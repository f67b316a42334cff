"""The JAX-free planner of art_tpu_torch against `art_tpu`'s `plan`:
same PipelineConfig, same data keys, same arrays, for the flagship
profile (AMaZE), its bilinear variant and a WB/denoise variant; and a
named NotImplementedError for every step the port lacks; a step ported
since plans as the reference's does, from files the test writes.
"""

import contextlib
import dataclasses
import fcntl
import hashlib
import importlib
import os

import numpy as np
import pytest

from art_tpu.params import ProcParams
from art_tpu_torch.core.image import synthesize_bayer
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import parity

jdev = importlib.import_module("art_tpu.pipeline.develop")

# Under pytest-xdist each worker collects every test module, this one
# included: give each worker its share of the cores for PyTorch's
# intra-op threads. With one thread a core in each of six workers on
# eight cores, the spin-waiting thread pools oversubscribe the machine
# and a CPU test that takes 5 s alone takes minutes.
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

ARP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "art_tpu_torch", "data", "profiles",
    "Standard Film Curve.arp")


def flagship_pp():
    pp = ProcParams()
    pp.apply_arp_text(open(ARP).read())
    pp.raw.bayer.method = "bilinear"
    pp.denoise.enabled = True
    pp.denoise.luminance = 20.0
    pp.denoise.chrominance = 20.0
    return pp


def amaze_pp():
    pp = flagship_pp()
    pp.raw.bayer.method = "amaze"
    return pp


def variant_pp():
    pp = flagship_pp()
    pp.wb.method = "CustomMult"
    pp.wb.mult = [2.2, 1.0, 1.7]
    pp.denoise.chrominance_method = 0
    pp.denoise.luminance = 40.0
    return pp


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0.02, 0.95, size=(3, 256, 1024)).astype(np.float32)
    return synthesize_bayer(rgb, pattern="RGGB")


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        elif isinstance(v, list):  # the spot entries' windows
            yield from _leaves(dict(enumerate(v)), f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# values computed by a different float32 program than the reference's:
# the Neutral curve's hue anchors and ranges (host numpy vs an XLA
# program with its own arctan2, within 2e-6 rad); everything else is the
# same float64 numpy code cast to float32 once
LOOSE = {"op:tonecurve/params": (slice(36, 42), 2e-6)}


@pytest.mark.parametrize("make_pp", [flagship_pp, variant_pp, amaze_pp],
                         ids=["flagship-bilinear", "variant", "flagship"])
def test_plan_matches_reference(frame, make_pp):
    assert_plans_equal(tdev.plan(frame, make_pp()),
                       jdev.plan(frame, make_pp()))


def assert_plans_equal(ours_plan, ref_plan):
    """The port's (config, data) against the reference's: the same
    PipelineConfig, data keys, shapes and dtypes, and values within rtol
    1e-6 (LOOSE entries within their atol)."""
    ours_cfg, ours = ours_plan
    ref_cfg, ref = ref_plan
    names = [f.name for f in dataclasses.fields(ref_cfg)]
    assert [f.name for f in dataclasses.fields(ours_cfg)] == names
    for n in names:
        assert getattr(ours_cfg, n) == getattr(ref_cfg, n), n
    ours_l, ref_l = dict(_leaves(ours)), dict(_leaves(ref))
    assert sorted(ours_l) == sorted(ref_l)
    for k, rv in ref_l.items():
        ov = np.asarray(ours_l[k])
        rv = np.asarray(rv)
        assert ov.shape == rv.shape and ov.dtype == rv.dtype, k
        if k in LOOSE:
            sl, atol = LOOSE[k]
            np.testing.assert_allclose(ov[sl], rv[sl], rtol=0, atol=atol)
            ov, rv = np.delete(ov, sl), np.delete(rv, sl)
        np.testing.assert_allclose(ov, rv, rtol=1e-6, atol=0, err_msg=k)


def test_auto_chroma_matches_reference(frame):
    from art_tpu.pipeline.autos import auto_chroma_params as ref_fn
    from art_tpu_torch.pipeline.autos import auto_chroma_params

    pp = flagship_pp()
    # the same numpy statistics, op for op: identical up to BLAS sum order
    np.testing.assert_allclose(auto_chroma_params(frame, pp),
                               ref_fn(frame, pp), rtol=1e-9)


def _set(pp, path, value):
    obj = pp
    *head, last = path.split(".")
    for p in head:
        obj = getattr(obj, p)
    setattr(obj, last, value)


@pytest.mark.parametrize("changes,match", [
    # ported since (match None, below): LMMSE plans its iterations as
    # in the reference
    ({"raw.bayer.method": "lmmse"}, None),
    # ported since (match None): auto white balance (grey world)
    ({"wb.method": "Auto"}, None),
    # ported since (match None): the Smoothing op's NLMeans region under
    # an area mask, rasterised as the reference's OpenCV calls do
    ({"extra": {"Smoothing": {"Enabled": "true", "Mode_1": "3",
                              "AreaMaskEnabled_1": "true",
                              "AreaMask0Type_1": "rectangle"}}}, None),
    # ported since (match None): a PSF kernel from an image file, which
    # the port's own decoder reads
    ({"sharpening.enabled": True, "sharpening.method": "psf",
      "sharpening.psf_kernel": "{tmp}/psf.png"}, None),
    # ported since (match None): the drawn and external-file masks of the
    # region ops
    ({"extra": {"ColorCorrection": {
        "Enabled": "true", "Mode_1": "RGB", "DrawnMaskEnabled_1": "true",
        "DrawnMaskStrokes_1": "1;0.1;1;1;0.5;0.5;"}}}, None),
    ({"extra": {"TextureBoost": {
        "Enabled": "true", "Strength_1": "0.5",
        "ExternalMaskEnabled_1": "true",
        "ExternalMaskFilename_1": "{tmp}/mask.png"}}}, None),
    # ported since (match None): the transform beside the crop, flips
    # and resize, line denoise, the LCP profile, the dark frame, the
    # flat field and the gain map plan as in the reference, from the
    # files the test writes
    ({"resize.enabled": True, "rotate.enabled": True, "rotate.degree": 3.0},
     None),
    ({"perspective.enabled": True, "perspective.horizontal": 10.0}, None),
    ({"distortion.enabled": True, "distortion.amount": 0.05}, None),
    ({"raw.bayer.green_eq_enabled": True, "raw.bayer.linenoise": 10}, None),
    # ported since (match None): ICC and DCP profile files
    ({"icm.output_profile": "{tmp}/out.icc"}, None),
    # an LCP file: its vignette and geometry apply
    ({"lens_prof.method": "lcp", "lens_prof.lcp_file": "{tmp}/lens.lcp",
      "lens_prof.use_ca": True}, None),
    ({"icm.input_profile": "{tmp}/camera.dcp"}, None),
    ({"icm.input_profile": "{tmp}/camera.icc"}, None),
    ({"raw.df_enabled": True, "raw.df_file": "{tmp}/dark.dng"}, None),
    # the searches find the DNG the test writes in their directories
    ({"raw.df_enabled": True, "raw.df_autoselect": True}, None),
    ({"raw.ff_enabled": True, "raw.ff_file": "{tmp}/flat.dng"}, None),
    ({"raw.ff_enabled": True, "raw.ff_autoselect": True}, None),
    ({"raw.ff_enabled": True, "raw.ff_embedded": True,
      "frame.filename": "{tmp}/frame.dng"}, None),
], ids=["amaze", "auto-wb", "nlmeans", "psf-image", "cc-drawn-mask",
        "texture-external-mask", "rotate-resize", "perspective",
        "distortion", "cfa-linedn", "out-icc", "lcp-file", "in-dcp",
        "in-icc", "df-file", "df-auto", "ff-file", "ff-auto",
        "ff-embedded"])
def test_unported_steps_raise_by_name(frame, tmp_path, changes, match):
    # "{tmp}/..." names a file the test writes (the reference would apply
    # it), "{missing}/..." one that does not exist. A step ported since
    # (match None) plans as in the reference: the same PipelineConfig and
    # data, and not the flagship's plan
    pp = flagship_pp()
    if match is None:
        ref_pp = flagship_pp()
        with _searches(frame, tmp_path):
            ours = _apply(pp, frame, changes, tmp_path)
            _apply(ref_pp, frame, changes, tmp_path)
            cfg, data = tdev.plan(ours, pp, device="cpu")
            assert_plans_equal((cfg, data), jdev.plan(ours, ref_pp))
        assert plan_key(cfg, data) != plan_key(*tdev.plan(frame,
                                                          flagship_pp()))
        tdev.build_run(cfg)
        return
    frame = _apply(pp, frame, changes, tmp_path)
    with pytest.raises(NotImplementedError, match=match):
        cfg, data = tdev.plan(frame, pp)
        tdev.build_run(cfg)


def _write_file(path, frame):
    """A file for a "{tmp}/..." value: a DNG of the frame's mosaic with
    four gain maps, C1's LCP profile, P1's DCP camera profile, a v4
    matrix ICC profile with a parametric TRC, a 9x9 PSF image, or an
    empty file."""
    if path.endswith(".dng"):
        from art_tpu_torch.io.dngwrite import write_dng
        from chip_smoke import gain_maps

        h, w = frame.cfa.shape
        write_dng(path, np.round(frame.cfa).astype(np.uint16), black=512,
                  white=16383, compress=False, gain_maps=gain_maps(h, w))
    elif path.endswith(".lcp"):
        from chip_smoke import C1_LCP, _LCP_FRAME

        with open(path, "w") as f:
            f.write(C1_LCP.format(frames=_LCP_FRAME.format(
                f=35, fl=0.72, k1=-0.05)))
    elif path.endswith(".dcp"):
        from chip_smoke import write_dcp

        write_dcp(path)
    elif path.endswith(".icc"):
        from chip_smoke import write_para_icc

        write_para_icc(path)
    elif path.endswith(".png"):
        from art_tpu_torch.io.imagefile import write_png

        yy, xx = np.mgrid[-4:5, -4:5]
        k = np.exp(-(yy * yy + xx * xx) / 4.0) * 255.0
        write_png(path, np.repeat(k[..., None], 3, 2).astype(np.uint8))
    else:
        with open(path, "wb"):
            pass


@contextlib.contextmanager
def _searches(frame, tmp_path):
    """Both packages' dark-frame and flat-field searches read a directory
    that holds one DNG of the frame's mosaic, inside the block."""
    from art_tpu.raw import dfff_managers as ref_mgr
    from art_tpu_torch.raw import dfff_managers as mgr

    d = tmp_path / "search"
    d.mkdir()
    _write_file(str(d / "cal.dng"), frame)
    mp = pytest.MonkeyPatch()
    for pkg in ("art_tpu", "art_tpu_torch"):
        settings = importlib.import_module(f"{pkg}.settings").settings
        mp.setattr(settings, "dark_frames_dir", str(d))
        mp.setattr(settings, "flat_fields_dir", str(d))
    mgr.reset()
    ref_mgr.reset()
    try:
        yield
    finally:
        mp.undo()
        mgr.reset()
        ref_mgr.reset()


def _apply(pp, frame, changes, tmp_path):
    """Set `changes` on pp (and "frame.filename" on a copy of frame),
    writing a file for each "{tmp}/..." value (also inside a group of
    `extra`, `_write_file`); returns the frame."""
    def resolve(value):
        if isinstance(value, dict):
            return {k: resolve(v) for k, v in value.items()}
        if isinstance(value, str) and value.startswith("{tmp}"):
            value = str(tmp_path / value[len("{tmp}/"):])
            _write_file(value, frame)
        elif isinstance(value, str) and value.startswith("{missing}"):
            value = str(tmp_path / "missing" / value[len("{missing}/"):])
        return value

    for path, value in changes.items():
        value = resolve(value)
        if path == "frame.filename":
            frame = dataclasses.replace(frame, filename=value)
        else:
            _set(pp, path, value)
    return frame


def plan_key(config, data):
    """A digest of a plan: its PipelineConfig and every array of its
    data."""
    h = hashlib.sha256(repr(config).encode())
    for k, v in sorted(_leaves(data)):
        a = np.ascontiguousarray(np.asarray(v))
        h.update(f"{k} {a.dtype} {a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


class Develops:
    """Develops by plan: `get(package, key, develop)` runs develop() once
    for each (package, key) and returns its output as a numpy array from
    then on. The outputs are kept in the process and as .npy files in
    `directory`, which the test session's workers share (each key's file
    written under a lock), so a plan that several settings resolve to is
    developed once a session, whichever worker takes each setting. The
    keys are plans of the module's one frame."""

    def __init__(self, directory):
        self.dir = directory
        self.dir.mkdir(parents=True, exist_ok=True)
        self.memo = {}

    def get(self, package, key, develop):
        name = f"{package}-{key}"
        if name not in self.memo:
            path = self.dir / f"{name}.npy"
            with open(self.dir / f"{name}.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not path.exists():
                    out = np.asarray(develop())
                    np.save(self.dir / f"{name}.tmp.npy", out)
                    os.replace(self.dir / f"{name}.tmp.npy", path)
            self.memo[name] = np.load(path)
        return self.memo[name]


@pytest.fixture(scope="module")
def develops(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the session's, above each worker's own
    return Develops(root / "plan_develops")


# settings the reference develops without the step they name, because
# the file the step needs does not exist: each plans and develops as the
# reference does. They resolve to two plans (Rec2020 and sRGB out), each
# developed once by either package (`develops`)
MISSING = [
    ({"icm.output_profile": "{missing}/rec2020.icc"}, "Rec2020"),
    ({"icm.output_profile": "{missing}/foo.icc"}, "sRGB"),
    ({"icm.input_profile": "{missing}/camera.dcp"}, "sRGB"),
    ({"icm.input_profile": "{missing}/camera.icc"}, "sRGB"),
    ({"raw.df_enabled": True, "raw.df_file": "{missing}/dark.dng"}, "sRGB"),
    ({"raw.ff_enabled": True, "raw.ff_file": "{missing}/flat.dng",
      "raw.ff_embedded": True}, "sRGB"),
]


@pytest.mark.parametrize("changes,out_prof", MISSING,
                         ids=["out-rec2020-icc", "out-foo-icc", "in-dcp",
                              "in-icc", "df-file", "ff-file-embedded"])
def test_missing_files_develop_as_the_reference(frame, tmp_path, develops,
                                                changes, out_prof):
    pp, ref_pp = flagship_pp(), flagship_pp()
    _apply(pp, frame, changes, tmp_path)
    _apply(ref_pp, frame, changes, tmp_path)
    cfg, data = tdev.plan(frame, pp)
    ref_cfg, ref_data = jdev.plan(frame, ref_pp)
    assert cfg.out_trc == ref_cfg.out_trc
    assert not (ref_cfg.darkframe or ref_cfg.flatfield or ref_cfg.gainmap
                or ref_cfg.dcp or ref_cfg.icc_input_trc)
    want = (np.linalg.inv(tdev.cs.MATRICES_RGB_TO_XYZ[out_prof])
            @ tdev.cs.MATRICES_RGB_TO_XYZ[cfg.working_profile])
    np.testing.assert_allclose(data["work2out"], want, rtol=1e-6, atol=1e-7)
    for k in ("work2out", "cam2work"):
        np.testing.assert_array_equal(data[k], ref_data[k], err_msg=k)
    out = develops.get("port", plan_key(cfg, data), lambda: tdev.develop(
        frame, pp, device="cpu").numpy())
    ref = develops.get("ref", plan_key(ref_cfg, ref_data),
                       lambda: jdev.develop(frame, ref_pp))
    st = parity(out, ref)
    print(changes, st)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st


def test_missing_files_resolve_to_two_plans(frame, tmp_path):
    # the reading `develops` rests on: each setting above plans as the
    # flagship does, with its output profile
    keys = {}
    for changes, out_prof in MISSING + [({}, "sRGB")]:
        pp = flagship_pp()
        _apply(pp, frame, changes, tmp_path)
        keys.setdefault(out_prof, set()).add(plan_key(*tdev.plan(frame, pp)))
    assert {k: len(v) for k, v in keys.items()} == {"Rec2020": 1, "sRGB": 1}


@pytest.mark.parametrize("changes", [{"denoise.enabled": False},
                                     {"tone_curve.enabled": False}],
                         ids=["no-denoise", "no-curve"])
def test_closed_fusion_gates_develop_as_the_reference(frame, changes):
    # no denoise: the raw head runs on its own before the Neutral curve
    # (B7 with the output tail); no tone curve: B4 takes the head and the
    # output tail runs on its own. Slice bounds against the reference
    # as it stands (its wavelet's approximate reciprocal is the gap)
    pp, ref_pp = flagship_pp(), flagship_pp()
    for path, value in changes.items():
        _set(pp, path, value)
        _set(ref_pp, path, value)
    gates = tdev.fusion_gates(tdev.plan(frame, pp)[0])
    assert gates == ((False, True) if "denoise.enabled" in changes
                     else (True, False))
    out = tdev.develop(frame, pp, device="cpu").numpy()
    st = parity(out, jdev.develop(frame, ref_pp))
    print(changes, st)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st


# groups the reference plans no step for (ROADMAP C5): each op's own
# enable gate, a lens profile with no correction to find, auto
# distortion with no embedded JPEG preview
NO_STEP = [
    "[HSL Equalizer]\nEnabled=true\n",
    "[Luminance Curve]\nEnabled=true\n",
    "[ColorCorrection]\nEnabled=true\n",
    "[FattalToneMapping]\nEnabled=true\nAmount=400\n",
    "[Spot Removal]\nEnabled=true\nSpot1=10;10;30;30;0;1;1;2\n",
    "[LensProfile]\nLcMode=lcp\n",
    "[LensProfile]\nLcMode=exif\n",
    "[LensProfile]\nLcMode=lfauto\n",
    "[Sharpening]\nEnabled=true\nMethod=psf\nPSFKernel={missing}/psf.json\n",
    "[Distortion]\nEnabled=true\nAuto=true\n",
]


@pytest.mark.parametrize("text", NO_STEP, ids=[
    "hsl", "lab-curve", "color-correction", "fattal", "spot-radius-0",
    "lcp-no-file", "exif-no-data", "lensfun-no-db", "psf-missing",
    "auto-distortion-no-preview"])
def test_groups_the_reference_skips_plan_the_same_steps(tmp_path, text):
    from art_tpu_torch.params import ProcParams as TorchProcParams

    rgb = np.random.default_rng(1).uniform(0.02, 0.95, (3, 64, 96))
    small = synthesize_bayer(rgb.astype(np.float32), pattern="RGGB")
    text = text.replace("{missing}", str(tmp_path / "missing"))
    got = []
    for planner, cls in ((tdev.plan, TorchProcParams),
                         (jdev.plan, ProcParams)):
        pp = cls()
        pp.apply_arp_text(text)
        cfg, _ = planner(small, pp)
        got.append((cfg.steps, cfg.transform, cfg.late_crop))
    assert got[0] == got[1]
    assert got[0] == ((), False, True)
