"""Geometry and lens corrections of art_tpu_torch against `art_tpu`, on
the CPU: the transform (`pipeline/transform.py`: rotation, perspective,
distortion and CA sliders, LCP, metadata-spline and DNG-warp maps;
Catmull-Rom and bilinear) at 64x96, the auto-fill bisection, the three
raw vignettes (LCP, metadata or lensfun spline, DNG polynomial), the LCP
and lensfun host copies on fixtures the tests write, both planners'
PipelineConfig and data for each correction, and two develops: C1's
settings (`chip_smoke.c1_pp`: dark frame, flat field, .badpixels, line
denoise, PDAF, an LCP profile, rotation, perspective, auto-fill; AMaZE,
denoise, the Neutral curve) at 256x1024 against the reference on its
exact paths (AMaZE whole-plane, the wavelet shrink dividing exactly, as
the port does), and C2's (`chip_smoke.c2_arp`: an
embedded gain map, lensfun, distortion and CA sliders) with bilinear
demosaic at 96x160, below every kernel tile.

Bounds: the transform within 1.0 of 65535 against the reference's
function run op by op (jitted, XLA's CPU code fuses multiply-adds into
FMAs, which PyTorch does not: a coordinate then moves by an ulp); the
develops PERF.md section
2's (max <= 1 LSB8, mean <= 2e-4, >= 99.9% within 1 LSB8), where C1's
sample positions are threshold decisions (inside the source or not) read
from both packages' coordinate maps by `flip_parity`: at most 2e-5 of
the sites may flip.
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.io.rawfile import synthesize_bayer as ref_synthesize
from art_tpu.params import ProcParams as RefProcParams
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev
from art_tpu_torch.pipeline import transform as tt
from chip_smoke import (C1_LCP, LENSFUN_XML, _LCP_FRAME, badpixels_dir,
                        c1_files, c1_frame, c1_pp, c2_arp, c2_dng,
                        flip_parity, lensfun_db, parity)
from tests.test_torch_plan import Develops, plan_key
from tests.test_torch_rawcal import assert_same_plan, raw_stage

jdev = importlib.import_module("art_tpu.pipeline.develop")
jt = importlib.import_module("art_tpu.pipeline.transform")

H, W = 64, 96

GEOMETRY = {
    "rotate-perspective": "[Rotation]\nEnabled=true\nDegree=1.5\n"
                          "[Perspective]\nEnabled=true\nHorizontal=8\n"
                          "Vertical=-5\nShear=3\n"
                          "[Common Properties for Transformations]\n"
                          "AutoFill=true\n",
    "angle-no-autofill": "[Perspective]\nEnabled=true\nAngle=-2\n"
                         "Vertical=10\n",
    "distortion-ca": "[Distortion]\nEnabled=true\nAmount=0.05\n"
                     "[CACorrection]\nEnabled=true\nRed=0.002\n"
                     "Blue=-0.002\n",
    "lcp": "[LensProfile]\nLcMode=lcp\nLCPFile={lcp}\nUseCA=true\n"
           "[Rotation]\nEnabled=true\nDegree=-0.7\n",
    "lcp-ca-only": "[LensProfile]\nLcMode=lcp\nLCPFile={lcp}\n"
                   "UseDistortion=false\nUseCA=true\n",
    "exif-spline": "[LensProfile]\nLcMode=exif\nUseVignette=false\n"
                   "UseCA=true\n",
    "dng-warp": "[LensProfile]\nLcMode=exif\nUseVignette=false\n",
    "lensfun": "[LensProfile]\nLcMode=lfmanual\nLFCameraMake=ART-TPU\n"
               "LFCameraModel=Synthetic\nLFLens=ART-TPU 50mm f/1.8\n",
    "lensfun-auto": "[LensProfile]\nLcMode=lfauto\nUseCA=true\n",
}


def _sony_makernotes(nc=16):
    """A Sony correction (lensexif.cc SonyCorrectionData): barrel
    distortion, a small CA and a corner vignette."""
    return {"DistortionCorrParams": [nc] + [int(-16384 * (i / 15.0) ** 2
                                                * 0.2) for i in range(nc)],
            "ChromaticAberrationCorrParams": [2 * nc] + [
                int(300 * (i % nc) / nc) * (1 if i < nc else -1)
                for i in range(2 * nc)],
            "VignettingCorrParams": [nc] + [int(-8192 * (i / 15.0) ** 2)
                                            for i in range(nc)]}


def _dng_opcodes3():
    """DNG OpcodeList3 bytes: WarpRectilinear and FixVignetteRadial, each
    with its own centre (lensexif.cc DNGCorrectionData)."""
    import struct

    warp = [1.0, 0.02, -0.003, 0.0004, 1e-4, -2e-4]
    vig = [0.3, -0.05, 0.01, -0.002, 1e-4]
    out = struct.pack(">I", 2)
    body = struct.pack(">I", 1) + struct.pack(">6d", *warp) \
        + struct.pack(">2d", 0.51, 0.48)
    out += struct.pack(">IIII", 1, 1, 0, len(body)) + body
    body = struct.pack(">7d", *vig, 0.49, 0.52)
    out += struct.pack(">IIII", 3, 1, 0, len(body)) + body
    return out


@pytest.fixture
def lens(tmp_path):
    """The LCP file, a lensfun database set in both packages' settings,
    and the DNG OpcodeList3 both packages' exif readers return."""
    lcp = str(tmp_path / "lens.lcp")
    with open(lcp, "w") as f:
        f.write(C1_LCP.format(frames="".join(
            _LCP_FRAME.format(f=f_mm, fl=fl, k1=k1) for f_mm, fl, k1 in (
                (35, 0.72, -0.05), (50, 1.03, -0.02)))))
    db = lensfun_db(str(tmp_path / "lensfun"))
    mp = pytest.MonkeyPatch()
    for pkg in ("art_tpu", "art_tpu_torch"):
        mp.setattr(importlib.import_module(f"{pkg}.settings").settings,
                   "lensfun_db_dir", db)
        mp.setattr(f"{pkg}.lens.exifcorr._read_opcodelist3",
                   lambda path: _dng_opcodes3())
    yield {"lcp": lcp, "db": db}
    mp.undo()


def _frame(case, shape=(H, W), seed=0):
    from art_tpu_torch.core.image import synthesize_bayer

    rgb = np.random.default_rng(seed).uniform(0.02, 0.95, (3, *shape))
    frame = synthesize_bayer(rgb.astype(np.float32), pattern="RGGB")
    exif = {"focal_length": 42.0, "f_number": 4.0,
            "lens_model": "ART-TPU 50mm f/1.8"}
    name = "<synthetic>"
    make = frame.make
    if case.startswith("exif"):
        make = "SONY"
        exif["makernotes"] = _sony_makernotes()
    elif case.startswith("dng"):
        name = "frame.dng"  # its OpcodeList3: the fixture's bytes
        exif["is_dng"] = True
    return dataclasses.replace(frame, make=make, exif=exif, filename=name)


# ------------------------------------------------------------ the transform

@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("case", list(GEOMETRY))
def test_transform_matches_reference(lens, case, method):
    frame = _frame(case)
    arp = GEOMETRY[case].format(lcp=lens["lcp"])
    cfg, data = assert_same_plan(frame, arp)
    assert cfg.transform and not cfg.late_crop
    tdata = data["transform"]
    keys = {"lcp": "lcp_dist", "lcp-ca-only": "lcp_ca",
            "exif-spline": "exifc_ca", "dng-warp": "exif_dng_warp",
            "lensfun": "exifc_dist", "lensfun-auto": "exifc_ca"}
    assert keys.get(case, "cos") in tdata
    assert ("lcp_dist" in tdata) == (case == "lcp")
    rgb = np.random.default_rng(1).uniform(0.0, 65535.0, (3, H, W)).astype(
        np.float32)
    ours = tt.apply_transform(torch.from_numpy(rgb),
                              tdev.data_to_torch(tdata, "cpu"), method)
    # op by op: jitted, XLA's CPU code contracts multiply-adds into FMAs
    # (jnp.interp is jitted on its own), which moves a coordinate by an
    # ulp and a sample of this full-scale noise by up to ~1 (the
    # develops below hold the jitted reference)
    with jax.disable_jit():
        ref = np.asarray(jt.apply_transform(jnp.asarray(rgb), tdata,
                                            method))
    d = np.abs(ours.numpy().astype(np.float64) - ref)
    print(case, method, "max", d.max(), "zeros", int((ref == 0).sum()))
    assert d.max() <= 1.0


def test_autofill_scale_matches_reference():
    base = {"cos": 1.0, "sin": 0.0, "dist": 0.0, "ca_r": 0.0, "ca_b": 0.0,
            "persp_h": 0.0, "persp_v": 0.0, "shear": 0.0}
    cases = [dict(base), dict(base, cos=np.cos(0.03), sin=np.sin(0.03)),
             dict(base, persp_h=0.08, persp_v=-0.05, shear=0.03),
             dict(base, dist=-0.1, ca_r=0.002, ca_b=-0.002),
             dict(base, cos=np.cos(-0.5), sin=np.sin(-0.5), dist=0.08)]
    got = []
    for data in cases:
        data = {k: np.float32(v) for k, v in data.items()}
        for h, w in ((H, W), (4000, 6000)):
            a = tt._autofill_scale(data, h, w)
            assert a == jt._autofill_scale(data, h, w)
            got.append(a)
    assert 0.5 < min(got) < 0.95 and max(got) < 1.0


def test_fisheye_lcp_is_skipped_as_in_the_reference(tmp_path):
    # a fisheye profile: no LCP map and no vignette, but the transform
    # the set file turns on still runs (transform.py:130, develop.py:327)
    lcp = str(tmp_path / "fisheye.lcp")
    with open(lcp, "w") as f:
        f.write(C1_LCP.format(frames=_LCP_FRAME.format(
            f=8, fl=0.3, k1=0.1).replace(
                "PerspectiveModel", "FisheyeModel")))
    cfg, data = assert_same_plan(
        _frame("lcp"), f"[LensProfile]\nLcMode=lcp\nLCPFile={lcp}\n")
    assert cfg.transform
    assert not {"lcp_dist", "lcp_ca"} & set(data["transform"])
    assert "lcp_vign" not in data


def test_auto_distortion_is_refused_by_name_where_a_preview_exists(tmp_path):
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.io.rawfile import load_raw

    path = str(tmp_path / "preview.dng")
    rgb = np.random.default_rng(2).uniform(0.1, 0.9, (3, H, W))
    write_dng(path, np.full((H, W), 4000, np.uint16), black=512,
              white=16383, compress=False, preview_rgb01=rgb)
    pp = ProcParams()
    pp.apply_arp_text("[Distortion]\nEnabled=true\nAuto=true\n")
    with pytest.raises(NotImplementedError, match="auto distortion"):
        tdev.plan(load_raw(path), pp, device="cpu")


# ------------------------------------------------------------ raw vignettes

VIGNETTES = {
    "lcp": ("[LensProfile]\nLcMode=lcp\nLCPFile={lcp}\n", "lcp_vign"),
    "exif-spline": ("[LensProfile]\nLcMode=exif\n", "exif_vign"),
    "dng": ("[LensProfile]\nLcMode=exif\n", "exif_vign_dng"),
    "lensfun": (GEOMETRY["lensfun"] + "UseDistortion=false\nUseCA=false\n",
                "exif_vign"),
}


@pytest.mark.parametrize("case", list(VIGNETTES))
def test_raw_vignette_matches_reference(lens, case):
    # a frame whose padded plane (128x128) is larger than it: the spline
    # takes its centre from the padded plane, the others from the frame
    frame = _frame(case)
    arp, key = VIGNETTES[case]
    cfg, data = assert_same_plan(frame, arp.format(lcp=lens["lcp"]))
    assert key in data
    inp = tdev.pad_to_multiple(frame.cfa, tdev.PAD_MULTIPLE)[0]
    ours = raw_stage("port", cfg, inp, data)
    ref = raw_stage("ref", cfg, inp, data)
    d = np.abs(ours.astype(np.float64) - ref)
    print(case, "max", d.max())
    assert d.max() <= 1.0


# ------------------------------------------------------------ host copies

def test_lcp_parse_matches_reference(lens):
    from art_tpu.lens import lcp as ref_lcp
    from art_tpu_torch.lens import lcp

    prof, ref = lcp.parse_lcp(lens["lcp"]), ref_lcp.parse_lcp(lens["lcp"])
    assert len(prof.frames) == len(ref.frames) == 2
    assert prof.is_fisheye is ref.is_fisheye is False
    for focal, ap in ((35.0, 2.8), (42.0, 4.0), (20.0, 0.0), (80.0, 2.8)):
        for m, r in ((prof.distortion(focal), ref.distortion(focal)),
                     (prof.vignette(focal, ap), ref.vignette(focal, ap))):
            assert dataclasses.asdict(m) == dataclasses.asdict(r)
            assert m.geometry(96, 64, focal) == r.geometry(96, 64, focal)
        assert prof.vignette(focal, ap).vign_param() == \
            ref.vignette(focal, ap).vign_param()
        assert [dataclasses.asdict(m) for m in prof.chromatic(focal)] == \
            [dataclasses.asdict(m) for m in ref.chromatic(focal)]
    assert lcp.parse_lcp(str(lens["db"])) is None


def test_lensfun_matches_reference(lens):
    from art_tpu.lens import lensfun as ref_lf
    from art_tpu_torch.lens import lensfun as lf

    with open(os.path.join(lens["db"], "more.xml"), "w") as f:
        f.write(LENSFUN_XML.replace("ART-TPU 50mm f/1.8",
                                    "ART-TPU 24-70mm f/2.8 Zoom"))
    db, ref = lf.LensfunDB(lens["db"]), ref_lf.LensfunDB(lens["db"])
    assert len(db.lenses) == len(ref.lenses) == 2
    cam = db.find_camera("art-tpu", "synthetic")
    assert cam.model == ref.find_camera("art-tpu", "synthetic").model
    for name in ("ART-TPU 50mm f/1.8", "24-70mm Zoom", "nothing like it"):
        a, b = db.find_lens(name, cam), ref.find_lens(name, cam)
        assert (a and a.model) == (b and b.model)
    lens_ = db.find_lens("50mm f/1.8", cam)
    ref_lens = ref.find_lens("50mm f/1.8", cam)
    for focal, ap in ((50.0, 1.8), (50.0, 4.0), (0.0, 0.0)):
        c = db.corrections(lens_, cam, focal, ap)
        r = ref.corrections(ref_lens, cam, focal, ap)
        for k in ("knots", "dist", "vig", "ca"):
            np.testing.assert_array_equal(getattr(c, k), getattr(r, k), k)
    # the database follows settings.lensfun_db_dir
    assert lf.get_db() is lf.get_db() and len(lf.get_db().lenses) == 2


# ------------------------------------------------------------ develops

@pytest.fixture(scope="module")
def develops(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    return Develops(root / "lens_develops")


def _valid_masks(module, config, data):
    """The transform's support decisions of `module` (the port's or the
    reference's transform) on config's planes: an (H, W) code of the
    three channels' in-source tests."""
    masks = []

    def record(img, dy, dx):
        h, w = img.shape
        masks.append(np.asarray((dy >= 0) & (dy <= h - 1) & (dx >= 0)
                                & (dx <= w - 1)))
        return dy * 0

    mp = pytest.MonkeyPatch()
    mp.setattr(module, "_sample_bicubic", record)
    try:
        h, w = config.orig_shape
        if module is tt:
            tt.apply_transform(torch.zeros(3, h, w),
                               tdev.data_to_torch(data, "cpu"))
        else:
            jt.apply_transform(jnp.zeros((3, h, w)), data)
    finally:
        mp.undo()
    return sum(m.astype(np.float64) * 2 ** i for i, m in enumerate(masks))


def _ref_exact_develop(frame, pp):
    """The reference's develop on its exact paths: AMaZE on the
    whole-plane path, the wavelet shrink with a division for its
    approximate reciprocal (both divide exactly in the port)."""
    from art_tpu.demosaic import amaze_pallas
    from art_tpu.ops import wavelet_pallas
    from tests.test_torch_wavelet_multi import _exact_shrink

    mp = pytest.MonkeyPatch()
    mp.setattr(amaze_pallas, "amaze_pallas", lambda *a, **k: None)
    mp.setattr(wavelet_pallas, "_shrink", _exact_shrink)
    jdev._executor.cache_clear()
    jax.clear_caches()
    try:
        return np.asarray(jdev.develop(frame, pp))
    finally:
        mp.undo()
        jdev._executor.cache_clear()
        jax.clear_caches()


def test_c1_develops_as_the_exact_reference(tmp_path, develops):
    frame = c1_frame(256, 1024, seed=5)
    files = c1_files(str(tmp_path), frame, seed=5)
    with badpixels_dir(files["badpixels_dir"]):
        pp, ref_pp = c1_pp(files), c1_pp(files, RefProcParams())
        cfg, data = tdev.plan(frame, pp, device="cpu")
        ref_cfg, ref_data = jdev.plan(frame, ref_pp)
        for f in ("transform", "darkframe", "flatfield", "badpix_file",
                  "linedn", "pdaf", "steps", "late_crop"):
            assert getattr(cfg, f) == getattr(ref_cfg, f), f
        assert cfg.transform and cfg.darkframe and cfg.badpix_file
        assert cfg.flatfield == ("area", 32) and cfg.pdaf
        assert tdev.fusion_gates(cfg) == (True, True)
        # the plan's file contents, not its temporary paths, key a develop
        key = plan_key(cfg, data)
        out = develops.get("port", key, lambda: tdev.develop(
            frame, pp, device="cpu").numpy())
        ref = develops.get("ref-exact", key,
                           lambda: _ref_exact_develop(frame, ref_pp))
    dec = _valid_masks(tt, cfg, data["transform"])
    ref_dec = _valid_masks(jt, ref_cfg, ref_data["transform"])
    # auto-fill keeps the whole output inside the source, but for
    # samples that land exactly on its border
    assert (dec == 7).mean() > 0.99
    st = flip_parity(out, ref, dec, ref_dec, 1)
    print("C1 port vs exact reference", st)
    assert out.shape == (3, 256, 1024)
    assert st["flip_share"] <= 2e-5, st
    assert st["max_lsb8_beyond_flips"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st


def test_c2_develops_as_the_reference(tmp_path, develops):
    from art_tpu_torch.io.rawfile import load_raw
    from chip_smoke import flagship_pp

    path = str(tmp_path / "c2.dng")
    c2_dng(path, 96, 160, seed=5)
    frame = load_raw(path)
    db = lensfun_db(str(tmp_path / "lensfun"))
    mp = pytest.MonkeyPatch()
    for pkg in ("art_tpu", "art_tpu_torch"):
        mp.setattr(importlib.import_module(f"{pkg}.settings").settings,
                   "lensfun_db_dir", db)
    try:
        pps = []
        for cls in (ProcParams, RefProcParams):
            pp = flagship_pp("bilinear", cls())
            pp.apply_arp_text(c2_arp())
            pps.append(pp)
        cfg, data = tdev.plan(frame, pps[0], device="cpu")
        ref_cfg, ref_data = jdev.plan(frame, pps[1])
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        assert cfg.gainmap and cfg.transform and "exif_vign" in data
        assert {"exifc_dist", "exifc_ca"} <= set(data["transform"])
        out = develops.get("port", plan_key(cfg, data), lambda: tdev.develop(
            frame, pps[0], device="cpu").numpy())
        ref = develops.get("ref", plan_key(ref_cfg, ref_data),
                           lambda: jdev.develop(frame, pps[1]))
    finally:
        mp.undo()
    st = parity(out, ref)
    print("C2 port vs reference", st)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st


def test_reference_synthesizer_agrees():
    # the tests above hand the port's synthetic frames to the reference's
    # planner: both packages' synthesizers make the same frame
    rgb = np.random.default_rng(0).uniform(0.02, 0.95, (3, 8, 12))
    from art_tpu_torch.core.image import synthesize_bayer

    a = synthesize_bayer(rgb.astype(np.float32))
    b = ref_synthesize(rgb.astype(np.float32))
    np.testing.assert_array_equal(a.cfa, b.cfa)
