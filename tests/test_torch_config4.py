"""Config 4 (BASELINE.json configs[3]: X-Trans 3-pass, dehaze, the tone
equalizer, local contrast and a film-simulation LUT) in art_tpu_torch
against `art_tpu` on the CPU: each module on the same seeded inputs
(`FlatCurve`, the masks' parse and evaluation, the à trous chain, each op
at its static variants, the .cube parser, the tetrahedral LUT), the
region ops' plan for unsuffixed groups, the area, drawn, external-file
and linked masks planned as the reference plans them (an external file
that is empty or no image leaves the region unmasked), the film
simulation's other file kinds planned as the reference plans them, and
the whole develop at 192x288 X-Trans with a 9^3 cube.

Tolerances: host values (curves, parsed masks and tables, plans) equal
exactly; the masks, à trous and the LUT within 1e-5 (of 1; measured
equal bit for bit on x86); each op within 1e-5 relative to 65535 plus
1e-5 of the value (log, exp and pow round differently in XLA and
PyTorch; measured 0.07 of 65535 at most); the develop at PERF.md
section 2's bounds (max <= 1/255, mean <= 2e-4, >= 99.9% within one
8-bit step; measured 0.15 LSB8 max, 9.0e-6 mean).
"""

import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu import masks as rmasks
from art_tpu.color import curves as rcurves
from art_tpu.color import lut3d as rlut
from art_tpu.ops import wavelet as rwav
from art_tpu.params import ProcParams as RefProcParams
from art_tpu.params.keyfile import KeyFile as RefKeyFile
from art_tpu_torch import masks
from art_tpu_torch.color import curves, lut3d
from art_tpu_torch.core.image import synthesize_bayer, synthesize_xtrans
from art_tpu_torch.ops import wavelet
from art_tpu_torch.params import ProcParams
from art_tpu_torch.params.keyfile import KeyFile
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import config4_pp, parity, write_cube

jdev = importlib.import_module("art_tpu.pipeline.develop")

FLAT_CURVES = [
    ([1, 0.0, 0.3, 0.35, 0.35, 0.5, 0.8, 0.35, 0.35], False, 0.5),
    ([1, 0.1, 0.2, 0.0, 0.0, 0.6, 0.9, 0.5, 0.7, 0.9, 0.4, 0.35, 0.35],
     True, 0.5),
    (masks.DEFAULT_HUE, True, 1.0),
    ([1, 0.2, 0.7, 0.6, 0.6, 0.8, 0.1, 0.6, 0.6], False, 0.0),
    ([0], False, 0.0),
]


@pytest.mark.parametrize("points,periodic,ident", FLAT_CURVES)
def test_flat_curve_matches_reference(points, periodic, ident):
    t = np.linspace(-0.25, 1.25, 3001)
    ours = curves.FlatCurve(points, periodic, ident)
    ref = rcurves.FlatCurve(points, periodic, ident)
    assert ours.is_identity() == ref.is_identity()
    np.testing.assert_array_equal(ours.get_val(t), ref.get_val(t))
    np.testing.assert_array_equal(ours.lut(1025), ref.lut(1025))


# region keys of a [Local Contrast] group: one parametric (hue,
# lightness, blur) + ΔE region, one lightness mask through a curve,
# posterization, inversion and opacity, and a third unmasked; a
# MaskEnabled alone also opens a region
GROUP = """[Local Contrast]
Enabled=true
Contrast_1=30
Curve_1=1;0;0.3;0.35;0.35;1;0.1;0.35;0.35;
MaskEnabled_1=true
ParametricMaskEnabled_1=true
HueMask_1=1;0.2;0.9;0.35;0.35;0.7;0.3;0.35;0.35;
LightnessMask_1=1;0;0;0.35;0.35;1;1;0.35;0.35;
ParametricMaskBlur_1=1.5
DeltaEMaskEnabled_1=true
DeltaEMaskL_1=50
DeltaEMaskC_1=20
DeltaEMaskH_1=200
Contrast_2=-20
ParametricMaskEnabled_2=true
LightnessMask_2=1;0;0.2;0.35;0.35;1;0.9;0.35;0.35;
MaskCurve_2=1;0;0;0.5;0.8;1;1;
MaskPosterization_2=2
MaskInverted_2=true
MaskOpacity_2=0.8
Contrast_3=15
MaskEnabled_4=false
"""

FIELDS = {"contrast": ("Contrast", "f", 0.0), "curve": ("Curve", "dl", [])}


def _pps(text):
    ours, ref = ProcParams(), RefProcParams()
    ours.apply_arp_text(text)
    ref.apply_arp_text(text)
    return ours, ref


def test_mask_parse_matches_reference():
    ours, ref = _pps(GROUP)
    a = masks.regions_from_extra(ours, "Local Contrast", FIELDS)
    b = rmasks.regions_from_extra(ref, "Local Contrast", FIELDS)
    assert len(a) == len(b) == 4
    for (pa, ma), (pb, mb) in zip(a, b):
        assert pa == pb
        assert dataclasses.asdict(ma) == dataclasses.asdict(mb)
        assert ma.is_trivial() == mb.is_trivial()
    kf, rkf = KeyFile.parse(GROUP), RefKeyFile.parse(GROUP)
    assert dataclasses.asdict(masks.MaskSpec.from_keyfile(
        kf, "Local Contrast", "_2")) == dataclasses.asdict(
            rmasks.MaskSpec.from_keyfile(rkf, "Local Contrast", "_2"))


@pytest.fixture(scope="module")
def rgb():
    x = np.random.default_rng(3).uniform(0.0, 1.0, (3, 48, 64)) ** 2
    return (x * 60000).astype(np.float32)


def _ws(profile="Rec2020"):
    from art_tpu_torch.color import colorspaces as cs

    return cs.MATRICES_RGB_TO_XYZ[profile].astype(np.float32)


@pytest.mark.parametrize("region", [0, 1, 2], ids=[
    "parametric-deltae", "curve-posterize-invert-opacity", "unmasked"])
def test_eval_mask_matches_reference(rgb, region):
    ours, ref = _pps(GROUP)
    m = masks.regions_from_extra(ours, "Local Contrast", FIELDS)[region][1]
    rm = rmasks.regions_from_extra(ref, "Local Contrast", FIELDS)[region][1]
    st, data = masks.plan_mask(m, rgb.shape[1:], ours)
    rst, rdata = rmasks.plan_mask(rm, rgb.shape[1:], ref)
    assert st == rst
    assert sorted(data) == sorted(rdata)
    for k in rdata:
        np.testing.assert_array_equal(data[k], rdata[k], err_msg=k)
    a = masks.eval_mask(torch.from_numpy(rgb), torch.from_numpy(_ws()), st,
                        tdev.data_to_torch(data, "cpu")).numpy()
    b = np.asarray(rmasks.eval_mask(jnp.asarray(rgb), jnp.asarray(_ws()),
                                    rst, rdata))
    print("mask", region, "range", b.min(), b.max(), "diff",
          np.abs(a - b).max())
    assert b.max() - b.min() > 0.1 or region == 2
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("keys,file", [
    ("AreaMaskEnabled_1=true\nAreaMask0Type_1=rectangle\n"
     "AreaMask0Width_1=50\nAreaMask0Height_1=40\nAreaMask0Angle_1=30\n"
     "AreaMask0ShapeFeather_1=20\n", None),
    ("DrawnMaskEnabled_1=true\nDrawnMaskStrokes_1=1;0.1;1;1;0.5;0.5;\n",
     None),
    ("ExternalMaskEnabled_1=true\nExternalMaskFilename_1={file}\n",
     "image"),
    ("MaskEnabled_1=true\nLinkedMaskEnabled_1=true\n"
     "LinkedMask_1=localcontrast|sky\nMaskName_2=sky\nContrast_2=10\n",
     None),
    ("ExternalMaskEnabled_1=true\nExternalMaskFilename_1={file}\n",
     "empty"),
    ("ExternalMaskEnabled_1=true\nExternalMaskFilename_1={file}\n",
     "text"),
], ids=["area", "drawn", "external", "linked", "external-empty",
        "external-text"])
def test_unported_masks_raise_by_name(tmp_path, keys, file):
    # ported since: the area, drawn, external-file and linked masks plan
    # as the reference's, the same static and data (the rasterised planes
    # within 1e-5); an external file that is empty or no image raises
    # OSError in both decoders, which plans the region unmasked
    # (ext_radius -1, no plane), as in the reference
    from chip_smoke import write_mask_png

    path = tmp_path / "mask.png"
    if file == "image":
        write_mask_png(str(path), 40, 50)
    elif file == "empty":
        path.write_bytes(b"")
    elif file == "text":
        path.write_bytes(b"hello")
    text = "[Local Contrast]\nEnabled=true\nContrast_1=30\n" + keys.format(
        file=path)

    def plans(text):
        pp, ref = _pps(text)
        m = masks.regions_from_extra(pp, "Local Contrast", FIELDS)[0][1]
        rm = rmasks.regions_from_extra(ref, "Local Contrast", FIELDS)[0][1]
        return (masks.plan_mask(m, (32, 32), pp, "cpu"),
                rmasks.plan_mask(rm, (32, 32), ref))

    (st, data), (rst, rdata) = plans(text)
    assert st == rst
    assert sorted(data) == sorted(rdata)
    for k in rdata:
        np.testing.assert_allclose(data[k], rdata[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    if file in ("empty", "text"):
        assert st[11] == -1 and not data
    else:  # a plane, or the linked mask's own plan
        assert data or st[12] is not None
    # a missing mask file, or a linked name that resolves to no mask,
    # plans the region unmasked, as in the reference
    text = text.replace(str(path), str(tmp_path / "missing.png")).replace(
        "MaskName_2=sky", "MaskName_2=sea")
    if file or "Linked" in keys:
        (st, data), (rst, _) = plans(text)
        assert st == rst and not data


def test_atrous_matches_reference():
    # a 40x90 plane: the coarse levels' reflect pads (up to 64) pass the
    # rows' count, where the reflection repeats
    y = np.random.default_rng(5).uniform(0.0, 1.0, (40, 90)).astype(
        np.float32)
    d, r = wavelet.atrous_decompose(torch.from_numpy(y), 6)
    rd, rr = rwav.atrous_decompose(jnp.asarray(y), 6)
    for a, b in zip(d + [r], rd + [rr]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(
        wavelet.atrous_reconstruct(d, r).numpy(),
        np.asarray(rwav.atrous_reconstruct(rd, rr)), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    path = tmp_path_factory.mktemp("lut") / "c.cube"
    write_cube(str(path), 9)
    return str(path)


def _op_settings(case, cube):
    def setup(pp):
        if case == "localcontrast":
            pp.apply_arp_text(GROUP)
        elif case.startswith("toneequalizer"):
            te = pp.tone_equalizer
            te.enabled = True
            te.band0, te.band1, te.band3, te.band4 = -20, -10, 10, 20
            te.regularization = int(case[-1])
            te.pivot = 0.5
        elif case.startswith("dehaze"):
            pp.dehaze.enabled = True
            pp.dehaze.luminance = case.endswith("luminance")
            pp.dehaze.depth = 30
        elif case == "filmsim":
            pp.film_simulation.enabled = True
            pp.film_simulation.clut_filename = cube
            pp.film_simulation.strength = 80
        return pp
    return setup


OP_CASES = [("localcontrast", "localcontrast"),
            ("toneequalizer0", "toneequalizer"),
            ("toneequalizer1", "toneequalizer"),
            # regularization 2: radius 350 and 700 guided filters, past
            # the 48x64 plane
            ("toneequalizer2", "toneequalizer"),
            ("dehaze", "dehaze"), ("dehaze-luminance", "dehaze"),
            ("filmsim", "filmsim")]


@pytest.mark.parametrize("profile", ["Rec2020", "sRGB"])
@pytest.mark.parametrize("case,op", OP_CASES, ids=[c for c, _ in OP_CASES])
def test_op_matches_reference(rgb, cube, case, op, profile):
    setup = _op_settings(case, cube)
    frame = synthesize_bayer(np.full((3, 48, 64), 0.5))
    ours_mod = importlib.import_module(f"art_tpu_torch.ops.{op}")
    ref_mod = importlib.import_module(f"art_tpu.ops.{op}")
    ctx = {"working_profile": profile, "frame": frame}
    st, data = ours_mod.plan(setup(ProcParams()), ctx)
    rst, rdata = ref_mod.plan(setup(RefProcParams()), ctx)
    assert st == rst
    a = ours_mod.apply(torch.from_numpy(rgb), tdev.data_to_torch(data, "cpu"),
                       st).numpy()
    b = np.asarray(ref_mod.apply(jnp.asarray(rgb), rdata, rst))
    print(case, profile, "max diff", np.abs(a - b).max())
    assert np.abs(b - rgb).max() > 100.0  # the op changed the image
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=65535 * 1e-5)


def test_cube_parse_matches_reference(tmp_path):
    rng = np.random.default_rng(7)
    vals = rng.uniform(0.0, 1.0, (4 ** 3, 3))
    text = ("# a comment\nTITLE \"t\"\nLUT_3D_SIZE 4\n"
            "DOMAIN_MIN 0.0 0.1 0.0\nDOMAIN_MAX 1.0 0.9 1.0\n\n"
            + "".join(f"{r:.6f} {g:.6f} {b:.6f}\n" for r, g, b in vals))
    path = tmp_path / "t.cube"
    path.write_text(text)
    t, lo, hi = lut3d.load_cube(str(path))
    rt, rlo, rhi = rlut.load_cube(str(path))
    np.testing.assert_array_equal(t, rt)
    np.testing.assert_array_equal(lo, rlo)
    np.testing.assert_array_equal(hi, rhi)
    assert t.shape == (4, 4, 4, 3)
    np.testing.assert_array_equal(lut3d.load_lut3d(str(path)),
                                  rlut.load_lut3d(str(path)))
    (tmp_path / "bad.cube").write_text("LUT_3D_SIZE 4\n0 0 0\n")
    with pytest.raises(ValueError):
        lut3d.load_cube(str(tmp_path / "bad.cube"))


def test_tetrahedral_matches_reference():
    n = 9
    rng = np.random.default_rng(8)
    table = rng.uniform(0.0, 1.0, (n, n, n, 3)).astype(np.float32)
    k = np.arange(n) / (n - 1.0)
    tie = rng.uniform(-0.1, 1.1, 300)
    faces = np.concatenate([k, np.zeros(n), np.ones(n)])
    r = np.concatenate([rng.uniform(-0.1, 1.1, 2000), tie, faces, faces,
                        tie + 0.3 / (n - 1)])
    g = np.concatenate([rng.uniform(-0.1, 1.1, 2000), tie, k.repeat(3),
                        faces[::-1], tie])
    b = np.concatenate([rng.uniform(-0.1, 1.1, 2000), tie,
                        np.ones(3 * n), faces, tie])
    chans = [c.astype(np.float32).reshape(1, -1) for c in (r, g, b)]
    ours = lut3d.apply_tetrahedral(*(torch.from_numpy(c) for c in chans),
                                   torch.from_numpy(table))
    ref = rlut.apply_tetrahedral(*(jnp.asarray(c) for c in chans),
                                 jnp.asarray(table))
    for a, bb in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), rtol=0,
                                   atol=1e-5)
    # at the lattice points the table itself
    node = torch.tensor([[0.0, 0.5, 1.0]])
    got = lut3d.apply_tetrahedral(node, node, node, torch.from_numpy(table))
    for c in range(3):
        np.testing.assert_allclose(
            got[c].numpy()[0], table[[0, 4, 8], [0, 4, 8], [0, 4, 8], c],
            rtol=0, atol=1e-6)


def _write_lut(path):
    """A film-simulation file of each kind (chip_smoke's P3 files, small):
    a level-2 Hald PNG, a CTL script, a CLF (also gzipped as .clfz), an
    external generator's JSON config."""
    import gzip
    import shutil

    import chip_smoke

    name = os.path.basename(path)
    if name.endswith(".png"):
        chip_smoke.write_hald(path, level=2, bits=8)
    elif name.endswith(".ctl"):
        chip_smoke.write_ctl(path)
    elif name.endswith(".clf"):
        chip_smoke.write_clf(path, n=5)
    elif name.endswith(".clfz"):
        chip_smoke.write_clf(path + ".tmp", n=5)
        with open(path + ".tmp", "rb") as f, gzip.open(path, "wb") as g:
            shutil.copyfileobj(f, g)
    else:
        cfg = chip_smoke.write_extlut(os.path.dirname(path))
        shutil.move(cfg, path)


@pytest.mark.parametrize("name,match", [
    ("look.png", "Hald CLUT"), ("look.ctl", "CTL"), ("look.clf", "CLF"),
    ("look.clfz", "CLF"), ("look.json", "JSON")])
def test_unported_luts_raise_by_name(tmp_path, name, match):
    # ported since: each kind plans as the reference does. A file that
    # does not exist or cannot be read plans nothing in both; a file of
    # the kind plans the same static part and the same tables
    from art_tpu.ops import filmsim as rfilmsim
    from art_tpu_torch.ops import filmsim

    frame = synthesize_bayer(np.full((3, 32, 32), 0.5))
    ctx = {"working_profile": "Rec2020", "frame": frame, "device": "cpu"}
    pp, ref_pp = ProcParams(), RefProcParams()
    for p in (pp, ref_pp):
        p.film_simulation.enabled = True
        p.film_simulation.strength = 80
        p.film_simulation.clut_filename = str(tmp_path / "missing" / name)
    assert filmsim.plan(pp, ctx) is None
    assert rfilmsim.plan(ref_pp, ctx) is None
    (tmp_path / name).write_bytes(b"x")
    for p in (pp, ref_pp):
        p.film_simulation.clut_filename = str(tmp_path / name)
    assert filmsim.plan(pp, ctx) is None
    assert rfilmsim.plan(ref_pp, ctx) is None
    (tmp_path / name).unlink()
    (tmp_path / "lut").mkdir()
    path = str(tmp_path / "lut" / name)
    _write_lut(path)
    for p in (pp, ref_pp):
        p.film_simulation.clut_filename = path
    static, data = filmsim.plan(pp, ctx)
    ref_static, ref_data = rfilmsim.plan(ref_pp, ctx)
    assert static == ref_static, match
    assert sorted(data) == sorted(ref_data)
    for k in data:
        if k == "clf_arrays":
            for ours, ref in zip(data[k], ref_data[k]):
                for a, b in zip(ours, ref):
                    np.testing.assert_array_equal(a, b)
        else:
            # a baked CTL table: the same float32 operations, whose
            # log and pow round differently in XLA and PyTorch (values
            # up to ~100, scene-linear)
            tol = 1e-5 if static[0] == "ctl" else 0
            np.testing.assert_allclose(data[k], ref_data[k], rtol=tol,
                                       atol=tol, err_msg=k)


def test_relative_lut_resolves_against_cluts_dir(cube, monkeypatch):
    from art_tpu_torch.ops import filmsim
    from art_tpu_torch.settings import settings

    frame = synthesize_bayer(np.full((3, 32, 32), 0.5))
    pp = ProcParams()
    pp.film_simulation.enabled = True
    pp.film_simulation.clut_filename = os.path.basename(cube)
    pp.film_simulation.after_tone_curve = True
    ctx = {"working_profile": "sRGB", "frame": frame}
    assert filmsim.plan_post(pp, ctx) is None
    monkeypatch.setattr(settings, "cluts_dir", os.path.dirname(cube))
    static, data = filmsim.plan_post(pp, ctx)
    assert static == ("hald", True) and data["table"].shape == (9, 9, 9, 3)
    assert filmsim.plan(pp, ctx) is None  # the post-curve position only


@pytest.mark.parametrize("group", ["Local Contrast", "TextureBoost",
                                   "Smoothing"])
def test_unsuffixed_region_groups_plan_no_step(group):
    # the reference reads only suffixed region keys: an unsuffixed group
    # (as tools/bench_configs.py writes config 4's local contrast) plans
    # no step, and the port develops it without raising
    text = f"[{group}]\nEnabled=true\nContrast=30\nStrength=40\nMode=1\n"
    ours, ref = _pps(text)
    ours.raw.bayer.method = ref.raw.bayer.method = "bilinear"
    frame = synthesize_bayer(np.random.default_rng(2).uniform(
        0.1, 0.9, (3, 64, 96)))
    cfg, _ = tdev.plan(frame, ours)
    ref_cfg, _ = jdev.plan(frame, ref)
    assert cfg.steps == ref_cfg.steps == ()
    out = tdev.develop(frame, ours, device="cpu")
    assert out.shape == (3, 64, 96)
    # with a region key, the reference plans the op, and so does the port
    ours, ref = _pps(text.replace("Contrast=30", "Contrast_1=30").replace(
        "Strength=40", "Strength_1=40").replace("Mode=1", "Mode_1=1"))
    ours.raw.bayer.method = ref.raw.bayer.method = "bilinear"
    names = [s[0] for s in jdev.plan(frame, ref)[0].steps]
    assert names == [{"Local Contrast": "localcontrast",
                      "TextureBoost": "textureboost",
                      "Smoothing": "smoothing"}[group]]
    assert [s[0] for s in tdev.plan(frame, ours)[0].steps] == names


@pytest.fixture(scope="module")
def frame():
    return synthesize_xtrans(np.random.default_rng(2).uniform(
        0.02, 0.95, (3, 192, 288)).astype(np.float32))


def test_plan_matches_reference(frame, cube):
    cfg, data = tdev.plan(frame, config4_pp(cube, ProcParams()))
    ref_cfg, ref_data = jdev.plan(frame, config4_pp(cube, RefProcParams()))
    for f in dataclasses.fields(ref_cfg):
        assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    assert [s[0] for s in cfg.steps] == ["dehaze", "toneequalizer",
                                         "filmsim_pre", "localcontrast"]
    assert sorted(data) == sorted(ref_data)


def test_develop_matches_reference(frame, cube):
    out = tdev.develop(frame, config4_pp(cube, ProcParams()), device="cpu")
    assert out.shape == (3, 192, 288) and out.dtype == torch.float32
    ref = np.asarray(jdev.develop(frame, config4_pp(cube, RefProcParams())))
    st = parity(out, ref)
    print("config 4 develop, port vs art_tpu", st)
    assert st["max_lsb8"] <= 1.0, st
    assert st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st
