"""The raw calibration of art_tpu_torch against `art_tpu`, on the CPU:
the dark frame, the flat field (Bayer and X-Trans, each blur type), the
embedded DNG gain map, the .badpixels file, CFA line denoise and the
PDAF line filter; their host copies (the gain-map parse, the dark-frame
and flat-field searches, the .badpixels parse) on files the tests
write; and both planners' PipelineConfig and data for each.

Inputs are made from a seed with numpy and handed to both packages. The
device functions the reference defines on their own are called
directly; the gain map and the lens vignettes, which the reference
writes inline in its device program, are read from each program as the
mosaic it hands to the demosaic (`raw_stage`). Bounds: 1.0 of 65535 on
values up to 65535. The flat field's box means and PDAF's row profiles
difference float32 running sums, which the two packages round apart
(the error grows with the sum's length): the flat field stays inside
the bound at a 4096-row plane (0.31 at most, measured), PDAF's filter is
bounded at 5e-5 of the value (2.4e-5 measured on a 2048-wide plane).
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.params import ProcParams as RefProcParams
from art_tpu_torch.core.image import (XTRANS_CANONICAL, bayer_channel_masks,
                                     synthesize_bayer, synthesize_xtrans,
                                     xtrans_color_index_device)
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev

jdev = importlib.import_module("art_tpu.pipeline.develop")

H, W = 64, 96
LSB = 1.0  # of 65535


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _max_diff(ours, ref):
    return float(np.max(np.abs(np.asarray(ours, np.float64)
                               - np.asarray(ref, np.float64))))


def _raw_plane(seed, shape=(H, W), lo=600.0, hi=16000.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, shape).astype(np.float32)


# ------------------------------------------------------------ device steps

def test_subtract_dark():
    from art_tpu.raw.dfff import subtract_dark as ref_fn
    from art_tpu_torch.raw.dfff import subtract_dark

    cfa, dark = _raw_plane(1), _raw_plane(2, lo=400.0, hi=1400.0)
    dark[::7] += 20000.0  # rows darker than the scene clip at 0
    ours = subtract_dark(_t(cfa), _t(dark)).numpy()
    ref = np.asarray(ref_fn(jnp.asarray(cfa), jnp.asarray(dark)))
    assert (ours == 0).any()
    assert _max_diff(ours, ref) == 0.0


def _flat(seed, shape):
    """A flat grey under a radial falloff, with per-site noise."""
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    r2 = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2) / (h * h / 4 + w * w / 4)
    noise = np.random.default_rng(seed).normal(0.0, 40.0, shape)
    return (512.0 + 9000.0 * (1.0 - 0.45 * r2) + noise).astype(np.float32)


# (shape, blur, radius, bound in ADU): the long axis runs its box sums
# over 2048 subplane rows, as a 4000-row frame does
FLATS = [((H, W), "area", 32, LSB), ((H, W), "area", 8, LSB),
         ((H, W), "v", 32, LSB), ((H, W), "h", 32, LSB),
         ((H, W), "vh", 4, LSB), ((4096, 64), "v", 32, LSB),
         ((4096, 64), "area", 32, LSB)]


@pytest.mark.parametrize("shape,blur,radius,bound", FLATS, ids=[
    "area-32", "area-8", "v", "h", "vh", "long-v", "long-area"])
def test_flatfield_bayer(shape, blur, radius, bound):
    from art_tpu.raw.dfff import apply_flatfield_bayer as ref_fn
    from art_tpu_torch.raw.dfff import apply_flatfield_bayer

    cfa, flat = _raw_plane(3, shape), _flat(4, shape)
    ours = apply_flatfield_bayer(_t(cfa), _t(flat), blur, radius).numpy()
    ref = np.asarray(ref_fn(jnp.asarray(cfa), jnp.asarray(flat), blur,
                            radius))
    d = np.abs(ours.astype(np.float64) - ref)
    print(blur, radius, shape, "max", d.max(), "relative", (d / ref).max())
    assert d.max() <= bound


@pytest.mark.parametrize("blur", ["area", "v", "h", "vh"])
def test_flatfield_xtrans(blur):
    from art_tpu.core.image import xtrans_color_index_device as ref_cidx
    from art_tpu.raw.dfff import apply_flatfield_xtrans as ref_fn
    from art_tpu_torch.raw.dfff import apply_flatfield_xtrans

    shape = (72, 96)
    cfa, flat = _raw_plane(5, shape), _flat(6, shape)
    cidx = xtrans_color_index_device(XTRANS_CANONICAL, shape, "cpu")
    ours = apply_flatfield_xtrans(_t(cfa), _t(flat), cidx, blur, 12).numpy()
    ref = np.asarray(ref_fn(jnp.asarray(cfa), jnp.asarray(flat),
                            ref_cidx(XTRANS_CANONICAL, shape), blur, 12))
    d = np.abs(ours.astype(np.float64) - ref)
    print(blur, "max", d.max())
    assert d.max() <= LSB


@pytest.mark.parametrize("direction", [1, 2, 3])
def test_cfa_line_denoise(direction):
    from art_tpu.raw.cfa_linedn import cfa_line_denoise as ref_fn
    from art_tpu_torch.raw.cfa_linedn import cfa_line_denoise

    rng = np.random.default_rng(7)
    cfa = rng.uniform(2000.0, 40000.0, (H, W)).astype(np.float32)
    cfa += rng.normal(0.0, 300.0, (H, 1)).astype(np.float32)  # row bands
    cfa += rng.normal(0.0, 300.0, (1, W)).astype(np.float32)  # columns
    ours = cfa_line_denoise(_t(cfa), 30.0, direction).numpy()
    ref = np.asarray(ref_fn(jnp.asarray(cfa), 30.0, direction))
    assert _max_diff(ours, cfa) > 10.0  # the bands moved
    assert _max_diff(ours, ref) <= LSB


def test_pdaf_filter():
    from art_tpu.core.image import bayer_channel_masks as ref_masks
    from art_tpu.raw.pdaf import pdaf_filter as ref_fn
    from art_tpu.raw.pdaf import pdaf_row_mask as ref_rows
    from art_tpu_torch.raw.pdaf import pdaf_filter, pdaf_row_mask

    shape = (H, 2048)
    cfa = _raw_plane(8, shape, 20000.0, 40000.0)
    rows = pdaf_row_mask([0, 18], 5, shape[0])
    np.testing.assert_array_equal(rows, ref_rows([0, 18], 5, shape[0]))
    cfa[rows] *= 0.97  # PDAF rows read low
    _, mg, _ = bayer_channel_masks("RGGB", shape, "cpu")
    _, rmg, _ = ref_masks("RGGB", shape, xp=jnp)
    ours = pdaf_filter(_t(cfa), mg, _t(rows)).numpy()
    ref = np.asarray(ref_fn(jnp.asarray(cfa), rmg,
                            jnp.asarray(rows, jnp.float32)))
    assert _max_diff(ours, cfa) > 100.0
    # the row profiles difference running sums of up to 1024 green
    # values ~3e4 (a float32 step of 2-4 there) over 17 samples, so the
    # two packages' profiles, and the ratio, round apart by up to ~1e-5
    # (measured 2.4e-5 of the value at most)
    d = np.abs(ours.astype(np.float64) - ref) / ref
    print("max relative", d.max(), "max", _max_diff(ours, ref))
    assert d.max() <= 5e-5


# ----------------------------------------------- the programs' raw stages

class _Stop(Exception):
    pass


def raw_stage(package, config, inp, data):
    """The mosaic that `package`'s device program for config hands to its
    demosaic, from a run stopped there: numpy (H, W)."""
    got = {}

    def stop(cfa, *args, **kwargs):
        got["cfa"] = np.asarray(cfa)
        raise _Stop

    mp = pytest.MonkeyPatch()
    try:
        if package == "port":
            mp.setattr("art_tpu_torch.demosaic.demosaic", stop)
            run = tdev.build_run(config)
            args = (_t(inp), tdev.data_to_torch(data, "cpu"))
        else:
            mp.setattr("art_tpu.demosaic.demosaic", stop)
            run = jdev._build_run(config)
            args = (jnp.asarray(inp, jnp.float32), data)
        with pytest.raises(_Stop):
            run(*args)
    finally:
        mp.undo()
    return got["cfa"]


def _frame(seed=0, shape=(H, W), make="ART-TPU", model="Synthetic"):
    rgb = np.random.default_rng(seed).uniform(0.02, 0.95, (3, *shape))
    fr = synthesize_bayer(rgb.astype(np.float32), pattern="RGGB")
    return dataclasses.replace(fr, make=make, model=model)


def _pps(arp):
    """The port's and the reference's ProcParams from one .arp text."""
    out = []
    for cls in (ProcParams, RefProcParams):
        pp = cls()
        pp.raw.bayer.method = "bilinear"
        pp.apply_arp_text(arp)
        out.append(pp)
    return out


def assert_same_plan(frame, arp, **kw):
    """Both planners on one frame and .arp: the same PipelineConfig and
    the same data (rtol 1e-6, `test_torch_plan.assert_plans_equal`).
    Returns the port's (config, data)."""
    from tests.test_torch_plan import assert_plans_equal

    pp, ref_pp = _pps(arp)
    ours = tdev.plan(frame, pp, device="cpu", **kw)
    assert_plans_equal(ours, jdev.plan(frame, ref_pp, **kw))
    return ours


def _write_dng(path, cfa, **kw):
    from art_tpu_torch.io.dngwrite import write_dng

    write_dng(str(path), np.round(cfa).astype(np.uint16), pattern="RGGB",
              black=512, white=16383, compress=False, **kw)
    return str(path)


def _gain_maps(h, w, n=9, fall=0.4):
    gy, gx = np.mgrid[0:n, 0:n]
    py = gy * (h - 1) / (n - 1.0)
    px = gx * (w - 1) / (n - 1.0)
    gv = 1.0 / (1.0 - fall * (((py - h / 2) ** 2 + (px - w / 2) ** 2)
                              / (h * h / 4 + w * w / 4)))
    return [{"gains": (gv * (1.0 + 0.01 * k)).astype(np.float32),
             "top": t, "left": lft, "bottom": h, "right": w}
            for k, (t, lft) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1)))]


@pytest.fixture
def calib(tmp_path):
    """A 64x96 scene DNG with four gain maps, a dark frame and a flat
    field of its shape (DNGs), and a .badpixels file for its camera in
    the dark-frame directory the lookup reads."""
    fr = _frame(1)
    scene = _write_dng(tmp_path / "scene.dng", fr.cfa,
                       gain_maps=_gain_maps(H, W))
    dark = 512.0 + np.random.default_rng(2).uniform(0.0, 60.0, (H, W))
    dark[:, 40:43] += 900.0  # hot columns
    df = _write_dng(tmp_path / "dark.dng", dark)
    ff = _write_dng(tmp_path / "flat.dng", _flat(3, (H, W)))
    bp_dir = tmp_path / "bp"
    bp_dir.mkdir()
    (bp_dir / "ART-TPU Synthetic.badpixels").write_text(
        "1\n4 5\n10 20\n95 63\n200 3\n")
    mp = pytest.MonkeyPatch()
    mp.setenv("ART_TPU_DARKFRAMES", str(bp_dir))
    yield {"scene": scene, "df": df, "ff": ff, "dir": tmp_path}
    mp.undo()


def _scene(calib):
    from art_tpu_torch.io.rawfile import load_raw

    return load_raw(calib["scene"])


CALIB = {
    "dark-frame": "[RAW]\nDarkFrameEnabled=true\nDarkFrame={df}\n",
    "flat-area": "[RAW]\nFlatFieldEnabled=true\nFlatFieldFile={ff}\n"
                 "FlatFieldBlurRadius=8\n",
    "flat-v": "[RAW]\nFlatFieldEnabled=true\nFlatFieldFile={ff}\n"
              "FlatFieldBlurType=Vertical\nFlatFieldBlurRadius=8\n",
    "flat-h": "[RAW]\nFlatFieldEnabled=true\nFlatFieldFile={ff}\n"
              "FlatFieldBlurType=Horizontal\n",
    "flat-vh": "[RAW]\nFlatFieldEnabled=true\nFlatFieldFile={ff}\n"
               "FlatFieldBlurType=V+H\nFlatFieldBlurRadius=4\n",
    # the embedded map wins over a flat-field file, at 80% strength
    "gain-map": "[RAW]\nFlatFieldEnabled=true\nFlatFieldUseEmbedded=true\n"
                "FlatFieldFile={ff}\nFlatFieldClipControl=20\n",
    "all": "[RAW]\nDarkFrameEnabled=true\nDarkFrame={df}\n"
           "FlatFieldEnabled=true\nFlatFieldUseEmbedded=true\n"
           "[RAW Bayer]\nLineDenoise=30\nPreprocessingEnabled=true\n",
}


@pytest.mark.parametrize("name", list(CALIB))
def test_calibration_plans_and_runs_as_the_reference(calib, name):
    frame = _scene(calib)
    arp = CALIB[name].format(df=calib["df"], ff=calib["ff"])
    cfg, data = assert_same_plan(frame, arp)
    assert cfg.badpix_file  # the .badpixels file applies in every case
    want = {"dark-frame": ("darkframe",), "gain-map": ("gainmap",),
            "all": ("darkframe", "gainmap")}.get(name, ("flatfield",))
    assert all(getattr(cfg, f) for f in want), cfg
    inp = tdev.pad_to_multiple(np.asarray(frame.cfa, np.float32),
                               tdev.PAD_MULTIPLE)[0]
    ours = raw_stage("port", cfg, inp, data)
    ref = raw_stage("ref", cfg, inp, data)
    d = np.abs(ours.astype(np.float64) - ref)
    print(name, "max", d.max())
    assert d.max() <= LSB


def test_gain_map_parse_matches_reference(calib):
    from art_tpu.io import gainmap as ref_gm
    from art_tpu_torch.io import gainmap

    buf = gainmap.read_opcodelist2(calib["scene"])
    assert buf == ref_gm.read_opcodelist2(calib["scene"])
    maps, ref_maps = gainmap.parse_gain_maps(buf), ref_gm.parse_gain_maps(buf)
    assert len(maps) == len(ref_maps) == 4
    for m, r in zip(maps, ref_maps):
        assert sorted(m) == sorted(r)
        for k in m:
            np.testing.assert_array_equal(m[k], r[k], err_msg=k)
    for sf in (1.0, 0.8):
        np.testing.assert_array_equal(
            gainmap.build_gain_plane(maps, (H, W), sf),
            ref_gm.build_gain_plane(ref_maps, (H, W), sf))
    bad = [dict(m, row_pitch=4) for m in maps]
    assert gainmap.build_gain_plane(bad, (H, W)) is None
    assert ref_gm.build_gain_plane(bad, (H, W)) is None
    assert gainmap.parse_gain_maps(None) == []


def test_broken_gain_map_is_skipped_as_in_the_reference(tmp_path):
    # a file that is not a TIFF: the parse fails on the host and the
    # reference plans no gain map
    path = tmp_path / "scene.dng"
    path.write_bytes(b"not a tiff")
    frame = dataclasses.replace(_frame(1), filename=str(path))
    cfg, _ = assert_same_plan(
        frame, "[RAW]\nFlatFieldEnabled=true\nFlatFieldUseEmbedded=true\n")
    assert not cfg.gainmap and cfg.flatfield is None


def test_calibration_frames_of_another_shape_are_skipped(calib, tmp_path):
    small = _write_dng(tmp_path / "small.dng", _flat(3, (32, 48)))
    cfg, data = assert_same_plan(_scene(calib), (
        "[RAW]\nDarkFrameEnabled=true\nDarkFrame={0}\n"
        "FlatFieldEnabled=true\nFlatFieldFile={0}\n").format(small))
    assert not cfg.darkframe and cfg.flatfield is None
    assert "df_plane" not in data and "ff_plane" not in data


def _search_dir(tmp_path, name, isos):
    d = tmp_path / name
    d.mkdir()
    for i, iso in enumerate(isos):
        _write_dng(d / f"{name}{i}.dng", _flat(10 + i, (H, W)), iso=iso)
    return str(d)


def test_dark_and_flat_searches_match_the_reference(calib, tmp_path):
    from art_tpu.raw import dfff_managers as ref_mgr
    from art_tpu_torch.raw import dfff_managers as mgr

    ref_settings_mod = importlib.import_module("art_tpu.settings")
    settings_mod = importlib.import_module("art_tpu_torch.settings")

    dfd = _search_dir(tmp_path, "darks", (100, 800, 3200))
    ffd = _search_dir(tmp_path, "flats", (100,))
    mp = pytest.MonkeyPatch()
    try:
        for s in (settings_mod.settings, ref_settings_mod.settings):
            mp.setattr(s, "dark_frames_dir", dfd)
            mp.setattr(s, "flat_fields_dir", ffd)
        mgr.reset()
        ref_mgr.reset()
        for iso in (100, 640, 2500, 6400):
            got = mgr.df_manager().search("ART-TPU", "Synthetic", iso, 0.01)
            assert got == ref_mgr.df_manager().search(
                "ART-TPU", "Synthetic", iso, 0.01)
            assert got is not None
        assert mgr.df_manager().search("Other", "Cam", 100, 0.0) is None
        assert mgr.ff_manager().search("ART-TPU", "Synthetic") \
            == ref_mgr.ff_manager().search("ART-TPU", "Synthetic")
        frame = _scene(calib)
        frame.iso = 700.0
        cfg, _ = assert_same_plan(
            frame, "[RAW]\nDarkFrameEnabled=true\nDarkFrameAuto=true\n"
                   "FlatFieldEnabled=true\nFlatFieldAutoSelect=true\n")
        assert cfg.darkframe and cfg.flatfield == ("area", 32)
    finally:
        mp.undo()
        mgr.reset()
        ref_mgr.reset()


def test_badpixels_file_matches_reference(calib):
    from art_tpu.raw import badpixfile as ref_bp
    from art_tpu_torch.raw import badpixfile

    path = badpixfile.find_badpixels_for("art-tpu", "SYNTHETIC")
    assert path == ref_bp.find_badpixels_for("art-tpu", "SYNTHETIC")
    pts = badpixfile.parse_badpixels_file(path)
    assert pts == ref_bp.parse_badpixels_file(path) == [
        (5, 6), (11, 21), (96, 64), (201, 4)]
    np.testing.assert_array_equal(badpixfile.badpixel_mask(pts, (H, W)),
                                  ref_bp.badpixel_mask(pts, (H, W)))


def test_pdaf_and_line_denoise_plan_and_run_as_the_reference():
    # FUJIFILM GFX 100's camconst entry carries a PDAF row pattern
    frame = _frame(4, make="FUJIFILM", model="GFX 100")
    cfa = frame.cfa.copy()
    cfa[(np.arange(H) % 18) == 0] *= 0.97
    frame = dataclasses.replace(frame, cfa=cfa)
    arp = ("[RAW Bayer]\nPDAFLinesFilter=true\nPreprocessingEnabled=true\n"
           "LineDenoise=30\nLineDenoiseDirection=3\n")
    cfg, data = assert_same_plan(frame, arp)
    assert cfg.pdaf and cfg.linedn == (30.0, 3)
    assert data["pdaf_rows"].shape == (tdev.PAD_MULTIPLE,)
    inp = tdev.pad_to_multiple(frame.cfa, tdev.PAD_MULTIPLE)[0]
    ours = raw_stage("port", cfg, inp, data)
    ref = raw_stage("ref", cfg, inp, data)
    d = np.abs(ours.astype(np.float64) - ref)
    print("max", d.max())
    assert d.max() <= LSB


def test_flat_field_on_xtrans_plans_and_runs_as_the_reference(tmp_path):
    from art_tpu_torch.io.dngwrite import write_dng

    shape = (72, 96)
    rgb = np.random.default_rng(9).uniform(0.02, 0.95, (3, *shape))
    frame = synthesize_xtrans(rgb.astype(np.float32))
    ff = str(tmp_path / "flat.dng")
    write_dng(ff, np.round(_flat(3, shape)).astype(np.uint16),
              black=512, white=16383, compress=False)
    cfg, data = assert_same_plan(
        frame, f"[RAW]\nFlatFieldEnabled=true\nFlatFieldFile={ff}\n"
               "FlatFieldBlurType=V+H\nFlatFieldBlurRadius=6\n")
    assert cfg.flatfield == ("vh", 6) and cfg.xtrans is not None
    inp = tdev.pad_to_multiple(frame.cfa, tdev.PAD_MULTIPLE)[0]
    ours = raw_stage("port", cfg, inp, data)
    ref = raw_stage("ref", cfg, inp, data)
    assert _max_diff(ours, ref) <= LSB
