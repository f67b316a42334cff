"""X-Trans in art_tpu_torch against `art_tpu` on the CPU: the colour
index (host and device, with offsets), the synthetic frame, the scale
plan's 24-row period, each demosaic method on the same seeded mosaic,
4-pass with its dual blend (the plan, the demosaic and a develop), the
raw steps' plan as the
reference plans them for X-Trans, and a synthetic X-Trans RAF from
`tests/util_raf.write_raf` through `cli.main` against the reference's
`process_image` (u8 output, as tests/test_torch_process_image.py holds
the DNG).

Tolerances: the index, the frame and the plan equal exactly; each
demosaic method within 0.05 of 65535 (the same float32 operations in
the same order; measured equal bit for bit on x86); the CLI's u8 output
max <= 1 and >= 99.9% equal (PERF.md section 2).
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.core import image as rimage
from art_tpu.demosaic import registry as ref_registry
from art_tpu.io import rawfile as rraw
from art_tpu.params import ProcParams as RefProcParams
from art_tpu.raw import preprocess as rpre
from art_tpu_torch.core import image as timage
from art_tpu_torch.demosaic import xtrans as txt
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev
from art_tpu_torch.raw import preprocess as tpre
from chip_smoke import parity
from test_torch_process_image import check_u8
from util_raf import write_raf

# the reference's 4-pass imports its dual module, which registers the
# dual names: let the registry fill first, or it would hold those alone
# (and every other method fall back to bilinear) in this process
ref_registry.get("amaze")
from art_tpu.demosaic import xtrans as rxt  # noqa: E402

jdev = importlib.import_module("art_tpu.pipeline.develop")

PATTERN = timage.XTRANS_CANONICAL


def test_colour_index_matches_reference():
    assert PATTERN == rraw.XTRANS_CANONICAL
    np.testing.assert_array_equal(
        timage.xtrans_color_index(PATTERN, (30, 42)),
        rimage.xtrans_color_index(PATTERN, (30, 42)))
    for dy, dx in ((0, 0), (-1, 0), (1, -1), (-3, 3), (2, 5)):
        ours = timage.xtrans_color_index_device(PATTERN, (30, 42), "cpu",
                                                dy=dy, dx=dx)
        ref = rimage.xtrans_color_index_device(PATTERN, (30, 42), dy, dx)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_synthetic_frame_and_scale_plan_match_reference():
    rgb = np.random.default_rng(4).uniform(0.02, 0.95, (3, 60, 90))
    ours, ref = timage.synthesize_xtrans(rgb), rraw.synthesize_xtrans(rgb)
    np.testing.assert_array_equal(ours.cfa, ref.cfa)
    assert ours.xtrans == ref.xtrans and ours.pattern is None
    for mono in (False, True):
        a = tpre.scale_plan(ours, None, 1.0, mono, (1.9, 1.0, 1.4))
        b = rpre.scale_plan(ref, None, 1.0, mono, (1.9, 1.0, 1.4))
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["offset_tile"].shape == (24, 128)  # lcm(6, 8) rows


@pytest.fixture(scope="module")
def mosaic():
    return (np.random.default_rng(0).uniform(0.05, 0.9, (96, 144))
            * 40000).astype(np.float32)


@pytest.mark.parametrize("method", ["fast", "1-pass (medium)", "2-pass",
                                    "3-pass (best)", "4-pass", "mono",
                                    "none", "an unknown name"])
def test_demosaic_matches_reference(mosaic, method):
    # 4-pass with its dual blend off (DualDemosaicAutoContrast false,
    # contrast 0): four passes; an unknown name runs three, as in the
    # reference
    kw = (("dual_contrast", 0.0), ("dual_auto", False))
    ours = txt.demosaic_xtrans(torch.from_numpy(mosaic), PATTERN, method,
                               kw).numpy()
    ref = np.asarray(rxt.demosaic_xtrans(jnp.asarray(mosaic), PATTERN,
                                         method, **dict(kw)))
    print(method, np.abs(ours - ref).max())
    assert ours.shape == (3, 96, 144)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=0.05)


def test_green_directional_matches_reference(mosaic):
    ours = txt.green_directional(torch.from_numpy(mosaic), PATTERN)
    ref = rxt.green_directional(jnp.asarray(mosaic), PATTERN)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=0.05)


@pytest.fixture(scope="module")
def small_frame():
    return timage.synthesize_xtrans(
        np.random.default_rng(1).uniform(0.02, 0.95, (3, 48, 72)))


def test_four_pass_dual_blend_raises_by_name(mosaic, small_frame):
    # 4-pass under the default DualDemosaicAutoContrast blends against
    # the fast method (demosaic/dual.py), as in the reference: the same
    # plan, the demosaic within 0.05 of 65535 (automatic and a fixed
    # contrast), the develop within the slice bounds (measured: the
    # blend's exp, 0.0002 LSB8)
    pp, ref_pp = ProcParams(), RefProcParams()
    for p in (pp, ref_pp):
        p.raw.xtrans.method = "4-pass (best)"
    assert pp.raw.xtrans.dual_demosaic_auto_contrast  # the default
    cfg, _ = tdev.plan(small_frame, pp, device="cpu")
    ref_cfg, _ = jdev.plan(small_frame, ref_pp)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert dict(cfg.dem_kwargs)["dual_auto"] is True
    for kw in ((("dual_auto", True), ("dual_contrast", 20.0)),
               (("dual_auto", False), ("dual_contrast", 35.0))):
        ours = txt.demosaic_xtrans(torch.from_numpy(mosaic), PATTERN,
                                   "4-pass", kw).numpy()
        ref = np.asarray(rxt.demosaic_xtrans(jnp.asarray(mosaic), PATTERN,
                                             "4-pass", **dict(kw)))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=0.05)
    out = tdev.develop(small_frame, pp, device="cpu").numpy()
    st = parity(out, np.asarray(jdev.develop(small_frame, ref_pp)))
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st


def _raw_settings(pp):
    pp.raw.xtrans.method = "2-pass"
    pp.raw.hotdead_enabled = True
    pp.raw.hotpixel_filter = True
    pp.raw.bayer.green_eq_enabled = True
    pp.raw.bayer.green_eq = 100.0
    pp.raw.bayer.linenoise = 10.0
    pp.raw.ca_enabled = True
    pp.raw.ca_autocorrect = True
    return pp


def test_bayer_raw_steps_plan_as_the_reference(small_frame):
    # green equilibration, line denoise and raw CA are Bayer steps: the
    # reference plans none of them for X-Trans; it plans the hot/dead
    # filter and runs it on Bayer mosaics only
    cfg, data = tdev.plan(small_frame, _raw_settings(ProcParams()))
    ref_cfg, ref_data = jdev.plan(small_frame, _raw_settings(RefProcParams()))
    for name in ("xtrans", "pattern", "demosaic_method", "dem_kwargs",
                 "hotdead", "green_eq", "linedn", "ca_mode", "shape"):
        assert getattr(cfg, name) == getattr(ref_cfg, name), name
    for k in ("raw_offset", "raw_scale", "rgb_mults", "cam2work"):
        np.testing.assert_array_equal(data[k], ref_data[k], err_msg=k)
    out = tdev.develop(small_frame, _raw_settings(ProcParams()),
                       device="cpu")
    assert out.shape == (3, 48, 72)


@pytest.fixture(scope="module")
def raf(tmp_path_factory):
    """A synthetic X-Trans RAF (96x144, 14-bit range) from a seed, and a
    profile that selects 3-pass."""
    d = tmp_path_factory.mktemp("xtrans")
    rgb = np.random.default_rng(11).uniform(0.05, 0.9, (3, 96, 144))
    frame = rraw.synthesize_xtrans(rgb.astype(np.float32), black=0.0,
                                   white=15000.0)
    write_raf(str(d / "shot.raf"), np.round(frame.cfa).astype(np.uint16),
              xtrans=PATTERN, wb_grbg=(1024, 2048, 1536, 1024))
    (d / "xtrans.arp").write_text("[RAW X-Trans]\nMethod=3-pass (best)\n")
    return d


def test_raf_through_the_cli_matches_the_reference(raf, tmp_path):
    from art_tpu.pipeline.develop import process_image as ref_process
    from art_tpu_torch import cli
    from art_tpu_torch.io.rawfile import load_raw

    frame = load_raw(str(raf / "shot.raf"))
    assert frame.xtrans == PATTERN and frame.pattern is None
    out = tmp_path / "ours.jpg"
    rc = cli.main(["-Y", "-p", str(raf / "xtrans.arp"), "-o", str(out),
                   "-c", str(raf / "shot.raf")], device="cpu")
    assert rc == 0
    data = out.read_bytes()
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    pp = ProcParams()
    pp.apply_arp_text((raf / "xtrans.arp").read_text())
    ours = tdev.process_image(str(raf / "shot.raf"), pp,
                              output_path=str(tmp_path / "again.jpg"),
                              device="cpu")
    assert (tmp_path / "again.jpg").read_bytes() == data
    rpp = RefProcParams()
    rpp.apply_arp_text((raf / "xtrans.arp").read_text())
    ref = ref_process(str(raf / "shot.raf"), rpp,
                      output_path=str(tmp_path / "ref.jpg"))
    assert ours.shape == (96, 144, 3)
    check_u8(ours, ref)
