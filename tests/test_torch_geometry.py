"""The export geometry of art_tpu_torch against `art_tpu`: coarse
rotation and flips, the crop, the Lanczos resize and its scale rule, the
fast export's plan (-q), the gamma output TRCs, develops of these at
64x96 and 96x160, and `cli.main -q` against the reference's CLI.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from art_tpu.params import ProcParams
from art_tpu_torch.core.image import synthesize_bayer
from art_tpu_torch.params import ProcParams as TorchProcParams
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import clipped_frame, config4_frame, parity

jdev = importlib.import_module("art_tpu.pipeline.develop")

# develops: PERF.md's slice bounds on the encoded output
DEV_MAX_LSB8, DEV_MEAN, DEV_WITHIN = 1.0, 2e-4, 0.999


def frame_of(h, w, seed=0):
    rgb = np.random.default_rng(seed).uniform(0.02, 0.95, (3, h, w))
    return synthesize_bayer(rgb.astype(np.float32), pattern="RGGB")


def both(text, method="bilinear"):
    """This package's and the reference's ProcParams for an .arp text."""
    out = []
    for cls in (TorchProcParams, ProcParams):
        pp = cls()
        pp.raw.bayer.method = method
        pp.apply_arp_text(text)
        out.append(pp)
    return out


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def assert_same_plan(frame, text, fast=False, method="bilinear"):
    """Both planners give the same PipelineConfig and data (rtol 1e-6)."""
    pp, ref_pp = both(text, method)
    cfg, data = tdev.plan(frame, pp, fast=fast)
    ref_cfg, ref_data = jdev.plan(frame, ref_pp, fast=fast)
    for f in dataclasses.fields(ref_cfg):
        assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    ours, ref = dict(_leaves(data)), dict(_leaves(ref_data))
    assert sorted(ours) == sorted(ref)
    for k, rv in ref.items():
        ov, rv = np.asarray(ours[k]), np.asarray(rv)
        assert ov.shape == rv.shape and ov.dtype == rv.dtype, k
        np.testing.assert_allclose(ov, rv, rtol=1e-6, atol=0, err_msg=k)
    return cfg, data


def assert_develops_as_reference(frame, text, fast=False, method="bilinear"):
    pp, ref_pp = both(text, method)
    out = tdev.develop(frame, pp, device="cpu", fast=fast).numpy()
    ref = np.asarray(jdev.develop(frame, ref_pp, fast=fast))
    assert out.shape == ref.shape
    st = parity(out, ref)
    print(text.replace("\n", " "), st)
    assert st["max_lsb8"] <= DEV_MAX_LSB8 and st["mean"] <= DEV_MEAN, st
    assert st["within_1lsb8"] >= DEV_WITHIN, st
    return out


@pytest.fixture(scope="module")
def frame():
    return frame_of(64, 96)


@pytest.mark.parametrize("rotate", [0, 90, 180, 270])
@pytest.mark.parametrize("flips", [(False, False), (True, False),
                                   (False, True), (True, True)],
                         ids=["none", "h", "v", "hv"])
def test_coarse_plan(frame, rotate, flips):
    cfg, _ = assert_same_plan(frame, (
        f"[Coarse Transformation]\nRotate={rotate}\n"
        f"HorizontalFlip={str(flips[0]).lower()}\n"
        f"VerticalFlip={str(flips[1]).lower()}\n"))
    assert cfg.orig_shape == ((96, 64) if rotate % 180 else (64, 96))
    assert cfg.late_crop == (rotate == 0 and flips == (False, False))


@pytest.mark.parametrize("crop", [(5, 7, 50, 40), (0, 0, 96, 64),
                                  (-3, 10, 200, 30), (20, 3, 0, 0)],
                         ids=["inside", "whole", "past-edges", "w-h-unset"])
def test_crop_plan(frame, crop):
    x, y, w, h = crop
    cfg, _ = assert_same_plan(frame, (
        f"[Crop]\nEnabled=true\nX={x}\nY={y}\nW={w}\nH={h}\n"))
    assert (cfg.crop is None) == (crop == (0, 0, 96, 64))


def test_coarse_crop_local_contrast_mask_plan(frame):
    # a parametric mask's region planned at the rotated, cropped image;
    # the ported masks hold no (H, W) plane for the crop to slice
    assert_same_plan(frame, (
        "[Coarse Transformation]\nRotate=90\n"
        "[Crop]\nEnabled=true\nX=4\nY=6\nW=40\nH=70\n"
        "[Local Contrast]\nEnabled=true\nContrast_1=30\n"
        "ParametricMaskEnabled_1=true\nLightnessMask_1=1;0.2;0.8;0.35;0.35;"
        "0.8;0.2;0.35;0.35;\n"))


def test_op_planes_fit_the_image():
    # stage 1-3 planes of (H, W): edge-padded on the late-crop path,
    # sliced to the crop window otherwise; other arrays and stage 0 stay
    plane = np.arange(6 * 8, dtype=np.float32).reshape(6, 8)
    steps = (("denoise", (), 0), ("localcontrast", (), 3))

    def data():
        return {"op:denoise": {"m": plane},
                "op:localcontrast": {"lc0": {"mask": [plane, plane[None]],
                                             "factors": np.ones(6)}}}

    d = data()
    tdev.fit_op_planes(d, steps, (6, 8), (8, 16), True, None)
    padded = d["op:localcontrast"]["lc0"]["mask"]
    np.testing.assert_array_equal(padded[0], np.pad(plane, ((0, 2), (0, 8)),
                                                    mode="edge"))
    assert padded[1].shape == (1, 8, 16)
    assert d["op:denoise"]["m"] is plane
    d = data()
    tdev.fit_op_planes(d, steps, (6, 8), (8, 16), False, (1, 2, 3, 4))
    cropped = d["op:localcontrast"]["lc0"]["mask"]
    np.testing.assert_array_equal(cropped[0], plane[1:4, 2:6])
    assert cropped[1].shape == (1, 3, 4)
    assert d["op:localcontrast"]["lc0"]["factors"].shape == (6,)


RESIZE_CASES = [
    # (DataSpecified, Scale, Width, Height, AppliesTo, AllowUpscaling)
    (0, 0.5, 0, 0, "Cropped area", False),
    (0, 1.5, 0, 0, "Cropped area", False),
    (0, 1.5, 0, 0, "Cropped area", True),
    (0, 1.000001, 0, 0, "Cropped area", True),
    (1, 1.0, 50, 0, "Cropped area", False),
    (1, 1.0, 50, 0, "Full image", False),
    (1, 1.0, 0, 0, "Cropped area", False),
    (2, 1.0, 0, 30, "Cropped area", False),
    (2, 1.0, 0, 300, "Full image", True),
    (3, 1.0, 48, 20, "Cropped area", False),
    (3, 1.0, 480, 200, "Full image", False),
    (3, 1.0, 480, 200, "Full image", True),
]


@pytest.mark.parametrize("case", RESIZE_CASES)
@pytest.mark.parametrize("crop", [None, (3, 4, 40, 60)],
                         ids=["no-crop", "crop"])
def test_resize_scale(case, crop):
    ds, scale, width, height, applies_to, up = case
    pp = ProcParams()
    rs = pp.resize
    rs.enabled, rs.data_specified, rs.scale = True, ds, scale
    rs.width, rs.height, rs.applies_to, rs.allow_upscaling = (
        width, height, applies_to, up)
    assert tdev._resize_scale(pp, 64, 96, crop) == jdev._resize_scale(
        pp, 64, 96, crop)


@pytest.mark.parametrize("text", [
    "[Resize]\nEnabled=true\nDataSpecified=3\nWidth=40\nHeight=40\n",
    # the 32-pixel floor of the target
    "[Resize]\nEnabled=true\nDataSpecified=0\nScale=0.1\n",
    "[Resize]\nEnabled=true\nDataSpecified=1\nWidth=120\n"
    "AllowUpscaling=true\n[Crop]\nEnabled=true\nX=10\nY=4\nW=60\nH=50\n"
    "[OutputSharpening]\nEnabled=true\nMethod=usm\n",
], ids=["box", "floor-32", "upscale-crop-prsharpen"])
def test_resize_plan(frame, text):
    cfg, data = assert_same_plan(frame, text)
    assert cfg.resize_to is not None
    assert data["resize_rows"].shape == (cfg.resize_to[0],
                                         cfg.crop[2] if cfg.crop else 64)


def test_lanczos_matrices_and_product():
    from art_tpu.ops import resize as jres
    from art_tpu_torch.ops import resize as tres

    for n_in, n_out in ((97, 40), (40, 97), (64, 64), (1000, 33)):
        np.testing.assert_array_equal(tres.lanczos_matrix(n_in, n_out),
                                      jres.lanczos_matrix(n_in, n_out))
    rgb = np.random.default_rng(2).uniform(0, 65535, (3, 97, 130)).astype(
        np.float32)
    a_r, a_c = jres.resize_plan((97, 130), (40, 57))
    ref = np.asarray(jres.apply_resize(rgb, a_r, a_c))
    out = tres.apply_resize(torch.from_numpy(rgb), torch.from_numpy(a_r),
                            torch.from_numpy(a_c)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-6, atol=2e-3)


@pytest.mark.parametrize("text", [
    "[Resize]\nEnabled=true\nDataSpecified=3\nWidth=48\nHeight=48\n",
    "[Resize]\nEnabled=true\nDataSpecified=3\nWidth=48\nHeight=48\n"
    "[Coarse Transformation]\nRotate=90\n"
    "[Crop]\nEnabled=true\nX=10\nY=20\nW=30\nH=50\n",
    # no downscale: the fast export is off
    "[Resize]\nEnabled=true\nDataSpecified=3\nWidth=480\nHeight=480\n",
    "[Coarse Transformation]\nRotate=90\n",
], ids=["box", "rotated-crop", "no-downscale", "no-resize"])
def test_fast_plan(frame, text):
    cfg, _ = assert_same_plan(frame, text, fast=True)
    assert cfg.resize_to is None


def test_fast_plan_downgrades_xtrans_3pass():
    xt = config4_frame(72, 96)
    cfg, _ = assert_same_plan(
        xt, "[RAW X-Trans]\nMethod=3-pass (best)\n"
        "[Resize]\nEnabled=true\nDataSpecified=3\nWidth=48\nHeight=48\n",
        fast=True)
    assert cfg.demosaic_method == "1-pass (medium)"
    assert cfg.early_resize == (72, 96, 36, 48)


@pytest.mark.parametrize("name", ["Adobe RGB", "ProPhoto"])
def test_gamma_trc_encode(name):
    import jax.numpy as jnp
    from art_tpu.color import colorspaces as jcs
    from art_tpu_torch.color import colorspaces as tcs

    trc = tcs.OUTPUT_GAMMAS[name]
    assert trc == jcs.OUTPUT_GAMMAS[name] and trc[0] == "gamma"
    tcs.check_trc(trc)
    x = np.random.default_rng(3).uniform(-0.1, 1.1, (3, 37, 41)).astype(
        np.float32)
    ref = np.asarray(jcs.encode_trc(jnp.asarray(x), trc, jnp))
    out = tcs.encode_trc(torch.from_numpy(x), trc).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("text", [
    # rotation, a flip, a crop and an Adobe RGB output (gamma TRC)
    "[Coarse Transformation]\nRotate=90\nHorizontalFlip=true\n"
    "[Crop]\nEnabled=true\nX=5\nY=9\nW=50\nH=70\n"
    "[Color Management]\nOutputProfile=RT_Medium_gsRGB\n",
    # a resize with post-resize USM after a vertical flip, to ProPhoto
    "[Coarse Transformation]\nRotate=270\nVerticalFlip=true\n"
    "[Resize]\nEnabled=true\nDataSpecified=3\nWidth=72\nHeight=72\n"
    "[OutputSharpening]\nEnabled=true\nMethod=usm\n"
    "[Color Management]\nOutputProfile=RT_Large_gsRGB\n",
], ids=["rot90-hflip-crop-adobe-64x96", "rot270-vflip-resize-prophoto-96x160"])
def test_geometry_develops_as_the_reference(text):
    h, w = (64, 96) if "Crop" in text else (96, 160)
    pp, _ = both(text)
    out = assert_develops_as_reference(frame_of(h, w, seed=4), text)
    cfg, _ = tdev.plan(frame_of(h, w, seed=4), pp)
    assert cfg.out_trc[0] == "gamma" and not cfg.late_crop
    assert tdev.fusion_gates(cfg)[1] is False


def test_fast_develop_with_everything_at_output_scale():
    # highlights, a rotation, a crop in rotated coordinates, the early
    # resize before them and sharpening after: 96x160 -> 48x80
    text = ("[Exposure]\nHLRecovery=Blend\n"
            "[Coarse Transformation]\nRotate=270\n"
            "[Crop]\nEnabled=true\nX=6\nY=10\nW=80\nH=120\n"
            "[Sharpening]\nEnabled=true\nMethod=usm\n"
            "[Resize]\nEnabled=true\nDataSpecified=3\nWidth=80\nHeight=80\n")
    frame = clipped_frame(96, 160, seed=6, share=0.1)
    cfg, data = assert_same_plan(frame, text, fast=True)
    assert cfg.early_resize == (96, 160, 48, 80) and cfg.crop == (5, 3, 60, 40)
    assert_develops_as_reference(frame, text, fast=True)


def test_cli_fast_export_matches_the_reference(tmp_path, monkeypatch):
    from art_tpu import cli as ref_cli
    from art_tpu.core import compilecache
    from art_tpu_torch import cli
    from PIL import Image

    from art_tpu_torch.io.dngwrite import write_dng

    monkeypatch.setattr(compilecache, "enable", lambda *a, **k: True)
    m = (np.random.default_rng(7).uniform(0.05, 0.9, (128, 192)) * 16000
         + 500).astype(np.uint16)
    write_dng(tmp_path / "in.dng", m, black=500, white=16500)
    (tmp_path / "web.arp").write_text(
        "[RAW Bayer]\nMethod=bilinear\n"
        "[Resize]\nEnabled=true\nWidth=96\nHeight=96\n")
    outs = {}
    for name, main in (("ours", lambda a: cli.main(a, device="cpu")),
                       ("ref", ref_cli.main)):
        out = tmp_path / f"{name}.jpg"
        rc = main(["-Y", "-q", "-p", str(tmp_path / "web.arp"), "-o",
                   str(out), "-c", str(tmp_path / "in.dng")])
        assert rc == 0
        outs[name] = np.asarray(Image.open(out).convert("RGB"))
    assert outs["ours"].shape == outs["ref"].shape == (64, 96, 3)
    d = np.abs(outs["ours"].astype(np.int16) - outs["ref"].astype(np.int16))
    assert d.max() <= 2 and (d <= 1).mean() >= 0.999, d.max()
