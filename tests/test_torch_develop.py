"""The whole slice: art_tpu_torch's plan -> develop -> crop_result on the
CPU against `art_tpu`'s develop, flagship profile with bilinear
demosaic at 256x1024 (the smallest shape at which both pass-fusion gates
and both kernels engage), on the encoded [0,1] output.

Bounds: the reference's wavelet shrink uses the TPU's approximate
reciprocal, the port exact division; that alone puts 0.43 of an 8-bit
step (max) and 6.8e-5 (mean) between the two on this input. So: max
<= 1/255, mean <= 2e-4, and at least 99.9% of pixels within one 8-bit
step.
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.params import ProcParams
from art_tpu_torch.core.image import synthesize_bayer
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import parity

jdev = importlib.import_module("art_tpu.pipeline.develop")

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


def check_parity(out, ref, label):
    """BACKEND_DIFF-style stats in 8-bit steps; asserts the slice bound."""
    stats = parity(out, ref)
    print(label, stats)
    assert stats["max_lsb8"] <= 1.0, stats
    assert stats["mean"] <= 2e-4, stats
    assert stats["within_1lsb8"] >= 0.999, stats
    return stats


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0.02, 0.95, size=(3, 256, 1024)).astype(np.float32)
    frame = synthesize_bayer(rgb, pattern="RGGB")
    ref = np.asarray(jdev.develop(frame, flagship_pp()))
    return frame, ref


def test_develop_matches_reference(case):
    frame, ref = case
    before = _launches()
    out = tdev.develop(frame, flagship_pp(), device="cpu")
    assert _launches() == before  # plain versions on the CPU
    assert out.shape == (3, 256, 1024) and out.dtype == torch.float32
    out = out.numpy()
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
    check_parity(out, ref, "port develop vs art_tpu develop")


def test_reference_plan_through_port_runner(case):
    # the reference's own (config, data) on the port's device program:
    # separates planning from device parity
    frame, ref = case
    config, data = jdev.plan(frame, flagship_pp())
    inp, _ = tdev.pad_to_multiple(frame.cfa, 128)
    out = tdev.build_run(config)(torch.from_numpy(inp),
                                 tdev.data_to_torch(data, "cpu"))
    out = tdev.crop_result(out, config).numpy()
    check_parity(out, ref, "art_tpu plan on the port runner")


@pytest.mark.parametrize("pattern", ["RGGB", "BGGR", "GRBG", "GBRG"])
def test_raw_stage_matches_reference(pattern):
    # black/scale and bilinear demosaic (plain PyTorch on every device)
    # against the reference's XLA versions: same f32 operations
    from art_tpu.demosaic.bilinear import bayer_bilinear as ref_bilinear
    from art_tpu.raw.preprocess import apply_scale as ref_scale
    from art_tpu_torch.demosaic import demosaic
    from art_tpu_torch.raw.preprocess import apply_scale, scale_plan

    rng = np.random.default_rng(8)
    frame = synthesize_bayer(rng.uniform(0.02, 0.95, (3, 64, 128)),
                             pattern=pattern)
    sp = scale_plan(frame, wb_mults_rgb=frame.camera_wb_mults())
    ref = np.asarray(ref_bilinear(ref_scale(
        jnp.asarray(frame.cfa), jnp.asarray(sp["offset_tile"]),
        jnp.asarray(sp["scale_tile"]), jnp), pattern))
    cfa = apply_scale(torch.from_numpy(frame.cfa),
                      torch.from_numpy(sp["offset_tile"]),
                      torch.from_numpy(sp["scale_tile"]))
    out = demosaic(cfa, pattern, "bilinear").numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


def test_integral_frame_ships_as_u16(case):
    # decoded frames carry integer counts and cross to the device as u16;
    # the device widens them back: same output as the float frame
    import dataclasses

    frame, _ = case
    counts = np.round(frame.cfa).astype(np.float32)
    as_float = dataclasses.replace(frame, cfa=counts)
    as_u16 = dataclasses.replace(frame, cfa=counts, integral=True)
    a = tdev.develop(as_float, flagship_pp(), device="cpu")
    b = tdev.develop(as_u16, flagship_pp(), device="cpu")
    assert torch.equal(a, b)


def test_data_to_torch_types():
    d = tdev.data_to_torch({"a": np.float32(2.0), "b": {"c": np.ones(3)},
                            "i": np.arange(3, dtype=np.int32)}, "cpu")
    assert d["a"].dtype == torch.float32 and d["a"].ndim == 0
    assert d["b"]["c"].dtype == torch.float32
    assert d["i"].dtype == torch.int32


def _launches():
    from art_tpu_torch.ops.tonecurve_neutral import neutral_tone
    from art_tpu_torch.ops.wavelet_kernel import wavelet_denoise_rgb

    return wavelet_denoise_rgb.launches, neutral_tone.launches
