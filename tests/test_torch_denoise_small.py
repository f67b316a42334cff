"""The denoise below one kernel tile, art_tpu_torch against
`art_tpu/ops/denoise.py` on the same inputs: the fused path's whole-plane
version (with the raw head), the non-fused one (global crop MAD, the
DCT detail pass with and without its threshold mask, guided chroma), the
whole-plane NLMeans loop and `dct_detail_recovery` alone, and the path
each shape takes. The small develops of the fast export with config 3's
denoise run the whole-plane NLMeans inside the op
(tests/test_torch_export.py).
"""

import numpy as np
import pytest
import torch

from art_tpu.ops import denoise as jdn
from art_tpu.params import ProcParams
from art_tpu_torch.ops import denoise as tdn
from art_tpu_torch.ops import nlmeans_kernel, wavelet_kernel
from art_tpu_torch.params import ProcParams as TorchProcParams

# outputs in the 0..65535 domain (the op) or 0..1 (its planes), relative
# to full scale: float32 rounding of two programs (sums and reductions
# in another order, pow and exp of another library), which the op's
# gamma (x^(1/g), then ^g) amplifies
OP_ATOL = 65535.0 * 5e-5
PLANE_ATOL = 2e-5
H, W = 96, 160


def jnp():
    import jax.numpy

    return jax.numpy


def jit(fn, static):
    """The reference's function under jax.jit: one compile, where its
    eager operations (einsums, 121 slices) compile one by one."""
    import jax

    return jax.jit(fn, static_argnums=static)


def plan_both(text):
    out = []
    for cls, mod in ((TorchProcParams, tdn), (ProcParams, jdn)):
        pp = cls()
        pp.apply_arp_text(text)
        out.append(mod.plan(pp, {"working_profile": "Rec2020"}))
    return out


def rgb_image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.1, 0.8, (3, 1, 1)) * np.ones((3, h, w))
    base[:, :, w // 2 :] *= 0.5
    noisy = base + rng.normal(0.0, 0.03, (3, h, w))
    return (np.clip(noisy, 0.0, 1.0) * 65535.0).astype(np.float32)


PRE_MULTS = np.array([1.9, 1.0, 1.4], np.float32)
PRE_MAT = np.array([[1.2, -0.15, -0.05], [-0.1, 1.15, -0.05],
                    [0.02, -0.2, 1.18]], np.float32)


@pytest.mark.parametrize("text,pre", [
    ("[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n", True),
    ("[Denoise]\nEnabled=true\nLuminance=30\nChrominance=15\n"
     "LuminanceDetail=30\nSmoothingEnabled=true\nSmoothingMethod=1\n",
     True),
    ("[Denoise]\nEnabled=true\nLuminance=0\nChrominance=25\n"
     "SmoothingEnabled=true\nSmoothingMethod=1\n", False),
    ("[Denoise]\nEnabled=true\nLuminance=25\nChrominance=10\n"
     "LuminanceDetail=60\nLuminanceDetailThreshold=40\n", False),
], ids=["fused-raw-head", "dct-guided-raw-head", "chroma-guided",
        "dct-threshold"])
def test_whole_plane_denoise_matches_reference(text, pre):
    (static, data), (ref_static, ref_data) = plan_both(text)
    assert static == ref_static
    for k, v in ref_data.items():
        np.testing.assert_array_equal(data[k], v, err_msg=k)
    rgb = rgb_image(H, W)
    if pre:
        data = dict(data, pre_mults=PRE_MULTS, pre_mat=PRE_MAT)
        ref_data = dict(ref_data, pre_mults=PRE_MULTS, pre_mat=PRE_MAT)
        rgb = rgb / PRE_MULTS[:, None, None]
    want = np.asarray(jit(jdn.apply, 2)(jnp().asarray(rgb), {
        k: jnp().asarray(v) for k, v in ref_data.items()}, ref_static))
    got = tdn.apply(torch.from_numpy(rgb), {
        k: torch.from_numpy(np.asarray(v)) for k, v in data.items()},
        static).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_ATOL)
    assert np.abs(got - want).mean() < 65535.0 * 1e-6
    assert np.abs(got - rgb * (PRE_MULTS[:, None, None] if pre else 1)
                  ).mean() > 100.0  # it denoised


@pytest.mark.parametrize("shape,fused,multi", [
    ((64, 96), False, False), ((255, 2048), False, False),
    ((256, 768), True, False), ((256, 1024), True, True),
    ((533, 800), False, False), ((1280, 1920), True, True)])
def test_paths_follow_the_reference_shape_rule(shape, fused, multi):
    # B4 from one tile up (the full width where it is a multiple of 128),
    # B5 from 256x1024, else the whole-plane chain
    static = (True, 0, 0, False, False, 0)
    assert tdn.is_fused(static, shape) == fused
    assert (wavelet_kernel.tile_geometry(*shape) is not None) == fused
    assert (wavelet_kernel.multi_geometry(*shape) is not None) == multi


def test_whole_plane_nlmeans_matches_reference():
    rng = np.random.default_rng(1)
    y = (0.4 + rng.normal(0, 0.01, (H, W))).astype(np.float32)
    h2, detail = np.float32(0.003), np.float32(0.2)
    assert H < nlmeans_kernel.TILE  # the kernel's refusal, the loop's shape
    maskinv = tdn.nl_maskinv(torch.from_numpy(y), torch.tensor(h2),
                             torch.tensor(detail))
    got = tdn.nlmeans_plane(torch.from_numpy(y), maskinv).numpy()
    want = np.asarray(jit(jdn._nlmeans, ())(jnp().asarray(y), h2, detail))
    np.testing.assert_allclose(got, want, rtol=0, atol=PLANE_ATOL)
    assert np.std(got) < 0.7 * np.std(y)


@pytest.mark.parametrize("thresh", [0, 40])
def test_dct_detail_recovery_matches_reference(thresh):
    from art_tpu.ops.dct_detail import dct_detail_recovery as ref_fn
    from art_tpu_torch.ops.dct_detail import dct_detail_recovery

    rng = np.random.default_rng(2)
    y_in = np.clip(0.5 + 0.2 * np.sin(np.arange(W) / 3.0)[None, :]
                   + rng.normal(0, 0.03, (H, W)), 0, 1).astype(np.float32)
    y_dn = (0.5 * y_in + 0.25).astype(np.float32)
    ld = np.float32(30.0)
    want = np.asarray(jit(ref_fn, 3)(jnp().asarray(y_in),
                                     jnp().asarray(y_dn), ld, thresh))
    got = dct_detail_recovery(torch.from_numpy(y_in), torch.from_numpy(y_dn),
                              torch.tensor(ld), thresh).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PLANE_ATOL)
    assert np.abs(got - y_dn).max() > 1e-3  # detail came back


def test_global_mad_sigma_matches_reference():
    from art_tpu.ops import wavelet as jwv
    from art_tpu_torch.ops import wavelet as twv

    d = np.random.default_rng(3).normal(0, 0.02, (300, 420)).astype(
        np.float32)
    assert float(twv.mad_sigma(torch.from_numpy(d))) == pytest.approx(
        float(jwv.mad_sigma(jnp().asarray(d))), rel=1e-6)
    x = np.random.default_rng(4).uniform(0, 1, (H, W)).astype(np.float32)
    assert float(tdn.mad_sigma_crop(torch.from_numpy(x))) == pytest.approx(
        float(jdn._mad_sigma_crop(jnp().asarray(x))), rel=1e-5)
