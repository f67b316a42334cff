"""Kernel B6 (NLMeans) of art_tpu_torch against `art_tpu`, on the CPU.

- `nlmeans_plain` against `art_tpu.ops.nlmeans_pallas.nlmeans_pallas` in
  Pallas interpret mode, on a plane of whole 256x256 tiles and on planes
  that need the reference's edge pad to whole tiles. The port runs the
  whole plane with edge-clamped neighbours, the reference tile windows
  of an edge-padded plane; the same float32 operations in the same
  order, but XLA's exp on the CPU is its own polynomial, not the libm
  one PyTorch calls (they differ by 1 ulp at ~10% of arguments). Bound:
  8 ulps of 1.0 (4.8e-7) on luma in [0, 1] (measured up to 2.4e-7).
- `nlmeans_plain`, whose offsets t and -t share one patch box, against
  the same function with a box for every offset, as the kernels make
  it: equal bit for bit.
- The detail mask and inverse weight scale (`denoise.nl_maskinv`)
  against the pieces of `art_tpu.ops.denoise._nlmeans`: the same gauss
  blurs and divisions; bound 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.ops import filters as rf
from art_tpu.ops.nlmeans_pallas import nlmeans_pallas
from art_tpu_torch.ops import denoise as tdn
from art_tpu_torch.ops import nlmeans_kernel as nk

H2 = np.float32(((50 / 100.0) ** 0.9 / 10.0) ** 2)  # nl_strength 50


def _luma(shape, seed):
    """A denoised-luma-like plane: gradient, edges and 0.5% noise."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    p = 0.25 + 0.4 * xx + 0.2 * ((np.floor(yy * 6) % 2) == 0)
    return np.clip(p + rng.normal(0, 0.005, shape), 0, 1).astype(np.float32)


def _ref_maskinv(y, detail):
    """denoise.py:152-156 on jnp."""
    lap = jnp.abs(y - rf.gauss_blur(y, 2.0))
    lap = rf.gauss_blur(lap, 2.0)
    lap = lap / jnp.maximum(jnp.max(lap), 1e-9)
    mask = lap * (1.0 - detail) + detail
    return 1.0 / (jnp.maximum(mask, 1e-6) * H2)


@pytest.mark.parametrize("shape", [(256, 512), (300, 520), (256, 300)],
                         ids=["whole-tiles", "edge-pad", "edge-pad-x"])
def test_plain_b6_matches_pallas_interpret(shape):
    y = _luma(shape, 1)
    mi = np.array(_ref_maskinv(jnp.asarray(y), np.float32(0.5)))
    ref = np.asarray(nlmeans_pallas(jnp.asarray(y), jnp.asarray(mi)))
    before = nk.nlmeans_plain.calls
    out = nk.nlmeans(torch.from_numpy(y), torch.from_numpy(mi)).numpy()
    assert nk.nlmeans_plain.calls == before + 1
    assert out.shape == ref.shape == shape
    err = float(np.abs(out.astype(np.float64) - ref).max())
    assert err <= 4.8e-7, err
    # and it filters: the noise drops
    assert np.std(np.diff(out, axis=1)) < 0.8 * np.std(np.diff(y, axis=1))


@pytest.mark.parametrize("detail", [0.0, 0.5, 0.99])
def test_maskinv_matches_reference(detail):
    y = _luma((96, 160), 2)
    d = np.float32(detail)
    ref = np.asarray(_ref_maskinv(jnp.asarray(y), d))
    ours = tdn.nl_maskinv(torch.from_numpy(y), torch.tensor(H2),
                          torch.tensor(d)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)


def _per_offset(y, maskinv):
    """B6 with a patch box of its own for every offset, as the Pallas
    kernel and the CUDA kernel compute it."""
    h, w = y.shape
    yp = torch.nn.functional.pad(y[None, None], (7, 7, 7, 7),
                                 mode="replicate")[0, 0]
    centre = yp[5 : h + 9, 5 : w + 9]
    acc = wsum = 0.0
    for idx in range(121):
        ty, tx = idx // 11 - 5, idx % 11 - 5
        d = centre - yp[5 + ty : h + 9 + ty, 5 + tx : w + 9 + tx]
        d2 = d * d
        s = d2[2 : h + 2] + d2[3 : h + 3] + d2[1 : h + 1] + d2[4 : h + 4] \
            + d2[0:h]
        box = s[:, 2 : w + 2] + s[:, 3 : w + 3] + s[:, 1 : w + 1] \
            + s[:, 4 : w + 4] + s[:, 0:w]
        wgt = torch.exp(-torch.minimum(box * maskinv, torch.tensor(50.0)))
        sh = yp[7 + ty : h + 7 + ty, 7 + tx : w + 7 + tx]
        acc = acc + wgt * sh
        wsum = wsum + wgt
    return acc / (wsum + 1e-5)


@pytest.mark.parametrize("shape", [(40, 56), (256, 300)])
def test_offset_pairs_share_their_box_exactly(shape):
    # (a - b)^2 = (b - a)^2, so the box of -t at p is the box of t at
    # p - t, summed in the same order: equal bit for bit
    y = torch.from_numpy(_luma(shape, 4))
    mi = tdn.nl_maskinv(y, torch.tensor(H2), torch.tensor(0.5))
    assert torch.equal(nk.nlmeans_plain(y, mi), _per_offset(y, mi))


def test_plain_b6_on_a_constant_plane_is_identity():
    # every weight is exp(0) = 1 and every neighbour the same value, so
    # each pixel is 121 * 0.375 / (121 + 1e-5), all sums exact in float32
    y = torch.full((256, 256), 0.375)
    out = nk.nlmeans_plain(y, torch.full((256, 256), 100.0))
    want = np.float32(121 * 0.375) / (np.float32(121) + np.float32(1e-5))
    assert torch.equal(out, torch.full((256, 256), float(want)))


def test_wrapper_refuses_small_and_mismatched_planes():
    with pytest.raises(NotImplementedError, match="256x256"):
        nk.nlmeans(torch.zeros(200, 512), torch.zeros(200, 512))
    with pytest.raises(ValueError, match="maskinv"):
        nk.nlmeans(torch.zeros(256, 256), torch.zeros(256, 255))
    with pytest.raises(ValueError, match="float32"):
        nk.nlmeans(torch.zeros(256, 256, dtype=torch.float64),
                   torch.zeros(256, 256))
