"""The port's filters and YUV split against `art_tpu`'s, on the CPU.

Inputs come from numpy seeds and go to both packages unchanged.

- `gauss_blur`: the same reflect pads and tap order, float32 taps on both
  sides: equal (measured), bound 2e-7 on values in [0, 1].
- `box_blur` and `guided_filter`: prefix sums, whose rounding is the
  algorithm's. PyTorch's CPU cumsum accumulates in double, XLA's in
  float32 in its own order, so a box mean differs by up to two ulps of
  each prefix sum it comes from, over the window's count: here prefix
  sums reach ~600 (ulp 6.1e-5), bound 4 * 6.1e-5 / (2r + 1) (measured
  4.1e-5 at r = 1, half the bound). The guided filter divides by the
  local variance plus eps (1e-4), which amplifies that at small radii:
  bound 3e-4 on a source in [-0.1, 0.1] (measured 1.5e-4 at r = 1,
  7e-6 at r = 3).
- `rgb_to_yuv` / `yuv_to_rgb`: the same float32 operations, exact
  division by lum_w[1]: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.color import yuv as ryuv
from art_tpu.ops import filters as rf
from art_tpu_torch.color import yuv as tyuv
from art_tpu_torch.ops import filters as tf

LUM_W = np.array([0.2790177, 0.6753402, 0.0456377], np.float32)


def _plane(seed, shape=(96, 1200)):
    """Smooth gradient plus noise in [0, 1]: a denoise-domain luma."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    p = 0.3 + 0.4 * xx * yy + rng.normal(0, 0.05, shape)
    return np.clip(p, 0.0, 1.0).astype(np.float32)


def _cmp(ours, ref):
    ours = ours.numpy()
    ref = np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    return float(np.abs(ours.astype(np.float64) - ref).max())


@pytest.mark.parametrize("radius", [1, 2, 3, 7, 50, 95])
def test_box_blur_matches_reference(radius):
    # 95: a radius near the plane's 96 rows, where the clamped counts
    # differ at every row
    x = _plane(1)
    err = _cmp(tf.box_blur(torch.from_numpy(x), radius),
               rf.box_blur(jnp.asarray(x), radius))
    assert err <= 4 * 6.1e-5 / (2 * radius + 1), err


def test_box_blur_radius_zero_is_identity():
    x = torch.from_numpy(_plane(2))
    assert tf.box_blur(x, 0) is x


@pytest.mark.parametrize("sigma", [0.05, 0.8, 2.0, 3.5])
def test_gauss_blur_matches_reference(sigma):
    x = _plane(3)
    err = _cmp(tf.gauss_blur(torch.from_numpy(x), sigma),
               rf.gauss_blur(jnp.asarray(x), sigma))
    assert err <= 2e-7, err


def test_gauss_kernel_equals_reference():
    for sigma in (0.8, 2.0, 3.5):
        np.testing.assert_array_equal(tf._gauss_kernel(sigma),
                                      rf._gauss_kernel(sigma))


@pytest.mark.parametrize("radius", [1, 3, 8, 90])
def test_guided_filter_matches_reference(radius):
    guide, src = _plane(4), _plane(5) * 0.2 - 0.1  # a chroma-like source
    err = _cmp(tf.guided_filter(torch.from_numpy(guide),
                                torch.from_numpy(src), radius, 1e-4),
               rf.guided_filter(jnp.asarray(guide), jnp.asarray(src),
                                radius, 1e-4))
    assert err <= 3e-4, err


def test_yuv_round_trip_matches_reference():
    rgb = np.stack([_plane(s, (64, 128)) for s in (6, 7, 8)])
    lw = torch.from_numpy(LUM_W)
    ours = tyuv.rgb_to_yuv(torch.from_numpy(rgb), lw)
    ref = ryuv.rgb_to_yuv(jnp.asarray(rgb), jnp.asarray(LUM_W))
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    back = tyuv.yuv_to_rgb(*ours, lw).numpy()
    ref_back = np.asarray(ryuv.yuv_to_rgb(*ref, jnp.asarray(LUM_W)))
    np.testing.assert_array_equal(back, ref_back)
    np.testing.assert_allclose(back, rgb, atol=1e-6)
