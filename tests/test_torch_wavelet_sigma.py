"""The noise-sigma selection of the wavelet kernels B4 and B5, on the CPU.

The kernels do not count |d0| <= mid over the window 14 times. They
histogram each value's leaf in the tree of mids that the 14 bisection
steps from (0, max) can visit, and walk the steps on the histogram
(`wavelet_kernel.mad_sigma_hist` renders that route in PyTorch). The two
are equal bit for bit, not to a tolerance:

- the mids are the same floats: each step computes 0.5 * (lo + hi) from
  the same lo and hi, in float32, on both routes;
- the intervals nest (lo <= mid <= hi), so a value that left the
  bisection's path at an earlier step lies wholly below the current mid
  (it went left where the path went right) or wholly above it; the count
  of values <= mid is therefore the count that left to the left plus the
  current node's left half, a sum of histogram bins;
- counts are integers, so the test count / n < 0.5 sees the same
  numbers.

The kernel finds a value's place among the top 10 levels of the tree by
its rank among their (ordered) mids; `sigma_leaves` renders that, and is
held here to a plain 14-step walk. The cases stress ties and rounding: a
constant window (max 0, every mid 0), values exactly on mids, one huge
outlier, powers of two, subnormals, values near the float32 maximum (lo +
hi overflows), the real 384 x 1152 windows of `band_sigmas`, and windows
from hypothesis.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from art_tpu.ops import wavelet_pallas as wp
from art_tpu_torch.ops import wavelet_kernel as wk

F32_MAX = float(np.finfo(np.float32).max)


def _walk_leaves(a, top):
    """Leaves by the 14 bisection comparisons, one level at a time."""
    lo = torch.zeros_like(a)
    hi = top[:, None].expand_as(a)
    leaf = torch.zeros(a.shape, dtype=torch.int64)
    for _ in range(wk.BISECT):
        mid = 0.5 * (lo + hi)
        up = ~(a <= mid)
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
        leaf = 2 * leaf + up
    return leaf


def _on_mids(top, n, seed):
    """n values drawn from the tree's own mids (and 0 and top)."""
    rng = np.random.default_rng(seed)
    mids = wk.top_mids(torch.tensor([top], dtype=torch.float32))[0]
    pool = torch.cat([mids, torch.tensor([0.0, top])])
    return pool[torch.from_numpy(rng.integers(0, len(pool), n))]


def _cases():
    rng = np.random.default_rng(21)
    noise = rng.normal(0, 0.01, (48, 64)).astype(np.float32)
    outlier = noise.copy()
    outlier[7, 9] = 3e30
    pow2 = np.ldexp(1.0, rng.integers(-30, 10, (40, 40))).astype(np.float32)
    sub = (rng.integers(0, 200, (32, 32)) * np.float32(1e-45)).astype(
        np.float32)
    big = (rng.uniform(0.5, 1.0, (16, 16)) * F32_MAX).astype(np.float32)
    on_mids = torch.cat([_on_mids(1.0, 900, 1), torch.tensor([1.0])])
    on_mids_odd = torch.cat([_on_mids(0.7371, 900, 2),
                             torch.tensor([0.7371])])
    half = np.full((24, 24), 0.25, np.float32)
    half[:12] = 0.5
    return {
        "zeros": torch.zeros(2, 16, 16),
        "constant": torch.full((1, 32, 32), -0.125),
        "noise": torch.from_numpy(noise),
        "huge-outlier": torch.from_numpy(outlier),
        "powers-of-two": torch.from_numpy(pow2),
        "subnormals": torch.from_numpy(sub),
        "near-float-max": torch.from_numpy(big),
        "on-mids": on_mids.reshape(1, 1, -1),
        "on-mids-odd-max": on_mids_odd.reshape(1, -1, 1),
        "half-on-the-first-mid": torch.from_numpy(half),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_histogram_walk_equals_bisection(name):
    d = CASES[name]
    assert torch.equal(wk.mad_sigma_hist(d), wk.mad_sigma(d))


@pytest.mark.parametrize("name", sorted(CASES))
def test_table_leaves_equal_the_walk(name):
    a = CASES[name].abs().flatten(-2).reshape(-1, CASES[name].shape[-2]
                                             * CASES[name].shape[-1])
    top = a.amax(-1)
    assert torch.equal(wk.sigma_leaves(a, top), _walk_leaves(a, top))


def test_real_windows_of_band_sigmas():
    # the 384 x 1152 windows of a (1, 512, 2048) plane's 2 x 2 tiles, d0
    # with the blur wrapping inside each window, as band_sigmas takes it
    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 0.1, (1, 512, 2048)).astype(np.float32)
    x[0, :, 1400:] *= 0.2  # a quieter region for one tile column
    planes = torch.from_numpy(np.pad(x, ((0, 0), (64, 64), (64, 64)),
                                     mode="reflect"))
    wins = torch.stack([
        planes[0, i * 256:i * 256 + 384, j * 1024:j * 1024 + 1152]
        for i in range(2) for j in range(2)])
    d0 = wins - wk._sep_blur(wins, 1, periodic=True)
    ours = wk.mad_sigma_hist(d0)
    assert torch.equal(ours, wk.mad_sigma(d0))
    assert torch.equal(
        ours, wk.band_sigmas(planes, 1024, [-1.0]).reshape(-1))
    # and the reference's window MAD, to the one rounding of the final
    # scale its test allows
    for k in range(4):
        ref = float(wp._mad_sigma_vmem(jnp.asarray(d0[k].numpy())))
        np.testing.assert_allclose(float(ours[k]), ref, rtol=1e-6)


@settings(max_examples=150, deadline=None)
@given(hnp.arrays(np.float32, hnp.array_shapes(min_dims=2, max_dims=2,
                                               max_side=24),
                  elements=st.floats(-F32_MAX, F32_MAX, width=32,
                                     allow_nan=False)))
def test_hypothesis_windows(x):
    d = torch.from_numpy(x)[None]
    assert torch.equal(wk.mad_sigma_hist(d), wk.mad_sigma(d))
