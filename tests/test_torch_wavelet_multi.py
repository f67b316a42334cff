"""Kernel B5 (the wavelet chain on stacked planes) of art_tpu_torch against
`art_tpu.ops.wavelet_pallas`, on the CPU.

- The per-tile noise sigma against `_mad_sigma_vmem` on each of the
  reference's 384x1152 windows, on a 2-D grid of tiles: the same f32
  blur and integer-count bisection; equal up to one rounding of the
  final scale (rtol 1e-6).
- The whole chain of one tile against the reference's `_wavelet_chain`
  with its approximate reciprocal replaced by a division: bound 4e-7 on
  planes near 0.5, a few ulps of the summed levels (measured: equal).
- `wavelet_multi_plain` against `wavelet_denoise_pallas_multi` as it
  stands, in Pallas interpret mode, where the shrink's
  `pl.reciprocal(approx=True)` becomes a bfloat16 reciprocal (the port
  divides exactly): bounds max 4e-3, mean 2e-4 on planes of 0.5 +- 0.1
  noise (measured 1.4e-3 and 5.4e-5), with the reference's tile pad at
  (3, 300, 1100).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.ops import wavelet_pallas as wp
from art_tpu_torch.ops import wavelet_kernel as wk

STRENGTHS = [0.8, 1.4, 0.45]
BLENDS = [0.3, 0.0, 0.0]


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    c, h, w = shape
    yy = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    base = 0.4 + 0.2 * xx * yy + 0.1 * ((np.floor(xx * 8) % 2) == 0)
    return (base + rng.normal(0, 0.1, shape)).astype(np.float32)


def _exact_shrink(d, t2, detail_blend):
    """wavelet_pallas._shrink with a division for its approximate
    reciprocal."""
    e = d * d
    s = e + wp._roll2(e, 1, 0) + wp._roll2(e, -1, 0)
    e9 = (s + wp._roll2(s, 0, 1) + wp._roll2(s, 0, -1)) * (1.0 / 9.0)
    dd = d * (e9 / (e9 + t2 + 1e-12))
    return dd + (d - dd) * detail_blend


def test_tile_sigmas_match_reference_windows():
    # 512x2048: 2x2 tiles of 256x1024, each window 384x1152 of the
    # reflect-padded plane
    x = _planes((1, 512, 2048), 1)
    xp = np.pad(x, ((0, 0), (64, 64), (64, 64)), mode="reflect")
    ours = wk.band_sigmas(torch.from_numpy(xp), 1024, [-1.0]).numpy()
    assert ours.shape == (2, 2, 1)
    win = jnp.asarray(xp[0])
    for i in range(2):
        for j in range(2):
            w_ = win[i * 256 : i * 256 + 384, j * 1024 : j * 1024 + 1152]
            ref = float(wp._mad_sigma_vmem(w_ - wp._sep_blur_vmem(w_, 1)))
            np.testing.assert_allclose(ours[i, j, 0], ref, rtol=1e-6)


def test_pinned_sigma_replaces_the_tile_estimate():
    x = torch.from_numpy(_planes((3, 384, 1152), 2))
    sig = wk.band_sigmas(x, 1024, [0.02, -1.0, 0.0]).numpy()
    assert sig[0, 0, 0] == np.float32(0.02) and sig[0, 0, 2] == 0.0
    assert 0.05 < sig[0, 0, 1] < 0.2  # the plane's MAD sigma, ~0.1


def test_one_tile_matches_exact_reference_chain(monkeypatch):
    monkeypatch.setattr(wp, "_shrink", _exact_shrink)
    x = _planes((3, 256, 1024), 3)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (64, 64), (64, 64)),
                 mode="reflect")
    ref = np.stack([np.asarray(wp._wavelet_chain(
        xp[c], jnp.float32(-1.0), jnp.float32(STRENGTHS[c]),
        jnp.float32(BLENDS[c])))[64:320, 64:1088] for c in range(3)])
    out = wk.wavelet_denoise_multi(torch.from_numpy(x), [-1.0] * 3,
                                   STRENGTHS, BLENDS).numpy()
    err = float(np.abs(out.astype(np.float64) - ref).max())
    assert err <= 4e-7, err


@pytest.mark.parametrize("shape,sigmas", [
    ((3, 256, 1024), [-1.0] * 3),
    ((3, 300, 1100), [-1.0] * 3),
    ((2, 256, 1024), [-1.0] * 2),
    ((3, 256, 1024), [0.05, -1.0, 0.02]),
], ids=["one-tile", "tile-pad", "two-planes", "pinned"])
def test_plain_b5_matches_pallas_interpret(shape, sigmas):
    c = shape[0]
    x = _planes(shape, 4)
    ref = np.asarray(wp.wavelet_denoise_pallas_multi(
        jnp.asarray(x), jnp.asarray(sigmas, jnp.float32),
        jnp.asarray(STRENGTHS[-c:], jnp.float32),
        jnp.asarray(BLENDS[-c:], jnp.float32)))
    before = (wk.wavelet_denoise_multi.launches, wk.wavelet_multi_plain.calls)
    out = wk.wavelet_denoise_multi(torch.from_numpy(x), sigmas,
                                   STRENGTHS[-c:], BLENDS[-c:]).numpy()
    assert (wk.wavelet_denoise_multi.launches,
            wk.wavelet_multi_plain.calls) == (before[0], before[1] + 1)
    assert out.shape == ref.shape == shape
    d = np.abs(out.astype(np.float64) - ref)
    assert d.max() <= 4e-3 and d.mean() <= 2e-4, (d.max(), d.mean())


def test_multi_geometry_and_refusals():
    # tx is always 1024 for B5 (the reference never picks a full-width
    # tile on this path): 6016 columns pad to 6144
    assert wk.multi_geometry(4096, 6016) == (4096, 6144)
    assert wk.multi_geometry(300, 1100) == (512, 2048)
    assert wk.multi_geometry(255, 4096) is None
    with pytest.raises(NotImplementedError, match="256x1024"):
        wk.wavelet_denoise_multi(torch.zeros(3, 256, 1000), [-1.0] * 3,
                                 [1.0] * 3, [0.0] * 3)
    with pytest.raises(ValueError, match="3 sigmas"):
        wk.wavelet_denoise_multi(torch.zeros(3, 256, 1024), [-1.0] * 2,
                                 [1.0] * 3, [0.0] * 3)
    with pytest.raises(ValueError, match="float32"):
        wk.wavelet_denoise_multi(torch.zeros(3, 256, 1024,
                                             dtype=torch.float64),
                                 [-1.0] * 3, [1.0] * 3, [0.0] * 3)
