"""Impulse denoise, Lab and the cube root of art_tpu_torch against
`art_tpu`, on the CPU.

- `cbrt` (PyTorch has none): pow(t, 1/3) and one Newton step. Within 1
  ulp of the correctly rounded cube root (float64 cbrt rounded once);
  np.cbrt on float32 is itself up to 2 ulps off it, so within 2 of that.
- `xyz_to_lab` / `lab_to_xyz` against the reference's: the cube root
  above against XLA's, and IEEE divisions by the D50 white and the Lab
  constants where XLA on the CPU multiplies by their reciprocals: bound
  1e-4 on L, a, b (in 0..100 units) and 1e-6 on XYZ.
- `impulse.apply` against `art_tpu.ops.impulse.apply` on the same
  working-space image with salt and pepper: the impulse decision `hp >
  (nbr - hp) * thr` compares two sums of gaussian and box (prefix-sum)
  filters, which round differently in the two packages, so a pixel on
  the threshold may flip; and a replacement weighs its neighbours by
  1 / ((Ln - L)^2 + 1), which carries ulps of L (~0.002 at L ~ 30000)
  into the result. Bound: 99.99% of values within 2.0 of 65535 (measured:
  no flip, all within 0.09 at thresholds 20 and 50, 0.89 at 80), and
  most injected impulses replaced.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.color import colorspaces as rcs
from art_tpu.ops import impulse as rimp
from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.core.fmath import cbrt
from art_tpu_torch.ops import impulse as timp


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(216 / 24389, 1.0), (1.0, 8.0),
                                   (1e-3, 216 / 24389)])
def test_cbrt_within_one_ulp(lo, hi):
    t = np.random.default_rng(0).uniform(lo, hi, 200000).astype(np.float32)
    ours = cbrt(torch.from_numpy(t)).numpy()
    exact = np.cbrt(t.astype(np.float64)).astype(np.float32)
    assert _ulps(ours, exact).max() <= 1
    assert _ulps(ours, np.cbrt(t)).max() <= 2


def _xyz(seed, shape=(64, 96)):
    rng = np.random.default_rng(seed)
    # includes dark values below the Lab linear-segment threshold
    return [rng.uniform(0.0, 1.0, shape).astype(np.float32) ** 3
            for _ in range(3)]


def test_xyz_to_lab_matches_reference():
    xyz = _xyz(1)
    ours = cs.xyz_to_lab(*map(torch.from_numpy, xyz))
    ref = rcs.xyz_to_lab(*map(jnp.asarray, xyz), jnp)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4)


def test_lab_round_trip_matches_reference():
    lab = [np.array(v) for v in rcs.xyz_to_lab(
        *map(jnp.asarray, _xyz(2)), jnp)]
    ours = cs.lab_to_xyz(*map(torch.from_numpy, lab))
    ref = rcs.lab_to_xyz(*map(jnp.asarray, lab), jnp)
    for o, r, x in zip(ours, ref, _xyz(2)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(o.numpy(), x, rtol=0, atol=1e-5)


def test_d50_white_equals_reference():
    np.testing.assert_array_equal(cs.D50_WHITE, rcs.D50_WHITE)


def _impulse_case(seed, thresh):
    from art_tpu.params import ProcParams

    rng = np.random.default_rng(seed)
    h, w = 96, 160
    yy = np.linspace(0, 1, h)[:, None]
    xx = np.linspace(0, 1, w)[None, :]
    rgb = np.stack([np.broadcast_to(p, (h, w)) for p in
                    (0.3 + 0.4 * xx, 0.25 + 0.3 * yy, 0.2 + 0.2 * xx * yy)])
    rgb = rgb + rng.normal(0, 0.01, rgb.shape)
    spots = rng.random((h, w)) < 0.01
    rgb[:, spots] = rng.choice([0.01, 0.99], size=(3, int(spots.sum())))
    rgb = (np.clip(rgb, 0, 1) * 65535).astype(np.float32)
    pp = ProcParams()
    pp.impulse_denoise.enabled = True
    pp.impulse_denoise.thresh = thresh
    return rgb, spots, pp


@pytest.mark.parametrize("thresh", [50, 20, 80])
def test_impulse_matches_reference(thresh):
    rgb, spots, pp = _impulse_case(3, thresh)
    ctx = {"working_profile": "Rec2020"}
    static, data = rimp.plan(pp, ctx)
    ours_static, ours_data = timp.plan(pp, ctx)
    assert ours_static == static
    for k, v in data.items():
        np.testing.assert_array_equal(ours_data[k], v, err_msg=k)
    ref = np.asarray(rimp.apply(jnp.asarray(rgb),
                                {k: jnp.asarray(v) for k, v in data.items()},
                                static))
    out = timp.apply(torch.from_numpy(rgb.copy()),
                     {k: torch.from_numpy(np.asarray(v))
                      for k, v in data.items()}, static).numpy()
    d = np.abs(out.astype(np.float64) - ref)
    assert (d <= 2.0).mean() >= 0.9999, (d.max(), (d > 2.0).sum())
    # the injected spots moved towards their neighbourhood
    moved = np.abs(out - rgb).max(axis=0)[spots]
    assert (moved > 1000).mean() > 0.9
