"""Smoothing in art_tpu_torch against `art_tpu` on the CPU: each of the
nine region modes (guided, gaussian, glow, NLMeans, motion, lens, noise,
halation, wavelets) on the luminance, chrominance or RGB channels, under
a mask or not, and film grain (its three NOISE regions); each plan and
its apply on the same seeded (3, 64, 96) noisy field, NLMeans below one
256x256 tile (the whole-plane loop on both sides). And `core/prng.py`
against JAX: the bits of `jax.random.bits` equal, for several keys and
odd shapes, and the normals of `jax.random.normal` within 1e-6.

Tolerances: the plans' data to rtol 1e-6 (the same float64 numpy cast to
float32 once); the applies to max |diff| <= 1.0 of 65535 (float32 blurs,
guided filters, exp and the NOISE regions' standard deviation, reduced
in a different order); the random bits exactly; the normals to 1e-6
(XLA's erfinv polynomial, the same coefficients, rounded by another
compiler).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu_torch.core import prng
from chip_smoke import _HUE_MASK
from tests.test_torch_ops_look import check_plans, plans

MASK = f"ParametricMaskEnabled_1=true\nHueMask_1={_HUE_MASK}\n"

# (case id, .arp text)
CASES = [
    ("guided-lum", "Mode_1=0\nChannel_1=0\nRadius_1=3\nEpsilon_1=2\n"
     "Iterations_1=2\n"),
    ("gaussian-chroma", "Mode_1=1\nChannel_1=1\nSigma_1=2.5\n"
     "Iterations_1=2\n"),
    ("glow", "Mode_1=2\nSigma_1=3\nIterations_1=3\nFalloff_1=1.5\n"
     "MaskOpacity_1=0.5\n"),
    ("nlmeans-rgb-masked", "Mode_1=3\nChannel_1=2\nNLStrength_1=40\n"
     "NLDetail_1=50\n" + MASK),
    ("nlmeans-lum-twice", "Mode_1=3\nChannel_1=0\nIterations_1=2\n"
     "NLStrength_1=80\nNLDetail_1=20\n"),
    ("motion", "Mode_1=4\nChannel_1=2\nRadius_1=3\n"),
    ("lens", "Mode_1=5\nChannel_1=0\nRadius_1=1\n"),
    ("noise-lum", "Mode_1=6\nChannel_1=0\nNoiseStrength_1=60\n"
     "NoiseCoarseness_1=40\n"),
    ("noise-chroma", "Mode_1=6\nChannel_1=1\nNoiseStrength_1=40\n"
     "NoiseCoarseness_1=100\n"),
    ("halation", "Mode_1=7\nHalationSize_1=0.1\nHalationColor_1=0.3\n"),
    ("wavelets", "Mode_1=8\nChannel_1=2\nWavStrength_1=60\nWavLevels_1=4\n"
     + MASK),
    ("two-regions", "Mode_1=3\nChannel_1=2\n" + MASK
     + "Mode_2=2\nSigma_2=4\nIterations_2=2\nFalloff_2=2\n"
     "MaskOpacity_2=0.3\n"),
]
GRAIN = [("grain", "[Grain]\nEnabled=true\nISO=400\nStrength=25\n"),
         ("grain-with-region", "[Grain]\nEnabled=true\nISO=3200\n"
          "Strength=80\n[Smoothing]\nEnabled=true\nMode_1=1\nSigma_1=1.5\n")]
ALL = [(c, "[Smoothing]\nEnabled=true\n" + a) for c, a in CASES] + GRAIN


@pytest.fixture(scope="module")
def rgb():
    """A smooth coloured field with 3% noise, which NLMeans smooths."""
    yy, xx = np.mgrid[0:64, 0:96].astype(np.float32)
    field = np.stack([0.5 + 0.4 * np.sin(xx / 9.0), 0.4 + 0.3 * np.cos(
        yy / 7.0), 0.3 + 0.2 * np.sin((xx + yy) / 11.0)])
    noise = np.random.default_rng(13).normal(0.0, 0.03, field.shape)
    return (np.clip(field + noise, 0.0, 1.0) * 60000.0).astype(np.float32)


@pytest.mark.parametrize("case,arp", ALL, ids=[c[0] for c in ALL])
def test_plan_matches_reference(case, arp):
    check_plans(*plans(arp, "smoothing"))


@pytest.mark.parametrize("case,arp", ALL, ids=[c[0] for c in ALL])
def test_apply_matches_reference(rgb, case, arp):
    from art_tpu_torch.pipeline import develop as tdev

    (st, data), (rst, rdata) = plans(arp, "smoothing")
    a = importlib.import_module("art_tpu_torch.ops.smoothing").apply(
        torch.from_numpy(rgb), tdev.data_to_torch(data, "cpu"), st).numpy()
    b = np.asarray(importlib.import_module("art_tpu.ops.smoothing").apply(
        jnp.asarray(rgb), rdata, rst))
    d = np.abs(a.astype(np.float64) - b)
    print(case, "max diff", d.max(), "mean", d.mean())
    assert a.shape == b.shape and a.dtype == np.float32
    assert np.abs(b - rgb).max() > 100.0
    assert d.max() <= 1.0


def test_grain_plans_three_noise_regions():
    (st, _), _ = plans(GRAIN[0][1], "smoothing")
    assert [s[0] for s in st] == ["noise"] * 3
    assert [s[1] for s in st] == [0, 0, 0]  # luminance


KEYS = [0, 1, 42, 43, 44, 45, 2 ** 31 + 5, 2 ** 32 - 1]
SHAPES = [(1,), (7,), (37, 53), (3, 5, 7), (64, 97)]


@pytest.mark.parametrize("seed", KEYS)
def test_bits_equal_jax(seed):
    k = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(k, np.int64), prng.key(seed))
    for shape in SHAPES:
        want = np.asarray(jax.random.bits(k, shape, dtype=jnp.uint32))
        got = prng.bits(prng.key(seed), shape)
        assert got.dtype == torch.int64 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", KEYS)
def test_normals_match_jax(seed):
    k = jax.random.PRNGKey(seed)
    for shape in SHAPES:
        want = np.asarray(jax.random.normal(k, shape, dtype=jnp.float32))
        got = prng.normal(prng.key(seed), shape)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the uniform before erfinv is bit-equal
    want = np.asarray(jax.random.uniform(
        k, (64, 97), jnp.float32, np.nextafter(np.float32(-1), 0), 1.0))
    got = prng.uniform_bits(prng.bits(prng.key(seed), (64, 97)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_threefry_known_answer():
    # Threefry-2x32, 20 rounds: the Random123 known-answer vector
    # (key 0x13198a2e 0x03707344, counter 0x243f6a88 0x85a308d3)
    k = (0x13198A2E, 0x03707344)
    x0, x1 = prng.threefry2x32(k, torch.tensor([0x243F6A88]),
                               torch.tensor([0x85A308D3]))
    assert (int(x0), int(x1)) == (0xC4923A9C, 0x483DF7A0)


def test_key_range():
    with pytest.raises(ValueError):
        prng.key(-1)
    with pytest.raises(ValueError):
        prng.key(2 ** 32)
