"""The tone curve's seven modes in art_tpu_torch against `art_tpu` on the
CPU (the cases of tests/test_tonecurve_modes.py): Standard, FilmLike,
Luminance, WeightedStd, SatAndValueBlending, Perceptual and Neutral, each
with the s-curve, and with a base curve and contrast; each mode's plan
data and its apply on the same seeded (3, 64, 96) planes; the second
curve's mode, which counts only where it equals the first's; and the
port's CIECAM02 (numpy and torch) against the reference's.

Tolerances: the plans' data to rtol 1e-6 (the same float64 numpy cast to
float32 once; Neutral's hue anchors, a float32 program of its own, to
2e-6 rad); the applies to max |diff| <= 1.0 of 65535 (float32 fitted
curves; Perceptual's CIECAM02 round trip runs pow, atan2, sin and cos,
which XLA and PyTorch round differently); CIECAM02 to rtol 1e-12 in
numpy (the same code) and 2e-3 in float32 torch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.ops import tonecurve as rtc
from art_tpu.params import ProcParams as RefProcParams
from art_tpu_torch.ops import tonecurve as tc
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev

_SCURVE = [1, 0, 0, 0.2, 0.08, 0.7, 0.85, 1, 1]
MODES = ["Standard", "FilmLike", "Luminance", "WeightedStd",
         "SatAndValueBlending", "Perceptual", "Neutral"]
# the s-curve alone, and with a Rolloff base curve and contrast 25
VARIANTS = {"scurve": {}, "base-contrast": {"basecurve": "Rolloff",
                                            "contrast": 25}}


def _pp(cls, mode, variant):
    pp = cls()
    t = pp.tone_curve
    t.enabled = True
    t.curve_mode = mode
    t.curve = list(_SCURVE)
    for k, v in VARIANTS[variant].items():
        setattr(t, k, v)
    return pp


def _plans(mode, variant, profile="Rec2020"):
    ctx = {"working_profile": profile}
    return (tc.plan(_pp(ProcParams, mode, variant), ctx),
            rtc.plan(_pp(RefProcParams, mode, variant), ctx))


@pytest.fixture(scope="module")
def rgb():
    rng = np.random.default_rng(3)
    return (rng.uniform(0, 1, size=(3, 64, 96)) ** 1.8 * 60000).astype(
        np.float32)


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", MODES)
def test_plan_matches_reference(mode, variant):
    (st, data), (rst, rdata) = _plans(mode, variant)
    assert st == rst
    o, r = dict(_leaves(data)), dict(_leaves(rdata))
    assert sorted(o) == sorted(r)
    for k, v in r.items():
        ov, rv = np.asarray(o[k]), np.asarray(v)
        assert ov.dtype == rv.dtype, k
        if k == "params":  # Neutral's hue anchors and ranges
            np.testing.assert_allclose(ov[36:42], rv[36:42], atol=2e-6)
            ov, rv = np.delete(ov, np.s_[36:42]), np.delete(rv, np.s_[36:42])
        np.testing.assert_allclose(ov, rv, rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", MODES)
def test_apply_matches_reference(rgb, mode, variant):
    (st, data), (rst, rdata) = _plans(mode, variant)
    a = tc.apply(torch.from_numpy(rgb), tdev.data_to_torch(data, "cpu"),
                 st).numpy()
    b = np.asarray(rtc.apply(jnp.asarray(rgb), rdata, rst))
    d = np.abs(a.astype(np.float64) - b)
    print(mode, variant, "max diff", d.max(), "mean", d.mean())
    assert np.isfinite(a).all() and a.dtype == np.float32
    # an s-curve increases contrast (test_tonecurve_modes.py)
    assert a.std() > rgb.std() * 1.02
    assert d.max() <= 1.0


@pytest.mark.parametrize("mode2,same", [("Standard", True),
                                        ("FilmLike", False)])
def test_second_curve_counts_only_in_the_same_mode(rgb, mode2, same):
    # the reference composes curve 2 only when both modes agree
    # (tonecurve.py:185-205); otherwise it is ignored
    def pp(cls):
        p = _pp(cls, "Standard", "scurve")
        p.tone_curve.curve_mode2 = mode2
        p.tone_curve.curve2 = [1, 0, 0, 0.5, 0.6, 1, 1]
        return p

    ctx = {"working_profile": "Rec2020"}
    (st, data), (rst, rdata) = tc.plan(pp(ProcParams), ctx), rtc.plan(
        pp(RefProcParams), ctx)
    assert st == rst == ("standard", True)
    np.testing.assert_allclose(data["coeffs"], rdata["coeffs"], rtol=1e-6)
    alone, _ = _plans("Standard", "scurve")
    assert np.array_equal(data["coeffs"], alone[1]["coeffs"]) != same


def test_gray_stays_gray():
    for mode, tol in (("Perceptual", 300.0), ("Luminance", 300.0),
                      ("Neutral", 800.0)):
        (st, data), _ = _plans(mode, "scurve")
        out = tc.apply(torch.full((3, 8, 8), 20000.0),
                       tdev.data_to_torch(data, "cpu"), st).numpy()
        assert np.abs(out - out.mean(axis=0)).max() < tol, mode


def test_ciecam02_matches_reference():
    from art_tpu.color import ciecam02 as rcam
    from art_tpu.color.colorspaces import MATRICES_RGB_TO_XYZ
    from art_tpu_torch.color import ciecam02 as cam

    p2x = MATRICES_RGB_TO_XYZ["ProPhoto"]
    white = tuple(p2x @ np.ones(3) * 100)
    k = cam.ViewingConditions(white=white, la=20.0, yb=20.0).constants()
    rk = rcam.ViewingConditions(white=white, la=20.0, yb=20.0).constants()
    for name, v in rk.items():
        np.testing.assert_allclose(k[name], v, rtol=1e-12, err_msg=name)
    xyz = (p2x @ np.random.default_rng(1).uniform(0.01, 1.0, (3, 3000))
           ) * 100.0
    jch = cam.xyz_to_jch(*xyz, k)
    np.testing.assert_allclose(jch, rcam.xyz_to_jch(*xyz, rk), rtol=1e-12)
    np.testing.assert_allclose(cam.jch_to_xyz(*jch, k),
                               rcam.jch_to_xyz(*jch, rk), rtol=1e-12)
    # the torch form, float32 with float32 constants as the tone curve
    # passes them
    kt = {n: (tuple(torch.tensor(np.float32(c)) for c in v)
              if n == "d_rgb" else torch.tensor(np.float32(v)))
          for n, v in k.items()}
    t = [torch.from_numpy(c.astype(np.float32)) for c in xyz]
    tj = cam.xyz_to_jch(*t, kt, xp=cam.TORCH)
    for got, want in zip(tj, jch):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=1e-3)
    back = cam.jch_to_xyz(*tj, kt, xp=cam.TORCH)
    for got, want in zip(back, xyz):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=1e-2)
