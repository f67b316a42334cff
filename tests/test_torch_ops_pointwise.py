"""The five pointwise ops of the bundled and user profiles (exposure,
the channel mixer, saturation, RGB curves, soft light) in art_tpu_torch
against `art_tpu` on the CPU: each op's plan on the same ProcParams,
its apply on the same seeded (3, 64, 96) planes in 0..65535, and a
64x96 bilinear develop with all five on (`chip_smoke.USER_ARP`) and no
Pallas step.

Tolerances: the plans' data to rtol 1e-6 (the same float64 numpy, cast
to float32); the applies to max |diff| <= 0.05 of 65535 for exposure,
the channel mixer and saturation (float32 arithmetic; pow rounds
differently in XLA and PyTorch), <= 1.0 for RGB curves and soft light
(fitted curves evaluated through sqrt and a Clenshaw or Horner sum);
the develop at PERF.md section 2's bounds (max <= 1/255, mean <= 2e-4,
>= 99.9% within one 8-bit step).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.params import ProcParams as RefProcParams
from art_tpu_torch.core.image import synthesize_bayer
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import USER_ARP, parity

jdev = importlib.import_module("art_tpu.pipeline.develop")

# (case id, op module, .arp text, max |diff| of the apply)
CASES = [
    ("exposure", "exposure", "[Exposure]\nCompensation=0.5\n", 0.05),
    ("exposure-black", "exposure",
     "[Exposure]\nCompensation=-1.0\nBlack=0.2\n", 0.05),
    ("chmixer-matrix", "chmixer",
     "[Channel Mixer]\nEnabled=true\nMode=0\nRed=1100;-60;-40\n"
     "Green=-30;1050;-20\nBlue=-20;-80;1100\n", 0.05),
    ("chmixer-primaries", "chmixer",
     "[Channel Mixer]\nEnabled=true\nMode=1\nHueTweak=10;-20;15\n"
     "SatTweak=20;-10;30\n", 0.05),
    ("saturation", "saturation",
     "[Saturation]\nEnabled=true\nSaturation=15\n", 0.05),
    ("saturation-vibrance", "saturation",
     "[Saturation]\nEnabled=true\nSaturation=15\nVibrance=10\n", 0.05),
    ("saturation-negative", "saturation",
     "[Saturation]\nEnabled=true\nSaturation=-30\nVibrance=40\n", 0.05),
    ("rgbcurves-red", "rgbcurves",
     "[RGB Curves]\nEnabled=true\n"
     "rCurve=1;0;0;0.25;0.2;0.5;0.56;0.75;0.8;1;1;\n", 1.0),
    # a piecewise-linear green knee: the fits fall back to segments
    ("rgbcurves-segments", "rgbcurves",
     "[RGB Curves]\nEnabled=true\n"
     "rCurve=1;0;0;0.25;0.2;0.5;0.56;0.75;0.8;1;1;\n"
     "gCurve=0;0;0;0.3;0.6;1;1;\nbCurve=1;0;0;0.6;0.5;1;1;\n", 1.0),
    ("softlight", "softlight", "[SoftLight]\nEnabled=true\nStrength=30\n",
     1.0),
    ("softlight-full", "softlight",
     "[SoftLight]\nEnabled=true\nStrength=100\n", 1.0),
]


@pytest.fixture(scope="module")
def rgb():
    return np.random.default_rng(7).uniform(
        0.0, 65535.0, (3, 64, 96)).astype(np.float32)


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _plans(arp, op, profile):
    frame = synthesize_bayer(np.full((3, 48, 64), 0.5))
    ours, ref = ProcParams(), RefProcParams()
    ours.apply_arp_text(arp)
    ref.apply_arp_text(arp)
    ctx = {"working_profile": profile, "frame": frame}
    return (importlib.import_module(f"art_tpu_torch.ops.{op}").plan(ours, ctx),
            importlib.import_module(f"art_tpu.ops.{op}").plan(ref, ctx))


@pytest.mark.parametrize("profile", ["Rec2020", "sRGB"])
@pytest.mark.parametrize("case,op,arp,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_plan_matches_reference(case, op, arp, tol, profile):
    (st, data), (rst, rdata) = _plans(arp, op, profile)
    assert st == rst
    ours, ref = dict(_leaves(data)), dict(_leaves(rdata))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert np.asarray(ours[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_allclose(ours[k], v, rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("profile", ["Rec2020", "sRGB"])
@pytest.mark.parametrize("case,op,arp,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_apply_matches_reference(rgb, case, op, arp, tol, profile):
    (st, data), (rst, rdata) = _plans(arp, op, profile)
    mod = importlib.import_module(f"art_tpu_torch.ops.{op}")
    a = mod.apply(torch.from_numpy(rgb), tdev.data_to_torch(data, "cpu"),
                  st).numpy()
    b = np.asarray(importlib.import_module(f"art_tpu.ops.{op}").apply(
        jnp.asarray(rgb), rdata, rst))
    d = np.abs(a.astype(np.float64) - b)
    print(case, profile, "max diff", d.max(), "mean", d.mean())
    assert a.shape == b.shape and a.dtype == np.float32
    assert np.abs(b - rgb).max() > 100.0  # the op changed the image
    assert d.max() <= tol


def test_segments_case_fits_segments():
    (st, data), _ = _plans(CASES[8][2], "rgbcurves", "Rec2020")
    assert st == ((True, True, True),)
    assert data["coeffs"].shape == (3, 64, 4)
    (st, data), _ = _plans(CASES[7][2], "rgbcurves", "Rec2020")
    assert st == ((True, False, False),) and data["coeffs"].ndim == 2


@pytest.mark.parametrize("op", ["exposure", "chmixer", "saturation",
                                "rgbcurves", "softlight"])
def test_off_plans_nothing(op):
    # an identity mixer, zero exposure, zero saturation, linear curves,
    # zero strength: no step, in either package
    arp = {"exposure": "[Exposure]\nCompensation=0\n",
           "chmixer": "[Channel Mixer]\nEnabled=true\n",
           "saturation": "[Saturation]\nEnabled=true\n",
           "rgbcurves": "[RGB Curves]\nEnabled=true\n",
           "softlight": "[SoftLight]\nEnabled=true\nStrength=0\n"}[op]
    assert _plans(arp, op, "Rec2020") == (None, None)


def test_user_profile_develop_matches_reference():
    frame = synthesize_bayer(np.random.default_rng(4).uniform(
        0.02, 0.95, (3, 64, 96)).astype(np.float32))
    pps = []
    for cls in (ProcParams, RefProcParams):
        pp = cls()
        pp.apply_arp_text(USER_ARP)
        pp.raw.bayer.method = "bilinear"
        pps.append(pp)
    cfg, _ = tdev.plan(frame, pps[0])
    assert [s[0] for s in cfg.steps] == ["chmixer", "exposure", "saturation",
                                         "rgbcurves", "softlight"]
    assert tdev.fusion_gates(cfg) == (False, False)
    out = tdev.develop(frame, pps[0], device="cpu")
    ref = np.asarray(jdev.develop(frame, pps[1]))
    st = parity(out, ref)
    print("user profile develop, port vs art_tpu", st)
    assert st["max_lsb8"] <= 1.0, st
    assert st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st
