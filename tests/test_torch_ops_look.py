"""The grading ops of art_tpu_torch against `art_tpu` on the CPU: Lab
adjustments, B&W, the HSL equalizer, defringe, colour correction
(RGB, HSL, YUV and Jzazbz regions, masks), texture boost, the gradients
(graduated filter, PC vignette, vignetting filter) and log encoding, each
op's plan on the same ProcParams and its apply on the same seeded
(3, 64, 96) planes; and `auto_log_params` on a small frame.

Tolerances: the plans' data to rtol 1e-6 (the same float64 numpy cast
to float32 once); the applies to max |diff| <= TOL[op] of 65535 (float32
arithmetic through fitted curves, cube roots, atan2 and pow, which XLA
and PyTorch round differently); the automatic log values to 0.02 EV
(percentiles of two neutral develops that agree to PERF.md section 2's
bounds).
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
from chip_smoke import _HUE_MASK

CC3 = ("[ColorCorrection]\nEnabled=true\nMode_1=RGB\nSlopeR_1=1.1\n"
       "SlopeB_1=0.92\nOffsetG_1=0.01\nPowerR_1=0.95\nMode_2=HSL\n"
       "SlopeH_2=30\nSlopeS_2=40\nSlopeL_2=5\nOffsetH_2=200\nOffsetS_2=20\n"
       "PowerH_2=90\nPowerS_2=10\nParametricMaskEnabled_2=true\n"
       f"HueMask_2={_HUE_MASK}\nMode_3=Jzazbz\nSlope_3=1.05\n"
       "Offset_3=0.002\nPower_3=1.1\nA_3=0.1\nB_3=-0.05\nInSaturation_3=10\n"
       "OutSaturation_3=-5\nHueShift_3=8\n")

# (case id, op module, .arp text)
CASES = [
    ("lab-lcurve-chroma", "labadj", "[Luminance Curve]\nEnabled=true\n"
     "Chromaticity=15\nLCurve=1;0;0;0.3;0.25;0.7;0.78;1;1;\n"),
    ("lab-contrast-brightness", "labadj", "[Luminance Curve]\nEnabled=true\n"
     "Contrast=30\nBrightness=20\n"),
    ("lab-contrast-only", "labadj", "[Luminance Curve]\nEnabled=true\n"
     "Contrast=-25\n"),
    ("lab-ab-dark", "labadj", "[Luminance Curve]\nEnabled=true\n"
     "Brightness=-30\naCurve=1;0;0;0.4;0.45;1;1;\n"
     "bCurve=1;0;0;0.6;0.55;1;1;\n"),
    ("bw-default", "bw", "[Black & White]\nEnabled=true\n"),
    ("bw-gamma-filter", "bw", "[Black & White]\nEnabled=true\n"
     "Filter=Yellow\nGammaRed=10\nGammaBlue=-10\n"),
    ("bw-cast-abs", "bw", "[Black & White]\nEnabled=true\n"
     "Setting=RGB-Abs\nMixerRed=50\nMixerGreen=40\nMixerBlue=20\n"
     "ColorCast=30;50;\n"),
    ("hsl-all", "hsl", "[HSL Equalizer]\nEnabled=true\n"
     "HCurve=1;0.166666667;0.55;0.35;0.35;0.5;0.45;0.35;0.35;\n"
     "SCurve=1;0.33;0.7;0.35;0.35;0.83;0.4;0.35;0.35;\n"
     "LCurve=1;0.0;0.55;0.35;0.35;0.66;0.45;0.35;0.35;\nSmoothing=3\n"),
    ("hsl-sat", "hsl", "[HSL Equalizer]\nEnabled=true\n"
     "SCurve=1;0.33;0.2;0.35;0.35;0.83;0.8;0.35;0.35;\n"),
    ("defringe", "defringe", "[Defringing]\nEnabled=true\nThreshold=25\n"),
    ("defringe-flat", "defringe", "[Defringing]\nEnabled=true\nRadius=1.2\n"
     "Threshold=5\nHueCurve=0;\n"),
    ("cc-three-regions", "colorcorrection", CC3),
    ("cc-yuv-compression", "colorcorrection", "[ColorCorrection]\n"
     "Enabled=true\nMode_1=YUV\nSlope_1=1.2\nOffset_1=-0.01\nPower_1=0.9\n"
     "Pivot_1=0.6\nCompression_1=0.3\nHueShift_1=-20\nA_1=-0.2\n"),
    ("cc-rgb-luminance", "colorcorrection", "[ColorCorrection]\n"
     "Enabled=true\nMode_1=RGB\nRGBLuminance_1=true\nSlopeG_1=1.2\n"
     "PowerB_1=1.3\nDeltaEMaskEnabled_1=true\nDeltaEMaskL_1=50\n"
     "DeltaEMaskC_1=20\nDeltaEMaskH_1=60\nDeltaEMaskRange_1=30\n"),
    ("texture-boost", "textureboost", "[TextureBoost]\nEnabled=true\n"
     "Strength_1=0.6\nDetailThreshold_1=1.5\nIterations_1=1\n"),
    ("texture-soften-masked", "textureboost", "[TextureBoost]\n"
     "Enabled=true\nStrength_1=-0.5\nDetailThreshold_1=0.6\nIterations_1=2\n"
     f"ParametricMaskEnabled_1=true\nHueMask_1={_HUE_MASK}\n"),
    ("gradients-all", "gradients", "[Gradient]\nEnabled=true\nDegree=20\n"
     "Feather=40\nStrength=0.8\nCenterX=10\nCenterY=-20\n[PCVignette]\n"
     "Enabled=true\nStrength=0.6\nFeather=50\nRoundness=30\n"
     "[Vignetting Correction]\nEnabled=true\nAmount=-20\nRadius=60\n"
     "Strength=2\n"),
    ("gradients-steep", "gradients", "[Gradient]\nEnabled=true\n"
     "Degree=110\nStrength=-1.2\n[PCVignette]\nEnabled=true\nStrength=-1\n"
     "Roundness=80\nCenterY=30\n[Vignetting Correction]\nEnabled=true\n"
     "Amount=40\nCenterX=-20\n"),
    ("logenc-manual", "logenc", "[LogEncoding]\nEnabled=true\nAuto=false\n"
     "AutoGain=false\nGain=1.5\nBlackEv=-6\nWhiteEv=9\n"),
    ("logenc-hl-sat", "logenc", "[LogEncoding]\nEnabled=true\nAuto=false\n"
     "AutoGain=false\nGain=-0.5\nRegularization=0\nSaturationControl=true\n"
     "HighlightCompression=60\nTargetGray=25\n"),
    ("logenc-hl-low", "logenc", "[LogEncoding]\nEnabled=true\nAuto=false\n"
     "AutoGain=false\nHighlightCompression=5\nRegularization=20\n"),
]

TOL = {"labadj": 1.0, "bw": 0.05, "hsl": 1.0, "defringe": 1.0,
       "colorcorrection": 1.0, "textureboost": 1.0, "gradients": 0.25,
       "logenc": 1.0}

H, W = 64, 96


@pytest.fixture(scope="module")
def rgb():
    rng = np.random.default_rng(11)
    return (rng.uniform(0.0, 1.0, (3, H, W)) ** 1.8 * 60000.0).astype(
        np.float32)


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def plans(arp, op, profile="Rec2020"):
    """This package's and the reference's plan of `op` for the .arp."""
    frame = synthesize_bayer(np.full((3, H, W), 0.5))
    ours, ref = ProcParams(), RefProcParams()
    ours.apply_arp_text(arp)
    ref.apply_arp_text(arp)
    ctx = {"working_profile": profile, "frame": frame, "op_dims": (H, W)}
    return (importlib.import_module(f"art_tpu_torch.ops.{op}").plan(ours, ctx),
            importlib.import_module(f"art_tpu.ops.{op}").plan(ref, ctx))


def check_plans(ours, ref):
    (st, data), (rst, rdata) = ours, ref
    assert st == rst
    o, r = dict(_leaves(data)), dict(_leaves(rdata))
    assert sorted(o) == sorted(r)
    for k, v in r.items():
        assert np.asarray(o[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_allclose(o[k], v, rtol=1e-6, atol=0, err_msg=k)


def applies(rgb, op, ours, ref):
    (st, data), (rst, rdata) = ours, ref
    a = importlib.import_module(f"art_tpu_torch.ops.{op}").apply(
        torch.from_numpy(rgb), tdev.data_to_torch(data, "cpu"), st).numpy()
    b = np.asarray(importlib.import_module(f"art_tpu.ops.{op}").apply(
        jnp.asarray(rgb), rdata, rst))
    return a, b


@pytest.mark.parametrize("profile", ["Rec2020", "sRGB"])
@pytest.mark.parametrize("case,op,arp", CASES, ids=[c[0] for c in CASES])
def test_plan_matches_reference(case, op, arp, profile):
    check_plans(*plans(arp, op, profile))


@pytest.mark.parametrize("case,op,arp", CASES, ids=[c[0] for c in CASES])
def test_apply_matches_reference(rgb, case, op, arp):
    a, b = applies(rgb, op, *plans(arp, op))
    d = np.abs(a.astype(np.float64) - b)
    print(case, "max diff", d.max(), "mean", d.mean())
    assert a.shape == b.shape == rgb.shape and a.dtype == np.float32
    assert np.abs(b - rgb).max() > 100.0  # the op changed the image
    assert d.max() <= TOL[op]


@pytest.mark.parametrize("op,arp", [
    ("labadj", "[Luminance Curve]\nEnabled=true\n"),
    ("hsl", "[HSL Equalizer]\nEnabled=true\nSmoothing=5\n"),
    ("bw", "[Black & White]\nEnabled=false\n"),
    ("colorcorrection", "[ColorCorrection]\nEnabled=true\n"),
    ("textureboost", "[TextureBoost]\nEnabled=true\nStrength_1=0\n"),
    ("gradients", "[Gradient]\nEnabled=true\nStrength=0\n"),
    ("logenc", "[LogEncoding]\nEnabled=false\n"),
    ("defringe", "[Defringing]\nEnabled=false\n")])
def test_off_plans_nothing(op, arp):
    assert plans(arp, op) == (None, None)


def test_auto_log_matches_reference():
    from art_tpu.pipeline.autos import _subsample_frame, auto_log_params \
        as ref_auto
    from art_tpu_torch.pipeline.autos import auto_log_params, subsample_frame

    rng = np.random.default_rng(4)
    frame = synthesize_bayer((rng.uniform(0.0, 1.0, (3, 256, 384)) ** 2.0
                              * 0.9 + 0.005).astype(np.float32))
    np.testing.assert_array_equal(subsample_frame(frame, 8).cfa,
                                  _subsample_frame(frame, 8).cfa)
    ours, ref = ProcParams(), RefProcParams()
    got = auto_log_params(frame, ours, "cpu")
    want = ref_auto(frame, ref)
    print("auto log", got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02)
    assert want[1] < -0.5 and want[2] > 0.5  # inside the slider domains


def test_plan_resolves_auto_log_on_a_copy():
    # the plan's log encoding carries the automatic values; the caller's
    # ProcParams keeps its autos (the reference writes them back)
    rng = np.random.default_rng(4)
    frame = synthesize_bayer(rng.uniform(0.05, 0.9, (3, 64, 96)).astype(
        np.float32))
    pp = ProcParams()
    pp.raw.bayer.method = "bilinear"
    pp.apply_arp_text("[LogEncoding]\nEnabled=true\n")
    cfg, data = tdev.plan(frame, pp, device="cpu")
    assert [s[0] for s in cfg.steps] == ["logenc"]
    assert pp.logenc.auto_gain and pp.logenc.auto_gray
    from art_tpu_torch.pipeline.autos import auto_log_params

    gain, black_ev, white_ev = auto_log_params(frame, pp, "cpu")
    np.testing.assert_allclose(data["op:logenc"]["gray"],
                               np.float32(2.0 ** (-gain + np.log2(0.18))),
                               rtol=1e-6)
    np.testing.assert_allclose(data["op:logenc"]["shadows_range"],
                               np.float32(black_ev))
