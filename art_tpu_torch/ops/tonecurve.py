"""Tone curve op (counterpart of ``art_tpu/ops/tonecurve.py``).

The planner composes the base, contrast and user curves into one dense
LUT on the host, as the reference does; only the Neutral mode is ported
(:mod:`art_tpu_torch.ops.tonecurve_neutral`). Other modes raise.
"""

from __future__ import annotations

import numpy as np

from art_tpu_torch.color.curves import DiagonalCurve
from art_tpu_torch.color import colorspaces as cs

LUT_SIZE = 65536


def contrast_curve_lut(contrast, whitept=1.0, pivot_gray=0.18, n=LUT_SIZE):
    """ContrastCurve LUT (tonecurve.py::contrast_curve_lut)."""
    if contrast == 0:
        return None
    pivot = pivot_gray / whitept
    c = np.power(abs(contrast) / 100.0, 1.5) * 16.0
    b = (1 + c) if contrast > 0 else 1.0 / (1 + c)
    a = np.log((np.exp(np.log(b) * pivot) - 1) / (b - 1)) / np.log(pivot)
    x = np.linspace(0.0, 1.0, n)
    xx = np.clip(x, 0.0, whitept) / whitept
    return np.log(np.power(xx, a) * (b - 1.0) + 1.0) / np.log(b) * whitept


def tonemap_curve_lut(whitept=1.0, mid_gray=0.18, rolloff=True, n=LUT_SIZE):
    """ToneMapCurve LUT (tonecurve.py::tonemap_curve_lut)."""
    black_point = 1.0 / 65535.0
    target_slope = 1.0
    c_ = black_point
    a_ = whitept - c_
    mg = mid_gray
    b_ = (a_ / (mg - c_)) * (1.0 - ((mg - c_) / a_)) * mg
    gamma_ = target_slope * (mg + b_) ** 2 / (a_ * b_)
    x = np.linspace(0.0, 1.0, n)
    sc = mg * np.power(np.maximum(x, 1e-30) / mg, gamma_)
    y = a_ * (sc / (sc + b_)) + c_
    if rolloff:
        y = np.where(x <= mg, x, y)
    return y


def adjust_user_curve(points, n=LUT_SIZE):
    """User curve (sRGB-encoded) -> linear-domain LUT
    (tonecurve.py::adjust_user_curve)."""
    curve = DiagonalCurve(points)
    if curve.is_identity():
        return None
    x = np.linspace(0.0, 1.0, n)
    v = cs.srgb_gamma(x)
    y = curve.get_val(v)
    return cs.srgb_igamma(np.clip(y, 0.0, 1.0))


def compose_luts(luts, n=LUT_SIZE):
    """f_k(...f_1(x)) as one LUT, or None (tonecurve.py::compose_luts)."""
    luts = [l for l in luts if l is not None]
    if not luts:
        return None
    x = np.linspace(0.0, 1.0, n)
    y = x
    for lut in luts:
        idx = np.clip(y, 0.0, 1.0) * (n - 1)
        i0 = np.floor(idx).astype(np.int64)
        i1 = np.minimum(i0 + 1, n - 1)
        frac = idx - i0
        y = lut[i0] * (1 - frac) + lut[i1] * frac
    return y.astype(np.float32)


def plan(pp, ctx):
    """(static, data) for the tone curve (tonecurve.py::plan), Neutral
    mode only."""
    tc = pp.tone_curve
    if not tc.enabled:
        return None
    whitept = tc.white_point if tc.white_point else 1.0
    mode1 = tc.curve_mode
    mode2 = tc.curve_mode2 if (tc.curve2 and len(tc.curve2) > 1) else mode1
    single = mode1 == mode2
    pivot_gray = (pp.logenc.target_gray / 100.0) if pp.logenc.enabled else 0.18

    base_lut = None
    clip_first = False
    if tc.basecurve != "Linear":
        base_lut = tonemap_curve_lut(
            whitept, pivot_gray, rolloff=(tc.basecurve == "Rolloff"))
    elif not (single and mode1 == "Neutral"):
        clip_first = True

    luts = [
        contrast_curve_lut(tc.contrast, whitept, pivot_gray)
        if not tc.contrast_legacy else None,
        adjust_user_curve(tc.curve),
        adjust_user_curve(tc.curve2) if single else None,
    ]
    lut = compose_luts([base_lut] + luts)
    if lut is None and not clip_first:
        return None
    if mode1 != "Neutral":
        raise NotImplementedError(f"tone curve mode {mode1!r} is not ported "
                                  "(Neutral only)")
    if lut is None:
        lut = np.linspace(0.0, 1.0, LUT_SIZE, dtype=np.float32)
    from art_tpu_torch.ops import tonecurve_neutral

    static, data = tonecurve_neutral.plan_neutral(pp, ctx, lut, whitept)
    return ("neutral",) + static, data


def apply(rgb, data, static):
    """Apply a planned tone curve (tonecurve.py::apply)."""
    if static[0] != "neutral":
        raise NotImplementedError(f"tone curve mode {static[0]!r}")
    from art_tpu_torch.ops import tonecurve_neutral

    return tonecurve_neutral.apply_neutral(rgb, data, static)
