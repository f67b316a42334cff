"""Tone curve op (counterpart of ``art_tpu/ops/tonecurve.py``;
iptonecurve.cc:553-700, curves.h:236-356).

The planner composes the base, contrast and user curves into one dense
LUT on the host, as the reference does, and fits it; the device applies
it in the profile's mode: Standard, FilmLike (Adobe hue-stable),
Luminance, WeightedStd, SatAndValueBlending, Perceptual (CIECAM02 chroma
scaling) or Neutral (kernel B7, :mod:`art_tpu_torch.ops.tonecurve_neutral`).
Every mode but Neutral first clips hue-stably when no base curve rolls
the highlights off (`filmlike_clip`). Plain PyTorch but for B7.
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.color import ciecam02 as cam02
from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.curves import DiagonalCurve
from art_tpu_torch.core.curve1d import eval_curve, fit_curve
from art_tpu_torch.core.fmath import mat3
from art_tpu_torch.core.image import MAXVAL

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
    """(static, data) for the tone curve (tonecurve.py::plan). The second
    curve's mode counts only where it equals the first's."""
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
    if lut is None:
        lut = np.linspace(0.0, 1.0, LUT_SIZE, dtype=np.float32)

    mode = mode1
    if mode == "Perceptual":
        work = ctx["working_profile"]
        w2x = cs.MATRICES_RGB_TO_XYZ[work]
        p2x = cs.MATRICES_RGB_TO_XYZ["ProPhoto"]
        cmul = float(np.interp(_curve_contrast_value(lut), _CF_X, _CF_Y))
        # viewing conditions of PerceptualToneCurve::init (curves.cc:765-
        # 771): yb=20, la=20, average surround, D50/ProPhoto white
        wp = p2x @ np.ones(3) * 100.0
        k = cam02.ViewingConditions(white=tuple(wp), la=20.0,
                                    yb=20.0).constants()
        cam = np.array([k["c"], k["nc"], k["n"], k["z"], k["fl"],
                        k["nbb"], k["ncb"], k["aw"], *k["d_rgb"]],
                       dtype=np.float32)
        data = {
            "coeffs": fit_curve(lut),
            "w2p": (np.linalg.inv(p2x) @ w2x).astype(np.float32),
            "p2w": (np.linalg.inv(w2x) @ p2x).astype(np.float32),
            "pws": p2x.astype(np.float32),
            "pws_inv": np.linalg.inv(p2x).astype(np.float32),
            "cam": cam,
            "cmul": np.float32(cmul),
            "strength": np.float32(
                np.clip(tc.perceptual_strength / 100.0, 0.0, 1.0)),
        }
        return ("perceptual", clip_first), data
    if mode == "Neutral":
        from art_tpu_torch.ops import tonecurve_neutral

        static, data = tonecurve_neutral.plan_neutral(pp, ctx, lut, whitept)
        return ("neutral",) + static, data

    lum_w = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]][1]
    data = {"coeffs": fit_curve(lut), "lum_w": lum_w.astype(np.float32)}
    return (mode.lower(), clip_first), data


# PerceptualToneCurve contrast->chroma-scaling handles (curves.cc:783)
_CF_X = (0.60, 0.70, 0.90, 0.99, 1.00, 1.07, 1.08, 1.11, 1.20, 1.30,
         1.80, 2.00)
_CF_Y = (0.70, 0.80, 0.94, 1.00, 1.00, 1.00, 1.00, 1.02, 1.08, 1.12,
         1.20, 1.22)


def _curve_contrast_value(lut):
    """calculateToneCurveContrastValue (curves.cc:390): best linear slope
    removed, then max midtone slope in gamma-encoded space."""
    n = len(lut)
    xs = np.linspace(0.0, 1.0, n)

    def g2(v):
        return np.where(v <= 0.0031308, v * 12.92,
                        1.055 * np.maximum(v, 0.0) ** (1 / 2.4) - 0.055)

    def ig2(v):
        return np.where(v <= 0.04045, v / 12.92,
                        ((v + 0.055) / 1.055) ** 2.4)

    genc = g2(np.interp(ig2(xs), xs, lut))

    def rms(k):
        return np.mean((genc - k * xs) ** 2)

    ks = np.linspace(0.1, 5.0, 200)
    k = ks[int(np.argmin([rms(kk) for kk in ks]))]

    def slope_at(tx, xd=0.07):
        y0 = np.interp(tx - xd, xs, genc) - k * (tx - xd)
        y1 = np.interp(tx + xd, xs, genc) - k * (tx + xd)
        return 1.0 + (y1 - y0) / (2 * xd)

    mid = max(slope_at(t) for t in (0.30, 0.35, 0.40, 0.45))
    edge = max(slope_at(t) for t in (0.20, 0.25, 0.50, 0.55))
    return mid * 0.7 + edge * 0.3


# -- device apply -----------------------------------------------------------

def _hi_lo_mid(r, g, b, f_hi, f_lo):
    """The hue-stable rule (color.cc:6662-6688, AdobeToneCurve::RGBTone):
    f drives the largest and smallest channel, the middle one keeps its
    ratio between them."""
    hi = torch.maximum(torch.maximum(r, g), b)
    lo = torch.minimum(torch.minimum(r, g), b)
    mid = r + g + b - hi - lo
    hi_c = f_hi(hi)
    lo_c = f_lo(lo)
    denom = hi - lo
    mid_c = torch.where(
        denom > 0,
        lo_c + (hi_c - lo_c) * (mid - lo) / torch.where(denom > 0, denom,
                                                         1.0),
        hi_c)

    def pick(ch):
        return torch.where(ch >= hi, hi_c,
                           torch.where(ch <= lo, lo_c, mid_c))

    return torch.stack([pick(r), pick(g), pick(b)])


def filmlike_clip(rgb, lmax=MAXVAL):
    """Hue-stable highlight clip (tonecurve.py::filmlike_clip)."""
    def clip(v):
        return torch.clamp(v, max=lmax)

    return _hi_lo_mid(rgb[0], rgb[1], rgb[2], clip, clip)


def _apply_filmlike(rgb, coeffs):
    def curve(v):
        return eval_curve(v, coeffs)

    return _hi_lo_mid(rgb[0], rgb[1], rgb[2], curve, curve)


def _apply_luminance(rgb, coeffs, lum_w):
    y = lum_w[0] * rgb[0] + lum_w[1] * rgb[1] + lum_w[2] * rgb[2]
    y_safe = torch.clamp(y, min=1e-5)
    return rgb * (eval_curve(y_safe, coeffs) / y_safe)


def _apply_weighted_std(rgb, coeffs):
    """WeightedStdToneCurve as the reference mixes it: each channel's
    curve 3:1 with the channel moved by half its peers' deltas."""
    r, g, b = rgb[0], rgb[1], rgb[2]
    r1, g1, b1 = (eval_curve(c, coeffs) for c in (r, g, b))
    rf, gf, bf = r1 - r, g1 - g, b1 - b
    r2 = torch.clamp(r1 * 0.75 + (r + (gf + bf) * 0.5) * 0.25, 0.0, MAXVAL)
    g2 = torch.clamp(g1 * 0.75 + (g + (rf + bf) * 0.5) * 0.25, 0.0, MAXVAL)
    b2 = torch.clamp(b1 * 0.75 + (b + (rf + gf) * 0.5) * 0.25, 0.0, MAXVAL)
    return torch.stack([r2, g2, b2])


def _apply_satandvalue(rgb, coeffs):
    """SatAndValueBlendingToneCurve: the curve drives V of HSV."""
    v = torch.maximum(torch.maximum(rgb[0], rgb[1]), rgb[2])
    v_safe = torch.clamp(v, min=1e-5)
    ratio = eval_curve(v_safe, coeffs) / v_safe
    return torch.clamp(rgb * ratio, 0.0, MAXVAL)


def _scurve(x):
    return torch.where(x < 0.5, 2.0 * x * x, 1.0 - 2.0 * (1.0 - x) ** 2)


def _hsv_s(p):
    mx = torch.maximum(torch.maximum(p[0], p[1]), p[2])
    mn = torch.minimum(torch.minimum(p[0], p[1]), p[2])
    return torch.where(mx > 0, (mx - mn) / torch.clamp(mx, min=1e-9), 0.0)


def _apply_perceptual(rgb, data):
    """PerceptualToneCurve::BatchApply (tonecurve.py::_apply_perceptual,
    curves.cc:456): luminance from the hue-stable curve, chroma rescaled
    in CIECAM02 JCh by the curve's contrast, in ProPhoto."""
    coeffs = data["coeffs"]
    strength = data["strength"]
    x = torch.clamp(rgb, 0.0, MAXVAL)
    pro = torch.clamp(mat3(data["w2p"], x), 0.0, MAXVAL)

    # out-of-gamut blue fix (ACES trick, curves.cc:500)
    r, g, b = pro[0], pro[1], pro[2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = mx - mn
    safe = torch.where(c > 0, c, 1.0)
    h6 = torch.where(
        mx == r, (g - b) / safe,
        torch.where(mx == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe))
    h6 = torch.where(h6 < 0, h6 + 6.0, h6)
    hue = h6 * 60.0
    sat = torch.where(mx > 0, c / torch.clamp(mx, min=1e-9), 0.0)
    dist = torch.abs(hue - 250.0)
    xg = _scurve(torch.clamp(
        1.0 - torch.clamp(dist - 20.0, min=0.0) / 20.0, 0, 1))
    xx = _scurve(torch.clamp((sat - 0.65) / 0.35, 0.0, 1.0))
    gate = ((dist <= 40.0) & (sat >= 0.65)).to(x.dtype) * xg * xx
    g = g * (1.0 - gate) + (0.94 * g + 0.06 * b) * gate
    pro = torch.stack([r, g, b])

    std = mat3(data["p2w"], eval_curve(pro, coeffs))
    adobe = _apply_filmlike(pro, coeffs)

    yr, yg, yb = 0.2880402, 0.7118741, 0.0000857
    old_y = yr * pro[0] + yg * pro[1] + yb * pro[2]
    new_y = yr * adobe[0] + yg * adobe[1] + yb * adobe[2]
    lcoef = new_y / torch.clamp(old_y, min=1e-5)
    scaled = torch.clamp(pro * lcoef, 0.0, MAXVAL)

    # chroma modulation in CIECAM02 JCh (curves.cc:571-680)
    camv = data["cam"]
    k = {"c": camv[0], "nc": camv[1], "n": camv[2], "z": camv[3],
         "fl": camv[4], "nbb": camv[5], "ncb": camv[6], "aw": camv[7],
         "d_rgb": (camv[8], camv[9], camv[10])}
    xc, yc, zc = mat3(data["pws"], scaled * (100.0 / MAXVAL))
    J, C, hh = cam02.xyz_to_jch(xc, yc, zc, k, xp=cam02.TORCH)
    # saturated colors: ease the scaling off (C lolim 35 hilim 60)
    tsat = _scurve(torch.clamp((C - 35.0) / 25.0, 0.0, 1.0))
    cmul_px = data["cmul"] * ((1.0 - tsat) + 0.95 * tsat)
    # brighter areas: fade the extra shadow chroma (gamma Y 0.15..0.50)
    ny = torch.where(new_y / MAXVAL <= 0.0031308, new_y / MAXVAL * 12.92,
                     1.055 * torch.clamp(new_y / MAXVAL, min=1e-9)
                     ** (1 / 2.4) - 0.055)
    tdark = _scurve(torch.clamp((ny - 0.15) / 0.35, 0.0, 1.0))
    cmul_px = cmul_px * (1.20 * (1.0 - tdark) + tdark)
    # near-black: fade scaling to 1 (J lolim 4 hilim 7)
    tblack = _scurve(torch.clamp((J - 4.0) / 3.0, 0.0, 1.0))
    cmul_px = (1.0 - tblack) + cmul_px * tblack

    x2, y2, z2 = cam02.jch_to_xyz(J, C * cmul_px, hh, k, xp=cam02.TORCH)
    pro2 = torch.clamp(mat3(data["pws_inv"], (x2, y2, z2))
                       * (MAXVAL / 100.0), 0.0, MAXVAL)

    # limit saturation increase vs the hue-stable Adobe curve
    # (curves.cc:700-740): mix it back in where chroma scaling pushed
    # HSV saturation >20% past it
    s_new = _hsv_s(pro2)
    s_adobe = _hsv_s(adobe)
    sat_scale = torch.where(s_adobe > 0,
                            s_new / torch.clamp(s_adobe, min=1e-9), 1.0)
    tkeep = _scurve(torch.clamp((sat_scale - 1.0) / 0.2, 0.0, 1.0))
    keep = (1.0 - tkeep) + 0.2 * tkeep
    pro2 = keep[None] * pro2 + (1.0 - keep[None]) * adobe

    # non-finite guard (rim-of-gamut colors): fall back to the curve
    bad = ~torch.isfinite(pro2).all(dim=0)
    pro2 = torch.where(bad[None], torch.clamp(adobe, 0.0, MAXVAL), pro2)

    out = mat3(data["p2w"], pro2)
    out = strength * out + (1.0 - strength) * std
    # hard clip fast paths (all-white / all-black from the adobe curve)
    white = torch.all(adobe >= MAXVAL, dim=0)
    black = torch.all(adobe <= 0.0, dim=0)
    out = torch.where(white[None], MAXVAL, torch.where(black[None], 0.0, out))
    return torch.clamp(out, 0.0, MAXVAL)


def apply(rgb, data, static):
    """Apply a planned tone curve (tonecurve.py::apply)."""
    mode = static[0]
    if mode == "neutral":
        from art_tpu_torch.ops import tonecurve_neutral

        return tonecurve_neutral.apply_neutral(rgb, data, static)
    if static[1]:  # clip_first
        rgb = filmlike_clip(rgb)
    coeffs = data["coeffs"]
    if mode == "perceptual":
        return _apply_perceptual(rgb, data)
    if mode == "filmlike":
        return _apply_filmlike(rgb, coeffs)
    if mode == "luminance":
        return _apply_luminance(rgb, coeffs, data["lum_w"])
    if mode == "weightedstd":
        return _apply_weighted_std(rgb, coeffs)
    if mode == "satandvalueblending":
        return _apply_satandvalue(rgb, coeffs)
    return eval_curve(rgb, coeffs)
