"""HSL equalizer (counterpart of ``art_tpu/ops/hsl.py``; iphsl.cc).

Hue-indexed flat curves for hue, saturation and luminance, applied in
working-space YUV: each curve's factor plane, smoothed by a guided filter
on the luminance (the smoothing knob), scales the chroma through a
log2lin response (S), the luminance (L) or rotates the hue (H). Plain
PyTorch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.curves import FlatCurve
from art_tpu_torch.color.yuv import (hs_to_yuv, rgb_to_yuv, yuv_to_hs,
                                     yuv_to_rgb)
from art_tpu_torch.core.curve1d import eval_curve, fit_curve
from art_tpu_torch.core.fmath import fdiv
from art_tpu_torch.core.image import MAXVAL
from art_tpu_torch.ops.filters import guided_filter

_TWO_PI = 2.0 * math.pi


def plan(pp, ctx):
    h = pp.hsl
    if not h.enabled:
        return None
    curves = [FlatCurve(c, periodic=True)
              for c in (h.hcurve, h.scurve, h.lcurve)]
    if all(c.is_identity() for c in curves):
        return None
    data = {}
    active = []
    for name, curve in zip("hsl", curves):
        active.append(not curve.is_identity())
        if active[-1]:
            data[f"{name}coeffs"] = fit_curve(curve.lut(65536))
    smooth = 10.0 ** min(max(h.smoothing / 10.0, 0.0), 1.0) - 1.0
    radius = int(4 * smooth + 0.5)
    lradius = int(25 * smooth + 0.5)
    data["lum_w"] = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]][1].astype(
        np.float32)
    # the S strength response curve (iphsl.cc coeff FlatCurve)
    coeff = FlatCurve([1, 0.25, 0.0, 0.5, 0.18, 1, 1, 0, 0.35],
                      periodic=False)
    data["scoeff_resp"] = fit_curve(coeff.lut(65536))
    return (tuple(active), radius, lradius), data


def _tolin(y, base):
    v = (y - 0.5) * 2.0
    return torch.sign(v) * torch.clamp(
        (torch.pow(base, torch.abs(v)) - 1.0) / (base - 1.0), 0.0, 1.0)


def _hue01(hgl):
    v = fdiv(hgl, _TWO_PI)
    return torch.where(v < 0, 1.0 + v, torch.where(v > 1.0, v - 1.0, v))


def apply(rgb, data, static):
    active, radius, lradius = static
    lw = data["lum_w"]
    y, u, v = rgb_to_yuv(fdiv(rgb, MAXVAL), lw)
    hgl, s = yuv_to_hs(u, v)
    hue = _hue01(hgl)

    def masked(coeffs, rad, eps):
        f = eval_curve(hue, coeffs, in_max=1.0, out_max=1.0)
        return guided_filter(y, f, rad, eps) if rad > 0 else f

    if active[1]:  # saturation
        f = _tolin(masked(data["scoeffs"], radius, 0.001), 2.0)
        resp = eval_curve(s, data["scoeff_resp"], in_max=1.0, out_max=1.0)
        sexp = 1.0 + torch.where(f < 0, resp, 1.0 - resp)
        s = s * (1.0 + torch.sign(f)
                 * torch.pow(torch.clamp(torch.abs(f), 0.0, 1.0), sexp))
    if active[2]:  # luminance
        y = y * (1.0 + _tolin(masked(data["lcoeffs"], lradius, 0.0001),
                              10.0))
    if active[0]:  # hue shift
        hgl = hgl + _tolin(masked(data["hcoeffs"], radius, 0.001),
                           32.0) * math.pi
    u, v = hs_to_yuv(hgl, s)
    return yuv_to_rgb(y, u, v, lw) * MAXVAL
