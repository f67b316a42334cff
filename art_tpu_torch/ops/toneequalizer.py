"""Tone equalizer (counterpart of ``art_tpu/ops/toneequalizer.py``;
iptoneequalizer.cc).

Five user bands over 12 gaussian windows of log2 luminance (centres
-16..+6 EV, std 2 EV); the per-pixel gain is the normalised sum of the
band gains at the pixel's luminance. Regularization smooths the
luminance with a log-domain self-guided filter (radius 5) and, above 1,
a posterised luminance re-guided at radius 350 (and 700 at 2). Plain
PyTorch; the guided filters are `ops.filters.guided_filter`, whose box
windows clamp at the plane's edges for any radius.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.core.fmath import fdiv
from art_tpu_torch.core.image import MAXVAL
from art_tpu_torch.ops.filters import guided_filter

_CENTERS = np.array([-16.0, -14.0, -12.0, -10.0, -8.0, -6.0,
                     -4.0, -2.0, 0.0, 2.0, 4.0, 6.0], dtype=np.float32)


def _conv(v, lo, hi):
    f = lo if v < 0 else hi
    return 2.0 ** (v / 100.0 * f)


def plan(pp, ctx):
    te = pp.tone_equalizer
    if not te.enabled:
        return None
    bands = [te.band0, te.band1, te.band2, te.band3, te.band4]
    if all(b == 0 for b in bands):
        return None
    factors = np.array(
        [_conv(bands[0], 2, 3)] * 5
        + [_conv(bands[1], 2, 3), _conv(bands[2], 2.5, 2.5),
           _conv(bands[3], 3, 2)]
        + [_conv(bands[4], 3, 2)] * 4, dtype=np.float32)
    lum_w = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]][1]
    detail = 5 if te.regularization > 0 else 0
    radius = int(detail + 0.5)
    epsilon = 0.01 + 0.002 * max(detail - 3, 0)
    data = {
        "factors": factors,
        "lum_w": lum_w.astype(np.float32),
        "gain": np.float32(1.0 / MAXVAL * 2.0 ** (-te.pivot)),
    }
    return (radius, float(epsilon), int(te.regularization)), data


def apply(rgb, data, static):
    radius, epsilon, regularization = static
    lw, gain, factors = data["lum_w"], data["gain"], data["factors"]
    r, g, b = rgb[0] * gain, rgb[1] * gain, rgb[2] * gain
    y = torch.clamp(lw[0] * r + lw[1] * g + lw[2] * b, 1e-5, 32.0)

    if radius > 0:  # guidedFilterLog(10, ...)
        ly = fdiv(torch.log(y), math.log(10.0))
        ly = guided_filter(ly, ly, radius, epsilon)
        y = torch.pow(10.0, ly)

    if regularization > 1:
        base_posterization = 5.0
        lo, hi = float(_CENTERS[0]), float(_CENTERS[-1])
        ll = torch.clamp(torch.log2(torch.clamp(y, min=1e-9)), lo, hi)
        ll = fdiv(torch.round(ll * base_posterization), base_posterization)
        y2 = y
        y = guided_filter(y2, torch.pow(2.0, ll), 350, 0.004)
        reg = 5 - min(regularization, 4)
        if reg > 1:
            y = guided_filter(y2, y, 350 * (reg - 1), 0.004 / 100)

    luma = torch.clamp(torch.log2(torch.clamp(y, min=1e-30)), -14.0, 4.0)
    w_sum = float(np.sum(np.exp(-(_CENTERS ** 2) / 4.0)))
    correction = torch.zeros_like(luma)
    for c in range(12):
        correction = correction + torch.exp(
            -((luma - float(_CENTERS[c])) ** 2) / 4.0) * factors[c]
    return rgb * fdiv(correction, w_sum)[None]
