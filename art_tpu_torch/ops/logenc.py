"""Log encoding (counterpart of ``art_tpu/ops/logenc.py``; iplogenc.cc).

An ACES-style Lin_to_Log2 of a pixel norm (half power norm, half
luminance), with optional highlight compression, saturation control and
a guided-filter regularisation that encodes a smoothed norm and carries
the detail as a ratio. The automatic gain and dynamic range (getAutoLog)
are found at plan time, `pipeline/autos.py::auto_log_params`. Plain
PyTorch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.core.fmath import fdiv
from art_tpu_torch.core.image import MAXVAL
from art_tpu_torch.ops.filters import guided_filter

_NOISE = 2.0 ** -16
_LOG2 = math.log(2.0)


def _find_gray(source_gray, target_gray):
    """Solve (base^sg - 1)/(base - 1) = tg by bisection (iplogenc.cc:38)."""
    if source_gray <= 0:
        return 0.0
    lo, hi = 1.001, 1e7
    for _ in range(100):
        mid = np.sqrt(lo * hi)  # geometric bisection for the huge range
        val = (mid ** source_gray - 1.0) / (mid - 1.0)
        if abs(val - target_gray) < 1e-7:
            return mid
        if val > target_gray:
            lo = mid
        else:
            hi = mid
    return mid


def plan(pp, ctx):
    lp = pp.logenc
    if not lp.enabled:
        return None
    gray = 2.0 ** (-lp.gain + np.log2(0.18))
    dynamic_range = max(lp.white_ev - lp.black_ev, 0.5)
    b = 0.0
    if 1 < lp.target_gray < 100 and dynamic_range > 0:
        b = _find_gray(abs(lp.black_ev) / dynamic_range,
                       lp.target_gray / 100.0)
    hl = min(max(lp.highlight_compression / 100.0, 0.0), 1.0)
    reg_radius = 0
    if lp.regularization > 0:
        reg_radius = max(1, int(25 * lp.regularization / 100.0))
    lum_w = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]][1]
    data = {
        "gray": np.float32(gray),
        "shadows_range": np.float32(lp.black_ev),
        "dynamic_range": np.float32(dynamic_range),
        "linbase": np.float32(max(b, 0.0)),
        "lum_w": lum_w.astype(np.float32),
        "hl_factor": np.float32(hl),
    }
    return (bool(lp.satcontrol), hl > 0, reg_radius), data


def _norm(x, lw):
    r, g, b = torch.abs(x[0]), torch.abs(x[1]), torch.abs(x[2])
    r2, g2, b2 = r * r, g * g, b * b
    pn = (r * r2 + g * g2 + b * b2) / torch.clamp(r2 + g2 + b2, min=1e-12)
    lum = lw[0] * x[0] + lw[1] * x[1] + lw[2] * x[2]
    return torch.clamp(pn / 2 + lum / 2,
                       max=float(np.finfo(np.float32).max) / 100.0)


def _encode(m, data, has_hl):
    x = torch.clamp(m, min=_NOISE)
    x = torch.clamp(x / data["gray"], min=_NOISE)
    if has_hl:
        hl = data["hl_factor"]
        hlf = torch.clamp(hl, min=0.1)
        compr_l, compr_t = 1.01, 0.8
        compr_s = (compr_l - compr_t) / (torch.pow(torch.pow(
            (1.0 - compr_t) / (compr_l - compr_t), -hlf), 1.0 / hlf) - 1.0)
        n = (x - compr_t) / compr_s
        d = torch.pow(1.0 + torch.pow(torch.clamp(n, min=0.0), hlf),
                      1.0 / hlf)
        res = compr_t + compr_s * n / d
        res = torch.where(hl < 0.1, hl * 10.0 * res + (1 - hl * 10.0) * x,
                          res)
        x = torch.where(x < compr_t, x, res)
    x = torch.clamp((fdiv(torch.log(x), _LOG2) - data["shadows_range"])
                    / data["dynamic_range"], min=_NOISE)
    linbase = data["linbase"]
    return torch.where(
        linbase > 0,
        (torch.pow(torch.clamp(linbase, min=1.0001), x) - 1.0)
        / torch.clamp(linbase - 1.0, min=1e-4), x)


def apply(rgb, data, static):
    satcontrol, has_hl, reg_radius = static
    lw = data["lum_w"]
    x = fdiv(rgb, MAXVAL)
    m = _norm(x, lw)
    if reg_radius > 0:
        # regularised: encode a smoothed norm, carry the detail as a ratio
        ly = torch.log(torch.clamp(m, min=1e-5))
        ys = torch.exp(guided_filter(ly, ly, reg_radius, 0.01))
        mm = _encode(ys, data, has_hl) * (m / torch.clamp(ys, min=1e-9))
    else:
        mm = _encode(m, data, has_hl)
    f = torch.where(m > _NOISE, mm / torch.clamp(m, min=_NOISE), 1.0)
    out = x * f[None]
    if satcontrol:
        ll = lw[0] * out[0] + lw[1] * out[1] + lw[2] * out[2]
        d = out - ll[None]

        def sf(s, c):
            return torch.where(c > _NOISE, 1.0 - torch.clamp(
                torch.abs(s) / torch.clamp(c, min=_NOISE), max=1.0), 0.0)

        smax = torch.maximum(torch.maximum(sf(d[0], out[0]),
                                           sf(d[1], out[1])),
                             sf(d[2], out[2]))
        s = smax * (torch.pow(torch.clamp(f, min=1e-9), 0.3) * 0.6
                    + 0.4) + (1 - smax) * 1.0
        s = torch.where(f < 1.0, s, 1.0)
        out = ll[None] + s[None] * d
    return out * MAXVAL
