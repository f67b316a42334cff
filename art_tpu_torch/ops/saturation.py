"""Saturation and vibrance (counterpart of ``art_tpu/ops/saturation.py``;
ipsaturation.cc:43-82): each channel's distance from the working-space
luminance, optionally lifted by a power (vibrance), scaled, and added
back."""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.core.fmath import fdiv
from art_tpu_torch.core.image import MAXVAL

_NOISE = 2.0 ** -16


def plan(pp, ctx):
    s = pp.saturation
    if not s.enabled or (s.saturation == 0 and s.vibrance == 0):
        return None
    lum_w = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]][1]
    data = {
        "sat": np.float32(1.0 + s.saturation / 100.0),
        "vib": np.float32(1.0 - s.vibrance / 1000.0),
        "lum_w": lum_w.astype(np.float32),
    }
    return (bool(s.vibrance),), data


def _vibrance(x, vib):
    ax = torch.abs(fdiv(x, MAXVAL))
    out = torch.sign(x) * torch.pow(torch.clamp(ax, min=_NOISE), vib) * MAXVAL
    return torch.where(ax > _NOISE, out, x)


def apply(rgb, data, static):
    (has_vib,) = static
    w = data["lum_w"]
    lum = w[0] * rgb[0] + w[1] * rgb[1] + w[2] * rgb[2]
    d = rgb - lum[None]
    if has_vib:
        d = _vibrance(d, data["vib"])
    return torch.clamp(lum[None] + data["sat"] * d, min=_NOISE)
