"""The working-space YUV of the denoise (counterpart of
``art_tpu/color/yuv.py``, color.h:783-816): Y = working-space luminance,
u = Y - B, v = R - Y; hue and saturation of (u, v) as h = atan2(v, u),
s = hypot(u, v) (yuv2hsl / hsl2yuv). lum_w is a (3,) float32 tensor."""

from __future__ import annotations

import torch


def rgb_to_yuv(rgb, lum_w):
    y = lum_w[0] * rgb[0] + lum_w[1] * rgb[1] + lum_w[2] * rgb[2]
    u = y - rgb[2]
    v = rgb[0] - y
    return y, u, v


def yuv_to_rgb(y, u, v, lum_w):
    b = y - u
    r = v + y
    g = (y - r * lum_w[0] - b * lum_w[2]) / lum_w[1]
    return torch.stack([r, g, b])


def yuv_to_hs(u, v):
    return torch.atan2(v, u), torch.hypot(u, v)


def hs_to_yuv(h, s):
    return s * torch.cos(h), s * torch.sin(h)
