"""Texture boost (counterpart of ``art_tpu/ops/textureboost.py``;
iptextureboost.cc).

Per region, a two-scale detail gain on the working luminance: mid =
guided(Y, r), base = guided(mid, 4r), Y' = base + (Y - mid) * strength +
(mid - base) * strength2, iterated with a halving blend, U and V scaled by
the luminance ratio, blended in by the region's mask. Plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.yuv import rgb_to_yuv, yuv_to_rgb
from art_tpu_torch.core.fmath import fdiv
from art_tpu_torch.core.image import MAXVAL
from art_tpu_torch.masks import eval_mask, plan_mask, regions_from_extra
from art_tpu_torch.ops.filters import guided_filter

GROUP = "TextureBoost"

FIELDS = {
    "strength": ("Strength", "f", 0.0),
    "detail_threshold": ("DetailThreshold", "f", 0.2),
    "iterations": ("Iterations", "i", 1),
}


def plan(pp, ctx):
    regions = regions_from_extra(pp, GROUP, FIELDS)
    if not regions:
        return None
    h, w = ctx.get("op_dims") or ctx["frame"].shape
    ws = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]]
    data = {"ws": ws.astype(np.float32), "lum_w": ws[1].astype(np.float32)}
    statics = []
    for ridx, (params, mask) in enumerate(regions):
        if params["strength"] == 0:
            continue
        mstatic, mdata = plan_mask(mask, (h, w), pp,
                                   ctx.get("device", "cpu"))
        s = params["strength"]
        s = (s / 2.0) ** 0.3 * 2.0 if s >= 0 else s
        data[f"tb{ridx}"] = {
            "mask": mdata,
            "strength": np.float32(1.0 + s if s >= 0 else 1.0 / (1.0 - s)),
            "strength2": np.float32(1.0 + s / 4.0 if s >= 0
                                    else 1.0 / (1.0 - s / 2.0)),
        }
        radius = max(int(params["detail_threshold"] * 3.5 + 0.5), 1)
        statics.append((radius, max(int(params["iterations"]), 1),
                        mstatic, ridx))
    if not statics:
        return None
    return tuple(statics), data


def apply(rgb, data, static):
    ws, lw = data["ws"], data["lum_w"]
    x01 = fdiv(rgb, MAXVAL)
    for radius, iterations, mstatic, ridx in static:
        p = data[f"tb{ridx}"]
        mask = eval_mask(rgb, ws, mstatic, p["mask"])
        y, u, v = rgb_to_yuv(x01, lw)
        yy = torch.clamp(y, 1e-5, 32.0)
        minval = torch.min(yy)
        mid = out = yy
        for i in range(iterations):
            blend = 1.0 / (2.0 ** i)
            mid = guided_filter(mid, mid, radius, 0.001)
            base = guided_filter(mid, mid, radius * 4, 0.0001)
            boosted = torch.maximum(base + (out - mid) * p["strength"]
                                    + (mid - base) * p["strength2"], minval)
            out = blend * boosted + (1 - blend) * out
        f = out / torch.clamp(yy, min=1e-9)
        sm = yuv_to_rgb(y * f, u * f, v * f, lw)
        x01 = sm * mask[None] + x01 * (1.0 - mask[None])
    return x01 * MAXVAL
