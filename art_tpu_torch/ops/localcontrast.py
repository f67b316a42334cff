"""Local contrast (counterpart of ``art_tpu/ops/localcontrast.py``;
iplocalcontrast.cc).

Per region: a 6-level à trous decomposition of the working-space
luminance, each level scaled by the region's level curve and the
contrast slider, U and V scaled by the luminance ratio, blended in by
the region's mask. Plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.curves import FlatCurve
from art_tpu_torch.color.yuv import rgb_to_yuv, yuv_to_rgb
from art_tpu_torch.core.fmath import fdiv
from art_tpu_torch.core.image import MAXVAL
from art_tpu_torch.masks import eval_mask, plan_mask, regions_from_extra
from art_tpu_torch.ops.wavelet import atrous_decompose, atrous_reconstruct

GROUP = "Local Contrast"

FIELDS = {
    "contrast": ("Contrast", "f", 0.0),
    "curve": ("Curve", "dl", []),
}

LEVELS = 6


def plan(pp, ctx):
    regions = regions_from_extra(pp, GROUP, FIELDS)
    if not regions:
        return None
    h, w = ctx.get("op_dims") or ctx["frame"].shape
    ws = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]]
    data = {"ws": ws.astype(np.float32), "lum_w": ws[1].astype(np.float32)}
    statics = []
    for ridx, (params, mask) in enumerate(regions):
        contrast = params["contrast"]
        curve = FlatCurve(params["curve"], periodic=False,
                          identity_value=0.0)
        if contrast == 0 and curve.is_identity():
            continue
        # per-level boost factors: the curve at the level positions
        # (0 = finest), plus the global contrast gain
        pos = np.linspace(0.0, 1.0, LEVELS)
        lvl = curve.get_val(pos) if not curve.is_identity() else np.zeros(
            LEVELS)
        factors = 1.0 + contrast / 100.0 + 4.0 * lvl
        mstatic, mdata = plan_mask(mask, (h, w), pp,
                                   ctx.get("device", "cpu"))
        data[f"lc{ridx}"] = {"mask": mdata,
                             "factors": factors.astype(np.float32)}
        statics.append((mstatic, ridx))
    if not statics:
        return None
    return tuple(statics), data


def apply(rgb, data, static):
    ws, lw = data["ws"], data["lum_w"]
    x01 = fdiv(rgb, MAXVAL)
    for mstatic, ridx in static:
        p = data[f"lc{ridx}"]
        mask = eval_mask(rgb, ws, mstatic, p["mask"])
        y, u, v = rgb_to_yuv(x01, lw)
        details, resid = atrous_decompose(y, LEVELS)
        y2 = atrous_reconstruct(
            [d * p["factors"][i] for i, d in enumerate(details)], resid)
        f = torch.where(y > 1e-6, y2 / torch.clamp(y, min=1e-6), 1.0)
        sm = yuv_to_rgb(y2, u * f, v * f, lw)
        x01 = sm * mask[None] + x01 * (1.0 - mask[None])
    return x01 * MAXVAL
