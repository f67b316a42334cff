"""Impulse (salt and pepper) denoise (counterpart of
``art_tpu/ops/impulse.py``; impulse_denoise.cc, rt_algo.cc markImpulse).

Plain PyTorch on the whole plane, as the reference's XLA code: Lab from
the working space; a pixel is an impulse where |L - gauss(L)| exceeds the
5x5 sum of that high-pass, less itself, times a threshold; an impulse is
replaced by the range-weighted mean of its non-impulse 5x5 neighbours
(edge-padded).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.core.fmath import fdiv, mat3
from art_tpu_torch.core.image import MAXVAL
from art_tpu_torch.ops.filters import box_blur, gauss_blur


def plan(pp, ctx):
    """(static, data) for the op (impulse.py::plan)."""
    ip = pp.impulse_denoise
    if not ip.enabled:
        return None
    thresh = ip.thresh / 20.0
    work = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]]
    data = {
        "ws": work.astype(np.float32),
        "iws": np.linalg.inv(work).astype(np.float32),
        "sigma": np.float32(max(2.0, thresh - 1.0)),
        "impthr_div24": np.float32(max(1.0, 5.5 - thresh) / 24.0),
    }
    return (float(max(2.0, thresh - 1.0)),), data


def detect(L, sigma, thr):
    """The impulse mask of the scaled L plane: |L - gauss(L)| above the
    5x5 sum of that high-pass, less itself, times thr."""
    hp = torch.abs(L - gauss_blur(L, sigma))
    nbr = box_blur(hp, 2) * 25.0  # 5x5 sum
    return hp > (nbr - hp) * thr


def apply(rgb, data, static):
    """Impulse denoise of a (3, H, W) tensor in the 0..65535 domain."""
    (sigma,) = static
    L, a, b = cs.xyz_to_lab(*mat3(data["ws"], fdiv(rgb, MAXVAL)))
    L = L * 327.68  # the reference's Lab scaling
    imp = detect(L, sigma, data["impthr_div24"])

    # replacement: range-weighted mean over the non-impulse 5x5 neighbours
    ok = (~imp).to(L.dtype)
    h, w = L.shape
    Lp, ap, bp, okp = F.pad(torch.stack([L, a, b, ok])[None], (2, 2, 2, 2),
                            mode="replicate")[0]
    norm = sl = sa = sb = None
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            win = (slice(2 + dy, 2 + dy + h), slice(2 + dx, 2 + dx + w))
            ln, an, bn = Lp[win], ap[win], bp[win]
            d = ln - L
            wt = okp[win] / (d * d + 1.0)
            if norm is None:
                norm, sl, sa, sb = wt, wt * ln, wt * an, wt * bn
            else:
                norm = norm + wt
                sl = sl + wt * ln
                sa = sa + wt * an
                sb = sb + wt * bn
    fix = imp & (norm > 0)
    den = torch.clamp(norm, min=1e-9)
    Lr = torch.where(fix, sl / den, L)
    ar = torch.where(fix, sa / den, a)
    br = torch.where(fix, sb / den, b)

    return mat3(data["iws"], cs.lab_to_xyz(fdiv(Lr, 327.68), ar, br)) \
        * MAXVAL
