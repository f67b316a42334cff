"""Defringe (counterpart of ``art_tpu/ops/defringe.py``; PF_correct_RT.cc).

Hue-weighted chroma deviation from a gaussian of a and b: where the
fringe weight 1 / (deviation + mean deviation) falls below the
threshold's, a and b become the fringe-weighted window average. Plain
PyTorch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.curves import FlatCurve
from art_tpu_torch.core.curve1d import eval_curve, fit_curve
from art_tpu_torch.core.fmath import fdiv, mat3, rdiv
from art_tpu_torch.core.image import MAXVAL
from art_tpu_torch.masks import _mod
from art_tpu_torch.ops.filters import box_blur, gauss_blur


def plan(pp, ctx):
    d = pp.defringe
    if not d.enabled:
        return None
    work = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]]
    hc = FlatCurve(d.huecurve, periodic=True, identity_value=0.5)
    data = {"ws": work.astype(np.float32),
            "iws": np.linalg.inv(work).astype(np.float32),
            "thresh": np.float32(d.threshold)}
    use_curve = not hc.is_identity()
    if use_curve:
        data["hcoeffs"] = fit_curve(hc.lut(8192))
    halfwin = int(np.ceil(2 * d.radius)) + 1
    return (float(max(d.radius, 0.3)), halfwin, use_curve), data


def apply(rgb, data, static):
    radius, halfwin, use_curve = static
    L, a, b = cs.xyz_to_lab(*mat3(data["ws"], fdiv(rgb, MAXVAL)))
    a = a * 327.68
    b = b * 327.68
    L = L * 327.68
    ta = gauss_blur(a, radius)
    tb = gauss_blur(b, radius)
    factor = torch.ones_like(a)
    if use_curve:
        hh = fdiv(torch.atan2(b, a), 2 * math.pi)
        h01 = _mod(hh + 1.0 + 1.0 / 6.0, 1.0)
        chparam = eval_curve(h01, data["hcoeffs"], in_max=1.0,
                             out_max=1.0) - 0.5
        chparam = torch.where(chparam < 0, chparam * 2.0, chparam)
        factor = (1.0 + chparam) ** 2
    chroma = factor * ((a - ta) ** 2 + (b - tb) ** 2)
    chromave = torch.mean(chroma)
    fringe = rdiv(1.0, chroma + chromave)
    threshfactor = rdiv(1.0, fdiv(data["thresh"], 33.0) ** 2 * chromave
                        * 5.0 + chromave)
    r = halfwin - 1
    n = (2 * r + 1) ** 2
    atot = box_blur(fringe * a, r) * n
    btot = box_blur(fringe * b, r) * n
    norm = torch.clamp(box_blur(fringe, r) * n, min=1e-9)
    sel = fringe < threshfactor
    a2 = torch.where(sel, atot / norm, a)
    b2 = torch.where(sel, btot / norm, b)
    xyz = cs.lab_to_xyz(fdiv(L, 327.68), fdiv(a2, 327.68), fdiv(b2, 327.68))
    return mat3(data["iws"], xyz) * MAXVAL
