"""Lab adjustments (counterpart of ``art_tpu/ops/labadj.py``;
iplabadjustments.cc, "Luminance Curve").

Brightness (a toe/shoulder spline), contrast (a NURBS around the image's
mean luminance), the L, a and b user curves and the chromaticity, in Lab.
With contrast the L curve depends on the mean of brightness(L) over the
plane: the planner fits the composed curve for each of 25 means
(`AVG_GRID`, cubic segments, which are linear in their coefficients) and
the device interpolates between the two rows about the plane's mean, as
the reference does. Plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.curves import DiagonalCurve
from art_tpu_torch.core.curve1d import eval_curve, fit_curve
from art_tpu_torch.core.fmath import fdiv, mat3
from art_tpu_torch.core.image import MAXVAL

AVG_GRID = np.linspace(0.05, 0.95, 25)  # contrast-center sample points


def _brightness_curve(brightness, n=65536):
    if not brightness:
        return None
    pts = [4, 0.0, 0.0,
           0.1, 0.1 + abs(brightness) / 150.0,
           0.7, min(1.0, 0.7 + abs(brightness) / 300.0),
           1.0, 1.0]
    x = np.linspace(0.0, 1.0, n)
    y = DiagonalCurve(pts).get_val(x)
    if brightness < 0:
        # the inverse mapping for a negative brightness (get_L_curve)
        y = np.interp(x, y, x)
    return y


def _contrast_curve(contrast, avg=0.5, n=65536):
    if not contrast:
        return None
    pts = [3, 0.0, 0.0,
           avg - avg * (0.6 - contrast / 250.0),
           avg - avg * (0.6 + contrast / 250.0),
           avg + (1 - avg) * (0.6 - contrast / 250.0),
           avg + (1 - avg) * (0.6 + contrast / 250.0),
           1.0, 1.0]
    return DiagonalCurve(pts).get_val(np.linspace(0.0, 1.0, n))


def _compose(x, *luts):
    y = x
    for lut in luts:
        if lut is None:
            continue
        idx = np.clip(y, 0, 1) * (lut.shape[0] - 1)
        i0 = idx.astype(np.int64)
        i1 = np.minimum(i0 + 1, lut.shape[0] - 1)
        fr = idx - i0
        y = lut[i0] * (1 - fr) + lut[i1] * fr
    return y


def plan(pp, ctx):
    """(static, data) (labadj.py::plan): static (l_mode, use_ab), l_mode
    0 no L curve, 1 a fixed one, 2 the family over the contrast centre."""
    lc = pp.lab_curve
    if not lc.enabled:
        return None
    work = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]]
    x = np.linspace(0.0, 1.0, 65536)
    bl = _brightness_curve(lc.brightness)
    uc = DiagonalCurve(lc.lcurve)
    ul = None if uc.is_identity() else uc.get_val(x)

    l_mode = 0
    data = {
        "ws": work.astype(np.float32),
        "iws": np.linalg.inv(work).astype(np.float32),
        "chrom": np.float32(1.0 + lc.chromaticity / 100.0),
    }
    if lc.contrast:
        data["lfam"] = np.stack([fit_curve(
            _compose(x, bl, _contrast_curve(lc.contrast, avg=a), ul),
            allow_poly=False) for a in AVG_GRID]).astype(np.float32)
        if bl is not None:
            data["bcoeffs"] = fit_curve(bl)
        l_mode = 2
    elif bl is not None or ul is not None:
        data["lcoeffs"] = fit_curve(_compose(x, bl, ul))
        l_mode = 1

    ac = DiagonalCurve(lc.acurve)
    bc = DiagonalCurve(lc.bcurve)
    use_ab = not (ac.is_identity() and bc.is_identity())
    if use_ab:
        data["acoeffs"] = fit_curve(ac.get_val(x))
        data["bcoeffs_ab"] = fit_curve(bc.get_val(x))
    if l_mode == 0 and not use_ab and lc.chromaticity == 0:
        return None
    return (l_mode, use_ab), data


def apply(rgb, data, static):
    l_mode, has_ab = static
    L, a, b = cs.xyz_to_lab(*mat3(data["ws"], fdiv(rgb, MAXVAL)))
    if l_mode == 2:
        # contrast centre = mean of brightness(L) over the plane
        # (iplabadjustments.cc:95-106)
        ln = torch.clamp(fdiv(L, 100.0), 0.0, 1.0)
        if "bcoeffs" in data:
            m = torch.mean(eval_curve(ln, data["bcoeffs"], in_max=1.0,
                                      out_max=1.0))
        else:
            m = torch.mean(ln)
        n_avg = data["lfam"].shape[0]
        a0, a1 = float(AVG_GRID[0]), float(AVG_GRID[-1])
        pos = torch.clamp(fdiv(m - a0, a1 - a0), 0.0, 1.0) * (n_avg - 1)
        i0 = torch.clamp(torch.floor(pos).long(), 0, n_avg - 2)
        fr = pos - i0.to(pos.dtype)
        coeffs = data["lfam"][i0] * (1.0 - fr) + data["lfam"][i0 + 1] * fr
        L = eval_curve(ln, coeffs, in_max=1.0, out_max=100.0)
    elif l_mode == 1:
        L = eval_curve(torch.clamp(fdiv(L, 100.0), 0.0, 1.0),
                       data["lcoeffs"], in_max=1.0, out_max=100.0)
    if has_ab:
        an = torch.clamp(fdiv(a, 256.0) + 0.5, 0.0, 1.0)
        bn = torch.clamp(fdiv(b, 256.0) + 0.5, 0.0, 1.0)
        a = (eval_curve(an, data["acoeffs"], in_max=1.0, out_max=1.0)
             - 0.5) * 256.0
        b = (eval_curve(bn, data["bcoeffs_ab"], in_max=1.0, out_max=1.0)
             - 0.5) * 256.0
    a = a * data["chrom"]
    b = b * data["chrom"]
    return mat3(data["iws"], cs.lab_to_xyz(L, a, b)) * MAXVAL
