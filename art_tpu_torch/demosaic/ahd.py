"""AHD demosaic (counterpart of ``art_tpu/demosaic/ahd.py``;
ahd_demosaic_RT.cc, Hirakawa-Parks adaptive homogeneity-directed).

The reference's whole-plane formulation in plain PyTorch: horizontal and
vertical green candidates clamped by a median, R/B per direction from
colour differences, CIELab homogeneity maps with adaptive epsilons from
the opposing directions' differences, and a vote over the 3x3-summed
maps. Lab uses the sRGB matrix (the reference's deviation: the metric
only ranks directions); its cube root is `core/fmath.py::cbrt_xla`. The outer
5-pixel ring takes the bilinear result.
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.core.fmath import cbrt_xla
from art_tpu_torch.core.image import bayer_channel_masks, shifts
from art_tpu_torch.demosaic.bilinear import bilinear_ring

BORDER = 5

_XYZ_RGB = np.array([
    [0.412453, 0.357580, 0.180423],
    [0.212671, 0.715160, 0.072169],
    [0.019334, 0.119193, 0.950227]])
_D65 = np.array([0.950456, 1.0, 1.088754])
_XYZ_N = (_XYZ_RGB / _D65[:, None]).tolist()


def median3(a, b, c):
    return torch.maximum(torch.minimum(torch.maximum(a, b), c),
                         torch.minimum(a, b))


def lab_f(t):
    return torch.where(t > 0.008856, cbrt_xla(torch.clamp(t, min=1e-9)),
                       7.787 * t + 16.0 / 116.0)


def to_lab(r, g, b):
    """(L, a, b) of 0..65535 sRGB planes, D65 white."""
    scale = 1.0 / 65535.0
    m = _XYZ_N
    x = (m[0][0] * r + m[0][1] * g + m[0][2] * b) * scale
    y = (m[1][0] * r + m[1][1] * g + m[1][2] * b) * scale
    z = (m[2][0] * r + m[2][1] * g + m[2][2] * b) * scale
    fx, fy, fz = lab_f(x), lab_f(y), lab_f(z)
    return 116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)


def green_candidates(x, mg):
    """The horizontal and vertical greens at R/B sites, the 5-tap
    estimate clamped by a median to its two green neighbours; the mosaic
    at G sites."""
    s = shifts(x, 2)
    gh = median3(0.25 * ((s(0, -1) + s(0, 0) + s(0, 1)) * 2.0
                         - s(0, -2) - s(0, 2)), s(0, -1), s(0, 1))
    gv = median3(0.25 * ((s(-1, 0) + s(0, 0) + s(1, 0)) * 2.0
                         - s(-2, 0) - s(2, 0)), s(-1, 0), s(1, 0))
    return torch.where(mg, x, gh), torch.where(mg, x, gv)


def rg_rows(mr):
    """The sites whose horizontal neighbours are red."""
    return torch.roll(mr, 1, dims=1) | torch.roll(mr, -1, dims=1)


def box3(p):
    sp = shifts(p, 1)
    return (sp(-1, -1) + sp(-1, 0) + sp(-1, 1) + sp(0, -1) + sp(0, 0)
            + sp(0, 1) + sp(1, -1) + sp(1, 0) + sp(1, 1))


def ahd_demosaic(cfa, pattern, **kw):
    """(H, W) mosaic in 0..65535 -> (3, H, W) RGB on cfa's device."""
    x = torch.clamp(cfa, min=0.0)
    mr, mg, mb = bayer_channel_masks(pattern, x.shape, x.device)
    rg_row = rg_rows(mr)
    sh_x = shifts(x, 1)

    rgbs, labs = [], []
    for g in green_candidates(x, mg):
        sg = shifts(g, 1)
        # at G sites: the colour of the row from +-1 columns, the other
        # from +-1 rows; at the opposite sites the diagonal differences
        c_h = torch.clamp(x + 0.5 * (sh_x(0, -1) + sh_x(0, 1)
                                     - sg(0, -1) - sg(0, 1)), 0.0, 65535.0)
        c_v = torch.clamp(x + 0.5 * (sh_x(-1, 0) + sh_x(1, 0)
                                     - sg(-1, 0) - sg(1, 0)), 0.0, 65535.0)
        diag = torch.clamp(g + 0.25 * (
            sh_x(-1, -1) + sh_x(-1, 1) + sh_x(1, -1) + sh_x(1, 1)
            - sg(-1, -1) - sg(-1, 1) - sg(1, -1) - sg(1, 1)), 0.0, 65535.0)
        r = torch.where(mr, x, torch.where(mb, diag,
                                           torch.where(rg_row, c_h, c_v)))
        b = torch.where(mb, x, torch.where(mr, diag,
                                           torch.where(rg_row, c_v, c_h)))
        rgbs.append((r, g, b))
        labs.append(to_lab(r, g, b))

    # homogeneity: left/right (0, 1) and up/down (2, 3)
    dirs = ((0, -1), (0, 1), (-1, 0), (1, 0))
    ldiff = [[None] * 4 for _ in range(2)]
    abdiff = [[None] * 4 for _ in range(2)]
    for d in range(2):
        lum, a_, b_ = labs[d]
        sl, sa, sb = shifts(lum, 1), shifts(a_, 1), shifts(b_, 1)
        for i, (dy, dx) in enumerate(dirs):
            ldiff[d][i] = torch.abs(lum - sl(dy, dx))
            abdiff[d][i] = (a_ - sa(dy, dx)) ** 2 + (b_ - sb(dy, dx)) ** 2
    leps = torch.minimum(torch.maximum(ldiff[0][0], ldiff[0][1]),
                         torch.maximum(ldiff[1][2], ldiff[1][3]))
    abeps = torch.minimum(torch.maximum(abdiff[0][0], abdiff[0][1]),
                          torch.maximum(abdiff[1][2], abdiff[1][3]))
    homo = []
    for d in range(2):
        hsum = torch.zeros_like(x)
        for i in range(4):
            hsum = hsum + ((ldiff[d][i] <= leps)
                           & (abdiff[d][i] <= abeps)).to(x.dtype)
        homo.append(hsum)
    hm0, hm1 = box3(homo[0]), box3(homo[1])

    rgb = torch.stack([
        torch.where(hm1 > hm0, p1, torch.where(hm0 > hm1, p0,
                                               0.5 * (p0 + p1)))
        for p0, p1 in zip(rgbs[0], rgbs[1])])
    return bilinear_ring(rgb, cfa, pattern, BORDER)
