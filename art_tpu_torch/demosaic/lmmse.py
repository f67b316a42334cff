"""LMMSE Bayer demosaic (counterpart of ``art_tpu/demosaic/lmmse.py``;
lmmse_demosaic.cc, Zhang & Wu 2005).

The reference's whole-plane formulation in plain PyTorch: the G-R/G-B
differences interpolated along each axis by the 5-tap filter (guarded in
highlights by a 3-way median), low-passed by a 9-tap gaussian, fused per
axis by the LMMSE estimate over 9-sample windows and across the axes by
inverse posterior variance; R and B from the difference planes; then
`iterations - 1` median refinements of R-G and B-G (3x3, reflect pad).
"""

from __future__ import annotations

import math

import torch

from art_tpu_torch.core.fmath import fdiv
from art_tpu_torch.core.image import bayer_channel_masks, shifts
from art_tpu_torch.demosaic.ahd import median3

EPS = 1e-7


def med3x3(x):
    """The 3x3 median over a reflect pad."""
    sh = shifts(x, 1)
    planes = torch.stack([sh(dy, dx) for dy in (-1, 0, 1)
                          for dx in (-1, 0, 1)])
    return torch.median(planes, dim=0).values


def _axis_shift(p, k, r, h, w, axis):
    if axis == 1:
        return p[r: r + h, r + k: r + k + w]
    return p[r + k: r + k + h, r: r + w]


def lmmse_axis(diff, lp, axis):
    """The LMMSE fuse of a directional difference against its low pass
    over a 9-sample window along `axis`: (estimate, posterior variance)."""
    r = 4
    h, w = diff.shape
    pd = torch.nn.functional.pad(diff[None, None], (r, r, r, r),
                                 mode="reflect")[0, 0]
    pl = torch.nn.functional.pad(lp[None, None], (r, r, r, r),
                                 mode="reflect")[0, 0]
    ps = [_axis_shift(pl, k, r, h, w, axis) for k in range(-4, 5)]
    mu = fdiv(sum(ps), 9.0)
    vx = EPS + sum((p - mu) ** 2 for p in ps)
    qs = [ps[k + 4] - _axis_shift(pd, k, r, h, w, axis)
          for k in range(-4, 5)]
    vn = EPS + sum(q * q for q in qs)
    est = (diff * vx + lp * vn) / (vx + vn)
    var = vx * vn / (vx + vn)
    return est, var


def lmmse_demosaic(cfa, pattern, iterations=2, **kw):
    """(H, W) mosaic in 0..65535 -> (3, H, W) RGB on cfa's device."""
    x = cfa * (1.0 / 65535.0)
    mr, mg, mb = bayer_channel_masks(pattern, x.shape, x.device)
    sh = shifts(x, 2)

    # directional interpolation of the G-R(B) difference
    v0 = 0.0625 * (sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1)) + 0.25 * x
    ih = -0.25 * (sh(0, -2) + sh(0, 2)) + 0.5 * (sh(0, -1) + x + sh(0, 1))
    iv = -0.25 * (sh(-2, 0) + sh(2, 0)) + 0.5 * (sh(-1, 0) + x + sh(1, 0))
    # the highlight guard: where the site towers over the local mean,
    # the median of (interpolation, left, right)
    hl_h = x > 1.75 * (v0 + 0.5 * ih)
    hl_v = x > 1.75 * (v0 + 0.5 * iv)
    ih = torch.where(hl_h, median3(ih, sh(0, -1), sh(0, 1)),
                     torch.clamp(ih, 0.0, 1.0))
    iv = torch.where(hl_v, median3(iv, sh(-1, 0), sh(1, 0)),
                     torch.clamp(iv, 0.0, 1.0))
    # at G sites the same stencil estimates (G - C) directly
    gh = 0.25 * (sh(0, -2) + sh(0, 2)) - 0.5 * (sh(0, -1) + x + sh(0, 1))
    gv = 0.25 * (sh(-2, 0) + sh(2, 0)) - 0.5 * (sh(-1, 0) + x + sh(1, 0))
    diff_h = torch.where(mg, torch.clamp(gh, -1.0, 0.0) + x, ih - x)
    diff_v = torch.where(mg, torch.clamp(gv, -1.0, 0.0) + x, iv - x)

    # the 9-tap gaussian low pass along each direction
    hk = [1.0] + [math.exp(-(k * k) / 8.0) for k in range(1, 5)]
    norm = hk[0] + 2.0 * sum(hk[1:])
    hk = [c / norm for c in hk]
    r = 4
    h, w = x.shape
    ph = torch.nn.functional.pad(diff_h[None, None], (r, r, r, r),
                                 mode="reflect")[0, 0]
    pv = torch.nn.functional.pad(diff_v[None, None], (r, r, r, r),
                                 mode="reflect")[0, 0]
    lp_h = hk[0] * diff_h
    lp_v = hk[0] * diff_v
    for k in range(1, 5):
        lp_h = lp_h + hk[k] * (ph[r: r + h, r - k: r - k + w]
                               + ph[r: r + h, r + k: r + k + w])
        lp_v = lp_v + hk[k] * (pv[r - k: r - k + h, r: r + w]
                               + pv[r + k: r + k + h, r: r + w])

    est_h, var_h = lmmse_axis(diff_h, lp_h, axis=1)
    est_v, var_v = lmmse_axis(diff_v, lp_v, axis=0)
    fdiff = (est_h * var_v + est_v * var_h) / (var_h + var_v)
    g = torch.where(mg, x, x + fdiff)

    # R/B from the colour-difference planes: dC is 0 off its sites, so
    # the cross sum fires at G sites only (one axis), the diagonal at the
    # opposite colour's sites
    def chan(mc):
        d = torch.where(mc, x - g, 0.0)
        s = shifts(d, 1)
        cross = s(0, -1) + s(0, 1) + s(-1, 0) + s(1, 0)
        diag = s(-1, -1) + s(-1, 1) + s(1, -1) + s(1, 1)
        return torch.where(mc, x, g + 0.5 * cross + 0.25 * diag)

    red, blue = chan(mr), chan(mb)
    for _ in range(max(int(iterations) - 1, 0)):
        m_rg = med3x3(red - g)
        m_bg = med3x3(blue - g)
        red = torch.where(mr, x, g + m_rg)
        blue = torch.where(mb, x, g + m_bg)
        g = torch.where(mg, x, 0.5 * ((red - m_rg) + (blue - m_bg)))
    return torch.stack([red, g, blue]) * 65535.0
