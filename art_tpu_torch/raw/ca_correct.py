"""Raw chromatic aberration correction (counterpart of
``art_tpu/raw/ca_correct.py``; CA_correct_RT.cc:122).

R and B live on half-resolution subgrids, here strided views of the
mosaic (the reference reaches them through one-hot selection matmuls, a
TPU layout device). Auto mode: block shifts of R/B against a cardinal G
average by gradient correlation, a 3x3 median of the block shifts, a
ridge-regularised weighted least-squares fit of a 4x4 Legendre surface
(float32 `torch.linalg.solve`; TF32 is off package-wide), then a two-pass
variable-shift bilinear warp over edge pads. Frames whose subgrid is
under 256 on a side fall back to one global radial coefficient; manual
mode scales radially by the user's coefficients. The radial resample is
two plain float32 products with bilinear axis matrices.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from art_tpu_torch.core.fmath import fdiv
from art_tpu_torch.core.image import bayer_color_index

SHIFT_MAX = 4.0  # px on the subgrid


def _subgrid_offsets(pattern, color):
    """(row0, col0) of the `color` subgrid in the 2x2 pattern."""
    pos = np.argwhere(bayer_color_index(pattern, (2, 2)) == color)
    return int(pos[0][0]), int(pos[0][1])


def _legendre_terms(yn, xn, pairs):
    """Products P_i(yn) P_j(xn) for (i, j) in `pairs`, [-1, 1] coords."""

    def P(t):
        return (torch.ones_like(t), t, 1.5 * t * t - 0.5,
                2.5 * t * t * t - 1.5 * t)

    py, px = P(yn), P(xn)
    return [py[i] * px[j] for i, j in pairs]


def _term_pairs(n_blocks):
    """Basis size by block count: the full 4x4 surface needs enough
    tiles; small frames degrade to quadratic or affine fits."""
    if n_blocks >= 48:
        return [(i, j) for i in range(4) for j in range(4)]
    if n_blocks >= 12:
        return [(i, j) for i in range(3) for j in range(3) if i + j <= 2]
    return [(0, 0), (0, 1), (1, 0)]


def _correlation(sub_c, sub_g, nby, nbx):
    """Per-block (dy, dx, weight) of sub_c against sub_g over an
    nby x nbx grid: d = -sum(diff * grad) / sum(grad^2)."""
    h, w = sub_c.shape
    gy, gx = torch.gradient(sub_g)
    diff = sub_c - sub_g
    bh, bw = h // nby, w // nbx

    def block_sum(a):
        return a[: bh * nby, : bw * nbx].reshape(nby, bh, nbx, bw).sum(
            dim=(1, 3))

    den_x, den_y = block_sum(gx * gx), block_sum(gy * gy)
    dx = -block_sum(diff * gx) / (den_x + 1e-3)
    dy = -block_sum(diff * gy) / (den_y + 1e-3)
    return dy, dx, den_x + den_y, (bh, bw)


def _block_shifts(sub_c, sub_g, bs=64):
    """Block shifts over 64-px blocks of the subgrid (the reference's
    ts=128 mosaic tiles), clipped to SHIFT_MAX."""
    h, w = sub_c.shape
    nby, nbx = max(h // bs, 2), max(w // bs, 2)
    dy, dx, wgt, (bh, bw) = _correlation(sub_c, sub_g, nby, nbx)
    dx = torch.clamp(dx, -SHIFT_MAX, SHIFT_MAX)
    dy = torch.clamp(dy, -SHIFT_MAX, SHIFT_MAX)
    return dy, dx, wgt, (nby, nbx, bh, bw)


def _estimate_radial(sub_c, sub_g, n_blocks=8):
    """Global radial coefficient (shift = c * r): the small-frame fallback,
    one pooled parameter over an 8x8 block grid."""
    h, w = sub_c.shape
    dy, dx, wgt, (bh, bw) = _correlation(sub_c, sub_g, n_blocks, n_blocks)
    ar = torch.arange(n_blocks, device=sub_c.device)
    cy = (ar + 0.5) * bh - h / 2.0
    cx = (ar + 0.5) * bw - w / 2.0
    ones = torch.ones((1, n_blocks), device=sub_c.device)
    yy = cy[:, None] * ones
    xx = cx[None, :] * ones.T
    wgt = wgt / (torch.sum(wgt) + 1e-9)
    c = torch.sum(wgt * (dx * xx + dy * yy)) / torch.clamp(
        torch.sum(wgt * (xx * xx + yy * yy)), min=1e-9)
    return torch.clamp(c, -0.01, 0.01)


def _median3x3(a):
    """3x3 median over the block grid, edge-replicated (:760-775)."""
    ap = F.pad(a[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    h, w = a.shape
    st = torch.stack([ap[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    return torch.median(st, dim=0).values


def _fit_surface(dy, dx, wgt, geom, shape):
    """Weighted LS fit of the Legendre surface; returns the subgrid's
    (sy, sx) shift fields."""
    nby, nbx, bh, bw = geom
    h, w = shape
    dev = dy.device
    dy, dx = _median3x3(dy), _median3x3(dx)
    pairs = _term_pairs(nby * nbx)
    cy = fdiv((torch.arange(nby, device=dev) + 0.5) * bh, h) * 2.0 - 1.0
    cx = fdiv((torch.arange(nbx, device=dev) + 0.5) * bw, w) * 2.0 - 1.0
    yn = torch.repeat_interleave(cy, nbx)
    xn = cx.repeat(nby)
    A = torch.stack(_legendre_terms(yn, xn, pairs), dim=1)
    wn = wgt.reshape(-1) / (torch.sum(wgt) + 1e-9) + 1e-12
    AtW = A.T * wn[None, :]
    G = AtW @ A + 1e-6 * torch.eye(A.shape[1], dtype=A.dtype, device=dev)
    coeff_y = torch.linalg.solve(G, AtW @ dy.reshape(-1))
    coeff_x = torch.linalg.solve(G, AtW @ dx.reshape(-1))

    yy = fdiv(torch.arange(h, dtype=torch.float32, device=dev) + 0.5, h)
    xx = fdiv(torch.arange(w, dtype=torch.float32, device=dev) + 0.5, w)
    terms = _legendre_terms((yy * 2.0 - 1.0)[:, None],
                            (xx * 2.0 - 1.0)[None, :], pairs)
    sy = sum(c * t for c, t in zip(coeff_y, terms))
    sx = sum(c * t for c, t in zip(coeff_x, terms))
    return (torch.clamp(sy, -SHIFT_MAX, SHIFT_MAX),
            torch.clamp(sx, -SHIFT_MAX, SHIFT_MAX))


def _warp_axis(a, shift, axis, dmax=int(SHIFT_MAX)):
    """out(p) = a(p + shift(p)) along `axis`, bilinear, |shift| <= dmax:
    the tent-weighted sum over the integer taps of an edge pad."""
    pad = dmax + 1
    pw = (0, 0, pad, pad) if axis == 0 else (pad, pad, 0, 0)
    ap = F.pad(a[None, None], pw, mode="replicate")[0, 0]
    shift = torch.clamp(shift, -dmax, dmax - 1e-3)
    out = torch.zeros_like(a)
    n = a.shape[axis]
    for d in range(-dmax, dmax + 2):
        w = torch.clamp(1.0 - torch.abs(shift - d), min=0.0)
        out = out + w * ap.narrow(axis, pad + d, n)
    return out


def _warp2d(sub, sy, sx):
    """Two-pass spatially varying bilinear warp."""
    return _warp_axis(_warp_axis(sub, sy, 0), sx, 1)


def _axis_matrix(n, scale, device):
    """Bilinear 1-D resample matrix M[i, j] = w(src_i - j),
    src_i = (i - c)(1 + scale) + c."""
    c = (n - 1) / 2.0
    i = torch.arange(n, dtype=torch.float32, device=device)
    src = torch.clamp((i - c) * (1.0 + scale) + c, 0.0, n - 1.0)
    return torch.clamp(1.0 - torch.abs(src[:, None] - i[None, :]), min=0.0)


def _resample_radial(sub, scale):
    h, w = sub.shape
    ry = _axis_matrix(h, scale, sub.device)
    cx = _axis_matrix(w, scale, sub.device)
    return torch.matmul(torch.matmul(ry, sub), cx.T)


def ca_correct(cfa, pattern, auto=True, ca_red=0.0, ca_blue=0.0):
    """Correct lateral CA on the scaled (H, W) mosaic (H, W even);
    returns the corrected mosaic."""
    ry, rx = _subgrid_offsets(pattern, 0)
    by, bx = _subgrid_offsets(pattern, 2)
    sub_r = cfa[ry::2, rx::2]
    sub_b = cfa[by::2, bx::2]
    # G reference at the R/B sites: the cardinal average
    gavg = 0.25 * (torch.roll(cfa, 1, 1) + torch.roll(cfa, -1, 1)
                   + torch.roll(cfa, 1, 0) + torch.roll(cfa, -1, 0))
    g_r = gavg[ry::2, rx::2]
    g_b = gavg[by::2, bx::2]

    if auto and min(sub_r.shape) >= 256:
        new_r = _warp2d(sub_r, *_fit_surface(*_block_shifts(sub_r, g_r),
                                             shape=sub_r.shape))
        new_b = _warp2d(sub_b, *_fit_surface(*_block_shifts(sub_b, g_b),
                                             shape=sub_b.shape))
    elif auto:
        new_r = _resample_radial(sub_r, _estimate_radial(sub_r, g_r))
        new_b = _resample_radial(sub_b, _estimate_radial(sub_b, g_b))
    else:
        f32 = np.float32
        new_r = _resample_radial(sub_r, f32(ca_red * 1e-3))
        new_b = _resample_radial(sub_b, f32(ca_blue * 1e-3))
    out = cfa.clone()
    out[ry::2, rx::2] = new_r
    out[by::2, bx::2] = new_b
    return out
