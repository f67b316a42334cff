"""Block-DCT luminance detail recovery (counterpart of
``art_tpu/ops/dct_detail.py``; FTblockDN.cc:1479 detail_recovery).

The residual the wavelet shrink removed from the luminance is cut into
64x64 tiles at four shifts of 32 pixels (each pixel in four tiles),
windowed by sin^2 edges, DCT'd (FFTW REDFT10/REDFT01 scaling, as two
host-built 64x64 float32 matrices and `torch.matmul`, TF32 off), its
coefficients attenuated by 1 - exp(-nbrwt^2 / noisevar) (nbrwt a box
blur of their magnitudes, noisevar from the Luminance Detail slider),
inverse DCT'd, windowed again, summed and divided by the constant
combining weight; what survives is added back to the denoised plane.
With a detail threshold, a log-domain Laplacian mask of the luminance
modulates the slider per pixel (`detail_mask`). Plain PyTorch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from art_tpu_torch.core.fmath import fdiv
from art_tpu_torch.ops.filters import gauss_blur
from art_tpu_torch.ops.wavelet import _reflect_index

TS = 64
STRIDE = 32
_SHIFTS = ((0, 0), (0, STRIDE), (STRIDE, 0), (STRIDE, STRIDE))
_LSCALE = 65535.0  # the reference's labdn->L scale inside RGB_denoise


def _tilemasks():
    """sin^2 edge windows (FTblockDN.cc:1831-1845), with an epsilon
    floor."""
    border = max(2, TS // 16)
    eps = 0.001 / (TS * TS)
    i = np.arange(TS, dtype=np.float64)
    i1 = np.where(i > TS / 2, np.abs(i - TS + 1), i)
    m_in = np.where(i1 < border,
                    np.sin((np.pi * i1) / (2 * border)) ** 2, 1.0)
    m_out = np.where(i1 < 2 * border,
                     np.sin((np.pi * i1) / (2 * border)) ** 2, 1.0)
    w_in = (m_in[:, None] * m_in[None, :] + eps).astype(np.float32)
    w_out = (m_out[:, None] * m_out[None, :] + eps).astype(np.float32)
    return w_in, w_out


W_IN, W_OUT = _tilemasks()


def _totwt_pattern():
    """The combining weight: w_in * w_out summed over the four covering
    shifts, periodic with period STRIDE on both axes."""
    prod = W_IN * W_OUT
    pat = (prod[:STRIDE, :STRIDE] + prod[STRIDE:, :STRIDE]
           + prod[:STRIDE, STRIDE:] + prod[STRIDE:, STRIDE:])
    return pat.astype(np.float32)


TOTWT = _totwt_pattern()


def dct_mats():
    """FFTW-scaled DCT-II forward and DCT-III inverse matrices, the
    reference's 1/(4 TS^2) norm folded into the inverse as 1/(2 TS) a
    side."""
    n = np.arange(TS, dtype=np.float64)
    k = np.arange(TS, dtype=np.float64)
    fwd = 2.0 * np.cos(np.pi * (n[None, :] + 0.5) * k[:, None] / TS)
    scale = np.where(k == 0, 1.0, 2.0)
    inv = scale[None, :] * np.cos(np.pi * k[None, :] * (n[:, None] + 0.5) / TS)
    inv /= 2.0 * TS
    return fwd.astype(np.float32), inv.astype(np.float32)


DCT_F, DCT_I = dct_mats()


def compute_detail(d):
    """noisevar_Ldetail from the Detail slider (FTblockDN.cc:1482-1486)."""
    t = 100.0 - d
    return ((t * t + 50.0 * t) * (TS * 0.5)) ** 2


def _box_abs_blur_tiles(x, rad):
    """Per-tile box blur of |x| with windows shrinking at the tile edges
    (boxabsblur, boxblur.h:745); x: (N, TS, TS)."""
    a = torch.abs(x)
    ones = torch.ones((1, TS, TS), dtype=a.dtype, device=a.device)

    def blur1d(v, dim):
        pad = [0, 0, 0, 0]
        pad[2 * (2 - dim)] = pad[2 * (2 - dim) + 1] = rad
        c = torch.cumsum(torch.nn.functional.pad(v, pad), dim=dim)
        c = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)), c], dim=dim)
        return c.narrow(dim, 2 * rad + 1, TS) - c.narrow(dim, 0, TS)

    num = blur1d(blur1d(a, 1), 2)
    den = blur1d(blur1d(ones, 1), 2)
    return num / den


def _tile_groups(xp):
    """The four shifted tilings of a padded plane: (dy, dx, tiles of
    (nh * nw, TS, TS), (nh, nw, h, w))."""
    hp, wp = xp.shape
    for dy, dx in _SHIFTS:
        h = hp - (TS if dy else 0)
        w = wp - (TS if dx else 0)
        sub = xp[dy:dy + h, dx:dx + w]
        nh, nw = h // TS, w // TS
        tiles = sub.reshape(nh, TS, nw, TS).permute(0, 2, 1, 3)
        yield dy, dx, tiles.reshape(nh * nw, TS, TS), (nh, nw, h, w)


def resize_linear_matrix(n_in, n_out):
    """(n_out, n_in) float32 weights of `jax.image.resize(...,
    method="linear")` along one axis: a triangle kernel, widened by the
    scale when downscaling (antialias), normalised over the samples
    inside the input."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[None, :]
                - np.arange(n_in, dtype=np.float32)[:, None])
         / kernel_scale)
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.ascontiguousarray(
        np.where(inside[None, :], weights, 0).T.astype(np.float32))


def _resize_linear(x, shape):
    """A (H, W) plane resized as `jax.image.resize(x, shape, "linear")`."""
    out = x
    (h, w), (oh, ow) = x.shape, shape
    if oh != h:
        out = torch.matmul(torch.from_numpy(
            resize_linear_matrix(h, oh)).to(x.device), out)
    if ow != w:
        out = torch.matmul(out, torch.from_numpy(
            resize_linear_matrix(w, ow)).to(x.device).transpose(0, 1))
    return out


def detail_mask(L, amount, scale=1.0):
    """The per-pixel Detail modulation (detail_mask, FTblockDN.cc:1408);
    L the 0..1 gamma-domain luminance, amount the threshold / 100."""
    H, W = L.shape
    if H < 8 or W < 8:
        return torch.ones_like(L)
    L2 = _resize_linear(L, (H // 4, W // 4))
    base = 50.0
    L2 = fdiv(torch.log(torch.clamp(L2, min=0.0) * (base - 1.0) + 1.0),
              math.log(base))
    h4, w4 = L2.shape
    p = L2.index_select(0, _reflect_index(h4, 1, L2.device))
    p = torch.clamp(p.index_select(1, _reflect_index(w4, 1, L2.device)),
                    min=0.0)
    lap = (-8.0 * p[1:-1, 1:-1] + p[:-2, 1:-1] + p[2:, 1:-1]
           + p[1:-1, :-2] + p[1:-1, 2:] + p[:-2, :-2] + p[:-2, 2:]
           + p[2:, :-2] + p[2:, 2:])
    thr = 25.0 / _LSCALE
    ceil = 10000.0 / _LSCALE
    m2 = torch.clamp(torch.abs(lap) - thr, 0.0, ceil) * (amount / ceil)
    mask = _resize_linear(m2, (H, W))
    x = torch.clamp(mask + (1.0 - amount), 0.0, 1.0)
    mask = fdiv(torch.log(torch.pow(x, 2.23) * 100.0 + 1.0), math.log(101.0))
    return gauss_blur(mask, 25.0 / scale)


def dct_detail_recovery(y_in, y_dn, lum_detail, detail_thresh=0,
                        scale=1.0):
    """The denoised luminance y_dn with the DCT-filtered residual of y_in
    added back; y_in, y_dn the 0..1 gamma-domain luminance before and
    after the wavelet shrink, lum_detail the slider (0..100, a tensor)."""
    H, W = y_in.shape
    dev = y_in.device
    params_ld = torch.clamp(torch.as_tensor(lum_detail, dtype=torch.float32,
                                            device=dev), max=99.9)
    resid = (y_in - y_dn) * _LSCALE
    # pad: at least STRIDE on each side, a multiple of TS in all
    Hp = int(np.ceil((H + 2 * STRIDE) / TS) * TS)
    Wp = int(np.ceil((W + 2 * STRIDE) / TS) * TS)
    pt, pl = STRIDE, STRIDE
    rows = _reflect_index(H, max(pt, Hp - H - pt), dev)
    cols = _reflect_index(W, max(pl, Wp - W - pl), dev)
    r0 = max(pt, Hp - H - pt) - pt
    c0 = max(pl, Wp - W - pl) - pl
    rp = resid.index_select(0, rows[r0:r0 + Hp]).index_select(
        1, cols[c0:c0 + Wp])

    # the noise variance per pixel, detail_lo outside the image (the zero
    # pad gives compute_detail(0))
    if detail_thresh > 0:
        amount = float(np.clip(detail_thresh / 100.0, 0.0, 1.0))
        dplane = params_ld * detail_mask(y_dn, amount, scale)
    else:
        dplane = torch.ones((H, W), dtype=torch.float32, device=dev) \
            * params_ld
    dp = torch.nn.functional.pad(dplane, (pl, Wp - W - pl, pt, Hp - H - pt))
    nvp = compute_detail(dp)

    w_in = torch.from_numpy(W_IN).to(dev)
    w_out = torch.from_numpy(W_OUT).to(dev)
    df = torch.from_numpy(DCT_F).to(dev)
    di = torch.from_numpy(DCT_I).to(dev)
    rad = max(1, int(3 / scale))

    acc = torch.zeros((Hp, Wp), dtype=torch.float32, device=dev)
    nv_groups = [g for _, _, g, _ in _tile_groups(nvp)]
    for (dy, dx, tiles, (nh, nw, h, w)), nvg in zip(_tile_groups(rp),
                                                    nv_groups):
        f = torch.matmul(torch.matmul(df, tiles * w_in), df.transpose(0, 1))
        nbrwt = _box_abs_blur_tiles(f, rad)
        nv = torch.clamp(nvg, min=1e-6)
        f = f * (1.0 - torch.exp(-(nbrwt * nbrwt) / nv))
        out = torch.matmul(torch.matmul(di, f), di.transpose(0, 1)) * w_out
        plane = out.reshape(nh, nw, TS, TS).permute(0, 2, 1, 3).reshape(h, w)
        acc[dy:dy + h, dx:dx + w] += plane

    totwt = torch.from_numpy(np.tile(TOTWT, (Hp // STRIDE, Wp // STRIDE))
                             ).to(dev)
    detail = (acc / totwt)[pt:pt + H, pl:pl + W]
    return y_dn + fdiv(detail, _LSCALE)
