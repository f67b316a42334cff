"""Dynamic range compression, Fattal'02 gradient-domain tone mapping
(counterpart of ``art_tpu/ops/fattal.py``; rtengine/tmo_fattal02.cc).

The log luminance's gradients are attenuated by a factor built over a
7-level pyramid (blur and decimate, the attenuation computed at most
1920 pixels wide and repeated up), the attenuated divergence is solved
back by a Neumann Poisson solve (an even-symmetric extension through
`torch.fft.rfft2` / `irfft2`), and the image is scaled by the new
luminance over the old, matched at the medians of a ~200 px nearest
subsample. Deep shadows first take a median of a stencil that grows
with the image (7x7, 49 points, at 24 MP). Plain PyTorch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from art_tpu_torch.color import colorspaces as cs

NLEVELS = 7
DETAIL_LEVEL = 3
DIM_CAP = 1920


def plan(pp, ctx):
    f = pp.fattal
    if not f.enabled:
        return None
    alpha = 1.0
    if f.threshold < 0:
        alpha += f.threshold * 0.9 / 100.0
    elif f.threshold > 0:
        alpha += f.threshold / 100.0
    beta = 1.0 - (f.amount * 0.3) / 100.0
    if alpha <= 0 or beta <= 0:
        return None
    lum_w = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]][1]
    data = {
        "lum_w": lum_w.astype(np.float32),
        "alpha": np.float32(alpha),
        "beta": np.float32(beta),
        "noise": np.float32(alpha * 0.01),
    }
    return (), data


# median stencils by image size (Median_Denoise call,
# tmo_fattal02.cc:1104-1116: r = max(w,h)/1920 picks 3x3 strong /
# 5x5 soft (13-pt diamond) / 5x5 strong / 7x7)
_MED_3X3 = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
_MED_5X5_SOFT = [(-2, 0), (-1, -1), (-1, 0), (-1, 1), (0, -2), (0, -1),
                 (0, 0), (0, 1), (0, 2), (1, -1), (1, 0), (1, 1), (2, 0)]
_MED_5X5 = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)]
_MED_7X7 = [(dy, dx) for dy in range(-3, 4) for dx in range(-3, 4)]


# the median's rows a chunk: 49 shifted planes of 512 rows of a 6000-wide
# plane hold 0.6 GB
_MEDIAN_ROWS = 512


def _median_pts(x, pts):
    """The median over the stencil's points of the edge-padded plane
    (an odd count: the middle value), in chunks of rows."""
    r = max(max(abs(dy), abs(dx)) for dy, dx in pts)
    p = F.pad(x[None, None], (r, r, r, r), mode="replicate")[0, 0]
    h, w = x.shape
    out = torch.empty_like(x)
    for y0 in range(0, h, _MEDIAN_ROWS):
        n = min(_MEDIAN_ROWS, h - y0)
        vals = torch.stack([p[r + y0 + dy : r + y0 + dy + n,
                              r + dx : r + dx + w] for dy, dx in pts])
        out[y0 : y0 + n] = torch.median(vals, dim=0).values
    return out


def _blur5(x):
    """The pyramid's blur (tmo_fattal02.cc:178): [1 4 6 4 1]/16 each way,
    edge-padded, taps summed in order."""
    k = [c / 16.0 for c in (1.0, 4.0, 6.0, 4.0, 1.0)]
    h, w = x.shape
    p = F.pad(x[None, None], (0, 0, 2, 2), mode="replicate")[0, 0]
    col = sum(p[i : i + h] * k[i] for i in range(5))
    p2 = F.pad(col[None, None], (2, 2, 0, 0), mode="replicate")[0, 0]
    return sum(p2[:, i : i + w] * k[i] for i in range(5))


def _gradients(hh, k):
    divider = 2.0 ** (k + 1)
    p = F.pad(hh[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    h, w = hh.shape
    gx = p[1 : 1 + h, 0:w] - p[1 : 1 + h, 2 : 2 + w]
    gy = p[2 : 2 + h, 1 : 1 + w] - p[0:h, 1 : 1 + w]
    g = torch.sqrt(gx * gx + gy * gy) / divider
    return g, torch.mean(g)


def _poisson_neumann(f):
    """Solve lap(U) = f with Neumann boundaries by an even-symmetric
    extension and rfft2."""
    h, w = f.shape
    ext = torch.cat([f, torch.flip(f, (0,))], dim=0)
    ext = torch.cat([ext, torch.flip(ext, (1,))], dim=1)
    spec = torch.fft.rfft2(ext)
    ky = torch.arange(2 * h, device=f.device, dtype=f.dtype)
    kx = torch.arange(spec.shape[1], device=f.device, dtype=f.dtype)
    eig = (2.0 * torch.cos(math.pi * ky / h)[:, None]
           + 2.0 * torch.cos(math.pi * kx / w)[None, :] - 4.0)
    eig[0, 0] = 1.0
    u = spec / eig
    u[0, 0] = 0.0
    return torch.fft.irfft2(u, s=ext.shape)[:h, :w]


def _repeat2(x, s):
    return x.repeat_interleave(s, 0).repeat_interleave(s, 1)


def apply(rgb, data, static):
    lw = data["lum_w"]
    h, w = rgb.shape[1:]
    y = torch.clamp(lw[0] * rgb[0] + lw[1] * rgb[1] + lw[2] * rgb[2],
                    min=1.0)

    # median prefilter on deep shadows (luminance_noise_floor = 65.535);
    # the stencil grows with the image (tmo_fattal02.cc:1104-1116)
    r_cap = max(h, w) / float(DIM_CAP)
    pts = (_MED_7X7 if r_cap >= 3 else
           _MED_5X5 if r_cap >= 2 else
           _MED_5X5_SOFT if r_cap >= 1 else _MED_3X3)
    y = torch.where(y < 65.535, _median_pts(y, pts), y)

    hh = torch.log(y + 1e-4)

    # the attenuation at most DIM_CAP wide
    ds = max(1, int(np.ceil(max(h, w) / DIM_CAP)))
    pyr = [hh[::ds, ::ds]]
    for k in range(1, NLEVELS):
        if min(pyr[-1].shape) < 8:
            break
        pyr.append(_blur5(pyr[-1])[::2, ::2])
    grads = [_gradients(p, k) for k, p in enumerate(pyr)]

    # FI attenuation (calculateFiMatrix)
    nl = len(pyr)
    fi = torch.ones_like(pyr[-1])
    alpha, beta, noise = data["alpha"], data["beta"], data["noise"]
    for k in range(nl - 1, -1, -1):
        g, avg = grads[k]
        if k >= DETAIL_LEVEL or k == nl - 1:
            a = alpha * avg
            grad = torch.clamp(g, min=1e-4)
            fi = fi * torch.pow((grad + noise) / torch.clamp(a, min=1e-9),
                                beta - 1.0)
        if k > 0:
            th, tw = pyr[k - 1].shape
            fi = _blur5(_repeat2(fi, 2)[:th, :tw])
    if ds > 1:
        fi = _repeat2(fi, ds)[:h, :w]

    # attenuated gradients and divergence (forward differences, the last
    # row and column reflected)
    def right(a):
        return torch.cat([a[:, 1:], a[:, -2:-1]], dim=1)

    def down(a):
        return torch.cat([a[1:], a[-2:-1]], dim=0)

    gx = (right(hh) - hh) * 0.5 * (right(fi) + fi)
    gy = (down(hh) - hh) * 0.5 * (down(fi) + fi)
    div = gx + gy
    div = div - torch.cat([-gx[:, :1], gx[:, :-1]], dim=1)
    div = div - torch.cat([-gy[:1], gy[:-1]], dim=0)

    lum = torch.exp(_poisson_neumann(div))

    # median-matched rescale on a ~200 px nearest subsample
    sy, sx = max(1, h // 200), max(1, w // 200)
    y_small = torch.sort(y[::sy, ::sx].reshape(-1)).values
    l_small = torch.sort(lum[::sy, ::sx].reshape(-1)).values
    n = y_small.shape[0]
    old_med, new_med = y_small[n // 2], l_small[n // 2]
    scale = torch.where((old_med > 0) & (new_med > 0), old_med / new_med,
                        65535.0)
    ratio = torch.clamp(lum, min=1e-4) * scale / torch.clamp(y, min=1e-4)
    return rgb * ratio[None]
