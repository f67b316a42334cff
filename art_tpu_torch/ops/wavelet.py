"""Undecimated (à trous) wavelet decomposition and shrink (counterpart of
``art_tpu/ops/wavelet.py``; rtengine/cplx_wavelet_dec.cc).

The plain chain that local contrast runs, and the whole-plane denoise
below one kernel tile: each level a separable B3-spline blur with taps
2^level apart over reflect pads, summed in tap order as in the
reference; the global MAD sigma (`mad_sigma`) and the energy shrink
(`shrink_sure_like`). This is not kernels B4/B5's fused chain.
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.core.fmath import fdiv

# B3-spline kernel, the classic à trous choice
_B3 = np.array([1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16], dtype=np.float32)


def _reflect_index(n, r, device):
    """Indices of a reflect pad of `r` on each side of an axis of n
    (numpy's "reflect", also where r >= n: the reflection repeats)."""
    i = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _sep_blur(x, kernel, spacing):
    """Separable convolution with dilated taps, reflect borders."""
    r = (len(kernel) - 1) // 2 * spacing

    def conv_axis(a, axis):
        n = a.shape[axis]
        p = a.index_select(axis, _reflect_index(n, r, a.device))
        out = None
        for i, w in enumerate(kernel):
            piece = p.narrow(axis, i * spacing, n) * float(w)
            out = piece if out is None else out + piece
        return out

    return conv_axis(conv_axis(x, 0), 1)


def atrous_decompose(x, levels):
    """x -> ([detail_0 .. detail_{n-1}], residual) with B3 à trous."""
    details = []
    cur = x
    for lv in range(levels):
        smooth = _sep_blur(cur, _B3, 2 ** lv)
        details.append(cur - smooth)
        cur = smooth
    return details, cur


def atrous_reconstruct(details, residual):
    out = residual
    for d in details:
        out = out + d
    return out


def mad_sigma(detail):
    """Noise sigma: the median of |detail| over every 8th row and column,
    found by 24 bisection steps, / 0.6745 (wavelet.py::mad_sigma)."""
    sub = torch.abs(detail[::8, ::8] if detail.ndim == 2 else detail)
    lo = torch.zeros((), dtype=sub.dtype, device=sub.device)
    hi = sub.amax()
    half = 0.5 * sub.numel()
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        upper = (sub <= mid).sum() >= half
        lo, hi = torch.where(upper, lo, mid), torch.where(upper, mid, hi)
    return fdiv(0.5 * (lo + hi), 0.6745)


def shrink_sure_like(d, sigma, strength):
    """Attenuate each coefficient by e / (e + (strength * sigma)^2), e the
    3x3 mean of d^2 over reflect pads (wavelet.py::shrink_sure_like)."""
    t2 = (strength * sigma) ** 2
    h, w = d.shape
    dd = d * d
    p = dd.index_select(0, _reflect_index(h, 1, d.device)).index_select(
        1, _reflect_index(w, 1, d.device))
    e = None
    for dy in range(3):
        for dx in range(3):
            t = p[dy : dy + h, dx : dx + w]
            e = t if e is None else e + t
    e = fdiv(e, 9.0)
    return d * (e / (e + t2 + 1e-12))
