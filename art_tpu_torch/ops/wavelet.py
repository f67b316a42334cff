"""Undecimated (à trous) wavelet decomposition (counterpart of
``art_tpu/ops/wavelet.py:22-58``; rtengine/cplx_wavelet_dec.cc).

The plain chain that local contrast runs: each level a separable B3-spline
blur with taps 2^level apart over reflect pads, summed in tap order as in
the reference. This is not kernel B4's fused chain.
"""

from __future__ import annotations

import numpy as np
import torch

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
