"""Box, gaussian and guided filters on (H, W) float32 planes (counterpart
of ``art_tpu/ops/filters.py``: boxblur.h, gauss.cc, guidedfilter.cc).

Plain PyTorch, in the reference's formulations, whose rounding the
outputs carry: the box mean is a difference of prefix sums with clamped
ends and counts (no convolution, which would also bring cuDNN's TF32);
the gaussian is separable shift-multiply-adds over reflect pads, taps
summed in order from -r to +r.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def box_blur(x, radius):
    """Mean over a (2r+1)^2 window, edge-clamped counts (2-D plane)."""
    if radius <= 0:
        return x
    r = int(radius)

    def blur_axis(a, axis):
        n = a.shape[axis]
        c = torch.cumsum(a, dim=axis)
        c = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)), c], dim=axis)
        i = torch.arange(n, device=a.device)
        hi = torch.clamp(i + r + 1, 0, n)
        lo = torch.clamp(i - r, 0, n)
        s = c.index_select(axis, hi) - c.index_select(axis, lo)
        shape = [1, 1]
        shape[axis] = n
        return s / (hi - lo).to(a.dtype).reshape(shape)

    return blur_axis(blur_axis(x, 0), 1)


def _gauss_kernel(sigma):
    r = max(1, int(np.ceil(3.0 * sigma)))
    xs = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _taps(p, k, n, dim):
    """sum_i k[i] * p[i : i + n] along dim, in tap order."""
    out = None
    for i, kv in enumerate(k):
        term = float(kv) * p.narrow(dim, i, n)
        out = term if out is None else out + term
    return out


def gauss_blur(x, sigma):
    """Separable gaussian of a 2-D plane (gauss.cc semantics)."""
    if sigma <= 0.1:
        return x
    k = _gauss_kernel(float(sigma))
    r = (len(k) - 1) // 2
    h, w = x.shape
    xp = F.pad(x[None, None], (0, 0, r, r), mode="reflect")[0, 0]
    col = _taps(xp, k, h, 0)
    cp = F.pad(col[None, None], (r, r, 0, 0), mode="reflect")[0, 0]
    return _taps(cp, k, w, 1)


def guided_filter(guide, src, radius, eps):
    """He et al. guided filter (guidedfilter.cc); guide, src: (H, W)."""
    if radius <= 0:
        return src
    mean_i = box_blur(guide, radius)
    mean_p = box_blur(src, radius)
    mean_ip = box_blur(guide * src, radius)
    mean_ii = box_blur(guide * guide, radius)
    cov_ip = mean_ip - mean_i * mean_p
    var_i = mean_ii - mean_i * mean_i
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return box_blur(a, radius) * guide + box_blur(b, radius)
