"""Lanczos-3 resize (counterpart of ``art_tpu/ops/resize.py``;
ipresize.cc).

The reference's separable Lanczos as two dense products, out = A_r @ img
@ A_c^T, with the interpolation matrices built on the host in float64
and stored as float32. `apply_resize` multiplies with `torch.matmul` in
full float32 (TF32 stays off, `art_tpu_torch/__init__.py`).
"""

from __future__ import annotations

import numpy as np
import torch

_A = 3  # Lanczos support


def lanczos_matrix(n_in, n_out):
    """(n_out, n_in) row-stochastic Lanczos-3 resampling matrix
    (resize.py::lanczos_matrix): each row's taps normalised to sum 1,
    taps beyond the edges folded onto the edge samples."""
    scale = n_out / n_in
    support = _A / min(scale, 1.0)
    x_out = np.arange(n_out)
    src = (x_out + 0.5) / scale - 0.5
    A = np.zeros((n_out, n_in), dtype=np.float64)
    kscale = min(scale, 1.0)
    for i, c in enumerate(src):
        lo = int(np.floor(c - support))
        hi = int(np.ceil(c + support))
        idx = np.arange(lo, hi + 1)
        t = (idx - c) * kscale
        w = np.sinc(t) * np.sinc(t / _A)
        w[np.abs(t) >= _A] = 0.0
        idxc = np.clip(idx, 0, n_in - 1)
        s = w.sum()
        if s != 0:
            w /= s
        for j, wt in zip(idxc, w):
            A[i, j] += wt
    return A.astype(np.float32)


def resize_plan(in_shape, out_shape):
    """(A_rows, A_cols) for (H, W) -> (H', W')."""
    h, w = in_shape
    oh, ow = out_shape
    return lanczos_matrix(h, oh), lanczos_matrix(w, ow)


def apply_resize(rgb, a_rows, a_cols):
    """(C, H, W) -> (C, H', W'): A_rows @ rgb, then @ A_cols^T."""
    tmp = torch.matmul(a_rows, rgb)
    return torch.matmul(tmp, a_cols.transpose(0, 1))
