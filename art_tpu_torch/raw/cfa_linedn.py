"""CFA line (banding) noise removal (counterpart of
``art_tpu/raw/cfa_linedn.py``; reference: cfa_linedn_RT.cc).

Row/column pattern noise on the mosaic: per Bayer site's subplane (a
strided view), the per-line offset is the mean of the high-pass residual
(the subplane less its gaussian blur of sigma 3) clipped at twice the
noise amplitude, itself clipped to the amplitude, and subtracted.
Direction follows LineDenoiseDirection (1 horizontal, 2 vertical, 3
both). Plain PyTorch; the line means reduce in float64, the same on
every device.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.fmath import mean32
from art_tpu_torch.ops.filters import gauss_blur


def _deband_axis(x, amount, axis):
    resid = x - gauss_blur(x, 3.0)
    # robust per-line offset: mean of residuals clipped at 2*amount
    clipped = torch.clamp(resid, -2.0 * amount, 2.0 * amount)
    line = mean32(clipped, axis, keepdim=True)
    return x - torch.clamp(line, -amount, amount)


def cfa_line_denoise(cfa, amount, direction=3):
    """amount: LineDenoise slider (0..100) scaled to the 65535 domain;
    cfa: (H, W) with H and W even."""
    amp = amount / 100.0 * 65535.0 * 0.02  # max ~2% banding amplitude
    out = torch.empty_like(cfa)
    for py in (0, 1):
        for px in (0, 1):
            sub = cfa[py::2, px::2]
            if direction & 1:  # horizontal banding -> per-row offsets
                sub = _deband_axis(sub, amp, axis=1)
            if direction & 2:  # vertical banding -> per-column offsets
                sub = _deband_axis(sub, amp, axis=0)
            out[py::2, px::2] = sub
    return out
