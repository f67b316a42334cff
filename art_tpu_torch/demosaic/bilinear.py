"""Bilinear Bayer demosaic (counterpart of ``art_tpu/demosaic/bilinear.py``).

Each output plane is a 3x3 normalised sum of the masked mosaic over a
reflect-padded plane; samples keep their own value at their own sites.
Plain PyTorch: the reference has no Pallas kernel here.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.image import bayer_channel_masks

_K_RB = {  # [[1,2,1],[2,4,2],[1,2,1]] / 4
    (-1, -1): 0.25, (-1, 0): 0.5, (-1, 1): 0.25,
    (0, -1): 0.5, (0, 0): 1.0, (0, 1): 0.5,
    (1, -1): 0.25, (1, 0): 0.5, (1, 1): 0.25,
}
_K_G = {  # [[0,1,0],[1,4,1],[0,1,0]] / 4
    (-1, 0): 0.25, (0, -1): 0.25, (0, 0): 1.0, (0, 1): 0.25, (1, 0): 0.25,
}


def _shift_sum(x, weights):
    p = torch.nn.functional.pad(x[None, None], (1, 1, 1, 1),
                                mode="reflect")[0, 0]
    h, w = x.shape
    out = None
    for (dy, dx), wgt in weights.items():
        piece = p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] * wgt
        out = piece if out is None else out + piece
    return out


def bilinear_ring(rgb, cfa, pattern, border):
    """rgb with its outer `border`-pixel ring replaced by the bilinear
    result of cfa (the reference's border interpolation of RCD, DCB,
    AHD, EAHD, HPHD, PPG and JDL)."""
    h, w = cfa.shape
    ri = torch.arange(h, device=cfa.device)[:, None]
    ci = torch.arange(w, device=cfa.device)[None, :]
    ring = ((ri < border) | (ri >= h - border)
            | (ci < border) | (ci >= w - border))
    return torch.where(ring[None], bayer_bilinear(cfa, pattern), rgb)


def bayer_bilinear(cfa, pattern):
    """(H, W) mosaic -> (3, H, W) RGB, same 0..65535 domain."""
    mr, mg, mb = bayer_channel_masks(pattern, cfa.shape, cfa.device)
    zero = torch.zeros((), dtype=cfa.dtype, device=cfa.device)
    r = _shift_sum(torch.where(mr, cfa, zero), _K_RB)
    g = _shift_sum(torch.where(mg, cfa, zero), _K_G)
    b = _shift_sum(torch.where(mb, cfa, zero), _K_RB)
    return torch.stack([torch.where(mr, cfa, r), torch.where(mg, cfa, g),
                        torch.where(mb, cfa, b)])
