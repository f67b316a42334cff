"""Highlight reconstruction, Color (counterpart of
``art_tpu/raw/hilite_inpaint.py``; hilite_recon.cc HLRecovery_inpaint).

The reference's formulation, which stands in for ART's directional
scans: unclipped colour diffuses into blown regions on an 8x-downscaled
grid (64 masked Jacobi steps of 3x3 normalised box sums), the filled
field is upsampled bilinearly, and each clipped channel takes the field
times a per-pixel least-squares gain against the pixel's unclipped
channels (the luminance ratio, at least 1, where all three clip). Same
domain and arguments as `raw.hilite.recover_opposed`. Plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from art_tpu_torch.raw.hilite import _scale_and_clips

_FACTOR = 8
_ITERS = 64
_EPS = 1e-6


def _box3(x):
    """3x3 box sum of each plane of (C, h, w), zero outside."""
    p = F.pad(x, (1, 1, 1, 1))
    _, h, w = x.shape
    s = None
    for dy in range(3):
        for dx in range(3):
            t = p[:, dy : dy + h, dx : dx + w]
            s = t if s is None else s + t
    return s


def _downscale(x, f):
    """Box mean over f x f blocks of (C, H, W), H and W multiples of f."""
    c, h, w = x.shape
    return x.reshape(c, h // f, f, w // f, f).mean(dim=(2, 4))


def recover_inpaint(rgb, scale_mul3, wb_cam3):
    """Inpaint-reconstruct clipped highlights of the (3, H, W) demosaiced
    planes before the multipliers."""
    scalecoeffs, clips = _scale_and_clips(scale_mul3, wb_cam3)
    x = torch.clamp(rgb * scalecoeffs[:, None, None], min=0.0)
    c, h, w = x.shape
    f = _FACTOR
    ph, pw = (-h) % f, (-w) % f
    xp = F.pad(x[None], (0, pw, 0, ph), mode="replicate")[0]

    clipped = x >= clips[:, None, None]
    any_clip = clipped.any(dim=0).to(x.dtype)

    # the coarse grid fill
    ds = _downscale(xp, f)
    m = _downscale(F.pad(any_clip[None, None], (0, pw, 0, ph),
                         mode="replicate")[0], f)[0]
    known = (m < 0.02).to(x.dtype)
    u = ds * known[None]
    wgt = known
    for _ in range(_ITERS):
        us = _box3(u)
        ws = _box3(wgt[None])[0]
        fill = us / torch.clamp(ws, min=_EPS)[None]
        have = (ws > _EPS).to(u.dtype)
        u = torch.where(known[None] > 0, ds,
                        torch.where(wgt[None] > 0, u, fill * have[None]))
        wgt = torch.maximum(wgt, have * (1.0 - known) * (ws > _EPS))

    # the filled field at full resolution (half-pixel bilinear, edges
    # clamped: jax.image.resize's weights for an upscale)
    fr = F.interpolate(u[None], size=(h + ph, w + pw), mode="bilinear",
                       align_corners=False)[0, :, :h, :w]
    fr = torch.clamp(fr, min=_EPS)

    unc = (~clipped).to(x.dtype)
    num = (unc * x * fr).sum(dim=0)
    den = (unc * fr * fr).sum(dim=0)
    s_ls = num / torch.clamp(den, min=_EPS)
    lum_x = x.mean(dim=0)
    lum_f = fr.mean(dim=0)
    s_lum = torch.clamp(lum_x / torch.clamp(lum_f, min=_EPS), min=1.0)
    n_unc = unc.sum(dim=0)
    s = torch.where(n_unc > 0, s_ls, s_lum)

    cand = s[None] * fr
    out = torch.where(clipped, torch.maximum(x, cand), x)
    return out / scalecoeffs[:, None, None]
