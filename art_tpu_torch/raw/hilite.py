"""Highlight reconstruction, ColorSoft and Blend (counterpart of
``art_tpu/raw/hilite.py``; hilite_recon.cc).

- `recover_opposed` (HLRecovery=ColorSoft): clipped channels take the
  cube of the mean cube roots of the other two channels' 3x3 means, plus
  a global chrominance offset over the near-clip pixels of the dilated
  clip mask; after the demosaic, before the WB multipliers.
- `recover_blend` (HLRecovery=Blend): where a channel nears its clip
  level, blend toward the pixel's channel mean; after the multipliers.

Whole-plane plain PyTorch on the (3, H, W) planes the pipeline carries
(the padded plane: the global sums run over the pad too, as in the
reference).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from art_tpu_torch.core.fmath import cbrt, fdiv


def _box3_mean3(x3):
    """3x3 box mean of each plane of a (3, H, W) stack, edges clamped."""
    p = F.pad(torch.clamp(x3, min=0.0)[None], (1, 1, 1, 1),
              mode="replicate")[0]
    _, h, w = x3.shape
    s = None
    for dy in range(3):
        for dx in range(3):
            t = p[:, dy : dy + h, dx : dx + w]
            s = t if s is None else s + t
    return fdiv(s, 9.0)


def _dilate3(m3):
    """3x3 dilation of each plane of a (3, H, W) boolean stack."""
    return F.max_pool2d(m3.to(torch.float32)[None], 3, 1, 1)[0] > 0


def _cbrt0(x):
    """Cube root of a tensor >= 0 (0 at 0)."""
    pos = x > 0
    return torch.where(pos, cbrt(torch.where(pos, x, 1.0)), 0.0)


def _scale_and_clips(scale_mul3, wb_cam3):
    """recover_opposed's per-channel scale to [0, 1] and clip levels."""
    gain = 1.2
    clipval = 0.987 / gain
    scalecoeffs = fdiv(scale_mul3 * wb_cam3, 65535.0)
    return scalecoeffs, clipval * wb_cam3


def recover_opposed(rgb, scale_mul3, wb_cam3):
    """rgb: the (3, H, W) demosaiced planes before the multipliers;
    scale_mul3: the per-channel scale_mul; wb_cam3: the white balance's
    camera-space multipliers (`raw.wb.wb_camera_multipliers`)."""
    scalecoeffs, clips = _scale_and_clips(scale_mul3, wb_cam3)
    clipdark = torch.stack([0.03 * clips[0], 0.125 * clips[1],
                            0.03 * clips[2]])
    x = rgb * scalecoeffs[:, None, None]

    croot = _cbrt0(torch.clamp(_box3_mean3(x), min=0.0))
    croot_refavg = torch.stack([
        0.5 * (croot[1] + croot[2]),
        0.5 * (croot[0] + croot[2]),
        0.5 * (croot[0] + croot[1]),
    ])
    est = croot_refavg * croot_refavg * croot_refavg

    clipped = x >= clips[:, None, None]
    mask = _dilate3(clipped)

    # global chrominance offset from near-clip pixels inside the mask
    inval = torch.clamp(x, min=0.0)
    sel = mask & (inval > clipdark[:, None, None]) & (
        inval < clips[:, None, None])
    cr_sum = torch.where(sel, inval - est, 0.0).sum(dim=(1, 2))
    cr_cnt = torch.clamp(sel.sum(dim=(1, 2)), min=1).to(torch.float32)
    chrom = cr_sum / cr_cnt

    recovered = torch.maximum(inval, est + chrom[:, None, None])
    out = torch.where(clipped, recovered, x)
    return out / scalecoeffs[:, None, None]


def recover_blend(rgb, hlmax3):
    """Blend (HLRecovery_blend, whole-plane): past 3/4 of a channel's clip
    level, push the pixel toward its channel mean."""
    clip = torch.clamp(hlmax3, max=65535.0)
    frac = torch.clamp((rgb - 0.75 * clip[:, None, None])
                       / (0.25 * clip[:, None, None]), 0.0, 1.0)
    anyclip = frac.amax(dim=0)
    lum = rgb.mean(dim=0)
    blended = rgb * (1 - anyclip[None]) + lum[None] * anyclip[None]
    return torch.where(anyclip[None] > 0, blended, rgb)
