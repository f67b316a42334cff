"""Pixel-shift 4-frame combine (counterpart of
``art_tpu/demosaic/pixelshift.py``; pixelshift.cc:298).

Pentax and Sony pixel-shift bodies record 4 frames with the sensor
displaced by one photosite between them, so every site is sampled by R,
B and two Gs: each channel comes from the frame whose displaced CFA
colour lands there and the two greens are averaged. Where the two greens
differ beyond the noise model (a normalised difference test, dilated
3x3: the reference's simplification of pixelshift.cc's statistics) the
scene moved, and the site takes a demosaic of frame 0 instead, AMaZE at
gain 1 by default, as there. Frame offsets: (0,0), (0,1), (1,1), (1,0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from art_tpu_torch.core.image import bayer_channel_masks

OFFSETS = ((0, 0), (0, 1), (1, 1), (1, 0))


def shifted_masks(pattern, shape, device, dy, dx):
    """The channel masks of the CFA as a frame displaced by (dy, dx) sees
    it."""
    return tuple(torch.roll(m, (-dy, -dx), dims=(0, 1))
                 for m in bayer_channel_masks(pattern, shape, device))


def motion_mask(g_min, g_max, sigma_factor):
    """Where the two greens disagree beyond sigma_factor of their sum plus
    16, dilated by a 3x3 OR (False outside the plane)."""
    denom = torch.clamp(g_max + g_min, min=1.0)
    motion = (g_max - g_min) > sigma_factor * denom + 16.0
    return F.max_pool2d(motion[None, None].to(g_min.dtype), 3, 1,
                        1)[0, 0] > 0


def pixelshift_combine(frames, pattern, motion_detect=True,
                       sigma_factor=0.08, demosaic_method="amaze",
                       **dem_kwargs):
    """frames: (4, H, W) scaled mosaics -> (3, H, W) RGB on their
    device."""
    from art_tpu_torch.demosaic import demosaic

    f = torch.clamp(frames, min=0.0)
    _, h, w = f.shape
    r = torch.zeros((h, w), dtype=f.dtype, device=f.device)
    b = torch.zeros_like(r)
    g_sum = torch.zeros_like(r)
    g_min = torch.full_like(r, float("inf"))
    g_max = torch.full_like(r, float("-inf"))
    for k, (dy, dx) in enumerate(OFFSETS):
        mr, mg, mb = shifted_masks(pattern, (h, w), f.device, dy, dx)
        r = torch.where(mr, f[k], r)
        b = torch.where(mb, f[k], b)
        g_sum = g_sum + torch.where(mg, f[k], 0.0)
        g_min = torch.where(mg, torch.minimum(g_min, f[k]), g_min)
        g_max = torch.where(mg, torch.maximum(g_max, f[k]), g_max)
    out = torch.stack([r, 0.5 * g_sum, b])
    if not motion_detect:
        return out
    motion = motion_mask(g_min, g_max, sigma_factor)
    fallback = demosaic(f[0], pattern, demosaic_method,
                        dem_kwargs=tuple(dem_kwargs.items()))
    return torch.where(motion[None], fallback, out)
