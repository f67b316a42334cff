"""Hot/dead pixel detection and CFA-aware interpolation (counterpart of
``art_tpu/raw/badpixels.py``; rtengine/badpixels.cc findHotDeadPixels:477,
interpolateBadPixelsBayer:66).

Plain PyTorch on (H, W) float32 planes. The bad-pixel decision
`absdev > varthresh * hfnbrave` compares against a 25-term sum, so the sum
runs in the reference's order (dy outer, dx inner, from zero) and the two
packages round it alike.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.image import shifts


def find_hot_dead(cfa, thresh, find_hot=True, find_dead=True,
                  is_xtrans=False):
    """Boolean bad-pixel mask (findHotDeadPixels semantics)."""
    varthresh = (20.0 * (thresh / 100.0) + 1.0) / 24.0
    if is_xtrans:
        varthresh *= 0.25
    sh = shifts(cfa, 3)
    # median of the 9 same-colour samples on the step-2 5x5 grid
    neigh = torch.stack([sh(dy, dx) for dy in (-2, 0, 2)
                         for dx in (-2, 0, 2)])
    med = torch.median(neigh, dim=0).values
    del neigh
    dev = cfa - med
    absdev = torch.abs(dev)
    # 5x5 sum of |dev| minus the centre
    sa = shifts(absdev, 2, mode="constant")
    nb = torch.zeros_like(cfa)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            nb = nb + sa(dy, dx)
    hfnbrave = nb - 2.0 * absdev  # the reference starts at -pixdev
    bad = absdev > varthresh * hfnbrave
    if not find_dead:
        bad = bad & (dev > 0)
    if not find_hot:
        bad = bad & (dev < 0)
    return bad


def interpolate_bad_bayer(cfa, bad, mg):
    """interpolateBadPixelsBayer: gradient-weighted pair averages, with the
    plain mean of the good step-2 neighbours where no pair is good."""
    eps = 1.0
    good = 1.0 - bad.to(cfa.dtype)
    sx, sg = shifts(cfa, 3), shifts(good, 3)

    def add_pair(dy, dx, weight):
        a = sx(dy, dx)
        b = sx(-dy, -dx)
        ok = sg(dy, dx) * sg(-dy, -dx)
        w = ok * weight / (torch.abs(a - b) + eps)
        return w * (a + b), w

    def pairs(offsets, weight, s=None, n=None):
        for dy, dx in offsets:
            ds, dn = add_pair(dy, dx, weight)
            s = ds if s is None else s + ds
            n = dn if n is None else n + dn
        return s, n

    # the reference sums each pair onto zeros; 0 + v is v
    sg_, ng = pairs(((-1, 1), (-1, -1)), 0.70710678)  # green diagonals
    sc, nc = pairs(((-2, 2), (-2, -2)), 0.35355339)  # R/B far diagonals
    wtdsum = torch.where(mg, sg_, sc)
    norm = torch.where(mg, ng, nc)
    # channel-independent H/V pairs
    wtdsum, norm = pairs(((0, 2), (2, 0)), 0.5, wtdsum, norm)

    interp = wtdsum / (2.0 * torch.clamp(norm, min=1e-12))
    fsum = torch.zeros_like(cfa)
    fcnt = torch.zeros_like(cfa)
    for dy in (-2, 0, 2):
        for dx in (-2, 0, 2):
            if dy == 0 and dx == 0:
                continue
            ok = sg(dy, dx)
            fsum = fsum + ok * sx(dy, dx)
            fcnt = fcnt + ok
    fallback = fsum / torch.clamp(fcnt, min=1.0)
    fixed = torch.where(norm > 0, interp, fallback)
    return torch.where(bad, fixed, cfa)
