"""EAHD demosaic (counterpart of ``art_tpu/demosaic/eahd.py``;
eahd_demosaic.cc, AHD with a 3x3 Lab homogeneity vote).

The reference's formulation in plain PyTorch: the vote compares Lab
distances over the whole 3x3 neighbourhood, the thresholds come from the
horizontal map's left/right and the vertical map's up/down, each vote is
spread over its 3x3 neighbourhood; the reference's row-sequential
fixation becomes its two-pass fixed point (a vote, then a re-vote with
the causal neighbours fixed to the first vote's winner). R/B per
direction follow interpolate_row_rb, the final ones
interpolate_row_rb_mul_pp. The outer 4-pixel ring takes the bilinear
result.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.image import bayer_channel_masks, shifts
from art_tpu_torch.demosaic.ahd import green_candidates, rg_rows, to_lab
from art_tpu_torch.demosaic.bilinear import bilinear_ring

BORDER = 4

# the 3x3 neighbourhood in the reference's order: rows i-1, i, i+1
OFFS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1),
        (1, -1), (1, 0), (1, 1))
CAUSAL = (0, 1, 2, 3)  # positions whose direction is already decided


def chroma_rb(x, g, mr, mb, rg_row):
    """R and B from one green plane (interpolate_row_rb): the site's own
    colour kept, the cross colour from the 4 diagonals, the colours at G
    sites by linear chroma interpolation; unclipped."""
    sg = shifts(g, 1)
    sx = shifts(x, 1)
    cross = g + 0.25 * (sx(-1, -1) - sg(-1, -1) + sx(-1, 1) - sg(-1, 1)
                        + sx(1, -1) - sg(1, -1) + sx(1, 1) - sg(1, 1))
    horiz = g + 0.5 * (sx(0, -1) - sg(0, -1) + sx(0, 1) - sg(0, 1))
    vert = g + 0.5 * (sx(-1, 0) - sg(-1, 0) + sx(1, 0) - sg(1, 0))
    r = torch.where(mr, x, torch.where(mb, cross,
                                       torch.where(rg_row, horiz, vert)))
    b = torch.where(mb, x, torch.where(mr, cross,
                                       torch.where(rg_row, vert, horiz)))
    return r, b


def vote(labs, fix=None):
    """The homogeneity maps (hom_h, hom_v) of the two directional Lab
    stacks; `fix` (+1 horizontal, -1 vertical, 0 open) fixes the Lab the
    causal positions compare against."""
    (lh, ah, bh), (lv, av, bv) = labs
    sh = [shifts(p, 1) for p in (lh, ah, bh)]
    sv = [shifts(p, 1) for p in (lv, av, bv)]
    sfix = shifts(fix, 1) if fix is not None else None
    dh, dv = [], []
    for k, (dy, dx) in enumerate(OFFS):
        nbh = [s(dy, dx) for s in sh]
        nbv = [s(dy, dx) for s in sv]
        if sfix is not None and k in CAUSAL:
            f = sfix(dy, dx)
            nb_h = [torch.where(f != 0, torch.where(f > 0, h, v), h)
                    for h, v in zip(nbh, nbv)]
            nb_v = [torch.where(f != 0, torch.where(f > 0, h, v), v)
                    for h, v in zip(nbh, nbv)]
        else:
            nb_h, nb_v = nbh, nbv
        dh.append(tuple(torch.abs(c - n) for c, n in zip((lh, ah, bh),
                                                         nb_h)))
        dv.append(tuple(torch.abs(c - n) for c, n in zip((lv, av, bv),
                                                         nb_v)))
    # the thresholds: horizontal left/right against vertical up/down
    e = [torch.minimum(torch.maximum(dh[3][c], dh[5][c]),
                       torch.maximum(dv[1][c], dv[7][c])) for c in range(3)]

    def count(ds):
        return sum(((d[0] <= e[0]) & (d[1] <= e[1]) & (d[2] <= e[2])).to(
            torch.float32) for d in ds)

    def box9(p):
        sp = shifts(p, 1)
        return sum(sp(dy, dx) for dy, dx in OFFS)

    return box9(count(dh)), box9(count(dv))


def eahd_demosaic(cfa, pattern, **kw):
    """(H, W) mosaic in 0..65535 -> (3, H, W) RGB on cfa's device."""
    x = torch.clamp(cfa, min=0.0)
    mr, mg, mb = bayer_channel_masks(pattern, x.shape, x.device)
    rg_row = rg_rows(mr)
    gh, gv = green_candidates(x, mg)
    rh, bh = (torch.clamp(p, 0.0, 65535.0)
              for p in chroma_rb(x, gh, mr, mb, rg_row))
    rv, bv = (torch.clamp(p, 0.0, 65535.0)
              for p in chroma_rb(x, gv, mr, mb, rg_row))
    labs = [to_lab(rh, gh, bh), to_lab(rv, gv, bv)]

    hom_h, hom_v = vote(labs)
    hom_h, hom_v = vote(labs, fix=torch.sign(hom_h - hom_v))
    g = torch.where(mg, x, torch.where(hom_h > hom_v, gh, torch.where(
        hom_h < hom_v, gv, 0.5 * (gh + gv))))
    g = torch.clamp(g, min=0.0)

    # the final R/B from the decided green (interpolate_row_rb_mul_pp)
    r, b = chroma_rb(x, g, mr, mb, rg_row)
    rgb = torch.stack([torch.clamp(r, min=0.0), g, torch.clamp(b, min=0.0)])
    return bilinear_ring(rgb, cfa, pattern, BORDER)
