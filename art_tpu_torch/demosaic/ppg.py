"""PPG demosaic (counterpart of ``art_tpu/demosaic/ppg.py``;
demosaic_algos.cc:51 ppg_demosaic, Patterned Pixel Grouping).

The reference's whole-plane formulation in plain PyTorch, in floats as
there (no integer truncation of the guesses): green at R/B sites by the
direction of the smaller weighted gradient, clamped by a median to that
direction's greens; R/B at G sites by colour differences along the row
or column; the opposite colour by the diagonal of the smaller gradient
(their mean on a tie). The outer 4-pixel ring takes the bilinear result.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.image import bayer_channel_masks, shifts
from art_tpu_torch.demosaic.ahd import median3, rg_rows
from art_tpu_torch.demosaic.bilinear import bilinear_ring

BORDER = 4


def ppg_demosaic(cfa, pattern, **kw):
    """(H, W) mosaic in 0..65535 -> (3, H, W) RGB on cfa's device."""
    x = torch.clamp(cfa, min=0.0)
    mr, mg, mb = bayer_channel_masks(pattern, x.shape, x.device)
    rg_row = rg_rows(mr)
    s = shifts(x, 3)
    a = torch.abs

    # phase 1: green at R/B sites
    guess_h = (s(0, -1) + s(0, 0) + s(0, 1)) * 2.0 - s(0, -2) - s(0, 2)
    guess_v = (s(-1, 0) + s(0, 0) + s(1, 0)) * 2.0 - s(-2, 0) - s(2, 0)
    diff_h = (a(s(0, -2) - s(0, 0)) + a(s(0, 2) - s(0, 0))
              + a(s(0, -1) - s(0, 1))) * 3.0 \
        + (a(s(0, 3) - s(0, 1)) + a(s(0, -3) - s(0, -1))) * 2.0
    diff_v = (a(s(-2, 0) - s(0, 0)) + a(s(2, 0) - s(0, 0))
              + a(s(-1, 0) - s(1, 0))) * 3.0 \
        + (a(s(3, 0) - s(1, 0)) + a(s(-3, 0) - s(-1, 0))) * 2.0
    gh = median3(guess_h * 0.25, s(0, 1), s(0, -1))
    gv = median3(guess_v * 0.25, s(1, 0), s(-1, 0))
    g = torch.where(mg, x, torch.where(diff_h > diff_v, gv, gh))
    sg = shifts(g, 3)

    # phase 2: R/B at green sites along the axis where the colour sits
    horiz = torch.clamp(0.5 * (s(0, -1) + s(0, 1) + 2.0 * g
                               - sg(0, -1) - sg(0, 1)), 0.0, 65535.0)
    vert = torch.clamp(0.5 * (s(-1, 0) + s(1, 0) + 2.0 * g
                              - sg(-1, 0) - sg(1, 0)), 0.0, 65535.0)
    r_at_g = torch.where(rg_row, horiz, vert)
    b_at_g = torch.where(rg_row, vert, horiz)

    # phase 3: the opposite colour at R/B sites, two diagonals compete
    def diag(dy, dx):
        dd = a(s(-dy, -dx) - s(dy, dx)) + a(sg(-dy, -dx) - g) \
            + a(sg(dy, dx) - g)
        gg = s(-dy, -dx) + s(dy, dx) + 2.0 * g - sg(-dy, -dx) - sg(dy, dx)
        return dd, gg

    d0, g0 = diag(1, 1)
    d1, g1 = diag(1, -1)
    opp = torch.clamp(torch.where(d0 < d1, g0 * 0.5, torch.where(
        d0 > d1, g1 * 0.5, (g0 + g1) * 0.25)), 0.0, 65535.0)

    r = torch.where(mr, x, torch.where(mg, r_at_g, opp))
    b = torch.where(mb, x, torch.where(mg, b_at_g, opp))
    rgb = torch.stack([r, torch.clamp(g, min=0.0), b])
    return bilinear_ring(rgb, cfa, pattern, BORDER)
