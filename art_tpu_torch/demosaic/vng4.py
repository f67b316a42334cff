"""VNG4 Bayer demosaic (counterpart of ``art_tpu/demosaic/vng4.py``;
vng4_demosaic_RT.cc, Chang & Tan's variable number of gradients).

The reference's whole-plane formulation, in plain PyTorch: eight
directional gradients from same-colour pairs of the 5x5 neighbourhood,
the directions below T = 1.5 min + 0.5 (max - min) kept, and the centre
corrected by the mean colour difference of a bilinear prior at the kept
neighbours: out_c = v + sum_d w_d (B_c(p+d) - B_c0(p+d)) / sum_d w_d,
with c0 the centre's CFA colour (so c == c0 keeps the mosaic value).
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.fmath import rdiv
from art_tpu_torch.core.image import bayer_channel_masks, shifts
from art_tpu_torch.demosaic.bilinear import bayer_bilinear

# the eight neighbour directions, in the order of their gradients
DIRS = ((-1, 0), (1, 0), (0, 1), (0, -1), (-1, 1), (1, -1), (-1, -1), (1, 1))


def gradients(sh):
    """The 8 directional gradients (N, S, E, W, NE, SW, NW, SE) over a
    shifter of the mosaic; every |a - b| pairs same-colour sites."""
    a = torch.abs

    def card(f):
        # f maps (dy, dx) in the north frame to the actual offset
        return (a(sh(*f(-1, 0)) - sh(*f(1, 0)))
                + a(sh(*f(-2, 0)) - sh(*f(0, 0)))
                + 0.5 * (a(sh(*f(-1, -1)) - sh(*f(1, -1)))
                         + a(sh(*f(-1, 1)) - sh(*f(1, 1)))
                         + a(sh(*f(-2, -1)) - sh(*f(0, -1)))
                         + a(sh(*f(-2, 1)) - sh(*f(0, 1)))))

    def diag(f):
        return (a(sh(*f(-1, 1)) - sh(*f(1, -1)))
                + a(sh(*f(-2, 2)) - sh(*f(0, 0)))
                + 0.5 * (a(sh(*f(-2, 1)) - sh(*f(0, -1)))
                         + a(sh(*f(-1, 2)) - sh(*f(1, 0)))))

    return [card(lambda dy, dx: (dy, dx)), card(lambda dy, dx: (-dy, dx)),
            card(lambda dy, dx: (dx, -dy)), card(lambda dy, dx: (-dx, dy)),
            diag(lambda dy, dx: (dy, dx)), diag(lambda dy, dx: (-dy, -dx)),
            diag(lambda dy, dx: (dy, -dx)), diag(lambda dy, dx: (-dy, dx))]


def vng4_demosaic(cfa, pattern, **kw):
    """(H, W) mosaic in 0..65535 -> (3, H, W) RGB on cfa's device."""
    x = cfa
    mr, mg, mb = bayer_channel_masks(pattern, x.shape, x.device)
    grads = gradients(shifts(x, 2))
    gmin = grads[0]
    gmax = grads[0]
    for g in grads[1:]:
        gmin = torch.minimum(gmin, g)
        gmax = torch.maximum(gmax, g)
    thold = 1.5 * gmin + 0.5 * (gmax - gmin)

    prior = bayer_bilinear(x, pattern)
    shb = [shifts(prior[c], 1) for c in range(3)]
    n = torch.zeros_like(x)
    acc = [torch.zeros_like(x) for _ in range(3)]
    for (dy, dx), g in zip(DIRS, grads):
        w = (g <= thold).to(x.dtype)
        n = n + w
        bc = [shb[c](dy, dx) for c in range(3)]
        # the bilinear estimate of the centre's colour at the neighbour
        ref = torch.where(mr, bc[0], torch.where(mg, bc[1], bc[2]))
        for c in range(3):
            acc[c] = acc[c] + w * (bc[c] - ref)
    inv = rdiv(1.0, torch.clamp(n, min=1.0))
    return torch.stack([torch.where(m, x, x + acc[c] * inv)
                        for c, m in enumerate((mr, mg, mb))])
