"""Local green equilibration (counterpart of ``art_tpu/raw/green_eq.py::
green_equilibrate``; rtengine/green_equil_RT.cc:120-220).

At green sites, compare the coherence of the diagonal (opposite-coset)
and the same-coset neighbours; where the G1/G2 imbalance dominates the
texture, replace G with the mean of the measured and the diagonally
interpolated value. The two decisions (`cond`, `replace`) keep the
reference's expression order, so both packages round their operands
alike.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.image import shifts


def green_equilibrate(cfa, mg, thresh):
    """`thresh` is the user GreenEqThreshold / 100, constant over the
    plane; mg the green-site mask."""
    eps = 1.0
    x = cfa
    sh = shifts(x, 3)
    # diagonal (opposite G coset) neighbours
    o1_1, o1_2, o1_3, o1_4 = sh(-1, -1), sh(-1, 1), sh(1, -1), sh(1, 1)
    # same-coset neighbours
    o2_1, o2_2, o2_3, o2_4 = sh(-2, 0), sh(2, 0), sh(0, -2), sh(0, 2)

    def coherence(a1, a2, a3, a4):
        return (torch.abs(a1 - a2) + torch.abs(a1 - a3) + torch.abs(a1 - a4)
                + torch.abs(a2 - a3) + torch.abs(a3 - a4)
                + torch.abs(a2 - a4))

    d1 = o1_1 + o1_2 + o1_3 + o1_4
    d2 = o2_1 + o2_2 + o2_3 + o2_4
    c1 = coherence(o1_1, o1_2, o1_3, o1_4)
    c2 = coherence(o2_1, o2_2, o2_3, o2_4)
    cond = (c1 + c2) < 6.0 * thresh * torch.abs(d1 - d2)

    gin = x
    gmp2p2 = gin - sh(2, 2)
    gmm2m2 = gin - sh(-2, -2)
    gmm2p2 = gin - sh(-2, 2)
    gmp2m2 = gin - sh(2, -2)

    gse = o1_4 + 0.5 * gmp2p2
    gnw = o1_1 + 0.5 * gmm2m2
    gne = o1_2 + 0.5 * gmm2p2
    gsw = o1_3 + 0.5 * gmp2m2

    wtse = 1.0 / (eps + gmp2p2 ** 2 + (sh(3, 3) - o1_4) ** 2)
    wtnw = 1.0 / (eps + gmm2m2 ** 2 + (sh(-3, -3) - o1_1) ** 2)
    wtne = 1.0 / (eps + gmm2p2 ** 2 + (sh(-3, 3) - o1_2) ** 2)
    wtsw = 1.0 / (eps + gmp2m2 ** 2 + (sh(3, -3) - o1_3) ** 2)

    ginterp = (gse * wtse + gnw * wtnw + gne * wtne + gsw * wtsw) / (
        wtse + wtnw + wtne + wtsw)
    replace = (ginterp - gin) < thresh * (ginterp + gin)
    val = torch.where(cond & replace, 0.5 * (ginterp + gin), gin)
    return torch.where(mg, val, cfa)
