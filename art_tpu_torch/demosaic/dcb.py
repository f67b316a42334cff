"""DCB demosaic (counterpart of ``art_tpu/demosaic/dcb.py``;
demosaic_algos.cc dcb_demosaic:1666, Jacek Gozdz's DCB).

The reference's whole-plane formulation in plain PyTorch, each step a
shifted-stencil expression with CFA parity masks over reflect pads; its
sequence (dcb_demosaic:1736-1766): hid, `iterations` x (3 x hid2, map,
correction), color, pp, map, correction2, map, correction, color,
2 x (map, correction), map, R/B restored, then color, or with `enhance`
the refinement and color_full. The outer 6-pixel ring takes the bilinear
result.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.fmath import fdiv, rdiv
from art_tpu_torch.core.image import bayer_channel_masks, shifts
from art_tpu_torch.demosaic.bilinear import bilinear_ring

BORDER = 6


def map_weight(mp):
    """The 0..16 weight of the vertical direction: 4 map + 2 (its 4
    neighbours) + the axial ones at 2 (dcb_correction:1467)."""
    m = shifts(mp, 2)
    return (4.0 * m(0, 0)
            + 2.0 * (m(-1, 0) + m(1, 0) + m(0, -1) + m(0, 1))
            + m(-2, 0) + m(2, 0) + m(0, -2) + m(0, 2))


def dcb_map(g):
    """The direction map on the green plane, 1 = vertical (dcb_map:1444)."""
    s = shifts(g, 3)
    gh0, gh1 = s(0, -3), s(0, 3)
    gv0, gv1 = s(-3, 0), s(3, 0)
    cond = 4.0 * s(0, 0) > (gh0 + gh1 + gv0 + gv1)
    m_hi = (torch.minimum(gh0, gh1) + gh0 + gh1) < (torch.minimum(gv0, gv1)
                                                    + gv0 + gv1)
    m_lo = (torch.maximum(gh0, gh1) + gh0 + gh1) > (torch.maximum(gv0, gv1)
                                                    + gv0 + gv1)
    return torch.where(cond, m_hi, m_lo).to(g.dtype)


def _inv_spread(a, b, c):
    return rdiv(1.0, 1.0 + torch.abs(a - b) + torch.abs(a - c)
                + torch.abs(b - c))


def dcb_demosaic(cfa, pattern, iterations=2, enhance=True, **kw):
    """(H, W) mosaic in 0..65535 -> (3, H, W) RGB on cfa's device."""
    x = torch.clamp(cfa, min=0.0)
    mr, mg, mb = bayer_channel_masks(pattern, x.shape, x.device)
    mrb = ~mg
    r0 = torch.where(mr, x, 0.0)
    b0 = torch.where(mb, x, 0.0)
    g = torch.where(mg, x, 0.0)
    c_site = x  # the R or B value at its own sites
    scx = shifts(c_site, 2)

    # dcb_hid: bilinear green at the R/B sites
    sg = shifts(g, 1)
    g = torch.where(mrb,
                    0.25 * (sg(0, -1) + sg(0, 1) + sg(-1, 0) + sg(1, 0)), g)

    def hid2(g):
        # dcb_hid2:1423: G = C + mean4(G+-2 - C+-2) at R/B sites
        s = shifts(g, 2)
        est = c_site + 0.25 * (
            s(-2, 0) + s(2, 0) + s(0, -2) + s(0, 2)
            - scx(-2, 0) - scx(2, 0) - scx(0, -2) - scx(0, 2))
        return torch.where(mrb, est, g)

    def correction(g, mp):
        cur = map_weight(mp)
        s = shifts(g, 1)
        est = ((16.0 - cur) * (s(0, -1) + s(0, 1))
               + cur * (s(-1, 0) + s(1, 0))) * 0.03125
        return torch.where(mrb, est, g)

    def correction2(g, mp):
        cur = map_weight(mp)
        s = shifts(g, 1)
        est = c_site + ((16.0 - cur) * (s(0, -1) + s(0, 1)
                                        - (scx(0, -2) + scx(0, 2)))
                        + cur * (s(-1, 0) + s(1, 0)
                                 - (scx(-2, 0) + scx(2, 0)))) * 0.03125
        return torch.where(mrb, est, g)

    # on a G site of an R row, R is the horizontal neighbour
    rg_row = torch.roll(mr, 1, dims=1) | torch.roll(mr, -1, dims=1)

    def color(g, r, b):
        # dcb_color:1361: the opposite colour from the diagonal
        # differences, R/B at G from the axial ones
        def diag(p):
            s = shifts(p, 1)
            return s(-1, -1) + s(-1, 1) + s(1, -1) + s(1, 1)

        def axh(p):
            s = shifts(p, 1)
            return s(0, -1) + s(0, 1)

        def axv(p):
            s = shifts(p, 1)
            return s(-1, 0) + s(1, 0)

        gd = diag(g)
        r = torch.where(mb, g + 0.25 * (diag(r) - gd), r)
        b = torch.where(mr, g + 0.25 * (diag(b) - gd), b)
        ghh, gvv = axh(g), axv(g)
        r_h = g + 0.5 * (axh(r) - ghh)
        r_v = g + 0.5 * (axv(r) - gvv)
        b_h = g + 0.5 * (axh(b) - ghh)
        b_v = g + 0.5 * (axv(b) - gvv)
        r = torch.where(mg, torch.where(rg_row, r_h, r_v), r)
        b = torch.where(mg, torch.where(rg_row, b_v, b_h), b)
        return r, b

    def pp(g, r, b):
        # dcb_pp:1480: 8-neighbour means, R/B re-centred on local green
        def mean8(p):
            s = shifts(p, 1)
            return 0.125 * (s(-1, -1) + s(-1, 0) + s(-1, 1) + s(0, -1)
                            + s(0, 1) + s(1, -1) + s(1, 0) + s(1, 1))

        r1, g1, b1 = mean8(r), mean8(g), mean8(b)
        return r1 + (g - g1), b1 + (g - g1)

    for _ in range(max(int(iterations), 1)):
        g = hid2(hid2(hid2(g)))
        g = correction(g, dcb_map(g))
    r, b = color(g, r0, b0)
    r, b = pp(g, r, b)
    g = correction2(g, dcb_map(g))
    g = correction(g, dcb_map(g))
    r, b = color(g, r, b)
    g = correction(g, dcb_map(g))
    g = correction(g, dcb_map(g))
    mp = dcb_map(g)
    # restore_from_buffer: R/B back to their CFA values
    r = torch.where(mr, x, r)
    b = torch.where(mb, x, b)

    if not enhance:
        r, b = color(g, torch.where(mr, r, 0.0), torch.where(mb, b, 0.0))
    else:
        # dcb_refinement:1577: green at R/B sites, ratio based, clamped
        cur = map_weight(mp)
        s = shifts(g, 1)
        cp = c_site
        f0 = (s(-1, 0) + s(1, 0)) / (1.0 + 2.0 * cp)
        f1 = 2.0 * s(-1, 0) / (1.0 + scx(-2, 0) + cp)
        f2 = 2.0 * s(1, 0) / (1.0 + scx(2, 0) + cp)
        g1 = f0 + f1 + f2
        h0 = (s(0, -1) + s(0, 1)) / (1.0 + 2.0 * cp)
        h1 = 2.0 * s(0, -1) / (1.0 + scx(0, -2) + cp)
        h2 = 2.0 * s(0, 1) / (1.0 + scx(0, 2) + cp)
        g2 = h0 + h1 + h2
        est = fdiv(cp * (cur * g1 + (16.0 - cur) * g2), 48.0)
        lo = torch.minimum(torch.minimum(s(0, -1), s(0, 1)),
                           torch.minimum(s(-1, 0), s(1, 0)))
        hi = torch.maximum(torch.maximum(s(0, -1), s(0, 1)),
                           torch.maximum(s(-1, 0), s(1, 0)))
        g = torch.where(mrb, torch.minimum(torch.maximum(est, lo), hi), g)

        # dcb_color_full:1620: adaptive chroma interpolation
        ch_r = torch.where(mr, r - g, 0.0)
        ch_b = torch.where(mb, b - g, 0.0)

        def chroma_diag(ch):
            s = shifts(ch, 4)
            c_mm, c_mp = s(-1, -1), s(-1, 1)
            c_pm, c_pp = s(1, -1), s(1, 1)
            f0 = _inv_spread(c_mm, c_pp, s(-3, -3))
            f1 = _inv_spread(c_mp, c_pm, s(-3, 3))
            f2 = _inv_spread(c_pm, c_mp, s(3, -3))
            f3 = _inv_spread(c_pp, c_mm, s(3, 3))
            g0 = 1.325 * c_mm - 0.175 * s(-3, -3) - 0.075 * (s(-3, -1)
                                                             + s(-1, -3))
            g1 = 1.325 * c_mp - 0.175 * s(-3, 3) - 0.075 * (s(-3, 1)
                                                            + s(-1, 3))
            g2 = 1.325 * c_pm - 0.175 * s(3, -3) - 0.075 * (s(3, -1)
                                                            + s(1, -3))
            g3 = 1.325 * c_pp - 0.175 * s(3, 3) - 0.075 * (s(3, 1)
                                                           + s(1, 3))
            return (f0 * g0 + f1 * g1 + f2 * g2 + f3 * g3) / (f0 + f1
                                                              + f2 + f3)

        ch_r = torch.where(mb, chroma_diag(ch_r), ch_r)
        ch_b = torch.where(mr, chroma_diag(ch_b), ch_b)

        def chroma_axial(ch):
            s = shifts(ch, 3)
            f0 = _inv_spread(s(-1, 0), s(1, 0), s(-3, 0))
            f1 = _inv_spread(s(0, 1), s(0, -1), s(0, 3))
            f2 = _inv_spread(s(0, -1), s(0, 1), s(0, -3))
            f3 = _inv_spread(s(1, 0), s(-1, 0), s(3, 0))
            g0 = 0.875 * s(-1, 0) + 0.125 * s(-3, 0)
            g1 = 0.875 * s(0, 1) + 0.125 * s(0, 3)
            g2 = 0.875 * s(0, -1) + 0.125 * s(0, -3)
            g3 = 0.875 * s(1, 0) + 0.125 * s(3, 0)
            return (f0 * g0 + f1 * g1 + f2 * g2 + f3 * g3) / (f0 + f1
                                                              + f2 + f3)

        ch_r = torch.where(mg, chroma_axial(ch_r), ch_r)
        ch_b = torch.where(mg, chroma_axial(ch_b), ch_b)
        r = ch_r + g
        b = ch_b + g

    out = torch.clamp(torch.stack([r, g, b]), 0.0, 65535.0)
    return bilinear_ring(out, cfa, pattern, BORDER)
