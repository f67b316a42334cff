"""IGV Bayer demosaic (counterpart of ``art_tpu/demosaic/igv.py``;
demosaic_algos.cc igv_interpolate:495, integrated gaussian vector).

The reference's whole-plane formulation in plain PyTorch: Hamilton-Adams
green candidates N/E/W/S fused by gradient weights into vertical and
horizontal G-C differences at R/B sites; the IGV energies of the
difference planes pick between the two, each limited by a 3-way median;
green as C + chroma; chroma spread to the opposite colour's sites from
the diagonals and to the green sites from the cardinals, by inverse
gradient weights. Half-image offsets of the reference are full-plane
offsets of 2 here, with parity masks selecting the sites.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.fmath import fdiv, rdiv
from art_tpu_torch.core.image import bayer_channel_masks, shifts
from art_tpu_torch.demosaic.ahd import median3

EPS = 1e-5
EPSSQ = 1e-5
R = 7


def igv_demosaic(cfa, pattern, **kw):
    """(H, W) mosaic in 0..65535 -> (3, H, W) RGB on cfa's device."""
    x = torch.clamp(cfa, min=0.0) * (1.0 / 65535.0)
    mr, mg, mb = bayer_channel_masks(pattern, x.shape, x.device)
    sh = shifts(x, R)

    # stage 1: directional green-minus-colour differences
    def grad(d1, d3, c2):
        return EPS + torch.abs(sh(*d1) - sh(*d3)) + torch.abs(x - sh(*c2))

    ng = grad((-1, 0), (-3, 0), (-2, 0))
    sg = grad((1, 0), (3, 0), (2, 0))
    wg = grad((0, -1), (0, -3), (0, -2))
    eg = grad((0, 1), (0, 3), (0, 2))

    def ha(g1, g3, g5, go, c2, c4):
        v = (23.0 * sh(*g1) + 23.0 * sh(*g3) + sh(*g5) + sh(*go)
             + 40.0 * x - 32.0 * sh(*c2) - 8.0 * sh(*c4))
        return torch.clamp(fdiv(v, 48.0), 0.0, 1.0)

    nv = ha((-1, 0), (-3, 0), (-5, 0), (1, 0), (-2, 0), (-4, 0))
    sv = ha((1, 0), (3, 0), (5, 0), (-1, 0), (2, 0), (4, 0))
    wv = ha((0, -1), (0, -3), (0, -5), (0, 1), (0, -2), (0, -4))
    ev = ha((0, 1), (0, 3), (0, 5), (0, -1), (0, 2), (0, 4))

    nong = ~mg
    vdif = torch.where(nong, (sg * nv + ng * sv) / (ng + sg) - x, 0.0)
    hdif = torch.where(nong, (wg * ev + eg * wv) / (eg + wg) - x, 0.0)
    pv, ph = shifts(vdif, R), shifts(hdif, R)

    def sv_(k):  # vdif k rows down
        return pv(k, 0)

    def sh_(k):  # hdif k columns right
        return ph(0, k)

    # stage 2: IGV energies and the median-limited H/V chroma fuse
    def energy(s):
        e = (EPSSQ + 78.0 * s(0) ** 2
             + 69.0 * (s(-2) ** 2 + s(2) ** 2)
             + 51.0 * (s(-4) ** 2 + s(4) ** 2)
             + 21.0 * (s(-6) ** 2 + s(6) ** 2)
             - 6.0 * (s(-2) + s(0) + s(2)) ** 2
             - 10.0 * ((s(-4) + s(-2) + s(0)) ** 2
                       + (s(0) + s(2) + s(4)) ** 2)
             - 7.0 * ((s(-6) + s(-4) + s(-2)) ** 2
                      + (s(2) + s(4) + s(6)) ** 2))
        return torch.clamp(e, 0.0, 1.0)

    e_v = energy(sv_)
    e_h = energy(sh_)
    lim_v = median3(0.725 * sv_(0) + 0.1375 * (sv_(-2) + sv_(2)),
                 sv_(-2), sv_(2))
    lim_h = median3(0.725 * sh_(0) + 0.1375 * (sh_(-2) + sh_(2)),
                 sh_(-2), sh_(2))
    chr_site = (e_h * lim_v + e_v * lim_h) / (e_v + e_h)
    g = torch.where(mg, x, x + chr_site)
    chr_r = torch.where(mr, chr_site, 0.0)
    chr_b = torch.where(mb, chr_site, 0.0)

    # stage 3: chroma at the opposite colour's sites (diagonals)
    def spread(chn, offsets, limit):
        s = shifts(chn, R)
        num = torch.zeros_like(x)
        den = torch.zeros_like(x)
        for oy, ox in offsets:
            wgt = rdiv(1.0, EPS + torch.abs(s(oy, ox) - s(3 * oy, 3 * ox))
                       + torch.abs(s(-oy, -ox) - s(3 * oy, 3 * ox)))
            v = (median3(s(oy, ox), s(3 * oy, ox), s(oy, 3 * ox)) if limit
                 else s(oy, ox))
            num = num + wgt * v
            den = den + wgt
        return num / den

    diag = ((-1, -1), (-1, 1), (1, -1), (1, 1))
    card = ((-1, 0), (1, 0), (0, -1), (0, 1))
    chr_r = torch.where(mb, spread(chr_r, diag, True), chr_r)
    chr_b = torch.where(mr, spread(chr_b, diag, True), chr_b)
    # stage 4: chroma at the green sites (cardinals)
    chr_r = torch.where(mg, spread(chr_r, card, False), chr_r)
    chr_b = torch.where(mg, spread(chr_b, card, False), chr_b)

    red = torch.where(mr, x, g - chr_r)
    blue = torch.where(mb, x, g - chr_b)
    return torch.stack([red, g, blue]) * 65535.0
