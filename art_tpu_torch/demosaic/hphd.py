"""HPHD demosaic (counterpart of ``art_tpu/demosaic/hphd.py``;
hphd_demosaic_RT.cc, Horvath's homogeneity-guided interpolation).

The reference's whole-plane formulation in plain PyTorch: the vertical
and horizontal high-pass statistic maps (|5th-order derivative|, its
9-tap mean and squared deviation, the neighbouring means blended by the
opposite deviation), a 3-way classification by the 0.8 dominance test,
directional greens with inverse-gradient weights switched by it, and R/B
by green-guided interpolation (interpolate_row_rb_mul_pp). The outer
10-pixel ring takes the bilinear result.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.fmath import fdiv, rdiv
from art_tpu_torch.core.image import bayer_channel_masks, shifts
from art_tpu_torch.demosaic.ahd import rg_rows
from art_tpu_torch.demosaic.bilinear import bilinear_ring
from art_tpu_torch.demosaic.eahd import chroma_rb

BORDER = 10
EPS = 0.001


def hp_map(x, axis):
    """The directional high-pass statistic along `axis` (0 = vertical)."""
    s = shifts(x, 10)

    def sh(d):
        return s(d, 0) if axis == 0 else s(0, d)

    temp = torch.abs((sh(-5) - sh(5)) - 8.0 * (sh(-4) - sh(4))
                     + 27.0 * (sh(-3) - sh(3)) - 48.0 * (sh(-2) - sh(2))
                     + 42.0 * (sh(-1) - sh(1)))
    st = shifts(temp, 5)

    def sht(d):
        return st(d, 0) if axis == 0 else st(0, d)

    taps = [sht(d) for d in range(-4, 5)]
    avg = fdiv(sum(taps), 9.0)
    dev = torch.clamp(sum((t - avg) ** 2 for t in taps), min=EPS)
    sa, sd = shifts(avg, 1), shifts(dev, 1)
    if axis == 0:
        avg_l, avg_r, dev_l, dev_r = sa(-1, 0), sa(1, 0), sd(-1, 0), sd(1, 0)
    else:
        avg_l, avg_r, dev_l, dev_r = sa(0, -1), sa(0, 1), sd(0, -1), sd(0, 1)
    return avg_l + (avg_r - avg_l) * dev_l / (dev_l + dev_r)


def green_dir_weights(s, vertical):
    """(g_minus, g_plus, e_minus, e_plus) of one orientation at a non-G
    site: g = raw(+-1) - raw(+-2) / 2, e = 1 / (the axis gradient plus
    the same-colour gradients of that side)."""
    a = torch.abs
    if vertical:
        g_m = s(-1, 0) - 0.5 * s(-2, 0)
        g_p = s(1, 0) - 0.5 * s(2, 0)
        d_ax = EPS + a(s(1, 0) - s(-1, 0))
        e_m = rdiv(1.0, d_ax + a(s(-1, 0) - s(-3, 0)) + a(s(0, 0) - s(-2, 0))
                   + 0.5 * (a(s(0, -1) - s(-2, -1)) + a(s(0, 1) - s(-2, 1))))
        e_p = rdiv(1.0, d_ax + a(s(1, 0) - s(3, 0)) + a(s(0, 0) - s(2, 0))
                   + 0.5 * (a(s(0, -1) - s(2, -1)) + a(s(0, 1) - s(2, 1))))
    else:
        g_m = s(0, -1) - 0.5 * s(0, -2)
        g_p = s(0, 1) - 0.5 * s(0, 2)
        d_ax = EPS + a(s(0, 1) - s(0, -1))
        e_m = rdiv(1.0, d_ax + a(s(0, -3) - s(0, -1)) + a(s(0, -2) - s(0, 0))
                   + 0.5 * (a(s(-1, -2) - s(-1, 0)) + a(s(1, -2) - s(1, 0))))
        e_p = rdiv(1.0, d_ax + a(s(0, 3) - s(0, 1)) + a(s(0, 2) - s(0, 0))
                   + 0.5 * (a(s(-1, 2) - s(-1, 0)) + a(s(1, 2) - s(1, 0))))
    return g_m, g_p, e_m, e_p


def hphd_demosaic(cfa, pattern, **kw):
    """(H, W) mosaic in 0..65535 -> (3, H, W) RGB on cfa's device."""
    x = torch.clamp(cfa, min=0.0)
    mr, mg, mb = bayer_channel_masks(pattern, x.shape, x.device)
    hp_v, hp_h = hp_map(x, 0), hp_map(x, 1)
    # 2: a vertical edge (interpolate along columns), 1: a horizontal
    # one, 0: isotropic
    klass = torch.where(hp_v < 0.8 * hp_h, 2,
                        torch.where(hp_h < 0.8 * hp_v, 1, 0))

    s = shifts(x, 3)
    gv_m, gv_p, ev_m, ev_p = green_dir_weights(s, vertical=True)
    gh_m, gh_p, eh_m, eh_p = green_dir_weights(s, vertical=False)
    g_horiz = 0.5 * x + (eh_m * gh_m + eh_p * gh_p) / (eh_m + eh_p)
    g_vert = 0.5 * x + (ev_m * gv_m + ev_p * gv_p) / (ev_m + ev_p)
    g_iso = 0.5 * x + ((ev_m * gv_m + eh_p * gh_p)
                       + (ev_p * gv_p + eh_m * gh_m)) / (
        ev_m + ev_p + eh_m + eh_p)
    g_est = torch.clamp(torch.where(klass == 1, g_horiz, torch.where(
        klass == 2, g_vert, g_iso)), min=0.0)
    g = torch.where(mg, x, g_est)

    r, b = chroma_rb(x, g, mr, mb, rg_rows(mr))
    rgb = torch.stack([torch.clamp(r, min=0.0), g, torch.clamp(b, min=0.0)])
    return bilinear_ring(rgb, cfa, pattern, BORDER)
