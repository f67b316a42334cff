"""JDL demosaic (counterpart of ``art_tpu/demosaic/jdl.py``;
demosaic_algos.cc:360 jdl_interpolate_omp, Luis Sanz Rodriguez).

The reference's whole-plane formulation in plain PyTorch, in floats as
there: directional G-C candidates at R/B sites (7-tap greens fused by
inverse gradients), the own-site chroma picked by a high-order coherence
form, the opposite chroma from the 4 diagonal own-chromas (weights and
3-point medians), R and B at green sites from the 4 cardinal chroma
planes. The outer 8-pixel ring takes the bilinear result.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.fmath import fdiv, rdiv
from art_tpu_torch.core.image import bayer_channel_masks, shifts
from art_tpu_torch.demosaic.ahd import median3
from art_tpu_torch.demosaic.bilinear import bilinear_ring

BORDER = 8


def _weight(a, p, q, r, t):
    """1 / (1 + |a(p) - a(q)| + |a(p) - a(r)| + |a(q) - a(t)|) over the
    shifter a."""
    ab = torch.abs
    return rdiv(1.0, 1.0 + ab(a(*p) - a(*q)) + ab(a(*p) - a(*r))
                + ab(a(*q) - a(*t)))


def jdl_demosaic(cfa, pattern, **kw):
    """(H, W) mosaic in 0..65535 -> (3, H, W) RGB on cfa's device."""
    x = torch.clamp(cfa, min=0.0)
    mr, mg, mb = bayer_channel_masks(pattern, x.shape, x.device)
    s = shifts(x, 6)
    ab = torch.abs

    # pass 1: directional candidates at R/B sites; along a row or column
    # odd offsets are greens and even ones the centre's colour
    def cand(dy, dx):
        g1, g3, g5 = s(dy, dx), s(3 * dy, 3 * dx), s(5 * dy, 5 * dx)
        c2, c4 = s(2 * dy, 2 * dx), s(4 * dy, 4 * dx)
        f = 1.0 + ab(g1 - g3) + ab(g1 - s(-dy, -dx)) \
            + ab(s(0, 0) - c2) + ab(c2 - c4)
        g = torch.clamp(fdiv(22.0 * g1 + 22.0 * g3 + 2.0 * g5
                             + 2.0 * s(-dy, -dx) + 40.0 * s(0, 0)
                             - 32.0 * c2 - 8.0 * c4, 48.0), 0.0, 65535.0)
        return f, g

    f_n, g_n = cand(-1, 0)
    f_s, g_s = cand(1, 0)
    f_e, g_e = cand(0, 1)
    f_w, g_w = cand(0, -1)
    dif_v = torch.clamp((f_s * g_n + f_n * g_s) / (f_n + f_s), 0.0,
                        65535.0) - s(0, 0)
    dif_h = torch.clamp((f_w * g_e + f_e * g_w) / (f_e + f_w), 0.0,
                        65535.0) - s(0, 0)
    sv, sh = shifts(dif_v, 6), shifts(dif_h, 6)

    # pass 2: the own-site chroma by the coherence of the chroma run
    def coherence(sd, dy, dx):
        d0 = sd(0, 0)
        dm2, dp2 = sd(-2 * dy, -2 * dx), sd(2 * dy, 2 * dx)
        dm4, dp4 = sd(-4 * dy, -4 * dx), sd(4 * dy, 4 * dx)
        dm6, dp6 = sd(-6 * dy, -6 * dx), sd(6 * dy, 6 * dx)
        sq = torch.square
        f = (1.0 + 78.0 * sq(d0) + 69.0 * (sq(dm2) + sq(dp2))
             + 51.0 * (sq(dm4) + sq(dp4)) + 21.0 * (sq(dm6) + sq(dp6))
             - 6.0 * sq(dm2 + d0 + dp2)
             - 10.0 * (sq(dm4 + dm2 + d0) + sq(d0 + dp2 + dp4))
             - 7.0 * (sq(dm6 + dm4 + dm2) + sq(dp2 + dp4 + dp6)))
        # +1 on constant chroma; float32 cancellation at hard edges can
        # reach 0 on both axes, so the reference floors it
        return torch.clamp(f, min=1e-3)

    f0 = coherence(sv, 1, 0)
    f1 = coherence(sh, 0, 1)
    g0 = median3(0.725 * sv(0, 0) + 0.1375 * sv(-2, 0) + 0.1375 * sv(2, 0),
                 sv(-2, 0), sv(2, 0))
    g1 = median3(0.725 * sh(0, 0) + 0.1375 * sh(0, -2) + 0.1375 * sh(0, 2),
                 sh(0, -2), sh(0, 2))
    chr_own = (f1 * g0 + f0 * g1) / (f0 + f1)

    # pass 3: the opposite chroma from the 4 diagonal own-chromas (the
    # diagonal neighbours of an R site are B sites and the reverse)
    a = shifts(chr_own, 6)
    fs = [_weight(a, (-1, -1), (1, 1), (-3, -3), (-3, -3)),
          _weight(a, (-1, 1), (1, -1), (-3, 3), (-3, 3)),
          _weight(a, (1, -1), (-1, 1), (3, 3), (3, -3)),
          _weight(a, (1, 1), (-1, -1), (3, -3), (3, 3))]
    gs = [median3(a(-1, -1), a(-3, -1), a(-1, -3)),
          median3(a(-1, 1), a(-3, 1), a(-1, 3)),
          median3(a(1, -1), a(3, -1), a(1, -3)),
          median3(a(1, 1), a(3, 1), a(1, 3))]
    chr_other = ((fs[0] * gs[0] + fs[1] * gs[1] + fs[2] * gs[2]
                  + fs[3] * gs[3]) / (fs[0] + fs[1] + fs[2] + fs[3]))

    g = torch.where(mg, x, torch.clamp(x + chr_own, 0.0, 65535.0))
    other = torch.clamp(g - chr_other, 0.0, 65535.0)  # B at R, R at B

    # pass 4: R/B at green sites from the cardinal chroma planes
    chr0 = torch.where(mr, chr_own, chr_other)  # G - R
    chr1 = torch.where(mb, chr_own, chr_other)  # G - B

    def green_site(chrp):
        cc = shifts(chrp, 6)
        f = [_weight(cc, (-1, 0), (1, 0), (-3, 0), (-3, 0)),
             _weight(cc, (0, 1), (0, -1), (0, 3), (0, 3)),
             _weight(cc, (0, -1), (0, 1), (0, -3), (0, -3)),
             _weight(cc, (1, 0), (-1, 0), (3, 0), (3, 0))]
        gg = [0.875 * cc(-1, 0) + 0.125 * cc(-3, 0),
              0.875 * cc(0, 1) + 0.125 * cc(0, 3),
              0.875 * cc(0, -1) + 0.125 * cc(0, -3),
              0.875 * cc(1, 0) + 0.125 * cc(3, 0)]
        est = ((f[0] * gg[0] + f[1] * gg[1] + f[2] * gg[2] + f[3] * gg[3])
               / (f[0] + f[1] + f[2] + f[3]))
        return torch.clamp(x - est, 0.0, 65535.0)  # x is G at G sites

    r = torch.where(mr, x, torch.where(mg, green_site(chr0), other))
    b = torch.where(mb, x, torch.where(mg, green_site(chr1), other))
    return bilinear_ring(torch.stack([r, g, b]), cfa, pattern, BORDER)
