"""RCD (Ratio Corrected Demosaicing) on the whole plane (counterpart of
``art_tpu/demosaic/rcd.py``; rcd_demosaic.cc, RCD 2.3).

Plain PyTorch: the reference computes RCD in XLA, outside any Pallas
kernel, as full-plane shifted-stencil expressions with CFA parity masks.
Each intermediate is reflect-padded once per `_Shifter` (by 4, 1, 2 or 3,
as there) and read as shifted views; both arms of every select are
computed, as there; the outer 9-pixel ring takes the bilinear result.
Every division but the one by 65536 (a power of two, exact as a
multiply) is by a tensor, so it is an IEEE division on every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from art_tpu_torch.core.image import bayer_channel_masks
from art_tpu_torch.demosaic.bilinear import bilinear_ring

EPS = 1e-5
EPSSQ = 1e-10
BORDER = 9


class _Shifter:
    """Pad once, slice per (dy, dx): every shift is a view of one pad."""

    def __init__(self, x, r=4):
        self.r = r
        self.h, self.w = x.shape
        self.p = F.pad(x[None, None], (r, r, r, r), mode="reflect")[0, 0]

    def __call__(self, dy, dx):
        r = self.r
        return self.p[r + dy : r + dy + self.h, r + dx : r + dx + self.w]


def _hpf_sq(s, axis):
    """Squared 2nd-derivative high pass (reference step 1.1)."""
    if axis == 0:
        a = (s(-3, 0) - s(-1, 0) - s(1, 0) + s(3, 0)
             - 3.0 * (s(-2, 0) + s(2, 0)) + 6.0 * s(0, 0))
    else:
        a = (s(0, -3) - s(0, -1) - s(0, 1) + s(0, 3)
             - 3.0 * (s(0, -2) + s(0, 2)) + 6.0 * s(0, 0))
    return a * a


def _disc(d, nbh):
    """The direction weight d, or its neighbourhood mean where that lies
    farther from 0.5 (the more decided of the two)."""
    return torch.where(torch.abs(0.5 - d) < torch.abs(0.5 - nbh), nbh, d)


def _diag_mean(s):
    return 0.25 * (s(-1, -1) + s(-1, 1) + s(1, -1) + s(1, 1))


def rcd_demosaic(cfa, pattern, **kw):
    """(H, W) Bayer mosaic in 0..65535 -> (3, H, W) RGB, same domain."""
    scale = 65536.0
    x = torch.clamp(cfa / scale, 0.0, 1.0)
    mr, mg, mb = bayer_channel_masks(pattern, x.shape, x.device)
    m_rb = ~mg
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    s = _Shifter(x, r=4)

    # Step 1: V/H discrimination
    v_hpf = _hpf_sq(s, 0)
    h_hpf = _hpf_sq(s, 1)
    sv = _Shifter(v_hpf, r=1)
    sh = _Shifter(h_hpf, r=1)
    v_stat = torch.clamp(sv(-1, 0) + v_hpf + sv(1, 0), min=EPSSQ)
    h_stat = torch.clamp(sh(0, -1) + h_hpf + sh(0, 1), min=EPSSQ)
    vh_dir = v_stat / (v_stat + h_stat)

    # Step 2: low-pass (used at R/B sites; computed everywhere)
    lpf = (x
           + 0.5 * (s(-1, 0) + s(1, 0) + s(0, -1) + s(0, 1))
           + 0.25 * (s(-1, -1) + s(-1, 1) + s(1, -1) + s(1, 1)))
    sl = _Shifter(lpf, r=2)

    # Step 3: green at R/B sites
    n_grad = (EPS + torch.abs(s(-1, 0) - s(1, 0)) + torch.abs(x - s(-2, 0))
              + torch.abs(s(-1, 0) - s(-3, 0))
              + torch.abs(s(-2, 0) - s(-4, 0)))
    s_grad = (EPS + torch.abs(s(-1, 0) - s(1, 0)) + torch.abs(x - s(2, 0))
              + torch.abs(s(1, 0) - s(3, 0)) + torch.abs(s(2, 0) - s(4, 0)))
    w_grad = (EPS + torch.abs(s(0, -1) - s(0, 1)) + torch.abs(x - s(0, -2))
              + torch.abs(s(0, -1) - s(0, -3))
              + torch.abs(s(0, -2) - s(0, -4)))
    e_grad = (EPS + torch.abs(s(0, -1) - s(0, 1)) + torch.abs(x - s(0, 2))
              + torch.abs(s(0, 1) - s(0, 3)) + torch.abs(s(0, 2) - s(0, 4)))

    # ratio-corrected estimates: the lpf neighbour is the same-colour
    # site 2 away
    n_est = s(-1, 0) * (2.0 * lpf) / (EPS + lpf + sl(-2, 0))
    s_est = s(1, 0) * (2.0 * lpf) / (EPS + lpf + sl(2, 0))
    w_est = s(0, -1) * (2.0 * lpf) / (EPS + lpf + sl(0, -2))
    e_est = s(0, 1) * (2.0 * lpf) / (EPS + lpf + sl(0, 2))

    v_est = (s_grad * n_est + n_grad * s_est) / (n_grad + s_grad)
    h_est = (w_grad * e_est + e_grad * w_est) / (e_grad + w_grad)

    vh_disc = _disc(vh_dir, _diag_mean(_Shifter(vh_dir, r=1)))
    g_at_rb = vh_disc * h_est + (1.0 - vh_disc) * v_est
    green = torch.where(m_rb, g_at_rb, x)

    # Step 4.0/4.1: P/Q diagonal discrimination
    p_hpf = (s(-3, -3) - s(-1, -1) - s(1, 1) + s(3, 3)
             - 3.0 * (s(-2, -2) + s(2, 2)) + 6.0 * x)
    p_hpf = p_hpf * p_hpf
    q_hpf = (s(-3, 3) - s(-1, 1) - s(1, -1) + s(3, -3)
             - 3.0 * (s(-2, 2) + s(2, -2)) + 6.0 * x)
    q_hpf = q_hpf * q_hpf
    sp = _Shifter(p_hpf, r=1)
    sq = _Shifter(q_hpf, r=1)
    p_stat = torch.clamp(sp(-1, -1) + p_hpf + sp(1, 1), min=EPSSQ)
    q_stat = torch.clamp(sq(-1, 1) + q_hpf + sq(1, -1), min=EPSSQ)
    pq_dir = p_stat / (p_stat + q_stat)
    pq_disc = _disc(pq_dir, _diag_mean(_Shifter(pq_dir, r=1)))

    # Step 4.2: R at B sites and B at R sites, from the diagonal colour
    # differences (the diagonal neighbours of one are sites of the other)
    sg = _Shifter(green, r=3)
    cdiff = x - green

    nw_grad = (EPS + torch.abs(s(-1, -1) - s(1, 1))
               + torch.abs(s(-1, -1) - s(-3, -3))
               + torch.abs(green - sg(-2, -2)))
    ne_grad = (EPS + torch.abs(s(-1, 1) - s(1, -1))
               + torch.abs(s(-1, 1) - s(-3, 3))
               + torch.abs(green - sg(-2, 2)))
    sw_grad = (EPS + torch.abs(s(-1, 1) - s(1, -1))
               + torch.abs(s(1, -1) - s(3, -3))
               + torch.abs(green - sg(2, -2)))
    se_grad = (EPS + torch.abs(s(-1, -1) - s(1, 1))
               + torch.abs(s(1, 1) - s(3, 3))
               + torch.abs(green - sg(2, 2)))

    sc = _Shifter(cdiff, r=1)
    nw_est, ne_est = sc(-1, -1), sc(-1, 1)
    sw_est, se_est = sc(1, -1), sc(1, 1)
    p_est = (nw_grad * se_est + se_grad * nw_est) / (nw_grad + se_grad)
    q_est = (ne_grad * sw_est + sw_grad * ne_est) / (ne_grad + sw_grad)
    opp_at_rb = green + (pq_disc * q_est + (1.0 - pq_disc) * p_est)

    red = torch.where(mr, x, torch.where(mb, opp_at_rb, zero))
    blue = torch.where(mb, x, torch.where(mr, opp_at_rb, zero))

    # Step 4.3: R and B at green sites from the cardinal differences
    g1 = green
    sgr = _Shifter(g1, r=2)
    n1 = EPS + torch.abs(g1 - sgr(-2, 0))
    s1 = EPS + torch.abs(g1 - sgr(2, 0))
    w1 = EPS + torch.abs(g1 - sgr(0, -2))
    e1 = EPS + torch.abs(g1 - sgr(0, 2))

    def chroma_at_g(c_plane):
        scp = _Shifter(c_plane, r=3)
        snabs = torch.abs(scp(-1, 0) - scp(1, 0))
        ewabs = torch.abs(scp(0, -1) - scp(0, 1))
        n_g = n1 + snabs + torch.abs(scp(-1, 0) - scp(-3, 0))
        s_g = s1 + snabs + torch.abs(scp(1, 0) - scp(3, 0))
        w_g = w1 + ewabs + torch.abs(scp(0, -1) - scp(0, -3))
        e_g = e1 + ewabs + torch.abs(scp(0, 1) - scp(0, 3))
        n_e = scp(-1, 0) - sgr(-1, 0)
        s_e = scp(1, 0) - sgr(1, 0)
        w_e = scp(0, -1) - sgr(0, -1)
        e_e = scp(0, 1) - sgr(0, 1)
        v_e = (n_g * s_e + s_g * n_e) / (n_g + s_g)
        h_e = (e_g * w_e + w_g * e_e) / (e_g + w_g)
        return g1 + (vh_disc * h_e + (1.0 - vh_disc) * v_e)

    red = torch.where(mg, chroma_at_g(red), red)
    blue = torch.where(mg, chroma_at_g(blue), blue)

    rgb = torch.clamp(torch.stack([red, green, blue]) * scale, min=0.0)

    # the reference interpolates the outer ring separately: bilinear
    return bilinear_ring(rgb, cfa, pattern, BORDER)
