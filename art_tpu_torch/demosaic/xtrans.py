"""X-Trans demosaic (counterpart of ``art_tpu/demosaic/xtrans.py``;
rtengine/xtrans_demosaic.cc).

`fast_xtrans` (fast_xtrans_interpolate:971): 3x3 weighted colour sums
with green normalisation by solitary or paired green sites.
`xtrans_directional` fills the Markesteijn 1/2/3-pass slots: directional
green candidates fused by smoothed derivative energies and clamped to the
local green range, chroma by a normalised 5x5 tent convolution of the
colour differences, and median refinements for the later passes. The
formulation is the reference's own (its whole-plane stencils selected by
the 6x6 layout, not the C++ hex tables), in plain PyTorch; the colour
index is a lookup on the global coordinates (`core.image.
xtrans_color_index_device`).
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.core.image import shifts, xtrans_color_index_device

_W33 = ((0.25, 0.5, 0.25), (0.5, 0.0, 0.5), (0.25, 0.5, 0.25))


def fast_xtrans(cfa, xtrans_pattern):
    h, w = cfa.shape
    dev = cfa.device
    cidx = xtrans_color_index_device(xtrans_pattern, (h, w), dev)
    masks = [cidx == c for c in range(3)]

    sums = []
    for c in range(3):
        sh = shifts(torch.where(masks[c], cfa, 0.0), 1)
        s = torch.zeros_like(cfa)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                wgt = _W33[dy + 1][dx + 1]
                if wgt:
                    s = s + sh(dy, dx) * wgt
        sums.append(s)

    # a solitary green: its left and right neighbours share a colour
    left = xtrans_color_index_device(xtrans_pattern, (h, w), dev, dx=-1)
    right = xtrans_color_index_device(xtrans_pattern, (h, w), dev, dx=1)
    solitary = (cidx == 1) & (left == right)

    def chroma(c):
        at_g = torch.where(solitary, sums[c], sums[c] * 1.3333333)
        return torch.where(masks[c], cfa,
                           torch.where(masks[1], at_g, sums[c]))

    g = torch.where(masks[1], cfa, sums[1] * 0.5)
    return torch.stack([chroma(0), g, chroma(2)])


def _box3(x):
    sh = shifts(x, 1, mode="replicate")
    acc = torch.zeros_like(x)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc + sh(dy, dx)
    return acc * (1.0 / 9.0)


def _med3x3(x):
    sh = shifts(x, 1, mode="replicate")
    planes = torch.stack([sh(dy, dx) for dy in (-1, 0, 1)
                          for dx in (-1, 0, 1)])
    return torch.median(planes, dim=0).values


def green_directional(cfa, xtrans_pattern):
    """Directional green candidates and the energy-fused green; returns
    (g, g_h, g_v), g equal to cfa at green sites."""
    h, w = cfa.shape
    dev = cfa.device

    def green_at(dy, dx):
        return xtrans_color_index_device(xtrans_pattern, (h, w), dev,
                                         dy=dy, dx=dx) == 1

    mg = green_at(0, 0)
    gl, gr, gu, gd = green_at(0, -1), green_at(0, 1), green_at(-1, 0), \
        green_at(1, 0)

    x = cfa
    sh = shifts(x, 3)
    third = 1.0 / 3.0
    # the X-Trans row invariant: greens on both near sides, or one near
    # at 1 and a far one at 2; both sides take the curvature-cancelling
    # weights (xtrans_demosaic.cc:439)
    g_h = torch.where(gl & gr,
                      0.6796875 * (sh(0, -1) + sh(0, 1))
                      - 0.1796875 * (sh(0, -2) + sh(0, 2)),
                      torch.where(gl, (2.0 * sh(0, -1) + sh(0, 2)) * third,
                                  (2.0 * sh(0, 1) + sh(0, -2)) * third))
    g_v = torch.where(gu & gd,
                      0.6796875 * (sh(-1, 0) + sh(1, 0))
                      - 0.1796875 * (sh(-2, 0) + sh(2, 0)),
                      torch.where(gu, (2.0 * sh(-1, 0) + sh(2, 0)) * third,
                                  (2.0 * sh(1, 0) + sh(-2, 0)) * third))

    # diagonal candidates (the hex[4]/hex[5] pair, xtrans_demosaic.cc:445)
    gd_ul, gd_ur = green_at(-1, -1), green_at(-1, 1)
    corr1 = 0.12890625 * (2.0 * x - sh(-3, -3) - sh(3, 3))
    corr2 = 0.12890625 * (2.0 * x - sh(-3, 3) - sh(3, -3))
    g_d1 = torch.where(gd_ul,
                       0.640625 * sh(-1, -1) + 0.359375 * sh(2, 2),
                       0.640625 * sh(1, 1) + 0.359375 * sh(-2, -2)) + corr1
    g_d2 = torch.where(gd_ur,
                       0.640625 * sh(-1, 1) + 0.359375 * sh(2, -2),
                       0.640625 * sh(1, -1) + 0.359375 * sh(-2, 2)) + corr2

    # direction energies, smoothed; weights are the prior over the
    # squared energy, 0.5 on the diagonals
    e_h = ((sh(0, -1) - sh(0, 1)) ** 2
           + (2.0 * x - sh(0, -2) - sh(0, 2)) ** 2)
    e_v = ((sh(-1, 0) - sh(1, 0)) ** 2
           + (2.0 * x - sh(-2, 0) - sh(2, 0)) ** 2)
    e_d1 = ((sh(-1, -1) - sh(1, 1)) ** 2
            + (2.0 * x - sh(-2, -2) - sh(2, 2)) ** 2)
    e_d2 = ((sh(-1, 1) - sh(1, -1)) ** 2
            + (2.0 * x - sh(-2, 2) - sh(2, -2)) ** 2)
    eps = 1e-5
    pri = (1.0, 1.0, 0.5, 0.5)
    # p / e as a division (a scalar over a tensor is a reciprocal times
    # the scalar in PyTorch)
    ws = [torch.full_like(x, p_) / (_box3(e) + eps) ** 2
          for p_, e in zip(pri, (e_h, e_v, e_d1, e_d2))]
    wsum = ws[0] + ws[1] + ws[2] + ws[3]
    g = (ws[0] * g_h + ws[1] * g_v + ws[2] * g_d1 + ws[3] * g_d2) / wsum

    # clamp to the masked 8-neighbour greens' min/max (greenminmax,
    # xtrans_demosaic.cc:319-410)
    big = float(np.finfo(np.float32).max)
    neigh = [(gl, sh(0, -1)), (gr, sh(0, 1)), (gu, sh(-1, 0)),
             (gd, sh(1, 0)), (gd_ul, sh(-1, -1)), (gd_ur, sh(-1, 1)),
             (green_at(1, -1), sh(1, -1)), (green_at(1, 1), sh(1, 1))]
    gmin = torch.full_like(x, big)
    gmax = torch.full_like(x, -big)
    for m, v in neigh:
        gmin = torch.minimum(gmin, torch.where(m, v, big))
        gmax = torch.maximum(gmax, torch.where(m, v, -big))
    g = torch.minimum(torch.maximum(g, gmin), gmax)
    g = torch.where(mg, x, g)
    return g, g_h, g_v


_TENT = np.outer([1.0, 2.0, 3.0, 2.0, 1.0], [1.0, 2.0, 3.0, 2.0, 1.0])


def xtrans_directional(cfa, xtrans_pattern, passes=1):
    """Directional X-Trans demosaic for the Markesteijn-quality slots."""
    h, w = cfa.shape
    cidx = xtrans_color_index_device(xtrans_pattern, (h, w), cfa.device)
    mr, mg, mb = cidx == 0, cidx == 1, cidx == 2
    x = cfa
    g, _, _ = green_directional(cfa, xtrans_pattern)

    # chroma: normalised convolution of the colour differences with a
    # 5x5 tent (X-Trans has >= 2 sites of each colour in any 5x5)
    def chan(mc):
        sd = shifts(torch.where(mc, x - g, 0.0), 2)
        sm = shifts(mc.to(x.dtype), 2)
        num = torch.zeros_like(x)
        den = torch.zeros_like(x)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                wgt = float(_TENT[dy + 2, dx + 2])
                num = num + wgt * sd(dy, dx)
                den = den + wgt * sm(dy, dx)
        return torch.where(mc, x, g + num / torch.clamp(den, min=1e-6))

    red, blue = chan(mr), chan(mb)
    for _ in range(max(int(passes) - 1, 0)):
        m_rg = _med3x3(red - g)
        m_bg = _med3x3(blue - g)
        red = torch.where(mr, x, g + m_rg)
        blue = torch.where(mb, x, g + m_bg)
        g = torch.where(mg, x, 0.5 * ((red - m_rg) + (blue - m_bg)))
    return torch.stack([red, g, blue])


def demosaic_xtrans(cfa, xtrans_pattern, method="3-pass (best)",
                    dem_kwargs=()):
    """The reference's dispatch by method name: mono/none, fast, 1-, 2-,
    3- and 4-pass; any other name runs 3 passes, as in the reference.
    4-pass is 4 directional passes blended against the fast method by
    `dual.dual_blend` under a positive contrast or the automatic one
    (dual_demosaic_RT.cc fast_xtrans_interpolate_blend)."""
    m = method.lower()
    if m in ("mono", "none"):
        return torch.stack([cfa, cfa, cfa])
    if m.startswith("fast"):
        return fast_xtrans(cfa, xtrans_pattern)
    passes = 3
    for prefix, n in (("1-pass", 1), ("2-pass", 2), ("4-pass", 4)):
        if m.startswith(prefix):
            passes = n
    out = xtrans_directional(cfa, xtrans_pattern, passes=passes)
    kw = dict(dem_kwargs)
    dc = kw.get("dual_contrast", 0.0)
    da = kw.get("dual_auto", False)
    if m.startswith("4-pass") and (da or dc > 0.0):
        from art_tpu_torch.demosaic.dual import dual_blend

        out = dual_blend(out, fast_xtrans(cfa, xtrans_pattern), dc, da)
    return out
