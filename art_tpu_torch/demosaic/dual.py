"""Dual demosaic (counterpart of ``art_tpu/demosaic/dual.py``;
dual_demosaic_RT.cc, the mask of rt_algo.cc buildBlendMask).

A detail method (AMaZE, RCD, DCB) is blended with a smooth one
(bilinear, VNG4) by a sigmoid of the local Lab L gradient against a
contrast threshold, blurred by a gaussian of sigma 2. The automatic
threshold takes the flattest usable 64x64 tile and the smallest of 100
candidates for which that tile blends at most 1% toward the detail
method; with no usable tile, the default slider value 0.2.

Plain PyTorch, in the reference's order of operations; the tile means
accumulate in float64 (`core/fmath.py::mean32`), so the card and the CPU
pick the same tile and threshold (`mean32`'s rounding).
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.fmath import cbrt_xla, fdiv, fsqrt, mean32, rdiv
from art_tpu_torch.ops.filters import gauss_blur

TILE = 64


def lab_l(rgb):
    """Lab L in the reference's 0..32768 domain (Color::RGB2L)."""
    y = (0.212671 * rgb[0] + 0.715160 * rgb[1] + 0.072169 * rgb[2]) \
        * (1.0 / 65535.0)
    eps = (6.0 / 29.0) ** 3
    f = torch.where(y > eps, cbrt_xla(torch.clamp(y, min=1e-12)),
                    fdiv(y, 3.0 * (6.0 / 29.0) ** 2) + 4.0 / 29.0)
    return (116.0 * f - 16.0) * 327.68


def contrast_map(lum):
    """The gradient magnitude of L over +-1 and +-2 (edge pad), in the
    0..1 contrast units of the slider / 100."""
    p = torch.nn.functional.pad(lum[None, None], (2, 2, 2, 2),
                                mode="replicate")[0, 0]
    h, w = lum.shape

    def sh(dy, dx):
        return p[2 + dy: 2 + dy + h, 2 + dx: 2 + dx + w]

    return fsqrt((sh(0, 1) - sh(0, -1)) ** 2 + (sh(1, 0) - sh(-1, 0)) ** 2
                 + (sh(0, 2) - sh(0, -2)) ** 2
                 + (sh(2, 0) - sh(-2, 0)) ** 2) * (0.0625 / 327.68)


def sigmoid_blend(contrast, threshold):
    """The blend toward the detail method: 1 / (1 + exp(16 - 16 c / t)),
    the exponent clipped to +-40."""
    t = torch.clamp(threshold, min=1e-5)
    return rdiv(1.0, 1.0 + torch.exp(torch.clamp(
        16.0 - 16.0 * contrast / t, -40.0, 40.0)))


def auto_threshold(lum, contrast):
    """The automatic threshold (a 0-dim tensor): the flattest tile whose
    mean L lies in 2000..20000 and whose variance is at least 0.5, then
    the first candidate in 0.01..1.00 whose mean blend on it is <= 1%
    (1.0 if none is); 0.2 where no tile is usable."""
    h, w = lum.shape
    th, tw = h // TILE, w // TILE
    lt = lum[: th * TILE, : tw * TILE].reshape(th, TILE, tw, TILE)
    avg = lt.double().mean(dim=(1, 3)).to(lt.dtype)
    var = ((lt - avg[:, None, :, None]) ** 2).double().mean(
        dim=(1, 3)).to(lt.dtype)
    valid = (avg >= 2000.0) & (avg <= 20000.0) & (var >= 0.5)
    inf = torch.full_like(var, float("inf"))
    score = torch.where(valid, var, inf).reshape(-1)
    flat = torch.argmin(score)
    ct = contrast[: th * TILE, : tw * TILE].reshape(
        th, TILE, tw, TILE).permute(0, 2, 1, 3).reshape(th * tw, TILE * TILE)
    tile_c = ct[flat]
    cand = fdiv(torch.arange(100, dtype=lum.dtype, device=lum.device) + 1.0,
                100.0)
    mean_blend = mean32(sigmoid_blend(tile_c[None, :], cand[:, None]), 1)
    ok = mean_blend <= 0.01
    thr = torch.where(ok.any(), cand[torch.argmax(ok.to(torch.uint8))],
                      torch.ones((), dtype=lum.dtype, device=lum.device))
    return torch.where(torch.isinf(score[flat]),
                       torch.full_like(thr, 0.2), thr)


def dual_blend(rgb_sharp, rgb_flat, contrast=20.0, auto=False):
    """Blend two demosaic results by the sharp one's local contrast;
    contrast is the 0..100 slider, auto the automatic threshold."""
    lum = lab_l(rgb_sharp)
    cmap = contrast_map(lum)
    if auto:
        thr = auto_threshold(lum, cmap)
    else:
        thr = torch.tensor(contrast / 100.0, dtype=lum.dtype,
                           device=lum.device)
    blend = gauss_blur(sigmoid_blend(cmap, thr), 2.0)
    return blend[None] * rgb_sharp + (1.0 - blend[None]) * rgb_flat


def _make(sharp_name, flat_name):
    def fn(cfa, pattern, dual_contrast=20.0, dual_auto=False, **kw):
        from art_tpu_torch.demosaic import methods
        from art_tpu_torch.demosaic.bilinear import bayer_bilinear

        sharp = methods()[sharp_name](cfa, pattern, **kw)
        if not dual_auto and dual_contrast <= 0.0:
            return sharp
        if flat_name == "bilinear":
            flat = bayer_bilinear(cfa, pattern)
        else:
            flat = methods()[flat_name](cfa, pattern)
        return dual_blend(sharp, flat, dual_contrast, dual_auto)

    fn.__name__ = f"{sharp_name}{flat_name}_demosaic"
    return fn


def methods():
    """The six dual names: {amaze, rcd, dcb} x {bilinear, vng4}. The
    reference's comment that DCB's duals route to RCD is stale: its code
    runs DCB, and so does this."""
    return {f"{s}{f}": _make(s, f) for s in ("amaze", "rcd", "dcb")
            for f in ("bilinear", "vng4")}
