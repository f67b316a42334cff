"""Spot removal (counterpart of ``art_tpu/ops/spot.py``; ipspot.cc,
procparams.h SpotEntry:1144).

Each spot heals a feathered circular window from a source position onto
its target with the GIMP heal (ipspot.cc:85 heal_laplace_loop, :154
heal): the detail-weighted difference w * (dst - src) is relaxed toward
a harmonic fill inside the feather circle, then src + diff is blended
over the target with an opacity that falls off as a gaussian out to the
feather radius. The reference's in-place SOR sweep (omega = 1.4) is
red-black SOR over the whole window, its neighbours taken with a roll,
so the window wraps at its edges as the reference's does, with the same
budget min(2 * size, 1000) sweeps. The entries apply in order, each on
the image the previous ones healed. Plain PyTorch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_OMEGA = 1.4  # SOR overrelaxation (ipspot.cc:95)
_MAX_ITER = 1000


def _entry_window(e, h, w):
    """Static geometry for one spot entry, clamped to the true image."""
    fr = int(math.ceil(e.radius * (1.0 + e.feather))) + 1
    size = 2 * fr + 1

    def clamp(cx, cy):
        x0 = min(max(int(cx) - fr, 0), max(w - size, 0))
        y0 = min(max(int(cy) - fr, 0), max(h - size, 0))
        return y0, x0

    sy, sx = clamp(e.source_x, e.source_y)
    ty, tx = clamp(e.target_x, e.target_y)
    return sy, sx, ty, tx, size, fr


def plan(pp, ctx):
    sp = getattr(pp, "spot", None)
    if sp is None or not sp.enabled or not sp.entries:
        return None
    frame = ctx["frame"]
    if frame.is_raw:
        h, w = frame.cfa.shape
    else:
        h, w = frame.rgb.shape[-2:]

    statics = []
    masks = []
    for e in sp.entries:
        if e.radius <= 0:
            continue
        sy, sx, ty, tx, size, fr = _entry_window(e, h, w)
        if size > min(h, w):
            continue
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        r = np.sqrt((yy - fr) ** 2 + (xx - fr) ** 2)
        feather_r = e.radius * (1.0 + e.feather)
        # sigma so the falloff hits ~0.5% at the feather radius
        # (find_sigma, ipspot.cc:37)
        span = max(feather_r - e.radius, 1e-3)
        sigma = span * span / math.log(200.0)
        fall = np.exp(-np.maximum(r - e.radius, 0.0) ** 2 / sigma)
        blend = np.where(r <= e.radius, 1.0, fall)
        blend = np.where(r <= feather_r, blend, 0.0) * float(e.opacity)

        # detail weight on the seeded difference (ipspot.cc:182):
        # w = 1 - clip01(radius - r)/radius ** (0.125*(detail+1))
        detail_exp = 0.125 * (float(e.detail) + 1.0)
        wdet = 1.0 - np.power(
            np.clip(e.radius - r, 0.0, 1.0) / max(e.radius, 1), detail_exp)
        heal = (r <= feather_r)  # PDE domain (ipspot.cc:181 mask)
        # checkerboard parity for the red-black half sweeps
        red = ((yy + xx).astype(np.int32) % 2) == 0
        iters = min(2 * size, _MAX_ITER)

        statics.append((sy, sx, ty, tx, size, iters))
        masks.append((blend.astype(np.float32)[None],
                      wdet.astype(np.float32)[None],
                      (heal & red).astype(np.float32)[None],
                      (heal & ~red).astype(np.float32)[None]))
    if not statics:
        return None
    blends, wdets, reds, blacks = zip(*masks)
    return tuple(statics), {"blends": list(blends), "wdets": list(wdets),
                            "reds": list(reds), "blacks": list(blacks)}


def _heal_laplace(diff, red, black, iters):
    """Red-black SOR Laplace relaxation of the masked window
    (spot.py::_heal_laplace)."""
    w1 = 1.0 - _OMEGA
    w2 = _OMEGA / 4.0

    def half(d, par):
        lap = (torch.roll(d, 1, dims=-2) + torch.roll(d, -1, dims=-2)
               + torch.roll(d, 1, dims=-1) + torch.roll(d, -1, dims=-1))
        upd = d * w1 + lap * w2
        return d + (upd - d) * par

    for _ in range(iters):
        diff = half(half(diff, red), black)
    return diff


def apply(rgb, data, static):
    out = rgb.clone()
    for (sy, sx, ty, tx, size, iters), blend, wdet, red, black in zip(
            static, data["blends"], data["wdets"], data["reds"],
            data["blacks"]):
        src = out[:, sy : sy + size, sx : sx + size]
        tgt = out[:, ty : ty + size, tx : tx + size]
        diff = _heal_laplace(wdet * (tgt - src), red, black, iters)
        healed = src + diff
        result = tgt + (healed - tgt) * blend
        out[:, ty : ty + size, tx : tx + size] = result
    return out
