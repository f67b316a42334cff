"""Dehaze (counterpart of ``art_tpu/ops/dehaze.py``; ipdehaze.cc: the
dark-channel prior, guided-filter refinement of the transmission, a
luminance-only option).

Plain PyTorch. The patch minima follow XLA's reduce_window with "SAME"
padding (total max((ceil(n/k) - 1) * k + k - n, 0), the low side
total // 2, padded with +inf), as a max-pool of the negated plane over
that explicit pad. The ambient light comes from a downsample of at most
~200 px a side, with the two 95th-percentile sorts indexed as the
reference computes the index, in float32. The strength is a flat curve
over gamma-encoded luminance, fitted on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.curves import FlatCurve
from art_tpu_torch.core.curve1d import eval_curve, fit_curve
from art_tpu_torch.core.image import MAXVAL
from art_tpu_torch.ops.filters import guided_filter

PATCH = 5


def plan(pp, ctx):
    d = pp.dehaze
    if not d.enabled:
        return None
    strength_curve = FlatCurve(d.strength, periodic=False,
                               identity_value=0.5)
    x = np.linspace(0.0, 1.0, 65536)
    s = (strength_curve.get_val(cs.srgb_gamma(x)) - 0.5) * 1.3
    lum_w = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]][1]
    data = {
        "scoeffs": fit_curve(s),  # signed strength vs encoded luminance
        "lum_w": lum_w.astype(np.float32),
        "depth": np.float32(-d.depth / 100.0),
    }
    return (bool(d.luminance), bool(d.show_depth_map),
            int(d.blackpoint)), data


def _window_min(x, k):
    """reduce_window(min, (k, k), strides (k, k), "SAME") of a plane."""
    pads = []
    for n in reversed(x.shape):
        total = max((-(-n // k) - 1) * k + k - n, 0)
        pads += [total // 2, total - total // 2]
    p = F.pad(-x[None, None], pads, value=-math.inf)
    return -F.max_pool2d(p, k, k)[0, 0]


def _patch_min(x, patch):
    mn = _window_min(x, patch)
    return mn.repeat_interleave(patch, 0).repeat_interleave(patch, 1)[
        : x.shape[0], : x.shape[1]]


def _percentile95(vals, valid):
    """The reference's pick: sort ascending with the invalid entries as
    -inf, take index (invalid count) + int32(float32(0.95) * valid
    count), clipped."""
    flat = torch.where(valid, vals, -math.inf).reshape(-1)
    n = int(flat.shape[0])
    n_valid = valid.sum().to(torch.int32)
    k = (n - n_valid) + (torch.tensor(0.95, dtype=torch.float32,
                                      device=vals.device)
                         * n_valid.to(torch.float32)).to(torch.int32)
    return torch.sort(flat).values[torch.clamp(k, 0, n - 1)]


def apply(rgb, data, static):
    luminance, show_depth, _blackpoint = static
    lw = data["lum_w"]
    h, w = rgb.shape[1:]

    maxchan = torch.clamp(torch.max(rgb), min=1e-6)
    img = rgb / maxchan
    # smoothed channels (guided self-filter, eps 0.1)
    R, G, B = (guided_filter(img[c], img[c], PATCH, 0.1) for c in range(3))

    # ambient light on a downsample of about 200 px a side
    factor = max(1, min(h, w) // 200)
    RR, GG, BB = (c[::factor, ::factor] for c in (R, G, B))
    D = _window_min(torch.minimum(torch.minimum(RR, GG), BB), 2)
    darklim = _percentile95(D, (D >= 0) & (D <= 1.0 - 1e-5))
    patch_mask = (D >= darklim) & (D >= 0) & (D <= 1.0)
    pm_full = patch_mask.repeat_interleave(2, 0).repeat_interleave(2, 1)[
        : RR.shape[0], : RR.shape[1]]
    ssum = RR + GG + BB
    bright_lim = _percentile95(ssum, pm_full)
    amb_mask = pm_full & (ssum >= bright_lim)
    n = torch.clamp(amb_mask.sum().to(torch.int32), min=1).to(torch.float32)
    ambient = torch.stack([torch.where(amb_mask, c, 0.0).sum() / n
                           for c in (RR, GG, BB)])
    ambient = torch.clamp(ambient, min=1e-6)
    max_t = torch.where(darklim > 0, -1.125 * torch.log(darklim), 44.0)

    # transmission from the full-resolution dark channel over the ambient
    dark = _patch_min(torch.minimum(
        torch.minimum(R / ambient[0], G / ambient[1]), B / ambient[2]), PATCH)
    dark = torch.clamp(dark, 0.0, 1.0)

    y_lum = lw[0] * img[0] + lw[1] * img[1] + lw[2] * img[2]
    # the strength by the unnormalised luminance (the reference's
    # Y * maxchan)
    s = eval_curve(torch.clamp(y_lum * maxchan, 0, 1.0) * MAXVAL,
                   data["scoeffs"], out_max=1.0)
    add_haze = s < 0
    t_tilde = 1.0 - torch.abs(s) * dark
    t = guided_filter(img[2], t_tilde, PATCH * 4, 1e-5)

    t0 = torch.clamp(torch.exp(data["depth"] * max_t), min=1e-6)
    tl = 1.0 - torch.minimum(torch.minimum(
        img[0] / ambient[0], img[1] / ambient[1]), img[2] / ambient[2])
    mt = torch.maximum(torch.maximum(t, t0), tl + 1e-6)

    if show_depth:
        depth_img = torch.clamp(1.0 - mt, 0.0, 1.0)
        return torch.stack([depth_img] * 3) * MAXVAL
    if luminance:
        ambient_y = lw[0] * ambient[0] + lw[1] * ambient[1] \
            + lw[2] * ambient[2]
        yy = (y_lum - ambient_y) / mt + ambient_y
        yy = torch.where(add_haze, y_lum + y_lum - yy, yy)
        f = torch.where(y_lum > 1e-5, yy / torch.clamp(y_lum, min=1e-5), 1.0)
        out = img * f[None]
    else:
        amb = ambient[:, None, None]
        deh = (img - amb) / mt[None] + amb
        out = torch.where(add_haze[None], img + (img - deh), deh)
    return out * maxchan
