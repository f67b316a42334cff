"""Smoothing and blur effects (counterpart of ``art_tpu/ops/smoothing.py``;
ipsmoothing.cc), with film grain (ipgrain.cc) as its NOISE regions.

Region modes (procparams.h:1296-1306): GUIDED, GAUSSIAN, GAUSSIAN_GLOW,
NLMEANS, MOTION, LENS, NOISE, HALATION, WAVELETS, on the channels
LUMINANCE, CHROMINANCE or RGB (Y, U and V) of the normalised working
YUV, each region blended in by its mask. NLMeans runs the denoise's
(`ops/denoise.py::nl_maskinv`, `nlmeans_plane`: kernel B6 from one
256x256 tile up); the NOISE regions draw the reference's random planes
bit for bit (`core/prng.py`, the key 42 + channel + region). Plain
PyTorch but for B6.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.yuv import rgb_to_yuv, yuv_to_rgb
from art_tpu_torch.core import prng
from art_tpu_torch.core.fmath import fdiv
from art_tpu_torch.core.image import MAXVAL
from art_tpu_torch.masks import (MaskSpec, eval_mask, plan_mask,
                                 regions_from_extra)
from art_tpu_torch.ops.filters import gauss_blur, guided_filter
from art_tpu_torch.ops.wavelet import atrous_decompose, atrous_reconstruct

GROUP = "Smoothing"

FIELDS = {
    "mode": ("Mode", "i", 0),
    "channel": ("Channel", "i", 2),
    "radius": ("Radius", "i", 10),
    "sigma": ("Sigma", "f", 10.0),
    "epsilon": ("Epsilon", "i", 0),
    "iterations": ("Iterations", "i", 1),
    "falloff": ("Falloff", "f", 1.0),
    "nlstrength": ("NLStrength", "i", 50),
    "nldetail": ("NLDetail", "i", 50),
    "noise_strength": ("NoiseStrength", "i", 0),
    "noise_coarseness": ("NoiseCoarseness", "i", 0),
    "halation_size": ("HalationSize", "f", 0.5),
    "halation_color": ("HalationColor", "f", 0.0),
    "wav_strength": ("WavStrength", "i", 50),
    "wav_levels": ("WavLevels", "i", 5),
    "wav_gamma": ("WavGamma", "f", 1.0),
    "angle": ("Angle", "f", 0.0),
    "curvature": ("Curvature", "f", 0.0),
    "numblades": ("NumBlades", "i", 0),
}

MODES = ("guided", "gaussian", "glow", "nlmeans", "motion", "lens",
         "noise", "halation", "wavelets")


def plan(pp, ctx):
    # grain (ipgrain.cc) synthesizes NOISE regions through this op
    regions = regions_from_extra(pp, GROUP, FIELDS)
    regions = list(regions) if regions else []
    if pp.grain.enabled:
        iso_min, iso_max = 20, 6400
        coarseness = int(np.clip((pp.grain.iso - iso_min + 1)
                                 / (iso_max - iso_min), 0, 1) * 100 + 0.5)
        nlevels = 3
        for i in range(nlevels):
            params = {k: v[2] for k, v in FIELDS.items()}
            params["mode"] = 6  # NOISE
            params["channel"] = 0  # LUMINANCE
            params["noise_strength"] = pp.grain.strength // (nlevels - i)
            params["noise_coarseness"] = coarseness // (i + 1)
            regions.append((params, MaskSpec()))
    if not regions:
        return None
    h, w = ctx.get("op_dims") or ctx["frame"].shape
    ws = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]]
    data = {"ws": ws.astype(np.float32),
            "lum_w": ws[1].astype(np.float32)}
    statics = []
    for ridx, (params, mask) in enumerate(regions):
        mstatic, mdata = plan_mask(mask, (h, w), pp,
                                   ctx.get("device", "cpu"))
        mode = MODES[min(params["mode"], len(MODES) - 1)]
        data[f"sm{ridx}"] = {
            "mask": mdata,
            "sigma": np.float32(max(params["sigma"], 0.1)),
            "falloff": np.float32(max(params["falloff"], 1e-3)),
            "nl_h2": np.float32(((params["nlstrength"] / 100.0) ** 0.9
                                 / 10.0) ** 2),
            "nl_detail": np.float32(np.clip(params["nldetail"] / 100.0,
                                            0, 0.99)),
            "noise_sf": np.float32(
                np.clip(params["noise_strength"]
                        / (200.0 if params["channel"] == 0 else 100.0),
                        0, 1)),
            "noise_radius": np.float32(
                0.5 + 1.75 * params["noise_coarseness"] / 100.0),
            "hal_color": np.float32(
                np.clip(params["halation_color"] + 0.5, 0, 1)),
            "wav_strength": np.float32(params["wav_strength"] / 100.0),
        }
        statics.append((
            mode, int(params["channel"]),
            max(int(params["radius"]), 1),
            float(max(0.001 * 2.0 ** (-params["epsilon"]), 1e-6)),
            max(int(params["iterations"]), 1),
            int(50 * params["halation_size"]),
            int(params["wav_levels"]),
            float(max(params["sigma"], 0.1)),
            float(max(params["falloff"], 1e-3)),
            float(0.5 + 1.75 * params["noise_coarseness"] / 100.0),
            mstatic, ridx,
        ))
    return tuple(statics), data


def _per_channel(fn, y, u, v, channel):
    """channel: 0=LUMINANCE 1=CHROMINANCE 2=RGB."""
    if channel == 0:
        return fn(y), u, v
    if channel == 1:
        return y, fn(u), fn(v)
    return fn(y), fn(u), fn(v)


def _disc_kernel_blur(x, radius):
    """A flat disc of `radius` with a one-pixel linear rim, normalised,
    as shift-multiply-adds over a reflect pad in tap order
    (smoothing.py::_disc_kernel_blur)."""
    r = max(int(np.ceil(radius)), 1)
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    d = np.sqrt(ys * ys + xs * xs) - radius
    k = np.where(d < 0, 1.0, np.maximum(1.0 - d, 0.0)).astype(np.float32)
    k /= k.sum()
    p = F.pad(x[None, None], (r, r, r, r), mode="reflect")[0, 0]
    h, w = x.shape
    out = None
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            wgt = float(k[dy, dx])
            if wgt == 0.0:
                continue
            piece = wgt * p[dy : dy + h, dx : dx + w]
            out = piece if out is None else out + piece
    return out


def _nlmeans(c, p, iterations):
    from art_tpu_torch.ops.denoise import nl_maskinv, nlmeans_plane

    for _ in range(iterations):
        c = nlmeans_plane(c, nl_maskinv(c, p["nl_h2"], p["nl_detail"]))
    return c


def apply(rgb, data, static):
    ws, lw = data["ws"], data["lum_w"]
    x01 = fdiv(rgb, MAXVAL)
    for (mode, channel, radius, epsilon, iterations, hal_size,
         wav_levels, sigma, falloff, noise_radius, mstatic, ridx) in static:
        p = data[f"sm{ridx}"]
        mask = eval_mask(rgb, ws, mstatic, p["mask"])
        y, u, v = rgb_to_yuv(x01, lw)

        if mode == "guided":
            def gf(c):
                for _ in range(iterations):
                    c = guided_filter(c, c, radius, epsilon)
                return c

            y, u, v = _per_channel(gf, y, u, v, channel)
        elif mode == "glow":
            # iterative blur and falloff blend (ipsmoothing.cc:1015-1038)
            base_y, base_u, base_v = y, u, v
            sig = sigma
            for i in range(iterations):
                f = falloff ** i
                f2 = 1.0 + 1.0 / f
                y = fdiv(base_y + fdiv(gauss_blur(y, sig), f), f2)
                u = fdiv(base_u + fdiv(gauss_blur(u, sig), f), f2)
                v = fdiv(base_v + fdiv(gauss_blur(v, sig), f), f2)
                sig *= 1.5
        elif mode == "gaussian":
            def gb(c):
                for _ in range(iterations):
                    c = gauss_blur(c, sigma)
                return c

            y, u, v = _per_channel(gb, y, u, v, channel)
        elif mode == "nlmeans":
            y, u, v = _per_channel(lambda c: _nlmeans(c, p, iterations),
                                   y, u, v, channel)
        elif mode in ("motion", "lens"):
            y, u, v = _per_channel(
                lambda c: _disc_kernel_blur(c, max(radius, 2)), y, u, v,
                channel)
        elif mode == "noise":
            noise = prng.normal(prng.key(42 + channel + ridx),
                                tuple(y.shape), y.device)
            noise = _disc_kernel_blur(noise, noise_radius)
            noise = noise / torch.clamp(torch.std(noise, correction=0),
                                        min=1e-6)
            amp = p["noise_sf"] * 0.05
            if channel == 1:
                u = u + noise * amp
                v = v + torch.roll(noise, 7, dims=0) * amp
            else:
                y = y * (1.0 + noise * amp)
        elif mode == "halation":
            if hal_size > 0:
                glow_y = _disc_kernel_blur(torch.clamp(y, min=0.0),
                                           max(hal_size, 2))
                add = torch.clamp(glow_y - y, min=0.0)
                tint = torch.stack([add, add * p["hal_color"],
                                    add * p["hal_color"] * 0.5])
                y, u, v = rgb_to_yuv(yuv_to_rgb(y, u, v, lw) + tint, lw)
        elif mode == "wavelets":
            def wv(c):
                details, resid = atrous_decompose(c, max(wav_levels, 1))
                return atrous_reconstruct(
                    [d * (1.0 - p["wav_strength"]) for d in details], resid)

            y, u, v = _per_channel(wv, y, u, v, channel)

        sm = yuv_to_rgb(y, u, v, lw)
        x01 = sm * mask[None] + x01 * (1.0 - mask[None])
    return x01 * MAXVAL
