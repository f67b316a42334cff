"""Colour correction (counterpart of ``art_tpu/ops/colorcorrection.py``;
ipcolorcorrection.cc).

Per region of the `.arp` "ColorCorrection" group's suffixed keys: an
ASC-CDL slope, offset, power and pivot with log compression, in one of
the modes YUV, RGB, HSL (hue and saturation wheels per channel) or
Jzazbz, a hue shift, the a/b wheel and the input and output saturation,
in working-space YUV, blended in by the region's mask. Plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color import jzazbz as jzmod
from art_tpu_torch.color.yuv import rgb_to_yuv, yuv_to_rgb
from art_tpu_torch.core.fmath import fdiv, mat3
from art_tpu_torch.core.image import MAXVAL
from art_tpu_torch.masks import MaskSpec, eval_mask, plan_mask
from art_tpu_torch.params.keyfile import KeyFile

GROUP = "ColorCorrection"


def _kf_from_extra(pp):
    kf = KeyFile()
    if GROUP in pp.extra:
        kf.groups[GROUP] = dict(pp.extra[GROUP])
    return kf


def _log2lin(x, base):
    return np.sign(x) * (np.power(base, abs(x)) - 1.0) / (base - 1.0)


def plan(pp, ctx):
    kf = _kf_from_extra(pp)
    if GROUP not in kf.groups or not kf.get_bool(GROUP, "Enabled", False):
        return None
    ws = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]]
    h, w = ctx.get("op_dims") or ctx["frame"].shape

    regions = []
    data = {"ws_lum": ws[1].astype(np.float32),
            "ws": ws.astype(np.float32),
            "iws": np.linalg.inv(ws).astype(np.float32)}
    j = 1
    while kf.has(GROUP, f"Mode_{j}") or kf.has(GROUP, f"Slope_{j}") or (
            j == 1 and kf.has(GROUP, "A_1")):
        sfx = f"_{j}"
        mode = kf.get_string(GROUP, "Mode" + sfx, "Jzazbz")
        a = kf.get_float(GROUP, "A" + sfx, 0.0)
        b = kf.get_float(GROUP, "B" + sfx, 0.0)
        in_sat = kf.get_float(GROUP, "InSaturation" + sfx, 0.0)
        out_sat = kf.get_float(GROUP, "OutSaturation" + sfx, 0.0)
        hueshift = kf.get_float(GROUP, "HueShift" + sfx, 0.0)
        rgbl = kf.get_bool(GROUP, "RGBLuminance" + sfx, False)

        rgbmode = mode in ("RGB", "HSL")
        slope = np.ones(3)
        offset = np.zeros(3)
        power = np.ones(3)
        pivot = np.ones(3)
        compression = np.zeros((3, 2))
        if mode == "HSL":
            # hue/sat wheels -> per-channel slope/offset/power
            # (ipcolorcorrection.cc:305-340)
            for c, nameof in enumerate(("Slope", "Offset", "Power")):
                hdeg = kf.get_float(GROUP, f"{nameof}H" + sfx, 0.0)
                sv = kf.get_float(GROUP, f"{nameof}S" + sfx, 0.0)
                fv = kf.get_float(GROUP, f"{nameof}L" + sfx, 0.0)
                hue = hdeg / 360.0
                sat = (sv / 100.0) ** 2.5
                f = fv / 100.0 + 1.0
                u = sat * np.cos(2 * np.pi * hue)
                v = sat * np.sin(2 * np.pi * hue)
                B = 0.5 - u
                R = v + 0.5
                G = (0.5 - R * ws[1][0] - B * ws[1][2]) / ws[1][1]
                RGB = np.array([R, G, B]) * 2.0
                if c == 0:
                    slope = RGB * f
                elif c == 1:
                    offset = RGB + f - 2.0
                else:
                    power = (2.0 - RGB) * (2.0 - f)
        else:
            def getv(name, dflt):
                single = kf.get_float(GROUP, name + sfx, dflt)
                out = []
                for ch in "RGB":
                    out.append(kf.get_float(GROUP, name + ch + sfx, single))
                return np.array(out)

            slope = getv("Slope", 1.0)
            offset = getv("Offset", 0.0)
            powr = getv("Power", 1.0)
            power = 1.0 / np.maximum(powr, 1e-6)
            pivot = getv("Pivot", 1.0)
            compr = getv("Compression", 0.0) * 100.0
            for c in range(3):
                if compr[c] > 0:
                    y0 = (np.power((slope[c] + offset[c]) / pivot[c],
                                   power[c]) * pivot[c])
                    compression[c] = (compr[c],
                                      np.log(1.0 + y0 * compr[c]) / slope[c])
            if not rgbmode:
                slope = np.full(3, slope[0])
                offset = np.full(3, offset[0])
                power = np.full(3, power[0])
                pivot = np.full(3, pivot[0])
                compression = np.stack([compression[0]] * 3)

        # ab wheel (abcoord2): log warp then hue/sat to uv
        aa = _log2lin(a, 4.0)
        bb = _log2lin(b, 4.0)
        hh = np.arctan2(bb, aa) / (2 * np.pi)
        ss = np.hypot(aa, bb)
        abcb = ss * np.cos(2 * np.pi * hh)  # u component
        abca = ss * np.sin(2 * np.pi * hh)  # v component

        mask = MaskSpec.from_keyfile(kf, GROUP, sfx)
        mstatic, mdata = plan_mask(mask, (h, w), pp,
                                   ctx.get("device", "cpu"))

        ridx = len(regions)
        data[f"cc{ridx}"] = {
            "slope": slope.astype(np.float32),
            "offset": (offset / 2.0).astype(np.float32),
            "power": power.astype(np.float32),
            "pivot": pivot.astype(np.float32),
            "compr": compression.astype(np.float32),
            "in_sat": np.float32(1.0 + in_sat / 100.0),
            "out_sat": np.float32(1.0 + out_sat / 100.0),
            "hueshift": np.float32(np.radians(hueshift)
                                   if mode != "RGB" else 0.0),
            "ab": np.array([abca, abcb], dtype=np.float32),
            "hsl_gamma": np.float32(
                kf.get_float(GROUP, "HSLGamma" + sfx, 2.4)),
            "mask": mdata,
        }
        regions.append((mode, rgbl, mstatic))
        j += 1
    if not regions:
        return None
    return tuple(regions), data


def _cdl(val, p, c):
    """slope, offset, power about the pivot, then the log compression of
    channel c (ipcolorcorrection.cc)."""
    val = val * p["slope"][c] + p["offset"][c]
    pw = torch.pow(torch.clamp(val / p["pivot"][c], min=1e-12),
                   p["power"][c]) * p["pivot"][c]
    val = torch.where(val > 0, pw, 0.0)
    c0, c1 = p["compr"][c][0], p["compr"][c][1]
    return torch.where(c0 != 0, torch.log(torch.clamp(val, min=0.0) * c0
                                          + 1.0)
                       / torch.where(c1 != 0, c1, 1.0), val)


def _cdl_rgbmode(y, u, v, p, lw, mode, rgbl):
    u = u * p["in_sat"]
    v = v * p["in_sat"]
    rgb = yuv_to_rgb(y, u, v, lw)
    vout = []
    for c in range(3):
        val = fdiv(rgb[c], MAXVAL)
        if mode == "HSL":
            val = torch.where(val > 0, torch.pow(torch.clamp(
                val, min=1e-9), 1.0 / p["hsl_gamma"]), val)
        val = _cdl(val, p, c)
        if mode == "HSL":
            val = torch.where(val > 0, torch.pow(torch.clamp(
                val, min=1e-9), p["hsl_gamma"]), val)
        vout.append(val * MAXVAL)
    new_rgb = torch.stack(vout)
    if rgbl:
        old = yuv_to_rgb(y, u, v, lw)
        f3 = torch.max(lw) / lw
        mixed = old + (new_rgb - old) * f3[:, None, None]
        y1 = lw[0] * mixed[0] + lw[1] * mixed[1] + lw[2] * mixed[2]
        f = torch.where(y > 0, y1 / torch.clamp(y, min=1e-9), 1.0)
        u, v = u * f, v * f
        y = y1
    else:
        y, u, v = rgb_to_yuv(new_rgb, lw)
    fmax = torch.clamp(y, min=0.0)
    u = (u + fmax * p["ab"][1]) * p["out_sat"]
    v = (v + fmax * p["ab"][0]) * p["out_sat"]
    return y, u, v


def _cdl_yuvmode(y, u, v, p, ws, iws, is_jz):
    yy = _cdl(fdiv(y, MAXVAL), p, 0) * MAXVAL
    f = torch.where(y > 0, yy / torch.clamp(y, min=1e-9), 1.0)
    y2, u2, v2 = yy, u * f, v * f
    if is_jz:
        rgb = yuv_to_rgb(y2, u2, v2, ws[1])
        xyz = [sum(fdiv(ws[i, c] * rgb[c], MAXVAL) for c in range(3))
               for i in range(3)]
        jz, az, bz = jzmod.xyz_to_jzazbz(*xyz)
        y2, v2, u2 = jz, az, bz
    fmax = torch.clamp(y2, min=0.0)
    u2 = (u2 * p["in_sat"] + fmax * p["ab"][1]) * p["out_sat"]
    v2 = (v2 * p["in_sat"] + fmax * p["ab"][0]) * p["out_sat"]
    if is_jz:
        rgb = mat3(iws, jzmod.jzazbz_to_xyz(y2, v2, u2))
        y2, u2, v2 = rgb_to_yuv(rgb * MAXVAL, ws[1])
    return y2, u2, v2


def _hueshift(y, u, v, hs):
    h = torch.atan2(v, u) + hs
    s = torch.hypot(u, v)
    return y, s * torch.cos(h), s * torch.sin(h)


def apply(rgb, data, static):
    ws, iws, lw = data["ws"], data["iws"], data["ws_lum"]
    y, u, v = rgb_to_yuv(rgb, lw)
    for ridx, (mode, rgbl, mstatic) in enumerate(static):
        p = data[f"cc{ridx}"]
        mask = eval_mask(rgb, ws, mstatic, p["mask"])
        y2, u2, v2 = y, u, v
        if mode != "RGB":
            y2, u2, v2 = _hueshift(y2, u2, v2, p["hueshift"])
        if mode in ("RGB", "HSL"):
            y2, u2, v2 = _cdl_rgbmode(y2, u2, v2, p, lw, mode, rgbl)
        else:
            y2, u2, v2 = _cdl_yuvmode(y2, u2, v2, p, ws, iws,
                                      mode == "Jzazbz")
        y = mask * y2 + (1 - mask) * y
        u = mask * u2 + (1 - mask) * u
        v = mask * v2 + (1 - mask) * v
    return yuv_to_rgb(y, u, v, lw)
