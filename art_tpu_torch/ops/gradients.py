"""Creative gradients (counterpart of ``art_tpu/ops/gradients.py``;
iptransform.cc: calcGradientFactor :761, calcPCVignetteFactor :905,
calcVignettingParams :648): the graduated filter, the post-crop
vignette and the vignetting filter, multiplicative factor fields over
the pixel coordinates of the image the op meets (``ctx["op_dims"]``,
after rotation and crop). The planner fixes the scalar geometry, the
device evaluates the fields. Plain PyTorch.
"""

from __future__ import annotations

import math

import numpy as np
import torch


_PI = np.pi


def plan(pp, ctx):
    g = pp.gradient
    pcv = pp.pcvignette
    vig = pp.vignetting
    use_g = g.enabled and abs(g.strength) > 1e-6
    use_p = pcv.enabled and abs(pcv.strength) > 1e-6
    use_v = vig.enabled and vig.amount != 0
    if not (use_g or use_p or use_v):
        return None
    h, w = ctx.get("op_dims") or ctx["frame"].shape
    data = {}
    if use_g:
        data.update(_plan_gradient(g, w, h))
    if use_p:
        data.update(_plan_pcv(pcv, w, h))
    if use_v:
        x = vig.centerX / 100.0
        y = vig.centerY / 100.0
        v = 1.0 + vig.strength * abs(vig.amount) * 3.0 / 400.0
        b = 1.0 + vig.radius * 7.0 / 100.0
        data.update({
            "vig_w2": np.float32(w / 2.0 - 0.5 + x * w),
            "vig_h2": np.float32(h / 2.0 - 0.5 + y * h),
            "vig_maxr": np.float32(np.hypot(w, h) / 2.0),
            "vig_v": np.float32(v),
            "vig_b": np.float32(b),
            "vig_mul": np.float32((1.0 - v) / np.tanh(b)),
        })
    pcv_super = False
    pcv_portrait = False
    if use_p:
        pcv_super = (pcv.roundness / 100.0) < 0.5
        pcv_portrait = w < h
    grad_transpose = False
    grad_bright = False
    if use_g:
        grad_transpose = bool(data["g_flags"][0])
        grad_bright = bool(data["g_flags"][1])
    return (use_g, use_p, use_v, vig.amount < 0 if use_v else False,
            pcv_super, pcv_portrait, grad_transpose, grad_bright), data


def _plan_gradient(g, w, h):
    """calcGradientParams (iptransform.cc:677-758)."""
    stops = g.strength
    span = g.feather / 100.0
    cx = g.centerX / 200.0 + 0.5
    cy = g.centerY / 200.0 + 0.5
    angle = np.fmod(g.degree / 180.0 * _PI, 2 * _PI)
    if angle < 0:
        angle += 2 * _PI
    transpose = False
    bright_top = False
    if abs(np.cos(angle)) < 0.707:
        transpose = True
        angle += 0.5 * _PI
        cx, cy = 1.0 - cy, cx
    angle = np.fmod(angle, 2 * _PI)
    if 0.5 * _PI < angle < _PI:
        angle += _PI
        bright_top = True
    elif _PI <= angle < 1.5 * _PI:
        angle -= _PI
        bright_top = True
    angle_is_zero = abs(angle) < 0.001 or abs(angle - 2 * _PI) < 0.001
    if transpose:
        bright_top = not bright_top
        w, h = h, w
    scale = 1.0 / 2 ** stops
    topmul, botmul = (1.0, scale) if bright_top else (scale, 1.0)
    ys = np.sqrt(float(h * h + w * w)) * (span / np.cos(angle))
    ys_inv = 1.0 / ys if ys >= 1.0 / h else 0.0
    if ys < 1.0 / h:
        ys = 0.0
    return {
        "g_ta": np.float32(np.tan(angle)),
        "g_xc": np.float32(w * cx),
        "g_yc": np.float32(h * cy),
        "g_ys": np.float32(ys),
        "g_ys_inv": np.float32(ys_inv),
        "g_scale": np.float32(scale),
        "g_topmul": np.float32(topmul),
        "g_botmul": np.float32(botmul),
        "g_top_edge0": np.float32(h * cy - ys / 2.0),
        "g_flags": np.array([transpose, bright_top, angle_is_zero, h],
                            dtype=np.float32),
    }


def _plan_pcv(pcv, w, h):
    """calcPCVignetteParams (iptransform.cc:828-900), no-crop case."""
    roundness = pcv.roundness / 100.0
    feather = pcv.feather / 100.0
    ew, eh = w, h
    dW = pcv.centerX / 200.0 * ew
    dH = pcv.centerY / 200.0 * eh
    ex, ey = dW, dH
    x2 = ew + abs(dW)
    y2 = eh + abs(dH)
    fadeout_mul = 1.0 / (0.05 * np.sqrt(w * w + h * h))
    short_side = min(ew, eh)
    long_side = max(ew, eh)
    sep = 2
    sepmix = 0.0
    oe_a = np.sqrt(2.0) * long_side * 0.5
    oe_b = oe_a * short_side / long_side
    ie_mul = (1.0 / np.sqrt(2.0)) * (1.0 - feather)
    is_super = False
    oe1 = oe2 = (0.0, 0.0)
    ie1_mul = ie2_mul = 0.0
    if roundness < 0.5:
        is_super = True
        sepf = 2 + 4 * (1.0 - 2 * roundness) ** 1.3
        sep = int(sepf) & ~0x1
        sepmix = (sepf - sep) * 0.5
        oe1_a = 2.0 ** (1.0 / sep) * long_side * 0.5
        oe1 = (oe1_a, oe1_a * short_side / long_side)
        ie1_mul = (1.0 / 2.0 ** (1.0 / sep)) * (1.0 - feather)
        oe2_a = 2.0 ** (1.0 / (sep + 2)) * long_side * 0.5
        oe2 = (oe2_a, oe2_a * short_side / long_side)
        ie2_mul = (1.0 / 2.0 ** (1.0 / (sep + 2))) * (1.0 - feather)
    if roundness > 0.5:
        rad = np.sqrt(ew * ew + eh * eh) / 2.0
        oe_a += (rad - oe_a) * 2 * (roundness - 0.5)
        oe_b += (rad - oe_b) * 2 * (roundness - 0.5)
    scale = 2.0 ** (-pcv.strength)
    if pcv.strength >= 6.0:
        scale = 0.0
    return {
        "p_geom": np.array([ex, ey, ew, eh, x2, y2, fadeout_mul],
                           dtype=np.float32),
        "p_oe": np.array([oe_a, oe_b, ie_mul, scale, sepmix],
                         dtype=np.float32),
        "p_super": np.array(list(oe1) + list(oe2) + [ie1_mul, ie2_mul,
                                                     float(sep)],
                            dtype=np.float32),
        "p_flags": np.array([is_super, ew < eh], dtype=np.float32),
    }


def _shape_val(scale, val01):
    """The sin^3 / cos^3 shaping of the gradient's ramp."""
    v = val01 * (math.pi / 2.0)
    return torch.where(scale < 1.0, torch.sin(v) ** 3,
                       1.0 - torch.cos(v) ** 3)


def apply(rgb, data, static):
    (use_g, use_p, use_v, vig_darkening, pcv_super, pcv_portrait,
     grad_transpose, grad_bright) = static
    h, w = rgb.shape[1:]
    yy = torch.arange(h, dtype=rgb.dtype, device=rgb.device)[:, None] \
        * torch.ones((1, w), dtype=rgb.dtype, device=rgb.device)
    xx = torch.arange(w, dtype=rgb.dtype, device=rgb.device)[None, :] \
        * torch.ones((h, 1), dtype=rgb.dtype, device=rgb.device)
    factor = torch.ones((h, w), dtype=rgb.dtype, device=rgb.device)

    if use_v:
        r = torch.hypot(xx - data["vig_w2"], yy - data["vig_h2"])
        f = data["vig_v"] + data["vig_mul"] * torch.tanh(
            data["vig_b"] * (data["vig_maxr"] - r) / data["vig_maxr"])
        if vig_darkening:
            factor = factor / torch.clamp(f, min=0.001)
        else:
            factor = factor * f

    if use_g:
        gh = data["g_flags"][3]
        gy = xx if grad_transpose else yy
        gx = (gh - yy - 1.0) if grad_transpose else xx
        top_edge = data["g_top_edge0"] - data["g_ta"] * (gx - data["g_xc"])
        val = (gy - top_edge) * data["g_ys_inv"]
        if grad_bright:
            val = 1.0 - val
        shaped = _shape_val(data["g_scale"], torch.clamp(val, 0.0, 1.0))
        mid = data["g_scale"] + shaped * (1.0 - data["g_scale"])
        f = torch.where(gy < top_edge, data["g_topmul"],
                        torch.where(gy >= top_edge + data["g_ys"],
                                    data["g_botmul"], mid))
        factor = factor * f

    if use_p:
        geom, oe, sup = data["p_geom"], data["p_oe"], data["p_super"]
        ex, ey, ew, eh, x2, y2, fadeout_mul = (geom[i] for i in range(7))
        a = torch.abs((xx - ex) - ew * 0.5)
        b = torch.abs((yy - ey) - eh * 0.5)
        if pcv_portrait:
            a, b = b, a
        dist = torch.hypot(a, b)
        dsafe = torch.clamp(dist, min=1e-9)
        cosv = torch.where(dist > 0, a / dsafe, 1.0)
        sinv = torch.where(dist > 0, b / dsafe, 0.0)
        if pcv_super:
            sep = sup[6]

            def normn(u, v, n):
                return torch.pow(torch.pow(torch.abs(u), n)
                                 + torch.pow(torch.abs(v), n), 1.0 / n)

            d_oe1 = sup[0] * sup[1] / normn(sup[1] * cosv, sup[0] * sinv,
                                            sep)
            d_oe2 = sup[2] * sup[3] / normn(sup[3] * cosv, sup[2] * sinv,
                                            sep + 2)
            dist_oe = d_oe1 * (1 - oe[4]) + d_oe2 * oe[4]
            dist_ie = sup[4] * d_oe1 * (1 - oe[4]) + sup[5] * d_oe2 * oe[4]
        else:
            dist_oe = oe[0] * oe[1] / torch.sqrt(
                (oe[1] * cosv) ** 2 + (oe[0] * sinv) ** 2)
            dist_ie = oe[2] * dist_oe
        scale = oe[3]
        val01 = torch.clamp((dist - dist_ie) / torch.clamp(
            dist_oe - dist_ie, min=1e-9), 0.0, 1.0)
        v = val01 * (math.pi / 2.0)
        shaped = torch.where(scale < 1.0, torch.cos(v) ** 4,
                             1.0 - torch.sin(v) ** 4)
        val = scale + shaped * (1.0 - scale)
        val = torch.where(dist <= dist_ie, 1.0,
                          torch.where(dist >= dist_oe, scale, val))
        # fadeout outside the crop box
        dist_x = torch.clamp(torch.maximum(-xx, xx - x2), min=0.0)
        dist_y = torch.clamp(torch.maximum(-yy, yy - y2), min=0.0)
        fo = torch.hypot(dist_x, dist_y) * fadeout_mul
        val = torch.where(fo >= 1.0, 1.0,
                          torch.where(fo > 0, fo + val * (1.0 - fo), val))
        factor = factor * val

    return rgb * factor[None]
