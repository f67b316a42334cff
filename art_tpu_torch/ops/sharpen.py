"""Sharpening: USM and Richardson-Lucy deconvolution (counterpart of
``art_tpu/ops/sharpen.py``; ipsharpen.cc).

On the working-space luminance, blended by the contrast mask (a sigmoid
of the 4-direction gradient norm against the contrast threshold):
- "rld": 20 RL iterations I <- I * G(L / G(I)) with the reference's
  per-pixel divergence stop as a running freeze mask;
- "usm": an unsharp mask in the gamma-3 domain with the 4-point
  threshold ramp;
- "psf": RL with a measured PSF from a JSON file (a flat n^2 list or a
  matrix), its two convolutions per iteration as `conv2d` over edge
  pads, frozen where |log(est / L)| passes 0.3. A PSF image file needs an
  image decoder (PIL in the reference) and is refused.
The same op runs after the resize as post-resize sharpening (`plan_pr`).
Plain PyTorch, in the reference's operation order.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.yuv import rgb_to_yuv, yuv_to_rgb
from art_tpu_torch.core.fmath import fdiv, rdiv
from art_tpu_torch.core.image import MAXVAL
from art_tpu_torch.ops.filters import gauss_blur


def _plan(sp, ctx, lum_w):
    if not sp.enabled:
        return None
    data = {
        "lum_w": lum_w.astype(np.float32),
        "amount": np.float32(sp.deconv_amount / 100.0
                             if sp.method == "rld" else sp.amount / 100.0),
        "contrast": np.float32(max(sp.contrast, 0.0) / 100.0),
        "thresh": np.array(list(sp.threshold) + [20, 80, 2000, 1200])[:4]
        .astype(np.float32),
    }
    if sp.method == "rld":
        radius = float(max(sp.deconv_radius, 0.2))
        if getattr(sp, "deconv_auto_radius", False):
            from art_tpu_torch.pipeline.autos import deconv_auto_radius

            frame = ctx.get("frame")
            est = deconv_auto_radius(frame) if frame is not None else None
            if est is not None:
                radius = est
                from art_tpu_torch.pipeline.listeners import report_auto

                report_auto("deconv_radius", float(est))
        static = ("rld", radius, 20)
    elif sp.method == "psf":
        kern = load_psf_kernel(sp.psf_kernel,
                               scale=float(ctx.get("scale", 1.0) or 1.0))
        if kern is None:
            return None  # no file, or an invalid kernel: the op is skipped
        data["psf"] = kern
        data["amount"] = np.float32(1.0)
        static = ("psf", int(kern.shape[0]), int(max(sp.psf_iterations, 1)))
    else:
        static = ("usm", float(max(sp.radius, 0.2)), 0)
    return static, data


def load_psf_kernel(path, scale=1.0):
    """A PSF kernel from a JSON file (a flat n^2 list or a matrix) or a
    square, odd-sized image (its green channel, through the port's
    decoder, `io/imagefile.py::read_rgb8`), normalised and rescaled to
    the processing scale (sharpen.py::load_psf_kernel, import_kernel and
    rescale_kernel, ipsharpen.cc:347-495): (k, k) float32, or None for a
    missing file or an invalid kernel. An image format the decoder does
    not read raises NotImplementedError naming it."""
    if not path or not os.path.exists(path):
        return None
    k = None
    try:
        with open(path, "rb") as f:
            head = f.read(32)
    except OSError:
        return None
    try:
        if head.lstrip()[:1] == b"[":
            with open(path) as f:
                arr = np.asarray(json.load(f), np.float32)
            if arr.ndim == 1:
                n = int(round(arr.size ** 0.5))
                if n * n != arr.size or n < 2:
                    return None
                k = arr.reshape(n, n)
            elif arr.ndim == 2 and arr.shape[0] == arr.shape[1]:
                k = arr
        else:
            from art_tpu_torch.io.imagefile import read_rgb8

            img = read_rgb8(path).astype(np.float32)
            if img.shape[0] == img.shape[1] and img.shape[0] % 2 == 1:
                k = img[:, :, 1]
    except NotImplementedError as e:
        from art_tpu_torch.io.textures import BLPFormatError

        if not isinstance(e, BLPFormatError):  # Pillow's own, which the
            raise  # reference's except takes
        return None
    except Exception:
        return None
    if k is None or k.shape[0] % 2 == 0:
        return None
    kw = int(k.shape[0] / scale) | 1
    if kw < 3:
        return None
    if kw != k.shape[0]:
        sh = k.shape[0] // 2
        h = kw // 2
        s = k.shape[0] / kw
        yy, xx = np.mgrid[-h : h + 1, -h : h + 1].astype(np.float32) * s

        def samp(y, x):  # rescale_kernel's mirrored bilinear get()
            ya, xa = np.abs(y), np.abs(x)
            yi, xi = ya.astype(int), xa.astype(int)
            yf, xf = ya - yi, xa - xi
            yi1 = np.minimum(yi + 1, sh)
            xi1 = np.minimum(xi + 1, sh)
            yi, yi1 = np.where(y < 0, -yi, yi), np.where(y < 0, -yi1, yi1)
            xi, xi1 = np.where(x < 0, -xi, xi), np.where(x < 0, -xi1, xi1)
            bl = k[yi + sh, xi + sh]
            br = k[yi + sh, xi1 + sh]
            tl = k[yi1 + sh, xi + sh]
            tr = k[yi1 + sh, xi1 + sh]
            return (1 - yf) * ((1 - xf) * bl + xf * br) \
                + yf * ((1 - xf) * tl + xf * tr)

        k = samp(yy, xx)
    s = float(k.sum())
    if s >= 1e-5:
        k = k / s
    else:
        k = np.zeros_like(k)
        k[k.shape[0] // 2, k.shape[1] // 2] = 1.0
    return k.astype(np.float32)


def plan(pp, ctx):
    lum_w = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]][1]
    return _plan(pp.sharpening, ctx, lum_w)


def plan_pr(pp, ctx):
    """Post-resize sharpening (the OutputSharpening group)."""
    lum_w = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]][1]
    return _plan(pp.pr_sharpening, ctx, lum_w)


def _edge_pad(x, r):
    return F.pad(x[None, None], (r, r, r, r), mode="replicate")[0, 0]


def blend_mask(y, contrast_thresh, amount):
    """buildBlendMask's fixed-threshold path (sharpen.py::_blend_mask,
    rt_algo.cc:315-455) on the 0..65535 luminance."""
    p = _edge_pad(y, 2)
    h, w = y.shape

    def sh(dy, dx):
        return p[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w]

    scale = 0.0625 / 655.36  # Lab L's 0..32768 scale against Y's 0..65535
    contrast = torch.sqrt(
        (sh(0, 1) - sh(0, -1)) ** 2 + (sh(1, 0) - sh(-1, 0)) ** 2
        + (sh(0, 2) - sh(0, -2)) ** 2 + (sh(2, 0) - sh(-2, 0)) ** 2
    ) * scale
    t = torch.clamp(contrast_thresh, min=1e-5)
    blend = rdiv(amount, 1.0 + torch.exp(
        torch.clamp(16.0 - 16.0 * contrast / t, -40.0, 40.0)))
    return torch.where(contrast_thresh > 0, blend, amount)


def _threshold_ramp(x, t):
    """Threshold<int>::multiply's quad ramp (procparams.h:446-497)."""
    bl, tl, br, tr = t[0], t[1], t[2], t[3]
    up = torch.clamp((x - bl) / torch.clamp(tl - bl, min=1e-5), 0.0, 1.0)
    down = 1.0 - torch.clamp((x - tr) / torch.clamp(br - tr, min=1e-5),
                             0.0, 1.0)
    return up * down


def rl_deconv(y, blend, sigma, iterations, amount):
    """deconvsharpening (sharpen.py::_rl_deconv, ipsharpen.cc:144-228)."""
    offset = 1000.0
    lum = y + offset
    est = torch.clamp(lum, min=0.0)
    frozen = torch.zeros_like(y, dtype=torch.bool)
    out = lum
    for _ in range(iterations):
        div = lum / torch.clamp(gauss_blur(est, sigma), min=1e-6)
        est_new = est * gauss_blur(div, sigma)
        diverged = torch.abs(est_new - lum) > lum * 0.2
        out = torch.where(diverged & ~frozen, est_new, out)
        frozen = frozen | diverged
        est = est_new
    final = torch.where(frozen, out, est)
    b = blend * amount
    result = b * torch.clamp(final, min=0.0) + (1.0 - b) * lum
    return torch.clamp(result - offset, min=0.0)


def _conv2(x, k):
    """2-D correlation with edge-replicated borders."""
    r = k.shape[0] // 2
    return F.conv2d(_edge_pad(x, r)[None, None], k[None, None])[0, 0]


def rl_deconv_psf(y, blend, kern, iterations):
    """rl_deconvolution_psf (sharpen.py::_rl_deconv_psf, ipsharpen.cc:523):
    a pixel's output is captured and frozen once |log(est / lum)| passes
    0.3."""
    kflip = torch.flip(kern, (0, 1))
    lum = torch.clamp(y, min=0.0)
    est = lum
    frozen = torch.zeros_like(y, dtype=torch.bool)
    captured = lum
    for _ in range(iterations):
        tmp = _conv2(est, kern)
        tmp = torch.where(tmp > 1e-5, lum / torch.clamp(tmp, min=1e-5), tmp)
        tmp = _conv2(tmp, kflip)
        est = est * tmp
        diverged = torch.abs(torch.log(
            torch.clamp(est, min=1e-5) / torch.clamp(lum, min=1e-5))) > 0.3
        val = blend * torch.clamp(est, min=0.0) + (1.0 - blend) * lum
        captured = torch.where(diverged & ~frozen, val, captured)
        frozen = frozen | diverged
    final = blend * torch.clamp(est, min=0.0) + (1.0 - blend) * lum
    return torch.where(frozen, captured, final)


def usm(y, blend, radius, amount, thresh):
    """The unsharp mask in the gamma-3 domain (sharpen.py::_usm)."""
    yn = torch.pow(torch.clamp(fdiv(y, MAXVAL), 0.0, 1.0),
                   1.0 / 3.0) * MAXVAL
    diff = yn - gauss_blur(yn, radius)
    delta = _threshold_ramp(torch.clamp(torch.abs(diff), max=2000.0),
                            thresh) * (amount * diff)
    out = blend * (yn + delta) + (1.0 - blend) * yn
    return torch.pow(torch.clamp(fdiv(out, MAXVAL), 0.0, 1.0), 3.0) * MAXVAL


def apply(rgb, data, static):
    method, radius, iters = static
    lw = data["lum_w"]
    y, u, v = rgb_to_yuv(rgb, lw)
    blend = blend_mask(y, data["contrast"], 1.0)
    if method == "rld":
        y2 = rl_deconv(y, blend, radius, iters, data["amount"])
    elif method == "psf":
        y2 = rl_deconv_psf(y, blend, data["psf"], iters)
    else:
        y2 = usm(y, blend, radius, data["amount"], data["thresh"])
    f = torch.where(y > 1e-5, y2 / torch.clamp(y, min=1e-5), 1.0)
    return yuv_to_rgb(y2, u * f, v * f, lw)
