"""Main denoise (counterpart of ``art_tpu/ops/denoise.py``).

`plan` is the reference's (host numpy, with the automatic chrominance
estimate). `apply` takes the reference's paths, chosen by the same
static and shape predicates:

- fused (no NLMeans, no guided chroma, no DCT pass) from one kernel tile
  up: gamma, YUV and the wavelet shrink in kernel B4
  (:mod:`art_tpu_torch.ops.wavelet_kernel`), with the raw head fused in
  when the pipeline passes it;
- otherwise: the raw head (when passed), exposure gain, gamma and YUV in
  plain PyTorch; the wavelet shrink of the stacked Y/U/V in kernel B5
  from one 256x1024 tile up, else the whole-plane chain with a global
  crop MAD sigma (:mod:`art_tpu_torch.ops.wavelet`); the DCT luminance
  detail pass (:mod:`art_tpu_torch.ops.dct_detail`); the guided chroma
  filter (:mod:`art_tpu_torch.ops.filters`); NLMeans on Y in kernel B6
  (:mod:`art_tpu_torch.ops.nlmeans_kernel`) from one 256x256 tile up,
  else the whole-plane 121-offset loop; then back to RGB.
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.yuv import rgb_to_yuv, yuv_to_rgb
from art_tpu_torch.core.fmath import fdiv, mat3
from art_tpu_torch.core.image import MAXVAL
from art_tpu_torch.core.profile import span
from art_tpu_torch.ops import nlmeans_kernel
from art_tpu_torch.ops.filters import box_blur, gauss_blur, guided_filter
from art_tpu_torch.ops.nlmeans_kernel import nlmeans
from art_tpu_torch.ops.wavelet import (_B3, _sep_blur, atrous_decompose,
                                       atrous_reconstruct, mad_sigma,
                                       shrink_sure_like)
from art_tpu_torch.ops.wavelet_kernel import (multi_geometry, tile_geometry,
                                              wavelet_denoise_multi,
                                              wavelet_denoise_rgb)

LEVELS = 5


def plan(pp, ctx):
    """(static, data) for the denoise op (art_tpu/ops/denoise.py::plan)."""
    dn = pp.denoise
    if not dn.enabled:
        return None
    lum_w = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]][1]
    chroma = dn.chrominance
    chroma_rg = dn.chrominance_redgreen
    chroma_by = dn.chrominance_blueyellow
    if dn.chrominance_method != 0:  # auto modes
        est = None
        frame = ctx.get("frame")
        if frame is not None:
            from art_tpu_torch.pipeline.autos import auto_chroma_params

            est = auto_chroma_params(frame, pp)
        factor = max(dn.chrominance_auto_factor, 0.1)
        if est is not None:
            ch, rg, by = est
            from art_tpu_torch.pipeline.listeners import report_auto

            report_auto("chroma", (float(ch), float(rg), float(by)))
            chroma = ch * factor
            chroma_rg = rg * factor
            chroma_by = by * factor
        else:  # non-Bayer fallback: scaled baseline
            chroma = 15.0 * factor
    from art_tpu_torch.core.curve1d import fit_gamma_split

    gam_fwd, gam_inv = fit_gamma_split(dn.gamma)
    data = {
        "lum_w": lum_w.astype(np.float32),
        "gamma": np.float32(dn.gamma),
        "gam_fwd": gam_fwd,
        "gam_inv": gam_inv,
        "lum_strength": np.float32(dn.luminance / 25.0),
        "lum_detail": np.float32(np.clip(dn.luminance_detail / 100.0, 0, 1)),
        "chroma": np.float32(chroma / 10.0),
        "chroma_rg": np.float32(chroma_rg / 10.0),
        "chroma_by": np.float32(chroma_by / 10.0),
        "ecomp": np.float32(2.0 ** (pp.exposure.expcomp
                                    if pp.exposure.enabled
                                    and pp.exposure.expcomp > 0 else 0.0)),
    }
    nl = 0
    if dn.smoothing_enabled and dn.nl_strength:
        nl = int(dn.nl_strength)
    guided = 0
    if dn.smoothing_enabled and dn.smoothing_method == 1:
        guided = int(dn.guided_chroma_radius)
        data["guided_strength"] = np.float32(dn.guided_chroma_strength / 100.0)
    if nl:
        data["nl_h2"] = np.float32(((nl / 100.0) ** 0.9 / 10.0) ** 2)
        data["nl_detail"] = np.float32(np.clip(dn.nl_detail / 100.0, 0, 0.99))
    use_dct = bool(dn.luminance > 0 and dn.luminance_detail > 0)
    if use_dct:
        data["lum_detail_dct"] = np.float32(dn.luminance_detail)
    return (bool(dn.luminance > 0), nl, guided,
            bool(dn.aggressive), use_dct,
            int(dn.luminance_detail_threshold) if use_dct else 0), data


def is_fused(static, shape=None):
    """Whether `apply` takes the fused path (kernel B4): no NLMeans, no
    guided chroma, no DCT pass, and (for an image of `shape`, (H, W))
    at least one B4 tile."""
    _do_lum, nl, guided, _aggressive, use_dct, _thresh = static
    return (nl == 0 and guided == 0 and not use_dct
            and (shape is None or tile_geometry(*shape) is not None))


def strengths_blends(data, static):
    """The wavelet's per-plane (Y, U, V) strengths and detail blends."""
    do_lum, _nl, _guided, _aggressive, use_dct, _thresh = static
    cb = data["chroma"] + data["chroma_by"]
    cr = data["chroma"] + data["chroma_rg"]
    strengths = [data["lum_strength"] if do_lum else 0.0, cb, cr]
    blends = [data["lum_detail"] if do_lum and not use_dct else 0.0,
              0.0, 0.0]
    return strengths, blends


def kernel_args(data, static):
    """(args, kwargs) of `wavelet_denoise_rgb` (B4) after the image, for
    this op's data and a static of the fused path; data["pre_mults"] and
    data["pre_mat"], when present, are the raw head fused into B4."""
    if not is_fused(static):
        raise ValueError("denoise: NLMeans, guided chroma or the DCT pass "
                         "take the non-fused path")
    strengths, blends = strengths_blends(data, static)
    pre = None
    if "pre_mat" in data:
        pre = (data["pre_mults"], data["pre_mat"])
    return ((data["lum_w"], data["ecomp"], data["gam_fwd"], data["gam_inv"],
             [-1.0, -1.0, -1.0], strengths, blends), {"pre": pre})


def to_yuv(rgb, data):
    """The non-fused path's Y, U, V planes: exposure gain, then
    (x / MAXVAL)^(1/gamma) clipped to [0, 1], split by the working
    space's luminance weights (denoise.py:228-234)."""
    x = rgb * data["ecomp"]
    xn = torch.pow(torch.clamp(fdiv(x, MAXVAL), 0.0, 1.0),
                   torch.reciprocal(data["gamma"]))
    return rgb_to_yuv(xn, data["lum_w"])


def nl_maskinv(y, h2_base, detail):
    """NLMeans' inverse weight scale (denoise.py:151-156): the smoothed
    |y - gauss(y)|, over its maximum across the whole plane, blended
    with the detail level, as 1 / (max(mask, 1e-6) * h2)."""
    lap = torch.abs(y - gauss_blur(y, 2.0))
    lap = gauss_blur(lap, 2.0)
    lap = lap / torch.clamp(lap.amax(), min=1e-9)
    mask = lap * (1.0 - detail) + detail
    return torch.reciprocal(torch.clamp(mask, min=1e-6) * h2_base)


def mad_sigma_crop(x):
    """The global MAD sigma of the whole-plane path: the finest à trous
    detail of a centre crop of at most 1024 x 1024
    (denoise.py::_mad_sigma_crop)."""
    h, w = x.shape[-2:]
    cs_ = min(1024, h, w)
    y0 = (h - cs_) // 2
    x0 = (w - cs_) // 2
    crop = x[..., y0 : y0 + cs_, x0 : x0 + cs_]
    return mad_sigma(crop - _sep_blur(crop, _B3, 1))


def wavelet_denoise_planes(planes, strengths, blends):
    """Denoise a list of (H, W) planes: kernel B5 (each tile's sigma) from
    one 256x1024 tile up, else the whole-plane chain with each plane's
    crop MAD (denoise.py::_wavelet_denoise_planes)."""
    n = len(planes)
    if multi_geometry(*planes[0].shape) is not None:
        with span("denoise/B5"):
            out = wavelet_denoise_multi(torch.stack(planes), [-1.0] * n,
                                        strengths, blends)
        return list(out.unbind(0))
    with span("denoise/wavelet"):
        sigmas = [mad_sigma_crop(p) for p in planes]
        res = []
        for x, sigma, strength, blend in zip(planes, sigmas, strengths,
                                             blends):
            details, resid = atrous_decompose(x, LEVELS)
            out_details = []
            for lv, d in enumerate(details):
                # noise shrinks by ~2 a coarser level (B3 norm)
                dd = shrink_sure_like(d, fdiv(sigma, 2.0 ** lv), strength)
                out_details.append(dd + (d - dd) * blend)
            res.append(atrous_reconstruct(out_details, resid))
    return res


def nlmeans_plane(y, maskinv, search_radius=5, patch_radius=2):
    """NLMeans of the luma: kernel B6 from one 256x256 tile up, else the
    reference's whole-plane loop over the 121 offsets, edge-padded
    (denoise.py::_nlmeans)."""
    h, w = y.shape
    if h >= nlmeans_kernel.TILE and w >= nlmeans_kernel.TILE:
        with span("denoise/B6"):
            return nlmeans(y, maskinv)
    with span("denoise/nlmeans"):
        patch_n = (2 * patch_radius + 1) ** 2
        acc = torch.zeros_like(y)
        wsum = torch.zeros_like(y)
        r = search_radius
        off = r + patch_radius
        p = torch.nn.functional.pad(y[None, None], (off,) * 4,
                                    mode="replicate")[0, 0]
        for ty in range(-r, r + 1):
            for tx in range(-r, r + 1):
                sh = p[off + ty : off + ty + h, off + tx : off + tx + w]
                dist2 = box_blur((y - sh) ** 2, patch_radius) * patch_n
                wgt = torch.exp(-torch.clamp(dist2 * maskinv, max=50.0))
                acc = acc + wgt * sh
                wsum = wsum + wgt
        return acc / (wsum + 1e-5)


def apply(rgb, data, static):
    """Denoise of a (3, H, W) tensor in the 0..65535 domain: the fused
    path (kernel B4) or the non-fused one (B5 or the whole-plane wavelet,
    the DCT pass, guided chroma, B6 or the whole-plane NLMeans), as the
    reference chooses."""
    if is_fused(static, rgb.shape[-2:]):
        args, kwargs = kernel_args(data, static)
        return wavelet_denoise_rgb(rgb, *args, **kwargs)
    do_lum, nl, guided, _aggressive, use_dct, detail_thresh = static
    strengths, blends = strengths_blends(data, static)
    if "pre_mat" in data:
        # the fused raw head, here below one B4 tile
        rgb = mat3(data["pre_mat"], torch.clamp(
            rgb * data["pre_mults"][:, None, None], 0.0, MAXVAL))
    y, u, v = to_yuv(rgb, data)
    if do_lum:
        y_pre = y
        y, u, v = wavelet_denoise_planes([y, u, v], strengths, blends)
        if use_dct:
            from art_tpu_torch.ops.dct_detail import dct_detail_recovery

            with span("dct_detail"):
                y = dct_detail_recovery(y_pre, y, data["lum_detail_dct"],
                                        detail_thresh)
    else:
        u, v = wavelet_denoise_planes([u, v], strengths[1:], [0.0, 0.0])
    if guided > 0:
        with span("denoise/guided"):
            gs = data["guided_strength"]
            u2 = guided_filter(y, u, guided, 1e-4)
            v2 = guided_filter(y, v, guided, 1e-4)
            u = u + (u2 - u) * gs
            v = v + (v2 - v) * gs
    if nl:
        with span("denoise/nl_mask"):
            maskinv = nl_maskinv(y, data["nl_h2"], data["nl_detail"])
        y = nlmeans_plane(y, maskinv)
    out = yuv_to_rgb(y, u, v, data["lum_w"])
    out = torch.pow(torch.clamp(out, 0.0, 1.0), data["gamma"]) * MAXVAL
    return out / data["ecomp"]
