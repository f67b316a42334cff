"""NLMeans on luma, kernel B6 (counterpart of
``art_tpu/ops/nlmeans_pallas.py``: ``nlmeans_pallas`` -> ``_run`` ->
``_kernel``; nlmeans.cc:50-260).

For each of the 121 search offsets t (radius 5, idx = 0..120, ty = idx
// 11 - 5, tx = idx % 11 - 5): the squared difference d2(p) = (y(p) -
y(p + t))^2, its 5x5 patch box (vertical sums first, then horizontal,
each as ((((c + c[+1]) + c[-1]) + c[+2]) + c[-2])), the weight
exp(-min(box * maskinv, 50)), and acc += weight * y(p + t), wsum +=
weight; the result is acc / (wsum + 1e-5).

The reference edge-pads the plane to whole 256-pixel tiles and each
tile's window by 8 rows and 64 columns; its reach is 5 + 2 = 7, so no
kept pixel sees the window's wrap and the result equals this whole-plane
form with edge-clamped neighbours. There is no tile grid to keep.

`nlmeans` is the entry point. On a CPU tensor it runs `nlmeans_plain`;
on a CUDA tensor it launches ``art_nlmeans`` of ``csrc/nlmeans.cu`` or
raises. The kernel walks each column down strips of rows with all 121
offsets' sums in registers; its tile is the .cu's constants (WX, WY,
STRIP), reported by `layout`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from art_tpu_torch import kernels

TILE = 256  # the reference's tile: smaller planes take an unported path
SEARCH_R = 5
PATCH_R = 2


def nlmeans(y, maskinv):
    """Kernel B6: NLMeans of the (H, W) float32 luma y with the per-pixel
    inverse weight scale maskinv (same shape)."""
    if y.ndim != 2 or y.dtype != torch.float32:
        raise ValueError(f"y: want float32 (H, W), got {y.dtype} "
                         f"{tuple(y.shape)}")
    if maskinv.dtype != torch.float32 or maskinv.shape != y.shape \
            or maskinv.device != y.device:
        raise ValueError(f"maskinv: want float32 {tuple(y.shape)} on "
                         f"{y.device}, got {maskinv.dtype} "
                         f"{tuple(maskinv.shape)} on {maskinv.device}")
    h, w = y.shape
    if h < TILE or w < TILE:
        raise NotImplementedError(
            f"NLMeans of a {h}x{w} plane: below one 256x256 tile the "
            "reference runs a whole-plane path that is not ported")
    if y.device.type == "cpu":
        return nlmeans_plain(y, maskinv)
    if y.device.type != "cuda":
        raise ValueError(f"no NLMeans kernel for device {y.device}")
    y, maskinv = y.contiguous(), maskinv.contiguous()
    out = torch.empty_like(y)
    rc = kernels.library().art_nlmeans(
        y.data_ptr(), maskinv.data_ptr(), out.data_ptr(), h, w,
        kernels.stream_of(y))
    kernels.check(rc, "art_nlmeans")
    nlmeans.launches += 1
    return out


nlmeans.launches = 0


def nlmeans_plain(y, maskinv):
    """The plain PyTorch version of B6, in the Pallas kernel's operation
    order; counts its calls in `.calls`.

    The offsets t and -t share one patch box: the squared difference of
    -t at q is that of t at q - t ((a - b)^2 = (b - a)^2), so the box of
    -t at p is the box of t at p - t, the same values summed in the same
    order. The box of each of the 60 offsets before (0, 0) is made over
    the plane grown by the search radius and read again, moved, for its
    partner: the kernel's result bit for bit, from the operations it
    needs (this count is B6's bound in chip_smoke.py)."""
    nlmeans_plain.calls += 1
    h, w = y.shape
    e, q = SEARCH_R, PATCH_R
    r = e + q + SEARCH_R
    yp = F.pad(y[None, None], (r, r, r, r), mode="replicate")[0, 0]
    hb, wb = h + 2 * e, w + 2 * e  # the boxes' plane, grown by e
    hq, wq = hb + 2 * q, wb + 2 * q
    centre = yp[SEARCH_R : SEARCH_R + hq, SEARCH_R : SEARCH_R + wq]
    n = 2 * SEARCH_R + 1
    half = n * n // 2  # the index of offset (0, 0)
    fifty = torch.tensor(50.0, dtype=y.dtype, device=y.device)
    boxes = {}
    acc = wsum = None
    for idx in range(n * n):
        ty = idx // n - SEARCH_R
        tx = idx % n - SEARCH_R
        if idx <= half:
            d = centre - yp[SEARCH_R + ty : SEARCH_R + ty + hq,
                            SEARCH_R + tx : SEARCH_R + tx + wq]
            d2 = d * d
            s = d2[2 : hb + 2] + d2[3 : hb + 3] + d2[1 : hb + 1] \
                + d2[4 : hb + 4] + d2[0:hb]
            box = s[:, 2 : wb + 2] + s[:, 3 : wb + 3] + s[:, 1 : wb + 1] \
                + s[:, 4 : wb + 4] + s[:, 0:wb]
            boxes[idx] = box
            dist2 = box[e : e + h, e : e + w]
        else:  # the partner -t's box, read at p + t
            box = boxes.pop(n * n - 1 - idx)
            dist2 = box[e + ty : e + ty + h, e + tx : e + tx + w]
        wgt = torch.exp(-torch.minimum(dist2 * maskinv, fifty))
        sh = yp[r + ty : r + ty + h, r + tx : r + tx + w]
        acc = wgt * sh if acc is None else acc + wgt * sh
        wsum = wgt if wsum is None else wsum + wgt
    return acc / (wsum + 1e-5)


nlmeans_plain.calls = 0


def layout():
    """B6's kernel on the card: registers, shared and local memory, tile
    (``art_nlmeans_layout``)."""
    buf = ctypes.create_string_buffer(1024)
    kernels.check(kernels.library().art_nlmeans_layout(buf, len(buf)),
                  "art_nlmeans_layout")
    return buf.value.decode()
