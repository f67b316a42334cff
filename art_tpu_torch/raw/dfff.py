"""Dark-frame subtraction, the embedded DNG gain map and flat-field
correction (counterpart of ``art_tpu/raw/dfff.py`` and of the gain map's
device step in ``art_tpu/pipeline/develop.py``; rawimagesource.cc
copyOriginalPixels, rawflatfield.cc, gainmap.cc).

All three run on raw ADU values before black subtraction and scaling, as in
the reference. The flat field blurs each Bayer site's subplane (a
strided view, radius halved) or, on X-Trans, each colour by a
mask-normalised blur, with the blur type Area, Vertical, Horizontal or
V+H; the correction is the blurred subplane's mean over its blurred
value, clipped to [0.25, 4]. Plain PyTorch in the reference's float32
formulation: the box means difference float32 running sums, whose
rounding the correction carries; they and the reference means accumulate
in float64 on every device (`core/fmath.py::cumsum32`, `mean32`), so the
card rounds them as the CPU does.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.fmath import cumsum32, mean32


def subtract_dark(cfa, dark):
    return torch.clamp(cfa - dark, min=0.0)


def apply_gain_plane(cfa, offset_tile, gain):
    """An embedded DNG gain map on raw ADUs (develop.py:862-871): (raw -
    black) * gain + black, black from the periodic level rows that
    `raw/preprocess.py::apply_scale` uses, then clipped at 0."""
    th = offset_tile.shape[0]
    hh, ww = cfa.shape
    v = cfa.reshape(hh // th, th, ww)
    v = (v - offset_tile[None]) * gain.reshape(hh // th, th, ww) \
        + offset_tile[None]
    return torch.clamp(v.reshape(hh, ww), min=0.0)


def _blur_sub(sub, radius, blur_type):
    if blur_type == "v":
        return sub if radius <= 0 else _box_axis(sub, radius, 0)
    if blur_type == "h":
        return _box_axis(sub, radius, 1)
    if blur_type == "vh" or radius > 0:
        # V+H, and the area blur (`ops/filters.py::box_blur`'s two passes)
        return _box_axis(_box_axis(sub, radius, 0), radius, 1)
    return sub


def _box_axis(a, r, axis):
    """Mean over 2r+1 samples along one axis, edge-clamped counts."""
    n = a.shape[axis]
    c = cumsum32(a, axis)
    c = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)), c], dim=axis)
    i = torch.arange(n, device=a.device)
    hi = torch.clamp(i + r + 1, 0, n)
    lo = torch.clamp(i - r, 0, n)
    s = c.index_select(axis, hi) - c.index_select(axis, lo)
    shape = [1] * a.dim()
    shape[axis] = n
    return s / (hi - lo).to(a.dtype).reshape(shape)


def apply_flatfield_bayer(cfa, flat, blur_type="area", radius=32):
    """cfa, flat: (H, W) raw ADU planes of one sensor, H and W even."""
    rsub = max(int(radius) // 2, 1)
    corr_full = torch.empty_like(cfa)
    for py in (0, 1):
        for px in (0, 1):
            blurred = _blur_sub(flat[py::2, px::2], rsub, blur_type)
            ref = mean32(blurred)
            corr = ref / torch.clamp(blurred, min=1e-3)
            # the reference guards insane corrections from dust/defects
            corr_full[py::2, px::2] = torch.clamp(corr, 0.25, 4.0)
    return cfa * corr_full


def apply_flatfield_xtrans(cfa, flat, cidx, blur_type="area", radius=32):
    """X-Trans: mask-normalised blur per colour plane; cidx is the (H, W)
    colour index (`core/image.py::xtrans_color_index_device`)."""
    out = cfa
    r = max(int(radius), 1)
    for c in range(3):
        sel = cidx == c
        m = sel.to(cfa.dtype)
        num = _blur_sub(flat * m, r, blur_type)
        den = _blur_sub(m, r, blur_type)
        blurred = num / torch.clamp(den, min=1e-6)
        ref = (torch.sum(flat * m, dtype=torch.float64)
               / torch.clamp(torch.sum(m, dtype=torch.float64), min=1.0)
               ).to(cfa.dtype)
        corr = torch.clamp(ref / torch.clamp(blurred, min=1e-3), 0.25, 4.0)
        out = torch.where(sel, out * corr, out)
    return out
