"""Rasterisers and resamplers of the region masks, in place of the OpenCV
and Pillow calls of the reference's masks (``art_tpu/masks/__init__.py``:
``rasterize_area``, ``rasterize_drawn``, ``_load_external_mask``).

The card's machine has neither library, so each call is rebuilt here and
held to it value for value (``tests/test_torch_masks.py``):

- `box_points`: ``cv2.boxPoints``, in float32 as ``RotatedRect::points``;
- `fill_poly`: ``cv2.fillPoly`` of int32 vertices (shift 0, 8-connected):
  OpenCV draws every edge with its Bresenham line, then fills the spans
  between the fixed-point (16.16) edge walks of its active-edge table
  (an edge that leaves the image walks from its clipped ends), so the
  pixels on an edge are included; host numpy, exact;
- `circle_cover`: ``cv2.circle(..., thickness=-1)`` at integer centres,
  the midpoint circle's spans; host numpy, exact;
- `gaussian_blur`: ``cv2.GaussianBlur(a, (0, 0), sigma)`` on float32
  (kernel size ``cvRound(8 sigma + 1) | 1``, ``getGaussianKernel``'s
  taps, ``BORDER_REFLECT_101``), separable float32 in PyTorch on the
  plane's device: a feather at 24 MP is a blur of 800 to 3200 taps;
- `pil_resize_bilinear`: Pillow's ``resize((w, h), Image.BILINEAR)`` of
  an ``L``, ``I;16`` or ``F`` plane: a separable convolution with a
  triangle whose support widens with the shrink factor, horizontal pass
  first, 8-bit planes through 22-bit fixed-point taps with rounding and
  clipping, ``I;16`` through double sums rounded half up, ``F`` through
  double sums; in PyTorch on the plane's device, taps summed in
  Pillow's order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def box_points(center, size, angle):
    """The four corners of a rotated rectangle, (4, 2) float32, as
    ``cv2.boxPoints(((cx, cy), (w, h), angle))`` gives them (angle in
    degrees; RotatedRect::points in float32)."""
    f = np.float32
    cx, cy = f(center[0]), f(center[1])
    w, h = f(size[0]), f(size[1])
    rad = float(f(angle)) * math.pi / 180.0
    b = f(math.cos(rad)) * f(0.5)
    a = f(math.sin(rad)) * f(0.5)
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    p2 = (cx + a * h + b * w, cy - b * h + a * w)
    p3 = (cx - a * h + b * w, cy + b * h + a * w)
    return np.array([p0, p1, p2, p3], dtype=np.float32)


def _outside(w, h, x, y):
    return not (0 <= x < w and 0 <= y < h)


def _clip_line(w, h, p1, p2):
    """cv::clipLine on int64 points: (inside, p1, p2), the points moved
    as OpenCV moves them, also where the line misses the image."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line_pixels(w, h, p1, p2):
    """(ys, xs) of OpenCV's 8-connected line from p1 to p2 (LineIterator,
    left to right, clipped to the image): the minor coordinate after k
    major steps is ceil((2 d k - D) / (2 D)), Bresenham's error walk in
    closed form."""
    if _outside(w, h, *p1) or _outside(w, h, *p2):
        inside, p1, p2 = _clip_line(w, h, p1, p2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    major, minor = max(dx, abs(dy)), min(dx, abs(dy))
    k = np.arange(major + 1, dtype=np.int64)
    m = -((major - 2 * minor * k) // (2 * major)) if major else k
    if abs(dy) > dx:
        return y1 + sy * k, x1 + m
    return y1 + sy * m, x1 + k


def _cdiv(a, b):
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def fill_poly(shape, pts):
    """``cv2.fillPoly(zeros(shape), [pts], 1)`` of one int32 polygon
    (shift 0, 8-connected lines) as a bool plane: the edges' lines, then
    the spans between the active edges' 16.16 walks, row by row
    (drawing.cpp CollectPolyEdges and FillEdgeCollection)."""
    h, w = shape
    out = np.zeros((h, w), dtype=bool)
    v = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []
    for i in range(len(v)):
        (x0, y0), (x1, y1) = v[i - 1], v[i]
        ys, xs = _line_pixels(w, h, (x0, y0), (x1, y1))
        out[ys, xs] = True
        c0, c1 = [x0 << XY_SHIFT, y0], [x1 << XY_SHIFT, y1]
        if _outside(w, h, x0, y0) or _outside(w, h, x1, y1):
            # an edge that leaves the image walks from its clipped ends
            # (as cv::clipLine leaves them, also off the image), flat
            # where they share a row
            _, t0, t1 = _clip_line(w, h, (x0, y0), (x1, y1))
            c0, c1 = [t0[0] << XY_SHIFT, t0[1]], [t1[0] << XY_SHIFT, t1[1]]
        if y0 == y1:
            continue
        step = (_cdiv(c1[0] - c0[0], c1[1] - c0[1]) if c1[1] != c0[1]
                else 0)
        if y0 < y1:
            edges.append((y0, y1, c0[0] + (y0 - c0[1]) * step, step))
        else:
            edges.append((y1, y0, c1[0] + (y1 - c1[1]) * step, step))
    if len(edges) < 2:
        return out
    y0s, y1s, x0s, steps = (np.array(c, dtype=np.int64)
                            for c in zip(*edges))
    ends = x0s + (y1s - y0s) * steps
    if (y1s.max() < 0 or y0s.min() >= h
            or max(x0s.max(), ends.max()) < 0
            or min(x0s.min(), ends.min()) >= (w << XY_SHIFT)):
        return out
    rows = np.arange(max(int(y0s.min()), 0), min(int(y1s.max()), h))
    if rows.size == 0:
        return out
    # each row's active edges (y0 <= y < y1) sorted by their walk's x and
    # paired left to right; a pair fills [ceil(lo), floor(hi)]
    r = rows[:, None]
    active = (r >= y0s) & (r < y1s)
    xs = np.where(active, x0s + (r - y0s) * steps, np.iinfo(np.int64).max)
    xs.sort(axis=1)
    count = active.sum(axis=1)
    cols = np.arange(w)
    for p in range(0, len(edges) - 1, 2):
        lo = (xs[:, p] + XY_ONE - 1) >> XY_SHIFT
        hi = xs[:, p + 1] >> XY_SHIFT
        ok = (count >= p + 2) & (lo < w) & (hi >= 0)
        lo, hi = np.maximum(lo, 0), np.minimum(hi, w - 1)
        ok &= lo <= hi
        sel = rows[ok]
        out[sel] |= (cols >= lo[ok, None]) & (cols <= hi[ok, None])
    return out


def _circle_half_widths(radius):
    """Half-width of the filled midpoint circle (drawing.cpp Circle) at
    each row offset 0..radius."""
    hw = np.zeros(radius + 1, dtype=np.int64)
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        hw[dy] = max(hw[dy], dx)
        hw[dx] = max(hw[dx], dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return hw


def circle_cover(shape, centers, radius):
    """The union of ``cv2.circle(img, (cx, cy), radius, 1, -1)`` over
    integer `centers` ((x, y) pairs) inside its bounding box: (window,
    bool plane of the window), or None where it misses the image. Each
    disc's rows are spans, summed into a difference array."""
    h, w = shape
    c = np.asarray(centers, dtype=np.int64).reshape(-1, 2)
    hw = _circle_half_widths(int(radius))
    t = np.arange(-radius, radius + 1)
    ys = (c[:, 1:2] + t).ravel()
    x1 = (c[:, 0:1] - hw[np.abs(t)]).ravel()
    x2 = (c[:, 0:1] + hw[np.abs(t)]).ravel()
    ok = (ys >= 0) & (ys < h) & (x1 < w) & (x2 >= 0)
    ys, x1, x2 = ys[ok], np.maximum(x1[ok], 0), np.minimum(x2[ok], w - 1)
    if ys.size == 0:
        return None
    ya, yb, xa, xb = ys.min(), ys.max() + 1, x1.min(), x2.max() + 1
    diff = np.zeros((yb - ya, xb - xa + 1), dtype=np.int32)
    np.add.at(diff, (ys - ya, x1 - xa), 1)
    np.add.at(diff, (ys - ya, x2 - xa + 1), -1)
    cov = np.cumsum(diff, axis=1)[:, :-1] > 0
    return (slice(ya, yb), slice(xa, xb)), cov


def _reflect101(n, r, device):
    """Source indices of a BORDER_REFLECT_101 pad of r on each side of
    n samples (repeated reflection for r >= n, as borderInterpolate)."""
    i = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def gaussian_kernel(sigma):
    """``getGaussianKernel(cvRound(8 sigma + 1) | 1, sigma, CV_32F)``:
    exp(-x^2 / (2 sigma^2)) normalised in double, then cast."""
    n = int(round(sigma * 4 * 2 + 1)) | 1
    half = (n - 1) // 2
    x = np.arange(1 - n, 0, 2, dtype=np.float64)  # twice the offsets
    t = np.exp(x * x * (-0.125 / (sigma * sigma)))
    mul = 1.0 / (t.sum() * 2.0 + 1.0)
    k = np.empty(n)
    k[:half] = t * mul
    k[half] = mul
    k[half + 1:] = k[:half][::-1]
    return k.astype(np.float32)


def gaussian_blur(x, sigma):
    """``cv2.GaussianBlur(x, (0, 0), sigma)`` of a float32 (H, W) tensor,
    on its device: the rows, then the columns, each a 1-D convolution of
    a BORDER_REFLECT_101 pad."""
    k = torch.from_numpy(gaussian_kernel(float(sigma))).to(x.device)
    r = (k.numel() - 1) // 2
    h, w = x.shape
    xp = x.index_select(1, _reflect101(w, r, x.device))
    y = F.conv2d(xp[None, None], k.view(1, 1, 1, -1))[0, 0]
    yp = y.index_select(0, _reflect101(h, r, x.device))
    return F.conv2d(yp[None, None], k.view(1, 1, -1, 1))[0, 0]


def _pil_taps(in_size, out_size):
    """Pillow's precompute_coeffs for the bilinear filter (support 1):
    (first source index, taps, count of taps) of each output sample,
    (out, ksize) float64 taps normalised to sum 1 and zero past each
    one's count."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    ss = 1.0 / filterscale
    kk = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for t in range(ksize):
        d = np.abs((t + xmin - center + 0.5) * ss)
        kk[:, t] = np.where(t < xmax, np.where(d < 1.0, 1.0 - d, 0.0), 0.0)
        ww += kk[:, t]
    kk = np.where(ww[:, None] != 0.0, kk / np.where(ww == 0.0, 1.0, ww)[
        :, None], kk)
    return xmin, kk, xmax


def _pil_pass(a, taps, mode, dim):
    """One pass of Pillow's resample along `dim` of a 2-D tensor (the
    8bpc, 16bpc and 32bpr loops)."""
    xmin, kk, count = taps
    dev = a.device
    n_in = a.shape[dim]
    first = torch.from_numpy(xmin).to(dev)
    if mode == "L":
        fixed = np.floor(0.5 + kk * (1 << 22)).astype(np.int64)
        k = torch.from_numpy(fixed).to(dev)
        acc = torch.full((), 1 << 21, dtype=torch.int64, device=dev)
        src = a.to(torch.int64)
    else:
        k = torch.from_numpy(kk).to(dev)
        acc = torch.zeros((), dtype=torch.float64, device=dev)
        src = a.to(torch.float64)
    shape = [1, 1]
    shape[dim] = -1
    used = torch.from_numpy(count).to(dev)
    for t in range(kk.shape[1]):
        idx = torch.clamp(first + t, max=n_in - 1)
        term = src.index_select(dim, idx) * k[:, t].view(shape)
        # Pillow reads no sample past a tap's count (0 x inf is NaN)
        acc = acc + torch.where((t < used).view(shape), term,
                                torch.zeros((), dtype=term.dtype,
                                            device=dev))
    if mode == "L":
        return torch.where(acc >= 1 << 30, 255, torch.where(
            acc <= 0, 0, acc >> 22)).to(torch.uint8)
    if mode == "I;16":
        return torch.floor(acc + 0.5).clamp(0, 65535).to(torch.int32)
    return acc.to(torch.float32)


def pil_resize_bilinear(a, mode, size, device):
    """Pillow's ``Image.resize(size, Image.BILINEAR)`` of a 2-D plane of
    mode "L" (uint8), "I;16" (uint16) or "F" (float32), on `device`:
    a tensor of the mode's values (uint8, int32, float32)."""
    w, h = size
    x = torch.from_numpy(np.ascontiguousarray(a).astype(
        np.int32 if mode == "I;16" else a.dtype)).to(device)
    if x.shape[1] != w:
        x = _pil_pass(x, _pil_taps(x.shape[1], w), mode, 1)
    if x.shape[0] != h:
        x = _pil_pass(x, _pil_taps(x.shape[0], h), mode, 0)
    return x
