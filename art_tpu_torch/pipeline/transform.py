"""Geometric transform stage (counterpart of
``art_tpu/pipeline/transform.py``; iptransform.cc transformGeneral).

One inverse-mapped resampling pass composing rotation, lens distortion,
chromatic aberration scaling and perspective: for each output pixel its
source position in centre-normalised coordinates, in the reference's
order (the keystone perspective's divide, the rotation, the radial
distortion and CA scale, then the LCP or metadata lens maps), sampled
by Catmull-Rom (16 taps a channel, zero outside the source) or
bilinearly. The host half (`needs_transform`, `plan_transform`, the
auto-fill bisection) is a numpy copy of the reference's; the device half
is plain PyTorch on tensors of the input's device. Divisions by a host
scalar go through `core/fmath.py::fdiv` and roots through `fsqrt`, so
the card rounds the coordinates as the CPU does: whether a sample falls
inside the source is a threshold decision.
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.core.fmath import fdiv, fsqrt, interp


def _cubic_w(t):
    """Catmull-Rom weights for the 4 taps at offsets -1, 0, 1, 2."""
    t2 = t * t
    t3 = t2 * t
    return (
        -0.5 * t3 + t2 - 0.5 * t,
        1.5 * t3 - 2.5 * t2 + 1.0,
        -1.5 * t3 + 2.0 * t2 + 0.5 * t,
        0.5 * t3 - 0.5 * t2,
    )


def _sample_bicubic(img, dy, dx):
    """Catmull-Rom sampling of img (H, W) at float coords (dy, dx); zero
    where (dy, dx) lies outside [0, H-1] x [0, W-1]."""
    h, w = img.shape
    iy = torch.floor(dy)
    ix = torch.floor(dx)
    wys = _cubic_w(dy - iy)
    wxs = _cubic_w(dx - ix)
    valid = (dy >= 0) & (dy <= h - 1) & (dx >= 0) & (dx <= w - 1)
    flat = img.reshape(-1)
    cols = [torch.clamp(ix + (i - 1), 0, w - 1).to(torch.int64)
            for i in range(4)]
    acc = torch.zeros_like(dy)
    for j, wy in enumerate(wys):
        row = torch.clamp(iy + (j - 1), 0, h - 1).to(torch.int64) * w
        for i, wx in enumerate(wxs):
            acc = acc + (wy * wx) * flat[row + cols[i]]
    return torch.where(valid, acc, torch.zeros_like(acc))


def _sample_bilinear(img, dy, dx):
    """jax.scipy.ndimage.map_coordinates(img, [dy, dx], order=1,
    mode="constant", cval=0): each of the four taps that falls outside
    the image is zero, the others weighted as (1 - f, f) products."""
    h, w = img.shape
    flat = img.reshape(-1)
    nodes = []
    for c, n in ((dy, h), (dx, w)):
        lower = torch.floor(c)
        upper_w = c - lower
        i0 = lower.to(torch.int64)
        nodes.append([(i0, 1 - upper_w), (i0 + 1, upper_w)])
    out = None
    for iy, wy in nodes[0]:
        for ix, wx in nodes[1]:
            ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            v = flat[torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1)]
            term = (wy * wx) * torch.where(ok, v, torch.zeros_like(v))
            out = term if out is None else out + term
    return out


def needs_transform(pp, frame=None):
    return (
        (pp.rotate.enabled and abs(pp.rotate.degree) > 1e-6)
        or (pp.distortion.enabled and abs(pp.distortion.amount) > 1e-6)
        or (pp.cacorrection.enabled and (abs(pp.cacorrection.red) > 1e-9
                                         or abs(pp.cacorrection.blue) > 1e-9))
        or (pp.perspective.enabled and (abs(pp.perspective.horizontal) > 1e-6
                                        or abs(pp.perspective.vertical) > 1e-6
                                        or abs(pp.perspective.angle) > 1e-6
                                        or abs(pp.perspective.shear) > 1e-6))
        or _lcp_geometry_active(pp)
        or _exif_geometry_active(pp, frame) is not None
    )


def _lcp_geometry_active(pp):
    lp = pp.lens_prof
    return (lp.method == "lcp" and bool(lp.lcp_file)
            and (lp.use_dist or lp.use_ca))


def _exif_geometry_active(pp, frame):
    """ExifCorr when metadata-embedded (method "exif", lensexif.cc) or
    lensfun-database (methods "lfauto"/"lfmanual", rtlensfun.cc)
    corrections are selected and available."""
    lp = pp.lens_prof
    if frame is None or not (lp.use_dist or lp.use_ca):
        return None
    if lp.method == "exif":
        from art_tpu_torch.lens.exifcorr import for_frame

        corr = for_frame(frame)
    elif lp.method in ("lfauto", "lfmanual"):
        from art_tpu_torch.lens.lensfun import for_frame as lf_for_frame

        corr = lf_for_frame(pp, frame)
    else:
        return None
    if corr is None:
        return None
    if (lp.use_dist and corr.has_dist) or (lp.use_ca and corr.has_ca):
        return corr
    return None


def plan_transform(pp, shape, frame=None):
    h, w = shape
    rot = pp.rotate.degree if pp.rotate.enabled else 0.0
    ang = pp.perspective.angle if pp.perspective.enabled else 0.0
    theta = np.radians(rot + ang)
    data = {
        "cos": np.float32(np.cos(theta)),
        "sin": np.float32(np.sin(theta)),
        "dist": np.float32(pp.distortion.amount
                           if pp.distortion.enabled else 0.0),
        "ca_r": np.float32(pp.cacorrection.red
                           if pp.cacorrection.enabled else 0.0),
        "ca_b": np.float32(pp.cacorrection.blue
                           if pp.cacorrection.enabled else 0.0),
        "persp_h": np.float32((pp.perspective.horizontal
                               if pp.perspective.enabled else 0.0) / 100.0),
        "persp_v": np.float32((pp.perspective.vertical
                               if pp.perspective.enabled else 0.0) / 100.0),
        "shear": np.float32((pp.perspective.shear
                             if pp.perspective.enabled else 0.0) / 100.0),
    }
    # auto-fill (iptransform.cc getTransformAutoFill :1310): bisect the
    # largest output scale whose border still maps inside the source
    if getattr(pp, "common_trans", None) is not None \
            and pp.common_trans.autofill:
        data["ascale"] = np.float32(_autofill_scale(data, h, w))
    if _lcp_geometry_active(pp):
        from art_tpu_torch.lens.lcp import parse_lcp

        prof = parse_lcp(pp.lens_prof.lcp_file)
        focal = float((frame.exif.get("focal_length", 0.0) or 0.0)
                      if frame is not None else 0.0)
        if prof is not None and not prof.is_fisheye:
            lp = pp.lens_prof

            def row(m):
                x0, y0, fx, fy = m.geometry(w, h, focal)
                return np.asarray(
                    [x0, y0, fx, fy] + list(m.param) + [m.scale_factor],
                    dtype=np.float32)

            base = prof.distortion(focal) if lp.use_dist else None
            if base is not None:
                data["lcp_dist"] = row(base)
            chrom = prof.chromatic(focal) if lp.use_ca else None
            if chrom is not None:
                data["lcp_ca"] = np.stack([row(m) for m in chrom])
    corr = _exif_geometry_active(pp, frame)
    if corr is not None:
        lp = pp.lens_prof
        if corr.kind == "spline":
            if lp.use_dist and corr.dist is not None:
                data["exifc_dist"] = np.stack(
                    [corr.knots, corr.dist]).astype(np.float32)
            if lp.use_ca and corr.ca is not None:
                data["exifc_ca"] = np.stack(
                    [np.stack([corr.knots, c]) for c in corr.ca]
                ).astype(np.float32)
        elif lp.use_dist and corr.warp is not None:
            # DNG WarpRectilinear: absolute center + corner normalizer
            # (lensexif.cc:492-506)
            cx = corr.center_d[0] * w
            cy = corr.center_d[1] * h
            m = np.hypot(max(cx, w - cx), max(cy, h - cy))
            data["exif_dng_warp"] = np.asarray(
                [cx, cy, m] + list(corr.warp), np.float32)
    return data


def _map_border(data, h, w, scale, n=64):
    """Numpy replica of apply_transform's inverse map on border samples
    (green channel), with the output pre-scaled by `scale`."""
    w2 = w / 2.0 - 0.5
    h2 = h / 2.0 - 0.5
    maxradius = np.sqrt(w * w + h * h) / 2.0
    ts = np.linspace(0.0, 1.0, n)
    bx = np.concatenate([ts * (w - 1), ts * (w - 1),
                         np.zeros(n), np.full(n, w - 1.0)])
    by = np.concatenate([np.zeros(n), np.full(n, h - 1.0),
                         ts * (h - 1), ts * (h - 1)])
    x_d = (bx - w2) * scale
    y_d = (by - h2) * scale
    ph = float(data["persp_h"])
    pv = float(data["persp_v"])
    shear = float(data["shear"])
    denom = 1.0 + (pv * y_d / h) + (ph * x_d / w)
    x_d = (x_d + shear * y_d) / denom
    y_d = y_d / denom
    cost, sint = float(data["cos"]), float(data["sin"])
    dxc = x_d * cost - y_d * sint
    dyc = x_d * sint + y_d * cost
    r = np.sqrt(dxc * dxc + dyc * dyc) / maxradius
    s = 1.0 - float(data["dist"]) + float(data["dist"]) * r
    # widest channel reach: include the CA extremes
    out = []
    for ca in (0.0, float(data["ca_r"]), float(data["ca_b"])):
        sc = s + ca
        out.append((dxc * sc + w2, dyc * sc + h2))
    return out


def _autofill_scale(data, h, w):
    lo, hi = 0.001, 2.0
    while hi - lo > 0.001:
        mid = 0.5 * (lo + hi)
        clipped = False
        for dx, dy in _map_border(data, h, w, mid):
            if (dx.min() < 0 or dy.min() < 0 or dx.max() > w - 1
                    or dy.max() > h - 1):
                clipped = True
                break
        if clipped:
            hi = mid
        else:
            lo = mid
    return lo


def apply_transform(rgb, data, method="bicubic"):
    """(3, H, W) -> (3, H, W): each channel sampled at its inverse-mapped
    source position (data: `plan_transform`'s, as tensors on rgb's
    device)."""
    c, h, w = rgb.shape
    w2 = w / 2.0 - 0.5
    h2 = h / 2.0 - 0.5
    maxradius = np.sqrt(w * w + h * h) / 2.0
    f32 = dict(dtype=rgb.dtype, device=rgb.device)

    yy = torch.arange(h, **f32)[:, None] * torch.ones((1, w), **f32)
    xx = torch.arange(w, **f32)[None, :] * torch.ones((h, 1), **f32)
    x_d = xx - w2
    y_d = yy - h2
    del xx, yy
    if "ascale" in data:
        x_d = x_d * data["ascale"]
        y_d = y_d * data["ascale"]

    # perspective (keystone approximation: projective division by a tilt
    # plane; reference uses the focal-length camera model)
    ph = data["persp_h"]
    pv = data["persp_v"]
    shear = data["shear"]
    denom = 1.0 + fdiv(pv * y_d, h) + fdiv(ph * x_d, w)
    x_d = (x_d + shear * y_d) / denom
    y_d = y_d / denom
    del denom

    cost, sint = data["cos"], data["sin"]
    dxc = x_d * cost - y_d * sint
    dyc = x_d * sint + y_d * cost
    del x_d, y_d

    r = fdiv(fsqrt(dxc * dxc + dyc * dyc), maxradius)
    s = 1.0 - data["dist"] + data["dist"] * r
    del r

    out = []
    ch_dist = [data["ca_r"], torch.zeros((), **f32), data["ca_b"]]
    for ci in range(3):
        sc = s + ch_dist[ci]
        dx = dxc * sc + w2
        dy = dyc * sc + h2
        del sc
        if "lcp_dist" in data or "lcp_ca" in data:
            dx, dy = _lcp_map(dx, dy, ci, data)
        if ("exifc_dist" in data or "exifc_ca" in data
                or "exif_dng_warp" in data):
            dx, dy = _exif_map(dx, dy, ci, data, h, w)
        if method == "bicubic":
            out.append(_sample_bicubic(rgb[ci], dy, dx))
        else:
            out.append(_sample_bilinear(rgb[ci], dy, dx))
        del dx, dy
    return torch.stack(out)


def _exif_map(dx, dy, ci, data, h, w):
    """Metadata-embedded lens corrections on absolute pixel coordinates
    (lensexif.cc correctDistortion :524 / correctCA :600)."""
    w2e = w * 0.5
    h2e = h * 0.5
    rnorm = 1.0 / np.hypot(w2e, h2e)

    def radial(x, y, series):
        ccx = x - w2e
        ccy = y - h2e
        r = rnorm * fsqrt(ccx * ccx + ccy * ccy)
        dr = interp(r, series[0], series[1])
        return dr * ccx + w2e, dr * ccy + h2e

    if "exifc_dist" in data:
        dx, dy = radial(dx, dy, data["exifc_dist"])
    if "exifc_ca" in data and ci != 1:
        dx, dy = radial(dx, dy, data["exifc_ca"][ci])
    if "exif_dng_warp" in data:
        p = data["exif_dng_warp"]
        cx1, cy1, m = p[0], p[1], p[2]
        xd = (dx - cx1) / m
        yd = (dy - cy1) / m
        xd2 = xd * xd
        yd2 = yd * yd
        r2 = xd2 + yd2
        f = p[3] + r2 * (p[4] + r2 * (p[5] + r2 * p[6]))
        dxdy2 = 2.0 * xd * yd
        # dy_t keeps the reference's (r2 + 2*dx2) term (lensexif.cc:571)
        x_t = p[7] * dxdy2 + p[8] * (r2 + 2.0 * xd2)
        y_t = p[8] * dxdy2 + p[7] * (r2 + 2.0 * xd2)
        dx = cx1 + m * (f * xd + x_t)
        dy = cy1 + m * (f * yd + y_t)
    return dx, dy


def _lcp_model_fwd(xd, yd, p, with_scale=False):
    """Adobe rectilinear model (lcp.cc correctDistortion :1062-1080):
    normalized undistorted -> distorted coordinates. p is the 10-row
    [x0, y0, fx, fy, a0, a1, a2, t1, t2, scale]."""
    a0, a1, a2 = p[4], p[5], p[6]
    yfac, xfac = p[7], p[8]  # param[3], param[4] (no axis swap)
    rsqr = xd * xd + yd * yd
    common = (((a2 * rsqr + a1) * rsqr + a0) * rsqr + 1.0
              + 2.0 * (yfac * yd + xfac * xd))
    xn = xd * common + xfac * rsqr
    yn = yd * common + yfac * rsqr
    if with_scale:
        xn = xn * p[9]
        yn = yn * p[9]
    return xn, yn


def _lcp_map(dx, dy, ci, data):
    """Apply the LCP distortion (+ per-channel CA) to absolute pixel
    coordinates (lcp.cc correctDistortion/correctCA)."""
    if "lcp_dist" in data:
        p = data["lcp_dist"]
        xd = (dx - p[0]) / p[2]
        yd = (dy - p[1]) / p[3]
        xn, yn = _lcp_model_fwd(xd, yd, p)
        dx = xn * p[2] + p[0]
        dy = yn * p[3] + p[1]
    if "lcp_ca" in data:
        pg = data["lcp_ca"][1]
        xd = (dx - pg[0]) / pg[2]
        yd = (dy - pg[1]) / pg[3]
        if "lcp_dist" not in data:
            # CA models carry the main distortion when it isn't applied
            # separately (correctCA useCADist)
            xg, yg = _lcp_model_fwd(xd, yd, pg)
        else:
            xg, yg = xd, yd
        if ci == 1:
            dx = xg * pg[2] + pg[0]
            dy = yg * pg[3] + pg[1]
        else:
            pc = data["lcp_ca"][0 if ci == 0 else 2]
            xn, yn = _lcp_model_fwd(xg, yg, pc, with_scale=True)
            dx = xn * pc[2] + pc[0]
            dy = yn * pc[3] + pc[1]
    return dx, dy
