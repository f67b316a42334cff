"""Automatic adjustments run at plan time (counterpart of
``art_tpu/pipeline/autos.py``).

Host numpy. Ported: the grey-world white balance, the automatic
chrominance estimate and the RL sharpening radius, copies of the
reference's `auto_wb_multipliers`, `auto_chroma_params` and
`deconv_auto_radius`; the automatic log encoding, `auto_log_params`,
whose statistics come from a neutral develop of a subsampled frame on
the device of the develop that asks for it; and the histogram-matched
tone curve's points, `histogram_matching_curve`.
"""

from __future__ import annotations

import copy

import numpy as np

from art_tpu_torch.core.image import bayer_color_index


def auto_wb_multipliers(frame):
    """Grey-world auto WB -> ColorTemp-convention RGB multipliers
    (art_tpu/pipeline/autos.py::auto_wb_multipliers; RawImageSource::
    getAutoWBMultipliers): the mean of each channel's unclipped CFA sites
    above black, as gains relative to green, taken to the RGB multiplier
    convention through rgb_cam. ones(3) for a frame with no Bayer
    pattern (X-Trans included)."""
    if not frame.is_raw or frame.pattern is None:
        return np.ones(3)
    cfa = np.asarray(frame.cfa, dtype=np.float64)
    h, w = cfa.shape
    cidx = bayer_color_index(frame.pattern, (h, w))
    black = np.asarray(frame.black)
    white = np.asarray(frame.white)
    clip_hi = 0.95 * white.min()
    avgs = []
    for c in range(3):
        sel = (cidx == c) & (cfa < clip_hi)
        vals = cfa[sel] - black[[0, 1, 2][c]]
        avgs.append(max(vals.mean() if vals.size else 1.0, 1e-3))
    gains = np.array([avgs[1] / avgs[0], 1.0, avgs[1] / avgs[2]])
    # gains = pre_mul / (cam_rgb @ mult) * norm, so mult = rgb_cam @
    # (pre_mul / gains)
    rgb_cam, _, _ = frame.color_matrices()
    pm = frame.pre_mul()
    v = rgb_cam @ (pm[:3] / gains)
    if v[1] <= 0:
        return np.ones(3)
    return np.array([v[0] / v[1], 1.0, v[2] / v[1]])


def auto_chroma_params(frame, pp, wb_mults=None):
    """Automatic chrominance estimate from nine sample crops (ipdenoise.cc
    denoiseComputeParams): (chrominance, red_green, blue_yellow) in slider
    units, or None for non-Bayer frames
    (art_tpu/pipeline/autos.py::auto_chroma_params)."""
    if frame is None or not frame.is_raw or frame.pattern is None:
        return None

    from art_tpu_torch.color import colorspaces as cs
    from art_tpu_torch.raw import preprocess as rawpre
    from art_tpu_torch.raw import wb as wbmod

    mosaic = np.asarray(frame.cfa)
    h, w = mosaic.shape
    if h < 64 or w < 64:
        return None
    if wb_mults is None:
        wb_mults = frame.camera_wb_mults()
    splan = rawpre.scale_plan(frame, wb_mults_rgb=wb_mults)
    mults, _ = wbmod.image_multipliers(
        frame, wb_mults, splan["scale_mul"], splan["c_white"],
        splan["cblack"])
    rgb_cam, _, _ = frame.color_matrices()
    working = pp.icm.working_profile
    if working not in cs.MATRICES_RGB_TO_XYZ:
        working = "Rec2020"
    xyz_cam = cs.MATRICES_RGB_TO_XYZ["sRGB"] @ rgb_cam
    cam2work = cs.MATRICES_XYZ_TO_RGB[working] @ xyz_cam
    work2xyz = cs.MATRICES_RGB_TO_XYZ[working]
    lum_w = work2xyz[1]
    gam = max(float(pp.denoise.gamma), 1e-3)

    off_t = np.asarray(splan["offset_tile"], dtype=np.float32)
    scl_t = np.asarray(splan["scale_tile"], dtype=np.float32)
    th = off_t.shape[0]

    pat = frame.pattern
    pos = {c: [(i // 2, i % 2) for i, p in enumerate(pat) if p == c]
           for c in "RGB"}

    crw = min(512, (w // 2) & ~1)
    crh = min(512, (h // 2) & ~1)
    beg = 50 if (w > crw + 120 and h > crh + 120) else 0
    cw0 = [beg, (w - crw) // 2, w - crw - beg]
    ch0 = [beg, (h - crh) // 2, h - crh - beg]

    def sep_blur(p, sp):
        k = [1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16]
        out = np.zeros_like(p)
        for t, kv in zip((-2, -1, 0, 1, 2), k):
            out += kv * np.roll(p, t * sp, axis=0)
        out2 = np.zeros_like(out)
        for t, kv in zip((-2, -1, 0, 1, 2), k):
            out2 += kv * np.roll(out, t * sp, axis=1)
        return out2

    def mad(d):
        return float(np.median(np.abs(d)) / 0.6745)

    aggressive = bool(pp.denoise.aggressive)
    reduc = 0.9 if aggressive else 1.0

    ch_M = np.zeros(9)
    deltas = np.zeros(9)
    max_r = np.zeros(9)
    max_b = np.zeros(9)
    min_r = np.zeros(9)
    min_b = np.zeros(9)
    lumL = np.zeros(9)
    chromC = np.zeros(9)
    ry = np.zeros(9)
    sk = np.zeros(9)
    pcsk = np.zeros(9)

    for wcr in range(3):
        for hcr in range(3):
            kidx = hcr * 3 + wcr
            x0 = cw0[wcr] & ~1
            y0 = ch0[hcr] & ~1
            m = mosaic[y0 : y0 + crh, x0 : x0 + crw]
            rows = (np.arange(y0, y0 + crh) % th)
            off = off_t[rows][:, x0 : x0 + crw]
            scl = scl_t[rows][:, x0 : x0 + crw]
            sm = np.maximum(m - off, 0.0) * scl
            # superpixel half-res camera RGB
            chans = []
            for c in "RGB":
                ps = pos[c]
                acc = sum(sm[dy::2, dx::2] for dy, dx in ps) / len(ps)
                chans.append(acc)
            cam = np.stack(chans) * mults[:3, None, None]
            wrk = np.einsum("ij,jhw->ihw", cam2work, cam)
            wrk = np.clip(wrk, 0.0, 65535.0)
            # denoise gamma domain, 0..32768 (RGB_denoise_infoGamCurve)
            gd = (wrk / 65535.0) ** (1.0 / gam) * 32768.0
            y = lum_w[0] * gd[0] + lum_w[1] * gd[1] + lum_w[2] * gd[2]
            u = y - gd[2]
            v = gd[0] - y

            # scene statistics in Lab (RT scale: CIE x 327.68)
            xyz = np.einsum("ij,jhw->ihw", work2xyz, wrk / 65535.0)
            xn = xyz[0] / 0.9642
            yn = xyz[1]
            zn = xyz[2] / 0.8249

            def f(t):
                t = np.maximum(t, 1e-8)
                return np.where(t > (6 / 29) ** 3, np.cbrt(t),
                                t / (3 * (6 / 29) ** 2) + 4 / 29)

            fx, fy, fz = f(xn), f(yn), f(zn)
            Lr = (116.0 * fy - 16.0) * 327.68
            ar = 500.0 * (fx - fy) * 327.68
            br = 200.0 * (fy - fz) * 327.68
            cN = np.maximum(np.hypot(ar, br), 100.0)
            hN = np.arctan2(br, ar)
            lumL[kidx] = float(np.mean(np.clip(Lr, 2.0, 32768.0)))
            chromC[kidx] = float(np.mean(cN))
            ry_mask = (hN > -0.8) & (hN < 2.0) & (cN > 10000.0)
            sk_mask = (hN > 0.0) & (hN < 1.6) & (cN < 10000.0)
            ry[kidx] = float(cN[ry_mask].mean()) if ry_mask.any() else 0.0
            sk[kidx] = float(cN[sk_mask].mean()) if sk_mask.any() else 0.0
            pcsk[kidx] = float(sk_mask.mean())

            # per-level MAD^2 of the U/V details (ShrinkAll_info MadRgb)
            chau = 0.0
            chred = 0.0
            chblue = 0.0
            mxr = 0.0
            mxb = 0.0
            mnr = 1e12
            mnb = 1e12
            nb = 0
            cu, cv = v, u  # a = v (red-green), b = u (blue-yellow)
            for lv in range(5):
                sa = sep_blur(cu, 2 ** lv)
                sb = sep_blur(cv, 2 ** lv)
                mada = mad(cu - sa) ** 2
                madb = mad(cv - sb) ** 2
                cu, cv = sa, sb
                chred += mada
                chblue += madb
                chau += mada + madb
                mxr = max(mxr, mada)
                mxb = max(mxb, madb)
                mnr = min(mnr, mada)
                mnb = min(mnb, madb)
                nb += 1
            chaut = float(np.sqrt(reduc * chau / (2 * nb)))
            ch_M[kidx] = chaut
            max_r[kidx] = float(np.sqrt(reduc * mxr))
            max_b[kidx] = float(np.sqrt(reduc * mxb))
            min_r[kidx] = float(np.sqrt(reduc * mnr))
            min_b[kidx] = float(np.sqrt(reduc * mnb))

            # calcautodn_info corrections (mode=1 auto, lissage=0,
            # levaut=0)
            maxmax = max(max_r[kidx], max_b[kidx])
            c = (ch_M[kidx] * nb * 2 - maxmax) / (nb * 2 - 1)
            if ((ry[kidx] > 5000.0 or sk[kidx] > 1000.0)
                    and pcsk[kidx] < 0.4 and chromC[kidx] > 3000.0):
                c *= 0.45
            elif ((ry[kidx] > 12000.0 or sk[kidx] > 1200.0)
                    and pcsk[kidx] < 0.3 and chromC[kidx] > 3000.0):
                c *= 0.3
            if chromC[kidx] > 10000.0:
                c *= 0.8
            elif chromC[kidx] > 6000.0:
                c *= 0.9
            elif chromC[kidx] < 2000.0:
                c *= 2.2
            elif chromC[kidx] < 3000.0:
                c *= 1.5
            if lumL[kidx] < 2500.0:
                c *= 1.2
            elif lumL[kidx] < 5000.0:
                c *= 1.1
            elif lumL[kidx] > 20000.0:
                c *= 0.9
            if c > 300.0:  # levaut==0 Low denoise soft knee
                c = 0.714286 * c + 85.71428
            delta = (maxmax - c) * (0.9 if aggressive else 1.0)
            if c < 200.0 and delta < 200.0:
                delta *= 0.95
            elif c < 200.0 and delta < 400.0:
                delta *= 0.7
            elif c < 200.0:
                delta = 280.0
            elif c < 400.0 and delta < 400.0:
                delta *= 0.6
            elif c < 400.0:
                delta = 200.0
            elif c < 550.0:
                delta *= 0.3
            elif c < 650.0:
                delta *= 0.2
            else:
                delta *= 0.15
            if chromC[kidx] < 6000.0:
                delta *= 1.2
            if lumL[kidx] < 5000.0:
                delta *= 1.2
            ch_M[kidx] = c
            deltas[kidx] = delta

    # aggregation (ipdenoise.cc:1010-1067)
    autoNR, autoNRmax, multip, adjustr, lowd = 10.0, 40.0, 1.0, 1.0, 1.0
    Max_R = np.zeros(9)
    Max_B = np.zeros(9)
    Min_R = np.zeros(9)
    Min_B = np.zeros(9)
    for k in range(9):
        if max_r[k] > max_b[k]:
            Max_R[k] = deltas[k] / ((autoNRmax * multip * adjustr * lowd)
                                    / 2.0)
            Min_B[k] = -(ch_M[k] - min_b[k]) / (autoNRmax * multip
                                                * adjustr * lowd)
        else:
            Max_B[k] = deltas[k] / ((autoNRmax * multip * adjustr * lowd)
                                    / 2.0)
            Min_R[k] = -(ch_M[k] - min_r[k]) / (autoNRmax * multip
                                                * adjustr * lowd)
    chM = float(ch_M.mean())
    MaxR, MaxB = float(Max_R.max()), float(Max_B.max())
    MinR, MinB = float(Min_R.min()), float(Min_B.min())
    MaxRMoy, MaxBMoy = float(Max_R.mean()), float(Max_B.mean())
    MinRMoy, MinBMoy = float(Min_R.mean()), float(Min_B.mean())
    if MaxR > MaxB:
        maxr = MaxRMoy + (MaxR - MaxRMoy) * 0.66
        maxb = MinBMoy + (MinB - MinBMoy) * 0.66
    else:
        maxb = MaxBMoy + (MaxB - MaxBMoy) * 0.66
        maxr = MinRMoy + (MinR - MinRMoy) * 0.66
    chrominance = chM / (autoNR * multip * adjustr)
    return float(chrominance), float(maxr), float(maxb)


def deconv_auto_radius(frame, lower_limit=1000.0):
    """The capture's gaussian blur radius for RL sharpening's
    DeconvAutoRadius (art_tpu/pipeline/autos.py::deconv_auto_radius,
    deconvautoradius.cc calcRadiusBayer): the largest ratio of diagonal
    green neighbours away from near-clip sites, inverted through the
    gaussian's adjacent-sample falloff; float64 numpy on the host. None
    when it cannot be estimated."""
    from art_tpu_torch.core.image import bayer_color_index

    if frame.pattern is None or frame.cfa is None:
        return None
    cfa = np.asarray(frame.cfa, np.float64)
    black = float(np.asarray(frame.black).mean())
    white = float(np.asarray(frame.white).min())
    x = np.maximum(cfa - black, 0.0)
    clip_val = (white - black) * 0.95
    mg = bayer_color_index(frame.pattern, cfa.shape) == 1

    # clipped-neighborhood exclusion (3x3 dilation of near-clip pixels)
    near_clip = x >= clip_val
    nc = near_clip.copy()
    for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
        nc |= np.roll(near_clip, sh, axis=ax)
    nc |= np.roll(np.roll(near_clip, 1, 0), 1, 1)
    nc |= np.roll(np.roll(near_clip, 1, 0), -1, 1)
    nc |= np.roll(np.roll(near_clip, -1, 0), 1, 1)
    nc |= np.roll(np.roll(near_clip, -1, 0), -1, 1)

    max_ratio = 1.0
    for dx in (-1, 1):
        a = x[:-1, 1:-1]
        b = x[1:, 1 + dx : x.shape[1] - 1 + dx]
        valid = (mg[:-1, 1:-1] & mg[1:, 1 + dx : x.shape[1] - 1 + dx]
                 & ~nc[:-1, 1:-1]
                 & ~nc[1:, 1 + dx : x.shape[1] - 1 + dx])
        hi = np.maximum(a, b)
        lo = np.minimum(a, b)
        valid &= (lo > 0) & (hi > lower_limit)
        if valid.any():
            r = (hi[valid] / lo[valid]).max()
            max_ratio = max(max_ratio, float(r))
    if max_ratio <= 1.0:
        return None
    # gaussian adjacent-sample falloff inversion (deconvautoradius.cc:90)
    radius = float(np.sqrt((1.0 / (np.log(1.0 / max_ratio) / 2.0)) / -2.0))
    if not np.isfinite(radius):
        return None
    return float(np.clip(radius, 0.4, 2.5))


def auto_log_params(frame, pp, device):
    """getAutoLog (iplogenc.cc:308; art_tpu/pipeline/autos.py::
    auto_log_params): (gain, black_ev, white_ev) from the 1st, 50th and
    99.5th percentiles of the luminance of a neutral develop (fast
    demosaic, pp's working space) of the frame subsampled 8x, rendered
    on `device`."""
    from art_tpu_torch.color import colorspaces as cs
    from art_tpu_torch.params import ProcParams
    from art_tpu_torch.pipeline.develop import develop

    neutral = ProcParams()
    neutral.raw.bayer.method = "fast"
    neutral.icm.working_profile = pp.icm.working_profile
    out = develop(subsample_frame(frame, 8), neutral, device=device)
    lin = cs.srgb_igamma(out.cpu().numpy())
    y = 0.2126 * lin[0] + 0.7152 * lin[1] + 0.0722 * lin[2]
    y = np.maximum(y, 2.0 ** -16)
    lo = np.percentile(y, 1.0)
    hi = np.percentile(y, 99.5)
    med = np.median(y)
    gray = 0.18
    gain = float(np.log2(gray / max(med, 1e-6)))
    black_ev = float(np.log2(max(lo, 1e-6) / gray) - gain)
    white_ev = float(np.log2(max(hi, 1e-6) / gray) - gain + 1.0)
    # the reference's slider domains (blackEv < 0 < whiteEv)
    black_ev = float(np.clip(black_ev, -16.0, -0.5))
    white_ev = float(np.clip(white_ev, 0.5, 32.0))
    if white_ev - black_ev < 0.5:
        white_ev = black_ev + 0.5
    return gain, black_ev, white_ev


def histogram_matching_render(frame, device):
    """The neutral render the matched curve is read against
    (develop.py:489-492): the frame subsampled 8x through ProcParams()
    with the fast demosaic, on `device`; (3, h, w) float32 numpy. Unlike
    the auto log's render, it keeps the default working profile."""
    from art_tpu_torch.params import ProcParams
    from art_tpu_torch.pipeline.develop import develop

    neutral = ProcParams()
    neutral.raw.bayer.method = "fast"
    out = develop(subsample_frame(frame, 8), neutral, device=device)
    return out.cpu().numpy()


def histogram_matching_curve(source_rgb01, target_rgb01, n_points=9):
    """The tone curve (sRGB-encoded domain) that maps the neutral render's
    luminance distribution onto the embedded preview's (histmatching.cc;
    art_tpu/pipeline/autos.py::histogram_matching_curve): the float32
    Rec.709 luminance of each, sorted, read at 9 quantiles from 2% to
    98%; a knot is kept only 0.02 past the last one and below 0.98.
    Returns DiagonalCurve points [DCT_SPLINE, 0, 0, x1, y1, ..., 1, 1]."""
    def lum(img):
        return 0.2126 * img[0] + 0.7152 * img[1] + 0.0722 * img[2]

    s = np.sort(lum(np.asarray(source_rgb01)).ravel())
    t = np.sort(lum(np.asarray(target_rgb01)).ravel())
    qs = np.linspace(0.02, 0.98, n_points)
    xs = np.quantile(s, qs)
    ys = np.quantile(t, qs)
    pts = [1.0, 0.0, 0.0]
    lastx = 0.0
    for x, y in zip(xs, ys):
        if x <= lastx + 0.02 or x >= 0.98:
            continue
        pts += [float(x), float(np.clip(y, 0, 1))]
        lastx = x
    pts += [1.0, 1.0]
    return pts


def subsample_frame(frame, step):
    """A Bayer frame's 2x2 blocks every 2 * step sites, pattern kept
    (autos.py::_subsample_frame); any other frame as it is."""
    f = copy.copy(frame)
    if frame.is_raw and frame.pattern is not None:
        c = frame.cfa
        h, w = c.shape
        s = step * 2
        blocks = np.zeros((2 * (h // s), 2 * (w // s)), dtype=c.dtype)
        blocks[0::2, 0::2] = c[0::s, 0::s][: h // s, : w // s]
        blocks[0::2, 1::2] = c[0::s, 1::s][: h // s, : w // s]
        blocks[1::2, 0::2] = c[1::s, 0::s][: h // s, : w // s]
        blocks[1::2, 1::2] = c[1::s, 1::s][: h // s, : w // s]
        f.cfa = blocks
    return f
