"""Adobe DCP camera profiles (counterpart of ``art_tpu/color/dcp.py``;
rtengine/dcp.cc).

A .dcp is a small TIFF of DNG tags: ColorMatrix1/2 (50721/50722),
ForwardMatrix1/2 (50964/50965), CalibrationIlluminant1/2 (50778/50779),
ProfileHueSatMapDims/Data1/Data2 (50937-50939), ProfileToneCurve
(50940), ProfileLookTableDims/Data (50981/50982),
ProfileHueSatMapEncoding (51107), ProfileLookTableEncoding (51108),
BaselineExposureOffset (51109). `load_dcp` reads them with the port's
TIFF IFD reader; `plan_dcp` is host float64, a copy of the reference's.

On the device, step 1 (`apply_dcp`, DCPProfile::apply) takes camera RGB
through the illuminant-mixed matrix to linear ProPhoto, the HueSatMap
in HSV, and on to the working space; step 2 (`apply_dcp_look`,
step2ApplyTile) applies the baseline exposure, the look table and the
profile tone curve inside the op chain (`ops/dcplook.py`). The table
lookups gather the four (hue, saturation) corners of a cell from the
(value, hue, saturation) table itself, the hue wrapping to 0, at one or
two value levels; the blends, the truncations and the wraps are the
reference's, in its order.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from art_tpu_torch.core.fmath import fdiv, fpow, mat3
from art_tpu_torch.io.metadata import _read_ifd, _value

# CalibrationIlluminant EXIF code -> correlated color temperature
_ILLUM_TEMP = {
    1: 5500.0, 2: 3500.0, 3: 2856.0, 4: 5500.0, 9: 5500.0, 10: 6500.0,
    11: 7500.0, 12: 6400.0, 13: 5000.0, 14: 4150.0, 15: 3500.0,
    17: 2856.0, 18: 4874.0, 19: 6774.0, 20: 5500.0, 21: 6500.0,
    22: 7500.0, 23: 5000.0, 24: 3200.0,
}


@dataclasses.dataclass
class DCPProfile:
    color_matrix_1: np.ndarray | None = None
    color_matrix_2: np.ndarray | None = None
    forward_matrix_1: np.ndarray | None = None
    forward_matrix_2: np.ndarray | None = None
    illuminant_1: int = 0
    illuminant_2: int = 0
    hsm_dims: tuple | None = None  # (hue_div, sat_div, val_div)
    hsm_data_1: np.ndarray | None = None  # (hd, sd, vd, 3)
    hsm_data_2: np.ndarray | None = None
    hsm_srgb_encoding: bool = False
    look_dims: tuple | None = None
    look_data: np.ndarray | None = None
    look_srgb_encoding: bool = False
    tone_curve: np.ndarray | None = None  # (N, 2) pairs
    baseline_exposure_offset: float = 0.0


def _mat(v):
    a = np.array([x[0] / x[1] for x in v], dtype=np.float64)
    return a.reshape(3, 3)


def load_dcp(path) -> DCPProfile:
    with open(path, "rb") as f:
        buf = f.read()
    le = buf[:2] == b"II"
    off = struct.unpack_from(("<" if le else ">") + "I", buf, 4)[0]
    ents, _ = _read_ifd(buf, off, le)
    p = DCPProfile()

    def get(tag):
        if tag not in ents:
            return None
        typ, cnt, doff = ents[tag]
        return _value(buf, typ, cnt, doff, le)

    v = get(50721)
    if v:
        p.color_matrix_1 = _mat(v)
    v = get(50722)
    if v:
        p.color_matrix_2 = _mat(v)
    v = get(50964)
    if v:
        p.forward_matrix_1 = _mat(v)
    v = get(50965)
    if v:
        p.forward_matrix_2 = _mat(v)
    p.illuminant_1 = get(50778) or 0
    p.illuminant_2 = get(50779) or 0
    dims = get(50937)
    if dims and len(dims) == 3:
        p.hsm_dims = tuple(int(d) for d in dims)
        for tag, attr in ((50938, "hsm_data_1"), (50939, "hsm_data_2")):
            if tag in ents:
                typ, cnt, doff = ents[tag]
                raw = np.frombuffer(
                    buf, dtype="<f4" if le else ">f4", count=cnt,
                    offset=doff).astype(np.float32)
                hd, sd, vd = p.hsm_dims
                setattr(p, attr, raw.reshape(vd, hd, sd, 3))
    enc = get(51107)
    p.hsm_srgb_encoding = bool(enc)
    dims = get(50981)
    if dims and len(dims) == 3 and 50982 in ents:
        typ, cnt, doff = ents[50982]
        raw = np.frombuffer(buf, dtype="<f4" if le else ">f4", count=cnt,
                            offset=doff).astype(np.float32)
        hd, sd, vd = (int(d) for d in dims)
        p.look_dims = (hd, sd, vd)
        p.look_data = raw.reshape(vd, hd, sd, 3)
    enc = get(51108)  # ProfileLookTableEncoding (dcp.cc:1158)
    p.look_srgb_encoding = bool(enc)
    if 50940 in ents:
        typ, cnt, doff = ents[50940]
        raw = np.frombuffer(buf, dtype="<f4" if le else ">f4", count=cnt,
                            offset=doff)
        p.tone_curve = np.asarray(raw, dtype=np.float64).reshape(-1, 2)
    v = get(51109)
    if v is not None:
        p.baseline_exposure_offset = (v[0] / v[1]
                                      if isinstance(v, tuple) else float(v))
    return p


def _mix_weight(temp, t1, t2):
    """DNG illuminant interpolation weight for matrix/table pair 1."""
    if t1 <= 0 or t2 <= 0 or abs(t1 - t2) < 1:
        return 1.0
    lo, hi = (t2, t1) if t1 > t2 else (t1, t2)
    temp = min(max(temp, lo), hi)
    w = (1e6 / temp - 1e6 / t2) / (1e6 / t1 - 1e6 / t2)
    return float(min(max(w, 0.0), 1.0))


_XYZ_PROPHOTO = np.array([[0.7976749, 0.1351917, 0.0313534],
                          [0.2880402, 0.7118741, 0.0000857],
                          [0.0000000, 0.0000000, 0.8252100]])
_PROPHOTO_XYZ = np.linalg.inv(_XYZ_PROPHOTO)


def plan_dcp(profile: DCPProfile, frame, wb_temp, working_xyz_inv,
             icm=None):
    """Fold the DCP into the (cam -> ProPhoto, ProPhoto -> working)
    matrices and the tables (dcp.cc DCPProfile, makeXyzCam): the
    matrices and HueSatMap mixed by 1/T between the two illuminants at
    wb_temp, the white from temp2mulxyz. icm: the ICMParams that gate
    the HueSatMap, the look table, the tone curve and the baseline
    exposure (dcp.cc ApplyState). Returns (static, step2, data): step 1's
    static (has_hsm, dims, srgb_enc), step 2's (baseline scale, has_look,
    look dims, look srgb_enc, has_tc) or None, and the arrays."""
    t1 = _ILLUM_TEMP.get(profile.illuminant_1, 5000.0)
    t2 = _ILLUM_TEMP.get(profile.illuminant_2, 5000.0)
    mix = _mix_weight(wb_temp, t1, t2)

    def interp(a, b):
        if a is None:
            return b
        if b is None:
            return a
        return mix * a + (1.0 - mix) * b

    cm = interp(profile.color_matrix_1, profile.color_matrix_2)
    fwd = interp(profile.forward_matrix_1, profile.forward_matrix_2)

    from art_tpu_torch.raw.wb import temp2mulxyz

    xz = temp2mulxyz(wb_temp)
    white_xyz = np.array([xz[0], 1.0, xz[1]])
    if fwd is not None and cm is not None:
        camera_white = cm @ white_xyz
        cam_xyz = np.linalg.inv(fwd @ np.linalg.inv(np.diag(camera_white)))
    elif cm is not None:
        # Bradford-map D50 to the shot white (dng mapWhiteMatrix)
        d50 = np.array([0.9642, 1.0, 0.8249])
        brad = np.array([[0.8951, 0.2664, -0.1614],
                         [-0.7502, 1.7135, 0.0367],
                         [0.0389, -0.0685, 1.0296]])
        w1 = brad @ d50
        w2 = brad @ (white_xyz / white_xyz[1])
        adapt = np.linalg.inv(brad) @ np.diag(
            np.clip(w2 / w1, 0.1, 10.0)) @ brad
        cam_xyz = cm @ adapt
    else:
        cam_xyz = frame.cam_xyz if frame.cam_xyz is not None else np.eye(3)

    xyz_cam = np.linalg.inv(cam_xyz)
    # normalize rows of cam_rgb so camera (1,1,1) stays white (dcp.cc:1860)
    from art_tpu_torch.color.colorspaces import MATRICES_RGB_TO_XYZ

    cam_rgb = cam_xyz @ MATRICES_RGB_TO_XYZ["sRGB"]
    cam_rgb /= cam_rgb.sum(axis=1, keepdims=True)
    xyz_cam = MATRICES_RGB_TO_XYZ["sRGB"] @ np.linalg.inv(cam_rgb)

    cam2pro = _PROPHOTO_XYZ @ xyz_cam
    pro2work = working_xyz_inv @ _XYZ_PROPHOTO

    data = {
        "dcp_cam2pro": cam2pro.astype(np.float32),
        "dcp_pro2work": pro2work.astype(np.float32),
    }
    use_hsm = icm is None or getattr(icm, "apply_hue_sat_map", True)
    use_look = icm is None or getattr(icm, "apply_look_table", True)
    use_tc = icm is None or getattr(icm, "tone_curve", True)
    use_be = icm is None or getattr(icm, "apply_baseline_exposure", True)
    has_hsm = profile.hsm_data_1 is not None and use_hsm
    if has_hsm:
        tab = (mix * profile.hsm_data_1
               + (1.0 - mix) * profile.hsm_data_2
               if profile.hsm_data_2 is not None else profile.hsm_data_1)
        data["dcp_hsm"] = np.asarray(tab, dtype=np.float32)
    has_look = profile.look_data is not None and use_look
    if has_look:
        data["dcp_look"] = np.asarray(profile.look_data, dtype=np.float32)
    has_tc = (use_tc and profile.tone_curve is not None
              and len(profile.tone_curve) >= 2)
    if has_tc:
        from art_tpu_torch.core.curve1d import fit_curve

        xs = np.linspace(0.0, 1.0, 4096)
        pts = profile.tone_curve
        dense = np.interp(xs, pts[:, 0], pts[:, 1])
        data["dcp_tc"] = fit_curve(dense)
    bl = (2.0 ** profile.baseline_exposure_offset
          if profile.baseline_exposure_offset and use_be else 1.0)

    # step 1 = colorspace conversion (DCPProfile::apply, dcp.cc:1363):
    # matrices + HueSatMap only
    static = (has_hsm,
              tuple(profile.hsm_dims) if has_hsm else None,
              bool(profile.hsm_srgb_encoding))
    # step 2 = in-chain look/tone (step2ApplyTile, dcp.cc:1518), applied
    # at the early/late look position (improcfun.cc:590-592,614-620)
    if has_look or has_tc or bl != 1.0:
        step2 = (float(bl), has_look,
                 tuple(profile.look_dims) if has_look else None,
                 bool(profile.look_srgb_encoding), has_tc)
        data["dcp_work2pro"] = np.linalg.inv(pro2work).astype(np.float32)
    else:
        step2 = None
    return static, step2, data


def _rgb2hsv(r, g, b):
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = mx - mn
    safe = torch.where(c > 0, c, 1.0)
    h = torch.where(
        mx == r, (g - b) / safe,
        torch.where(mx == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe))
    h = torch.where(c > 0, torch.where(h < 0, h + 6.0, h), 0.0)
    s = torch.where(mx > 0, c / torch.clamp(mx, min=1e-12), 0.0)
    return h, s, mx


def _select(i, choices):
    """jnp.select over i == 0 .. 4, the last choice the default."""
    out = choices[-1]
    for k in range(4, -1, -1):
        out = torch.where(i == k, choices[k], out)
    return out


def _hsv2rgb(h, s, v):
    i = torch.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6
    return (_select(i, (v, q, p, p, t, v)), _select(i, (t, v, v, q, p, p)),
            _select(i, (p, p, t, v, v, q)))


def _hsm_lookup(table, dims, v, h, s):
    """Bilinear (one value level) or trilinear hue/sat/val table lookup
    (hsdApply); `v` in the table's value encoding. Returns the hue
    shift, the saturation scale and the value scale."""
    hd, sd, vd = dims
    flat = table.reshape(-1, 3)
    h_scaled = h * (hd / 6.0)
    s_scaled = s * (sd - 1)
    h0 = torch.clamp(h_scaled.to(torch.int32), 0, hd - 1)
    s0 = torch.clamp(s_scaled.to(torch.int32), 0, sd - 2)
    hf = (h_scaled - h0.to(h.dtype))[..., None]
    sf = (s_scaled - s0.to(h.dtype))[..., None]
    h0, s0 = h0.long(), s0.long()
    h1 = torch.where(h0 == hd - 1, 0, h0 + 1)  # the hue wraps

    def bilin(vi):
        def at(hi, si):
            return flat[(vi * hd + hi) * sd + si]

        c00, c01 = at(h0, s0), at(h1, s0)
        c10, c11 = at(h0, s0 + 1), at(h1, s0 + 1)
        return ((1 - sf) * ((1 - hf) * c00 + hf * c01)
                + sf * ((1 - hf) * c10 + hf * c11))

    if vd < 2:
        out = bilin(torch.zeros_like(h0))
    else:
        v_scaled = v * (vd - 1)
        v0 = torch.clamp(v_scaled.to(torch.int32), 0, vd - 2)
        vf = (v_scaled - v0.to(h.dtype))[..., None]
        v0 = v0.long()
        out = (1.0 - vf) * bilin(v0) + vf * bilin(v0 + 1)
    return out[..., 0], out[..., 1], out[..., 2]


def _srgb_enc(v):
    return torch.where(v <= 0.0031308, 12.92 * v,
                       1.055 * fpow(torch.clamp(v, min=1e-12), 1 / 2.4)
                       - 0.055)


def _srgb_dec(v):
    return torch.where(v <= 0.04045, fdiv(v, 12.92),
                       fpow(fdiv(torch.clamp(v, min=0.0), 1.055)
                            + 0.055 / 1.055, 2.4))


def _apply_hsv_table(x, table, dims, srgb_enc, clip_sv=False):
    """One hue/sat/val table pass on a linear ProPhoto stack in [0, 1];
    a pixel with a negative channel passes through. With the sRGB table
    encoding, the value index and the value scale run in the encoded
    domain: v' = igamma(gamma(v) * vs) (hsdApply, dcp.cc:2025,2090)."""
    r, g, b = x[0], x[1], x[2]
    neg = (r < 0) | (g < 0) | (b < 0)
    h, s, v = _rgb2hsv(torch.clamp(r, min=0), torch.clamp(g, min=0),
                       torch.clamp(b, min=0))
    venc = _srgb_enc(v) if srgb_enc else v
    hs, ss, vs = _hsm_lookup(table, dims, venc, h, s)
    h2 = h + hs * (6.0 / 360.0)
    h2 = torch.where(h2 < 0, h2 + 6.0, torch.where(h2 >= 6.0, h2 - 6.0, h2))
    s2 = torch.clamp(s * ss, 0.0, 1.0)
    v2 = _srgb_dec(venc * vs) if srgb_enc else v * vs
    if clip_sv:  # step2ApplyTile clips v too (dcp.cc:1585-1586)
        v2 = torch.clamp(v2, 0.0, 1.0)
    return torch.where(neg[None], x, torch.stack(_hsv2rgb(h2, s2, v2)))


def apply_dcp(rgb, data, static):
    """Step 1 (DCPProfile::apply, dcp.cc:1363): camera RGB (0..65535) to
    working RGB through the mixed matrices and the HueSatMap."""
    has_hsm, dims, srgb_enc = static
    x = mat3(data["dcp_cam2pro"], rgb * (1.0 / 65535.0))
    if has_hsm:
        x = _apply_hsv_table(x, data["dcp_hsm"], dims, srgb_enc)
    return mat3(data["dcp_pro2work"], x) * 65535.0


def apply_dcp_look(rgb, data, static):
    """Step 2 (step2ApplyTile, dcp.cc:1518): working RGB (0..65535) with
    the baseline exposure, then the look table and the profile's tone
    curve in linear ProPhoto (the curve on the max and min channels, the
    middle one keeping the hue: AdobeToneCurve, curves.h:425)."""
    bl_scale, has_look, look_dims, look_srgb, has_tc = static
    x = rgb
    if bl_scale != 1.0:
        x = x * bl_scale
    if not (has_look or has_tc):
        return x
    x = torch.clamp(mat3(data["dcp_work2pro"], x), min=0.0)
    if has_look:
        pro = torch.clamp(x, 0.0, 65535.5) * (1.0 / 65535.0)
        x = _apply_hsv_table(pro, data["dcp_look"], look_dims, look_srgb,
                             clip_sv=True) * 65535.0
    if has_tc:
        from art_tpu_torch.ops.tonecurve import _apply_filmlike

        x = _apply_filmlike(torch.clamp(x, 0.0, 65535.0), data["dcp_tc"])
    return mat3(data["dcp_pro2work"], x)
