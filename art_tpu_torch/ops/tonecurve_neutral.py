"""Neutral tone curve, kernel B7 (counterpart of
``art_tpu/ops/tonecurve_neutral.py``: ``apply_neutral`` ->
``_run_neutral_pallas`` -> ``_neutral_kernel``).

Pointwise on three planes: gamut compression toward the output space,
the brightness-preserving curve, Jzazbz hue twists (red/blue) and
saturation compensation; optionally the fused output epilogue
(work->out matrix, clip, sRGB encode). The math keeps the reference's
float32 forms: a polynomial atan2, Taylor sin/cos of the small hue
shift, Horner/Clenshaw curve fits and the polynomial PQ transfers; no
`atan2`, `sin` or `pow` of the platform.

`neutral_tone` is the kernel entry point: the plain PyTorch version
below on a CPU tensor, the kernel of ``csrc/neutral_tone.cu`` on a CUDA
tensor, or an error. Segment-represented curves take plain PyTorch math
on any device, as the reference sends them to XLA.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from art_tpu_torch import kernels
from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color import jzazbz
from art_tpu_torch.core.curve1d import (clenshaw, eval_curve, eval_split,
                                        fit_curve, fit_curve_split)
from art_tpu_torch.core.fmath import fdiv
from art_tpu_torch.core.image import MAXVAL

# gamut compress constants (curves.cc:903-908)
_DL = np.array([1.1, 1.2, 1.5])
_TH = np.array([0.85, 0.75, 0.95])
_S = (1.0 - _TH) / np.sqrt(_DL - 1.0)

_ATAN_C = (  # minimax odd poly for atan(t), |t|<=1
    0.9999993329, -0.3332985605, 0.1994653599, -0.1390853351,
    0.0964200441, -0.0559098861, 0.0218612288, -0.0040540580)

# the curve forms (rows, coefficients a row) the kernel is built for: the
# planner's fits, the even/odd split of deg_half 10-16 and the Chebyshev
# series of degree 15, 23 or 31 (core/curve1d.py); FORMS in
# csrc/neutral_tone.cu
KERNEL_FORMS = ((2, 11), (2, 13), (2, 15), (2, 17), (1, 16), (1, 24),
                (1, 32))


def _output_matrix_for(name: str):
    """Output primaries for a profile name (tonecurve_neutral.py::
    _output_matrix_for)."""
    n = (name or "").lower()
    if "2020" in n:
        return cs.MATRICES_RGB_TO_XYZ["Rec2020"]
    if "adobe" in n:
        return cs.MATRICES_RGB_TO_XYZ["Adobe RGB"]
    if "prophoto" in n or "large" in n:
        return cs.MATRICES_RGB_TO_XYZ["ProPhoto"]
    if "acesp0" in n:
        return cs.MATRICES_RGB_TO_XYZ["ACESp0"]
    if "acesp1" in n or "ap1" in n:
        return cs.MATRICES_RGB_TO_XYZ["ACESp1"]
    return cs.MATRICES_RGB_TO_XYZ["sRGB"]


def plan_neutral(pp, ctx, lut, whitept):
    """(static, data) with the curve fit and the 43-scalar params vector:
    work, iwork, to_out, to_work (3x3 each), the hue anchors and ranges,
    whitept (tonecurve_neutral.py::plan_neutral)."""
    work = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]]
    iwork = np.linalg.inv(work)
    om = _output_matrix_for(pp.icm.output_profile)
    to_out = np.linalg.inv(om) @ work
    to_work = iwork @ om
    hws = cs.MATRICES_RGB_TO_XYZ["Rec2020"]
    rhue = jzazbz.hue_of((1.0, 0.0, 0.0), hws)
    bhue = jzazbz.hue_of((0.0, 0.0, 1.0), hws)
    yhue = jzazbz.hue_of((1.0, 1.0, 0.0), hws)
    ohue = jzazbz.hue_of((1.0, 0.5, 0.0), hws)
    yrange = abs(ohue - yhue) * 0.8
    rrange = abs(ohue - rhue)
    coeffs = fit_curve_split(lut)
    if coeffs is None:
        coeffs = fit_curve(lut)
    params = np.concatenate([
        np.asarray(work, np.float64).ravel(),
        np.asarray(iwork, np.float64).ravel(),
        np.asarray(to_out, np.float64).ravel(),
        np.asarray(to_work, np.float64).ravel(),
        np.array([rhue, bhue, yhue, rrange, rrange, yrange, whitept]),
    ]).astype(np.float32)
    return (), {"coeffs": coeffs, "params": params}


# ---------------------------------------------------------------------------
# plain PyTorch version: the reference's scalar-level math on tensors


def _atan2_poly(a, b):
    aa = torch.abs(a)
    ab = torch.abs(b)
    hi = torch.maximum(aa, ab)
    lo = torch.minimum(aa, ab)
    t = lo / torch.clamp(hi, min=1e-30)
    s = t * t
    acc = torch.full_like(t, _ATAN_C[7])
    for c in _ATAN_C[6::-1]:
        acc = acc * s + c
    r = t * acc
    r = torch.where(aa > ab, (np.pi / 2) - r, r)
    r = torch.where(b < 0, np.pi - r, r)
    return torch.where(a < 0, -r, r)


def _sincos_small(d):
    d2 = d * d
    sin_d = d * (1.0 - d2 * (1.0 / 6.0) * (1.0 - d2 * 0.05))
    cos_d = 1.0 - d2 * 0.5 * (1.0 - d2 * (1.0 / 12.0))
    return sin_d, cos_d


def _jzazbz_fwd(r, g, b, P):
    m = jzazbz.D50_TO_D65
    x = P[0] * r + P[1] * g + P[2] * b
    y = P[3] * r + P[4] * g + P[5] * b
    z = P[6] * r + P[7] * g + P[8] * b
    x, y, z = (float(m[0, 0]) * x + float(m[0, 1]) * y + float(m[0, 2]) * z,
               float(m[1, 0]) * x + float(m[1, 1]) * y + float(m[1, 2]) * z,
               float(m[2, 0]) * x + float(m[2, 1]) * y + float(m[2, 2]) * z)
    lp = jzazbz.pq(0.674207838 * x + 0.382799340 * y - 0.047570458 * z)
    mp = jzazbz.pq(0.149284160 * x + 0.739628340 * y + 0.083327300 * z)
    sp = jzazbz.pq(0.070941080 * x + 0.174768000 * y + 0.670970020 * z)
    iz = 0.5 * (lp + mp)
    az = 3.524000 * lp - 4.066708 * mp + 0.542708 * sp
    bz = 0.199076 * lp + 1.096799 * mp - 1.295875 * sp
    jz = (0.44 * iz) / (1.0 - 0.56 * iz) - 1.6295499532821566e-11
    return jz, az, bz


def _jzazbz_inv(jz, az, bz, P):
    jz = jz + 1.6295499532821566e-11
    iz = jz / (0.44 + 0.56 * jz)
    l = jzazbz.pq_inv(
        iz + 1.386050432715393e-1 * az + 5.804731615611869e-2 * bz)
    m = jzazbz.pq_inv(
        iz - 1.386050432715393e-1 * az - 5.804731615611891e-2 * bz)
    s = jzazbz.pq_inv(
        iz - 9.601924202631895e-2 * az - 8.118918960560390e-1 * bz)
    x = (1.661373055774069e+00 * l - 9.145230923250668e-01 * m
         + 2.313620767186147e-01 * s)
    y = (-3.250758740427037e-01 * l + 1.571847038366936e+00 * m
         - 2.182538318672940e-01 * s)
    z = (-9.098281098284756e-02 * l - 3.127282905230740e-01 * m
         + 1.522766561305260e+00 * s)
    mm = jzazbz.D65_TO_D50
    x, y, z = (
        float(mm[0, 0]) * x + float(mm[0, 1]) * y + float(mm[0, 2]) * z,
        float(mm[1, 0]) * x + float(mm[1, 1]) * y + float(mm[1, 2]) * z,
        float(mm[2, 0]) * x + float(mm[2, 1]) * y + float(mm[2, 2]) * z)
    return (P[9] * x + P[10] * y + P[11] * z,
            P[12] * x + P[13] * y + P[14] * z,
            P[15] * x + P[16] * y + P[17] * z)


def _gauss(x, b, c):
    c = np.float32(c)
    return torch.exp(fdiv(-((x - b) ** 2), np.float32(2.0) * c * c))


def _filmlike_clip3(r, g, b, lmax):
    hi = torch.maximum(torch.maximum(r, g), b)
    lo = torch.minimum(torch.minimum(r, g), b)
    mid = r + g + b - hi - lo
    hi_c = torch.clamp(hi, max=lmax)
    lo_c = torch.clamp(lo, max=lmax)
    denom = hi - lo
    pos = denom > 0
    mid_c = torch.where(
        pos, lo_c + (hi_c - lo_c) * (mid - lo)
        / torch.where(pos, denom, torch.ones_like(denom)), hi_c)

    def pick(ch):
        return torch.where(ch >= hi, hi_c, torch.where(ch <= lo, lo_c, mid_c))

    return pick(r), pick(g), pick(b)


def _neutral_core(r, g, b, P, curve_fn):
    """The Neutral transform on three planes in the 0..MAXVAL domain; P:
    the params as Python floats (f32 values)."""
    rhue, bhue, yhue = P[36], P[37], P[38]
    rrange, brange, yrange = P[39], P[40], P[41]
    whitept = P[42]
    lmax = float(np.float32(whitept) * np.float32(MAXVAL))

    r = torch.clamp(r * (1.0 / MAXVAL), min=0.0)
    g = torch.clamp(g * (1.0 / MAXVAL), min=0.0)
    b = torch.clamp(b * (1.0 / MAXVAL), min=0.0)
    ilum, az1, bz1 = _jzazbz_fwd(r, g, b, P)
    cz1 = torch.sqrt(az1 * az1 + bz1 * bz1)
    hue0 = _atan2_poly(az1, bz1)
    iy = (r + g + b) * (1.0 / 3.0)

    o0 = P[18] * r + P[19] * g + P[20] * b
    o1 = P[21] * r + P[22] * g + P[23] * b
    o2 = P[24] * r + P[25] * g + P[26] * b
    ac = torch.maximum(torch.maximum(o0, o1), o2)
    aac = torch.abs(ac)
    safe = torch.where(aac > 0, aac, torch.ones_like(aac))
    outs = []
    for c, oc in enumerate((o0, o1, o2)):
        d = torch.where(ac != 0, (ac - oc) / safe, torch.zeros_like(ac))
        th = float(_TH[c])
        s = float(_S[c])
        compr = (s * torch.sqrt(torch.clamp(d - th, min=0.0) + s * s / 4.0)
                 - s * np.sqrt(s * s / 4.0) + th)
        cd = torch.where(d < th, d, compr)
        outs.append(ac - cd * aac)
    o0, o1, o2 = outs
    r = P[27] * o0 + P[28] * o1 + P[29] * o2
    g = P[30] * o0 + P[31] * o1 + P[32] * o2
    b = P[33] * o0 + P[34] * o1 + P[35] * o2

    oy = (r + g + b) * (1.0 / 3.0)
    f = torch.where(oy > 0, iy / torch.where(oy > 0, oy, torch.ones_like(oy)),
                    torch.ones_like(oy))
    r, g, b = r * f, g * f, b * f
    r, g, b = _filmlike_clip3(r, g, b, whitept)

    r = curve_fn(r)
    g = curve_fn(g)
    b = curve_fn(b)

    jz, az2, bz2 = _jzazbz_fwd(r, g, b, P)
    cz = torch.sqrt(az2 * az2 + bz2 * bz2)

    hue_shift = 15.0 * (np.pi / 180.0) * _gauss(hue0, rhue, rrange)
    hue_shift = (hue_shift
                 - 5.0 * (np.pi / 180.0) * _gauss(hue0, bhue, brange))
    hue_shift = hue_shift * torch.clamp(
        fdiv(r + g + b, np.float32(3.0) * np.float32(whitept)), 0.0, 1.0)
    hue = hue0 + hue_shift

    ccf = torch.where(
        ilum > 1e-5,
        1.0 - torch.clamp(jz / torch.clamp(ilum, min=1e-5) - 1.0, 0.0, 1.0)
        * 0.2,
        torch.ones_like(ilum))
    ccf = torch.clamp(ccf + 0.5 * _gauss(hue, yhue, yrange), 0.0, 1.0)

    sin_d, cos_d = _sincos_small(hue_shift)
    inv_c1 = torch.where(cz1 > 1e-20, 1.0 / torch.clamp(cz1, min=1e-20),
                         torch.zeros_like(cz1))
    scale = cz * ccf * inv_c1
    az = scale * (az1 * cos_d + bz1 * sin_d)
    bz = scale * (bz1 * cos_d - az1 * sin_d)

    r, g, b = _jzazbz_inv(jz, az, bz, P)
    r = torch.clamp(r * MAXVAL, 0.0, lmax)
    g = torch.clamp(g * MAXVAL, 0.0, lmax)
    b = torch.clamp(b * MAXVAL, 0.0, lmax)
    return r, g, b


def _epilogue(r, g, b, W, trc):
    """work->out matrix, clip to [0,1], TRC encode (develop.py rgb2out)."""
    inv = 1.0 / MAXVAL
    out = []
    for i in range(3):
        o = (W[3 * i] * r + W[3 * i + 1] * g + W[3 * i + 2] * b) * inv
        o = torch.clamp(o, 0.0, 1.0)
        if trc == "srgb":
            o = cs.srgb_gamma_torch(o)
        out.append(o)
    return out


def _curve_fn(coeffs):
    c = coeffs.tolist()
    if len(c) == 2:
        return lambda x: eval_split(x, c)

    def cheb(x):
        t = 2.0 * torch.sqrt(torch.clamp(x, 0.0, 1.0)) - 1.0
        return clenshaw(t, c[0])
    return cheb


def neutral_plain(rgb, params, coeffs, epi=None):
    """Plain PyTorch version of the kernel. coeffs: (2, K) split or (1, D)
    Chebyshev. Counts its calls in `.calls`."""
    neutral_plain.calls += 1
    P = params.tolist()
    r, g, b = _neutral_core(rgb[0], rgb[1], rgb[2], P, _curve_fn(coeffs))
    if epi:
        r, g, b = _epilogue(r, g, b, P[43:52], epi)
    return torch.stack([r, g, b])


neutral_plain.calls = 0


# ---------------------------------------------------------------------------
# kernel wrapper

_EPI = {None: 0, "srgb": 1, "linear": 2}


@functools.lru_cache(None)
def _consts_np():
    """Host-derived float32 constants the kernel takes by value (layout
    in csrc/neutral_tone.cu): PQ fits, the sRGB fit, gamut-compression
    constants and the Bradford matrices."""
    pf, qf, pi, qi, ymax = jzazbz.pq_fits()
    pol, t0 = cs._srgb_gamma_fit()
    if (len(pf), len(qf), len(pi), len(qi), len(pol)) != (12, 12, 10, 10, 9):
        raise RuntimeError("fit sizes changed; update csrc/neutral_tone.cu")
    s = _S
    vals = (list(pf) + list(qf) + list(pi) + list(qi)
            + [1.0 / ymax, t0, 1.0 - t0] + list(pol)
            + list(_TH) + list(s) + list(s * s / 4.0)
            + list(s * np.sqrt(s * s / 4.0))
            + list(jzazbz.D50_TO_D65.ravel())
            + list(jzazbz.D65_TO_D50.ravel()))
    return np.asarray(vals, dtype=np.float32)


def neutral_tone(rgb, params, coeffs, epi=None):
    """Neutral tone curve (+ optional epilogue) of a (3, H, W) float32
    stack. params: 43 scalars (52 with the work2out matrix for the
    epilogue); coeffs: (2, K) split or (1, D) Chebyshev fit; epi: None,
    "srgb" or "linear"."""
    if rgb.ndim != 3 or rgb.shape[0] != 3 or rgb.dtype != torch.float32:
        raise ValueError(f"want float32 (3, H, W), got {rgb.dtype} "
                         f"{tuple(rgb.shape)}")
    if epi not in _EPI:
        raise NotImplementedError(f"neutral epilogue TRC {epi!r}")
    want = 52 if epi else 43
    if params.ndim != 1 or params.shape[0] != want:
        raise ValueError(f"params: want ({want},), got {tuple(params.shape)}")
    if coeffs.ndim != 2 or coeffs.shape[0] not in (1, 2):
        raise ValueError(f"coeffs: want (2, K) or (1, D), got "
                         f"{tuple(coeffs.shape)}")
    if tuple(coeffs.shape) not in KERNEL_FORMS:
        raise NotImplementedError(
            f"coeffs {tuple(coeffs.shape)}: the kernel is built for the "
            f"planner's curve forms {KERNEL_FORMS}")
    if rgb.device.type == "cpu":
        return neutral_plain(rgb, params, coeffs, epi)
    if rgb.device.type != "cuda":
        raise ValueError(f"no neutral kernel for device {rgb.device}")
    for name, t in (("params", params), ("coeffs", coeffs)):
        if t.device != rgb.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: want float32 on {rgb.device}, got "
                             f"{t.dtype} on {t.device}")
    rgb = rgb.contiguous()
    params = params.contiguous()
    coeffs = coeffs.contiguous()
    out = torch.empty_like(rgb)
    lib = kernels.library()
    rc = lib.art_neutral_tone(
        rgb.data_ptr(), out.data_ptr(), params.data_ptr(),
        coeffs.data_ptr(), _consts_np().ctypes.data, rgb[0].numel(),
        params.shape[0], coeffs.shape[0], coeffs.shape[1], _EPI[epi],
        kernels.stream_of(rgb))
    kernels.check(rc, "art_neutral_tone")
    neutral_tone.launches += 1
    return out


neutral_tone.launches = 0


def layout(coeffs_shape, epi):
    """The kernel of a curve form and epilogue on the card: registers,
    shared and local memory (``art_neutral_layout``)."""
    buf = ctypes.create_string_buffer(512)
    kernels.check(kernels.library().art_neutral_layout(
        buf, len(buf), *coeffs_shape, _EPI[epi]), "art_neutral_layout")
    return buf.value.decode()


def apply_neutral(rgb, data, static):
    """Dispatch (tonecurve_neutral.py::apply_neutral): a trailing ("epi",
    trc) static entry appends data["out_mat"] to the params and fuses
    the output transform."""
    coeffs = data["coeffs"]
    params = data["params"]
    epi = None
    if static and isinstance(static[-1], tuple) and static[-1][0] == "epi":
        epi = static[-1][1][0]
        params = torch.cat([params.reshape(-1),
                            data["out_mat"].to(params.dtype).reshape(-1)])
    if coeffs.ndim == 2 and coeffs.shape[0] not in (1, 2):
        # segment fits: plain math on any device (the reference's XLA path)
        P = params.tolist()
        r, g, b = _neutral_core(
            rgb[0], rgb[1], rgb[2], P,
            lambda x: eval_curve(x, coeffs, in_max=1.0, out_max=1.0))
        if epi:
            r, g, b = _epilogue(r, g, b, P[43:52], epi)
        return torch.stack([r, g, b])
    if coeffs.ndim == 1:
        coeffs = coeffs.reshape(1, -1)
    return neutral_tone(rgb, params, coeffs, epi)
