"""LittleCMS 2.17's pipeline stages in its own arithmetic, for
``color/lcms.py``'s model of a transform.

A pipeline is a list of stages; `eval_float` runs it as
``cmsPipelineEvalFloat`` does: float32 values from stage to stage, each
stage's sums in double where the C code sums in double. The stages:

- a curve set (``EvaluateCurves`` through ``cmsEvalToneCurveFloat``): a
  16-bit table through ``_cmsQuickSaturateWord`` and ``LinLerp1D``; a
  segmented curve (``EvalSegmentedFn``) of parametric types 1-5 and
  their reverses, the formula segments 6-8 of a ``curf`` and sampled
  segments through ``LinLerp1Dfloat``;
- a matrix with or without an offset (``EvaluateMatrix``), which also
  carries the PCS normalisers (v2/v4 Lab, the float PCS of a D2Bx tag);
- a 16-bit CLUT (``EvaluateCLUTfloatIn16``: to 16 bits, then
  ``TetrahedralInterp16`` or, where LittleCMS switches it,
  ``TrilinearInterp16``) and a float CLUT (``TetrahedralInterpFloat``,
  ``TrilinearInterpFloat``), three inputs;
- Lab to XYZ and XYZ to Lab (``EvaluateLab2XYZ``, ``EvaluateXYZ2Lab``).

`read_lut_tag` reads an ``mft1``, ``mft2`` or ``mAB `` tag into stages
as ``cmstypes.c`` does; `pre_optimize` is ``cmsopt.c``'s PreOptimize.
Powers and logarithms go through Python's ``math`` (the C library's
``pow`` and ``log10``), one call per distinct value.
"""

from __future__ import annotations

import math
import struct

import numpy as np

MATRIX_DET_TOLERANCE = 0.0001
MAX_ENCODEABLE_XYZ = 1.0 + 32767.0 / 32768.0
D50 = (0.9642, 1.0, 0.8249)
PLUS_INF = float(np.float32(1e22))
MINUS_INF = float(np.float32(-1e22))
_F32 = np.float32


# -- numbers (lcms2_internal.h) ----------------------------------------------

def quick_floor(v):
    """_cmsQuickFloor: the double's 16.16 fixed-point image after adding
    1.5 * 2^36 (so rounded to 2^-16 first), floored."""
    t = np.asarray(v, np.float64) + 103079215104.0
    low = (t.view(np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return low >> 16


def quick_saturate_word(d):
    """_cmsQuickSaturateWord of doubles -> int64 in 0..65535."""
    d = np.asarray(d, np.float64) + 0.5
    w = (quick_floor(d - 32767.0).astype(np.int64) + 32767) & 0xFFFF
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 0xFFFF, w))


def from_16_to_8(w):
    return ((np.asarray(w, np.int64) * 65281 + 8388608) >> 24) & 0xFF


def to_16(v):
    """FromFloatTo16: float32 values to 16-bit words (int64)."""
    return quick_saturate_word(np.asarray(v, np.float32).astype(np.float64)
                               * 65535.0)


def from_16(w):
    """From16ToFloat: ``(cmsFloat32Number) In / 65535.0F``."""
    return np.asarray(w, np.int64).astype(_F32) / _F32(65535.0)


def to_fixed_domain(a):
    """_cmsToFixedDomain: a 0..0xFFFF (times a domain) value to 16.16."""
    a = np.asarray(a, np.int64)
    return a + (a + 0x7FFF) // 0xFFFF


def lin_lerp16(v, table):
    """LinLerp1D: a 16-bit table at 16-bit inputs (int64 arrays)."""
    table = np.asarray(table, np.int64)
    v = np.asarray(v, np.int64)
    n1 = len(table) - 1
    if n1 == 0:
        return np.full(v.shape, table[0], np.int64)
    a = n1 * v
    val3 = a + (a + 0x7FFF) // 0xFFFF
    cell0 = np.minimum(val3 >> 16, n1 - 1)
    rest = val3 & 0xFFFF
    y0 = table[cell0]
    y1 = table[cell0 + 1]
    dif = ((((y1 - y0) % (1 << 32)) * rest + 0x8000) % (1 << 32)) >> 16
    out = ((dif + y0) % (1 << 32)) & 0xFFFF
    return np.where(v == 0xFFFF, table[n1], out)


def fclamp(v):
    """fclamp: below 1e-9 (or NaN) to 0, above 1 to 1, in float32."""
    v = np.asarray(v, _F32)
    return np.where((v < _F32(1e-9)) | np.isnan(v), _F32(0.0),
                    np.where(v > _F32(1.0), _F32(1.0), v)).astype(_F32)


# -- curves (cmsgamma.c) -----------------------------------------------------

def _pow(a, b):
    """C's pow (glibc), with its inf and nan where Python raises."""
    try:
        return math.pow(a, b)
    except ZeroDivisionError:
        return math.inf
    except ValueError:
        return math.nan
    except OverflowError:
        return -math.inf if a < 0 and b % 2 == 1 else math.inf


def _log10(e):
    try:
        return math.log10(e)
    except ValueError:
        return -math.inf if e == 0 else math.nan


def eval_parametric(kind, p, r):
    """DefaultEvalParametricFn at one double: the types a ``para`` tag
    takes (1-5), the reversed sRGB curve (-4) and a ``curf``'s formula
    segments (6-8)."""
    if kind == 1:
        if r < 0:
            return r if abs(p[0] - 1.0) < MATRIX_DET_TOLERANCE else 0.0
        return _pow(r, p[0])
    if kind == 2:
        if abs(p[1]) < MATRIX_DET_TOLERANCE:
            return 0.0
        if r >= -p[2] / p[1]:
            e = p[1] * r + p[2]
            return _pow(e, p[0]) if e > 0 else 0.0
        return 0.0
    if kind == 3:
        if abs(p[1]) < MATRIX_DET_TOLERANCE:
            return 0.0
        disc = max(-p[2] / p[1], 0.0)
        if r >= disc:
            e = p[1] * r + p[2]
            return _pow(e, p[0]) + p[3] if e > 0 else 0.0
        return p[3]
    if kind == 4:
        if r >= p[4]:
            e = p[1] * r + p[2]
            return _pow(e, p[0]) if e > 0 else 0.0
        return r * p[3]
    if kind == 5:
        if r >= p[4]:
            e = p[1] * r + p[2]
            return _pow(e, p[0]) + p[5] if e > 0 else p[5]
        return r * p[3] + p[6]
    if kind == -4:
        e = p[1] * p[4] + p[2]
        disc = 0.0 if e < 0 else _pow(e, p[0])
        if r >= disc:
            if abs(p[0]) < MATRIX_DET_TOLERANCE or \
                    abs(p[1]) < MATRIX_DET_TOLERANCE:
                return 0.0
            return (_pow(r, 1.0 / p[0]) - p[2]) / p[1]
        return 0.0 if abs(p[3]) < MATRIX_DET_TOLERANCE else r / p[3]
    if kind == 6:  # Y = (a X + b)^g + c
        e = p[1] * r + p[2]
        if p[0] == 1.0:
            return e + p[3]
        return p[3] if e < 0 else _pow(e, p[0]) + p[3]
    if kind == 7:  # Y = a log10(b X^g + c) + d
        e = p[2] * _pow(r, p[0]) + p[3]
        return p[4] if e <= 0 else p[1] * _log10(e) + p[4]
    if kind == 8:  # Y = a b^(c X + d) + e
        return p[0] * _pow(p[1], p[2] * r + p[3]) + p[4]
    raise NotImplementedError(f"parametric curve type {kind}")


def param_curve(kind, params):
    """cmsBuildParametricToneCurve: one segment over the whole line."""
    p = tuple(float(v) for v in params) + (0.0,) * (10 - len(params))
    return ("seg", ((MINUS_INF, PLUS_INF, kind, p),))


def _lerp1d_float(r1, pts):
    """LinLerp1Dfloat of float32 `r1` on float32 samples `pts`."""
    dom = _F32(len(pts) - 1)
    v = fclamp(r1)
    last = v == _F32(1.0)
    v = (v * dom).astype(_F32)
    c0 = np.floor(v).astype(np.int64)
    c1 = np.ceil(v).astype(np.int64)
    rest = (v - c0.astype(_F32)).astype(_F32)
    c0 = np.minimum(c0, len(pts) - 1)
    c1 = np.minimum(c1, len(pts) - 1)
    y0, y1 = pts[c0], pts[c1]
    out = (y0 + ((y1 - y0).astype(_F32) * rest).astype(_F32)).astype(_F32)
    return np.where(last, pts[-1], out)


def _eval_segmented(segments, r):
    """EvalSegmentedFn at doubles `r`: the last segment whose (x0, x1]
    holds the value; none gives MINUS_INF, an infinite result PLUS_INF."""
    out = np.full(r.shape, MINUS_INF)
    done = np.zeros(r.shape, bool)
    for x0, x1, kind, data in reversed(segments):
        m = ~done & (r > x0) & (r <= x1)
        if not m.any():
            continue
        done |= m
        rm = r[m]
        if kind == 0:
            r1 = (rm - x0).astype(_F32) / (_F32(x1) - _F32(x0))
            out[m] = _lerp1d_float(r1.astype(_F32), data).astype(np.float64)
        else:
            uniq, inv = np.unique(rm, return_inverse=True)
            vals = np.array([eval_parametric(kind, data, float(u))
                             for u in uniq], np.float64)
            out[m] = vals[inv]
    return np.where(np.isinf(out), PLUS_INF, out)


def curve_float(curve, v):
    """cmsEvalToneCurveFloat at float32 inputs -> float32."""
    v = np.asarray(v, _F32)
    if curve[0] == "table":
        w = quick_saturate_word(v.astype(np.float64) * 65535.0)
        return (lin_lerp16(w, curve[1]) / 65535.0).astype(_F32)
    flat = v.ravel().astype(np.float64)
    return _eval_segmented(curve[1], flat).astype(_F32).reshape(v.shape)


def curve_table16(curve):
    """The 16-bit table LittleCMS keeps beside a curve: a table curve's
    own; a segmented curve's 4096 samples (a type-1 gamma's own count
    is not needed here: only `is_degenerated` reads it)."""
    if curve[0] == "table":
        return np.asarray(curve[1], np.int64)
    r = np.arange(4096, dtype=np.float64) / 4095
    return quick_saturate_word(_eval_segmented(curve[1], r) * 65535.0)


# -- stages (cmslut.c, cmsintrp.c) -------------------------------------------

class Stage:
    """A stage: ``type`` is cmsStageType's answer, ``implements`` what
    PreOptimize reads."""

    type = implements = ""
    n_in = n_out = 3

    def __call__(self, x):
        raise NotImplementedError


class Curves(Stage):
    type = implements = "cvst"

    def __init__(self, curves):
        self.curves = list(curves)
        self.n_in = self.n_out = len(self.curves)

    def __call__(self, x):
        return np.stack([curve_float(c, x[:, i])
                         for i, c in enumerate(self.curves)], -1)


class Matrix(Stage):
    """EvaluateMatrix: each output summed in double, in input order, the
    offset last, rounded to float32."""

    type = "matf"

    def __init__(self, rows, cols, m, off=None, implements="matf"):
        self.n_out, self.n_in = rows, cols
        self.m = np.asarray(m, np.float64).reshape(rows, cols)
        self.off = None if off is None else np.asarray(off, np.float64)
        self.implements = implements

    def __call__(self, x):
        x = np.asarray(x, _F32).astype(np.float64)
        out = np.empty((len(x), self.n_out), _F32)
        for i in range(self.n_out):
            t = 0.0 + x[:, 0] * self.m[i, 0]
            for j in range(1, self.n_in):
                t = t + x[:, j] * self.m[i, j]
            if self.off is not None:
                t = t + self.off[i]
            out[:, i] = t.astype(_F32)
        return out


def _tetra_weights(rx, ry, rz):
    """TetrahedralInterp's six cases, in the C code's order of tests."""
    return [(rx >= ry) & (ry >= rz), (rx >= rz) & (rz >= ry),
            (rz >= rx) & (rx >= ry), (ry >= rx) & (rx >= rz),
            (ry >= rz) & (rz >= rx), (rz >= ry) & (ry >= rx)]


def _tetra_deltas(d, x0, y0, z0, x1, y1, z1):
    """(c1, c2, c3) of each case, as node differences."""
    return (
        [d(x1, y0, z0) - d(x0, y0, z0), d(x1, y0, z0) - d(x0, y0, z0),
         d(x1, y0, z1) - d(x0, y0, z1), d(x1, y1, z0) - d(x0, y1, z0),
         d(x1, y1, z1) - d(x0, y1, z1), d(x1, y1, z1) - d(x0, y1, z1)],
        [d(x1, y1, z0) - d(x1, y0, z0), d(x1, y1, z1) - d(x1, y0, z1),
         d(x1, y1, z1) - d(x1, y0, z1), d(x0, y1, z0) - d(x0, y0, z0),
         d(x0, y1, z0) - d(x0, y0, z0), d(x0, y1, z1) - d(x0, y0, z1)],
        [d(x1, y1, z1) - d(x1, y1, z0), d(x1, y0, z1) - d(x1, y0, z0),
         d(x0, y0, z1) - d(x0, y0, z0), d(x1, y1, z1) - d(x1, y1, z0),
         d(x0, y1, z1) - d(x0, y1, z0), d(x0, y0, z1) - d(x0, y0, z0)])


def _i32(x):
    """int64 values wrapped to int32, as the C code's int sums wrap."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def tetra16(lut, i0, i1, r):
    """TetrahedralInterp16's sums on a (nx, ny, nz, n_out) table: base
    nodes i0, upper nodes i1 and 16-bit rests r, (N, 3) each. Each of the
    C code's six cases is the path from the base node to the far one
    along the axes in decreasing order of rest, the sum of each step's
    difference times its axis's rest; where rests tie, every path gives
    the same sum. In int32, which wraps as the C code's ints do."""
    nx, ny, nz, n_out = lut.shape
    flat = np.asarray(lut, np.int32).reshape(-1, n_out)
    i0 = np.asarray(i0, np.int32)
    r = np.asarray(r, np.int32)
    stride = np.array([ny * nz, nz, 1], np.int32)
    steps = (np.asarray(i1, np.int32) - i0) * stride
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
    first = np.where((rx >= ry) & (rx >= rz), 0, np.where(ry >= rz, 1, 2))
    last = np.where((rz <= ry) & (rz <= rx), 2, np.where(ry <= rx, 1, 0))
    order = np.stack([first, 3 - first - last, last], -1)
    step = np.take_along_axis(steps, order, 1)
    rr = np.take_along_axis(r, order, 1)
    k1 = (i0 * stride).sum(1, dtype=np.int32) + step[:, 0]
    k2 = k1 + step[:, 1]
    v0 = flat[k1 - step[:, 0]]
    v1, v2, v3 = flat[k1], flat[k2], flat[k2 + step[:, 2]]
    rest = (v1 - v0) * rr[:, 0:1] + (v2 - v1) * rr[:, 1:2] \
        + (v3 - v2) * rr[:, 2:3] + np.int32(0x8001)
    return ((v0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF).astype(np.int64)


def trilinear16(lut, i0, i1, r):
    """TrilinearInterp16: LERP (l + ((h - l) a + 0x8000) >> 16, to 16
    bits) along x, then y, then z."""
    rx, ry, rz = r[:, 0:1], r[:, 1:2], r[:, 2:3]
    x0, y0, z0 = i0[:, 0], i0[:, 1], i0[:, 2]
    x1, y1, z1 = i1[:, 0], i1[:, 1], i1[:, 2]

    def lerp(a, lo, hi):
        return (lo + (_i32(_i32((hi - lo) * a) + 0x8000) >> 16)) & 0xFFFF

    dx00 = lerp(rx, lut[x0, y0, z0], lut[x1, y0, z0])
    dx01 = lerp(rx, lut[x0, y0, z1], lut[x1, y0, z1])
    dx10 = lerp(rx, lut[x0, y1, z0], lut[x1, y1, z0])
    dx11 = lerp(rx, lut[x0, y1, z1], lut[x1, y1, z1])
    return lerp(rz, lerp(ry, dx00, dx10), lerp(ry, dx01, dx11))


def interp16(lut, w16, trilinear=False):
    """A 16-bit CLUT (nx, ny, nz, n_out) at 16-bit inputs (N, 3):
    TetrahedralInterp16 or TrilinearInterp16."""
    dom = np.array(lut.shape[:3], np.int64) - 1
    f = to_fixed_domain(w16 * dom)
    i0 = f >> 16
    i1 = np.where(w16 == 0xFFFF, i0, i0 + 1)
    return (trilinear16 if trilinear else tetra16)(lut, i0, i1, f & 0xFFFF)


def interp_float(lut, x, trilinear=False):
    """TetrahedralInterpFloat or TrilinearInterpFloat of a float32 CLUT
    (nx, ny, nz, n_out) at float32 inputs (N, 3)."""
    c = fclamp(x)
    dom = np.array(lut.shape[:3], np.int64) - 1
    p = (c * dom.astype(_F32)).astype(_F32)
    i0 = np.floor(p).astype(np.int64)
    fr = (p - i0.astype(_F32)).astype(_F32)
    i1 = np.where(c >= _F32(1.0), i0, i0 + 1)
    rx, ry, rz = fr[:, 0:1], fr[:, 1:2], fr[:, 2:3]
    x0, y0, z0 = i0[:, 0], i0[:, 1], i0[:, 2]
    x1, y1, z1 = i1[:, 0], i1[:, 1], i1[:, 2]

    def d(x, y, z):
        return lut[x, y, z]

    if trilinear:
        def lerp(a, lo, hi):
            return (lo + ((hi - lo) * a).astype(_F32)).astype(_F32)

        dx00 = lerp(rx, d(x0, y0, z0), d(x1, y0, z0))
        dx01 = lerp(rx, d(x0, y0, z1), d(x1, y0, z1))
        dx10 = lerp(rx, d(x0, y1, z0), d(x1, y1, z0))
        dx11 = lerp(rx, d(x0, y1, z1), d(x1, y1, z1))
        return lerp(rz, lerp(ry, dx00, dx10), lerp(ry, dx01, dx11))
    c0 = d(x0, y0, z0)
    conds = _tetra_weights(rx, ry, rz)
    c1s, c2s, c3s = _tetra_deltas(d, x0, y0, z0, x1, y1, z1)
    c1, c2, c3 = (np.select(conds, cs, _F32(0)).astype(_F32)
                  for cs in (c1s, c2s, c3s))
    out = (c0 + (c1 * rx).astype(_F32)).astype(_F32)
    out = (out + (c2 * ry).astype(_F32)).astype(_F32)
    return (out + (c3 * rz).astype(_F32)).astype(_F32)


class Clut(Stage):
    """A CLUT of three inputs: 16-bit (``EvaluateCLUTfloatIn16``) or
    float; tetrahedral unless a device link's Lab output switched it to
    trilinear (``ChangeInterpolationToTrilinear``)."""

    type = implements = "clut"

    def __init__(self, table, is_float=False):
        self.table = np.asarray(table, _F32 if is_float else np.int64)
        self.n_in = self.table.ndim - 1
        self.n_out = self.table.shape[-1]
        self.is_float = is_float
        self.trilinear = False

    def __call__(self, x):
        if self.n_in != 3:
            raise NotImplementedError(
                f"ICC CLUT of {self.n_in} inputs inside an RGB profile's "
                "table")
        if self.is_float:
            return interp_float(self.table, x, self.trilinear)
        return from_16(interp16(self.table, to_16(x), self.trilinear))


def _lab_f1(t):
    """cmsLab2XYZ's f_1."""
    return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0),
                    t * t * t)


class Lab2XYZ(Stage):
    """EvaluateLab2XYZ: v4 Lab encoding to XYZ over MAX_ENCODEABLE_XYZ."""

    type = implements = "x2l "  # lcms2.h's signature for this stage

    def __call__(self, x):
        v = np.asarray(x, _F32).astype(np.float64)
        y = (v[:, 0] * 100.0 + 16.0) / 116.0
        xx = y + 0.002 * (v[:, 1] * 255.0 - 128.0)
        z = y - 0.005 * (v[:, 2] * 255.0 - 128.0)
        return np.stack([(_lab_f1(t) * D50[k] / MAX_ENCODEABLE_XYZ)
                         .astype(_F32) for k, t in enumerate((xx, y, z))],
                        -1)


def _cube_root(t):
    uniq, inv = np.unique(t, return_inverse=True)
    return np.array([_pow(float(u), 1.0 / 3.0) for u in uniq])[inv]


def _lab_f(t):
    """cmsXYZ2Lab's f: pow(t, 1/3) above the limit."""
    lim = (24.0 / 116.0) * (24.0 / 116.0) * (24.0 / 116.0)
    lo = (841.0 / 108.0) * t + (16.0 / 116.0)
    return np.where(t <= lim, lo, _cube_root(np.where(t <= lim, 1.0, t)))


class XYZ2Lab(Stage):
    """EvaluateXYZ2Lab: XYZ over MAX_ENCODEABLE_XYZ to v4 Lab encoding."""

    type = implements = "l2x "

    def __call__(self, x):
        v = np.asarray(x, _F32).astype(np.float64) * MAX_ENCODEABLE_XYZ
        fx, fy, fz = (_lab_f(v[:, k] / D50[k]) for k in range(3))
        L = 116.0 * fy - 16.0
        a = 500.0 * (fx - fy)
        b = 200.0 * (fy - fz)
        return np.stack([(L / 100.0).astype(_F32),
                         ((a + 128.0) / 255.0).astype(_F32),
                         ((b + 128.0) / 255.0).astype(_F32)], -1)


def lab_v2_to_v4():
    """_cmsStageAllocLabV2ToV4: the v2 16-bit Lab encoding to v4."""
    k = 65535.0 / 65280.0
    return Matrix(3, 3, np.diag([k, k, k]), implements="2 4 ")


def lab_v4_to_v2():
    k = 65280.0 / 65535.0
    return Matrix(3, 3, np.diag([k, k, k]), implements="4 2 ")


def normalize_from_xyz_float():
    """_cmsStageNormalizeFromXyzFloat: a D2Bx tag's XYZ to the PCS."""
    n = 32768.0 / 65535.0
    return Matrix(3, 3, np.diag([n, n, n]), implements="d2x ")


def normalize_from_lab_float():
    """_cmsStageNormalizeFromLabFloat: a D2Bx tag's Lab to the PCS."""
    return Matrix(3, 3, np.diag([1.0 / 100.0, 1.0 / 255.0, 1.0 / 255.0]),
                  [0.0, 128.0 / 255.0, 128.0 / 255.0], implements="d2l ")


def normalize_to_lab_float():
    """_cmsStageNormalizeToLabFloat: the PCS's Lab to a D2Bx tag's."""
    return Matrix(3, 3, np.diag([100.0, 255.0, 255.0]),
                  [0.0, -128.0, -128.0], implements="l2d ")


def normalize_to_xyz_float():
    n = 65535.0 / 32768.0
    return Matrix(3, 3, np.diag([n, n, n]), implements="x2d ")


def eval_float(stages, x):
    """cmsPipelineEvalFloat on float32 rows (N, n_in)."""
    x = np.asarray(x, _F32)
    for st in stages:
        x = st(x)
    return x


def eval16(stages, w):
    """_LUTeval16: 16-bit words in, through the float stages, 16-bit out."""
    return to_16(eval_float(stages, from_16(w)))


# -- PreOptimize (cmsopt.c) --------------------------------------------------

_PAIRS = (("l2x ", "x2l "), ("x2l ", "l2x "), ("4 2 ", "2 4 "),
          ("2 4 ", "4 2 "), ("d2l ", "l2d "), ("d2x ", "x2d "))


def _identity3(m, tol):
    return all(abs(m[i][j] - (i == j)) < tol for i in range(3)
               for j in range(3))


def _multiply_matrix(st):
    """_MultiplyMatrix: two plain 3x3 matrices in a row joined (the later
    times the earlier), dropped where the product is an identity; a pair
    with an offset stops the search."""
    opt = False
    i = 0
    while i + 1 < len(st):
        a, b = st[i], st[i + 1]
        if a.implements == "matf" and b.implements == "matf":
            if a.off is not None or b.off is not None or \
                    (a.n_in, a.n_out, b.n_in, b.n_out) != (3, 3, 3, 3):
                return opt
            res = [[b.m[r, 0] * a.m[0, c] + b.m[r, 1] * a.m[1, c]
                    + b.m[r, 2] * a.m[2, c] for c in range(3)]
                   for r in range(3)]  # _cmsMAT3per(b, a)
            st[i : i + 2] = [] if _identity3(res, float(_F32(1e-5))) \
                else [Matrix(3, 3, res)]
            opt = True
        else:
            i += 1
    return opt


def pre_optimize(stages):
    """PreOptimize: identities out, inverse pairs out, matrices joined,
    until nothing changes."""
    st = list(stages)
    while True:
        opt = False
        n = len(st)
        st = [s for s in st if s.implements != "idn "]
        opt |= len(st) != n
        for a, b in _PAIRS:
            i = 0
            while i + 1 < len(st):
                if st[i].implements == a and st[i + 1].implements == b:
                    del st[i : i + 2]
                    opt = True
                else:
                    i += 1
        opt |= _multiply_matrix(st)
        if not opt:
            return st


# -- LUT tags (cmstypes.c) ---------------------------------------------------

class _Reader:
    """LittleCMS's memory IO on the profile's bytes: a read past the
    end fails (`ValueError`)."""

    def __init__(self, data, pos):
        self.data, self.pos = data, pos

    def take(self, n):
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError("read past the profile")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def u8(self):
        return self.take(1)[0]

    def u16(self):
        return struct.unpack(">H", self.take(2))[0]

    def u32(self):
        return struct.unpack(">I", self.take(4))[0]

    def u16s(self, n):
        return np.frombuffer(self.take(2 * n), ">u2").astype(np.int64)

    def s15f16(self):
        return struct.unpack(">i", self.take(4))[0] / 65536.0

    def f32(self):
        """_cmsReadFloat32Number: zero or a normal number within 1e20."""
        v = struct.unpack(">f", self.take(4))[0]
        if not (v == 0.0 or (math.isfinite(v) and abs(v) <= 1e20
                             and abs(v) >= np.finfo(_F32).tiny)):
            raise ValueError("float out of range")
        return v

    def seek(self, pos):
        if pos > len(self.data):
            raise ValueError("seek past the profile")
        self.pos = pos

    def align(self):
        self.take((-self.pos) % 4)


def _is_identity(m):
    """_cmsMAT3isIdentity: every entry within 1/65535."""
    return _identity3(np.asarray(m).reshape(3, 3), 1.0 / 65535.0)


def _uipow(n, a, b):
    if a == 0 or n == 0:
        return 0
    rv = 1
    for _ in range(b):
        rv *= a
        if rv > 0xFFFFFFFF // a:
            raise ValueError("table too large")
    return rv * n


def _curve_tag(io):
    """Type_Curve_Read / Type_ParametricCurve_Read after the type base."""
    typ = io.take(4)
    io.take(4)
    if typ == b"curv":
        cnt = io.u32()
        if cnt == 0:
            return param_curve(1, (1.0,))
        if cnt == 1:
            return param_curve(1, (io.u16() / 256.0,))
        if cnt > 0x7FFF:
            raise ValueError("curve too long")
        return ("table", io.u16s(cnt))
    if typ == b"para":
        kind = io.u16()
        io.u16()
        if kind > 4:
            raise ValueError("parametric curve type")
        n = (1, 3, 4, 5, 7)[kind]
        return param_curve(kind + 1, [io.s15f16() for _ in range(n)])
    raise ValueError(f"curve type {typ!r}")


def _table_curves(io, n_ch, n_entries, eight_bit=False):
    if eight_bit:  # FROM_8_TO_16 of 256 bytes a channel
        return Curves([("table", np.frombuffer(io.take(256), np.uint8)
                        .astype(np.int64) * 257) for _ in range(n_ch)])
    if n_entries == 0:  # an lcms extension: no table
        return None
    if n_entries < 2:
        raise ValueError("table of one entry")
    return Curves([("table", io.u16s(n_entries)) for _ in range(n_ch)])


def _read_lut16(io, eight_bit):
    n_in, n_out, grid = io.u8(), io.u8(), io.u8()
    if eight_bit and grid == 1:
        raise ValueError("grid of one point")
    io.u8()
    if not (0 < n_in <= 16 and 0 < n_out <= 16):
        raise ValueError("channels")
    m = [io.s15f16() for _ in range(9)]
    st = []
    if n_in == 3 and not _is_identity(m):
        st.append(Matrix(3, 3, m))
    if eight_bit:
        n_e_in = n_e_out = 256
    else:
        n_e_in, n_e_out = io.u16(), io.u16()
        if n_e_in > 0x7FFF or n_e_out > 0x7FFF or grid == 1:
            raise ValueError("table sizes")
    c = _table_curves(io, n_in, n_e_in, eight_bit)
    if c is not None:
        st.append(c)
    size = _uipow(n_out, grid, n_in)
    if size > 0:
        if eight_bit:
            t = np.frombuffer(io.take(size), np.uint8).astype(np.int64) * 257
        else:
            t = io.u16s(size)
        st.append(_clut16(t, (grid,) * n_in, n_out))
    c = _table_curves(io, n_out, n_e_out, eight_bit)
    if c is not None:
        st.append(c)
    return st, n_in, n_out


def _clut16(t, dims, n_out):
    return Clut(np.asarray(t).reshape(*dims, n_out))


def _read_mab(io, base):
    n_in, n_out = io.u8(), io.u8()
    io.u16()
    off_b, off_mat, off_m, off_c, off_a = (io.u32() for _ in range(5))
    if not (0 < n_in < 16 and 0 < n_out < 16):
        raise ValueError("channels")

    def curves(off, n):
        io.seek(base + off)
        out = []
        for _ in range(n):
            out.append(_curve_tag(io))
            io.align()
        return Curves(out)

    st = []
    if off_a:
        st.append(curves(off_a, n_in))
    if off_c:
        io.seek(base + off_c)
        dims = list(io.take(16))
        if 1 in dims:
            raise ValueError("grid of one point")
        prec = io.u8()
        io.take(3)
        size = n_out
        for d in dims[:n_in]:
            size *= d
        if prec == 1:
            t = np.frombuffer(io.take(size), np.uint8).astype(np.int64) * 257
        elif prec == 2:
            t = io.u16s(size)
        else:
            raise ValueError("CLUT precision")
        st.append(_clut16(t, dims[:n_in], n_out))
    if off_m:
        st.append(curves(off_m, n_out))
    if off_mat:
        io.seek(base + off_mat)
        m = [io.s15f16() for _ in range(9)]
        st.append(Matrix(3, 3, m, [io.s15f16() for _ in range(3)]))
    if off_b:
        st.append(curves(off_b, n_out))
    return st, n_in, n_out


def check_chain(stages, n_in, n_out):
    """BlessLUT's consistency: each stage takes what the last gave."""
    chans = n_in if not stages else stages[0].n_in
    for s in stages:
        if s.n_in != chans:
            raise ValueError("stage channels do not chain")
        chans = s.n_out
    if stages:
        n_in, n_out = stages[0].n_in, stages[-1].n_out
    return n_in, n_out


def read_lut_tag(data, off):
    """cmsReadTag of an A2Bx/B2Ax tag at `off`: (stages, n_in, n_out,
    the tag's type), ValueError where LittleCMS's read fails."""
    typ = data[off : off + 4]
    io = _Reader(data, off + 8)
    if typ in (b"mft1", b"mft2"):
        st, n_in, n_out = _read_lut16(io, typ == b"mft1")
    elif typ == b"mAB ":
        st, n_in, n_out = _read_mab(io, off)
    elif typ == b"mpet":
        from art_tpu_torch.color.lcms_mpe import read_mpet

        st, n_in, n_out = read_mpet(io, off)
    else:
        raise ValueError(f"LUT type {typ!r}")
    n_in, n_out = check_chain(st, n_in, n_out)
    return st, n_in, n_out, typ
