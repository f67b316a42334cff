"""LittleCMS 2.17's conversion of an 8-bit RGB image from its embedded ICC
profile to LittleCMS's built-in sRGB, perceptual intent, as the reference's
``art_tpu/io/imagefile.py::load_std_image`` gets it from Pillow 12.1.0:
``ImageCms.profileToProfile(img.convert("RGB"), ImageCmsProfile(icc),
ImageCms.createProfile("sRGB"))`` (RGB in and out, 8 bits a sample).

A numpy model of the C code, with no LittleCMS to call:

- the built-in sRGB (``cmsCreate_sRGBProfile``): D65 and the Rec. 709
  primaries Bradford-adapted to D50 in double precision
  (``_cmsBuildRGB2XYZtransferMatrix``), and the parametric type-4 curve,
  reversed analytically for output;
- the source profile's header, tag directory and tags read as
  ``cmsOpenProfileFromMem`` and ``cmsReadTag`` read them (XYZ, ``curv``,
  ``para``);
- a matrix/TRC source (``cmsopt.c``): the two matrices joined
  (``_MultiplyMatrix``), then ``OptimizeMatrixShaper``'s 8-bit evaluator:
  a 256-entry input shaper in 1.14 fixed point, the matrix in 1.14,
  ``(sum + 0x2000) >> 14`` clipped to 0..16384, a 16385-entry output
  shaper to 8 bits, in integers, bit for bit. A sampled ``curv``
  evaluates through LittleCMS's
  16-bit linear interpolation, a parametric curve through the C library's
  ``pow`` (Python's ``math.pow`` calls it);
- a LUT-class source (an A2B0 of type ``mft1``, ``mft2`` or ``mAB``):
  the joined pipeline in float (the tag through the port's stages,
  ``color/icclut.py``; black point compensation as LittleCMS forces it
  for the v4 sRGB in perceptual; the sRGB output in float), then
  ``cmsopt.c``'s resampling for 8-bit RGB: the prelinearisation curves
  of ``OptimizeByComputingLinearization`` (a 4096-entry grey ramp,
  slope-limited and reversed), a 33^3 16-bit CLUT sampled through them,
  the white node patched (``FixWhiteMisalignment``), and ``PrelinEval8``'s
  tetrahedral interpolation in LittleCMS's fixed point; where the curves
  are not monotonic, ``OptimizeByResampling``'s plain CLUT. Within one
  8-bit code of Pillow's LittleCMS (``tests/test_torch_stdimage.py``):
  the float pipeline's last bit differs now and then at a CLUT node.

`Refused` marks a profile LittleCMS refuses (it cannot open the profile,
or cannot link it: a grey or CMYK profile on an RGB image, a tag missing
or cut off): Pillow raises, and the reference leaves the image as it was.
A profile LittleCMS would link but this model does not cover (a device
link, a float D2B0 tag, black point compensation of a matrix source, a
LUT tag the port does not parse, an A2B0 curve whose table the port's
curve refit misses by more than `LUT_CURVE_TOL`) raises NotImplementedError
naming it.
"""

from __future__ import annotations

import functools
import math
import struct

import numpy as np

MAX_ENCODEABLE_XYZ = 1.0 + 32767.0 / 32768.0
INP_ADJ = 1.0 / MAX_ENCODEABLE_XYZ
OUTP_ADJ = MAX_ENCODEABLE_XYZ
D50 = (0.9642, 1.0, 0.8249)
MATRIX_DET_TOLERANCE = 0.0001
MAX_TABLE_TAG = 100
# cmsPERCEPTUAL_BLACK_X/Y/Z: the v4 perceptual reference medium black
PERCEPTUAL_BLACK = (0.00336, 0.0034731, 0.00287)
_BRADFORD = ((0.8951, 0.2664, -0.1614),
             (-0.7502, 1.7135, 0.0367),
             (0.0389, -0.0685, 1.0296))
# cmsCreate_sRGBProfile's definition (cmsvirt.c)
SRGB_WHITE_XYY = (0.3127, 0.3290, 1.0)
SRGB_PRIMARIES_XYY = ((0.6400, 0.3300, 1.0), (0.3000, 0.6000, 1.0),
                      (0.1500, 0.0600, 1.0))
SRGB_PARAMS = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)


class Refused(Exception):
    """LittleCMS refuses this profile or transform (Pillow raises)."""


# -- LittleCMS's matrix helpers (cmsmtrx.c), in the C code's order ----------

def mat3_per(a, b):
    """_cmsMAT3per: a @ b."""
    return tuple(tuple(a[i][0] * b[0][j] + a[i][1] * b[1][j]
                       + a[i][2] * b[2][j] for j in range(3))
                 for i in range(3))


def mat3_eval(a, v):
    """_cmsMAT3eval: a @ v."""
    return tuple(a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2]
                 for i in range(3))


def mat3_inverse(a):
    """_cmsMAT3inverse, or None for a singular matrix."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    if abs(det) < MATRIX_DET_TOLERANCE:
        return None
    return ((c0 / det,
             (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det),
            (c1 / det,
             (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det),
            (c2 / det,
             (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det))


def _xyy_to_xyz(x, y, big_y):
    return ((x / y) * big_y, big_y, ((1 - x - y) / y) * big_y)


def _adaptation(src, dst):
    """_cmsAdaptationMatrix with the Bradford cone matrix."""
    inv = mat3_inverse(_BRADFORD)
    cs = mat3_eval(_BRADFORD, src)
    cd = mat3_eval(_BRADFORD, dst)
    cone = ((cd[0] / cs[0], 0.0, 0.0), (0.0, cd[1] / cs[1], 0.0),
            (0.0, 0.0, cd[2] / cs[2]))
    return mat3_per(inv, mat3_per(cone, _BRADFORD))


@functools.lru_cache(maxsize=None)
def srgb_colorants():
    """The built-in sRGB's colorant matrix (rows X, Y, Z; columns R, G, B)
    in double precision, as ``cmsCreate_sRGBProfile`` keeps it in memory
    (``_cmsBuildRGB2XYZtransferMatrix`` and ``_cmsAdaptMatrixToD50``)."""
    xn, yn = SRGB_WHITE_XYY[0], SRGB_WHITE_XYY[1]
    (xr, yr, _), (xg, yg, _), (xb, yb, _) = SRGB_PRIMARIES_XYY
    prim = ((xr, xg, xb), (yr, yg, yb),
            ((1 - xr - yr), (1 - xg - yg), (1 - xb - yb)))
    coef = mat3_eval(mat3_inverse(prim), (xn / yn, 1.0, (1.0 - xn - yn) / yn))
    r = ((coef[0] * xr, coef[1] * xg, coef[2] * xb),
         (coef[0] * yr, coef[1] * yg, coef[2] * yb),
         (coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg),
          coef[2] * (1.0 - xb - yb)))
    white = _xyy_to_xyz(*SRGB_WHITE_XYY)
    return mat3_per(_adaptation(white, D50), r)


# -- numbers and curves (lcms2_internal.h, cmsgamma.c, cmsintrp.c) ----------

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


def _pow(a, b):
    """C's pow (glibc), with its inf and nan where Python raises."""
    try:
        return math.pow(a, b)
    except ZeroDivisionError:
        return math.inf
    except (ValueError, OverflowError):
        return math.nan if a < 0 else math.inf


def eval_parametric(kind, p, r):
    """DefaultEvalParametricFn for the types a profile's TRC can take
    (1-5) and the reversed sRGB curve (-4), at one double."""
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
    raise NotImplementedError(f"parametric curve type {kind}")


def eval_float(curve, v):
    """cmsEvalToneCurveFloat at float32 inputs -> float32: a sampled
    curve through 16 bits (its table, LinLerp1D), a parametric one in
    double (EvalSegmentedFn)."""
    v = np.asarray(v, np.float32)
    if curve[0] == "table":
        w = quick_saturate_word(v.astype(np.float64) * 65535.0)
        return (lin_lerp16(w, curve[1]) / 65535.0).astype(np.float32)
    kind, p = curve[1], curve[2]
    flat = [eval_parametric(kind, p, float(x)) for x in v.ravel()]
    return np.asarray(flat, np.float64).astype(np.float32).reshape(v.shape)


SRGB_INVERSE = ("param", -4, SRGB_PARAMS)


# -- the profile (cmsio0.c _cmsReadHeader, cmsReadTag; cmstypes.c) ----------

_DEVICE_CLASSES = {b"\0\0\0\0", b"scnr", b"mntr", b"prtr", b"link", b"abst",
                   b"spac", b"nmcl"}
_TAG_TYPES = {b"rXYZ": (b"XYZ ",), b"gXYZ": (b"XYZ ",), b"bXYZ": (b"XYZ ",),
              b"rTRC": (b"curv", b"para"), b"gTRC": (b"curv", b"para"),
              b"bTRC": (b"curv", b"para"),
              b"A2B0": (b"mft1", b"mft2", b"mAB ")}
_PARA_COUNTS = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}


class Profile:
    """A profile's header and tag directory as ``cmsOpenProfileFromMem``
    keeps them: `Refused` where LittleCMS cannot open it."""

    def __init__(self, data):
        data = bytes(data)
        if len(data) < 128:
            raise Refused("ICC profile shorter than its header")
        if data[36:40] != b"acsp":
            raise Refused("not an ICC profile, invalid signature")
        ver = bytearray(data[8:12])  # _validatedVersion
        ver[0] = min(ver[0], 9)
        ver[1] = min(ver[1] & 0xF0, 0x90) | min(ver[1] & 0x0F, 9)
        ver[2] = ver[3] = 0
        self.version = struct.unpack(">I", bytes(ver))[0]
        if self.version > 0x5000000:
            raise Refused(f"unsupported profile version {self.version:#x}")
        self.device_class = data[12:16]
        if self.device_class not in _DEVICE_CLASSES:
            raise Refused(f"unsupported device class {self.device_class!r}")
        self.color_space = data[16:20]
        self.pcs = data[20:24]
        size = min(struct.unpack(">I", data[0:4])[0], len(data))
        if len(data) < 132:
            raise Refused("no tag count")
        count = struct.unpack(">I", data[128:132])[0]
        if count > MAX_TABLE_TAG:
            raise Refused(f"too many tags ({count})")
        self.data = data
        self.tags = {}
        for i in range(count):
            p = 132 + 12 * i
            if p + 12 > len(data):
                raise Refused("tag directory cut off")
            sig, off, n = struct.unpack(">4sII", data[p : p + 12])
            if n == 0 or off == 0 or off + n > size:
                continue
            if sig in self.tags:
                raise Refused("duplicated tag")
            self.tags[sig] = (off, n)

    def tag_type(self, sig):
        off, _ = self.tags[sig]
        return self.data[off : off + 4]

    def read(self, sig):
        """cmsReadTag for the tags this model reads: the parsed tag, or
        None where LittleCMS's read fails."""
        if sig not in self.tags:
            return None
        off, n = self.tags[sig]
        if n < 8:
            return None
        typ = self.data[off : off + 4]
        if typ not in _TAG_TYPES.get(sig, ()):
            return None
        body = self.data[off + 8 : off + n]
        try:
            if typ == b"XYZ ":
                return tuple(v / 65536.0 for v in
                             struct.unpack(">3i", body[:12]))
            if typ == b"curv":
                cnt = struct.unpack(">I", body[:4])[0]
                if cnt == 0:
                    return ("param", 1, (1.0,))
                if cnt == 1:
                    return ("param", 1,
                            (struct.unpack(">H", body[4:6])[0] / 256.0,))
                if cnt > 0x7FFF or len(body) < 4 + 2 * cnt:
                    return None
                return ("table", np.frombuffer(body, ">u2", cnt, 4)
                        .astype(np.int64))
            if typ == b"para":
                kind = struct.unpack(">H", body[:2])[0]
                if kind not in _PARA_COUNTS:
                    return None
                k = _PARA_COUNTS[kind]
                vals = struct.unpack(f">{k}i", body[4 : 4 + 4 * k])
                return ("param", kind + 1, tuple(v / 65536.0 for v in vals))
        except struct.error:
            return None
        return self.data[off : off + n]


# -- the transform -------------------------------------------------------

def _srgb_output_matrix():
    """BuildRGBOutputMatrixShaper's matrix: the inverse colorants,
    times OutpAdj."""
    inv = mat3_inverse(srgb_colorants())
    return tuple(tuple(v * OUTP_ADJ for v in row) for row in inv)


@functools.lru_cache(maxsize=None)
def _srgb_second_shaper():
    """FillSecondShaper of the reversed sRGB curve for 8-bit output: the
    byte each of 16385 1.14 values gives (the table holds it times 257,
    the optimised packer keeps the low byte)."""
    r = (np.arange(16385, dtype=np.float64) / 16384.0).astype(np.float32)
    val = eval_float(SRGB_INVERSE, r).astype(np.float64)
    val = np.clip(val, 0.0, 1.0)
    return from_16_to_8(quick_saturate_word(val * 65535.0)).astype(np.uint8)


def _first_shaper(curve):
    """FillFirstShaper: 256 entries of 1.14 fixed point."""
    r = (np.arange(256, dtype=np.float64) / 255.0).astype(np.float32)
    y = eval_float(curve, r).astype(np.float64)
    return np.where(y < 131072.0, np.floor(y * 16384.0 + 0.5),
                    0x7FFFFFFF).astype(np.int64)


def _fixed14(x):
    return int(math.floor(x * 16384.0 + 0.5))


class MatrixShaper:
    """The optimised 8-bit transform of a matrix/TRC source."""

    def __init__(self, colorants, curves):
        m_in = tuple(tuple(v * INP_ADJ for v in row) for row in colorants)
        res = mat3_per(_srgb_output_matrix(), m_in)  # _MultiplyMatrix
        # a product within 1/65535 of the identity would join the two
        # curves instead (OptimizeByJoiningCurves); no profile's 15.16
        # colorants come that close to the built-in sRGB's doubles (the
        # nearest lattice point is 1.9e-5 off), so that path is not modelled
        if all(abs((i == j) - res[i][j]) < 1.0 / 65535.0
               for i in range(3) for j in range(3)):
            raise NotImplementedError(
                "ICC profile whose colorants join sRGB's to the identity "
                "(LittleCMS's joined-curves path)")
        shaper1 = [_first_shaper(c) for c in curves]
        # MatShaperEval16's sums, Mat[i][k] * Shaper1k[v] (+ 0x2000 in
        # the first term), tabulated per input byte
        self.terms = [[_fixed14(res[i][k]) * shaper1[k] + (0x2000 if k == 0
                                                           else 0)
                       for k in range(3)] for i in range(3)]
        self.shaper2 = _srgb_second_shaper()

    def __call__(self, rgb8):
        out = np.empty(rgb8.shape, np.uint8)
        for i, (tr, tg, tb) in enumerate(self.terms):
            lv = (tr[rgb8[..., 0]] + tg[rgb8[..., 1]] + tb[rgb8[..., 2]]) >> 14
            out[..., i] = self.shaper2[np.clip(lv, 0, 16384)]
        return out


def _lab_black_to_xyz(xyz):
    """BlackPointAsDarkerColorant's last steps: XYZ -> Lab, L above 95
    read as 0, a = b = 0, L clipped to 50, back to XYZ (D50)."""
    def f(t):
        return (841.0 / 108.0) * t + 16.0 / 116.0 \
            if t <= (24.0 / 116.0) ** 3 else t ** (1.0 / 3.0)

    L = 116.0 * f(xyz[1] / D50[1]) - 16.0
    if L > 95:
        L = 0.0
    L = min(L, 50.0)
    fy = (L + 16.0) / 116.0

    def f1(t):
        return t * t * t if t > 24.0 / 116.0 else \
            108.0 / 841.0 * (t - 16.0 / 116.0)

    return (D50[0] * f1(fy), D50[1] * f1(fy), D50[2] * f1(fy))


PRELIN_POINTS = 4096  # PRELINEARIZATION_POINTS (cmsopt.c)
GRID_RGB = 33  # _cmsReasonableGridpointsByColorspace for 3 channels


def slope_limit(table):
    """cmsopt.c SlopeLimiting: the first and last 2% of a 16-bit curve
    replaced by straight lines to 0 and 0xFFFF (reversed for a
    descending curve)."""
    t = np.asarray(table, np.int64).copy()
    n = len(t)
    at_begin = int(math.floor(n * 0.02 + 0.5))
    at_end = n - at_begin - 1
    begin, end = (0xFFFF, 0) if t[0] > t[-1] else (0, 0xFFFF)
    val = float(t[at_begin])
    slope = (val - begin) / at_begin
    beta = val - slope * at_begin
    i = np.arange(at_begin)
    t[:at_begin] = quick_saturate_word(i * slope + beta)
    val = float(t[at_end])
    slope = (end - val) / at_begin
    beta = val - slope * at_end
    i = np.arange(at_end, n)
    t[at_end:] = quick_saturate_word(i * slope + beta)
    return t


def is_monotonic(t):
    """cmsIsToneCurveMonotonic: steps against the direction of at most 2,
    walked from the far end."""
    t = np.asarray(t, np.int64)
    if len(t) < 2:
        return True
    if t[0] > t[-1]:  # descending: walk forward from the first entry
        last = t[0]
        for v in t[1:]:
            if v - last > 2:
                return False
            last = v
        return True
    last = t[-1]
    for v in t[-2::-1]:
        if v - last > 2:
            return False
        last = v
    return True


def is_degenerated(t):
    """cmsopt.c IsDegenerated: more than a twentieth of the entries at 0
    or at 0xFFFF (one of each is a linear table)."""
    t = np.asarray(t, np.int64)
    zeros, poles = int((t == 0).sum()), int((t == 0xFFFF).sum())
    if zeros == 1 and poles == 1:
        return False
    return zeros > len(t) // 20 or poles > len(t) // 20


def reverse_curve(t, n_out):
    """cmsReverseToneCurveEx of a 16-bit table: for each of n_out output
    samples y, the interval GetInterval finds (the last that holds y for
    an ascending table, the first for a descending one) and the line
    through it; a collapsed interval gives its upper (ascending) or lower
    end and leaves the line as it was; where no interval holds y the last
    line stands (0 before any)."""
    t = np.asarray(t, np.int64)
    n1 = len(t) - 1
    ascending = not t[0] > t[-1]
    y = np.arange(n_out) * 65535.0 / (n_out - 1)
    lo = np.minimum(t[:-1], t[1:]).astype(np.float64)
    hi = np.maximum(t[:-1], t[1:]).astype(np.float64)
    j = np.full(n_out, -1, np.int64)
    for c0 in range(0, n_out, 256):  # (samples, intervals) in blocks
        yy = y[c0 : c0 + 256, None]
        inside = (lo[None] <= yy) & (yy <= hi[None])
        any_in = inside.any(axis=1)
        if t[0] < t[n1]:
            k = n1 - 1 - np.argmax(inside[:, ::-1], axis=1)
        else:
            k = np.argmax(inside, axis=1)
        j[c0 : c0 + 256] = np.where(any_in, k, -1)
    jj = np.maximum(j, 0)
    x1, x2 = t[jj].astype(np.float64), t[jj + 1].astype(np.float64)
    y1 = (jj * 65535.0) / n1
    y2 = ((jj + 1) * 65535.0) / n1
    collapsed = (j >= 0) & (x1 == x2)
    sets = (j >= 0) & ~collapsed
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.where(sets, (y2 - y1) / (x2 - x1), 0.0)
    b = np.where(sets, y2 - a * x2, 0.0)
    # the line in force at each sample: the last one set at or before it
    last = np.maximum.accumulate(np.where(sets, np.arange(n_out), -1))
    a_in = np.where(last >= 0, a[np.maximum(last, 0)], 0.0)
    b_in = np.where(last >= 0, b[np.maximum(last, 0)], 0.0)
    out = quick_saturate_word(a_in * y + b_in)
    ends = quick_saturate_word(y2 if ascending else y1)
    return np.where(collapsed, ends, out).astype(np.int64)


def to_fixed_domain(a):
    """_cmsToFixedDomain: a 0..0xFFFF (times a domain) value to 16.16."""
    a = np.asarray(a, np.int64)
    return a + (a + 0x7FFF) // 0xFFFF


# the most a refit A2B0 curve may miss its table by (of full scale): the
# pipeline's curves are the port's refits (core/curve1d.py), LittleCMS's
# the tables themselves
LUT_CURVE_TOL = 1e-3


def _check_curve_fits(lut):
    """NotImplementedError where a curve of the A2B0 is one the port's
    refit does not follow within `LUT_CURVE_TOL` (a table with detail
    finer than the refit's segments): the model would then be more than
    an 8-bit code from LittleCMS, which interpolates the table."""
    import torch

    from art_tpu_torch.color.icclut import _is_identity_curves
    from art_tpu_torch.core.curve1d import eval_curve, fit_curves

    x = np.linspace(0.0, 1.0, 65536)
    for key in ("in_curves", "m_curves", "out_curves"):
        stack = lut.get(key)
        if stack is None or _is_identity_curves(stack):
            continue
        fits = fit_curves([stack[i] for i in range(3)])
        for i in range(3):
            table = np.asarray(stack[i], np.float64)
            want = np.interp(x, np.linspace(0.0, 1.0, table.size), table)
            got = eval_curve(torch.from_numpy(x.astype(np.float32)),
                             torch.from_numpy(fits[i]), in_max=1.0,
                             out_max=1.0).double().numpy()
            err = float(np.abs(got - want).max())
            if err > LUT_CURVE_TOL:
                raise NotImplementedError(
                    f"ICC profile whose A2B0 {key.replace('_', ' ')} "
                    f"({table.size}-entry table, channel {i}) the port's "
                    f"refit misses by {err:.2g} of full scale, past "
                    f"{LUT_CURVE_TOL:g}: LittleCMS interpolates the table")


class LutSource:
    """A LUT-class source as LittleCMS optimises it for 8-bit RGB
    (``cmsopt.c``): the joined float pipeline (its A2B0 through the
    port's stages, ``color/icclut.py``; black point compensation to
    sRGB's zero black, which LittleCMS forces for the v4 sRGB in
    perceptual; the sRGB colorants inverted and the reversed sRGB curve)
    resampled by ``OptimizeByComputingLinearization``: three 4096-entry
    prelinearisation curves from a grey ramp, slope-limited, a 33^3
    16-bit CLUT sampled through their inverses, the white node patched
    by ``FixWhiteMisalignment``, evaluated by ``PrelinEval8`` in
    LittleCMS's fixed point; ``OptimizeByResampling`` (the CLUT alone,
    ``TetrahedralInterp16``) where the curves are not monotonic or
    degenerate."""

    def __init__(self, prof):
        from art_tpu_torch.color.iccfile import _parse_lut_tag
        from art_tpu_torch.color.icclut import plan_lut

        off, _ = prof.tags[b"A2B0"]
        try:
            lut = _parse_lut_tag(prof.data, off)
            pcs = "Lab" if prof.pcs == b"Lab " else "XYZ"
            self.stages, data = plan_lut(lut, pcs, "in")
        except (ValueError, KeyError, IndexError, struct.error) as e:
            raise NotImplementedError(
                f"ICC profile with an A2B0 the port does not parse ({e})")
        _check_curve_fits(lut)
        import torch

        self.data = {k: torch.from_numpy(np.asarray(v, np.float32))
                     for k, v in data.items()}
        self.inv = np.array(mat3_inverse(srgb_colorants()))
        # the v4 perceptual black of a LUT profile, else its own black
        if prof.version >= 0x4000000:
            bp = PERCEPTUAL_BLACK
        else:
            bp = _lab_black_to_xyz(self._xyz(np.zeros((1, 3), np.float32))[0])
        self.bpc = None
        if any(bp):
            t = [bp[k] - D50[k] for k in range(3)]
            self.bpc = (np.array([(0.0 - D50[k]) / t[k] for k in range(3)]),
                        np.array([-D50[k] * (0.0 - bp[k]) / t[k]
                                  for k in range(3)]))
        self._optimise()

    def _xyz(self, rgb):
        """The A2B0 at float32 RGB in [0, 1]: XYZ (N, 3) float64."""
        import torch

        from art_tpu_torch.color.icclut import apply_stages

        x = torch.from_numpy(np.asarray(rgb, np.float32).reshape(-1, 3))
        r, g, b = apply_stages(x[:, 0], x[:, 1], x[:, 2], self.stages,
                               self.data)
        return torch.stack([r, g, b], -1).double().numpy()

    def pipeline(self, rgb):
        """The joined float pipeline: float32 RGB (N, 3) in [0, 1] to the
        encoded sRGB floats, unclipped."""
        xyz = self._xyz(rgb)
        if self.bpc is not None:
            xyz = (xyz * self.bpc[0] + self.bpc[1]).astype(np.float32)
        lin = (np.asarray(xyz, np.float64) @ self.inv.T).astype(np.float32)
        enc = _srgb_encode_float(lin)
        return enc

    def _optimise(self):
        ramp = (np.arange(PRELIN_POINTS, dtype=np.float64)
                / (PRELIN_POINTS - 1)).astype(np.float32)
        grey = self.pipeline(np.repeat(ramp[:, None], 3, axis=1))
        trans = [slope_limit(quick_saturate_word(grey[:, t].astype(np.float64)
                                                 * 65535.0))
                 for t in range(3)]
        suitable = all(is_monotonic(t) and not is_degenerated(t)
                       for t in trans)
        g = GRID_RGB
        node = quick_saturate_word(np.arange(g) * 65535.0 / (g - 1))
        nodes = np.stack(np.meshgrid(node, node, node, indexing="ij"),
                         -1).reshape(-1, 3)  # r slowest, b fastest
        infl = (nodes / 65535.0).astype(np.float32)
        if suitable:
            rev = [reverse_curve(t, PRELIN_POINTS) for t in trans]
            w = quick_saturate_word(infl.astype(np.float64) * 65535.0)
            infl = np.stack([(lin_lerp16(w[:, t], rev[t]) / 65535.0)
                             .astype(np.float32) for t in range(3)], -1)
        out = self.pipeline(infl)
        self.clut = quick_saturate_word(out.astype(np.float64) * 65535.0
                                        ).reshape(g, g, g, 3)
        self.prelin = trans if suitable else None
        self._fix_white()

    def _eval16(self, rgb8):
        """PrelinEval8 (or, without curves, TetrahedralInterp16) of (N, 3)
        uint8: (N, 3) int64 16-bit outputs."""
        v = np.asarray(rgb8, np.int64).reshape(-1, 3)
        g1 = GRID_RGB - 1
        w16 = (v << 8) | v
        if self.prelin is not None:
            w16 = np.stack([lin_lerp16(w16[:, t], self.prelin[t])
                            for t in range(3)], -1)
        f = to_fixed_domain(w16 * g1)
        i0 = f >> 16
        r = f & 0xFFFF
        if self.prelin is None:  # TetrahedralInterp16 steps past no edge
            i1 = np.where(w16 == 0xFFFF, i0, i0 + 1)
        else:
            i1 = np.where(r == 0, i0, i0 + 1)
        lut = self.clut
        rx, ry, rz = r[:, 0:1], r[:, 1:2], r[:, 2:3]
        x0, y0, z0 = i0[:, 0], i0[:, 1], i0[:, 2]
        x1, y1, z1 = i1[:, 0], i1[:, 1], i1[:, 2]

        def d(x, y, z):
            return lut[x, y, z]

        c0 = d(x0, y0, z0)
        conds = [(rx >= ry) & (ry >= rz), (rx >= rz) & (rz >= ry),
                 (rz >= rx) & (rx >= ry), (ry >= rx) & (rx >= rz),
                 (ry >= rz) & (rz >= rx), (rz >= ry) & (ry >= rx)]
        c1s = [d(x1, y0, z0) - c0, d(x1, y0, z0) - c0,
               d(x1, y0, z1) - d(x0, y0, z1), d(x1, y1, z0) - d(x0, y1, z0),
               d(x1, y1, z1) - d(x0, y1, z1), d(x1, y1, z1) - d(x0, y1, z1)]
        c2s = [d(x1, y1, z0) - d(x1, y0, z0), d(x1, y1, z1) - d(x1, y0, z1),
               d(x1, y1, z1) - d(x1, y0, z1), d(x0, y1, z0) - c0,
               d(x0, y1, z0) - c0, d(x0, y1, z1) - d(x0, y0, z1)]
        c3s = [d(x1, y1, z1) - d(x1, y1, z0), d(x1, y0, z1) - d(x1, y0, z0),
               d(x0, y0, z1) - c0, d(x1, y1, z1) - d(x1, y1, z0),
               d(x0, y1, z1) - d(x0, y1, z0), d(x0, y0, z1) - c0]
        c1 = np.select(conds, c1s, 0)
        c2 = np.select(conds, c2s, 0)
        c3 = np.select(conds, c3s, 0)
        rest = c1 * rx + c2 * ry + c3 * rz + 0x8001
        return (c0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF

    def _fix_white(self):
        """FixWhiteMisalignment: where white does not come out white, the
        CLUT node white lands on (if it lands on one) set to 0xFFFF."""
        got = self._eval16(np.full((1, 3), 255, np.uint8))[0]
        d = np.abs(got - 0xFFFF)
        if (d > 0xF000).any() or (got == 0xFFFF).all():
            return
        # on the first channel whose whites differ: WhitesAreEqual
        for k in range(3):
            if d[k] > 0xF000:
                return
            if got[k] != 0xFFFF:
                break
        white_in = [0xFFFF] * 3 if self.prelin is None else [
            int(lin_lerp16(np.array([0xFFFF]), t)[0]) for t in self.prelin]
        pos = [w * (GRID_RGB - 1) / 65535.0 for w in white_in]
        if any(p != math.floor(p) for p in pos):
            return
        x, y, z = (int(p) for p in pos)
        self.clut[x, y, z] = 0xFFFF

    def __call__(self, rgb8):
        out = self._eval16(np.asarray(rgb8).reshape(-1, 3))
        return from_16_to_8(out).astype(np.uint8).reshape(np.shape(rgb8))


def _srgb_encode_float(lin):
    """The reversed sRGB curve (parametric type -4, in double) at float32
    linear values, to float32."""
    p = SRGB_PARAMS
    r = np.asarray(lin, np.float64)
    disc = math.pow(p[1] * p[4] + p[2], p[0])
    with np.errstate(invalid="ignore", divide="ignore"):
        hi = (np.power(np.where(r >= disc, r, 1.0), 1.0 / p[0]) - p[2]) / p[1]
    return np.where(r >= disc, hi, r / p[3]).astype(np.float32)


def _lab_f1(t):
    """cmsLab2XYZ's inverse of the Lab companding."""
    return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0),
                    t * t * t)


@functools.lru_cache(maxsize=1)
def lab_to_srgb_clut():
    """The 33^3 16-bit CLUT (L, a, b nodes; (33, 33, 33, 3) uint16) of
    Pillow's ``convert("RGB")`` of a "LAB" image: a LittleCMS transform
    from ``cmsCreateLab2Profile(NULL)`` (D50, an abstract v2 profile
    whose identity A2B0 and v2/v4 encoding stages PreOptimize removes)
    to the built-in sRGB, TYPE_Lab_8 in, 8 bits out, perceptual, no BPC
    (both black points zero). ``OptimizeByResampling`` samples the float
    pipeline at the nodes: the node's 16-bit value over 65535 in float32,
    ``EvaluateLab2XYZ`` in double (L times 100, a and b times 255 less
    128, ``cmsLab2XYZ`` against D50, over MAX_ENCODEABLE_XYZ) to
    float32, the sRGB output matrix (the colorants inverted, times
    MAX_ENCODEABLE_XYZ) summed in double to float32, the reversed sRGB
    curve, then ``_cmsQuickSaturateWord`` of the value times 65535. The
    white node is not patched: Lab's white (0xFFFF, 0x8080, 0x8080) is
    on no node. The 8-bit evaluation is ``TetrahedralInterp16`` on the
    bytes times 257 (``io/native/rasterdec.cc::lab_to_rgb``)."""
    g = GRID_RGB
    node = quick_saturate_word(np.arange(g) * 65535.0 / (g - 1))
    nodes = np.stack(np.meshgrid(node, node, node, indexing="ij"),
                     -1).reshape(-1, 3)
    v = (nodes / 65535.0).astype(np.float32).astype(np.float64)
    y = (v[:, 0] * 100.0 + 16.0) / 116.0
    x = y + 0.002 * (v[:, 1] * 255.0 - 128.0)
    z = y - 0.005 * (v[:, 2] * 255.0 - 128.0)
    xyz = np.stack([(_lab_f1(t) * D50[k] / MAX_ENCODEABLE_XYZ).astype(
        np.float32) for k, t in enumerate((x, y, z))], -1).astype(np.float64)
    inv = np.array(mat3_inverse(srgb_colorants())) * MAX_ENCODEABLE_XYZ
    lin = np.zeros_like(xyz)
    for i in range(3):
        for j in range(3):
            lin[:, i] = lin[:, i] + xyz[:, j] * inv[i, j]
    enc = _srgb_encode_float(lin.astype(np.float32))
    return quick_saturate_word(enc.astype(np.float64) * 65535.0).astype(
        np.uint16).reshape(g, g, g, 3)


def build_transform(icc):
    """The transform from profile bytes `icc` to the built-in sRGB, as a
    callable on (..., 3) uint8 RGB; `Refused` where Pillow's
    ``profileToProfile`` raises, NotImplementedError where LittleCMS
    would convert and this model does not."""
    prof = Profile(icc)
    if prof.device_class in (b"link", b"abst", b"nmcl"):
        # LittleCMS reads a link's or an abstract's A2B0, a named colour
        # profile's ncl2; without it the link fails
        if (b"ncl2" if prof.device_class == b"nmcl" else b"A2B0") \
                not in prof.tags:
            raise Refused("no device link table")
        raise NotImplementedError(
            f"ICC profile of class {prof.device_class.decode('latin-1')!r} "
            "as an image's embedded profile")
    if prof.color_space != b"RGB ":
        raise Refused("wrong input color space on transform")
    if prof.pcs == b"RGB ":
        raise NotImplementedError("ICC profile with an RGB connection space")
    if prof.pcs not in (b"XYZ ", b"Lab "):
        raise Refused("colorspace mismatch")
    if b"D2B0" in prof.tags:
        raise NotImplementedError("ICC profile with a float D2B0 tag")
    if b"A2B0" in prof.tags:
        if prof.read(b"A2B0") is None:
            raise Refused("cannot read the A2B0 tag")
        return LutSource(prof)
    cols = [prof.read(s) for s in (b"rXYZ", b"gXYZ", b"bXYZ")]
    curves = [prof.read(s) for s in (b"rTRC", b"gTRC", b"bTRC")]
    if any(c is None for c in cols + curves):
        raise Refused("cannot build the matrix-shaper input")
    colorants = tuple(tuple(cols[j][i] for j in range(3)) for i in range(3))
    # black point compensation (forced for the v4 sRGB) moves nothing
    # when the source's black is zero, as sRGB's is
    zero = np.zeros(1, np.float32)
    if any(float(eval_float(c, zero)[0]) != 0.0 for c in curves):
        raise NotImplementedError(
            "black point compensation of an ICC profile whose TRC does not "
            "start at 0")
    return MatrixShaper(colorants, curves)


@functools.lru_cache(maxsize=8)
def _cached_transform(icc):
    return build_transform(icc)


def to_srgb(rgb8, icc):
    """(H, W, 3) uint8 converted from profile `icc` to the built-in sRGB."""
    return _cached_transform(bytes(icc))(np.asarray(rgb8, np.uint8))
