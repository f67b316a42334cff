"""LittleCMS 2.17's conversion of an 8-bit RGB image from its embedded ICC
profile to LittleCMS's built-in sRGB, perceptual intent, as the reference's
``art_tpu/io/imagefile.py::load_std_image`` gets it from Pillow 12.1.0:
``ImageCms.profileToProfile(img.convert("RGB"), ImageCmsProfile(icc),
ImageCms.createProfile("sRGB"))`` (RGB in and out, 8 bits a sample).

A numpy model of the C code, with no LittleCMS to call, bit-equal to
Pillow's on every profile class it links:

- the built-in sRGB (``cmsCreate_sRGBProfile``): D65 and the Rec. 709
  primaries Bradford-adapted to D50 in double precision
  (``_cmsBuildRGB2XYZtransferMatrix``), and the parametric type-4 curve,
  reversed analytically for output;
- the source profile's header, tag directory and tags read as
  ``cmsOpenProfileFromMem`` and ``cmsReadTag`` read them;
- the link (``cmscnvrt.c``): the source's input table
  (``_cmsReadInputLUT``: a float D2B0 in preference to the A2B0, else the
  matrix and TRCs; a device link's or an abstract profile's own table by
  ``_cmsReadDevicelinkLUT``), black point compensation as the v4 sRGB
  forces it in perceptual (``cmsDetectBlackPoint`` of the source, a
  matrix and offset where the blacks differ), the sRGB's output matrix
  and reversed curves; the stages in LittleCMS's own arithmetic
  (``color/lcms_stages.py``, ``color/lcms_mpe.py``), then PreOptimize;
- the 8-bit transform ``cmsopt.c`` makes of it: ``OptimizeMatrixShaper``
  (a 256-entry input shaper in 1.14 fixed point, the matrix in 1.14,
  ``(sum + 0x2000) >> 14`` clipped to 0..16384, a 16385-entry output
  shaper to 8 bits, in integers), else ``OptimizeByComputingLinearization``
  (three 4096-entry prelinearisation curves from a grey ramp,
  slope-limited and reversed, a 33^3 16-bit CLUT sampled through them,
  the white node patched, ``PrelinEval8``), else ``OptimizeByResampling``
  (the CLUT alone, ``TetrahedralInterp16``).

`Refused` marks a profile or link LittleCMS refuses: Pillow raises, and
the reference leaves the image as it was (a profile it cannot open, a
grey or CMYK profile on an RGB image, a tag missing, cut off or of a
type the tag may not have, a device link to anything but Lab or XYZ, a
named-colour profile, an abstract profile or one whose connection space
is RGB). NotImplementedError is left only where Pillow is not reached
here: a CLUT of other than three inputs inside an RGB profile's table,
and the joined-curves optimisation, which no profile's s15.16 colorants
reach (``tests/test_torch_lcms.py``).
"""

from __future__ import annotations

import functools
import math
import struct

import numpy as np

from art_tpu_torch.color import lcms_stages as ls
from art_tpu_torch.color.lcms_stages import (
    D50, MATRIX_DET_TOLERANCE, MAX_ENCODEABLE_XYZ, from_16_to_8, lin_lerp16,
    quick_saturate_word, to_fixed_domain)

INP_ADJ = 1.0 / MAX_ENCODEABLE_XYZ
OUTP_ADJ = MAX_ENCODEABLE_XYZ
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


def _as_curve(c):
    """A ``curv``/``para`` reading as a `lcms_stages` curve."""
    return ls.param_curve(c[1], c[2]) if c[0] == "param" else c


SRGB_INVERSE = ("param", -4, SRGB_PARAMS)


# -- the profile (cmsio0.c _cmsReadHeader, cmsReadTag; cmstypes.c) ----------

_DEVICE_CLASSES = {b"\0\0\0\0", b"scnr", b"mntr", b"prtr", b"link", b"abst",
                   b"spac", b"nmcl"}
_LUT_TYPES = (b"mft1", b"mft2", b"mAB ")
_TAG_TYPES = {b"rXYZ": (b"XYZ ",), b"gXYZ": (b"XYZ ",), b"bXYZ": (b"XYZ ",),
              b"rTRC": (b"curv", b"para"), b"gTRC": (b"curv", b"para"),
              b"bTRC": (b"curv", b"para"),
              b"A2B0": _LUT_TYPES, b"A2B1": _LUT_TYPES, b"A2B2": _LUT_TYPES,
              b"D2B0": (b"mpet",), b"D2B1": (b"mpet",), b"D2B2": (b"mpet",)}
_PARA_COUNTS = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}
_A2B = (b"A2B0", b"A2B1", b"A2B2", b"A2B1")  # Device2PCS16
_D2B = (b"D2B0", b"D2B1", b"D2B2", b"D2B3")  # Device2PCSFloat
_PCS_SPACES = (b"XYZ ", b"Lab ")


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

    def is_matrix_shaper(self):
        """cmsIsMatrixShaper of an RGB profile: all six tags present."""
        return self.color_space == b"RGB " and all(
            s in self.tags for s in (b"rXYZ", b"gXYZ", b"bXYZ", b"rTRC",
                                     b"gTRC", b"bTRC"))

    def read(self, sig):
        """cmsReadTag for the tags this model reads: the parsed tag (a
        LUT tag as (stages, its type)), or None where LittleCMS's read
        fails."""
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
            st, _, _, typ = ls.read_lut_tag(self.data, off)
            return st, typ
        except (struct.error, ValueError):
            return None


# -- reading a profile's table (cmsio1.c) ------------------------------------

def _read_lut(prof, sig):
    got = prof.read(sig)
    if got is None:
        raise Refused(f"cannot read the {sig.decode('latin-1')} tag")
    return got


def _float_tag(prof, sig):
    """_cmsReadFloatInputTag / _cmsReadFloatDevicelinkTag: the tag
    between its spaces' float normalisers."""
    st, _ = _read_lut(prof, sig)
    if prof.color_space == b"Lab ":
        st.insert(0, ls.normalize_to_lab_float())
    elif prof.color_space == b"XYZ ":
        st.insert(0, ls.normalize_to_xyz_float())
    if prof.pcs == b"Lab ":
        st.append(ls.normalize_from_lab_float())
    elif prof.pcs == b"XYZ ":
        st.append(ls.normalize_from_xyz_float())
    return st


def _matrix_shaper_input(prof):
    """BuildRGBInputMatrixShaper: the TRCs, the colorants times InpAdj,
    XYZ to Lab for a Lab PCS."""
    cols = [prof.read(s) for s in (b"rXYZ", b"gXYZ", b"bXYZ")]
    curves = [prof.read(s) for s in (b"rTRC", b"gTRC", b"bTRC")]
    if any(c is None for c in cols + curves):
        raise Refused("cannot build the matrix-shaper input")
    m = [[cols[j][i] * INP_ADJ for j in range(3)] for i in range(3)]
    st = [ls.Curves([_as_curve(c) for c in curves]), ls.Matrix(3, 3, m)]
    if prof.pcs == b"Lab ":
        st.append(ls.XYZ2Lab())
    return st


def input_lut(prof, intent=0):
    """_cmsReadInputLUT of a profile that is not a named-colour one."""
    if prof.color_space == b"GRAY":
        raise Refused("grey profile")
    if _D2B[intent] in prof.tags:
        return _float_tag(prof, _D2B[intent])
    tag = _A2B[intent] if _A2B[intent] in prof.tags else b"A2B0"
    if tag in prof.tags:
        st, typ = _read_lut(prof, tag)
        if typ != b"mft2" or prof.pcs != b"Lab ":
            return st
        if prof.color_space == b"Lab ":
            st.insert(0, ls.lab_v4_to_v2())
        return st + [ls.lab_v2_to_v4()]
    return _matrix_shaper_input(prof)


def devicelink_lut(prof, intent=0):
    """_cmsReadDevicelinkLUT of a device link or an abstract profile."""
    if _D2B[intent] in prof.tags:
        return _float_tag(prof, _D2B[intent])
    if b"D2B0" in prof.tags:
        return _read_lut(prof, b"D2B0")[0]
    tag = _A2B[intent] if _A2B[intent] in prof.tags else b"A2B0"
    if tag not in prof.tags:
        raise Refused("no device link table")
    st, typ = _read_lut(prof, tag)
    if prof.pcs == b"Lab ":  # ChangeInterpolationToTrilinear
        for s in st:
            if s.type == "clut":
                s.trilinear = True
    if typ != b"mft2":
        return st
    if prof.color_space == b"Lab ":
        st.insert(0, ls.lab_v4_to_v2())
    if prof.pcs == b"Lab ":
        st.append(ls.lab_v2_to_v4())
    return st


def _srgb_input():
    """The built-in sRGB read for input: its curves, its colorants."""
    m = [[v * INP_ADJ for v in row] for row in srgb_colorants()]
    return [ls.Curves([_as_curve(("param", 4, SRGB_PARAMS))] * 3),
            ls.Matrix(3, 3, m)]


def _srgb_output():
    """BuildRGBOutputMatrixShaper of the built-in sRGB."""
    inv = mat3_inverse(srgb_colorants())
    m = [[v * OUTP_ADJ for v in row] for row in inv]
    return [ls.Matrix(3, 3, m),
            ls.Curves([_as_curve(SRGB_INVERSE)] * 3)]


# -- black points (cmssamp.c) ------------------------------------------------

def _lab2xyz(L, a, b):
    """cmsLab2XYZ against D50 in double."""
    y = (L + 16.0) / 116.0
    x = y + 0.002 * a
    z = y - 0.005 * b

    def f1(t):
        return t * t * t if t > 24.0 / 116.0 else \
            (108.0 / 841.0) * (t - 16.0 / 116.0)

    return (f1(x) * D50[0], f1(y) * D50[1], f1(z) * D50[2])


def _black_of(stages, pcs):
    """BlackPointAsDarkerColorant's transform to a Lab identity (Lab
    double out, no optimisation) at the zero colorant: the PCS to Lab,
    then PreOptimize; L outside 0..50 read as 0, a = b = 0, to XYZ."""
    st = list(stages)
    if pcs == b"XYZ ":
        st.append(ls.XYZ2Lab())
    st = ls.pre_optimize(st)
    out = ls.eval_float(st, np.zeros((1, 3), np.float32))[0]
    L = float(out[0]) * 100.0
    if L > 50 or L < 0:
        L = 0.0
    return _lab2xyz(L, 0.0, 0.0)


def _black_darker(prof, intent):
    """BlackPointAsDarkerColorant of an RGB profile."""
    if not (_A2B[intent] in prof.tags or prof.is_matrix_shaper()):
        return (0.0, 0.0, 0.0)  # cmsIsIntentSupported
    try:
        st = input_lut(prof, intent)
    except Refused:
        return (0.0, 0.0, 0.0)
    if prof.pcs not in _PCS_SPACES:
        return (0.0, 0.0, 0.0)
    try:
        if ls.check_chain(st, 3, 3) != (3, 3):
            return (0.0, 0.0, 0.0)
    except ValueError:
        return (0.0, 0.0, 0.0)
    return _black_of(st, prof.pcs)


def detect_black_point(prof, intent=0):
    """cmsDetectBlackPoint of a source profile, perceptual or relative."""
    if prof.device_class in (b"link", b"abst", b"nmcl"):
        return (0.0, 0.0, 0.0)
    if prof.version >= 0x4000000 and intent in (0, 2):
        if prof.is_matrix_shaper():
            return _black_darker(prof, 1)
        return PERCEPTUAL_BLACK
    return _black_darker(prof, intent)


@functools.lru_cache(maxsize=None)
def srgb_black_point():
    """cmsDetectDestinationBlackPoint of the built-in sRGB, perceptual: a
    v4 matrix-shaper, so its relative black through its own input."""
    return _black_of(_srgb_input(), b"XYZ ")


def bpc_conversion(black_in, black_out):
    """ComputeConversion's black point compensation: (m, off), the
    offset over MAX_ENCODEABLE_XYZ; None for an empty layer
    (IsEmptyLayer: the entries' distance from the identity below
    0.002)."""
    m = np.eye(3)
    off = np.zeros(3)
    if tuple(black_in) != tuple(black_out):
        for k in range(3):
            t = black_in[k] - D50[k]
            m[k, k] = (black_out[k] - D50[k]) / t
            off[k] = -D50[k] * (black_out[k] - black_in[k]) / t
    off = off / MAX_ENCODEABLE_XYZ
    diff = 0.0
    for v in (m - np.eye(3)).ravel():
        diff += abs(v)
    for v in off:
        diff += abs(v)
    return None if diff < 0.002 else (m, off)


# -- the link (cmscnvrt.c, cmsxform.c) ---------------------------------------

def link(prof):
    """The pipeline ``cmsCreateTransform(prof, RGB_8, sRGB, RGB_8,
    PERCEPTUAL, 0)`` links, before optimisation: `Refused` where the
    transform cannot be created."""
    cls, cs, pcs = prof.device_class, prof.color_space, prof.pcs
    # GetXFormColorSpaces, IsProperColorSpace
    if cls == b"nmcl":
        raise Refused("wrong input color space on transform (named colour)")
    entry, post = (cs, pcs) if cs not in _PCS_SPACES or cls == b"link" \
        else (pcs, cs)
    if entry != b"RGB ":
        raise Refused("wrong input color space on transform")
    if post not in _PCS_SPACES:
        raise Refused("wrong output color space on transform")
    # DefaultICCintents: the source, then sRGB for output from a PCS
    # (black point compensation forced by its v4) or else for input
    if cls in (b"link", b"abst"):
        st, black = devicelink_lut(prof), (0.0, 0.0, 0.0)
    else:
        st, black = input_lut(prof), None
    if pcs in _PCS_SPACES:
        if black is None:
            black = detect_black_point(prof)
        if pcs == b"Lab ":
            st.append(ls.Lab2XYZ())
        bpc = bpc_conversion(black, srgb_black_point())
        if bpc is not None:
            st.append(ls.Matrix(3, 3, bpc[0], bpc[1]))
        st += _srgb_output()
    elif pcs == b"RGB ":
        st += _srgb_input()
    else:
        raise Refused("colorspace mismatch")
    try:
        chans = ls.check_chain(st, 3, 3)
    except ValueError:
        raise Refused("cannot link the profiles") from None
    if chans != (3, 3):
        raise Refused("channel count doesn't match")
    return st


# -- the 8-bit transform (cmsopt.c) ------------------------------------------

def _first_shaper(curve):
    """FillFirstShaper: 256 entries of 1.14 fixed point."""
    r = (np.arange(256, dtype=np.float64) / 255.0).astype(np.float32)
    y = ls.curve_float(curve, r).astype(np.float64)
    return np.where(y < 131072.0, np.floor(y * 16384.0 + 0.5),
                    0x7FFFFFFF).astype(np.int64)


def _second_shaper(curve):
    """FillSecondShaper for 8-bit output: the byte each of 16385 1.14
    values gives (the table holds it times 257, the optimised packer
    keeps the low byte)."""
    r = (np.arange(16385, dtype=np.float64) / 16384.0).astype(np.float32)
    val = np.clip(ls.curve_float(curve, r).astype(np.float64), 0.0, 1.0)
    return from_16_to_8(quick_saturate_word(val * 65535.0)).astype(np.uint8)


def _fixed14(x):
    return int(math.floor(x * 16384.0 + 0.5))


class MatrixShaper:
    """OptimizeMatrixShaper's 8-bit evaluator (MatShaperEval16): input
    shapers, the matrix and its offset in 1.14 (the offset added to the
    1.28 sums, as LittleCMS adds it), output shapers."""

    def __init__(self, curves1, mat, off, curves2):
        shaper1 = [_first_shaper(c) for c in curves1]
        # Mat[i][k] * Shaper1k[v] (+ Off[i] + 0x2000 in the first term),
        # tabulated per input byte
        self.terms = [[_fixed14(mat[i][k]) * shaper1[k]
                       + ((0x2000 + (0 if off is None else _fixed14(off[i])))
                          if k == 0 else 0)
                       for k in range(3)] for i in range(3)]
        self.shaper2 = [_second_shaper(c) for c in curves2]

    def __call__(self, rgb8):
        out = np.empty(rgb8.shape, np.uint8)
        for i, (tr, tg, tb) in enumerate(self.terms):
            lv = (tr[rgb8[..., 0]] + tg[rgb8[..., 1]] + tb[rgb8[..., 2]]) >> 14
            out[..., i] = self.shaper2[i][np.clip(lv, 0, 16384)]
        return out


def _matrix_shaper(st):
    """OptimizeMatrixShaper's patterns: curves, matrix, curves; or
    curves, matrix without offset, matrix, curves (joined). (curves1,
    matrix, offset, curves2, identity?) or None."""
    types = [s.type for s in st]
    if types == ["cvst", "matf", "matf", "cvst"]:
        m1, m2 = st[1], st[2]
        if any((m.n_in, m.n_out) != (3, 3) for m in (m1, m2)) or \
                m1.off is not None:
            return None
        res = mat3_per(tuple(map(tuple, m2.m)), tuple(map(tuple, m1.m)))
        off = m2.off
    elif types == ["cvst", "matf", "cvst"]:
        if (st[1].n_in, st[1].n_out) != (3, 3):
            return None
        res, off = tuple(map(tuple, st[1].m)), st[1].off
    else:
        return None
    ident = off is None and all(abs(res[i][j] - (i == j)) < 1.0 / 65535.0
                                for i in range(3) for j in range(3))
    return st[0].curves, res, off, st[-1].curves, ident


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


class ClutTransform:
    """A pipeline LittleCMS resamples for 8-bit RGB: by
    ``OptimizeByComputingLinearization`` (three 4096-entry
    prelinearisation curves from a grey ramp through the float pipeline,
    slope-limited; a 33^3 16-bit CLUT sampled through their inverses;
    ``PrelinEval8`` in LittleCMS's fixed point), or, where the last
    stage's curves are degenerate or the grey curves are not monotonic
    or are degenerate, by ``OptimizeByResampling`` (the CLUT alone,
    ``TetrahedralInterp16``); the white node patched by
    ``FixWhiteMisalignment`` either way. Each pixel is evaluated by
    ``io/native/rasterdec.cc::clut8`` (`_eval16` is its numpy model)."""

    def __init__(self, stages):
        self.stages = stages
        self._optimise()

    def pipeline(self, rgb):
        """The float pipeline: float32 RGB (N, 3) in [0, 1] to the
        encoded sRGB floats, unclipped."""
        return ls.eval_float(self.stages,
                             np.asarray(rgb, np.float32).reshape(-1, 3))

    def _optimise(self):
        last = self.stages[-1]
        suitable = not (last.type == "cvst" and any(
            is_degenerated(ls.curve_table16(c)) for c in last.curves))
        if suitable:
            ramp = (np.arange(PRELIN_POINTS, dtype=np.float64)
                    / (PRELIN_POINTS - 1)).astype(np.float32)
            grey = self.pipeline(np.repeat(ramp[:, None], 3, axis=1))
            trans = [slope_limit(quick_saturate_word(
                grey[:, t].astype(np.float64) * 65535.0)) for t in range(3)]
            suitable = all(is_monotonic(t) and not is_degenerated(t)
                           for t in trans)
        g = GRID_RGB
        node = quick_saturate_word(np.arange(g) * 65535.0 / (g - 1))
        nodes = np.stack(np.meshgrid(node, node, node, indexing="ij"),
                         -1).reshape(-1, 3)  # r slowest, b fastest
        infl = (nodes / 65535.0).astype(np.float32)  # XFormSampler16
        if suitable:
            rev = [("table", reverse_curve(t, PRELIN_POINTS)) for t in trans]
            infl = np.stack([ls.curve_float(rev[t], infl[:, t])
                             for t in range(3)], -1)
        out = self.pipeline(infl)
        self.clut = quick_saturate_word(out.astype(np.float64) * 65535.0
                                        ).reshape(g, g, g, 3)
        self.prelin = trans if suitable else None
        self.tables = byte_tables(self.prelin)
        self._fix_white()

    def _eval16(self, rgb8):
        """PrelinEval8 (or, without curves, TetrahedralInterp16) of (N, 3)
        uint8: (N, 3) int64 16-bit outputs."""
        v = np.asarray(rgb8).reshape(-1, 3).astype(np.intp)
        i0, i1, r = (np.stack([self.tables[k, j][v[:, k]] for k in range(3)],
                              -1) for j in range(3))
        return ls.tetra16(self.clut, i0, i1, r)

    def _fix_white(self):
        """FixWhiteMisalignment: where white does not come out white
        (WhitesAreEqual: channel by channel, a difference past 0xF000
        counts as equal), the CLUT node white lands on (if it lands on
        one) set to 0xFFFF."""
        got = self._eval16(np.full((1, 3), 255, np.uint8))[0]
        for k in range(3):
            if abs(int(got[k]) - 0xFFFF) > 0xF000:
                return
            if got[k] != 0xFFFF:
                break
        else:
            return
        white_in = [0xFFFF] * 3 if self.prelin is None else [
            int(lin_lerp16(np.array([0xFFFF]), t)[0]) for t in self.prelin]
        pos = [w * (GRID_RGB - 1) / 65535.0 for w in white_in]
        if any(p != math.floor(p) for p in pos):
            return
        x, y, z = (int(p) for p in pos)
        self.clut[x, y, z] = 0xFFFF

    def __call__(self, rgb8):
        from art_tpu_torch.io.rasterformats import clut8

        return clut8(rgb8, self.tables, self.clut)


def byte_tables(prelin=None):
    """Each input byte's base node, upper node and 16-bit rest on the
    GRID_RGB grid, per channel ((3, 3, 256) int32): PrelinEval8's
    (PrelinOpt8alloc: the byte times 257 through the channel's `prelin`
    curve; a rest of 0 steps to no upper node), or, without curves,
    TetrahedralInterp16's on the byte times 257."""
    w16 = np.arange(256, dtype=np.int64) * 257
    out = np.empty((3, 3, 256), np.int32)
    for k in range(3):
        w = w16 if prelin is None else lin_lerp16(w16, prelin[k])
        f = to_fixed_domain(w * (GRID_RGB - 1))
        i0, r = f >> 16, f & 0xFFFF
        up = w != 0xFFFF if prelin is None else r != 0
        out[k] = i0, np.where(up, i0 + 1, i0), r
    return out


@functools.lru_cache(maxsize=1)
def lab_to_srgb_clut():
    """The 33^3 16-bit CLUT (L, a, b nodes; (33, 33, 33, 3) uint16) of
    Pillow's ``convert("RGB")`` of a "LAB" image: a LittleCMS transform
    from ``cmsCreateLab2Profile(NULL)`` (D50, an abstract v2 profile
    whose identity A2B0 and v2/v4 encoding stages PreOptimize removes)
    to the built-in sRGB, TYPE_Lab_8 in, 8 bits out, perceptual, no BPC
    (both black points zero): ``OptimizeByResampling`` samples Lab to
    XYZ and sRGB's output at the nodes (``XFormSampler16``). The white
    node is not patched: Lab's white (0xFFFF, 0x8080, 0x8080) is on no
    node. The 8-bit evaluation is ``TetrahedralInterp16`` on the bytes
    times 257 (`byte_tables`, ``io/native/rasterdec.cc::clut8``)."""
    g = GRID_RGB
    node = quick_saturate_word(np.arange(g) * 65535.0 / (g - 1))
    nodes = np.stack(np.meshgrid(node, node, node, indexing="ij"),
                     -1).reshape(-1, 3)
    out = ls.eval_float([ls.Lab2XYZ()] + _srgb_output(),
                        (nodes / 65535.0).astype(np.float32))
    return quick_saturate_word(out.astype(np.float64) * 65535.0).astype(
        np.uint16).reshape(g, g, g, 3)


def optimise(st):
    """cmsopt.c's choice for 8-bit RGB in and out, after PreOptimize."""
    if all(s.type == "cvst" for s in st):
        raise NotImplementedError(
            "ICC transform that reduces to curves alone (LittleCMS's "
            "joined-curves path)")
    ms = _matrix_shaper(st)
    if ms is not None:
        curves1, mat, off, curves2, ident = ms
        if ident:
            raise NotImplementedError(
                "ICC profile whose colorants join sRGB's to the identity "
                "(LittleCMS's joined-curves path)")
        return MatrixShaper(curves1, mat, off, curves2)
    return ClutTransform(st)


def build_transform(icc):
    """The transform from profile bytes `icc` to the built-in sRGB, as a
    callable on (..., 3) uint8 RGB; `Refused` where Pillow's
    ``profileToProfile`` raises."""
    return optimise(ls.pre_optimize(link(Profile(icc))))


@functools.lru_cache(maxsize=8)
def _cached_transform(icc):
    return build_transform(icc)


def to_srgb(rgb8, icc):
    """(H, W, 3) uint8 converted from profile `icc` to the built-in sRGB."""
    return _cached_transform(bytes(icc))(np.asarray(rgb8, np.uint8))
