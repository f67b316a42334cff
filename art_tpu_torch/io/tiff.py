"""TIFF and BigTIFF in, as Pillow 12.1.0 opens and loads them with its
libtiff 4.7.1, with no PIL.

Pillow's open (``TiffImagePlugin._setup``) keys the first IFD on (byte
order, photometric, sample format, fill order, bits per sample, extra
samples) in its table `OPEN_INFO`, ported here as data, and takes its
mode and raw mode from there; a key the table lacks, a compression
`COMPRESSION_INFO` lacks, a missing colour map or a bad sample count is
`Unidentified`. Its load then takes one of two paths:

- an uncompressed image goes through Pillow's own raw decoder: each
  strip or tile is read from its offset and unpacked row by row with the
  raw mode (fill order 2 through the ``;R`` modes, separate planes
  through one raw mode character a plane);
- any other goes through libtiff: each strip or tile is decompressed
  (none, LZW, deflate, PackBits, LZMA through stdlib ``lzma``, JPEG
  through :mod:`art_tpu_torch.io.jpegdec`, ZSTD, CCITT RLE/RLEW/G3/G4 and
  ThunderScan through ``io/native/tiffdec.cc``, old-style JPEG rebuilt
  from its tags or its interchange stream), bits reversed first under
  fill order 2, the predictor undone (horizontal, or the floating-point
  one's byte planes), and unpacked with the raw mode of fill order 1;
  separate planes are copied into the pixel's first bands. A YCbCr image
  (photometric 6) not under new-style JPEG goes through libtiff's RGBA
  interface as Pillow asks: the subsampled blocks replicated, converted
  with the YCbCrCoefficients and ReferenceBlackWhite by libtiff's tables,
  and a strip that fails to decode kept as far as it went.

A decode that fails where libtiff's fails raises OSError ("decoder error
-2"); what Pillow's raw unpacker refuses raises its ValueError; a form
Pillow loads and the port does not read raises NotImplementedError
naming it. Orientation 2-8 is applied after the load, as Pillow's
``exif_transpose`` in ``load_end`` does.
"""

from __future__ import annotations

import ctypes
import lzma
import struct
import threading
import zlib

import numpy as np

from art_tpu_torch import hostbuild
from art_tpu_torch.io.stdformats import PilValueError, Unidentified

# TiffImagePlugin.OPEN_INFO: (byte orders "I"/"M", photometric, sample
# format, fill order, bits per sample, extra samples, mode, raw mode)
_OPEN_INFO_ROWS = (
    ('IM', 0, (1,), 1, (1,), (), '1', '1;I'),
    ('IM', 0, (1,), 2, (1,), (), '1', '1;IR'),
    ('IM', 1, (1,), 1, (1,), (), '1', '1'),
    ('IM', 1, (1,), 2, (1,), (), '1', '1;R'),
    ('IM', 0, (1,), 1, (2,), (), 'L', 'L;2I'),
    ('IM', 0, (1,), 2, (2,), (), 'L', 'L;2IR'),
    ('IM', 1, (1,), 1, (2,), (), 'L', 'L;2'),
    ('IM', 1, (1,), 2, (2,), (), 'L', 'L;2R'),
    ('IM', 0, (1,), 1, (4,), (), 'L', 'L;4I'),
    ('IM', 0, (1,), 2, (4,), (), 'L', 'L;4IR'),
    ('IM', 1, (1,), 1, (4,), (), 'L', 'L;4'),
    ('IM', 1, (1,), 2, (4,), (), 'L', 'L;4R'),
    ('IM', 0, (1,), 1, (8,), (), 'L', 'L;I'),
    ('IM', 0, (1,), 2, (8,), (), 'L', 'L;IR'),
    ('IM', 1, (1,), 1, (8,), (), 'L', 'L'),
    ('IM', 1, (2,), 1, (8,), (), 'L', 'L'),
    ('IM', 1, (1,), 2, (8,), (), 'L', 'L;R'),
    ('I', 1, (1,), 1, (12,), (), 'I;16', 'I;12'),
    ('I', 0, (1,), 1, (16,), (), 'I;16', 'I;16'),
    ('I', 1, (1,), 1, (16,), (), 'I;16', 'I;16'),
    ('M', 1, (1,), 1, (16,), (), 'I;16B', 'I;16B'),
    ('I', 1, (1,), 2, (16,), (), 'I;16', 'I;16R'),
    ('I', 1, (2,), 1, (16,), (), 'I', 'I;16S'),
    ('M', 1, (2,), 1, (16,), (), 'I', 'I;16BS'),
    ('I', 0, (3,), 1, (32,), (), 'F', 'F;32F'),
    ('M', 0, (3,), 1, (32,), (), 'F', 'F;32BF'),
    ('I', 1, (1,), 1, (32,), (), 'I', 'I;32N'),
    ('I', 1, (2,), 1, (32,), (), 'I', 'I;32S'),
    ('M', 1, (2,), 1, (32,), (), 'I', 'I;32BS'),
    ('I', 1, (3,), 1, (32,), (), 'F', 'F;32F'),
    ('M', 1, (3,), 1, (32,), (), 'F', 'F;32BF'),
    ('IM', 1, (1,), 1, (8, 8), (2,), 'LA', 'LA'),
    ('IM', 2, (1,), 1, (8, 8, 8), (), 'RGB', 'RGB'),
    ('IM', 2, (1,), 2, (8, 8, 8), (), 'RGB', 'RGB;R'),
    ('IM', 2, (1,), 1, (8, 8, 8, 8), (), 'RGBA', 'RGBA'),
    ('IM', 2, (1,), 1, (8, 8, 8, 8), (0,), 'RGB', 'RGBX'),
    ('IM', 2, (1,), 1, (8, 8, 8, 8, 8), (0, 0), 'RGB', 'RGBXX'),
    ('IM', 2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0), 'RGB', 'RGBXXX'),
    ('IM', 2, (1,), 1, (8, 8, 8, 8), (1,), 'RGBA', 'RGBa'),
    ('IM', 2, (1,), 1, (8, 8, 8, 8, 8), (1, 0), 'RGBA', 'RGBaX'),
    ('IM', 2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0), 'RGBA', 'RGBaXX'),
    ('IM', 2, (1,), 1, (8, 8, 8, 8), (2,), 'RGBA', 'RGBA'),
    ('IM', 2, (1,), 1, (8, 8, 8, 8, 8), (2, 0), 'RGBA', 'RGBAX'),
    ('IM', 2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0), 'RGBA', 'RGBAXX'),
    ('IM', 2, (1,), 1, (8, 8, 8, 8), (999,), 'RGBA', 'RGBA'),
    ('I', 2, (1,), 1, (16, 16, 16), (), 'RGB', 'RGB;16L'),
    ('M', 2, (1,), 1, (16, 16, 16), (), 'RGB', 'RGB;16B'),
    ('I', 2, (1,), 1, (16, 16, 16, 16), (), 'RGBA', 'RGBA;16L'),
    ('M', 2, (1,), 1, (16, 16, 16, 16), (), 'RGBA', 'RGBA;16B'),
    ('I', 2, (1,), 1, (16, 16, 16, 16), (0,), 'RGB', 'RGBX;16L'),
    ('M', 2, (1,), 1, (16, 16, 16, 16), (0,), 'RGB', 'RGBX;16B'),
    ('I', 2, (1,), 1, (16, 16, 16, 16), (1,), 'RGBA', 'RGBa;16L'),
    ('M', 2, (1,), 1, (16, 16, 16, 16), (1,), 'RGBA', 'RGBa;16B'),
    ('I', 2, (1,), 1, (16, 16, 16, 16), (2,), 'RGBA', 'RGBA;16L'),
    ('M', 2, (1,), 1, (16, 16, 16, 16), (2,), 'RGBA', 'RGBA;16B'),
    ('IM', 3, (1,), 1, (1,), (), 'P', 'P;1'),
    ('IM', 3, (1,), 2, (1,), (), 'P', 'P;1R'),
    ('IM', 3, (1,), 1, (2,), (), 'P', 'P;2'),
    ('IM', 3, (1,), 2, (2,), (), 'P', 'P;2R'),
    ('IM', 3, (1,), 1, (4,), (), 'P', 'P;4'),
    ('IM', 3, (1,), 2, (4,), (), 'P', 'P;4R'),
    ('IM', 3, (1,), 1, (8,), (), 'P', 'P'),
    ('IM', 3, (1,), 1, (8, 8), (0,), 'P', 'PX'),
    ('IM', 3, (1,), 1, (8, 8), (2,), 'PA', 'PA'),
    ('IM', 3, (1,), 2, (8,), (), 'P', 'P;R'),
    ('IM', 5, (1,), 1, (8, 8, 8, 8), (), 'CMYK', 'CMYK'),
    ('IM', 5, (1,), 1, (8, 8, 8, 8, 8), (0,), 'CMYK', 'CMYKX'),
    ('IM', 5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0), 'CMYK', 'CMYKXX'),
    ('I', 5, (1,), 1, (16, 16, 16, 16), (), 'CMYK', 'CMYK;16L'),
    ('M', 5, (1,), 1, (16, 16, 16, 16), (), 'CMYK', 'CMYK;16B'),
    ('IM', 6, (1,), 1, (8,), (), 'L', 'L'),
    ('IM', 6, (1,), 1, (8, 8, 8), (), 'RGB', 'RGBX'),
    ('IM', 8, (1,), 1, (8, 8, 8), (), 'LAB', 'LAB'),
)
OPEN_INFO = {(order, photo, fmt, fill, bps, extra): (mode, raw)
             for orders, photo, fmt, fill, bps, extra, mode, raw
             in _OPEN_INFO_ROWS for order in orders}
MAX_SAMPLESPERPIXEL = max(len(k[4]) for k in OPEN_INFO)

COMPRESSION_INFO = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4",
                    5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                    8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                    32773: "packbits", 32809: "tiff_thunderscan",
                    32946: "tiff_deflate", 34676: "tiff_sgilog",
                    34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                    50001: "webp"}

# the compressions of COMPRESSION_INFO whose decode always fails in
# libtiff 4.7.1 as Pillow builds it: no WebP codec; SGILog needs a LogL or
# LogLuv photometric, which OPEN_INFO has not
_LOAD_FAILS = {34676, 34677, 50001}

# the bands of Pillow's modes as np.asarray gives them, by the byte of
# Pillow's 4-byte pixel each comes from
_BANDS = {"LA": (0, 3), "PA": (0, 3), "RGB": (0, 1, 2), "LAB": (0, 1, 2),
          "RGBA": (0, 1, 2, 3), "CMYK": (0, 1, 2, 3)}
# the band characters Pillow's raw decoder unpacks one plane with
_BAND_CHARS = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK", "LAB": "LAB",
               "L": "L", "P": "P", "1": "1", "F": "F", "I": "I"}

_BITFLIP = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                    np.uint8)

# field types: struct code of one value, bytes of one value
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
          11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8),
          17: ("q", 8), 18: ("Q", 8)}


class _Ifd:
    """The first IFD as Pillow's ``ImageFileDirectory_v2`` loads it."""

    def __init__(self, buf):
        from art_tpu_torch.io.metadata import _read_ifd

        self.buf = buf
        self.le = buf[:2] == b"II"
        self.big = buf[2:4] in (b"\x2b\x00", b"\x00\x2b")
        self.e = "<" if self.le else ">"
        try:
            if self.big and struct.unpack_from(self.e + "HH", buf, 4) != (8, 0):
                raise struct.error("BigTIFF: offset size other than 8")
            first = struct.unpack_from(self.e + ("Q" if self.big else "I"),
                                       buf, 8 if self.big else 4)[0]
            sizes = {t: s for t, (_, s) in _TYPES.items()}
            self.ents = _read_ifd(buf, first, self.le, self.big, sizes)[0]
        except struct.error as err:  # Pillow's open fails on the IFD
            raise Unidentified(f"TIFF: broken IFD ({err})") from err

    def values(self, tag):
        """The tag's values as a tuple (rationals as floats), or None."""
        if tag not in self.ents:
            return None
        typ, cnt, off = self.ents[tag]
        code, size = _TYPES.get(typ, (None, 0))
        if code is None or off + size * cnt > len(self.buf) or cnt == 0:
            return None
        if typ in (1, 2, 7):
            return tuple(self.buf[off : off + cnt])
        if typ in (5, 10):
            v = struct.unpack_from(self.e + code[0] * (2 * cnt), self.buf, off)
            return tuple(v[2 * i] / v[2 * i + 1] if v[2 * i + 1] else 0.0
                         for i in range(cnt))
        return struct.unpack_from(self.e + code * cnt, self.buf, off)

    def get(self, tag, default=None):
        v = self.values(tag)
        return default if v is None else v[0]

    def seq(self, tag, default=None):
        v = self.values(tag)
        return default if v is None else tuple(int(x) for x in v)

    def raw(self, tag):
        if tag not in self.ents:
            return None
        typ, cnt, off = self.ents[tag]
        return self.buf[off : off + cnt] if typ in (1, 7) else None


class Tiff:
    """A TIFF as Pillow's ``Image.open`` opens it: mode, raw mode, size,
    the tags the load reads, and the strips or tiles."""

    def __init__(self, buf):
        d = self.ifd = _Ifd(buf)
        if 0xBC01 in d.ents:
            raise OSError("Windows Media Photo files not yet supported")
        comp = int(d.get(259, 1))
        if comp not in COMPRESSION_INFO:  # a KeyError in _setup
            raise Unidentified(f"cannot identify image file: TIFF "
                               f"compression {comp}")
        self.comp = comp
        self.planar = int(d.get(284, 1))
        photo = int(d.get(262, 0))
        if comp == 6:
            photo = 6
        self.photo = photo
        self.fill = int(d.get(266, 1))
        w, h = d.get(256), d.get(257)
        if w is None or h is None:
            raise Unidentified("cannot identify image file: TIFF: missing "
                               "dimensions")
        if not isinstance(w, int) or not isinstance(h, int):
            raise PilValueError("Invalid dimensions")
        self.w, self.h = w, h
        fmt = d.seq(339, (1,))
        if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
            fmt = (1,)
        bps = d.seq(258, (1,))
        extra = d.seq(338, ())
        bps_count = {2: 3, 6: 3, 8: 3, 5: 4}.get(photo, 1) + len(extra)
        spp = int(d.get(277, 3 if comp == 6 and photo in (2, 6) else 1))
        if spp > MAX_SAMPLESPERPIXEL:
            raise Unidentified("cannot identify image file: Invalid value "
                               "for samples per pixel")
        if spp < len(bps):
            bps = bps[:spp]
        elif spp > len(bps) and len(bps) == 1:
            bps = bps * spp
        if len(bps) != spp:
            raise Unidentified("cannot identify image file: unknown data "
                               "organization")
        key = ("I" if d.le else "M", photo, fmt, self.fill, bps, extra)
        if key not in OPEN_INFO:
            raise Unidentified(f"cannot identify image file: TIFF of "
                               f"unknown pixel mode {key}")
        self.mode, self.rawmode = OPEN_INFO[key]
        self.spp, self.bps, self.extra, self.fmt = spp, bps, extra, fmt
        self.bps_count = bps_count
        self.libtiff = comp != 1
        if self.libtiff:
            if self.fill == 2:
                self.mode, self.rawmode = OPEN_INFO[key[:3] + (1,) + key[4:]]
            if photo == 6 and comp == 7 and self.planar == 1:
                self.rawmode = "RGB"
            elif self.rawmode == "I;16":
                self.rawmode = "I;16N"
            elif self.rawmode.endswith((";16B", ";16L")):
                self.rawmode = self.rawmode[:-1] + "N"
        self.tiled = 322 in d.ents
        if self.tiled:
            tw, th = d.get(322), d.get(323)
            if not isinstance(tw, int) or not isinstance(th, int):
                raise PilValueError("Invalid tile dimensions")
            self.offsets = d.seq(324)
            self.counts = d.seq(325)
        elif 273 in d.ents:
            tw, th = w, int(d.get(278, h))
            self.offsets = d.seq(273)
            self.counts = d.seq(279)
        else:
            raise Unidentified("cannot identify image file: unknown data "
                               "organization")
        if self.offsets is None:
            raise Unidentified("cannot identify image file: TIFF: no strip "
                               "or tile offsets")
        self.tw, self.th = tw, th
        self.icc = d.raw(34675)
        self.palette = None
        if self.mode in ("P", "PA"):
            cmap = d.seq(320)
            if cmap is None:
                raise Unidentified("cannot identify image file: TIFF: no "
                                   "colour map")
            cmap = np.asarray(cmap, np.uint32) // 256
            n = len(cmap) // 3
            pal = np.zeros((256, 3), np.uint8)
            pal[:] = np.arange(256, dtype=np.uint8)[:, None]
            pal[: min(n, 256)] = cmap[: 3 * n].reshape(3, n).T[:256]
            self.palette = pal
        self.orientation = d.get(274, 1)


def open_tiff(buf):
    """`Tiff` of the bytes; Unidentified where Pillow's open fails."""
    try:
        return Tiff(buf)
    except (struct.error, IndexError, TypeError) as err:
        raise Unidentified(f"cannot identify image file: {err}") from err


# -- unpacking -------------------------------------------------------------

def _bits(rows, depth, w):
    """(n, row bytes) uint8 -> (n, w) values of `depth` bits, MSB first."""
    b = np.unpackbits(rows, axis=1)[:, : w * depth].reshape(rows.shape[0], w,
                                                            depth)
    v = np.zeros((rows.shape[0], w), np.uint16)
    for k in range(depth):
        v = (v << 1) | b[..., k]
    return v


def _rawbits(rawmode):
    """The bits a pixel of Pillow's raw mode takes."""
    if rawmode in ("1", "1;I", "1;R", "1;IR", "P;1", "P;1R"):
        return 1
    if rawmode.startswith(("L;2", "P;2")):
        return 2
    if rawmode.startswith(("L;4", "P;4")):
        return 4
    if rawmode == "I;12":
        return 12
    if rawmode.startswith("I;16"):
        return 16
    if rawmode.startswith(("I;32", "F;32")):
        return 32
    if ";16" in rawmode:
        return 16 * len(rawmode.split(";")[0])
    base = rawmode.split(";")[0]
    return 8 * len(base)


# the raw modes of fill order 2, by the raw mode of their reversed bytes
_REVERSED = {"1;R": "1", "1;IR": "1;I", "L;2R": "L;2", "L;2IR": "L;2I",
             "L;4R": "L;4", "L;4IR": "L;4I", "L;R": "L", "L;IR": "L;I",
             "P;1R": "P;1", "P;2R": "P;2", "P;4R": "P;4", "P;R": "P",
             "RGB;R": "RGB", "I;16R": "I;16"}


# raw modes of OPEN_INFO that Pillow has no unpacker for: its raw decoder
# refuses them (libtiff's path reads them in the fill order 1 mode)
_NO_UNPACKER = {"L;IR", "P;1R", "P;2R", "P;4R"}


def _unpack(mode, rawmode, rows, w):
    """Rows of one strip or tile, (n, row bytes) uint8, through Pillow's
    unpacker `rawmode` into `mode`: (n, w) for one band ("1" as 0/255),
    (n, w, 4) Pillow's 4-byte pixels for more."""
    n = rows.shape[0]
    if rawmode in _REVERSED:  # fill order 2: each byte's bits reversed
        rows = _BITFLIP[rows]
        rawmode = _REVERSED[rawmode]
    if mode == "1":
        v = _bits(rows, 1, w).astype(np.uint8)
        if rawmode == "1;I":
            v = 1 - v
        return v * 255
    if mode in ("L", "P"):
        if rawmode in ("L;2", "L;2I", "L;4", "L;4I", "P;1", "P;2", "P;4"):
            depth = int(rawmode[2])
            v = _bits(rows, depth, w).astype(np.uint8)
            if mode == "L":
                v = v * (255 // ((1 << depth) - 1))
                if rawmode.endswith("I"):
                    v = 255 - v
            return v.astype(np.uint8)
        if rawmode in ("L", "P"):
            return rows[:, :w].copy()
        if rawmode == "L;I":
            return 255 - rows[:, :w]
        if rawmode == "PX":
            return rows[:, : 2 * w : 2].copy()
    if mode in ("I;16", "I;16B"):
        if rawmode == "I;12":
            v = _bits(rows, 12, w)
            return v.astype("<u2")
        dt = ">u2" if rawmode == "I;16B" else "<u2"
        v = rows[:, : 2 * w].copy().view(dt).reshape(n, w)
        return v.astype(">u2" if mode == "I;16B" else "<u2")
    if mode == "I":
        kind = {"I": "<i4", "I;16S": "<i2", "I;16BS": ">i2", "I;32N": "<u4",
                "I;32S": "<i4", "I;32BS": ">i4"}[rawmode]
        size = int(kind[2])
        v = rows[:, : size * w].copy().view(kind).reshape(n, w)
        return v.astype(np.int64).astype(np.uint32).view(np.int32) \
            if kind == "<u4" else v.astype(np.int32)
    if mode == "F":
        kind = ">f4" if rawmode == "F;32BF" else "<f4"
        return rows[:, : 4 * w].copy().view(kind).reshape(n, w).astype(
            np.float32)
    # bands into Pillow's 4-byte pixel
    base, _, tail = rawmode.partition(";")
    wide = tail.startswith("16")
    step = len(base) * (2 if wide else 1)
    px = rows[:, : step * w].reshape(n, w, step)
    if wide:
        hi = 0 if tail == "16B" else 1  # "16L", "16N": little-endian here
        px = px[..., hi::2]
    out = np.zeros((n, w, 4), np.uint8)
    if mode == "RGB":
        out[..., 3] = 255
    if mode in ("LA", "PA"):
        out[..., 0] = px[..., 0]
        out[..., 3] = px[..., 1]
        if mode == "LA":
            out[..., 1] = out[..., 2] = px[..., 0]
        return out
    bands = len(_BANDS[mode])
    out[..., :bands] = px[..., :bands]
    if mode == "LAB":
        out[..., 1:3] ^= 128
    if base.startswith("RGBa"):
        _unpremultiply(out)
    return out


def _unpremultiply(px):
    """Pillow's "RGBa" unpackers: colour times 255 over alpha, clipped; an
    alpha of 0 zeroes the pixel."""
    a = px[..., 3].astype(np.int32)
    c = px[..., :3].astype(np.int32)
    safe = np.maximum(a, 1)[..., None]
    v = np.minimum(c * 255 // safe, 255)
    v = np.where(a[..., None] == 255, c, v)
    v = np.where(a[..., None] == 0, 0, v)
    px[..., :3] = v.astype(np.uint8)


# -- codecs ----------------------------------------------------------------

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = hostbuild.load("tiffdec")
            P = ctypes.c_char_p
            S = ctypes.c_size_t
            I = ctypes.c_int
            lib.tiffdec_zstd.argtypes = [P, S, P, S, P, I]
            lib.tiffdec_fax.argtypes = [P, S, P, S, I, I, I, P, I]
            lib.tiffdec_thunder.argtypes = [P, S, P, S, I, P, I]
            for f in (lib.tiffdec_zstd, lib.tiffdec_fax, lib.tiffdec_thunder):
                f.restype = I
            _LIB = lib
        return _LIB


class _Broken(Exception):
    """A strip libtiff fails to decode: `partial` what it wrote first."""

    def __init__(self, msg, partial=b""):
        super().__init__(msg)
        self.partial = partial


def _native(fn, data, occ, *args):
    out = ctypes.create_string_buffer(max(occ, 1))
    msg = ctypes.create_string_buffer(256)
    ok = fn(bytes(data), len(data), out, occ, *args, msg, len(msg))
    got = out.raw[:occ]
    if not ok:
        raise _Broken(msg.value.decode("ascii", "replace"), got)
    return got


def _lzw(data, occ):
    """libtiff's LZWDecode: MSB-first codes of 9 to 12 bits, the early
    change; the strip must give `occ` bytes."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    nbits = 9
    bitpos = 0
    end = len(data) * 8
    data = bytes(data) + b"\0\0\0"
    prev = None
    while bitpos + nbits <= end and len(out) < occ:
        i, off = divmod(bitpos, 8)
        code = (int.from_bytes(data[i : i + 3], "big")
                >> (24 - off - nbits)) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == 256:
            del table[258:]
            nbits = 9
            prev = None
            continue
        if code == 257:
            break
        if prev is None:
            if code >= 256:
                raise _Broken("Corrupted LZW table", bytes(out))
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise _Broken("Corrupted LZW table", bytes(out))
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << nbits) and nbits < 12:
            nbits += 1
    if len(out) < occ:
        raise _Broken("LZWDecode: Not enough data", bytes(out))
    return bytes(out[:occ])


def _packbits(data, occ):
    """libtiff's PackBitsDecode."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < occ:
        c = data[i]
        i += 1
        if c >= 128:
            c -= 256
        if c < 0:
            if c == -128:
                continue
            run = min(-c + 1, occ - len(out))
            if i >= n:
                break
            out += data[i : i + 1] * run
            i += 1
        else:
            run = min(c + 1, occ - len(out))
            if n - i < c + 1:
                break
            out += data[i : i + run]
            i += c + 1
    if len(out) < occ:
        raise _Broken("PackBitsDecode: Not enough data",
                      bytes(out).ljust(occ, b"\0"))
    return bytes(out)


def _inflate(data, occ):
    """libtiff's ZIPDecode: inflate until the strip is full."""
    d = zlib.decompressobj()
    try:
        out = d.decompress(data, occ)
    except zlib.error as err:
        raise _Broken(f"ZIPDecode: {err}") from err
    if len(out) < occ:
        raise _Broken("ZIPDecode: Not enough data", out)
    return out


def _unlzma(data, occ):
    """libtiff's LZMADecode: an xz stream (lzma_stream_decoder) until the
    strip is full."""
    d = lzma.LZMADecompressor(format=lzma.FORMAT_XZ)
    try:
        out = d.decompress(data, occ)
    except lzma.LZMAError as err:
        raise _Broken(f"LZMADecode: {err}") from err
    if len(out) < occ:
        raise _Broken("LZMADecode: Not enough data", out)
    return out


# -- the load --------------------------------------------------------------

class _Image:
    """Pillow's image memory: one band (h, w) or 4-byte pixels."""

    def __init__(self, t):
        self.t = t
        if t.mode in _BANDS:
            self.px = np.zeros((t.h, t.w, 4), np.uint8)
            if t.mode == "RGB":
                self.px[..., 3] = 255
        else:
            dt = {"1": np.uint8, "L": np.uint8, "P": np.uint8,
                  "I;16": "<u2", "I;16B": ">u2", "I": np.int32,
                  "F": np.float32}[t.mode]
            self.px = np.zeros((t.h, t.w), dt)

    def put(self, y, x, blk):
        hh, ww = blk.shape[:2]
        self.px[y : y + hh, x : x + ww] = blk

    def array(self):
        """np.asarray of the image."""
        m = self.t.mode
        if m == "1":
            return self.px > 0
        if m in _BANDS:
            arr = np.ascontiguousarray(self.px[..., list(_BANDS[m])])
            if m == "LAB":  # Pillow's "LAB" packer undoes the unpacker's
                arr[..., 1:] ^= 128  # a and b offsets
            return arr
        return self.px


def load(buf):
    """(mode, np.asarray(image), palette, icc) of a TIFF file as Pillow
    opens it by its path and loads it; palette (256, 3) uint8 for "P" and
    "PA", else None. A single raw strip is mapped (`_mapped`)."""
    t = open_tiff(buf)
    from art_tpu_torch.io import unported

    unported._bomb((t.w, t.h))
    arr = _mapped(t, buf)
    if arr is None:
        img = _Image(t)
        if t.libtiff:
            _load_libtiff(t, buf, img)
        else:
            _load_raw(t, buf, img)
        arr = img.array()
    return t.mode, _orient(arr, t.orientation), t.palette, t.icc


# ImageFile.load maps these modes' raw data where they are also the raw
# mode (Image._MAPMODES), by bytes a pixel
_MAPMODES = {"L": 1, "P": 1, "I;16": 2, "I;16L": 2, "I;16B": 2, "RGBX": 4,
             "RGBA": 4, "CMYK": 4}


def _mapped(t, buf):
    """ImageFile.load's memory map of a file opened by path: one raw
    strip or tile whose raw mode is its mode is read as an image of
    Pillow's size, which Orientation 5-8 has swapped (the rows then
    fall at another width; ``exif_transpose`` follows). None where the
    map is not taken; ValueError where the file is shorter than the
    image (``map_buffer``)."""
    tiles = _tiles(t)
    if t.libtiff or len(tiles) != 1 or t.mode not in _MAPMODES:
        return None
    x, y, layer, i = tiles[0]
    rawmode = t.rawmode[layer] if t.planar == 2 else t.rawmode
    if rawmode != t.mode:
        return None
    stride = t.tw * sum(t.bps) / 8 if x + t.tw > t.w else 0
    if t.planar == 2:
        stride /= t.bps_count
    stride = int(stride)
    w, h = (t.h, t.w) if t.orientation in (5, 6, 7, 8) else (t.w, t.h)
    off = t.offsets[i]
    if off + h * stride > len(buf):
        return None  # "buffer is not large enough": the decoder reads it
    px = _MAPMODES[t.mode]
    stride = stride if stride > 0 else w * px
    if off + h * stride > len(buf):
        raise PilValueError("buffer is not large enough")
    rows = np.frombuffer(buf, np.uint8, h * stride, off).reshape(h, stride)
    rows = rows[:, : w * px]
    if px == 1:
        return rows.copy()
    if px == 2:
        return rows.copy().view(">u2" if t.mode == "I;16B" else "<u2")
    arr = rows.reshape(h, w, 4)
    return arr[..., :3].copy() if t.mode == "RGBX" else arr.copy()


def _orient(arr, o):
    """ImageOps.exif_transpose of the loaded image."""
    if o == 2:
        return arr[:, ::-1]
    if o == 3:
        return arr[::-1, ::-1]
    if o == 4:
        return arr[::-1]
    if o == 5:
        return np.swapaxes(arr, 0, 1)
    if o == 6:
        return np.rot90(arr, -1)
    if o == 7:
        return np.swapaxes(arr[::-1, ::-1], 0, 1)
    if o == 8:
        return np.rot90(arr, 1)
    return arr


def _tiles(t):
    """Pillow's tile walk: (x, y, layer, offset index) of each strip or
    tile, in the order of the offsets."""
    x = y = layer = 0
    offsets = t.offsets
    first = 0
    if t.tw == t.w and t.th == t.h and t.planar != 2:
        first = len(offsets) - 1
    out = []
    for i in range(first, len(offsets)):
        out.append((x, y, layer, i))
        x += t.tw
        if x >= t.w:
            x, y = 0, y + t.th
            if y >= t.h:
                y = 0
                layer += 1
    return out


def _load_raw(t, buf, img):
    """Pillow's raw decoder over each strip or tile, read from its offset
    (not bounded by its byte count); separate planes through one raw mode
    character a plane (a band copy, "1" bits, "I" and "F" 32-bit)."""
    for x, y, layer, i in _tiles(t):
        if t.planar == 2 and layer >= len(t.rawmode):
            raise Unidentified("cannot identify image file: TIFF: more "
                               "planes than the raw mode has bands")
        x1, y1 = min(x + t.tw, t.w), min(y + t.th, t.h)
        if x >= x1 or y >= y1:
            continue
        vis = x1 - x
        rawmode = t.rawmode
        stride = t.tw * sum(t.bps) / 8 if x + t.tw > t.w else 0
        if t.planar == 2:
            rawmode = rawmode[layer]
            if rawmode not in _BAND_CHARS.get(t.mode, ""):
                raise PilValueError("unknown raw mode for given image mode")
            stride /= t.bps_count
            bits = {"1": 1, "I": 32, "F": 32}.get(rawmode, 8)
        else:
            if rawmode in _NO_UNPACKER:
                raise PilValueError("unknown raw mode for given image mode")
            bits = _rawbits(rawmode)
        row = (vis * bits + 7) // 8
        stride = int(stride)
        step = stride if stride else row
        if step < row:
            raise OSError("decoder error -8")
        rows = y1 - y
        need = (rows - 1) * step + row
        off = t.offsets[i]
        data = buf[off : off + need]
        if len(data) < need:
            raise OSError("image file is truncated")
        arr = np.frombuffer(data + b"\0" * (rows * step - need), np.uint8)
        arr = arr.reshape(rows, step)[:, :row]
        if t.planar == 2 and t.mode in _BANDS:
            k = _BAND_CHARS[t.mode].index(rawmode)
            img.px[y:y1, x:x1, k] = arr[:, :vis]
        else:
            img.put(y, x, _unpack(t.mode, rawmode, arr, vis))


def _broken():
    return OSError("decoder error -2")


def _load_libtiff(t, buf, img):
    """libtiff's decode as Pillow's ImagingLibTiffDecode drives it."""
    comp, photo = t.comp, t.photo
    libphoto = t.ifd.get(262, 6 if comp == 6 else None)
    if comp == 6 and libphoto in (None, 2):
        libphoto = 6
    if comp in _LOAD_FAILS:
        raise _broken()
    if comp == 6 and libphoto != 6:
        if t.spp != 1:
            # Pillow's RGBX rows are wider than libtiff's three samples
            raise _broken()
        _load_ojpeg_grey(t, buf, img)
        return
    if comp == 32809 and t.bps[0] != 4:
        raise _broken()  # ThunderSetupDecode: 4 bits only
    if comp in (2, 3, 4, 32771) and (t.spp != 1 or t.bps[0] != 1):
        raise _broken()  # tif_fax3: "Bits/sample must be 1"
    if libphoto == 6 and not (comp == 7 and t.planar == 1):
        _load_rgba(t, buf, img)
        return
    planes = len(_BANDS[t.mode]) if (t.planar == 2 and t.mode in _BANDS) \
        else 1
    if planes > 1 and t.bps[0] not in (8, 16):
        raise _broken()
    if t.tiled:
        tw, th = t.tw, t.th
    else:
        tw = t.w
        th = t.th if 0 < t.th < 0xFFFFFFFF else t.h
        th = min(th, t.h)
    spp_block = 1 if t.planar == 2 else t.spp
    scan = (tw * spp_block * t.bps[0] + 7) // 8
    if comp == 7 and photo == 6 and t.planar == 1:
        scan = tw * 3
    if scan == 0 or (tw * _rawbits(t.rawmode) // planes + 7) // 8 > scan:
        raise _broken()
    across = (t.w + tw - 1) // tw
    down = (t.h + th - 1) // th
    per_plane = across * down
    for plane in range(planes):
        for by in range(down):
            for bx in range(across):
                idx = by * across + bx + plane * per_plane
                y, x = by * th, bx * tw
                rows = th if t.tiled else min(th, t.h - y)
                blk = _read_block(t, buf, idx, rows, tw, scan)
                hh, ww = min(th, t.h - y), min(tw, t.w - x)
                arr = np.frombuffer(blk, np.uint8).reshape(rows, scan)[:hh]
                if planes > 1:
                    # "R;16N"-like band unpackers: a 16-bit sample's
                    # high byte, libtiff having put it in native order
                    band = arr[:, 1 : 2 * ww : 2] if t.bps[0] == 16 \
                        else arr[:, :ww]
                    img.px[y : y + hh, x : x + ww, plane] = band
                else:
                    img.put(y, x, _unpack(t.mode, t.rawmode, arr, ww))
    if planes > 3 and t.mode == "RGBA" and t.extra and t.extra[0] in (0, 1):
        _unpremultiply(img.px)


def _load_ojpeg_grey(t, buf, img):
    """Old-style JPEG of one sample a pixel under a photometric other than
    YCbCr: tif_ojpeg's stream of one component read by libjpeg's
    scanlines (grey, unconverted), strip after strip; a failure anywhere
    fails the load."""
    from art_tpu_torch.io import jpegdec, ojpeg

    if ojpeg.header_fails(t, 1):
        raise _broken()  # the header
    jstream, _ = ojpeg.stream(t, buf, (1, 1), ncomp=1)
    if jstream is None:
        raise _broken()  # OJPEGPreDecode: the header
    try:
        planes, failed_at = jpegdec.decode_raw(jstream)
    except OSError as err:
        raise _broken() from err
    if failed_at is not None:
        raise _broken()
    plane = planes[0][0]
    if plane.shape[0] < t.h or plane.shape[1] < t.w:
        raise _broken()  # libjpeg runs out of scanlines
    img.px[:, :] = plane[: t.h, : t.w]


def _strip_data(t, buf, idx):
    """The bytes of strip or tile `idx` as libtiff reads them; bits
    reversed under fill order 2 (the fax decoders read them reversed)."""
    if idx >= len(t.offsets):
        raise _broken()
    off = t.offsets[idx]
    n = t.counts[idx] if t.counts and idx < len(t.counts) \
        else len(buf) - off
    if off > len(buf) or n > len(buf) - off:
        raise _broken()  # TIFFFillStrip: "Read error on strip"
    if n == 0 and t.comp != 1:
        raise _broken()  # TIFFFillStrip: "Invalid strip byte count"
    data = buf[off : off + n]
    if t.fill == 2:
        data = _BITFLIP[np.frombuffer(data, np.uint8)].tobytes()
    return data


# the codecs libtiff runs the predictor after
_PREDICTED = {5, 8, 32946, 34925, 50000}


def _read_block(t, buf, idx, rows, tw, scan, predict=True):
    """TIFFReadEncodedStrip/Tile: `rows` rows of `scan` bytes decoded, the
    predictor undone (unless `predict` is off), multi-byte samples in the
    host's (little-endian) order as libtiff delivers them; OSError where
    libtiff fails, its cause a `_Broken` with what the codec wrote."""
    occ = rows * scan
    comp = t.comp
    data = _strip_data(t, buf, idx)
    try:
        if comp in (8, 32946):
            out = _inflate(data, occ)
        elif comp == 5:
            out = _lzw(data, occ)
        elif comp == 32773:
            out = _packbits(data, occ)
        elif comp == 34925:
            out = _unlzma(data, occ)
        elif comp == 50000:
            out = _native(_lib().tiffdec_zstd, data, occ)
        elif comp in (2, 3, 4, 32771):
            kind = {2: 0, 32771: 0, 3: 1, 4: 2}[comp]
            opts = 0
            if comp == 32771:
                opts = 1 | ((t.offsets[idx] & 1) << 1)
            elif comp == 3:
                opts = int(t.ifd.get(292, 0))
            out = _native(_lib().tiffdec_fax, data, occ, tw, kind, opts)
        elif comp == 32809:
            out = _native(_lib().tiffdec_thunder, data, occ, tw)
        else:
            out = _jpeg_block(t, data, rows, tw)
    except _Broken as err:
        raise _broken() from err
    pred = int(t.ifd.get(317, 1)) if comp in _PREDICTED and predict else 1
    if pred == 3:
        return _unpredict_float(out, rows, tw, t, scan)
    if pred == 2:
        try:
            out = _unpredict(out, rows, t, scan)
        except _Broken as err:
            raise _broken() from err
    elif pred != 1:
        raise _broken()  # PredictorSetup: an unknown predictor
    if not t.ifd.le and t.bps[0] in (16, 32, 64):
        nb = t.bps[0] // 8
        a = np.frombuffer(out, np.uint8).reshape(rows, scan)
        n = scan // nb * nb
        out = a.copy()
        out[:, :n] = a[:, :n].reshape(rows, -1, nb)[..., ::-1].reshape(rows, n)
        out = out.tobytes()
    return out


def _unpredict(data, rows, t, scan):
    """libtiff's horizontal predictor (tif_predict.c): running sums of each
    sample along each row of `scan` bytes (its rowsize, TIFFScanlineSize:
    for YCbCr a row of sampling blocks over the vertical sampling), in
    the sample's width; a `_Broken` with the codec's output where a row
    is not whole pixels (horAcc8's "(cc%stride)!=0")."""
    spp = 1 if t.planar == 2 else t.spp
    bps = t.bps[0]
    if bps not in (8, 16, 32, 64):
        raise _broken()  # "Horizontal differencing Predictor not supported"
    if scan % (spp * bps // 8):
        raise _Broken("(cc%stride)!=0", data)
    e = t.ifd.e
    dt = np.dtype({8: "u1", 16: e + "u2", 32: e + "u4", 64: e + "u8"}[bps])
    v = np.frombuffer(data, dt, rows * scan // dt.itemsize)
    v = np.cumsum(v.reshape(rows, -1, spp), axis=1,
                  dtype=dt.newbyteorder("="))
    return v.astype(dt).tobytes()


def _unpredict_float(data, rows, tw, t, scan):
    """libtiff's floating-point predictor (fpAcc): the row's bytes summed
    along it sample-interleaved, then regrouped from byte planes (most
    significant first) into samples in the host's order."""
    spp = 1 if t.planar == 2 else t.spp
    bps = t.bps[0]
    if bps not in (16, 24, 32, 64) or t.fmt[0] != 3:
        raise _broken()  # "Floating point Predictor not supported"
    nb = bps // 8
    n = tw * spp * nb
    a = np.frombuffer(data, np.uint8).reshape(rows, scan)[:, :n]
    acc = np.cumsum(a.reshape(rows, tw * nb, spp).astype(np.uint8), axis=1,
                    dtype=np.uint8).reshape(rows, n)
    # byte plane k holds byte k (most significant first) of every sample
    planes = acc.reshape(rows, nb, tw * spp)
    le = np.moveaxis(planes, 1, 2)[..., ::-1]  # (rows, samples, nb)
    out = np.frombuffer(data, np.uint8).reshape(rows, scan).copy()
    out[:, :n] = le.reshape(rows, n)
    return out.tobytes()


def _jpeg_block(t, data, rows, tw):
    """A JPEG-compressed strip or tile (compression 7) as libtiff's
    JPEGDecode gives it: YCbCr converted to RGB (JPEGCOLORMODE_RGB, which
    Pillow sets for photometric 6), any other photometric's components
    unconverted."""
    from art_tpu_torch.io import jpegdec

    color = 1 if t.photo == 6 else 0
    stream = _join_tables(t.ifd.raw(347), data)
    try:
        blk = jpegdec.decode_tiff_stream(stream, color)
    except OSError as err:
        raise _Broken(str(err)) from err
    blk = blk.reshape(blk.shape[0], blk.shape[1], -1)
    comps = 3 if color else (1 if t.planar == 2 else t.spp)
    if blk.shape[2] != comps or blk.shape[0] < rows and not t.tiled \
            and blk.shape[0] < min(rows, t.h) or blk.shape[1] < tw:
        raise _Broken("JPEG strip of the wrong size")
    out = np.zeros((rows, tw, comps), np.uint8)
    hh = min(rows, blk.shape[0])
    out[:hh] = blk[:hh, :tw]
    return out.tobytes()


def _join_tables(tables, stream):
    """A strip's JPEG stream with the JPEGTables' markers before its own,
    as libtiff hands libjpeg the tables and then the strip."""
    if not tables:
        return stream
    head = tables[:-2] if tables[-2:] == b"\xff\xd9" else tables
    body = stream[2:] if stream[:2] == b"\xff\xd8" else stream
    return head + body


# -- YCbCr through libtiff's RGBA interface ---------------------------------

def ycbcr_tables(luma, refbw):
    """TIFFYCbCrToRGBInit's tables (tif_color.c): (Y, Cr_r, Cb_b, Cr_g,
    Cb_g), each 256 int64, in float32 and int32 as libtiff computes
    them."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)
    rb = [f32(v) for v in refbw]

    def fix(x):
        return int(np.float64(f32(x) * f32(65536.0)) + 0.5)

    def clamp(f, lo, hi):
        return lo if f < lo else hi if f > hi else f

    f1 = f32(f32(2) - f32(2) * lr)
    d1 = fix(clamp(f1, f32(0), f32(2)))
    f2 = f32(lr * f1 / lg)
    d2 = -fix(clamp(f2, f32(0), f32(2)))
    f3 = f32(f32(2) - f32(2) * lb)
    d3 = fix(clamp(f3, f32(0), f32(2)))
    f4 = f32(lb * f3 / lg)
    d4 = -fix(clamp(f4, f32(0), f32(2)))

    def code2v(c, lo, hi, cr):
        den = f32(hi - lo)
        if den == 0:
            den = f32(1)
        return f32(f32(f32(c - int(lo)) * f32(cr)) / den)

    def clampw(f):
        lo, hi = f32(-128.0 * 32), f32(128.0 * 32)
        v = lo if f < lo else hi if f > hi else f
        return int(v)  # the cast to int32 truncates toward zero

    y_tab = np.zeros(256, np.int64)
    crr = np.zeros(256, np.int64)
    cbb = np.zeros(256, np.int64)
    crg = np.zeros(256, np.int64)
    cbg = np.zeros(256, np.int64)
    half = 1 << 15
    for i in range(256):
        x = i - 128
        cr = clampw(code2v(x, f32(rb[4] - f32(128)), f32(rb[5] - f32(128)),
                           127))
        cb = clampw(code2v(x, f32(rb[2] - f32(128)), f32(rb[3] - f32(128)),
                           127))
        crr[i] = (d1 * cr + half) >> 16
        cbb[i] = (d3 * cb + half) >> 16
        crg[i] = d2 * cr
        cbg[i] = d4 * cb + half
        y_tab[i] = clampw(code2v(x + 128, rb[0], rb[1], 255))
    return y_tab, crr, cbb, crg, cbg


def ycbcr_to_rgb(y, cb, cr, tabs):
    """TIFFYCbCrtoRGB of uint8 planes of one shape: (..., 3) uint8."""
    y_tab, crr, cbb, crg, cbg = tabs
    yy = y_tab[y]
    r = yy + crr[cr]
    g = yy + ((cbg[cb] + crg[cr]) >> 16)
    b = yy + cbb[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# the subsamplings tif_getimage.c converts (PickContigCase)
_SUBSAMPLINGS = {(4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)}


def _ycbcr_setup(t, sampling):
    """The YCbCr conversion of TIFFRGBAImageBegin; OSError where it fails
    ("Can not handle format")."""
    d = t.ifd
    # PickContigCase converts each subsampling above; PickSeparateCase
    # only 1x1 (putseparate8bitYCbCr11tile)
    if t.bps[0] != 8 or t.spp != 3 or t.planar not in (1, 2) or \
            tuple(sampling) not in _SUBSAMPLINGS or \
            (t.planar == 2 and tuple(sampling) != (1, 1)):
        raise _broken()
    luma = d.values(529) or (0.299, 0.587, 0.114)
    refbw = d.values(532) or (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)
    if len(luma) < 3 or len(refbw) < 6 or float(luma[1]) == 0.0 or \
            any(np.isnan(luma)) or any(np.isnan(refbw)):
        raise _broken()
    return ycbcr_tables(luma[:3], refbw[:6])


def blocks_to_rgb(data, rows, w, hs, vs, tabs):
    """libtiff's packed YCbCr blocks of `rows` image rows (a block: hs*vs
    luma samples, row by row, then Cb and Cr) as putcontig8bitYCbCr*tile
    converts them: (rows, w, 3), chroma replicated over its block."""
    bw = (w + hs - 1) // hs
    brows = (rows + vs - 1) // vs
    bsize = hs * vs + 2
    a = np.frombuffer(data, np.uint8)[: brows * bw * bsize]
    a = np.pad(a, (0, brows * bw * bsize - a.size)).reshape(brows, bw, bsize)
    lum = a[..., : hs * vs].reshape(brows, bw, vs, hs)
    lum = np.moveaxis(lum, 2, 1).reshape(brows * vs, bw * hs)[:rows, :w]
    cb = np.repeat(np.repeat(a[..., hs * vs], vs, 0), hs, 1)[:rows, :w]
    cr = np.repeat(np.repeat(a[..., hs * vs + 1], vs, 0), hs, 1)[:rows, :w]
    return ycbcr_to_rgb(lum, cb, cr, tabs)


def _load_rgba(t, buf, img):
    """Pillow's _decodeAsRGBA: TIFFRGBAImageGet a strip at a time,
    stoponerr off. Each call reads its strip into a new zeroed buffer,
    allocated once the strip is read and its decoder set up (tif_ojpeg
    reads the JPEG header and starts libjpeg there): a failure before
    that fails the load; a strip that fails to decode keeps what the
    codec wrote, zeros after it. libtiff reads `vs` scanlines of a block
    row at a time (TIFFScanlineSize, the block row's bytes over `vs`)."""
    from art_tpu_torch.io import jpegdec, ojpeg

    d = t.ifd
    sampling = tuple(d.seq(530, (2, 2))[:2]) if d.values(530) else (2, 2)
    if t.comp == 6:  # the JPEG's own sampling, as OJPEGSubsamplingCorrect
        jstream, sampling = ojpeg.stream(t, buf, sampling)
    tabs = _ycbcr_setup(t, sampling)  # TIFFRGBAImageBegin
    if t.comp != 6 and t.planar == 2:
        _load_rgba_separate(t, buf, img, tabs)
        return
    if t.comp != 6 and t.tiled:
        _load_rgba_tiles(t, buf, img, tabs, sampling)
        return
    packed = None
    hs, vs = sampling
    th = t.th if 0 < t.th < 0xFFFFFFFF else t.h
    th = min(th, t.h)
    if t.comp == 6:
        # RowsPerStrip naming more strips than the offsets hold: the first
        # missing strip's decode runs out of data (its rows stay zero),
        # and the next one's setup fails the load
        missing = ojpeg.strip_count(t) - len(t.offsets)
        if jstream is None or missing > 1 or ojpeg.header_fails(t, vs):
            raise _broken()  # OJPEGPreDecode: the header
        try:
            planes, failed_at = jpegdec.decode_raw(jstream)
        except OSError as err:
            raise _broken() from err
        packed = ojpeg.ycbcr_blocks(planes, t.w, t.h, *sampling)
        if missing == 1:
            packed[len(t.offsets) * th // vs :] = 0
        if failed_at is not None:
            # the strip whose decode fails keeps none of its rows, and
            # every strip after it fails at once
            first = failed_at * 8 * vs // th * th
            packed[first // vs :] = 0
    block_row = (t.w + hs - 1) // hs * (hs * vs + 2)
    for i, y in enumerate(range(0, t.h, th)):
        rows = min(th, t.h - y)
        brows = (rows + vs - 1) // vs
        if t.comp == 6:
            got = packed[y // vs : y // vs + brows].tobytes()
        else:
            try:
                got = _read_block(t, buf, i, brows * vs, t.w, block_row // vs)
            except OSError as err:
                if not isinstance(err.__cause__, _Broken):
                    raise  # TIFFFillStrip failed: no strip buffer
                got = err.__cause__.partial
        img.px[y : y + rows, :, :3] = blocks_to_rgb(
            got[: brows * block_row], rows, t.w, hs, vs, tabs)


def _read_into(t, buf, idx, out, occ, rows, tw, scan, first, predict=True):
    """TIFFReadEncodedStrip/Tile of `occ` bytes into `out` (a bytearray)
    with stoponerr off: a strip or tile that fails to decode is written
    as far as the codec went, zeros after it; one libtiff cannot read at
    all (TIFFFillStrip) is zeros, and fails the load where it is the
    first read of a buffer (`first`: the buffer is never made)."""
    try:
        got = _read_block(t, buf, idx, rows, tw, scan, predict)
    except OSError as err:
        if not isinstance(err.__cause__, _Broken):
            if first:
                raise
            got = b""
        else:
            got = err.__cause__.partial
    out[:occ] = bytes(got[:occ]).ljust(occ, b"\0")


def _load_rgba_separate(t, buf, img, tabs):
    """gtStripSeparate as Pillow's _decodeAsRGBA calls it, a strip at a
    time: the Y, Cb and Cr planes' strips read into one buffer
    (`_read_into`: the Y strip must be readable), converted sample by
    sample (putseparate8bitYCbCr11tile)."""
    th = t.th if 0 < t.th < 0xFFFFFFFF else t.h
    th = min(th, t.h)
    per_plane = (t.h + th - 1) // th
    for i, y in enumerate(range(0, t.h, th)):
        rows = min(th, t.h - y)
        occ = rows * t.w
        planes = []
        for k in range(3):
            out = bytearray(occ)
            _read_into(t, buf, i + k * per_plane, out, occ, rows, t.w, t.w,
                       first=k == 0)
            planes.append(np.frombuffer(bytes(out), np.uint8).reshape(
                rows, t.w))
        img.px[y : y + rows, :, :3] = ycbcr_to_rgb(*planes, tabs)


def _load_rgba_tiles(t, buf, img, tabs, sampling):
    """gtTileContig as Pillow's _decodeAsRGBA calls it, a row of tiles at
    a time: each tile read into the row's one buffer (`_read_into`: the
    row's first tile must be readable), its packed blocks converted
    (putcontig8bitYCbCr*tile) and clipped at the image's right edge."""
    hs, vs = sampling
    tw, th = t.tw, t.th
    if tw <= 0 or th <= 0:
        raise _broken()
    block_row = (tw + hs - 1) // hs * (hs * vs + 2)
    occ = (th + vs - 1) // vs * block_row  # TIFFTileSize
    rowsize = tw * 3  # TIFFTileRowSize, the predictor's row
    across = (t.w + tw - 1) // tw
    for r, y in enumerate(range(0, t.h, th)):
        rows = min(th, t.h - y)
        out = bytearray(occ)
        for c in range(across):
            x = c * tw
            whole = occ % rowsize == 0
            # PredictorDecodeTile fails on "occ0%rowsize != 0" after the
            # codec has written the tile, which then stays unsummed
            _read_into(t, buf, r * across + c, out, occ,
                       occ // rowsize if whole else 1, tw,
                       rowsize if whole else occ, c == 0, predict=whole)
            ww = min(tw, t.w - x)
            img.px[y : y + rows, x : x + ww, :3] = blocks_to_rgb(
                bytes(out), rows, tw, hs, vs, tabs)[:, :ww]


# -- read_image's contract -------------------------------------------------

def to_rgb(mode, arr, palette):
    """Pillow's ``convert("RGB")`` of a TIFF's loaded image."""
    from art_tpu_torch.io.stdformats import cmyk_to_rgb

    if mode == "1":
        grey = np.where(arr, 255, 0).astype(np.uint8)
    elif mode in ("L", "LA"):
        grey = arr if arr.ndim == 2 else arr[..., 0]
    elif mode in ("P", "PA"):
        idx = arr if arr.ndim == 2 else arr[..., 0]
        return palette[idx]
    elif mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(arr[..., :3])
    elif mode == "CMYK":
        return cmyk_to_rgb(arr)
    elif mode == "LAB":
        from art_tpu_torch.io.rasterformats import lab_to_rgb

        return lab_to_rgb(arr ^ np.array([0, 128, 128], np.uint8))
    elif mode == "F":
        g = np.where(arr >= 255.0, 255.0, np.where(arr > 0.0, arr, 0.0))
        grey = np.nan_to_num(g, nan=0.0).astype(np.uint8)
    else:  # I;16, I;16B, I
        grey = np.clip(arr, 0, 255).astype(np.uint8)
    return np.repeat(np.asarray(grey, np.uint8)[..., None], 3, axis=2)


def read(buf):
    """(mode, samples, icc) as ``imagefile.read_image`` gives them for a
    file opened by its path: Pillow's mode of one 16- or 32-bit sample
    ("I;16", "I;16B", "I", "F") with its samples, else "RGB" and the
    ``convert("RGB")``."""
    mode, arr, palette, icc = load(buf)
    if mode in ("I;16", "I;16B", "I", "F"):
        return mode, arr, icc
    return "RGB", to_rgb(mode, arr, palette), icc
