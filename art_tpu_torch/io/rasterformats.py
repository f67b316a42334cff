"""The loads of the simple raster formats Pillow 12.1.0 opens: DIB, ICO,
CUR, TGA, PSD, QOI, PCX, DCX and SGI, each as its plugin loads what its
open found, and the image's ``convert("RGB")``.

:mod:`art_tpu_torch.io.unported` mirrors the opens and decides, in the
order of Pillow's ``Image.ID``, which plugin opens a file; the reader
here then loads it. Each follows its plugin and decoder:

- DIB (``BmpImagePlugin.DibImageFile``): a bitmap with no file header,
  :func:`art_tpu_torch.io.stdformats.read_bitmap`.
- ICO (``IcoImagePlugin.IcoFile``): the entry the open loads (sorted by
  colour depth, then stably by area, largest first): a PNG icon through
  the port's PNG reader, a bitmap icon as a DIB of half its height (its
  AND mask or alpha only makes the alpha that ``convert("RGB")`` drops).
- CUR (``CurImagePlugin``): the entry whose width and height bytes both
  pass the chosen one's, a bitmap of half its height, no mask.
- TGA (``TgaImagePlugin``, ``TgaRleDecode.c``): image types 1/9, 2/10
  and 3/11 at the depths Pillow maps (8-bit indices, 1- and 8-bit grey,
  grey and alpha, 15-bit colour with its alpha bit, 24 and 32 bits); the
  colour map from its first index, of 16- or 24-bit entries (Pillow's
  load refuses 32-bit ones); the origin bits (bottom-up rows, a
  horizontal flip).
- PSD (``PsdImagePlugin``): the merged image after the colour mode data,
  the image resources (resource 1039, the ICC profile) and the layer
  section, raw or PackBits (``PackDecode.c``), one plane a channel, in
  modes 1, L, P (the colour mode data's planar palette), RGB, RGBA,
  CMYK (stored inverted) and LAB; channels past the mode's are dropped.
- QOI (``QoiImagePlugin.QoiDecoder``): RGB or RGBA as the header says.
- PCX (``PcxImagePlugin``, ``PcxDecode.c``): 1 bit, 2 and 4 bit planes
  with the header's 16 colours, 8-bit grey or the 256-colour palette at
  the file's end, 24-bit planes; the bounding box's size and the stride
  Pillow computes. DCX (``DcxImagePlugin``): frame 0's PCX.
- SGI (``SgiImagePlugin``, ``SgiRleDecode.c``): raw or RLE, 1 or 2
  bytes a sample (the high byte kept, as Pillow's ``L;16B`` and
  ``RGB;16B``), bottom-up rows.

The byte streams decode in ``io/native/rasterdec.cc``. Errors are
Pillow's load's: OSError (data that ends early, a decoder's overrun,
no tile), `PilValueError` (a palette of more than 256 entries, a raw mode
the image's mode has no unpacker for, a single-plane raw image that the
file, opened by name as the reference opens it, is too short to map),
`PilIndexError` (QOI's Python decoder reading past the file's end).
Raw tiles load through :func:`art_tpu_torch.io.rawtile.load_raw`. Every
reader takes (buf, path) and returns (mode, samples, icc) as
``imagefile.read_image`` does. The small raster plugins (FITS to FLI)
load in :mod:`art_tpu_torch.io.plugins`.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

from art_tpu_torch import hostbuild
from art_tpu_torch.io.rawtile import (grey3, load_raw, new, put, rgb_out,
                                      truncated)
from art_tpu_torch.io.stdformats import (GREY_PALETTE, PilIndexError,
                                         PilValueError, read_bitmap)
from art_tpu_torch.io import unported
from art_tpu_torch.io.unported import _File

_LIB = None
_LIB_LOCK = threading.Lock()
_P = ctypes.c_void_p
_SZ = ctypes.c_size_t
_I64 = ctypes.c_int64


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = hostbuild.load("rasterdec")
            for name, args in (
                    ("tga_rle", [_P, _SZ, ctypes.c_int, _SZ, _I64, _P,
                                 ctypes.POINTER(_I64)]),
                    ("pcx", [_P, _SZ, ctypes.c_int, _I64, _SZ, _I64, _P,
                             ctypes.POINTER(_I64)]),
                    ("packbits", [_P, _SZ, _SZ, _I64, _P,
                                  ctypes.POINTER(_SZ)]),
                    ("sgi_rle", [_P, _SZ, _I64, _I64, ctypes.c_int,
                                 ctypes.c_int, _P]),
                    ("qoi", [_P, _SZ, _I64, ctypes.c_int, _P]),
                    ("sun_rle", [_P, _SZ, _SZ, _I64, _P]),
                    ("xbm", [_P, _SZ, _SZ, _I64, _P]),
                    ("pcd", [_P, _SZ, _P]),
                    ("bcn", [ctypes.c_int, ctypes.c_int, _P, _SZ, _I64,
                             _I64, _P]),
                    ("bitdec", [_P, _SZ, ctypes.c_int, _I64, _I64, _P])):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = args
            lib.fli.restype = _I64
            lib.fli.argtypes = [_P, _I64, ctypes.c_int, ctypes.c_int, _P,
                                ctypes.POINTER(ctypes.c_int)]
            lib.blp_dxt.restype = None
            lib.blp_dxt.argtypes = [ctypes.c_int, ctypes.c_int, _P, _I64, _I64,
                                    _P]
            lib.clut8.restype = None
            lib.clut8.argtypes = [_P, _I64, _P, _P, ctypes.c_int, _P]
            for name in ("ycc_to_rgb", "ycbcr_to_rgb"):
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [_P, _I64, _P]
            _LIB = lib
        return _LIB


def _ptr(a):
    return a.ctypes.data_as(_P)


def _data(buf, at):
    """The bytes from `at` to the file's end, as a uint8 array."""
    return np.frombuffer(buf, np.uint8)[at:]


def _overrun():
    return OSError("buffer overrun when reading image file")


def _no_tile():
    return OSError("cannot load this image")


# -- unpacking and Pillow's convert("RGB") -----------------------------------

def _bits_msb(rows, width):
    """Packed rows of 1-bit pixels, most significant first -> (h, width)
    0/1."""
    return np.unpackbits(rows, axis=1)[:, :width]


def palette_rgb(raw, stride=3, planar=False, order="RGB"):
    """A palette's (256, 3) uint8 RGB from its raw bytes as Pillow's
    ``putpalette`` reads them: entries of `stride` bytes in `order` (RGB,
    BGR, or "BGR;15" for 16-bit little-endian 5-5-5), or three planes of
    256 (``RGB;L``); entries past the bytes black. PilValueError where
    they hold more than 256 entries."""
    pal = np.zeros((256, 3), np.uint8)
    if planar:
        v = np.frombuffer(bytes(raw[:768]), np.uint8)
        n = len(v) // 3
        for k in range(3):
            pal[:n, k] = v[k * n : (k + 1) * n][:n]
        return pal
    n = len(raw) // stride
    if n > 256:
        raise PilValueError("invalid palette size")
    ent = np.frombuffer(bytes(raw[: n * stride]), np.uint8).reshape(n, stride)
    if order == "BGR;15":
        v = ent[:, 0].astype(np.int32) | ent[:, 1].astype(np.int32) << 8
        pal[:n] = np.stack([((v >> 10) & 31) * 255 // 31,
                            ((v >> 5) & 31) * 255 // 31,
                            (v & 31) * 255 // 31], -1)
    elif order == "BGR":
        pal[:n] = ent[:, 2::-1]
    else:
        pal[:n] = ent[:, :3]
    return pal


def clut8(rgb8, tables, clut):
    """LittleCMS's 8-bit evaluation of the (n, n, n, 3) 16-bit CLUT
    `clut` on (..., 3) uint8 samples, each byte's nodes and rest from
    `tables` ((3, 3, 256): per channel the base nodes, upper nodes and
    rests), and From16To8 (``io/native/rasterdec.cc::clut8``)."""
    src = np.ascontiguousarray(rgb8, np.uint8)
    out = np.empty_like(src)
    tab = np.ascontiguousarray(tables, np.int32)
    lut = np.ascontiguousarray(clut, np.uint16)
    _lib().clut8(_ptr(src), src.size // 3, _ptr(tab), _ptr(lut),
                 lut.shape[0], _ptr(out))
    return out


def lab_to_rgb(lab):
    """Pillow's ``convert("RGB")`` of (..., 3) uint8 "LAB" samples
    (LittleCMS's transform, :func:`art_tpu_torch.color.lcms.
    lab_to_srgb_clut`), bit for bit."""
    from art_tpu_torch.color.lcms import byte_tables, lab_to_srgb_clut

    return clut8(lab, byte_tables(), lab_to_srgb_clut())


# -- DIB, ICO, CUR -----------------------------------------------------------

def read_dib(buf, path):
    return (*read_bitmap(buf, 0), None)


def read_ico(buf, path):
    from art_tpu_torch.io import imagefile

    offset = unported.ico_entry(_File(buf))[2]
    if bytes(buf[offset : offset + 8]) == b"\x89PNG\r\n\x1a\n":
        samples, depth, ctype, plte, _ = imagefile._read_png(buf[offset:])
        if ctype == 0 and depth == 16:
            return "I;16", samples[..., 0], None
        return "RGB", imagefile._png_rgb8(samples, depth, ctype, plte), None
    return (*read_bitmap(buf, offset, rows=lambda h: int(h / 2)), None)


def read_cur(buf, path, indices=False):
    f = _File(buf)
    at = struct.unpack_from("<I", unported.cur_entry(f), 12)[0] or f.tell()
    return (*read_bitmap(buf, at, rows=lambda h: h // 2, indices=indices),
            None)


# -- TGA ---------------------------------------------------------------------

# (image type & 7, depth) -> (raw mode, bits a pixel)
_TGA_RAW = {(1, 8): ("P", 8), (3, 1): ("1", 1), (3, 8): ("L", 8),
            (3, 16): ("LA", 16), (2, 16): ("BGRA;15Z", 16),
            (2, 24): ("BGR", 24), (2, 32): ("BGRA", 32)}


def read_tga(buf, path, indices=False):
    """A TGA as Pillow opens and converts it; `indices`: a palette
    image's indices in each channel."""
    f = _File(buf)
    mode, (w, h) = unported._tga(f)  # the file left at the image data
    at = f.tell()
    id_len, cmap, itype, depth, flags = buf[0], buf[1], buf[2], buf[16], \
        buf[17]
    orient = flags & 0x30
    top = orient in (0x20, 0x30)
    pal = None
    if cmap:
        start, mapdepth = struct.unpack_from("<H", buf, 3)[0], buf[7]
        k = mapdepth // 8
        raw = bytes(k * start) + bytes(buf[min(18 + id_len, len(buf)) : at])
        if k == 4:  # "BGRA" into an RGB palette: no such unpacker
            pal = PilValueError("unrecognized raw mode")
        elif len(raw) // k > 256:
            pal = PilValueError("invalid palette size")
        else:
            pal = palette_rgb(raw, k, order="BGR;15" if k == 2 else "BGR")
    key = (itype & 7, depth)
    if key not in _TGA_RAW:
        raise _no_tile()
    rawmode, bits = _TGA_RAW[key]
    if rawmode == "P" and mode == "L":
        raise PilValueError("unknown raw mode for given image mode")
    if mode == "P" and isinstance(pal, Exception):  # set before the tile
        raise pal  # decodes (a mapped file's errors are ValueErrors too)
    if itype & 8:
        row_bytes = (w * bits + 7) // 8
        rows = np.zeros((h, row_bytes), np.uint8)
        done = _I64(0)
        data = _data(buf, at)
        rc = _lib().tga_rle(_ptr(data), data.size, depth // 8, row_bytes, h,
                            _ptr(rows), ctypes.byref(done))
        if rc == 1:
            raise truncated()
        if rc == 2:
            raise _overrun()
        img = new(mode, w, h)
        put(img, slice(None) if top else slice(None, None, -1), mode,
            rawmode, rows, w)
    else:
        img = load_raw(buf, path, mode, (w, h),
                       [(at, (rawmode, 0, 1 if top else -1))])
    if cmap and mode not in ("P", "L", "LA"):
        raise PilValueError("unrecognized image mode")
    if isinstance(pal, Exception):
        raise pal
    if cmap:  # a colour map turns L and LA to P and PA
        mode = {"L": "P", "LA": "PA"}.get(mode, mode)
    rgb = rgb_out(mode, img, GREY_PALETTE if indices else pal)[1]
    if orient in (0x10, 0x30):
        rgb = rgb[:, ::-1]
    return "RGB", np.ascontiguousarray(rgb), None


# -- PSD ---------------------------------------------------------------------

_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
              (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
              (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def read_psd(buf, path, indices=False):
    hd = unported.psd_header(_File(buf))
    mode, channels, comp = hd["mode"], hd["channels"], hd["comp"]
    w, h = hd["size"]
    icc = hd["icc"]
    palette = None if hd["palette"] is None else GREY_PALETTE if indices \
        else palette_rgb(hd["palette"], planar=True)
    at = hd["offset"]
    layers = [c + ";I" if mode == "CMYK" else c for c in mode[:channels]]
    if comp == 0:
        img = load_raw(buf, path, mode, (w, h),
                       [(at + c * w * h, layer)
                        for c, layer in enumerate(layers)])
    elif comp == 1:
        counts = hd["counts"]
        lib = _lib()
        img = new(mode, w, h)
        row_bytes = (w + 7) // 8 if mode == "1" else w
        for c, layer in enumerate(layers):
            data = _data(buf, at)
            plane = np.empty((h, row_bytes), np.uint8)
            used = _SZ(0)
            if lib.packbits(_ptr(data), data.size, row_bytes, h,
                            _ptr(plane), ctypes.byref(used)):
                raise truncated()
            put(img, slice(None), mode, layer, plane, w)
            at += sum(counts[c * h : (c + 1) * h])
    else:
        raise _no_tile()
    if mode == "LAB":
        return "RGB", lab_to_rgb(img), icc
    return (*rgb_out(mode, img, palette), icc)


# -- QOI ---------------------------------------------------------------------

def read_qoi(buf, path):
    w, h = struct.unpack_from(">II", buf, 4)
    bands = 3 if buf[12] == 3 else 4
    data = _data(buf, 14)
    out = np.zeros((h, w, bands), np.uint8)
    rc = _lib().qoi(_ptr(data), data.size, w * h, bands, _ptr(out))
    if rc == 1:
        raise PilIndexError("index out of range")
    if rc == 3:
        raise PilValueError("not enough values to unpack")
    return "RGB", np.ascontiguousarray(out[..., :3]), None


# -- PCX, DCX ----------------------------------------------------------------

def _read_pcx(buf, at, indices=False):
    f = _File(buf)
    f.seek(at)
    mode, (w, h) = unported._pcx(f)  # the mode decided as the open does
    s = bytes(buf[at : at + 68])
    bits, planes = s[3], s[65]
    given = struct.unpack_from("<H", s, 66)[0]
    pal = None
    if mode == "1":
        rawmode, pbits = "1", 1
    elif mode == "P" and bits == 1:  # bit planes, the header's 16 colours
        rawmode, pbits = f"P;{planes}L", planes
        pal = palette_rgb(s[16:64])
    elif mode in ("L", "P"):  # P: the 256 colours at the file's end
        rawmode, pbits = "L", 8
        if mode == "P":
            pal = palette_rgb(bytes(buf[-768:]))
    else:
        rawmode, pbits = "RGB;L", 24
    stride = (w * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    line = planes * stride
    rows = np.zeros((h, line), np.uint8)
    data = _data(buf, at + 128)
    done = _I64(0)
    rc = _lib().pcx(_ptr(data), data.size, pbits, w, line, h, _ptr(rows),
                    ctypes.byref(done))
    if indices and pal is not None:
        pal = GREY_PALETTE
    if rc == 1:
        raise truncated()
    if rc == 2:
        raise _overrun()
    if rawmode == "1":
        return "RGB", grey3(_bits_msb(rows, w) * 255)
    if rawmode.startswith("P;"):
        s8 = (w + 7) // 8
        idx = np.zeros((h, w), np.uint8)
        for p in range(planes):
            idx |= (_bits_msb(rows[:, p * s8 : (p + 1) * s8], w)
                    << p).astype(np.uint8)
        return "RGB", pal[idx]
    if rawmode == "L":
        px = rows[:, :w]
        return "RGB", pal[px] if pal is not None else grey3(px)
    return "RGB", np.ascontiguousarray(np.stack(
        [rows[:, k * w : (k + 1) * w] for k in range(3)], -1))


def read_pcx(buf, path, indices=False):
    """A PCX as Pillow opens and converts it; `indices`: a palette
    image's indices in each channel."""
    return (*_read_pcx(buf, 0, indices), None)


def read_dcx(buf, path, indices=False):
    return (*_read_pcx(buf, struct.unpack_from("<I", buf, 4)[0], indices),
            None)


# -- SGI ---------------------------------------------------------------------

def read_sgi(buf, path):
    from art_tpu_torch.io.unported import _SGI_MODES

    comp, bpc = buf[2], buf[3]
    dim, w, h, z = struct.unpack_from(">4H", buf, 4)
    mode = _SGI_MODES[(bpc, dim, z)]
    bands = len(mode)
    if comp == 0 and bpc == 1:
        img = load_raw(buf, path, mode, (w, h),
                       [(512 + b * w * h, (layer, 0, -1))
                        for b, layer in enumerate(mode)])
        return (*rgb_out(mode, img), None)
    if comp == 0:
        planes = []
        at = 512
        for b in range(bands):
            got = bytes(buf[at : at + 2 * w * h])
            at += len(got)
            if len(got) < 2 * w * h:
                raise PilValueError("not enough image data")
            planes.append(np.frombuffer(got, np.uint8)[0::2].reshape(
                h, w)[::-1])
        px = np.stack(planes, -1)
    elif comp == 1:
        img = np.zeros((h, w * bands * bpc), np.uint8)
        data = np.frombuffer(bytes(buf), np.uint8)
        if _lib().sgi_rle(_ptr(data), data.size, w, h, bands, bpc,
                          _ptr(img)):
            raise _overrun()
        px = img.reshape(h, w, bands, bpc)[..., 0]
    else:
        raise _no_tile()
    if bands == 1:
        return "RGB", grey3(px[..., 0]), None
    return "RGB", np.ascontiguousarray(px[..., :3]), None
