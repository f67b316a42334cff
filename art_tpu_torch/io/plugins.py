"""The loads of the small raster plugins Pillow 12.1.0 opens: FITS, PFM,
the PNM extensions, SPIDER, McIdas, IMT, IM, SUN, MSP, XVThumb, PIXAR,
GBR, XBM, XPM, FTEX, IPTC/NAA, PCD and FLI, each as its plugin loads
what its open found.

:mod:`art_tpu_torch.io.unported` mirrors the opens (each leaves its tile
and header state in the file's ``tile``) and decides, in the order of
Pillow's ``Image.ID``, which plugin opens a file; the reader here then
loads it as ``ImageFile.load`` does (raw tiles through
:func:`art_tpu_torch.io.rawtile.load_raw`, other tiles through their
decoder fed from the tile's offset), and sets a palette last (ValueError
for more than 256 entries, or on an image that has no palette). Each
follows its plugin:

- FITS (``FitsImagePlugin``): BITPIX 8, 16, 32, -32 and -64 as L, I;16,
  I and F, the samples read with the raw mode equal to the mode on rows
  stored bottom-up, so big-endian data reads as little-endian and
  BITPIX -64 as pairs of float32; the GZIP_1 tiled form keeps the last
  ``min(bits // 8, 4)`` bytes of each 4-byte word (no byte for a float
  image, which then fails).
- PFM and the PNM extensions (``PpmImagePlugin``): F from ``F;32F`` or
  ``F;32BF`` by the scale's sign, bottom-up; P0CMYK, PyP, PyRGBA and
  PyCMYK raw at maxval 255, else rescaled by ``PpmDecoder``.
- SPIDER (F, ``F;32F`` or ``F;32BF``), McIdas (L, I;16B, or ``I;32B``
  into I, with the header's stride), IMT (L).
- IM (``ImImagePlugin.OPEN``): line-interleaved ``;L`` forms, ``RGB;T``
  planes (green first), ``P;2``/``P;4``, ``F;n`` through the bit decoder,
  the Lut as an ``RGB;L`` palette where it is no grey ramp.
- SUN (raw with its 16-bit row padding, or ``sun_rle``), MSP (v1 raw, v2
  ``MspDecoder``), XVThumb (P, the 3-3-2 palette), PIXAR (RGB), GBR (L
  or RGBA through ``frombytes``).
- XBM (``XbmDecode.c``), XPM (``XpmDecoder``: P up to 256 colours, RGB
  above; a pixel of the ``None`` colour or of no colour fails).
- FTEX (raw RGB, or BC1 through ``BcnDecode.c`` (``bcn``) into RGBA).
  The texture and icon formats (BLP, DDS, ICNS) load in
  :mod:`art_tpu_torch.io.textures`, JPEG 2000 in
  :mod:`art_tpu_torch.io.jpeg2000`; AVIF is refused by name
  (:mod:`art_tpu_torch.io.unported`).
- IPTC/NAA: the 8:10 records joined (behind a P5 header where raw, as
  they are otherwise, a JPEG in practice) and opened again (here the
  port's own decode); where the file names a band, the image must be L
  (Pillow's ``Image.merge``: else "mode mismatch") and is that band of an
  RGB or CMYK image whose other bands are black.
- PCD (``PcdDecode.c``): the 768 x 512 base image, rotated by 90 or 270
  degrees for orientation 1 or 3.
- FLI/FLC (``FliDecode.c``): frame 0, fed one frame size at a time.

The byte streams decode in ``io/native/rasterdec.cc``. Every reader
takes (buf, path) and returns (mode, samples, icc) as
``imagefile.read_image`` does: "RGB" with the image's ``convert("RGB")``,
or Pillow's mode for I;16, I;16B, I;16L (uint16), I (int32), F (float32)
and YCbCr ((H, W, 3) uint8, which ``imagefile.to_rgb8`` converts as
Pillow does). `path` None reads the bytes as Pillow reads a stream (no
mapping).
"""

from __future__ import annotations

import ctypes
import gzip
import struct

import numpy as np

from art_tpu_torch.io import unported
from art_tpu_torch.io.rasterformats import _lib, _ptr, palette_rgb
from art_tpu_torch.io.rawtile import (_BANDS, decoder_error, load_raw, new,
                                      put, raw, rgb_out, seek, truncated,
                                      unpacker)
from art_tpu_torch.io.stdformats import PilValueError, Unidentified
from art_tpu_torch.io.unported import _File


def _set_as_raw(img, data, mode, rawmode=None):
    """``PyDecoder.set_as_raw``: `data` through the raw decoder, top-down;
    ValueError where it holds too few bytes."""
    data = np.frombuffer(bytes(data), np.uint8)
    try:
        raw(img, data, mode, rawmode or mode)
    except OSError as e:
        raise PilValueError("not enough image data") from e
    return img


def _pal(data, planar=False):
    """``putpalette`` of a palette of RGB (or ``RGB;L``) bytes: ValueError
    where they hold more than 256 entries."""
    if len(data) // 3 > 256:
        raise PilValueError("invalid palette size")
    return palette_rgb(data, planar=planar)


def ycbcr_to_rgb(ycc):
    """Pillow's ``convert("RGB")`` of (..., 3) uint8 YCbCr samples, bit for
    bit."""
    src = np.ascontiguousarray(ycc, np.uint8)
    out = np.empty_like(src)
    _lib().ycbcr_to_rgb(_ptr(src), src.size // 3, _ptr(out))
    return out


def _open(opener, buf, path):
    f = _File(buf, path)
    mode, size = opener(f)
    return f, mode, size


# -- FITS --------------------------------------------------------------------

def read_fits(buf, path):
    f, mode, size = _open(unported._fits, buf, path)
    decoder, offset, args = f.tile
    if decoder == "raw":
        return (*rgb_out(mode, load_raw(buf, path, mode, size,
                                      [(offset, args)])), None)
    # FitsGzipDecoder: the heap inflated, the last bytes of each word
    data = seek(buf, path, offset)
    w, h = size
    img = new(mode, w, h)
    value = gzip.decompress(data.tobytes())
    n = min(args[0] // 8, 4)
    if n <= 0 or len(value) < 4 * w * h:
        raise PilValueError("not enough image data")
    words = np.frombuffer(value[: 4 * w * h], np.uint8).reshape(h, w, 4)
    rows = np.ascontiguousarray(words[::-1, :, 4 - n :]).reshape(h, w * n)
    put(img, slice(None), mode, mode, rows, w)
    return (*rgb_out(mode, img), None)


# -- PFM and the PNM extensions -----------------------------------------------

def read_ppm(buf, path):
    f, mode, size = _open(unported._ppm, buf, path)
    offset, value = f.tile
    if mode == "F":
        rawmode = "F;32F" if value < 0 else "F;32BF"
        img = load_raw(buf, path, mode, size, [(offset, (rawmode, 0, -1))])
        return (*rgb_out(mode, img), None)
    if value == 255:
        img = load_raw(buf, path, mode, size, [(offset, mode)])
        return (*rgb_out(mode, img), None)
    # PpmDecoder: each sample rescaled to 0..255
    w, h = size
    img = new(mode, w, h)
    data = seek(buf, path, offset)
    bands = _BANDS[mode]
    size_in = 1 if value < 256 else 2
    k = min(len(data) // (size_in * bands), w * h) * bands
    vals = data[: k * size_in].view(np.uint8 if size_in == 1 else ">u2")
    vals = np.minimum(255, np.round(vals / value * 255)).astype(np.uint8)
    return (*rgb_out(mode, _set_as_raw(img, vals, mode)), None)


# -- SPIDER, McIdas, IMT -----------------------------------------------------

def read_spider(buf, path):
    f, mode, size = _open(unported._spider, buf, path)
    offset, big = f.tile
    img = load_raw(buf, path, mode, size,
                    [(offset, "F;32BF" if big else "F;32F")])
    return (*rgb_out(mode, img), None)


def read_mcidas(buf, path):
    f, mode, size = _open(unported._mcidas, buf, path)
    w = f.tile
    rawmode = {1: "L", 2: "I;16B", 4: "I;32B"}[w[11]]
    args = (rawmode, w[15] + w[10] * w[11] * w[14], 1)
    img = load_raw(buf, path, mode, size, [(w[34] + w[15], args)])
    return (*rgb_out(mode, img), None)


def read_imt(buf, path):
    f, mode, size = _open(unported._imt, buf, path)
    if f.tile is None:
        raise OSError("cannot load this image")
    return (*rgb_out(mode, load_raw(buf, path, mode, size,
                                  [(f.tile, mode)])), None)


# -- IM ----------------------------------------------------------------------

def read_im(buf, path):
    f, mode, size = _open(unported._im, buf, path)
    rawmode, offs, lut = f.tile
    new(mode, 1, 1)
    w, h = size
    if not (isinstance(w, int) and isinstance(h, int)):
        raise unported.OpenError("IM: TypeError: a size of floats")
    pal = None
    if lut is not None:
        pal = _pal(lut, planar=True)
    bits = None
    if rawmode.startswith("F;"):
        try:
            bits = int(rawmode[2:])
        except ValueError:
            pass
    if bits is not None and bits not in (8, 16, 32):
        img = new(mode, w, h)
        if mode != "F":
            raise PilValueError("bad image mode")
        data = seek(buf, path, offs)
        out = np.zeros((h, w), np.float32)
        rc = _lib().bitdec(_ptr(data), data.size, bits, w, h, _ptr(out))
        if rc == 1:
            raise truncated()
        if rc == 2:
            raise decoder_error(-8)
        img[...] = out
    elif rawmode in ("RGB;T", "RYB;T"):
        n = w * h
        img = load_raw(buf, path, mode, size, [
            (offs, ("G", 0, -1)), (offs + n, ("R", 0, -1)),
            (offs + 2 * n, ("B", 0, -1))])
    else:
        img = load_raw(buf, path, mode, size, [(offs, (rawmode, 0, -1))])
    return (*rgb_out(mode, img, pal), None)


# -- SUN, MSP, XVThumb, PIXAR, GBR -------------------------------------------

def read_sun(buf, path):
    f, mode, size = _open(unported._sun, buf, path)
    rawmode, offset, stride, rle, palette = f.tile
    w, h = size
    pal = None
    if mode == "P":  # ImageFile.load_prepare sets a P image's palette
        pal = _pal(palette, planar=True)  # before its tile decodes
    if rle:
        img = new(mode, w, h)
        data = seek(buf, path, offset)
        bits, _ = unpacker(mode, rawmode)
        row = (w * bits + 7) // 8
        rows = np.zeros((h, row), np.uint8)
        if _lib().sun_rle(_ptr(data), data.size, row, h, _ptr(rows)):
            raise truncated()
        put(img, slice(None), mode, rawmode, rows, w)
    else:
        img = load_raw(buf, path, mode, size, [(offset, (rawmode, stride))])
    if palette is not None and mode != "P":  # Image.load sets it last
        raise PilValueError("illegal image mode")  # on 1 or RGB
    return (*rgb_out(mode, img, pal), None)


def read_msp(buf, path):
    f, mode, size = _open(unported._msp, buf, path)
    if bytes(buf[:4]) == b"DanM":
        return (*rgb_out(mode, load_raw(buf, path, mode, size, [(32, "1")])),
                None)
    # MspDecoder: a row map, then each row's runs
    w, h = size
    img = new(mode, w, h)
    blank = b"\xff" * ((w + 7) // 8)
    rowmap = bytes(buf[32 : 32 + 2 * h])
    if len(rowmap) < 2 * h:
        raise OSError("Truncated MSP file in row map")
    pos = 32 + 2 * h
    out = bytearray()
    for y, n in enumerate(struct.unpack(f"<{h}H", rowmap)):
        if n == 0:
            out += blank
            continue
        row = bytes(buf[pos : pos + n])
        pos += len(row)
        if len(row) != n:
            raise OSError(f"Truncated MSP file, expected {n} bytes on row "
                          f"{y}")
        i = 0
        while i < n:
            t = row[i]
            i += 1
            if t == 0:
                if n - i < 2:
                    raise OSError(f"Corrupted MSP file in row {y}")
                out += row[i + 1 : i + 2] * row[i]
                i += 2
            else:
                out += row[i : i + t]
                i += t
    return (*rgb_out(mode, _set_as_raw(img, out, mode)), None)


_XV_PALETTE = np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3)
                        for r in range(8) for g in range(8)
                        for b in range(4)], np.uint8)


def read_xvthumb(buf, path):
    f, mode, size = _open(unported._xvthumb, buf, path)
    img = load_raw(buf, path, mode, size, [(f.tile, mode)])
    return (*rgb_out(mode, img, _XV_PALETTE), None)


def read_pixar(buf, path):
    _, mode, size = _open(unported._pixar, buf, path)
    return (*rgb_out(mode, load_raw(buf, path, mode, size, [(1024, mode)])),
            None)


def read_gbr(buf, path):
    f, mode, size = _open(unported._gbr, buf, path)
    w, h = size
    img = new(mode, w, h)
    data = bytes(buf[f.tile : f.tile + w * h * _BANDS[mode]])
    return (*rgb_out(mode, _set_as_raw(img, data, mode)), None)


# -- XBM, XPM ----------------------------------------------------------------

def read_xbm(buf, path):
    f, mode, size = _open(unported._xbm, buf, path)
    w, h = size
    data = seek(buf, path, f.tile)
    row = (w + 7) // 8
    rows = np.zeros((h, row), np.uint8)
    if _lib().xbm(_ptr(data), data.size, row, h, _ptr(rows)):
        raise truncated()
    img = new(mode, w, h)
    put(img, slice(None), mode, "1;R", rows, w)
    return (*rgb_out(mode, img), None)


def read_xpm(buf, path):
    f, mode, size = _open(unported._xpm, buf, path)
    bpp, palette, offset = f.tile
    w, h = size
    img = new(mode, w, h)
    keys = tuple(palette)
    index = {k: i for i, k in reversed(list(enumerate(keys)))}
    dest = w * h * (3 if mode == "RGB" else 1)
    data = bytearray()
    lines = [ln + b"\n" for ln in bytes(buf[offset:]).split(b"\n")]
    lines[-1] = lines[-1][:-1]  # readline's lines: each ends at "\n"
    if not lines[-1]:
        lines.pop()
    header = False
    for line in lines:
        if len(data) >= dest:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        if bpp == 0 and line:
            raise PilValueError("range() arg 3 must not be zero")
        for i in range(0, len(line), bpp):
            key = line[i : i + bpp]
            if mode == "RGB":
                if key not in palette:
                    raise unported.OpenError(f"XPM: KeyError: {key!r}")
                data += palette[key]
            else:
                if key not in index:
                    raise PilValueError("tuple.index(x): x not in tuple")
                data.append(index[key])
    _set_as_raw(img, data, mode)
    pal = _pal(b"".join(palette.values())) if mode == "P" else None
    return (*rgb_out(mode, img, pal), None)


# -- FTEX --------------------------------------------------------------------

def read_ftex(buf, path):
    f, mode, size = _open(unported._ftex, buf, path)
    fmt, data = f.tile
    w, h = size
    if fmt == 1:
        return (*rgb_out(mode, load_raw(data, None, mode, size, [(0, "RGB")])),
                None)
    src = np.frombuffer(data, np.uint8)
    img = np.zeros((h, w, 4), np.uint8)
    if _lib().bcn(1, 0, _ptr(src), src.size, w, h, _ptr(img)):
        raise truncated()
    return (*rgb_out(mode, img), None)


# -- IPTC/NAA ----------------------------------------------------------------

def read_iptc(buf, path):
    from art_tpu_torch.io import imagefile

    f, mode, size = _open(unported._iptc, buf, path)
    if f.tile is None:
        raise OSError("cannot load this image")
    offset, compression, info = f.tile
    out = bytearray(b"P5\n%d %d\n255\n" % size if compression == 1
                    else b"")
    f.seek(offset)
    while True:  # the 8:10 records, joined
        try:
            tag, n = unported.iptc_field(f)
        except Unidentified as e:  # the load's OSError: no loader after it
            raise OSError(str(e)) from e
        if tag != (8, 10):
            break
        out += f.read(n)
    if mode == "L":
        return imagefile._decode(bytes(out), None)
    # Image.open of the records, the band list, then Image.merge
    band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    data = bytes(out)
    bands = _BANDS[mode]
    if compression == 1:
        inner = "L"
    else:
        inner = _inner_mode(data)
    if not -bands <= band < bands:
        raise IndexError("list assignment index out of range")
    if inner not in ("L", None):
        raise PilValueError("mode mismatch")
    if inner == "L" and data[:3] == b"\xff\xd8\xff":
        from art_tpu_torch.io import jpegdec

        grey = jpegdec.decode(data)  # the merge loads the band
    else:
        _, samples, _ = imagefile._decode(data, None)  # Pillow's L band
        grey = samples[..., 0]
    px = np.zeros(grey.shape[:2] + (bands,), np.uint8)
    px[..., band] = grey
    return (*rgb_out(mode, px), None)


def _inner_mode(data):
    """Pillow's mode of the image an IPTC file's records hold: a JPEG's,
    a PNG's ("L" for 8-bit grey), a PNM's or a TIFF's; None for another
    format, whose decode's first channel is then taken as its L."""
    from art_tpu_torch.io import jpegdec, stdformats, tiff

    if data[:3] == b"\xff\xd8\xff":
        return jpegdec.pil_header(data).mode
    if data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) >= 26:
        return "L" if data[24:26] == b"\x08\x00" else "other"
    magic = stdformats.pnm_magic(data)[0]
    if magic in (b"P2", b"P5"):
        return "L"  # "I" above 255 levels: the decode's clip reads it
    if magic in (b"P1", b"P3", b"P4", b"P6"):
        return "other"
    if data[:4] in (b"II\x2a\x00", b"MM\x00\x2a", b"II\x2b\x00",
                    b"MM\x00\x2b"):
        return tiff.open_tiff(data).mode
    return None


# -- PCD ---------------------------------------------------------------------

def read_pcd(buf, path):
    f, mode, size = _open(unported._pcd, buf, path)
    data = seek(buf, path, 96 * 2048)
    img = np.zeros((512, 768, 3), np.uint8)
    if _lib().pcd(_ptr(data), data.size, _ptr(img)):
        raise truncated()
    if f.tile == 1:  # Image.rotate(90, expand=True): a transpose
        img = np.rot90(img, 1)
    elif f.tile == 3:
        img = np.rot90(img, -1)
    return "RGB", np.ascontiguousarray(img), None


# -- FLI ---------------------------------------------------------------------

def read_fli(buf, path):
    f, mode, size = _open(unported._fli, buf, path)
    palette, block = f.tile
    w, h = size
    img = np.zeros((h, w), np.uint8)
    data = seek(buf, path, 128)
    if block == 0:
        raise truncated()
    lib = _lib()
    b = np.zeros(0, np.uint8)
    pos = 0
    err = ctypes.c_int(0)
    while True:
        s = data[pos : pos + block]
        pos += len(s)
        if not len(s):
            raise truncated(len(b))
        b = np.concatenate([b, s])
        n = lib.fli(_ptr(b), b.size, w, h, _ptr(img), ctypes.byref(err))
        if n < 0:
            break
        b = b[n:]
    if err.value < 0:
        raise decoder_error(err.value)
    return "RGB", np.array(palette, np.uint8)[img], None
