"""Pillow 12.1.0's ``ImageFile.load`` of raw tiles, shared by the readers
of :mod:`art_tpu_torch.io.rasterformats` and :mod:`art_tpu_torch.io.plugins`.

A lone raw tile of a file opened by name is mapped where its raw mode is
the image's and one of Pillow's mapped modes (a file too short to map
raises ValueError); other tiles go through the raw decoder fed from the
tile's offset (a file that ends first raises "image file is truncated",
an OSError; a decoder's error code an OSError once the image is done).
Images are numpy arrays in Pillow's layout: (H, W) for one band, (H, W,
bands) else; :func:`rgb_out` turns one into what
``imagefile.read_image`` returns.
"""

from __future__ import annotations

import numpy as np

from art_tpu_torch.io import unported
from art_tpu_torch.io.stdformats import PilValueError, cmyk_to_rgb

_MAPMODES = ("L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B")
# the modes the loads make, and their bands
_BANDS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "I;16L": 1, "I;16B": 1,
          "I": 1, "F": 1, "LA": 2, "PA": 2, "RGB": 3, "YCbCr": 3,
          "LAB": 3, "RGBA": 4, "CMYK": 4}


def truncated(n=0):
    return OSError(f"image file is truncated ({n} bytes not processed)")


_ERRORS = {-1: "image buffer overrun error", -2: "decoding error",
           -3: "unknown error", -8: "bad configuration"}


def decoder_error(code):
    return OSError(f"{_ERRORS.get(code, f'decoder error {code}')} when "
                   "reading image file")


def seek(buf, path, offset):
    """The load's seek to a tile: a file refuses a negative offset
    (EINVAL), a stream raises ValueError."""
    if offset < 0:
        if path is None:
            raise PilValueError(f"negative seek value {offset}")
        raise OSError("[Errno 22] Invalid argument")
    return np.frombuffer(buf, np.uint8)[offset:]


def new(mode, w, h):
    """``Image.core.new``: zeros in the mode's layout (ValueError for a
    mode no plugin's load makes: Pillow's for a mode it does not know,
    or for one it has no raw decoder into)."""
    if mode not in _BANDS:
        raise PilValueError("unrecognized image mode")
    dtype = {"I;16": np.uint16, "I;16L": np.uint16, "I;16B": np.uint16,
             "I": np.int32, "F": np.float32}.get(mode, np.uint8)
    b = _BANDS[mode]
    return np.zeros((h, w) if b == 1 else (h, w, b), dtype)


# -- Pillow's unpackers: (mode, raw mode) -> (bits a pixel, unpack) ---------

def _bits(rows, w, bits, lsb=False):
    """Packed rows of `bits`-bit samples, most significant first (or
    least, `lsb`), -> (n, w) uint8."""
    u = np.unpackbits(rows, axis=1, bitorder="little" if lsb else "big")
    u = u[:, : w * bits].reshape(len(rows), w, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (u * weights).sum(-1).astype(np.uint8)


def _num(rows, w, dtype):
    return np.ascontiguousarray(rows[:, : w * np.dtype(dtype).itemsize]) \
        .view(dtype).reshape(len(rows), w)


def _bgra15z(rows, w):
    """``ImagingUnpackBGRA15Z``: 5-5-5 little-endian, the top bit an
    inverted alpha."""
    v = _num(rows, w, "<u2").astype(np.int32)
    return np.stack([((v >> 10) & 31) * 255 // 31,
                     ((v >> 5) & 31) * 255 // 31,
                     (v & 31) * 255 // 31,
                     255 - (v >> 15) * 255], -1).astype(np.uint8)


_UNPACK = {
    ("1", "1"): (1, lambda r, w: _bits(r, w, 1) * 255),
    ("1", "1;I"): (1, lambda r, w: (1 - _bits(r, w, 1)) * 255),
    ("1", "1;R"): (1, lambda r, w: _bits(r, w, 1, lsb=True) * 255),
    ("L", "L"): (8, lambda r, w: r[:, :w]),
    ("L", "L;4"): (4, lambda r, w: _bits(r, w, 4) * 17),
    ("P", "P"): (8, lambda r, w: r[:, :w]),
    ("P", "P;4"): (4, lambda r, w: _bits(r, w, 4)),
    ("P", "P;2"): (2, lambda r, w: _bits(r, w, 2)),
    # multi-band forms: ("px", bytes a pixel, the bytes of each band) or
    # ("planes", lines a row, the line of each band), copied band by band
    ("LA", "LA"): (16, ("px", 2, (0, 1))),
    ("LA", "LA;L"): (16, ("planes", 2, (0, 1))),
    ("PA", "PA;L"): (16, ("planes", 2, (0, 1))),
    ("RGB", "RGB"): (24, ("px", 3, (0, 1, 2))),
    ("RGB", "BGR"): (24, ("px", 3, (2, 1, 0))),
    ("RGB", "RGBX"): (32, ("px", 4, (0, 1, 2))),
    ("RGB", "BGRX"): (32, ("px", 4, (2, 1, 0))),
    ("RGB", "RGB;L"): (24, ("planes", 3, (0, 1, 2))),
    ("RGB", "RGBX;L"): (32, ("planes", 4, (0, 1, 2))),
    ("RGBA", "RGBA"): (32, ("px", 4, (0, 1, 2, 3))),
    ("RGBA", "BGRA"): (32, ("px", 4, (2, 1, 0, 3))),
    ("RGBA", "BGR"): (24, lambda r, w: np.concatenate(
        [r[:, : 3 * w].reshape(len(r), w, 3)[..., ::-1],
         np.full((len(r), w, 1), 255, np.uint8)], -1)),
    ("RGBA", "BGRA;15Z"): (16, _bgra15z),
    ("RGBA", "RGBA;L"): (32, ("planes", 4, (0, 1, 2, 3))),
    ("CMYK", "CMYK"): (32, ("px", 4, (0, 1, 2, 3))),
    ("CMYK", "CMYK;L"): (32, ("planes", 4, (0, 1, 2, 3))),
    ("YCbCr", "YCbCr;L"): (24, ("planes", 3, (0, 1, 2))),
    ("I;16", "I;16"): (16, lambda r, w: _num(r, w, "<u2")),
    ("I;16L", "I;16L"): (16, lambda r, w: _num(r, w, "<u2")),
    ("I;16B", "I;16B"): (16, lambda r, w: _num(r, w, ">u2")),
    ("I", "I"): (32, lambda r, w: _num(r, w, "<i4")),
    ("I", "I;32"): (32, lambda r, w: _num(r, w, "<i4")),
    ("I", "I;32S"): (32, lambda r, w: _num(r, w, "<i4")),
    ("I", "I;32B"): (32, lambda r, w: _num(r, w, ">i4")),
    ("F", "F"): (32, lambda r, w: _num(r, w, "<f4")),
    ("F", "F;32F"): (32, lambda r, w: _num(r, w, "<f4")),
    ("F", "F;32BF"): (32, lambda r, w: _num(r, w, ">f4")),
    ("F", "F;8"): (8, lambda r, w: _num(r, w, "u1")),
    ("F", "F;8S"): (8, lambda r, w: _num(r, w, "i1")),
    ("F", "F;16"): (16, lambda r, w: _num(r, w, "<u2")),
    ("F", "F;16S"): (16, lambda r, w: _num(r, w, "<i2")),
    ("F", "F;32"): (32, lambda r, w: _num(r, w, "<u4")),
}
# raw modes that write one band of a multi-band image: (band, inverted)
_BAND = {(mode, c): (i, False) for mode in ("RGB", "RGBA", "CMYK", "LAB")
         for i, c in enumerate(mode)}
_BAND.update({("CMYK", c + ";I"): (i, True) for i, c in enumerate("CMYK")})


def unpacker(mode, rawmode):
    """(bits a pixel, unpack) of Pillow's unpacker from `rawmode` into
    `mode`; unpack is None for one band of a multi-band image."""
    if (mode, rawmode) in _BAND:
        return 8, None
    if (mode, rawmode) not in _UNPACK:
        raise PilValueError("unknown raw mode for given image mode")
    return _UNPACK[(mode, rawmode)]


def put(img, ys, mode, rawmode, rows, w):
    """Unpack `rows` (n, bytes) of `rawmode` into img[ys]."""
    _, fn = unpacker(mode, rawmode)
    if fn is None:
        band, inverted = _BAND[(mode, rawmode)]
        img[ys, :, band] = 255 - rows[:, :w] if inverted else rows[:, :w]
    elif isinstance(fn, tuple):
        kind, k, order = fn
        n = len(rows)
        src = rows[:, : w * k].reshape(n, w, k) if kind == "px" else \
            rows[:, : w * k].reshape(n, k, w)
        for band, at in enumerate(order):
            img[ys, :, band] = src[:, :, at] if kind == "px" else \
                src[:, at]
    else:
        img[ys] = fn(rows, w)


def _rows(data, n, row, skip):
    """n rows of `row` bytes, `skip` bytes apart, from data's start:
    (n, row) uint8, or None where data ends first."""
    need = n * row + (n - 1) * skip
    if len(data) < need:
        return None
    if skip == 0:
        return data[: n * row].reshape(n, row)
    return np.lib.stride_tricks.as_strided(
        data, (n, row), (row + skip, 1)).copy()


def raw(img, data, mode, rawmode, stride=0, ystep=1):
    """RawDecode.c fed from the tile's offset: fills `img` (its rows
    bottom-up for a negative ystep); returns the decoder's error code."""
    h, w = img.shape[:2]
    bits, _ = unpacker(mode, rawmode)
    row = (w * bits + 7) // 8
    skip = stride - row if stride else 0
    if skip < 0:
        return -8
    rows = _rows(data, h, row, skip)
    if rows is None:
        raise truncated(len(data) % row if row and not skip else 0)
    ys = slice(None, None, -1) if ystep < 0 else slice(None)
    put(img, ys, mode, rawmode, rows, w)
    return 0


def _map(buf, img, mode, offset, stride, ystep):
    """``Image.core.map_buffer``: the file's bytes as the image's rows."""
    h, w = img.shape[:2]
    if stride <= 0:
        stride = w if mode in ("L", "P") else 2 * w \
            if mode.startswith("I;16") else 4 * w
    if offset + stride * h > len(buf):
        raise PilValueError("buffer is not large enough")
    bits, _ = unpacker(mode, mode)
    row = w * bits // 8
    data = np.frombuffer(buf, np.uint8)
    rows = np.lib.stride_tricks.as_strided(data[offset:], (h, row),
                                           (stride, 1)).copy()
    ys = slice(None) if ystep > 0 else slice(None, None, -1)
    put(img, ys, mode, mode, rows, w)


def _c_int(v):
    """A raw tile's stride as the decoder's C int takes it."""
    if not -2 ** 31 <= v < 2 ** 31:
        raise unported.OpenError("OverflowError: signed integer is out of "
                                 "a C int's range")


def _args(args):
    """A raw tile's args as (raw mode, stride, ystep)."""
    if isinstance(args, str):
        return args, 0, 1
    return args[0], args[1] if len(args) > 1 else 0, \
        args[2] if len(args) > 2 else 1


def load_raw(buf, path, mode, size, tiles):
    """``ImageFile.load`` of raw tiles [(offset, args)]: the mapping of a
    lone tile of a file opened by name, else each tile's decoder in file
    order; (H, W[, bands]) in Pillow's layout."""
    w, h = size
    if path is not None and len(tiles) == 1:
        offset, args = tiles[0]
        if isinstance(args, str):
            args = (args, 0, 1)
        if len(args) >= 3 and args[0] == mode and mode in _MAPMODES:
            if offset < 0:
                raise PilValueError("Tile offset cannot be negative")
            if offset + h * args[1] <= len(buf):  # else the decoder
                _c_int(args[1])
                img = new(mode, w, h)
                _map(buf, img, mode, offset, args[1], args[2])
                return img
    img = new(mode, w, h)
    tiles = sorted(tiles, key=lambda t: t[0])
    tiles = [t for i, t in enumerate(tiles)
             if i + 1 == len(tiles) or _args(tiles[i + 1][1]) != _args(t[1])]
    err = -3
    for offset, args in tiles:
        data = seek(buf, path, offset)
        rawmode, stride, ystep = _args(args)
        _c_int(stride)
        err = raw(img, data, mode, rawmode, stride, ystep)
    if err < 0:
        raise decoder_error(err)
    return img


def grey3(grey):
    return np.repeat(np.asarray(grey, np.uint8)[..., None], 3, axis=2)


def rgb_out(mode, img, pal=None):
    """(mode, samples) as ``read_image`` gives them: Pillow's modes I;16,
    I;16L, I;16B, I, F and YCbCr as they are, any other the image's
    ``convert("RGB")`` (`pal` the (256, 3) palette of P and PA, black
    where None; LAB is converted by its reader)."""
    if mode in ("I;16", "I;16L", "I;16B", "I", "F", "YCbCr"):
        return mode, np.ascontiguousarray(img)
    if pal is None:
        pal = np.zeros((256, 3), np.uint8)
    if mode in ("1", "L"):
        return "RGB", grey3(img)
    if mode == "LA":
        return "RGB", grey3(img[..., 0])
    if mode == "P":
        return "RGB", pal[img]
    if mode == "PA":
        return "RGB", pal[img[..., 0]]
    if mode == "CMYK":
        return "RGB", cmyk_to_rgb(img)
    return "RGB", np.ascontiguousarray(img[..., :3])
