"""The load of a JPEG 2000 file (a JP2 or a bare codestream) as Pillow
12.1.0's ``Jpeg2KImagePlugin`` loads what its open found, through
``Jpeg2KDecode.c``'s glue over OpenJPEG.

:func:`art_tpu_torch.io.unported._jpeg2000` mirrors the open: the mode
(L, I;16, LA, RGB, RGBA, CMYK, P or PA) and size from the SIZ marker or
the JP2 header, and for P and PA the palette that ``ImagePalette.
getcolor`` builds from the pclr box (repeated colours kept once). The
load here then does what ``j2k_decode_entry`` does:

- ``opj_read_header`` over the whole file (the codestream decoder in
  ``io/native/jp2dec.cc``); an image of 1 to 4 components;
- the colour space where the stream leaves it unknown or unspecified:
  grey for 1 or 2 components, else sYCC where the first subsampled
  component is the second or the third, sRGB otherwise;
- the first unpacker of Pillow's table that matches the colour space,
  the component count, the subsampling (only the RGB and RGBA ones take
  a subsampled component) and the open's mode; none, no load;
- each tile from ``opj_read_tile_header`` checked to lie in the image,
  decoded by ``opj_decode_tile_data`` into a zeroed buffer (its size
  Pillow's: the sum of the component widths grows with each tile) and
  unpacked (``j2ku_*``): each sample shifted from its precision to 8 or
  16 bits (a signed one offset by half its range, a narrowing one
  rounded by half a step, the result cut to the mode's width), a
  subsampled component read at x / dx, y / dy with the row stride
  w / dx, sYCC through Pillow's YCbCr to RGB;
- ``opj_end_decompress``.

Any failure raises Pillow's ``OSError("broken data stream when reading
image file")``. HTJ2K code-blocks (the code-block style's bit 0x40)
decode through the decoder's port of OpenJPEG's HT block decoder. The
image comes back as ``imagefile.read_image`` gives it: I;16 as it is,
any other mode through its ``convert("RGB")``.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from art_tpu_torch import hostbuild

BROKEN = "broken data stream when reading image file"

_LIB = None
_LIB_LOCK = threading.Lock()
_P = ctypes.c_void_p
_I64P = ctypes.POINTER(ctypes.c_int64)

# OPJ_COLOR_SPACE
_UNKNOWN, _UNSPECIFIED, _SRGB, _GRAY, _SYCC, _CMYK = -1, 0, 1, 2, 3, 5

# Jpeg2KDecode.c's j2k_unpackers: (mode, colour space, components,
# takes subsampling, unpacker), first match wins (its I;16B entry left
# out: no open gives that mode)
_UNPACKERS = (
    ("L", _GRAY, 1, False, "gray_l"),
    ("P", _SRGB, 1, False, "gray_l"),
    ("PA", _SRGB, 2, False, "graya_la"),
    ("I;16", _GRAY, 1, False, "gray_i"),
    ("LA", _GRAY, 2, False, "graya_la"),
    ("RGB", _GRAY, 1, False, "gray_rgb"),
    ("RGB", _GRAY, 2, False, "gray_rgb"),
    ("RGB", _SRGB, 3, True, "srgb_rgb"),
    ("RGB", _SYCC, 3, True, "sycc_rgb"),
    ("RGB", _SRGB, 4, True, "srgb_rgb"),
    ("RGB", _SYCC, 4, True, "sycc_rgb"),
    ("RGBA", _GRAY, 1, False, "gray_rgb"),
    ("RGBA", _GRAY, 2, False, "graya_la"),
    ("RGBA", _SRGB, 3, True, "srgb_rgb"),
    ("RGBA", _SYCC, 3, True, "sycc_rgb"),
    ("RGBA", _GRAY, 4, True, "srgba_rgba"),
    ("RGBA", _SRGB, 4, True, "srgba_rgba"),
    ("RGBA", _SYCC, 4, True, "sycca_rgba"),
    ("CMYK", _CMYK, 4, True, "srgba_rgba"),
)


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = hostbuild.load("jp2dec")
            lib.j2k_create.argtypes = [_P, ctypes.c_size_t, ctypes.c_int]
            lib.j2k_create.restype = _P
            lib.j2k_destroy.argtypes = [_P]
            lib.j2k_read_header.argtypes = [_P, _I64P, ctypes.c_int]
            lib.j2k_read_tile_header.argtypes = [_P, _I64P]
            lib.j2k_decode_tile_data.argtypes = [_P, ctypes.c_uint32, _P,
                                                 ctypes.c_uint64]
            lib.j2k_end_decompress.argtypes = [_P]
            _LIB = lib
    return _LIB


def _broken():
    return OSError(BROKEN)


def _check(r):
    """An entry point's return: 0 is Pillow's failure."""
    if not r:
        raise _broken()


def _csiz(prec):
    c = (prec + 7) >> 3
    return 4 if c == 3 else c


def _words(buf, start, csiz, index):
    """The unsigned words of `csiz` bytes at `index` (in words) from byte
    `start` of `buf`, little-endian; zero past its end."""
    off = start + csiz * index.astype(np.int64)
    out = np.zeros(index.shape, np.uint32)
    n = buf.size
    for k in range(csiz):
        pos = off + k
        ok = (pos >= 0) & (pos < n)
        out |= np.where(ok, buf[np.where(ok, pos, 0)], 0).astype(
            np.uint32) << np.uint32(8 * k)
    return out


def _plane(buf, start, csiz, h, w):
    """The (h, w) words of `csiz` bytes stored row by row from byte
    `start` of `buf`, as uint32; zero past its end."""
    n = h * w
    have = max(0, min(n, (buf.size - start) // csiz))
    dtype = {1: "<u1", 2: "<u2", 4: "<u4"}[csiz]
    out = np.zeros(n, np.uint32)
    out[:have] = np.frombuffer(buf.data, dtype, have, start)
    if have < n:
        return _words(buf, start, csiz, np.arange(n).reshape(h, w))
    return out.reshape(h, w)


def _shift(word, prec, sgnd, depth):
    """``j2ku_shift(offset + word, shift)`` of Pillow's unpackers, cut to
    `depth` bits."""
    shift = depth - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    x = word + np.uint32(offset)  # uint32 arithmetic wraps as C's does
    x = x >> np.uint32(-shift) if shift < 0 else x << np.uint32(shift)
    return x & np.uint32((1 << depth) - 1)


def _unpack(name, comps, tile, buf, im):
    """Pillow's ``j2ku_<name>`` of one tile's buffer into `im`, the image
    in Pillow's storage ((H, W) for L, P and I;16, else (H, W, 4))."""
    x0, y0, x1, y1, ix0, iy0 = tile
    w, h = x1 - x0, y1 - y0
    ox, oy = x0 - ix0, y0 - iy0
    if name in ("gray_l", "gray_i", "gray_rgb"):
        prec, sgnd = comps[0][2], comps[0][3]
        depth = 16 if name == "gray_i" else 8
        v = _shift(_plane(buf, 0, _csiz(prec), h, w), prec, sgnd, depth)
        if name == "gray_rgb":
            im[oy:oy + h, ox:ox + w, :3] = v[..., None].astype(np.uint8)
            im[oy:oy + h, ox:ox + w, 3] = 255
        else:
            im[oy:oy + h, ox:ox + w] = v.astype(im.dtype)
        return
    if name == "graya_la":
        (_, _, prec, sgnd), (_, _, aprec, asgnd) = comps[0], comps[1]
        c, ac = _csiz(prec), _csiz(aprec)
        v = _shift(_plane(buf, 0, c, h, w), prec, sgnd, 8)
        a = _shift(_plane(buf, c * w * h, ac, h, w), aprec, asgnd, 8)
        im[oy:oy + h, ox:ox + w, :3] = v[..., None].astype(np.uint8)
        im[oy:oy + h, ox:ox + w, 3] = a.astype(np.uint8)
        return
    n = 4 if name in ("srgba_rgba", "sycca_rgba") else 3
    start = 0
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    for k in range(n):
        dx, dy, prec, sgnd = comps[k]
        c = _csiz(prec)
        if (dx, dy) == (1, 1):
            word = _plane(buf, start, c, h, w)
        else:
            ys, xs = np.mgrid[0:h, 0:w]
            word = _words(buf, start, c, (ys // dy) * (w // dx) + xs // dx)
        out[..., k] = _shift(word, prec, sgnd, 8).astype(np.uint8)
        start += c * (w // dx) * (h // dy)
    if name in ("sycc_rgb", "sycca_rgba"):
        from art_tpu_torch.io.plugins import ycbcr_to_rgb

        out[..., :3] = ycbcr_to_rgb(out[..., :3])
    im[oy:oy + h, ox:ox + w] = out


def decode(buf, codec, mode, size):
    """The image Pillow's load of a JPEG 2000 file of mode `mode` and
    size `size` (from the open) leaves, in Pillow's storage: (H, W) uint8
    for L and P, (H, W) uint16 for I;16, else (H, W, 4) uint8. Every
    failure is Pillow's OSError."""
    lib = _lib()
    data = np.frombuffer(bytes(buf), np.uint8)
    handle = lib.j2k_create(data.ctypes.data, data.size, codec == "jp2")
    if not handle:
        raise _broken()
    try:
        return _decode(lib, handle, data, mode, size)
    finally:
        lib.j2k_destroy(handle)


def _decode(lib, handle, data, mode, size):
    info = (ctypes.c_int64 * (6 + 4 * 16385))()
    _check(lib.j2k_read_header(handle, info, len(info)))
    ncomp, space = info[0], info[1]
    if not 1 <= ncomp <= 4:
        raise _broken()
    comps = [tuple(info[6 + 4 * c:10 + 4 * c]) for c in range(ncomp)]
    ix0, iy0 = info[2], info[3]
    first = next((c for c in range(ncomp) if comps[c][:2] != (1, 1)), None)
    if space in (_UNKNOWN, _UNSPECIFIED):
        if ncomp <= 2:
            space = _GRAY
        elif first in (1, 2):
            space = _SYCC
        else:
            space = _SRGB
    unpack = next((u[4] for u in _UNPACKERS
                   if u[1] == space and u[2] == ncomp
                   and (u[3] or first is None) and u[0] == mode), None)
    if unpack is None:
        raise _broken()
    w, h = size
    if mode in ("L", "P"):
        im = np.zeros((h, w), np.uint8)
    elif mode == "I;16":
        im = np.zeros((h, w), np.uint16)
    else:
        im = np.zeros((h, w, 4), np.uint8)
    tinfo = (ctypes.c_int64 * 8)()
    width = 0  # Pillow's total_component_width, summed over every tile
    for _ in range(1 << 20):
        _check(lib.j2k_read_tile_header(handle, tinfo))
        if not tinfo[0]:
            break
        index, data_size, x0, y0, x1, y1, nb = tinfo[1:8]
        if x0 >= x1 or y0 >= y1 or x0 < 0 or y0 < 0 or x0 < ix0 or \
                y0 < iy0 or x1 - ix0 > w or y1 - iy0 > h or nb != ncomp:
            raise _broken()
        width += sum(_csiz(c[2]) for c in comps)
        tw, th = x1 - x0, y1 - y0
        for a, b in ((tw, width), (th, width), (th * width, tw),
                     (tw * width, th)):
            if a * b > 0xFFFFFFFF:
                raise _broken()
        # Pillow's buffer holds max(tw * th * width, data_size) bytes,
        # zeroed; the decoder writes data_size of them, and an unpacker's
        # read past them finds zeros (`_words`, `_plane`)
        out = np.zeros(max(data_size, 1), np.uint8)
        if not lib.j2k_decode_tile_data(handle, index, out.ctypes.data,
                                        out.size):
            raise _broken()
        out = out[:data_size]
        _unpack(unpack, comps, (x0, y0, x1, y1, ix0, iy0), out, im)
    if not lib.j2k_end_decompress(handle):
        raise _broken()
    return im


def to_pillow_layout(mode, im):
    """Pillow's 4-byte pixels of LA and PA as their two bands, of RGB as
    its three; the other modes as they are."""
    if mode in ("LA", "PA"):
        return np.ascontiguousarray(im[..., [0, 3]])
    if mode == "RGB":
        return np.ascontiguousarray(im[..., :3])
    return im


def read_jpeg2000(buf, path):
    """A JPEG 2000 image as ``imagefile.read_image`` gives it: (mode,
    samples, None), I;16 as it is, any other mode its ``convert("RGB")``
    (P and PA through the open's palette)."""
    from art_tpu_torch.io import unported
    from art_tpu_torch.io.rawtile import rgb_out
    from art_tpu_torch.io.unported import _File

    f = _File(buf, path)
    mode, size = unported._jpeg2000(f)
    codec, palette = f.tile
    im = to_pillow_layout(mode, decode(buf, codec, mode, size))
    return (*rgb_out(mode, im, palette), None)
