"""The loads of the texture and icon formats Pillow 12.1.0 opens: BLP,
DDS and ICNS, each as its plugin loads what its open found.

:mod:`art_tpu_torch.io.unported` mirrors the opens (each leaves its tile
and header state in the file's ``tile``) and decides, in the order of
Pillow's ``Image.ID``, which plugin opens a file; the reader here then
loads it. Each follows its plugin:

- BLP (``BlpImagePlugin``; its decoders pull the file from the tile's
  offset): the 16 mipmap offsets and lengths, then BLP1's JPEG (the
  header and the first mipmap joined and decoded by the port's JPEG
  decoder, a four-component frame read as CMYK with no YCCK conversion,
  the RGB set as ``BGR``: red and blue swap), BLP1's palette encodings
  4 and 5 and BLP2's uncompressed palette (each byte an entry of the
  256 BGRA entries), BLP2's DXT1, DXT3 and DXT5 through the plugin's own
  Python decode (``blp_dxt``, not ``BcnDecode.c``). The decoded bytes
  are set at the image's stride, so a width that is not a multiple of 4
  shears a DXT image, and DXT3/5's RGBA bytes are read as RGB where the
  alpha flag is 0. `BLPFormatError` (a NotImplementedError) for the
  forms Pillow refuses, OSError "Truncated File Read" for a short read.
- DDS (``DdsImagePlugin``; its ``load_seek`` does nothing, so the data
  starts where the open stopped reading): ``dds_rgb``'s masks (each
  value's trailing zero bits shifted off, ``int(v / total * 255)``,
  zeros past the file's end), L, LA, P with its 1024-byte RGBA palette,
  DX10's R8G8B8A8, and every BCn form through ``BcnDecode.c`` (``bcn``:
  BC1-BC3 RGBA, BC4 L, BC5 RGB signed or not, BC6H RGB, BC7 RGBA).
- ICNS (``IcnsImagePlugin``): the best size's readers in order, each
  from its block's start to the file's end (raw or Apple's PackBits RGB,
  the 4-zero ``it32`` signature, the ``*8mk`` mask, a PNG icon through
  the port's PNG reader); an RGBA icon wins, else the RGB (its mask put
  as alpha); an icon whose size is none of the file's is refused as
  Pillow's size check refuses it. A JPEG 2000 icon (``read_png_or_
  jpeg2000``) opens on the block's bytes as a BytesIO would read them,
  passes the bomb check and loads through :mod:`art_tpu_torch.io.
  jpeg2000` into RGBA: at once for another mode (its ``convert``), after
  the other readers for an RGBA one.

The byte streams decode in ``io/native/rasterdec.cc``. Every reader
takes (buf, path) and returns (mode, samples, icc) as
``imagefile.read_image`` does: "RGB" with the image's
``convert("RGB")`` (an ICNS opens as RGBA whatever its icon's mode, so
its consumers take even a 16-bit grey PNG icon through RGB).
"""

from __future__ import annotations

import struct

import numpy as np

from art_tpu_torch.io import unported
from art_tpu_torch.io.rasterformats import _lib, _ptr
from art_tpu_torch.io.rawtile import new, raw, rgb_out, truncated
from art_tpu_torch.io.stdformats import (GREY_PALETTE, DecompressionBomb,
                                         PilValueError,
                                         Unidentified)
from art_tpu_torch.io.unported import _File


class BLPFormatError(NotImplementedError):
    """BlpImagePlugin.BLPFormatError."""


def _set_as_raw(img, data, mode, rawmode=None):
    """``PyDecoder.set_as_raw``: ValueError where `data` is short."""
    data = np.frombuffer(bytes(data), np.uint8)
    try:
        raw(img, data, mode, rawmode or mode)
    except OSError as e:
        raise PilValueError("not enough image data") from e
    return img


# -- BLP ---------------------------------------------------------------------

def _safe_read(f, n):
    """``ImageFile._safe_read`` in a decoder's load: a short read is a
    plain OSError (the open succeeded)."""
    if n <= 0:
        return b""
    out = f.read(n)
    if len(out) < n:
        raise OSError("Truncated File Read")
    return out


def _blp_palette(f):
    """``_read_palette``: 256 BGRA entries, (256, 4) as (b, g, r, a)."""
    return np.frombuffer(_safe_read(f, 1024), np.uint8).reshape(256, 4)


def _blp_bgra(f, lengths, palette, alpha):
    """``_read_bgra``: each byte of the first mipmap an entry, as RGB or
    RGBA bytes."""
    idx = np.frombuffer(_safe_read(f, lengths[0]), np.uint8)
    order = [2, 1, 0, 3] if alpha else [2, 1, 0]
    return palette[:, order][idx].tobytes()


def _blp_jpeg(f, offsets, lengths):
    """``BLP1Decoder._decode_jpeg_stream``: the stream's RGB bytes."""
    from art_tpu_torch.io import jpegdec
    from art_tpu_torch.io.stdformats import cmyk_to_rgb

    (n,) = struct.unpack("<I", _safe_read(f, 4))
    head = _safe_read(f, n)
    _safe_read(f, offsets[0] - f.tell())
    data = head + _safe_read(f, lengths[0])
    try:  # JpegImageFile's open: ImageFile's wrap of its errors
        hdr = jpegdec._parse(data)
    except (IndexError, TypeError, KeyError, EOFError, struct.error) as e:
        raise SyntaxError(str(e)) from e
    # the tile's jpeg mode set to "CMYK": a four-component frame is read
    # as CMYK (no YCCK conversion), inverted as Pillow's "CMYK;I"
    arr = jpegdec.decode(data, color=2 if hdr.mode == "CMYK" else -1)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=2)
    elif arr.shape[2] == 4:
        arr = cmyk_to_rgb(arr)
    return arr.tobytes()


def read_blp(buf, path):
    """The BLP1 or BLP2 decoder from the tile's offset. Pillow maps a
    ``struct.error`` there to "Truncated BLP file", but every read goes
    through ``_safe_read`` first, so none can come."""
    f = _File(buf, path)
    mode, (w, h) = unported._blp(f)
    magic, offset, compression, encoding, alpha, alpha_encoding = f.tile
    img = new(mode, w, h)
    f.seek(offset)
    offsets = struct.unpack("<16I", _safe_read(f, 64))
    lengths = struct.unpack("<16I", _safe_read(f, 64))
    if magic == b"BLP1":
        if compression == 0:
            rgb = _blp_jpeg(f, offsets, lengths)
            return (*rgb_out(mode, _set_as_raw(img, rgb, mode, "BGR")), None)
        if compression != 1:
            raise BLPFormatError(f"Unsupported BLP compression {encoding!r}")
        if encoding not in (4, 5):
            raise BLPFormatError(f"Unsupported BLP encoding {encoding!r}")
        data = _blp_bgra(f, lengths, _blp_palette(f), alpha)
        return (*rgb_out(mode, _set_as_raw(img, data, mode)), None)
    palette = _blp_palette(f)
    f.seek(offsets[0])
    if compression != 1:
        raise BLPFormatError(f"Unknown BLP compression {compression!r}")
    if encoding == 1:
        data = _blp_bgra(f, lengths, palette, alpha)
    elif encoding == 2:
        kind = {0: 1, 1: 3, 7: 5}.get(alpha_encoding)
        if kind is None:
            raise BLPFormatError(
                f"Unsupported alpha encoding {alpha_encoding!r}")
        bw, bh = (w + 3) // 4, (h + 3) // 4
        src = np.frombuffer(_safe_read(f, bh * bw * (8 if kind == 1 else 16)),
                            np.uint8)
        data = np.zeros(bh * 4 * bw * 4 * (3 if kind == 1 and not alpha
                                           else 4), np.uint8)
        _lib().blp_dxt(kind, int(alpha), _ptr(src), bw, bh, _ptr(data))
    else:
        raise BLPFormatError(f"Unknown BLP encoding {encoding!r}")
    return (*rgb_out(mode, _set_as_raw(img, data, mode)), None)


# -- DDS ---------------------------------------------------------------------

_CHUNK = 1 << 22  # the pixels `_dds_rgb` unpacks at a time


def _dds_rgb(data, w, h, bitcount, masks):
    """``DdsRgbDecoder``: each pixel a little-endian value of bitcount // 8
    bytes (zero past the data's end), each mask's bits scaled to 8 as
    ``int(v / total * 255)`` (through a table of every v where the
    field has at most 16 bits)."""
    n = w * h
    k = bitcount // 8
    fields = []
    for mask in masks:
        off = 0
        if mask:
            while mask >> (off + 1) << (off + 1) == mask:
                off += 1
        total = mask >> off
        lut = (np.arange(total + 1) / total * 255).astype(np.uint8) \
            if 0 < total < 1 << 16 else None
        fields.append((mask, off, total, lut))
    out = np.zeros((n, len(masks)), np.uint8)
    for p0 in range(0, n, _CHUNK):
        p1 = min(n, p0 + _CHUNK)
        vals = np.zeros(p1 - p0, np.uint32)  # the masks read 32 bits at most
        if k in (1, 2, 4) and p1 * k <= len(data):  # whole values
            vals[:] = data[p0 * k : p1 * k].view(f"<u{k}")
        elif k == 3 and p1 * k <= len(data):
            cols = data[p0 * k : p1 * k].reshape(-1, k)
            for b in range(k):
                vals |= cols[:, b].astype(np.uint32) << np.uint32(8 * b)
        else:
            for b in range(min(k, 4)):
                at = np.arange(p0, p1, dtype=np.int64) * k + b
                ok = at < len(data)
                vals[ok] |= data[at[ok]].astype(np.uint32) << np.uint32(8 * b)
        for i, (mask, off, total, lut) in enumerate(fields):
            if not total:
                continue
            v = (vals & np.uint32(mask)) >> np.uint32(off)
            out[p0:p1, i] = lut[v] if lut is not None else \
                (v.astype(np.float64) / total * 255).astype(np.uint8)
    return out.reshape(h, w, len(masks))


def read_dds(buf, path, indices=False):
    f = _File(buf, path)
    mode, (w, h) = unported._dds(f)
    kind, at, palette = f.tile
    data = np.frombuffer(buf, np.uint8)[at:]
    if kind[0] == "rgb":
        return (*rgb_out(mode, _dds_rgb(data, w, h, *kind[1:])), None)
    if kind[0] == "raw":
        row = w * (2 if mode == "LA" else 4 if mode == "RGBA" else 1)
        if data.size < row * h:  # the raw decoder's error, before the image
            raise truncated(data.size % row)  # is made
        img = new(mode, w, h)
        raw(img, data, mode, kind[1])
        pal = None
        if palette is not None and indices:
            pal = GREY_PALETTE
        elif palette is not None:
            pal = np.zeros((256, 3), np.uint8)
            entries = np.frombuffer(palette[: len(palette) // 4 * 4],
                                    np.uint8).reshape(-1, 4)
            pal[: len(entries)] = entries[:, :3]
        return (*rgb_out(mode, img, pal), None)
    _, n, sign = kind
    size = 8 if n in (1, 4) else 16
    if data.size < ((w + 3) // 4) * ((h + 3) // 4) * size:
        raise truncated(data.size % size)
    img = new(mode, w, h)
    _lib().bcn(n, sign, _ptr(data), data.size, w, h, _ptr(img))
    return (*rgb_out(mode, img), None)


# -- ICNS --------------------------------------------------------------------

def _read_32(buf, start, length, side):
    """``read_32``: raw RGB where the block holds 3 side^2 bytes, else
    Apple's PackBits, one band after another, from `start` on."""
    n = side * side
    if length == n * 3:
        img = new("RGB", side, side)
        return _set_as_raw(img, buf[start : start + length], "RGB")
    img = np.zeros((side, side, 3), np.uint8)
    pos = start
    for band in range(3):
        out = bytearray()
        left = n
        while left > 0:
            if pos >= len(buf):
                break
            c = buf[pos]
            pos += 1
            if c & 0x80:
                k = c - 125
                v = buf[pos : pos + 1]
                pos += len(v)
                out += v * k
            else:
                k = c + 1
                out += buf[pos : pos + k]
                pos += len(buf[pos : pos + k])
            left -= k
        if left != 0:
            raise SyntaxError(f"Error reading channel [{left!r} left]")
        if len(out) < n:
            raise PilValueError("buffer is not large enough")
        img[..., band] = np.frombuffer(bytes(out[:n]), np.uint8).reshape(
            side, side)
    return img


def _icns_png(buf, start):
    """A PNG icon as ``PngImageFile`` opens it from the block's start and
    loads it: (mode, samples), or the open's error (SyntaxError, or
    OSError for a short read) raised at once and the load's returned."""
    from art_tpu_torch.io import imagefile

    try:
        samples, depth, ctype, plte, _ = imagefile._read_png(buf[start:],
                                                             bomb=True)
    except Unidentified as e:
        cause = e.__cause__
        if isinstance(cause, OSError) and not isinstance(cause, Unidentified):
            raise OSError(str(cause)) from e
        raise SyntaxError(str(cause or e)) from e
    except (DecompressionBomb, PilValueError):
        raise
    except Exception as e:  # the load's error, raised after the readers
        return e
    if ctype == 0 and depth == 16:  # I;16, clipped: the ICNS opened as RGBA
        return "RGB", imagefile.to_rgb8("I;16", samples[..., 0])
    return "RGB", imagefile._png_rgb8(samples, depth, ctype, plte)


class _Stream(_File):
    """A ``BytesIO``'s reads and seeks: a negative length reads to the
    end, a seek before the start from the current position or the end
    stops at the start."""

    def read(self, n=-1):
        return super().read(-1 if n < 0 else n)

    def seek(self, off, whence=0):
        if whence == 0 and off < 0:
            raise PilValueError(f"negative seek value {off}")
        base = (0, self.pos, len(self.buf))[whence]
        self.pos = max(0, base + off)


def _icns_jpeg2000(buf, start, length):
    """``read_png_or_jpeg2000`` on a JPEG 2000 icon: a Jpeg2KImageFile on
    the block's bytes (its open's errors, IndexError, KeyError, TypeError,
    EOFError and struct.error as SyntaxError), the bomb check, then
    ``convert("RGBA")`` (its load) unless the mode is RGBA, whose load
    comes after the other readers. (mode, samples) as ``read_image``
    gives them, or the deferred load's error."""
    from art_tpu_torch.io import jpeg2000
    from art_tpu_torch.io import imagefile

    data = bytes(buf[start : start + max(length, 0)])
    f = _Stream(data)
    try:
        mode, size = unported._jpeg2000(f)
    except (IndexError, TypeError, KeyError, EOFError, struct.error) as e:
        raise SyntaxError(str(e)) from e
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("no mode, or an empty size")
    unported._bomb(size)
    codec, palette = f.tile

    def load():
        im = jpeg2000.to_pillow_layout(
            mode, jpeg2000.decode(data, codec, mode, size))
        return "RGB", imagefile.to_rgb8(*rgb_out(mode, im, palette))

    if mode != "RGBA":
        return load()
    try:
        return load()
    except Exception as e:  # the load's error, raised after the readers
        return e


def read_icns(buf, path):
    f = _File(buf, path)
    unported._icns(f)
    blocks, sizes = f.tile
    best = max(sizes)
    side = best[0] * best[2]
    buf = f.buf
    channels = {}
    for code in unported._ICNS_SIZES[best]:
        if code not in blocks:
            continue
        start, length = blocks[code]
        if code.endswith(b"mk"):  # read_mk
            if len(buf[start : start + side * side]) < side * side:
                raise PilValueError("buffer is not large enough")
            channels["A"] = True
        elif code in (b"it32", b"is32", b"il32", b"ih32"):
            if code == b"it32":  # read_32t
                if buf[start : start + 4] != b"\0\0\0\0":
                    raise SyntaxError("Unknown signature, expecting "
                                      "0x00000000")
                start, length = start + 4, length - 4
            channels["RGB"] = _read_32(buf, start, length, side)
        else:  # read_png_or_jpeg2000
            sig = buf[start : start + 12]
            if sig.startswith(b"\x89PNG\r\n\x1a\n"):
                channels["RGBA"] = _icns_png(buf, start)
            elif unported.is_jpeg2000(sig, icns=True):
                channels["RGBA"] = _icns_jpeg2000(buf, start, length)
            else:
                raise PilValueError("Unsupported icon subimage format")
    if "RGBA" in channels:
        icon = channels["RGBA"]
        if isinstance(icon, Exception):
            raise icon
        mode, samples = icon
    else:
        if "RGB" not in channels:
            raise KeyError("RGB")
        mode, samples = "RGB", channels["RGB"]
    # the icon's size set as the image's: one of the file's sizes
    ih, iw = samples.shape[:2]
    for s in sizes:
        sw, sh = s[0] * s[2], s[1] * s[2]
        if sh / ih == sw // iw:
            return mode, np.ascontiguousarray(samples), None
    raise PilValueError("This is not one of the allowed sizes of this image")


_PNG_MODES = {(0, 1): "1", (0, 16): "I;16", (2, 8): "RGB", (2, 16): "RGB",
              (3, 1): "P", (3, 2): "P", (3, 4): "P", (3, 8): "P",
              (4, 8): "LA", (4, 16): "LA", (6, 8): "RGBA", (6, 16): "RGBA"}


def icns_loaded_mode(buf):
    """The mode an ICNS that `read_icns` decodes takes once Pillow has
    loaded it (it opens as RGBA): its PNG icon's, or RGB or RGBA (a mask)
    for an RLE or raw one. ``np.asarray`` of the image packs its pixels
    into the open's RGBA, which fails for a PNG icon of another mode than
    RGB or RGBA."""
    f = _File(buf)
    unported._icns(f)
    blocks, sizes = f.tile
    codes = [c for c in unported._ICNS_SIZES[max(sizes)] if c in blocks]
    for code in codes:
        start = blocks[code][0]
        if bytes(buf[start : start + 8]) == b"\x89PNG\r\n\x1a\n":
            depth, ctype = buf[start + 24], buf[start + 25]
            return _PNG_MODES.get((ctype, depth), "L")
        if unported.is_jpeg2000(bytes(buf[start : start + 12]), icns=True):
            return "RGBA"  # converted to RGBA by the reader
    return "RGBA" if any(c.endswith(b"mk") for c in codes) else "RGB"
