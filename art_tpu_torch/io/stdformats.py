"""BMP, PNM and GIF decoding without PIL: the arrays the reference's
callers get from Pillow 12.1.0's ``Image.open(path)`` and its
``convert("RGB")``. (The formats Pillow opens and the port does not
decode are told apart in :mod:`art_tpu_torch.io.unported`.)

Each reader follows the Pillow plugin that opens the format, as that
plugin reads it (``BmpImagePlugin``, ``PpmImagePlugin``,
``GifImagePlugin``), and returns ``(mode, samples)``: "RGB" with the
``convert("RGB")`` of every 8-bit form ((H, W, 3) uint8), or "I" with
the int32 samples of a PGM whose maxval is above 255. Where Pillow's
``Image.open`` fails, the readers raise `Unidentified` (an OSError);
where its load fails in C code, OSError; where it fails in one of its
Python decoders (``ValueError``), `PilValueError`, a ValueError; an
image past Pillow's pixel limit, `DecompressionBomb`.

- BMP: the 12-byte OS/2 header and the 40- to 124-byte Windows headers;
  1, 4 and 8 bits through the palette (one of more than 256 entries a
  ValueError); a palette that is the grey ramp reads as Pillow's mode
  "L", a byte a pixel whatever the depth (a file opened by name maps
  its rows, which then may overlap), or, black and white, as "1", bits
  whatever the depth; 16 bits as 5-5-5, 24
  bits, 32 bits; the bitfield layouts Pillow knows (5-6-5 and 5-5-5, and
  the byte orders of 24 and 32 bits, alpha dropped); RLE8 and RLE4 with
  Pillow's own walk of the escapes (its delta escape reads two bytes
  more than it uses, as Pillow does); bottom-up and top-down rows.
- PNM: P1-P6 at every maxval: raw samples where maxval is 255 (and a
  P5 of maxval 65535 as "I"), else Pillow's rescale ``round(v / maxval
  * 255)`` (to 65535 for a PGM of maxval above 255, mode "I"), the plain
  forms token by token with ``#`` comments.
- GIF: the first frame: the logical screen grown to the frame, the
  frame's or the global colour table (one that is the grey ramp gives
  grey), LZW data (``io/native/lzwdec.cc``, which reads the file as
  Pillow's decoder is fed it), interlaced rows, pixels outside the frame
  the transparent index where one is set, else 0.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

from art_tpu_torch import hostbuild


class Unidentified(OSError):
    """``Image.open`` fails: the bytes are no image PIL knows."""


class PilValueError(ValueError):
    """Pillow's open or load raises ValueError here (a Python decoder)."""


class PilIndexError(IndexError):
    """Pillow's load raises IndexError here (QOI's Python decoder reads
    past the file's end): not an OSError, so the reference tries no
    external loader."""


class PilSyntaxError(SyntaxError):
    """Pillow's load raises SyntaxError here (a PNG chunk name that is no
    name while the image wants more data): not an OSError, so the
    reference tries no external loader."""


class DecompressionBomb(Exception):
    """``Image.open``'s DecompressionBombError: an image of more than
    twice ``Image.MAX_IMAGE_PIXELS`` pixels (not an OSError, so the
    reference tries no external loader)."""


_WS = b" \t\n\x0b\x0c\r"


def _u16(b, off=0):
    return struct.unpack_from("<H", b, off)[0]


def _u32(b, off=0):
    return struct.unpack_from("<I", b, off)[0]


# -- the conversions Pillow's convert("RGB") applies -----------------------

def _cmyk_table():
    """out[k << 8 | v]: Pillow's ``cmyk2rgb`` of one of C, M, Y (v)
    against K, ``nk - MULDIV255(v, nk)`` with nk = 255 - K."""
    v = np.arange(256, dtype=np.int32)[None, :]
    nk = 255 - np.arange(256, dtype=np.int32)[:, None]
    t = v * nk + 128
    return np.clip(nk - ((t + (t >> 8)) >> 8), 0, 255).astype(
        np.uint8).reshape(-1)


_CMYK = _cmyk_table()


def cmyk_to_rgb(cmyk):
    """Pillow's ``convert("RGB")`` of (..., 4) uint8 CMYK."""
    c = np.asarray(cmyk, np.uint8)
    k = c[..., 3:4].astype(np.uint16) << 8
    return _CMYK[k | c[..., :3]]


def _grey3(grey):
    return np.repeat(np.asarray(grey, np.uint8)[..., None], 3, axis=2)


# the palette a reader's `indices` takes: each entry its index, thrice
GREY_PALETTE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)


def _palette(raw, stride):
    """(256, 3) uint8 from palette bytes of `stride` bytes an entry in
    B, G, R (stride 3 or 4) or R, G, B order (negative stride); entries
    past the bytes black."""
    pal = np.zeros((256, 3), np.uint8)
    s = abs(stride)
    k = min(len(raw) // s, len(pal))
    ent = np.frombuffer(bytes(raw[: k * s]), np.uint8).reshape(k, s)[:, :3]
    pal[:k] = ent[:, ::-1] if stride > 0 else ent
    return pal


def _bits(rows, depth, width):
    """Packed rows (MSB first) -> (h, width) uint8 values of `depth`
    bits."""
    h = rows.shape[0]
    b = np.unpackbits(rows, axis=1)[:, : width * depth].reshape(h, width,
                                                                depth)
    out = np.zeros((h, width), np.uint8)
    for i in range(depth):
        out = (out << 1) | b[..., i]
    return out


# -- BMP --------------------------------------------------------------------

# 32-bit bitfield masks (R, G, B, A) -> the byte order in memory
_MASKS32 = {(0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX",
            (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
            (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR",
            (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
            (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
            (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
            (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR",
            (0x0, 0x0, 0x0, 0x0): "BGRA"}


def read_bmp(buf, indices=False):
    """A BMP file as Pillow opens and converts it: ("RGB", (H, W, 3));
    `indices`: a palette image's indices in each channel."""
    try:
        offset = _u32(buf, 10)
    except struct.error as e:
        raise Unidentified(f"BMP: header cut off ({e})") from e
    return read_bitmap(buf, 14, offset, indices=indices)


def read_bitmap(buf, at, offset=0, rows=None, mapped=True, indices=False):
    """``BmpImageFile._bitmap`` and the load of its tile: the bitmap whose
    info header starts at byte `at`, its data at `offset` (the file
    header's; where that is 0, after the header, masks and palette, as a
    DIB, an icon's or a cursor's bitmap is read), ("RGB", (H, W, 3)).
    `rows` makes the image's height what an icon (``int(h / 2)``) or a
    cursor (``h // 2``) takes of the header's. `mapped`: the file was
    opened by name, so Pillow maps an 8-bit tile of one byte a pixel
    (``ImageFile.load``'s mmap) where the file holds all its rows; an
    icon's bitmap, read from the icon file's stream, is not mapped.
    `indices`: a palette image's indices in each channel, its palette
    read as the grey ramp."""
    try:
        hsize = _u32(buf, at)
    except struct.error as e:
        raise Unidentified(f"BMP: header cut off ({e})") from e
    hdr = buf[at + 4 : at + hsize]
    if len(hdr) < hsize - 4:
        raise Unidentified("BMP: Truncated File Read")
    pos = at + hsize
    masks = None
    try:
        if hsize == 12:
            w, h = _u16(hdr, 0), _u16(hdr, 2)
            bits, comp, colors, pad, direction = _u16(hdr, 6), 0, 0, 3, -1
        elif hsize in (40, 52, 56, 64, 108, 124):
            flip = hdr[7] == 0xFF
            direction = 1 if flip else -1
            w = _u32(hdr, 0)
            h = 2 ** 32 - _u32(hdr, 4) if flip else _u32(hdr, 4)
            bits, comp = _u16(hdr, 10), _u32(hdr, 12)
            colors, pad = _u32(hdr, 28), 4
            if comp == 3:
                if len(hdr) >= 48:
                    n = 4 if len(hdr) >= 52 else 3
                    masks = [_u32(hdr, 36 + 4 * i) for i in range(n)]
                else:
                    masks = list(struct.unpack_from("<3I", buf, pos))
                    pos += 12
                masks += [0] * (4 - len(masks))
        else:
            raise Unidentified(f"Unsupported BMP header type ({hsize})")
    except (struct.error, IndexError) as e:
        raise Unidentified(f"BMP: header cut off ({e})") from e
    if w <= 0 or h <= 0:
        raise Unidentified(f"BMP: image size {w}x{h}")
    if w * h > 178956970 and rows is None:  # an icon's: at its open
        raise DecompressionBomb(f"BMP: image size {w}x{h}")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    raw = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR",
           32: "BGRX"}.get(bits)
    if raw is None:
        raise Unidentified(f"Unsupported BMP pixel depth ({bits})")
    rle = False
    if comp == 3:
        if bits == 32 and tuple(masks) in _MASKS32:
            raw = _MASKS32[tuple(masks)]
        elif bits == 24 and tuple(masks[:3]) == (0xFF0000, 0xFF00, 0xFF):
            raw = "BGR"
        elif bits == 16 and tuple(masks[:3]) in ((0xF800, 0x7E0, 0x1F),
                                                (0x7C00, 0x3E0, 0x1F)):
            raw = "BGR;16" if masks[0] == 0xF800 else "BGR;15"
        else:
            raise Unidentified("Unsupported BMP bitfields layout")
    elif comp in (1, 2):
        rle = True
        if bits > 8:  # BmpRleDecoder's "P" raw mode for an "RGB" image
            raise PilValueError("unknown raw mode for given image mode")
    elif comp != 0:
        raise Unidentified(f"Unsupported BMP compression ({comp})")
    pal = None
    grey = False
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise Unidentified(f"Unsupported BMP Palette size ({colors})")
        praw = buf[pos : pos + pad * colors]
        pos += len(praw)
        idx = (0, 255) if colors == 2 else range(colors)
        grey = all(praw[i * pad : i * pad + 3] == bytes([v & 255]) * 3
                   for i, v in enumerate(idx))
        if grey and colors == 2 and rle:  # "P" raw mode for mode "1"
            raise PilValueError("unknown raw mode for given image mode")
        if not grey:
            if len(praw) // pad > 256:  # the palette's load, first
                raise PilValueError("invalid palette size")
            pal = GREY_PALETTE if indices else _palette(praw, pad)
        # the grey modes' raw modes: "1" (bits, whatever the depth) or
        # "L" (a byte a pixel, whatever the depth)
        raw = ("1" if colors == 2 else "L") if grey else raw
    offset = offset or min(pos, len(buf))
    if rows is not None:
        h = rows(h)
        if h == 0:  # the halved tile's load
            raise PilValueError("tile cannot extend outside image")
    if rle:
        idx = _bmp_rle(buf, offset, w, h, comp == 2)
        rows = idx if direction == 1 else idx[::-1]
        return "RGB", _grey3(rows) if grey else pal[rows]
    stride = ((w * bits + 31) >> 3) & ~3
    row = {"1": (w + 7) // 8, "L": w}.get(raw, (w * bits + 7) // 8)
    if mapped and raw in ("L", "P") and offset + h * stride <= len(buf):
        # the mapped file: each row from its place, zeros past the end
        data = bytes(buf[offset : offset + stride * (h - 1) + row])
        data = data.ljust(stride * (h - 1) + row, b"\0")
    else:
        if stride < row:
            raise OSError("bad configuration")
        data = buf[offset : offset + stride * (h - 1) + row]
        if len(data) < stride * (h - 1) + row:
            raise OSError("image file is truncated")
    span = stride * (h - 1) + row
    rows = np.lib.stride_tricks.as_strided(
        np.frombuffer(bytes(data)[:span], np.uint8), (h, row), (stride, 1))
    if direction == -1:
        rows = rows[::-1]
    if raw == "1":
        return "RGB", _grey3(_bits(np.ascontiguousarray(rows), 1, w) * 255)
    if raw == "L":
        return "RGB", _grey3(rows[:, :w])
    if bits <= 8:
        idx = rows[:, :w] if bits == 8 else _bits(np.ascontiguousarray(rows),
                                                  bits, w)
        return "RGB", pal[idx]
    if bits == 16:
        v = rows[:, : 2 * w].copy().view("<u2").astype(np.int32)
        if raw == "BGR;16":
            r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
            rgb = np.stack([r * 255 // 31, g * 255 // 63, b * 255 // 31], -1)
        else:
            r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
            rgb = np.stack([r * 255 // 31, g * 255 // 31, b * 255 // 31], -1)
        return "RGB", rgb.astype(np.uint8)
    px = np.ascontiguousarray(rows[:, : w * bits // 8]).reshape(
        h, w, bits // 8)
    order = raw[:4] if bits == 32 else raw
    rgb = np.stack([px[..., order.index(c)] for c in "RGB"], -1)
    return "RGB", np.ascontiguousarray(rgb)


def _bmp_rle(buf, offset, w, h, rle4):
    """BmpRleDecoder's walk: (h, w) uint8 indices in file row order."""
    data = bytearray()
    x = 0
    pos = offset
    n = len(buf)
    dest = w * h
    while len(data) < dest:
        if pos + 2 > n:
            break
        count, byte = buf[pos], buf[pos + 1]
        pos += 2
        if count:
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                data += (pair * ((count + 1) // 2))[:count]
            else:
                data += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            data += b"\0" * ((-len(data)) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: Pillow reads two bytes, then two more
            if pos + 2 > n:
                break
            pos += 2
            right, up = buf[pos : pos + 2] if pos + 2 <= n else (0, 0)
            if pos + 2 > n:
                raise PilValueError("not enough values to unpack")
            pos += 2
            data += b"\0" * (right + up * w)
            x = len(data) % w
        else:  # absolute run
            if rle4:
                got = buf[pos : pos + byte // 2]
                pos += len(got)
                for v in got:
                    data += bytes([v >> 4, v & 15])
                short = len(got) < byte // 2
            else:
                got = buf[pos : pos + byte]
                pos += len(got)
                data += got
                short = len(got) < byte
            if short:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(data) < dest:
        raise PilValueError("not enough image data")
    return np.frombuffer(bytes(data[:dest]), np.uint8).reshape(h, w)


# -- PNM --------------------------------------------------------------------

_PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
              b"P6": "RGB"}


class _Reader:
    def __init__(self, buf, pos=0):
        self.buf, self.pos = buf, pos

    def read1(self):
        c = self.buf[self.pos : self.pos + 1]
        self.pos += len(c)
        return c


def pnm_magic(buf):
    """PpmImageFile._read_magic: up to 6 bytes before whitespace."""
    r = _Reader(buf)
    magic = b""
    for _ in range(6):
        c = r.read1()
        if not c or c in _WS:
            break
        magic += c
    return magic, r


def _token(r):
    token = b""
    while len(token) <= 10:
        c = r.read1()
        if not c:
            break
        if c in _WS:
            if not token:
                continue
            break
        if c == b"#":
            while r.read1() not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise PilValueError("Reached EOF while reading header")
    if len(token) > 10:
        raise PilValueError(f"Token too long in file header: {token!r}")
    return token


def _int(token):
    try:
        return int(token)
    except ValueError as e:
        raise PilValueError(str(e)) from e


def read_pnm(buf):
    """A P1-P6 file as Pillow opens it: ("RGB", (H, W, 3)) for modes 1, L
    and RGB (their ``convert("RGB")``), ("I", (H, W) int32) for a PGM of
    maxval above 255."""
    magic, r = pnm_magic(buf)
    mode = _PNM_MODES[magic]
    w, h = _int(_token(r)), _int(_token(r))
    if w <= 0 or h <= 0:
        raise Unidentified("PNM: an empty image size")
    if w * h > 178956970:
        raise DecompressionBomb(f"PNM: image size {w}x{h}")
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        if plain:
            bits = _plain_bitonal(buf[r.pos :], w * h)
        else:
            stride = (w + 7) // 8
            data = buf[r.pos : r.pos + stride * h]
            if len(data) < stride * h:
                raise OSError("image file is truncated")
            rows = np.frombuffer(bytes(data), np.uint8).reshape(h, stride)
            bits = np.unpackbits(rows, axis=1)[:, :w].reshape(-1)
        return "RGB", _grey3(np.where(bits.reshape(h, w) != 0, 0, 255))
    maxval = _int(_token(r))
    if not 0 < maxval < 65536:
        raise PilValueError("maxval must be greater than 0 and less than "
                            "65536")
    if maxval > 255 and mode == "L":
        mode = "I"
    bands = 3 if mode == "RGB" else 1
    out_max = 65535 if mode == "I" else 255
    n = w * h * bands
    if plain:
        vals = _plain_values(buf[r.pos :], n, maxval)
        vals = np.round(vals / maxval * out_max)
    elif maxval == 255 or (maxval == 65535 and mode == "I"):
        size = 1 if maxval == 255 else 2
        data = buf[r.pos : r.pos + n * size]
        if len(data) < n * size:
            raise OSError("image file is truncated")
        vals = np.frombuffer(bytes(data), np.uint8 if size == 1 else ">u2")
    else:  # PpmDecoder: rescale each sample
        size = 1 if maxval < 256 else 2
        data = buf[r.pos :]
        k = len(data) // (size * bands) * bands
        if k < n:
            raise PilValueError("not enough image data")
        vals = np.frombuffer(bytes(data[: n * size]),
                             np.uint8 if size == 1 else ">u2")
        vals = np.minimum(out_max, np.round(vals / maxval * out_max))
    if mode == "I":
        return "I", vals.astype(np.int32).reshape(h, w)
    vals = vals.astype(np.uint8)
    if mode == "L":
        return "RGB", _grey3(vals.reshape(h, w))
    return "RGB", vals.reshape(h, w, 3)


def _strip_comments(data):
    """PpmPlainDecoder's comment removal: from '#' to the next CR or LF
    (or the end)."""
    out = bytearray()
    i = 0
    while True:
        j = data.find(b"#", i)
        if j < 0:
            out += data[i:]
            return bytes(out)
        out += data[i:j]
        ends = [k for k in (data.find(b"\n", j), data.find(b"\r", j))
                if k >= 0]
        if not ends:
            return bytes(out)
        i = min(ends) + 1


def _plain_bitonal(data, n):
    tokens = b"".join(_strip_comments(bytes(data)).split())
    for t in set(tokens[:n]):
        if t not in (48, 49):
            raise PilValueError(f"Invalid token for this mode: "
                                f"{bytes([t])!r}")
    if len(tokens) < n:
        raise PilValueError("not enough image data")
    return np.frombuffer(tokens[:n], np.uint8) - 48


def _plain_values(data, n, maxval):
    tokens = _strip_comments(bytes(data)).split()[:n]
    for t in tokens:
        if len(t) > 10:
            raise PilValueError(f"Token too long found in data: {t[:11]!r}")
    vals = np.array([_int(t) for t in tokens], np.float64)
    if (vals < 0).any():
        raise PilValueError("Channel value is negative")
    if (vals > maxval).any():
        raise PilValueError("Channel value too large for this mode")
    if len(vals) < n:
        raise PilValueError("not enough image data")
    return vals


# -- GIF --------------------------------------------------------------------

_LIB = None
_LIB_LOCK = threading.Lock()


def _lzw():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = hostbuild.load("lzwdec")
            lib.gif_lzw_decode.restype = ctypes.c_int
            lib.gif_lzw_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t)]
            _LIB = lib
        return _LIB


def _needed(p):
    """GifImageFile._is_palette_needed: not the grey ramp."""
    q = np.frombuffer(bytes(p[: len(p) // 3 * 3]), np.uint8).reshape(-1, 3)
    ramp = np.arange(len(q))
    return bool(((q != ramp[:, None])).any()) or len(p) % 3 != 0


def _interlace_rows(h):
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                           np.arange(2, h, 4), np.arange(1, h, 2)])


def read_gif(buf, indices=False):
    """A GIF's first frame as Pillow opens and converts it: ("RGB",
    (H, W, 3)); `indices`: its indices in each channel."""
    if len(buf) < 13:
        raise Unidentified("GIF: header cut off")
    w, h = _u16(buf, 6), _u16(buf, 8)
    flags = buf[10]
    pos = 13
    global_pal = None
    if flags & 128:
        p = buf[pos : pos + (3 << ((flags & 7) + 1))]
        pos += len(p)
        if _needed(p):
            global_pal = p
    r = _Reader(buf, pos)

    def data():  # GifImageFile.data: one sub-block, None at a 0 size
        n = r.read1()
        if n and n[0]:
            got = r.buf[r.pos : r.pos + n[0]]
            r.pos += len(got)
            return got
        return None

    transparency = None
    frame = None
    s = r.read1()
    while True:  # GifImageFile._seek(0)'s walk to the first image
        if not s:
            s = r.read1()
        if not s or s == b";":
            break
        if s == b"!":
            label = r.read1()
            block = data()
            if label == b"\xf9" and block is not None:
                if block[0] & 1:
                    transparency = block[3]
            elif label == b"\xfe":
                while block:
                    block = data()
                s = b""
                continue
            elif label == b"\xff" and block is not None and \
                    block.startswith(b"NETSCAPE2.0"):
                data()
            while data():
                pass
        elif s == b",":
            d = r.buf[r.pos : r.pos + 9]
            r.pos += 9
            if len(d) < 9:
                raise Unidentified("GIF: image descriptor cut off")
            x0, y0 = _u16(d, 0), _u16(d, 2)
            fw, fh = _u16(d, 4), _u16(d, 6)
            f = d[8]
            pal = global_pal
            if f & 128:
                p = r.buf[r.pos : r.pos + (3 << ((f & 7) + 1))]
                r.pos += len(p)
                pal = p if _needed(p) else None
            bits = r.read1()
            if not bits:
                raise Unidentified("GIF: image data missing")
            frame = (x0, y0, fw, fh, bool(f & 64), pal, bits[0])
            pos = r.pos
            break
        s = b""
    if frame is None:
        raise Unidentified("image not found in GIF frame")
    x0, y0, fw, fh, interlace, pal, bits = frame
    W, H = max(w, x0 + fw), max(h, y0 + fh)
    if W <= 0 or H <= 0:
        raise Unidentified("GIF: empty image")
    if bits > 12:
        raise PilValueError("bits must be between 0 and 12")
    canvas = np.full((H, W), transparency or 0, np.uint8)
    if fw > 0 and fh > 0:
        data = bytes(buf[pos:])
        out = np.zeros(fw * fh, np.uint8)
        written = ctypes.c_size_t(0)
        status = _lzw().gif_lzw_decode(data, len(data), bits,
                                       out.ctypes.data, out.size,
                                       ctypes.byref(written))
        if status == 2:
            raise OSError("broken data stream when reading image file")
        if status == 1:
            raise OSError("image file is truncated")
        rows = _interlace_rows(fh) if interlace else np.arange(fh)
        canvas[y0 + rows, x0 : x0 + fw] = out.reshape(fh, fw)
    if pal is None or indices:
        return "RGB", _grey3(canvas)
    return "RGB", _palette(pal, -3)[canvas]
