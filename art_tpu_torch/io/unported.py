"""The formats Pillow 12.1.0 opens past those the port reads by their
magic, and which of them a file is, decided as ``Image.open`` decides
it.

``Image.open`` walks its plugins in the order of ``Image.ID``. A plugin
whose accept test passes on the file's first 16 bytes, or which has
none, runs its ``_open``: a parse of the header (and, for ICO, a decode
of the largest icon). Where that raises IndexError, TypeError, KeyError,
EOFError, struct.error or SyntaxError, or leaves no mode or an empty
size, the walk goes on to the next plugin. Any other error leaves
``Image.open`` as it is, and the reference's ``load_std_image`` tries its
external loader only for an OSError. A header that parses opens the
image, unless its size passes twice ``Image.MAX_IMAGE_PIXELS``
(DecompressionBombError).

`walk` makes the same walk over `WALK`, each ``_open`` mirrored here
over the file's bytes: the plugin's header checks, reads and seeks, as a
file opened for reading makes them (a seek before the start fails with
OSError, a read of a negative length other than -1 with ValueError). It
returns the format that opens and the port's load of it (None for a
format in `FORMATS`, which the port refuses by name), or None where none
opens; the errors Pillow lets out come out as `Unidentified` (an
OSError), `PilValueError` (a ValueError), `DecompressionBomb` or
`OpenError` (any other). The formats the port decodes by their magic
(BMP, GIF, JPEG, PNG, PNM's P1-P6 and TIFF) are read before this walk
and are not in it; the walk's own decoded formats load where it opens
them: DIB, CUR, PCX, DCX, ICO, PSD, QOI, SGI and TGA
(:mod:`art_tpu_torch.io.rasterformats`); FITS, FLI, FTEX, GBR, IM, IMT,
IPTC/NAA, McIdas, MSP, PCD, PIXAR, PFM, the PNM extensions, SPIDER,
SUN, XBM, XPM and XVThumb (:mod:`art_tpu_torch.io.plugins`, each open
leaving its tile in the file's ``tile``); BLP, DDS and ICNS
(:mod:`art_tpu_torch.io.textures`, their opens leaving the decoder's
state, DDS's data start and ICNS's blocks likewise); WebP
(:mod:`art_tpu_torch.io.webpdec`, whose open is libwebp's parse, made
in its load); and JPEG 2000 (:mod:`art_tpu_torch.io.jpeg2000`, its open
leaving the codec and a P image's palette). `FORMATS` holds the rest:
AVIF, refused by name, and the formats of `LOAD_FAILS`, whose load
always fails in Pillow (BUFR, GRIB and HDF5 stubs, WMF/EMF, MPEG, EPS
with no Ghostscript).

Not mirrored: the coded data that AVIF's open parses with libavif. Its
container is checked (boxes whole, the image's boxes present), not what
libavif checks inside them. ICO's open decodes its largest icon: a PNG
icon goes through the port's PNG reader, a bitmap icon through its
load in ``stdformats.read_bitmap`` after the checks of its mask's or
alpha's length.
"""

from __future__ import annotations

import math
import os
import re
import struct
import zlib

import numpy as np

from art_tpu_torch.io.stdformats import (DecompressionBomb, PilValueError,
                                         Unidentified)


class OpenError(Exception):
    """Pillow's ``Image.open`` raises an error that is neither an OSError
    nor a ValueError here (ZeroDivisionError, AttributeError, a failed
    assert, NotImplementedError): the reference fails with no loader."""


_BOMB_PIXELS = 178956970  # twice Image.MAX_IMAGE_PIXELS
# the errors after which Image.open tries the next plugin
_NEXT = (IndexError, TypeError, KeyError, EOFError, struct.error, SyntaxError)


class _File:
    """A file's bytes read as Pillow's plugins read a file opened "rb".
    With the file's `path`, a seek past its end is made on the file too:
    the file system refuses one past its largest file (EINVAL)."""

    def __init__(self, buf, path=None):
        self.buf = buf if isinstance(buf, bytes) else bytes(buf)
        self.pos, self.path = 0, path
        # what an open leaves for its format's load: the tile (offset,
        # raw mode, ...) and the header's state Pillow's load reads
        self.tile = None

    def read(self, n=-1):
        if n < -1:
            raise PilValueError("read length must be non-negative or -1")
        out = self.buf[self.pos :] if n == -1 else \
            self.buf[self.pos : self.pos + n]
        self.pos += len(out)
        return out

    def seek(self, off, whence=0):
        base = (0, self.pos, len(self.buf))[whence]
        if base + off < 0:
            raise Unidentified("[Errno 22] Invalid argument")
        if base + off >= 1 << 63:
            raise PilValueError("cannot fit 'int' into an offset-sized "
                                "integer")
        if self.path is not None and base + off > len(self.buf):
            try:
                fd = os.open(self.path, os.O_RDONLY)
            except OSError:
                pass
            else:
                try:
                    os.lseek(fd, base + off, os.SEEK_SET)
                except OSError as e:
                    raise Unidentified(str(e)) from e
                finally:
                    os.close(fd)
        self.pos = base + off

    def tell(self):
        return self.pos

    def readline(self):
        end = self.buf.find(b"\n", self.pos)
        out = self.buf[self.pos : len(self.buf) if end < 0 else end + 1]
        self.pos += len(out)
        return out


def _i16(b, o=0):
    return struct.unpack_from("<H", b, o)[0]


def _i32(b, o=0):
    return struct.unpack_from("<I", b, o)[0]


def _i16be(b, o=0):
    return struct.unpack_from(">H", b, o)[0]


def _i32be(b, o=0):
    return struct.unpack_from(">I", b, o)[0]


def _i8(c):
    return c[0]


# -- the plugins' opens, each returning (mode, size) ----------------------

def _avif(f):
    """libavif's parse as far as its boxes: the top-level boxes, each
    whole, read up to the meta box (libavif stops there for an image),
    ftyp among them with an AVIF brand, and the meta box's own boxes
    whole (a box cut short fails the parse: the next plugin) holding the
    primary item's (without them libavif finds no image item, which
    Pillow raises as RuntimeError)."""
    buf, pos, n = f.buf, 0, len(f.buf)
    ftyp = None
    while True:
        kind, start, end = _iso_boxes(buf, pos, n, one=True)[0]
        if kind == b"ftyp" and ftyp is None:
            brands = {buf[i : i + 4] for i in range(start, end - 3, 4)
                      if i != start + 4}
            if not {b"avif", b"avis"} & brands:
                raise SyntaxError("AVIF: invalid ftyp")
            ftyp = True
        if kind == b"meta":
            break
        pos = end
    if ftyp is None:
        raise SyntaxError("AVIF: invalid ftyp")
    inner = {k for k, _, _ in _iso_boxes(buf, start + 4, end)}
    if not {b"hdlr", b"pitm", b"iloc", b"iinf", b"iprp"} <= inner:
        raise OpenError("AVIF: RuntimeError: Missing or empty image item")
    return "RGB", (1, 1)


def _iso_boxes(buf, pos, end, one=False):
    """(type, payload start, payload end) of the whole boxes from `pos`
    (only the first where `one`); SyntaxError where one runs past `end`."""
    out = []
    while pos < end or one and not out:
        if end - pos < 8:
            raise SyntaxError("box header cut off")
        size, kind = struct.unpack_from(">I4s", buf, pos)
        head = 8
        if size == 1:
            if end - pos < 16:
                raise SyntaxError("box header cut off")
            size, head = struct.unpack_from(">Q", buf, pos + 8)[0], 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise SyntaxError("box cut off")
        out.append((kind, pos + head, pos + size))
        if one:
            break
        pos += size
    return out


def _blp(f):
    magic = f.read(4)
    if not magic.startswith((b"BLP1", b"BLP2")):
        raise SyntaxError("Bad BLP magic")
    (compression,) = struct.unpack("<i", f.read(4))
    encoding = alpha_encoding = None
    if magic == b"BLP1":
        alpha = struct.unpack("<I", f.read(4))[0] != 0
    else:
        (encoding,) = struct.unpack("<b", f.read(1))
        alpha = struct.unpack("<b", f.read(1))[0] != 0
        (alpha_encoding,) = struct.unpack("<b", f.read(1))
        f.seek(1, 1)
    size = struct.unpack("<II", f.read(8))
    if magic == b"BLP1":
        (encoding,) = struct.unpack("<i", f.read(4))
    # the load's decoder, from the tile's offset
    f.tile = (magic, 28 if magic == b"BLP1" else 20, compression, encoding,
              alpha, alpha_encoding)
    return ("RGBA" if alpha else "RGB"), size


_BIT2MODE = {1: "P", 4: "P", 8: "P", 16: "RGB", 24: "RGB", 32: "RGB"}
_MASKS = {32: [(0xFF0000, 0xFF00, 0xFF, 0x0),
               (0xFF000000, 0xFF0000, 0xFF00, 0x0),
               (0xFF000000, 0xFF00, 0xFF, 0x0),
               (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
               (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
               (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
               (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)],
          24: [(0xFF0000, 0xFF00, 0xFF)],
          16: [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)]}


def _safe_read(f, size):
    if size <= 0:
        return b""
    data = f.read(size)
    if len(data) < size:
        raise Unidentified("Truncated File Read")
    return data


def _bitmap(f, header=0, offset=0):
    """BmpImageFile._bitmap: (mode, size, (data offset, stride, row
    bytes, compression)); the mode only as far as open tells modes apart
    (a palette's, grey or not, else "RGB")."""
    if header:
        f.seek(header)
    hsize = _i32(f.read(4))
    data = _safe_read(f, hsize - 4)
    colors = 0
    if hsize == 12:
        w, h = _i16(data, 0), _i16(data, 2)
        _i16(data, 4)
        bits, comp, pad = _i16(data, 6), 0, 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        flip = data[7] == 0xFF
        w = _i32(data, 0)
        h = 2 ** 32 - _i32(data, 4) if flip else _i32(data, 4)
        _i16(data, 8)
        bits, comp = _i16(data, 10), _i32(data, 12)
        _i32(data, 16), _i32(data, 20), _i32(data, 24)
        colors, pad = _i32(data, 28), 4
        if comp == 3:
            if len(data) >= 48:
                n = 4 if len(data) >= 52 else 3
                masks = [_i32(data, 36 + 4 * i) for i in range(n)]
                masks += [0] * (4 - n)
            else:
                masks = [_i32(f.read(4)) for _ in range(3)] + [0]
    else:
        raise Unidentified(f"Unsupported BMP header type ({hsize})")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    mode = _BIT2MODE.get(bits)
    if mode is None:
        raise Unidentified(f"Unsupported BMP pixel depth ({bits})")
    if comp == 3:
        if not (bits == 32 and tuple(masks) in _MASKS[32]
                or bits in (24, 16) and tuple(masks[:3]) in _MASKS[bits]):
            raise Unidentified("Unsupported BMP bitfields layout")
    elif comp not in (0, 1, 2):
        raise Unidentified(f"Unsupported BMP compression ({comp})")
    if mode == "P":
        if not 0 < colors <= 65536:
            raise Unidentified(f"Unsupported BMP Palette size ({colors})")
        palette = f.read(pad * colors)
        idx = (0, 255) if colors == 2 else range(colors)
        grey = all(palette[i * pad : i * pad + 3] == bytes((v & 255,)) * 3
                   for i, v in enumerate(idx))
        if grey:
            mode = "1" if colors == 2 else "L"
    stride = ((w * bits + 31) >> 3) & ~3
    return mode, (w, h), (offset or f.tell(), stride, (w * bits + 7) // 8,
                          comp)


def _dib(f):
    return _bitmap(f)[:2]


def _stub(*magics):
    def open_(f):
        if not f.read(max(len(m) for m in magics)).startswith(magics):
            raise SyntaxError("not this stub format")
        return "F", (1, 1)
    return open_


def _grib(f):
    s = f.read(8)
    if not (len(s) >= 8 and s.startswith(b"GRIB") and s[7] == 1):
        raise SyntaxError("Not a GRIB file")
    return "F", (1, 1)


def cur_entry(f):
    """CurImageFile._open's pick: the 16-byte directory entry of the first
    cursor whose width and height bytes both pass the one picked before;
    the file left after the directory."""
    s = f.read(6)
    if not s.startswith(b"\0\0\2\0"):
        raise SyntaxError("not a CUR file")
    m = b""
    for _ in range(_i16(s, 4)):
        s = f.read(16)
        if not m:
            m = s
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise TypeError("No cursors were found")
    return m


def _cur(f):
    mode, (w, h), _ = _bitmap(f, _i32(cur_entry(f), 12))
    return mode, (w, h // 2)


def _pcx_accept(p):
    return len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5)


def _pcx(f):
    s = f.read(68)
    if not _pcx_accept(s):
        raise SyntaxError("not a PCX file")
    x0, y0, x1, y1 = _i16(s, 4), _i16(s, 6), _i16(s, 8) + 1, _i16(s, 10) + 1
    if x1 <= x0 or y1 <= y0:
        raise SyntaxError("bad PCX image size")
    version, bits, planes = s[1], s[3], s[65]
    _i16(s, 66), _i16(s, 12), _i16(s, 14)
    if bits == 1 and planes in (1, 2, 4):
        mode = "1" if planes == 1 else "P"
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        f.seek(-769, 2)
        s = f.read(769)
        if len(s) == 769 and s[0] == 12 and any(
                s[i * 3 + 1 : i * 3 + 4] != bytes((i,)) * 3
                for i in range(256)):
            mode = "P"
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise Unidentified("unknown PCX mode")
    return mode, (x1 - x0, y1 - y0)


def _dcx(f):
    s = f.read(4)
    if not (len(s) >= 4 and _i32(s) == 987654321):
        raise SyntaxError("not a DCX file")
    offsets = []
    for _ in range(1024):
        off = _i32(f.read(4))
        if not off:
            break
        offsets.append(off)
    if not offsets:
        raise EOFError("attempt to seek outside sequence")
    f.seek(offsets[0])
    return _pcx(f)


# the DXGI formats and FourCCs DDS's open takes: (mode, BCn's n or 0 for
# raw RGBA, signed)
_DXGI = {70: ("RGBA", 1, 0), 71: ("RGBA", 1, 0), 73: ("RGBA", 2, 0),
         74: ("RGBA", 2, 0), 76: ("RGBA", 3, 0), 77: ("RGBA", 3, 0),
         79: ("L", 4, 0), 80: ("L", 4, 0), 82: ("RGB", 5, 0),
         83: ("RGB", 5, 0), 84: ("RGB", 5, 1), 95: ("RGB", 6, 0),
         96: ("RGB", 6, 1), 97: ("RGBA", 7, 0), 98: ("RGBA", 7, 0),
         99: ("RGBA", 7, 0), 27: ("RGBA", 0, 0), 28: ("RGBA", 0, 0),
         29: ("RGBA", 0, 0)}
_FOURCC = {827611204: ("RGBA", 1, 0), 861165636: ("RGBA", 2, 0),
           894720068: ("RGBA", 3, 0), 1429488450: ("L", 4, 0),
           826889281: ("L", 4, 0), 1395999554: ("RGB", 5, 1),
           1429553986: ("RGB", 5, 0), 843666497: ("RGB", 5, 0)}


def _dds(f):
    """DdsImageFile._open; the tile left for the load: ("rgb", bitcount,
    masks), ("raw", raw mode) or ("bcn", n, signed), then the offset the
    open stopped reading at (the load's ``load_seek`` does nothing, so
    its data starts there) and a P image's palette."""
    if not f.read(4).startswith(b"DDS "):
        raise SyntaxError("not a DDS file")
    (hsize,) = struct.unpack("<I", f.read(4))
    if hsize != 124:
        raise Unidentified(f"Unsupported header size {hsize!r}")
    header = f.read(hsize - 4)
    if len(header) != 120:
        raise Unidentified(f"Incomplete header: {len(header)} bytes")
    _, h, w = struct.unpack("<3I", header[:12])
    _, pfflags, fourcc, bitcount = struct.unpack("<4I", header[68:84])
    palette = None
    if pfflags & 64:  # DDPF.RGB
        mode = "RGBA" if pfflags & 1 else "RGB"
        n = len(mode)
        masks = struct.unpack(f"<{n}I", header[84 : 84 + 4 * n])
        f.tile = (("rgb", bitcount, masks), f.tell(), None)
        return mode, (w, h)
    if pfflags & 131072:  # DDPF.LUMINANCE
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & 1:
            mode = "LA"
        else:
            raise Unidentified(f"Unsupported bitcount {bitcount}")
        kind = ("raw", mode)
    elif pfflags & 32:  # DDPF.PALETTEINDEXED8
        mode, kind = "P", ("raw", "P")
        palette = f.read(1024)
    elif pfflags & 4:  # DDPF.FOURCC
        if fourcc == 808540228:  # DX10
            (dxgi,) = struct.unpack("<I", f.read(4))
            f.read(16)
            if dxgi not in _DXGI:
                raise OpenError(f"DDS: Unimplemented DXGI format {dxgi}")
            mode, n, sign = _DXGI[dxgi]
            kind = ("bcn", n, sign) if n else ("raw", mode)
        elif fourcc in _FOURCC:
            mode, n, sign = _FOURCC[fourcc]
            kind = ("bcn", n, sign)
        else:
            raise OpenError(f"DDS: Unimplemented pixel format {fourcc!r}")
    else:
        raise OpenError(f"DDS: Unknown pixel format flags {pfflags}")
    f.tile = (kind, f.tell(), palette)
    return mode, (w, h)


_EPS_SPLIT = re.compile(r"^%%([^:]*):[ \t]*(.*)[ \t]*$")
_EPS_FIELD = re.compile(r"^%[%!\w]([^:]*)[ \t]*$")
_EPS_MODES = {1: "L", 2: "LAB", 3: "RGB", 4: "CMYK"}
_EPS_EOL = re.compile(rb"[\r\n]")


def _eps(f):
    """EpsImageFile._open: its walk over the header and trailer comments,
    a run of bytes between line ends at a time."""
    s = f.read(4)
    if s == b"%!PS":
        offset = 0
    elif _i32(s) == 0xC6D3D0C5:
        offset = _i32(f.read(8))
    else:
        raise SyntaxError("not an EPS file")
    f.seek(offset)
    buf, info, mode = f.buf, {}, "RGB"
    bbox = imagedata = None
    arr = bytearray(255)
    nread = 0
    header, trailer_comments, trailer = True, False, False

    def check():
        if "PS-Adobe" not in info:
            raise SyntaxError('EPS header missing "%!PS-Adobe" comment')
        if "BoundingBox" not in info:
            raise SyntaxError('EPS header missing "%%BoundingBox" comment')

    def comment(s):
        nonlocal bbox, trailer_comments
        m = _EPS_SPLIT.match(s)
        if not m:
            return False
        k, v = m.group(1, 2)
        info[k] = v
        if k == "BoundingBox":
            if v == "(atend)":
                trailer_comments = True
            elif not bbox or (trailer and trailer_comments):
                try:
                    bbox = [int(float(i)) for i in v.split()]
                except Exception:
                    pass
        return True

    while True:
        # a run of bytes up to a line end, as Pillow's reads of one byte
        # at a time add them to the line: a 256th byte starts the line
        # over, after the header check, where the line is no comment
        m = _EPS_EOL.search(buf, f.pos)
        end = m.start() if m else len(buf)
        run = memoryview(buf)[f.pos : end] if f.pos < end else b""
        i = 0
        while i < len(run):
            if nread >= 255:
                if arr[0] == 37:
                    raise SyntaxError("not an EPS file")
                if header:
                    check()
                    header = False
                nread = 0
            k = min(len(run) - i, 255 - nread)
            arr[nread : nread + k] = run[i : i + k]
            nread += k
            i += k
        f.pos = max(f.pos, end)
        byte = f.read(1)
        if byte == b"":
            if nread == 0:
                if header:
                    check()
                break
        elif nread == 0:
            continue
        mv = memoryview(arr)
        if header:
            if arr[0] != 37 or mv[:13] == b"%%EndComments":
                check()
                header = False
                continue
            s = str(mv[:nread], "latin-1")
            if not comment(s):
                m = _EPS_FIELD.match(s)
                if m:
                    k = m.group(1)
                    info["PS-Adobe" if k.startswith("PS-Adobe") else k] = \
                        k[9:] if k.startswith("PS-Adobe") else ""
                elif s[0] != "%":
                    raise Unidentified("bad EPS header")
        elif mv[:11] == b"%ImageData:":
            if imagedata:
                nread = 0
                continue
            values = arr[11:nread].split(None, 7)
            try:
                cols, rows, depth, mode_id = (int(v) for v in values[:4])
            except ValueError as e:
                raise PilValueError(str(e)) from e
            if depth == 1:
                mode = "1"
            elif depth == 8:
                mode = _EPS_MODES[mode_id]
            else:
                break
            imagedata = cols, rows
        elif mv[:5] == b"%%EOF":
            break
        elif trailer and trailer_comments:
            comment(str(mv[:nread], "latin-1"))
        elif mv[:9] == b"%%Trailer":
            trailer = True
        elif mv[:14] == b"%%BeginBinary:":
            try:
                count = int(arr[14:nread])
            except ValueError as e:
                raise PilValueError(str(e)) from e
            f.seek(count, 1)
        nread = 0
    if not bbox:
        raise Unidentified("cannot determine EPS bounding box")
    return mode, imagedata or (bbox[2] - bbox[0], bbox[3] - bbox[1])


def _int(v):
    try:
        return int(v)
    except ValueError as e:
        raise PilValueError(str(e)) from e


def _fits_size(headers, prefix):
    naxis = _int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _int(headers[prefix + b"NAXIS1"])
    return _int(headers[prefix + b"NAXIS1"]), _int(headers[prefix + b"NAXIS2"])


def _fits(f):
    headers = {}
    in_header = False
    parsed = None
    while True:
        card = f.read(80)
        if not card:
            raise Unidentified("Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break
        elif keyword == b"END":
            f.seek(math.ceil(f.tell() / 2880) * 2880)
            if parsed is None or not parsed[0]:
                parsed = _fits_parse(headers)
            in_header = False
            continue
        if parsed is not None and parsed[0]:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE")
                            or value != b"T"):
            raise SyntaxError("Not a FITS file")
        headers[keyword] = value
    if parsed is None or not parsed[0]:
        raise PilValueError("No image data")
    # the data start: the card that ended the walk read, backed off 80
    f.tile = (parsed[0], parsed[3] + f.tell() - 80, parsed[4])
    return parsed[1], parsed[2]


def _fits_parse(headers):
    """FitsImageFile._parse_headers: (decoder, mode, size, offset past
    the data start, the tile's args)."""
    prefix = b""
    decoder = "raw"
    offset = 0
    if headers.get(b"XTENSION") == b"'BINTABLE'" and \
            headers.get(b"ZIMAGE") == b"T" and \
            headers[b"ZCMPTYPE"] == b"'GZIP_1  '":
        table = _fits_size(headers, prefix) or (0, 0)
        offset = table[0] * table[1] * (_int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _fits_size(headers, prefix)
    if not size:
        return "", "", (0, 0), 0, ()
    bits = _int(headers[prefix + b"BITPIX"])
    mode = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}.get(bits, "")
    args = (mode, 0, -1) if decoder == "raw" else (bits,)
    return decoder, mode, size, offset, args


def _fli_accept(p):
    return len(p) >= 16 and _i16(p, 4) in (0xAF11, 0xAF12) \
        and _i16(p, 14) in (0, 3)


def _fli(f):
    s = f.read(128)
    if not (_fli_accept(s) and s[20:22] == b"\0\0" and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise SyntaxError("not an FLI/FLC file")
    frames = _i16(s, 6)
    size = _i16(s, 8), _i16(s, 10)
    _i32(s, 16)
    palette = [(a, a, a) for a in range(256)]
    s = f.read(16)
    if _i16(s, 4) == 0xF100:
        f.seek(128 + _i32(s))
        s = f.read(16)
    if _i16(s, 4) == 0xF1FA:
        chunk = None
        for _ in range(_i16(s, 6)):
            if chunk is not None:
                f.seek(chunk - 6, 1)
            s = f.read(6)
            if _i16(s, 4) in (4, 11):
                shift = 2 if _i16(s, 4) == 11 else 0
                i = 0
                for _ in range(_i16(f.read(2))):
                    s = f.read(2)
                    i += s[0]
                    n = s[1] or 256
                    s = f.read(n * 3)
                    for k in range(0, len(s), 3):
                        rgb = tuple((v << shift) & 255 for v in
                                    (s[k], s[k + 1], s[k + 2]))
                        if i >= 256:  # the palette's list of 256
                            raise IndexError("list index out of range")
                        palette[i] = rgb
                        i += 1
                break
            chunk = _i32(s)
            if not chunk:
                break
    if frames == 0:
        raise EOFError("attempt to seek outside sequence")
    f.seek(128)
    s = f.read(4)
    if not s:
        raise EOFError("missing frame size")
    f.tile = (palette, _i32(s))  # frame 0's size is the load's block
    return "P", size


def _ftex(f):
    if not f.read(4).startswith(b"FTEX"):
        raise SyntaxError("not an FTEX file")
    struct.unpack("<i", f.read(4))
    size = struct.unpack("<2i", f.read(8))
    _, count = struct.unpack("<2i", f.read(8))
    if count != 1:
        raise OpenError("FTEX: AssertionError (a format count other than 1)")
    fmt, where = struct.unpack("<2i", f.read(8))
    f.seek(where)
    (n,) = struct.unpack("<i", f.read(4))
    f.tile = (fmt, f.read(n))  # the load reads this mipmap only
    if fmt not in (0, 1):
        raise PilValueError(f"Invalid texture compression format: {fmt!r}")
    if size[0] <= 0 or size[1] <= 0:
        # the plugin has closed the file by now: Image.open's next plugin
        # (IM's, which has no accept test) cannot seek it
        raise PilValueError("seek of closed file")
    return ("RGBA" if fmt == 0 else "RGB"), size


def _gbr(f):
    hsize = _i32be(f.read(4))
    if hsize < 20:
        raise SyntaxError("not a GIMP brush")
    version = _i32be(f.read(4))
    if version not in (1, 2):
        raise SyntaxError(f"Unsupported GIMP brush version: {version}")
    w, h, depth = _i32be(f.read(4)), _i32be(f.read(4)), _i32be(f.read(4))
    if w == 0 or h == 0:
        raise SyntaxError("not a GIMP brush")
    if depth not in (1, 4):
        raise SyntaxError(f"Unsupported GIMP brush color depth: {depth}")
    if version == 1:
        n = hsize - 20
    else:
        n = hsize - 28
        if f.read(4) != b"GIMP":
            raise SyntaxError("not a GIMP brush, bad magic number")
        _i32be(f.read(4))
    f.read(n)
    _bomb((w, h))
    f.tile = f.tell()  # the load reads its samples from here
    return ("L" if depth == 1 else "RGBA"), (w, h)


def _memory():
    """This machine's RAM, in bytes."""
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


class _Boxes:
    """Jpeg2KImagePlugin.BoxReader."""

    def __init__(self, f, length=-1):
        self.f, self.has_length, self.length = f, length >= 0, length
        self.left = -1

    def can_read(self, n):
        if self.has_length and self.f.tell() + n > self.length:
            return False
        return n <= self.left if self.left >= 0 else True

    def read_bytes(self, n):
        if not self.can_read(n):
            raise SyntaxError("Not enough data in header")
        if n > _memory():
            # a file's read of n bytes allocates them first: Linux refuses
            # one allocation past its RAM (and swap: MemoryError)
            raise OpenError(f"MemoryError: a read of {n} bytes")
        data = self.f.read(n)
        if len(data) < n:
            raise Unidentified(f"Expected to read {n} bytes but only got "
                               f"{len(data)}.")
        if self.left > 0:
            self.left -= n
        return data

    def fields(self, fmt):
        return struct.unpack(fmt, self.read_bytes(struct.calcsize(fmt)))

    def boxes(self):
        size = self.left
        return _Boxes(_File(self.read_bytes(size)), size)

    def has_next(self):
        return self.f.tell() + self.left < self.length if self.has_length \
            else True

    def next_type(self):
        if self.left > 0:
            self.f.seek(self.left, 1)
        self.left = -1
        lbox, tbox = self.fields(">I4s")
        head = 8
        if lbox == 1:
            lbox, head = self.fields(">Q")[0], 16
        if lbox < head or not self.can_read(lbox - head):
            raise SyntaxError("Invalid header length")
        self.left = lbox - head
        return tbox


def _j2k_codestream(f):
    hdr = f.read(2)
    lsiz = _i16be(hdr)
    siz = hdr + f.read(lsiz - 2)
    _, _, xsiz, ysiz, xo, yo, _, _, _, _, csiz = struct.unpack_from(
        ">HHIIIIIIIIH", siz)
    if csiz == 1:
        mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
        struct.unpack_from(">B", siz, 38)
    elif csiz in (2, 3, 4):
        mode = ("LA", "RGB", "RGBA")[csiz - 2]
    else:
        raise SyntaxError("unable to determine J2K image mode")
    return (xsiz - xo, ysiz - yo), mode


def _j2k_comment(f):
    while True:
        marker = f.read(2)
        if not marker:
            break
        typ = marker[1]
        if typ in (0x90, 0xD9):
            break
        length = _i16be(f.read(2))
        if typ == 0x64:
            f.read(length - 2)
            break
        f.seek(length - 2, 1)


def _jp2_header(f):
    reader = _Boxes(f)
    while True:  # a box reader with no length always has a next box
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.boxes()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    size = mode = None
    nc = None
    palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            h, w, nc, bpc = header.fields(">IIHB")
            size = (w, h)
            mode = {1: "I;16" if (bpc & 0x7F) > 8 else "L", 2: "LA",
                    3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr" and nc == 4:
            meth, _, _, cs = header.fields(">BBBI")
            if meth == 1 and cs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            if max([0, *header.fields(">" + "B" * npc)]) <= 8:
                # ImagePalette.getcolor of each entry: a new colour at
                # the palette's length over the mode's (RGB, or RGBA for
                # four values), its bytes put there
                colors, raw = {}, bytearray()
                step = 4 if npc == 4 else 3
                for _ in range(ne):
                    c = header.fields(">" + "B" * npc)
                    if c not in colors:
                        index = len(raw) // step
                        if index >= 256:
                            raise PilValueError(
                                "cannot allocate more than 256 colors")
                        colors[c] = index
                        if index * step < len(raw):
                            raw[index * step : index * step + step] = \
                                bytes(c)
                        else:
                            raw += bytes(c)
                palette = _jp2_palette(bytes(raw), npc)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.boxes()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    return size, mode, palette


def _jp2_palette(raw, npc):
    """The (256, 3) palette a P image converts to RGB through once the
    load has put the palette's bytes: RGB entries (RGBA for four values a
    colour), black past them."""
    step = 4 if npc == 4 else 3
    pal = np.zeros((256, 3), np.uint8)
    n = min(256, len(raw) // step)
    if n:
        pal[:n] = np.frombuffer(raw[: n * step], np.uint8).reshape(
            n, step)[:, :3]
    return pal


J2K_SOC_SIZ = b"\xff\x4f\xff\x51"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"


def is_jpeg2000(prefix, icns=False):
    """Jpeg2KImagePlugin's ``_accept``: a codestream's SOC and SIZ, or the
    JP2 signature box. With `icns`, IcnsImagePlugin's test of an icon's
    first 12 bytes, which also takes the signature box's last 4 bytes at
    the start."""
    return prefix.startswith((J2K_SOC_SIZ, JP2_SIGNATURE)) or (
        icns and prefix.startswith(JP2_SIGNATURE[8:]))


def _jpeg2000(f):
    """Jpeg2KImageFile's open; the tile keeps the codec ("j2k" or "jp2")
    and the palette of a P or PA image (else None) for the load."""
    sig = f.read(4)
    if sig == J2K_SOC_SIZ:
        size, mode = _j2k_codestream(f)
        _j2k_comment(f)
        f.tile = ("j2k", None)
        return mode, size
    sig += f.read(8)
    if sig != JP2_SIGNATURE:
        raise SyntaxError("not a JPEG 2000 file")
    size, mode, palette = _jp2_header(f)
    f.tile = ("jp2", palette)
    if f.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
        length = _i16be(f.read(2))
        f.seek(length - 2, 1)
        _j2k_comment(f)
    return mode, size


# IcnsFile.SIZES: (width, height, scale) and the blocks that give it
_ICNS_SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",),
    (256, 256, 2): (b"ic14",), (256, 256, 1): (b"ic08",),
    (128, 128, 2): (b"ic13",), (128, 128, 1): (b"ic07", b"it32", b"t8mk"),
    (64, 64, 1): (b"icp6",), (32, 32, 2): (b"ic12",),
    (48, 48, 1): (b"ih32", b"h8mk"), (32, 32, 1): (b"icp5", b"il32", b"l8mk"),
    (16, 16, 2): (b"ic11",), (16, 16, 1): (b"icp4", b"is32", b"s8mk")}


def _icns(f):
    """IcnsFile: each block's (start, length) by its code (the last of a
    code kept) in the tile, for the load."""
    sig, filesize = struct.unpack(">4sI", f.read(8))
    if not sig.startswith(b"icns"):
        raise SyntaxError("not an icns file")
    blocks = {}
    i = 8
    while i < filesize:
        sig, size = struct.unpack(">4sI", f.read(8))
        if size <= 0:
            raise SyntaxError("invalid block header")
        i += 8
        size -= 8
        blocks[sig] = (i, size)
        f.seek(size, 1)
        i += size
    sizes = [s for s, codes in _ICNS_SIZES.items() if set(blocks) & set(codes)]
    if not sizes:
        raise SyntaxError("No 32bit icon resources found")
    f.tile = (blocks, sizes)
    w, h, scale = max(sizes)
    return "RGBA", (w * scale, h * scale)


def ico_entry(f):
    """IcoFile's first entry, the icon the open loads: the entries sorted
    by colour depth, then stably by area, largest first; (bpp, bytes,
    offset)."""
    s = f.read(6)
    if not s.startswith(b"\0\0\1\0"):
        raise SyntaxError("not an ICO file")
    entries = []
    for _ in range(_i16(s, 4)):
        s = f.read(16)
        w, h, ncolor = s[0] or 256, s[1] or 256, s[2]
        bpp = _i16(s, 6)
        s[3], _i16(s, 4)
        depth = bpp or (ncolor != 0 and math.ceil(math.log(ncolor, 2))) or 256
        entries.append((w * h, depth, bpp, _i32(s, 8), _i32(s, 12)))
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    return entries[0][2:]


def _ico(f):
    bpp, size, offset = ico_entry(f)
    f.seek(offset)
    head = f.read(8)
    f.seek(offset)
    if head == b"\x89PNG\r\n\x1a\n":  # through the port's PNG reader
        from art_tpu_torch.io import imagefile

        try:
            samples = imagefile._read_png(f.buf[offset:])[0]
        except (Unidentified, SyntaxError) as e:
            raise SyntaxError(str(e)) from e
        except PilValueError:
            raise
        except (OSError, IndexError, struct.error, zlib.error,
                ValueError) as e:
            raise Unidentified(f"broken PNG icon: {e}") from e
        shape = samples.shape[1], samples.shape[0]
        _bomb(shape)
        return "RGBA", shape
    mode, (w, h), (data, stride, row, comp) = _bitmap(f)
    if w <= 0 or h <= 0:
        raise SyntaxError("an icon of no size")
    _bomb((w, h))
    h = int(h / 2)
    if bpp == 32:  # its alpha: every fourth byte of its data
        f.seek(data)
        if len(f.read(w * h * 4)[3::4]) < w * h:
            raise PilValueError("buffer is not large enough")
    else:  # the AND mask after its data, rows of 32-bit words
        w32 = w + (32 - w % 32) % 32
        total = int((w32 * h) / 8)
        f.seek(offset + size - total)
        if len(f.read(total)) < int(w32 / 8) * (h - 1) + (w + 7) // 8:
            raise PilValueError("not enough image data")
    # the open loads the bitmap (not mapped: it is read from the stream)
    from art_tpu_torch.io.stdformats import read_bitmap

    try:
        read_bitmap(f.buf, offset, rows=lambda n: int(n / 2), mapped=False)
    except (PilValueError, Unidentified):
        raise
    except OSError as e:
        raise Unidentified(str(e)) from e
    return "RGBA", (w, h)


_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = ("Comment", "Date", "Digitalization equipment",
            "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type")
# ImImagePlugin.OPEN: image type -> (mode, raw mode)
_IM_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = (f"I;{_i}",
                                                              f"I;{_i}")
_IM_OPEN["L 32S image"] = _IM_OPEN["L*32S image"] = ("I", "I;32S")
for _i in range(2, 33):
    _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")


def _im_number(s):
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError as e:
            raise PilValueError(str(e)) from e


def _im(f):
    if b"\n" not in f.read(100):
        raise SyntaxError("not an IM file")
    f.seek(0)
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode = "L"
    n = 0
    while True:
        s = f.read(1)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        s += f.readline()
        if len(s) > 100:
            raise SyntaxError("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else \
            s[:-1] if s.endswith(b"\n") else s
        m = _IM_SPLIT.match(s)
        if not m:
            raise SyntaxError("Syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)",
                 "Image size (x*y)"):
            v = tuple(map(_im_number, v.replace("*", ",").split(",")))
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in _IM_OPEN:
            v, rawmode = _IM_OPEN[v]
        info[k] = v
        if k in _IM_TAGS:
            n += 1
    if not n:
        raise SyntaxError("Not an IM file")
    size, mode = info["Image size (x*y)"], info["Image type"]
    while s and not s.startswith(b"\x1a"):
        s = f.read(1)
    if not s:
        raise SyntaxError("File truncated")
    palette = None
    if "Lut" in info:
        p = f.read(768)
        grey = True
        for i in range(256):
            if not p[i] == p[i + 256] == p[i + 512]:
                grey = False
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode, rawmode = ("P", "P") if mode in ("L", "P") else \
                ("PA", "PA;L")
            palette = p
    size[0], size[1]  # a scalar size is no size (TypeError)
    f.tile = (rawmode, f.tell(), palette)
    return mode, size


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt(f):
    buffer = f.read(100)
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    w = h = 0
    size, mode = (0, 0), ""
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = f.read(1)
        if not s:
            break
        if s == b"\x0c":
            f.tile = f.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += f.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            w = _int(v)
            size = w, h
        elif k == b"height":
            h = _int(v)
            size = w, h
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    return mode, size


def _iptc_int(c):
    return _i32be((b"\0\0\0\0" + c)[-4:])


def iptc_field(f):
    """IptcImageFile.field: (tag or None, size) of the field at the file's
    position, the file left at its data."""
    s = f.read(5)
    if not s.strip(b"\0"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise Unidentified("illegal field length in IPTC/NAA file")
    return tag, 0 if size == 128 else \
        _iptc_int(f.read(size - 128)) if size > 128 else _i16be(s, 3)


def _iptc(f):
    info = {}
    while True:
        offset = f.tell()
        tag, size = iptc_field(f)
        if not tag or tag == (8, 10):
            break
        data = f.read(size) if size else None
        if tag in info:
            info[tag] = (info[tag] if isinstance(info[tag], list)
                         else [info[tag]]) + [data]
        else:
            info[tag] = data
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode = ""
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        if (3, 65) in info:
            info[(3, 65)][0] - 1
    size = _iptc_int(info[(3, 20)]), _iptc_int(info[(3, 30)])
    try:
        compression = _iptc_int(info[(3, 120)])
        if compression not in (1, 5):
            raise KeyError
    except KeyError as e:
        raise Unidentified("Unknown IPTC image compression") from e
    if tag == (8, 10):  # the data's first field, where the load starts
        f.tile = (offset, compression, info)
    return mode, size


def _mcidas(f):
    s = f.read(256)
    if not s.startswith(b"\0\0\0\0\0\0\0\4") or len(s) != 256:
        raise SyntaxError("not an McIdas area file")
    w = [0, *struct.unpack("!64i", s)]
    if w[11] not in (1, 2, 4):
        raise SyntaxError("unsupported McIdas format")
    f.tile = w
    return {1: "L", 2: "I;16B", 4: "I"}[w[11]], (w[10], w[9])


def _mpeg(f):
    state = [0, 0]  # bits held, the bit buffer

    def read(n):
        while state[0] < n:
            state[1] = (state[1] << 8) + _i8(f.read(1))
            state[0] += 8
        v = state[1] >> (state[0] - n) & (1 << n) - 1
        state[0] -= n
        return v

    if read(32) != 0x1B3:
        raise SyntaxError("not an MPEG file")
    return "RGB", (read(12), read(12))


def _msp(f):
    s = f.read(32)
    if not s.startswith((b"DanM", b"LinS")):
        raise SyntaxError("not an MSP file")
    check = 0
    for i in range(0, 32, 2):
        check ^= _i16(s, i)
    if check:
        raise SyntaxError("bad MSP checksum")
    return "1", (_i16(s, 4), _i16(s, 6))


def _pcd(f):
    f.seek(2048)
    s = f.read(1539)
    if not s.startswith(b"PCD_"):
        raise SyntaxError("not a PCD file")
    f.tile = s[1538] & 3  # the orientation
    return "RGB", (512, 768) if s[1538] & 3 in (1, 3) else (768, 512)


def _pixar(f):
    s = f.read(4)
    if not s.startswith(b"\x80\xe8\0\0"):
        raise SyntaxError("not a PIXAR file")
    s += f.read(508)
    size = _i16(s, 418), _i16(s, 416)
    return ("RGB" if (_i16(s, 424), _i16(s, 426)) == (14, 2) else ""), size


_PPM_MODES = {b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA",
              b"PyCMYK": "CMYK"}


def _ppm(f):
    """PpmImageFile._open for the magics beyond P1-P6."""
    from art_tpu_torch.io import stdformats

    magic, r = stdformats.pnm_magic(f.buf)
    mode = _PPM_MODES[magic]
    size = (stdformats._int(stdformats._token(r)),
            stdformats._int(stdformats._token(r)))
    token = stdformats._token(r)
    if mode == "F":
        try:
            scale = float(token)
        except ValueError as e:
            raise PilValueError(str(e)) from e
        if scale == 0.0 or not math.isfinite(scale):
            raise PilValueError("scale must be finite and non-zero")
        f.tile = (r.pos, scale)
    else:
        maxval = stdformats._int(token)
        if not 0 < maxval < 65536:
            raise PilValueError("maxval must be greater than 0 and less "
                                "than 65536")
        f.tile = (r.pos, maxval)
    return mode, size


_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
              (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
              (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def psd_header(f):
    """PsdImageFile._open and _maketile's reads: a dict of the mode, the
    channels read, the size, the colour mode data where it is a P
    image's 768-byte palette (else None), the ICC profile (the last image
    resource 1039, else None), the compression, the image data's offset
    and, for PackBits, the byte counts of the channels' rows; the file
    left past the tiles."""
    s = f.read(26)
    if not s.startswith(b"8BPS") or _i16be(s, 4) != 1:
        raise SyntaxError("not a PSD file")
    mode, channels = _PSD_MODES[(_i16be(s, 24), _i16be(s, 22))]
    have = _i16be(s, 12)
    if channels > have:
        raise Unidentified("not enough channels")
    if mode == "RGB" and have == 4:
        mode, channels = "RGBA", 4
    h = {"mode": mode, "channels": channels, "palette": None, "icc": None,
         "size": (_i32be(s, 18), _i32be(s, 14)), "counts": None}
    n = _i32be(f.read(4))
    if n:
        data = f.read(n)
        if mode == "P" and n == 768:
            h["palette"] = data
    n = _i32be(f.read(4))
    if n:
        end = f.tell() + n
        while f.tell() < end:
            f.read(4)
            rid = _i16be(f.read(2))
            name = f.read(_i8(f.read(1)))
            if not len(name) & 1:
                f.read(1)
            data = f.read(_i32be(f.read(4)))
            if len(data) & 1:
                f.read(1)
            if rid == 1039:
                h["icc"] = data
    n = _i32be(f.read(4))
    if n:
        end = f.tell() + n
        _i32be(f.read(4))
        f.seek(end)
    h["comp"] = _i16be(f.read(2))
    w, rows = h["size"]
    h["offset"] = offset = f.tell()
    if h["comp"] == 0:  # raw: one plane after another
        offset += channels * w * rows
    elif h["comp"] == 1:  # packbits: a byte count per row
        counts = f.read(channels * rows * 2)
        if len(counts) < channels * rows * 2:
            raise struct.error("unpack_from requires a buffer of 2 bytes")
        h["counts"] = struct.unpack(f">{channels * rows}H", counts)
        h["offset"] = offset = f.tell()
        offset += sum(h["counts"])
    f.seek(offset)  # past the tiles
    return h


def _psd(f):
    h = psd_header(f)
    return h["mode"], h["size"]


def _qoi(f):
    if not f.read(4).startswith(b"qoif"):
        raise SyntaxError("not a QOI file")
    size = _i32be(f.read(4)), _i32be(f.read(4))
    channels = f.read(1)[0]
    return ("RGB" if channels == 3 else "RGBA"), size


_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L",
              (1, 3, 3): "RGB", (2, 3, 3): "RGB", (1, 3, 4): "RGBA",
              (2, 3, 4): "RGBA"}


def _sgi(f):
    s = f.read(512)
    if not (len(s) >= 2 and _i16be(s) == 474):
        raise PilValueError("Not an SGI image file")
    s[2]
    key = s[3], _i16be(s, 4), _i16be(s, 10)
    size = _i16be(s, 6), _i16be(s, 8)
    if key not in _SGI_MODES:
        raise PilValueError("Unsupported SGI image mode")
    return _SGI_MODES[key], size


def _spider_header(t):
    """SpiderImagePlugin.isSpiderHeader: the header's byte count, or 0."""
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        try:
            if h[i] - int(h[i]) != 0:
                return 0
        except (ValueError, OverflowError):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labbyt = int(h[22])
    if labbyt != int(h[13]) * int(h[23]):
        return 0
    return labbyt


def _spider_int(v):
    try:
        return int(v)
    except ValueError as e:
        raise PilValueError(str(e)) from e
    except OverflowError as e:
        raise OpenError(f"SPIDER: OverflowError: {e}") from e


def _spider(f):
    data = f.read(108)
    big = True
    t = struct.unpack(">27f", data)
    hdrlen = _spider_header(t)
    if not hdrlen:
        big = False
        t = struct.unpack("<27f", data)
        hdrlen = _spider_header(t)
        if not hdrlen:
            raise SyntaxError("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    size = int(h[12]), int(h[2])
    stack, number = _spider_int(h[24]), _spider_int(h[27])
    f.tile = (hdrlen, big)
    if stack > 0 and number == 0:
        _spider_int(h[26])
        f.tile = (hdrlen * 2, big)
    elif stack == 0 and number > 0:
        raise OpenError("SPIDER: AttributeError: 'SpiderImageFile' object "
                        "has no attribute 'stkoffset'")
    elif not (stack == 0 and number == 0):
        raise SyntaxError("inconsistent stack header values")
    return "F", size


def _sun(f):
    s = f.read(32)
    if not (len(s) >= 4 and _i32be(s) == 0x59A66A95):
        raise SyntaxError("not an SUN raster file")
    size = _i32be(s, 4), _i32be(s, 8)
    depth, ftype = _i32be(s, 12), _i32be(s, 20)
    ptype, plen = _i32be(s, 24), _i32be(s, 28)
    if depth not in (1, 4, 8, 24, 32):
        raise SyntaxError("Unsupported Mode/Bit Depth")
    mode = {1: "1", 4: "L", 8: "L"}.get(depth, "RGB")
    rawmode = {1: "1;I", 4: "L;4", 8: "L"}.get(depth) or \
        ("RGB" if ftype == 3 else "BGR") + ("X" if depth == 32 else "")
    palette = None
    if plen:
        if plen > 1024:
            raise SyntaxError("Unsupported Color Palette Length")
        if ptype != 1:
            raise SyntaxError("Unsupported Palette Type")
        palette = f.read(plen)
        if mode == "L":
            mode = "P"
            rawmode = rawmode.replace("L", "P")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise SyntaxError("Unsupported Sun Raster file type")
    f.tile = (rawmode, 32 + plen, ((size[0] * depth + 15) // 16) * 2,
              ftype == 2, palette)
    return mode, size


def _tga(f):
    s = f.read(18)
    id_len, cmap, itype, depth, _ = s[0], s[1], s[2], s[16], s[17]
    size = _i16(s, 12), _i16(s, 14)
    if cmap not in (0, 1) or size[0] <= 0 or size[1] <= 0 or \
            depth not in (1, 8, 16, 24, 32):
        raise SyntaxError("not a TGA file")
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if cmap else "L"
    elif itype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise SyntaxError("unknown TGA mode")
    if id_len:
        f.read(id_len)
    if cmap:  # the colour map's entries; the file left at the image data
        if s[7] not in (16, 24, 32):
            raise SyntaxError("unknown TGA map depth")
        f.read(s[7] // 8 * _i16(s, 5))
    return mode, size


def _wmf(f):
    s = f.read(44)
    if s.startswith(b"\xd7\xcd\xc6\x9a\0\0"):
        inch = _i16(s, 14)
        if inch == 0:
            raise PilValueError("Invalid inch")
        x0, y0, x1, y1 = struct.unpack_from("<4h", s, 6)
        size = (x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch
        if s[22:26] != b"\x01\x00\t\x00":
            raise SyntaxError("Unsupported WMF file format")
    elif s.startswith(b"\x01\0\0\0") and s[40:44] == b" EMF":
        x0, y0, x1, y1, fx0, fy0, fx1, fy1 = struct.unpack_from("<8i", s, 8)
        if fx1 == fx0 or fy1 == fy0:
            raise OpenError("WMF: ZeroDivisionError: division by zero")
        size = x1 - x0, y1 - y0
    else:
        raise SyntaxError("Unsupported file format")
    return "RGB", size


_XBM = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")


def _xbm(f):
    m = _XBM.match(f.read(512))
    if not m:
        raise SyntaxError("not a XBM file")
    f.tile = m.end()
    return "1", (int(m.group("width")), int(m.group("height")))


_XPM = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _xpm(f):
    if not f.read(9).startswith(b"/* XPM */"):
        raise SyntaxError("not an XPM file")
    while True:
        line = f.readline()
        if not line:
            raise SyntaxError("broken XPM file")
        m = _XPM.match(line)
        if m:
            break
    size = _int(m.group(1)), _int(m.group(2))
    n, bpp = _int(m.group(3)), _int(m.group(4))
    palette = {}
    for _ in range(n):
        line = f.readline().rstrip()
        c = line[1 : bpp + 1]
        s = line[bpp + 1 : -2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1]
                if rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError as e:
                        raise PilValueError(str(e)) from e
                    palette[c] = bytes(((v >> 16) & 255, (v >> 8) & 255,
                                        v & 255))
                elif rgb != b"None":
                    raise PilValueError("cannot read this XPM file")
                break
        else:
            raise PilValueError("cannot read this XPM file")
    f.tile = (bpp, palette, f.tell())
    return ("RGB" if n > 256 else "P"), size


def _xvthumb(f):
    if not f.read(6).startswith(b"P7 332"):
        raise SyntaxError("not an XV thumbnail file")
    f.readline()
    while True:
        s = f.readline()
        if not s:
            raise SyntaxError("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    parts = s.strip().split(maxsplit=2)[:2]
    if len(parts) < 2:
        raise PilValueError("not enough values to unpack")
    f.tile = f.tell()
    return "P", (_int(parts[0]), _int(parts[1]))


def _bomb(size):
    if max(1, size[0]) * max(1, size[1]) > _BOMB_PIXELS:
        raise DecompressionBomb(
            f"Image size ({size[0]}x{size[1]}) exceeds limit of "
            f"{_BOMB_PIXELS} pixels, could be decompression bomb DOS attack.")


def _starts(*magics):
    return lambda p: p.startswith(magics)


def _reader(name, module="rasterformats"):
    """The port's load of a format it decodes: ``read_<name>`` of
    :mod:`art_tpu_torch.io.rasterformats`, of
    :mod:`art_tpu_torch.io.plugins` for a small raster plugin, or of
    :mod:`art_tpu_torch.io.textures` for a texture or icon format."""
    def read(buf, path):
        import importlib

        mod = importlib.import_module(f"art_tpu_torch.io.{module}")
        return getattr(mod, f"read_{name}")(buf, path)
    return read


def _plugin(name):
    return _reader(name, "plugins")


def _texture(name):
    return _reader(name, "textures")


def _webp_accept(p):
    from art_tpu_torch.io import webpdec

    return webpdec.accept(p)


def _webp_open(f):
    """WebP's open is libwebp's parse, made in the load below."""
    return "RGB", (1, 1)


def _read_webp(buf, path):
    from art_tpu_torch.io import webpdec

    try:
        rgb, icc = webpdec.read_webp(bytes(buf))
    except Unidentified as e:
        raise Unidentified(f"cannot identify image file {str(path)!r}: "
                           f"{e}") from e
    return "RGB", rgb, icc


# (name, accept test on the first 16 bytes or None, open, the port's load
# or None) in the order of Pillow 12.1.0's Image.ID, the plugins of the
# formats read before the walk left out; PPM's plugin is here for the
# magics beyond P1-P6. A format with no load is refused by name.
WALK = (
    ("AVIF", lambda p: p[4:8] == b"ftyp"
     and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1"), _avif, None),
    ("BLP", _starts(b"BLP1", b"BLP2"), _blp, _texture("blp")),
    ("DIB", lambda p: len(p) >= 4
     and _i32(p) in (12, 40, 52, 56, 64, 108, 124), _dib, _reader("dib")),
    ("BUFR", _starts(b"BUFR", b"ZCZC"), _stub(b"BUFR", b"ZCZC"), None),
    ("CUR", _starts(b"\0\0\2\0"), _cur, _reader("cur")),
    ("PCX", _pcx_accept, _pcx, _reader("pcx")),
    ("DCX", lambda p: len(p) >= 4 and _i32(p) == 987654321, _dcx,
     _reader("dcx")),
    ("DDS", _starts(b"DDS "), _dds, _texture("dds")),
    ("EPS", lambda p: p.startswith(b"%!PS")
     or (len(p) >= 4 and _i32(p) == 0xC6D3D0C5), _eps, None),
    ("FITS", _starts(b"SIMPLE"), _fits, _plugin("fits")),
    ("FLI", _fli_accept, _fli, _plugin("fli")),
    ("FTEX", _starts(b"FTEX"), _ftex, _plugin("ftex")),
    ("GBR", lambda p: len(p) >= 8 and _i32be(p) >= 20
     and _i32be(p, 4) in (1, 2), _gbr, _plugin("gbr")),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
     _grib, None),
    ("HDF5", _starts(b"\x89HDF\r\n\x1a\n"), _stub(b"\x89HDF\r\n\x1a\n"),
     None),
    ("JPEG 2000", is_jpeg2000, _jpeg2000, _reader("jpeg2000", "jpeg2000")),
    ("ICNS", _starts(b"icns"), _icns, _texture("icns")),
    ("ICO", _starts(b"\0\0\1\0"), _ico, _reader("ico")),
    ("IM", None, _im, _plugin("im")),
    ("IMT", None, _imt, _plugin("imt")),
    ("IPTC/NAA", None, _iptc, _plugin("iptc")),
    ("McIdas", _starts(b"\0\0\0\0\0\0\0\4"), _mcidas,
     _plugin("mcidas")),
    ("MPEG", _starts(b"\x00\x00\x01\xb3"), _mpeg, None),
    ("MSP", _starts(b"DanM", b"LinS"), _msp, _plugin("msp")),
    ("PCD", None, _pcd, _plugin("pcd")),
    ("PIXAR", _starts(b"\x80\xe8\x00\x00"), _pixar,
     _plugin("pixar")),
    ("PFM", _starts(b"Pf"), _ppm, _plugin("ppm")),
    ("PNM of a Pillow extension", _starts(b"P0", b"Py"), _ppm,
     _plugin("ppm")),
    ("PSD", _starts(b"8BPS"), _psd, _reader("psd")),
    ("QOI", _starts(b"qoif"), _qoi, _reader("qoi")),
    ("SGI", lambda p: len(p) >= 2 and _i16be(p) == 474, _sgi,
     _reader("sgi")),
    ("SPIDER", None, _spider, _plugin("spider")),
    ("SUN", lambda p: len(p) >= 4 and _i32be(p) == 0x59A66A95, _sun,
     _plugin("sun")),
    ("TGA", None, _tga, _reader("tga")),
    ("WebP", _webp_accept, _webp_open, _read_webp),
    ("WMF", _starts(b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"), _wmf,
     None),
    ("XBM", lambda p: p.lstrip().startswith(b"#define"), _xbm,
     _plugin("xbm")),
    ("XPM", _starts(b"/* XPM */"), _xpm, _plugin("xpm")),
    ("XVThumb", _starts(b"P7 332"), _xvthumb,
     _plugin("xvthumb")),
)

# the formats Pillow opens that the port refuses by name: (name, accept,
# open)
FORMATS = tuple(e[:3] for e in WALK if e[3] is None)
# those whose load always fails in Pillow 12.1.0 (no handler, no
# decoder): the message of the OSError its load raises
LOAD_FAILS = {"BUFR": "cannot find loader for this BUFR file",
              "GRIB": "cannot find loader for this GRIB file",
              "HDF5": "cannot find loader for this HDF5 file",
              "WMF": "cannot find loader for this WMF file",
              "MPEG": "cannot load this image",
              "EPS": "Unable to locate Ghostscript on paths"}


def load_fails(name):
    """Pillow's load message where a file of format `name` can never load
    (EPS only where no ``gs`` is on PATH), else None."""
    if name == "EPS":
        import shutil

        if shutil.which("gs") is not None:
            return None
    return LOAD_FAILS.get(name)


def walk(buf, path=None):
    """(name, the port's load or None) of the plugin Pillow's
    ``Image.open`` opens `buf` (the bytes of the file at `path`, where
    given) with, walking `WALK`, or None where none does; the errors its
    open lets out as the module docstring says."""
    hit = walk_open(buf, path)
    return None if hit is None else hit[:2]


def walk_open(buf, path=None):
    """`walk`'s (name, load) and the mode the plugin's open gives."""
    prefix = bytes(buf[:16])
    for name, accept, open_, read in WALK:
        if accept is not None and not accept(prefix):
            continue
        try:
            mode, size = open_(_File(buf, path))
        except (Unidentified, PilValueError, DecompressionBomb, OpenError):
            raise
        except _NEXT:
            continue
        except OverflowError as e:
            raise OpenError(f"{name}: OverflowError: {e}") from e
        if not mode or size[0] <= 0 or size[1] <= 0:
            continue
        _bomb(size)
        return name, read, mode
    return None


def identify(buf):
    """The name of the format Pillow's ``Image.open`` opens `buf` as where
    the port refuses it by name; None where it opens none or one the port
    decodes; the errors its open lets out as the module docstring says."""
    hit = walk(buf)
    return hit[0] if hit is not None and hit[1] is None else None
