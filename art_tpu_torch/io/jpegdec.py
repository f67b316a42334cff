"""JPEG decoding without PIL or OpenCV: the array the reference's callers
get from ``Image.open(...)`` (and its ``convert("RGB")``) with Pillow
12.1.0, which links libjpeg-turbo 3.1.3.

Two layers, as in Pillow:
- :func:`pil_header` walks the markers up to the first SOS as
  ``JpegImagePlugin.JpegImageFile._open`` does, and fails where
  ``Image.open`` fails (OSError): a stream that does not start with
  FF D8 FF, a marker it does not know, a segment cut short, a frame of
  other than 8 bits or of other than 1, 3 or 4 components, no SOS;
- the port's C++ decoder (``io/native/jpegdec.cc``, built by
  :mod:`art_tpu_torch.hostbuild` at first use) decodes the stream as
  libjpeg-turbo's default decompressor does when Pillow feeds it:
  islow IDCT, fancy upsampling, its YCbCr tables, block smoothing of a
  progressive file cut before its last refinement. Nothing falls back to
  another library.

What it decodes: SOF0, SOF1 and SOF2 (Huffman-coded), SOF9 and SOF10
(arithmetic-coded) and SOF3 (lossless, Huffman-coded) at 8 bits; 1
component (mode L), 3 (YCbCr after a JFIF APP0, an Adobe APP14 with
transform 1, or component IDs other than R, G, B; RGB after an APP14
with transform 0 or IDs R, G, B) or 4 (mode CMYK: CMYK, or YCCK after an
APP14 with a transform other than 0, inverted as Pillow's "CMYK;I" raw
mode reads Adobe's CMYK); any sampling libjpeg upsamples (4:4:4, 4:2:2,
4:2:0, 4:4:0, 4:1:1, ...); restart intervals; any size from 1x1.

The other forms, as Pillow here treats them:
- 12 and 16 bits (any process): Pillow's header parse refuses them, so
  the port raises OSError;
- lossless arithmetic coding (SOF11): libjpeg-turbo does not implement
  it, so the decode fails (OSError, or a black image in the salvage
  pass);
- the hierarchical processes (SOF5-7, SOF13-15) and DHP: Pillow opens
  them and libjpeg fails, so the port fails as that decode does (OSError,
  or a black image in the salvage pass).

Truncation: Pillow's strict load raises OSError where libjpeg suspends
before the last scanline (or fails after it). Under its
``LOAD_TRUNCATED_IMAGES`` (``salvage=True``) it appends an EOI marker at
the end of the data, keeps the scanlines libjpeg output, and leaves the
rest of its buffer as allocated (zeros): a file cut inside its
entropy-coded data decodes to the end (grey blocks past the cut in a
sequential file, smoothed coefficients in a progressive one), a file cut
where libjpeg cannot reach its output pass (inside a header or between
the scans of a progressive file) gives a black image. The arithmetic
decoder cannot suspend: where it needs bytes past those Pillow has fed
(past the file's end, or past the first 64 KiB of a larger file) libjpeg
fails, the strict load raises, and the salvage load keeps the scanlines
a single-scan file output before the failure.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

from art_tpu_torch import hostbuild

_LIB = None
_LIB_LOCK = threading.Lock()

# Image.open's limit: twice Image.MAX_IMAGE_PIXELS
_BOMB_PIXELS = 178956970

# markers by Pillow's handler (the rest from C0 on have none)
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
        0xCE, 0xCF, 0xDE}
_SKIP = {0xC4, 0xCC, 0xDA, 0xDC, 0xDD, 0xDF}
_APP = set(range(0xE0, 0xF0))
_DQT, _COM = 0xDB, 0xFE


class Header:
    """What Pillow's parse keeps: mode ("L", "RGB" or "CMYK"), size
    (width, height), the last SOF marker, the Adobe transform flag
    (None without an APP14) and the ICC profile (``info["icc_profile"]``:
    the APP2 ICC_PROFILE chunks seen before a SOF, sorted and joined
    where their count matches, else None; absent, None too)."""

    def __init__(self):
        self.mode = None
        self.size = None
        self.sof = None
        self.adobe_transform = None
        self.icc_profile = None
        self.icclist = []


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, n):
        out = self.buf[self.pos : self.pos + n]
        self.pos += len(out)
        return out

    def length(self):  # i16(fp.read(2)) - 2, struct.error when short
        s = self.read(2)
        if len(s) < 2:
            raise struct.error("unpack requires a buffer of 2 bytes")
        return struct.unpack(">H", s)[0] - 2

    def safe_read(self, n):  # ImageFile._safe_read
        if n <= 0:
            return b""
        s = self.read(n)
        if len(s) < n:
            raise OSError("Truncated File Read")
        return s


def pil_header(buf) -> Header:
    """The header as ``Image.open`` parses a JPEG; OSError where it fails."""
    try:
        return _parse(buf)
    except (SyntaxError, IndexError, TypeError, struct.error) as e:
        raise OSError(f"cannot identify image file ({e})") from e


def _parse(buf):
    if not bytes(buf[:3]) == b"\xff\xd8\xff":
        raise SyntaxError("not a JPEG file")
    r = _Reader(buf)
    r.pos = 3
    hdr = Header()
    s = b"\xff"
    while True:
        i = s[0]
        if i == 0xFF:
            s = s + r.read(1)
            i = struct.unpack(">H", s)[0]
        else:
            s = r.read(1)
            continue
        m = i & 0xFF
        if i >= 0xFFC0 and i != 0xFFFF:
            if m in _SOF:
                _sof(r, hdr, m)
            elif m in _SKIP:
                r.safe_read(r.length())
            elif m in _APP:
                _app(r, hdr, m)
            elif m == _DQT:
                _dqt(r)
            elif m == _COM:
                r.safe_read(r.length())
            if m == 0xDA:
                break
            s = r.read(1)
        elif i == 0xFFFF:
            s = b"\xff"
        elif i == 0xFF00:
            s = r.read(1)
        else:
            raise SyntaxError("no marker found")
    # ImageFile.__init__ refuses a file with no mode or an empty size
    if hdr.mode is None or hdr.size is None or min(hdr.size) <= 0:
        raise SyntaxError("no mode or an empty size")
    if hdr.size[0] * hdr.size[1] > _BOMB_PIXELS:
        from art_tpu_torch.io.stdformats import DecompressionBomb

        raise DecompressionBomb(f"image size {hdr.size} exceeds the "
                                "decompression bomb limit")
    return hdr


def _sof(r, hdr, marker):
    s = r.safe_read(r.length())
    width, height = struct.unpack_from(">H", s, 3)[0], \
        struct.unpack_from(">H", s, 1)[0]
    hdr.size = (width, height)
    if s[0] != 8:
        raise SyntaxError(f"cannot handle {s[0]}-bit layers")
    layers = s[5]
    modes = {1: "L", 3: "RGB", 4: "CMYK"}
    if layers not in modes:
        raise SyntaxError(f"cannot handle {layers}-layer images")
    hdr.mode = modes[layers]
    hdr.sof = marker
    if hdr.icclist:  # Pillow's fixup at each SOF
        hdr.icclist.sort()
        if hdr.icclist[0][13] == len(hdr.icclist):
            hdr.icc_profile = b"".join(p[14:] for p in hdr.icclist)
        else:
            hdr.icc_profile = None  # a wrong number of fragments
        hdr.icclist = []
    for i in range(6, len(s), 3):
        t = s[i : i + 3]
        t[0], t[1], t[2]  # Pillow indexes each triple (IndexError if cut)


def _app(r, hdr, marker):
    s = r.safe_read(r.length())
    if marker == 0xE0 and s.startswith(b"JFIF"):
        struct.unpack_from(">H", s, 5)
    elif marker == 0xE2 and s.startswith(b"ICC_PROFILE\0"):
        hdr.icclist.append(s)
    elif marker == 0xED and s.startswith(b"Photoshop 3.0\x00"):
        _photoshop(s)
    elif marker == 0xEE and s.startswith(b"Adobe"):
        struct.unpack_from(">H", s, 5)
        if len(s) > 11:
            hdr.adobe_transform = s[11]


def _photoshop(s):
    # Pillow's walk of the 8BIM blocks: a short field ends it, except the
    # name length, whose IndexError fails the open
    offset = 14
    while s[offset : offset + 4] == b"8BIM":
        try:
            offset += 4
            code = struct.unpack_from(">H", s, offset)[0]
            offset += 2
            offset += 1 + s[offset]
            offset += offset & 1
            size = struct.unpack_from(">I", s, offset)[0]
            offset += 4
            if code == 0x03ED:
                # the resolution info's four fields end at byte 14
                struct.unpack_from(">H", s[offset : offset + size], 12)
            offset += size
            offset += offset & 1
        except struct.error:
            break


def _dqt(r):
    s = r.safe_read(r.length())
    while len(s):
        precision = 1 if s[0] // 16 == 0 else 2
        qt_length = 1 + precision * 64
        if len(s) < qt_length:
            raise SyntaxError("bad quantization table marker")
        s = s[qt_length:]


def _load():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = hostbuild.load("jpegdec")
            lib.jpegdec_decode.restype = ctypes.c_int
            lib.jpegdec_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_char_p, ctypes.c_int]
            lib.jpegdec_decode_as.restype = ctypes.c_int
            lib.jpegdec_decode_as.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_char_p, ctypes.c_int]
            lib.jpegdec_decode_raw.restype = ctypes.c_int
            lib.jpegdec_decode_raw.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_char_p, ctypes.c_int]
            lib.jpegdec_free.restype = None
            lib.jpegdec_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
            _LIB = lib
        return _LIB


def _native_decode(buf, salvage=False, color=-1):
    """The C++ decoder on the whole stream: (outcome, array or None,
    message, scanlines output); outcome 0 every scanline output, 1 the same but a later
    marker failed, 2 the data ended first, 3 an error came first, 4 an
    error came inside the one scan of a single-scan file (the array: the
    scanlines output before it, zeros after). color:
    a three-component frame's colour space, -1 libjpeg's guess, 0 the
    components unconverted, 1 YCbCr; 2 a four-component frame read as
    CMYK (no YCCK conversion)."""
    lib = _load()
    info = (ctypes.c_int * 5)()
    out = ctypes.POINTER(ctypes.c_uint8)()
    msg = ctypes.create_string_buffer(256)
    data = bytes(buf)
    if lib.jpegdec_decode_as(data, len(data), int(bool(salvage)), int(color),
                             info, ctypes.byref(out), msg, len(msg)) != 0:
        raise RuntimeError("jpegdec: bad arguments")
    outcome, h, w, c, rows = info[0], info[1], info[2], info[3], info[4]
    arr = None
    if out:
        try:
            arr = np.ctypeslib.as_array(out, shape=(h * w * c,)).copy()
        finally:
            lib.jpegdec_free(out)
        arr = arr.reshape((h, w) if c == 1 else (h, w, c))
    return (outcome, arr, msg.value.decode("ascii", "replace"),
            rows if outcome == 4 else h)


def decode(buf, salvage=False, color=-1):
    """A JPEG stream as Pillow's ``Image.open(...)`` loads it: (H, W)
    uint8 for mode L, (H, W, 3) for RGB, (H, W, 4) for CMYK (Pillow's
    "CMYK;I": libjpeg's CMYK inverted). Strict (Pillow's default) raises
    OSError where the load fails; `salvage` is the load under
    ``ImageFile.LOAD_TRUNCATED_IMAGES``; `color` 2 reads a
    four-component frame as CMYK with no YCCK conversion (Pillow's jpeg
    mode "CMYK", as BLP1 sets it)."""
    hdr = pil_header(buf)
    w, h = hdr.size
    outcome, arr, msg, rows = _native_decode(buf, salvage, color)
    if arr is not None and hdr.mode == "CMYK":
        # Pillow inverts the scanlines libjpeg output; the rest stay 0
        arr[:rows] = 255 - arr[:rows]
    if outcome == 0 or (salvage and outcome in (1, 4)):
        return arr
    if salvage:
        return np.zeros({"L": (h, w), "RGB": (h, w, 3)}.get(
            hdr.mode, (h, w, 4)), np.uint8)
    if outcome == 2:
        raise OSError("image file is truncated")
    raise OSError(f"broken data stream when reading image file: {msg}")


def decode_tiff_stream(buf, color):
    """One strip or tile of a JPEG-compressed TIFF (its JPEGTables
    joined), as libtiff has libjpeg decode it for Pillow: (H, W) uint8 for
    one component, (H, W, 3) for three; color 1 converts YCbCr to RGB
    (JPEGCOLORMODE_RGB), 0 keeps the components as they are. A stream
    libjpeg cannot decode to its end raises OSError."""
    outcome, arr, msg, _ = _native_decode(buf, False, color)
    if outcome != 0:
        raise OSError(f"TIFF JPEG strip: {msg or 'the data ended first'}")
    return arr


def decode_raw(buf):
    """A JPEG stream's component planes as libjpeg's jpeg_read_raw_data
    gives them (libtiff's old-style JPEG): a list of (plane (rows, row
    length) uint8 in whole blocks, (h, v) sampling factors). A stream
    libjpeg fails on before its last row raises OSError; what follows
    the rows (tif_ojpeg never finishes the decompression) is not read."""
    lib = _load()
    info = (ctypes.c_int * 5)()
    geom = (ctypes.c_int * 40)()
    out = ctypes.POINTER(ctypes.c_uint8)()
    msg = ctypes.create_string_buffer(256)
    data = bytes(buf)
    if lib.jpegdec_decode_raw(data, len(data), info, geom, ctypes.byref(out),
                              msg, len(msg)) != 0:
        raise RuntimeError("jpegdec: bad arguments")
    if info[0] not in (0, 1) or not out:
        if out:
            lib.jpegdec_free(out)
        raise OSError(f"JPEG raw data: "
                      f"{msg.value.decode('ascii', 'replace') or 'the data ended first'}")
    planes = []
    total = sum(geom[4 * c] * geom[4 * c + 1] for c in range(info[3]))
    try:
        flat = np.ctypeslib.as_array(out, shape=(total,)).copy()
    finally:
        lib.jpegdec_free(out)
    at = 0
    for c in range(info[3]):
        rows, pw = geom[4 * c], geom[4 * c + 1]
        planes.append((flat[at : at + rows * pw].reshape(rows, pw),
                       (geom[4 * c + 2], geom[4 * c + 3])))
        at += rows * pw
    return planes


def decode_rgb(buf, salvage=False):
    """`decode` followed by Pillow's ``convert("RGB")``: (H, W, 3)."""
    from art_tpu_torch.io.stdformats import cmyk_to_rgb

    arr = decode(buf, salvage)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=2)
    elif arr.shape[2] == 4:
        arr = cmyk_to_rgb(arr)
    return arr
