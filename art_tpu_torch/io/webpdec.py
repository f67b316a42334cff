"""WebP decoding without PIL: what Pillow 12.1.0's ``Image.open`` makes
of a WebP file and its ``convert("RGB")``, bit for bit.

Pillow opens every WebP through libwebp's animation decoder
(``PIL/WebPImagePlugin.py``, ``_open``; ``src/_webp.c``,
``_anim_decoder_new``): ``WebPGetFeatures`` of the whole file, then
``WebPAnimDecoderNew`` (``src/demux/anim_decode.c``), which checks the
features again and parses the container with ``WebPDemux``
(``src/demux/demux.c``); a file either rejects fails ``Image.open`` with
OSError ("could not create decoder object"). The load decodes frame 0
(``WebPAnimDecoderGetNext``) onto a canvas cleared to (0, 0, 0, 0), at the
frame's offset with no blend, as RGBA that is not premultiplied; a frame
that fails to decode fails the load with OSError. ``convert("RGB")``
drops the alpha, so pixels outside the frame are (0, 0, 0).

This module mirrors the container checks in Python: the RIFF size, odd
sizes padded, bytes after the RIFF ignored; a simple ``VP8 `` or
``VP8L`` file; ``VP8X`` with its flags and 24-bit canvas, then ``ICCP``,
``ALPH``, ``ANIM``, ``ANMF``, ``EXIF`` and ``XMP `` in libwebp's order
rules (an ``ALPH`` chunk dropped where the alpha flag is off); each
``ANMF`` frame's offset (twice the stored value), its chunks, and its
bitstream inside the canvas. The bitstreams decode in
``io/native/webpdec.cc`` (VP8L, VP8 and ALPH, as libwebp 1.6.0 does).
The ICC profile is the first ``ICCP`` chunk's payload where the VP8X
flags announce one (``WebPDemuxGetChunk``), as Pillow's
``info["icc_profile"]``.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

from art_tpu_torch import hostbuild
from art_tpu_torch.io.stdformats import Unidentified

_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_IMAGE_AREA = 1 << 32
_ALPHA_FLAG, _ANIMATION_FLAG, _ICCP_FLAG = 0x10, 0x02, 0x20
_EXIF_FLAG, _XMP_FLAG = 0x08, 0x04
_ALL_VALID_FLAGS = 0x3E
# VP8StatusCode
_OK, _BITSTREAM_ERROR, _NOT_ENOUGH_DATA = 0, 3, 7
# the demuxer's ParseStatus
_PARSE_OK, _PARSE_NEED_MORE_DATA, _PARSE_ERROR = 0, 1, 2


def accept(prefix):
    """WebPImagePlugin._accept on a file's first 16 bytes."""
    return (prefix[:4] == b"RIFF" and prefix[8:12] == b"WEBP"
            and prefix[12:16] in (b"VP8 ", b"VP8X", b"VP8L"))


def _le16(b, o):
    return b[o] | b[o + 1] << 8


def _le24(b, o):
    return b[o] | b[o + 1] << 8 | b[o + 2] << 16


def _le32(b, o):
    return struct.unpack_from("<I", b, o)[0]


# -- the bitstream headers (src/dec/webp_dec.c, vp8_dec.c, vp8l_dec.c) ------

def _vp8_info(data, chunk_size):
    """VP8GetInfo: the key frame's (width, height), or None."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        return None
    bits = _le24(data, 0)
    w, h = _le16(data, 6) & 0x3FFF, _le16(data, 8) & 0x3FFF
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 \
            or bits >> 5 >= chunk_size or w == 0 or h == 0:
        return None
    return w, h


def _vp8l_info(data):
    """VP8LGetInfo: (width, height, alpha bit), or None."""
    if len(data) < 5 or data[0] != 0x2F or data[4] >> 5:
        return None
    bits = _le32(data, 1)
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1


class _Headers:
    """WebPHeaderStructure: where the bitstream and its alpha lie."""
    offset = 0
    alpha = None  # (offset, size) of an ALPH chunk's payload
    lossless = False
    width = height = 0
    has_alpha = False
    animation = False


def _parse_headers(data, have_all_data, features_only):
    """ParseHeadersInternal: (status, _Headers). `features_only` is
    WebPGetFeatures' call (no headers asked for: an animation stops at
    VP8X, and data that ends after a VP8X is no error)."""
    hd = _Headers()
    n = len(data)
    if n < 12:
        return _NOT_ENOUGH_DATA, hd
    pos, riff_size = 0, 0
    # ParseRIFF
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            return _BITSTREAM_ERROR, hd
        size = _le32(data, 4)
        if size < 12 or size > _MAX_CHUNK_PAYLOAD:
            return _BITSTREAM_ERROR, hd
        if have_all_data and size > n - 8:
            return _NOT_ENOUGH_DATA, hd
        riff_size, pos = size, 12
    found_riff = riff_size > 0
    # ParseVP8X
    if n - pos < 8:
        return _NOT_ENOUGH_DATA, hd
    found_vp8x, canvas = False, (0, 0)
    flags = 0
    if data[pos : pos + 4] == b"VP8X":
        if _le32(data, pos + 4) != 10:
            return _BITSTREAM_ERROR, hd
        if n - pos < 18:
            return _NOT_ENOUGH_DATA, hd
        flags = _le32(data, pos + 8)
        canvas = 1 + _le24(data, pos + 12), 1 + _le24(data, pos + 15)
        if canvas[0] * canvas[1] >= _MAX_IMAGE_AREA:
            return _BITSTREAM_ERROR, hd
        pos += 18
        found_vp8x = True
    if not found_riff and found_vp8x:
        return _BITSTREAM_ERROR, hd
    hd.has_alpha = bool(flags & _ALPHA_FLAG)
    hd.animation = bool(flags & _ANIMATION_FLAG)
    hd.width, hd.height = canvas

    def done(status):
        if status == _OK or (status == _NOT_ENOUGH_DATA and found_vp8x
                             and features_only):
            hd.has_alpha |= hd.alpha is not None
            return _OK, hd
        return status, hd

    if found_vp8x and hd.animation and features_only:
        return done(_OK)
    if n - pos < 4:
        return done(_NOT_ENOUGH_DATA)
    # ParseOptionalChunks
    if (found_riff and found_vp8x) or (not found_riff and not found_vp8x
                                       and data[pos : pos + 4] == b"ALPH"):
        total = 4 + 8 + 10
        while True:
            if n - pos < 8:
                return done(_NOT_ENOUGH_DATA)
            size = _le32(data, pos + 4)
            if size > _MAX_CHUNK_PAYLOAD:
                return _BITSTREAM_ERROR, hd
            disk = (8 + size + 1) & ~1
            total += disk
            if riff_size > 0 and total > riff_size:
                return _BITSTREAM_ERROR, hd
            if data[pos : pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if n - pos < disk:
                return done(_NOT_ENOUGH_DATA)
            if data[pos : pos + 4] == b"ALPH":
                hd.alpha = pos + 8, size
            pos += disk
    # ParseVP8Header
    if n - pos < 8:
        return done(_NOT_ENOUGH_DATA)
    kind = bytes(data[pos : pos + 4])
    if kind in (b"VP8 ", b"VP8L"):
        size = _le32(data, pos + 4)
        if riff_size >= 12 and size > riff_size - 12:
            return _BITSTREAM_ERROR, hd
        if have_all_data and size > n - pos - 8:
            return done(_NOT_ENOUGH_DATA)
        pos += 8
        hd.lossless = kind == b"VP8L"
    else:
        size = n - pos
        hd.lossless = (n - pos >= 5 and data[pos] == 0x2F
                       and data[pos + 4] >> 5 == 0)
    if size > _MAX_CHUNK_PAYLOAD:
        return _BITSTREAM_ERROR, hd
    body = data[pos:]
    if not hd.lossless:
        if len(body) < 10:
            return done(_NOT_ENOUGH_DATA)
        info = _vp8_info(body, size)
        if info is None:
            return _BITSTREAM_ERROR, hd
        image = info
    else:
        if len(body) < 5:
            return done(_NOT_ENOUGH_DATA)
        info = _vp8l_info(body)
        if info is None:
            return _BITSTREAM_ERROR, hd
        image = info[:2]
        hd.has_alpha = bool(info[2])
    if found_vp8x and image != canvas:
        return _BITSTREAM_ERROR, hd
    hd.width, hd.height = image
    hd.offset = pos
    return done(_OK)


def features_ok(data):
    """Whether WebPGetFeatures accepts `data`."""
    return _parse_headers(data, False, True)[0] == _OK


# -- the demuxer (src/demux/demux.c) ----------------------------------------

class _Frame:
    def __init__(self):
        self.x = self.y = 0
        self.width = self.height = 0
        self.has_alpha = False
        self.image = (0, 0)  # (offset of the chunk's header, size)
        self.alpha = (0, 0)
        self.complete = False
        self.num = 0


class _Demux:
    """WebPDemux of a whole file (no partial data): the parse over a
    buffer of `end` bytes (the RIFF's end or the file's, the lesser)."""

    def __init__(self, buf, riff_end):
        self.buf = buf
        self.start = 12
        self.riff_end = riff_end
        self.end = min(len(buf), riff_end)
        self.frames = []
        self.num_frames = 0
        self.canvas = (0, 0)
        self.flags = 0
        self.ext = False
        self.state_done = False
        self.iccp = None

    def size(self):
        return self.end - self.start

    def invalid(self, n):  # SizeIsInvalid
        return n > self.riff_end - self.start

    def le32(self):
        v = _le32(self.buf, self.start)
        self.start += 4
        return v

    def add(self, frame):  # AddFrame
        if self.frames and not self.frames[-1].complete:
            return False
        self.frames.append(frame)
        return True

    def store_frame(self, num, min_size, frame):
        """StoreFrame: the frame's ALPH and image chunks from here."""
        if self.size() < 8 or self.size() < min_size:
            return _PARSE_NEED_MORE_DATA
        alpha_chunks = image_chunks = 0
        status = _PARSE_OK
        done = False
        while not done and status == _PARSE_OK:
            chunk_start = self.start
            fourcc = bytes(self.buf[self.start : self.start + 4])
            self.start += 4
            payload = self.le32()
            if payload > _MAX_CHUNK_PAYLOAD:
                return _PARSE_ERROR
            padded = payload + (payload & 1)
            available = min(padded, self.size())
            chunk_size = 8 + available
            if self.invalid(padded):
                return _PARSE_ERROR
            if padded > self.size():
                status = _PARSE_NEED_MORE_DATA
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                frame.alpha = chunk_start, chunk_size
                frame.has_alpha = True
                frame.num = num
                self.start += available
            elif fourcc in (b"VP8 ", b"VP8L") and image_chunks == 0:
                if fourcc == b"VP8L" and alpha_chunks > 0:
                    return _PARSE_ERROR
                ok, has_alpha, size = _chunk_features(
                    self.buf[chunk_start : chunk_start + chunk_size])
                if not ok:
                    return _PARSE_ERROR
                image_chunks = 1
                frame.image = chunk_start, chunk_size
                frame.width, frame.height = size
                frame.has_alpha |= has_alpha
                frame.num = num
                frame.complete = status == _PARSE_OK
                self.start += available
            elif fourcc == b"VP8L" and alpha_chunks > 0:
                return _PARSE_ERROR
            else:
                self.start -= 8
                done = True
            if self.start == self.riff_end:
                done = True
            elif self.size() < 8:
                status = _PARSE_NEED_MORE_DATA
        return status

    def parse_single_image(self):
        if self.frames:
            return _PARSE_ERROR
        if self.invalid(8):
            return _PARSE_ERROR
        if self.size() < 8:
            return _PARSE_NEED_MORE_DATA
        frame = _Frame()
        status = self.store_frame(1, 0, frame)
        if status != _PARSE_ERROR:
            if not self.flags & _ALPHA_FLAG and frame.alpha[1] > 0:
                frame.alpha = (0, 0)
                frame.has_alpha = False
            if not self.ext and frame.width > 0 and frame.height > 0:
                self.canvas = frame.width, frame.height
                self.flags |= _ALPHA_FLAG if frame.has_alpha else 0
            if not self.add(frame):
                status = _PARSE_ERROR
            else:
                self.num_frames = 1
        return status

    def parse_animation_frame(self, chunk_size):
        anmf_payload = chunk_size - 16
        if self.invalid(16) or chunk_size < 16:
            return _PARSE_ERROR
        if self.size() < 16:
            return _PARSE_NEED_MORE_DATA
        frame = _Frame()
        b, s = self.buf, self.start
        frame.x, frame.y = 2 * _le24(b, s), 2 * _le24(b, s + 3)
        width, height = 1 + _le24(b, s + 6), 1 + _le24(b, s + 9)
        self.start += 16
        if width * height >= _MAX_IMAGE_AREA:
            return _PARSE_ERROR
        start = self.start
        status = self.store_frame(self.num_frames + 1, anmf_payload, frame)
        if status != _PARSE_ERROR and self.start - start > anmf_payload:
            status = _PARSE_ERROR
        if status != _PARSE_ERROR and self.flags & _ANIMATION_FLAG \
                and frame.num > 0:
            if self.add(frame):
                self.num_frames += 1
            else:
                status = _PARSE_ERROR
        return status

    def parse_vp8x(self):
        if self.size() < 8:
            return _PARSE_NEED_MORE_DATA
        self.ext = True
        self.start += 4
        vp8x_size = self.le32()
        if vp8x_size > _MAX_CHUNK_PAYLOAD or vp8x_size < 10:
            return _PARSE_ERROR
        vp8x_size += vp8x_size & 1
        if self.invalid(vp8x_size):
            return _PARSE_ERROR
        if self.size() < vp8x_size:
            return _PARSE_NEED_MORE_DATA
        b, s = self.buf, self.start
        self.flags = b[s]
        self.canvas = 1 + _le24(b, s + 4), 1 + _le24(b, s + 7)
        if self.canvas[0] * self.canvas[1] >= _MAX_IMAGE_AREA:
            return _PARSE_ERROR
        self.start += vp8x_size
        if self.invalid(8):
            return _PARSE_ERROR
        if self.size() < 8:
            return _PARSE_NEED_MORE_DATA
        return self.parse_vp8x_chunks()

    def parse_vp8x_chunks(self):
        is_animation = bool(self.flags & _ANIMATION_FLAG)
        anim_chunks = 0
        status = _PARSE_OK
        while True:
            chunk_start = self.start
            fourcc = bytes(self.buf[self.start : self.start + 4])
            self.start += 4
            chunk_size = self.le32()
            if chunk_size > _MAX_CHUNK_PAYLOAD:
                return _PARSE_ERROR
            padded = chunk_size + (chunk_size & 1)
            if self.invalid(padded):
                return _PARSE_ERROR
            store, skip = True, False
            if fourcc == b"VP8X":
                return _PARSE_ERROR
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks > 0 or is_animation:
                    return _PARSE_ERROR
                self.start -= 8
                status = self.parse_single_image()
            elif fourcc == b"ANIM":
                if padded < 6:
                    return _PARSE_ERROR
                if self.size() < padded:
                    status = _PARSE_NEED_MORE_DATA
                elif anim_chunks == 0:
                    anim_chunks = 1
                    self.start += padded
                else:
                    store, skip = False, True
            elif fourcc == b"ANMF":
                if anim_chunks == 0:
                    return _PARSE_ERROR
                status = self.parse_animation_frame(padded)
            else:
                store = {b"ICCP": bool(self.flags & _ICCP_FLAG),
                         b"EXIF": bool(self.flags & _EXIF_FLAG),
                         b"XMP ": bool(self.flags & _XMP_FLAG)}.get(
                             fourcc, True)
                skip = True
            if skip:
                if padded <= self.size():
                    if store and fourcc == b"ICCP" and self.iccp is None:
                        self.iccp = bytes(self.buf[chunk_start + 8 :
                                                   chunk_start + 8
                                                   + chunk_size])
                    self.start += padded
                else:
                    status = _PARSE_NEED_MORE_DATA
            if self.start == self.riff_end:
                break
            if self.size() < 8:
                status = _PARSE_NEED_MORE_DATA
            if status != _PARSE_OK:
                break
        return status

    def valid_simple(self):  # IsValidSimpleFormat
        if self.canvas[0] <= 0 or self.canvas[1] <= 0:
            return False
        if self.state_done and not self.frames:
            return False
        f = self.frames[0]
        return f.width > 0 and f.height > 0

    def valid_extended(self):  # IsValidExtendedFormat
        is_animation = bool(self.flags & _ANIMATION_FLAG)
        if self.canvas[0] <= 0 or self.canvas[1] <= 0:
            return False
        if self.state_done and not self.frames:
            return False
        if self.flags & ~_ALL_VALID_FLAGS:
            return False
        for f in self.frames:
            if not is_animation and f.num > 1:
                return False
            if f.complete:
                if f.alpha[1] == 0 and f.image[1] == 0:
                    return False
                if f.alpha[1] > 0 and f.alpha[0] > f.image[0]:
                    return False
                if f.width <= 0 or f.height <= 0:
                    return False
            else:
                if self.state_done:
                    return False
                if f.alpha[1] > 0 and f.image[1] > 0 \
                        and f.alpha[0] > f.image[0]:
                    return False
                if f is not self.frames[-1]:
                    return False
            if f.width > 0 and f.height > 0:
                if not is_animation:
                    if f.x or f.y or (f.width, f.height) != self.canvas:
                        return False
                elif f.x + f.width > self.canvas[0] \
                        or f.y + f.height > self.canvas[1]:
                    return False
        return True


def _chunk_features(chunk):
    """WebPGetFeatures of one VP8/VP8L chunk as StoreFrame asks it: (ok,
    has_alpha, (width, height))."""
    status, hd = _parse_headers(chunk, False, True)
    return status == _OK, hd.has_alpha, (hd.width, hd.height)


def _demux(buf):
    """WebPDemux: the parsed container, or None where it fails."""
    if len(buf) < 20 or buf[:4] != b"RIFF" or buf[8:12] != b"WEBP":
        return None
    riff_size = _le32(buf, 4)
    if riff_size < 8 or riff_size > _MAX_CHUNK_PAYLOAD:
        return None
    riff_end = riff_size + 8
    if len(buf) < riff_end:  # partial data is refused
        return None
    d = _Demux(buf, riff_end)
    kind = bytes(buf[12:16])
    if kind in (b"VP8 ", b"VP8L"):
        status, valid = d.parse_single_image(), d.valid_simple
    elif kind == b"VP8X":
        status, valid = d.parse_vp8x(), d.valid_extended
    else:
        return None
    if status == _PARSE_NEED_MORE_DATA:
        return None  # not partial, so an error
    if status == _PARSE_OK:
        d.state_done = True
    if status != _PARSE_ERROR and not valid():
        return None
    return None if status == _PARSE_ERROR else d


def open_webp(buf):
    """Image.open of a WebP: the demuxed container, whose ``canvas`` is
    the image's size and ``iccp`` its profile; `Unidentified` where
    WebPAnimDecoderNew fails."""
    buf = memoryview(buf)
    d = _demux(buf) if features_ok(buf) else None
    if d is None:
        raise Unidentified("could not create decoder object")
    return d


# -- the frame's decode ------------------------------------------------------

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = hostbuild.load("webpdec")
            lib.webp_vp8l_decode.restype = ctypes.c_int
            lib.webp_vp8l_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int]
            lib.webp_vp8l_info.restype = ctypes.c_int
            lib.webp_vp8l_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                           ctypes.c_void_p]
            lib.webp_vp8_info.restype = ctypes.c_int
            lib.webp_vp8_info.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.webp_vp8_decode.restype = ctypes.c_int
            lib.webp_vp8_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int]
            _LIB = lib
        return _LIB


def _frame_payload(buf, frame):
    """GetFramePayload: the frame's ALPH chunk (if kept) through its
    image chunk."""
    start, size = frame.image
    if frame.alpha[1] > 0:
        inter = start - (frame.alpha[0] + frame.alpha[1]) if start > 0 else 0
        size += frame.alpha[1] + inter
        start = frame.alpha[0]
    return buf[start : start + size]


def decode_frame(payload, out):
    """WebPDecode of one frame's payload into `out`, a view of (height,
    width, 4) uint8 rows of the canvas; False where libwebp fails."""
    if not features_ok(payload):
        return False
    status, hd = _parse_headers(payload, True, False)
    if status != _OK or hd.animation:
        return False
    h, w = out.shape[:2]
    if (hd.width, hd.height) != (w, h):
        return False
    raw = np.frombuffer(payload, np.uint8)
    base = raw.ctypes.data
    n = len(raw) - hd.offset
    stride = out.strides[0]
    ptr = out.ctypes.data
    lib = _lib()
    if hd.lossless:
        status = lib.webp_vp8l_decode(base + hd.offset, n, w, h, ptr, stride)
    else:
        alpha, alpha_n = (None, 0) if hd.alpha is None else (
            base + hd.alpha[0], hd.alpha[1])
        status = lib.webp_vp8_decode(base + hd.offset, n, alpha, alpha_n, w,
                                     h, ptr, stride)
    return status == _OK


def load(buf, d):
    """The load of frame 0 (WebPAnimDecoderGetNext): the canvas as (H,
    W, 4) RGBA; OSError where the frame fails to decode."""
    cw, ch = d.canvas
    canvas = np.zeros((ch, cw, 4), np.uint8)
    frame = d.frames[0]  # a valid container has one, frame 1
    view = canvas[frame.y : frame.y + frame.height,
                  frame.x : frame.x + frame.width]
    if not decode_frame(_frame_payload(buf, frame), view):
        raise OSError("failed to read next frame")
    return canvas


def read_webp(buf):
    """(RGB (H, W, 3) uint8, ICC profile or None) of a WebP's bytes, as
    ``Image.open`` and ``convert("RGB")`` give them: `Unidentified` where
    the open fails, OSError where the load does."""
    from art_tpu_torch.io.unported import _bomb

    buf = memoryview(buf)
    d = open_webp(buf)
    _bomb(d.canvas)
    canvas = load(buf, d)
    return np.ascontiguousarray(canvas[..., :3]), d.iccp or None
