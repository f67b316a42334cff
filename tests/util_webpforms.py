"""Writers of WebP files for the decoder tests: Pillow's own save, its
bundled libwebp's ``WebPEncode`` through ``tests/webpwrite_helper.c`` for
the encoder options Pillow does not expose (the simple filter, sharpness,
segments, token partitions, filter strength, alpha filter and
compression), and containers written by hand (raw ALPH chunks, VP8X
with ICCP, animations whose frame 0 is offset and smaller than the
canvas). `stream_info` reads back what a bitstream holds, through the
port's own parse (``webp_vp8l_info``, ``webp_vp8_info``)."""

from __future__ import annotations

import ctypes
import glob
import io
import os
import shutil
import struct
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import PIL
from PIL import Image

HELPER_SRC = Path(__file__).with_name("webpwrite_helper.c")
_LIBS = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")

_HELPER = None


def helper():
    """The helper library, built once a process against Pillow's libwebp
    (its libsharpyuv loaded first, with RTLD_GLOBAL)."""
    global _HELPER
    if _HELPER is None:
        sharp = glob.glob(os.path.join(_LIBS, "libsharpyuv-*.so*"))[0]
        webp = glob.glob(os.path.join(_LIBS, "libwebp-*.so*"))[0]
        ctypes.CDLL(sharp, mode=ctypes.RTLD_GLOBAL)
        ctypes.CDLL(webp, mode=ctypes.RTLD_GLOBAL)
        cc = shutil.which("gcc") or shutil.which("cc")
        out = Path(tempfile.mkdtemp(prefix="webpwrite_")) / "helper.so"
        subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", str(out),
                        str(HELPER_SRC), webp, f"-Wl,-rpath,{_LIBS}"],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(out))
        lib.webp_helper_encode.restype = ctypes.c_int
        lib.webp_helper_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t)]
        _HELPER = lib
    return _HELPER


def encode(img, lossless=0, quality=75, method=4, segments=4, sns=50,
           filter_strength=60, sharpness=0, filter_type=1, autofilter=0,
           alpha_compression=1, alpha_filtering=1, alpha_quality=100,
           partitions=0, exact=0, passes=1):
    """`img` ((H, W, 3) or (H, W, 4) uint8) through libwebp's WebPEncode
    with these WebPConfig fields (partitions: log2 of the count; passes:
    ``pass``)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    use_alpha = int(img.shape[2] == 4)
    if not use_alpha:
        img = np.ascontiguousarray(np.concatenate(
            [img, np.full((h, w, 1), 255, np.uint8)], 2))
    opts = (ctypes.c_int * 16)(
        lossless, quality, method, segments, sns, filter_strength, sharpness,
        filter_type, autofilter, alpha_compression, alpha_filtering,
        alpha_quality, partitions, exact, use_alpha, passes)
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t(0)
    lib = helper()
    rc = lib.webp_helper_encode(img.ctypes.data, w, h, opts,
                                ctypes.byref(out), ctypes.byref(size))
    if rc != 0:
        raise RuntimeError(f"WebPEncode failed: {rc}")
    data = ctypes.string_at(out, size.value)
    lib.webp_helper_free(out)
    return data


def pil_save(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


# -- containers by hand ---------------------------------------------------

def chunk(kind, data):
    return kind + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def riff(*chunks):
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def le24(v):
    return struct.pack("<I", v)[:3]


def vp8x(flags, w, h):
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + le24(w - 1) + le24(h - 1))


def chunks_of(data):
    """[(kind, payload)] of a RIFF WEBP file's top-level chunks."""
    out, pos, end = [], 12, 8 + struct.unpack_from("<I", data, 4)[0]
    while pos + 8 <= end:
        kind = data[pos : pos + 4]
        n = struct.unpack_from("<I", data, pos + 4)[0]
        out.append((kind, data[pos + 8 : pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def alph(alpha, filt=0, method=0, pre=0):
    """An ALPH payload of raw alpha (method 0) filtered as libwebp's
    filters.c does (0 none, 1 horizontal, 2 vertical, 3 gradient)."""
    a = np.asarray(alpha, np.int32)
    h, w = a.shape
    d = a.copy()
    left = np.concatenate([np.zeros((h, 1), np.int32), a[:, :-1]], 1)
    up = np.concatenate([np.zeros((1, w), np.int32), a[:-1]], 0)
    if filt == 1:
        pred = left.copy()
        pred[1:, 0] = a[:-1, 0]
    elif filt == 2:
        pred = up.copy()
        pred[0] = left[0]
    elif filt == 3:
        ul = np.concatenate([np.zeros((h, 1), np.int32), up[:, :-1]], 1)
        pred = np.clip(left + up - ul, 0, 255)
        pred[0] = left[0]
        pred[1:, 0] = a[:-1, 0]
    else:
        pred = np.zeros_like(a)
    if filt:
        d = (a - pred) & 255
    return bytes([method | filt << 2 | pre << 4]) + d.astype(np.uint8).tobytes()


def still_with(parts, w, h, flags):
    """A VP8X still image of the chunks `parts` ((kind, payload))."""
    return riff(vp8x(flags, w, h), *[chunk(k, p) for k, p in parts])


def animation(canvas, frames, icc=None, bgcolor=0, loop=0):
    """An animated WebP: `frames` of (x, y, w, h, duration, bits, [(kind,
    payload)]), x and y even, with an optional ICCP chunk."""
    flags = 0x02 | (0x20 if icc else 0) | 0x10
    out = [vp8x(flags, *canvas)]
    if icc:
        out.append(chunk(b"ICCP", icc))
    out.append(chunk(b"ANIM", struct.pack("<IH", bgcolor, loop)))
    for x, y, w, h, dur, bits, parts in frames:
        body = (le24(x // 2) + le24(y // 2) + le24(w - 1) + le24(h - 1)
                + le24(dur) + bytes([bits]))
        body += b"".join(chunk(k, p) for k, p in parts)
        out.append(chunk(b"ANMF", body))
    return riff(*out)


def stream_info(data):
    """What a simple or VP8X still WebP's bitstream holds, read by the
    port's parse: ("VP8L", {...}) or ("VP8", {...})."""
    from art_tpu_torch.io import webpdec

    lib = webpdec._lib()
    kinds = dict(chunks_of(data))
    info = (ctypes.c_int * 9)()
    if b"VP8L" in kinds:
        p = kinds[b"VP8L"]
        assert lib.webp_vp8l_info(p, len(p), info) == 0
        keys = ("transforms", "t0", "t1", "t2", "t3", "colors", "cache_bits",
                "meta_bits", "groups")
        return "VP8L", dict(zip(keys, info))
    p = kinds[b"VP8 "]
    w = struct.unpack_from("<H", p, 6)[0] & 0x3FFF
    h = struct.unpack_from("<H", p, 8)[0] & 0x3FFF
    assert lib.webp_vp8_info(p, len(p), w, h, info) == 0
    keys = ("simple", "level", "sharpness", "segments_on", "map", "partitions",
            "segments_used", "i4x4", "skipped")
    return "VP8", dict(zip(keys, info))


# -- the committed fixtures (tests/data, recorded in formats_sha256.json) -------

def vp8l_all_transforms(w=97, h=66, seed=0):
    """A lossless WebP no encoder writes: all four transforms (colour
    indexing of 11 colours, two pixels a byte; subtract green; predictor
    by tiles of 4 with every mode 0-15; cross colour by tiles of 8), a
    colour cache of 4 bits, and meta prefix codes (two groups by tiles of
    8), every sub-image and pixel random, through chip_smoke's VP8L
    writer (literals of 8 bits)."""
    import chip_smoke as cs

    rng = np.random.default_rng(seed)

    def image(n, green=None):
        argb = rng.integers(0, 256, (n, 4)).astype(np.uint8)
        if green is not None:
            argb[:, 2] = green
        return argb

    def sub(bw, argb):
        bw.put(0, 1)  # no colour cache
        cs.vp8l_codes(bw)
        cs.vp8l_pixels(bw, argb)

    def tiles(size, bits):
        return (size + (1 << bits) - 1) >> bits

    bw = cs.LsbBits()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(1, 1)
    bw.put(0, 3)
    bw.put(1, 1)
    bw.put(3, 2)  # colour indexing: 11 colours, 2 pixels a byte
    bw.put(10, 8)
    sub(bw, image(11))
    xs = tiles(w, 1)
    bw.put(1, 1)
    bw.put(2, 2)  # subtract green
    bw.put(1, 1)
    bw.put(0, 2)  # predictor, tiles of 4
    bw.put(0, 3)
    n = tiles(xs, 2) * tiles(h, 2)
    sub(bw, image(n, np.arange(n) % 16))
    bw.put(1, 1)
    bw.put(1, 2)  # cross colour, tiles of 8
    bw.put(1, 3)
    sub(bw, image(tiles(xs, 3) * tiles(h, 3)))
    bw.put(0, 1)
    bw.put(1, 1)  # a colour cache of 4 bits
    bw.put(4, 4)
    bw.put(1, 1)  # meta prefix codes, tiles of 8
    bw.put(1, 3)
    n = tiles(xs, 3) * tiles(h, 3)
    groups = image(n, rng.integers(0, 2, n))
    groups[:, 1] = 0
    sub(bw, groups)
    cs.vp8l_codes(bw, cache_bits=4)
    cs.vp8l_codes(bw, cache_bits=4)
    cs.vp8l_pixels(bw, image(xs * h))
    return cs.webp_riff(bw.getvalue())


def smooth_scene(h, w, alpha=True):
    """W1's picture: soft colour gradients and blobs, and an alpha of a
    soft vignette (uint8, (H, W, 4) or (H, W, 3))."""
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    blob = np.exp(-((xx - 0.62) ** 2 / 0.05 + (yy - 0.4) ** 2 / 0.08))
    r = 0.55 * xx + 0.35 * blob + 0.1
    g = 0.5 * yy + 0.3 * np.exp(-((xx - 0.25) ** 2 + (yy - 0.7) ** 2) / 0.04)
    b = 0.6 * (1.0 - xx) * (1.0 - yy) + 0.25 * blob
    planes = [r, g + 0.15, b + 0.1]
    if alpha:
        vig = 1.0 - 0.8 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2) * 2.0
        planes.append(vig)
    return np.stack([np.clip(np.broadcast_to(p, (h, w)) * 255.0 + 0.5, 0,
                             255).astype(np.uint8) for p in planes], -1)


def fixtures():
    """name -> bytes of each committed WebP: one lossless file with all
    four transforms, a lossy file with the normal filter, 4 segments and
    alpha, a lossy file with the simple filter and 8 partitions, an
    animation (frame 0 offset and smaller than the canvas) with an ICCP
    chunk, W2's lossy mask, and W1's 24 MP lossy file with alpha."""
    from chip_smoke import f2_mask

    rng = np.random.default_rng(20)
    out = {"webp_lossless_transforms.webp": vp8l_all_transforms()}
    scene = smooth_scene(120, 160)
    scene[..., :3] += rng.integers(0, 12, (120, 160, 3)).astype(np.uint8)
    out["webp_lossy_alpha.webp"] = encode(
        scene, quality=60, segments=4, sns=100, filter_type=1,
        filter_strength=60, alpha_compression=1, alpha_filtering=3)
    out["webp_lossy_simple_8parts.webp"] = encode(
        scene[..., :3], quality=70, method=2, filter_type=0,
        filter_strength=70, sharpness=3, partitions=3)
    f0 = dict(chunks_of(encode(scene[:60, :80, :3], quality=75)))[b"VP8 "]
    f1 = dict(chunks_of(pil_save(scene[..., :3], lossless=True)))[b"VP8L"]
    icc = b"\x00\x00\x01\x00stand-in profile bytes of the test" * 3
    out["webp_anim_icc.webp"] = animation(
        (160, 120), [(34, 20, 80, 60, 90, 0, [(b"VP8 ", f0)]),
                     (0, 0, 160, 120, 90, 2, [(b"VP8L", f1)])], icc=icc)
    mask = f2_mask().astype(np.uint8)
    out["webp_w2_mask.webp"] = pil_save(np.repeat(mask[..., None], 3, 2),
                                        quality=80, method=4)
    out["webp_w1_24mp_alpha.webp"] = pil_save(smooth_scene(4000, 6000),
                                              quality=30, method=4)
    return out


# -- VP8 key frames written from random syntax elements -------------------------

class BoolWriter:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range = 255
        self.bottom = 0
        self.bit_count = 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob, bit):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v, n):
        for i in range(n - 1, -1, -1):
            self.put(128, (v >> i) & 1)

    def flagged(self, v, n):
        """A flag, then (where v is not 0) |v| in n bits and its sign."""
        self.put(128, v != 0)
        if v:
            self.value(abs(v), n)
            self.put(128, v < 0)

    def flush(self):
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def vp8_tables():
    """The VP8 spec's tables as the port's decoder holds them
    (io/native/webpdec.cc): update probabilities, default coefficient
    probabilities ((4, 8, 3, 11) each), the 4x4 mode probabilities
    ((10, 10, 9)), the DC and AC quantisers."""
    import re

    src = (Path(__file__).resolve().parent.parent / "art_tpu_torch" / "io"
           / "native" / "webpdec.cc").read_text()

    def table(name, shape):
        body = re.search(name + r"[^=]*= \{(.*?)\};", src, re.S).group(1)
        vals = [int(v) for v in re.findall(r"\d+", body)]
        return np.array(vals, np.int64).reshape(shape)

    return (table("kCoeffsUpdateProba", (4, 8, 3, 11)),
            table("kCoeffsProba0", (4, 8, 3, 11)),
            table("kBModesProba", (10, 10, 9)),
            table("kDcTable", (128,)), table("kAcTable", (128,)))


_BANDS = [0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0]
_CAT = [(173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129)]
# the 4x4 modes' tree paths over prob[0..8], in the decoder's mode order
# (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU)
_BMODE_PATH = [[(0, 0)], [(0, 1), (1, 0)], [(0, 1), (1, 1), (2, 0)],
               [(0, 1), (1, 1), (2, 1), (3, 0), (4, 0)],
               [(0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 0)],
               [(0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 1)],
               [(0, 1), (1, 1), (2, 1), (3, 1), (6, 0)],
               [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 0)],
               [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 0)],
               [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 1)]]


def _write_large(bw, p, v):
    if v <= 4:
        bw.put(p[3], 0)
        bw.put(p[4], v != 2)
        if v != 2:
            bw.put(p[5], v - 3)
    elif v <= 10:
        bw.put(p[3], 1)
        bw.put(p[6], 0)
        bw.put(p[7], v > 6)
        if v <= 6:
            bw.put(159, v - 5)
        else:
            bw.put(165, (v - 7) >> 1)
            bw.put(145, (v - 7) & 1)
    else:
        bw.put(p[3], 1)
        bw.put(p[6], 1)
        cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
        bw.put(p[8], cat >> 1)
        bw.put(p[9 + (cat >> 1)], cat & 1)
        extra, tab = v - 3 - (8 << cat), _CAT[cat]
        for i, prob in enumerate(tab):
            bw.put(prob, (extra >> (len(tab) - 1 - i)) & 1)


def _write_block(bw, probs, ctx, first, levels):
    """One 4x4 block's tokens (levels in zigzag order from `first`), as
    GetCoeffs reads them; returns the decoder's nz."""
    nonzero = [i for i in range(first, 16) if levels[i]]
    last = nonzero[-1] if nonzero else -1
    n = first
    p = probs[_BANDS[n]][ctx]
    while n < 16:
        if n > last:
            bw.put(p[0], 0)
            return n
        bw.put(p[0], 1)
        while levels[n] == 0:
            bw.put(p[1], 0)
            n += 1
            p = probs[_BANDS[n]][0]
        bw.put(p[1], 1)
        v = abs(int(levels[n]))
        nxt = probs[_BANDS[n + 1]]
        if v == 1:
            bw.put(p[2], 0)
            p = nxt[1]
        else:
            bw.put(p[2], 1)
            _write_large(bw, p, v)
            p = nxt[2]
        bw.put(128, levels[n] < 0)
        n += 1
    return 16


def random_vp8(seed, w=None, h=None, wild=False):
    """A VP8 key frame (the payload of a ``VP8 `` chunk) of random but
    valid syntax: segments (absolute or delta, a coded map or not), the
    simple or normal filter at any level and sharpness, loop-filter
    deltas, 1-8 token partitions, random probability updates, the
    macroblock skip flag, every 16x16, 4x4 and chroma mode, and sparse
    coefficients up to cat6 tokens, dequantised within +-2047 as an
    encoder's are, or with `wild` past it, as a damaged stream's can be
    (where libwebp's SSE2 inverse DCT wraps its 16-bit sums)."""
    upd_p, probs0, bmodes, dc_t, ac_t = vp8_tables()
    rng = np.random.default_rng(seed)
    w = int(rng.integers(1, 80)) if w is None else w
    h = int(rng.integers(1, 80)) if h is None else h
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    bw = BoolWriter()
    bw.put(128, 0)  # colour space
    bw.put(128, int(rng.integers(0, 2)))  # clamping type
    use_segment = bool(rng.integers(0, 2))
    update_map = use_segment and bool(rng.integers(0, 2))
    absolute = bool(rng.integers(0, 2))
    quant = [0] * 4
    seg_probs = [255, 255, 255]
    bw.put(128, use_segment)
    base_q = int(rng.integers(0, 128))
    if use_segment:
        bw.put(128, update_map)
        bw.put(128, 1)  # update data
        bw.put(128, absolute)
        for s in range(4):
            quant[s] = int(rng.integers(0, 128)) if absolute else int(
                rng.integers(-40, 41))
            bw.flagged(quant[s], 7)
        for s in range(4):
            bw.flagged(int(rng.integers(-63, 64)) if rng.random() < 0.7
                       else 0, 6)
        if update_map:
            for s in range(3):
                seg_probs[s] = int(rng.integers(1, 256)) \
                    if rng.random() < 0.8 else 255
                bw.put(128, seg_probs[s] != 255)
                if seg_probs[s] != 255:
                    bw.value(seg_probs[s], 8)
    bw.put(128, int(rng.integers(0, 2)))  # simple filter
    bw.value(int(rng.choice([0, int(rng.integers(1, 64))])), 6)
    bw.value(int(rng.integers(0, 8)), 3)
    use_lf_delta = bool(rng.integers(0, 2))
    bw.put(128, use_lf_delta)
    if use_lf_delta:
        bw.put(128, 1)
        for _ in range(8):
            bw.flagged(int(rng.integers(-63, 64)) if rng.random() < 0.6
                       else 0, 6)
    log_parts = int(rng.integers(0, 4))
    bw.value(log_parts, 2)
    bw.value(base_q, 7)
    deltas = [int(rng.integers(-15, 16)) if rng.random() < 0.5 else 0
              for _ in range(5)]
    for d in deltas:
        bw.flagged(d, 4)
    bw.put(128, 0)  # refresh entropy probabilities (ignored)
    probs = probs0.copy()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for q in range(11):
                    upd = rng.random() < 0.04
                    bw.put(int(upd_p[t, b, c, q]), upd)
                    if upd:
                        probs[t, b, c, q] = int(rng.integers(1, 256))
                        bw.value(int(probs[t, b, c, q]), 8)
    use_skip = bool(rng.integers(0, 2))
    skip_p = int(rng.integers(1, 255))
    bw.put(128, use_skip)
    if use_skip:
        bw.value(skip_p, 8)

    def dq(seg):
        q = quant[seg] + (0 if use_segment and absolute else base_q) \
            if use_segment else base_q
        clip = lambda v, m: min(max(v, 0), m)  # noqa: E731
        return {"y1": (dc_t[clip(q + deltas[0], 127)], ac_t[clip(q, 127)]),
                "y2": (dc_t[clip(q + deltas[1], 127)] * 2,
                       max(8, ac_t[clip(q + deltas[2], 127)] * 101581 >> 16)),
                "uv": (dc_t[clip(q + deltas[3], 117)],
                       ac_t[clip(q + deltas[4], 127)])}

    def levels(first, mat, density):
        lv = np.zeros(16, np.int64)
        for i in range(first, 16):
            if rng.random() < density:
                limit = 2114 if wild else max(1, 2047 // int(mat[i > 0]))
                mag = int(rng.integers(1, 3)) if rng.random() < 0.7 else \
                    int(rng.integers(1, min(limit, 2114) + 1))
                lv[i] = min(mag, limit) * (1 if rng.random() < 0.5 else -1)
        return lv

    intra_t = np.zeros(4 * mb_w, np.int64)
    parts = [BoolWriter() for _ in range(1 << log_parts)]
    top_nz = [[0, 0] for _ in range(mb_w)]  # (nz, nz_dc) per column
    for mb_y in range(mb_h):
        intra_l = [0, 0, 0, 0]
        rows = []
        for mb_x in range(mb_w):
            seg = int(rng.integers(0, 4)) if update_map else 0
            if update_map:
                bw.put(seg_probs[0], seg >= 2)
                bw.put(seg_probs[1 + (seg >= 2)], seg & 1)
            skip = use_skip and rng.random() < 0.3
            if use_skip:
                bw.put(skip_p, skip)
            i4x4 = bool(rng.integers(0, 2))
            bw.put(145, not i4x4)
            top = intra_t[4 * mb_x : 4 * mb_x + 4]
            if not i4x4:
                ymode = int(rng.integers(0, 4))  # DC, TM, V, H
                bw.put(156, ymode in (1, 3))
                bw.put(128 if ymode in (1, 3) else 163, ymode in (1, 2))
                top[:] = ymode
                intra_l = [ymode] * 4
            else:
                for y in range(4):
                    left = intra_l[y]
                    for x in range(4):
                        mode = int(rng.integers(0, 10))
                        prob = bmodes[top[x], left]
                        for node, bit in _BMODE_PATH[mode]:
                            bw.put(int(prob[node]), bit)
                        top[x] = left = mode
                    intra_l[y] = left
            uvmode = int(rng.integers(0, 4))  # DC, TM, V, H
            bw.put(142, uvmode != 0)
            if uvmode:
                bw.put(114, uvmode != 2)
                if uvmode != 2:
                    bw.put(183, uvmode == 1)
            rows.append((seg, skip, i4x4))
        # the row's tokens, contexts as ParseResiduals keeps them
        tb = parts[mb_y & ((1 << log_parts) - 1)]
        left_nz = [0, 0]
        density = float(rng.choice([0.05, 0.2, 0.6]))
        for mb_x, (seg, skip, i4x4) in enumerate(rows):
            mb_nz = top_nz[mb_x]
            if skip:
                mb_nz[0] = left_nz[0] = 0
                if not i4x4:
                    mb_nz[1] = left_nz[1] = 0
                continue
            m = dq(seg)
            if not i4x4:
                ctx = mb_nz[1] + left_nz[1]
                nz = _write_block(tb, probs[1], ctx, 0,
                                  levels(0, m["y2"], density / 2))
                mb_nz[1] = left_nz[1] = int(nz > 0)
                first, ptype = 1, 0
            else:
                first, ptype = 0, 3
            tnz, lnz = mb_nz[0] & 0x0F, left_nz[0] & 0x0F
            for _ in range(4):
                lbit = lnz & 1
                for _ in range(4):
                    ctx = lbit + (tnz & 1)
                    nz = _write_block(tb, probs[ptype], ctx, first,
                                      levels(first, m["y1"], density))
                    lbit = int(nz > first)
                    tnz = (tnz >> 1) | (lbit << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (lbit << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz = mb_nz[0] >> (4 + ch)
                lnz = left_nz[0] >> (4 + ch)
                for _ in range(2):
                    lbit = lnz & 1
                    for _ in range(2):
                        ctx = lbit + (tnz & 1)
                        nz = _write_block(tb, probs[2], ctx, 0,
                                          levels(0, m["uv"], density))
                        lbit = int(nz > 0)
                        tnz = (tnz >> 1) | (lbit << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (lbit << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            mb_nz[0], left_nz[0] = out_t & 0xFF, out_l & 0xFF
    part0 = bw.flush()
    tokens = [p.flush() for p in parts]
    tag = (1 << 4) | (len(part0) << 5)  # a shown key frame, profile 0
    scale = int(rng.integers(0, 4))  # the scale bits, which decoders skip
    head = (tag.to_bytes(3, "little") + b"\x9d\x01\x2a"
            + (w | scale << 14).to_bytes(2, "little")
            + (h | (3 - scale) << 14).to_bytes(2, "little"))
    sizes = b"".join(len(t).to_bytes(3, "little") for t in tokens[:-1])
    return head + part0 + sizes + b"".join(tokens)
