"""Texture and icon files Pillow 12.1.0 opens (DDS, BLP, ICNS), built
byte by byte in each form its plugin reads, for the tests against
Pillow (the DDS and BLP headers by `chip_smoke.py`'s writers, which also
write its K1 and K2 files). `FORMS` names each form; `fixtures()` writes
the small files committed in tests/data (their Pillow decodes' sha256 in
formats_sha256.json), which K1 tiles to 24 MP.

Block-compressed data: BC1-BC5 from random bytes (every block valid);
BC7 from random bytes under each mode's prefix, and the reserved mode
(a zero mode byte); BC6H mode by mode from the format's table of
header bit fields (below), each endpoint chosen where its half float
lands inside 0..1, so that the 8-bit clamp keeps it, and from random
bytes."""

import io
import struct

import numpy as np

from chip_smoke import blp2_bytes, dds_bytes
from util_rasterforms import picture

FOURCC = {1: b"DXT1", 2: b"DXT3", 3: b"DXT5"}
# DXGI codes: (n, signed)
DXGI = {71: 1, 74: 2, 77: 3, 80: 4, 83: 5, 84: 5, 95: 6, 96: 6, 98: 7,
        99: 7}


def block_bytes(n):
    return 8 if n in (1, 4) else 16


def random_blocks(n, count, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (count, block_bytes(n))).astype(np.uint8)


def dds_bcn(w, h, blocks, fourcc=None, dxgi=None):
    data = np.asarray(blocks, np.uint8).tobytes()
    if dxgi is not None:
        return dds_bytes(w, h, data, 4, b"DX10", dxgi=dxgi)
    return dds_bytes(w, h, data, 4, fourcc)


def nblocks(w, h):
    return ((w + 3) // 4) * ((h + 3) // 4)


# -- BC7 ---------------------------------------------------------------------

def bc7_blocks(count, seed, modes=range(9)):
    """Random BC7 blocks, their modes taken in turn from `modes` (8: the
    reserved mode, a zero first byte)."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 256, (count, 16)).astype(np.uint8)
    modes = list(modes)
    for i in range(count):
        m = modes[i % len(modes)]
        if m == 8:
            out[i, 0] = 0
        else:
            keep = int(out[i, 0]) & ~((1 << (m + 1)) - 1) & 255
            out[i, 0] = keep | (1 << m)
    return out


# -- BC6H --------------------------------------------------------------------

def _f(*fields):
    """A mode's header bits after its mode bits: (endpoint, bit) in the
    order stored, from fields (name, high bit, low bit), a field written
    high:low stored from its low bit, low:high (reversed) from its
    high."""
    out = []
    for name, hi, lo in fields:
        bits = range(lo, hi + 1) if hi >= lo else range(lo, hi - 1, -1)
        out += [(name, b) for b in bits]
    return out


def _r(name, hi, lo=None):
    return (name, hi, hi if lo is None else lo)


# the 14 modes' header bit fields: w, x the first region's endpoints, y,
# z the second's; the mode bits (2 for the first two, else 5), the
# partition (5 bits, two-region modes) and the indices follow
BC6_FIELDS = [
    _f(_r("gy", 4), _r("by", 4), _r("bz", 4), _r("rw", 9, 0), _r("gw", 9, 0),
       _r("bw", 9, 0), _r("rx", 4, 0), _r("gz", 4), _r("gy", 3, 0),
       _r("gx", 4, 0), _r("bz", 0), _r("gz", 3, 0), _r("bx", 4, 0),
       _r("bz", 1), _r("by", 3, 0), _r("ry", 4, 0), _r("bz", 2),
       _r("rz", 4, 0), _r("bz", 3)),
    _f(_r("gy", 5), _r("gz", 4), _r("gz", 5), _r("rw", 6, 0), _r("bz", 0),
       _r("bz", 1), _r("by", 4), _r("gw", 6, 0), _r("by", 5), _r("bz", 2),
       _r("gy", 4), _r("bw", 6, 0), _r("bz", 3), _r("bz", 5), _r("bz", 4),
       _r("rx", 5, 0), _r("gy", 3, 0), _r("gx", 5, 0), _r("gz", 3, 0),
       _r("bx", 5, 0), _r("by", 3, 0), _r("ry", 5, 0), _r("rz", 5, 0)),
    _f(_r("rw", 9, 0), _r("gw", 9, 0), _r("bw", 9, 0), _r("rx", 4, 0),
       _r("rw", 10), _r("gy", 3, 0), _r("gx", 3, 0), _r("gw", 10),
       _r("bz", 0), _r("gz", 3, 0), _r("bx", 3, 0), _r("bw", 10), _r("bz", 1),
       _r("by", 3, 0), _r("ry", 4, 0), _r("bz", 2), _r("rz", 4, 0),
       _r("bz", 3)),
    _f(_r("rw", 9, 0), _r("gw", 9, 0), _r("bw", 9, 0), _r("rx", 3, 0),
       _r("rw", 10), _r("gz", 4), _r("gy", 3, 0), _r("gx", 4, 0),
       _r("gw", 10), _r("gz", 3, 0), _r("bx", 3, 0), _r("bw", 10),
       _r("bz", 1), _r("by", 3, 0), _r("ry", 3, 0), _r("bz", 0), _r("bz", 2),
       _r("rz", 3, 0), _r("gy", 4), _r("bz", 3)),
    _f(_r("rw", 9, 0), _r("gw", 9, 0), _r("bw", 9, 0), _r("rx", 3, 0),
       _r("rw", 10), _r("by", 4), _r("gy", 3, 0), _r("gx", 3, 0),
       _r("gw", 10), _r("bz", 0), _r("gz", 3, 0), _r("bx", 4, 0),
       _r("bw", 10), _r("by", 3, 0), _r("ry", 3, 0), _r("bz", 1), _r("bz", 2),
       _r("rz", 3, 0), _r("bz", 4), _r("bz", 3)),
    _f(_r("rw", 8, 0), _r("by", 4), _r("gw", 8, 0), _r("gy", 4),
       _r("bw", 8, 0), _r("bz", 4), _r("rx", 4, 0), _r("gz", 4),
       _r("gy", 3, 0), _r("gx", 4, 0), _r("bz", 0), _r("gz", 3, 0),
       _r("bx", 4, 0), _r("bz", 1), _r("by", 3, 0), _r("ry", 4, 0),
       _r("bz", 2), _r("rz", 4, 0), _r("bz", 3)),
    _f(_r("rw", 7, 0), _r("gz", 4), _r("by", 4), _r("gw", 7, 0), _r("bz", 2),
       _r("gy", 4), _r("bw", 7, 0), _r("bz", 3), _r("bz", 4), _r("rx", 5, 0),
       _r("gy", 3, 0), _r("gx", 4, 0), _r("bz", 0), _r("gz", 3, 0),
       _r("bx", 4, 0), _r("bz", 1), _r("by", 3, 0), _r("ry", 5, 0),
       _r("rz", 5, 0)),
    _f(_r("rw", 7, 0), _r("bz", 0), _r("by", 4), _r("gw", 7, 0), _r("gy", 5),
       _r("gy", 4), _r("bw", 7, 0), _r("gz", 5), _r("bz", 4), _r("rx", 4, 0),
       _r("gz", 4), _r("gy", 3, 0), _r("gx", 5, 0), _r("gz", 3, 0),
       _r("bx", 4, 0), _r("bz", 1), _r("by", 3, 0), _r("ry", 4, 0),
       _r("bz", 2), _r("rz", 4, 0), _r("bz", 3)),
    _f(_r("rw", 7, 0), _r("bz", 1), _r("by", 4), _r("gw", 7, 0), _r("by", 5),
       _r("gy", 4), _r("bw", 7, 0), _r("bz", 5), _r("bz", 4), _r("rx", 4, 0),
       _r("gz", 4), _r("gy", 3, 0), _r("gx", 4, 0), _r("bz", 0),
       _r("gz", 3, 0), _r("bx", 5, 0), _r("by", 3, 0), _r("ry", 4, 0),
       _r("bz", 2), _r("rz", 4, 0), _r("bz", 3)),
    _f(_r("rw", 5, 0), _r("gz", 4), _r("bz", 0), _r("bz", 1), _r("by", 4),
       _r("gw", 5, 0), _r("gy", 5), _r("by", 5), _r("bz", 2), _r("gy", 4),
       _r("bw", 5, 0), _r("gz", 5), _r("bz", 3), _r("bz", 5), _r("bz", 4),
       _r("rx", 5, 0), _r("gy", 3, 0), _r("gx", 5, 0), _r("gz", 3, 0),
       _r("bx", 5, 0), _r("by", 3, 0), _r("ry", 5, 0), _r("rz", 5, 0)),
    _f(_r("rw", 9, 0), _r("gw", 9, 0), _r("bw", 9, 0), _r("rx", 9, 0),
       _r("gx", 9, 0), _r("bx", 9, 0)),
    _f(_r("rw", 9, 0), _r("gw", 9, 0), _r("bw", 9, 0), _r("rx", 8, 0),
       _r("rw", 10), _r("gx", 8, 0), _r("gw", 10), _r("bx", 8, 0),
       _r("bw", 10)),
    _f(_r("rw", 9, 0), _r("gw", 9, 0), _r("bw", 9, 0), _r("rx", 7, 0),
       _r("rw", 10, 11), _r("gx", 7, 0), _r("gw", 10, 11), _r("bx", 7, 0),
       _r("bw", 10, 11)),
    _f(_r("rw", 9, 0), _r("gw", 9, 0), _r("bw", 9, 0), _r("rx", 3, 0),
       _r("rw", 10, 15), _r("gx", 3, 0), _r("gw", 10, 15), _r("bx", 3, 0),
       _r("bw", 10, 15)),
]
# each mode's bits, its (endpoint bits, delta bits of r, g, b, transformed)
BC6_MODE_BITS = [0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15]
BC6_PREC = [(10, 5, 5, 5, 1), (7, 6, 6, 6, 1), (11, 5, 4, 4, 1),
            (11, 4, 5, 4, 1), (11, 4, 4, 5, 1), (9, 5, 5, 5, 1),
            (8, 6, 5, 5, 1), (8, 5, 6, 5, 1), (8, 5, 5, 6, 1), (6, 6, 6, 6, 0),
            (10, 10, 10, 10, 0), (11, 9, 9, 9, 1), (12, 8, 8, 8, 1),
            (16, 4, 4, 4, 1)]


def bc6h_block(mode, values, partition, indices):
    """A BC6H block of `mode` (0-13): `values` endpoint name -> its stored
    bits, the partition (two-region modes) and the index bits, anchors
    one bit short, as one int of all index bits in pixel order."""
    m = BC6_MODE_BITS[mode]
    bits = [(m, 2 if mode < 2 else 5)]
    for name, b in BC6_FIELDS[mode]:
        bits.append((values.get(name, 0) >> b & 1, 1))
    if mode < 10:
        bits.append((partition, 5))
    v, pos = 0, 0
    for val, n in bits:
        v |= (val & ((1 << n) - 1)) << pos
        pos += n
    v |= indices << pos
    return v.to_bytes(16, "little")


def bc6h_visible(mode, signed, rng):
    """A block of `mode` whose endpoints' half floats fall inside 0..1:
    each first endpoint in the window, the others (deltas in a
    transformed mode) near it, random partition and indices."""
    epb, rb, gb, bb, tr = BC6_PREC[mode]
    top = (1 << epb) - 1
    # the half float of 31/32 (signed) or 31/64 of the unquantized value,
    # ((q << 15) + 0x4000) >> (epb - 1) or ((q << 16) + 0x8000) >> epb,
    # lies inside 1/255 .. 1 for q inside 0.24 .. 0.47 of its range
    scale = 1 << (epb - 1 if signed else epb)
    lo, hi = int(0.24 * scale), int(0.47 * scale)
    values = {}
    regions = 2 if mode < 10 else 1
    for c, db in zip("rgb", (rb, gb, bb)):
        w = int(rng.integers(lo, hi))
        values[c + "w"] = w
        for e in ("x", "y", "z")[: 2 * regions - 1]:
            if tr:
                span = min((1 << (db - 1)) - 1, max(1, (hi - lo) // 4))
                values[c + e] = int(rng.integers(-span, span + 1)) & (
                    (1 << db) - 1)
            else:
                values[c + e] = int(rng.integers(lo, hi)) & top
    nbits = 46 if regions == 2 else 63
    return bc6h_block(mode, values, int(rng.integers(0, 32)),
                      int(rng.integers(0, 1 << 62)) << (nbits - 62)
                      if nbits > 62 else int(rng.integers(0, 1 << nbits)))


def bc6h_blocks(signed, per_mode, seed):
    """`per_mode` visible blocks of each of the 14 modes in turn, then as
    many random blocks of each mode and of the reserved modes."""
    rng = np.random.default_rng(seed)
    out = [bc6h_visible(m, signed, rng) for _ in range(per_mode)
           for m in range(14)]
    raw = rng.integers(0, 256, (per_mode * 18, 16)).astype(np.uint8)
    for i in range(len(raw)):
        m = (BC6_MODE_BITS + [19, 23, 27, 31])[i % 18]
        k = 2 if m < 2 else 5
        raw[i, 0] = (int(raw[i, 0]) & ~((1 << k) - 1) & 255) | m
    return np.frombuffer(b"".join(out), np.uint8).reshape(-1, 16), raw


# -- DDS of masks, luminance, palette ----------------------------------------

def dds_masks(rgba, bitcount, masks, pfflags=0x40, cut=None):
    """An uncompressed DDS of (H, W, 4) samples packed into `bitcount`-bit
    little-endian values by `masks` (each sample's top bits at its
    mask's bits), the body cut to `cut` bytes where given."""
    h, w = rgba.shape[:2]
    v = np.zeros((h, w), np.uint64)
    for i, mask in enumerate(masks):
        if not mask:
            continue
        bits = [b for b in range(32) if mask >> b & 1]
        s = rgba[..., i].astype(np.uint64)
        for k, b in enumerate(reversed(bits)):  # the sample's top bits first
            v |= ((s >> np.uint64(7 - k)) & np.uint64(1)) << np.uint64(b) \
                if k < 8 else np.uint64(0)
    k = bitcount // 8
    data = b"".join(int(x).to_bytes(8, "little")[:k] for x in v.ravel())
    if cut is not None:
        data = data[:cut]
    return dds_bytes(w, h, data, pfflags, bitcount=bitcount,
                     masks=tuple(masks) + (0,) * (4 - len(masks)))


def dds_lum(arr, alpha=False):
    h, w = arr.shape[:2]
    return dds_bytes(w, h, np.ascontiguousarray(arr, np.uint8).tobytes(),
                     0x20001 if alpha else 0x20000, bitcount=16 if alpha
                     else 8)


def dds_palette(idx, palette_rgba):
    h, w = idx.shape
    return dds_bytes(w, h, np.ascontiguousarray(idx, np.uint8).tobytes(),
                     0x20, bitcount=8,
                     extra=np.asarray(palette_rgba, np.uint8).tobytes())


# -- BLP ---------------------------------------------------------------------

def blp1(w, h, compression, alpha, encoding, body, offsets=None,
         lengths=None):
    """A BLP1: the 28-byte header, the mipmap offsets and lengths (the
    first at the body's start and of its length, unless given), body."""
    offs = offsets or [28 + 128] + [0] * 15
    lens = lengths or [len(body)] + [0] * 15
    return (b"BLP1" + struct.pack("<iIIIii", compression, alpha, w, h,
                                  encoding, 0)
            + struct.pack("<16I", *offs) + struct.pack("<16I", *lens) + body)


def blp1_jpeg(jpg, w, h, alpha=0, split=20):
    """BLP1's JPEG form: the stream's first `split` bytes as the shared
    header, the rest as the first mipmap, right after it."""
    head, rest = jpg[:split], jpg[split:]
    at = 28 + 128 + 4 + len(head)
    return blp1(w, h, 0, alpha, 5, struct.pack("<I", len(head)) + head + rest,
                offsets=[at] + [0] * 15, lengths=[len(rest)] + [0] * 15)


def blp1_palette(idx, bgra, alpha=0, encoding=4):
    """BLP1's palette form: the 256 BGRA entries, then the indices (read
    from where the palette ends)."""
    h, w = idx.shape
    data = np.ascontiguousarray(idx, np.uint8).tobytes()
    return blp1(w, h, 1, alpha, encoding,
                np.asarray(bgra, np.uint8).tobytes() + data,
                lengths=[len(data)] + [0] * 15)


def blp2_dxt(w, h, kind, alpha_depth, seed):
    """A BLP2 of DXT1 (kind 1), DXT3 (3) or DXT5 (5) blocks from random
    bytes."""
    size = 8 if kind == 1 else 16
    data = np.random.default_rng(seed).integers(
        0, 256, nblocks(w, h) * size).astype(np.uint8).tobytes()
    return blp2_bytes(w, h, 2, alpha_depth, {1: 0, 3: 1, 5: 7}[kind], data)


def blp2_palette(idx, bgra, alpha_depth=0):
    h, w = idx.shape
    return blp2_bytes(w, h, 1, alpha_depth, 0,
                      np.ascontiguousarray(idx, np.uint8).tobytes(),
                      np.asarray(bgra, np.uint8).tobytes())


# -- ICNS --------------------------------------------------------------------

def icns_rle(channel):
    """Apple's PackBits of one channel's bytes: runs of 3 to 130 as 0x80 +
    n - 3 and the byte, literals of 1 to 128 as n - 1 and the bytes."""
    data = bytes(channel)
    out = bytearray()
    i = 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 130 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([0x80 + j - i - 3, data[i]])
            i = j
            continue
        j = i
        while j < len(data) and j - i < 128 and not (
                j + 2 < len(data) and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def icns_rgb(rgb, rle=True):
    """An icon's 24-bit block body: raw RGB, or the three channels in
    Apple's PackBits one after another."""
    if not rle:
        return np.ascontiguousarray(rgb, np.uint8).tobytes()
    return b"".join(icns_rle(rgb[..., c].tobytes()) for c in range(3))


def icns(blocks):
    """An ICNS of (code, body) blocks in order."""
    body = b"".join(code + struct.pack(">I", 8 + len(b)) + b
                    for code, b in blocks)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def _png(arr):
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(arr).save(b, "PNG")
    return b.getvalue()


def _png_p(rgb):
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(rgb).quantize(16).save(b, "PNG")
    return b.getvalue()


def _jpeg(arr, **kw):
    from PIL import Image

    b = io.BytesIO()
    img = Image.frombytes("CMYK", arr.shape[1::-1], arr.tobytes()) \
        if arr.ndim == 3 and arr.shape[2] == 4 else Image.fromarray(arr)
    img.save(b, "JPEG", quality=90, **kw)
    return b.getvalue()


def _jp2(arr):
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(arr).save(b, "JPEG2000")
    return b.getvalue()


# -- the forms ---------------------------------------------------------------

def _forms():
    f = {}
    for n in (1, 2, 3):
        for w, h in ((8, 8), (6, 10)):
            f[f"DDS {FOURCC[n].decode()} {w}x{h}"] = dds_bcn(
                w, h, random_blocks(n, nblocks(w, h), n), FOURCC[n])
    for cc, n in ((b"BC4U", 4), (b"ATI1", 4), (b"BC5U", 5), (b"ATI2", 5),
                  (b"BC5S", 5)):
        f[f"DDS {cc.decode()} 10x6"] = dds_bcn(
            10, 6, random_blocks(n, nblocks(10, 6), n + 10), cc)
    for code, n in DXGI.items():
        if n in (6, 7):
            continue
        f[f"DDS DX10 {code} 8x12"] = dds_bcn(
            8, 12, random_blocks(n, nblocks(8, 12), code), dxgi=code)
    # BC7: each mode and the reserved one, and a seeded batch
    for m in range(9):
        f[f"DDS BC7 mode {m if m < 8 else 'reserved'}"] = dds_bcn(
            16, 16, bc7_blocks(16, 30 + m, [m]), dxgi=98)
    f["DDS BC7 random 64x40"] = dds_bcn(64, 40, bc7_blocks(160, 40),
                                        dxgi=98)
    f["DDS BC7 sRGB 6x6"] = dds_bcn(6, 6, bc7_blocks(4, 41), dxgi=99)
    for signed, code in ((0, 95), (1, 96)):
        vis, raw = bc6h_blocks(signed, 4, 50 + signed)
        name = "SF16" if signed else "UF16"
        f[f"DDS BC6H {name}, 14 modes"] = dds_bcn(56, 16, vis, dxgi=code)
        f[f"DDS BC6H {name} random"] = dds_bcn(72, 16, raw, dxgi=code)
    # uncompressed
    rgba = picture(10, 14, 4, seed=60)
    f["DDS R5G6B5"] = dds_masks(rgba, 16, (0xF800, 0x7E0, 0x1F))
    f["DDS A1R5G5B5"] = dds_masks(rgba, 16, (0x7C00, 0x3E0, 0x1F, 0x8000),
                                  0x41)
    f["DDS X8R8G8B8"] = dds_masks(rgba, 32, (0xFF0000, 0xFF00, 0xFF))
    f["DDS A8B8G8R8"] = dds_masks(rgba, 32, (0xFF, 0xFF00, 0xFF0000,
                                             0xFF000000), 0x41)
    f["DDS R8G8B8"] = dds_masks(rgba, 24, (0xFF0000, 0xFF00, 0xFF))
    f["DDS masks with gaps"] = dds_masks(rgba, 32, (0xB00000, 0x5A00, 0x13,
                                                    0x80000000), 0x41)
    f["DDS 12-bit masks (one byte read)"] = dds_masks(rgba, 12,
                                                     (0xE0, 0x1C, 0x3))
    f["DDS R5G6B5 cut short"] = dds_masks(rgba, 16, (0xF800, 0x7E0, 0x1F),
                                          cut=101)
    f["DDS L"] = dds_lum(rgba[..., 0])
    f["DDS LA"] = dds_lum(rgba[..., :2], alpha=True)
    pal = np.random.default_rng(61).integers(0, 256, (256, 4))
    f["DDS P"] = dds_palette(rgba[..., 1], pal)
    f["DDS DX10 R8G8B8A8"] = dds_bytes(14, 10, rgba.tobytes(), 4, b"DX10",
                                       dxgi=28)
    f["DDS DX10 R8G8B8A8 sRGB"] = dds_bytes(14, 10, rgba.tobytes(), 4,
                                            b"DX10", dxgi=29)
    f["DDS DXT1 cut short"] = dds_bcn(8, 8, random_blocks(1, 4, 62),
                                      FOURCC[1])[:-11]
    f["DDS L cut short"] = dds_lum(rgba[..., 0])[:-30]
    # BLP1: JPEG and palette
    rgb = picture(24, 32, 3, seed=70)
    f["BLP1 JPEG RGB"] = blp1_jpeg(_jpeg(rgb), 32, 24)
    f["BLP1 JPEG RGB, alpha flag"] = blp1_jpeg(_jpeg(rgb), 32, 24, alpha=8)
    f["BLP1 JPEG grey"] = blp1_jpeg(_jpeg(rgb[..., 0]), 32, 24)
    f["BLP1 JPEG CMYK"] = blp1_jpeg(_jpeg(picture(24, 32, 4, seed=71)), 32,
                                    24)
    f["BLP1 JPEG of another size"] = blp1_jpeg(_jpeg(rgb), 30, 20)
    f["BLP1 JPEG too small"] = blp1_jpeg(_jpeg(rgb[:8]), 32, 24)
    bgra = np.random.default_rng(72).integers(0, 256, (256, 4))
    idx = picture(12, 16, 1, seed=73)[..., 0]
    for enc in (4, 5):
        for alpha in (0, 1):
            f[f"BLP1 palette, encoding {enc}, alpha {alpha}"] = \
                blp1_palette(idx, bgra, alpha, enc)
    f["BLP1 encoding 3"] = blp1_palette(idx, bgra, 0, 3)
    f["BLP1 compression 2"] = blp1(16, 12, 2, 0, 5, bytes(300))
    # BLP2: palette and DXT
    f["BLP2 palette"] = blp2_palette(idx, bgra)
    f["BLP2 palette, alpha 8"] = blp2_palette(idx, bgra, 8)
    f["BLP2 palette, short data"] = blp2_palette(idx[:5], bgra)[:-3]
    for kind in (1, 3, 5):
        for w in (6, 8):
            for alpha in (0, 8 if kind > 1 else 1):
                f[f"BLP2 DXT{kind} {w}x8, alpha {alpha}"] = blp2_dxt(
                    w, 8, kind, alpha, 80 + kind * 10 + w + alpha)
    f["BLP2 DXT5 cut short"] = blp2_dxt(8, 8, 5, 8, 99)[:-20]
    f["BLP2 encoding 3"] = blp2_bytes(8, 8, 3, 0, 0, bytes(64))
    f["BLP2 alpha encoding 5"] = blp2_bytes(8, 8, 2, 8, 5, bytes(64))
    f["BLP2 compression 0"] = blp2_bytes(8, 8, 1, 0, 0,
                                         bytes(64)).replace(
        b"BLP2\1\0\0\0", b"BLP2\0\0\0\0", 1)
    # ICNS
    rgb16, rgb32 = picture(16, 16, 3, seed=90), picture(32, 32, 3, seed=91)
    rgb48, rgb128 = picture(48, 48, 3, seed=92), picture(128, 128, 3, seed=93)
    m16, m32 = picture(16, 16, 1, seed=94)[..., 0], picture(32, 32, 1,
                                                            seed=95)[..., 0]
    f["ICNS is32 raw, s8mk"] = icns([(b"is32", icns_rgb(rgb16, False)),
                                     (b"s8mk", m16.tobytes())])
    f["ICNS is32 RLE, no mask"] = icns([(b"is32", icns_rgb(rgb16))])
    f["ICNS il32 RLE, l8mk"] = icns([(b"il32", icns_rgb(rgb32)),
                                     (b"l8mk", m32.tobytes()),
                                     (b"is32", icns_rgb(rgb16))])
    f["ICNS ih32 RLE, h8mk"] = icns([(b"ih32", icns_rgb(rgb48)),
                                     (b"h8mk", bytes(48 * 48))])
    f["ICNS it32 RLE, t8mk"] = icns([(b"it32", bytes(4) + icns_rgb(rgb128)),
                                     (b"t8mk", bytes(range(256)) * 64)])
    f["ICNS it32 bad signature"] = icns([(b"it32", b"\0\0\0\1"
                                          + icns_rgb(rgb128))])
    f["ICNS RLE channel short"] = icns([(b"is32", icns_rgb(rgb16)[:-40])])
    f["ICNS RLE run past the channel"] = icns(
        [(b"is32", b"\x84\x07" * 42 + bytes([0xFF, 1]) * 2)])
    f["ICNS mask short"] = icns([(b"l8mk", bytes(100)),
                                 (b"il32", icns_rgb(rgb32))])
    f["ICNS mask alone"] = icns([(b"s8mk", m16.tobytes())])
    rgba128 = picture(128, 128, 4, seed=96)
    f["ICNS ic07 PNG"] = icns([(b"ic07", _png(rgba128)),
                               (b"it32", bytes(4) + icns_rgb(rgb128))])
    f["ICNS ic07 PNG of 64x64"] = icns([(b"ic07", _png(rgb128[:64, :64]))])
    f["ICNS ic07 PNG of 100x100"] = icns([(b"ic07", _png(rgb128[:100,
                                                                :100]))])
    f["ICNS icp4 grey PNG"] = icns([(b"icp4", _png(m16))])
    f["ICNS icp4 palette PNG"] = icns([(b"icp4", _png_p(rgb16))])
    f["ICNS icp4 grey PNG, 16-bit"] = icns([(b"icp4", _png(
        picture(16, 16, 1, seed=97)[..., 0].astype(np.uint16) * 257))])
    f["ICNS ic08 JPEG 2000"] = icns([(b"ic08", _jp2(picture(256, 256, 3,
                                                            seed=98))),
                                     (b"is32", icns_rgb(rgb16))])
    f["ICNS JPEG 2000 of a smaller size"] = icns(
        [(b"icp5", _jp2(rgb32)), (b"il32", icns_rgb(rgb32)),
         (b"it32", bytes(4) + icns_rgb(rgb128))])
    f["ICNS unknown subimage"] = icns([(b"ic09", b"GIF89a" + bytes(40))])
    return f


FORMS = _forms()


def fixtures():
    """name -> bytes of the small texture and icon files committed in
    tests/data; K1 tiles the first three's blocks to 24 MP."""
    vis, _ = bc6h_blocks(1, 4, 100)
    blocks1 = random_blocks(1, 256, 101)
    blocks1[::7, :4] = blocks1[::7, [2, 3, 0, 1]]  # some c0 <= c1 blocks
    return {
        "tex_bc1.dds": dds_bcn(64, 64, blocks1, FOURCC[1]),
        "tex_bc7.dds": dds_bcn(64, 64, bc7_blocks(256, 102), dxgi=98),
        "tex_dxt5.blp": blp2_dxt(64, 64, 5, 8, 103),
        "tex_bc6h_sf16.dds": dds_bcn(56, 16, vis, dxgi=96),
        "tex_bc5s.dds": dds_bcn(32, 32, random_blocks(5, 64, 104),
                                b"BC5S"),
        "tex_jpeg.blp": blp1_jpeg(_jpeg(picture(32, 48, 3, seed=105)), 48,
                                  32),
        "tex_rle.icns": icns([(b"is32", icns_rgb(picture(16, 16, 3,
                                                         seed=106))),
                              (b"il32", icns_rgb(picture(32, 32, 3,
                                                         seed=107))),
                              (b"l8mk", bytes(range(256)) * 4)]),
    }
