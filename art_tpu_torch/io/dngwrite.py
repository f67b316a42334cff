"""Minimal DNG writer (a copy of ``art_tpu/io/dngwrite.py``; host, numpy):
uncompressed or LJ92 strips, the LJ92 scan packed in numpy
(`_pack_scan`) to the reference's bytes. The optional JPEG preview goes
through the port's own encoder (:mod:`art_tpu_torch.io.jpeg`).

Exists for two reasons: (a) a test oracle for the native decoder — encode a
known mosaic, decode it back bit-exactly; (b) the framework's own raw
export / preconversion cache format. Writes little-endian TIFF6 + DNG 1.4
tags with a Bayer CFA layout.
"""

from __future__ import annotations

import heapq
import struct

import numpy as np

# TIFF types
T_BYTE, T_ASCII, T_SHORT, T_LONG, T_RATIONAL = 1, 2, 3, 4, 5
T_SRATIONAL = 10

CFA_CODE = {"R": 0, "G": 1, "B": 2}


def _huffman_table(hist):
    """Build JPEG-style Huffman (BITS[1..16], HUFFVAL) from symbol counts."""
    # package-merge would be proper; classic heapq Huffman then length-limit
    syms = [s for s, c in enumerate(hist) if c > 0]
    if len(syms) == 1:
        return {syms[0]: (1, 0)}, [0] * 17, syms
    heap = [(c, i, (s,)) for i, (s, c) in
            enumerate((s, hist[s]) for s in syms)]
    heapq.heapify(heap)
    lengths = {s: 0 for s in syms}
    uid = len(heap)
    while len(heap) > 1:
        c1, _, s1 = heapq.heappop(heap)
        c2, _, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            lengths[s] += 1
        heapq.heappush(heap, (c1 + c2, uid, s1 + s2))
        uid += 1
    # clamp to 16 (rarely needed for 17 symbols)
    for s in lengths:
        lengths[s] = min(lengths[s], 16)
    # canonical code assignment
    order = sorted(syms, key=lambda s: (lengths[s], s))
    bits = [0] * 17
    for s in order:
        bits[lengths[s]] += 1
    # fix Kraft if clamping broke it
    while sum(bits[l] * 2 ** (16 - l) for l in range(1, 17)) > 2 ** 16:
        for l in range(16, 0, -1):
            if bits[l] > 0:
                bits[l] -= 1
                bits[min(l + 1, 16)] += 1
                break
    code = 0
    codes = {}
    i = 0
    huffval = []
    for l in range(1, 17):
        for _ in range(bits[l]):
            s = order[i]
            codes[s] = (l, code)
            huffval.append(s)
            code += 1
            i += 1
        code <<= 1
    return codes, bits, huffval


def _pack_scan(diffs, cats, codes):
    """The entropy-coded scan as the reference's bit writer
    (``art_tpu/io/dngwrite.py::_BitWriter``) writes it symbol by symbol
    (each sample's Huffman code, then its c low bits of the difference,
    none for category 16; 0xFF bytes stuffed; the last byte padded with
    1s), in numpy: each sample's codeword of up to 32 bits placed at its
    bit offset in a stream of big-endian 32-bit words (disjoint bits, so
    the words are sums)."""
    lens = np.array([codes.get(c, (0, 0))[0] for c in range(17)], np.int64)
    vals = np.array([codes.get(c, (0, 0))[1] for c in range(17)], np.int64)
    extra = np.where(cats == 16, 0, cats)
    low = np.where(diffs >= 0, diffs, diffs + (1 << extra) - 1) \
        & ((1 << extra) - 1)
    word = ((vals[cats] << extra) | low).astype(np.uint64)
    n = lens[cats] + extra
    end = np.cumsum(n)
    total = int(end[-1]) if len(end) else 0
    off = end - n
    j = off >> 5
    shift = (64 - n - (off & 31)).astype(np.uint64)
    v = np.where(n > 0, word << np.minimum(shift, np.uint64(63)), 0)
    nwords = (total + 31) // 32 + 1
    acc = (np.bincount(j, weights=(v >> np.uint64(32)).astype(np.float64),
                       minlength=nwords)
           + np.bincount(j + 1, weights=(v & np.uint64(0xFFFFFFFF)).astype(
               np.float64), minlength=nwords + 1)[:nwords])
    data = np.frombuffer(acc.astype(np.uint64).astype(">u4").tobytes(),
                         np.uint8)[: (total + 7) // 8].copy()
    if total % 8:
        data[-1] |= (1 << (8 - total % 8)) - 1
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def lj92_encode(img: np.ndarray, precision=16, predictor=1) -> bytes:
    """Encode a (H, W) uint16 plane as lossless JPEG (SOF3, 1 component)."""
    img = np.asarray(img, dtype=np.int64)
    h, w = img.shape
    # diffs under the predictor
    diffs = np.zeros((h, w), dtype=np.int64)
    default = 1 << (precision - 1)
    for row in range(h):
        ra = np.empty(w, dtype=np.int64)
        if row == 0:
            ra[0] = default
            ra[1:] = img[0, :-1]
        else:
            ra[0] = img[row - 1, 0]
            if predictor == 1:
                ra[1:] = img[row, :-1]
            elif predictor == 2:
                ra[1:] = img[row - 1, 1:]
            else:
                ra[1:] = img[row, :-1]
        diffs[row] = img[row] - ra
    # mod-2^16 domain: wrap into [-32768, 32767]; -32768 is category 16
    diffs = ((diffs + 32768) & 0xFFFF) - 32768
    mags = np.abs(diffs)
    cats = np.where(mags == 0, 0,
                    np.ceil(np.log2(mags + 1)).astype(np.int64))
    cats = np.where(diffs == -32768, 16, cats)
    hist = np.bincount(cats.ravel(), minlength=17)
    codes, bits, huffval = _huffman_table(hist.tolist())

    scan = _pack_scan(diffs.ravel(), cats.ravel(), codes)

    def seg(marker, payload):
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    sof = struct.pack(">BHHB", precision, h, w, 1) + struct.pack(
        ">BBB", 0, 0x11, 0)
    dht = bytes([0x00]) + bytes(bits[1:]) + bytes(huffval)
    sos = struct.pack(">BBB", 1, 0, 0) + struct.pack(
        ">BBB", predictor, 0, 0)
    return (b"\xff\xd8" + seg(0xC3, sof) + seg(0xC4, dht) + seg(0xDA, sos)
            + scan + b"\xff\xd9")


def write_dng(path, mosaic: np.ndarray, pattern="RGGB", black=0.0,
              white=None, cam_mul=None, cam_xyz=None, compress=True,
              make="ART-TPU", model="Synthetic", iso=100,
              baseline_exposure=0.0, preview_rgb01=None, gain_maps=None,
              payload=None):
    """Write a Bayer mosaic (H, W) uint16 as a DNG file.

    payload: strip byte override (hand-built LJ92 vectors in tests);
    mosaic still defines dimensions and metadata."""
    mosaic = np.asarray(mosaic)
    assert mosaic.dtype == np.uint16 and mosaic.ndim == 2
    h, w = mosaic.shape
    if white is None:
        white = int(mosaic.max())

    if payload is not None:
        compression = 7 if compress else 1
    elif compress:
        payload = lj92_encode(mosaic)
        compression = 7
    else:
        payload = mosaic.astype("<u2").tobytes()
        compression = 1

    entries = []  # (tag, type, count, value_bytes or small int)
    extra = bytearray()  # out-of-line data, offsets fixed later

    def add(tag, typ, values):
        if typ == T_ASCII:
            data = values.encode() + b"\x00"
            count = len(data)
        elif typ == T_RATIONAL or typ == T_SRATIONAL:
            data = b"".join(
                struct.pack("<ii" if typ == T_SRATIONAL else "<II",
                            int(round(v * 1000000)), 1000000)
                for v in values)
            count = len(values)
        elif typ == T_SHORT:
            data = b"".join(struct.pack("<H", int(v)) for v in values)
            count = len(values)
        elif typ == T_LONG:
            data = b"".join(struct.pack("<I", int(v)) for v in values)
            count = len(values)
        elif typ == T_BYTE:
            data = bytes(int(v) for v in values)
            count = len(values)
        else:
            raise ValueError(typ)
        entries.append([tag, typ, count, data])

    add(254, T_LONG, [0])                       # NewSubfileType: main raw
    add(256, T_LONG, [w])
    add(257, T_LONG, [h])
    add(258, T_SHORT, [16])
    add(259, T_SHORT, [compression])
    add(262, T_SHORT, [32803])                  # CFA
    add(271, T_ASCII, make)
    add(272, T_ASCII, model)
    add(277, T_SHORT, [1])
    add(278, T_LONG, [h])
    add(284, T_SHORT, [1])
    add(33421, T_SHORT, [2, 2])                 # CFARepeatPatternDim
    add(33422, T_BYTE, [CFA_CODE[c] for c in pattern])
    add(34855, T_SHORT, [int(iso)])             # ISO (inline for simplicity)
    add(50706, T_BYTE, [1, 4, 0, 0])            # DNGVersion
    add(50708, T_ASCII, f"{make} {model}")      # UniqueCameraModel
    add(50714, T_SHORT, [int(black)] * 4)       # BlackLevel
    add(50717, T_SHORT, [int(white)])           # WhiteLevel
    if cam_xyz is not None:
        add(50721, T_SRATIONAL, list(np.asarray(cam_xyz).ravel()))
        add(50778, T_SHORT, [21])               # CalibrationIlluminant1: D65
    if cam_mul is not None:
        asn = [1.0 / m for m in np.asarray(cam_mul)[:3]]
        add(50728, T_RATIONAL, asn)             # AsShotNeutral
    if baseline_exposure:
        add(50730, T_SRATIONAL, [baseline_exposure])
    if gain_maps is not None:
        # OpcodeList2 with four per-coset GainMap opcodes (big-endian)
        ops = bytearray(struct.pack(">I", len(gain_maps)))
        for gm in gain_maps:
            g = np.asarray(gm["gains"], dtype=">f4")
            pv, ph = g.shape
            body = struct.pack(
                ">10I4dI", gm.get("top", 0), gm.get("left", 0),
                gm.get("bottom", h), gm.get("right", w), 0, 1, 2, 2,
                pv, ph, gm.get("spacing_v", 1.0 / max(pv - 1, 1)),
                gm.get("spacing_h", 1.0 / max(ph - 1, 1)), 0.0, 0.0,
                1) + g.tobytes()
            ops += struct.pack(">IIII", 9, 0x01040000, 0, len(body)) + body
        entries.append([51009, 7, len(ops), bytes(ops)])

    # optional embedded JPEG preview (JPEGInterchangeFormat tags) so the
    # histogram-matching / thumbnail paths have a camera rendition to read
    preview = b""
    if preview_rgb01 is not None:
        from art_tpu_torch.io import jpeg

        arr = np.clip(np.moveaxis(np.asarray(preview_rgb01), 0, -1), 0, 1)
        # quality 90 at libjpeg's default 4:2:0, as the reference's call
        preview = jpeg.encode((arr * 255 + 0.5).astype(np.uint8),
                              quality=90, subsampling=1)
        add(513, T_LONG, [0])                   # offset fixed after layout
        add(514, T_LONG, [len(preview)])

    # strip location fixed after layout
    add(273, T_LONG, [0])
    add(279, T_LONG, [len(payload)])

    entries.sort(key=lambda e: e[0])

    header = struct.pack("<2sHI", b"II", 42, 8)
    n = len(entries)
    ifd_size = 2 + n * 12 + 4
    data_off = 8 + ifd_size
    # lay out out-of-line values
    fixed = []
    for tag, typ, count, data in entries:
        if len(data) <= 4:
            val = data + b"\x00" * (4 - len(data))
            fixed.append((tag, typ, count, val, None))
        else:
            fixed.append((tag, typ, count, None, len(extra)))
            extra.extend(data)
            if len(extra) % 2:
                extra.append(0)
    strip_off = data_off + len(extra)
    out = bytearray(header)
    out += struct.pack("<H", n)
    preview_off = strip_off + len(payload) + (len(payload) % 2)
    for tag, typ, count, val, eoff in fixed:
        if tag == 273:
            val = struct.pack("<I", strip_off)
        if tag == 513:
            val = struct.pack("<I", preview_off)
        if val is None:
            val = struct.pack("<I", data_off + eoff)
        out += struct.pack("<HHI", tag, typ, count) + val
    out += struct.pack("<I", 0)  # next IFD
    out += extra
    out += payload
    if preview:
        if len(payload) % 2:
            out += b"\x00"
        out += preview
    with open(path, "wb") as f:
        f.write(out)
    return path
