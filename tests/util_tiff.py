"""A small TIFF writer for the tests: any tags, strips or tiles, either
byte order, classic or BigTIFF. It writes what it is given and checks
nothing, so it can build the forms and the faults the decoder must meet.
"""

from __future__ import annotations

import struct

import numpy as np

# TIFF field types
SHORT, LONG, RATIONAL = 3, 4, 5
_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 11: "f",
        12: "d", 16: "Q"}


def _pack(e, typ, vals):
    if typ in (1, 7) and isinstance(vals, (bytes, bytearray)):
        return bytes(vals)
    if typ == 2:
        s = vals.encode() if isinstance(vals, str) else bytes(vals)
        return s + b"\0"
    if typ in (5, 10):
        return b"".join(struct.pack(e + ("II" if typ == 5 else "ii"), *v)
                        for v in vals)
    return struct.pack(e + _FMT[typ] * len(vals), *vals)


def build(tags, blocks, le=True, big=False, offset_tag=None,
          count_tag=None, ifd_first=False):
    """The bytes of a one-IFD TIFF. `tags`: {tag: (type, values)} (values a
    tuple, bytes or str). `blocks`: the strips' or tiles' bytes, stored
    after the header (after the IFD where `ifd_first`, so that a cut
    copy keeps its IFD); their offsets and counts go into StripOffsets
    and StripByteCounts (or TileOffsets/TileByteCounts where tag 322 is
    given) unless `tags` names them already."""
    e = "<" if le else ">"
    tiled = 322 in tags
    offset_tag = offset_tag or (324 if tiled else 273)
    count_tag = count_tag or (325 if tiled else 279)
    head = 16 if big else 8
    tags = dict(tags)
    lay = dict(tags)
    lay.setdefault(offset_tag, (LONG, (0,) * len(blocks)))
    lay.setdefault(count_tag, (LONG, (0,) * len(blocks)))
    ifd_len = len(_ifd(lay, e, big, 0)[0]) + len(_ifd(lay, e, big, 0)[1])
    start = head + (ifd_len + ifd_len % 2 if ifd_first else 0)
    data = bytearray()
    offsets = []
    for b in blocks:
        offsets.append(start + len(data))
        data += b
        if len(data) % 2:
            data += b"\0"
    tags.setdefault(offset_tag, (LONG, tuple(offsets)))
    tags.setdefault(count_tag, (LONG, tuple(len(b) for b in blocks)))
    ifd_at = head if ifd_first else head + len(data)
    table, extra = _ifd(tags, e, big, ifd_at)
    if big:
        hdr = (b"II" if le else b"MM") + struct.pack(e + "HHHQ", 43, 8, 0,
                                                       ifd_at)
    else:
        hdr = (b"II" if le else b"MM") + struct.pack(e + "HI", 42, ifd_at)
    if ifd_first:
        body = table + extra
        return bytes(hdr + body + b"\0" * (len(body) % 2) + data)
    return bytes(hdr + data + table + extra)


def _ifd(tags, e, big, ifd_at):
    """(the IFD's entry table, its out-of-line values) at `ifd_at`."""
    n = len(tags)
    entry = 20 if big else 12
    inline = 8 if big else 4
    extra_at = ifd_at + (8 if big else 2) + n * entry + (8 if big else 4)
    ifd = bytearray(struct.pack(e + ("Q" if big else "H"), n))
    extra = bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        if isinstance(vals, int):
            vals = (vals,)
        payload = _pack(e, typ, vals)
        count = len(payload) if typ in (1, 2, 7) else len(vals)
        if len(payload) <= inline:
            field = payload.ljust(inline, b"\0")
        else:
            field = struct.pack(e + ("Q" if big else "I"),
                                extra_at + len(extra))
            extra += payload
            if len(extra) % 2:
                extra += b"\0"
        ifd += struct.pack(e + ("HHQ" if big else "HHI"), tag, typ, count)
        ifd += field
    ifd += b"\0" * (8 if big else 4)
    return bytes(ifd), bytes(extra)


def rows_bytes(arr, bits, le=True):
    """Samples (h, w, spp) or (h, w) packed as TIFF strips pack them: each
    row padded to a whole byte; 16- and 32-bit samples in the byte
    order, floats as float32."""
    a = np.asarray(arr)
    if a.ndim == 2:
        a = a[..., None]
    h, w, spp = a.shape
    e = "<" if le else ">"
    if bits in (8, 16, 32, 64) and a.dtype.kind in "uif":
        kind = a.dtype.kind
        return a.astype(np.dtype(e + kind + str(bits // 8))).tobytes()
    vals = a.reshape(h, w * spp).astype(np.uint32)
    bitsarr = ((vals[..., None] >> np.arange(bits - 1, -1, -1)) & 1)
    bitsarr = bitsarr.reshape(h, -1).astype(np.uint8)
    pad = (-bitsarr.shape[1]) % 8
    bitsarr = np.pad(bitsarr, ((0, 0), (0, pad)))
    return np.packbits(bitsarr, axis=1).tobytes()


def packbits(data):
    """PackBits of a byte string (runs of 3 or more replicated)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def lzw(data):
    """TIFF LZW (MSB first, early change), one code table reset at the
    start and whenever the table fills."""
    out_bits = []
    nbits = 9

    def put(code):
        out_bits.append((code, nbits))

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    put(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt >= 4094:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt = 258
            nbits = 9
        elif nxt >= (1 << nbits):
            nbits += 1
        w = bytes([c])
    if w:
        put(table[w])
        nxt += 1
        if nxt >= (1 << nbits) and nbits < 12:
            nbits += 1
    put(257)
    acc = 0
    nacc = 0
    out = bytearray()
    for code, nb in out_bits:
        acc = (acc << nb) | code
        nacc += nb
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def thunderscan(img4):
    """ThunderScan 4-bit rows (tif_thunder.c's codes): runs of the last
    pixel, 2-bit and 3-bit deltas where they reach, raw pixels else; each
    row starts from pixel 0."""
    out = bytearray()
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    for row in np.asarray(img4, np.uint8):
        last = 0
        i, n = 0, len(row)
        while i < n:
            v = int(row[i])
            run = 0
            while i + run < n and int(row[i + run]) == last and run < 63:
                run += 1
            if run >= 2:
                out.append(run)
                i += run
                continue
            if i + 2 < n:
                d = [int(row[i]) - last, int(row[i + 1]) - int(row[i]),
                     int(row[i + 2]) - int(row[i + 1])]
                if all(x in two for x in d):
                    out.append(0x40 | (two[d[0]] << 4) | (two[d[1]] << 2)
                               | two[d[2]])
                    last = int(row[i + 2])
                    i += 3
                    continue
            if i + 1 < n:
                d = [int(row[i]) - last, int(row[i + 1]) - int(row[i])]
                if all(x in three for x in d):
                    out.append(0x80 | (three[d[0]] << 3) | three[d[1]])
                    last = int(row[i + 1])
                    i += 2
                    continue
            out.append(0xC0 | v)
            last = v
            i += 1
    return bytes(out)


def predict_horizontal(rows_arr):
    """TIFF predictor 2 of (h, w, spp) integer samples: each sample less
    the one to its left, in its own width."""
    a = np.asarray(rows_arr)
    d = a.copy()
    d[:, 1:] = a[:, 1:] - a[:, :-1]
    return d


def predict_float(rows_arr, le=True):
    """TIFF predictor 3 (libtiff's fpDiff) of (h, w, spp) float32: each
    row's samples split into byte planes, most significant first, then
    byte differences along the row with a stride of spp."""
    a = np.asarray(rows_arr, np.float32)
    h, w, spp = a.shape
    be = a.astype(">f4").view(np.uint8).reshape(h, w * spp, 4)
    planes = np.moveaxis(be, 2, 1).reshape(h, 4 * w * spp)
    d = planes.reshape(h, -1, spp).astype(np.int16)
    d[:, 1:] = d[:, 1:] - d[:, :-1]
    return (d & 255).astype(np.uint8).reshape(h, -1).tobytes()


def _smooth(h, w, spp, top, seed, noise=0.0):
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    chans = [np.sin(xx / (37.0 + 11 * k)) * np.cos(yy / (23.0 + 5 * k) + k)
             for k in range(spp)]
    v = (np.stack(chans, -1) + 1.0) / 2.0 * 0.9 + 0.05
    v = v + rng.normal(0.0, noise, v.shape)
    return np.clip(np.round(v * top), 0, top)


def fixtures():
    """The committed TIFF fixtures: {name: bytes}. V1's single strips
    (6000 wide: an 8-bit RGB under ZSTD with predictor 2, a 16-bit RGB
    under LZMA, a bilevel under Group 4, a float grey under deflate with
    predictor 3) and V2's 16-bit ZSTD Hald CLUT and Group 4 mask, which
    chip_smoke.py builds from."""
    import io
    import lzma
    import zlib

    import zstandard
    from PIL import Image

    import chip_smoke

    out = {}
    w = 6000

    def tags(h, bps, spp, photo, comp, extra=None):
        t = {256: (SHORT, (w,)), 257: (SHORT, (h,)),
             258: (SHORT, (bps,) * spp), 259: (SHORT, (comp,)),
             262: (SHORT, (photo,)), 277: (SHORT, (spp,)),
             278: (SHORT, (h,))}
        t.update(extra or {})
        return t

    h = 8
    rgb8 = _smooth(h, w, 3, 255, 1, 0.002).astype(np.uint8)
    strip = predict_horizontal(rgb8).astype(np.uint8).tobytes()
    out["tiff_v1_rgb8_zstd_pred2.tif"] = build(
        tags(h, 8, 3, 2, 50000, {317: (SHORT, (2,))}),
        [zstandard.ZstdCompressor(level=19).compress(strip)])
    h = 16
    rgb16 = np.repeat(_smooth(h, w // 16, 3, 65535, 2), 16, axis=1).astype(
        np.uint16)
    out["tiff_v1_rgb16_lzma.tif"] = build(
        tags(h, 16, 3, 2, 34925),
        [lzma.compress(rgb16.astype("<u2").tobytes(), format=lzma.FORMAT_XZ,
                       preset=9)])
    h = 50
    yy, xx = np.mgrid[0:h, 0:w]
    bits = ((np.sin(xx / 40.0) + np.cos(yy / 7.0 + xx / 300.0)) > 0.3)
    bio = io.BytesIO()
    Image.fromarray(bits.astype(np.uint8) * 255).convert("1").save(
        bio, "TIFF", compression="group4", strip_size=1 << 20)
    out["tiff_v1_g4.tif"] = bio.getvalue()
    h = 4
    flt = (_smooth(h, w, 1, 1000, 3) / 7.0 - 20.0).astype(np.float32)
    out["tiff_v1_float_deflate_pred3.tif"] = build(
        tags(h, 32, 1, 1, 8, {317: (SHORT, (3,)), 339: (SHORT, (3,))}),
        [zlib.compress(predict_float(flt), 9)])
    hald = chip_smoke.hald_image(6, 16)
    hh, hw = hald.shape[:2]
    t = {256: (SHORT, (hw,)), 257: (SHORT, (hh,)),
         258: (SHORT, (16, 16, 16)), 259: (SHORT, (50000,)),
         262: (SHORT, (2,)), 277: (SHORT, (3,)), 278: (SHORT, (hh,)),
         317: (SHORT, (2,))}
    out["tiff_v2_hald6_zstd16.tif"] = build(
        t, [zstandard.ZstdCompressor(level=19).compress(
            predict_horizontal(hald.astype(np.int32)).astype("<u2")
            .tobytes())])
    mask = chip_smoke.f2_mask(*chip_smoke.Q2_MASK) > 128
    bio = io.BytesIO()
    Image.fromarray(mask.astype(np.uint8) * 255).convert("1").save(
        bio, "TIFF", compression="group4", strip_size=1 << 20)
    out["tiff_v2_mask_g4.tif"] = bio.getvalue()
    return out


def _jpeg(rgb, sub, restart=0):
    import io

    from PIL import Image

    bio = io.BytesIO()
    kw = {"restart_marker_blocks": restart} if restart else {}
    Image.fromarray(rgb).save(bio, "JPEG", quality=85, subsampling=sub, **kw)
    return bio.getvalue()


def ojpeg_jif(rgb, sub, ifd_first=False):
    """Old-style JPEG with the whole JPEG at JPEGInterchangeFormat (a
    Pillow JPEG of subsampling `sub`: 0 4:4:4, 1 4:2:2, 2 4:2:0), the one
    strip pointing at it."""
    j = _jpeg(rgb, sub)
    h, w = rgb.shape[:2]
    tags = {256: (SHORT, (w,)), 257: (SHORT, (h,)),
            258: (SHORT, (8, 8, 8)), 259: (SHORT, (6,)),
            262: (SHORT, (6,)), 277: (SHORT, (3,)), 278: (SHORT, (h,)),
            513: (LONG, (0,)), 514: (LONG, (len(j),))}
    first = build(tags, [j], ifd_first=ifd_first)
    at = _first_offset(first)
    tags[513] = (LONG, (at,))
    return build(tags, [j], ifd_first=ifd_first)


def _first_offset(data):
    """StripOffsets[0] of a little-endian classic TIFF."""
    ifd = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        tag, typ, cnt, v = struct.unpack_from("<HHII", data, ifd + 2 + 12 * i)
        if tag == 273:
            return v if cnt == 1 else struct.unpack_from("<I", data, v)[0]
    raise ValueError("no StripOffsets")


def _jpeg_parts(j):
    """(tables by (kind, id), (h, v) of the first component, entropy
    data) of a baseline JPEG."""
    pos, tables, samp = 2, {}, None
    while True:
        m = j[pos + 1]
        n = struct.unpack_from(">H", j, pos + 2)[0]
        seg = j[pos + 4 : pos + 2 + n]
        pos += 2 + n
        if m == 0xDB:
            for p in range(0, len(seg), 65):
                tables[("q", seg[p] & 15)] = seg[p + 1 : p + 65]
        elif m == 0xC4:
            p = 0
            while p < len(seg):
                k = sum(seg[p + 1 : p + 17])
                tables[("h", seg[p])] = seg[p + 1 : p + 17 + k]
                p += 17 + k
        elif m == 0xC0:
            samp = (seg[7] >> 4, seg[7] & 15)
        elif m == 0xDA:
            return tables, samp, j[pos : j.rindex(b"\xff\xd9")]


def ojpeg_tables(rgb, sub, rows=None, restart=0):
    """Old-style JPEG rebuilt from JPEGQTables, JPEGDCTables and
    JPEGACTables; the strips the entropy data (one a restart interval of
    `restart` MCUs where given, JPEGRestartInterval set)."""
    h, w = rgb.shape[:2]
    tables, (hs, vs), ent = _jpeg_parts(_jpeg(rgb, sub, restart))
    strips = [ent]
    if restart:
        strips, cur, i = [], bytearray(), 0
        while i < len(ent):
            if ent[i] == 0xFF and i + 1 < len(ent) and \
                    0xD0 <= ent[i + 1] <= 0xD7:
                strips.append(bytes(cur))
                cur, i = bytearray(), i + 2
                continue
            cur.append(ent[i])
            i += 1
        strips.append(bytes(cur))
    blob, at = bytearray(), {}
    for k, v in tables.items():
        at[k] = 8 + len(blob)
        blob += v
    blob += b"\0" * (len(blob) % 2)
    offs, p = [], 8 + len(blob)
    for s in strips:
        offs.append(p)
        p += len(s) + len(s) % 2
    tags = {256: (SHORT, (w,)), 257: (SHORT, (h,)),
            258: (SHORT, (8, 8, 8)), 259: (SHORT, (6,)),
            262: (SHORT, (6,)), 277: (SHORT, (3,)),
            278: (SHORT, (rows or h,)), 530: (SHORT, (hs, vs)),
            512: (SHORT, (1,)),
            519: (LONG, (at["q", 0], at["q", 1], at["q", 1])),
            520: (LONG, (at["h", 0x00], at["h", 0x01], at["h", 0x01])),
            521: (LONG, (at["h", 0x10], at["h", 0x11], at["h", 0x11])),
            273: (LONG, tuple(offs)), 279: (LONG, tuple(map(len, strips)))}
    if restart:
        tags[515] = (SHORT, (restart,))
    return build(tags, [bytes(blob)] + strips)


def ycbcr_blocks(y, cb, cr, hs, vs):
    """libtiff's packed YCbCr blocks of full-size luma and subsampled
    chroma planes."""
    h, w = y.shape
    bw, br = (w + hs - 1) // hs, (h + vs - 1) // vs
    lum = np.zeros((br * vs, bw * hs), np.uint8)
    lum[:h, :w] = y
    lum = np.moveaxis(lum.reshape(br, vs, bw, hs), 2, 1).reshape(br, bw, -1)
    return np.concatenate([lum, cb[:br, :bw, None], cr[:br, :bw, None]],
                          axis=2).reshape(br, -1)


def ojpeg_grey(grey, photo=1, tables=False, rows=None, restart=0,
               sof_sampling=None):
    """Old-style JPEG of one sample a pixel under photometric `photo`: a
    Pillow JPEG of the grey plane at JPEGInterchangeFormat, or (tables)
    rebuilt from one table of each kind, the strips its entropy data (one
    a restart interval of `restart` MCUs where given). sof_sampling
    rewrites the interchange frame's sampling byte."""
    import io

    from PIL import Image

    h, w = grey.shape
    bio = io.BytesIO()
    kw = {"restart_marker_blocks": restart} if restart else {}
    Image.fromarray(grey).save(bio, "JPEG", quality=85, **kw)
    j = bio.getvalue()
    base = {256: (SHORT, (w,)), 257: (SHORT, (h,)), 258: (SHORT, (8,)),
            259: (SHORT, (6,)), 262: (SHORT, (photo,)), 277: (SHORT, (1,))}
    if not tables:
        if sof_sampling is not None:
            at = j.index(b"\xff\xc0")
            j = j[: at + 11] + bytes([sof_sampling]) + j[at + 12 :]
        tags = dict(base)
        tags.update({278: (SHORT, (rows or h,)), 513: (LONG, (0,)),
                     514: (LONG, (len(j),))})
        tags[513] = (LONG, (_first_offset(build(tags, [j])),))
        return build(tags, [j])
    parts, _, ent = _jpeg_parts(j)
    strips = [ent]
    if restart:
        strips, cur, i = [], bytearray(), 0
        while i < len(ent):
            if ent[i] == 0xFF and i + 1 < len(ent) and \
                    0xD0 <= ent[i + 1] <= 0xD7:
                strips.append(bytes(cur))
                cur, i = bytearray(), i + 2
                continue
            cur.append(ent[i])
            i += 1
        strips.append(bytes(cur))
    blob, at = bytearray(), {}
    for k in (("q", 0), ("h", 0x00), ("h", 0x10)):
        at[k] = 8 + len(blob)
        blob += parts[k]
    blob += b"\0" * (len(blob) % 2)
    offs, p = [], 8 + len(blob)
    for s in strips:
        offs.append(p)
        p += len(s) + len(s) % 2
    tags = dict(base)
    tags.update({278: (SHORT, (rows or h,)), 512: (SHORT, (1,)),
                 519: (LONG, (at["q", 0],)), 520: (LONG, (at["h", 0x00],)),
                 521: (LONG, (at["h", 0x10],)), 273: (LONG, tuple(offs)),
                 279: (LONG, tuple(map(len, strips)))})
    if restart:
        tags[515] = (SHORT, (restart,))
    return build(tags, [bytes(blob)] + strips)


def _squeeze(raw, comp):
    import zlib

    if comp == 8:
        return zlib.compress(raw)
    if comp == 5:
        return lzw(raw)
    if comp == 32773:
        return packbits(raw)
    return raw


def ycbcr_planar(y, cb, cr, comp=8, rows=None, predictor=1, sampling=(1, 1)):
    """YCbCr in separate planes (PlanarConfiguration 2): each of Y, Cb and
    Cr stored in strips of `rows` rows under compression `comp`."""
    h, w = y.shape
    rows = rows or h
    strips = []
    for plane in (y, cb, cr):
        for r in range(0, plane.shape[0], rows):
            part = plane[r : r + rows]
            if predictor == 2:
                part = predict_horizontal(part[..., None])[..., 0]
            strips.append(_squeeze(np.ascontiguousarray(part).tobytes(),
                                   comp))
    tags = {256: (SHORT, (w,)), 257: (SHORT, (h,)),
            258: (SHORT, (8, 8, 8)), 259: (SHORT, (comp,)),
            262: (SHORT, (6,)), 277: (SHORT, (3,)), 278: (SHORT, (rows,)),
            284: (SHORT, (2,)), 530: (SHORT, sampling)}
    if predictor != 1:
        tags[317] = (SHORT, (predictor,))
    return build(tags, strips)


def ycbcr_tiled(y, cb, cr, hs, vs, tw=16, th=16, comp=8, predictor=1):
    """YCbCr (contiguous, subsampled hs x vs) in tiles of tw x th: each
    tile's packed blocks, edge tiles padded to the whole tile; the
    Predictor tag set to `predictor` over the blocks as they are."""
    h, w = y.shape
    tiles = []
    for ty in range(0, h, th):
        for tx in range(0, w, tw):
            ty_ = np.zeros((th, tw), np.uint8)
            part = y[ty : ty + th, tx : tx + tw]
            ty_[: part.shape[0], : part.shape[1]] = part
            bh, bw = (th + vs - 1) // vs, (tw + hs - 1) // hs
            cbt = np.zeros((bh, bw), np.uint8)
            crt = np.zeros((bh, bw), np.uint8)
            pc = cb[ty // vs : ty // vs + bh, tx // hs : tx // hs + bw]
            cbt[: pc.shape[0], : pc.shape[1]] = pc
            pc = cr[ty // vs : ty // vs + bh, tx // hs : tx // hs + bw]
            crt[: pc.shape[0], : pc.shape[1]] = pc
            tiles.append(_squeeze(ycbcr_blocks(ty_, cbt, crt, hs, vs)
                                  .tobytes(), comp))
    tags = {256: (SHORT, (w,)), 257: (SHORT, (h,)),
            258: (SHORT, (8, 8, 8)), 259: (SHORT, (comp,)),
            262: (SHORT, (6,)), 277: (SHORT, (3,)), 322: (SHORT, (tw,)),
            323: (SHORT, (th,)), 530: (SHORT, (hs, vs))}
    if predictor != 1:
        tags[317] = (SHORT, (predictor,))
    return build(tags, tiles)
