"""Old-style JPEG in TIFF (compression 6) as libtiff 4.7.1's tif_ojpeg.c
feeds libjpeg for Pillow, with no PIL.

tif_ojpeg rebuilds one JPEG stream for the whole image and decodes it
with libjpeg's raw-data interface (no upsampling, no colour conversion);
libtiff's RGBA interface then converts the YCbCr blocks
(:func:`art_tpu_torch.io.tiff.blocks_to_rgb`). The stream is either

- the interchange stream at JPEGInterchangeFormat (tag 513, its length
  tag 514): its tables, restart interval and frame up to the SOS, then the
  entropy-coded data that follows the SOS there and continues into the
  strips; the JPEG's own sampling factors win over YCbCrSubsampling; or
- rebuilt from the tags: JPEGQTables, JPEGDCTables and JPEGACTables
  (tags 519-521, one table of each a component, at the offsets they
  give), JPEGRestartInterval (515) and YCbCrSubsampling (530, default
  2x2), with the strips' data after the SOS, one after another.

Between two strips tif_ojpeg inserts the next RSTn marker. Only a
baseline (JPEGProc 1) frame is read: three YCbCr components, or for an
image of one sample a pixel (any photometric but YCbCr) one component
sampled 1x1, which libjpeg decodes into grey scanlines. libjpeg runs
through :mod:`art_tpu_torch.io.jpegdec`.
"""

from __future__ import annotations

import struct

import numpy as np


def _segments(head, ncomp=3):
    """The JIF stream's markers up to its SOS: (header bytes through the
    SOS segment, (h, v) of the first component) or None where tif_ojpeg's
    parse fails (a frame of other than `ncomp` components, the image's
    samples a pixel; one component sampled other than 1x1)."""
    if head[:2] != b"\xff\xd8":
        return None
    pos = 2
    sampling = None
    while pos + 4 <= len(head):
        if head[pos] != 0xFF:
            return None
        marker = head[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        n = struct.unpack_from(">H", head, pos + 2)[0]
        seg = head[pos + 4 : pos + 2 + n]
        if marker in (0xC0, 0xC1):
            if len(seg) < 6 + 3 * ncomp or seg[5] != ncomp:
                return None
            sampling = (seg[7] >> 4, seg[7] & 15)
            if ncomp == 1 and sampling != (1, 1):
                return None
        elif marker in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            return None
        pos += 2 + n
        if marker == 0xDA:
            return (head[:pos], sampling) if sampling else None
    return None


def _table_header(t, buf, hs, vs, ncomp=3):
    """SOI, the tables, DRI and SOF0/SOS tif_ojpeg writes from the tags
    for `ncomp` components (a table of each kind a component), or None
    where a tag is missing or points outside the file."""
    d = t.ifd
    q, dc, ac = d.seq(519), d.seq(520), d.seq(521)
    if int(d.get(512, 1)) != 1 or not q or not dc or not ac or \
            min(len(q), len(dc), len(ac)) < ncomp:
        return None
    out = bytearray(b"\xff\xd8")
    for i in range(ncomp):
        tab = buf[q[i] : q[i] + 64]
        if len(tab) < 64:
            return None
        out += b"\xff\xdb" + struct.pack(">HB", 67, i) + tab
    for cls, offs in ((0, dc), (1, ac)):
        for i in range(ncomp):
            bits = buf[offs[i] : offs[i] + 16]
            if len(bits) < 16:
                return None
            vals = buf[offs[i] + 16 : offs[i] + 16 + sum(bits)]
            if len(vals) < sum(bits):
                return None
            out += b"\xff\xc4" + struct.pack(">HB", 19 + len(vals),
                                              (cls << 4) | i) + bits + vals
    ri = int(d.get(515, 0))
    if ri:
        out += b"\xff\xdd" + struct.pack(">HH", 4, ri)
    out += b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * ncomp, 8, t.h, t.w,
                                       ncomp)
    for i in range(ncomp):
        samp = (hs << 4) | vs if i == 0 else 0x11
        out += bytes([i + 1, samp, i])
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * ncomp, ncomp)
    for i in range(ncomp):
        out += bytes([i + 1, (i << 4) | i])
    out += b"\x00\x3f\x00"
    return bytes(out)


def _strips(t, buf):
    """The strips' bytes in order, as tif_ojpeg reads them."""
    out = []
    for k, off in enumerate(t.offsets):
        n = t.counts[k] if t.counts and k < len(t.counts) else 0
        out.append(buf[off : off + n])
    return out


def stream(t, buf, tag_sampling, ncomp=3):
    """(the JPEG stream of `ncomp` components, (hs, vs)) tif_ojpeg hands
    libjpeg, or (None, sampling) where its header parse fails."""
    d = t.ifd
    jif = d.get(513)
    data = _strips(t, buf)
    rst = b""
    body = bytearray()
    if jif:
        n = d.get(514) or len(buf) - jif
        head = buf[jif : jif + n]
        parsed = _segments(head, ncomp)
        if parsed is None:
            return None, tag_sampling
        header, sampling = parsed
        body += head[len(header):]
    else:
        sampling = tag_sampling
        header = _table_header(t, buf, *sampling, ncomp)
        if header is None:
            return None, sampling
    for k, s in enumerate(data):
        body += rst + s
        rst = bytes([0xFF, 0xD0 + k % 8])
    return header + bytes(body) + b"\xff\xd9", sampling


def ycbcr_blocks(planes, w, h, hs, vs):
    """The raw planes packed as libtiff's YCbCr blocks (OJPEGDecodeRaw):
    for each row of blocks and each block, hs*vs luma samples row by row,
    then Cb and Cr."""
    (y, _), (cb, _), (cr, _) = planes[:3]
    bw = (w + hs - 1) // hs
    brows = (h + vs - 1) // vs

    def fit(p, rows, cols):
        out = np.zeros((rows, cols), np.uint8)
        r, c = min(rows, p.shape[0]), min(cols, p.shape[1])
        out[:r, :c] = p[:r, :c]
        return out

    lum = fit(y, brows * vs, bw * hs).reshape(brows, vs, bw, hs)
    lum = np.moveaxis(lum, 2, 1).reshape(brows, bw, hs * vs)
    blocks = np.concatenate([lum, fit(cb, brows, bw)[..., None],
                             fit(cr, brows, bw)[..., None]], axis=2)
    return blocks.reshape(brows, -1)
