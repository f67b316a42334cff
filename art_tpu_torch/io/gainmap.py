"""DNG GainMap opcodes (a copy of ``art_tpu/io/gainmap.py``; reference:
gainmap.{h,cc}, rawimage_gainmap.cc).

OpcodeList2 (DNG tag 51009, always big-endian) may carry four GainMap
opcodes (id 9), one per 2x2 CFA coset, encoding a vignette-like gain
grid. Reference apply (gainmap.cc:179): for each coset pixel,
raw = (raw - black) * bilinear(map, y*row_scale, x*col_scale) * s + black
with s = (100 - FlatFieldClipControl)/100, gated by FlatFieldUseEmbedded.

Here the full-resolution gain plane is precomputed on the host at plan
time (static per image) and the device program applies it
(`raw/dfff.py::apply_gain_plane`).
"""

from __future__ import annotations

import struct

import numpy as np

from art_tpu_torch.io.metadata import _read_ifd, _value


def read_opcodelist2(path):
    """Raw OpcodeList2 bytes from any IFD of a TIFF container, or None."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 8 or buf[:2] not in (b"II", b"MM"):
        return None
    le = buf[:2] == b"II"
    e = "<" if le else ">"
    off = struct.unpack_from(e + "I", buf, 4)[0]
    queue = [off]
    seen = set()
    while queue:
        o = queue.pop()
        if o in seen or o == 0:
            continue
        seen.add(o)
        ents, nxt = _read_ifd(buf, o, le)
        if nxt:
            queue.append(nxt)
        if 51009 in ents:
            typ, cnt, doff = ents[51009]
            return buf[doff : doff + cnt]
        for tag in (330, 34665):
            if tag in ents:
                v = _value(buf, *ents[tag][:2], ents[tag][2], le)
                for sub in ([v] if isinstance(v, int) else list(v or [])):
                    queue.append(sub)
    return None


def parse_gain_maps(buf):
    """[{top,left,bottom,right,row_pitch,col_pitch,points_v,points_h,
    gains(np (v,h))}] from OpcodeList2 bytes (big-endian)."""
    if buf is None or len(buf) < 4:
        return []
    out = []
    n = struct.unpack_from(">I", buf, 0)[0]
    idx = 4
    for _ in range(n):
        if idx + 16 > len(buf):
            break
        opid, _ver, _flags, size = struct.unpack_from(">IIII", buf, idx)
        idx += 16
        if opid == 9 and idx + 76 <= len(buf):
            (top, left, bottom, right, plane, planes, rp, cp,
             mpv, mph) = struct.unpack_from(">10I", buf, idx)
            sv, sh, ov, oh = struct.unpack_from(">4d", buf, idx + 40)
            (mplanes,) = struct.unpack_from(">I", buf, idx + 72)
            cnt = mpv * mph * mplanes
            gains = np.frombuffer(buf, dtype=">f4", count=cnt,
                                  offset=idx + 76).astype(np.float32)
            out.append({
                "top": top, "left": left, "bottom": bottom, "right": right,
                "plane": plane, "planes": planes,
                "row_pitch": rp, "col_pitch": cp,
                "points_v": mpv, "points_h": mph,
                "spacing_v": sv, "spacing_h": sh,
                "origin_v": ov, "origin_h": oh,
                "map_planes": mplanes,
                "gains": gains.reshape(mpv, mph, mplanes)[..., 0],
            })
        idx += size
        if idx > len(buf):
            return []
    return out


def build_gain_plane(maps, shape, scale_factor=1.0):
    """Full-res (H, W) float32 gain plane from 4 per-coset maps, or None
    when the layout isn't the supported 2x2-coset form (gainmap.cc:181)."""
    h, w = shape
    if len(maps) != 4:
        return None
    for m in maps:
        if (m["plane"] != 0 or m["planes"] != 1 or m["map_planes"] != 1
                or m["row_pitch"] != 2 or m["col_pitch"] != 2
                or m["origin_v"] != 0 or m["origin_h"] != 0):
            return None
    plane = np.ones(shape, dtype=np.float32)
    for m in maps:
        mv = m["gains"]
        pv, ph = m["points_v"], m["points_h"]
        ys = np.arange(m["top"], min(h, m["bottom"]), 2)
        xs = np.arange(m["left"], min(w, m["right"]), 2)
        fy = np.clip(ys * (pv - 1) / float(h), 0, pv - 1)
        fx = np.clip(xs * (ph - 1) / float(w), 0, ph - 1)
        y0 = np.minimum(fy.astype(np.int64), pv - 2) if pv > 1 \
            else np.zeros_like(fy, np.int64)
        x0 = np.minimum(fx.astype(np.int64), ph - 2) if ph > 1 \
            else np.zeros_like(fx, np.int64)
        wy = (fy - y0)[:, None]
        wx = (fx - x0)[None, :]
        y1 = np.minimum(y0 + 1, pv - 1)
        x1 = np.minimum(x0 + 1, ph - 1)
        g = ((1 - wy) * ((1 - wx) * mv[np.ix_(y0, x0)]
                         + wx * mv[np.ix_(y0, x1)])
             + wy * ((1 - wx) * mv[np.ix_(y1, x0)]
                     + wx * mv[np.ix_(y1, x1)]))
        plane[np.ix_(ys, xs)] = g * scale_factor
    return plane
