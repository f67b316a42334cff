"""LittleCMS 2.17's reading of a multiProcessElements tag (``mpet``, the
float D2Bx tags), as ``cmstypes.c`` reads it, into the stages of
``color/lcms_stages.py``:

- ``cvst``: a curve set, one segmented curve (``curf``) a channel, each
  of formula segments (``parf``, types 0-2, kept as LittleCMS's types
  6-8) and sampled segments (``samf``, whose first point LittleCMS takes
  from the curve just left of the segment);
- ``matf``: a matrix with an offset, in float32 read to double;
- ``clut``: a float CLUT;
- ``bACS``/``eACS``: skipped.

Offsets in a position table count from the start of the element that
holds it (the tag for the elements, the ``cvst`` for its curves).
"""

from __future__ import annotations

import numpy as np

from art_tpu_torch.color import lcms_stages as ls

_F32 = np.float32


def _position_table(io, count):
    """ReadPositionTable's offsets and sizes, refused where the table
    would run past the profile."""
    if (len(io.data) - io.pos) // 8 < count:
        raise ValueError("position table past the profile")
    return [(io.u32(), io.u32()) for _ in range(count)]


def _segmented_curve(io):
    """ReadSegmentedCurve: (x0, x1, kind, params or samples) segments,
    the implicit first sample of each sampled segment filled in."""
    if io.take(4) != b"curf":
        raise ValueError("not a segmented curve")
    io.take(4)
    n = io.u16()
    io.u16()
    if n < 1:
        raise ValueError("no segments")
    brk = [_F32(io.f32()) for _ in range(n - 1)]
    x0s = [_F32(ls.MINUS_INF)] + brk
    x1s = brk + [_F32(ls.PLUS_INF)]
    segs = []
    for i in range(n):
        sig = io.take(4)
        io.take(4)
        if sig == b"parf":
            typ = io.u16()
            io.u16()
            if typ > 2:
                raise ValueError("formula segment type")
            p = [io.f32() for _ in range((4, 5, 5)[typ])]
            data = tuple(p) + (0.0,) * (10 - len(p))
            segs.append([float(x0s[i]), float(x1s[i]), typ + 6, data])
        elif sig == b"samf":
            cnt = io.u32() + 1
            pts = np.zeros(cnt, _F32)
            for j in range(1, cnt):
                pts[j] = io.f32()
            segs.append([float(x0s[i]), float(x1s[i]), 0, pts])
        else:
            raise ValueError(f"curve segment {sig!r}")
    for i, seg in enumerate(segs):
        if seg[2] == 0:
            v = ls.curve_float(("seg", tuple(map(tuple, segs))),
                               np.array([seg[0]], _F32))[0]
            seg[3][0] = v
    return ("seg", tuple(tuple(s) for s in segs))


def _cvst(io, base):
    n_in, n_out = io.u16(), io.u16()
    if n_in != n_out:
        raise ValueError("curve set channels")
    curves = []
    for off, _ in _position_table(io, n_in):
        io.seek(base + off)
        curves.append(_segmented_curve(io))
    return ls.Curves(curves)


def _matf(io):
    n_in, n_out = io.u16(), io.u16()
    if n_in >= 16 or n_out >= 16:
        raise ValueError("matrix channels")
    m = [io.f32() for _ in range(n_in * n_out)]
    off = [io.f32() for _ in range(n_out)]
    return ls.Matrix(n_out, n_in, m, off)


def _clut(io):
    n_in, n_out = io.u16(), io.u16()
    if n_in == 0 or n_out == 0:
        raise ValueError("CLUT channels")
    dims = list(io.take(16))[: min(n_in, 8)]
    if 1 in dims:
        raise ValueError("grid of one point")
    size = n_out
    for d in dims:
        size *= d
    vals = np.array([io.f32() for _ in range(size)], _F32)
    return ls.Clut(vals.reshape(*dims, n_out), is_float=True)


def read_mpet(io, tag_off):
    """Type_MPE_Read: (stages, n_in, n_out)."""
    n_in, n_out = io.u16(), io.u16()
    if not (0 < n_in < 16 and 0 < n_out < 16):
        raise ValueError("channels")
    count = io.u32()
    st = []
    for off, _ in _position_table(io, count):
        base = tag_off + off
        io.seek(base)
        sig = io.take(4)
        io.take(4)
        if sig == b"cvst":
            st.append(_cvst(io, base))
        elif sig == b"matf":
            st.append(_matf(io))
        elif sig == b"clut":
            st.append(_clut(io))
        elif sig not in (b"bACS", b"eACS"):
            raise ValueError(f"multiProcessElement {sig!r}")
    got = ls.check_chain(st, n_in, n_out)
    if got != (n_in, n_out):
        raise ValueError("element channels differ from the tag's")
    return st, n_in, n_out
