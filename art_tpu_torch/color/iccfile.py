"""ICC profile files (counterpart of ``art_tpu/color/iccfile.py``;
iccstore.cc:224-366): a copy of the reference's parser, host numpy.

A matrix-shaper profile (v2/v4) gives its colorants (rXYZ/gXYZ/bXYZ,
PCS D50-relative) and its TRCs ('curv' identity, gamma or samples;
'para' types 0-4); sampled curves are refit as Chebyshev series in
float64 (`core/curve1d.py::fit_curve`), or kept as tables where the fit
fails. A LUT-class profile (mft1, mft2, mAB, mBA) parses into the
canonical element pipeline (curves, matrix, CLUT) that
`color/icclut.py` plans and applies on the device.
"""

from __future__ import annotations

import struct

import numpy as np


def _s15f16(b, off):
    return struct.unpack_from(">i", b, off)[0] / 65536.0


def _parse_curv(b, off, size):
    """'curv' tag -> TRC tuple (see colorspaces.encode_trc forms)."""
    n = struct.unpack_from(">I", b, off + 8)[0]
    if n == 0:
        return ("linear", None)
    if n == 1:
        g = struct.unpack_from(">H", b, off + 12)[0] / 256.0
        if abs(g - 1.0) < 1e-3:
            return ("linear", None)
        return ("gamma", float(g))
    samples = np.frombuffer(b, dtype=">u2", count=n,
                            offset=off + 12).astype(np.float64) / 65535.0
    return _fit_sampled(samples)


def _parse_para(b, off, size):
    """'para' tag -> ("para", (g, a, bb, c, d, e, f))."""
    typ = struct.unpack_from(">H", b, off + 8)[0]
    nv = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}.get(typ)
    if nv is None:
        raise ValueError(f"unsupported para curve type {typ}")
    v = [_s15f16(b, off + 12 + 4 * i) for i in range(nv)]
    g = v[0]
    if typ == 0:
        if abs(g - 1.0) < 1e-3:
            return ("linear", None)
        return ("gamma", float(g))
    a, bb = v[1], v[2]
    c = v[3] if typ >= 2 else 0.0
    if typ == 1:
        d = -bb / a if a else 0.0
        return ("para", (g, a, bb, 0.0, d, 0.0, 0.0))
    if typ == 2:
        d = -bb / a if a else 0.0
        return ("para", (g, a, bb, 0.0, d, c, c))
    if typ == 3:
        d = v[4]
        return ("para", (g, a, bb, c, d, 0.0, 0.0))
    # typ == 4: y = (a x + b)^g + e (x >= d) else c x + f
    return ("para", (g, a, bb, c, v[4], v[5], v[6]))


def _fit_sampled(samples):
    """Sampled TRC -> ("cheb", (enc, dec)) Chebyshev pair, or ("lut",
    (enc_samples, dec_samples)) when the curve resists fitting."""
    from art_tpu_torch.core.curve1d import fit_curve

    samples = np.clip(np.asarray(samples, dtype=np.float64), 0.0, 1.0)
    if samples[0] > samples[-1]:  # decreasing TRC: normalize orientation
        samples = samples[::-1].copy()
    xs = np.linspace(0.0, 1.0, 4096)
    # ICC TRC samples map device -> linear (the decode direction, same
    # convention as the ("gamma", g) tag); encode is its inverse
    dense = np.interp(xs, np.linspace(0, 1, len(samples)), samples)
    mono = np.maximum.accumulate(dense)
    inv = np.interp(xs, mono, xs)
    dec = fit_curve(dense)
    enc = fit_curve(inv)
    if enc is not None and dec is not None and enc.ndim == 1 \
            and dec.ndim == 1:
        return ("cheb", (tuple(float(c) for c in enc),
                         tuple(float(c) for c in dec)))
    # fallback: 256-sample linear-interp pair (encode first, like cheb)
    sub = np.interp(np.linspace(0, 1, 256), xs, dense)
    isub = np.interp(np.linspace(0, 1, 256), xs, inv)
    return ("lut", (tuple(float(v) for v in isub),
                    tuple(float(v) for v in sub)))


# ---------------------------------------------------------------------------
# LUT-class profile tags (mft1 / mft2 / mAB / mBA)

_CURVE_SAMPLES = 1024  # canonical dense sampling for element curves


def _curve_to_table(trc):
    """Tagged TRC tuple -> (S,) dense float table on [0,1] (forward,
    i.e. the direction the tag stores)."""
    xs = np.linspace(0.0, 1.0, _CURVE_SAMPLES)
    kind, v = trc
    if kind == "linear":
        return xs.copy()
    if kind == "gamma":
        return xs ** float(v)
    if kind == "samples":
        return np.interp(xs, np.linspace(0, 1, len(v)), v)
    if kind == "para":
        g, a, b, c, d, e, f = v
        lo = c * xs + f
        hi = np.power(np.maximum(a * xs + b, 0.0), g) + e
        return np.where(xs >= d, hi, lo)
    raise ValueError(f"unsupported curve kind {kind}")


def _parse_curv_raw(b, off):
    """'curv' tag -> forward table tuple + its byte size."""
    n = struct.unpack_from(">I", b, off + 8)[0]
    size = 12 + 2 * n
    if n == 0:
        return ("linear", None), size
    if n == 1:
        g = struct.unpack_from(">H", b, off + 12)[0] / 256.0
        return ("gamma", g), size
    samples = np.frombuffer(b, dtype=">u2", count=n,
                            offset=off + 12).astype(np.float64) / 65535.0
    return ("samples", samples), size


def _read_curve_seq(b, off, n):
    """Read n sequential 'curv'/'para' curves (4-byte aligned) -> list of
    dense (S,) tables."""
    tables = []
    for _ in range(n):
        typ = b[off : off + 4]
        if typ == b"curv":
            trc, size = _parse_curv_raw(b, off)
        elif typ == b"para":
            trc = _parse_para(b, off, 0)
            ntyp = struct.unpack_from(">H", b, off + 8)[0]
            size = 12 + 4 * {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}[ntyp]
        else:
            raise ValueError(f"unsupported element curve type {typ!r}")
        tables.append(_curve_to_table(trc))
        off += (size + 3) & ~3
    return tables


def _parse_mft(data, off, is16):
    """mft1/mft2 (lut8/lut16) -> element dict. Layout: header, 3x3
    matrix (s15f16), input tables, CLUT, output tables."""
    n_in = data[off + 8]
    n_out = data[off + 9]
    g = data[off + 10]
    if n_in != 3 or n_out != 3:
        raise ValueError(f"unsupported LUT channels {n_in}->{n_out}")
    mat = np.array([[_s15f16(data, off + 12 + 4 * (3 * r + c))
                     for c in range(3)] for r in range(3)])
    p = off + 48
    if is16:
        n_tab, m_tab = struct.unpack_from(">HH", data, p)
        p += 4
        def table(count):
            nonlocal p
            t = np.frombuffer(data, dtype=">u2", count=count,
                              offset=p).astype(np.float64) / 65535.0
            p += 2 * count
            return t
        ins = [table(n_tab) for _ in range(3)]
        clut = table(g ** 3 * 3).reshape(g, g, g, 3)
        outs = [table(m_tab) for _ in range(3)]
    else:
        def table8(count):
            nonlocal p
            t = np.frombuffer(data, dtype=np.uint8, count=count,
                              offset=p).astype(np.float64) / 255.0
            p += count
            return t
        ins = [table8(256) for _ in range(3)]
        clut = table8(g ** 3 * 3).reshape(g, g, g, 3)
        outs = [table8(256) for _ in range(3)]
    # the matrix applies only when the lut INPUT side is PCSXYZ (spec
    # clause for lut8/16Type); identity matrices are dropped either way
    if np.allclose(mat, np.eye(3), atol=1e-6):
        mat = None
    return {
        "form": "mft2" if is16 else "mft1",
        "matrix": mat,
        "in_curves": np.stack(ins),
        "clut": clut.astype(np.float32),
        "out_curves": np.stack(outs),
        "m_curves": None,
        "matrix34": None,
    }


def _parse_mabba(data, off, is_ab):
    """mAB/mBA (lutAtoB/lutBtoA) -> element dict. Offsets at +12:
    bCurves, matrix, mCurves, clut, aCurves (0 = absent)."""
    n_in = data[off + 8]
    n_out = data[off + 9]
    if n_in != 3 or n_out != 3:
        raise ValueError(f"unsupported LUT channels {n_in}->{n_out}")
    ob, om, omc, ocl, oa = struct.unpack_from(">5I", data, off + 12)

    b_curves = (np.stack(_read_curve_seq(data, off + ob, 3))
                if ob else None)
    m_curves = (np.stack(_read_curve_seq(data, off + omc, 3))
                if omc else None)
    a_curves = (np.stack(_read_curve_seq(data, off + oa, 3))
                if oa else None)
    mat34 = None
    if om:
        v = [_s15f16(data, off + om + 4 * i) for i in range(12)]
        mat34 = np.array([[v[0], v[1], v[2], v[9]],
                          [v[3], v[4], v[5], v[10]],
                          [v[6], v[7], v[8], v[11]]])
        if np.allclose(mat34, np.hstack([np.eye(3), np.zeros((3, 1))]),
                       atol=1e-7):
            mat34 = None
    clut = None
    if ocl:
        p = off + ocl
        gps = [data[p + i] for i in range(3)]
        prec = data[p + 16]
        p += 20
        count = gps[0] * gps[1] * gps[2] * 3
        if prec == 1:
            clut = np.frombuffer(data, np.uint8, count,
                                 p).astype(np.float64) / 255.0
        else:
            clut = np.frombuffer(data, ">u2", count,
                                 p).astype(np.float64) / 65535.0
        if not (gps[0] == gps[1] == gps[2]):
            raise ValueError("non-cubic CLUT grids unsupported")
        clut = clut.reshape(gps[0], gps[0], gps[0], 3).astype(np.float32)
    return {
        "form": "mAB" if is_ab else "mBA",
        "matrix": None,
        "matrix34": mat34,
        "in_curves": a_curves if is_ab else b_curves,
        "m_curves": m_curves,
        "clut": clut,
        "out_curves": b_curves if is_ab else a_curves,
    }


def _parse_lut_tag(data, off):
    typ = data[off : off + 4]
    if typ == b"mft1":
        return _parse_mft(data, off, is16=False)
    if typ == b"mft2":
        return _parse_mft(data, off, is16=True)
    if typ == b"mAB ":
        return _parse_mabba(data, off, is_ab=True)
    if typ == b"mBA ":
        return _parse_mabba(data, off, is_ab=False)
    raise ValueError(f"unsupported LUT tag type {typ!r}")


def parse_icc_bytes(data: bytes):
    """Parse a matrix-shaper ICC profile.

    Returns dict: rgb_to_xyz (3,3) D50-relative, trc (tagged tuple,
    green channel), trcs (per-channel), description, bytes.
    Raises ValueError for non-RGB or LUT-only profiles."""
    if len(data) < 132 or data[36:40] != b"acsp":
        raise ValueError("not an ICC profile")
    dev_space = data[16:20]
    if dev_space != b"RGB ":
        raise ValueError(f"unsupported device space {dev_space!r}")
    count = struct.unpack_from(">I", data, 128)[0]
    if count > 1024:
        raise ValueError("corrupt tag table")
    tags = {}
    for i in range(count):
        sig, off, size = struct.unpack_from(">4sII", data, 132 + 12 * i)
        tags[sig] = (off, size)

    def xyz_tag(sig):
        if sig not in tags:
            return None
        off, _ = tags[sig]
        if data[off : off + 4] != b"XYZ ":
            return None
        return [_s15f16(data, off + 8), _s15f16(data, off + 12),
                _s15f16(data, off + 16)]

    def desc_of():
        d = ""
        if b"desc" in tags:
            off, size = tags[b"desc"]
            typ = data[off : off + 4]
            try:
                if typ == b"desc":
                    n = struct.unpack_from(">I", data, off + 8)[0]
                    d = data[off + 12 : off + 12 + n - 1].decode(
                        "ascii", "replace")
                elif typ == b"mluc":
                    nrec = struct.unpack_from(">I", data, off + 8)[0]
                    if nrec:
                        ln, loff = struct.unpack_from(">II", data, off + 20)
                        d = data[off + loff : off + loff + ln].decode(
                            "utf-16-be", "replace")
            except Exception:
                d = ""
        return d

    r = xyz_tag(b"rXYZ")
    g = xyz_tag(b"gXYZ")
    b = xyz_tag(b"bXYZ")
    if r is None or g is None or b is None:
        # LUT-class profile: canonical element pipelines per direction
        a2b = b2a = None
        if b"A2B0" in tags:
            a2b = _parse_lut_tag(data, tags[b"A2B0"][0])
        if b"B2A0" in tags:
            b2a = _parse_lut_tag(data, tags[b"B2A0"][0])
        if a2b is None and b2a is None:
            raise ValueError(
                "profile has neither matrix colorants nor A2B/B2A LUTs")
        return {
            "kind": "lut",
            "pcs": data[20:24].decode("ascii").strip(),
            "version": data[8],
            "a2b": a2b,
            "b2a": b2a,
            "description": desc_of(),
            "bytes": data,
        }
    m = np.array([r, g, b]).T  # columns = colorants

    def trc_tag(sig):
        if sig not in tags:
            return ("linear", None)
        off, size = tags[sig]
        typ = data[off : off + 4]
        if typ == b"curv":
            return _parse_curv(data, off, size)
        if typ == b"para":
            return _parse_para(data, off, size)
        raise ValueError(f"unsupported TRC tag type {typ!r}")

    trcs = tuple(trc_tag(s) for s in (b"rTRC", b"gTRC", b"bTRC"))

    return {
        "kind": "matrix",
        "rgb_to_xyz": m,
        "trc": trcs[1],
        "trcs": trcs,
        "description": desc_of(),
        "bytes": data,
    }


def load_icc(path):
    with open(path, "rb") as f:
        return parse_icc_bytes(f.read())
