"""Common LUT Format (.clf / .clfz) files (counterpart of
``art_tpu/color/clf.py``; the reference ART applies them through
OpenColorIO, clutstore.cc:1117-1131, 1620-1655).

`load_clf` (host, a copy of the reference's XML parse) gives a hashable
signature per ProcessNode and its constant arrays; `apply_clf` runs the
nodes on a (3, H, W) stack in torch: LUT1D (linear), LUT3D (tetrahedral
or trilinear), Matrix (3x3 / 3x4), Range, Exponent (basic and monCurve
styles), Log (log2/log10/antiLog, lin/log, camera styles with their
linear segment) and ASC_CDL (Fwd/Rev, NoClamp), with the reference's
float32 branches. halfDomain/rawHalfs LUT1Ds and unknown nodes raise
ValueError.
"""

from __future__ import annotations

import gzip
import xml.etree.ElementTree as ET

import numpy as np
import torch

from art_tpu_torch.core.fmath import fpow

# bit-depth normalization scales (CLF 5.3: integer depths scale by
# 2^n - 1, float depths are nominally 0..1)
_SCALE = {"8i": 255.0, "10i": 1023.0, "12i": 4095.0, "16i": 65535.0,
          "16f": 1.0, "32f": 1.0}


def _tag(e):
    t = e.tag
    return t.rsplit("}", 1)[-1] if "}" in t else t


def _scale(depth):
    try:
        return _SCALE[(depth or "32f").strip()]
    except KeyError:
        raise ValueError(f"CLF: unknown bit depth {depth!r}")


def _floats(text):
    return np.array([float(v) for v in text.split()], dtype=np.float64)


def _array_elem(node):
    for ch in node:
        if _tag(ch) == "Array":
            dim = tuple(int(v) for v in ch.get("dim", "").split())
            return dim, _floats(ch.text or "")
    raise ValueError(f"CLF: {_tag(node)} node has no Array")


def _parse_lut1d(node, ins, outs):
    if node.get("halfDomain") or node.get("rawHalfs"):
        raise ValueError("CLF: halfDomain/rawHalfs LUT1D not supported")
    dim, vals = _array_elem(node)
    if len(dim) != 2 or dim[1] not in (1, 3):
        raise ValueError(f"CLF: bad LUT1D dim {dim}")
    n, ch = dim
    table = (vals.reshape(n, ch) / outs).astype(np.float32)
    if ch == 1:
        table = np.repeat(table, 3, axis=1)
    return ("lut1d", n), (table,)


def _parse_lut3d(node, ins, outs):
    dim, vals = _array_elem(node)
    if len(dim) != 4 or dim[3] != 3 or not dim[0] == dim[1] == dim[2]:
        raise ValueError(f"CLF: bad LUT3D dim {dim}")
    n = dim[0]
    # CLF value order: first (R) index slowest, B fastest -> [r][g][b]
    table = (vals.reshape(n, n, n, 3) / outs).astype(np.float32)
    interp = (node.get("interpolation") or "trilinear").lower()
    return ("lut3d", n, interp), (table,)


def _parse_matrix(node, ins, outs):
    dim, vals = _array_elem(node)
    if len(dim) == 3:          # legacy v2 "rows cols 3"
        dim = dim[:2]
    if dim == (3, 3):
        m = vals.reshape(3, 3)
        off = np.zeros(3)
    elif dim == (3, 4):
        m = vals.reshape(3, 4)[:, :3]
        off = vals.reshape(3, 4)[:, 3]
    elif dim == (4, 4):
        m = vals.reshape(4, 4)[:3, :3]
        off = vals.reshape(4, 4)[:3, 3]
    else:
        raise ValueError(f"CLF: bad Matrix dim {dim}")
    # fold depth scaling: y_norm = (M @ (x*ins) + off) / outs
    m = (m * (ins / outs)).astype(np.float32)
    off = (off / outs).astype(np.float32)
    return ("matrix",), (m, off)


def _parse_range(node, ins, outs):
    def grab(name):
        for ch in node:
            if _tag(ch) == name:
                return float(ch.text)
        return None

    in_min, in_max = grab("minInValue"), grab("maxInValue")
    out_min, out_max = grab("minOutValue"), grab("maxOutValue")
    noclamp = (node.get("style") or "Clamp").lower() == "noclamp"
    if in_min is not None and in_max is not None:
        scale = (out_max - out_min) / (in_max - in_min) * (ins / outs) \
            if in_max != in_min else 0.0
        # y_norm = ((x*ins - in_min) * s + out_min) / outs
        a = scale
        b = (out_min - in_min * ((out_max - out_min) /
                                 (in_max - in_min))) / outs \
            if in_max != in_min else out_min / outs
        lo = out_min / outs if not noclamp else None
        hi = out_max / outs if not noclamp else None
    else:
        # clamp-only mode (one bound): identity scale
        a, b = ins / outs, 0.0
        lo = in_min * a / ins if in_min is not None else None
        hi = in_max * a / ins if in_max is not None else None
    return ("range", lo, hi), (np.float32(a), np.float32(b))


def _exp_params(node):
    """Per-channel (exponent, offset) from ExponentParams children."""
    exps = np.ones(3)
    offs = np.zeros(3)
    seen_all = False
    for ch in node:
        if _tag(ch) != "ExponentParams":
            continue
        e = float(ch.get("exponent", 1.0))
        o = float(ch.get("offset", 0.0))
        chan = ch.get("channel")
        if chan in ("R", "G", "B"):
            i = "RGB".index(chan)
            exps[i], offs[i] = e, o
        else:
            exps[:], offs[:] = e, o
            seen_all = True
    if not seen_all and not any(_tag(c) == "ExponentParams" for c in node):
        raise ValueError("CLF: Exponent node without ExponentParams")
    return exps.astype(np.float32), offs.astype(np.float32)


def _parse_exponent(node, ins, outs):
    style = node.get("style", "basicFwd")
    exps, offs = _exp_params(node)
    return ("exponent", style), (exps.reshape(3, 1, 1),
                                 offs.reshape(3, 1, 1))


def _log_params(node):
    keys = ("base", "logSideSlope", "logSideOffset", "linSideSlope",
            "linSideOffset", "linSideBreak", "linearSlope")
    dft = {"base": 2.0, "logSideSlope": 1.0, "logSideOffset": 0.0,
           "linSideSlope": 1.0, "linSideOffset": 0.0,
           "linSideBreak": None, "linearSlope": None}
    out = {k: np.full(3, np.nan) for k in keys}
    found = False
    for ch in node:
        if _tag(ch) != "LogParams":
            continue
        found = True
        chan = ch.get("channel")
        idx = ["RGB".index(chan)] if chan in ("R", "G", "B") else [0, 1, 2]
        for k in keys:
            v = ch.get(k)
            if v is not None:
                for i in idx:
                    out[k][i] = float(v)
    params = {}
    for k in keys:
        vals = out[k]
        if np.all(np.isnan(vals)):
            params[k] = dft[k]
        else:
            fill = dft[k] if dft[k] is not None else 0.0
            params[k] = np.where(np.isnan(vals), fill, vals)
    return found, params


def _parse_log(node, ins, outs):
    style = node.get("style", "log2")
    found, p = _log_params(node)
    if style in ("log2", "log10", "antiLog2", "antiLog10"):
        return ("log", style, False, False), ()
    if not found:
        raise ValueError(f"CLF: Log style {style} requires LogParams")

    def vec(k, default):
        v = p[k]
        if v is None:
            return np.full((3, 1, 1), default, np.float32)
        return np.asarray(v, np.float32).reshape(-1)[..., None, None] \
            if np.ndim(v) else np.full((3, 1, 1), v, np.float32)

    base = vec("base", 2.0)
    lss = vec("logSideSlope", 1.0)
    lso = vec("logSideOffset", 0.0)
    lns = vec("linSideSlope", 1.0)
    lno = vec("linSideOffset", 0.0)
    if style in ("cameraLinToLog", "cameraLogToLin"):
        if p["linSideBreak"] is None:
            raise ValueError("CLF: camera Log styles need linSideBreak")
        brk = vec("linSideBreak", 0.0)
        # derived linear-segment params (CLF spec eq. for camera styles)
        logb = np.log(base)
        if p["linearSlope"] is None:
            lin_slope = lss * lns / ((lns * brk + lno) * logb)
        else:
            lin_slope = vec("linearSlope", 1.0)
        log_brk = lss * np.log(lns * brk + lno) / logb + lso
        lin_off = log_brk - lin_slope * brk
        arrs = (base, lss, lso, lns, lno, brk,
                lin_slope.astype(np.float32), lin_off.astype(np.float32))
        return ("log", style, True, True), tuple(
            np.asarray(a, np.float32) for a in arrs)
    arrs = (base, lss, lso, lns, lno)
    return ("log", style, False, True), tuple(
        np.asarray(a, np.float32) for a in arrs)


def _parse_cdl(node, ins, outs):
    style = node.get("style", "Fwd")
    slope = np.ones(3)
    offset = np.zeros(3)
    power = np.ones(3)
    sat = 1.0
    for ch in node:
        t = _tag(ch)
        if t == "SOPNode":
            for sub in ch:
                st = _tag(sub)
                if st == "Slope":
                    slope = _floats(sub.text)[:3]
                elif st == "Offset":
                    offset = _floats(sub.text)[:3]
                elif st == "Power":
                    power = _floats(sub.text)[:3]
        elif t == "SatNode":
            for sub in ch:
                if _tag(sub) == "Saturation":
                    sat = float(sub.text)
    arrs = (slope.reshape(3, 1, 1).astype(np.float32),
            offset.reshape(3, 1, 1).astype(np.float32),
            power.reshape(3, 1, 1).astype(np.float32),
            np.float32(sat))
    return ("cdl", style), arrs


_PARSERS = {
    "LUT1D": _parse_lut1d,
    "LUT3D": _parse_lut3d,
    "Matrix": _parse_matrix,
    "Range": _parse_range,
    "Exponent": _parse_exponent,
    "Log": _parse_log,
    "ASC_CDL": _parse_cdl,
}

_META = ("Description", "InputDescriptor", "OutputDescriptor", "Info")


def load_clf(path):
    """Parse a .clf / .clfz file -> (static_sig, arrays).

    static_sig is a hashable tuple of per-op signatures (jit cache key
    material); arrays is a tuple of per-op constant-array tuples.
    """
    if str(path).lower().endswith((".clfz", ".gz")):
        with gzip.open(path, "rb") as f:
            data = f.read()
    else:
        with open(path, "rb") as f:
            data = f.read()
    root = ET.fromstring(data)
    if _tag(root) != "ProcessList":
        raise ValueError(f"CLF: root element is {_tag(root)}")
    sigs = []
    arrays = []
    for node in root:
        t = _tag(node)
        if t in _META:
            continue
        if t not in _PARSERS:
            raise ValueError(f"CLF: unsupported ProcessNode {t}")
        ins = _scale(node.get("inBitDepth"))
        outs = _scale(node.get("outBitDepth"))
        sig, arrs = _PARSERS[t](node, ins, outs)
        sigs.append(sig)
        arrays.append(tuple(arrs))
    return tuple(sigs), tuple(arrays)


# -- device evaluation -------------------------------------------------------


def _apply_lut1d(x, sig, arrs):
    (table,) = arrs
    n = sig[1]
    pos = torch.clamp(x, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(pos.to(torch.int32), 0, n - 2)
    f = pos - i0.to(x.dtype)
    i0 = i0.long()
    out = []
    for c in range(3):
        col = table[:, c]
        v0 = col[i0[c]]
        v1 = col[i0[c] + 1]
        out.append(v0 + (v1 - v0) * f[c])
    return torch.stack(out)


def _apply_lut3d(x, sig, arrs):
    from art_tpu_torch.color.lut3d import apply_tetrahedral, apply_trilinear

    (table,) = arrs
    fn = apply_tetrahedral if sig[2] == "tetrahedral" else apply_trilinear
    return torch.stack(fn(torch.clamp(x[0], 0, 1), torch.clamp(x[1], 0, 1),
                          torch.clamp(x[2], 0, 1), table))


def _apply_matrix(x, sig, arrs):
    m, off = arrs
    return torch.stack([m[i, 0] * x[0] + m[i, 1] * x[1] + m[i, 2] * x[2]
                        + off[i] for i in range(3)])


def _apply_range(x, sig, arrs):
    a, b = arrs
    lo, hi = sig[1], sig[2]
    y = x * a + b
    if lo is not None:
        y = torch.clamp(y, min=lo)
    if hi is not None:
        y = torch.clamp(y, max=hi)
    return y


def _apply_exponent(x, sig, arrs):
    exps, offs = arrs
    s = sig[1].lower()
    mirror = "mirror" in s
    passthru = "passthru" in s
    rev = s.endswith("rev")
    if s.startswith("moncurve"):
        # a gamma with a linear toe (the CLF spec, 5.6.2)
        xb = offs / (exps - 1.0)
        yb = fpow(exps * offs / ((exps - 1.0) * (1.0 + offs)), exps)
        sl = ((exps - 1.0) / offs) * yb
        ax = torch.abs(x) if mirror else x
        if not rev:
            curve = fpow(torch.clamp(ax + offs, min=0.0) / (1.0 + offs),
                              exps)
            y = torch.where(ax >= xb, curve, ax * sl)
        else:
            curve = (1.0 + offs) * fpow(torch.clamp(ax, min=0.0),
                                             1.0 / exps) - offs
            y = torch.where(ax >= yb, curve, ax / sl)
        return torch.sign(x) * y if mirror else y
    p = 1.0 / exps if rev else exps
    if mirror:
        return torch.sign(x) * fpow(torch.abs(x), p)
    if passthru:
        return torch.where(x < 0, x, fpow(torch.clamp(x, min=0.0), p))
    return fpow(torch.clamp(x, min=0.0), p)


def _apply_log(x, sig, arrs):
    style = sig[1]
    eps = 1e-10
    if style == "log2":
        return torch.log2(torch.clamp(x, min=eps))
    if style == "log10":
        return torch.log10(torch.clamp(x, min=eps))
    if style == "antiLog2":
        return torch.exp2(x)
    if style == "antiLog10":
        return fpow(10.0, x)
    camera = style.startswith("camera")
    if camera:
        base, lss, lso, lns, lno, brk, lin_slope, lin_off = arrs
    else:
        base, lss, lso, lns, lno = arrs
    if style in ("linToLog", "cameraLinToLog"):
        logv = lss * (torch.log(torch.clamp(lns * x + lno, min=eps))
                      / torch.log(base)) + lso
        if camera:
            return torch.where(x <= brk, lin_slope * x + lin_off, logv)
        return logv
    if style in ("logToLin", "cameraLogToLin"):
        linv = (fpow(base, (x - lso) / lss) - lno) / lns
        if camera:
            log_brk = lin_slope * brk + lin_off
            return torch.where(x <= log_brk, (x - lin_off) / lin_slope,
                               linv)
        return linv
    raise ValueError(f"CLF: unknown Log style {style}")


_LUMA_W = (0.2126, 0.7152, 0.0722)


def _luma(y):
    return (y[0:1] * _LUMA_W[0] + y[1:2] * _LUMA_W[1]) + y[2:3] * _LUMA_W[2]


def _apply_cdl(x, sig, arrs):
    style = sig[1]
    slope, offset, power, sat = arrs
    clamp = "NoClamp" not in style
    if not style.startswith("Rev"):
        y = x * slope + offset
        if clamp:
            y = fpow(torch.clamp(y, 0.0, 1.0), power)
        else:
            y = torch.where(y >= 0, fpow(torch.clamp(y, min=0.0),
                                              power), y)
        luma = _luma(y)
        y = luma + sat * (y - luma)
        return torch.clamp(y, 0.0, 1.0) if clamp else y
    # reverse: unsaturate, un-power, un-slope
    luma = _luma(x)
    y = luma + (x - luma) / torch.clamp(sat, min=1e-9)
    if clamp:
        y = fpow(torch.clamp(y, 0.0, 1.0), 1.0 / power)
    else:
        y = torch.where(y >= 0, fpow(torch.clamp(y, min=0.0),
                                          1.0 / power), y)
    y = (y - offset) / slope
    return torch.clamp(y, 0.0, 1.0) if clamp else y


_APPLIERS = {
    "lut1d": _apply_lut1d,
    "lut3d": _apply_lut3d,
    "matrix": _apply_matrix,
    "range": _apply_range,
    "exponent": _apply_exponent,
    "log": _apply_log,
    "cdl": _apply_cdl,
}


def apply_clf(x, sigs, arrays):
    """A parsed CLF ProcessList over a (3, H, W) stack; arrays as
    tensors on x's device (the planner's tuples, `data_to_torch`)."""
    for sig, arrs in zip(sigs, arrays):
        x = _APPLIERS[sig[0]](x, sig, arrs)
    return x
