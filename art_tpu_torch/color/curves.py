"""Host-side diagonal and flat curves -> dense LUTs (a copy of
``art_tpu/color/curves.py``; the port's tone curve bakes its user curves
through it, dehaze its strength curve and the masks their H/C/L curves).

Reference: ``rtengine/diagonalcurves.cc``, ``rtengine/curves.h:90-171``
(parametric basis functions). Curves are evaluated on the host (numpy) at
plan time. Curve encodings match the `.arp` on-disk format: a flat list
of doubles whose first element is the type tag
(``rtgui/mydiagonalcurve.h:31-40``).
"""

from __future__ import annotations

import numpy as np

# Diagonal curve type tags (rtgui/mydiagonalcurve.h:31-40)
DCT_EMPTY = -1
DCT_LINEAR = 0
DCT_SPLINE = 1
DCT_PARAMETRIC = 2
DCT_NURBS = 3
DCT_CATMULL_ROM = 4

# Flat curve type tags (rtgui/myflatcurve.h:29-36)
FCT_EMPTY = -1
FCT_LINEAR = 0
FCT_MIN_MAX_CPOINTS = 1


# ---------------------------------------------------------------------------
# parametric basis (curves.h:93-156)
# ---------------------------------------------------------------------------

def _basel(x, m1, m2):
    x = np.asarray(x, dtype=np.float64)
    k = np.sqrt((m1 - 1.0) * (m1 - m2) * 0.5) / (1.0 - m2)
    l = (m1 - m2) / (1.0 - m2) + k
    with np.errstate(divide="ignore", invalid="ignore"):
        lx = np.log(np.maximum(x, 1e-300))
        val = m2 * x + (1.0 - m2) * (2.0 - np.exp(k * lx)) * np.exp(l * lx)
    return np.where(x == 0.0, 0.0, val)


def _baseu(x, m1, m2):
    return 1.0 - _basel(1.0 - np.asarray(x, dtype=np.float64), m1, m2)


def _cupper(x, m, hr):
    x = np.asarray(x, dtype=np.float64)
    if hr > 1.0:
        return _baseu(x, m, 2.0 * (hr - 1.0) / m)
    x1 = (1.0 - hr) / m
    x2 = x1 + hr
    out = np.where(x >= x2, 1.0, x * m)
    if hr > 0:
        mid = 1.0 - hr + hr * _baseu((x - x1) / hr, m, 0.0)
        out = np.where((x < x2) & (x >= x1), mid, out)
    return out


def _clower(x, m, sr):
    return 1.0 - _cupper(1.0 - np.asarray(x, dtype=np.float64), m, sr)


def _p00(x, prot):
    return _clower(x, 2.0, prot)


def _p11(x, prot):
    return _cupper(x, 2.0, prot)


def _p01(x, prot):
    x = np.asarray(x, dtype=np.float64)
    return np.where(
        x <= 0.5,
        _clower(x * 2.0, 2.0, prot) * 0.5,
        0.5 + _cupper((x - 0.5) * 2.0, 2.0, prot) * 0.5,
    )


def _p10(x, prot):
    x = np.asarray(x, dtype=np.float64)
    return np.where(
        x <= 0.5,
        _cupper(x * 2.0, 2.0, prot) * 0.5,
        0.5 + _clower((x - 0.5) * 2.0, 2.0, prot) * 0.5,
    )


def _pfull(x, prot, sh, hl):
    return (
        (1 - sh) * (1 - hl) * _p00(x, prot)
        + sh * hl * _p11(x, prot)
        + (1 - sh) * hl * _p01(x, prot)
        + sh * (1 - hl) * _p10(x, prot)
    )


# ---------------------------------------------------------------------------
# diagonal curves
# ---------------------------------------------------------------------------

class DiagonalCurve:
    """y = f(x) on [0,1]; matches DiagonalCurve semantics.

    ``points`` is the .arp flat list: [type, x0, y0, x1, y1, ...] or the
    9-element parametric form [2, x1, x2, x3, hl, lights, darks, sh, prot?].
    """

    def __init__(self, points):
        p = [float(v) for v in points]
        self.kind = DCT_EMPTY
        self._x = self._y = None
        self._param = None
        if len(p) < 3:
            return
        kind = int(p[0])
        if kind in (DCT_LINEAR, DCT_SPLINE, DCT_NURBS, DCT_CATMULL_ROM):
            n = (len(p) - 1) // 2
            x = np.array(p[1 : 1 + 2 * n : 2], dtype=np.float64)
            y = np.array(p[2 : 2 + 2 * n : 2], dtype=np.float64)
            identity = bool(np.all(np.abs(x - y) < 0.000009)) and (
                x[0] == 0.0 and x[-1] == 1.0
            )
            if identity:
                return
            # degenerate endpoint protection (diagonalcurves.cc:83-93)
            if n >= 2 and x[0] == 0.0 and x[1] == 0.0:
                x[1] = 0.01
            if n >= 2 and x[0] == 1.0 and x[1] == 1.0:
                x[0] = 0.99
            self._x, self._y = x, y
            if n <= 2 and kind in (DCT_SPLINE, DCT_NURBS, DCT_CATMULL_ROM):
                kind = DCT_LINEAR
            self.kind = kind
            if kind == DCT_SPLINE:
                self._ypp = self._spline_cubic_set(x, y)
            elif kind in (DCT_NURBS, DCT_CATMULL_ROM):
                self._poly_x, self._poly_y = self._densify(kind, x, y)
        elif kind == DCT_PARAMETRIC:
            if len(p) in (8, 9) and any(v != 0.0 for v in p[4:8]):
                xx = np.empty(9)
                xx[0] = p[0]
                for i in range(1, 4):
                    xx[i] = min(max(p[i], 0.001), 0.99)
                for i in range(4, 8):
                    xx[i] = (p[i] + 100.0) / 200.0
                xx[8] = 1.0 if len(p) < 9 else p[8] / 100.0
                self._param = xx
                self._mc = -np.log(2.0) / np.log(xx[2])
                mbase = float(_pfull(0.5, xx[8], xx[6], xx[5]))
                self._mfc = 0.0 if mbase <= 1e-14 else np.exp(np.log(mbase) / self._mc)
                self._msc = -np.log(2.0) / np.log(xx[1] / xx[2])
                self._mhc = -np.log(2.0) / np.log((xx[3] - xx[2]) / (1 - xx[2]))
                self.kind = DCT_PARAMETRIC

    # -- construction helpers ------------------------------------------------

    @staticmethod
    def _spline_cubic_set(x, y):
        # natural cubic spline second derivatives (diagonalcurves.cc:152-180)
        n = len(x)
        ypp = np.zeros(n)
        u = np.zeros(n)
        for i in range(1, n - 1):
            sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
            pden = sig * ypp[i - 1] + 2.0
            ypp[i] = (sig - 1.0) / pden
            u[i] = (y[i + 1] - y[i]) / (x[i + 1] - x[i]) - (y[i] - y[i - 1]) / (
                x[i] - x[i - 1]
            )
            u[i] = (6.0 * u[i] / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / pden
        ypp[n - 1] = 0.0
        for k in range(n - 2, -1, -1):
            ypp[k] = ypp[k] * ypp[k + 1] + u[k]
        return ypp

    @staticmethod
    def _densify(kind, x, y, samples=65000):
        """Sample NURBS/Catmull-Rom chains into a dense monotone-x polyline.

        The reference builds explicit polylines too (NURBS_set
        diagonalcurves.cc:183+, catmull_rom_chain :405-430); we sample the
        same constructions and later linearly interp.
        """
        if kind == DCT_CATMULL_ROM:
            px, py = _catmull_rom_chain(x, y, samples)
        else:  # NURBS: quadratic beziers through segment midpoints
            px, py = _nurbs_chain(x, y, samples)
        # enforce monotone x for interpolation
        order = np.argsort(px, kind="stable")
        px, py = px[order], py[order]
        keep = np.concatenate([[True], np.diff(px) > 0])
        return px[keep], py[keep]

    # -- evaluation ----------------------------------------------------------

    def is_identity(self):
        return self.kind == DCT_EMPTY

    def get_val(self, t):
        """Vectorised getVal (diagonalcurves.cc:443-520)."""
        t = np.asarray(t, dtype=np.float64)
        if self.kind == DCT_EMPTY:
            return t.copy()
        if self.kind == DCT_PARAMETRIC:
            return self._get_val_parametric(t)
        x, y = self._x, self._y
        if self.kind == DCT_LINEAR:
            return np.interp(t, x, y)
        if self.kind == DCT_SPLINE:
            tt = np.clip(t, x[0], x[-1])
            k_hi = np.clip(np.searchsorted(x, tt, side="right"), 1, len(x) - 1)
            k_lo = k_hi - 1
            h = x[k_hi] - x[k_lo]
            a = (x[k_hi] - tt) / h
            b = (tt - x[k_lo]) / h
            r = (
                a * y[k_lo]
                + b * y[k_hi]
                + ((a**3 - a) * self._ypp[k_lo] + (b**3 - b) * self._ypp[k_hi])
                * (h * h)
                / 6.0
            )
            r = np.maximum(r, 0.0)
            return np.where(t < x[0], y[0], np.where(t > x[-1], y[-1], r))
        # NURBS / Catmull-Rom via dense polyline
        r = np.interp(t, self._poly_x, self._poly_y)
        return np.where(t < x[0], y[0], np.where(t > x[-1], y[-1], r))

    def _get_val_parametric(self, t):
        xx = self._param
        mc, mfc, msc, mhc = self._mc, self._mfc, self._msc, self._mhc
        t = np.asarray(t, dtype=np.float64)
        safe_t = np.maximum(t, 1e-14)
        tv = np.exp(mc * np.log(safe_t))
        base = _pfull(tv, xx[8], xx[6], xx[5])
        stretched = np.where(
            base <= 1e-14, 0.0, np.exp(np.log(np.maximum(base, 1e-300)) / mc)
        )
        # shadows branch (t < x[2])
        with np.errstate(divide="ignore", invalid="ignore"):
            stv = np.exp(msc * np.log(np.maximum(stretched / max(mfc, 1e-300), 1e-300)))
            sbase = _pfull(stv, xx[8], xx[7], 0.5)
            shadows = mfc * np.where(
                sbase <= 1e-14, 0.0, np.exp(np.log(np.maximum(sbase, 1e-300)) / msc)
            )
            htv = np.exp(
                mhc
                * np.log(np.maximum((stretched - mfc) / max(1 - mfc, 1e-300), 1e-300))
            )
            hbase = _pfull(htv, xx[8], 0.5, xx[4])
            highlights = mfc + (1 - mfc) * np.where(
                hbase <= 1e-14, 0.0, np.exp(np.log(np.maximum(hbase, 1e-300)) / mhc)
            )
        out = np.where(t < xx[2], shadows, highlights)
        return np.where(t <= 1e-14, 0.0, out)

    def lut(self, size=65536, dtype=np.float32):
        """Bake into a LUT over [0, 1]."""
        t = np.linspace(0.0, 1.0, size)
        return self.get_val(t).astype(dtype)


def _catmull_rom_reflect(px, py, cx, cy):
    # diagonalcurves.cc:386-402 (RT PR#4701 variant)
    eps = 1e-5
    dx = px - cx
    dy = py - cy
    rx = cx - dx * 0.01
    ry = (dy / dx) * (rx - cx) + cy if dx > eps else cy
    return rx, ry


def _catmull_rom_tj(ti, px, py, qx, qy, alpha=0.25):
    # centripetal parameterisation: t_{j+1} = t_j + dist^alpha; the reference
    # uses sqrt(sqrt(...)) i.e. alpha = 0.25 on squared distance -> 0.5 power
    d = (qx - px) ** 2 + (qy - py) ** 2
    return ti + d**alpha


def _catmull_rom_chain(x, y, n_points):
    n = len(x)
    x_first, y_first = _catmull_rom_reflect(x[1], y[1], x[0], y[0])
    x_last, y_last = _catmull_rom_reflect(x[-2], y[-2], x[-1], y[-1])
    res_x = [x[0]]
    res_y = [y[0]]
    for i in range(n - 1):
        p0 = (x_first, y_first) if i == 0 else (x[i - 1], y[i - 1])
        p1 = (x[i], y[i])
        p2 = (x[i + 1], y[i + 1])
        p3 = (x_last, y_last) if i == n - 2 else (x[i + 2], y[i + 2])
        seg = max(int(n_points * (x[i + 1] - x[i]) + 0.5), 2)
        t0 = 0.0
        t1 = _catmull_rom_tj(t0, *p0, *p1)
        t2 = _catmull_rom_tj(t1, *p1, *p2)
        t3 = _catmull_rom_tj(t2, *p2, *p3)
        if p1[1] == p2[1] and p1[1] in (0.0, 1.0):
            ts = np.linspace(p1[0], p2[0], seg)[1:-1]
            res_x.extend(ts.tolist())
            res_y.extend([p1[1]] * len(ts))
        else:
            t = np.linspace(t1, t2, seg)[1:-1]
            a1x = _lerp(p0[0], p1[0], t0, t1, t)
            a1y = _lerp(p0[1], p1[1], t0, t1, t)
            a2x = _lerp(p1[0], p2[0], t1, t2, t)
            a2y = _lerp(p1[1], p2[1], t1, t2, t)
            a3x = _lerp(p2[0], p3[0], t2, t3, t)
            a3y = _lerp(p2[1], p3[1], t2, t3, t)
            b1x = _lerp(a1x, a2x, t0, t2, t)
            b1y = _lerp(a1y, a2y, t0, t2, t)
            b2x = _lerp(a2x, a3x, t1, t3, t)
            b2y = _lerp(a2y, a3y, t1, t3, t)
            cx = _lerp(b1x, b2x, t1, t2, t)
            cy = _lerp(b1y, b2y, t1, t2, t)
            res_x.extend(np.asarray(cx).tolist())
            res_y.extend(np.asarray(cy).tolist())
        res_x.append(p2[0])
        res_y.append(p2[1])
    return np.array(res_x), np.array(res_y)


def _lerp(pa, pb, ta, tb, t):
    c = (tb - t) / (tb - ta)
    d = (t - ta) / (tb - ta)
    return c * pa + d * pb


def _nurbs_chain(x, y, n_points):
    """Quadratic-bezier chain through segment midpoints (NURBS_set)."""
    n = len(x)
    # control polygon: P0, P1, ..., PN-1; curve = P0 -> mid01 segment ...
    # The reference splits each interior span around midpoints; an equivalent
    # construction: quadratic beziers with on-curve points at P0, midpoints,
    # PN-1 and off-curve points at the interior Pi.
    res_x = [x[0]]
    res_y = [y[0]]
    per_seg = max(8, n_points // max(1, n))
    # first on-curve point after P0 is midpoint of (P1,P2) in ref; here:
    on_x = [x[0]]
    on_y = [y[0]]
    for i in range(1, n - 1):
        if i < n - 2:
            on_x.append(0.5 * (x[i] + x[i + 1]))
            on_y.append(0.5 * (y[i] + y[i + 1]))
    on_x.append(x[-1])
    on_y.append(y[-1])
    ctrl = list(zip(x[1:-1], y[1:-1]))
    for i, (cx, cy) in enumerate(ctrl):
        t = np.linspace(0.0, 1.0, per_seg)[1:]
        ax, ay = on_x[i], on_y[i]
        bx, by = on_x[i + 1], on_y[i + 1]
        qx = (1 - t) ** 2 * ax + 2 * (1 - t) * t * cx + t**2 * bx
        qy = (1 - t) ** 2 * ay + 2 * (1 - t) * t * cy + t**2 * by
        res_x.extend(qx.tolist())
        res_y.extend(qy.tolist())
    if len(ctrl) == 0:
        res_x.append(x[-1])
        res_y.append(y[-1])
    return np.array(res_x), np.array(res_y)


# ---------------------------------------------------------------------------
# flat curves
# ---------------------------------------------------------------------------

class FlatCurve:
    """Periodic/clamped flat curve (flatcurves.cc:26-90; a copy of
    art_tpu/color/curves.py::FlatCurve).

    Encoding: [1, x0, y0, leftTan0, rightTan0, x1, y1, lt1, rt1, ...].
    Used by HSL equalizer, parametric masks, etc. Identity value is the
    y everywhere for an empty curve (0.5 by default).
    """

    def __init__(self, points, periodic=True, identity_value=0.5):
        p = [float(v) for v in points]
        self.kind = FCT_EMPTY
        self.identity_value = identity_value
        self.periodic = periodic
        if len(p) < 5 or int(p[0]) != FCT_MIN_MAX_CPOINTS:
            return
        n = (len(p) - 1) // 4
        arr = np.array(p[1 : 1 + 4 * n]).reshape(n, 4)
        arr = arr[np.argsort(arr[:, 0], kind="stable")]
        x = arr[:, 0].copy()
        y = arr[:, 1].copy()
        lt = arr[:, 2].copy()
        rt = arr[:, 3].copy()
        if periodic:
            x = np.append(x, x[0] + 1.0)
            y = np.append(y, y[0])
            lt = np.append(lt, lt[0])
            rt = np.append(rt, rt[0])
        if np.all(np.abs(y - identity_value) < 1e-7):
            return
        self._x, self._y, self._lt, self._rt = x, y, lt, rt
        self.kind = FCT_MIN_MAX_CPOINTS
        self._poly_x, self._poly_y = self._build_poly()

    def _build_poly(self, per_seg=200):
        x, y, lt, rt = self._x, self._y, self._lt, self._rt
        nseg = len(x) - 1
        res_x = []
        res_y = []
        for i in range(nseg):
            x0, y0 = x[i], y[i]
            x1v, y1v = x[i + 1], y[i + 1]
            start_linear = rt[i] == 0.0 or y0 == y1v
            end_linear = lt[i + 1] == 0.0 or y0 == y1v
            if start_linear and end_linear:
                res_x.extend([x0, x1v])
                res_y.extend([y0, y1v])
                continue
            xp1 = x0 if start_linear else (x1v - x0) * rt[i] + x0
            xp3 = x1v if end_linear else (x0 - x1v) * lt[i + 1] + x1v
            xp2 = (xp1 + xp3) / 2.0
            yp2 = (y0 + y1v) / 2.0
            if rt[i] + lt[i + 1] > 1.0:
                xp1 = xp3 = xp2
            t = np.linspace(0.0, 1.0, per_seg)
            # first half: quadratic bezier (x0,y0)-(xp1,y0)-(xp2,yp2)
            if start_linear:
                res_x.extend([x0, xp2])
                res_y.extend([y0, yp2])
            else:
                qx = (1 - t) ** 2 * x0 + 2 * (1 - t) * t * xp1 + t**2 * xp2
                qy = (1 - t) ** 2 * y0 + 2 * (1 - t) * t * y0 + t**2 * yp2
                res_x.extend(qx.tolist())
                res_y.extend(qy.tolist())
            # second half: (xp2,yp2)-(xp3,y1)-(x1,y1)
            if end_linear:
                res_x.extend([xp2, x1v])
                res_y.extend([yp2, y1v])
            else:
                qx = (1 - t) ** 2 * xp2 + 2 * (1 - t) * t * xp3 + t**2 * x1v
                qy = (1 - t) ** 2 * yp2 + 2 * (1 - t) * t * y1v + t**2 * y1v
                res_x.extend(qx.tolist())
                res_y.extend(qy.tolist())
        px = np.array(res_x)
        py = np.array(res_y)
        order = np.argsort(px, kind="stable")
        px, py = px[order], py[order]
        keep = np.concatenate([[True], np.diff(px) > 0])
        return px[keep], py[keep]

    def is_identity(self):
        return self.kind == FCT_EMPTY

    def get_val(self, t):
        t = np.asarray(t, dtype=np.float64)
        if self.kind == FCT_EMPTY:
            return np.full_like(t, self.identity_value)
        if self.periodic:
            tt = np.mod(t - self._x[0], 1.0) + self._x[0]
        else:
            tt = np.clip(t, self._poly_x[0], self._poly_x[-1])
        return np.interp(tt, self._poly_x, self._poly_y)

    def lut(self, size=65536, dtype=np.float32):
        t = np.linspace(0.0, 1.0, size)
        return self.get_val(t).astype(dtype)
