"""CIECAM02 appearance model (a copy of ``art_tpu/color/ciecam02.py``;
rtengine/ciecam02.{h,cc}).

Forward XYZ -> (J, C, h) and inverse, with the viewing-condition
constants precomputed on the host (the reference's initcam1/initcam2
role). The Perceptual tone-curve mode (curves.cc:571-771) judges the
curve's chroma shifts in CIECAM02 terms. `xp` is numpy (the default) or
`TORCH`, which runs the same equations on tensors.

Implements the standard CIE 159:2004 equations (CAT02 adaptation, HPE
cone response, Michaelis-Menten compression). Hunt/helmholtz effects not
used by the reference are omitted.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_M_CAT02 = np.array([
    [0.7328, 0.4296, -0.1624],
    [-0.7036, 1.6975, 0.0061],
    [0.0030, 0.0136, 0.9834]])
_M_HPE = np.array([
    [0.38971, 0.68898, -0.07868],
    [-0.22981, 1.18340, 0.04641],
    [0.0, 0.0, 1.0]])
_M_HPE_CAT02 = _M_HPE @ np.linalg.inv(_M_CAT02)
_M_CAT02_HPE = np.linalg.inv(_M_HPE_CAT02)
_M_CAT02_INV = np.linalg.inv(_M_CAT02)


class _Torch:
    """The numpy calls of the equations below, on tensors."""

    abs = staticmethod(torch.abs)
    sign = staticmethod(torch.sign)
    sqrt = staticmethod(torch.sqrt)
    cos = staticmethod(torch.cos)
    sin = staticmethod(torch.sin)
    arctan2 = staticmethod(torch.atan2)
    where = staticmethod(torch.where)

    @staticmethod
    def maximum(a, b):
        return torch.clamp(a, min=b)


TORCH = _Torch()


@dataclasses.dataclass(frozen=True)
class ViewingConditions:
    """Precomputed constants for one surround/adaptation state."""

    white: tuple = (96.42, 100.0, 82.49)  # D50 in the reference pipeline
    la: float = 20.0   # adapting luminance cd/m2
    yb: float = 18.0   # background relative luminance
    surround: str = "average"

    def constants(self):
        f, c, nc = {
            "average": (1.0, 0.69, 1.0),
            "dim": (0.9, 0.59, 0.9),
            "dark": (0.8, 0.525, 0.8),
        }[self.surround]
        xw, yw, zw = self.white
        la = self.la
        d = f * (1.0 - (1.0 / 3.6) * math.exp((-la - 42.0) / 92.0))
        d = min(max(d, 0.0), 1.0)
        rgb_w = _M_CAT02 @ np.array([xw, yw, zw])
        d_rgb = d * yw / rgb_w + 1.0 - d
        k = 1.0 / (5.0 * la + 1.0)
        fl = (0.2 * k ** 4 * 5.0 * la
              + 0.1 * (1.0 - k ** 4) ** 2 * (5.0 * la) ** (1.0 / 3.0))
        n = self.yb / yw
        z = 1.48 + math.sqrt(n)
        nbb = 0.725 * (1.0 / n) ** 0.2
        rgb_wc = d_rgb * rgb_w
        rgb_wp = _M_HPE_CAT02 @ rgb_wc
        t = (fl * rgb_wp / 100.0) ** 0.42
        rgb_aw = 400.0 * t / (t + 27.13) + 0.1
        aw = (2.0 * rgb_aw[0] + rgb_aw[1] + 0.05 * rgb_aw[2] - 0.305) * nbb
        return {
            "c": c, "nc": nc, "n": n, "z": z, "fl": fl, "nbb": nbb,
            "ncb": nbb, "aw": aw, "d_rgb": d_rgb,
        }


def _adapt(rgb_p, fl, xp):
    t = xp.abs(fl * rgb_p / 100.0) ** 0.42
    return xp.sign(rgb_p) * 400.0 * t / (t + 27.13) + 0.1


def _adapt_inv(ra, fl, xp):
    v = ra - 0.1
    av = xp.abs(v)
    t = (27.13 * av) / xp.maximum(400.0 - av, 1e-6)
    return xp.sign(v) * (100.0 / fl) * t ** (1.0 / 0.42)


def xyz_to_jch(x, y, z, vc_consts, xp=np):
    """XYZ (0..100 scale) -> (J, C, h[rad])."""
    k = vc_consts
    m = _M_CAT02
    r = m[0, 0] * x + m[0, 1] * y + m[0, 2] * z
    g = m[1, 0] * x + m[1, 1] * y + m[1, 2] * z
    b = m[2, 0] * x + m[2, 1] * y + m[2, 2] * z
    dr, dg, db = k["d_rgb"]
    r, g, b = r * dr, g * dg, b * db
    m2 = _M_HPE_CAT02
    rp = m2[0, 0] * r + m2[0, 1] * g + m2[0, 2] * b
    gp = m2[1, 0] * r + m2[1, 1] * g + m2[1, 2] * b
    bp = m2[2, 0] * r + m2[2, 1] * g + m2[2, 2] * b
    ra = _adapt(rp, k["fl"], xp)
    ga = _adapt(gp, k["fl"], xp)
    ba = _adapt(bp, k["fl"], xp)
    ca = ra - 12.0 * ga / 11.0 + ba / 11.0
    cb = (ra + ga - 2.0 * ba) / 9.0
    h = xp.arctan2(cb, ca)  # NOTE: math convention (a=cos axis)
    a_ach = (2.0 * ra + ga + 0.05 * ba - 0.305) * k["nbb"]
    j = 100.0 * xp.maximum(a_ach / k["aw"], 1e-9) ** (k["c"] * k["z"])
    hdeg = h
    et = 0.25 * (xp.cos(hdeg + 2.0) + 3.8)
    tt = ((50000.0 / 13.0) * k["nc"] * k["ncb"] * et
          * xp.sqrt(ca * ca + cb * cb)
          / xp.maximum(ra + ga + 21.0 * ba / 20.0, 1e-6))
    c = (tt ** 0.9 * xp.sqrt(j / 100.0)
         * (1.64 - 0.29 ** k["n"]) ** 0.73)
    return j, c, h


def jch_to_xyz(j, c, h, vc_consts, xp=np):
    """(J, C, h[rad]) -> XYZ (0..100 scale)."""
    k = vc_consts
    jj = xp.maximum(j, 1e-6)
    tt = (c / (xp.sqrt(jj / 100.0)
               * (1.64 - 0.29 ** k["n"]) ** 0.73)) ** (1.0 / 0.9)
    et = 0.25 * (xp.cos(h + 2.0) + 3.8)
    a_ach = k["aw"] * (jj / 100.0) ** (1.0 / (k["c"] * k["z"]))
    p1 = ((50000.0 / 13.0) * k["nc"] * k["ncb"] * et
          / xp.maximum(tt, 1e-9))
    p2 = a_ach / k["nbb"] + 0.305
    sin_h = xp.sin(h)
    cos_h = xp.cos(h)
    # solve for ca, cb (CIE 159 step 3, stable both branches via abs test)
    big_sin = xp.abs(sin_h) >= xp.abs(cos_h)
    # branch A: |sin| >= |cos|
    p4 = p1 / xp.where(big_sin, xp.where(sin_h == 0, 1e-9, sin_h), 1.0)
    cb_a = (p2 * (2.0 + 21.0 / 20.0) * (460.0 / 1403.0)) / (
        p4 + (2.0 + 21.0 / 20.0) * (220.0 / 1403.0) * (cos_h
        / xp.where(sin_h == 0, 1e-9, sin_h))
        - (27.0 / 1403.0) + (21.0 / 20.0) * (6300.0 / 1403.0))
    ca_a = cb_a * cos_h / xp.where(sin_h == 0, 1e-9, sin_h)
    # branch B: |cos| > |sin|
    p5 = p1 / xp.where(big_sin, 1.0, xp.where(cos_h == 0, 1e-9, cos_h))
    ca_b = (p2 * (2.0 + 21.0 / 20.0) * (460.0 / 1403.0)) / (
        p5 + (2.0 + 21.0 / 20.0) * (220.0 / 1403.0)
        - ((27.0 / 1403.0) - (21.0 / 20.0) * (6300.0 / 1403.0))
        * (sin_h / xp.where(cos_h == 0, 1e-9, cos_h)))
    cb_b = ca_b * sin_h / xp.where(cos_h == 0, 1e-9, cos_h)
    ca = xp.where(big_sin, ca_a, ca_b)
    cb = xp.where(big_sin, cb_a, cb_b)
    # zero-chroma guard
    zero = tt < 1e-8
    ca = xp.where(zero, 0.0, ca)
    cb = xp.where(zero, 0.0, cb)

    ra = (460.0 * p2 + 451.0 * ca + 288.0 * cb) / 1403.0
    ga = (460.0 * p2 - 891.0 * ca - 261.0 * cb) / 1403.0
    ba = (460.0 * p2 - 220.0 * ca - 6300.0 * cb) / 1403.0
    rp = _adapt_inv(ra, k["fl"], xp)
    gp = _adapt_inv(ga, k["fl"], xp)
    bp = _adapt_inv(ba, k["fl"], xp)
    m2 = _M_CAT02_HPE
    r = m2[0, 0] * rp + m2[0, 1] * gp + m2[0, 2] * bp
    g = m2[1, 0] * rp + m2[1, 1] * gp + m2[1, 2] * bp
    b = m2[2, 0] * rp + m2[2, 1] * gp + m2[2, 2] * bp
    dr, dg, db = k["d_rgb"]
    r, g, b = r / dr, g / dg, b / db
    mi = _M_CAT02_INV
    x = mi[0, 0] * r + mi[0, 1] * g + mi[0, 2] * b
    y = mi[1, 0] * r + mi[1, 1] * g + mi[1, 2] * b
    z = mi[2, 0] * r + mi[2, 1] * g + mi[2, 2] * b
    return x, y, z
