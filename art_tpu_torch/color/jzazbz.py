"""Jzazbz with polynomial PQ transfers (counterpart of
``art_tpu/color/jzazbz.py``).

The PQ transfers are the reference's host-fitted even/odd series on
power-warped domains (`pq_fits` is a numpy copy). `pq` / `pq_inv`
evaluate them on tensors, `xyz_to_jzazbz` / `jzazbz_to_xyz` convert
planes; `hue_of` computes the Neutral curve's hue
anchors on the host in float32 numpy, where the reference ran a jnp
float32 program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs

PQ_XMAX = 4.0
D50_TO_D65 = cs.D50_TO_D65.astype(np.float32)
D65_TO_D50 = cs.D65_TO_D50.astype(np.float32)


@functools.lru_cache(None)
def pq_fits():
    """(pf, qf, pi, qi, ymax): forward PQ on the x^(1/32) warp (11+11) and
    inverse on the y^(1/8) warp (9+9), as in art_tpu/color/jzazbz.py::
    _pq_fits."""
    def pq64(x):
        x = np.maximum(x, 1e-12)
        xx = (x * 1e-4) ** 0.1593017578125
        return ((0.8359375 + 18.8515625 * xx)
                / (1 + 18.6875 * xx)) ** 134.034375

    def pq_inv64(y):
        y = np.maximum(y, 1e-12)
        xx = y ** (1.0 / 134.034375)
        num = np.maximum(xx - 0.8359375, 0.0)
        den = 18.8515625 - 18.6875 * xx
        return 1e4 * (num / np.maximum(den, 1e-10)) ** 6.277394636015326

    ymax = float(pq64(np.float64(PQ_XMAX)))

    def split_fit(f, deg_half):
        t = np.linspace(-1.0, 1.0, 40001)
        y = f(t)
        fe = 0.5 * (y + y[::-1])
        fo = 0.5 * (y - y[::-1])
        half = t > 0
        a = np.vander(t[half] ** 2, deg_half + 1)
        p, *_ = np.linalg.lstsq(a, fe[half], rcond=None)
        q, *_ = np.linalg.lstsq(a, fo[half] / t[half], rcond=None)
        return tuple(float(c) for c in p), tuple(float(c) for c in q)

    pf, qf = split_fit(lambda t: pq64(PQ_XMAX * ((t + 1) / 2) ** 32), 11)
    pi, qi = split_fit(lambda t: pq_inv64(ymax * ((t + 1) / 2) ** 8), 9)
    return pf, qf, pi, qi, ymax


def _horner_sq(t, p, q, full):
    # P(t^2) + t*Q(t^2): the PQ fits are in t^2, not in 2t^2-1
    s = t * t
    accp = full(t, p[0])
    for c in p[1:]:
        accp = accp * s + c
    accq = full(t, q[0])
    for c in q[1:]:
        accq = accq * s + c
    return accp + t * accq


def pq(x):
    """PQ forward (1.0 = 100 nits) on a tensor."""
    pf, qf, _, _, _ = pq_fits()
    t = torch.clamp(x * (1.0 / PQ_XMAX), 0.0, 1.0)
    for _ in range(5):
        t = torch.sqrt(t)
    return _horner_sq(2.0 * t - 1.0, pf, qf, torch.full_like)


def pq_inv(y):
    """PQ inverse on a tensor."""
    _, _, pi, qi, ymax = pq_fits()
    v = torch.clamp(y * (1.0 / ymax), 0.0, 1.0)
    v = torch.sqrt(torch.sqrt(torch.sqrt(v)))
    return torch.clamp(_horner_sq(2.0 * v - 1.0, pi, qi, torch.full_like),
                       min=0.0)


def _pq_np32(x):
    pf, qf, _, _, _ = pq_fits()
    f32 = np.float32
    t = np.clip(x * f32(1.0 / PQ_XMAX), f32(0), f32(1))
    for _ in range(5):
        t = np.sqrt(t)
    tt = f32(2) * t - f32(1)
    return _horner_sq(tt, [f32(c) for c in pf], [f32(c) for c in qf],
                      lambda a, v: np.full_like(a, v))


def hue_of(rgb, ws):
    """Jzazbz hue atan2(az, bz) of one working-space RGB triple, in
    float32 (the Neutral curve's anchors; art_tpu/ops/tonecurve_neutral.py::
    _hue_of)."""
    f32 = np.float32
    r, g, b = (np.asarray(v, f32) for v in rgb)
    ws = np.asarray(ws, f32)
    x = ws[0, 0] * r + ws[0, 1] * g + ws[0, 2] * b
    y = ws[1, 0] * r + ws[1, 1] * g + ws[1, 2] * b
    z = ws[2, 0] * r + ws[2, 1] * g + ws[2, 2] * b
    m = D50_TO_D65
    x, y, z = (m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
               m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
               m[2, 0] * x + m[2, 1] * y + m[2, 2] * z)
    lp = _pq_np32(f32(0.674207838) * x + f32(0.382799340) * y
                  - f32(0.047570458) * z)
    mp = _pq_np32(f32(0.149284160) * x + f32(0.739628340) * y
                  + f32(0.083327300) * z)
    sp = _pq_np32(f32(0.070941080) * x + f32(0.174768000) * y
                  + f32(0.670970020) * z)
    az = f32(3.524000) * lp - f32(4.066708) * mp + f32(0.542708) * sp
    bz = f32(0.199076) * lp + f32(1.096799) * mp - f32(1.295875) * sp
    return float(np.arctan2(az, bz))


def xyz_to_jzazbz(x, y, z):
    """D50 XYZ planes -> (Jz, az, bz) (jzazbz.py::xyz_to_jzazbz)."""
    m = D50_TO_D65
    x, y, z = (m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
               m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
               m[2, 0] * x + m[2, 1] * y + m[2, 2] * z)
    lp = pq(0.674207838 * x + 0.382799340 * y - 0.047570458 * z)
    mp = pq(0.149284160 * x + 0.739628340 * y + 0.083327300 * z)
    sp = pq(0.070941080 * x + 0.174768000 * y + 0.670970020 * z)
    iz = 0.5 * (lp + mp)
    az = 3.524000 * lp - 4.066708 * mp + 0.542708 * sp
    bz = 0.199076 * lp + 1.096799 * mp - 1.295875 * sp
    jz = (0.44 * iz) / (1.0 - 0.56 * iz) - 1.6295499532821566e-11
    return jz, az, bz


def jzazbz_to_xyz(jz, az, bz):
    """(Jz, az, bz) -> D50 XYZ planes (jzazbz.py::jzazbz_to_xyz)."""
    jz = jz + 1.6295499532821566e-11
    iz = jz / (0.44 + 0.56 * jz)
    l = pq_inv(iz + 1.386050432715393e-1 * az + 5.804731615611869e-2 * bz)
    m = pq_inv(iz - 1.386050432715393e-1 * az - 5.804731615611891e-2 * bz)
    s = pq_inv(iz - 9.601924202631895e-2 * az - 8.118918960560390e-1 * bz)
    x = (1.661373055774069e+00 * l - 9.145230923250668e-01 * m
         + 2.313620767186147e-01 * s)
    y = (-3.250758740427037e-01 * l + 1.571847038366936e+00 * m
         - 2.182538318672940e-01 * s)
    z = (-9.098281098284756e-02 * l - 3.127282905230740e-01 * m
         + 1.522766561305260e+00 * s)
    mm = D65_TO_D50
    return (mm[0, 0] * x + mm[0, 1] * y + mm[0, 2] * z,
            mm[1, 0] * x + mm[1, 1] * y + mm[1, 2] * z,
            mm[2, 0] * x + mm[2, 1] * y + mm[2, 2] * z)
