"""1-D curves as host-fitted series (counterpart of ``art_tpu/core/curve1d.py``).

The planner refits every dense curve on the host: an even/odd Horner
split or a Chebyshev series on the sqrt-warped domain, or 64 cubic
segments for kinky curves. The fits are numpy copies of the reference's;
the evaluators are torch and follow the reference's float32 operation
order, so both packages evaluate the same polynomials the same way.
"""

from __future__ import annotations

import numpy as np
import torch

K = 64  # segments
CHEB_TOL = 2e-4  # max refit error (of full scale) to accept a series fit


def fit_curve(dense_lut, in_max=1.0, allow_poly=True):
    """(N,) dense curve on [0, in_max] -> Chebyshev (D,) on the sqrt
    warp, or (K, 4) cubic segments (art_tpu/core/curve1d.py::fit_curve)."""
    dense_lut = np.asarray(dense_lut, dtype=np.float64)
    n = dense_lut.shape[0]

    def curve_at(x01):
        idx = np.clip(x01, 0.0, 1.0) * (n - 1)
        i0 = np.floor(idx).astype(np.int64)
        i1 = np.minimum(i0 + 1, n - 1)
        fr = idx - i0
        return dense_lut[i0] * (1 - fr) + dense_lut[i1] * fr

    if allow_poly:
        t = np.linspace(0.0, 1.0, 4097)
        y = curve_at(t * t)
        for deg in (15, 23, 31):
            c = np.polynomial.chebyshev.chebfit(2.0 * t - 1.0, y, deg)
            err = np.abs(np.polynomial.chebyshev.chebval(2.0 * t - 1.0, c)
                         - y).max()
            if err < CHEB_TOL:
                return c.astype(np.float32)

    u_nodes = np.array([0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0])
    coeffs = np.zeros((K, 4))
    vinv = np.linalg.inv(np.vander(u_nodes, 4))
    for k in range(K):
        x01 = ((k + u_nodes) / K) ** 2
        coeffs[k] = vinv @ curve_at(x01)
    return coeffs.astype(np.float32)



def fit_curves(dense_luts, in_max=1.0):
    """Several curves fitted into one stackable representation
    (art_tpu/core/curve1d.py::fit_curves): Chebyshev series zero-padded
    to one degree, or, if any curve needs segments, all refit as
    segments."""
    fits = [fit_curve(np.asarray(lut), in_max) for lut in dense_luts]
    if all(f.ndim == 1 for f in fits):
        d = max(f.shape[0] for f in fits)
        return np.stack([np.pad(f, (0, d - f.shape[0])) for f in fits])
    return np.stack([f if f.ndim == 2
                     else fit_curve(np.asarray(lut), in_max,
                                    allow_poly=False)
                     for f, lut in zip(fits, dense_luts)])

def split_poly(fn_t, deg_half, tol=None):
    """Fit fn(t), t in [-1,1], as P(u) + t*Q(u) with u = 2t^2-1; returns
    (2, deg_half+1) highest power first, or None if `tol` is missed
    (art_tpu/core/curve1d.py::split_poly)."""
    t = np.linspace(-1.0, 1.0, 40001)
    y = np.asarray(fn_t(t), dtype=np.float64)
    fe = 0.5 * (y + y[::-1])
    fo = 0.5 * (y - y[::-1])
    half = t > 0
    u = 2.0 * t[half] ** 2 - 1.0
    a = np.polynomial.chebyshev.chebvander(u, deg_half)
    cp, *_ = np.linalg.lstsq(a, fe[half], rcond=None)
    cq, *_ = np.linalg.lstsq(a, fo[half] / t[half], rcond=None)
    p = np.polynomial.chebyshev.cheb2poly(cp)[::-1]
    q = np.polynomial.chebyshev.cheb2poly(cq)[::-1]
    out = np.stack([p, q]).astype(np.float32)
    if tol is not None:
        uu = 2.0 * t * t - 1.0
        approx = (np.polyval(out[0].astype(np.float64), uu)
                  + t * np.polyval(out[1].astype(np.float64), uu))
        if np.abs(approx - y).max() > tol:
            return None
    return out


def fit_gamma_split(gamma):
    """(fwd, inv) split fits of x^(1/gamma) on the x^(1/8) warp and x^gamma
    on the sqrt warp (art_tpu/core/curve1d.py::fit_gamma_split)."""
    g = float(gamma)

    def fwd_t(t):
        return np.clip((t + 1.0) / 2.0, 0.0, 1.0) ** (8.0 / g)

    def inv_t(t):
        return np.clip((t + 1.0) / 2.0, 0.0, 1.0) ** (2.0 * g)

    fwd = None
    inv = None
    for dh in (10, 12, 14, 16):
        if fwd is None:
            fwd = split_poly(fwd_t, dh, tol=5e-7)
        if inv is None:
            inv = split_poly(inv_t, dh, tol=5e-7)
    if fwd is None:
        fwd = split_poly(fwd_t, 16)
    if inv is None:
        inv = split_poly(inv_t, 16)
    return fwd, inv


def fit_curve_split(dense_lut, deg_half=(10, 12, 14, 16), tol=CHEB_TOL):
    """(N,) dense curve on [0,1] -> (2, K) split fit on the sqrt warp, or
    None for kinky curves (art_tpu/core/curve1d.py::fit_curve_split)."""
    dense_lut = np.asarray(dense_lut, dtype=np.float64)
    n = dense_lut.shape[0]

    def fn_t(t):
        x01 = ((t + 1.0) / 2.0) ** 2
        idx = np.clip(x01, 0.0, 1.0) * (n - 1)
        i0 = np.floor(idx).astype(np.int64)
        i1 = np.minimum(i0 + 1, n - 1)
        fr = idx - i0
        return dense_lut[i0] * (1 - fr) + dense_lut[i1] * fr

    if np.isscalar(deg_half):
        deg_half = (deg_half,)
    for dh in deg_half:
        out = split_poly(fn_t, dh, tol=tol)
        if out is not None:
            return out
    return None


def horner_split(t, p, q):
    """P(u) + t*Q(u) with u = 2t^2-1; p, q: Python floats, highest power
    first."""
    u = 2.0 * t * t - 1.0
    accp = torch.full_like(t, p[0])
    for c in p[1:]:
        accp = accp * u + c
    accq = torch.full_like(t, q[0])
    for c in q[1:]:
        accq = accq * u + c
    return accp + t * accq


def clenshaw(t, cks):
    """Chebyshev series sum at t by the Clenshaw recurrence."""
    t2 = 2.0 * t
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for k in range(len(cks) - 1, 0, -1):
        b1, b2 = cks[k] + t2 * b1 - b2, b1
    return cks[0] + t * b1 - b2


def eval_split(x, pq_coeffs, in_max=1.0, out_max=1.0):
    """Evaluate a (2, K) split fit (rows of Python floats) at
    t = 2*sqrt(x/in_max)-1."""
    t = 2.0 * torch.sqrt(torch.clamp(x / in_max, 0.0, 1.0)) - 1.0
    return horner_split(t, pq_coeffs[0], pq_coeffs[1]) * out_max


def eval_curve(x, coeffs, in_max=65535.0, out_max=65535.0):
    """Evaluate a fitted curve: (D,) Chebyshev on the sqrt warp or (K, 4)
    cubic segments uniform in sqrt(x); `coeffs` is a tensor on x's
    device."""
    if coeffs.ndim == 1:
        t = 2.0 * torch.sqrt(torch.clamp(x / in_max, 0.0, 1.0)) - 1.0
        return clenshaw(t, coeffs.tolist()) * out_max
    t = torch.sqrt(torch.clamp(x / in_max, 0.0, 1.0))
    s = t * K
    k = torch.clamp(s.to(torch.int32), max=K - 1).long()
    u = s - k.to(s.dtype)
    a, b, c, d = (coeffs[:, i][k] for i in range(4))
    y = ((a * u + b) * u + c) * u + d
    return y * out_max
