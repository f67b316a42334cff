"""Float32 arithmetic that must round the same on every device.

`fdiv` divides by a tensor: PyTorch's CUDA division by a Python scalar
multiplies by the scalar's reciprocal, which rounds differently from an
IEEE division; `rdiv` divides a scalar by a tensor, which PyTorch
rounds as a reciprocal and a product. `cbrt` stands in for `jnp.cbrt`,
which PyTorch lacks; `cbrt_xla` follows XLA's own rounding of it.
`mat3` applies a 3x3 matrix as explicit multiply-adds. `fpow` is a
float32 power through float64, alike on every device. `interp` is
`jnp.interp`'s formula, constant ends included. `fsqrt`, `cumsum32` and
`mean32` round alike on the card and the CPU, where PyTorch's own
float32 versions do not: its CPU sqrt is not the correctly rounded root
(for ~0.5% of values), its CPU cumsum accumulates in float64 and its
CUDA scan in float32, and the two reduce a mean in different orders.
"""

from __future__ import annotations

import numpy as np
import torch


def fdiv(a, b):
    """a / b as an IEEE float division on a's device, for a Python or
    numpy scalar (or tensor) b."""
    return a / torch.as_tensor(b, dtype=a.dtype, device=a.device)


def mat3(m, rgb):
    """(3, H, W) m @ rgb as explicit multiply-adds in the reference's order
    (develop.py::_mat3): no matrix unit, no TF32. rgb: a (3, H, W) tensor
    or three planes."""
    return torch.stack([m[i, 0] * rgb[0] + m[i, 1] * rgb[1] + m[i, 2] * rgb[2]
                        for i in range(3)])


def cbrt(t):
    """Cube root of a positive float32 tensor: pow(t, 1/3) and one Newton
    step, y - (y - t/y^2)/3. Within 1 ulp of the correctly rounded root
    (np.cbrt on float32, itself up to 2 ulps off it, is within 2)."""
    y = torch.pow(t, 1.0 / 3.0)
    return y - fdiv(y - t / (y * y), 3.0)


def cbrt_xla(t):
    """jnp.cbrt as XLA computes it on the CPU, pow(t, float32(1/3)):
    here the float64 power rounded to float32, which equals XLA's value
    for all but ~0.06% of inputs (1 ulp there) and rounds alike on every
    device. For the threshold decisions that follow a reference's cube
    root (the AHD/EAHD Lab votes, the dual demosaic's L), where `cbrt`'s
    1-ulp differences from XLA (~14% of values) flip votes."""
    return torch.pow(t.double(), float(np.float32(1.0 / 3.0))).to(t.dtype)


def fpow(t, e):
    """t ** e as XLA's float32 power, a Python base or exponent rounded to
    float32 (a weak-typed scalar under JAX): the float64 power rounded to
    the float result type, the same value on every device (PyTorch's CUDA
    pow is not correctly rounded, nor its CPU pow of two tensors)."""
    if not torch.is_tensor(t):
        return torch.pow(float(np.float32(t)), e.double()).to(e.dtype)
    if not torch.is_tensor(e):
        return torch.pow(t.double(), float(np.float32(e))).to(t.dtype)
    return torch.pow(t.double(), e.double()).to(
        torch.promote_types(t.dtype, e.dtype))


def rdiv(a, b):
    """a / b as an IEEE float division for a Python scalar a and a tensor
    b (PyTorch's `a / b` multiplies by b's reciprocal instead)."""
    return torch.full_like(b, a) / b


# jnp.interp's threshold below which a knot interval counts as empty
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def interp(x, xp, fp):
    """jnp.interp(x, xp, fp) for float32 tensors (JAX's own formula):
    the interval from a right-sided search clipped to [1, n - 1], the
    slope as (x - xp[i-1]) / dx * df, fp[0] below xp[0] and fp[-1]
    above xp[-1]."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, n - 1)
    f0 = fp[i - 1]
    df = fp[i] - f0
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= _INTERP_EPS
    f = torch.where(dx0, f0, f0 + (delta / torch.where(
        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def fsqrt(t):
    """sqrt of a float32 tensor, correctly rounded on every device (the
    float64 root rounds to the float32 one)."""
    return torch.sqrt(t.double()).to(t.dtype)


def cumsum32(a, dim):
    """Running sums along dim, accumulated in float64 and stored as a's
    dtype, on every device (what PyTorch's CPU cumsum of float32 does)."""
    return torch.cumsum(a, dim, dtype=torch.float64).to(a.dtype)


def mean32(a, dim=None, keepdim=False):
    """The mean (of all of a, or along dim) in float64, as a's dtype: the
    same value on every device."""
    if dim is None:
        return torch.mean(a, dtype=torch.float64).to(a.dtype)
    return torch.mean(a, dim, keepdim=keepdim,
                      dtype=torch.float64).to(a.dtype)
