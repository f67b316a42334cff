"""JAX's default random numbers, bit for bit, in torch integer arithmetic
(the reference draws its film grain with ``jax.random.normal``).

`key(seed)` is ``jax.random.PRNGKey(seed)`` for a seed below 2^32: the
pair (0, seed). `bits(key, shape)` is ``jax.random.bits`` (uint32) with
partitionable Threefry-2x32 (``jax_threefry_partitionable``, on by
default): element i hashes the counter pair (i >> 32, i & 0xffffffff)
and XORs the two output words (jax/_src/prng.py::
_threefry_random_bits_partitionable, _threefry2x32_lowering). `normal`
is ``jax.random.normal`` in float32 (jax/_src/random.py::_normal_real):
a uniform on (nextafter(-1, 0), 1) from the bits' top 23 mantissa bits,
then sqrt(2) * erfinv, with XLA's single-precision erfinv polynomial.
The words are int64 tensors holding uint32 values (torch's uint32 has
few kernels), so the same code runs on the card and on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's ErfInv32 (its client math library): a degree-8 polynomial in
# w - 2.5 for w = -log1p(-x^2) < 5, else in sqrt(w) - 3
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)

_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# (1 - lo) rounded to float32, as the reference's uniform scales by it
_SPAN = float(np.float32(1.0) - np.float32(_LO))


def key(seed):
    """``jax.random.PRNGKey(seed)`` as a pair of Python ints."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed}: want 0 <= seed < 2**32")
    return (0, seed)


def _rotl(v, r):
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32(k, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words x0, x1
    (int64 tensors of uint32 values) under the key pair k."""
    ks = (k[0] & _M32, k[1] & _M32, (k[0] ^ k[1] ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def bits(k, shape, device="cpu"):
    """``jax.random.bits(key, shape)``: uint32 values in an int64 tensor
    on `device`."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k, idx >> 32, idx & _M32)
    return (b0 ^ b1).reshape(shape)


def erfinv(x):
    """XLA's float32 erfinv of x in (-1, 1)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return p * x


def uniform_bits(b):
    """The reference's float32 uniform on [nextafter(-1, 0), 1) from
    uint32 words b: 1 + mantissa bits, minus 1, scaled and shifted."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f * _SPAN + _LO, min=_LO)


def normal(k, shape, device="cpu"):
    """``jax.random.normal(key, shape, float32)`` on `device`."""
    u = uniform_bits(bits(k, shape, device))
    return float(np.float32(math.sqrt(2.0))) * erfinv(u)
