"""Float32 arithmetic that must round the same on every device.

`fdiv` divides by a tensor: PyTorch's CUDA division by a Python scalar
multiplies by the scalar's reciprocal, which rounds differently from an
IEEE division; `rdiv` divides a scalar by a tensor, which PyTorch
rounds as a reciprocal and a product. `cbrt` stands in for `jnp.cbrt`, which PyTorch lacks.
`mat3` applies a 3x3 matrix as explicit multiply-adds.
"""

from __future__ import annotations

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


def rdiv(a, b):
    """a / b as an IEEE float division for a Python scalar a and a tensor
    b (PyTorch's `a / b` multiplies by b's reciprocal instead)."""
    return torch.full_like(b, a) / b
