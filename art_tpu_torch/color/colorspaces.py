"""Color space constants, host transfer curves, the device TRC encode and
Lab (counterpart of ``art_tpu/color/colorspaces.py``).

The matrices, the numpy transfer curves and the host-side fit are copies
of the reference's (its numpy branches). The device encode follows the
reference's device branch: a Horner fit on the x^(1/8) warp, not a
`pow`, so the port's output values are the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from art_tpu_torch.core.curve1d import clenshaw
from art_tpu_torch.core.fmath import cbrt, fdiv

# -- Bradford-adapted (D50) RGB<->XYZ matrices (iccmatrices.h:76-160) -------

MATRICES_RGB_TO_XYZ = {
    "sRGB": np.array(
        [
            [0.4360747, 0.3850649, 0.1430804],
            [0.2225045, 0.7168786, 0.0606169],
            [0.0139322, 0.0971045, 0.7141733],
        ]
    ),
    "Adobe RGB": np.array(
        [
            [0.6097559, 0.2052401, 0.1492240],
            [0.3111242, 0.6256560, 0.0632197],
            [0.0194811, 0.0608902, 0.7448387],
        ]
    ),
    "ProPhoto": np.array(
        [
            [0.7976749, 0.1351917, 0.0313534],
            [0.2880402, 0.7118741, 0.0000857],
            [0.0000000, 0.0000000, 0.8252100],
        ]
    ),
    "Rec2020": np.array(
        [
            [0.6734241, 0.1656411, 0.1251286],
            [0.2790177, 0.6753402, 0.0456377],
            [-0.0019300, 0.0299784, 0.7973330],
        ]
    ),
    "ACESp0": np.array(
        [
            [0.9908526, 0.0122334, -0.0388654],
            [0.3618807, 0.72255045, -0.0843859],
            [-0.0027093, 0.0082323, 0.8196880],
        ]
    ),
    "ACESp1": np.array(
        [
            [0.689697, 0.149944, 0.124559],
            [0.284448, 0.671758, 0.043794],
            [-0.006043, 0.009998, 0.820945],
        ]
    ),
}

MATRICES_XYZ_TO_RGB = {k: np.linalg.inv(v)
                       for k, v in MATRICES_RGB_TO_XYZ.items()}

# Bradford chromatic adaptation between illuminants (iccmatrices.h:25-47)
D65_TO_D50 = np.array(
    [
        [0.9555766, -0.0230393, 0.0631636],
        [-0.0282895, 1.0099416, 0.0210077],
        [0.0122982, -0.0204830, 1.3299098],
    ]
)
D50_TO_D65 = np.array(
    [
        [1.0478112, 0.0228866, -0.0501270],
        [0.0295424, 0.9904844, -0.0170491],
        [-0.0092345, 0.0150436, 0.7521316],
    ]
)

# sRGB D65 native matrix (iccmatrices.h:51-62): camera matrices
XYZ_FROM_SRGB_D65 = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ]
)

SRGB_D65_FROM_XYZ = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ]
)

# standard output TRCs by colorspace name (matrix + TRC output path)
OUTPUT_GAMMAS = {
    "sRGB": ("srgb", None),
    "Adobe RGB": ("gamma", 2.19921875),
    "ProPhoto": ("gamma", 1.8),
    "Rec2020": ("srgb", None),  # ART's bundled Rec2020 uses sRGB-like TRC
    "ACESp0": ("linear", None),
    "ACESp1": ("linear", None),
}


def _power_branch_fit(g, x0, deg=8):
    """Polynomial (highest-first) for 1.055*x^(1/g)-0.055-style branches
    evaluated in u = affine(x^(1/8)) (colorspaces.py::_power_branch_fit)."""
    t0 = x0 ** 0.125
    tt = np.linspace(t0, 1.0, 50001)
    y = tt ** (8.0 / g)
    u = 2.0 * (tt - t0) / (1.0 - t0) - 1.0
    c = np.polynomial.chebyshev.chebfit(u, y, deg)
    pol = np.polynomial.chebyshev.cheb2poly(c)[::-1]
    return (tuple(float(v) for v in pol), float(t0))


@functools.lru_cache(None)
def _srgb_gamma_fit():
    return _power_branch_fit(2.4, 0.0031308)


def srgb_gamma(x):
    """Linear -> sRGB encoding (g=2.4, slope 12.92) of a numpy array."""
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * np.power(np.maximum(x, 1e-12), 1.0 / 2.4) - 0.055)


def srgb_igamma(y):
    """sRGB -> linear decoding of a numpy array."""
    y = np.clip(y, 0.0, 1.0)
    return np.where(y <= 0.04045, y / 12.92,
                    np.power((y + 0.055) / 1.055, 2.4))


def srgb_gamma_torch(x):
    """Linear -> sRGB (g=2.4, slope 12.92) on a tensor, through the
    reference's x^(1/8)-warp Horner fit (colorspaces.py:152-160)."""
    pol, t0 = _srgb_gamma_fit()
    x = torch.clamp(x, 0.0, 1.0)
    t = torch.sqrt(torch.sqrt(torch.sqrt(x)))
    u = fdiv(2.0 * (t - t0), 1.0 - t0) - 1.0
    acc = torch.full_like(x, pol[0])
    for c in pol[1:]:
        acc = acc * u + c
    return torch.where(x <= 0.0031308, x * 12.92, 1.055 * acc - 0.055)


def check_trc(trc):
    """Refuse an output TRC this package does not encode. Every kind the
    reference's planner gives is encoded: the named ones, an ICC file's
    `para`, `cheb` and `lut` curves (`encode_trc`) and a LUT-class
    profile's `icclut` stages (`color/icclut.py`)."""
    if trc[0] not in ("srgb", "gamma", "linear", "para", "cheb", "lut",
                      "icclut"):
        raise NotImplementedError(f"output TRC {trc[0]!r} is not ported")


def pure_gamma(x, g):
    """max(x, 0)^g of a tensor (colorspaces.py::pure_gamma), the exponent
    a float32 as under JAX."""
    return torch.pow(torch.clamp(x, min=0.0), float(np.float32(g)))


def _cheb_sqrtwarp(x, coeffs):
    """A fitted sampled TRC (`core/curve1d.py::fit_curve`'s Chebyshev
    series on the sqrt-warped [0, 1]) by the Clenshaw recurrence
    (colorspaces.py::_cheb_sqrtwarp)."""
    t = 2.0 * torch.sqrt(torch.clamp(x, 0.0, 1.0)) - 1.0
    return clenshaw(t, coeffs)


def _para_fwd(x, p):
    """The ICC parametric curve in its tag's direction, device to linear
    (colorspaces.py::_para_fwd): (a*x + b)^g + e for x >= d, else
    c*x + f."""
    g, a, b, c, d, e, f = p
    x = torch.clamp(x, 0.0, 1.0)
    hi = torch.pow(torch.clamp(a * x + b, min=0.0), g) + e
    return torch.where(x >= d, hi, c * x + f)


def _para_inv(y, p):
    """The parametric curve's inverse, linear to device
    (colorspaces.py::_para_inv)."""
    g, a, b, c, d, e, f = p
    y = torch.clamp(y, 0.0, 1.0)
    hi = fdiv(torch.pow(torch.clamp(y - e, min=0.0), 1.0 / g) - b,
              a or 1.0)
    lo = fdiv(y - f, c) if c else torch.zeros_like(y)
    return torch.where(y >= c * d + f, hi, lo)


def _table(x, samples):
    """Linear interpolation in a table of samples over [0, 1]
    (colorspaces.py's `lut` branch)."""
    s = torch.as_tensor(np.asarray(samples, np.float32), device=x.device)
    n = s.shape[0]
    idx = torch.clamp(x, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(idx.to(torch.int32), 0, n - 2)
    fr = idx - i0
    i0 = i0.long()
    return s[i0] * (1 - fr) + s[i0 + 1] * fr


def encode_trc(x, trc):
    """Output TRC encode of a tensor (colorspaces.py::encode_trc): sRGB
    through the device fit, a pure gamma (Adobe RGB, ProPhoto) as
    clip(x, 0, 1)^(1/g), an ICC file's parametric curve by its inverse,
    a sampled one by its fitted encode series (`cheb`) or its encode
    table (`lut`); kinds without a matched branch clip to [0, 1] as the
    reference's default does ("linear" among them)."""
    kind, g = trc
    if kind == "srgb":
        return srgb_gamma_torch(x)
    if kind == "gamma":
        return pure_gamma(torch.clamp(x, 0.0, 1.0), 1.0 / g)
    if kind == "para":
        return _para_inv(x, g)
    if kind == "cheb":
        return torch.clamp(_cheb_sqrtwarp(x, g[0]), 0.0, 1.0)
    if kind == "lut":
        return _table(x, g[0])
    return torch.clamp(x, 0.0, 1.0)


def srgb_igamma_torch(y):
    """sRGB -> linear of a tensor, the exact power (colorspaces.py::
    srgb_igamma)."""
    y = torch.clamp(y, 0.0, 1.0)
    return torch.where(y <= 0.04045, fdiv(y, 12.92),
                       torch.pow(fdiv(y + 0.055, 1.055), 2.4))


def decode_trc(y, trc):
    """TRC decode of a tensor, device to linear (colorspaces.py::
    decode_trc): the counterpart of each `encode_trc` branch."""
    kind, g = trc
    if kind == "srgb":
        return srgb_igamma_torch(y)
    if kind == "gamma":
        return pure_gamma(torch.clamp(y, 0.0, 1.0), g)
    if kind == "para":
        return _para_fwd(y, g)
    if kind == "cheb":
        return torch.clamp(_cheb_sqrtwarp(y, g[1]), 0.0, 1.0)
    if kind == "lut":
        return _table(y, g[1])
    return torch.clamp(y, 0.0, 1.0)


# -- Lab (D50, matching Color::XYZ2Lab; colorspaces.py:263-294) -------------

D50_WHITE = np.array([0.9642, 1.0, 0.8249])
_EPS = 216.0 / 24389.0
_KAPPA = 24389.0 / 27.0


def xyz_to_lab(x, y, z, root=cbrt):
    """XYZ (D50) to Lab; `root` the cube root (`core/fmath.py::cbrt`, or
    `cbrt_xla` where XLA's rounding of the reference's jitted `jnp.cbrt`
    is what the result is held to)."""
    def f(t):
        return torch.where(t > _EPS, root(t), fdiv(_KAPPA * t + 16.0, 116.0))

    fx = f(fdiv(x, D50_WHITE[0]))
    fy = f(fdiv(y, D50_WHITE[1]))
    fz = f(fdiv(z, D50_WHITE[2]))
    return 116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)


def lab_to_xyz(L, a, b):
    fy = fdiv(L + 16.0, 116.0)
    fx = fy + fdiv(a, 500.0)
    fz = fy - fdiv(b, 200.0)

    def finv(t):
        t3 = t * t * t
        return torch.where(t3 > _EPS, t3, fdiv(116.0 * t - 16.0, _KAPPA))

    return (finv(fx) * float(D50_WHITE[0]), finv(fy) * float(D50_WHITE[1]),
            finv(fz) * float(D50_WHITE[2]))
