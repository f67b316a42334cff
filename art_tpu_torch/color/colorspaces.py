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
    """Refuse an output TRC whose encode is not ported: the kinds that
    only ICC profile files give (para, cheb, lut, icclut)."""
    if trc[0] in ("para", "cheb", "lut", "icclut"):
        raise NotImplementedError(f"output TRC {trc[0]!r} is not ported")


def pure_gamma(x, g):
    """max(x, 0)^g of a tensor (colorspaces.py::pure_gamma), the exponent
    a float32 as under JAX."""
    return torch.pow(torch.clamp(x, min=0.0), float(np.float32(g)))


def encode_trc(x, trc):
    """Output TRC encode of a tensor (colorspaces.py::encode_trc): sRGB
    through the device fit, a pure gamma (Adobe RGB, ProPhoto) as
    clip(x, 0, 1)^(1/g); kinds without a matched branch clip to [0, 1]
    as the reference's default does ("linear" among them). For a TRC
    that `check_trc` admits (the pipeline checks it at build time)."""
    if trc[0] == "srgb":
        return srgb_gamma_torch(x)
    if trc[0] == "gamma":
        return pure_gamma(torch.clamp(x, 0.0, 1.0), 1.0 / trc[1])
    return torch.clamp(x, 0.0, 1.0)


# -- Lab (D50, matching Color::XYZ2Lab; colorspaces.py:263-294) -------------

D50_WHITE = np.array([0.9642, 1.0, 0.8249])
_EPS = 216.0 / 24389.0
_KAPPA = 24389.0 / 27.0


def xyz_to_lab(x, y, z):
    def f(t):
        return torch.where(t > _EPS, cbrt(t), fdiv(_KAPPA * t + 16.0, 116.0))

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
