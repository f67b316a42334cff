"""Soft light blend (counterpart of ``art_tpu/ops/softlight.py``;
ipsoftlight.cc, Pegtop's formula).

v = srgb_gamma(x); v' = 3v^2 - 2v^3; out = lerp(blend, igamma(v'), x),
baked on the host into one fitted device curve.
"""

from __future__ import annotations

import numpy as np

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.core.curve1d import eval_curve, fit_curve


def plan(pp, ctx):
    slp = pp.softlight
    if not slp.enabled or slp.strength <= 0:
        return None
    blend = slp.strength / 100.0
    x = np.linspace(0.0, 1.0, 65536)
    v = cs.srgb_gamma(x)
    v2 = v * v
    sl = v2 + 2.0 * v2 - 2.0 * v2 * v
    y = blend * cs.srgb_igamma(np.clip(sl, 0.0, 1.0)) + (1 - blend) * x
    return (), {"coeffs": fit_curve(y)}


def apply(rgb, data, static):
    return eval_curve(rgb, data["coeffs"])
