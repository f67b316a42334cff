"""Per-channel RGB curves (counterpart of ``art_tpu/ops/rgbcurves.py``;
iprgbcurves.cc).

The curves are drawn in sRGB-gamma space and applied to linear data,
as the tone curve's user curves are (`ops.tonecurve.adjust_user_curve`);
the planner fits one device curve per channel (`core.curve1d.fit_curves`,
one representation for all three).
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.core.curve1d import eval_curve, fit_curves
from art_tpu_torch.ops.tonecurve import adjust_user_curve


def plan(pp, ctx):
    rc = pp.rgb_curves
    if not rc.enabled:
        return None
    luts = [adjust_user_curve(c) for c in (rc.rcurve, rc.gcurve, rc.bcurve)]
    if all(lut is None for lut in luts):
        return None
    ident = np.linspace(0.0, 1.0, 65536, dtype=np.float32)
    coeffs = fit_curves([lut if lut is not None else ident for lut in luts])
    active = tuple(lut is not None for lut in luts)
    return (active,), {"coeffs": coeffs}


def apply(rgb, data, static):
    (active,) = static
    coeffs = data["coeffs"]
    return torch.stack([eval_curve(rgb[c], coeffs[c]) if active[c] else rgb[c]
                        for c in range(3)])
