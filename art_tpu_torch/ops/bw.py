"""Black & white (counterpart of ``art_tpu/ops/bw.py``; ipbw.cc:214-367).

Per-channel gamma pre-curves, the weighted channel mix of the setting and
colour filter, and an optional colour cast: u and v offsets driven by a
film curve and a saturation curve of the luminance. Plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.curves import DiagonalCurve, FlatCurve
from art_tpu_torch.core.curve1d import eval_curve, fit_curve, fit_curves
from art_tpu_torch.core.image import MAXVAL

# colour filter presets as RGB weight multipliers (bw.py::_FILTERS)
_FILTERS = {
    "None": (1.0, 1.0, 1.0),
    "Red": (1.0, 0.05, 0.0),
    "Orange": (1.0, 0.42, 0.0),
    "Yellow": (1.0, 1.0, 0.0),
    "YellowGreen": (0.25, 1.0, 0.0),
    "GreenYellow": (0.25, 1.0, 0.0),
    "Green": (0.0, 1.0, 0.0),
    "Cyan": (0.0, 1.0, 1.0),
    "Blue": (0.0, 0.05, 1.0),
    "Purple": (1.0, 0.0, 1.0),
}


def _mixer_weights(setting, filter_, mr, mg, mb):
    """Relative settings normalise the filtered weights to sum 1, the
    absolute ones ("...Abs") keep them /100."""
    w = np.array([mr, mg, mb], dtype=np.float64)
    w = w * np.array(_FILTERS.get(filter_, (1.0, 1.0, 1.0)))
    if setting.endswith("Abs"):
        return w / 100.0
    s = w.sum()
    if abs(s) < 1e-6:
        return np.array([0.33, 0.33, 0.34])
    return w / s


def plan(pp, ctx):
    bwp = pp.bw
    if not bwp.enabled:
        return None
    weights = _mixer_weights(bwp.setting, bwp.filter_, bwp.mixer_red,
                             bwp.mixer_green, bwp.mixer_blue)
    gammas = [1.0 - g / (125.0 if g >= 0 else 100.0)
              for g in (bwp.gamma_red, bwp.gamma_green, bwp.gamma_blue)]
    has_gamma = any(abs(g - 1.0) > 1e-6 for g in gammas)
    lum_w = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]][1]
    data = {"weights": weights.astype(np.float32),
            "lum_w": lum_w.astype(np.float32)}
    if has_gamma:
        x = np.linspace(0.0, 1.0, 65536)
        data["gcoeffs"] = fit_curves([np.power(x, g) for g in gammas])

    # colour cast (ipbw.cc:318-365)
    cast = list(bwp.color_cast) + [0, 0]
    has_cast = cast[1] > 0
    if has_cast:
        s = (cast[1] / 100.0) ** 3
        hue = cast[0] / 180.0 * np.pi
        filmcurve = DiagonalCurve([4, 0.0, 0.0, 0.35, 0.15, 0.65, 0.85,
                                   1.0, 1.0])
        satcurve = FlatCurve([1, 0, 0, 0.35, 0, 0.5, 1, 0.35, 0.35,
                              1, 0, 0, 0.35], periodic=False)
        xe = cs.srgb_gamma(np.linspace(0.0, 1.0, 65536))
        yv = filmcurve.get_val(xe)
        cv = satcurve.get_val(xe)
        data["ucoeffs"] = fit_curve(s * cv * np.cos(hue) * yv)
        data["vcoeffs"] = fit_curve(s * cv * np.sin(hue) * yv)
    return (has_gamma, has_cast), data


def apply(rgb, data, static):
    has_gamma, has_cast = static
    r, g, b = rgb[0], rgb[1], rgb[2]
    if has_gamma:
        gc = data["gcoeffs"]
        r, g, b = (eval_curve(c, gc[i]) for i, c in enumerate((r, g, b)))
    w = data["weights"]
    bwv = w[0] * r + w[1] * g + w[2] * b
    out = torch.stack([bwv, bwv, bwv])
    if has_cast:
        lw = data["lum_w"]
        y = lw[0] * out[0] + lw[1] * out[1] + lw[2] * out[2]
        du = eval_curve(y, data["ucoeffs"], out_max=MAXVAL)
        dv = eval_curve(y, data["vcoeffs"], out_max=MAXVAL)
        # u = Y - B, v = R - Y: the offsets tint by the luminance
        bb = out[2] - du
        rr = out[0] + dv
        gg = (y - rr * lw[0] - bb * lw[2]) / lw[1]
        out = torch.stack([rr, gg, bb])
    return torch.clamp(out, min=0.0)
