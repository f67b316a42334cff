"""Film negative (counterpart of ``art_tpu/ops/filmneg.py``;
filmnegativeproc.cc doProcess:223).

out_c = min(mult_c * in_c^exp_c, MAXVAL), the exponents -(greenExp *
ratio_c), the multipliers such that the reference input colour maps to
the reference output colour. With no reference input (its green <= 0)
the input is the channel medians of the frame's middle 60% each way,
every 4th pixel, the median of an even count the mean of its two middle
values as numpy's (and the reference's) is; with no reference output it
is MAXVAL / 24. Plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

MAXVAL = 65535.0


def plan(pp, ctx):
    fn = pp.film_negative
    if not fn.enabled:
        return None
    gexp = float(fn.green_exp)
    exps = np.array([-(gexp * float(fn.red_ratio)), -gexp,
                     -(gexp * float(fn.blue_ratio))], dtype=np.float32)
    ref_in = np.asarray(list(fn.ref_input) + [0.0] * 3, dtype=np.float32)[:3]
    ref_out = np.asarray(list(fn.ref_output) + [0.0] * 3,
                         dtype=np.float32)[:3]
    auto_in = bool(ref_in[1] <= 0.0)
    if ref_out[1] <= 0.0:
        ref_out = np.full(3, MAXVAL / 24.0, dtype=np.float32)
    return (auto_in,), {"exps": exps, "ref_in": ref_in, "ref_out": ref_out}


def median(x):
    """Medians of the rows of a (C, N) tensor, numpy's: the middle value
    of a sorted row, or the mean of the two middle values of an even
    count (torch.median returns the lower one)."""
    s, _ = torch.sort(x, dim=1)
    n = x.shape[1]
    if n % 2:
        return s[:, n // 2]
    return (s[:, n // 2 - 1] + s[:, n // 2]) * 0.5


def apply(rgb, data, static):
    (auto_in,) = static
    exps = data["exps"][:, None, None]
    if auto_in:
        c, h, w = rgb.shape
        y0, y1 = int(h * 0.2), int(h * 0.8)
        x0, x1 = int(w * 0.2), int(w * 0.8)
        ref_in = median(rgb[:, y0:y1:4, x0:x1:4].reshape(c, -1))
    else:
        ref_in = data["ref_in"]
    mult = data["ref_out"] / torch.clamp(ref_in, min=1.0) ** data["exps"]
    out = mult[:, None, None] * torch.clamp(rgb, min=0.0) ** exps
    return torch.clamp(out, 0.0, MAXVAL)
