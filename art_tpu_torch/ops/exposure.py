"""Exposure compensation (counterpart of ``art_tpu/ops/exposure.py``;
ipexposure.cc:29-75).

``v = max(v * 2^expcomp - black*2000, 0)`` per channel. Highlight
reconstruction lives in the raw stage (refused there by the planner).
"""

from __future__ import annotations

import numpy as np
import torch


def plan(pp, ctx):
    e = pp.exposure
    if not e.enabled or (e.expcomp == 0 and e.black == 0):
        return None
    data = {
        "scale": np.float32(2.0 ** e.expcomp),
        "black": np.float32(e.black * 2000.0),
    }
    return (), data


def apply(rgb, data, static):
    return torch.clamp(rgb * data["scale"] - data["black"], min=0.0)
