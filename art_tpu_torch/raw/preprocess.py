"""Black subtraction and channel scaling (counterpart of
``art_tpu/raw/preprocess.py``).

The host plan is a numpy copy of the reference's. On the device the
periodic level pattern is applied by plain row indexing; the reference's
row-parity selects exist only for the TPU's layout.
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.settings import PAD_MULTIPLE
from art_tpu_torch.core.image import (MAXVAL, bayer_color_index,
                                     xtrans_color_index)


def calculate_scale_mul(pre_mul4, c_white, c_black, is_mono=False):
    """scale_mul[c] = (pre_mul[c]/max(pre_mul)) * 65535/(white[c]-black[c])
    and gain = max/min (art_tpu/raw/preprocess.py::calculate_scale_mul)."""
    pre_mul4 = np.asarray(pre_mul4, dtype=np.float64).copy()
    c_white = np.asarray(c_white, dtype=np.float64)
    c_black = np.asarray(c_black, dtype=np.float64)
    if is_mono:
        scale = MAXVAL / (c_white - c_black)
    else:
        maxpremul = pre_mul4.max()
        scale = (pre_mul4 / maxpremul) * MAXVAL / (c_white - c_black)
    gain = scale.max() / scale.min()
    return scale, gain


def scale_plan(frame, bayer_black_adjust=None, raw_expos=1.0, is_mono=False,
               wb_mults_rgb=None):
    """Per-site black/scale row patterns for a Bayer or X-Trans frame,
    plus scale_mul, gain, clmax, cblack and c_white
    (art_tpu/raw/preprocess.py::scale_plan). The row period is 8 for
    Bayer and lcm(6, 8) = 24 for X-Trans, on the global coordinates."""
    if frame.pattern is None and frame.xtrans is None:
        raise NotImplementedError(
            "scale_plan: a monochrome raw with no CFA is not ported to "
            "art_tpu_torch (a Foveon frame takes scale_plan_foveon)")
    h, w = frame.cfa.shape
    cblack = np.asarray(frame.black, dtype=np.float64).copy()
    if bayer_black_adjust is not None:
        cblack = np.maximum(cblack + np.asarray(bayer_black_adjust), 0.0)
    c_white = np.asarray(frame.white, dtype=np.float64)
    c_white = (c_white - cblack) / raw_expos + cblack
    pre_mul4 = frame.pre_mul()
    if wb_mults_rgb is not None:
        w4 = np.array([wb_mults_rgb[0], wb_mults_rgb[1], wb_mults_rgb[2],
                       wb_mults_rgb[1]], dtype=np.float64)
        pre_mul4 = pre_mul4 / w4
    scale_mul, gain = calculate_scale_mul(pre_mul4, c_white, cblack, is_mono)
    clmax = (c_white - cblack) * scale_mul

    if frame.pattern is not None:
        cidx = bayer_color_index(frame.pattern, (2, 2))
        c4 = cidx.astype(np.int64).copy()
        # dcraw c4: G on even rows is G2 (index 3)
        g2 = (cidx == 1) & (np.arange(2)[:, None] % 2 == 0)
        c4[g2] = 3
    else:
        c4 = xtrans_color_index(frame.xtrans, (6, 6)).astype(np.int64)
    offset_tile = cblack[c4].astype(np.float32)
    scale_tile = scale_mul[c4].astype(np.float32)
    # full-width row patterns, 8 rows high: the reference's data layout
    wpad = -(-w // PAD_MULTIPLE) * PAD_MULTIPLE
    th, tw = offset_tile.shape
    reps = -(-wpad // tw)
    offset_rows = np.tile(offset_tile, (1, reps))[:, :wpad]
    scale_rows = np.tile(scale_tile, (1, reps))[:, :wpad]
    vreps = int(np.lcm(th, 8)) // th
    return {
        "offset_tile": np.tile(offset_rows, (vreps, 1)),
        "scale_tile": np.tile(scale_rows, (vreps, 1)),
        "scale_mul": scale_mul,
        "gain": gain,
        "clmax": clmax[:3],
        "cblack": cblack,
        "c_white": c_white,
    }


def scale_plan_foveon(frame, raw_expos=1.0, wb_mults_rgb=None):
    """scaleColors for a 3-plane Foveon frame: a (black, scale) per
    channel as (3, 1, 1) planes over the (3, H, W) stack, plus scale_mul,
    gain, clmax, cblack and c_white
    (art_tpu/raw/preprocess.py::scale_plan_foveon)."""
    cblack = np.asarray(frame.black, dtype=np.float64).copy()
    c_white = np.asarray(frame.white, dtype=np.float64)
    c_white = (c_white - cblack) / raw_expos + cblack
    pre_mul4 = frame.pre_mul()
    if wb_mults_rgb is not None:
        w4 = np.array([wb_mults_rgb[0], wb_mults_rgb[1], wb_mults_rgb[2],
                       wb_mults_rgb[1]], dtype=np.float64)
        pre_mul4 = pre_mul4 / w4
    scale_mul, gain = calculate_scale_mul(pre_mul4, c_white, cblack)
    clmax = (c_white - cblack) * scale_mul
    return {
        "offset3": cblack[:3].astype(np.float32).reshape(3, 1, 1),
        "scale3": scale_mul[:3].astype(np.float32).reshape(3, 1, 1),
        "scale_mul": scale_mul,
        "gain": gain,
        "clmax": clmax[:3],
        "cblack": cblack,
        "c_white": c_white,
    }


def apply_scale(cfa, offset_tile, scale_tile):
    """(raw - black) * scale with the (period, W) level rows repeated down
    the mosaic; all tensors on one device."""
    rows = torch.arange(cfa.shape[0], device=cfa.device) % offset_tile.shape[0]
    return torch.clamp(cfa - offset_tile[rows], min=0.0) * scale_tile[rows]
