"""PDAF lines filter (counterpart of ``art_tpu/raw/pdaf.py``; reference:
pdaflinesfilter.cc).

On-sensor phase-detect rows read slightly low on green, leaving
horizontal banding; the rows repeat with a camera-specific pattern and
offset (camconst.json pdaf_pattern/pdaf_offset). A host row mask marks
them (`pdaf_row_mask`); on the device each marked row's green sites are
rescaled by the ratio of a smoothed green profile of the rows 2 above
and below to the row's own, clipped to [0.95, 1.05]. Plain PyTorch; the
row profiles difference float32 running sums, as the reference's do,
accumulated alike on every device (`core/fmath.py::cumsum32`).
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.core.fmath import cumsum32


def pdaf_row_mask(pattern_rows, offset, height):
    """Boolean (H,) host mask: row is PDAF when
    (row - offset) % pattern[-1] is in the pattern
    (pdaflinesfilter.cc:145)."""
    period = max(int(pattern_rows[-1]), 1)
    keys = set(int(v) % period for v in pattern_rows)
    rows = (np.arange(height) - int(offset)) % period
    return np.isin(rows, sorted(keys))


def _smooth_rows(x, r=8):
    """Horizontal box mean per row over 2r+1 samples, edge-clamped."""
    h, w = x.shape
    c = cumsum32(x, 1)
    c = torch.cat([torch.zeros((h, 1), dtype=x.dtype, device=x.device), c],
                  dim=1)
    i = torch.arange(w, device=x.device)
    hi = torch.clamp(i + r + 1, 0, w)
    lo = torch.clamp(i - r, 0, w)
    s = c.index_select(1, hi) - c.index_select(1, lo)
    return s / (hi - lo).to(x.dtype)


def pdaf_filter(cfa, green_mask, row_mask):
    """Correct marked rows' green sites toward their +-2 row neighbours;
    row_mask: (H,) float, 1 on a PDAF row."""
    g = torch.where(green_mask, cfa, torch.zeros_like(cfa))
    gm = green_mask.to(cfa.dtype)
    up = torch.roll(g, 2, dims=0)
    dn = torch.roll(g, -2, dims=0)
    upm = torch.roll(gm, 2, dims=0)
    dnm = torch.roll(gm, -2, dims=0)
    neigh = _smooth_rows(up + dn) / torch.clamp(_smooth_rows(upm + dnm),
                                                min=1e-6)
    own = _smooth_rows(g) / torch.clamp(_smooth_rows(gm), min=1e-6)
    ratio = torch.clamp(neigh / torch.clamp(own, min=1e-6), 0.95, 1.05)
    rm = row_mask.to(cfa.dtype)[:, None]
    corr = 1.0 + (ratio - 1.0) * rm
    return torch.where(green_mask, cfa * corr, cfa)
