"""Histogram, waveform and vectorscope data (counterpart of
``art_tpu/pipeline/scopes.py``; improccoordinator.cc
updateLRGBHistograms/updateVectorscope/updateWaveforms :560-660, the
listener surface rtengine.h:272-330).

A headless API over any (3, H, W) image in the 0..MAXVAL domain, host
numpy as in the reference: `process_image` feeds `histogram_rgbl` to a
PipelineListener that wants a histogram.
"""

from __future__ import annotations

import numpy as np

from art_tpu_torch.core.image import MAXVAL, bayer_color_index


def histogram_rgbl(rgb, bins=256):
    """Per-channel and luminance histograms: a dict of (bins,) int64
    counts r, g, b and l (Rec709 luma of the working-space RGB)."""
    x = np.asarray(rgb)
    out = {}
    edges = np.linspace(0.0, MAXVAL, bins + 1)
    for name, plane in (("r", x[0]), ("g", x[1]), ("b", x[2])):
        out[name], _ = np.histogram(plane, bins=edges)
    luma = 0.2126 * x[0] + 0.7152 * x[1] + 0.0722 * x[2]
    out["l"], _ = np.histogram(luma, bins=edges)
    return out


def waveform(rgb, bins=256, max_cols=512):
    """Per-column intensity distribution: (3, bins, n_cols) counts, the
    columns subsampled to at most about max_cols."""
    x = np.asarray(rgb)
    _, h, w = x.shape
    step = max(w // max_cols, 1)
    cols = x[:, :, ::step]
    n_cols = cols.shape[2]
    q = np.clip((cols / MAXVAL * (bins - 1)).astype(np.int64), 0, bins - 1)
    out = np.zeros((3, bins, n_cols), dtype=np.int64)
    col_idx = np.broadcast_to(np.arange(n_cols)[None, :], q.shape[1:])
    for c in range(3):
        np.add.at(out[c], (q[c].ravel(), col_idx.ravel()), 1)
    return out


def vectorscope(rgb, size=128):
    """CbCr chromaticity density, a (size, size) grid of counts."""
    x = np.asarray(rgb) / MAXVAL
    y = 0.2126 * x[0] + 0.7152 * x[1] + 0.0722 * x[2]
    cb = (x[2] - y) * 0.5389
    cr = (x[0] - y) * 0.6350
    qi = np.clip(((cr + 0.5) * (size - 1)).astype(np.int64), 0, size - 1)
    qj = np.clip(((cb + 0.5) * (size - 1)).astype(np.int64), 0, size - 1)
    out = np.zeros((size, size), dtype=np.int64)
    np.add.at(out, (qi.ravel(), qj.ravel()), 1)
    return out


def raw_histogram(cfa, pattern, bins=256, black=0.0, white=65535.0):
    """Per-CFA-channel raw histograms (RawImageSource::getRAWHistogram):
    r, g and b counts, or g alone for a frame with no Bayer pattern."""
    x = np.asarray(cfa)
    edges = np.linspace(float(black), float(white), bins + 1)
    out = {}
    if pattern is None:
        out["g"], _ = np.histogram(x, bins=edges)
        return out
    cidx = bayer_color_index(pattern, x.shape)
    for c, name in enumerate("rgb"):
        out[name], _ = np.histogram(x[cidx == c], bins=edges)
    return out
