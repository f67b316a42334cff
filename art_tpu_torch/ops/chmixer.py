"""Channel mixer (counterpart of ``art_tpu/ops/chmixer.py``;
ipchmixer.cc).

Two modes: RGB_MATRIX (3x3 / 1000) and PRIMARIES_CHROMA (the primaries'
hue and saturation tweaked in xy chromaticity). Both reduce to a 3x3
matrix on the host; the device applies one multiply-add and clips at 0.
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.core.fmath import mat3

_D65_xy = (0.3127, 0.3290)


def _mixer_matrix_primaries(hue_tweak, sat_tweak, working_profile):
    """get_mixer_matrix (ipchmixer.cc:44-148)."""
    ws = cs.MATRICES_RGB_TO_XYZ[working_profile]
    white = np.array([_D65_xy[0], _D65_xy[1], 1 - _D65_xy[0] - _D65_xy[1]])

    def rgb2xy(rgb):
        xyz = ws @ rgb
        s = xyz.sum()
        if s == 0:
            return white.copy()
        x, y = xyz[0] / s, xyz[1] / s
        return np.array([x, y, 1 - x - y])

    def get_matrix(rxy, gxy, bxy, w):
        m = np.stack([rxy, gxy, bxy], axis=1)
        kr = np.linalg.inv(m) @ w
        return m @ np.diag(kr)

    rxy = rgb2xy(np.array([1.0, 0, 0]))
    gxy = rgb2xy(np.array([0, 1.0, 0]))
    bxy = rgb2xy(np.array([0, 0, 1.0]))
    M = get_matrix(rxy, gxy, bxy, white)

    def tweak(c, hue, sat, hrange, srange):
        x, y = c[0], c[1]
        dx, dy = x - _D65_xy[0], y - _D65_xy[1]
        radius = np.hypot(dx, dy)
        angle = np.degrees(np.arctan2(dy, dx))
        dh = hue / 100.0 * 360.0 * hrange
        ds = 1.0 + sat / 100.0 * srange
        radius *= ds
        angle += dh
        nx = _D65_xy[0] + radius * np.cos(np.radians(angle))
        ny = _D65_xy[1] + radius * np.sin(np.radians(angle))
        return np.array([nx, ny, 1 - nx - ny])

    N = get_matrix(
        tweak(rxy, hue_tweak[0], sat_tweak[0], 0.075, 0.3),
        tweak(gxy, hue_tweak[1], sat_tweak[1], 0.1, 0.5),
        tweak(bxy, hue_tweak[2], sat_tweak[2], 0.075, 0.5),
        white)
    try:
        Minv = np.linalg.inv(M)
    except np.linalg.LinAlgError:
        return np.eye(3)
    return N @ Minv


def plan(pp, ctx):
    cm = pp.chmixer
    if not cm.enabled:
        return None
    if cm.mode == 1 or cm.mode == "PRIMARIES_CHROMA":
        mat = _mixer_matrix_primaries(cm.hue_tweak, cm.sat_tweak,
                                      ctx["working_profile"])
    else:
        mat = np.array([cm.red, cm.green, cm.blue], dtype=np.float64) / 1000.0
    if np.allclose(mat, np.eye(3)):
        return None
    return (), {"matrix": mat.astype(np.float32)}


def apply(rgb, data, static):
    return torch.clamp(mat3(data["matrix"], rgb), min=0.0)
