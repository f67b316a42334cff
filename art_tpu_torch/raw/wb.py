"""White-balance channel multipliers (counterpart of ``art_tpu/raw/wb.py``).

Host numpy. Only what the camera and `CustomMult` white balances and
highlight recovery need: the temperature model (`Custom`) and auto WB
are not ported yet.
"""

from __future__ import annotations

import numpy as np

from art_tpu_torch.raw.preprocess import calculate_scale_mul


def image_multipliers(frame, wb_mults_rgb, scale_mul, c_white, cblack,
                      raw_expos=1.0, is_mono=False):
    """getImage's rm/gm/bm for the demosaiced planes, times the baseline
    exposure gain (art_tpu/raw/wb.py::image_multipliers)."""
    rgb_cam, cam_rgb, _ = frame.color_matrices()
    pm = frame.pre_mul()

    v = rgb_cam @ (pm[:3] / 1.0)
    r, g, b = v[0] / v[1], 1.0, v[2] / v[1]
    rm, gm, bm = cam_rgb @ np.array([r, g, b])
    new_pre_mul = np.array([pm[0] / rm, pm[1] / gm, pm[2] / bm, pm[3] / gm])
    new_scale_mul, gain = calculate_scale_mul(
        new_pre_mul, c_white, cblack, is_mono)
    rm = new_scale_mul[0] / scale_mul[0] * gain
    gm = new_scale_mul[1] / scale_mul[1] * gain
    bm = new_scale_mul[2] / scale_mul[2] * gain

    if wb_mults_rgb is not None:
        cam_v = cam_rgb @ np.asarray(wb_mults_rgb, dtype=np.float64)
        wr = pm[0] / cam_v[0]
        wg = pm[1] / cam_v[1]
        wbv = pm[2] / cam_v[2]
        wr, wbv, wg = wr / wg, wbv / wg, 1.0
        if wr > 0 and wbv > 0:
            rm, gm, bm = rm * wr, gm * wg, bm * wbv

    expcomp = 2.0 ** frame.baseline_exposure
    return np.array([rm, gm, bm]) * expcomp, gain


def wb_camera_multipliers(frame, wb_mults_rgb):
    """wbMul2Camera (art_tpu/raw/wb.py::wb_camera_multipliers,
    rawimagesource.cc:4708): the chosen white balance's RGB multipliers
    as camera-space per-channel multipliers, green-normalised."""
    _, cam_rgb, _ = frame.color_matrices()
    pm = frame.pre_mul()
    cam_v = cam_rgb @ np.asarray(wb_mults_rgb, dtype=np.float64)
    w = pm[:3] / np.maximum(cam_v, 1e-9)
    return np.array([w[0] / w[1], 1.0, w[2] / w[1]])
