"""White balance (counterpart of ``art_tpu/raw/wb.py``): the
temperature model, temp/green <-> multipliers (colortemp.cc), and the
channel multipliers of getImage.

Host numpy, float64, copied from the reference: the CIE 1931 observer
as the reference's analytic fit, a blackbody below 4000 K and the CIE
D series above, summed over 5 nm steps. Auto WB is not ported (its
multipliers come from the raw's statistics, pipeline/autos.py).
"""

from __future__ import annotations

import numpy as np

from art_tpu_torch.color.colorspaces import SRGB_D65_FROM_XYZ
from art_tpu_torch.raw.preprocess import calculate_scale_mul

MINTEMP = 1500.0
MAXTEMP = 60000.0
MINGREEN = 0.02
MAXGREEN = 10.0
INITIALBLACKBODY = 4000.0


# -- CIE 1931 2° observer (analytic fit, Wyman et al. 2013) -----------------

def _gauss(x, alpha, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    t = (x - mu) / s
    return alpha * np.exp(-0.5 * t * t)


def cie_xbar(lam):
    return (_gauss(lam, 1.056, 599.8, 37.9, 31.0)
            + _gauss(lam, 0.362, 442.0, 16.0, 26.7)
            + _gauss(lam, -0.065, 501.1, 20.4, 26.2))


def cie_ybar(lam):
    return (_gauss(lam, 0.821, 568.8, 46.9, 40.5)
            + _gauss(lam, 0.286, 530.9, 16.3, 31.1))


def cie_zbar(lam):
    return (_gauss(lam, 1.217, 437.0, 11.8, 36.0)
            + _gauss(lam, 0.681, 459.0, 26.0, 13.8))


_LAMBDA = np.arange(360.0, 830.1, 5.0)
_CMF = np.stack([cie_xbar(_LAMBDA), cie_ybar(_LAMBDA), cie_zbar(_LAMBDA)])


def _blackbody_spect(lam_nm, temp):
    lm = lam_nm * 1e-9
    c1 = 3.7417717e-16
    c2 = 1.438786e-2
    return (c1 / (lm ** 5)) / (np.exp(c2 / (lm * temp)) - 1.0)


# CIE daylight components S0/S1/S2, 10nm 300-830nm (standard table)
_S0 = np.array([
    0.04, 3.02, 6.00, 17.80, 29.60, 42.45, 55.30, 56.30, 57.30, 59.55,
    61.80, 61.65, 61.50, 65.15, 68.80, 66.10, 63.40, 64.60, 65.80, 80.30,
    94.80, 99.80, 104.80, 105.35, 105.90, 101.35, 96.80, 105.35, 113.90,
    119.75, 125.60, 125.55, 125.50, 123.40, 121.30, 121.30, 121.30, 117.40,
    113.50, 113.30, 113.10, 111.95, 110.80, 108.65, 106.50, 107.65, 108.80,
    107.05, 105.30, 104.85, 104.40, 102.20, 100.00, 98.00, 96.00, 95.55,
    95.10, 92.10, 89.10, 89.80, 90.50, 90.40, 90.30, 89.35, 88.40, 86.20,
    84.00, 84.55, 85.10, 83.50, 81.90, 82.25, 82.60, 83.75, 84.90, 83.10,
    81.30, 76.60, 71.90, 73.10, 74.30, 75.35, 76.40, 69.85, 63.30, 67.50,
    71.70, 74.35, 77.00, 71.10, 65.20, 56.45, 47.70, 58.15, 68.60, 66.80,
    65.00, 65.50, 66.00, 63.50, 61.00, 57.15, 53.30, 56.10, 58.90, 60.40,
    61.90,
])
_S1 = np.array([
    0.02, 2.26, 4.50, 13.45, 22.40, 32.20, 42.00, 41.30, 40.60, 41.10,
    41.60, 39.80, 38.00, 40.20, 42.40, 40.45, 38.50, 36.75, 35.00, 39.20,
    43.40, 44.85, 46.30, 45.10, 43.90, 40.50, 37.10, 36.90, 36.70, 36.30,
    35.90, 34.25, 32.60, 30.25, 27.90, 26.10, 24.30, 22.20, 20.10, 18.15,
    16.20, 14.70, 13.20, 10.90, 8.60, 7.35, 6.10, 5.15, 4.20, 3.05, 1.90,
    0.95, 0.00, -0.80, -1.60, -2.55, -3.50, -3.50, -3.50, -4.65, -5.80,
    -6.50, -7.20, -7.90, -8.60, -9.05, -9.50, -10.20, -10.90, -10.80,
    -10.70, -11.35, -12.00, -13.00, -14.00, -13.80, -13.60, -12.80, -12.00,
    -12.65, -13.30, -13.10, -12.90, -11.75, -10.60, -11.10, -11.60, -11.90,
    -12.20, -11.20, -10.20, -9.00, -7.80, -9.50, -11.20, -10.80, -10.40,
    -10.50, -10.60, -10.15, -9.70, -9.00, -8.30, -8.80, -9.30, -9.55, -9.80,
])
_S2 = np.array([
    0.00, 1.00, 2.00, 3.00, 4.00, 6.25, 8.50, 8.15, 7.80, 7.25, 6.70, 6.00,
    5.30, 5.70, 6.10, 4.55, 3.00, 2.10, 1.20, 0.05, -1.10, -0.80, -0.50,
    -0.60, -0.70, -0.95, -1.20, -1.90, -2.60, -2.75, -2.90, -2.85, -2.80,
    -2.70, -2.60, -2.60, -2.60, -2.20, -1.80, -1.65, -1.50, -1.40, -1.30,
    -1.25, -1.20, -1.10, -1.00, -0.75, -0.50, -0.40, -0.30, -0.15, 0.00,
    0.10, 0.20, 0.35, 0.50, 1.30, 2.10, 2.65, 3.20, 3.65, 4.10, 4.40, 4.70,
    4.90, 5.10, 5.90, 6.70, 7.00, 7.30, 7.95, 8.60, 9.20, 9.80, 10.00,
    10.20, 9.25, 8.30, 8.95, 9.60, 9.05, 8.50, 7.75, 7.00, 7.30, 7.60,
    7.80, 8.00, 7.35, 6.70, 5.95, 5.20, 6.30, 7.40, 7.10, 6.80, 6.90, 7.00,
    6.70, 6.40, 5.95, 5.50, 5.80, 6.10, 6.30, 6.50,
])
_S_LAMBDA = np.arange(300.0, 830.1, 5.0)


def _daylight_spect(lam, m1, m2):
    s0 = np.interp(lam, _S_LAMBDA, _S0)
    s1 = np.interp(lam, _S_LAMBDA, _S1)
    s2 = np.interp(lam, _S_LAMBDA, _S2)
    return s0 + m1 * s1 + m2 * s2


def temp2mulxyz(temp):
    """White point (X/Y, Z/Y) for a correlated color temperature.

    Mirrors colortemp.cc:164-199: blackbody below 4000K, CIE D-series above.
    """
    temp = float(np.clip(temp, MINTEMP, MAXTEMP))
    if temp <= INITIALBLACKBODY:
        spd = _blackbody_spect(_LAMBDA, temp)
    else:
        t = temp
        if t <= 7000:
            x_d = -4.6070e9 / t**3 + 2.9678e6 / t**2 + 0.09911e3 / t + 0.244063
        elif t <= 25000:
            x_d = -2.0064e9 / t**3 + 1.9018e6 / t**2 + 0.24748e3 / t + 0.237040
        else:
            x_d = (-2.0064e9 / t**3 + 1.9018e6 / t**2 + 0.24748e3 / t
                   + 0.237040 - ((t - 25000) / 25000) * 0.025)
        y_d = -3.0 * x_d * x_d + 2.87 * x_d - 0.275
        interm = 0.0241 + 0.2562 * x_d - 0.734 * y_d
        m1 = (-1.3515 - 1.7703 * x_d + 5.9114 * y_d) / interm
        m2 = (0.03 - 31.4424 * x_d + 30.0717 * y_d) / interm
        spd = _daylight_spect(_LAMBDA, m1, m2)
    X, Y, Z = (_CMF * spd).sum(axis=1)
    s = X + Y + Z
    x, y = X / s, Y / s
    return x / y, (1.0 - x - y) / y


def temp2mul(temp, green, equal=1.0):
    """Temp/green -> sRGB-space multipliers, green-normalized.

    Mirrors colortemp.cc:294-326 including the `equal` empirical red/blue
    adjustment.
    """
    green = float(np.clip(green, MINGREEN, MAXGREEN))
    xwb, zwb = temp2mulxyz(temp)
    adj = 1.0
    if equal < 0.9999 or equal > 1.0001:
        adj = (100.0 + (1000.0 - 1000.0 * equal) / 20.0) / 100.0
    m = SRGB_D65_FROM_XYZ
    rmul = max(m[0][0] * xwb * adj + m[0][1] + m[0][2] * zwb / adj, 1e-5)
    gmul = max(m[1][0] * xwb + m[1][1] + m[1][2] * zwb, 1e-5)
    bmul = max(m[2][0] * xwb * adj + m[2][1] + m[2][2] * zwb / adj, 1e-5)
    gmul /= green
    mx = max(rmul, gmul, bmul)
    rmul, gmul, bmul = rmul / mx, gmul / mx, bmul / mx
    return np.array([rmul / gmul, 1.0, bmul / gmul])


def mul2temp(rmul, gmul, bmul, equal=1.0):
    """Multipliers -> (temp, green) by bisection (colortemp.cc:271-292)."""
    mintemp, maxtemp = MINTEMP, MAXTEMP
    temp = (mintemp + maxtemp) / 2
    tmp = np.ones(3)
    while maxtemp - mintemp > 1:
        tmp = temp2mul(temp, 1.0, equal)
        if tmp[2] / tmp[0] > bmul / rmul:
            maxtemp = temp
        else:
            mintemp = temp
        temp = (mintemp + maxtemp) / 2
    green = (tmp[1] / tmp[0]) / (gmul / rmul)
    return temp, float(np.clip(green, MINGREEN, MAXGREEN))



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
