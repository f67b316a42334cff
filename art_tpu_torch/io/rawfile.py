"""The raw frame model (a copy of ``RawFrame`` from
``art_tpu/io/rawfile.py`` with the helpers it calls).

A `RawFrame` carries the decoded CFA plane plus the static sensor and
color metadata the planner reads. Decoding raw files is host code that
the port does not copy; frames come from a decoder or from
:func:`art_tpu_torch.core.image.synthesize_bayer`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from art_tpu_torch.color import colorspaces as cs


@dataclasses.dataclass
class RawFrame:
    """Decoded raw frame: CFA plane + static sensor/color metadata."""

    cfa: np.ndarray  # (H, W) raw ADU values, black NOT subtracted;
    # float32, or uint16 when `integral` (native-decoded counts)
    pattern: str | None = "RGGB"  # Bayer 2x2; None for non-mosaic (RGB/mono)
    xtrans: tuple | None = None  # 6x6 nested tuple of 0/1/2 when X-Trans
    black: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4, np.float64))  # per c4 (R,G1,B,G2)
    white: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(4, 65535.0))
    cam_mul: np.ndarray | None = None  # as-shot WB multipliers (camera RGBG)
    cam_xyz: np.ndarray | None = None  # (3,3) XYZ(D65) -> camera matrix
    iso: float = 100.0
    baseline_exposure: float = 0.0  # EV (DNG BaselineExposure)
    make: str = ""
    model: str = ""
    exif: dict = dataclasses.field(default_factory=dict)
    filename: str = ""
    # non-raw passthrough: (3,H,W) float32 0..65535 already-demosaiced data
    rgb: np.ndarray | None = None
    # pixel-shift: the 3 additional frames (3,H,W), same ADU domain as cfa
    extra_frames: np.ndarray | None = None
    # cfa values are u16-exact (decoded from integer counts): the device
    # transfer may narrow to uint16 (develop.transfer_array)
    integral: bool = False

    @property
    def is_raw(self):
        return self.rgb is None

    @property
    def shape(self):
        return self.cfa.shape if self.rgb is None else self.rgb.shape[1:]

    def color_matrices(self):
        """Return (rgb_cam, cam_rgb, pre_mul_d65), as dcraw's
        ``cam_xyz_coeff``: rows of cam_xyz @ xyz_srgb are normalized so
        camera white maps to 1 per channel; the row norms give the D65
        pre-multiplier estimate; rgb_cam is the pseudo-inverse."""
        if self.cam_xyz is None:
            eye = np.eye(3)
            return eye, eye, np.ones(3)
        cam_rgb = self.cam_xyz @ cs.XYZ_FROM_SRGB_D65
        sums = cam_rgb.sum(axis=1, keepdims=True)
        sums[sums == 0] = 1.0
        cam_rgb = cam_rgb / sums
        pre_mul = 1.0 / sums[:, 0]
        rgb_cam = np.linalg.pinv(cam_rgb)
        return rgb_cam, cam_rgb, pre_mul

    def pre_mul(self):
        """Pre-multipliers: as-shot cam_mul if valid, else the
        matrix-derived D65 estimate (dcraw scale_colors semantics)."""
        if self.cam_mul is not None and np.all(np.asarray(self.cam_mul)[:3] > 0):
            m = np.asarray(self.cam_mul, dtype=np.float64)
            out = np.ones(4)
            out[: min(4, m.size)] = m[:4]
            if m.size < 4 or out[3] == 0:
                out[3] = out[1]
            return out
        _, _, pm = self.color_matrices()
        return np.array([pm[0], pm[1], pm[2], pm[1]])

    def camera_wb_mults(self):
        """As-shot ("Camera") WB in the ColorTemp multiplier convention:
        rgb_cam @ (1,1,1), normalized to green (rawimagesource.cc:1376)."""
        rgb_cam, _, _ = self.color_matrices()
        v = rgb_cam @ np.ones(3)
        if v[1] <= 0:
            return np.ones(3)
        return np.array([v[0] / v[1], 1.0, v[2] / v[1]])
