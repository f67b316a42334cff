"""The raw frame model and the host decode dispatch (a copy of
``art_tpu/io/rawfile.py``: ``RawFrame``, ``is_raw_file``, ``load_raw``
and ``_apply_camconst_levels``).

A `RawFrame` carries the decoded CFA plane plus the static sensor and
color metadata the planner reads. :func:`load_raw` decodes a raw file
on the host with the port's build of the native decoder
(:mod:`art_tpu_torch.io.dng`); frames also come from
:func:`art_tpu_torch.core.image.synthesize_bayer`. The reference's
external preconverters (``io/iomanager.py``) are not ported.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from art_tpu_torch.color import colorspaces as cs

RAW_EXTENSIONS = {
    ".dng", ".nef", ".cr2", ".cr3", ".arw", ".raf", ".orf", ".rw2", ".crw",
    ".pef", ".srw", ".x3f", ".3fr", ".fff", ".iiq", ".mos", ".nrw",
    ".mrw", ".kdc", ".dcr", ".sr2", ".srf", ".erf", ".mef", ".raw",
    ".qtk", ".pxn",
}
# the extensions the native decoder reads (rawfile.py::load_raw)
NATIVE_EXTENSIONS = (
    ".dng", ".cr2", ".cr3", ".raf", ".nef", ".arw", ".rw2", ".pef", ".orf",
    ".srw", ".mrw", ".3fr", ".iiq", ".x3f", ".crw", ".dcr", ".kdc", ".qtk",
    ".pxn")


def is_raw_file(path) -> bool:
    return os.path.splitext(str(path))[1].lower() in RAW_EXTENSIONS


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


def synthesize_pixelshift(rgb01, pattern="RGGB", black=512.0, white=16383.0,
                          cam_mul=(2.0, 1.0, 1.5)):
    """Four pixel-shift frames of a linear [0, 1] scene (the Pentax/Sony
    4-frame grid) as one RawFrame and its `extra_frames`: frame k records
    the channel the CFA displaced by `demosaic.pixelshift.OFFSETS[k]`
    selects (art_tpu/io/rawfile.py::synthesize_pixelshift)."""
    from art_tpu_torch.core.image import bayer_color_index
    from art_tpu_torch.demosaic.pixelshift import OFFSETS

    rgb01 = np.asarray(rgb01, dtype=np.float64)
    _, h, w = rgb01.shape
    cam_mul = np.asarray(cam_mul, dtype=np.float64)
    sensor = rgb01 / cam_mul[:, None, None]
    frames = []
    for dy, dx in OFFSETS:
        cidx = np.roll(np.roll(bayer_color_index(pattern, (h, w)), -dy, 0),
                       -dx, 1)
        mosaic = np.take_along_axis(
            sensor.reshape(3, -1), cidx.reshape(1, -1), axis=0
        ).reshape(h, w)
        frames.append(np.clip(mosaic * (white - black) + black, 0, white))
    return RawFrame(
        cfa=frames[0].astype(np.float32),
        pattern=pattern,
        black=np.full(4, float(black)),
        white=np.full(4, float(white)),
        cam_mul=np.array([cam_mul[0], cam_mul[1], cam_mul[2], cam_mul[1]]),
        make="ART-TPU", model="SyntheticPS",
        filename="<synthetic-pixelshift>",
        extra_frames=np.stack(frames[1:]).astype(np.float32),
    )


def load_raw(path) -> RawFrame:
    """Decode a raw file on host with the native decoder (DNG, CR2, NEF,
    classic RAF, ARW, ...), as the reference does; another extension goes
    to a registered external preconverter (``io/iomanager.py``), whose
    DNG decodes through the native path (imgiomanager.cc loadRaw :510)."""
    from art_tpu_torch.io import dng

    ext = os.path.splitext(str(path))[1].lower()
    if ext in NATIVE_EXTENSIONS:
        frame = dng.load_dng(path)
        # RW2 carries per-channel blacks in its tags; the camconst value
        # is an additional pedestal (dcraw merges `black` into cblack)
        _apply_camconst_levels(frame, black_add=(ext == ".rw2"))
        if ext != ".raf":
            try:
                from art_tpu_torch.io.metadata import harvest

                tags, _ = harvest(path)
                frame.exif.update(tags)
            except Exception:
                pass
        return frame
    # external preconverter hook (imgiomanager.cc loadRaw :510); no EXIF
    # harvest, as in the reference
    from art_tpu_torch.io.iomanager import get_instance

    dng_path = get_instance().preconvert_raw(path)
    if dng_path:
        frame = dng.load_dng(dng_path)
        frame.filename = str(path)
        _apply_camconst_levels(frame)
        return frame
    raise NotImplementedError(
        f"raw format {ext} not natively decoded yet; convert to DNG or "
        "register an external preconverter"
    )


def _apply_camconst_levels(frame: RawFrame, black_add=False):
    """Override container levels with camconst per-ISO data when present
    (reference: camconst.cc get_Levels consulted by RawImage::get_*level).
    black_add: treat the camconst black as a pedestal added to the
    container's per-channel blacks (Panasonic RW2 semantics)."""
    try:
        from art_tpu_torch.raw.camconst import get_instance

        cc = get_instance().get(frame.make, frame.model)
    except Exception:
        return
    if cc is None:
        return
    wl = cc.white_levels(int(frame.iso))
    if wl is not None:
        frame.white = np.asarray(wl, dtype=np.float64)
    bl = cc.black_levels(int(frame.iso))
    if bl is not None and np.any(np.asarray(bl) > 0):
        if black_add:
            frame.black = frame.black + np.asarray(bl, dtype=np.float64)
        else:
            frame.black = np.asarray(bl, dtype=np.float64)
    if frame.cam_xyz is None:
        m = cc.dcraw_matrix()
        if m and len(m) >= 9:
            frame.cam_xyz = np.asarray(m[:9], dtype=np.float64).reshape(3, 3)
            if np.abs(frame.cam_xyz).max() > 10:  # dcraw x10000 convention
                frame.cam_xyz = frame.cam_xyz / 10000.0
