"""DNG -> RawFrame (a copy of ``art_tpu/io/dng.py``): host decode via the
port's build of the native artraw library.

Reference equivalents: dcraw's DNG path + ``RawImage::loadRaw``
(rtengine/rawimage.cc:1148). Level/matrix semantics follow the DNG spec:
AsShotNeutral is the camera-space color of the illuminant (gains are its
reciprocal); ColorMatrix2 (D65) is preferred for the XYZ->camera matrix as
dcraw does.
"""

from __future__ import annotations

import numpy as np

from art_tpu_torch.io.native_binding import decode_dng_bytes
from art_tpu_torch.io.rawfile import RawFrame

_CODE_TO_COLOR = {0: "R", 1: "G", 2: "B"}


def load_dng(path) -> RawFrame:
    with open(path, "rb") as f:
        data = f.read()
    img, meta = decode_dng_bytes(data)

    cfa = meta["cfa_pattern"]
    pattern = None
    xtrans = meta.get("xtrans")
    if xtrans is None and all(c in _CODE_TO_COLOR for c in cfa):
        pattern = "".join(_CODE_TO_COLOR[c] for c in cfa)

    # crop to ActiveArea when present (top, left, bottom, right); an odd
    # origin shifts the CFA phase (dcraw adjusts `filters` the same way)
    aa = meta["active_area"]
    if aa[0] >= 0 and aa[2] > aa[0] and aa[3] > aa[1]:
        img = img[aa[0] : aa[2], aa[1] : aa[3]]
        if pattern is not None and (aa[0] % 2 or aa[1] % 2):
            dy, dx = aa[0] % 2, aa[1] % 2
            p = [[pattern[0], pattern[1]], [pattern[2], pattern[3]]]
            pattern = (p[dy][dx] + p[dy][1 - dx]
                       + p[1 - dy][dx] + p[1 - dy][1 - dx])

    # DNG levels are in CFA-pattern order; RawFrame wants c4 (R,G1,B,G2)
    black4 = _pattern_to_c4(meta["black"], pattern)
    white4 = _pattern_to_c4(meta["white"], pattern)

    asn = meta["as_shot_neutral"]
    cam_mul = None
    if np.all(asn[:3] > 0):
        g = asn[1]
        cam_mul = np.array([g / max(asn[0], 1e-9) * 1.0, 1.0,
                            g / max(asn[2], 1e-9)])
        cam_mul = np.array([1.0 / asn[0], 1.0 / asn[1], 1.0 / asn[2]])
        cam_mul = cam_mul / cam_mul[1]
        cam_mul = np.array([cam_mul[0], cam_mul[1], cam_mul[2],
                            cam_mul[1]])

    cam_xyz = meta["color_matrix2"]
    if cam_xyz is None:
        cam_xyz = meta["color_matrix1"]

    return RawFrame(
        # keep the decoder's uint16 counts: the host-side f32 widen
        # (~0.25s/24MP) is pure waste — every consumer converts on use
        # and the device program widens after the u16 H2D upload
        cfa=img,
        integral=True,
        pattern=pattern,
        xtrans=xtrans,
        black=np.asarray(black4, dtype=np.float64),
        white=np.asarray(white4, dtype=np.float64),
        cam_mul=cam_mul,
        cam_xyz=cam_xyz,
        iso=meta["iso"],
        baseline_exposure=meta["baseline_exposure"],
        make=meta["make"],
        model=meta["model"],
        exif={"orientation": meta["orientation"]},
        filename=str(path),
    )


def _pattern_to_c4(levels, pattern):
    """Map per-CFA-position levels to c4 order (R, G1, B, G2)."""
    levels = np.asarray(levels, dtype=np.float64)
    if pattern is None or len(levels) < 4:
        v = float(levels[0]) if levels.size else 0.0
        return np.full(4, v)
    out = np.zeros(4)
    seen_g = 0
    for i, c in enumerate(pattern):
        if c == "R":
            out[0] = levels[i]
        elif c == "B":
            out[2] = levels[i]
        else:
            out[1 if seen_g == 0 else 3] = levels[i]
            seen_g += 1
    if seen_g == 1:
        out[3] = out[1]
    return out
