"""The soft-proof gamut warning (counterpart of
``art_tpu/color/gamutwarning.py``; rtengine/gamutwarning.cc).

Each pixel of the developed image goes from the output profile's
encoding to XYZ, into the proof profile's RGB, clamped to [0, 1], and
back to ACES AP0; a pixel whose round trip moved more than 1e-4 there
(GamutWarning::markLine, gamutwarning.cc:79-120, the matrix-shaper
branch) is painted cyan (0, 1, 1). Profiles are named colorspaces or
matrix .icc files; a LUT-class proof or output profile raises
ValueError, as in the reference. In torch, on the image's device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.iccstore import output_trc
from art_tpu_torch.core.fmath import mat3

_DELTA_MATRIX = 1e-4


def _resolve_profile(name_or_path):
    """A named colorspace (a "-linear" one with the linear TRC) or a
    matrix .icc path -> (rgb_to_xyz float32, TRC)."""
    if (isinstance(name_or_path, str)
            and name_or_path.lower().endswith((".icc", ".icm"))
            and os.path.isfile(name_or_path)):
        from art_tpu_torch.color.iccfile import load_icc

        prof = load_icc(name_or_path)
        if prof.get("kind") == "lut":
            raise ValueError("LUT-class proof profiles need the Lab "
                             "branch (gamut_warning_mask_lab)")
        return np.asarray(prof["rgb_to_xyz"], np.float32), prof["trc"]
    name = name_or_path or ""
    base = name.removesuffix("-linear")
    if name != base and base in cs.MATRICES_RGB_TO_XYZ:
        return (np.asarray(cs.MATRICES_RGB_TO_XYZ[base], np.float32),
                ("linear", None))
    if name not in cs.MATRICES_RGB_TO_XYZ:
        name = "sRGB"
    return (np.asarray(cs.MATRICES_RGB_TO_XYZ[name], np.float32),
            output_trc(name))


def mark_gamut(rgb_encoded01, mask):
    """Paint the masked pixels cyan, the reference's mark (0, 255, 255)."""
    m = mask[None].to(rgb_encoded01.dtype)
    cyan = torch.stack([torch.zeros_like(rgb_encoded01[0]),
                        torch.ones_like(rgb_encoded01[0]),
                        torch.ones_like(rgb_encoded01[0])])
    return rgb_encoded01 * (1.0 - m) + cyan * m


def paint_gamut_warning(out_encoded01, output_profile, proof_profile):
    """(image, mask): the developed (3, H, W) image in [0, 1] with the
    pixels outside the proof profile's gamut painted cyan, and the
    (H, W) bool mask. output_profile, proof_profile: a named colorspace
    or a matrix .icc path."""
    out_mat, out_trc = _resolve_profile(output_profile)
    proof_mat, _ = _resolve_profile(proof_profile)
    aces = cs.MATRICES_XYZ_TO_RGB["ACESp0"].astype(np.float32)
    dev = out_encoded01.device

    def t(m):
        return torch.as_tensor(np.asarray(m, np.float32), device=dev)

    lin = cs.decode_trc(out_encoded01, out_trc)
    xyz = mat3(t(out_mat), lin)
    proof = mat3(t(np.linalg.inv(proof_mat).astype(np.float32)), xyz)
    ref_round = mat3(t(aces @ proof_mat), torch.clamp(proof, 0.0, 1.0))
    ref_direct = mat3(t(aces), xyz)
    delta = torch.amax(torch.abs(ref_round - ref_direct), dim=0)
    mask = delta > _DELTA_MATRIX
    return mark_gamut(out_encoded01, mask), mask
