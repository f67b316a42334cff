"""Pipeline ops (counterpart of :mod:`art_tpu.ops`).

Each op module exposes ``plan(pp, ctx) -> (static, data) | None`` (host
numpy) and ``apply(rgb, data, static) -> rgb`` on (3, H, W) float32
tensors in the 0..65535 domain. The stage grouping and order are the
reference's; only the ops in `PORTED` exist here.
"""

from __future__ import annotations

import importlib

STAGE_0 = ("spot", "filmneg", "denoise", "dehaze", "fattal")
STAGE_1 = ("chmixer", "exposure", "hsl", "toneequalizer")
STAGE_2 = ("dcplook_early", "sharpen", "impulse", "defringe",
           "colorcorrection", "smoothing")
STAGE_3 = (
    "gradients", "textureboost", "grain", "logenc", "saturation",
    "dcplook_late", "filmsim_pre", "tonecurve", "filmsim_post",
    "rgbcurves", "labadj", "softlight", "localcontrast", "bw",
)
ALL_STEPS = STAGE_0 + STAGE_1 + STAGE_2 + STAGE_3

PORTED = ("denoise", "impulse", "tonecurve")


def stage_of(name: str) -> int:
    for stage, names in enumerate((STAGE_0, STAGE_1, STAGE_2, STAGE_3)):
        if name in names:
            return stage
    return 3


def get_op(name: str):
    """The port's module for a ported op; NotImplementedError otherwise."""
    if name not in PORTED:
        raise NotImplementedError(f"op {name!r} is not ported")
    return importlib.import_module(f"art_tpu_torch.ops.{name}")
