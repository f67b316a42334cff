"""Pipeline ops (counterpart of :mod:`art_tpu.ops`).

Each op module exposes ``plan(pp, ctx) -> (static, data) | None`` (host
numpy) and ``apply(rgb, data, static) -> rgb`` on (3, H, W) float32
tensors in the 0..65535 domain. The stage grouping and order are the
reference's; every step is in `PORTED`. The DCP look (`dcplook_early`,
`dcplook_late`) is planned only from a DCP input profile. Film grain (`grain`) has no module of its own, as in the reference: the
smoothing op runs it as NOISE regions.
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

PORTED = ALL_STEPS

# steps run by another step's module: the film simulation before and
# after the tone curve, the DCP look early and late; None: a step with
# no module (film grain)
_MODULES = {"filmsim_pre": "filmsim", "filmsim_post": "filmsim",
            "dcplook_early": "dcplook", "dcplook_late": "dcplook",
            "grain": None}


def stage_of(name: str) -> int:
    for stage, names in enumerate((STAGE_0, STAGE_1, STAGE_2, STAGE_3)):
        if name in names:
            return stage
    return 3


def get_op(name: str):
    """The port's module for a ported op (None for a step with no module);
    NotImplementedError for an op that is not ported."""
    if name not in PORTED:
        raise NotImplementedError(f"op {name!r} is not ported")
    modname = _MODULES.get(name, name)
    if modname is None:
        return None
    return importlib.import_module(f"art_tpu_torch.ops.{modname}")


def plan_step(name, pp, ctx):
    """A step's plan: None for a step with no module; a positional variant
    (filmsim_post, dcplook_early) plans through its module's plan_<suffix> where there is
    one, as in the reference's planner."""
    mod = get_op(name)
    if mod is None:
        return None
    plan_fn = mod.plan
    if "_" in name:
        plan_fn = getattr(mod, f"plan_{name.rsplit('_', 1)[1]}", mod.plan)
    return plan_fn(pp, ctx)
