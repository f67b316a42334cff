"""Output-profile transfer curves (a copy of the part of
``art_tpu/color/iccstore.py`` the port uses: ``ICCStore.output_profile``'s
TRC for a named matrix colorspace)."""

from __future__ import annotations

from art_tpu_torch.color import colorspaces as cs


def output_trc(name: str | None) -> tuple:
    """The (kind, param) TRC of a named output colorspace; an unknown or
    empty name is sRGB, as in the reference's store."""
    if not name or name not in cs.MATRICES_RGB_TO_XYZ:
        name = "sRGB"
    return cs.OUTPUT_GAMMAS.get(name, ("srgb", None))
