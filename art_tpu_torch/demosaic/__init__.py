"""Demosaic dispatch (counterpart of ``art_tpu/demosaic/__init__.py``).

Ported: ``amaze`` (kernels B1-B3), ``rcd`` (plain PyTorch, as in the
reference) and the bilinear Bayer methods (``bilinear`` and ``fast``,
which the reference also maps to bilinear); for an X-Trans frame, every
method of ``demosaic/xtrans.py`` but the 4-pass dual blend. Every other
Bayer method raises NotImplementedError naming it; there is no fallback
to bilinear for an unknown name.
"""

from __future__ import annotations

PORTED = ("amaze", "rcd", "bilinear", "fast")


def demosaic(cfa, pattern, method, init_gain=1.0, xtrans=None,
             dem_kwargs=()):
    """(H, W) scaled mosaic -> (3, H, W) RGB on cfa's device.
    init_gain: the planner's raw gain (AMaZE's clip points); the
    planner's dual-demosaic kwargs do not apply to plain bilinear, as in
    the reference; for X-Trans they say whether 4-pass blends."""
    from art_tpu_torch.demosaic import amaze, bilinear, rcd, xtrans as xt

    if xtrans is not None:
        return xt.demosaic_xtrans(cfa, xtrans, method, dem_kwargs)
    m = method.lower()
    if m in ("bilinear", "fast"):
        return bilinear.bayer_bilinear(cfa, pattern)
    if m == "amaze":
        return amaze.amaze_demosaic(cfa, pattern, init_gain=init_gain)
    if m == "rcd":
        return rcd.rcd_demosaic(cfa, pattern)
    raise NotImplementedError(
        f"demosaic method {method!r} is not ported to art_tpu_torch "
        f"(ported: {', '.join(PORTED)})")
