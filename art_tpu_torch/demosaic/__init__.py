"""Demosaic dispatch (counterpart of ``art_tpu/demosaic/__init__.py``).

Every method of the reference: for a Bayer mosaic, `amaze` (kernels
B1-B3), `rcd`, `lmmse`, `igv`, `vng4`, `dcb`, `ahd`, `eahd`, `hphd`,
`ppg`, `jdl` and the six dual blends ({amaze, rcd, dcb} x {bilinear,
vng4}), plain PyTorch as in the reference but AMaZE; `bilinear` and
`fast` as bilinear, `mono` and `none` as the mosaic in all three
channels; any other name develops bilinear, as in the reference (its
registry's default for a free-form method string). For an X-Trans frame,
every method of `demosaic/xtrans.py`, 4-pass with its dual blend.
"""

from __future__ import annotations

import torch


def methods():
    """name -> fn(cfa, pattern, **kwargs): the reference's registry
    (art_tpu/demosaic/registry.py). Each takes the planner's kwargs it
    knows (init_gain, iterations, enhance, dual_contrast, dual_auto) and
    ignores the others."""
    from art_tpu_torch.demosaic import (ahd, amaze, dcb, dual, eahd, hphd,
                                        igv, jdl, lmmse, ppg, rcd, vng4)

    return {"amaze": amaze.amaze_demosaic, "rcd": rcd.rcd_demosaic,
            "lmmse": lmmse.lmmse_demosaic, "igv": igv.igv_demosaic,
            "vng4": vng4.vng4_demosaic, "dcb": dcb.dcb_demosaic,
            "ahd": ahd.ahd_demosaic, "eahd": eahd.eahd_demosaic,
            "hphd": hphd.hphd_demosaic, "ppg": ppg.ppg_demosaic,
            "jdl": jdl.jdl_demosaic, **dual.methods()}


def demosaic(cfa, pattern, method, init_gain=1.0, xtrans=None,
             dem_kwargs=()):
    """(H, W) scaled mosaic -> (3, H, W) RGB on cfa's device.
    init_gain: the planner's raw gain (AMaZE's clip points, also the
    sharp side of its duals); dem_kwargs: the planner's method kwargs,
    as pairs (the reference's **kwargs); plain bilinear takes none."""
    from art_tpu_torch.demosaic import bilinear, xtrans as xt

    if xtrans is not None:
        return xt.demosaic_xtrans(cfa, xtrans, method, dem_kwargs)
    m = method.lower()
    if m in ("bilinear", "fast"):
        return bilinear.bayer_bilinear(cfa, pattern)
    if m in ("mono", "none"):
        return torch.stack([cfa, cfa, cfa])
    fn = methods().get(m)
    if fn is None:
        return bilinear.bayer_bilinear(cfa, pattern)
    return fn(cfa, pattern, init_gain=init_gain, **dict(dem_kwargs))
