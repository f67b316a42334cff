"""Film simulation through a 3D LUT (counterpart of
``art_tpu/ops/filmsim.py``; ipfilmsim.cc, clutstore.cc:1502-1616
CLUTApplication::do_apply).

Working space -> sRGB primaries, the sRGB encode, the tetrahedral LUT
blended by strength, the sRGB decode, back to the working space; before
or after the tone curve (`filmsim_pre` / `filmsim_post`). The encode is
the reference's device fit (`colorspaces.srgb_gamma_torch`) and the
decode its exact power. Ported: a `.cube` file, cached per file and
parameters, a relative name resolved against `settings.cluts_dir`. A file
that cannot be read plans nothing, as in the reference. A Hald CLUT
image, a CTL script, a CLF/CLFZ file and a JSON LUT generator raise
NotImplementedError naming them where the file exists.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.lut3d import apply_tetrahedral, load_lut3d
from art_tpu_torch.core.fmath import fdiv, mat3
from art_tpu_torch.core.image import MAXVAL

_lut_cache: dict = {}

# LUT kinds the reference reads through other modules, by extension
_UNPORTED = ((".ctl", "CTL script LUT (color/ctl.py)"),
             (".clf", "CLF LUT (color/clf.py)"),
             (".clfz", "CLF LUT (color/clf.py)"),
             (".json", "JSON LUT generator (color/extclut.py)"))


def _plan_common(pp, ctx, want_after):
    from art_tpu_torch.settings import settings

    fs = pp.film_simulation
    if not fs.enabled or not fs.clut_filename:
        return None
    if bool(fs.after_tone_curve) != want_after:
        return None
    fname = fs.clut_filename
    if not os.path.isabs(fname) and settings.cluts_dir:
        # relative CLUT paths resolve against clutsDir (clutstore.cc)
        cand = os.path.join(settings.cluts_dir, fname)
        if os.path.exists(cand):
            fname = cand
    for ext, what in _UNPORTED:
        if fname.lower().endswith(ext):
            if os.path.isfile(fname):
                raise NotImplementedError(
                    f"{what} {fname!r} is not ported to art_tpu_torch")
            return None  # the reference plans nothing for a missing file
    key = (fname, fs.clut_params)
    if key not in _lut_cache:
        try:
            _lut_cache[key] = load_lut3d(fname)
        except (OSError, ValueError):
            _lut_cache[key] = None
    table = _lut_cache[key]
    if table is None:
        return None
    work = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]]
    to_srgb = cs.MATRICES_XYZ_TO_RGB["sRGB"] @ work
    data = {
        "table": table,
        "to_clut": to_srgb.astype(np.float32),
        "to_work": np.linalg.inv(to_srgb).astype(np.float32),
        "strength": np.float32(np.clip(fs.strength / 100.0, 0.0, 1.0)),
    }
    return ("hald", ctx["working_profile"] == "sRGB"), data


def plan(pp, ctx):
    """The pre-curve position (filmsim_pre)."""
    return _plan_common(pp, ctx, want_after=False)


def plan_post(pp, ctx):
    """The post-curve position (filmsim_post)."""
    return _plan_common(pp, ctx, want_after=True)


def check_static(static):
    if static[0] != "hald":
        raise NotImplementedError(
            f"film simulation mode {static[0]!r} is not ported to "
            "art_tpu_torch")


def srgb_igamma(y):
    """sRGB -> linear of a tensor, the exact power (colorspaces.py::
    srgb_igamma)."""
    y = torch.clamp(y, 0.0, 1.0)
    return torch.where(y <= 0.04045, fdiv(y, 12.92),
                       torch.pow(fdiv(y + 0.055, 1.055), 2.4))


def apply(rgb, data, static):
    _, same = static
    x = fdiv(rgb, MAXVAL)
    if not same:
        x = mat3(data["to_clut"], x)
    enc = cs.srgb_gamma_torch(torch.clamp(x, 0.0, 1.0))
    r2, g2, b2 = apply_tetrahedral(enc[0], enc[1], enc[2], data["table"])
    s = data["strength"]
    out_enc = torch.stack([r2, g2, b2]) * s + enc * (1.0 - s)
    x = srgb_igamma(out_enc)
    if not same:
        x = mat3(data["to_work"], x)
    return x * MAXVAL
