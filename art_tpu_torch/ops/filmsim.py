"""Film simulation through a 3D LUT (counterpart of
``art_tpu/ops/filmsim.py``; ipfilmsim.cc, clutstore.cc:1502-1616
CLUTApplication::do_apply).

Before or after the tone curve (`filmsim_pre` / `filmsim_post`), by the
kind of the file, a relative name resolved against `settings.cluts_dir`:

- a Hald CLUT image (PNG or TIFF, `color/lut3d.py::load_hald_clut`), a
  `.cube` file or an external generator's `.json` config
  (`color/extclut.py`): working space -> sRGB primaries, the sRGB
  encode (the reference's device fit), the tetrahedral LUT blended by
  strength, the exact sRGB decode, back to the working space;
- a CTL script (`color/ctl.py`), baked once on the planning device to a
  LUT over the PQ shaper's domain: working -> the script's colour
  space, the shaper, the LUT, back, blended by strength in the working
  space (CTL_apply, clutstore.cc:1662);
- a CLF/CLFZ file (`color/clf.py`): working -> linear ACES AP0, the
  ProcessList, back, blended by strength in the working space (the
  reference's OCIO_apply, clutstore.cc:1620-1655).

Each table is cached per file and parameters. A file that cannot be
read or parsed plans nothing, as in the reference; an image format the
port's decoder does not read raises NotImplementedError naming it.
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


def _parse_lut_params(raw):
    """"name=v1,v2;..." -> {name: scalar or list} (procparams.cc
    load_lut_params)."""
    out = {}
    for item in (raw or "").split(";"):
        item = item.strip()
        if "=" not in item:
            continue
        name, _, vs = item.partition("=")
        vals = [float(v) for v in vs.split(",") if v.strip()]
        if vals:
            out[name.strip()] = vals[0] if len(vals) == 1 else vals
    return out


def _cached(key, load, errors):
    """The cache's entry for key, loading it on a miss; a load that
    raises one of `errors` caches None."""
    if key not in _lut_cache:
        try:
            _lut_cache[key] = load()
        except errors:
            _lut_cache[key] = None
    return _lut_cache[key]


def _strength(fs):
    return np.float32(np.clip(fs.strength / 100.0, 0.0, 1.0))


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
    key = (fname, fs.clut_params)
    low = fname.lower()
    work = cs.MATRICES_RGB_TO_XYZ[ctx["working_profile"]]
    if low.endswith(".ctl"):
        def bake():
            from art_tpu_torch.color.ctl import bake_lut, load_ctl

            script = load_ctl(fname)
            return (bake_lut(script, _parse_lut_params(fs.clut_params),
                             device=ctx.get("device", "cpu")),
                    script.colorspace)

        entry = _cached(key, bake, Exception)
        if entry is None:
            return None
        table, space = entry
        conv = (cs.MATRICES_XYZ_TO_RGB[space] @ work
                if space and space in cs.MATRICES_XYZ_TO_RGB else np.eye(3))
        return ("ctl", False), {
            "table": np.asarray(table, np.float32),
            "to_clut": conv.astype(np.float32),
            "to_work": np.linalg.inv(conv).astype(np.float32),
            "strength": _strength(fs)}
    if low.endswith((".clf", ".clfz")):
        from art_tpu_torch.color.clf import load_clf

        entry = _cached(key, lambda: load_clf(fname), Exception)
        if entry is None:
            return None
        sigs, arrays = entry
        conv = np.linalg.inv(cs.MATRICES_RGB_TO_XYZ["ACESp0"]) @ work
        return ("clf", sigs), {
            "clf_arrays": arrays,
            "to_clut": conv.astype(np.float32),
            "to_work": np.linalg.inv(conv).astype(np.float32),
            "strength": _strength(fs)}
    if low.endswith(".json"):
        from art_tpu_torch.color.extclut import get_external_lut

        table = _cached(key, lambda: get_external_lut(
            fname, _parse_lut_params(fs.clut_params)), (OSError, ValueError))
    else:
        table = _cached(key, lambda: load_lut3d(fname), (OSError, ValueError))
    if table is None:
        return None
    to_srgb = cs.MATRICES_XYZ_TO_RGB["sRGB"] @ work
    return ("hald", ctx["working_profile"] == "sRGB"), {
        "table": table,
        "to_clut": to_srgb.astype(np.float32),
        "to_work": np.linalg.inv(to_srgb).astype(np.float32),
        "strength": _strength(fs)}


def plan(pp, ctx):
    """The pre-curve position (filmsim_pre)."""
    return _plan_common(pp, ctx, want_after=False)


def plan_post(pp, ctx):
    """The post-curve position (filmsim_post)."""
    return _plan_common(pp, ctx, want_after=True)


def apply(rgb, data, static):
    mode, same = static
    s = data["strength"]
    if mode == "ctl":
        from art_tpu_torch.color.ctl import ctl_shaper

        enc = ctl_shaper(mat3(data["to_clut"], fdiv(rgb, MAXVAL)))
        out = mat3(data["to_work"], torch.stack(apply_tetrahedral(
            enc[0], enc[1], enc[2], data["table"]))) * MAXVAL
        return out * s + rgb * (1.0 - s)
    if mode == "clf":
        from art_tpu_torch.color.clf import apply_clf

        y = apply_clf(mat3(data["to_clut"], fdiv(rgb, MAXVAL)), same,
                      data["clf_arrays"])
        out = mat3(data["to_work"], y) * MAXVAL
        return out * s + rgb * (1.0 - s)
    x = fdiv(rgb, MAXVAL)
    if not same:
        x = mat3(data["to_clut"], x)
    enc = cs.srgb_gamma_torch(torch.clamp(x, 0.0, 1.0))
    out_enc = torch.stack(apply_tetrahedral(enc[0], enc[1], enc[2],
                                            data["table"])) * s \
        + enc * (1.0 - s)
    x = cs.srgb_igamma_torch(out_enc)
    if not same:
        x = mat3(data["to_work"], x)
    return x * MAXVAL
