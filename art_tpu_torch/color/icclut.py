"""LUT-class ICC profiles on the device (counterpart of
``art_tpu/color/icclut.py``; the role lcms2 plays in
iccstore.cc:224-366).

`plan_lut` (host numpy, a copy of the reference's) turns an element
pipeline that `color/iccfile.py` parsed into a stage tuple and its
arrays: curves refit by `core/curve1d.py::fit_curves`, 3x3 and 3x4
matrices, the CLUT for `color/lut3d.py::apply_tetrahedral`.
`apply_stages` runs the stages on three planes, in torch.

Directions: ``plan_lut(lut, pcs, "in")`` is A2B, device RGB [0, 1] to
PCS XYZ (D50); ``plan_lut(lut, pcs, "out")`` is B2A, PCS XYZ to device
RGB [0, 1]. A lut16 (mft2) uses the ICC v2 legacy 16-bit Lab encoding
(L: 0..100 -> 0..0xFF00), lut8 and v4 mAB/mBA the natural ranges; XYZ
is the u1.15 encoding (1.0 -> 0x8000) in every form.
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.lut3d import apply_tetrahedral
from art_tpu_torch.core.curve1d import eval_curve, fit_curves
from art_tpu_torch.core.fmath import cbrt_xla, fdiv

_XYZ_SCALE = 32768.0 / 65535.0


def _is_identity_curves(stack):
    xs = np.linspace(0.0, 1.0, stack.shape[1])
    return all(np.allclose(stack[i], xs, atol=1e-4) for i in range(3))


def plan_lut(lut, pcs, direction):
    """Element dict (iccfile._parse_lut_tag) -> (stages, data): the
    hashable stage tuple `apply_stages` runs, and its numpy arrays (keys
    ``c0``/``c1``/``c2``, ``m3``, ``m34``, ``clut``), which the caller
    namespaces into the pipeline's data."""
    form = lut["form"]
    legacy_lab = form == "mft2"  # the v2 16-bit Lab encoding
    stages = []
    data = {}
    ci = 0

    def add_curves(stack):
        nonlocal ci
        if stack is None or _is_identity_curves(stack):
            return
        data[f"c{ci}"] = fit_curves([stack[i] for i in range(3)])
        stages.append(("curves", ci))
        ci += 1

    def add_clut():
        if lut["clut"] is None:
            return
        data["clut"] = np.asarray(lut["clut"], np.float32)
        stages.append(("clut",))

    def add_mat34():
        if lut["matrix34"] is None:
            return
        data["m34"] = np.asarray(lut["matrix34"], np.float32)
        stages.append(("matrix34",))

    if direction == "in":
        if form in ("mft1", "mft2"):
            add_curves(lut["in_curves"])
            add_clut()
            add_curves(lut["out_curves"])
        elif form == "mAB":
            add_curves(lut["in_curves"])   # A curves
            add_clut()
            add_curves(lut["m_curves"])
            add_mat34()
            add_curves(lut["out_curves"])  # B curves
        else:
            raise ValueError(f"tag form {form} cannot map device->PCS")
        stages.append(("pcs_dec", pcs, legacy_lab))
    elif direction == "out":
        stages.insert(0, ("pcs_enc", pcs, legacy_lab))
        if form in ("mft1", "mft2"):
            if pcs == "XYZ" and lut["matrix"] is not None:
                data["m3"] = np.asarray(lut["matrix"], np.float32)
                stages.append(("matrix3",))
            add_curves(lut["in_curves"])
            add_clut()
            add_curves(lut["out_curves"])
        elif form == "mBA":
            add_curves(lut["in_curves"])   # B curves
            add_mat34()
            add_curves(lut["m_curves"])
            add_clut()
            add_curves(lut["out_curves"])  # A curves
        else:
            raise ValueError(f"tag form {form} cannot map PCS->device")
    else:
        raise ValueError(direction)
    return tuple(stages), data


def _pcs_encode(x, y, z, pcs, legacy):
    if pcs == "XYZ":
        return x * _XYZ_SCALE, y * _XYZ_SCALE, z * _XYZ_SCALE
    L, a, b = cs.xyz_to_lab(x, y, z, root=cbrt_xla)
    if legacy:
        return (L * (652.8 / 65535.0), (a + 128.0) * (256.0 / 65535.0),
                (b + 128.0) * (256.0 / 65535.0))
    return L * 0.01, fdiv(a + 128.0, 255.0), fdiv(b + 128.0, 255.0)


def _pcs_decode(x, y, z, pcs, legacy):
    if pcs == "XYZ":
        return (fdiv(x, _XYZ_SCALE), fdiv(y, _XYZ_SCALE),
                fdiv(z, _XYZ_SCALE))
    if legacy:
        L = x * (65535.0 / 652.8)
        a = y * (65535.0 / 256.0) - 128.0
        b = z * (65535.0 / 256.0) - 128.0
    else:
        L = x * 100.0
        a = y * 255.0 - 128.0
        b = z * 255.0 - 128.0
    return cs.lab_to_xyz(L, a, b)


def apply_stages(r, g, b, stages, data, prefix=""):
    """The planned stages on three planes of one shape; data's arrays are
    read as ``f"{prefix}{key}"``, tensors on the planes' device."""
    for st in stages:
        kind = st[0]
        if kind == "curves":
            c = data[f"{prefix}c{st[1]}"]
            r, g, b = (eval_curve(torch.clamp(v, 0.0, 1.0), c[i], in_max=1.0,
                                  out_max=1.0)
                       for i, v in enumerate((r, g, b)))
        elif kind == "clut":
            r, g, b = apply_tetrahedral(
                torch.clamp(r, 0.0, 1.0), torch.clamp(g, 0.0, 1.0),
                torch.clamp(b, 0.0, 1.0), data[f"{prefix}clut"])
        elif kind == "matrix3":
            m = data[f"{prefix}m3"]
            r, g, b = (m[0, 0] * r + m[0, 1] * g + m[0, 2] * b,
                       m[1, 0] * r + m[1, 1] * g + m[1, 2] * b,
                       m[2, 0] * r + m[2, 1] * g + m[2, 2] * b)
        elif kind == "matrix34":
            m = data[f"{prefix}m34"]
            r, g, b = (m[0, 0] * r + m[0, 1] * g + m[0, 2] * b + m[0, 3],
                       m[1, 0] * r + m[1, 1] * g + m[1, 2] * b + m[1, 3],
                       m[2, 0] * r + m[2, 1] * g + m[2, 2] * b + m[2, 3])
        elif kind == "pcs_enc":
            r, g, b = _pcs_encode(r, g, b, st[1], st[2])
        elif kind == "pcs_dec":
            r, g, b = _pcs_decode(r, g, b, st[1], st[2])
        else:
            raise ValueError(f"unknown stage {kind}")
    return r, g, b
