"""Region masks (counterpart of ``art_tpu/masks/__init__.py``;
rtengine/masks.cc, procparams.h:101-330).

`MaskSpec` and its keyfile parsing, `regions_from_extra` (a tool's
suffixed region keys), and for one region `plan_mask` (host numpy) and
`eval_mask` (torch): an unmasked region, the parametric H/C/L mask, the
ΔE mask, the mask curve, posterization, inversion and opacity. Area,
drawn, external-file and linked masks need host rasterisers, image files
or another tool's mask; where the reference would apply one, planning
raises NotImplementedError naming it.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.curves import DiagonalCurve, FlatCurve
from art_tpu_torch.core.curve1d import eval_curve, fit_curve
from art_tpu_torch.core.fmath import fdiv
from art_tpu_torch.core.image import MAXVAL
from art_tpu_torch.ops.filters import gauss_blur
from art_tpu_torch.params.keyfile import KeyFile

# reference defaults (procparams.cc:1014-1052): identity curves
DEFAULT_HUE = [1, 0.166666667, 1.0, 0.35, 0.35, 0.8287775246, 1.0, 0.35,
               0.35]
DEFAULT_CC = [1, 0.0, 1.0, 0.35, 0.35, 1.0, 1.0, 0.35, 0.35]


@dataclasses.dataclass
class MaskSpec:
    enabled: bool = True
    inverted: bool = False
    parametric_enabled: bool = False
    hue: list = dataclasses.field(default_factory=lambda: list(DEFAULT_HUE))
    chromaticity: list = dataclasses.field(
        default_factory=lambda: list(DEFAULT_CC))
    lightness: list = dataclasses.field(
        default_factory=lambda: list(DEFAULT_CC))
    parametric_blur: float = 0.0
    area_enabled: bool = False
    area_shapes: list = dataclasses.field(default_factory=list)
    area_feather: float = 0.0
    area_blur: float = 0.0
    deltae_enabled: bool = False
    deltae_lch: tuple = (0.0, 0.0, 0.0)
    deltae_range: float = 1.0
    deltae_decay: float = 1.0
    curve: list = dataclasses.field(default_factory=lambda: [0])
    posterization: int = 0
    smoothing: int = 0
    opacity: float = 1.0
    drawn_enabled: bool = False
    drawn_feather: float = 0.0
    drawn_opacity: float = 1.0
    drawn_smoothness: float = 0.0
    drawn_contrast: list = dataclasses.field(default_factory=lambda: [0])
    drawn_mode: int = 0  # 0=INTERSECT 1=ADD 2=ADD_BOUNDED
    drawn_strokes: list = dataclasses.field(default_factory=list)
    name: str = ""
    # LinkedMask (procparams.h:267): reuse a named mask from another tool
    linked_enabled: bool = False
    linked_inverted: bool = False
    linked_toolname: str = ""
    linked_name: str = ""
    # ExternalMask (procparams.h:280): greyscale image file as a mask
    external_enabled: bool = False
    external_inverted: bool = False
    external_filename: str = ""
    external_feather: float = 0.0

    @classmethod
    def from_keyfile(cls, kf, group, suffix, prefix=""):
        """Parse the suffixed mask keys (procparams.cc:1432-1496)."""
        m = cls()
        g = lambda key, kind, dflt: {  # noqa: E731
            "b": kf.get_bool, "f": kf.get_float, "i": kf.get_int,
            "dl": kf.get_double_list, "s": kf.get_string,
        }[kind](group, prefix + key + suffix, dflt)
        m.enabled = g("MaskEnabled", "b", True)
        m.inverted = g("MaskInverted", "b", False)
        m.curve = g("MaskCurve", "dl", [0])
        m.posterization = g("MaskPosterization", "i", 0)
        m.smoothing = g("MaskSmoothing", "i", 0)
        m.opacity = g("MaskOpacity", "f", 1.0)
        m.parametric_enabled = g("ParametricMaskEnabled", "b", False)
        m.hue = g("HueMask", "dl", DEFAULT_HUE)
        m.chromaticity = g("ChromaticityMask", "dl", DEFAULT_CC)
        m.lightness = g("LightnessMask", "dl", DEFAULT_CC)
        m.parametric_blur = g("ParametricMaskBlur", "f", 0.0)
        m.area_enabled = g("AreaMaskEnabled", "b", False)
        m.area_feather = g("AreaMaskFeather", "f", 0.0)
        m.area_blur = g("AreaMaskBlur", "f", 0.0)
        n = 0
        while True:  # shapes: AreaMask<N>Type etc.
            t = kf.get_string(group, f"{prefix}AreaMask{n}Type{suffix}", "")
            if not t:
                break
            shape = {"type": t.lower()}
            for key in ("X", "Y", "Width", "Height", "Angle", "Roundness",
                        "StrengthStart", "StrengthEnd", "ShapeFeather"):
                shape[key.lower()] = kf.get_float(
                    group, f"{prefix}AreaMask{n}{key}{suffix}", 0.0)
            shape["knots"] = kf.get_double_list(
                group, f"{prefix}AreaMask{n}Knots{suffix}", [])
            shape["mode"] = kf.get_string(
                group, f"{prefix}AreaMask{n}Mode{suffix}", "add").lower()
            m.area_shapes.append(shape)
            n += 1
        m.drawn_enabled = g("DrawnMaskEnabled", "b", False)
        m.drawn_feather = g("DrawnMaskFeather", "f", 0.0)
        m.drawn_opacity = g("DrawnMaskOpacity", "f", 1.0)
        m.drawn_smoothness = g("DrawnMaskSmoothness", "f", 0.0)
        m.drawn_contrast = g("DrawnMaskContrast", "dl", [0])
        m.drawn_mode = g("DrawnMaskMode", "i", 0)
        m.drawn_strokes = g("DrawnMaskStrokes", "dl", [])
        m.deltae_enabled = g("DeltaEMaskEnabled", "b", False)
        m.deltae_lch = (g("DeltaEMaskL", "f", 0.0),
                        g("DeltaEMaskC", "f", 0.0),
                        g("DeltaEMaskH", "f", 0.0))
        m.deltae_range = g("DeltaEMaskRange", "f", 1.0)
        m.deltae_decay = g("DeltaEMaskDecay", "f", 1.0)
        m.name = g("MaskName", "s", "")
        # linked mask: "toolname|maskname" (procparams.cc:1403-1416)
        m.linked_enabled = g("LinkedMaskEnabled", "b", False)
        m.linked_inverted = g("LinkedMaskInverted", "b", False)
        ref = g("LinkedMask", "s", "")
        if "|" in ref:
            m.linked_toolname, m.linked_name = ref.split("|", 1)
        # external mask (procparams.cc:1418-1424)
        m.external_enabled = g("ExternalMaskEnabled", "b", False)
        m.external_inverted = g("ExternalMaskInverted", "b", False)
        m.external_filename = g("ExternalMaskFilename", "s", "")
        if m.external_filename.startswith("file://"):
            from urllib.parse import unquote, urlparse

            m.external_filename = unquote(urlparse(m.external_filename).path)
        m.external_feather = g("ExternalMaskFeather", "f", 0.0)
        return m

    def is_trivial(self):
        return not (self.parametric_enabled or self.area_enabled
                    or self.deltae_enabled or self.inverted
                    or (self.drawn_enabled and self.drawn_strokes)
                    or (self.linked_enabled and self.linked_name)
                    or (self.external_enabled and self.external_filename)
                    or (self.curve and len(self.curve) > 1))


# reference toolnames of LinkedMask refs (ipcolorcorrection.cc:236,
# iplocalcontrast.cc:454, ipsmoothing.cc:929, iptextureboost.cc:210)
_TOOL_GROUPS = {
    "colorcorrection": "ColorCorrection",
    "smoothing": "Smoothing",
    "textureboost": "TextureBoost",
    "localcontrast": "Local Contrast",
}


def _linked_source(pp, mask):
    """The enabled, named mask of another tool that a linked mask resolves
    to (masks.py::build_mask_registry's lookup), or None."""
    group = _TOOL_GROUPS.get(mask.linked_toolname)
    if group is None or group not in pp.extra:
        return None
    kf = KeyFile()
    kf.groups[group] = dict(pp.extra[group])
    for j in range(1, 65):
        sfx = f"_{j}"
        if not kf.has(group, f"MaskEnabled{sfx}") and \
                not kf.has(group, f"MaskName{sfx}"):
            break
        m = MaskSpec.from_keyfile(kf, group, sfx)
        if m.name == mask.linked_name and m.enabled:
            return m
    return None


def _unported(what):
    raise NotImplementedError(f"{what} is not ported to art_tpu_torch")


def plan_mask(mask: MaskSpec, shape, pp=None):
    """Host planner for one region mask -> (static, data), the reference's
    static layout. Refuses an area, drawn, external-file or linked mask
    wherever the reference would apply one."""
    data = {}
    use_param = False
    if mask.parametric_enabled:
        if not (mask.hue == DEFAULT_HUE and mask.chromaticity == DEFAULT_CC
                and mask.lightness == DEFAULT_CC):
            use_param = True
            data["hm"] = fit_curve(FlatCurve(
                mask.hue, periodic=True, identity_value=1.0).lut(8192))
            data["cm"] = fit_curve(FlatCurve(
                mask.chromaticity, periodic=False,
                identity_value=1.0).lut(8192))
            data["lm"] = fit_curve(FlatCurve(
                mask.lightness, periodic=False,
                identity_value=1.0).lut(8192))
    if mask.area_enabled and mask.area_shapes:
        _unported("area mask (masks/__init__.py::rasterize_area)")
    if mask.drawn_enabled and mask.drawn_strokes:
        _unported("drawn mask (masks/__init__.py::rasterize_drawn)")
    use_curve = False
    mc = DiagonalCurve(mask.curve)
    if not mc.is_identity():
        use_curve = True
        data["mcurve"] = fit_curve(mc.lut(8192))
    use_de = bool(mask.deltae_enabled)
    if use_de:
        data["de_ref"] = np.array(mask.deltae_lch, dtype=np.float32)
        data["de_range"] = np.float32(mask.deltae_range)
        data["de_decay"] = np.float32(max(mask.deltae_decay, 1e-3))
    # the reference loads an external mask file that opens, and skips one
    # that does not
    if (mask.external_enabled and mask.external_filename
            and os.path.isfile(mask.external_filename)):
        _unported("external mask file")
    if (mask.linked_enabled and mask.linked_name and pp is not None
            and _linked_source(pp, mask) is not None):
        _unported("linked mask")
    static = (use_param, False, use_curve, use_de,
              bool(mask.inverted), float(mask.parametric_blur),
              float(mask.area_blur), int(mask.posterization),
              float(mask.opacity), -1,
              float(np.clip(mask.drawn_opacity, 0.0, 1.0)),
              -1, None, bool(mask.linked_inverted))
    return static, data


def _lin2log(x, base):
    return fdiv(torch.log(x * (base - 1.0) + 1.0), math.log(base))


def _mod(x, y):
    """jnp.mod for floats: fmod, moved to y's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def eval_mask(rgb, ws, static, data):
    """One region mask of a (3, H, W) working-space image -> (H, W) in
    [0, 1]; ws the working space's RGB -> XYZ matrix (a tensor)."""
    (use_param, use_area, use_curve, use_de, inverted, pblur, _ablur,
     posterization, opacity, drawn_mode, _alpha, ext_radius, linked,
     _linked_inverted) = static
    if use_area or drawn_mode >= 0 or ext_radius >= 0 or linked is not None:
        _unported("area, drawn, external or linked mask")
    x = fdiv(rgb, MAXVAL)
    xx = ws[0, 0] * x[0] + ws[0, 1] * x[1] + ws[0, 2] * x[2]
    yy = ws[1, 0] * x[0] + ws[1, 1] * x[1] + ws[1, 2] * x[2]
    zz = ws[2, 0] * x[0] + ws[2, 1] * x[1] + ws[2, 2] * x[2]
    L, a, b = cs.xyz_to_lab(xx, yy, zz)
    l01 = torch.clamp(fdiv(L, 100.0), 0.0, 1.0)

    m = torch.ones_like(l01)
    if use_param:
        c = fdiv(torch.hypot(a, b), 182.0)
        c = _lin2log(torch.clamp(c, 0.0, 1.0), 50.0)
        hgl = fdiv(torch.atan2(b, a), 2 * math.pi)
        h01 = _lin2log(_mod(hgl + 1.0 + 1.0 / 6.0, 1.0), 3.0)
        m = (eval_curve(h01, data["hm"], in_max=1.0, out_max=1.0)
             * eval_curve(c, data["cm"], in_max=1.0, out_max=1.0)
             * eval_curve(l01, data["lm"], in_max=1.0, out_max=1.0))
        if pblur > 0:
            m = gauss_blur(m, pblur)
    if use_de:
        ref = data["de_ref"]
        c = torch.hypot(a, b)
        hh = torch.atan2(b, a) * (180.0 / math.pi)
        dL = L - ref[0]
        dC = c - ref[1]
        dH = torch.abs(_mod(hh - ref[2] + 180.0, 360.0) - 180.0)
        de = torch.sqrt((0.5 * dL) ** 2 + (0.75 * dC) ** 2
                        + (1.0 * dH) ** 2)
        sel = torch.exp(-torch.clamp(de - data["de_range"], min=0.0)
                        / (data["de_decay"] * 10.0))
        m = m * sel
    if use_curve:
        m = eval_curve(m, data["mcurve"], in_max=1.0, out_max=1.0)
    if posterization > 0:
        levels = float(2 ** posterization)
        m = torch.round(m * levels) / levels
    if inverted:
        m = 1.0 - m
    return torch.clamp(m * opacity, 0.0, 1.0)


def regions_from_extra(pp, group, field_spec):
    """Parse suffixed region params and masks from ProcParams.extra[group].

    field_spec: {python_name: (arp_key_base, kind, default)} with kinds
    b/i/f/s/dl; keys are read as f"{base}_{j}". Returns a list of
    (params_dict, MaskSpec), or None: an unsuffixed key plans no region,
    as in the reference."""
    if group not in pp.extra:
        return None
    kf = KeyFile()
    kf.groups[group] = dict(pp.extra[group])
    if not kf.get_bool(group, "Enabled", False):
        return None
    getters = {"b": kf.get_bool, "i": kf.get_int, "f": kf.get_float,
               "s": kf.get_string, "dl": kf.get_double_list}
    out = []
    for j in range(1, 65):
        sfx = f"_{j}"
        if not any(kf.has(group, spec[0] + sfx)
                   for spec in field_spec.values()) and not kf.has(
                       group, f"MaskEnabled{sfx}"):
            break
        params = {name: getters[kind](group, base + sfx, dflt)
                  for name, (base, kind, dflt) in field_spec.items()}
        out.append((params, MaskSpec.from_keyfile(kf, group, sfx)))
    return out or None
