"""Region masks (counterpart of ``art_tpu/masks/__init__.py``;
rtengine/masks.cc, procparams.h:101-330).

`MaskSpec` and its keyfile parsing, `regions_from_extra` (a tool's
suffixed region keys), and for one region `plan_mask` (host) and
`eval_mask` (torch): the parametric H/C/L mask, the ΔE mask, the area
shapes, the drawn strokes, an external mask file, a mask linked from
another tool, the mask curve, posterization, inversion and opacity.

The area and drawn masks are rasterised at plan time, as the reference
does with OpenCV, by `masks/raster.py`: the binary fills exactly in host
numpy, the feathers and the rest of each plane in PyTorch on the plan's
device (a 24 MP feather is a blur of hundreds of taps), returned to the
host as the reference's planes. An external mask file is decoded by
`io/imagefile.py::read_grey` and resampled as Pillow does
(`raster.pil_resize_bilinear`); a file that raises OSError (missing, no
image, truncated) plans the region unmasked, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.curves import DiagonalCurve, FlatCurve
from art_tpu_torch.core.curve1d import eval_curve, fit_curve
from art_tpu_torch.core.fmath import fdiv
from art_tpu_torch.core.image import MAXVAL
from art_tpu_torch.masks import raster
from art_tpu_torch.ops.filters import gauss_blur, guided_filter
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


def build_mask_registry(pp):
    """(toolname, mask name) -> MaskSpec over every masked tool in `pp`
    (masks.py::build_mask_registry; LinkedMaskManager, masks.cc:806-865):
    the enabled, named masks, the last of a name winning. Built anew for
    each plan; the reference caches it on the ProcParams."""
    reg = {}
    for toolname, group in _TOOL_GROUPS.items():
        if group not in pp.extra:
            continue
        kf = KeyFile()
        kf.groups[group] = dict(pp.extra[group])
        for j in range(1, 65):
            sfx = f"_{j}"
            if not kf.has(group, f"MaskEnabled{sfx}") and \
                    not kf.has(group, f"MaskName{sfx}"):
                break
            m = MaskSpec.from_keyfile(kf, group, sfx)
            if m.name and m.enabled:
                reg[(toolname, m.name)] = m
    return reg


def _host(t):
    return t.cpu().numpy()


def rasterize_area(shapes, h, w, device="cpu"):
    """The area shapes as a float32 (h, w) alpha (masks.py::
    rasterize_area): rectangles and polygons filled on the host, their
    feather blurred, gradients and the add/subtract/intersect modes on
    `device`."""
    out = torch.zeros((h, w), dtype=torch.float32, device=device)
    for s in shapes:
        cx = (s.get("x", 0.0) / 200.0 + 0.5) * w
        cy = (s.get("y", 0.0) / 200.0 + 0.5) * h
        fill = None
        if s["type"] in ("rectangle", "rect"):
            ww = s.get("width", 100.0) / 100.0 * w / 2.0
            hh = s.get("height", 100.0) / 100.0 * h / 2.0
            angle = np.radians(s.get("angle", 0.0))
            box = raster.box_points((cx, cy), (2 * ww, 2 * hh),
                                    -np.degrees(angle))
            fill = raster.fill_poly((h, w), box.astype(np.int32))
        elif s["type"] == "polygon" and len(s.get("knots", [])) >= 6:
            k = np.asarray(s["knots"], dtype=np.float64)
            pts = np.stack([(k[0::3] / 200.0 + 0.5) * w,
                            (k[1::3] / 200.0 + 0.5) * h], axis=1)
            fill = raster.fill_poly((h, w), pts.astype(np.int32))
        if s["type"] == "gradient":
            # float64 over the pixel grid, as the reference's np.mgrid
            angle = np.radians(s.get("angle", 0.0))
            ss = s.get("strengthstart", 100.0) / 100.0
            se = s.get("strengthend", 0.0) / 100.0
            f64 = dict(dtype=torch.float64, device=device)
            dx = (torch.arange(w, **f64) - cx) * float(np.sin(angle))
            dy = (torch.arange(h, **f64) - cy) * float(np.cos(angle))
            d = dx[None, :] + dy[:, None]
            span = max(h, w) * max(s.get("shapefeather", 25.0), 1.0) / 100.0
            t = torch.clamp(d / span + 0.5, 0.0, 1.0)
            alpha = (ss + (se - ss) * t).to(torch.float32)
        elif fill is not None:
            alpha = torch.from_numpy(fill).to(device).to(torch.float32)
        else:
            alpha = torch.zeros((h, w), dtype=torch.float32, device=device)
        feather = s.get("shapefeather", 0.0)
        if feather > 0 and s["type"] != "gradient":
            sigma = feather / 100.0 * min(h, w) * 0.1 + 0.5
            alpha = raster.gaussian_blur(alpha, sigma)
        if s.get("mode") == "subtract":
            out = torch.clamp(out - alpha, 0.0, 1.0)
        elif s.get("mode") == "intersect":
            out = out * alpha
        else:
            out = torch.clamp(out + alpha, 0.0, 1.0)
    return _host(out)


def _interp(x, xp, fp):
    """np.interp of x in [xp[0], xp[-1]] in float64 on x's device, the
    reference's formula: slope * (x - xp[j]) + fp[j], fp[j] where x hits
    a knot."""
    xp = torch.from_numpy(np.asarray(xp, np.float64)).to(x.device)
    fp = torch.from_numpy(np.asarray(fp, np.float64)).to(x.device)
    n = xp.numel()
    j = torch.searchsorted(xp, x, right=True) - 1
    jj = torch.clamp(j, 0, n - 2)
    slope = (fp[1:] - fp[:-1]) / (xp[1:] - xp[:-1])
    res = slope[jj] * (x - xp[jj]) + fp[jj]
    res = torch.where(xp[jj] == x, fp[jj], res)
    return torch.where(j >= n - 1, fp[n - 1], res)


def rasterize_drawn(spec, h, w, device="cpu"):
    """The brush strokes as a float32 (h, w) plane (masks.py::
    rasterize_drawn; masks.cc generate_drawn_mask): each stroke group's
    discs stamped on the host over their bounding box, then the rescale,
    the smoothness blur, the feather and the contrast curve on `device`.
    The reference's deviations from ART are kept: a Gaussian feather in
    place of the guided filter, stamps merged per parameter group."""
    strokes = list(spec.drawn_strokes)
    add = spec.drawn_mode != 0
    mask = np.zeros((h, w), dtype=np.float32)
    stamped = np.zeros((h, w), dtype=bool)
    maxradius = 0.0
    pos = 0
    while pos + 4 < len(strokes):
        n = int(strokes[pos])
        radius = float(strokes[pos + 1])
        erase = not bool(strokes[pos + 2])
        opac = float(np.clip(strokes[pos + 3], 0.0, 1.0))
        pos += 4
        pts = strokes[pos: pos + 2 * n]
        pos += 2 * n
        r = int(min(w, h) * radius * 0.25)
        maxradius = max(maxradius, radius)
        val = (-1.0 if erase else 1.0) + (1.0 - opac) * (0.99 if erase
                                                         else -0.99)
        centers = [(int(round(w * pts[k])), int(round(h * pts[k + 1])))
                   for k in range(0, len(pts) - 1, 2)]
        cover = raster.circle_cover((h, w), centers, max(r, 1))
        if cover is None:
            continue
        win, cov = cover
        m = mask[win]
        stamped[win] |= cov
        if add:
            base = np.where(np.sign(m) == np.sign(val), m,
                            np.clip(m, 0.0, 1.0))
            mask[win] = np.where(cov, np.clip(base + val, -1.0, 1.0), m)
        else:
            mask[win] = np.where(cov, np.clip(m + val, 0.0, 1.0), m)

    ccurve = DiagonalCurve(spec.drawn_contrast)
    needscale = add and (spec.drawn_smoothness > 0 or spec.drawn_feather > 0
                         or not ccurve.is_identity())
    out = torch.from_numpy(mask).to(device)
    if needscale:
        out = torch.where(torch.from_numpy(stamped).to(device),
                          (out + 1.0) / 2.0, 0.5)
    if spec.drawn_smoothness > 0:
        sigma = min(w, h) * maxradius * 0.2 * spec.drawn_smoothness
        if sigma > 0.3:
            out = raster.gaussian_blur(out, sigma)
    if spec.drawn_feather > 0:
        rad = spec.drawn_feather / 100.0 * min(w, h) * 0.1 + 0.5
        if rad > 0.6:
            out = raster.gaussian_blur(out, rad)
    if not ccurve.is_identity():
        out = _interp(torch.clamp(out, 0.0, 1.0).to(torch.float64),
                      np.linspace(0.0, 1.0, 1025),
                      ccurve.lut(1025)).to(torch.float32)
    if needscale:
        out = out * 2.0 - 1.0
    return _host(out)


def load_external_mask(filename, h, w, inverted, device="cpu"):
    """A greyscale mask image as a float32 (h, w) plane (masks.py::
    _load_external_mask; ExternalMaskManager::apply_mask, masks.cc:
    951-1023): PIL's mode, its bilinear resample to the frame, a scale
    chosen by the plane's max, the clip, the optional inversion. None
    where the decode raises OSError (a missing, empty, truncated file or
    one that is no image), which leaves the reference's region
    unmasked; the resample on the card raises as it fails."""
    from art_tpu_torch.io.imagefile import read_grey

    try:
        plane, mode = read_grey(filename, resized=True)
    except OSError:
        return None
    if mode == "P":  # an IPTC/NAA L file over a palette core
        if plane.shape != (h, w):
            from art_tpu_torch.io.stdformats import PilValueError

            raise PilValueError("image has wrong mode")
        a = torch.from_numpy(plane.astype(np.float32)).to(device)
    else:
        a = raster.pil_resize_bilinear(plane, mode, (w, h), device).to(
            torch.float32)
    top = float(a.max())
    scale = 65535.0 if top > 255.0 else (255.0 if top > 1.0 else 1.0)
    a = torch.clamp(a / scale, 0.0, 1.0)
    if inverted:
        a = 1.0 - a
    return _host(a)


def plan_mask(mask: MaskSpec, shape, pp=None, device="cpu"):
    """Host planner for one region mask -> (static, data), the reference's
    static layout and data keys. `pp` resolves a linked mask against the
    other tools' masks; `device` is where the area and drawn planes and
    an external mask's resample are computed."""
    h, w = shape
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
    use_area = bool(mask.area_enabled and mask.area_shapes)
    if use_area:
        data["area"] = rasterize_area(mask.area_shapes, h, w, device)
    drawn_mode = -1
    if mask.drawn_enabled and mask.drawn_strokes:
        drawn_mode = int(np.clip(mask.drawn_mode, 0, 2))
        data["drawn"] = rasterize_drawn(mask, h, w, device)
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
    # external mask file (masks.cc:1396); one whose decode raises
    # OSError leaves the region unmasked
    ext_radius = -1
    ext = None
    if mask.external_enabled and mask.external_filename:
        ext = load_external_mask(mask.external_filename, h, w,
                                 mask.external_inverted, device)
    if ext is not None:
        data["ext"] = ext
        # feather -> guided-filter radius (masks.cc:1025-1030)
        ext_radius = int(mask.external_feather / 100.0 * min(h, w) * 0.1
                         + 0.5) if mask.external_feather > 0 else 0
    # linked mask: the other tool's spec, without its own linked and
    # external parts, planned and evaluated on this op's input
    # (masks.cc:1411-1425, the reference's re-evaluation)
    linked_static = None
    if mask.linked_enabled and mask.linked_name and pp is not None:
        src = build_mask_registry(pp).get((mask.linked_toolname,
                                           mask.linked_name))
        if src is not None:
            src = dataclasses.replace(src, linked_enabled=False,
                                      external_enabled=False)
            linked_static, linked_data = plan_mask(src, shape,
                                                   device=device)
            for k, v in linked_data.items():
                data["linked:" + k] = v
    static = (use_param, use_area, use_curve, use_de,
              bool(mask.inverted), float(mask.parametric_blur),
              float(mask.area_blur), int(mask.posterization),
              float(mask.opacity), drawn_mode,
              float(np.clip(mask.drawn_opacity, 0.0, 1.0)),
              ext_radius, linked_static, bool(mask.linked_inverted))
    return static, data


def _lin2log(x, base):
    return fdiv(torch.log(x * (base - 1.0) + 1.0), math.log(base))


def _mod(x, y):
    """jnp.mod for floats: fmod, moved to y's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def eval_mask(rgb, ws, static, data):
    """One region mask of a (3, H, W) working-space image -> (H, W) in
    [0, 1]; ws the working space's RGB -> XYZ matrix (a tensor). The
    parts multiply in the reference's order: parametric, ΔE, a bounded
    brush, the area, the external plane, the linked mask, the other
    brush modes; then the curve, posterization, inversion, opacity."""
    (use_param, use_area, use_curve, use_de, inverted, pblur, ablur,
     posterization, opacity, drawn_mode, drawn_alpha, ext_radius, linked,
     linked_inverted) = static

    def apply_drawn(m):
        f = drawn_alpha * data["drawn"]
        if drawn_mode == 0:  # INTERSECT
            return m * f
        return torch.clamp(m + f, 0.0, 1.0)

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
    if drawn_mode == 2:  # ADD_BOUNDED: the brush before the area bound
        m = apply_drawn(m)
    if use_area:
        area = data["area"]
        if ablur > 0:
            area = gauss_blur(area, ablur)
        m = m * area
    if ext_radius >= 0:  # the external mask multiplies in (masks.cc:1396)
        ext = data["ext"]
        if ext_radius > 0:
            ext = guided_filter(l01, ext, ext_radius, 1e-7)
        m = m * ext
    if linked is not None:  # the linked mask multiplies in (:1411)
        lm = eval_mask(rgb, ws, linked,
                       {k[len("linked:"):]: v for k, v in data.items()
                        if k.startswith("linked:")})
        if linked_inverted:
            lm = 1.0 - lm
        m = m * lm
    if drawn_mode in (0, 1):
        m = apply_drawn(m)
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
