"""Adobe Lens Correction Profile (.lcp) parser + mapper (a copy of
``art_tpu/lens/lcp.py``).

Reference: ``rtengine/lcp.{h,cc}`` (parser :600-900, model math
LCPModelCommon::merge/prepareParams :93-160, mapper :1035-1215). An LCP is
an XMP document with per-focal-length frames; each frame carries a
rectilinear ("Perspective") distortion model, a vignette model and three
chromatic-aberration models, all in Adobe's normalized coordinates
(focal lengths relative to max(W, H), centers relative to W/H).

The host side parses and interpolates (log-focal weighting, aperture mix
for vignette — lcp.cc :507-546) into flat coefficient rows; the device
side evaluates the radial polynomials inside the geometric transform and
the raw vignette gain (pipeline/transform.py, pipeline/develop.py).
Fisheye profiles and the swapped/mirrored orientations are out of scope
(the pipeline applies LCP in sensor orientation).
"""

from __future__ import annotations

import dataclasses
import math
import os
import xml.etree.ElementTree as ET

import numpy as np


def _local(tag):
    return tag.rsplit("}", 1)[-1].rsplit(":", 1)[-1]


_MODEL_NAMES = {
    "PerspectiveModel": "base",
    "RectilinearModel": "base",
    "VignetteModel": "vignette",
    "ChromaticRedGreenModel": "chrom_r",
    "ChromaticGreenModel": "chrom_g",
    "ChromaticBlueGreenModel": "chrom_b",
}

_NUM_FIELDS = (
    "FocalLengthX", "FocalLengthY", "ImageXCenter", "ImageYCenter",
    "ScaleFactor", "ResidualMeanError",
    "RadialDistortParam1", "RadialDistortParam2", "RadialDistortParam3",
    "TangentialDistortParam1", "TangentialDistortParam2",
    "VignetteModelParam1", "VignetteModelParam2", "VignetteModelParam3",
)


@dataclasses.dataclass
class Model:
    foc_len_x: float = -1.0
    foc_len_y: float = -1.0
    img_center_x: float = 0.5
    img_center_y: float = 0.5
    scale_factor: float = 1.0
    # param[0..4] = RadialDistort1..3, TangentialDistort1..2 (or
    # VignetteModelParam1..3 in param[0..2] for the vignette model)
    param: list = dataclasses.field(default_factory=lambda: [0.0] * 5)

    def merged(self, other, fac_a):
        fb = 1.0 - fac_a
        m = Model(
            foc_len_x=fac_a * self.foc_len_x + fb * other.foc_len_x,
            foc_len_y=fac_a * self.foc_len_y + fb * other.foc_len_y,
            img_center_x=fac_a * self.img_center_x + fb * other.img_center_x,
            img_center_y=fac_a * self.img_center_y + fb * other.img_center_y,
            scale_factor=fac_a * self.scale_factor + fb * other.scale_factor,
            param=[fac_a * a + fb * b
                   for a, b in zip(self.param, other.param)])
        return m

    def vign_param(self):
        """lcp.cc merge :109-116: the vignette gain series coefficients."""
        p0, p1, p2 = self.param[0], self.param[1], self.param[2]
        p0sq = p0 * p0
        return (-p0, p0sq - p1,
                p0sq * p0 - 2.0 * p0 * p1 + p2,
                p0sq * p0sq + p1 * p1 + 2.0 * p0 * p2 - 3.0 * p0sq * p1)

    def geometry(self, w, h, focal_mm):
        """prepareParams :119-158 (no swap/mirror): (x0, y0, fx, fy)."""
        dmax = max(w, h)
        flx, fly = self.foc_len_x, self.foc_len_y
        if flx < 0:
            # focal lengths absent: derive from the shot focal length
            # assuming full-frame-equivalent normalization
            flx = fly = (focal_mm / 35.0) if focal_mm > 0 else 1.0
        return (self.img_center_x * w, self.img_center_y * h,
                flx * dmax, fly * dmax)


@dataclasses.dataclass
class Frame:
    focal: float = 0.0
    aperture: float = 0.0
    focus_dist: float = 0.0
    models: dict = dataclasses.field(default_factory=dict)


class LCPProfile:
    def __init__(self, frames, is_fisheye=False):
        self.frames = sorted(frames, key=lambda f: f.focal)
        self.is_fisheye = is_fisheye

    def _interp(self, kind, focal, aperture=0.0):
        cands = [f for f in self.frames if kind in f.models]
        if not cands:
            return None
        if len(cands) == 1 or focal <= 0:
            return cands[0].models[kind]
        lo = max((f for f in cands if f.focal <= focal),
                 key=lambda f: f.focal, default=cands[0])
        hi = min((f for f in cands if f.focal >= focal),
                 key=lambda f: f.focal, default=cands[-1])
        if lo.focal >= hi.focal:
            return lo.models[kind]
        fac_lo = ((math.log(hi.focal) - math.log(max(focal, 1e-3)))
                  / (math.log(hi.focal) - math.log(lo.focal)))
        fac_lo = min(max(fac_lo, 0.0), 1.0)
        if kind == "vignette" and aperture > 0 and lo.aperture < aperture \
                and hi.aperture > aperture:
            fac_ap = ((hi.aperture - aperture)
                      / (hi.aperture - lo.aperture))
            fac_lo = 0.5 * fac_lo + 0.5 * fac_ap
        return lo.models[kind].merged(hi.models[kind], fac_lo)

    def distortion(self, focal):
        return self._interp("base", focal)

    def vignette(self, focal, aperture=0.0):
        return self._interp("vignette", focal, aperture)

    def chromatic(self, focal):
        mods = [self._interp(k, focal)
                for k in ("chrom_r", "chrom_g", "chrom_b")]
        return mods if all(m is not None for m in mods) else None


def parse_lcp(path) -> LCPProfile | None:
    if not path or not os.path.isfile(path):
        return None
    try:
        tree = ET.parse(path)
    except ET.ParseError:
        return None
    frames = []
    fisheye = False

    def attrs_of(el):
        out = {}
        for k, v in el.attrib.items():
            out[_local(k)] = v
        for child in el:
            name = _local(child.tag)
            if name not in _MODEL_NAMES and child.text \
                    and child.text.strip() and len(child) == 0:
                out[name] = child.text.strip()
        return out

    def model_from(el):
        # the model element either has the attrs directly or wraps a
        # Description that does
        a = attrs_of(el)
        for child in el.iter():
            if child is not el:
                a.update(attrs_of(child))
        m = Model()
        g = lambda key, dflt: float(a.get(key, dflt))
        m.foc_len_x = g("FocalLengthX", -1.0)
        m.foc_len_y = g("FocalLengthY", m.foc_len_x)
        m.img_center_x = g("ImageXCenter", 0.5)
        m.img_center_y = g("ImageYCenter", 0.5)
        m.scale_factor = g("ScaleFactor", 1.0)
        if "VignetteModelParam1" in a:
            m.param = [g("VignetteModelParam1", 0.0),
                       g("VignetteModelParam2", 0.0),
                       g("VignetteModelParam3", 0.0), 0.0, 0.0]
        else:
            m.param = [g("RadialDistortParam1", 0.0),
                       g("RadialDistortParam2", 0.0),
                       g("RadialDistortParam3", 0.0),
                       g("TangentialDistortParam1", 0.0),
                       g("TangentialDistortParam2", 0.0)]
        return m

    for el in tree.getroot().iter():
        name = _local(el.tag)
        if name == "FisheyeModel":
            fisheye = True
        a = {_local(k): v for k, v in el.attrib.items()}
        has_focal = "FocalLength" in a
        if not has_focal:
            for child in el:
                if _local(child.tag) == "FocalLength":
                    a["FocalLength"] = (child.text or "0").strip()
                    has_focal = True
        if not has_focal:
            continue
        fr = Frame(
            focal=float(a.get("FocalLength", 0) or 0),
            aperture=float(a.get("ApertureValue", 0) or 0),
            focus_dist=float(a.get("FocusDistance", 0) or 0))
        for sub in el.iter():
            nm = _local(sub.tag)
            if nm in _MODEL_NAMES:
                fr.models[_MODEL_NAMES[nm]] = model_from(sub)
        if fr.models:
            frames.append(fr)
    if not frames:
        return None
    return LCPProfile(frames, fisheye)
