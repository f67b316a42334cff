"""Lensfun XML database: parser, matcher, correction models (a copy of
``art_tpu/lens/lensfun.py``).

Reference: ``rtengine/rtlensfun.cc`` wraps liblensfun (LFDatabase /
LFModifier). No liblensfun exists here, so this module reads lensfun's
XML database files directly (the public format: ``<camera>`` and
``<lens>`` elements with ``<calibration>`` rows) and evaluates the
published correction models itself:

- distortion ``poly3``  rd = ru * (1 - k1 + k1 * ru^2)
- distortion ``poly5``  rd = ru * (1 + k1 * ru^2 + k2 * ru^4)
- distortion ``ptlens`` rd = ru * (a*ru^3 + b*ru^2 + c*ru + 1-a-b-c)
- TCA ``poly3``         rd = ru * (k + v * ru^2)  per R/B channel
- vignetting ``pa``     Cd = 1 + k1*r^2 + k2*r^4 + k3*r^6

Radii are normalized to the half-diagonal; calibrations taken on a
different sensor size are rescaled through the camera/lens crop-factor
ratio. Corrections are sampled to the same 16-knot radial splines the
EXIF-makernote path uses (`lens/exifcorr.py`), so the device
transform and raw-vignette paths are shared.

Matching follows LFDatabase::findModifier: camera by make+model
(case-insensitive containment), lens by normalized name tokens, focal
interpolation between bracketing calibration rows, nearest aperture for
vignetting.
"""

from __future__ import annotations

import glob
import os
import xml.etree.ElementTree as ET

import numpy as np

from art_tpu_torch.lens.exifcorr import ExifCorr

N_KNOTS = 16


class LFCamera:
    __slots__ = ("maker", "model", "mount", "cropfactor", "variant")

    def __init__(self, maker="", model="", mount="", cropfactor=1.0,
                 variant=""):
        self.maker = maker
        self.model = model
        self.mount = mount
        self.cropfactor = cropfactor
        self.variant = variant


class LFLens:
    __slots__ = ("maker", "model", "mounts", "cropfactor", "distortion",
                 "tca", "vignetting")

    def __init__(self, maker="", model="", cropfactor=1.0):
        self.maker = maker
        self.model = model
        self.mounts = []
        self.cropfactor = cropfactor
        self.distortion = []  # rows: {model, focal, params...}
        self.tca = []
        self.vignetting = []  # rows include aperture


def _floats(el, *names):
    out = {}
    for n in names:
        v = el.get(n)
        if v is not None:
            try:
                out[n] = float(v)
            except ValueError:
                pass
    return out


def _parse_file(path, cameras, lenses):
    try:
        root = ET.parse(path).getroot()
    except ET.ParseError:
        return
    for cam in root.iter("camera"):
        c = LFCamera(
            maker=(cam.findtext("maker") or "").strip(),
            model=(cam.findtext("model") or "").strip(),
            mount=(cam.findtext("mount") or "").strip(),
            cropfactor=float(cam.findtext("cropfactor") or 1.0),
            variant=(cam.findtext("variant") or "").strip(),
        )
        if c.model:
            cameras.append(c)
    for lens in root.iter("lens"):
        L = LFLens(
            maker=(lens.findtext("maker") or "").strip(),
            model=(lens.findtext("model") or "").strip(),
            cropfactor=float(lens.findtext("cropfactor") or 1.0),
        )
        L.mounts = [m.text.strip() for m in lens.findall("mount")
                    if m.text]
        cal = lens.find("calibration")
        if cal is not None:
            for d in cal.findall("distortion"):
                row = {"model": d.get("model", ""),
                       **_floats(d, "focal", "k1", "k2", "a", "b", "c")}
                if "focal" in row:
                    L.distortion.append(row)
            for t in cal.findall("tca"):
                row = {"model": t.get("model", ""),
                       **_floats(t, "focal", "kr", "kb", "vr", "vb")}
                if "focal" in row:
                    L.tca.append(row)
            for v in cal.findall("vignetting"):
                row = {"model": v.get("model", ""),
                       **_floats(v, "focal", "aperture", "distance",
                                 "k1", "k2", "k3")}
                if "focal" in row:
                    L.vignetting.append(row)
        if L.model:
            lenses.append(L)


class LensfunDB:
    def __init__(self, dirs):
        self.cameras = []
        self.lenses = []
        for d in dirs if isinstance(dirs, (list, tuple)) else [dirs]:
            if d and os.path.isdir(d):
                for f in sorted(glob.glob(os.path.join(d, "*.xml"))):
                    _parse_file(f, self.cameras, self.lenses)

    # ---- matching (LFDatabase::findCamera/findLens) ----
    def find_camera(self, make, model):
        make = (make or "").lower()
        model = (model or "").lower()
        best = None
        for c in self.cameras:
            if c.maker.lower() in make or make in c.maker.lower():
                cm = c.model.lower()
                if cm in model or model in cm:
                    if best is None or len(c.model) > len(best.model):
                        best = c
        return best

    def find_lens(self, name, camera=None):
        toks = set(_norm_tokens(name))
        if not toks:
            return None
        best = None
        best_score = 0.0
        for lens in self.lenses:
            if camera is not None and lens.mounts and camera.mount \
                    and camera.mount not in lens.mounts:
                continue
            lt = set(_norm_tokens(lens.model))
            if not lt:
                continue
            inter = len(toks & lt)
            score = inter / float(len(toks | lt))
            if inter and score > best_score:
                best_score = score
                best = lens
        return best if best_score >= 0.3 else None

    def corrections(self, lens, camera, focal, aperture=0.0):
        """ExifCorr 16-knot splines for (lens, camera, focal[, aperture]);
        None when the lens carries no usable calibration."""
        crop_scale = 1.0
        if camera is not None and camera.cropfactor > 0 \
                and lens.cropfactor > 0:
            # image-normalized radius -> calibration-normalized radius
            crop_scale = lens.cropfactor / camera.cropfactor
        r = np.arange(N_KNOTS, dtype=np.float32) / (N_KNOTS - 1)
        rc = r * crop_scale

        dist = None
        drow = _interp_rows(lens.distortion, focal)
        if drow is not None:
            dist = _dist_scale(drow, rc).astype(np.float32)
        ca = None
        trow = _interp_rows(lens.tca, focal)
        if trow is not None:
            ca = np.ones((3, N_KNOTS), np.float32)
            ca[0] = trow.get("kr", 1.0) + trow.get("vr", 0.0) * rc * rc
            ca[2] = trow.get("kb", 1.0) + trow.get("vb", 0.0) * rc * rc
        vig = None
        vrow = _interp_rows(_nearest_aperture(lens.vignetting, aperture),
                            focal)
        if vrow is not None:
            cd = (1.0 + vrow.get("k1", 0.0) * rc ** 2
                  + vrow.get("k2", 0.0) * rc ** 4
                  + vrow.get("k3", 0.0) * rc ** 6)
            # raw is divided by sf^2 downstream (exifcorr contract)
            vig = np.sqrt(np.maximum(cd, 1e-4)).astype(np.float32)
        if dist is None and ca is None and vig is None:
            return None
        return ExifCorr("spline", knots=r, dist=dist, vig=vig, ca=ca)


def _norm_tokens(name):
    out = []
    for t in (name or "").lower().replace("/", " ").replace("-", " ") \
            .split():
        t = t.strip(",;()")
        if t and t not in ("f", "mm", "lens"):
            out.append(t)
    return out


def _nearest_aperture(rows, aperture):
    if not rows:
        return rows
    if not aperture:
        return rows
    byf = {}
    for row in rows:
        f = row["focal"]
        cur = byf.get(f)
        if cur is None or abs(row.get("aperture", 0.0) - aperture) \
                < abs(cur.get("aperture", 0.0) - aperture):
            byf[f] = row
    return list(byf.values())


def _interp_rows(rows, focal):
    """Linear interpolation of calibration parameters between the
    bracketing focal rows (same model only)."""
    if not rows:
        return None
    rows = sorted(rows, key=lambda r: r["focal"])
    if not focal or focal <= rows[0]["focal"]:
        return rows[0]
    if focal >= rows[-1]["focal"]:
        return rows[-1]
    for a, b in zip(rows, rows[1:]):
        if a["focal"] <= focal <= b["focal"]:
            if a.get("model") != b.get("model"):
                return a
            t = (focal - a["focal"]) / max(b["focal"] - a["focal"], 1e-9)
            out = dict(a)
            for k in set(a) | set(b):
                if k == "model":
                    continue
                va = float(a.get(k, 0.0))
                vb = float(b.get(k, 0.0))
                out[k] = va + t * (vb - va)
            return out
    return rows[-1]


def _dist_scale(row, r):
    """rd/ru at normalized radii r for one distortion row."""
    m = row.get("model", "")
    r2 = r * r
    if m == "poly3":
        k1 = row.get("k1", 0.0)
        return 1.0 - k1 + k1 * r2
    if m == "poly5":
        return 1.0 + row.get("k1", 0.0) * r2 + row.get("k2", 0.0) * r2 * r2
    if m == "ptlens":
        a = row.get("a", 0.0)
        b = row.get("b", 0.0)
        c = row.get("c", 0.0)
        return a * r * r2 + b * r2 + c * r + 1.0 - a - b - c
    return np.ones_like(r)


_DB = None
_DB_DIR = None


def get_db():
    """Database from settings.lensfun_db_dir (cached)."""
    global _DB, _DB_DIR
    from art_tpu_torch.settings import settings

    d = settings.lensfun_db_dir
    if d != _DB_DIR:
        _DB = LensfunDB(d) if d else None
        _DB_DIR = d
    return _DB


def for_frame(pp, frame):
    """ExifCorr for the frame per LensProfParams lfauto/lfmanual
    (rtlensfun.cc findModifier), or None."""
    db = get_db()
    if db is None:
        return None
    lp = pp.lens_prof
    if lp.method == "lfmanual":
        cam = db.find_camera(lp.lf_camera_make, lp.lf_camera_model)
        lens = db.find_lens(lp.lf_lens, cam)
    elif lp.method == "lfauto":
        cam = db.find_camera(frame.make, frame.model)
        lens = db.find_lens(frame.exif.get("lens_model", ""), cam)
    else:
        return None
    if lens is None:
        return None
    focal = float(frame.exif.get("focal_length", 0.0) or 0.0)
    aperture = float(frame.exif.get("f_number", 0.0) or 0.0)
    return db.corrections(lens, cam, focal, aperture)
