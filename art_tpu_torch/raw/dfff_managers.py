"""Dark-frame and flat-field auto-select managers (a copy of
``art_tpu/raw/dfff_managers.py``).

Reference: ``rtengine/dfmanager.cc`` (index by maker/model/ISO/shutter,
nearest acquisition time) and ``rtengine/ffmanager.cc`` (index by
maker/model/lens/focal/aperture, nearest time). The managers scan a
directory once, read each raw's metadata (no pixel decode), and pick the
best match for a shot; same-key frames taken closest in time win.

The reference parses shutter/aperture from filenames or EXIF via exiv2;
here the EXIF harvest comes from io.metadata when available, with mtime
as the acquisition-time fallback.
"""

from __future__ import annotations

import dataclasses
import math
import os

from art_tpu_torch.io.rawfile import RAW_EXTENSIONS
from art_tpu_torch.settings import settings


@dataclasses.dataclass
class _Entry:
    path: str
    make: str = ""
    model: str = ""
    iso: float = 0.0
    shutter: float = 0.0
    focal: float = 0.0
    aperture: float = 0.0
    lens: str = ""
    time: float = 0.0


def _harvest(path):
    e = _Entry(path=path)
    try:
        e.time = os.path.getmtime(path)
    except OSError:
        pass
    try:
        from art_tpu_torch.io.metadata import harvest

        ex, _ = harvest(path)
        e.make = str(ex.get("make", "")).strip()
        e.model = str(ex.get("model", "")).strip()
        e.iso = float(ex.get("iso", 0) or 0)
        e.shutter = float(ex.get("exposure_time", 0) or 0)
        e.focal = float(ex.get("focal_length", 0) or 0)
        e.aperture = float(ex.get("f_number", 0) or 0)
        e.lens = str(ex.get("lens_model", "")).strip()
        dt = ex.get("datetime_original")
        if dt:
            import time as _t

            try:
                e.time = _t.mktime(_t.strptime(str(dt),
                                               "%Y:%m:%d %H:%M:%S"))
            except ValueError:
                pass
    except Exception:
        pass
    return e


def _scan(directory):
    out = []
    if not directory or not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        p = os.path.join(directory, name)
        if (os.path.isfile(p)
                and os.path.splitext(name)[1].lower() in RAW_EXTENSIONS):
            out.append(_harvest(p))
    return out


class DarkFrameManager:
    """dfmanager.cc: match maker/model/ISO/shutter, nearest time."""

    def __init__(self, directory=None):
        if directory is None:
            directory = settings.dark_frames_dir or (
                os.path.join(settings.user_dir, "darkframes")
                if settings.user_dir else None)
        self.entries = _scan(directory)

    def search(self, make, model, iso, shutter, time=None):
        best = None
        best_key = None
        for e in self.entries:
            if make and e.make and e.make.lower() != str(make).lower():
                continue
            if model and e.model and e.model.lower() != str(model).lower():
                continue
            iso_d = abs(math.log2(max(e.iso, 25) / max(float(iso or 100),
                                                       25)))
            sh_d = abs(math.log2(max(e.shutter, 1e-4)
                                 / max(float(shutter or 1e-4), 1e-4))) \
                if shutter else 0.0
            t_d = abs((e.time or 0) - (time or e.time or 0)) / 86400.0
            key = (round(iso_d, 3), round(sh_d, 3), t_d)
            if best is None or key < best_key:
                best, best_key = e, key
        return best.path if best else None


class FlatFieldManager:
    """ffmanager.cc: match maker/model/lens/focal/aperture, nearest time."""

    def __init__(self, directory=None):
        if directory is None:
            directory = settings.flat_fields_dir or (
                os.path.join(settings.user_dir, "flatfields")
                if settings.user_dir else None)
        self.entries = _scan(directory)

    def search(self, make, model, lens="", focal=0.0, aperture=0.0,
               time=None):
        best = None
        best_key = None
        for e in self.entries:
            if make and e.make and e.make.lower() != str(make).lower():
                continue
            if model and e.model and e.model.lower() != str(model).lower():
                continue
            lens_d = 0 if (not lens or not e.lens
                           or e.lens.lower() == str(lens).lower()) else 1
            f_d = abs(math.log2(max(e.focal, 1.0)
                                / max(float(focal or 1.0), 1.0)))
            a_d = abs(math.log2(max(e.aperture, 0.5)
                                / max(float(aperture or 0.5), 0.5)))
            t_d = abs((e.time or 0) - (time or e.time or 0)) / 86400.0
            key = (lens_d, round(f_d, 3), round(a_d, 3), t_d)
            if best is None or key < best_key:
                best, best_key = e, key
        return best.path if best else None


_df_instance = None
_ff_instance = None


def df_manager():
    global _df_instance
    if _df_instance is None:
        _df_instance = DarkFrameManager()
    return _df_instance


def ff_manager():
    global _ff_instance
    if _ff_instance is None:
        _ff_instance = FlatFieldManager()
    return _ff_instance


def reset():
    global _df_instance, _ff_instance
    _df_instance = _ff_instance = None
