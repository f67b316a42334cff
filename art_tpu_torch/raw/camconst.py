"""Camera constants DB (a copy of ``art_tpu/raw/camconst.py``, trimmed to
the lookups the port makes: the planner's whether a camera has PDAF
lines, and the raw loader's per-ISO white and black levels and dcraw
matrix).

The data is the reference's bundled ``camconst.json``, shipped in
``art_tpu_torch/data/``.
"""

from __future__ import annotations

import json
import os
import threading

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "camconst.json")


def _strip_comments(text: str) -> str:
    """Remove // line comments outside of string literals (cJSON tolerance)."""
    out = []
    in_str = False
    i = 0
    n = len(text)
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
        else:
            if c == '"':
                in_str = True
                out.append(c)
                i += 1
            elif c == "/" and i + 1 < n and text[i + 1] == "/":
                while i < n and text[i] != "\n":
                    i += 1
            elif c == "/" and i + 1 < n and text[i + 1] == "*":
                i += 2
                while i + 1 < n and not (text[i] == "*" and text[i + 1] == "/"):
                    i += 1
                i += 2
            else:
                out.append(c)
                i += 1
    return "".join(out)


class CameraConst:
    def __init__(self, data: dict):
        self.make_model = data.get("make_model", "")
        self.data = data

    @staticmethod
    def _resolve_levels(spec, iso):
        """Resolve a camconst levels spec: scalar | [4 values] | per-ISO table.

        Per-ISO entries list exact ISO values (camconst.cc get_Levels picks
        the entry containing the ISO); unmatched ISO falls through to the
        nearest lower entry.
        """
        if spec is None:
            return None
        if isinstance(spec, (int, float)):
            return [float(spec)] * 4
        if isinstance(spec, list) and spec and isinstance(spec[0], (int, float)):
            vals = [float(v) for v in spec]
            return (vals * 4)[:4]
        if isinstance(spec, list):  # per-ISO dict entries
            best = None
            best_iso = -1
            fallback = None
            for entry in spec:
                if not isinstance(entry, dict):
                    continue
                isos = entry.get("iso", 0)
                isos = isos if isinstance(isos, list) else [isos]
                lv = entry.get("levels", 0)
                lv = ([float(v) for v in lv] * 4)[:4] if isinstance(lv, list) \
                    else [float(lv)] * 4
                if fallback is None:
                    fallback = lv
                if iso in isos:
                    return lv
                lower = [i for i in isos if i <= iso]
                if lower and max(lower) > best_iso:
                    best_iso = max(lower)
                    best = lv
            return best or fallback
        return None

    def white_levels(self, iso=0):
        ranges = self.data.get("ranges")
        if isinstance(ranges, dict):
            lv = self._resolve_levels(ranges.get("white"), iso)
            if lv is not None:
                return lv
            wm = ranges.get("white_max")
            if wm is not None:
                return [float(wm)] * 4
        return None

    def black_levels(self, iso=0):
        ranges = self.data.get("ranges")
        if isinstance(ranges, dict):
            return self._resolve_levels(ranges.get("black"), iso)
        return None

    def dcraw_matrix(self):
        m = self.data.get("dcraw_matrix")
        return [float(v) for v in m] if m else None

    def pdaf(self):
        """(pattern row indices, offset) or None (camconst.json
        pdaf_pattern)."""
        pat = self.data.get("pdaf_pattern")
        if not pat:
            return None
        return [int(v) for v in pat], int(self.data.get("pdaf_offset", 0))


class CameraConstantsStore:
    def __init__(self):
        self._db: dict[str, CameraConst] = {}

    def load_json(self, path):
        # camconst.json allows // comments; strip them before parsing
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            text = f.read()
        data = json.loads(_strip_comments(text))
        for entry in data.get("camera_constants", []):
            mm = entry.get("make_model", "")
            models = mm if isinstance(mm, list) else [mm]
            for m in models:
                self._db[m.lower()] = CameraConst(dict(entry, make_model=m))

    def get(self, make: str, model: str) -> CameraConst | None:
        key = f"{make} {model}".strip().lower()
        return self._db.get(key)


_instance: CameraConstantsStore | None = None
# the batch queue's host threads plan at once: the store loads once
_instance_lock = threading.Lock()


def get_instance() -> CameraConstantsStore:
    """The store, loaded from the bundled data on first use."""
    global _instance
    with _instance_lock:
        if _instance is None:
            store = CameraConstantsStore()
            store.load_json(DATA)
            _instance = store
        return _instance
