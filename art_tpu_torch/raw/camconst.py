"""Camera constants DB (a copy of ``art_tpu/raw/camconst.py``, trimmed to
the lookup the port's planner makes: whether a camera has PDAF lines).

The data is the reference's bundled ``camconst.json``, shipped in
``art_tpu_torch/data/``.
"""

from __future__ import annotations

import json
import os

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


def get_instance() -> CameraConstantsStore:
    """The store, loaded from the bundled data on first use."""
    global _instance
    if _instance is None:
        store = CameraConstantsStore()
        store.load_json(DATA)
        _instance = store
    return _instance
