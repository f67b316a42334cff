"""Glib-KeyFile-style parser/writer for `.arp` sidecars (a copy of
``art_tpu/params/keyfile.py``).

Reference sidecars are written by Glib's KeyFile (``procparams.cc``
load/save): ``[Group]`` headers, ``Key=value`` entries, ``#`` comments,
booleans as ``true``/``false``, double lists as ``;``-separated strings
(with a trailing ``;``). We re-implement the subset ART uses instead of
pulling in configparser, whose interpolation/duplicate handling differs.
"""

from __future__ import annotations


class KeyFile:
    def __init__(self):
        # group -> {key -> raw string value}; insertion ordered
        self.groups: dict[str, dict[str, str]] = {}

    # -- parsing -----------------------------------------------------------

    @classmethod
    def parse(cls, text: str) -> "KeyFile":
        kf = cls()
        current = None
        for raw_line in text.splitlines():
            line = raw_line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("[") and line.endswith("]"):
                current = line[1:-1]
                kf.groups.setdefault(current, {})
                continue
            if current is None or "=" not in line:
                continue
            key, _, value = line.partition("=")
            kf.groups[current][key.strip()] = value.strip()
        return kf

    @classmethod
    def load(cls, path) -> "KeyFile":
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            return cls.parse(f.read())

    # -- access ------------------------------------------------------------

    def has(self, group: str, key: str) -> bool:
        return group in self.groups and key in self.groups[group]

    def get_string(self, group: str, key: str, default: str = "") -> str:
        return self.groups.get(group, {}).get(key, default)

    def get_bool(self, group, key, default=False):
        v = self.groups.get(group, {}).get(key)
        if v is None:
            return default
        return v.lower() in ("true", "1", "yes")

    def get_int(self, group, key, default=0):
        v = self.groups.get(group, {}).get(key)
        if v is None:
            return default
        try:
            return int(float(v))
        except ValueError:
            return default

    def get_float(self, group, key, default=0.0):
        v = self.groups.get(group, {}).get(key)
        if v is None:
            return default
        try:
            return float(v)
        except ValueError:
            return default

    def get_double_list(self, group, key, default=()):
        v = self.groups.get(group, {}).get(key)
        if v is None:
            return list(default)
        out = []
        for tok in v.split(";"):
            tok = tok.strip()
            if tok:
                try:
                    out.append(float(tok))
                except ValueError:
                    pass
        if not out and v.strip():
            # modern ART packs value lists as base64 half-floats
            # (procparams.cc pack_list :96)
            return unpack_half_list(v.strip())
        return out

    # -- writing -----------------------------------------------------------

    def set(self, group, key, value):
        self.groups.setdefault(group, {})[key] = _format_value(value)

    def dump(self) -> str:
        lines = []
        for group, kv in self.groups.items():
            if lines:
                lines.append("")
            lines.append(f"[{group}]")
            for key, value in kv.items():
                lines.append(f"{key}={value}")
        return "\n".join(lines) + "\n"

    def save(self, path):
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.dump())


def _format_value(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (list, tuple)):
        # Glib double-list format: trailing separator included
        return ";".join(_format_number(v) for v in value) + ";"
    if isinstance(value, float):
        return _format_number(value)
    return str(value)


def _format_number(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def unpack_half_list(data: str):
    """Decode the reference's packed value list: base64 of little-endian
    IEEE half-floats (procparams.cc unpack_list :74)."""
    import base64

    import numpy as np

    try:
        buf = base64.b64decode(data, validate=True)
    except Exception:
        return []
    if len(buf) % 2:
        buf = buf[: len(buf) - 1]
    return [float(x) for x in np.frombuffer(buf, dtype="<f2")]


def pack_half_list(values):
    """Inverse of unpack_half_list (procparams.cc pack_list :96)."""
    import base64

    import numpy as np

    arr = np.asarray(list(values), dtype="<f2")
    return base64.b64encode(arr.tobytes()).decode("ascii")
