"""Profile store + dynamic profiles (a copy of ``art_tpu/profiles.py``).

Reference: rtengine/profilestore.cc (bundled + user .arp registry; partial
profiles applied over defaults) and rtengine/dynamicprofile.cc (rules in a
keyfile — groups "rule N" with <field>_min/_max ranges and _value/_enabled
string matches — picking the profile(s) applied to a raw by camera/ISO/
f-number/shutter/focal length).

The bundled profiles under art_tpu_torch/data/profiles are this project's own
presets (same .arp grammar as the reference, independent content).
"""

from __future__ import annotations

import dataclasses
import os
import re

from art_tpu_torch.params.keyfile import KeyFile
from art_tpu_torch.params.procparams import ProcParams

BUNDLED_DIR = os.path.join(os.path.dirname(__file__), "data", "profiles")


def user_config_dir():
    return os.environ.get(
        "ART_TPU_CONFIG",
        os.path.join(os.path.expanduser("~"), ".config", "art-tpu"))


class ProfileStore:
    """Registry of .arp profiles: bundled first, user dir overrides."""

    def __init__(self, extra_dirs=()):
        self.dirs = [BUNDLED_DIR,
                     os.path.join(user_config_dir(), "profiles")]
        self.dirs += list(extra_dirs)

    def list_profiles(self):
        out = {}
        for d in self.dirs:
            if not os.path.isdir(d):
                continue
            for root, _, names in os.walk(d):
                for n in sorted(names):
                    if n.endswith(".arp"):
                        rel = os.path.relpath(os.path.join(root, n), d)
                        out[rel[:-4]] = os.path.join(root, n)
        return out

    def resolve(self, name):
        """Profile name (or path) -> file path, or None."""
        if os.path.isfile(name):
            return name
        profiles = self.list_profiles()
        if name in profiles:
            return profiles[name]
        # the reference's GUI paths look like "${p}/name"
        base = name.split("/")[-1]
        return profiles.get(base)

    def load(self, name, base=None):
        """ProcParams with the named partial profile applied over `base`."""
        path = self.resolve(name)
        pp = base if base is not None else ProcParams()
        if path:
            pp.update_from_keyfile(KeyFile.load(path))
        return pp


_store = None


def get_store():
    global _store
    if _store is None:
        _store = ProfileStore()
    return _store


@dataclasses.dataclass
class DynamicRule:
    serial: int = 0
    iso: tuple = (0, 512000)
    fnumber: tuple = (0.0, 100.0)
    focallen: tuple = (0.0, 10000.0)
    shutterspeed: tuple = (0.0, 1000.0)
    camera: str | None = None  # exact or re: pattern, None = any
    profilepath: str = ""

    def matches(self, meta):
        def in_range(v, rng):
            return v is None or rng[0] <= v <= rng[1]

        if not in_range(meta.get("iso"), self.iso):
            return False
        if not in_range(meta.get("f_number"), self.fnumber):
            return False
        if not in_range(meta.get("focal_length"), self.focallen):
            return False
        if not in_range(meta.get("shutterspeed"), self.shutterspeed):
            return False
        if self.camera:
            cam = meta.get("camera", "")
            if self.camera.startswith("re:"):
                if not re.search(self.camera[3:], cam, re.IGNORECASE):
                    return False
            elif self.camera.lower() != cam.lower():
                return False
        return True


def load_dynamic_rules(path=None):
    """Parse dynamicprofile.cfg ("rule N" groups, dynamicprofile.cc:264)."""
    if path is None:
        path = os.path.join(user_config_dir(), "dynamicprofile.cfg")
    if not os.path.isfile(path):
        return []
    kf = KeyFile.load(path)
    rules = []
    for group in kf.groups:
        m = re.fullmatch(r"rule (\d+)", group)
        if not m:
            continue
        r = DynamicRule(serial=int(m.group(1)))

        def rng(key, default, cast=float):
            lo = kf.get_float(group, key + "_min") \
                if kf.has(group, key + "_min") else default[0]
            hi = kf.get_float(group, key + "_max") \
                if kf.has(group, key + "_max") else default[1]
            return (cast(lo), cast(hi))

        r.iso = rng("iso", r.iso, int)
        r.fnumber = rng("fnumber", r.fnumber)
        r.focallen = rng("focallen", r.focallen)
        r.shutterspeed = rng("shutterspeed", r.shutterspeed)
        if (kf.has(group, "camera_enabled")
                and kf.get_bool(group, "camera_enabled")
                and kf.has(group, "camera_value")):
            r.camera = kf.get_string(group, "camera_value")
        if kf.has(group, "profilepath"):
            r.profilepath = kf.get_string(group, "profilepath")
        rules.append(r)
    rules.sort(key=lambda r: r.serial)
    return rules


def _frame_meta(frame):
    ex = getattr(frame, "exif", {}) or {}

    def num(v):
        if isinstance(v, tuple) and len(v) == 2:
            return v[0] / max(v[1], 1)
        return v if isinstance(v, (int, float)) else None

    return {
        "iso": getattr(frame, "iso", None),
        "f_number": num(ex.get("f_number")),
        "focal_length": num(ex.get("focal_length")),
        "shutterspeed": num(ex.get("exposure_time")),
        "camera": f"{getattr(frame, 'make', '')} "
                  f"{getattr(frame, 'model', '')}".strip(),
    }


def default_params_for(frame, default_profile="Neutral", rules_path=None):
    """The reference's -d semantics: dynamic rules if any match, else the
    default raw profile, applied over ProcParams defaults."""
    store = get_store()
    pp = store.load(default_profile)
    meta = _frame_meta(frame)
    for rule in load_dynamic_rules(rules_path):
        if rule.matches(meta) and rule.profilepath:
            pp = store.load(rule.profilepath, base=pp)
    return pp
