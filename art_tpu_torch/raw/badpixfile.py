"""User .badpixels files (a copy of the lookup in
``art_tpu/raw/badpixfile.py``; reference: dfmanager.cc scanBadPixelsFile).

A file named "<Make> <Model>.badpixels" in the dark-frames directory
lists known-bad sensor pixels. The port does not apply such a file; the
planner only asks whether one exists, to refuse the frame by name.
"""

from __future__ import annotations

import os


def user_config_dir():
    """The user's configuration directory (art_tpu/profiles.py:25)."""
    return os.environ.get(
        "ART_TPU_CONFIG",
        os.path.join(os.path.expanduser("~"), ".config", "art-tpu"))


def find_badpixels_for(make, model, search_dirs=None):
    """Locate "<make> <model>.badpixels" (case-insensitive)."""
    if search_dirs is None:
        search_dirs = [os.path.join(user_config_dir(), "darkframes")]
        env = os.environ.get("ART_TPU_DARKFRAMES")
        if env:
            search_dirs.insert(0, env)
    want = f"{make} {model}".strip().lower()
    for d in search_dirs:
        if not os.path.isdir(d):
            continue
        for n in os.listdir(d):
            if not n.lower().endswith(".badpixels"):
                continue
            if n[: -len(".badpixels")].strip().lower() == want:
                return os.path.join(d, n)
    return None
