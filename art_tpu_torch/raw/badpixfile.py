"""User .badpixels files (a copy of ``art_tpu/raw/badpixfile.py``;
reference: dfmanager.cc scanBadPixelsFile).

A file named "<Make> <Model>.badpixels" in the dark-frames directory
lists "x y" coordinates of known-bad sensor pixels (a single number on
the first line is a coordinate offset). The planner turns them into a
mask (`badpixel_mask`); the device program interpolates the marked
sites with the hot/dead filter's CFA-aware kernel
(`raw/badpixels.py::interpolate_bad_bayer`).
"""

from __future__ import annotations

import os

import numpy as np


def user_config_dir():
    """The user's configuration directory (art_tpu/profiles.py:25)."""
    return os.environ.get(
        "ART_TPU_CONFIG",
        os.path.join(os.path.expanduser("~"), ".config", "art-tpu"))


def parse_badpixels_file(path):
    """[(x, y), ...] from a .badpixels file."""
    pts = []
    offset = 0
    with open(path) as f:
        first = True
        for line in f:
            parts = line.split()
            nums = []
            for p in parts[:2]:
                try:
                    nums.append(int(p))
                except ValueError:
                    break
            if first and len(nums) == 1:
                offset = nums[0]
            elif len(nums) >= 2:
                pts.append((nums[0] + offset, nums[1] + offset))
            first = False
    return pts


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


def badpixel_mask(points, shape):
    """Boolean (H, W) mask from (x, y) points (out-of-range ignored)."""
    h, w = shape
    mask = np.zeros(shape, dtype=bool)
    for x, y in points:
        if 0 <= y < h and 0 <= x < w:
            mask[y, x] = True
    return mask
