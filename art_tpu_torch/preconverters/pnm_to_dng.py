#!/usr/bin/env python3
"""Example raw preconverter: 16-bit PGM (binary P5) mosaic -> Bayer DNG.

A copy of ``tools/preconverters/pnm_to_dng.py`` that writes its DNG with
the port's own writer (``art_tpu_torch/io/dngwrite.py``), so it runs
where only ``art_tpu_torch`` is installed. It is the shipped proof of
the `[ART RAWImageIO]` hook (art_tpu_torch/io/iomanager.py; reference
rtengine/imgiomanager.h:36-81): any format you can turn into a CFA
plane can enter the pipeline through a two-line config. Install:

    mkdir -p <user_dir>/imageio
    cp pnm.txt.example <user_dir>/imageio/pnm.txt   # adjust paths

Config (pnm.txt):
    [ART RAWImageIO]
    Extension=pgm
    ReadCommand=python3 /path/to/art_tpu_torch/preconverters/pnm_to_dng.py

Invocation contract (imgiomanager.cc): `cmd <input> <output.dng>`.
Pattern/black/white come from ART_PNM_PATTERN / ART_PNM_BLACK /
ART_PNM_WHITE env vars (defaults RGGB / 0 / maxval).
"""

import os
import re
import sys


def read_pgm16(path):
    with open(path, "rb") as f:
        data = f.read()
    m = re.match(rb"P5\s+(?:#[^\n]*\n\s*)*(\d+)\s+(\d+)\s+(\d+)\s",
                 data)
    if not m:
        raise SystemExit("pnm_to_dng: not a binary PGM (P5)")
    w, h, maxval = (int(m.group(i)) for i in (1, 2, 3))
    pix = data[m.end():]
    import numpy as np
    if maxval > 255:
        arr = np.frombuffer(pix[: w * h * 2], dtype=">u2").astype(
            np.uint16)
    else:
        arr = np.frombuffer(pix[: w * h], dtype=np.uint8).astype(
            np.uint16)
    if arr.size < w * h:
        raise SystemExit("pnm_to_dng: truncated PGM payload")
    return arr.reshape(h, w), maxval


def main():
    if len(sys.argv) != 3:
        raise SystemExit("usage: pnm_to_dng.py <input.pgm> <output.dng>")
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, here)
    from art_tpu_torch.io.dngwrite import write_dng

    mosaic, maxval = read_pgm16(sys.argv[1])
    pattern = os.environ.get("ART_PNM_PATTERN", "RGGB")
    black = float(os.environ.get("ART_PNM_BLACK", "0"))
    white = float(os.environ.get("ART_PNM_WHITE", str(maxval)))
    write_dng(sys.argv[2], mosaic, pattern=pattern, black=black,
              white=white)


if __name__ == "__main__":
    main()
