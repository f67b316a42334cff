"""3D LUTs: the .cube parser and tetrahedral interpolation (counterpart
of ``art_tpu/color/lut3d.py``; rtengine/clutstore.cc, LUT3D.cc).

The host parser gives an (n, n, n, 3) float32 table indexed [r][g][b].
On the device each pixel gathers the 8 corners of its lattice cell from
the flat table and takes the tetrahedron that its fractions select (the
reference packs the corners into rows and maps over chunks to suit the
TPU's gathers; the corners and the six-way select are the same). A Hald
CLUT image needs an image decoder (PIL in the reference), which the port
does not carry.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def load_cube(path):
    """.cube parser (Adobe/Resolve format) -> ((n, n, n, 3) table,
    DOMAIN_MIN, DOMAIN_MAX)."""
    size = None
    data = []
    dmin = np.zeros(3)
    dmax = np.ones(3)
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0].upper()
            if key == "LUT_3D_SIZE":
                size = int(parts[1])
            elif key == "DOMAIN_MIN":
                dmin = np.array([float(v) for v in parts[1:4]])
            elif key == "DOMAIN_MAX":
                dmax = np.array([float(v) for v in parts[1:4]])
            elif key in ("TITLE", "LUT_1D_SIZE", "LUT_3D_INPUT_RANGE"):
                continue
            else:
                try:
                    data.append([float(v) for v in parts[:3]])
                except ValueError:
                    continue
    if size is None or len(data) < size ** 3:
        raise ValueError(f"invalid .cube file: {path}")
    arr = np.asarray(data[: size ** 3], dtype=np.float32)
    # cube order: r fastest, so [b][g][r]; transposed to [r][g][b]
    table = arr.reshape(size, size, size, 3)
    return np.ascontiguousarray(np.transpose(table, (2, 1, 0, 3))), dmin, dmax


def load_lut3d(path):
    """A .cube file's table; any other extension is a Hald CLUT image,
    which is not ported: one that exists raises NotImplementedError, a
    missing one OSError, on which the reference plans nothing."""
    if os.path.splitext(str(path))[1].lower() == ".cube":
        return load_cube(path)[0]
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    raise NotImplementedError(
        f"Hald CLUT image {path!r} (color/lut3d.py::load_hald_clut, an "
        "image decoder) is not ported to art_tpu_torch")


def apply_tetrahedral(r, g, b, table):
    """Tetrahedral 3D LUT interpolation (LUT3D.cc apply_tetra): r, g, b in
    [0, 1] (clamped), table an (n, n, n, 3) tensor on their device.
    Returns (r', g', b')."""
    n = table.shape[0]
    dm1 = n - 1.0
    flat = table.reshape(-1, 3)
    shape = r.shape
    rr = torch.clamp(r, 0.0, 1.0).reshape(-1) * dm1
    gg = torch.clamp(g, 0.0, 1.0).reshape(-1) * dm1
    bb = torch.clamp(b, 0.0, 1.0).reshape(-1) * dm1
    r0 = torch.clamp(torch.floor(rr), max=dm1 - 1).to(torch.int32)
    g0 = torch.clamp(torch.floor(gg), max=dm1 - 1).to(torch.int32)
    b0 = torch.clamp(torch.floor(bb), max=dm1 - 1).to(torch.int32)
    fr, fg, fb = rr - r0, gg - g0, bb - b0
    base = ((r0 * n + g0) * n + b0).long()

    def at(i, j, k):
        q = flat[base + ((i * n + j) * n + k)]
        return q[:, 0], q[:, 1], q[:, 2]

    c000, c111 = at(0, 0, 0), at(1, 1, 1)
    c100, c110, c010 = at(1, 0, 0), at(1, 1, 0), at(0, 1, 0)
    c011, c001, c101 = at(0, 1, 1), at(0, 0, 1), at(1, 0, 1)

    def tet(c0, cA, cB, c1, f0, fA, fB):
        return tuple(c0[c] * (1.0 - f0) + cA[c] * (f0 - fA)
                     + cB[c] * (fA - fB) + c1[c] * fB for c in range(3))

    t1 = tet(c000, c100, c110, c111, fr, fg, fb)  # r >= g >= b
    t2 = tet(c000, c100, c101, c111, fr, fb, fg)  # r >= b > g
    t3 = tet(c000, c001, c101, c111, fb, fr, fg)  # b > r >= g
    t4 = tet(c000, c001, c011, c111, fb, fg, fr)  # b > g > r
    t5 = tet(c000, c010, c011, c111, fg, fb, fr)  # g > b > r
    t6 = tet(c000, c010, c110, c111, fg, fr, fb)  # g > r, r >= b

    rge_g, gge_b, rge_b = fr >= fg, fg >= fb, fr >= fb
    outs = []
    for c in range(3):
        o = torch.where(
            rge_g & gge_b, t1[c], torch.where(
                rge_g & ~gge_b & rge_b, t2[c], torch.where(
                    rge_g & ~gge_b & ~rge_b, t3[c], torch.where(
                        ~rge_g & ~gge_b, t4[c], torch.where(
                            ~rge_g & gge_b & ~rge_b, t5[c], t6[c])))))
        outs.append(o.reshape(shape))
    return tuple(outs)
