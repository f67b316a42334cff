"""3D LUTs: Hald CLUT images, the .cube parser, tetrahedral and
trilinear interpolation (counterpart of ``art_tpu/color/lut3d.py``;
rtengine/clutstore.cc, LUT3D.cc).

The host loaders give an (n, n, n, 3) float32 table indexed [r][g][b]:
a Hald image through the port's own decoder (`io/imagefile.py::
read_rgb8`, what the reference asks PIL for), a .cube file by its text.
On the device each pixel gathers the 8 corners of its lattice cell from
the flat table and takes the tetrahedron that its fractions select, or
the trilinear blend (the reference packs the corners into rows and maps
over chunks to suit the TPU's gathers; the corners and the weights are
the same).
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


def load_hald_clut(path):
    """A Hald CLUT image -> (n, n, n, 3) table, level n = cbrt(pixels)
    (clutstore semantics: pixel p = r + n*g + n*n*b, row-major)."""
    from art_tpu_torch.io.imagefile import read_rgb8

    arr = read_rgb8(path).astype(np.float32) / 255.0
    npix = arr.shape[0] * arr.shape[1]
    n = round(npix ** (1.0 / 3.0))
    if n * n * n != npix:
        raise ValueError(f"not a Hald CLUT: {path}")
    table = arr.reshape(n, n, n, 3)  # [b][g][r]
    return np.ascontiguousarray(np.transpose(table, (2, 1, 0, 3)))


def load_lut3d(path):
    """A .cube file's table, or a Hald CLUT image's for any other
    extension."""
    if os.path.splitext(str(path))[1].lower() == ".cube":
        return load_cube(path)[0]
    return load_hald_clut(path)


def _cell(r, g, b, n):
    """Each value's lattice cell (flat index of its low corner) and its
    fractions in the cell, as the reference computes them."""
    dm1 = n - 1.0
    rr = torch.clamp(r, 0.0, 1.0).reshape(-1) * dm1
    gg = torch.clamp(g, 0.0, 1.0).reshape(-1) * dm1
    bb = torch.clamp(b, 0.0, 1.0).reshape(-1) * dm1
    r0 = torch.clamp(torch.floor(rr), max=dm1 - 1).to(torch.int32)
    g0 = torch.clamp(torch.floor(gg), max=dm1 - 1).to(torch.int32)
    b0 = torch.clamp(torch.floor(bb), max=dm1 - 1).to(torch.int32)
    base = ((r0 * n + g0) * n + b0).long()
    return base, rr - r0, gg - g0, bb - b0


def apply_tetrahedral(r, g, b, table):
    """Tetrahedral 3D LUT interpolation (LUT3D.cc apply_tetra): r, g, b in
    [0, 1] (clamped), table an (n, n, n, 3) tensor on their device.
    Returns (r', g', b')."""
    n = table.shape[0]
    flat = table.reshape(-1, 3)
    shape = r.shape
    base, fr, fg, fb = _cell(r, g, b, n)

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


def apply_trilinear(r, g, b, table):
    """Trilinear 3D LUT interpolation (CLF interpolation="trilinear"):
    the 8 corners weighed by the products of the fractions, summed in
    the reference's corner order."""
    n = table.shape[0]
    flat = table.reshape(-1, 3)
    shape = r.shape
    base, fr, fg, fb = _cell(r, g, b, n)
    fr, fg, fb = fr[:, None], fg[:, None], fb[:, None]
    out = 0.0
    for i in (0, 1):
        wi = fr if i else (1.0 - fr)
        for j in (0, 1):
            wj = fg if j else (1.0 - fg)
            for k in (0, 1):
                wk = fb if k else (1.0 - fb)
                out = out + flat[base + ((i * n + j) * n + k)] * (
                    wi * wj * wk)
    return tuple(out[:, c].reshape(shape) for c in range(3))
