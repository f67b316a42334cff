"""B1's, B2's and B3's tiling on the CPU: each output tile of the fused
stage kernels is computed from the tile grown by its halo alone.

For every tile of the kernel's grid over the padded plane (S2_TILE,
ragged at the far edges), the window of the tile grown by S2_HALO is cut
from x and s1 with wrapped indices and given the Bayer pattern shifted to
the window's global origin; `stage2_plain` on that window must equal
`stage2_plain` on the whole plane over the tile, bit for bit.

The halo is x's reach through the intermediates the kernel holds: nyqf
over the tile grown by S2_HALO - 3 reads delhvsq by 2 more, which reads
x by 1 more. A halo one smaller gets nyqf wrong there. (The outputs
themselves need one less in a regular Bayer plane: the curvature reads
green0 at G sites, where it is x, and green0 by 3 at an R/B site is read
only where the seam of an odd-size plane puts two R/B sites side by
side; no data tried here shows it.) B3's tiles (S3_TILE over its output,
the plane cropped by HALO) need x by S3_HALO: the outputs' chroma at G
sites reads the propagation by 1, which reads dgrb0 by 3, which reads
rbint by 2, whose pmwt reads the diagonal variances by 1, which read the
squares by 2, which read x by 1. B1's tiles (S1_TILE over the padded
plane, cut with wrapped indices as B2's) need x by S1_HALO: hvwt reads
the selected vcd by 3 rows, which reads vcd and vcdalt by 2, which read
dirwts0 by 2, which reads x by 2. The tile and halo constants are read
from the wrapper, which mirrors those of ``csrc/amaze.cu``. No JAX here.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from art_tpu_torch.demosaic import amaze
from art_tpu_torch.demosaic import amaze_kernel as ak

CU = Path(ak.__file__).resolve().parents[1] / "csrc" / "amaze.cu"


def shifted_pattern(pattern, oy, ox):
    """The 2x2 pattern seen from a window whose origin is at (oy, ox)."""
    return "".join(pattern[((r + oy) % 2) * 2 + (c + ox) % 2]
                   for r in (0, 1) for c in (0, 1))


def _planes(pattern):
    """A padded plane of 96x160 with stage 1's planes: noise with a block
    of one-pixel stripes, so that the Nyquist test fires."""
    rng = np.random.default_rng(21)
    cfa = rng.uniform(0.01, 1.0, (48, 112)) * 65535
    cfa[8:30, 20:70] = np.where(np.arange(20, 70) % 2, 60000.0, 4000.0)
    x = amaze.padded_plane(torch.from_numpy(cfa.astype(np.float32)))
    s1 = amaze.stage1_plain(x, pattern,
                            amaze.clip_points(np.float32(1.0), "cpu"))
    return x, s1


def _tile_mismatches(x, pattern, halo, fn, planes=None, tile=ak.S2_TILE,
                     grow=0):
    """The tiles (y0, x0) of `tile`'s grid where fn(x, pattern, planes)
    on the window of `halo` (x and planes cut with wrapped indices)
    differs from fn on the whole plane over the tile grown by `grow`
    (fn's planes stacked on the first axis)."""
    th, tw = tile
    hp, wp = x.shape
    whole = fn(x, pattern, planes)
    bad = []
    for y0 in range(0, hp, th):
        for x0 in range(0, wp, tw):
            rows = torch.arange(y0 - halo, y0 + th + halo) % hp
            cols = torch.arange(x0 - halo, x0 + tw + halo) % wp
            win = fn(x[rows][:, cols].contiguous(),
                     shifted_pattern(pattern, y0 - halo, x0 - halo),
                     None if planes is None
                     else planes[:, rows][:, :, cols].contiguous())
            # the tile grown by `grow`, clipped at the plane's far edges
            h = min(th, hp - y0) + 2 * grow
            w = min(tw, wp - x0) + 2 * grow
            o = halo - grow
            want = whole[:, torch.arange(y0 - grow, y0 - grow + h) % hp][
                :, :, torch.arange(x0 - grow, x0 - grow + w) % wp]
            if not torch.equal(win[:, o:o + h, o:o + w], want):
                bad.append((y0, x0))
    return bad


def _nyqf(x, pattern, s1):
    return amaze.nyquist_masks(x, pattern, s1)[0][None]


@pytest.mark.parametrize("pattern", ["RGGB", "GBRG"])
def test_stage2_tiles_need_only_their_halo(pattern):
    x, s1 = _planes(pattern)
    assert x.shape == (96, 160)
    # the test fires: a share of nyquist2 pixels the kernel's list sees
    assert amaze.nyquist_masks(x, pattern, s1)[1].mean().item() > 0.01
    halo, stage2 = ak.S2_HALO, amaze.stage2_plain
    assert _tile_mismatches(x, pattern, halo, stage2, s1) == []
    # nyqf over the tile grown by halo - 3: right from its halo, and
    # wrong from one less
    assert _tile_mismatches(x, pattern, halo, _nyqf, s1,
                            grow=halo - 3) == []
    assert _tile_mismatches(x, pattern, halo - 1, _nyqf, s1,
                            grow=halo - 3) != []


def test_tile_constants_mirror_the_kernel():
    src = CU.read_text()
    th, tw = re.search(r"S2_TH = (\d+), S2_TW = (\d+);", src).groups()
    assert (int(th), int(tw)) == ak.S2_TILE
    assert int(re.search(r"\bR_X = (\d+)", src).group(1)) == ak.S2_HALO
    assert ak.SCRATCH["art_amaze_stage2"] == 0


def _stage3_planes(pattern, shape):
    """x, stage 2's planes and the clips of a mosaic of `shape` (noise
    with a block of one-pixel stripes), from the plain versions."""
    rng = np.random.default_rng(23)
    h, w = shape
    cfa = np.minimum(rng.uniform(0.01, 1.1, shape), 1.0) * 65535
    cfa[4:h // 2, 10:w // 2] = np.where(np.arange(10, w // 2) % 2, 60000.0,
                                        4000.0)
    x = amaze.padded_plane(torch.from_numpy(cfa.astype(np.float32)))
    clips = amaze.clip_points(np.float32(1.25), "cpu")
    s1 = amaze.stage1_plain(x, pattern, clips)
    return x, amaze.stage2_plain(x, pattern, s1), clips


def _stage3_tile_mismatches(x, s2, clips, pattern, halo):
    """The output tiles (k0, j0) of B3's grid where stage3_plain on the
    tile grown by `halo` differs from stage3_plain on the whole plane.
    B3's output is the padded plane cropped by HALO > its reach, so the
    window of a tile (ragged ones cut to the output) lies inside the
    plane: no wrapped index."""
    th, tw = ak.S3_TILE
    whole = amaze.stage3_plain(x, pattern, s2, clips)
    _, ho, wo = whole.shape
    bad = []
    for k0 in range(0, ho, th):
        for j0 in range(0, wo, tw):
            h, w = min(th, ho - k0), min(tw, wo - j0)
            y0, x0 = amaze.HALO + k0 - halo, amaze.HALO + j0 - halo
            rows = slice(y0, y0 + h + 2 * halo)
            cols = slice(x0, x0 + w + 2 * halo)
            win = amaze.stage3_plain(
                x[rows, cols].contiguous(), shifted_pattern(pattern, y0, x0),
                s2[:, rows, cols].contiguous(), clips, halo=halo)
            if not torch.equal(win, whole[:, k0:k0 + h, j0:j0 + w]):
                bad.append((k0, j0))
    return bad


# 57 x 131 pads to an odd 105 x 179: an output of 2 x 3 tiles, ragged at
# the bottom (25 rows) and the right (3 columns)
@pytest.mark.parametrize("pattern", ["RGGB", "GRBG", "GBRG", "BGGR"])
def test_stage3_tiles_need_only_their_halo(pattern):
    x, s2, clips = _stage3_planes(pattern, (57, 131))
    assert x.shape == (105, 179)
    halo = ak.S3_HALO
    assert halo < amaze.HALO
    assert _stage3_tile_mismatches(x, s2, clips, pattern, halo) == []
    # a halo one smaller misses x where rbint's pmwt reads it
    assert _stage3_tile_mismatches(x, s2, clips, pattern, halo - 1) != []


def test_stage3_tile_constants_mirror_the_kernel():
    src = CU.read_text()
    th, tw = re.search(r"S3_TH = (\d+), S3_TW = (\d+);", src).groups()
    assert (int(th), int(tw)) == ak.S3_TILE
    assert int(re.search(r"\bR3_X = (\d+)", src).group(1)) == ak.S3_HALO
    assert ak.SCRATCH["art_amaze_stage3"] == 0


# 58 x 132 pads to 106 x 180: 4 x 3 tiles of B1's grid over the padded
# plane, ragged at the bottom (10 rows) and the right (52 columns), the
# windows of the edge tiles reaching across the wrap. (An even plane: a
# window is given one shifted pattern, which the seam of an odd plane
# breaks; the card test holds the kernel there.) Gain 1.6 puts clip_pt8
# (0.5) and clip_pt (0.625) below much of x, so stage 2's clip mask and
# the bound's clip branch both fire; gain 1.0 leaves most of the plane
# unclipped
@pytest.mark.parametrize("pattern", ["RGGB", "GRBG", "GBRG", "BGGR"])
def test_stage1_tiles_need_only_their_halo(pattern):
    rng = np.random.default_rng(29)
    cfa = np.minimum(rng.uniform(0.01, 1.1, (58, 132)), 1.0) * 65535
    cfa[4:30, 10:70] = np.where(np.arange(10, 70) % 2, 60000.0, 4000.0)
    x = amaze.padded_plane(torch.from_numpy(cfa.astype(np.float32)))
    assert x.shape == (106, 180)

    def mismatches(gain, halo):
        clips = amaze.clip_points(np.float32(gain), "cpu")
        return _tile_mismatches(
            x, pattern, halo,
            lambda xw, pat, _: amaze.stage1_plain(xw, pat, clips),
            tile=ak.S1_TILE)

    hot = amaze.clip_points(np.float32(1.6), "cpu")
    assert (x > hot[1]).double().mean() > 0.2
    assert (x > hot[0]).double().mean() > 0.1
    assert mismatches(1.6, ak.S1_HALO) == []
    assert mismatches(1.0, ak.S1_HALO) == []
    # a halo one smaller misses x where dirwts0 is read by 7 rows (the
    # unclipped vcd by 5, whose variance picks the selected vcd by 3);
    # where the clip mask fires, vcd is vcdalt and reaches less far
    assert mismatches(1.0, ak.S1_HALO - 1) != []


def test_stage1_tile_constants_mirror_the_kernel():
    src = CU.read_text()
    th, tw = re.search(r"S1_TH = (\d+), S1_TW = (\d+);", src).groups()
    assert (int(th), int(tw)) == ak.S1_TILE
    assert int(re.search(r"\bR1_X = (\d+)", src).group(1)) == ak.S1_HALO
    assert int(re.search(r"\bS1_THREADS = (\d+);", src).group(1)) % 32 == 0
    assert ak.SCRATCH["art_amaze_stage1"] == 0
    # one kernel: the three passes of the first design are gone
    for name in ("s1_cd", "s1_select", "s1_hvwt"):
        assert name not in src
