"""Image layout helpers (counterpart of ``art_tpu/core/image.py``).

Host padding and CFA indexing in numpy, CFA masks and X-Trans colour
indices as torch tensors, shifted views of a padded plane, and the
synthetic Bayer and X-Trans frames used by tests and the chip smoke run.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from art_tpu_torch.io.rawfile import RawFrame

MAXVAL = 65535.0

BAYER_PATTERNS = ("RGGB", "BGGR", "GRBG", "GBRG")


def pad_to_multiple(arr, multiple: int):
    """Reflect-pad the last two axes up to a multiple; returns (padded,
    orig_shape). Host numpy (art_tpu/core/image.py::pad_to_multiple)."""
    shape = arr.shape
    pads = [(0, 0)] * (arr.ndim - 2) + [
        (0, -n % multiple) for n in shape[-2:]]
    if all(p == (0, 0) for p in pads):
        return arr, shape
    return np.pad(arr, pads, mode="reflect"), shape


def bayer_color_index(pattern: str, shape):
    """Int array (H, W) with 0=R 1=G 2=B per CFA site (host numpy;
    art_tpu/core/image.py::bayer_color_index)."""
    h, w = shape
    rows = np.arange(h) % 2
    cols = np.arange(w) % 2
    idx2 = rows[:, None] * 2 + cols[None, :]
    lut = np.array(["RGB".index(c) for c in pattern], dtype=np.int32)
    return lut[idx2]


def xtrans_color_index(pattern6x6, shape):
    """Int array (H, W) 0/1/2 for an X-Trans 6x6 pattern (host numpy;
    art_tpu/core/image.py::xtrans_color_index)."""
    pat = np.asarray(pattern6x6, dtype=np.int32).reshape(6, 6)
    h, w = shape
    return pat[np.arange(h)[:, None] % 6, np.arange(w)[None, :] % 6]


def xtrans_color_index_device(pattern, shape, device, dy=0, dx=0):
    """(H, W) int64 colour index of the site (y + dy, x + dx) of an
    X-Trans pattern, built on `device` by a 6x6 lookup on the global
    coordinates modulo 6 (art_tpu/core/image.py::
    xtrans_color_index_device). The planner's reflect pad breaks the CFA
    period in the pad rows and columns; this index, like the
    reference's, does not follow it."""
    pat = torch.as_tensor(np.asarray(pattern, dtype=np.int64).reshape(6, 6),
                          device=device)
    h, w = shape
    ry = (torch.arange(h, device=device) + dy) % 6
    cx = (torch.arange(w, device=device) + dx) % 6
    return pat[ry[:, None], cx[None, :]]


def shifts(x, r, mode="reflect"):
    """sh(dy, dx) -> x shifted by (dy, dx) over one pad of `r` (reflect,
    edge as "replicate", or zeros as "constant"): the reference's
    `_shift`, which pads anew for every shift, with one pad a plane."""
    h, w = x.shape
    p = F.pad(x[None, None], (r, r, r, r), mode=mode)[0, 0]

    def sh(dy, dx):
        return p[r + dy: r + dy + h, r + dx: r + dx + w]

    return sh


def bayer_channel_masks(pattern: str, shape, device):
    """Boolean (R, G, B) masks of `shape` for a Bayer pattern string,
    built on `device`. "RGGB" means (0,0)=R (0,1)=G (1,0)=G (1,1)=B."""
    if pattern not in BAYER_PATTERNS:
        raise ValueError(f"not a Bayer pattern: {pattern!r}")
    h, w = shape
    rows = torch.arange(h, device=device) % 2
    cols = torch.arange(w, device=device) % 2
    idx2 = rows[:, None] * 2 + cols[None, :]
    masks = []
    for color in "RGB":
        m = torch.zeros((h, w), dtype=torch.bool, device=device)
        for pos, c in enumerate(pattern):
            if c == color:
                m |= idx2 == pos
        masks.append(m)
    return tuple(masks)


def synthesize_bayer(rgb01, pattern="RGGB", black=512.0, white=16383.0,
                     cam_mul=(2.0, 1.0, 1.5), noise=0.0, seed=0):
    """Mosaic a linear-sRGB [0,1] image into a synthetic Bayer RawFrame
    (art_tpu/io/rawfile.py::synthesize_bayer): WB division, CFA sampling,
    black/white encoding, identity camera matrix."""
    rgb01 = np.asarray(rgb01, dtype=np.float64)
    if rgb01.ndim != 3 or rgb01.shape[0] != 3:
        raise ValueError(f"want a (3, H, W) image, got {rgb01.shape}")
    _, h, w = rgb01.shape
    cam_mul = np.asarray(cam_mul, dtype=np.float64)
    sensor = rgb01 / cam_mul[:, None, None]
    cidx = bayer_color_index(pattern, (h, w))
    mosaic = np.take_along_axis(
        sensor.reshape(3, -1), cidx.reshape(1, -1), axis=0
    ).reshape(h, w)
    adu = mosaic * (white - black) + black
    if noise > 0:
        rng = np.random.default_rng(seed)
        adu = adu + rng.normal(0.0, noise, size=adu.shape)
    adu = np.clip(adu, 0, white)
    return RawFrame(
        cfa=adu.astype(np.float32),
        pattern=pattern,
        black=np.full(4, float(black)),
        white=np.full(4, float(white)),
        cam_mul=np.array([cam_mul[0], cam_mul[1], cam_mul[2], cam_mul[1]]),
        cam_xyz=None,
        make="ART-TPU", model="Synthetic",
        filename="<synthetic>",
    )


# the canonical Fuji X-Trans pattern (dcraw ordering, 0=R 1=G 2=B)
XTRANS_CANONICAL = (
    (1, 1, 0, 1, 1, 2),
    (1, 1, 2, 1, 1, 0),
    (2, 0, 1, 0, 2, 1),
    (1, 1, 2, 1, 1, 0),
    (1, 1, 0, 1, 1, 2),
    (0, 2, 1, 2, 0, 1),
)


def synthesize_xtrans(rgb01, black=512.0, white=16383.0,
                      cam_mul=(2.0, 1.0, 1.5), pattern=XTRANS_CANONICAL):
    """The X-Trans companion of synthesize_bayer
    (art_tpu/io/rawfile.py::synthesize_xtrans)."""
    rgb01 = np.asarray(rgb01, dtype=np.float64)
    _, h, w = rgb01.shape
    cam_mul = np.asarray(cam_mul, dtype=np.float64)
    sensor = rgb01 / cam_mul[:, None, None]
    cidx = xtrans_color_index(pattern, (h, w))
    mosaic = np.take_along_axis(
        sensor.reshape(3, -1), cidx.reshape(1, -1), axis=0
    ).reshape(h, w)
    adu = np.clip(mosaic * (white - black) + black, 0, white)
    return RawFrame(
        cfa=adu.astype(np.float32),
        pattern=None,
        xtrans=pattern,
        black=np.full(4, float(black)),
        white=np.full(4, float(white)),
        cam_mul=np.array([cam_mul[0], cam_mul[1], cam_mul[2], cam_mul[1]]),
        cam_xyz=None,
        make="ART-TPU", model="SyntheticXT",
        filename="<synthetic-xtrans>",
    )
