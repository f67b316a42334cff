"""Writers of the JPEG forms Pillow cannot write, for the decoder tests:
a lossless (SOF3) writer in numpy, and the arithmetic-coded, CMYK and
YCCK files through ``tests/jpegwrite_helper.c``, compiled against the
system's libjpeg (its ``C_ARITH_CODING_SUPPORTED`` build)."""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

HELPER_SRC = Path(__file__).with_name("jpegwrite_helper.c")

# a DC table for the lossless categories 0..16: Annex K.3's luminance
# lengths, then 12..16 at 10..14 bits
_BITS = [0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0]
_VALS = list(range(17))


def _codes():
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(_BITS[length]):
            codes[_VALS[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _pack(vals, lens):
    """MSB-first bits of each (value, length), padded with ones, with
    0xFF bytes stuffed."""
    vals = np.asarray(vals, np.uint64)
    lens = np.asarray(lens, np.int64)
    shifts = np.arange(31, -1, -1, dtype=np.uint64)
    bits = ((vals[:, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    mask = np.arange(32)[None, :] >= (32 - lens[:, None])
    flat = bits[mask]
    flat = np.concatenate([flat, np.ones((-len(flat)) % 8, np.uint8)])
    return np.packbits(flat).tobytes().replace(b"\xff", b"\xff\x00")


def _predict(x, psv, pt, first_rows):
    """The predictions of each sample of one plane (int64): the first
    row (of the image and of each restart interval) from the initial
    value and the left sample, the first column from above."""
    h, w = x.shape
    ra = np.zeros_like(x)
    rb = np.zeros_like(x)
    rc = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb[1:] = x[:-1]
    rc[1:, 1:] = x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv].copy()
    pred[:, 0] = rb[:, 0]
    for y in first_rows:
        pred[y, 0] = 1 << (8 - pt - 1)
        pred[y, 1:] = x[y, :-1]
    return pred


def write_lossless(path, img, psv=1, pt=0, restart_rows=0, ids=None):
    """A lossless JPEG (SOF3, 8 bits, Huffman) of (H, W) or (H, W, C)
    uint8 `img`, predictor `psv`, point transform `pt`; a restart
    interval of `restart_rows` MCU rows (0: none); component IDs `ids`
    (default 1, 2, ...)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nc = img.shape
    ids = ids or list(range(1, nc + 1))
    x = img.astype(np.int64) >> pt
    first = [0] + (list(range(restart_rows, h, restart_rows))
                   if restart_rows else [])
    diffs = np.stack([x[..., c] - _predict(x[..., c], psv, pt, first)
                      for c in range(nc)], -1)
    diffs = ((diffs + 32767) % 65536) - 32767  # into -32767..32768
    codes = _codes()
    out = bytearray(b"\xff\xd8")
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + \
        bytes([nc]) + b"".join(bytes([ids[c], 0x11, 0]) for c in range(nc))
    out += b"\xff\xc3" + (len(sof) + 2).to_bytes(2, "big") + sof
    dht = bytes([0]) + bytes(_BITS[1:]) + bytes(_VALS)
    out += b"\xff\xc4" + (len(dht) + 2).to_bytes(2, "big") + dht
    if restart_rows:
        out += b"\xff\xdd\x00\x04" + (restart_rows * w).to_bytes(2, "big")
    sos = bytes([nc]) + b"".join(bytes([ids[c], 0]) for c in range(nc)) + \
        bytes([psv, 0, pt])
    out += b"\xff\xda" + (len(sos) + 2).to_bytes(2, "big") + sos
    bounds = first[1:] + [h]
    y0 = 0
    for k, y1 in enumerate(bounds):
        d = diffs[y0:y1].reshape(-1)
        mag = np.abs(d)
        cat = np.where(d == 32768, 16,
                       np.ceil(np.log2(mag + 1)).astype(np.int64))
        cat = np.where(mag == 0, 0, cat)
        extra = np.where(d > 0, d, d + (1 << cat) - 1) & ((1 << cat) - 1)
        extra = np.where(cat == 16, 0, extra)
        elen = np.where(cat == 16, 0, cat)
        hc = np.array([codes[c][0] for c in range(17)])[cat]
        hl = np.array([codes[c][1] for c in range(17)])[cat]
        vals = np.stack([hc, extra], 1).reshape(-1)
        lens = np.stack([hl, elen], 1).reshape(-1)
        keep = lens > 0
        out += _pack(vals[keep], lens[keep])
        if k < len(bounds) - 1:
            out += bytes([0xFF, 0xD0 + (k % 8)])
        y0 = y1
    out += b"\xff\xd9"
    Path(path).write_bytes(bytes(out))
    return path


_HELPER = None


def helper():
    """The compiled ``jpegwrite_helper`` (built once a process)."""
    global _HELPER
    if _HELPER is None:
        cc = shutil.which("gcc") or shutil.which("cc") or shutil.which("g++")
        out = Path(tempfile.mkdtemp(prefix="jpegwrite_")) / "jpegwrite_helper"
        subprocess.run([cc, "-O2", "-x", "c", "-o", str(out), str(HELPER_SRC),
                        "-ljpeg"], check=True, capture_output=True)
        _HELPER = str(out)
    return _HELPER


def write_libjpeg(path, img, space, arith=False, progressive=False,
                  quality=90, restart=0, sampling=(1, 1), adobe=True):
    """`img` ((H, W) grey, (H, W, 3) RGB or (H, W, 4) CMYK uint8) through
    libjpeg into a file of colour space `space` (gray, rgb, ycc, cmyk,
    ycck)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    nc = 1 if img.ndim == 2 else img.shape[2]
    fd, raw = tempfile.mkstemp(suffix=".raw")
    try:
        os.write(fd, img.tobytes())
        os.close(fd)
        subprocess.run([helper(), raw, str(path), str(w), str(h), str(nc),
                        space, str(int(arith)), str(int(progressive)),
                        str(quality), str(restart), str(sampling[0]),
                        str(sampling[1]), str(int(adobe))],
                       check=True, capture_output=True)
    finally:
        os.unlink(raw)
    return path
