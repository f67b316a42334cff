"""The port's TIFF reader (`art_tpu_torch/io/tiff.py`, `io/ojpeg.py`,
`io/native/tiffdec.cc`) against Pillow 12.1.0 with libtiff 4.7.1, bit for
bit: Pillow's mode and samples (`np.asarray(Image.open(...))`), its
``convert("RGB")``, or its error class, and the reference's loaders.

- every key of Pillow's OPEN_INFO, both byte orders where it names both,
  uncompressed and under deflate, LZW, PackBits, LZMA and ZSTD (the
  compressed bytes from zlib, lzma, zstandard and the LZW and PackBits
  writers of util_tiff);
- files Pillow's libtiff writes: CCITT RLE, RLEW, Group 3 (1D and 2D),
  Group 4, LZMA, ZSTD, JPEG of one to four samples, the predictors;
- ZSTD frames from zstandard at levels 1-19 and more, decoded by the
  native codec;
- hand-built ThunderScan, old-style JPEG (the interchange stream and the
  tables), YCbCr at each subsampling with its coefficients;
- faults C13 (premultiplied alpha), C14 (FillOrder 2) and C15 (Pillow's
  error classes), each by name;
- damaged ZSTD, Group 4 and old-style JPEG files;
- the reference's `load_std_image`, Hald, mask and PSF loaders;
- the committed fixtures and chip_smoke.py's V1 tiling and V2 files.
"""

import hashlib
import io
import json
import lzma
import os
import struct
import tempfile
import warnings
import zlib

import numpy as np
import pytest
import zstandard
from PIL import Image

import chip_smoke
import util_tiff as U
from art_tpu_torch.io import stdformats, tiff
from art_tpu_torch.io.imagefile import (load_std_image, read_grey, read_image,
                                        read_rgb8)
from util_tiff import LONG, RATIONAL, SHORT

DATA = os.path.join(os.path.dirname(__file__), "data")
COMPRESSIONS = (1, 8, 5, 32773, 34925, 50000)


def _pil(data):
    """("ok", mode, samples, convert("RGB")) or ("open"|"load", error
    class) of the bytes as a file Pillow opens by its path, as the
    reference's loaders do."""
    fd, path = tempfile.mkstemp(suffix=".tif")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                im = Image.open(path)
            except Exception as e:
                return ("open", type(e))
            with im:
                try:
                    im.load()
                    return ("ok", im.mode, np.asarray(im),
                            np.asarray(im.convert("RGB")))
                except Exception as e:
                    return ("load", type(e))
    finally:
        os.unlink(path)


def _port(data):
    try:
        mode, arr, pal, _ = tiff.load(data)
    except Exception as e:
        return ("err", type(e))
    return ("ok", mode, arr, tiff.to_rgb(mode, arr, pal))


def _same_error(pil_stage, pil_cls, port_cls):
    """Pillow's error against the port's: an open Pillow fails is
    Unidentified; a load that fails with an OSError is an OSError other
    than Unidentified; a ValueError is a ValueError."""
    if issubclass(port_cls, NotImplementedError):
        return False
    if pil_stage == "open":
        return issubclass(port_cls, stdformats.Unidentified) or (
            issubclass(pil_cls, ValueError)
            and issubclass(port_cls, ValueError))
    if issubclass(pil_cls, OSError):
        return issubclass(port_cls, OSError) and \
            not issubclass(port_cls, stdformats.Unidentified)
    return issubclass(port_cls, pil_cls.__mro__[1]) or \
        issubclass(port_cls, pil_cls)


def check(data):
    """The port's load against Pillow's; Pillow's outcome."""
    want, got = _pil(data), _port(data)
    if want[0] != "ok":
        assert got[0] == "err", (want, got[:2])
        assert _same_error(want[0], want[1], got[1]), (want, got)
        return want[0]
    assert got[0] == "ok", (want[:2], got)
    assert got[1] == want[1]
    assert got[2].dtype == want[2].dtype and got[2].shape == want[2].shape
    assert np.array_equal(got[2], want[2], equal_nan=True)
    np.testing.assert_array_equal(got[3], want[3])
    return "ok"


def check_file(data, tmp_path, name="a.tif"):
    """`check`, then the readers on a file: read_rgb8 as Pillow's
    convert("RGB"), read_image's mode and samples, read_grey as the
    reference's mask rule."""
    outcome = check(data)
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    if outcome != "ok":
        return outcome
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        im = Image.open(path)
        im.load()
        np.testing.assert_array_equal(read_rgb8(path),
                                      np.asarray(im.convert("RGB")))
        mode, samples, _ = read_image(path)
        if im.mode in ("I;16", "I;16B", "I", "F"):
            assert mode == im.mode
            np.testing.assert_array_equal(samples, np.asarray(im))
        else:
            assert mode == "RGB"
        g = im if im.mode in ("L", "I;16", "F") else im.convert("RGB")
        a = np.asarray(g)
        grey, gmode = read_grey(path)
        assert gmode == (im.mode if im.mode in ("L", "I;16", "F") else "L")
        np.testing.assert_array_equal(grey, a[..., 1] if a.ndim == 3 else a)
    return outcome


def _flip(data):
    return tiff._BITFLIP[np.frombuffer(data, np.uint8)].tobytes()


def _compress(raw, comp, level=3):
    if comp == 8:
        return zlib.compress(raw)
    if comp == 5:
        return U.lzw(raw)
    if comp == 32773:
        return U.packbits(raw)
    if comp == 34925:
        return lzma.compress(raw, format=lzma.FORMAT_XZ)
    if comp == 50000:
        return zstandard.ZstdCompressor(level=level).compress(raw)
    return raw


def key_file(key, comp, h=9, w=13, rows=5, seed=0):
    """A TIFF of OPEN_INFO key `key` under compression `comp`: random
    samples of its bits and sample format, in strips of `rows` rows."""
    order, photo, fmt, fill, bps, extra = key
    le = order == "I"
    rng = np.random.default_rng(seed)
    spp, bits = len(bps), bps[0]
    if fmt[0] == 3:
        samples = rng.normal(0, 300, (h, w, spp)).astype(np.float32)
    elif fmt[0] == 2:
        samples = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1),
                               (h, w, spp)).astype(f"i{bits // 8}")
    elif bits in (8, 16, 32):
        samples = rng.integers(0, 1 << bits, (h, w, spp),
                               dtype=np.uint64).astype(f"u{bits // 8}")
    else:
        samples = rng.integers(0, 1 << bits, (h, w, spp))
    tags = {256: (SHORT, (w,)), 257: (SHORT, (h,)), 258: (SHORT, bps),
            259: (SHORT, (comp,)), 262: (SHORT, (photo,)),
            277: (SHORT, (spp,)), 278: (SHORT, (rows,)),
            266: (SHORT, (fill,)), 339: (SHORT, fmt * spp)}
    if extra:
        tags[338] = (SHORT, extra)
    if photo == 3:
        tags[320] = (SHORT, tuple(int(v) for v in rng.integers(
            0, 65536, 3 * (1 << bits))))
    if photo == 6:
        tags[530] = (SHORT, (1, 1))
    strips = []
    for y in range(0, h, rows):
        raw = _compress(U.rows_bytes(samples[y : y + rows], bits, le), comp)
        if fill == 2 and comp != 1:  # libtiff reverses before decoding
            raw = _flip(raw)
        strips.append(raw)
    return U.build(tags, strips, le=le)


# -- (a) every OPEN_INFO key --------------------------------------------------

KEYS = sorted(tiff.OPEN_INFO, key=repr)


def test_open_info_is_pillows():
    from PIL import TiffImagePlugin as T

    want = {(k[0].decode()[0], *k[1:]): v for k, v in T.OPEN_INFO.items()}
    assert tiff.OPEN_INFO == want and len(KEYS) == 120
    assert tiff.COMPRESSION_INFO == T.COMPRESSION_INFO


@pytest.mark.parametrize("key", KEYS, ids=repr)
def test_open_info_key(key, tmp_path):
    """Each key uncompressed and under the five codecs: Pillow's mode,
    samples and convert("RGB") or its error class; the readers on the
    deflate file."""
    for comp in COMPRESSIONS:
        data = key_file(key, comp, seed=hash((key, comp)) % 1000)
        if comp == 8:
            check_file(data, tmp_path)
        else:
            check(data)


# -- (b) files Pillow's libtiff writes ---------------------------------------

RNG = np.random.default_rng(3)
BW = Image.fromarray(RNG.integers(0, 2, (48, 64), dtype=np.uint8) * 255
                     ).convert("1")
_T = np.full((48, 64), 255, np.uint8)
_T[10:20, 5:50] = 0
_T[30:35, ::3] = 0
TEXT = Image.fromarray(_T).convert("1")
RGB = Image.fromarray(RNG.integers(0, 256, (48, 64, 3), dtype=np.uint8))
GREY = Image.fromarray((np.add.outer(np.arange(48), np.arange(64)) * 2
                        % 256).astype(np.uint8))
FLOAT = Image.fromarray(RNG.normal(0, 100, (48, 64)).astype(np.float32))
I16 = Image.fromarray(RNG.integers(0, 65535, (48, 64), dtype=np.uint16))

WRITTEN = {
    "group3": (BW, {"compression": "group3"}),
    "group3 2D": (BW, {"compression": "group3", "tiffinfo": {292: 1}}),
    "group3 2D fill bits": (TEXT, {"compression": "group3",
                                   "tiffinfo": {292: 5}}),
    "group4": (BW, {"compression": "group4"}),
    "group4 text": (TEXT, {"compression": "group4"}),
    "group4 fill order 2": (BW, {"compression": "group4",
                                 "tiffinfo": {266: 2}}),
    "tiff_ccitt": (BW, {"compression": "tiff_ccitt"}),
    "tiff_ccitt text": (TEXT, {"compression": "tiff_ccitt"}),
    "tiff_raw_16": (BW, {"compression": "tiff_raw_16"}),
    "tiff_raw_16 text": (TEXT, {"compression": "tiff_raw_16"}),
    "lzma RGB": (RGB, {"compression": "lzma"}),
    "lzma L": (GREY, {"compression": "lzma"}),
    "zstd RGB": (RGB, {"compression": "zstd"}),
    # libtiff's pseudo-tags TIFFTAG_ZSTD_LEVEL and TIFFTAG_LZMAPRESET
    "zstd RGB level 1": (RGB, {"compression": "zstd",
                               "tiffinfo": {65564: 1}}),
    "zstd RGB level 9": (RGB, {"compression": "zstd",
                               "tiffinfo": {65564: 9}}),
    "zstd RGB level 19": (RGB, {"compression": "zstd",
                                "tiffinfo": {65564: 19}}),
    "zstd L level 22": (GREY, {"compression": "zstd",
                               "tiffinfo": {65564: 22}}),
    "lzma RGB preset 0": (RGB, {"compression": "lzma",
                                "tiffinfo": {65562: 0}}),
    "lzma L preset 9": (GREY, {"compression": "lzma",
                               "tiffinfo": {65562: 9}}),
    "zstd L": (GREY, {"compression": "zstd"}),
    "jpeg RGBA": (Image.fromarray(RNG.integers(0, 256, (48, 64, 4),
                                               dtype=np.uint8)),
                  {"compression": "jpeg"}),
    "jpeg CMYK": (Image.fromarray(RNG.integers(0, 256, (48, 64, 4),
                                               dtype=np.uint8), "CMYK"),
                  {"compression": "jpeg"}),
    "jpeg LA": (Image.fromarray(RNG.integers(0, 256, (48, 64, 2),
                                             dtype=np.uint8), "LA"),
                {"compression": "jpeg"}),
    "jpeg LAB": (RGB.convert("LAB"), {"compression": "jpeg"}),
    "jpeg YCbCr": (RGB.convert("YCbCr"), {"compression": "jpeg"}),
    "lzw YCbCr": (RGB.convert("YCbCr"), {"compression": "tiff_lzw"}),
    "zstd YCbCr": (RGB.convert("YCbCr"), {"compression": "zstd"}),
    "predictor 3 deflate": (FLOAT, {"compression": "tiff_adobe_deflate",
                                    "tiffinfo": {317: 3}}),
    "predictor 3 zstd": (FLOAT, {"compression": "zstd",
                                 "tiffinfo": {317: 3}}),
    "predictor 3 lzma": (FLOAT, {"compression": "lzma",
                                 "tiffinfo": {317: 3}}),
    "predictor 2 zstd RGB": (RGB, {"compression": "zstd",
                                   "tiffinfo": {317: 2}}),
    "predictor 2 deflate I;16": (I16, {"compression": "tiff_adobe_deflate",
                                       "tiffinfo": {317: 2}}),
    "predictor 2 lzma I;16": (I16, {"compression": "lzma",
                                    "tiffinfo": {317: 2}}),
}


def _pil_bytes(img, **kw):
    bio = io.BytesIO()
    img.save(bio, "TIFF", **kw)
    return bio.getvalue()


# Pillow's libtiff writes RLEW rows word-aligned in its buffer and reads
# them aligned in the file; this one its own load cannot finish
LOAD_FAILS = {"tiff_raw_16 text"}


@pytest.mark.parametrize("name", sorted(WRITTEN))
def test_files_pillow_writes(name, tmp_path):
    img, kw = WRITTEN[name]
    want = "load" if name in LOAD_FAILS else "ok"
    assert check_file(_pil_bytes(img, **kw), tmp_path) == want


# -- (c) ZSTD frames ----------------------------------------------------------

def _zstd_inputs():
    rng = np.random.default_rng(7)
    return {
        "few symbols": rng.integers(0, 4, 20000, dtype=np.uint8).tobytes(),
        "long matches": (os.urandom(0) + bytes(rng.integers(
            0, 256, 3000, dtype=np.uint8)) + b"abc" * 9000 + bytes(
                rng.integers(0, 256, 2000, dtype=np.uint8))),
        "incompressible": bytes(rng.integers(0, 256, 150000,
                                             dtype=np.uint8)),
        "smooth": (np.sin(np.arange(300000) / 50) * 100 + 100).astype(
            np.uint8).tobytes(),
        "repeats far apart": bytes(rng.integers(0, 256, 70, dtype=np.uint8))
        * 3000,
        "mixed spans": b"".join(
            bytes(rng.integers(0, 256, int(rng.integers(1, 40)),
                               dtype=np.uint8)) * int(rng.integers(1, 30))
            for _ in range(3000)),
    }


def _zstd_native(frame, n):
    return tiff._native(tiff._lib().tiffdec_zstd, frame, n)


@pytest.mark.parametrize("level", list(range(1, 20)) + [-5])
def test_zstd_frames(level):
    """Every input at the level, with and without the content size and
    checksum, and from the streaming compressor (no content size), equal
    to the input byte for byte."""
    for data in _zstd_inputs().values():
        for flags in (True, False):
            c = zstandard.ZstdCompressor(level=level, write_checksum=flags,
                                         write_content_size=flags)
            assert _zstd_native(c.compress(data), len(data)) == data
        obj = zstandard.ZstdCompressor(level=level).compressobj()
        frame = obj.compress(data) + obj.flush()
        assert _zstd_native(frame, len(data)) == data


def test_zstd_long_window():
    """Long-distance matching with a 4 MiB window, a frame of many
    blocks, and a strip shorter than the frame (libzstd stops once the
    strip is full)."""
    rng = np.random.default_rng(8)
    chunk = bytes(rng.integers(0, 256, 600000, dtype=np.uint8))
    data = chunk + bytes(300000) + chunk
    params = zstandard.ZstdCompressionParameters.from_level(
        19, window_log=22, enable_ldm=True)
    frame = zstandard.ZstdCompressor(compression_params=params).compress(data)
    assert _zstd_native(frame, len(data)) == data
    assert _zstd_native(frame, 1000) == data[:1000]
    with pytest.raises(tiff._Broken):
        _zstd_native(frame, len(data) + 1)


@pytest.mark.parametrize("level", [1, 9, 19])
def test_zstd_tiff_levels(level, tmp_path):
    rgb = np.asarray(RGB)
    data = U.build({256: (SHORT, (64,)), 257: (SHORT, (48,)),
                    258: (SHORT, (8, 8, 8)), 259: (SHORT, (50000,)),
                    262: (SHORT, (2,)), 277: (SHORT, (3,)),
                    278: (SHORT, (20,))},
                   [zstandard.ZstdCompressor(level=level).compress(
                       rgb[y : y + 20].tobytes()) for y in range(0, 48, 20)])
    assert check_file(data, tmp_path) == "ok"


# -- (d) ThunderScan, old-style JPEG, YCbCr ----------------------------------

def _thunder(seed, h=21, w=31, rows=None, photo=1, bits=4):
    rng = np.random.default_rng(seed)
    g = np.clip(np.cumsum(rng.integers(-1, 2, (h, w)), 1) + 8, 0, 15
                ).astype(np.uint8)
    g[3, 5:20] = g[3, 4]
    g[5] = g[5, 0]
    rows = rows or h
    tags = {256: (SHORT, (w,)), 257: (SHORT, (h,)), 258: (SHORT, (bits,)),
            259: (SHORT, (32809,)), 262: (SHORT, (photo,)),
            277: (SHORT, (1,)), 278: (SHORT, (rows,))}
    return U.build(tags, [U.thunderscan(g[y : y + rows])
                          for y in range(0, h, rows)]), g


@pytest.mark.parametrize("seed", range(4))
def test_thunderscan(seed, tmp_path):
    data, g = _thunder(seed, w=31 + seed, rows=8 if seed % 2 else None,
                       photo=seed % 2)
    assert check_file(data, tmp_path) == "ok"
    mode, arr, _, _ = tiff.load(data)
    want = g * 17 if seed % 2 else 255 - g * 17  # photometric 1 or 0
    np.testing.assert_array_equal(arr, want)


def test_thunderscan_damaged_and_8_bit():
    """A strip cut short fails ("Not enough data"), as 8-bit ThunderScan
    (its decoder reads only 4 bits) does."""
    data, g = _thunder(0)
    t = tiff.open_tiff(data)
    tags = {256: (SHORT, (31,)), 257: (SHORT, (21,)), 258: (SHORT, (4,)),
            259: (SHORT, (32809,)), 262: (SHORT, (1,)),
            277: (SHORT, (1,)), 278: (SHORT, (21,))}
    strip = data[t.offsets[0] : t.offsets[0] + t.counts[0]]
    assert check(U.build(tags, [strip[:-5]])) == "load"
    assert check(_thunder(0, bits=8)[0]) == "load"


PIC = np.clip(np.stack(np.meshgrid(np.arange(48) * 5, np.arange(32) * 7),
                       -1).sum(-1)[..., None] * np.array([1, 2, 3]) % 256
              + np.random.default_rng(0).integers(-20, 20, (32, 48, 3)),
              0, 255).astype(np.uint8)
ODD = np.random.default_rng(1).integers(0, 256, (37, 45, 3), dtype=np.uint8)
OJPEG = {
    "interchange 4:4:4": lambda: U.ojpeg_jif(PIC, 0),
    "interchange 4:2:2": lambda: U.ojpeg_jif(PIC, 1),
    "interchange 4:2:0": lambda: U.ojpeg_jif(PIC, 2),
    "interchange 4:2:0 odd size": lambda: U.ojpeg_jif(ODD, 2),
    "tables 4:4:4": lambda: U.ojpeg_tables(PIC, 0),
    "tables 4:2:2": lambda: U.ojpeg_tables(PIC, 1),
    "tables 4:2:0": lambda: U.ojpeg_tables(PIC, 2),
    "tables 4:2:0 odd size": lambda: U.ojpeg_tables(ODD, 2),
    "tables, a strip a restart interval": lambda: U.ojpeg_tables(
        np.random.default_rng(2).integers(0, 256, (64, 48, 3),
                                          dtype=np.uint8), 2, 16, 3),
}


@pytest.mark.parametrize("name", sorted(OJPEG))
def test_old_style_jpeg(name, tmp_path):
    assert check_file(OJPEG[name](), tmp_path) == "ok"


@pytest.mark.parametrize("rows", [8, 16, 24, 32])
@pytest.mark.parametrize("form", ["4:4:4", "4:2:2", "4:2:0", "grey tables",
                                  "grey interchange"])
def test_c17_rows_per_strip_names_more_strips_than_held(form, rows,
                                                        tmp_path):
    """One strip of entropy data holding the whole 48x64 image, and
    RowsPerStrip naming 2 to 8 strips: libtiff pads the offsets with
    zeros, tif_ojpeg sets a restart interval of a strip's MCUs, checks
    that a strip is whole MCU rows, and inserts a restart marker after
    the strip it holds. The first missing strip runs out of data (its
    rows are zero blocks in Pillow's RGBA path, a failed strip in the
    grey one) and the next one fails the load: Pillow's array or its
    error, by path."""
    rng = np.random.default_rng(5)
    if form.startswith("grey"):
        g = rng.integers(0, 256, (64, 48), dtype=np.uint8)
        data = U.ojpeg_grey(g, 1, tables=form == "grey tables", rows=rows)
    else:
        rgb = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
        data = U.ojpeg_tables(rgb, ("4:4:4", "4:2:2", "4:2:0").index(form),
                              rows=rows)
    assert len(tiff.open_tiff(data).offsets) == 1
    want = "ok" if rows == 32 and not form.startswith("grey") else "load"
    assert check_file(data, tmp_path) == want


@pytest.mark.parametrize("restart", [2, 3, 6])
@pytest.mark.parametrize("rows", [8, 16, 24, 32, 64])
@pytest.mark.parametrize("form", ["4:4:4", "4:2:2", "4:2:0", "grey tables",
                                  "grey interchange"])
def test_c21_strips_not_the_ones_rows_per_strip_names(form, rows, restart,
                                                      tmp_path):
    """A 48x64 picture whose strips are restart intervals of 2, 3 or 6
    MCUs, under a RowsPerStrip of 8-64 rows: libtiff reads only the
    strips RowsPerStrip names; where a strip is shorter than the image,
    tif_ojpeg sets a restart interval of a strip's MCUs (an interchange
    stream's own DRI wins); libjpeg skips to a restart marker past the
    interval's data and fills a short interval with zeros; an unexpected
    marker fails the decode in tif_ojpeg's resync (RGBA: that strip and
    those after it are zero; grey: the load fails). Pillow's array or its
    error, by path."""
    rng = np.random.default_rng(5)
    if form.startswith("grey"):
        g = rng.integers(0, 256, (64, 48), dtype=np.uint8)
        data = U.ojpeg_grey(g, 1, tables=form == "grey tables", rows=rows,
                            restart=restart)
    else:
        rgb = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
        data = U.ojpeg_tables(rgb, ("4:4:4", "4:2:2", "4:2:0").index(form),
                              rows=rows, restart=restart)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            path = str(tmp_path / "a.tif")
            with open(path, "wb") as f:
                f.write(data)
            Image.open(path).load()
            want = "ok"
        except OSError:
            want = "load"
    assert check_file(data, tmp_path) == want


def test_old_style_jpeg_close_to_its_source():
    """The interchange form at 4:4:4: a few codes from the picture (JPEG
    at quality 85 and libtiff's YCbCr tables)."""
    _, arr, _, _ = tiff.load(U.ojpeg_jif(PIC, 0))
    assert np.abs(arr.astype(int) - PIC).mean() < 10


SUBSAMPLINGS = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (4, 4),
                (2, 4), (3, 1)]


@pytest.mark.parametrize("hs,vs", SUBSAMPLINGS)
def test_ycbcr_subsampling(hs, vs, tmp_path):
    """Photometric 6 under deflate and LZW at each subsampling (libtiff
    converts 1, 2 and 4 with vertical at most horizontal, and 1x2; the
    rest fail its RGBA interface), with the default and with BT.709's
    coefficients and studio-range ReferenceBlackWhite."""
    h, w = 21, 31
    rng = np.random.default_rng(hs * 10 + vs)
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    shape = ((h + vs - 1) // vs, (w + hs - 1) // hs)
    cb = rng.integers(0, 256, shape, dtype=np.uint8)
    cr = rng.integers(0, 256, shape, dtype=np.uint8)
    blocks = U.ycbcr_blocks(y, cb, cr, hs, vs)
    rows = 2 * vs
    outcomes = set()
    for comp in (8, 5):
        tags = {256: (SHORT, (w,)), 257: (SHORT, (h,)),
                258: (SHORT, (8, 8, 8)), 259: (SHORT, (comp,)),
                262: (SHORT, (6,)), 277: (SHORT, (3,)),
                278: (SHORT, (rows,)), 530: (SHORT, (hs, vs))}
        strips = [_compress(blocks[r // vs : (r + rows) // vs].tobytes(),
                            comp) for r in range(0, h, rows)]
        outcomes.add(check_file(U.build(tags, strips), tmp_path))
        tags[532] = (RATIONAL, ((16, 1), (235, 1), (128, 1), (240, 1),
                                (128, 1), (240, 1)))
        tags[529] = (RATIONAL, ((2126, 10000), (7152, 10000), (722, 10000)))
        outcomes.add(check(U.build(tags, strips)))
    assert outcomes == {"ok" if (hs, vs) in tiff._SUBSAMPLINGS else "load"}


def _ycbcr_blocks(h, w, hs, vs, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    shape = ((h + vs - 1) // vs, (w + hs - 1) // hs)
    cb = rng.integers(0, 256, shape, dtype=np.uint8)
    cr = rng.integers(0, 256, shape, dtype=np.uint8)
    return U.ycbcr_blocks(y, cb, cr, hs, vs)


@pytest.mark.parametrize("w", [31, 3])
@pytest.mark.parametrize("hs,vs", SUBSAMPLINGS)
def test_ycbcr_subsampling_predictor(hs, vs, w, tmp_path):
    """Photometric 6 with predictor 2 under deflate and ZSTD: libtiff
    sums each rowsize, a block row's bytes over the vertical sampling
    (TIFFScanlineSize), three bytes a step, and reads that many bytes a
    strip; where the rowsize is not whole pixels horAcc8 fails and Pillow
    keeps the strip as the codec wrote it."""
    h = 21
    blocks = _ycbcr_blocks(h, w, hs, vs, hs * 10 + vs + w)
    scan = blocks.shape[1] // vs
    rows = 2 * vs
    outcomes = set()
    for comp in (8, 50000):
        tags = {256: (SHORT, (w,)), 257: (SHORT, (h,)),
                258: (SHORT, (8, 8, 8)), 259: (SHORT, (comp,)),
                262: (SHORT, (6,)), 277: (SHORT, (3,)),
                278: (SHORT, (rows,)), 530: (SHORT, (hs, vs)),
                317: (SHORT, (2,))}
        strips = []
        for r in range(0, h, rows):
            raw = blocks[r // vs : (r + rows) // vs].tobytes()
            n = len(raw) // scan * scan
            if scan % 3 == 0:
                runs = np.frombuffer(raw[:n], np.uint8).reshape(-1, scan // 3,
                                                                3)
                raw = U.predict_horizontal(runs).tobytes() + raw[n:]
            strips.append(_compress(raw, comp))
        outcomes.add(check_file(U.build(tags, strips), tmp_path))
    assert outcomes == {"ok" if (hs, vs) in tiff._SUBSAMPLINGS else "load"}


def test_ycbcr_later_strip_has_a_buffer_of_its_own():
    """Pillow reads each YCbCr strip through its own TIFFRGBAImageGet:
    a later strip cut short keeps what the codec wrote with zeros after
    it (not the strip before), and a later strip past the end of the
    file fails the load."""
    h, w = 8, 6
    blocks = _ycbcr_blocks(h, w, 1, 1, 5)
    top = zlib.compress(blocks[:4].tobytes())
    flat = np.full((4, w * 3), 128, np.uint8)
    flat[:, ::3] = 200
    cut = zlib.compress(flat.tobytes(), 0)[:37]
    tags = {256: (SHORT, (w,)), 257: (SHORT, (h,)), 258: (SHORT, (8, 8, 8)),
            259: (SHORT, (8,)), 262: (SHORT, (6,)), 277: (SHORT, (3,)),
            278: (SHORT, (4,)), 530: (SHORT, (1, 1))}
    assert check(U.build(tags, [top, cut])) == "ok"
    past = dict(tags)
    past[273] = (LONG, (8, 1 << 20))
    past[279] = (LONG, (len(top), 50))
    assert check(U.build(past, [top])) == "load"


GREY = np.clip(np.add.outer(np.arange(37) * 3, np.arange(45) * 5) % 256
               + np.random.default_rng(5).integers(-9, 9, (37, 45)), 0,
               255).astype(np.uint8)
OJPEG_GREY = {
    "interchange, photometric 1": (lambda: U.ojpeg_grey(GREY, 1), "ok"),
    "interchange, photometric 0": (lambda: U.ojpeg_grey(GREY, 0), "ok"),
    "interchange, photometric 3": (lambda: U.ojpeg_grey(GREY, 3), "ok"),
    "interchange, photometric 5": (lambda: U.ojpeg_grey(GREY, 5), "ok"),
    "interchange, photometric 8": (lambda: U.ojpeg_grey(GREY, 8), "ok"),
    "interchange, photometric 32844": (lambda: U.ojpeg_grey(GREY, 32844),
                                       "ok"),
    "tables": (lambda: U.ojpeg_grey(GREY, 1, tables=True), "ok"),
    "tables, a strip a restart interval": (lambda: U.ojpeg_grey(
        GREY[:32, :40], 1, tables=True, rows=8, restart=5), "ok"),
    "a frame sampled 2x2": (lambda: U.ojpeg_grey(GREY, 1,
                                                 sof_sampling=0x22), "load"),
    "a frame sampled 1x2": (lambda: U.ojpeg_grey(GREY, 1,
                                                 sof_sampling=0x12), "load"),
}


@pytest.mark.parametrize("name", sorted(OJPEG_GREY))
def test_old_style_jpeg_of_one_sample(name, tmp_path):
    """Old-style JPEG of one sample a pixel under a photometric other than
    YCbCr (Pillow's L): libjpeg's grey scanlines of tif_ojpeg's stream of
    one component, from the interchange stream or the tables; a frame
    sampled other than 1x1 fails tif_ojpeg's header check, as in
    Pillow."""
    make, want = OJPEG_GREY[name]
    assert check_file(make(), tmp_path) == want


@pytest.mark.parametrize("photo", [0, 1, 3, 5, 8, 10, 32844])
def test_old_style_jpeg_of_three_samples_not_ycbcr(photo, tmp_path):
    """Three samples under old-style JPEG and a photometric that libtiff
    does not take for YCbCr: Pillow's RGBX rows are wider than libtiff's,
    so its load fails, as the port's does."""
    data = bytearray(U.ojpeg_jif(PIC, 0))
    ifd = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        at = ifd + 2 + 12 * i
        if struct.unpack_from("<H", data, at)[0] == 262:
            struct.pack_into("<H", data, at + 8, photo)
    assert check_file(bytes(data), tmp_path) == "load"


YC = [np.random.default_rng(40 + k).integers(0, 256, (21, 31),
                                             dtype=np.uint8)
      for k in range(3)]


@pytest.mark.parametrize("rows", [None, 4, 5])
@pytest.mark.parametrize("comp", [8, 5, 32773])
def test_ycbcr_in_separate_planes(comp, rows, tmp_path):
    """YCbCr 1x1 in separate planes under deflate, LZW and PackBits, in
    one strip a plane or several: libtiff's putseparate8bitYCbCr11tile,
    the same tables as the contiguous form."""
    assert check_file(U.ycbcr_planar(*YC, comp, rows), tmp_path) == "ok"


def test_ycbcr_in_separate_planes_other_forms(tmp_path):
    """With predictor 2 (each plane's rows summed); subsampled 2x2 or 2x1
    (no separate put routine: "Can not handle format"); a Cb strip cut
    short (kept as far as it decoded, zeros after) or past the end of the
    file (zeros); a Y strip past the end (the load fails)."""
    assert check_file(U.ycbcr_planar(*YC, 8, 4, predictor=2),
                      tmp_path) == "ok"
    for sampling in ((2, 2), (2, 1), (1, 2)):
        assert check(U.ycbcr_planar(*YC, 8, 4, sampling=sampling)) == "load"
    data = U.ycbcr_planar(*YC, 8, 8)
    t = tiff.open_tiff(data)
    per = len(t.offsets) // 3
    tags = {256: (U.SHORT, (31,)), 257: (U.SHORT, (21,)),
            258: (U.SHORT, (8, 8, 8)), 259: (U.SHORT, (8,)),
            262: (U.SHORT, (6,)), 277: (U.SHORT, (3,)),
            278: (U.SHORT, (8,)), 284: (U.SHORT, (2,)),
            530: (U.SHORT, (1, 1))}
    strips = [data[o : o + n] for o, n in zip(t.offsets, t.counts)]
    cut = list(strips)
    cut[per + 1] = cut[per + 1][: len(cut[per + 1]) // 2]
    assert check(U.build(tags, cut)) == "ok"
    for k, want in ((per + 1, "ok"), (0, "load"), (1, "load")):
        far = dict(tags)
        offs = [o for o in t.offsets]
        offs[k] = 1 << 20
        far[273] = (U.LONG, tuple(offs))
        far[279] = (U.LONG, tuple(t.counts))
        assert check(U.build(far, strips)) == want, k


@pytest.mark.parametrize("hs,vs", SUBSAMPLINGS)
def test_ycbcr_in_tiles(hs, vs, tmp_path):
    """YCbCr in tiles (16x16 and 32x16, edge tiles clipped) under deflate
    and LZW at each subsampling, and with predictor 2 (summed along rows
    of three bytes a pixel, or left unsummed where a tile is not whole
    such rows): gtTileContig with the contiguous put routines, or
    libtiff's failure where the subsampling has none."""
    rng = np.random.default_rng(hs * 10 + vs + 50)
    outcomes = set()
    for tw, th, comp, pred in ((16, 16, 8, 1), (32, 16, 5, 1),
                               (16, 16, 8, 2)):
        ch = (-(-21 // vs) + 8, -(-31 // hs) + 8)
        cb, cr = (rng.integers(0, 256, ch, dtype=np.uint8) for _ in "bc")
        data = U.ycbcr_tiled(YC[0], cb, cr, hs, vs, tw, th, comp, pred)
        outcomes.add(check_file(data, tmp_path))
    assert outcomes == {"ok" if (hs, vs) in tiff._SUBSAMPLINGS else "load"}


def test_ycbcr_tiles_damaged(tmp_path):
    """A tile cut short keeps what its codec wrote, zeros after it (over
    the tile before it in the row's buffer); a tile past the end of the
    file reads as zeros, and where it is a row's first fails the load;
    with predictor 2 a tile that is not whole rows of the predictor stays
    unsummed."""
    rng = np.random.default_rng(61)
    cb, cr = (rng.integers(0, 256, (11, 16), dtype=np.uint8) for _ in "bc")
    data = U.ycbcr_tiled(YC[0], cb, cr, 2, 2, 16, 16, 8)
    t = tiff.open_tiff(data)
    tiles = [data[o : o + n] for o, n in zip(t.offsets, t.counts)]
    tags = {256: (U.SHORT, (31,)), 257: (U.SHORT, (21,)),
            258: (U.SHORT, (8, 8, 8)), 259: (U.SHORT, (8,)),
            262: (U.SHORT, (6,)), 277: (U.SHORT, (3,)),
            322: (U.SHORT, (16,)), 323: (U.SHORT, (16,)),
            530: (U.SHORT, (2, 2))}
    for k in range(len(tiles)):
        cut = list(tiles)
        cut[k] = cut[k][: len(cut[k]) // 3]
        assert check(U.build(tags, cut)) == "ok", k
        far = dict(tags)
        offs = list(t.offsets)
        offs[k] = 1 << 20
        far[324] = (U.LONG, tuple(offs))
        far[325] = (U.LONG, tuple(t.counts))
        assert check(U.build(far, tiles)) == ("load" if k % 2 == 0
                                              else "ok"), k
    pred = dict(tags)
    pred[317] = (U.SHORT, (2,))
    assert check(U.build(pred, tiles)) == "ok"


def test_three_layouts_for_the_consumers(tmp_path):
    """load_std_image, the Hald CLUT and the external mask from an
    old-style JPEG grey TIFF, a YCbCr TIFF in separate planes and one in
    tiles, against the reference."""
    from art_tpu.color.lut3d import load_hald_clut as ref_hald
    from art_tpu.io.imagefile import load_std_image as ref_load
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu_torch.color.lut3d import load_hald_clut
    from art_tpu_torch.masks import load_external_mask

    hald = chip_smoke.hald_image(2, 8)
    cb = np.zeros((8, 8), np.uint8) + 128
    files = {
        "ojpeg": U.ojpeg_grey(GREY, 1),
        "planar": U.ycbcr_planar(*YC, 8, 4),
        "tiled": U.ycbcr_tiled(YC[0], cb, cb, 1, 1, 16, 16, 5),
        "hald": U.ycbcr_tiled(hald[..., 1], hald[..., 0], hald[..., 2], 1, 1,
                              16, 16, 8),
    }
    for name, data in files.items():
        path = str(tmp_path / f"{name}.tif")
        with open(path, "wb") as f:
            f.write(data)
        np.testing.assert_array_equal(load_std_image(path).rgb,
                                      ref_load(path).rgb)
        for inverted in (False, True):
            np.testing.assert_array_equal(
                load_external_mask(path, 30, 40, inverted),
                ref_mask(path, 30, 40, inverted))
    path = str(tmp_path / "hald.tif")
    np.testing.assert_array_equal(load_hald_clut(path), ref_hald(path))


def test_uncompressed_ycbcr_is_pillows_raw_rgbx(tmp_path):
    """Uncompressed photometric 6 goes through Pillow's raw decoder with
    its raw mode "RGBX": four bytes a pixel of three-byte data."""
    rgb = np.random.default_rng(4).integers(0, 256, (6, 8, 3),
                                            dtype=np.uint8)
    tags = {256: (SHORT, (8,)), 257: (SHORT, (6,)), 258: (SHORT, (8, 8, 8)),
            262: (SHORT, (6,)), 277: (SHORT, (3,)), 278: (SHORT, (6,))}
    assert check_file(U.build(tags, [rgb.tobytes() + bytes(64)]),
                      tmp_path) == "ok"


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation(orientation, tmp_path):
    """Pillow's TIFF load transposes by the Orientation tag."""
    for key, comp in ((("I", 1, (1,), 1, (8,), ()), 1),
                      (("M", 2, (1,), 1, (16, 16, 16), ()), 50000)):
        data = key_file(key, comp, h=7, w=10, rows=3)
        t = tiff.open_tiff(data)
        tags = {256: (SHORT, (10,)), 257: (SHORT, (7,)),
                258: (SHORT, key[4]), 259: (SHORT, (comp,)),
                262: (SHORT, (key[1],)), 277: (SHORT, (len(key[4]),)),
                278: (SHORT, (3,)), 274: (SHORT, (orientation,))}
        strips = [data[o : o + n] for o, n in zip(t.offsets, t.counts)]
        check_file(U.build(tags, strips, le=key[0] == "I"), tmp_path)


MAPPED = {"L": (1, 1, 8, ()), "RGBA": (4, 2, 8, (2,)),
          "CMYK": (4, 5, 8, ()), "I;16": (1, 1, 16, ()), "P": (1, 3, 8, ())}


@pytest.mark.parametrize("mode", sorted(MAPPED))
def test_mapped_raw_strip(mode, tmp_path):
    """A file opened by path whose one raw strip is in its mode's own
    raw mode is memory-mapped by Pillow's load at Pillow's size, which
    Orientation 5-8 swaps (the rows then fall at the other width), and a
    file too short for it raises ValueError; several strips are read by
    the decoder. read_rgb8 against Pillow by path, for each orientation,
    one strip and three, whole and cut."""
    spp, photo, bps, extra = MAPPED[mode]
    rng = np.random.default_rng(len(mode))
    top = (1 << bps) - 1
    g = rng.integers(0, top + 1, (8, 13, spp)).astype(f"u{bps // 8}")
    for o in range(1, 9):
        for rows in (8, 3):
            tags = {256: (SHORT, (13,)), 257: (SHORT, (8,)),
                    258: (SHORT, (bps,) * spp), 262: (SHORT, (photo,)),
                    277: (SHORT, (spp,)), 278: (SHORT, (rows,)),
                    274: (SHORT, (o,))}
            if extra:
                tags[338] = (SHORT, extra)
            if photo == 3:
                tags[320] = (SHORT, tuple(int(v) for v in rng.integers(
                    0, 65536, 768)))
            data = U.build(tags, [g[y : y + rows].tobytes()
                                  for y in range(0, 8, rows)],
                           ifd_first=True)
            for cut in (0, 20):
                path = str(tmp_path / "m.tif")
                with open(path, "wb") as f:
                    f.write(data[: len(data) - cut])
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    try:
                        want = np.asarray(Image.open(path).convert("RGB"))
                    except Exception as e:
                        want = type(e)
                if isinstance(want, type):
                    with pytest.raises((OSError, ValueError)) as got:
                        read_rgb8(path)
                    assert isinstance(got.value, ValueError) == \
                        issubclass(want, ValueError), (o, rows, cut)
                else:
                    np.testing.assert_array_equal(read_rgb8(path), want)


# -- (e) faults C13-C15 -------------------------------------------------------

def _rgba(bits, extra, comp=1, planar=False, le=True):
    rng = np.random.default_rng(bits + extra)
    a = rng.integers(0, 256, (11, 17, 1))
    a[0, :3, 0] = (0, 255, 1)
    c = rng.integers(0, 256, (11, 17, 3))
    px = np.concatenate([c * a // 255, a], axis=2)  # premultiplied
    if bits == 16:
        px = px * 257
    px = px.astype(np.uint8 if bits == 8 else np.uint16)
    tags = {256: (SHORT, (17,)), 257: (SHORT, (11,)),
            258: (SHORT, (bits,) * 4), 259: (SHORT, (comp,)),
            262: (SHORT, (2,)), 277: (SHORT, (4,)), 278: (SHORT, (11,)),
            338: (SHORT, (extra,))}
    if planar:
        tags[284] = (SHORT, (2,))
        strips = [_compress(U.rows_bytes(px[..., k], bits, le), comp)
                  for k in range(4)]
    else:
        strips = [_compress(U.rows_bytes(px, bits, le), comp)]
    return U.build(tags, strips, le=le)


@pytest.mark.parametrize("bits,comp,planar,le", [
    (8, 1, False, True), (8, 8, False, True), (8, 50000, False, False),
    (16, 1, False, True), (16, 1, False, False), (16, 34925, False, True),
    (8, 8, True, True), (8, 1, True, True)])
def test_c13_premultiplied_alpha(bits, comp, planar, le, tmp_path):
    """ExtraSamples 1 (associated alpha): Pillow's "RGBa" unpackers
    (8-bit, "RGBa;16L/B") and libtiff's planar fix-up divide the colour by
    the alpha; the parent read the premultiplied colour (up to 241 codes
    off). An uncompressed planar file is Pillow's ValueError."""
    data = _rgba(bits, 1, comp, planar, le)
    want = "load" if planar and comp == 1 else "ok"
    assert check_file(data, tmp_path) == want
    if want == "ok":
        _, arr, _, _ = tiff.load(data)
        plain = _pil(_rgba(bits, 2, comp, planar, le))[2]
        assert (arr[..., :3] != plain[..., :3]).any()


@pytest.mark.parametrize("comp", COMPRESSIONS + (4,))
def test_c14_fill_order_2(comp, tmp_path):
    """FillOrder 2: Pillow's ";R" raw modes reverse each byte's bits, and
    libtiff reverses the strip before it decodes; the parent ignored the
    tag (up to 209 codes off on 8-bit grey)."""
    if comp == 4:
        data = _pil_bytes(BW, compression="group4", tiffinfo={266: 2})
    else:
        data = key_file(("I", 1, (1,), 2, (8,), ()), comp, seed=comp)
    assert check_file(data, tmp_path) == "ok"
    for key in (("M", 2, (1,), 2, (8, 8, 8), ()), ("I", 0, (1,), 2, (1,), ()),
                ("I", 1, (1,), 2, (4,), ()), ("I", 1, (1,), 2, (16,), ())):
        check(key_file(key, 1 if comp == 4 else comp))


def _c15(name):
    g = np.arange(35, dtype=np.uint8).reshape(5, 7)
    base = {256: (SHORT, (7,)), 257: (SHORT, (5,)), 258: (SHORT, (8,)),
            262: (SHORT, (1,)), 277: (SHORT, (1,)), 278: (SHORT, (5,))}
    if name == "float RGB":
        base.update({258: (SHORT, (32, 32, 32)), 277: (SHORT, (3,)),
                     262: (SHORT, (2,)), 339: (SHORT, (3, 3, 3))})
        return U.build(base, [np.zeros((5, 7, 3), np.float32).tobytes()])
    comp = {"compression 32766": 32766, "compression 99": 99,
            "WebP": 50001, "ThunderScan 8-bit": 32809,
            "SGILog, grey": 34676}[name]
    base[259] = (SHORT, (comp,))
    return U.build(base, [g.tobytes()])


C15_OPEN = ("compression 32766", "compression 99", "float RGB")
C15_LOAD = ("WebP", "ThunderScan 8-bit", "SGILog, grey")


@pytest.mark.parametrize("name", C15_OPEN + C15_LOAD)
def test_c15_error_classes(name, tmp_path):
    """Where Pillow's open fails the port raises Unidentified, where its
    load fails an OSError ("decoder error -2"), never NotImplementedError
    (the parent's refusal): load_std_image tries the external loader only
    for the first, the mask passes over both, the PSF is skipped, as in
    the reference."""
    import art_tpu
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu.ops.sharpen import load_psf_kernel as ref_psf
    from art_tpu_torch.masks import load_external_mask
    from art_tpu_torch.ops.sharpen import load_psf_kernel

    data = _c15(name)
    stage = "open" if name in C15_OPEN else "load"
    assert check(data) == stage
    path = str(tmp_path / "c15.tif")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(OSError) as got:
        read_rgb8(path)
    assert isinstance(got.value, stdformats.Unidentified) == (stage == "open")
    for load in (load_std_image, art_tpu.load_image):
        with pytest.raises(OSError):
            load(path)
    with pytest.raises(OSError):  # its caller passes over the mask
        ref_mask(path, 30, 40, False)
    assert load_external_mask(path, 30, 40, False) is None
    assert ref_psf(path, 1.0) is None and load_psf_kernel(path, 1.0) is None


def test_c15_external_loader_only_where_open_fails(tmp_path, monkeypatch):
    """load_std_image hands a file Pillow cannot open to the loader
    registered for its extension and raises where Pillow's load fails."""
    from art_tpu_torch.io.imagefile import write_png
    from art_tpu_torch.io.iomanager import get_instance

    png = str(tmp_path / "conv.png")
    write_png(png, np.full((4, 5, 3), 77, np.uint8))
    calls = []

    def loader(path):
        calls.append(path)
        return png

    monkeypatch.setattr(get_instance(), "load_image", loader)
    for name in C15_OPEN + C15_LOAD:
        path = str(tmp_path / f"{name.replace(' ', '_')}.tif")
        with open(path, "wb") as f:
            f.write(_c15(name))
        if name in C15_OPEN:
            assert load_std_image(path).rgb.shape == (3, 4, 5)
        else:
            with pytest.raises(OSError, match="decoder error -2"):
                load_std_image(path)
    assert len(calls) == len(C15_OPEN)


# -- (f) damaged copies -------------------------------------------------------

def _damaged(data, start, n, seed):
    """`n` copies of `data`: cut at random points past `start`, or with
    one to three bytes past it changed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 3 == 0:
            out.append(data[: int(rng.integers(start, len(data)))])
            continue
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(start, len(b)))] ^= int(rng.integers(1, 256))
        out.append(bytes(b))
    return out


# the damaged files keep their IFD before their data, so that a cut
# copy still opens

def _zstd_file():
    rgb = np.asarray(RGB)
    strips = [zstandard.ZstdCompressor(level=12, write_checksum=True).compress(
        rgb[y : y + 16].tobytes()) for y in range(0, 48, 16)]
    return U.build({256: (SHORT, (64,)), 257: (SHORT, (48,)),
                    258: (SHORT, (8, 8, 8)), 259: (SHORT, (50000,)),
                    262: (SHORT, (2,)), 277: (SHORT, (3,)),
                    278: (SHORT, (16,))}, strips, ifd_first=True)


def _g4_file():
    """Pillow's Group 4 strips of TEXT, one row a strip: a strip Group 4
    leaves short then fails, rather than leaving rows libtiff never
    wrote."""
    data = _pil_bytes(TEXT, compression="group4", strip_size=8)
    t = tiff.open_tiff(data)
    strips = [data[o : o + n] for o, n in zip(t.offsets, t.counts)]
    return U.build({256: (SHORT, (64,)), 257: (SHORT, (48,)),
                    258: (SHORT, (1,)), 259: (SHORT, (4,)),
                    262: (SHORT, (t.photo,)), 277: (SHORT, (1,)),
                    278: (SHORT, (1,))}, strips, ifd_first=True)


DAMAGED = {"zstd": _zstd_file, "group4": _g4_file,
           "old-style JPEG": lambda: U.ojpeg_jif(PIC, 2, ifd_first=True)}


@pytest.mark.parametrize("name", sorted(DAMAGED))
def test_damaged_copies(name):
    """Thirty damaged copies each, cut or with bytes of their data
    changed: Pillow's array or its error class."""
    data = DAMAGED[name]()
    assert check(data) == "ok"
    start = min(tiff.open_tiff(data).offsets)
    if name == "old-style JPEG":
        start += 600  # past the JPEG's tables, into its entropy data
    outcomes = [check(copy) for copy in _damaged(data, start, 30, len(name))]
    assert len(outcomes) == 30


def _cut_each(tags, blocks, k):
    """The file of `blocks` with block `k` cut at each of its bytes (its
    byte count the cut's), every cut against Pillow."""
    for n in range(len(blocks[k]) + 1):
        cut = list(blocks)
        cut[k] = blocks[k][:n]
        check(U.build(tags, cut))


def test_c18_zstd_strip_cut_at_every_byte():
    """tests/data/tiff_c18_zstd_ycbcr.tif: YCbCr 4:2:0 in three ZSTD
    strips (noise in a raw block, a flat strip, noise again). Each strip
    cut at every byte: Pillow's array or its error. libzstd streams a
    raw block's bytes as they come, so a strip cut inside one keeps them
    (and the RGBA path shows them); a byte count of 0 fails
    TIFFFillStrip."""
    with open(os.path.join(DATA, "tiff_c18_zstd_ycbcr.tif"), "rb") as f:
        data = f.read()
    t = tiff.open_tiff(data)
    strips = [data[o : o + n] for o, n in zip(t.offsets, t.counts)]
    tags = {256: (SHORT, (t.w,)), 257: (SHORT, (t.h,)),
            258: (SHORT, (8, 8, 8)), 259: (SHORT, (50000,)),
            262: (SHORT, (6,)), 277: (SHORT, (3,)), 278: (SHORT, (t.th,)),
            530: (SHORT, (2, 2))}
    assert check(U.build(tags, strips)) == "ok"
    for k in range(len(strips)):
        _cut_each(tags, strips, k)


def test_c18_zstd_tile_cut_at_every_byte():
    """YCbCr 4:2:0 in four 16x16 ZSTD tiles (raw blocks for the noisy
    ones), each tile cut at every byte: Pillow's array or its error (a
    tile of no bytes fails TIFFFillTile, and fails the load where it
    starts a row of tiles)."""
    import zlib

    rng = np.random.default_rng(61)
    cb, cr = (rng.integers(0, 256, (11, 16), dtype=np.uint8) for _ in "bc")
    data = U.ycbcr_tiled(YC[0], cb, cr, 2, 2, 16, 16, 8)
    t = tiff.open_tiff(data)
    tiles = [zstandard.ZstdCompressor(level=12, write_checksum=True).compress(
        zlib.decompress(data[o : o + n])) for o, n in zip(t.offsets,
                                                           t.counts)]
    tags = {256: (SHORT, (31,)), 257: (SHORT, (21,)),
            258: (SHORT, (8, 8, 8)), 259: (SHORT, (50000,)),
            262: (SHORT, (6,)), 277: (SHORT, (3,)),
            322: (SHORT, (16,)), 323: (SHORT, (16,)), 530: (SHORT, (2, 2))}
    assert check(U.build(tags, tiles)) == "ok"
    for k in range(len(tiles)):
        _cut_each(tags, tiles, k)


@pytest.mark.slow
def test_damaged_strips_under_sanitizers(tmp_path):
    """tiffdec.cc built with AddressSanitizer and UBSan decodes damaged
    strips with no report: ZSTD frames of three inputs at three levels,
    Pillow's CCITT strips (RLE, RLEW, Group 3 1D and 2D, Group 4), each
    cut or with bytes changed, random bytes as fax and ThunderScan
    data."""
    import shutil
    import subprocess

    cxx = shutil.which("g++")
    exe = str(tmp_path / "tiffdec_sanitized")
    subprocess.run([cxx, "-g", "-O1", "-std=c++17",
                    "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=undefined", "-o", exe,
                    os.path.join(os.path.dirname(__file__),
                                 "tiffdec_sanitized.cc")], check=True)
    rng = np.random.default_rng(2025)
    cases = []

    def damaged(data, n):
        out = []
        for k in range(n):
            b = bytearray(data)
            if k % 4 == 0:
                out.append(bytes(b[: int(rng.integers(1, len(b)))]))
                continue
            for _ in range(int(rng.integers(1, 6))):
                b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
            out.append(bytes(b))
        return out

    for src in _zstd_inputs().values():
        src = src[:6000]
        for level in (1, 5, 19):
            frame = zstandard.ZstdCompressor(
                level=level, write_checksum=True).compress(src)
            cases += [(f"zstd {len(src)} 0 0", d)
                      for d in damaged(frame, 60)]
    for comp, kind, opts in (("tiff_ccitt", 0, 0), ("tiff_raw_16", 0, 1),
                             ("group3", 1, 0), ("group3", 1, 1),
                             ("group4", 2, 0)):
        info = {292: opts} if comp == "group3" else {}
        data = _pil_bytes(BW, compression=comp, tiffinfo=info)
        t = tiff.open_tiff(data)
        strip = data[t.offsets[0] : t.offsets[0] + t.counts[0]]
        head = f"fax{kind} {8 * 48} 64 {opts}"
        cases += [(head, d) for d in damaged(strip, 80)]
        cases += [(head, bytes(rng.integers(0, 256, int(rng.integers(
            1, 400)), dtype=np.uint8))) for _ in range(40)]
    cases += [("thunder 320 31 0", bytes(rng.integers(0, 256, int(
        rng.integers(1, 300)), dtype=np.uint8))) for _ in range(100)]
    paths = []
    for i, (head, data) in enumerate(cases):
        path = str(tmp_path / f"{i}.case")
        with open(path, "wb") as f:
            f.write(head.encode() + b"\n" + data)
        paths.append(path)
    for k in range(0, len(paths), 400):
        run = subprocess.run([exe, *paths[k : k + 400]],
                             capture_output=True, text=True)
        assert run.returncode == 0, run.stderr[-3000:]
        assert "runtime error" not in run.stderr, run.stderr[-3000:]


# -- (g) the reference's loaders ----------------------------------------------

def test_consumers_as_the_reference(tmp_path):
    """load_std_image (RGB, I;16 from I;12, LAB, 16-bit CMYK, old-style
    JPEG, YCbCr), the Hald CLUT from a 16-bit ZSTD TIFF, the external
    mask from Group 4 and float TIFFs, and the PSF from an LZMA grey TIFF,
    against the reference."""
    import art_tpu
    import art_tpu_torch
    from art_tpu.color.lut3d import load_hald_clut as ref_hald
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu.ops.sharpen import load_psf_kernel as ref_psf
    from art_tpu_torch.color.lut3d import load_hald_clut
    from art_tpu_torch.masks import load_external_mask
    from art_tpu_torch.ops.sharpen import load_psf_kernel

    def write(name, data):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        return path

    files = {
        "rgb": key_file(("I", 2, (1,), 1, (8, 8, 8), ()), 50000),
        "i12": key_file(("I", 1, (1,), 1, (12,), ()), 34925),
        "lab": key_file(("M", 8, (1,), 1, (8, 8, 8), ()), 8),
        "cmyk16": key_file(("I", 5, (1,), 1, (16, 16, 16, 16), ()), 5),
        "ojpeg": U.ojpeg_tables(PIC, 2),
        "ycbcr": _pil_bytes(RGB.convert("YCbCr"), compression="zstd"),
    }
    for name, data in files.items():
        path = write(name + ".tif", data)
        ref, got = art_tpu.load_image(path), art_tpu_torch.load_image(path)
        np.testing.assert_array_equal(got.rgb, ref.rgb)
    assert read_image(str(tmp_path / "i12.tif"))[0] == "I;16"
    hald = write("hald.tif", open(os.path.join(DATA, chip_smoke.V2_HALD),
                                  "rb").read())
    np.testing.assert_array_equal(load_hald_clut(hald), ref_hald(hald))
    masks = [write("g4.tif", _pil_bytes(TEXT, compression="group4")),
             write("f.tif", _pil_bytes(FLOAT, compression="zstd",
                                       tiffinfo={317: 3}))]
    for path in masks:
        for inverted in (False, True):
            np.testing.assert_array_equal(
                load_external_mask(path, 30, 40, inverted),
                ref_mask(path, 30, 40, inverted))
    yy, xx = np.mgrid[-4:5, -4:5]
    k = np.round(255 * np.exp(-(xx ** 2 + yy ** 2) / 6.0)).astype(np.uint8)
    psf = write("k.tif", _pil_bytes(Image.fromarray(k), compression="lzma"))
    for scale in (1.0, 2.0):
        got, want = load_psf_kernel(psf, scale), ref_psf(psf, scale)
        assert got is not None
        np.testing.assert_array_equal(got, want)


# -- fixtures, chip_smoke's V1 and V2 -----------------------------------------

def _sha(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def test_fixtures_hold_their_sha256():
    """Each committed TIFF fixture decodes in Pillow to the recorded
    sha256 and in the port to Pillow's mode and samples; 200 KB in all."""
    recorded = json.load(open(os.path.join(DATA, "formats_sha256.json")))
    names = sorted(k for k in recorded if k.startswith("tiff_"))
    assert set(names) == set(U.fixtures())
    total = 0
    for name in names:
        path = os.path.join(DATA, name)
        data = open(path, "rb").read()
        total += len(data)
        assert check(data) == "ok"
        assert _sha(np.asarray(Image.open(path).convert("RGB"))) == \
            recorded[name], name
        assert _sha(read_rgb8(path)) == recorded[name]
    assert total <= 200 * 1024
    assert {n for _, n in chip_smoke.V1_TILED} | {
        chip_smoke.V2_HALD, chip_smoke.V2_MASK} == set(names)


@pytest.mark.parametrize("label,name", chip_smoke.V1_TILED)
def test_v1_tiling_at_a_small_size(label, name):
    """chip_smoke.tiff_tiled of each fixture at three strips: Pillow and
    the port decode it to the fixture's decode three times over."""
    fixture = open(os.path.join(DATA, name), "rb").read()
    rows = np.asarray(Image.open(io.BytesIO(fixture))).shape[0]
    data = chip_smoke.tiff_tiled(fixture, 3 * rows)
    assert check(data) == "ok"
    strip = np.asarray(Image.open(io.BytesIO(fixture)))
    np.testing.assert_array_equal(tiff.load(data)[1],
                                  np.concatenate([strip] * 3, axis=0))
    assert chip_smoke.V1_FRAME[0] % rows == 0


def test_v2_files_hold_their_samples(tmp_path):
    """V2's Hald is hald_image(6) at 16 bits (read as its high bytes) and
    its mask f2_mask above 128, as the PNGs chip_smoke.v2_inputs writes;
    its two develops differ only in those files."""
    samples, paths, argvs = chip_smoke.v2_inputs(
        str(tmp_path), chip_smoke.flagship_frame(16, 24))
    np.testing.assert_array_equal(samples["hald"],
                                  chip_smoke.hald_image(6, 16) >> 8)
    np.testing.assert_array_equal(read_rgb8(paths["hald"]), samples["hald"])
    mask, mode = read_grey(paths["mask"])
    assert mode == "L"
    np.testing.assert_array_equal(
        mask, np.where(chip_smoke.f2_mask(*chip_smoke.Q2_MASK) > 128, 255, 0))
    np.testing.assert_array_equal(read_rgb8(paths["mask"]), samples["mask"])
    for kind in ("tiff", "png"):
        arp = argvs[kind][argvs[kind].index("-o") - 1]
        text = open(arp).read()
        names = (paths if kind == "tiff" else
                 {"hald": "hald6.png", "mask": "mask.png"}).values()
        assert all(os.path.basename(n) in text for n in names), kind
