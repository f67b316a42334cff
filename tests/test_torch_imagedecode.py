"""The port's image decoder (`io/imagefile.py::read_rgb8`) against PIL,
and the Hald CLUT film simulation against `art_tpu`, on the CPU.

PIL is the oracle only here: the decoder's array must equal
``np.asarray(Image.open(path).convert("RGB"))`` bit for bit.

- PNG written by PIL (RGB, RGBA, L, LA, P, 1, 16-bit grey) and, for what
  PIL does not write, by the small encoder below, which PIL then reads:
  1/2/4/8/16-bit grey, 8/16-bit grey+alpha, RGB and RGBA, 1/2/4/8-bit
  palettes (a short PLTE, a tRNS), each row under one of the five
  filters in turn, plain and Adam7-interlaced.
- TIFF written by PIL (none, LZW, deflate, Adobe deflate, PackBits; RGB,
  RGBA, L, P, 1; the horizontal predictor under LZW and deflate; 16-bit
  grey), the port's own 16-bit RGB writer (deflate with the predictor,
  and none), and tiled TIFFs from the encoder below (8 and 16 bits,
  both byte orders, edge tiles, the predictor), which PIL reads.
- JPEG, GIF, BMP, WebP and PNM decode as PIL decodes them (the
  decoders' own grids are tests/test_torch_jpegdec.py,
  tests/test_torch_formats.py and tests/test_torch_webp.py); bytes that
  are no image raise OSError; a missing file FileNotFoundError.
- `load_hald_clut` of an 8-bit PIL PNG, a 16-bit PNG and a TIFF: the
  reference's table exactly.
- A film simulation from a Hald PNG at strength 80 at 96x160 bilinear:
  the port plans the reference's plan, and the reference's plan
  developed through the port agrees with the reference's develop
  within the slice bounds (max <= 1 LSB8, mean <= 2e-4, >= 99.9%
  within 1 LSB8).
"""

import importlib
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from art_tpu.color import lut3d as rlut
from art_tpu.params import ProcParams as RefProcParams
from art_tpu_torch.color import lut3d
from art_tpu_torch.io.imagefile import read_rgb8
from art_tpu_torch.io.tiffwrite import write_tiff
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import (flagship_frame, hald_image, p3_arp, parity,
                        profile_pp, write_hald)
from tests.test_torch_plan import Develops, assert_plans_equal, plan_key

jdev = importlib.import_module("art_tpu.pipeline.develop")

H, W = 96, 160


def _pil(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _check(path):
    want = _pil(path)
    got = read_rgb8(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- a small PNG encoder for what PIL does not write -------------------------

def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filter(rows, bpp, first_type):
    """Rows of bytes under filters 0-4 in turn, from first_type."""
    out = []
    prior = bytes(len(rows[0])) if rows else b""
    for i, row in enumerate(rows):
        t = (first_type + i) % 5
        f = bytearray()
        for x, v in enumerate(row):
            a = row[x - bpp] if x >= bpp else 0
            b = prior[x]
            c = prior[x - bpp] if x >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[t]
            f.append((v - pred) & 255)
        out.append(bytes([t]) + bytes(f))
        prior = row
    return b"".join(out)


def _rows(samples, depth):
    """(h, w, c) samples -> packed rows of bytes."""
    h, w, c = samples.shape
    if depth == 16:
        return [samples[y].astype(">u2").tobytes() for y in range(h)]
    if depth == 8:
        return [samples[y].astype(np.uint8).tobytes() for y in range(h)]
    rows = []
    for y in range(h):
        bits = np.unpackbits(samples[y, :, 0].astype(np.uint8)[:, None],
                             axis=1)[:, 8 - depth:].ravel()
        rows.append(np.packbits(bits).tobytes())
    return rows


_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def write_test_png(path, samples, ctype, depth, interlace=False, plte=None,
                   trns=None):
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b"".join(_filter(_rows(samples[y0::dy, x0::dx], depth), bpp,
                               k) for k, (y0, x0, dy, dx) in
                       enumerate(_ADAM7)
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = _filter(_rows(samples, depth), bpp, 1)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        data += _chunk(b"PLTE", plte)
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    data += _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1",
                                  "I;16"])
def test_pil_png_decodes_as_pil(tmp_path, mode):
    rng = np.random.default_rng(1)
    if mode == "I;16":
        im = Image.fromarray(rng.integers(0, 65536, (37, 53)).astype(
            np.uint16))
    else:
        im = Image.fromarray(rng.integers(0, 256, (37, 53, 3)).astype(
            np.uint8)).convert(mode)
    im.save(tmp_path / "a.png")
    _check(tmp_path / "a.png")


PNG_CASES = [(0, d) for d in (1, 2, 4, 8, 16)] + [
    (4, 8), (4, 16), (2, 8), (2, 16), (6, 8), (6, 16)] + [
    (3, d) for d in (1, 2, 4, 8)]


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", PNG_CASES,
                         ids=[f"ct{c}-{d}bit" for c, d in PNG_CASES])
def test_png_decodes_as_pil(tmp_path, ctype, depth, interlace):
    rng = np.random.default_rng(ctype * 100 + depth)
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    samples = rng.integers(0, 1 << depth, (13, 19, c))
    plte = trns = None
    if ctype == 3:  # a PLTE shorter than the indices reach, and a tRNS
        n = max(1, (1 << depth) - 3)
        plte = rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes()
        trns = b"\x00\x80"
    elif ctype == 0 and depth == 8:
        trns = b"\x00\x10"
    path = tmp_path / "a.png"
    write_test_png(path, samples, ctype, depth, interlace, plte, trns)
    _check(path)


@pytest.mark.parametrize("comp", ["raw", "tiff_lzw", "tiff_deflate",
                                  "tiff_adobe_deflate", "packbits"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P", "1"])
def test_pil_tiff_decodes_as_pil(tmp_path, comp, mode):
    rng = np.random.default_rng(2)
    im = Image.fromarray(rng.integers(0, 256, (37, 53, 3)).astype(
        np.uint8)).convert(mode)
    im.save(tmp_path / "a.tif", compression=comp)
    _check(tmp_path / "a.tif")
    if comp in ("tiff_lzw", "tiff_deflate") and mode in ("RGB", "L"):
        im.save(tmp_path / "p.tif", compression=comp, tiffinfo={317: 2})
        assert Image.open(tmp_path / "p.tif").tag_v2.get(317) == 2
        _check(tmp_path / "p.tif")


def test_16bit_tiffs_decode_as_pil(tmp_path):
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 65536, (21, 33)).astype(
        np.uint16)).save(tmp_path / "g.tif", compression="tiff_lzw")
    _check(tmp_path / "g.tif")
    rgb = rng.uniform(0.0, 1.0, (3, 21, 33)).astype(np.float32)
    for compress in (True, False):
        write_tiff(str(tmp_path / "c.tif"), rgb, bits=16, compress=compress)
        _check(tmp_path / "c.tif")


def write_tiled_tiff(path, hwc, tile=16, le=True, predictor=True):
    """A deflate-compressed tiled RGB TIFF of (H, W, 3) uint8/uint16."""
    e = "<" if le else ">"
    h, w, _ = hwc.shape
    bits = 8 * hwc.dtype.itemsize
    tiles = []
    for y0 in range(0, h, tile):
        for x0 in range(0, w, tile):
            t = np.zeros((tile, tile, 3), hwc.dtype)
            blk = hwc[y0:y0 + tile, x0:x0 + tile]
            t[:blk.shape[0], :blk.shape[1]] = blk
            if predictor:
                t = np.diff(t, axis=1, prepend=np.zeros_like(t[:, :1]))
            tiles.append(zlib.compress(t.astype(e + f"u{bits // 8}")
                                       .tobytes()))
    entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 3, [bits] * 3),
               (259, 3, 1, 8), (262, 3, 1, 2), (277, 3, 1, 3),
               (284, 3, 1, 1), (317, 3, 1, 2 if predictor else 1),
               (322, 3, 1, tile), (323, 3, 1, tile),
               (324, 4, len(tiles), None), (325, 4, len(tiles),
                                            [len(t) for t in tiles])]
    n = len(entries)
    pos = 8 + 2 + 12 * n + 4
    extra = b""
    ifd = struct.pack(e + "H", n)
    data_off = pos + 64 * 4 * 3  # room for the out-of-line arrays
    blob = b"".join(tiles)
    offs = list(np.cumsum([0] + [len(t) for t in tiles[:-1]]) + data_off)
    for tag, typ, cnt, val in entries:
        if tag == 324:
            val = offs
        vals = val if isinstance(val, list) else [val]
        fmt = e + ("H" if typ == 3 else "I") * cnt
        payload = struct.pack(fmt, *[int(v) for v in vals])
        if len(payload) <= 4:
            ifd += struct.pack(e + "HHI", tag, typ, cnt) + payload.ljust(
                4, b"\0")
        else:
            ifd += struct.pack(e + "HHII", tag, typ, cnt, pos + len(extra))
            extra += payload
    ifd += struct.pack(e + "I", 0)
    head = (b"II*\0" if le else b"MM\0*") + struct.pack(e + "I", 8)
    body = head + ifd + extra
    assert len(body) <= data_off
    with open(path, "wb") as f:
        f.write(body.ljust(data_off, b"\0") + blob)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("le", [True, False], ids=["II", "MM"])
def test_tiled_tiff_decodes_as_pil(tmp_path, bits, le):
    rng = np.random.default_rng(bits)
    hwc = rng.integers(0, 1 << bits, (37, 45, 3)).astype(
        np.uint16 if bits == 16 else np.uint8)
    for predictor in (True, False):
        write_tiled_tiff(tmp_path / "t.tif", hwc, le=le, predictor=predictor)
        assert Image.open(tmp_path / "t.tif").tag_v2.get(322) == 16
        _check(tmp_path / "t.tif")


@pytest.mark.parametrize("fmt,name", [("JPEG", "JPEG"), ("GIF", "GIF"),
                                      ("BMP", "BMP"), ("WEBP", "WebP"),
                                      ("PPM", "PNM")])
def test_other_formats_raise_by_name(tmp_path, fmt, name):
    # each decoded since (tests/test_torch_jpegdec.py,
    # tests/test_torch_formats.py, tests/test_torch_webp.py), as PIL
    # decodes it
    rgb = np.random.default_rng(1).integers(0, 256, (13, 21, 3))
    Image.fromarray(rgb.astype(np.uint8)).save(tmp_path / "a.img",
                                               format=fmt)
    _check(tmp_path / "a.img")
    (tmp_path / "b.img").write_bytes(b"no image here")
    with pytest.raises(OSError, match="cannot identify"):
        read_rgb8(str(tmp_path / "b.img"))
    with pytest.raises(FileNotFoundError):
        read_rgb8(str(tmp_path / "missing.png"))


def test_hald_clut_loads_as_the_reference(tmp_path):
    Image.fromarray(hald_image(3, 8)).save(tmp_path / "h8.png")
    write_hald(str(tmp_path / "h16.png"), level=3, bits=16)
    Image.fromarray(hald_image(3, 8)).save(tmp_path / "h.tif",
                                           compression="tiff_lzw")
    for name in ("h8.png", "h16.png", "h.tif"):
        got = lut3d.load_hald_clut(str(tmp_path / name))
        want = rlut.load_hald_clut(str(tmp_path / name))
        assert got.shape == (9, 9, 9, 3) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)
    Image.fromarray(np.zeros((10, 10, 3), np.uint8)).save(
        tmp_path / "bad.png")
    with pytest.raises(ValueError, match="not a Hald CLUT"):
        lut3d.load_hald_clut(str(tmp_path / "bad.png"))


@pytest.fixture(scope="module")
def develops(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    return Develops(root / "profile_develops")


def test_hald_film_simulation_develops_as_the_reference(tmp_path,
                                                        develops):
    path = str(tmp_path / "look.png")
    write_hald(path, level=4, bits=16)
    frame = flagship_frame(H, W, seed=5)
    pps = [profile_pp(p3_arp(path), cls()) for cls in (ProcParams,
                                                       RefProcParams)]
    for pp in pps:
        pp.raw.bayer.method = "bilinear"
    ours = tdev.plan(frame, pps[0], device="cpu")
    ref_cfg, ref_data = jdev.plan(frame, pps[1])
    assert_plans_equal(ours, (ref_cfg, ref_data))
    assert [s[0] for s in ref_cfg.steps] == ["denoise", "filmsim_pre",
                                             "tonecurve"]
    # the film simulation before the curve leaves the tail's fusion open
    assert tdev.fusion_gates(ref_cfg)[1]
    out = tdev.crop_result(tdev.build_run(ref_cfg)(
        tdev.upload(frame, "cpu"), tdev.data_to_torch(ref_data, "cpu")),
        ref_cfg).numpy()
    ref = develops.get("ref", plan_key(ref_cfg, ref_data),
                       lambda: jdev.develop(frame, pps[1]))
    st = parity(out, ref)
    print("hald", st)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st
