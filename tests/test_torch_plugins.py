"""The small raster plugins the reference opens through Pillow, decoded by
the port (`art_tpu_torch.io.plugins` over `io/native/rasterdec.cc`) on
the CPU against Pillow 12.1.0 and, through the consumers, against
`art_tpu`:

- every form of tests/util_plugins.py (FITS of each BITPIX and its
  GZIP_1 tiles; PFM of either byte order; P0CMYK, PyP, PyRGBA and
  PyCMYK raw and rescaled; SPIDER; McIdas of 1, 2 and 4 bytes; IMT; IM
  in each mode ``ImImagePlugin.OPEN`` maps, its Lut and ``F;n`` bit
  forms; SUN of each depth, raw and RLE, with colour maps; MSP v1 and
  v2; XVThumb; PIXAR; GBR v1 and v2; XBM; XPM in P and RGB; FTEX raw and
  BC1; IPTC/NAA with and without a band; PCD in each orientation; FLI's
  chunks) through the four readers: `read_rgb8` against Pillow's
  ``convert("RGB")``, `read_grey` against the mask path's mode rule,
  `read_image` (Pillow's mode and samples for I;16, I;16B, I;16L, I, F
  and YCbCr) and `load_std_image` against the reference's; a form whose
  load fails in Pillow fails with its error class;
- the quirks the reference keeps: FITS's big-endian samples read as
  little-endian and BITPIX -64 as pairs of float32, PFM's byte order by
  the scale's sign, XPM above 256 colours, IPTC's band merge, PCD's
  rotation;
- Pillow's YCbCr and PhotoYCC conversions on all 2^24 triples;
- the consumers (`load_image`, `load_hald_clut`, `load_external_mask`,
  `load_psf_kernel`) against the reference's on every form;
- `chip_smoke.py`'s G1 writers against Pillow's reading, and the Photo
  CD whose decode G1 holds to a recorded sha256.

The damaged copies of each format (cut, bytes changed, lengthened) are
in tests/test_torch_unported.py.
"""

import hashlib
import io
import json
import os
import struct
import warnings

import numpy as np
import pytest

from art_tpu.io.imagefile import load_std_image as ref_load
from art_tpu_torch.io import plugins, unported
from art_tpu_torch.io.imagefile import load_std_image, read_image, read_rgb8

import chip_smoke
import util_plugins as up
from test_torch_formats import DATA, check_readers

Image = pytest.importorskip("PIL.Image")

_NAMES = {"MCIDAS": "McIdas", "IPTC": "IPTC/NAA", "XVTHUMB": "XVThumb"}


def _error_class(e):
    for cls in (OSError, ValueError, IndexError):
        if isinstance(e, cls):
            return cls.__name__
    return "other"


def _outcome(fn):
    """("ok", fn's result), or (the class of the error it raises,)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return ("ok", fn())
        except Exception as e:
            return (_error_class(e),)


def _class(fn):
    return _outcome(fn)[0]


def _write(tmp_path, data, name="a.img"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("form", sorted(up.FORMS))
def test_forms_decode_as_pillow(form, tmp_path):
    """The four readers on each form against Pillow and the reference; a
    form Pillow cannot load fails alike, at the same stage."""
    data = up.FORMS[form]
    path = _write(tmp_path, data)
    im = Image.open(path)
    fmt = im.format
    name, _ = unported.walk(data, path)
    if fmt == "PPM":
        fmt = "PFM" if data[:2] == b"Pf" else "PNM of a Pillow extension"
    assert name == _NAMES.get(fmt, fmt)
    want = _class(lambda: np.asarray(Image.open(path).convert("RGB")))
    if want != "ok":
        assert _class(lambda: read_rgb8(path)) == want
        assert _class(lambda: load_std_image(path)) == \
            _class(lambda: ref_load(path))
        return
    check_readers(path)


def test_every_mode_of_the_plugins_is_held():
    """Each mode the plugins map has a form that loads in Pillow."""
    modes = {}
    for data in up.FORMS.values():
        try:
            im = Image.open(io.BytesIO(data))
            im.load()
        except Exception:
            continue
        modes.setdefault(im.format, set()).add(im.mode)
    assert modes["FITS"] == {"L", "I;16", "I", "F"}
    assert modes["PPM"] == {"F", "CMYK", "P", "RGBA"}
    assert modes["MCIDAS"] == {"L", "I;16B", "I"}
    assert modes["IM"] >= {"1", "L", "P", "RGB", "RGBA", "CMYK", "YCbCr",
                           "LA", "PA", "I", "F", "I;16", "I;16L", "I;16B"}
    assert modes["SUN"] == {"1", "L", "P", "RGB"}
    assert modes["XPM"] == {"P", "RGB"}
    assert modes["GBR"] == {"L", "RGBA"}
    assert modes["FTEX"] == {"RGB", "RGBA"}
    assert modes["IPTC"] == {"L", "RGB", "CMYK"}
    assert {"SPIDER", "IMT", "MSP", "XVThumb", "PIXAR", "XBM", "PCD",
            "FLI"} <= set(modes)


def test_fits_big_endian_samples_read_as_little_endian(tmp_path):
    """Pillow reads FITS with the raw mode equal to the mode: big-endian
    1, 2, 3, 258 in a 16-bit FITS open as I;16 768, 513 over 256, 512
    (rows bottom-up), and BITPIX -64 as pairs of float32."""
    cards = [b"SIMPLE  =                    T", b"BITPIX  =                   16",
             b"NAXIS   =                    2", b"NAXIS1  =                    2",
             b"NAXIS2  =                    2", b"END"]
    head = b"".join(c.ljust(80) for c in cards).ljust(2880)
    path = _write(tmp_path, head + struct.pack(">4H", 1, 2, 3, 258)
                  .ljust(2880, b"\0"))
    mode, samples, _ = read_image(path)
    assert mode == "I;16"
    np.testing.assert_array_equal(samples, [[768, 513], [256, 512]])
    np.testing.assert_array_equal(samples, np.asarray(Image.open(path)))
    f64 = np.array([[1.5, -2.0, 3.25]])
    path = _write(tmp_path, up.fits(f64, -64), "d.fits")
    mode, samples, _ = read_image(path)
    raw = f64.astype(">f8").tobytes()
    assert mode == "F"
    np.testing.assert_array_equal(
        samples.view(np.uint32),
        np.frombuffer(raw[:12], "<f4").reshape(1, 3).view(np.uint32))
    np.testing.assert_array_equal(samples, np.asarray(Image.open(path)))


def test_pfm_scale_sign_picks_the_byte_order(tmp_path):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    for scale in (-1.0, 1.0, -0.5, 4.0):
        path = _write(tmp_path, up.pfm(arr, scale), f"{scale}.pfm")
        mode, samples, _ = read_image(path)
        assert mode == "F"
        np.testing.assert_array_equal(samples, arr)
        np.testing.assert_array_equal(samples, np.asarray(Image.open(path)))
    # a big-endian file read with a negative scale: its bytes swapped
    data = up.pfm(arr, 1.0).replace(b"\n1.0\n", b"\n-1.\n")
    path = _write(tmp_path, data, "swapped.pfm")
    np.testing.assert_array_equal(read_image(path)[1],
                                  arr.astype(">f4").view("<f4"))


def test_xpm_above_256_colours_reads_rgb(tmp_path):
    """Pillow's XPM plugin: up to 256 colours a P image, above RGB; a
    pixel of the None colour fails a P image (ValueError) and an RGB one
    (KeyError, no OSError)."""
    path = _write(tmp_path, up.FORMS["XPM RGB (300 colours)"])
    assert Image.open(path).mode == "RGB"
    np.testing.assert_array_equal(
        read_rgb8(path), np.asarray(Image.open(path).convert("RGB")))
    idx = (np.arange(6 * 7).reshape(6, 7) * 5) % 300
    cols = np.random.default_rng(3).integers(0, 256, (300, 3))
    rgb = up.xpm(idx, cols, bpp=2)
    head, pixels = rgb.split(b"/* pixels */")
    p_none = up.xpm(idx % 40, cols[:40], none_key="!")
    head_p, pixels_p = p_none.split(b"/* pixels */")
    for d, want in ((rgb, "ok"),
                    (p_none, "ok"),  # a None colour no pixel uses
                    (head_p + b"/* pixels */" + pixels_p.replace(
                        b'"', b'"!', 1), "ValueError"),
                    (head + b"/* pixels */" + pixels.replace(
                        b'"', b'"~~', 1), "other")):  # a key of no colour
        p = _write(tmp_path, d, "x.xpm")
        assert _class(lambda: read_rgb8(p)) == want == _class(
            lambda: Image.open(p).convert("RGB"))


def test_iptc_band_merges_into_its_mode(tmp_path):
    """An IPTC/NAA file naming a band (3:65) of an RGB or CMYK image: the
    raw L image is that band, the others black."""
    g = np.arange(6 * 9, dtype=np.uint8).reshape(6, 9) * 4
    for layers, band, k in ((3, 2, 1), (3, None, 0), (4, 4, 3), (3, 3, 2)):
        path = _write(tmp_path, up.iptc(g, layers, 1, band=band))
        pil = Image.open(path)
        assert pil.mode == ("RGB" if layers == 3 else "CMYK")
        want = np.asarray(pil.convert("RGB"))
        got = read_rgb8(path)
        np.testing.assert_array_equal(got, want)
        if layers == 3:
            expect = np.zeros(g.shape + (3,), np.uint8)
            expect[..., k] = g
            np.testing.assert_array_equal(got, expect)
    path = _write(tmp_path, up.iptc(g, 3, 1, band=5))
    assert _class(lambda: read_rgb8(path)) == "IndexError" == _class(
        lambda: Image.open(path).load())


def test_pcd_orientation_rotates_the_base_image(tmp_path):
    """Orientation 1 and 3 turn the 768 x 512 base image by 90 and 270
    degrees (Pillow's load_end), 0 and 2 leave it."""
    base = None
    for o in (0, 1, 2, 3):
        data = bytearray(up.pcd(0, seed=4))
        data[2048 + 1538] = o
        path = _write(tmp_path, bytes(data), f"{o}.pcd")
        got = read_rgb8(path)
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(path).convert("RGB")))
        if base is None:
            base = got
        expect = {0: base, 1: np.rot90(base), 2: base,
                  3: np.rot90(base, -1)}[o]
        np.testing.assert_array_equal(got, expect)


def test_ycbcr_to_rgb_on_all_2_24_triples():
    """Pillow's YCbCr -> RGB (its fixed-point tables), bit for bit."""
    v = np.arange(1 << 24, dtype=np.uint32)
    t = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                 -1).astype(np.uint8)
    del v
    want = np.asarray(Image.frombytes("YCbCr", (4096, 4096), t.tobytes())
                      .convert("RGB")).reshape(-1, 3)
    got = plugins.ycbcr_to_rgb(t)
    bad = np.nonzero((got != want).any(1))[0]
    assert bad.size == 0, (t[bad[:5]], got[bad[:5]], want[bad[:5]])


def test_photo_ycc_to_rgb_on_all_2_24_triples():
    """Pillow's PhotoYCC unpacker ("YCC;P", Photo CD's), bit for bit."""
    v = np.arange(1 << 24, dtype=np.uint32)
    t = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                 -1).astype(np.uint8)
    del v
    want = np.asarray(Image.frombytes("RGB", (4096, 4096), t.tobytes(),
                                      "raw", "YCC;P")).reshape(-1, 3)
    got = np.empty_like(t)
    plugins._lib().ycc_to_rgb(plugins._ptr(t), t.shape[0],
                              plugins._ptr(got))
    bad = np.nonzero((got != want).any(1))[0]
    assert bad.size == 0, (t[bad[:5]], got[bad[:5]], want[bad[:5]])


# -- the consumers ----------------------------------------------------------

def _same(a, b):
    if a[0] != b[0]:
        return False
    if a[0] != "ok":
        return True
    x, y = a[1], b[1]
    if x is None or y is None:
        return x is None and y is None
    x, y = (np.asarray(getattr(x, "rgb", x)), np.asarray(getattr(y, "rgb",
                                                                  y)))
    return x.shape == y.shape and np.array_equal(x, y, equal_nan=True)


@pytest.mark.parametrize("form", sorted(up.FORMS))
def test_consumers_of_each_form_as_the_reference(form, tmp_path):
    """`load_image`, the Hald CLUT, the external mask (an OSError leaves
    the region unmasked: the reference's caller catches it) and the PSF
    image on each form give the reference's result or its error class."""
    import art_tpu
    import art_tpu_torch
    from art_tpu.color.lut3d import load_hald_clut as ref_hald
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu.ops.sharpen import load_psf_kernel as ref_psf
    from art_tpu_torch.color.lut3d import load_hald_clut
    from art_tpu_torch.masks import load_external_mask
    from art_tpu_torch.ops.sharpen import load_psf_kernel

    path = _write(tmp_path, up.FORMS[form])
    for label, ref, port in (
            ("load_image", lambda: art_tpu.load_image(path),
             lambda: art_tpu_torch.load_image(path)),
            ("mask", lambda: ref_mask(path, 9, 14, True),
             lambda: load_external_mask(path, 9, 14, True)),
            ("hald", lambda: ref_hald(path), lambda: load_hald_clut(path)),
            ("psf", lambda: ref_psf(path, 1.0),
             lambda: load_psf_kernel(path, 1.0))):
        want, got = _outcome(ref), _outcome(port)
        if label == "mask" and want[0] == "OSError":
            want = ("ok", None)
        assert _same(want, got), (label, want[0], got[0])


# -- chip_smoke.py's G1 ------------------------------------------------------

def test_g1_writers_as_pillow_reads_them(tmp_path):
    """G1's numpy writers at a small size: Pillow reads each file in the
    mode and to the samples G1 expects (FITS's byte order as Pillow's),
    and so does the port."""
    files = chip_smoke.plugin_files(str(tmp_path), 61, 97)
    for name, (path, mode, want) in files.items():
        im = Image.open(path)
        assert (im.mode if im.mode in ("I;16", "I;16B", "F") else "RGB") \
            == mode, name
        pil = np.asarray(im) if mode != "RGB" else np.asarray(
            im.convert("RGB"))
        pil = pil.astype(pil.dtype.newbyteorder("="))  # I;16B's '>u2'
        assert chip_smoke._bits_equal(pil, want), name
        got_mode, samples, _ = read_image(path)
        assert got_mode == mode and chip_smoke._bits_equal(samples, want)
        check_readers(path)


def test_g1_photo_cd_sha256_is_pillows(tmp_path):
    """The sha256 chip_smoke.py's G1 holds its Photo CD to is Pillow's
    convert("RGB") of the same file."""
    with open(os.path.join(DATA, "formats_sha256.json")) as f:
        recorded = json.load(f)
    path = chip_smoke.write_pcd(str(tmp_path / "g.pcd"))
    want = np.asarray(Image.open(path).convert("RGB"))
    assert want.shape == (768, 512, 3)
    assert hashlib.sha256(want.tobytes()).hexdigest() == \
        recorded[chip_smoke.G1_PCD]
    np.testing.assert_array_equal(read_rgb8(path), want)


def test_g2_mask_and_hald_as_the_png_and_tiff(tmp_path):
    """G2's RLE SUN Hald and PFM mask decode to the samples of the PNG
    and float TIFF they stand beside."""
    from art_tpu_torch.io.imagefile import read_grey

    hald = chip_smoke.hald_image(4, 8)
    mask = chip_smoke.f2_mask(40, 60).astype(np.float32) / np.float32(255)
    sun = chip_smoke.write_sun_rle(str(tmp_path / "h.ras"), hald)
    np.testing.assert_array_equal(read_rgb8(sun), hald)
    np.testing.assert_array_equal(
        np.asarray(Image.open(sun).convert("RGB")), hald)
    pfm = chip_smoke.write_pfm(str(tmp_path / "m.pfm"), mask)
    tif = chip_smoke.write_float_tiff(str(tmp_path / "m.tif"), mask)
    for path in (pfm, tif):
        plane, mode = read_grey(path)
        assert mode == "F" and Image.open(path).mode == "F"
        np.testing.assert_array_equal(plane, mask)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), mask)
