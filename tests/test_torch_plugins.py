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
  BC1; IPTC/NAA with and without a band, raw and with a JPEG of each
  mode in each file mode, an L file over a colour image of each format
  (C19) and a band of one (C20); PCD in each orientation; FLI's
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
import util_rasterforms as ur
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


_IPTC_PIC = np.clip(np.add.outer(np.arange(19) * 7, np.arange(27) * 3)
                    [..., None] * np.array([1, 2, 3]) % 256, 0,
                    255).astype(np.uint8)


def _iptc_jpeg(inner, layers, band, cut=None):
    bio = io.BytesIO()
    Image.fromarray(_IPTC_PIC).convert(inner).save(bio, "JPEG", quality=90)
    data = bio.getvalue()[:cut]
    return up.iptc_jpeg(data, 27, 19, layers, band)


@pytest.mark.parametrize("band", [None, 0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("layers", [1, 3, 4])
@pytest.mark.parametrize("inner", ["L", "RGB", "CMYK"])
def test_iptc_jpeg_band(inner, layers, band, tmp_path):
    """An IPTC/NAA file whose 8:10 records hold a JPEG (compression 5) of
    an L, RGB or CMYK image, in an L, RGB or CMYK file, naming no band or
    band 0 to 5: Pillow's load opens the records and merges an L image
    into the file's mode as that band (band 0 the last), raises its
    ValueError where the image is not L and its IndexError where the
    band is out of range; an L file takes the image as it is. The port's
    readers as Pillow's, and the reference's loader and external mask as
    the port's, an L file holding a colour JPEG included (Pillow's L
    image over an RGB or CMYK core: its L samples are the core's bytes,
    its resize the core's)."""
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu_torch.masks import load_external_mask

    path = _write(tmp_path, _iptc_jpeg(inner, layers, band), "a.iim")
    want = _outcome(lambda: np.asarray(Image.open(path).convert("RGB")))
    got = _outcome(lambda: read_rgb8(path))
    assert want[0] == got[0]
    if want[0] != "ok":
        assert _class(lambda: load_std_image(path)) == want[0]
        return
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(load_std_image(path).rgb,
                                  ref_load(path).rgb)
    check_readers(path)
    np.testing.assert_array_equal(load_external_mask(path, 30, 40, False),
                                  ref_mask(path, 30, 40, False))


def _encoded(arr, fmt, mode=None, **kw):
    bio = io.BytesIO()
    img = Image.fromarray(arr)
    (img.convert(mode) if mode else img).save(bio, fmt, **kw)
    return bio.getvalue()


_IPTC_RGB = np.ascontiguousarray(np.stack(
    [_IPTC_PIC[..., 0], _IPTC_PIC[::-1, :, 1], 255 - _IPTC_PIC[..., 2]], -1))
# images an IPTC file's records may hold, Pillow opening each as RGB or
# CMYK: Pillow's core of each (RGBX, its pad byte 255, or 0 from the SGI
# decoder; the CMYK bytes)
_COLOUR_INNER = {
    "JPEG RGB": lambda: _encoded(_IPTC_RGB, "JPEG", quality=90),
    "JPEG CMYK": lambda: _encoded(_IPTC_RGB, "JPEG", quality=90,
                                  mode="CMYK"),
    "PNG RGB": lambda: _encoded(_IPTC_RGB, "PNG"),
    "PPM": lambda: _encoded(_IPTC_RGB, "PPM"),
    "BMP": lambda: _encoded(_IPTC_RGB, "BMP"),
    "SGI": lambda: _encoded(_IPTC_RGB, "SGI"),
    "TGA": lambda: _encoded(_IPTC_RGB, "TGA"),
    "PCX": lambda: _encoded(_IPTC_RGB, "PCX"),
    "QOI": lambda: _encoded(_IPTC_RGB, "QOI"),
    "WebP": lambda: _encoded(_IPTC_RGB, "WEBP", lossless=True),
    "JPEG 2000": lambda: _encoded(_IPTC_RGB, "JPEG2000"),
}


@pytest.mark.parametrize("inner", sorted(_COLOUR_INNER))
def test_c19_l_file_over_a_colour_core(inner, tmp_path):
    """An IPTC/NAA L file (3:60 of one layer) whose records hold a colour
    image: Pillow's L image over the image's RGB or CMYK core. Its
    ``convert("RGB")`` is the image's; its L samples, which read_grey
    gives, are the first bytes of each row of the core; the reference's
    external mask resizes the core and reads its second band. All four
    readers and the mask against Pillow and the reference, by path."""
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu_torch.io.imagefile import read_grey
    from art_tpu_torch.masks import load_external_mask

    path = _write(tmp_path, up.iptc_jpeg(_COLOUR_INNER[inner](), 27, 19, 1),
                  "l.iim")
    with Image.open(path) as im:
        assert im.mode == "L"
        want = np.asarray(im)
    grey, mode = read_grey(path)
    assert mode == "L"
    np.testing.assert_array_equal(grey, want)
    check_readers(path)
    for h, w in ((30, 40), (19, 27), (7, 9)):
        np.testing.assert_array_equal(load_external_mask(path, h, w, False),
                                      ref_mask(path, h, w, False))


@pytest.mark.parametrize("band", [None, 1, 2])
@pytest.mark.parametrize("inner", sorted(set(_COLOUR_INNER) - {
    "JPEG RGB", "JPEG CMYK", "PNG RGB", "PPM"}))
def test_c20_band_of_a_colour_image(inner, band, tmp_path):
    """An IPTC/NAA RGB file naming band 0 (none named, or 3:65 of 1) or
    band 1 of a colour image in a format other than JPEG, PNG, PNM or
    TIFF: Pillow's merge raises its ValueError (the band's mode is not
    L, or its core has more than one band), in the port's readers and
    load_std_image alike (the port read the decode's first channel)."""
    path = _write(tmp_path, up.iptc_jpeg(_COLOUR_INNER[inner](), 27, 19, 3,
                                         band), "b.iim")
    assert _class(lambda: Image.open(path).convert("RGB")) == "ValueError"
    assert _class(lambda: read_rgb8(path)) == "ValueError"
    assert _class(lambda: load_std_image(path)) == "ValueError"
    assert _class(lambda: ref_load(path)) == "ValueError"


@pytest.mark.parametrize("inner", ["GIF", "BMP P", "PNG P", "PNG RGBA"])
def test_c20_second_band_of_a_palette_image(inner, tmp_path):
    """Band 1 of an IPTC/NAA RGB file (3:65 of 2) holding a palette or
    RGBA image: a band the merge checks, its mode not L, so Pillow's
    ValueError in the port's readers too (a GIF opens as P in Pillow,
    even of a grey image)."""
    img = Image.fromarray(_IPTC_RGB)
    if inner == "PNG RGBA":
        img = Image.fromarray(np.dstack([_IPTC_RGB, _IPTC_PIC[..., :1]]))
    elif inner != "GIF":
        img = img.convert("P")
    bio = io.BytesIO()
    img.save(bio, inner.split()[0])
    path = _write(tmp_path, up.iptc_jpeg(bio.getvalue(), 27, 19, 3, 2),
                  "p.iim")
    assert _class(lambda: Image.open(path).convert("RGB")) == "ValueError"
    assert _class(lambda: read_rgb8(path)) == "ValueError"
    assert _class(lambda: load_std_image(path)) == "ValueError"


def _palette_inner(inner):
    """The bytes of a palette (or bilevel) image of _IPTC_RGB in the
    format `inner` names, as Pillow writes it."""
    img = Image.fromarray(_IPTC_RGB)
    fmt, _, kind = inner.partition(" ")
    kw = {}
    if kind == "1":
        img = img.convert("1")
    elif kind == "P4":
        img, kw = img.quantize(16), {"bits": 4} if fmt == "PNG" else {}
    elif kind == "P tRNS":
        img, kw = img.convert("P"), {"transparency": 3}
    elif fmt != "GIF":
        img = img.convert("P")
    bio = io.BytesIO()
    img.save(bio, fmt, **kw)
    return bio.getvalue()


@pytest.mark.parametrize("band", [None, 1])
@pytest.mark.parametrize("inner", [
    "GIF", "BMP P", "BMP P4", "PNG P", "PNG P4", "PNG P tRNS", "TIFF P",
    "TGA P", "PCX P", "IM P", "PPM 1", "PNG 1", "BMP 1"])
def test_c20_first_band_of_a_palette_image(inner, band, tmp_path):
    """Band 0 of an IPTC/NAA RGB file (none named, or 3:65 of 1) holding
    a palette or bilevel image: a band the merge does not check, taken
    as the image's bytes, so a P image's indices (not its colours) and
    a bilevel image's 0 and 255 in the red channel. The port's readers
    and load_std_image as Pillow's and the reference's, by path (the
    port read a P image's first colour channel, a PBM's raised)."""
    path = _write(tmp_path, up.iptc_jpeg(_palette_inner(inner), 27, 19, 3,
                                         band), "p0.iim")
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(read_rgb8(path), want)
    assert not want[..., 1:].any()
    if inner.split()[-1] != "1":
        with Image.open(io.BytesIO(_palette_inner(inner))) as im:
            np.testing.assert_array_equal(want[..., 0], np.asarray(im))
    np.testing.assert_array_equal(load_std_image(path).rgb,
                                  ref_load(path).rgb)
    check_readers(path)


def test_c20_first_band_of_another_palette_format_is_named(tmp_path):
    """Band 0 of an IPTC/NAA RGB file holding a palette image in a format
    whose index plane the port read by name before C22 (an XPM here): no
    longer refused, Pillow's merge of its indices (the name is kept)."""
    xpm = (b'/* XPM */\nstatic char *x[] = {\n"2 1 2 1",\n"a c #FF0000",\n'
           b'"b c #0000FF",\n"ab"\n};\n')
    path = _write(tmp_path, up.iptc_jpeg(xpm, 2, 1, 3), "x.iim")
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    assert want[0, :, 0].tolist() == [0, 1]
    np.testing.assert_array_equal(read_rgb8(path), want)


def test_iptc_jpeg_band_cut_short(tmp_path):
    """A JPEG band cut inside its headers fails Pillow's open of the
    records (an OSError), one cut in its scan its load (OSError), in the
    port alike."""
    for cut in (60, 400):
        path = _write(tmp_path, _iptc_jpeg("L", 3, 2, cut), "c.iim")
        assert _class(lambda: read_rgb8(path)) == "OSError" == _class(
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


def _c22_core(kind):
    """The bytes of a 27x19 image in the mode and format `kind` names,
    as Pillow writes it (P, RGBA, LA or CMYK)."""
    mode, fmt = kind.split()
    img = Image.fromarray(_IPTC_RGB)
    if mode == "RGBA":
        img = Image.fromarray(np.dstack([_IPTC_RGB, _IPTC_PIC[..., :1]]))
    elif mode != "RGB":
        img = img.convert(mode)
    bio = io.BytesIO()
    img.save(bio, fmt)
    return bio.getvalue()


@pytest.mark.parametrize("kind", ["P PNG", "P GIF", "P BMP", "RGBA PNG",
                                  "RGBA TIFF", "LA PNG", "LA TIFF",
                                  "CMYK TIFF"])
def test_c22_l_file_over_another_core(kind, tmp_path):
    """An IPTC/NAA L file (3:60 of one layer) over a P, RGBA, LA or
    non-JPEG CMYK core: Pillow's L samples, which read_grey gives, are
    the first bytes of each row of the core's memory (indices; RGBA;
    L, L, L, A; CMYK); the reference's external mask resizes the core
    (its second band; a P core's resize raises Pillow's ValueError, the
    same size its indices). Against Pillow and the reference, by path."""
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu_torch.io.imagefile import read_grey
    from art_tpu_torch.masks import load_external_mask

    path = _write(tmp_path, up.iptc_jpeg(_c22_core(kind), 27, 19, 1),
                  "l.iim")
    with Image.open(path) as im:
        assert im.mode == "L"
        want = np.asarray(im)
    grey, mode = read_grey(path)
    assert mode == "L"
    np.testing.assert_array_equal(grey, want)
    for h, w in ((30, 40), (19, 27), (7, 9)):
        want = _outcome(lambda: ref_mask(path, h, w, False))
        got = _outcome(lambda: load_external_mask(path, h, w, False))
        assert got[0] == want[0]
        if want[0] == "ok":
            np.testing.assert_array_equal(got[1], want[1])


def _c22_palette_inner(fmt):
    """A palette image of 27x19 indices in `fmt`, hand-built, where
    Pillow opens it as P."""
    rng = np.random.default_rng(22)
    idx = rng.integers(0, 200, (19, 27), dtype=np.uint8)
    colours = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    if fmt == "PSD":
        return ur.psd_form("P", h=19, w=27, seed=3)
    if fmt == "SUN":
        return up.sun(np.pad(idx, ((0, 0), (0, 1))).tobytes(), 27, 19, 8, 1,
                      colours.T.reshape(-1).tobytes())
    if fmt == "XPM":
        return up.xpm(idx % 40, colours[:40])
    if fmt == "FLI":
        return up.fli(27, 19, [up.fli_colour(colours), up.fli_brun(idx)])
    if fmt == "XVThumb":
        return up.xvthumb(idx)
    if fmt == "DCX":
        img = Image.fromarray(idx, "P")
        img.putpalette(colours.reshape(-1).tolist())
        bio = io.BytesIO()
        img.save(bio, "PCX")
        return ur.dcx(bio.getvalue())
    if fmt == "JPEG 2000":
        import util_j2kforms as uj

        return uj.palette_file(idx, colours)
    import util_texforms as ut

    pal = np.zeros((256, 4), np.uint8)
    pal[:200, :3], pal[:200, 3] = colours, 255
    return ut.dds_palette(idx, pal)


@pytest.mark.parametrize("band", [None, 1])
@pytest.mark.parametrize("fmt", ["PSD", "SUN", "XPM", "FLI", "XVThumb",
                                 "JPEG 2000", "DDS", "DCX"])
def test_c22_first_band_of_a_palette_image(fmt, band, tmp_path):
    """Band 0 of an IPTC/NAA RGB file holding a palette image in a format
    other than PNG, GIF, BMP, TIFF, TGA, PCX or IM (and a DCX): Pillow
    merges its indices as band 0, in the port's readers and load_std_image as in
    Pillow and the reference (the port refused it by name)."""
    inner = _c22_palette_inner(fmt)
    with Image.open(io.BytesIO(inner)) as im:
        assert im.mode == "P"
        idx = np.asarray(im)
    w, h = idx.shape[1], idx.shape[0]
    path = _write(tmp_path, up.iptc_jpeg(inner, w, h, 3, band), "p0.iim")
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(want[..., 0], idx)
    np.testing.assert_array_equal(read_rgb8(path), want)
    np.testing.assert_array_equal(load_std_image(path).rgb,
                                  ref_load(path).rgb)
