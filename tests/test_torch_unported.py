"""The formats Pillow 12.1.0 opens past those the port reads by their
magic (`art_tpu_torch.io.unported`): a file of each opens in Pillow and,
in the port, is decoded as Pillow decodes it (DIB, CUR, PCX, DCX, ICO,
PSD, QOI, SGI, TGA: `art_tpu_torch.io.rasterformats`; FITS, FLI, FTEX,
GBR, IM, IMT, IPTC/NAA, McIdas, MSP, PCD, PIXAR, PFM, the PNM
extensions, SPIDER, SUN, XBM, XPM, XVThumb: `art_tpu_torch.io.plugins`;
FTEX's, IPTC's and PCD's fixtures, whose load Pillow calls truncated,
and XPM's, whose None colour fails its load, fail alike), fails with
Pillow's load error where Pillow's load always fails (BUFR, GRIB, HDF5,
WMF/EMF, MPEG, EPS with no Ghostscript) or is refused by name; damaged
copies of it (cut short, bytes of its header changed, bytes added; for
the decoded formats bytes anywhere, its palettes, offset tables and RLE
data included) open, fail to open (an OSError, after which the
reference tries its external loader) or fail otherwise in the port
exactly where they do in Pillow's ``Image.open``, and a decoded format's
copies load to Pillow's array or fail with its error class at its
stage; each consumer of a file whose load always fails does what the
reference's does; and a file that takes a plugin's accept test but not
its open reaches the external loader in both packages.

Two opens are mirrored only in part (see the module's docstring), and
their damaged copies here are those the mirror covers: AVIF's, whose
checks inside the meta box are libavif's (its files are only cut short
or lengthened), and ICO's of a PNG icon, whose icon goes through the
port's PNG reader (only the icon directory's bytes are changed).
"""

import io
import struct
import sys
import warnings

import numpy as np
import pytest

from art_tpu.io.imagefile import load_std_image as ref_load
from art_tpu_torch.io import unported
from art_tpu_torch.io.imagefile import load_std_image, read_rgb8
from art_tpu_torch.io.stdformats import (DecompressionBomb, PilValueError,
                                         Unidentified)

import util_rasterforms as rf
from test_torch_iomanager import both  # noqa: F401 (fixture)

Image = pytest.importorskip("PIL.Image")


def _pil(fmt, mode="RGB", size=(16, 12), **kw):
    def make():
        rng = np.random.default_rng(3)
        a = rng.integers(0, 256, (size[1], size[0], 3)).astype(np.uint8)
        im = Image.fromarray(a)
        if mode != "RGB":
            im = im.convert(mode)
        b = io.BytesIO()
        im.save(b, format=fmt, **kw)
        return b.getvalue()
    return make


def _cur():
    """Pillow's ICO of a bitmap icon, its type made a cursor's."""
    d = bytearray(_pil("ICO", size=(16, 16), bitmap_format="bmp")())
    d[2] = 2
    return bytes(d)


def _dcx():
    return struct.pack("<III", 987654321, 12, 0) + _pil("PCX")()


def _fits():
    cards = [b"SIMPLE  =                    T",
             b"BITPIX  =                    8",
             b"NAXIS   =                    2",
             b"NAXIS1  =                    4",
             b"NAXIS2  =                    3", b"END"]
    head = b"".join(c.ljust(80) for c in cards).ljust(2880)
    return head + bytes(range(12)).ljust(2880, b"\0")


def _fli():
    h = bytearray(128)
    struct.pack_into("<IHHHHHH", h, 0, 0, 0xAF12, 1, 8, 6, 8, 0)
    d = bytearray(bytes(h) + struct.pack("<IHHH", 16, 0xF1FA, 0, 0) + bytes(6))
    struct.pack_into("<I", d, 0, len(d))
    return bytes(d)


def _ftex():
    data = bytes(4 * 4 * 3)
    return (b"FTEX" + struct.pack("<i2i2i2i", 1, 4, 4, 1, 1, 1, 36)
            + struct.pack("<i", len(data)) + data)


def _iptc():
    def field(rec, ds, data):
        return bytes([0x1C, rec, ds]) + struct.pack(">H", len(data)) + data
    return (field(3, 60, b"\x01\x00") + field(3, 20, b"\x00\x04")
            + field(3, 30, b"\x00\x03") + field(3, 120, b"\x01")
            + bytes([0x1C, 8, 10, 0x80]) + bytes(12))


def _mcidas():
    w = [0] * 64
    w[1], w[8], w[9], w[10], w[13], w[33] = 4, 3, 5, 1, 1, 256
    return b"\0\0\0\0\0\0\0\4" + struct.pack("!62i", *w[2:64]) + bytes(32)


def _pixar():
    h = bytearray(1024)
    h[:4] = b"\x80\xe8\0\0"
    struct.pack_into("<HH", h, 416, 3, 4)
    struct.pack_into("<HH", h, 424, 14, 2)
    return bytes(h) + bytes(36)


def _psd():
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, 3, 3, 4, 8, 3)
    return head + bytes(12) + bytes(2) + bytes(36)


def _wmf():
    h = bytearray(44)
    h[:6] = b"\xd7\xcd\xc6\x9a\0\0"
    struct.pack_into("<4hH", h, 6, 0, 0, 144, 72, 72)
    h[22:26] = b"\x01\x00\t\x00"
    return bytes(h) + bytes(40)


def _emf():
    h = bytearray(88)
    h[:4] = b"\x01\0\0\0"
    struct.pack_into("<8i", h, 8, 0, 0, 15, 9, 0, 0, 400, 300)
    h[40:44] = b" EMF"
    return bytes(h)


# a file of each format (and of a second form of some) that Pillow opens
OPENABLE = {
    "AVIF": _pil("AVIF"),
    "BLP": _pil("BLP", "P"),
    "BLP version 1": lambda: b"BLP1" + struct.pack("<iIIIii", 0, 0, 4, 3, 5, 0)
    + bytes(16),
    "DIB": _pil("DIB"),
    "BUFR": lambda: b"BUFR" + bytes(64),
    "CUR": _cur,
    "PCX": _pil("PCX"),
    "PCX L": _pil("PCX", "L", (40, 30)),
    "DCX": _dcx,
    "DDS": _pil("DDS", size=(32, 24)),
    "DDS L": _pil("DDS", "L"),
    "EPS": _pil("EPS"),
    "FITS": _fits,
    "FLI": _fli,
    "FTEX": _ftex,
    "GBR": lambda: struct.pack(">IIIII", 24, 1, 3, 2, 1) + b"br\0\0"
    + bytes(6),
    "GRIB": lambda: b"GRIB\0\0\0\1" + bytes(64),
    "HDF5": lambda: b"\x89HDF\r\n\x1a\n" + bytes(64),
    "JPEG 2000": _pil("JPEG2000"),
    "JPEG 2000 codestream": _pil("JPEG2000", no_jp2=True),
    "ICNS": _pil("ICNS", size=(32, 32)),
    "ICO": _pil("ICO", size=(16, 16)),
    "ICO of a bitmap": _pil("ICO", size=(16, 16), bitmap_format="bmp"),
    "IM": _pil("IM"),
    "IM header only": lambda: b"Image type: RGB image\r\nImage size (x*y): "
    b"4*3\r\n\x1a" + bytes(36),
    "IMT": lambda: b"width 4\nheight 3\npixel n8\n\x0c" + bytes(12),
    "IPTC/NAA": _iptc,
    "McIdas": _mcidas,
    "MPEG": lambda: b"\x00\x00\x01\xb3\x01\x00\x0c\x00" + bytes(16),
    "MSP": _pil("MSP", "1"),
    "PCD": lambda: bytes(2048) + b"PCD_IPI" + bytes(1539),
    "PIXAR": _pixar,
    "PFM": lambda: b"Pf\n4 3\n-1.0\n" + bytes(48),
    "PNM of a Pillow extension": lambda: b"PyRGBA\n4 3\n255\n" + bytes(48),
    "PSD": _psd,
    "QOI": _pil("QOI"),
    "SGI": _pil("SGI"),
    "SPIDER": _pil("SPIDER", "F"),
    "SUN": lambda: struct.pack(">8I", 0x59A66A95, 4, 3, 8, 12, 1, 0, 0)
    + bytes(12),
    "TGA": _pil("TGA"),
    "TGA RLE": _pil("TGA", compression="tga_rle"),
    "TGA colour-mapped RLE": lambda: rf.tga_mapped(
        (np.arange(9 * 14).reshape(9, 14) % 30 + 3).astype(np.uint8),
        bytes(range(7, 7 + 96)), 24, first=3, rle=True, top=False),
    "PSD PackBits": lambda: rf.psd_form("RGB", 1, h=6, w=9),
    "PSD CMYK": lambda: rf.psd_form("CMYK", 0, h=5, w=7, extra=1),
    "PSD P": lambda: rf.psd_form("P", 0, h=5, w=7),
    "QOI of every op": rf.qoi_every_op,
    "SGI RLE": lambda: rf.sgi8_rle(rf.picture(6, 9, 3)),
    "SGI 16-bit RLE": lambda: rf.sgi16(rf.picture(5, 7, 1)[..., 0]
                                       .astype(np.uint16) * 257, rle=True),
    "PCX P": _pil("PCX", "P", (40, 30)),
    "PCX of 16 colours": lambda: rf.pcx_planes(
        (np.arange(7 * 13).reshape(7, 13) % 16).astype(np.uint8), 4,
        bytes(range(48))),
    "CUR of three": lambda: rf.icon_dir(2, [
        (16, 16, 0, 24, rf.dib_icon(rf.picture(16, 16))),
        (24, 24, 0, 8, rf.dib_icon(rf.picture(24, 24), "P")),
        (20, 32, 0, 24, rf.dib_icon(rf.picture(32, 20)))]),
    "WMF": _wmf,
    "WMF of an EMF": _emf,
    "XBM": _pil("XBM", "1"),
    "XPM": lambda: b'/* XPM */\nstatic char *x[] = {\n"4 3 2 1",\n'
    b'"a c #ff0000",\n"b c None",\n"abab",\n"baba",\n"abab"\n};\n',
    "XVThumb": lambda: b"P7 332\n#comment\n#END_OF_COMMENTS\n4 3 255\n"
    + bytes(12),
}
# Pillow's format name -> the port's
PORT_NAME = {"JPEG2000": "JPEG 2000", "MCIDAS": "McIdas",
             "XVTHUMB": "XVThumb", "IPTC": "IPTC/NAA"}
# (WebP's opens and damaged files: tests/test_torch_webp.py)
PORT_DECODES = {"BMP", "GIF", "PNG", "JPEG", "MPO", "TIFF", "WEBP"}


# the formats the port decodes where the walk opens them
DECODED = {"DIB", "CUR", "PCX", "DCX", "ICO", "PSD", "QOI", "SGI", "TGA",
           "FITS", "FLI", "FTEX", "GBR", "IM", "IMT", "IPTC/NAA", "McIdas",
           "MSP", "PCD", "PIXAR", "PFM", "PNM of a Pillow extension",
           "SPIDER", "SUN", "XBM", "XPM", "XVThumb", "BLP", "DDS", "ICNS"}


def _name(key):
    """The port's name of the format of OPENABLE[key]."""
    return next(e[0] for e in unported.WALK
                if key == e[0] or key.startswith(e[0] + " "))


def pil_outcome(data, path):
    """Image.open(path)'s outcome: ("opens", the port's name of its
    format), ("OSError",), ("ValueError",) or ("other",); None where it
    opens a format the port decodes."""
    path.write_bytes(data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            im = Image.open(str(path))
        except OSError:
            return ("OSError",)
        except ValueError:
            return ("ValueError",)
        except Exception:
            return ("other",)
    fmt = im.format
    im.close()
    if fmt in PORT_DECODES:
        return None
    if fmt == "PPM":
        if data[:2] in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"):
            return None
        fmt = "PFM" if data[:2] == b"Pf" else "PNM of a Pillow extension"
    return ("opens", PORT_NAME.get(fmt, fmt))


def port_outcome(data, path=None):
    """The port's walk of `data` (written at `path`, where given)."""
    if path is not None:
        path.write_bytes(data)
    try:
        hit = unported.walk(data, None if path is None else str(path))
    except Unidentified:
        return ("OSError",)
    except PilValueError:
        return ("ValueError",)
    except (DecompressionBomb, unported.OpenError):
        return ("other",)
    return ("opens", hit[0]) if hit else ("OSError",)


def _error_class(e):
    for cls in (OSError, ValueError, IndexError):
        if isinstance(e, cls):
            return cls.__name__
    return "other"


def pil_decode(data, path):
    """Image.open(path) and its convert("RGB"): ("ok", array), or (the
    stage, "open" or "load", the error's class)."""
    path.write_bytes(data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            im = Image.open(str(path))
        except Exception as e:
            return ("open", _error_class(e))
        try:
            return ("ok", np.asarray(im.convert("RGB")))
        except Exception as e:
            return ("load", _error_class(e))


def same_decode(want, got):
    if want[0] != got[0]:
        return False
    if want[0] == "ok":
        return want[1].shape == got[1].shape and (want[1] == got[1]).all()
    return want[1] == got[1]


def port_decode(data, path):
    """The port's walk (its open) and load, as `pil_decode`."""
    path.write_bytes(data)
    try:
        hit = unported.walk(data, str(path))
    except Exception as e:
        return ("open", _error_class(e))
    if hit is None:
        return ("open", "OSError")
    try:
        return ("ok", read_rgb8(str(path)))
    except Exception as e:
        return ("load", _error_class(e))


def variants(key, data, rng):
    """Damaged copies of `data`: cut short, 1 to 3 bytes changed (most in
    its first 140 bytes), bytes added after it or after its first 16."""
    n = len(data)
    cuts = {1, 2, 4, 8, 12, 16, 20, 26, 32, 44, 64, 68, 100, 108, 128, 256,
            512, *(int(c) for c in rng.integers(1, max(2, n), 8))}
    out = [data[:c] for c in sorted(cuts) if c < n]
    tails = [data + rng.integers(0, 256, 64).astype(np.uint8).tobytes(),
             data[:16] + rng.integers(0, 256, 300).astype(np.uint8).tobytes()]
    if key == "AVIF":
        return out + tails[:1]
    if _name(key) in DECODED and key != "ICO":
        # the decoded formats: bytes changed anywhere (palettes, offset
        # tables, RLE data), and more cuts
        out += [data[:c] for c in rng.integers(1, n, 8)]
        for _ in range(24):
            d = bytearray(data)
            for _ in range(int(rng.integers(1, 4))):
                d[int(rng.integers(0, n))] = int(rng.integers(0, 256))
            out.append(bytes(d))
    span = 22 if key == "ICO" else min(n, 140)
    for _ in range(36):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, span)) if key == "ICO" or \
                rng.random() < 0.8 else int(rng.integers(0, n))
            d[i] = int(rng.choice([0, 1, 255, 0x7F,
                                   int(rng.integers(0, 256))]))
        out.append(bytes(d))
    return (out if key == "ICO" else out + tails)


def _pil_load_error(path):
    """The OSError Pillow's load of `path` raises, or None."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            Image.open(str(path)).load()
        except OSError as e:
            return str(e)
    return None


@pytest.mark.parametrize("key", sorted(OPENABLE))
def test_each_unported_format_opens_in_pillow_and_is_refused_by_name(
        key, tmp_path):
    """A file of each format opens in Pillow and in the port's walk; the
    port decodes it as Pillow does (the formats it decodes), fails with
    Pillow's load error (the formats whose load always fails) or refuses
    it by name (the others)."""
    data = OPENABLE[key]()
    name = _name(key)
    path = tmp_path / "a.img"
    assert pil_outcome(data, path) == ("opens", name)
    assert unported.walk(data)[0] == name
    if name in DECODED:
        assert unported.identify(data) is None
        assert same_decode(pil_decode(data, path), port_decode(data, path))
        return
    assert unported.identify(data) == name
    msg = unported.load_fails(name)
    if msg is not None:
        assert _pil_load_error(path) == msg
        with pytest.raises(OSError) as e:
            read_rgb8(str(path))
        assert str(e.value) == msg and not isinstance(e.value, Unidentified)
        return
    with pytest.raises(NotImplementedError, match=f"{name} image"):
        read_rgb8(str(path))


def test_every_format_in_the_table_has_a_file():
    """The walk's table has a file of each format; the table of formats
    refused by name holds neither the decoded ones nor WebP."""
    assert {e[0] for e in unported.WALK} - {"WebP"} == \
        {_name(k) for k in OPENABLE}
    assert {n for n, _, _ in unported.FORMATS} == \
        {_name(k) for k in OPENABLE} - DECODED
    assert {e[0] for e in unported.WALK if e[3] is not None} == \
        DECODED | {"WebP"}


@pytest.mark.parametrize("key", sorted(OPENABLE))
def test_damaged_files_open_or_fail_as_in_pillow(key, tmp_path):
    """Each damaged copy opens, fails with OSError, ValueError or another
    error in the port's walk as in Pillow's Image.open; where it opens as
    a format the port decodes, the port's load gives Pillow's array or
    fails with the error class Pillow's load raises."""
    rng = np.random.default_rng(sorted(OPENABLE).index(key))
    wrong = []
    for i, data in enumerate(variants(key, OPENABLE[key](), rng)):
        want = pil_outcome(data, tmp_path / "v.img")
        if want is None:
            continue
        got = port_outcome(data, tmp_path / "v.img")
        if got != want:
            wrong.append((i, len(data), want, got))
        elif want[0] == "opens" and want[1] in DECODED:
            w = pil_decode(data, tmp_path / "v.img")
            g = port_decode(data, tmp_path / "v.img")
            if not same_decode(w, g):
                wrong.append((i, len(data), w[:2] if w[0] != "ok" else "ok",
                              g[:2] if g[0] != "ok" else "ok"))
    assert not wrong, wrong


# the formats whose load always fails in Pillow here (EPS: no gs)
LOAD_FAILS = ["BUFR", "GRIB", "HDF5", "WMF", "WMF of an EMF", "MPEG", "EPS"]


@pytest.mark.parametrize("key", LOAD_FAILS)
def test_formats_whose_load_fails_give_the_references_outcome(key, tmp_path,
                                                              both, capsys):
    """A file Pillow opens and cannot load: `load_std_image` and
    `load_hald_clut` raise its OSError with no external loader tried, an
    external mask leaves the region unmasked (the reference's
    ``except OSError``), a PSF image gives None and ``--check-lut`` the
    reference's exit code and text."""
    import shutil

    from art_tpu import cli as ref_cli
    from art_tpu.color.lut3d import load_hald_clut as ref_hald
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu.ops.sharpen import load_psf_kernel as ref_psf
    from art_tpu_torch import cli
    from art_tpu_torch.color.lut3d import load_hald_clut
    from art_tpu_torch.masks import load_external_mask
    from art_tpu_torch.ops.sharpen import load_psf_kernel

    if key == "EPS" and shutil.which("gs"):
        pytest.skip("Ghostscript renders EPS here")
    iodir, run = both
    marker = tmp_path / "ran"
    script = tmp_path / "mark.py"
    script.write_text(f"open({str(marker)!r}, 'w').close()\n")
    (iodir / "img.txt").write_text(
        f"[ART ImageIO]\nExtension=img\nReadCommand={sys.executable} "
        f"{script}\n")
    path = tmp_path / "a.img"
    path.write_bytes(OPENABLE[key]())
    msg = _pil_load_error(path)
    assert msg == unported.load_fails(_name(key))
    errors = {}
    for package, load in (("ref", ref_load), ("port", load_std_image)):
        with pytest.raises(OSError) as e:
            run(package, lambda: load(str(path)))
        errors[package] = str(e.value)
    assert errors["port"] == errors["ref"] == msg
    assert not marker.exists()
    for load in (ref_hald, load_hald_clut):
        with pytest.raises(OSError, match=msg):
            load(str(path))
    with pytest.raises(OSError, match=msg):
        ref_mask(str(path), 8, 8, False)
    assert load_external_mask(str(path), 8, 8, False) is None
    assert ref_psf(str(path)) is None and load_psf_kernel(str(path)) is None
    from test_torch_profiles import _check_lut

    lut = tmp_path / "a.png"
    lut.write_bytes(OPENABLE[key]())
    assert _check_lut(cli.main, lut, capsys) == \
        _check_lut(ref_cli.main, lut, capsys)


# files that take a plugin's accept test and fail its open
REJECTED = {
    # no " EMF" at byte 40: WmfImagePlugin raises SyntaxError
    "wmf": b"\x01\x00\x00\x00" + bytes(3000),
    # a 40-byte header of 0 bits: BmpImagePlugin raises OSError
    "dib": b"(\0\0\0" + bytes(3000),
    # an empty bounding box: PcxImagePlugin raises SyntaxError
    "pcx": b"\x0a\x05\x01\x08" + bytes(3000),
}


@pytest.mark.parametrize("ext", sorted(REJECTED))
def test_rejected_by_its_plugin_reaches_the_external_loader(ext, tmp_path,
                                                             both):
    """Pillow's open of these fails with an OSError, so the reference
    hands them to the [ART ImageIO] loader of their extension; so does the
    port, with equal frames."""
    from test_torch_iomanager import _tiff_writer

    iodir, run = both
    conv = _tiff_writer(tmp_path)
    (iodir / f"{ext}.txt").write_text(
        f"[ART ImageIO]\nExtension={ext}\nReadCommand={sys.executable} "
        f"{conv}\n")
    src = tmp_path / f"a.{ext}"
    src.write_bytes(REJECTED[ext])
    with pytest.raises(OSError):
        Image.open(str(src))
    with pytest.raises(Unidentified):
        read_rgb8(str(src))
    ref = run("ref", lambda: ref_load(str(src)))
    got = run("port", lambda: load_std_image(str(src)))
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    assert got.filename == ref.filename
