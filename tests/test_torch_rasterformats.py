"""The simple raster formats the reference opens through Pillow, decoded by
the port (`art_tpu_torch.io.rasterformats` over `io/native/rasterdec.cc`)
on the CPU against Pillow 12.1.0 and, through the consumers, against
`art_tpu`:

- each form through the four readers (`read_rgb8` against Pillow's
  ``convert("RGB")``, `read_grey` against the mask path's mode rule,
  `read_image`, `load_std_image` against the reference's), bit for bit:
  the files Pillow writes (DIB; ICO of PNG and bitmap icons; TGA raw and
  RLE in L, LA, P, RGB, RGBA, both origins; QOI; PCX in 1, L, P, RGB;
  SGI in L, RGB, RGBA) and those written by hand (tests/util_rasterforms.py:
  cursors, DCX, PSD in every mode of ``PsdImagePlugin.MODES`` raw and
  PackBits with extra channels, a layer section and an ICC resource,
  16-bit and RLE SGI, TGA colour maps with a first index and 16-, 24- and
  32-bit entries, PCX bit planes, QOI streams of every op); forms Pillow
  opens and fails to load, or fails to open, fail alike;
- Pillow's LAB to RGB (LittleCMS) on all 2^24 triples;
- the consumers (`load_image`, `load_hald_clut`, `load_external_mask`,
  `load_psf_kernel`) against the reference's on files of these formats.

The damaged files of each format (cut, bytes changed) are in
tests/test_torch_unported.py.
"""

import io
import struct

import numpy as np
import pytest

from art_tpu_torch.io import rasterformats, unported
from art_tpu_torch.io.imagefile import read_rgb8
from art_tpu_torch.io.stdformats import PilIndexError, PilValueError

import chip_smoke
import util_rasterforms as rf
from test_torch_formats import bmp, check_readers

Image = pytest.importorskip("PIL.Image")


def _save(img, fmt, mode=None, **kw):
    def make():
        im = Image.fromarray(img)
        if mode is not None:
            im = im.convert(mode)
        return rf.pil_bytes(im, fmt, **kw)
    return make


PIC = rf.picture(23, 37, 3, seed=1)
PIC4 = rf.picture(23, 37, 4, seed=2)
SQ = rf.picture(48, 48, 3, seed=3)
SQ4 = rf.picture(48, 48, 4, seed=4)

FORMS = {}
for _m in ("RGB", "RGBA", "P", "L", "1"):
    FORMS[f"DIB {_m}"] = _save(PIC4 if _m == "RGBA" else PIC, "DIB", _m)
FORMS["ICO PNG sizes"] = _save(SQ4, "ICO", sizes=[(16, 16), (32, 32),
                                                 (48, 48)])
FORMS["ICO PNG grey"] = _save(SQ, "ICO", "L", sizes=[(32, 32)])
for _m in ("RGB", "RGBA", "P", "L", "1"):
    FORMS[f"ICO bitmap {_m}"] = _save(SQ4 if _m == "RGBA" else SQ, "ICO",
                                      _m, bitmap_format="bmp",
                                      sizes=[(16, 16), (48, 48)])
for _m in ("L", "LA", "P", "RGB", "RGBA"):
    for _rle in (False, True):
        for _o in (1, -1):
            FORMS[f"TGA {_m} {'rle' if _rle else 'raw'} "
                  f"{'top' if _o == 1 else 'bottom'}"] = _save(
                PIC4 if _m in ("LA", "RGBA") else PIC, "TGA", _m,
                compression="tga_rle" if _rle else None, orientation=_o)
for _m in ("RGB", "RGBA"):
    FORMS[f"QOI {_m}"] = _save(PIC4 if _m == "RGBA" else PIC, "QOI", _m)
for _m in ("1", "L", "P", "RGB"):
    FORMS[f"PCX {_m}"] = _save(PIC, "PCX", _m)
    FORMS[f"PCX {_m} even"] = _save(rf.picture(20, 36, 3, 5), "PCX", _m)
for _m in ("L", "RGB", "RGBA"):
    FORMS[f"SGI {_m}"] = _save(PIC4 if _m == "RGBA" else PIC, "SGI", _m)
    FORMS[f"SGI {_m} 16-bit"] = _save(PIC4 if _m == "RGBA" else PIC, "SGI",
                                      _m, bpc=2)

# written by hand
FORMS["CUR one"] = lambda: rf.icon_dir(2, [(24, 24, 0, 24,
                                            rf.dib_icon(SQ[:24, :24]))])
FORMS["CUR largest of three"] = lambda: rf.icon_dir(2, [
    (16, 16, 0, 24, rf.dib_icon(SQ[:16, :16])),
    (24, 24, 0, 8, rf.dib_icon(SQ[:24, :24], "P")),
    (20, 32, 0, 24, rf.dib_icon(SQ[:32, :20]))])
FORMS["CUR 32-bit at 22"] = lambda: rf.icon_dir(2, [
    (16, 16, 0, 32, rf.dib_icon(SQ4[:16, :16], "RGBA"))])
FORMS["CUR grey"] = lambda: rf.icon_dir(2, [
    (16, 16, 0, 8, rf.dib_icon(SQ[:16, :16], "L"))])
FORMS["ICO of two depths at one size"] = lambda: rf.icon_dir(1, [
    (24, 24, 0, 32, rf.dib_icon(SQ4[:24, :24], "RGBA")),
    (24, 24, 0, 8, rf.dib_icon(SQ[:24, :24], "P")),
    (16, 16, 0, 24, rf.dib_icon(SQ[:16, :16]))])
FORMS["ICO of a PNG and a bitmap"] = lambda: rf.icon_dir(1, [
    (16, 16, 0, 32, rf.pil_bytes(Image.fromarray(SQ4[:16, :16]), "PNG")),
    (32, 32, 0, 24, rf.dib_icon(SQ[:32, :32]))])
FORMS["ICO of a 16-bit grey PNG"] = lambda: rf.icon_dir(1, [
    (20, 20, 0, 16, rf.pil_bytes(Image.fromarray(
        (rf.picture(20, 20, 1)[..., 0].astype(np.uint16) * 300)), "PNG"))])
FORMS["DCX"] = lambda: rf.dcx(_save(PIC, "PCX")(), _save(SQ, "PCX", "L")())
FORMS["DCX of P"] = lambda: rf.dcx(_save(PIC, "PCX", "P")())
for _name in ("1", "L", "P", "RGB", "RGBA", "CMYK", "LAB", "L multichannel",
              "L duotone"):
    for _comp in (0, 1):
        FORMS[f"PSD {_name} {'packbits' if _comp else 'raw'}"] = (
            lambda n=_name, c=_comp: rf.psd_form(n, c, seed=len(n)))
FORMS["PSD L from bitmap mode at 8 bits"] = lambda: rf.psd_form("L bitmap 8")
FORMS["PSD P without a palette"] = lambda: rf.psd(
    2, rf.picture(7, 9, 1)[None, ..., 0])
FORMS["PSD RGB of 5 channels"] = lambda: rf.psd_form("RGB", 1, extra=2)
FORMS["PSD CMYK of 5 channels"] = lambda: rf.psd_form("CMYK", 0, extra=1)
FORMS["PSD L of 2 channels"] = lambda: rf.psd_form("L", 1, extra=1)
FORMS["PSD with layers and ICC"] = lambda: rf.psd_form(
    "RGB", 1, icc=rf.rgb_icc(), layers=True)
FORMS["PSD LAB with ICC"] = lambda: rf.psd_form("LAB", 0, icc=rf.rgb_icc())
FORMS["PSD with a resource"] = lambda: rf.psd(
    1, rf.picture(6, 10, 1)[None, ..., 0],
    resources=b"8BIM" + struct.pack(">HB", 1005, 3) + b"abc"
    + struct.pack(">I", 5) + b"12345\0")
FORMS["PSD compression 2"] = lambda: (
    lambda d: d[:38] + b"\0\2" + d[40:])(rf.psd(3, np.zeros((3, 4, 5),
                                                          np.uint8)))
FORMS["SGI L RLE"] = lambda: rf.sgi8_rle(PIC[..., 0])
FORMS["SGI RGB RLE"] = lambda: rf.sgi8_rle(PIC)
FORMS["SGI RGBA RLE"] = lambda: rf.sgi8_rgba_rle(PIC4)
FORMS["SGI 16-bit L RLE"] = lambda: rf.sgi16(
    PIC[..., 0].astype(np.uint16) * 257 + 3, rle=True)
FORMS["SGI 16-bit RGB RLE"] = lambda: rf.sgi16(
    PIC.astype(np.uint16) * 251, rle=True)
FORMS["SGI 16-bit RGB raw"] = lambda: rf.sgi16(PIC.astype(np.uint16) * 251)
_IDX = (np.arange(23 * 37).reshape(23, 37) * 7 % 50).astype(np.uint8)
for _bits in (16, 24, 32):
    for _first in (0, 6):
        for _rle in (False, True):
            FORMS[f"TGA map {_bits}-bit first {_first} "
                  f"{'rle' if _rle else 'raw'}"] = (
                lambda b=_bits, f=_first, r=_rle: rf.tga_mapped(
                    _IDX + f, np.random.default_rng(b).integers(
                        0, 256, 50 * b // 8).astype(np.uint8).tobytes(),
                    b, first=f, rle=r, top=not r))
FORMS["TGA map 15-bit"] = lambda: rf.tga_mapped(
    _IDX, bytes(range(100)), 15)
FORMS["TGA map short"] = lambda: rf.tga_mapped(_IDX, bytes(range(60)), 24)
FORMS["TGA map of 300 entries"] = lambda: rf.tga_mapped(
    _IDX, bytes(900), 24)
FORMS["TGA flipped"] = lambda: rf.tga_mapped(
    _IDX, bytes(range(150)), 24, flip=True, top=False)
FORMS["PCX 16 colours"] = lambda: rf.pcx_planes(
    (np.arange(11 * 29).reshape(11, 29) % 16).astype(np.uint8), 4,
    np.random.default_rng(1).integers(0, 256, 48).astype(np.uint8))
FORMS["PCX 4 colours"] = lambda: rf.pcx_planes(
    (np.arange(11 * 21).reshape(11, 21) % 4).astype(np.uint8), 2,
    np.random.default_rng(2).integers(0, 256, 48).astype(np.uint8))
FORMS["PCX 16 colours, stride as given"] = lambda: rf.pcx_planes(
    (np.arange(9 * 24).reshape(9, 24) % 16).astype(np.uint8), 4,
    bytes(range(48)), stride=3)
FORMS["PCX 2-bit"] = lambda: rf.pcx_planes(
    (np.arange(5 * 8).reshape(5, 8) % 4).astype(np.uint8), 1, bytes(48),
    bits=2)
# bitmaps whose palette is the grey ramp: Pillow reads mode "L" a byte a
# pixel whatever the depth (a file opened by name maps its rows, which may
# overlap), mode "1" (two colours, black and white) as bits
_RAMP16 = [(i, i, i) for i in range(16)]
_NIB = (np.arange(7 * 37).reshape(7, 37) % 16).astype(np.uint8)


def _packed(idx, bits):
    h, w = idx.shape
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    packed = np.packbits(np.unpackbits(idx[..., None], axis=2)[
        ..., 8 - bits :].reshape(h, -1), axis=1)
    rows[:, : packed.shape[1]] = packed
    return rows[::-1].tobytes()


FORMS["BMP 4-bit grey ramp"] = lambda: bmp(_packed(_NIB, 4), 4, 37, 7,
                                           palette=_RAMP16)
FORMS["BMP 4-bit grey ramp, 4 wide"] = lambda: bmp(
    _packed(_NIB[:, :4], 4), 4, 4, 7, palette=_RAMP16)
FORMS["BMP 8-bit of black and white"] = lambda: bmp(
    _packed(_NIB * 16, 8), 8, 37, 7, palette=[(0, 0, 0), (255, 255, 255)])
FORMS["DIB 4-bit grey ramp"] = lambda: bmp(_packed(_NIB, 4), 4, 37, 7,
                                           palette=_RAMP16)[14:]
FORMS["ICO of a 4-bit grey-ramp bitmap"] = lambda: rf.icon_dir(1, [
    (37, 7, 16, 4, bmp(_packed(np.concatenate([_NIB, _NIB]), 4), 4, 37, 14,
                       palette=_RAMP16)[14:])])
FORMS["ICO of a 4-bit grey-ramp bitmap, 4 wide"] = lambda: rf.icon_dir(1, [
    (4, 7, 16, 4, bmp(_packed(np.concatenate([_NIB, _NIB])[:, :4], 4), 4, 4,
                      14, palette=_RAMP16)[14:])])
FORMS["BMP of 300 colours"] = lambda: bmp(
    _packed(_NIB, 8), 8, 37, 7, palette=np.random.default_rng(3).integers(
        0, 256, (300, 3)))
FORMS["QOI every op"] = rf.qoi_every_op
FORMS["QOI every op, RGB"] = lambda: rf.qoi_every_op()[:12] + b"\3" \
    + rf.qoi_every_op()[13:]


def _outcome(fn):
    try:
        return ("ok", fn())
    except OSError:
        return ("OSError",)
    except ValueError:
        return ("ValueError",)
    except IndexError:
        return ("IndexError",)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_forms_decode_as_pillow(form, tmp_path):
    data = FORMS[form]()
    path = str(tmp_path / "a.img")
    with open(path, "wb") as f:
        f.write(data)
    want = _outcome(lambda: np.asarray(Image.open(path).convert("RGB")))
    if want[0] != "ok":
        assert _outcome(lambda: read_rgb8(path))[0] == want[0]
        return
    hit = unported.walk(data)  # None for a BMP, read before the walk
    assert Image.open(path).format == (hit[0] if hit else "BMP")
    check_readers(path)


def test_every_form_of_the_table_is_held():
    """Every decoded format and every (mode, bits) of
    ``PsdImagePlugin.MODES`` has a form."""
    from PIL import PsdImagePlugin

    datas = [FORMS[k]() for k in sorted(FORMS)]
    names = set()
    for d in datas:
        try:
            hit = unported.walk(d)
        except OSError:  # the forms Pillow's open refuses
            hit = None
        if hit is not None:
            names.add(hit[0])
    assert {"DIB", "ICO", "CUR", "TGA", "PSD", "QOI", "PCX", "DCX",
            "SGI"} <= names
    psd_modes = {(struct.unpack_from(">H", d, 24)[0],
                  struct.unpack_from(">H", d, 22)[0])
                 for d in datas if d[:4] == b"8BPS"}
    assert set(PsdImagePlugin.MODES) <= psd_modes


def test_qoi_every_op_is_read():
    """The hand-written stream: the ops decode as Pillow's decoder reads
    them (a run past the image's end is cut)."""
    data = rf.qoi_every_op()
    _, rgb, _ = rasterformats.read_qoi(data, "x")
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(rgb, want)
    assert (rgb[0, 0] == (10, 20, 30)).all()


def test_qoi_cut_short_fails_as_pillow(tmp_path):
    data = rf.qoi_every_op()
    for cut, err in ((14, PilIndexError), (15, PilValueError),
                     (16, PilValueError), (22, PilValueError),
                     (25, PilIndexError)):
        path = tmp_path / "q.qoi"
        path.write_bytes(data[:cut])
        with pytest.raises(err.__mro__[1]):
            Image.open(str(path)).load()
        with pytest.raises(err):
            read_rgb8(str(path))


def test_lab_to_rgb_on_all_2_24_triples():
    """Pillow's LAB -> RGB (LittleCMS: Lab D50 to its sRGB through a 33^3
    CLUT) on every triple of Pillow's LAB bytes, bit for bit."""
    v = np.arange(1 << 24, dtype=np.uint32)
    lab = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                   -1).astype(np.uint8)
    del v
    # Pillow's "LAB" raw mode stores a and b with their sign bit flipped
    raw = lab.copy()
    raw[:, 1:] ^= 128
    want = np.asarray(Image.frombytes("LAB", (4096, 4096), raw.tobytes())
                      .convert("RGB")).reshape(-1, 3)
    del raw
    got = rasterformats.lab_to_rgb(lab)
    bad = np.nonzero((got != want).any(1))[0]
    assert bad.size == 0, (lab[bad[:5]], got[bad[:5]], want[bad[:5]])


# -- the consumers ----------------------------------------------------------

def _write(tmp_path, name, data):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return p


def _rgb_files(tmp_path, rgb, stem):
    """`rgb` ((H, W, 3) uint8) in each of the new formats."""
    planes = np.moveaxis(rgb, -1, 0)
    j = lambda n: str(tmp_path / f"{stem}.{n}")  # noqa: E731
    return {
        "tga": chip_smoke.write_tga(j("tga"), rgb, rle=True),
        "psd": chip_smoke.write_psd(j("psd"), planes, packbits=True),
        "psd icc": chip_smoke.write_psd(j("icc.psd"), planes,
                                        icc=rf.rgb_icc()),
        "qoi": chip_smoke.write_qoi(j("qoi"), rgb),
        "pcx": chip_smoke.write_pcx(j("pcx"), rgb),
        "sgi": chip_smoke.write_sgi(j("sgi"), rgb),
        "dib": _write(tmp_path, f"{stem}.dib",
                      rf.pil_bytes(Image.fromarray(rgb), "DIB")),
    }


def test_hald_clut_from_the_raster_formats(tmp_path):
    from art_tpu.color.lut3d import load_hald_clut as ref_hald
    from art_tpu_torch.color.lut3d import load_hald_clut

    hald = chip_smoke.hald_image(4, 8)  # 64x64
    for kind, path in _rgb_files(tmp_path, hald, "h").items():
        np.testing.assert_array_equal(load_hald_clut(path), ref_hald(path),
                                      err_msg=kind)


def test_external_mask_from_the_raster_formats(tmp_path):
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu_torch.masks import load_external_mask

    grey = chip_smoke.f2_mask(40, 60).astype(np.uint8)
    files = _rgb_files(tmp_path, np.repeat(grey[..., None], 3, 2), "m")
    files["sgi grey"] = chip_smoke.write_sgi(str(tmp_path / "g.sgi"), grey)
    files["psd grey"] = _write(tmp_path, "g.psd", rf.psd(1, grey[None]))
    files["tga grey"] = _write(tmp_path, "g.tga", rf.pil_bytes(
        Image.fromarray(grey), "TGA", compression="tga_rle"))
    files["ico 16-bit"] = _write(tmp_path, "g.ico", FORMS[
        "ICO of a 16-bit grey PNG"]())
    for kind, path in files.items():
        for inverted in (False, True):
            want = ref_mask(path, 48, 72, inverted)
            got = load_external_mask(path, 48, 72, inverted)
            np.testing.assert_array_equal(got, want, err_msg=kind)


def test_psf_image_from_the_raster_formats(tmp_path):
    from art_tpu.ops.sharpen import load_psf_kernel as ref_psf
    from art_tpu_torch.ops.sharpen import load_psf_kernel

    yy, xx = np.mgrid[-4:5, -4:5]
    k = np.round(255 * np.exp(-(xx ** 2 + yy ** 2) / 6.0)).astype(np.uint8)
    rgb = np.repeat(k[..., None], 3, 2)
    for kind, path in _rgb_files(tmp_path, rgb, "k").items():
        for scale in (1.0, 2.0):
            want, got = ref_psf(path, scale), load_psf_kernel(path, scale)
            assert (want is None) == (got is None), kind
            np.testing.assert_array_equal(got, want, err_msg=kind)


def test_load_image_of_the_raster_formats(tmp_path):
    import art_tpu
    import art_tpu_torch

    files = _rgb_files(tmp_path, rf.picture(24, 40, 3, 7), "a")
    files["psd lab icc"] = _write(tmp_path, "lab.psd", FORMS[
        "PSD LAB with ICC"]())
    files["sgi 16"] = _write(tmp_path, "a16.sgi", FORMS[
        "SGI 16-bit RGB RLE"]())
    for kind, path in files.items():
        ref, got = art_tpu.load_image(path), art_tpu_torch.load_image(path)
        np.testing.assert_array_equal(got.rgb, ref.rgb, err_msg=kind)
        assert got.filename == ref.filename
