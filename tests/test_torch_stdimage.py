"""Non-raw input on the CPU: `art_tpu_torch.io.imagefile.load_std_image`
against `art_tpu.io.imagefile.load_std_image` on the same files, and the
port's model of LittleCMS 2.17 (`art_tpu_torch.color.lcms`) against
Pillow 12.1.0's ``ImageCms`` (which links it). The files are written
here with Pillow; the port decodes them with its own reader.

- Every form of Pillow's modes that the reference branches on: 8-bit
  RGB, RGBA, grey, grey and alpha, palette and 1-bit PNGs and 16-bit RGB
  PNG and TIFF (all through ``convert("RGB")``), 16-bit grey PNG and
  little-endian TIFF (``I;16``), big-endian (``I;16B``), 32-bit and
  signed 16-bit integer TIFF (``I``), float TIFF (``F``), JPEG, and
  JPEG-compressed TIFF (RGB, YCbCr 4:4:4 and, hand-built, 4:2:0 over
  several strips, grey): the RawFrame field for field, ``rgb`` bit-equal.
- Embedded profiles (PNG iCCP, TIFF tag 34675, JPEG APP2 in one and in
  several chunks): LittleCMS's own sRGB, Adobe RGB, ProPhoto and Rec.
  2020 matrix/TRC profiles (sampled ``curv``), a gamma ``curv`` and a v4
  ``para`` profile: bit-equal; the model on all 2^24 colours for two of
  them. A LUT-class profile (mAB, mft2, mft1; v2 and v4): within one
  code of LittleCMS's 8-bit prelinearised CLUT on random colours, the
  grey ramp and the grid nodes. Where LittleCMS refuses (a
  grey or CMYK profile on an RGB image, bytes cut short, an empty tag, a
  bad signature) both leave the image unconverted; where it would link a
  profile the model does not cover, the port raises naming it.
- The built-in sRGB the model builds from its definition against the
  tags of ``ImageCms.createProfile("sRGB")``'s bytes.
"""

import io
import os
import struct

import numpy as np
import pytest

from art_tpu.io.imagefile import load_std_image as ref_load
from art_tpu_torch.color import iccwrite, lcms
from art_tpu_torch.io.imagefile import load_std_image, read_image
from chip_smoke import _curv, _icc_bytes, _lattice, _s15f16, _u16

Image = pytest.importorskip("PIL.Image")
ImageCms = pytest.importorskip("PIL.ImageCms")

RNG = np.random.default_rng(7)
RGB8 = RNG.integers(0, 256, (29, 43, 3), dtype=np.uint8)
G16 = RNG.integers(0, 65536, (29, 43), dtype=np.uint16)
G16[0, :4] = (0, 100, 255, 300)


def scene(h, w):
    """A smooth scene with a little noise (JPEG fixtures)."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y) % 256, (y * 2) % 256,
                     ((x + y) * 5) % 256], -1)
    noise = np.random.default_rng(1).integers(-12, 12, base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def assert_same_frame(path):
    ref = ref_load(str(path))
    got = load_std_image(str(path))
    assert got.rgb.dtype == np.float32 and got.rgb.shape == ref.rgb.shape
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    np.testing.assert_array_equal(got.cfa, ref.cfa)
    assert got.cfa.dtype == ref.cfa.dtype
    assert (got.pattern, got.filename, got.is_raw) == (
        ref.pattern, ref.filename, ref.is_raw)
    return got


def _save(path, img, **kw):
    img.save(path, **kw)
    return path


# Pillow's mode of each fixture, as the reference's branches read it
FORMS = {
    "rgb8-png": ("RGB", lambda p: _save(p + ".png", Image.fromarray(RGB8))),
    "rgba-png": ("RGBA", lambda p: _save(p + ".png", Image.fromarray(
        np.dstack([RGB8, RGB8[..., :1]])))),
    "l-png": ("L", lambda p: _save(p + ".png", Image.fromarray(RGB8[..., 0]))),
    "la-png": ("LA", lambda p: _save(p + ".png", Image.fromarray(
        RGB8[..., :2].copy(), "LA"))),
    "p-png": ("P", lambda p: _save(p + ".png", Image.fromarray(RGB8).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=50))),
    "1bit-png": ("1", lambda p: _save(p + ".png", Image.fromarray(
        RGB8[..., 0] > 128))),
    "i16-png": ("I;16", lambda p: _save(p + ".png", Image.fromarray(G16))),
    "rgb16-png": ("RGB", lambda p: _rgb48_png(p + ".png")),
    "rgb8-tif": ("RGB", lambda p: _save(p + ".tif", Image.fromarray(RGB8))),
    "rgb16-tif": ("RGB", lambda p: _tiff(p + ".tif", RNG.integers(
        0, 65536, (29, 43, 3)).astype(np.uint16), photo=2)),
    "l-tif-deflate": ("L", lambda p: _save(p + ".tif", Image.fromarray(
        RGB8[..., 1]), compression="tiff_adobe_deflate")),
    "i16-tif": ("I;16", lambda p: _tiff(p + ".tif", G16)),
    "i16-whiteiszero-tif": ("I;16", lambda p: _tiff(p + ".tif", G16,
                                                     photo=0)),
    "i16b-tif": ("I;16B", lambda p: _tiff(p + ".tif", G16, le=False)),
    "i32-tif": ("I", lambda p: _save(p + ".tif", Image.fromarray(
        RNG.integers(-300, 90000, (29, 43)).astype(np.int32), "I"))),
    "u32-tif": ("I", lambda p: _tiff(p + ".tif", RNG.integers(
        0, 1 << 32, (29, 43), dtype=np.uint64).astype(np.uint32), fmt=1)),
    "i16s-tif": ("I", lambda p: _tiff(p + ".tif", RNG.integers(
        -2000, 30000, (29, 43)).astype(np.int16), fmt=2)),
    "f-tif": ("F", lambda p: _save(p + ".tif", Image.fromarray(
        RNG.uniform(-10.0, 300.0, (29, 43)).astype(np.float32), "F"))),
    "p-tif": ("P", lambda p: _save(p + ".tif", Image.fromarray(RGB8).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=20))),
    "rgb-jpg": ("RGB", lambda p: _save(p + ".jpg", Image.fromarray(
        scene(29, 43)), quality=90)),
    "l-jpg": ("L", lambda p: _save(p + ".jpg", Image.fromarray(
        scene(29, 43)[..., 0]))),
    "jpeg-rgb-tif": ("RGB", lambda p: _save(p + ".tif", Image.fromarray(
        scene(200, 150)), compression="jpeg")),
    "jpeg-ycbcr-tif": ("RGB", lambda p: _save(p + ".tif", Image.fromarray(
        scene(57, 70)).convert("YCbCr"), compression="jpeg", quality=80)),
    "jpeg-l-tif": ("L", lambda p: _save(p + ".tif", Image.fromarray(
        scene(57, 70)[..., 2]), compression="jpeg")),
    "jpeg-420-strips-tif": ("RGB", lambda p: _ycbcr_strips_tiff(p + ".tif")),
}


def _rgb48_png(path):
    import zlib

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    a = RNG.integers(0, 65536, (29, 43, 3)).astype(">u2")
    rows = b"".join(b"\0" + a[y].tobytes() for y in range(29))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", 43, 29, 16, 2, 0, 0,
                                             0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
    return path


def _ifd(entries, le, data_at):
    """An IFD (and its out-of-line values) for entries of (tag, type,
    values or bytes), values placed from offset data_at."""
    e = "<" if le else ">"
    fmt = {3: "H", 4: "I"}
    entries = sorted(entries)
    extra = b""
    out = struct.pack(e + "H", len(entries))
    ext_at = data_at + 2 + 12 * len(entries) + 4
    for tag, typ, vals in entries:
        raw = vals if typ == 7 else struct.pack(
            e + fmt[typ] * len(vals), *vals)
        cnt = len(raw) if typ == 7 else len(vals)
        if len(raw) <= 4:
            out += struct.pack(e + "HHI", tag, typ, cnt) + raw.ljust(4, b"\0")
        else:
            out += struct.pack(e + "HHII", tag, typ, cnt, ext_at + len(extra))
            extra += raw + b"\0" * (len(raw) % 2)
    return out + struct.pack(e + "I", 0) + extra


def _tiff(path, arr, photo=1, le=True, fmt=1, comp=1, strips=None,
          extra=()):
    """An uncompressed (or given strips') TIFF of one IFD."""
    e = "<" if le else ">"
    h, w = arr.shape[:2]
    spp = arr.shape[2] if arr.ndim == 3 else 1
    if strips is None:
        strips = [arr.astype(arr.dtype.newbyteorder(e)).tobytes()]
        rps = h
    else:
        strips, rps = strips
    blob = b"".join(strips)
    offs = list(np.cumsum([8] + [len(s) for s in strips[:-1]]))
    entries = [(256, 4, [w]), (257, 4, [h]),
               (258, 3, [arr.dtype.itemsize * 8] * spp), (259, 3, [comp]),
               (262, 3, [photo]), (273, 4, [int(o) for o in offs]),
               (277, 3, [spp]), (278, 4, [rps]),
               (279, 4, [len(s) for s in strips]), (284, 3, [1]),
               (339, 3, [fmt] * spp), *extra]
    head = (b"II*\0" if le else b"MM\0*") + struct.pack(e + "I",
                                                       8 + len(blob))
    with open(path, "wb") as f:
        f.write(head + blob + _ifd(entries, le, 8 + len(blob)))
    return path


def _ycbcr_strips_tiff(path, h=70, w=45, rps=32):
    """YCbCr 4:2:0 JPEG strips, each a whole JPEG from Pillow's encoder."""
    a = scene(h, w)
    strips = []
    for y0 in range(0, h, rps):
        b = io.BytesIO()
        Image.fromarray(a[y0 : y0 + rps]).save(b, "JPEG", quality=85,
                                               subsampling=2)
        strips.append(b.getvalue())
    return _tiff(path, a, photo=6, comp=7, strips=(strips, rps),
                 extra=[(530, 3, [2, 2])])


@pytest.mark.parametrize("form", sorted(FORMS))
def test_every_form_loads_as_the_reference(form, tmp_path):
    from art_tpu_torch.io.imagefile import read_rgb8

    mode, write = FORMS[form]
    path = write(str(tmp_path / form))
    assert Image.open(path).mode == mode
    assert_same_frame(path)
    # and the decoder's convert("RGB"), as PIL's (a 16-bit WhiteIsZero
    # TIFF opens as I;16, not inverted; I and F through PIL's "L")
    np.testing.assert_array_equal(
        read_rgb8(path), np.asarray(Image.open(path).convert("RGB")))


def test_jpeg_tiff_decodes_as_pil(tmp_path):
    """The strips' JPEG streams with their tables, as libtiff decodes
    them: the same samples as Pillow's convert("RGB")."""
    from art_tpu_torch.io.imagefile import read_rgb8

    for form in ("jpeg-rgb-tif", "jpeg-ycbcr-tif", "jpeg-l-tif",
                 "jpeg-420-strips-tif"):
        path = FORMS[form][1](str(tmp_path / form))
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(read_rgb8(path), want)
    # Pillow writes the tables apart (tag 347) and several strips
    im = Image.open(str(tmp_path / "jpeg-rgb-tif.tif"))
    assert 347 in im.tag_v2 and len(im.tag_v2[273]) > 1


def test_old_style_jpeg_tiff_is_refused_by_name(tmp_path):
    """Old-style JPEG is decoded now (io/ojpeg.py); strips of raw samples
    under compression 6 carry no JPEG header, so libtiff's decoder setup
    fails and the load raises Pillow's OSError in both packages."""
    path = _tiff(str(tmp_path / "o.tif"), RGB8, photo=6, comp=6)
    for load in (load_std_image, ref_load):
        with pytest.raises(OSError, match="decoder error -2"):
            load(path)


# -- embedded ICC profiles ----------------------------------------------------

def lcms_srgb_bytes():
    return ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()


def para_icc():
    from chip_smoke import write_para_icc

    import tempfile

    with tempfile.TemporaryDirectory() as d:
        write_para_icc(os.path.join(d, "p.icc"))
        with open(os.path.join(d, "p.icc"), "rb") as f:
            return f.read()


def gamma_icc():
    cols = [(0.6097, 0.3111, 0.0195), (0.2053, 0.6257, 0.0609),
            (0.1492, 0.0632, 0.7446)]
    tags = [(s, b"XYZ \0\0\0\0" + _s15f16(v))
            for s, v in zip((b"rXYZ", b"gXYZ", b"bXYZ"), cols)]
    curv = b"curv\0\0\0\0" + (1).to_bytes(4, "big") + (563).to_bytes(2, "big")
    return _icc_bytes(tags + [(s, curv) for s in (b"rTRC", b"gTRC",
                                                  b"bTRC")], version=2)


def _pad4(b):
    return b + b"\0" * ((-len(b)) % 4)


def lut_icc_mab(version=4, grid=17):
    """A LUT-class input profile LittleCMS reads: an mAB A2B0 (A curves a
    square root, a CLUT squaring back with 8% more saturation, M curves,
    a 3x4 matrix to XYZ), every element 4-byte aligned."""
    from art_tpu_torch.color import colorspaces as ccs

    xs = np.linspace(0.0, 1.0, 256)
    lat = _lattice(grid) ** 2
    y = lat.mean(axis=-1, keepdims=True)
    clut = np.clip(y + 1.08 * (lat - y), 0.0, 1.0)
    mat = ccs.MATRICES_RGB_TO_XYZ["sRGB"] * (32768.0 / 65535.0) * 0.98
    blobs = {"b": b"".join(_pad4(_curv()) for _ in range(3)),
             "m": _s15f16(np.concatenate([mat.ravel(), [0.002] * 3])),
             "mc": b"".join(_pad4(_curv(xs ** 0.97)) for _ in range(3)),
             "cl": _pad4(bytes([grid] * 3 + [0] * 13) + bytes([2, 0, 0, 0])
                         + _u16(clut)),
             "a": b"".join(_pad4(_curv(np.sqrt(xs))) for _ in range(3))}
    offs, body, pos = {}, b"", 32
    for key in ("b", "m", "mc", "cl", "a"):
        offs[key] = pos
        body += blobs[key]
        pos += len(blobs[key])
    tag = (b"mAB \0\0\0\0" + bytes([3, 3, 0, 0])
           + b"".join(offs[k].to_bytes(4, "big")
                      for k in ("b", "m", "mc", "cl", "a")) + body)
    return _icc_bytes([(b"A2B0", tag)], pcs=b"XYZ ", version=version)


def lut_icc_mft2(version=2, grid=9):
    """A LUT-class profile of an mft2 A2B0 on the Lab PCS: a gamma-2.2 RGB
    to Lab in the legacy 16-bit encoding."""
    from art_tpu_torch.color import colorspaces as ccs

    xyz = np.tensordot(_lattice(grid) ** 2.2,
                       ccs.MATRICES_RGB_TO_XYZ["sRGB"].T, axes=1)
    f = np.cbrt(np.maximum(xyz / np.array([0.9642, 1.0, 0.8249]),
                           216 / 24389.0))
    lab = np.stack([(116 * f[..., 1] - 16) * 652.8 / 65535.0,
                    (500 * (f[..., 0] - f[..., 1]) + 128) * 256 / 65535.0,
                    (200 * (f[..., 1] - f[..., 2]) + 128) * 256 / 65535.0],
                   -1)
    ident = np.tile(np.linspace(0.0, 1.0, 256), 3)
    tag = (b"mft2\0\0\0\0" + bytes([3, 3, grid, 0]) + _s15f16(np.eye(3))
           + (256).to_bytes(2, "big") * 2 + _u16(ident) + _u16(lab)
           + _u16(ident))
    return _icc_bytes([(b"A2B0", tag)], pcs=b"Lab ", version=version)


def _retag(icc, sig, size=None, off=None):
    b = bytearray(icc)
    for i in range(struct.unpack(">I", b[128:132])[0]):
        p = 132 + 12 * i
        if b[p : p + 4] == sig:
            if size is not None:
                b[p + 8 : p + 12] = struct.pack(">I", size)
            if off is not None:
                b[p + 4 : p + 8] = struct.pack(">I", off)
    return bytes(b)


MATRIX_ICC = {
    "lcms-srgb": lcms_srgb_bytes,
    "adobe-curv": lambda: iccwrite.make_icc("Adobe RGB"),
    "prophoto-curv": lambda: iccwrite.make_icc("ProPhoto"),
    "rec2020-curv": lambda: iccwrite.make_icc("Rec2020"),
    "gamma-curv": gamma_icc,
    "v4-para": para_icc,
}


def _grey_icc():
    g = _icc_bytes([(b"kTRC", _curv(np.linspace(0, 1, 256) ** 2.2))])
    return g[:16] + b"GRAY" + g[20:]


REFUSED_ICC = {
    "grey-on-rgb": _grey_icc,
    "cmyk-on-rgb": lambda: (lambda a: a[:16] + b"CMYK" + a[20:])(
        iccwrite.make_icc("Adobe RGB")),
    "cut-in-tags": lambda: iccwrite.make_icc("Adobe RGB")[:600],
    "cut-in-header": lambda: iccwrite.make_icc("Adobe RGB")[:100],
    "cut-in-directory": lambda: iccwrite.make_icc("Adobe RGB")[:140],
    "empty-trc-tag": lambda: _retag(iccwrite.make_icc("Adobe RGB"), b"rTRC",
                                    size=0),
    "bad-signature": lambda: (lambda a: a[:36] + b"xxxx" + a[40:])(
        iccwrite.make_icc("Adobe RGB")),
}


@pytest.mark.parametrize("container", ["png", "tif", "jpg"])
@pytest.mark.parametrize("name", sorted(MATRIX_ICC))
def test_matrix_trc_profiles_convert_bit_equal(name, container, tmp_path):
    icc = MATRIX_ICC[name]()
    img = Image.fromarray(scene(31, 47) if container == "jpg" else RGB8)
    path = _save(str(tmp_path / f"a.{container}"), img, icc_profile=icc)
    mode, samples, got_icc = read_image(path)
    assert got_icc == Image.open(path).info["icc_profile"] == icc
    got = assert_same_frame(path)
    if name != "lcms-srgb":
        assert not np.array_equal(
            got.rgb, load_std_image_without_icc(mode, samples, path))


def load_std_image_without_icc(mode, samples, path):
    """The frame the same samples give with no profile."""
    from art_tpu_torch.color import colorspaces as cs
    from art_tpu_torch.io.imagefile import to_rgb8

    arr = to_rgb8(mode, samples).astype(np.float32) / 255.0
    return np.ascontiguousarray(np.moveaxis(cs.srgb_igamma(arr), -1, 0)
                                * 65535.0).astype(np.float32)


def test_jpeg_profile_in_several_app2_chunks(tmp_path):
    """A profile over 64 KiB rides several APP2 chunks, joined in their
    sequence order as Pillow joins them."""
    icc = iccwrite.make_icc("Rec2020") + b"\0" * 70000
    big = struct.pack(">I", len(icc)) + icc[4:]
    path = _save(str(tmp_path / "big.jpg"), Image.fromarray(scene(16, 24)),
                 icc_profile=big)
    raw = open(path, "rb").read()
    assert raw.count(b"ICC_PROFILE\0") == 2
    assert read_image(path)[2] == Image.open(path).info["icc_profile"] == big
    assert_same_frame(path)


@pytest.mark.parametrize("name", sorted(REFUSED_ICC))
def test_profiles_lcms_refuses_leave_the_image(name, tmp_path):
    icc = REFUSED_ICC[name]()
    with pytest.raises(Exception):
        ImageCms.profileToProfile(
            Image.fromarray(RGB8), ImageCms.ImageCmsProfile(io.BytesIO(icc)),
            ImageCms.createProfile("sRGB"))
    with pytest.raises(lcms.Refused):
        lcms.to_srgb(RGB8, icc)
    path = _save(str(tmp_path / "a.png"), Image.fromarray(RGB8),
                 icc_profile=icc)
    got = assert_same_frame(path)
    mode, samples, _ = read_image(path)
    np.testing.assert_array_equal(
        got.rgb, load_std_image_without_icc(mode, samples, path))


def test_profile_on_16_bit_grey_clips_first(tmp_path):
    """LittleCMS gets convert("RGB") of I;16, clipped at 255, and the
    converted 8-bit image goes on as RGB."""
    path = _save(str(tmp_path / "g.png"), Image.fromarray(G16),
                 icc_profile=iccwrite.make_icc("Adobe RGB"))
    assert Image.open(path).mode == "I;16"
    got = assert_same_frame(path)
    assert got.rgb.max() <= 65535.0 and len(np.unique(got.rgb)) <= 256


def test_profiles_the_model_does_not_cover_raise(tmp_path):
    # a TRC that does not start at 0: LittleCMS links it with black point
    # compensation through a CLUT
    cols = [(0.4361, 0.2225, 0.0139), (0.3851, 0.7169, 0.0971),
            (0.1431, 0.0606, 0.7141)]
    tags = [(s, b"XYZ \0\0\0\0" + _s15f16(v))
            for s, v in zip((b"rXYZ", b"gXYZ", b"bXYZ"), cols)]
    lifted = _curv(0.02 + 0.98 * np.linspace(0, 1, 64) ** 2.2)
    icc = _icc_bytes(tags + [(s, lifted) for s in (b"rTRC", b"gTRC",
                                                   b"bTRC")], version=2)
    ImageCms.profileToProfile(Image.fromarray(RGB8),
                              ImageCms.ImageCmsProfile(io.BytesIO(icc)),
                              ImageCms.createProfile("sRGB"))
    path = _save(str(tmp_path / "a.png"), Image.fromarray(RGB8),
                 icc_profile=icc)
    with pytest.raises(NotImplementedError, match="black point"):
        load_std_image(path)


def _all_colours():
    c = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 3)


@pytest.mark.parametrize("name", ["adobe-curv", "v4-para"])
def test_model_equals_lcms_on_every_colour(name):
    icc = MATRIX_ICC[name]()
    img = _all_colours()
    want = np.asarray(ImageCms.profileToProfile(
        Image.fromarray(img), ImageCms.ImageCmsProfile(io.BytesIO(icc)),
        ImageCms.createProfile("sRGB")))
    np.testing.assert_array_equal(lcms.to_srgb(img, icc), want)


def lut_icc_mft1(version=2, grid=9, pcs=b"XYZ "):
    """A LUT-class profile of an mft1 (8-bit) A2B0: a gamma-2.2 RGB to
    XYZ (halved into the PCS encoding) or to Lab (the 8-bit encoding),
    identity input and output tables."""
    from art_tpu_torch.color import colorspaces as ccs

    xyz = np.tensordot(_lattice(grid) ** 2.2,
                       ccs.MATRICES_RGB_TO_XYZ["sRGB"].T, axes=1)
    if pcs == b"XYZ ":
        clut = xyz * 0.5
    else:
        f = np.cbrt(np.maximum(xyz / np.array([0.9642, 1.0, 0.8249]),
                               216 / 24389.0))
        clut = np.stack([(116 * f[..., 1] - 16) / 100,
                         (500 * (f[..., 0] - f[..., 1]) + 128) / 255,
                         (200 * (f[..., 1] - f[..., 2]) + 128) / 255], -1)

    def u8(v):
        return np.round(np.clip(np.ravel(v), 0, 1) * 255).astype(
            np.uint8).tobytes()

    ident = np.tile(np.linspace(0.0, 1.0, 256), 3)
    tag = (b"mft1\0\0\0\0" + bytes([3, 3, grid, 0]) + _s15f16(np.eye(3))
           + u8(ident) + u8(clut) + u8(ident))
    return _icc_bytes([(b"A2B0", tag)], pcs=pcs, version=version)


# queue C's fault line: at most 1 code of 255, a mean of at most 2e-4 of
# full scale, against Pillow's LittleCMS (its 8-bit prelinearised CLUT)
LUT_BOUND_MAX = 1
LUT_BOUND_MEAN = 2e-4 * 255
LUT_FORMS = {"mab-v4": lambda: lut_icc_mab(4), "mab-v2": lambda: lut_icc_mab(2),
             "mft2-v2": lambda: lut_icc_mft2(2),
             "mft2-v4": lambda: lut_icc_mft2(4),
             "mft1-v2": lambda: lut_icc_mft1(2),
             "mft1-v4": lambda: lut_icc_mft1(4),
             "mft1-lab-v2": lambda: lut_icc_mft1(2, pcs=b"Lab "),
             "mft1-lab-v4": lambda: lut_icc_mft1(4, pcs=b"Lab ")}


def _lut_inputs():
    """Random colours, the grey ramp and LittleCMS's 33^3 grid nodes."""
    rnd = np.random.default_rng(0).integers(0, 256, (256 * 256, 3))
    g = np.arange(256)
    nodes = np.round(np.arange(33) * 255 / 32)
    grid = np.stack(np.meshgrid(nodes, nodes, nodes, indexing="ij"),
                    -1).reshape(-1, 3)
    return np.concatenate([rnd, np.stack([g, g, g], -1), grid]).astype(
        np.uint8)[None]


@pytest.mark.parametrize("form", sorted(LUT_FORMS))
def test_lut_class_profiles_within_the_measured_bound(form, tmp_path):
    icc = LUT_FORMS[form]()
    img = _lut_inputs()
    want = np.asarray(ImageCms.profileToProfile(
        Image.fromarray(img), ImageCms.ImageCmsProfile(io.BytesIO(icc)),
        ImageCms.createProfile("sRGB"))).astype(np.int64)
    d = np.abs(lcms.to_srgb(img, icc).astype(np.int64) - want)
    print(form, "max", d.max(), "mean", d.mean(), "beyond 0", (d > 0).mean())
    assert d.max() <= LUT_BOUND_MAX and d.mean() <= LUT_BOUND_MEAN
    # and through load_std_image, against the reference on the same file
    path = _save(str(tmp_path / "a.png"),
                 Image.fromarray(img[0, :32 * 48].reshape(32, 48, 3)),
                 icc_profile=icc)
    ref = ref_load(path).rgb
    got = load_std_image(path).rgb
    enc = [np.round(np.clip(cs_gamma(x), 0, 1) * 255) for x in (ref, got)]
    assert np.abs(enc[0] - enc[1]).max() <= LUT_BOUND_MAX


def _rippled_mft2(amp):
    """lut_icc_mft2's profile with 4096-entry input curves that carry a
    ripple of `amp` (of full scale), 300 periods: detail finer than the
    port's curve refit follows."""
    from art_tpu_torch.color import colorspaces as ccs

    xyz = np.tensordot(_lattice(9) ** 2.2, ccs.MATRICES_RGB_TO_XYZ["sRGB"].T,
                       axes=1)
    f = np.cbrt(np.maximum(xyz / np.array([0.9642, 1.0, 0.8249]),
                           216 / 24389.0))
    lab = np.stack([(116 * f[..., 1] - 16) * 652.8 / 65535.0,
                    (500 * (f[..., 0] - f[..., 1]) + 128) * 256 / 65535.0,
                    (200 * (f[..., 1] - f[..., 2]) + 128) * 256 / 65535.0],
                   -1)
    x = np.linspace(0.0, 1.0, 4096)
    ripple = np.clip(x + amp * np.sin(x * 2 * np.pi * 300), 0.0, 1.0)
    ident = np.tile(np.linspace(0.0, 1.0, 256), 3)
    tag = (b"mft2\0\0\0\0" + bytes([3, 3, 9, 0]) + _s15f16(np.eye(3))
           + (4096).to_bytes(2, "big") + (256).to_bytes(2, "big")
           + _u16(np.tile(ripple, 3)) + _u16(lab) + _u16(ident))
    return _icc_bytes([(b"A2B0", tag)], pcs=b"Lab ", version=2)


@pytest.mark.parametrize("amp", [0.004, 0.02])
def test_lut_class_profile_the_model_cannot_meet_is_refused(amp, tmp_path,
                                                             monkeypatch):
    """A LUT-class profile whose A2B0 curves have detail the port's refit
    does not follow: Pillow links it; the model, unchecked, would be more
    than one code off, so it raises NotImplementedError naming the curves
    (in `lcms.to_srgb` and in `load_std_image`) instead of returning the
    wrong image."""
    icc = _rippled_mft2(amp)
    img = _lut_inputs()
    want = np.asarray(ImageCms.profileToProfile(
        Image.fromarray(img), ImageCms.ImageCmsProfile(io.BytesIO(icc)),
        ImageCms.createProfile("sRGB"))).astype(np.int64)
    with pytest.raises(NotImplementedError, match="A2B0 in curves"):
        lcms.to_srgb(img, icc)
    path = _save(str(tmp_path / "a.png"),
                 Image.fromarray(img[0, :32 * 48].reshape(32, 48, 3)),
                 icc_profile=icc)
    with pytest.raises(NotImplementedError, match="A2B0 in curves"):
        load_std_image(path)
    monkeypatch.setattr(lcms, "LUT_CURVE_TOL", float("inf"))
    lcms._cached_transform.cache_clear()
    try:
        d = np.abs(lcms.to_srgb(img, icc).astype(np.int64) - want)
    finally:
        lcms._cached_transform.cache_clear()
    assert d.max() > LUT_BOUND_MAX


def test_lut_class_resampling_without_prelinearisation():
    """A grey response that turns back (not monotonic) takes LittleCMS's
    plain resampling, which the model follows within the same bound."""
    from art_tpu_torch.color import colorspaces as ccs

    lat = 0.5 - 0.5 * np.cos(_lattice(9) * 2 * np.pi)
    xyz = np.tensordot(lat ** 2.2, ccs.MATRICES_RGB_TO_XYZ["sRGB"].T, axes=1)
    f = np.cbrt(np.maximum(xyz / np.array([0.9642, 1.0, 0.8249]),
                           216 / 24389.0))
    lab = np.stack([(116 * f[..., 1] - 16) * 652.8 / 65535.0,
                    (500 * (f[..., 0] - f[..., 1]) + 128) * 256 / 65535.0,
                    (200 * (f[..., 1] - f[..., 2]) + 128) * 256 / 65535.0],
                   -1)
    ident = np.tile(np.linspace(0.0, 1.0, 256), 3)
    tag = (b"mft2\0\0\0\0" + bytes([3, 3, 9, 0]) + _s15f16(np.eye(3))
           + (256).to_bytes(2, "big") * 2 + _u16(ident) + _u16(lab)
           + _u16(ident))
    img = _lut_inputs()
    for version in (2, 4):
        icc = _icc_bytes([(b"A2B0", tag)], pcs=b"Lab ", version=version)
        assert lcms.build_transform(icc).prelin is None
        want = np.asarray(ImageCms.profileToProfile(
            Image.fromarray(img), ImageCms.ImageCmsProfile(io.BytesIO(icc)),
            ImageCms.createProfile("sRGB"))).astype(np.int64)
        d = np.abs(lcms.to_srgb(img, icc).astype(np.int64) - want)
        assert d.max() <= LUT_BOUND_MAX and d.mean() <= LUT_BOUND_MEAN


def test_lut_class_pipeline_against_lcms_unoptimised():
    """The model's float pipeline against LittleCMS with its
    optimisation off (``Flags.NOOPTIMIZE``: the pipeline itself, each
    pixel through it in float): within one code, so the resampling
    carries the rest of the agreement."""
    img = _lut_inputs()
    for make in ("mab-v4", "mft2-v2", "mft1-v4"):
        icc = LUT_FORMS[make]()
        want = np.asarray(ImageCms.profileToProfile(
            Image.fromarray(img), ImageCms.ImageCmsProfile(io.BytesIO(icc)),
            ImageCms.createProfile("sRGB"),
            flags=ImageCms.Flags.NOOPTIMIZE)).astype(np.int64)
        t = lcms.build_transform(icc)
        enc = t.pipeline(img[0].astype(np.float32) / 255.0)
        got = lcms.from_16_to_8(lcms.quick_saturate_word(
            enc.astype(np.float64) * 65535.0))
        assert np.abs(got - want[0]).max() <= 1, make


def cs_gamma(rgb):
    from art_tpu_torch.color import colorspaces as cs

    return cs.srgb_gamma(rgb / 65535.0)


def test_builtin_srgb_matches_lcms_bytes():
    """The model's sRGB from its definition against the tags LittleCMS
    writes for it (colorants and curve parameters as s15.16)."""
    prof = lcms.Profile(lcms_srgb_bytes())
    assert prof.version >= 0x4000000 and prof.color_space == b"RGB "
    cols = lcms.srgb_colorants()
    for j, sig in enumerate((b"rXYZ", b"gXYZ", b"bXYZ")):
        want = prof.read(sig)
        got = tuple(round(cols[i][j] * 65536) / 65536 for i in range(3))
        assert got == want, sig
    for sig in (b"rTRC", b"gTRC", b"bTRC"):
        kind, typ, params = prof.read(sig)
        assert (kind, typ) == ("param", 4)
        assert params == tuple(round(p * 65536) / 65536
                               for p in lcms.SRGB_PARAMS)
    assert b"wtpt" in prof.tags
