"""The texture and icon formats the reference opens through Pillow,
decoded by the port (`art_tpu_torch.io.textures` over
`io/native/rasterdec.cc`) on the CPU against Pillow 12.1.0 and, through
the consumers, against `art_tpu`:

- every form of tests/util_texforms.py (DDS of each BCn FourCC and DXGI
  code the open accepts, BC7's eight modes and its reserved one, BC6H's
  14 modes in UF16 and SF16, masks of 16, 24, 32 and 12 bits with gaps
  and a cut body, L, LA, P, DX10 R8G8B8A8; BLP1's JPEG of RGB, grey and
  CMYK and its palette encodings; BLP2's palette and DXT1/3/5 at widths
  6 and 8 with an alpha flag of 0 and 1; ICNS's raw and RLE icons with
  their masks, PNG icons, a JPEG 2000 icon) through the four readers:
  `read_rgb8` against Pillow's ``convert("RGB")``, `read_grey` against
  the mask path's mode rule, `read_image` and `load_std_image` against
  the reference's; a form whose load fails in Pillow fails with its
  error's class and message; a JPEG 2000 icon of the chosen size is
  refused by name;
- ``BcnDecode.c`` (`bcn`) on seeded batches of blocks of every kind, at
  sizes that cut blocks, bit for bit;
- the quirks the port keeps: BLP's DXT bytes set at the image's stride
  (a sheared width, RGBA read as RGB), BLP1's JPEG read as BGR;
- the consumers (`load_image`, `load_hald_clut`, `load_external_mask`,
  `load_psf_kernel`) against the reference's on every form;
- damaged copies of a file of each kind (cut, bytes changed, lengthened)
  open or fail, and load or fail, as in Pillow;
- `chip_smoke.py`'s K1 writers and tiling, and its K2 Hald and mask.

The damaged copies of Pillow's own BLP, DDS and ICNS files are in
tests/test_torch_unported.py.
"""

import io
import os
import struct
import warnings

import numpy as np
import pytest

from art_tpu.io.imagefile import load_std_image as ref_load
from art_tpu_torch.io import textures, unported
from art_tpu_torch.io.imagefile import (load_std_image, read_grey,
                                        read_image, read_rgb8)
from art_tpu_torch.io.rasterformats import _lib, _ptr

import chip_smoke
import util_texforms as ut
from test_torch_formats import DATA, check_readers, pil_grey

Image = pytest.importorskip("PIL.Image")


def _error(e):
    """An error's class as the tests compare it, and its message."""
    for cls in (OSError, ValueError, IndexError, NotImplementedError,
                SyntaxError, KeyError):
        if isinstance(e, cls):
            return cls.__name__, str(e)
    return "other", str(e)


def _outcome(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return ("ok", fn())
        except Exception as e:
            return _error(e)


def _write(tmp_path, data, name="a.img"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _pil_rgb(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("form", sorted(ut.FORMS))
def test_forms_decode_as_pillow(form, tmp_path):
    """The four readers on each form against Pillow and the reference; a
    form Pillow cannot load fails with its error's class and message;
    a JPEG 2000 icon of the chosen size is refused by name."""
    data = ut.FORMS[form]
    path = _write(tmp_path, data)
    name, _ = unported.walk(data, path)
    assert name == Image.open(path).format
    want = _outcome(lambda: _pil_rgb(path))
    if form == "ICNS ic08 JPEG 2000":  # Pillow decodes it
        for read in (read_rgb8, read_grey, read_image, load_std_image):
            with pytest.raises(NotImplementedError, match="JPEG 2000"):
                read(path)
        return
    if want[0] != "ok":
        assert _outcome(lambda: read_rgb8(path)) == want
        assert _outcome(lambda: read_image(path)) == want
        assert _outcome(lambda: load_std_image(path))[0] == \
            _outcome(lambda: ref_load(path))[0]
        return
    ref = _outcome(lambda: ref_load(path))
    if ref[0] != "ok":  # an ICNS of a grey or palette PNG icon: the
        # reference's np.asarray packs it into the open's RGBA and fails
        assert _outcome(lambda: load_std_image(path)) == ref
        np.testing.assert_array_equal(read_rgb8(path), want[1])
        np.testing.assert_array_equal(read_image(path)[1], want[1])
        for a, b in zip(read_grey(path), pil_grey(path)):
            np.testing.assert_array_equal(a, b)
        return
    check_readers(path)


def test_every_kind_of_form_is_held():
    """Each DDS FourCC and DXGI code the open accepts has a form, each BLP
    encoding Pillow loads, each ICNS reader; and the BC6H forms of each
    mode give Pillow values inside 1..254."""
    fourccs, dxgis, blp, icns = set(), set(), set(), set()
    for data in ut.FORMS.values():
        if data[:4] == b"DDS ":
            if data[84:88] == b"DX10":
                dxgis.add(struct.unpack_from("<I", data, 128)[0])
            elif data[80] & 4:
                fourccs.add(data[84:88])
        elif data[:4] in (b"BLP1", b"BLP2"):
            blp.add((data[:4], data[8] if data[:4] == b"BLP2" else
                     struct.unpack_from("<i", data, 4)[0]))
        elif data[:4] == b"icns":
            icns |= _codes(data)
    assert fourccs == {b"DXT1", b"DXT3", b"DXT5", b"BC4U", b"ATI1", b"BC5U",
                       b"ATI2", b"BC5S"}
    assert {c for c in unported._DXGI if c not in (27, 70, 73, 76, 79, 82,
                                                   97)} <= dxgis
    assert {(b"BLP1", 0), (b"BLP1", 1), (b"BLP2", 1), (b"BLP2", 2)} <= blp
    assert {b"is32", b"il32", b"ih32", b"it32", b"s8mk", b"l8mk", b"h8mk",
            b"t8mk", b"ic07", b"icp4", b"ic08"} <= icns
    for signed, code in ((0, 95), (1, 96)):
        vis, _ = ut.bc6h_blocks(signed, 4, 50 + signed)
        a = np.asarray(Image.open(io.BytesIO(ut.dds_bcn(
            56, 16, vis, dxgi=code))).convert("RGB"))
        for m in range(14):  # block column m holds mode m
            tile = a[:, 4 * m : 4 * m + 4]
            assert ((tile > 0) & (tile < 255)).mean() > 0.5, (signed, m)


def _codes(data):
    f = unported._File(data)
    unported._icns(f)
    return set(f.tile[0])


@pytest.mark.parametrize("n,signed", [(1, 0), (2, 0), (3, 0), (4, 0), (5, 0),
                                      (5, 1), (6, 0), (6, 1), (7, 0)])
def test_bcn_decoder_on_seeded_blocks(n, signed):
    """``bcn`` against Pillow's BcnDecode.c on 2400 seeded blocks of each
    kind (BC6H's and BC7's modes in turn), at 40 x 240 and at 38 x 238,
    which cut the last blocks."""
    code = {1: 71, 2: 74, 3: 77, 4: 80, 5: 84 if signed else 83,
            6: 96 if signed else 95, 7: 98}[n]
    count = 10 * 60
    if n == 7:
        blocks = ut.bc7_blocks(count, 200)
    elif n == 6:
        vis, raw = ut.bc6h_blocks(signed, 20, 201 + signed)
        blocks = np.concatenate([vis, raw])[:count]
    else:
        blocks = ut.random_blocks(n, count, 202 + n)
    bands = 1 if n == 4 else 3 if n in (5, 6) else 4
    for w, h in ((40, 240), (38, 238)):
        want = np.asarray(Image.open(io.BytesIO(ut.dds_bcn(
            w, h, blocks, dxgi=code))))
        src = np.ascontiguousarray(blocks).reshape(-1)
        got = np.zeros((h, w, bands), np.uint8)
        assert _lib().bcn(n, signed, _ptr(src), src.size, w, h,
                          _ptr(got)) == 0
        np.testing.assert_array_equal(got[..., 0] if bands == 1 else got,
                                      want)


def test_blp_dxt_bytes_set_at_the_image_stride(tmp_path):
    """BLP2's DXT decode sets 4 whole blocks' rows at the image's own
    stride: RGBA bytes read as RGB where the alpha flag is 0, a width of
    6 sheared; BLP1's JPEG is set as BGR."""
    full = read_rgb8(_write(tmp_path, ut.blp2_dxt(8, 8, 5, 8, 7), "a.blp"))
    rgba = np.asarray(Image.open(str(tmp_path / "a.blp")))
    flat = rgba.reshape(-1)
    noalpha = read_rgb8(_write(tmp_path, ut.blp2_dxt(8, 8, 5, 0, 7),
                               "b.blp"))
    np.testing.assert_array_equal(noalpha, flat[: 8 * 8 * 3].reshape(8, 8, 3))
    np.testing.assert_array_equal(full, rgba[..., :3])
    sheared = read_rgb8(_write(tmp_path, ut.blp2_dxt(6, 8, 5, 8, 7),
                               "c.blp"))
    # 6-wide rows out of two blocks' 8-wide rows (the same blocks: 2 a row)
    rows8 = np.asarray(Image.open(io.BytesIO(ut.blp2_dxt(8, 8, 5, 8, 7))))
    np.testing.assert_array_equal(
        sheared, rows8.reshape(-1, 4)[: 6 * 8].reshape(8, 6, 4)[..., :3])
    rgb = ut.picture(24, 32, 3, seed=70)
    path = _write(tmp_path, ut.FORMS["BLP1 JPEG RGB"], "d.blp")
    jpg = io.BytesIO(ut._jpeg(rgb))
    np.testing.assert_array_equal(
        read_rgb8(path), np.asarray(Image.open(jpg).convert("RGB"))[..., ::-1])


def test_errors_as_pillows(tmp_path):
    """The load errors the port mirrors, class and message: a BLP whose
    offsets run past the file (Truncated File Read), BLPFormatError (a
    NotImplementedError), ICNS's SyntaxError on a channel with bytes
    left, DDS's truncation, a PNG icon of another size."""
    import test_torch_unported as tu

    cases = {
        "BLP version 1": tu.OPENABLE["BLP version 1"](),
        "BLP1 encoding 3": ut.FORMS["BLP1 encoding 3"],
        "ICNS RLE channel short": ut.FORMS["ICNS RLE channel short"],
        "DDS DXT1 cut short": ut.FORMS["DDS DXT1 cut short"],
        "ICNS ic07 PNG of 100x100": ut.FORMS["ICNS ic07 PNG of 100x100"],
    }
    want = {"BLP version 1": ("OSError", "Truncated File Read"),
            "BLP1 encoding 3": ("NotImplementedError",
                                "Unsupported BLP encoding 3"),
            "ICNS RLE channel short": ("SyntaxError",
                                       "Error reading channel [29 left]"),
            "DDS DXT1 cut short": ("OSError", "image file is truncated "
                                              "(5 bytes not processed)"),
            "ICNS ic07 PNG of 100x100": (
                "ValueError",
                "This is not one of the allowed sizes of this image")}
    for name, data in cases.items():
        path = _write(tmp_path, data)
        assert _outcome(lambda: _pil_rgb(path)) == want[name], name
        assert _outcome(lambda: read_rgb8(path)) == want[name], name
    with pytest.raises(textures.BLPFormatError):
        textures.read_blp(ut.FORMS["BLP1 encoding 3"], None)


def test_icns_jpeg2000_refused_only_at_its_chosen_size(tmp_path):
    """An ICNS whose chosen size is a JPEG 2000 icon is refused by name;
    one whose JPEG 2000 icon is of another size decodes as Pillow
    decodes it; the walk opens both (FORMATS holds JPEG 2000, AVIF and
    the formats whose load always fails, not ICNS)."""
    names = {n for n, _, _ in unported.FORMATS}
    assert names == {"AVIF", "JPEG 2000"} | set(unported.LOAD_FAILS)
    path = _write(tmp_path, ut.FORMS["ICNS ic08 JPEG 2000"])
    assert unported.identify(ut.FORMS["ICNS ic08 JPEG 2000"]) is None
    with pytest.raises(NotImplementedError, match="JPEG 2000"):
        read_rgb8(path)
    path = _write(tmp_path, ut.FORMS["ICNS JPEG 2000 of a smaller size"])
    np.testing.assert_array_equal(read_rgb8(path), _pil_rgb(path))


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


@pytest.mark.parametrize("form", sorted(ut.FORMS))
def test_consumers_of_each_form_as_the_reference(form, tmp_path):
    """`load_image`, the Hald CLUT, the external mask (an OSError leaves
    the region unmasked: the reference's caller catches it) and the PSF
    image on each form give the reference's result or its error class; a
    JPEG 2000 icon the port refuses by name."""
    import art_tpu
    import art_tpu_torch
    from art_tpu.color.lut3d import load_hald_clut as ref_hald
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu.ops.sharpen import load_psf_kernel as ref_psf
    from art_tpu_torch.color.lut3d import load_hald_clut
    from art_tpu_torch.masks import load_external_mask
    from art_tpu_torch.ops.sharpen import load_psf_kernel

    path = _write(tmp_path, ut.FORMS[form])
    refused = form.endswith("ic08 JPEG 2000")
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
        if refused:
            assert got[0] == "NotImplementedError", label
            continue
        assert _same(want, got), (label, want[0], got[0])


# damaged copies: the forms, and the header bytes each may change (the
# size fields left alone: a width or height made huge only asks Pillow's
# Python decoders for ~1e8 pixels)
DAMAGED = {"DDS BC7 random 64x40": 128, "DDS R5G6B5": 128,
           "DDS P": 128, "BLP2 DXT5 8x8, alpha 8": 148,
           "BLP1 palette, encoding 4, alpha 1": 156, "BLP1 JPEG RGB": 200,
           "ICNS il32 RLE, l8mk": 200, "ICNS ic07 PNG": 120}


def _damaged(data, rng, head):
    n = len(data)
    out = [data[:c] for c in sorted({int(c) for c in rng.integers(1, n, 12)}
                                    | {4, 8, 20, 100, 128, 150})
           if c < n]
    size_fields = range(12, 20)
    for _ in range(40):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, head if rng.random() < 0.6 else n))
            if i in size_fields:
                continue
            d[i] = int(rng.choice([0, 1, 255, 0x7F,
                                   int(rng.integers(0, 256))]))
        out.append(bytes(d))
    out.append(data + rng.integers(0, 256, 64).astype(np.uint8).tobytes())
    return out


@pytest.mark.parametrize("form", sorted(DAMAGED))
def test_damaged_files_load_or_fail_as_in_pillow(form, tmp_path):
    """Each damaged copy opens or fails in the port's walk as in Pillow's
    Image.open; where it opens as a texture or icon format, the port's
    load gives Pillow's array or fails with its error's class."""
    import test_torch_unported as tu

    rng = np.random.default_rng(sorted(DAMAGED).index(form) + 300)
    wrong = []
    for i, data in enumerate(_damaged(ut.FORMS[form], rng, DAMAGED[form])):
        path = tmp_path / "v.img"
        want = tu.pil_outcome(data, path)
        if want is None:
            continue
        got = tu.port_outcome(data, path)
        if got != want:
            wrong.append((i, want, got))
            continue
        if want[0] == "opens" and want[1] in ("BLP", "DDS", "ICNS"):
            w = tu.pil_decode(data, path)
            g = tu.port_decode(data, path)
            if w[0] == "ok" and g[:2] == ("load", "other") and \
                    "JPEG 2000" in _outcome(lambda: read_rgb8(str(path)))[1]:
                continue  # an icon Pillow decodes as JPEG 2000: refused
            if not tu.same_decode(w, g):
                wrong.append((i, w[:2] if w[0] != "ok" else "ok",
                              g[:2] if g[0] != "ok" else "ok"))
    assert not wrong, wrong


# -- chip_smoke.py's K1 and K2 -----------------------------------------------

def test_k1_writers_as_pillow_reads_them(tmp_path):
    """K1's numpy writers at a small size: Pillow reads each file to the
    array K1 expects (the 5-6-5 samples as dds_rgb scales them), and so
    does the port; each fixture tiled to a size that is no multiple of
    its own decodes, in Pillow and in the port, to the same tiling of
    the fixture's decode."""
    files = chip_smoke.texture_files(str(tmp_path), 36, 52)
    assert set(files) == {"DDS A8R8G8B8", "DDS R5G6B5", "DDS DX10 R8G8B8A8",
                          "BLP2 palette"}
    for name, (path, want) in files.items():
        np.testing.assert_array_equal(_pil_rgb(path), want, err_msg=name)
        np.testing.assert_array_equal(read_rgb8(path), want, err_msg=name)
    for label, name in chip_smoke.K1_TILED:
        fixture = os.path.join(DATA, name)
        path = chip_smoke.tile_texture(fixture, str(tmp_path / name), 88,
                                       148)
        want = chip_smoke.tiled_decode(_pil_rgb(fixture), 88, 148)
        np.testing.assert_array_equal(_pil_rgb(path), want, err_msg=label)
        np.testing.assert_array_equal(read_rgb8(path), want, err_msg=label)


def test_k2_hald_and_mask_as_the_pngs(tmp_path):
    """K2's uncompressed DDS Hald and BLP2 palette mask decode to the
    samples of the PNGs they stand beside, in Pillow and in the port, and
    the mask reads as the PNG mask does."""
    from art_tpu_torch.io.imagefile import write_png

    hald = chip_smoke.hald_image(4, 8)
    mask = chip_smoke.f2_mask(40, 60).astype(np.uint8)
    grey = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    dds = _write(tmp_path, chip_smoke.dds_rgb_bytes(hald, bits=24), "h.dds")
    blp = _write(tmp_path, chip_smoke.blp_palette_bytes(mask, grey), "m.blp")
    png = str(tmp_path / "m.png")
    write_png(png, np.repeat(mask[..., None], 3, 2))
    for path, want in ((dds, hald), (blp, grey[mask])):
        np.testing.assert_array_equal(_pil_rgb(path), want)
        np.testing.assert_array_equal(read_rgb8(path), want)
    assert Image.open(blp).mode == Image.open(png).mode == "RGB"
    for a, b in zip(read_grey(blp), read_grey(png)):
        np.testing.assert_array_equal(a, b)
