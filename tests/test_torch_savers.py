"""The port's writers (`art_tpu_torch/io/savers.py`) against the
reference's `art_tpu/io/imagefile.py::save_image`, which hands every
extension but .tif, .tiff, .jpg, .jpeg and .png to Pillow 12.1.0's
``Image.fromarray(data).save(path, icc_profile=..., exif=...)``.

- every extension Pillow maps to BMP, DIB, TGA, SGI, IM, PCX, PPM, QOI,
  DDS, EPS, JPEG (.jpe, .jfif), MPO, PDF or GIF: the same bytes (a PDF's
  two dates masked), with the ICC profile and EXIF that process_image
  passes, on seeded arrays of a few dozen pixels a side and one GIF of
  more than 256 colours;
- ICO, ICNS and APNG: the same directory and frames in Pillow's decode;
- the formats with no writer: the reference's exception class, message
  and what it leaves on disk; JPEG 2000, WebP and AVIF refused by name;
- chip_smoke.py's O1 fixtures at the sha256 the JSON records, Pillow's;
- end to end: one develop through cli.main to a GIF and one batch-queue
  job to a TGA, each the reference's file.
"""

from __future__ import annotations

import io
import os
import struct
import tempfile

import numpy as np
import pytest

from art_tpu.io.imagefile import save_image as ref_save
from art_tpu_torch.io import savers
from art_tpu_torch.io.imagefile import save_image

import chip_smoke

Image = pytest.importorskip("PIL.Image")


def _icc():
    from art_tpu_torch.color.iccwrite import make_icc

    return make_icc("sRGB")


def _exif():
    from art_tpu_torch.io.metadata import build_exif_bytes

    return build_exif_bytes({"Make": "ART", "Model": "port",
                             "ISOSpeedRatings": 200})


def _planes(h, w, seed, noise=30):
    """(3, h, w) float32 in [0, 1] as process_image hands save_image, a
    few values past each end."""
    rgb = chip_smoke.photo_u8(h, w, seed).astype(np.float32)
    rng = np.random.default_rng(seed)
    rgb += rng.integers(-noise, noise + 1, rgb.shape)
    return np.moveaxis(rgb / 255.0, -1, 0).clip(-0.02, 1.02)


BYTE_EXTS = sorted(e for e, f in savers.EXTENSION.items() if f in (
    "BMP", "DIB", "TGA", "SGI", "IM", "PCX", "PPM", "QOI", "DDS", "EPS",
    "MPO", "PDF", "GIF") or e in (".jpe", ".jfif"))
SHAPES = {"40x56": (40, 56, 0), "17x23": (17, 23, 1)}


def _both(tmp_path, ext, planes, name="x", **kw):
    """(the reference's file, the port's file) for the same call."""
    out = []
    for who, fn in (("ref", ref_save), ("port", save_image)):
        d = tmp_path / who
        d.mkdir(exist_ok=True)
        path = str(d / f"{name}{ext}")
        fn(path, planes, **kw)
        with open(path, "rb") as f:
            out.append(f.read())
    return out


def test_byte_exts_are_pillows():
    assert len(BYTE_EXTS) == 26
    assert {".jpg", ".jpeg", ".tif", ".png"}.isdisjoint(BYTE_EXTS)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("ext", BYTE_EXTS)
def test_writes_the_references_bytes(ext, shape, tmp_path):
    """save_image with the ICC profile and EXIF process_image passes (the
    quality and subsampling it ignores outside .jpg), the reference's
    bytes; a PDF's dates masked."""
    planes = _planes(*SHAPES[shape])
    ref, got = _both(tmp_path, ext, planes, quality=92, subsampling=3,
                     icc_bytes=_icc(), exif_bytes=_exif())
    if ext == ".pdf":
        ref, got = (chip_smoke.mask_pdf_dates(b) for b in (ref, got))
    assert got == ref


@pytest.mark.parametrize("ext", [".gif", ".pcx", ".qoi", ".eps"])
def test_many_colours_and_bare_calls(ext, tmp_path):
    """A 300x200 image of thousands of colours (GIF's median cut over
    more than 256, its palette not optimised from 512x512 up, odd and
    even widths through PCX's planes), and the bare call the batch queue
    makes (no ICC, no EXIF): the reference's bytes."""
    for h, w in ((200, 300), (97, 61)):
        planes = _planes(h, w, 5, noise=60)
        ref, got = _both(tmp_path, ext, planes)
        assert got == ref
    if ext == ".gif":
        idx, pal = savers.gif_parts(chip_smoke.photo_u8(600, 500, 3))
        assert len(pal) == 256 and idx.max() == 255


@pytest.mark.parametrize("levels", [2, 4, 7, 256])
def test_gif_of_few_and_many_colours(levels, tmp_path):
    """GIF of 8, 64, 343 and thousands of colours on odd sizes: the
    median cut stops at one colour a box below 257 colours, the palette
    shrinks to a power of two where it may (the optimisation of images
    under 512x512), and the reference's bytes."""
    for h, w in ((33, 47), (120, 77)):
        u8 = chip_smoke.photo_u8(h, w, levels)
        step = 256 // levels
        u8 = (u8 // step * step + step // 2).astype(np.uint8)
        ref, got = _both(tmp_path, ".gif", u8, name=f"g{h}")
        assert got == ref


def test_uint8_planes_and_16_bits(tmp_path):
    """Device-converted uint8 output, planar or interleaved, writes the
    same bytes as the float planes it came from; bits=16 is ignored
    outside PNG and TIFF, as in the reference."""
    planes = _planes(17, 23, 2)
    u8 = (np.clip(planes, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    ref = _both(tmp_path, ".bmp", planes)[0]
    assert _both(tmp_path, ".bmp", u8)[1] == ref
    assert _both(tmp_path, ".bmp", np.moveaxis(u8, 0, -1).copy())[1] == ref
    ref16, got16 = _both(tmp_path, ".tga", planes, bits=16)
    assert got16 == ref16 == _both(tmp_path, ".tga", planes)[0]


def _ico_frames(data):
    im = Image.open(io.BytesIO(data))
    out = {}
    for size in sorted(im.info["sizes"]):
        im.size = size
        out[size] = np.asarray(im.convert("RGBA"))
    return im.info["sizes"], out


def _icns_frames(data):
    out, pos = [], 8
    while pos < len(data):
        kind = data[pos : pos + 4]
        n = struct.unpack(">i", data[pos + 4 : pos + 8])[0]
        if kind != b"TOC ":
            im = Image.open(io.BytesIO(data[pos + 8 : pos + n]))
            out.append((kind, im.mode, np.asarray(im)))
        pos += n
    return out


@pytest.mark.parametrize("shape", [(40, 56), (300, 200), (16, 16), (5, 7)])
@pytest.mark.parametrize("ext", [".ico", ".icns", ".apng"])
def test_resized_formats_decode_as_the_references(ext, shape, tmp_path):
    """ICO (LANCZOS thumbnails of each default size the image holds),
    ICNS (BICUBIC resizes to each of its sizes) and APNG: Pillow decodes
    the port's file to the reference's directory, sizes, modes and
    pixels (the bytes differ: the port's PNG has no row filter)."""
    planes = _planes(*shape, 4)
    ref, got = _both(tmp_path, ext, planes, icc_bytes=_icc(),
                     exif_bytes=_exif())
    if ext == ".ico":
        if min(shape) < 16:  # no size fits: a directory of no frame
            assert got == ref
            return
        assert _ico_frames(got)[0] == _ico_frames(ref)[0]
        for size, px in _ico_frames(ref)[1].items():
            np.testing.assert_array_equal(_ico_frames(got)[1][size], px)
    elif ext == ".icns":
        a, b = _icns_frames(ref), _icns_frames(got)
        assert [(k, m, x.shape) for k, m, x in a] == \
            [(k, m, x.shape) for k, m, x in b]
        for (_, _, x), (_, _, y) in zip(a, b):
            np.testing.assert_array_equal(x, y)
    else:
        a, b = Image.open(io.BytesIO(ref)), Image.open(io.BytesIO(got))
        assert a.mode == b.mode and a.info.get("icc_profile") == \
            b.info.get("icc_profile")
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


NO_WRITER = [".blp", ".msp", ".palm", ".xbm", ".bufr", ".grib", ".h5",
             ".hdf", ".wmf", ".emf", ".psd", ".cur", ".dcx", ".fits",
             ".flc", ".ftu", ".gbr", ".iim", ".mpg", ".pcd", ".pxr", ".ras",
             ".xpm", ".xyz", ""]


def _fails(fn, path, planes):
    try:
        fn(path, planes, icc_bytes=_icc(), exif_bytes=_exif())
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("before", [False, True])
@pytest.mark.parametrize("ext", NO_WRITER)
def test_formats_without_a_writer_fail_as_the_references(ext, before,
                                                         tmp_path):
    """The reference's exception class and message, and what it leaves:
    nothing where the file was not there, an empty file where it was
    (Pillow opens it for writing before its writer fails); an extension
    with no writer raises before it opens the file."""
    planes = _planes(17, 23, 0)
    outcome = {}
    for who, fn in (("ref", ref_save), ("port", save_image)):
        d = tmp_path / who
        d.mkdir()
        path = str(d / f"out{ext}")
        if before:
            with open(path, "wb") as f:
                f.write(b"old")
        err = _fails(fn, path, planes)
        left = open(path, "rb").read() if os.path.exists(path) else None
        outcome[who] = (err, left)
    assert outcome["ref"][0] is not None
    assert outcome["port"] == outcome["ref"]


@pytest.mark.parametrize("ext", [".j2c", ".j2k", ".jp2", ".jpc", ".jpf",
                                 ".jpx", ".webp", ".avif", ".avifs"])
def test_queued_encoders_are_refused_by_name(ext, tmp_path):
    """JPEG 2000, WebP and AVIF: NotImplementedError naming the format,
    no file written."""
    path = str(tmp_path / f"out{ext}")
    with pytest.raises(NotImplementedError,
                       match=savers.EXTENSION[ext]):
        save_image(path, _planes(17, 23, 0))
    assert not os.path.exists(path)


def test_o1_fixtures_hold_pillows_sha256():
    """chip_smoke.py's O1 holds each writer's bytes of its fixtures to the
    recorded sha256: Pillow's bytes of the same arrays, and the port's."""
    import json

    with open(chip_smoke.FORMATS_SHA) as f:
        recorded = json.load(f)
    with tempfile.TemporaryDirectory() as d:
        pil = chip_smoke.o1_fixture_sha(
            lambda p, a: Image.fromarray(a).save(p), d)
        port = chip_smoke.o1_fixture_sha(savers.save, d)
    assert {k: v for k, v in recorded.items() if k.startswith("O1 ")} \
        == pil == port
    assert len(pil) == len(chip_smoke.O1_FIXTURES) * len(chip_smoke.O1_EXTS)


def test_median_cut_above_65536_colours():
    """An image of more than 65536 colours: the histogram at a coarser
    scale, as Quantize.c's; Pillow's indices and palette."""
    rgb = np.random.default_rng(9).integers(0, 256, (300, 260, 3),
                                            dtype=np.uint8)
    im = Image.fromarray(rgb).quantize(256)
    idx, pal = savers.quantize(rgb)
    np.testing.assert_array_equal(idx, np.asarray(im))
    assert pal.reshape(-1).tolist() == im.getpalette()


def _dng(tmp_path):
    from art_tpu_torch.core.image import synthesize_bayer
    from art_tpu_torch.io.dngwrite import write_dng

    rgb = np.random.default_rng(1).uniform(0.1, 0.8, size=(3, 64, 96))
    syn = synthesize_bayer(rgb, black=512, white=16383)
    path = tmp_path / "in.dng"
    write_dng(path, syn.cfa.astype(np.uint16), black=512, white=16383,
              cam_mul=(2.0, 1.0, 1.5), compress=True)
    return str(path)


def test_cli_main_to_a_gif_writes_the_references_file(tmp_path,
                                                      monkeypatch):
    """A bilinear develop of a 64x96 DNG through cli.main -o x.gif, in
    the port on the CPU and in the reference: the same GIF."""
    from art_tpu import cli as ref_cli
    from art_tpu.core import compilecache
    from art_tpu_torch import cli

    monkeypatch.setattr(compilecache, "enable", lambda *a, **k: True)
    dng = _dng(tmp_path)
    (tmp_path / "b.arp").write_text("[RAW Bayer]\nMethod=bilinear\n")
    outs = {}
    for name, main in (("port", lambda a: cli.main(a, device="cpu")),
                       ("ref", ref_cli.main)):
        out = tmp_path / f"{name}.gif"
        assert main(["-Y", "-p", str(tmp_path / "b.arp"), "-o", str(out),
                     "-c", dng]) == 0
        outs[name] = out.read_bytes()
    assert outs["port"] == outs["ref"]
    assert outs["port"][:6] == b"GIF87a"


def test_batch_queue_job_to_a_tga_writes_the_references_file(tmp_path):
    """One job of the batch queue to a .tga (the queue's bare save_image:
    no ICC, no EXIF), against the reference's process_batch."""
    from art_tpu.params import ProcParams as RefProcParams
    from art_tpu.parallel import process_batch as ref_batch
    from art_tpu_torch.params import ProcParams
    from art_tpu_torch.parallel import process_batch

    dng = _dng(tmp_path)
    out, ref = str(tmp_path / "port.tga"), str(tmp_path / "ref.tga")
    assert process_batch([(dng, ProcParams(), out)], devices=["cpu"]) \
        == [True]
    assert ref_batch([(dng, RefProcParams(), ref)]) == [True]
    assert open(out, "rb").read() == open(ref, "rb").read()
