"""External loaders and raw preconverters on the CPU:
`art_tpu_torch.io.iomanager` against `art_tpu.io.iomanager` (reference
rtengine/imgiomanager.cc) on the same config directory, each manager
running its own commands with ``tempfile.tempdir`` set apart per package
(so each preconverts into its own cache).

- The cases of tests/test_iomanager.py: a raw preconverter script to DNG
  (cached by path and mtime), the config tables, and the shipped PGM
  preconverter (the port's copy, art_tpu_torch/preconverters/, against
  tools/preconverters/); the frames decode alike, field by field.
- The preconverter's DNG writer: the LJ92 scan, packed in numpy, holds
  the reference's bytes (0xFF stuffing, category 16, one pixel, both
  predictors).
- An [ART ImageIO] loader for an unknown extension: `load_std_image`
  reads the TIFF it writes, as the reference does; a failing command
  leaves the original error, and a failing preconverter the reference's
  NotImplementedError; a saver hands its file on, or answers False.
"""

import os
import sys
import tempfile

import numpy as np
import pytest

from art_tpu.io import iomanager as ref_iom
from art_tpu.io import rawfile as ref_rawfile
from art_tpu.io.imagefile import load_std_image as ref_load_std
from art_tpu_torch.io import iomanager
from art_tpu_torch.io import rawfile
from art_tpu_torch.io.imagefile import load_std_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def both(tmp_path, monkeypatch):
    """run(package, fn): fn() with that package's manager scanning
    tmp/imageio and tempfile's directory its own."""
    iodir = tmp_path / "imageio"
    iodir.mkdir()
    tmps = {p: tmp_path / f"tmp-{p}" for p in ("ref", "port")}
    for d in tmps.values():
        d.mkdir()

    def run(package, fn):
        mod = ref_iom if package == "ref" else iomanager
        monkeypatch.setattr(tempfile, "tempdir", str(tmps[package]))
        monkeypatch.setattr(mod, "_instance",
                            mod.IOManager(dirs=[str(iodir)]))
        try:
            return fn()
        finally:
            mod.reset()

    return iodir, run


def assert_same_raw(a, b):
    for f in ("pattern", "xtrans", "iso", "make", "model", "filename",
              "integral", "baseline_exposure"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("cfa", "black", "white", "cam_mul", "cam_xyz"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_raw_preconverter_roundtrip(tmp_path, both):
    """A configured ReadCommand converts an unknown raw to DNG, which
    decodes through the native path; the second call hits the cache."""
    iodir, run = both
    rng = np.random.default_rng(0)
    mosaic = rng.integers(600, 12000, size=(32, 48)).astype(np.uint16)
    np.save(str(tmp_path / "mosaic.npy"), mosaic)
    conv = tmp_path / "conv.py"
    conv.write_text(f"""\
import sys
sys.path.insert(0, {REPO!r})
import numpy as np
from art_tpu_torch.io.dngwrite import write_dng
mosaic = np.load({str(tmp_path / 'mosaic.npy')!r})
write_dng(sys.argv[2], mosaic, black=512, white=16383)
""")
    (iodir / "myraw.txt").write_text(
        "[ART RAWImageIO]\n"
        f"Extension=mos\nReadCommand={sys.executable} {conv}\n")
    fake = tmp_path / "shot.mos"
    fake.write_bytes(b"not-a-real-raw")

    def load(package):
        mod = ref_iom if package == "ref" else iomanager
        load_raw = (ref_rawfile if package == "ref" else rawfile).load_raw

        def fn():
            fr = load_raw(str(fake))
            mgr = mod.get_instance()
            out1 = mgr.preconvert_raw(str(fake))
            out2 = mgr.preconvert_raw(str(fake))
            assert out1 == out2 and os.path.isfile(out1)
            assert out1.startswith(tempfile.gettempdir())
            return fr, os.path.basename(out1)
        return run(package, fn)

    (ref, ref_name), (got, name) = load("ref"), load("port")
    np.testing.assert_array_equal(got.cfa, mosaic)
    assert got.filename == str(fake) and name == ref_name
    # no EXIF harvest after a preconversion, in either: the DNG's own
    assert got.exif == ref.exif == {"orientation": 1}
    assert_same_raw(got, ref)


def test_iomanager_config_parse(tmp_path, both):
    iodir, run = both
    (iodir / "exr.txt").write_text(
        "[ART ImageIO]\nExtension=exr\nReadCommand=exr2tiff\n"
        "WriteCommand=tiff2exr\nLabel=OpenEXR\n")
    (iodir / "heic.txt").write_text(
        "[ART ImageIO]\nExtension=.HEIC\nReadCommand=heif-convert -q\n"
        "WriteCommand=enc\nSaveFormat=HEIF\n")
    (iodir / "raws.txt").write_text(
        "[ART RAWImageIO]\nExtension=x3f\nMake=Sigma\nModel=SD\n"
        "ReadCommand=x3f2dng\n")
    (iodir / "notes.md").write_text("[ART ImageIO]\nExtension=md\n")

    def tables(package):
        mod = ref_iom if package == "ref" else iomanager
        return run(package, lambda: (lambda m: (
            m.loaders, m.savers, m.raw_loaders,
            m.can_load_raw("a.X3F", "SIGMA", "sd Quattro"),
            m.can_load_raw("a.x3f", "Canon", "SD")))(mod.get_instance()))

    got = tables("port")
    assert got == tables("ref")
    assert "exr" in got[0] and "exr" in got[1] and "heif" in got[1]
    assert got[3:] == (True, False)


def test_shipped_pnm_preconverter(tmp_path, both):
    """The shipped example converter carries a 16-bit PGM mosaic into the
    native pipeline: the port's copy as the reference's original."""
    iodir, run = both
    rng = np.random.default_rng(1)
    mosaic = rng.integers(100, 15000, size=(24, 40)).astype(np.uint16)
    pgm = tmp_path / "frame.mos"
    pgm.write_bytes(b"P5\n40 24\n65535\n" + mosaic.astype(">u2").tobytes())
    frames = {}
    for package, script in (
            ("ref", os.path.join(REPO, "tools", "preconverters",
                                 "pnm_to_dng.py")),
            ("port", os.path.join(REPO, "art_tpu_torch", "preconverters",
                                  "pnm_to_dng.py"))):
        (iodir / "pnm.txt").write_text(
            "[ART RAWImageIO]\n"
            f"Extension=mos\nReadCommand={sys.executable} {script}\n")
        load_raw = (ref_rawfile if package == "ref" else rawfile).load_raw
        frames[package] = run(package, lambda: load_raw(str(pgm)))
    np.testing.assert_array_equal(frames["port"].cfa, mosaic)
    assert frames["port"].pattern == "RGGB"
    assert_same_raw(frames["port"], frames["ref"])
    # the copy differs from the original only in its docstring, its
    # example path and the writer it imports
    with open(os.path.join(REPO, "tools", "preconverters",
                           "pnm_to_dng.py")) as f:
        orig = f.read()
    with open(os.path.join(REPO, "art_tpu_torch", "preconverters",
                           "pnm_to_dng.py")) as f:
        copy = f.read()
    assert copy.split("def read_pgm16")[1].replace(
        "art_tpu_torch.io.dngwrite", "art_tpu.io.dngwrite") == \
        orig.split("def read_pgm16")[1]


def _tiff_writer(tmp_path):
    """A loader script: any input -> an RGB TIFF made from the input's
    bytes, through the port's TIFF writer."""
    conv = tmp_path / "img2tif.py"
    conv.write_text(f"""\
import sys
sys.path.insert(0, {REPO!r})
import numpy as np
from art_tpu_torch.io.tiffwrite import write_tiff
data = np.frombuffer(open(sys.argv[1], 'rb').read(), np.uint8)
img = np.resize(data, 3 * 20 * 30).reshape(3, 20, 30) / 255.0
write_tiff(sys.argv[2], img, bits=16, compress=True)
""")
    return conv


def test_external_image_loader(tmp_path, both):
    iodir, run = both
    conv = _tiff_writer(tmp_path)
    (iodir / "xyz.txt").write_text(
        f"[ART ImageIO]\nExtension=xyzimg\nReadCommand={sys.executable} "
        f"{conv}\n")
    src = tmp_path / "picture.xyzimg"
    src.write_bytes(np.random.default_rng(2).integers(
        0, 256, 5000).astype(np.uint8).tobytes())
    ref = run("ref", lambda: ref_load_std(str(src)))
    got = run("port", lambda: load_std_image(str(src)))
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    assert got.rgb.shape == (3, 20, 30) and got.filename == str(src)
    assert (got.pattern, got.is_raw) == (ref.pattern, ref.is_raw)


def test_failing_commands(tmp_path, both):
    iodir, run = both
    bad = tmp_path / "fail.py"
    bad.write_text("import sys\nsys.exit(3)\n")
    (iodir / "bad.txt").write_text(
        f"[ART ImageIO]\nExtension=xyzimg\nReadCommand={sys.executable} "
        f"{bad}\nWriteCommand={sys.executable} {bad}\n"
        f"[ART RAWImageIO]\nExtension=mos\nReadCommand={sys.executable} "
        f"{bad}\n")
    src = tmp_path / "picture.xyzimg"
    src.write_bytes(b"junk")
    raw = tmp_path / "shot.mos"
    raw.write_bytes(b"junk")
    for package, load_std, load_raw in (
            ("ref", ref_load_std, ref_rawfile.load_raw),
            ("port", load_std_image, rawfile.load_raw)):
        mod = ref_iom if package == "ref" else iomanager

        def fn():
            mgr = mod.get_instance()
            assert mgr.load_image(str(src)) is None
            assert mgr.preconvert_raw(str(raw)) is None
            assert mgr.save_image("xyzimg", str(src), str(tmp_path / "o"))\
                is False
            assert mgr.save_image("nope", str(src), str(tmp_path / "o")) \
                is False
            with pytest.raises(OSError, match="cannot identify"):
                load_std(str(src))
            with pytest.raises(FileNotFoundError):
                load_std(str(tmp_path / "missing.png"))
            with pytest.raises(NotImplementedError,
                               match="not natively decoded"):
                load_raw(str(raw))
            # no temporary TIFF is left by a failed load
            return sorted(os.listdir(tempfile.gettempdir()))
        assert run(package, fn) == ["art_tpu_rawimgio"]


def test_saver_hands_its_file_on(tmp_path, both):
    iodir, run = both
    copy = tmp_path / "copy.py"
    copy.write_text("import shutil, sys\nshutil.copy(sys.argv[1], "
                    "sys.argv[2])\n")
    (iodir / "w.txt").write_text(
        f"[ART ImageIO]\nExtension=qq\nWriteCommand={sys.executable} "
        f"{copy}\nSaveFormat=QQFMT\n")
    src = tmp_path / "in.tif"
    src.write_bytes(b"tiff bytes")
    for package in ("ref", "port"):
        mod = ref_iom if package == "ref" else iomanager
        dest = tmp_path / f"out-{package}.qq"
        assert run(package, lambda: mod.get_instance().save_image(
            "qqfmt", str(src), str(dest))) is True
        assert dest.read_bytes() == b"tiff bytes"


def test_a_format_pil_reads_goes_to_no_loader(tmp_path, both):
    """A BMP, a WebP and a TGA are images PIL opens, so the reference
    never asks a loader: the port decodes the BMP and the WebP as the
    reference does and refuses the TGA by name, and runs no loader
    either."""
    Image = pytest.importorskip("PIL.Image")
    iodir, run = both
    marker = tmp_path / "ran"
    script = tmp_path / "mark.py"
    script.write_text(f"open({str(marker)!r}, 'w').close()\n")
    for ext in ("bmp", "webp", "tga", "im"):
        (iodir / f"{ext}.txt").write_text(
            f"[ART ImageIO]\nExtension={ext}\nReadCommand="
            f"{sys.executable} {script}\n")
    bmp = tmp_path / "a.bmp"
    Image.fromarray(np.full((4, 4, 3), 77, np.uint8)).save(bmp)
    ref = run("ref", lambda: ref_load_std(str(bmp)))
    assert ref.rgb.shape == (3, 4, 4) and not marker.exists()
    got = run("port", lambda: load_std_image(str(bmp)))
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    webp = tmp_path / "a.webp"
    Image.fromarray(np.full((4, 4, 3), 90, np.uint8)).save(webp)
    ref = run("ref", lambda: ref_load_std(str(webp)))
    got = run("port", lambda: load_std_image(str(webp)))
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    tga = tmp_path / "a.tga"
    Image.fromarray(np.full((4, 4, 3), 60, np.uint8)).save(tga)
    ref = run("ref", lambda: ref_load_std(str(tga)))
    got = run("port", lambda: load_std_image(str(tga)))
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    jp2 = tmp_path / "a.jp2"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(jp2)
    assert run("ref", lambda: ref_load_std(str(jp2))).rgb.shape == (3, 4, 4)
    with pytest.raises(NotImplementedError, match="JPEG 2000 image"):
        run("port", lambda: load_std_image(str(jp2)))
    assert not marker.exists()


LJ92_CASES = {
    "noise": np.random.default_rng(0).integers(0, 65536, (37, 53)),
    "flat": np.zeros((8, 8)),
    "white": np.full((5, 7), 65535),
    "category-16": (np.arange(2000) % 2 * 65535).reshape(40, 50),
    "one-pixel": np.array([[123]]),
    "narrow-range": np.random.default_rng(1).integers(1000, 1004,
                                                      (100, 120)),
}


@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("case", sorted(LJ92_CASES))
def test_lj92_scan_equals_the_reference(case, predictor):
    from art_tpu.io import dngwrite as ref_dngwrite
    from art_tpu_torch.io import dngwrite

    m = LJ92_CASES[case].astype(np.uint16)
    got = dngwrite.lj92_encode(m, predictor=predictor)
    assert got == ref_dngwrite.lj92_encode(m, predictor=predictor)
    if case == "noise":
        assert b"\xff\x00" in got  # stuffed bytes were written


def test_the_loader_runs_where_pils_open_fails(tmp_path, both):
    """The reference asks the loader only where Image.open raises: a PNG
    broken before its image data (a bad IHDR checksum) goes to it; a PNG
    whose image data is cut short opens, fails in its load, and does not;
    nor does a JPEG cut in its data. Both packages alike."""
    from art_tpu_torch.io.imagefile import write_png

    iodir, run = both
    conv = _tiff_writer(tmp_path)
    for ext in ("png", "jpg"):
        (iodir / f"{ext}.txt").write_text(
            f"[ART ImageIO]\nExtension={ext}\nReadCommand={sys.executable} "
            f"{conv}\n")
    good = tmp_path / "good.png"
    write_png(str(good), np.random.default_rng(3).integers(
        0, 256, (40, 60, 3)).astype(np.uint8))
    data = bytearray(good.read_bytes())
    bad_header = tmp_path / "bad_header.png"
    data[29] ^= 0xFF  # IHDR's CRC
    bad_header.write_bytes(bytes(data))
    cut_data = tmp_path / "cut_data.png"
    cut_data.write_bytes(good.read_bytes()[:-40])
    from art_tpu_torch.io import jpeg

    blob = jpeg.encode(np.random.default_rng(4).integers(
        0, 256, (64, 96, 3)).astype(np.uint8), 90, 1)
    cut_jpeg = tmp_path / "cut.jpg"
    cut_jpeg.write_bytes(blob[: len(blob) // 2])
    for package, load_std in (("ref", ref_load_std),
                              ("port", load_std_image)):
        fr = run(package, lambda: load_std(str(bad_header)))
        assert fr.rgb.shape == (3, 20, 30)  # the loader's TIFF
        for path in (cut_data, cut_jpeg):
            with pytest.raises(OSError):
                run(package, lambda: load_std(str(path)))
