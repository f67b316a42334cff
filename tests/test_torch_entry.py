"""The package's entry points on the CPU against `art_tpu`'s: `init`,
`load_image`, `process_image` and `thumbnail`, and the refusal of a
non-raw develop, held by both packages through the planner, the develop,
`process_image`, the CLI and the batch queue.

- `init(user_settings_dir=...)`: both set the user directory, start the
  external I/O manager anew from it and load its camconst.json over the
  bundled camera constants (a DNG of that camera decodes with the user's
  levels in both).
- `load_image`: a DNG, a PNG and a raw format the native decoder does
  not read, preconverted by the port's shipped PGM converter registered
  through `init`: the frames field for field.
- `process_image` and `thumbnail` on 96x160 DNGs (the reference takes
  its exact whole-plane AMaZE below one tile): the fast develop with
  bilinear and the default ProcParams() to the slice bounds (PERF.md
  section 2), the embedded preview exactly.
- The reference's planner fails on every non-raw frame (its RGB branch
  reads `pixelshift`, art_tpu/pipeline/develop.py:715, bound only at
  :132); the port refuses it by name wherever that failure shows: the
  CLI exits 2 and writes nothing, the queue fails that job alone.
"""

import importlib
import os
import sys

import numpy as np
import pytest

import art_tpu
import art_tpu_torch
from art_tpu.params import ProcParams as RefProcParams
from art_tpu_torch.io.dngwrite import write_dng
from art_tpu_torch.params import ProcParams
from chip_smoke import parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNM = os.path.join(REPO, "art_tpu_torch", "preconverters", "pnm_to_dng.py")


@pytest.fixture
def fresh_state(monkeypatch):
    """Each package's settings, camera constants and I/O manager as a
    process starts, restored after the test."""
    from art_tpu.io import iomanager as ref_iom
    from art_tpu.raw import camconst as ref_cc
    from art_tpu.raw import dfff_managers as ref_dfff
    from art_tpu.settings import settings as ref_settings
    from art_tpu_torch.io import iomanager
    from art_tpu_torch.raw import camconst, dfff_managers
    from art_tpu_torch.settings import settings

    for mod in (ref_settings, settings):
        monkeypatch.setattr(mod, "user_dir", None)
    for mod in (ref_cc, camconst, ref_iom, iomanager):
        monkeypatch.setattr(mod, "_instance", None)
    for mod in (ref_dfff, dfff_managers):
        monkeypatch.setattr(mod, "_df_instance", None)
        monkeypatch.setattr(mod, "_ff_instance", None)
    yield
    ref_iom.reset()
    iomanager.reset()


def _mosaic(h, w, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 0.9, (h, w)) * 16000 + 500).astype(np.uint16)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("entry")
    m = _mosaic(96, 160)
    write_dng(d / "plain.dng", m, black=500, white=16500, compress=False)
    write_dng(d / "preview.dng", m, black=500, white=16500, compress=False,
              preview_rgb01=np.random.default_rng(4).uniform(
                  0, 1, (3, 40, 60)))
    write_dng(d / "camera.dng", m, black=500, white=16500, compress=False,
              make="ART-TPU", model="InitTest")
    (d / "raw.mos").write_bytes(b"P5\n160 96\n65535\n"
                                + m.astype(">u2").tobytes())
    from art_tpu_torch.io.imagefile import write_png

    write_png(str(d / "photo.png"), np.random.default_rng(5).integers(
        0, 256, (16, 24, 3)).astype(np.uint8))
    return d


def _user_dir(tmp_path):
    user = tmp_path / "user"
    (user / "imageio").mkdir(parents=True)
    (user / "imageio" / "pnm.txt").write_text(
        "[ART RAWImageIO]\nExtension=mos\n"
        f"ReadCommand={sys.executable} {PNM}\n")
    (user / "camconst.json").write_text(
        '{"camera_constants": [{"make_model": "ART-TPU InitTest", '
        '"ranges": {"white": 15000, "black": 600}}]}')
    return user


def _same_frame(a, b):
    for f in ("pattern", "xtrans", "iso", "make", "model", "filename",
              "is_raw", "exif"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("cfa", "black", "white", "cam_mul", "cam_xyz", "rgb"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f)


def test_init_matches_the_reference(files, tmp_path, fresh_state):
    from art_tpu.io import iomanager as ref_iom
    from art_tpu.raw.camconst import get_instance as ref_cc
    from art_tpu.settings import settings as ref_settings
    from art_tpu_torch.io import iomanager
    from art_tpu_torch.raw.camconst import get_instance as cc
    from art_tpu_torch.settings import settings

    user = _user_dir(tmp_path)
    for pkg, iom in ((art_tpu, ref_iom), (art_tpu_torch, iomanager)):
        iom.get_instance()  # a manager from before the user directory
        pkg.init()
        assert iom._instance is not None
        pkg.init(user_settings_dir=user)
        assert iom._instance is None  # started anew
        assert iom.get_instance().raw_loaders[0][0] == "mos"
    assert settings.user_dir == ref_settings.user_dir == str(user)
    got = cc().get("ART-TPU", "InitTest")
    want = ref_cc().get("ART-TPU", "InitTest")
    assert got.white_levels(100) == want.white_levels(100) == [15000.0] * 4
    assert got.black_levels(100) == want.black_levels(100)
    # the bundled entries stay under the user's
    assert cc().get("Canon", "EOS 5D Mark II") is not None
    assert (cc().get("Canon", "EOS 5D Mark II").data
            == ref_cc().get("Canon", "EOS 5D Mark II").data)
    ref = art_tpu.load_image(str(files / "camera.dng"))
    got = art_tpu_torch.load_image(str(files / "camera.dng"))
    _same_frame(got, ref)
    np.testing.assert_array_equal(got.white, [15000.0] * 4)
    # a broken user camconst.json is skipped by both
    (user / "camconst.json").write_text("{ not json")
    art_tpu.init(user_settings_dir=user)
    art_tpu_torch.init(user_settings_dir=user)


def test_load_image_matches_the_reference(files, tmp_path, fresh_state,
                                          monkeypatch):
    import tempfile

    user = _user_dir(tmp_path)
    for name in ("plain.dng", "photo.png"):
        _same_frame(art_tpu_torch.load_image(str(files / name)),
                    art_tpu.load_image(str(files / name)))
    frames = []
    for pkg in (art_tpu, art_tpu_torch):
        cache = tmp_path / f"tmp-{pkg.__name__}"
        cache.mkdir()
        monkeypatch.setattr(tempfile, "tempdir", str(cache))
        pkg.init(user_settings_dir=user)
        frames.append(pkg.load_image(str(files / "raw.mos")))
        assert os.listdir(cache / "art_tpu_rawimgio")
    ref, got = frames
    _same_frame(got, ref)
    np.testing.assert_array_equal(got.cfa, _mosaic(96, 160))
    assert got.filename == str(files / "raw.mos")


@pytest.fixture(scope="module")
def bilinear_fast():
    pps = []
    for cls in (ProcParams, RefProcParams):
        pp = cls()
        pp.raw.bayer.method = "bilinear"
        pp.resize.enabled = True
        pp.resize.width, pp.resize.height = 80, 48
        pps.append(pp)
    return pps


def test_process_image_matches_the_reference(files, bilinear_fast):
    pp, ref_pp = bilinear_fast
    for fast in (False, True):
        got = art_tpu_torch.process_image(str(files / "plain.dng"), pp,
                                          fast=fast, device="cpu")
        ref = np.asarray(art_tpu.process_image(str(files / "plain.dng"),
                                               ref_pp, fast=fast))
        assert got.dtype == np.float32 and got.shape == ref.shape
        st = parity(got, ref)
        assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, (fast, st)


def test_thumbnail_matches_the_reference(files):
    # the embedded preview, strided
    for max_px in (256, 32):
        got = art_tpu_torch.thumbnail(str(files / "preview.dng"),
                                      max_px=max_px, device="cpu")
        ref = art_tpu.thumbnail(str(files / "preview.dng"), max_px=max_px)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    assert got.shape == (3, 20, 30)
    # no preview: a fast develop of ProcParams() (AMaZE), strided
    got = art_tpu_torch.thumbnail(str(files / "plain.dng"), max_px=64,
                                  device="cpu")
    ref = art_tpu.thumbnail(str(files / "plain.dng"), max_px=64)
    assert got.shape == ref.shape == (3, 32, 54)
    st = parity(got, ref)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st


def test_non_raw_develop_is_refused_by_both(files, tmp_path, capsys,
                                            monkeypatch):
    from art_tpu import cli as ref_cli
    from art_tpu.core import compilecache
    from art_tpu.parallel import process_batch as ref_batch
    from art_tpu_torch import cli
    from art_tpu_torch.parallel import process_batch
    from art_tpu_torch.pipeline import develop as tdev

    jdev = importlib.import_module("art_tpu.pipeline.develop")
    png = str(files / "photo.png")
    ref_frame = art_tpu.load_image(png)
    frame = art_tpu_torch.load_image(png)
    assert not frame.is_raw and frame.rgb.shape == (3, 16, 24)
    with pytest.raises(UnboundLocalError, match="pixelshift"):
        jdev.plan(ref_frame, RefProcParams())
    with pytest.raises(NotImplementedError, match="non-raw input"):
        tdev.plan(frame, ProcParams(), device="cpu")
    with pytest.raises(UnboundLocalError):
        jdev.develop(ref_frame, RefProcParams())
    with pytest.raises(NotImplementedError, match="non-raw input"):
        tdev.develop(frame, ProcParams(), device="cpu")
    with pytest.raises(UnboundLocalError):
        art_tpu.process_image(png, RefProcParams())
    with pytest.raises(NotImplementedError, match="non-raw input"):
        art_tpu_torch.process_image(png, ProcParams(), device="cpu")
    # the CLI: the ImgDefault profile, a per-file error, exit code 2, no
    # file written
    monkeypatch.setattr(compilecache, "enable", lambda *a, **k: True)
    capsys.readouterr()
    for name, main in (("ours", lambda a: cli.main(a, device="cpu")),
                       ("ref", ref_cli.main)):
        out = tmp_path / name
        out.mkdir()
        assert main(["-Y", "-o", str(out) + os.sep, "-c", png]) == 2
        assert not os.listdir(out)
        err = capsys.readouterr().err
        assert f"error processing {png}" in err
        if name == "ours":
            assert "non-raw input" in err
    # the queue: that job fails, nothing written
    for run, cls in ((lambda j: process_batch(j, devices=["cpu"]),
                      ProcParams), (ref_batch, RefProcParams)):
        out = tmp_path / f"q-{cls.__module__.split('.')[0]}.jpg"
        assert run([(png, cls(), str(out))]) == [False]
        assert not out.exists()
