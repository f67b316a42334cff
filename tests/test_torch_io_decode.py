"""The port's raw decode against the reference's, on the CPU: the DNG
writer's bytes, the decoded mosaic and the frame's fields, for each Bayer
pattern, compressed (LJ92) and not, at odd and even sizes; a corrupt DNG
raises as in the reference; and the port decodes with its own build of
its own copy of the decoder source.
"""

import itertools
import os

import numpy as np
import pytest

from art_tpu.io import dngwrite as ref_dngwrite
from art_tpu.io.rawfile import load_raw as ref_load_raw
from art_tpu_torch import hostbuild
from art_tpu_torch.io import dngwrite, native_binding
from art_tpu_torch.io.rawfile import load_raw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM_XYZ = np.array([[0.9, -0.2, -0.1], [-0.4, 1.3, 0.1], [-0.1, 0.2, 0.7]])
CASES = list(itertools.product(("RGGB", "BGGR", "GRBG", "GBRG"),
                               (True, False),
                               ((7, 13), (64, 96), (257, 430))))


@pytest.mark.parametrize("pattern,compress,shape", CASES)
def test_decode_equals_the_reference(tmp_path, pattern, compress, shape):
    rng = np.random.default_rng(sum(shape) + len(pattern) + compress)
    mosaic = rng.integers(0, 16384, shape).astype(np.uint16)
    kw = dict(pattern=pattern, black=512, white=16383,
              cam_mul=(2.0, 1.0, 1.5), cam_xyz=CAM_XYZ, compress=compress,
              iso=400, make="Maker", model="Cam 1")
    ours, ref = tmp_path / "ours.dng", tmp_path / "ref.dng"
    dngwrite.write_dng(ours, mosaic, **kw)
    ref_dngwrite.write_dng(ref, mosaic, **kw)
    assert ours.read_bytes() == ref.read_bytes()

    frame, rframe = load_raw(str(ours)), ref_load_raw(str(ours))
    assert frame.cfa.dtype == np.uint16 and frame.integral
    np.testing.assert_array_equal(frame.cfa, mosaic)
    np.testing.assert_array_equal(frame.cfa, rframe.cfa)
    assert frame.pattern == rframe.pattern == pattern
    for field in ("black", "white", "cam_mul", "cam_xyz"):
        np.testing.assert_array_equal(getattr(frame, field),
                                      getattr(rframe, field), err_msg=field)
    for field in ("iso", "baseline_exposure", "make", "model", "exif",
                  "filename"):
        assert getattr(frame, field) == getattr(rframe, field), field
    assert (frame.make, frame.model, frame.iso) == ("Maker", "Cam 1", 400)


def test_corrupt_dng_raises_as_the_reference(tmp_path):
    mosaic = np.arange(64 * 96, dtype=np.uint16).reshape(64, 96)
    path = tmp_path / "x.dng"
    dngwrite.write_dng(path, mosaic, compress=True)
    data = path.read_bytes()
    for bad in (data[:40], b"XX" + data[2:]):  # cut IFD, bad byte order
        path.write_bytes(bad)
        with pytest.raises(ValueError):
            ref_load_raw(str(path))
        with pytest.raises(ValueError, match="artraw: failed to decode DNG"):
            load_raw(str(path))
    # a strip cut short decodes what it holds, in both
    path.write_bytes(data[: len(data) // 3])
    np.testing.assert_array_equal(load_raw(str(path)).cfa,
                                  ref_load_raw(str(path)).cfa)


def test_decoder_is_the_ports_own_build():
    lib = native_binding._load()
    assert os.path.dirname(lib._name) == str(hostbuild.BUILD_DIR)
    assert lib._name == str(hostbuild.target("artraw"))
    assert "art_tpu/io/native" not in lib._name
    # the source is a verbatim copy of the reference's, built with the
    # reference's flags less -march=native
    with open(os.path.join(REPO, "art_tpu", "io", "native",
                           "artraw.cc"), "rb") as f:
        assert (hostbuild.SRC_DIR / "artraw.cc").read_bytes() == f.read()
    assert not any(f.startswith("-march") for f in hostbuild.CXX_FLAGS)


def test_non_raw_and_non_native_inputs_raise(tmp_path, monkeypatch):
    """A non-raw file loads through load_std_image, so a missing one
    raises as Image.open does; a raw format the native decoder does not
    read raises as the reference's does unless a registered preconverter
    turns it into a DNG (tests/test_torch_iomanager.py), here one whose
    command fails."""
    from art_tpu.io import iomanager as ref_iomanager
    from art_tpu.io import load_image as ref_load_image
    from art_tpu.settings import settings as ref_settings
    from art_tpu_torch.io import iomanager, load_image
    from art_tpu_torch.settings import settings

    for load in (load_image, ref_load_image):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "photo.png"))
    for load in (load_raw, ref_load_raw):
        with pytest.raises(NotImplementedError, match="not natively decoded"):
            load(str(tmp_path / "x.mos"))
    conf = tmp_path / "imageio"
    conf.mkdir()
    (conf / "mos.txt").write_text("[ART RAWImageIO]\nExtension=mos\n"
                                  "ReadCommand=conv\n")
    (tmp_path / "x.mos").write_bytes(b"junk")
    for mod, iom in ((settings, iomanager), (ref_settings, ref_iomanager)):
        monkeypatch.setattr(mod, "user_dir", str(tmp_path))
        monkeypatch.setattr(iom, "_instance", None)
    try:
        for load in (load_raw, ref_load_raw):
            with pytest.raises(NotImplementedError,
                               match="register an external preconverter"):
                load(str(tmp_path / "x.mos"))
    finally:
        iomanager.reset()
        ref_iomanager.reset()