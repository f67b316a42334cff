"""The bundled profiles through art_tpu_torch against `art_tpu` on the
CPU, histogram matching and `--check-lut`:

- each bundled `.arp` (Punchy with saturation and the Neutral curve,
  Auto-Matched Curve, Neutral, Standard Film Curve) plans the
  reference's steps and develops a 64x96 LJ92 DNG (AMaZE) within
  PERF.md section 2's bounds (max <= 1/255, mean <= 2e-4, >= 99.9%
  within one 8-bit step);
- histogram matching: the reference derives a curve only from an
  embedded JPEG preview (develop.py:482-503), so Auto-Matched Curve on
  a DNG without one develops with the tone curve untouched, and one
  written with a preview derives the reference's curve and develops
  within the same bounds;
- `--check-lut` answers as the reference's for .cube files (0 if the
  LUT loads, 1 with "Invalid LUT file" if not, as for a missing file)
  and for a Hald CLUT PNG and JPEG (the port's own decoders), and exits
  2 naming the format for an image the decoder does not read (a GIF).
"""

import importlib
import os

import numpy as np
import pytest

from art_tpu.io.rawfile import load_raw as ref_load_raw
from art_tpu.params import ProcParams as RefProcParams
from art_tpu_torch.io.dngwrite import write_dng
from art_tpu_torch.io.rawfile import load_raw
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import parity, write_cube

jdev = importlib.import_module("art_tpu.pipeline.develop")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILES = os.path.join(REPO, "art_tpu_torch", "data", "profiles")
# the steps each bundled profile plans, in both packages
STEPS = {"Punchy.arp": ["saturation", "tonecurve"],
         "Auto-Matched Curve.arp": [],
         "Neutral.arp": [],
         "Standard Film Curve.arp": ["tonecurve"]}


def _mosaic(h, w):
    return (np.random.default_rng(1).uniform(0.05, 0.9, (h, w)) * 16000
            + 500).astype(np.uint16)


@pytest.fixture(scope="module")
def dngs(tmp_path_factory):
    """A 64x96 LJ92 DNG without a preview, and one with a JPEG preview."""
    d = tmp_path_factory.mktemp("profiles")
    m = _mosaic(64, 96)
    write_dng(d / "plain.dng", m, black=500, white=16500)
    preview = np.random.default_rng(2).uniform(0, 1, (3, 16, 24))
    write_dng(d / "preview.dng", m, black=500, white=16500,
              preview_rgb01=preview)
    return d


def _pps(arp):
    with open(os.path.join(PROFILES, arp)) as f:
        text = f.read()
    ours, ref = ProcParams(), RefProcParams()
    ours.apply_arp_text(text)
    ref.apply_arp_text(text)
    return ours, ref


@pytest.mark.parametrize("arp", sorted(STEPS))
def test_bundled_profile_develops_as_the_reference(dngs, arp):
    path = str(dngs / "plain.dng")
    pp, ref_pp = _pps(arp)
    cfg, _ = tdev.plan(load_raw(path), pp)
    ref_cfg, _ = jdev.plan(ref_load_raw(path), ref_pp)
    assert [s[0] for s in cfg.steps] == [s[0] for s in ref_cfg.steps] \
        == STEPS[arp]
    out = tdev.develop(load_raw(path), pp, device="cpu")
    ref = np.asarray(jdev.develop(ref_load_raw(path), ref_pp))
    st = parity(out, ref)
    print(arp, "port vs art_tpu", st)
    assert st["max_lsb8"] <= 1.0, st
    assert st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st


def test_auto_matched_curve_with_a_jpeg_preview_is_refused(dngs):
    # ported since: with a JPEG preview the bundled profile derives the
    # reference's curve from it (points within 1e-6) and develops within
    # the bounds; a curve already matched is the user's curve
    path = str(dngs / "preview.dng")
    pp, ref_pp = _pps("Auto-Matched Curve.arp")
    assert pp.tone_curve.histmatching
    cfg, _ = tdev.plan(load_raw(path), pp, device="cpu")
    assert [s[0] for s in cfg.steps] == ["tonecurve"]
    out = tdev.develop(load_raw(path), pp, device="cpu")
    ref = np.asarray(jdev.develop(ref_load_raw(path), ref_pp))
    assert ref_pp.tone_curve.from_histmatching
    st = parity(out, ref)
    print("Auto-Matched Curve with a preview, port vs art_tpu", st)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    pp.tone_curve.from_histmatching = True
    assert [s[0] for s in tdev.plan(load_raw(path), pp, device="cpu")[
        0].steps] == []


def _check_lut(main, path, capsys):
    rc = main(["--check-lut", str(path)])
    out = capsys.readouterr()
    return rc, out.out + out.err


@pytest.mark.parametrize("case", ["cube", "garbage", "truncated", "missing"])
def test_check_lut_answers_as_the_reference(tmp_path, capsys, case):
    from art_tpu import cli as ref_cli
    from art_tpu_torch import cli

    path = tmp_path / ("lut.png" if case == "missing" else "lut.cube")
    if case == "cube":
        write_cube(str(path), 5)
    elif case == "garbage":
        path.write_bytes(b"\x00\x01 not a LUT\n")
    elif case == "truncated":
        path.write_text("LUT_3D_SIZE 5\n0 0 0\n1 1 1\n")
    rc, text = _check_lut(cli.main, path, capsys)
    ref_rc, ref_text = _check_lut(ref_cli.main, path, capsys)
    assert rc == ref_rc == (0 if case == "cube" else 1)
    assert text == ref_text
    if rc:
        assert f"Invalid LUT file: {path}" in text


def test_check_lut_refuses_a_hald_image(tmp_path, capsys):
    # ported since: a Hald PNG, JPEG, GIF and WebP load (0) as in the
    # reference; an image format the port's decoder does not read (a
    # TGA) exits 2 naming it
    from PIL import Image

    from art_tpu import cli as ref_cli
    from art_tpu_torch import cli
    from chip_smoke import hald_image, write_hald

    path = tmp_path / "hald.png"
    write_hald(str(path), level=2, bits=8)
    jpeg = tmp_path / "hald.jpg"
    Image.fromarray(hald_image(2, 8)).save(jpeg)
    gif = tmp_path / "hald.gif"
    Image.fromarray(hald_image(2, 8)).save(gif)
    webp = tmp_path / "hald.webp"
    Image.fromarray(hald_image(2, 8)).save(webp, lossless=True)
    for lut in (path, jpeg, gif, webp):
        rc, text = _check_lut(cli.main, lut, capsys)
        ref_rc, ref_text = _check_lut(ref_cli.main, lut, capsys)
        assert rc == ref_rc == 0 and text == ref_text
    tga = tmp_path / "hald.tga"
    Image.fromarray(hald_image(2, 8)).save(tga)
    rc, text = _check_lut(cli.main, tga, capsys)
    ref_rc, ref_text = _check_lut(ref_cli.main, tga, capsys)
    assert rc == ref_rc == 0 and text == ref_text
    jp2 = tmp_path / "hald.jp2"
    Image.fromarray(hald_image(2, 8)).save(jp2)
    rc, text = _check_lut(cli.main, jp2, capsys)
    assert rc == 2
    assert "JPEG 2000 image" in text and "does not read JPEG 2000" in text
    assert "Invalid LUT file" not in text
