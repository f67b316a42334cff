"""art_tpu_torch stands alone: a subprocess that refuses every `jax`,
`jaxlib` and `art_tpu` import plans and develops the flagship frame (AMaZE
and bilinear), config 3 (RCD, non-fused denoise, impulse), a dual
demosaic (`dcbvng4`), a pixel-shift frame and a Foveon frame; another
that also refuses `PIL` and `cv2` (absent on the card's machine) runs
`cli.main` from a DNG to a JPEG, and through the batch queue with
`--devices 2`; a third, refusing all four, develops the fast export of
E3 (config 3's denoise, whole-plane), E1's settings (highlights,
sharpening, rotation, crop, resize, Adobe RGB), the look paths L1
(with its automatic log encoding and grain) and L2, and the lens and
sensor corrections of C1 and C2 at a small size; a fourth, refusing all
four, develops the colour profiles and LUTs of P1 (a DCP, temperature
WB, a matrix/para .icc out), P2 (LUT-class .icc in and out) and P3 (a
Hald PNG, a CLF, a CTL script and an external generator) with a gamut
warning; a fifth, refusing all four, develops M1's region masks (area,
linked, drawn, a 16-bit grey PNG) and M2's auto white balance with a
histogram listener; a sixth, refusing all four, decodes an embedded
preview (whole and through the salvage pass), plans the bundled
Auto-Matched Curve.arp on a DNG with a preview, and loads a Hald CLUT and
a grey mask written as JPEG; a seventh, refusing all four, runs the
entry points: `init` with a user directory that registers the shipped
PGM preconverter, `load_image` of a preconverted raw and of a PNG with an
ICC profile (the LittleCMS model), `process_image`'s refusal of it and
`thumbnail` from a preview; no source file of the package (`parallel/`,
the export's and the colour profiles' modules, `masks/raster.py`,
`pipeline/scopes.py`, `io/jpegdec.py`, `io/native/jpegdec.cc`,
`io/iomanager.py`, `color/lcms.py` and `preconverters/` among them), nor
chip_smoke.py, imports any of them or reads a file under art_tpu/; and
the port's copies of the reference's host modules (profiles, colour-space
tables, camera constants, output TRCs) hold the reference's values.
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILES = os.path.join(REPO, "art_tpu_torch", "data", "profiles")
ARPS = sorted(f for f in os.listdir(PROFILES) if f.endswith(".arp"))

SCRIPT = r'''
import sys

BLOCKED = ("jax", "jaxlib", "art_tpu")


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in this process: " + name)
        return None


sys.meta_path.insert(0, _Refuse())

import os
import numpy as np
import torch
from art_tpu_torch.params import ProcParams
from art_tpu_torch.core.image import synthesize_bayer
from art_tpu_torch.pipeline import develop as tdev

rgb = np.random.default_rng(3).uniform(0.02, 0.95, (3, 256, 1024))
frame = synthesize_bayer(rgb.astype(np.float32))
for method in ("amaze", "bilinear"):
    pp = ProcParams()
    pp.apply_arp_text(open(os.path.join(
        sys.argv[1], "art_tpu_torch", "data", "profiles",
        "Standard Film Curve.arp")).read())
    assert pp.raw.bayer.method == "amaze"
    pp.raw.bayer.method = method
    pp.denoise.enabled = True
    pp.denoise.luminance = 20.0
    pp.denoise.chrominance = 20.0
    out = tdev.develop(frame, pp, device="cpu")
    assert tuple(out.shape) == (3, 256, 1024), out.shape
    assert bool(torch.isfinite(out).all())
    assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0
from chip_smoke import config3_pp
out = tdev.develop(frame, config3_pp(), device="cpu")
assert tuple(out.shape) == (3, 256, 1024), out.shape
assert bool(torch.isfinite(out).all())
assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0
# a dual demosaic, a pixel-shift frame (a patch moved: the AMaZE
# fallback runs) and a Foveon frame (3 u16 planes)
from art_tpu_torch.io.rawfile import RawFrame, synthesize_pixelshift
ps = synthesize_pixelshift(rgb[:, :96, :160])
ps.extra_frames[:, 40:60, 60:90] *= 0.5
fov = RawFrame(cfa=(rgb[:, :96, :160] * 4000 + 16).astype(np.uint16),
               pattern=None, integral=True, make="SIGMA")
for fr, method in ((frame, "dcbvng4"), (ps, "pixelshift"), (fov, "amaze")):
    pp = ProcParams()
    pp.raw.bayer.method = method
    cfg, _ = tdev.plan(fr, pp, device="cpu")
    assert cfg.demosaic_method == ("foveon" if fr is fov else method), cfg
    out = tdev.develop(fr, pp, device="cpu")
    assert tuple(out.shape[-2:]) == fr.cfa.shape[-2:], out.shape
    assert bool(torch.isfinite(out).all())
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("STANDALONE-OK")
'''


CLI_SCRIPT = r'''
import sys

BLOCKED = ("jax", "jaxlib", "art_tpu", "PIL", "cv2")


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in this process: " + name)
        return None


sys.meta_path.insert(0, _Refuse())

import os
import numpy as np
from art_tpu_torch import cli
from art_tpu_torch.io.dngwrite import write_dng

d = sys.argv[2]
m = (np.random.default_rng(1).uniform(0.05, 0.9, (128, 192)) * 16000
     + 500).astype(np.uint16)
write_dng(os.path.join(d, "in.dng"), m, black=500, white=16500)
with open(os.path.join(d, "bilinear.arp"), "w") as f:
    f.write("[RAW Bayer]\nMethod=bilinear\n")
rc = cli.main(["-Y", "-p", os.path.join(d, "bilinear.arp"), "-O",
               os.path.join(d, "out.jpg"), "-c", os.path.join(d, "in.dng")],
              device="cpu")
assert rc == 0, rc
data = open(os.path.join(d, "out.jpg"), "rb").read()
assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
assert os.path.isfile(os.path.join(d, "out.jpg.arp"))
# the batch queue, two workers on the CPU
os.makedirs(os.path.join(d, "batch"))
rc = cli.main(["-p", os.path.join(d, "bilinear.arp"), "-o",
               os.path.join(d, "batch") + os.sep, "--devices", "2", "-c",
               os.path.join(d, "in.dng"), os.path.join(d, "out.jpg.arp")],
              device="cpu")
assert rc == 2, rc  # the .arp is no raw file: its job fails alone
assert open(os.path.join(d, "batch", "in.jpg"), "rb").read()[:2] == \
    b"\xff\xd8"
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("CLI-STANDALONE-OK")
'''


EXPORT_SCRIPT = r'''
import sys

BLOCKED = ("jax", "jaxlib", "art_tpu", "PIL", "cv2")


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in this process: " + name)
        return None


sys.meta_path.insert(0, _Refuse())

import os
import torch
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import clipped_frame, e3_pp, export_pp, fast_box_arp

frame = clipped_frame(96, 160, seed=9, share=0.05)
pp = e3_pp()
pp.apply_arp_text(fast_box_arp(80))
cfg, _ = tdev.plan(frame, pp, fast=True)
assert cfg.early_resize == (96, 160, 48, 80), cfg.early_resize
out = tdev.develop(frame, pp, device="cpu", fast=True)
assert tuple(out.shape) == (3, 48, 80), out.shape
out = tdev.develop(frame, export_pp(96, 160), device="cpu")
assert tuple(out.shape) == (3, 55, 33), out.shape
assert bool(torch.isfinite(out).all())
from chip_smoke import flagship_frame, l1_pp, l2_frame, l2_pp
for frame, pp in ((flagship_frame(96, 160, seed=5), l1_pp(96, 160)),
                  (l2_frame(96, 160, seed=5), l2_pp())):
    out = tdev.develop(frame, pp, device="cpu")
    assert tuple(out.shape) == (3, 96, 160), out.shape
    assert bool(torch.isfinite(out).all())
# the lens and sensor corrections: C1 (dark frame, flat field,
# .badpixels, line denoise, PDAF, an LCP profile, rotation, perspective)
# and C2 (an embedded gain map, lensfun, distortion and CA sliders)
import tempfile
from art_tpu_torch.io.rawfile import load_raw
from art_tpu_torch.settings import settings
from chip_smoke import (badpixels_dir, c1_files, c1_frame, c1_pp, c2_arp,
                        c2_dng, flagship_pp, lensfun_db)
with tempfile.TemporaryDirectory() as d:
    frame = c1_frame(96, 160, seed=5)
    files = c1_files(d, frame)
    with badpixels_dir(files["badpixels_dir"]):
        pp = c1_pp(files)
        cfg, _ = tdev.plan(frame, pp, device="cpu")
        assert cfg.transform and cfg.darkframe and cfg.badpix_file, cfg
        assert cfg.flatfield and cfg.pdaf and cfg.linedn[0] > 0, cfg
        out = tdev.develop(frame, pp, device="cpu")
    assert tuple(out.shape) == (3, 96, 160), out.shape
    c2_dng(os.path.join(d, "c2.dng"), 96, 160)
    settings.lensfun_db_dir = lensfun_db(os.path.join(d, "lensfun"))
    pp = flagship_pp("bilinear")
    pp.apply_arp_text(c2_arp())
    frame = load_raw(os.path.join(d, "c2.dng"))
    cfg, _ = tdev.plan(frame, pp, device="cpu")
    assert cfg.gainmap and cfg.transform, cfg
    out = tdev.develop(frame, pp, device="cpu")
    assert bool(torch.isfinite(out).all())
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("EXPORT-STANDALONE-OK")
'''


PROFILE_SCRIPT = r'''
import sys

BLOCKED = ("jax", "jaxlib", "art_tpu", "PIL", "cv2")


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in this process: " + name)
        return None


sys.meta_path.insert(0, _Refuse())

import tempfile
import torch
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import (flagship_frame, p1_arp, p2_arp, p3_arp,
                        profile_files, profile_pp)

frame = flagship_frame(96, 160, seed=5)
with tempfile.TemporaryDirectory() as d:
    files = profile_files(d, level=2)
    arps = {"P1": p1_arp(files), "P2": p2_arp(files)}
    for kind in ("hald", "clf", "ctl", "json"):
        arps[kind] = p3_arp(files[kind], after=kind == "ctl")
    for label, arp in arps.items():
        pp = profile_pp(arp)
        pp.raw.bayer.method = "bilinear"
        cfg, _ = tdev.plan(frame, pp, device="cpu")
        assert label[0] != "P" or cfg.out_trc[0] in ("para", "icclut"), cfg
        out = tdev.develop(frame, pp, device="cpu")
        assert tuple(out.shape) == (3, 96, 160), out.shape
        assert bool(torch.isfinite(out).all()), label
    out = tdev.process_image(frame, profile_pp(arps["P1"]),
                             gamut_warn="sRGB", device="cpu")
    assert out.shape == (3, 96, 160)
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("PROFILE-STANDALONE-OK")
'''


MASK_SCRIPT = r'''
import sys

BLOCKED = ("jax", "jaxlib", "art_tpu", "PIL", "cv2")


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in this process: " + name)
        return None


sys.meta_path.insert(0, _Refuse())

import os
import tempfile
import torch
from art_tpu_torch.pipeline import develop as tdev
from art_tpu_torch.pipeline.listeners import PipelineListener
from chip_smoke import flagship_frame, m1_pp, m2_pp, write_mask_png

frame = flagship_frame(96, 160, seed=5)
with tempfile.TemporaryDirectory() as d:
    pp = m1_pp(write_mask_png(os.path.join(d, "mask.png"), 40, 60))
    pp.raw.bayer.method = "bilinear"
    cfg, data = tdev.plan(frame, pp, device="cpu")
    ops = [s[0] for s in cfg.steps]
    for op in ("localcontrast", "smoothing", "colorcorrection",
               "textureboost"):
        assert op in ops, ops
    out = tdev.develop(frame, pp, device="cpu")
    assert bool(torch.isfinite(out).all())
    seen = []

    class Wants(PipelineListener):
        def auto_wb_changed(self, temp, green):
            seen.append("wb")

        def histogram_changed(self, hist_rgbl):
            seen.append(int(hist_rgbl["l"].sum()))

    pp = m2_pp()
    pp.raw.bayer.method = "bilinear"
    tdev.process_image(frame, pp, listener=Wants(), device="cpu")
    assert seen == ["wb", 96 * 160], seen
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("MASK-STANDALONE-OK")
'''


JPEG_SCRIPT = r"""
import sys

BLOCKED = ("jax", "jaxlib", "art_tpu", "PIL", "cv2")


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in this process: " + name)
        return None


sys.meta_path.insert(0, _Refuse())

import os
import tempfile
import numpy as np
from art_tpu_torch.color.lut3d import load_hald_clut
from art_tpu_torch.io import jpeg
from art_tpu_torch.io.dngwrite import write_dng
from art_tpu_torch.io.imagefile import read_grey
from art_tpu_torch.io.metadata import decode_jpeg_resilient, embedded_thumb
from art_tpu_torch.io.rawfile import load_raw
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev
from art_tpu_torch.pipeline.listeners import _Collect
from chip_smoke import flagship_frame, hald_image

frame = flagship_frame(64, 96, seed=2)
look = np.clip(0.5 - 0.5 * np.cos(np.pi * np.linspace(0, 1, 96)), 0, 1)
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "p.dng")
    write_dng(path, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, preview_rgb01=np.broadcast_to(look, (3, 64, 96)))
    thumb = embedded_thumb(path)
    assert thumb.shape == (3, 64, 96) and thumb.dtype == np.float32
    blob = jpeg.encode(np.random.default_rng(0).integers(
        0, 256, (64, 96, 3)).astype(np.uint8), 90, 1)
    cut = blob[: blob.index(b"\xff\xda") + 400]
    assert decode_jpeg_resilient(cut).shape == (64, 96, 3)
    assert decode_jpeg_resilient(b"\xff\xd8\xff\xe0junk") is None
    pp = ProcParams()
    pp.apply_arp_text(open(os.path.join(
        "art_tpu_torch", "data", "profiles", "Auto-Matched Curve.arp")).read())
    with _Collect() as report:
        cfg, _ = tdev.plan(load_raw(path), pp, device="cpu")
    assert [s[0] for s in cfg.steps] == ["tonecurve"], cfg.steps
    assert len(report["matched_curve"]) > 6
    hald = os.path.join(d, "hald.jpg")
    with open(hald, "wb") as f:
        f.write(jpeg.encode(hald_image(4, 8), 95, 3))
    assert load_hald_clut(hald).shape == (16, 16, 16, 3)
    mask = os.path.join(d, "mask.jpg")
    with open(mask, "wb") as f:
        f.write(jpeg.encode(hald_image(2, 8), 90, 1))
    plane, mode = read_grey(mask)
    assert mode == "L" and plane.shape == (8, 8)
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("JPEG-STANDALONE-OK")
"""


ENTRY_SCRIPT = r"""
import sys

BLOCKED = ("jax", "jaxlib", "art_tpu", "PIL", "cv2")


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in this process: " + name)
        return None


sys.meta_path.insert(0, _Refuse())

import os
import tempfile
import numpy as np
import art_tpu_torch
from art_tpu_torch.color import iccwrite
from art_tpu_torch.io.dngwrite import write_dng
from art_tpu_torch.io.imagefile import write_png

rng = np.random.default_rng(0)
with tempfile.TemporaryDirectory() as d:
    tempfile.tempdir = d
    os.makedirs(os.path.join(d, "user", "imageio"))
    with open(os.path.join(d, "user", "imageio", "pnm.txt"), "w") as f:
        f.write("[ART RAWImageIO]\nExtension=mos\nReadCommand="
                + sys.executable + " " + os.path.abspath(os.path.join(
                    "art_tpu_torch", "preconverters", "pnm_to_dng.py"))
                + "\n")
    art_tpu_torch.init(user_settings_dir=os.path.join(d, "user"))
    m = rng.integers(600, 15000, (32, 48)).astype(np.uint16)
    with open(os.path.join(d, "shot.mos"), "wb") as f:
        f.write(b"P5\n48 32\n65535\n" + m.astype(">u2").tobytes())
    frame = art_tpu_torch.load_image(os.path.join(d, "shot.mos"))
    assert (frame.cfa == m).all() and frame.pattern == "RGGB"
    png = os.path.join(d, "a.png")
    write_png(png, rng.integers(0, 256, (8, 12, 3)).astype(np.uint8),
              icc_bytes=iccwrite.make_icc("Adobe RGB"))
    img = art_tpu_torch.load_image(png)
    assert img.rgb.shape == (3, 8, 12) and not img.is_raw
    try:
        art_tpu_torch.process_image(png, None, device="cpu")
        raise AssertionError("a non-raw develop went through")
    except NotImplementedError as e:
        assert "non-raw input" in str(e)
    dng = os.path.join(d, "p.dng")
    write_dng(dng, m, black=512, white=16383,
              preview_rgb01=np.full((3, 16, 24), 0.5))
    thumb = art_tpu_torch.thumbnail(dng, max_px=8, device="cpu")
    assert thumb.shape == (3, 6, 8)
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("ENTRY-STANDALONE-OK")
"""


def test_develops_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, REPO], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "STANDALONE-OK" in proc.stdout


def test_cli_with_jax_pil_and_cv2_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", CLI_SCRIPT, REPO,
                           str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "CLI-STANDALONE-OK" in proc.stdout


def test_export_with_jax_pil_and_cv2_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", EXPORT_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "EXPORT-STANDALONE-OK" in proc.stdout


def test_profiles_with_jax_pil_and_cv2_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", PROFILE_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PROFILE-STANDALONE-OK" in proc.stdout


def test_masks_and_autos_with_jax_pil_and_cv2_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", MASK_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "MASK-STANDALONE-OK" in proc.stdout


def test_jpeg_paths_with_jax_pil_and_cv2_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", JPEG_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "JPEG-STANDALONE-OK" in proc.stdout


def test_entry_points_with_jax_pil_and_cv2_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", ENTRY_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ENTRY-STANDALONE-OK" in proc.stdout


FORMATS_SCRIPT = r"""
import sys

BLOCKED = ("jax", "jaxlib", "art_tpu", "PIL", "cv2")


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in this process: " + name)
        return None


sys.meta_path.insert(0, _Refuse())

import hashlib
import json
import os
import tempfile
import numpy as np
import chip_smoke
from art_tpu_torch.io import imagefile, unported

qoi = b"qoif\0\0\0\4\0\0\0\3\3\0"
assert unported.walk(qoi)[0] == "QOI" and unported.walk(qoi)[1] is not None
assert unported.identify(qoi) is None
im = b"Image type: RGB image\r\nImage size (x*y): 4*3\r\n\x1a" + bytes(36)
assert unported.identify(im) is None and unported.walk(im)[0] == "IM"
assert imagefile._decode(im, None)[1].shape == (3, 4, 3)
icns = b"icns\0\0\0\x10ic07\0\0\0\x08"
assert unported.identify(icns) is None and unported.walk(icns)[0] == "ICNS"
with tempfile.TemporaryDirectory() as d:
    for name, (path, want) in chip_smoke.formats_files(d, 40, 64).items():
        mode, samples, _ = imagefile.read_image(path)
        assert want is None or np.array_equal(samples, want), name
with open(os.path.join("tests", "data", "formats_sha256.json")) as f:
    rec = json.load(f)
for name, sha in rec.items():
    if name.startswith(("F1 ", "Q1 ", "U1 ")):  # generated 24 MP files
        continue
    with tempfile.TemporaryDirectory() as d:
        path = chip_smoke.write_pcd(os.path.join(d, "g.pcd")) \
            if name == chip_smoke.G1_PCD else \
            os.path.join("tests", "data", name)
        rgb = imagefile.read_rgb8(path)
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == sha, name
print("FORMATS-STANDALONE-OK")
"""


def test_formats_with_jax_pil_and_cv2_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", FORMATS_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "FORMATS-STANDALONE-OK" in proc.stdout


def _port_sources():
    root = os.path.join(REPO, "art_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cc")):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


# an import of jax, jaxlib or art_tpu (not art_tpu_torch)
IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|art_tpu)\b", re.M)
# an import of PIL or OpenCV, which the card's machine lacks
IMAGE_LIB = re.compile(r"^\s*(import|from)\s+(PIL|cv2)\b", re.M)
# a path into the reference package: os.path.join(..., "art_tpu", ...)
# or a literal art_tpu/data/... path
REF_PATH = re.compile(r"""["']art_tpu["']\s*,|art_tpu/data""")


def test_no_source_file_imports_jax():
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for name in ("__init__.py", "queue.py", "dryrun.py"):
        assert os.path.join("art_tpu_torch", "parallel", name) in scanned
    for name in ("ops/sharpen.py", "ops/resize.py", "ops/dct_detail.py",
                 "raw/hilite.py", "raw/hilite_inpaint.py",
                 "lens/exifcorr.py", "ops/labadj.py", "ops/bw.py",
                 "ops/hsl.py", "ops/defringe.py", "ops/logenc.py",
                 "ops/gradients.py", "ops/textureboost.py",
                 "ops/colorcorrection.py", "ops/smoothing.py", "ops/spot.py",
                 "ops/filmneg.py", "ops/fattal.py", "color/ciecam02.py",
                 "core/prng.py", "pipeline/autos.py",
                 "pipeline/transform.py", "lens/lcp.py", "lens/lensfun.py",
                 "raw/dfff.py", "raw/dfff_managers.py", "io/gainmap.py",
                 "raw/cfa_linedn.py", "raw/pdaf.py", "color/dcp.py",
                 "color/iccfile.py", "color/icclut.py", "color/clf.py",
                 "color/ctl.py", "color/extclut.py",
                 "color/gamutwarning.py", "ops/dcplook.py",
                 "io/imagefile.py", "io/jpegdec.py", "io/metadata.py",
                 "io/jpeg2000.py", "io/native/jp2dec.cc", "io/plugins.py",
                 "io/native/jpegdec.cc", "io/tiff.py", "io/ojpeg.py",
                 "io/native/tiffdec.cc", "io/iomanager.py", "color/lcms.py",
                 "preconverters/pnm_to_dng.py", "__init__.py"):
        assert os.path.join("art_tpu_torch", name) in scanned
    offenders = []
    for path in _port_sources():
        with open(path) as fh:
            if IMPORT.search(fh.read()):
                offenders.append(path)
    assert offenders == []


def test_no_source_file_imports_pil_or_cv2():
    assert IMAGE_LIB.search("    from PIL import Image")
    assert IMAGE_LIB.search("import cv2")
    assert not IMAGE_LIB.search("from art_tpu_torch.io import jpeg")
    offenders = []
    for path in _port_sources():
        with open(path) as fh:
            if IMAGE_LIB.search(fh.read()):
                offenders.append(path)
    assert offenders == []


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        src = fh.read()
    assert not IMPORT.search(src)
    assert IMPORT.search("from art_tpu.params import ProcParams")
    assert not IMPORT.search("from art_tpu_torch.params import ProcParams")


def test_no_source_file_reads_the_reference_package():
    assert REF_PATH.search('os.path.join(root, "art_tpu", "data")')
    assert not REF_PATH.search('"replaces": "art_tpu/ops/x.py:1"')
    offenders = []
    for path in _port_sources():
        with open(path) as fh:
            if REF_PATH.search(fh.read()):
                offenders.append(path)
    assert offenders == []


@pytest.mark.parametrize("arp", ARPS)
def test_bundled_profiles_parse_as_in_the_reference(arp):
    from art_tpu.params import ProcParams as RefProcParams
    from art_tpu_torch.params import ProcParams

    with open(os.path.join(PROFILES, arp)) as f:
        text = f.read()
    with open(os.path.join(REPO, "art_tpu", "data", "profiles", arp)) as f:
        assert f.read() == text
    ours, ref = ProcParams(), RefProcParams()
    ours.apply_arp_text(text)
    ref.apply_arp_text(text)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_host_tables_equal_the_reference():
    from art_tpu.color import colorspaces as rcs
    from art_tpu.color.iccstore import get_instance as ref_icc
    from art_tpu.raw.camconst import get_instance as ref_camconst
    from art_tpu_torch.color import colorspaces as cs
    from art_tpu_torch.color.iccstore import output_trc
    from art_tpu_torch.raw.camconst import get_instance as camconst

    for table in ("MATRICES_RGB_TO_XYZ", "MATRICES_XYZ_TO_RGB"):
        ours, ref = getattr(cs, table), getattr(rcs, table)
        assert sorted(ours) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    for name in ("D65_TO_D50", "D50_TO_D65", "XYZ_FROM_SRGB_D65",
                 "SRGB_D65_FROM_XYZ"):
        np.testing.assert_array_equal(getattr(cs, name), getattr(rcs, name))
    assert cs.OUTPUT_GAMMAS == rcs.OUTPUT_GAMMAS
    assert cs._srgb_gamma_fit() == rcs._srgb_gamma_fit()
    x = np.linspace(-0.1, 1.1, 4097)
    np.testing.assert_array_equal(cs.srgb_gamma(x), rcs.srgb_gamma(x))
    np.testing.assert_array_equal(cs.srgb_igamma(x), rcs.srgb_igamma(x))
    for name in (*rcs.MATRICES_RGB_TO_XYZ, "", None, "no such space"):
        assert output_trc(name) == ref_icc().output_profile(name).trc, name

    ours, ref = camconst()._db, ref_camconst()._db
    assert len(ref) > 100 and sorted(ours) == sorted(ref)
    for key, cc in ref.items():
        assert ours[key].data == cc.data, key
        assert ours[key].pdaf() == cc.pdaf(), key
