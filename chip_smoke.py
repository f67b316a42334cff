"""Smoke run of art_tpu_torch on one NVIDIA GPU (H100 class).

    python3 chip_smoke.py

Builds the CUDA kernels from art_tpu_torch/csrc (one nvcc per source) and
the host decoder and JPEG encoder from art_tpu_torch/io/native (g++), all
at once, and drives the paths below through the user's entry points,
plan -> develop(device="cuda") -> crop_result, each with the launch and
plain-call counts set to 0 just before it and read just after:

- the main path, the flagship as bench.py defines it: a 4000x6000 RGGB
  mosaic from seed 0, `Standard Film Curve.arp` (AMaZE), denoise at
  luminance/chrominance 20, the Neutral tone curve, sRGB out; kernels B1,
  B2, B3 (AMaZE stages), B4 (wavelet denoise) and B7 (Neutral curve);
- the same frame with bilinear demosaic (B4 and B7);
- config 3 (BASELINE.json configs[2], as tools/bench_configs.py writes
  it) with the Smoothing group on, on the same frame: ProcParams()
  defaults, RCD, denoise 20/20 with NLMeans 50 and the guided chroma
  filter, impulse denoise, no tone curve; kernels B5 (wavelet chain on
  the stacked Y/U/V) and B6 (NLMeans);
- config 2 (BASELINE.json configs[1]) with both hot/dead filters on: the
  flagship frame with R and B magnified by 1 +- 2e-3 before mosaicing
  and 0.1% of the sites 0 or white; hot/dead pixels, green
  equilibration at 100, auto raw CA, AMaZE (B1, B2, B3 once each and no
  other kernel), the unfused raw head and output tail;
- config 4 (BASELINE.json configs[3]) with Contrast_1=30: a 4008x6000
  X-Trans frame from seed 2 as tools/bench_configs.py makes it, 3-pass,
  dehaze, the tone equalizer, a 33^3 .cube film simulation, local
  contrast; no kernel. For configs 2 and 4 it prints the median develop,
  the host plan and the device program alone, peak memory by stage,
  device ms by `art:` stage, and config 2's flagged bad pixels.

It checks that every kernel of a path launched and no plain version ran,
that the output has the frame's shape, finite and in [0, 1], that each
kernel equals its plain PyTorch version on the tensors its path feeds it
(bounds below), and that a 512x1024 develop on the card agrees with the
same develop on the CPU's plain path, for each path, to the slice bounds
of the CPU tests (configs 2 and 4 at 512x768 and 384x576; config 2's
hot/dead and green-equilibration decisions may flip between the devices
at RAW_FLIPS of the sites, the max held beyond RAW_REACH pixels of them).
It prints the card's name and power limit, develop and device-program
timings, peak memory and the stage and kernel launch
that set it, torch.profiler tables, the kernels' ptxas report
(registers, spills), for every kernel its registers and shared memory
as loaded, and device time by kernel name: B4 and B5 by torch.profiler
(sigma passes against level kernels, also on a constant frame, where
every value falls in one histogram bin) with their scratch bytes; B1,
B2, B3 and B6, one kernel a call, by CUDA events, with the bytes a B1,
B2 or B3 call allocates beside its output's and the share of nyquist2
pixels, where B2's area sums run, and B6 also on a constant plane and
where the weight's clamp at 50 fires, each held to the plain version.
Then the headless CLI path, `art_tpu_torch.cli.main` from a DNG file to a
JPEG on the card, counts reset before each: config 1 (BASELINE.json
configs[0]: a 4000x6000 RGGB DNG from seed 1 as tools/bench_configs.py
writes it, uncompressed, bilinear, no kernel), with the median of each
phase (decode, plan, H2D, device program, D2H, metadata, encode+write)
over 3 runs after a warm one and the u8 output's readback beside the f32
planes'; config 1 on a 512x768 LJ92 DNG against the CPU; and the AMaZE
flagship from a DNG of the flagship frame with the bundled profile and a
second one that turns the denoise on at 20/20 (B1, B2, B3, B4 and B7,
one launch each), timed the same way, its u8 output equal to the u8 cast
of the float develop on the card, and each JPEG's markers well formed.
Then config 5, the batch queue (`art_tpu_torch.parallel.process_batch`
over every CUDA device, one worker each): C5_JOBS (16) jobs of a
4000x6000 RGGB DNG from seed 3 as tools/bench_configs.py writes it
(uncompressed, hardlinked per job), AMaZE and denoise at luminance 20,
to JPEGs, after a warm run of 2, with the window of the reference's
one-chip run (prefetch 8): images/s, the stages' worker-seconds, the
frames held against the window, the device's busy share (torch.profiler
over C5_SUB (4) jobs) and C5_SUB jobs at the default window; B1-B4
C5_JOBS launches each and no other, every JPEG well formed, job 0's
scan byte-equal to
process_image's. Then a mixed catalog of 10 jobs (the four bundled
profiles and USER_ARP, which turns on the five pointwise ops), B7 once
per Neutral-curve job, and USER_ARP's 512x1024 develop against the CPU.
Then the everyday export (`export_phase`), counts reset before each
path: E1, the flagship frame with blown highlights (`clipped_frame`,
about 1% of the sites at white) and `export_pp` (Blend, denoise 20/20
with LuminanceDetail 30, RL sharpening, a quarter turn, a 3000x4500
crop at (500, 750), a 2048 box with USM output sharpening, Adobe RGB),
B1, B2, B3, B5 and B7 (no epilogue) once each and no other, as
new_path runs configs 2 and 4, with a 512x1024 develop against the CPU;
E2, the flagship's fast export (-q) through cli.main at the default
1920 box (B1-B3 at 24 MP, B4 with no raw head at 1280x1920, B7 with the
sRGB epilogue), its phases and the Lanczos matrices' share of the H2D;
E3, config 3's denoise with LuminanceDetail 30 in a fast export to an
800 box (533x800: the whole-plane wavelet, the DCT pass, guided chroma;
B6 once, its 256x256 tile fits, as in the reference), as new_path runs;
B7 with no epilogue and B4 with no raw head against their plain
versions on the tensors E1 and E2 feed them; and 512x1024 develops with
HLRecovery=Color and ColorSoft against the CPU.
Then the look (`look_phase`), counts reset before each path: L1, a
colour grade on the flagship frame (`l1_pp`: two spot entries, HSL,
defringe, colour correction in three regions, smoothing with NLMeans on
Y, U and V under a parametric mask and a glow, grain, the gradients,
texture boost, automatic log encoding, Lab adjustments), B1, B2, B3, B4
(no raw head) and B7 (no epilogue) once and B6 three times; L2, a
scanned colour negative (`l2_frame`, `l2_pp`: film negative, Fattal, a
FilmLike curve, B&W), B1-B3 once; each as new_path runs, with its
512x1024 develop against the CPU; B6 against its plain version on the
luma and chroma planes L1's smoothing feeds it; Fattal's 49-point
median at 24 MP beside a 9-point one; and each of the seven tone-curve
modes in a 512x768 develop against the CPU.
Then the lens and sensor corrections (`lens_phase`), counts reset before
each path: C1, a calibrated, lens-corrected flagship (`c1_frame`,
`c1_files`, `c1_pp`: the flagship frame named as a FUJIFILM GFX 100,
whose camconst entry has PDAF rows, under a lens falloff with a dark
pattern; a dark-frame and a flat-field DNG, a .badpixels file, CFA line
denoise, the PDAF filter, an LCP profile's distortion, CA and vignette,
a rotation by 1.5 degrees, perspective and auto-fill; AMaZE, denoise, the
Neutral curve), B1, B2, B3, B4 (raw head) and B7 (sRGB epilogue) once
each, as new_path runs it, each kernel held to its plain version on the
tensors C1 feeds it and a 512x1024 develop against the CPU; C2, a 24 MP
DNG with four 9x9 gain maps developed through cli.main with lensfun
(`lensfun_db`), a distortion slider and CA sliders (`c2_arp`), its
phases (median of 2 after a warm run), its launches and a 512x1024
develop against the CPU.
Then the demosaics and raw inputs (`demosaic_phase`), counts reset
before each path: D1, the flagship with `amazevng4` and the automatic
dual contrast (B1-B4, B7); D2, each other Bayer name of D2_METHODS on
the flagship frame's top quarter (D2_FRAME, the full width) and profile
(B4 and B7; B1-B3 for the AMaZE dual), with a 128x1024 crop against the
CPU; D3, pixel shift: four 24 MP
frames of the flagship scene with a 512x512 patch moved (B1-B3 in the
motion fallback, B4 with no raw head, B7), its motion share and the H2D
of the three float32 extra frames; D4, a (3, 4000, 6000) u16 Foveon
frame (B4 with the raw head, B7); D5, X-Trans 4-pass with the automatic
dual blend on config 4's frame and settings (no kernel). Each prints its
device program, peak memory and device ms by `art:` stage, holds each
kernel it launched to its plain version on its own tensors, and
compares the card with the CPU, with flip_parity over the demosaic's
sites that moved between them or pixel shift's motion masks.
Then the colour profiles and LUTs (`profile_phase`), counts reset
before each path, on the flagship frame and profile, every file written
from a seed (`profile_files`): P1, a dual-illuminant DCP with its look
late under Custom WB at 5200 K, to a v4 matrix/para .icc; P2, LUT-class
.icc profiles in (mAB, 33^3) and out (mft2 on Lab, 17^3); P3, a
level-12 16-bit Hald PNG, a CLF, a CTL script after the curve and an
external generator at strength 80, then the Hald run through cli.main
with --gamut-warn (ProPhoto out, an sRGB proof). Each launches B1-B3,
B4 (with no raw head on P1 and P2) and B7 (with no epilogue on P1, P2
and the CTL run) once, held to their plain versions on the path's
tensors (the Hald and CTL runs for P3), with its develop, device
program, peak memory, device ms by `art:` stage (`dcp`, `dcplook_late`,
`iccin`, `iccout`, `filmsim_*`) and a small develop against the CPU;
also the Hald's decode, the CTL bake on the card against the CPU's, and
the gamut warning's time at 24 MP and its marks against the CPU's (at
most GAMUT_FLIPS of the pixels flip).
Then the region masks and the host autos (`mask_phase`), counts reset
before each path, on the flagship frame and profile: M1 (`m1_pp`),
Local Contrast under an area mask (a rectangle turned 30 degrees with
feather 25, less a non-convex polygon, an area blur), Smoothing's
NLMeans under the inverted linked mask, Colour Correction under three
stroke groups (one an erase; smoothness, feather, a contrast curve) and
Texture Boost under a 1000x1500 16-bit grey PNG (`write_mask_png`)
resampled to 24 MP through the guided filter: B1-B4, B6 and B7 once,
each held to its plain version on M1's tensors, B6 on the Smoothing
region's own, with the host plan's mask parts timed apart (the fills,
the card's blurs, the decode, the resample); M2 (`m2_pp`), WB Auto
through process_image with a listener that takes the histogram and the
auto WB report: B1-B4 and B7 once. Each prints its develop, device
program, peak memory, device ms by `art:` stage and a 512x1024 develop
against the CPU.
Then the JPEG decoder and histogram matching (`jpeg_phase`): H1, the
bundled Auto-Matched Curve.arp on a DNG with a full-size preview; H2,
the same through cli.main; J1, the decoder alone and P3's and M1's
paths with JPEG files.
Then the package's entry points (`entry_phase`), counts reset before
each path: X1, the flagship frame as a 16-bit PGM under a raw extension
the native decoder does not read (.mos), X1, T1 and N1 at ENTRY_FRAME
(half the flagship's rows), registered through `init` for
the shipped preconverter (art_tpu_torch/preconverters/pnm_to_dng.py),
through cli.main with the bundled profile and denoise 20/20: the first
call (the preconversion) and the cached one, the phases, B1-B4 and B7
once each and bit-equal to their plain versions on X1's tensors, the
scan byte-equal to cli.main's on the cached DNG, a 512x768 .mos
against the CPU; T1, `thumbnail` of a DNG with no preview (B1-B3,
as its plan says) and with H1's preview (no launch); N1, `load_image`
of non-raw files on the host (an 8-bit PNG, a 16-bit grey PNG, a
JPEG-compressed TIFF, a JPEG with an Adobe RGB profile), decode and ICC
conversion timed apart, an external loader, and the PNG through
cli.main (exit 2, non-raw input named, no file).
Then the image formats Pillow opens (`formats_phase`), on the host:
F1, 24 MP files the phase writes with its numpy writers (`write_bmp24`,
`write_pnm`, `write_gif`, `write_tiff_form`: a 24-bit BMP, an 8-bit PPM,
a 16-bit PGM, a GIF, a planar TIFF, a BigTIFF, a CMYK TIFF), each
decode's host ms and its array against the one written (the CMYK
TIFF's against the sha256 the CPU tests recorded from Pillow), and the
committed JPEG forms of tests/data (arithmetic-coded, lossless, CMYK,
YCCK) against Pillow's sha256; F2, P3's Hald film simulation with
Texture Boost under an external mask through cli.main at 24 MP, the
Hald a BMP and the mask a 16-bit PGM, its JPEG byte-equal to the same
develop from PNG files, B1-B4 and B7 once each and bit-equal to their
plain versions on F2's tensors.
Then WebP (`webp_phase`): W1, a 24 MP lossless WebP the phase writes
(`write_webp_lossless`: subtract-green, one prefix-code group), its
read_image host ms and array against the one written, the committed
24 MP lossy WebP with alpha and the small WebP fixtures of tests/data
against Pillow's sha256; W2, F2's develop through cli.main with a
lossless WebP Hald and the committed lossy WebP mask, its JPEG
byte-equal to the same develop from PNGs of the same samples, B1-B4 and
B7 once each and bit-equal to their plain versions on W2's tensors.
Then the simple raster formats (`raster_phase`): R1, 24 MP TGA (raw and
RLE), PSD (raw and PackBits), QOI, PCX and RLE SGI files the phase
writes (`raster_files`), each read_image's host ms and array against
the one written, and the small raster fixtures of tests/data (ICO, CUR,
DCX, PSD, 16-bit SGI, TGA, PCX) against Pillow's sha256; R2, F2's
develop through cli.main with a PackBits PSD Hald and an RLE SGI mask,
its JPEG byte-equal to the same develop from PNGs of the same samples,
B1-B4 and B7 once each and bit-equal to their plain versions on R2's
tensors.
Then the small raster plugins (`plugin_phase`): G1, 24 MP FITS (16-bit
and float32, read as Pillow reads them: big-endian samples as
little-endian), PFM, SPIDER, McIdas, IM RGB;L, RLE SUN and PIXAR files
the phase writes (`plugin_files`), each read_image's host ms, mode and
samples against the array written, and the small plugin fixtures of
tests/data and a Photo CD (`write_pcd`) against Pillow's sha256; G2,
F2's develop through cli.main with an RLE SUN Hald and a PFM mask of
mode F, its JPEG byte-equal to the same develop from a PNG Hald and a
float32 TIFF mask, B1-B4 and B7 once each and bit-equal to their plain
versions on G2's tensors.
Then the texture and icon formats (`texture_phase`): K1, 24 MP DDS
files of A8R8G8B8 and R5G6B5 masks and of DX10 R8G8B8A8 and a BLP2
palette file the phase writes (`texture_files`), each against the array
written; a BC1 and a BC7 DDS and a DXT5 BLP2 tiled from the committed
fixtures' blocks (`tile_texture`), each against the same tiling of the
fixture's decode; the small texture and icon fixtures of tests/data
against Pillow's sha256; K2, F2's develop through cli.main with an
uncompressed DDS Hald and a BLP2 palette mask, its JPEG byte-equal to
the same develop from PNGs of the same samples, B1-B4 and B7 once each
and bit-equal to their plain versions on K2's tensors.
Then JPEG 2000 (`jpeg2000_phase`): Q1, a 24 MP lossless JP2 and a 24 MP
three-layer 9/7 codestream tiled from the committed one-tile fixtures
(`j2k_tiled`), each read_rgb8's host ms against the same tiling of the
fixture's decode and against the sha256 of Pillow's decode of the same
file, and every committed JPEG 2000 fixture against Pillow's sha256;
Q2, F2's develop through cli.main with a committed lossless JP2 Hald
and J2K mask, its JPEG byte-equal to the same develop from PNGs of the
same samples, B1-B4 and B7 once each and bit-equal to their plain
versions on Q2's tensors.
Then TIFF (`tiff_phase`): V1, four 24 MP TIFFs whose strips repeat a
committed single-strip fixture (`tiff_tiled`: an 8-bit RGB under ZSTD
with predictor 2, a 16-bit RGB under LZMA, a Group 4 bilevel, a float
grey under deflate with the floating-point predictor), each read_image's
host ms against the same tiling of the fixture's decode, and every
committed TIFF fixture against Pillow's sha256; V2, F2's develop
through cli.main with a committed 16-bit ZSTD Hald and a Group 4 mask,
its JPEG byte-equal to the same develop from PNGs of the same samples,
B1-B4 and B7 once each and bit-equal to their plain versions on V2's
tensors.
Then the writers (`output_phase`): O1, every format the reference saves
through Pillow written by the port (`art_tpu_torch/io/savers.py`) from a
seeded photo-like 24 MP array, each timed, the lossless ones read back
through the port's decoders equal to the array, the GIF to its own
indices and palette, ICO and ICNS timed with their largest frames equal
to their resamples, and the small O1 fixtures' bytes against Pillow's
sha256; O2, the flagship through cli.main to a PNG, a GIF, a PDF and a
BMP, B1-B4 and B7 once each and bit-equal to their plain versions, each
file byte-equal to the port's writer applied to the PNG's pixels.
Then one JSON line of per-kernel results (time, plain time, bound) and
last the line {"ok": true, "device": {...}}. Any failure raises
(non-zero exit, no result lines); so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# kernel vs plain version, both on the card: the kernels are built
# without FMA contraction and follow the plain versions' operation order
# (the same IEEE division and sqrt, the same libdevice exp), so they agree
# to the last bit; any difference fails
KERNEL_MAX, KERNEL_MEAN = 0.0, 0.0
# slice parity (tests/test_torch_amaze.py, test_torch_develop.py):
# encoded output, card against the CPU plain path
DEV_MAX, DEV_MEAN, DEV_WITHIN = 1.0 / 255.0, 2e-4, 0.999
# config 3 (tests/test_torch_config3.py): the impulse decision compares
# two filtered sums and may flip where the two devices round them
# differently. A flip changes its pixel and the impulses within 2 pixels
# (their replacement weighs it), so DEV_MAX holds outside that reach, and
# at most this share of the pixels flips
IMPULSE_FLIPS = 2e-5
# config 2 (tests/test_torch_raw_config2.py): the hot/dead and green
# equilibration decisions compare sums the two devices may round
# differently; a flipped site moves its value by up to full scale, which
# the CA warp and AMaZE carry up to this many pixels, so DEV_MAX holds
# beyond that reach, and at most RAW_FLIPS of the sites flip
RAW_FLIPS, RAW_REACH = 2e-5, 32
# the bound of each kernel: H100 SXM data sheet peaks (HBM3 rate, FP32 rate)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

FRAME = (4000, 6000)
# config 4's X-Trans frame (tools/bench_configs.py:138)
FRAME4 = (4008, 6000)
# the small develops, card against the CPU: the earlier paths, config 2,
# config 4
SMALL, SMALL2, SMALL4 = (512, 1024), (512, 768), (384, 576)
PROFILE = "Standard Film Curve.arp"


T_START = time.monotonic()


@contextlib.contextmanager
def phase_clock(name):
    """Logs a phase's host seconds and the script's so far."""
    t0 = time.monotonic()
    yield
    t1 = time.monotonic()
    log(f"{name}: {t1 - t0:.1f} s ({t1 - T_START:.1f} s since the start)")


def log(*a):
    print(*a, flush=True)


def flagship_pp(method, pp=None):
    """The flagship's ProcParams with demosaic `method`, on pp (either
    package's; default a fresh one of this package's)."""
    if pp is None:
        from art_tpu_torch.params import ProcParams

        pp = ProcParams()
    arp = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "art_tpu_torch", "data", "profiles", PROFILE)
    with open(arp) as f:
        pp.apply_arp_text(f.read())
    if pp.raw.bayer.method != "amaze":
        raise RuntimeError(f"{PROFILE} plans {pp.raw.bayer.method!r}")
    pp.raw.bayer.method = method
    pp.denoise.enabled = True
    pp.denoise.luminance = 20.0
    pp.denoise.chrominance = 20.0
    return pp


def config3_pp(pp=None, smoothing=True, impulse=True):
    """Config 3 as tools/bench_configs.py writes it, set on pp (either
    package's ProcParams; default a fresh one of this package's, no
    profile), with the Smoothing group on (without it NLMeans never runs)
    unless `smoothing` is False."""
    if pp is None:
        from art_tpu_torch.params import ProcParams

        pp = ProcParams()
    pp.raw.bayer.method = "rcd"
    pp.denoise.enabled = True
    pp.denoise.luminance = 20.0
    pp.denoise.chrominance = 20.0
    pp.denoise.nl_strength = 50
    pp.denoise.smoothing_enabled = smoothing
    pp.impulse_denoise.enabled = impulse
    return pp


def config2_pp(pp=None):
    """Config 2 (BASELINE.json configs[1], tools/bench_configs.py:109-120)
    set on pp (either package's ProcParams; default a fresh one of this
    package's): AMaZE, auto raw CA, hot/dead pixels, green equilibration
    at 100. bench_configs sets HotDeadPixelEnabled but neither filter, so
    there the reference plans no hot/dead step; both filters are on
    here."""
    if pp is None:
        from art_tpu_torch.params import ProcParams

        pp = ProcParams()
    pp.raw.bayer.method = "amaze"
    pp.raw.ca_enabled = True
    pp.raw.ca_autocorrect = True
    pp.raw.hotdead_enabled = True
    pp.raw.hotpixel_filter = True
    pp.raw.deadpixel_filter = True
    pp.raw.bayer.green_eq_enabled = True
    pp.raw.bayer.green_eq = 100.0
    return pp


def write_cube(path, n=33):
    """The near-identity .cube LUT of tools/bench_configs.py's config 4."""
    ax = np.linspace(0, 1, n)
    with open(path, "w") as f:
        f.write(f"LUT_3D_SIZE {n}\n")
        for b in ax:
            for g in ax:
                for r in ax:
                    f.write(f"{r**1.05:.6f} {g:.6f} {b**0.95:.6f}\n")


def config4_pp(cube, pp=None):
    """Config 4 (BASELINE.json configs[3], tools/bench_configs.py:134-164)
    set on pp, with the LUT file `cube`: X-Trans 3-pass, the tone
    equalizer, dehaze, the film simulation, and local contrast with
    Contrast_1=30. bench_configs writes the unsuffixed Contrast=30, which
    plans no region in the reference, so no local-contrast step."""
    if pp is None:
        from art_tpu_torch.params import ProcParams

        pp = ProcParams()
    pp.raw.xtrans.method = "3-pass"
    te = pp.tone_equalizer
    te.enabled = True
    te.band0, te.band1, te.band3, te.band4 = -20, -10, 10, 20
    pp.dehaze.enabled = True
    pp.film_simulation.enabled = True
    pp.film_simulation.clut_filename = cube
    pp.apply_arp_text("[Local Contrast]\nEnabled=true\nContrast_1=30\n")
    return pp


# a user profile that turns on the five pointwise ops: exposure, the
# channel mixer (RGB matrix mode, off-diagonal terms), saturation with
# vibrance, a non-linear red RGB curve and soft light (keys as
# art_tpu/params/procparams.py spells them)
USER_ARP = """[Exposure]
Compensation=0.5

[Channel Mixer]
Enabled=true
Mode=0
Red=1100;-60;-40
Green=-30;1050;-20
Blue=-20;-80;1100

[Saturation]
Enabled=true
Saturation=15
Vibrance=10

[RGB Curves]
Enabled=true
rCurve=1;0;0;0.25;0.2;0.5;0.56;0.75;0.8;1;1;

[SoftLight]
Enabled=true
Strength=30
"""


def config5_pp(pp=None):
    """Config 5's job (tools/bench_configs.py's config 5) set on pp (either
    package's ProcParams; default a fresh one of this package's): AMaZE,
    denoise at luminance 20 with the default (automatic) chrominance."""
    if pp is None:
        from art_tpu_torch.params import ProcParams

        pp = ProcParams()
    pp.raw.bayer.method = "amaze"
    pp.denoise.enabled = True
    pp.denoise.luminance = 20.0
    return pp


def export_arp(h, w):
    """E1, the everyday export, for a (h, w) frame: highlight recovery
    Blend, denoise 20/20 with LuminanceDetail 30, RL capture sharpening,
    a quarter turn, a crop of the middle 3/4 x 3/4 in rotated coordinates
    (3000x4500 at (500, 750) on 4000x6000), a resize to a box of 2048 on
    6000 pixels with USM output sharpening, and Adobe RGB out
    (RT_Medium_gsRGB)."""
    rh, rw = w, h  # rotated
    box = max(32, round(max(rh, rw) * 2048 / 6000))
    return ("[Exposure]\nHLRecovery=Blend\n"
            "[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n"
            "LuminanceDetail=30\n"
            "[Sharpening]\nEnabled=true\nMethod=rld\n"
            "[Coarse Transformation]\nRotate=90\n"
            f"[Crop]\nEnabled=true\nX={rw // 8}\nY={rh // 8}\n"
            f"W={3 * rw // 4}\nH={3 * rh // 4}\n"
            f"[Resize]\nEnabled=true\nDataSpecified=3\nWidth={box}\n"
            f"Height={box}\n"
            "[OutputSharpening]\nEnabled=true\nMethod=usm\n"
            "[Color Management]\nOutputProfile=RT_Medium_gsRGB\n")


def export_pp(h, w, pp=None):
    """E1's ProcParams for a (h, w) frame, on pp (either package's;
    default a fresh one of this package's): the flagship profile with
    AMaZE and `export_arp`."""
    if pp is None:
        from art_tpu_torch.params import ProcParams

        pp = ProcParams()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "art_tpu_torch", "data", "profiles",
                           PROFILE)) as f:
        pp.apply_arp_text(f.read())
    pp.raw.bayer.method = "amaze"
    pp.apply_arp_text(export_arp(h, w))
    return pp


def fast_box_arp(box):
    """A profile whose resize box bounds the fast export (-q) to `box`."""
    return (f"[Resize]\nEnabled=true\nDataSpecified=3\nWidth={box}\n"
            f"Height={box}\n")


def e3_pp(pp=None):
    """E3's ProcParams: config 3 with the Smoothing group on and the DCT
    detail pass (LuminanceDetail 30), on pp (either package's)."""
    pp = config3_pp(pp)
    pp.denoise.luminance_detail = 30.0
    return pp


# L1, a colour grade on the flagship: the keys as
# art_tpu/params/procparams.py spells them and the region tools' suffixed
# keys. Mask curves: a parametric hue mask on the reds and yellows
_HUE_MASK = "1;0.05;1;0.35;0.35;0.2;1;0.35;0.35;0.45;0;0.35;0.35;"
_L1_LOOK = """[HSL Equalizer]
Enabled=true
HCurve=1;0.166666667;0.55;0.35;0.35;0.5;0.45;0.35;0.35;
SCurve=1;0.33;0.7;0.35;0.35;0.83;0.4;0.35;0.35;
LCurve=1;0.0;0.55;0.35;0.35;0.66;0.45;0.35;0.35;
Smoothing=3

[ColorCorrection]
Enabled=true
Mode_1=RGB
SlopeR_1=1.1
SlopeB_1=0.92
OffsetG_1=0.01
PowerR_1=0.95
Mode_2=HSL
SlopeH_2=30
SlopeS_2=40
SlopeL_2=5
OffsetH_2=200
OffsetS_2=20
PowerH_2=90
PowerS_2=10
ParametricMaskEnabled_2=true
HueMask_2={hue}
Mode_3=Jzazbz
Slope_3=1.05
Offset_3=0.002
Power_3=1.1
A_3=0.1
B_3=-0.05
InSaturation_3=10
OutSaturation_3=-5
HueShift_3=8

[Smoothing]
Enabled=true
Mode_1=3
Channel_1=2
Iterations_1=1
NLStrength_1=40
NLDetail_1=50
ParametricMaskEnabled_1=true
HueMask_1={hue}
Mode_2=2
Sigma_2=4
Iterations_2=2
Falloff_2=2
MaskOpacity_2=0.3

[Grain]
Enabled=true
ISO=400
Strength=25

[Defringing]
Enabled=true
Radius=2
Threshold=25

[Gradient]
Enabled=true
Degree=20
Feather=40
Strength=0.8
CenterX=10
CenterY=-20

[PCVignette]
Enabled=true
Strength=0.6
Feather=50
Roundness=30

[Vignetting Correction]
Enabled=true
Amount=-20
Radius=60
Strength=2

[TextureBoost]
Enabled=true
Strength_1=0.6
DetailThreshold_1=1.5
Iterations_1=1

[LogEncoding]
Enabled=true

[Luminance Curve]
Enabled=true
Chromaticity=15
LCurve=1;0;0;0.3;0.25;0.7;0.78;1;1;
"""


def l1_arp(h, w):
    """L1's tools beyond the flagship profile, for a (h, w) frame: two
    spot entries (the second's target overlapping the first's source),
    HSL with all three curves, colour correction in three regions (RGB,
    HSL under a parametric mask, Jzazbz), Smoothing (NLMeans on Y, U and
    V under a parametric mask; a gaussian glow), grain (ISO 400, strength
    25), defringe, the graduated filter, PC vignette and vignetting
    filter, texture boost in one region, log encoding with its automatic
    gain and gray, and Lab adjustments (an L curve and chromaticity)."""
    r = max(3, min(h, w) // 100)
    sx, sy = w * 3 // 10, h * 3 // 10
    spots = (f"[Spot Removal]\nEnabled=true\n"
             f"Spot1={sx};{sy};{w // 2};{h // 2};{r};0.5;1;2\n"
             f"Spot2={w * 7 // 10};{h * 6 // 10};{sx + r};{sy};{r};1;0.8;4\n")
    return spots + _L1_LOOK.format(hue=_HUE_MASK)


def l1_pp(h, w, pp=None):
    """L1's ProcParams for a (h, w) frame, on pp (either package's): the
    flagship profile (AMaZE, denoise 20/20, the Neutral curve) and
    `l1_arp`."""
    pp = flagship_pp("amaze", pp)
    pp.apply_arp_text(l1_arp(h, w))
    return pp


L2_ARP = """[Film Negative]
Enabled=true

[FattalToneMapping]
Enabled=true
Threshold=30
Amount=20

[ToneCurve]
Enabled=true
CurveMode=FilmLike
Curve=1;0;0;0.25;0.18;0.6;0.68;1;1;

[Black & White]
Enabled=true
Setting=RGB-Rel
Filter=Yellow
GammaRed=10
GammaBlue=-10
"""


def l2_pp(pp=None):
    """L2, a scanned colour negative in mono, on pp (either package's;
    default a fresh one of this package's): AMaZE, film negative at its
    automatic input, Fattal (threshold 30, amount 20), a FilmLike curve
    with a user curve, B&W; no denoise."""
    if pp is None:
        from art_tpu_torch.params import ProcParams

        pp = ProcParams()
    pp.raw.bayer.method = "amaze"
    pp.apply_arp_text(L2_ARP)
    return pp


def l2_frame(h, w, seed=0, cell=16, grain=0.02):
    """A colour negative of a scene: the flagship's uniform values of
    seed `seed` on a grid every `cell` pixels, bilinear between them,
    with `grain` of multiplicative gaussian grain, inverted and tinted
    (R x0.9, G x0.6, B x0.4) before mosaicing. (The flagship's
    per-pixel noise as a negative makes Fattal's Poisson solve, the
    reference's as the port's, overflow float32 from about 6 MP.)"""
    from art_tpu_torch.core.image import synthesize_bayer

    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0.02, 0.95, size=(3, h // cell + 2,
                                           w // cell + 2)).astype(np.float32)
    axes = []
    for n, m in ((h, coarse.shape[1]), (w, coarse.shape[2])):
        src = np.clip((np.arange(n) + 0.5) / cell, 0.0, m - 1.0)
        i0 = np.minimum(np.floor(src).astype(np.int64), m - 2)
        axes.append((i0, (src - i0).astype(np.float32)))
    (y0, fy), (x0, fx) = axes
    rows = (coarse[:, y0] * (1 - fy[:, None]) + coarse[:, y0 + 1]
            * fy[:, None])
    rgb = rows[:, :, x0] * (1 - fx) + rows[:, :, x0 + 1] * fx
    rgb *= 1.0 + grain * rng.standard_normal((3, h, w), dtype=np.float32)
    tint = np.array([0.9, 0.6, 0.4], np.float32)[:, None, None]
    return synthesize_bayer(np.clip(1.0 - rgb, 0.0, 1.0) * tint,
                            pattern="RGGB")


# C1's lens (lens/lcp.py): an Adobe LCP profile of a 35 mm prime with a
# rectilinear distortion, a vignette and three CA models, and a 50 mm
# frame to interpolate towards
C1_LCP = """<?xml version="1.0" encoding="UTF-8"?>
<x:xmpmeta xmlns:x="adobe:ns:meta/">
 <rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#">
  <rdf:Description xmlns:stCamera="http://ns.adobe.com/photoshop/1.0/camera-profile">
   <stCamera:CameraProfiles><rdf:Seq>{frames}</rdf:Seq></stCamera:CameraProfiles>
  </rdf:Description>
 </rdf:RDF>
</x:xmpmeta>
"""
_LCP_FRAME = """
    <rdf:li><rdf:Description stCamera:Make="FUJIFILM" stCamera:Model="GFX 100"
      stCamera:FocalLength="{f}" stCamera:ApertureValue="2.8">
     <stCamera:PerspectiveModel><rdf:Description
       stCamera:FocalLengthX="{fl}" stCamera:FocalLengthY="{fl}"
       stCamera:ImageXCenter="0.502" stCamera:ImageYCenter="0.497"
       stCamera:RadialDistortParam1="{k1}" stCamera:RadialDistortParam2="0.01"
       stCamera:TangentialDistortParam1="0.0004"
       stCamera:TangentialDistortParam2="-0.0003"/></stCamera:PerspectiveModel>
     <stCamera:VignetteModel><rdf:Description
       stCamera:FocalLengthX="{fl}" stCamera:FocalLengthY="{fl}"
       stCamera:VignetteModelParam1="-0.35" stCamera:VignetteModelParam2="0.08"
       stCamera:VignetteModelParam3="-0.01"/></stCamera:VignetteModel>
     <stCamera:ChromaticRedGreenModel><rdf:Description
       stCamera:FocalLengthX="{fl}" stCamera:FocalLengthY="{fl}"
       stCamera:ScaleFactor="1.0008"
       stCamera:RadialDistortParam1="0.002"/></stCamera:ChromaticRedGreenModel>
     <stCamera:ChromaticGreenModel><rdf:Description
       stCamera:FocalLengthX="{fl}" stCamera:FocalLengthY="{fl}"
       stCamera:RadialDistortParam1="{k1}"
       stCamera:RadialDistortParam2="0.01"/></stCamera:ChromaticGreenModel>
     <stCamera:ChromaticBlueGreenModel><rdf:Description
       stCamera:FocalLengthX="{fl}" stCamera:FocalLengthY="{fl}"
       stCamera:ScaleFactor="0.9993"
       stCamera:RadialDistortParam1="-0.002"/></stCamera:ChromaticBlueGreenModel>
    </rdf:Description></rdf:li>"""

# C2's lensfun database (lens/lensfun.py): a camera and a lens with a
# ptlens distortion, a poly3 TCA and pa vignetting at two apertures
LENSFUN_XML = """<lensdatabase>
 <camera>
  <maker>ART-TPU</maker>
  <model>Synthetic</model>
  <mount>Synthetic mount</mount>
  <cropfactor>1.0</cropfactor>
 </camera>
 <lens>
  <maker>ART-TPU</maker>
  <model>ART-TPU 50mm f/1.8</model>
  <mount>Synthetic mount</mount>
  <cropfactor>1.0</cropfactor>
  <calibration>
   <distortion model="ptlens" focal="50" a="0.01" b="-0.03" c="0.005"/>
   <tca model="poly3" focal="50" kr="1.0004" vr="-0.0002" kb="0.9996" vb="0.0002"/>
   <vignetting model="pa" focal="50" aperture="1.8" distance="1000" k1="-0.6" k2="0.2" k3="-0.05"/>
   <vignetting model="pa" focal="50" aperture="5.6" distance="1000" k1="-0.1" k2="0.0" k3="0.0"/>
  </calibration>
 </lens>
</lensdatabase>
"""
# the camconst entry C1's frame takes its name from: its PDAF rows are
# 0 and 18 of every 18 (pdaf_pattern, pdaf_offset 0)
C1_CAMERA = ("FUJIFILM", "GFX 100")


def falloff(h, w, amount=0.4):
    """A lens's radial falloff over a (h, w) frame: 1 at the centre,
    1 - amount in the corners."""
    yy = (np.arange(h, dtype=np.float32) - h / 2)[:, None] / (h / 2)
    xx = (np.arange(w, dtype=np.float32) - w / 2)[None, :] / (w / 2)
    return 1.0 - amount * 0.5 * (yy * yy + xx * xx)


def c1_frame(h, w, seed=0):
    """C1's scene: the flagship frame of seed `seed` under the lens's
    falloff, plus the sensor's dark pattern (`c1_dark`), its PDAF rows'
    values 3% low, named as a FUJIFILM GFX 100 (whose camconst entry
    has a PDAF row pattern) shot at 35 mm and f/2.8."""
    import dataclasses

    frame = flagship_frame(h, w, seed)
    black = frame.black[0]
    cfa = black + (frame.cfa - black) * falloff(h, w)
    pdaf = (np.arange(h) % 18) == 0
    cfa[pdaf] = black + (cfa[pdaf] - black) * 0.97
    cfa = np.clip(cfa + (c1_dark(h, w, seed) - black), 0.0, frame.white[0])
    return dataclasses.replace(
        frame, cfa=cfa.astype(np.float32), make=C1_CAMERA[0],
        model=C1_CAMERA[1], exif={"focal_length": 35.0, "f_number": 2.8})


def c1_dark(h, w, seed=0):
    """The sensor's dark frame: the black level 512 plus fixed-pattern
    noise (0-40 ADU) and four hot columns (+600)."""
    rng = np.random.default_rng(seed + 100)
    dark = 512.0 + rng.uniform(0.0, 40.0, (h, w)).astype(np.float32)
    dark[:, rng.choice(w, 4, replace=False)] += 600.0
    return dark


def c1_files(directory, frame, seed=0):
    """Write C1's calibration for `frame` into `directory`: a dark-frame
    and a flat-field DNG of its shape (the flat: a grey at 8000 ADU under
    the falloff, with noise), the LCP profile, and a .badpixels file for
    its camera in `directory`/darkframes (12 sites). Returns their
    paths: "df", "ff", "lcp", "badpixels_dir"."""
    from art_tpu_torch.io.dngwrite import write_dng

    h, w = frame.cfa.shape
    rng = np.random.default_rng(seed + 200)
    os.makedirs(directory, exist_ok=True)
    files = {"df": os.path.join(directory, "dark.dng"),
             "ff": os.path.join(directory, "flat.dng"),
             "lcp": os.path.join(directory, "lens.lcp"),
             "badpixels_dir": os.path.join(directory, "darkframes")}
    write_dng(files["df"], np.round(c1_dark(h, w, seed)).astype(np.uint16),
              black=512, white=16383, compress=False)
    flat = 512.0 + 8000.0 * falloff(h, w) * (
        1.0 + 0.01 * rng.standard_normal((h, w), dtype=np.float32))
    write_dng(files["ff"], np.round(flat).astype(np.uint16), black=512,
              white=16383, compress=False)
    with open(files["lcp"], "w") as f:
        f.write(C1_LCP.format(frames="".join(
            _LCP_FRAME.format(f=f_mm, fl=fl, k1=k1) for f_mm, fl, k1 in (
                (35, 0.72, -0.05), (50, 1.03, -0.02)))))
    os.makedirs(files["badpixels_dir"], exist_ok=True)
    pts = [(int(rng.integers(w)), int(rng.integers(h))) for _ in range(12)]
    with open(os.path.join(files["badpixels_dir"],
                           f"{C1_CAMERA[0]} {C1_CAMERA[1]}.badpixels"),
              "w") as f:
        f.write("".join(f"{x} {y}\n" for x, y in pts))
    return files


def c1_arp(files):
    """C1's tools beyond the flagship profile: the dark frame, the flat
    field (area blur, radius 32), CFA line denoise 30 in both
    directions, the PDAF line filter, the LCP profile's distortion, CA
    and vignette, a rotation by 1.5 degrees, perspective 8 / -5 and
    auto-fill."""
    return (f"[RAW]\nDarkFrameEnabled=true\nDarkFrame={files['df']}\n"
            f"FlatFieldEnabled=true\nFlatFieldFile={files['ff']}\n"
            "FlatFieldBlurType=Area Flatfield\nFlatFieldBlurRadius=32\n"
            "[RAW Bayer]\nPreprocessingEnabled=true\nLineDenoise=30\n"
            "LineDenoiseDirection=3\nPDAFLinesFilter=true\n"
            f"[LensProfile]\nLcMode=lcp\nLCPFile={files['lcp']}\n"
            "UseDistortion=true\nUseVignette=true\nUseCA=true\n"
            "[Rotation]\nEnabled=true\nDegree=1.5\n"
            "[Perspective]\nEnabled=true\nHorizontal=8\nVertical=-5\n"
            "[Common Properties for Transformations]\nAutoFill=true\n")


def c1_pp(files, pp=None):
    """C1's ProcParams on pp (either package's): the flagship profile
    (AMaZE, denoise 20/20, the Neutral curve) and `c1_arp`."""
    pp = flagship_pp("amaze", pp)
    pp.apply_arp_text(c1_arp(files))
    return pp


@contextlib.contextmanager
def badpixels_dir(path):
    """The .badpixels lookup (`raw/badpixfile.py`) reads `path` inside
    the block."""
    old = os.environ.get("ART_TPU_DARKFRAMES")
    os.environ["ART_TPU_DARKFRAMES"] = path
    try:
        yield
    finally:
        if old is None:
            del os.environ["ART_TPU_DARKFRAMES"]
        else:
            os.environ["ART_TPU_DARKFRAMES"] = old


def gain_maps(h, w, n=9, amount=0.4):
    """Four per-site DNG gain maps on an n x n grid that undo
    `falloff(h, w, amount)`, each site's 1% apart."""
    g = 1.0 / falloff(n, n, amount)
    return [{"gains": (g * (1.0 + 0.01 * k)).astype(np.float32), "top": t,
             "left": lft, "bottom": h, "right": w}
            for k, (t, lft) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1)))]


def c2_dng(path, h, w, seed=0):
    """C2's raw file: the flagship frame of seed `seed` under the falloff,
    as an uncompressed DNG with the four gain maps that undo it."""
    from art_tpu_torch.io.dngwrite import write_dng

    frame = flagship_frame(h, w, seed)
    cfa = 512.0 + (frame.cfa - 512.0) * falloff(h, w)
    write_dng(path, np.round(cfa).astype(np.uint16), black=512, white=16383,
              cam_mul=(2.0, 1.0, 1.5), compress=False,
              gain_maps=gain_maps(h, w))


def c2_arp():
    """C2's tools beyond the flagship profile: the embedded gain map, the
    lensfun database's corrections for its lens (chosen by hand), a
    distortion of 0.05 and CA red 0.002, blue -0.002."""
    return ("[RAW]\nFlatFieldEnabled=true\nFlatFieldUseEmbedded=true\n"
            "[LensProfile]\nLcMode=lfmanual\nLFCameraMake=ART-TPU\n"
            "LFCameraModel=Synthetic\nLFLens=ART-TPU 50mm f/1.8\n"
            "UseDistortion=true\nUseVignette=true\nUseCA=true\n"
            "[Distortion]\nEnabled=true\nAmount=0.05\n"
            "[CACorrection]\nEnabled=true\nRed=0.002\nBlue=-0.002\n")


def lensfun_db(directory):
    """Write C2's lensfun database into `directory`; returns it."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "synthetic.xml"), "w") as f:
        f.write(LENSFUN_XML)
    return directory


def path_pp(label):
    """The ProcParams of a path: "amaze", "bilinear" or "config3"."""
    return config3_pp() if label == "config3" else flagship_pp(label)


def flagship_scene(h, w, seed=0):
    """The flagship's scene: (3, h, w) float32 uniform in [0.02, 0.95]."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.02, 0.95, size=(3, h, w)).astype(np.float32)


def flagship_frame(h, w, seed=0):
    from art_tpu_torch.core.image import synthesize_bayer

    return synthesize_bayer(flagship_scene(h, w, seed), pattern="RGGB")


def clipped_frame(h, w, seed=0, share=0.02, gain=2.2):
    """The flagship frame of seed `seed` with blown highlights: blocks of
    16x16 pixels, `share` of them, brightened by `gain` before mosaicing,
    so that the brighter sites of each block clip at white (about half a
    block's green sites, fewer of its red and blue)."""
    from art_tpu_torch.core.image import synthesize_bayer

    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0.02, 0.95, size=(3, h, w)).astype(np.float32)
    blocks = rng.random((-(-h // 16), -(-w // 16))) < share
    mask = np.repeat(np.repeat(blocks, 16, 0), 16, 1)[:h, :w]
    rgb[:, mask] *= gain
    return synthesize_bayer(rgb, pattern="RGGB")


def scale_about_centre(plane, s):
    """A (H, W) plane magnified by s about its centre, bilinear, edges
    clamped: out(p) = plane(c + (p - c) / s)."""
    h, w = plane.shape
    out = []
    for n in (h, w):
        c = (n - 1) / 2.0
        src = np.clip(c + (np.arange(n) - c) / s, 0.0, n - 1.0)
        i0 = np.minimum(np.floor(src).astype(np.int64), n - 2)
        out.append((i0, (src - i0).astype(np.float32)))
    (y0, fy), (x0, fx) = out
    top = plane[y0][:, x0] * (1 - fx) + plane[y0][:, x0 + 1] * fx
    bot = plane[y0 + 1][:, x0] * (1 - fx) + plane[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy[:, None]) + bot * fy[:, None]


def with_raw_faults(rgb, seed=0, ca=2e-3, share=1e-3):
    """A Bayer RawFrame of a linear (3, H, W) image with config 2's raw
    faults: R magnified by 1 + ca and B by 1 - ca about the centre before
    mosaicing (lateral CA), then `share` of the sites set to 0 or to
    white, half each (dead and hot pixels)."""
    from art_tpu_torch.core.image import synthesize_bayer

    rgb = np.stack([scale_about_centre(rgb[0], 1.0 + ca), rgb[1],
                    scale_about_centre(rgb[2], 1.0 - ca)])
    frame = synthesize_bayer(rgb.astype(np.float32), pattern="RGGB")
    cfa = frame.cfa.reshape(-1)
    idx = np.random.default_rng(seed).choice(cfa.size, int(cfa.size * share),
                                             replace=False)
    cfa[idx[::2]] = 0.0
    cfa[idx[1::2]] = frame.white[0]
    return frame


def config2_frame(h, w, seed=0):
    """The flagship frame of seed `seed` with config 2's raw faults."""
    rng = np.random.default_rng(seed)
    return with_raw_faults(
        rng.uniform(0.02, 0.95, size=(3, h, w)).astype(np.float32), seed)


def config4_frame(h, w, seed=2):
    """Config 4's X-Trans frame as tools/bench_configs.py makes it."""
    from art_tpu_torch.core.image import synthesize_xtrans

    rng = np.random.default_rng(seed)
    return synthesize_xtrans(
        rng.uniform(0.02, 0.95, size=(3, h, w)).astype(np.float32))


def gpu_ms(fn, n):
    """Mean ms per call over n calls after one warm call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def diff_stats(a, b):
    d = (a.double() - b.double()).abs()
    return float(d.max()), float(d.mean())


def _cpu64(a):
    if not isinstance(a, torch.Tensor):
        return torch.from_numpy(np.array(a, np.float64))
    return a.detach().cpu().double()


def parity(out, ref):
    """Encoded outputs (tensors or arrays) against each other in 8-bit
    steps; the 99.9th percentile from every 7th value."""
    d = (_cpu64(out) - _cpu64(ref)).abs()
    lsb = d * 255.0
    return {"max_lsb8": float(lsb.max()), "mean": float(d.mean()),
            "p999_lsb8": float(torch.quantile(lsb.flatten()[::7], 0.999)),
            "within_1lsb8": float((lsb <= 1.0).double().mean()),
            "beyond_1lsb8": int((lsb > 1.0).sum())}


@contextlib.contextmanager
def impulse_masks():
    """Yields a list that gathers, on the CPU, the mask of every impulse
    detection (`ops.impulse.detect`) run inside the block."""
    from art_tpu_torch.ops import impulse

    masks, detect = [], impulse.detect

    def recorded(*args):
        imp = detect(*args)
        masks.append(imp.cpu())
        return imp

    impulse.detect = recorded
    try:
        yield masks
    finally:
        impulse.detect = detect


def impulse_parity(out, ref, imp_out, imp_ref):
    """parity() of two develops with an impulse step, given their impulse
    masks (on the padded plane): the share of pixels whose decision
    differs, and the max outside those pixels' reach."""
    return flip_parity(out, ref, imp_out, imp_ref, 2)


def flip_parity(out, ref, dec_out, dec_ref, reach):
    """parity() of two develops given the decision masks each made (on
    the padded plane): the share of sites whose decision differs, and
    the max outside `reach` pixels of them."""
    st = parity(out, ref)
    flips = _cpu64(dec_out) != _cpu64(dec_ref)
    h, w = out.shape[-2:]
    near = torch.nn.functional.max_pool2d(
        flips[None, None].double(), 2 * reach + 1, 1,
        reach)[0, 0, :h, :w] > 0
    d = (_cpu64(out) - _cpu64(ref)).abs() * 255.0
    st["flips"] = int(flips.sum())
    st["flip_share"] = st["flips"] / flips.numel()
    st["max_lsb8_beyond_flips"] = float(d[:, ~near].max()) if (
        ~near).any() else 0.0
    return st


@contextlib.contextmanager
def raw_decisions():
    """Yields a dict that gathers, on the CPU, the raw decisions of the
    develops run inside the block, one (H, W) bool plane a develop each:
    "hotdead", the hot/dead masks (`raw.badpixels.find_hot_dead`), and
    "green_eq", the green sites that green equilibration replaced
    (`raw.green_eq.green_equilibrate`; its output differs from its input
    there)."""
    from art_tpu_torch.raw import badpixels, green_eq

    got = {"hotdead": [], "green_eq": []}
    find, equil = badpixels.find_hot_dead, green_eq.green_equilibrate

    def find_recorded(*args, **kwargs):
        bad = find(*args, **kwargs)
        got["hotdead"].append(bad.cpu())
        return bad

    def equil_recorded(cfa, *args, **kwargs):
        out = equil(cfa, *args, **kwargs)
        got["green_eq"].append((out != cfa).cpu())
        return out

    badpixels.find_hot_dead = find_recorded
    green_eq.green_equilibrate = equil_recorded
    try:
        yield got
    finally:
        badpixels.find_hot_dead = find
        green_eq.green_equilibrate = equil


def bound(reads, writes, ops):
    """(bound_ms, bound_by, bytes_ms, ops_ms, ops, naive_ops): each input
    read once and each output written once at the memory rate, against
    the operations the result needs (`opcount.needed_ops`: the taken arm
    of each select, repeats once) at the f32 rate. naive_ops (every
    float op of the plain version, both arms) is printed beside it."""
    ops, naive = ops
    nbytes = sum(t.numel() * t.element_size() for t in (*reads, *writes))
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", t_bytes, t_ops,
            ops, naive)


def counted():
    """name -> (wrapper with .launches, plain version with .calls)."""
    from art_tpu_torch.demosaic import amaze
    from art_tpu_torch.demosaic import amaze_kernel as ak
    from art_tpu_torch.ops import nlmeans_kernel as nk
    from art_tpu_torch.ops import tonecurve_neutral as tn
    from art_tpu_torch.ops import wavelet_kernel as wk

    return {"b1": (ak.amaze_stage1, amaze.stage1_plain),
            "b2": (ak.amaze_stage2, amaze.stage2_plain),
            "b3": (ak.amaze_stage3, amaze.stage3_plain),
            "b4": (wk.wavelet_denoise_rgb, wk.wavelet_rgb_plain),
            "b5": (wk.wavelet_denoise_multi, wk.wavelet_multi_plain),
            "b6": (nk.nlmeans, nk.nlmeans_plain),
            "b7": (tn.neutral_tone, tn.neutral_plain)}


def reset_counts():
    for wrapper, plain in counted().values():
        wrapper.launches = 0
        plain.calls = 0


def read_counts():
    c = counted()
    return ({k: w.launches for k, (w, _) in c.items()},
            {k: p.calls for k, (_, p) in c.items()})


def drive(label, pp, frame, kernels_of_path, shape=None, fast=False):
    """One develop through the user's entry points, counts from 0; checks
    the launches, the plain calls and the output, of `shape` (H, W)
    (default the frame's)."""
    from art_tpu_torch.pipeline import develop as tdev

    reset_counts()
    t0 = time.monotonic()
    out = tdev.develop(frame, pp, fast=fast)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches, plain_calls = read_counts()
    fh, fw = frame.cfa.shape[-2:]
    shape = shape or (fh, fw)
    log(f"{label} develop {fh}x{fw} (first): {seconds:.3f} s; "
        f"launches {launches}; plain calls {plain_calls}")
    missing = [k for k in kernels_of_path if launches[k] < 1]
    if missing:
        raise RuntimeError(f"{label}: kernels {missing} did not launch")
    if any(plain_calls.values()):
        raise RuntimeError(f"{label}: a plain version ran on the card: "
                           f"{plain_calls}")
    if tuple(out.shape) != (3, *shape) or out.device.type != "cuda":
        raise RuntimeError(f"bad output {tuple(out.shape)} on {out.device}")
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{label}: non-finite output")
    lo, hi = float(out.min()), float(out.max())
    if lo < 0.0 or hi > 1.0:
        raise RuntimeError(f"{label}: output outside [0, 1]: {lo} .. {hi}")
    log(f"  output (3, {shape[0]}, {shape[1]}) finite, range {lo:.6f} .. "
        f"{hi:.6f}, mean {float(out.mean()):.6f}")
    return launches


def new_path(label, pp, frame, kernels_of_path, small_frame, small_pp=None,
             shape=None, fast=False):
    """A path of configs 2 and 4, the export and the look: one develop
    with the counts from 0, which must launch each kernel of the path
    once (or as often as a dict kernels_of_path says) and no other, and
    print the bad pixels flagged and the green sites
    equilibrated; the median develop, the host plan and the device
    program alone with peak memory by stage, device ms by stage; then a
    develop of small_frame (with small_pp, default pp) on the card
    against the same on the CPU (flip_parity where the path makes raw
    decisions). shape: the output's (H, W), default the frame's; fast:
    the fast export. Returns that comparison."""
    from art_tpu_torch.pipeline import develop as tdev

    small_pp = pp if small_pp is None else small_pp
    with raw_decisions() as dec:
        launches = drive(label, pp, frame, kernels_of_path, shape, fast)
    if isinstance(kernels_of_path, dict):
        want = {k: kernels_of_path.get(k, 0) for k in launches}
    else:
        want = {k: int(k in kernels_of_path) for k in launches}
    if launches != want:
        raise RuntimeError(f"{label}: launches {launches}, want {want}")
    if dec["hotdead"]:
        log(f"  hot/dead pixels flagged: {int(dec['hotdead'][0].sum())} of "
            f"{dec['hotdead'][0].numel()} sites of the padded plane; green "
            f"sites equilibrated: {int(dec['green_eq'][0].sum())}")
    median_develop(label, frame, pp, fast)
    device_program(frame, pp, fast)
    profile_develop(frame, pp, fast)

    with raw_decisions() as dec, impulse_masks() as imp:
        g = tdev.develop(small_frame, small_pp, fast=fast).cpu()
        c = tdev.develop(small_frame, small_pp, device="cpu", fast=fast)
    if dec["hotdead"]:
        planes = [hd | ge for hd, ge in zip(dec["hotdead"], dec["green_eq"])]
        st = flip_parity(g, c, *planes, RAW_REACH)
    elif imp:
        st = impulse_parity(g, c, *imp)
    else:
        st = parity(g, c)
    h, w = small_frame.cfa.shape
    log(f"{h}x{w} {label} develop, card vs CPU plain path: {st}")
    return st


def median_develop(label, frame, pp, fast=False):
    from art_tpu_torch.pipeline import develop as tdev

    times = []
    for _ in range(2):
        t0 = time.monotonic()
        tdev.develop(frame, pp, fast=fast)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    log(f"{label} develop (plan + H2D + device + crop), median of 2: "
        f"{1e3 * float(np.median(times)):.1f} ms "
        f"{[round(1e3 * t, 1) for t in times]}")


def peak_by_stage(run):
    """Run `run` once and attribute its peak device memory: the peak so far
    after each pipeline stage (an `art:` span of develop.py) and at each
    kernel launch (its launch check, its output and scratch allocated).
    The allocator counts on the host, in program order, so no
    synchronisation is needed between the marks. Returns (peak, the
    first stage and the first launch at which the peak was reached)."""
    from art_tpu_torch import kernels
    from art_tpu_torch.pipeline import develop as tdev

    stages, launches = [], []
    check, span = kernels.check, tdev.span

    def check_at(rc, name):
        launches.append((name, torch.cuda.max_memory_allocated()))
        return check(rc, name)

    @contextlib.contextmanager
    def span_at(name):
        with span(name):
            yield
        stages.append((name, torch.cuda.max_memory_allocated()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.check, tdev.span = check_at, span_at
    try:
        run()
    finally:
        kernels.check, tdev.span = check, span
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    def first(marks):
        return next((name for name, m in marks if m == peak), "after all")

    log("  peak device memory so far, after each stage: " + ", ".join(
        f"{k} {m / 1e9:.3f}" for k, m in stages) + " GB; at each launch: "
        + ", ".join(f"{k} {m / 1e9:.3f}" for k, m in launches) + " GB")
    log(f"  peak {peak / 1e9:.3f} GB, set in stage {first(stages)}, at "
        f"the launch of {first(launches)}")
    return peak, first(stages), first(launches)


def device_program(frame, pp, fast=False, n=5):
    """Time the host plan alone, then the device program alone with its
    inputs resident (uploaded as develop uploads them; CUDA events, mean
    of n after a warm call), its peak memory and the stage that sets it.
    Returns the config, the device inputs and those numbers."""
    from art_tpu_torch.pipeline import develop as tdev

    t0 = time.monotonic()
    config, data = tdev.plan(frame, pp, fast=fast)
    plan_ms = 1e3 * (time.monotonic() - t0)
    log(f"  host plan alone: {plan_ms:.1f} ms")
    inp_d = tdev.upload(frame, "cuda")
    data_d = tdev.data_to_torch(data, "cuda")
    run = tdev.build_run(config)
    device_ms = gpu_ms(lambda: run(inp_d, data_d), n)
    peak, at, _ = peak_by_stage(lambda: run(inp_d, data_d))
    log(f"  device program alone (inputs resident), mean of {n}: "
        f"{device_ms:.2f} ms; peak device memory {peak / 1e9:.2f} GB")
    return config, inp_d, data_d, {
        "plan_ms": plan_ms, "device_ms": device_ms, "peak_gb": peak / 1e9,
        "peak_stage": at}


def profile_develop(frame, pp, fast=False):
    """Device busy time of one end-to-end develop, from torch.profiler,
    and its top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from art_tpu_torch.pipeline import develop as tdev

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        tdev.develop(frame, pp, fast=fast)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    avg = prof.key_averages()
    # device-side events only: a CPU op's entry repeats its kernels' time;
    # the pipeline's "art:" ranges (art_tpu_torch.core.profile.span) also
    # show on the device timeline, as annotations over their kernels, and
    # are not device work
    busy_us = sum(e.self_device_time_total for e in avg
                  if e.device_type != DeviceType.CPU
                  and not e.key.startswith("art:"))
    log(avg.table(sort_by="self_device_time_total", row_limit=20))
    log(f"profiled develop: wall {wall_ms:.1f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms, idle share "
        f"{1.0 - busy_us / 1e3 / wall_ms:.4f}")
    # per stage: the span of each range on the device timeline (its
    # host-side entry counts only the kernels of aten ops, not those the
    # ctypes wrappers launch)
    stages = sorted(((e.key, e.device_time_total) for e in avg
                     if e.key.startswith("art:")
                     and e.device_type != DeviceType.CPU),
                    key=lambda kv: -kv[1])
    log("  device ms by stage: " + ", ".join(
        f"{k[4:]} {us / 1e3:.2f}" for k, us in stages))


def kernel_breakdown(label, fn, parts, expect=None):
    """Device time of one call of fn by kernel name (torch.profiler), and
    the share of each part: name -> kernel-name prefixes. Returns the
    launches of each kernel. The traced call follows an untraced warm-up
    step of the profiler; a trace that lacks device events (or whose
    launches `expect` refuses: on the card a trace now and then loses
    its first kernels) is taken again, five times at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        # the step's own range spans its kernels on the device timeline
        rows = [(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type != DeviceType.CPU
                and e.self_device_time_total > 0
                and not e.key.startswith("ProfilerStep")]
        total = sum(us for _, _, us in rows)
        if total > 0 and (expect is None
                          or expect({k: n for k, n, _ in rows})):
            break
    if total == 0:
        raise RuntimeError(f"{label}: five traces without device time")
    log(f"{label} by kernel (one call, device {total / 1e3:.3f} ms):")
    for key, n, us in sorted(rows, key=lambda r: -r[2]):
        log(f"  {us / 1e3:8.3f} ms  x{n}  {key[:100]}")
    for part, prefixes in parts.items():
        us = sum(u for k, _, u in rows
                 if any(p in k for p in prefixes))
        log(f"  {part}: {us / 1e3:.3f} ms, {us / total:.3f} of the call")
    return {k: n for k, n, _ in rows}


WAVELET_PARTS = {"sigma passes (memsets, win_max, win_hist, select)":
                 ("Memset", "win_max_kernel", "win_hist_kernel",
                  "select_kernel"),
                 "level kernels": ("level_kernel",),
                 "head, pad and tail": ("head_kernel", "pad_kernel",
                                        "tail_kernel")}


# the sigma is a fixed number of kernels per call (one each of win_max,
# win_hist and select), and the levels one kernel each
WAVELET_LAUNCHES = {"win_max_kernel": 1, "win_hist_kernel": 1,
                    "select_kernel": 1, "level_kernel": 5}


def wavelet_launches(counts):
    return {p: sum(c for k, c in counts.items() if p in k)
            for p in WAVELET_LAUNCHES}


def wavelet_complete(counts):
    return wavelet_launches(counts) == WAVELET_LAUNCHES


def check_wavelet_launches(label, counts):
    got = wavelet_launches(counts)
    if got != WAVELET_LAUNCHES:
        raise RuntimeError(f"{label}: unexpected kernel launches {got}")


def one_launch_ms(label, fn, kernel):
    """Device time a call of fn, a wrapper that launches the one kernel
    named: CUDA events over 10 calls back to back (the queue then hides
    the wrapper's host time, which one call alone would count)."""
    ms = gpu_ms(fn, 10)
    log(f"{label} by kernel (a call, mean of 10 back to back): {ms:.3f} "
        f"ms, its one launch of {kernel} (CUDA events)")


def allocation(label, fn, out):
    """The bytes one call of fn allocates on the card, beside the bytes of
    its output `out`."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    log(f"{label} allocates "
        f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB a call "
        f"(its output: {out.numel() * out.element_size() / 1e9:.3f} GB)")


def b6_case(label, y, maskinv):
    """B6 against its plain version on one plane: (equal, kernel ms)."""
    from art_tpu_torch.ops import nlmeans_kernel as nk

    k = nk.nlmeans(y, maskinv)
    p = nk.nlmeans_plain(y, maskinv)
    torch.cuda.synchronize()
    equal = torch.equal(k, p)
    ms = gpu_ms(lambda: nk.nlmeans(y, maskinv), 5)
    log(f"B6 on {label}: kernel equals plain {equal}, kernel {ms:.3f} ms")
    return equal


def b6_entry(name, key, launches, y, maskinv):
    """B6 against its plain version on one plane, as a kernels-line
    entry. The plain version (each offset pair sharing its patch box) has
    no select and no repeat, so its operation count is linear in the
    rows: counted on a 1024-row slice of these inputs and scaled per row
    (the slice's edge rows add under 1%)."""
    from art_tpu_torch.opcount import needed_ops
    from art_tpu_torch.ops import nlmeans_kernel as nk

    k_out = nk.nlmeans(y, maskinv)
    p_out = nk.nlmeans_plain(y, maskinv)
    rows = min(1024, y.shape[0])
    _, ops6, naive6 = needed_ops(lambda: nk.nlmeans_plain(
        y[:rows].contiguous(), maskinv[:rows].contiguous()))
    scale = y.shape[0] / rows
    torch.cuda.synchronize()
    return kernel_entry(
        name, key, "art_tpu_torch/csrc/nlmeans.cu",
        "art_tpu/ops/nlmeans_pallas.py:83", {key: launches["b6"]}, k_out,
        p_out, gpu_ms(lambda: nk.nlmeans(y, maskinv), 10),
        gpu_ms(lambda: nk.nlmeans_plain(y, maskinv), 3),
        bound((y, maskinv), (k_out,), (ops6 * scale, naive6 * scale)),
        note=f"; counted on {rows} of {y.shape[0]} rows, scaled")


def clamp_share(y, maskinv):
    """The share of pixels whose weight for the offset (0, 1) is clamped
    at 50 (box * maskinv > 50), from a 5x5 mean of the squared
    differences."""
    d2 = (y[:, 1:] - y[:, :-1]) ** 2
    box = torch.nn.functional.avg_pool2d(d2[None, None], 5, 1, 2)[0, 0] * 25
    return float((box * maskinv[:, :-1] > 50).float().mean())


def kernel_entry(name, key, source, replaces, launches, k_out, p_out,
                 ms, plain_ms, bnd, note=""):
    err, mean = diff_stats(k_out, p_out)
    log(f"{name}: kernel vs plain at {tuple(k_out.shape)}: max {err:.6g} "
        f"mean {mean:.6g} (bounds {KERNEL_MAX}, {KERNEL_MEAN}); kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms "
        f"({bnd[1]}; bytes {bnd[2]:.4f} ms, {bnd[4]:.4g} operations "
        f"{bnd[3]:.4f} ms; naive count {bnd[5]:.4g}{note})")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1],
            # no single PyTorch call computes any of these functions
            "library_ms": None, "_mean_err": mean}


# the phases process_image times with settings.verbose, in order
CLI_PHASES = ("decode", "plan", "H2D", "device program", "D2H", "metadata",
              "encode+write")


def cli_run(argv):
    """One `art_tpu_torch.cli.main` on the card with settings.verbose on:
    ({phase: ms}, seconds end to end); raises unless it exits 0."""
    from art_tpu_torch import cli
    from art_tpu_torch.settings import settings

    buf = io.StringIO()
    settings.verbose = True
    try:
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        seconds = time.monotonic() - t0
    finally:
        settings.verbose = False
    if rc != 0:
        raise RuntimeError(f"cli.main {argv} exited {rc}: "
                           f"{buf.getvalue()[-2000:]}")
    phases = {}
    for line in buf.getvalue().splitlines():
        m = re.match(r"\[art-tpu\] (.+): ([0-9.]+) ms$", line)
        if m:
            phases[m.group(1)] = float(m.group(2))
    return phases, seconds


def cli_timed(label, argv, runs=2):
    """cli_run once warm, then `runs` times: logs each phase's median."""
    cli_run(argv)
    got = [cli_run(argv) for _ in range(runs)]
    med = {k: float(np.median([g[0][k] for g in got])) for k in CLI_PHASES}
    total = float(np.median([g[1] for g in got]))
    log(f"{label} through cli.main, median of {runs} after one warm run: "
        f"end to end {1e3 * total:.1f} ms; " + ", ".join(
            f"{k} {v:.1f}" for k, v in med.items()) + " ms")
    return med


def check_jpeg(path, quiet=False):
    """The file's markers are well formed: SOI, DQT, SOF0, DHT and SOS in
    that order (APPn where they may be), a scan whose every 0xFF byte is
    stuffed, and EOI. Returns the file from its SOS marker to EOI (the
    scan with its header)."""
    data = open(path, "rb").read()
    if data[:2] != b"\xff\xd8" or data[-2:] != b"\xff\xd9":
        raise RuntimeError(f"{path}: no SOI/EOI")
    pos, markers = 2, []
    while True:
        if data[pos] != 0xFF:
            raise RuntimeError(f"{path}: no marker at byte {pos}")
        markers.append(data[pos + 1])
        sos = pos
        pos += 2 + int.from_bytes(data[pos + 2: pos + 4], "big")
        if markers[-1] == 0xDA:
            break
    body = [m for m in markers if not 0xE0 <= m <= 0xEF]
    want = [0xDB, 0xDB, 0xC0, 0xC4, 0xC4, 0xC4, 0xC4, 0xDA]
    scan = np.frombuffer(data, np.uint8, offset=pos)[:-2]
    ff = np.flatnonzero(scan[:-1] == 0xFF)
    if body != want or scan[-1] == 0xFF or (scan[ff + 1] != 0).any():
        raise RuntimeError(f"{path}: markers {[hex(m) for m in markers]}, "
                           "or an unstuffed 0xFF in the scan")
    if not quiet:
        log(f"  {os.path.basename(path)}: {len(data)} bytes, markers "
            + " ".join(hex(m) for m in markers) + " ... 0xd9: well formed")
    return data[sos:]


def readback(frame, pp):
    """D2H of the device-side u8 output against that of the f32 planes,
    both cropped as process_image reads them, on one frame: bytes and ms
    (median of 3, host clock)."""
    from art_tpu_torch.pipeline import develop as tdev

    for u8 in (True, False):
        config, data = tdev.plan(frame, pp, out_u8=u8)
        out = tdev.build_run(config)(tdev.upload(frame, "cuda"),
                                     tdev.data_to_torch(data, "cuda"))
        view = tdev.crop_result(out, config)
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.monotonic()
            view.cpu()
            times.append(time.monotonic() - t0)
        log(f"  D2H of the {'u8 (H, W, 3)' if u8 else 'f32 (3, H, W)'} "
            f"output: {view.numel() * view.element_size() / 1e6:.1f} MB in "
            f"{1e3 * float(np.median(times)):.2f} ms (median of 3)")
        del out, view


def cli_phase(smi_line, tmp):
    """Config 1 and the AMaZE flagship from a DNG file to a JPEG through
    the CLI on the card: phase times, kernel launches, the u8 output
    against the float develop's cast, the files' markers; config 1 on a
    small LJ92 DNG against the CPU."""
    from art_tpu_torch import cli
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.io.rawfile import load_raw
    from art_tpu_torch.params import ProcParams
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- CLI phase ({smi_line})")
    bil = os.path.join(tmp, "bilinear.arp")
    with open(bil, "w") as f:
        f.write("[RAW Bayer]\nMethod=bilinear\n")
    # config 1 as tools/bench_configs.py writes it, uncompressed (the
    # numpy LJ92 encoder would take most of a minute at this size)
    c1 = os.path.join(tmp, "config1.dng")
    t0 = time.monotonic()
    m = (np.random.default_rng(1).uniform(0.05, 0.9, FRAME) * 16000
         + 500).astype(np.uint16)
    write_dng(c1, m, black=500, white=16500, compress=False)
    log(f"config 1 DNG {FRAME[0]}x{FRAME[1]} written in "
        f"{time.monotonic() - t0:.2f} s")
    out1 = os.path.join(tmp, "config1.jpg")
    argv1 = ["-Y", "-p", bil, "-o", out1, "-c", c1]
    reset_counts()
    cli_run(argv1)
    launches, plain_calls = read_counts()
    log(f"config 1 through cli.main: launches {launches}; plain calls "
        f"{plain_calls}")
    if any(launches.values()) or any(plain_calls.values()):
        raise RuntimeError("config 1 runs no kernel and no plain version")
    check_jpeg(out1)
    cli_timed(f"config 1 ({FRAME[0]}x{FRAME[1]}, bilinear, sRGB JPEG)", argv1)
    pp1 = ProcParams()
    pp1.raw.bayer.method = "bilinear"
    readback(load_raw(c1), pp1)

    # the lossless (LJ92) decode on a small DNG, card against the CPU
    small = os.path.join(tmp, "small.dng")
    write_dng(small, m[:512, :768], black=500, white=16500, compress=True)
    g = tdev.process_image(small, pp1, output_path=os.path.join(
        tmp, "small.jpg"))
    c = tdev.process_image(small, pp1, output_path=os.path.join(
        tmp, "small_cpu.jpg"), device="cpu")
    d = np.abs(g.astype(np.int16) - c.astype(np.int16))
    log(f"config 1 on a 512x768 LJ92 DNG, card vs CPU: u8 max {d.max()}, "
        f"equal share {(d == 0).mean():.6f}")
    if g.shape != (512, 768, 3) or d.max() > 1 or (d == 0).mean() < 0.999:
        raise RuntimeError("config 1: the card's u8 output disagrees with "
                           "the CPU's")

    # the AMaZE flagship: the synthetic flagship frame as a DNG, the
    # bundled profile and a second one with the denoise at 20/20
    frame = flagship_frame(*FRAME)
    fl = os.path.join(tmp, "flagship.dng")
    write_dng(fl, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, cam_mul=(2.0, 1.0, 1.5), compress=False)
    del frame
    dn = os.path.join(tmp, "denoise20.arp")
    with open(dn, "w") as f:
        f.write("[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n")
    arp = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "art_tpu_torch", "data", "profiles", PROFILE)
    out2 = os.path.join(tmp, "flagship.jpg")
    argv2 = ["-Y", "-p", arp, "-p", dn, "-o", out2, "-c", fl]
    reset_counts()
    cli_run(argv2)
    launches, plain_calls = read_counts()
    log(f"flagship through cli.main: launches {launches}; plain calls "
        f"{plain_calls}")
    want = {k: int(k in ("b1", "b2", "b3", "b4", "b7")) for k in launches}
    if launches != want or any(plain_calls.values()):
        raise RuntimeError(f"flagship through the CLI: launches {launches}, "
                           f"want {want}; plain calls {plain_calls}")
    check_jpeg(out2)
    cli_timed(f"flagship ({FRAME[0]}x{FRAME[1]}, AMaZE, denoise, Neutral "
              "curve, sRGB JPEG)", argv2)
    pp = cli.compose_params(fl, cli.parse_args(argv2))
    if (pp.raw.bayer.method, pp.denoise.enabled, pp.denoise.luminance,
            pp.denoise.chrominance) != ("amaze", True, 20.0, 20.0):
        raise RuntimeError("the flagship's profiles composed wrongly")
    u8 = tdev.process_image(fl, pp, output_path=out2)
    flt = tdev.develop(load_raw(fl), pp)
    cast = (torch.clamp(flt, 0.0, 1.0) * 255.0 + 0.5).to(
        torch.uint8).permute(1, 2, 0).cpu().numpy()
    del flt
    if u8.shape != (*FRAME, 3) or not np.array_equal(u8, cast):
        raise RuntimeError("flagship: the u8 output differs from the cast "
                           "of the float develop")
    log(f"flagship u8 output {u8.shape} equals the u8 cast of the float "
        "develop, on the card")


def batch_counts(label, jobs, want, prefetch):
    """One `process_batch` of jobs over every CUDA device with the counts
    from 0: checks that every job succeeded, that each kernel launched as
    `want` says and no plain version ran, and that the frames held stayed
    within the window. Returns (stats, wall seconds)."""
    from art_tpu_torch.parallel import process_batch

    reset_counts()
    stats = {}
    t0 = time.monotonic()
    oks = process_batch(jobs, prefetch=prefetch, stats=stats)
    wall = time.monotonic() - t0
    launches, plain_calls = read_counts()
    log(f"{label}: {len(jobs)} jobs in {wall:.3f} s, "
        f"{len(jobs) / wall:.4f} images/s; {sum(oks)} True; launches "
        f"{launches}; plain calls {plain_calls}; peak in flight "
        f"{stats['peak_in_flight']} of window {stats['window']}")
    log("  stage worker-seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stats["stage_seconds"].items())
        + "; per image: " + ", ".join(
            f"{k} {1e3 * v / len(jobs):.1f} ms"
            for k, v in stats["stage_seconds"].items()))
    if not all(oks):
        raise RuntimeError(f"{label}: jobs failed: "
                           f"{[i for i, ok in enumerate(oks) if not ok]}")
    if launches != want or any(plain_calls.values()):
        raise RuntimeError(f"{label}: launches {launches}, want {want}; "
                           f"plain calls {plain_calls}")
    if stats["peak_in_flight"] > stats["window"]:
        raise RuntimeError(f"{label}: frames held beyond the window: "
                           f"{stats}")
    return stats, wall


def device_busy(run):
    """(device busy seconds, wall seconds) of run(), from torch.profiler:
    every device activity (kernels and copies) of the process, whichever
    thread launched it, as profile_develop counts it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU
                  and not e.key.startswith("art:"))
    return busy_us / 1e6, wall


# the bundled profiles of the mixed catalog, with the Neutral tone curve
# (kernel B7) or not
BUNDLED = {"Auto-Matched Curve.arp": False, "Neutral.arp": False,
           "Punchy.arp": True, "Standard Film Curve.arp": True}


# config 5's catalog: its jobs, and the jobs of the profiled run and of
# the run at the default window
C5_JOBS, C5_SUB = 16, 4


def config5_phase(smi_line, tmp):
    """Config 5, the batch queue (`parallel.queue.process_batch` over
    every CUDA device): (a) C5_JOBS jobs of config 5's 24 MP DNG to JPEGs,
    after a warm run of 2: images/s, stage seconds, the frames held
    against the window, the device's busy share; launches, markers and
    job 0's scan against process_image's. (b) A mixed catalog of 10 jobs:
    the four bundled profiles and USER_ARP, two each; B7 once per
    Neutral-curve job. Returns the user profile's 512x1024 develop, card
    against the CPU."""
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.io.rawfile import load_raw
    from art_tpu_torch.params import ProcParams
    from art_tpu_torch.pipeline import develop as tdev
    from art_tpu_torch.settings import settings

    log(f"---- config 5, the batch queue ({smi_line}; "
        f"{torch.cuda.device_count()} CUDA device(s), host threads "
        f"{settings.host_threads} + {settings.host_threads}, "
        f"{os.cpu_count()} cores)")
    # config 5's DNG as tools/bench_configs.py writes it, uncompressed
    # (the numpy LJ92 encoder would take most of a minute at this size),
    # hardlinked once per job
    t0 = time.monotonic()
    src = os.path.join(tmp, "c5_0.dng")
    m = (np.random.default_rng(3).uniform(0.05, 0.9, FRAME) * 16000
         + 500).astype(np.uint16)
    write_dng(src, m, black=500, white=16500, compress=False)
    del m
    paths = [src]
    for i in range(1, C5_JOBS):
        paths.append(os.path.join(tmp, f"c5_{i}.dng"))
        os.link(src, paths[-1])
    log(f"config 5 DNG {FRAME[0]}x{FRAME[1]} written and linked {C5_JOBS} "
        f"times "
        f"in {time.monotonic() - t0:.2f} s")
    config, _ = tdev.plan(load_raw(src), config5_pp(), out_u8=True)
    if ([s[0] for s in config.steps] != ["denoise"]
            or tdev.fusion_gates(config) != (True, False)):
        raise RuntimeError(f"config 5 plans {config.steps}, gates "
                           f"{tdev.fusion_gates(config)}")
    jobs = [(p, config5_pp(), os.path.join(tmp, f"c5_out_{i}.jpg"))
            for i, p in enumerate(paths)]
    want = {k: C5_JOBS * (k in ("b1", "b2", "b3", "b4")) for k in counted()}
    # the window of the reference's run on one chip (device_batch 4:
    # max(4 + 1, 2 * 4) = 8 frames), and the default (prefetch 2)
    prefetch = 8
    batch_counts("config 5 warm run",
                 jobs[:2], {k: 2 * (v > 0) for k, v in want.items()},
                 prefetch)
    stats, wall = batch_counts(
        f"config 5 ({FRAME[0]}x{FRAME[1]}, AMaZE, denoise 20, sRGB JPEG; "
        f"prefetch {prefetch})", jobs, want, prefetch)
    log(f"  device stream share of the wall (the device stage's CUDA-event "
        f"span over wall time): {stats['stage_seconds']['device'] / wall:.4f}")
    scans = [check_jpeg(j[2], quiet=True) for j in jobs]
    sizes = [os.path.getsize(j[2]) for j in jobs]
    log(f"  all {C5_JOBS} JPEGs well formed ({min(sizes)}-{max(sizes)} "
        "bytes)")
    ref = os.path.join(tmp, "c5_single.jpg")
    tdev.process_image(src, config5_pp(), output_path=ref)
    if scans[0] != check_jpeg(ref, quiet=True):
        raise RuntimeError("config 5: job 0's scan differs from "
                           "process_image's")
    if any(sc != scans[0] for sc in scans):
        raise RuntimeError("config 5: the jobs of one file wrote different "
                           "scans")
    log("  job 0's scan (SOS to EOI) equals process_image's, byte for "
        "byte; every job's scan equals job 0's")
    n = C5_SUB
    busy, pwall = device_busy(lambda: batch_counts(
        f"config 5 under torch.profiler, {n} jobs", jobs[:n],
        {k: n * (v > 0) for k, v in want.items()}, prefetch))
    log(f"  profiled {n} jobs: device busy {busy:.3f} s of {pwall:.3f} s "
        f"wall, busy share {busy / pwall:.4f}")
    batch_counts(f"config 5 at the default window (prefetch 2), {n} jobs",
                 jobs[:n], {k: n * (v > 0) for k, v in want.items()}, 2)
    for j in jobs:
        os.unlink(j[2])

    # (b) the mixed catalog: the bundled profiles and the user profile
    prof_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "art_tpu_torch", "data", "profiles")
    user = os.path.join(tmp, "user.arp")
    with open(user, "w") as f:
        f.write(USER_ARP)
    mixed = []
    for k in range(10):
        name = (sorted(BUNDLED) + ["user.arp"])[k % 5]
        pp = ProcParams()
        with open(user if name == "user.arp"
                  else os.path.join(prof_dir, name)) as f:
            pp.apply_arp_text(f.read())
        mixed.append((paths[k], pp, os.path.join(tmp, f"mixed_{k}.jpg")))
    neutral = 2 * sum(BUNDLED.values())
    batch_counts("mixed catalog (the four bundled profiles and the user "
                 "profile, two jobs each)", mixed,
                 {k: {"b1": 10, "b2": 10, "b3": 10, "b7": neutral}.get(k, 0)
                  for k in counted()}, prefetch)
    for j in mixed:
        check_jpeg(j[2], quiet=True)
    log(f"  all 10 JPEGs well formed; B7 launched once per Neutral-curve "
        f"job ({neutral})")

    pp = ProcParams()
    pp.apply_arp_text(USER_ARP)
    small = flagship_frame(*SMALL, seed=5)
    cfg, _ = tdev.plan(small, pp)
    g = tdev.develop(small, pp).cpu()
    c = tdev.develop(small, pp, device="cpu")
    st = parity(g, c)
    log(f"{SMALL[0]}x{SMALL[1]} user profile develop "
        f"({[s[0] for s in cfg.steps]}), card vs CPU plain path: {st}")
    return st


@contextlib.contextmanager
def record_args(module, name):
    """Yields a list that gathers the (args, kwargs) of every call of
    module.<name> inside the block; the function runs as before, and a
    launch it counts on its own name stays counted."""
    fn = getattr(module, name)
    calls = []

    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    recorded.launches = getattr(fn, "launches", 0)
    setattr(module, name, recorded)
    try:
        yield calls
    finally:
        setattr(module, name, fn)
        if hasattr(fn, "launches"):
            fn.launches = recorded.launches


def jpeg_size(path):
    """(height, width) from a JPEG's SOF0 marker."""
    data = open(path, "rb").read()
    i = data.index(b"\xff\xc0")
    return (int.from_bytes(data[i + 5: i + 7], "big"),
            int.from_bytes(data[i + 7: i + 9], "big"))


def variant_entry(name, key, source, replaces, launches, kern, plain,
                  reads):
    """A kernel variant on the tensors its path fed it: the kernel against
    its plain version (bit-equal), times and bound, as a kernels-line
    entry."""
    from art_tpu_torch.opcount import needed_ops

    k_out = kern()
    p_out, *ops = needed_ops(plain)
    torch.cuda.synchronize()
    return kernel_entry(name, key, source, replaces, {key: launches}, k_out,
                        p_out, gpu_ms(kern, 10), gpu_ms(plain, 3),
                        bound(reads, (k_out,), ops))


def export_phase(smi_line, tmp, entries):
    """The everyday export on the card: E1 (the flagship frame with blown
    highlights, Blend, denoise with the DCT pass, RL sharpening, a
    quarter turn, a crop, the resize with USM output sharpening, Adobe
    RGB: B1, B2, B3, B5 and B7 with no epilogue), E2 (the flagship's
    fast export through cli.main at the default 1920 box: B1-B3 at 24 MP,
    B4 with no raw head at 1280x1920, B7 with the sRGB epilogue) and E3
    (config 3's denoise with the DCT pass in a fast export to an 800 box:
    the whole-plane wavelet, B6 at 533x800); B7 with no epilogue and B4
    with no head held to their plain versions on the tensors E1 and E2
    feed them (entries added to `entries`); small develops of each, and
    of HLRecovery=Color and ColorSoft, against the CPU. Returns the
    comparisons."""
    from art_tpu_torch import cli
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.io.rawfile import load_raw
    from art_tpu_torch.ops import denoise
    from art_tpu_torch.ops import tonecurve_neutral as tn
    from art_tpu_torch.ops import wavelet_kernel as wk
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- export phase ({smi_line})")
    stats = {}
    # E1, the everyday export
    t0 = time.monotonic()
    frame = clipped_frame(*FRAME, share=0.03)
    clipped = float((frame.cfa >= frame.white[0]).mean())
    log(f"E1 frame {FRAME[0]}x{FRAME[1]} (the flagship frame, 3% of its "
        f"16x16 blocks x2.2) in {time.monotonic() - t0:.2f} s: "
        f"{clipped:.4f} of the sites clipped")
    pp = export_pp(*FRAME)
    config, data = tdev.plan(frame, pp)
    log(f"E1 plan: steps {[st[0] for st in config.steps]}, coarse "
        f"{config.coarse}, crop {config.crop}, resize_to "
        f"{config.resize_to}, prsharp {config.prsharp}, hl_mode "
        f"{config.hl_mode}, out_trc {config.out_trc}, fusion gates "
        f"{tdev.fusion_gates(config)}; Lanczos matrices "
        f"{(data['resize_rows'].nbytes + data['resize_cols'].nbytes) / 1e6:.1f}"
        " MB")
    stats["E1"] = new_path("E1", pp, frame, ("b1", "b2", "b3", "b5", "b7"),
                           clipped_frame(*SMALL, seed=5, share=0.03),
                           export_pp(*SMALL), shape=config.resize_to)
    with record_args(tn, "neutral_tone") as calls:
        tdev.develop(frame, pp)
    (x, params, coeffs, epi), _ = calls[0]
    if epi is not None:
        raise RuntimeError(f"E1: B7 ran with the epilogue {epi!r}")
    log("B7 (EPI 0) as loaded: " + tn.layout(tuple(coeffs.shape),
                                              None).strip())
    entries["b7_epi0"] = variant_entry(
        "neutral_tone (B7, EPI 0)", "b7_epi0",
        "art_tpu_torch/csrc/neutral_tone.cu",
        "art_tpu/ops/tonecurve_neutral.py:384", 1,
        lambda: tn.neutral_tone(x, params, coeffs, None),
        lambda: tn.neutral_plain(x, params, coeffs, None), (x,))
    del frame, calls, x

    # E2, the flagship's fast export through the CLI
    frame = flagship_frame(*FRAME)
    fl = os.path.join(tmp, "flagship.dng")
    write_dng(fl, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, cam_mul=(2.0, 1.0, 1.5), compress=False)
    del frame
    dn = os.path.join(tmp, "denoise20.arp")
    with open(dn, "w") as f:
        f.write("[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n")
    arp = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "art_tpu_torch", "data", "profiles", PROFILE)
    out2 = os.path.join(tmp, "e2.jpg")
    argv = ["-Y", "-q", "-p", arp, "-p", dn, "-o", out2, "-c", fl]
    reset_counts()
    cli_run(argv)
    launches, plain_calls = read_counts()
    log(f"E2 through cli.main -q: launches {launches}; plain calls "
        f"{plain_calls}")
    want = {k: int(k in ("b1", "b2", "b3", "b4", "b7")) for k in launches}
    if launches != want or any(plain_calls.values()):
        raise RuntimeError(f"E2: launches {launches}, want {want}; plain "
                           f"calls {plain_calls}")
    check_jpeg(out2)
    if jpeg_size(out2) != (1280, 1920):
        raise RuntimeError(f"E2: a {jpeg_size(out2)} JPEG, want 1280x1920")
    cli_timed(f"E2 ({FRAME[0]}x{FRAME[1]} -> 1280x1920, -q, AMaZE, denoise, "
              "Neutral curve, sRGB JPEG)", argv)
    pp2 = cli.compose_params(fl, cli.parse_args(argv))
    frame = load_raw(fl)
    config2, data2 = tdev.plan(frame, pp2, fast=True, out_u8=True)
    lanczos = data2["early_rows"].nbytes + data2["early_cols"].nbytes
    h2d = tdev.host_input(frame).nbytes + sum(
        np.asarray(v).nbytes for _, v in _leaves(data2))
    log(f"E2 plan: early_resize {config2.early_resize}, fusion gates "
        f"{tdev.fusion_gates(config2)}; the H2D: {h2d / 1e6:.1f} MB, of "
        f"which the Lanczos matrices {lanczos / 1e6:.1f} MB")
    with record_args(denoise, "wavelet_denoise_rgb") as calls:
        tdev.develop(frame, pp2, fast=True)
    args, kwargs = calls[0]
    if kwargs.get("pre") is not None or tuple(args[0].shape) != (3, 1280,
                                                                  1920):
        raise RuntimeError("E2: B4 ran with a raw head or at "
                           f"{tuple(args[0].shape)}")
    plain_args = (args[0],) + wk.prepare(*args, **kwargs)
    entries["b4_nohead"] = variant_entry(
        "wavelet_rgb (B4, no raw head)", "b4_nohead",
        "art_tpu_torch/csrc/wavelet_rgb.cu",
        "art_tpu/ops/wavelet_pallas.py:311", 1,
        lambda: wk.wavelet_denoise_rgb(*args, **kwargs),
        lambda: wk.wavelet_rgb_plain(*plain_args), (args[0],))
    del frame, calls, args, plain_args

    # E3, config 3's denoise in a fast export to an 800 box: the wavelet
    # below a tile runs whole-plane; B6's tile is 256x256, which 533x800
    # holds, so it launches (as the reference's nlmeans_pallas tiles it)
    frame = flagship_frame(*FRAME)
    pp3 = e3_pp()
    pp3.apply_arp_text(fast_box_arp(800))
    small3 = e3_pp()
    small3.apply_arp_text(fast_box_arp(round(800 * SMALL2[1] / FRAME[1])))
    stats["E3"] = new_path("E3", pp3, frame, ("b6",),
                           flagship_frame(*SMALL2, seed=5), small3,
                           shape=(533, 800), fast=True)
    del frame

    # highlight recovery Color and ColorSoft, card against the CPU
    small = clipped_frame(*SMALL, seed=5, share=0.03)
    for mode in ("Color", "ColorSoft"):
        ppm = flagship_pp("amaze")
        ppm.exposure.hrmode = mode
        g = tdev.develop(small, ppm).cpu()
        c = tdev.develop(small, ppm, device="cpu")
        stats[f"HL {mode}"] = parity(g, c)
        log(f"{SMALL[0]}x{SMALL[1]} HLRecovery={mode} develop, card vs CPU "
            f"plain path: {stats[f'HL {mode}']}")
    return stats


TONE_MODES = ("Standard", "FilmLike", "Luminance", "WeightedStd",
              "SatAndValueBlending", "Perceptual", "Neutral")


def look_phase(smi_line, entries):
    """The look paths on the card, counts reset before each: L1, a colour
    grade on the flagship frame (`l1_pp`: B1, B2, B3 and B4 with no raw
    head once, B6 three times on smoothing's Y, U and V, B7 with no
    epilogue once) and L2, a scanned colour negative (`l2_frame`,
    `l2_pp`: B1-B3 once), as new_path runs them, with 512x1024 develops
    against the CPU; B6 on L1's luma and chroma planes against its plain
    version (entries added to `entries`); Fattal's 49-point shadow median
    timed beside a 9-point one; and each tone-curve mode at 512x768
    against the CPU. Returns the comparisons."""
    from art_tpu_torch.ops import denoise, fattal
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- look phase ({smi_line})")
    stats = {}
    frame = flagship_frame(*FRAME)
    pp = l1_pp(*FRAME)
    t0 = time.monotonic()
    config, _ = tdev.plan(frame, pp)
    log(f"L1 plan (with the auto log render) {time.monotonic() - t0:.3f} "
        f"s: steps {[st[0] for st in config.steps]}, fusion gates "
        f"{tdev.fusion_gates(config)}")
    l1 = {"b1": 1, "b2": 1, "b3": 1, "b4": 1, "b6": 3, "b7": 1}
    stats["L1"] = new_path("L1", pp, frame, l1, flagship_frame(*SMALL, seed=5),
                           l1_pp(*SMALL))
    with record_args(denoise, "nlmeans") as calls:
        tdev.develop(frame, pp)
    if len(calls) != 3:
        raise RuntimeError(f"L1: B6 ran {len(calls)} times, want 3")
    for (args, _), plane in zip(calls[:2], ("luma", "chroma")):
        y, maskinv = args
        log(f"L1 smoothing's {plane} plane into B6: range "
            f"{float(y.min()):.5f} .. {float(y.max()):.5f}")
        entries[f"b6_{plane}"] = b6_entry(
            f"nlmeans (B6, L1 smoothing {plane})", f"b6_{plane}",
            {"b6": 3}, y, maskinv)
    del calls, y, maskinv, frame

    frame = l2_frame(*FRAME)
    stats["L2"] = new_path("L2", l2_pp(), frame, ("b1", "b2", "b3"),
                           l2_frame(*SMALL, seed=5))
    # Fattal's shadow median at 24 MP: 49 points (7x7) against 9
    y = torch.rand(FRAME, device="cuda") * 100.0
    for name in ("_MED_7X7", "_MED_3X3"):
        pts = getattr(fattal, name)
        ms = gpu_ms(lambda: fattal._median_pts(y, pts), 3)
        log(f"Fattal's {len(pts)}-point median of a {FRAME[0]}x{FRAME[1]} "
            f"plane: {ms:.2f} ms (CUDA events, mean of 3)")
    del y, frame

    small = flagship_frame(*SMALL2, seed=5)
    for mode in TONE_MODES:
        ppm = flagship_pp("amaze")
        ppm.tone_curve.curve_mode = ppm.tone_curve.curve_mode2 = mode
        g = tdev.develop(small, ppm).cpu()
        c = tdev.develop(small, ppm, device="cpu")
        stats[f"curve {mode}"] = parity(g, c)
        log(f"{SMALL2[0]}x{SMALL2[1]} tone curve {mode} develop, card vs "
            f"CPU plain path: {stats[f'curve {mode}']}")
    return stats


def kernels_against_plain(label, develop,
                          keys=("b1", "b2", "b3", "b4", "b7")):
    """Run `develop` once, recording the arguments of each launch of B1,
    B2, B3, B4 and B7, and hold each kernel of `keys` to its plain version
    on them (bit-equal); each must launch once. Returns the failures."""
    from art_tpu_torch.demosaic import amaze
    from art_tpu_torch.demosaic import amaze_kernel as ak
    from art_tpu_torch.ops import denoise
    from art_tpu_torch.ops import tonecurve_neutral as tn
    from art_tpu_torch.ops import wavelet_kernel as wk

    with contextlib.ExitStack() as stack:
        calls = {k: stack.enter_context(record_args(mod, name))
                 for k, (mod, name) in {
                     "b1": (ak, "amaze_stage1"), "b2": (ak, "amaze_stage2"),
                     "b3": (ak, "amaze_stage3"),
                     "b4": (denoise, "wavelet_denoise_rgb"),
                     "b7": (tn, "neutral_tone")}.items()}
        develop()
    pairs = {
        "b1": (ak.amaze_stage1, amaze.stage1_plain),
        "b2": (ak.amaze_stage2, amaze.stage2_plain),
        "b3": (ak.amaze_stage3, amaze.stage3_plain),
        "b4": (wk.wavelet_denoise_rgb,
               lambda *a, **kw: wk.wavelet_rgb_plain(
                   a[0], *wk.prepare(*a, **kw))),
        "b7": (tn.neutral_tone, tn.neutral_plain)}
    failures = []
    for key, (kern, plain) in pairs.items():
        if key not in keys:
            continue
        if len(calls[key]) != 1:
            failures.append(f"{label}: {key} ran {len(calls[key])} times")
            continue
        args, kwargs = calls[key][0]
        k_out = kern(*args, **kwargs)
        p_out = plain(*args, **kwargs)
        torch.cuda.synchronize()
        err, mean = diff_stats(k_out, p_out)
        log(f"{label} {key.upper()} on its path's tensors "
            f"{tuple(args[0].shape)}: kernel vs plain max {err:.6g} mean "
            f"{mean:.6g}")
        if err > KERNEL_MAX or mean > KERNEL_MEAN:
            failures.append(f"{label}: {key} disagrees with its plain "
                            "version")
    return failures


def lens_phase(smi_line, tmp):
    """The lens and sensor corrections on the card, counts reset before
    each path. C1, a calibrated, lens-corrected flagship (`c1_frame`,
    `c1_files`, `c1_pp`: a dark frame, a flat field, a .badpixels file,
    CFA line denoise, the PDAF filter, an LCP profile's distortion, CA and
    vignette, a rotation, perspective and auto-fill; AMaZE, denoise, the
    Neutral curve, sRGB), as new_path runs it: B1, B2, B3, B4 (raw head)
    and B7 (sRGB epilogue) once each, each held to its plain version on
    the tensors C1 feeds it, and a 512x1024 develop against the CPU. C2,
    an embedded gain map and lensfun through cli.main (`c2_dng`,
    `c2_arp`, `lensfun_db`): its phases, median of 2 after a warm run,
    its launches, and a 512x1024 develop against the CPU. Returns (the
    comparisons, the failures)."""
    from art_tpu_torch.io.rawfile import load_raw
    from art_tpu_torch.pipeline import develop as tdev
    from art_tpu_torch.settings import settings

    log(f"---- lens phase ({smi_line})")
    stats = {}
    t0 = time.monotonic()
    frame = c1_frame(*FRAME)
    files = c1_files(tmp, frame)
    small = c1_frame(*SMALL, seed=5)
    small_files = c1_files(os.path.join(tmp, "small"), small, seed=5)
    log(f"C1 frame {FRAME[0]}x{FRAME[1]} and its calibration (a dark-frame "
        f"and a flat-field DNG, an LCP profile, a .badpixels file) in "
        f"{time.monotonic() - t0:.2f} s")
    with badpixels_dir(files["badpixels_dir"]):
        pp = c1_pp(files)
        t0 = time.monotonic()
        config, data = tdev.plan(frame, pp)
        planes = sum(data[k].nbytes for k in ("df_plane", "ff_plane",
                                              "badpix_mask"))
        log(f"C1 plan {1e3 * (time.monotonic() - t0):.1f} ms: steps "
            f"{[st[0] for st in config.steps]}, transform "
            f"{config.transform} ({sorted(data['transform'])}), darkframe "
            f"{config.darkframe}, flatfield {config.flatfield}, badpix_file "
            f"{config.badpix_file}, linedn {config.linedn}, pdaf "
            f"{config.pdaf}, fusion gates {tdev.fusion_gates(config)}; the "
            f"dark, flat and .badpixels planes {planes / 1e6:.1f} MB of the "
            "H2D")
        if not (config.transform and config.darkframe and config.pdaf
                and config.badpix_file and config.flatfield
                and config.linedn[0] > 0 and "lcp_vign" in data):
            raise RuntimeError(f"C1 planned {config}")
        del data
        stats["C1"] = new_path("C1", pp, frame,
                               ("b1", "b2", "b3", "b4", "b7"), small,
                               c1_pp(small_files))
        failures = kernels_against_plain("C1", lambda: tdev.develop(frame,
                                                                    pp))
    del frame, small

    # C2: an embedded gain map and lensfun, file in, JPEG out
    t0 = time.monotonic()
    dng = os.path.join(tmp, "c2.dng")
    c2_dng(dng, *FRAME)
    arp = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "art_tpu_torch", "data", "profiles", PROFILE)
    dn = os.path.join(tmp, "denoise20.arp")
    with open(dn, "w") as f:
        f.write("[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n")
    c2 = os.path.join(tmp, "c2.arp")
    with open(c2, "w") as f:
        f.write(c2_arp())
    out = os.path.join(tmp, "c2.jpg")
    argv = ["-Y", "-p", arp, "-p", dn, "-p", c2, "-o", out, "-c", dng]
    log(f"C2 DNG {FRAME[0]}x{FRAME[1]} with four 9x9 gain maps in "
        f"{time.monotonic() - t0:.2f} s")
    old_db = settings.lensfun_db_dir
    settings.lensfun_db_dir = lensfun_db(os.path.join(tmp, "lensfun"))
    try:
        reset_counts()
        cli_run(argv)
        launches, plain_calls = read_counts()
        log(f"C2 through cli.main: launches {launches}; plain calls "
            f"{plain_calls}")
        want = {k: int(k in ("b1", "b2", "b3", "b4", "b7"))
                for k in launches}
        if launches != want or any(plain_calls.values()):
            raise RuntimeError(f"C2: launches {launches}, want {want}; "
                               f"plain calls {plain_calls}")
        check_jpeg(out)
        cli_timed(f"C2 ({FRAME[0]}x{FRAME[1]} DNG, gain map, lensfun, "
                  "distortion and CA sliders, AMaZE, denoise, Neutral "
                  "curve, sRGB JPEG)", argv)
        from art_tpu_torch import cli

        pp2 = cli.compose_params(dng, cli.parse_args(argv))
        config, data = tdev.plan(load_raw(dng), pp2)
        log(f"C2 plan: gainmap {config.gainmap}, transform "
            f"{config.transform} ({sorted(data['transform'])}), raw "
            f"vignette {[k for k in data if 'vign' in k]}")
        if not (config.gainmap and config.transform
                and "exif_vign" in data):
            raise RuntimeError(f"C2 planned {config}")
        small_dng = os.path.join(tmp, "c2_small.dng")
        c2_dng(small_dng, *SMALL, seed=5)
        small = load_raw(small_dng)
        g = tdev.develop(small, pp2).cpu()
        c = tdev.develop(small, pp2, device="cpu")
        stats["C2"] = parity(g, c)
        log(f"{SMALL[0]}x{SMALL[1]} C2 develop, card vs CPU plain path: "
            f"{stats['C2']}")
    finally:
        settings.lensfun_db_dir = old_db
    return stats, failures


# the demosaic phase: D2's names beside D1's amazevng4 (the other
# Bayer methods, the duals, mono/none and a name outside the registry,
# which develops bilinear), its card-vs-CPU crop, and D3's moved patch
D2_METHODS = ("lmmse", "igv", "vng4", "dcb", "ahd", "eahd", "hphd", "ppg",
              "jdl", "amazebilinear", "rcdbilinear", "rcdvng4",
              "dcbbilinear", "dcbvng4", "mono", "none", "no such method")
# D2 runs each name at a quarter of the flagship's rows (the full width)
# and compares a 128x1024 crop card against CPU: 17 names, the phase's most
# time
CROP = (128, 1024)
D2_FRAME = (FRAME[0] // 4, FRAME[1])
PATCH = 512
# a Sigma DP2 Merrill's levels (12-bit, black 16)
FOVEON_BLACK, FOVEON_WHITE = 16.0, 4070.0


def crop_frame(frame, h, w):
    """The frame's top-left h x w, every plane and extra frame."""
    import dataclasses

    extra = frame.extra_frames
    return dataclasses.replace(
        frame, cfa=np.ascontiguousarray(frame.cfa[..., :h, :w]),
        extra_frames=None if extra is None
        else np.ascontiguousarray(extra[:, :h, :w]))


def pixelshift_frame(h, w, seed=0, patch=PATCH):
    """Four pixel-shift frames of the flagship scene of `seed`
    (`synthesize_pixelshift`), with a patch x patch block halved in the
    second frame from a third of the way down and across: an object that
    moved, where the motion fallback runs."""
    from art_tpu_torch.io.rawfile import synthesize_pixelshift

    rng = np.random.default_rng(seed)
    frame = synthesize_pixelshift(
        rng.uniform(0.02, 0.95, size=(3, h, w)).astype(np.float32))
    p = min(patch, h // 4, w // 4)
    frame.extra_frames[0, h // 3: h // 3 + p, w // 3: w // 3 + p] *= 0.5
    return frame


def foveon_frame(h, w, seed=0):
    """A Sigma Foveon frame of the flagship scene of `seed`: three u16
    planes at a DP2 Merrill's levels, as an X3F decodes."""
    from art_tpu_torch.io.rawfile import RawFrame

    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0.02, 0.95, size=(3, h, w))
    planes = np.round(rgb * (FOVEON_WHITE - FOVEON_BLACK) + FOVEON_BLACK)
    return RawFrame(cfa=planes.astype(np.uint16), pattern=None,
                    black=np.full(4, FOVEON_BLACK),
                    white=np.full(4, FOVEON_WHITE), make="SIGMA",
                    model="DP2 Merrill", integral=True)


@contextlib.contextmanager
def demosaic_decisions(outputs=True):
    """Yields a dict that gathers, on the CPU, the demosaic's output of
    each develop inside the block ("demosaic", unless `outputs` is
    False) and pixel shift's motion masks ("motion")."""
    from art_tpu_torch import demosaic as dem
    from art_tpu_torch.demosaic import pixelshift as tps

    got = {"demosaic": [], "motion": []}
    dem_fn, mask_fn = dem.demosaic, tps.motion_mask

    def dem_recorded(*args, **kwargs):
        rgb = dem_fn(*args, **kwargs)
        got["demosaic"].append(rgb.cpu())
        return rgb

    def mask_recorded(*args):
        m = mask_fn(*args)
        got["motion"].append(m.cpu())
        return m

    tps.motion_mask = mask_recorded
    if outputs:
        dem.demosaic = dem_recorded
    try:
        yield got
    finally:
        dem.demosaic, tps.motion_mask = dem_fn, mask_fn


def card_vs_cpu(label, frame, pp):
    """A develop of frame on the card against the same on the CPU. Where
    the path decides (a demosaic's direction picks and votes, the dual
    blend's threshold, pixel shift's motion), flip_parity reads the
    decisions: the motion masks, or the demosaic's sites that differ by
    more than 1 of 65535 between the two (a flipped pick moves a value
    by far more than rounding)."""
    from art_tpu_torch.pipeline import develop as tdev

    with demosaic_decisions() as dec:
        g = tdev.develop(frame, pp).cpu()
        n_card = len(dec["demosaic"])
        c = tdev.develop(frame, pp, device="cpu")
    if dec["motion"]:
        st = flip_parity(g, c, *dec["motion"], RAW_REACH)
    elif dec["demosaic"]:
        # each develop's own demosaic is its last one (a neutral render
        # for an auto, histogram matching's, demosaics before it)
        a, b = dec["demosaic"][n_card - 1], dec["demosaic"][-1]
        moved = (a.double() - b.double()).abs().amax(0) > 1.0
        st = flip_parity(g, c, moved, torch.zeros_like(moved), RAW_REACH)
    else:
        st = parity(g, c)
    h, w = frame.cfa.shape[-2:]
    log(f"{h}x{w} {label} develop, card vs CPU plain path: {st}")
    return st


def stage_ms(run):
    """Device ms of each `art:` stage in one call of run (torch.profiler:
    the span of each range on the device timeline), traced after an
    untraced warm-up step, as kernel_breakdown traces: a trace's first
    step can lose its first ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    return {e.key[4:]: e.device_time_total / 1e3
            for e in prof.key_averages()
            if e.key.startswith("art:") and e.device_type != DeviceType.CPU}


def program_times(label, frame, pp, n=3):
    """device_program's numbers (mean of n) and the device ms by `art:`
    stage, logged on one line and returned as a dict."""
    from art_tpu_torch.pipeline import develop as tdev

    config, inp, data, times = device_program(frame, pp, n=n)
    run = tdev.build_run(config)
    times["stages"] = stage_ms(lambda: run(inp, data))
    log(f"{label}: host plan {times['plan_ms']:.1f} ms; device program "
        f"{times['device_ms']:.3f} ms (mean of {n}, inputs resident); peak "
        f"{times['peak_gb']:.3f} GB in {times['peak_stage']}; device ms by "
        "stage: " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
            times["stages"].items(), key=lambda kv: -kv[1])))
    return times


def demosaic_path(label, pp, frame, want, small, median=False):
    """One path of the demosaic phase: a develop with the counts from 0,
    which must launch each kernel of `want` once and no other (and no
    plain version); with `median`, the median develop and the profiled
    one; the device program's times; each launched kernel against its
    plain version on the path's own tensors; a develop of `small` on the
    card against the CPU. Returns (times, comparison, failures)."""
    from art_tpu_torch.pipeline import develop as tdev

    launches = drive(label, pp, frame, want, shape=frame.cfa.shape[-2:])
    expect = {k: int(k in want) for k in launches}
    if launches != expect:
        raise RuntimeError(f"{label}: launches {launches}, want {expect}")
    if median:
        median_develop(label, frame, pp)
        profile_develop(frame, pp)
    times = program_times(label, frame, pp)
    failures = kernels_against_plain(
        label, lambda: tdev.develop(frame, pp), want) if want else []
    return times, card_vs_cpu(label, small, pp), failures


def demosaic_phase(smi_line, entries):
    """The demosaics and raw inputs on the card, counts reset before each
    path, each kernel launched held to its plain version on the path's
    own tensors, each path's small develop against the CPU:
    D1, the flagship with `amazevng4` and the automatic dual contrast
    (B1-B4, B7; the median develop, the device program, peak memory and
    `art:` stages, a 512x768 develop against the CPU, as D3's and D4's);
    D2, each of
    D2_METHODS on the top quarter of the flagship frame (D2_FRAME, the full
    width) and the flagship profile (B4 and B7; B1-B3 for the AMaZE
    dual), its device program and `art:demosaic` ms and a CROP crop
    against the CPU; D3, pixel shift: four 24 MP frames
    with a 512x512 patch moved (B1-B3 in the motion fallback at gain 1,
    B4 with no raw head, B7), the motion share and the H2D of the three
    float32 extra frames; D4, a (3, 4000, 6000) u16 Foveon frame (B4 with
    the raw head, B7); D5, X-Trans 4-pass with the automatic dual blend
    on config 4's frame and settings (no kernel). `entries` (the kernels
    line) is left as it is: no new kernel. Returns (times by path, the
    comparisons, the failures)."""
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- demosaic phase ({smi_line})")
    times, stats, failures = {}, {}, []
    b15 = ("b1", "b2", "b3", "b4", "b7")
    t0 = time.monotonic()
    frame = flagship_frame(*FRAME)
    small = flagship_frame(*SMALL2, seed=5)
    log(f"flagship frame {FRAME[0]}x{FRAME[1]} in "
        f"{time.monotonic() - t0:.2f} s")

    pp = flagship_pp("amazevng4")
    config, _ = tdev.plan(small, pp)
    log(f"D1 plan: {config.demosaic_method} {config.dem_kwargs}, fusion "
        f"gates {tdev.fusion_gates(config)}")
    t, st, f = demosaic_path("D1 amazevng4", pp, frame, b15, small,
                             median=True)
    times["D1 amazevng4"], stats["D1 amazevng4"] = t, st
    failures += f

    crop = crop_frame(frame, *CROP)
    top = crop_frame(frame, *D2_FRAME)
    for m in D2_METHODS:
        label = f"D2 {m}"
        want = b15 if m.startswith("amaze") else ("b4", "b7")
        t, st, f = demosaic_path(label, flagship_pp(m), top, want, crop)
        times[label], stats[label] = t, st
        failures += f
    del frame, crop, small, top

    # D3: pixel shift, a moved patch
    t0 = time.monotonic()
    frame = pixelshift_frame(*FRAME)
    small = pixelshift_frame(*SMALL2, seed=5)
    log(f"D3 four pixel-shift frames {FRAME[0]}x{FRAME[1]} in "
        f"{time.monotonic() - t0:.2f} s")
    pp = flagship_pp("pixelshift")
    config, data = tdev.plan(frame, pp)
    extra = data["ps_frames"]
    if not config.pixelshift or tdev.fusion_gates(config)[0]:
        raise RuntimeError(f"D3 planned {config}")
    h2d = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        torch.from_numpy(extra).to("cuda")
        torch.cuda.synchronize()
        h2d.append(1e3 * (time.monotonic() - t0))
    log(f"D3 H2D of the three float32 extra frames "
        f"({extra.nbytes / 1e6:.1f} MB, pageable), median of 3: "
        f"{float(np.median(h2d)):.2f} ms")
    del data, extra
    with demosaic_decisions(outputs=False) as dec:
        t, st, f = demosaic_path("D3 pixelshift", pp, frame, b15, small,
                                 median=True)
    share = float(dec["motion"][0].double().mean())
    log(f"D3 motion share of the padded plane: {share:.5f}")
    if not 0.0 < share < 0.05:
        failures.append(f"D3: motion share {share}")
    t["motion_share"] = share
    times["D3 pixelshift"], stats["D3 pixelshift"] = t, st
    failures += f
    del frame, small

    # D4: Foveon, three planes, no demosaic
    pp = flagship_pp("amaze")
    frame, small = foveon_frame(*FRAME), foveon_frame(*SMALL2, seed=5)
    config, _ = tdev.plan(frame, pp)
    if config.demosaic_method != "foveon" or not tdev.fusion_gates(
            config)[0]:
        raise RuntimeError(f"D4 planned {config}")
    t, st, f = demosaic_path("D4 foveon", pp, frame, ("b4", "b7"), small,
                             median=True)
    times["D4 foveon"], stats["D4 foveon"] = t, st
    failures += f
    del frame, small

    # D5: X-Trans 4-pass with the automatic dual blend
    with tempfile.TemporaryDirectory() as lut_dir:
        cube = os.path.join(lut_dir, "config4.cube")
        write_cube(cube)
        pp = config4_pp(cube)
        pp.raw.xtrans.method = "4-pass (best)"
        if not pp.raw.xtrans.dual_demosaic_auto_contrast:
            raise RuntimeError("4-pass without the automatic dual blend")
        t, st, f = demosaic_path("D5 xtrans 4-pass", pp,
                                 config4_frame(*FRAME4), (),
                                 config4_frame(*SMALL4, seed=5),
                                 median=True)
        times["D5 xtrans 4-pass"], stats["D5 xtrans 4-pass"] = t, st
        failures += f
    log("demosaic phase summary (device program ms, art:demosaic or "
        "art:pixelshift ms, peak GB): " + json.dumps({k: [
            round(v["device_ms"], 3),
            round(v["stages"].get("demosaic", v["stages"].get(
                "pixelshift", 0.0)), 3), round(v["peak_gb"], 3)]
            for k, v in times.items()}))
    return times, stats, failures


# ---- colour profiles and LUTs (profile_phase): the files P1-P3 read,
# written from a seed; the CPU tests write them too

# P1's white balance: Custom at 5200 K, green 1.0
P1_TEMP = 5200.0
# Adobe Standard's table shapes: the HueSatMap (hue, sat, val) and the
# look table, as the DNG tags store their dims
HSM_DIMS, LOOK_DIMS = (90, 30, 1), (36, 8, 16)


def _tiff_bytes(entries):
    """A little-endian TIFF of one IFD: entries (tag, type, count,
    payload bytes), sorted by tag."""
    entries = sorted(entries)
    n = len(entries)
    data_off = 8 + 2 + 12 * n + 4
    out = bytearray(b"II*\0" + (8).to_bytes(4, "little"))
    out += n.to_bytes(2, "little")
    blobs = bytearray()
    for tag, typ, count, payload in entries:
        if len(payload) <= 4:
            field = payload + b"\0" * (4 - len(payload))
        else:
            field = (data_off + len(blobs)).to_bytes(4, "little")
            blobs += payload + b"\0" * (len(payload) % 2)
        out += (tag.to_bytes(2, "little") + typ.to_bytes(2, "little")
                + count.to_bytes(4, "little") + field)
    return bytes(out + b"\0\0\0\0" + blobs)


def _srational(vals, den=1000000):
    return b"".join(int(round(v * den)).to_bytes(4, "little", signed=True)
                    + den.to_bytes(4, "little") for v in np.ravel(vals))


def _floats_le(a):
    return np.asarray(a, "<f4").tobytes()


def write_dcp(path, seed=0, dual=True, forward=True):
    """P1's camera profile: a dual-illuminant DCP (StdA / D65) for the
    synthetic camera (linear sRGB primaries), with ColorMatrix and
    ForwardMatrix pairs, a 90x30x1 HueSatMap per illuminant, a 36x8x16
    sRGB-encoded LookTable, a 9-point tone curve and a baseline exposure
    offset of +0.35: Adobe Standard's layout, smooth random tables.
    dual=False keeps the D65 illuminant's tags alone; forward=False
    leaves out the forward matrices."""
    from art_tpu_torch.color import colorspaces as cs

    rng = np.random.default_rng(seed)
    cm2 = cs.SRGB_D65_FROM_XYZ  # XYZ -> camera under D65
    warm = np.diag([1.06, 1.0, 0.9])
    cm1 = warm @ cm2
    fm = cs.MATRICES_RGB_TO_XYZ["sRGB"]

    def table(dims, hue_deg, sat, val):
        hd, sd, vd = dims
        h = np.linspace(0.0, 2 * np.pi, hd, endpoint=False)[None, :, None]
        s = np.linspace(0.0, 1.0, sd)[None, None, :]
        v = np.linspace(0.0, 1.0, vd)[:, None, None]
        ph = rng.uniform(0, 2 * np.pi, 3)
        t = np.zeros((vd, hd, sd, 3), np.float32)
        t[..., 0] = hue_deg * np.sin(h + ph[0]) * s
        t[..., 1] = 1.0 + sat * np.sin(2 * h + ph[1]) * s * (1 - 0.3 * v)
        t[..., 2] = 1.0 + val * np.cos(h + ph[2]) * s * (1 - v)
        return t

    hsm1 = table(HSM_DIMS, 6.0, 0.08, 0.03)
    hsm2 = table(HSM_DIMS, 4.0, 0.06, 0.02)
    look = table(LOOK_DIMS, 3.0, 0.1, 0.05)
    x = np.linspace(0.0, 1.0, 9)
    tc = np.stack([x, x + 0.12 * np.sin(2 * np.pi * x) * x * (1 - x) * 4],
                  axis=1)
    short = lambda v: int(v).to_bytes(2, "little")  # noqa: E731
    long3 = lambda d: b"".join(int(v).to_bytes(4, "little")  # noqa: E731
                               for v in d)
    if not dual:
        cm1, hsm1 = cm2, hsm2
    entries = [
        (50721, 10, 9, _srational(cm1)), (50778, 3, 1, short(17)),
        (50937, 4, 3, long3(HSM_DIMS)),
        (50938, 11, hsm1.size, _floats_le(hsm1)),
        (50940, 11, tc.size, _floats_le(tc)),
        (50981, 4, 3, long3(LOOK_DIMS)),
        (50982, 11, look.size, _floats_le(look)),
        (51108, 4, 1, (1).to_bytes(4, "little")),
        (51109, 10, 1, _srational([0.35], 100)),
    ]
    if dual:
        entries += [(50722, 10, 9, _srational(cm2)), (50779, 3, 1, short(21)),
                    (50939, 11, hsm2.size, _floats_le(hsm2))]
    if forward:
        entries.append((50964, 10, 9, _srational(fm)))
        if dual:
            entries.append((50965, 10, 9, _srational(fm)))
    with open(path, "wb") as f:
        f.write(_tiff_bytes(entries))


def _icc_bytes(tags, pcs=b"XYZ ", version=4):
    """An RGB-device ICC profile of these (signature, bytes) tags."""
    import struct

    table = struct.pack(">I", len(tags))
    off = 128 + 4 + 12 * len(tags)
    body = b""
    for sig, data in tags:
        table += sig + struct.pack(">II", off + len(body), len(data))
        body += data + b"\0" * ((-len(data)) % 4)
    hdr = bytearray(128)
    hdr[8] = version
    hdr[12:16] = b"mntr"
    hdr[16:20] = b"RGB "
    hdr[20:24] = pcs
    hdr[36:40] = b"acsp"
    struct.pack_into(">I", hdr, 0, 128 + len(table) + len(body))
    return bytes(hdr) + table + body


def _s15f16(vals):
    return b"".join(int(round(v * 65536)).to_bytes(4, "big", signed=True)
                    for v in np.ravel(vals))


def _u16(vals):
    return b"".join(int(round(v * 65535)).to_bytes(2, "big")
                    for v in np.clip(np.ravel(vals), 0.0, 1.0))


def _curv(samples=None):
    if samples is None:
        return b"curv\0\0\0\0" + (0).to_bytes(4, "big")
    return (b"curv\0\0\0\0" + len(samples).to_bytes(4, "big")
            + _u16(samples))


def write_para_icc(path, space="Rec2020",
                   para=(1 / 0.45, 1 / 1.099, 0.099 / 1.099, 1 / 4.5,
                         0.081), narrow=0.0):
    """P1's output profile: a v4 matrix profile of `space`'s primaries
    with a type-3 `para` TRC (by default Rec. 709's curve); narrow > 0
    moves each primary that share of the way to the white (a small
    gamut, as of a print)."""
    from art_tpu_torch.color import colorspaces as cs

    m = cs.MATRICES_RGB_TO_XYZ[space]
    m = (1.0 - narrow) * m + narrow * m.sum(axis=1, keepdims=True) / 3.0
    tags = [(sig, b"XYZ \0\0\0\0" + _s15f16(m[:, i]))
            for i, sig in enumerate((b"rXYZ", b"gXYZ", b"bXYZ"))]
    trc = b"para\0\0\0\0" + (3).to_bytes(2, "big") + b"\0\0" + _s15f16(para)
    tags += [(sig, trc) for sig in (b"rTRC", b"gTRC", b"bTRC")]
    with open(path, "wb") as f:
        f.write(_icc_bytes(tags))


def _lattice(g):
    """(g, g, g, 3) lattice coordinates in [0, 1], r along axis 0."""
    ax = np.linspace(0.0, 1.0, g)
    return np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1)


def write_lut_icc_in(path, grid=33):
    """P2's camera profile: a LUT-class v4 input profile whose A2B0 is an
    mAB (A curves: a square-root encode; a 33^3 CLUT: the square back,
    with 8% more saturation; M curves: a slight lift; a 3x4 matrix: the
    camera's primaries to XYZ in the PCS encoding, with an offset; B
    curves: identity), XYZ PCS."""
    from art_tpu_torch.color import colorspaces as cs

    xs = np.linspace(0.0, 1.0, 256)
    a_curves = [np.sqrt(xs)] * 3
    lat = _lattice(grid) ** 2
    y = lat.mean(axis=-1, keepdims=True)
    clut = np.clip(y + 1.08 * (lat - y), 0.0, 1.0)
    m_curves = [xs ** 0.97] * 3
    mat = cs.MATRICES_RGB_TO_XYZ["sRGB"] * (32768.0 / 65535.0) * 0.98
    mat34 = np.hstack([mat, np.full((3, 1), 0.002)])

    def curves(cs3):
        blob = b""
        for c in cs3:
            e = _curv(c)
            blob += e + b"\0" * ((-len(e)) % 4)
        return blob

    blobs = {"b": curves([None] * 3),
             "m": _s15f16(np.concatenate([mat34[:, :3].ravel(),
                                          mat34[:, 3]])),
             "mc": curves(m_curves),
             "cl": (bytes([grid] * 3 + [0] * 13) + bytes([2, 0, 0, 0])
                    + _u16(clut)),
             "a": curves(a_curves)}
    offs, body, pos = {}, b"", 32
    for key in ("b", "m", "mc", "cl", "a"):
        offs[key] = pos
        body += blobs[key]
        pos += len(blobs[key])
    tag = (b"mAB \0\0\0\0" + bytes([3, 3, 0, 0])
           + b"".join(offs[k].to_bytes(4, "big")
                      for k in ("b", "m", "mc", "cl", "a")) + body)
    with open(path, "wb") as f:
        f.write(_icc_bytes([(b"A2B0", tag)], pcs=b"XYZ "))


def write_lut_icc_out(path, grid=17):
    """P2's output profile: a LUT-class v2 profile whose B2A0 is an mft2
    (lut16) on the Lab PCS: identity curves and a 17^3 CLUT from the
    legacy 16-bit Lab encoding to sRGB-encoded device values."""
    from art_tpu_torch.color import colorspaces as cs

    lat = _lattice(grid)
    L = lat[..., 0] * (65535.0 / 652.8)
    a = lat[..., 1] * (65535.0 / 256.0) - 128.0
    b = lat[..., 2] * (65535.0 / 256.0) - 128.0
    fy = (L + 16.0) / 116.0
    f = np.stack([fy + a / 500.0, fy, fy - b / 200.0])
    eps, kappa = 216.0 / 24389.0, 24389.0 / 27.0
    xyz = np.where(f ** 3 > eps, f ** 3, (116.0 * f - 16.0) / kappa) \
        * cs.D50_WHITE[:, None, None, None]
    lin = np.tensordot(cs.MATRICES_XYZ_TO_RGB["sRGB"], xyz, axes=1)
    clut = np.moveaxis(cs.srgb_gamma(np.clip(lin, 0.0, 1.0)), 0, -1)
    ident = np.linspace(0.0, 1.0, 256)
    tag = (b"mft2\0\0\0\0" + bytes([3, 3, grid, 0]) + _s15f16(np.eye(3))
           + (256).to_bytes(2, "big") + (256).to_bytes(2, "big")
           + _u16(np.tile(ident, 3)) + _u16(clut) + _u16(np.tile(ident, 3)))
    with open(path, "wb") as f:
        f.write(_icc_bytes([(b"B2A0", tag)], pcs=b"Lab ", version=2))


def hald_image(level, bits=16):
    """A Hald CLUT image of `level` (level^3 pixels a side): the identity
    lattice through a film look (a gentle S-curve, a warm cast, 10% less
    saturation), as (H, W, 3) uint8 or uint16."""
    n = level * level
    ax = np.linspace(0.0, 1.0, n)
    b, g, r = np.meshgrid(ax, ax, ax, indexing="ij")  # r fastest
    rgb = np.stack([r, g, b], axis=-1).reshape(level ** 3, level ** 3, 3)
    y = rgb.mean(axis=-1, keepdims=True)
    rgb = y + 0.9 * (rgb - y)
    rgb = rgb + 0.06 * np.sin(np.pi * (rgb - 0.5)) * (1 - np.abs(2 * rgb - 1))
    rgb = np.clip(rgb * np.array([1.03, 1.0, 0.95]), 0.0, 1.0)
    top = (1 << bits) - 1
    return np.round(rgb * top).astype(np.uint16 if bits == 16 else np.uint8)


def write_hald(path, level=12, bits=16):
    """P3's Hald CLUT as a PNG (the port's writer: no filter)."""
    from art_tpu_torch.io.imagefile import write_png

    write_png(path, hald_image(level, bits))


CLF_TEXT = """<?xml version="1.0" encoding="UTF-8"?>
<ProcessList id="p3-look" compCLFversion="3">
  <Description>P3: log, a {n}^3 LUT, a matrix, a moncurve decode</Description>
  <Log inBitDepth="32f" outBitDepth="32f" style="cameraLinToLog">
    <LogParams base="2" logSideSlope="0.0570776" logSideOffset="0.5547945"
               linSideSlope="1" linSideOffset="0" linSideBreak="0.0078125"/>
  </Log>
  <LUT3D inBitDepth="32f" outBitDepth="16i" interpolation="tetrahedral">
    <Array dim="{n} {n} {n} 3">
{lut}
    </Array>
  </LUT3D>
  <Matrix inBitDepth="32f" outBitDepth="32f">
    <Array dim="3 3">
 1.06 -0.04 -0.02
-0.03  1.05 -0.02
-0.02 -0.05  1.07
    </Array>
  </Matrix>
  <Exponent inBitDepth="32f" outBitDepth="32f" style="monCurveFwd">
    <ExponentParams exponent="2.4" offset="0.055"/>
  </Exponent>
</ProcessList>
"""


def write_clf(path, n=33):
    """P3's CLF: ACEScct's camera log, a n^3 LUT3D (16-bit values) from
    log to a moncurve (sRGB-like) encode of the linear values times 0.9,
    a saturating matrix, the moncurve decode back to linear."""
    lat = _lattice(n)
    lin = np.where(lat <= 0.155251141552511, (lat - 0.0729055341958355)
                   / 10.5402377416545, 2.0 ** (lat * 17.52 - 9.72))
    lin = np.clip(lin * 0.9, 0.0, 1.0)
    enc = np.where(lin < 0.0031308, lin * 12.92,
                   1.055 * lin ** (1 / 2.4) - 0.055)
    rows = "\n".join(" ".join(str(int(round(v * 65535))) for v in px)
                     for px in enc.reshape(-1, 3))
    with open(path, "w") as f:
        f.write(CLF_TEXT.format(n=n, lut=rows))


CTL_TEXT = """// @ART-label: "P3 contrast and warmth"
// @ART-colorspace: "rec2020"
// @ART-lut: 32
// @ART-param: ["contrast", "Contrast", 0.5, 2.0, 1.2, 0.01]
// @ART-param: ["warmth", "Warmth", -1.0, 1.0, 0.2, 0.01]

const float pivot = 0.18;
const float lum[3] = { 0.2627, 0.678, 0.0593 };

float tone(float x, float c)
{
    if (x <= 0.0) {
        return 0.0;
    }
    float y = pivot * pow(x / pivot, c);
    if (y > 16.0) {
        return 16.0 + log2(y / 16.0);
    }
    return y;
}

void ART_main(varying float r, varying float g, varying float b,
              output varying float rout, output varying float gout,
              output varying float bout, float contrast, float warmth)
{
    float y = lum[0] * r + lum[1] * g + lum[2] * b;
    float ty = tone(y, contrast);
    float k = 1.0;
    if (y > 1e-6) {
        k = ty / y;
    }
    float w = 0.1 * warmth;
    rout = r * k * (1.0 + w);
    gout = g * k;
    bout = b * k * (1.0 - w);
}
"""


def write_ctl(path):
    """P3's CTL script: two @ART-params, @ART-lut: 32, a masked return
    in a function of a varying value."""
    with open(path, "w") as f:
        f.write(CTL_TEXT)


EXTLUT_SCRIPT = '''import json
import sys

import numpy as np


def cube(params, out, n=17):
    ax = np.linspace(0.0, 1.0, n)
    b, g, r = np.meshgrid(ax, ax, ax, indexing="ij")  # r fastest
    rgb = np.stack([r, g, b], axis=-1).reshape(-1, 3)
    y = rgb.mean(axis=1, keepdims=True)
    rgb = np.clip(y + params["saturation"] * (rgb - y), 0.0, 1.0)
    rgb = rgb ** (1.0 / params["gamma"])
    with open(out, "w") as f:
        f.write("LUT_3D_SIZE %d\\n" % n)
        for px in rgb:
            f.write("%.6f %.6f %.6f\\n" % tuple(px))


if sys.argv[1:2] == ["--server"]:
    while True:
        line = sys.stdin.readline()
        if not line:
            break
        out = sys.stdin.readline().strip()
        cube(json.loads(line), out)
        sys.stdout.write("Y1\\nwrote " + out + "\\n")
        sys.stdout.flush()
else:
    with open(sys.argv[1]) as f:
        cube(json.load(f), sys.argv[2])
'''


def write_extlut(directory, server=False):
    """P3's external LUT generator: a Python script (run with this
    interpreter) and its JSON config, one-shot or server; returns the
    config's path."""
    import shlex

    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "gen_look.py"), "w") as f:
        f.write(EXTLUT_SCRIPT)
    cmd = f"{shlex.quote(sys.executable)} gen_look.py"
    cfg = {"ART-lut3d": {
        "command": cmd + (" --server" if server else ""), "server": server,
        "label": "P3 look",
        "params": [["saturation", "Saturation", 0.0, 2.0, 0.85, 0.01],
                   ["gamma", "Gamma", 0.5, 2.0, 1.1, 0.01]]}}
    path = os.path.join(directory,
                        "look_server.json" if server else "look.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def p1_arp(files):
    """P1's settings: WB Custom at 5200 K, the DCP with its look at the
    late position, the matrix/para output profile."""
    return (f"[White Balance]\nEnabled=true\nSetting=Custom\n"
            f"Temperature={int(P1_TEMP)}\nGreen=1\nEqual=1\n"
            f"[Color Management]\nInputProfile={files['dcp']}\n"
            "ApplyLookTable=true\nApplyBaselineExposureOffset=true\n"
            "ApplyHueSatMap=true\nToneCurve=true\nDCPLookEarly=false\n"
            f"OutputProfile={files['para_icc']}\n")


def p2_arp(files):
    """P2's settings: the LUT-class input and output profiles."""
    return (f"[Color Management]\nInputProfile={files['lut_icc_in']}\n"
            f"OutputProfile={files['lut_icc_out']}\n")


def p3_arp(lut, after=False, strength=80):
    """P3's settings: a film simulation from `lut` at `strength`, before
    the curve or after it."""
    return (f"[Film Simulation]\nEnabled=true\nClutFilename={lut}\n"
            f"Strength={strength}\nAfterToneCurve={str(after).lower()}\n")


def profile_files(directory, level=12, seed=0):
    """Every file of P1-P3 in `directory`: name -> path."""
    os.makedirs(directory, exist_ok=True)
    files = {k: os.path.join(directory, v) for k, v in {
        "dcp": "camera.dcp", "para_icc": "rec709para.icc",
        "lut_icc_in": "camera_lut.icc", "lut_icc_out": "print_lut.icc",
        "hald": f"hald{level}.png", "clf": "look.clf",
        "ctl": "look.ctl"}.items()}
    write_dcp(files["dcp"], seed)
    write_para_icc(files["para_icc"])
    write_lut_icc_in(files["lut_icc_in"])
    write_lut_icc_out(files["lut_icc_out"])
    write_hald(files["hald"], level)
    write_clf(files["clf"])
    write_ctl(files["ctl"])
    files["json"] = write_extlut(os.path.join(directory, "extlut"))
    return files


def profile_pp(arp, pp=None):
    """The flagship (AMaZE, denoise 20/20, the Neutral curve) with `arp`
    on top, on pp (either package's)."""
    pp = flagship_pp("amaze", pp)
    pp.apply_arp_text(arp)
    return pp


# the gamut warning's marks, card against the CPU at SMALL2: a pixel whose
# round-trip delta lies within rounding of the 1e-4 threshold may flip
# between the devices (its colour moves by up to full scale); at most
# this share of the pixels, and the slice bounds beyond them
GAMUT_FLIPS = 1e-3


def profile_path(label, pp, frame, small, want, check_kernels=True):
    """One path of the profile phase: a develop with the counts from 0,
    which must launch each kernel of `want` once and no other (and no
    plain version); the median develop; the host plan, the device
    program (inputs resident), its peak memory and device ms by `art:`
    stage; with `check_kernels`, each kernel against its plain version
    on the path's own tensors; a develop of `small` on the card against
    the CPU. Returns (times, comparison, failures)."""
    from art_tpu_torch.pipeline import develop as tdev

    launches = drive(label, pp, frame, want)
    expect = {k: int(k in want) for k in launches}
    if launches != expect:
        raise RuntimeError(f"{label}: launches {launches}, want {expect}")
    median_develop(label, frame, pp)
    times = program_times(label, frame, pp)
    failures = kernels_against_plain(
        label, lambda: tdev.develop(frame, pp), want) if check_kernels \
        else []
    return times, card_vs_cpu(label, small, pp), failures


def profile_phase(smi_line, tmp):
    """The colour profiles and LUTs on the card, on the flagship frame
    and profile (AMaZE, denoise 20/20, the Neutral curve), counts reset
    before each path: P1, a DCP camera profile (`write_dcp`: two
    illuminants, HueSatMaps, an sRGB-encoded look table late, a tone
    curve, +0.35 EV) under Custom WB at 5200 K, to a v4 matrix/para .icc;
    P2, LUT-class .icc profiles in (mAB, 33^3) and out (mft2 on Lab,
    17^3); each launches B1-B3, B4 with no raw head and B7 with no
    epilogue. P3, the four film-simulation files at strength 80: a
    level-12 16-bit Hald PNG, a CLF, a CTL script (after the curve: B7
    with no epilogue) and an external generator, then the Hald run
    through cli.main with a gamut warning (ProPhoto out, an sRGB proof).
    Each path as profile_path runs it; also the Hald's decode, the CTL
    bake on the card against the CPU's, and the gamut warning's time at
    24 MP and its marks card against CPU. Returns (the comparisons, the
    failures)."""
    from art_tpu_torch.color import ctl
    from art_tpu_torch.color.gamutwarning import paint_gamut_warning
    from art_tpu_torch.color.lut3d import load_hald_clut
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- profile phase ({smi_line})")
    t_phase = time.monotonic()
    t0 = time.monotonic()
    files = profile_files(tmp)
    log(f"profile files (a DCP, four .icc, a level-12 16-bit Hald PNG of "
        f"{os.path.getsize(files['hald']) / 1e6:.1f} MB, a CLF, a CTL "
        f"script, a generator) written in {time.monotonic() - t0:.2f} s")
    t0 = time.monotonic()
    table = load_hald_clut(files["hald"])
    log(f"Hald CLUT decode (host, io/imagefile.py): "
        f"{1e3 * (time.monotonic() - t0):.1f} ms -> {table.shape}")
    frame = flagship_frame(*FRAME)
    small = flagship_frame(*SMALL2, seed=5)
    want = ("b1", "b2", "b3", "b4", "b7")
    stats, failures = {}, []

    def planned(label, pp, check):
        t0 = time.monotonic()
        config, _ = tdev.plan(frame, pp)
        gates = tdev.fusion_gates(config)
        log(f"{label} plan {1e3 * (time.monotonic() - t0):.1f} ms: steps "
            f"{[s[0] for s in config.steps]}, dcp {config.dcp}, input TRC "
            f"{str(config.icc_input_trc)[:60]}, output TRC "
            f"{str(config.out_trc)[:60]}, fusion gates {gates}")
        if not check(config, gates):
            raise RuntimeError(f"{label} planned {config}")

    pp = profile_pp(p1_arp(files))
    planned("P1", pp, lambda c, g: (
        c.dcp is not None and c.dcp[0] and c.out_trc[0] == "para"
        and [s[0] for s in c.steps] == ["denoise", "dcplook_late",
                                        "tonecurve"]
        and g == (False, False)))
    _, stats["P1"], f = profile_path("P1", pp, frame, small, want)
    failures += f
    pp = profile_pp(p2_arp(files))
    planned("P2", pp, lambda c, g: (
        c.icc_input_trc[0] == c.out_trc[0] == "icclut"
        and g == (False, False)))
    _, stats["P2"], f = profile_path("P2", pp, frame, small, want)
    failures += f
    for kind in ("hald", "clf", "ctl", "json"):
        after = kind == "ctl"
        pp = profile_pp(p3_arp(files[kind], after=after))
        step = "filmsim_post" if after else "filmsim_pre"
        planned(f"P3 {kind}", pp, lambda c, g, step=step, after=after: (
            step in [s[0] for s in c.steps] and g == (True, not after)))
        _, stats[f"P3 {kind}"], f = profile_path(
            f"P3 {kind}", pp, frame, small, want,
            check_kernels=kind in ("hald", "ctl"))
        failures += f

    # the CTL bake on the card (the planning device) against the CPU's
    script = ctl.load_ctl(files["ctl"])
    ctl.bake_lut(script, device="cuda")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    on_card = ctl.bake_lut(script, device="cuda")
    card_ms = 1e3 * (time.monotonic() - t0)
    t0 = time.monotonic()
    on_cpu = ctl.bake_lut(script, device="cpu")
    cpu_ms = 1e3 * (time.monotonic() - t0)
    rel = float(np.max(np.abs(on_card.astype(np.float64) - on_cpu)
                       / np.maximum(1.0, np.abs(on_cpu))))
    log(f"CTL bake ({on_card.shape[0]}^3, the interpreter over the shaper "
        f"lattice): card {card_ms:.1f} ms (second call), CPU {cpu_ms:.1f} "
        f"ms; card vs CPU max {rel:.3g} of max(1, |value|)")
    if rel > 1e-5:
        failures.append(f"CTL bake: card vs CPU {rel}")

    # the gamut warning: the Hald run through the CLI to ProPhoto, proofed
    # against sRGB
    dng = os.path.join(tmp, "flagship.dng")
    write_dng(dng, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, compress=False)
    arp = os.path.join(tmp, "p3_gamut.arp")
    with open(arp, "w") as f:
        f.write(p3_arp(files["hald"]) + "[Color Management]\n"
                "OutputProfile=RTv4_ProPhoto\n")
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "art_tpu_torch", "data", "profiles", PROFILE)
    dn = os.path.join(tmp, "denoise20.arp")
    with open(dn, "w") as f:
        f.write("[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n")
    out = os.path.join(tmp, "p3_gamut.jpg")
    argv = ["-Y", "-p", base, "-p", dn, "-p", arp, "--gamut-warn", "sRGB",
            "-o", out, "-c", dng]
    reset_counts()
    phases, seconds = cli_run(argv)
    launches, plain_calls = read_counts()
    log(f"P3 gamut through cli.main: {1e3 * seconds:.1f} ms end to end "
        f"(first); phases {phases}; launches {launches}; plain calls "
        f"{plain_calls}")
    if launches != {k: int(k in want) for k in launches} \
            or any(plain_calls.values()) or "gamut warning" not in phases:
        raise RuntimeError(f"P3 gamut: launches {launches}, phases "
                           f"{phases}")
    check_jpeg(out)
    cli_timed("P3 gamut (4000x6000 DNG, Hald film simulation, ProPhoto "
              "JPEG, an sRGB proof)", argv, runs=1)
    from art_tpu_torch import cli

    pp = cli.compose_params(dng, cli.parse_args(argv))
    dev = tdev.develop(frame, pp)
    ms = gpu_ms(lambda: paint_gamut_warning(dev, "ProPhoto", "sRGB"), 5)
    _, mask = paint_gamut_warning(dev, "ProPhoto", "sRGB")
    log(f"gamut warning at {tuple(dev.shape)} on the card: {ms:.3f} ms "
        f"(mean of 5); marked share {float(mask.double().mean()):.4f}")
    del dev
    g, gm = paint_gamut_warning(tdev.develop(small, pp), "ProPhoto", "sRGB")
    c, cm = paint_gamut_warning(tdev.develop(small, pp, device="cpu"),
                                "ProPhoto", "sRGB")
    st = flip_parity(g.cpu(), c, gm.cpu(), cm, 0)
    log(f"{SMALL2[0]}x{SMALL2[1]} P3 gamut develop, card vs CPU plain path: "
        f"{st}")
    if (st["flip_share"] > GAMUT_FLIPS
            or st["max_lsb8_beyond_flips"] > DEV_MAX * 255
            or st["mean"] > DEV_MEAN or st["within_1lsb8"] < DEV_WITHIN):
        failures.append(f"P3 gamut: card disagrees with the CPU: {st}")
    log(f"profile phase: {time.monotonic() - t_phase:.1f} s")
    return stats, failures


# ---- region masks (M1) and the host autos and scopes (M2)

MASK_PNG = (1000, 1500)
# the drawn strokes, n;radius;draw(1)/erase(0);opacity;x0;y0;... in frame
# units: a wave across the upper third, a softer arc, an erase through
# the first
_WAVE = [(0.1 + 0.8 * i / 23, 0.25 + 0.08 * np.sin(i / 3.0))
         for i in range(24)]
_ARC = [(0.3 + 0.4 * np.cos(np.pi * i / 15), 0.7 - 0.25 * np.sin(
    np.pi * i / 15)) for i in range(16)]
_ERASE = [(0.3 + 0.04 * i, 0.2 + 0.012 * i) for i in range(10)]


def _strokes(groups):
    out = []
    for radius, draw, opacity, pts in groups:
        out += [len(pts), radius, draw, opacity]
        for x, y in pts:
            out += [round(x, 4), round(y, 4)]
    return ";".join(f"{v:g}" for v in out) + ";"


M1_STROKES = _strokes([(0.15, 1, 1.0, _WAVE), (0.25, 1, 0.6, _ARC),
                       (0.08, 0, 1.0, _ERASE)])

M1_ARP = """[Local Contrast]
Enabled=true
Contrast_1=40
MaskName_1=sky
AreaMaskEnabled_1=true
AreaMaskBlur_1=3
AreaMask0Type_1=rectangle
AreaMask0X_1=-10
AreaMask0Y_1=-35
AreaMask0Width_1=75
AreaMask0Height_1=45
AreaMask0Angle_1=30
AreaMask0ShapeFeather_1=25
AreaMask1Type_1=polygon
AreaMask1Knots_1=-40;-60;0;10;-20;0;40;-70;0;20;10;0;-30;0;0;
AreaMask1ShapeFeather_1=5
AreaMask1Mode_1=subtract

[Smoothing]
Enabled=true
Mode_1=3
Channel_1=0
NLStrength_1=40
NLDetail_1=50
LinkedMaskEnabled_1=true
LinkedMask_1=localcontrast|sky
LinkedMaskInverted_1=true

[ColorCorrection]
Enabled=true
Mode_1=RGB
SlopeR_1=1.12
SlopeB_1=0.9
OffsetG_1=0.01
PowerR_1=0.95
DrawnMaskEnabled_1=true
DrawnMaskMode_1=1
DrawnMaskSmoothness_1=0.5
DrawnMaskFeather_1=20
DrawnMaskContrast_1=1;0;0;0.3;0.2;0.7;0.85;1;1;
DrawnMaskStrokes_1={strokes}

[TextureBoost]
Enabled=true
Strength_1=0.6
DetailThreshold_1=1.5
Iterations_1=1
ExternalMaskEnabled_1=true
ExternalMaskFilename_1={mask}
ExternalMaskFeather_1=10
"""


def m1_arp(mask):
    """M1's region tools beyond the flagship profile: Local Contrast under
    an area mask named `sky` (a rectangle turned 30 degrees, feather 25,
    less a non-convex 5-knot polygon, area blur 3); Smoothing's NLMeans
    on luminance under the inverted linked mask `localcontrast|sky`;
    Colour Correction (RGB) under three stroke groups, one an erase
    (drawn mode 1, smoothness 0.5, feather 20, a contrast curve); Texture
    Boost under the external mask file `mask` (feather 10, the guided
    filter). The geometry is relative to the frame, so one profile serves
    every size."""
    return M1_ARP.format(strokes=M1_STROKES, mask=mask)


def m1_pp(mask, pp=None):
    """M1's ProcParams on pp (either package's): the flagship profile
    (AMaZE, denoise 20/20, the Neutral curve) and `m1_arp`."""
    pp = flagship_pp("amaze", pp)
    pp.apply_arp_text(m1_arp(mask))
    return pp


def write_mask_png(path, h=MASK_PNG[0], w=MASK_PNG[1], seed=0):
    """M1's external mask: a 16-bit greyscale PNG (colour type 0, which
    Pillow opens as I;16) of a soft blob and a ramp with 1% noise,
    written with zlib (the card's machine has no PIL)."""
    import struct
    import zlib

    yy, xx = np.mgrid[0:h, 0:w]
    yy, xx = yy / h, xx / w
    blob = np.exp(-((xx - 0.6) ** 2 / 0.04 + (yy - 0.45) ** 2 / 0.06))
    v = 0.7 * blob + 0.3 * xx + np.random.default_rng(seed).normal(
        0.0, 0.01, (h, w))
    plane = np.round(np.clip(v, 0.0, 1.0) * 65535.0).astype(">u2")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           plane.view(np.uint8).reshape(h, -1)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))
    return path


def m2_pp(pp=None):
    """M2's ProcParams on pp (either package's): the flagship profile
    with white balance Auto (grey world)."""
    pp = flagship_pp("amaze", pp)
    pp.wb.method = "Auto"
    return pp


@contextlib.contextmanager
def timed_calls(parts):
    """Yields a dict label -> [seconds of each call] of the functions
    `parts` names ({label: (module, name)}) inside the block, the card
    synchronised before and after each call, so the host's part and the
    card's part of a plan read apart."""
    seconds = {label: [] for label in parts}
    saved = []
    for label, (module, name) in parts.items():
        fn = getattr(module, name)
        saved.append((module, name, fn))

        def timed(*args, _fn=fn, _label=label, **kwargs):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[_label].append(time.monotonic() - t0)
            return out

        setattr(module, name, timed)
    try:
        yield seconds
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def mask_plan_parts(label, frame, pp):
    """One host plan with its mask parts timed apart: the area and drawn
    rasterisers and the external mask's load, and inside them the host
    fills, the card's blurs, the decode and the resample. Returns the
    plan's ms and {part: ms}."""
    from art_tpu_torch import masks
    from art_tpu_torch.io import imagefile
    from art_tpu_torch.masks import raster
    from art_tpu_torch.pipeline import develop as tdev

    parts = {"area rasterise": (masks, "rasterize_area"),
             "drawn rasterise": (masks, "rasterize_drawn"),
             "external decode+resize": (masks, "load_external_mask"),
             "  polygon fills (host)": (raster, "fill_poly"),
             "  disc stamps (host)": (raster, "circle_cover"),
             "  Gaussian blurs (card)": (raster, "gaussian_blur"),
             "  decode (host)": (imagefile, "read_grey"),
             "  PIL resample (card)": (raster, "pil_resize_bilinear")}
    with timed_calls(parts) as seconds:
        t0 = time.monotonic()
        tdev.plan(frame, pp)
        plan_ms = 1e3 * (time.monotonic() - t0)
    ms = {k: 1e3 * sum(v) for k, v in seconds.items()}
    log(f"{label} host plan (synchronised around each part) {plan_ms:.1f} "
        "ms, of it: " + "; ".join(
            f"{k.strip()} {ms[k]:.1f} ms ({len(seconds[k])} calls)"
            for k in parts))
    return plan_ms, ms


def mask_phase(smi_line, tmp):
    """The region masks and the host autos and scopes on the card, on the
    flagship frame and profile (AMaZE, denoise 20/20, the Neutral curve),
    counts reset before each path. M1 (`m1_pp`): Local Contrast under an
    area mask (a rotated rectangle, feather 25, less a non-convex
    polygon), Smoothing's NLMeans under the inverted linked mask,
    Colour Correction under three stroke groups, Texture Boost under a
    1000x1500 16-bit grey PNG resampled to the frame (`write_mask_png`);
    B1-B4, B6 and B7 once each, each held to its plain version on M1's
    tensors (B6 on the Smoothing region's own), as profile_path runs it,
    with the host plan's mask parts timed apart. M2 (`m2_pp`): the
    flagship with WB Auto through process_image with a listener that
    takes the histogram and the auto WB report; B1-B4 and B7 once. Each
    with its device program, peak memory, device ms by `art:` stage and
    a 512x1024 develop against the CPU. Returns (the comparisons, the
    failures)."""
    from art_tpu_torch.ops import denoise
    from art_tpu_torch.pipeline import develop as tdev
    from art_tpu_torch.pipeline.listeners import PipelineListener
    from art_tpu_torch.pipeline.scopes import histogram_rgbl

    log(f"---- mask phase ({smi_line})")
    t_phase = time.monotonic()
    mask = write_mask_png(os.path.join(tmp, "m1_mask.png"))
    frame = flagship_frame(*FRAME)
    small = flagship_frame(*SMALL, seed=5)
    stats, failures = {}, []

    pp = m1_pp(mask)
    config, _ = tdev.plan(frame, pp)
    steps = [st[0] for st in config.steps]
    log(f"M1 steps {steps}; fusion gates {tdev.fusion_gates(config)}")
    if not {"localcontrast", "smoothing", "colorcorrection",
            "textureboost"} <= set(steps):
        raise RuntimeError(f"M1 planned {steps}")
    mask_plan_parts("M1", frame, pp)
    want = ("b1", "b2", "b3", "b4", "b6", "b7")
    _, stats["M1"], f = profile_path("M1", pp, frame, small, want)
    failures += f
    with record_args(denoise, "nlmeans") as calls:
        tdev.develop(frame, pp)
    if len(calls) != 1:
        raise RuntimeError(f"M1: B6 ran {len(calls)} times, want 1")
    y, maskinv = calls[0][0]
    if not b6_case("M1 smoothing's luma (under the linked mask)", y,
                   maskinv):
        failures.append("M1: B6 disagrees with its plain version")
    del calls, y, maskinv

    class Scoped(PipelineListener):
        wb = hist = None

        def auto_wb_changed(self, temp, green):
            self.wb = (temp, green)

        def histogram_changed(self, hist_rgbl):
            self.hist = hist_rgbl

    pp = m2_pp()
    want = ("b1", "b2", "b3", "b4", "b7")
    runs = []
    for i in range(3):
        listener = Scoped()
        reset_counts()
        t0 = time.monotonic()
        out = tdev.process_image(frame, pp, listener=listener)
        runs.append(time.monotonic() - t0)
        if i == 0:
            launches, plain_calls = read_counts()
            log(f"M2 process_image {FRAME[0]}x{FRAME[1]} (first): "
                f"{runs[0]:.3f} s; launches {launches}; plain calls "
                f"{plain_calls}; auto WB reported {listener.wb}")
            if launches != {k: int(k in want) for k in launches} \
                    or any(plain_calls.values()):
                raise RuntimeError(f"M2: launches {launches}, plain "
                                   f"{plain_calls}")
            if listener.wb is None or listener.hist is None or any(
                    int(listener.hist[k].sum()) != out[0].size
                    for k in "rgb"):
                raise RuntimeError("M2: the listener missed the auto WB "
                                   "or the histogram")
            if out.shape != (3, *FRAME) or not np.isfinite(out).all():
                raise RuntimeError(f"M2: bad output {out.shape}")
    log(f"M2 process_image (plan + H2D + device + D2H + histogram), median "
        f"of 3: {1e3 * float(np.median(runs)):.1f} ms "
        f"{[round(1e3 * t, 1) for t in runs]}")
    t0 = time.monotonic()
    histogram_rgbl(np.clip(out, 0.0, 1.0) * 65535.0)
    log(f"M2 histogram_rgbl of the 24 MP float output (host numpy): "
        f"{1e3 * (time.monotonic() - t0):.1f} ms")
    del out
    program_times("M2", frame, pp)
    failures += kernels_against_plain(
        "M2", lambda: tdev.develop(frame, pp), want)
    stats["M2"] = card_vs_cpu("M2", small, pp)
    log(f"mask phase: {time.monotonic() - t_phase:.1f} s")
    return stats, failures


MATCHED_ARP = "Auto-Matched Curve.arp"


def matched_pp(pp=None):
    """The bundled Auto-Matched Curve.arp on pp (either package's):
    histogram matching, AMaZE, the Neutral curve mode, nothing else."""
    if pp is None:
        from art_tpu_torch.params import ProcParams

        pp = ProcParams()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "art_tpu_torch", "data", "profiles",
                           MATCHED_ARP)) as f:
        pp.apply_arp_text(f.read())
    return pp


def preview_look(rgb):
    """A camera's rendition of a scene for its embedded preview: a
    tone-mapped, contrasty look (an S-curve over a 0.8 power)."""
    return np.clip(0.5 - 0.5 * np.cos(np.pi * rgb ** np.float32(0.8)), 0.0,
                   1.0)


def h1_dng(path, h, w, seed=0):
    """H1's file: the flagship frame of `seed` as an uncompressed DNG
    (black 512, white 16383) with a full-size JPEG preview of its scene
    (`preview_look`, quality 90, 4:2:0, as write_dng writes it)."""
    from art_tpu_torch.core.image import synthesize_bayer
    from art_tpu_torch.io.dngwrite import write_dng

    rgb = flagship_scene(h, w, seed)
    frame = synthesize_bayer(rgb, pattern="RGGB")
    write_dng(path, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, compress=False, preview_rgb01=preview_look(rgb))
    return path


def matched_points(frame, pp, device):
    """One plan on `device`: the host plan's seconds, the matched points
    it reported and the shape of the tone curve's fit ((1, K) or (2, K)
    take B7; more rows are segments, plain math as in the reference)."""
    from art_tpu_torch.pipeline import develop as tdev
    from art_tpu_torch.pipeline.listeners import _Collect

    t0 = time.monotonic()
    with _Collect() as report:
        _, data = tdev.plan(frame, pp, device=device)
    fit = tuple(data["op:tonecurve"]["coeffs"].shape) \
        if "op:tonecurve" in data else None
    return time.monotonic() - t0, report.get("matched_curve"), fit


def jpeg_phase(smi_line, tmp, entries):
    """The JPEG decoder and histogram matching on the card, counts reset
    before each path. H1: the bundled Auto-Matched Curve.arp on the
    flagship frame as a DNG with a full-size 4000x6000 preview (`h1_dng`):
    the host plan split into the preview's decode, the neutral render
    (the 1/8 frame on the card), the two sorts and quantiles and the
    rest; the develop, the device program and its `art:` stages; the
    matched points; B1-B3 once each and no other (B7 too where the
    matched curve's LUT fits one split polynomial; a kinked one runs on
    segments, plain math, as in the reference), each held to its plain
    version on H1's tensors (kernels-line entries `b*_h1`); a 512x1024
    file on the card against the CPU, with the matched points of both. H2: the same file through cli.main
    with the bundled profile to a JPEG, its phases. J1: the decoder alone
    on the 24 MP preview, a level-8 Hald JPEG (512x512) and a 1000x1500
    mask as JPEG, then one develop each of P3's Hald path and M1's
    external-mask path with those JPEGs in place of the PNGs. Returns
    (the comparisons, the failures)."""
    from art_tpu_torch.demosaic import amaze_kernel as ak
    from art_tpu_torch.io import jpeg, jpegdec, metadata
    from art_tpu_torch.io.rawfile import load_raw
    from art_tpu_torch.ops import tonecurve_neutral as tn
    from art_tpu_torch.pipeline import autos
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- JPEG phase ({smi_line})")
    t_phase = time.monotonic()
    stats, failures = {}, []
    t0 = time.monotonic()
    path = h1_dng(os.path.join(tmp, "h1.dng"), *FRAME)
    small_path = h1_dng(os.path.join(tmp, "h1_small.dng"), *SMALL, seed=5)
    (off, length), = metadata.harvest(path)[1]
    log(f"H1 files: a {FRAME[0]}x{FRAME[1]} DNG with a {length / 1e6:.1f} MB "
        f"full-size preview, and a {SMALL[0]}x{SMALL[1]} one, written in "
        f"{time.monotonic() - t0:.1f} s")
    frame = load_raw(path)
    pp = matched_pp()

    # H1: the first develop with the counts from 0 (the fit of the matched
    # curve decides whether B7 is on the path: read from one plan)
    _, _, fit = matched_points(frame, pp, "cuda")
    # the Neutral curve takes B7 only where its LUT fits one split
    # polynomial; a matched spline's knots leave segment fits, which run
    # as plain math (the reference's XLA path, tonecurve_neutral.py:417)
    want = ("b1", "b2", "b3", "b7") if fit and fit[0] in (1, 2) \
        else ("b1", "b2", "b3")
    log(f"H1 tone curve fit {fit}: kernels of the path {want}")
    launches = drive("H1", pp, frame, want)
    if launches != {k: int(k in want) for k in launches}:
        raise RuntimeError(f"H1: launches {launches}, want {want} once")
    # the warm plan's parts, synchronised around each
    parts = {"preview decode (host)": (metadata, "embedded_thumb"),
             "neutral render (card)": (autos, "histogram_matching_render"),
             "sorts + quantiles (host)": (autos, "histogram_matching_curve")}
    with timed_calls(parts) as seconds:
        plan_s, points, _ = matched_points(frame, pp, "cuda")
    ms = {k: 1e3 * sum(v) for k, v in seconds.items()}
    rest = 1e3 * plan_s - sum(ms.values())
    log(f"H1 host plan (warm) {1e3 * plan_s:.1f} ms, of it: " + "; ".join(
        f"{k} {v:.1f} ms" for k, v in ms.items()) + f"; the rest {rest:.1f} "
        "ms")
    if points is None or len(points) < 7:
        raise RuntimeError(f"H1: no matched curve ({points})")
    log(f"H1 matched points ({(len(points) - 3) // 2} knots): "
        + ", ".join(f"{p:.6f}" for p in points))
    times = []
    for _ in range(2):
        t0 = time.monotonic()
        tdev.develop(frame, pp)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    log(f"H1 develop (plan + H2D + device + crop): "
        f"{[round(1e3 * t, 1) for t in times]} ms")
    program_times("H1", frame, pp, n=3)
    with contextlib.ExitStack() as stack:
        calls = {k: stack.enter_context(record_args(mod, name))
                 for k, (mod, name) in {
                     "b1": (ak, "amaze_stage1"), "b2": (ak, "amaze_stage2"),
                     "b3": (ak, "amaze_stage3"),
                     "b7": (tn, "neutral_tone")}.items()}
        tdev.develop(frame, pp)
    from art_tpu_torch.demosaic import amaze

    for key, kern, plain, name, source, replaces in (
            ("b1", ak.amaze_stage1, amaze.stage1_plain, "AMaZE stage 1",
             "art_tpu_torch/csrc/amaze.cu",
             "art_tpu/demosaic/amaze_pallas.py:65"),
            ("b2", ak.amaze_stage2, amaze.stage2_plain, "AMaZE stage 2",
             "art_tpu_torch/csrc/amaze.cu",
             "art_tpu/demosaic/amaze_pallas.py:65"),
            ("b3", ak.amaze_stage3, amaze.stage3_plain, "AMaZE stage 3",
             "art_tpu_torch/csrc/amaze.cu",
             "art_tpu/demosaic/amaze_pallas.py:65"),
            ("b7", tn.neutral_tone, tn.neutral_plain,
             "neutral_tone with the matched curve",
             "art_tpu_torch/csrc/neutral_tone.cu",
             "art_tpu/ops/tonecurve_neutral.py:384")):
        if len(calls[key]) != int(key in want):
            failures.append(f"H1: {key} ran {len(calls[key])} times")
        if not calls[key]:
            continue
        args, kwargs = calls[key][0]
        entries[f"{key}_h1"] = variant_entry(
            f"{name} on H1's tensors ({key.upper()})", key, source, replaces,
            launches[key], lambda: kern(*args, **kwargs),
            lambda: plain(*args, **kwargs),
            tuple(a for a in args if isinstance(a, torch.Tensor)))
    del calls
    small = load_raw(small_path)
    _, card_pts, _ = matched_points(small, pp, "cuda")
    _, cpu_pts, _ = matched_points(small, pp, "cpu")
    gap = float(np.abs(np.subtract(card_pts, cpu_pts)).max()) \
        if len(card_pts) == len(cpu_pts) else float("inf")
    log(f"H1 {SMALL[0]}x{SMALL[1]} matched points, card against CPU: "
        f"{len(card_pts)} and {len(cpu_pts)} values, max difference {gap:.3g}")
    if gap > 1e-6:
        failures.append(f"H1: matched points differ between card and CPU "
                        f"by {gap}")
    stats["H1"] = card_vs_cpu("H1", small, pp)

    # H2: the ART-cli user's export with the bundled profile
    arp = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "art_tpu_torch", "data", "profiles", MATCHED_ARP)
    out = os.path.join(tmp, "h2.jpg")
    reset_counts()
    cli_timed("H2", ["-Y", "-p", arp, "-o", out, "-c", path], runs=1)
    launches2, plain_calls = read_counts()
    log(f"H2 launches over the 2 runs {launches2}; plain calls "
        f"{plain_calls}")
    if launches2 != {k: 2 * int(k in want) for k in launches2} \
            or any(plain_calls.values()):
        raise RuntimeError(f"H2: launches {launches2}, plain {plain_calls}")
    check_jpeg(out)

    # J1: the decoder alone, then P3's and M1's paths with JPEG files
    with open(path, "rb") as f:
        f.seek(off)
        blob = f.read(length)
    hald = os.path.join(tmp, "hald8.jpg")
    with open(hald, "wb") as f:
        f.write(jpeg.encode(hald_image(8, 8), quality=95, subsampling=3))
    mask_png = write_mask_png(os.path.join(tmp, "mask.png"))
    from art_tpu_torch.io.imagefile import read_grey

    grey = (read_grey(mask_png)[0] >> 8).astype(np.uint8)
    mask = os.path.join(tmp, "mask.jpg")
    with open(mask, "wb") as f:
        f.write(jpeg.encode(np.repeat(grey[..., None], 3, 2), quality=92))
    for label, buf in (("24 MP preview", blob),
                       ("level-8 Hald (512x512)", open(hald, "rb").read()),
                       ("1000x1500 mask", open(mask, "rb").read())):
        ts = []
        for _ in range(3):
            t0 = time.monotonic()
            arr = jpegdec.decode_rgb(buf)
            ts.append(time.monotonic() - t0)
        log(f"J1 decode of the {label} ({len(buf) / 1e6:.2f} MB, "
            f"{arr.shape[1]}x{arr.shape[0]}): median of 3 "
            f"{1e3 * float(np.median(ts)):.1f} ms "
            f"{[round(1e3 * t, 1) for t in ts]}")
    flag = flagship_frame(*FRAME)
    drive("J1 P3 (Hald JPEG)", profile_pp(p3_arp(hald)), flag,
          ("b1", "b2", "b3", "b4", "b7"))
    drive("J1 M1 (mask JPEG)", m1_pp(mask), flag,
          ("b1", "b2", "b3", "b4", "b6", "b7"))
    log(f"JPEG phase: {time.monotonic() - t_phase:.1f} s")
    return stats, failures


# X1's raw format: an extension of a raw the native decoder does not read
# (Leaf's), so load_raw hands it to the registered preconverter
X1_EXT = "mos"
# X1, T1 and N1 run at half the flagship's rows (the full width): the
# entry phase is host-bound (X1's preconversion, N1's file writes and
# loads), and its depth was cut to make room for the output phase
ENTRY_FRAME = (FRAME[0] // 2, FRAME[1])


def write_pgm16(path, mosaic):
    """A (H, W) uint16 mosaic as a binary 16-bit PGM (P5, big-endian), the
    input of the shipped preconverter."""
    h, w = mosaic.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n65535\n" % (w, h))
        f.write(np.asarray(mosaic, ">u2").tobytes())
    return path


def write_jpeg_tiff(path, rgb8, rows=256, quality=90):
    """A JPEG-compressed TIFF (compression 7) as a camera or scanner
    writes one: YCbCr 4:2:0 strips of `rows` rows, each a whole JPEG from
    the port's encoder (photometric 6, YCbCrSubsampling 2, 2)."""
    import struct

    from art_tpu_torch.io import jpeg

    h, w = rgb8.shape[:2]
    strips = [jpeg.encode(np.ascontiguousarray(rgb8[y : y + rows]),
                          quality=quality, subsampling=1)
              for y in range(0, h, rows)]
    offs = np.cumsum([8] + [len(b) for b in strips[:-1]])
    ifd_at = 8 + sum(len(b) for b in strips)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
               (259, 3, [7]), (262, 3, [6]),
               (273, 4, [int(o) for o in offs]), (277, 3, [3]),
               (278, 4, [rows]), (279, 4, [len(b) for b in strips]),
               (284, 3, [1]), (530, 3, [2, 2])]
    ext_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd, extra = struct.pack("<H", len(entries)), b""
    for tag, typ, vals in entries:
        raw = struct.pack("<" + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(raw) <= 4:
            ifd += struct.pack("<HHI", tag, typ, len(vals)) + raw.ljust(4,
                                                                       b"\0")
        else:
            ifd += struct.pack("<HHII", tag, typ, len(vals),
                               ext_at + len(extra))
            extra += raw
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", ifd_at) + b"".join(strips)
                + ifd + struct.pack("<I", 0) + extra)
    return path


def timed(fn, runs=2):
    """fn's result and the median of `runs` calls' seconds (host clock)."""
    ts = []
    for _ in range(runs):
        t0 = time.monotonic()
        out = fn()
        ts.append(time.monotonic() - t0)
    return out, float(np.median(ts))


# N1's host ms (decode, ICC conversion, load_image) by label, and its
# Adobe RGB JPEG's decoded 8-bit RGB ("rgb8"), kept by entry_phase for
# I1's comparison and I1's photo
N1_MS = {}
N1_PHOTO = {}


def entry_phase(smi_line, tmp):
    """The package's entry points on the card, counts reset before each
    path, at ENTRY_FRAME (half the flagship's rows, the full width). X1:
    the flagship frame (seed 0) as a 16-bit PGM under a raw
    extension the native decoder does not read (.mos), registered through
    `init(user_settings_dir=...)` with `<user>/imageio/pnm.txt` for the
    shipped `art_tpu_torch/preconverters/pnm_to_dng.py`, through cli.main
    with the bundled profile and denoise 20/20: the first call (the
    preconversion subprocess in its decode), the cached second, the
    phases (one run after a warm run), B1-B4 and B7 once each and no
    plain version, each held to its plain version on X1's tensors, the
    JPEG well formed with its scan byte-equal to cli.main's on the cached
    DNG itself; a 512x768 .mos through the same path, card against the
    CPU. T1: `thumbnail` of a DNG with no preview (a fast develop
    of ProcParams(); its launches as its plan says) and of H1's DNG with
    a full-size preview (no launch), both timed (first and second call).
    N1: `load_image` of non-raw files on the host (one call each),
    decode and conversion timed apart: an 8-bit RGB PNG, a 16-bit grey
    PNG (I;16), a JPEG-compressed TIFF (YCbCr 4:2:0 strips), an 8-bit
    JPEG with an Adobe RGB matrix/TRC profile (`color/iccwrite.py`; the
    LittleCMS model); then an [ART ImageIO] loader for an unknown
    extension; then the PNG through cli.main: exit code 2, the error
    naming non-raw input, no file written. Returns (the comparisons, the
    failures)."""
    import shutil

    import art_tpu_torch
    from art_tpu_torch import cli
    from art_tpu_torch.color import iccwrite, lcms
    from art_tpu_torch.io import imagefile, iomanager, jpeg
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.io.rawfile import load_raw
    from art_tpu_torch.io.xmp import insert_jpeg_app_segments
    from art_tpu_torch.params import ProcParams
    from art_tpu_torch.pipeline import develop as tdev
    from art_tpu_torch.settings import settings

    log(f"---- entry phase ({smi_line})")
    t_phase = time.monotonic()
    stats, failures = {}, []
    here = os.path.dirname(os.path.abspath(__file__))
    user = os.path.join(tmp, "user")
    os.makedirs(os.path.join(user, "imageio"))
    script = os.path.join(here, "art_tpu_torch", "preconverters",
                          "pnm_to_dng.py")
    with open(os.path.join(user, "imageio", "pnm.txt"), "w") as f:
        f.write(f"[ART RAWImageIO]\nExtension={X1_EXT}\n"
                f"ReadCommand={sys.executable} {script}\n")
    saved = (tempfile.tempdir, settings.user_dir,
             {k: os.environ.get(k) for k in ("ART_PNM_BLACK",
                                             "ART_PNM_WHITE")})
    cache = os.path.join(tmp, "cache")
    os.makedirs(cache)
    tempfile.tempdir = cache  # the preconverter's cache, fresh
    os.environ.update(ART_PNM_BLACK="512", ART_PNM_WHITE="16383")
    try:
        art_tpu_torch.init(user_settings_dir=user)

        # X1: a preconverted raw through cli.main
        frame = flagship_frame(*ENTRY_FRAME)
        mosaic = np.round(frame.cfa).astype(np.uint16)
        del frame
        pgm = write_pgm16(os.path.join(tmp, f"x1.{X1_EXT}"), mosaic)
        dn = os.path.join(tmp, "denoise20.arp")
        with open(dn, "w") as f:
            f.write("[Denoise]\nEnabled=true\nLuminance=20\n"
                    "Chrominance=20\n")
        arp = os.path.join(here, "art_tpu_torch", "data", "profiles",
                           PROFILE)
        out = os.path.join(tmp, "x1.jpg")
        argv = ["-Y", "-p", arp, "-p", dn, "-o", out, "-c", pgm]
        want = ("b1", "b2", "b3", "b4", "b7")
        for call in ("first (preconverts)", "second (cached DNG)"):
            reset_counts()
            phases, seconds = cli_run(argv)
            launches, plain_calls = read_counts()
            log(f"X1 {call} through cli.main: {1e3 * seconds:.1f} ms end to "
                f"end, decode {phases.get('decode', float('nan')):.1f} ms; "
                f"launches {launches}; plain calls {plain_calls}")
            if launches != {k: int(k in want) for k in launches} \
                    or any(plain_calls.values()):
                raise RuntimeError(f"X1: launches {launches}, want {want} "
                                   f"once; plain calls {plain_calls}")
        scan = check_jpeg(out)
        cli_timed(f"X1 ({ENTRY_FRAME[0]}x{ENTRY_FRAME[1]} .{X1_EXT} "
                  "preconverted, AMaZE, denoise, Neutral curve, sRGB JPEG)",
                  argv, runs=1)
        dng = iomanager.get_instance().preconvert_raw(pgm)
        if not dng or os.path.dirname(os.path.dirname(dng)) != cache:
            raise RuntimeError(f"X1: no cached DNG ({dng})")
        direct = os.path.join(tmp, "x1.dng")
        shutil.copy(dng, direct)
        out_dng = os.path.join(tmp, "x1_dng.jpg")
        cli_run(["-Y", "-p", arp, "-p", dn, "-o", out_dng, "-c", direct])
        if check_jpeg(out_dng, quiet=True) != scan:
            failures.append("X1: the scan differs from cli.main's on the "
                            "cached DNG")
        else:
            log("X1 scan byte-equal to cli.main's on the cached DNG itself")
        failures += kernels_against_plain("X1", lambda: cli_run(argv))
        small = write_pgm16(os.path.join(tmp, f"x1_small.{X1_EXT}"),
                            mosaic[: SMALL2[0], : SMALL2[1]])
        pp = flagship_pp("amaze")
        stats["X1"] = card_vs_cpu("X1", art_tpu_torch.load_image(small), pp)

        # T1: thumbnails, with no preview and with one
        t1 = os.path.join(tmp, "t1.dng")
        write_dng(t1, mosaic, black=512, white=16383, compress=False)
        config, _ = tdev.plan(load_raw(t1), ProcParams(), fast=True)
        head, tail = tdev.fusion_gates(config)
        want_t = (("b1", "b2", "b3") if config.demosaic_method == "amaze"
                  else ()) + (("b4",) if head else ()) + \
            (("b7",) if tail else ())
        log(f"T1 plan of ProcParams() (fast): demosaic "
            f"{config.demosaic_method}, steps {[s[0] for s in config.steps]}"
            f", fuse_head {head}, fuse_tail {tail}: kernels {want_t}")
        for label, path, kernels in (
                ("no preview", t1, want_t),
                ("H1's full-size preview",
                 h1_dng(os.path.join(tmp, "h1.dng"), *ENTRY_FRAME), ())):
            reset_counts()
            thumb, first = timed(lambda: art_tpu_torch.thumbnail(path), 1)
            launches, plain_calls = read_counts()
            _, warm = timed(lambda: art_tpu_torch.thumbnail(path), 1)
            log(f"T1 thumbnail, {label}: {thumb.shape} {thumb.dtype}, first "
                f"{1e3 * first:.1f} ms, second {1e3 * warm:.1f} ms; "
                f"launches {launches}; plain calls {plain_calls}")
            if launches != {k: int(k in kernels) for k in launches} \
                    or any(plain_calls.values()):
                failures.append(f"T1 {label}: launches {launches}, want "
                                f"{kernels}; plain {plain_calls}")
            step = -(-max(ENTRY_FRAME) // 256)
            if thumb.shape != (3, -(-ENTRY_FRAME[0] // step),
                               -(-ENTRY_FRAME[1] // step)) \
                    or not np.isfinite(thumb).all():
                failures.append(f"T1 {label}: thumbnail {thumb.shape}")
        del mosaic

        # N1: non-raw files on the host
        scene = preview_look(flagship_scene(*ENTRY_FRAME))
        rgb8 = np.round(np.moveaxis(scene, 0, -1) * 255.0).astype(np.uint8)
        del scene
        files = {}
        t0 = time.monotonic()
        files["8-bit RGB PNG"] = os.path.join(tmp, "n1.png")
        imagefile.write_png(files["8-bit RGB PNG"], rgb8)
        files["16-bit grey PNG (I;16)"] = write_mask_png(
            os.path.join(tmp, "n1_grey.png"), *ENTRY_FRAME)
        files["JPEG-compressed TIFF"] = write_jpeg_tiff(
            os.path.join(tmp, "n1.tif"), rgb8)
        files["JPEG, Adobe RGB profile"] = os.path.join(tmp, "n1.jpg")
        with open(files["JPEG, Adobe RGB profile"], "wb") as f:
            f.write(jpeg.encode(rgb8, quality=90, subsampling=1))
        insert_jpeg_app_segments(files["JPEG, Adobe RGB profile"],
                                 icc_bytes=iccwrite.make_icc("Adobe RGB"))
        log(f"N1 files written in {time.monotonic() - t0:.1f} s")
        for label, path in files.items():
            (mode, samples, icc), dec = timed(
                lambda: imagefile.read_image(path), 1)
            conv = 0.0
            if icc:
                _, conv = timed(lambda: lcms.to_srgb(
                    imagefile.to_rgb8(mode, samples), icc), 1)
            fr, total = timed(lambda: art_tpu_torch.load_image(path), 1)
            N1_MS[label] = (1e3 * dec, 1e3 * conv, 1e3 * total)
            if label == "JPEG, Adobe RGB profile":
                N1_PHOTO["rgb8"] = imagefile.to_rgb8(mode, samples)
            log(f"N1 {label} ({os.path.getsize(path) / 1e6:.1f} MB, mode "
                f"{mode}, ICC {len(icc) if icc else 0} bytes): decode "
                f"{1e3 * dec:.1f} ms, ICC conversion {1e3 * conv:.1f} ms; "
                f"load_image in all (decode, conversion, sRGB decode to "
                f"float) {1e3 * total:.1f} ms (one call each)")
            if fr.rgb.shape != (3, *ENTRY_FRAME) or fr.is_raw or not (
                    np.isfinite(fr.rgb).all() and fr.rgb.min() >= 0
                    and fr.rgb.max() <= 65535.0):
                failures.append(f"N1 {label}: bad frame {fr.rgb.shape}")
        # an external loader for an unknown extension: a container the
        # decoder does not know, unwrapped to its TIFF by the command
        loader = os.path.join(tmp, "unwrap.py")
        with open(loader, "w") as f:
            f.write("import sys\ndata = open(sys.argv[1], 'rb').read()\n"
                    "open(sys.argv[2], 'wb').write(data[8:])\n")
        with open(os.path.join(user, "imageio", "wrapped.txt"), "w") as f:
            f.write(f"[ART ImageIO]\nExtension=wrapped\n"
                    f"ReadCommand={sys.executable} {loader}\n")
        art_tpu_torch.init(user_settings_dir=user)
        wrapped = os.path.join(tmp, "n1.wrapped")
        with open(wrapped, "wb") as f:
            f.write(b"WRAPPED\n" + open(files["JPEG-compressed TIFF"],
                                         "rb").read())
        fr, secs = timed(lambda: art_tpu_torch.load_image(wrapped), 1)
        ref = art_tpu_torch.load_image(files["JPEG-compressed TIFF"])
        same = np.array_equal(fr.rgb, ref.rgb)
        log(f"N1 external loader (.wrapped -> TIFF): {1e3 * secs:.1f} ms, "
            f"the frame equal to the TIFF's own: {same}")
        if not same or fr.filename != wrapped:
            failures.append("N1: the external loader's frame differs")
        # a non-raw develop: refused by name, as the reference's plan fails
        out_dir = os.path.join(tmp, "n1_out")
        os.makedirs(out_dir)
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["-Y", "-o", out_dir + os.sep, "-c",
                           files["8-bit RGB PNG"]])
        log(f"N1 PNG through cli.main: exit {rc}, files {os.listdir(out_dir)}"
            f", stderr {err.getvalue().strip()[:200]!r}")
        if rc != 2 or os.listdir(out_dir) or \
                "non-raw input" not in err.getvalue():
            failures.append("N1: cli.main on a PNG did not exit 2 naming "
                            "non-raw input")
    finally:
        tempfile.tempdir, settings.user_dir = saved[0], saved[1]
        for k, v in saved[2].items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        iomanager.reset()
    log(f"entry phase: {time.monotonic() - t_phase:.1f} s")
    return stats, failures


# ---- the image formats Pillow opens (F1, F2) --------------------------

FORMATS_FRAME = (4000, 6000)
# tests/data: the committed JPEG forms and GIF, and the sha256 of Pillow 12.1.0's
# convert("RGB") of each (and of F1's CMYK TIFF), recorded by
# tests/test_torch_formats.py
FORMATS_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "data")
FORMATS_SHA = os.path.join(FORMATS_DATA, "formats_sha256.json")


def write_bmp24(path, rgb):
    """A 24-bit bottom-up BMP (BITMAPINFOHEADER, rows padded to 4
    bytes) of (H, W, 3) uint8."""
    import struct

    h, w, _ = rgb.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = rgb[::-1, :, ::-1].reshape(h, -1)
    head = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size,
                       2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(head + info)
        f.write(rows.tobytes())
    return path


def write_pnm(path, arr, maxval=255):
    """A binary PGM (P5, (H, W)) or PPM (P6, (H, W, 3)) of maxval
    `maxval`: one byte a sample up to 255, else two, big-endian."""
    arr = np.asarray(arr)
    magic = b"P5" if arr.ndim == 2 else b"P6"
    h, w = arr.shape[:2]
    data = arr.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    with open(path, "wb") as f:
        f.write(b"%s\n%d %d\n%d\n" % (magic, w, h, maxval))
        f.write(data)
    return path


def write_gif(path, idx, palette):
    """A GIF89a of (H, W) uint8 indices into a 256-colour palette ((256,
    3) uint8): LZW data of 9-bit literal codes only, a clear code before
    every 254 of them (so the table never widens the codes)."""
    import struct

    h, w = idx.shape
    flat = idx.reshape(-1).astype(np.uint16)
    n = flat.size
    groups = (n + 253) // 254
    codes = np.empty(n + groups + 1, np.uint16)
    starts = np.arange(groups) * 255
    codes[starts] = 256  # clear
    mask = np.ones(n + groups + 1, bool)
    mask[starts] = False
    mask[-1] = False
    codes[mask] = flat
    codes[-1] = 257  # end of information
    # eight 9-bit codes, least significant bit first, make nine bytes
    total = codes.size
    c = np.zeros((total + 7) // 8 * 8, np.uint64)
    c[:total] = codes
    c = c.reshape(-1, 8)
    lo = np.zeros(len(c), np.uint64)
    for i in range(7):
        lo |= c[:, i] << np.uint64(9 * i)
    lo |= (c[:, 7] & np.uint64(1)) << np.uint64(63)
    data = np.concatenate([lo.astype("<u8").view(np.uint8).reshape(-1, 8),
                           (c[:, 7:8] >> np.uint64(1)).astype(np.uint8)],
                          axis=1).reshape(-1)[: (total * 9 + 7) // 8]
    nb = (data.size + 254) // 255
    padded = np.zeros(nb * 255, np.uint8)
    padded[: data.size] = data
    blocks = np.concatenate([np.full((nb, 1), 255, np.uint8),
                             padded.reshape(nb, 255)], axis=1)
    blocks[-1, 0] = data.size - 255 * (nb - 1)  # sub-blocks of 255 bytes
    body = blocks.reshape(-1)[: (nb - 1) * 256 + 1 + int(blocks[-1, 0])]
    with open(path, "wb") as f:
        f.write(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0))
        f.write(np.asarray(palette, np.uint8).tobytes())
        f.write(b"," + struct.pack("<HHHHB", 0, 0, w, h, 0) + bytes([8]))
        f.write(body.tobytes() + b"\x00;")
    return path


def tiff_bytes(blocks, ents, big=False, tiles=False):
    """A little-endian TIFF (BigTIFF with `big`: 8-byte offsets) of the
    data blocks, strips or (with `tiles`) tiles, in order after the
    header, and an IFD of the entries `ents` ((tag, type 3 or 4, values))
    with the blocks' offsets and byte counts added."""
    import struct

    head = 16 if big else 8
    offsets, pos = [], head
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    pos += pos & 1
    long_t = 16 if big else 4
    where, counts = (324, 325) if tiles else (273, 279)
    ents = sorted(list(ents) + [(where, long_t, offsets),
                                (counts, long_t, [len(b) for b in blocks])])
    code = {3: "H", 4: "I", 16: "Q"}
    inline = 8 if big else 4
    n = len(ents)
    extra_at = pos + ((8 + 20 * n + 8) if big else (2 + 12 * n + 4))
    ifd = struct.pack("<Q", n) if big else struct.pack("<H", n)
    extra = b""
    for tag, typ, vals in ents:
        payload = struct.pack("<" + code[typ] * len(vals), *vals)
        if len(payload) <= inline:
            value = payload.ljust(inline, b"\0")
        else:
            value = struct.pack("<Q" if big else "<I", extra_at + len(extra))
            extra += payload + b"\0" * (len(payload) & 1)
        ifd += struct.pack("<HHQ" if big else "<HHI", tag, typ,
                           len(vals)) + value
    ifd += b"\0" * (8 if big else 4)
    hdr = (b"II+\0" + struct.pack("<HHQ", 8, 0, pos)) if big else \
        (b"II*\0" + struct.pack("<I", pos))
    return (hdr + b"".join(blocks)).ljust(pos, b"\0") + ifd + extra


def write_tiff_form(path, arr, photometric=2, planar=False, big=False,
                    rows_per_strip=256, deflate=False):
    """A little-endian TIFF (BigTIFF with `big`: 8-byte offsets) of
    (H, W, C) uint8 or uint16 `arr`: photometric 1 (grey), 2 (RGB) or 5
    (CMYK), chunky or with separate planes (one plane's strips after
    another's), strips of `rows_per_strip` rows, uncompressed or
    deflated."""
    import zlib

    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    bits = 8 * arr.dtype.itemsize
    planes = [arr[..., k : k + 1] for k in range(c)] if planar else [arr]
    strips = []
    for plane in planes:
        for y in range(0, h, rows_per_strip):
            raw = np.ascontiguousarray(plane[y : y + rows_per_strip]).astype(
                "<u2" if bits == 16 else np.uint8).tobytes()
            strips.append(zlib.compress(raw, 1) if deflate else raw)
    ents = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * c),
            (259, 3, [8 if deflate else 1]), (262, 3, [photometric]),
            (277, 3, [c]), (278, 4, [rows_per_strip]),
            (284, 3, [2 if planar else 1])]
    with open(path, "wb") as f:
        f.write(tiff_bytes(strips, ents, big))
    return path


def formats_arrays(h, w, seed=0):
    """F1's pictures: an RGB scene with noise, a 16-bit grey ramp with
    noise, a GIF's indices and palette, and a CMYK scene, all from
    `seed`."""
    rng = np.random.default_rng(seed)
    y = np.arange(h, dtype=np.int32)[:, None]
    x = np.arange(w, dtype=np.int32)[None, :]
    base = np.empty((h, w, 3), np.int16)
    base[..., 0] = (x // 20 + y // 33) % 256
    base[..., 1] = (y // 25) % 256
    base[..., 2] = ((x + y) // 50) % 256
    rgb = np.clip(base + rng.integers(-8, 9, (h, w, 3), dtype=np.int8), 0,
                  255).astype(np.uint8)
    grey16 = np.clip(x * 65535 // max(w - 1, 1) + rng.integers(
        -600, 601, (h, w), dtype=np.int32), 0, 65535).astype(np.uint16)
    idx = ((x // 7 + y // 5) % 256).astype(np.uint8)
    palette = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    cmyk = np.concatenate([rgb, (255 - rgb.max(-1, keepdims=True))], -1)
    return rgb, grey16, idx, palette, cmyk


def formats_files(tmp, h, w, seed=0):
    """F1's files in `tmp`: name -> (path, the array each decodes to, or
    None where Pillow's sha256 stands for it)."""
    rgb, grey16, idx, palette, cmyk = formats_arrays(h, w, seed)
    files = {
        "BMP 24-bit": (write_bmp24(os.path.join(tmp, "f1.bmp"), rgb), rgb),
        "PPM 8-bit": (write_pnm(os.path.join(tmp, "f1.ppm"), rgb), rgb),
        "PGM 16-bit": (write_pnm(os.path.join(tmp, "f1.pgm"), grey16,
                                 65535), grey16.astype(np.int32)),
        "GIF": (write_gif(os.path.join(tmp, "f1.gif"), idx, palette),
                palette[idx]),
        "planar TIFF": (write_tiff_form(os.path.join(tmp, "f1p.tif"), rgb,
                                        planar=True, deflate=True), rgb),
        "BigTIFF": (write_tiff_form(os.path.join(tmp, "f1b.tif"), rgb,
                                    big=True), rgb),
        "CMYK TIFF": (write_tiff_form(os.path.join(tmp, "f1c.tif"), cmyk,
                                      photometric=5), None),
    }
    return files


def _sha(arr):
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def f2_arp(hald, mask):
    """F2's settings: P3's Hald film simulation (before the curve,
    strength 80) and Texture Boost under the external mask `mask`."""
    return (p3_arp(hald) + "\n[TextureBoost]\nEnabled=true\nStrength_1=0.6\n"
            "DetailThreshold_1=1.5\nIterations_1=1\n"
            f"ExternalMaskEnabled_1=true\nExternalMaskFilename_1={mask}\n"
            "ExternalMaskFeather_1=10\n")


def f2_mask(h=MASK_PNG[0], w=MASK_PNG[1], seed=0):
    """F2's mask samples: M1's blob and ramp with 1% noise, at 0..255 (a
    16-bit PGM opens as Pillow's mode I, which a mask reads through
    ``convert("RGB")``, clipped at 255)."""
    yy, xx = np.mgrid[0:h, 0:w]
    yy, xx = yy / h, xx / w
    blob = np.exp(-((xx - 0.6) ** 2 / 0.04 + (yy - 0.45) ** 2 / 0.06))
    v = 0.7 * blob + 0.3 * xx + np.random.default_rng(seed).normal(
        0.0, 0.01, (h, w))
    return np.round(np.clip(v, 0.0, 1.0) * 255.0).astype(np.uint16)


def formats_phase(smi_line, tmp):
    """The image formats Pillow opens, decoded by the port on the card's
    machine (no PIL there). F1: `formats_files` at 24 MP, each decode's
    host ms and its samples against the array written (the CMYK TIFF's
    against Pillow's sha256 from tests/data/formats_sha256.json), then
    every committed fixture of tests/data (the JPEG forms and a GIF of
    Pillow's own LZW) against Pillow's sha256 (the card machine's g++
    builds of io/native/jpegdec.cc and lzwdec.cc held to Pillow). F2:
    `f2_arp` on the flagship DNG through cli.main with the bundled
    profile and denoise 20/20, the Hald a 24-bit BMP and the mask a
    16-bit PGM, against the same develop from an 8-bit PNG Hald and an
    8-bit PNG mask of the same samples: the JPEGs byte-equal, B1-B4
    and B7 once each and bit-equal to their plain versions on F2's
    tensors. Returns (the comparisons, the failures)."""
    from art_tpu_torch.io import imagefile
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- formats phase ({smi_line})")
    t_phase = time.monotonic()
    failures = []
    with open(FORMATS_SHA) as f:
        recorded = json.load(f)
    h, w = FORMATS_FRAME
    t0 = time.monotonic()
    files = formats_files(tmp, h, w)
    log(f"F1 files {h}x{w} written in {time.monotonic() - t0:.2f} s: "
        + ", ".join(f"{k} {os.path.getsize(p) / 1e6:.1f} MB"
                    for k, (p, _) in files.items()))
    for name, (path, want) in files.items():
        t0 = time.monotonic()
        mode, samples, _ = imagefile.read_image(path)
        ms = 1e3 * (time.monotonic() - t0)
        if want is None:
            got_sha = _sha(imagefile.to_rgb8(mode, samples))
            ok = got_sha == recorded.get(f"F1 {name}")
        else:
            ok = samples.shape == want.shape and np.array_equal(samples, want)
        log(f"F1 {name}: read_image {ms:.1f} ms (host) -> mode {mode} "
            f"{samples.shape} {samples.dtype}: "
            f"{'equal' if ok else 'DIFFERENT'}")
        if not ok:
            failures.append(f"F1 {name} decodes differently")
    for name in sorted(k for k in recorded if not k.startswith(
            ("F1 ", "G1 ", "Q1 ", "U1 ", "I1 ", "O1 ", "webp_", "raster_",
             "plugin_", "j2k_", "u1_", "u2_"))):
        path = os.path.join(FORMATS_DATA, name)
        buf = open(path, "rb").read()
        t0 = time.monotonic()
        rgb = imagefile.read_rgb8(path)
        ms = 1e3 * (time.monotonic() - t0)
        ok = _sha(rgb) == recorded[name]
        log(f"F1 {name} ({len(buf)} bytes, {rgb.shape[1]}x{rgb.shape[0]}): "
            f"{ms:.1f} ms, sha256 {'equal to' if ok else 'NOT'} Pillow's")
        if not ok:
            failures.append(f"F1 {name}: sha256 differs from Pillow's")

    # F2: the Hald as a BMP and the mask as a 16-bit PGM against PNGs
    from art_tpu_torch.io.imagefile import write_png

    hald = hald_image(12, 8)
    mask = f2_mask()
    paths = {"bmp": write_bmp24(os.path.join(tmp, "hald12.bmp"), hald),
             "pgm": write_pnm(os.path.join(tmp, "mask.pgm"), mask, 65535),
             "png": os.path.join(tmp, "hald12.png"),
             "mask_png": os.path.join(tmp, "mask.png")}
    write_png(paths["png"], hald)
    write_png(paths["mask_png"], np.repeat(mask.astype(np.uint8)[..., None],
                                           3, axis=2))
    t0 = time.monotonic()
    plane, mode = imagefile.read_grey(paths["pgm"])
    ms = 1e3 * (time.monotonic() - t0)
    ok = mode == "L" and np.array_equal(plane, mask.astype(np.uint8))
    log(f"F2 mask: the 16-bit PGM reads as mode {mode} {plane.shape} in "
        f"{ms:.1f} ms (host), {'equal to' if ok else 'NOT'} its samples "
        f"clipped at 255")
    if not ok:
        failures.append("F2: the PGM mask decodes wrongly")
    frame = flagship_frame(*FRAME)
    dng = os.path.join(tmp, "f2.dng")
    write_dng(dng, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, compress=False)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "art_tpu_torch", "data", "profiles", PROFILE)
    dn = os.path.join(tmp, "denoise20.arp")
    with open(dn, "w") as f:
        f.write("[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n")
    outs = {}
    want = ("b1", "b2", "b3", "b4", "b7")
    for kind, (lut, msk) in {"new": (paths["bmp"], paths["pgm"]),
                             "png": (paths["png"], paths["mask_png"])}.items():
        arp = os.path.join(tmp, f"f2_{kind}.arp")
        with open(arp, "w") as f:
            f.write(f2_arp(lut, msk))
        out = os.path.join(tmp, f"f2_{kind}.jpg")
        argv = ["-Y", "-p", base, "-p", dn, "-p", arp, "-o", out, "-c", dng]
        reset_counts()
        phases, seconds = cli_run(argv)
        launches, plain_calls = read_counts()
        log(f"F2 ({'BMP Hald, PGM mask' if kind == 'new' else 'PNG Hald, '
            'PNG mask'}) through cli.main: {1e3 * seconds:.1f} ms end to "
            f"end (first); phases {phases}; launches {launches}; plain "
            f"calls {plain_calls}")
        if launches != {k: int(k in want) for k in launches} \
                or any(plain_calls.values()):
            failures.append(f"F2 {kind}: launches {launches}, plain calls "
                            f"{plain_calls}")
        outs[kind] = open(out, "rb").read()
        check_jpeg(out)
    same = outs["new"] == outs["png"]
    log(f"F2 JPEG from the BMP and PGM {'byte-equal to' if same else 'DIFFERS FROM'}"
        f" the PNGs' ({len(outs['new'])} bytes)")
    if not same:
        failures.append("F2: the BMP/PGM develop differs from the PNGs'")
    from art_tpu_torch import cli

    argv = ["-Y", "-p", base, "-p", dn, "-p",
            os.path.join(tmp, "f2_new.arp"), "-o",
            os.path.join(tmp, "f2_k.jpg"), "-c", dng]
    pp = cli.compose_params(dng, cli.parse_args(argv))
    failures += kernels_against_plain("F2", lambda: tdev.develop(frame, pp),
                                      want)
    log(f"formats phase: {time.monotonic() - t_phase:.1f} s")
    return {}, failures


# ---- WebP (W1, W2) -------------------------------------------------------

# tests/data: W1's 24 MP lossy WebP with alpha, W2's lossy mask and the
# small WebP fixtures (written by tests/util_webpforms.py::fixtures),
# each held to the sha256 of Pillow's convert("RGB") recorded in
# formats_sha256.json
W1_LOSSY = "webp_w1_24mp_alpha.webp"
W1_LOSSY_SIZE = (4000, 6000)
W2_MASK = "webp_w2_mask.webp"

_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


class LsbBits:
    """Bits packed least significant first, as VP8L reads them."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, v, n):
        self.acc |= (int(v) & ((1 << n) - 1)) << self.n
        self.n += n
        while self.n >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.n -= 8

    def put_bytes(self, data):
        """Whole bytes (a uint8 array), each its 8 bits in order."""
        data = np.ascontiguousarray(data, np.uint8).reshape(-1)
        r = self.n
        if r == 0:
            self.out += data.tobytes()
            return
        d = data.astype(np.uint16)
        body = ((d << r) & 255).astype(np.uint8)
        body[1:] |= (d[:-1] >> (8 - r)).astype(np.uint8)
        body[0] |= self.acc
        self.out += body.tobytes()
        self.acc = int(d[-1]) >> (8 - r)

    def getvalue(self):
        return bytes(self.out) + (bytes([self.acc]) if self.n else b"")


def vp8l_fixed_code(bw, alphabet):
    """A normal prefix code giving each of the 256 literals 8 bits (a
    code-length code of one symbol, 8, read in no bits; an alphabet past
    256 stops at its 256th length)."""
    bw.put(0, 1)
    bw.put(12 - 4, 4)  # 12 code-length code lengths: symbol 8 the 12th
    for i in range(12):
        bw.put(1 if i == 11 else 0, 3)
    if alphabet == 256:
        bw.put(0, 1)
    else:
        bw.put(1, 1)
        bw.put(3, 3)  # 8 bits of max_symbol
        bw.put(254, 8)  # 2 + 254 = 256 symbols


def vp8l_one_symbol(bw, symbol):
    """A simple prefix code of one symbol, read in no bits."""
    bw.put(1, 1)
    bw.put(0, 1)
    if symbol < 2:
        bw.put(0, 1)
        bw.put(symbol, 1)
    else:
        bw.put(1, 1)
        bw.put(symbol, 8)


def vp8l_codes(bw, alpha=None, cache_bits=0):
    """One prefix-code group: green, red, blue and alpha literals of 8
    bits (alpha a one-symbol code of `alpha` where given; green's
    backward-reference and cache symbols unused), distance one symbol."""
    vp8l_fixed_code(bw, 280 + (1 << cache_bits if cache_bits else 0))
    vp8l_fixed_code(bw, 256)
    vp8l_fixed_code(bw, 256)
    if alpha is None:
        vp8l_fixed_code(bw, 256)
    else:
        vp8l_one_symbol(bw, alpha)
    vp8l_one_symbol(bw, 0)


def vp8l_pixels(bw, argb, alpha=None):
    """The pixels of `argb` ((N, 4) uint8, A, R, G, B) as the literals of
    `vp8l_codes`' group: green, red, blue and (unless alpha is one
    symbol) alpha, a byte each."""
    order = [2, 1, 3] + ([0] if alpha is None else [])
    bw.put_bytes(_REV8[np.ascontiguousarray(argb[:, order])])


def webp_riff(vp8l):
    body = b"WEBP" + b"VP8L" + len(vp8l).to_bytes(4, "little") + vp8l
    body += b"\0" * (len(vp8l) & 1)
    return b"RIFF" + len(body).to_bytes(4, "little") + body


def write_webp_lossless(path, rgb):
    """A lossless WebP of (H, W, 3) uint8: one VP8L stream with the
    subtract-green transform, no colour cache and one prefix-code group
    (`vp8l_codes`: each pixel three bytes after the header)."""
    h, w, _ = rgb.shape
    bw = LsbBits()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(0, 1)  # no alpha
    bw.put(0, 3)  # version
    bw.put(1, 1)
    bw.put(2, 2)  # subtract green
    bw.put(0, 1)
    bw.put(0, 1)  # no colour cache
    bw.put(0, 1)  # no meta prefix codes
    flat = rgb.reshape(-1, 3)
    g = flat[:, 1]
    argb = np.empty((flat.shape[0], 4), np.uint8)
    argb[:, 0] = 255
    argb[:, 1] = flat[:, 0] - g
    argb[:, 2] = g
    argb[:, 3] = flat[:, 2] - g
    vp8l_codes(bw, alpha=255)
    vp8l_pixels(bw, argb, alpha=255)
    with open(path, "wb") as f:
        f.write(webp_riff(bw.getvalue()))
    return path


def webp_phase(smi_line, tmp):
    """WebP decoded by the port on the card's machine (no PIL there). W1:
    a 24 MP lossless WebP from `write_webp_lossless` (its read_image host
    ms and its array against the one written), the committed 24 MP lossy
    WebP with alpha and every small WebP fixture of tests/data against
    the sha256 of Pillow's decode (the card machine's g++ build of
    io/native/webpdec.cc held to Pillow). W2: F2's develop through
    cli.main (P3's Hald film simulation with Texture Boost under an
    external mask, bundled profile, denoise 20/20), the Hald a lossless
    WebP and the mask the committed lossy WebP (its decode first held to
    Pillow's sha256), against the same develop from PNG files of the same
    samples: the JPEGs byte-equal, B1-B4 and B7 once each and bit-equal
    to their plain versions on W2's tensors. Returns (the comparisons,
    the failures)."""
    from art_tpu_torch.io import imagefile
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.io.imagefile import write_png
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- WebP phase ({smi_line})")
    t_phase = time.monotonic()
    failures = []
    with open(FORMATS_SHA) as f:
        recorded = json.load(f)
    h, w = FORMATS_FRAME
    rgb = formats_arrays(h, w)[0]
    t0 = time.monotonic()
    path = write_webp_lossless(os.path.join(tmp, "w1.webp"), rgb)
    log(f"W1 lossless {h}x{w} written in {time.monotonic() - t0:.2f} s "
        f"({os.path.getsize(path) / 1e6:.1f} MB)")
    t0 = time.monotonic()
    mode, samples, _ = imagefile.read_image(path)
    ms = 1e3 * (time.monotonic() - t0)
    ok = mode == "RGB" and np.array_equal(samples, rgb)
    log(f"W1 lossless: read_image {ms:.1f} ms (host) -> {samples.shape}: "
        f"{'equal' if ok else 'DIFFERENT'}")
    if not ok:
        failures.append("W1 lossless decodes differently")
    del rgb, samples
    names = [W1_LOSSY] + sorted(k for k in recorded if k.startswith("webp_")
                                and k != W1_LOSSY)
    for name in names:
        fpath = os.path.join(FORMATS_DATA, name)
        t0 = time.monotonic()
        got = imagefile.read_rgb8(fpath)
        ms = 1e3 * (time.monotonic() - t0)
        ok = _sha(got) == recorded[name]
        log(f"W1 {name} ({os.path.getsize(fpath)} bytes, "
            f"{got.shape[1]}x{got.shape[0]}): read_rgb8 {ms:.1f} ms (host), "
            f"sha256 {'equal to' if ok else 'NOT'} Pillow's")
        if not ok:
            failures.append(f"W1 {name}: sha256 differs from Pillow's")

    # W2: a lossless WebP Hald and the lossy WebP mask against PNGs
    hald = hald_image(12, 8)
    mask_rgb = imagefile.read_rgb8(os.path.join(FORMATS_DATA, W2_MASK))
    if _sha(mask_rgb) != recorded[W2_MASK]:
        failures.append("W2: the WebP mask's sha256 differs from Pillow's")
    paths = {"hald": write_webp_lossless(os.path.join(tmp, "hald12.webp"),
                                         hald),
             "mask": os.path.join(FORMATS_DATA, W2_MASK),
             "hald_png": os.path.join(tmp, "hald12.png"),
             "mask_png": os.path.join(tmp, "mask.png")}
    write_png(paths["hald_png"], hald)
    write_png(paths["mask_png"], mask_rgb)
    t0 = time.monotonic()
    plane, mode = imagefile.read_grey(paths["mask"])
    ms = 1e3 * (time.monotonic() - t0)
    log(f"W2 mask: the lossy WebP reads as mode {mode} {plane.shape} in "
        f"{ms:.1f} ms (host)")
    frame = flagship_frame(*FRAME)
    dng = os.path.join(tmp, "w2.dng")
    write_dng(dng, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, compress=False)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "art_tpu_torch", "data", "profiles", PROFILE)
    dn = os.path.join(tmp, "denoise20.arp")
    with open(dn, "w") as f:
        f.write("[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n")
    outs = {}
    want = ("b1", "b2", "b3", "b4", "b7")
    for kind, (lut, msk) in {
            "webp": (paths["hald"], paths["mask"]),
            "png": (paths["hald_png"], paths["mask_png"])}.items():
        arp = os.path.join(tmp, f"w2_{kind}.arp")
        with open(arp, "w") as f:
            f.write(f2_arp(lut, msk))
        out = os.path.join(tmp, f"w2_{kind}.jpg")
        argv = ["-Y", "-p", base, "-p", dn, "-p", arp, "-o", out, "-c", dng]
        reset_counts()
        phases, seconds = cli_run(argv)
        launches, plain_calls = read_counts()
        log(f"W2 ({'WebP Hald, WebP mask' if kind == 'webp' else 'PNG Hald, '
            'PNG mask'}) through cli.main: {1e3 * seconds:.1f} ms end to "
            f"end (first); phases {phases}; launches {launches}; plain "
            f"calls {plain_calls}")
        if launches != {k: int(k in want) for k in launches} \
                or any(plain_calls.values()):
            failures.append(f"W2 {kind}: launches {launches}, plain calls "
                            f"{plain_calls}")
        outs[kind] = open(out, "rb").read()
        check_jpeg(out)
    same = outs["webp"] == outs["png"]
    log(f"W2 JPEG from the WebPs {'byte-equal to' if same else 'DIFFERS FROM'}"
        f" the PNGs' ({len(outs['webp'])} bytes)")
    if not same:
        failures.append("W2: the WebP develop differs from the PNGs'")
    from art_tpu_torch import cli

    argv = ["-Y", "-p", base, "-p", dn, "-p",
            os.path.join(tmp, "w2_webp.arp"), "-o",
            os.path.join(tmp, "w2_k.jpg"), "-c", dng]
    pp = cli.compose_params(dng, cli.parse_args(argv))
    failures += kernels_against_plain("W2", lambda: tdev.develop(frame, pp),
                                      want)
    log(f"WebP phase: {time.monotonic() - t_phase:.1f} s")
    return {}, failures


# ---- the simple raster formats (R1, R2) --------------------------------

def rle_rows(rows, px, chunk, run_head, lit_head, tail=b""):
    """Rows of pixels ((R, n * px) uint8, px bytes a pixel) as packets of
    up to `chunk` pixels that never cross a row: a chunk of one repeated
    pixel (two or more) as run_head(count) and the pixel, any other as
    lit_head(count) and its pixels, `tail` after each row. Returns (the
    stream as uint8, each row's byte count)."""
    rows = np.ascontiguousarray(rows, np.uint8)
    r, nb = rows.shape
    n = nb // px
    pix = rows.reshape(r, n, px)
    starts = np.arange(0, n, chunk)
    counts = np.minimum(chunk, n - starts)
    nch = len(starts)
    cid = np.repeat(np.arange(nch), counts)  # each pixel's chunk
    first = pix[:, starts[cid]]
    same = (pix == first).all(-1)  # (r, n)
    uniform = np.logical_and.reduceat(same, starts, axis=1) & (counts > 1)
    size = np.where(uniform, 1 + px, 1 + counts * px)  # (r, nch)
    row_len = size.sum(1) + len(tail)
    ends = np.cumsum(row_len)
    row_at = ends - row_len
    out = np.zeros(int(ends[-1]) if r else 0, np.uint8)
    at = row_at[:, None] + np.concatenate(
        [np.zeros((r, 1), np.int64), np.cumsum(size, 1)[:, :-1]], 1)
    heads = np.where(uniform, run_head(counts)[None, :],
                     lit_head(counts)[None, :]).astype(np.uint8)
    out[at.ravel()] = heads.ravel()
    # a run's pixel
    ur, uc = np.nonzero(uniform)
    for k in range(px):
        out[at[ur, uc] + 1 + k] = pix[ur, starts[uc], k]
    # a literal's pixels
    lit = ~uniform[:, cid]  # (r, n)
    lr, li = np.nonzero(lit)
    base = at[lr, cid[li]] + 1 + (li - starts[cid[li]]) * px
    for k in range(px):
        out[base + k] = pix[lr, li, k]
    if tail:
        t = np.frombuffer(tail, np.uint8)
        for k, v in enumerate(t):
            out[ends - len(t) + k] = v
    return out, row_len


def write_tga(path, rgb, rle=False):
    """A 24-bit top-down TGA (image type 2, or 10 with `rle`: packets of
    up to 128 pixels, a row of one colour a run) of (H, W, 3) uint8."""
    import struct

    h, w, _ = rgb.shape
    bgr = np.ascontiguousarray(rgb[..., ::-1]).reshape(h, -1)
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 10 if rle else 2, 0, 0, 0, 0,
                       0, w, h, 24, 0x20)
    if rle:
        data, _ = rle_rows(bgr, 3, 128, lambda c: 0x80 | (c - 1),
                           lambda c: c - 1)
    else:
        data = bgr
    with open(path, "wb") as f:
        f.write(head)
        f.write(data.tobytes())
    return path


def _packbits_head(c):
    return np.where(c > 1, 257 - c, 0) & 0xFF


def write_psd(path, planes, mode=3, packbits=False, icc=None, palette=None,
              layers=b""):
    """A PSD of 8-bit planes ((C, H, W) uint8): colour mode `mode` (3 RGB,
    1 grey, 2 indexed with `palette` ((256, 3) uint8), 4 CMYK as stored,
    9 Lab), the ICC profile as image resource 1039, a layer section of
    `layers`' bytes, the merged image raw or PackBits (chunks of up to
    128 bytes, one row of each channel after another, its byte counts
    first)."""
    import struct

    planes = np.asarray(planes, np.uint8)
    c, h, w = planes.shape
    cmd = b"" if palette is None else \
        np.ascontiguousarray(np.asarray(palette, np.uint8).T).tobytes()
    res = b""
    if icc:
        res = b"8BIM" + struct.pack(">HBx I", 1039, 0, len(icc)) + icc
        res += b"\0" * (len(icc) & 1)
    with open(path, "wb") as f:
        f.write(b"8BPS" + struct.pack(">H6xHIIHH", 1, c, h, w, 8, mode))
        for block in (cmd, res, layers):
            f.write(struct.pack(">I", len(block)) + block)
        if packbits:
            data, counts = rle_rows(planes.reshape(c * h, w), 1, 128,
                                    _packbits_head, lambda n: n - 1)
            f.write(struct.pack(">H", 1))
            f.write(counts.astype(">u2").tobytes())
            f.write(data.tobytes())
        else:
            f.write(struct.pack(">H", 0))
            f.write(planes.tobytes())
    return path


def write_qoi(path, rgb):
    """A QOI of (H, W, 3) uint8: QOI_OP_RUN for a pixel that repeats the
    one before (runs of up to 62), QOI_OP_RGB for any other, then the
    end marker."""
    import struct

    h, w, _ = rgb.shape
    flat = rgb.reshape(-1, 3)
    n = flat.shape[0]
    prev = np.concatenate([np.zeros((1, 3), np.uint8), flat[:-1]])
    rep = (flat == prev).all(1)
    rep[0] = False  # the first pixel against (0, 0, 0, 255): an RGB op
    # a run op closes each stretch of repeats at 62 and at its end
    idx = np.arange(n)
    start = np.where(rep & ~np.concatenate([[False], rep[:-1]]), idx, 0)
    start = np.maximum.accumulate(start)
    k = idx - start  # the repeat's place in its stretch
    last = rep & (~np.concatenate([rep[1:], [False]]) | (k % 62 == 61))
    size = np.where(rep, last.astype(np.int64), 4)
    at = np.cumsum(size) - size
    out = np.zeros(int(size.sum()) + 8, np.uint8)
    lit = np.nonzero(~rep)[0]
    out[at[lit]] = 0xFE
    for c in range(3):
        out[at[lit] + 1 + c] = flat[lit, c]
    ends = np.nonzero(last)[0]
    out[at[ends]] = 0xC0 | (k[ends] % 62)
    out[-1] = 1  # the end marker: seven zeros and a one
    with open(path, "wb") as f:
        f.write(b"qoif" + struct.pack(">IIBB", w, h, 3, 0))
        f.write(out.tobytes())
    return path


def write_pcx(path, rgb):
    """A version-5 PCX of (H, W, 3) uint8, three 8-bit planes: each line
    (the planes' rows) in chunks of up to 63 bytes, a chunk of one
    repeated byte a run, any other byte by byte (a byte of 0xC0 and up
    as a run of one)."""
    import struct

    h, w, _ = rgb.shape
    stride = w + (w & 1)
    lines = np.zeros((h, 3, stride), np.uint8)
    lines[:, :, :w] = np.moveaxis(rgb, -1, 1)
    lines = lines.reshape(h, -1)
    n = lines.shape[1]
    starts = np.arange(0, n, 63)
    counts = np.minimum(63, n - starts)
    cid = np.repeat(np.arange(len(starts)), counts)
    same = lines == lines[:, starts[cid]]
    uniform = np.logical_and.reduceat(same, starts, axis=1) & (counts > 1)
    lit = ~uniform[:, cid]
    big = lines >= 0xC0
    # bytes each source byte makes: a literal 1 or 2, a run's first 2
    first = np.zeros(n, bool)
    first[starts] = True
    size = np.where(lit, 1 + big, np.where(first[None, :], 2, 0))
    flat = size.ravel()
    at = np.cumsum(flat) - flat
    src = lines.ravel()
    out = np.zeros(int(flat.sum()), np.uint8)
    two = np.nonzero(flat == 2)[0]
    run_count = np.where(lit.ravel()[two], 1, counts[cid][two % n])
    out[at[two]] = 0xC0 | run_count
    out[at[two] + 1] = src[two]
    one = np.nonzero(flat == 1)[0]
    out[at[one]] = src[one]
    head = bytearray(128)
    head[:4] = bytes([10, 5, 1, 8])
    struct.pack_into("<4H", head, 4, 0, 0, w - 1, h - 1)
    head[65] = 3
    struct.pack_into("<H", head, 66, stride)
    with open(path, "wb") as f:
        f.write(bytes(head))
        f.write(out.tobytes())
    return path


def write_sgi(path, img):
    """An RLE SGI of (H, W) or (H, W, 3) uint8, 8 bits: each channel's
    rows bottom-up in chunks of up to 127 (a chunk of one repeated value
    a run, any other a copy), each row ended by a zero, after the offset
    and length tables."""
    import struct

    img = np.asarray(img, np.uint8)
    grey = img.ndim == 2
    if grey:
        img = img[..., None]
    h, w, z = img.shape
    rows = np.moveaxis(img[::-1], -1, 0).reshape(z * h, w)
    data, lengths = rle_rows(rows, 1, 127, lambda c: c,
                             lambda c: 0x80 | c, tail=b"\0")
    head = bytearray(512)
    struct.pack_into(">HBBHHHH", head, 0, 474, 1, 1, 2 if grey else 3, w, h,
                     z)
    struct.pack_into(">II", head, 12, 0, 255)
    first = 512 + 8 * z * h
    offsets = first + np.cumsum(lengths) - lengths
    with open(path, "wb") as f:
        f.write(bytes(head))
        f.write(offsets.astype(">u4").tobytes())
        f.write(lengths.astype(">u4").tobytes())
        f.write(data.tobytes())
    return path


def raster_picture(h, w, seed=0):
    """R1's picture: F1's RGB scene with its top eighth made of rows of
    one colour (so the RLE forms have runs as well as literals)."""
    rgb = formats_arrays(h, w, seed)[0]
    rgb[: h // 8] = rgb[: h // 8, :1]
    return rgb


def raster_files(tmp, h, w, seed=0):
    """R1's files in `tmp`: name -> (path, the RGB array it decodes to)."""
    rgb = raster_picture(h, w, seed)
    planes = np.moveaxis(rgb, -1, 0)
    j = os.path.join
    return {
        "TGA raw": (write_tga(j(tmp, "r1.tga"), rgb), rgb),
        "TGA RLE": (write_tga(j(tmp, "r1r.tga"), rgb, rle=True), rgb),
        "PSD raw": (write_psd(j(tmp, "r1.psd"), planes), rgb),
        "PSD PackBits": (write_psd(j(tmp, "r1p.psd"), planes, packbits=True),
                         rgb),
        "QOI": (write_qoi(j(tmp, "r1.qoi"), rgb), rgb),
        "PCX RGB": (write_pcx(j(tmp, "r1.pcx"), rgb), rgb),
        "SGI RLE": (write_sgi(j(tmp, "r1.sgi"), rgb), rgb),
    }


def raster_phase(smi_line, tmp):
    """The simple raster formats decoded by the port on the card's machine
    (no PIL there). R1: `raster_files` at 24 MP (TGA raw and RLE, PSD raw
    and PackBits, QOI, PCX RGB, SGI RLE), each read_image's host ms and
    its array against the one written, then every small raster fixture of
    tests/data (ICO, CUR, DCX, PSD in CMYK, LAB, P and with an ICC,
    16-bit SGI, colour-mapped RLE TGA, 256-colour PCX) against the sha256
    of Pillow's decode (the card machine's g++ build of
    io/native/rasterdec.cc held to Pillow). R2: F2's develop through
    cli.main (P3's Hald film simulation with Texture Boost under an
    external mask, bundled profile, denoise 20/20), the Hald a PackBits
    PSD and the mask an 8-bit RLE SGI, against the same develop from PNG
    files of the same samples: the JPEGs byte-equal, B1-B4 and B7 once
    each and bit-equal to their plain versions on R2's tensors. Returns
    (the comparisons, the failures)."""
    from art_tpu_torch.io import imagefile
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.io.imagefile import write_png
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- raster phase ({smi_line})")
    t_phase = time.monotonic()
    failures = []
    with open(FORMATS_SHA) as f:
        recorded = json.load(f)
    h, w = FORMATS_FRAME
    t0 = time.monotonic()
    files = raster_files(tmp, h, w)
    log(f"R1 files {h}x{w} written in {time.monotonic() - t0:.2f} s: "
        + ", ".join(f"{k} {os.path.getsize(p) / 1e6:.1f} MB"
                    for k, (p, _) in files.items()))
    for name, (path, want) in files.items():
        t0 = time.monotonic()
        mode, samples, _ = imagefile.read_image(path)
        ms = 1e3 * (time.monotonic() - t0)
        ok = mode == "RGB" and np.array_equal(samples, want)
        log(f"R1 {name}: read_image {ms:.1f} ms (host) -> {samples.shape}: "
            f"{'equal' if ok else 'DIFFERENT'}")
        if not ok:
            failures.append(f"R1 {name} decodes differently")
        os.unlink(path)
    del files, samples
    for name in sorted(k for k in recorded if k.startswith("raster_")):
        fpath = os.path.join(FORMATS_DATA, name)
        t0 = time.monotonic()
        got = imagefile.read_rgb8(fpath)
        ms = 1e3 * (time.monotonic() - t0)
        ok = _sha(got) == recorded[name]
        log(f"R1 {name} ({os.path.getsize(fpath)} bytes, "
            f"{got.shape[1]}x{got.shape[0]}): read_rgb8 {ms:.1f} ms (host), "
            f"sha256 {'equal to' if ok else 'NOT'} Pillow's")
        if not ok:
            failures.append(f"R1 {name}: sha256 differs from Pillow's")

    # R2: a PackBits PSD Hald and an RLE SGI mask against PNGs
    hald = hald_image(12, 8)
    mask = f2_mask().astype(np.uint8)
    paths = {"hald": write_psd(os.path.join(tmp, "hald12.psd"),
                               np.moveaxis(hald, -1, 0), packbits=True),
             "mask": write_sgi(os.path.join(tmp, "mask.sgi"), mask),
             "hald_png": os.path.join(tmp, "hald12.png"),
             "mask_png": os.path.join(tmp, "mask.png")}
    write_png(paths["hald_png"], hald)
    write_png(paths["mask_png"], np.repeat(mask[..., None], 3, axis=2))
    t0 = time.monotonic()
    plane, mode = imagefile.read_grey(paths["mask"])
    ms = 1e3 * (time.monotonic() - t0)
    ok = mode == "L" and np.array_equal(plane, mask)
    log(f"R2 mask: the RLE SGI reads as mode {mode} {plane.shape} in "
        f"{ms:.1f} ms (host), {'equal to' if ok else 'NOT'} its samples")
    if not ok:
        failures.append("R2: the SGI mask decodes wrongly")
    frame = flagship_frame(*FRAME)
    dng = os.path.join(tmp, "r2.dng")
    write_dng(dng, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, compress=False)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "art_tpu_torch", "data", "profiles", PROFILE)
    dn = os.path.join(tmp, "denoise20.arp")
    with open(dn, "w") as f:
        f.write("[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n")
    outs = {}
    want = ("b1", "b2", "b3", "b4", "b7")
    for kind, (lut, msk) in {
            "raster": (paths["hald"], paths["mask"]),
            "png": (paths["hald_png"], paths["mask_png"])}.items():
        arp = os.path.join(tmp, f"r2_{kind}.arp")
        with open(arp, "w") as f:
            f.write(f2_arp(lut, msk))
        out = os.path.join(tmp, f"r2_{kind}.jpg")
        argv = ["-Y", "-p", base, "-p", dn, "-p", arp, "-o", out, "-c", dng]
        reset_counts()
        phases, seconds = cli_run(argv)
        launches, plain_calls = read_counts()
        log(f"R2 ({'PSD Hald, SGI mask' if kind == 'raster' else 'PNG Hald, '
            'PNG mask'}) through cli.main: {1e3 * seconds:.1f} ms end to "
            f"end (first); phases {phases}; launches {launches}; plain "
            f"calls {plain_calls}")
        if launches != {k: int(k in want) for k in launches} \
                or any(plain_calls.values()):
            failures.append(f"R2 {kind}: launches {launches}, plain calls "
                            f"{plain_calls}")
        outs[kind] = open(out, "rb").read()
        check_jpeg(out)
    same = outs["raster"] == outs["png"]
    log(f"R2 JPEG from the PSD and SGI "
        f"{'byte-equal to' if same else 'DIFFERS FROM'} the PNGs' "
        f"({len(outs['raster'])} bytes)")
    if not same:
        failures.append("R2: the PSD/SGI develop differs from the PNGs'")
    from art_tpu_torch import cli

    argv = ["-Y", "-p", base, "-p", dn, "-p",
            os.path.join(tmp, "r2_raster.arp"), "-o",
            os.path.join(tmp, "r2_k.jpg"), "-c", dng]
    pp = cli.compose_params(dng, cli.parse_args(argv))
    failures += kernels_against_plain("R2", lambda: tdev.develop(frame, pp),
                                      want)
    log(f"raster phase: {time.monotonic() - t_phase:.1f} s")
    return {}, failures


# ---- the small raster plugins (G1, G2) -----------------------------------

def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)
    return path


def _fits_card(key, value=None):
    if value is None:
        return key.ljust(80).encode()
    return f"{key:<8}= {value:>20}".ljust(80).encode()


def fits_bytes(arr, bitpix):
    """A FITS primary image of (H, W) samples (BITPIX 8, 16, 32, -32 or
    -64, the samples' bits stored big-endian), its first row the image's
    bottom, padded to 2880-byte blocks."""
    h, w = arr.shape
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    head = b"".join([_fits_card("SIMPLE", "T"), _fits_card("BITPIX", bitpix),
                     _fits_card("NAXIS", 2), _fits_card("NAXIS1", w),
                     _fits_card("NAXIS2", h), _fits_card("END")])
    head += b" " * (-len(head) % 2880)
    data = np.ascontiguousarray(arr[::-1]).astype(dt).tobytes()
    return head + data + b"\0" * (-len(data) % 2880)


def write_fits(path, arr, bitpix):
    return _write(path, fits_bytes(arr, bitpix))


def fits_as_pillow(arr):
    """What Pillow's FITS plugin reads from `write_fits` at BITPIX 16 or
    -32: the stored bytes as little-endian samples (its raw mode is the
    mode), the rows put back top-down: each sample's bytes swapped."""
    return arr.byteswap()


def pfm_bytes(arr, scale=-1.0):
    """A PFM of (H, W) float32, bottom row first, little-endian for a
    negative scale."""
    h, w = arr.shape
    dt = "<f4" if scale < 0 else ">f4"
    return (b"Pf\n%d %d\n%s\n" % (w, h, repr(scale).encode())
            + np.ascontiguousarray(arr[::-1]).astype(dt).tobytes())


def write_pfm(path, arr):
    return _write(path, pfm_bytes(arr))


def spider_bytes(arr, big=False):
    """A SPIDER 2D image of (H, W) float32: its header one record of 4 x W
    bytes (or more records, to 1024 bytes), as SPIDER writes it."""
    import struct

    h, w = arr.shape
    lenbyt = 4 * w
    labrec = -(-1024 // lenbyt)
    hdr = [0.0] * (labrec * lenbyt // 4 + 1)
    hdr[1], hdr[2], hdr[3], hdr[5], hdr[12] = 1.0, h, h, 1.0, w
    hdr[13], hdr[22], hdr[23] = labrec, labrec * lenbyt, lenbyt
    e = ">" if big else "<"
    return struct.pack(f"{e}{len(hdr) - 1}f", *hdr[1:]) + \
        np.ascontiguousarray(arr).astype(f"{e}f4").tobytes()


def write_spider(path, arr):
    return _write(path, spider_bytes(arr))


def mcidas_bytes(arr, nbytes, prefix=0, offset=256):
    """A McIdas area of (H, W) samples of `nbytes` bytes (1, 2 or 4),
    big-endian, one band, each line after a `prefix` of line-documentation
    bytes, the data at `offset`."""
    import struct

    h, w = arr.shape
    words = [0] * 65
    words[2], words[9], words[10], words[11] = 4, h, w, nbytes
    words[14], words[15], words[34] = 1, prefix, offset
    dt = {1: ">u1", 2: ">u2", 4: ">i4"}[nbytes]
    lines = np.full((h, prefix + nbytes * w), 7, np.uint8)
    lines[:, prefix:] = np.ascontiguousarray(arr).astype(dt).view(
        np.uint8).reshape(h, -1)
    head = struct.pack("!64i", *words[1:])
    return head + bytes(max(0, offset - 256)) + lines.tobytes()


def write_mcidas(path, arr, prefix=8):
    return _write(path, mcidas_bytes(arr, 2, prefix))


def write_im_rgb(path, rgb):
    """An IM "RGB image": a 512-byte header, then line-interleaved rows
    (each row's R, G and B lines), bottom row first."""
    h, w, _ = rgb.shape
    head = (b"Image type: RGB image\r\nName: g1\r\n"
            b"Image size (x*y): %d*%d\r\n" % (w, h)).ljust(511, b"\0")
    rows = np.ascontiguousarray(np.moveaxis(rgb[::-1], -1, 1))
    return _write(path, head + b"\x1a" + rows.tobytes())


def sun_rle_bytes(raw):
    """Sun's byte run-length code of a uint8 stream: runs of three or
    more (up to 256) as 0x80, count - 1, value; a lone or paired 0x80 as
    0x80 0 each; any other byte as itself."""
    raw = np.ascontiguousarray(raw, np.uint8).reshape(-1)
    n = raw.size
    starts = np.concatenate([[0], np.nonzero(raw[1:] != raw[:-1])[0] + 1])
    lengths = np.diff(np.concatenate([starts, [n]]))
    # split runs longer than 256
    k = (lengths + 255) // 256
    first = np.repeat(starts, k) + (np.arange(k.sum()) - np.repeat(
        np.cumsum(k) - k, k)) * 256
    lens = np.minimum(256, np.repeat(starts + lengths, k) - first)
    vals = raw[first]
    run = lens >= 3
    # a short stretch of 0x80 goes byte by byte, 2 bytes each; others 1
    size = np.where(run, 3, np.where(vals == 0x80, 2 * lens, lens))
    ends = np.cumsum(size)
    at = ends - size
    out = np.empty(int(ends[-1]), np.uint8)
    r = np.nonzero(run)[0]
    out[at[r]], out[at[r] + 1], out[at[r] + 2] = 0x80, lens[r] - 1, vals[r]
    short = np.nonzero(~run)[0]
    for j in (0, 1):  # the first and second byte of a short stretch
        s2 = short[lens[short] > j]
        esc = vals[s2] == 0x80
        pos = at[s2] + np.where(esc, 2 * j, j)
        out[pos] = vals[s2]
        out[pos[esc] + 1] = 0
    return out


def sun_bytes(data, w, h, depth, ftype=1, palette=None):
    """A Sun raster of its stored bytes (`ftype` 2: RLE-coded) and a
    planar RGB colour map."""
    import struct

    pal = b"" if palette is None else bytes(palette)
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), ftype,
                       1 if pal else 0, len(pal)) + pal + bytes(data)


def write_sun_rle(path, rgb):
    """A 24-bit Sun raster, type 2 (RLE) of (H, W, 3) uint8: B, G, R
    bytes, the rows one stream (coded 256 rows at a time)."""
    h, w, _ = rgb.shape
    data = np.concatenate([
        sun_rle_bytes(np.ascontiguousarray(rgb[y : y + 256, :, ::-1]))
        for y in range(0, h, 256)])
    return _write(path, sun_bytes(data, w, h, 24, 2))


def pixar_bytes(rgb):
    """A PIXAR raster of (H, W, 3) uint8: the 1024-byte header (its size
    at 416, the 8-bit RGB storage code at 424), then the pixels."""
    import struct

    h, w, _ = rgb.shape
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\0\0"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, 14, 2)
    return bytes(head) + np.ascontiguousarray(rgb, np.uint8).tobytes()


def write_pixar(path, rgb):
    return _write(path, pixar_bytes(rgb))


def write_float_tiff(path, arr):
    """A little-endian TIFF of one float32 sample a pixel (Pillow's "F")."""
    h, w = arr.shape
    strips = [np.ascontiguousarray(arr[y : y + 256]).astype("<f4").tobytes()
              for y in range(0, h, 256)]
    ents = [(256, 4, [w]), (257, 4, [h]), (258, 3, [32]), (259, 3, [1]),
            (262, 3, [1]), (277, 3, [1]), (278, 4, [256]), (339, 3, [3])]
    with open(path, "wb") as f:
        f.write(tiff_bytes(strips, ents))
    return path


# the Photo CD the phase writes, and the sha256 of Pillow's decode
G1_PCD = "G1 PCD, orientation 1"


def pcd_bytes(orientation=1, seed=0):
    """A Photo CD image pac as far as its base image: the "PCD_" block at
    2048 with the orientation (1, a quarter turn), the 768 x 512 YCC base
    at 96 x 2048: pairs of luma rows (a ramp with noise) over half-width
    chroma."""
    rng = np.random.default_rng(seed)
    head = bytearray(96 * 2048)
    head[2048 : 2048 + 7] = b"PCD_IPI"
    head[2048 + 1538] = orientation
    x = np.arange(768)
    luma = ((x[None, :] // 3 + np.arange(512)[:, None] // 2) % 256 +
            rng.integers(0, 6, (512, 768))).clip(0, 255).astype(np.uint8)
    chroma = rng.integers(90, 190, (256, 2, 384)).astype(np.uint8)
    body = np.concatenate([luma.reshape(256, 2 * 768),
                           chroma.reshape(256, 768)], 1)
    return bytes(head) + body.tobytes()


def write_pcd(path, seed=0):
    return _write(path, pcd_bytes(1, seed))


def plugin_files(tmp, h, w, seed=0):
    """G1's files in `tmp`: name -> (path, the mode read_image gives, the
    samples it gives: each written array read as Pillow reads it)."""
    rgb, grey16 = formats_arrays(h, w, seed)[:2]
    f32 = (grey16.astype(np.float32) / 65535.0) ** np.float32(2.2)
    j = os.path.join
    return {
        "FITS 16-bit": (write_fits(j(tmp, "g1.fits"), grey16, 16), "I;16",
                        fits_as_pillow(grey16)),
        "FITS float32": (write_fits(j(tmp, "g1f.fits"), f32, -32), "F",
                         fits_as_pillow(f32)),
        "PFM": (write_pfm(j(tmp, "g1.pfm"), f32), "F", f32),
        "SPIDER": (write_spider(j(tmp, "g1.spi"), f32), "F", f32),
        "McIdas 16-bit": (write_mcidas(j(tmp, "g1.area"), grey16), "I;16B",
                          grey16),
        "IM RGB;L": (write_im_rgb(j(tmp, "g1.im"), rgb), "RGB", rgb),
        "SUN RLE 24-bit": (write_sun_rle(j(tmp, "g1.ras"), rgb), "RGB", rgb),
        "PIXAR": (write_pixar(j(tmp, "g1.pxr"), rgb), "RGB", rgb),
    }


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize and \
        np.array_equal(a.view(f"u{a.dtype.itemsize}"),
                       b.view(f"u{b.dtype.itemsize}"))


def plugin_phase(smi_line, tmp):
    """The small raster plugins decoded by the port on the card's machine
    (no PIL there). G1: `plugin_files` at 24 MP (FITS 16-bit and float32,
    PFM, SPIDER, McIdas 16-bit, IM RGB;L, RLE SUN 24-bit, PIXAR), each
    read_image's host ms and its mode and samples against the array
    written, read as Pillow reads it (FITS's big-endian samples as
    little-endian); then every small plugin fixture of tests/data and the
    Photo CD `write_pcd` writes, against the sha256 of Pillow's decode.
    G2: F2's develop through cli.main (P3's Hald film simulation with
    Texture Boost under an external mask, bundled profile, denoise
    20/20), the Hald an RLE SUN raster and the mask a PFM of mode F,
    against the same develop from a PNG Hald and a float32 TIFF mask of
    the same samples: the JPEGs byte-equal, B1-B4 and B7 once each and
    bit-equal to their plain versions on G2's tensors. Returns (the
    comparisons, the failures)."""
    from art_tpu_torch.io import imagefile
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.io.imagefile import write_png
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- plugin phase ({smi_line})")
    t_phase = time.monotonic()
    failures = []
    with open(FORMATS_SHA) as f:
        recorded = json.load(f)
    h, w = FORMATS_FRAME
    t0 = time.monotonic()
    files = plugin_files(tmp, h, w)
    log(f"G1 files {h}x{w} written in {time.monotonic() - t0:.2f} s: "
        + ", ".join(f"{k} {os.path.getsize(p) / 1e6:.1f} MB"
                    for k, (p, _, _) in files.items()))
    for name, (path, want_mode, want) in files.items():
        t0 = time.monotonic()
        mode, samples, _ = imagefile.read_image(path)
        ms = 1e3 * (time.monotonic() - t0)
        ok = mode == want_mode and _bits_equal(samples, want)
        log(f"G1 {name}: read_image {ms:.1f} ms (host) -> mode {mode} "
            f"{samples.shape} {samples.dtype}: "
            f"{'equal' if ok else 'DIFFERENT'}")
        if not ok:
            failures.append(f"G1 {name} decodes differently")
        os.unlink(path)
    del files, samples
    fixtures = {k: os.path.join(FORMATS_DATA, k) for k in recorded
                if k.startswith("plugin_")}
    fixtures[G1_PCD] = write_pcd(os.path.join(tmp, "g1.pcd"))
    for name in sorted(fixtures):
        fpath = fixtures[name]
        t0 = time.monotonic()
        got = imagefile.read_rgb8(fpath)
        ms = 1e3 * (time.monotonic() - t0)
        ok = _sha(got) == recorded[name]
        log(f"G1 {name} ({os.path.getsize(fpath)} bytes, "
            f"{got.shape[1]}x{got.shape[0]}): read_rgb8 {ms:.1f} ms (host), "
            f"sha256 {'equal to' if ok else 'NOT'} Pillow's")
        if not ok:
            failures.append(f"G1 {name}: sha256 differs from Pillow's")

    # G2: an RLE SUN Hald and a PFM mask against a PNG and a float TIFF
    hald = hald_image(12, 8)
    mask = (f2_mask().astype(np.float32) / np.float32(255.0))
    paths = {"hald": write_sun_rle(os.path.join(tmp, "hald12.ras"), hald),
             "mask": write_pfm(os.path.join(tmp, "mask.pfm"), mask),
             "hald_png": os.path.join(tmp, "hald12.png"),
             "mask_tif": write_float_tiff(os.path.join(tmp, "mask.tif"),
                                          mask)}
    write_png(paths["hald_png"], hald)
    t0 = time.monotonic()
    plane, mode = imagefile.read_grey(paths["mask"])
    ms = 1e3 * (time.monotonic() - t0)
    ok = mode == "F" and _bits_equal(plane, mask)
    log(f"G2 mask: the PFM reads as mode {mode} {plane.shape} in "
        f"{ms:.1f} ms (host), {'equal to' if ok else 'NOT'} its samples")
    if not ok:
        failures.append("G2: the PFM mask decodes wrongly")
    frame = flagship_frame(*FRAME)
    dng = os.path.join(tmp, "g2.dng")
    write_dng(dng, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, compress=False)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "art_tpu_torch", "data", "profiles", PROFILE)
    dn = os.path.join(tmp, "denoise20.arp")
    with open(dn, "w") as f:
        f.write("[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n")
    outs = {}
    want = ("b1", "b2", "b3", "b4", "b7")
    for kind, (lut, msk) in {
            "plugins": (paths["hald"], paths["mask"]),
            "png": (paths["hald_png"], paths["mask_tif"])}.items():
        arp = os.path.join(tmp, f"g2_{kind}.arp")
        with open(arp, "w") as f:
            f.write(f2_arp(lut, msk))
        out = os.path.join(tmp, f"g2_{kind}.jpg")
        argv = ["-Y", "-p", base, "-p", dn, "-p", arp, "-o", out, "-c", dng]
        reset_counts()
        phases, seconds = cli_run(argv)
        launches, plain_calls = read_counts()
        log(f"G2 ({'SUN Hald, PFM mask' if kind == 'plugins' else 'PNG '
            'Hald, float TIFF mask'}) through cli.main: "
            f"{1e3 * seconds:.1f} ms end to end (first); phases {phases}; "
            f"launches {launches}; plain calls {plain_calls}")
        if launches != {k: int(k in want) for k in launches} \
                or any(plain_calls.values()):
            failures.append(f"G2 {kind}: launches {launches}, plain calls "
                            f"{plain_calls}")
        outs[kind] = open(out, "rb").read()
        check_jpeg(out)
    same = outs["plugins"] == outs["png"]
    log(f"G2 JPEG from the SUN and PFM "
        f"{'byte-equal to' if same else 'DIFFERS FROM'} the PNG's and "
        f"TIFF's ({len(outs['plugins'])} bytes)")
    if not same:
        failures.append("G2: the SUN/PFM develop differs from the PNG/TIFF")
    from art_tpu_torch import cli

    argv = ["-Y", "-p", base, "-p", dn, "-p",
            os.path.join(tmp, "g2_plugins.arp"), "-o",
            os.path.join(tmp, "g2_k.jpg"), "-c", dng]
    pp = cli.compose_params(dng, cli.parse_args(argv))
    failures += kernels_against_plain("G2", lambda: tdev.develop(frame, pp),
                                      want)
    log(f"plugin phase: {time.monotonic() - t_phase:.1f} s")
    return {}, failures


# ---- the texture and icon formats (texture_phase): DDS and BLP writers;
# the CPU tests write their files with them too

def dds_bytes(w, h, data, pfflags, fourcc=b"\0\0\0\0", bitcount=0,
              masks=(0, 0, 0, 0), dxgi=None, extra=b""):
    """A DDS: the 124-byte header (the pixel format's flags, FourCC, bit
    count and four masks), DX10's 20 bytes where `dxgi` is given, `extra`
    (a palette), then `data`."""
    pf = struct.pack("<4I", 32, pfflags, int.from_bytes(fourcc, "little"),
                     bitcount) + struct.pack("<4I", *masks)
    head = (struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0) + bytes(44) + pf
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    dx10 = b"" if dxgi is None else struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return b"DDS " + head + dx10 + extra + data


def blp2_bytes(w, h, encoding, alpha_depth, alpha_encoding, mip0,
               palette=None):
    """A BLP2 of one mipmap: the header, the 16 mipmap offsets and lengths
    (the first after the 256-entry BGRA palette), the palette, `mip0`."""
    pal = bytes(1024) if palette is None else bytes(palette)
    off = 20 + 128 + len(pal)
    return (b"BLP2" + struct.pack("<i4bII", 1, encoding, alpha_depth,
                                  alpha_encoding, 0, w, h)
            + struct.pack("<16I", off, *[0] * 15)
            + struct.pack("<16I", len(mip0), *[0] * 15) + pal + mip0)


def dds_rgb_bytes(rgb, alpha=None, bits=32):
    """An uncompressed DDS of (H, W, 3) uint8: A8R8G8B8 (bits 32, `alpha`
    its alpha, else 255), R8G8B8 (24), or R5G6B5 (16, the top 5, 6 and 5
    bits of each sample)."""
    h, w = rgb.shape[:2]
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    if bits == 16:
        v = (r >> 3) << 11 | (g >> 2) << 5 | b >> 3
        return dds_bytes(w, h, v.astype("<u2").tobytes(), 0x40, bitcount=16,
                         masks=(0xF800, 0x7E0, 0x1F, 0))
    if bits == 24:
        data = np.ascontiguousarray(rgb[..., ::-1]).tobytes()
        return dds_bytes(w, h, data, 0x40, bitcount=24,
                         masks=(0xFF0000, 0xFF00, 0xFF, 0))
    a = np.full((h, w), 255, np.uint32) if alpha is None else \
        alpha.astype(np.uint32)
    v = a << 24 | r << 16 | g << 8 | b
    return dds_bytes(w, h, v.astype("<u4").tobytes(), 0x41, bitcount=32,
                     masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))


def rgb565_as_pillow(rgb):
    """`dds_rgb_bytes(rgb, bits=16)` as Pillow's dds_rgb decoder reads it:
    each field v of n bits as int(v / (2^n - 1) * 255)."""
    out = np.empty_like(rgb)
    for i, n in enumerate((5, 6, 5)):
        v = (rgb[..., i] >> (8 - n)).astype(np.float64)
        out[..., i] = (v / ((1 << n) - 1) * 255).astype(np.uint8)
    return out


def texture_blocks(path):
    """(header, blocks, blocks down, blocks across, bytes a block) of a
    block-compressed texture fixture that ends with its blocks: a DDS of
    a FourCC or a DX10 format (the data after the header), or a BLP2 of
    DXT blocks (its first mipmap)."""
    buf = open(path, "rb").read()
    if buf[:4] == b"DDS ":
        h, w = struct.unpack_from("<2I", buf, 12)
        at = 128 + (20 if buf[84:88] == b"DX10" else 0)
    else:
        w, h = struct.unpack_from("<2I", buf, 12)
        at = struct.unpack_from("<I", buf, 20)[0]
    bh, bw = (h + 3) // 4, (w + 3) // 4
    return buf[:at], buf[at:], bh, bw, (len(buf) - at) // (bh * bw)


def tile_texture(path, out, h, w):
    """A (h, w) texture (multiples of 4) whose block (y, x) is the
    fixture's block (y mod its rows, x mod its columns): the fixture's
    header with the size and, for a BLP, the first mipmap's length
    changed. Returns out."""
    head, blocks, bh, bw, size = texture_blocks(path)
    grid = np.frombuffer(blocks, np.uint8).reshape(bh, bw, size)
    big = grid[np.arange(h // 4) % bh][:, np.arange(w // 4) % bw]
    head = bytearray(head)
    if head[:4] == b"DDS ":
        struct.pack_into("<2I", head, 12, h, w)
    else:
        struct.pack_into("<2I", head, 12, w, h)
        struct.pack_into("<I", head, 84, big.size)
    with open(out, "wb") as f:
        f.write(bytes(head))
        f.write(big.tobytes())
    return out


def tiled_decode(rgb, h, w):
    """The decode of `tile_texture`'s file from its fixture's: blocks are
    decoded alone, so the fixture's pixels repeat."""
    fh, fw = rgb.shape[:2]
    return rgb[np.arange(h) % fh][:, np.arange(w) % fw]


def blp_palette_bytes(idx, palette):
    """A BLP2 of one uncompressed mipmap: `idx` (H, W) uint8 into
    `palette` (256, 3) RGB, stored BGRA, no alpha."""
    h, w = idx.shape
    bgra = np.zeros((256, 4), np.uint8)
    bgra[:, :3] = np.asarray(palette, np.uint8)[:, ::-1]
    return blp2_bytes(w, h, 1, 0, 0, np.ascontiguousarray(idx).tobytes(),
                      bgra.tobytes())


def texture_files(tmp, h, w, seed=0):
    """K1's files in `tmp` that are written from arrays: name -> (path,
    the RGB read_rgb8 must give)."""
    rgb = formats_arrays(h, w, seed)[0]
    rng = np.random.default_rng(seed + 1)
    alpha = rng.integers(0, 256, (h, w)).astype(np.uint8)
    idx = rng.integers(0, 256, (h, w)).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    j = os.path.join
    rgba = np.concatenate([rgb, alpha[..., None]], -1)
    return {
        "DDS A8R8G8B8": (_write(j(tmp, "k1a.dds"), dds_rgb_bytes(rgb, alpha)),
                         rgb),
        "DDS R5G6B5": (_write(j(tmp, "k1b.dds"), dds_rgb_bytes(rgb, bits=16)),
                       rgb565_as_pillow(rgb)),
        "DDS DX10 R8G8B8A8": (_write(j(tmp, "k1c.dds"), dds_bytes(
            w, h, rgba.tobytes(), 4, b"DX10", dxgi=28)), rgb),
        "BLP2 palette": (_write(j(tmp, "k1d.blp"),
                                blp_palette_bytes(idx, pal)), pal[idx]),
    }


# the fixtures K1 tiles to 24 MP: (K1's name, fixture)
K1_TILED = (("DDS BC1", "tex_bc1.dds"), ("DDS BC7", "tex_bc7.dds"),
            ("BLP2 DXT5", "tex_dxt5.blp"))


def texture_phase(smi_line, tmp):
    """The texture and icon formats decoded by the port on the card's
    machine (no PIL there). K1: `texture_files` at 24 MP (DDS of
    A8R8G8B8 and R5G6B5 masks, DX10 R8G8B8A8, a BLP2 palette file), each
    read_rgb8's host ms against the array written (the 5-6-5 samples as
    Pillow's dds_rgb scales them); a BC1 and a BC7 DDS and a DXT5 BLP2
    tiled from the committed fixtures' blocks (K1_TILED), each against
    the same tiling of the fixture's decode; every committed texture and
    icon fixture against the sha256 of Pillow's decode. K2: F2's develop
    through cli.main (P3's Hald film simulation with Texture Boost under
    an external mask, bundled profile, denoise 20/20), the Hald an
    uncompressed DDS and the mask a BLP2 palette file, against the same
    develop from a PNG Hald and a PNG mask of the same samples and mode:
    the JPEGs byte-equal, B1-B4 and B7 once each and bit-equal to their
    plain versions on K2's tensors. Returns (the comparisons, the
    failures)."""
    from art_tpu_torch.io import imagefile
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.io.imagefile import write_png
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- texture phase ({smi_line})")
    t_phase = time.monotonic()
    failures = []
    with open(FORMATS_SHA) as f:
        recorded = json.load(f)
    fixtures = sorted(k for k in recorded if k.startswith("tex_"))
    decoded = {}
    for name in fixtures:
        fpath = os.path.join(FORMATS_DATA, name)
        t0 = time.monotonic()
        got = imagefile.read_rgb8(fpath)
        ms = 1e3 * (time.monotonic() - t0)
        ok = _sha(got) == recorded[name]
        decoded[name] = got
        log(f"K1 {name} ({os.path.getsize(fpath)} bytes, "
            f"{got.shape[1]}x{got.shape[0]}): read_rgb8 {ms:.1f} ms (host), "
            f"sha256 {'equal to' if ok else 'NOT'} Pillow's")
        if not ok:
            failures.append(f"K1 {name}: sha256 differs from Pillow's")
    h, w = FORMATS_FRAME
    t0 = time.monotonic()
    files = texture_files(tmp, h, w)
    for label, name in K1_TILED:
        path = tile_texture(os.path.join(FORMATS_DATA, name),
                            os.path.join(tmp, name), h, w)
        files[label] = (path, tiled_decode(decoded[name], h, w))
    log(f"K1 files {h}x{w} written in {time.monotonic() - t0:.2f} s: "
        + ", ".join(f"{k} {os.path.getsize(p) / 1e6:.1f} MB"
                    for k, (p, _) in files.items()))
    for name, (path, want) in files.items():
        t0 = time.monotonic()
        got = imagefile.read_rgb8(path)
        ms = 1e3 * (time.monotonic() - t0)
        ok = got.shape == want.shape and np.array_equal(got, want)
        log(f"K1 {name}: read_rgb8 {ms:.1f} ms (host) -> {got.shape}: "
            f"{'equal' if ok else 'DIFFERENT'}")
        if not ok:
            failures.append(f"K1 {name} decodes differently")
        os.unlink(path)
    del files, got, want

    # K2: an uncompressed DDS Hald and a BLP2 palette mask against PNGs
    hald = hald_image(12, 8)
    mask = f2_mask().astype(np.uint8)
    grey = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    paths = {"hald": _write(os.path.join(tmp, "hald12.dds"),
                            dds_rgb_bytes(hald, bits=24)),
             "mask": _write(os.path.join(tmp, "mask.blp"),
                            blp_palette_bytes(mask, grey)),
             "hald_png": os.path.join(tmp, "hald12.png"),
             "mask_png": os.path.join(tmp, "mask.png")}
    write_png(paths["hald_png"], hald)
    write_png(paths["mask_png"], np.repeat(mask[..., None], 3, 2))
    for key, want in (("hald", hald), ("mask", grey[mask])):
        t0 = time.monotonic()
        got = imagefile.read_rgb8(paths[key])
        ms = 1e3 * (time.monotonic() - t0)
        ok = np.array_equal(got, want)
        log(f"K2 {key}: {os.path.basename(paths[key])} {got.shape} in "
            f"{ms:.1f} ms (host), {'equal to' if ok else 'NOT'} its samples")
        if not ok:
            failures.append(f"K2: the {key} decodes wrongly")
    frame = flagship_frame(*FRAME)
    dng = os.path.join(tmp, "k2.dng")
    write_dng(dng, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, compress=False)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "art_tpu_torch", "data", "profiles", PROFILE)
    dn = os.path.join(tmp, "denoise20.arp")
    with open(dn, "w") as f:
        f.write("[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n")
    outs = {}
    want = ("b1", "b2", "b3", "b4", "b7")
    for kind, (lut, msk) in {
            "textures": (paths["hald"], paths["mask"]),
            "png": (paths["hald_png"], paths["mask_png"])}.items():
        arp = os.path.join(tmp, f"k2_{kind}.arp")
        with open(arp, "w") as f:
            f.write(f2_arp(lut, msk))
        out = os.path.join(tmp, f"k2_{kind}.jpg")
        argv = ["-Y", "-p", base, "-p", dn, "-p", arp, "-o", out, "-c", dng]
        reset_counts()
        phases, seconds = cli_run(argv)
        launches, plain_calls = read_counts()
        log(f"K2 ({'DDS Hald, BLP mask' if kind == 'textures' else 'PNG '
            'Hald, PNG mask'}) through cli.main: "
            f"{1e3 * seconds:.1f} ms end to end (first); phases {phases}; "
            f"launches {launches}; plain calls {plain_calls}")
        if launches != {k: int(k in want) for k in launches} \
                or any(plain_calls.values()):
            failures.append(f"K2 {kind}: launches {launches}, plain calls "
                            f"{plain_calls}")
        outs[kind] = open(out, "rb").read()
        check_jpeg(out)
    same = outs["textures"] == outs["png"]
    log(f"K2 JPEG from the DDS and BLP "
        f"{'byte-equal to' if same else 'DIFFERS FROM'} the PNGs' "
        f"({len(outs['textures'])} bytes)")
    if not same:
        failures.append("K2: the DDS/BLP develop differs from the PNGs'")
    from art_tpu_torch import cli

    argv = ["-Y", "-p", base, "-p", dn, "-p",
            os.path.join(tmp, "k2_textures.arp"), "-o",
            os.path.join(tmp, "k2_k.jpg"), "-c", dng]
    pp = cli.compose_params(dng, cli.parse_args(argv))
    failures += kernels_against_plain("K2", lambda: tdev.develop(frame, pp),
                                      want)
    log(f"texture phase: {time.monotonic() - t_phase:.1f} s")
    return {}, failures


# -- JPEG 2000 (Q1, Q2) ------------------------------------------------------

# Q1: the 24 MP files tiled from a committed one-tile fixture (Pillow 12.1.0
# wrote each: T x T, 3 resolutions, 64x64 code-blocks, so every tile at a
# multiple of T has the fixture's partitions): (name, fixture, wrapped in
# a JP2)
Q1_FRAME = (4096, 6144)
Q1_TILED = (("Q1 JP2 lossless (5/3), 256x256 tiles",
             "j2k_q1_lossless_tile.j2k", True),
            ("Q1 J2K 9/7, three layers, 512x512 tiles",
             "j2k_q1_97_layers_tile.j2k", False))
# Q2's committed Hald (level 6, lossless JP2) and mask (a lossless J2K
# codestream of f2_mask at Q2_MASK)
Q2_HALD, Q2_MASK_FILE, Q2_MASK = "j2k_q2_hald6.jp2", "j2k_q2_mask.j2k", \
    (200, 300)


def j2k_segments(cs):
    """The main header's marker segments of a codestream, (marker, bytes
    with the marker) up to the first SOT, and the SOT's offset."""
    pos, out = 2, []
    while True:
        m = struct.unpack_from(">H", cs, pos)[0]
        if m == 0xFF90:
            return out, pos
        n = struct.unpack_from(">H", cs, pos + 2)[0]
        out.append((m, cs[pos : pos + 2 + n]))
        pos += 2 + n


def jp2_wrap(cs, h, w, nc, enumcs=16):
    """A JP2 of codestream `cs`: jP, ftyp, jp2h (ihdr, colr), jp2c."""
    def box(kind, payload):
        return struct.pack(">I", 8 + len(payload)) + kind + payload

    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, 7, 7, 0, 0))
    colr = box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", enumcs))
    return (b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
            + box(b"ftyp", b"jp2 \0\0\0\0jp2 ") + box(b"jp2h", ihdr + colr)
            + box(b"jp2c", cs))


def j2k_tiled(fixture, h, w, jp2=False):
    """A (h, w) codestream (or JP2) whose every tile is the one-tile
    `fixture`'s tile-part: its main header with SIZ's size set to (h, w)
    and its tile size to the fixture's, then one tile-part a tile with
    only Isot changed, then EOC. h and w are multiples of the tile."""
    segs, sot = j2k_segments(fixture)
    psot = struct.unpack_from(">I", fixture, sot + 6)[0]
    body = fixture[sot + 12 : sot + psot]
    out = [b"\xff\x4f"]
    for m, seg in segs:
        if m == 0xFF51:
            seg = bytearray(seg)
            t = struct.unpack_from(">I", seg, 6)[0]
            struct.pack_into(">8I", seg, 6, w, h, 0, 0, t, t, 0, 0)
            nc = struct.unpack_from(">H", seg, 38)[0]
            seg = bytes(seg)
        out.append(seg)
    for k in range((h // t) * (w // t)):
        out.append(b"\xff\x90" + struct.pack(">HHIBB", 10, k, psot, 0, 1))
        out.append(body)
    out.append(b"\xff\xd9")
    cs = b"".join(out)
    return jp2_wrap(cs, h, w, nc) if jp2 else cs


def jpeg2000_phase(smi_line, tmp):
    """JPEG 2000 decoded by the port on the card's machine (no PIL there).
    Q1: two 24 MP files tiled from the committed one-tile fixtures
    (Q1_TILED: a lossless JP2 of 256x256 tiles, a three-layer 9/7
    codestream of 512x512 tiles), each read_rgb8's host ms against the
    same tiling of the fixture's decode and against the sha256 of
    Pillow's decode of the same file; every committed JPEG 2000 fixture
    against the sha256 of Pillow's decode. Q2: F2's develop through
    cli.main (P3's Hald film simulation with Texture Boost under an
    external mask, bundled profile, denoise 20/20), the Hald a lossless
    JP2 and the mask a J2K codestream, both committed, against the same
    develop from a PNG Hald and a PNG mask of the same samples and mode:
    the JPEGs byte-equal, B1-B4 and B7 once each and bit-equal to their
    plain versions on Q2's tensors. Returns (the comparisons, the
    failures)."""
    from art_tpu_torch.io import imagefile
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.io.imagefile import write_png
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- JPEG 2000 phase ({smi_line})")
    t_phase = time.monotonic()
    failures = []
    with open(FORMATS_SHA) as f:
        recorded = json.load(f)
    fixtures = sorted(k for k in recorded if k.startswith("j2k_"))
    decoded = {}
    for name in fixtures:
        fpath = os.path.join(FORMATS_DATA, name)
        t0 = time.monotonic()
        got = imagefile.read_rgb8(fpath)
        ms = 1e3 * (time.monotonic() - t0)
        ok = _sha(got) == recorded[name]
        decoded[name] = got
        log(f"Q1 {name} ({os.path.getsize(fpath)} bytes, "
            f"{got.shape[1]}x{got.shape[0]}): read_rgb8 {ms:.1f} ms (host), "
            f"sha256 {'equal to' if ok else 'NOT'} Pillow's")
        if not ok:
            failures.append(f"Q1 {name}: sha256 differs from Pillow's")
    h, w = Q1_FRAME
    for label, name, jp2 in Q1_TILED:
        with open(os.path.join(FORMATS_DATA, name), "rb") as f:
            fixture = f.read()
        t0 = time.monotonic()
        path = _write(os.path.join(tmp, name), j2k_tiled(fixture, h, w, jp2))
        t1 = time.monotonic()
        got = imagefile.read_rgb8(path)
        ms = 1e3 * (time.monotonic() - t1)
        want = tiled_decode(decoded[name], h, w)
        ok = got.shape == want.shape and np.array_equal(got, want)
        same = _sha(got) == recorded[f"{label} {w}x{h}"]
        Q1_MS[label] = ms
        log(f"{label}: {w}x{h} file {os.path.getsize(path) / 1e6:.2f} MB "
            f"written in {t1 - t0:.2f} s; read_rgb8 {ms:.1f} ms (host) -> "
            f"{got.shape}: {'equal to' if ok else 'DIFFERENT FROM'} the "
            f"fixture's tiling, sha256 {'equal to' if same else 'NOT'} "
            f"Pillow's")
        if not (ok and same):
            failures.append(f"{label} decodes differently")
        os.unlink(path)
    del got, want

    # Q2: a lossless JP2 Hald and a J2K mask against PNGs
    hald = hald_image(6, 8)
    mask = f2_mask(*Q2_MASK).astype(np.uint8)
    paths = {"hald": os.path.join(FORMATS_DATA, Q2_HALD),
             "mask": os.path.join(FORMATS_DATA, Q2_MASK_FILE),
             "hald_png": os.path.join(tmp, "hald6.png"),
             "mask_png": os.path.join(tmp, "mask.png")}
    write_png(paths["hald_png"], hald)
    write_png(paths["mask_png"], np.repeat(mask[..., None], 3, 2))
    for key, want in (("hald", hald), ("mask", np.repeat(mask[..., None], 3,
                                                         2))):
        t0 = time.monotonic()
        got = imagefile.read_rgb8(paths[key])
        ms = 1e3 * (time.monotonic() - t0)
        ok = np.array_equal(got, want)
        log(f"Q2 {key}: {os.path.basename(paths[key])} {got.shape} in "
            f"{ms:.1f} ms (host), {'equal to' if ok else 'NOT'} its samples")
        if not ok:
            failures.append(f"Q2: the {key} decodes wrongly")
    frame = flagship_frame(*FRAME)
    dng = os.path.join(tmp, "q2.dng")
    write_dng(dng, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, compress=False)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "art_tpu_torch", "data", "profiles", PROFILE)
    dn = os.path.join(tmp, "denoise20.arp")
    with open(dn, "w") as f:
        f.write("[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n")
    outs = {}
    want = ("b1", "b2", "b3", "b4", "b7")
    for kind, (lut, msk) in {
            "jpeg2000": (paths["hald"], paths["mask"]),
            "png": (paths["hald_png"], paths["mask_png"])}.items():
        arp = os.path.join(tmp, f"q2_{kind}.arp")
        with open(arp, "w") as f:
            f.write(f2_arp(lut, msk))
        out = os.path.join(tmp, f"q2_{kind}.jpg")
        argv = ["-Y", "-p", base, "-p", dn, "-p", arp, "-o", out, "-c", dng]
        reset_counts()
        phases, seconds = cli_run(argv)
        launches, plain_calls = read_counts()
        log(f"Q2 ({'JP2 Hald, J2K mask' if kind == 'jpeg2000' else 'PNG '
            'Hald, PNG mask'}) through cli.main: "
            f"{1e3 * seconds:.1f} ms end to end (first); phases {phases}; "
            f"launches {launches}; plain calls {plain_calls}")
        if launches != {k: int(k in want) for k in launches} \
                or any(plain_calls.values()):
            failures.append(f"Q2 {kind}: launches {launches}, plain calls "
                            f"{plain_calls}")
        outs[kind] = open(out, "rb").read()
        check_jpeg(out)
    same = outs["jpeg2000"] == outs["png"]
    log(f"Q2 JPEG from the JP2 and J2K "
        f"{'byte-equal to' if same else 'DIFFERS FROM'} the PNGs' "
        f"({len(outs['jpeg2000'])} bytes)")
    if not same:
        failures.append("Q2: the JPEG 2000 develop differs from the PNGs'")
    from art_tpu_torch import cli

    argv = ["-Y", "-p", base, "-p", dn, "-p",
            os.path.join(tmp, "q2_jpeg2000.arp"), "-o",
            os.path.join(tmp, "q2_k.jpg"), "-c", dng]
    pp = cli.compose_params(dng, cli.parse_args(argv))
    failures += kernels_against_plain("Q2", lambda: tdev.develop(frame, pp),
                                      want)
    log(f"JPEG 2000 phase: {time.monotonic() - t_phase:.1f} s")
    return {}, failures


# -- HTJ2K and the last forms Pillow decodes (U1, U2) --------------------------

# U1: the 24 MP HTJ2K files tiled from a committed one-tile fixture
# (tests/util_htforms.py wrote each: T x T, 4 resolutions, 64x64 blocks):
# (name, fixture, wrapped in a JP2)
U1_TILED = (("U1 HTJ2K 9/7 with SigProp and MagRef, 512x512 tiles",
             "u1_htj2k_97_sigprop_tile.j2k", False),
            ("U1 HTJ2K JP2 lossless (5/3), 256x256 tiles",
             "u1_htj2k_53_tile.j2k", True))
# U2's committed Hald (level 6, reversible 5/3 with SigProp and MagRef, a
# JP2) and mask (f2_mask at Q2_MASK, a lossless HTJ2K codestream)
U2_HALD, U2_MASK_FILE = "u2_htj2k_hald6.jp2", "u2_htj2k_mask.j2k"
# Q1's read_rgb8 host ms by label, kept by jpeg2000_phase for U1
Q1_MS = {}


def htj2k_phase(smi_line, tmp):
    """The last forms Pillow decodes, read by the port on the card's
    machine (no PIL there). U1: every committed U fixture (HTJ2K, an
    old-style JPEG grey TIFF, YCbCr TIFFs in separate planes and in
    tiles, an IPTC/NAA file with a JPEG band) against the sha256 of
    Pillow's decode; two 24 MP HTJ2K files tiled from the committed
    one-tile fixtures (U1_TILED), each read_rgb8's host ms beside Q1's
    MQ decode of its like, against the same tiling of the fixture's
    decode and the sha256 of Pillow's decode of the same file. U2: F2's
    develop through cli.main (P3's Hald film simulation with Texture
    Boost under an external mask, bundled profile, denoise 20/20), the
    Hald a reversible HTJ2K JP2 and the mask an HTJ2K codestream, both
    committed, against the same develop from PNGs of the same samples:
    the JPEGs byte-equal, B1-B4 and B7 once each and bit-equal to their
    plain versions on U2's tensors. Returns (the comparisons, the
    failures)."""
    from art_tpu_torch.io import imagefile
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.io.imagefile import write_png
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- HTJ2K phase ({smi_line})")
    t_phase = time.monotonic()
    failures = []
    with open(FORMATS_SHA) as f:
        recorded = json.load(f)
    decoded = {}
    for name in sorted(k for k in recorded if k.startswith(("u1_", "u2_"))):
        fpath = os.path.join(FORMATS_DATA, name)
        t0 = time.monotonic()
        got = imagefile.read_rgb8(fpath)
        ms = 1e3 * (time.monotonic() - t0)
        ok = _sha(got) == recorded[name]
        decoded[name] = got
        log(f"U1 {name} ({os.path.getsize(fpath)} bytes, "
            f"{got.shape[1]}x{got.shape[0]}): read_rgb8 {ms:.1f} ms (host), "
            f"sha256 {'equal to' if ok else 'NOT'} Pillow's")
        if not ok:
            failures.append(f"U1 {name}: sha256 differs from Pillow's")
    h, w = Q1_FRAME
    q1_like = {False: Q1_TILED[1][0], True: Q1_TILED[0][0]}
    for label, name, jp2 in U1_TILED:
        with open(os.path.join(FORMATS_DATA, name), "rb") as f:
            fixture = f.read()
        t0 = time.monotonic()
        path = _write(os.path.join(tmp, name), j2k_tiled(fixture, h, w, jp2))
        t1 = time.monotonic()
        got = imagefile.read_rgb8(path)
        ms = 1e3 * (time.monotonic() - t1)
        want = tiled_decode(decoded[name], h, w)
        ok = got.shape == want.shape and np.array_equal(got, want)
        same = _sha(got) == recorded[f"{label} {w}x{h}"]
        mq = Q1_MS.get(q1_like[jp2])
        log(f"{label}: {w}x{h} file {os.path.getsize(path) / 1e6:.2f} MB "
            f"written in {t1 - t0:.2f} s; read_rgb8 {ms:.1f} ms (host; "
            f"{q1_like[jp2]} (MQ): "
            f"{'not measured' if mq is None else f'{mq:.1f} ms'}) -> "
            f"{got.shape}: {'equal to' if ok else 'DIFFERENT FROM'} the "
            f"fixture's tiling, sha256 {'equal to' if same else 'NOT'} "
            f"Pillow's ({smi_line})")
        if not (ok and same):
            failures.append(f"{label} decodes differently")
        os.unlink(path)
    del got, want

    # U2: an HTJ2K Hald and mask against PNGs of the same samples
    hald = decoded[U2_HALD]
    mask = decoded[U2_MASK_FILE]
    if not np.array_equal(mask[..., 0],
                          f2_mask(*Q2_MASK).astype(np.uint8)):
        failures.append("U2: the mask decodes wrongly")
    paths = {"hald": os.path.join(FORMATS_DATA, U2_HALD),
             "mask": os.path.join(FORMATS_DATA, U2_MASK_FILE),
             "hald_png": os.path.join(tmp, "hald6.png"),
             "mask_png": os.path.join(tmp, "mask.png")}
    write_png(paths["hald_png"], hald)
    write_png(paths["mask_png"], mask)
    frame = flagship_frame(*FRAME)
    dng = os.path.join(tmp, "u2.dng")
    write_dng(dng, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, compress=False)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "art_tpu_torch", "data", "profiles", PROFILE)
    dn = os.path.join(tmp, "denoise20.arp")
    with open(dn, "w") as f:
        f.write("[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n")
    outs = {}
    want = ("b1", "b2", "b3", "b4", "b7")
    for kind, (lut, msk) in {
            "htj2k": (paths["hald"], paths["mask"]),
            "png": (paths["hald_png"], paths["mask_png"])}.items():
        arp = os.path.join(tmp, f"u2_{kind}.arp")
        with open(arp, "w") as f:
            f.write(f2_arp(lut, msk))
        out = os.path.join(tmp, f"u2_{kind}.jpg")
        argv = ["-Y", "-p", base, "-p", dn, "-p", arp, "-o", out, "-c", dng]
        reset_counts()
        phases, seconds = cli_run(argv)
        launches, plain_calls = read_counts()
        log(f"U2 ({'HTJ2K Hald and mask' if kind == 'htj2k' else 'PNG '
            'Hald, PNG mask'}) through cli.main: "
            f"{1e3 * seconds:.1f} ms end to end (first); phases {phases}; "
            f"launches {launches}; plain calls {plain_calls} ({smi_line})")
        if launches != {k: int(k in want) for k in launches} \
                or any(plain_calls.values()):
            failures.append(f"U2 {kind}: launches {launches}, plain calls "
                            f"{plain_calls}")
        outs[kind] = open(out, "rb").read()
        check_jpeg(out)
    same = outs["htj2k"] == outs["png"]
    log(f"U2 JPEG from the HTJ2K Hald and mask "
        f"{'byte-equal to' if same else 'DIFFERS FROM'} the PNGs' "
        f"({len(outs['htj2k'])} bytes)")
    if not same:
        failures.append("U2: the HTJ2K develop differs from the PNGs'")
    from art_tpu_torch import cli

    argv = ["-Y", "-p", base, "-p", dn, "-p",
            os.path.join(tmp, "u2_htj2k.arp"), "-o",
            os.path.join(tmp, "u2_k.jpg"), "-c", dng]
    pp = cli.compose_params(dng, cli.parse_args(argv))
    failures += kernels_against_plain("U2", lambda: tdev.develop(frame, pp),
                                      want)
    log(f"HTJ2K phase: {time.monotonic() - t_phase:.1f} s ({smi_line})")
    return {}, failures


# I1: one committed 64x64 PNG a profile form LittleCMS converts (or, the
# last, refuses), and whether the phase also loads a 24 MP file tiled
# from it; tests/test_torch_lcms.py writes them and records the sha256 of
# Pillow's conversion under "I1 <name>"
I1_FORMS = (
    ("I1 float D2B0 (formula and sampled segments, matrix, float CLUT)",
     "i1_d2b0_xyz_v4.png", True),
    ("I1 D2B0 beside an A2B0, v2", "i1_d2b0_beside_a2b0_v2.png", False),
    ("I1 lifted black (BPC of a matrix/TRC source)",
     "i1_lifted_black_v2.png", True),
    ("I1 rippled 4096-entry mft2 curves", "i1_rippled_mft2.png", True),
    ("I1 device link RGB to Lab", "i1_link_rgb_lab.png", True),
    ("I1 device link RGB to XYZ (D2B0)", "i1_link_rgb_xyz_d2b0.png", False),
    ("I1 abstract Lab to Lab (refused)", "i1_abstract_lab_refused.png",
     False))
I1_FRAME = (4000, 6000)
# I1's photo: N1's Adobe RGB JPEG decoded, under this fixture's profile
I1_PHOTO = ("I1 N1's photo under the rippled mft2 profile",
            "i1_rippled_mft2.png")


def frame_rgb8(rgb):
    """The 8-bit RGB a non-raw (3, H, W) frame was decoded from: each
    sample's nearest of the 256 levels load_std_image makes (the sRGB
    decode of v / 255, times 65535); (H, W, 3) uint8."""
    from art_tpu_torch.color import colorspaces as cs

    levels = cs.srgb_igamma(np.arange(256, dtype=np.float32) / 255.0) \
        * 65535.0
    mids = (levels[1:].astype(np.float64) + levels[:-1]) / 2.0
    return np.moveaxis(np.searchsorted(mids, rgb), 0, -1).astype(np.uint8)


def i1_tiled(samples, h, w):
    """(h, w, ...) of `samples` repeated, cut at the far edges."""
    reps = (-(-h // samples.shape[0]), -(-w // samples.shape[1])) \
        + (1,) * (samples.ndim - 2)
    return np.ascontiguousarray(np.tile(samples, reps)[:h, :w])


def icc_phase(smi_line, tmp):
    """Embedded ICC profiles through the port's model of LittleCMS on the
    card's machine (no PIL there). I1: each committed fixture of
    I1_FORMS through art_tpu_torch.load_image, its 8-bit RGB against the
    sha256 of Pillow's conversion (decode, conversion and load_image ms
    each); for the tiled forms a 24 MP PNG of the fixture's samples
    repeated, with its profile, loaded in one call (decode, conversion,
    load_image ms beside N1's Adobe RGB JPEG of this run), its frame
    equal to the same tiling of the fixture's frame; and N1's decoded
    photo (millions of colours) as a PNG with the I1_PHOTO fixture's
    LUT-class profile, its decode, conversion and load_image ms beside
    N1's, the load equal to the conversion. Returns (the comparisons,
    the failures)."""
    import art_tpu_torch
    from art_tpu_torch.color import lcms
    from art_tpu_torch.io import imagefile

    log(f"---- ICC phase ({smi_line})")
    t_phase = time.monotonic()
    failures = []
    with open(FORMATS_SHA) as f:
        recorded = json.load(f)
    n1 = N1_MS.get("JPEG, Adobe RGB profile")
    n1_text = "not measured" if n1 is None else (
        f"decode {n1[0]:.1f}, conversion {n1[1]:.1f}, load_image "
        f"{n1[2]:.1f} ms")
    h, w = I1_FRAME
    for label, name, tiled in I1_FORMS:
        path = os.path.join(FORMATS_DATA, name)
        (mode, samples, icc), dec = timed(
            lambda: imagefile.read_image(path), 1)
        rgb8 = imagefile.to_rgb8(mode, samples)
        t0 = time.monotonic()
        try:
            conv8, refused = lcms.to_srgb(rgb8, icc), False
        except lcms.Refused:
            conv8, refused = rgb8, True
        conv = time.monotonic() - t0
        fr, total = timed(lambda: art_tpu_torch.load_image(path), 1)
        got8 = frame_rgb8(fr.rgb)
        ok = _sha(got8) == recorded[f"I1 {name}"] and \
            np.array_equal(got8, conv8)
        log(f"{label} ({name}, {os.path.getsize(path)} bytes, ICC "
            f"{len(icc)} bytes): decode {1e3 * dec:.1f} ms, conversion "
            f"{1e3 * conv:.1f} ms (the transform built"
            f"{'; Refused, as Pillow' if refused else ''}), load_image "
            f"{1e3 * total:.1f} ms (host), "
            f"sha256 {'equal to' if ok else 'NOT'} Pillow's")
        if not ok:
            failures.append(f"{label}: sha256 differs from Pillow's")
        if not tiled:
            continue
        big = os.path.join(tmp, name)
        t0 = time.monotonic()
        imagefile.write_png(big, i1_tiled(samples, h, w), icc_bytes=icc)
        written = time.monotonic() - t0
        (bmode, bsamples, bicc), bdec = timed(
            lambda: imagefile.read_image(big), 1)
        _, bconv = timed(lambda: lcms.to_srgb(
            imagefile.to_rgb8(bmode, bsamples), bicc), 1)
        del bsamples
        bfr, btotal = timed(lambda: art_tpu_torch.load_image(big), 1)
        same = bfr.rgb.shape == (3, h, w) and np.array_equal(
            bfr.rgb, i1_tiled(np.moveaxis(fr.rgb, 0, -1), h, w)
            .transpose(2, 0, 1))
        log(f"{label} at {w}x{h} ({os.path.getsize(big) / 1e6:.1f} MB, "
            f"written in {written:.2f} s): decode {1e3 * bdec:.1f} ms, "
            f"conversion {1e3 * bconv:.1f} ms, load_image "
            f"{1e3 * btotal:.1f} ms (host; N1's Adobe RGB JPEG: {n1_text})"
            f": frame {'equal to' if same else 'DIFFERENT FROM'} the "
            f"fixture's tiled ({smi_line})")
        if not same:
            failures.append(f"{label}: the 24 MP load differs from the "
                            "tiled fixture")
        del bfr
        os.unlink(big)
    photo = N1_PHOTO.pop("rgb8", None)
    if photo is None:
        failures.append("I1 photo: N1's Adobe RGB JPEG was not decoded")
    else:
        label, name = I1_PHOTO
        icc = imagefile.read_image(os.path.join(FORMATS_DATA, name))[2]
        big = os.path.join(tmp, "i1_photo.png")
        t0 = time.monotonic()
        imagefile.write_png(big, photo, icc_bytes=icc)
        written = time.monotonic() - t0
        used = np.zeros(1 << 24, bool)
        used[(photo[..., 0].astype(np.int32) << 16)
             | (photo[..., 1].astype(np.int32) << 8) | photo[..., 2]] = True
        colours = int(np.count_nonzero(used))
        shape = photo.shape[:2]
        del photo, used
        (bmode, bsamples, bicc), bdec = timed(
            lambda: imagefile.read_image(big), 1)
        bconv8, bconv = timed(lambda: lcms.to_srgb(
            imagefile.to_rgb8(bmode, bsamples), bicc), 1)
        del bsamples
        bfr, btotal = timed(lambda: art_tpu_torch.load_image(big), 1)
        same = bfr.rgb.shape == (3, *shape) and np.array_equal(
            frame_rgb8(bfr.rgb), bconv8)
        log(f"{label} at {w}x{h} ({colours} colours, "
            f"{os.path.getsize(big) / 1e6:.1f} MB, written in "
            f"{written:.2f} s): decode {1e3 * bdec:.1f} ms, conversion "
            f"{1e3 * bconv:.1f} ms, load_image {1e3 * btotal:.1f} ms (host; "
            f"N1's Adobe RGB JPEG: {n1_text}): frame "
            f"{'equal to' if same else 'DIFFERENT FROM'} the conversion "
            f"({smi_line})")
        if not same:
            failures.append(f"{label}: load_image differs from to_srgb")
        del bfr, bconv8
        os.unlink(big)
    log(f"ICC phase: {time.monotonic() - t_phase:.1f} s ({smi_line})")
    return {}, failures


# V1: 24 MP TIFFs whose strips repeat a committed single-strip fixture
V1_FRAME = (4000, 6000)
V1_TILED = (("V1 8-bit RGB, ZSTD, predictor 2", "tiff_v1_rgb8_zstd_pred2.tif"),
            ("V1 16-bit RGB, LZMA", "tiff_v1_rgb16_lzma.tif"),
            ("V1 bilevel, Group 4", "tiff_v1_g4.tif"),
            ("V1 float grey, deflate, predictor 3",
             "tiff_v1_float_deflate_pred3.tif"))
# V2's committed Hald (level 6, 16-bit RGB under ZSTD with predictor 2)
# and mask (f2_mask at Q2_MASK above 128, Group 4)
V2_HALD, V2_MASK = "tiff_v2_hald6_zstd16.tif", "tiff_v2_mask_g4.tif"


def tiff_tiled(fixture, h):
    """A TIFF of `h` rows whose every strip is the one-strip `fixture`'s
    strip, stored once: the fixture's SHORT and LONG entries with
    ImageLength set to h and StripOffsets and StripByteCounts naming the
    one strip again and again. h is a multiple of its rows."""
    e = "<" if fixture[:2] == b"II" else ">"
    ifd = struct.unpack_from(e + "I", fixture, 4)[0]
    ents = {}
    for i in range(struct.unpack_from(e + "H", fixture, ifd)[0]):
        at = ifd + 2 + 12 * i
        tag, typ, cnt = struct.unpack_from(e + "HHI", fixture, at)
        if typ in (3, 4):
            code = "H" if typ == 3 else "I"
            size = cnt * struct.calcsize(code)
            off = at + 8 if size <= 4 else \
                struct.unpack_from(e + "I", fixture, at + 8)[0]
            ents[tag] = (typ, struct.unpack_from(e + code * cnt, fixture, off))
    rows = ents[278][1][0] if 278 in ents else ents[257][1][0]
    off, cnt = ents[273][1][0], ents[279][1][0]
    strip = fixture[off : off + cnt] + b"\0" * (cnt % 2)
    k = h // rows
    ents.update({257: (4, (h,)), 278: (4, (rows,)), 273: (4, (8,) * k),
                 279: (4, (cnt,) * k)})
    ifd_at = 8 + len(strip)
    extra_at = ifd_at + 2 + 12 * len(ents) + 4
    table, extra = [struct.pack(e + "H", len(ents))], []
    for tag in sorted(ents):
        typ, vals = ents[tag]
        payload = struct.pack(e + ("H" if typ == 3 else "I") * len(vals),
                              *vals)
        if len(payload) <= 4:
            field = payload.ljust(4, b"\0")
        else:
            field = struct.pack(e + "I", extra_at + sum(map(len, extra)))
            extra.append(payload)
        table.append(struct.pack(e + "HHI", tag, typ, len(vals)) + field)
    head = fixture[:2] + struct.pack(e + "HI", 42, ifd_at)
    return b"".join([head, strip, *table, b"\0" * 4, *extra])


def tiff_phase(smi_line, tmp):
    """TIFF decoded by the port on the card's machine (no PIL there). V1:
    four 24 MP TIFFs built by `tiff_tiled` from the committed single-strip
    fixtures (V1_TILED), each read_image's host ms against the same
    tiling of the fixture's decode; every committed TIFF fixture against
    the sha256 of Pillow's decode. V2: F2's develop through cli.main
    (P3's Hald film simulation with Texture Boost under an external mask,
    bundled profile, denoise 20/20), the Hald a 16-bit ZSTD TIFF and the
    mask a Group 4 TIFF, both committed, against the same develop from a
    16-bit PNG Hald and a PNG mask of the same samples: the JPEGs
    byte-equal, B1-B4 and B7 once each and bit-equal to their plain
    versions on V2's tensors. Returns (the comparisons, the failures)."""
    from art_tpu_torch import cli
    from art_tpu_torch.io import imagefile
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- TIFF phase ({smi_line})")
    t_phase = time.monotonic()
    failures = []
    with open(FORMATS_SHA) as f:
        recorded = json.load(f)
    decoded = {}
    for name in sorted(k for k in recorded if k.startswith("tiff_")):
        fpath = os.path.join(FORMATS_DATA, name)
        t0 = time.monotonic()
        got = imagefile.read_rgb8(fpath)
        ms = 1e3 * (time.monotonic() - t0)
        ok = _sha(got) == recorded[name]
        decoded[name] = imagefile.read_image(fpath)[:2]
        log(f"V1 {name} ({os.path.getsize(fpath)} bytes, "
            f"{got.shape[1]}x{got.shape[0]}): read_rgb8 {ms:.1f} ms (host), "
            f"sha256 {'equal to' if ok else 'NOT'} Pillow's")
        if not ok:
            failures.append(f"V1 {name}: sha256 differs from Pillow's")
    h, w = V1_FRAME
    for label, name in V1_TILED:
        with open(os.path.join(FORMATS_DATA, name), "rb") as f:
            fixture = f.read()
        t0 = time.monotonic()
        path = _write(os.path.join(tmp, name), tiff_tiled(fixture, h))
        t1 = time.monotonic()
        mode, got, _ = imagefile.read_image(path)
        ms = 1e3 * (time.monotonic() - t1)
        fmode, strip = decoded[name]
        want = np.concatenate([strip] * (h // strip.shape[0]), axis=0)
        ok = mode == fmode and got.shape == want.shape and \
            np.array_equal(got, want)
        log(f"{label}: {w}x{h} file {os.path.getsize(path) / 1e6:.2f} MB "
            f"written in {t1 - t0:.2f} s; read_image {ms:.1f} ms (host) -> "
            f"{mode} {got.shape}: {'equal to' if ok else 'DIFFERENT FROM'} "
            f"the fixture's tiling")
        if not ok:
            failures.append(f"{label} decodes differently")
        os.unlink(path)
    del got, want

    # V2: a 16-bit ZSTD Hald and a Group 4 mask against PNGs
    frame = flagship_frame(*FRAME)
    samples, paths, argvs = v2_inputs(tmp, frame)
    for key in ("hald", "mask"):
        t0 = time.monotonic()
        got = imagefile.read_rgb8(paths[key])
        ms = 1e3 * (time.monotonic() - t0)
        ok = np.array_equal(got, samples[key])
        log(f"V2 {key}: {os.path.basename(paths[key])} {got.shape} in "
            f"{ms:.1f} ms (host), {'equal to' if ok else 'NOT'} its samples")
        if not ok:
            failures.append(f"V2: the {key} decodes wrongly")
    outs = {}
    want = ("b1", "b2", "b3", "b4", "b7")
    for kind, argv in argvs.items():
        out = argv[argv.index("-o") + 1]
        reset_counts()
        phases, seconds = cli_run(argv)
        launches, plain_calls = read_counts()
        log(f"V2 ({'ZSTD Hald, G4 mask' if kind == 'tiff' else 'PNG Hald, '
            'PNG mask'}) through cli.main: "
            f"{1e3 * seconds:.1f} ms end to end (first); phases {phases}; "
            f"launches {launches}; plain calls {plain_calls}")
        if launches != {k: int(k in want) for k in launches} \
                or any(plain_calls.values()):
            failures.append(f"V2 {kind}: launches {launches}, plain calls "
                            f"{plain_calls}")
        outs[kind] = open(out, "rb").read()
        check_jpeg(out)
    same = outs["tiff"] == outs["png"]
    log(f"V2 JPEG from the TIFFs "
        f"{'byte-equal to' if same else 'DIFFERS FROM'} the PNGs' "
        f"({len(outs['tiff'])} bytes)")
    if not same:
        failures.append("V2: the TIFF develop differs from the PNGs'")
    argv = argvs["tiff"]
    pp = cli.compose_params(argv[-1], cli.parse_args(argv))
    failures += kernels_against_plain("V2", lambda: tdev.develop(frame, pp),
                                      want)
    log(f"TIFF phase: {time.monotonic() - t_phase:.1f} s")
    return {}, failures


def v2_inputs(tmp, frame):
    """V2's inputs: the committed 16-bit ZSTD Hald and Group 4 mask, PNGs
    of the same samples and the frame's DNG, written in `tmp`. Returns
    ({"hald", "mask"}: the 8-bit samples read_rgb8 gives, {"hald",
    "mask"}: the TIFFs' paths, {"tiff", "png"}: the cli.main argv of F2's
    develop from each kind, writing tmp/v2_<kind>.jpg)."""
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.io.imagefile import write_png

    hald = hald_image(6, 16)
    mask = np.where(f2_mask(*Q2_MASK) > 128, 255, 0).astype(np.uint8)
    mask3 = np.repeat(mask[..., None], 3, 2)
    paths = {"hald": os.path.join(FORMATS_DATA, V2_HALD),
             "mask": os.path.join(FORMATS_DATA, V2_MASK)}
    pngs = {"hald": os.path.join(tmp, "hald6.png"),
            "mask": os.path.join(tmp, "mask.png")}
    write_png(pngs["hald"], hald)
    write_png(pngs["mask"], mask3)
    dng = os.path.join(tmp, "v2.dng")
    write_dng(dng, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, compress=False)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "art_tpu_torch", "data", "profiles", PROFILE)
    dn = os.path.join(tmp, "denoise20.arp")
    with open(dn, "w") as f:
        f.write("[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n")
    argvs = {}
    for kind, files in (("tiff", paths), ("png", pngs)):
        arp = os.path.join(tmp, f"v2_{kind}.arp")
        with open(arp, "w") as f:
            f.write(f2_arp(files["hald"], files["mask"]))
        out = os.path.join(tmp, f"v2_{kind}.jpg")
        argvs[kind] = ["-Y", "-p", base, "-p", dn, "-p", arp, "-o", out,
                       "-c", dng]
    samples = {"hald": (hald >> 8).astype(np.uint8), "mask": mask3}
    return samples, paths, argvs


def v2_cpu(tmp):
    """V2's two develops through cli.main on the CPU at 200x320 (ROADMAP
    C's watch: run it in fresh processes and compare). Returns the sha256
    of each JPEG."""
    import hashlib

    from art_tpu_torch import cli

    _, _, argvs = v2_inputs(tmp, flagship_frame(200, 320))
    shas = {}
    for kind, argv in argvs.items():
        cli.main(argv, device="cpu")
        with open(argv[argv.index("-o") + 1], "rb") as f:
            shas[kind] = hashlib.sha256(f.read()).hexdigest()
    return shas


def _leaves(d):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield k, v


# O1: the writers of every format the reference saves through Pillow;
# each byte-equal writer's bytes of the O1_FIXTURES arrays are held to
# Pillow's sha256 under "O1 <fixture> <extension>"
# (tests/test_torch_savers.py writes them), a PDF's two dates masked
O1_EXTS = (".bmp", ".dib", ".tga", ".sgi", ".im", ".pcx", ".ppm", ".qoi",
           ".dds", ".eps", ".jpe", ".pdf", ".gif")
O1_FIXTURES = {"photo 56x40": (40, 56, 0), "odd 23x17": (17, 23, 1),
               "many colours 300x200": (200, 300, 2)}
O1_FRAME = FRAME
O2_EXTS = (".gif", ".pdf", ".bmp")


def photo_u8(h, w, seed=0):
    """A photo-like (h, w, 3) uint8 image from a seed: smooth gradients
    and a slow wave in each channel, plus noise of +-12 (millions of
    colours at 24 MP)."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    out = np.empty((h, w, 3), np.uint8)
    for c, (fy, fx, ph) in enumerate(((3.0, 2.0, 0.3), (2.0, 5.0, 1.1),
                                      (4.0, 3.0, 2.0))):
        base = 60.0 + 120.0 * (0.6 * x + 0.4 * y) + 50.0 * np.sin(
            fy * np.pi * y + fx * np.pi * x + ph)
        noise = rng.integers(-12, 13, (h, w), dtype=np.int16)
        out[..., c] = np.clip(base + noise, 0, 255).astype(np.uint8)
    return out


def mask_pdf_dates(data):
    """A PDF's bytes with its CreationDate and ModDate zeroed."""
    return re.sub(rb"\(D:\d{14}Z\)", b"(D:00000000000000Z)", data)


def o1_fixture_sha(save, tmp):
    """{"O1 <fixture> <extension>": sha256 of the bytes `save(path, rgb)`
    writes} for each O1 fixture and extension."""
    out = {}
    for name, (h, w, seed) in O1_FIXTURES.items():
        rgb = photo_u8(h, w, seed)
        for ext in O1_EXTS:
            path = os.path.join(tmp, f"o1{ext}")
            save(path, rgb)
            with open(path, "rb") as f:
                data = f.read()
            if ext == ".pdf":
                data = mask_pdf_dates(data)
            out[f"O1 {name} {ext}"] = hashlib.sha256(data).hexdigest()
            os.unlink(path)
    return out


def png_metadata(path):
    """(ICC profile, EXIF with its "Exif" header) of a PNG the port
    wrote: its iCCP inflated, its eXIf chunk."""
    data = open(path, "rb").read()
    pos, icc, exif = 8, None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        if kind == b"iCCP":
            icc = zlib.decompress(body[body.index(b"\0") + 2 :])
        elif kind == b"eXIf":
            exif = b"Exif\x00\x00" + body
        pos += 12 + n
    return icc, exif


def o1_writers(smi_line, tmp):
    """O1 of `output_phase`: the fixtures against Pillow's sha256, then
    each writer on the 24 MP array. Returns the failures."""
    from art_tpu_torch.io import imagefile, savers, stdformats

    failures = []
    with open(FORMATS_SHA) as f:
        recorded = json.load(f)
    got = o1_fixture_sha(savers.save, tmp)
    bad = sorted(k for k, v in got.items() if recorded.get(k) != v)
    log(f"O1 fixtures: {len(got) - len(bad)} of {len(got)} files at "
        f"Pillow's sha256")
    if bad:
        failures.append(f"O1 fixtures differ from Pillow's: {bad}")

    # O1 at 24 MP
    h, w = O1_FRAME
    t0 = time.monotonic()
    rgb = photo_u8(h, w, 7)
    log(f"O1 array {w}x{h} made in {time.monotonic() - t0:.1f} s")
    jpe = None
    for ext in O1_EXTS + (".ico", ".icns"):
        path = os.path.join(tmp, f"o1{ext}")
        t0 = time.monotonic()
        savers.save(path, rgb)
        ms = 1e3 * (time.monotonic() - t0)
        size = os.path.getsize(path)
        ok, how = True, ""
        if ext in (".bmp", ".dib", ".tga", ".sgi", ".im", ".pcx", ".ppm",
                   ".qoi", ".dds"):
            t1 = time.monotonic()
            back = imagefile.read_rgb8(path)
            ok = back.shape == rgb.shape and np.array_equal(back, rgb)
            how = (f"read back in {1e3 * (time.monotonic() - t1):.1f} ms "
                   f"{'equal to' if ok else 'DIFFERENT FROM'} the array")
            del back
        elif ext == ".eps":
            data = open(path, "rb").read()
            start = data.index(b"false 3 colorimage\n",
                               data.index(b"gsave")) + 19
            end = data.index(b"\n%%%%EndBinary")
            hexed = data[start:end].replace(b"\n", b"")
            ok = bytes.fromhex(hexed.decode("ascii")) == rgb.tobytes()
            how = f"hex {'equal to' if ok else 'DIFFERENT FROM'} the array"
            del data, hexed
        elif ext == ".jpe":
            jpe = open(path, "rb").read()
            check_jpeg(path, quiet=True)
            how = "markers well formed"
        elif ext == ".pdf":
            data = open(path, "rb").read()
            at = data.index(b">>stream\n") + 9
            n = int(re.search(rb"/Length (\d+)", data).group(1))
            ok = data[at : at + n] == jpe
            how = (f"DCT stream {'equal to' if ok else 'DIFFERENT FROM'} the"
                   " .jpe")
        elif ext == ".gif":
            t1 = time.monotonic()
            idx, pal = savers.gif_parts(rgb)
            quant = 1e3 * (time.monotonic() - t1)
            data = open(path, "rb").read()
            _, back = stdformats.read_gif(data, indices=True)
            ok = np.array_equal(back[..., 0], idx) and np.array_equal(
                imagefile.read_rgb8(path), pal[idx])
            how = (f"{len(pal)} colours (the median cut and palette "
                   f"{quant:.1f} ms); indices and palette read back "
                   f"{'equal' if ok else 'DIFFERENT'}")
            del idx, data, back
        elif ext == ".ico":
            frames = savers.ico_frames(rgb)
            big = frames[-1]
            back = imagefile.read_rgb8(path)
            ok = np.array_equal(back, big)
            how = (f"{len(frames)} frames; its {big.shape[1]}x{big.shape[0]}"
                   f" frame {'equal to' if ok else 'DIFFERENT FROM'} its "
                   "resample")
        elif ext == ".icns":
            big = savers.resize(rgb, (1024, 1024), 3)
            back = imagefile.read_rgb8(path)
            ok = np.array_equal(back, big)
            how = (f"its 1024x1024 frame {'equal to' if ok else 'DIFFERENT'}"
                   f" {'' if ok else 'FROM '}its resample")
        log(f"O1 {ext}: {w}x{h} written in {ms:.1f} ms (host), "
            f"{size / 1e6:.2f} MB; {how} ({smi_line})")
        if not ok:
            failures.append(f"O1 {ext}: {how}")
        os.unlink(path)
    del rgb, jpe
    return failures


def output_phase(smi_line, tmp):
    """The writers of the formats the reference saves through Pillow, on
    the card's machine (no PIL there). O1: every byte-equal writer on a
    seeded photo-like 24 MP array (O1_FRAME), each timed on the host, the
    lossless ones read back through the port's decoders equal to the
    array (EPS by its hex, the GIF equal to its own indices and palette,
    the PDF's DCT stream equal to the .jpe's bytes), ICO and ICNS timed
    and their largest frames read back equal to their resamples; the
    O1_FIXTURES arrays' bytes against Pillow's sha256. O2: the flagship
    through cli.main to out.png, then out.gif, out.pdf and out.bmp, each
    with B1-B4 and B7 once and no plain version; each file byte-equal to
    the port's writer applied to the PNG's pixels, ICC profile and EXIF
    (the PDF's dates masked); B1-B4 and B7 bit-equal to their plain
    versions on O2's tensors. Returns (the comparisons, the failures)."""
    from art_tpu_torch import cli
    from art_tpu_torch.io import imagefile, savers
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.pipeline import develop as tdev

    log(f"---- output phase ({smi_line})")
    t_phase = time.monotonic()
    failures = o1_writers(smi_line, tmp)

    # O2: the flagship through cli.main to each format
    frame = flagship_frame(*FRAME)
    dng = os.path.join(tmp, "o2.dng")
    write_dng(dng, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, compress=False)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "art_tpu_torch", "data", "profiles", PROFILE)
    dn = os.path.join(tmp, "denoise20.arp")
    with open(dn, "w") as f:
        f.write("[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n")
    want = ("b1", "b2", "b3", "b4", "b7")
    outs = {}
    for ext in (".png",) + O2_EXTS:
        out = os.path.join(tmp, f"o2{ext}")
        argv = ["-Y", "-p", base, "-p", dn, "-o", out, "-c", dng]
        reset_counts()
        phases, seconds = cli_run(argv)
        launches, plain_calls = read_counts()
        log(f"O2 -o {os.path.basename(out)} through cli.main: "
            f"{1e3 * seconds:.1f} ms end to end; encode+write "
            f"{phases.get('encode+write', float('nan')):.1f} ms; launches "
            f"{launches}; plain calls {plain_calls} ({smi_line})")
        if launches != {k: int(k in want) for k in launches} \
                or any(plain_calls.values()):
            failures.append(f"O2 {ext}: launches {launches}, plain calls "
                            f"{plain_calls}")
        outs[ext] = out
    pixels = imagefile.read_rgb8(outs[".png"])
    icc, exif = png_metadata(outs[".png"])
    os.makedirs(os.path.join(tmp, "writer"))
    for ext in O2_EXTS:  # the same base name: a PDF's title is the name
        ref = os.path.join(tmp, "writer", f"o2{ext}")
        savers.save(ref, pixels, icc_bytes=icc, exif_bytes=exif)
        a, b = open(outs[ext], "rb").read(), open(ref, "rb").read()
        if ext == ".pdf":
            a, b = mask_pdf_dates(a), mask_pdf_dates(b)
        same = a == b
        log(f"O2 {ext} ({len(a)} bytes) "
            f"{'byte-equal to' if same else 'DIFFERS FROM'} the writer on "
            "the PNG's pixels")
        if not same:
            failures.append(f"O2 {ext}: differs from the writer on the "
                            "PNG's pixels")
    pp = cli.compose_params(dng, cli.parse_args(
        ["-Y", "-p", base, "-p", dn, "-o", outs[".gif"], "-c", dng]))
    failures += kernels_against_plain("O2", lambda: tdev.develop(frame, pp),
                                      want)
    log(f"output phase: {time.monotonic() - t_phase:.1f} s ({smi_line})")
    return {}, failures


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(smi_line)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from art_tpu_torch import kernels
    from art_tpu_torch.demosaic import amaze
    from art_tpu_torch.demosaic import amaze_kernel as ak
    from art_tpu_torch.demosaic import rcd
    from art_tpu_torch.ops import denoise
    from art_tpu_torch.ops import nlmeans_kernel as nk
    from art_tpu_torch.ops import tonecurve_neutral as tn
    from art_tpu_torch.opcount import needed_ops
    from art_tpu_torch.ops import wavelet_kernel as wk
    from art_tpu_torch.pipeline import develop as tdev
    from art_tpu_torch.raw.preprocess import apply_scale

    from art_tpu_torch import hostbuild

    # the host libraries (raw decoder, JPEG encoder and decoder, GIF's
    # LZW decoder, WebP decoder, the simple raster decoders, the JPEG 2000
    # decoder, the writers' encoders; g++) build
    # beside the CUDA kernels (nvcc), all compilers at once
    t0 = time.monotonic()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(hostbuild.build, "artraw", "jpegenc", "jpegdec",
                           "lzwdec", "webpdec", "rasterdec", "jp2dec",
                           "saveenc")
        kernels.library()
        host_libs = host.result()
    log(f"build: {time.monotonic() - t0:.2f} s "
        f"(nvcc {kernels.build_info['seconds']:.2f} s, compiled="
        f"{kernels.build_info['compiled']}; g++ "
        f"{sorted(p.name for p in host_libs.values())})")
    for line in kernels.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())
    log("kernels as loaded (B1, B2, B3, B6; B4, B5):")
    for line in (ak.layout() + nk.layout() + wk.layout()).splitlines():
        log("  " + line)

    # ---- the main path: the AMaZE flagship
    t0 = time.monotonic()
    frame = flagship_frame(*FRAME)
    log(f"frame {FRAME[0]}x{FRAME[1]} synthesised in "
        f"{time.monotonic() - t0:.2f} s")
    pp = flagship_pp("amaze")
    launches = drive("amaze", pp, frame, ("b1", "b2", "b3", "b4", "b7"))
    median_develop("amaze", frame, pp)
    config, inp_d, data_d, _ = device_program(frame, pp)
    profile_develop(frame, pp)

    # ---- the bilinear path (the first slice's)
    drive("bilinear", flagship_pp("bilinear"), frame, ("b4", "b7"))

    # ---- config 3 with smoothing: RCD, B5, guided chroma, B6, impulse
    pp3 = config3_pp()
    launches3 = drive("config3", pp3, frame, ("b5", "b6"))
    median_develop("config3", frame, pp3)
    config3, inp3, data3, _ = device_program(frame, pp3)
    profile_develop(frame, pp3)

    # ---- configs 2 and 4, each with a small develop against the CPU
    new_stats = {}
    t0 = time.monotonic()
    frame2 = config2_frame(*FRAME)
    log(f"config 2 frame {FRAME[0]}x{FRAME[1]} (the flagship frame, R and "
        f"B magnified by 1 +- 2e-3, 0.1% of the sites 0 or white) in "
        f"{time.monotonic() - t0:.2f} s")
    new_stats["config2"] = new_path("config2", config2_pp(), frame2,
                                    ("b1", "b2", "b3"),
                                    config2_frame(*SMALL2, seed=5))
    del frame2
    with tempfile.TemporaryDirectory() as lut_dir:
        cube = os.path.join(lut_dir, "config4.cube")
        write_cube(cube)
        t0 = time.monotonic()
        frame4 = config4_frame(*FRAME4)
        log(f"config 4 frame {FRAME4[0]}x{FRAME4[1]} X-Trans in "
            f"{time.monotonic() - t0:.2f} s; a 33^3 .cube LUT")
        new_stats["config4"] = new_path("config4", config4_pp(cube), frame4,
                                        (), config4_frame(*SMALL4, seed=5))
        del frame4

    # ---- kernel phase: each kernel on the tensors its path feeds it
    pat = config.pattern
    cfa = apply_scale(inp_d.float(), data_d["raw_offset"],
                      data_d["raw_scale"])
    clips = amaze.clip_points(data_d["init_gain"], "cuda")
    x = amaze.padded_plane(cfa)
    entries = {}

    def check(key, kern, plain, reads):
        """Kernel and plain version on the same inputs: the entry of the
        kernels line, and the kernel's output."""
        k_out = kern()
        p_out, *ops = needed_ops(plain)
        torch.cuda.synchronize()
        bnd = bound(reads, (k_out,), ops)
        entries[key] = kernel_entry(
            f"AMaZE stage {key[1]} ({key.upper()})", key,
            "art_tpu_torch/csrc/amaze.cu",
            "art_tpu/demosaic/amaze_pallas.py:65", launches, k_out, p_out,
            gpu_ms(kern, 10), gpu_ms(plain, 3), bnd)
        return k_out

    s1 = check("b1", lambda: ak.amaze_stage1(x, pat, clips),
               lambda: amaze.stage1_plain(x, pat, clips), (x, clips))
    allocation("B1", lambda: ak.amaze_stage1(x, pat, clips), s1)
    one_launch_ms("B1", lambda: ak.amaze_stage1(x, pat, clips), "s1_tile")
    s2 = check("b2", lambda: ak.amaze_stage2(x, pat, s1),
               lambda: amaze.stage2_plain(x, pat, s1), (x, s1))
    log(f"B2 nyquist2 share on this frame: "
        f"{float(amaze.nyquist_masks(x, pat, s1)[1].mean()):.4f} of the "
        f"padded plane's pixels (the area sums run there)")
    allocation("B2", lambda: ak.amaze_stage2(x, pat, s1), s2)
    one_launch_ms("B2", lambda: ak.amaze_stage2(x, pat, s1), "s2_tile")
    del s1
    k3 = check("b3", lambda: ak.amaze_stage3(x, pat, s2, clips),
               lambda: amaze.stage3_plain(x, pat, s2, clips), (x, s2, clips))
    allocation("B3", lambda: ak.amaze_stage3(x, pat, s2, clips), k3)
    one_launch_ms("B3", lambda: ak.amaze_stage3(x, pat, s2, clips), "s3_tile")
    rgb = amaze._with_border(cfa, pat, k3)
    del s2, x

    dn = dict(data_d["op:denoise"], pre_mults=data_d["rgb_mults"],
              pre_mat=data_d["cam2work"])
    b4_args, b4_kw = denoise.kernel_args(dn, config.steps[0][1])
    b4_args = (rgb,) + b4_args
    plain_args = (rgb,) + wk.prepare(*b4_args, **b4_kw)
    _, hp4, wp4 = wk.tile_geometry(*rgb.shape[1:], plain_args[4])
    log(f"B4 scratch at {tuple(rgb.shape)}: "
        f"{wk.scratch_bytes(3, hp4, wp4, plain_args[4]) / 1e9:.3f} GB")
    check_wavelet_launches("B4", kernel_breakdown(
        "B4", lambda: wk.wavelet_denoise_rgb(*b4_args, **b4_kw),
        WAVELET_PARTS, wavelet_complete))
    # the sigma's worst case: every |d0| of a window in one leaf, so pass
    # B's shared-memory atomics all hit one bin
    flat = torch.full_like(rgb, 0.5)
    kernel_breakdown("B4 on a constant frame", lambda: wk.wavelet_denoise_rgb(
        flat, *b4_args[1:], **b4_kw), WAVELET_PARTS, wavelet_complete)
    del flat
    b4_k = wk.wavelet_denoise_rgb(*b4_args, **b4_kw)
    b4_p, *ops = needed_ops(lambda: wk.wavelet_rgb_plain(*plain_args))
    torch.cuda.synchronize()
    entries["b4"] = kernel_entry(
        "wavelet_rgb (B4)", "b4", "art_tpu_torch/csrc/wavelet_rgb.cu",
        "art_tpu/ops/wavelet_pallas.py:311", launches, b4_k, b4_p,
        gpu_ms(lambda: wk.wavelet_denoise_rgb(*b4_args, **b4_kw), 10),
        gpu_ms(lambda: wk.wavelet_rgb_plain(*plain_args), 3),
        bound((rgb,), (b4_k,), ops))
    del b4_p

    tc = data_d["op:tonecurve"]
    params = torch.cat([tc["params"], data_d["work2out"].reshape(-1)])
    coeffs = tc["coeffs"].reshape(-1, tc["coeffs"].shape[-1])
    epi = config.out_trc[0]
    log("B7 as loaded: " + tn.layout(tuple(coeffs.shape), epi).strip())
    b7_k = tn.neutral_tone(b4_k, params, coeffs, epi)
    b7_p, *ops = needed_ops(lambda: tn.neutral_plain(b4_k, params, coeffs,
                                                     epi))
    torch.cuda.synchronize()
    entries["b7"] = kernel_entry(
        "neutral_tone (B7)", "b7", "art_tpu_torch/csrc/neutral_tone.cu",
        "art_tpu/ops/tonecurve_neutral.py:384", launches, b7_k, b7_p,
        gpu_ms(lambda: tn.neutral_tone(b4_k, params, coeffs, epi), 20),
        gpu_ms(lambda: tn.neutral_plain(b4_k, params, coeffs, epi), 3),
        bound((b4_k,), (b7_k,), ops))
    del b7_p, b7_k, b4_k, rgb, cfa, inp_d, data_d

    # B5 on config 3's stacked Y/U/V: RCD, the raw head, gain, gamma, YUV
    cfa = apply_scale(inp3.float(), data3["raw_offset"], data3["raw_scale"])
    rgb = tdev.raw_head(rcd.rcd_demosaic(cfa, config3.pattern), data3)
    dn3, dn3_static = data3["op:denoise"], config3.steps[0][1]
    x3 = torch.stack(denoise.to_yuv(rgb, dn3))
    del rgb, cfa
    strengths, blends = denoise.strengths_blends(dn3, dn3_static)
    prm = wk.multi_params(3, [-1.0] * 3, strengths, blends, "cuda")
    hp5, wp5 = wk.multi_geometry(*x3.shape[1:])
    log(f"B5 scratch at {tuple(x3.shape)}: "
        f"{wk.scratch_bytes(3, hp5, wp5, wk.TILE_X) / 1e9:.3f} GB")
    check_wavelet_launches("B5", kernel_breakdown(
        "B5", lambda: wk.wavelet_denoise_multi(x3, [-1.0] * 3, strengths,
                                               blends), WAVELET_PARTS,
        wavelet_complete))
    flat = torch.full_like(x3, 0.5)
    kernel_breakdown("B5 on a constant frame",
                     lambda: wk.wavelet_denoise_multi(
                         flat, [-1.0] * 3, strengths, blends), WAVELET_PARTS,
                     wavelet_complete)
    del flat
    b5_k = wk.wavelet_denoise_multi(x3, [-1.0] * 3, strengths, blends)
    b5_p, *ops = needed_ops(lambda: wk.wavelet_multi_plain(x3, prm))
    torch.cuda.synchronize()
    entries["b5"] = kernel_entry(
        "wavelet_multi (B5)", "b5", "art_tpu_torch/csrc/wavelet_rgb.cu",
        "art_tpu/ops/wavelet_pallas.py:127", launches3, b5_k, b5_p,
        gpu_ms(lambda: wk.wavelet_denoise_multi(x3, [-1.0] * 3, strengths,
                                                blends), 10),
        gpu_ms(lambda: wk.wavelet_multi_plain(x3, prm), 3),
        bound((x3,), (b5_k,), ops))
    del b5_p, x3

    # B6 on B5's Y (the guided filter leaves Y alone) and its maskinv
    y = b5_k[0]
    maskinv = denoise.nl_maskinv(y, dn3["nl_h2"], dn3["nl_detail"])
    entries["b6"] = b6_entry("nlmeans (B6)", "b6", launches3, y, maskinv)
    one_launch_ms("B6", lambda: nk.nlmeans(y, maskinv), "nlmeans_walk")
    # every box 0 (every weight 1), and a maskinv where min(., 50) clamps
    b6_edges = {"a constant plane": b6_case(
        "a constant plane", torch.full_like(y, 0.5), maskinv)}
    mi_hot = maskinv * 1e4
    label = (f"maskinv x 1e4 (the clamp at 50 fires at "
             f"{clamp_share(y, mi_hot):.4f} of the pixels for offset (0, 1))")
    b6_edges["maskinv x 1e4"] = b6_case(label, y, mi_hot)
    del mi_hot, b5_k, y, maskinv, inp3, data3

    # ---- small develops: the card against the CPU plain path
    small = flagship_frame(*SMALL, seed=5)
    small_stats = {}
    for label in ("amaze", "bilinear", "config3"):
        with impulse_masks() as masks:
            g = tdev.develop(small, path_pp(label)).cpu()
            c = tdev.develop(small, path_pp(label), device="cpu")
        small_stats[label] = impulse_parity(g, c, *masks) if masks \
            else parity(g, c)
        log(f"{SMALL[0]}x{SMALL[1]} {label} develop, card vs CPU plain "
            f"path: {small_stats[label]}")

    log(f"kernel phases and small develops: "
        f"{time.monotonic() - T_START:.1f} s since the start")
    # ---- the CLI: config 1 and the flagship, file in, JPEG out
    with phase_clock("CLI phase"), tempfile.TemporaryDirectory() as tmp:
        cli_phase(smi_line, tmp)

    # ---- config 5: the batch queue over a 24 MP catalog, then a mixed one
    with phase_clock("config 5 phase"), \
            tempfile.TemporaryDirectory() as tmp:
        new_stats["user-profile"] = config5_phase(smi_line, tmp)

    # ---- the everyday export: E1, E2 (-q through the CLI) and E3
    with phase_clock("export phase"), tempfile.TemporaryDirectory() as tmp:
        new_stats.update(export_phase(smi_line, tmp, entries))

    # ---- the look: L1 (a colour grade) and L2 (a colour negative)
    with phase_clock("look phase"):
        new_stats.update(look_phase(smi_line, entries))

    # ---- lens and sensor corrections: C1 (calibrated, lens-corrected)
    # and C2 (an embedded gain map and lensfun, through the CLI)
    with phase_clock("lens phase"), tempfile.TemporaryDirectory() as tmp:
        lens_stats, failures = lens_phase(smi_line, tmp)
    new_stats.update(lens_stats)

    # ---- the demosaics and raw inputs: D1-D5
    with phase_clock("demosaic phase"):
        _, dem_stats, dem_failures = demosaic_phase(smi_line, entries)
    new_stats.update(dem_stats)
    failures += dem_failures

    # ---- colour profiles and LUTs: P1 (a DCP), P2 (ICC LUT profiles), P3
    # (the film-simulation files, the gamut warning)
    with phase_clock("profile phase, in all"), \
            tempfile.TemporaryDirectory() as tmp:
        prof_stats, prof_failures = profile_phase(smi_line, tmp)
    new_stats.update(prof_stats)
    failures += prof_failures

    # ---- the region masks (M1: area, linked, drawn, external) and the
    # host autos and scopes (M2: auto WB, the histogram listener)
    with phase_clock("mask phase, in all"), \
            tempfile.TemporaryDirectory() as tmp:
        mask_stats, mask_failures = mask_phase(smi_line, tmp)
    new_stats.update(mask_stats)
    failures += mask_failures

    # ---- the JPEG decoder and histogram matching: H1 (the bundled
    # Auto-Matched Curve.arp on a DNG with a full-size preview), H2 (the
    # same through cli.main), J1 (the decoder alone, JPEG Hald and mask)
    with phase_clock("JPEG phase, in all"), \
            tempfile.TemporaryDirectory() as tmp:
        jpeg_stats, jpeg_failures = jpeg_phase(smi_line, tmp, entries)
    new_stats.update(jpeg_stats)
    failures += jpeg_failures

    # ---- the entry points: X1 (a preconverted raw through cli.main), T1
    # (thumbnails), N1 (non-raw input on the host)
    with phase_clock("entry phase, in all"), \
            tempfile.TemporaryDirectory() as tmp:
        entry_stats, entry_failures = entry_phase(smi_line, tmp)
    new_stats.update(entry_stats)
    failures += entry_failures

    # ---- the image formats Pillow opens: F1 (24 MP files of each form,
    # the committed JPEG forms), F2 (a BMP Hald and a PGM mask through
    # cli.main)
    with phase_clock("formats phase, in all"), \
            tempfile.TemporaryDirectory() as tmp:
        fmt_stats, fmt_failures = formats_phase(smi_line, tmp)
    new_stats.update(fmt_stats)
    failures += fmt_failures

    # ---- WebP: W1 (24 MP lossless and lossy decodes, the committed
    # fixtures), W2 (a WebP Hald and a WebP mask through cli.main)
    with phase_clock("WebP phase, in all"), \
            tempfile.TemporaryDirectory() as tmp:
        webp_stats, webp_failures = webp_phase(smi_line, tmp)
    new_stats.update(webp_stats)
    failures += webp_failures

    # ---- the simple raster formats: R1 (24 MP decodes, the committed
    # fixtures), R2 (a PSD Hald and an SGI mask through cli.main)
    with phase_clock("raster phase, in all"), \
            tempfile.TemporaryDirectory() as tmp:
        raster_stats, raster_failures = raster_phase(smi_line, tmp)
    new_stats.update(raster_stats)
    failures += raster_failures

    # ---- the small raster plugins: G1 (24 MP decodes, the committed
    # fixtures, a Photo CD), G2 (an RLE SUN Hald and a PFM mask through
    # cli.main)
    with phase_clock("plugin phase, in all"), \
            tempfile.TemporaryDirectory() as tmp:
        plugin_stats, plugin_failures = plugin_phase(smi_line, tmp)
    new_stats.update(plugin_stats)
    failures += plugin_failures

    # ---- the texture and icon formats: K1 (24 MP DDS and BLP decodes,
    # BCn tiled from the committed fixtures, the fixtures), K2 (a DDS
    # Hald and a BLP mask through cli.main)
    with phase_clock("texture phase, in all"), \
            tempfile.TemporaryDirectory() as tmp:
        tex_stats, tex_failures = texture_phase(smi_line, tmp)
    new_stats.update(tex_stats)
    failures += tex_failures

    # ---- JPEG 2000: Q1 (24 MP lossless JP2 and 9/7 codestream tiled from
    # the committed fixtures, the fixtures), Q2 (a JP2 Hald and a J2K mask
    # through cli.main)
    with phase_clock("JPEG 2000 phase, in all"), \
            tempfile.TemporaryDirectory() as tmp:
        q_stats, q_failures = jpeg2000_phase(smi_line, tmp)
    new_stats.update(q_stats)
    failures += q_failures

    # ---- TIFF: V1 (24 MP ZSTD, LZMA, Group 4 and floating-point
    # predictor files tiled from the committed strips, the fixtures), V2
    # (a ZSTD Hald and a Group 4 mask through cli.main)
    with phase_clock("TIFF phase, in all"), \
            tempfile.TemporaryDirectory() as tmp:
        v_stats, v_failures = tiff_phase(smi_line, tmp)
    new_stats.update(v_stats)
    failures += v_failures

    # ---- HTJ2K and the last TIFF and IPTC forms: U1 (the U fixtures,
    # 24 MP HTJ2K files tiled from the committed ones, beside Q1's MQ
    # decode), U2 (an HTJ2K Hald and mask through cli.main)
    with phase_clock("HTJ2K phase, in all"), \
            tempfile.TemporaryDirectory() as tmp:
        u_stats, u_failures = htj2k_phase(smi_line, tmp)
    new_stats.update(u_stats)
    failures += u_failures

    # ---- embedded ICC profiles: I1 (every profile form LittleCMS links,
    # at 64x64 and, four of them, tiled to 24 MP)
    with phase_clock("ICC phase, in all"), \
            tempfile.TemporaryDirectory() as tmp:
        i_stats, i_failures = icc_phase(smi_line, tmp)
    new_stats.update(i_stats)
    failures += i_failures

    # ---- the writers: O1 (every format the reference saves through
    # Pillow, on a 24 MP array, and the fixtures against Pillow's
    # sha256), O2 (the flagship through cli.main to GIF, PDF and BMP)
    with phase_clock("output phase, in all"), \
            tempfile.TemporaryDirectory() as tmp:
        o_stats, o_failures = output_phase(smi_line, tmp)
    new_stats.update(o_stats)
    failures += o_failures

    failures += [f"B6 on {k} disagrees with its plain version"
                 for k, ok in b6_edges.items() if not ok]
    for e in entries.values():
        mean_err = e.pop("_mean_err")
        if e["max_abs_err"] > KERNEL_MAX or mean_err > KERNEL_MEAN:
            failures.append(f"{e['name']} disagrees with its plain version")
    for label, st in {**small_stats, **new_stats}.items():
        if "flips" in st:
            bad = (st["flip_share"] > (RAW_FLIPS if label == "config2"
                                       else IMPULSE_FLIPS)
                   or st["max_lsb8_beyond_flips"] > DEV_MAX * 255)
        else:
            bad = st["max_lsb8"] > DEV_MAX * 255
        if (bad or st["mean"] > DEV_MEAN
                or st["within_1lsb8"] < DEV_WITHIN):
            failures.append(f"{label}: card develop disagrees with the "
                            f"CPU: {st}")
    if "jax" in sys.modules or "art_tpu" in sys.modules:
        failures.append("jax or art_tpu was imported")
    if failures:
        raise RuntimeError("; ".join(failures))
    print(json.dumps({"kernels": [entries[k] for k in sorted(entries)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
