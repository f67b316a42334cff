"""WebP decoding and the PNG reader's damaged-file walk against Pillow
12.1.0 (``art_tpu_torch/io/webpdec.py`` and ``io/native/webpdec.cc``;
``io/imagefile.py::_read_png``).

Every case compares the port's array with Pillow's ``convert("RGB")`` of
the same bytes, bit for bit, or the port's error with Pillow's: the same
class, at open (`Unidentified`, an OSError) or at load. The files come
from Pillow's save, from its bundled libwebp's ``WebPEncode`` through
``tests/webpwrite_helper.c`` for the options Pillow does not expose,
from containers written by hand, and VP8 key frames of random syntax
for what libwebp's encoder never writes (``tests/util_webpforms.py``). Which
transforms, codes, filters, segments and partitions each stream holds is
read from the stream, so the grid is known to reach them. The four
consumers that open images through Pillow in the reference are held to
the JAX package on WebP files.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import chip_smoke
import util_webpforms as wf
from test_torch_iomanager import both  # noqa: F401 (fixture)
from art_tpu_torch.io import imagefile, webpdec
from art_tpu_torch.io.stdformats import DecompressionBomb, Unidentified

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def scene(h, w, seed=0, alpha=False):
    """A smooth scene with texture and noise (and a ramp of alpha)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 7 + y * 3) % 256, (y * 5 + 40) % 256,
                     ((x + y) * 2) % 256], -1)
    img = np.clip(base + rng.integers(-12, 13, (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)
    if alpha:
        a = (x * 255 // max(w - 1, 1) ^ (y * 40 % 256)).astype(np.uint8)
        img = np.concatenate([img, a[..., None]], -1)
    return img


def _kind(e):
    for cls in (OSError, ValueError, SyntaxError, EOFError):
        if isinstance(e, cls):
            return cls.__name__
    return type(e).__name__


def pil_outcome(buf):
    """What the reference gets: ("ok", pixels), ("open", error class) or
    ("load", error class)."""
    try:
        im = Image.open(io.BytesIO(buf))
    except Exception as e:  # noqa: BLE001 - every class is compared
        return "open", _kind(e)
    try:
        return "ok", np.asarray(im.convert("RGB")).tobytes()
    except Exception as e:  # noqa: BLE001
        return "load", _kind(e)


def port_outcome(buf):
    try:
        mode, samples, _ = imagefile._decode(buf, "x")
    except Unidentified:
        return "open", "OSError"
    except ValueError:  # Pillow's ValueErrors are all at open here
        return "open", "ValueError"
    except DecompressionBomb:
        return "open", "DecompressionBombError"
    except Exception as e:  # noqa: BLE001
        return "load", _kind(e)
    return "ok", imagefile.to_rgb8(mode, samples).tobytes()


def check(buf):
    """The port's RGB equals Pillow's, bit for bit."""
    want = np.asarray(Image.open(io.BytesIO(buf)).convert("RGB"))
    mode, got, _ = imagefile._decode(buf, "x")
    assert mode == "RGB"
    np.testing.assert_array_equal(got, want)
    return got


# -- lossless -----------------------------------------------------------------

def _lossless_images():
    """Small pictures, and one of three regions (noise, flat blocks, a
    ramp) on which the encoder takes the meta prefix codes and the colour
    cache."""
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:48, 0:64]
    smooth = np.stack([x * 4, y * 5, (x + y) * 2], -1).astype(np.uint8)
    regions = scene(128, 192)
    regions[:, 64:128] = np.repeat(np.repeat(
        rng.integers(0, 256, (16, 8, 3)), 8, 0), 8, 1)
    y, x = np.mgrid[0:128, 128:192]
    regions[:, 128:] = np.stack([x * 3, y * 2, x + y], -1).astype(np.uint8)
    blocks = np.repeat(np.repeat(rng.integers(0, 256, (6, 8, 3)), 8, 0), 8, 1)
    return {"scene alpha": scene(48, 64, 1, True), "smooth": smooth,
            "blocks": blocks.astype(np.uint8), "regions": regions}


LOSSLESS = [(name, method, quality) for name in _lossless_images()
            for method in range(7) for quality in (0, 50, 100)]
_SEEN = {}


@pytest.mark.parametrize("name,method,quality", LOSSLESS)
def test_lossless_methods_and_qualities(name, method, quality):
    img = _lossless_images()[name]
    buf = wf.pil_save(img, lossless=True, method=method, quality=quality,
                      exact=True)
    check(buf)
    kind, info = wf.stream_info(buf)
    assert kind == "VP8L"
    for t in range(info["transforms"]):
        _SEEN.setdefault("transforms", set()).add(info[f"t{t}"])
    if info["cache_bits"]:
        _SEEN["cache"] = True
    if info["meta_bits"]:
        _SEEN["meta"] = True


def test_lossless_grid_reaches_every_tool():
    """The grid above holds each transform, the colour cache and the meta
    prefix codes at least once (run after it in the same process; a
    worker that ran only part of it re-encodes the grid here)."""
    if len(_SEEN.get("transforms", ())) < 4 or "cache" not in _SEEN \
            or "meta" not in _SEEN:
        for name, method, quality in LOSSLESS:
            test_lossless_methods_and_qualities(name, method, quality)
    assert _SEEN["transforms"] == {0, 1, 2, 3}
    assert _SEEN.get("cache") and _SEEN.get("meta")


@pytest.mark.parametrize("colors", [2, 3, 4, 5, 16, 17, 256])
def test_lossless_palettes_and_bundling(colors):
    rng = np.random.default_rng(colors)
    pal = rng.integers(0, 256, (colors, 3)).astype(np.uint8)
    idx = (np.arange(37 * 29).reshape(37, 29) * 7 // 3) % colors
    buf = wf.pil_save(pal[idx], lossless=True, method=4)
    check(buf)
    _, info = wf.stream_info(buf)
    assert 3 in [info[f"t{t}"] for t in range(info["transforms"])]
    assert info["colors"] == colors


def test_lossless_exact_alpha_keeps_colour_under_zero_alpha():
    img = np.zeros((6, 9, 4), np.uint8)
    img[..., :3] = (200, 100, 50)
    img[2:4, 3:6, 3] = 255
    buf = wf.pil_save(img, lossless=True, exact=True)
    assert (check(buf) == (200, 100, 50)).all()


# -- lossy --------------------------------------------------------------------

SIZES = [(1, 1), (1, 19), (23, 1), (17, 23), (255, 257)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("alpha", [False, True])
def test_lossy_sizes_and_qualities(size, alpha):
    img = scene(*size, seed=size[0], alpha=alpha)
    for quality in (0, 50, 100):
        check(wf.pil_save(img, quality=quality))


ENCODER = (
    [dict(filter_type=0, filter_strength=50, sharpness=s) for s in range(8)]
    + [dict(filter_type=1, filter_strength=70, sharpness=s)
       for s in range(8)]
    + [dict(segments=n, sns=80) for n in (1, 2, 3, 4)]
    + [dict(partitions=p, method=m) for p in range(4) for m in (0, 2)]
    + [dict(filter_strength=0), dict(filter_strength=100),
       dict(filter_type=0, filter_strength=100), dict(quality=0, method=6),
       dict(quality=100, autofilter=1, method=6)])


@pytest.mark.parametrize("opts", ENCODER, ids=str)
def test_lossy_encoder_options(opts):
    img = scene(61, 83, seed=7)
    buf = wf.encode(img, **opts)
    check(buf)
    kind, info = wf.stream_info(buf)
    assert kind == "VP8"
    if opts.get("filter_strength", 60) == 0:
        assert info["level"] == 0
    elif "filter_type" in opts:
        assert info["simple"] == (opts["filter_type"] == 0)
        assert info["sharpness"] == opts["sharpness"] if "sharpness" in \
            opts else True
    if "segments" in opts:
        assert info["segments_on"] == (opts["segments"] > 1)
        assert bin(info["segments_used"]).count("1") <= opts["segments"]
    if "partitions" in opts:
        assert info["partitions"] == 1 << opts["partitions"]


def test_lossy_four_segments_with_their_map():
    buf = wf.encode(scene(96, 128, seed=2), segments=4, sns=100)
    check(buf)
    _, info = wf.stream_info(buf)
    assert info["segments_on"] and info["map"]
    assert info["segments_used"] == 0b1111


@pytest.mark.parametrize("seed", range(24))
def test_random_vp8_key_frames_as_pillow(seed):
    """VP8 key frames of random syntax (`util_webpforms.random_vp8`):
    what libwebp's encoder never writes (the macroblock skip flag,
    loop-filter deltas, absolute segment quantisers, random probability
    updates, cat6 tokens, every mode at every edge) decodes as Pillow
    decodes it; and (odd seeds) coefficients past an encoder's range, as
    a damaged stream's, through the SSE2 inverse DCT's 16-bit wrap."""
    buf = wf.riff(wf.chunk(b"VP8 ", wf.random_vp8(seed, wild=seed % 2)))
    check(buf)


def test_random_vp8_frames_reach_the_skip_flag():
    skipped = [wf.stream_info(wf.riff(wf.chunk(
        b"VP8 ", wf.random_vp8(s, wild=s % 2))))[1]["skipped"]
        for s in range(24)]
    assert sum(1 for n in skipped if n) >= 5


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_alpha_filters_and_compression(compression, filt):
    img = scene(45, 38, seed=filt, alpha=True)
    buf = wf.encode(img, alpha_compression=compression, alpha_filtering=filt,
                    alpha_quality=100)
    check(buf)
    alph = dict(wf.chunks_of(buf))[b"ALPH"]
    assert alph[0] & 3 == compression


@pytest.mark.parametrize("filt", [0, 1, 2, 3])
@pytest.mark.parametrize("pre", [0, 1])
def test_raw_alph_chunks_by_hand(filt, pre):
    """Raw ALPH (compression 0) with each filter written here, and the
    pre-processing bit, which changes nothing with dithering off."""
    rgb = scene(21, 30, seed=5)
    vp8 = dict(wf.chunks_of(wf.encode(rgb)))[b"VP8 "]
    a = scene(21, 30, seed=6)[..., 1]
    buf = wf.still_with([(b"ALPH", wf.alph(a, filt, 0, pre)), (b"VP8 ", vp8)],
                        30, 21, 0x10)
    assert (check(buf) == check(wf.riff(wf.chunk(b"VP8 ", vp8)))).all()
    bad = wf.still_with([(b"ALPH", wf.alph(a, filt)[:-1]), (b"VP8 ", vp8)],
                        30, 21, 0x10)
    assert pil_outcome(bad) == port_outcome(bad) == ("load", "OSError")
    off = wf.still_with([(b"ALPH", b"\xff"), (b"VP8 ", vp8)], 30, 21, 0)
    assert port_outcome(off) == pil_outcome(off)  # dropped: flag off


# -- containers -----------------------------------------------------------------

def test_animation_frame0_offset_with_icc():
    """Frame 0 smaller than the canvas and offset (x, y even): the rest
    of the canvas is (0, 0, 0); the ICCP chunk is the profile."""
    f0 = scene(20, 26, seed=8)
    f1 = scene(40, 50, seed=9)
    vp8 = dict(wf.chunks_of(wf.encode(f0)))[b"VP8 "]
    vp8l = dict(wf.chunks_of(wf.pil_save(f1, lossless=True)))[b"VP8L"]
    icc = b"\x00\x00\x02\x0cICC profile stand-in" * 4
    buf = wf.animation((50, 40), [(6, 10, 26, 20, 100, 0, [(b"VP8 ", vp8)]),
                                  (0, 0, 50, 40, 100, 2, [(b"VP8L", vp8l)])],
                       icc=icc)
    got = check(buf)
    assert (got[:10] == 0).all() and (got[:, :6] == 0).all()
    assert Image.open(io.BytesIO(buf)).info["icc_profile"] == icc
    assert imagefile._decode(buf, "x")[2] == icc


def test_animation_from_pillow_and_lossless_frame0():
    frames = [Image.fromarray(scene(30, 44, seed=s)) for s in range(3)]
    out = io.BytesIO()
    frames[0].save(out, "WEBP", save_all=True, append_images=frames[1:],
                   duration=80, lossless=True)
    check(out.getvalue())
    out = io.BytesIO()
    frames[0].save(out, "WEBP", save_all=True, append_images=frames[1:],
                   duration=80, quality=60, minimize_size=True)
    check(out.getvalue())


def test_vp8x_still_with_icc_exif_xmp():
    img = scene(19, 27, seed=4)
    buf = wf.pil_save(img, icc_profile=b"p" * 40, exif=b"Exif\0\0MM",
                      xmp=b"<x/>", quality=90)
    check(buf)
    assert imagefile._decode(buf, "x")[2] == b"p" * 40


CONTAINER_FAULTS = {
    "odd riff size": lambda b: b[:4] + struct.pack("<I", len(b) - 9) + b[8:],
    "riff past the end": lambda b: b[:4] + struct.pack("<I", len(b)) + b[8:],
    "trailing bytes": lambda b: b + b"\0junk",
    "trailing chunk": lambda b: b[:4] + struct.pack("<I", len(b) + 4)
    + b[8:] + b"XYZW\0\0\0\0",
    "short trailing": lambda b: b[:4] + struct.pack("<I", len(b) + 2)
    + b[8:] + b"\0\0",
    "vp8x reserved flag": lambda b: b[:20] + bytes([b[20] | 0x80]) + b[21:],
    "vp8x canvas": lambda b: b[:24] + bytes([b[24] ^ 1]) + b[25:],
    "vp8x size 12": lambda b: b[:16] + struct.pack("<I", 12) + b[20:],
}


@pytest.mark.parametrize("fault", sorted(CONTAINER_FAULTS))
@pytest.mark.parametrize("form", ["lossy alpha", "lossless", "animation"])
def test_container_faults_fail_as_pillow(fault, form):
    img = scene(18, 22, seed=11, alpha=form != "animation")
    if form == "lossy alpha":
        buf = wf.pil_save(img, quality=70)
    elif form == "lossless":
        buf = wf.pil_save(img, lossless=True)
        buf = wf.still_with([(b"ICCP", b"abc"), *wf.chunks_of(buf)], 22, 18,
                            0x30)
    else:
        frames = [Image.fromarray(scene(18, 22, seed=s)) for s in (1, 2)]
        out = io.BytesIO()
        frames[0].save(out, "WEBP", save_all=True, append_images=frames[1:])
        buf = out.getvalue()
    bad = CONTAINER_FAULTS[fault](buf)
    assert port_outcome(bad) == pil_outcome(bad)


def test_anmf_declared_size_and_bounds():
    f0 = scene(20, 26, seed=8)
    vp8 = dict(wf.chunks_of(wf.encode(f0)))[b"VP8 "]
    cases = [wf.animation((50, 40), [(x, y, w, h, 10, 0, [(b"VP8 ", vp8)])])
             for x, y, w, h in [(6, 10, 26, 20), (24, 20, 26, 20),
                                (26, 20, 26, 20), (6, 10, 30, 22),
                                (0, 0, 1, 1)]]
    cases.append(wf.animation((26, 20), [(0, 0, 26, 20, 10, 0, [])]))
    for buf in cases:
        assert port_outcome(buf) == pil_outcome(buf)


# -- damaged files --------------------------------------------------------------

def _walk_cases(buf, parts):
    """Cuts at a stride of 1/150 of the file, and byte flips at each of
    `parts` ((start, end) of a region: 30 offsets spread over it)."""
    n = len(buf)
    for cut in sorted({*range(0, n, max(1, n // 150)), n - 1, n - 2, 11, 15,
                       19, 29, 35}):
        yield f"cut {cut}", buf[:cut]
    for start, end in parts:
        for off in sorted({int(v) for v in np.linspace(start, end - 1, 30)}):
            for mask in (0x01, 0x80, 0xFF):
                b = bytearray(buf)
                b[off] ^= mask
                yield f"flip {off}^{mask}", bytes(b)


def _regions(buf):
    """Header, bitstream start and end, and ALPH regions of a file."""
    out, pos = [(0, 30)], 12
    end = 8 + struct.unpack_from("<I", buf, 4)[0]
    while pos + 8 <= end:
        kind = buf[pos : pos + 4]
        n = struct.unpack_from("<I", buf, pos + 4)[0]
        if kind in (b"VP8 ", b"VP8L", b"ALPH"):
            out.append((pos + 8, min(pos + 8 + n, pos + 48)))
            out.append((pos + 8 + n // 2, pos + 8 + n))
        pos += 8 + n + (n & 1)
    return out


@pytest.mark.parametrize("form", ["lossy", "lossless", "random VP8"])
def test_damaged_file_walk(form):
    img = scene(37, 51, seed=12, alpha=True)
    if form == "lossy":
        buf = wf.encode(img, alpha_compression=1, alpha_filtering=2,
                        partitions=2, method=2)
    elif form == "lossless":
        buf = wf.pil_save(img, lossless=True, method=5)
    else:  # skip flags, segments with their map, 8 token partitions
        buf = wf.riff(wf.chunk(b"VP8 ", wf.random_vp8(4, 53, 41)))
    bad = []
    cases = list(_walk_cases(buf, _regions(buf)))
    assert len(cases) > 400
    for name, data in cases:
        want, got = pil_outcome(data), port_outcome(data)
        if want != got:
            bad.append((name, want[:2] if want[0] != "ok" else "ok",
                        got[:2] if got[0] != "ok" else "ok"))
    assert not bad, bad[:10]


# -- dispatch and the consumers ----------------------------------------------------

def test_webp_is_reached_in_pillows_plugin_order():
    from art_tpu_torch.io import unported

    names = [e[0] for e in unported.WALK]
    assert "WebP" not in [n for n, _, _ in unported.FORMATS]
    before = names[: names.index("WebP")]
    assert before[-1] == "TGA"
    assert {"IM", "IMT", "IPTC/NAA", "PCD", "SPIDER"} <= set(before)
    buf = wf.pil_save(scene(8, 8), quality=80)
    assert unported.identify(buf) is None
    assert unported.walk(buf)[0] == "WebP"
    assert webpdec.accept(buf[:16])
    for bad in (buf[:12] + b"VP8Y" + buf[16:], b"RIFX" + buf[4:]):
        assert port_outcome(bad) == pil_outcome(bad) == ("open", "OSError")


def test_readers_take_webp(tmp_path):
    img = scene(30, 40, seed=13, alpha=True)
    path = str(tmp_path / "a.webp")
    open(path, "wb").write(wf.pil_save(img, quality=85))
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(imagefile.read_rgb8(path), want)
    plane, mode = imagefile.read_grey(path)
    assert mode == "L" and (plane == want[..., 1]).all()
    mode, samples, icc = imagefile.read_image(path)
    assert mode == "RGB" and icc is None and (samples == want).all()


def test_consumers_match_the_reference_on_webp(tmp_path):
    import art_tpu
    import art_tpu_torch
    from art_tpu.color.lut3d import load_hald_clut as ref_hald
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu.ops.sharpen import load_psf_kernel as ref_psf
    from art_tpu_torch.color.lut3d import load_hald_clut
    from art_tpu_torch.masks import load_external_mask
    from art_tpu_torch.ops.sharpen import load_psf_kernel

    hald = chip_smoke.hald_image(4, 8)
    hpath = str(tmp_path / "h.webp")
    open(hpath, "wb").write(wf.pil_save(hald, lossless=True))
    np.testing.assert_array_equal(load_hald_clut(hpath), ref_hald(hpath))
    grey = chip_smoke.f2_mask(40, 60).astype(np.uint8)
    mpath = str(tmp_path / "m.webp")
    open(mpath, "wb").write(wf.pil_save(np.repeat(grey[..., None], 3, 2),
                                        quality=90))
    for inverted in (False, True):
        np.testing.assert_array_equal(
            load_external_mask(mpath, 48, 72, inverted),
            ref_mask(mpath, 48, 72, inverted))
    yy, xx = np.mgrid[-4:5, -4:5]
    k = np.round(255 * np.exp(-(xx ** 2 + yy ** 2) / 6.0)).astype(np.uint8)
    kpath = str(tmp_path / "k.webp")
    open(kpath, "wb").write(wf.pil_save(np.repeat(k[..., None], 3, 2),
                                        lossless=True))
    for scale in (1.0, 2.0):
        np.testing.assert_array_equal(load_psf_kernel(kpath, scale),
                                      ref_psf(kpath, scale))
    ipath = str(tmp_path / "i.webp")
    open(ipath, "wb").write(wf.pil_save(scene(24, 40, seed=14), quality=70))
    ref, got = art_tpu.load_image(ipath), art_tpu_torch.load_image(ipath)
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    assert got.filename == ref.filename


def test_a_webp_pillow_cannot_open_reaches_its_loader(tmp_path, both):
    """A WebP that WebPAnimDecoderNew rejects (its VP8X flags a reserved
    bit): Pillow's open fails with OSError, so the reference hands the
    file to its [ART ImageIO] loader; so does the port. A WebP whose
    frame fails to decode fails at load in both, with no loader."""
    import sys

    from art_tpu.io.imagefile import load_std_image as ref_load
    from test_torch_iomanager import _tiff_writer

    iodir, run = both
    conv = _tiff_writer(tmp_path)
    (iodir / "webp.txt").write_text(
        f"[ART ImageIO]\nExtension=webp\nReadCommand={sys.executable} "
        f"{conv}\n")
    buf = wf.pil_save(scene(12, 16, seed=15, alpha=True), quality=80)
    assert buf[12:16] == b"VP8X"
    src = tmp_path / "a.webp"
    src.write_bytes(buf[:20] + bytes([buf[20] | 0x80]) + buf[21:])
    with pytest.raises(OSError):
        Image.open(str(src))
    ref = run("ref", lambda: ref_load(str(src)))
    got = run("port", lambda: imagefile.load_std_image(str(src)))
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    assert got.filename == ref.filename
    alph = dict(wf.chunks_of(buf))[b"ALPH"]
    src.write_bytes(buf.replace(alph[:4], bytes([alph[0] | 0xC0])
                                + alph[1:4], 1))
    for package, fn in (("ref", ref_load), ("port", imagefile.load_std_image)):
        with pytest.raises(OSError) as err:
            run(package, lambda: fn(str(src)))
        assert not isinstance(err.value, Unidentified)


@pytest.mark.parametrize("name", ["adobe-curv", "gamma-curv", "v4-para"])
def test_webp_icc_profile_converts_as_the_reference(name, tmp_path):
    """A WebP's ICCP chunk is Pillow's info["icc_profile"], and
    load_std_image converts through it as the reference does (bit-equal
    for a matrix/TRC profile)."""
    from test_torch_stdimage import MATRIX_ICC, RGB8, assert_same_frame

    icc = MATRIX_ICC[name]()
    path = str(tmp_path / "a.webp")
    Image.fromarray(RGB8).save(path, "WEBP", lossless=True, icc_profile=icc)
    assert imagefile.read_image(path)[2] == icc
    assert_same_frame(path)


def test_process_image_of_a_webp_is_refused_as_the_reference(tmp_path):
    """A non-raw WebP loads as the reference loads it and its develop is
    refused, as the reference's plan fails on every non-raw frame."""
    import art_tpu
    import art_tpu_torch
    from art_tpu.params import ProcParams as RefProcParams
    from art_tpu_torch.params import ProcParams

    path = str(tmp_path / "p.webp")
    open(path, "wb").write(wf.pil_save(scene(16, 24, seed=16), quality=90))
    assert not art_tpu_torch.load_image(path).is_raw
    with pytest.raises(UnboundLocalError):
        art_tpu.process_image(path, RefProcParams())
    with pytest.raises(NotImplementedError, match="non-raw input"):
        art_tpu_torch.process_image(path, ProcParams(), device="cpu")


# -- fixtures and chip_smoke's writer -------------------------------------------------

WEBP_FIXTURES = ["webp_lossless_transforms.webp", "webp_lossy_alpha.webp",
                 "webp_lossy_simple_8parts.webp", "webp_anim_icc.webp",
                 "webp_w2_mask.webp"]


def test_webp_fixtures_hold_what_they_name():
    recorded = json.load(open(os.path.join(DATA, "formats_sha256.json")))
    for name in WEBP_FIXTURES:
        path = os.path.join(DATA, name)
        buf = open(path, "rb").read()
        assert len(buf) <= 40 * 1024
        want = np.asarray(Image.open(path).convert("RGB"))
        assert hashlib.sha256(want.tobytes()).hexdigest() == recorded[name]
        np.testing.assert_array_equal(imagefile.read_rgb8(path), want)
    _, info = wf.stream_info(open(os.path.join(
        DATA, WEBP_FIXTURES[0]), "rb").read())
    assert {info[f"t{t}"] for t in range(info["transforms"])} == {0, 1, 2, 3}
    assert info["cache_bits"] and info["meta_bits"] and info["groups"] == 2
    _, info = wf.stream_info(open(os.path.join(
        DATA, WEBP_FIXTURES[1]), "rb").read())
    assert not info["simple"] and info["segments_used"] == 0b1111
    _, info = wf.stream_info(open(os.path.join(
        DATA, WEBP_FIXTURES[2]), "rb").read())
    assert info["simple"] and info["partitions"] == 8
    assert Image.open(os.path.join(DATA, WEBP_FIXTURES[3])).info.get(
        "icc_profile")


def test_w1_lossy_24mp_fixture_form():
    """W1's committed file: a lossy 4000x6000 WebP with alpha under 1.5
    MB (its sha256: tests/test_torch_formats.py::
    test_committed_fixtures_hold_their_sha256)."""
    path = os.path.join(DATA, chip_smoke.W1_LOSSY)
    assert os.path.getsize(path) <= 1536 * 1024
    buf = open(path, "rb").read()
    kinds = [k for k, _ in wf.chunks_of(buf)]
    assert kinds == [b"VP8X", b"ALPH", b"VP8 "]
    assert Image.open(path).size == chip_smoke.W1_LOSSY_SIZE[::-1]
    assert webpdec.open_webp(buf).canvas == chip_smoke.W1_LOSSY_SIZE[::-1]


def test_chip_smoke_vp8l_writer_as_pillow_reads_it(tmp_path):
    rgb = chip_smoke.formats_arrays(96, 130)[0]
    path = chip_smoke.write_webp_lossless(str(tmp_path / "w.webp"), rgb)
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(want, rgb)
    np.testing.assert_array_equal(imagefile.read_rgb8(path), rgb)
    _, info = wf.stream_info(open(path, "rb").read())
    assert info["transforms"] == 1 and info["t0"] == 2 and info["groups"] == 1


# -- C11: the PNG reader's open and load as Pillow's -----------------------------

def _png_chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _pngs():
    rng = np.random.default_rng(1)
    out = {}
    for name, img in [
            ("rgb", Image.fromarray(rng.integers(0, 256, (20, 24, 3),
                                                 dtype=np.uint8))),
            ("palette", Image.fromarray(rng.integers(
                0, 256, (13, 17, 3), dtype=np.uint8)).quantize(16)),
            ("grey16", Image.fromarray(rng.integers(0, 65536, (9, 11),
                                                    dtype=np.uint16)))]:
        b = io.BytesIO()
        img.save(b, "PNG")
        out[name] = b.getvalue()
    # a 12-byte IHDR (Pillow's open: ValueError), and the RGB image's
    # data split over three IDAT chunks
    pal = out["palette"]
    out["ihdr12"] = pal[:8] + _png_chunk(b"IHDR", pal[16:28]) + pal[33:]
    rgb = out["rgb"]
    pos, parts = 8, []
    while pos < len(rgb):
        n = struct.unpack_from(">I", rgb, pos)[0]
        kind, body = rgb[pos + 4 : pos + 8], rgb[pos + 8 : pos + 8 + n]
        if kind == b"IDAT":
            step = -(-n // 3)
            parts += [_png_chunk(b"IDAT", body[i : i + step])
                      for i in range(0, n, step)]
        else:
            parts.append(_png_chunk(kind, body))
        pos += 12 + n
    out["rgb 3 IDAT"] = rgb[:8] + b"".join(parts)
    return out


@pytest.mark.parametrize("name", ["rgb", "palette", "grey16", "ihdr12",
                                  "rgb 3 IDAT"])
def test_png_cuts_and_crc_flips_as_pillow(name):
    """Every cut offset and every CRC byte flip of each chunk (IHDR,
    PLTE, IDAT, IEND): Pillow checks CRCs at open only, before the image
    data, and reads what follows the image leniently."""
    buf = _pngs()[name]
    cases = [buf[:k] for k in range(len(buf))]
    pos = 8
    while pos + 8 <= len(buf):
        n = struct.unpack_from(">I", buf, pos)[0]
        for j in range(4):
            b = bytearray(buf)
            b[pos + 8 + n + j] ^= 0x5A
            cases.append(bytes(b))
        pos += 12 + n
    bad = [k for k, c in enumerate(cases) if port_outcome(c) != pil_outcome(c)]
    assert not bad, bad[:10]


def test_png_c11_cases_load_equal_to_pillow():
    """The three files of fault C11: cut inside the last IDAT's CRC, and
    one byte of the IDAT or of the IEND CRC flipped."""
    buf = _pngs()["rgb"]
    idat_end = buf.rindex(b"IEND") - 4
    flips = []
    for at in (idat_end - 2, len(buf) - 2):
        b = bytearray(buf)
        b[at] ^= 0x01
        flips.append(bytes(b))
    for case in [buf[: idat_end - 2], *flips]:
        want = np.asarray(Image.open(io.BytesIO(case)).convert("RGB"))
        mode, got, _ = imagefile._decode(case, "x")
        np.testing.assert_array_equal(imagefile.to_rgb8(mode, got), want)
