"""The port's JPEG decoder (`io/jpegdec.py`, `io/native/jpegdec.cc`), the
embedded preview's decode, the histogram-matched tone curve and the JPEG
file paths, against Pillow and `art_tpu` on the CPU.

Pillow 12.1.0 (libjpeg-turbo 3.1.3, read from
``PIL.features.version_feature("libjpeg_turbo")`` and recorded) and
OpenCV write the fixtures and are the oracle: the port's array must
equal ``np.asarray(Image.open(...).convert("RGB"))`` bit for bit, under
Pillow's strict load and under its ``LOAD_TRUNCATED_IMAGES`` salvage load,
and fail where that load fails.

- The grid: baseline and progressive; grey and colour at 4:4:4, 4:2:2,
  4:2:0, 4:4:0 and 4:1:1 (OpenCV); with and without a restart marker
  every MCU; 1x1, 7x9, 17x33 and 40x56. Each file whole and cut: right
  after SOI, inside the first SOS header, at 24 points through the
  data, one and two bytes short.
- Pillow's own writers (JFIF, optimised tables, progressive, restart
  intervals by blocks and by rows), an Adobe RGB-transform file, a file
  with no JFIF marker, component IDs R, G, B; files past 64 KiB cut near
  their end (Pillow feeds 64 KiB a call); scans with bytes overwritten
  and garbage after SOI.
- The forms the port refuses by name where Pillow decodes them (CMYK,
  YCCK, arithmetic coding, lossless SOF3) and those it fails as Pillow
  fails (12 bits, a hierarchical SOF5).
- `embedded_thumb` and `decode_jpeg_resilient` equal the reference's on
  DNGs with a preview: whole, with an under-reported length (the 32 MiB
  read on), cut inside the scan (the salvage pass), unreadable (None).
- `histogram_matching_curve` equals the reference's points exactly on
  the same arrays.
- The bundled Auto-Matched Curve.arp on a 192x256 DNG with a preview:
  the matched points within 1e-6 of the reference's, the develop within
  1 LSB8 max and 2e-4 mean, through `plan`/`develop` and `process_image`
  (also fast, with a resize) with the listener's report; the caller's pp
  is not changed (the reference's is: a second file reuses its curve).
- A Hald CLUT, a PSF and an external mask as JPEG load as the
  reference's loaders load them.
"""

import importlib
import io
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image, ImageFile, features

from art_tpu.io import metadata as jmeta
from art_tpu.io.rawfile import load_raw as ref_load_raw
from art_tpu.params import ProcParams as RefProcParams
from art_tpu.pipeline import autos as jautos
from art_tpu_torch.io import jpegdec
from art_tpu_torch.io import metadata as tmeta
from art_tpu_torch.io.dngwrite import write_dng
from art_tpu_torch.io.rawfile import load_raw
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import autos as tautos
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import fast_box_arp, parity
from tests.test_torch_plan import Develops, plan_key

jdev = importlib.import_module("art_tpu.pipeline.develop")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATCHED_ARP = os.path.join(REPO, "art_tpu_torch", "data", "profiles",
                           "Auto-Matched Curve.arp")


def test_oracle_version(record_property):
    version = features.version_feature("libjpeg_turbo")
    record_property("libjpeg_turbo", version)
    print("Pillow", Image.__version__, "libjpeg-turbo", version)
    assert version is not None


def pil_load(buf, salvage):
    """Pillow's array, or the exception its load raised."""
    prev = ImageFile.LOAD_TRUNCATED_IMAGES
    ImageFile.LOAD_TRUNCATED_IMAGES = salvage
    try:
        im = Image.open(io.BytesIO(buf))
        im.load()
        return np.asarray(im.convert("RGB"))
    except Exception as e:  # the oracle's failure, of any kind
        return e
    finally:
        ImageFile.LOAD_TRUNCATED_IMAGES = prev


def check_as_pil(buf, what=""):
    for salvage in (False, True):
        want = pil_load(buf, salvage)
        if isinstance(want, Exception):
            with pytest.raises(OSError):
                jpegdec.decode_rgb(buf, salvage)
            continue
        got = jpegdec.decode_rgb(buf, salvage)
        assert got.shape == want.shape, (what, salvage)
        assert np.array_equal(got, want), (
            what, salvage, int((got != want).sum()))


def scene(h, w, seed=0, grey=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([(xx * 7 + yy * 3) % 256, (yy * 9) % 256,
                  ((xx - yy) * 5) % 256], -1).astype(float)
    a = np.clip(a + rng.normal(0, 25, a.shape), 0, 255).astype(np.uint8)
    return a[..., 0] if grey else a


SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def cv_jpeg(a, sampling="420", progressive=False, restart=0, quality=85):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    if a.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        a = a[..., ::-1]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, buf = cv2.imencode(".jpg", a, params)
    assert ok
    return buf.tobytes()


def pil_jpeg(a, **kw):
    b = io.BytesIO()
    Image.fromarray(a).save(b, "JPEG", **kw)
    return b.getvalue()


def cuts(buf):
    """Right after SOI, inside the first SOS header, 24 points through
    the rest, one and two bytes short."""
    sos = buf.index(b"\xff\xda")
    through = np.linspace(sos + 12, len(buf) - 3, 24).astype(int)
    return sorted({2, 3, sos + 3, *through.tolist(), len(buf) - 2,
                   len(buf) - 1})


FORMS = ([("grey", "444")] + [("colour", s) for s in SAMPLING])
SIZES = [(1, 1), (7, 9), (17, 33), (40, 56)]


@pytest.mark.parametrize("restart", [0, 1], ids=["no-rst", "rst1"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("form,sampling", FORMS,
                         ids=[f"{f}-{s}" for f, s in FORMS])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_decodes_as_pil(size, form, sampling, progressive, restart):
    h, w = size
    a = scene(h, w, seed=h * 100 + w, grey=form == "grey")
    buf = cv_jpeg(a, sampling, progressive, restart)
    check_as_pil(buf, "whole")
    for cut in cuts(buf):
        check_as_pil(buf[:cut], f"cut at {cut} of {len(buf)}")


@pytest.mark.parametrize("sampling,restart,cut", [("444", 1, 1094),
                                                  ("422", 0, 1428),
                                                  ("422", 0, 2234)])
def test_zero_filled_blocks_decode_as_pil(sampling, restart, cut):
    # cuts whose zero-filled MCU drives the IDCT past the sample range:
    # libjpeg-turbo's SIMD IDCT saturates there where its C code's
    # range-limit table wraps, and Pillow runs the SIMD one
    buf = cv_jpeg(scene(40, 56, seed=4063), sampling, False, restart)
    check_as_pil(buf[:cut], f"cut at {cut}")


PIL_WRITERS = {
    "q75": dict(quality=75), "444-q95": dict(quality=95, subsampling=0),
    "422-q50": dict(quality=50, subsampling=1),
    "progressive": dict(quality=90, progressive=True),
    "rst-blocks": dict(quality=80, restart_marker_blocks=1),
    "rst-rows": dict(quality=80, restart_marker_rows=1),
    "optimize": dict(quality=90, optimize=True),
    "progressive-rst": dict(quality=90, progressive=True,
                            restart_marker_blocks=2)}


@pytest.mark.parametrize("grey", [False, True], ids=["colour", "grey"])
@pytest.mark.parametrize("writer", sorted(PIL_WRITERS))
def test_pil_written_files_decode_as_pil(writer, grey):
    for h, w in SIZES:
        check_as_pil(pil_jpeg(scene(h, w, seed=1, grey=grey),
                              **PIL_WRITERS[writer]))


def _strip_app0(buf):
    i = buf.index(b"\xff\xe0")
    return buf[:i] + buf[i + 2 + int.from_bytes(buf[i + 2 : i + 4], "big"):]


def test_colour_space_markers_decode_as_pil():
    for h, w in [(17, 33), (40, 56)]:
        a = scene(h, w, seed=2)
        check_as_pil(pil_jpeg(a, quality=90, keep_rgb=True), "Adobe RGB")
        bare = _strip_app0(pil_jpeg(a, quality=90))
        check_as_pil(bare, "no JFIF")
        rgb_ids = bytearray(bare)
        sof, sos = rgb_ids.index(b"\xff\xc0"), rgb_ids.index(b"\xff\xda")
        for k, cid in enumerate(b"RGB"):
            rgb_ids[sof + 10 + 3 * k] = cid
            rgb_ids[sos + 5 + 2 * k] = cid
        check_as_pil(bytes(rgb_ids), "component IDs R, G, B")


@pytest.mark.parametrize("kw", [dict(quality=95), dict(quality=95,
                                                       progressive=True),
                                dict(quality=85, restart_marker_blocks=3)],
                         ids=["baseline", "progressive", "rst3"])
def test_files_past_one_read_decode_as_pil(kw):
    buf = pil_jpeg(scene(300, 400, seed=3), **kw)
    assert len(buf) > 65536
    for cut in (len(buf), len(buf) - 1, len(buf) - 2, len(buf) - 5,
                len(buf) - 30, 65536, 65537, len(buf) // 2):
        check_as_pil(buf[:cut], f"cut at {cut} of {len(buf)}")


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_damaged_data_decodes_as_pil(progressive):
    rng = np.random.default_rng(5)
    for sampling in ("420", "444"):
        buf = cv_jpeg(scene(64, 80, seed=9), sampling, progressive)
        sos = buf.index(b"\xff\xda")
        for _ in range(12):
            bad = bytearray(buf)
            p = int(rng.integers(sos + 14, len(buf) - 2))
            k = int(rng.integers(1, 40))
            bad[p : p + k] = rng.integers(0, 256, k).astype(
                np.uint8).tobytes()
            check_as_pil(bytes(bad[: len(buf)]), f"{k} bytes at {p}")


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_files_without_their_tables_decode_as_pil(progressive):
    # libjpeg-turbo fills the standard Huffman tables into empty slots 0
    # and 1 of a sequential file (Motion-JPEG frames carry none), and of
    # no progressive one: there the first scan's missing table fails
    buf = cv_jpeg(scene(26, 40, seed=4), "420", progressive, quality=60)
    dht = buf.index(b"\xff\xc4")
    bare = buf[:dht] + buf[dht + 2 + int.from_bytes(buf[dht + 2 : dht + 4],
                                                    "big"):]
    check_as_pil(bare)
    assert isinstance(pil_load(bare, False), Exception) == progressive


def test_garbage_after_soi_fails_as_pil():
    rng = np.random.default_rng(6)
    for t in range(30):
        g = rng.integers(0, 256, int(rng.integers(0, 200))).astype(
            np.uint8).tobytes()
        check_as_pil(b"\xff\xd8" + g)
        check_as_pil(b"\xff\xd8\xff" + g)
        buf = pil_jpeg(scene(17, 33, seed=t), quality=80)
        p = int(rng.integers(2, buf.index(b"\xff\xda")))
        check_as_pil(buf[:p] + g + buf[p:], f"garbage at {p}")


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def arithmetic_jpeg():
    """An 8x8 grey frame under SOF9 with a scan of arbitrary bytes (an
    arithmetic decoder reads any bytes)."""
    return (b"\xff\xd8" + _segment(0xDB, bytes([0]) + bytes([1] * 64))
            + _segment(0xC9, bytes([8, 0, 8, 0, 8, 1, 1, 0x11, 0]))
            + _segment(0xDA, bytes([1, 1, 0x00, 0, 63, 0]))
            + bytes(np.random.default_rng(0).integers(0, 255, 40).astype(
                np.uint8)) + b"\xff\xd9")


def lossless_jpeg(g):
    """An 8-bit grey image as a lossless SOF3 JPEG (predictor 1, the
    Annex K luminance DC table for the differences)."""
    h, w = g.shape
    bits = [0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    codes, code, k = {}, 0, 0
    for n in range(1, 17):
        for _ in range(bits[n]):
            codes[k] = (code, n)
            code += 1
            k += 1
        code <<= 1
    out, acc, nacc = [], 0, 0

    def put(v, n):
        nonlocal acc, nacc
        acc, nacc = (acc << n) | v, nacc + n
        while nacc >= 8:
            byte = (acc >> (nacc - 8)) & 255
            nacc -= 8
            out.extend([byte, 0] if byte == 255 else [byte])

    g = g.astype(int)
    for y in range(h):
        for x in range(w):
            p = 128 if x == 0 and y == 0 else (
                g[y, x - 1] if y == 0 or x > 0 else g[y - 1, x])
            d = g[y, x] - p
            s = int(abs(d)).bit_length()
            put(*codes[s])
            if s:
                put(d if d > 0 else d + (1 << s) - 1, s)
    if nacc:
        put((1 << (8 - nacc)) - 1, 8 - nacc)
    return (b"\xff\xd8" + _segment(0xC4, bytes([0] + bits[1:]) + bytes(
        range(12))) + _segment(0xC3, bytes([8]) + struct.pack(">HH", h, w)
                               + bytes([1, 1, 0x11, 0]))
            + _segment(0xDA, bytes([1, 1, 0x00, 1, 0, 0])) + bytes(out)
            + b"\xff\xd9")


def _cmyk(transform=None):
    b = io.BytesIO()
    Image.fromarray(scene(16, 24, seed=1)).convert("CMYK").save(
        b, "JPEG", quality=90)
    buf = bytearray(b.getvalue())
    if transform is not None:
        buf[buf.index(b"Adobe") + 11] = transform
    return bytes(buf)


REFUSED = {"CMYK": _cmyk, "YCCK": lambda: _cmyk(2),
           "arithmetic-coded": arithmetic_jpeg,
           "lossless": lambda: lossless_jpeg(scene(9, 13, 3, grey=True))}


@pytest.mark.parametrize("form", sorted(REFUSED))
def test_forms_pil_decodes_are_refused_by_name(form, tmp_path):
    """The forms the port once refused by name (CMYK, YCCK, arithmetic
    coding, lossless) decode as Pillow decodes them: strict, salvage and
    through the image readers."""
    buf = REFUSED[form]()
    for salvage in (False, True):
        assert not isinstance(pil_load(buf, salvage), Exception)
    check_as_pil(buf, form)
    path = tmp_path / "a.jpg"
    path.write_bytes(buf)
    from art_tpu_torch.io.imagefile import read_grey, read_rgb8

    want = pil_load(buf, False)
    np.testing.assert_array_equal(read_rgb8(str(path)), want)
    grey, mode = read_grey(str(path))
    np.testing.assert_array_equal(grey, want[..., 1])
    assert mode == "L"


def test_forms_pil_fails_on_fail_alike():
    twelve = bytearray(pil_jpeg(scene(16, 24), quality=90))
    twelve[twelve.index(b"\xff\xc0") + 4] = 12
    sof5 = bytearray(pil_jpeg(scene(16, 24), quality=90))
    sof5[sof5.index(b"\xff\xc0") + 1] = 0xC5
    assert isinstance(pil_load(bytes(twelve), True), Exception)
    assert isinstance(pil_load(bytes(sof5), False), Exception)
    for buf in (bytes(twelve), bytes(sof5)):
        check_as_pil(buf)


# -- the embedded preview ---------------------------------------------------

def preview_dng(path, h=192, w=256, seed=3):
    """test_metadata.py::dng_with_preview's DNG: a grey ramp with 1% noise
    under RGGB, and its tone-mapped look at a quarter size as the JPEG
    preview. Returns the preview's offset and length in the file."""
    from art_tpu_torch.core.image import synthesize_bayer

    rng = np.random.default_rng(seed)
    rgb = np.clip(np.stack([np.linspace(0.1, 0.9, w)[None, :]
                            * np.ones((h, 1))] * 3)
                  + rng.normal(0, 0.01, (3, h, w)), 0, 1)
    frame = synthesize_bayer(rgb.astype(np.float32), "RGGB")
    look = np.clip(0.5 - 0.5 * np.cos(np.pi * rgb ** 0.8), 0, 1)
    write_dng(path, np.asarray(frame.cfa).astype(np.uint16),
              pattern="RGGB", black=512, white=16383,
              preview_rgb01=look[:, ::4, ::4])
    (off, length), = tmeta.harvest(str(path))[1]
    return off, length


def _patch_length(path, length):
    """Set the preview's JPEGInterchangeFormatLength (tag 514) in place."""
    buf = bytearray(open(path, "rb").read())
    ifd = struct.unpack_from("<I", buf, 4)[0]
    for i in range(struct.unpack_from("<H", buf, ifd)[0]):
        p = ifd + 2 + 12 * i
        if struct.unpack_from("<H", buf, p)[0] == 514:
            struct.pack_into("<I", buf, p + 8, length)
    open(path, "wb").write(bytes(buf))


@pytest.mark.parametrize("case", ["whole", "under-reported", "cut",
                                  "unreadable"])
def test_embedded_thumb_equals_reference(tmp_path, case):
    path = str(tmp_path / "p.dng")
    off, length = preview_dng(path)
    if case == "under-reported":
        _patch_length(path, length // 2)
    elif case == "cut":
        with open(path, "r+b") as f:
            f.truncate(off + length * 2 // 3)
    elif case == "unreadable":
        with open(path, "r+b") as f:
            f.seek(off + 2)
            f.write(b"\x00" * 64)
    got, want = tmeta.embedded_thumb(path), jmeta.embedded_thumb(path)
    if case == "unreadable":
        assert got is None and want is None
        return
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (3, 48, 64)
    assert np.array_equal(got, want)
    with open(path, "rb") as f:
        f.seek(off)
        blob = f.read(length)
    for a, b in ((tmeta.decode_jpeg_resilient(blob),
                  jmeta._decode_jpeg_resilient(blob)),):
        assert np.array_equal(a, np.asarray(b))


# -- the matched curve ------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_histogram_matching_curve_equals_reference(seed):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 1, (3, 37, 53)).astype(np.float32) ** (1 + seed)
    dst = np.clip(rng.normal(0.5, 0.2 + 0.05 * seed, (3, 48, 64)), 0,
                  1).astype(np.float32)
    got = tautos.histogram_matching_curve(src, dst)
    want = jautos.histogram_matching_curve(src, dst)
    assert got == want
    assert got[:3] == [1.0, 0.0, 0.0] and got[-2:] == [1.0, 1.0]


# -- the step in the plan ---------------------------------------------------

@pytest.fixture(scope="module")
def develops(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    return Develops(root / "plan_develops")


@pytest.fixture(scope="module")
def matched(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("matched") / "p.dng")
    preview_dng(path)
    return path


def _matched_pps(extra=""):
    text = open(MATCHED_ARP).read() + extra
    pp, ref_pp = ProcParams(), RefProcParams()
    pp.apply_arp_text(text)
    ref_pp.apply_arp_text(text)
    assert pp.tone_curve.histmatching and not pp.tone_curve.from_histmatching
    return pp, ref_pp


def test_auto_matched_curve_develops_as_the_reference(matched, develops):
    from art_tpu_torch.pipeline.listeners import _Collect

    pp, ref_pp = _matched_pps()
    with _Collect() as report:
        cfg, data = tdev.plan(load_raw(matched), pp, device="cpu")
    pts = report["matched_curve"]
    assert [s[0] for s in cfg.steps] == ["tonecurve"]
    # the caller's pp keeps asking; the reference resolves it in place
    assert not pp.tone_curve.from_histmatching and pp.tone_curve.curve != pts
    ref_out = develops.get("ref", plan_key(cfg, data), lambda: jdev.develop(
        ref_load_raw(matched), ref_pp))
    out = develops.get("port", plan_key(cfg, data), lambda: tdev.develop(
        load_raw(matched), pp, device="cpu").numpy())
    ref_pts = ref_pp.tone_curve.curve if ref_pp.tone_curve.from_histmatching \
        else _ref_points(matched)
    assert len(pts) == len(ref_pts) > 6
    assert np.abs(np.subtract(pts, ref_pts)).max() <= 1e-6
    st = parity(out, ref_out)
    print("Auto-Matched Curve port vs art_tpu", st, "points", pts)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st


def _ref_points(path):
    ref_pp = _matched_pps()[1]
    jdev.plan(ref_load_raw(path), ref_pp)
    assert ref_pp.tone_curve.from_histmatching
    return ref_pp.tone_curve.curve


@pytest.mark.parametrize("fast", [False, True], ids=["full", "fast"])
def test_auto_matched_curve_through_process_image(matched, tmp_path, fast):
    from art_tpu.pipeline.listeners import PipelineListener as RefListener
    from art_tpu_torch.pipeline.listeners import PipelineListener

    class Seen(PipelineListener):
        points = None

        def auto_matched_curve_changed(self, points):
            self.points = points

    class RefSeen(RefListener):
        points = None

        def auto_matched_curve_changed(self, points):
            self.points = points

    extra = fast_box_arp(128) if fast else ""
    pp, ref_pp = _matched_pps(extra)
    seen, ref_seen = Seen(), RefSeen()
    out = tdev.process_image(matched, pp, fast=fast, listener=seen,
                             device="cpu")
    ref = jdev.process_image(matched, ref_pp, fast=fast, listener=ref_seen)
    assert seen.points is not None and ref_seen.points is not None
    assert np.abs(np.subtract(seen.points, ref_seen.points)).max() <= 1e-6
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert (out.size < 3 * 192 * 256) == fast
    scale = 255.0 if out.dtype == np.uint8 else 1.0
    st = parity(out.astype(np.float32) / scale,
                ref.astype(np.float32) / scale)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st


def test_a_reused_pp_matches_each_file(matched, tmp_path):
    # the port resolves the curve on a copy, so a pp reused for a second
    # file matches that file's preview; the reference's first plan writes
    # the curve into the caller's pp, and its second file keeps that curve
    from art_tpu_torch.pipeline.listeners import _Collect

    second = str(tmp_path / "q.dng")
    preview_dng(second, seed=11, w=320)
    pp, ref_pp = _matched_pps()
    points = []
    for path in (matched, second):
        with _Collect() as report:
            tdev.plan(load_raw(path), pp, device="cpu")
        points.append(report["matched_curve"])
    assert not pp.tone_curve.from_histmatching
    jdev.plan(ref_load_raw(matched), ref_pp)
    first = list(ref_pp.tone_curve.curve)
    jdev.plan(ref_load_raw(second), ref_pp)
    assert ref_pp.tone_curve.curve == first
    assert np.abs(np.subtract(points[0], first)).max() <= 1e-6
    assert np.abs(np.subtract(points[1], _ref_points(second))).max() <= 1e-6
    assert points[1] != points[0]


def test_a_preview_neither_load_decodes_is_skipped(tmp_path):
    path = str(tmp_path / "p.dng")
    off, _ = preview_dng(path)
    with open(path, "r+b") as f:
        f.seek(off + 2)
        f.write(b"\x00" * 64)
    pp, ref_pp = _matched_pps()
    cfg, _ = tdev.plan(load_raw(path), pp, device="cpu")
    ref_cfg, _ = jdev.plan(ref_load_raw(path), ref_pp)
    assert [s[0] for s in cfg.steps] == [s[0] for s in ref_cfg.steps] == []
    assert not ref_pp.tone_curve.from_histmatching


# -- the JPEG file paths ----------------------------------------------------

@pytest.mark.parametrize("level", [2, 4])
def test_hald_clut_jpeg_loads_as_reference(tmp_path, level):
    from art_tpu.color.lut3d import load_hald_clut as ref_load
    from art_tpu_torch.color.lut3d import load_hald_clut
    from chip_smoke import hald_image

    path = str(tmp_path / "hald.jpg")
    Image.fromarray(hald_image(level, 8)).save(path, quality=92)
    got, want = load_hald_clut(path), ref_load(path)
    assert got.shape == want.shape == (level ** 2,) * 3 + (3,)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_external_mask_jpeg_loads_as_reference(tmp_path, mode):
    from art_tpu.masks import _load_external_mask as ref_load
    from art_tpu_torch.masks import load_external_mask

    rng = np.random.default_rng(7)
    img = scene(53, 71, seed=7, grey=mode == "L")
    img = np.clip(img.astype(int) + rng.integers(0, 30, img.shape), 0, 255)
    path = str(tmp_path / "mask.jpg")
    Image.fromarray(img.astype(np.uint8)).save(path, quality=90)
    for inverted in (False, True):
        got = np.asarray(load_external_mask(path, 40, 64, inverted))
        want = ref_load(path, 40, 64, inverted)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    cut = str(tmp_path / "cut.jpg")
    open(cut, "wb").write(open(path, "rb").read()[:400])
    assert load_external_mask(cut, 40, 64, False) is None
    with pytest.raises(OSError):
        ref_load(cut, 40, 64, False)
