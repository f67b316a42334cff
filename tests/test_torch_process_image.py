"""The headless ART-cli slice on the CPU: a raw file in, a JPEG out,
through `art_tpu_torch.pipeline.develop.process_image` and
`art_tpu_torch.cli.main`, against the reference's (PIL decodes the
JPEGs here; the port imports no PIL).

- Config 1 (BASELINE.json configs[0]: ProcParams() with bilinear
  demosaic, sRGB JPEG) on a 256x384 LJ92 DNG from a seed: the returned
  u8 arrays agree to the slice bounds in 8-bit steps (max <= 1, at least
  99.9% equal; PERF.md section 2); the JPEGs hold the same segments in
  the same order, equal but for the EXIF blob (built without PIL), whose
  tags read the same; the port's encoder writes the reference's scan
  from the reference's pixels; decoded, the two files agree in every
  8x8 block in which the u8 arrays agree.
- The flagship profile with bilinear demosaic at 256x1024, port only:
  the device-side u8 output behind the fused tail equals the u8 cast of
  the port's float develop, exactly.
- `cli.main` of both packages with -p and -O: the JPEGs agree as above
  and the .arp copies parse to equal ProcParams.
- The bundled Auto-Matched Curve.arp through `cli.main` of both
  packages on a DNG with a JPEG preview: the decoded JPEGs agree to the
  slice bounds.
- What the slice does not port (auto distortion from a JPEG preview)
  and a non-raw input (whose develop the reference's plan fails on)
  exit 2, or raise, naming the step; a gamut
  warning against a LUT-class proof profile exits 2 as in the
  reference; --check-lut on a file that is no image answers 1, as the
  reference's. (--devices N over several files runs the
  batch queue: tests/test_torch_queue.py.)
- The port's copies of the app options reader and the profile store
  read as the reference's.
"""

import dataclasses
import os
import struct

import numpy as np
import pytest
import torch

from art_tpu.params import ProcParams as RefProcParams
from art_tpu_torch.params import ProcParams

Image = pytest.importorskip("PIL.Image")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARP = os.path.join(REPO, "art_tpu_torch", "data", "profiles",
                   "Standard Film Curve.arp")
BILINEAR_ARP = "[RAW Bayer]\nMethod=bilinear\n"


@pytest.fixture(scope="module")
def dng(tmp_path_factory):
    """Config 1's DNG as tools/bench_configs.py writes it, at 256x384
    and LJ92-compressed, and a profile that selects bilinear."""
    from art_tpu_torch.io.dngwrite import write_dng

    d = tmp_path_factory.mktemp("config1")
    m = (np.random.default_rng(1).uniform(0.05, 0.9, (256, 384))
         * 16000 + 500).astype(np.uint16)
    write_dng(d / "c1.dng", m, black=500, white=16500)
    (d / "bilinear.arp").write_text(BILINEAR_ARP)
    return d


def config1(pp_cls):
    pp = pp_cls()
    pp.raw.bayer.method = "bilinear"
    return pp


def segments(data):
    """(marker, payload) of each segment before the scan, and the scan
    with its SOS header."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack_from(">H", data, pos + 2)[0]
        out.append((data[pos + 1], data[pos + 4: pos + 2 + n]))
        pos += 2 + n
    return out, data[pos:]


def is_exif(marker, payload):
    return marker == 0xE1 and payload[:6] == b"Exif\0\0"


def exif_tags(tmp_path, name, payload):
    from art_tpu.io.metadata import harvest

    (tmp_path / name).write_bytes(payload[6:])
    return harvest(str(tmp_path / name))[0]


def check_u8(ours, ref):
    assert ours.dtype == ref.dtype == np.uint8
    assert ours.shape == ref.shape
    d = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    print("u8 max", d.max(), "equal share", (d == 0).mean())
    assert d.max() <= 1
    assert (d == 0).mean() >= 0.999


def check_jpegs(tmp_path, ours_path, ref_path, ours_u8, ref_u8):
    """The files agree: segments, EXIF tags, the scan of the reference's
    pixels, and the decoded pixels of each 8x8 block (4:4:4) whose u8
    pixels agree."""
    from art_tpu_torch.io import jpeg

    ours, ref = open(ours_path, "rb").read(), open(ref_path, "rb").read()
    (segs, scan), (rsegs, rscan) = segments(ours), segments(ref)
    assert [m for m, _ in segs] == [m for m, _ in rsegs]
    for (m, p), (_, rp) in zip(segs, rsegs):
        if is_exif(m, p):
            assert is_exif(m, rp)
            assert exif_tags(tmp_path, "o.tif", p) == \
                exif_tags(tmp_path, "r.tif", rp)
        else:
            assert p == rp, hex(m)
    # the reference's pixels through the port's encoder: the reference's
    # scan, byte for byte
    assert segments(jpeg.encode(ref_u8, 92, 3))[1] == rscan
    a = np.asarray(Image.open(ours_path).convert("RGB"))
    b = np.asarray(Image.open(ref_path).convert("RGB"))
    h, w = ref_u8.shape[:2]
    hb, wb = -(-h // 8), -(-w // 8)
    differ = np.zeros((hb * 8, wb * 8), bool)
    differ[:h, :w] = (ours_u8 != ref_u8).any(-1)
    blocks = differ.reshape(hb, 8, wb, 8).any((1, 3))
    same = ~np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:h, :w]
    np.testing.assert_array_equal(a[same], b[same])
    if not blocks.any():
        assert scan == rscan


@pytest.fixture(scope="module")
def config1_outputs(dng):
    """Both packages' process_image of config 1 to a JPEG: {name: (u8
    array, JPEG path)}."""
    from art_tpu.pipeline.develop import process_image as ref_process
    from art_tpu_torch.pipeline.develop import process_image

    ref = ref_process(str(dng / "c1.dng"), config1(RefProcParams),
                      output_path=str(dng / "ref.jpg"))
    ours = process_image(str(dng / "c1.dng"), config1(ProcParams),
                         output_path=str(dng / "ours.jpg"), device="cpu")
    return {"ours": (ours, dng / "ours.jpg"), "ref": (ref, dng / "ref.jpg")}


def test_config1_process_image_matches_the_reference(config1_outputs,
                                                     tmp_path):
    (ours, ours_jpg), (ref, ref_jpg) = config1_outputs.values()
    assert isinstance(ours, np.ndarray) and ours.shape == (256, 384, 3)
    check_u8(ours, ref)
    check_jpegs(tmp_path, ours_jpg, ref_jpg, ours, ref)


def test_cli_matches_the_reference(dng, config1_outputs, tmp_path,
                                   monkeypatch):
    from art_tpu import cli as ref_cli
    from art_tpu.core import compilecache
    from art_tpu_torch import cli

    # the reference's CLI would point JAX's compile cache elsewhere
    monkeypatch.setattr(compilecache, "enable", lambda *a, **k: True)
    outs = {}
    for name, main in (("ours", lambda a: cli.main(a, device="cpu")),
                       ("ref", ref_cli.main)):
        out = tmp_path / f"{name}.jpg"
        rc = main(["-Y", "-p", str(dng / "bilinear.arp"), "-O", str(out),
                   "-c", str(dng / "c1.dng")])
        assert rc == 0
        outs[name] = out
    # the CLI develops what process_image does: its files are those
    for name, out in outs.items():
        assert out.read_bytes() == config1_outputs[name][1].read_bytes()
    check_jpegs(tmp_path, outs["ours"], outs["ref"],
                config1_outputs["ours"][0], config1_outputs["ref"][0])
    parsed = []
    for path in outs.values():
        for cls in (ProcParams, RefProcParams):
            pp = cls()
            pp.apply_arp_text(open(f"{path}.arp").read())
            parsed.append(dataclasses.asdict(pp))
    assert all(p == parsed[0] for p in parsed)
    assert parsed[0]["raw"]["bayer"]["method"] == "bilinear"


def test_cli_auto_matched_curve_matches_the_reference(tmp_path,
                                                     monkeypatch):
    # the bundled profile on a DNG with a JPEG preview: the curve matched
    # to the preview, the export as the reference's
    from art_tpu import cli as ref_cli
    from art_tpu.core import compilecache
    from art_tpu.pipeline.develop import process_image as ref_process
    from art_tpu_torch import cli
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.pipeline.develop import process_image

    monkeypatch.setattr(compilecache, "enable", lambda *a, **k: True)
    rng = np.random.default_rng(2)
    path = str(tmp_path / "preview.dng")
    write_dng(path, (rng.uniform(0.05, 0.9, (64, 96)) * 16000
                     + 500).astype(np.uint16), black=500, white=16500,
              preview_rgb01=rng.uniform(0, 1, (3, 16, 24)) ** 2)
    arp = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "art_tpu_torch", "data", "profiles",
        "Auto-Matched Curve.arp")
    u8 = {}
    for name, run, cls in (
            ("ours", lambda pp, o: process_image(path, pp, output_path=o,
                                                 device="cpu"), ProcParams),
            ("ref", lambda pp, o: ref_process(path, pp, output_path=o),
             RefProcParams)):
        pp = cls()
        pp.apply_arp_text(open(arp).read())
        u8[name] = run(pp, str(tmp_path / f"{name}-pi.jpg"))
    outs = {}
    for name, main in (("ours", lambda a: cli.main(a, device="cpu")),
                       ("ref", ref_cli.main)):
        outs[name] = tmp_path / f"{name}.jpg"
        assert main(["-Y", "-p", arp, "-O",
                     str(outs[name]), "-c", path]) == 0
        assert outs[name].read_bytes() == (
            tmp_path / f"{name}-pi.jpg").read_bytes()
    d = np.abs(u8["ours"].astype(int) - u8["ref"].astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999
    check_jpegs(tmp_path, outs["ours"], outs["ref"], u8["ours"], u8["ref"])


@pytest.mark.parametrize("args,step", [
    # the fast export is ported, and so are the steps this case refused
    # before (auto white balance, then a histogram-matched curve from a
    # JPEG preview: the id keeps the case's name); auto distortion in its
    # profile, on a file with a JPEG preview, is not
    (["-q", "-p", "{tmp}/autodist.arp", "-c", "{tmp}/preview.dng"],
     "auto distortion"),
    # the gamut warning is ported; a LUT-class proof profile is refused
    # as in the reference
    (["--gamut-warn", "{tmp}/proof.icc"], "gamut_warning_mask_lab"),
], ids=["args0-white balance", "args1-gamut_warning_mask_lab"])
def test_cli_refusals(dng, tmp_path, capsys, args, step):
    from art_tpu_torch import cli
    from art_tpu_torch.io.dngwrite import write_dng

    from chip_smoke import write_lut_icc_out

    (tmp_path / "autodist.arp").write_text("[Distortion]\nEnabled=true\n"
                                           "Auto=true\n")
    write_dng(str(tmp_path / "preview.dng"), np.full((64, 96), 4000,
                                                     np.uint16),
              black=512, white=16383,
              preview_rgb01=np.full((3, 16, 24), 0.5))
    write_lut_icc_out(str(tmp_path / "proof.icc"), grid=3)
    args = [a.replace("{tmp}", str(tmp_path)) for a in args]
    if "-c" not in args:
        args += ["-c", str(dng / "c1.dng")]
    out = tmp_path / "out"
    out.mkdir()
    rc = cli.main(["-Y", "-o", str(out) + os.sep, *args], device="cpu")
    assert rc == 2
    assert step in capsys.readouterr().err
    assert not list(out.glob("*.jpg"))


def test_cli_refuses_check_lut_and_non_raw(tmp_path, capsys, monkeypatch):
    from art_tpu import cli as ref_cli
    from art_tpu.core import compilecache
    from art_tpu_torch import cli
    from art_tpu_torch.io.imagefile import write_png

    # a Hald CLUT image loads through the port's decoder: a PNG
    # signature and nothing after it is no LUT, as in the reference
    (tmp_path / "hald.png").write_bytes(b"\x89PNG\r\n\x1a\n")
    assert cli.main(["--check-lut", str(tmp_path / "hald.png")]) == 1
    assert "Invalid LUT file" in capsys.readouterr().out
    # a non-raw input loads as in the reference, whose plan then fails on
    # it (develop.py:715); the port refuses it by name: exit 2 in both,
    # no file written
    write_png(str(tmp_path / "photo.png"), np.full((8, 12, 3), 90, np.uint8))
    monkeypatch.setattr(compilecache, "enable", lambda *a, **k: True)
    for name, main in (("ours", lambda a: cli.main(a, device="cpu")),
                       ("ref", ref_cli.main)):
        out = tmp_path / name
        out.mkdir()
        rc = main(["-Y", "-o", str(out) + os.sep, "-c",
                   str(tmp_path / "photo.png")])
        assert rc == 2 and not os.listdir(out)
        err = capsys.readouterr().err
        assert "error processing" in err
        if name == "ours":
            assert "non-raw input" in err


def test_flagship_u8_equals_the_cast_of_the_float_develop(tmp_path):
    from art_tpu_torch.core.image import synthesize_bayer
    from art_tpu_torch.pipeline import develop as tdev
    from art_tpu_torch.pipeline.autos import auto_chroma_params
    from art_tpu_torch.pipeline.listeners import PipelineListener

    rgb = np.random.default_rng(0).uniform(0.02, 0.95, (3, 256, 1024))
    frame = synthesize_bayer(rgb.astype(np.float32), pattern="RGGB")
    pp = ProcParams()
    pp.apply_arp_text(open(ARP).read())
    pp.raw.bayer.method = "bilinear"
    pp.denoise.enabled = True
    pp.denoise.luminance = 20.0
    pp.denoise.chrominance = 20.0
    config, _ = tdev.plan(frame, pp, out_u8=True)
    assert config.out_u8 and tdev.fusion_gates(config) == (True, True)

    class Listener(PipelineListener):
        def __init__(self):
            self.seen = {}

        def image_type_changed(self, *flags):
            self.seen["type"] = flags

        def auto_chroma_changed(self, *values):
            self.seen["chroma"] = values

    listener = Listener()
    out = tdev.process_image(frame, pp, output_path=str(tmp_path / "f.jpg"),
                             listener=listener, device="cpu")
    flt = tdev.develop(frame, pp, device="cpu")
    cast = (torch.clamp(flt, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    np.testing.assert_array_equal(out, cast.permute(1, 2, 0).numpy())
    assert listener.seen["type"] == (True, True, False, False)
    assert listener.seen["chroma"] == tuple(
        float(v) for v in auto_chroma_params(frame, pp))
    decoded = np.asarray(Image.open(tmp_path / "f.jpg"))
    assert decoded.shape == (256, 1024, 3)


def test_process_image_refusals(dng, tmp_path):
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.io.imagefile import write_png
    from art_tpu_torch.pipeline.develop import process_image
    from art_tpu_torch.pipeline.listeners import PipelineListener

    class Wants(PipelineListener):
        def histogram_changed(self, hist_rgbl):
            pass

    # auto white balance and a histogram listener are ported since
    # (tests/test_torch_autos_scopes.py), and so is a histogram-matched
    # curve from a JPEG preview (tests/test_torch_jpegdec.py); the
    # refusals held here are steps still unported. The fast export is
    # ported: with auto distortion on a file with a JPEG preview, its step
    # is refused; a non-raw input loads and is refused in the plan, where
    # the reference's fails (tests/test_torch_entry.py), before any
    # listener is fed
    preview = str(tmp_path / "preview.dng")
    write_dng(preview, np.full((64, 96), 4000, np.uint16), black=512,
              white=16383, preview_rgb01=np.full((3, 16, 24), 0.5))
    png = str(tmp_path / "in.png")
    write_png(png, np.full((16, 24, 3), 128, np.uint8))
    fast = config1(ProcParams)
    fast.resize.enabled = True
    fast.apply_arp_text("[Distortion]\nEnabled=true\nAuto=true\n")
    for path, pp, kw, step in (
            (preview, fast, dict(fast=True), "auto distortion"),
            (png, config1(ProcParams), dict(listener=Wants()),
             "non-raw input")):
        with pytest.raises(NotImplementedError, match=step):
            process_image(path, pp, device="cpu", **kw)


def test_options_and_profiles_read_as_the_reference(tmp_path):
    from art_tpu.options import Options as RefOptions
    from art_tpu.params import KeyFile as RefKeyFile
    from art_tpu.profiles import get_store as ref_store
    from art_tpu_torch.options import Options
    from art_tpu_torch.params import KeyFile
    from art_tpu_torch.profiles import get_store

    text = ("[General]\nVerbose=true\n[Profiles]\nRawDefault=Punchy\n"
            "[Output]\nFormat=PNG\nJpegQuality=85\nPngBps=16\n"
            "[Fast Export]\nMaxWidth=1000\n"
            "[File Browser]\nParseExtensions=dng;NEF;\n")
    ours = Options.from_keyfile(KeyFile.parse(text))
    ref = RefOptions.from_keyfile(RefKeyFile.parse(text))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.format, ours.png_bits, ours.parse_extensions) == \
        ("png", 16, ("dng", "nef"))
    names = sorted(get_store().list_profiles())
    assert names == sorted(ref_store().list_profiles())
    assert "Standard Film Curve" in names
    assert os.path.basename(get_store().resolve("Punchy")) == "Punchy.arp"
