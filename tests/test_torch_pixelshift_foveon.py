"""Pixel shift and Foveon frames in art_tpu_torch against `art_tpu`, on
the CPU.

- Pixel shift: `synthesize_pixelshift` equal to the reference's; the
  4-frame combine exact on a static scene (within 1.0 of 65535 of the
  scene, as the reference's own test holds it) and equal to the
  reference's; its motion fallback (a block that moved after frame 0)
  with RCD and with AMaZE at gain 1, within 0.05 of the reference's
  (measured: equal); the motion mask's 3x3 OR equal to
  `lax.reduce_window` at the borders; the plan with three extra frames
  (their padded planes equal) and with none, which plans AMaZE (C6, also
  outside fast export); a develop at 96x160 with a moved patch within
  the slice bounds (max <= 1/255, mean <= 2e-4, >= 99.9% within 1 LSB8;
  measured under 0.001 LSB8).
- Foveon: `scale_plan_foveon` equal to the reference's; an X3F written by
  `tests/util_x3f.write_x3f` read by each package's own `load_raw`, its
  plan equal (method "foveon", no CFA step, camera WB under Auto), its
  u16 planes through `host_input`/`device_input` bit for bit, and its
  develop (the flagship profile, denoise 20/20) within the slice bounds
  (measured: 0.004 LSB8); through `process_image` and `cli.main` of both
  packages, the u8 outputs max <= 1 and >= 99.9% equal and each CLI's
  JPEG the bytes of its `process_image`.
- A 2-D frame with neither a Bayer pattern nor an X-Trans matrix (a
  monochrome sensor) is refused by both: the port by name, the reference
  with an AssertionError in its bilinear fallback.
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from art_tpu.demosaic import registry as ref_registry
from art_tpu.params import ProcParams
from art_tpu_torch.core.image import synthesize_bayer
from art_tpu_torch.demosaic import pixelshift as tps
from art_tpu_torch.io import rawfile as traw
from art_tpu_torch.pipeline import develop as tdev
from art_tpu_torch.raw import preprocess as tpre
from chip_smoke import parity
from test_torch_process_image import check_u8
from util_x3f import write_x3f

# the reference's registry fills itself only while it is empty
ref_registry.get("amaze")
from art_tpu.demosaic import pixelshift as rps  # noqa: E402
from art_tpu.io import rawfile as rraw  # noqa: E402
from art_tpu.raw import preprocess as rpre  # noqa: E402

jdev = importlib.import_module("art_tpu.pipeline.develop")


def smooth_scene(h, w, seed):
    """A smooth linear [0, 1] scene (ramps and a soft blob) from a seed."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 1, h)[:, None]
    xx = np.linspace(0, 1, w)[None, :]
    out = []
    for c in range(3):
        a, b, cx, cy = rng.uniform(0.1, 0.6, 4)
        blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 0.05)
        out.append(0.05 + a * xx + b * yy * 0.5 + 0.3 * blob)
    return np.clip(np.stack(out), 0.0, 1.0)


def test_synthesize_pixelshift_matches_reference():
    rgb = smooth_scene(40, 60, 1)
    ours, ref = traw.synthesize_pixelshift(rgb), rraw.synthesize_pixelshift(
        rgb)
    np.testing.assert_array_equal(ours.cfa, ref.cfa)
    np.testing.assert_array_equal(ours.extra_frames, ref.extra_frames)
    assert (ours.pattern, ours.make, ours.model) == (ref.pattern, ref.make,
                                                     ref.model)
    assert tps.OFFSETS == rps.OFFSETS


def _frames(rgb, moved=None):
    fr = traw.synthesize_pixelshift(rgb, black=0.0, white=65535.0,
                                    cam_mul=(1.0, 1.0, 1.0))
    frames = np.concatenate([fr.cfa[None], fr.extra_frames])
    if moved is not None:  # an object that moved after frame 0
        frames[(slice(1, None),) + moved] *= 0.2
    return frames


def test_combine_is_exact_on_a_static_scene():
    rgb = smooth_scene(64, 96, 5)
    frames = _frames(rgb)
    out = tps.pixelshift_combine(torch.from_numpy(frames), "RGGB",
                                 motion_detect=False).numpy()
    np.testing.assert_allclose(out, rgb * 65535.0, rtol=0, atol=1.0)
    ref = np.asarray(rps.pixelshift_combine(jnp.asarray(frames), "RGGB",
                                            motion_detect=False))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("method", ["rcd", "amaze"])
def test_motion_fallback_matches_reference(method):
    rgb = smooth_scene(64, 96, 6)
    frames = _frames(rgb, (slice(30, 50), slice(40, 60)))
    out = tps.pixelshift_combine(torch.from_numpy(frames), "RGGB",
                                 demosaic_method=method).numpy()
    naive = tps.pixelshift_combine(torch.from_numpy(frames), "RGGB",
                                   motion_detect=False).numpy()
    with jax.disable_jit():
        ref = np.asarray(rps.pixelshift_combine(
            jnp.asarray(frames), "RGGB", demosaic_method=method))
    np.testing.assert_allclose(out, ref, rtol=0, atol=0.05)
    # in the moved block the output follows frame 0's demosaic, where
    # the naive combine mixes the darkened frames
    blk = (slice(None), slice(34, 46), slice(44, 56))
    truth = rgb * 65535.0
    assert np.abs(out[blk] - truth[blk]).mean() < 0.5 * np.abs(
        naive[blk] - truth[blk]).mean()


def test_motion_mask_is_the_references_window_or():
    rng = np.random.default_rng(8)
    g_min = rng.uniform(0, 4000, (33, 47)).astype(np.float32)
    g_max = g_min + rng.uniform(0, 700, (33, 47)).astype(np.float32)
    ours = tps.motion_mask(torch.from_numpy(g_min), torch.from_numpy(g_max),
                           0.08).numpy()
    denom = np.maximum(g_max + g_min, 1.0)
    raw = jnp.asarray((g_max - g_min) > 0.08 * denom + 16.0)
    ref = np.asarray(lax.reduce_window(raw, False, lax.bitwise_or, (3, 3),
                                       (1, 1), "SAME"))
    assert 0 < ours.sum() < ours.size
    np.testing.assert_array_equal(ours, ref)


@pytest.fixture(scope="module")
def ps_scene():
    return smooth_scene(96, 160, 9)


def _ps_frame(package, rgb):
    fr = package.synthesize_pixelshift(rgb)
    fr.extra_frames[:, 40:60, 60:90] *= 0.5  # a patch that moved
    return fr


def test_plan_with_three_extra_frames_matches_reference(ps_scene):
    pp = ProcParams()
    pp.raw.bayer.method = "pixelshift"
    cfg, data = tdev.plan(_ps_frame(traw, ps_scene), pp, device="cpu")
    ref_cfg, ref_data = jdev.plan(_ps_frame(rraw, ps_scene), pp)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.pixelshift and cfg.demosaic_method == "pixelshift"
    np.testing.assert_array_equal(data["ps_frames"], ref_data["ps_frames"])
    assert data["ps_frames"].shape == (3, 128, 256)
    fuse_head, _ = tdev.fusion_gates(cfg)
    assert not fuse_head  # pixel shift shuts the raw head's fusion


@pytest.mark.parametrize("fast", [False, True], ids=["develop", "fast"])
def test_pixelshift_on_one_frame_plans_amaze(ps_scene, fast):
    # C6: a single-frame file with Method=pixelshift develops with AMaZE,
    # as the reference's (develop.py:131-139), on every path
    pp = ProcParams()
    pp.raw.bayer.method = "pixelshift"
    pp.resize.enabled = fast
    frame = synthesize_bayer(ps_scene.astype(np.float32))
    cfg, _ = tdev.plan(frame, pp, fast=fast, device="cpu")
    ref_cfg, _ = jdev.plan(frame, pp, fast=fast)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.demosaic_method == "amaze" and not cfg.pixelshift
    tdev.build_run(cfg)


def test_pixelshift_develop_matches_reference(ps_scene):
    pp = ProcParams()
    pp.raw.bayer.method = "pixelshift"
    frame = _ps_frame(traw, ps_scene)
    masks = []
    mask = tps.motion_mask

    def recorded(*args):
        masks.append(mask(*args))
        return masks[-1]

    tps.motion_mask = recorded
    try:
        out = tdev.develop(frame, pp, device="cpu").numpy()
    finally:
        tps.motion_mask = mask
    # the moved patch takes the AMaZE fallback, the rest the combine
    share = float(masks[0].double().mean())
    assert len(masks) == 1 and 0.02 < share < 0.2, share
    ref = np.asarray(jdev.develop(_ps_frame(rraw, ps_scene), pp))
    st = parity(out, ref)
    print("pixel shift develop", st)
    assert out.shape == (3, 96, 160)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st


def _x3f_planes(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(400, 3800, size=(3, 1, 1))
    dy = rng.integers(-200, 201, size=(3, h, 1))
    dx = rng.integers(-200, 201, size=(3, 1, w))
    return np.clip(base + dy + dx, 0, 4095).astype(np.int64)


@pytest.fixture(scope="module")
def x3f(tmp_path_factory):
    d = tmp_path_factory.mktemp("foveon")
    write_x3f(d / "f.x3f", _x3f_planes(96, 160, 5), fmt=30,
              model="DP2 Merrill")
    (d / "denoise.arp").write_text(
        "[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n")
    return d


def test_scale_plan_foveon_matches_reference(x3f):
    frame = traw.load_raw(str(x3f / "f.x3f"))
    for expos, wb in ((1.0, None), (1.7, (1.9, 1.0, 1.4))):
        a = tpre.scale_plan_foveon(frame, expos, wb)
        b = rpre.scale_plan_foveon(frame, expos, wb)
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("wb", ["Camera", "Auto"])
def test_foveon_plan_matches_reference(x3f, wb):
    # no CFA step is planned for a Foveon frame, whatever the profile
    # asks: auto WB takes the camera's, as in the reference
    frame = traw.load_raw(str(x3f / "f.x3f"))
    ref_frame = rraw.load_raw(str(x3f / "f.x3f"))
    assert frame.cfa.shape == (3, 96, 160) and frame.pattern is None
    np.testing.assert_array_equal(frame.cfa, ref_frame.cfa)
    pp = ProcParams()
    pp.wb.method = wb
    pp.raw.hotdead_enabled = True
    pp.raw.hotpixel_filter = True
    pp.exposure.hrmode = "Blend"
    cfg, data = tdev.plan(frame, pp, device="cpu")
    ref_cfg, ref_data = jdev.plan(ref_frame, pp)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.demosaic_method == "foveon" and cfg.hl_mode == "Off"
    for k in ("raw_offset", "raw_scale", "rgb_mults", "init_gain",
              "cam2work"):
        np.testing.assert_array_equal(data[k], ref_data[k], err_msg=k)
    assert data["raw_offset"].shape == (3, 1, 1)


def test_foveon_planes_reach_the_device_bit_for_bit(x3f):
    frame = traw.load_raw(str(x3f / "f.x3f"))
    host = tdev.host_input(frame)
    assert host.dtype == np.int16 and host.shape == (3, 128, 256)
    dev = tdev.device_input(host, "cpu", tdev.PinnedBuffer()
                            if torch.cuda.is_available() else None)
    np.testing.assert_array_equal(dev[:, :96, :160].numpy(), frame.cfa)


@pytest.fixture(scope="module")
def foveon_outputs(x3f, tmp_path_factory):
    """Both packages' process_image of the X3F (the flagship profile
    with denoise 20/20) to a JPEG, and their CLIs'."""
    from art_tpu import cli as ref_cli
    from art_tpu.core import compilecache
    from art_tpu.params import ProcParams as RefPP
    from art_tpu.pipeline.develop import process_image as ref_process
    from art_tpu_torch import cli
    from art_tpu_torch.params import ProcParams as PortPP

    d = tmp_path_factory.mktemp("foveon_out")
    arp = (x3f / "denoise.arp").read_text()
    outs = {}
    for name, cls, process, main in (
            ("ours", PortPP, lambda *a, **k: tdev.process_image(
                *a, device="cpu", **k),
             lambda a: cli.main(a, device="cpu")),
            ("ref", RefPP, ref_process, ref_cli.main)):
        pp = cls()
        pp.apply_arp_text(arp)
        u8 = process(str(x3f / "f.x3f"), pp,
                     output_path=str(d / f"{name}.jpg"))
        mp = pytest.MonkeyPatch()
        # the reference's CLI would point JAX's compile cache elsewhere
        mp.setattr(compilecache, "enable", lambda *a, **k: True)
        try:
            rc = main(["-Y", "-p", str(x3f / "denoise.arp"), "-o",
                       str(d / f"{name}-cli.jpg"), "-c",
                       str(x3f / "f.x3f")])
        finally:
            mp.undo()
        assert rc == 0
        outs[name] = (u8, d / f"{name}.jpg", d / f"{name}-cli.jpg")
    return outs


def test_foveon_develop_matches_reference(x3f):
    pp = ProcParams()
    pp.apply_arp_text((x3f / "denoise.arp").read_text())
    out = tdev.develop(traw.load_raw(str(x3f / "f.x3f")), pp,
                       device="cpu").numpy()
    ref = np.asarray(jdev.develop(rraw.load_raw(str(x3f / "f.x3f")), pp))
    st = parity(out, ref)
    print("foveon develop", st)
    assert out.shape == (3, 96, 160)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st


def test_foveon_through_process_image_and_the_cli(foveon_outputs):
    (ours, ours_jpg, ours_cli), (ref, ref_jpg, ref_cli) = \
        foveon_outputs.values()
    assert ours.shape == (96, 160, 3)
    check_u8(ours, ref)
    for jpg, cli_jpg in ((ours_jpg, ours_cli), (ref_jpg, ref_cli)):
        data = cli_jpg.read_bytes()
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
        assert data == jpg.read_bytes()


def test_monochrome_frame_without_cfa_is_refused_by_both():
    mono = traw.RawFrame(cfa=np.full((64, 96), 2000.0, np.float32),
                         pattern=None)
    with pytest.raises(NotImplementedError, match="monochrome raw with no "
                                                  "CFA"):
        tdev.plan(mono, ProcParams(), device="cpu")
    ref_mono = rraw.RawFrame(cfa=mono.cfa, pattern=None)
    with pytest.raises(AssertionError):
        jdev.develop(ref_mono, ProcParams())
