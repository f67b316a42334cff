"""External LUT generators and the gamut warning in art_tpu_torch against
`art_tpu` on the CPU.

- P3's generator (chip_smoke.write_extlut: a Python script run with this
  interpreter) one-shot and as a server: the configs parse alike, each
  request writes the reference's .cube (the same table, bit for bit),
  a second request with the same values hits the disk cache, the
  server answers several requests from one child, and `close` kills
  and reaps it; `get_external_lut` gives the reference's table.
- `paint_gamut_warning` of seeded encoded images for named and ICC
  output profiles against named and ICC proof profiles: the same mask,
  the painted image within 1e-6.
- `process_image` with a gamut warning (16x16 patches of random colours,
  ProPhoto out, a matrix .icc proof of a small gamut) at 96x160
  bilinear: the image is the develop painted where
  `paint_gamut_warning` marks it, and against the reference's develop
  painted by the reference, the marks differ at no more than 0.1% of
  the pixels, and beyond them the slice bounds hold (max <= 1 LSB8,
  mean <= 2e-4, >= 99.9% within 1 LSB8); the CLI exits 0.
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.color import extclut as rextclut
from art_tpu.color import gamutwarning as rgamut
from art_tpu.params import ProcParams as RefProcParams
from art_tpu_torch.color import extclut, gamutwarning
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import (flip_parity, profile_pp,
                        write_extlut, write_para_icc)
from tests.test_torch_plan import Develops, plan_key

jdev = importlib.import_module("art_tpu.pipeline.develop")


@pytest.mark.parametrize("server", [False, True], ids=["oneshot", "server"])
def test_generator_writes_the_reference_cube(tmp_path, server):
    from art_tpu_torch.color.lut3d import load_cube

    cfg = write_extlut(str(tmp_path), server=server)
    ours, ref = extclut.ExternalLUT3D(cfg), rextclut.ExternalLUT3D(cfg)
    try:
        assert ours.ok and ours.server == server
        for attr in ("command", "params", "label", "workdir"):
            assert getattr(ours, attr) == getattr(ref, attr), attr
        assert ours.default_values() == ref.default_values()
        for values in ({"saturation": 1.3}, {"gamma": 0.8},
                       {"saturation": 1.3}):
            got, want = ours.generate(values), ref.generate(values)
            assert got != want  # the port's cache lies apart
            np.testing.assert_array_equal(load_cube(got)[0],
                                          load_cube(want)[0])
        proc = ours._proc
        assert (proc is not None) == server
    finally:
        ours.close()
        ref.close()
    if server:
        assert proc.returncode is not None  # killed and reaped
        assert ours._proc is None
    got = extclut.get_external_lut(cfg, {"saturation": 0.5})
    want = rextclut.get_external_lut(cfg, {"saturation": 0.5})
    np.testing.assert_array_equal(got, want)
    extclut._cache.pop(cfg).close()
    rextclut._cache.pop(cfg).close()


@pytest.fixture(scope="module")
def icc(tmp_path_factory):
    d = tmp_path_factory.mktemp("icc")
    write_para_icc(str(d / "rec709.icc"))
    write_para_icc(str(d / "adobe.icc"), space="Adobe RGB",
                   para=(2.2, 1.0, 0.0, 0.0, 0.0))
    return d


@pytest.mark.parametrize("out", ["sRGB", "ProPhoto", "Rec2020",
                                 "ACESp1", "rec709.icc"])
@pytest.mark.parametrize("proof", ["sRGB", "Adobe RGB", "adobe.icc"])
def test_gamut_mask_matches_reference(icc, out, proof):
    out = str(icc / out) if out.endswith(".icc") else out
    proof = str(icc / proof) if proof.endswith(".icc") else proof
    rng = np.random.default_rng(len(out) + len(proof))
    img = rng.uniform(0.0, 1.0, (3, 48, 64)).astype(np.float32)
    img[:, :8] = img[:, :8] ** 4  # saturated colours
    painted, mask = gamutwarning.paint_gamut_warning(
        torch.from_numpy(img), out, proof)
    ref_painted, ref_mask = rgamut.paint_gamut_warning(jnp.asarray(img),
                                                       out, proof)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(painted.numpy(), np.asarray(ref_painted),
                               rtol=0, atol=1e-6)
    print(out, proof, "marked", float(mask.double().mean()))


def test_lut_proof_profile_is_refused_as_in_the_reference(tmp_path):
    from chip_smoke import write_lut_icc_out

    write_lut_icc_out(str(tmp_path / "lut.icc"), grid=3)
    img = torch.full((3, 4, 4), 0.5)
    with pytest.raises(ValueError, match="Lab branch"):
        gamutwarning.paint_gamut_warning(img, "sRGB", str(tmp_path /
                                                          "lut.icc"))


@pytest.fixture(scope="module")
def develops(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    return Develops(root / "profile_develops")


def test_gamut_warning_develops_as_the_reference(tmp_path, develops):
    from art_tpu.color.gamutwarning import paint_gamut_warning as ref_paint
    from art_tpu_torch import cli
    from art_tpu_torch.pipeline.develop import process_image

    from art_tpu_torch.core.image import synthesize_bayer

    # patches of 16x16 pixels of one random colour each (the flagship
    # scene's per-pixel colours average to grey in the demosaic)
    cells = np.random.default_rng(5).uniform(0.02, 0.95, (3, 6, 10))
    rgb = np.repeat(np.repeat(cells, 16, axis=1), 16, axis=2)
    frame = synthesize_bayer(rgb.astype(np.float32), pattern="RGGB")
    arp = "[Color Management]\nOutputProfile=RTv4_ProPhoto\n"
    pp, ref_pp = (profile_pp(arp, cls()) for cls in (ProcParams,
                                                     RefProcParams))
    for p in (pp, ref_pp):
        p.raw.bayer.method = "bilinear"
    # a proof of a print's small gamut (sRGB's primaries halfway to the
    # white): a share of the frame's colours falls outside it
    proof = str(tmp_path / "print.icc")
    write_para_icc(proof, space="sRGB", narrow=0.5)
    out = process_image(frame, pp, gamut_warn=proof, device="cpu")
    dev = tdev.develop(frame, pp, device="cpu")
    painted, mask = gamutwarning.paint_gamut_warning(dev, "ProPhoto", proof)
    np.testing.assert_array_equal(out, painted.numpy())
    share = float(mask.double().mean())
    assert 0.01 < share < 0.99, share
    ref_cfg, ref_data = jdev.plan(frame, ref_pp)
    ref_dev = develops.get("ref", plan_key(ref_cfg, ref_data),
                           lambda: jdev.develop(frame, ref_pp))
    ref_out, ref_mask = ref_paint(jnp.asarray(ref_dev), "ProPhoto", proof)
    st = flip_parity(out, np.asarray(ref_out), mask, np.asarray(ref_mask),
                     0)
    print("gamut", share, st)
    assert st["flip_share"] <= 1e-3, st
    assert st["max_lsb8_beyond_flips"] <= 1.0 and st["mean"] <= 2e-4, st
    # through the CLI, to a 16-bit TIFF
    from art_tpu_torch.io.dngwrite import write_dng

    dng = str(tmp_path / "in.dng")
    write_dng(dng, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, compress=False)
    (tmp_path / "p.arp").write_text(arp + "[RAW Bayer]\nMethod=bilinear\n")
    rc = cli.main(["-Y", "-t", "-p", str(tmp_path / "p.arp"),
                   "--gamut-warn", proof, "-o", str(tmp_path / "o.tif"),
                   "-c", dng], device="cpu")
    assert rc == 0 and os.path.getsize(tmp_path / "o.tif") > 0
