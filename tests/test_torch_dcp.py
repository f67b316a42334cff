"""DCP camera profiles and temperature white balance in art_tpu_torch
against `art_tpu` on the CPU.

- The temperature model (`raw/wb.py`: temp2mulxyz, temp2mul, mul2temp),
  float64 numpy copied from the reference: rtol 1e-12.
- `load_dcp` of P1's profile (chip_smoke.write_dcp: dual illuminant,
  forward matrices, a 90x30x1 HueSatMap a illuminant, a 36x8x16
  sRGB-encoded look table, a tone curve, a baseline exposure offset):
  every field equal. `plan_dcp` at temperatures below, between and above
  the illuminants, with each ICM gate off, and for a profile with one
  illuminant and no forward matrix: the matrices within rtol 1e-12, the
  tables and the static parts equal.
- `apply_dcp` (step 1) and `apply_dcp_look` (step 2) on seeded values
  (negative and over-range ones among them), with linear and sRGB value
  encodings and one or several value levels: within 1.0 of 65535. The
  sRGB encode that indexes a table's value axis rounds as the
  reference's at the knots of P1's look table (the index it truncates
  to is the same).
- P1's settings (WB Custom at 5200 K, the DCP with its look late, a v4
  matrix/para output profile) at 96x160 bilinear: the port plans the
  reference's plan, and the reference's plan developed through the port
  agrees with the reference's develop within the slice bounds (max <= 1
  LSB8, mean <= 2e-4, >= 99.9% within 1 LSB8); the early look plans as
  the reference's.
- `Custom`/`CustomTemp` WB plans as the reference's; so does a
  histogram-matched curve on a file with a JPEG preview.
"""

import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.color import dcp as rdcp
from art_tpu.params import ProcParams as RefProcParams
from art_tpu.raw import wb as rwb
from art_tpu_torch.color import dcp
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev
from art_tpu_torch.raw import wb
from chip_smoke import (LOOK_DIMS, flagship_frame, p1_arp, parity,
                        profile_files, profile_pp, write_dcp)
from tests.test_torch_plan import Develops, assert_plans_equal, plan_key

jdev = importlib.import_module("art_tpu.pipeline.develop")

H, W = 96, 160


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return profile_files(str(tmp_path_factory.mktemp("profiles")), level=2)


@pytest.fixture(scope="module")
def develops(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    return Develops(root / "profile_develops")


@pytest.mark.parametrize("temp", [1500.0, 2856.0, 4000.0, 4001.0, 5200.0,
                                  6504.0, 7000.0, 7001.0, 25000.0, 40000.0])
@pytest.mark.parametrize("green,equal", [(1.0, 1.0), (0.8, 1.0),
                                         (1.3, 0.9)])
def test_temperature_model_matches_reference(temp, green, equal):
    np.testing.assert_allclose(wb.temp2mulxyz(temp), rwb.temp2mulxyz(temp),
                               rtol=1e-12)
    mul = wb.temp2mul(temp, green, equal)
    np.testing.assert_allclose(mul, rwb.temp2mul(temp, green, equal),
                               rtol=1e-12)
    t, g = wb.mul2temp(*mul, equal=equal)
    rt, rg = rwb.mul2temp(*mul, equal=equal)
    np.testing.assert_allclose([t, g], [rt, rg], rtol=1e-12)


def _profiles_equal(ours, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_load_dcp_matches_reference(files):
    ours, ref = dcp.load_dcp(files["dcp"]), rdcp.load_dcp(files["dcp"])
    _profiles_equal(ours, ref)
    assert ours.hsm_dims == (90, 30, 1) and ours.look_dims == LOOK_DIMS
    assert ours.look_srgb_encoding and ours.baseline_exposure_offset == 0.35


def _icm(**flags):
    pp = ProcParams()
    for k, v in flags.items():
        setattr(pp.icm, k, v)
    return pp.icm


@pytest.mark.parametrize("temp", [2000.0, 4000.0, 5200.0, 9000.0])
@pytest.mark.parametrize("flags", [
    {}, {"apply_hue_sat_map": False}, {"apply_look_table": False},
    {"tone_curve": False}, {"apply_baseline_exposure": False},
    {"apply_look_table": False, "tone_curve": False,
     "apply_baseline_exposure": False}],
    ids=["all", "no-hsm", "no-look", "no-curve", "no-exposure", "no-step2"])
def test_plan_dcp_matches_reference(files, temp, flags):
    from art_tpu_torch.color import colorspaces as cs

    frame = flagship_frame(16, 16)
    inv = cs.MATRICES_XYZ_TO_RGB["Rec2020"]
    ours = dcp.plan_dcp(dcp.load_dcp(files["dcp"]), frame, temp, inv,
                        icm=_icm(**flags))
    ref = rdcp.plan_dcp(rdcp.load_dcp(files["dcp"]), frame, temp, inv,
                        icm=_icm(**flags))
    assert ours[0] == ref[0] and ours[1] == ref[1]
    assert sorted(ours[2]) == sorted(ref[2])
    for k, v in ref[2].items():
        assert ours[2][k].dtype == v.dtype, k
        np.testing.assert_allclose(ours[2][k], v, rtol=1e-12, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("forward", [True, False], ids=["fm", "cm-only"])
def test_plan_dcp_one_illuminant(tmp_path, forward):
    from art_tpu_torch.color import colorspaces as cs

    path = str(tmp_path / "one.dcp")
    write_dcp(path, seed=3, dual=False, forward=forward)
    frame = flagship_frame(16, 16)
    inv = cs.MATRICES_XYZ_TO_RGB["ProPhoto"]
    ours = dcp.plan_dcp(dcp.load_dcp(path), frame, 4500.0, inv)
    ref = rdcp.plan_dcp(rdcp.load_dcp(path), frame, 4500.0, inv)
    assert ours[:2] == ref[:2]
    for k, v in ref[2].items():
        np.testing.assert_allclose(ours[2][k], v, rtol=1e-12, atol=0,
                                   err_msg=k)


def _values(seed, n=4096):
    """Seeded (3, n) ProPhoto-like values in 0..65535: greys, saturated
    and dark colours, a few negative and over-range channels."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (3, n)) ** 1.5
    x[:, : n // 8] = x[0, : n // 8]  # greys
    x[:, n // 8 : n // 4] *= rng.uniform(0.0, 0.05, n // 8)  # dark
    x[rng.integers(0, 3, 64), rng.integers(0, n, 64)] = -0.02
    x[rng.integers(0, 3, 64), rng.integers(0, n, 64)] = 1.3
    return (x * 65535.0).astype(np.float32)


def _tables(seed, dims):
    rng = np.random.default_rng(seed)
    hd, sd, vd = dims
    t = np.empty((vd, hd, sd, 3), np.float32)
    t[..., 0] = rng.uniform(-8.0, 8.0, (vd, hd, sd))
    t[..., 1] = rng.uniform(0.8, 1.2, (vd, hd, sd))
    t[..., 2] = rng.uniform(0.9, 1.1, (vd, hd, sd))
    return t


@pytest.mark.parametrize("dims,srgb", [((90, 30, 1), False),
                                       ((36, 8, 16), True),
                                       ((36, 8, 16), False),
                                       ((6, 2, 2), True)])
def test_apply_dcp_matches_reference(dims, srgb):
    rng = np.random.default_rng(1)
    data = {"dcp_cam2pro": rng.uniform(-0.1, 0.9, (3, 3)).astype(np.float32),
            "dcp_pro2work": rng.uniform(-0.1, 0.9, (3, 3)).astype(
                np.float32),
            "dcp_hsm": _tables(2, dims)}
    static = (True, dims, srgb)
    x = _values(3)
    ours = dcp.apply_dcp(torch.from_numpy(x), {
        k: torch.from_numpy(v) for k, v in data.items()}, static).numpy()
    ref = np.asarray(rdcp.apply_dcp(jnp.asarray(x), {
        k: jnp.asarray(v) for k, v in data.items()}, static))
    d = np.abs(ours - ref).max()
    print(dims, srgb, "max", d)
    assert d <= 1.0


@pytest.mark.parametrize("static", [
    (2.0 ** 0.35, True, LOOK_DIMS, True, True),
    (1.0, True, (36, 8, 1), False, False),
    (1.0, False, None, False, True),
    (1.5, False, None, False, False)], ids=["look-curve-exposure",
                                            "look-2d", "curve", "exposure"])
def test_apply_dcp_look_matches_reference(static):
    from art_tpu_torch.core.curve1d import fit_curve

    rng = np.random.default_rng(4)
    pro2work = rng.uniform(-0.1, 0.9, (3, 3)) + np.eye(3)
    xs = np.linspace(0.0, 1.0, 4096)
    data = {"dcp_pro2work": pro2work.astype(np.float32),
            "dcp_work2pro": np.linalg.inv(pro2work).astype(np.float32),
            "dcp_tc": fit_curve(xs + 0.1 * np.sin(np.pi * xs) * (1 - xs))}
    if static[1]:
        data["dcp_look"] = _tables(5, static[2])
    x = _values(6)
    ours = dcp.apply_dcp_look(torch.from_numpy(x), {
        k: torch.from_numpy(v) for k, v in data.items()}, static).numpy()
    ref = np.asarray(rdcp.apply_dcp_look(jnp.asarray(x), {
        k: jnp.asarray(v) for k, v in data.items()}, static))
    d = np.abs(ours - ref).max()
    print(static, "max", d)
    assert d <= 1.0


def test_srgb_encode_matches_xla_at_the_value_knots():
    # the values whose sRGB encode lands on a knot of a 16-level value
    # axis (k / 15), and the 8 float32 neighbours on each side: the port's
    # encode (a float64 power rounded to float32) truncates to the
    # reference's index, and differs from XLA's float32 power by at most
    # one ulp
    vd = LOOK_DIMS[2]
    knots = np.arange(1, vd - 1) / (vd - 1)
    lin = np.where(knots <= 0.04045, knots / 12.92,
                   ((knots + 0.055) / 1.055) ** 2.4).astype(np.float32)
    v = np.concatenate([lin + np.float32(0)] + [
        np.nextafter(lin, np.float32(s * np.inf), dtype=np.float32)
        for s in (-1, 1)])
    for _ in range(7):
        v = np.unique(np.concatenate([
            v, np.nextafter(v, np.float32(np.inf)),
            np.nextafter(v, np.float32(-np.inf))])).astype(np.float32)
    ours = dcp._srgb_enc(torch.from_numpy(v)).numpy()
    ref = np.asarray(rdcp._srgb_enc(jnp.asarray(v)))
    ulps = np.abs(ours.view(np.int32) - ref.view(np.int32))
    assert ulps.max() <= 1, ulps.max()
    idx = (ours * np.float32(vd - 1)).astype(np.int32)
    ref_idx = (ref * np.float32(vd - 1)).astype(np.int32)
    print("knot values", v.size, "ulps off", int((ulps > 0).sum()),
          "index flips", int((idx != ref_idx).sum()))
    np.testing.assert_array_equal(idx, ref_idx)


def _p1_pps(files, early=False):
    arp = p1_arp(files) + f"DCPLookEarly={str(early).lower()}\n"
    pps = [profile_pp(arp, cls()) for cls in (ProcParams, RefProcParams)]
    for pp in pps:
        pp.raw.bayer.method = "bilinear"
    return pps


def test_p1_develops_as_the_reference(files, develops):
    frame = flagship_frame(H, W, seed=5)
    pp, ref_pp = _p1_pps(files)
    ours = tdev.plan(frame, pp, device="cpu")
    ref_cfg, ref_data = jdev.plan(frame, ref_pp)
    assert_plans_equal(ours, (ref_cfg, ref_data))
    assert [s[0] for s in ref_cfg.steps] == ["denoise", "dcplook_late",
                                             "tonecurve"]
    assert ref_cfg.dcp == (True, (90, 30, 1), False)
    assert ref_cfg.out_trc[0] == "para"
    # a DCP shuts the raw head's fusion, a para TRC the output tail's
    assert tdev.fusion_gates(ref_cfg) == (False, False)
    out = develops.get("port-refplan", plan_key(ref_cfg, ref_data), lambda:
                       tdev.crop_result(tdev.build_run(ref_cfg)(
                           tdev.upload(frame, "cpu"),
                           tdev.data_to_torch(ref_data, "cpu")),
                           ref_cfg).numpy())
    ref = develops.get("ref", plan_key(ref_cfg, ref_data),
                       lambda: jdev.develop(frame, ref_pp))
    st = parity(out, ref)
    print("P1", st)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st
    # the profile moves the picture: not the flagship's output
    flag = tdev.develop(frame, profile_pp("[Color Management]\n"),
                        device="cpu")
    assert parity(out, flag)["mean"] > 1e-3


def test_p1_early_look_plans_as_the_reference(files):
    frame = flagship_frame(32, 48, seed=5)
    pp, ref_pp = _p1_pps(files, early=True)
    ours = tdev.plan(frame, pp, device="cpu")
    ref = jdev.plan(frame, ref_pp)
    assert_plans_equal(ours, ref)
    assert [s[0] for s in ours[0].steps][:2] == ["denoise", "dcplook_early"]


@pytest.mark.parametrize("method", ["Custom", "CustomTemp"])
def test_temperature_wb_plans_as_the_reference(method):
    frame = flagship_frame(32, 48, seed=2)
    pps = [profile_pp("[White Balance]\nEnabled=true\n"
                      f"Setting={method}\nTemperature=3800\nGreen=1.1\n",
                      cls()) for cls in (ProcParams, RefProcParams)]
    assert_plans_equal(tdev.plan(frame, pps[0], device="cpu"),
                       jdev.plan(frame, pps[1]))


def test_auto_wb_stays_refused(tmp_path):
    # auto white balance is ported since (tests/test_torch_autos_scopes.py),
    # and so is the step this test held refused after it: a
    # histogram-matched tone curve on a file with an embedded JPEG preview
    # matches the reference's points (within 1e-6: the two neutral renders
    # differ in float32 rounding), and with those points plans the
    # reference's plan
    from art_tpu.io.rawfile import load_raw as ref_load_raw
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.io.rawfile import load_raw
    from art_tpu_torch.pipeline.listeners import _Collect

    frame = flagship_frame(32, 48)
    path = str(tmp_path / "preview.dng")
    write_dng(path, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, preview_rgb01=np.full((3, 16, 24), 0.5))
    arp = "[ToneCurve]\nHistogramMatching=true\n"
    pp, ref_pp = profile_pp(arp), profile_pp(arp, RefProcParams())
    with _Collect() as report:
        tdev.plan(load_raw(path), pp, device="cpu")
    ref_plan = jdev.plan(ref_load_raw(path), ref_pp)
    assert ref_pp.tone_curve.from_histmatching
    assert not pp.tone_curve.from_histmatching
    points = report["matched_curve"]
    assert len(points) == len(ref_pp.tone_curve.curve)
    assert np.abs(np.subtract(points, ref_pp.tone_curve.curve)).max() \
        <= 1e-6
    pp.tone_curve.enabled = True
    pp.tone_curve.curve = list(ref_pp.tone_curve.curve)
    pp.tone_curve.from_histmatching = True
    assert_plans_equal(tdev.plan(load_raw(path), pp, device="cpu"),
                       ref_plan)
