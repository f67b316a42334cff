"""The host autos and scopes of art_tpu_torch against `art_tpu`, on the
CPU: the grey-world auto white balance (`pipeline/autos.py::
auto_wb_multipliers`) on Bayer, X-Trans and clipped frames, its plan and
the temperature it reports; the four scope functions of
`pipeline/scopes.py` on the same float input; and `process_image`'s
histogram listener, fed after the autos are reported, on the u8 and the
float output.

Tolerances: the multipliers and the reported temperature and green
within rtol 1e-9 (the same float64 numpy, op for op; a mean's summation
order is numpy's on both sides); the plans as tests/test_torch_plan.py
holds them; the scopes' counts equal.
"""

import dataclasses
import importlib

import numpy as np
import pytest

from art_tpu.io.rawfile import RawFrame as RefRawFrame
from art_tpu.params import ProcParams as RefProcParams
from art_tpu.pipeline import autos as rautos
from art_tpu.pipeline import scopes as rscopes
from art_tpu_torch.core.image import MAXVAL, synthesize_xtrans
from art_tpu_torch.io.rawfile import RawFrame
from art_tpu_torch.pipeline import autos, scopes
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import clipped_frame, flagship_frame, m2_pp
from tests.test_torch_plan import assert_plans_equal

jdev = importlib.import_module("art_tpu.pipeline.develop")


def _ref_frame(frame):
    """The reference's RawFrame with the port frame's fields."""
    return RefRawFrame(**{f.name: getattr(frame, f.name)
                          for f in dataclasses.fields(RawFrame)})


def _xtrans(h, w):
    rgb = np.random.default_rng(2).uniform(0.02, 0.95, (3, h, w))
    return synthesize_xtrans(rgb)


def _no_cam_mul(h, w):
    # the multipliers from the matrix's D65 estimate
    return dataclasses.replace(flagship_frame(h, w, seed=3), cam_mul=None)


FRAMES = {"bayer": lambda: flagship_frame(48, 64, seed=1),
          "clipped": lambda: clipped_frame(64, 96, seed=4, share=0.2),
          "xtrans": lambda: _xtrans(48, 72),
          "no-cam-mul": lambda: _no_cam_mul(48, 64)}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_auto_wb_matches_reference(name):
    frame = FRAMES[name]()
    ours = autos.auto_wb_multipliers(frame)
    ref = rautos.auto_wb_multipliers(_ref_frame(frame))
    np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=0)
    if name == "xtrans":
        np.testing.assert_array_equal(ours, np.ones(3))
    else:
        assert abs(ours[0] - 1.0) > 1e-3


def _collect(pkg, fn):
    listeners = importlib.import_module(f"{pkg}.pipeline.listeners")
    with listeners._Collect() as report:
        out = fn()
    return out, report


def test_auto_wb_plans_and_reports_as_the_reference():
    frame = clipped_frame(64, 96, seed=4, share=0.2)
    ours, report = _collect("art_tpu_torch", lambda: tdev.plan(
        frame, m2_pp(), device="cpu"))
    ref, ref_report = _collect("art_tpu", lambda: jdev.plan(
        _ref_frame(frame), m2_pp(RefProcParams())))
    assert_plans_equal(ours, ref)
    np.testing.assert_allclose(report["wb"], ref_report["wb"], rtol=1e-9)
    # not the camera's white balance
    cam, _ = _collect("art_tpu_torch", lambda: tdev.plan(
        frame, m2_pp().__class__(), device="cpu"))
    assert not np.allclose(cam[1]["rgb_mults"], ours[1]["rgb_mults"])


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.05, 1.05, (3, 40, 1100)).astype(np.float32) * MAXVAL
    x[:, :2, :3] = [[[0.0]], [[MAXVAL]], [[MAXVAL / 2]]]
    return x


@pytest.mark.parametrize("fn,kw", [
    ("histogram_rgbl", {}), ("histogram_rgbl", {"bins": 64}),
    ("waveform", {}), ("waveform", {"bins": 32, "max_cols": 100}),
    ("vectorscope", {}), ("vectorscope", {"size": 33})],
    ids=["hist", "hist-64", "waveform", "waveform-32", "vectorscope",
         "vectorscope-33"])
def test_scopes_match_reference(image, fn, kw):
    ours = getattr(scopes, fn)(image, **kw)
    ref = getattr(rscopes, fn)(image, **kw)
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])
            assert ours[k].dtype == ref[k].dtype
    else:
        np.testing.assert_array_equal(ours, ref)
        assert ours.dtype == ref.dtype


@pytest.mark.parametrize("pattern", ["RGGB", "GBRG", None])
def test_raw_histogram_matches_reference(pattern):
    cfa = np.random.default_rng(6).uniform(400, 17000, (30, 50)).astype(
        np.float32)
    kw = dict(bins=128, black=512.0, white=16383.0)
    ours = scopes.raw_histogram(cfa, pattern, **kw)
    ref = rscopes.raw_histogram(cfa, pattern, **kw)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("u8", [True, False], ids=["u8-jpeg", "float"])
def test_histogram_listener_follows_the_reference(tmp_path, u8):
    from art_tpu_torch.pipeline.listeners import PipelineListener

    events = []

    class Wants(PipelineListener):
        def auto_wb_changed(self, temp, green):
            events.append(("wb", temp, green))

        def histogram_changed(self, hist_rgbl):
            events.append(("hist", hist_rgbl))

    frame = clipped_frame(64, 96, seed=4, share=0.2)
    pp = m2_pp()
    pp.raw.bayer.method = "bilinear"
    out = tdev.process_image(
        frame, pp, output_path=str(tmp_path / ("o.jpg" if u8 else "o.tif")),
        listener=Wants(), device="cpu")
    assert [e[0] for e in events] == ["wb", "hist"]
    _, ref_report = _collect("art_tpu", lambda: jdev.plan(
        _ref_frame(frame), m2_pp(RefProcParams())))
    np.testing.assert_allclose(events[0][1:], ref_report["wb"], rtol=1e-9)
    # the reference's branch on the returned output: u8 (H, W, 3) scaled
    # by MAXVAL / 255 after the transpose, float clipped and scaled
    assert (out.dtype == np.uint8) == u8
    full = (out.transpose(2, 0, 1).astype(np.float32) * (MAXVAL / 255.0)
            if u8 else np.clip(out, 0.0, 1.0) * MAXVAL)
    want = rscopes.histogram_rgbl(full)
    got = events[1][1]
    for k in "rgbl":
        np.testing.assert_array_equal(got[k], want[k])
    assert got["g"].sum() == 64 * 96
