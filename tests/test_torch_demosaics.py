"""The Bayer demosaics of art_tpu_torch against `art_tpu`'s, on the CPU:
the ten methods (LMMSE, IGV, VNG4, DCB, AHD, EAHD, HPHD, PPG, JDL and the
dual blend with its six names), the dispatch (mono, none, fast, bilinear,
an unknown name), the planner's method and kwargs for every name, and
small develops (`amazevng4`, `dcb`) against the reference's.

Inputs: the same numpy mosaic from a seed (`test_torch_rcd._mosaic`: ramps,
a hard edge, 2% noise, clipped sites) through both functions, for the
four Bayer patterns, at 64x96 and an odd 71x97. The reference's methods
are not jitted: they run op by op, with no FMA contraction, under
`jax.disable_jit()` all the same.

Bounds, in 65535ths:
- each method: max 0.05, mean 1e-4, and no site beyond 1.0. Measured:
  equal, every method and pattern. The decisions (LMMSE's highlight
  guard, the VNG4/PPG/JDL/HPHD direction picks, the AHD/EAHD votes, the
  DCB map) take the same float32 sums in the same order; the AHD/EAHD
  Lab cube root is `core/fmath.py::cbrt_xla`, XLA's rounding (with the
  port's `cbrt`, 1 ulp off XLA at ~14% of values, EAHD flipped ~0.2% of
  its votes, up to 1725 of 65535). So no site flips at these shapes.
- the dual blend: max 0.05, mean 1e-3 (measured 0.0039 and 4e-4: the
  sigmoid's exp rounds differently in PyTorch and XLA); the automatic
  threshold equal (measured: equal), the no-usable-tile default 0.2 in
  both.
- the develops at 96x160: the slice's, max <= 1/255, mean <= 2e-4,
  >= 99.9% within 1 LSB8 (measured: under 0.001 LSB8).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.demosaic import registry as ref_registry
from art_tpu.params import ProcParams
from art_tpu_torch.core.image import synthesize_bayer
from art_tpu_torch.demosaic import demosaic, dual as tdual, methods
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import parity
from test_torch_plan import Develops, flagship_pp, plan_key
from test_torch_rcd import PATTERNS, _mosaic

# the reference's registry fills itself only while it is empty: let it
# fill before the method modules are imported directly
ref_registry.get("amaze")
from art_tpu.demosaic import demosaic as ref_demosaic  # noqa: E402
from art_tpu.demosaic import dual as rdual  # noqa: E402

jdev = importlib.import_module("art_tpu.pipeline.develop")

METHODS = ["lmmse", "igv", "vng4", "dcb", "ahd", "eahd", "hphd", "ppg",
           "jdl"]
DUALS = ["amazebilinear", "amazevng4", "rcdbilinear", "rcdvng4",
         "dcbbilinear", "dcbvng4"]


def _ref(cfa, pattern, method, **kw):
    with jax.disable_jit():
        return np.asarray(ref_demosaic(jnp.asarray(cfa), pattern, method,
                                       **kw))


def _check(out, ref, atol=0.05, mean=1e-4):
    assert out.shape == ref.shape
    d = np.abs(out.astype(np.float64) - ref)
    assert d.max() <= atol and d.mean() <= mean, (d.max(), d.mean())


@pytest.mark.parametrize("shape", [(64, 96), (71, 97)], ids=["64x96", "odd"])
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("method", METHODS + ["dcb-plain"])
def test_method_matches_reference(method, pattern, shape):
    # dcb-plain: DCB with one iteration and no enhancement
    cfa = _mosaic(shape, 11)
    kw = {}
    if method == "dcb-plain":
        method, kw = "dcb", {"iterations": 1, "enhance": False}
    elif method in ("lmmse", "dcb"):
        kw = {"iterations": 2}
    ref = _ref(cfa, pattern, method, **kw)
    out = demosaic(torch.from_numpy(cfa), pattern, method,
                   dem_kwargs=tuple(kw.items())).numpy()
    assert out.shape == (3, *shape)
    _check(out, ref)


@pytest.mark.parametrize("auto", [False, True], ids=["contrast", "auto"])
@pytest.mark.parametrize("method", DUALS)
def test_dual_matches_reference(method, auto):
    cfa = _mosaic((64, 96), 12)
    kw = {"dual_contrast": 30.0, "dual_auto": auto}
    ref = _ref(cfa, "RGGB", method, **kw)
    out = demosaic(torch.from_numpy(cfa), "RGGB", method,
                   dem_kwargs=tuple(kw.items())).numpy()
    _check(out, ref, mean=1e-3)


def test_dual_with_contrast_0_is_the_sharp_method():
    cfa = torch.from_numpy(_mosaic((64, 96), 13))
    kw = (("dual_contrast", 0.0), ("dual_auto", False))
    assert torch.equal(demosaic(cfa, "GRBG", "rcdvng4", dem_kwargs=kw),
                       demosaic(cfa, "GRBG", "rcd"))


@pytest.mark.parametrize("scene", ["mosaic", "dark", "flat"])
def test_auto_threshold_matches_reference(scene):
    # "dark" (L under 2000) and "flat" (no variance) have no usable tile:
    # the default 0.2 in both
    rng = np.random.default_rng(14)
    if scene == "mosaic":
        rgb = np.stack([_mosaic((128, 192), 15 + c) for c in range(3)])
    elif scene == "dark":
        rgb = rng.uniform(0.0, 200.0, (3, 128, 192)).astype(np.float32)
    else:
        rgb = np.full((3, 128, 192), 20000.0, np.float32)
    lum = tdual.lab_l(torch.from_numpy(rgb))
    thr = float(tdual.auto_threshold(lum, tdual.contrast_map(lum)))
    with jax.disable_jit():
        rl = rdual._lab_l(jnp.asarray(rgb))
        ref = float(rdual._auto_threshold(rl, rdual._contrast_map(rl)))
    assert thr == ref
    if scene != "mosaic":
        assert thr == pytest.approx(0.2)
    np.testing.assert_allclose(lum.numpy(), np.asarray(rl), rtol=0,
                               atol=1e-2)


@pytest.mark.parametrize("auto", [False, True], ids=["contrast", "auto"])
def test_dual_blend_matches_reference(auto):
    sharp = np.stack([_mosaic((128, 192), 16 + c) for c in range(3)])
    flat = np.stack([_mosaic((128, 192), 20 + c) for c in range(3)])
    out = tdual.dual_blend(torch.from_numpy(sharp), torch.from_numpy(flat),
                           25.0, auto).numpy()
    with jax.disable_jit():
        ref = np.asarray(rdual.dual_blend(jnp.asarray(sharp),
                                          jnp.asarray(flat), 25.0, auto))
    _check(out, ref, mean=1e-3)


@pytest.mark.parametrize("method", ["mono", "none", "fast", "bilinear",
                                    "no such method", "AMaZE", "RCD"])
def test_dispatch_matches_reference(method):
    # mono and none repeat the mosaic; fast, bilinear and a name outside
    # the registry develop bilinear; names are case-blind
    cfa = _mosaic((64, 96), 17)
    _check(demosaic(torch.from_numpy(cfa), "BGGR", method).numpy(),
           _ref(cfa, "BGGR", method))


def test_registry_holds_the_references_names():
    ref_registry.get("amaze")
    assert sorted(methods()) == sorted(ref_registry._REGISTRY)


@pytest.fixture(scope="module")
def frame():
    rgb = np.random.default_rng(0).uniform(0.02, 0.95, (3, 96, 160))
    return synthesize_bayer(rgb.astype(np.float32))


NAMES = ["amaze", "rcd"] + METHODS + DUALS + [
    "mono", "none", "fast", "bilinear", "no such method", "pixelshift"]


@pytest.mark.parametrize("method", NAMES)
def test_plan_matches_reference(frame, method):
    # the same PipelineConfig (method, kwargs) and the same data; a
    # pixel-shift method on a single frame plans AMaZE, as the reference
    # does (rawimagesource.cc:1888), and an unknown name keeps its name
    # (its demosaic is bilinear)
    pp = ProcParams()
    pp.raw.bayer.method = method
    pp.raw.bayer.lmmse_iterations = 3
    pp.raw.bayer.dcb_iterations = 1
    pp.raw.bayer.dcb_enhance = False
    pp.raw.bayer.dual_demosaic_contrast = 40.0
    cfg, data = tdev.plan(frame, pp, device="cpu")
    ref_cfg, ref_data = jdev.plan(frame, pp)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert sorted(data) == sorted(ref_data)
    want = {"pixelshift": "amaze"}.get(method, method)
    assert cfg.demosaic_method == want and not cfg.pixelshift
    kw = dict(cfg.dem_kwargs)
    if method == "lmmse":
        assert kw == {"iterations": 3}
    if method.startswith("dcb"):
        assert kw["iterations"] == 1 and kw["enhance"] is False
    if method.endswith(("bilinear", "vng4")):
        assert kw["dual_contrast"] == 40.0
    tdev.build_run(cfg)


@pytest.fixture(scope="module")
def develops(tmp_path_factory):
    return Develops(tmp_path_factory.mktemp("demosaic_develops"))


@pytest.mark.parametrize("method", ["amazevng4", "dcb"])
def test_develop_matches_reference(frame, develops, method):
    # the flagship profile with the method (the automatic dual contrast,
    # DCB's two iterations with enhancement): B4 runs whole-plane here
    pp = flagship_pp()
    pp.raw.bayer.method = method
    out = tdev.develop(frame, pp, device="cpu").numpy()
    ref = develops.get("ref", plan_key(*jdev.plan(frame, pp)),
                       lambda: jdev.develop(frame, pp))
    st = parity(out, ref)
    print(method, st)
    assert out.shape == (3, 96, 160)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st
