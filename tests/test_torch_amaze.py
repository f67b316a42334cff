"""AMaZE in art_tpu_torch against `art_tpu`'s, on the CPU.

Inputs are made from a seed with numpy and handed to both packages; each
frame is built by its own package's `synthesize_bayer`.

(a) Each stage alone: the port's plain B1, B2 and B3 against
    `_stages_1to4/5to6/7to8(fast=False)` on the same reflect-padded
    plane, B2 and B3 fed the reference's own outputs of the stage
    before. Bound 0: the same float32 operations in the same order,
    with exact division on both sides.
(b) The whole `amaze_demosaic` against the reference's whole-plane path
    (`use_pallas=False`, exact division) for all four Bayer patterns, at
    init_gain 1 and at a gain whose clip points engage. Bound: max 1e-3,
    mean 1e-6 of 65535 and all pixels within 1.0 (measured: equal); the
    reference's own two exact paths differ by 49 max, 9e-4 mean.
(c) The AMaZE flagship develop at 256x1024 (the smallest shape at which
    the reference takes its Pallas paths) against `art_tpu`'s develop
    with its AMaZE forced onto the exact whole-plane path. Bounds: the
    slice's, max <= 1/255, mean <= 2e-4, >= 99.9% within 1 LSB8 (the
    rest of the gap is the wavelet shrink's approximate reciprocal,
    which the port does not copy).
(d) The same develop against the reference as it stands: on the CPU its
    Pallas AMaZE runs in interpret mode, where `pl.reciprocal(approx=
    True)` becomes a bfloat16 reciprocal. Bounds: mean <= 4e-4 and
    >= 99% within 1 LSB8: that gap (the reference against its own exact
    path, printed here) plus the wavelet gap of (c).

Measured on this input (x86 CPU): (a) and (b) equal; (c) 0.75 LSB8 max,
9.1e-5 mean, 100% within 1 LSB8; (d) 52.5 LSB8 max, 2.4e-4 mean, 99.46%
within 1 LSB8.
"""

import dataclasses
import importlib
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.core.image import bayer_channel_masks as ref_masks
from art_tpu.demosaic import registry as ref_registry
from art_tpu.io.rawfile import synthesize_bayer as ref_synthesize
from art_tpu.params import ProcParams as RefProcParams
from art_tpu_torch.core.image import synthesize_bayer
from art_tpu_torch.demosaic import amaze as ta
from art_tpu_torch.demosaic import amaze_kernel as ak
from art_tpu_torch.demosaic import demosaic
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import parity

# the reference's method registry fills itself only while it is empty:
# importing one method module first would leave it holding that method
# alone (the others then fall back to bilinear) for every later test in
# this process, so let it fill before the direct import below
ref_registry.get("amaze")
from art_tpu.demosaic import amaze as ra  # noqa: E402

jdev = importlib.import_module("art_tpu.pipeline.develop")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARP = os.path.join(REPO, "art_tpu_torch", "data", "profiles",
                   "Standard Film Curve.arp")
PATTERNS = ["RGGB", "BGGR", "GRBG", "GBRG"]


def flagship(pp):
    """The flagship profile (bench.py): AMaZE, denoise 20/20."""
    with open(ARP) as f:
        pp.apply_arp_text(f.read())
    assert pp.raw.bayer.method == "amaze"
    pp.denoise.enabled = True
    pp.denoise.luminance = 20.0
    pp.denoise.chrominance = 20.0
    return pp


def _stats(out, ref):
    d = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    return d, {"max": float(d.max()), "mean": float(d.mean())}


# ---------------------------------------------------------------- (a)

def _plane(pattern, seed):
    rng = np.random.default_rng(seed)
    cfa = (rng.uniform(0.01, 1.1, (64, 96)) * 65535).astype(np.float32)
    cfa = np.minimum(cfa, 65535.0)
    xp = (np.pad(cfa, ra.HALO, mode="reflect")
          / np.float32(65535.0)).astype(np.float32)
    mr, mg, mb = ref_masks(pattern, xp.shape, xp=jnp)
    return xp, (mr, mg, mb)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_matches_reference(stage, pattern):
    xp, (mr, mg, mb) = _plane(pattern, 10 + stage)
    gain = np.float32(1.6)  # clip points at 0.625 / 0.5: both engage
    cp, cp8 = jnp.float32(1.0) / gain, jnp.float32(0.8) / gain
    clips = ta.clip_points(gain, "cpu")
    x, jx = torch.from_numpy(xp), jnp.asarray(xp)
    r1 = ra._stages_1to4(jx, mg, cp, cp8)
    s1 = np.stack([np.asarray(a) for a in r1])
    if stage == 1:
        ours, ref = ta.stage1_plain(x, pattern, clips), s1
    elif stage == 2:
        ours = ta.stage2_plain(x, pattern, torch.from_numpy(s1))
        ref = np.stack([np.asarray(a) for a in ra._stages_5to6(jx, mg, *r1)])
    else:
        r2 = ra._stages_5to6(jx, mg, *r1)
        s2 = np.stack([np.asarray(a) for a in r2])
        ours = ta.stage3_plain(x, pattern, torch.from_numpy(s2), clips)
        h = ra.HALO
        ref = np.asarray(ra._stages_7to8(jx, mr, mg, mb, *r2, cp))[
            :, h:-h, h:-h]
    _, st = _stats(ours.numpy(), ref)
    print(f"stage {stage} {pattern}", st)
    assert ours.shape == ref.shape
    assert st["max"] == 0.0, st


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("gain", [1.0, 1.6])
def test_amaze_matches_whole_plane_reference(pattern, gain):
    rng = np.random.default_rng(3)
    cfa = np.minimum(rng.uniform(0.01, 1.1, (96, 160)) * 65535,
                     65535.0).astype(np.float32)
    ref = np.asarray(ra.amaze_demosaic(jnp.asarray(cfa), pattern,
                                       init_gain=jnp.float32(gain),
                                       use_pallas=False))
    before = ak.amaze_stage1.launches
    ours = ta.amaze_demosaic(torch.from_numpy(cfa), pattern,
                             init_gain=np.float32(gain)).numpy()
    assert ak.amaze_stage1.launches == before  # plain versions on the CPU
    d, st = _stats(ours, ref)
    st["within_1"] = float((d <= 1.0).mean())
    print(f"amaze {pattern} gain {gain}", st)
    assert ours.shape == (3, 96, 160)
    assert st["max"] <= 1e-3 and st["mean"] <= 1e-6, st
    assert st["within_1"] == 1.0, st


def test_amaze_odd_size_border():
    # odd sizes take the whole-plane border select
    rng = np.random.default_rng(4)
    cfa = (rng.uniform(0.02, 0.95, (71, 97)) * 65535).astype(np.float32)
    ref = np.asarray(ra.amaze_demosaic(jnp.asarray(cfa), "GRBG",
                                       use_pallas=False))
    ours = ta.amaze_demosaic(torch.from_numpy(cfa), "GRBG").numpy()
    _, st = _stats(ours, ref)
    assert st["max"] <= 1e-3, st


# ---------------------------------------------------------------- (c), (d)

@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    return rng.uniform(0.02, 0.95, size=(3, 256, 1024)).astype(np.float32)


@pytest.fixture(scope="module")
def port_out(scene):
    counts = (ak.amaze_stage1.launches, ta.stage1_plain.calls)
    out = tdev.develop(synthesize_bayer(scene), flagship(ProcParams()),
                       device="cpu")
    assert (ak.amaze_stage1.launches, ta.stage1_plain.calls) == (
        counts[0], counts[1] + 1)
    return out


def _ref_develop(scene):
    jdev._executor.cache_clear()
    jax.clear_caches()
    try:
        return np.asarray(jdev.develop(ref_synthesize(scene),
                                       flagship(RefProcParams())))
    finally:
        jdev._executor.cache_clear()
        jax.clear_caches()


@pytest.fixture(scope="module")
def ref_exact(scene):
    from art_tpu.demosaic import amaze_pallas

    mp = pytest.MonkeyPatch()
    mp.setattr(amaze_pallas, "amaze_pallas", lambda *a, **k: None)
    try:
        return _ref_develop(scene)
    finally:
        mp.undo()


def test_develop_matches_exact_reference(port_out, ref_exact):
    out = port_out.numpy()
    assert out.shape == (3, 256, 1024) and out.dtype == np.float32
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
    st = parity(out, ref_exact)
    print("port develop vs art_tpu develop (exact AMaZE)", st)
    assert st["max_lsb8"] <= 1.0, st
    assert st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st


def test_develop_against_unpatched_reference(port_out, ref_exact, scene):
    ref = _ref_develop(scene)
    st = parity(port_out.numpy(), ref)
    print("port develop vs art_tpu develop (as it stands)", st)
    # the reference's own gap: its Pallas AMaZE in interpret mode against
    # its exact whole-plane path
    print("art_tpu develop as it stands vs exact AMaZE",
          parity(ref, ref_exact))
    assert st["mean"] <= 4e-4, st
    assert st["within_1lsb8"] >= 0.99, st


def test_plan_matches_reference_for_amaze(scene):
    # AMaZE plans no demosaic kwargs in either package
    cfg, data = tdev.plan(synthesize_bayer(scene), flagship(ProcParams()))
    ref_cfg, ref_data = jdev.plan(ref_synthesize(scene),
                                  flagship(RefProcParams()))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.demosaic_method == "amaze" and cfg.dem_kwargs == ()
    assert data["init_gain"] == ref_data["init_gain"]


@pytest.mark.parametrize("method", ["igv", "lmmse", "amazebilinear", "dcb",
                                    "vng4", "no such method"])
def test_unported_demosaic_raises_by_name(method):
    # every method of the reference's registry is ported, and a name
    # outside it develops bilinear, as in the reference (its registry's
    # default): each develops as the reference's dispatch does, within
    # 0.05 of 65535 (measured: equal but the dual blend's exp, 0.004)
    rng = np.random.default_rng(7)
    cfa = (rng.uniform(0.05, 0.9, (64, 96)) * 60000).astype(np.float32)
    from art_tpu.demosaic import demosaic as ref_demosaic

    ref = np.asarray(ref_demosaic(jnp.asarray(cfa), "RGGB", method))
    out = demosaic(torch.from_numpy(cfa), "RGGB", method).numpy()
    assert out.shape == ref.shape == (3, 64, 96)
    np.testing.assert_allclose(out, ref, rtol=0, atol=0.05)


def test_amaze_wrappers_refuse_bad_inputs():
    x = torch.zeros(80, 96)
    clips = ta.clip_points(1.0, "cpu")
    with pytest.raises(ValueError, match="Bayer"):
        ak.amaze_stage1(x, "RGBG", clips)
    with pytest.raises(ValueError, match="float32"):
        ak.amaze_stage1(x.double(), "RGGB", clips)
    with pytest.raises(ValueError, match="HALO"):
        ak.amaze_stage1(torch.zeros(40, 96), "RGGB", clips)
    with pytest.raises(ValueError, match="stage input"):
        ak.amaze_stage2(x, "RGGB", torch.zeros(2, 80, 96))
    with pytest.raises(ValueError, match="clips"):
        ak.amaze_stage3(x, "RGGB", torch.zeros(2, 80, 96), clips[:1])


def test_develop_runs_on_the_card_by_default():
    param = inspect.signature(tdev.develop).parameters["device"]
    assert param.default == "cuda"
