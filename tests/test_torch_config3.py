"""Config 3 (BASELINE.json configs[2]: RCD, wavelet NR, NLMeans, impulse)
through art_tpu_torch's plan -> develop -> crop_result on the CPU against
`art_tpu`'s develop, at 256x1024 (the smallest shape at which the
reference takes its Pallas paths), on the encoded [0, 1] output.

Two variants: with the Smoothing group on, the denoise takes the
non-fused path (kernels B5 and B6, the guided chroma filter) and the
raw head runs on its own; as `tools/bench_configs.py` writes it (the
group off, so NLMeans never runs), the fused B4 path takes the raw head.
Both end with the stage-2 impulse denoise and the unfused output tail
(no tone curve).

Bounds, against the reference with its wavelet shrink's approximate
reciprocal replaced by a division (the port divides exactly; as for
the flagship, the rest of the gap to the reference as it stands is that
reciprocal): mean <= 2e-4 and >= 99.9% of values within one 8-bit step;
the impulse decision (a comparison of two filtered sums, rounded
differently in the two packages) differs at no more than 2e-5 of the
pixels (5 at 256x1024), and max <= 1/255 holds outside the reach of
those pixels (the pixel and the impulses within 2 pixels, whose
replacement weighs it). Without the impulse step, max <= 1/255 holds
everywhere. Against the reference as it stands: mean <= 2e-4, >= 99.9%
within one step.

The decisions are read where each package makes them: the port's from
`ops.impulse.detect` (`chip_smoke.impulse_masks`), the reference's inside
its jit, as the plane it edge-pads fourth in `art_tpu.ops.impulse.apply`
(ok = ~imp).

Measured on this input (x86 CPU): smoothing on, one pixel's impulse
decision differs (6 values beyond one step, 44.7 LSB8 max), 0.022 LSB8
max outside its reach, 1.3e-6 mean; without impulse 0.033 LSB8 max.
Smoothing off: one pixel (3 values beyond, 8.0 LSB8 max), 0.0004 LSB8
outside its reach, 2.1e-7 mean; without impulse 0.0002 LSB8. As it stands: 64.1 and 71.5 LSB8 max, 1.2e-4 mean, 99.97%
within one step.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.ops import impulse as rimp
from art_tpu.ops import wavelet_pallas as wp
from art_tpu.params import ProcParams as RefProcParams
from art_tpu_torch.core.image import synthesize_bayer
from art_tpu_torch.ops import nlmeans_kernel as nk
from art_tpu_torch.ops import wavelet_kernel as wk
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import (IMPULSE_FLIPS, config3_pp, impulse_masks,
                        impulse_parity, parity)
from test_torch_wavelet_multi import _exact_shrink

jdev = importlib.import_module("art_tpu.pipeline.develop")

VARIANTS = [True, False]
IDS = ["smoothing", "as-bench-configs"]


class _RecordImpulse:
    """`jnp` as `art_tpu.ops.impulse` sees it, gathering the impulse mask
    of each traced `apply` as it runs: its fourth edge pad is that of
    ok = ~imp."""

    def __init__(self, masks):
        self.masks, self.pads = masks, 0

    def __getattr__(self, name):
        return getattr(jnp, name)

    def pad(self, t, *args, **kwargs):
        self.pads += 1
        if self.pads % 4 == 0:
            jax.debug.callback(
                lambda ok: self.masks.append(np.asarray(ok) == 0), t)
        return jnp.pad(t, *args, **kwargs)


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0.02, 0.95, size=(3, 256, 1024)).astype(np.float32)
    return synthesize_bayer(rgb, pattern="RGGB")


def _ref_develop(frame, pp, exact, masks=None):
    """art_tpu's develop, with an exact shrink if `exact`; the impulse
    masks it makes are appended to `masks`."""
    mp = pytest.MonkeyPatch()
    if exact:
        mp.setattr(wp, "_shrink", _exact_shrink)
    if masks is not None:
        mp.setattr(rimp, "jnp", _RecordImpulse(masks))
    jdev._executor.cache_clear()
    jax.clear_caches()
    try:
        out = np.asarray(jdev.develop(frame, pp))
        jax.effects_barrier()
        return out
    finally:
        mp.undo()
        jdev._executor.cache_clear()
        jax.clear_caches()


def _port_develop(frame, smoothing, impulse=True):
    counted = (wk.wavelet_denoise_rgb, wk.wavelet_denoise_multi, nk.nlmeans)
    plains = (wk.wavelet_rgb_plain, wk.wavelet_multi_plain, nk.nlmeans_plain)
    launches = [f.launches for f in counted]
    calls = [f.calls for f in plains]
    out = tdev.develop(frame, config3_pp(ProcParams(), smoothing, impulse),
                       device="cpu")
    # no kernel on the CPU; the plain versions of the path, once each
    assert [f.launches for f in counted] == launches
    want = [0, 1, 1] if smoothing else [1, 0, 0]
    assert [f.calls - c for f, c in zip(plains, calls)] == want
    assert out.shape == (3, 256, 1024) and out.dtype == torch.float32
    out = out.numpy()
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
    return out


@pytest.mark.parametrize("smoothing", VARIANTS, ids=IDS)
def test_develop_matches_exact_reference(frame, smoothing):
    with impulse_masks() as masks:
        out = _port_develop(frame, smoothing)
    ref_masks = []
    ref = _ref_develop(frame, config3_pp(RefProcParams(), smoothing), True,
                       ref_masks)
    assert len(masks) == len(ref_masks) == 1
    st = impulse_parity(out, ref, masks[0], ref_masks[0])
    print("port develop vs art_tpu develop (exact shrink)", st)
    assert st["flip_share"] <= IMPULSE_FLIPS, st
    assert st["max_lsb8_beyond_flips"] <= 1.0, st
    assert st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st


@pytest.mark.parametrize("smoothing", VARIANTS, ids=IDS)
def test_develop_without_impulse_matches_exact_reference(frame, smoothing):
    out = _port_develop(frame, smoothing, impulse=False)
    ref = _ref_develop(frame, config3_pp(RefProcParams(), smoothing, False),
                       True)
    st = parity(out, ref)
    print("without impulse, port vs art_tpu (exact shrink)", st)
    assert st["max_lsb8"] <= 1.0, st
    assert st["mean"] <= 2e-4, st


@pytest.mark.parametrize("smoothing", VARIANTS, ids=IDS)
def test_develop_against_unpatched_reference(frame, smoothing):
    out = _port_develop(frame, smoothing)
    ref = _ref_develop(frame, config3_pp(RefProcParams(), smoothing), False)
    st = parity(out, ref)
    print("port develop vs art_tpu develop (as it stands)", st)
    assert st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("smoothing", VARIANTS, ids=IDS)
def test_plan_matches_reference(frame, smoothing):
    cfg, data = tdev.plan(frame, config3_pp(ProcParams(), smoothing))
    ref_cfg, ref_data = jdev.plan(frame,
                                  config3_pp(RefProcParams(), smoothing))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.demosaic_method == "rcd" and cfg.out_trc == ("srgb", None)
    steps = {s[0]: s[1] for s in cfg.steps}
    assert steps["denoise"][1:3] == ((50, 3) if smoothing else (0, 0))
    assert steps["impulse"] == (2.0,)
    assert tdev.fusion_gates(cfg) == (not smoothing, False)
    ours, ref = dict(_leaves(data)), dict(_leaves(ref_data))
    assert sorted(ours) == sorted(ref)
    for k, rv in ref.items():
        ov, rv = np.asarray(ours[k]), np.asarray(rv)
        assert ov.shape == rv.shape and ov.dtype == rv.dtype, k
        np.testing.assert_allclose(ov, rv, rtol=1e-6, atol=0, err_msg=k)


def test_reference_plan_through_port_runner(frame):
    # the reference's own (config, data) on the port's device program
    pp = config3_pp(RefProcParams())
    config, data = jdev.plan(frame, pp)
    inp, _ = tdev.pad_to_multiple(frame.cfa, 128)
    out = tdev.build_run(config)(torch.from_numpy(inp),
                                 tdev.data_to_torch(data, "cpu"))
    out = tdev.crop_result(out, config).numpy()
    ours = _port_develop(frame, True)
    # the planners agree to float32 rounding (above), so the runs do too
    st = parity(out, ours)
    assert st["max_lsb8"] <= 1e-3, st
