"""Config 2 (BASELINE.json configs[1]: AMaZE after hot/dead pixels, green
equilibration and raw CA correction) in art_tpu_torch against `art_tpu`
on the CPU: each raw module on the same seeded numpy inputs, the plan,
and the whole develop at 512x512, below AMaZE's Pallas width, where the
reference takes its exact whole-plane path, and where raw CA takes its
surface branch (a 256x256 subgrid).

The scene is textured (two sinusoids and a seeded 1% noise); its R plane
is magnified by 1 + 2e-3 and its B plane by 1 - 2e-3 about the centre
before mosaicing, so the fitted CA shift is not zero, and 0.1% of the
sites are set to 0 or to white (`chip_smoke.with_raw_faults`).

Tolerances:
- hot/dead and green equilibration decide by thresholds on sums kept in
  the reference's order: at most RAW_FLIPS (2e-5) of the sites may
  decide differently, and where the decisions agree the outputs agree
  to 1e-2 of 65535;
- raw CA (a float32 least-squares fit and warp): outputs within 0.05 of
  65535, the fitted shift fields within 1e-3 px, the radial coefficient
  within 1e-7;
- the develop: PERF.md section 2's bounds (max <= 1/255, mean <= 2e-4,
  >= 99.9% within one 8-bit step) beyond RAW_REACH pixels of any flipped
  decision, at most RAW_FLIPS of the sites flipped.

Measured on this input (x86 CPU): no decision flips; hot/dead, green
equilibration and CA manual/radial equal bit for bit; the surface
branch within 0.004 of 65535; the develop 0.11 LSB8 max, 5e-8 mean.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.core.image import bayer_channel_masks as ref_masks
from art_tpu.params import ProcParams as RefProcParams
from art_tpu.raw import badpixels as rbad
from art_tpu.raw import ca_correct as rca
from art_tpu.raw import green_eq as rgeq
from art_tpu.raw import preprocess as rpre
from art_tpu_torch.core.image import bayer_channel_masks, pad_to_multiple
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev
from art_tpu_torch.raw import badpixels, ca_correct, green_eq
from chip_smoke import (RAW_FLIPS, RAW_REACH, config2_pp, flip_parity,
                        raw_decisions, with_raw_faults)

jdev = importlib.import_module("art_tpu.pipeline.develop")


def textured(h, w, seed=0):
    """A linear (3, H, W) scene: two sinusoids, a diagonal wave and 1%
    seeded noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (0.45 + 0.25 * np.sin(xx / 6.3) * np.cos(yy / 4.1)
            + 0.1 * np.sin((xx + yy) / 17.0))
    rgb = np.stack([base * 0.9, base, base * 0.8])
    rgb = rgb + np.random.default_rng(seed).normal(0.0, 0.01, rgb.shape)
    return np.clip(rgb, 0.01, 0.98).astype(np.float32)


def scaled_cfa(frame):
    """The frame's black-subtracted, scaled mosaic as the develop sees it
    (numpy float32)."""
    cfg, data = tdev.plan(frame, config2_pp(ProcParams()))
    inp, _ = pad_to_multiple(frame.cfa, 128)
    return tdev.rawpre.apply_scale(
        torch.from_numpy(inp), torch.from_numpy(data["raw_offset"]),
        torch.from_numpy(data["raw_scale"])).numpy()


@pytest.fixture(scope="module")
def faulty():
    """A scaled mosaic with faults, and the masks of its dead and hot
    sites."""
    f = with_raw_faults(textured(256, 384))
    return scaled_cfa(f), f.cfa == 0, f.cfa == f.white[0]


@pytest.fixture(scope="module")
def cfa(faulty):
    return faulty[0]


def green(shape):
    return (bayer_channel_masks("RGGB", shape, "cpu")[1],
            ref_masks("RGGB", shape)[1])


def check_decided(ours, ref, dec, ref_dec, what):
    flips = int((dec != ref_dec).sum())
    print(what, "decisions", int(ref_dec.sum()), "flips", flips)
    assert flips <= RAW_FLIPS * dec.size
    agree = dec == ref_dec
    np.testing.assert_allclose(ours[agree], ref[agree], rtol=0, atol=1e-2)


@pytest.mark.parametrize("hot,dead", [(True, False), (False, True),
                                      (True, True)],
                         ids=["hot-only", "dead-only", "both"])
def test_hot_dead_matches_reference(faulty, hot, dead):
    cfa, dead_sites, hot_sites = faulty
    mg, rmg = green(cfa.shape)
    bad = badpixels.find_hot_dead(torch.from_numpy(cfa), 100.0, hot, dead)
    ref_bad = np.asarray(rbad.find_hot_dead(jnp.asarray(cfa), 100.0, hot,
                                            dead))
    bad = bad.numpy()
    # the faults the setting looks for are found, the others left alone
    print("found", bad[hot_sites].mean(), bad[dead_sites].mean())
    for look, sites in ((hot, hot_sites), (dead, dead_sites)):
        if look:
            assert bad[sites].mean() >= 0.8
        else:
            assert not bad[sites].any()
    out = badpixels.interpolate_bad_bayer(
        torch.from_numpy(cfa), torch.from_numpy(bad), mg).numpy()
    ref = np.asarray(rbad.interpolate_bad_bayer(
        jnp.asarray(cfa), jnp.asarray(ref_bad), rmg))
    check_decided(out, ref, bad, ref_bad, f"hot={hot} dead={dead}")


def test_green_equilibration_matches_reference(cfa):
    mg, rmg = green(cfa.shape)
    out = green_eq.green_equilibrate(torch.from_numpy(cfa), mg, 1.0).numpy()
    ref = np.asarray(rgeq.green_equilibrate(jnp.asarray(cfa), rmg, 1.0))
    assert (out != cfa).sum() > 0.02 * mg.sum()  # 3.9% here
    check_decided(out, ref, out != cfa, ref != cfa, "green eq")


# (shape, auto, ca_red, ca_blue): the surface fit needs a 256-px
# subgrid; smaller frames take the radial fallback
CA_CASES = [((512, 512), True, 0.0, 0.0), ((256, 384), True, 0.0, 0.0),
            ((256, 384), False, 2.0, -1.5)]


@pytest.mark.parametrize("shape,auto,ca_red,ca_blue", CA_CASES,
                         ids=["surface", "radial", "manual"])
def test_ca_correct_matches_reference(shape, auto, ca_red, ca_blue):
    x = scaled_cfa(with_raw_faults(textured(*shape), share=0.0))
    out = ca_correct.ca_correct(torch.from_numpy(x), "RGGB", auto, ca_red,
                                ca_blue).numpy()
    ref = np.asarray(rca.ca_correct(jnp.asarray(x), "RGGB", auto, ca_red,
                                    ca_blue))
    print("CA output max diff", np.abs(out - ref).max(),
          "correction", np.abs(ref - x).max())
    np.testing.assert_allclose(out, ref, rtol=0, atol=0.05)
    assert np.abs(ref - x).max() > 1.0  # the correction moved the mosaic

    # the R subgrid (RGGB: even rows and columns) against its cardinal
    # G average, as ca_correct feeds the fits
    t = torch.from_numpy(x)
    gavg = 0.25 * (torch.roll(t, 1, 1) + torch.roll(t, -1, 1)
                   + torch.roll(t, 1, 0) + torch.roll(t, -1, 0))
    sub_r, g_r = t[0::2, 0::2], gavg[0::2, 0::2]
    rs, rg = jnp.asarray(sub_r.numpy()), jnp.asarray(g_r.numpy())
    if auto and min(sub_r.shape) >= 256:
        sy, sx = ca_correct._fit_surface(
            *ca_correct._block_shifts(sub_r, g_r), shape=sub_r.shape)
        rsy, rsx = rca._fit_surface(*rca._block_shifts(rs, rg),
                                    shape=rs.shape)
        d = max(np.abs(sy.numpy() - np.asarray(rsy)).max(),
                np.abs(sx.numpy() - np.asarray(rsx)).max())
        print("CA shift fields: max |shift|",
              float(np.abs(np.asarray(rsx)).max()), "max diff", d)
        assert float(np.abs(np.asarray(rsx)).max()) > 1e-2
        assert d <= 1e-3
    elif auto:
        c = float(ca_correct._estimate_radial(sub_r, g_r))
        rc = float(rca._estimate_radial(rs, rg))
        print("CA radial coefficient", rc, "diff", abs(c - rc))
        assert abs(rc) > 1e-5 and abs(c - rc) <= 1e-7


def _set(pp, changes):
    for path, value in changes.items():
        obj = pp
        *head, last = path.split(".")
        for p in head:
            obj = getattr(obj, p)
        setattr(obj, last, value)
    return pp


@pytest.fixture(scope="module")
def frame():
    return with_raw_faults(textured(512, 512))


@pytest.mark.parametrize("changes", [
    {},
    {"raw.hotpixel_filter": False, "raw.ca_autocorrect": False,
     "raw.ca_red": 1.5},
    # as tools/bench_configs.py writes config 2: no hot/dead filter
    {"raw.hotpixel_filter": False, "raw.deadpixel_filter": False},
], ids=["config2", "dead-manual-ca", "as-bench-configs"])
def test_plan_matches_reference(frame, changes):
    cfg, data = tdev.plan(frame, _set(config2_pp(ProcParams()), changes))
    ref_cfg, ref_data = jdev.plan(frame, _set(config2_pp(RefProcParams()),
                                              changes))
    for f in dataclasses.fields(ref_cfg):
        assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    assert sorted(data) == sorted(ref_data)
    if not changes:
        assert (cfg.hotdead, cfg.green_eq, cfg.ca_mode) == (
            (True, True, 100.0), 1.0, ("auto", 0.0, 0.0))


def _ref_decisions(frame):
    """The reference's hot/dead and green-equilibration decisions on its
    own scaled mosaic, by its functions run op by op."""
    cfg, data = jdev.plan(frame, config2_pp(RefProcParams()))
    inp, _ = pad_to_multiple(frame.cfa, 128)
    x = rpre.apply_scale(jnp.asarray(inp), data["raw_offset"],
                         data["raw_scale"], jnp)
    _, mg, _ = ref_masks(cfg.pattern, x.shape)
    bad = rbad.find_hot_dead(x, *cfg.hotdead[2:], *cfg.hotdead[:2])
    x = rbad.interpolate_bad_bayer(x, bad, mg)
    eq = rgeq.green_equilibrate(x, mg, cfg.green_eq)
    return np.asarray(bad) | np.asarray(eq != x)


def test_develop_matches_reference(frame):
    with raw_decisions() as dec:
        out = tdev.develop(frame, config2_pp(ProcParams()), device="cpu")
    assert out.shape == (3, 512, 512) and out.dtype == torch.float32
    ours_dec = dec["hotdead"][0] | dec["green_eq"][0]
    ref = np.asarray(jdev.develop(frame, config2_pp(RefProcParams())))
    st = flip_parity(out, ref, ours_dec, _ref_decisions(frame), RAW_REACH)
    print("config 2 develop, port vs art_tpu", st,
          "flagged", int(dec["hotdead"][0].sum()))
    assert int(dec["hotdead"][0].sum()) >= 100
    assert st["flip_share"] <= RAW_FLIPS, st
    assert st["max_lsb8_beyond_flips"] <= 1.0, st
    assert st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st


@pytest.mark.parametrize("changes,frame_changes,field", [
    ({"raw.bayer.linenoise": 10.0}, {}, "linedn"),
    ({"raw.bayer.pdaf_lines_filter": True},
     {"make": "Fujifilm", "model": "GFX 100"}, "pdaf"),
], ids=["line-denoise", "pdaf"])
def test_unported_raw_steps_raise_by_name(frame, changes, frame_changes,
                                          field):
    # CFA line denoise and the PDAF line filter, once refused here, plan
    # as in the reference (tests/test_torch_rawcal.py runs them)
    from tests.test_torch_plan import assert_plans_equal

    f = dataclasses.replace(frame, **frame_changes)
    cfg, data = tdev.plan(f, _set(config2_pp(ProcParams()), changes))
    assert_plans_equal((cfg, data), jdev.plan(
        f, _set(config2_pp(RefProcParams()), changes)))
    assert getattr(cfg, field) not in (False, (0.0, 3))
