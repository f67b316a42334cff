"""Spot removal, film negative and Fattal tone mapping in art_tpu_torch
against `art_tpu` on the CPU (the cases of tests/test_spot_filmneg.py):
each op's plan and its apply on the same planes, spots healing a
blemish on a flat field and on a gradient, two entries where the second
heals from what the first healed, film negative at its automatic input
(the median of an even count) and with references, the median stencils
of Fattal's shadow prefilter at every size they switch at, and a small
bilinear develop of each op through both packages.

Tolerances: the plans' data equal (the same numpy); spot and film
negative applies to max |diff| <= 0.05 of 65535 (float32, the same
operation order; pow rounds differently in XLA and PyTorch); Fattal's to
a relative 1e-3 (two FFT libraries, whose rounding the Poisson solve's
lowest modes amplify); the medians equal (a selection);
the develops at PERF.md section 2's bounds (max <= 1/255, mean <= 2e-4,
>= 99.9% within one 8-bit step).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.params import ProcParams as RefProcParams
from art_tpu_torch.core.image import synthesize_bayer
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import parity

jdev = importlib.import_module("art_tpu.pipeline.develop")


def _spot_arp(*entries):
    return "[Spot Removal]\nEnabled=true\n" + "".join(
        f"Spot{i + 1}={';'.join(str(v) for v in e)}\n"
        for i, e in enumerate(entries))


def blemish():
    rgb = np.full((3, 128, 128), 0.5 * 65535, np.float32)
    rgb[:, 60:68, 60:68] = 0.1 * 65535
    return rgb


def gradient():
    h, w = 128, 160
    ramp = np.linspace(0.2, 0.8, w, dtype=np.float32) * 65535
    rgb = np.broadcast_to(ramp, (3, h, w)).copy()
    rgb[:, 58:70, 114:126] = 0.05 * 65535
    return rgb


def noisy():
    return (np.random.default_rng(5).uniform(0, 1, (3, 96, 128)) ** 1.5
            * 60000).astype(np.float32)


# (case id, image, .arp): sx;sy;tx;ty;radius;feather;opacity;detail
SPOTS = [
    ("flat-blemish", blemish, _spot_arp((30, 30, 64, 64, 10, 0.5, 1.0, 2))),
    ("gradient", gradient, _spot_arp((30, 64, 120, 64, 12, 0.4, 1.0, 2))),
    # the second entry's target covers the first's source: it heals from
    # the image the first entry left
    ("overlapping", noisy, _spot_arp((30, 30, 60, 48, 8, 0.5, 1.0, 2),
                                     (90, 60, 38, 30, 8, 1.0, 0.8, 4))),
    # a window clamped at the frame's corner, where the SOR wraps
    ("corner", noisy, _spot_arp((5, 5, 120, 90, 6, 0.3, 1.0, 0))),
]

NEG = [
    ("auto", "[Film Negative]\nEnabled=true\n"),
    ("refs", "[Film Negative]\nEnabled=true\nRefInput=20000;20000;20000;\n"
     "RefOutput=30000;30000;30000;\n"),
    ("ratios", "[Film Negative]\nEnabled=true\nRedRatio=1.2\n"
     "GreenExponent=1.8\nBlueRatio=0.7\nRefOutput=0;0;0;\n"),
]


def _plans(op, arp, shape):
    frame = synthesize_bayer(np.full((3, *shape), 0.5))
    ours, ref = ProcParams(), RefProcParams()
    ours.apply_arp_text(arp)
    ref.apply_arp_text(arp)
    ctx = {"working_profile": "Rec2020", "frame": frame, "op_dims": shape}
    return (importlib.import_module(f"art_tpu_torch.ops.{op}").plan(ours, ctx),
            importlib.import_module(f"art_tpu.ops.{op}").plan(ref, ctx))


def _same_data(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _same_data(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_data(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


def _apply(op, rgb, ours, ref):
    (st, data), (rst, rdata) = ours, ref
    assert st == rst
    _same_data(data, rdata)
    a = importlib.import_module(f"art_tpu_torch.ops.{op}").apply(
        torch.from_numpy(rgb), tdev.data_to_torch(data, "cpu"), st).numpy()
    b = np.asarray(importlib.import_module(f"art_tpu.ops.{op}").apply(
        jnp.asarray(rgb), rdata, rst))
    return a, b


@pytest.mark.parametrize("case,image,arp", SPOTS, ids=[s[0] for s in SPOTS])
def test_spot_matches_reference(case, image, arp):
    rgb = image()
    a, b = _apply("spot", rgb, *_plans("spot", arp, rgb.shape[1:]))
    d = np.abs(a.astype(np.float64) - b)
    print(case, "max diff", d.max())
    assert np.abs(b - rgb).max() > 1000.0
    assert d.max() <= 0.05
    assert not np.array_equal(a, rgb) and a.dtype == np.float32


def test_spot_entries_apply_in_order():
    # the overlapping case differs from its entries applied each to the
    # input alone: the second reads what the first healed
    rgb = noisy()
    arp = SPOTS[2][2]
    (st, data), _ = _plans("spot", arp, rgb.shape[1:])
    from art_tpu_torch.ops import spot

    d = tdev.data_to_torch(data, "cpu")
    x = torch.from_numpy(rgb)
    both = spot.apply(x, d, st)
    one = {k: v[1:] for k, v in d.items()}
    alone = spot.apply(x, one, st[1:])
    sy, sx, ty, tx, size, _ = st[1]
    win = (slice(None), slice(ty, ty + size), slice(tx, tx + size))
    assert not torch.equal(both[win], alone[win])
    assert torch.equal(x, torch.from_numpy(rgb))  # the input is kept


@pytest.mark.parametrize("case,arp", NEG, ids=[n[0] for n in NEG])
def test_film_negative_matches_reference(case, arp):
    rgb = noisy()
    a, b = _apply("filmneg", rgb, *_plans("filmneg", arp, rgb.shape[1:]))
    d = np.abs(a.astype(np.float64) - b)
    print(case, "max diff", d.max())
    assert d.max() <= 0.05 and np.abs(b - rgb).max() > 1000.0


def test_median_of_an_even_count_is_numpys():
    from art_tpu_torch.ops.filmneg import median

    x = np.random.default_rng(2).uniform(0, 65535, (3, 150)).astype(
        np.float32)
    np.testing.assert_array_equal(median(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.median(x, axis=1)))
    np.testing.assert_array_equal(median(torch.from_numpy(x)).numpy(),
                                  np.median(x, axis=1).astype(np.float32))
    # torch's median is the lower middle value: not numpy's
    assert not np.array_equal(torch.median(torch.from_numpy(x), dim=1)
                              .values.numpy(), np.median(x, axis=1))
    odd = torch.from_numpy(x[:, :149].copy())
    np.testing.assert_array_equal(median(odd).numpy(),
                                  np.median(x[:, :149], axis=1))
    # the auto input of a 96x128 frame: 10 rows x 16 columns, even
    c, h, w = 3, 96, 128
    n = len(range(int(h * 0.2), int(h * 0.8), 4)) * len(
        range(int(w * 0.2), int(w * 0.8), 4))
    assert n % 2 == 0


@pytest.mark.parametrize("stencil", ["_MED_3X3", "_MED_5X5_SOFT", "_MED_5X5",
                                     "_MED_7X7"])
def test_fattal_median_stencils_match_reference(stencil):
    from art_tpu.ops import fattal as rf
    from art_tpu_torch.ops import fattal

    x = np.random.default_rng(3).uniform(0, 100, (600, 40)).astype(
        np.float32)
    pts = getattr(fattal, stencil)
    assert pts == getattr(rf, stencil)
    got = fattal._median_pts(torch.from_numpy(x), pts).numpy()
    np.testing.assert_array_equal(got, np.asarray(rf._median_pts(
        jnp.asarray(x), pts)))


def scene(shape, seed=6):
    """A smooth warm scene with 5% noise and deep shadows (about 9% of
    the pixels below Fattal's noise floor, where the median runs)."""
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.45 * np.sin(xx / (w / 7.0)) * np.cos(yy / (h / 3.0))
    rgb = base[None] ** 4 * np.array([1.0, 0.8, 0.6], np.float32)[
        :, None, None]
    rgb = rgb * (1 + 0.05 * np.random.default_rng(seed).standard_normal(
        (3, h, w)))
    return (np.clip(rgb, 0, 1) * 60000).astype(np.float32)


@pytest.mark.parametrize("shape", [(96, 128), (256, 1920), (384, 3840)],
                         ids=["3x3", "5x5-soft", "5x5-ds2"])
def test_fattal_matches_reference(shape):
    arp = "[FattalToneMapping]\nEnabled=true\nThreshold=30\nAmount=20\n"
    rgb = scene(shape)
    assert (rgb.mean(0) < 65.535).mean() > 0.05
    a, b = _apply("fattal", rgb, *_plans("fattal", arp, shape))
    rel = np.abs(a.astype(np.float64) - b) / np.maximum(np.abs(b), 1.0)
    print(shape, "max rel", rel.max())
    assert np.isfinite(b).all() and np.abs(b - rgb).max() > 100.0
    assert rel.max() <= 1e-3


@pytest.mark.parametrize("arp", [
    SPOTS[2][2], NEG[0][1],
    "[FattalToneMapping]\nEnabled=true\nThreshold=-40\nAmount=50\n"],
    ids=["spot", "filmneg", "fattal"])
def test_develops_as_the_reference(arp):
    frame = synthesize_bayer(noisy() / 65535.0)
    pps = []
    for cls in (ProcParams, RefProcParams):
        pp = cls()
        pp.raw.bayer.method = "bilinear"
        pp.apply_arp_text(arp)
        pps.append(pp)
    cfg, _ = tdev.plan(frame, pps[0])
    assert [s[0] for s in cfg.steps] == [s[0] for s in jdev.plan(
        frame, pps[1])[0].steps] and len(cfg.steps) == 1
    st = parity(tdev.develop(frame, pps[0], device="cpu"),
                np.asarray(jdev.develop(frame, pps[1])))
    print(st)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st
