"""Kernel B7 (Neutral tone curve) of art_tpu_torch against the JAX
reference's `apply_neutral` in its Pallas interpret path, with and
without the fused output epilogue, for the split and the Chebyshev curve
forms. Inputs come from numpy seeds and go to both packages unchanged.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from art_tpu.color import colorspaces as jcs
from art_tpu.ops import tonecurve_neutral as jtn
from art_tpu.params import ProcParams
from art_tpu_torch.core.curve1d import fit_curve, fit_curve_split
from art_tpu_torch.ops import tonecurve as ttc
from art_tpu_torch.ops import tonecurve_neutral as ttn

# Same float32 formulas in the same order; the platforms' exp and
# division round differently in the last bit, and the PQ inverse (a
# steep power fit) amplifies that to at most ~1.5 of 65535 (2.3e-5 of
# full scale) in the linear output, measured at these inputs; encoded
# [0,1] output differs by at most 1.5e-4 (0.04 of an 8-bit step).
LIN_MAX, LIN_MEAN = 4.0, 0.2
ENC_MAX, ENC_MEAN = 5e-4, 5e-6


def _flagship_tc():
    import os

    pp = ProcParams()
    arp = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "art_tpu_torch", "data", "profiles",
        "Standard Film Curve.arp")
    pp.apply_arp_text(open(arp).read())
    return pp


def _inputs(seed=4):
    # working-space RGB spanning black, out-of-gamut negatives and
    # highlights past white
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.05, 1.15, size=(3, 128, 256)) * 65535).astype(
        np.float32)


def _work2out():
    m = (np.linalg.inv(jcs.MATRICES_RGB_TO_XYZ["sRGB"])
         @ jcs.MATRICES_RGB_TO_XYZ["Rec2020"])
    return m.astype(np.float32)


def _case(name):
    pp = _flagship_tc()
    _, data = ttc.plan(pp, {"working_profile": "Rec2020"})
    coeffs = data["coeffs"]
    if name == "cheb-epi":
        lut = ttc.compose_luts([ttc.adjust_user_curve(pp.tone_curve.curve)])
        coeffs = fit_curve(lut)
        assert coeffs.ndim == 1
    d = {"coeffs": coeffs, "params": data["params"], "out_mat": _work2out()}
    static = ("neutral",)
    if name.endswith("epi"):
        trc = "linear" if name.startswith("linear") else "srgb"
        static = static + (("epi", (trc, None)),)
    return d, static


@pytest.mark.parametrize("name", ["split", "split-epi", "cheb-epi",
                                  "linear-epi"])
def test_plain_b7_matches_pallas_interpret(name):
    d, static = _case(name)
    rgb = _inputs()
    ref = np.asarray(jtn.apply_neutral(
        jnp.asarray(rgb), {k: jnp.asarray(v) for k, v in d.items()},
        static))
    out = ttn.apply_neutral(
        torch.from_numpy(rgb),
        {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()},
        static).numpy()
    assert out.shape == ref.shape == rgb.shape
    diff = np.abs(out - ref)
    hi, mean = (ENC_MAX, ENC_MEAN) if "epi" in name else (LIN_MAX, LIN_MEAN)
    assert diff.max() <= hi, diff.max()
    assert diff.mean() <= mean, diff.mean()


def test_plan_neutral_matches_reference():
    pp = _flagship_tc()
    ctx = {"working_profile": "Rec2020"}
    lut = np.linspace(0.0, 1.0, 65536, dtype=np.float32) ** 0.9
    _, ours = ttn.plan_neutral(pp, ctx, lut, 1.0)
    _, ref = jtn.plan_neutral(pp, ctx, lut, 1.0)
    np.testing.assert_array_equal(ours["coeffs"], ref["coeffs"])
    np.testing.assert_array_equal(ours["params"][:36], ref["params"][:36])
    # hue anchors: float32 host numpy against a float32 XLA program (its
    # own arctan2): within 2e-6 rad
    np.testing.assert_allclose(ours["params"][36:], ref["params"][36:],
                               rtol=0, atol=2e-6)


def test_wrapper_checks_and_cpu_path():
    d, static = _case("split-epi")
    rgb = torch.from_numpy(_inputs())
    params = torch.cat([torch.from_numpy(d["params"]),
                        torch.from_numpy(d["out_mat"]).reshape(-1)])
    coeffs = torch.from_numpy(d["coeffs"])
    before = ttn.neutral_tone.launches
    out = ttn.neutral_tone(rgb, params, coeffs, "srgb")
    assert ttn.neutral_tone.launches == before  # CPU: plain version
    assert torch.equal(out, ttn.neutral_plain(rgb, params, coeffs, "srgb"))
    with pytest.raises(ValueError):
        ttn.neutral_tone(rgb, params[:43], coeffs, "srgb")
    with pytest.raises(ValueError):
        ttn.neutral_tone(rgb[:2], params, coeffs, "srgb")
    with pytest.raises(NotImplementedError):
        ttn.neutral_tone(rgb, params, coeffs, "gamma")
    # a curve form the kernel has no instantiation for
    with pytest.raises(NotImplementedError, match="curve forms"):
        ttn.neutral_tone(rgb, params, coeffs[:, :-1], "srgb")


def test_kernel_forms_mirror_the_source_and_the_fits():
    src = (Path(ttn.__file__).resolve().parents[1] / "csrc"
           / "neutral_tone.cu").read_text()
    line = re.search(r"#define FORMS\(X\)(.*)", src).group(1)
    forms = tuple((int(a), int(b))
                  for a, b in re.findall(r"X\((\d+), (\d+)\)", line))
    assert forms == ttn.KERNEL_FORMS
    # every series the planner fits is one of them: split fits of each
    # half degree, and Chebyshev fits of curves from gentle to steep
    x = np.linspace(0.0, 1.0, 65536)
    for dh in fit_curve_split.__defaults__[0]:
        assert (2, dh + 1) in forms
    shapes = {(1, fit_curve(x + a * np.sin(k * np.pi * np.sqrt(x)))
               .shape[0]) for a, k in ((0.01, 4), (0.005, 10), (0.002, 14))}
    assert shapes == {f for f in forms if f[0] == 1}, shapes


def test_segment_curve_takes_plain_math():
    d, static = _case("split")
    lut = np.clip(np.linspace(0.0, 1.3, 65536), 0, 1).astype(np.float32)
    seg = fit_curve(lut, allow_poly=False)
    assert seg.shape == (64, 4)
    rgb = _inputs(6)
    dd = dict(d, coeffs=seg)
    ref = np.asarray(jtn.apply_neutral(
        jnp.asarray(rgb), {k: jnp.asarray(v) for k, v in dd.items()},
        static))
    before = ttn.neutral_tone.launches
    out = ttn.apply_neutral(
        torch.from_numpy(rgb),
        {k: torch.from_numpy(np.asarray(v)) for k, v in dd.items()},
        static).numpy()
    assert ttn.neutral_tone.launches == before
    diff = np.abs(out - ref)
    assert diff.max() <= LIN_MAX and diff.mean() <= LIN_MEAN
