"""CLF and CTL film-simulation files in art_tpu_torch against `art_tpu` on
the CPU.

- `load_clf` of each ProcessNode kind (the XML parse is the reference's
  host code): the same signatures and arrays. `apply_clf` of each node
  on values that straddle its breaks (the LUT1D's ends and knots, the
  LUT3D's lattice, Range's clamps, the moncurve's and the camera log's
  linear segments, negative values for the mirror and pass-through
  styles): within 2e-6 of max(1, |value|) (log, exp and pow round
  differently in XLA and PyTorch).
- The CTL forms of tests/test_ctl.py (a gain with a uniform `if`, user
  functions with output arrays, a const 3x3 inverse and masked returns,
  loops and a varying ternary) and P3's script (two @ART-params, a
  masked return in a function of a varying value): within 1e-5 of
  max(1, |value|); the annotations parse to the same parameters;
  `bake_lut` at the script's @ART-lut size and at an explicit one
  within 1e-5 of max(1, |value|); the shaper within 1e-5 (its inverse
  divides by a difference that cancels near the black end).
- The film simulation of P3's CLF and CTL files plans as the
  reference's (covered for every kind in tests/test_torch_config4.py).
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.color import clf as rclf
from art_tpu.color import ctl as rctl
from art_tpu_torch.color import clf, ctl
from chip_smoke import CTL_TEXT, write_clf
from tests.test_ctl import FUNCS, LOOPS, SIMPLE


def _close(ours, ref, tol):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    bad = np.abs(ours - ref) > tol * np.maximum(1.0, np.abs(ref))
    assert not bad.any(), (np.abs(ours - ref).max(), ours[bad][:5],
                           ref[bad][:5])


def _write(path, body, compress=False):
    doc = ('<?xml version="1.0" encoding="UTF-8"?>\n'
           '<ProcessList id="x" compCLFversion="3.0">\n'
           f"{body}\n</ProcessList>\n")
    if compress:
        with gzip.open(path, "wb") as f:
            f.write(doc.encode())
    else:
        with open(path, "w") as f:
            f.write(doc)
    return path


def _array(dim, vals):
    return (f'<Array dim="{dim}">\n'
            + " ".join(f"{v:.9g}" for v in np.ravel(vals)) + "\n</Array>")


RNG = np.random.default_rng(11)
LUT1D_1 = np.sort(RNG.uniform(0, 1023, 17))
LUT1D_3 = np.sort(RNG.uniform(0, 1, (9, 3)), axis=0)
LUT3D = np.clip(np.stack(np.meshgrid(*[np.linspace(0, 1, 5)] * 3,
                                     indexing="ij"), -1) ** 1.3
                + RNG.uniform(-0.03, 0.03, (5, 5, 5, 3)), 0, 1)


def _log(style, params=None):
    attrs = " ".join(f'{k}="{v}"' for k, v in (params or {}).items())
    inner = f"<LogParams {attrs}/>" if params else ""
    return (f'<Log inBitDepth="32f" outBitDepth="32f" style="{style}">'
            f"{inner}</Log>")


CAMERA = {"base": 2, "logSideSlope": 0.0570776, "logSideOffset": 0.5547945,
          "linSideSlope": 1, "linSideOffset": 0,
          "linSideBreak": 0.0078125}

NODES = {
    "lut1d-1": ('<LUT1D inBitDepth="32f" outBitDepth="10i">'
                + _array("17 1", LUT1D_1) + "</LUT1D>"),
    "lut1d-3": ('<LUT1D inBitDepth="32f" outBitDepth="32f">'
                + _array("9 3", LUT1D_3) + "</LUT1D>"),
    "lut3d-tetra": ('<LUT3D inBitDepth="32f" outBitDepth="32f" '
                    'interpolation="tetrahedral">'
                    + _array("5 5 5 3", LUT3D) + "</LUT3D>"),
    "lut3d-tri": ('<LUT3D inBitDepth="32f" outBitDepth="32f">'
                  + _array("5 5 5 3", LUT3D) + "</LUT3D>"),
    "matrix3": ('<Matrix inBitDepth="32f" outBitDepth="32f">'
                + _array("3 3", [1.1, -0.05, -0.05, -0.1, 1.2, -0.1, 0, -0.2,
                                 1.2]) + "</Matrix>"),
    "matrix34": ('<Matrix inBitDepth="32f" outBitDepth="10i">'
                 + _array("3 4", [1023, 0, 0, 102.3, 0, 511.5, 0, 0, 10, 0,
                                  1000, -5]) + "</Matrix>"),
    "range-clamp": ('<Range inBitDepth="32f" outBitDepth="32f">'
                    "<minInValue>0.1</minInValue><maxInValue>0.9</maxInValue>"
                    "<minOutValue>0.0</minOutValue>"
                    "<maxOutValue>1.0</maxOutValue></Range>"),
    "range-noclamp": ('<Range inBitDepth="32f" outBitDepth="32f" '
                      'style="noClamp"><minInValue>0.1</minInValue>'
                      "<maxInValue>0.9</maxInValue><minOutValue>0.0"
                      "</minOutValue><maxOutValue>1.0</maxOutValue></Range>"),
    "range-min": ('<Range inBitDepth="32f" outBitDepth="32f">'
                  "<minInValue>0.2</minInValue></Range>"),
}
for style in ("basicFwd", "basicRev", "basicMirrorFwd", "basicMirrorRev",
              "basicPassThruFwd", "basicPassThruRev"):
    NODES[f"exp-{style}"] = (
        f'<Exponent inBitDepth="32f" outBitDepth="32f" style="{style}">'
        '<ExponentParams channel="R" exponent="2.2"/>'
        '<ExponentParams channel="G" exponent="1.8"/>'
        '<ExponentParams channel="B" exponent="2.6"/></Exponent>')
for style in ("monCurveFwd", "monCurveRev", "monCurveMirrorFwd",
              "monCurveMirrorRev"):
    NODES[f"exp-{style}"] = (
        f'<Exponent inBitDepth="32f" outBitDepth="32f" style="{style}">'
        '<ExponentParams exponent="2.4" offset="0.055"/></Exponent>')
for style in ("log2", "log10", "antiLog2", "antiLog10"):
    NODES[f"log-{style}"] = _log(style)
NODES["log-linToLog"] = _log("linToLog", {
    "base": 10, "logSideSlope": 0.25, "logSideOffset": 0.6,
    "linSideSlope": 1.2, "linSideOffset": 0.01})
NODES["log-logToLin"] = _log("logToLin", {
    "base": 10, "logSideSlope": 0.25, "logSideOffset": 0.6,
    "linSideSlope": 1.2, "linSideOffset": 0.01})
NODES["log-cameraLinToLog"] = _log("cameraLinToLog", CAMERA)
NODES["log-cameraLogToLin"] = _log("cameraLogToLin", CAMERA)
for style in ("Fwd", "Rev", "FwdNoClamp", "RevNoClamp"):
    NODES[f"cdl-{style}"] = (
        f'<ASC_CDL inBitDepth="32f" outBitDepth="32f" style="{style}">'
        "<SOPNode><Slope>1.1 0.95 1.05</Slope><Offset>-0.02 0.01 0.03"
        "</Offset><Power>1.2 0.9 1.05</Power></SOPNode>"
        "<SatNode><Saturation>1.3</Saturation></SatNode></ASC_CDL>")


def _inputs(name):
    """Seeded (3, 8, 128) values across each node's domain, with the
    breaks and the ends among them."""
    rng = np.random.default_rng(len(name))
    x = rng.uniform(-0.1, 1.1, (3, 8, 128))
    special = {
        "exp-mon": [0.0, 0.0031308, 0.04045, 0.04045 * 1.0001, 1.0],
        "log-camera": [0.0078125, 0.0078124, 0.155251, 0.0729055, 1.0],
        "lut1d": list(np.linspace(0.0, 1.0, 17)) + [-0.5, 1.5],
        "lut3d": list(np.linspace(0.0, 1.0, 5)),
        "range": [0.1, 0.9, 0.2, 0.0999, 0.9001],
        "log-anti": [-2.0, 0.5, 3.0],
    }
    for key, vals in special.items():
        if name.startswith(key):
            v = np.asarray(vals, np.float64)
            x[:, 0, : v.size] = v
    if name.startswith(("log-log2", "log-log10", "log-linToLog")):
        x[:, 1] = rng.uniform(1e-12, 1e-3, (3, 128))
    return x.astype(np.float32)


@pytest.mark.parametrize("name", list(NODES))
def test_clf_node_matches_reference(tmp_path, name):
    path = _write(str(tmp_path / "n.clf"), NODES[name])
    sigs, arrays = clf.load_clf(path)
    ref_sigs, ref_arrays = rclf.load_clf(path)
    assert sigs == ref_sigs
    for ours, ref in zip(arrays, ref_arrays):
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    x = _inputs(name)
    out = clf.apply_clf(torch.from_numpy(x), sigs, [
        [torch.as_tensor(a) for a in arrs] for arrs in arrays]).numpy()
    ref = np.asarray(rclf.apply_clf(jnp.asarray(x), ref_sigs, ref_arrays))
    _close(out, ref, 2e-6)


def test_p3_clf_matches_reference(tmp_path):
    path = str(tmp_path / "look.clf")
    write_clf(path, n=9)
    with open(path, "rb") as f, gzip.open(str(tmp_path / "look.clfz"),
                                          "wb") as g:
        g.write(f.read())
    x = np.random.default_rng(5).uniform(0.0, 1.2, (3, 16, 64)).astype(
        np.float32)
    for p in (path, str(tmp_path / "look.clfz")):
        sigs, arrays = clf.load_clf(p)
        ref_sigs, ref_arrays = rclf.load_clf(p)
        assert sigs == ref_sigs and [s[0] for s in sigs] == [
            "log", "lut3d", "matrix", "exponent"]
        out = clf.apply_clf(torch.from_numpy(x), sigs, [
            [torch.as_tensor(a) for a in arrs] for arrs in arrays]).numpy()
        _close(out, rclf.apply_clf(jnp.asarray(x), ref_sigs, ref_arrays),
               2e-6)


PARAMS_TEXT = """
// @ART-param: ["f", "Float", -1.0, 1.0, 0.25, 0.05]
// @ART-param: ["i", "Int", -10, 10]
// @ART-param: ["flag", "Bool", true]
// @ART-param: ["choice", "Choice", ["A", "B", "C"], 1]
// @ART-colorspace: "acescg"
// @ART-lut: 12
void ART_main(varying float r, varying float g, varying float b,
              output varying float ro, output varying float go,
              output varying float bo,
              float f, int i, bool flag, int choice, float extra = 0.5)
{
    float k = 1.0;
    if (flag) { k = 1.0 + f; }
    ro = r * k + i * 0.01;
    go = g > 0.5 ? g * extra : fmod(g * 7.0, 0.3);
    bo = choice == 1 ? clamp(b, 0.1, 0.6) : b;
}
"""

SCRIPTS = {"simple": SIMPLE, "funcs": FUNCS, "loops": LOOPS,
           "params": PARAMS_TEXT, "p3": CTL_TEXT}


def _load(tmp_path, mod, name):
    p = tmp_path / f"{name}.ctl"
    p.write_text(SCRIPTS[name])
    return mod.load_ctl(str(p))


@pytest.mark.parametrize("values", [None, {"gain": 3.0, "enable": 0.0,
                                           "contrast": 1.6, "warmth": -0.5,
                                           "f": -0.4, "flag": 0.0,
                                           "choice": 2.0}],
                         ids=["defaults", "set"])
@pytest.mark.parametrize("name", list(SCRIPTS))
def test_ctl_script_matches_reference(tmp_path, name, values):
    ours, ref = _load(tmp_path, ctl, name), _load(tmp_path, rctl, name)
    assert [vars(p) for p in ours.params] == [vars(p) for p in ref.params]
    assert (ours.label, ours.colorspace, ours.lut_dim) == (
        ref.label, ref.colorspace, ref.lut_dim)
    rng = np.random.default_rng(9)
    x = rng.uniform(-0.2, 1.5, (3, 512)).astype(np.float32)
    x[:, :8] = [0.0, 1e-7, 0.18, 1.0, -0.1, 16.5, 40.0, 0.5]
    outs = ours(*torch.from_numpy(x), values)
    refs = ref(*jnp.asarray(x), values)
    for o, r in zip(outs, refs):
        o = o.numpy() if torch.is_tensor(o) else np.full(512, o)
        _close(o, np.broadcast_to(np.asarray(r), (512,)), 1e-5)


def test_shaper_matches_reference():
    x = np.linspace(0.0, 1.0, 4097, dtype=np.float32)
    inv = ctl.ctl_shaper(torch.from_numpy(x), inv=True)
    ref_inv = rctl.ctl_shaper(jnp.asarray(x), inv=True)
    _close(inv.numpy(), ref_inv, 1e-5)
    _close(ctl.ctl_shaper(inv).numpy(), rctl.ctl_shaper(ref_inv), 1e-5)


@pytest.mark.parametrize("dim", [None, 9])
def test_bake_lut_matches_reference(tmp_path, dim):
    ours, ref = _load(tmp_path, ctl, "p3"), _load(tmp_path, rctl, "p3")
    values = {"contrast": 1.4, "warmth": 0.3}
    got = ctl.bake_lut(ours, values, dim)
    want = rctl.bake_lut(ref, values, dim)
    assert got.shape == want.shape == ((dim or 32),) * 3 + (3,)
    assert got.dtype == np.float32
    _close(got, want, 1e-5)
