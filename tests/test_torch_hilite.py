"""Highlight recovery of art_tpu_torch against `art_tpu/raw/hilite.py` and
`hilite_inpaint.py` on the same demosaiced planes of a frame with blown
highlights: ColorSoft (`recover_opposed`), Color (`recover_inpaint`) and
Blend (`recover_blend`); their plan; Blend's closed fused head; and a
develop of each mode with the denoise (each mode's function changes the
image: `test_recovery_matches_reference`).
"""

import dataclasses
import importlib

import numpy as np
import pytest

from art_tpu.params import ProcParams
from art_tpu_torch.params import ProcParams as TorchProcParams
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import clipped_frame, parity

jdev = importlib.import_module("art_tpu.pipeline.develop")

# a function's output in the 0..65535 domain: relative to full scale
# (the global chroma sum of ColorSoft runs in another float32 order,
# the Color fill's 64 diffusion steps and bilinear weights round
# differently)
FN_ATOL = 65535.0 * 1e-5

MODES = {"ColorSoft": "opposed", "Color": "inpaint", "Blend": "blend"}
DENOISE = "[Denoise]\nEnabled=true\nLuminance=20\nChrominance=20\n"


@pytest.fixture(scope="module")
def frame():
    return clipped_frame(64, 96, seed=3, share=0.15)


def pp_of(cls, mode, extra=""):
    pp = cls()
    pp.raw.bayer.method = "bilinear"
    pp.exposure.hrmode = mode
    pp.apply_arp_text(extra)
    return pp


def demosaiced(frame, data):
    """The padded bilinear planes before the multipliers, and the plan's
    data as tensors."""
    from art_tpu_torch.demosaic.bilinear import bayer_bilinear
    from art_tpu_torch.raw.preprocess import apply_scale

    d = tdev.data_to_torch(data, "cpu")
    cfa = apply_scale(tdev.upload(frame, "cpu").float(), d["raw_offset"],
                      d["raw_scale"])
    return bayer_bilinear(cfa, frame.pattern), d


@pytest.mark.parametrize("mode", list(MODES))
def test_plan_matches_reference(frame, mode):
    cfg, data = tdev.plan(frame, pp_of(TorchProcParams, mode, DENOISE))
    ref_cfg, ref_data = jdev.plan(frame, pp_of(ProcParams, mode, DENOISE))
    for f in dataclasses.fields(ref_cfg):
        assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    assert (cfg.hl_mode, cfg.do_clip) == (MODES[mode], False)
    for k in ("hl_scale_mul", "hl_wb_cam", "hl_max", "rgb_mults"):
        np.testing.assert_allclose(data[k], ref_data[k], rtol=1e-6, atol=0)
    # with the clip off (and Blend after the multipliers) the raw head
    # leaves B4, which takes it with the recovery off
    assert tdev.fusion_gates(cfg)[0] is False
    off, _ = tdev.plan(frame, pp_of(TorchProcParams, "Off", DENOISE))
    assert tdev.fusion_gates(off)[0] is True


@pytest.mark.parametrize("mode", list(MODES))
def test_recovery_matches_reference(frame, mode):
    import jax.numpy as jnp
    from art_tpu.raw import hilite as jhl
    from art_tpu.raw import hilite_inpaint as jhi
    from art_tpu_torch.raw import hilite as thl
    from art_tpu_torch.raw import hilite_inpaint as thi

    _, data = tdev.plan(frame, pp_of(TorchProcParams, mode))
    rgb, d = demosaiced(frame, data)
    if mode == "Blend":
        x = rgb * d["rgb_mults"][:, None, None]
        got = thl.recover_blend(x, d["hl_max"])
        want = jhl.recover_blend(jnp.asarray(x.numpy()), data["hl_max"])
    else:
        tfn, jfn = ((thl.recover_opposed, jhl.recover_opposed)
                    if mode == "ColorSoft"
                    else (thi.recover_inpaint, jhi.recover_inpaint))
        x = rgb
        got = tfn(x, d["hl_scale_mul"], d["hl_wb_cam"])
        want = jfn(jnp.asarray(x.numpy()), data["hl_scale_mul"],
                   data["hl_wb_cam"])
    got, want = got.numpy(), np.asarray(want)
    changed = np.abs(want - x.numpy()) > 1.0
    assert changed.mean() > 0.005, changed.mean()  # it recovered something
    np.testing.assert_allclose(got, want, rtol=0, atol=FN_ATOL)


def test_opposed_reads_the_pad_as_the_reference(frame):
    # the global chroma offset sums over the padded plane: the same pad
    # contents give the same offset
    import jax.numpy as jnp
    from art_tpu.raw import hilite as jhl
    from art_tpu_torch.raw import hilite as thl

    _, data = tdev.plan(frame, pp_of(TorchProcParams, "ColorSoft"))
    rgb, d = demosaiced(frame, data)
    assert rgb.shape[1:] == (128, 128)
    rgb = rgb.clone()
    rgb[:, 64:, :] *= 1.5  # brighter pad rows move the offset
    got = thl.recover_opposed(rgb, d["hl_scale_mul"], d["hl_wb_cam"])
    want = jhl.recover_opposed(jnp.asarray(rgb.numpy()),
                               data["hl_scale_mul"], data["hl_wb_cam"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FN_ATOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_develop_matches_reference(frame, mode):
    out = tdev.develop(frame, pp_of(TorchProcParams, mode, DENOISE),
                       device="cpu").numpy()
    ref = np.asarray(jdev.develop(frame, pp_of(ProcParams, mode, DENOISE)))
    st = parity(out, ref)
    print(mode, st)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st
