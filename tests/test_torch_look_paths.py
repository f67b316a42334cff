"""chip_smoke.py's look paths at a small size, art_tpu_torch on the CPU
against `art_tpu`: L1, a colour grade (spot, AMaZE, denoise, HSL,
defringe, colour correction, smoothing with NLMeans and a glow, grain,
the gradients, texture boost, automatic log encoding, the Neutral curve,
Lab adjustments) and L2, a scanned colour negative (film negative,
Fattal, a FilmLike curve, B&W), each with the steps and fusion gates
the reference plans; the reference's plan of L1 on the port's program;
the gradients and texture boost on a coarse rotation and crop, where
the ops meet the rotated, cropped image (``ctx["op_dims"]``); and
`process_image`, `cli.main` and the queue rendering the automatic log
encoding on the device they were given.

The frames are 96x160, below every kernel tile, so neither side runs a
Pallas kernel (NLMeans takes its whole-plane loop). Each distinct plan
develops once a session (`test_torch_plan.Develops`). Bounds: PERF.md
section 2's (max <= 1/255, mean <= 2e-4, >= 99.9% within one 8-bit
step).
"""

import importlib

import numpy as np
import pytest

from art_tpu.params import ProcParams
from art_tpu_torch.params import ProcParams as TorchProcParams
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import flagship_frame, l1_pp, l2_frame, l2_pp, parity
from tests.test_torch_plan import Develops, plan_key

jdev = importlib.import_module("art_tpu.pipeline.develop")

H, W = 96, 160

PATHS = {
    "L1": (lambda cls: l1_pp(H, W, cls()), lambda: flagship_frame(
        H, W, seed=5),
        ["spot", "denoise", "hsl", "defringe", "colorcorrection",
         "smoothing", "gradients", "textureboost", "logenc", "tonecurve",
         "labadj"]),
    "L2": (lambda cls: l2_pp(cls()), lambda: l2_frame(H, W, seed=5),
           ["filmneg", "fattal", "tonecurve", "bw"]),
}


@pytest.fixture(scope="module")
def develops(tmp_path_factory):
    import os

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    return Develops(root / "look_develops")


def _check(out, ref):
    st = parity(out, ref)
    print(st)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st


@pytest.mark.parametrize("label", list(PATHS))
def test_path_develops_as_the_reference(label, develops):
    make_pp, make_frame, steps = PATHS[label]
    frame = make_frame()
    pp, ref_pp = make_pp(TorchProcParams), make_pp(ProcParams)
    cfg, data = tdev.plan(frame, pp, device="cpu")
    ref_cfg, ref_data = jdev.plan(frame, make_pp(ProcParams))
    assert [s[0] for s in cfg.steps] == [s[0] for s in ref_cfg.steps] \
        == steps
    assert cfg.steps == ref_cfg.steps
    # the spot runs first in stage 0, Lab adjustments after the curve:
    # both fusion gates shut, as in the reference
    assert tdev.fusion_gates(cfg) == (False, False)
    out = develops.get("port", plan_key(cfg, data), lambda: tdev.develop(
        frame, pp, device="cpu").numpy())
    ref = develops.get("ref", plan_key(ref_cfg, ref_data),
                       lambda: jdev.develop(frame, ref_pp))
    assert out.shape == ref.shape == (3, H, W)
    _check(out, ref)


def test_reference_plan_of_l1_through_port_runner(develops):
    # the reference's (config, data), its spot windows' lists and the
    # region ops' nested masks among them, on the port's program
    frame = flagship_frame(H, W, seed=5)
    cfg, data = jdev.plan(frame, l1_pp(H, W, ProcParams()))
    run = tdev.build_run(cfg)
    out = tdev.crop_result(run(tdev.upload(frame, "cpu"),
                               tdev.data_to_torch(data, "cpu")), cfg)
    pp = l1_pp(H, W, TorchProcParams())
    ours_cfg, ours = tdev.plan(frame, pp, device="cpu")
    mine = develops.get("port", plan_key(ours_cfg, ours), lambda: tdev.develop(
        frame, pp, device="cpu").numpy())
    _check(out.numpy(), mine)


GEOMETRY = ("[Coarse Transformation]\nRotate=90\n[Crop]\nEnabled=true\n"
            "X=20\nY=10\nW=64\nH=120\n[Gradient]\nEnabled=true\nDegree=30\n"
            "Strength=1\nCenterX=20\n[PCVignette]\nEnabled=true\n"
            "Strength=1\nRoundness=20\n[Vignetting Correction]\n"
            "Enabled=true\nAmount=30\nCenterY=10\n[TextureBoost]\n"
            "Enabled=true\nStrength_1=0.8\n")


def test_gradients_on_a_rotated_crop_develop_as_the_reference():
    frame = flagship_frame(H, W, seed=6)
    pps = []
    for cls in (TorchProcParams, ProcParams):
        pp = cls()
        pp.raw.bayer.method = "bilinear"
        pp.apply_arp_text(GEOMETRY)
        pps.append(pp)
    cfg, data = tdev.plan(frame, pps[0])
    ref_cfg, _ = jdev.plan(frame, pps[1])
    assert cfg.crop == ref_cfg.crop == (10, 20, 120, 64)
    assert [s[0] for s in cfg.steps] == ["gradients", "textureboost"]
    # the factor fields span the rotated image, sliced to the crop
    assert cfg.steps == ref_cfg.steps
    out = tdev.develop(frame, pps[0], device="cpu").numpy()
    ref = np.asarray(jdev.develop(frame, pps[1]))
    assert out.shape == ref.shape == (3, 120, 64)
    _check(out, ref)


def test_entry_points_render_the_auto_log_on_their_device(tmp_path,
                                                          monkeypatch):
    # process_image, cli.main and the queue pass their device to the
    # plan's auto log render: on this CPU-only machine a render on the
    # default "cuda" would raise, so each develops only if it passes it
    from art_tpu_torch import cli
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.parallel import process_batch
    from art_tpu_torch.pipeline import autos

    frame = flagship_frame(64, 96, seed=7)
    dng = str(tmp_path / "in.dng")
    write_dng(dng, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383)
    arp = tmp_path / "log.arp"
    arp.write_text("[RAW Bayer]\nMethod=bilinear\n[LogEncoding]\n"
                   "Enabled=true\n")
    seen = []
    render = autos.auto_log_params

    def spy(frame, pp, device):
        seen.append(str(device))
        return render(frame, pp, device)

    monkeypatch.setattr(autos, "auto_log_params", spy)
    pp = TorchProcParams()
    pp.apply_arp_text(arp.read_text())
    out = tdev.process_image(dng, pp, output_path=str(tmp_path / "a.jpg"),
                             device="cpu")
    assert out.shape == (64, 96, 3)
    assert cli.main(["-Y", "-p", str(arp), "-o", str(tmp_path / "b.jpg"),
                     "-c", dng], device="cpu") == 0
    assert process_batch([(dng, pp, str(tmp_path / "c.jpg"))],
                         devices=["cpu"]) == [True]
    assert seen == ["cpu"] * 3
    assert pp.logenc.auto_gain  # the caller's ProcParams keeps its autos
