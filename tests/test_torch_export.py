"""The export paths of chip_smoke.py's E1-E3 at a small size, art_tpu_torch
on the CPU against `art_tpu`: E1 the everyday export (AMaZE, Blend,
denoise with the DCT pass, RL sharpening, a quarter turn, a crop, the
resize with USM output sharpening, Adobe RGB), E2 the flagship's fast
export (-q), E3 config 3's denoise in a fast export (the whole-plane
wavelet, DCT pass, guided chroma and NLMeans). Each held to PERF.md's
slice bounds, with the plan each runs; and the reference's plans of
these paths, with every data key the slice adds, on the port's program.
"""

import importlib
import json

import numpy as np
import pytest

from art_tpu.params import ProcParams
from art_tpu_torch.params import ProcParams as TorchProcParams
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import (clipped_frame, e3_pp, export_arp, export_pp,
                        fast_box_arp, flagship_pp, parity)

jdev = importlib.import_module("art_tpu.pipeline.develop")

H, W = 96, 160


def pps(label):
    """This package's and the reference's ProcParams of a path."""
    out = []
    for cls in (TorchProcParams, ProcParams):
        if label == "E1":
            out.append(export_pp(H, W, cls()))
            continue
        pp = flagship_pp("amaze", cls()) if label == "E2" else e3_pp(cls())
        pp.apply_arp_text(fast_box_arp(80))
        out.append(pp)
    return out


# label: (fast, output shape, steps, (fuse_head, fuse_tail))
PATHS = {
    "E1": (False, (3, 55, 33), ["denoise", "sharpen", "tonecurve"],
           (False, False)),
    "E2": (True, (3, 48, 80), ["denoise", "tonecurve"], (False, True)),
    "E3": (True, (3, 48, 80), ["denoise", "impulse"], (False, False)),
}


@pytest.mark.parametrize("label", list(PATHS))
def test_export_develops_as_the_reference(label):
    fast, shape, steps, gates = PATHS[label]
    frame = clipped_frame(H, W, seed=8, share=0.03)
    pp, ref_pp = pps(label)
    cfg, _ = tdev.plan(frame, pp, fast=fast)
    ref_cfg, _ = jdev.plan(frame, ref_pp, fast=fast)
    assert [s[0] for s in cfg.steps] == [s[0] for s in ref_cfg.steps] \
        == steps
    assert (cfg.early_resize is not None) == fast
    assert tdev.fusion_gates(cfg) == gates
    out = tdev.develop(frame, pp, device="cpu", fast=fast).numpy()
    ref = np.asarray(jdev.develop(frame, ref_pp, fast=fast))
    assert out.shape == ref.shape == shape
    st = parity(out, ref)
    print(label, st)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st


# every data key the slice adds: hl_*, op:sharpen with a PSF,
# resize_rows/cols and op:prsharpen (E1 with a JSON PSF), lum_detail_dct,
# early_rows/cols (E3's fast export)
NEW_KEYS = {"E1": ("hl_scale_mul", "hl_wb_cam", "hl_max", "resize_rows",
                   "resize_cols", "op:prsharpen/amount", "op:sharpen/psf",
                   "op:denoise/lum_detail_dct"),
            "E3": ("early_rows", "early_cols", "op:denoise/lum_detail_dct")}


@pytest.mark.parametrize("label", list(NEW_KEYS))
def test_reference_plan_through_port_runner(tmp_path, label):
    # the reference's (config, data) on the port's program, against the
    # port's own plan and program: separates planning from the device
    k = np.exp(-0.5 * (np.arange(-2, 3)[:, None] ** 2
                       + np.arange(-2, 3)[None, :] ** 2))
    (tmp_path / "psf.json").write_text(json.dumps(k.tolist()))
    text = (export_arp(H, W) + "[Sharpening]\nMethod=psf\nPSFKernel="
            f"{tmp_path / 'psf.json'}\nPSFIterations=5\n"
            if label == "E1" else fast_box_arp(80))
    frame = clipped_frame(H, W, seed=8, share=0.03)
    out = []
    for cls, planner in ((ProcParams, jdev.plan),
                         (TorchProcParams, tdev.plan)):
        pp = cls() if label == "E1" else e3_pp(cls())
        if label == "E1":
            flagship_pp("amaze", pp)
        pp.apply_arp_text(text)
        config, data = planner(frame, pp, fast=label == "E3")
        leaves = {f"{a}/{b}" if isinstance(v, dict) else a
                  for a, v in data.items()
                  for b in (v if isinstance(v, dict) else [None])}
        assert set(NEW_KEYS[label]) <= leaves
        run = tdev.build_run(config)
        out.append(tdev.crop_result(run(tdev.upload(frame, "cpu"),
                                        tdev.data_to_torch(data, "cpu")),
                                    config).numpy())
    assert out[0].shape == out[1].shape
    st = parity(out[0], out[1])
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st
