"""Smoke run of art_tpu_torch on one NVIDIA GPU (H100 class).

    python3 chip_smoke.py

Builds the CUDA kernels from art_tpu_torch/csrc (one nvcc per source, all
at once) and drives two paths through the user's entry points, plan ->
develop(device="cuda") -> crop_result, each with the launch and plain-call
counts set to 0 just before it and read just after:

- the main path, the flagship as bench.py defines it: a 4000x6000 RGGB
  mosaic from seed 0, `Standard Film Curve.arp` (AMaZE), denoise at
  luminance/chrominance 20, the Neutral tone curve, sRGB out; kernels B1,
  B2, B3 (AMaZE stages), B4 (wavelet denoise) and B7 (Neutral curve);
- the same frame with bilinear demosaic (B4 and B7).

It checks that every kernel of a path launched and no plain version ran,
that the output is (3, 4000, 6000), finite and in [0, 1], that each
kernel equals its plain PyTorch version on the tensors the main path
feeds it (bounds below), and that a 512x2048 develop on the card agrees
with the same develop on the CPU's plain path, for both demosaics, to
the slice bounds of tests/test_torch_amaze.py. It prints the card's name
and power limit, develop and device-program timings, peak memory, a
torch.profiler table, one JSON line of per-kernel results (time, plain
time, bound) and last the line {"ok": true, "device": {...}}. Any
failure raises (non-zero exit, no result lines); so does a machine
without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# kernel vs plain version, both on the card: the kernels are built
# without FMA contraction and follow the plain versions' operation order
# (the same IEEE division and sqrt, the same libdevice exp), so they agree
# to the last bit; any difference fails
KERNEL_MAX, KERNEL_MEAN = 0.0, 0.0
# slice parity (tests/test_torch_amaze.py, test_torch_develop.py):
# encoded output, card against the CPU plain path
DEV_MAX, DEV_MEAN, DEV_WITHIN = 1.0 / 255.0, 2e-4, 0.999
# the bound of each kernel: H100 SXM data sheet peaks (HBM3 rate, FP32 rate)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

FRAME = (4000, 6000)
PROFILE = "Standard Film Curve.arp"


def log(*a):
    print(*a, flush=True)


def flagship_pp(method):
    from art_tpu_torch.params import ProcParams

    pp = ProcParams()
    arp = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "art_tpu_torch", "data", "profiles", PROFILE)
    with open(arp) as f:
        pp.apply_arp_text(f.read())
    if pp.raw.bayer.method != "amaze":
        raise RuntimeError(f"{PROFILE} plans {pp.raw.bayer.method!r}")
    pp.raw.bayer.method = method
    pp.denoise.enabled = True
    pp.denoise.luminance = 20.0
    pp.denoise.chrominance = 20.0
    return pp


def flagship_frame(h, w, seed=0):
    from art_tpu_torch.core.image import synthesize_bayer

    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0.02, 0.95, size=(3, h, w)).astype(np.float32)
    return synthesize_bayer(rgb, pattern="RGGB")


def gpu_ms(fn, n):
    """Mean ms per call over n calls after one warm call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def diff_stats(a, b):
    d = (a.double() - b.double()).abs()
    return float(d.max()), float(d.mean())


def parity(out, ref):
    d = (out.double() - ref.double()).abs()
    lsb = d * 255.0
    return {"max_lsb8": float(lsb.max()), "mean": float(d.mean()),
            "p999_lsb8": float(torch.quantile(lsb.flatten()[::7], 0.999)),
            "within_1lsb8": float((lsb <= 1.0).double().mean())}


def bound(reads, writes, ops):
    """(bound_ms, bound_by, bytes_ms, ops_ms, ops, naive_ops): each input
    read once and each output written once at the memory rate, against
    the operations the result needs (`opcount.needed_ops`: the taken arm
    of each select, repeats once) at the f32 rate. naive_ops (every
    float op of the plain version, both arms) is printed beside it."""
    ops, naive = ops
    nbytes = sum(t.numel() * t.element_size() for t in (*reads, *writes))
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", t_bytes, t_ops,
            ops, naive)


def counted():
    """name -> (wrapper with .launches, plain version with .calls)."""
    from art_tpu_torch.demosaic import amaze
    from art_tpu_torch.demosaic import amaze_kernel as ak
    from art_tpu_torch.ops import tonecurve_neutral as tn
    from art_tpu_torch.ops import wavelet_kernel as wk

    return {"b1": (ak.amaze_stage1, amaze.stage1_plain),
            "b2": (ak.amaze_stage2, amaze.stage2_plain),
            "b3": (ak.amaze_stage3, amaze.stage3_plain),
            "b4": (wk.wavelet_denoise_rgb, wk.wavelet_rgb_plain),
            "b7": (tn.neutral_tone, tn.neutral_plain)}


def reset_counts():
    for wrapper, plain in counted().values():
        wrapper.launches = 0
        plain.calls = 0


def read_counts():
    c = counted()
    return ({k: w.launches for k, (w, _) in c.items()},
            {k: p.calls for k, (_, p) in c.items()})


def drive(method, frame, kernels_of_path):
    """One develop through the user's entry points, counts from 0; checks
    the launches, the plain calls and the output."""
    from art_tpu_torch.pipeline import develop as tdev

    pp = flagship_pp(method)
    reset_counts()
    t0 = time.monotonic()
    out = tdev.develop(frame, pp)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches, plain_calls = read_counts()
    log(f"{method} develop {FRAME[0]}x{FRAME[1]} (first): {seconds:.3f} s; "
        f"launches {launches}; plain calls {plain_calls}")
    missing = [k for k in kernels_of_path if launches[k] < 1]
    if missing:
        raise RuntimeError(f"{method}: kernels {missing} did not launch")
    if any(plain_calls.values()):
        raise RuntimeError(f"{method}: a plain version ran on the card: "
                           f"{plain_calls}")
    if tuple(out.shape) != (3, *FRAME) or out.device.type != "cuda":
        raise RuntimeError(f"bad output {tuple(out.shape)} on {out.device}")
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{method}: non-finite output")
    lo, hi = float(out.min()), float(out.max())
    if lo < 0.0 or hi > 1.0:
        raise RuntimeError(f"{method}: output outside [0, 1]: {lo} .. {hi}")
    log(f"  output (3, {FRAME[0]}, {FRAME[1]}) finite, range {lo:.6f} .. "
        f"{hi:.6f}, mean {float(out.mean()):.6f}")
    return pp, launches


def device_program(frame, pp):
    """Time the host plan alone, then the device program alone with its
    inputs resident (CUDA events) and its peak memory. Returns the config
    and the device inputs."""
    from art_tpu_torch.pipeline import develop as tdev

    t0 = time.monotonic()
    config, data = tdev.plan(frame, pp)
    log(f"  host plan alone: {1e3 * (time.monotonic() - t0):.1f} ms")
    inp, _ = tdev.pad_to_multiple(frame.cfa, tdev.PAD_MULTIPLE)
    inp_d = torch.from_numpy(inp).to("cuda")
    data_d = tdev.data_to_torch(data, "cuda")
    run = tdev.build_run(config)
    device_ms = gpu_ms(lambda: run(inp_d, data_d), 5)
    torch.cuda.reset_peak_memory_stats()
    run(inp_d, data_d)
    torch.cuda.synchronize()
    log(f"  device program alone (inputs resident), mean of 5: "
        f"{device_ms:.2f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return config, inp_d, data_d


def profile_develop(frame, pp):
    """Device busy time of one end-to-end develop, from torch.profiler,
    and its top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from art_tpu_torch.pipeline import develop as tdev

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        tdev.develop(frame, pp)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    avg = prof.key_averages()
    # device-side events only: a CPU op's entry repeats its kernels' time
    busy_us = sum(e.self_device_time_total for e in avg
                  if e.device_type != DeviceType.CPU)
    log(avg.table(sort_by="self_device_time_total", row_limit=20))
    log(f"profiled develop: wall {wall_ms:.1f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms, idle share "
        f"{1.0 - busy_us / 1e3 / wall_ms:.4f}")


def kernel_entry(name, key, source, replaces, launches, k_out, p_out,
                 ms, plain_ms, bnd):
    err, mean = diff_stats(k_out, p_out)
    log(f"{name}: kernel vs plain at {tuple(k_out.shape)}: max {err:.6g} "
        f"mean {mean:.6g} (bounds {KERNEL_MAX}, {KERNEL_MEAN}); kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms "
        f"({bnd[1]}; bytes {bnd[2]:.4f} ms, {bnd[4]:.4g} operations "
        f"{bnd[3]:.4f} ms; naive count {bnd[5]:.4g})")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1],
            # no single PyTorch call computes any of these functions
            "library_ms": None, "_mean_err": mean}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from art_tpu_torch import kernels
    from art_tpu_torch.demosaic import amaze
    from art_tpu_torch.demosaic import amaze_kernel as ak
    from art_tpu_torch.ops import denoise
    from art_tpu_torch.ops import tonecurve_neutral as tn
    from art_tpu_torch.opcount import needed_ops
    from art_tpu_torch.ops import wavelet_kernel as wk
    from art_tpu_torch.pipeline import develop as tdev
    from art_tpu_torch.raw.preprocess import apply_scale

    t0 = time.monotonic()
    kernels.library()
    log(f"build: {time.monotonic() - t0:.2f} s "
        f"(nvcc {kernels.build_info['seconds']:.2f} s, compiled="
        f"{kernels.build_info['compiled']})")
    for line in kernels.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # ---- the main path: the AMaZE flagship
    t0 = time.monotonic()
    frame = flagship_frame(*FRAME)
    log(f"frame {FRAME[0]}x{FRAME[1]} synthesised in "
        f"{time.monotonic() - t0:.2f} s")
    pp, launches = drive("amaze", frame, ("b1", "b2", "b3", "b4", "b7"))

    times = []
    for _ in range(5):
        t0 = time.monotonic()
        tdev.develop(frame, pp)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    log(f"amaze develop (plan + H2D + device + crop), median of 5: "
        f"{1e3 * float(np.median(times)):.1f} ms "
        f"{[round(1e3 * t, 1) for t in times]}")
    config, inp_d, data_d = device_program(frame, pp)
    profile_develop(frame, pp)

    # ---- the bilinear path (the first slice's)
    pp_bil, _ = drive("bilinear", frame, ("b4", "b7"))
    device_program(frame, pp_bil)

    # ---- kernel phase: each kernel on the tensors the main path feeds it
    pat = config.pattern
    cfa = apply_scale(inp_d.float(), data_d["raw_offset"],
                      data_d["raw_scale"])
    clips = amaze.clip_points(data_d["init_gain"], "cuda")
    x = amaze.padded_plane(cfa)
    entries = []

    def check(key, kern, plain, reads):
        """Kernel and plain version on the same inputs: the entry of the
        kernels line, and the kernel's output."""
        k_out = kern()
        p_out, *ops = needed_ops(plain)
        torch.cuda.synchronize()
        bnd = bound(reads, (k_out,), ops)
        entries.append(kernel_entry(
            f"AMaZE stage {key[1]} ({key.upper()})", key,
            "art_tpu_torch/csrc/amaze.cu",
            "art_tpu/demosaic/amaze_pallas.py:65", launches, k_out, p_out,
            gpu_ms(kern, 10), gpu_ms(plain, 3), bnd))
        return k_out

    s1 = check("b1", lambda: ak.amaze_stage1(x, pat, clips),
               lambda: amaze.stage1_plain(x, pat, clips), (x, clips))
    s2 = check("b2", lambda: ak.amaze_stage2(x, pat, s1),
               lambda: amaze.stage2_plain(x, pat, s1), (x, s1))
    del s1
    k3 = check("b3", lambda: ak.amaze_stage3(x, pat, s2, clips),
               lambda: amaze.stage3_plain(x, pat, s2, clips), (x, s2, clips))
    rgb = amaze._with_border(cfa, pat, k3)
    del s2, x

    dn = dict(data_d["op:denoise"], pre_mults=data_d["rgb_mults"],
              pre_mat=data_d["cam2work"])
    b4_args, b4_kw = denoise.kernel_args(dn, config.steps[0][1])
    b4_args = (rgb,) + b4_args
    plain_args = (rgb,) + wk.prepare(*b4_args, **b4_kw)
    b4_k = wk.wavelet_denoise_rgb(*b4_args, **b4_kw)
    b4_p, *ops = needed_ops(lambda: wk.wavelet_rgb_plain(*plain_args))
    torch.cuda.synchronize()
    entries.append(kernel_entry(
        "wavelet_rgb (B4)", "b4", "art_tpu_torch/csrc/wavelet_rgb.cu",
        "art_tpu/ops/wavelet_pallas.py:311", launches, b4_k, b4_p,
        gpu_ms(lambda: wk.wavelet_denoise_rgb(*b4_args, **b4_kw), 10),
        gpu_ms(lambda: wk.wavelet_rgb_plain(*plain_args), 3),
        bound((rgb,), (b4_k,), ops)))
    del b4_p

    tc = data_d["op:tonecurve"]
    params = torch.cat([tc["params"], data_d["work2out"].reshape(-1)])
    coeffs = tc["coeffs"].reshape(-1, tc["coeffs"].shape[-1])
    epi = config.out_trc[0]
    b7_k = tn.neutral_tone(b4_k, params, coeffs, epi)
    b7_p, *ops = needed_ops(lambda: tn.neutral_plain(b4_k, params, coeffs,
                                                     epi))
    torch.cuda.synchronize()
    entries.append(kernel_entry(
        "neutral_tone (B7)", "b7", "art_tpu_torch/csrc/neutral_tone.cu",
        "art_tpu/ops/tonecurve_neutral.py:384", launches, b7_k, b7_p,
        gpu_ms(lambda: tn.neutral_tone(b4_k, params, coeffs, epi), 20),
        gpu_ms(lambda: tn.neutral_plain(b4_k, params, coeffs, epi), 3),
        bound((b4_k,), (b7_k,), ops)))
    del b7_p, b7_k, b4_k, rgb, cfa

    # ---- small develops: the card against the CPU plain path
    small = flagship_frame(512, 2048, seed=5)
    small_stats = {}
    for method in ("amaze", "bilinear"):
        g = tdev.develop(small, flagship_pp(method)).cpu()
        c = tdev.develop(small, flagship_pp(method), device="cpu")
        small_stats[method] = parity(g, c)
        log(f"512x2048 {method} develop, card vs CPU plain path: "
            f"{small_stats[method]}")

    failures = []
    for e in entries:
        mean_err = e.pop("_mean_err")
        if e["max_abs_err"] > KERNEL_MAX or mean_err > KERNEL_MEAN:
            failures.append(f"{e['name']} disagrees with its plain version")
    for method, st in small_stats.items():
        if (st["max_lsb8"] > DEV_MAX * 255 or st["mean"] > DEV_MEAN
                or st["within_1lsb8"] < DEV_WITHIN):
            failures.append(f"{method}: card develop disagrees with the "
                            f"CPU: {st}")
    if "jax" in sys.modules or "art_tpu" in sys.modules:
        failures.append("jax or art_tpu was imported")
    if failures:
        raise RuntimeError("; ".join(failures))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
