"""Tuning builds of kernel B1 (``s1_tile`` in ``csrc/amaze.cu``) on the card.

    python -m art_tpu_torch.demosaic.tune_stage1

Builds variants of the source, each a text replacement in it: other walk
lengths (K1-K4) or thread counts, or an early return before a phase (so
the times read the phases' cumulative cost), one nvcc each with the
package's flags, all at once. Each full variant is held against
`stage1_plain` on a plane of the flagship's padded size (4144 x 6064),
and every variant is timed by CUDA events (20 calls) in three rounds of
alternating order. To re-tune B1, add a variant here, run this on the
card and copy the fastest constants into the source. The builds go to a
temporary directory under ``_build/`` and are removed.
"""

from __future__ import annotations

import ctypes
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from art_tpu_torch import kernels
from art_tpu_torch.demosaic import amaze
from art_tpu_torch.demosaic import amaze_kernel as ak

SOURCE = kernels.SRC_DIR / "amaze.cu"
WALKS = "constexpr int K1 = 8, K2 = 6, K3 = 5, K4 = 4;"
THREADS = "constexpr int S1_THREADS = 512;"
SHAPE = (4144, 6064)


def _stop(marker):
    """An early return just before the phase that starts at `marker`."""
    return [(marker, "  if (STOP_HERE) return;\n" + marker),
            ("namespace {", "namespace {\nconstexpr bool STOP_HERE = true;")]


# name -> text replacements (old, new) in the source
VARIANTS = {
    "as built": [],
    "walks 12/7/5/4": [(WALKS, "constexpr int K1 = 12, K2 = 7, K3 = 5, "
                        "K4 = 4;")],
    "walks 8/8/5/4": [(WALKS, "constexpr int K1 = 8, K2 = 8, K3 = 5, "
                       "K4 = 4;")],
    "walks 8/6/10/4": [(WALKS, "constexpr int K1 = 8, K2 = 6, K3 = 10, "
                        "K4 = 4;")],
    "walks 16/6/5/8": [(WALKS, "constexpr int K1 = 16, K2 = 6, K3 = 5, "
                        "K4 = 8;")],
    "768 threads": [(THREADS, "constexpr int S1_THREADS = 768;")],
    "up to the copy of x": _stop("  // stage 1: the gradient weights"),
    "up to stage 1": _stop("  // stage 2 over the cross of the cd planes"),
    "up to stage 2": _stop("  // stage 3: the selected, bounded vcd"),
    "up to stage 3": _stop("  // stage 4 -> vcd, hcd, hvwt"),
}


def build(directory):
    """Each variant's art_amaze_stage1 and its s1_tile layout line."""
    src = SOURCE.read_text()
    jobs = []
    for i, reps in enumerate(VARIANTS.values()):
        text = src
        for old, new in reps:
            if old not in text:
                raise RuntimeError(f"not in {SOURCE.name}: {old!r}")
            text = text.replace(old, new, 1)
        cu = directory / f"v{i}.cu"
        cu.write_text(text)
        jobs.append((directory / f"libv{i}.so", [cu]))
    kernels._compile(jobs)
    out = {}
    for name, (so, _) in zip(VARIANTS, jobs):
        lib = ctypes.CDLL(str(so))
        fn = lib.art_amaze_stage1
        fn.argtypes = kernels.SIGNATURES["art_amaze_stage1"][1]
        buf = ctypes.create_string_buffer(1024)
        kernels.check(lib.art_amaze_layout(buf, len(buf)), "layout")
        out[name] = (fn, buf.value.decode().splitlines()[0])
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tune_stage1: needs a CUDA device")
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    directory = tempfile.mkdtemp(dir=kernels.BUILD_DIR, prefix="tune_")
    try:
        variants = build(Path(directory))
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.uniform(0.0, 1.0, SHAPE).astype(
            np.float32)).cuda()
        clips = amaze.clip_points(np.float32(1.0), "cuda")
        want = amaze.stage1_plain(x, "RGGB", clips)
        pat = ak.pattern_code("RGGB")
        out = torch.empty_like(want)

        def run(fn):
            kernels.check(fn(x.data_ptr(), clips.data_ptr(), out.data_ptr(),
                             *SHAPE, pat, kernels.stream_of(x)), "s1_tile")

        times = {name: [] for name in variants}
        for rnd in range(3):
            names = list(variants)[::1 if rnd % 2 == 0 else -1]
            for name in names:
                fn, layout = variants[name]
                run(fn)
                torch.cuda.synchronize()
                if rnd == 0:
                    equal = "" if name.startswith("up to") else \
                        f"; equals stage1_plain {torch.equal(out, want)}"
                    print(f"{name}: {layout}{equal}")
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    run(fn)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / 20)
        for name, ms in times.items():
            print(f"{name:22s} ms a call: "
                  + ", ".join(f"{t:.4f}" for t in ms))
    finally:
        shutil.rmtree(directory)


if __name__ == "__main__":
    main()
