"""Dry run of the batch queue over several devices (counterpart of
``art_tpu/parallel/dryrun.py``'s second gate, the production path):
`process_batch` develops two tiny DNG files per device, written to a
temporary directory, and every job must succeed, write its file and
keep the frames held within the queue's window.

    python -m art_tpu_torch.parallel.dryrun N

runs it over the first N CUDA devices and raises if fewer are visible;
``run(n, device="cpu")`` runs n workers on the CPU.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np


def run(n_devices: int, device: str = "cuda") -> dict:
    """The queue over n_devices workers on `device` ("cuda": the first
    n_devices CUDA devices; "cpu": n_devices workers on the CPU); returns
    its stats."""
    import torch

    from art_tpu_torch.core.image import synthesize_bayer
    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.params import ProcParams
    from art_tpu_torch.parallel.queue import process_batch

    if device == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n_devices:
            raise RuntimeError(f"need {n_devices} CUDA devices, {count} "
                               "visible")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    else:
        devices = [device] * n_devices

    # a cheap but real config: the full plan and device program with the
    # bilinear demosaic; the gate is the queue, not the kernels
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0.02, 0.95, size=(3, 64, 96))
    mosaic = synthesize_bayer(rgb.astype(np.float32), pattern="RGGB").cfa
    with tempfile.TemporaryDirectory() as td:
        jobs = []
        for i in range(2 * n_devices):
            p = os.path.join(td, f"in_{i}.dng")
            write_dng(p, np.round(mosaic).astype(np.uint16), pattern="RGGB",
                      black=512, white=16383)
            pp = ProcParams()
            pp.raw.bayer.method = "bilinear"
            jobs.append((p, pp, os.path.join(td, f"out_{i}.png")))
        stats: dict = {}
        oks = process_batch(jobs, devices=devices, stats=stats)
        if not all(oks):
            raise RuntimeError(f"dryrun: a job failed: {oks}")
        missing = [j[2] for j in jobs if not os.path.isfile(j[2])]
        if missing:
            raise RuntimeError(f"dryrun: outputs not written: {missing}")
        if stats["peak_in_flight"] > stats["window"]:
            raise RuntimeError(f"dryrun: frames held beyond the window: "
                               f"{stats}")
    print(f"dryrun: OK on {n_devices} {device} workers ({devices}); queue "
          f"{len(jobs)} jobs, peak in flight {stats['peak_in_flight']} of "
          f"window {stats['window']}")
    return stats


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 1)
