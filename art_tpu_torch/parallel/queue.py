"""Batch queue: persistent jobs and a streaming develop of a catalog
(counterpart of ``art_tpu/parallel/queue.py``).

The reference's semantics (rtgui/batchqueue.cc): jobs persist as JSON
in the queue file and survive restarts; a job is (input path, composed
ProcParams, output path).

Execution on GPUs. The reference groups jobs by compiled config, pads a
group by repeating its last frame and maps it over a device mesh
(`shard_map`, `lax.map`): that exists for XLA's compiles, and none of it
is here. Instead, for each image:

- the calling thread feeds: it takes one of `window` slots (a
  semaphore), so the frames held at once stay O(devices), not
  O(catalog), and hands the job to a host pool of
  `settings.host_threads` threads, which decode it and plan it (`plan`,
  with the device-side u8 output for a JPEG, and `build_run`'s checks);
- one worker thread per device takes planned frames as they come. It
  makes its device current, works on a CUDA stream of its own, stages
  the input in a pinned buffer (a ring of two, each refilled only after
  the event that follows its copy), copies it to the card without
  blocking, runs the program, crops, and reads the output back into a
  pinned buffer (one of `window`, reused only after its encode), then
  waits on an event and hands the array to the encode pool;
- the encode pool (`settings.host_threads` threads) writes the file with
  `io/imagefile.py::save_image`, whose encoder runs in native code with
  the GIL released, and frees the frame's slot.

A per-file failure (an undecodable file, a step the port refuses) makes
that job's result False and the queue goes on. A failure on a device or
in the encoder stops the feed and raises once the frames in flight have
drained. As in the reference, the outputs carry no EXIF, ICC or XMP
(its `save_image` call is bare).
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from art_tpu_torch.settings import settings

# stage_seconds' keys: decode and plan (host clock, per image), the
# host-to-device copy with its staging, the device program with the
# crop, the readback (CUDA events on the worker's stream; the host clock
# on a CPU device), and the encode with the file write (host clock)
STAGES = ("decode", "h2d", "device", "d2h", "encode")


class BatchQueue:
    """Persistent job queue (batchqueue.cc save/load semantics)."""

    def __init__(self, path=None):
        self.path = path
        self.jobs: list[dict] = []
        if path and os.path.exists(path):
            self.load()

    def add(self, input_path, output_path, params_text=""):
        self.jobs.append({
            "input": str(input_path),
            "output": str(output_path),
            "params": params_text,
            "done": False,
        })
        if self.path:
            self.save()

    def pending(self):
        return [j for j in self.jobs if not j["done"]]

    def mark_done(self, job):
        job["done"] = True
        if self.path:
            self.save()

    def save(self):
        with open(self.path, "w") as f:
            json.dump(self.jobs, f)

    def load(self):
        with open(self.path) as f:
            self.jobs = json.load(f)

    def process(self, devices=None, progress=None):
        """Develop the pending jobs (`process_batch`) and mark those that
        succeeded done; returns their results."""
        from art_tpu_torch.params import ProcParams

        def make_job(j):
            pp = ProcParams()
            if j["params"]:
                pp.apply_arp_text(j["params"])
            return (j["input"], pp, j["output"], j)

        jobs = [make_job(j) for j in self.pending()]
        results = process_batch(
            [(inp, pp, outp) for inp, pp, outp, _ in jobs],
            devices=devices, progress=progress)
        for (_, _, _, raw), ok in zip(jobs, results):
            if ok:
                self.mark_done(raw)
        return results


def _devices(devices):
    """The workers' devices: every CUDA device when none are named (and
    an error without CUDA: the queue runs on the card unless the caller
    names devices, "cpu" among them)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "process_batch: no devices named and no CUDA device; name "
                "the devices (devices=['cpu', ...]) to run on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("process_batch: no devices")
    return out


class _Worker:
    """One device's side of the queue: its stream, its ring of two pinned
    input buffers and its readback buffers (CUDA), and the develop of one
    planned frame."""

    def __init__(self, device, n_out):
        from art_tpu_torch.pipeline.develop import PinnedBuffer

        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            # the kernel libraries launch on the thread's current device
            torch.cuda.set_device(device)
            self.stream = torch.cuda.Stream(device)
            self.ins = [(PinnedBuffer(), torch.cuda.Event())
                        for _ in range(2)]
            self.outs = queue_mod.Queue()
            for _ in range(n_out):
                self.outs.put(PinnedBuffer())
        self.count = 0

    def develop(self, run, config, data, host):
        """(host output, its readback buffer or None, {stage: seconds})
        of one planned frame."""
        from art_tpu_torch.pipeline.develop import (crop_result,
                                                    data_to_torch,
                                                    device_input, read_back)

        if not self.cuda:
            t0 = time.monotonic()
            inp = device_input(host, self.device)
            t1 = time.monotonic()
            out = crop_result(run(inp, data_to_torch(data, self.device)),
                              config)
            t2 = time.monotonic()
            out = read_back(out)
            return out, None, {"h2d": t1 - t0, "device": t2 - t1,
                               "d2h": time.monotonic() - t2}
        buf, copied = self.ins[self.count % 2]
        self.count += 1
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with torch.cuda.stream(self.stream):
            # every tensor of this frame is made and used on this stream,
            # so the caching allocator reuses its memory only after the
            # stream's work on it
            copied.synchronize()  # the buffer's last copy is done
            marks[0].record()
            inp = device_input(host, self.device, buf)
            copied.record()
            marks[1].record()
            out = crop_result(run(inp, data_to_torch(data, self.device)),
                              config)
            del inp
            marks[2].record()
            obuf = self.outs.get()  # a buffer whose encode has finished
            out = read_back(out, obuf)
            marks[3].record()
        marks[3].synchronize()
        return out, obuf, {
            name: marks[k].elapsed_time(marks[k + 1]) / 1e3
            for k, name in enumerate(("h2d", "device", "d2h"))}


def process_batch(jobs, devices=None, progress=None, prefetch=2,
                  stats=None):
    """Develop jobs, a list of (input_path, ProcParams, output_path), on
    `devices` (default: every CUDA device; raises without CUDA), one
    worker each; returns a list of bools, one per job.

    progress(i, output_path) is called as job i's file is written.
    prefetch sets the frames held at once, `window = max(n + 1,
    prefetch * n)` for n devices, from the start of a decode to the end
    of its encode. stats, an optional dict, gets "peak_in_flight" (the
    most frames held at once), "window", and "stage_seconds": worker
    seconds by stage (`STAGES`); overlapped, the wall time is nearer the
    largest stage over its threads than their sum."""
    from art_tpu_torch.io import load_image
    from art_tpu_torch.io.imagefile import save_image
    from art_tpu_torch.pipeline.develop import build_run, host_input, plan

    devices = _devices(devices)
    n = len(devices)
    window = max(n + 1, prefetch * n)
    slots = threading.Semaphore(window)
    lock = threading.Lock()
    held, peak = [0], [0]
    stage_s = dict.fromkeys(STAGES, 0.0)
    results = [False] * len(jobs)
    failures: list[BaseException] = []
    ready: queue_mod.Queue = queue_mod.Queue()

    def track(delta):
        with lock:
            held[0] += delta
            peak[0] = max(peak[0], held[0])

    def add(times):
        with lock:
            for name, dt in times.items():
                stage_s[name] += dt

    def release():
        track(-1)
        slots.release()

    def fail(exc):
        with lock:
            failures.append(exc)

    def prepare(idx, job):
        inp, pp, outp = job
        t0 = time.monotonic()
        try:
            frame = load_image(inp)
            # 8-bit JPEG outputs convert to u8 on the device; an auto log
            # encoding renders on a device of the queue's
            config, data = plan(
                frame, pp,
                out_u8=str(outp).lower().endswith((".jpg", ".jpeg")),
                device=devices[idx % n])
            run = build_run(config)
            host = host_input(frame)
        except Exception as e:  # a per-file error doesn't stop the queue
            print(f"batch: {inp}: {type(e).__name__}: {e}", file=sys.stderr)
            release()
            return
        add({"decode": time.monotonic() - t0})
        ready.put((idx, run, config, data, host, outp))

    def encode(idx, out, obuf, outp, worker):
        t0 = time.monotonic()
        try:
            save_image(outp, out.numpy())
            results[idx] = True
            if progress:
                progress(idx, outp)
        except Exception as e:
            fail(e)
        finally:
            if obuf is not None:
                worker.outs.put(obuf)
            add({"encode": time.monotonic() - t0})
            release()

    host_pool = ThreadPoolExecutor(settings.host_threads)
    encode_pool = ThreadPoolExecutor(settings.host_threads)
    encodes = []

    def serve(device):
        try:
            worker = _Worker(device, window)
        except Exception as e:
            fail(e)
            worker = None
        while True:
            item = ready.get()
            if item is None:
                return
            idx, run, config, data, host, outp = item
            if worker is None or failures:  # drain: free the slots
                release()
                continue
            try:
                out, obuf, times = worker.develop(run, config, data, host)
            except Exception as e:
                fail(e)
                release()
                continue
            add(times)
            encodes.append(encode_pool.submit(encode, idx, out, obuf, outp,
                                              worker))

    threads = [threading.Thread(target=serve, args=(d,), daemon=True,
                                name=f"batch-{d}") for d in devices]
    for t in threads:
        t.start()
    prepares = []
    try:
        for idx, job in enumerate(jobs):
            slots.acquire()
            if failures:
                slots.release()
                break
            track(+1)
            prepares.append(host_pool.submit(prepare, idx, job))
        for f in prepares:
            f.result()
    finally:
        for _ in threads:
            ready.put(None)
        for t in threads:
            t.join()
        host_pool.shutdown(wait=True)
        encode_pool.shutdown(wait=True)
    for f in encodes:
        f.result()
    if failures:
        raise failures[0]
    if stats is not None:
        stats["peak_in_flight"] = peak[0]
        stats["window"] = window
        stats["stage_seconds"] = dict(stage_s)
    return results
