"""The batch queue of art_tpu_torch (config 5) on the CPU, case by case
as tests/test_batch.py holds the reference's, with two CPU workers
(`devices=["cpu", "cpu"]`) over 64x96 DNGs from `dngwrite`:

- every job is written, with more jobs than workers;
- the queue's output equals `process_image`'s: a JPEG's entropy-coded
  scan byte for byte (the queue's files carry no metadata, as the
  reference's), a PNG's pixels;
- on 33 jobs the frames held at once stay within the window, and the
  window is smaller than the catalog;
- `BatchQueue` persists its jobs and resumes only the pending ones;
- a broken file and a step the port refuses each give False, the others
  True; a failure on a device raises once the queue has drained;
- with no devices named and no CUDA, `process_batch` raises;
- `cli.main` with `--devices 2` over several inputs writes every output
  (with the serial path's -Y check), and `dryrun.run(2, device="cpu")`;
- a stress run of eight workers with a short switch interval;
- config 5's plan at 256x1024 equals the reference's (config, and data
  to rtol 1e-6), with the fused denoise head and no tone curve
  (`fusion_gates` (True, False)).
"""

import dataclasses
import importlib
import os
import struct
import sys
import threading

import numpy as np
import pytest
import torch

from art_tpu_torch.core.image import synthesize_bayer
from art_tpu_torch.io.dngwrite import write_dng
from art_tpu_torch.io.imagefile import write_png
from art_tpu_torch.params import ProcParams
from art_tpu_torch.parallel import BatchQueue, process_batch
from art_tpu_torch.parallel import queue as tqueue
from art_tpu_torch.pipeline import develop as tdev

CPU2 = ["cpu", "cpu"]


def make_dngs(tmp_path, n):
    paths = []
    rng = np.random.default_rng(1)
    for i in range(n):
        rgb = rng.uniform(0.1, 0.8, size=(3, 64, 96))
        syn = synthesize_bayer(rgb, black=512, white=16383)
        p = tmp_path / f"img{i}.dng"
        write_dng(p, syn.cfa.astype(np.uint16), black=512, white=16383,
                  cam_mul=(2.0, 1.0, 1.5), compress=True)
        paths.append(p)
    return paths


def bilinear():
    pp = ProcParams()
    pp.raw.bayer.method = "bilinear"
    return pp


def scan(path):
    """A JPEG's bytes from its SOS marker on."""
    data = open(path, "rb").read()
    pos = 2
    while data[pos + 1] != 0xDA:
        pos += 2 + struct.unpack_from(">H", data, pos + 2)[0]
    return data[pos:]


def test_process_batch_writes_every_job(tmp_path):
    paths = make_dngs(tmp_path, 10)  # more jobs than workers
    jobs = [(str(p), ProcParams(), str(tmp_path / f"out{i}.jpg"))
            for i, p in enumerate(paths)]
    seen = []
    results = process_batch(jobs, devices=CPU2,
                            progress=lambda i, o: seen.append((i, o)))
    assert results == [True] * 10
    assert sorted(seen) == [(i, j[2]) for i, j in enumerate(jobs)]
    for i in range(10):
        assert (tmp_path / f"out{i}.jpg").stat().st_size > 0


@pytest.mark.parametrize("ext", ["jpg", "png"])
def test_batch_output_equals_process_image(tmp_path, ext):
    paths = make_dngs(tmp_path, 3)
    jobs = [(str(p), ProcParams(), str(tmp_path / f"b{i}.{ext}"))
            for i, p in enumerate(paths)]
    assert all(process_batch(jobs, devices=CPU2))
    for i, p in enumerate(paths):
        single = str(tmp_path / f"single{i}.{ext}")
        tdev.process_image(str(p), ProcParams(), output_path=single,
                           device="cpu")
        if ext == "jpg":
            assert scan(jobs[i][2]) == scan(single)
        else:
            Image = pytest.importorskip("PIL.Image")
            np.testing.assert_array_equal(
                np.asarray(Image.open(jobs[i][2])),
                np.asarray(Image.open(single)))


def test_batch_streaming_bounded_memory(tmp_path):
    paths = make_dngs(tmp_path, 33)
    jobs = [(str(p), bilinear(), str(tmp_path / f"s{i}.jpg"))
            for i, p in enumerate(paths)]
    stats = {}
    results = process_batch(jobs, devices=CPU2, prefetch=2, stats=stats)
    assert all(results)
    assert stats["window"] == 4
    assert 1 <= stats["peak_in_flight"] <= stats["window"] < len(jobs)
    assert sorted(stats["stage_seconds"]) == sorted(tqueue.STAGES)
    assert all(v > 0 for v in stats["stage_seconds"].values())


def test_batch_queue_persistence(tmp_path):
    paths = make_dngs(tmp_path, 3)
    qfile = tmp_path / "queue.json"
    q = BatchQueue(str(qfile))
    for i, p in enumerate(paths):
        q.add(str(p), str(tmp_path / f"q{i}.jpg"),
              "[RAW Bayer]\nMethod=bilinear\n" if i else "")
    assert len(q.pending()) == 3
    # reload from disk (restart semantics, batchqueue.cc:287-332)
    q2 = BatchQueue(str(qfile))
    assert q2.jobs == q.jobs and len(q2.pending()) == 3
    q2.mark_done(q2.jobs[0])
    q3 = BatchQueue(str(qfile))
    assert len(q3.pending()) == 2
    # resume: only the pending jobs run
    assert q3.process(devices=CPU2) == [True, True]
    assert not (tmp_path / "q0.jpg").exists()
    assert (tmp_path / "q1.jpg").exists() and (tmp_path / "q2.jpg").exists()
    assert len(BatchQueue(str(qfile)).pending()) == 0


def test_batch_bad_file_and_refused_step_continue(tmp_path, capsys):
    paths = make_dngs(tmp_path, 2)
    bad = tmp_path / "broken.dng"
    bad.write_bytes(b"not a dng")
    # a non-raw input loads and its develop is refused by name, where the
    # reference's plan fails (tests/test_torch_entry.py holds the
    # reference's queue on it)
    refused = tmp_path / "in.png"
    write_png(str(refused), np.full((16, 24, 3), 128, np.uint8))
    jobs = [(str(paths[0]), ProcParams(), str(tmp_path / "g0.jpg")),
            (str(bad), ProcParams(), str(tmp_path / "g1.jpg")),
            (str(refused), ProcParams(), str(tmp_path / "g2.jpg")),
            (str(paths[1]), ProcParams(), str(tmp_path / "g3.jpg"))]
    assert process_batch(jobs, devices=CPU2) == [True, False, False, True]
    assert not (tmp_path / "g1.jpg").exists()
    assert not (tmp_path / "g2.jpg").exists()
    assert "non-raw input" in capsys.readouterr().err


def test_device_failure_raises_after_draining(tmp_path, monkeypatch):
    paths = make_dngs(tmp_path, 2)
    jobs = [(str(paths[i % 2]), bilinear(), str(tmp_path / f"f{i}.jpg"))
            for i in range(8)]
    develop = tqueue._Worker.develop
    calls = []

    def failing(self, *args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("art_amaze_stage1: CUDA error 700 at launch")
        return develop(self, *args)

    monkeypatch.setattr(tqueue._Worker, "develop", failing)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        process_batch(jobs, devices=CPU2)


def test_no_devices_and_no_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths = make_dngs(tmp_path, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        process_batch([(str(paths[0]), ProcParams(),
                        str(tmp_path / "n.jpg"))])
    assert not (tmp_path / "n.jpg").exists()


def test_cli_devices_2_writes_every_output(tmp_path, capsys):
    from art_tpu_torch import cli

    paths = [str(p) for p in make_dngs(tmp_path, 3)]
    out = tmp_path / "out"
    out.mkdir()
    (out / "img1.jpg").write_bytes(b"old")
    argv = ["-o", str(out) + os.sep, "--devices", "2", "-c", *paths]
    # without -Y the existing output is skipped, as in the serial path
    assert cli.main(argv, device="cpu") == 0
    assert (out / "img1.jpg").read_bytes() == b"old"
    err = capsys.readouterr()
    assert "img1.jpg exists (use -Y)" in err.err
    assert err.out.count("-> ") == 2
    assert cli.main(["-Y", *argv], device="cpu") == 0
    for i in range(3):
        assert scan(out / f"img{i}.jpg")  # a full JPEG
    # a missing file fails its job: exit 2, the others written
    rc = cli.main(["-Y", "-o", str(out) + os.sep, "--devices", "2", "-c",
                   paths[0], str(tmp_path / "missing.dng")], device="cpu")
    assert rc == 2


def test_dryrun_on_two_cpu_workers(capsys):
    from art_tpu_torch.parallel import dryrun

    stats = dryrun.run(2, device="cpu")
    assert stats["peak_in_flight"] <= stats["window"] == 4
    assert "dryrun: OK on 2 cpu workers" in capsys.readouterr().out


def test_dryrun_refuses_missing_cuda_devices(monkeypatch):
    from art_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices"):
        dryrun.run(2)


def test_stress_eight_workers_short_switch_interval(tmp_path):
    paths = make_dngs(tmp_path, 2)
    jobs = [(str(paths[i % 2]), bilinear(), str(tmp_path / f"x{i}.jpg"))
            for i in range(24)]
    got, stats, seen = {}, {}, []
    lock = threading.Lock()

    def progress(i, o):
        with lock:
            seen.append(i)

    def go():
        got["r"] = process_batch(jobs, devices=["cpu"] * 8, prefetch=1,
                                 stats=stats, progress=progress)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=go, daemon=True)
        t.start()
        t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive()
    assert got["r"] == [True] * 24
    assert sorted(seen) == list(range(24))
    assert stats["peak_in_flight"] <= stats["window"] == 9
    first = scan(jobs[0][2])
    assert all(scan(jobs[i][2]) == first for i in range(0, 24, 2))


def test_config5_plan_matches_reference(tmp_path):
    from art_tpu.io.rawfile import load_raw as ref_load_raw
    from art_tpu.params import ProcParams as RefProcParams
    from art_tpu_torch.io.rawfile import load_raw
    from chip_smoke import config5_pp

    jdev = importlib.import_module("art_tpu.pipeline.develop")
    # config 5's DNG as tools/bench_configs.py writes it, at 256x1024
    mosaic = (np.random.default_rng(3).uniform(0.05, 0.9, (256, 1024))
              * 16000 + 500).astype(np.uint16)
    path = str(tmp_path / "c5.dng")
    write_dng(path, mosaic, black=500, white=16500, compress=False)
    cfg, data = tdev.plan(load_raw(path), config5_pp(), out_u8=True)
    ref_cfg, ref_data = jdev.plan(ref_load_raw(path),
                                  config5_pp(RefProcParams()), out_u8=True)
    for f in dataclasses.fields(ref_cfg):
        assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    assert [s[0] for s in cfg.steps] == ["denoise"]
    assert tdev.fusion_gates(cfg) == (True, False)

    def leaves(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    ours, ref = dict(leaves(data)), dict(leaves(ref_data))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(np.asarray(ours[k]), np.asarray(v),
                                   rtol=1e-6, atol=0, err_msg=k)
