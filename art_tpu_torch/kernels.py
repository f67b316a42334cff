"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
`ctypes`; the compilers of all sources run at once. Such a build takes
seconds; one that includes PyTorch's headers takes minutes. The
libraries go to ``art_tpu_torch/_build/`` under names that carry a hash
of the source and the flags, so an edited source rebuilds on its next
use and an unchanged one is reused. A failed build raises.

Nothing here runs at import time: the first call to :func:`library`
builds and loads. ``python -m art_tpu_torch.kernels`` times a fresh
build both ways: one nvcc per source at once, and one over all sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
import types
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -fmad=false: no multiply-add contraction, so every float operation
# rounds as in the plain PyTorch versions (and the reference); the
# kernels then match their plain versions bit for bit, not to a bound
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> (source stem in csrc/, argtypes); all return a
# cudaError_t as int
SIGNATURES = {
    # rgb, out, planes, acc, hist, wmax, sigma, pv, cf, ci,
    # kf, ki, h, w, hp, wp, tx, pre, stream
    "art_wavelet_rgb": ("wavelet_rgb", [_P] * 10 + [_I] * 8 + [_P]),
    # x, out, planes, acc, hist, wmax, sigma, prm, nc, h, w, hp, wp, stream
    "art_wavelet_multi": ("wavelet_rgb", [_P] * 8 + [_I] * 5 + [_P]),
    # buf, cap: the wavelet kernels' registers and shared memory, as text
    "art_wavelet_layout": ("wavelet_rgb", [_P, _I]),
    # y, maskinv, out, h, w, stream
    "art_nlmeans": ("nlmeans", [_P] * 3 + [_I] * 2 + [_P]),
    # buf, cap: B6's kernel's registers and shared memory, as text
    "art_nlmeans_layout": ("nlmeans", [_P, _I]),
    # rgb, out, params, coeffs, consts (host), npix, nparams, crows,
    # ccols, epi, stream
    "art_neutral_tone": ("neutral_tone", [_P] * 5 + [_I] * 5 + [_P]),
    # buf, cap, crows, ccols, epi: B7's kernel of that form as loaded
    "art_neutral_layout": ("neutral_tone", [_P] + [_I] * 4),
    # x, clips, out, hp, wp, pat, stream
    "art_amaze_stage1": ("amaze", [_P] * 3 + [_I] * 3 + [_P]),
    # x, s1, out, hp, wp, pat, stream
    "art_amaze_stage2": ("amaze", [_P] * 3 + [_I] * 3 + [_P]),
    # buf, cap: B1's, B2's and B3's kernels' registers and shared memory,
    # as text
    "art_amaze_layout": ("amaze", [_P, _I]),
    # x, s2, clips, out, hp, wp, halo, pat, stream
    "art_amaze_stage3": ("amaze", [_P] * 4 + [_I] * 4 + [_P]),
}

_lib = None
# first use from several threads (the batch queue's device workers)
# builds and loads once
_lib_lock = threading.Lock()
build_info: dict = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): cannot build "
                       "the art_tpu_torch CUDA kernels")


def _sources():
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def _target(src):
    h = hashlib.sha256()
    h.update(src.name.encode())
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _compile(jobs):
    """Run nvcc for each (output, sources) pair, all at once; raise if one
    fails. Returns nvcc's ptxas reports."""
    procs = []
    for out, srcs in jobs:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), *map(str, srcs)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append("nvcc failed (exit %d):\n%s\n%s" % (
                proc.returncode, " ".join(cmd), err[-8000:]))
        logs.append(err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def build():
    """Compile each csrc/*.cu into _build/ unless a library of the same
    source and flags is there, all compilers at once; returns {stem:
    path}. Fills `build_info` (seconds, which sources compiled, and
    nvcc's ptxas report)."""
    t0 = time.monotonic()
    libs, jobs = {}, []
    for src in _sources():
        so = libs[src.stem] = _target(src)
        if not so.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs.append((tmp, [src]))
    try:
        log = _compile(jobs) if jobs else ""
        for tmp, (src,) in jobs:
            os.replace(tmp, libs[src.stem])
    finally:
        for tmp, _ in jobs:
            if os.path.exists(tmp):
                os.unlink(tmp)
    build_info.update(seconds=time.monotonic() - t0,
                      compiled=sorted(src.stem for _, (src,) in jobs),
                      log=log)
    return libs


def library():
    """The loaded kernel libraries, built on first use: a namespace with
    one ctypes function per SIGNATURES entry."""
    global _lib
    with _lib_lock:
        if _lib is None:
            loaded = {stem: ctypes.CDLL(str(p))
                      for stem, p in build().items()}
            fns = {}
            for name, (stem, argtypes) in SIGNATURES.items():
                fn = fns[name] = getattr(loaded[stem], name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            # the handles keep the libraries loaded
            _lib = types.SimpleNamespace(handles=loaded, **fns)
        return _lib


def time_builds():
    """Seconds of a fresh build of all csrc/*.cu: one nvcc per source, all
    at once (as `build` does), against one nvcc over all sources."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="timing_"))
    try:
        t0 = time.monotonic()
        _compile([(out / f"{s.stem}.so", [s]) for s in _sources()])
        parallel = time.monotonic() - t0
        t0 = time.monotonic()
        _compile([(out / "all.so", _sources())])
        return parallel, time.monotonic() - t0
    finally:
        shutil.rmtree(out)


def check(rc, name):
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_of(t):
    """The raw handle of PyTorch's current stream on t's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


if __name__ == "__main__":
    # python -m art_tpu_torch.kernels: time the two ways to build
    p, one = time_builds()
    print(f"fresh build of {len(_sources())} sources: one nvcc per source, "
          f"all at once {p:.2f} s; one nvcc over all sources {one:.2f} s")
