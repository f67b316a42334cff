"""Build the package's host C++ libraries: the raw decoder
(``io/native/artraw.cc``), the baseline JPEG encoder
(``io/native/jpegenc.cc``), the JPEG decoder (``io/native/jpegdec.cc``),
GIF's LZW decoder (``io/native/lzwdec.cc``), the WebP decoder
(``io/native/webpdec.cc``), the simple raster formats' decoders
(``io/native/rasterdec.cc``), the JPEG 2000 decoder
(``io/native/jp2dec.cc``) and the TIFF codecs (``io/native/tiffdec.cc``:
ZSTD, CCITT fax, ThunderScan).

Each source is compiled by g++ with portable flags (no ``-march=native``,
so a library built on one machine runs on another), and a source's own
flags from `SOURCE_FLAGS` after them, into
``art_tpu_torch/_build/``, under a name that carries a hash of the source
and the flags, at its first use. Several processes may ask at once (the
test workers): the build runs under an exclusive ``fcntl`` lock, writes
to a temporary name and renames it into place, so one process builds
and the others load its library. A failed build raises; nothing falls
back to another library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "io" / "native"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
# flags of one source only: the JPEG 2000 decoder's float32 wavelet and
# colour transform round each product and sum as OpenJPEG's x86-64 build
# does, so no multiply-add may fuse (g++ on aarch64 fuses by default)
SOURCE_FLAGS = {"jp2dec": ("-ffp-contract=off",)}


def flags(stem: str) -> tuple:
    """The g++ flags of source `stem`."""
    return CXX_FLAGS + SOURCE_FLAGS.get(stem, ())


def target(stem: str) -> Path:
    """The library path of source `stem` under the current flags."""
    src = SRC_DIR / f"{stem}.cc"
    h = hashlib.sha256()
    h.update(src.name.encode())
    h.update(src.read_bytes())
    h.update(" ".join(flags(stem)).encode())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: cannot build the art_tpu_torch "
                           "host libraries (raw decoder, JPEG encoder and "
                           "decoder, GIF, WebP, raster, JPEG 2000 and "
                           "TIFF decoders)")
    return cxx


def build(*stems: str) -> dict:
    """Build each named source unless its library exists, all compilers
    at once; returns {stem: library path}."""
    libs = {s: target(s) for s in stems}
    if all(p.is_file() for p in libs.values()):
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        jobs = []
        try:
            for stem, so in libs.items():
                if so.is_file():  # another process built it meanwhile
                    continue
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                cmd = [_cxx(), *flags(stem), "-o", tmp,
                       str(SRC_DIR / f"{stem}.cc")]
                jobs.append((stem, tmp, cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            failed = []
            for stem, tmp, cmd, proc in jobs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    failed.append("g++ failed (exit %d):\n%s\n%s" % (
                        proc.returncode, " ".join(cmd), err[-8000:]))
            if failed:
                raise RuntimeError("\n".join(failed))
            for stem, tmp, _, _ in jobs:
                os.replace(tmp, libs[stem])
        finally:
            for _, tmp, _, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)
    return libs


def load(stem: str) -> ctypes.CDLL:
    """The library of source `stem`, built on first use."""
    return ctypes.CDLL(str(build(stem)[stem]))
