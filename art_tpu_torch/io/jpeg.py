"""Baseline JPEG encoding without PIL or OpenCV.

:func:`encode` runs the port's C++ encoder (``io/native/jpegenc.cc``,
built by :mod:`art_tpu_torch.hostbuild` at first use), which writes the
bytes of libjpeg's default compressor (what the reference's
``io/imagefile.py::save_image`` gets from OpenCV): the same JFIF header,
tables and scan data for a quality and a chroma subsampling.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from art_tpu_torch import hostbuild

_LIB = None
# the encode pool's threads load the library once
_LIB_LOCK = threading.Lock()


def _load():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = hostbuild.load("jpegenc")
            lib.jpegenc_encode.restype = ctypes.c_int
            lib.jpegenc_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.jpegenc_free.restype = None
            lib.jpegenc_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
            _LIB = lib
        return _LIB


def encode(rgb, quality=92, subsampling=3) -> bytes:
    """JPEG bytes of an interleaved (H, W, 3) uint8 RGB image.

    subsampling: ART-cli's -js value, 1 = 4:2:0, 2 = 4:2:2, 3 = 4:4:4."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"need (H, W, 3) uint8, got {rgb.dtype} "
                         f"{rgb.shape}")
    h, w = rgb.shape[:2]
    if not (1 <= h <= 65535 and 1 <= w <= 65535):
        raise ValueError(f"JPEG dimensions out of range: {h}x{w}")
    if int(subsampling) not in (1, 2, 3):
        raise ValueError(f"subsampling must be 1, 2 or 3, not {subsampling}")
    lib = _load()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t()
    rc = lib.jpegenc_encode(rgb.ctypes.data, h, w, int(quality),
                            int(subsampling), ctypes.byref(out),
                            ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"jpegenc: encode failed ({rc})")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.jpegenc_free(out)
