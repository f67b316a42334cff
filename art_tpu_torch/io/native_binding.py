"""ctypes binding for the native artraw decoder (a copy of
``art_tpu/io/native_binding.py``).

The decoder is the port's copy of the reference's C++ source,
``io/native/artraw.cc``, built by :mod:`art_tpu_torch.hostbuild` with
portable flags at first use. ``ART_TPU_DECODE_THREADS`` sets its strip
threads, as in the reference."""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from art_tpu_torch import hostbuild

_LIB = None
# the batch queue's host threads load the library once
_LIB_LOCK = threading.Lock()


class ArtRawMeta(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("cfa_pattern", ctypes.c_int32 * 4),
        ("black", ctypes.c_double * 4),
        ("white", ctypes.c_double * 4),
        ("as_shot_neutral", ctypes.c_double * 3),
        ("color_matrix1", ctypes.c_double * 9),
        ("color_matrix2", ctypes.c_double * 9),
        ("has_cm1", ctypes.c_int32),
        ("has_cm2", ctypes.c_int32),
        ("illuminant1", ctypes.c_int32),
        ("illuminant2", ctypes.c_int32),
        ("baseline_exposure", ctypes.c_double),
        ("iso", ctypes.c_double),
        ("orientation", ctypes.c_int32),
        ("active_area", ctypes.c_int32 * 4),
        ("crop", ctypes.c_int32 * 4),
        ("xtrans", ctypes.c_int32 * 36),
        ("make", ctypes.c_char * 64),
        ("model", ctypes.c_char * 64),
        ("channels", ctypes.c_int32),  # 0/1 mosaic-or-gray; 3 Foveon
    ]


def _load():
    """The port's own build of the decoder (``io/native/artraw.cc``, a
    copy of the reference's source), built by g++ at first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = hostbuild.load("artraw")
            lib.artraw_decode_dng.restype = ctypes.POINTER(ctypes.c_uint16)
            lib.artraw_decode_dng.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ArtRawMeta)]
            lib.artraw_free.argtypes = [ctypes.POINTER(ctypes.c_uint16)]
            lib.artraw_free.restype = None
            _LIB = lib
        return _LIB


def decode_dng_bytes(data: bytes):
    """Decode DNG bytes -> (image uint16 (H,W) or (H,W,spp), meta dict)."""
    lib = _load()
    meta = ArtRawMeta()
    ptr = lib.artraw_decode_dng(data, len(data), ctypes.byref(meta))
    if not ptr:
        raise ValueError("artraw: failed to decode DNG")
    try:
        h, w = meta.height, meta.width
        ch = int(meta.channels) or 1
        arr = np.ctypeslib.as_array(ptr, shape=(h * w * ch,)).copy()
        img = arr.reshape(h, w) if ch == 1 else arr.reshape(ch, h, w)
    finally:
        lib.artraw_free(ptr)
    m = {
        "width": w,
        "height": h,
        "channels": ch,
        "cfa_pattern": list(meta.cfa_pattern),
        "black": np.array(meta.black),
        "white": np.array(meta.white),
        "as_shot_neutral": np.array(meta.as_shot_neutral),
        "color_matrix1": (np.array(meta.color_matrix1).reshape(3, 3)
                          if meta.has_cm1 else None),
        "color_matrix2": (np.array(meta.color_matrix2).reshape(3, 3)
                          if meta.has_cm2 else None),
        "illuminant1": meta.illuminant1,
        "illuminant2": meta.illuminant2,
        "baseline_exposure": meta.baseline_exposure,
        "iso": meta.iso,
        "orientation": meta.orientation,
        "active_area": list(meta.active_area),
        "crop": list(meta.crop),
        "xtrans": (tuple(tuple(meta.xtrans[r * 6 + c] for c in range(6))
                         for r in range(6))
                   if meta.xtrans[0] >= 0 else None),
        "make": meta.make.decode(errors="replace"),
        "model": meta.model.decode(errors="replace"),
    }
    return img, m
