"""AMaZE stage kernels B1-B3 (counterpart of
``art_tpu/demosaic/amaze_pallas.py``: ``_stage_call`` stages 1-3).

Each wrapper takes the reflect-padded, normalised plane x (Hp, Wp) and
the previous stage's planes. On a CPU tensor it runs the stage's plain
PyTorch version (:mod:`art_tpu_torch.demosaic.amaze`); on a CUDA tensor
it launches the kernel of ``csrc/amaze.cu`` (see there for its design)
or raises. The clip points travel as a 2-float tensor on the device, as
the reference's SMEM `clips`, so no value is read back to the host.

  amaze_stage1(x, pattern, clips)      -> (3, Hp, Wp) vcd, hcd, hvwt
  amaze_stage2(x, pattern, s1)         -> (2, Hp, Wp) green, hvwt
  amaze_stage3(x, pattern, s2, clips)  -> (3, Hp-2*HALO, Wp-2*HALO) RGB

`.launches` on each wrapper counts its kernel launches (one call of the
C entry point, whatever number of passes it runs).

Each is one kernel over output tiles, each tile computed from the tile
grown by its halo (x's reach): B1 over tiles of S1_TILE of the padded
plane, grown by S1_HALO (the .cu's S1_TH, S1_TW and R1_X); B2 likewise
over S2_TILE, grown by S2_HALO (S2_TH, S2_TW and R_X); B3 over tiles of
S3_TILE of its cropped output, grown by S3_HALO (S3_TH, S3_TW and R3_X).
``tests/test_torch_amaze_tiles.py`` holds these to the .cu and checks
each halo on the CPU. No stage needs a scratch plane.
"""

from __future__ import annotations

import ctypes

import torch

from art_tpu_torch import kernels
from art_tpu_torch.core.image import BAYER_PATTERNS
from art_tpu_torch.demosaic import amaze

# scratch planes each entry point needs beside its output
SCRATCH = {"art_amaze_stage1": 0, "art_amaze_stage2": 0,
           "art_amaze_stage3": 0}
# B1's, B2's and B3's output tiles (rows, columns) and the reach of the
# window around each
S1_TILE = (32, 64)
S1_HALO = 9
S2_TILE = (32, 64)
S2_HALO = 15
S3_TILE = (32, 64)
S3_HALO = 10


def pattern_code(pattern):
    """The Bayer pattern as 2 bits per 2x2 site (0=R 1=G 2=B), site k =
    (row % 2) * 2 + (col % 2) in bits 2k..2k+1."""
    if pattern not in BAYER_PATTERNS:
        raise ValueError(f"not a Bayer pattern: {pattern!r}")
    return sum("RGB".index(c) << (2 * k) for k, c in enumerate(pattern))


def _check(name, t, shape, device):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want float32 {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, x on {device}")


def _args(x, planes, clips):
    """Check the inputs against x; returns the device type."""
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"x: want float32 (Hp, Wp), got {x.dtype} "
                         f"{tuple(x.shape)}")
    hp, wp = x.shape
    if hp <= 2 * amaze.HALO or wp <= 2 * amaze.HALO:
        raise ValueError(f"x {tuple(x.shape)}: smaller than the 2*HALO ring")
    if planes is not None:
        _check("stage input", planes[1], (planes[0], hp, wp), x.device)
    if clips is not None:
        _check("clips", clips, (2,), x.device)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no AMaZE kernel for device {x.device}")
    return x.device.type


def amaze_stage1(x, pattern, clips):
    """Kernel B1: stages 1-4."""
    if _args(x, None, clips) == "cpu":
        return amaze.stage1_plain(x, pattern, clips)
    out = _launch("art_amaze_stage1", x, pattern, (3,) + tuple(x.shape),
                  (clips,))
    amaze_stage1.launches += 1
    return out


def amaze_stage2(x, pattern, s1):
    """Kernel B2: stages 5-6."""
    if _args(x, (3, s1), None) == "cpu":
        return amaze.stage2_plain(x, pattern, s1)
    out = _launch("art_amaze_stage2", x, pattern, (2,) + tuple(x.shape),
                  (s1,))
    amaze_stage2.launches += 1
    return out


def amaze_stage3(x, pattern, s2, clips):
    """Kernel B3: stages 7-8, written cropped by HALO."""
    if _args(x, (2, s2), clips) == "cpu":
        return amaze.stage3_plain(x, pattern, s2, clips)
    hp, wp = x.shape
    h = amaze.HALO
    out = _launch("art_amaze_stage3", x, pattern,
                  (3, hp - 2 * h, wp - 2 * h), (s2, clips), (h,))
    amaze_stage3.launches += 1
    return out


amaze_stage1.launches = 0
amaze_stage2.launches = 0
amaze_stage3.launches = 0


def _launch(name, x, pattern, out_shape, inputs, ints=()):
    fn = getattr(kernels.library(), name)
    x = x.contiguous()
    inputs = [t.contiguous() for t in inputs]
    hp, wp = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty(out_shape, **f32)
    planes = [x, *inputs, out]
    if SCRATCH[name]:
        planes.append(torch.empty((SCRATCH[name], hp, wp), **f32))
    ptrs = [t.data_ptr() for t in planes]
    rc = fn(*ptrs, hp, wp, *ints, pattern_code(pattern),
            kernels.stream_of(x))
    kernels.check(rc, name)
    return out


def layout():
    """B1's, B2's and B3's kernels on the card: registers, shared and local
    memory, tile (``art_amaze_layout``)."""
    buf = ctypes.create_string_buffer(1024)
    kernels.check(kernels.library().art_amaze_layout(buf, len(buf)),
                  "art_amaze_layout")
    return buf.value.decode()
