"""ART-TPU on PyTorch and CUDA: the develop pipeline for NVIDIA Hopper.

Counterpart of :mod:`art_tpu`, which stays the reference. The layout
mirrors ``art_tpu/``: each module names its ``art_tpu`` original in its
docstring. Host planning is numpy (no JAX anywhere in this package); the
device half is plain PyTorch on tensors plus hand-written CUDA kernels
(``csrc/``, built and bound by :mod:`art_tpu_torch.kernels`) where the
reference used Pallas.

Every function that touches tensors takes an explicit ``device``; there
is no hidden global device. A kernel wrapper runs its plain PyTorch
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises.

Covered so far: ``pipeline.develop.plan`` -> ``develop`` ->
``crop_result`` for a Bayer frame, with the hot/dead filter, green
equilibration and raw CA correction, and AMaZE (kernels B1-B3,
``csrc/amaze.cu``), RCD or bilinear (or ``fast``) demosaic, or an
X-Trans frame (fast, 1-, 2-, 3-pass); dehaze, the tone equalizer, a
``.cube`` film simulation and local contrast with its region masks; the
denoise, fused (kernel B4, ``csrc/wavelet_rgb.cu``) or not (kernel B5
in the same source, the guided chroma filter, NLMeans as kernel B6,
``csrc/nlmeans.cu``); the impulse denoise; the Neutral tone curve with
the sRGB/linear output epilogue (kernel B7, ``csrc/neutral_tone.cu``) or
the output transform on its own, ending for an 8-bit JPEG in
interleaved uint8; and the pointwise ops exposure, channel mixer,
saturation, RGB curves and soft light. Around it, the headless ART-cli
path (``cli``, ``pipeline.develop.process_image``): raw decode with the
package's own build of the reference's C++ decoder (``io/native``, built
by :mod:`art_tpu_torch.hostbuild`) and JPEG/TIFF/PNG output with its own
encoders and the reference's metadata; and the batch queue
(``parallel``), one worker per device with decode, plan and encode on
host threads. Anything else raises
``NotImplementedError`` naming the step or parameter.

Public surface (as :mod:`art_tpu`'s, which mirrors the reference's
headless path, ``rtengine/rtengine.h:550-626``):

- :func:`init` -- global bring-up: the user settings directory, its
  dark-frame/flat-field and external image I/O managers, and its
  ``camconst.json`` over the bundled camera constants.
- :func:`load_image` -- host decode of a raw or non-raw file (a raw
  format the native decoder does not read goes through a registered
  preconverter, ``io/iomanager.py``).
- :func:`process_image` -- the full develop on the card (or the CPU).
- :func:`thumbnail` -- the embedded preview, or a fast develop, strided
  to a size.
- ``python -m art_tpu_torch.cli`` -- the ART-cli compatible front end.

A non-raw image loads as the reference loads it; its develop is refused
by name, since the reference's planner fails on every non-raw frame
(``pipeline/develop.py::_refuse_non_raw``).
"""

import torch

# Full float32 everywhere: TF32 keeps ~3 decimal digits (cuDNN's default
# for convolutions is TF32; the reference computes in exact f32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def init(base_dir=None, user_settings_dir=None):
    """Global bring-up (``art_tpu/__init__.py::init``; rtengine::init,
    init.cc:59). Idempotent. With ``user_settings_dir``: it becomes
    ``settings.user_dir``, and the dark-frame/flat-field managers and
    the external image I/O manager (``<user_dir>/imageio``) start anew
    from it. The bundled camera constants load (lazily, in
    ``raw/camconst.py``); a ``camconst.json`` in the user directory
    loads over them, an unreadable one skipped as in the reference.
    ``base_dir`` is accepted and unused, as in the reference."""
    import os

    from art_tpu_torch.raw import camconst
    from art_tpu_torch.settings import settings

    if user_settings_dir:
        settings.user_dir = str(user_settings_dir)
        from art_tpu_torch.io import iomanager
        from art_tpu_torch.raw import dfff_managers

        dfff_managers.reset()
        iomanager.reset()

    cc = camconst.get_instance()
    if settings.user_dir:
        user_cc = os.path.join(settings.user_dir, "camconst.json")
        if os.path.isfile(user_cc):
            try:
                cc.load_json(user_cc)
            except (OSError, ValueError):
                pass


def load_image(path):
    """A raw or non-raw file as a RawFrame (``io.load_image``)."""
    from art_tpu_torch.io import load_image as _load

    return _load(path)


def process_image(path_or_image, params, fast=False, device="cuda"):
    """Develop a file (or a RawFrame) with ProcParams `params` on `device`
    (the card unless the caller asks for the CPU): (3, H, W) float32 in
    [0, 1] as a numpy array (``pipeline.develop.process_image`` with no
    output file). fast: the fast export (ART-cli's -q)."""
    from art_tpu_torch.pipeline.develop import process_image as _process

    return _process(path_or_image, params, fast=fast, device=device)


def thumbnail(path, params=None, max_px=256, device="cuda"):
    """A thumbnail as (3, H, W) float32 in [0, 1] (rtengine's Thumbnail
    role): the largest embedded JPEG preview when the file has one,
    else a fast develop with `params` (default ``ProcParams()``) on
    `device`; then every step-th row and column, step =
    ceil(max(H, W) / max_px)."""
    import numpy as np

    from art_tpu_torch.io.metadata import embedded_thumb

    thumb = embedded_thumb(path)
    if thumb is None:
        from art_tpu_torch.params import ProcParams

        pp = params or ProcParams()
        thumb = np.asarray(process_image(path, pp, fast=True, device=device),
                           np.float32)
    c, h, w = thumb.shape
    step = max(1, int(np.ceil(max(h, w) / float(max_px))))
    if step > 1:
        thumb = thumb[:, ::step, ::step]
    return thumb
