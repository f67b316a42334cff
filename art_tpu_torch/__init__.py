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
"""

import torch

# Full float32 everywhere: TF32 keeps ~3 decimal digits (cuDNN's default
# for convolutions is TF32; the reference computes in exact f32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
