"""Lens corrections (counterpart of :mod:`art_tpu.lens`): only the host
lookup that decides whether the reference would apply one."""
