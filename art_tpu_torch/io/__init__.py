"""Raw frames (counterpart of :mod:`art_tpu.io`)."""
