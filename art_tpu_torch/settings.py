"""Engine settings (from ``art_tpu/settings.py``): the port reads one."""

# Pad images to multiples of this tile edge; the planned shape and the
# per-row level patterns follow it, as in the reference.
PAD_MULTIPLE = 128
