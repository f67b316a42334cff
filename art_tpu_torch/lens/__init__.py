"""Lens corrections (counterpart of :mod:`art_tpu.lens`): host copies of
the Adobe LCP parser (`lcp.py`), the lensfun database (`lensfun.py`) and
the metadata-embedded corrections (`exifcorr.py`), whose coefficients the
planner hands to the raw vignette and the geometry transform
(`pipeline/transform.py`)."""
