"""Engine settings (a copy of the fields of ``art_tpu/settings.py`` that
the port reads): the develop pipeline's pad multiple, and the `Settings`
singleton of the export path (``pipeline/develop.py::process_image``,
``cli.py``), the batch queue's host threads (``parallel/queue.py``) and
the film simulation's LUT directory, the dark-frame and flat-field
search directories (``raw/dfff_managers.py``) and the lensfun database
directory (``lens/lensfun.py``)."""

from __future__ import annotations

import dataclasses
import os

# Pad images to multiples of this tile edge; the planned shape and the
# per-row level patterns follow it, as in the reference.
PAD_MULTIPLE = 128


@dataclasses.dataclass
class Settings:
    # per-phase timings of process_image on stdout (ART-cli's -V)
    verbose: bool = False
    # Host threads of the batch queue's decode/plan pool and of its encode
    # pool (the reference sizes its ThreadPool to nproc-1, init.cc:66-73)
    host_threads: int = max(1, (os.cpu_count() or 2) - 1)
    # Directory with user camconst overrides, dark frames, flat fields and
    # external image IO configs (<user_dir>/imageio).
    user_dir: str | None = None
    # XMP sidecar naming (settings.h XmpSidecarStyle): "std" = file.xmp,
    # "ext" = file.raw.xmp
    xmp_sidecar_style: str = "std"
    # exiftool binary for deep makernote preservation on output
    # (settings.h:75 exiftool_path; metadata.cc embed path). The native
    # EXIF tunnel always runs; exiftool additionally copies proprietary
    # makernote blocks when the binary exists.
    exiftool_path: str = "exiftool"
    # Directory that relative film-simulation LUT names resolve against
    # (options.clutsDir; ops/filmsim.py)
    cluts_dir: str | None = None
    # Auto-select scan roots (reference dfmanager/ffmanager dir options);
    # default to <user_dir>/darkframes and <user_dir>/flatfields
    dark_frames_dir: str | None = None
    flat_fields_dir: str | None = None
    # lensfun XML database directory (rtlensfun.cc LFDatabase::init's
    # lensfunDbDirectory option); None = lensfun corrections disabled
    lensfun_db_dir: str | None = None


settings = Settings()
