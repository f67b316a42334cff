"""Optional exiftool fallback for deep makernote preservation (a copy of
``art_tpu/io/exiftool.py``).

The reference shells out to exiftool (``metadata.h:113``,
``metadata.cc:143-240`` Exiftool class) for two jobs the native EXIF
machinery cannot do: importing metadata exiv2 chokes on, and carrying
proprietary MakerNote blocks into output files. Our native tunnel
(io.metadata.build_exif_bytes) rebuilds standard EXIF; this module adds
the reference's second job — when ``settings.exiftool_path`` resolves
to a runnable binary, copy the full tag set (incl. makernotes) from the
source raw into the saved output.

exiftool's ``-TagsFromFile`` already refuses to copy "unsafe"
structural tags, which covers most of the reference's ``badtags`` list
(``metadata.cc:592-652``); the explicit excludes below handle the rest
(orientation is baked into our pixels, thumbnails would be stale).

Everything degrades silently: no binary, or a failed run, leaves the
natively-tunneled output untouched (the reference logs "exiftool
disabled or not found" and continues, metadata.cc:356).
"""

from __future__ import annotations

import os
import shutil
import subprocess

# structural/baked tags never copied (remove_unwanted badtags subset
# that exiftool would otherwise consider copyable)
_EXCLUDES = (
    "--Orientation",
    "--ThumbnailImage",
    "--PreviewImage",
    "--JpgFromRaw",
    "--OtherImage",
    "--ImageWidth",
    "--ImageHeight",
    "--BitsPerSample",
    "--Compression",
)


def find_exiftool(path: str | None = None) -> str | None:
    """Resolve the exiftool binary (metadata.cc get_exiftool_path)."""
    if path is None:
        from art_tpu_torch.settings import settings

        path = settings.exiftool_path
    if not path:
        return None
    if os.path.sep in path:
        return path if os.access(path, os.X_OK) else None
    return shutil.which(path)


def copy_tags(src: str, dst: str, exiftool: str | None = None,
              timeout: float = 30.0) -> bool:
    """Deep-copy tags (incl. MakerNotes) from src raw into dst output.

    Returns True when exiftool ran successfully; False when the binary
    is missing or the run failed (native-tunneled metadata stays).
    """
    exe = exiftool or find_exiftool()
    if not exe:
        return False
    argv = [exe, "-q", "-q", "-overwrite_original", "-TagsFromFile", src,
            "-all:all", *_EXCLUDES, dst]
    try:
        res = subprocess.run(argv, capture_output=True, timeout=timeout)
        return res.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False
