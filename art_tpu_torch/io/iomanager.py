"""Pluggable external loaders and savers, and raw preconverters (a copy of
``art_tpu/io/iomanager.py``).

Reference: ``rtengine/imgiomanager.{h,cc}``. User-provided ``*.txt``
KeyFile configs declare shell commands for (a) image formats the engine
cannot read or write natively ([ART ImageIO]: Extension, ReadCommand,
WriteCommand, SaveFormat) and (b) raw formats preconverted to DNG
([ART RAWImageIO]: Extension, Make, Model, ReadCommand). Commands run as
``cmd <input> <output>``; a preconverted DNG is cached under a name made
from the md5 of the source path and its mtime (imgiomanager.cc
get_cache_name :530).

Configs are scanned from ``<user_dir>/imageio`` (settings.user_dir).
"""

from __future__ import annotations

import hashlib
import os
import shlex
import subprocess
import tempfile

from art_tpu_torch.params.keyfile import KeyFile
from art_tpu_torch.settings import settings


class IOManager:
    def __init__(self, dirs=None):
        self.loaders = {}      # ext -> (workdir, command)
        self.savers = {}       # fmt -> (workdir, command, out_ext)
        self.raw_loaders = []  # (ext, make, model, workdir, command)
        if dirs is None:
            dirs = []
            if settings.user_dir:
                dirs.append(os.path.join(settings.user_dir, "imageio"))
        for d in dirs:
            self.scan(d)

    def scan(self, directory):
        if not directory or not os.path.isdir(directory):
            return
        for name in sorted(os.listdir(directory)):
            if not name.lower().endswith(".txt"):
                continue
            try:
                kf = KeyFile.load(os.path.join(directory, name))
            except OSError:
                continue
            g = "ART RAWImageIO"
            if g in kf.groups and kf.has(g, "ReadCommand"):
                self.raw_loaders.append((
                    kf.get_string(g, "Extension").lower().lstrip("."),
                    kf.get_string(g, "Make").lower(),
                    kf.get_string(g, "Model").lower(),
                    directory, kf.get_string(g, "ReadCommand")))
            g = "ART ImageIO"
            if g in kf.groups and kf.has(g, "Extension"):
                ext = kf.get_string(g, "Extension").lower().lstrip(".")
                if kf.has(g, "ReadCommand"):
                    self.loaders[ext] = (directory,
                                         kf.get_string(g, "ReadCommand"))
                if kf.has(g, "WriteCommand"):
                    fmt = kf.get_string(g, "SaveFormat").lower() or ext
                    self.savers[fmt] = (directory,
                                        kf.get_string(g, "WriteCommand"),
                                        ext)

    # -- raw preconversion (imgiomanager.cc loadRaw :510-585) -------------

    def can_load_raw(self, path, make="", model=""):
        return self._match_raw(path, make, model) is not None

    def _match_raw(self, path, make, model):
        ext = os.path.splitext(str(path))[1].lower().lstrip(".")
        for rext, rmake, rmodel, wd, cmd in self.raw_loaders:
            if rext and rext != ext:
                continue
            if rmake and rmake not in (make or "").lower():
                continue
            if rmodel and rmodel not in (model or "").lower():
                continue
            return wd, cmd
        return None

    def _cache_name(self, path):
        base = os.path.join(tempfile.gettempdir(), "art_tpu_rawimgio")
        os.makedirs(base, exist_ok=True)
        md5 = hashlib.md5(
            f"{path}:{os.path.getmtime(path)}".encode()).hexdigest()
        return os.path.join(base,
                            os.path.basename(str(path)) + "." + md5 + ".dng")

    def preconvert_raw(self, path, make="", model=""):
        """Run the matching raw preconverter; returns the DNG path or
        None. Results are cached per (path, mtime)."""
        m = self._match_raw(path, make, model)
        if m is None:
            return None
        out = self._cache_name(path)
        if os.path.isfile(out):
            return out
        wd, cmd = m
        argv = shlex.split(cmd) + [str(path), out]
        try:
            subprocess.run(argv, cwd=wd or None, check=True,
                           capture_output=True, timeout=300)
        except (subprocess.SubprocessError, OSError):
            return None
        return out if os.path.isfile(out) else None

    # -- pluggable image load/save (load :240-300, save :430-500) ----------

    def load_image(self, path):
        """External loader -> temporary TIFF path, or None."""
        ext = os.path.splitext(str(path))[1].lower().lstrip(".")
        if ext not in self.loaders:
            return None
        wd, cmd = self.loaders[ext]
        fd, out = tempfile.mkstemp(suffix=".tif", prefix="art_tpu_ioload_")
        os.close(fd)
        argv = shlex.split(cmd) + [str(path), out]
        try:
            subprocess.run(argv, cwd=wd or None, check=True,
                           capture_output=True, timeout=300)
        except (subprocess.SubprocessError, OSError):
            os.unlink(out)
            return None
        return out

    def save_image(self, fmt, tiff_path, dest):
        """External saver: hand a float TIFF to the configured command."""
        if fmt not in self.savers:
            return False
        wd, cmd, _ = self.savers[fmt]
        argv = shlex.split(cmd) + [str(tiff_path), str(dest)]
        try:
            subprocess.run(argv, cwd=wd or None, check=True,
                           capture_output=True, timeout=600)
        except (subprocess.SubprocessError, OSError):
            return False
        return os.path.isfile(str(dest))


_instance = None


def get_instance() -> IOManager:
    global _instance
    if _instance is None:
        _instance = IOManager()
    return _instance


def reset():
    global _instance
    _instance = None
