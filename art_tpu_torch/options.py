"""App-level Options tier (a copy of ``art_tpu/options.py``, reading side
only; reference: ``rtgui/options.{h,cc}``).

The reference keeps three configuration tiers: engine ``Settings``
(settings.h — :mod:`art_tpu_torch.settings`), the app ``Options`` KeyFile
stored as ``<config dir>/options`` (options.cc:651+), and per-image
``ProcParams``. This module is the headless-relevant subset of tier 2:
default processing profiles, save-format defaults, profile/ICC/CLUT
directories, dark/flat paths, fast-export sizing and the preview
demosaic knob. GUI-only fields (window geometry, themes, panel state)
are out of scope.

Group/key names match the reference KeyFile so an existing ART
``options`` file loads as-is. ``load_options()`` also forwards the
engine-relevant values into :data:`art_tpu_torch.settings.settings` the same
way ``Options::readFromFile`` fills ``rtSettings``: of them the port's
settings carry ``verbose``, the CLUT directory and the lensfun database
directory (dark frames and flat fields are not ported).
"""

from __future__ import annotations

import dataclasses
import os

from art_tpu_torch.params.keyfile import KeyFile

# reference defaults (options.h:101-107)
DEFPROFILE_INTERNAL = "Neutral"
DEFPROFILE_DYNAMIC = "Dynamic"
DEFPROFILE_RAW = DEFPROFILE_DYNAMIC
DEFPROFILE_IMG = DEFPROFILE_INTERNAL


@dataclasses.dataclass
class Options:
    # [General] (options.cc:720-725)
    verbose: bool = False
    dark_frames_path: str = ""
    flat_fields_path: str = ""
    # [Profiles] (options.cc:905-917)
    profile_path: str = ""           # Profiles/Directory
    use_bundled_profiles: bool = True
    def_prof_raw: str = DEFPROFILE_RAW
    def_prof_img: str = DEFPROFILE_IMG
    params_sidecar_strip_extension: bool = False
    # [Output] (options.cc:311-315, 794-840)
    format: str = "jpg"
    jpeg_quality: int = 92
    png_bits: int = 8
    tiff_bits: int = 16
    tiff_float: bool = False
    tiff_uncompressed: bool = True
    save_proc_params: bool = True
    path_template: str = ""
    use_path_template: bool = False
    # [Color Management]
    icc_directory: str = ""
    cluts_directory: str = ""        # options.cc:487 default "./cluts"
    monitor_profile: str = ""
    # [Fast Export] (options.cc:484-485)
    fast_export_resize_width: int = 1920
    fast_export_resize_height: int = 1920
    # [Performance] (options.cc:461,1123: 0=fast preview demosaic always,
    # 1=sidecar-quality demosaic when the image has an .arp)
    prev_demo: int = 1
    # [File Browser]
    max_thumbnail_height: int = 250  # MaxPreviewHeight
    parse_extensions: tuple = ()
    # [Lensfun]
    lensfun_db_directory: str = ""

    # -- KeyFile reader -----------------------------------------------------

    @classmethod
    def from_keyfile(cls, kf: KeyFile) -> "Options":
        o = cls()
        o.verbose = kf.get_bool("General", "Verbose", o.verbose)
        o.dark_frames_path = kf.get_string("General", "DarkFramesPath",
                                           o.dark_frames_path)
        o.flat_fields_path = kf.get_string("General", "FlatFieldsPath",
                                           o.flat_fields_path)
        o.profile_path = kf.get_string("Profiles", "Directory",
                                       o.profile_path)
        o.use_bundled_profiles = kf.get_bool(
            "Profiles", "UseBundledProfiles", o.use_bundled_profiles)
        o.def_prof_raw = kf.get_string("Profiles", "RawDefault",
                                       o.def_prof_raw)
        o.def_prof_img = kf.get_string("Profiles", "ImgDefault",
                                       o.def_prof_img)
        o.params_sidecar_strip_extension = kf.get_bool(
            "Profiles", "ParamsSidecarStripExtension",
            o.params_sidecar_strip_extension)
        o.format = kf.get_string("Output", "Format", o.format).lower()
        o.jpeg_quality = kf.get_int("Output", "JpegQuality",
                                    o.jpeg_quality)
        o.png_bits = kf.get_int("Output", "PngBps", o.png_bits)
        o.tiff_bits = kf.get_int("Output", "TiffBps", o.tiff_bits)
        o.tiff_float = kf.get_bool("Output", "TiffFloat", o.tiff_float)
        o.tiff_uncompressed = kf.get_bool("Output", "TiffUncompressed",
                                          o.tiff_uncompressed)
        o.save_proc_params = kf.get_bool("Output", "SaveProcParams",
                                         o.save_proc_params)
        o.path_template = kf.get_string("Output", "PathTemplate",
                                        o.path_template)
        o.use_path_template = kf.get_bool("Output", "UsePathTemplate",
                                          o.use_path_template)
        o.icc_directory = kf.get_string("Color Management", "ICCDirectory",
                                        o.icc_directory)
        o.cluts_directory = kf.get_string(
            "Color Management", "ClutsDirectory", o.cluts_directory)
        o.monitor_profile = kf.get_string(
            "Color Management", "MonitorProfile", o.monitor_profile)
        o.fast_export_resize_width = kf.get_int(
            "Fast Export", "fastexport_resize_width",
            kf.get_int("Fast Export", "MaxWidth",
                       o.fast_export_resize_width))
        o.fast_export_resize_height = kf.get_int(
            "Fast Export", "fastexport_resize_height",
            kf.get_int("Fast Export", "MaxHeight",
                       o.fast_export_resize_height))
        o.prev_demo = kf.get_int("Performance",
                                 "PreviewDemosaicFromSidecar", o.prev_demo)
        o.max_thumbnail_height = kf.get_int(
            "File Browser", "MaxPreviewHeight", o.max_thumbnail_height)
        exts = kf.get_string("File Browser", "ParseExtensions", "")
        if exts:
            o.parse_extensions = tuple(
                e.strip().lstrip(".").lower()
                for e in exts.split(";") if e.strip())
        o.lensfun_db_directory = kf.get_string(
            "Lensfun", "DBDirectory", o.lensfun_db_directory)
        return o

    # -- settings forwarding (Options::readFromFile -> rtSettings) ----------

    def apply_to_settings(self, settings) -> None:
        if self.verbose:
            settings.verbose = True
        if self.cluts_directory:
            settings.cluts_dir = self.cluts_directory
        if self.lensfun_db_directory:
            settings.lensfun_db_dir = self.lensfun_db_directory


def config_dir() -> str:
    """User config dir (main.cc user_config_dir semantics):
    $ART_TPU_CONFIG_DIR, else $XDG_CONFIG_HOME/ART-tpu, else
    ~/.config/ART-tpu."""
    env = os.environ.get("ART_TPU_CONFIG_DIR")
    if env:
        return env
    xdg = os.environ.get("XDG_CONFIG_HOME",
                         os.path.join(os.path.expanduser("~"), ".config"))
    return os.path.join(xdg, "ART-tpu")


_options: Options | None = None


def load_options(path=None, settings=None) -> Options:
    """Load (and cache) the app options, forwarding engine-relevant
    fields into the Settings singleton. Missing file = defaults (the
    reference also starts with built-in defaults)."""
    global _options
    if path is None:
        path = os.path.join(config_dir(), "options")
    o = Options()
    if os.path.isfile(path):
        try:
            o = Options.from_keyfile(KeyFile.load(path))
        except OSError:
            pass
    if settings is None:
        from art_tpu_torch.settings import settings as settings_
        settings = settings_
    o.apply_to_settings(settings)
    _options = o
    return o


def get_options() -> Options:
    """The cached app options (defaults if load_options never ran)."""
    global _options
    if _options is None:
        _options = Options()
    return _options
