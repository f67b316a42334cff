"""ART-cli compatible command line front end (a copy of
``art_tpu/cli.py``, developing on the card through
:mod:`art_tpu_torch`).

Reference: ``rtgui/main-cli.cc`` (910 LoC) and the argv contract in
``doc/manpage/ART.1:20-70``. Profile composition order: neutral defaults ->
``-d`` default profile -> each ``-p`` in order -> sidecar with ``-s``/``-S``.

    python -m art_tpu_torch.cli -c in.dng -o out.jpg -p profile.arp

Extra flags of the reference: ``--bench`` prints per-image timings;
``--devices N`` (N > 1, several inputs) develops the inputs through the
batch queue (``parallel/queue.py::process_batch``) over the first N
visible CUDA devices, as the reference takes its first N devices; as
there, its outputs carry no metadata. ``--check-lut <file>`` exits 0 if
the LUT loads, 1 if it does not, and 2 for an image format the port's
decoder does not read (it reads PNG and baseline TIFF Hald CLUTs).
``-q`` is the fast export: a resize to the Options' fast-export box
right after the raw stage. ``--gamut-warn <profile>`` paints the pixels
outside the proof profile's gamut cyan (``color/gamutwarning.py``).
`main` develops on the card unless its caller passes ``device="cpu"``
(with ``--devices N``: N workers on the CPU).
"""

from __future__ import annotations

import os
import sys
import time

from art_tpu_torch.params import KeyFile, ProcParams


def _usage():
    print(
        "ART-tpu-cli\n"
        "  python -m art_tpu_torch.cli [options] -c <input files>\n\n"
        "Options (ART-cli compatible, doc/manpage/ART.1):\n"
        "  -c <files>   input files (must be last)\n"
        "  -o <file>|<dir>  output target\n"
        "  -O <file>|<dir>  like -o, also copies the arp\n"
        "  -s | -S      use sidecar <input>.arp (S: skip if missing)\n"
        "  -p <f.arp>   apply profile (repeatable, in order)\n"
        "  -d           apply default processing profile\n"
        "  -j[1-100]    JPEG output [quality]\n"
        "  -t[z]        TIFF output (z: deflate compression)\n"
        "  -n           PNG output\n"
        "  -b<8|16|32>  bit depth (TIFF/PNG; 32 = float TIFF)\n"
        "  -Y           overwrite existing output\n"
        "  -q           fast export mode\n"
        "  --progress   machine-readable progress protocol\n"
        "  --devices N  shard batch over N devices\n"
        "  --make-icc -p <preset> -d <desc> -o <file>  generate an ICC\n"
        "  --check-lut <file>  validate a LUT file loads\n"
        "  --gamut-warn <profile>  paint out-of-gamut pixels cyan\n"
        "               (soft-proof vs a preset name or matrix .icc)\n"
    )


def parse_args(argv):
    opts = {
        "inputs": [],
        "output": None,
        "copy_arp": False,
        "sidecar": None,  # None | "use" | "require"
        "profiles": [],
        "use_default": False,
        "format": None,
        "quality": None,  # None -> Options tier default (92)
        "bits": None,
        "overwrite": False,
        "fast": False,
        "devices": 0,
        "bench": False,
        "progress": False,
        "gamut_warn": None,
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-c":
            opts["inputs"] = argv[i + 1 :]
            break
        elif a in ("-o", "-O"):
            opts["output"] = argv[i + 1]
            opts["copy_arp"] = a == "-O"
            i += 1
        elif a == "-s":
            opts["sidecar"] = "use"
        elif a == "-S":
            opts["sidecar"] = "require"
        elif a == "-p":
            opts["profiles"].append(argv[i + 1])
            i += 1
        elif a == "-d":
            opts["use_default"] = True
        elif a.startswith("-j") and not a.startswith("-js"):
            opts["format"] = "jpg"
            if len(a) > 2:
                opts["quality"] = int(a[2:])
        elif a.startswith("-js"):
            # -js<1-3>: 1 = best compression (4:2:0) .. 3 = 4:4:4
            opts["subsampling"] = int(a[3:] or 3)
        elif a.startswith("-t"):
            opts["format"] = "tif"
            # ART-cli: -t = uncompressed TIFF, -tz = deflate
            opts["tiff_uncompressed"] = "z" not in a[2:]
        elif a == "-n":
            opts["format"] = "png"
        elif a.startswith("-b"):
            opts["bits"] = int(a[2:].rstrip("f"))
        elif a == "-Y":
            opts["overwrite"] = True
        elif a in ("-q", "-a"):
            opts["fast"] = a == "-q"
        elif a == "--devices":
            opts["devices"] = int(argv[i + 1])
            i += 1
        elif a == "--bench":
            opts["bench"] = True
        elif a == "--progress":
            opts["progress"] = True
        elif a == "--gamut-warn":
            opts["gamut_warn"] = argv[i + 1]
            i += 1
        elif a == "-V":
            from art_tpu_torch.settings import settings as _settings

            _settings.verbose = True
        elif a in ("-h", "--help"):
            _usage()
            raise SystemExit(0)
        i += 1
    return opts


def compose_params(path, opts) -> ProcParams:
    """Profile composition (main-cli.cc:679-846 / ART.1:60-70)."""
    pp = ProcParams()
    if opts.get("use_default"):
        # -d: the Options-tier default profile (Profiles/RawDefault —
        # "Dynamic" runs the dynamic profile rules, a name resolves in
        # the profile store, "Neutral" is the built-in default); rule
        # matching only needs the EXIF header, not a full decode
        from art_tpu_torch.io.rawfile import is_raw_file
        from art_tpu_torch.options import get_options

        o = get_options()
        defprof = o.def_prof_raw if is_raw_file(path) else o.def_prof_img
        if defprof == "Dynamic":
            import types

            from art_tpu_torch.io.metadata import harvest
            from art_tpu_torch.profiles import default_params_for

            try:
                tags, _ = harvest(path)
            except Exception:
                tags = {}
            iso = tags.get("iso")
            shim = types.SimpleNamespace(
                iso=iso[0] if isinstance(iso, tuple) else iso,
                exif=tags, make=tags.get("make", ""),
                model=tags.get("model", ""))
            pp = default_params_for(shim)
        elif defprof not in ("Neutral", ""):
            from art_tpu_torch.profiles import get_store as _gs

            resolved = _gs().resolve(defprof)
            if resolved:
                pp.update_from_keyfile(KeyFile.load(resolved))
    from art_tpu_torch.profiles import get_store

    store = get_store()
    for prof in opts["profiles"]:
        resolved = store.resolve(prof) or prof
        pp.update_from_keyfile(KeyFile.load(resolved))
    if opts["sidecar"]:
        sidecar = path + ".arp"
        if os.path.exists(sidecar):
            pp.update_from_keyfile(KeyFile.load(sidecar))
        elif opts["sidecar"] == "require":
            return None
    if opts.get("fast"):
        _adjust_fast_params(pp)
    return pp


def _adjust_fast_params(pp):
    """-q fast export: force-enable resize bounded by the Options-tier
    fast-export dimensions (fastexport.cc adjust_fast_params)."""
    from art_tpu_torch.options import get_options

    o = get_options()
    pp.resize.unit = "px"
    if pp.resize.enabled:
        pp.resize.width = min(pp.resize.width, o.fast_export_resize_width)
        pp.resize.height = min(pp.resize.height,
                               o.fast_export_resize_height)
    else:
        pp.resize.width = o.fast_export_resize_width
        pp.resize.height = o.fast_export_resize_height
    pp.resize.enabled = True
    pp.resize.scale = 1.0
    pp.resize.applies_to = "Cropped area"
    pp.resize.data_specified = 3
    pp.resize.allow_upscaling = False


def output_path_for(inp, opts):
    fmt = opts["format"] or "jpg"
    base = os.path.splitext(os.path.basename(inp))[0] + "." + fmt
    out = opts["output"]
    if out is None:
        return os.path.join(os.path.dirname(inp), base)
    if os.path.isdir(out) or out.endswith(os.sep):
        return os.path.join(out, base)
    return out


def make_icc_main(args):
    """--make-icc (rtgui/makeicc.cc ART_makeicc_main): preset primaries +
    TRC to an .icc file. Supported subset: -p preset, -t TRC name,
    -d description, -o output, -v2 accepted."""
    from art_tpu_torch.color.iccwrite import make_icc

    preset, desc, out = "sRGB", None, None
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-p":
            preset = args[i + 1]
            i += 1
        elif a == "-d":
            desc = args[i + 1]
            i += 1
        elif a == "-o":
            out = args[i + 1]
            i += 1
        elif a in ("-t", "-g", "-s", "-w", "-i"):
            i += 1  # accepted; preset TRCs are used
        elif a == "-c":
            i += 6
        i += 1
    if not out:
        print("ERROR: -o output name is mandatory", file=sys.stderr)
        return 1
    names = {"srgb": "sRGB", "adobergb": "Adobe RGB",
             "prophoto": "ProPhoto", "rec2020": "Rec2020",
             "acesp0": "ACESp0", "acesp1": "ACESp1"}
    prof = names.get(preset.lower().replace(" ", ""), preset)
    data = make_icc(prof, desc)
    if data is None:
        print(f"ERROR: unknown primaries preset {preset}", file=sys.stderr)
        return 1
    with open(out, "wb") as f:
        f.write(data)
    return 0


def check_lut_main(args):
    """--check-lut (main-cli.cc:105-126): exit 0 iff the LUT loads, 1
    ("Invalid LUT file") if it does not; 2, naming the format, for an
    image the port's decoder does not read, which it cannot judge."""
    if not args:
        print("invalid arguments to --check-lut")
        return 2
    from art_tpu_torch.color.lut3d import load_lut3d

    try:
        load_lut3d(args[0])
    except NotImplementedError as e:
        print(f"error: --check-lut: {e}", file=sys.stderr)
        return 2
    except Exception:
        print(f"Invalid LUT file: {args[0]}")
        return 1
    return 0


def _batch_main(opts, device):
    """The inputs through `parallel.queue.process_batch` over the first
    N visible CUDA devices (N workers on the CPU for device="cpu"), with
    the serial path's sidecar skips and -Y check; exit 0 if every job
    succeeded, else 2."""
    import torch

    from art_tpu_torch.parallel import process_batch

    jobs = []
    for inp in opts["inputs"]:
        pp = compose_params(inp, opts)
        if pp is None:
            print(f"skipping {inp} (no sidecar)")
            continue
        outp = output_path_for(inp, opts)
        if os.path.exists(outp) and not opts["overwrite"]:
            print(f"error: output {outp} exists (use -Y)", file=sys.stderr)
            continue
        jobs.append((inp, pp, outp))
    if torch.device(device).type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(min(opts["devices"], count))]
    else:
        devices = [device] * opts["devices"]
    results = process_batch(jobs, devices=devices or None,
                            progress=lambda i, o: print(f"-> {o}"))
    return 0 if all(results) else 2


def main(argv=None, device="cuda"):
    """Run the CLI on argv (default sys.argv[1:]); develop on `device`.
    Returns the exit code: 0, or 2 if a file failed."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        _usage()
        return 1
    if argv[0] == "--make-icc":
        return make_icc_main(argv[1:])
    if argv[0] == "--check-lut":
        return check_lut_main(argv[1:])
    opts = parse_args(argv)
    if not opts["inputs"]:
        print("error: no input files (-c)", file=sys.stderr)
        return 2

    import art_tpu_torch

    art_tpu_torch.init()
    # Options tier (rtgui/options.cc KeyFile): CLI flags win; the app
    # options fill defaults the way main-cli.cc's globals do
    from art_tpu_torch.options import load_options

    app_opts = load_options()
    if opts["format"] is None and app_opts.format in ("jpg", "png", "tif"):
        opts["format"] = app_opts.format
    if opts["quality"] is None:
        opts["quality"] = app_opts.jpeg_quality
    if opts["bits"] is None and opts["format"] == "tif":
        opts["bits"] = app_opts.tiff_bits
    elif opts["bits"] is None and opts["format"] == "png":
        opts["bits"] = app_opts.png_bits
    from art_tpu_torch.pipeline.develop import process_image

    if opts["devices"] > 1 and len(opts["inputs"]) > 1:
        # the batch queue, one worker per device
        return _batch_main(opts, device)

    errors = 0
    n_files = max(len(opts["inputs"]), 1)
    done = 0

    def _progress(pct):
        # GIMP-plugin protocol (main-cli.cc:297-350): bare percent lines
        if opts.get("progress"):
            print(f"\n{min(int(pct), 99)}", flush=True)

    for inp in opts["inputs"]:
        pp = compose_params(inp, opts)
        if pp is None:
            print(f"skipping {inp} (no sidecar)")
            continue
        outp = output_path_for(inp, opts)
        if os.path.exists(outp) and not opts["overwrite"]:
            print(f"error: output {outp} exists (use -Y)", file=sys.stderr)
            errors += 1
            continue
        bits = opts["bits"] or (8 if (opts["format"] or "jpg") == "jpg" else
                                16 if opts["format"] == "tif" else 8)
        try:
            _progress(done * 100.0 / n_files)
            t0 = time.time()
            # within-file phase milestones ride the ProgressListener
            # surface (rtengine.h:150-166; percent protocol
            # main-cli.cc:297-350)
            from art_tpu_torch.pipeline.listeners import CallbackListener

            base = done * 100.0 / n_files
            lst = CallbackListener(
                on_progress=lambda f: _progress(base + f * 100.0 / n_files))
            process_image(inp, pp, fast=opts["fast"], output_path=outp,
                          bits=bits, quality=opts["quality"],
                          uncompressed=opts.get("tiff_uncompressed", False),
                          gamut_warn=opts.get("gamut_warn"),
                          subsampling=opts.get("subsampling", 3),
                          listener=lst, device=device)
            dt = time.time() - t0
            done += 1
            _progress(done * 100.0 / n_files)
            if opts["bench"]:
                print(f"{inp} -> {outp} ({dt*1000:.0f} ms)")
            else:
                print(f"{inp} -> {outp}")
            if opts["copy_arp"]:
                pp.save(outp + ".arp")
        except Exception as e:  # per-file error handling (main-cli.cc:797)
            print(f"error processing {inp}: {e}", file=sys.stderr)
            errors += 1
    return 0 if errors == 0 else 2


if __name__ == "__main__":
    raise SystemExit(main())
