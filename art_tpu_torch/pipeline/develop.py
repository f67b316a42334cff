"""The develop pipeline (counterpart of ``art_tpu/pipeline/develop.py``).

`plan` folds a frame and its ProcParams into a `PipelineConfig` and a
dict of numpy arrays, as the reference's planner does, restricted to the
steps this package has ported; any other step or parameter raises
NotImplementedError naming it. `build_run` returns the device program
for a config, in the reference's order: u16 widen; the raw calibration
(dark frame, embedded gain map, flat field); black/scale; the lens
vignette gains (LCP, metadata or lensfun); on a Bayer mosaic the
.badpixels file's sites, the hot/dead filter, green equilibration, CFA
line denoise, the PDAF line filter and raw CA correction; AMaZE
(kernels B1-B3), RCD or bilinear demosaic, or an X-Trans method;
highlight recovery (ColorSoft, Color); the raw head (WB
multipliers, Blend, clip, cam2work), fused into the denoise kernel B4
when the reference's `fuse_head` gate opens, else applied on its own,
with fast export's early Lanczos resize before its matrix; a DCP input
profile's matrices and HueSatMap (`color/dcp.py`) in place of the
matrix, or an ICC input profile's shaper TRC or LUT stages
(`color/icclut.py`) before it; the stage-0
ops: the denoise (B4, or B5 and B6 on the non-fused path, or their
whole-plane versions below one tile) and dehaze; the coarse rotation
and flips, the geometric transform (rotation, perspective, distortion,
CA, lens maps: `pipeline/transform.py`) and the crop; the stage 1-3
ops: the tone equalizer, sharpening, impulse denoise, the film
simulation, the tone curve and local contrast; the Lanczos resize and
post-resize sharpening; then the output transform (work2out, clip,
TRC, or an ICC output profile's TRC or LUT stages), fused into the
Neutral tone-curve kernel B7 when the `fuse_tail` gate opens, else
applied on its own; and for an 8-bit JPEG, the
conversion to interleaved uint8 (`out_u8`). `data_to_torch` moves
either planner's data to a device, so the reference's own plan can
drive this runner.
`develop` chains plan -> device -> `crop_result`, and `process_image`
decodes a raw file, develops it and saves the result with its metadata.
The staged pieces between them (`host_input`, `device_input`,
`read_back`, with a reusable `PinnedBuffer` where the caller keeps one)
are those of the batch queue (`parallel/queue.py`), so both give the
same bytes.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from art_tpu_torch.settings import PAD_MULTIPLE
from art_tpu_torch import ops as ops_pkg
from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color.iccstore import output_trc
from art_tpu_torch.core.fmath import fdiv, fsqrt, interp, mat3
from art_tpu_torch.core.image import (MAXVAL, bayer_channel_masks,
                                     pad_to_multiple)
from art_tpu_torch.core.profile import span
from art_tpu_torch.ops.resize import apply_resize, resize_plan
from art_tpu_torch.pipeline.transform import (apply_transform,
                                              needs_transform,
                                              plan_transform)
from art_tpu_torch.raw import preprocess as rawpre
from art_tpu_torch.raw import wb as wbmod


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Hashable static pipeline description (a copy of the reference's
    PipelineConfig; the fields mean the same)."""

    pattern: str | None
    xtrans: tuple | None
    is_raw: bool
    demosaic_method: str
    do_clip: bool
    working_profile: str
    out_trc: tuple
    shape: tuple  # padded (H, W)
    orig_shape: tuple  # true (H, W)
    steps: tuple = ()  # (op_name, static, stage) for enabled ops
    late_crop: bool = False
    crop: tuple | None = None
    resize_to: tuple | None = None
    early_resize: tuple | None = None
    prsharp: tuple | None = None
    coarse: tuple = (0, False, False)
    transform: bool = False
    linedn: tuple = (0.0, 3)
    ca_mode: tuple | None = None
    hotdead: tuple | None = None
    badpix_file: bool = False
    green_eq: float = 0.0
    hl_mode: str = "Off"
    pdaf: bool = False
    dem_kwargs: tuple = ()
    dcp: tuple | None = None
    icc_input_trc: tuple | None = None
    pixelshift: bool = False
    darkframe: bool = False
    flatfield: tuple | None = None
    gainmap: bool = False
    out_u8: bool = False


def _unported(what):
    raise NotImplementedError(f"{what} is not ported to art_tpu_torch")


def _refuse_non_raw():
    """The develop of a non-raw frame (``io/imagefile.py::
    load_std_image``'s RGB payload), which the reference's plan fails on:
    its RGB branch passes ``pixelshift`` (art_tpu/pipeline/develop.py:715),
    which only its raw branch binds (:132), so every such frame raises
    UnboundLocalError there. The port refuses it by name instead."""
    raise NotImplementedError(
        "non-raw input: the reference's plan fails on every non-raw frame "
        "(art_tpu/pipeline/develop.py:715 reads `pixelshift`, which only "
        ":132 binds), so art_tpu_torch refuses its develop")


def _auto_log(frame, pp, device):
    """pp with the automatic log encoding resolved (develop.py:462-477,
    getAutoLog): a neutral develop of the frame subsampled 8x on `device`
    sets the gain and the black and white EVs where auto gain is on, and
    both autos turn off; on a copy, so the caller's pp keeps its autos.
    A failure of that develop raises (the reference falls back to the
    manual values on any error). A frame too small to subsample keeps
    them, as the reference's empty render does."""
    lp = pp.logenc
    if not (lp.enabled and (lp.auto_gain or lp.auto_gray)):
        return pp
    import copy

    from art_tpu_torch.pipeline.autos import auto_log_params

    pp = copy.deepcopy(pp)
    h, w = frame.cfa.shape[-2:]
    if frame.pattern is not None and min(h, w) < 16:
        return pp
    gain, black_ev, white_ev = auto_log_params(frame, pp, device)
    from art_tpu_torch.pipeline.listeners import report_auto

    report_auto("log", (gain, black_ev, white_ev))
    if pp.logenc.auto_gain:
        pp.logenc.gain = gain
        pp.logenc.black_ev = black_ev
        pp.logenc.white_ev = white_ev
    pp.logenc.auto_gain = False
    pp.logenc.auto_gray = False
    return pp


def _plan_raw_steps(frame, pp, shape, data):
    """The planned raw steps after the scale, as the reference plans them
    (develop.py:214-250): (hotdead, green_eq, linedn, pdaf, ca_mode), and
    PDAF's row mask of the padded height in data["pdaf_rows"]. Green
    equilibration, CFA line denoise, the PDAF filter and raw CA apply to a
    Bayer mosaic only; the hot/dead filter is planned for any raw frame
    and runs on a Bayer one."""
    raw, bayer = pp.raw, pp.raw.bayer
    hotdead = None
    if raw.hotdead_enabled and (raw.hotpixel_filter or raw.deadpixel_filter):
        hotdead = (bool(raw.hotpixel_filter), bool(raw.deadpixel_filter),
                   float(raw.hotdead_thresh))
    green_eq, linedn, pdaf, ca_mode = 0.0, (0.0, 3), False, None
    if frame.pattern is None:
        return hotdead, green_eq, linedn, pdaf, ca_mode
    if bayer.green_eq_enabled and bayer.green_eq > 0:
        green_eq = float(bayer.green_eq) / 100.0
    if bayer.green_eq_enabled and bayer.linenoise > 0:
        linedn = (float(bayer.linenoise), int(bayer.linenoise_direction))
    if bayer.pdaf_lines_filter:
        from art_tpu_torch.raw.camconst import get_instance

        cc = get_instance().get(frame.make, frame.model)
        pd = cc.pdaf() if cc is not None else None
        if pd:
            from art_tpu_torch.raw.pdaf import pdaf_row_mask

            data["pdaf_rows"] = pdaf_row_mask(pd[0], pd[1],
                                              shape[0]).astype(np.float32)
            pdaf = True
    if raw.ca_enabled:
        if raw.ca_autocorrect:
            ca_mode = ("auto", 0.0, 0.0)
        elif raw.ca_red != 0 or raw.ca_blue != 0:
            ca_mode = ("manual", float(raw.ca_red), float(raw.ca_blue))
    return hotdead, green_eq, linedn, pdaf, ca_mode


def _padded_f32(plane):
    """A host plane reflect-padded to the planned shape, as float32."""
    return np.asarray(pad_to_multiple(plane, PAD_MULTIPLE)[0],
                      dtype=np.float32)


def _calibration_frame(path, frame):
    """A dark or flat frame's mosaic, where `path` names a file whose
    mosaic has the frame's shape (the reference skips any other)."""
    if not (path and os.path.isfile(path)):
        return None
    from art_tpu_torch.io.rawfile import load_raw

    cal = load_raw(path)
    return cal.cfa if cal.cfa.shape == frame.cfa.shape else None


def _plan_calibration(frame, pp, data):
    """The raw calibration the reference plans (develop.py:199-212,
    252-319): the user .badpixels file's mask, the dark frame (by path or
    by its search), the embedded DNG gain map, the flat field (by path or
    by its search, unless a gain map applies); each plane padded to the
    planned shape. None of them for a Foveon frame. Returns (darkframe,
    flatfield, gainmap)."""
    from art_tpu_torch.raw.badpixfile import (badpixel_mask,
                                              find_badpixels_for,
                                              parse_badpixels_file)

    if frame.cfa.ndim == 3:  # Foveon: no CFA-domain calibration
        return False, None, False
    raw = pp.raw
    bp_file = find_badpixels_for(frame.make, frame.model)
    if bp_file:
        pts = parse_badpixels_file(bp_file)
        if pts:
            data["badpix_mask"] = _padded_f32(
                badpixel_mask(pts, frame.cfa.shape).astype(np.float32))

    df_path = raw.df_file if (raw.df_enabled and raw.df_file) else ""
    if raw.df_enabled and raw.df_autoselect:
        from art_tpu_torch.raw.dfff_managers import df_manager

        found = df_manager().search(frame.make, frame.model, frame.iso,
                                    frame.exif.get("exposure_time", 0.0))
        if found:
            df_path = found
    dark = _calibration_frame(df_path, frame)
    if dark is not None:
        data["df_plane"] = _padded_f32(dark)

    # a gain map whose parse fails is skipped on the host, as in the
    # reference (develop.py:275-294)
    gainmap = False
    if raw.ff_enabled and raw.ff_embedded and frame.filename:
        try:
            from art_tpu_torch.io.gainmap import (build_gain_plane,
                                                  parse_gain_maps,
                                                  read_opcodelist2)

            maps = parse_gain_maps(read_opcodelist2(frame.filename))
            sf = max((100.0 - float(raw.ff_clip_control)) / 100.0, 0.01)
            plane = build_gain_plane(maps, frame.cfa.shape, sf)
            if plane is not None:
                data["gain_plane"] = _padded_f32(plane)
                gainmap = True
        except Exception:
            gainmap = False

    flatfield = None
    ff_path = raw.ff_file if (raw.ff_enabled and raw.ff_file) else ""
    if not gainmap and raw.ff_enabled and raw.ff_autoselect:
        from art_tpu_torch.raw.dfff_managers import ff_manager

        found = ff_manager().search(
            frame.make, frame.model, frame.exif.get("lens_model", ""),
            frame.exif.get("focal_length", 0.0),
            frame.exif.get("f_number", 0.0))
        if found:
            ff_path = found
    flat = None if gainmap else _calibration_frame(ff_path, frame)
    if flat is not None:
        data["ff_plane"] = _padded_f32(flat)
        bt = (raw.ff_blur_type or "area").lower()
        bt = {"area flatfield": "area", "vertical": "v",
              "horizontal": "h", "v+h": "vh"}.get(bt, bt)
        flatfield = (bt, int(raw.ff_blur_radius))
    return dark is not None, flatfield, gainmap


def _plan_raw_vignette(frame, pp, data, w, h):
    """The lens vignette gains on the raw plane (develop.py:321-359): an
    LCP profile's (not a fisheye's), or the metadata's or lensfun's,
    a spline or the DNG FixVignetteRadial polynomial; centres from the
    frame's true (w, h). None for a Foveon frame."""
    lp = pp.lens_prof
    if frame.cfa.ndim == 3:
        return
    focal = float(frame.exif.get("focal_length", 0.0) or 0.0)
    if lp.method == "lcp" and lp.lcp_file and lp.use_vign:
        from art_tpu_torch.lens.lcp import parse_lcp

        prof = parse_lcp(lp.lcp_file)
        if prof is not None and not prof.is_fisheye:
            vm = prof.vignette(
                focal, float(frame.exif.get("f_number", 0.0) or 0.0))
            if vm is not None:
                x0, y0, fx, fy = vm.geometry(w, h, focal)
                data["lcp_vign"] = np.asarray(
                    [x0, y0, 1.0 / fx, 1.0 / fy] + list(vm.vign_param()),
                    dtype=np.float32)
    elif lp.method in ("exif", "lfauto", "lfmanual") and lp.use_vign:
        if lp.method == "exif":
            from art_tpu_torch.lens import exifcorr

            corr = exifcorr.for_frame(frame)
        else:
            from art_tpu_torch.lens import lensfun

            corr = lensfun.for_frame(pp, frame)
        if corr is not None and corr.has_vign:
            if corr.kind == "spline":
                data["exif_vign"] = np.stack(
                    [corr.knots, corr.vig]).astype(np.float32)
            else:
                cx = corr.center_v[0] * w
                cy = corr.center_v[1] * h
                m2 = 1.0 / (max(cx, w - cx) ** 2 + max(cy, h - cy) ** 2)
                data["exif_vign_dng"] = np.asarray(
                    [cx, cy, m2] + list(corr.vign_radial), np.float32)


def _plan_input_profile(frame, pp, data, ctx, icc_working, wb_mults):
    """A camera profile file (develop.py:383-444): an ICC one's matrix
    and shaper TRC, or its A2B LUT stages with an XYZ-to-working matrix
    (any failure keeps the camera matrix, as in the reference); a DCP
    one's matrices and tables at the shot's temperature, its step 2 (the
    look, the tone curve, the baseline exposure) left in
    ctx["dcp_step2"] for the DCP look op. A file that does not exist
    keeps the camera matrix. Returns (dcp static, input TRC)."""
    ip = pp.icm.input_profile
    dcp_static = icc_input_trc = None
    if not (isinstance(ip, str) and os.path.isfile(ip)):
        return dcp_static, icc_input_trc
    if ip.lower().endswith((".icc", ".icm")):
        try:
            from art_tpu_torch.color.iccfile import load_icc

            prof = load_icc(ip)
            if prof.get("kind") == "lut":
                if prof["a2b"] is not None:
                    from art_tpu_torch.color.icclut import plan_lut

                    stages, ldata = plan_lut(prof["a2b"], prof["pcs"], "in")
                    for k, v in ldata.items():
                        data[f"iccin:{k}"] = v
                    data["cam2work"] = cs.MATRICES_XYZ_TO_RGB[
                        icc_working].astype(np.float32)
                    icc_input_trc = ("icclut", stages)
            else:
                data["cam2work"] = (cs.MATRICES_XYZ_TO_RGB[icc_working]
                                    @ prof["rgb_to_xyz"]).astype(np.float32)
                if prof["trc"][0] != "linear":
                    icc_input_trc = prof["trc"]
        except Exception:
            pass
    if ip.lower().endswith(".dcp"):
        from art_tpu_torch.color.dcp import load_dcp, plan_dcp

        if pp.wb.enabled and pp.wb.method in ("Custom", "CustomTemp"):
            wb_temp = float(pp.wb.temperature)
        else:
            wb_temp, _ = wbmod.mul2temp(*np.asarray(wb_mults)[:3])
        dcp_static, step2, dcp_data = plan_dcp(
            load_dcp(ip), frame, wb_temp,
            cs.MATRICES_XYZ_TO_RGB[icc_working], icm=pp.icm)
        if step2 is not None:
            ctx["dcp_step2"] = (step2, {
                k: dcp_data[k] for k in ("dcp_work2pro", "dcp_pro2work",
                                         "dcp_look", "dcp_tc")
                if k in dcp_data})
        for k in ("dcp_work2pro", "dcp_look", "dcp_tc"):
            dcp_data.pop(k, None)
        data.update(dcp_data)
    return dcp_static, icc_input_trc


def _has_jpeg_preview(path) -> bool:
    """Whether the file holds an embedded preview whose bytes start as a
    JPEG's, where the reference's `io/metadata.py::embedded_thumb` would
    decode one. A file it cannot read or parse has none."""
    from art_tpu_torch.io.metadata import harvest

    try:
        _, previews = harvest(path)
        with open(path, "rb") as f:
            for off, _ in previews:
                f.seek(off)
                if f.read(2) == b"\xff\xd8":
                    return True
    except Exception:
        return False
    return False


def _hist_match(frame, pp, device):
    """pp with the histogram-matched tone curve resolved (develop.py:
    480-503, histmatching.cc:444): where a raw asks for it and its file
    holds a JPEG preview, the points that map a neutral render of the
    frame subsampled 8x (on `device`) onto the largest preview become an
    enabled curve, marked as matched, and go to the listener; on a copy,
    so the caller's pp keeps asking. The reference skips the step on any
    failure; the port skips where it would fail: no preview, one that
    neither of Pillow's loads decodes, a frame too small to render. A
    preview form Pillow decodes and the port does not raises, and so
    does a render that fails on the card."""
    tc = pp.tone_curve
    if not (frame.is_raw and tc.histmatching and not tc.from_histmatching
            and frame.filename):
        return pp
    from art_tpu_torch.io import metadata
    from art_tpu_torch.pipeline import autos

    thumb = metadata.embedded_thumb(frame.filename)
    if thumb is None:
        return pp
    h, w = frame.cfa.shape[-2:]
    if frame.pattern is not None and min(h, w) < 16:
        return pp
    small = autos.histogram_matching_render(frame, device)
    pts = autos.histogram_matching_curve(small, thumb)
    import copy

    pp = copy.deepcopy(pp)
    pp.tone_curve.enabled = True
    pp.tone_curve.curve = pts
    pp.tone_curve.from_histmatching = True
    from art_tpu_torch.pipeline.listeners import report_auto

    report_auto("matched_curve", pts)
    return pp


def _check_autos(frame, pp):
    """Refuse auto distortion (develop.py:542-553,
    lens/autos.py::auto_distortion_for, OpenCV) where the file holds a
    JPEG preview to estimate it from."""
    if (pp.distortion.enabled and pp.distortion.auto_compute
            and frame.filename and _has_jpeg_preview(frame.filename)):
        _unported("auto distortion (lens/autos.py::auto_distortion_for)")


def _resolve_output_profile(name: str) -> str:
    """Output-profile name -> named colorspace, or the path of a user
    .icc/.icm file that exists, by its path or by its name in
    <user_dir>/iccprofiles (develop.py::_resolve_output_profile,
    iccstore.cc:224-366); any other name resolves by substring, as in
    the reference."""
    from art_tpu_torch.settings import settings

    n = (name or "").lower()
    if n.endswith((".icc", ".icm")):
        if os.path.isfile(name):
            return name
        if settings.user_dir:
            cand = os.path.join(settings.user_dir, "iccprofiles",
                                os.path.basename(name))
            if os.path.isfile(cand):
                return cand
    if "2020" in n:
        return "Rec2020"
    if "adobe" in n or "medium" in n:
        return "Adobe RGB"
    if "prophoto" in n or "large" in n:
        return "ProPhoto"
    if "acesp0" in n:
        return "ACESp0"
    if "acesp1" in n or "ap1" in n:
        return "ACESp1"
    return "sRGB"


def _resize_scale(pp, h, w, crop=None):
    """resizeScale (develop.py::_resize_scale, ipresize.cc:226): the scale
    factor by DataSpecified (0 scale, 1 width, 2 height, 3 fit box) of the
    crop or the whole image (AppliesTo), 1 where it would upscale without
    AllowUpscaling or is within 1e-5 of 1."""
    rs = pp.resize
    if not rs.enabled:
        return 1.0
    if crop is not None and rs.applies_to == "Cropped area":
        refh, refw = crop[2], crop[3]
    else:
        refh, refw = h, w
    ds = rs.data_specified
    if ds == 1:
        scale = rs.width / refw if rs.width > 0 else 1.0
    elif ds == 2:
        scale = rs.height / refh if rs.height > 0 else 1.0
    elif ds == 3:  # fit box
        sw = rs.width / refw if rs.width > 0 else 1.0
        sh = rs.height / refh if rs.height > 0 else 1.0
        scale = min(sw, sh)
        if scale > 1.0 and not rs.allow_upscaling:
            scale = 1.0
    else:
        scale = rs.scale
    if abs(scale - 1.0) <= 1e-5:
        return 1.0
    if scale > 1.0 and not rs.allow_upscaling:
        return 1.0
    return scale


def _map_tree(obj, fn):
    if isinstance(obj, dict):
        return {k: _map_tree(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tree(v, fn) for v in obj)
    return fn(obj)


def fit_op_planes(data, steps, dims, shape, late_crop, crop):
    """The (H, W) planes of the stage 1-3 ops' data at the image they meet
    (develop.py:625-662): edge-padded to the padded `shape` on the
    late-crop path, else sliced to the crop window (ipf.setViewport).
    dims is the image's (H, W) after coarse rotation."""
    h, w = dims

    def pad_plane(a):
        if (isinstance(a, np.ndarray) and a.ndim >= 2
                and a.shape[-2:] == (h, w) and a.shape[-2:] != tuple(shape)):
            pad = [(0, 0)] * (a.ndim - 2) + [
                (0, shape[0] - h), (0, shape[1] - w)]
            return np.pad(a, pad, mode="edge")
        return a

    def crop_plane(a):
        if (isinstance(a, np.ndarray) and a.ndim >= 2
                and a.shape[-2:] == (h, w)):
            cy, cx, ch, cw = crop
            return np.ascontiguousarray(a[..., cy : cy + ch, cx : cx + cw])
        return a

    fn = pad_plane if late_crop else crop_plane if crop is not None else None
    if fn is not None:
        for name, _, stage in steps:
            if stage > 0:
                data[f"op:{name}"] = _map_tree(data[f"op:{name}"], fn)


def _dem_kwargs(method, sensor, bayer):
    """The method's demosaic kwargs, as pairs (develop.py:143-158): the
    dual blend's contrast and auto for names ending in bilinear or vng4
    and for X-Trans 4-pass, LMMSE's iterations, DCB's iterations and
    enhance (also for its duals)."""
    ml = method.lower()
    kw = []
    if (ml.endswith("bilinear") or ml.endswith("vng4")
            or ml.startswith("4-pass")):
        kw += [("dual_contrast", float(sensor.dual_demosaic_contrast)),
               ("dual_auto", bool(sensor.dual_demosaic_auto_contrast))]
    if ml == "lmmse":
        kw.append(("iterations", int(bayer.lmmse_iterations)))
    if ml.startswith("dcb"):
        kw += [("iterations", int(bayer.dcb_iterations)),
               ("enhance", bool(bayer.dcb_enhance))]
    return kw


def plan(frame, pp, fast=False, out_u8=False, device="cuda"):
    """ProcParams + frame -> (PipelineConfig, data) for the ported slice:
    a Bayer raw frame (dark frame, gain map, flat field, lens vignette,
    .badpixels, hot/dead pixels, green equilibration, line denoise, PDAF
    lines, raw CA; every demosaic method of the reference, pixel shift
    with the frame's 3 extra frames), an X-Trans one or a Foveon one
    (3 planes, no CFA step), highlight recovery, the ported ops
    (`ops.PORTED`) and their region masks, coarse rotation and flips,
    the geometric transform with its lens corrections (LCP,
    metadata, lensfun), the crop, the Lanczos resize with post-resize
    sharpening; camera, CustomMult, temperature (Custom) or grey-world
    (Auto, `pipeline/autos.py::auto_wb_multipliers`) white balance;
    a DCP or ICC camera profile; a named or ICC output profile.
    fast=True is the reference's fast export (-q), active only with a
    resize: the demosaic downgrades, the image is resized right after
    the raw stage and every later step runs at output scale. out_u8
    plans the reference's device-side 8-bit output: interleaved
    (H, W, 3) uint8 in place of (3, H, W) float planes. device: where the
    automatic log encoding and the histogram-matched curve render their
    neutral develops and the region masks blur and resample their planes
    (the device of the develop that plans). pp itself is not changed.
    Anything else raises NotImplementedError."""
    if not frame.is_raw:
        _refuse_non_raw()
    # a Sigma Foveon X3F: 3 full planes, no mosaic (develop.py:112-126)
    foveon = frame.cfa.ndim == 3
    if not foveon and frame.pattern is None and frame.xtrans is None:
        _unported("monochrome raw with no CFA")
    fast = bool(fast and pp.resize.enabled)
    if fast:
        import copy

        pp = copy.deepcopy(pp)
        if pp.raw.xtrans.method.lower().startswith("3-pass"):
            pp.raw.xtrans.method = "1-pass (medium)"
        if pp.raw.bayer.method.lower() == "pixelshift":
            pp.raw.bayer.method = "amaze"
    icc_working = pp.icm.working_profile
    if icc_working not in cs.MATRICES_RGB_TO_XYZ:
        icc_working = "Rec2020"
    data = {}
    ctx = {"working_profile": icc_working, "frame": frame, "pp": pp,
           "device": device}

    h, w = frame.cfa.shape[-2:]
    pm = PAD_MULTIPLE
    shape = (((h + pm - 1) // pm) * pm, ((w + pm - 1) // pm) * pm)
    bayer_adjust = None
    if frame.pattern is not None and pp.raw.bayer.black_enabled:
        b = pp.raw.bayer
        bayer_adjust = [b.black1, b.black0, b.black2, b.black3]
    raw_expos = pp.raw.expos if pp.raw.expos_enabled else 1.0
    sensor = pp.raw.bayer if frame.pattern is not None else pp.raw.xtrans
    method = "foveon" if foveon else sensor.method
    # pixel shift needs the 3 extra frames; a single frame develops with
    # AMaZE (develop.py:131-139, the rawimagesource.cc:1888 fallback)
    pixelshift = False
    if method.lower() == "pixelshift":
        extra = frame.extra_frames
        if extra is not None and len(extra) == 3:
            pixelshift = True
            data["ps_frames"] = _padded_f32(np.asarray(extra, np.float32))
        else:
            method = "amaze"
    dem_kwargs = _dem_kwargs(method, sensor, pp.raw.bayer)

    if pp.wb.enabled and pp.wb.method in ("Custom", "CustomTemp"):
        wb_mults = wbmod.temp2mul(pp.wb.temperature, pp.wb.green,
                                  pp.wb.equal)
    elif pp.wb.enabled and pp.wb.method in ("CustomMult",
                                            "CustomMultLegacy"):
        m = np.asarray(pp.wb.mult, dtype=np.float64)
        wb_mults = np.array([m[0] / m[1], 1.0, m[2] / m[1]])
    elif pp.wb.enabled and pp.wb.method == "Auto" and not foveon:
        from art_tpu_torch.pipeline.autos import auto_wb_multipliers

        wb_mults = auto_wb_multipliers(frame)
        try:
            from art_tpu_torch.pipeline.listeners import report_auto

            report_auto("wb", wbmod.mul2temp(*np.asarray(wb_mults)[:3]))
        except Exception:
            pass
    else:
        wb_mults = frame.camera_wb_mults()

    is_mono = method == "mono"
    if foveon:
        splan = rawpre.scale_plan_foveon(frame, raw_expos, wb_mults)
        data["raw_offset"] = splan["offset3"]
        data["raw_scale"] = splan["scale3"]
    else:
        splan = rawpre.scale_plan(frame, bayer_adjust, raw_expos,
                                  is_mono=is_mono, wb_mults_rgb=wb_mults)
        data["raw_offset"] = splan["offset_tile"]
        data["raw_scale"] = splan["scale_tile"]
    mults, _ = wbmod.image_multipliers(
        frame, wb_mults, splan["scale_mul"], splan["c_white"],
        splan["cblack"], raw_expos, is_mono=is_mono)
    data["rgb_mults"] = mults.astype(np.float32)
    data["init_gain"] = np.float32(splan["gain"])
    darkframe, flatfield, gainmap = _plan_calibration(frame, pp, data)
    hotdead, green_eq, linedn, pdaf, ca_mode = _plan_raw_steps(
        frame, pp, shape, data)
    _plan_raw_vignette(frame, pp, data, w, h)

    # highlight reconstruction (develop.py:363-380), on a CFA frame
    hl_mode = "Off"
    if pp.exposure.enabled and pp.exposure.hrmode != "Off" and not foveon:
        hl_mode = {"Blend": "blend", "Color": "inpaint",
                   "ColorSoft": "opposed"}.get(pp.exposure.hrmode, "Off")
    if hl_mode != "Off":
        wb_cam = wbmod.wb_camera_multipliers(frame, wb_mults)
        data["hl_scale_mul"] = splan["scale_mul"][:3].astype(np.float32)
        data["hl_wb_cam"] = wb_cam.astype(np.float32)
        data["hl_max"] = (splan["clmax"] * mults).astype(np.float32)

    rgb_cam, _, _ = frame.color_matrices()
    xyz_cam = cs.MATRICES_RGB_TO_XYZ["sRGB"] @ rgb_cam
    data["cam2work"] = (cs.MATRICES_XYZ_TO_RGB[icc_working]
                        @ xyz_cam).astype(np.float32)
    do_clip = not (pp.exposure.enabled and pp.exposure.hrmode != "Off")
    dcp_static, icc_input_trc = _plan_input_profile(
        frame, pp, data, ctx, icc_working, wb_mults)
    pp = _auto_log(frame, pp, device)
    pp = _hist_match(frame, pp, device)
    _check_autos(frame, pp)

    # coarse rotation and flips: an odd quarter turn swaps the dims
    coarse = (int(pp.coarse.rotate // 90) % 4, bool(pp.coarse.hflip),
              bool(pp.coarse.vflip))
    if coarse[0] % 2 == 1:
        h, w = w, h

    # fast export's early resize (develop.py:513-536): the scale of the
    # whole rotated image, a target in sensor orientation (it runs before
    # the coarse rotation); the crop then scales, and no final resize
    early_resize = None
    fast_scale = 1.0
    if fast:
        fast_scale = _resize_scale(pp, h, w)
        if fast_scale != 1.0:
            oh = int(h * fast_scale + 0.5)
            ow = int(w * fast_scale + 0.5)
            th, tw = (ow, oh) if coarse[0] % 2 == 1 else (oh, ow)
            sh0, sw0 = (w, h) if coarse[0] % 2 == 1 else (h, w)
            data["early_rows"], data["early_cols"] = resize_plan(
                (sh0, sw0), (th, tw))
            early_resize = (sh0, sw0, th, tw)
            h, w = oh, ow

    # the geometric transform, at output scale in fast export
    # (develop.py:538-556)
    do_transform = needs_transform(pp, frame)
    if do_transform:
        data["transform"] = plan_transform(pp, (h, w), frame=frame)

    # crop, in rotated coordinates (develop.py:558-570)
    crop = None
    if pp.crop.enabled:
        sf = fast_scale if early_resize is not None else 1.0
        cx = max(0, int(pp.crop.x * sf + 0.5))
        cy = max(0, int(pp.crop.y * sf + 0.5))
        cw0 = int(pp.crop.w * sf + 0.5) if pp.crop.w > 0 else w
        ch0 = int(pp.crop.h * sf + 0.5) if pp.crop.h > 0 else h
        cw = min(cw0, w - cx)
        ch = min(ch0, h - cy)
        if (cx, cy, cw, ch) != (0, 0, w, h):
            crop = (cy, cx, ch, cw)

    # the final resize (develop.py:572-587)
    resize_to = None
    if pp.resize.enabled and early_resize is None:
        scale_f = _resize_scale(pp, h, w, crop)
        src_h = crop[2] if crop else h
        src_w = crop[3] if crop else w
        if scale_f != 1.0:
            oh = max(32, int(src_h * scale_f + 0.5))
            ow = max(32, int(src_w * scale_f + 0.5))
            if (oh, ow) != (src_h, src_w):
                resize_to = (oh, ow)
                data["resize_rows"], data["resize_cols"] = resize_plan(
                    (src_h, src_w), resize_to)

    # with no geometry change, stages 1-3 run on the padded planes and
    # the slice to true dims comes last (crop_result)
    late_crop = (coarse == (0, False, False) and not do_transform
                 and crop is None and early_resize is None)

    ctx["op_dims"] = (h, w)
    steps = []
    for name in ops_pkg.ALL_STEPS:
        planned = ops_pkg.plan_step(name, pp, ctx)
        if planned is None:
            continue
        static, op_data = planned
        steps.append((name, tuple(static), ops_pkg.stage_of(name)))
        data[f"op:{name}"] = op_data
    fit_op_planes(data, steps, (h, w), shape, late_crop, crop)

    # post-resize sharpening (develop.py:664-672)
    prsharp = None
    if resize_to is not None and pp.pr_sharpening.enabled:
        from art_tpu_torch.ops import sharpen

        planned = sharpen.plan_pr(pp, ctx)
        if planned is not None:
            prsharp, data["op:prsharpen"] = planned

    out_mat, out_trc = _plan_output_profile(pp, data)
    data["work2out"] = (np.linalg.inv(out_mat)
                        @ cs.MATRICES_RGB_TO_XYZ[icc_working]).astype(
                            np.float32)

    config = PipelineConfig(
        pattern=frame.pattern,
        xtrans=frame.xtrans,
        is_raw=True,
        demosaic_method=method,
        do_clip=do_clip,
        working_profile=icc_working,
        out_trc=out_trc,
        shape=tuple(shape),
        orig_shape=(h, w),
        steps=tuple(steps),
        late_crop=late_crop,
        crop=crop,
        resize_to=resize_to,
        early_resize=early_resize,
        prsharp=prsharp,
        coarse=coarse,
        transform=do_transform,
        linedn=linedn,
        ca_mode=ca_mode,
        hotdead=hotdead,
        badpix_file="badpix_mask" in data,
        green_eq=green_eq,
        hl_mode=hl_mode,
        pdaf=pdaf,
        dem_kwargs=tuple(dem_kwargs),
        dcp=dcp_static,
        icc_input_trc=icc_input_trc,
        pixelshift=pixelshift,
        darkframe=darkframe,
        flatfield=flatfield,
        gainmap=gainmap,
        out_u8=bool(out_u8),
    )
    return config, data


def _plan_output_profile(pp, data):
    """(output matrix, output TRC) of the output profile
    (develop.py:675-705): a named colorspace's, or a user ICC file's
    matrix and TRC, or, for a LUT-class one, XYZ (D50) and its B2A0
    stages; any failure of the file falls back to sRGB, as in the
    reference."""
    out_prof = _resolve_output_profile(pp.icm.output_profile)
    if not out_prof.lower().endswith((".icc", ".icm")):
        return cs.MATRICES_RGB_TO_XYZ[out_prof], output_trc(out_prof)
    try:
        from art_tpu_torch.color.iccfile import load_icc

        prof = load_icc(out_prof)
        if prof.get("kind") != "lut":
            return prof["rgb_to_xyz"], prof["trc"]
        if prof["b2a"] is None:
            raise ValueError("LUT output profile has no B2A0")
        from art_tpu_torch.color.icclut import plan_lut

        stages, ldata = plan_lut(prof["b2a"], prof["pcs"], "out")
        for k, v in ldata.items():
            data[f"iccout:{k}"] = v
        return np.eye(3), ("icclut", stages)
    except Exception:
        return cs.MATRICES_RGB_TO_XYZ["sRGB"], output_trc("sRGB")


def fusion_gates(config: PipelineConfig):
    """(fuse_head, fuse_tail): the reference's pass-fusion gates
    (develop.py::_build_run)."""
    first0 = next((s for s in config.steps if s[2] == 0), None)
    fuse_head = (
        config.is_raw and first0 is not None and first0[0] == "denoise"
        and len(first0[1]) >= 5
        and first0[1][1] == 0 and first0[1][2] == 0 and not first0[1][4]
        and config.hl_mode != "blend" and config.do_clip
        and config.early_resize is None and config.dcp is None
        and config.icc_input_trc is None and not config.pixelshift)
    late_steps = [s for s in config.steps if s[2] > 0]
    fuse_tail = (
        config.resize_to is None and bool(late_steps)
        and late_steps[-1][0] == "tonecurve"
        and bool(late_steps[-1][1]) and late_steps[-1][1][0] == "neutral"
        and config.out_trc[0] in ("srgb", "linear"))
    return fuse_head, fuse_tail


def _check_config(config):
    """Refuse configs outside the slice (either planner's)."""
    if not config.is_raw:
        _refuse_non_raw()
    if (config.pattern is None and config.xtrans is None
            and config.demosaic_method != "foveon"):
        _unported("monochrome raw with no CFA")
    if config.hl_mode not in ("Off", "blend", "opposed", "inpaint"):
        _unported(f"highlight recovery {config.hl_mode!r}")
    for name, static, _ in config.steps:
        check = getattr(ops_pkg.get_op(name), "check_static", None)
        if check is not None:
            check(static)
    cs.check_trc(config.out_trc)


def raw_gains(rgb, data, hl_mode="Off", do_clip=True):
    """The raw head's multipliers (develop.py:990-998): WB multipliers,
    then the Blend highlight recovery, then the clip to [0, MAXVAL]
    unless highlight recovery turned it off."""
    rgb = rgb * data["rgb_mults"][:, None, None]
    if hl_mode == "blend":
        from art_tpu_torch.raw.hilite import recover_blend

        with span("hilite"):
            rgb = recover_blend(rgb, data["hl_max"])
    if do_clip:
        rgb = torch.clamp(rgb, 0.0, MAXVAL)
    return rgb


def raw_head(rgb, data):
    """The raw head on its own with the clip (develop.py:990-1032):
    `raw_gains`, then camera to working space."""
    return mat3(data["cam2work"], raw_gains(rgb, data))


def recover_highlights(rgb, data, hl_mode):
    """The highlight recovery that runs right after the demosaic, before
    the multipliers (develop.py:980-989): ColorSoft and Color."""
    if hl_mode == "opposed":
        from art_tpu_torch.raw.hilite import recover_opposed

        return recover_opposed(rgb, data["hl_scale_mul"], data["hl_wb_cam"])
    if hl_mode == "inpaint":
        from art_tpu_torch.raw.hilite_inpaint import recover_inpaint

        return recover_inpaint(rgb, data["hl_scale_mul"], data["hl_wb_cam"])
    return rgb


def raw_calibration(inp, config: PipelineConfig, data):
    """The raw calibration on ADUs before the scale (develop.py:858-886),
    each in its own span: dark frame, gain map, flat field."""
    from art_tpu_torch.raw import dfff

    if config.darkframe:
        with span("darkframe"):
            inp = dfff.subtract_dark(inp, data["df_plane"])
    if config.gainmap:
        with span("gainmap"):
            inp = dfff.apply_gain_plane(inp, data["raw_offset"],
                                        data["gain_plane"])
    if config.flatfield is not None:
        bt, rad = config.flatfield
        with span("flatfield"):
            if config.pattern is not None:
                inp = dfff.apply_flatfield_bayer(inp, data["ff_plane"], bt,
                                                 rad)
            else:
                from art_tpu_torch.core.image import \
                    xtrans_color_index_device

                cidx = xtrans_color_index_device(config.xtrans, inp.shape,
                                                 inp.device)
                inp = dfff.apply_flatfield_xtrans(inp, data["ff_plane"],
                                                  cidx, bt, rad)
    return inp


def _plane_coords(cfa):
    """(row index as an (H, 1) column, column index as a (1, W) row) in
    cfa's dtype, on its device."""
    hh, ww = cfa.shape
    return (torch.arange(hh, dtype=cfa.dtype, device=cfa.device)[:, None],
            torch.arange(ww, dtype=cfa.dtype, device=cfa.device)[None, :])


def raw_vignette(cfa, data):
    """The lens vignette gains on the scaled mosaic (develop.py:889-922):
    the LCP gain series on the normalised radius, the metadata or lensfun
    spline (the raw divided by its square; its centre and radius
    normaliser from the padded plane's shape, as in the reference), the
    DNG FixVignetteRadial polynomial."""
    if "lcp_vign" in data:
        v = data["lcp_vign"]
        ys, xs = _plane_coords(cfa)
        rs = ((xs - v[0]) * v[2]) ** 2 + ((ys - v[1]) * v[3]) ** 2
        factor = rs * (v[4] + rs * (v[5] - v[6] * rs + v[7] * rs * rs))
        cfa = cfa * (1.0 + factor)
    if "exif_vign" in data:
        v = data["exif_vign"]
        hh2, ww2 = cfa.shape
        w2e, h2e = ww2 * 0.5, hh2 * 0.5
        # float32, as the reference's jnp.sqrt of a Python float
        rn = float(np.float32(1.0) / np.sqrt(np.float32(w2e * w2e
                                                        + h2e * h2e)))
        ys, xs = _plane_coords(cfa)
        sf = interp(rn * fsqrt((ys - h2e) ** 2 + (xs - w2e) ** 2),
                    v[0], v[1])
        cfa = cfa / (sf * sf)
    if "exif_vign_dng" in data:
        v = data["exif_vign_dng"]
        ys, xs = _plane_coords(cfa)
        r2 = v[2] * ((ys - v[1]) ** 2 + (xs - v[0]) ** 2)
        gain = 1.0 + r2 * (v[3] + r2 * (v[4] + r2 * (
            v[5] + r2 * (v[6] + r2 * v[7]))))
        cfa = cfa * gain
    return cfa


def raw_steps(cfa, config: PipelineConfig, data):
    """The raw steps between the scale and the demosaic, in the
    reference's order (develop.py:923-961), each in its own span: the
    .badpixels file's sites, hot/dead pixels, green equilibration, CFA
    line denoise, the PDAF line filter, raw CA correction; on a Bayer
    mosaic."""
    if config.pattern is None:
        return cfa
    if (config.badpix_file or config.hotdead is not None
            or config.green_eq > 0 or config.pdaf):
        _, mg, _ = bayer_channel_masks(config.pattern, cfa.shape, cfa.device)
    if config.badpix_file:
        from art_tpu_torch.raw.badpixels import interpolate_bad_bayer

        with span("badpix"):
            cfa = interpolate_bad_bayer(cfa, data["badpix_mask"] > 0.5, mg)
    if config.hotdead is not None:
        from art_tpu_torch.raw.badpixels import (find_hot_dead,
                                                 interpolate_bad_bayer)

        with span("hotdead"):
            find_hot, find_dead, thr = config.hotdead
            bad = find_hot_dead(cfa, thr, find_hot, find_dead)
            cfa = interpolate_bad_bayer(cfa, bad, mg)
    if config.green_eq > 0:
        from art_tpu_torch.raw.green_eq import green_equilibrate

        with span("green_eq"):
            cfa = green_equilibrate(cfa, mg, config.green_eq)
    if config.linedn[0] > 0:
        from art_tpu_torch.raw.cfa_linedn import cfa_line_denoise

        with span("linedn"):
            cfa = cfa_line_denoise(cfa, config.linedn[0], config.linedn[1])
    if config.pdaf:
        from art_tpu_torch.raw.pdaf import pdaf_filter

        with span("pdaf"):
            cfa = pdaf_filter(cfa, mg, data["pdaf_rows"])
    if config.ca_mode is not None:
        from art_tpu_torch.raw.ca_correct import ca_correct

        with span("ca_correct"):
            mode, car, cab = config.ca_mode
            cfa = ca_correct(cfa, config.pattern, auto=(mode == "auto"),
                             ca_red=car, ca_blue=cab)
    return cfa


def coarse_transform(rgb, coarse):
    """Quarter turns counter-clockwise, then the horizontal and vertical
    flips (develop.py:1048-1057)."""
    k, hflip, vflip = coarse
    if k:
        rgb = torch.rot90(rgb, k, dims=(1, 2))
    if hflip:
        rgb = torch.flip(rgb, dims=(2,))
    if vflip:
        rgb = torch.flip(rgb, dims=(1,))
    return rgb


def foveon_scale(inp, data):
    """A Foveon frame's (3, H, W) planes through the per-channel
    scaleColors (develop.py:848-851): no mosaic, no demosaic."""
    with span("scale"):
        return torch.clamp((inp - data["raw_offset"]) * data["raw_scale"],
                           min=0.0)


def raw_stage(inp, config: PipelineConfig, data):
    """A CFA frame from raw counts to RGB (develop.py:858-979): the
    calibration, the scale, the vignette, the raw steps, then the
    demosaic, or pixel shift's combine of the 4 scaled frames."""
    from art_tpu_torch.demosaic import demosaic

    inp = raw_calibration(inp, config, data)
    with span("scale"):
        cfa = rawpre.apply_scale(inp, data["raw_offset"], data["raw_scale"])
    del inp
    if any(k in data for k in ("lcp_vign", "exif_vign", "exif_vign_dng")):
        with span("vignette"):
            cfa = raw_vignette(cfa, data)
    cfa = raw_steps(cfa, config, data)
    if config.pixelshift:
        from art_tpu_torch.demosaic.pixelshift import pixelshift_combine

        with span("scale"):
            frames = torch.stack([cfa] + [
                rawpre.apply_scale(data["ps_frames"][k], data["raw_offset"],
                                   data["raw_scale"]) for k in range(3)])
        del cfa
        with span("pixelshift"):
            return pixelshift_combine(frames, config.pattern,
                                      **dict(config.dem_kwargs))
    with span("demosaic"):
        return demosaic(cfa, config.pattern, config.demosaic_method,
                        init_gain=data["init_gain"], xtrans=config.xtrans,
                        dem_kwargs=config.dem_kwargs)


def build_run(config: PipelineConfig):
    """The device program for a config: run(inp, data) -> encoded
    (3, H, W) float32 on inp's device, or (H, W, 3) uint8 for an out_u8
    config; padded on the late-crop path (crop with `crop_result`)."""
    _check_config(config)
    fuse_head, fuse_tail = fusion_gates(config)
    first0 = next((s for s in config.steps if s[2] == 0), None)
    late_steps = [s for s in config.steps if s[2] > 0]

    def run(inp, data):
        if inp.dtype != torch.float32:
            inp = inp.to(torch.float32)
        if config.demosaic_method == "foveon":
            rgb = foveon_scale(inp, data)
        else:
            rgb = raw_stage(inp, config, data)
        del inp
        if config.hl_mode in ("opposed", "inpaint"):
            with span("hilite"):
                rgb = recover_highlights(rgb, data, config.hl_mode)
        if not fuse_head:
            with span("raw_head"):
                rgb = raw_gains(rgb, data, config.hl_mode, config.do_clip)
        if config.early_resize is not None:
            # fast export: to output scale right after the raw stage
            sh0, sw0, _, _ = config.early_resize
            with span("early_resize"):
                rgb = apply_resize(rgb[:, :sh0, :sw0], data["early_rows"],
                                   data["early_cols"])
        if config.dcp is not None:
            from art_tpu_torch.color.dcp import apply_dcp

            with span("dcp"):
                rgb = apply_dcp(rgb, data, config.dcp)
        elif not fuse_head:
            if config.icc_input_trc is not None:
                with span("iccin"):
                    rgb = icc_input(rgb, config.icc_input_trc, data)
            with span("raw_head"):
                rgb = mat3(data["cam2work"], rgb)
        for step in config.steps:
            name, static, stage = step
            if stage != 0:
                continue
            d = data[f"op:{name}"]
            if fuse_head and step == first0:
                d = dict(d, pre_mults=data["rgb_mults"],
                         pre_mat=data["cam2work"])
            with span(name):
                rgb = ops_pkg.get_op(name).apply(rgb, d, static)
        h0, w0 = config.orig_shape
        if not config.late_crop:
            # the sensor's true dims (orig_shape is after the rotation),
            # then the rotation, flips and crop (develop.py:1044-1068)
            k = config.coarse[0]
            sh, sw = (w0, h0) if k % 2 == 1 else (h0, w0)
            rgb = rgb[:, :sh, :sw]
            if config.coarse != (0, False, False):
                with span("coarse"):
                    rgb = coarse_transform(rgb, config.coarse)
            if config.transform:
                with span("transform"):
                    rgb = apply_transform(rgb, data["transform"])
            if config.crop is not None:
                cy, cx, ch, cw = config.crop
                with span("crop"):
                    rgb = rgb[:, cy : cy + ch, cx : cx + cw].contiguous()
        for step in late_steps:
            name, static, _ = step
            d = data[f"op:{name}"]
            if fuse_tail and step == late_steps[-1]:
                d = dict(d, out_mat=data["work2out"])
                static = static + (("epi", config.out_trc),)
            with span(name):
                rgb = ops_pkg.get_op(name).apply(rgb, d, static)
        if config.resize_to is not None:
            if config.late_crop:
                rgb = rgb[:, :h0, :w0]
            with span("resize"):
                rgb = apply_resize(rgb, data["resize_rows"],
                                   data["resize_cols"])
            if config.prsharp is not None:
                from art_tpu_torch.ops import sharpen

                with span("prsharpen"):
                    rgb = sharpen.apply(rgb, data["op:prsharpen"],
                                        config.prsharp)
        if not fuse_tail:  # rgb2out: working -> output primaries, TRC
            with span("rgb2out"):
                rgb = torch.clamp(fdiv(mat3(data["work2out"], rgb), MAXVAL),
                                  0.0, 1.0)
                if config.out_trc[0] != "icclut":
                    rgb = cs.encode_trc(rgb, config.out_trc)
            if config.out_trc[0] == "icclut":
                # a LUT-class output profile: rgb is PCS XYZ (D50) here
                from art_tpu_torch.color.icclut import apply_stages

                with span("iccout"):
                    rgb = torch.clamp(torch.stack(apply_stages(
                        rgb[0], rgb[1], rgb[2], config.out_trc[1], data,
                        "iccout:")), 0.0, 1.0)
        if config.out_u8:
            # interleaved 8-bit for the encoder, converted before the
            # readback (develop.py:1109-1114): a quarter of the f32
            # planes' bytes, and no byte transpose on the host; the
            # values lie in [0.5, 255.5], where the cast truncates
            with span("out_u8"):
                rgb = (torch.clamp(rgb, 0.0, 1.0) * 255.0 + 0.5).to(
                    torch.uint8).permute(1, 2, 0).contiguous()
        return rgb

    return run


def icc_input(rgb, trc, data):
    """An ICC camera profile before its matrix (develop.py:1015-1033):
    device RGB (0..65535) to PCS XYZ through a LUT-class profile's A2B
    stages, or linearised by a matrix profile's shaper TRC."""
    x01 = rgb * (1.0 / MAXVAL)
    if trc[0] == "icclut":
        from art_tpu_torch.color.icclut import apply_stages

        return torch.stack(apply_stages(x01[0], x01[1], x01[2], trc[1],
                                        data, "iccin:")) * MAXVAL
    return cs.decode_trc(x01, trc) * MAXVAL


def crop_result(out, config: PipelineConfig):
    """Slice a late-crop output to the true (H, W) (develop.py::
    crop_result)."""
    if not (config.late_crop and config.resize_to is None):
        return out
    h0, w0 = config.orig_shape
    if config.out_u8:
        return out[..., :h0, :w0, :]
    return out[..., :h0, :w0]


def data_to_torch(data, device):
    """A planner's data (numpy arrays and scalars in nested dicts and
    lists, from this package's plan or the reference's) as float32/int
    tensors on `device`; float64 becomes float32 as under JAX's default
    x32."""
    if isinstance(data, dict):
        return {k: data_to_torch(v, device) for k, v in data.items()}
    if isinstance(data, (list, tuple)):  # the spot entries' windows
        return [data_to_torch(v, device) for v in data]
    a = np.asarray(data)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    if not a.flags.c_contiguous:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def transfer_array(inp):
    """Narrow an integral float raw plane to uint16 for the host-to-device
    copy (develop.py::transfer_array); the program widens it back."""
    if inp.dtype == np.float32:
        return inp.astype(np.uint16)
    return inp


class PinnedBuffer:
    """A reusable page-locked host buffer, grown to the largest request:
    the source of an asynchronous host-to-device copy and the target of an
    asynchronous readback. Pinning 48-72 MB anew for each 24 MP image
    would cost more than the copy."""

    def __init__(self):
        self._bytes = None

    def view(self, dtype, shape):
        """The buffer's first bytes as a contiguous tensor of this dtype
        and shape."""
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        if self._bytes is None or self._bytes.numel() < n:
            self._bytes = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        return self._bytes[:n].view(dtype).view(shape)


def host_input(frame):
    """The frame's mosaic padded to the planned shape, as the host array
    that goes to the device: decoded u16 counts as an int16 view (half
    the bytes of f32; torch's uint16 has few kernels, so the program's
    input widens it back, `device_input`), else float32."""
    inp, _ = pad_to_multiple(frame.cfa, PAD_MULTIPLE)
    if frame.integral:  # decoded u16 counts
        inp = transfer_array(inp)
    inp = np.ascontiguousarray(inp)
    if inp.dtype == np.uint16:
        inp = inp.view(np.int16)
    return inp


def device_input(host, device, pinned=None):
    """`host_input`'s array on `device`. With `pinned` (a PinnedBuffer)
    the array is staged there and copied with non_blocking=True on the
    current stream: the caller may refill the buffer only after that
    copy (an event recorded after this call). u16 counts widen from their
    int16 view on the device, bit for bit."""
    src = torch.from_numpy(host)
    if pinned is not None:
        stage = pinned.view(src.dtype, src.shape)
        stage.copy_(src)
        dev = stage.to(device, non_blocking=True)
    else:
        dev = src.to(device)
    if dev.dtype == torch.int16:
        return dev.to(torch.int32) & 0xFFFF
    return dev


def upload(frame, device):
    """The frame's mosaic padded to the planned shape, on `device`
    (`host_input` -> `device_input`)."""
    return device_input(host_input(frame), device)


def read_back(out, pinned=None):
    """A device output (cropped by `crop_result`) on the host: into
    `pinned` (a PinnedBuffer) with non_blocking=True on the current
    stream, which the caller synchronises before reading it, or as a
    host tensor at once."""
    if pinned is None:
        return out.cpu()
    host = pinned.view(out.dtype, tuple(out.shape))
    host.copy_(out, non_blocking=True)
    return host


def develop(frame, pp, device="cuda", fast=False, out_u8=False):
    """Full develop of a raw frame on `device` (the card unless the caller
    asks for the CPU): encoded (3, H, W) float32 in [0, 1], or (H, W, 3)
    uint8 with out_u8, as a tensor on that device. fast: the fast export
    (-q), as `plan` takes it."""
    config, data = plan(frame, pp, fast=fast, out_u8=out_u8, device=device)
    out = build_run(config)(upload(frame, device), data_to_torch(data, device))
    return crop_result(out, config)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def process_image(path_or_frame, pp, fast=False, output_path=None,
                  bits=8, quality=92, uncompressed=False,
                  gamut_warn=None, subsampling=3, listener=None,
                  device="cuda"):
    """processImage equivalent (``art_tpu/pipeline/develop.py::
    process_image``; rtengine.h:604, simpleprocess.cc:580): decode a raw
    file (or take a RawFrame), develop it on `device` (the card unless
    the caller asks for the CPU), save it to `output_path` with its
    metadata and ICC profile, and return the developed image as a numpy
    array: (H, W, 3) uint8 when the output is an 8-bit JPEG (converted on
    the device, as in the reference), else (3, H, W) float32.

    listener: optional pipeline.listeners.ProgressListener — phase
    milestones + errors. With settings.verbose, the wall-clock time of
    each phase prints to stdout: decode, plan, H2D, device program, D2H,
    encode and metadata/write (the reference's `-V` instrumentation
    times decode, develop and encode+metadata).

    fast: the fast export (ART-cli's -q), as `plan` takes it.

    gamut_warn: a proof profile (a named colorspace or a matrix .icc
    path); the pixels outside its gamut are painted cyan
    (`color/gamutwarning.py`), on the develop's device.

    A PipelineListener that overrides `histogram_changed` gets the
    256-bin R, G, B and luminance histograms of the developed image
    (`pipeline/scopes.py::histogram_rgbl`, on the host) after the autos
    are reported."""
    import time as _time

    from art_tpu_torch.io.rawfile import RawFrame
    from art_tpu_torch.pipeline.listeners import (PipelineListener,
                                                  _Collect, fire_autos,
                                                  notify, wants_histogram)
    from art_tpu_torch.settings import settings

    def _tick(label, t0):
        if settings.verbose:
            print(f"[art-tpu] {label}: "
                  f"{(_time.monotonic() - t0) * 1000:.1f} ms", flush=True)
        return _time.monotonic()

    t = _time.monotonic()
    try:
        if isinstance(path_or_frame, RawFrame):
            frame = path_or_frame
        else:
            from art_tpu_torch.io import load_image

            frame = load_image(path_or_frame)
    except Exception as e:
        if listener is not None:
            listener.error(f"load failed: {e}")
        raise
    notify(listener, "decode")
    t = _tick("decode", t)
    if isinstance(listener, PipelineListener) and frame.is_raw:
        listener.image_type_changed(
            True, frame.pattern is not None, frame.xtrans is not None,
            frame.pattern is None and frame.xtrans is None
            and getattr(frame.cfa, "ndim", 2) == 2)
    # 8-bit JPEG output with no host-side post step: convert on device
    u8 = (bits == 8 and gamut_warn is None and output_path is not None
          and str(output_path).lower().endswith((".jpg", ".jpeg")))
    with _Collect() as auto_report:
        config, data = plan(frame, pp, fast=fast, out_u8=u8, device=device)
    t = _tick("plan", t)
    inp = upload(frame, device)
    data_d = data_to_torch(data, device)
    _sync(device)
    t = _tick("H2D", t)
    out = build_run(config)(inp, data_d)
    del inp, data_d
    _sync(device)
    t = _tick("device program", t)
    out = crop_result(out, config)
    scoped = None
    if gamut_warn and wants_histogram(listener):
        # the reference's histogram reads the develop before the paint
        scoped = np.array(read_back(out).numpy())
    if gamut_warn:
        from art_tpu_torch.color.gamutwarning import paint_gamut_warning

        out, _ = paint_gamut_warning(
            out, _resolve_output_profile(pp.icm.output_profile), gamut_warn)
        _sync(device)
        t = _tick("gamut warning", t)
    out = read_back(out).numpy()
    t = _tick("D2H", t)
    fire_autos(listener, auto_report)
    if wants_histogram(listener):
        from art_tpu_torch.pipeline.scopes import histogram_rgbl

        arr = out if scoped is None else scoped
        full = (arr.transpose(2, 0, 1).astype(np.float32)
                * (MAXVAL / 255.0) if u8
                else np.clip(arr, 0.0, 1.0) * MAXVAL)
        listener.histogram_changed(histogram_rgbl(full))
    notify(listener, "develop")
    if gamut_warn:
        notify(listener, "gamut")
    if output_path is not None:
        from art_tpu_torch.io.imagefile import save_image

        # metadata tunnel/edit (MetaDataParams.mode: 0=tunnel 1=edit
        # 2=strip; rtengine/metadata.cc semantics)
        exif_bytes = None
        exif_tags = None
        xmp_bytes = None
        iptc_iim = None
        if pp.metadata.mode != 2 and frame.filename:
            try:
                from art_tpu_torch.io.metadata import (build_exif_bytes,
                                                       harvest)
                from art_tpu_torch.io.xmp import (build_iptc_iim,
                                                  read_xmp_sidecar,
                                                  serialize_xmp,
                                                  xmp_exif_overrides)

                tags, _ = harvest(frame.filename)
                # sidecar XMP wins over in-file values (do_merge_xmp,
                # metadata.cc:463); rating and a few dc fields promote
                # into EXIF like exiv2's moveXmpToExif
                xmp_props = read_xmp_sidecar(frame.filename,
                                             settings.xmp_sidecar_style)
                if xmp_props:
                    tags.update(xmp_exif_overrides(xmp_props))
                if pp.metadata.mode == 1:
                    if pp.metadata.exif_keys:
                        keep = set(pp.metadata.exif_keys.split(";"))
                        tags = {k: v for k, v in tags.items() if k in keep}
                    # ProcParams Exif change list (procparams.cc:4262)
                    _EXIF_FIELD = {
                        "Exif.Image.Copyright": "copyright",
                        "Exif.Image.Artist": "artist",
                        "Exif.Image.ImageDescription": "image_description",
                        "Exif.Image.Make": "make",
                        "Exif.Image.Model": "model",
                        "Exif.Photo.LensModel": "lens_model",
                        "Exif.Photo.DateTimeOriginal": "datetime_original",
                    }
                    for exiv_key, val in pp.metadata.exif.items():
                        fkey = _EXIF_FIELD.get(exiv_key)
                        if fkey:
                            tags[fkey] = val
                    if pp.metadata.iptc:
                        iptc_iim = build_iptc_iim(pp.metadata.iptc)
                if xmp_props:
                    if pp.metadata.notes:
                        xmp_props["Xmp.ART.notes"] = pp.metadata.notes
                    xmp_bytes = serialize_xmp(xmp_props)
                elif pp.metadata.notes:
                    xmp_bytes = serialize_xmp(
                        {"Xmp.ART.notes": pp.metadata.notes})
                if tags:
                    exif_bytes = build_exif_bytes(tags)
                    exif_tags = tags
            except Exception:
                # the reference's behaviour: a failed harvest leaves the
                # output without metadata
                pass
        icc = None
        try:
            op = _resolve_output_profile(pp.icm.output_profile)
            if op.lower().endswith((".icc", ".icm")):
                # a user profile file embeds its own bytes
                with open(op, "rb") as f:
                    icc = f.read()
            else:
                from art_tpu_torch.color.iccwrite import make_icc

                icc = make_icc(op)
        except Exception:
            icc = None
        t = _tick("metadata", t)
        save_image(output_path, out, bits=bits, quality=quality,
                   exif_bytes=exif_bytes, exif_tags=exif_tags,
                   icc_bytes=icc, uncompressed=uncompressed,
                   xmp_bytes=xmp_bytes, iptc_iim=iptc_iim,
                   subsampling=subsampling)
        t = _tick("encode+write", t)
        if pp.metadata.mode == 0 and frame.filename:
            # tunnel mode: deep makernote copy via exiftool when the
            # binary exists (metadata.h:113 fallback; no-op otherwise)
            from art_tpu_torch.io.exiftool import copy_tags

            copy_tags(frame.filename, output_path)
            _tick("exiftool", t)
    notify(listener, "save")
    return out
