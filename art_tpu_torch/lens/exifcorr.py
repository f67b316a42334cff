"""Lens corrections embedded in camera metadata (a copy of the host side
of ``art_tpu/lens/exifcorr.py``; lensexif.cc ExifLensCorrection).

The planner asks `for_frame` for a frame's correction (LcMode=exif) and
hands its coefficients to the raw vignette and the geometry transform
(`pipeline/transform.py::_exif_map`). Sources, each reduced to a spline
or a DNG model as in the reference: Sony makernote tags 0x2011-0x2013, Fuji RAF
records 0x9501-0x9503, Olympus 0x150a/0x150c (from a ``makernotes``
dict a decoder attaches), DNG OpcodeList3 (WarpRectilinear,
FixVignetteRadial) and a Sony makernote walk of the file.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

SONY_TAG_VIGN = 0x2011
SONY_TAG_CA = 0x2012
SONY_TAG_DIST = 0x2013
FUJI_TAG_GEOMETRIC = 0x9501
FUJI_TAG_CA = 0x9502
FUJI_TAG_VIGNETTING = 0x9503


@dataclasses.dataclass
class ExifCorr:
    """Correction model ready for device evaluation."""

    kind: str  # "spline" | "dng"
    # spline model (normalized radius knots)
    knots: np.ndarray | None = None  # (n,)
    dist: np.ndarray | None = None  # (n,) radius scale
    vig: np.ndarray | None = None  # (n,) gain (raw is divided by vig^2)
    ca: np.ndarray | None = None  # (3, n) per-channel radius scale
    # dng model
    warp: np.ndarray | None = None  # (6,) WarpRectilinear kr0..kr3,kt0,kt1
    vign_radial: np.ndarray | None = None  # (5,) FixVignetteRadial k0..k4
    center_d: tuple | None = None  # (cx, cy) fractions for warp
    center_v: tuple | None = None  # (cx, cy) fractions for vignette

    @property
    def has_dist(self):
        if self.kind == "dng":
            return self.warp is not None
        return self.dist is not None

    @property
    def has_ca(self):
        return self.kind == "spline" and self.ca is not None

    @property
    def has_vign(self):
        if self.kind == "dng":
            return self.vign_radial is not None
        return self.vig is not None


# ---------------------------------------------------------------------------
# coefficient conversion (lensexif.cc get_coeffs implementations)

def from_sony(dist_vals, ca_vals, vig_vals):
    """SonyCorrectionData (lensexif.cc:55): int16 arrays led by a knot
    count; fixed-point scales 2^-14 (dist), 2^-21 (CA), 2^-13 (vig)."""
    d = np.asarray(dist_vals, np.float32)
    c = np.asarray(ca_vals, np.float32)
    v = np.asarray(vig_vals, np.float32)
    if d.size < 2 or c.size < 2 or v.size < 2:
        return None
    nc = int(d[0])
    if not (0 < nc <= 16 and c[0] == 2 * nc and v[0] == nc
            and d.size >= nc + 1 and c.size >= 2 * nc + 1
            and v.size >= nc + 1):
        return None
    knots = np.arange(nc, dtype=np.float32) / (nc - 1)
    dist = d[1 : nc + 1] * 2.0 ** -14 + 1.0
    ca = np.ones((3, nc), np.float32)
    ca[0] = c[1 : nc + 1] * 2.0 ** -21 + 1.0
    ca[2] = c[nc + 1 : 2 * nc + 1] * 2.0 ** -21 + 1.0
    vig_scaling = 0.7
    vig = 2.0 ** (0.5 - 2.0 ** (vig_scaling * v[1 : nc + 1]
                                * 2.0 ** -13 - 1.0))
    return ExifCorr("spline", knots=knots, dist=dist.astype(np.float32),
                    vig=vig.astype(np.float32), ca=ca)


def from_fuji(geo_vals, ca_vals, vig_vals, crop_mode=0):
    """FujiCorrectionData (lensexif.cc:96): 9-knot tables, all three
    sharing the same knot positions; 1.25x crop modes rescale knots."""
    g = np.asarray(geo_vals, np.float32)
    c = np.asarray(ca_vals, np.float32)
    v = np.asarray(vig_vals, np.float32)
    if g.size != 19 or c.size != 29 or v.size != 19:
        return None
    kg, kc, kv = g[1:10], c[1:10], v[1:10]
    if not (np.all(kg == kc) and np.all(kg == kv)):
        return None
    cropf = 1.25 if int(crop_mode) in (2, 4) else 1.0
    knots = (cropf * kg).astype(np.float32)
    dist = (g[10:19] / 100.0 + 1.0).astype(np.float32)
    ca = np.ones((3, 9), np.float32)
    ca[0] = c[10:19] + 1.0
    ca[2] = c[19:28] + 1.0
    vig = (v[10:19] / 100.0).astype(np.float32)  # 1 - (1 - v/100)
    return ExifCorr("spline", knots=knots, dist=dist, vig=vig, ca=ca)


def from_olympus(dist_vals, ca_vals=None):
    """OlympusCorrectionData (lensexif.cc:255): polynomial coefficients
    sampled to a 16-knot spline."""
    d = np.asarray(dist_vals, np.float32)
    if d.size != 4:
        return None
    dk2, dk4, dk6, drs = d
    if not (dk2 or dk4 or dk6):
        return None
    nc = 16
    r = np.arange(nc, dtype=np.float32) / (nc - 1)
    rs2 = (r * drs) ** 2
    dist = drs * (1.0 + rs2 * (dk2 + rs2 * (dk4 + rs2 * dk6)))
    ca = None
    if ca_vals is not None:
        cv = np.asarray(ca_vals, np.float32)
        if cv.size == 6 and cv.any():
            car0, car2, car4, cab0, cab2, cab4 = cv
            r2 = r * r
            ca = np.ones((3, nc), np.float32)
            # rd == r so the rd/r factor cancels (lensexif.cc:306)
            ca[0] += car0 + r2 * (car2 + r2 * car4)
            ca[2] += cab0 + r2 * (cab2 + r2 * cab4)
    return ExifCorr("spline", knots=r.astype(np.float32),
                    dist=dist.astype(np.float32), ca=ca)


def parse_dng_opcodes3(buf):
    """DNGCorrectionData::parse (lensexif.cc:159): WarpRectilinear and
    FixVignetteRadial from big-endian OpcodeList3 bytes."""
    if buf is None or len(buf) < 4:
        return None
    n = struct.unpack_from(">I", buf, 0)[0]
    idx = 4
    warp = vign = center_d = center_v = None
    for _ in range(n):
        if idx + 16 > len(buf):
            break
        opid, _ver, _flags, size = struct.unpack_from(">IIII", buf, idx)
        idx += 16
        if opid == 1:  # WarpRectilinear
            nplanes = struct.unpack_from(">I", buf, idx)[0]
            wstart = idx + 4
            cstart = wstart + 6 * 8
            if nplanes == 3:
                wstart += 6 * 8
                cstart += 6 * 8 * 2
            elif nplanes != 1:
                cstart = len(buf) + 1
            if cstart + 16 <= len(buf):
                warp = np.asarray(
                    struct.unpack_from(">6d", buf, wstart), np.float32)
                center_d = struct.unpack_from(">2d", buf, cstart)
        elif opid == 3:  # FixVignetteRadial
            if idx + 7 * 8 <= len(buf):
                vals = struct.unpack_from(">7d", buf, idx)
                vign = np.asarray(vals[:5], np.float32)
                center_v = vals[5:7]
        idx += size
        if idx > len(buf):
            break
    if warp is None and vign is None:
        return None
    return ExifCorr("dng", warp=warp, vign_radial=vign,
                    center_d=center_d, center_v=center_v)


# ---------------------------------------------------------------------------
# metadata extraction

def _read_opcodelist3(path):
    from art_tpu_torch.io.metadata import _read_ifd, _value

    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 8 or buf[:2] not in (b"II", b"MM"):
        return None
    le = buf[:2] == b"II"
    e = "<" if le else ">"
    queue = [struct.unpack_from(e + "I", buf, 4)[0]]
    seen = set()
    while queue:
        o = queue.pop()
        if o in seen or o == 0:
            continue
        seen.add(o)
        ents, nxt = _read_ifd(buf, o, le)
        if nxt:
            queue.append(nxt)
        if 51022 in ents:
            typ, cnt, doff = ents[51022]
            return buf[doff : doff + cnt]
        for tag in (330, 34665):
            if tag in ents:
                v = _value(buf, *ents[tag][:2], ents[tag][2], le)
                for sub in ([v] if isinstance(v, int) else list(v or [])):
                    queue.append(sub)
    return None


def _sony_makernote_tags(path):
    """Sony makernote (EXIF tag 37500, "SONY DSC " header + TIFF IFD
    with file-absolute offsets): values of the correction tags."""
    from art_tpu_torch.io.metadata import _read_ifd, _value

    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 8 or buf[:2] not in (b"II", b"MM"):
        return None
    le = buf[:2] == b"II"
    e = "<" if le else ">"
    queue = [struct.unpack_from(e + "I", buf, 4)[0]]
    seen = set()
    mn_off = None
    while queue and mn_off is None:
        o = queue.pop()
        if o in seen or o == 0:
            continue
        seen.add(o)
        ents, nxt = _read_ifd(buf, o, le)
        if nxt:
            queue.append(nxt)
        if 37500 in ents:
            mn_off = ents[37500][2]
            break
        for tag in (330, 34665):
            if tag in ents:
                v = _value(buf, *ents[tag][:2], ents[tag][2], le)
                for sub in ([v] if isinstance(v, int) else list(v or [])):
                    queue.append(sub)
    if mn_off is None or buf[mn_off : mn_off + 9] != b"SONY DSC ":
        return None
    ents, _ = _read_ifd(buf, mn_off + 12, le)
    out = {}
    for tag in (SONY_TAG_DIST, SONY_TAG_CA, SONY_TAG_VIGN):
        if tag in ents:
            typ, cnt, doff = ents[tag]
            if typ == 8:  # SSHORT (not handled by _value)
                out[tag] = struct.unpack_from(e + f"{cnt}h", buf, doff)
            else:
                out[tag] = _value(buf, typ, cnt, doff, le)
    return out or None


def for_frame(frame):
    """ExifCorr for a decoded RawFrame, or None (ExifLensCorrection
    ctor, lensexif.cc:330). Checks, in order: a ``makernotes`` dict the
    decoder may have attached, DNG OpcodeList3, and a Sony makernote
    walk of the source file."""
    mn = frame.exif.get("makernotes") or {}
    make = (frame.make or "").upper()
    corr = None
    if "DistortionCorrParams" in mn:
        corr = from_sony(mn.get("DistortionCorrParams"),
                         mn.get("ChromaticAberrationCorrParams", ()),
                         mn.get("VignettingCorrParams", ()))
    elif "GeometricDistortionParams" in mn:
        corr = from_fuji(mn.get("GeometricDistortionParams"),
                         mn.get("ChromaticAberrationParams", ()),
                         mn.get("VignettingParams", ()),
                         mn.get("CropMode", 0))
    elif "OlympusDistortionCorr2" in mn:
        corr = from_olympus(mn.get("OlympusDistortionCorr2"),
                            mn.get("OlympusCACorr2"))
    if corr is not None:
        return corr
    path = frame.filename
    if not path:
        return None
    try:
        if frame.exif.get("is_dng") or path.lower().endswith(".dng"):
            return parse_dng_opcodes3(_read_opcodelist3(path))
        if make == "SONY":
            tags = _sony_makernote_tags(path)
            if tags and SONY_TAG_DIST in tags:
                return from_sony(tags[SONY_TAG_DIST],
                                 tags.get(SONY_TAG_CA, ()),
                                 tags.get(SONY_TAG_VIGN, ()))
    except (OSError, struct.error):
        return None
    return None
