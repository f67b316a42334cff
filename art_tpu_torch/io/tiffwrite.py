"""Native baseline-TIFF encoder: RGB 8/16-bit uint and 32-bit float (a
copy of ``art_tpu/io/tiffwrite.py``).

Fills the reference's TIFF output contract (``imageio.h:90-96`` —
``saveTIFF(fname, bps, uncompressed)`` with 8/16/32f depths and deflate
compression; CLI ``-b`` handling ``main-cli.cc:878-887``).  PIL cannot
write 48-bit RGB TIFFs, so this is a small self-contained little-endian
TIFF6 writer with:

- SampleFormat/BitsPerSample for u8 / u16 / f32
- Adobe deflate (COMPRESSION 8) with horizontal-differencing predictor
  for the integer depths, or uncompressed
- ICC profile embedding (tag 34675)
- basic EXIF: IFD0 description tags + an Exif sub-IFD (tag 34665)
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

T_BYTE, T_ASCII, T_SHORT, T_LONG, T_RATIONAL = 1, 2, 3, 4, 5
T_UNDEF, T_SRATIONAL = 7, 10

# IFD0 EXIF description tags (tag -> (key in tags dict, type))
_IFD0_TAGS = {
    271: ("make", T_ASCII),
    272: ("model", T_ASCII),
    306: ("datetime", T_ASCII),
    315: ("artist", T_ASCII),
    33432: ("copyright", T_ASCII),
}
# Exif private IFD tags (metadata.cc tunnel subset)
_EXIF_TAGS = {
    33434: ("exposure_time", T_RATIONAL),
    33437: ("f_number", T_RATIONAL),
    34855: ("iso", T_SHORT),
    36867: ("datetime_original", T_ASCII),
    37386: ("focal_length", T_RATIONAL),
    42036: ("lens_model", T_ASCII),
}


def _pack_value(typ, values):
    if typ == T_ASCII:
        data = str(values).encode("utf-8", "replace") + b"\x00"
        return data, len(data)
    if typ in (T_RATIONAL, T_SRATIONAL):
        fmt = "<ii" if typ == T_SRATIONAL else "<II"
        out = b""
        for v in values:
            if isinstance(v, tuple):
                num, den = v
            else:
                num, den = int(round(float(v) * 1000000)), 1000000
            out += struct.pack(fmt, num, den)
        return out, len(values)
    if typ == T_SHORT:
        return b"".join(struct.pack("<H", int(v)) for v in values), len(values)
    if typ == T_LONG:
        return b"".join(struct.pack("<I", int(v)) for v in values), len(values)
    if typ in (T_BYTE, T_UNDEF):
        return bytes(values), len(values)
    raise ValueError(typ)


class _IFD:
    def __init__(self):
        self.entries = []  # (tag, typ, count, data_bytes)

    def add(self, tag, typ, values):
        data, count = _pack_value(typ, values)
        self.entries.append((tag, typ, count, data))

    def layout(self, base_off):
        """Serialize at absolute offset base_off; returns (bytes, size)."""
        self.entries.sort(key=lambda e: e[0])
        n = len(self.entries)
        ifd_size = 2 + n * 12 + 4
        extra = bytearray()
        body = struct.pack("<H", n)
        for tag, typ, count, data in self.entries:
            if len(data) <= 4:
                val = data + b"\x00" * (4 - len(data))
            else:
                val = struct.pack("<I", base_off + ifd_size + len(extra))
                extra.extend(data)
                if len(extra) % 2:
                    extra.append(0)
            body += struct.pack("<HHI", tag, typ, count) + val
        body += struct.pack("<I", 0)
        return bytes(body) + bytes(extra)


def write_tiff(path, rgb01, bits=16, compress=True, icc_bytes=None,
               exif_tags=None, software="art-tpu", xmp_bytes=None,
               iptc_iim=None):
    """Write (3, H, W) float RGB in [0,1] as an RGB TIFF.

    bits: 8 or 16 (unsigned int) or 32 (IEEE float, values kept linear
    in [0,1] as encoded by the output TRC upstream). ``xmp_bytes`` lands
    in tag 700 (XMP packet), ``iptc_iim`` in tag 33723.
    """
    arr = np.asarray(rgb01, dtype=np.float32)
    assert arr.ndim == 3 and arr.shape[0] == 3, arr.shape
    h, w = arr.shape[1:]
    hwc = np.moveaxis(np.clip(arr, 0.0, 1.0), 0, -1)
    if bits == 8:
        raster = (hwc * 255.0 + 0.5).astype("<u1")
        sample_format = 1
    elif bits == 16:
        raster = (hwc * 65535.0 + 0.5).astype("<u2")
        sample_format = 1
    elif bits == 32:
        raster = np.ascontiguousarray(hwc).astype("<f4")
        sample_format = 3
    else:
        raise ValueError(f"unsupported TIFF bit depth {bits}")

    if compress:
        compression = 8  # Adobe deflate
        if bits == 32:
            predictor = 1
            payload_arr = raster
        else:
            # horizontal differencing predictor in the sample domain
            predictor = 2
            diff = raster.astype(np.int32)
            diff[:, 1:, :] -= raster[:, :-1, :].astype(np.int32)
            payload_arr = (diff & (0xFF if bits == 8 else 0xFFFF)).astype(
                raster.dtype)
        payload = zlib.compress(payload_arr.tobytes(), 6)
    else:
        compression = 1
        predictor = 1
        payload = raster.tobytes()

    ifd = _IFD()
    ifd.add(256, T_LONG, [w])
    ifd.add(257, T_LONG, [h])
    ifd.add(258, T_SHORT, [bits, bits, bits])
    ifd.add(259, T_SHORT, [compression])
    ifd.add(262, T_SHORT, [2])              # RGB
    ifd.add(277, T_SHORT, [3])
    ifd.add(278, T_LONG, [h])               # one strip
    ifd.add(279, T_LONG, [len(payload)])
    ifd.add(284, T_SHORT, [1])              # chunky
    ifd.add(296, T_SHORT, [2])
    ifd.add(282, T_RATIONAL, [(300, 1)])
    ifd.add(283, T_RATIONAL, [(300, 1)])
    ifd.add(305, T_ASCII, software)
    ifd.add(339, T_SHORT, [sample_format] * 3)
    if predictor != 1:
        ifd.add(317, T_SHORT, [predictor])
    if icc_bytes:
        ifd.add(34675, T_UNDEF, icc_bytes)
    if xmp_bytes:
        ifd.add(700, T_BYTE, xmp_bytes)
    if iptc_iim:
        ifd.add(33723, T_UNDEF, iptc_iim)

    tags = exif_tags or {}
    for tag, (key, typ) in _IFD0_TAGS.items():
        v = tags.get(key)
        if v not in (None, ""):
            ifd.add(tag, typ, v if typ == T_ASCII else [v])
    if tags.get("orientation"):
        ifd.add(274, T_SHORT, [int(tags["orientation"])])

    exif_ifd = _IFD()
    for tag, (key, typ) in _EXIF_TAGS.items():
        v = tags.get(key)
        if v in (None, "", 0, 0.0):
            continue
        if tag == 34855 and isinstance(v, tuple):
            v = v[0]
        exif_ifd.add(tag, typ, v if typ == T_ASCII else [v])
    has_exif = bool(exif_ifd.entries)

    # sizes are a pure function of entry data lengths, so placeholder
    # pointer values can be laid out first and patched by re-serializing
    # at the same (now-known) offsets
    if has_exif:
        ifd.add(34665, T_LONG, [0])
    ifd.add(273, T_LONG, [0])
    exif_off = 8 + len(ifd.layout(8))
    exif_bytes = exif_ifd.layout(exif_off) if has_exif else b""
    strip_off = exif_off + len(exif_bytes)
    patch = {34665: exif_off, 273: strip_off}
    ifd.entries = [
        (t, ty, c, struct.pack("<I", patch[t]) if t in patch else d)
        for (t, ty, c, d) in ifd.entries]

    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, 8))
        f.write(ifd.layout(8))
        f.write(exif_bytes)
        f.write(payload)
    return path
