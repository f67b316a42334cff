"""Host-side image encode: JPEG, TIFF and PNG (counterpart of
``art_tpu/io/imagefile.py::save_image``), with no PIL and no OpenCV.

The reference's output matrix: JPEG 8-bit through the port's own
libjpeg-exact encoder (:mod:`art_tpu_torch.io.jpeg`, in place of the
reference's OpenCV call, same bytes) with EXIF and ICC inserted as
APP1/APP2 segments; TIFF 8/16/32 through :mod:`art_tpu_torch.io.tiffwrite`;
PNG 8/16-bit through the small zlib writer below (the reference uses PIL
for 8 bits and OpenCV for 16; the pixels are the same). Reading non-raw
images (``load_std_image``) is not ported.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def save_image(path, rgb_encoded01, bits=8, quality=92, icc_bytes=None,
               exif_bytes=None, exif_tags=None, uncompressed=False,
               xmp_bytes=None, iptc_iim=None, subsampling=3):
    """Save an encoded (post-TRC) RGB image in [0,1], shape (3, H, W), or
    the device's uint8 output, (H, W, 3) or (3, H, W).

    Output matrix per the reference (imageio.h:90-96, main-cli.cc:878-887):
    JPEG 8-bit; PNG 8/16-bit; TIFF 8/16-bit uint or 32-bit float, deflate
    unless ``uncompressed``. ``xmp_bytes``/``iptc_iim`` carry the XMP
    packet and IPTC-IIM record stream into the container (APP1/APP13 for
    JPEG, iTXt for PNG, tags 700/33723 for TIFF)."""
    arr = np.asarray(rgb_encoded01)
    if arr.ndim != 3:
        raise ValueError(f"need a 3-D image, got shape {arr.shape}")
    if arr.dtype == np.uint8:
        # device-converted 8-bit output (PipelineConfig.out_u8): already
        # clipped/scaled, planar (3,H,W) or interleaved (H,W,3)
        if bits != 8:
            raise ValueError("uint8 planes require bits=8")
        if arr.shape[0] == 3 and arr.shape[2] != 3:
            arr = np.moveaxis(arr, 0, -1)
    elif arr.shape[0] != 3:
        raise ValueError(f"need (3, H, W) planes, got shape {arr.shape}")
    d = os.path.dirname(str(path))
    if d:
        os.makedirs(d, exist_ok=True)
    path = str(path)
    lower = path.lower()
    if lower.endswith(".tif") or lower.endswith(".tiff"):
        from art_tpu_torch.io.tiffwrite import write_tiff

        if arr.dtype == np.uint8:  # HWC u8 after the normalization above
            arr = np.moveaxis(arr, -1, 0).astype(np.float32) / 255.0
        write_tiff(path, np.clip(arr, 0.0, 1.0), bits=bits,
                   compress=not uncompressed,
                   icc_bytes=icc_bytes, exif_tags=exif_tags,
                   xmp_bytes=xmp_bytes, iptc_iim=iptc_iim)
        return
    if bits == 16 and lower.endswith(".png"):
        # as the reference's OpenCV call: RGB48, no metadata
        hwc = np.moveaxis(np.clip(arr, 0.0, 1.0), 0, -1)
        write_png(path, (hwc * 65535.0 + 0.5).astype(np.uint16))
        return
    # 8-bit conversion on the contiguous CHW float, then a byte-level
    # transpose; device-converted uint8 output arrives HWC and skips both
    if arr.dtype == np.uint8:
        data = arr
    else:
        u8 = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        data = np.ascontiguousarray(np.moveaxis(u8, 0, -1))
    if lower.endswith(".jpg") or lower.endswith(".jpeg"):
        from art_tpu_torch.io import jpeg
        from art_tpu_torch.io.xmp import (insert_jpeg_app_segments,
                                          insert_jpeg_segments)

        with open(path, "wb") as f:
            f.write(jpeg.encode(data, quality=int(quality),
                                subsampling=int(subsampling or 3)))
        insert_jpeg_app_segments(path, exif_bytes=exif_bytes,
                                 icc_bytes=icc_bytes)
        if xmp_bytes or iptc_iim:
            insert_jpeg_segments(path, xmp_bytes=xmp_bytes,
                                 iptc_iim=iptc_iim)
        return
    if lower.endswith(".png"):
        write_png(path, data, icc_bytes=icc_bytes, exif_bytes=exif_bytes,
                  xmp_bytes=xmp_bytes)
        return
    raise NotImplementedError(
        f"output format of {path!r}: only JPEG, TIFF and PNG are ported "
        "to art_tpu_torch")


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, hwc, icc_bytes=None, exif_bytes=None, xmp_bytes=None):
    """Write an (H, W, 3) uint8 or uint16 RGB image as a PNG: no filter,
    deflate level 6; the ICC profile as iCCP, EXIF as eXIf, XMP as an
    iTXt chunk."""
    hwc = np.asarray(hwc)
    if hwc.dtype not in (np.uint8, np.uint16) or hwc.ndim != 3 \
            or hwc.shape[2] != 3:
        raise ValueError(f"need (H, W, 3) uint8/uint16, got {hwc.dtype} "
                         f"{hwc.shape}")
    h, w = hwc.shape[:2]
    depth = 8 * hwc.dtype.itemsize
    rows = hwc.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rows.view(np.uint8)], axis=1)
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0, 0))]
    if icc_bytes:
        out.append(_chunk(b"iCCP", b"ICC Profile\x00\x00"
                          + zlib.compress(icc_bytes)))
    if exif_bytes:
        payload = exif_bytes[6:] if exif_bytes[:6] == b"Exif\x00\x00" \
            else exif_bytes
        out.append(_chunk(b"eXIf", payload))
    if xmp_bytes:
        out.append(_chunk(b"iTXt", b"XML:com.adobe.xmp\x00\x00\x00\x00\x00"
                          + xmp_bytes))
    out.append(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))
