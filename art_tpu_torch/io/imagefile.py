"""Host-side image encode and decode: JPEG, TIFF and PNG out
(counterpart of ``art_tpu/io/imagefile.py::save_image``), PNG, TIFF and
JPEG in, with no PIL and no OpenCV.

The reference's output matrix: JPEG 8-bit through the port's own
libjpeg-exact encoder (:mod:`art_tpu_torch.io.jpeg`, in place of the
reference's OpenCV call, same bytes) with EXIF and ICC inserted as
APP1/APP2 segments; TIFF 8/16/32 through :mod:`art_tpu_torch.io.tiffwrite`;
PNG 8/16-bit through the small zlib writer below (the reference uses PIL
for 8 bits and OpenCV for 16; the pixels are the same).

`read_rgb8` decodes a PNG (1 to 16 bits; grey, grey and alpha, RGB, RGBA,
palette; plain or Adam7; opened and loaded step by step as Pillow does,
CRCs checked at the open only), a TIFF or BigTIFF in every mode of
Pillow's OPEN_INFO under each compression Pillow's libtiff decodes
(:mod:`art_tpu_torch.io.tiff`), a JPEG
(:mod:`art_tpu_torch.io.jpegdec`: Huffman- or arithmetic-coded
baseline, extended or progressive, lossless; grey, YCbCr, RGB, CMYK or
YCCK), a BMP, PNM or GIF (:mod:`art_tpu_torch.io.stdformats`), a WebP
(:mod:`art_tpu_torch.io.webpdec`: lossless, lossy with its alpha, the
first frame of an animation), a DIB, ICO, CUR, TGA, PSD, QOI, PCX,
DCX or SGI (:mod:`art_tpu_torch.io.rasterformats`), a small raster
plugin's format (:mod:`art_tpu_torch.io.plugins`) or a BLP, DDS or ICNS
(:mod:`art_tpu_torch.io.textures`) into what the reference's callers ask
PIL for,
``np.asarray(Image.open(path).convert("RGB"))``, byte for byte: 16-bit
colour keeps its high byte, 16-bit grey clips at 255 (PIL's I;16), grey
below 8 bits scales to 0..255, a palette expands through PLTE (entries
past its end black), alpha and tRNS drop (premultiplied alpha divided
out first), CMYK goes through Pillow's ``cmyk2rgb``, LAB through
LittleCMS as Pillow's ``convert`` does. `read_grey` decodes an external mask as PIL opens it: a
16-bit grey PNG or little-endian TIFF as its uint16 samples (``I;16``),
a TIFF of 32-bit floats as float32 (``F``), any other image as the
green channel of the above (``L``). `read_image` gives an image as
``Image.open`` opens it, in Pillow's mode, with its embedded ICC
profile; `load_std_image` turns it into the RawFrame of a non-raw input
as the reference does. A format whose load always fails in Pillow
(BUFR, GRIB, HDF5, WMF/EMF, MPEG, EPS with no Ghostscript) raises its
OSError; another format that Pillow opens raises NotImplementedError
naming it; bytes Pillow cannot open raise `Unidentified`.
"""

from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np

from art_tpu_torch.io.stdformats import (PilSyntaxError, PilValueError,
                                         Unidentified)


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
    # the reference's Image.fromarray(data).save(path, icc_profile=...,
    # exif=...): Pillow's writer of the extension's format
    from art_tpu_torch.io import savers

    savers.save(path, data, icc_bytes=icc_bytes, exif_bytes=exif_bytes)


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, hwc, icc_bytes=None, exif_bytes=None, xmp_bytes=None):
    """Write an (H, W, 3) uint8 or uint16 RGB image as a PNG
    (`png_bytes`)."""
    data = png_bytes(hwc, icc_bytes, exif_bytes, xmp_bytes)
    with open(path, "wb") as f:
        f.write(data)


def png_bytes(hwc, icc_bytes=None, exif_bytes=None, xmp_bytes=None):
    """The PNG of an (H, W, 3) uint8 or uint16 RGB image: no filter,
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
    return b"".join(out)


# -- decode ----------------------------------------------------------------

def read_rgb8(path):
    """A PNG, TIFF, JPEG, BMP, PNM, GIF, WebP, DIB, ICO, CUR, TGA, PSD,
    QOI, PCX, DCX, SGI, small raster plugin, BLP, DDS, ICNS or JPEG 2000
    image as (H, W, 3) uint8, the array PIL's
    ``Image.open(path).convert("RGB")`` gives. Another format that PIL
    reads, or a form the port's decoder does not read, raises
    NotImplementedError naming it; bytes that are no image, an image
    whose decode fails (a truncated file) and a format whose load always
    fails in PIL raise OSError, as PIL does."""
    with open(path, "rb") as f:
        buf = f.read()
    mode, samples, _ = _decode(buf, path)
    return to_rgb8(mode, samples)


def read_grey(path, resized=False):
    """A mask image as PIL opens it for the reference's external masks
    (``art_tpu/masks/__init__.py::_load_external_mask``): (plane, mode)
    with mode "I;16" (uint16: a 16-bit grey PNG, a little-endian 16-bit
    grey TIFF), "F" (float32: a TIFF of 32-bit float samples) or "L"
    (uint8: any other image, "I" of a deep PGM included, the green
    channel of its ``convert("RGB")``), of the formats `read_rgb8`
    reads. An IPTC/NAA L file over a core of another mode
    (`plugins.iptc_l_core`) gives Pillow's L samples, each row the first
    bytes of the core's row; or, `resized`, the plane the reference's
    resize and green channel read, the core's second band (the resize
    keeps the core's mode), or a P core's indices as mode "P". Bytes
    that are no image, and an image whose decode fails (a truncated
    file), raise OSError as PIL does; another format that PIL reads raises
    NotImplementedError naming it."""
    with open(path, "rb") as f:
        buf = f.read()
    mode, samples, _ = _decode(buf, path)
    if mode in ("I;16", "F"):
        return samples, mode
    from art_tpu_torch.io import plugins

    core = plugins.iptc_l_core(buf, path)
    if core is not None:
        mem, second = core
        if resized:  # a P core has no band Pillow's resize takes
            return (mem, "P") if second is None else (second, "L")
        h, w = mem.shape[:2]
        return np.ascontiguousarray(mem.reshape(h, -1)[:, :w]), "L"
    return to_rgb8(mode, samples)[..., 1], "L"


def read_image(path):
    """An image as ``Image.open(path)`` opens it: (mode, samples, icc).
    mode is "RGB" for every 8-bit form (samples: its ``convert("RGB")``,
    (H, W, 3) uint8), or Pillow's mode of one 16- or 32-bit sample:
    "I;16" (a 16-bit grey PNG, a little-endian 16-bit grey TIFF, FITS)
    and "I;16B" (a big-endian one, McIdas), "I;16L" (IM), uint16; "I" (a
    TIFF of 32-bit or signed 16-bit integers, FITS, McIdas, IM), int32;
    "F" (32-bit floats: TIFF, FITS, PFM, SPIDER, IM), float32; or
    "YCbCr" (IM), (H, W, 3) uint8, which `to_rgb8` converts. icc is the
    embedded ICC profile as Pillow's ``info["icc_profile"]`` gives it (a
    PNG's iCCP inflated, TIFF tag 34675, a JPEG's APP2 ICC_PROFILE
    chunks joined in sequence order, a WebP's ICCP chunk, a PSD's image
    resource 1039), or None; the formats `read_rgb8` reads (an ICO of a
    16-bit grey PNG icon as "I;16"). Errors as `read_rgb8`'s;
    where Pillow's ``Image.open`` fails (bytes that are no image, a PNG
    broken before its image data, a JPEG whose markers Pillow's parse
    rejects, a TIFF with no readable IFD or size, a WebP libwebp's
    demuxer rejects) they are `Unidentified` (an OSError); where its load
    fails, other errors."""
    with open(path, "rb") as f:
        buf = f.read()
    return _decode(buf, path)


def to_rgb8(mode, samples):
    """Pillow's ``convert("RGB")`` of the samples `read_image` gives: a
    16-bit plane clips at 255, a 32-bit integer one to 0..255, a float
    one truncates toward zero within 0..255 (through Pillow's "L"),
    YCbCr through Pillow's fixed-point conversion."""
    if mode == "RGB":
        return samples
    if mode == "YCbCr":
        from art_tpu_torch.io.plugins import ycbcr_to_rgb

        return ycbcr_to_rgb(samples)
    if mode == "F":
        grey = np.where(samples >= 255.0, 255.0,
                        np.where(samples > 0.0, samples, 0.0))
        grey = np.nan_to_num(grey, nan=0.0).astype(np.uint8)
    else:
        grey = np.clip(samples, 0, 255).astype(np.uint8)
    return np.repeat(grey[..., None], 3, axis=2)


def load_std_image(path):
    """A non-raw image as a RawFrame with an rgb payload (counterpart of
    ``art_tpu/io/imagefile.py::load_std_image``; StdImageSource,
    stdimagesource.cc): the embedded ICC profile converted to LittleCMS's
    sRGB (:mod:`art_tpu_torch.color.lcms`, perceptual, 8 bits) on
    ``convert("RGB")`` of the image, unconverted where LittleCMS refuses
    the profile; a 16-bit grey (I;16, I;16B, I;16L) or 32-bit integer
    image (no profile) kept at its depth over 65535, any other through its ``convert("RGB")``
    over 255; then the sRGB decode, times MAXVAL, as (3, H, W) float32.

    A file ``Image.open`` cannot open (missing, no image, a header it
    rejects: `Unidentified`) goes to the external loader registered for
    its extension (``io/iomanager.py``), whose TIFF is read instead;
    without one the error stands. A file whose data fails to decode, or
    whose format PIL opens and never loads, raises as the reference's
    load does, with no loader. A format PIL reads and the port's decoder
    does not raises NotImplementedError naming it, with no loader
    tried."""
    from art_tpu_torch.color import colorspaces as cs
    from art_tpu_torch.color import lcms
    from art_tpu_torch.core.image import MAXVAL
    from art_tpu_torch.io.rawfile import RawFrame

    buf = None
    try:
        with open(path, "rb") as f:
            buf = f.read()
        mode, samples, icc = _decode(buf, path)
    except OSError as e:
        if buf is not None and not isinstance(e, Unidentified):
            raise  # Image.open succeeded; its load failed
        from art_tpu_torch.io.iomanager import get_instance

        conv = get_instance().load_image(path)
        if conv is None:
            raise
        mode, samples, icc = read_image(conv)
    else:
        if buf[:4] == b"icns":  # the reference's np.asarray of the image
            from art_tpu_torch.io.textures import icns_loaded_mode

            loaded = icns_loaded_mode(buf)
            if loaded not in ("RGB", "RGBA"):
                raise PilValueError(f"No packer found from {loaded} to RGBA")
    if icc:
        try:
            samples = lcms.to_srgb(to_rgb8(mode, samples), icc)
            mode = "RGB"
        except lcms.Refused:
            pass
    if mode in ("I;16", "I;16B", "I;16L", "I"):
        arr = samples.astype(np.float32) / 65535.0
        arr = np.stack([arr] * 3, axis=-1)
    else:
        arr = to_rgb8(mode, samples).astype(np.float32) / 255.0
    linear = cs.srgb_igamma(arr)
    chw = np.moveaxis(linear, -1, 0) * MAXVAL
    return RawFrame(
        cfa=np.zeros((1, 1), np.float32),
        pattern=None,
        rgb=np.ascontiguousarray(chw).astype(np.float32),
        filename=str(path),
    )


def _decode(buf, path):
    """(mode, samples, icc) of an image's bytes; see `read_image`."""
    from art_tpu_torch.io import stdformats

    try:
        if buf[:8] == b"\x89PNG\r\n\x1a\n":
            samples, depth, ctype, plte, icc = _read_png(buf)
            if ctype == 0 and depth == 16:
                return "I;16", samples[..., 0], icc
            return "RGB", _png_rgb8(samples, depth, ctype, plte), icc
        if buf[:4] in (b"II\x2a\x00", b"MM\x00\x2a", b"II\x2b\x00",
                       b"MM\x00\x2b"):
            from art_tpu_torch.io import tiff

            return tiff.read(buf)
        if buf[:3] == b"\xff\xd8\xff":
            from art_tpu_torch.io import jpegdec

            try:
                icc = jpegdec.pil_header(buf).icc_profile
            except OSError as e:  # Pillow's open fails
                raise Unidentified(f"cannot identify image file "
                                   f"{str(path)!r}: {e}") from e
            return "RGB", jpegdec.decode_rgb(buf), icc
        if buf[:2] == b"BM":
            return (*stdformats.read_bmp(buf), None)
        if buf[:6] in (b"GIF87a", b"GIF89a"):
            return (*stdformats.read_gif(buf), None)
        if stdformats.pnm_magic(buf)[0] in (b"P1", b"P2", b"P3", b"P4",
                                            b"P5", b"P6"):
            return (*stdformats.read_pnm(buf), None)
    except (IndexError, struct.error, zlib.error) as e:
        raise OSError(f"broken image file {str(path)!r}: {e}") from e
    except ValueError as e:
        if isinstance(e, (_TooLarge, PilValueError)):
            raise
        raise OSError(f"broken image file {str(path)!r}: {e}") from e
    return _plugin_walk(buf, path)


def _plugin_walk(buf, path):
    """Pillow's plugin walk past the formats read above, in the order of
    ``Image.ID`` (:mod:`art_tpu_torch.io.unported`): a DIB, CUR, PCX, DCX,
    ICO, PSD, QOI, SGI or TGA (:mod:`art_tpu_torch.io.rasterformats`), a
    FITS, FLI, FTEX, GBR, IM, IMT, IPTC/NAA, McIdas, MSP, PCD, PIXAR, PFM,
    PNM of a Pillow extension, SPIDER, SUN, XBM, XPM or XVThumb
    (:mod:`art_tpu_torch.io.plugins`), a BLP, DDS or ICNS
    (:mod:`art_tpu_torch.io.textures`), a WebP
    (:mod:`art_tpu_torch.io.webpdec`) or a JPEG 2000 file or codestream
    (:mod:`art_tpu_torch.io.jpeg2000`) loaded where the walk opens it;
    OSError with Pillow's message for a format whose load always fails
    in Pillow (BUFR, GRIB, HDF5, WMF/EMF, MPEG, EPS with no Ghostscript:
    the open succeeded, so the reference tries no external loader);
    NotImplementedError naming any other format Pillow opens (AVIF);
    `Unidentified` where Pillow opens nothing or WebP's open
    fails, and the other errors Pillow's open raises."""
    from art_tpu_torch.io import unported

    hit = unported.walk(buf, path)
    if hit is None:
        raise Unidentified(f"cannot identify image file {str(path)!r}")
    name, read = hit
    if read is not None:
        return read(buf, path)
    msg = unported.load_fails(name)
    if msg is not None:
        raise OSError(msg)
    raise NotImplementedError(
        f"{name} image {str(path)!r}: the port's image decoder "
        "(io/imagefile.py::read_rgb8) does not read AVIF")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw, h, row_bytes, bpp):
    """The PNG filters undone (None, Sub, Up, Average, Paeth): (h,
    row_bytes) uint8. Rows of None, Sub and Up go one row at a time;
    once a row uses Average or Paeth, which read the reconstructed byte
    to the left, the rest go by anti-diagonals of bpp-byte groups (a
    group reads its left, upper and upper-left neighbours)."""
    raw = np.frombuffer(raw, np.uint8)
    if raw.size < h * (row_bytes + 1):
        raise ValueError("broken PNG file: image data too short")
    raw = raw[: h * (row_bytes + 1)].reshape(h, row_bytes + 1)
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"broken PNG file: filter type {ftype.max()}")
    filt = raw[:, 1:]
    out = np.zeros((h, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.uint8)
    seq = np.nonzero(ftype >= 3)[0]
    first_seq = int(seq[0]) if seq.size else h
    for y in range(first_seq):
        t = ftype[y]
        row = filt[y]
        if t == 1:  # Sub: running sums of each of the bpp byte lanes
            row = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif t == 2:
            row = row + prior
        out[y] = row
        prior = out[y]
    if first_seq == h:
        return out
    g = row_bytes // bpp
    rest = h - first_seq
    f3 = filt[first_seq:].reshape(rest, g, bpp).astype(np.int32)
    # rec[y + 1, k + 1]: reconstructed group k of row first_seq + y;
    # row 0 the row above, column 0 zeros
    rec = np.zeros((rest + 1, g + 1, bpp), np.int32)
    rec[0, 1:] = prior.reshape(g, bpp)
    types = ftype[first_seq:].astype(np.int32)
    for d in range(rest + g - 1):
        ys = np.arange(max(0, d - g + 1), min(rest - 1, d) + 1)
        ks = d - ys
        a = rec[ys + 1, ks]
        b = rec[ys, ks + 1]
        c = rec[ys, ks]
        t = types[ys][:, None]
        pred = np.where(t == 1, a, np.where(
            t == 2, b, np.where(t == 3, (a + b) >> 1, np.where(
                t == 4, _paeth(a, b, c), 0))))
        rec[ys + 1, ks + 1] = (f3[ys, ks] + pred) & 255
    out[first_seq:] = rec[1:, 1:].reshape(rest, row_bytes)
    return out


def _png_samples(rows, w, depth, channels):
    """Unfiltered rows -> (h, w, channels) samples (uint8 or uint16)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, -1)[
            :, : w * channels].reshape(h, w, channels)
    if depth == 8:
        return rows[:, : w * channels].reshape(h, w, channels)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
    vals = np.zeros((h, w), np.uint8)
    for i in range(depth):
        vals = (vals << 1) | bits[..., i]
    return vals[..., None]


_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


class _TooLarge(ValueError):
    """An iCCP chunk inflates past Pillow's MAX_TEXT_CHUNK (Image.open
    raises ValueError)."""


_SAFEBLOCK = 1024 * 1024  # ImageFile.SAFEBLOCK, PngImagePlugin.MAX_TEXT_CHUNK


def _iccp(body):
    """PngStream.chunk_iCCP: the inflated profile, or None where the
    stream is broken; SyntaxError for a compression method other than 0,
    `_TooLarge` (a ValueError) for a profile past MAX_TEXT_CHUNK."""
    i = body.find(b"\0")
    if body[i + 1] != 0:
        raise SyntaxError(f"Unknown compression method {body[i + 1]} in "
                          "iCCP chunk")
    d = zlib.decompressobj()
    try:
        icc = d.decompress(body[i + 2 :], _SAFEBLOCK)
    except zlib.error:
        return None
    if d.unconsumed_tail:
        raise _TooLarge("Decompressed data too large for "
                        "PngImagePlugin.MAX_TEXT_CHUNK")
    return icc


class _Stream:
    """A file's bytes as Pillow's PNG plugin reads them from a file opened
    "rb": a read past the end gives what is left."""

    def __init__(self, buf, pos):
        self.buf, self.pos = buf, pos

    def read(self, n):
        out = self.buf[self.pos : self.pos + n]
        self.pos += len(out)
        return out

    def safe_read(self, n):
        """ImageFile._safe_read: OSError where the file ends first."""
        out = self.read(max(n, 0))
        if len(out) < n:
            raise OSError("Truncated File Read")
        return out

    def chunk_head(self):
        """ChunkStream.read: (cid, length); struct.error where fewer than
        4 bytes are left, SyntaxError for a name that is not 4 word
        characters."""
        s = self.read(8)
        length = struct.unpack_from(">I", s)[0]
        cid = s[4:]
        if not _IS_CID(cid):
            raise SyntaxError(f"broken PNG file (chunk {cid!r})")
        return cid, length


_IS_CID = re.compile(rb"\w\w\w\w").match
# PngImagePlugin._MODES: the (depth, colour type) pairs Pillow opens
_PNG_MODES = {(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2),
              (1, 3), (2, 3), (4, 3), (8, 3), (8, 4), (16, 4), (8, 6),
              (16, 6)}


def _png_chunk(f, cid, length, st):
    """PngStream.call for the chunks the decode reads (any other is read
    and dropped): the chunk's bytes. The handlers' own errors:
    ValueError for an IHDR shorter than 13 bytes or an iCCP profile
    past MAX_TEXT_CHUNK, SyntaxError for a filter method other than 0
    or an iCCP compression method other than 0."""
    s = f.safe_read(length)
    if cid == b"IHDR":
        if length < 13:
            raise PilValueError("Truncated IHDR chunk")
        st["size"] = struct.unpack_from(">II", s)
        if (s[8], s[9]) in _PNG_MODES:
            st["depth"], st["ctype"] = s[8], s[9]
        if s[12]:
            st["interlace"] = 1
        if s[11]:
            raise SyntaxError("unknown filter category")
    elif cid == b"PLTE":
        if st.get("ctype") == 3:
            st["plte"] = s
    elif cid == b"iCCP":
        st["icc"] = _iccp(s)
    return s


def _read_png(buf, bomb=False):
    """A PNG's (samples (h, w, channels), depth, colour type, PLTE, ICC
    profile) as Pillow 12.1.0 opens and loads it; `bomb`: Pillow's
    decompression bomb check between the open and the load.

    The open (``PngImageFile._open``): each chunk up to the first IDAT or
    IEND goes through its handler's checks, then its CRC is checked;
    any failure but a handler's ValueError is `Unidentified`. The load
    (``ImageFile.load`` over ``load_read`` and ``load_end``): IDAT data
    is inflated in blocks of 64 KiB with no CRC check, row by row, and
    the image is done once its last row is out (or the zlib stream ends
    on a row's end, the rows after it left black); the file ending
    first, a zlib error or a filter type past 4 is an OSError, a chunk
    name that is no name while more data is wanted a SyntaxError. The
    chunks after the image are read leniently (no CRC, a cut header ends
    them, IEND optional), but a chunk cut short there is an OSError. The
    profile is that of the last iCCP chunk before the image data."""
    f = _Stream(buf, 8)
    st = {"size": (0, 0), "depth": None, "ctype": None, "plte": b"",
          "icc": None, "interlace": 0}
    try:
        while True:
            cid, length = f.chunk_head()
            if cid in (b"IDAT", b"IEND"):  # EOFError: the open ends here
                break
            s = _png_chunk(f, cid, length, st)
            crc = f.read(4)
            if struct.unpack(">I", crc)[0] != zlib.crc32(cid + s):
                raise SyntaxError(f"broken PNG file (bad header checksum "
                                  f"in {cid!r})")
    except (OSError, SyntaxError, IndexError, struct.error) as e:
        raise Unidentified(f"cannot identify image file: {e}") from e
    w, h = st["size"]
    depth, ctype = st["depth"], st["ctype"]
    if depth is None or w <= 0 or h <= 0:
        raise Unidentified("cannot identify image file: no PNG mode or "
                           "size")
    if bomb:
        from art_tpu_torch.io import unported

        unported._bomb((w, h))
    if cid != b"IDAT":
        raise OSError("cannot load this image")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bits_px = depth * channels
    if st["interlace"]:
        passes = [(y0, x0, dy, dx, (h - y0 + dy - 1) // dy,
                   (w - x0 + dx - 1) // dx) for y0, x0, dy, dx in _ADAM7]
        passes = [p + ((p[5] * bits_px + 7) // 8,) for p in passes
                  if p[4] > 0 and p[5] > 0]
    else:
        passes = [(0, 0, 1, 1, h, w, (w * bits_px + 7) // 8)]
    data, rows = _png_load(f, length, [(p[4], p[6] + 1) for p in passes])
    dtype = np.uint16 if depth == 16 else np.uint8
    samples = np.zeros((h, w, channels), dtype)
    pos = 0
    bpp = max(1, bits_px // 8)
    for y0, x0, dy, dx, ph, pw, rb in passes:
        n = min(ph, rows)
        rows -= n
        if n:
            out = _png_samples(_unfilter(data[pos : pos + n * (rb + 1)], n,
                                         rb, bpp), pw, depth, channels)
            samples[y0 : y0 + n * dy : dy, x0::dx] = out
        pos += n * (rb + 1)
    return samples, depth, ctype, st["plte"], st["icc"]


def _png_load(f, idat, passes):
    """The image data of a PNG opened up to its first IDAT's data (`idat`
    bytes), as Pillow's load reads and inflates it (ZipDecode): (the
    inflated rows' bytes, the number of rows done). `passes`: (rows,
    bytes a row with its filter type) of each pass."""
    ends = []
    total = 0
    for n, rb in passes:
        for _ in range(n):
            total += rb
            ends.append(total)
    dec = zlib.decompressobj()
    out = bytearray()
    row = 0
    left = [idat]

    def load_read(n):
        while left[0] == 0:
            f.read(4)  # CRC
            try:
                cid, length = f.chunk_head()
            except struct.error as e:
                raise OSError("image file is truncated") from e
            except SyntaxError as e:
                raise PilSyntaxError(str(e)) from e
            if cid not in (b"IDAT", b"DDAT", b"fdAT"):
                f.pos -= 8  # pushed back for load_end
                return b""
            left[0] = length - 4 if cid == b"fdAT" else length
            if cid == b"fdAT":
                f.read(4)
        n = min(n, left[0])
        left[0] -= n
        return f.read(n)

    done = False
    while not done:
        s = load_read(65536)  # ImageFile.decodermaxblock
        if not s:
            raise OSError("image file is truncated")
        while s:  # ZipDecode: while avail_in > 0
            if dec.eof:
                break
            try:
                got = dec.decompress(s, ends[row] - len(out))
            except zlib.error as e:
                raise OSError(f"broken data stream when reading image "
                              f"file: {e}") from e
            out += got
            s = dec.unconsumed_tail
            if len(out) < ends[row]:
                break
            start = ends[row - 1] if row else 0
            if out[start] > 4:
                raise OSError("unknown decoder error: PNG filter type "
                              f"{out[start]}")
            row += 1
            if row == len(ends) or dec.eof:
                done = True
                break
    # load_end
    f.read(left[0])
    while True:
        f.read(4)  # CRC
        try:
            cid, length = f.chunk_head()
        except (struct.error, SyntaxError):
            break
        if cid == b"IEND":
            break
        try:
            _png_chunk(f, cid, length, {"icc": None})
        except SyntaxError as e:
            raise PilSyntaxError(str(e)) from e
    return bytes(out), row


def _png_rgb8(samples, depth, ctype, plte):
    """A PNG's samples as PIL's ``convert("RGB")``."""
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte[: len(plte) // 3 * 3],
                                np.uint8).reshape(-1, 3)[:256]
        pal[: len(entries)] = entries
        return pal[samples[..., 0]]
    if ctype in (0, 4):
        grey = samples[..., 0]
        if depth == 16 and ctype == 0:  # PIL's I;16 clips to 8 bits
            grey = np.minimum(grey, 255).astype(np.uint8)
        elif depth == 16:
            grey = (grey >> 8).astype(np.uint8)
        elif depth < 8:
            grey = (grey.astype(np.uint16) * (255 // ((1 << depth) - 1))
                    ).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=2)
    rgb = samples[..., :3]
    if depth == 16:
        rgb = (rgb >> 8).astype(np.uint8)
    return np.ascontiguousarray(rgb)
