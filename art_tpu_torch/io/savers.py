"""Pillow 12.1.0's writers of an RGB image, with no PIL: the formats that
the reference's ``io/imagefile.py::save_image`` hands to
``Image.fromarray(data, mode="RGB").save(path, icc_profile=...,
exif=...)``, every extension but ``.tif``, ``.tiff``, ``.jpg``,
``.jpeg`` and ``.png``.

`EXTENSION` is Pillow's extension -> format table, as
``Image.registered_extensions()`` gives it; `save` looks the format up
there and runs its writer, one function a format mirroring the plugin's
``_save``:

- byte for byte: BMP and DIB, TGA, SGI, IM, PCX, PPM (written as P6
  under all five extensions), DDS, EPS, QOI, JPEG by ``.jpe``/``.jfif``
  and MPO (Pillow's JPEG writer at its defaults: quality 75, 4:2:0, the
  EXIF as APP1 and the ICC profile as APP2), PDF (that JPEG in Pillow's
  PDF; its two dates from the clock) and GIF (``convert("P",
  palette=ADAPTIVE)``'s median cut, the writer's palette optimisation
  and its LZW);
- decoded equal: ICO (Lanczos thumbnails of 16-256 px) and ICNS (bicubic
  resizes to 16-1024 px), each frame a PNG of
  :func:`art_tpu_torch.io.imagefile.png_bytes`, and APNG (one PNG). The
  port's PNG has no row filter, so the bytes differ from Pillow's.

Formats with no writer fail as Pillow's do: BLP, MSP, PALM and XBM with
the writer's error on an RGB image, BUFR, GRIB, HDF5 and WMF with "save
handler not installed", an extension Pillow opens but cannot write with
its KeyError, an unknown extension with its ValueError. Pillow opens the
file before its writer runs and removes it where the writer fails, if it
was not there before (a file that was is left empty). JPEG 2000, WebP
and AVIF raise NotImplementedError naming the format.

The per-pixel loops (QOI, PCX's RLE, EPS's hex, the median cut and GIF's
LZW, the resamples) are C++ (``io/native/saveenc.cc``).
"""

from __future__ import annotations

import ctypes
import math
import os
import struct
import threading
import time

import numpy as np

from art_tpu_torch import hostbuild

# Image.registered_extensions() of Pillow 12.1.0
EXTENSION = {
    ".apng": "PNG", ".avif": "AVIF", ".avifs": "AVIF", ".blp": "BLP",
    ".bmp": "BMP", ".bufr": "BUFR", ".bw": "SGI", ".cur": "CUR",
    ".dcx": "DCX", ".dds": "DDS", ".dib": "DIB", ".emf": "WMF",
    ".eps": "EPS", ".fit": "FITS", ".fits": "FITS", ".flc": "FLI",
    ".fli": "FLI", ".ftc": "FTEX", ".ftu": "FTEX", ".gbr": "GBR",
    ".gif": "GIF", ".grib": "GRIB", ".h5": "HDF5", ".hdf": "HDF5",
    ".icb": "TGA", ".icns": "ICNS", ".ico": "ICO", ".iim": "IPTC",
    ".im": "IM", ".j2c": "JPEG2000", ".j2k": "JPEG2000", ".jfif": "JPEG",
    ".jp2": "JPEG2000", ".jpc": "JPEG2000", ".jpe": "JPEG", ".jpeg": "JPEG",
    ".jpf": "JPEG2000", ".jpg": "JPEG", ".jpx": "JPEG2000", ".mpeg": "MPEG",
    ".mpg": "MPEG", ".mpo": "MPO", ".msp": "MSP", ".palm": "PALM",
    ".pbm": "PPM", ".pcd": "PCD", ".pcx": "PCX", ".pdf": "PDF",
    ".pfm": "PPM", ".pgm": "PPM", ".png": "PNG", ".pnm": "PPM",
    ".ppm": "PPM", ".ps": "EPS", ".psd": "PSD", ".pxr": "PIXAR",
    ".qoi": "QOI", ".ras": "SUN", ".rgb": "SGI", ".rgba": "SGI",
    ".sgi": "SGI", ".tga": "TGA", ".tif": "TIFF", ".tiff": "TIFF",
    ".vda": "TGA", ".vst": "TGA", ".webp": "WEBP", ".wmf": "WMF",
    ".xbm": "XBM", ".xpm": "XPM",
}

# the writers' errors on an RGB image, raised once the file is open
FAILS = {
    "BLP": (ValueError, "Unsupported BLP image mode"),
    "MSP": (OSError, "cannot write mode RGB as MSP"),
    "PALM": (OSError, "cannot write mode RGB as Palm"),
    "XBM": (OSError, "cannot write mode RGB as XBM"),
    "BUFR": (OSError, "BUFR save handler not installed"),
    "GRIB": (OSError, "GRIB save handler not installed"),
    "HDF5": (OSError, "HDF5 save handler not installed"),
    "WMF": (OSError, "WMF save handler not installed"),
}

# whole encoders still to port, in the order they are queued
QUEUED = {
    "JPEG2000": "JPEG 2000 (OpenJPEG 2.5.4's encoder), queued first",
    "WEBP": "WebP (libwebp 1.6.0, lossy q80, method 4), queued second",
    "AVIF": "AVIF (libavif/aom), queued third, blocked as its decode is",
}

_LIB = None
_LIB_LOCK = threading.Lock()
_BYTES = ctypes.POINTER(ctypes.c_uint8)


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = hostbuild.load("saveenc")
            for name in ("saveenc_qoi", "saveenc_pcx", "saveenc_eps"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(_BYTES),
                               ctypes.POINTER(ctypes.c_size_t)]
            lib.saveenc_quantize.restype = ctypes.c_int
            lib.saveenc_quantize.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int)]
            lib.saveenc_gif_lzw.restype = ctypes.c_int
            lib.saveenc_gif_lzw.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_size_t, ctypes.POINTER(_BYTES),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.saveenc_resample.restype = ctypes.c_int
            lib.saveenc_resample.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.saveenc_free.restype = None
            lib.saveenc_free.argtypes = [_BYTES]
            _LIB = lib
        return _LIB


def _native(name, rgb, *args):
    """The bytes the C++ encoder `name` gives for `rgb`."""
    lib = _lib()
    out, n = _BYTES(), ctypes.c_size_t()
    h, w = rgb.shape[:2]
    if getattr(lib, name)(rgb.ctypes.data, w, h, *args, ctypes.byref(out),
                          ctypes.byref(n)) != 0:
        raise MemoryError(f"{name}: out of memory")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.saveenc_free(out)


def save(path, rgb, icc_bytes=None, exif_bytes=None):
    """Write the (H, W, 3) uint8 image as ``Image.fromarray(rgb).save(
    path, icc_profile=icc_bytes, exif=exif_bytes)`` writes it (each
    keyword only where given)."""
    path = str(path)
    ext = os.path.splitext(path)[1].lower()
    if ext not in EXTENSION:
        raise ValueError(f"unknown file extension: {ext}")
    fmt = EXTENSION[ext]
    if fmt in QUEUED:
        raise NotImplementedError(
            f"writing {fmt} ({path!r}): the port's {QUEUED[fmt]}")
    if fmt not in WRITERS and fmt not in FAILS:
        raise KeyError(fmt)  # Pillow's SAVE[format]: no writer
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"need (H, W, 3) uint8, got {rgb.dtype} "
                         f"{rgb.shape}")
    info = {"icc_profile": icc_bytes, "exif": exif_bytes}
    created = not os.path.exists(path)
    with open(path, "w+b") as f:
        try:
            if fmt in FAILS:
                cls, msg = FAILS[fmt]
                raise cls(msg)
            f.write(WRITERS[fmt](rgb, path, info))
        except Exception:
            f.close()
            if created:
                try:
                    os.remove(path)
                except PermissionError:
                    pass
            raise


def _o16(v):
    return struct.pack("<H", v)


def _o32(v):
    return struct.pack("<I", v)


# -- BMP, DIB, TGA, SGI, IM, PPM, DDS ----------------------------------------

def _bmp(rgb, filename, info, file_header=True):
    """BmpImagePlugin._save: BGR rows bottom up, each padded to 4 bytes,
    at 96 dpi."""
    h, w = rgb.shape[:2]
    stride = ((w * 24 + 7) // 8 + 3) & ~3
    image = stride * h
    ppm = int(96 * 39.3701 + 0.5)
    out = bytearray()
    if file_header:
        offset = 14 + 40
        if offset + image > 2**32 - 1:
            raise ValueError("File size is too large for the BMP format")
        out += b"BM" + _o32(offset + image) + _o32(0) + _o32(offset)
    out += (_o32(40) + _o32(w) + _o32(h) + _o16(1) + _o16(24) + _o32(0)
            + _o32(image) + _o32(ppm) + _o32(ppm) + _o32(0) + _o32(0))
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : 3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    return bytes(out) + rows.tobytes()


def _dib(rgb, filename, info):
    return _bmp(rgb, filename, info, file_header=False)


def _tga(rgb, filename, info):
    """TgaImagePlugin._save: uncompressed BGR rows bottom up, the
    version 2 footer."""
    h, w = rgb.shape[:2]
    head = (bytes([0, 0, 2]) + _o16(0) + _o16(0) + bytes([0]) + _o16(0)
            + _o16(0) + _o16(w) + _o16(h) + bytes([24, 0]))
    return (head + rgb[::-1, :, ::-1].tobytes()
            + b"\000" * 8 + b"TRUEVISION-XFILE." + b"\000")


def _sgi(rgb, filename, info):
    """SgiImagePlugin._save: one byte a sample, no RLE, each channel's
    rows bottom up; the file's base name as the image name."""
    h, w = rgb.shape[:2]
    name = os.path.splitext(os.path.basename(filename))[0]
    name = name.encode("ascii", "ignore")
    head = (struct.pack(">h", 474) + bytes([0, 1])
            + struct.pack(">HHHH", 3, w, h, 3) + struct.pack(">l", 0)
            + struct.pack(">l", 255) + struct.pack("4s", b"")
            + struct.pack("79s", name) + struct.pack("s", b"")
            + struct.pack(">l", 0) + struct.pack("404s", b""))
    return head + np.ascontiguousarray(
        np.moveaxis(rgb[::-1], 2, 0)).tobytes()


def _im(rgb, filename, info):
    """ImImagePlugin._save: the text header to byte 511, then each row
    (bottom up) as its R, G and B lines."""
    h, w = rgb.shape[:2]
    name, ext = os.path.splitext(os.path.basename(filename))
    name = "".join([name[: 92 - len(ext)], ext])
    head = (b"Image type: RGB image\r\n"
            + f"Name: {name}\r\n".encode("ascii")
            + f"Image size (x*y): {w}*{h}\r\n".encode("ascii")
            + b"File size (no of images): 1\r\n")
    head += b"\000" * (511 - len(head)) + b"\032"
    return head + np.ascontiguousarray(
        np.moveaxis(rgb[::-1], 2, 1)).tobytes()


def _ppm(rgb, filename, info):
    h, w = rgb.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + rgb.tobytes()


def _dds(rgb, filename, info):
    """DdsImagePlugin._save of RGB: uncompressed BGR, rows top down."""
    h, w = rgb.shape[:2]
    flags = 0x1 | 0x2 | 0x4 | 0x1000 | 0x8  # CAPS HEIGHT WIDTH PF PITCH
    head = (_o32(0x20534444)
            + struct.pack("<7I", 124, flags, h, w, (w * 24 + 7) // 8, 0, 0)
            + struct.pack("11I", *((0,) * 11))
            + struct.pack("<4I", 32, 0x40, 0, 24)
            + struct.pack("<4I", 0x00FF0000, 0x0000FF00, 0x000000FF, 0)
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    return head + rgb[..., ::-1].tobytes()


# -- PCX, EPS, QOI (C++) -----------------------------------------------------

def _pcx(rgb, filename, info):
    """PcxImagePlugin._save: version 5, 8 bits, three planes a line, the
    RLE of PcxEncode.c."""
    h, w = rgb.shape[:2]
    stride = w + w % 2
    head = (bytes([10, 5, 1, 8]) + _o16(0) + _o16(0) + _o16(w - 1)
            + _o16(h - 1) + _o16(100) + _o16(100) + b"\0" * 24
            + b"\xff" * 24 + b"\0" + bytes([3]) + _o16(stride) + _o16(1)
            + _o16(w) + _o16(h) + b"\0" * 54)
    return head + _native("saveenc_pcx", rgb)


def _eps(rgb, filename, info):
    """EpsImagePlugin._save: the EPS header, the image operator, the
    samples in hex, 39 bytes a line."""
    h, w = rgb.shape[:2]
    out = (b"%!PS-Adobe-3.0 EPSF-3.0\n"
           b"%%Creator: PIL 0.1 EpsEncode\n"
           + b"%%%%BoundingBox: 0 0 %d %d\n" % (w, h)
           + b"%%Pages: 1\n%%EndComments\n%%Page: 1 1\n"
           + b"%%ImageData: %d %d " % (w, h)
           + b'%d %d 0 1 1 "%s"\n' % (8, 3, b"false 3 colorimage")
           + b"gsave\n10 dict begin\n"
           + b"/buf %d string def\n" % (w * 3)
           + b"%d %d scale\n" % (w, h) + b"%d %d 8\n" % (w, h)
           + b"[%d 0 0 -%d 0 %d]\n" % (w, h, h)
           + b"{ currentfile buf readhexstring pop } bind\n"
           + b"false 3 colorimage\n")
    return (out + _native("saveenc_eps", rgb) + b"\n%%%%EndBinary\n"
            + b"grestore end\n")


def _qoi(rgb, filename, info):
    """QoiImagePlugin._save: colour space 1 (linear, Pillow's default),
    then QoiEncoder's ops."""
    h, w = rgb.shape[:2]
    return (b"qoif" + struct.pack(">II", w, h) + bytes([3, 1])
            + _native("saveenc_qoi", rgb))


# -- JPEG, MPO, PDF ----------------------------------------------------------

def jpeg_default(rgb, icc_profile=None, exif=None):
    """JpegImagePlugin._save at its defaults: libjpeg's quality 75 and
    4:2:0 (:func:`art_tpu_torch.io.jpeg.encode`), the EXIF bytes as they
    are in APP1 after the JFIF APP0, then the ICC profile in APP2
    chunks."""
    from art_tpu_torch.io import jpeg

    if rgb.shape[0] == 0 or rgb.shape[1] == 0:
        raise ValueError("cannot write empty image as JPEG")
    extra = b""
    if icc_profile:
        room = 65533 - 14
        chunks = [icc_profile[i : i + room]
                  for i in range(0, len(icc_profile), room)]
        for i, chunk in enumerate(chunks):
            extra += (b"\xff\xe2" + struct.pack(">H", 2 + 14 + len(chunk))
                      + b"ICC_PROFILE\0" + bytes([i + 1, len(chunks)])
                      + chunk)
    exif = exif or b""
    if len(exif) > 65533:
        raise ValueError("EXIF data is too long")
    app1 = b""
    if exif:
        app1 = b"\xff\xe1" + struct.pack(">H", len(exif) + 2) + exif
    data = jpeg.encode(rgb, quality=75, subsampling=1)
    at = 2 + 2 + struct.unpack_from(">H", data, 4)[0]  # SOI, JFIF APP0
    return data[:at] + app1 + extra + data[at:]


def _jpeg(rgb, filename, info):
    return jpeg_default(rgb, info["icc_profile"], info["exif"])


def _pdf_string(b):
    return b"(" + b.replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(
        b")", b"\\)") + b")"


def _pdf(rgb, filename, info):
    """PdfImagePlugin._save of one RGB page at 72 dpi: the image as
    DCTDecode (`jpeg_default`, the ICC profile and EXIF with it), the
    page, its contents and the document information (the title, the
    creation and modification dates from the clock), as PdfParser lays
    them out."""
    h, w = rgb.shape[:2]
    stream = jpeg_default(rgb, info["icc_profile"], info["exif"])
    title = os.path.splitext(os.path.basename(filename))[0]
    created, modified = time.gmtime(), time.gmtime()
    out = bytearray(b"%PDF-1.4\n% created by Pillow PDF driver\n")
    offsets = {}

    def obj(num, body, data=None):
        offsets[num] = len(out)
        out.extend(b"%d 0 obj" % num)
        if data is not None:
            body = body + [(b"Length", b"%d" % len(data))]
        out.extend(b"<<" + b"".join(b"\n/" + k + b" " + v for k, v in body)
                   + b"\n>>")
        if data is not None:
            out.extend(b"stream\n" + data + b"\nendstream\n")
        out.extend(b"endobj\n")

    obj(4, [(b"Type", b"/Catalog"), (b"Pages", b"5 0 R")])
    obj(5, [(b"Type", b"/Pages"), (b"Count", b"1"), (b"Kids", b"[ 2 0 R ]")])
    obj(1, [(b"Type", b"/XObject"), (b"Subtype", b"/Image"),
            (b"Width", b"%d" % w), (b"Height", b"%d" % h),
            (b"Filter", b"/DCTDecode"), (b"BitsPerComponent", b"8"),
            (b"ColorSpace", b"/DeviceRGB")], stream)
    size = (str(w * 72.0 / 72.0).encode(), str(h * 72.0 / 72.0).encode())
    obj(2, [(b"Resources", b"<<\n/ProcSet [ /PDF /ImageC ]\n/XObject <<"
                           b"\n/image 1 0 R\n>>\n>>"),
            (b"MediaBox", b"[ 0 0 " + size[0] + b" " + size[1] + b" ]"),
            (b"Contents", b"3 0 R"), (b"Type", b"/Page"),
            (b"Parent", b"5 0 R")])
    obj(3, [], b"q %f 0 0 %f 0 0 cm /image Do Q\n" % (w * 72.0 / 72.0,
                                                      h * 72.0 / 72.0))
    doc = []
    if title:
        doc.append((b"Title", _pdf_string(b"\xfe\xff"
                                          + title.encode("utf_16_be"))))
    for key, t in ((b"CreationDate", created), (b"ModDate", modified)):
        doc.append((key, b"(D:" + time.strftime("%Y%m%d%H%M%SZ", t).encode(
            "us-ascii") + b")"))
    obj(6, doc)
    start = len(out)
    out.extend(b"xref\n0 7\n0000000000 65536 f \n")
    for num in range(1, 7):
        out.extend(b"%010d %05d n \n" % (offsets[num], 0))
    out.extend(b"trailer\n<<\n/Root 4 0 R\n/Size 7\n/Info 6 0 R\n>>"
               + b"\nstartxref\n%d\n%%%%EOF" % start)
    return bytes(out)


# -- GIF ---------------------------------------------------------------------

def quantize(rgb, colors=256):
    """``Image.quantize(colors)`` of an RGB image, the median cut
    (Quantize.c, method 0): ((H, W) uint8 indices, (n, 3) uint8
    palette)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    idx = np.empty((h, w), np.uint8)
    pal = np.zeros((256, 3), np.uint8)
    n = ctypes.c_int()
    rc = _lib().saveenc_quantize(rgb.ctypes.data, h * w, colors,
                                 idx.ctypes.data, pal.ctypes.data,
                                 ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"saveenc_quantize failed ({rc})")
    return idx, pal[: n.value].copy()


def gif_parts(rgb):
    """The image GifImagePlugin._save writes of an RGB image: its
    ADAPTIVE conversion to P, then _normalize_palette's optimisation
    (below 512x512 pixels: the used entries only, where some are unused
    before the last used one or the palette's power-of-two size would
    halve). ((H, W) uint8 indices, (n, 3) uint8 palette)."""
    idx, pal = quantize(rgb)
    h, w = idx.shape
    if w * h < 512 * 512:
        used = np.flatnonzero(np.bincount(idx.reshape(-1), minlength=256))
        n = len(pal)
        size = 1 << (n - 1).bit_length()
        if used.max() >= len(used) or (len(used) <= size // 2 and size > 2):
            where = np.zeros(256, np.uint8)
            where[used] = np.arange(len(used))
            idx, pal = where[idx], pal[used]
    return idx, pal


def _gif(rgb, filename, info):
    """GifImagePlugin._save of one frame: GIF87a, the global palette
    padded to a power of two, interlaced from 16 pixels a side, the LZW
    of GifEncode.c in the sub-blocks Pillow's buffer gives."""
    h, w = rgb.shape[:2]
    idx, pal = gif_parts(rgb)
    palette = pal.tobytes()
    n = len(pal)
    size = 1 if n < 3 else math.ceil(math.log(n, 2)) - 1
    palette += b"\0" * 3 * ((2 << size) - n)
    interlace = 0 if min(w, h) < 16 else 1
    out = (b"GIF87a" + _o16(w) + _o16(h) + bytes([size + 128, 0, 0])
           + palette + b"," + _o16(0) + _o16(0) + _o16(w) + _o16(h)
           + bytes([64 if interlace else 0, 8]))
    lib = _lib()
    data, nb = _BYTES(), ctypes.c_size_t()
    if lib.saveenc_gif_lzw(idx.ctypes.data, w, h, interlace,
                           max(65536, w * 4), ctypes.byref(data),
                           ctypes.byref(nb)) != 0:
        raise MemoryError("saveenc_gif_lzw: out of memory")
    try:
        body = ctypes.string_at(data, nb.value)
    finally:
        lib.saveenc_free(data)
    return out + body + b"\0" + b";"


# -- ICO, ICNS, APNG ---------------------------------------------------------

def resize(rgb, size, resample):
    """``Image.resize(size, resample)`` of an RGB image: Pillow's 8-bit
    two-pass resample (1 LANCZOS, 3 BICUBIC)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    ow, oh = size
    if (ow, oh) == (w, h):
        return rgb.copy()
    out = np.empty((oh, ow, 3), np.uint8)
    _lib().saveenc_resample(rgb.ctypes.data, w, h, ow, oh, resample,
                            out.ctypes.data)
    return out


def thumbnail_size(w, h, size):
    """``Image.thumbnail``'s size for an image of w x h larger than
    `size` on a side: the aspect kept, each side rounded to the nearer
    aspect."""
    x, y = size
    aspect = w / h

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect,
                         key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def ico_frames(rgb):
    """IcoImagePlugin._save's frames of an RGB image: for each default
    size no larger than the image and 256, the image itself where it has
    that size, else its LANCZOS thumbnail."""
    h, w = rgb.shape[:2]
    frames = []
    for s in (16, 24, 32, 48, 64, 128, 256):
        if s > w or s > h:
            continue
        if (w, h) == (s, s):
            frames.append(rgb)
            continue
        frames.append(resize(rgb, thumbnail_size(w, h, (s, s)), 1))
    return frames


def _ico(rgb, filename, info):
    from art_tpu_torch.io.imagefile import png_bytes

    frames = ico_frames(rgb)
    out = bytearray(b"\0\0\1\0" + _o16(len(frames)))
    pngs = [png_bytes(f) for f in frames]
    offset = len(out) + 16 * len(frames)
    for f, png in zip(frames, pngs):
        fh, fw = f.shape[:2]
        out += (bytes([fw if fw < 256 else 0, fh if fh < 256 else 0, 0, 0])
                + b"\0\0" + _o16(32) + _o32(len(png)) + _o32(offset))
        offset += len(png)
    return bytes(out) + b"".join(pngs)


ICNS_TYPES = ((b"ic07", 128), (b"ic08", 256), (b"ic09", 512),
              (b"ic10", 1024), (b"ic11", 32), (b"ic12", 64), (b"ic13", 256),
              (b"ic14", 512))


def icns_frames(rgb):
    """IcnsImagePlugin._save's images: {size: the BICUBIC resize to size
    x size} for each size of its types."""
    return {s: resize(rgb, (s, s), 3) for s in sorted({s for _, s in
                                                       ICNS_TYPES})}


def _icns(rgb, filename, info):
    from art_tpu_torch.io.imagefile import png_bytes

    streams = {s: png_bytes(f) for s, f in icns_frames(rgb).items()}
    entries = [(kind, 8 + len(streams[s]), streams[s])
               for kind, s in ICNS_TYPES]
    length = 8 + 8 + 8 * len(entries) + sum(e[1] for e in entries)
    out = bytearray(b"icns" + struct.pack(">i", length) + b"TOC "
                    + struct.pack(">i", 8 + len(entries) * 8))
    for kind, n, _ in entries:
        out += kind + struct.pack(">i", n)
    for kind, n, stream in entries:
        out += kind + struct.pack(">i", n) + stream
    return bytes(out)


def _png(rgb, filename, info):
    from art_tpu_torch.io.imagefile import png_bytes

    return png_bytes(rgb, icc_bytes=info["icc_profile"],
                     exif_bytes=info["exif"])


WRITERS = {
    "BMP": _bmp, "DIB": _dib, "TGA": _tga, "SGI": _sgi, "IM": _im,
    "PPM": _ppm, "DDS": _dds, "PCX": _pcx, "EPS": _eps, "QOI": _qoi,
    "JPEG": _jpeg, "MPO": _jpeg, "PDF": _pdf, "GIF": _gif, "ICO": _ico,
    "ICNS": _icns, "PNG": _png,
}
