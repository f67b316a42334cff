"""The image formats the reference opens through Pillow, decoded by the
port (`art_tpu_torch.io.stdformats`, `io/imagefile.py`, `io/jpegdec.py`)
on the CPU against Pillow 12.1.0 and, through `load_std_image`, against
`art_tpu.io.imagefile.load_std_image`.

- BMP (1, 4, 8, 16, 24 and 32 bits; RLE4 and RLE8 with absolute runs
  and Pillow's reading of the delta escape; bitfields; the OS/2 header;
  top-down), PNM (P1-P6, maxvals 1 to 65535, comments) and GIF (first
  frame; global and local tables; interlaced; transparency; a frame
  offset past the screen), through the four readers: `read_rgb8`,
  `read_grey` (the reference's mask rule: L, I;16 and F kept, every other
  mode converted), `read_image` (Pillow's mode) and `load_std_image`.
- TIFF: CMYK, separate planes (8 and 16 bits, strips and tiles, each
  compression), BigTIFF; `chip_smoke.py`'s F1 writers against Pillow.
- JPEG: arithmetic-coded sequential and progressive, lossless (the
  seven predictors, the point transform, restarts), CMYK and YCCK,
  strict and salvage loads of whole and cut files; the committed
  fixtures of tests/data against their recorded sha256.
- A file Pillow cannot open (OpenEXR's magic) reaches its external
  loader in both packages; files Pillow writes in a format the port
  does not decode are refused by name, and those it writes in DIB, TGA,
  ICO, PCX, SGI and QOI decode as Pillow's (the walk that tells the
  formats apart is tested in tests/test_torch_unported.py, the simple
  raster formats in tests/test_torch_rasterformats.py); F1's and R1's
  writers of chip_smoke.py against Pillow's reading.
- The consumers: a Hald CLUT, an external mask, a PSF image and
  `load_image`.
"""

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest

from art_tpu.io.imagefile import load_std_image as ref_load
from art_tpu_torch.io import imagefile, jpegdec, unported
from art_tpu_torch.io.imagefile import (load_std_image, read_grey, read_image,
                                        read_rgb8)

import chip_smoke
from test_torch_iomanager import both  # noqa: F401 (fixture)
from util_jpegforms import write_libjpeg, write_lossless

Image = pytest.importorskip("PIL.Image")
ImageFile = pytest.importorskip("PIL.ImageFile")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
H, W = 37, 53


def scene(h, w, c=3, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y) % 256, (y * 2) % 256, ((x + y) * 5) % 256,
                     (x * 7) % 256], -1)[..., :c]
    noise = rng.integers(-12, 12, base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def pil_mode_rgb(path):
    im = Image.open(path)
    return im.mode, np.asarray(im.convert("RGB"))


def pil_grey(path):
    """The reference's mask rule (art_tpu/masks/__init__.py:314-315)."""
    img = Image.open(path)
    if img.mode not in ("L", "I;16", "F"):
        img = img.convert("RGB")
    a = np.asarray(img)
    return (a[..., 1] if a.ndim == 3 else a), \
        (img.mode if img.mode in ("L", "I;16", "F") else "L")


def check_readers(path):
    """The four readers against Pillow and the reference."""
    mode, want = pil_mode_rgb(path)
    np.testing.assert_array_equal(read_rgb8(path), want)
    grey, gmode = read_grey(path)
    pg, pmode = pil_grey(path)
    assert gmode == pmode
    np.testing.assert_array_equal(grey, pg)
    got_mode, samples, icc = read_image(path)
    if mode in ("I", "I;16", "I;16B", "I;16L", "F", "YCbCr"):
        assert got_mode == mode
        np.testing.assert_array_equal(samples, np.asarray(Image.open(path)))
    else:
        assert got_mode == "RGB"
    ref = ref_load(path)
    got = load_std_image(path)
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    return mode


def _pil_bytes(img, fmt, **kw):
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


def _write(tmp_path, name, data):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return p


# -- BMP ---------------------------------------------------------------------

def bmp(pixels, bits, w, h, comp=0, palette=None, header=40, topdown=False,
        masks=None, masks_in_header=False, colors=None):
    """A BMP of raw pixel bytes (bottom-up rows as given): BITMAPINFOHEADER
    (or the 12-byte OS/2 header, or a longer one), a palette of (n, 3)
    RGB entries, bitfield masks after the header or inside it."""
    pal = b""
    if palette is not None:
        pad = 3 if header == 12 else 4
        pal = b"".join(bytes([b, g, r]) + b"\0" * (pad - 3)
                       for r, g, b in np.asarray(palette, np.uint8))
    extra = b""
    if masks is not None and not masks_in_header:
        extra = struct.pack("<3I", *masks[:3])
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if topdown else h,
                           1, bits, comp, len(pixels), 2835, 2835,
                           colors if colors is not None else
                           (0 if palette is None else len(palette)), 0)
        if header > 40:
            tail = struct.pack("<4I", *(list(masks or ()) + [0] * 4)[:4])
            info += (tail + b"\0" * header)[: header - 40]
    off = 14 + len(info) + len(extra) + len(pal)
    return (struct.pack("<2sIHHI", b"BM", off + len(pixels), 0, 0, off)
            + info + extra + pal + pixels)


def _rows(arr, row_bytes):
    """(h, row_bytes) rows padded to 4 bytes, bottom-up."""
    h = arr.shape[0]
    stride = (row_bytes + 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    out[:, :row_bytes] = arr.reshape(h, -1)[:, :row_bytes]
    return out[::-1].tobytes()


def _pack_bits(idx, bits):
    h, w = idx.shape
    per = 8 // bits
    wpad = (w + per - 1) // per * per
    v = np.zeros((h, wpad), np.uint8)
    v[:, :w] = idx
    v = v.reshape(h, -1, per)
    out = np.zeros(v.shape[:2], np.uint8)
    for i in range(per):
        out |= v[..., i] << (8 - bits * (i + 1))
    return out


def rle8(idx, absolute=True, delta=False):
    """RLE8 data of (h, w) indices, bottom-up: runs, an absolute run of
    three or more differing bytes, end of line, end of bitmap; `delta`
    puts a delta escape (0, 2, 1, 0) at the start of the second row."""
    out = bytearray()
    for y, row in enumerate(idx[::-1]):
        if delta and y == 1:
            out += bytes([0, 2, 1, 0])
        x = 0
        w = len(row)
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run == 1 and absolute and x + 3 <= w and \
                    row[x] != row[x + 1] != row[x + 2]:
                n = 3
                out += bytes([0, n]) + bytes(row[x : x + n]) + b"\0"
                x += n
                continue
            out += bytes([run, row[x]])
            x += run
        out += b"\0\0"
    return bytes(out + b"\0\1")


def rle4(idx):
    out = bytearray()
    for row in idx[::-1]:
        x = 0
        w = len(row)
        if w >= 4:  # an absolute run of four pixels
            out += bytes([0, 4, (row[0] << 4) | row[1], (row[2] << 4) | row[3]])
            x = 4
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            out += bytes([run, (row[x] << 4) | row[x]])
            x += run
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _bmp_forms():
    rgb = scene(H, W)
    pal16 = np.random.default_rng(19).integers(0, 256, (16, 3))
    pal256 = np.random.default_rng(19).integers(0, 256, (256, 3))
    idx4 = np.random.default_rng(19).integers(0, 16, (H, W)).astype(np.uint8)
    idx4[:, ::3] = idx4[:, :1]  # some runs
    idx8 = (scene(H, W)[..., 0] // 8).astype(np.uint8)
    v16 = np.random.default_rng(19).integers(0, 65536, (H, W)).astype("<u2")
    forms = {
        "24-bit": lambda: bmp(_rows(rgb[..., ::-1], W * 3), 24, W, H),
        "24-bit top-down": lambda: bmp(_rows(rgb[::-1, :, ::-1], W * 3), 24,
                                       W, H, topdown=True),
        "32-bit BGRX": lambda: bmp(_rows(np.dstack([rgb[..., ::-1], rgb[..., :1]]),
                                         W * 4), 32, W, H),
        "32-bit bitfields XBGR": lambda: bmp(
            _rows(np.dstack([rgb[..., :1], rgb[..., ::-1]]), W * 4), 32, W, H,
            comp=3, masks=(0xFF000000, 0xFF0000, 0xFF00), header=56,
            masks_in_header=True),
        "16-bit 5-5-5": lambda: bmp(_rows(v16.view(np.uint8).reshape(H, -1),
                                          W * 2), 16, W, H),
        "16-bit bitfields 5-6-5": lambda: bmp(
            _rows(v16.view(np.uint8).reshape(H, -1), W * 2), 16, W, H,
            comp=3, masks=(0xF800, 0x7E0, 0x1F)),
        "16-bit bitfields 5-5-5 in a V4 header": lambda: bmp(
            _rows(v16.view(np.uint8).reshape(H, -1), W * 2), 16, W, H,
            comp=3, masks=(0x7C00, 0x3E0, 0x1F, 0), header=108,
            masks_in_header=True),
        "8-bit palette": lambda: bmp(_rows(idx8, W), 8, W, H,
                                     palette=pal256),
        "8-bit short palette": lambda: bmp(_rows(idx8, W), 8, W, H,
                                           palette=pal16),
        "8-bit grey": lambda: bmp(_rows(idx8, W), 8, W, H,
                                  palette=np.repeat(np.arange(256)[:, None],
                                                    3, 1)),
        "4-bit palette": lambda: bmp(_rows(_pack_bits(idx4, 4), (W + 1) // 2),
                                     4, W, H, palette=pal16),
        "1-bit palette": lambda: bmp(_rows(_pack_bits(idx4 & 1, 1),
                                           (W + 7) // 8), 1, W, H,
                                     palette=pal16[:2]),
        "1-bit black and white": lambda: bmp(
            _rows(_pack_bits(idx4 & 1, 1), (W + 7) // 8), 1, W, H,
            palette=[(0, 0, 0), (255, 255, 255)]),
        "OS/2 24-bit": lambda: bmp(_rows(rgb[..., ::-1], W * 3), 24, W, H,
                                   header=12),
        "OS/2 8-bit": lambda: bmp(_rows(idx8, W), 8, W, H, palette=pal256,
                                  header=12),
        "RLE8": lambda: bmp(rle8(idx8), 8, W, H, comp=1, palette=pal256),
        "RLE8 delta": lambda: bmp(rle8(idx8, delta=True), 8, W, H, comp=1,
                                  palette=pal256),
        "RLE4": lambda: bmp(rle4(idx4), 4, W, H, comp=2, palette=pal16),
        "Pillow 24-bit": lambda: _pil_bytes(Image.fromarray(rgb), "BMP"),
        "Pillow 1-bit": lambda: _pil_bytes(Image.fromarray(idx4 > 7), "BMP"),
        "Pillow P": lambda: _pil_bytes(Image.fromarray(rgb).quantize(16),
                                       "BMP"),
        "Pillow RGBA": lambda: _pil_bytes(Image.fromarray(
            np.dstack([rgb, idx8])), "BMP"),
    }
    return forms


BMP_FORMS = _bmp_forms()


@pytest.mark.parametrize("form", sorted(BMP_FORMS))
def test_bmp_forms_read_as_pillow(form, tmp_path):
    path = _write(tmp_path, "a.bmp", BMP_FORMS[form]())
    try:
        Image.open(path).load()
    except ValueError:  # Pillow's RLE walk ends short: so must the port's
        with pytest.raises(ValueError):
            read_rgb8(path)
        return
    check_readers(path)


def test_bmp_truncated_and_unsupported(tmp_path):
    full = BMP_FORMS["24-bit"]()
    cut = _write(tmp_path, "cut.bmp", full[: len(full) // 2])
    with pytest.raises(OSError):
        Image.open(cut).load()
    with pytest.raises(OSError):
        read_rgb8(cut)
    bad = bytearray(full)
    bad[28:30] = struct.pack("<H", 7)  # 7 bits a pixel
    bad_path = _write(tmp_path, "bad.bmp", bytes(bad))
    with pytest.raises(OSError):
        Image.open(bad_path)
    with pytest.raises(imagefile.Unidentified):
        read_rgb8(bad_path)


# -- PNM ---------------------------------------------------------------------

def pnm(magic, maxval, vals, plain=False, comment=True):
    h, w = vals.shape[:2]
    hdr = b"%s\n%s%d %d\n%d\n" % (magic, b"# a comment\n" if comment else b"",
                                  w, h, maxval)
    if plain:
        body = b"\n".join(b" ".join(b"%d" % v for v in row.ravel())
                          for row in vals.reshape(h, -1))
        return hdr + b"# data comment\n" + body + b"\n"
    return hdr + vals.astype(np.uint8 if maxval < 256 else ">u2").tobytes()


def _pnm_forms():
    rgb = scene(H, W)
    grey = rgb[..., 0]
    bits = (grey > 120).astype(np.uint8)
    forms = {
        "P6 255": lambda: pnm(b"P6", 255, rgb),
        "P5 255": lambda: pnm(b"P5", 255, grey),
        "P6 65535": lambda: pnm(b"P6", 65535,
                                np.random.default_rng(19).integers(0, 65536, (H, W, 3))),
        "P5 65535": lambda: pnm(b"P5", 65535, np.random.default_rng(19).integers(0, 65536, (H, W))),
        "P5 4095": lambda: pnm(b"P5", 4095, np.random.default_rng(19).integers(0, 4096, (H, W))),
        "P6 1000": lambda: pnm(b"P6", 1000, np.random.default_rng(19).integers(0, 1001, (H, W, 3))),
        "P6 15": lambda: pnm(b"P6", 15, np.random.default_rng(19).integers(0, 16, (H, W, 3))),
        "P5 1": lambda: pnm(b"P5", 1, np.random.default_rng(19).integers(0, 2, (H, W))),
        "P5 2": lambda: pnm(b"P5", 2, np.random.default_rng(19).integers(0, 3, (H, W))),
        "P2 255": lambda: pnm(b"P2", 255, grey, True),
        "P2 7": lambda: pnm(b"P2", 7, np.random.default_rng(19).integers(0, 8, (H, W)), True),
        "P2 1000": lambda: pnm(b"P2", 1000, np.random.default_rng(19).integers(0, 1001, (H, W)),
                               True),
        "P3 255": lambda: pnm(b"P3", 255, rgb, True),
        "P3 2": lambda: pnm(b"P3", 2, np.random.default_rng(19).integers(0, 3, (H, W, 3)), True),
        "P3 300": lambda: pnm(b"P3", 300, np.random.default_rng(19).integers(0, 301, (H, W, 3)),
                              True),
        "P1": lambda: b"P1\n%d %d\n" % (W, H) + b"\n".join(
            b"".join(b"%d" % v for v in row) for row in bits),
        "P4": lambda: b"P4\n# c\n%d %d\n" % (W, H)
        + np.packbits(bits, axis=1).tobytes(),
        "Pillow P5 I": lambda: _pil_bytes(Image.fromarray(
            np.random.default_rng(19).integers(0, 65536, (H, W)).astype(np.int32), "I"), "PPM"),
        "Pillow P4": lambda: _pil_bytes(Image.fromarray(bits > 0), "PPM"),
    }
    return forms


PNM_FORMS = _pnm_forms()


@pytest.mark.parametrize("form", sorted(PNM_FORMS))
def test_pnm_forms_read_as_pillow(form, tmp_path):
    path = _write(tmp_path, "a.pnm", PNM_FORMS[form]())
    mode = check_readers(path)
    assert mode == Image.open(path).mode
    if form.startswith("P5 ") and int(form.split()[1]) > 255:
        assert read_image(path)[0] == "I"


def test_pnm_faults_fail_as_pillow(tmp_path):
    for name, data in {
            "value past maxval": b"P2\n2 1\n7\n3 9\n",
            "maxval 0": b"P5\n2 1\n0\n\0\0",
            "short data": b"P5\n4 4\n200\n" + bytes(5),
            "cut raw": b"P6\n4 4\n255\n" + bytes(20)}.items():
        path = _write(tmp_path, "x.pnm", data)
        try:
            Image.open(path).load()
            want = None
        except Exception as e:  # the oracle's failure, of any kind
            want = e
        assert want is not None, name
        with pytest.raises(ValueError if isinstance(want, ValueError)
                           else OSError):
            read_rgb8(path)


# -- GIF ---------------------------------------------------------------------

def gif(idx, palette=None, local=None, x0=0, y0=0, screen=None,
        interlace=False, transparency=None):
    """A GIF89a of one frame through `chip_smoke.write_gif`'s literal-code
    LZW, with a global and/or local table, an offset and an interlaced
    row order."""
    h, w = idx.shape
    sw, sh = screen or (w, h)
    order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                            np.arange(2, h, 4), np.arange(1, h, 2)]) \
        if interlace else np.arange(h)
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".gif") as f:
        chip_smoke.write_gif(f.name, idx[order], np.zeros((256, 3), np.uint8))
        raw = open(f.name, "rb").read()
    lzw = raw[13 + 768 + 10 :]  # code size, sub-blocks, terminator, ';'
    flags = 0
    gpal = b""
    if palette is not None:
        flags = 0xF7
        gpal = np.asarray(palette, np.uint8).tobytes()
    ext = b""
    if transparency is not None:
        ext = b"!\xf9\x04" + bytes([1, 0, 0, transparency]) + b"\0"
    lflags = (0x40 if interlace else 0)
    lpal = b""
    if local is not None:
        lflags |= 0x87
        lpal = np.asarray(local, np.uint8).tobytes()
    return (b"GIF89a" + struct.pack("<HHBBB", sw, sh, flags, 0, 0) + gpal
            + ext + b"," + struct.pack("<HHHHB", x0, y0, w, h, lflags)
            + lpal + lzw)


def _gif_forms():
    rgb = scene(H, W)
    p16 = Image.fromarray(rgb).quantize(16)
    pal = np.random.default_rng(19).integers(0, 256, (256, 3))
    pal2 = np.random.default_rng(19).integers(0, 256, (256, 3))
    idx = np.random.default_rng(19).integers(0, 256, (H, W)).astype(np.uint8)
    return {
        "Pillow P": lambda: _pil_bytes(p16, "GIF"),
        "Pillow interlaced": lambda: _pil_bytes(p16, "GIF", interlace=True),
        "Pillow transparency": lambda: _pil_bytes(p16, "GIF",
                                                  transparency=3),
        "Pillow L": lambda: _pil_bytes(Image.fromarray(rgb[..., 0]), "GIF"),
        "Pillow RGB": lambda: _pil_bytes(Image.fromarray(rgb), "GIF"),
        "global table": lambda: gif(idx, pal),
        "local table": lambda: gif(idx, pal, local=pal2),
        "local table only": lambda: gif(idx, local=pal2),
        "no table": lambda: gif(idx),
        "interlaced": lambda: gif(idx, pal, interlace=True),
        "offset frame": lambda: gif(idx[:20, :30], pal, x0=5, y0=7,
                                    screen=(W, H)),
        "offset with transparency": lambda: gif(idx[:20, :30], pal, x0=5,
                                                y0=7, screen=(W, H),
                                                transparency=9),
        "frame past the screen": lambda: gif(idx, pal, x0=4, y0=3,
                                             screen=(20, 20)),
    }


GIF_FORMS = _gif_forms()


@pytest.mark.parametrize("form", sorted(GIF_FORMS))
def test_gif_forms_read_as_pillow(form, tmp_path):
    check_readers(_write(tmp_path, "a.gif", GIF_FORMS[form]()))


def test_gif_cut_fails_as_pillow(tmp_path):
    full = GIF_FORMS["global table"]()
    path = _write(tmp_path, "cut.gif", full[: len(full) - 200])
    with pytest.raises(OSError):
        Image.open(path).load()
    with pytest.raises(OSError):
        read_rgb8(path)


def _codes(codes, width):
    """LZW codes of one width packed least significant bit first."""
    acc = nacc = 0
    out = bytearray()
    for c in codes:
        acc |= c << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8
    return bytes(out) + (bytes([acc]) if nacc else b"")


def _gif_of_codes(codes, bits, blocks=None, tail=b"\0;", w=4, h=4):
    """A 4x4 GIF whose frame data is `codes` at (bits + 1) bits, in
    sub-blocks of the given sizes (one block by default), then `tail`."""
    data = _codes(codes, bits + 1)
    sizes = blocks or [len(data)]
    out, pos = b"", 0
    for size in sizes:
        out += bytes([size]) + data[pos : pos + size]
        pos += size
    pal = bytes(i * 7 % 256 for i in range(768))
    return (b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + pal + b","
            + struct.pack("<HHHHB", 0, 0, w, h, 0) + bytes([bits]) + out
            + tail)


GIF_STREAMS = {
    # a minimum code size of 12: next starts past the 4096-entry table
    "12 bits, next twice": ([4096, 5, 4098, 4098, 4097], 12, None),
    "12 bits, next once": ([4096, 5, 4098] + [1] * 13 + [4097], 12, None),
    "12 bits, next then end": ([4096, 5, 4098, 7, 4097], 12, None),
    "end code first": ([256, 5, 6, 7, 257], 8, None),
    "stops short": ([256, 5, 6, 7], 8, None),
    # an end code ends Pillow's decoder call: where the file has no more
    # 64 KiB chunk to read, it is cut short
    "end code mid-frame": ([256] + [3] * 8 + [257] + [4] * 8, 8, None),
    # a zero-length block is an empty one: the blocks after it are read
    "blocks past the terminator": ([256] + [3] * 16, 8, [9, 0, 9]),
    "first code past clear": ([256, 258], 8, None),
    "code past next": ([256, 1, 261], 8, None),
}


def _literal_codes(idx):
    """9-bit literal codes of `idx` with a clear code every 254, so the
    table never widens the codes."""
    codes = []
    for i in range(0, len(idx), 254):
        codes += [256] + [int(v) for v in idx[i : i + 254]]
    return codes


def _big_gif(end_at, side=320):
    """A side x side frame (over 64 KiB of data) with an end code after
    `end_at` pixels, in 255-byte sub-blocks."""
    idx = np.random.default_rng(5).integers(0, 256, side * side)
    codes = _literal_codes(idx)
    at = end_at + end_at // 254 + 1
    codes = codes[:at] + [257] + codes[at:] + [257]
    n = len(_codes(codes, 9))
    blocks = [255] * (n // 255) + ([n % 255] if n % 255 else [])
    return _gif_of_codes(codes, 8, blocks, w=side, h=side), idx


@pytest.mark.parametrize("end_at", [1000, 320 * 320 - 100])
def test_gif_end_code_resumes_at_the_next_chunk(end_at, tmp_path):
    """An end code within the first 64 KiB of frame data: Pillow's next
    read resumes the decode and the frame is whole. One in the last
    chunk: the file is cut short."""
    data, idx = _big_gif(end_at)
    path = _write(tmp_path, "big.gif", data)
    if end_at == 1000:
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(read_rgb8(path), want)
        pal = np.frombuffer(data[13 : 13 + 768], np.uint8).reshape(256, 3)
        np.testing.assert_array_equal(want.reshape(-1, 3), pal[idx])
    else:
        with pytest.raises(OSError, match="truncated"):
            Image.open(path).load()
        with pytest.raises(OSError, match="truncated"):
            read_rgb8(path)


@pytest.mark.parametrize("form", sorted(GIF_STREAMS))
def test_gif_lzw_streams_as_pillow(form, tmp_path):
    """Frame data Pillow's GifDecode.c decodes, or refuses (a broken or
    short stream: OSError), as the port's lzwdec.cc does."""
    codes, bits, blocks = GIF_STREAMS[form]
    path = _write(tmp_path, "s.gif", _gif_of_codes(codes, bits, blocks))
    try:
        want = np.asarray(Image.open(path).convert("RGB"))
    except OSError as e:
        with pytest.raises(OSError, match=str(e).split(" (")[0]):
            read_rgb8(path)
        return
    np.testing.assert_array_equal(read_rgb8(path), want)


# -- TIFF ----------------------------------------------------------------------

def _lzw_encode(data):
    """TIFF LZW (MSB-first codes, the early change) of bytes."""
    table = {bytes([i]): i for i in range(256)}
    out, acc, nacc = bytearray(), 0, 0
    nbits, nxt = 9, 258

    def put(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 255)
            nacc -= 8

    put(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        # the decoder's table lags one code: it widens once it holds
        # 2^nbits - 1 entries, after the code that follows this one
        if nxt >= 4094:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nbits, nxt = 9, 258
        elif nxt >= (1 << nbits):
            nbits += 1
        w = bytes([c])
    if w:
        put(table[w])
        nxt += 1
        if nxt >= (1 << nbits) and nbits < 12:
            nbits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def _packbits_encode(data):
    out = bytearray()
    for i in range(0, len(data), 128):
        chunk = data[i : i + 128]
        out.append(len(chunk) - 1)
        out += chunk
    return bytes(out)


def planar_tiff(arr, tile=None, comp=1, big=False, predictor=False):
    """A little-endian planar TIFF (or BigTIFF) of (H, W, C) uint8/uint16,
    in strips of 16 rows or tiles of `tile`, compressed by `comp` (1, 5
    LZW, 8 deflate, 32773 PackBits)."""
    h, w, c = arr.shape
    bits = 8 * arr.dtype.itemsize
    th, tw = tile or (16, w)
    blocks = []
    for k in range(c):
        plane = arr[..., k]
        for y in range(0, h, th):
            for x in range(0, w, tw):
                b = np.zeros((th, tw) if tile else (min(th, h - y), tw),
                             arr.dtype)
                part = plane[y : y + th, x : x + tw]
                b[: part.shape[0], : part.shape[1]] = part
                if predictor:
                    b = np.diff(b, axis=1, prepend=np.zeros((b.shape[0], 1),
                                                            b.dtype))
                raw = b.astype("<u2" if bits == 16 else np.uint8).tobytes()
                raw = {1: raw, 5: _lzw_encode(raw) if comp == 5 else raw,
                       8: zlib.compress(raw),
                       32773: _packbits_encode(raw)}[comp]
                blocks.append(raw)
    ents = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * c),
            (259, 3, [comp]), (262, 3, [2]), (277, 3, [c]), (284, 3, [2])]
    if predictor:
        ents.append((317, 3, [2]))
    ents += [(322, 4, [tw]), (323, 4, [th])] if tile else [(278, 4, [th])]
    return chip_smoke.tiff_bytes(blocks, ents, big, tiles=bool(tile))


TIFF_FORMS = {}
for _bits in (8, 16):
    for _comp in (1, 5, 8, 32773):
        for _tile in (None, (16, 16)):
            TIFF_FORMS[f"planar {_bits}-bit comp {_comp} "
                       f"{'tiles' if _tile else 'strips'}"] = (
                lambda b=_bits, c=_comp, t=_tile: planar_tiff(
                    np.random.default_rng(19).integers(0, 1 << b, (H, W, 3)).astype(
                        np.uint16 if b == 16 else np.uint8), t, c))
TIFF_FORMS["planar predictor"] = lambda: planar_tiff(scene(H, W), comp=8,
                                                     predictor=True)
TIFF_FORMS["planar BigTIFF tiles"] = lambda: planar_tiff(
    scene(H, W), (16, 16), 8, big=True)
TIFF_FORMS["Pillow CMYK"] = lambda: _pil_bytes(
    Image.fromarray(scene(H, W, 4), "CMYK"), "TIFF")
TIFF_FORMS["Pillow CMYK LZW"] = lambda: _pil_bytes(
    Image.fromarray(scene(H, W, 4), "CMYK"), "TIFF", compression="tiff_lzw")
for _c in ("raw", "tiff_deflate", "tiff_lzw", "packbits"):
    TIFF_FORMS[f"Pillow BigTIFF {_c}"] = (
        lambda c=_c: _pil_bytes(Image.fromarray(scene(H, W)), "TIFF",
                                big_tiff=True, compression=c))
TIFF_FORMS["Pillow BigTIFF 16-bit grey"] = lambda: _pil_bytes(
    Image.fromarray(np.random.default_rng(19).integers(0, 65536, (H, W)).astype(np.uint16)),
    "TIFF", big_tiff=True)
TIFF_FORMS["Pillow BigTIFF float"] = lambda: _pil_bytes(
    Image.fromarray(np.random.default_rng(19).random((H, W)).astype(np.float32) * 300), "TIFF",
    big_tiff=True)


@pytest.mark.parametrize("form", sorted(TIFF_FORMS))
def test_tiff_forms_read_as_pillow(form, tmp_path):
    check_readers(_write(tmp_path, "a.tif", TIFF_FORMS[form]()))


@pytest.mark.parametrize("name", ["BMP 24-bit", "PPM 8-bit", "PGM 16-bit",
                                  "GIF", "planar TIFF", "BigTIFF",
                                  "CMYK TIFF", "TGA raw", "TGA RLE",
                                  "PSD raw", "PSD PackBits", "QOI",
                                  "PCX RGB", "SGI RLE"])
def test_chip_smoke_writers_as_pillow_reads_them(name, tmp_path):
    """F1's and R1's numpy writers (chip_smoke.py) at a small size: Pillow
    reads each file as the array written, and so does the port."""
    files = chip_smoke.formats_files(str(tmp_path), 61, 97)
    files.update(chip_smoke.raster_files(str(tmp_path), 61, 97))
    path, want = files[name]
    im = Image.open(path)
    if want is not None:
        pil = np.asarray(im) if im.mode == "I" else np.asarray(
            im.convert("RGB"))
        np.testing.assert_array_equal(pil, want)
    check_readers(path)


# -- JPEG ----------------------------------------------------------------------

def pil_load(buf, salvage):
    prev = ImageFile.LOAD_TRUNCATED_IMAGES
    ImageFile.LOAD_TRUNCATED_IMAGES = salvage
    try:
        im = Image.open(io.BytesIO(buf))
        im.load()
        return np.asarray(im.convert("RGB"))
    except Exception as e:  # the oracle's failure, of any kind
        return e
    finally:
        ImageFile.LOAD_TRUNCATED_IMAGES = prev


def check_jpeg(buf):
    for salvage in (False, True):
        want = pil_load(buf, salvage)
        if isinstance(want, Exception):
            with pytest.raises(OSError):
                jpegdec.decode_rgb(buf, salvage)
            continue
        np.testing.assert_array_equal(jpegdec.decode_rgb(buf, salvage), want)


def _jpeg_forms():
    forms = {}
    for space, c in (("ycc", 3), ("gray", 1), ("rgb", 3), ("cmyk", 4),
                     ("ycck", 4)):
        for arith in (False, True):
            for prog in (False, True):
                for samp in ((1, 1), (2, 2), (2, 1)):
                    if c == 1 and samp != (1, 1):
                        continue
                    if not arith and space not in ("cmyk", "ycck"):
                        continue  # Huffman grey/colour: test_torch_jpegdec
                    for rst in (0, 3):
                        name = (f"{space} {'arith' if arith else 'huff'} "
                                f"{'prog' if prog else 'seq'} "
                                f"{samp[0]}x{samp[1]} rst{rst}")
                        forms[name] = (space, c, arith, prog, samp, rst)
    return forms


JPEG_FORMS = _jpeg_forms()


@pytest.mark.parametrize("form", sorted(JPEG_FORMS))
def test_jpeg_forms_decode_as_pillow(form, tmp_path):
    space, c, arith, prog, samp, rst = JPEG_FORMS[form]
    img = scene(H + 27, W + 43, 4)[..., :c]
    if c == 1:
        img = img[..., 0]
    path = str(tmp_path / "a.jpg")
    write_libjpeg(path, img, space, arith, prog, 90, rst, samp)
    buf = open(path, "rb").read()
    check_jpeg(buf)
    for cut in (len(buf) // 2, len(buf) - 7):
        check_jpeg(buf[:cut])
    check_readers(path)


def test_cmyk_jpeg_without_adobe_marker_and_pillow_cmyk(tmp_path):
    path = str(tmp_path / "a.jpg")
    write_libjpeg(path, scene(40, 40, 4), "cmyk", adobe=False)
    check_jpeg(open(path, "rb").read())
    check_readers(path)
    pil = _write(tmp_path, "p.jpg", _pil_bytes(
        Image.fromarray(scene(40, 56, 4), "CMYK"), "JPEG", quality=85))
    assert Image.open(pil).mode == "CMYK"
    check_readers(pil)


def test_cmyk_jpeg_with_cmyk_profile_keeps_the_image(tmp_path):
    """A CMYK profile meets the RGB image in LittleCMS: the reference's
    conversion raises and leaves the image, as the port's `lcms.Refused`
    does."""
    icc = _icc_cmyk()
    pil = _write(tmp_path, "p.jpg", _pil_bytes(
        Image.fromarray(scene(40, 56, 4), "CMYK"), "JPEG", quality=85,
        icc_profile=icc))
    assert Image.open(pil).info.get("icc_profile") == icc
    check_readers(pil)


def _icc_cmyk():
    g = chip_smoke._icc_bytes([(b"A2B0", b"mft2" + bytes(200))])
    return g[:12] + b"prtr" + b"CMYK" + g[20:]


@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("pt", [0, 3])
@pytest.mark.parametrize("comps", [1, 3])
def test_lossless_jpeg_decodes_as_pillow(psv, pt, comps, tmp_path):
    img = scene(H, W, 3)
    if comps == 1:
        img = img[..., 0]
    path = write_lossless(str(tmp_path / "a.jpg"), img, psv, pt)
    buf = open(path, "rb").read()
    check_jpeg(buf)
    check_jpeg(buf[: len(buf) * 2 // 3])
    check_readers(path)


def test_lossless_jpeg_restarts_and_ids(tmp_path):
    img = scene(H, W, 3)
    for kw in ({"restart_rows": 5}, {"ids": [82, 71, 66]},
               {"restart_rows": 1, "ids": [1, 2, 3]}):
        path = write_lossless(str(tmp_path / "a.jpg"), img, 4, 1, **kw)
        check_jpeg(open(path, "rb").read())


def test_arithmetic_jpeg_past_the_first_chunk_fails_as_pillow(tmp_path):
    """The arithmetic decoder cannot suspend: a file whose data runs past
    Pillow's first 64 KiB fails in the strict load, and the salvage load
    keeps the scanlines output before (a single-scan file) or none."""
    img = np.random.default_rng(19).integers(0, 256, (300, 300, 3)).astype(np.uint8)
    for prog in (False, True):
        path = str(tmp_path / "big.jpg")
        write_libjpeg(path, img, "ycc", True, prog, 95)
        buf = open(path, "rb").read()
        assert len(buf) > 65536
        assert isinstance(pil_load(buf, False), OSError)
        check_jpeg(buf)


def test_committed_fixtures_hold_their_sha256():
    """The JPEG forms, a GIF of Pillow's own LZW (its codes widen to 12
    bits and clear; interlaced; its colour table moved from the screen to
    the frame), the WebP fixtures (tests/test_torch_webp.py; W1's 24 MP
    lossy file up to 1.5 MB), the raster, plugin, texture and JPEG 2000
    fixtures (tests/util_rasterforms.py::fixtures and its like) decode to
    the sha256 recorded from Pillow, which `chip_smoke.py`'s format phases
    check on the card's machine (the generated F1, G1, Q1 and U1 files
    apart)."""
    with open(os.path.join(DATA, "formats_sha256.json")) as f:
        recorded = json.load(f)
    names = [k for k in recorded
             if not k.startswith(("F1 ", "G1 ", "Q1 ", "U1 "))]
    assert len(names) >= 7
    gif_bytes = open(os.path.join(DATA, "gif_pillow_lzw.gif"), "rb").read()
    assert gif_bytes[10] & 0x80 == 0  # no global table
    assert gif_bytes[13] == 0x2C and gif_bytes[22] & 0xC0 == 0xC0
    for name in names:
        path = os.path.join(DATA, name)
        assert os.path.getsize(path) <= (
            1536 if name == chip_smoke.W1_LOSSY else 64) * 1024
        want = np.asarray(Image.open(path).convert("RGB"))
        assert hashlib.sha256(want.tobytes()).hexdigest() == recorded[name]
        np.testing.assert_array_equal(read_rgb8(path), want)


def test_f1_cmyk_tiff_sha256_is_pillows(tmp_path):
    """The sha256 chip_smoke.py's F1 holds its 24 MP CMYK TIFF to is
    Pillow's convert("RGB") of the same file."""
    with open(os.path.join(DATA, "formats_sha256.json")) as f:
        recorded = json.load(f)
    h, w = chip_smoke.FORMATS_FRAME
    _, _, _, _, cmyk = chip_smoke.formats_arrays(h, w)
    path = chip_smoke.write_tiff_form(str(tmp_path / "c.tif"), cmyk,
                                      photometric=5)
    del cmyk
    want = np.asarray(Image.open(path).convert("RGB"))
    assert hashlib.sha256(want.tobytes()).hexdigest() == \
        recorded["F1 CMYK TIFF"]


# -- files Pillow cannot open, and the formats refused by name ---------------

def test_exr_magic_reaches_its_external_loader(tmp_path, both):
    """OpenEXR's magic bytes: Pillow opens nothing, so the reference hands
    the file to its [ART ImageIO] loader; so does the port."""
    from test_torch_iomanager import _tiff_writer

    iodir, run = both
    conv = _tiff_writer(tmp_path)
    (iodir / "exr.txt").write_text(
        f"[ART ImageIO]\nExtension=exr\nReadCommand={sys.executable} "
        f"{conv}\n")
    src = tmp_path / "a.exr"
    src.write_bytes(b"\x76\x2f\x31\x01" + bytes(3000))
    with pytest.raises(OSError):
        Image.open(str(src))
    with pytest.raises(imagefile.Unidentified):
        read_image(str(src))
    ref = run("ref", lambda: ref_load(str(src)))
    got = run("port", lambda: load_std_image(str(src)))
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    assert got.filename == ref.filename


# port name -> Pillow's format of the plugin that opens it
PIL_FORMAT = {"JPEG 2000": "JPEG2000", "WebP": "WEBP", "McIdas": "MCIDAS",
              "XVThumb": "XVTHUMB", "IPTC/NAA": "IPTC", "PFM": "PPM"}


def _pil_written(fmt, tmp_path):
    mode = {"XBM": "1", "MSP": "1", "SPIDER": "F", "BLP": "P"}.get(fmt,
                                                                  "RGB")
    img = Image.fromarray(scene(16, 16)).convert(mode)
    path = str(tmp_path / "a.img")
    try:
        img.save(path, format=fmt)
    except (OSError, KeyError, ValueError) as e:
        pytest.skip(f"Pillow here cannot write {fmt}: {e}")
    assert Image.open(path).format == fmt
    return path


@pytest.mark.parametrize("fmt", ["AVIF"])
def test_formats_pillow_writes_and_the_port_refuses(fmt, tmp_path):
    """Files Pillow writes in a format the port does not decode: Pillow
    opens them, and the port raises NotImplementedError naming the
    format."""
    path = _pil_written(fmt, tmp_path)
    names = {PIL_FORMAT.get(n, n.upper()): n for n, _, _ in
             unported.FORMATS}
    assert fmt in names
    with pytest.raises(NotImplementedError, match=f"{names[fmt]} image"):
        read_rgb8(path)


@pytest.mark.parametrize("fmt", ["DIB", "TGA", "ICO", "PCX", "SGI", "QOI",
                                 "MSP", "XBM", "IM", "SPIDER", "DDS", "BLP",
                                 "ICNS", "JPEG2000"])
def test_formats_pillow_writes_decode_as_pillow(fmt, tmp_path):
    """Files Pillow writes in the simple raster formats, the small raster
    plugins, the texture and icon formats and JPEG 2000, which the port
    decodes (io/rasterformats.py, io/plugins.py, io/textures.py,
    io/jpeg2000.py): the four readers as Pillow and the reference."""
    path = _pil_written(fmt, tmp_path)
    assert fmt not in {PIL_FORMAT.get(n, n.upper()) for n, _, _ in
                       unported.FORMATS}
    check_readers(path)


# -- the consumers -----------------------------------------------------------------

def test_hald_clut_from_the_new_formats(tmp_path):
    from art_tpu.color.lut3d import load_hald_clut as ref_hald
    from art_tpu_torch.color.lut3d import load_hald_clut

    hald = chip_smoke.hald_image(4, 8)  # 64x64
    files = {"bmp": chip_smoke.write_bmp24(str(tmp_path / "h.bmp"), hald),
             "ppm": chip_smoke.write_pnm(str(tmp_path / "h.ppm"), hald),
             "tif": chip_smoke.write_tiff_form(str(tmp_path / "h.tif"), hald,
                                               planar=True, big=True)}
    for kind, path in files.items():
        np.testing.assert_array_equal(load_hald_clut(path), ref_hald(path))


def test_external_mask_from_the_new_formats(tmp_path):
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu_torch.masks import load_external_mask

    grey16 = chip_smoke.f2_mask(40, 60)
    files = {
        "pgm16": chip_smoke.write_pnm(str(tmp_path / "m.pgm"), grey16,
                                      65535),
        "pgm16 deep": chip_smoke.write_pnm(str(tmp_path / "d.pgm"),
                                           grey16 * 250, 65535),
        "pgm8": chip_smoke.write_pnm(str(tmp_path / "m8.pgm"),
                                     grey16.astype(np.uint8)),
        "bmp": chip_smoke.write_bmp24(str(tmp_path / "m.bmp"), np.repeat(
            grey16.astype(np.uint8)[..., None], 3, 2)),
        "gif": _write(tmp_path, "m.gif", gif(grey16.astype(np.uint8)))}
    for kind, path in files.items():
        for inverted in (False, True):
            want = ref_mask(path, 48, 72, inverted)
            got = load_external_mask(path, 48, 72, inverted)
            np.testing.assert_array_equal(got, want, err_msg=kind)


def test_psf_image_from_the_new_formats(tmp_path):
    from art_tpu.ops.sharpen import load_psf_kernel as ref_psf
    from art_tpu_torch.ops.sharpen import load_psf_kernel

    yy, xx = np.mgrid[-4:5, -4:5]
    k = np.round(255 * np.exp(-(xx ** 2 + yy ** 2) / 6.0)).astype(np.uint8)
    rgb = np.repeat(k[..., None], 3, 2)
    for path in (chip_smoke.write_bmp24(str(tmp_path / "k.bmp"), rgb),
                 chip_smoke.write_pnm(str(tmp_path / "k.ppm"), rgb),
                 _write(tmp_path, "k.gif", gif(k))):
        for scale in (1.0, 2.0):
            want, got = ref_psf(path, scale), load_psf_kernel(path, scale)
            assert (want is None) == (got is None)
            np.testing.assert_array_equal(got, want)


def test_load_image_of_the_new_formats(tmp_path):
    import art_tpu
    import art_tpu_torch

    path = chip_smoke.write_bmp24(str(tmp_path / "a.bmp"), scene(24, 40))
    ref, got = art_tpu.load_image(path), art_tpu_torch.load_image(path)
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    assert got.filename == ref.filename
