"""Files of the simple raster formats that Pillow 12.1.0 opens and cannot
write, or cannot write in a given form, built byte by byte: cursors,
DCX, PSD in every colour mode (raw and PackBits, extra channels, a layer
section, an ICC resource), 16-bit and RLE SGI, colour-mapped TGA, PCX
bit planes and QOI streams of every op. `fixtures()` writes the small
files committed in tests/data (their Pillow decodes' sha256 in
formats_sha256.json)."""

import io
import os
import struct
import tempfile

import numpy as np

import chip_smoke

Image = None


def _pil():
    global Image
    if Image is None:
        from PIL import Image as _Image

        Image = _Image
    return Image


def pil_bytes(img, fmt, **kw):
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


def picture(h, w, c=3, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 5 + y) % 256, (y * 3) % 256, ((x + 2 * y) * 7) % 256,
                     (x * 11 + 40) % 256], -1)[..., :c]
    noise = rng.integers(-10, 11, base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


# -- PSD --------------------------------------------------------------------

def packbits_rows(rows):
    """(byte counts, stream) of rows ((R, n) uint8) in PackBits."""
    data, counts = chip_smoke.rle_rows(rows, 1, 128, chip_smoke._packbits_head,
                                       lambda n: n - 1)
    return counts, data.tobytes()


def layer_section(w, h):
    """A layer and mask section of one RGB layer (its channel data raw)."""
    rec = struct.pack(">4iH", 0, 0, h, w, 3)
    for ch in (0, 1, 2):
        rec += struct.pack(">hI", ch, 2 + w * h)
    rec += b"8BIMnorm" + bytes([255, 0, 1, 0])
    extra = struct.pack(">II", 0, 0) + b"\x05Layer\0\0"
    rec += struct.pack(">I", len(extra)) + extra
    chans = b"".join(struct.pack(">H", 0) + bytes([40 + 30 * c]) * (w * h)
                     for c in range(3))
    info = struct.pack(">h", 1) + rec + chans
    info += b"\0" * (len(info) & 1)
    return struct.pack(">I", len(info)) + info + struct.pack(">I", 0)


def psd(mode, planes, bits=8, comp=0, cmd=b"", icc=None, layers=b"",
        channels=None, resources=b""):
    """A PSD of the planes ((C, H, W) uint8, or for 1 bit (1, H, ceil(W /
    8)) packed): colour mode `mode`, the channel count in the header
    `channels` (the planes' by default), colour mode data `cmd`, image
    resources (`resources`' bytes, then the ICC profile as resource
    1039), the layer section's bytes, raw (comp 0) or PackBits (1)."""
    planes = np.asarray(planes, np.uint8)
    c, h, rb = planes.shape
    w = rb * 8 if bits == 1 else rb
    res = resources
    if icc is not None:
        res += b"8BIM" + struct.pack(">HBxI", 1039, 0, len(icc)) + icc
        res += b"\0" * (len(icc) & 1)
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or c, h, w, bits,
                                mode)
    out += struct.pack(">I", len(cmd)) + cmd
    out += struct.pack(">I", len(res)) + res
    out += layers if layers else struct.pack(">I", 0)
    out += struct.pack(">H", comp)
    if comp == 1:
        counts, data = packbits_rows(planes.reshape(c * h, rb))
        out += counts.astype(">u2").tobytes() + data
    else:
        out += planes.tobytes()
    return out


PSD_MODE_CODES = {"1": 0, "L": 1, "P": 2, "RGB": 3, "CMYK": 4, "LAB": 9,
                  "L multichannel": 7, "L duotone": 8, "L bitmap 8": 0}


def psd_form(name, comp=0, h=11, w=19, seed=0, extra=0, icc=None,
             layers=False):
    """A PSD in the mode `name` (PSD_MODE_CODES; "RGBA" is RGB with four
    channels) with `extra` channels past the mode's."""
    rng = np.random.default_rng(seed)
    cmd = b""
    bits = 8
    if name == "1":
        bits, n = 1, 1
        planes = rng.integers(0, 256, (1, h, (w + 7) // 8))
    else:
        n = {"RGB": 3, "RGBA": 4, "CMYK": 4, "LAB": 3}.get(name, 1)
        planes = np.moveaxis(picture(h, w, 4, seed), -1, 0)
        planes = np.concatenate([planes, planes[::-1]])[: n + extra]
        if name == "P":
            cmd = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
    mode = PSD_MODE_CODES.get(name, 3)
    return psd(mode, planes, bits, comp, cmd, icc,
               layer_section(w, h) if layers else b"")


# -- SGI --------------------------------------------------------------------

def sgi16(img, rle=False):
    """A 16-bit SGI of (H, W) or (H, W, C) uint16: raw planes, or RLE with
    two-byte atoms (a run of one repeated value, else copies of up to
    127), rows bottom-up."""
    img = np.asarray(img, np.uint16)
    if img.ndim == 2:
        img = img[..., None]
    h, w, z = img.shape
    head = bytearray(512)
    struct.pack_into(">HBBHHHH", head, 0, 474, int(rle), 2,
                     2 if z == 1 else 3, w, h, z)
    planes = np.moveaxis(img[::-1], -1, 0)
    if not rle:
        return bytes(head) + planes.astype(">u2").tobytes()
    rows, lengths = [], []
    for row in planes.reshape(z * h, w):
        out = bytearray()
        x = 0
        while x < w:
            n = 1
            while x + n < w and n < 127 and row[x + n] == row[x]:
                n += 1
            if n > 1:
                out += struct.pack(">H", n) + struct.pack(">H", int(row[x]))
            else:
                n = min(127, w - x)
                out += struct.pack(">H", 0x80 | n)
                out += row[x : x + n].astype(">u2").tobytes()
            x += n
        out += b"\0\0"
        rows.append(bytes(out))
        lengths.append(len(out))
    first = 512 + 8 * z * h
    offsets = first + np.cumsum(lengths) - lengths
    return (bytes(head) + offsets.astype(">u4").tobytes()
            + np.asarray(lengths).astype(">u4").tobytes() + b"".join(rows))


def rgb_icc():
    """A matrix/TRC RGB profile (chip_smoke's parametric Rec. 2020)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "p.icc")
        chip_smoke.write_para_icc(path)
        return open(path, "rb").read()


def sgi8_rle(img):
    with tempfile.TemporaryDirectory() as d:
        return open(chip_smoke.write_sgi(os.path.join(d, "a.sgi"), img),
                    "rb").read()


def sgi8_rgba_rle(img):
    """An RLE SGI of (H, W, 4) uint8."""
    h, w, z = img.shape
    rows = np.moveaxis(img[::-1], -1, 0).reshape(z * h, w)
    data, lengths = chip_smoke.rle_rows(rows, 1, 127, lambda c: c,
                                        lambda c: 0x80 | c, tail=b"\0")
    head = bytearray(512)
    struct.pack_into(">HBBHHHH", head, 0, 474, 1, 1, 3, w, h, z)
    offsets = 512 + 8 * z * h + np.cumsum(lengths) - lengths
    return (bytes(head) + offsets.astype(">u4").tobytes()
            + lengths.astype(">u4").tobytes() + data.tobytes())


# -- TGA --------------------------------------------------------------------

def tga_mapped(idx, entries, entry_bits, first=0, rle=False, top=True,
               flip=False):
    """A colour-mapped TGA (type 1, or 9 with `rle`) of (H, W) uint8
    indices, its map of `entries` (bytes of entry_bits / 8 a colour,
    starting at index `first`), rows top-down or bottom-up, flipped
    horizontally with `flip`."""
    h, w = idx.shape
    k = (entry_bits + 7) // 8
    n = len(entries) // k
    head = struct.pack("<BBBHHBHHHHBB", 0, 1, 9 if rle else 1, first, n,
                       entry_bits, 0, 0, w, h, 8,
                       (0x20 if top else 0) | (0x10 if flip else 0))
    rows = idx if top else idx[::-1]
    rows = rows[:, ::-1] if flip else rows
    if rle:
        data, _ = chip_smoke.rle_rows(rows, 1, 128, lambda c: 0x80 | (c - 1),
                                      lambda c: c - 1)
        data = data.tobytes()
    else:
        data = np.ascontiguousarray(rows).tobytes()
    return head + bytes(entries) + data


# -- PCX, DCX ---------------------------------------------------------------

def pcx_planes(idx, planes, palette16, stride=None, bits=1):
    """A PCX of 1-bit planes (2 or 4) of (H, W) indices, the header's 16
    colours, each byte written as itself or a run of one."""
    h, w = idx.shape
    s = (w + 7) // 8
    stride = stride or s + (s & 1)
    lines = np.zeros((h, planes, stride), np.uint8)
    for p in range(planes):
        bitsp = ((idx >> p) & 1).astype(np.uint8)
        lines[:, p, :s] = np.packbits(bitsp, axis=1)
    body = bytearray()
    for v in lines.reshape(-1):
        body += bytes([0xC1, v]) if v >= 0xC0 else bytes([v])
    head = bytearray(128)
    head[:4] = bytes([10, 5, 1, bits])
    struct.pack_into("<4H", head, 4, 0, 0, w - 1, h - 1)
    head[16:64] = bytes(palette16)
    head[65] = planes
    struct.pack_into("<H", head, 66, stride)
    return bytes(head) + bytes(body)


def dcx(*frames):
    offs, at = [], 4 + 4 * (len(frames) + 1)
    for fr in frames:
        offs.append(at)
        at += len(fr)
    return (struct.pack("<I", 987654321)
            + struct.pack(f"<{len(frames) + 1}I", *offs, 0) + b"".join(frames))


# -- ICO, CUR ---------------------------------------------------------------

def icon_dir(kind, icons):
    """An ICO (kind 1) or CUR (2) of (width byte, height byte, colours,
    bpp, payload) entries, the payloads after the directory in order."""
    out = struct.pack("<HHH", 0, kind, len(icons))
    at = 6 + 16 * len(icons)
    body = b""
    for wb, hb, ncol, bpp, payload in icons:
        out += struct.pack("<BBBBHHII", wb, hb, ncol, 0, 1, bpp, len(payload),
                           at)
        at += len(payload)
        body += payload
    return out + body


def dib_icon(img, mode="RGB"):
    """A bitmap icon's payload: Pillow's DIB of `img` over itself (twice
    the rows, as an icon's XOR and AND halves are), and its height."""
    im = _pil().fromarray(np.concatenate([img, img[::-1]]))
    if mode != "RGB":
        im = im.convert(mode)
    return pil_bytes(im, "DIB")


# -- QOI --------------------------------------------------------------------

def qoi_every_op(w=7, h=5):
    """A QOI stream with every op: RGB, RGBA, INDEX (a colour seen and one
    never seen), DIFF, LUMA and RUN (runs past a row's end and past the
    image's), then the end marker."""
    ops = bytearray()
    ops += bytes([0xFE, 10, 20, 30])  # RGB
    ops += bytes([0xFF, 200, 100, 50, 128])  # RGBA
    ops += bytes([0x40 | (3 << 4) | (1 << 2) | 0])  # DIFF +1 -1 -2
    ops += bytes([0x80 | 40, (12 << 4) | 3])  # LUMA dg 8, dr +4, db -5
    h1 = (10 * 3 + 20 * 5 + 30 * 7 + 255 * 11) % 64
    ops += bytes([h1])  # INDEX of the first colour
    ops += bytes([0x00 | ((h1 + 1) % 64)])  # INDEX never set: zeros
    ops += bytes([0xC0 | 9])  # RUN of 10
    ops += bytes([0xFE, 1, 2, 3])
    ops += bytes([0x80 | 0, 0x00])  # LUMA at the low ends
    ops += bytes([0x40 | 0x3F])  # DIFF +1 +1 +1
    ops += bytes([0xC0 | 61])  # RUN of 62: past the image's end
    return (b"qoif" + struct.pack(">IIBB", w, h, 4, 0) + bytes(ops)
            + bytes(7) + b"\x01")


# -- the committed fixtures -------------------------------------------------

def fixtures():
    """name -> bytes of the small files committed in tests/data."""
    pic = picture(24, 24, 3, seed=5)
    png_icon = pil_bytes(_pil().fromarray(picture(32, 32, 4, seed=6), "RGBA"),
                         "PNG")
    bmp_icon = dib_icon(pic, "P")
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 20, (30, 40)).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    pimg = _pil().fromarray(idx, "P")
    pimg.putpalette(pal.reshape(-1).tolist())
    pcx256 = pil_bytes(pimg, "PCX")
    icc = rgb_icc()
    grey16 = (picture(20, 30, 1, seed=9)[..., 0].astype(np.uint16) * 257
              + np.arange(30, dtype=np.uint16)[None, :])
    entries = rng.integers(0, 256, 3 * 40).astype(np.uint8).tobytes()
    return {
        "raster_icon_png_bmp.ico": icon_dir(1, [
            (32, 32, 0, 32, png_icon), (24, 24, 0, 8, bmp_icon)]),
        "raster_cursor.cur": icon_dir(2, [
            (16, 16, 0, 24, dib_icon(picture(16, 16, 3, 1))),
            (24, 24, 0, 24, dib_icon(pic)),
            (20, 32, 0, 24, dib_icon(picture(32, 20, 3, 2)))]),
        "raster_two_frames.dcx": dcx(pcx256, pil_bytes(
            _pil().fromarray(pic), "PCX")),
        "raster_cmyk.psd": psd_form("CMYK", comp=1, h=20, w=33, seed=1,
                                    extra=1),
        "raster_lab.psd": psd_form("LAB", comp=1, h=20, w=33, seed=2),
        "raster_indexed.psd": psd_form("P", h=20, w=33, seed=3),
        "raster_rgb_icc.psd": psd_form("RGB", comp=1, h=20, w=33, seed=4,
                                       icc=icc, layers=True),
        "raster_grey16.sgi": sgi16(grey16, rle=True),
        "raster_mapped_rle.tga": tga_mapped(
            (rng.integers(0, 40, (25, 35)) + 5).astype(np.uint8), entries,
            24, first=5, rle=True, top=False),
        "raster_256.pcx": pcx256,
    }
