"""Files of the small raster plugins Pillow 12.1.0 opens (FITS, PFM, the
PNM extensions, SPIDER, McIdas, IMT, IM, SUN, MSP, XVThumb, PIXAR, GBR,
XBM, XPM, FTEX, IPTC/NAA, PCD, FLI), built byte by byte in each form its
plugin maps, for the tests against Pillow (FITS, PFM, SPIDER, McIdas,
SUN, PIXAR and PCD files by `chip_smoke.py`'s writers, which also write
its G1 files). `FORMS` names each form;
`fixtures()` writes the small files committed in tests/data (their
Pillow decodes' sha256 in formats_sha256.json)."""

import gzip
import struct

import numpy as np

from chip_smoke import (_fits_card as _card, fits_bytes as fits,
                        mcidas_bytes as mcidas, pcd_bytes as pcd,
                        pfm_bytes as pfm, pixar_bytes as pixar,
                        spider_bytes as spider, sun_bytes as sun,
                        sun_rle_bytes as sun_rle)
from util_rasterforms import picture


def fits_gzip(arr, zbitpix, table=(8, 1)):
    """A GZIP_1 tile-compressed FITS: an empty primary HDU, then a binary
    table whose heap holds the gzip of the image's 4-byte words (the
    samples big-endian in the words' last bytes), first row at the
    bottom."""
    h, w = arr.shape
    prim = b"".join([_card("SIMPLE", "T"), _card("BITPIX", 8),
                     _card("NAXIS", 0), _card("END")])
    prim += b" " * (-len(prim) % 2880)
    cards = [_card("XTENSION", "'BINTABLE'"), _card("BITPIX", 8),
             _card("NAXIS", 2), _card("NAXIS1", table[0]),
             _card("NAXIS2", table[1]), _card("ZIMAGE", "T"),
             _card("ZCMPTYPE", "'GZIP_1  '"), _card("ZBITPIX", zbitpix),
             _card("ZNAXIS", 2), _card("ZNAXIS1", w), _card("ZNAXIS2", h),
             _card("END")]
    head = b"".join(cards)
    head += b" " * (-len(head) % 2880)
    words = np.ascontiguousarray(arr[::-1]).astype(">i4").tobytes()
    return prim + head + bytes(table[0] * table[1]) + gzip.compress(words)


def pnm_ext(magic, arr, maxval=255):
    """A PNM of a Pillow extension (P0CMYK, PyP, PyRGBA, PyCMYK) of
    samples (H, W[, C]) up to maxval."""
    h, w = arr.shape[:2]
    dt = np.uint8 if maxval < 256 else ">u2"
    return (magic + b"\n%d %d\n%d\n" % (w, h, maxval)
            + np.ascontiguousarray(arr).astype(dt).tobytes())


def imt(arr):
    h, w = arr.shape
    return (b"width %d\nheight %d\npixel n8\n* a comment\n\x0c" % (w, h)
            + np.ascontiguousarray(arr, np.uint8).tobytes())


def im(image_type, data, w, h, lut=None, extra=b""):
    """An IM file: the header lines, padded to 512 bytes with its 0x1a,
    the Lut's 768 bytes (planar), then `data` as given."""
    head = (b"Image type: " + image_type + b"\r\nName: t\r\n"
            + b"Image size (x*y): %d*%d\r\n" % (w, h) + extra)
    if lut is not None:
        head += b"Lut: 1\r\n"
    head = head.ljust(511, b"\0") + b"\x1a"
    return head + (b"" if lut is None else bytes(lut)) + bytes(data)


def msp2(bits, w, h):
    """A Windows Paint v2 file of (H, ceil(W/8)) packed rows: each row's
    runs and literals, a row of 0xFF stored empty."""
    rows = []
    for r in bits:
        r = bytes(r)
        if r == b"\xff" * len(r):
            rows.append(b"")
            continue
        out = bytearray()
        i = 0
        while i < len(r):
            n = 1
            while i + n < len(r) and r[i + n] == r[i] and n < 255:
                n += 1
            if n >= 3:
                out += bytes([0, n, r[i]])
                i += n
            else:
                k = min(len(r) - i, 5)
                out += bytes([k]) + r[i : i + k]
                i += k
        rows.append(bytes(out))
    head = bytearray(struct.pack("<4sHHHHHHHHHHH", b"LinS", w, h, w, h, 0,
                                 0, 0, 0, 0, 0, 0))
    head = bytearray(head.ljust(32, b"\0"))
    check = 0
    for i in range(0, 30, 2):
        check ^= struct.unpack_from("<H", head, i)[0]
    struct.pack_into("<H", head, 30, check)
    return bytes(head) + struct.pack(f"<{h}H", *map(len, rows)) + \
        b"".join(rows)


def xvthumb(idx):
    h, w = idx.shape
    return b"P7 332\n#XVVERSION:\n#END_OF_COMMENTS\n%d %d 255\n" % (w, h) + \
        np.ascontiguousarray(idx, np.uint8).tobytes()


def gbr(arr, version=2, comment=b"brush"):
    h, w = arr.shape[:2]
    depth = 1 if arr.ndim == 2 else 4
    name = comment + b"\0"
    if version == 1:
        head = struct.pack(">5I", 20 + len(name), 1, w, h, depth) + name
    else:
        head = struct.pack(">5I", 28 + len(name), 2, w, h, depth) + \
            b"GIMP" + struct.pack(">I", 25) + name
    return head + np.ascontiguousarray(arr, np.uint8).tobytes()


def xbm(bits, hot=None):
    """An X11 bitmap of (H, W) 0/1, bits LSB first, hex bytes."""
    h, w = bits.shape
    packed = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
    s = b"#define im_width %d\n#define im_height %d\n" % (w, h)
    if hot:
        s += b"#define im_x_hot %d\n#define im_y_hot %d\n" % hot
    s += b"static char im_bits[] = {\n"
    s += b",".join(b"0x%02x" % v for v in packed.reshape(-1)) + b"\n};\n"
    return s


def xpm(idx, colours, bpp=1, none_key=None, pixels_comment=True):
    """An XPM of (H, W) indices into `colours` ((n, 3) uint8); keys of
    `bpp` characters; `none_key` adds a colour "None" that no pixel
    uses."""
    h, w = idx.shape
    alphabet = [chr(c) for c in range(35, 127) if chr(c) not in '"\\']
    keys = []
    for i in range(len(colours)):
        k, n = "", i
        for _ in range(bpp):
            k = alphabet[n % len(alphabet)] + k
            n //= len(alphabet)
        keys.append(k)
    lines = [f'"{w} {h} {len(colours) + (none_key is not None)} {bpp}",']
    for k, c in zip(keys, np.asarray(colours)):
        lines.append(f'"{k} c #{c[0]:02x}{c[1]:02x}{c[2]:02x}",')
    if none_key is not None:
        lines.append(f'"{none_key} c None",')
    if pixels_comment:
        lines.append("/* pixels */")
    for row in idx:
        lines.append('"' + "".join(keys[i] for i in row) + '",')
    return ("/* XPM */\nstatic char *t[] = {\n" + "\n".join(lines)
            + "\n};\n").encode()


def ftex(w, h, fmt, data):
    return (b"FTEX" + struct.pack("<i2i2i2i", 1, w, h, 1, 1, fmt, 32)
            + struct.pack("<i", len(data)) + bytes(data))


def bc1_blocks(w, h, seed=0):
    """Random BC1 blocks for (H, W), both colour orders among them."""
    rng = np.random.default_rng(seed)
    n = ((w + 3) // 4) * ((h + 3) // 4)
    blocks = rng.integers(0, 256, (n, 8)).astype(np.uint8)
    blocks[::3, 0:2] = blocks[::3, 2:4]  # c0 == c1: the 3-colour form
    return blocks.tobytes()


def iptc(arr, layers=1, component=0, band=None, compression=1,
         chunks=1):
    """An IPTC/NAA file: the 3:60 (layers, component), size, 3:120
    compression and optional 3:65 band records, then the image in
    `chunks` 8:10 records."""
    def field(rec, ds, data):
        return bytes([0x1C, rec, ds]) + struct.pack(">H", len(data)) + data
    h, w = arr.shape
    out = field(3, 60, bytes([layers, component])) + \
        field(3, 20, struct.pack(">H", w)) + \
        field(3, 30, struct.pack(">H", h)) + \
        field(3, 120, bytes([compression]))
    if band is not None:
        out += field(3, 65, bytes([band]))
    data = np.ascontiguousarray(arr, np.uint8).tobytes()
    step = -(-len(data) // chunks)
    for i in range(0, len(data), step):
        out += field(8, 10, data[i : i + step])
    return out


def iptc_jpeg(data, w, h, layers=3, band=None, chunks=2):
    """An IPTC/NAA file whose 8:10 records hold the image `data` (a JPEG,
    say) under compression 5, for an image of `layers` layers (1: L)
    naming `band` (3:65) where given."""
    def field(rec, ds, body):
        return bytes([0x1C, rec, ds]) + struct.pack(">H", len(body)) + body
    out = field(3, 60, bytes([layers, int(layers > 1)])) + \
        field(3, 20, struct.pack(">H", w)) + \
        field(3, 30, struct.pack(">H", h)) + field(3, 120, bytes([5]))
    if band is not None:
        out += field(3, 65, bytes([band]))
    step = -(-len(data) // chunks)
    for i in range(0, len(data), step):
        out += field(8, 10, data[i : i + step])
    return out


def _chunk(kind, payload):
    return struct.pack("<IH", 6 + len(payload), kind) + payload


def fli_colour(palette, kind=11):
    """A COLOR chunk (11: 64 levels, 4: 256) of (n, 3) entries at 0."""
    pal = np.asarray(palette, np.uint8)
    n = len(pal)
    return _chunk(kind, struct.pack("<HBB", 1, 0, n % 256)
                  + pal.tobytes())


def fli_brun(idx):
    """BRUN of (H, W) indices: runs of a byte as (count, v), literals as
    (-count, bytes)."""
    out = bytearray()
    for row in idx:
        out.append(0)
        r = bytes(row)
        i = 0
        while i < len(r):
            n = 1
            while i + n < len(r) and r[i + n] == r[i] and n < 127:
                n += 1
            if n >= 2:
                out += bytes([n, r[i]])
                i += n
            else:
                k = min(len(r) - i, 120)
                out += bytes([(256 - k) & 255]) + r[i : i + k]
                i += k
    return _chunk(15, bytes(out))


def fli_copy(idx):
    return _chunk(16, np.ascontiguousarray(idx, np.uint8).tobytes())


def fli_black():
    return _chunk(13, b"")


def fli_lc(idx, y0, rows):
    """LC of rows y0..y0+rows-1: each row one literal packet over a skip
    of 1 pixel."""
    out = bytearray(struct.pack("<HH", y0, rows))
    for row in idx[y0 : y0 + rows]:
        r = bytes(row[1:])
        out += bytes([1, 1, len(r)]) + r
    return _chunk(12, bytes(out))


def fli_ss2(idx, rows, skip=0):
    """SS2 (word delta) of the first `rows` rows, after skipping `skip`
    lines: one literal packet of the row's words, the odd width's last
    byte as a flag word."""
    h, w = idx.shape
    out = bytearray(struct.pack("<H", rows))
    for k in range(rows):
        row = bytes(idx[k + skip])
        words = w // 2
        if k == 0 and skip:
            out += struct.pack("<H", (65536 - skip) & 0xFFFF)
        if w % 2:
            out += struct.pack("<H", 0x8000 | row[-1])
        out += struct.pack("<H", 1) + bytes([0, words]) + row[: 2 * words]
    return _chunk(7, bytes(out))


def fli(w, h, chunks, magic=0xAF12, frames=1):
    """An FLI/FLC of one frame holding `chunks`."""
    frame = b"".join(chunks)
    frame = struct.pack("<IHH8x", 16 + len(frame), 0xF1FA, len(chunks)) + \
        frame
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(frame), magic, frames,
                     w, h, 8, 0, 5)
    return bytes(head) + frame


# -- the forms ---------------------------------------------------------------

H, W = 13, 21
_G = picture(H, W, 1, seed=11)[..., 0]
_RGB = picture(H, W, 3, seed=12)
_RGBA = picture(H, W, 4, seed=13)
_RNG = np.random.default_rng(14)
_U16 = _RNG.integers(0, 65536, (H, W)).astype(np.uint16)
_I32 = _RNG.integers(-2 ** 31, 2 ** 31, (H, W)).astype(np.int32)
_F32 = (_RNG.standard_normal((H, W)) * 80 + 100).astype(np.float32)
_F64 = (_RNG.standard_normal((H, W)) * 80 + 100)
_IDX = _RNG.integers(0, 256, (H, W)).astype(np.uint8)
_PAL = _RNG.integers(0, 256, (256, 3)).astype(np.uint8)


def _packed(vals, bits, w):
    """(H, W) values of `bits` bits packed MSB first into rows padded to
    a byte."""
    h = vals.shape[0]
    u = np.unpackbits(vals.astype(np.uint8)[..., None], axis=2)[..., 8 - bits:]
    return np.packbits(u.reshape(h, -1), axis=1)


def _im_forms():
    g, rgb, rgba = _G, _RGB, _RGBA
    f = {}
    f["IM greyscale"] = im(b"Greyscale image", g[::-1].tobytes(), W, H)
    f["IM 1"] = im(b"0 1 image", _packed(g > 128, 1, W)[::-1].tobytes(), W, H)
    f["IM RGB;L"] = im(b"RGB image", np.concatenate(
        [rgb[..., k] for k in range(3)], 1)[::-1].tobytes(), W, H)
    f["IM RGB;T"] = im(b"RGB3 image", np.concatenate(
        [rgb[::-1, :, k].reshape(-1) for k in (1, 0, 2)]).tobytes(), W, H)
    f["IM X 24"] = im(b"X 24 image", rgb[::-1].tobytes(), W, H)
    f["IM RGBA;L"] = im(b"RGBA image", np.concatenate(
        [rgba[..., k] for k in range(4)], 1)[::-1].tobytes(), W, H)
    f["IM RGBX;L"] = im(b"RGBX image", np.concatenate(
        [rgba[..., k] for k in range(4)], 1)[::-1].tobytes(), W, H)
    f["IM CMYK;L"] = im(b"CMYK image", np.concatenate(
        [rgba[..., k] for k in range(4)], 1)[::-1].tobytes(), W, H)
    f["IM YCC"] = im(b"YCC image", np.concatenate(
        [rgb[..., k] for k in range(3)], 1)[::-1].tobytes(), W, H)
    f["IM LA;L"] = im(b"LA image", np.concatenate(
        [rgba[..., 0], rgba[..., 3]], 1)[::-1].tobytes(), W, H)
    f["IM PA;L with a Lut"] = im(b"PA image", np.concatenate(
        [_IDX, rgba[..., 3]], 1)[::-1].tobytes(), W, H,
        lut=_PAL.T.reshape(-1))
    f["IM PA;L with no Lut"] = im(b"PA image", np.concatenate(
        [_IDX, rgba[..., 3]], 1)[::-1].tobytes(), W, H)
    f["IM P with a Lut"] = im(b"Greyscale image", _IDX[::-1].tobytes(), W,
                              H, lut=_PAL.T.reshape(-1))
    f["IM L with a grey Lut"] = im(b"Greyscale image", _IDX[::-1].tobytes(),
                                   W, H, lut=np.tile(np.arange(256), 3)[
                                       ::-1].astype(np.uint8))
    f["IM P;2"] = im(b"B2 image", _packed(_IDX % 4, 2, W)[::-1].tobytes(),
                     W, H, lut=_PAL.T.reshape(-1))
    f["IM P;4"] = im(b"B4 image", _packed(_IDX % 16, 4, W)[::-1].tobytes(),
                     W, H, lut=_PAL.T.reshape(-1))
    f["IM P;2 with no Lut"] = im(b"B2 image", _packed(
        _IDX % 4, 2, W)[::-1].tobytes(), W, H)
    f["IM P;4 with no Lut"] = im(b"B4 image", _packed(
        _IDX % 16, 4, W)[::-1].tobytes(), W, H)
    f["IM I;32"] = im(b"L 32 S image", _I32[::-1].astype("<i4").tobytes(),
                      W, H)
    f["IM I;32S"] = im(b"L 32S image", _I32[::-1].astype("<i4").tobytes(),
                       W, H)
    f["IM F;32F"] = im(b"L 32F image", _F32[::-1].astype("<f4").tobytes(),
                       W, H)
    f["IM F;32"] = im(b"L 32 F image", _U16[::-1].astype("<u4").tobytes(),
                      W, H)
    for t, dt in (("8", "u1"), ("8S", "i1"), ("16", "<u2"), ("16S", "<i2")):
        f[f"IM F;{t}"] = im(b"L %s image" % t.encode(),
                            _U16[::-1].astype(dt).tobytes(), W, H)
    for t, dt in (("16", "<u2"), ("16L", "<u2"), ("16B", ">u2")):
        f[f"IM I;{t}"] = im(b"L %s image" % t.encode(),
                            _U16[::-1].astype(dt).tobytes(), W, H)
    for bits in (3, 12, 27):
        rng = np.random.default_rng(bits)
        nbytes = -(-W * bits // 8)
        f[f"IM F;{bits} bits"] = im(
            b"L*%d image" % bits,
            rng.integers(0, 256, nbytes * H).astype(np.uint8).tobytes(),
            W, H)
    f["IM RLB"] = im(b"RLB image", rgb.tobytes(), W, H)
    f["IM of an unknown type"] = im(b"Q image", g.tobytes(), W, H)
    return f


def _sun_forms():
    f = {}
    rng = np.random.default_rng(15)
    for depth in (1, 4, 8, 24, 32):
        stride = ((W * depth + 15) // 16) * 2
        rows = rng.integers(0, 256, stride * H).astype(np.uint8)
        rows[: stride * 2] = 0x80  # runs and literal 0x80s
        for ftype in (1, 2, 3):
            data = sun_rle(rows) if ftype == 2 else rows.tobytes()
            f[f"SUN {depth}-bit type {ftype}"] = sun(data, W, H, depth, ftype)
        if depth in (4, 8):
            f[f"SUN {depth}-bit mapped"] = sun(
                rows.tobytes(), W, H, depth, 1,
                rng.integers(0, 256, 3 * (1 << depth)).astype(np.uint8))
            f[f"SUN {depth}-bit mapped RLE"] = sun(
                sun_rle(rows), W, H, depth, 2,
                rng.integers(0, 256, 3 * 7).astype(np.uint8))
    f["SUN 24-bit with a colour map"] = sun(
        rng.integers(0, 256, 64 * H).astype(np.uint8).tobytes(), W, H, 24, 1,
        bytes(30))
    f["SUN 8-bit with a colour map of 1000 bytes"] = sun(
        rng.integers(0, 256, 22 * H).astype(np.uint8).tobytes(), W, H, 8, 1,
        bytes(1000))
    f["SUN RLE runs across rows"] = sun(
        b"\x80\xff\x11" * 2 + b"\x80\x00" * 300, W, H, 8, 2)
    return f


def _pnm_forms():
    f = {}
    f["PFM little-endian"] = pfm(_F32, -1.0)
    f["PFM big-endian"] = pfm(_F32, 2.5)
    for magic, arr in ((b"P0CMYK", _RGBA), (b"PyP", _IDX),
                       (b"PyRGBA", _RGBA), (b"PyCMYK", _RGBA)):
        name = magic.decode()
        f[f"PNM {name}"] = pnm_ext(magic, arr)
        f[f"PNM {name} maxval 100"] = pnm_ext(magic, arr // 3, 100)
        f[f"PNM {name} maxval 1000"] = pnm_ext(
            magic, arr.astype(np.uint16) * 3, 1000)
    return f


def _forms():
    f = {}
    for bitpix, arr in ((8, _G), (16, _U16.astype(np.int64) - 32768),
                        (32, _I32), (-32, _F32), (-64, _F64)):
        f[f"FITS BITPIX {bitpix}"] = fits(arr, bitpix)
    for zbitpix, arr in ((8, _G), (16, _U16.astype(np.int64) - 32768),
                         (32, _I32), (-32, _I32)):
        f[f"FITS GZIP_1 ZBITPIX {zbitpix}"] = fits_gzip(arr, zbitpix)
    f["FITS one axis"] = (lambda d: d.replace(
        b"NAXIS   =                    2", b"NAXIS   =                    1"))(
        fits(_G, 8))
    f.update(_pnm_forms())
    f["SPIDER little-endian"] = spider(_F32)
    f["SPIDER big-endian"] = spider(_F32, big=True)
    f["McIdas L"] = mcidas(_G, 1, prefix=4)
    f["McIdas I;16B"] = mcidas(_U16, 2, prefix=2)
    f["McIdas I;32B"] = mcidas(_I32, 4, offset=300)
    f["IMT"] = imt(_G)
    f.update(_im_forms())
    f.update(_sun_forms())
    f["MSP v1"] = chip_smoke_msp1(_G > 100)
    f["MSP v2"] = msp2(np.packbits(np.where(
        np.arange(W)[None, :] < 8, 1, _G > 100).astype(np.uint8), axis=1),
        W, H)
    f["XVThumb"] = xvthumb(_IDX)
    f["PIXAR"] = pixar(_RGB)
    f["GBR v1 L"] = gbr(_G, 1)
    f["GBR v2 L"] = gbr(_G, 2)
    f["GBR v2 RGBA"] = gbr(_RGBA, 2)
    f["XBM"] = xbm(_G > 120)
    f["XBM with a hot spot"] = xbm(_G > 60, hot=(3, 4))
    cols = np.random.default_rng(16).integers(0, 256, (40, 3))
    f["XPM P"] = xpm(_IDX % 40, cols)
    f["XPM P, two-character keys, None"] = xpm(_IDX % 40, cols, bpp=2,
                                                none_key="  ")
    many = np.random.default_rng(17).integers(0, 256, (300, 3))
    f["XPM RGB (300 colours)"] = xpm(
        (np.arange(H * W).reshape(H, W) * 7) % 300, many, bpp=2)
    f["FTEX RGB"] = ftex(W, H, 1, _RGB.tobytes())
    f["FTEX BC1"] = ftex(W, H, 0, bc1_blocks(W, H))
    f["FTEX BC1 4x4"] = ftex(8, 12, 0, bc1_blocks(8, 12, 1))
    f["IPTC L"] = iptc(_G)
    f["IPTC L in two records"] = iptc(_G, chunks=2)
    f["IPTC RGB band 2"] = iptc(_G, 3, 1, band=2)
    f["IPTC RGB no band"] = iptc(_G, 3, 1)
    f["IPTC CMYK band 4"] = iptc(_G, 4, 1, band=4)
    for o in (0, 1, 3):
        f[f"PCD orientation {o}"] = pcd(o, seed=o)
    pal = np.random.default_rng(18).integers(0, 64, (256, 3))
    f["FLI BRUN, 64 levels"] = fli(W, H, [fli_colour(pal), fli_brun(_IDX)])
    f["FLI COPY, 256 levels"] = fli(W, H, [fli_colour(pal * 4, 4),
                                          fli_copy(_IDX)], magic=0xAF11)
    f["FLI BLACK then LC"] = fli(W, H, [fli_colour(pal), fli_black(),
                                       fli_lc(_IDX, 2, 5)])
    f["FLI SS2"] = fli(W, H, [fli_colour(pal), fli_ss2(_IDX, 6)])
    f["FLI SS2 with a skip"] = fli(W, H, [fli_ss2(_IDX, 4, skip=3)])
    return f


def chip_smoke_msp1(bits):
    """Windows Paint v1 as Pillow writes it (through Pillow)."""
    from util_rasterforms import _pil, pil_bytes

    return pil_bytes(_pil().fromarray((bits * 255).astype(np.uint8))
                     .convert("1"), "MSP")


FORMS = _forms()


def fixtures():
    """name -> bytes of the small plugin files committed in tests/data."""
    pal = np.random.default_rng(19).integers(0, 64, (256, 3))
    idx = picture(30, 40, 1, seed=20)[..., 0]
    return {
        "plugin_fits_gzip16.fits": fits_gzip(
            picture(20, 30, 1, seed=21)[..., 0].astype(np.int64) * 200 - 9000,
            16),
        "plugin_im_ycc.im": FORMS["IM YCC"],
        "plugin_im_f12.im": FORMS["IM F;12 bits"],
        "plugin_sun_mapped_rle.ras": FORMS["SUN 8-bit mapped RLE"],
        "plugin_msp2.msp": FORMS["MSP v2"],
        "plugin_xpm_rgb.xpm": FORMS["XPM RGB (300 colours)"],
        "plugin_ftex_bc1.ftc": ftex(40, 30, 0, bc1_blocks(40, 30, 2)),
        "plugin_iptc_band.iim": FORMS["IPTC RGB band 2"],
        "plugin_fli_brun.fli": fli(40, 30, [fli_colour(pal), fli_brun(idx)]),
        "plugin_gbr_rgba.gbr": FORMS["GBR v2 RGBA"],
        "plugin_xvthumb.xv": FORMS["XVThumb"],
    }

