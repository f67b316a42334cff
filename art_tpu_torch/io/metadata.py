"""Metadata: EXIF harvest from TIFF/DNG containers, the embedded JPEG
preview's decode, and EXIF emission for outputs (counterparts of
``art_tpu/io/metadata.py``'s ``harvest``, ``_decode_jpeg_resilient``,
``embedded_thumb`` and ``build_exif_bytes``; the preview decodes through
the port's own JPEG decoder, :mod:`art_tpu_torch.io.jpegdec`, as Pillow
would).

Reference: ART tunnels metadata with exiv2 (rtengine/metadata.cc;
MetaDataParams modes tunnel/edit/strip, procparams.h:1560). Here a small
pure-Python TIFF IFD walker harvests the standard tags and previews, and
a minimal EXIF TIFF blob is built for the output's APP1 segment.
"""

from __future__ import annotations

import struct

# tag -> (name, kind) for the tags we tunnel
_IFD0_TAGS = {
    271: "make", 272: "model", 274: "orientation", 306: "datetime",
    305: "software", 315: "artist", 33432: "copyright",
}
_EXIF_TAGS = {
    33434: "exposure_time", 33437: "f_number", 34855: "iso",
    36867: "datetime_original", 37386: "focal_length",
    42036: "lens_model", 42035: "lens_make", 37500: None,  # skip makernote
}

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 9: 4, 10: 8, 11: 4, 12: 8}


def _read_ifd(buf, off, le, big=False, type_size=_TYPE_SIZE):
    """The IFD at `off`: ({tag: (type, count, data offset)}, the next
    IFD's offset). `big`: a BigTIFF IFD (an 8-byte entry count, 20-byte
    entries with 8-byte counts and offsets, values up to 8 bytes
    inline); `type_size`: the bytes of a value of each type."""
    e = "<" if le else ">"
    count, word, head, step, inline = ("Q", "Q", 8, 20, 8) if big else \
        ("H", "I", 2, 12, 4)
    if off + head > len(buf):
        return {}, 0
    n = struct.unpack_from(e + count, buf, off)[0]
    entries = {}
    for i in range(n):
        p = off + head + step * i
        if p + step > len(buf):
            break
        tag, typ, cnt = struct.unpack_from(e + "HH" + word, buf, p)
        size = type_size.get(typ, 1) * cnt
        if size <= inline:
            data_off = p + step - inline
        else:
            data_off = struct.unpack_from(e + word, buf, p + step - inline)[0]
        entries[tag] = (typ, cnt, data_off)
    end = off + head + step * n
    nxt = struct.unpack_from(e + word, buf, end)[0] \
        if end + inline <= len(buf) else 0
    return entries, nxt


_INTS = {3: "H", 4: "I"}  # the integer types read, by their struct codes


def _value(buf, typ, cnt, off, le, ints=_INTS):
    e = "<" if le else ">"
    try:
        if typ == 2:
            raw = buf[off : off + cnt]
            return raw.split(b"\0")[0].decode("ascii", "replace")
        if typ in ints:
            v = struct.unpack_from(e + f"{cnt}{ints[typ]}", buf, off)
        elif typ == 5:
            parts = struct.unpack_from(e + f"{2 * cnt}I", buf, off)
            v = tuple((parts[2 * i], parts[2 * i + 1]) for i in range(cnt))
        elif typ == 10:
            parts = struct.unpack_from(e + f"{2 * cnt}i", buf, off)
            v = tuple((parts[2 * i], parts[2 * i + 1]) for i in range(cnt))
        else:
            return None
        return v[0] if cnt == 1 else v
    except struct.error:
        return None


def harvest(path):
    """Parse a TIFF-container raw (DNG etc.): returns (tags dict,
    preview list [(offset, length)])."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 8 or buf[:2] not in (b"II", b"MM"):
        return {}, []
    le = buf[:2] == b"II"
    e = "<" if le else ">"
    off = struct.unpack_from(e + "I", buf, 4)[0]
    tags = {}
    previews = []
    seen = set()
    queue = [off]
    while queue:
        o = queue.pop()
        if o in seen or o == 0:
            continue
        seen.add(o)
        ents, nxt = _read_ifd(buf, o, le)
        if nxt:
            queue.append(nxt)
        for tag, (typ, cnt, doff) in ents.items():
            if tag in _IFD0_TAGS and _IFD0_TAGS[tag]:
                v = _value(buf, typ, cnt, doff, le)
                if v is not None:
                    tags.setdefault(_IFD0_TAGS[tag], v)
            elif tag in _EXIF_TAGS and _EXIF_TAGS[tag]:
                v = _value(buf, typ, cnt, doff, le)
                if v is not None:
                    tags.setdefault(_EXIF_TAGS[tag], v)
            elif tag in (34665, 330):  # EXIF IFD / SubIFDs
                v = _value(buf, typ, cnt, doff, le)
                for sub in ([v] if isinstance(v, int) else list(v or [])):
                    queue.append(sub)
        # JPEG preview (JPEGInterchangeFormat + length)
        if 513 in ents and 514 in ents:
            po = _value(buf, *ents[513][:2], ents[513][2], le)
            pl = _value(buf, *ents[514][:2], ents[514][2], le)
            if isinstance(po, int) and isinstance(pl, int):
                previews.append((po, pl))
        # new-style preview: strips in a reduced-resolution JPEG IFD
        if (ents.get(254) and _value(buf, *ents[254][:2], ents[254][2], le)
                == 1 and ents.get(259)
                and _value(buf, *ents[259][:2], ents[259][2], le) in (6, 7)
                and 273 in ents and 279 in ents):
            so = _value(buf, *ents[273][:2], ents[273][2], le)
            sl = _value(buf, *ents[279][:2], ents[279][2], le)
            if isinstance(so, int) and isinstance(sl, int):
                previews.append((so, sl))
    return tags, previews


def decode_jpeg_resilient(blob):
    """A (possibly truncated or marker-damaged) JPEG preview as (H, W, 3)
    uint8, or None (``_decode_jpeg_resilient``): Pillow's strict load
    first, then its salvage load under ``LOAD_TRUNCATED_IMAGES``, which
    keeps the scanlines that decoded. None where both fail. A form Pillow
    decodes and the port does not raises NotImplementedError."""
    from art_tpu_torch.io import jpegdec
    from art_tpu_torch.io.stdformats import DecompressionBomb

    for salvage in (False, True):
        try:
            return jpegdec.decode_rgb(blob, salvage=salvage)
        except (OSError, DecompressionBomb):
            pass
    return None


def embedded_thumb(path):
    """The largest embedded JPEG preview (by pixel count) as (3, H, W)
    float32 in [0, 1], or None (``embedded_thumb``): the previews of IFD0's
    JPEGInterchangeFormat and of the reduced-resolution JPEG IFDs that
    `harvest` lists; a span with no EOI marker reads on up to 32 MiB,
    as preview tables sometimes under-report their length."""
    import numpy as np

    try:
        _, previews = harvest(path)
    except OSError:
        return None
    best = None
    for off, length in previews:
        with open(path, "rb") as f:
            f.seek(off)
            blob = f.read(length)
            if blob.startswith(b"\xff\xd8") and b"\xff\xd9" not in blob:
                blob += f.read(32 * 1024 * 1024)
        if not blob.startswith(b"\xff\xd8"):
            continue
        img = decode_jpeg_resilient(blob)
        if img is None:
            continue
        arr = np.moveaxis(img.astype(np.float32) / 255.0, -1, 0)
        if best is None or arr.size > best.size:
            best = arr
    return best


def build_exif_bytes(tags, software="art-tpu 0.1"):
    """EXIF payload (the ``Exif`` header and a TIFF stream) for an APP1
    segment: the IFD0 and Exif sub-IFD tags of the reference's
    ``build_exif_bytes``, packed with the TIFF writer's own IFD code (the
    reference builds it with PIL's ``Image.Exif``)."""
    from art_tpu_torch.io.tiffwrite import (T_ASCII, T_LONG, T_RATIONAL,
                                            T_SHORT, _IFD)

    def add(ifd, tag, typ, v):
        if typ == T_ASCII:
            ifd.add(tag, typ, str(v))
        elif typ == T_RATIONAL and isinstance(v, tuple) and v \
                and isinstance(v[0], tuple):
            ifd.add(tag, typ, list(v))
        else:
            ifd.add(tag, typ, [v])

    ifd0 = _IFD()
    for tag, key, typ in ((271, "make", T_ASCII), (272, "model", T_ASCII),
                          (274, "orientation", T_SHORT),
                          (306, "datetime", T_ASCII),
                          (315, "artist", T_ASCII),
                          (33432, "copyright", T_ASCII),
                          (270, "image_description", T_ASCII),
                          (18246, "rating", T_SHORT)):
        if tags.get(key) is not None:
            add(ifd0, tag, typ, tags[key])
    add(ifd0, 305, T_ASCII, software)
    sub = _IFD()
    for tag, key, typ in ((33434, "exposure_time", T_RATIONAL),
                          (33437, "f_number", T_RATIONAL),
                          (34855, "iso", T_SHORT),
                          (36867, "datetime_original", T_ASCII),
                          (37386, "focal_length", T_RATIONAL),
                          (42036, "lens_model", T_ASCII)):
        v = tags.get(key)
        if v is None:
            continue
        if tag == 34855 and isinstance(v, tuple):
            v = v[0]
        add(sub, tag, typ, v)
    # the sub-IFD's offset is known once IFD0's size is: lay IFD0 out with
    # a placeholder pointer, then again with the offset
    ifd0.add(34665, T_LONG, [0])
    sub_off = 8 + len(ifd0.layout(8))
    ifd0.entries = [(t, ty, c, struct.pack("<I", sub_off) if t == 34665
                     else d) for (t, ty, c, d) in ifd0.entries]
    return (b"Exif\x00\x00" + struct.pack("<2sHI", b"II", 42, 8)
            + ifd0.layout(8) + sub.layout(sub_off))
