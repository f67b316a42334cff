"""XMP packets and IPTC-IIM records: parse, serialize, embed (a copy of
``art_tpu/io/xmp.py``, without the readers of embedded segments and the
merge helper, which the export path does not call).

Reference: ``rtengine/metadata.{h,cc}`` (Exiv2Metadata). ART loads the
source file's XMP/IPTC with exiv2, optionally merges an XMP *sidecar*
(``xmpSidecarPath``, metadata.cc:799 — sidecar wins over in-file values,
``do_merge_xmp`` metadata.cc:463), applies the ProcParams Exif/IPTC change
lists, and writes everything into the output container. Here the same
contract is implemented in pure Python: an RDF/XML parser for XMP packets,
an IPTC-IIM (record 2) codec, and JPEG/PNG/TIFF embedding helpers.
"""

from __future__ import annotations

import os
import re
import struct
import xml.etree.ElementTree as ET

# canonical prefix -> namespace URI (the subset ART's merge touches)
NAMESPACES = {
    "x": "adobe:ns:meta/",
    "rdf": "http://www.w3.org/1999/02/22-rdf-syntax-ns#",
    "dc": "http://purl.org/dc/elements/1.1/",
    "xmp": "http://ns.adobe.com/xap/1.0/",
    "xmpRights": "http://ns.adobe.com/xap/1.0/rights/",
    "photoshop": "http://ns.adobe.com/photoshop/1.0/",
    "Iptc4xmpCore": "http://iptc.org/std/Iptc4xmpCore/1.0/xmlns/",
    "aux": "http://ns.adobe.com/exif/1.0/aux/",
    "exif": "http://ns.adobe.com/exif/1.0/",
    "tiff": "http://ns.adobe.com/tiff/1.0/",
    "crs": "http://ns.adobe.com/camera-raw-settings/1.0/",
    "lr": "http://ns.adobe.com/lightroom/1.0/",
    "ART": "us/pixls/ART/",  # registered by Exiv2Metadata::init
}
_URI2PREFIX = {v: k for k, v in NAMESPACES.items()}
_RDF = NAMESPACES["rdf"]


def xmp_sidecar_path(path, style="std"):
    """Sidecar path (metadata.cc:799): STD replaces the extension with
    .xmp; EXT appends .xmp to the full name."""
    if style == "std":
        base, ext = os.path.splitext(path)
        return base + ".xmp"
    return path + ".xmp"


def _prefix_for(uri):
    p = _URI2PREFIX.get(uri)
    if p:
        return p
    # derive something stable for unknown namespaces
    tail = re.sub(r"[^A-Za-z0-9]+", "", uri.rstrip("/#").rsplit("/", 1)[-1])
    return tail or "ns"


def _split_clark(tag):
    if tag.startswith("{"):
        uri, name = tag[1:].split("}", 1)
        return uri, name
    return "", tag


def parse_xmp(data):
    """Parse an XMP packet (bytes or str) into a flat dict.

    Keys are ``Xmp.<prefix>.<name>`` (exiv2-style); values are strings,
    or lists for rdf:Seq/Bag/Alt arrays. Nested structs are flattened
    with ``/``-joined field names. Returns {} on malformed input."""
    if isinstance(data, bytes):
        data = data.decode("utf-8", "replace")
    # strip xpacket PIs if present
    data = data.strip()
    try:
        root = ET.fromstring(data)
    except ET.ParseError:
        return {}
    props = {}

    def visit_value(el):
        # rdf:Seq / rdf:Bag / rdf:Alt child?
        for arr in el:
            uri, name = _split_clark(arr.tag)
            if uri == _RDF and name in ("Seq", "Bag", "Alt"):
                items = []
                for li in arr:
                    luri, lname = _split_clark(li.tag)
                    if luri == _RDF and lname == "li":
                        items.append((li.text or "").strip())
                return items
        if len(el) or el.attrib.get(
                "{%s}parseType" % _RDF) == "Resource":
            # struct: flatten children
            out = {}
            for child in el:
                curi, cname = _split_clark(child.tag)
                v = visit_value(child)
                out[cname] = v
            return out
        return (el.text or "").strip()

    def visit_description(desc):
        for key, val in desc.attrib.items():
            uri, name = _split_clark(key)
            if uri in ("", _RDF, "adobe:ns:meta/"):
                continue
            props[f"Xmp.{_prefix_for(uri)}.{name}"] = val
        for el in desc:
            uri, name = _split_clark(el.tag)
            if uri == _RDF:
                continue
            v = visit_value(el)
            base = f"Xmp.{_prefix_for(uri)}.{name}"
            if isinstance(v, dict):
                for k2, v2 in v.items():
                    props[f"{base}/{k2}"] = v2
            else:
                props[base] = v

    for desc in root.iter("{%s}Description" % _RDF):
        visit_description(desc)
    return props


def read_xmp_sidecar(path, style="std"):
    """XMP properties from the image's sidecar file, {} if none
    (getXmpSidecar, metadata.cc:809)."""
    fn = xmp_sidecar_path(path, style)
    if not os.path.exists(fn):
        return {}
    try:
        with open(fn, "rb") as f:
            return parse_xmp(f.read())
    except OSError:
        return {}


def serialize_xmp(props):
    """Flat property dict -> xpacket bytes for embedding."""
    used = {}
    for key in props:
        parts = key.split(".", 2)
        if len(parts) == 3 and parts[0] == "Xmp":
            pfx = parts[1]
            used[pfx] = NAMESPACES.get(pfx, "ns:%s/" % pfx)
    ns_attrs = "".join(f' xmlns:{p}="{u}"' for p, u in sorted(used.items()))

    def esc(s):
        return (str(s).replace("&", "&amp;").replace("<", "&lt;")
                .replace(">", "&gt;"))

    body = []
    for key, val in sorted(props.items()):
        parts = key.split(".", 2)
        if len(parts) != 3 or parts[0] != "Xmp":
            continue
        name = f"{parts[1]}:{parts[2].split('/', 1)[0]}"
        if "/" in parts[2]:
            continue  # flattened struct fields are not re-emitted
        if isinstance(val, (list, tuple)):
            kind = "Alt" if name == "dc:title" or name == "dc:description" \
                else ("Seq" if name == "dc:creator" else "Bag")
            lis = "".join(
                "<rdf:li%s>%s</rdf:li>" % (
                    ' xml:lang="x-default"' if kind == "Alt" else "",
                    esc(v)) for v in val)
            body.append(f"<{name}><rdf:{kind}>{lis}</rdf:{kind}></{name}>")
        else:
            body.append(f"<{name}>{esc(val)}</{name}>")

    xml = (
        '<?xpacket begin="﻿" id="W5M0MpCehiHzreSzNTczkc9d"?>'
        '<x:xmpmeta xmlns:x="adobe:ns:meta/" x:xmptk="art-tpu">'
        '<rdf:RDF xmlns:rdf="%s">'
        '<rdf:Description rdf:about=""%s>%s</rdf:Description>'
        "</rdf:RDF></x:xmpmeta>"
        '<?xpacket end="w"?>' % (_RDF, ns_attrs, "".join(body))
    )
    return xml.encode("utf-8")


# ---------------------------------------------------------------------------
# IPTC-IIM (record 2 "Application2") encoding
# ---------------------------------------------------------------------------

# exiv2 key -> (record, dataset, repeatable)
IPTC_DATASETS = {
    "Iptc.Application2.ObjectName": (2, 5, False),
    "Iptc.Application2.Category": (2, 15, False),
    "Iptc.Application2.SuppCategory": (2, 20, True),
    "Iptc.Application2.Keywords": (2, 25, True),
    "Iptc.Application2.SpecialInstructions": (2, 40, False),
    "Iptc.Application2.DateCreated": (2, 55, False),
    "Iptc.Application2.Byline": (2, 80, True),
    "Iptc.Application2.BylineTitle": (2, 85, True),
    "Iptc.Application2.City": (2, 90, False),
    "Iptc.Application2.ProvinceState": (2, 95, False),
    "Iptc.Application2.CountryName": (2, 101, False),
    "Iptc.Application2.TransmissionReference": (2, 103, False),
    "Iptc.Application2.Headline": (2, 105, False),
    "Iptc.Application2.Credit": (2, 110, False),
    "Iptc.Application2.Source": (2, 115, False),
    "Iptc.Application2.Copyright": (2, 116, False),
    "Iptc.Application2.Caption": (2, 120, False),
    "Iptc.Application2.Writer": (2, 122, True),
}


def build_iptc_iim(pairs):
    """Encode {exiv2 key: [values]} as an IPTC-IIM byte stream."""
    out = [
        # 1:90 coded character set = UTF-8 (ESC % G)
        b"\x1c\x01\x5a\x00\x03\x1b\x25\x47",
        # 2:00 record version = 4
        b"\x1c\x02\x00\x00\x02\x00\x04",
    ]
    for key in sorted(pairs, key=lambda k: IPTC_DATASETS.get(k, (9, 999))[:2]):
        if key not in IPTC_DATASETS:
            continue
        rec, ds, repeatable = IPTC_DATASETS[key]
        vals = pairs[key]
        if isinstance(vals, str):
            vals = [vals]
        if not repeatable:
            vals = vals[:1]
        for v in vals:
            data = str(v).encode("utf-8")[:2000]
            if not data:
                continue
            out.append(struct.pack(">BBBH", 0x1C, rec, ds, len(data)) + data)
    return b"".join(out)


def build_app13(iptc_iim):
    """Photoshop IRB wrapper (resource 0x0404) for a JPEG APP13 segment."""
    data = iptc_iim + (b"\x00" if len(iptc_iim) & 1 else b"")
    return (b"Photoshop 3.0\x00" + b"8BIM" + struct.pack(">H", 0x0404)
            + b"\x00\x00" + struct.pack(">I", len(iptc_iim)) + data)


# ---------------------------------------------------------------------------
# container embedding
# ---------------------------------------------------------------------------

_XMP_APP1_HEADER = b"http://ns.adobe.com/xap/1.0/\x00"


def insert_jpeg_app_segments(path, exif_bytes=None, icc_bytes=None):
    """Insert APP1-EXIF / APP2-ICC segments into an existing JPEG
    (right after SOI / any APP0), for encoders that emit bare streams
    (the cv2/libjpeg-turbo fast path)."""
    if not exif_bytes and not icc_bytes:
        return True
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] != b"\xff\xd8":
        return False
    pos = 2
    while pos + 4 <= len(buf) and buf[pos] == 0xFF and buf[pos + 1] == 0xE0:
        pos += 2 + struct.unpack_from(">H", buf, pos + 2)[0]
    segs = []
    if exif_bytes:
        payload = exif_bytes if exif_bytes[:4] == b"Exif" \
            else b"Exif\x00\x00" + exif_bytes
        if len(payload) + 2 <= 0xFFFF:
            segs.append(b"\xff\xe1" + struct.pack(">H", len(payload) + 2)
                        + payload)
    if icc_bytes:
        # ICC chunking per the ICC-in-JPEG spec (65519-byte payloads)
        chunk = 0xFFFF - 2 - 14
        parts = [icc_bytes[i : i + chunk]
                 for i in range(0, len(icc_bytes), chunk)]
        for i, part in enumerate(parts):
            payload = (b"ICC_PROFILE\x00"
                       + bytes([i + 1, len(parts)]) + part)
            segs.append(b"\xff\xe2" + struct.pack(">H", len(payload) + 2)
                        + payload)
    with open(path, "wb") as f:
        f.write(buf[:pos] + b"".join(segs) + buf[pos:])
    return True


def insert_jpeg_segments(path, xmp_bytes=None, iptc_iim=None):
    """Insert APP1-XMP / APP13-IPTC segments into an existing JPEG,
    after any leading APP0/APP1 segments."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] != b"\xff\xd8":
        return False
    pos = 2
    while pos + 4 <= len(buf) and buf[pos] == 0xFF and \
            buf[pos + 1] in (0xE0, 0xE1):
        pos += 2 + struct.unpack_from(">H", buf, pos + 2)[0]
    segs = []
    if xmp_bytes:
        payload = _XMP_APP1_HEADER + xmp_bytes
        if len(payload) + 2 <= 0xFFFF:
            segs.append(b"\xff\xe1" + struct.pack(">H", len(payload) + 2)
                        + payload)
    if iptc_iim:
        payload = build_app13(iptc_iim)
        if len(payload) + 2 <= 0xFFFF:
            segs.append(b"\xff\xed" + struct.pack(">H", len(payload) + 2)
                        + payload)
    if not segs:
        return True
    with open(path, "wb") as f:
        f.write(buf[:pos] + b"".join(segs) + buf[pos:])
    return True


# XMP -> EXIF promotions (moveXmpToExif role in do_merge_xmp):
# only what our EXIF builder can carry
XMP_TO_EXIF = {
    "Xmp.xmp.Rating": "rating",
    "Xmp.dc.rights": "copyright",
    "Xmp.dc.creator": "artist",
    "Xmp.dc.description": "image_description",
}


def xmp_exif_overrides(props):
    """EXIF tag-dict overrides derived from XMP values."""
    out = {}
    for xkey, ekey in XMP_TO_EXIF.items():
        v = props.get(xkey)
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            v = "; ".join(str(x) for x in v) if ekey != "artist" \
                else ", ".join(str(x) for x in v)
        if ekey == "rating":
            try:
                v = max(0, min(5, int(float(v))))
            except (TypeError, ValueError):
                continue
        out[ekey] = v
    return out
