"""Minimal ICC v2 display-profile writer (matrix + TRC; a copy of
``art_tpu/color/iccwrite.py``).

Reference: ART ships .icc files and builds output profiles in
rtengine/iccstore.cc; here the store *generates* the profile bytes for
any of the known output spaces so saved images carry correct color
tags without bundling binary profiles.

Layout: 128-byte header, tag table, then desc/wtpt/rXYZ/gXYZ/bXYZ/
rTRC/gTRC/bTRC/cprt. Primaries are Bradford-adapted to the D50 PCS as
the spec requires; TRCs are 1024-entry 'curv' tables sampled from the
space's transfer function.
"""

from __future__ import annotations

import struct

import numpy as np

from art_tpu_torch.color import colorspaces as cs

_D50 = np.array([0.9642, 1.0, 0.8249])
_BRAD = np.array([[0.8951, 0.2664, -0.1614],
                  [-0.7502, 1.7135, 0.0367],
                  [0.0389, -0.0685, 1.0296]])


def _s15f16(x):
    return struct.pack(">i", int(round(x * 65536.0)))


def _xyz_tag(v):
    return b"XYZ \0\0\0\0" + b"".join(_s15f16(c) for c in v)


def _curv_tag(samples):
    arr = np.clip(np.asarray(samples), 0.0, 1.0)
    pts = (arr * 65535.0 + 0.5).astype(">u2")
    return (b"curv\0\0\0\0" + struct.pack(">I", len(pts)) + pts.tobytes())


def _desc_tag(text):
    # ICC v2 textDescription
    data = text.encode("ascii", "replace") + b"\0"
    return (b"desc\0\0\0\0" + struct.pack(">I", len(data)) + data
            + b"\0" * 4 + b"\0"  # unicode code+count, scriptcode
            + b"\0" * 2 + b"\0" * 67)


def _text_tag(text):
    return b"text\0\0\0\0" + text.encode("ascii", "replace") + b"\0"


def _trc_samples(name, n=1024):
    x = np.linspace(0.0, 1.0, n)
    if name == "sRGB":
        return np.where(x <= 0.04045, x / 12.92,
                        ((x + 0.055) / 1.055) ** 2.4)
    if name in ("AdobeRGB", "Adobe RGB"):
        return x ** (563.0 / 256.0)
    if name == "ProPhoto":
        return np.where(x < 16.0 * (1.0 / 512.0), x / 16.0, x ** 1.8)
    if name == "Rec2020":
        b = 0.0181
        a = 1.0993
        return np.where(x < 4.5 * b, x / 4.5, ((x + a - 1.0) / a) ** (1 / 0.45))
    return x  # linear


def make_icc(profile_name, description=None):
    """ICC bytes for a known RGB space (matrix + TRC display profile)."""
    if profile_name not in cs.MATRICES_RGB_TO_XYZ:
        return None
    rgb2xyz = np.asarray(cs.MATRICES_RGB_TO_XYZ[profile_name], np.float64)
    # Bradford-adapt primaries from the space's white to D50 PCS
    white = rgb2xyz @ np.ones(3)
    w1 = _BRAD @ (white / white[1])
    w2 = _BRAD @ _D50
    adapt = np.linalg.inv(_BRAD) @ np.diag(w2 / w1) @ _BRAD
    m = adapt @ rgb2xyz

    trc = _curv_tag(_trc_samples(profile_name))
    tags = [
        (b"desc", _desc_tag(description or f"art-tpu {profile_name}")),
        (b"wtpt", _xyz_tag(_D50)),
        (b"rXYZ", _xyz_tag(m[:, 0])),
        (b"gXYZ", _xyz_tag(m[:, 1])),
        (b"bXYZ", _xyz_tag(m[:, 2])),
        (b"rTRC", trc),
        (b"gTRC", trc),
        (b"bTRC", trc),
        (b"cprt", _text_tag("no copyright, use freely")),
    ]

    tag_table = struct.pack(">I", len(tags))
    offset = 128 + 4 + 12 * len(tags)
    body = b""
    for sig, data in tags:
        pad = (-len(data)) % 4
        tag_table += sig + struct.pack(">II", offset + len(body), len(data))
        body += data + b"\0" * pad

    size = 128 + 4 + 12 * len(tags) + len(body)
    header = struct.pack(
        ">I4sI4s4s4s12s4s4sIII4sQI12s",
        size, b"atpu", 0x02400000, b"mntr", b"RGB ", b"XYZ ",
        b"\x07\xe6\x00\x01\x00\x01" + b"\0" * 6,  # date
        b"acsp", b"APPL", 0, 0, 0, b"\0\0\0\0", 0, 0, b"\0" * 12)
    # PCS illuminant (D50) at header offset 68
    header = (header[:68]
              + _s15f16(_D50[0]) + _s15f16(_D50[1]) + _s15f16(_D50[2])
              + header[80:])
    header = header + b"\0" * (128 - len(header))
    return header[:128] + tag_table + body
