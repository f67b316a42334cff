"""The port's model of LittleCMS 2.17 (`art_tpu_torch.color.lcms`, with
its stages in `color/lcms_stages.py` and its ``mpet`` reader in
`color/lcms_mpe.py`) against Pillow 12.1.0's ``ImageCms``, which links
it, on every class of embedded profile LittleCMS links for an RGB image.
The profiles are written here byte by byte.

- Converted forms, bit-equal to Pillow's ``profileToProfile`` on random
  colours, the grey ramp and the 33^3 grid nodes (max 0), and through
  `load_std_image` equal to the reference's frame of the same PNG: a
  float D2B0 (segmented curves of formula and sampled segments, a
  matrix with an offset, a float CLUT; XYZ and Lab; v2 and v4), a D2B0
  beside an A2B0 that disagrees with it, matrix/TRC profiles whose black
  is lifted (black point compensation through a CLUT), the LUT-class
  forms (v2 Lab mft2, mft1, an mAB with all its elements, 4096-entry
  rippled curves), device links to Lab (their CLUT trilinear) and to
  XYZ, an abstract profile on RGB, a colour-space class profile and a
  Lab-space profile whose connection space is RGB.
- Refused forms, where Pillow raises and the port raises `lcms.Refused`,
  so both leave the image unconverted: a link to RGB, an abstract Lab to
  Lab profile, a named-colour profile, an RGB profile whose connection
  space is RGB, a link to CMYK, and D2B0 tags LittleCMS cannot read.
- The float pipeline against LittleCMS unoptimised (``NOOPTIMIZE``),
  bit-equal; which optimiser each form ends in; the D2B0 read before
  the A2B0; and the argument that keeps the joined-curves path out of
  reach (no s15.16 colorants or link matrix join sRGB's to the identity).
"""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest

from art_tpu_torch.color import lcms, lcms_stages
from art_tpu_torch.io.imagefile import read_image
import chip_smoke
from chip_smoke import _icc_bytes, _lattice
from tests.test_torch_stdimage import (
    _lut_inputs, _rippled_mft2, _save, assert_same_frame, lifted_black_icc,
    load_std_image_without_icc, lut_icc_mab, lut_icc_mft1, lut_icc_mft2)

Image = pytest.importorskip("PIL.Image")
ImageCms = pytest.importorskip("PIL.ImageCms")


# -- profile bytes -----------------------------------------------------------

def _f32(vals):
    return b"".join(struct.pack(">f", float(v)) for v in np.ravel(vals))


def _parf(typ, params):
    return b"parf\0\0\0\0" + struct.pack(">HH", typ, 0) + _f32(params)


def _samf(points):
    return b"samf\0\0\0\0" + struct.pack(">I", len(points)) + _f32(points)


def _curf(breaks, segments):
    return (b"curf\0\0\0\0" + struct.pack(">HH", len(segments), 0)
            + _f32(breaks) + b"".join(segments))


def _positioned(head, parts):
    """`head`, then a position table of `parts` (offsets from the start
    of `head`), then the parts, each 4-byte aligned."""
    pos = len(head) + 8 * len(parts)
    table, body = b"", b""
    for p in parts:
        p = p + b"\0" * ((-len(p)) % 4)
        table += struct.pack(">II", pos + len(body), len(p))
        body += p
    return head + table + body


def _cvst(curves):
    n = len(curves)
    return _positioned(b"cvst\0\0\0\0" + struct.pack(">HH", n, n), curves)


def _matf(m, off):
    m = np.asarray(m)
    return (b"matf\0\0\0\0" + struct.pack(">HH", m.shape[1], m.shape[0])
            + _f32(m) + _f32(off))


def _clutf(table):
    """A float CLUT element of a (g, g, g, n_out) table."""
    g, n_out = table.shape[0], table.shape[-1]
    return (b"clut\0\0\0\0" + struct.pack(">HH", 3, n_out)
            + bytes([g] * 3 + [0] * 13) + _f32(table))


def _mpet(elements, n_in=3, n_out=3):
    return _positioned(b"mpet\0\0\0\0" + struct.pack(">HHI", n_in, n_out,
                                                    len(elements)), elements)


def _header(icc, cls=None, space=None, pcs=None):
    b = bytearray(icc)
    for at, v in ((12, cls), (16, space), (20, pcs)):
        if v is not None:
            b[at : at + 4] = v
    return bytes(b)


def _tag_of(icc, typ):
    """The first tag of type `typ` in `icc`, to its end."""
    return icc[icc.index(typ):]


def d2b0_curves():
    """Three segmented curves: a formula segment up to 0 (the line), a
    sampled one over (0, 0.5] (x^2.2 in 24 steps), and above 0.5 a
    formula of each type: a power, a logarithm, an exponential."""
    xs = np.linspace(0.0, 0.5, 25)[1:]
    low = _parf(0, (1.0, 1.0, 0.0, 0.0))
    mid = _samf(xs ** 2.2)
    top = [_parf(0, (2.2, 1.0, 0.0, 0.0)),
           _parf(1, (1.0, 3.014, 9.0, 1.0, -2.014)),
           _parf(2, (0.11443, 10.0, 1.0, 0.0, -0.1443))]
    return [_curf((0.0, 0.5), [low, mid, t]) for t in top]


def d2b0_elements(pcs=b"XYZ "):
    """The D2B0's elements: the curves, a 3x3 matrix with an offset, a
    5^3 float CLUT to the float PCS (XYZ with 8% more saturation, or
    Lab as L 0..100, a and b around 0)."""
    from art_tpu_torch.color import colorspaces as ccs

    lat = _lattice(5)
    m = ccs.MATRICES_RGB_TO_XYZ["sRGB"].T
    if pcs == b"XYZ ":
        y = lat.mean(axis=-1, keepdims=True)
        table = np.clip(y + 1.08 * (lat - y), 0.0, 1.0) @ m
    else:
        f = np.cbrt(np.maximum(lat @ m / np.array([0.9642, 1.0, 0.8249]),
                               216 / 24389.0))
        table = np.stack([116 * f[..., 1] - 16, 500 * (f[..., 0] - f[..., 1]),
                          200 * (f[..., 1] - f[..., 2])], -1)
    return [_cvst(d2b0_curves()),
            _matf(np.eye(3) * 0.98, (0.004, 0.003, 0.002)), _clutf(table)]


def d2b0_icc(version=4, pcs=b"XYZ ", a2b0=None, elements=None):
    tags = [(b"D2B0", _mpet(elements or d2b0_elements(pcs)))]
    if a2b0 is not None:
        tags.append((b"A2B0", a2b0))
    return _icc_bytes(tags, pcs=pcs, version=version)


def named_colour_icc():
    """A named-colour profile of one colour (``ncl2``)."""
    name = b"red".ljust(32, b"\0")
    tag = (b"ncl2\0\0\0\0" + struct.pack(">III", 0, 1, 3) + b"\0" * 64
           + name + struct.pack(">3H", 0x8000, 0xC000, 0xC000)
           + struct.pack(">3H", 0xFFFF, 0, 0))
    return _header(_icc_bytes([(b"ncl2", tag)], pcs=b"Lab ", version=2),
                   cls=b"nmcl")


CONVERTED = {
    "d2b0-xyz-v4": lambda: d2b0_icc(4),
    "d2b0-xyz-v2": lambda: d2b0_icc(2),
    "d2b0-lab-v4": lambda: d2b0_icc(4, b"Lab "),
    "d2b0-lab-v2": lambda: d2b0_icc(2, b"Lab "),
    "d2b0-beside-a2b0-v4": lambda: d2b0_icc(
        4, b"Lab ", a2b0=_tag_of(lut_icc_mft2(), b"mft2")),
    "d2b0-beside-a2b0-v2": lambda: d2b0_icc(
        2, b"Lab ", a2b0=_tag_of(lut_icc_mft2(), b"mft2")),
    "lifted-black-xyz-v2": lambda: lifted_black_icc(2),
    "lifted-black-xyz-v4": lambda: lifted_black_icc(4),
    "lifted-black-lab-v2": lambda: lifted_black_icc(2, b"Lab "),
    "lifted-black-10pc-v2": lambda: lifted_black_icc(2, lift=0.1),
    "mft2-lab-v2": lambda: lut_icc_mft2(2),
    "mft1-xyz-v2": lambda: lut_icc_mft1(2),
    "mab-all-elements-v4": lambda: lut_icc_mab(4),
    "rippled-mft2-0.004": lambda: _rippled_mft2(0.004),
    "rippled-mft2-0.02": lambda: _rippled_mft2(0.02),
    "link-rgb-lab-mft2": lambda: _header(lut_icc_mft2(), cls=b"link"),
    "link-rgb-lab-mft1": lambda: _header(lut_icc_mft1(pcs=b"Lab "),
                                         cls=b"link"),
    "link-rgb-lab-d2b0": lambda: _header(d2b0_icc(4, b"Lab "), cls=b"link"),
    "link-rgb-xyz-mab": lambda: _header(lut_icc_mab(), cls=b"link"),
    "link-rgb-xyz-d2b0": lambda: _header(d2b0_icc(4), cls=b"link"),
    "abstract-rgb-lab": lambda: _header(lut_icc_mft2(), cls=b"abst"),
    "colour-space-class": lambda: _header(lut_icc_mft2(), cls=b"spac"),
    "lab-space-rgb-pcs": lambda: _header(lut_icc_mft2(), space=b"Lab ",
                                         pcs=b"RGB "),
}

REFUSED = {
    "link-rgb-rgb": lambda: _header(lut_icc_mft2(), cls=b"link",
                                    pcs=b"RGB "),
    "link-rgb-cmyk": lambda: _header(lut_icc_mft2(), cls=b"link",
                                     pcs=b"CMYK"),
    "abstract-lab-lab": lambda: _header(lut_icc_mft2(), cls=b"abst",
                                        space=b"Lab "),
    "named-colour": named_colour_icc,
    "rgb-pcs-input": lambda: _header(lut_icc_mft2(), pcs=b"RGB "),
    "d2b0-unknown-element": lambda: d2b0_icc(
        elements=d2b0_elements() + [b"xxxx\0\0\0\0" + b"\0" * 8]),
    "d2b0-nan": lambda: d2b0_icc(elements=[
        _matf(np.eye(3), (float("nan"), 0.0, 0.0))]),
    "d2b0-cut-unreadable-beside-a2b0": lambda: d2b0_icc(
        elements=[_matf(np.eye(3), (0, 0, 0))[:-4]],
        a2b0=_tag_of(lut_icc_mft2(), b"mft2")),
    "mpet-in-a2b0": lambda: _icc_bytes([(b"A2B0", _mpet(d2b0_elements()))]),
}


def pillow(icc, img, flags=0):
    return np.asarray(ImageCms.profileToProfile(
        Image.fromarray(img), ImageCms.ImageCmsProfile(io.BytesIO(icc)),
        ImageCms.createProfile("sRGB"), flags=flags))


# -- converted forms ---------------------------------------------------------

@pytest.mark.parametrize("form", sorted(CONVERTED))
def test_converted_form_bit_equal_to_pillow(form, tmp_path):
    icc = CONVERTED[form]()
    img = _lut_inputs()
    d = np.abs(lcms.to_srgb(img, icc).astype(np.int64)
               - pillow(icc, img).astype(np.int64))
    assert d.max() == 0 and d.mean() == 0.0
    path = _save(str(tmp_path / "a.png"),
                 Image.fromarray(img[0, :32 * 48].reshape(32, 48, 3)),
                 icc_profile=icc)
    got = assert_same_frame(path)
    mode, samples, _ = read_image(path)
    assert not np.array_equal(
        got.rgb, load_std_image_without_icc(mode, samples, path))


@pytest.mark.parametrize("form", sorted(CONVERTED))
def test_float_pipeline_against_pillow_unoptimised(form):
    """The linked, pre-optimised pipeline per pixel against LittleCMS
    with ``Flags.NOOPTIMIZE`` (each pixel's 16-bit words through its
    float stages): bit-equal."""
    icc = CONVERTED[form]()
    img = _lut_inputs()
    st = lcms_stages.pre_optimize(lcms.link(lcms.Profile(icc)))
    got = lcms.from_16_to_8(lcms_stages.eval16(
        st, img[0].astype(np.int64) * 257))
    want = pillow(icc, img, flags=ImageCms.Flags.NOOPTIMIZE)[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", ["d2b0-xyz-v4", "lifted-black-xyz-v2",
                                  "link-rgb-lab-mft2"])
def test_converted_form_on_every_colour(form):
    """A float D2B0, a lifted black and a Lab link on all 2^24 colours:
    bit-equal to Pillow (every pixel converted, in chunks across the
    host's threads)."""
    from tests.test_torch_stdimage import _all_colours

    icc = CONVERTED[form]()
    img = _all_colours()
    np.testing.assert_array_equal(lcms.to_srgb(img, icc), pillow(icc, img))


# -- refused forms -----------------------------------------------------------

@pytest.mark.parametrize("form", sorted(REFUSED))
def test_refused_form_leaves_the_image(form, tmp_path):
    icc = REFUSED[form]()
    img = _lut_inputs()
    with pytest.raises(Exception):
        pillow(icc, img)
    with pytest.raises(lcms.Refused):
        lcms.to_srgb(img, icc)
    path = _save(str(tmp_path / "a.png"), Image.fromarray(img[0, :48 * 32]
                                                          .reshape(32, 48, 3)),
                 icc_profile=icc)
    got = assert_same_frame(path)
    mode, samples, _ = read_image(path)
    np.testing.assert_array_equal(
        got.rgb, load_std_image_without_icc(mode, samples, path))


# -- the model's structure ---------------------------------------------------

@pytest.mark.parametrize("form,kind,prelin", [
    ("lifted-black-xyz-v2", "ClutTransform", True),
    ("d2b0-xyz-v2", "ClutTransform", True),
    ("d2b0-xyz-v4", "ClutTransform", False),
    ("link-rgb-lab-mft2", "ClutTransform", True),
])
def test_optimiser_each_form_ends_in(form, kind, prelin):
    """The optimiser the model picks, as LittleCMS picks it: a lifted
    black puts an offset stage between the matrices, so the transform is
    resampled (through prelinearisation curves where the grey ramp is
    monotonic, as for the v2 D2B0; the v4 D2B0's black point
    compensation makes its grey curves degenerate, so it is resampled
    plainly); the result is bit-equal either way."""
    t = lcms.build_transform(CONVERTED[form]())
    assert type(t).__name__ == kind
    assert (t.prelin is not None) == prelin


def test_black_below_the_empty_layer_keeps_the_matrix_shaper():
    """A black so near zero that the compensation's distance from the
    identity is under 0.002 (IsEmptyLayer): no stage is added, and the
    source joins sRGB as a matrix-shaper, bit-equal to Pillow."""
    icc = lifted_black_icc(2, lift=0.0002)
    prof = lcms.Profile(icc)
    assert any(lcms.detect_black_point(prof))
    assert lcms.bpc_conversion(lcms.detect_black_point(prof),
                               lcms.srgb_black_point()) is None
    assert isinstance(lcms.build_transform(icc), lcms.MatrixShaper)
    img = _lut_inputs()
    np.testing.assert_array_equal(lcms.to_srgb(img, icc), pillow(icc, img))


def test_black_points():
    """cmsDetectBlackPoint as the model reads it: a v4 LUT profile's is
    the perceptual reference black, a link's zero, a v2 profile's its
    own darkest colorant (L above 50 read as 0), sRGB's zero."""
    assert lcms.srgb_black_point() == (0.0, 0.0, 0.0)
    assert lcms.detect_black_point(lcms.Profile(d2b0_icc(4))) == \
        lcms.PERCEPTUAL_BLACK
    assert lcms.detect_black_point(lcms.Profile(
        CONVERTED["link-rgb-xyz-mab"]())) == (0.0, 0.0, 0.0)
    # a D2B0 alone supports no intent for input (cmsIsIntentSupported)
    assert lcms.detect_black_point(lcms.Profile(d2b0_icc(2))) == \
        (0.0, 0.0, 0.0)
    y = lcms.detect_black_point(lcms.Profile(lifted_black_icc(2)))[1]
    assert 0.019 < y < 0.021
    assert lcms.detect_black_point(lcms.Profile(
        lifted_black_icc(2, lift=0.3))) == (0.0, 0.0, 0.0)


def test_d2b0_read_before_the_a2b0():
    """With both tags, LittleCMS reads the float D2B0: the v4 profile
    (whose black is the perceptual one either way) converts as its D2B0
    alone does, not as its A2B0 alone does."""
    img = _lut_inputs()
    both = lcms.to_srgb(img, CONVERTED["d2b0-beside-a2b0-v4"]())
    np.testing.assert_array_equal(both, lcms.to_srgb(img, d2b0_icc(
        4, b"Lab ")))
    assert not np.array_equal(both, lcms.to_srgb(img, lut_icc_mft2(4)))


def _lattice_joins_identity(a):
    """Whether some s15.16 column m near a^-1 e_j has |a m - e_j| below
    1e-5 (PreOptimize's identity test) for every column j: the lattice
    points within 3 steps of the exact column, each column alone."""
    inv = np.linalg.inv(a)
    steps = np.arange(-3, 4)
    grid = np.stack(np.meshgrid(steps, steps, steps, indexing="ij"),
                    -1).reshape(-1, 3)
    for j in range(3):
        base = np.round(inv[:, j] * 65536)
        cand = (base + grid) / 65536.0
        dist = np.abs(cand @ a.T - np.eye(3)[j]).max(axis=1)
        if dist.min() >= float(np.float32(1e-5)):
            return False, dist.min()
    return True, 0.0


def test_joined_curves_path_is_out_of_reach():
    """The model raises NotImplementedError where a transform reduces to
    curves alone (LittleCMS's OptimizeByJoiningCurves). That needs the
    source's matrix to join sRGB's output matrix to within 1e-5 of the
    identity: no lattice of s15.16 colorants (times InpAdj) nor of an
    mft2 link's s15.16 matrix (an XYZ link, whose matrix meets sRGB's
    with nothing between) comes that close in any column."""
    out = np.array(lcms.mat3_inverse(lcms.srgb_colorants())) * lcms.OUTP_ADJ
    ok, gap = _lattice_joins_identity(out * lcms.INP_ADJ)
    assert not ok and gap > 1e-5
    ok, gap = _lattice_joins_identity(out)
    assert not ok and gap > 1e-5
    # and an all-curves pipeline is where the model stops
    with pytest.raises(NotImplementedError, match="curves alone"):
        lcms.optimise([lcms_stages.Curves([("table", np.arange(2) * 65535)]
                                          * 3)])


# -- I1's committed fixtures -------------------------------------------------

I1_FORMS = {
    "i1_d2b0_xyz_v4.png": lambda: d2b0_icc(4),
    "i1_d2b0_beside_a2b0_v2.png": CONVERTED["d2b0-beside-a2b0-v2"],
    "i1_lifted_black_v2.png": lambda: lifted_black_icc(2),
    "i1_rippled_mft2.png": lambda: _rippled_mft2(0.02),
    "i1_link_rgb_lab.png": CONVERTED["link-rgb-lab-mft2"],
    "i1_link_rgb_xyz_d2b0.png": CONVERTED["link-rgb-xyz-d2b0"],
    "i1_abstract_lab_refused.png": REFUSED["abstract-lab-lab"],
}


def i1_picture():
    """64x64: hue and lightness sweeps, a grey ramp and a block of noise."""
    y, x = np.mgrid[0:64, 0:64] / 63.0
    h = x * 6.0
    c = np.stack([np.clip(np.abs(h - 3) - 1, 0, 1),
                  np.clip(2 - np.abs(h - 2), 0, 1),
                  np.clip(2 - np.abs(h - 4), 0, 1)], -1)
    rgb = np.round((c * (1 - y[..., None]) + y[..., None] * 0.5) * 255)
    rgb[0] = np.linspace(0, 255, 64)[:, None]
    rgb[40:56, 8:24] = np.random.default_rng(27).integers(0, 256, (16, 16, 3))
    return rgb.astype(np.uint8)


def i1_png(icc):
    bio = io.BytesIO()
    Image.fromarray(i1_picture()).save(bio, "PNG", icc_profile=icc)
    return bio.getvalue()


def test_i1_fixtures_hold_their_sha256():
    """chip_smoke.py's I1 fixtures: each committed PNG is what `i1_png`
    writes with its profile, 64x64 and at most 64 KB; the sha256 recorded
    under "I1 <name>" is Pillow's conversion of its RGB to sRGB (its RGB
    as it is where Pillow refuses the profile), which the port's
    `load_std_image` gives, as the reference's does."""
    from art_tpu_torch.io.imagefile import read_rgb8

    data_dir = os.path.join(os.path.dirname(__file__), "data")
    recorded = json.load(open(os.path.join(data_dir, "formats_sha256.json")))
    assert {n for _, n, _ in chip_smoke.I1_FORMS} == set(I1_FORMS)
    assert {k for k in recorded if k.startswith("I1 ")} == {
        f"I1 {n}" for n in I1_FORMS}
    for name, make in I1_FORMS.items():
        path = os.path.join(data_dir, name)
        icc = make()
        data = open(path, "rb").read()
        assert data == i1_png(icc) and len(data) <= 64 * 1024, name
        rgb = np.asarray(Image.open(path).convert("RGB"))
        assert rgb.shape == (64, 64, 3)
        try:
            want = pillow(icc, rgb)
        except ImageCms.PyCMSError:
            want = rgb
        assert hashlib.sha256(want.tobytes()).hexdigest() == \
            recorded[f"I1 {name}"], name
        got = assert_same_frame(path)
        np.testing.assert_array_equal(chip_smoke.frame_rgb8(got.rgb), want)
        np.testing.assert_array_equal(read_rgb8(path), rgb)


@pytest.mark.parametrize("name", [n for _, n, t in chip_smoke.I1_FORMS if t])
def test_i1_tiling_at_a_small_size(name, tmp_path):
    """chip_smoke.i1_tiled at 3x2 fixtures, written by the port's PNG
    writer with the fixture's profile: the port's frame is the tiling of
    the fixture's frame, and equals the reference's load of that file."""
    from art_tpu_torch.io.imagefile import load_std_image, write_png

    path = os.path.join(os.path.dirname(__file__), "data", name)
    _, samples, icc = read_image(path)
    big = str(tmp_path / "big.png")
    write_png(big, chip_smoke.i1_tiled(samples, 150, 170), icc_bytes=icc)
    got = assert_same_frame(big).rgb
    np.testing.assert_array_equal(
        got, chip_smoke.i1_tiled(np.moveaxis(load_std_image(path).rgb, 0, -1),
                                 150, 170).transpose(2, 0, 1))
