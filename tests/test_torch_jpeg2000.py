"""JPEG 2000 decoded by the port (`art_tpu_torch.io.jpeg2000` over
`io/native/jp2dec.cc`) on the CPU against Pillow 12.1.0 (OpenJPEG 2.5.4)
and, through the consumers, against `art_tpu`:

- Pillow's encoder options: lossless and irreversible, tiles and their
  offsets, image offsets, quality layers by rate and by dB, 1 to 7
  resolutions, code-blocks down to 4x4 and not square, precincts, the
  five progressions, MCT on and off, bare codestreams, PLT, signed
  samples, the modes L, LA, RGB, RGBA, I;16, CMYK and YCbCr (sYCC), and
  sizes 1x1, 1xN, Nx1 and odd ones: `read_image`, `read_rgb8`,
  `read_grey` and `load_std_image` as Pillow and the reference; DCP 2K
  frames of the cinema profile (a tile-part a component, TLM);
- rewrites Pillow's encoder cannot write (tests/util_j2kforms.py): SIZ
  precisions 1-16, signed and not; COD's and COC's code-block style byte
  with each of the six flags alone and in combinations (a decode or
  Pillow's failure); POC progressions; tile-parts split, reordered and
  interleaved; 4:2:0 and 4:2:2 sYCC spliced from
  one-component streams; JP2 boxes (pclr and cmap for P and PA with
  repeated colours, cdef, colr of enumcs 12, 17 and 18 and of an ICC
  profile, res, bpcc, an ihdr that disagrees with SIZ); RGN (ROI
  maxshift) in the main and a tile's header; packet headers moved into
  PPT or PPM, whole and damaged; HTJ2K code-blocks in empty packets;
- HTJ2K streams of the tests' own encoder (tests/util_htforms.py):
  cleanup only and with SigProp and MagRef, 5/3 and 9/7, layers, tiles,
  precincts, stripe-causal, CAP/CPF; lossless ones (and SigProp and
  MagRef at one resolution) as the encoder's input in Pillow; damaged
  copies and random code-block bytes as Pillow; the consumers;
- ICNS with JPEG 2000 icons (ic08, icp4);
- damaged copies of tiled, layered, precinct-partitioned files (cut,
  bytes changed anywhere): Pillow's array or its error; and (slow) the
  decoder under AddressSanitizer and UBSan on damaged copies of every
  form (tests/jp2dec_driver.cc);
- the committed fixtures against the sha256 of Pillow's decode, and
  `chip_smoke.py`'s Q1 tiling and Q2 Hald and mask, U1's HTJ2K tiling
  and U2's HTJ2K Hald and mask.

Every form decodes bit-equal to Pillow, 9/7 included. The damaged copies
of Pillow's own JPEG 2000 files are in tests/test_torch_unported.py.
"""

import hashlib
import json
import os
import warnings

import numpy as np
import pytest

from art_tpu.io.imagefile import load_std_image as ref_load
from art_tpu_torch import hostbuild
from art_tpu_torch.io import jpeg2000, unported
from art_tpu_torch.io.imagefile import (load_std_image, read_grey, read_image,
                                        read_rgb8)

import chip_smoke
import util_htforms
import util_j2kforms as F
from test_torch_formats import DATA, check_readers, pil_grey

Image = pytest.importorskip("PIL.Image")

PIC = F.picture(48, 64)
SMALL = F.picture(17, 33, seed=1)


def _write(tmp_path, data, name="a.jp2"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _outcome(fn):
    """("ok", value), ("OSError", its message), or the error's class:
    ("ValueError",), ("IndexError",) or ("other",)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return ("ok", fn())
        except OSError as e:
            return ("OSError", str(e))
        except Exception as e:
            for cls in (ValueError, IndexError):
                if isinstance(e, cls):
                    return (cls.__name__,)
            return ("other",)


def _same(want, got):
    if want[0] != got[0]:
        return False
    if want[0] == "ok":
        a, b = (np.asarray(getattr(v, "rgb", v)) for v in (want[1], got[1]))
        return a.shape == b.shape and np.array_equal(a, b)
    return want == got


def _pil_rgb(path):
    return np.asarray(Image.open(path).convert("RGB"))


def check(data, tmp_path, name="a.jp2"):
    """The four readers on `data` as Pillow and the reference, or
    Pillow's load error (class and message) from each reader; Pillow's
    outcome."""
    path = _write(tmp_path, data, name)
    want = _outcome(lambda: _pil_rgb(path))
    if want[0] != "ok":
        assert _same(want, _outcome(lambda: read_rgb8(path)))
        assert _outcome(lambda: read_image(path))[0] == want[0]
        assert _outcome(lambda: read_grey(path))[0] == want[0]
        return want[0]
    check_readers(path)
    return "ok"


# -- Pillow's encoder options ------------------------------------------------

ENCODED = {
    "lossless": lambda: F.encode(PIC),
    "irreversible": lambda: F.encode(PIC, irreversible=True),
    "bare codestream": lambda: F.encode(PIC, no_jp2=True),
    "bare irreversible": lambda: F.encode(PIC, no_jp2=True,
                                          irreversible=True),
    "tiles 16x16": lambda: F.encode(PIC, tile_size=(16, 16)),
    "tiles 17x13 at (3, 5), offset (5, 7)": lambda: F.encode(
        PIC, tile_size=(17, 13), tile_offset=(3, 5), offset=(5, 7)),
    "irreversible tiles 17x13 at (3, 5), offset (5, 7)": lambda: F.encode(
        PIC, tile_size=(17, 13), tile_offset=(3, 5), offset=(5, 7),
        irreversible=True),
    "offset (7, 3)": lambda: F.encode(PIC, tile_size=(70, 52),
                                      tile_offset=(2, 1), offset=(7, 3)),
    "layers by rate": lambda: F.encode(PIC, quality_mode="rates",
                                       quality_layers=[40, 10, 2]),
    "irreversible layers by rate": lambda: F.encode(
        PIC, quality_mode="rates", quality_layers=[40, 10, 2],
        irreversible=True),
    "irreversible layers by dB": lambda: F.encode(
        PIC, quality_mode="dB", quality_layers=[30, 40, 50],
        irreversible=True),
    "code-blocks 4x4": lambda: F.encode(PIC, codeblock_size=(4, 4)),
    "code-blocks 8x32": lambda: F.encode(PIC, codeblock_size=(8, 32)),
    "irreversible code-blocks 64x4": lambda: F.encode(
        PIC, codeblock_size=(64, 4), irreversible=True),
    "precincts 32x32": lambda: F.encode(PIC, precinct_size=(32, 32)),
    "precincts 16x64, 3 resolutions": lambda: F.encode(
        PIC, precinct_size=(16, 64), num_resolutions=3),
    "mct 0": lambda: F.encode(PIC, mct=0),
    "irreversible mct 0": lambda: F.encode(PIC, mct=0, irreversible=True),
    "plt": lambda: F.encode(PIC, plt=True),
    "signed L": lambda: F.encode(PIC, "L", signed=True),
    "signed irreversible": lambda: F.encode(PIC, signed=True,
                                            irreversible=True),
    "L": lambda: F.encode(PIC, "L"),
    "LA": lambda: F.encode(PIC, "LA"),
    "RGBA": lambda: F.encode(F.picture(48, 64, 4), "RGBA"),
    "irreversible RGBA": lambda: F.encode(F.picture(48, 64, 4), "RGBA",
                                          irreversible=True),
    "CMYK": lambda: F.encode(F.picture(48, 64, 4), "CMYK"),
    "YCbCr (sYCC)": lambda: F.encode(PIC, "YCbCr"),
    "irreversible YCbCr (sYCC)": lambda: F.encode(PIC, "YCbCr",
                                                  irreversible=True),
    "I;16": lambda: F.encode16(F.picture(40, 56, 1)[..., 0].astype(
        np.uint16) * 257 + 3),
    "irreversible I;16, tiles": lambda: F.encode16(
        F.picture(40, 56, 1)[..., 0].astype(np.uint16) * 250,
        irreversible=True, tile_size=(24, 24)),
    "17x33": lambda: F.encode(SMALL, num_resolutions=2),
    "irreversible 17x33": lambda: F.encode(SMALL, num_resolutions=2,
                                           irreversible=True),
    "1x1": lambda: F.encode(F.picture(1, 1), num_resolutions=1),
    "irreversible 1x9": lambda: F.encode(F.picture(1, 9), num_resolutions=1,
                                         irreversible=True),
    "9x1 L": lambda: F.encode(F.picture(9, 1), "L", num_resolutions=1),
    "2x3": lambda: F.encode(F.picture(2, 3), num_resolutions=2),
}
for _n in range(1, 8):  # 7 resolutions need 64 samples a side
    ENCODED[f"{_n} resolutions"] = lambda n=_n: F.encode(
        F.picture(64, 64), num_resolutions=n, codeblock_size=(16, 16))
    ENCODED[f"irreversible, {_n} resolutions"] = lambda n=_n: F.encode(
        F.picture(64, 64), num_resolutions=n, irreversible=True,
        codeblock_size=(16, 16))
for _p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
    for _irr in (False, True):
        ENCODED[f"{_p}{', irreversible' if _irr else ''}"] = \
            lambda p=_p, irr=_irr: F.encode(
                PIC, progression=p, irreversible=irr, quality_layers=[20, 5],
                precinct_size=(16, 16), num_resolutions=4, no_jp2=True)


@pytest.mark.parametrize("form", sorted(ENCODED))
def test_encoder_forms_decode_as_pillow(form, tmp_path):
    assert check(ENCODED[form](), tmp_path) == "ok"


@pytest.mark.parametrize("mode", ["cinema2k-24", "cinema2k-48"])
def test_dcp_cinema_frames(mode, tmp_path):
    """A digital cinema package's 2K frame as Pillow writes it (OpenJPEG's
    cinema profile: 9/7, CPRL, precincts, a TLM marker, a tile-part a
    component): `read_rgb8` as Pillow."""
    data = F.encode(F.picture(1080, 2048, noise=4), cinema_mode=mode)
    path = _write(tmp_path, data, "frame.j2c")
    assert data.count(b"\xff\x90\x00\x0a") == 3
    np.testing.assert_array_equal(read_rgb8(path), _pil_rgb(path))


# -- rewrites ----------------------------------------------------------------

@pytest.mark.parametrize("prec", range(1, 17))
@pytest.mark.parametrize("sgnd", [0, 0x80])
def test_siz_precisions(prec, sgnd, tmp_path):
    """Each component's Ssiz rewritten to a precision of 1-16 bits, signed
    or not, on L and RGB streams, 5/3 and 9/7."""
    for mode in ("L", None):
        for irr in (False, True):
            base = F.encode(PIC[:24, :32], mode, irreversible=irr,
                            no_jp2=True)
            check(F.set_ssiz(base, sgnd | (prec - 1)), tmp_path, "a.j2k")


STYLES = [1, 2, 4, 8, 16, 32, 3, 5, 9, 12, 24, 40, 48, 56, 63]


@pytest.mark.parametrize("style", STYLES)
def test_code_block_styles(style, tmp_path):
    """COD's code-block style byte, and a COC's for the second component,
    rewritten on streams coded without them (BYPASS, RESET, TERMALL,
    VSC, ERTERM, SEGSYM alone and together): Pillow's decode or its
    failure."""
    outcomes = set()
    for mode in ("L", None):
        for irr in (False, True):
            base = F.encode(PIC, mode, irreversible=irr, no_jp2=True,
                            quality_layers=[20, 5] if irr else None)
            outcomes.add(check(F.set_cod_style(base, style), tmp_path,
                               "a.j2k"))
            if mode is None:
                outcomes.add(check(F.add_coc(base, 1, style), tmp_path,
                                   "a.j2k"))
    if style in (4, 63):  # TERMALL's lengths do not fit the coded passes
        assert "OSError" in outcomes


@pytest.mark.parametrize("height", [1, 2, 3])
def test_tiles_lower_than_the_levels(height, tmp_path):
    """SIZ's tile height rewritten to 1-3 rows under three levels: the low
    resolutions of a tile at an odd row hold no row, so the wavelet runs
    on empty columns (the tile-parts then fill other tiles)."""
    base = F.encode(F.picture(20, 20), "L", tile_size=(8, 8), no_jp2=True)
    assert check(F.set_tile_size(base, 8, height), tmp_path,
                 "a.j2k") == "ok"


def test_one_and_zero_level_streams(tmp_path):
    for irr in (False, True):
        for n in (1, 2):
            data = F.encode(PIC, num_resolutions=n, irreversible=irr,
                            no_jp2=True)
            assert F.main_markers(data)[0xFF52]
            assert check(data, tmp_path, "a.j2k") == "ok"


def _poc_base(layers):
    return F.encode(PIC, no_jp2=True, num_resolutions=4,
                    quality_layers=[30, 8, 2][:layers], irreversible=True)


POCS = {
    # the stream's own LRCP order, split at resolution 2 (one layer)
    "LRCP split by resolution": lambda: F.add_poc(
        _poc_base(1), (0, 0, 1, 2, 3, 0), (2, 0, 1, 4, 3, 0)),
    # component by component, which one layer's LRCP order is not
    "CPRL over an LRCP stream": lambda: F.add_poc(
        _poc_base(1), (0, 0, 1, 4, 3, 4)),
    # three layers read resolution first: a different packet order
    "RLCP over a three-layer LRCP stream": lambda: F.add_poc(
        _poc_base(3), (0, 0, 3, 4, 3, 1)),
    # a progression past the first two components, then the rest
    "two components, then the third": lambda: F.add_poc(
        _poc_base(1), (0, 0, 1, 4, 2, 0), (0, 2, 1, 4, 3, 0)),
    "a progression order of 7": lambda: F.add_poc(
        _poc_base(1), (0, 0, 1, 4, 3, 7)),
}


@pytest.mark.parametrize("name", sorted(POCS))
def test_progression_order_changes(name, tmp_path):
    """A POC rewritten into Pillow's streams: the packets read in its
    order (shared across its progressions, each packet once), Pillow's
    decode or its failure."""
    check(POCS[name](), tmp_path, "a.j2k")


_PARTS = {
    "tiles in reverse": [(t, 0, 1) for t in (3, 2, 1, 0)],
    "two parts a tile, interleaved": [(t, 0, 2) for t in range(4)]
    + [(t, 1, 2) for t in range(4)],
    "three parts, zigzag": [(0, 0, 3), (1, 0, 3), (0, 1, 3), (2, 0, 3),
                            (1, 1, 3), (0, 2, 3), (3, 0, 1), (1, 2, 3),
                            (2, 1, 3), (2, 2, 3)],
    "a tile missing": [(t, 0, 1) for t in (0, 1, 2)],
    "a tile twice": [(t, 0, 1) for t in (0, 1, 2, 3, 3)],
}


@pytest.mark.parametrize("last_psot_zero", [False, True])
@pytest.mark.parametrize("tnsot", [True, False])
@pytest.mark.parametrize("name", sorted(_PARTS))
def test_tile_parts_in_any_order(name, tnsot, last_psot_zero, tmp_path):
    """A four-tile, two-layer 9/7 stream's packets dealt into tile-parts
    (split by its PLT) in another order, TNsot given or 0, the last Psot
    0 or not: decoded (a tile once its last part is read, or at EOC) or
    failed as Pillow does."""
    base = F.encode(PIC, no_jp2=True, plt=True, tile_size=(32, 32),
                    quality_layers=[30, 5], irreversible=True)
    check(F.reorder_tile_parts(base, _PARTS[name], tnsot, last_psot_zero),
          tmp_path, "a.j2k")


# -- ROI, packed packet headers, HTJ2K ----------------------------------------

def _roi_base(irr):
    return F.encode(PIC, no_jp2=True, irreversible=irr, tile_size=(32, 32),
                    quality_layers=[20, 5] if irr else None)


@pytest.mark.parametrize("shift", [1, 2, 3, 5, 12, 20, 25, 31, 40])
def test_roi_maxshift(shift, tmp_path):
    """An RGN (ROI maxshift) rewritten into streams coded without one, 5/3
    and 9/7: for the first component in the main header; for the second
    (Srgn 1) with QCD's guard bits cut to 0, so that the code-blocks'
    planes start lower and the coefficients below the shift stay as they
    are (the decode then differs from the one without RGN); for the third
    in a tile's header. Pillow's decode or its failure."""
    for irr in (False, True):
        base = _roi_base(irr)
        low = F.set_guard_bits(base, 0)
        check(F.add_rgn(base, 0, shift), tmp_path, "a.j2k")
        got = check(F.add_rgn(low, 1, shift, srgn=1), tmp_path, "a.j2k")
        if not irr and 2 <= shift <= 5:
            assert got == "ok"
            assert not np.array_equal(
                _pil_rgb(_write(tmp_path, F.add_rgn(low, 1, shift))),
                _pil_rgb(_write(tmp_path, low)))
        check(F.tile_segment(base, 1, F.rgn_segment(2, shift)), tmp_path,
              "a.j2k")


PACKED = {
    "one tile, three layers, 9/7": lambda: F.encode(
        PIC, no_jp2=True, plt=True, irreversible=True,
        quality_layers=[30, 10, 3]),
    "L, tiles 16x16": lambda: F.encode(PIC, "L", no_jp2=True, plt=True,
                                       tile_size=(16, 16)),
    "tiles 16x16": lambda: F.encode(PIC, no_jp2=True, plt=True,
                                    tile_size=(16, 16)),
    "tiles 17x13 at (3, 5), offset (5, 7), 9/7": lambda: F.encode(
        PIC, no_jp2=True, plt=True, tile_size=(17, 13), tile_offset=(3, 5),
        offset=(5, 7), quality_layers=[20, 5], irreversible=True),
    "8x8 code-blocks, four resolutions": lambda: F.encode(
        PIC, no_jp2=True, plt=True, codeblock_size=(8, 8),
        num_resolutions=4, quality_layers=[40, 10, 2]),
}


@pytest.mark.parametrize("pieces", [1, 3])
@pytest.mark.parametrize("marker", ["PPT", "PPM"])
@pytest.mark.parametrize("name", sorted(PACKED))
def test_packed_packet_headers(name, marker, pieces, tmp_path):
    """Pillow's streams with their packet headers moved (split by a parse
    of each packet's header, checked against PLT's lengths) into each
    tile-part's PPT or the main header's PPM, in one marker or three (a
    PPM cut anywhere, inside an Nppm too): Pillow's decode, which is the
    stream's own where it decodes, or its failure."""
    base = PACKED[name]()
    data = (F.with_ppt if marker == "PPT" else F.with_ppm)(base, pieces)
    if check(data, tmp_path, "a.j2k") == "ok":
        np.testing.assert_array_equal(
            _pil_rgb(_write(tmp_path, data)),
            _pil_rgb(_write(tmp_path, base, "b.j2k")))


@pytest.mark.parametrize("marker", ["PPT", "PPM"])
def test_damaged_packed_packet_headers(marker, tmp_path):
    """60 damaged copies of a tiled two-layer stream with its packet
    headers in PPT or PPM: Pillow's array or its error."""
    base = F.encode(F.picture(24, 20), quality_layers=[30, 3],
                    num_resolutions=3, no_jp2=True, tile_size=(16, 16),
                    plt=True)
    data = (F.with_ppt if marker == "PPT" else F.with_ppm)(base, 2)
    rng = np.random.default_rng(["PPT", "PPM"].index(marker) + 7)
    wrong = []
    for i, d in enumerate(F.damaged_copies(data, rng, 60)):
        path = _write(tmp_path, d, "v.j2k")
        want = _outcome(lambda: _pil_rgb(path))
        got = _outcome(lambda: read_rgb8(path))
        if not _same(want, got):
            wrong.append((i, want[0], got[0]))
    assert not wrong, wrong


def _empty(**kw):
    return F.empty_packets(F.encode(PIC, no_jp2=True, plt=True, **kw))


HTJ2K = {
    "COD": lambda st: F.set_cod_style(_empty(), st),
    "COD with VSC": lambda st: F.set_cod_style(_empty(), st | 8),
    "COC of the second component": lambda st: F.add_coc(_empty(), 1, st),
    "a tile's COD": lambda st: F.tile_segment(
        _empty(tile_size=(32, 32)), 1,
        F.cod_segment(_empty(tile_size=(32, 32)), st)),
}


@pytest.mark.parametrize("name", sorted(HTJ2K))
def test_htj2k_code_blocks_are_refused_by_name(name, tmp_path):
    """A stream whose COD or COC asks for HTJ2K code-blocks (style bit
    0x40), with every packet empty so that it codes no block: no longer
    refused, the port's readers decode it as Pillow does and the
    external mask as the reference's (the name is kept from when the
    port refused these streams). Without the bit the same stream
    decodes as Pillow's."""
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu_torch.masks import load_external_mask

    assert check(HTJ2K[name](0), tmp_path, "a.j2k") == "ok"
    assert check(HTJ2K[name](0x40), tmp_path, "a.j2k") == "ok"
    path = _write(tmp_path, HTJ2K[name](0x40), "a.j2k")
    np.testing.assert_array_equal(load_external_mask(path, 30, 40, False),
                                  ref_mask(path, 30, 40, False))


# HTJ2K streams of the tests' own encoder (tests/util_htforms.py): (image,
# encode_ht's options)
HT_PIC = F.picture(21, 27, seed=3)
HT_FORMS = {
    "cleanup, 5/3, no level": (HT_PIC, dict(levels=0)),
    "cleanup, 5/3, grey, 4x4 blocks": (HT_PIC[..., 1], dict(
        levels=2, cblk=(2, 2))),
    "cleanup, 5/3, three levels, 8x4 blocks": (HT_PIC, dict(
        levels=3, cblk=(3, 2))),
    "cleanup, 9/7": (HT_PIC, dict(levels=2, reversible=False, step_exp=2)),
    "SigProp, 5/3, no level": (HT_PIC, dict(levels=0, passes=2)),
    "SigProp and MagRef, 5/3, no level": (HT_PIC, dict(levels=0,
                                                       passes=3)),
    "SigProp and MagRef, 9/7": (HT_PIC, dict(levels=2, reversible=False,
                                             passes=3)),
    "SigProp and MagRef, 9/7, plane 3": (HT_PIC, dict(
        levels=1, reversible=False, passes=3, plane=3, cblk=(2, 3))),
    "SigProp and MagRef, stripe-causal": (HT_PIC[..., 0], dict(
        levels=1, passes=3, vsc=True, cblk=(3, 3))),
    "two layers": (HT_PIC, dict(levels=1, layers=2, passes=3,
                                reversible=False)),
    "three layers, cleanup only": (HT_PIC, dict(levels=2, layers=3)),
    "refinement a layer after its cleanup": (HT_PIC, dict(
        levels=1, layers=2, passes=3, split=True)),
    "SigProp a layer after its cleanup": (HT_PIC, dict(
        levels=1, layers=2, passes=2, split=True)),
    "tiles 13x11, precincts": (HT_PIC, dict(
        levels=2, tile=(13, 11), precincts=[(2, 2), (3, 3), (4, 4)],
        cblk=(2, 2))),
    "CAP and CPF markers": (HT_PIC, dict(levels=1, markers=True)),
    "1x9 and 9x1": (HT_PIC[:1, :9], dict(levels=2, passes=3)),
    "9x1": (HT_PIC[:9, :1], dict(levels=2)),
    "no MCT": (HT_PIC, dict(levels=1, mct=False, passes=3)),
}


def _ht(name):
    img, kw = HT_FORMS[name]
    return util_htforms.encode_ht(img, **kw)


@pytest.mark.parametrize("name", sorted(HT_FORMS))
def test_htj2k_forms_decode_as_pillow(name, tmp_path):
    """The encoder's HTJ2K streams: cleanup only and with SigProp and
    MagRef, 5/3 and 9/7, one to three layers (a block's refinement also
    a layer after its cleanup, which OpenJPEG reads into the cleanup's
    segment), tiles and precincts, stripe-causal, CAP and CPF: the four
    readers as Pillow and the reference. Where the encoder knows the
    image (lossless; SigProp and MagRef with no level) Pillow decodes
    the stream to it, which holds the tables and the passes' reading to
    OpenJPEG's."""
    data, expected = _ht(name)
    outcome = check(data, tmp_path, "h.j2k")
    broken = name == "SigProp a layer after its cleanup"
    assert outcome == ("OSError" if broken else "ok")
    if expected is not None:
        want = expected if expected.ndim == 3 else np.repeat(
            expected[..., None], 3, -1)
        np.testing.assert_array_equal(_pil_rgb(_write(tmp_path, data,
                                                      "e.j2k")), want)


@pytest.mark.parametrize("name", sorted(HT_FORMS))
def test_htj2k_damaged_copies(name, tmp_path):
    """60 damaged copies of each HTJ2K form (util_j2kforms.
    damaged_copies: cut, or bytes changed anywhere): Pillow's array or its
    error."""
    data, _ = _ht(name)
    rng = np.random.default_rng(sorted(HT_FORMS).index(name) + 300)
    wrong = []
    for i, d in enumerate(F.damaged_copies(data, rng, 60)):
        path = _write(tmp_path, d, "v.j2k")
        want = _outcome(lambda: _pil_rgb(path))
        got = _outcome(lambda: read_rgb8(path))
        if not _same(want, got):
            wrong.append((i, want[0], got[0]))
    assert not wrong, wrong


def _garble(rng):
    """A function that replaces a block's segments, now and then, with
    random bytes: all of them, a few bytes changed, the MagSgn part or
    the MEL and VLC part (Scup kept), or random bytes of a random
    length."""
    def mangle(segs):
        if rng.random() > 0.15:
            return segs
        mode = int(rng.integers(0, 5))
        cup = bytearray(segs[0])
        scup = (cup[-1] << 4) | (cup[-2] & 15)
        rest = [bytes(rng.integers(0, 256, len(x), dtype=np.uint8))
                for x in segs[1:]]
        if mode == 0:
            return [bytes(rng.integers(0, 256, len(x), dtype=np.uint8))
                    for x in segs]
        if mode == 1:
            for _ in range(int(rng.integers(1, 4))):
                cup[int(rng.integers(0, len(cup)))] = int(
                    rng.integers(0, 256))
            return [bytes(cup)] + list(segs[1:])
        lo, hi = (0, len(cup) - scup) if mode == 2 else \
            (max(0, len(cup) - scup), len(cup) - 2)
        for i in range(lo, hi):
            if rng.random() < 0.4:
                cup[i] = int(rng.integers(0, 256))
        if mode == 2:
            return [bytes(cup)] + rest
        if mode == 3:
            return [bytes(cup)] + list(segs[1:])
        return [bytes(rng.integers(0, 256, int(rng.integers(2, 60)),
                                   dtype=np.uint8)) for _ in segs]
    return mangle


@pytest.mark.parametrize("seed", range(6))
def test_htj2k_random_code_block_bytes(seed, tmp_path):
    """Random bytes in HT code-block segments (whole segments, the
    MagSgn, MEL and VLC parts, the SigProp and MagRef segment, the
    lengths): the malformed-block checks of OpenJPEG's HT decoder, or a
    decode of the random data, as Pillow; 40 streams a seed."""
    rng = np.random.default_rng(seed + 900)
    wrong = []
    names = sorted(HT_FORMS)
    seen = set()
    for i in range(40):
        img, kw = HT_FORMS[names[(seed * 40 + i) % len(names)]]
        data, _ = util_htforms.encode_ht(img, mangle=_garble(rng), **kw)
        path = _write(tmp_path, data, "r.j2k")
        want = _outcome(lambda: _pil_rgb(path))
        got = _outcome(lambda: read_rgb8(path))
        seen.add(want[0])
        if not _same(want, got):
            wrong.append((i, want[0], got[0]))
    assert not wrong, wrong
    assert seen == {"ok", "OSError"}


def test_htj2k_consumers_as_the_reference(tmp_path):
    """load_std_image, the Hald CLUT, the external mask and the PSF image
    from HTJ2K files against the reference."""
    import art_tpu
    import art_tpu_torch
    from art_tpu.color.lut3d import load_hald_clut as ref_hald
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu.ops.sharpen import load_psf_kernel as ref_psf
    from art_tpu_torch.color.lut3d import load_hald_clut
    from art_tpu_torch.masks import load_external_mask
    from art_tpu_torch.ops.sharpen import load_psf_kernel

    rgb = _write(tmp_path, util_htforms.encode_ht(
        HT_PIC, levels=2, reversible=False, passes=3)[0], "rgb.j2k")
    ref, got = art_tpu.load_image(rgb), art_tpu_torch.load_image(rgb)
    np.testing.assert_array_equal(got.rgb, ref.rgb)
    hald = _write(tmp_path, util_htforms.encode_ht(
        chip_smoke.hald_image(4, 8), levels=2, passes=3, plane=2)[0],
        "hald.j2k")
    np.testing.assert_array_equal(load_hald_clut(hald), ref_hald(hald))
    grey = _write(tmp_path, util_htforms.encode_ht(
        HT_PIC[..., 2], levels=1, passes=3)[0], "m.j2k")
    for path in (rgb, grey):
        for inverted in (False, True):
            np.testing.assert_array_equal(
                load_external_mask(path, 30, 40, inverted),
                ref_mask(path, 30, 40, inverted))
    yy, xx = np.mgrid[-4:5, -4:5]
    k = np.round(255 * np.exp(-(xx ** 2 + yy ** 2) / 6.0)).astype(np.uint8)
    psf = _write(tmp_path, util_htforms.encode_ht(k, levels=1)[0], "k.j2k")
    for scale in (1.0, 2.0):
        got, want = load_psf_kernel(psf, scale), ref_psf(psf, scale)
        assert got is not None
        np.testing.assert_array_equal(got, want)


SUB = {"4:2:0": (2, 2), "4:2:2": (2, 1)}


@pytest.mark.parametrize("jp2", [None, 18, 16])
@pytest.mark.parametrize("kind", sorted(SUB))
def test_subsampled_sycc(kind, jp2, tmp_path):
    """Y at full size, Cb and Cr subsampled, spliced from three
    one-component streams: a bare codestream (sYCC by Pillow's
    heuristic), a JP2 of sYCC and one of sRGB."""
    dx, dy = SUB[kind]
    y = F.picture(21, 30, 1)[..., 0]
    ch, cw = (21 + dy - 1) // dy, (30 + dx - 1) // dx
    cb = F.picture(ch, cw, 1, seed=2)[..., 0]
    cr = F.picture(ch, cw, 1, seed=3)[..., 0]
    assert check(F.subsampled(y, cb, cr, dx, dy, jp2), tmp_path) == "ok"


_CS = F.bare(F.encode(F.picture(12, 16), no_jp2=True))
_CS4 = F.bare(F.encode(F.picture(12, 16, 4), "CMYK", no_jp2=True))
_CSL = F.bare(F.encode(F.picture(12, 16), "L", no_jp2=True))
BOXES = {
    "sRGB": (_CS, F.ihdr(12, 16, 3, 7), F.colr(16)),
    "grey colr on RGB": (_CS, F.ihdr(12, 16, 3, 7), F.colr(17)),
    "sYCC colr": (_CS, F.ihdr(12, 16, 3, 7), F.colr(18)),
    "CMYK colr on three components": (_CS, F.ihdr(12, 16, 3, 7), F.colr(12)),
    "CMYK": (_CS4, F.ihdr(12, 16, 4, 7), F.colr(12)),
    "sRGB colr on four components": (_CS4, F.ihdr(12, 16, 4, 7), F.colr(16)),
    "grey colr on four components": (_CS4, F.ihdr(12, 16, 4, 7),
                                     F.colr(17)),
    "grey L": (_CSL, F.ihdr(12, 16, 1, 7), F.colr(17)),
    "sRGB colr on L": (_CSL, F.ihdr(12, 16, 1, 7), F.colr(16)),
    "ICC profile": (_CS, F.ihdr(12, 16, 3, 7), F.colr(icc=bytes(40))),
    "enumcs 1": (_CS, F.ihdr(12, 16, 3, 7), F.colr(1)),
    "no colr": (_CS, F.ihdr(12, 16, 3, 7)),
    "colr before ihdr": (_CS, F.colr(16), F.ihdr(12, 16, 3, 7)),
    "res": (_CS, F.ihdr(12, 16, 3, 7), F.colr(16), F.res_box()),
    "bpcc": (_CS, F.ihdr(12, 16, 3, 255), F.bpcc([7, 7, 7])),
    "bpcc of the wrong length": (_CS, F.ihdr(12, 16, 3, 7), F.bpcc([7, 7])),
    "cdef": (_CS, F.ihdr(12, 16, 3, 7), F.colr(16),
             F.cdef([(0, 0, 1), (1, 0, 2), (2, 0, 3)])),
    "cdef reordered": (_CS, F.ihdr(12, 16, 3, 7), F.colr(16),
                       F.cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)])),
    "empty cdef": (_CS, F.ihdr(12, 16, 3, 7), F.colr(16), F.cdef([])),
    "ihdr wider than SIZ": (_CS, F.ihdr(12, 17, 3, 7), F.colr(16)),
    "ihdr of one component": (_CS, F.ihdr(12, 16, 1, 7), F.colr(16)),
    "ihdr of four components": (_CS, F.ihdr(12, 16, 4, 7), F.colr(16)),
}


@pytest.mark.parametrize("name", sorted(BOXES))
def test_jp2_boxes(name, tmp_path):
    cs, *boxes = BOXES[name]
    check(F.jp2_file(cs, *boxes), tmp_path)


_INDEX = (np.arange(12 * 16).reshape(12, 16) % 7).astype(np.uint8)
_ENTRIES = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 0, 0],
                     [9, 9, 9], [0, 255, 0], [1, 2, 3]])
PALETTES = {
    "P": lambda: F.palette_file(_INDEX, _ENTRIES),
    "P, grey colr": lambda: F.palette_file(_INDEX, _ENTRIES, enumcs=17),
    "P of fewer colours than indices": lambda: F.palette_file(
        _INDEX, _ENTRIES[:3]),
    "P of RGBA entries": lambda: F.palette_file(
        _INDEX, np.c_[_ENTRIES, np.full(7, 128)]),
    "P of one column": lambda: F.palette_file(_INDEX, _ENTRIES[:, :1]),
    "P of two columns": lambda: F.palette_file(_INDEX, _ENTRIES[:, :2]),
    "PA": lambda: F.palette_file(_INDEX, _ENTRIES,
                                 alpha=(_INDEX * 30).astype(np.uint8)),
}


@pytest.mark.parametrize("name", sorted(PALETTES))
def test_palettes(name, tmp_path):
    """pclr and cmap: P and PA through the palette ImagePalette.getcolor
    builds (a repeated colour kept once, so later indices shift), black
    past it."""
    check(PALETTES[name](), tmp_path)


# -- ICNS --------------------------------------------------------------------

ICNS = {
    "ic08 JP2 RGBA": lambda: F.icns((b"ic08", F.encode(
        F.picture(256, 256, 4, noise=3), "RGBA", irreversible=True,
        quality_layers=[40]))),
    "ic08 J2K RGB": lambda: F.icns((b"ic08", F.encode(
        F.picture(256, 256, noise=3), no_jp2=True, irreversible=True,
        quality_layers=[60]))),
    "icp4 J2K": lambda: F.icns((b"icp4", F.encode(F.picture(16, 16),
                                                  no_jp2=True))),
    "icp4 L": lambda: F.icns((b"icp4", F.encode(F.picture(16, 16), "L"))),
    "icp4 LA": lambda: F.icns((b"icp4", F.encode(F.picture(16, 16), "LA"))),
    "icp4 of the wrong size": lambda: F.icns((b"icp4", F.encode(
        F.picture(16, 17)))),
    "icp4 cut": lambda: F.icns((b"icp4", F.encode(F.picture(16, 16))[:200])),
    "icp4 RGBA cut": lambda: F.icns((b"icp4", F.encode(
        F.picture(16, 16, 4), "RGBA")[:200])),
    "icp4 of a signature box's body": lambda: F.icns((b"icp4", F.encode(
        F.picture(16, 16))[8:])),
}


@pytest.mark.parametrize("name", sorted(ICNS))
def test_icns_jpeg2000_icons(name, tmp_path):
    """read_png_or_jpeg2000 on a JPEG 2000 icon: the readers as Pillow's,
    or its error's class and message."""
    path = _write(tmp_path, ICNS[name](), "a.icns")
    want = _outcome(lambda: _pil_rgb(path))
    assert _same(want, _outcome(lambda: read_rgb8(path)))
    if want[0] == "ok":
        grey, mode = read_grey(path)
        pg, pmode = pil_grey(path)
        assert mode == pmode
        np.testing.assert_array_equal(grey, pg)
        assert _same(_outcome(lambda: ref_load(path)),
                     _outcome(lambda: load_std_image(path)))


# -- damaged files -------------------------------------------------------------

DAMAGED = {
    "tiles, RPCL, two layers": lambda: F.encode(
        F.picture(24, 20), quality_layers=[30, 3], progression="RPCL",
        precinct_size=(16, 16), num_resolutions=3, no_jp2=True,
        tile_size=(16, 16)),
    "irreversible CPRL, two layers": lambda: F.encode(
        F.picture(16, 16), progression="CPRL", irreversible=True,
        quality_layers=[20, 4], no_jp2=True),
    "LA, PCRL, 8x8 code-blocks": lambda: F.encode(
        F.picture(16, 16), "LA", progression="PCRL", codeblock_size=(8, 8)),
}


@pytest.mark.parametrize("name", sorted(DAMAGED))
def test_damaged_files_decode_as_pillow(name, tmp_path):
    """Cut short, or one to three bytes changed (most anywhere, some in
    the headers): each copy gives Pillow's array or fails with its error
    class and message."""
    data = DAMAGED[name]()
    rng = np.random.default_rng(sorted(DAMAGED).index(name) + 24)
    n = len(data)
    wrong = []
    for i in range(60):
        d = bytearray(data)
        if i < 8:
            d = d[: int(rng.integers(1, n))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                at = int(rng.integers(0, n)) if rng.random() < 0.6 else \
                    int(rng.integers(0, min(n, 160)))
                d[at] = int(rng.choice([0, 1, 255, 0x7F,
                                        int(rng.integers(0, 256))]))
        path = _write(tmp_path, bytes(d), "v.j2k")
        want = _outcome(lambda: _pil_rgb(path))
        got = _outcome(lambda: read_rgb8(path))
        if not _same(want, got):
            wrong.append((i, want[0], got[0]))
    assert not wrong, wrong


@pytest.mark.slow
def test_damaged_copies_under_sanitizers(tmp_path):
    """jp2dec.cc built with AddressSanitizer and UBSan decodes each of the
    forms above and 60 damaged copies of each (encoder options, POC, palettes,
    the damaged-file bases, reordered tile-parts, sYCC, style and
    precision rewrites, tiles lower than their levels, ROI, PPT and PPM,
    HTJ2K in empty packets, every HTJ2K form of the encoder and its
    streams of random code-block bytes) with no report."""
    import subprocess

    driver = F.sanitized_driver(tmp_path)
    forms = [f() for f in ENCODED.values()]
    forms += [f() for f in (*POCS.values(), *PALETTES.values(),
                            *DAMAGED.values())]
    parts = F.encode(PIC, no_jp2=True, plt=True, tile_size=(32, 32),
                     quality_layers=[30, 5], irreversible=True)
    forms += [F.reorder_tile_parts(parts, sc) for sc in _PARTS.values()]
    forms.append(F.subsampled(F.picture(21, 30, 1)[..., 0],
                              F.picture(11, 15, 1, 2)[..., 0],
                              F.picture(11, 15, 1, 3)[..., 0]))
    coded = F.encode(PIC, no_jp2=True, irreversible=True,
                     quality_layers=[20, 5])
    forms += [F.set_cod_style(coded, st) for st in (1, 4, 8, 32, 63)]
    forms += [F.set_ssiz(F.encode(PIC[:24, :32], no_jp2=True), p)
              for p in (0x03, 0x0B, 0x8B, 0x0F)]
    tiled = F.encode(F.picture(20, 20), "L", tile_size=(8, 8), no_jp2=True)
    forms += [F.set_tile_size(tiled, 8, h) for h in (1, 2, 3)]
    forms += [F.add_rgn(F.set_guard_bits(_roi_base(irr), 0), 1, 3)
              for irr in (False, True)]
    forms += [wrap(f(), 2) for f in PACKED.values()
              for wrap in (F.with_ppt, F.with_ppm)]
    forms += [f(0x40) for f in HTJ2K.values()]
    forms += [_ht(name)[0] for name in sorted(HT_FORMS)]
    garble = _garble(np.random.default_rng(77))
    forms += [util_htforms.encode_ht(img, mangle=garble, **kw)[0]
              for img, kw in HT_FORMS.values()]
    rng = np.random.default_rng(2024)
    paths = []
    for i, form in enumerate(forms):
        paths.append(_write(tmp_path, form, f"{i}.j2k"))
        for j, d in enumerate(F.damaged_copies(form, rng, 60)):
            paths.append(_write(tmp_path, d, f"{i}_{j}.j2k"))
    for k in range(0, len(paths), 400):
        run = subprocess.run([driver, *paths[k : k + 400]],
                             capture_output=True, text=True)
        assert run.returncode == 0, run.stderr[-3000:]
        assert "runtime error" not in run.stderr, run.stderr[-3000:]


# -- consumers -----------------------------------------------------------------

def test_consumers_as_the_reference(tmp_path):
    """load_std_image of an RGB and an I;16 file (the reference's /65535
    branch), the Hald CLUT, the external mask (its mode rule) and the PSF
    image from JPEG 2000 files against the reference."""
    import art_tpu
    import art_tpu_torch
    from art_tpu.color.lut3d import load_hald_clut as ref_hald
    from art_tpu.masks import _load_external_mask as ref_mask
    from art_tpu.ops.sharpen import load_psf_kernel as ref_psf
    from art_tpu_torch.color.lut3d import load_hald_clut
    from art_tpu_torch.masks import load_external_mask
    from art_tpu_torch.ops.sharpen import load_psf_kernel

    rgb = _write(tmp_path, F.encode(PIC, irreversible=True), "rgb.jp2")
    grey16 = _write(tmp_path, ENCODED["I;16"](), "g16.jp2")
    for path in (rgb, grey16):
        ref, got = art_tpu.load_image(path), art_tpu_torch.load_image(path)
        np.testing.assert_array_equal(got.rgb, ref.rgb)
    assert read_image(grey16)[0] == "I;16"
    hald = _write(tmp_path, F.encode(chip_smoke.hald_image(4, 8)),
                  "hald.jp2")
    np.testing.assert_array_equal(load_hald_clut(hald), ref_hald(hald))
    for path in (grey16, rgb, _write(tmp_path, F.encode(PIC, "L",
                                                        no_jp2=True),
                                     "m.j2k")):
        for inverted in (False, True):
            np.testing.assert_array_equal(
                load_external_mask(path, 30, 40, inverted),
                ref_mask(path, 30, 40, inverted))
    yy, xx = np.mgrid[-4:5, -4:5]
    k = np.round(255 * np.exp(-(xx ** 2 + yy ** 2) / 6.0)).astype(np.uint8)
    psf = _write(tmp_path, F.encode(k), "k.jp2")
    for scale in (1.0, 2.0):
        got, want = load_psf_kernel(psf, scale), ref_psf(psf, scale)
        assert got is not None
        np.testing.assert_array_equal(got, want)


# -- fixtures, chip_smoke's Q1 and Q2 -----------------------------------------

def _sha(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def test_fixtures_hold_their_sha256():
    """Each committed JPEG 2000 fixture is what util_j2kforms.fixtures
    writes, at most 64 KB, and decodes in Pillow to the recorded sha256
    and in the port to Pillow's array."""
    recorded = json.load(open(os.path.join(DATA, "formats_sha256.json")))
    made = F.fixtures()
    assert {k for k in recorded if k.startswith("j2k_")} == set(made)
    for name, data in made.items():
        path = os.path.join(DATA, name)
        assert open(path, "rb").read() == data, name
        assert len(data) <= 64 * 1024
        want = _pil_rgb(path)
        assert _sha(want) == recorded[name], name
        np.testing.assert_array_equal(read_rgb8(path), want)


def test_q1_tiling_at_a_small_size(tmp_path):
    """chip_smoke.j2k_tiled at 512x768 (and the JP2 wrap): Pillow and the
    port both decode it to the fixture's decode tiled."""
    for label, name, jp2 in chip_smoke.Q1_TILED:
        fixture = open(os.path.join(DATA, name), "rb").read()
        path = _write(tmp_path, chip_smoke.j2k_tiled(fixture, 512, 1024,
                                                     jp2), "q1")
        want = chip_smoke.tiled_decode(_pil_rgb(os.path.join(DATA, name)),
                                       512, 1024)
        np.testing.assert_array_equal(_pil_rgb(path), want, err_msg=label)
        np.testing.assert_array_equal(read_rgb8(path), want, err_msg=label)


@pytest.mark.slow
def test_q1_tiling_premise_at_24mp(tmp_path):
    """Q1's 24 MP files: Pillow's decode is the fixture's tiled and has
    the sha256 chip_smoke.py holds the port's decode to."""
    recorded = json.load(open(os.path.join(DATA, "formats_sha256.json")))
    h, w = chip_smoke.Q1_FRAME
    Image.MAX_IMAGE_PIXELS = None
    for label, name, jp2 in chip_smoke.Q1_TILED:
        fixture = open(os.path.join(DATA, name), "rb").read()
        path = _write(tmp_path, chip_smoke.j2k_tiled(fixture, h, w, jp2),
                      "q1")
        got = _pil_rgb(path)
        assert _sha(got) == recorded[f"{label} {w}x{h}"]
        np.testing.assert_array_equal(got, chip_smoke.tiled_decode(
            _pil_rgb(os.path.join(DATA, name)), h, w))


def test_q2_hald_and_mask_hold_their_samples():
    """Q2's committed Hald and mask decode, in Pillow and in the port, to
    hald_image(6, 8) and f2_mask at Q2_MASK."""
    hald = os.path.join(DATA, chip_smoke.Q2_HALD)
    mask = os.path.join(DATA, chip_smoke.Q2_MASK_FILE)
    want = chip_smoke.hald_image(6, 8)
    np.testing.assert_array_equal(_pil_rgb(hald), want)
    np.testing.assert_array_equal(read_rgb8(hald), want)
    m = chip_smoke.f2_mask(*chip_smoke.Q2_MASK).astype(np.uint8)
    assert Image.open(mask).mode == "L"
    np.testing.assert_array_equal(read_grey(mask)[0], m)
    np.testing.assert_array_equal(pil_grey(mask)[0], m)


def test_u_fixtures_hold_their_sha256():
    """Each committed fixture of chip_smoke.py's U1 and U2 (HTJ2K, the
    three TIFF layouts, IPTC with a JPEG band) is what util_htforms.
    fixtures writes, at most 64 KB, and decodes in Pillow to the recorded
    sha256 and in the port to Pillow's array."""
    recorded = json.load(open(os.path.join(DATA, "formats_sha256.json")))
    made = util_htforms.fixtures()
    assert {k for k in recorded if k.startswith(("u1_", "u2_"))} == \
        set(made)
    for name, data in made.items():
        path = os.path.join(DATA, name)
        assert open(path, "rb").read() == data, name
        assert len(data) <= 64 * 1024
        want = _pil_rgb(path)
        assert _sha(want) == recorded[name], name
        np.testing.assert_array_equal(read_rgb8(path), want)


def test_u1_tiling_at_a_small_size(tmp_path):
    """chip_smoke.j2k_tiled of U1's HTJ2K fixtures at 512x1024 (and the
    JP2 wrap): Pillow and the port both decode it to the fixture's decode
    tiled."""
    for label, name, jp2 in chip_smoke.U1_TILED:
        fixture = open(os.path.join(DATA, name), "rb").read()
        path = _write(tmp_path, chip_smoke.j2k_tiled(fixture, 512, 1024,
                                                     jp2), "u1")
        want = chip_smoke.tiled_decode(_pil_rgb(os.path.join(DATA, name)),
                                       512, 1024)
        np.testing.assert_array_equal(_pil_rgb(path), want, err_msg=label)
        np.testing.assert_array_equal(read_rgb8(path), want, err_msg=label)


@pytest.mark.slow
def test_u1_tiling_premise_at_24mp(tmp_path):
    """U1's 24 MP HTJ2K files: Pillow's decode is the fixture's tiled and
    has the sha256 chip_smoke.py holds the port's decode to."""
    recorded = json.load(open(os.path.join(DATA, "formats_sha256.json")))
    h, w = chip_smoke.Q1_FRAME
    Image.MAX_IMAGE_PIXELS = None
    for label, name, jp2 in chip_smoke.U1_TILED:
        fixture = open(os.path.join(DATA, name), "rb").read()
        path = _write(tmp_path, chip_smoke.j2k_tiled(fixture, h, w, jp2),
                      "u1")
        got = _pil_rgb(path)
        assert _sha(got) == recorded[f"{label} {w}x{h}"]
        np.testing.assert_array_equal(got, chip_smoke.tiled_decode(
            _pil_rgb(os.path.join(DATA, name)), h, w))


def test_u2_hald_and_mask():
    """U2's committed HTJ2K Hald decodes, in Pillow and in the port, to
    hald_image(6, 8) within the SigProp and MagRef passes' last plane
    (two codes), and its mask, lossless, to f2_mask at Q2_MASK."""
    hald = os.path.join(DATA, chip_smoke.U2_HALD)
    mask = os.path.join(DATA, chip_smoke.U2_MASK_FILE)
    got = read_rgb8(hald)
    np.testing.assert_array_equal(got, _pil_rgb(hald))
    assert np.abs(got.astype(int) - chip_smoke.hald_image(6, 8)).max() <= 7
    m = chip_smoke.f2_mask(*chip_smoke.Q2_MASK).astype(np.uint8)
    assert Image.open(mask).mode == "L"
    np.testing.assert_array_equal(read_grey(mask)[0], m)
    np.testing.assert_array_equal(pil_grey(mask)[0], m)


def test_only_the_jpeg2000_decoder_builds_without_contraction():
    """jp2dec.cc alone gets -ffp-contract=off; every other host library
    keeps the shared flags (and so its bytes)."""
    assert hostbuild.flags("jp2dec") == hostbuild.CXX_FLAGS + (
        "-ffp-contract=off",)
    for stem in ("artraw", "jpegenc", "jpegdec", "lzwdec", "webpdec",
                 "rasterdec"):
        assert hostbuild.flags(stem) == hostbuild.CXX_FLAGS
    assert jpeg2000.BROKEN == "broken data stream when reading image file"
    assert "JPEG 2000" not in {n for n, _, _ in unported.FORMATS}
