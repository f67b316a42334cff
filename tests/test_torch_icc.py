"""ICC profile files in art_tpu_torch against `art_tpu` on the CPU.

- `parse_icc_bytes` of matrix profiles (parametric TRCs of types 0-4, a
  gamma 'curv', a sampled 'curv' refit as a Chebyshev pair, sRGB's and a
  staircase's samples, which fall back to tables) and LUT-class ones (lut16 A2B on XYZ and
  B2A on Lab, lut8 A2B, mAB with every element, mBA on Lab): the same
  dict, arrays equal.
- `encode_trc`/`decode_trc` of the srgb, gamma, para, cheb and lut kinds
  on seeded values: within 2e-6.
- `plan_lut` + `apply_stages` of each LUT form, A2B and B2A, on the XYZ
  and Lab PCS with the v2 legacy and v4 Lab encodings: the same stages
  and arrays, values within 2e-6.
- P2's settings (a LUT-class mAB input profile, a LUT-class mft2 output
  profile on Lab) and a matrix/para input with a sampled-TRC output (a
  table) at
  96x160 bilinear: the port plans the reference's plan, and the
  reference's plan developed through the port agrees with the
  reference's develop within the slice bounds (max <= 1 LSB8, mean <=
  2e-4, >= 99.9% within 1 LSB8).
- An output profile named by its basename in <user_dir>/iccprofiles
  plans as the reference's, and `process_image` embeds the profile
  file's own bytes in a JPEG, a PNG and a TIFF, as the reference does.
"""

import importlib
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.color import colorspaces as rcs
from art_tpu.color import iccfile as riccfile
from art_tpu.color import icclut as ricclut
from art_tpu.params import ProcParams as RefProcParams
from art_tpu_torch.color import colorspaces as cs
from art_tpu_torch.color import iccfile, icclut
from art_tpu_torch.color.iccwrite import make_icc
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import (_curv, _icc_bytes, _lattice, _s15f16, _u16,
                        flagship_frame, p2_arp, parity, profile_files,
                        profile_pp, write_lut_icc_out,
                        write_para_icc)
from tests.test_torch_plan import Develops, assert_plans_equal, plan_key

jdev = importlib.import_module("art_tpu.pipeline.develop")

H, W = 96, 160
XYZ_SCALE = 32768.0 / 65535.0


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return profile_files(str(tmp_path_factory.mktemp("profiles")), level=2)


@pytest.fixture(scope="module")
def develops(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    return Develops(root / "profile_develops")


# -- profile bytes ----------------------------------------------------------

PARA = {0: (2.2,), 1: (2.4, 1 / 1.055, 0.055 / 1.055),
        2: (2.4, 1 / 1.055, 0.055 / 1.055, 0.01),
        3: (2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045),
        4: (2.2, 0.95, 0.05, 1 / 10.0, 0.03, 0.005, 0.002)}


def _matrix_icc(trc_tag):
    m = cs.MATRICES_RGB_TO_XYZ["Adobe RGB"]
    tags = [(sig, b"XYZ \0\0\0\0" + _s15f16(m[:, i]))
            for i, sig in enumerate((b"rXYZ", b"gXYZ", b"bXYZ"))]
    return _icc_bytes(tags + [(sig, trc_tag)
                              for sig in (b"rTRC", b"gTRC", b"bTRC")])


def _para(typ):
    return (b"para\0\0\0\0" + struct.pack(">HH", typ, 0)
            + _s15f16(PARA[typ]))


def _mft(is16, matrix, in_curves, clut, out_curves):
    """A lut16 (mft2) or lut8 (mft1) tag."""
    g = clut.shape[0]
    out = (b"mft2" if is16 else b"mft1") + b"\0" * 4 + bytes([3, 3, g, 0])
    out += _s15f16(np.asarray(matrix))
    if is16:
        out += struct.pack(">HH", len(in_curves[0]), len(out_curves[0]))
        return (out + b"".join(_u16(t) for t in in_curves) + _u16(clut)
                + b"".join(_u16(t) for t in out_curves))
    u8 = lambda v: np.round(np.clip(np.ravel(v), 0, 1) * 255).astype(  # noqa
        np.uint8).tobytes()
    return (out + b"".join(u8(t) for t in in_curves) + u8(clut)
            + b"".join(u8(t) for t in out_curves))


def _mab(is_ab, a=None, clut=None, m=None, mat34=None, b=None):
    """An mAB/mBA tag; curves None are identity 'curv' entries."""
    def curves(cs3):
        blob = b""
        for i in range(3):
            e = _curv(None if cs3 is None else cs3[i])
            blob += e + b"\0" * ((-len(e)) % 4)
        return blob

    blobs = [("b", curves(b))]
    if mat34 is not None:
        mat34 = np.asarray(mat34)
        blobs.append(("m", _s15f16(np.concatenate([mat34[:, :3].ravel(),
                                                   mat34[:, 3]]))))
    blobs.append(("mc", curves(m)))
    if clut is not None:
        g = clut.shape[0]
        blobs.append(("cl", bytes([g] * 3 + [0] * 13) + bytes([2, 0, 0, 0])
                      + _u16(clut)))
    blobs.append(("a", curves(a)))
    offs, body, pos = {}, b"", 32
    for key, blob in blobs:
        offs[key] = pos
        body += blob
        pos += len(blob)
    return ((b"mAB " if is_ab else b"mBA ") + b"\0" * 4 + bytes([3, 3, 0, 0])
            + b"".join(offs.get(k, 0).to_bytes(4, "big")
                       for k in ("b", "m", "mc", "cl", "a")) + body)


XS = np.linspace(0.0, 1.0, 64)
GAM = [XS ** 1.8, XS ** 2.0, XS ** 2.2]
SQRT = [np.sqrt(XS)] * 3


def _xyz_clut(g):
    """A CLUT from device RGB to the XYZ PCS encoding (sRGB primaries on
    squared values)."""
    lat = _lattice(g) ** 2
    return np.clip(lat @ (cs.MATRICES_RGB_TO_XYZ["sRGB"].T * XYZ_SCALE),
                   0.0, 1.0)


def _lab_clut(g, legacy):
    """A CLUT from the Lab PCS encoding to sRGB-encoded device values."""
    lat = _lattice(g)
    if legacy:
        L = lat[..., 0] * (65535.0 / 652.8)
        a = lat[..., 1] * (65535.0 / 256.0) - 128.0
        b = lat[..., 2] * (65535.0 / 256.0) - 128.0
    else:
        L, a, b = lat[..., 0] * 100.0, lat[..., 1] * 255 - 128, \
            lat[..., 2] * 255 - 128
    x, y, z = rcs.lab_to_xyz(L, a, b)
    lin = np.stack([x, y, z], -1) @ cs.MATRICES_XYZ_TO_RGB["sRGB"].T
    return cs.srgb_gamma(np.clip(lin, 0.0, 1.0))


LUTS = {
    "mft2-a2b-xyz": (b"XYZ ", [(b"A2B0", lambda: _mft(
        True, np.eye(3), SQRT, _xyz_clut(9), [XS ** 1.1] * 3))]),
    "mft2-b2a-lab": (b"Lab ", [(b"B2A0", lambda: _mft(
        True, np.eye(3), [XS] * 3, _lab_clut(9, True), [XS ** 0.9] * 3))]),
    "mft2-b2a-xyz": (b"XYZ ", [(b"B2A0", lambda: _mft(
        True, [[1.0, 0.1, 0.0], [0.0, 0.95, 0.05], [0.0, 0.0, 1.1]],
        GAM, _lattice(5) ** 0.5, [XS] * 3))]),
    "mft1-a2b-xyz": (b"XYZ ", [(b"A2B0", lambda: _mft(
        False, np.eye(3), [np.linspace(0, 1, 256) ** 0.5] * 3,
        _xyz_clut(7), [np.linspace(0, 1, 256)] * 3))]),
    "mab-xyz": (b"XYZ ", [(b"A2B0", lambda: _mab(
        True, a=SQRT, clut=_lattice(9) ** 2, m=GAM,
        mat34=np.hstack([cs.MATRICES_RGB_TO_XYZ["sRGB"] * XYZ_SCALE,
                         np.full((3, 1), 0.01)]), b=[XS ** 0.95] * 3))]),
    "mab-lab": (b"Lab ", [(b"A2B0", lambda: _mab(
        True, a=GAM, clut=_lattice(5) * [0.9, 0.2, 0.3] + [0.05, 0.4, 0.35]
    ))]),
    "mba-lab": (b"Lab ", [(b"B2A0", lambda: _mab(
        False, b=[XS] * 3, clut=_lab_clut(9, False), a=[XS ** 0.95] * 3))]),
    "mba-xyz": (b"XYZ ", [(b"B2A0", lambda: _mab(
        False, b=[XS ** 0.9] * 3,
        mat34=np.hstack([cs.MATRICES_XYZ_TO_RGB["sRGB"] / XYZ_SCALE / 4,
                         np.zeros((3, 1))]), m=SQRT, clut=_lattice(5),
        a=[XS ** 1.05] * 3))]),
}


def _lut_icc(name):
    pcs, tags = LUTS[name]
    return _icc_bytes([(sig, make()) for sig, make in tags], pcs=pcs,
                      version=2 if name.startswith("mft") else 4)


STAIRS = np.repeat(np.linspace(0.0, 1.0, 8), 16)
MATRIX = {f"para{t}": lambda t=t: _matrix_icc(_para(t)) for t in PARA}
MATRIX.update({
    "gamma": lambda: _matrix_icc(_curv(None)[:8] + struct.pack(
        ">IH", 1, int(1.8 * 256))),
    "sampled": lambda: _matrix_icc(_curv(0.5 * XS + 0.5 * XS * XS)),
    "sampled-srgb": lambda: make_icc("sRGB"),
    "stairs": lambda: _matrix_icc(_curv(STAIRS)),
})


def _assert_same(ours, ref, path="profile"):
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref), path
        for k in ref:
            _assert_same(ours[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray) and ours.dtype == ref.dtype, path
        np.testing.assert_array_equal(ours, ref, err_msg=path)
    else:
        assert type(ours) is type(ref) and ours == ref, path


@pytest.mark.parametrize("name", list(MATRIX) + list(LUTS))
def test_parse_icc_bytes_matches_reference(name):
    data = MATRIX[name]() if name in MATRIX else _lut_icc(name)
    ours = iccfile.parse_icc_bytes(data)
    _assert_same(ours, riccfile.parse_icc_bytes(data))
    if name == "stairs":
        assert ours["trc"][0] == "lut"
    elif name.startswith("sampled"):
        # a gamma-like curve resists the series on the sqrt warp
        assert ours["trc"][0] == ("cheb" if name == "sampled" else "lut")


@pytest.mark.parametrize("name", ["para1", "para2", "para3", "para4",
                                  "gamma", "sampled", "sampled-srgb",
                                  "stairs"])
def test_trc_matches_reference(name):
    trc = iccfile.parse_icc_bytes(MATRIX[name]())["trc"]
    x = np.random.default_rng(7).uniform(-0.05, 1.05, 4096).astype(
        np.float32)
    for ours_fn, ref_fn in ((cs.encode_trc, rcs.encode_trc),
                            (cs.decode_trc, rcs.decode_trc)):
        ours = ours_fn(torch.from_numpy(x), trc).numpy()
        ref = np.asarray(ref_fn(jnp.asarray(x), trc, jnp))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-6,
                                   err_msg=f"{name} {ours_fn.__name__}")
    cs.check_trc(trc)


@pytest.mark.parametrize("name", list(LUTS))
def test_apply_stages_matches_reference(name):
    prof = iccfile.parse_icc_bytes(_lut_icc(name))
    direction = "in" if prof["a2b"] is not None else "out"
    lut = prof["a2b"] if direction == "in" else prof["b2a"]
    stages, data = icclut.plan_lut(lut, prof["pcs"], direction)
    ref_stages, ref_data = ricclut.plan_lut(lut, prof["pcs"], direction)
    assert stages == ref_stages
    _assert_same(data, ref_data)
    rng = np.random.default_rng(8)
    if direction == "in":
        x = rng.uniform(-0.05, 1.05, (3, 2048))
    else:  # PCS XYZ of colours inside and outside sRGB
        x = cs.MATRICES_RGB_TO_XYZ["sRGB"] @ rng.uniform(-0.1, 1.1,
                                                         (3, 2048))
    x = x.astype(np.float32)
    ours = icclut.apply_stages(*torch.from_numpy(x), stages, {
        k: torch.from_numpy(np.asarray(v)) for k, v in data.items()})
    ref = ricclut.apply_stages(*jnp.asarray(x), ref_stages, {
        k: jnp.asarray(v) for k, v in ref_data.items()})
    for c in range(3):
        np.testing.assert_allclose(ours[c].numpy(), np.asarray(ref[c]),
                                   rtol=0, atol=2e-6, err_msg=f"{c}")


def _develop_both(frame, pp, ref_pp, develops, label):
    ours = tdev.plan(frame, pp, device="cpu")
    ref_cfg, ref_data = jdev.plan(frame, ref_pp)
    assert_plans_equal(ours, (ref_cfg, ref_data))
    out = develops.get("port-refplan", plan_key(ref_cfg, ref_data), lambda:
                       tdev.crop_result(tdev.build_run(ref_cfg)(
                           tdev.upload(frame, "cpu"),
                           tdev.data_to_torch(ref_data, "cpu")),
                           ref_cfg).numpy())
    ref = develops.get("ref", plan_key(ref_cfg, ref_data),
                       lambda: jdev.develop(frame, ref_pp))
    st = parity(out, ref)
    print(label, st)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st
    return ref_cfg


def test_p2_develops_as_the_reference(files, develops):
    frame = flagship_frame(H, W, seed=5)
    pps = [profile_pp(p2_arp(files), cls()) for cls in (ProcParams,
                                                        RefProcParams)]
    for pp in pps:
        pp.raw.bayer.method = "bilinear"
    cfg = _develop_both(frame, *pps, develops, "P2")
    assert cfg.icc_input_trc[0] == cfg.out_trc[0] == "icclut"
    assert ("pcs_enc", "Lab", True) in cfg.out_trc[1]
    assert tdev.fusion_gates(cfg) == (False, False)


def test_matrix_input_and_sampled_output_develop_as_the_reference(
        tmp_path, develops):
    write_para_icc(str(tmp_path / "camera.icc"), space="sRGB",
                   para=PARA[4])
    with open(tmp_path / "out.icc", "wb") as f:
        f.write(make_icc("ProPhoto"))
    arp = (f"[Color Management]\nInputProfile={tmp_path / 'camera.icc'}\n"
           f"OutputProfile={tmp_path / 'out.icc'}\n")
    frame = flagship_frame(H, W, seed=5)
    pps = [profile_pp(arp, cls()) for cls in (ProcParams, RefProcParams)]
    for pp in pps:
        pp.raw.bayer.method = "bilinear"
        pp.denoise.enabled = False
    cfg = _develop_both(frame, *pps, develops, "matrix in, cheb out")
    assert cfg.icc_input_trc[0] == "para" and cfg.out_trc[0] == "lut"


@pytest.mark.parametrize("which", ["lut", "para"])
def test_output_profile_by_name_in_the_user_dir(tmp_path, which):
    from art_tpu.settings import settings as ref_settings
    from art_tpu_torch.settings import settings

    d = tmp_path / "iccprofiles"
    d.mkdir()
    name = "printer.icc"
    (write_lut_icc_out if which == "lut" else write_para_icc)(str(d / name))
    frame = flagship_frame(32, 48, seed=1)
    pps = [profile_pp(f"[Color Management]\nOutputProfile={name}\n", cls())
           for cls in (ProcParams, RefProcParams)]
    mp = pytest.MonkeyPatch()
    for st in (settings, ref_settings):
        mp.setattr(st, "user_dir", str(tmp_path))
    try:
        ours = tdev.plan(frame, pps[0], device="cpu")
        assert_plans_equal(ours, jdev.plan(frame, pps[1]))
    finally:
        mp.undo()
    assert ours[0].out_trc[0] == ("icclut" if which == "lut" else "para")


@pytest.mark.parametrize("ext", ["jpg", "png", "tif"])
def test_output_profile_bytes_are_embedded(tmp_path, files, ext):
    from PIL import Image

    from art_tpu_torch.io.dngwrite import write_dng
    from art_tpu_torch.pipeline.develop import process_image

    frame = flagship_frame(64, 96, seed=3)
    dng = str(tmp_path / "in.dng")
    write_dng(dng, np.round(frame.cfa).astype(np.uint16), black=512,
              white=16383, compress=False)
    pp = profile_pp(f"[Color Management]\nOutputProfile={files['para_icc']}"
                    "\n")
    pp.raw.bayer.method = "bilinear"
    out = str(tmp_path / f"out.{ext}")
    process_image(dng, pp, output_path=out, bits=8, device="cpu")
    with open(files["para_icc"], "rb") as f:
        want = f.read()
    assert Image.open(out).info.get("icc_profile") == want
