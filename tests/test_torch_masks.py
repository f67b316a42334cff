"""The region masks that need a rasteriser or a file, in art_tpu_torch
against their oracles on the CPU: OpenCV 5.0.0 and Pillow 12.1.0 for the
stand-ins of `masks/raster.py` and the grey decode of
`io/imagefile.py::read_grey`, and `art_tpu` for the area, drawn,
external-file and linked masks (`rasterize_area`, `rasterize_drawn`,
`plan_mask`, `eval_mask` at 64x96), then one masked develop: M1's
profile (`chip_smoke.m1_pp`: Local Contrast under an area mask, Smoothing
NLMeans under the inverted linked mask, Colour Correction under drawn
strokes, Texture Boost under a 16-bit grey PNG) at 256x1024 against the
reference on its exact paths.

Tolerances: the corners, fills and discs equal OpenCV's bit for bit;
the Gaussian within 1e-5 of cv2.GaussianBlur on [0, 1] planes (float32
sums in another order; measured 8e-7); the decode and resample equal
PIL's for L and I;16 and within 1e-6 relative for F (measured equal);
the rasterised planes, the plans' data and the evaluated masks within
1e-5 (measured 1.5e-6 at most), the statics equal, but for a mask
through the external plane's guided filter: its eps of 1e-7 amplifies
the box means' prefix-sum rounding, which differs between PyTorch and
XLA (tests/test_torch_filters.py), bound 1e-4 (measured 2.3e-5); the
develop at
PERF.md section 2's bounds (max <= 1 LSB8, mean <= 2e-4, >= 99.9% within
1 LSB8).
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu import masks as rmasks
from art_tpu.params import ProcParams as RefProcParams
from art_tpu.params.keyfile import KeyFile as RefKeyFile
from art_tpu_torch import masks
from art_tpu_torch.io.imagefile import read_grey
from art_tpu_torch.masks import raster
from art_tpu_torch.params import ProcParams
from art_tpu_torch.params.keyfile import KeyFile
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import flagship_frame, m1_pp, parity, write_mask_png
from tests.test_torch_plan import Develops, plan_key

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")
jdev = importlib.import_module("art_tpu.pipeline.develop")

H, W = 64, 96


@pytest.mark.parametrize("angle", [0.0, 30.0, 45.0, 90.0])
def test_box_points_match_opencv(angle):
    rng = np.random.default_rng(int(angle))
    for _ in range(200):
        c = tuple(rng.uniform(-50.0, 150.0, 2))
        s = tuple(rng.uniform(0.0, 200.0, 2))
        a = -np.degrees(np.radians(angle + rng.choice([0.0, 360.0])))
        ref = cv2.boxPoints((c, s, a))
        got = raster.box_points(c, s, a)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got.astype(np.int32),
                                      ref.astype(np.int32))


def _cv_fill(shape, pts):
    img = np.zeros(shape, np.float32)
    cv2.fillPoly(img, [np.asarray(pts, np.int32)], 1.0)
    return img > 0


POLYGONS = {
    # a non-convex dart and a self-crossing star, inside the frame
    "non-convex": [[10, 50], [40, 5], [70, 50], [40, 30]],
    "star": [[48, 2], [60, 60], [5, 22], [90, 22], [35, 60]],
    # leaving the frame on every side
    "clipped": [[-30, 10], [50, -20], [130, 30], [60, 90], [-10, 70]],
    "outside": [[-40, -40], [-5, -30], [-20, -2]],
}


@pytest.mark.parametrize("angle", [0.0, 30.0, 45.0, 90.0])
def test_fill_poly_matches_opencv_on_rotated_boxes(angle):
    rng = np.random.default_rng(7 + int(angle))
    for _ in range(40):
        c = tuple(rng.uniform(-20.0, W + 20.0, 2))
        s = tuple(rng.uniform(2.0, 120.0, 2))
        pts = raster.box_points(c, s, -angle).astype(np.int32)
        np.testing.assert_array_equal(raster.fill_poly((H, W), pts),
                                      _cv_fill((H, W), pts))


@pytest.mark.parametrize("name", sorted(POLYGONS))
def test_fill_poly_matches_opencv(name):
    pts = POLYGONS[name]
    np.testing.assert_array_equal(raster.fill_poly((H, W), pts),
                                  _cv_fill((H, W), pts))


def test_fill_poly_matches_opencv_on_random_polygons():
    rng = np.random.default_rng(11)
    for _ in range(300):
        h, w = rng.integers(5, 70, 2)
        n = rng.integers(3, 9)
        pts = np.stack([rng.integers(-w, 2 * w, n),
                        rng.integers(-h, 2 * h, n)], 1)
        np.testing.assert_array_equal(raster.fill_poly((h, w), pts),
                                      _cv_fill((h, w), pts))


@pytest.mark.parametrize("radius", [1, 2, 7, 30])
def test_fill_circles_match_opencv(radius):
    rng = np.random.default_rng(radius)
    for _ in range(30):
        centers = rng.integers(-40, 130, (rng.integers(1, 6), 2))
        ref = np.zeros((H, W), np.uint8)
        for cx, cy in centers:
            cv2.circle(ref, (int(cx), int(cy)), radius, 1, -1)
        got = np.zeros((H, W), bool)
        cover = raster.circle_cover((H, W), centers, radius)
        if cover is not None:
            got[cover[0]] = cover[1]
        np.testing.assert_array_equal(got, ref > 0)


@pytest.mark.parametrize("sigma", [0.35, 1.0, 6.9, 40.0])
def test_gaussian_blur_matches_opencv(sigma):
    rng = np.random.default_rng(3)
    for plane in (rng.uniform(0.0, 1.0, (H, W)),
                  (rng.uniform(0.0, 1.0, (H, W)) > 0.8)):
        a = plane.astype(np.float32)
        ref = cv2.GaussianBlur(a, (0, 0), sigma)
        got = raster.gaussian_blur(torch.from_numpy(a), sigma).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def _image(kind, h, w, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "L":
        return Image.fromarray(rng.integers(0, 256, (h, w), np.uint8))
    if kind == "I;16":
        return Image.fromarray(rng.integers(0, 65536, (h, w), np.uint16))
    if kind == "F":
        return Image.fromarray(rng.uniform(-0.2, 1.2, (h, w)).astype(
            np.float32))
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))


DECODES = [("L", "png"), ("I;16", "png"), ("I;16", "tif"), ("F", "tif"),
           ("RGB", "png")]


@pytest.mark.parametrize("size", [(23, 37), (160, 96)],
                         ids=["downscale", "upscale"])
@pytest.mark.parametrize("kind,ext", DECODES,
                         ids=[f"{k}-{e}" for k, e in DECODES])
def test_grey_decode_and_resize_match_pil(tmp_path, kind, ext, size):
    path = str(tmp_path / f"mask.{ext}")
    _image(kind, 53, 71).save(path)
    im = Image.open(path)
    if im.mode not in ("L", "I;16", "F"):
        im = im.convert("RGB")
    ref = np.asarray(im.resize(size, Image.BILINEAR))
    if ref.ndim == 3:
        ref = ref[..., 1]
    plane, mode = read_grey(path)
    assert mode == (kind if kind != "RGB" else "L")
    got = raster.pil_resize_bilinear(plane, mode, size, "cpu").numpy()
    if mode == "F":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      ref.astype(np.int64))


AREAS = {
    "rect-feather-add": [dict(type="rectangle", x=-10, y=20, width=60,
                              height=40, angle=30, shapefeather=25,
                              mode="add")],
    "polygon-subtract": [
        dict(type="rect", x=0, y=0, width=90, height=90, angle=0,
             shapefeather=0, mode="add"),
        dict(type="polygon", knots=[-40, -60, 0, 10, -20, 0, 40, -70, 0,
                                    20, 10, 0, -30, 0, 0],
             shapefeather=5, mode="subtract")],
    "gradient-intersect": [
        dict(type="rectangle", x=5, y=-5, width=80, height=70, angle=45,
             shapefeather=10, mode="add"),
        dict(type="gradient", x=10, y=-20, angle=35, strengthstart=90,
             strengthend=10, shapefeather=40, mode="intersect")],
    "clipped-polygon-few-knots": [
        dict(type="polygon", knots=[-120, -10, 0, 60, -130, 0, 140, 90, 0,
                                    -20, 150, 0], shapefeather=0,
             mode="add"),
        dict(type="polygon", knots=[0, 0, 0, 10, 10, 0], mode="add")],
}


@pytest.mark.parametrize("name", sorted(AREAS))
def test_rasterize_area_matches_reference(name):
    shapes = AREAS[name]
    ref = rmasks.rasterize_area(shapes, H, W)
    got = masks.rasterize_area(shapes, H, W)
    assert got.dtype == ref.dtype == np.float32
    assert ref.max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


STROKES = ("5;0.2;1;1;0.1;0.2;0.3;0.25;0.5;0.3;0.7;0.25;0.9;0.2;"
           "3;0.3;1;0.6;0.2;0.8;0.5;0.7;0.8;0.8;"
           "4;0.1;0;1;0.3;0.25;0.4;0.27;0.5;0.3;0.6;0.28;")
DRAWN = {
    "intersect": dict(drawn_mode=0),
    "add": dict(drawn_mode=1, drawn_smoothness=0.5, drawn_feather=20,
                drawn_contrast=[1, 0, 0, 0.3, 0.2, 0.7, 0.85, 1, 1]),
    "add-bounded": dict(drawn_mode=2, drawn_feather=40),
    "add-curve-only": dict(drawn_mode=1,
                           drawn_contrast=[1, 0, 0, 0.5, 0.9, 1, 1]),
}


def _drawn_spec(mod, **kw):
    return mod.MaskSpec(drawn_enabled=True, drawn_strokes=[
        float(v) for v in STROKES.strip(";").split(";")], **kw)


@pytest.mark.parametrize("name", sorted(DRAWN))
def test_rasterize_drawn_matches_reference(name):
    ref = rmasks.rasterize_drawn(_drawn_spec(rmasks, **DRAWN[name]), H, W)
    got = masks.rasterize_drawn(_drawn_spec(masks, **DRAWN[name]), H, W)
    assert got.dtype == ref.dtype == np.float32
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


# one region group of each kind, planned in a [Local Contrast] group with
# a second tool's named masks for the linked ones
KINDS = {
    "area": "AreaMaskEnabled_1=true\nAreaMaskBlur_1=1.5\n"
            "AreaMask0Type_1=rectangle\nAreaMask0X_1=10\n"
            "AreaMask0Width_1=60\nAreaMask0Height_1=50\n"
            "AreaMask0Angle_1=30\nAreaMask0ShapeFeather_1=25\n",
    "drawn": "DrawnMaskEnabled_1=true\nDrawnMaskMode_1=2\n"
             "DrawnMaskOpacity_1=0.8\nDrawnMaskFeather_1=10\n"
             f"DrawnMaskStrokes_1={STROKES}\n",
    "external": "ExternalMaskEnabled_1=true\nExternalMaskFilename_1={file}\n"
                "ExternalMaskFeather_1=20\nExternalMaskInverted_1=true\n",
    "linked": "LinkedMaskEnabled_1=true\nLinkedMask_1=smoothing|sky\n"
              "LinkedMaskInverted_1=true\n"
              "[Smoothing]\nEnabled=true\nMode_1=1\nMaskName_1=sky\n"
              "ParametricMaskEnabled_1=true\n"
              "LightnessMask_1=1;0;0.2;0.35;0.35;1;0.9;0.35;0.35;\n"
              "Mode_2=1\nMaskName_2=sky\nAreaMaskEnabled_2=true\n"
              "AreaMask0Type_2=gradient\nAreaMask0Angle_2=20\n"
              "AreaMask0StrengthStart_2=100\nAreaMask0StrengthEnd_2=10\n"
              "ExternalMaskEnabled_2=true\n"
              "ExternalMaskFilename_2={file}\n",
    "all": "MaskCurve_1=1;0;0;0.5;0.8;1;1;\nMaskPosterization_1=3\n"
           "MaskOpacity_1=0.9\nDrawnMaskEnabled_1=true\n"
           "DrawnMaskMode_1=1\n"
           f"DrawnMaskStrokes_1={STROKES}\n"
           "AreaMaskEnabled_1=true\nAreaMask0Type_1=gradient\n"
           "AreaMask0Angle_1=-30\nAreaMask0StrengthStart_1=100\n"
           "AreaMask0StrengthEnd_1=30\nAreaMask0ShapeFeather_1=50\n"
           "ExternalMaskEnabled_1=true\nExternalMaskFilename_1={file}\n"
           "LinkedMaskEnabled_1=true\nLinkedMask_1=smoothing|sky\n"
           "[Smoothing]\nEnabled=true\nMode_1=1\nMaskName_1=sky\n"
           "DeltaEMaskEnabled_1=true\nDeltaEMaskL_1=50\n",
}


def _region(text, kind_file):
    """The first Local Contrast region's MaskSpec of `text` in both
    packages, with their ProcParams."""
    out = []
    for pp_cls, mod, kf_cls in ((ProcParams, masks, KeyFile),
                                (RefProcParams, rmasks, RefKeyFile)):
        pp = pp_cls()
        pp.apply_arp_text("[Local Contrast]\nEnabled=true\nContrast_1=30\n"
                          + text.format(file=kind_file))
        kf = kf_cls()
        kf.groups["Local Contrast"] = dict(pp.extra["Local Contrast"])
        out += [mod.MaskSpec.from_keyfile(kf, "Local Contrast", "_1"), pp]
    return out


def assert_mask_plans_equal(ours, ref):
    (st, data), (rst, rdata) = ours, ref
    assert st == rst
    assert sorted(data) == sorted(rdata)
    for k, rv in rdata.items():
        ov = np.asarray(data[k])
        assert ov.shape == np.shape(rv) and ov.dtype == np.asarray(rv).dtype
        np.testing.assert_allclose(ov, rv, rtol=0, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def mask_file(tmp_path_factory):
    return write_mask_png(str(tmp_path_factory.mktemp("m") / "mask.png"),
                          60, 80)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plan_mask_matches_reference(mask_file, kind):
    m, pp, rm, rpp = _region(KINDS[kind], mask_file)
    ours = masks.plan_mask(m, (H, W), pp)
    ref = rmasks.plan_mask(rm, (H, W), rpp)
    assert_mask_plans_equal(ours, ref)
    assert ours[1]


@pytest.fixture(scope="module")
def rgb():
    x = np.random.default_rng(4).uniform(0.0, 1.0, (3, H, W)) ** 2
    return (x * 60000).astype(np.float32)


def _ws():
    from art_tpu_torch.color import colorspaces as cs

    return cs.MATRICES_RGB_TO_XYZ["Rec2020"].astype(np.float32)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_eval_mask_matches_reference(mask_file, rgb, kind):
    m, pp, rm, rpp = _region(KINDS[kind], mask_file)
    st, data = masks.plan_mask(m, (H, W), pp)
    rst, rdata = rmasks.plan_mask(rm, (H, W), rpp)
    got = masks.eval_mask(torch.from_numpy(rgb), torch.from_numpy(_ws()),
                          st, tdev.data_to_torch(data, "cpu")).numpy()
    # op by op: jitted, XLA's CPU code fuses the guided filter's
    # multiply-adds, which PyTorch does not
    with jax.disable_jit():
        ref = np.asarray(rmasks.eval_mask(jnp.asarray(rgb),
                                          jnp.asarray(_ws()), rst, rdata))
    assert ref.max() - ref.min() > 0.1
    # the external plane's guided filter (ext_radius > 0) divides by the
    # local variance plus 1e-7, which amplifies the box means' prefix-sum
    # rounding (PyTorch's CPU cumsum in double, XLA's in float32:
    # tests/test_torch_filters.py); every other part within 1e-5
    atol = 1e-4 if st[11] > 0 else 1e-5
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_linked_mask_takes_the_last_mask_of_a_name():
    # two enabled masks named "sky" in the Smoothing group, and a
    # disabled third: the reference's registry keeps the last enabled one
    text = ("LinkedMaskEnabled_1=true\nLinkedMask_1=smoothing|sky\n"
            "[Smoothing]\nEnabled=true\nMode_1=1\nMaskName_1=sky\n"
            "MaskInverted_1=true\n"
            "Mode_2=1\nMaskName_2=sky\nMaskPosterization_2=2\n"
            "Mode_3=1\nMaskName_3=sky\nMaskEnabled_3=false\n"
            "MaskOpacity_3=0.5\n")
    m, pp, rm, rpp = _region(text, "")
    ours = masks.plan_mask(m, (H, W), pp)
    assert_mask_plans_equal(ours, rmasks.plan_mask(rm, (H, W), rpp))
    assert ours[0][12][7] == 2 and not ours[0][12][4]
    reg = masks.build_mask_registry(pp)
    assert sorted(reg) == sorted(rmasks.build_mask_registry(rpp))
    assert [dataclasses.asdict(v) for v in reg.values()] == [
        dataclasses.asdict(v) for v in rmasks.build_mask_registry(
            rpp).values()]


@pytest.fixture(scope="module")
def develops(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    return Develops(root / "plan_develops")


def test_m1_develops_as_the_exact_reference(tmp_path, develops):
    from tests.test_torch_lens import _ref_exact_develop

    frame = flagship_frame(256, 1024, seed=5)
    mask = write_mask_png(str(tmp_path / "mask.png"))
    pp, ref_pp = m1_pp(mask), m1_pp(mask, RefProcParams())
    cfg, data = tdev.plan(frame, pp, device="cpu")
    ref_cfg, ref_data = jdev.plan(frame, ref_pp)
    steps = [s[0] for s in cfg.steps]
    assert steps == [s[0] for s in ref_cfg.steps]
    for op in ("localcontrast", "smoothing", "colorcorrection",
               "textureboost"):
        assert op in steps, steps
    key = plan_key(cfg, data)
    out = develops.get("port", key, lambda: tdev.develop(
        frame, pp, device="cpu").numpy())
    ref = develops.get("ref-exact", key,
                       lambda: _ref_exact_develop(frame, ref_pp))
    st = parity(out, ref)
    print("M1 port vs exact reference", st)
    assert out.shape == (3, 256, 1024)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st
