"""Sharpening of art_tpu_torch against `art_tpu/ops/sharpen.py` on the
same inputs: RL deconvolution, USM and a PSF kernel from a JSON file the
test writes, the PSF loader and its rescale, the automatic RL radius,
post-resize sharpening in the plan, and a develop with both.
"""

import importlib
import json

import numpy as np
import pytest
import torch

from art_tpu.ops import sharpen as jsh
from art_tpu.params import ProcParams
from art_tpu_torch.ops import sharpen as tsh
from art_tpu_torch.params import ProcParams as TorchProcParams
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import clipped_frame, parity

jdev = importlib.import_module("art_tpu.pipeline.develop")

# a function's output in the 0..65535 domain: relative to full scale
# (float32 rounding of the two programs, carried through 20 RL
# iterations or 10 PSF ones)
FN_ATOL = 65535.0 * 2e-5


def image(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0.05, 0.9, (3, h, w)) * 65535.0
    rgb[:, h // 3 : h // 2, :] *= 0.3  # an edge for the blend mask
    return rgb.astype(np.float32)


def plan_both(text, ctx_frame=None):
    """The sharpen op's plan from both packages for an .arp text."""
    out = []
    for cls, mod in ((TorchProcParams, tsh), (ProcParams, jsh)):
        pp = cls()
        pp.apply_arp_text(text)
        out.append(mod.plan(pp, {"working_profile": "Rec2020",
                                 "frame": ctx_frame}))
    return out


def write_psf(path):
    k = np.exp(-0.5 * (np.arange(-3, 4)[:, None] ** 2
                       + np.arange(-3, 4)[None, :] ** 2) / 1.2 ** 2)
    with open(path, "w") as f:
        json.dump(k.tolist(), f)


@pytest.mark.parametrize("text", [
    "[Sharpening]\nEnabled=true\nMethod=rld\nDeconvRadius=0.9\n"
    "DeconvAmount=80\n",
    "[Sharpening]\nEnabled=true\nMethod=usm\nRadius=1.2\nAmount=250\n"
    "Threshold=10;40;2000;1200;\n",
    "[Sharpening]\nEnabled=true\nMethod=usm\nContrast=0\n",
    "[Sharpening]\nEnabled=true\nMethod=psf\nPSFKernel={tmp}/psf.json\n"
    "PSFIterations=10\n",
], ids=["rld", "usm", "usm-no-mask", "psf-json"])
def test_sharpen_matches_reference(tmp_path, text):
    import jax.numpy as jnp

    write_psf(tmp_path / "psf.json")
    (ours, ref) = plan_both(text.replace("{tmp}", str(tmp_path)))
    assert ours[0] == ref[0]
    for k, v in ref[1].items():
        np.testing.assert_array_equal(ours[1][k], v, err_msg=k)
    rgb = image()
    want = np.asarray(jsh.apply(jnp.asarray(rgb), {
        k: jnp.asarray(v) for k, v in ref[1].items()}, ref[0]))
    got = tsh.apply(torch.from_numpy(rgb), {
        k: torch.from_numpy(np.asarray(v)) for k, v in ours[1].items()},
        ours[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FN_ATOL)
    assert np.abs(got - rgb).max() > 100.0  # it sharpened


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("content", ["matrix", "flat", "even", "bad"])
def test_psf_loader(tmp_path, scale, content):
    path = tmp_path / "k.json"
    if content == "matrix":
        write_psf(path)
    elif content == "flat":
        path.write_text(json.dumps(list(np.linspace(0.1, 1, 25))))
    elif content == "even":
        path.write_text(json.dumps(np.ones((4, 4)).tolist()))
    else:
        path.write_text("[1, 2,")
    got = tsh.load_psf_kernel(str(path), scale)
    want = jsh.load_psf_kernel(str(path), scale)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


def test_psf_image_file_is_refused_only_where_it_exists(tmp_path):
    # ported since: an image kernel (PNG, JPEG, GIF or WebP) decodes as
    # in the reference (its green channel, at both scales); a file that
    # is no image is skipped as the reference skips it; an image format
    # the port's decoder does not read (a TGA) is refused naming it
    from PIL import Image

    from art_tpu_torch.io.imagefile import write_png

    assert tsh.load_psf_kernel(str(tmp_path / "missing.png")) is None
    (tmp_path / "k.png").write_bytes(b"\x89PNG\r\n\x1a\n")
    assert tsh.load_psf_kernel(str(tmp_path / "k.png")) is None
    assert jsh.load_psf_kernel(str(tmp_path / "k.png")) is None
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (11, 11, 3)).astype(np.uint8)
    write_png(str(tmp_path / "k.png"), img)
    for scale in (1.0, 2.0):
        got = tsh.load_psf_kernel(str(tmp_path / "k.png"), scale)
        want = jsh.load_psf_kernel(str(tmp_path / "k.png"), scale)
        np.testing.assert_array_equal(got, want)
    # a JPEG PSF loads through the port's JPEG decoder as PIL loads it
    Image.fromarray(img).save(tmp_path / "k.jpg")
    for scale in (1.0, 2.0):
        got = tsh.load_psf_kernel(str(tmp_path / "k.jpg"), scale)
        want = jsh.load_psf_kernel(str(tmp_path / "k.jpg"), scale)
        assert got is not None
        np.testing.assert_array_equal(got, want)
    Image.fromarray(img).save(tmp_path / "k.gif")
    for scale in (1.0, 2.0):
        got = tsh.load_psf_kernel(str(tmp_path / "k.gif"), scale)
        want = jsh.load_psf_kernel(str(tmp_path / "k.gif"), scale)
        assert got is not None
        np.testing.assert_array_equal(got, want)
    Image.fromarray(img).save(tmp_path / "k.webp")
    for scale in (1.0, 2.0):
        got = tsh.load_psf_kernel(str(tmp_path / "k.webp"), scale)
        want = jsh.load_psf_kernel(str(tmp_path / "k.webp"), scale)
        assert got is not None
        np.testing.assert_array_equal(got, want)
    Image.fromarray(img).save(tmp_path / "k.tga")
    for scale in (1.0, 2.0):
        got = tsh.load_psf_kernel(str(tmp_path / "k.tga"), scale)
        want = jsh.load_psf_kernel(str(tmp_path / "k.tga"), scale)
        assert got is not None
        np.testing.assert_array_equal(got, want)
    Image.fromarray(img).save(tmp_path / "k.jp2")
    with pytest.raises(NotImplementedError, match="JPEG 2000 image"):
        tsh.load_psf_kernel(str(tmp_path / "k.jp2"))


def test_auto_radius_matches_reference():
    from art_tpu.pipeline.autos import deconv_auto_radius as ref_fn
    from art_tpu_torch.pipeline.autos import deconv_auto_radius

    frame = clipped_frame(96, 160, seed=1, share=0.05)
    got = deconv_auto_radius(frame)
    assert got is not None and got == ref_fn(frame)
    text = "[Sharpening]\nEnabled=true\nMethod=rld\nDeconvAutoRadius=true\n"
    ours, ref = plan_both(text, frame)
    assert ours[0] == ref[0] == ("rld", got, 20)


def test_post_resize_sharpening_plans_and_develops():
    # capture sharpening (RL) before the resize, output sharpening (USM)
    # after it; no output sharpening without a resize
    text = ("[Sharpening]\nEnabled=true\nMethod=rld\n"
            "[OutputSharpening]\nEnabled=true\nMethod=usm\nAmount=150\n"
            "[Resize]\nEnabled=true\nDataSpecified=3\nWidth=64\nHeight=64\n")
    frame = clipped_frame(64, 96, seed=2, share=0.05)

    def pp_of(cls, resize=True):
        pp = cls()
        pp.raw.bayer.method = "bilinear"
        pp.apply_arp_text(text)
        pp.resize.enabled = resize
        return pp

    (cfg, data), (ref_cfg, ref_data) = (
        tdev.plan(frame, pp_of(TorchProcParams)),
        jdev.plan(frame, pp_of(ProcParams)))
    assert cfg.prsharp == ref_cfg.prsharp == ("usm", 0.5, 0)
    assert [s[0] for s in cfg.steps] == ["sharpen"]
    for k in ("op:sharpen", "op:prsharpen"):
        for kk, v in ref_data[k].items():
            np.testing.assert_array_equal(data[k][kk], v)
    assert tdev.plan(frame, pp_of(TorchProcParams, False))[0].prsharp is None
    assert jdev.plan(frame, pp_of(ProcParams, False))[0].prsharp is None
    out = tdev.develop(frame, pp_of(TorchProcParams), device="cpu").numpy()
    ref = np.asarray(jdev.develop(frame, pp_of(ProcParams)))
    assert out.shape == ref.shape == (3, 43, 64)
    st = parity(out, ref)
    assert st["max_lsb8"] <= 1.0 and st["mean"] <= 2e-4, st
    assert st["within_1lsb8"] >= 0.999, st
