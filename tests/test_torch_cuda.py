"""CUDA kernels of art_tpu_torch against their plain PyTorch versions, on
the card. Imports no JAX, so it runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(`--noconftest`: tests/conftest.py sets up JAX for the reference's
tests). Without a CUDA device every test here skips.
"""

import os

import numpy as np
import pytest
import torch

from art_tpu_torch.core.curve1d import fit_curve, fit_gamma_split, split_poly
from art_tpu_torch.core.image import synthesize_bayer
from art_tpu_torch.demosaic import amaze
from art_tpu_torch.demosaic import amaze_kernel as ak
from art_tpu_torch.ops import denoise as tdn
from art_tpu_torch.ops import nlmeans_kernel as nk
from art_tpu_torch.ops import tonecurve as ttc
from art_tpu_torch.ops import tonecurve_neutral as ttn
from art_tpu_torch.ops import wavelet_kernel as wk
from art_tpu_torch.params import ProcParams
from art_tpu_torch.pipeline import develop as tdev
from chip_smoke import (IMPULSE_FLIPS, clamp_share, config3_pp,
                        impulse_masks, impulse_parity)

ARP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "art_tpu_torch", "data", "profiles",
    "Standard Film Curve.arp")
LUM_W = np.array([0.2790177, 0.6753402, 0.0456377], np.float32)
CAM2WORK = np.array([[0.6274, 0.3293, 0.0433],
                     [0.0691, 0.9195, 0.0114],
                     [0.0164, 0.0880, 0.8954]], np.float32)
MULTS = np.array([1.9, 1.0, 1.45], np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def flagship_pp(method="bilinear"):
    pp = ProcParams()
    with open(ARP) as f:
        pp.apply_arp_text(f.read())
    pp.raw.bayer.method = method
    pp.denoise.enabled = True
    pp.denoise.luminance = 20.0
    pp.denoise.chrominance = 20.0
    return pp


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    base = 0.2 + 0.5 * (0.6 * x + 0.4 * y) + 0.15 * ((np.floor(x * 8) % 2)
                                                     == 0)
    rgb = np.stack([base, base * 1.05, base * 0.9]) * np.array(
        [0.5, 1.0, 0.7], np.float32)[:, None, None]
    rgb = rgb + rng.normal(0, 0.01, size=rgb.shape)
    return (np.clip(rgb, 0.005, 1.0) * 40000).astype(np.float32)


# B4 cases: (shape, raw head, sigmas, constant input). The kernel's blocks
# take 32-64 x 128 tiles of the padded plane and 32 x 128 tiles of each
# sigma window; the image widths 1100 and 1216 are no multiple of them
# (the padded planes are), 300 rows pad to 512, a constant frame has
# sigma 0 (every gain e9 / (e9 + 1e-12)), and pinned sigmas (>= 0) skip
# the MAD passes of their plane
WAVELET_RGB_CASES = [((256, 2048), True, [-1.0] * 3, False),
                     ((512, 1024), True, [-1.0] * 3, False),
                     ((300, 1152), True, [-1.0] * 3, False),
                     ((256, 1100), True, [-1.0] * 3, False),
                     ((256, 1024), False, [-1.0] * 3, False),
                     ((300, 1216), True, [-1.0] * 3, False),
                     ((256, 1024), True, [-1.0] * 3, True),
                     ((512, 2048), True, [0.02, -1.0, 0.0], False)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,pre,sigmas,flat", WAVELET_RGB_CASES,
    ids=["256x2048", "512x1024", "300x1152-tile-pad", "256x1100",
         "256x1024-no-head", "300x1216-tile-pad", "constant",
         "pinned-and-mad"])
def test_wavelet_kernel_matches_plain(cuda_device, shape, pre, sigmas,
                                      flat):
    rgb = torch.from_numpy(_scene(*shape, 9)).to(cuda_device)
    if flat:
        rgb = torch.full_like(rgb, 20000.0)
    gf, gi = fit_gamma_split(1.7)
    args = (rgb, LUM_W, np.float32(1.0), gf, gi, sigmas,
            [0.8, 1.4, 0.45], [0.3, 0.0, 0.0])
    kw = {"pre": (MULTS, CAM2WORK) if pre else None}
    before = wk.wavelet_denoise_rgb.launches
    out = wk.wavelet_denoise_rgb(*args, **kw)
    torch.cuda.synchronize()
    assert wk.wavelet_denoise_rgb.launches == before + 1
    plain = wk.wavelet_rgb_plain(rgb, *wk.prepare(*args, **kw))
    # built without FMA contraction, same operation order, the same
    # bisection counts (from the leaf histogram): equal
    assert torch.equal(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("epi,cheb", [(None, False), ("srgb", False),
                                      ("srgb", True), ("linear", False)],
                         ids=["split", "split-epi", "cheb-epi",
                              "linear-epi"])
def test_neutral_kernel_matches_plain(cuda_device, epi, cheb):
    pp = flagship_pp()
    _, data = ttc.plan(pp, {"working_profile": "Rec2020"})
    coeffs = data["coeffs"]
    if cheb:
        lut = ttc.compose_luts([ttc.adjust_user_curve(pp.tone_curve.curve)])
        coeffs = fit_curve(lut)[None]
    params = data["params"]
    if epi:
        w2o = np.linalg.inv(ttn.cs.MATRICES_RGB_TO_XYZ["sRGB"]) @ \
            ttn.cs.MATRICES_RGB_TO_XYZ["Rec2020"]
        params = np.concatenate([params, w2o.astype(np.float32).ravel()])
    rng = np.random.default_rng(4)
    rgb = torch.from_numpy((rng.uniform(-0.05, 1.15, size=(3, 128, 256))
                            * 65535).astype(np.float32)).to(cuda_device)
    p = torch.from_numpy(params).to(cuda_device)
    c = torch.from_numpy(coeffs).to(cuda_device)
    before = ttn.neutral_tone.launches
    out = ttn.neutral_tone(rgb, p, c, epi)
    torch.cuda.synchronize()
    assert ttn.neutral_tone.launches == before + 1
    plain = ttn.neutral_plain(rgb, p, c, epi)
    # built without FMA contraction, same operation order and the same
    # libdevice exp/sqrt as PyTorch's kernels: equal
    assert torch.equal(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern,gain", [("RGGB", 1.0), ("GBRG", 1.6),
                                          ("BGGR", 1.25), ("GRBG", 1.0)])
def test_amaze_kernels_match_plain(cuda_device, pattern, gain):
    rng = np.random.default_rng(11)
    cfa = np.minimum(rng.uniform(0.01, 1.1, (300, 520)) * 65535, 65535.0)
    x = amaze.padded_plane(
        torch.from_numpy(cfa.astype(np.float32)).to(cuda_device))
    clips = amaze.clip_points(np.float32(gain), cuda_device)
    before = (ak.amaze_stage1.launches, ak.amaze_stage2.launches,
              ak.amaze_stage3.launches)
    # each kernel is fed the plain version's output of the stage before
    p1 = amaze.stage1_plain(x, pattern, clips)
    p2 = amaze.stage2_plain(x, pattern, p1)
    p3 = amaze.stage3_plain(x, pattern, p2, clips)
    k1 = ak.amaze_stage1(x, pattern, clips)
    k2 = ak.amaze_stage2(x, pattern, p1)
    k3 = ak.amaze_stage3(x, pattern, p2, clips)
    torch.cuda.synchronize()
    assert (ak.amaze_stage1.launches, ak.amaze_stage2.launches,
            ak.amaze_stage3.launches) == tuple(b + 1 for b in before)
    assert k3.shape == (3, 300, 520)
    # built without FMA contraction, same operation order, correctly
    # rounded reciprocals on both sides: equal
    assert torch.equal(k1, p1)
    assert torch.equal(k2, p2)
    assert torch.equal(k3, p3)


def _extremes(rgb):
    """Write extreme pixels into the first columns of a (3, H, W) stack:
    zero chroma, black, negative, far past white, one primary."""
    rgb[:, :, :4] = rgb[0, :, :4]
    rgb[:, :2, 4:8] = 0.0
    rgb[:, 2:4, 4:8] = -1000.0
    rgb[:, 4:6, 4:8] = 3e5
    rgb[0, 6:8, 4:8], rgb[1:, 6:8, 4:8] = 1e6, 0.0
    return rgb


def _form_coeffs(rows, k):
    """Coefficients of the flagship curve in a form the planner fits: the
    even/odd split of half degree k - 1 or the Chebyshev series of
    degree k - 1, on the sqrt warp (core/curve1d.py)."""
    lut = ttc.compose_luts([ttc.adjust_user_curve(
        flagship_pp().tone_curve.curve)])
    n = len(lut)

    def fn_t(t):
        return np.interp(((t + 1.0) / 2.0) ** 2, np.linspace(0, 1, n), lut)

    if rows == 2:
        return split_poly(fn_t, k - 1)
    t = np.linspace(-1.0, 1.0, 4097)
    return np.polynomial.chebyshev.chebfit(t, fn_t(t), k - 1).astype(
        np.float32)[None]


def _neutral_equal(device, shape, form, epi, seed):
    _, data = ttc.plan(flagship_pp(), {"working_profile": "Rec2020"})
    params = data["params"]
    if epi:
        w2o = np.linalg.inv(ttn.cs.MATRICES_RGB_TO_XYZ["sRGB"]) @ \
            ttn.cs.MATRICES_RGB_TO_XYZ["Rec2020"]
        params = np.concatenate([params, w2o.astype(np.float32).ravel()])
    rng = np.random.default_rng(seed)
    rgb = _extremes((rng.uniform(-0.05, 1.15, size=shape) * 65535).astype(
        np.float32))
    rgb = torch.from_numpy(rgb).to(device)
    p = torch.from_numpy(params).to(device)
    c = torch.from_numpy(_form_coeffs(*form)).to(device)
    assert tuple(c.shape) == form
    before = ttn.neutral_tone.launches
    out = ttn.neutral_tone(rgb, p, c, epi)
    torch.cuda.synchronize()
    assert ttn.neutral_tone.launches == before + 1
    # the same operations in the same order, -fmad=false: equal
    assert torch.equal(out, ttn.neutral_plain(rgb, p, c, epi))


# every instantiation of the kernel: each curve form the planner fits,
# each epilogue; 96 x 258 pixels
@pytest.mark.cuda
@pytest.mark.parametrize("epi", [None, "srgb", "linear"])
@pytest.mark.parametrize("form", ttn.KERNEL_FORMS,
                         ids=[f"{r}x{k}" for r, k in ttn.KERNEL_FORMS])
def test_neutral_kernel_every_instantiation(cuda_device, form, epi):
    _neutral_equal(cuda_device, (3, 96, 258), form, epi, 5)


# 97 x 131 pixels, odd: the planes start off 8-byte alignment, and the
# last block is ragged
@pytest.mark.cuda
@pytest.mark.parametrize("form,epi", [((2, 11), None), ((1, 32), "srgb"),
                                      ((2, 17), "linear")])
def test_neutral_kernel_odd_pixel_count(cuda_device, form, epi):
    _neutral_equal(cuda_device, (3, 97, 131), form, epi, 8)


# B1's fused kernel: 32 x 64 tiles of the padded plane, x copied 16
# bytes at a time where the plane's width is a multiple of 4 and the tile
# is inside it, else 4 bytes at a time through wrapped indices. 257 x 430
# pads to 305 x 478 (ragged tiles at both far edges, 4-byte copies); 301
# x 523 to an odd 349 x 571 (the wrap's seam puts like colours side by
# side); 300 x 1000 to 348 x 1048 (16-byte copies inside); 64 x 65 to 112
# x 113, two tiles a column. Gain 1.6 fires stage 2's clip mask and the
# bound's clip branch over much of the plane
@pytest.mark.cuda
@pytest.mark.parametrize("gain", [1.0, 1.6])
@pytest.mark.parametrize("shape,stripes,pattern", [
    ((300, 520), True, "RGGB"), ((257, 430), False, "GRBG"),
    ((301, 523), True, "GBRG"), ((300, 1000), True, "BGGR"),
    ((64, 65), False, "RGGB")],
    ids=["stripes", "ragged", "odd", "wide", "one-tile"])
def test_amaze_stage1_kernel_matches_plain(cuda_device, shape, stripes,
                                           pattern, gain):
    rng = np.random.default_rng(13)
    cfa = rng.uniform(0.01, 1.1, shape) * 65535
    if stripes:
        cfa[40:200, 60:400] = np.where(np.arange(60, 400) % 2, 60000.0,
                                       3000.0)
    x = amaze.padded_plane(torch.from_numpy(
        np.minimum(cfa, 65535.0).astype(np.float32)).to(cuda_device))
    clips = amaze.clip_points(np.float32(gain), cuda_device)
    before = ak.amaze_stage1.launches
    out = ak.amaze_stage1(x, pattern, clips)
    torch.cuda.synchronize()
    assert ak.amaze_stage1.launches == before + 1
    assert out.shape == (3, *x.shape)
    # the same operations in the same order, -fmad=false, correctly
    # rounded reciprocals: equal
    assert torch.equal(out, amaze.stage1_plain(x, pattern, clips))


# B3's fused kernel: 32 x 64 output tiles of the cropped output, copied
# 16 bytes at a time where the plane's width is a multiple of 4 and the
# tile is inside it, else 4 bytes at a time. 257 x 430 pads to 305 x 478
# (ragged tiles at both far edges, 4-byte copies); 301 x 523 to an odd
# 349 x 571; 300 x 1000 to 348 x 1048 (16-byte copies inside); stripes
# make stage 2's Nyquist test fire
@pytest.mark.cuda
@pytest.mark.parametrize("shape,stripes,pattern", [
    ((300, 520), True, "RGGB"), ((257, 430), False, "GRBG"),
    ((301, 523), True, "GBRG"), ((300, 1000), True, "BGGR"),
    ((64, 65), False, "RGGB")],
    ids=["stripes", "ragged", "odd", "wide", "one-tile"])
def test_amaze_stage3_kernel_matches_plain(cuda_device, shape, stripes,
                                           pattern):
    rng = np.random.default_rng(13)
    cfa = rng.uniform(0.01, 1.1, shape) * 65535
    if stripes:
        cfa[40:200, 60:400] = np.where(np.arange(60, 400) % 2, 60000.0,
                                       3000.0)
    x, s1 = _stage2_inputs(cfa, pattern, cuda_device)
    s2 = amaze.stage2_plain(x, pattern, s1)
    clips = amaze.clip_points(np.float32(1.25), cuda_device)
    before = ak.amaze_stage3.launches
    out = ak.amaze_stage3(x, pattern, s2, clips)
    torch.cuda.synchronize()
    assert ak.amaze_stage3.launches == before + 1
    assert out.shape == (3, *shape)
    # the same operations in the same order, -fmad=false, correctly
    # rounded reciprocals: equal
    assert torch.equal(out, amaze.stage3_plain(x, pattern, s2, clips))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bilinear", "amaze"])
def test_develop_on_card_matches_cpu(cuda_device, method):
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0.02, 0.95, size=(3, 256, 1024)).astype(np.float32)
    frame = synthesize_bayer(rgb, pattern="RGGB")
    counted = (wk.wavelet_denoise_rgb, ttn.neutral_tone, ak.amaze_stage1,
               ak.amaze_stage2, ak.amaze_stage3)
    plains = (wk.wavelet_rgb_plain, ttn.neutral_plain, amaze.stage1_plain,
              amaze.stage2_plain, amaze.stage3_plain)
    before = [f.launches for f in counted]
    plain_before = [f.calls for f in plains]
    out = tdev.develop(frame, flagship_pp(method))
    torch.cuda.synchronize()
    assert out.device.type == "cuda"
    want = [1, 1] + [int(method == "amaze")] * 3
    assert [f.launches - b for f, b in zip(counted, before)] == want
    assert [f.calls for f in plains] == plain_before
    cpu = tdev.develop(frame, flagship_pp(method), device="cpu")
    d = (out.cpu().double() - cpu.double()).abs()
    assert d.max().item() <= 1.0 / 255.0
    assert d.mean().item() <= 2e-4
    assert (d * 255 <= 1.0).double().mean().item() >= 0.999



# B5 cases: (shape, sigmas, plane 0 constant). 256 x 1024 tiles on the
# reflect-padded plane: 300 x 1100 pads to 512 x 2048, 512 x 3072 is a
# grid of 2 x 3 tiles; a constant plane has sigma 0
WAVELET_MULTI_CASES = [((3, 256, 1024), [-1.0] * 3, False),
                       ((3, 300, 1100), [-1.0] * 3, False),
                       ((2, 512, 2048), [0.05, -1.0], False),
                       ((3, 512, 3072), [-1.0] * 3, False),
                       ((3, 256, 1024), [-1.0] * 3, True),
                       ((3, 300, 2100), [0.0, -1.0, 0.03], False)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,sigmas,flat", WAVELET_MULTI_CASES,
    ids=["3x256x1024", "3x300x1100-tile-pad", "pinned-and-mad",
         "2x3-tiles", "constant-plane", "300x2100-pinned-zero"])
def test_wavelet_multi_kernel_matches_plain(cuda_device, shape, sigmas,
                                            flat):
    rng = np.random.default_rng(6)
    x = rng.normal(0.5, 0.1, shape).astype(np.float32)
    if flat:
        x[0] = 0.3
    x = torch.from_numpy(x).to(cuda_device)
    c = shape[0]
    args = (x, sigmas, [0.8, 1.4, 0.45][-c:], [0.3, 0.0, 0.0][-c:])
    before = wk.wavelet_denoise_multi.launches
    out = wk.wavelet_denoise_multi(*args)
    torch.cuda.synchronize()
    assert wk.wavelet_denoise_multi.launches == before + 1
    prm = torch.tensor([args[1], args[2], args[3]], device=cuda_device)
    # built without FMA contraction, same operation order, the same
    # bisection counts (from the leaf histogram): equal
    assert torch.equal(out, wk.wavelet_multi_plain(x, prm))


def _nlmeans_planes(shape, device):
    rng = np.random.default_rng(7)
    y = torch.from_numpy(np.clip(rng.normal(0.5, 0.02, shape), 0, 1)
                         .astype(np.float32)).to(device)
    mi = tdn.nl_maskinv(y, torch.tensor(0.00287, device=device),
                        torch.tensor(0.5, device=device))
    return y, mi


def _nlmeans_equal(y, mi):
    before = nk.nlmeans.launches
    out = nk.nlmeans(y, mi)
    torch.cuda.synchronize()
    assert nk.nlmeans.launches == before + 1
    # same order, -fmad=false, the libdevice expf that torch.exp calls:
    # equal
    assert torch.equal(out, nk.nlmeans_plain(y, mi))


# the kernel's blocks write 112 x 32 tiles (4 x 2 warps of 28 columns,
# strips of 16 rows): 256 x 256 is the smallest plane the wrapper takes,
# 257 x 301 is off the strips and the warps, 1000 x 1030 a grid of blocks
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512), (300, 520), (256, 256),
                                   (257, 301), (1000, 1030)])
def test_nlmeans_kernel_matches_plain(cuda_device, shape):
    _nlmeans_equal(*_nlmeans_planes(shape, cuda_device))


# a constant plane (every box 0, every weight 1), and a maskinv so large
# that min(box * maskinv, 50) clamps wherever the box is not 0
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["constant", "clamp"])
def test_nlmeans_kernel_edge_planes(cuda_device, case):
    y, mi = _nlmeans_planes((300, 520), cuda_device)
    if case == "constant":
        y = torch.full_like(y, 0.4)
    else:
        mi = mi * 1e4
        assert clamp_share(y, mi) > 0.5
    _nlmeans_equal(y, mi)


def _stage2_inputs(cfa, pattern, device):
    x = amaze.padded_plane(torch.from_numpy(
        np.minimum(cfa, 65535.0).astype(np.float32)).to(device))
    s1 = amaze.stage1_plain(x, pattern,
                            amaze.clip_points(np.float32(1.0), device))
    return x, s1


# B2's fused kernel: 32 x 64 output tiles over the padded plane, copied
# 16 bytes at a time where the plane's width is a multiple of 4 and the
# tile is inside it, else 4 bytes at a time through wrapped indices.
# A block of one-pixel stripes makes the Nyquist test fire; 257 x 430
# pads to 305 x 478 (ragged tiles at both edges, 4-byte copies); 301 x
# 523 pads to an odd 349 x 571 (the wrap's seam puts like colours side
# by side); 300 x 1000 pads to 348 x 1048 (16-byte copies inside)
@pytest.mark.cuda
@pytest.mark.parametrize("shape,stripes", [((300, 520), True),
                                           ((257, 430), False),
                                           ((301, 523), True),
                                           ((300, 1000), True)],
                         ids=["stripes", "ragged", "odd", "wide"])
def test_amaze_stage2_kernel_matches_plain(cuda_device, shape, stripes):
    rng = np.random.default_rng(12)
    cfa = rng.uniform(0.01, 1.1, shape) * 65535
    if stripes:
        cfa[40:200, 60:400] = np.where(np.arange(60, 400) % 2, 60000.0,
                                       3000.0)
    x, s1 = _stage2_inputs(cfa, "BGGR", cuda_device)
    if stripes:
        share = amaze.nyquist_masks(x, "BGGR", s1)[1].mean().item()
        assert share > 0.01
    before = ak.amaze_stage2.launches
    out = ak.amaze_stage2(x, "BGGR", s1)
    torch.cuda.synchronize()
    assert ak.amaze_stage2.launches == before + 1
    # the same operations in the same order, -fmad=false, correctly
    # rounded reciprocals: equal
    assert torch.equal(out, amaze.stage2_plain(x, "BGGR", s1))


@pytest.mark.cuda
@pytest.mark.parametrize("smoothing", [True, False])
def test_config3_develop_on_card_matches_cpu(cuda_device, smoothing):
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0.02, 0.95, size=(3, 256, 1024)).astype(np.float32)
    frame = synthesize_bayer(rgb, pattern="RGGB")
    counted = (wk.wavelet_denoise_rgb, wk.wavelet_denoise_multi, nk.nlmeans)
    plains = (wk.wavelet_rgb_plain, wk.wavelet_multi_plain, nk.nlmeans_plain)
    before = [f.launches for f in counted]
    plain_before = [f.calls for f in plains]
    with impulse_masks() as masks:
        out = tdev.develop(frame, config3_pp(smoothing=smoothing))
        torch.cuda.synchronize()
        want = [0, 1, 1] if smoothing else [1, 0, 0]
        assert [f.launches - b for f, b in zip(counted, before)] == want
        assert [f.calls for f in plains] == plain_before
        cpu = tdev.develop(frame, config3_pp(smoothing=smoothing),
                           device="cpu")
    # the impulse decision may differ where the two devices round the
    # filtered sums differently: at most IMPULSE_FLIPS of the pixels,
    # and the slice max outside their reach
    st = impulse_parity(out, cpu, *masks)
    assert st["flip_share"] <= IMPULSE_FLIPS, st
    assert st["max_lsb8_beyond_flips"] <= 1.0, st
    assert st["mean"] <= 2e-4, st


def _transform_data(case):
    """The geometric transform's data for a 256x384 image from the port's
    own planner: rotation and perspective with auto-fill, or distortion
    and CA sliders with a metadata spline (a Sony correction)."""
    import dataclasses

    from art_tpu_torch.pipeline import transform as tt

    pp = ProcParams()
    frame = synthesize_bayer(np.full((3, 8, 8), 0.5, np.float32))
    if case == "rotate-perspective":
        pp.apply_arp_text("[Rotation]\nEnabled=true\nDegree=1.5\n"
                          "[Perspective]\nEnabled=true\nHorizontal=8\n"
                          "Vertical=-5\n[Common Properties for "
                          "Transformations]\nAutoFill=true\n")
    else:
        nc = 16
        frame = dataclasses.replace(frame, make="SONY", exif={"makernotes": {
            "DistortionCorrParams": [nc] + [int(-3000 * (i / 15.0) ** 2)
                                            for i in range(nc)],
            "ChromaticAberrationCorrParams": [2 * nc] + [40] * (2 * nc),
            "VignettingCorrParams": [nc] + [0] * nc}})
        pp.apply_arp_text("[Distortion]\nEnabled=true\nAmount=0.05\n"
                          "[CACorrection]\nEnabled=true\nRed=0.002\n"
                          "Blue=-0.002\n[LensProfile]\nLcMode=exif\n"
                          "UseCA=true\n")
    return tt.plan_transform(pp, (256, 384), frame=frame)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("case", ["rotate-perspective", "exif-spline"])
def test_transform_on_card_matches_cpu(cuda_device, case, method):
    # the coordinates' divisions by host scalars go through fdiv, so the
    # card rounds them as the CPU does: the same samples, the same taps
    from art_tpu_torch.pipeline import transform as tt

    data = _transform_data(case)
    rgb = np.random.default_rng(4).uniform(0, 65535, (3, 256, 384))
    x = torch.from_numpy(rgb.astype(np.float32))
    cpu = tt.apply_transform(x, tdev.data_to_torch(data, "cpu"), method)
    out = tt.apply_transform(x.to(cuda_device),
                             tdev.data_to_torch(data, cuda_device), method)
    d = (out.cpu().double() - cpu.double()).abs()
    assert ((out.cpu() == 0) == (cpu == 0)).all()  # no support flips
    assert d.max().item() <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("blur", ["area", "v", "h", "vh"])
def test_flatfield_on_card_matches_cpu(cuda_device, blur):
    # the box means difference running sums, which the card's scan adds
    # in another order: within 1.0 of 65535 on a 512x768 plane
    from art_tpu_torch.raw.dfff import apply_flatfield_bayer

    rng = np.random.default_rng(5)
    cfa = torch.from_numpy(rng.uniform(600, 16000, (512, 768)).astype(
        np.float32))
    flat = torch.from_numpy(rng.uniform(4000, 9000, (512, 768)).astype(
        np.float32))
    cpu = apply_flatfield_bayer(cfa, flat, blur, 32)
    out = apply_flatfield_bayer(cfa.to(cuda_device), flat.to(cuda_device),
                                blur, 32)
    assert (out.cpu().double() - cpu.double()).abs().max().item() <= 1.0
