"""The needed-operation count behind the kernel bounds of chip_smoke.py
(`art_tpu_torch.opcount.needed_ops`), on the CPU.

Hand-counted cases: each returns (function, needed count, naive count)
for two 6x8 planes a, b from a seed; n = 48. Then every plain version of
a kernel (B1-B3, B4, B7; B5 and B6 of config 3) at a small size: the count
runs through all of its ops, leaves the result unchanged, and stays at or
under the naive count (every float op, both arms of each select, every
repeat); for the AMaZE stages, whose selects are whole-plane, strictly
under it.
"""

import os

import numpy as np
import pytest
import torch

from art_tpu_torch.core.image import synthesize_bayer
from art_tpu_torch.demosaic import amaze
from art_tpu_torch.opcount import needed_ops

ARP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "art_tpu_torch", "data", "profiles",
    "Standard Film Curve.arp")
SHAPE = (6, 8)
N = SHAPE[0] * SHAPE[1]


def _planes():
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.uniform(0.0, 1.0, SHAPE).astype(np.float32))
            for _ in range(2)]


def _roll(t, dy, dx):
    return torch.roll(t, (dy, dx), (0, 1))


def _case(name, a, b):
    k = int((a > 0.5).sum())  # elements that take the first arm
    if name == "elementwise":
        return lambda: a + b, N, N
    if name == "select_takes_one_arm":
        # compare, select, then a*2 where it holds and b*3 where not
        return lambda: torch.where(a > 0.5, a * 2.0, b * 3.0), \
            N + N + k + (N - k), 4 * N
    if name == "unread_op":
        def fn():
            _ = a * b
            return a + b
        return fn, N, 2 * N
    if name == "repeat":
        return lambda: (a * b) + (a * b), 2 * N, 3 * N
    if name == "rolled_repeat":
        return lambda: (_roll(a, 1, 2) - _roll(b, 1, 2)) + (a - b), \
            2 * N, 3 * N
    if name == "differently_rolled":
        return lambda: (_roll(a, 1, 0) - b) + (a - b), 3 * N, 3 * N
    if name == "stack_select":
        return lambda: torch.stack([a + b, a - b])[0], N, 2 * N
    if name == "reduction":
        return lambda: (a * b).sum(-1), 2 * N, 2 * N
    if name == "crop":
        return lambda: (a * b)[1:3, :2].contiguous(), 4, N
    if name == "constant_pad":
        # the first two padded columns: the zero pad and a*b's column 0
        return lambda: torch.nn.functional.pad(a * b, (1, 1))[:, :2], \
            SHAPE[0], N
    if name == "reflect_pad":
        # a 3x3 corner of a reflect pad by 2 reads 3x3 distinct elements
        return lambda: torch.nn.functional.pad(
            (a * b)[None, None], (2, 2, 2, 2), mode="reflect")[0, 0, :3, :3], \
            9, N
    if name == "gather":
        # clamped column shifts, as the wavelet blur reads its edges
        return lambda: (a * b).index_select(1, torch.tensor([0, 0, 1])), \
            2 * SHAPE[0], N
    if name == "in_place_mask":
        def fn():
            m = torch.zeros(SHAPE, dtype=torch.bool)
            m |= a > 0.5
            return torch.where(m, a + b, a - b)
        return fn, N + N + k + (N - k), 4 * N
    if name == "host_read":
        # a value the host reads needs all of its inputs
        return lambda: a + float((a * 2.0).sum()), 3 * N, 3 * N
    raise KeyError(name)


CASES = ["elementwise", "select_takes_one_arm", "unread_op", "repeat",
         "rolled_repeat", "differently_rolled", "stack_select", "reduction",
         "crop", "constant_pad", "reflect_pad", "gather", "in_place_mask",
         "host_read"]


@pytest.mark.parametrize("name", CASES)
def test_hand_counted(name):
    a, b = _planes()
    fn, want, want_naive = _case(name, a, b)
    out, ops, naive = needed_ops(fn)
    assert torch.equal(out, fn())
    assert (ops, naive) == (want, want_naive)


def test_op_without_a_rule_raises():
    a, _ = _planes()
    with pytest.raises(NotImplementedError, match="cumsum"):
        needed_ops(lambda: torch.cumsum(a, 0))


def _amaze_inputs(h=96, w=128):
    rng = np.random.default_rng(3)
    rgb = rng.uniform(0.02, 0.95, size=(3, h, w)).astype(np.float32)
    cfa = torch.from_numpy(synthesize_bayer(rgb, "RGGB").cfa)
    x = amaze.padded_plane(cfa)
    clips = amaze.clip_points(1.0, "cpu")
    s1 = amaze.stage1_plain(x, "RGGB", clips)
    s2 = amaze.stage2_plain(x, "RGGB", s1)
    return x, clips, s1, s2


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_amaze_stage_counts(stage):
    x, clips, s1, s2 = _amaze_inputs()
    fn = {1: lambda: amaze.stage1_plain(x, "RGGB", clips),
          2: lambda: amaze.stage2_plain(x, "RGGB", s1),
          3: lambda: amaze.stage3_plain(x, "RGGB", s2, clips)}[stage]
    out, ops, naive = needed_ops(fn)
    assert torch.equal(out, fn())
    # both select arms over the whole plane: the needed count is lower
    assert 0 < ops < naive
    print(f"B{stage}: {ops / x.numel():.1f} needed, {naive / x.numel():.1f} "
          f"naive operations a pixel of the padded plane")


def test_wavelet_and_neutral_counts():
    """The plain B4 and B7 on a small AMaZE develop's own tensors."""
    from art_tpu_torch.ops import denoise
    from art_tpu_torch.ops import tonecurve_neutral as tn
    from art_tpu_torch.ops import wavelet_kernel as wk
    from art_tpu_torch.params import ProcParams
    from art_tpu_torch.pipeline import develop as tdev
    from art_tpu_torch.raw.preprocess import apply_scale

    rng = np.random.default_rng(1)
    frame = synthesize_bayer(
        rng.uniform(0.02, 0.95, size=(3, 256, 512)).astype(np.float32),
        "RGGB")
    pp = ProcParams()
    with open(ARP) as f:
        pp.apply_arp_text(f.read())
    pp.denoise.enabled = True
    pp.denoise.luminance = pp.denoise.chrominance = 20.0
    config, data = tdev.plan(frame, pp)
    data = tdev.data_to_torch(data, "cpu")
    inp, _ = tdev.pad_to_multiple(frame.cfa, tdev.PAD_MULTIPLE)
    cfa = apply_scale(torch.from_numpy(inp).float(), data["raw_offset"],
                      data["raw_scale"])
    rgb = amaze.amaze_demosaic(cfa, config.pattern, data["init_gain"])
    dn = dict(data["op:denoise"], pre_mults=data["rgb_mults"],
              pre_mat=data["cam2work"])
    args, kw = denoise.kernel_args(dn, config.steps[0][1])
    plain_args = (rgb,) + wk.prepare(rgb, *args, **kw)
    b4, ops, naive = needed_ops(lambda: wk.wavelet_rgb_plain(*plain_args))
    assert torch.equal(b4, wk.wavelet_rgb_plain(*plain_args))
    assert 0 < ops <= naive
    tc = data["op:tonecurve"]
    params = torch.cat([tc["params"], data["work2out"].reshape(-1)])
    coeffs = tc["coeffs"].reshape(-1, tc["coeffs"].shape[-1])
    epi = config.out_trc[0]
    b7, ops, naive = needed_ops(
        lambda: tn.neutral_plain(b4, params, coeffs, epi))
    assert torch.equal(b7, tn.neutral_plain(b4, params, coeffs, epi))
    assert 0 < ops <= naive


def test_b5_count():
    from art_tpu_torch.ops import wavelet_kernel as wk

    rng = np.random.default_rng(2)
    x3 = torch.from_numpy(rng.normal(0.5, 0.1, (3, 256, 1024)).astype(
        np.float32))
    prm = torch.tensor([[-1.0] * 3, [0.8, 1.4, 0.45], [0.3, 0.0, 0.0]])
    out, ops, naive = needed_ops(lambda: wk.wavelet_multi_plain(x3, prm))
    assert torch.equal(out, wk.wavelet_multi_plain(x3, prm))
    assert 0 < ops <= naive
    print(f"B5: {ops / x3.numel():.1f} needed, {naive / x3.numel():.1f} "
          "naive operations an output value")


def _pair_area(a, b, dy, dx):
    """Elements in two a x b rectangles, one moved by (dy, dx)."""
    return 2 * a * b - max(0, a - abs(dy)) * max(0, b - abs(dx))


def test_b6_count():
    """No select and no repeat, and each offset pair t, -t shares one
    patch box, needed on the plane and on the plane moved by -t: per
    pair, 2 ops on the squared differences under those two planes grown
    by 2 each way, 4 on the vertical sums under them grown by 2
    sideways, and 4 on the box itself; offset (0, 0) makes its box on
    the plane alone. Then 7 a pixel for each of the 121 offsets
    (multiply, min, negate, exp, multiply, two adds), of which the first
    has no adds onto acc and wsum, and the final division adds 2 a
    pixel. Below the naive count, which holds every box on the grown
    plane."""
    from art_tpu_torch.ops import nlmeans_kernel as nk

    rng = np.random.default_rng(3)
    h, w = 40, 56
    y = torch.from_numpy(rng.uniform(0, 1, (h, w)).astype(np.float32))
    mi = torch.from_numpy(rng.uniform(50, 400, (h, w)).astype(np.float32))
    out, ops, naive = needed_ops(lambda: nk.nlmeans_plain(y, mi))
    assert torch.equal(out, nk.nlmeans_plain(y, mi))
    boxes = 2 * (h + 4) * (w + 4) + 4 * h * (w + 4) + 4 * h * w
    for idx in range(60):
        ty, tx = idx // 11 - 5, idx % 11 - 5
        boxes += (2 * _pair_area(h + 4, w + 4, ty, tx)
                  + 4 * _pair_area(h, w + 4, ty, tx)
                  + 4 * _pair_area(h, w, ty, tx))
    assert ops == boxes + 121 * 7 * h * w
    assert ops < naive
