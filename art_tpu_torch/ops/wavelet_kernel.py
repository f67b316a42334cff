"""Wavelet denoise kernels B4 and B5 (counterpart of
``art_tpu/ops/wavelet_pallas.py``): B4 is the fused RGB kernel
(``wavelet_denoise_pallas_rgb`` -> ``_run_rgb`` -> ``_kernel_rgb``), B5
the chain alone on stacked planes (``wavelet_denoise_pallas_multi`` ->
``_run`` -> ``_kernel``), which the non-fused denoise runs on Y, U, V.

What it computes, per (3, H, W) RGB stack in the 0..65535 domain:
optional raw head (WB multipliers, clip, cam2work), exposure gain and
forward gamma (x^(1/8)-warp Horner fit), YUV split; per plane a 5-level
B3 a-trous decomposition whose details are shrunk by their 3x3 energy
against a noise sigma, then the reconstruction, inverse YUV and inverse
gamma.

The noise sigma is the reference's tile statistic and is kept exactly:
the image is cut into bands of 256 rows by `tx` columns (`pick_tx_rgb`),
each band's window is the band plus a 64-pixel reflect halo, and sigma
is median(|d0|)/0.6745 by 14 bisection steps over the whole window,
where d0 is the level-0 detail computed with the blur wrapping around
INSIDE the window (the reference's `jnp.roll`). The kernel reaches the
same sigma without storing |d0| or counting 14 times: the bisection's
possible mids form a fixed binary tree for the window's max, so it
walks each value down that tree by the steps' own comparisons, counts
the leaves in a 16,384-bin histogram, and takes each step's count as a
prefix sum of it (`mad_sigma_hist` renders that walk in PyTorch for the
tests). Everything else is local: the chain reaches 63 pixels, so a
band's output equals the chain run over the whole padded plane, with
the band's sigma in the shrink.

B5 is the same chain on C planes with no head, gamma or YUV; its tiles
are always 256 x 1024 on the planes reflect-padded to whole tiles, so
its sigma grid is 2-D.

`wavelet_denoise_rgb` (B4) and `wavelet_denoise_multi` (B5) are the
entry points. On a CPU tensor each runs its plain PyTorch version below;
on a CUDA tensor it launches its kernel of ``csrc/wavelet_rgb.cu`` (see
there for the design) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from art_tpu_torch import kernels
from art_tpu_torch.core.curve1d import eval_split, horner_split
from art_tpu_torch.core.fmath import fdiv

TILE_Y = 256
TILE_X = 1024
PAD = 64
LEVELS = 5
BISECT = 14
LEAVES = 1 << BISECT  # leaves of the bisection tree (the kernel's histogram)
TOP = 10  # levels of the tree the kernel looks up in a table of mids
TOPN = (1 << TOP) - 1
B3 = (0.0625, 0.25, 0.375, 0.25, 0.0625)  # art_tpu/ops/wavelet.py::_B3
MAXK = 32  # longest split-fit row the kernel takes
MAXVAL = 65535.0


def pick_tx_rgb(w):
    """Band width: the full width when the reference's 3-plane window fits
    its VMEM budget, else 1024 (wavelet_pallas.py::_pick_tx_rgb). It fixes
    the sigma grid, so the port keeps it."""
    if w % 128 == 0 and 3 * (TILE_Y + 2 * PAD) * (w + 2 * PAD) * 4 * 3 \
            <= 88 * 1024 * 1024:
        return w
    return TILE_X


def tile_geometry(h, w, tx=None):
    """(tx, hp, wp): band width and the tile-padded plane size, or None
    when the image is smaller than one tile (the reference then takes a
    whole-plane XLA path that is not ported)."""
    if tx is None:
        tx = pick_tx_rgb(w)
        if h < TILE_Y or w < min(TILE_X, tx):
            return None
    hp = -(-h // TILE_Y) * TILE_Y
    wp = w if tx == w else -(-w // tx) * tx
    return tx, hp, wp


def pack_params(lum_w, ecomp, sigmas, strengths, blends, pre=None):
    """The kernel's scalar vector (14, or 26 with the head), laid out as
    the reference's `pv`: lum_w[3], ecomp/MAXVAL, sigma[3], strength[3],
    blend[3], MAXVAL/ecomp, then mults[3] and cam2work[9]."""
    def vec(xs):
        return torch.stack([torch.as_tensor(x, dtype=torch.float32)
                            .reshape(()).to(dev) for x in xs])

    ecomp = torch.as_tensor(ecomp, dtype=torch.float32)
    dev = ecomp.device
    lum_w = torch.as_tensor(lum_w, dtype=torch.float32).to(dev)
    mx = torch.full((1,), MAXVAL, dtype=torch.float32, device=dev)
    parts = [lum_w.reshape(3), (ecomp.reshape(1) / mx), vec(sigmas),
             vec(strengths), vec(blends), mx / ecomp.reshape(1)]
    if pre is not None:
        parts.append(torch.as_tensor(pre[0], dtype=torch.float32)
                     .to(dev).reshape(3))
        parts.append(torch.as_tensor(pre[1], dtype=torch.float32)
                     .to(dev).reshape(9))
    return torch.cat(parts)


def prepare(rgb, lum_w, ecomp, gam_fwd, gam_inv, sigmas, strengths,
            blends, pre=None):
    """Check the arguments and return (pv, cfwd, cinv, tx) on rgb's device:
    what the kernel and its plain version take. Raises
    NotImplementedError below one 256-row tile."""
    if rgb.ndim != 3 or rgb.shape[0] != 3 or rgb.dtype != torch.float32:
        raise ValueError(f"want float32 (3, H, W), got {rgb.dtype} "
                         f"{tuple(rgb.shape)}")
    _, h, w = rgb.shape
    geo = tile_geometry(h, w)
    if geo is None:
        raise NotImplementedError(
            f"wavelet denoise of a {h}x{w} image: below one 256-row tile "
            "the reference runs a whole-plane path that is not ported")
    pv = pack_params(lum_w, ecomp, sigmas, strengths, blends, pre).to(
        rgb.device)
    cfwd = torch.as_tensor(gam_fwd, dtype=torch.float32).to(rgb.device)
    cinv = torch.as_tensor(gam_inv, dtype=torch.float32).to(rgb.device)
    for name, c in (("gam_fwd", cfwd), ("gam_inv", cinv)):
        if c.ndim != 2 or c.shape[0] != 2 or not 1 <= c.shape[1] <= MAXK:
            raise ValueError(f"{name}: want (2, K<={MAXK}), got "
                             f"{tuple(c.shape)}")
    return pv, cfwd.contiguous(), cinv.contiguous(), geo[0]


def wavelet_denoise_rgb(rgb, lum_w, ecomp, gam_fwd, gam_inv, sigmas,
                        strengths, blends, pre=None):
    """Denoise a (3, H, W) float32 stack; see the module docstring.

    sigmas/strengths/blends: per Y, U, V (sigma < 0: the band's MAD);
    gam_fwd/gam_inv: (2, K) split fits; pre: optional (mults[3],
    cam2work 3x3) raw head."""
    pv, cfwd, cinv, tx = prepare(rgb, lum_w, ecomp, gam_fwd, gam_inv,
                                 sigmas, strengths, blends, pre)
    if rgb.device.type == "cpu":
        return wavelet_rgb_plain(rgb, pv, cfwd, cinv, tx)
    if rgb.device.type != "cuda":
        raise ValueError(f"no wavelet kernel for device {rgb.device}")
    return _launch(rgb.contiguous(), pv, cfwd, cinv, tx)


wavelet_denoise_rgb.launches = 0


def _scratch(c, hp, wp, tx, device):
    """The chain's scratch for c planes: two stacks of padded planes (each
    level's input and its smooth plane), acc, and per (tile, plane) the
    |d0| leaf histogram, the window's max |d0| and the sigma."""
    nwc = (hp // TILE_Y) * (wp // tx) * c
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((2, c, hp + 2 * PAD, wp + 2 * PAD), **f32),
            torch.empty((c, hp, wp), **f32),
            torch.empty((nwc, LEAVES), dtype=torch.int32, device=device),
            torch.empty((nwc,), **f32),
            torch.empty((nwc,), **f32))


def scratch_bytes(c, hp, wp, tx):
    """Bytes of device scratch one call takes for c planes."""
    return sum(t.numel() * t.element_size()
               for t in _scratch(c, hp, wp, tx, "meta"))


def layout():
    """Each wavelet kernel's registers, shared memory and local memory on
    the card, one line each (``art_wavelet_layout``)."""
    buf = ctypes.create_string_buffer(8192)
    kernels.check(kernels.library().art_wavelet_layout(buf, len(buf)),
                  "art_wavelet_layout")
    return buf.value.decode()


def _launch(rgb, pv, cfwd, cinv, tx):
    lib = kernels.library()
    _, h, w = rgb.shape
    _, hp, wp = tile_geometry(h, w, tx)
    out = torch.empty((3, h, w), dtype=torch.float32, device=rgb.device)
    scratch = _scratch(3, hp, wp, tx, rgb.device)
    ptr = [t.data_ptr() for t in (rgb, out, *scratch, pv, cfwd, cinv)]
    rc = lib.art_wavelet_rgb(*ptr, cfwd.shape[1], cinv.shape[1], h, w, hp,
                             wp, tx, int(pv.numel() == 26),
                             kernels.stream_of(rgb))
    kernels.check(rc, "art_wavelet_rgb")
    wavelet_denoise_rgb.launches += 1
    return out


def multi_geometry(h, w):
    """(hp, wp): B5's plane size after the reference's tile pad to whole
    256x1024 tiles (`_pad_to_tiles`; tx is always 1024 there), or None
    below one tile (the reference then runs a whole-plane XLA path that
    is not ported)."""
    if h < TILE_Y or w < TILE_X:
        return None
    return -(-h // TILE_Y) * TILE_Y, -(-w // TILE_X) * TILE_X


def multi_params(c, sigmas, strengths, blends, device):
    """(3, C) float32 rows sigma, strength, blend on `device`: the
    reference's `sc`, transposed, as B5 and its plain version take it."""
    rows = [[torch.as_tensor(v, dtype=torch.float32).reshape(()).to(device)
             for v in vs] for vs in (sigmas, strengths, blends)]
    if any(len(r) != c for r in rows):
        raise ValueError(f"want {c} sigmas, strengths and blends")
    return torch.stack([torch.stack(r) for r in rows])


def wavelet_denoise_multi(x3, sigmas, strengths, blends):
    """Kernel B5: denoise the stacked (C, H, W) float32 planes x3, plane c
    with sigmas[c] (< 0: each tile's MAD), strengths[c] and blends[c]
    (counterpart of `wavelet_denoise_pallas_multi`). On a CPU tensor it
    runs `wavelet_multi_plain`; on a CUDA tensor it launches
    ``art_wavelet_multi`` of ``csrc/wavelet_rgb.cu`` or raises."""
    if x3.ndim != 3 or x3.dtype != torch.float32:
        raise ValueError(f"want float32 (C, H, W), got {x3.dtype} "
                         f"{tuple(x3.shape)}")
    c, h, w = x3.shape
    if multi_geometry(h, w) is None:
        raise NotImplementedError(
            f"wavelet denoise of {h}x{w} planes: below one 256x1024 tile "
            "the reference runs a whole-plane path that is not ported")
    prm = multi_params(c, sigmas, strengths, blends, x3.device)
    if x3.device.type == "cpu":
        return wavelet_multi_plain(x3, prm)
    if x3.device.type != "cuda":
        raise ValueError(f"no wavelet kernel for device {x3.device}")
    return _launch_multi(x3.contiguous(), prm)


wavelet_denoise_multi.launches = 0


def _launch_multi(x3, prm):
    lib = kernels.library()
    c, h, w = x3.shape
    hp, wp = multi_geometry(h, w)
    out = torch.empty((c, h, w), dtype=torch.float32, device=x3.device)
    scratch = _scratch(c, hp, wp, TILE_X, x3.device)
    ptr = [t.data_ptr() for t in (x3, out, *scratch, prm)]
    rc = lib.art_wavelet_multi(*ptr, c, h, w, hp, wp, kernels.stream_of(x3))
    kernels.check(rc, "art_wavelet_multi")
    wavelet_denoise_multi.launches += 1
    return out


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU path, and the reference for the kernel on the
# card); float32 operations in the reference's order


def _split_eval(t, c):
    return horner_split(t, *c.tolist())


def _reflect(i, n):
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _padded(x3, hp, wp):
    """(C, hp+128, wp+128): the tile pad to (hp, wp) and the 64-pixel
    halo, both reflect pads of x3, as one gather."""
    _, h, w = x3.shape
    dev = x3.device
    ry = _reflect(_reflect(torch.arange(hp + 2 * PAD, device=dev) - PAD, hp),
                  h)
    rx = _reflect(_reflect(torch.arange(wp + 2 * PAD, device=dev) - PAD, wp),
                  w)
    return x3[:, ry][:, :, rx]


def _head(rgb, pv, cfwd, hp, wp, pre):
    """Padded (3, hp+128, wp+128) YUV planes in the forward gamma domain:
    the pads come first, so the head (pointwise) runs after one gather."""
    x = _padded(rgb, hp, wp)
    p = pv.tolist()
    gain = p[3]

    def fwd(v):
        v = torch.clamp(v * gain, 0.0, 1.0)
        wv = torch.sqrt(torch.sqrt(torch.sqrt(torch.clamp(v, 0.0, 1.0))))
        return _split_eval(2.0 * wv - 1.0, cfwd)

    if pre:
        q = p[14:26]
        r0 = torch.clamp(x[0] * q[0], 0.0, 65535.0)
        g0 = torch.clamp(x[1] * q[1], 0.0, 65535.0)
        b0 = torch.clamp(x[2] * q[2], 0.0, 65535.0)
        r = fwd(q[3] * r0 + q[4] * g0 + q[5] * b0)
        g = fwd(q[6] * r0 + q[7] * g0 + q[8] * b0)
        b = fwd(q[9] * r0 + q[10] * g0 + q[11] * b0)
    else:
        r, g, b = fwd(x[0]), fwd(x[1]), fwd(x[2])
    y = p[0] * r + p[1] * g + p[2] * b
    return torch.stack([y, y - b, r - y])


def _shift(a, d, dim):
    """out[i] = a[clamp(i + d)] along dim."""
    n = a.shape[dim]
    idx = torch.clamp(torch.arange(n, device=a.device) + d, 0, n - 1)
    return a.index_select(dim, idx)


def _sep_blur(a, spacing, periodic):
    """B3 separable blur with dilated taps over the last two dims; the
    reference's tap order. periodic: wrap around the array (jnp.roll);
    else clamp at its edges."""
    def sh(v, d, dim):
        if periodic:
            return torch.roll(v, -d, dims=dim)
        return _shift(v, d, dim)

    k = B3
    col = k[2] * a
    for i, d in ((0, -2), (1, -1), (3, 1), (4, 2)):
        col = col + k[i] * sh(a, d * spacing, -2)
    out = k[2] * col
    for i, d in ((0, -2), (1, -1), (3, 1), (4, 2)):
        out = out + k[i] * sh(col, d * spacing, -1)
    return out


def mad_sigma(d):
    """median(|d|)/0.6745 over the last two dims by 14 bisection steps,
    the reference's `_mad_sigma_vmem` (integer counts, f32 ratio)."""
    a = torch.abs(d).flatten(-2)
    n = torch.tensor(float(a.shape[-1]), dtype=torch.float32,
                     device=a.device)
    lo = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    hi = a.amax(-1)
    for _ in range(BISECT):
        mid = 0.5 * (lo + hi)
        below = (a <= mid[..., None]).sum(-1).to(torch.float32) / n
        go_up = below < 0.5
        lo = torch.where(go_up, mid, lo)
        hi = torch.where(go_up, hi, mid)
    return 0.5 * (lo + hi) * (1.0 / 0.6745)


def top_mids(top):
    """The mids of the top TOP levels of the bisection tree from (0, top)
    for each row's max `top`, in order (the kernel's `top_mids`): entry e
    lies between leaves e and e + 1 of those levels."""
    tbl = torch.zeros(top.shape + (TOPN,), dtype=torch.float32,
                      device=top.device)
    for depth in range(TOP):
        span = 1 << (TOP - depth)
        f = torch.arange(1 << depth, device=top.device) * span
        first, last = f == 0, f == f[-1]
        lo = torch.where(first, 0.0, tbl[..., (f - 1).clamp(min=0)])
        hi = torch.where(last, top[..., None],
                         tbl[..., (f + span - 1).clamp(max=TOPN - 1)])
        tbl[..., f + span // 2 - 1] = 0.5 * (lo + hi)
    return tbl


def sigma_leaves(a, top):
    """Each value's leaf in the tree of mids that 14 bisection steps from
    (0, top) can visit, as the kernel finds it: a (rows, n) >= 0, top
    (rows,). Those mids are ordered, so the path through the top TOP
    levels ends at the count of their mids below the value (the kernel
    reaches it from an estimate and a step or two), between the two mids
    around it as lo and hi; the last levels are walked by the steps' own
    comparison a <= mid."""
    tbl = top_mids(top)
    e = torch.searchsorted(tbl, a.contiguous())
    lo = torch.where(e > 0, tbl.gather(1, (e - 1).clamp(min=0)), 0.0)
    hi = torch.where(e < TOPN, tbl.gather(1, e.clamp(max=TOPN - 1)),
                     top[:, None])
    leaf = e
    for _ in range(BISECT - TOP):
        mid = 0.5 * (lo + hi)
        up = ~(a <= mid)
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
        leaf = 2 * leaf + up
    return leaf


def mad_sigma_hist(d):
    """`mad_sigma` as the kernel reaches it, for the tests: each value's
    leaf (`sigma_leaves`), the leaves' histogram, then the 14 steps, each
    count of values <= mid being the count below the current node plus
    its left half. Equal to `mad_sigma` bit for bit."""
    a = torch.abs(d).flatten(-2)
    batch = a.shape[:-1]
    a = a.reshape(-1, a.shape[-1])
    n = torch.tensor(float(a.shape[-1]), dtype=torch.float32,
                     device=a.device)
    top = a.amax(-1)
    leaf = sigma_leaves(a, top)
    rows = torch.arange(a.shape[0], device=a.device)[:, None] * LEAVES
    hist = torch.bincount((leaf + rows).flatten(),
                          minlength=a.shape[0] * LEAVES).reshape(-1, LEAVES)
    below_leaf = torch.nn.functional.pad(hist.cumsum(-1), (1, 0))
    lo = torch.zeros_like(top)
    hi = top
    node = torch.zeros_like(rows[:, 0])
    below = torch.zeros_like(node)
    for k in range(BISECT):
        start = node << (BISECT - k)
        half = LEAVES >> (k + 1)
        count = below + (below_leaf.gather(1, (start + half)[:, None])
                         - below_leaf.gather(1, start[:, None]))[:, 0]
        mid = 0.5 * (lo + hi)
        go_up = count.to(torch.float32) / n < 0.5
        lo = torch.where(go_up, mid, lo)
        hi = torch.where(go_up, hi, mid)
        below = torch.where(go_up, count, below)
        node = 2 * node + go_up
    return (0.5 * (lo + hi) * (1.0 / 0.6745)).reshape(batch)


def band_sigmas(yuv, tx, pinned=(-1.0, -1.0, -1.0)):
    """(nby, nbx, C) noise sigma per tile and plane from the C padded
    planes: the MAD of the level-0 detail over each tile's window, with
    the blur wrapping inside the window. pinned[c] >= 0 replaces it."""
    _, hh, ww = yuv.shape
    nby = (hh - 2 * PAD) // TILE_Y
    nbx = (ww - 2 * PAD) // tx
    rows = []
    for i in range(nby):
        row = []
        for j in range(nbx):
            win = yuv[:, i * TILE_Y : i * TILE_Y + TILE_Y + 2 * PAD,
                      j * tx : j * tx + tx + 2 * PAD]
            row.append(mad_sigma(win - _sep_blur(win, 1, periodic=True)))
        rows.append(torch.stack(row))
    sig = torch.stack(rows)
    pin = torch.as_tensor(pinned, dtype=torch.float32).to(sig.device)
    return torch.where(pin < 0.0, sig, pin)


def _shrink(d, t2, blend, hp, wp):
    """3x3-energy shrink of the centre (hp, wp) of d (3, H+128, W+128);
    t2 (3, hp, wp) per pixel, blend (3, 1, 1)."""
    e = d * d
    s = e + _shift(e, 1, -2) + _shift(e, -1, -2)
    e9 = (s + _shift(s, 1, -1) + _shift(s, -1, -1)) * (1.0 / 9.0)
    c = (slice(None), slice(PAD, PAD + hp), slice(PAD, PAD + wp))
    e9, d = e9[c], d[c]
    factor = e9 / (e9 + t2 + 1e-12)
    dd = d * factor
    return dd + (d - dd) * blend


def _chain(planes, prm, tx, hp, wp):
    """The reference's `_wavelet_chain` on each padded plane of (C,
    hp+128, wp+128), each tile with its own sigma: (C, hp, wp), the
    shrunk details of the 5 levels summed, plus the residual. prm: (3, C)
    rows sigma (< 0: the tile's MAD), strength, blend."""
    c = planes.shape[0]
    sig = band_sigmas(planes, tx, prm[0])  # (nby, nbx, C)
    strength = prm[1]
    blend = prm[2].reshape(c, 1, 1)
    acc = None
    cur = planes
    for lv in range(LEVELS):
        smooth = _sep_blur(cur, 2 ** lv, periodic=False)
        st = strength * sig / (2.0 ** lv)
        t2 = (st * st).permute(2, 0, 1)
        t2 = t2.repeat_interleave(TILE_Y, 1).repeat_interleave(tx, 2)
        val = _shrink(cur - smooth, t2, blend, hp, wp)
        acc = val if acc is None else acc + val
        cur = smooth
    return acc + cur[:, PAD : PAD + hp, PAD : PAD + wp]


def wavelet_rgb_plain(rgb, pv, cfwd, cinv, tx):
    """The plain PyTorch version of the kernel, on `prepare`'s outputs (a
    26-long pv carries the raw head); counts its calls in `.calls`."""
    wavelet_rgb_plain.calls += 1
    _, h, w = rgb.shape
    _, hp, wp = tile_geometry(h, w, tx)
    yuv = _head(rgb, pv, cfwd, hp, wp, pv.numel() == 26)
    y2, u2, v2 = _chain(yuv, pv[4:13].reshape(3, 3), tx, hp, wp)
    p = pv.tolist()
    b2 = y2 - u2
    r2 = v2 + y2
    g2 = fdiv(y2 - r2 * p[0] - b2 * p[2], pv[1])

    ci = cinv.tolist()
    return torch.stack([eval_split(v, ci, out_max=p[13])
                        for v in (r2, g2, b2)])[:, :h, :w]


wavelet_rgb_plain.calls = 0


def wavelet_multi_plain(x3, prm):
    """The plain PyTorch version of kernel B5 (counts its calls in
    `.calls`): the chain on each plane of x3 (C, H, W), reflect-padded to
    whole 256x1024 tiles; prm as `wavelet_denoise_multi` builds it."""
    wavelet_multi_plain.calls += 1
    _, h, w = x3.shape
    hp, wp = multi_geometry(h, w)
    return _chain(_padded(x3, hp, wp), prm, TILE_X, hp, wp)[:, :h, :w]


wavelet_multi_plain.calls = 0
