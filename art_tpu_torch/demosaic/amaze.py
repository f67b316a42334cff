"""AMaZE demosaic (counterpart of ``art_tpu/demosaic/amaze.py``, its
whole-plane path).

The mosaic is reflect-padded by HALO, divided by 65535 and run through
three stage functions on the whole padded plane, each neighbour read
periodically inside it (`torch.roll`, as the reference's `jnp.roll`):

  B1  x               -> vcd, hcd, hvwt     stages 1-4
  B2  x, vcd/hcd/hvwt -> green, hvwt'       stages 5-6
  B3  x, green/hvwt'  -> RGB (interior)     stages 7-8

then the outer BORDER ring is replaced by bilinear (`_with_border`).
Each stage has a CUDA kernel (``csrc/amaze.cu``, wrappers in
:mod:`art_tpu_torch.demosaic.amaze_kernel`); the functions here are their
plain PyTorch versions: float32 operations in the reference's order, with
exact division (the reference's Pallas path takes an approximate
reciprocal on the TPU; its whole-plane path, which this follows, divides
exactly). Stage reaches: B1 ~9, B2 ~13, B3 10, all inside HALO.

The reference's tile padding to 256x2048 multiples and its 128-column
halo are TPU layout workarounds and are not copied; they change no value.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.image import bayer_channel_masks

EPS = 1e-5
EPSSQ = 1e-10
ARTHRESH = 0.75
NYQTHRESH = 0.5

GAUSSODD = (0.14659727707323927, 0.103592713382435,
            0.0732036125103057, 0.0365543548389495)
GAUSSGRAD = tuple(NYQTHRESH * g for g in (
    0.07384411893421103, 0.06207511968171489, 0.0521818194747806,
    0.03687419286733595, 0.03099732204057846, 0.018413194161458882))
GAUSSEVEN = (0.13719494435797422, 0.05640252782101291)
GQUINC = (0.169917, 0.108947, 0.069855, 0.0287182)

BORDER = 16
HALO = 24  # cumulative stencil reach of the stage chain


def _med3(a, b, c):
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def _shifter(x):
    """s(dy, dx)[y, x] = x[y + dy, x + dx], wrapping around the plane."""
    def s(dy, dx):
        out = x
        if dy:
            out = torch.roll(out, -dy, 0)
        if dx:
            out = torch.roll(out, -dx, 1)
        return out

    return s


def _rcp(d):
    # 1/d, correctly rounded (the reference's `1.0 / d` with fast=False)
    return torch.reciprocal(d)


def _sq(a):
    return a * a


def _masks(pattern, x):
    return bayer_channel_masks(pattern, tuple(x.shape), x.device)


def stage1_plain(x, pattern, clips):
    """Stages 1-4 (amaze.py::_stages_1to4, fast=False) on the padded
    plane x (Hp, Wp); clips = (clip_pt, clip_pt8) as a 2-float tensor.
    Returns (3, Hp, Wp): vcd, hcd, hvwt."""
    stage1_plain.calls += 1
    _, mg, _ = _masks(pattern, x)
    clip_pt, clip_pt8 = clips[0], clips[1]
    s = _shifter(x)

    # ---- stage 1: gradients
    delh = torch.abs(s(0, 1) - s(0, -1))
    delv = torch.abs(s(1, 0) - s(-1, 0))
    dirwts0 = EPS + torch.abs(s(2, 0) - x) + torch.abs(x - s(-2, 0)) + delv
    dirwts1 = EPS + torch.abs(s(0, 2) - x) + torch.abs(x - s(0, -2)) + delh
    sd0 = _shifter(dirwts0)
    sd1 = _shifter(dirwts1)

    # ---- stage 2: cardinal G estimates + color differences
    cru = s(-1, 0) * (sd0(-2, 0) + dirwts0) * _rcp(
        sd0(-2, 0) * (EPS + x) + dirwts0 * (EPS + s(-2, 0)))
    crd = s(1, 0) * (sd0(2, 0) + dirwts0) * _rcp(
        sd0(2, 0) * (EPS + x) + dirwts0 * (EPS + s(2, 0)))
    crl = s(0, -1) * (sd1(0, -2) + dirwts1) * _rcp(
        sd1(0, -2) * (EPS + x) + dirwts1 * (EPS + s(0, -2)))
    crr = s(0, 1) * (sd1(0, 2) + dirwts1) * _rcp(
        sd1(0, 2) * (EPS + x) + dirwts1 * (EPS + s(0, 2)))

    guha = s(-1, 0) + 0.5 * (x - s(-2, 0))
    gdha = s(1, 0) + 0.5 * (x - s(2, 0))
    glha = s(0, -1) + 0.5 * (x - s(0, -2))
    grha = s(0, 1) + 0.5 * (x - s(0, 2))

    guar = torch.where(torch.abs(1.0 - cru) < ARTHRESH, x * cru, guha)
    gdar = torch.where(torch.abs(1.0 - crd) < ARTHRESH, x * crd, gdha)
    glar = torch.where(torch.abs(1.0 - crl) < ARTHRESH, x * crl, glha)
    grar = torch.where(torch.abs(1.0 - crr) < ARTHRESH, x * crr, grha)

    hwt = sd1(0, -1) * _rcp(sd1(0, -1) + sd1(0, 1))
    vwt = sd0(-1, 0) * _rcp(sd0(1, 0) + sd0(-1, 0))

    gintvha = vwt * gdha + (1.0 - vwt) * guha
    ginthha = hwt * grha + (1.0 - hwt) * glha

    sgn = torch.where(mg, -1.0, 1.0)  # cd is G-minus-other at every site
    vcd = sgn * ((vwt * gdar + (1.0 - vwt) * guar) - x)
    hcd = sgn * ((hwt * grar + (1.0 - hwt) * glar) - x)
    vcdalt = sgn * (gintvha - x)
    hcdalt = sgn * (ginthha - x)

    clipmask = (x > clip_pt8) | (gintvha > clip_pt8) | (ginthha > clip_pt8)
    guar = torch.where(clipmask, guha, guar)
    gdar = torch.where(clipmask, gdha, gdar)
    glar = torch.where(clipmask, glha, glar)
    grar = torch.where(clipmask, grha, grar)
    vcd = torch.where(clipmask, vcdalt, vcd)
    hcd = torch.where(clipmask, hcdalt, hcd)

    dgintv = torch.minimum(_sq(guha - gdha), _sq(guar - gdar))
    dginth = torch.minimum(_sq(glha - grha), _sq(glar - grar))
    del cru, crd, crl, crr, guar, gdar, glar, grar, gintvha, ginthha

    # ---- stage 3: variance-based selection + saturation bounding
    svc, shc = _shifter(vcd), _shifter(hcd)
    svca, shca = _shifter(vcdalt), _shifter(hcdalt)

    def var3(c_m, c_0, c_p):
        return 3.0 * (c_m * c_m + c_0 * c_0 + c_p * c_p) - _sq(
            c_m + c_0 + c_p)

    hcdvar = var3(shc(0, -2), hcd, shc(0, 2))
    hcdaltvar = var3(shca(0, -2), hcdalt, shca(0, 2))
    vcdvar = var3(svc(-2, 0), vcd, svc(2, 0))
    vcdaltvar = var3(svca(-2, 0), vcdalt, svca(2, 0))

    hcd = torch.where(hcdaltvar < hcdvar, hcdalt, hcd)
    vcd = torch.where(vcdaltvar < vcdvar, vcdalt, vcd)
    del hcdvar, hcdaltvar, vcdvar, vcdaltvar, vcdalt, hcdalt

    # bounding: G sites have cd = G - interp(other); R/B cd = Gint - cfa
    def bound_g_site(cd, n_m, n_p):
        gint_other = x - cd  # interpolated R/B at this G site
        med = _med3(gint_other, n_m, n_p)
        strong = 3.0 * cd > (gint_other + x)
        wt = 1.0 - 3.0 * cd * _rcp(EPS + gint_other + x)
        blended = wt * cd + (1.0 - wt) * (x - med)
        out = torch.where(cd > 0, torch.where(strong, x - med, blended), cd)
        return torch.where(gint_other > clip_pt, x - med, out)

    def bound_rb_site(cd, n_m, n_p):
        gint = cd + x
        med = _med3(gint, n_m, n_p)
        strong = 3.0 * cd < -(gint + x)
        wt = 1.0 + 3.0 * cd * _rcp(EPS + gint + x)
        blended = wt * cd + (1.0 - wt) * (med - x)
        out = torch.where(cd < 0, torch.where(strong, med - x, blended), cd)
        return torch.where(gint > clip_pt, med - x, out)

    hcd = torch.where(mg, bound_g_site(hcd, s(0, -1), s(0, 1)),
                      bound_rb_site(hcd, s(0, -1), s(0, 1)))
    vcd = torch.where(mg, bound_g_site(vcd, s(-1, 0), s(1, 0)),
                      bound_rb_site(vcd, s(-1, 0), s(1, 0)))

    # ---- stage 4: directional discrimination hvwt
    svc, shc = _shifter(vcd), _shifter(hcd)
    uave = vcd + svc(-1, 0) + svc(-2, 0) + svc(-3, 0)
    dave = vcd + svc(1, 0) + svc(2, 0) + svc(3, 0)
    lave = hcd + shc(0, -1) + shc(0, -2) + shc(0, -3)
    rave = hcd + shc(0, 1) + shc(0, 2) + shc(0, 3)
    # the reference sums raw deviations without the /4 mean
    dgrbvvaru = (_sq(vcd - uave) + _sq(svc(-1, 0) - uave)
                 + _sq(svc(-2, 0) - uave) + _sq(svc(-3, 0) - uave))
    dgrbvvard = (_sq(vcd - dave) + _sq(svc(1, 0) - dave)
                 + _sq(svc(2, 0) - dave) + _sq(svc(3, 0) - dave))
    dgrbhvarl = (_sq(hcd - lave) + _sq(shc(0, -1) - lave)
                 + _sq(shc(0, -2) - lave) + _sq(shc(0, -3) - lave))
    dgrbhvarr = (_sq(hcd - rave) + _sq(shc(0, 1) - rave)
                 + _sq(shc(0, 2) - rave) + _sq(shc(0, 3) - rave))

    vcdvar_d = EPSSQ + vwt * dgrbvvard + (1.0 - vwt) * dgrbvvaru
    hcdvar_d = EPSSQ + hwt * dgrbhvarr + (1.0 - hwt) * dgrbhvarl

    sgv, sgh = _shifter(dgintv), _shifter(dginth)
    fluctv_u = dgintv + sgv(-1, 0) + sgv(-2, 0)
    fluctv_d = dgintv + sgv(1, 0) + sgv(2, 0)
    flucth_l = dginth + sgh(0, -1) + sgh(0, -2)
    flucth_r = dginth + sgh(0, 1) + sgh(0, 2)
    vcdvar1 = EPSSQ + vwt * fluctv_d + (1.0 - vwt) * fluctv_u
    hcdvar1 = EPSSQ + hwt * flucth_r + (1.0 - hwt) * flucth_l

    varwt = hcdvar_d * _rcp(vcdvar_d + hcdvar_d)
    diffwt = hcdvar1 * _rcp(vcdvar1 + hcdvar1)
    agree = ((0.5 - varwt) * (0.5 - diffwt) > 0) & (
        torch.abs(0.5 - diffwt) < torch.abs(0.5 - varwt))
    hvwt = torch.where(agree, varwt, diffwt)
    return torch.stack([vcd, hcd, hvwt])


def _sum7(v, dim):
    """7 step-2 taps centred on each pixel, in the reference's log-tree
    order (amaze.py::_sum7): u1 = v + v[+2], u2 = u1 + u1[+4],
    s = u2 + u1[+8] + v[+12], recentred by 6."""
    def r(z, d):
        return torch.roll(z, -d, dim)

    u1 = v + r(v, 2)
    u2 = u1 + r(u1, 4)
    s = u2 + r(u1, 8) + r(v, 12)
    return torch.roll(s, 6, dim)


def _area_sum(a):
    return _sum7(_sum7(a, 0), 1)


def nyquist_masks(x, pattern, s1):
    """Stage 5's Nyquist test and majority vote (amaze.py::_stages_5to6)
    on the padded plane x with stage 1's (3, Hp, Wp) s1: (nyqf, ny2f),
    1.0 where set and 0.0 elsewhere (set only at R/B sites). nyquist2 is
    ny2f > 0.5."""
    vcd, hcd = s1[0], s1[1]
    _, mg, _ = _masks(pattern, x)
    s = _shifter(x)
    delh = torch.abs(s(0, 1) - s(0, -1))
    delv = torch.abs(s(1, 0) - s(-1, 0))
    delhvsqsum = delh * delh + delv * delv
    cddiffsq = _sq(vcd - hcd)

    scd, sds = _shifter(cddiffsq), _shifter(delhvsqsum)
    nyqutest = (
        GAUSSODD[0] * cddiffsq
        + GAUSSODD[1] * (scd(-1, -1) + scd(-1, 1) + scd(1, -1) + scd(1, 1))
        + GAUSSODD[2] * (scd(-2, 0) + scd(0, -2) + scd(0, 2) + scd(2, 0))
        + GAUSSODD[3] * (scd(-2, -2) + scd(-2, 2) + scd(2, -2) + scd(2, 2))
    ) - (
        GAUSSGRAD[0] * delhvsqsum
        + GAUSSGRAD[1] * (sds(-1, 0) + sds(0, 1) + sds(0, -1) + sds(1, 0))
        + GAUSSGRAD[2] * (sds(-1, -1) + sds(-1, 1) + sds(1, -1) + sds(1, 1))
        + GAUSSGRAD[3] * (sds(-2, 0) + sds(0, -2) + sds(0, 2) + sds(2, 0))
        + GAUSSGRAD[4] * (sds(-2, -1) + sds(-2, 1) + sds(-1, -2)
                          + sds(-1, 2) + sds(1, -2) + sds(1, 2)
                          + sds(2, -1) + sds(2, 1))
        + GAUSSGRAD[5] * (sds(-2, -2) + sds(-2, 2) + sds(2, -2) + sds(2, 2))
    )
    del scd, sds, cddiffsq, delhvsqsum
    m_rbf = torch.where(~mg, 1.0, 0.0)
    nyqf = torch.where(nyqutest > 0.0, 1.0, 0.0) * m_rbf

    sny = _shifter(nyqf)
    nyqsum = (sny(-2, 0) + sny(-1, -1) + sny(-1, 1) + sny(0, -2)
              + sny(0, 2) + sny(1, -1) + sny(1, 1) + sny(2, 0))
    ny2f = torch.where(nyqsum > 4, 1.0,
                       torch.where(nyqsum < 4, 0.0, nyqf)) * m_rbf
    return nyqf, ny2f


def stage2_plain(x, pattern, s1):
    """Stages 5-6 (amaze.py::_stages_5to6, fast=False): Nyquist texture
    handling and G at R/B sites. s1 is stage 1's (3, Hp, Wp). Returns
    (2, Hp, Wp): green, hvwt."""
    stage2_plain.calls += 1
    vcd, hcd, hvwt = s1[0], s1[1], s1[2]
    _, mg, _ = _masks(pattern, x)
    m_rb = ~mg
    s = _shifter(x)

    # ---- stage 5: Nyquist test and majority vote
    _, ny2f = nyquist_masks(x, pattern, s1)
    nyquist2 = ny2f > 0.5
    cfah = s(0, -1) + s(0, 1)
    cfav = s(-1, 0) + s(1, 0)
    sqh = _sq(x - s(0, -1)) + _sq(x - s(0, 1))
    sqv = _sq(x - s(-1, 0)) + _sq(x - s(1, 0))

    sumcfa = _area_sum(x * ny2f)
    sumh = _area_sum(cfah * ny2f)
    sumv = _area_sum(cfav * ny2f)
    sumsqh = _area_sum(sqh * ny2f)
    sumsqv = _area_sum(sqv * ny2f)
    areawt = _area_sum(ny2f)
    sumh = sumcfa - 0.5 * sumh
    sumv = sumcfa - 0.5 * sumv
    areawt = 0.5 * areawt
    hcdvar_a = EPSSQ + torch.abs(areawt * sumsqh - sumh * sumh)
    vcdvar_a = EPSSQ + torch.abs(areawt * sumsqv - sumv * sumv)
    hvwt = torch.where(nyquist2, hcdvar_a * _rcp(vcdvar_a + hcdvar_a), hvwt)
    del sumcfa, sumh, sumv, sumsqh, sumsqv, areawt, hcdvar_a, vcdvar_a

    # ---- stage 6: G at R/B sites
    shv = _shifter(hvwt)
    hvwtalt = 0.25 * (shv(-1, -1) + shv(-1, 1) + shv(1, -1) + shv(1, 1))
    hvwt = torch.where(torch.abs(0.5 - hvwt) < torch.abs(0.5 - hvwtalt),
                       hvwtalt, hvwt)

    dgrb0 = hvwt * vcd + (1.0 - hvwt) * hcd  # G-minus-other at R/B sites
    green = torch.where(m_rb, x + dgrb0, x)

    sgrn = _shifter(green)
    curv_h = torch.where(
        nyquist2, _sq(green - 0.5 * (sgrn(0, -1) + sgrn(0, 1))), 0.0)
    curv_v = torch.where(
        nyquist2, _sq(green - 0.5 * (sgrn(-1, 0) + sgrn(1, 0))), 0.0)
    sch, scv = _shifter(curv_h), _shifter(curv_v)

    def gquinc_avg(sq):
        return (GQUINC[0] * sq(0, 0)
                + GQUINC[1] * (sq(-1, -1) + sq(-1, 1) + sq(1, -1) + sq(1, 1))
                + GQUINC[2] * (sq(-2, 0) + sq(0, -2) + sq(0, 2) + sq(2, 0))
                + GQUINC[3] * (sq(-2, -2) + sq(-2, 2) + sq(2, -2)
                               + sq(2, 2)))

    gvarh = EPSSQ + gquinc_avg(sch)
    gvarv = EPSSQ + gquinc_avg(scv)
    dgrb0 = torch.where(nyquist2,
                        (hcd * gvarv + vcd * gvarh) * _rcp(gvarv + gvarh),
                        dgrb0)
    green = torch.where(m_rb, x + dgrb0, green)
    return torch.stack([green, hvwt])


def stage3_plain(x, pattern, s2, clips, halo=HALO):
    """Stages 7-8 (amaze.py::_stages_7to8, fast=False): diagonal R/B
    interpolation and chrominance. s2 is stage 2's (2, Hp, Wp). Returns
    the RGB stack in 0..65535 cropped by `halo` on every side:
    (3, Hp - 2*halo, Wp - 2*halo)."""
    stage3_plain.calls += 1
    green, hvwt = s2[0], s2[1]
    mr, mg, mb = _masks(pattern, x)
    clip_pt = clips[0]
    m_rb = ~mg
    s = _shifter(x)
    delh = torch.abs(s(0, 1) - s(0, -1))
    delv = torch.abs(s(1, 0) - s(-1, 0))
    dirwts0 = EPS + torch.abs(s(2, 0) - x) + torch.abs(x - s(-2, 0)) + delv
    dirwts1 = EPS + torch.abs(s(0, 2) - x) + torch.abs(x - s(0, -2)) + delh
    sd0, sd1 = _shifter(dirwts0), _shifter(dirwts1)
    dgrb0 = green - x

    # ---- stage 7: diagonal R/B interpolation
    delp = torch.abs(s(-1, 1) - s(1, -1))
    delm = torch.abs(s(1, 1) - s(-1, -1))
    dgrbsq1p = _sq(x - s(1, -1)) + _sq(x - s(-1, 1))
    dgrbsq1m = _sq(x - s(-1, -1)) + _sq(x - s(1, 1))

    crse = 2.0 * s(1, 1) * _rcp(EPS + x + s(2, 2))
    crnw = 2.0 * s(-1, -1) * _rcp(EPS + x + s(-2, -2))
    crne = 2.0 * s(-1, 1) * _rcp(EPS + x + s(-2, 2))
    crsw = 2.0 * s(1, -1) * _rcp(EPS + x + s(2, -2))

    rbse = torch.where(torch.abs(1.0 - crse) < ARTHRESH, x * crse,
                       s(1, 1) + 0.5 * (x - s(2, 2)))
    rbnw = torch.where(torch.abs(1.0 - crnw) < ARTHRESH, x * crnw,
                       s(-1, -1) + 0.5 * (x - s(-2, -2)))
    rbne = torch.where(torch.abs(1.0 - crne) < ARTHRESH, x * crne,
                       s(-1, 1) + 0.5 * (x - s(-2, 2)))
    rbsw = torch.where(torch.abs(1.0 - crsw) < ARTHRESH, x * crsw,
                       s(1, -1) + 0.5 * (x - s(2, -2)))
    del crse, crnw, crne, crsw

    sdm, sdp = _shifter(delm), _shifter(delp)
    wtse = EPS + delm + sdm(1, 1) + sdm(2, 2)
    wtnw = EPS + delm + sdm(-1, -1) + sdm(-2, -2)
    wtne = EPS + delp + sdp(-1, 1) + sdp(-2, 2)
    wtsw = EPS + delp + sdp(1, -1) + sdp(2, -2)

    rbm = (wtse * rbnw + wtnw * rbse) * _rcp(wtse + wtnw)
    rbp = (wtne * rbsw + wtsw * rbne) * _rcp(wtne + wtsw)
    del wtse, wtnw, wtne, wtsw, rbse, rbnw, rbne, rbsw

    sq1m, sq1p = _shifter(dgrbsq1m), _shifter(dgrbsq1p)
    rbvarm = EPSSQ + (
        GAUSSEVEN[0] * (sq1m(-1, 0) + sq1m(0, -1) + sq1m(0, 1) + sq1m(1, 0))
        + GAUSSEVEN[1] * (sq1m(-2, -1) + sq1m(-2, 1) + sq1m(-1, -2)
                          + sq1m(-1, 2) + sq1m(1, -2) + sq1m(1, 2)
                          + sq1m(2, -1) + sq1m(2, 1)))
    rbvarp = EPSSQ + (
        GAUSSEVEN[0] * (sq1p(-1, 0) + sq1p(0, -1) + sq1p(0, 1) + sq1p(1, 0))
        + GAUSSEVEN[1] * (sq1p(-2, -1) + sq1p(-2, 1) + sq1p(-1, -2)
                          + sq1p(-1, 2) + sq1p(1, -2) + sq1p(1, 2)
                          + sq1p(2, -1) + sq1p(2, 1)))
    pmwt = rbvarm * _rcp(rbvarp + rbvarm)
    del sq1m, sq1p, dgrbsq1m, dgrbsq1p, rbvarm, rbvarp

    # saturation bounding of rbp/rbm
    def bound_rb(rb, n_m, n_p):
        med = _med3(rb, n_m, n_p)
        strong = 2.0 * rb < x
        wt = 2.0 * (x - rb) * _rcp(EPS + rb + x)
        blended = wt * rb + (1.0 - wt) * med
        out = torch.where(rb < x, torch.where(strong, med, blended), rb)
        return torch.where(out > clip_pt, _med3(out, n_m, n_p), out)

    rbp = bound_rb(rbp, s(1, -1), s(-1, 1))
    rbm = bound_rb(rbm, s(-1, -1), s(1, 1))

    spm = _shifter(pmwt)
    pmwtalt = 0.25 * (spm(-1, -1) + spm(-1, 1) + spm(1, -1) + spm(1, 1))
    pmwt = torch.where(torch.abs(0.5 - pmwt) < torch.abs(0.5 - pmwtalt),
                       pmwtalt, pmwt)
    rbint = 0.5 * (x + rbm * (1.0 - pmwt) + rbp * pmwt)
    del rbm, rbp, pmwtalt

    # G correction where diagonal discrimination is stronger; rbint at
    # +-2 is the same-coset R/B site (the reference's half-index offsets)
    sri = _shifter(rbint)
    cru2 = s(-1, 0) * 2.0 * _rcp(EPS + rbint + sri(-2, 0))
    crd2 = s(1, 0) * 2.0 * _rcp(EPS + rbint + sri(2, 0))
    crl2 = s(0, -1) * 2.0 * _rcp(EPS + rbint + sri(0, -2))
    crr2 = s(0, 1) * 2.0 * _rcp(EPS + rbint + sri(0, 2))
    gu = torch.where(torch.abs(1.0 - cru2) < ARTHRESH, rbint * cru2,
                     s(-1, 0) + 0.5 * (rbint - sri(-2, 0)))
    gd = torch.where(torch.abs(1.0 - crd2) < ARTHRESH, rbint * crd2,
                     s(1, 0) + 0.5 * (rbint - sri(2, 0)))
    gl = torch.where(torch.abs(1.0 - crl2) < ARTHRESH, rbint * crl2,
                     s(0, -1) + 0.5 * (rbint - sri(0, -2)))
    gr = torch.where(torch.abs(1.0 - crr2) < ARTHRESH, rbint * crr2,
                     s(0, 1) + 0.5 * (rbint - sri(0, 2)))
    del cru2, crd2, crl2, crr2

    gintv = (sd0(-1, 0) * gd + sd0(1, 0) * gu) * _rcp(sd0(1, 0) + sd0(-1, 0))
    ginth = (sd1(0, -1) * gr + sd1(0, 1) * gl) * _rcp(sd1(0, -1) + sd1(0, 1))

    def bound_g2(g, n_m, n_p):
        med = _med3(g, n_m, n_p)
        strong = 2.0 * g < rbint
        wt = 2.0 * (rbint - g) * _rcp(EPS + g + rbint)
        blended = wt * g + (1.0 - wt) * med
        out = torch.where(g < rbint, torch.where(strong, med, blended), g)
        return torch.where(out > clip_pt, _med3(out, n_m, n_p), out)

    gintv = bound_g2(gintv, s(-1, 0), s(1, 0))
    ginth = bound_g2(ginth, s(0, -1), s(0, 1))

    g_diag = ginth * (1.0 - hvwt) + gintv * hvwt
    use_diag = (torch.abs(0.5 - pmwt) >= torch.abs(0.5 - hvwt)) & m_rb
    green = torch.where(use_diag, g_diag, green)
    dgrb0 = torch.where(use_diag, green - x, dgrb0)
    del gintv, ginth, g_diag, use_diag, rbint, gu, gd, gl, gr

    # ---- stage 8: chrominance; dgr valid at R sites, dgb at B sites
    dgr = torch.where(mr, dgrb0, 0.0)
    dgb = torch.where(mb, dgrb0, 0.0)

    def propagate_to_opposite(dg, m_src):
        """Interpolate Dgrb from its own coset to the opposite R/B coset."""
        sdg = _shifter(dg)
        nw, ne, sw, se = sdg(-1, -1), sdg(-1, 1), sdg(1, -1), sdg(1, 1)
        nw3, ne3, sw3, se3 = sdg(-3, -3), sdg(-3, 3), sdg(3, -3), sdg(3, 3)
        wtnw = _rcp(EPS + torch.abs(nw - se) + torch.abs(nw - nw3)
                    + torch.abs(se - nw3))
        wtne = _rcp(EPS + torch.abs(ne - sw) + torch.abs(ne - ne3)
                    + torch.abs(sw - ne3))
        wtsw = _rcp(EPS + torch.abs(sw - ne) + torch.abs(sw - se3)
                    + torch.abs(ne - sw3))
        wtse = _rcp(EPS + torch.abs(se - nw) + torch.abs(se - sw3)
                    + torch.abs(nw - se3))
        est = (wtnw * (1.325 * nw - 0.175 * nw3 - 0.075 * sdg(-1, -3)
                       - 0.075 * sdg(-3, -1))
               + wtne * (1.325 * ne - 0.175 * ne3 + -0.075 * sdg(-1, 3)
                         - 0.075 * sdg(-3, 1))
               + wtsw * (1.325 * sw - 0.175 * sw3 - 0.075 * sdg(1, -3)
                         - 0.075 * sdg(3, -1))
               + wtse * (1.325 * se - 0.175 * se3 - 0.075 * sdg(1, 3)
                         - 0.075 * sdg(3, 1))) * _rcp(wtnw + wtne + wtsw
                                                      + wtse)
        return torch.where(m_src, dg, torch.where(m_rb, est, 0.0))

    dgr = propagate_to_opposite(dgr, mr)
    dgb = propagate_to_opposite(dgb, mb)

    # at G sites: hvwt-weighted combine of the 4 cardinal R/B neighbours
    shw, sr_, sb_ = _shifter(hvwt), _shifter(dgr), _shifter(dgb)
    iwsum = _rcp(shw(-1, 0) + shw(1, 0) + (1.0 - shw(0, -1))
                 + (1.0 - shw(0, 1)))
    dgr_g = (shw(-1, 0) * sr_(-1, 0) + (1.0 - shw(0, 1)) * sr_(0, 1)
             + (1.0 - shw(0, -1)) * sr_(0, -1)
             + shw(1, 0) * sr_(1, 0)) * iwsum
    dgb_g = (shw(-1, 0) * sb_(-1, 0) + (1.0 - shw(0, 1)) * sb_(0, 1)
             + (1.0 - shw(0, -1)) * sb_(0, -1)
             + shw(1, 0) * sb_(1, 0)) * iwsum
    dgr = torch.where(mg, dgr_g, dgr)
    dgb = torch.where(mg, dgb_g, dgb)

    red = green - dgr
    blue = green - dgb
    rgb = torch.maximum(torch.stack([red, green, blue]) * 65535.0,
                        torch.zeros((), dtype=x.dtype, device=x.device))
    hp, wp = x.shape
    return rgb[:, halo : hp - halo, halo : wp - halo].contiguous()


stage1_plain.calls = 0
stage2_plain.calls = 0
stage3_plain.calls = 0


def clip_points(init_gain, device):
    """(clip_pt, clip_pt8) = (1, 0.8) / init_gain as a 2-float tensor on
    `device`, divided in float32 (the reference's `1.0 / init_gain` on
    the planner's float32 gain)."""
    g = torch.as_tensor(init_gain, dtype=torch.float32).to(device)
    num = torch.tensor([1.0, 0.8], dtype=torch.float32, device=device)
    return num / g


def padded_plane(cfa):
    """The stage kernels' input: the mosaic reflect-padded by HALO and
    divided by 65535. The divisor is a device tensor: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead."""
    xp = torch.nn.functional.pad(cfa[None, None], (HALO,) * 4,
                                 mode="reflect")[0, 0]
    return xp / torch.tensor(65535.0, dtype=xp.dtype, device=xp.device)


def amaze_demosaic(cfa, pattern, init_gain=1.0, **kw):
    """(H, W) scaled Bayer mosaic (0..65535) -> (3, H, W) RGB on cfa's
    device: reflect pad by HALO, the three stage kernels (plain versions
    on a CPU tensor), crop, then the bilinear border ring."""
    from art_tpu_torch.demosaic import amaze_kernel as ak

    clips = clip_points(init_gain, cfa.device)
    x = padded_plane(cfa)
    s1 = ak.amaze_stage1(x, pattern, clips)
    s2 = ak.amaze_stage2(x, pattern, s1)
    del s1
    rgb = ak.amaze_stage3(x, pattern, s2, clips)
    return _with_border(cfa, pattern, rgb)


def _with_border(cfa, pattern, rgb):
    """The outer BORDER ring falls back to bilinear (amaze.py::_with_border):
    computed on four strips of BORDER + 4 px, or, for an odd size, as a
    whole-plane select. Writes into `rgb` and returns it."""
    from art_tpu_torch.demosaic.bilinear import bayer_bilinear, bilinear_ring

    h, w = cfa.shape
    if h % 2 or w % 2:
        return bilinear_ring(rgb, cfa, pattern, BORDER)
    m = BORDER + 4  # strip width incl. interpolation context
    fb_top = bayer_bilinear(cfa[:m, :], pattern)
    fb_bot = bayer_bilinear(cfa[h - m :, :], pattern)
    fb_l = bayer_bilinear(cfa[:, :m], pattern)
    fb_r = bayer_bilinear(cfa[:, w - m :], pattern)
    rgb[:, :BORDER, :] = fb_top[:, :BORDER, :]
    rgb[:, h - BORDER :, :] = fb_bot[:, m - BORDER :, :]
    rgb[:, :, :BORDER] = fb_l[:, :, :BORDER]
    rgb[:, :, w - BORDER :] = fb_r[:, :, m - BORDER :]
    return rgb
