"""HTJ2K (ITU-T T.814) codestreams for the tests, from an encoder of the
tests' own: a forward 5/3 (exact) or 9/7 transform with RCT or ICT,
scalar quantisation, and for each code-block an HT cleanup pass (MagSgn,
MEL, VLC and U-VLC) with optional SigProp and MagRef passes, packed into
LRCP packets (inclusion and zero bit-plane tag trees, pass counts,
Lblock, lengths) in one or more layers, tiles and precincts, with CAP and
CPF markers if asked.

The VLC codewords come from inverting the two CxtVLC tables of the port's
decoder (`art_tpu_torch/io/native/jp2dec.cc`, read there off OpenJPEG's
binary), with OpenJPH's choice among the codewords that fit a quad. The
SigProp and MagRef passes follow the scan of OpenJPEG's decoder. Where
Pillow (OpenJPEG 2.5.4) decodes these streams to the encoder's input (a
lossless stream) or to the coefficients the encoder predicts (SigProp
and MagRef, at one resolution), the tables and the decoder's reading of
the passes are right.

OpenJPEG's convention, which the encoder follows: a block whose cleanup
pass codes bit-plane b (b = 0: the whole magnitude) carries P = Mb - 1 - b
zero bit-planes; SigProp and MagRef then code plane b - 1.
"""

import re
import struct
from pathlib import Path

import numpy as np

_SRC = (Path(__file__).resolve().parents[1] / "art_tpu_torch" / "io" /
        "native" / "jp2dec.cc")
_MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)


def decoder_tables():
    """kVlcTbl0 and kVlcTbl1 as the port's decoder holds them."""
    text = _SRC.read_text()
    out = []
    for name in ("kVlcTbl0", "kVlcTbl1"):
        body = re.search(name + r"\[1024\] = \{(.*?)\};", text, re.S).group(1)
        vals = [int(v, 16) for v in re.findall(r"0x[0-9a-f]+", body)]
        assert len(vals) == 1024
        out.append(vals)
    return out


def _encoder_tables():
    """{(table, c_q, rho, emb): (cwd, cwd_len, e_k)}: for each context and
    significance pattern, the codeword OpenJPH's encoder picks: with no
    u_off the first, else among those whose e_1 matches the samples at the
    exponent bound (emb) the one that implies the most exponent bits."""
    cands = {}
    for t, tbl in enumerate(decoder_tables()):
        for idx, e in enumerate(tbl):
            c_q, pat = idx >> 7, idx & 0x7F
            n = e & 7
            if n == 0:
                continue
            key = (t, c_q, (e >> 4) & 0xF, (e >> 3) & 1, (e >> 12) & 0xF,
                   (e >> 8) & 0xF)
            cands.setdefault(key, (pat & ((1 << n) - 1), n))
    out = {}
    for t in (0, 1):
        for c_q in range(8):
            for rho in range(16):
                for emb in range(16):
                    if emb & rho != emb or (rho == 0 and c_q == 0):
                        continue
                    best, best_k = None, -1
                    for (tt, cq, r, uo, ek, e1), (cwd, n) in sorted(
                            cands.items(), key=lambda kv: kv[1][1]):
                        if tt != t or cq != c_q or r != rho:
                            continue
                        if emb == 0:
                            if uo == 0:
                                best = (cwd, n, 0)
                                break
                        elif uo == 1 and (emb & ek) == e1:
                            k = bin(ek).count("1")
                            if k >= best_k:
                                best, best_k = (cwd, n, ek), k
                    if best is not None:
                        out[(t, c_q, rho, emb)] = best
    return out


_ENC = None


def _enc():
    global _ENC
    if _ENC is None:
        _ENC = _encoder_tables()
    return _ENC


# -- the bit writers ----------------------------------------------------------

class _Fwd:
    """MagSgn and SigProp: bits LSB first, a byte after 0xFF holds 7."""

    def __init__(self, pad):
        self.out, self.tmp, self.used, self.max, self.pad = [], 0, 0, 8, pad

    def put(self, v, n):
        for i in range(n):
            self.tmp |= ((v >> i) & 1) << self.used
            self.used += 1
            if self.used == self.max:
                self.out.append(self.tmp)
                self.max = 7 if self.tmp == 0xFF else 8
                self.tmp = self.used = 0

    def done(self):
        if self.used:
            if self.pad:
                self.tmp |= ((1 << (self.max - self.used)) - 1) << self.used
            self.out.append(self.tmp)
        return bytes(self.out)


class _Rev:
    """VLC and MagRef: bits LSB first into bytes written backwards; after
    a byte above 0x8F a byte whose low 7 bits are all 1 stops at 7."""

    def __init__(self, vlc):
        if vlc:  # the first byte's low half is Scup's, the one after it 0xFF
            self.out, self.tmp, self.used, self.gt = [], 0xF, 4, True
        else:
            self.out, self.tmp, self.used, self.gt = [], 0, 0, True

    def put(self, v, n):
        for i in range(n):
            self.tmp |= ((v >> i) & 1) << self.used
            self.used += 1
            if self.used == 7 and self.gt:
                if self.tmp == 0x7F:
                    self._emit()
                else:
                    self.gt = False
            elif self.used == 8:
                self._emit()

    def _emit(self):
        self.out.append(self.tmp)
        self.gt = self.tmp > 0x8F
        self.tmp = self.used = 0

    def done(self):
        if self.used:
            self.out.append(self.tmp)
        return bytes(reversed(self.out))


class _Mel:
    def __init__(self):
        self.out, self.tmp, self.left, self.k, self.run = [], 0, 8, 0, 0
        self.threshold = 1

    def _bit(self, v):
        self.tmp = (self.tmp << 1) | v
        self.left -= 1
        if self.left == 0:
            self.out.append(self.tmp)
            self.left = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def event(self, bit):
        if not bit:
            self.run += 1
            if self.run >= self.threshold:
                self._bit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
                self.threshold = 1 << _MEL_EXP[self.k]
        else:
            self._bit(0)
            t = _MEL_EXP[self.k]
            while t > 0:
                t -= 1
                self._bit((self.run >> t) & 1)
            self.run = 0
            self.k = max(0, self.k - 1)
            self.threshold = 1 << _MEL_EXP[self.k]

    def done(self):
        if self.run > 0:
            self._bit(1)
        if self.left != 8:
            self.out.append((self.tmp << self.left) & 0xFF)
        if self.out and self.out[-1] == 0xFF:
            # mel_init fails on a byte above 0x8F after a 0xFF
            self.out.append(0)
        return bytes(self.out)


def _uvlc_bits(u):
    """The U-VLC prefix and suffix of u >= 1 as (bits, count) pairs."""
    if u == 1:
        return [(1, 1)], []
    if u == 2:
        return [(2, 2)], []
    if u <= 4:
        return [(4, 3)], [(u - 3, 1)]
    assert u - 5 < 32, u
    return [(0, 3)], [(u - 5, 5)]


# -- the cleanup pass ---------------------------------------------------------

def _bitlen(v):
    return int(v).bit_length()


def cleanup(mu, neg):
    """The HT cleanup segment of a block of magnitudes `mu` (int array,
    (h, w)) with signs `neg`: MagSgn, then MEL, then the VLC stream
    backwards, its last two bytes carrying Scup."""
    enc = _enc()
    h, w = mu.shape
    ms, mel, vlc = _Fwd(True), _Mel(), _Rev(True)
    line = [0] * (w // 2 + 4)  # OpenJPEG's line state

    def quad(y, x):
        rho, es, mus = 0, [0] * 4, [0] * 4
        for i, (dy, dx) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
            yy, xx = y + dy, x + dx
            if yy < h and xx < w and mu[yy, xx]:
                rho |= 1 << i
                m = int(mu[yy, xx])
                mus[i] = m
                es[i] = _bitlen(2 * m - 1)
        return rho, es, mus

    def magsgn(y, x, rho, es, mus, U, ek):
        for i, (dy, dx) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
            if rho >> i & 1:
                m_n = U - ((ek >> i) & 1)
                v = 2 * (mus[i] - 1) + int(neg[y + dy, x + dx])
                ms.put(v & ((1 << m_n) - 1), m_n)

    for y in range(0, h, 2):
        first = y == 0
        t = 0 if first else 1
        lsp = 0
        ls0 = line[0]
        if not first:
            line[0] = 0
        c_q = 0
        for x in range(0, w, 4):
            quads = [quad(y, x)]
            if x + 2 < w:
                quads.append(quad(y, x + 2))
            infos = []
            for k, (rho, es, mus) in enumerate(quads):
                if not first:
                    if k == 0:
                        c_q |= ls0 >> 7
                        c_q |= (line[lsp + 1] >> 5) & 4
                    else:
                        c_q |= line[lsp + 1] >> 7
                        c_q |= (line[lsp + 2] >> 5) & 4
                emax = max(es)
                if first or not (rho & (rho - 1)):
                    kappa = 1
                else:
                    nb = (max(ls0 & 0x7F, line[lsp + 1] & 0x7F) if k == 0
                          else max(line[lsp + 1] & 0x7F,
                                   line[lsp + 2] & 0x7F))
                    kappa = 1 + max(nb - 2, 0)
                U = max(emax, kappa)
                u_off = int(U > kappa)
                emb = 0
                if u_off:
                    for i in range(4):
                        if rho >> i & 1 and es[i] == U:
                            emb |= 1 << i
                if c_q == 0:
                    mel.event(int(rho != 0))
                if rho or c_q:
                    cwd, n, ek = enc[(t, c_q, rho, emb)]
                    vlc.put(cwd, n)
                else:
                    ek = 0
                infos.append((rho, es, mus, U, u_off, kappa, ek))
                if first:
                    c_q = ((rho & 1) | ((rho >> 1) & 1)
                           | ((rho >> 2) & 1) << 1 | ((rho >> 3) & 1) << 2)
                else:
                    c_q = (((rho >> 2) & 1) | ((rho >> 3) & 1)) << 1
            while len(infos) < 2:
                infos.append((0, [0] * 4, [0] * 4, 1, 0, 1, 0))
            (r0, e0, m0, U0, o0, k0, ek0), (r1, e1, m1, U1, o1, k1, ek1) = \
                infos
            u0, u1 = U0 - k0, U1 - k1
            pre, suf = [], []
            if first and o0 and o1:
                if min(u0, u1) > 2:
                    mel.event(1)
                    p0, s0 = _uvlc_bits(u0 - 2)
                    p1, s1 = _uvlc_bits(u1 - 2)
                    pre, suf = p0 + p1, s0 + s1
                else:
                    mel.event(0)
                    p0, s0 = _uvlc_bits(u0)
                    if u0 > 2:
                        pre, suf = p0 + [(u1 - 1, 1)], s0
                    else:
                        p1, s1 = _uvlc_bits(u1)
                        pre, suf = p0 + p1, s0 + s1
            else:
                for o, u in ((o0, u0), (o1, u1)):
                    if o:
                        p, s = _uvlc_bits(u)
                        pre += p
                        suf += s
            for v, n in pre + suf:
                vlc.put(v, n)
            if not first:
                ls0 = line[lsp + 2]
                line[lsp + 1] = line[lsp + 2] = 0
            for q, (rho, es, mus, U, _, _, ek) in enumerate(infos):
                xq = x + 2 * q
                magsgn(y, xq, rho, es, mus, U, ek)
                if rho & 2:
                    line[lsp] = 0x80 | max(line[lsp] & 0x7F, es[1])
                lsp += 1
                if first:
                    line[lsp] = 0
                if rho & 8:
                    line[lsp] = 0x80 | es[3]
    ms_b, mel_b, vlc_b = ms.done(), mel.done(), vlc.done()
    scup = len(mel_b) + len(vlc_b) + 1
    assert 2 <= scup <= 4079, scup
    seg = bytearray(ms_b + mel_b + vlc_b + b"\xff")
    seg[-1] = scup >> 4
    seg[-2] = (seg[-2] & 0xF0) | (scup & 0xF)
    return bytes(seg)


# -- SigProp and MagRef (OpenJPEG's scan) -------------------------------------

def refinement(mu, bit, neg, passes, causal):
    """The SigProp (and with 3 passes MagRef) segment of a block whose
    cleanup coded the magnitudes `mu`, refining plane b - 1 whose bits are
    `bit`: (segment, new) with `new` the samples SigProp made
    significant."""
    h, w = mu.shape
    nw = (w + 7) // 8 + 2
    nstripes = (h + 3) // 4
    sig = np.zeros((nstripes + 1, nw), np.uint64)
    for y in range(h):
        for x in range(w):
            if mu[y, x]:
                sig[y // 4, x // 8] |= np.uint64(1 << ((x % 8) * 4 + y % 4))
    sig = [[int(v) for v in row] for row in sig]
    new = np.zeros((h, w), bool)
    spp, mrp = _Fwd(False), _Rev(False)
    if passes > 2:
        for s in range(nstripes):
            for i in range(0, w, 8):
                wd = sig[s][i // 8]
                for j in range(8):
                    for k in range(4):
                        if wd >> (j * 4 + k) & 1:
                            mrp.put(int(bit[4 * s + k, i + j]), 1)

    def own_mbr(s):
        out, prev = [], 0
        row = sig[s]
        for g in range(nw - 1):
            m = row[g] | (prev >> 28) | ((row[g] << 4) & 0xFFFFFFFF) | \
                (row[g] >> 4) | ((row[g + 1] << 28) & 0xFFFFFFFF)
            prev = row[g]
            z = m | ((m & 0x77777777) << 1) | ((m & 0xEEEEEEEE) >> 1)
            out.append(z & ~row[g] & 0xFFFFFFFF)
        return out + [0]

    mbr = [own_mbr(s) for s in range(nstripes)] + [[0] * nw]
    for s in range(nstripes):
        rows = min(4, h - 4 * s)
        pattern = {4: 0xFFFFFFFF, 3: 0x77777777, 2: 0x33333333,
                   1: 0x11111111}[rows]
        cur_sig, nxt_sig = sig[s], sig[s + 1]
        cur_mbr, nxt_mbr = mbr[s], mbr[s + 1]
        if s + 1 < nstripes:
            prev = 0
            for g in range(nw - 1):
                t = nxt_sig[g] | (prev >> 28) | \
                    ((nxt_sig[g] << 4) & 0xFFFFFFFF) | (nxt_sig[g] >> 4) | \
                    ((nxt_sig[g + 1] << 28) & 0xFFFFFFFF)
                prev = nxt_sig[g]
                if not causal:
                    cur_mbr[g] |= ((t & 0x11111111) << 3) & 0xFFFFFFFF
                cur_mbr[g] &= ~cur_sig[g] & 0xFFFFFFFF
        for i in range(0, w, 8):
            g = i // 8
            m = cur_mbr[g] & pattern
            new_sig = 0
            if m:
                for n in (0, 4):
                    inv = ~cur_sig[g] & pattern
                    end = n + 4 if n + 4 + i < w else w - i
                    got = []
                    for j in range(n, end):
                        if not (0xF << (4 * j)) & m:
                            continue
                        for r in range(4):
                            sm = 1 << (4 * j + r)
                            if m & sm:
                                y, x = 4 * s + r, i + j
                                b1 = int(bit[y, x])
                                spp.put(b1, 1)
                                if b1:
                                    new_sig |= sm
                                    new[y, x] = True
                                    got.append((y, x))
                                    t = ((0x32, 0x74, 0xE8, 0xC0)[r]
                                         << (4 * j)) & 0xFFFFFFFF
                                    m |= t & inv
                    for y, x in got:
                        spp.put(int(neg[y, x]), 1)
                    if n == 4:
                        t = new_sig >> 28
                        t |= ((t & 0xE) >> 1) | ((t & 7) << 1)
                        cur_mbr[g + 1] |= t & ~cur_sig[g + 1] & 0xFFFFFFFF
            new_sig |= cur_sig[g]
            ux = (new_sig & 0x88888888) >> 3
            tx = (ux | (ux << 4) | (ux >> 4)) & 0xFFFFFFFF
            if g > 0:
                nxt_mbr[g - 1] |= ((ux << 28) & 0xFFFFFFFF) & ~nxt_sig[g - 1]
            nxt_mbr[g] |= tx & ~nxt_sig[g] & 0xFFFFFFFF
            nxt_mbr[g + 1] |= (ux >> 28) & ~nxt_sig[g + 1] & 0xFFFFFFFF
    return spp.done() + mrp.done(), new


def encode_block(q, plane=0, passes=1, causal=False):
    """One code-block of quantisation indices `q` (signed ints): (its
    segments (cleanup, then the refinement segment if passes > 1), the
    words OpenJPEG's decoder leaves for it before halving or the step,
    passes), or None where the cleanup codes nothing."""
    a = np.abs(q.astype(np.int64))
    neg = q < 0
    mu = a >> plane
    if not mu.any():
        return None
    segs = [cleanup(mu, neg)]
    val = np.where(mu > 0, (2 * mu + 1) << plane, 0)
    if passes > 1:
        assert plane >= 1
        bit = (a >> (plane - 1)) & 1
        seg2, new = refinement(mu, bit, neg, passes, causal)
        segs.append(seg2)
        half = 1 << (plane - 1)
        if passes > 2:
            val = np.where(mu > 0, ((2 * mu + bit) << plane) | half, val)
        val = np.where(new, 3 << (plane - 1), val)
    return segs, np.where(neg, -val, val), passes


# -- the transform ------------------------------------------------------------

def _mirror(k, i0, i1):
    """Whole-sample symmetric extension of positions k (an int array) of
    the signal at absolute positions i0..i1-1."""
    n = i1 - i0
    if n == 1:
        return np.full_like(k, i0)
    period = 2 * (n - 1)
    r = (k - i0) % period
    return i0 + np.where(r < n, r, period - r)


def _fwd53(x, i0):
    """The reversible 5/3 analysis along axis 0 of x (n, m), its samples
    at absolute positions i0.. (low pass at the even ones): (low,
    high)."""
    n = x.shape[0]
    i1 = i0 + n
    if n == 1:
        return (x.copy(), x[:0]) if i0 % 2 == 0 else (x[:0], 2 * x)
    k = np.arange(i0 - 2, i1 + 2)
    X = x[_mirror(k, i0, i1) - i0]  # X[j] is position k[j]
    Y = X.copy()
    odd = np.nonzero(k % 2 == 1)[0]
    odd = odd[(odd >= 1) & (odd <= len(k) - 2)]
    Y[odd] = X[odd] - ((X[odd - 1] + X[odd + 1]) >> 1)
    even = np.nonzero((k % 2 == 0) & (k >= i0) & (k < i1))[0]
    Y[even] = X[even] + ((Y[even - 1] + Y[even + 1] + 2) >> 2)
    inside = (k >= i0) & (k < i1)
    return Y[inside & (k % 2 == 0)], Y[inside & (k % 2 == 1)]


_A, _B, _G, _D, _K = (-1.586134342, -0.052980118, 0.882911075,
                      0.443506852, 1.230174105)


def _fwd97(x, i0):
    """The irreversible 9/7 analysis along axis 0 (float64, OpenJPEG's
    scaling: low over K, high times K / 2)."""
    n = x.shape[0]
    i1 = i0 + n
    if n == 1:
        return (x.copy(), x[:0]) if i0 % 2 == 0 else (x[:0], 2 * x)
    k = np.arange(i0 - 4, i1 + 4)
    v = x[_mirror(k, i0, i1) - i0].astype(np.float64)
    for c, par in ((_A, 1), (_B, 0), (_G, 1), (_D, 0)):
        j = np.nonzero(k % 2 == par)[0]
        j = j[(j >= 1) & (j <= len(k) - 2)]
        v[j] = v[j] + c * (v[j - 1] + v[j + 1])
    inside = (k >= i0) & (k < i1)
    return v[inside & (k % 2 == 0)] / _K, v[inside & (k % 2 == 1)] * _K / 2


def _cdiv(a, b):
    return -(-a // b)


def analyse(a, x0, y0, levels, reversible):
    """The bands of a tile component (a: (h, w) at (x0, y0)): {(level,
    orient): array}, orient 0 LL (level `levels` only), 1 HL, 2 LH, 3 HH;
    level 1 the finest."""
    f = _fwd53 if reversible else _fwd97
    cur = a.astype(np.int64 if reversible else np.float64)
    out = {}

    def split(m, pos, axis):
        if m.shape[axis] == 0:
            return np.take(m, [], axis), np.take(m, [], axis)
        if m.shape[1 - axis] == 0:
            n = m.shape[axis]
            nl = _cdiv(pos + n, 2) - _cdiv(pos, 2)
            shape = list(m.shape)
            lo, hi = list(shape), list(shape)
            lo[axis], hi[axis] = nl, n - nl
            return np.zeros(lo, m.dtype), np.zeros(hi, m.dtype)
        if axis == 0:
            return f(m, pos)
        lo, hi = f(m.T, pos)
        return lo.T, hi.T

    for lv in range(1, levels + 1):
        lo, hi = split(cur, y0, 0)
        ll, hl = split(lo, x0, 1)
        lh, hh = split(hi, x0, 1)
        out[(lv, 1)], out[(lv, 2)], out[(lv, 3)] = hl, lh, hh
        cur, x0, y0 = ll, _cdiv(x0, 2), _cdiv(y0, 2)
    out[(levels, 0)] = cur
    return out


# -- the codestream -----------------------------------------------------------

class _Bio:
    """OpenJPEG's packet-header bit writer."""

    def __init__(self):
        self.out, self.buf, self.ct = bytearray(), 0, 8

    def bit(self, b):
        if self.ct == 0:
            self._byteout()
        self.ct -= 1
        self.buf |= b << self.ct

    def bits(self, v, n):
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def _byteout(self):
        self.out.append(self.buf & 0xFF)
        self.ct = 7 if self.buf & 0xFF == 0xFF else 8
        self.buf = 0

    def flush(self):
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class _TagTree:
    def __init__(self, h, w, values):
        self.levels = []
        vals = np.asarray(values, np.int64).reshape(h, w)
        while True:
            self.levels.append([vals, np.zeros_like(vals),
                                np.zeros(vals.shape, bool)])
            if vals.shape == (1, 1):
                break
            hh, ww = _cdiv(vals.shape[0], 2), _cdiv(vals.shape[1], 2)
            nxt = np.full((hh, ww), 1 << 40, np.int64)
            for i in range(vals.shape[0]):
                for j in range(vals.shape[1]):
                    nxt[i // 2, j // 2] = min(nxt[i // 2, j // 2], vals[i, j])
            vals = nxt

    def encode(self, bio, i, j, threshold):
        low = 0
        for lv in range(len(self.levels) - 1, -1, -1):
            vals, lows, known = self.levels[lv]
            a, b = i >> lv, j >> lv
            if low > lows[a, b]:
                lows[a, b] = low
            else:
                low = int(lows[a, b])
            while low < threshold:
                if low >= vals[a, b]:
                    if not known[a, b]:
                        bio.bit(1)
                        known[a, b] = True
                    break
                bio.bit(0)
                low += 1
            lows[a, b] = low


def _numpasses(bio, n):
    if n == 1:
        bio.bit(0)
    elif n == 2:
        bio.bits(2, 2)
    elif n <= 5:
        bio.bits(0b1100 | (n - 3), 4)
    elif n <= 36:
        bio.bits((0x1E0 | (n - 6)), 9)
    else:
        bio.bits((0xFF80 | (n - 37)), 16)


def _gain(o):
    return (0, 1, 1, 2)[o]


def encode_ht(img, levels=2, reversible=True, cblk=(6, 6), tile=None,
              layers=1, passes=1, plane=None, precincts=None, mct=None,
              markers=False, vsc=False, split=False, step_exp=1,
              mangle=None):
    """A bare HTJ2K codestream of `img` ((h, w) or (h, w, c) uint8),
    LRCP, one tile-part a tile: (codestream, expected), `expected` the
    image OpenJPEG must decode where the encoder can tell it exactly (a
    reversible stream of one pass: `img` itself; reversible with no
    level: from the predicted coefficients), else None.

    cblk: the code-block size's exponents (x, y); tile: (tw, th) or None;
    layers: block k enters in layer k % layers; passes 1, 2 or 3
    (SigProp, MagRef) at `plane` (default 0 for one pass, 1 for more);
    precincts: [(PPx, PPy)] per resolution; markers: CAP and CPF; vsc:
    the stripe-causal style bit; split: a block's SigProp and MagRef in
    the layer after its cleanup (OpenJPEG reads the first of them into
    the cleanup's segment, with no bytes); step_exp: the irreversible
    step, 2 ** -step_exp; mangle: a function of a block's segments that
    returns those to write in their place (random bytes, say)."""
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[..., None]
    h, w, nc = a.shape
    mct = (nc == 3) if mct is None else mct
    if plane is None:
        plane = 0 if passes == 1 else 1
    tw, th = tile or (w, h)
    guard = 2
    s = a.astype(np.int64) - 128
    if mct and reversible:
        r, g, b = s[..., 0], s[..., 1], s[..., 2]
        comps = [(r + 2 * g + b) >> 2, b - g, r - g]
    elif mct:
        r, g, b = (s[..., k].astype(np.float64) for k in range(3))
        comps = [0.299 * r + 0.587 * g + 0.114 * b,
                 -0.16875 * r - 0.331260 * g + 0.5 * b,
                 0.5 * r - 0.41869 * g - 0.08131 * b]
    else:
        comps = [s[..., k] for k in range(nc)]
    nb = 3 * levels + 1
    expn = []
    for c in range(nc):
        extra = 1 if (mct and reversible and c) else 0
        expn.append([8 + _gain(0 if k == 0 else (k - 1) % 3 + 1) + extra +
                     (0 if reversible else step_exp) for k in range(nb)])
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, tw, th, 0, 0, nc) + \
        b"".join(struct.pack(">BBB", 7, 1, 1) for _ in range(nc))
    style = 0x40 | (8 if vsc else 0)
    cod = struct.pack(">BBHBBBBBB", 1 if precincts else 0, 0, layers,
                      int(mct), levels, cblk[0] - 2, cblk[1] - 2, style,
                      int(reversible))
    if precincts:
        cod += bytes((pp[1] << 4) | pp[0] for pp in precincts)

    def qc(e):
        if reversible:
            return bytes([guard << 5]) + bytes(v << 3 for v in e)
        return bytes([(guard << 5) | 2]) + b"".join(
            struct.pack(">H", v << 11) for v in e)

    head = b"\xff\x4f\xff\x51" + struct.pack(">H", len(siz) + 2) + siz
    if markers:
        head += b"\xff\x50" + struct.pack(">HIH", 8, 1 << 17, 0x0020)
    head += b"\xff\x52" + struct.pack(">H", len(cod) + 2) + cod
    head += b"\xff\x5c" + struct.pack(">H", len(qc(expn[0])) + 2) + \
        qc(expn[0])
    for c in range(1, nc):
        if expn[c] != expn[0]:
            body = bytes([c]) + qc(expn[c])
            head += b"\xff\x5d" + struct.pack(">H", len(body) + 2) + body
    if markers:
        head += b"\xff\x59" + struct.pack(">HH", 4, 0)
    coef = np.zeros((h, w, nc), np.int64) if reversible and levels == 0 \
        else None
    ntx, nty = _cdiv(w, tw), _cdiv(h, th)
    out = [head]
    bno = 0
    for t in range(ntx * nty):
        tx0, ty0 = (t % ntx) * tw, (t // ntx) * th
        tx1, ty1 = min(tx0 + tw, w), min(ty0 + th, h)
        res_prec = {}
        for c in range(nc):
            bands = analyse(comps[c][ty0:ty1, tx0:tx1], tx0, ty0, levels,
                            reversible)
            for r in range(levels + 1):
                n = levels - r
                rx0, ry0 = _cdiv(tx0, 1 << n), _cdiv(ty0, 1 << n)
                rx1, ry1 = _cdiv(tx1, 1 << n), _cdiv(ty1, 1 << n)
                ppx, ppy = precincts[r] if precincts else (15, 15)
                res_prec[(r, c)] = []
                if rx0 == rx1 or ry0 == ry1:
                    continue
                px0, py0 = rx0 >> ppx, ry0 >> ppy
                pw = _cdiv(rx1, 1 << ppx) - px0
                ph = _cdiv(ry1, 1 << ppy) - py0
                bppx, bppy = (ppx, ppy) if r == 0 else (ppx - 1, ppy - 1)
                cbw, cbh = min(cblk[0], bppx), min(cblk[1], bppy)
                lv = levels if r == 0 else levels + 1 - r
                for pj in range(ph):
                    for pi in range(pw):
                        pb = []
                        for o in ([0] if r == 0 else [1, 2, 3]):
                            hh = (1 << (lv - 1)) if lv else 0
                            bx0 = _cdiv(tx0 - (o & 1) * hh, 1 << lv)
                            by0 = _cdiv(ty0 - (o >> 1) * hh, 1 << lv)
                            bx1 = _cdiv(tx1 - (o & 1) * hh, 1 << lv)
                            by1 = _cdiv(ty1 - (o >> 1) * hh, 1 << lv)
                            if bx0 >= bx1 or by0 >= by1:
                                continue
                            band = bands[(lv, o)]
                            k = 0 if r == 0 else 3 * (levels - lv) + o
                            mb = guard + expn[c][k] - 1
                            step = 2.0 ** (8 + _gain(o) - expn[c][k])
                            qx0 = max(bx0, (px0 + pi) << bppx)
                            qy0 = max(by0, (py0 + pj) << bppy)
                            qx1 = min(bx1, (px0 + pi + 1) << bppx)
                            qy1 = min(by1, (py0 + pj + 1) << bppy)
                            gw = gh = 0
                            if qx0 < qx1 and qy0 < qy1:
                                gx0, gy0 = qx0 >> cbw, qy0 >> cbh
                                gw = _cdiv(qx1, 1 << cbw) - gx0
                                gh = _cdiv(qy1, 1 << cbh) - gy0
                            blocks = []
                            for gj in range(gh):
                                for gi in range(gw):
                                    cx0 = max(qx0, (gx0 + gi) << cbw)
                                    cy0 = max(qy0, (gy0 + gj) << cbh)
                                    cx1 = min(qx1, (gx0 + gi + 1) << cbw)
                                    cy1 = min(qy1, (gy0 + gj + 1) << cbh)
                                    v = band[cy0 - by0:cy1 - by0,
                                             cx0 - bx0:cx1 - bx0]
                                    if reversible:
                                        qv = v.astype(np.int64)
                                    else:
                                        qv = (np.sign(v) * np.floor(
                                            np.abs(v) / step)).astype(np.int64)
                                    assert np.all(np.abs(qv) < (1 << mb))
                                    res = encode_block(qv, plane, passes, vsc)
                                    if res and mangle:
                                        res = (mangle(res[0]),) + res[1:]
                                    blocks.append(dict(
                                        res=res, P=mb - 1 - plane,
                                        layer=bno % layers if res else None))
                                    bno += 1
                                    if coef is not None and res:
                                        vals = res[1]
                                        coef[cy0:cy1, cx0:cx1, c] = \
                                            np.sign(vals) * (np.abs(vals) >> 1)
                            pb.append(dict(gw=gw, blocks=blocks))
                        res_prec[(r, c)].append(pb)
        data = bytearray()
        state = {}
        for layno in range(layers):
            for r in range(levels + 1):
                for c in range(nc):
                    for k, pb in enumerate(res_prec[(r, c)]):
                        data += _packet(pb, layno, layers, split, state,
                                        (r, c, k))
        sot = struct.pack(">HHIBB", 10, t, 12 + 2 + len(data), 0, 1)
        out.append(b"\xff\x90" + sot + b"\xff\x93" + bytes(data))
    out.append(b"\xff\xd9")
    cs = b"".join(out)
    if reversible and passes == 1 and plane == 0:
        return cs, a[..., 0] if nc == 1 else a
    if coef is not None:
        if mct:
            y, u, v = coef[..., 0], coef[..., 1], coef[..., 2]
            g = y - ((u + v) >> 2)
            coef = np.stack([v + g, g, u + g], -1)
        img = np.clip(coef + 128, 0, 255).astype(np.uint8)
        return cs, img[..., 0] if nc == 1 else img
    return cs, None


def _packet(pb, layno, layers, split, state, key):
    """One packet: its header (OpenJPEG's bit stuffing) and body."""
    bio = _Bio()
    body = bytearray()
    contrib = []
    for bi, band in enumerate(pb):
        blocks = band["blocks"]
        if key + (bi,) not in state:
            gw = band["gw"]
            gh = len(blocks) // gw if gw else 0
            incl = [b["layer"] if b["layer"] is not None else 1 << 30
                    for b in blocks]
            state[key + (bi,)] = dict(
                incl=_TagTree(gh, gw, incl) if blocks else None,
                imsb=_TagTree(gh, gw, [b["P"] for b in blocks])
                if blocks else None,
                lbits=[3] * len(blocks), seen=[False] * len(blocks))
        for n, b in enumerate(blocks):
            parts = []
            if b["res"]:
                segs, _, npass = b["res"]
                rest = [(npass - 1, segs[1])] if npass > 1 else []
                if split and rest:
                    if layno == b["layer"]:
                        parts = [(1, segs[0])]
                    elif layno == b["layer"] + 1:
                        if npass == 2:
                            parts = [(1, segs[1])]
                        else:
                            parts = [(1, b""), (npass - 2, segs[1])]
                elif layno == b["layer"]:
                    parts = [(1, segs[0])] + rest
            contrib.append((bi, n, b, parts))
    if not any(parts for *_, parts in contrib):
        bio.bit(0)
        return bio.flush()
    bio.bit(1)
    for bi, n, b, parts in contrib:
        st = state[key + (bi,)]
        gw = pb[bi]["gw"]
        i, j = n // gw, n % gw
        if not st["seen"][n]:
            st["incl"].encode(bio, i, j, layno + 1)
            if not parts:
                continue
            st["imsb"].encode(bio, i, j, b["P"] + 1)
            st["seen"][n] = True
        else:
            bio.bit(1 if parts else 0)
            if not parts:
                continue
        _numpasses(bio, sum(k for k, _ in parts))
        need = max(len(d).bit_length() - (k.bit_length() - 1)
                   for k, d in parts)
        inc = max(0, need - st["lbits"][n])
        bio.bits((1 << (inc + 1)) - 2, inc + 1)
        st["lbits"][n] += inc
        for k, d in parts:
            bio.bits(len(d), st["lbits"][n] + k.bit_length() - 1)
            body += d
    return bio.flush() + bytes(body)


# -- the committed fixtures (tests/data, chip_smoke.py's U1 and U2) -----------

def _scene(h, w, seed, noise):
    """A smooth colour scene with Gaussian noise, (h, w, 3) uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.sin(x / 23.0) * 60 + np.cos(y / 17.0) * 50 + 128
    a = np.stack([base + 25 * k * np.sin((x + y) / (40.0 + 9 * k))
                  + rng.normal(0, noise, (h, w)) for k in range(3)], -1)
    return np.clip(a, 0, 255).astype(np.uint8)


def fixtures():
    """{name: bytes} of the fixtures of chip_smoke.py's U1 and U2: U1's
    one-tile HTJ2K streams (a 512x512 9/7 stream with SigProp and MagRef
    passes, a 256x256 lossless 5/3 one), an old-style JPEG grey
    TIFF, YCbCr TIFFs in separate planes and in tiles, an IPTC/NAA file
    with a JPEG band; U2's Hald (level 6, reversible 5/3 with SigProp and
    MagRef at plane 2, a JP2) and mask (f2_mask at Q2_MASK, a lossless
    one-component codestream)."""
    import io

    import chip_smoke
    import util_plugins
    import util_tiff
    from PIL import Image

    out = {}
    cs, _ = encode_ht(_scene(512, 512, 26, 2.7), levels=3, reversible=False,
                      passes=3, plane=1, step_exp=0)
    out["u1_htj2k_97_sigprop_tile.j2k"] = cs
    out["u1_htj2k_53_tile.j2k"], _ = encode_ht(_scene(256, 256, 27, 0.0),
                                               levels=3)
    pic = _scene(61, 83, 28, 4.0)
    out["u1_tiff_ojpeg_grey.tif"] = util_tiff.ojpeg_grey(
        pic[:48, :80, 1], photo=1, tables=True, rows=8, restart=10)
    rng = np.random.default_rng(29)
    y, cb, cr = (pic[..., k] for k in range(3))
    out["u1_tiff_ycbcr_planar.tif"] = util_tiff.ycbcr_planar(
        y, cb, cr, comp=8, rows=16, predictor=2)
    sub = rng.integers(0, 256, (2, 31, 42), dtype=np.uint8)
    out["u1_tiff_ycbcr_tiled.tif"] = util_tiff.ycbcr_tiled(
        y, sub[0], sub[1], 2, 2, tw=32, th=16, comp=5)
    bio = io.BytesIO()
    Image.fromarray(pic[..., 2]).save(bio, "JPEG", quality=90)
    out["u1_iptc_jpeg_band.iim"] = util_plugins.iptc_jpeg(
        bio.getvalue(), 83, 61, layers=3, band=2)
    hald = chip_smoke.hald_image(6, 8)
    cs, _ = encode_ht(hald, levels=3, passes=3, plane=2)
    out["u2_htj2k_hald6.jp2"] = chip_smoke.jp2_wrap(cs, *hald.shape[:2], 3)
    mask = chip_smoke.f2_mask(*chip_smoke.Q2_MASK).astype(np.uint8)
    cs, _ = encode_ht(mask, levels=3, cblk=(5, 5))
    out["u2_htj2k_mask.j2k"] = cs
    return out
