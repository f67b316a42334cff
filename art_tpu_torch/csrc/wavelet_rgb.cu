// Wavelet denoise for Hopper: the fused RGB kernel (B4) and the stacked
// plane kernel (B5), sharing the sigma and level kernels.
//
// B4 replaces art_tpu/ops/wavelet_pallas.py::_run_rgb / _kernel_rgb, the
// Pallas TPU kernel of the fused denoise: optional raw head (WB, clip,
// cam2work), gain and forward gamma, YUV split, 5-level B3 a-trous
// decomposition with a per-tile MAD noise sigma, 3x3-energy shrink,
// reconstruction, inverse YUV and inverse gamma.
//
// B5 replaces wavelet_pallas.py::_run / _kernel: the same 5-level chain
// on C stacked planes (the non-fused denoise's Y, U and V), with each
// plane's [sigma, strength, blend] row and no gamma, YUV or head. Its
// tiles are 256 x 1024 on the plane reflect-padded up to whole tiles
// (_pad_to_tiles), so its sigma grid is 2-D: at 4096 x 6016, 16 x 6
// windows of 384 x 1152 per plane.
//
// The functions need about 0.4 ms of f32 operations and 0.18 ms of bytes
// at 24 MP; the chain's intermediates do not fit on chip. The TPU kernel
// kept one 384 x (tx+128) window per plane in VMEM (about 9.4 MB a plane
// at 24 MP); a Hopper block has at most 227 KB of shared memory. So the
// padded planes live in device memory, and each kernel keeps what it
// derives from them in shared memory, loaded by cp.async (16 bytes a
// copy where the columns allow):
//
// - the noise sigma (win_max_kernel, win_hist_kernel, select_kernel):
//   sigma = median(|d0|)/0.6745 over the tile's 384 x (tx+128) window by
//   14 bisection steps from lo = 0, hi = max|d0|, with d0's blur
//   wrapping around inside the window (jnp.roll). The mids of those
//   steps form a fixed binary tree for a given max; walking a value down
//   it by the same comparisons (a <= mid) gives a 14-bit leaf, and the
//   count of values <= mid at every node of the bisection's path is a
//   prefix sum of the 16,384-leaf histogram (nested intervals, integer
//   counts): exact. So |d0| is never stored. Two passes recompute it
//   from a shared-memory tile of the window with a 2-pixel ring, the
//   first for the window's max, the second for the histogram (64 KB of
//   shared memory a block, added into a per-window histogram in device
//   memory); the second finds each value's place among the top 10
//   levels of the tree in a table of their mids and walks the last 4. A
//   block per window then walks the 14 steps and applies count/n < 0.5
//   as the reference does. The passes run as many blocks as the card
//   holds at once, each over a contiguous run of the (window, tile)
//   pairs.
// - each level (level_kernel): one kernel loads a tile of the level's
//   input with its 2s+1 halo into shared memory (clamped at the padded
//   plane's edge), blurs it vertically then horizontally there, writes
//   the smooth plane (the next level's input) over the whole padded
//   plane, and shrinks the detail cur - smooth by its 3x3 energy on the
//   tile's interior, adding it to acc. The last level writes no smooth
//   plane: it adds the residual to the sum, which is the output (B5) or
//   the tail's input (B4). A thread computes 4 vertical blurs s rows
//   apart, and 4 shrinks down a column, from shared loads.
//
// Device memory moves about 8 GB per 24 MP call (head, two sigma reads of
// the windows, five levels of one read of the input, one write of the
// smooth plane and acc's read and write, the tail): about 2.7 ms at the
// card's rate. What holds it above that on an H100 is issue and latency
// more than bytes: the levels run at 1.5-2.2 TB/s, the deepest (s = 16)
// reads its 33-pixel halo about 5 times over from L2, and the histogram
// pass spends most of its time placing and counting values. Tensor cores
// and wgmma do not apply: these are 5-tap dilated f32 stencils and a
// selection, TF32 or bf16 would break the bit-equality with the plain
// version, and the f32 rate is not the limit.
//
// Everything outside the sigma reaches at most 63 pixels, inside the
// 64-pixel halo, so the levels run over the whole padded plane with
// clamped indexing at its outer edge (never read by a kept output). The
// shrink gain divides exactly; the TPU kernel used its approximate
// reciprocal there (about 5e-4 relative).

// Built with -fmad=false (kernels.py): no multiply-add contraction, so
// each operation rounds as in the plain PyTorch version, in the same
// order.

#include <cstdio>

#include <cuda_runtime.h>

namespace {

constexpr int TILE_Y = 256;
constexpr int PAD = 64;
constexpr int LEVELS = 5;
constexpr int BISECT = 14;
constexpr int LEAVES = 1 << BISECT;
constexpr int MAXK = 32;
constexpr int NPV = 26;
constexpr int THREADS = 256;

// the sigma passes: a tile of SIG_H x SIG_W window values and its 2-pixel
// ring, loaded 4 columns a copy from 4 columns left of the tile
constexpr int SIG_H = 32, SIG_W = 128;
constexpr int SIG_LH = SIG_H + 4, SIG_LW = SIG_W + 8;
// pass B finds a value's place among the top TOP levels of the bisection
// tree in a table of their mids, then walks the rest
constexpr int TOP = 10, TOPN = (1 << TOP) - 1;
constexpr size_t HIST_SMEM =
    sizeof(float) * (LEAVES + TOPN + 1 + SIG_LH * SIG_LW + SIG_H * SIG_LW);

// each level's output tile (rows x columns) by level, chosen by timing
// whole tables on an H100: 64 x 64 up to s = 4, 32 x 96 at s = 8 and 16,
// where the halo is wide and a taller tile leaves room for fewer blocks
// an SM
constexpr int LEVEL_TH[LEVELS] = {64, 64, 64, 32, 32};
constexpr int LEVEL_TW[LEVELS] = {64, 64, 64, 96, 96};

// B3 spline taps in the reference's accumulation order: centre, -2, -1,
// +1, +2 (all exact in float)
constexpr float K_C = 0.375f;
constexpr float K_2 = 0.0625f;
constexpr float K_1 = 0.25f;

__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// P(u) + t*Q(u), u = 2t^2 - 1, highest power first
__device__ __forceinline__ float horner_split(float t, const float* p,
                                              const float* q, int k) {
  float u = 2.0f * t * t - 1.0f;
  float accp = p[0];
  for (int i = 1; i < k; ++i) accp = accp * u + p[i];
  float accq = q[0];
  for (int i = 1; i < k; ++i) accq = accq * u + q[i];
  return accp + t * accq;
}

// 4-byte copy from device to shared memory without a register (sm_80+):
// a thread issues all of its tile's copies, then waits once, so they are
// all in flight together
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// sum over the block, returned to every thread (s: THREADS/32 words)
__device__ __forceinline__ unsigned int block_sum(unsigned int v,
                                                  unsigned int* s) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned int t = 0;
  for (int k = 0; k < THREADS / 32; ++k) t += s[k];
  __syncthreads();
  return t;
}

// tile pad (to hp) and halo pad (PAD) are both numpy-style reflect pads
__global__ void head_kernel(const float* __restrict__ rgb,
                            float* __restrict__ yuv,
                            const float* __restrict__ pv,
                            const float* __restrict__ cf, int kf, int h,
                            int w, int hp, int wp, int pre) {
  __shared__ float s_pv[NPV];
  __shared__ float s_cf[2 * MAXK];
  const int npv = pre ? NPV : 14;
  for (int i = threadIdx.x; i < npv; i += blockDim.x) s_pv[i] = pv[i];
  for (int i = threadIdx.x; i < 2 * kf; i += blockDim.x)
    s_cf[(i / kf) * MAXK + i % kf] = cf[i];
  __syncthreads();
  const int ww = wp + 2 * PAD, hh = hp + 2 * PAD;
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y;
  if (px >= ww) return;
  const int sy = reflect(reflect(py - PAD, hp), h);
  const int sx = reflect(reflect(px - PAD, wp), w);
  const size_t plane = (size_t)h * w;
  const size_t src = (size_t)sy * w + sx;
  float r = rgb[src], g = rgb[plane + src], b = rgb[2 * plane + src];
  if (pre) {
    const float* q = s_pv + 14;
    float r0 = fminf(fmaxf(r * q[0], 0.0f), 65535.0f);
    float g0 = fminf(fmaxf(g * q[1], 0.0f), 65535.0f);
    float b0 = fminf(fmaxf(b * q[2], 0.0f), 65535.0f);
    r = q[3] * r0 + q[4] * g0 + q[5] * b0;
    g = q[6] * r0 + q[7] * g0 + q[8] * b0;
    b = q[9] * r0 + q[10] * g0 + q[11] * b0;
  }
  const float gain = s_pv[3];
  float v[3] = {r, g, b};
  for (int c = 0; c < 3; ++c) {
    float x = clip01(v[c] * gain);
    float wv = sqrtf(sqrtf(sqrtf(x)));
    v[c] = horner_split(2.0f * wv - 1.0f, s_cf, s_cf + MAXK, kf);
  }
  const float y = s_pv[0] * v[0] + s_pv[1] * v[1] + s_pv[2] * v[2];
  const size_t o = (size_t)py * ww + px;
  const size_t P = (size_t)hh * ww;
  yuv[o] = y;
  yuv[P + o] = y - v[2];
  yuv[2 * P + o] = v[0] - y;
}

// B5's pad: the tile pad (to hp, wp) and the halo (PAD), both numpy
// reflect pads, as one gather per plane
__global__ void pad_kernel(const float* __restrict__ x,
                           float* __restrict__ cur, int h, int w, int hp,
                           int wp) {
  const int ww = wp + 2 * PAD, hh = hp + 2 * PAD;
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y;
  const int c = blockIdx.z;
  if (px >= ww) return;
  const int sy = reflect(reflect(py - PAD, hp), h);
  const int sx = reflect(reflect(px - PAD, wp), w);
  cur[(size_t)c * hh * ww + (size_t)py * ww + px] =
      x[(size_t)c * h * w + (size_t)sy * w + sx];
}

// Window wc = window * nc + plane of the sigma passes: its first value
// in the plane stack, and whether its plane's sigma is pinned (prm[c] >=
// 0: the window's MAD is not used). Each window has TILES tiles of
// SIG_H x SIG_W values.
struct Window {
  const float* p;
  int wy, wx, ntx;
  bool pinned;
};

__device__ __forceinline__ Window window_of(int wc, const float* cur,
                                            const float* prm, int hh,
                                            int ww, int tx, int nbx,
                                            int nc) {
  const int win = wc / nc, c = wc % nc;
  Window W;
  W.wy = TILE_Y + 2 * PAD;
  W.wx = tx + 2 * PAD;
  W.p = cur + (size_t)c * hh * ww + (size_t)(win / nbx) * TILE_Y * ww +
        (size_t)(win % nbx) * tx;
  W.ntx = (W.wx + SIG_W - 1) / SIG_W;
  W.pinned = prm[c] >= 0.0f;
  return W;
}

__host__ __device__ __forceinline__ int window_tiles(int tx) {
  return ((TILE_Y + 2 * PAD + SIG_H - 1) / SIG_H) *
         ((tx + 2 * PAD + SIG_W - 1) / SIG_W);
}

// This block's share of the nwc * window_tiles(tx) (window, tile) pairs of
// a sigma pass: a contiguous run [g0, g1), so a block flushes what it
// gathered once per window it touches
__device__ __forceinline__ void block_run(int nwc, int tx, long long* g0,
                                          long long* g1) {
  const long long total = (long long)nwc * window_tiles(tx);
  *g0 = blockIdx.x * total / gridDim.x;
  *g1 = (blockIdx.x + 1LL) * total / gridDim.x;
}

// |d0| of tile t of window W, the level-0 blur wrapping inside the
// window as the reference's jnp.roll does: f(value) for each value in
// the window. cs (SIG_LH x SIG_LW) and ts (SIG_H x SIG_LW): shared.
template <class F>
__device__ __forceinline__ void absd_tile(const Window& W, int ww, int t,
                                          float* cs, float* ts, F f) {
  // windows start on a multiple of 4 columns and are a multiple of 4 wide
  // (tx is), so each 4 columns lie in the window or wrap whole: one
  // 16-byte copy
  constexpr int LW4 = SIG_LW / 4;
  const int ty = (t / W.ntx) * SIG_H, tx0 = (t % W.ntx) * SIG_W;
  for (int i = threadIdx.x; i < SIG_LH * LW4; i += THREADS) {
    const int r = i / LW4, q = 4 * (i % LW4);
    int yy = ty + r - 2, xx = tx0 + q - 4;
    yy += yy < 0 ? W.wy : 0;
    yy -= yy >= W.wy ? W.wy : 0;
    xx += xx < 0 ? W.wx : 0;
    xx -= xx >= W.wx ? W.wx : 0;
    cp_async16(cs + r * SIG_LW + q, W.p + (size_t)yy * ww + xx);
  }
  cp_async_wait();
  __syncthreads();
  for (int i = threadIdx.x; i < SIG_H * SIG_LW; i += THREADS) {
    const float* a = cs + i + 2 * SIG_LW;
    float v = K_C * a[0];
    v = v + K_2 * a[-2 * SIG_LW];
    v = v + K_1 * a[-SIG_LW];
    v = v + K_1 * a[SIG_LW];
    v = v + K_2 * a[2 * SIG_LW];
    ts[i] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SIG_H * SIG_W; i += THREADS) {
    const int r = i / SIG_W, q = i % SIG_W;
    if (ty + r >= W.wy || tx0 + q >= W.wx) continue;
    const float* b = ts + r * SIG_LW + q + 4;
    float sm = K_C * b[0];
    sm = sm + K_2 * b[-2];
    sm = sm + K_1 * b[-1];
    sm = sm + K_1 * b[1];
    sm = sm + K_2 * b[2];
    f(fabsf(cs[(r + 2) * SIG_LW + q + 4] - sm));
  }
  __syncthreads();  // the next tile overwrites cs and ts
}

// sigma pass A: each window's max |d0|, by atomicMax on the float bits
// (all >= 0); wmax zeroed by the caller
__global__ void __launch_bounds__(THREADS)
    win_max_kernel(const float* __restrict__ cur, float* __restrict__ wmax,
                   const float* __restrict__ prm, int hh, int ww, int tx,
                   int nbx, int nc, int nwc) {
  __shared__ float cs[SIG_LH * SIG_LW];
  __shared__ float ts[SIG_H * SIG_LW];
  __shared__ float s_m[THREADS / 32];
  const int per = window_tiles(tx);
  long long g, g1;
  block_run(nwc, tx, &g, &g1);
  while (g < g1) {
    const int wc = (int)(g / per);
    const long long end = min(g1, (wc + 1LL) * per);
    const Window W = window_of(wc, cur, prm, hh, ww, tx, nbx, nc);
    if (W.pinned) {
      g = end;
      continue;
    }
    float m = 0.0f;
    for (; g < end; ++g)
      absd_tile(W, ww, (int)(g - (long long)wc * per), cs, ts,
                [&](float a) { m = fmaxf(m, a); });
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) s_m[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 1; k < THREADS / 32; ++k) m = fmaxf(m, s_m[k]);
      atomicMax(reinterpret_cast<int*>(wmax) + wc, __float_as_int(m));
    }
    __syncthreads();
  }
}

// The mids of the top TOP levels of the bisection tree from (0, top), in
// order: entry e lies between leaves e and e + 1 of those levels. The node
// at depth d covering leaves [f, f + 2^(TOP-d)) has its mid halfway, and
// its interval runs between the entries before and after those leaves
// (0 and top at the ends), which shallower depths filled.
__device__ void top_mids(float top, float* tbl) {
  for (int d = 0; d < TOP; ++d) {
    const int span = 1 << (TOP - d);
    for (int j = threadIdx.x; j < (1 << d); j += THREADS) {
      const int f = j * span;
      const float lo = j == 0 ? 0.0f : tbl[f - 1];
      const float hi = j == (1 << d) - 1 ? top : tbl[f + span - 1];
      tbl[f + span / 2 - 1] = 0.5f * (lo + hi);
    }
    __syncthreads();
  }
}

// sigma pass B: each window's histogram of the bisection tree's leaves.
// A value's leaf is its path down the tree of mids that 14 bisection
// steps from (0, max) can visit, by the steps' own comparison a <= mid
// (bit 1: a > mid, the step's lo moves up). Those mids are ordered, so
// the path through the top TOP levels ends at the count of their mids
// below the value, found from an estimate and a step or two in the
// table, between the two mids around it as lo and hi; the last levels
// are walked. hist zeroed by the caller.
__global__ void __launch_bounds__(THREADS)
    win_hist_kernel(const float* __restrict__ cur,
                    const float* __restrict__ wmax,
                    unsigned int* __restrict__ hist,
                    const float* __restrict__ prm, int hh, int ww, int tx,
                    int nbx, int nc, int nwc) {
  extern __shared__ float sh[];
  unsigned int* hs = reinterpret_cast<unsigned int*>(sh);
  float* tbl = sh + LEAVES;
  float* cs = tbl + TOPN + 1;
  float* ts = cs + SIG_LH * SIG_LW;
  const int per = window_tiles(tx);
  long long g, g1;
  block_run(nwc, tx, &g, &g1);
  for (int i = threadIdx.x; i < LEAVES; i += THREADS) hs[i] = 0u;
  __syncthreads();
  while (g < g1) {
    const int wc = (int)(g / per);
    const long long end = min(g1, (wc + 1LL) * per);
    const Window W = window_of(wc, cur, prm, hh, ww, tx, nbx, nc);
    if (W.pinned) {
      g = end;
      continue;
    }
    const float top = wmax[wc];
    top_mids(top, tbl);
    const float scale = top > 0.0f ? (float)(1 << TOP) / top : 0.0f;
    for (; g < end; ++g)
      absd_tile(W, ww, (int)(g - (long long)wc * per), cs, ts, [&](float a) {
        const float f = a * scale;
        int e = f < (float)TOPN ? (f >= 0.0f ? (int)f : 0) : TOPN;
        while (e > 0 && !(tbl[e - 1] < a)) --e;
        while (e < TOPN && tbl[e] < a) ++e;
        float lo = e > 0 ? tbl[e - 1] : 0.0f;
        float hi = e < TOPN ? tbl[e] : top;
        unsigned int leaf = (unsigned int)e;
#pragma unroll
        for (int k = TOP; k < BISECT; ++k) {
          const float mid = 0.5f * (lo + hi);
          const bool up = !(a <= mid);
          lo = up ? mid : lo;
          hi = up ? hi : mid;
          leaf = 2u * leaf + (up ? 1u : 0u);
        }
        atomicAdd(hs + leaf, 1u);
      });
    // absd_tile ended with a barrier: the counts are complete
    unsigned int* dst = hist + (size_t)wc * LEAVES;
    for (int i = threadIdx.x; i < LEAVES; i += THREADS)
      if (hs[i]) {
        atomicAdd(dst + i, hs[i]);
        hs[i] = 0u;
      }
    __syncthreads();
  }
}

// The 14 bisection steps of each window from its histogram, one block a
// window: at each step the count of values <= mid is the count below the
// current node plus the node's left half; then sigma = the final mid /
// 0.6745, or the plane's pinned value. prm: (3, nc) rows sigma, strength,
// blend per plane (sigma < 0: the window's MAD; B4 passes pv + 4, whose
// rows are laid out the same).
__global__ void __launch_bounds__(THREADS)
    select_kernel(const unsigned int* __restrict__ hist,
                  const float* __restrict__ wmax,
                  const float* __restrict__ prm, float* __restrict__ sigma,
                  int n, int nc) {
  __shared__ unsigned int s_part[THREADS / 32];
  const int wc = blockIdx.x;
  const float pinned = prm[wc % nc];
  if (pinned >= 0.0f) {
    if (threadIdx.x == 0) sigma[wc] = pinned;
    return;
  }
  const unsigned int* hw = hist + (size_t)wc * LEAVES;
  float lo = 0.0f, hi = wmax[wc];
  unsigned int node = 0u, below = 0u;
  for (int k = 0; k < BISECT; ++k) {
    const int half = LEAVES >> (k + 1);
    const unsigned int* left = hw + ((size_t)node << (BISECT - k));
    unsigned int part = 0u;
    for (int i = threadIdx.x; i < half; i += THREADS) part += left[i];
    const unsigned int cnt = below + block_sum(part, s_part);
    const float mid = 0.5f * (lo + hi);
    const bool go_up = (float)cnt / (float)n < 0.5f;
    lo = go_up ? mid : lo;
    hi = go_up ? hi : mid;
    below = go_up ? cnt : below;
    node = 2u * node + (go_up ? 1u : 0u);
  }
  if (threadIdx.x == 0)
    sigma[wc] = 0.5f * (lo + hi) * (float)(1.0 / 0.6745);
}

enum Mode { FIRST, MIDDLE, LAST };

// shared memory of level_kernel<S, TH, TW, MODE>, in floats, laid out
// as the kernel lays it out: the tile of cur (LH x LW), its vertical blur
// (MH x LW), and (MIDDLE, LAST) the tile's sum so far and (LAST) its
// smooth values
template <int S, int TH, int TW, Mode MODE>
constexpr int level_floats() {
  constexpr int R = 2 * S + 1, RA = (R + 3) / 4 * 4;
  constexpr int LH = TH + 2 * R, LW = TW + 2 * RA, MH = TH + 2;
  return (LH + MH) * LW + (MODE == FIRST ? 0 : TH * TW) +
         (MODE == LAST ? TH * TW : 0);
}

// One level at spacing S on a TH x TW tile of every plane: the separable
// blur of cur in shared memory (clamped at the padded plane's edge, as
// the plain version's shifts clamp), the smooth plane written over the
// whole padded plane (not at the LAST level), and the detail cur - smooth
// shrunk by its 3x3 energy against the band's noise on the tile's
// interior: acc = val (FIRST), acc += val (MIDDLE), or dst = (acc + val)
// + smooth on dst's dh x dw corner of the interior (LAST: the residual
// added, no smooth plane written).
template <int S, int TH, int TW, Mode MODE>
__global__ void __launch_bounds__(THREADS)
    level_kernel(const float* __restrict__ cur, float* __restrict__ smooth,
                 float* acc, float* dst, const float* __restrict__ sigma,
                 const float* __restrict__ prm, int hp, int wp, int tx,
                 int nbx, int nc, int dh, int dw) {
  constexpr int R = 2 * S + 1;  // the blur's reach plus the shrink's ring
  // the tile of cur: R rows above and below, RA >= R columns on each side
  // (the tile's columns start on a 16-byte boundary)
  constexpr int RA = (R + 3) / 4 * 4;
  constexpr int LH = TH + 2 * R, LW = TW + 2 * RA, LW4 = LW / 4;
  constexpr int MH = TH + 2, MW = TW + 2;  // smooth and detail: + ring
  static_assert(TW % 4 == 0, "tiles start on 16-byte boundaries");
  extern __shared__ float sh[];
  float* cs = sh;              // cur; the detail over its MH x MW centre
  float* ts = cs + LH * LW;    // the vertical blur, MH x LW
  float* as = ts + MH * LW;    // the sum so far, TH x TW
  float* ss = as + TH * TW;    // LAST: the smooth values, TH x TW
  const int hh = hp + 2 * PAD, ww = wp + 2 * PAD;
  const int c = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)c * hh * ww;
  const float* p = cur + plane;
  // rows are 16-byte aligned (ww % 4 == 0): 4 columns a copy, clamped
  // one by one where they cross the plane's edge
  for (int i = threadIdx.x; i < LH * LW4; i += THREADS) {
    const int r = i / LW4, q = 4 * (i % LW4);
    const float* row = p + (size_t)min(max(y0 - R + r, 0), hh - 1) * ww;
    const int xx = x0 - RA + q;
    float* to = cs + r * LW + q;
    if (xx >= 0 && xx + 4 <= ww) {
      cp_async16(to, row + xx);
    } else {
      for (int e = 0; e < 4; ++e)
        cp_async(to + e, row + min(max(xx + e, 0), ww - 1));
    }
  }
  // the tile's interior position i (of TH x TW) in the plane's interior
  // (cy, cx); false outside it
  auto inner = [&](int i, int& cy, int& cx) {
    cy = y0 + i / TW - PAD;
    cx = x0 + i % TW - PAD;
    return cy >= 0 && cy < hp && cx >= 0 && cx < wp;
  };
  float* accp = acc + (size_t)c * hp * wp;
  // 4 interior positions a copy: the interior's edges (0, hp, wp) and
  // wp are multiples of 4
  if (MODE != FIRST)
    for (int i = 4 * threadIdx.x; i < TH * TW; i += 4 * THREADS) {
      int cy, cx;
      if (inner(i, cy, cx)) cp_async16(as + i, accp + (size_t)cy * wp + cx);
    }
  const float strength = prm[nc + c], blend = prm[2 * nc + c];
  cp_async_wait();
  __syncthreads();
  // the vertical blur, V rows S apart a thread: row r reads cs rows r,
  // r + S, ..., r + 4S, so the V rows share V + 4 loads
  constexpr int NR = (MH + S - 1) / S;  // rows of a residue class mod S
  constexpr int V = NR < 4 ? NR : 4;
  constexpr int NM = (NR + V - 1) / V;
  for (int it = threadIdx.x; it < NM * S * LW; it += THREADS) {
    const int q = it % LW, rest = it / LW;
    const int base = rest % S + S * V * (rest / S);
    float a[V + 4];
#pragma unroll
    for (int u = 0; u < V + 4; ++u)
      if (base + S * (u < 4 ? 0 : u - 4) < MH)
        a[u] = cs[(base + S * u) * LW + q];
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (base + S * k < MH) {
        float v = K_C * a[k + 2];
        v = v + K_2 * a[k];
        v = v + K_1 * a[k + 1];
        v = v + K_1 * a[k + 3];
        v = v + K_2 * a[k + 4];
        ts[(base + S * k) * LW + q] = v;
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MH * MW; i += THREADS) {
    const int r = i / MW, j = i % MW;
    const float* b = ts + r * LW + j + RA - 1;
    float sm = K_C * b[0];
    sm = sm + K_2 * b[-2 * S];
    sm = sm + K_1 * b[-S];
    sm = sm + K_1 * b[S];
    sm = sm + K_2 * b[2 * S];
    const bool mine = r >= 1 && r <= TH && j >= 1 && j <= TW;
    const int y = y0 - 1 + r, x = x0 - 1 + j;
    if (MODE != LAST && mine && y < hh && x < ww)
      smooth[plane + (size_t)y * ww + x] = sm;
    if (MODE == LAST && mine) ss[(r - 1) * TW + j - 1] = sm;
    float* d = cs + (r + R - 1) * LW + j + RA - 1;
    *d = *d - sm;
  }
  __syncthreads();
  // the shrink, 4 rows a thread: they share 6 x 3 details and squares
  constexpr int VS = 4;
  static_assert(TH % VS == 0, "whole runs of rows");
  for (int it = threadIdx.x; it < TH / VS * TW; it += THREADS) {
    const int j = it % TW, r0 = VS * (it / TW);
    const int cx = x0 + j - PAD;
    if (cx < 0 || cx >= wp) continue;
    float e[VS + 2][3], dc[VS];
#pragma unroll
    for (int u = 0; u < VS + 2; ++u)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float dv = cs[(r0 - 1 + R + u) * LW + j + RA - 1 + q];
        e[u][q] = dv * dv;
        if (q == 1 && u >= 1 && u <= VS) dc[u - 1] = dv;
      }
    // bands are the full width (nbx 1) or 1024 columns wide
    const int bx = nbx == 1 ? 0 : cx >> 10;
#pragma unroll
    for (int k = 0; k < VS; ++k) {
      const int cy = y0 + r0 + k - PAD;
      if (cy < 0 || cy >= hp) continue;
      float s3[3];
      for (int q = 0; q < 3; ++q)
        s3[q] = (e[k + 1][q] + e[k + 2][q]) + e[k][q];
      const float e9 = ((s3[1] + s3[2]) + s3[0]) * (float)(1.0 / 9.0);
      const int band = (cy / TILE_Y) * nbx + bx;
      const float st = strength * sigma[band * nc + c] * (1.0f / (float)S);
      const float t2 = st * st;
      const float dd = dc[k] * (e9 / (e9 + t2 + 1e-12f));
      const float val = dd + (dc[k] - dd) * blend;
      const int i = (r0 + k) * TW + j;
      const size_t o = (size_t)cy * wp + cx;
      if (MODE == FIRST) {
        accp[o] = val;
      } else if (MODE == MIDDLE) {
        accp[o] = as[i] + val;
      } else if (cy < dh && cx < dw) {
        dst[(size_t)c * dh * dw + (size_t)cy * dw + cx] =
            (as[i] + val) + ss[i];
      }
    }
  }
}

// the sum (residual and details) to RGB: inverse YUV, inverse gamma,
// crop to (h, w)
__global__ void tail_kernel(const float* __restrict__ yuv,
                            float* __restrict__ out,
                            const float* __restrict__ pv,
                            const float* __restrict__ ci, int ki, int h,
                            int w, int hp, int wp) {
  __shared__ float s_ci[2 * MAXK];
  for (int i = threadIdx.x; i < 2 * ki; i += blockDim.x)
    s_ci[(i / ki) * MAXK + i % ki] = ci[i];
  __syncthreads();
  const int cx = blockIdx.x * blockDim.x + threadIdx.x;
  const int cy = blockIdx.y;
  if (cx >= w) return;
  const size_t ic = (size_t)cy * wp + cx, PC = (size_t)hp * wp;
  const float y2 = yuv[ic], u2 = yuv[PC + ic], v2 = yuv[2 * PC + ic];
  const float lw0 = pv[0], lw1 = pv[1], lw2 = pv[2], inv_gain = pv[13];
  const float b2 = y2 - u2;
  const float r2 = v2 + y2;
  const float g2 = (y2 - r2 * lw0 - b2 * lw2) / lw1;
  const float v[3] = {r2, g2, b2};
  const size_t po = (size_t)h * w, o = (size_t)cy * w + cx;
  for (int c = 0; c < 3; ++c) {
    const float t = 2.0f * sqrtf(clip01(v[c])) - 1.0f;
    out[c * po + o] = horner_split(t, s_ci, s_ci + MAXK, ki) * inv_gain;
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }
inline int imin(int a, int b) { return a < b ? a : b; }
inline int imax(int a, int b) { return a > b ? a : b; }

#define ART_CHECK(expr)                        \
  do {                                         \
    cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)
#define ART_LAUNCH_CHECK() ART_CHECK(cudaGetLastError())

// as many blocks of fn as the card holds at once (at most `work`): each
// sigma pass block walks a run of tiles, so one wave covers them all
template <class K>
cudaError_t resident_grid(K fn, size_t smem, long long work, int* grid) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, THREADS,
                                                      smem);
  *grid = (int)(work < (long long)imax(per, 1) * sms
                    ? work
                    : (long long)imax(per, 1) * sms);
  return e;
}

template <int L>
constexpr Mode level_mode() {
  return L == 0 ? FIRST : (L == LEVELS - 1 ? LAST : MIDDLE);
}

template <int L>
constexpr size_t level_smem() {
  return sizeof(float) *
         level_floats<1 << L, LEVEL_TH[L], LEVEL_TW[L], level_mode<L>()>();
}

template <int L>
auto level_fn() {
  return level_kernel<1 << L, LEVEL_TH[L], LEVEL_TW[L], level_mode<L>()>;
}

struct Chain {
  float *cur, *smooth, *acc, *dst;
  const float *sigma, *prm;
  int hp, wp, tx, nbx, nc, dh, dw;
};

template <int L>
int launch_level(const Chain& a, cudaStream_t st) {
  constexpr size_t smem = level_smem<L>();
  const auto fn = level_fn<L>();
  ART_CHECK(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  const dim3 grid(cdiv(a.wp + 2 * PAD, LEVEL_TW[L]),
                  cdiv(a.hp + 2 * PAD, LEVEL_TH[L]), a.nc);
  fn<<<grid, THREADS, smem, st>>>(a.cur, a.smooth, a.acc, a.dst, a.sigma,
                                  a.prm, a.hp, a.wp, a.tx, a.nbx, a.nc,
                                  a.dh, a.dw);
  ART_LAUNCH_CHECK();
  return 0;
}

template <int L>
int run_levels(Chain a, cudaStream_t st) {
  if constexpr (L < LEVELS) {
    const int rc = launch_level<L>(a, st);
    if (rc != 0) return rc;
    float* t = a.cur;  // the smooth plane is the next level's input
    a.cur = a.smooth;
    a.smooth = t;
    return run_levels<L + 1>(a, st);
  }
  return 0;
}

// The chain shared by B4 and B5, from the nc padded planes (hh x ww) in
// the first of the two stacks of `planes`: the per-(tile, plane) noise
// sigma on the reference's grid (two passes over the windows and a walk
// of their histograms), then one kernel per level, each level's smooth
// plane going to the other stack. The last level writes the sum of the
// details and the residual to dst, cropped to dh x dw per plane.
int run_chain(float* planes, float* acc, unsigned int* hist, float* wmax,
              float* sigma, const float* prm, int nc, int hp, int wp,
              int tx, float* dst, int dh, int dw, cudaStream_t st) {
  const int hh = hp + 2 * PAD, ww = wp + 2 * PAD;
  if (wp % 4 || tx % 4)  // 16-byte rows and windows
    return (int)cudaErrorInvalidValue;
  const int nbx = wp / tx;
  const int nwc = (hp / TILE_Y) * nbx * nc;
  const int wy = TILE_Y + 2 * PAD, wx = tx + 2 * PAD;
  const long long pairs = (long long)nwc * window_tiles(tx);
  ART_CHECK(cudaMemsetAsync(wmax, 0, sizeof(float) * nwc, st));
  ART_CHECK(cudaMemsetAsync(hist, 0, sizeof(unsigned int) * LEAVES * nwc,
                            st));
  int grid = 0;
  ART_CHECK(resident_grid(win_max_kernel, 0, pairs, &grid));
  win_max_kernel<<<grid, THREADS, 0, st>>>(planes, wmax, prm, hh, ww, tx, nbx,
                                           nc, nwc);
  ART_LAUNCH_CHECK();
  ART_CHECK(cudaFuncSetAttribute(win_hist_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)HIST_SMEM));
  ART_CHECK(resident_grid(win_hist_kernel, HIST_SMEM, pairs, &grid));
  win_hist_kernel<<<grid, THREADS, HIST_SMEM, st>>>(planes, wmax, hist, prm,
                                                    hh, ww, tx, nbx, nc, nwc);
  ART_LAUNCH_CHECK();
  select_kernel<<<nwc, THREADS, 0, st>>>(hist, wmax, prm, sigma, wy * wx,
                                        nc);
  ART_LAUNCH_CHECK();
  const size_t stack = (size_t)nc * hh * ww;
  return run_levels<0>(Chain{planes, planes + stack, acc, dst, sigma, prm,
                             hp, wp, tx, nbx, nc, dh, dw},
                       st);
}

// one line of art_wavelet_layout's report: the bytes used after it, or
// minus the CUDA error
template <class K>
int describe(char* buf, int cap, int used, const char* name, K fn,
             size_t dyn, int th, int tw) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return -(int)e;
  if (used >= cap - 1) return used;
  char tile[32] = "";
  if (th > 0) snprintf(tile, sizeof tile, ", tile %dx%d", th, tw);
  const int n = snprintf(
      buf + used, cap - used,
      "%s: %d registers, %zu B static + %zu B dynamic shared memory, %zu B "
      "local (spills and stack)%s\n",
      name, fa.numRegs, fa.sharedSizeBytes, dyn, fa.localSizeBytes, tile);
  return n < 0 ? used : imin(cap, used + n);
}

template <int L>
int describe_levels(char* buf, int cap, int used) {
  if constexpr (L < LEVELS) {
    char name[32];
    snprintf(name, sizeof name, "level_kernel s=%d", 1 << L);
    used = describe(buf, cap, used, name, level_fn<L>(), level_smem<L>(),
                    LEVEL_TH[L], LEVEL_TW[L]);
    if (used < 0) return used;
    return describe_levels<L + 1>(buf, cap, used);
  }
  return used;
}

}  // namespace

// B4: rgb (3,h,w) -> out (3,h,w). Scratch from the caller: planes
// 2 x (3,hh,ww) (each level's input and smooth plane), acc (3,hp,wp),
// hist (nwc, 16384) ints, wmax (nwc), sigma (nwc); nwc = (hp/256)*(wp/tx)*3.
extern "C" int art_wavelet_rgb(const float* rgb, float* out, float* planes,
                               float* acc, unsigned int* hist, float* wmax,
                               float* sigma, const float* pv, const float* cf,
                               const float* ci, int kf, int ki, int h, int w,
                               int hp, int wp, int tx, int pre,
                               void* stream) {
  if (kf < 1 || kf > MAXK || ki < 1 || ki > MAXK || hp % TILE_Y ||
      wp % tx || (wp != tx && tx != 1024) || h > hp || w > wp ||
      h < PAD + 1 || w < PAD + 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hh = hp + 2 * PAD, ww = wp + 2 * PAD;
  head_kernel<<<dim3(cdiv(ww, THREADS), hh), THREADS, 0, st>>>(
      rgb, planes, pv, cf, kf, h, w, hp, wp, pre);
  ART_LAUNCH_CHECK();
  // the last level leaves the denoised Y, U, V in acc
  const int rc = run_chain(planes, acc, hist, wmax, sigma, pv + 4, 3, hp, wp,
                           tx, acc, hp, wp, st);
  if (rc != 0) return rc;
  tail_kernel<<<dim3(cdiv(w, THREADS), h), THREADS, 0, st>>>(
      acc, out, pv, ci, ki, h, w, hp, wp);
  ART_LAUNCH_CHECK();
  return 0;
}

// B5: x (nc,h,w) -> out (nc,h,w), tiles of 256 x 1024 on the plane
// reflect-padded to (hp, wp) = whole tiles. prm: (3, nc) rows sigma,
// strength, blend. Scratch as for B4 with nc planes and tx = 1024.
extern "C" int art_wavelet_multi(const float* x, float* out, float* planes,
                                 float* acc, unsigned int* hist, float* wmax,
                                 float* sigma, const float* prm, int nc,
                                 int h, int w, int hp, int wp,
                                 void* stream) {
  constexpr int TX = 1024;
  if (nc < 1 || hp % TILE_Y || wp % TX || h > hp || w > wp || h < TILE_Y ||
      w < TX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hh = hp + 2 * PAD, ww = wp + 2 * PAD;
  pad_kernel<<<dim3(cdiv(ww, THREADS), hh, nc), THREADS, 0, st>>>(
      x, planes, h, w, hp, wp);
  ART_LAUNCH_CHECK();
  return run_chain(planes, acc, hist, wmax, sigma, prm, nc, hp, wp, TX, out,
                   h, w, st);
}

// The kernels' registers, shared memory (static, and dynamic as launched)
// and local memory, one line each, into buf (cap bytes, NUL-terminated).
extern "C" int art_wavelet_layout(char* buf, int cap) {
  if (cap < 1) return (int)cudaErrorInvalidValue;
  buf[0] = '\0';
  int used = 0;
  used = describe(buf, cap, used, "head_kernel", head_kernel, 0, 0, 0);
  if (used >= 0)
    used = describe(buf, cap, used, "pad_kernel", pad_kernel, 0, 0, 0);
  if (used >= 0)
    used = describe(buf, cap, used, "win_max_kernel", win_max_kernel, 0,
                    SIG_H, SIG_W);
  if (used >= 0)
    used = describe(buf, cap, used, "win_hist_kernel", win_hist_kernel,
                    HIST_SMEM, SIG_H, SIG_W);
  if (used >= 0)
    used = describe(buf, cap, used, "select_kernel", select_kernel, 0, 0, 0);
  if (used >= 0) used = describe_levels<0>(buf, cap, used);
  if (used >= 0)
    used = describe(buf, cap, used, "tail_kernel", tail_kernel, 0, 0, 0);
  return used < 0 ? -used : 0;
}
