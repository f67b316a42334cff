// Wavelet denoise for Hopper: the fused RGB kernel (B4) and the stacked
// plane kernel (B5), sharing the sigma, blur and shrink passes.
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
// What bounds it here: memory traffic. The TPU kernel kept one 384 x
// (tx+128) window per plane in VMEM (about 9.4 MB a plane at 24 MP);
// a Hopper block has at most 227 KB of shared memory. So the chain runs
// as passes over whole padded planes in device memory, all bands at
// once: head -> per-window sigma -> (vertical blur, horizontal blur,
// shrink-accumulate) x 5 levels -> tail. Every pass reads and writes
// each plane element about once, neighbouring threads on neighbouring
// addresses, with the stencil taps served from L1/L2. Fusing the blur
// passes through shared-memory tiles is later work.
//
// The sigma grid is the reference's and must not move: tiles of 256 rows
// by tx columns (B4: full-width bands where they fit; B5: tx = 1024),
// sigma = median(|d0|)/0.6745 over the tile's 384 x (tx+128) window by
// 14 bisection steps, with d0's blur wrapping around inside the window
// (jnp.roll). The window pass stores |d0| per window (the windows
// overlap) and each bisection step is an integer count, so count/n < 0.5
// decides as the reference's float mean does. Everything
// else reaches at most 63 pixels, inside the 64-pixel halo, so the
// level passes run over the whole padded plane with clamped indexing at
// its outer edge (never read by a kept output).
//
// The shrink gain divides exactly; the TPU kernel used its approximate
// reciprocal there (about 5e-4 relative).

// Built with -fmad=false (kernels.py): no multiply-add contraction, so
// each operation rounds as in the plain PyTorch version, in the same
// order.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_Y = 256;
constexpr int PAD = 64;
constexpr int LEVELS = 5;
constexpr int BISECT = 14;
constexpr int MAXK = 32;
constexpr int NPV = 26;
constexpr int THREADS = 256;

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

// dilated B3 taps along rows (vertical) with clamped indexing
__global__ void blur_v_kernel(const float* __restrict__ a,
                              float* __restrict__ o, int hh, int ww, int s) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= ww) return;
  const float* p = a + (size_t)blockIdx.z * hh * ww + x;
  auto at = [&](int yy) {
    yy = min(max(yy, 0), hh - 1);
    return p[(size_t)yy * ww];
  };
  float col = K_C * at(y);
  col = col + K_2 * at(y - 2 * s);
  col = col + K_1 * at(y - s);
  col = col + K_1 * at(y + s);
  col = col + K_2 * at(y + 2 * s);
  o[(size_t)blockIdx.z * hh * ww + (size_t)y * ww + x] = col;
}

__global__ void blur_h_kernel(const float* __restrict__ a,
                              float* __restrict__ o, int hh, int ww, int s) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= ww) return;
  const float* p = a + (size_t)blockIdx.z * hh * ww + (size_t)y * ww;
  auto at = [&](int xx) { return p[min(max(xx, 0), ww - 1)]; };
  float v = K_C * at(x);
  v = v + K_2 * at(x - 2 * s);
  v = v + K_1 * at(x - s);
  v = v + K_1 * at(x + s);
  v = v + K_2 * at(x + 2 * s);
  o[(size_t)blockIdx.z * hh * ww + (size_t)y * ww + x] = v;
}

// |d0| over each band's window, the level-0 blur wrapping inside the
// window; also the window's max via atomicMax on the float bits (>= 0)
__global__ void win_absd_kernel(const float* __restrict__ yuv,
                                float* __restrict__ absd,
                                float* __restrict__ lohi, int hh, int ww,
                                int tx, int nbx, int nc) {
  const int wc = blockIdx.y;
  const int win = wc / nc, c = wc % nc;
  const int wy = TILE_Y + 2 * PAD, wx = tx + 2 * PAD;
  const int oy = (win / nbx) * TILE_Y, ox = (win % nbx) * tx;
  const float* p = yuv + (size_t)c * hh * ww + (size_t)oy * ww + ox;
  const size_t n = (size_t)wy * wx;
  float* dst = absd + (size_t)wc * n;
  float m = 0.0f;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int yy = (int)(i / wx), xx = (int)(i % wx);
    int ys[5], xs[5];
    const int off[5] = {0, -2, -1, 1, 2};
    for (int k = 0; k < 5; ++k) {
      ys[k] = (yy + off[k] + wy) % wy;
      xs[k] = (xx + off[k] + wx) % wx;
    }
    auto col = [&](int x) {
      const float* q = p + x;
      float v = K_C * q[(size_t)ys[0] * ww];
      v = v + K_2 * q[(size_t)ys[1] * ww];
      v = v + K_1 * q[(size_t)ys[2] * ww];
      v = v + K_1 * q[(size_t)ys[3] * ww];
      v = v + K_2 * q[(size_t)ys[4] * ww];
      return v;
    };
    float sm = K_C * col(xs[0]);
    sm = sm + K_2 * col(xs[1]);
    sm = sm + K_1 * col(xs[2]);
    sm = sm + K_1 * col(xs[3]);
    sm = sm + K_2 * col(xs[4]);
    const float ad = fabsf(p[(size_t)yy * ww + xx] - sm);
    dst[i] = ad;
    m = fmaxf(m, ad);
  }
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float s_m[THREADS / 32];
  if ((threadIdx.x & 31) == 0) s_m[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k) m = fmaxf(m, s_m[k]);
    atomicMax(reinterpret_cast<int*>(lohi) + 2 * wc + 1, __float_as_int(m));
  }
}

// one bisection step's count of |d0| <= mid per (window, plane)
__global__ void count_kernel(const float* __restrict__ absd,
                             const float* __restrict__ lohi,
                             unsigned int* __restrict__ cnt, int n) {
  const int wc = blockIdx.y;
  const float mid = 0.5f * (lohi[2 * wc] + lohi[2 * wc + 1]);
  const float* a = absd + (size_t)wc * n;
  unsigned int k = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    k += a[i] <= mid ? 1u : 0u;
  for (int o = 16; o > 0; o >>= 1) k += __shfl_xor_sync(0xffffffffu, k, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(cnt + wc, k);
}

__global__ void bisect_kernel(float* __restrict__ lohi,
                              unsigned int* __restrict__ cnt, int nwc,
                              int n) {
  const int wc = blockIdx.x * blockDim.x + threadIdx.x;
  if (wc >= nwc) return;
  const float lo = lohi[2 * wc], hi = lohi[2 * wc + 1];
  const float mid = 0.5f * (lo + hi);
  const bool go_up = (float)cnt[wc] / (float)n < 0.5f;
  lohi[2 * wc] = go_up ? mid : lo;
  lohi[2 * wc + 1] = go_up ? hi : mid;
  cnt[wc] = 0;
}

// prm: (3, nc) rows sigma, strength, blend per plane (sigma < 0: the
// window's MAD; B4 passes pv + 4, whose rows are laid out the same)
__global__ void sigma_kernel(const float* __restrict__ lohi,
                             const float* __restrict__ prm,
                             float* __restrict__ sigma, int nwc, int nc) {
  const int wc = blockIdx.x * blockDim.x + threadIdx.x;
  if (wc >= nwc) return;
  const float pinned = prm[wc % nc];
  const float mad = 0.5f * (lohi[2 * wc] + lohi[2 * wc + 1]) *
                    (float)(1.0 / 0.6745);
  sigma[wc] = pinned < 0.0f ? mad : pinned;
}

// shrink the centre's detail d = cur - smooth by its 3x3 energy against
// the band's noise and add it to acc (written at level 0)
__global__ void shrink_kernel(const float* __restrict__ cur,
                              const float* __restrict__ sm,
                              float* __restrict__ acc,
                              const float* __restrict__ sigma,
                              const float* __restrict__ prm, int hp, int wp,
                              int tx, int nbx, int nc, float level_scale,
                              int first) {
  const int cx = blockIdx.x * blockDim.x + threadIdx.x;
  const int cy = blockIdx.y;
  const int c = blockIdx.z;
  if (cx >= wp) return;
  const int hh = hp + 2 * PAD, ww = wp + 2 * PAD;
  const size_t base =
      (size_t)c * hh * ww + (size_t)(cy + PAD) * ww + (cx + PAD);
  float d[3][3];
  for (int dy = -1; dy <= 1; ++dy)
    for (int dx = -1; dx <= 1; ++dx) {
      const size_t i = base + (long long)dy * ww + dx;
      d[dy + 1][dx + 1] = cur[i] - sm[i];
    }
  float s[3];
  for (int j = 0; j < 3; ++j)
    s[j] = (d[1][j] * d[1][j] + d[2][j] * d[2][j]) + d[0][j] * d[0][j];
  const float e9 = ((s[1] + s[2]) + s[0]) * (float)(1.0 / 9.0);
  const int band = (cy / TILE_Y) * nbx + cx / tx;
  const float st = prm[nc + c] * sigma[band * nc + c] * level_scale;
  const float t2 = st * st;
  const float dc = d[1][1];
  const float dd = dc * (e9 / (e9 + t2 + 1e-12f));
  const float val = dd + (dc - dd) * prm[2 * nc + c];
  const size_t o = (size_t)c * hp * wp + (size_t)cy * wp + cx;
  acc[o] = first ? val : acc[o] + val;
}

// residual + details, inverse YUV, inverse gamma, crop to (h, w)
__global__ void tail_kernel(const float* __restrict__ acc,
                            const float* __restrict__ cur,
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
  const int hh = hp + 2 * PAD, ww = wp + 2 * PAD;
  const size_t ic = (size_t)cy * wp + cx;
  const size_t ip = (size_t)(cy + PAD) * ww + (cx + PAD);
  const size_t PC = (size_t)hp * wp, PP = (size_t)hh * ww;
  const float y2 = acc[ic] + cur[ip];
  const float u2 = acc[PC + ic] + cur[PP + ip];
  const float v2 = acc[2 * PC + ic] + cur[2 * PP + ip];
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

// B5's tail: residual + details, cropped to (h, w)
__global__ void multi_tail_kernel(const float* __restrict__ acc,
                                  const float* __restrict__ cur,
                                  float* __restrict__ out, int h, int w,
                                  int hp, int wp) {
  const int cx = blockIdx.x * blockDim.x + threadIdx.x;
  const int cy = blockIdx.y;
  const int c = blockIdx.z;
  if (cx >= w) return;
  const int hh = hp + 2 * PAD, ww = wp + 2 * PAD;
  out[(size_t)c * h * w + (size_t)cy * w + cx] =
      acc[(size_t)c * hp * wp + (size_t)cy * wp + cx] +
      cur[(size_t)c * hh * ww + (size_t)(cy + PAD) * ww + (cx + PAD)];
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }
inline int imin(int a, int b) { return a < b ? a : b; }

#define ART_LAUNCH_CHECK()                          \
  do {                                              \
    cudaError_t e_ = cudaGetLastError();            \
    if (e_ != cudaSuccess) return (int)e_;          \
  } while (0)

// The chain shared by B4 and B5, from the padded planes in planes[0]
// (nc planes of hh x ww; planes holds 3 such stacks: cur, blur tmp,
// smooth): the per-(tile, plane) noise sigma on the reference's grid,
// then the 5 levels of blur and shrink-accumulate into acc. *cur_out is
// the stack that holds the residual at the end.
int run_chain(float* planes, float* acc, float* absd, float* lohi,
              unsigned int* cnt, float* sigma, const float* prm, int nc,
              int hp, int wp, int tx, cudaStream_t st, float** cur_out) {
  const int hh = hp + 2 * PAD, ww = wp + 2 * PAD;
  const size_t stack = (size_t)nc * hh * ww;
  float* cur = planes;
  float* tmp = planes + stack;
  float* smooth = planes + 2 * stack;

  const int nbx = wp / tx;
  const int nwc = (hp / TILE_Y) * nbx * nc;
  const int n = (TILE_Y + 2 * PAD) * (tx + 2 * PAD);
  cudaError_t e = cudaMemsetAsync(lohi, 0, sizeof(float) * 2 * nwc, st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(cnt, 0, sizeof(unsigned int) * nwc, st);
  if (e != cudaSuccess) return (int)e;
  const dim3 wgrid(imin(cdiv(n, THREADS * 8), 512), nwc);
  win_absd_kernel<<<wgrid, THREADS, 0, st>>>(cur, absd, lohi, hh, ww, tx,
                                             nbx, nc);
  ART_LAUNCH_CHECK();
  for (int it = 0; it < BISECT; ++it) {
    count_kernel<<<wgrid, THREADS, 0, st>>>(absd, lohi, cnt, n);
    ART_LAUNCH_CHECK();
    bisect_kernel<<<cdiv(nwc, THREADS), THREADS, 0, st>>>(lohi, cnt, nwc, n);
    ART_LAUNCH_CHECK();
  }
  sigma_kernel<<<cdiv(nwc, THREADS), THREADS, 0, st>>>(lohi, prm, sigma, nwc,
                                                      nc);
  ART_LAUNCH_CHECK();

  const dim3 fgrid(cdiv(ww, THREADS), hh, nc);
  const dim3 cgrid(cdiv(wp, THREADS), hp, nc);
  for (int lv = 0; lv < LEVELS; ++lv) {
    const int s = 1 << lv;
    blur_v_kernel<<<fgrid, THREADS, 0, st>>>(cur, tmp, hh, ww, s);
    ART_LAUNCH_CHECK();
    blur_h_kernel<<<fgrid, THREADS, 0, st>>>(tmp, smooth, hh, ww, s);
    ART_LAUNCH_CHECK();
    shrink_kernel<<<cgrid, THREADS, 0, st>>>(cur, smooth, acc, sigma, prm, hp,
                                             wp, tx, nbx, nc,
                                             1.0f / (float)s, lv == 0);
    ART_LAUNCH_CHECK();
    float* t = cur;  // the smooth plane is the next level's input
    cur = smooth;
    smooth = t;
  }
  *cur_out = cur;
  return 0;
}

}  // namespace

// B4: rgb (3,h,w) -> out (3,h,w). Scratch from the caller: planes
// 3 x (3,hh,ww) (cur, blur tmp, smooth), acc (3,hp,wp), absd (nwc, wy*wx),
// lohi (nwc,2), cnt (nwc) ints, sigma (nwc); nwc = (hp/256)*(wp/tx)*3.
extern "C" int art_wavelet_rgb(const float* rgb, float* out, float* planes,
                               float* acc, float* absd, float* lohi,
                               unsigned int* cnt, float* sigma,
                               const float* pv, const float* cf,
                               const float* ci, int kf, int ki, int h, int w,
                               int hp, int wp, int tx, int pre,
                               void* stream) {
  if (kf < 1 || kf > MAXK || ki < 1 || ki > MAXK || hp % TILE_Y ||
      wp % tx || h > hp || w > wp || h < PAD + 1 || w < PAD + 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hh = hp + 2 * PAD, ww = wp + 2 * PAD;
  head_kernel<<<dim3(cdiv(ww, THREADS), hh), THREADS, 0, st>>>(
      rgb, planes, pv, cf, kf, h, w, hp, wp, pre);
  ART_LAUNCH_CHECK();
  float* cur = nullptr;
  const int rc = run_chain(planes, acc, absd, lohi, cnt, sigma, pv + 4, 3,
                           hp, wp, tx, st, &cur);
  if (rc != 0) return rc;
  tail_kernel<<<dim3(cdiv(w, THREADS), h), THREADS, 0, st>>>(
      acc, cur, out, pv, ci, ki, h, w, hp, wp);
  ART_LAUNCH_CHECK();
  return 0;
}

// B5: x (nc,h,w) -> out (nc,h,w), tiles of 256 x 1024 on the plane
// reflect-padded to (hp, wp) = whole tiles. prm: (3, nc) rows sigma,
// strength, blend. Scratch as for B4 with nc planes and tx = 1024.
extern "C" int art_wavelet_multi(const float* x, float* out, float* planes,
                                 float* acc, float* absd, float* lohi,
                                 unsigned int* cnt, float* sigma,
                                 const float* prm, int nc, int h, int w,
                                 int hp, int wp, void* stream) {
  constexpr int TX = 1024;
  if (nc < 1 || hp % TILE_Y || wp % TX || h > hp || w > wp || h < TILE_Y ||
      w < TX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hh = hp + 2 * PAD, ww = wp + 2 * PAD;
  pad_kernel<<<dim3(cdiv(ww, THREADS), hh, nc), THREADS, 0, st>>>(
      x, planes, h, w, hp, wp);
  ART_LAUNCH_CHECK();
  float* cur = nullptr;
  const int rc = run_chain(planes, acc, absd, lohi, cnt, sigma, prm, nc, hp,
                           wp, TX, st, &cur);
  if (rc != 0) return rc;
  multi_tail_kernel<<<dim3(cdiv(w, THREADS), h, nc), THREADS, 0, st>>>(
      acc, cur, out, h, w, hp, wp);
  ART_LAUNCH_CHECK();
  return 0;
}
