// Neutral tone curve for Hopper (kernel B7).
//
// Replaces art_tpu/ops/tonecurve_neutral.py::_run_neutral_pallas /
// _neutral_kernel: per pixel, gamut compression toward the output space,
// the brightness-preserving tone curve, Jzazbz hue twists and
// saturation compensation (_neutral_core), then optionally the output
// epilogue: work->out matrix, clip to [0,1], sRGB encode (_epilogue).
//
// What bounds it here: it reads 12 and writes 12 bytes a pixel and
// spends ~1,100 float operations on them (nine polynomial PQ transfers,
// three curve evaluations, the atan2 polynomial, ~56 IEEE square roots
// and ~15 IEEE divisions), so at 24 MP it is bound by the instructions it
// issues, not by device memory. The design issues little besides that
// arithmetic:
//
// - Every constant is an operand of the instruction that uses it, read
//   from a constant bank, not a shared-memory load of its own: the 86
//   host-fitted constants travel by value in the kernel's parameters
//   (struct Consts), and the per-image params and curve coefficients,
//   which lie on the device, are copied device to device into the
//   __constant__ block c_pc on the launch stream (no read-back to the
//   host). c_pc is one per library and device: launches that share it
//   must be ordered on one stream, as the wrapper's are.
// - The kernel is a template on the curve's form (rows, coefficients)
//   and the epilogue, for each form the planner fits (FORMS), so every
//   loop unrolls and every index into the constants is known.
// - One thread a pixel, THREADS a block. On an H100 (700 W) 2 or 4
//   pixels a thread (as float2, float4) ran slower, and no block of 128
//   to 1,024 threads beat 256 (a tuning build not kept): the kernel is
//   bound by the instructions it issues, which more pixels a thread do
//   not reduce.
//
// The float32 forms are the reference's: the polynomial atan2, Taylor
// sin/cos of the small hue shift, Horner/Clenshaw curve fits, the PQ and
// sRGB fits on power-warped domains; no atan2f, sinf or powf.

// Built with -fmad=false (kernels.py): no multiply-add contraction, so
// each operation rounds as in the plain PyTorch version, in the same
// order.

#include <cuda_runtime.h>
#include <stdio.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int NP_MAX = 52;
constexpr int NC_MAX = 64;  // 2 rows x 32
constexpr int NCONST = 86;
constexpr float MAXVAL = 65535.0f;

// the curve forms the planner fits (curve1d.py): (rows, coefficients a
// row), the even/odd split (2, deg_half + 1) or Chebyshev (1, deg + 1)
#define FORMS(X) X(2, 11) X(2, 13) X(2, 15) X(2, 17) X(1, 16) X(1, 24) X(1, 32)

struct Consts {
  float c[NCONST];
};

// the params (NP_MAX), then the coefficients, row r at NP_MAX + r * K
__constant__ float c_pc[NP_MAX + NC_MAX];

// layout of the host-built constants (tonecurve_neutral.py::_consts_np)
constexpr int C_PF = 0, C_QF = 12, C_PI = 24, C_QI = 34, C_INV_YMAX = 44;
constexpr int C_T0 = 45, C_1MT0 = 46, C_POL = 47, C_TH = 56, C_S = 59;
constexpr int C_S2Q = 62, C_SSQ = 65, C_D50_65 = 68, C_D65_50 = 77;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// P(t^2) + t*Q(t^2)
template <int NP, int NQ>
__device__ __forceinline__ float horner_sq(float t, const float* p,
                                           const float* q) {
  const float s = t * t;
  float accp = p[0];
#pragma unroll
  for (int i = 1; i < NP; ++i) accp = accp * s + p[i];
  float accq = q[0];
#pragma unroll
  for (int i = 1; i < NQ; ++i) accq = accq * s + q[i];
  return accp + t * accq;
}

__device__ __forceinline__ float pq_fwd(float x, const float* C) {
  float t = clampf(x * 0.25f, 0.0f, 1.0f);
#pragma unroll
  for (int i = 0; i < 5; ++i) t = sqrtf(t);
  return horner_sq<12, 12>(2.0f * t - 1.0f, C + C_PF, C + C_QF);
}

__device__ __forceinline__ float pq_inv(float y, const float* C) {
  float v = clampf(y * C[C_INV_YMAX], 0.0f, 1.0f);
  v = sqrtf(sqrtf(sqrtf(v)));
  return fmaxf(horner_sq<10, 10>(2.0f * v - 1.0f, C + C_PI, C + C_QI), 0.0f);
}

__device__ __forceinline__ void jz_fwd(float r, float g, float b,
                                       const float* P, const float* C,
                                       float& jz, float& az, float& bz) {
  float x = P[0] * r + P[1] * g + P[2] * b;
  float y = P[3] * r + P[4] * g + P[5] * b;
  float z = P[6] * r + P[7] * g + P[8] * b;
  const float* m = C + C_D50_65;
  const float x2 = m[0] * x + m[1] * y + m[2] * z;
  const float y2 = m[3] * x + m[4] * y + m[5] * z;
  const float z2 = m[6] * x + m[7] * y + m[8] * z;
  const float lp = pq_fwd(0.674207838f * x2 + 0.382799340f * y2 -
                          0.047570458f * z2, C);
  const float mp = pq_fwd(0.149284160f * x2 + 0.739628340f * y2 +
                          0.083327300f * z2, C);
  const float sp = pq_fwd(0.070941080f * x2 + 0.174768000f * y2 +
                          0.670970020f * z2, C);
  const float iz = 0.5f * (lp + mp);
  az = 3.524000f * lp - 4.066708f * mp + 0.542708f * sp;
  bz = 0.199076f * lp + 1.096799f * mp - 1.295875f * sp;
  jz = (0.44f * iz) / (1.0f - 0.56f * iz) - 1.6295499532821566e-11f;
}

__device__ __forceinline__ void jz_inv(float jz, float az, float bz,
                                       const float* P, const float* C,
                                       float& r, float& g, float& b) {
  jz = jz + 1.6295499532821566e-11f;
  const float iz = jz / (0.44f + 0.56f * jz);
  const float l = pq_inv(
      iz + 1.386050432715393e-1f * az + 5.804731615611869e-2f * bz, C);
  const float m = pq_inv(
      iz - 1.386050432715393e-1f * az - 5.804731615611891e-2f * bz, C);
  const float s = pq_inv(
      iz - 9.601924202631895e-2f * az - 8.118918960560390e-1f * bz, C);
  const float x = 1.661373055774069e+00f * l - 9.145230923250668e-01f * m +
                  2.313620767186147e-01f * s;
  const float y = -3.250758740427037e-01f * l + 1.571847038366936e+00f * m -
                  2.182538318672940e-01f * s;
  const float z = -9.098281098284756e-02f * l - 3.127282905230740e-01f * m +
                  1.522766561305260e+00f * s;
  const float* mm = C + C_D65_50;
  const float x2 = mm[0] * x + mm[1] * y + mm[2] * z;
  const float y2 = mm[3] * x + mm[4] * y + mm[5] * z;
  const float z2 = mm[6] * x + mm[7] * y + mm[8] * z;
  r = P[9] * x2 + P[10] * y2 + P[11] * z2;
  g = P[12] * x2 + P[13] * y2 + P[14] * z2;
  b = P[15] * x2 + P[16] * y2 + P[17] * z2;
}

__device__ __forceinline__ float atan_poly(float t) {
  const float s = t * t;
  float acc = -0.0040540580f;
  acc = acc * s + 0.0218612288f;
  acc = acc * s + -0.0559098861f;
  acc = acc * s + 0.0964200441f;
  acc = acc * s + -0.1390853351f;
  acc = acc * s + 0.1994653599f;
  acc = acc * s + -0.3332985605f;
  acc = acc * s + 0.9999993329f;
  return t * acc;
}

__device__ __forceinline__ float atan2_poly(float a, float b) {
  const float aa = fabsf(a), ab = fabsf(b);
  const float hi = fmaxf(aa, ab), lo = fminf(aa, ab);
  float r = atan_poly(lo / fmaxf(hi, 1e-30f));
  if (aa > ab) r = (float)(3.141592653589793 / 2) - r;
  if (b < 0.0f) r = (float)3.141592653589793 - r;
  return a < 0.0f ? -r : r;
}

__device__ __forceinline__ float gauss(float x, float b, float c) {
  const float d = x - b;
  return expf(-(d * d) / (2.0f * c * c));
}

template <int ROWS, int K>
__device__ __forceinline__ float curve(float x, const float* cf) {
  const float t = 2.0f * sqrtf(clampf(x, 0.0f, 1.0f)) - 1.0f;
  if (ROWS == 2) {  // even/odd Horner split in u = 2t^2 - 1
    const float u = 2.0f * t * t - 1.0f;
    float accp = cf[0];
#pragma unroll
    for (int i = 1; i < K; ++i) accp = accp * u + cf[i];
    float accq = cf[K];
#pragma unroll
    for (int i = 1; i < K; ++i) accq = accq * u + cf[K + i];
    return accp + t * accq;
  }
  const float t2 = 2.0f * t;  // Chebyshev, Clenshaw
  float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
  for (int i = K - 1; i > 0; --i) {
    const float nb = cf[i] + t2 * b1 - b2;
    b2 = b1;
    b1 = nb;
  }
  return cf[0] + t * b1 - b2;
}

__device__ __forceinline__ float srgb_encode(float x, const float* C) {
  x = clampf(x, 0.0f, 1.0f);
  const float t = sqrtf(sqrtf(sqrtf(x)));
  const float u = 2.0f * (t - C[C_T0]) / C[C_1MT0] - 1.0f;
  float acc = C[C_POL];
#pragma unroll
  for (int i = 1; i < 9; ++i) acc = acc * u + C[C_POL + i];
  return x <= 0.0031308f ? x * 12.92f : 1.055f * acc - 0.055f;
}

// one pixel, in place: (r, g, b) in 0..65535 -> the Neutral curve's
// output (EPI 0), or the output encoded (1: sRGB, 2: linear)
template <int ROWS, int K, int EPI>
__device__ __forceinline__ void neutral_px(float& r_io, float& g_io,
                                           float& b_io, const float* C) {
  const float* P = c_pc;
  const float* CF = c_pc + NP_MAX;
  const float rhue = P[36], bhue = P[37], yhue = P[38];
  const float rrange = P[39], brange = P[40], yrange = P[41];
  const float whitept = P[42];
  const float lmax = whitept * MAXVAL;

  float r = fmaxf(r_io * (float)(1.0 / 65535.0), 0.0f);
  float g = fmaxf(g_io * (float)(1.0 / 65535.0), 0.0f);
  float b = fmaxf(b_io * (float)(1.0 / 65535.0), 0.0f);
  float ilum, az1, bz1;
  jz_fwd(r, g, b, P, C, ilum, az1, bz1);
  const float cz1 = sqrtf(az1 * az1 + bz1 * bz1);
  const float hue0 = atan2_poly(az1, bz1);
  const float iy = (r + g + b) * (float)(1.0 / 3.0);

  // gamut compression in output space
  float o[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    o[c] = P[18 + 3 * c] * r + P[19 + 3 * c] * g + P[20 + 3 * c] * b;
  const float ac = fmaxf(fmaxf(o[0], o[1]), o[2]);
  const float aac = fabsf(ac);
  const float safe = aac > 0.0f ? aac : 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float d = ac != 0.0f ? (ac - o[c]) / safe : 0.0f;
    const float th = C[C_TH + c], s = C[C_S + c];
    const float compr =
        s * sqrtf(fmaxf(d - th, 0.0f) + C[C_S2Q + c]) - C[C_SSQ + c] + th;
    const float cd = d < th ? d : compr;
    o[c] = ac - cd * aac;
  }
  r = P[27] * o[0] + P[28] * o[1] + P[29] * o[2];
  g = P[30] * o[0] + P[31] * o[1] + P[32] * o[2];
  b = P[33] * o[0] + P[34] * o[1] + P[35] * o[2];

  // brightness-preserving normalisation + filmlike clip
  const float oy = (r + g + b) * (float)(1.0 / 3.0);
  const float f = oy > 0.0f ? iy / oy : 1.0f;
  r = r * f;
  g = g * f;
  b = b * f;
  {
    const float hi = fmaxf(fmaxf(r, g), b);
    const float lo = fminf(fminf(r, g), b);
    const float mid = r + g + b - hi - lo;
    const float hi_c = fminf(hi, whitept);
    const float lo_c = fminf(lo, whitept);
    const float denom = hi - lo;
    const float mid_c =
        denom > 0.0f ? lo_c + (hi_c - lo_c) * (mid - lo) / denom : hi_c;
    auto pick = [&](float ch) {
      return ch >= hi ? hi_c : (ch <= lo ? lo_c : mid_c);
    };
    r = pick(r);
    g = pick(g);
    b = pick(b);
  }

  r = curve<ROWS, K>(r, CF);
  g = curve<ROWS, K>(g, CF);
  b = curve<ROWS, K>(b, CF);

  float jz, az2, bz2;
  jz_fwd(r, g, b, P, C, jz, az2, bz2);
  const float cz = sqrtf(az2 * az2 + bz2 * bz2);

  // hue twists
  float hue_shift =
      (float)(15.0 * (3.141592653589793 / 180.0)) * gauss(hue0, rhue, rrange);
  hue_shift = hue_shift - (float)(5.0 * (3.141592653589793 / 180.0)) *
                              gauss(hue0, bhue, brange);
  hue_shift = hue_shift * clampf((r + g + b) / (3.0f * whitept), 0.0f, 1.0f);
  const float hue = hue0 + hue_shift;

  // saturation compensation
  float ccf = ilum > 1e-5f
                  ? 1.0f - clampf(jz / fmaxf(ilum, 1e-5f) - 1.0f, 0.0f, 1.0f) *
                               0.2f
                  : 1.0f;
  ccf = clampf(ccf + 0.5f * gauss(hue, yhue, yrange), 0.0f, 1.0f);

  const float d2 = hue_shift * hue_shift;
  const float sin_d =
      hue_shift * (1.0f - d2 * (float)(1.0 / 6.0) * (1.0f - d2 * 0.05f));
  const float cos_d = 1.0f - d2 * 0.5f * (1.0f - d2 * (float)(1.0 / 12.0));
  const float inv_c1 = cz1 > 1e-20f ? 1.0f / fmaxf(cz1, 1e-20f) : 0.0f;
  const float scale = cz * ccf * inv_c1;
  const float az = scale * (az1 * cos_d + bz1 * sin_d);
  const float bz = scale * (bz1 * cos_d - az1 * sin_d);

  jz_inv(jz, az, bz, P, C, r, g, b);
  r = clampf(r * MAXVAL, 0.0f, lmax);
  g = clampf(g * MAXVAL, 0.0f, lmax);
  b = clampf(b * MAXVAL, 0.0f, lmax);

  if (EPI) {  // work -> out, clip, TRC (1: sRGB, 2: linear)
    const float* W = P + 43;
    const float inv = (float)(1.0 / 65535.0);
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float x = (W[3 * c] * r + W[3 * c + 1] * g + W[3 * c + 2] * b) * inv;
      x = clampf(x, 0.0f, 1.0f);
      v[c] = EPI == 1 ? srgb_encode(x, C) : x;
    }
    r = v[0];
    g = v[1];
    b = v[2];
  }
  r_io = r;
  g_io = g;
  b_io = b;
}

// in/out: (3, npix) planes
template <int ROWS, int K, int EPI>
__global__ void __launch_bounds__(THREADS)
    neutral_kernel(const float* __restrict__ in, float* __restrict__ out,
                   int npix, const Consts consts) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= npix) return;
  const size_t n = npix;
  float r = in[i], g = in[n + i], b = in[2 * n + i];
  neutral_px<ROWS, K, EPI>(r, g, b, consts.c);
  out[i] = r;
  out[n + i] = g;
  out[2 * n + i] = b;
}

using KernelFn = void (*)(const float*, float*, int, const Consts);

// the instantiation for a form and an epilogue, or null
KernelFn pick(int rows, int k, int epi) {
  if (epi < 0 || epi > 2) return nullptr;
#define PICK(R, N)                                                \
  if (rows == R && k == N)                                        \
    return epi == 0 ? neutral_kernel<R, N, 0>                     \
                    : epi == 1 ? neutral_kernel<R, N, 1>          \
                               : neutral_kernel<R, N, 2>;
  FORMS(PICK)
#undef PICK
  return nullptr;
}

}  // namespace

// in/out: (3, npix) float32 planes; params (nparams = 43, or 52 with the
// epilogue's work2out matrix) and coeffs (crows, ccols; crows 2 = Horner
// split, 1 = Chebyshev; a form of FORMS) on the device; consts: NCONST
// host-fitted floats in host memory; epi: 0 none, 1 sRGB, 2 linear.
extern "C" int art_neutral_tone(const float* in, float* out,
                                const float* params, const float* coeffs,
                                const float* consts, int npix, int nparams,
                                int crows, int ccols, int epi,
                                void* stream) {
  const KernelFn fn = pick(crows, ccols, epi);
  if (fn == nullptr || npix < 1 || nparams != (epi ? 52 : 43))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyToSymbolAsync(
      c_pc, params, nparams * sizeof(float), 0, cudaMemcpyDeviceToDevice, st);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(c_pc, coeffs, crows * ccols * sizeof(float),
                                NP_MAX * sizeof(float),
                                cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  Consts c;
  memcpy(c.c, consts, sizeof(c.c));
  fn<<<(npix + THREADS - 1) / THREADS, THREADS, 0, st>>>(in, out, npix, c);
  return (int)cudaGetLastError();
}

// the kernel for a form and an epilogue as loaded: registers, shared and
// local memory, as one line of text into buf (cap bytes, NUL-terminated)
extern "C" int art_neutral_layout(char* buf, int cap, int crows, int ccols,
                                  int epi) {
  const KernelFn fn = pick(crows, ccols, epi);
  if (cap < 1 || fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return (int)e;
  snprintf(buf, cap,
           "neutral_kernel<%d, %d, %d>: %d registers, %zu B static shared "
           "memory, %zu B local (spills and stack), %zu B __constant__, %d "
           "threads\n",
           crows, ccols, epi, fa.numRegs, fa.sharedSizeBytes,
           fa.localSizeBytes, fa.constSizeBytes, THREADS);
  return 0;
}
