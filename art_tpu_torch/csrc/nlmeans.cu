// NLMeans on luma for Hopper (kernel B6).
//
// Replaces art_tpu/ops/nlmeans_pallas.py::_run / _kernel, the Pallas TPU
// kernel of the denoise's NLMeans pass: for each of 121 search offsets t
// (radius 5, in the order ty = -5..5, tx = -5..5), the squared
// difference d2(q) = (y(q) - y(q + t))^2, its 5x5 patch box (vertical
// sums first, then horizontal, each ((((c + c[+1]) + c[-1]) + c[+2]) +
// c[-2])), the weight exp(-min(box * maskinv, 50)), acc += weight *
// y(p + t) and wsum += weight; the result is acc / (wsum + 1e-5), with
// edge-clamped neighbours over the whole plane.
//
// What bounds it here: issue. Per pixel and offset the work is ~16 float
// operations and one expf against 12 bytes a pixel of device memory
// traffic in all, so the question is how few instructions carry it.
// A first version kept one thread per pixel and, for every offset, wrote
// the squared differences and their vertical sums to shared memory
// between three barriers: ~17 shared accesses and 3 barriers per pixel
// and offset (363 barriers a block), about 200 GB through shared memory
// at 24 MP.
//
// Design: a register walk. A block of WX x WY warps loads its luma tile
// with the 7-pixel halo (the reach: search 5 + patch 2), edge-clamped,
// into shared memory once; that load is the only barrier. Each lane owns
// one column and walks down a strip of STRIP output rows. For each
// offset it reads y(q + t) once per row from shared memory (the same
// value gives the squared difference and, two rows later, the y(p + t)
// that acc takes), keeps the last five squared differences in registers
// and forms the vertical 5-sum in the plain order; the horizontal 5-sum
// takes the neighbouring columns' vertical sums by __shfl_*_sync. acc,
// wsum, maskinv and the strip's own luma stay in registers across all
// 121 offsets. The two lanes at each side of a warp only feed their
// neighbours' horizontal sums: 28 output columns a warp, 4/28 = 14%
// computed again. No barrier and no shared store happen per offset.
//
// The offset pairs t, -t have the same box (the box of -t at p is the
// box of t at p - t), and the plain version makes each pair's box once
// (this count is the bound, 0.537 ms at 24 MP on an H100). The kernel
// makes all 121: sharing them would hold each pixel's 60 partner weights
// until offsets 61..120, ~1 MB for a 64 x 64 tile, which fits neither
// shared memory nor registers.
//
// Bit-equality with the plain version: each output is computed by the
// same float32 operations in the same order; the lanes and the strip
// only share loads. Built with -fmad=false (kernels.py): no multiply-add
// contraction; expf is the libdevice function that torch.exp calls, and
// the final division is IEEE.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdio.h>

namespace {

constexpr int SR = 5;                      // search radius
constexpr int PR = 2;                      // patch radius
constexpr int REACH = SR + PR;             // 7
constexpr int LANES = 32;
constexpr int COLS = LANES - 2 * PR;       // output columns a warp: 28
constexpr int STRIP = 16;                  // output rows a lane walks
constexpr int WALK = STRIP + 2 * PR;       // squared-difference rows: 20
constexpr int WX = 4, WY = 2;              // warps across and down a block
constexpr int BW = WX * COLS, BH = WY * STRIP;           // 112 x 32 output
constexpr int TW = BW + 2 * REACH, TH = BH + 2 * REACH;  // 126 x 46 luma
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WX * WY * LANES)
    nlmeans_walk(const float* __restrict__ y,
                 const float* __restrict__ maskinv,
                 float* __restrict__ out, int h, int w) {
  __shared__ float sy[TH][TW];
  const int x0 = blockIdx.x * BW, y0 = blockIdx.y * BH;
  for (int i = threadIdx.x; i < TH * TW; i += WX * WY * LANES) {
    const int r = i / TW, c = i % TW;
    const int gy = min(max(y0 + r - REACH, 0), h - 1);
    const int gx = min(max(x0 + c - REACH, 0), w - 1);
    sy[r][c] = __ldg(y + static_cast<size_t>(gy) * w + gx);
  }
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  const int wx = warp % WX, wy = warp / WX;
  // this lane's column, and the first row of its strip, in global and in
  // tile coordinates (tile = global - (y0, x0) + REACH)
  const int ox = x0 + wx * COLS + lane - PR;
  const int oy = y0 + wy * STRIP;
  const int tc = ox - x0 + REACH;
  const int tr = oy - PR - y0 + REACH;  // the first squared-difference row
  const bool writes = lane >= PR && lane < LANES - PR && ox < w;
  float mi[STRIP], acc[STRIP], wsum[STRIP];
#pragma unroll
  for (int j = 0; j < STRIP; ++j) {
    mi[j] = writes && oy + j < h
                ? __ldg(maskinv + static_cast<size_t>(oy + j) * w + ox)
                : 0.0f;
    acc[j] = 0.0f;
    wsum[j] = 0.0f;
  }
  __syncthreads();
  float yc[WALK];  // y at the walk's rows, this column
#pragma unroll
  for (int j = 0; j < WALK; ++j) yc[j] = sy[tr + j][tc];

#pragma unroll 1
  for (int ty = -SR; ty <= SR; ++ty) {
#pragma unroll 1
    for (int tx = -SR; tx <= SR; ++tx) {
      const float* col = &sy[tr + ty][tc + tx];
      float d2[WALK], sh[WALK];
#pragma unroll
      for (int j = 0; j < WALK; ++j) {
        sh[j] = col[j * TW];  // y(q + t) at the walk's row j
        const float d = yc[j] - sh[j];
        d2[j] = d * d;
        if (j >= 2 * PR) {  // output row o, centred on row j - PR
          const int o = j - 2 * PR;
          const float vs =
              (((d2[j - 2] + d2[j - 1]) + d2[j - 3]) + d2[j]) + d2[j - 4];
          const float r1 = __shfl_down_sync(FULL, vs, 1);
          const float l1 = __shfl_up_sync(FULL, vs, 1);
          const float r2 = __shfl_down_sync(FULL, vs, 2);
          const float l2 = __shfl_up_sync(FULL, vs, 2);
          const float box = (((vs + r1) + l1) + r2) + l2;
          const float wgt = expf(-fminf(box * mi[o], 50.0f));
          acc[o] = acc[o] + wgt * sh[j - PR];
          wsum[o] = wsum[o] + wgt;
        }
      }
    }
  }
  if (!writes) return;
#pragma unroll
  for (int j = 0; j < STRIP; ++j)
    if (oy + j < h)
      out[static_cast<size_t>(oy + j) * w + ox] = acc[j] / (wsum[j] + 1e-5f);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// y, maskinv (h, w) -> out (h, w)
extern "C" int art_nlmeans(const float* y, const float* maskinv, float* out,
                           int h, int w, void* stream) {
  if (h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  nlmeans_walk<<<dim3(cdiv(w, BW), cdiv(h, BH)), WX * WY * LANES, 0,
                 static_cast<cudaStream_t>(stream)>>>(y, maskinv, out, h, w);
  return static_cast<int>(cudaGetLastError());
}

// B6's kernel as loaded: registers, shared and local memory, and its
// tile, as one line of text into buf (cap bytes, NUL-terminated)
extern "C" int art_nlmeans_layout(char* buf, int cap) {
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, nlmeans_walk);
  if (e != cudaSuccess) return static_cast<int>(e);
  snprintf(buf, cap,
           "nlmeans_walk: %d registers, %zu B static shared memory, %zu B "
           "local (spills and stack), tile %dx%d (warps %dx%d, strip %d "
           "rows, %d of 32 lanes write)\n",
           fa.numRegs, fa.sharedSizeBytes, fa.localSizeBytes, BH, BW, WY, WX,
           STRIP, COLS);
  return 0;
}
