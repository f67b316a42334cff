// NLMeans on luma for Hopper (kernel B6).
//
// Replaces art_tpu/ops/nlmeans_pallas.py::_run / _kernel, the Pallas TPU
// kernel of the denoise's NLMeans pass: for each of 121 search offsets
// (radius 5), the 5x5 patch box of squared differences, the weight
// exp(-min(box * maskinv, 50)), and the weighted mean of the shifted
// luma, acc / (wsum + 1e-5).
//
// What bounds it here: operations. Each pixel does ~16 float operations
// for each of the 121 offsets (one of them an exp) against 12 bytes of
// memory traffic; the TPU kernel kept a 272 x 384 window in VMEM and
// looped over the offsets there. Here one block of 32 x 16 threads owns
// a 32 x 16 output tile and keeps its luma with a 7-pixel halo (the
// reach: search 5 + patch 2) in shared memory, read once from device
// memory with edge-clamped indices (the reference's edge pads). For each
// offset the block writes the squared differences over the tile plus a
// 2-pixel ring to shared memory, then their vertical 5-sums, then each
// thread sums 5 of those horizontally for its pixel: the plain version's
// separable order, so each pixel sees the same roundings.
//
// Built with -fmad=false (kernels.py): no multiply-add contraction, so
// each operation rounds as in the plain PyTorch version, in the same
// order; expf is the libdevice function that torch.exp calls, and the
// final division is IEEE.

#include <cuda_runtime.h>

namespace {

constexpr int SR = 5;            // search radius
constexpr int PR = 2;            // patch radius
constexpr int REACH = SR + PR;   // 7
constexpr int NOFF = (2 * SR + 1) * (2 * SR + 1);
constexpr int BX = 32, BY = 16;  // output tile, one thread per pixel
constexpr int TW = BX + 2 * REACH, TH = BY + 2 * REACH;  // luma tile
constexpr int DW = BX + 2 * PR, DH = BY + 2 * PR;        // d2 region

__global__ void __launch_bounds__(BX * BY)
    nlmeans_kernel(const float* __restrict__ y,
                   const float* __restrict__ maskinv,
                   float* __restrict__ out, int h, int w) {
  __shared__ float sy[TH][TW];
  __shared__ float sd[DH][DW];
  __shared__ float sv[BY][DW];
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  for (int i = tid; i < TH * TW; i += BX * BY) {
    const int r = i / TW, c = i % TW;
    const int gy = min(max(y0 + r - REACH, 0), h - 1);
    const int gx = min(max(x0 + c - REACH, 0), w - 1);
    sy[r][c] = y[(size_t)gy * w + gx];
  }
  const int r = threadIdx.y, c = threadIdx.x;
  const int oy = y0 + r, ox = x0 + c;
  const bool inside = oy < h && ox < w;
  const float mi = inside ? maskinv[(size_t)oy * w + ox] : 0.0f;
  float acc = 0.0f, wsum = 0.0f;
  __syncthreads();
  for (int idx = 0; idx < NOFF; ++idx) {
    const int ty = idx / (2 * SR + 1) - SR;
    const int tx = idx % (2 * SR + 1) - SR;
    // d2 at pixel (y0 + i - PR, x0 + j - PR), which is sy[i + SR][j + SR]
    for (int i = tid; i < DH * DW; i += BX * BY) {
      const int ri = i / DW, cj = i % DW;
      const float d = sy[ri + SR][cj + SR] - sy[ri + SR + ty][cj + SR + tx];
      sd[ri][cj] = d * d;
    }
    __syncthreads();
    // vertical 5-sums: centre, +1, -1, +2, -2
    for (int i = tid; i < BY * DW; i += BX * BY) {
      const int ri = i / DW, cj = i % DW;
      sv[ri][cj] = (((sd[ri + 2][cj] + sd[ri + 3][cj]) + sd[ri + 1][cj]) +
                    sd[ri + 4][cj]) +
                   sd[ri][cj];
    }
    __syncthreads();
    const float dist2 =
        (((sv[r][c + 2] + sv[r][c + 3]) + sv[r][c + 1]) + sv[r][c + 4]) +
        sv[r][c];
    const float wgt = expf(-fminf(dist2 * mi, 50.0f));
    const float sh = sy[r + REACH + ty][c + REACH + tx];
    acc = acc + wgt * sh;
    wsum = wsum + wgt;
    __syncthreads();  // sd and sv are rewritten by the next offset
  }
  if (inside) out[(size_t)oy * w + ox] = acc / (wsum + 1e-5f);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// y, maskinv (h, w) -> out (h, w)
extern "C" int art_nlmeans(const float* y, const float* maskinv, float* out,
                           int h, int w, void* stream) {
  if (h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  nlmeans_kernel<<<dim3(cdiv(w, BX), cdiv(h, BY)), dim3(BX, BY), 0,
                   static_cast<cudaStream_t>(stream)>>>(y, maskinv, out, h,
                                                        w);
  return (int)cudaGetLastError();
}
