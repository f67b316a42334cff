// AMaZE demosaic stage kernels B1-B3 for Hopper (sm_90a).
//
// Replaces the three Pallas stage kernels of art_tpu/demosaic/
// amaze_pallas.py (_stage_call, stages 1-3, which run amaze.py's
// _stages_1to4, _stages_5to6 and _stages_7to8 on 288x2304 VMEM windows).
// Each C entry point computes what its stage function computes on the
// whole reflect-padded plane, every neighbour read periodically inside
// the plane (torch.roll / jnp.roll), so it equals its plain PyTorch
// version (art_tpu_torch/demosaic/amaze.py) bit for bit: float32
// operations in the plain version's order, correctly rounded reciprocals
// (__frcp_rn, where the TPU kernel took an approximate one), built with
// -fmad=false so no multiply-add is contracted.
//
// Each stage is one kernel over output tiles, every intermediate in
// shared memory over the tile grown by its reach (what reads it, from
// how far); a tile reads x and the previous stage's planes once (the
// halos' re-reads mostly from L2) and writes its output, with no scratch
// plane in device memory:
//
//   B1  s1_tile   32x64 tiles of the padded plane   x by 9   (R1_X)
//   B2  s2_tile   32x64 tiles of the padded plane   x by 15  (R_X)
//   B3  s3_tile   32x64 tiles of the cropped output x by 10  (R3_X)
//
// B1 and B2 write every position of the padded plane (the next stage
// reads theirs periodically across the wrap), so their halo loads wrap
// on the global coordinate; B3's output is cropped by HALO = 24 > R3_X,
// so its tiles never cross the wrap.
//
// Bound on this card: the work is a few hundred float operations and
// 12-16 correctly rounded reciprocals per pixel, against one read of the
// mosaic and one write of the stage's planes. With the intermediates out
// of device memory, the kernels are bound inside the SM: by the float
// work, the shared-memory accesses and the phases between barriers.
//
// Each entry point launches on the given stream, allocates nothing (the
// wrapper passes the output planes) and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdio.h>

namespace {

// Constants as float(double): the rounding a Python float takes when
// it meets a float32 tensor.
constexpr float EPS = static_cast<float>(1e-5);
constexpr float EPSSQ = static_cast<float>(1e-10);
constexpr float ARTHRESH = 0.75f;
constexpr float GO0 = static_cast<float>(0.14659727707323927);
constexpr float GO1 = static_cast<float>(0.103592713382435);
constexpr float GO2 = static_cast<float>(0.0732036125103057);
constexpr float GO3 = static_cast<float>(0.0365543548389495);
constexpr float GG0 = static_cast<float>(0.5 * 0.07384411893421103);
constexpr float GG1 = static_cast<float>(0.5 * 0.06207511968171489);
constexpr float GG2 = static_cast<float>(0.5 * 0.0521818194747806);
constexpr float GG3 = static_cast<float>(0.5 * 0.03687419286733595);
constexpr float GG4 = static_cast<float>(0.5 * 0.03099732204057846);
constexpr float GG5 = static_cast<float>(0.5 * 0.018413194161458882);
constexpr float GE0 = static_cast<float>(0.13719494435797422);
constexpr float GE1 = static_cast<float>(0.05640252782101291);
constexpr float GQ0 = static_cast<float>(0.169917);
constexpr float GQ1 = static_cast<float>(0.108947);
constexpr float GQ2 = static_cast<float>(0.069855);
constexpr float GQ3 = static_cast<float>(0.0287182);
constexpr float C1325 = static_cast<float>(1.325);
constexpr float C0175 = static_cast<float>(0.175);
constexpr float C0075 = static_cast<float>(0.075);
constexpr float CM0075 = static_cast<float>(-0.075);

// i modulo n in [0, n), for any i
__device__ __forceinline__ int wrap_any(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

// CFA color (0=R 1=G 2=B) at an in-plane position: 2 bits per 2x2 site.
__device__ __forceinline__ int color(int pat, int y, int x) {
  return (pat >> (2 * (((y & 1) << 1) | (x & 1)))) & 3;
}

__device__ __forceinline__ float rcp(float d) { return __frcp_rn(d); }
__device__ __forceinline__ float sq(float a) { return a * a; }

__device__ __forceinline__ float med3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

// stage-1 gradient weights at (y, x), from the mosaic alone (X: a
// shared-memory tile)
template <class P>
__device__ __forceinline__ float dirwts0(const P& X, int y, int x) {
  float c = X(y, x);
  float delv = fabsf(X(y + 1, x) - X(y - 1, x));
  return EPS + fabsf(X(y + 2, x) - c) + fabsf(c - X(y - 2, x)) + delv;
}

template <class P>
__device__ __forceinline__ float dirwts1(const P& X, int y, int x) {
  float c = X(y, x);
  float delh = fabsf(X(y, x + 1) - X(y, x - 1));
  return EPS + fabsf(X(y, x + 2) - c) + fabsf(c - X(y, x - 2)) + delh;
}

// ------------------------------------------------------------- tiles
//
// A plane in shared memory over an output tile of TH x TW grown by HALO
// rows and HALO_X columns, indexed by tile-relative (y, x) with -HALO <=
// y < TH + HALO; a row holds PITCH values from column -LEFT (planes
// copied in 16-byte pieces start at a multiple of 4 columns).
template <typename T, int TH, int TW, int HALO, int LEFT, int PITCH,
          int HALO_X = HALO>
struct TileOf {
  static constexpr int R = HALO, RX = HALO_X, H = TH + 2 * HALO,
                       W = TW + 2 * HALO_X, N = H * W, L = LEFT, P = PITCH;
  static constexpr size_t BYTES = sizeof(T) * H * PITCH;
  static_assert(LEFT >= HALO_X && PITCH - LEFT >= TW + HALO_X, "a row fits");
  T* p;
  __device__ __forceinline__ T& operator()(int y, int x) const {
    return p[(y + HALO) * PITCH + x + LEFT];
  }
};

// f(y, x) at every position of tile T, the block's THREADS in turn
template <class T, int THREADS, class F>
__device__ __forceinline__ void each(F f) {
#pragma unroll 2
  for (int i = threadIdx.x; i < T::N; i += THREADS)
    f(i / T::W - T::R, i % T::W - T::RX);
}

// asynchronous copies of src (rows of w floats) into tile t's rows, by
// the block's THREADS (rows: the wrapped global rows from -ROW0; cols:
// the wrapped global columns from -COL0): 16 bytes at a time where the
// tile's columns lie inside the plane at 16-byte alignment (x0 the
// tile's first column), else 4 bytes at a time through the wrapped
// columns
template <int THREADS, int ROW0, int COL0, class T>
__device__ __forceinline__ void copy_in(const T& t, const float* src,
                                        const int* rows, const int* cols,
                                        int w, int x0, bool by16) {
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < T::H; r += THREADS / 32) {
    const float* srow = src + static_cast<size_t>(rows[r - T::R + ROW0]) * w;
    float* drow = t.p + r * T::P;
    if (by16) {
      for (int c = 4 * lane; c < T::P; c += 128)
        __pipeline_memcpy_async(drow + c, srow + x0 - T::L + c, 16);
    } else {
      for (int c = lane; c < T::P; c += 32)
        __pipeline_memcpy_async(drow + c, srow + cols[c - T::L + COL0], 4);
    }
  }
}

constexpr size_t al16(size_t b) { return (b + 15) / 16 * 16; }
constexpr size_t smax(size_t a, size_t b) { return a > b ? a : b; }

// ---------------------------------------------------------------- B1
//
// Stages 1-4 in one kernel, s1_tile: one block of S1_THREADS per output
// tile of S1_TH x S1_TW of the padded plane, every intermediate in
// shared memory over the tile grown by its reach (rows x columns,
// measured outward from the output tile; each plane is read along one
// axis only, so its reach across is what the other planes need):
//
//   hvwt (with vwt, hwt from dirwts by 1)       0 x 0   the output
//   select's vcd | hcd                          3 x 0 | 0 x 3   stage 4
//   dgintv | dginth                             2 x 0 | 0 x 2   stage 4
//   vcd, vcdalt | hcd, hcdalt                   5 x 0 | 0 x 5   stage 3
//   dirwts0 | dirwts1                           7 x 5 | 5 x 7   stage 2
//   x                                           9 x 9           dirwts
//
// (R1_* below; tests/test_torch_amaze_tiles.py checks the reach on the
// CPU). Stage 2 runs at the positions of the cross that the four cd
// planes cover, the tile grown by 5 rows within its columns and by 5
// columns within its rows. dirwts is computed once a position (the first
// design recomputed it 10 times a pixel, at the neighbours); reading it
// back gives the same float. Halo loads wrap on the global coordinate
// through tables of the tile's wrapped rows and columns, as in s2_tile,
// and each position's CFA colour is taken from its wrapped coordinate,
// so a tile at the seam (and a plane of odd size) reproduces the
// periodic values.
//
// The first design ran 3 passes over 8 scratch planes of the padded
// plane (0.8 GB at 24 MP, ~2.3 GB of traffic a call). This one keeps the
// planes in ~101 KB of shared memory, two blocks an SM: stage 3 holds
// its selected vcd and hcd in registers across a barrier and writes them
// over the cd planes it has read; vwt and hwt, read only at the output,
// are recomputed there from dirwts (the same operations on the same
// floats) rather than kept in planes of their own.
//
// What bounds it: ~15 correctly rounded reciprocals and a few hundred
// float operations per output pixel, stage 2 over 1.5 times the tile's
// positions, against 16 bytes of device memory: the SM's instruction
// issue. So each phase runs as column walks (Walks): a thread takes K
// rows of one column, keeps the column's values of the planes read
// along it in registers (Col), and reads only the other columns from
// shared memory, its index arithmetic done once a walk; on an H100 that
// ran faster than one thread a position. `python -m
// art_tpu_torch.demosaic.tune_stage1` times other walk lengths and
// thread counts, and the phases' cumulative cost, on the card; K1-K4 are
// the fastest of those it tries.

constexpr int S1_TH = 32, S1_TW = 64;  // output tile
constexpr int S1_THREADS = 512;
constexpr int R1_X = 9, R1_D = 7, R1_DX = 5, R1_CD = 5, R1_SEL = 3,
              R1_G = 2;

// B1's tiles: RY rows and RX columns of halo
template <typename T, int RY, int RX, int LEFT = RX,
          int PITCH = S1_TW + 2 * RX>
using Tile1 = TileOf<T, S1_TH, S1_TW, RY, LEFT, PITCH, RX>;
// x from column -12: the tile's first column is a multiple of S1_TW, so
// a row starts at a multiple of 4
using T1X = Tile1<float, R1_X, R1_X, 12, S1_TW + 24>;
using T1D0 = Tile1<float, R1_D, R1_DX>;
using T1D1 = Tile1<float, R1_DX, R1_D>;
using T1V = Tile1<float, R1_CD, 0>;
using T1H = Tile1<float, 0, R1_CD>;
using T1GV = Tile1<float, R1_G, 0>;
using T1GH = Tile1<float, 0, R1_G>;
using T1SV = Tile1<float, R1_SEL, 0>;
using T1SH = Tile1<float, 0, R1_SEL>;
static_assert(T1X::L % 4 == 0 && T1X::P % 4 == 0, "16-byte copies");

// a plane read at (dy, dx) from a position of a column walk: its own
// column from the registers w of the walk's window (w[o + dy], o the
// position's index in the window), the other columns from the tile t
template <int N, class T>
struct Col {
  const float (&w)[N];
  const T& t;
  int o, y, x;
  __device__ __forceinline__ float operator()(int dy, int dx) const {
    return dx == 0 ? w[o + dy] : t(y + dy, x + dx);
  }
};

// a tile read at (dy, dx) from a position (y, x)
template <class T>
struct Rel {
  const T& t;
  int y, x;
  __device__ __forceinline__ float operator()(int dy, int dx) const {
    return t(y + dy, x + dx);
  }
};

// the column walks of K rows over a region of C columns and R rows: walk
// i starts at (r0 + row, c0 + column); the last walk of a column ends on
// the region's last row, so it may repeat rows of the one before (and
// write the same values there)
struct At {
  int y, x;
};
template <int C, int R, int K>
struct Walks {
  static constexpr int N = C * ((R + K - 1) / K);
  static_assert(K <= R, "a walk fits its column");
  static __device__ __forceinline__ At at(int i, int r0, int c0) {
    return At{r0 + min(i / C * K, R - K), c0 + i % C};
  }
};

// each phase's walks, K1-K4 rows long: stage 1 down the columns of
// dirwts0's and dirwts1's union; stage 2 down those of the cd planes'
// cross, the tile's columns (W2V), then R1_CD columns left and right
// within its rows (W2H); stage 3 down the selected vcd's columns and the
// selected hcd's, a thread one walk of each; stage 4 down the tile's
constexpr int K1 = 8, K2 = 6, K3 = 5, K4 = 4;
using W1 = Walks<T1D1::W, T1D0::H, K1>;
using W2V = Walks<S1_TW, T1V::H, K2>;
using W2H = Walks<2 * R1_CD, S1_TH, K2>;
using W3V = Walks<S1_TW, T1SV::H, K3>;
using W3H = Walks<T1SH::W, S1_TH, K3>;
using W4 = Walks<S1_TW, S1_TH, K4>;
static_assert(W1::N <= S1_THREADS && W2V::N + W2H::N <= S1_THREADS &&
                  W3V::N <= S1_THREADS && W3H::N <= S1_THREADS &&
                  W4::N <= S1_THREADS,
              "a walk a thread");

// stage 2 at a position: cardinal G estimates and colour differences
struct Cd {
  float vcd, hcd, vcdalt, hcdalt, dgintv, dginth;
};

template <class PX, class PD0, class PD1>
__device__ __forceinline__ Cd cd_at(const PX& X, const PD0& D0,
                                    const PD1& D1, int y, int x, bool g,
                                    float clip8) {
  const float c = X(y, x);
  const float xu1 = X(y - 1, x), xd1 = X(y + 1, x);
  const float xl1 = X(y, x - 1), xr1 = X(y, x + 1);
  const float xu2 = X(y - 2, x), xd2 = X(y + 2, x);
  const float xl2 = X(y, x - 2), xr2 = X(y, x + 2);
  const float d0 = D0(y, x), d1 = D1(y, x);
  const float d0u2 = D0(y - 2, x), d0d2 = D0(y + 2, x);
  const float d0u1 = D0(y - 1, x), d0d1 = D0(y + 1, x);
  const float d1l2 = D1(y, x - 2), d1r2 = D1(y, x + 2);
  const float d1l1 = D1(y, x - 1), d1r1 = D1(y, x + 1);

  const float cru = xu1 * (d0u2 + d0) * rcp(d0u2 * (EPS + c) + d0 * (EPS + xu2));
  const float crd = xd1 * (d0d2 + d0) * rcp(d0d2 * (EPS + c) + d0 * (EPS + xd2));
  const float crl = xl1 * (d1l2 + d1) * rcp(d1l2 * (EPS + c) + d1 * (EPS + xl2));
  const float crr = xr1 * (d1r2 + d1) * rcp(d1r2 * (EPS + c) + d1 * (EPS + xr2));

  const float guha = xu1 + 0.5f * (c - xu2);
  const float gdha = xd1 + 0.5f * (c - xd2);
  const float glha = xl1 + 0.5f * (c - xl2);
  const float grha = xr1 + 0.5f * (c - xr2);

  float guar = fabsf(1.0f - cru) < ARTHRESH ? c * cru : guha;
  float gdar = fabsf(1.0f - crd) < ARTHRESH ? c * crd : gdha;
  float glar = fabsf(1.0f - crl) < ARTHRESH ? c * crl : glha;
  float grar = fabsf(1.0f - crr) < ARTHRESH ? c * crr : grha;

  const float hwt = d1l1 * rcp(d1l1 + d1r1);
  const float vwt = d0u1 * rcp(d0d1 + d0u1);

  const float gintvha = vwt * gdha + (1.0f - vwt) * guha;
  const float ginthha = hwt * grha + (1.0f - hwt) * glha;

  const float sgn = g ? -1.0f : 1.0f;
  Cd r;
  r.vcd = sgn * ((vwt * gdar + (1.0f - vwt) * guar) - c);
  r.hcd = sgn * ((hwt * grar + (1.0f - hwt) * glar) - c);
  r.vcdalt = sgn * (gintvha - c);
  r.hcdalt = sgn * (ginthha - c);

  if (c > clip8 || gintvha > clip8 || ginthha > clip8) {
    guar = guha;
    gdar = gdha;
    glar = glha;
    grar = grha;
    r.vcd = r.vcdalt;
    r.hcd = r.hcdalt;
  }
  r.dgintv = fminf(sq(guha - gdha), sq(guar - gdar));
  r.dginth = fminf(sq(glha - grha), sq(glar - grar));
  return r;
}

__device__ __forceinline__ float var3(float a, float b, float c) {
  return 3.0f * (a * a + b * b + c * c) - sq(a + b + c);
}

// the saturation bound of a colour difference cd at a position whose
// mosaic value is x (G site: cd is G minus the other channel; R/B site:
// the interpolated G minus x), against x's neighbours nm, np along the
// axis: bound_g_site and bound_rb_site of stage1_plain in one body, each
// site's operations on the same floats (x - cd is x + -cd; t < -u is
// -t > u; 1 - p is 1 + -p), so the block's warps do not split on the
// colour
__device__ __forceinline__ float bound_cd(float cd, float x, float nm,
                                          float np, bool g, float clip) {
  const float gint = g ? x - cd : cd + x;  // the interpolated other channel
  const float med = med3(gint, nm, np);
  const float dm = g ? x - med : med - x;
  const float t = 3.0f * cd;
  const bool strong = (g ? t : -t) > (gint + x);
  const float p = t * rcp(EPS + gint + x);
  const float wt = g ? 1.0f - p : 1.0f + p;
  const float blended = wt * cd + (1.0f - wt) * dm;
  const float out = (g ? cd : -cd) > 0.0f ? (strong ? dm : blended) : cd;
  return gint > clip ? dm : out;
}

// stage 3 along one axis at a position: the variance-based choice of cd
// or cdalt from their neighbours at -2 and +2 (cdm, cdp; altm, altp),
// then the saturation bound against x's neighbours at -1 and +1
__device__ __forceinline__ float select_at(float cd, float cdm, float cdp,
                                           float alt, float altm,
                                           float altp, float c, float nm,
                                           float np, bool g, float clip) {
  const float var = var3(cdm, cd, cdp);
  const float altvar = var3(altm, alt, altp);
  if (altvar < var) cd = alt;
  return bound_cd(cd, c, nm, np, g, clip);
}

// stage 4 at a position: directional discrimination from the selected
// vcd, hcd (V, H), dgintv, dginth (GV, GH) and the weights vwt, hwt
template <class PV, class PH, class PGV, class PGH>
__device__ __forceinline__ float hvwt_at(const PV& V, const PH& H,
                                         const PGV& GV, const PGH& GH,
                                         float vwt, float hwt, int y, int x) {
  const float vcd = V(y, x), hcd = H(y, x);
  const float vu1 = V(y - 1, x), vu2 = V(y - 2, x), vu3 = V(y - 3, x);
  const float vd1 = V(y + 1, x), vd2 = V(y + 2, x), vd3 = V(y + 3, x);
  const float hl1 = H(y, x - 1), hl2 = H(y, x - 2), hl3 = H(y, x - 3);
  const float hr1 = H(y, x + 1), hr2 = H(y, x + 2), hr3 = H(y, x + 3);
  const float uave = vcd + vu1 + vu2 + vu3;
  const float dave = vcd + vd1 + vd2 + vd3;
  const float lave = hcd + hl1 + hl2 + hl3;
  const float rave = hcd + hr1 + hr2 + hr3;
  const float dgrbvvaru =
      sq(vcd - uave) + sq(vu1 - uave) + sq(vu2 - uave) + sq(vu3 - uave);
  const float dgrbvvard =
      sq(vcd - dave) + sq(vd1 - dave) + sq(vd2 - dave) + sq(vd3 - dave);
  const float dgrbhvarl =
      sq(hcd - lave) + sq(hl1 - lave) + sq(hl2 - lave) + sq(hl3 - lave);
  const float dgrbhvarr =
      sq(hcd - rave) + sq(hr1 - rave) + sq(hr2 - rave) + sq(hr3 - rave);
  const float vcdvar_d = EPSSQ + vwt * dgrbvvard + (1.0f - vwt) * dgrbvvaru;
  const float hcdvar_d = EPSSQ + hwt * dgrbhvarr + (1.0f - hwt) * dgrbhvarl;

  const float gv = GV(y, x), gh = GH(y, x);
  const float fluctv_u = gv + GV(y - 1, x) + GV(y - 2, x);
  const float fluctv_d = gv + GV(y + 1, x) + GV(y + 2, x);
  const float flucth_l = gh + GH(y, x - 1) + GH(y, x - 2);
  const float flucth_r = gh + GH(y, x + 1) + GH(y, x + 2);
  const float vcdvar1 = EPSSQ + vwt * fluctv_d + (1.0f - vwt) * fluctv_u;
  const float hcdvar1 = EPSSQ + hwt * flucth_r + (1.0f - hwt) * flucth_l;

  const float varwt = hcdvar_d * rcp(vcdvar_d + hcdvar_d);
  const float diffwt = hcdvar1 * rcp(vcdvar1 + hcdvar1);
  const bool agree = ((0.5f - varwt) * (0.5f - diffwt) > 0.0f) &&
                     (fabsf(0.5f - diffwt) < fabsf(0.5f - varwt));
  return agree ? varwt : diffwt;
}

// shared memory of s1_tile, in bytes: the wrapped rows and columns, x,
// dirwts0 and dirwts1, the four cd planes (stage 3's selected vcd over
// vcd and vcdalt, its hcd over hcd and hcdalt), dgintv and dginth
constexpr size_t OFF1_ROWS = 0;
constexpr size_t OFF1_COLS = OFF1_ROWS + al16(T1X::H * sizeof(int));
constexpr size_t OFF1_X = OFF1_COLS + al16(T1X::P * sizeof(int));
constexpr size_t OFF1_D0 = OFF1_X + al16(T1X::BYTES);
constexpr size_t OFF1_D1 = OFF1_D0 + al16(T1D0::BYTES);
constexpr size_t OFF1_V = OFF1_D1 + al16(T1D1::BYTES);
constexpr size_t OFF1_VA = OFF1_V + al16(T1V::BYTES);
constexpr size_t OFF1_H = OFF1_VA + al16(T1V::BYTES);
constexpr size_t OFF1_HA = OFF1_H + al16(T1H::BYTES);
constexpr size_t OFF1_GV = OFF1_HA + al16(T1H::BYTES);
constexpr size_t OFF1_GH = OFF1_GV + al16(T1GV::BYTES);
constexpr size_t S1_SMEM = OFF1_GH + T1GH::BYTES;
constexpr size_t OFF1_SV = OFF1_V, OFF1_SH = OFF1_H;
static_assert(T1SV::BYTES <= OFF1_H - OFF1_V &&
                  T1SH::BYTES <= OFF1_GV - OFF1_H,
              "the selected planes fit over the cd planes");
static_assert(2 * (S1_SMEM + 1024) <= 233472, "two blocks an SM");

// x: the padded plane (h, w); clips: (clip_pt, clip_pt8); out: vcd,
// hcd, hvwt (3, h, w)
__global__ void __launch_bounds__(S1_THREADS, 2)
    s1_tile(const float* __restrict__ x, const float* __restrict__ clips,
            float* __restrict__ out, int h, int w, int pat, bool aligned) {
  extern __shared__ float4 s1_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(s1_smem);
  int* rows = reinterpret_cast<int*>(sm + OFF1_ROWS);
  int* cols = reinterpret_cast<int*>(sm + OFF1_COLS);
  auto fp = [&](size_t off) { return reinterpret_cast<float*>(sm + off); };
  const T1X X{fp(OFF1_X)};
  const T1D0 D0{fp(OFF1_D0)};
  const T1D1 D1{fp(OFF1_D1)};
  const T1V V{fp(OFF1_V)}, VA{fp(OFF1_VA)};
  const T1H H{fp(OFF1_H)}, HA{fp(OFF1_HA)};
  const T1GV GV{fp(OFF1_GV)};
  const T1GH GH{fp(OFF1_GH)};
  const T1SV SV{fp(OFF1_SV)};
  const T1SH SH{fp(OFF1_SH)};
  const size_t n = static_cast<size_t>(h) * w;
  const int y0 = blockIdx.y * S1_TH, x0 = blockIdx.x * S1_TW;
  const int tid = threadIdx.x;

  // the wrapped global rows of the tile grown by R1_X and its columns
  // from -T1X::L
  for (int i = tid; i < T1X::H + T1X::P; i += S1_THREADS) {
    if (i < T1X::H)
      rows[i] = wrap_any(y0 + i - R1_X, h);
    else
      cols[i - T1X::H] = wrap_any(x0 + i - T1X::H - T1X::L, w);
  }
  __syncthreads();
  auto green = [&](int y, int xx) {
    return color(pat, rows[y + R1_X], cols[xx + T1X::L]) == 1;
  };
  const bool by16 = aligned && x0 >= T1X::L && x0 - T1X::L + T1X::P <= w;
  copy_in<S1_THREADS, R1_X, T1X::L>(X, x, rows, cols, w, x0, by16);
  __pipeline_commit();
  const float clip = __ldg(clips), clip8 = __ldg(clips + 1);
  __pipeline_wait_prior(0);
  __syncthreads();
  // stage 1: the gradient weights, once a position
  if (tid < W1::N) {
    const At a = W1::at(tid, -R1_D, -R1_D);
    float wx[K1 + 4];
#pragma unroll
    for (int j = 0; j < K1 + 4; ++j) wx[j] = X(a.y - 2 + j, a.x);
    const bool d0 = a.x >= -R1_DX && a.x < S1_TW + R1_DX;
#pragma unroll
    for (int k = 0; k < K1; ++k) {
      const int y = a.y + k;
      const Col<K1 + 4, T1X> c{wx, X, k + 2, y, a.x};
      if (d0) D0(y, a.x) = dirwts0(c, 0, 0);
      if (y >= -R1_DX && y < S1_TH + R1_DX) D1(y, a.x) = dirwts1(c, 0, 0);
    }
  }
  __syncthreads();
  // stage 2 over the cross of the cd planes; dgintv, dginth by R1_G
  if (tid < W2V::N + W2H::N) {
    At a;
    if (tid < W2V::N) {
      a = W2V::at(tid, -R1_CD, 0);
    } else {
      a = W2H::at(tid - W2V::N, 0, 0);
      a.x += a.x < R1_CD ? -R1_CD : S1_TW - R1_CD;
    }
    float wx[K2 + 4], wd[K2 + 4];
#pragma unroll
    for (int j = 0; j < K2 + 4; ++j) {
      wx[j] = X(a.y - 2 + j, a.x);
      wd[j] = D0(a.y - 2 + j, a.x);
    }
    const bool in_cols = a.x >= 0 && a.x < S1_TW;
    const bool gh_cols = a.x >= -R1_G && a.x < S1_TW + R1_G;
#pragma unroll
    for (int k = 0; k < K2; ++k) {
      const int y = a.y + k;
      const Cd r = cd_at(Col<K2 + 4, T1X>{wx, X, k + 2, y, a.x},
                         Col<K2 + 4, T1D0>{wd, D0, k + 2, y, a.x},
                         Rel<T1D1>{D1, y, a.x}, 0, 0, green(y, a.x), clip8);
      if (in_cols) {
        V(y, a.x) = r.vcd;
        VA(y, a.x) = r.vcdalt;
        if (y >= -R1_G && y < S1_TH + R1_G) GV(y, a.x) = r.dgintv;
      }
      if (y >= 0 && y < S1_TH) {
        H(y, a.x) = r.hcd;
        HA(y, a.x) = r.hcdalt;
        if (gh_cols) GH(y, a.x) = r.dginth;
      }
    }
  }
  __syncthreads();
  // stage 3: the selected, bounded vcd (by R1_SEL rows) and hcd (by
  // R1_SEL columns), held until every thread has read the cd planes
  const At av = W3V::at(tid, -R1_SEL, 0), ah = W3H::at(tid, 0, -R1_SEL);
  float sv[K3], sh[K3];
  if (tid < W3V::N) {
    float wv[K3 + 4], wa[K3 + 4], wx[K3 + 2];
#pragma unroll
    for (int j = 0; j < K3 + 4; ++j) {
      wv[j] = V(av.y - 2 + j, av.x);
      wa[j] = VA(av.y - 2 + j, av.x);
      if (j < K3 + 2) wx[j] = X(av.y - 1 + j, av.x);
    }
#pragma unroll
    for (int k = 0; k < K3; ++k)
      sv[k] = select_at(wv[k + 2], wv[k], wv[k + 4], wa[k + 2], wa[k],
                        wa[k + 4], wx[k + 1], wx[k], wx[k + 2],
                        green(av.y + k, av.x), clip);
  }
  if (tid < W3H::N) {
#pragma unroll
    for (int k = 0; k < K3; ++k) {
      const int y = ah.y + k, xx = ah.x;
      sh[k] = select_at(H(y, xx), H(y, xx - 2), H(y, xx + 2), HA(y, xx),
                        HA(y, xx - 2), HA(y, xx + 2), X(y, xx), X(y, xx - 1),
                        X(y, xx + 1), green(y, xx), clip);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K3; ++k) {
    if (tid < W3V::N) SV(av.y + k, av.x) = sv[k];
    if (tid < W3H::N) SH(ah.y + k, ah.x) = sh[k];
  }
  __syncthreads();
  // stage 4 -> vcd, hcd, hvwt
  if (tid < W4::N) {
    const At a = W4::at(tid, 0, 0);
    float wv[K4 + 6], wg[K4 + 4], wd[K4 + 2];
#pragma unroll
    for (int j = 0; j < K4 + 6; ++j) {
      wv[j] = SV(a.y - 3 + j, a.x);
      if (j < K4 + 4) wg[j] = GV(a.y - 2 + j, a.x);
      if (j < K4 + 2) wd[j] = D0(a.y - 1 + j, a.x);
    }
#pragma unroll
    for (int k = 0; k < K4; ++k) {
      const int y = a.y + k;
      if (y0 + y >= h || x0 + a.x >= w) continue;
      const float d0u1 = wd[k], d0d1 = wd[k + 2];
      const float d1l1 = D1(y, a.x - 1), d1r1 = D1(y, a.x + 1);
      const float hwt = d1l1 * rcp(d1l1 + d1r1);
      const float vwt = d0u1 * rcp(d0d1 + d0u1);
      const size_t g = static_cast<size_t>(y0 + y) * w + x0 + a.x;
      out[g] = wv[k + 3];
      out[n + g] = SH(y, a.x);
      out[2 * n + g] = hvwt_at(Col<K4 + 6, T1SV>{wv, SV, k + 3, y, a.x},
                               Rel<T1SH>{SH, y, a.x},
                               Col<K4 + 4, T1GV>{wg, GV, k + 2, y, a.x},
                               Rel<T1GH>{GH, y, a.x}, vwt, hwt, 0, 0);
    }
  }
}

// ---------------------------------------------------------------- B2
//
// Stages 5-6 in one kernel, s2_tile: one block of S2_THREADS per output
// tile of S2_TH x S2_TW, every intermediate in shared memory over the
// tile grown by its reach (measured outward from the output tile):
//
//   curv_h, curv_v            2   gquinc (+-2) at the output
//   hvwt', green0, vcd, hcd   3   the curvature (+-1)
//   hvwt after the area       4   the diagonal smoothing (+-1)
//   ny2f                     10   the area sums (+-6) at +-4
//   nyqf                     12   the majority vote (+-2)
//   cddiffsq, delhvsq        14   the Nyquist test (+-2)
//   x                        15   delhvsq (+-1)
//
// (R_* below). In a regular Bayer plane the curvature reads green0 by 3
// only at G sites, where it is x, so the outputs need x by 14; where the
// seam of an odd-size plane puts two R/B sites side by side, green0 by 3
// is read at an R/B site, so the tile keeps the full 15.
//
// The first design ran 7 passes over 12 scratch planes of
// the padded plane (1.2 GB at 24 MP, ~4.3 GB of traffic a call); this
// one reads x and s1 (the halos' re-reads mostly from L2) and writes
// green and hvwt', with no scratch in device memory. Halo loads wrap on
// the global coordinate (tables of the tile's wrapped rows and columns),
// and the CFA colour of every position is taken from its wrapped global
// coordinate, so a tile at the plane's edge (and a plane of odd size)
// reproduces the periodic values.
//
// What bounds it: the work per output pixel is a few hundred float
// operations, most of them the Nyquist test over the tile grown by 12
// (2.4x the tile's pixels), against 24 bytes of device memory. So the
// kernel is made to issue little besides that arithmetic: all loads of a
// block are asynchronous copies (cp.async) in flight together; the
// Nyquist test walks down strips of NYQ_K rows with the 5x5 windows of
// cddiffsq and delhvsq in registers (10 shared loads a row instead of 38
// a pixel); the six area sums, read only where nyquist2, are computed
// only there: the positions are listed (one atomic a warp) and the
// block's threads share the list, each entry in _sum7's order (column
// sums over rows first, then over columns), so a tile without a Nyquist
// pixel skips them. The masks are bytes; the Nyquist planes and the
// later float planes share one region of shared memory in turn.
//
// Bit-equality: every value is computed by the same float32 operations
// in the same order as in stage2_plain; the per-pixel bodies below are
// templates on their accessor (a shared Tile or a register window),
// so the arithmetic is the same code whatever holds
// the plane.

constexpr int S2_TH = 32, S2_TW = 64;  // output tile
constexpr int S2_THREADS = 384, S2_WARPS = S2_THREADS / 32;
constexpr int NYQ_K = 14;  // rows a thread walks in the Nyquist test
constexpr int R_X = 15, R_CD = 14, R_NYQ = 12, R_NY2 = 10, R_HVA = 4,
              R_HV = 3, R_CURV = 2;

template <class P>
__device__ __forceinline__ float delhvsq(const P& X, int y, int x) {
  const float delh = fabsf(X(y, x + 1) - X(y, x - 1));
  const float delv = fabsf(X(y + 1, x) - X(y - 1, x));
  return delh * delh + delv * delv;
}

// stage 5: the Nyquist test from cddiffsq (CD) and delhvsqsum (DS)
template <class P>
__device__ __forceinline__ float nyqutest(const P& CD, const P& DS, int y,
                                          int x) {
  auto cd = [&](int dy, int dx) { return CD(y + dy, x + dx); };
  auto ds = [&](int dy, int dx) { return DS(y + dy, x + dx); };
  return (GO0 * cd(0, 0) +
          GO1 * (cd(-1, -1) + cd(-1, 1) + cd(1, -1) + cd(1, 1)) +
          GO2 * (cd(-2, 0) + cd(0, -2) + cd(0, 2) + cd(2, 0)) +
          GO3 * (cd(-2, -2) + cd(-2, 2) + cd(2, -2) + cd(2, 2))) -
         (GG0 * ds(0, 0) + GG1 * (ds(-1, 0) + ds(0, 1) + ds(0, -1) + ds(1, 0)) +
          GG2 * (ds(-1, -1) + ds(-1, 1) + ds(1, -1) + ds(1, 1)) +
          GG3 * (ds(-2, 0) + ds(0, -2) + ds(0, 2) + ds(2, 0)) +
          GG4 * (ds(-2, -1) + ds(-2, 1) + ds(-1, -2) + ds(-1, 2) + ds(1, -2) +
                 ds(1, 2) + ds(2, -1) + ds(2, 1)) +
          GG5 * (ds(-2, -2) + ds(-2, 2) + ds(2, -2) + ds(2, 2)));
}

// 7 step-2 taps a[0..6] in _sum7's log-tree order
__device__ __forceinline__ float sum7(const float* a) {
  return (((a[0] + a[1]) + (a[2] + a[3])) + (a[4] + a[5])) + a[6];
}

// hvwt from the six area sums (x*ny2f, cfah*ny2f, cfav*ny2f, sqh*ny2f,
// sqv*ny2f, ny2f), each over rows then columns (_area_sum), at a
// nyquist2 position
template <class PX, class PN>
__device__ float area_hvwt(const PX& X, const PN& NY, int y, int x) {
  float cs[6][7];
  float right[7];  // x at (q, xc + 1): the next column's left neighbour
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int xc = x - 6 + 2 * k;
    float a[6][7];
    float up = X(y - 7, xc);  // the first tap's upper neighbour
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const int q = y - 6 + 2 * j;
      const float ny = NY(q, xc) ? 1.0f : 0.0f;
      const float c = X(q, xc);
      const float l = k ? right[j] : X(q, xc - 1), r = X(q, xc + 1);
      const float u = up, d = X(q + 1, xc);
      right[j] = r;
      up = d;
      a[0][j] = c * ny;
      a[1][j] = (l + r) * ny;
      a[2][j] = (u + d) * ny;
      a[3][j] = (sq(c - l) + sq(c - r)) * ny;
      a[4][j] = (sq(c - u) + sq(c - d)) * ny;
      a[5][j] = ny;
    }
#pragma unroll
    for (int m = 0; m < 6; ++m) cs[m][k] = sum7(a[m]);
  }
  float s[6];
#pragma unroll
  for (int m = 0; m < 6; ++m) s[m] = sum7(cs[m]);
  const float sumcfa = s[0];
  const float sumh = sumcfa - 0.5f * s[1];
  const float sumv = sumcfa - 0.5f * s[2];
  const float areawt = 0.5f * s[5];
  const float hcdvar = EPSSQ + fabsf(areawt * s[3] - sumh * sumh);
  const float vcdvar = EPSSQ + fabsf(areawt * s[4] - sumv * sumv);
  return hcdvar * rcp(vcdvar + hcdvar);
}

template <class P>
__device__ __forceinline__ float gquinc(const P& Q, int y, int x) {
  return GQ0 * Q(y, x) +
         GQ1 * (Q(y - 1, x - 1) + Q(y - 1, x + 1) + Q(y + 1, x - 1) +
                Q(y + 1, x + 1)) +
         GQ2 * (Q(y - 2, x) + Q(y, x - 2) + Q(y, x + 2) + Q(y + 2, x)) +
         GQ3 * (Q(y - 2, x - 2) + Q(y - 2, x + 2) + Q(y + 2, x - 2) +
                Q(y + 2, x + 2));
}

// B2's tiles
template <typename T, int HALO, int LEFT = HALO,
          int PITCH = S2_TW + 2 * HALO>
using Tile = TileOf<T, S2_TH, S2_TW, HALO, LEFT, PITCH>;

// a 5x5 window of registers, w[q + dy][2 + dx] at (dy, dx) for the
// window centred on row q
template <int ROWS>
struct Window {
  const float (&w)[ROWS][5];
  int q;
  __device__ __forceinline__ float operator()(int dy, int dx) const {
    return w[q + dy][2 + dx];
  }
};

// the planes copied from device memory: x, vcd and hcd by 14, s1's hvwt
constexpr int LEFT16 = 16, PITCH16 = S2_TW + 32;
using TileX = Tile<float, R_X, LEFT16, PITCH16>;
using TileCD = Tile<float, R_CD, LEFT16, PITCH16>;
using TileNYQ = Tile<unsigned char, R_NYQ>;
using TileNY2 = Tile<unsigned char, R_NY2>;
using TileHVA = Tile<float, R_HVA, 4, S2_TW + 8>;
using TileHV = Tile<float, R_HV>;
using TileCurv = Tile<float, R_CURV>;
static_assert(TileNYQ::H % NYQ_K == 0, "whole strips");
// a warp's list segment: the most positions it visits in the vote
constexpr int SEGMENT = (TileNY2::N + S2_THREADS - 1) / S2_THREADS * 32;

// shared memory of s2_tile, in bytes: the wrapped rows and columns, x,
// the masks, vcd and hcd by 3, the area hvwt (s1's, then replaced where
// nyquist2), then one region that holds vcd and hcd by 14 until they
// become cddiffsq and delhvsq for the Nyquist test, then the list of
// nyquist2 positions (over hvwt', not yet written), then hvwt', green0
// and the curvatures
constexpr size_t OFF_ROWS = 0;
constexpr size_t OFF_COLS = OFF_ROWS + al16(TileX::H * sizeof(int));
constexpr size_t OFF_COUNT = OFF_COLS + al16(TileX::P * sizeof(int));
constexpr size_t OFF_X = OFF_COUNT + al16(S2_WARPS * sizeof(int));
constexpr size_t OFF_NYQ = OFF_X + al16(TileX::BYTES);
constexpr size_t OFF_NY2 = OFF_NYQ + al16(TileNYQ::BYTES);
constexpr size_t OFF_V3 = OFF_NY2 + al16(TileNY2::BYTES);
constexpr size_t OFF_H3 = OFF_V3 + al16(TileHV::BYTES);
constexpr size_t OFF_HVA = OFF_H3 + al16(TileHV::BYTES);
constexpr size_t OFF_U = OFF_HVA + al16(TileHVA::BYTES);
constexpr size_t OFF_CD = OFF_U;
constexpr size_t OFF_DS = OFF_CD + al16(TileCD::BYTES);
constexpr size_t OFF_HV = OFF_U;
constexpr size_t OFF_LIST = OFF_HV;
constexpr size_t OFF_G0 = OFF_HV + al16(TileHV::BYTES);
constexpr size_t OFF_CH = OFF_G0 + al16(TileHV::BYTES);
constexpr size_t OFF_CV = OFF_CH + al16(TileCurv::BYTES);
constexpr size_t S2_SMEM =
    smax(OFF_DS + TileCD::BYTES, OFF_CV + TileCurv::BYTES);
static_assert(S2_WARPS * SEGMENT * sizeof(short) <= TileHV::BYTES,
              "the list fits under hvwt'");
static_assert(TileHVA::N < 65536, "list entries are 16-bit");
static_assert(2 * (S2_SMEM + 1024) <= 233472, "two blocks an SM");

// x: the padded plane (h, w); s1: stage 1's vcd, hcd, hvwt; out: green,
// hvwt'
__global__ void __launch_bounds__(S2_THREADS, 2)
    s2_tile(const float* __restrict__ x, const float* __restrict__ s1,
            float* __restrict__ out, int h, int w, int pat, bool aligned) {
  extern __shared__ float4 s2_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(s2_smem);
  int* rows = reinterpret_cast<int*>(sm + OFF_ROWS);
  int* cols = reinterpret_cast<int*>(sm + OFF_COLS);
  int* counts = reinterpret_cast<int*>(sm + OFF_COUNT);
  unsigned short* list = reinterpret_cast<unsigned short*>(sm + OFF_LIST);
  auto fp = [&](size_t off) { return reinterpret_cast<float*>(sm + off); };
  const TileX X{fp(OFF_X)};
  const TileCD CD{fp(OFF_CD)}, DS{fp(OFF_DS)};
  const TileNYQ NYQ{sm + OFF_NYQ};
  const TileNY2 NY2{sm + OFF_NY2};
  const TileHVA HVA{fp(OFF_HVA)};
  const TileHV V3{fp(OFF_V3)}, H3{fp(OFF_H3)};
  const TileHV HV{fp(OFF_HV)}, G0{fp(OFF_G0)};
  const TileCurv CH{fp(OFF_CH)}, CV{fp(OFF_CV)};
  const size_t n = static_cast<size_t>(h) * w;
  const int y0 = blockIdx.y * S2_TH, x0 = blockIdx.x * S2_TW;
  const int tid = threadIdx.x, lane = tid % 32;

  // the wrapped global rows of the tile grown by R_X and its columns
  // from -LEFT16
  for (int i = tid; i < TileX::H + TileX::P; i += S2_THREADS) {
    if (i < TileX::H)
      rows[i] = wrap_any(y0 + i - R_X, h);
    else
      cols[i - TileX::H] = wrap_any(x0 + i - TileX::H - LEFT16, w);
  }
  __syncthreads();
  auto rb = [&](int y, int xx) {
    return color(pat, rows[y + R_X], cols[xx + LEFT16]) != 1;
  };
  // every load of the block at once; vcd and hcd land where cddiffsq
  // and delhvsq will be
  const bool by16 =
      aligned && x0 >= LEFT16 && x0 - LEFT16 + PITCH16 <= w;
  copy_in<S2_THREADS, R_X, LEFT16>(X, x, rows, cols, w, x0, by16);
  copy_in<S2_THREADS, R_X, LEFT16>(CD, s1, rows, cols, w, x0, by16);
  copy_in<S2_THREADS, R_X, LEFT16>(DS, s1 + n, rows, cols, w, x0, by16);
  copy_in<S2_THREADS, R_X, LEFT16>(HVA, s1 + 2 * n, rows, cols, w, x0,
                                   by16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  each<TileCD, S2_THREADS>([&](int y, int xx) {
    const float vc = CD(y, xx), hc = DS(y, xx);
    if (y >= -R_HV && y < S2_TH + R_HV && xx >= -R_HV && xx < S2_TW + R_HV) {
      V3(y, xx) = vc;
      H3(y, xx) = hc;
    }
    CD(y, xx) = sq(vc - hc);
    DS(y, xx) = delhvsq(X, y, xx);
  });
  __syncthreads();
  // stage 5: Nyquist test -> nyqf, down strips of NYQ_K rows
  for (int j = tid; j < TileNYQ::H / NYQ_K * TileNYQ::W; j += S2_THREADS) {
    const int xx = j % TileNYQ::W - R_NYQ;
    const int yt = j / TileNYQ::W * NYQ_K - R_NYQ;
    float cw[NYQ_K + 4][5], dw[NYQ_K + 4][5];
#pragma unroll
    for (int q = 0; q < NYQ_K + 4; ++q) {
#pragma unroll
      for (int u = 0; u < 5; ++u) {
        cw[q][u] = CD(yt - 2 + q, xx - 2 + u);
        dw[q][u] = DS(yt - 2 + q, xx - 2 + u);
      }
      if (q >= 4) {
        const int y = yt + q - 4;
        const Window<NYQ_K + 4> C{cw, q - 2}, D{dw, q - 2};
        NYQ(y, xx) = nyqutest(C, D, 0, 0) > 0.0f && rb(y, xx);
      }
    }
  }
  __syncthreads();
  // majority vote -> ny2f (nyqsum counts whole numbers: exact), and the
  // list of nyquist2 positions by R_HVA: each warp fills its own segment
  int listed = 0;
  unsigned short* seg = list + (tid / 32) * SEGMENT;
  for (int i0 = tid - lane; i0 < TileNY2::N; i0 += S2_THREADS) {
    const int i = i0 + lane;
    const int y = i / TileNY2::W - R_NY2, xx = i % TileNY2::W - R_NY2;
    bool need = false;
    if (i < TileNY2::N) {
      const int nyqsum = NYQ(y - 2, xx) + NYQ(y - 1, xx - 1) +
                         NYQ(y - 1, xx + 1) + NYQ(y, xx - 2) +
                         NYQ(y, xx + 2) + NYQ(y + 1, xx - 1) +
                         NYQ(y + 1, xx + 1) + NYQ(y + 2, xx);
      const bool ny2 =
          (nyqsum > 4 || (nyqsum == 4 && NYQ(y, xx))) && rb(y, xx);
      NY2(y, xx) = ny2;
      need = ny2 && y >= -R_HVA && y < S2_TH + R_HVA && xx >= -R_HVA &&
             xx < S2_TW + R_HVA;
    }
    const unsigned m = __ballot_sync(0xffffffffu, need);
    if (need)
      seg[listed + __popc(m & ((1u << lane) - 1u))] =
          static_cast<unsigned short>((y + R_HVA) * TileHVA::W + xx + R_HVA);
    listed += __popc(m);
  }
  if (lane == 0) counts[tid / 32] = listed;
  __syncthreads();
  // hvwt after the area test where nyquist2, the segments' entries shared
  // out in turn
  int total = 0;
  for (int wi = 0; wi < S2_WARPS; ++wi) total += counts[wi];
  for (int k = tid; k < total; k += S2_THREADS) {
    int wi = 0, at = k;
    while (at >= counts[wi]) at -= counts[wi++];
    const int i = list[wi * SEGMENT + at];
    const int y = i / TileHVA::W - R_HVA, xx = i % TileHVA::W - R_HVA;
    HVA(y, xx) = area_hvwt(X, NY2, y, xx);
  }
  __syncthreads();
  // stage 6: hvwt smoothing; the first G at R/B sites -> green0
  each<TileHV, S2_THREADS>([&](int y, int xx) {
    const float alt = 0.25f * (HVA(y - 1, xx - 1) + HVA(y - 1, xx + 1) +
                               HVA(y + 1, xx - 1) + HVA(y + 1, xx + 1));
    float hv = HVA(y, xx);
    if (fabsf(0.5f - hv) < fabsf(0.5f - alt)) hv = alt;
    HV(y, xx) = hv;
    const float dgrb0 = hv * V3(y, xx) + (1.0f - hv) * H3(y, xx);
    const float c = X(y, xx);
    G0(y, xx) = rb(y, xx) ? c + dgrb0 : c;
  });
  __syncthreads();
  // green curvature in Nyquist regions
  each<TileCurv, S2_THREADS>([&](int y, int xx) {
    float ch = 0.0f, cv = 0.0f;
    if (NY2(y, xx)) {
      const float g = G0(y, xx);
      ch = sq(g - 0.5f * (G0(y, xx - 1) + G0(y, xx + 1)));
      cv = sq(g - 0.5f * (G0(y - 1, xx) + G0(y + 1, xx)));
    }
    CH(y, xx) = ch;
    CV(y, xx) = cv;
  });
  __syncthreads();
  // Nyquist refinement of G at R/B sites -> green; hvwt'
#pragma unroll 2
  for (int i = tid; i < S2_TH * S2_TW; i += S2_THREADS) {
    const int y = i / S2_TW, xx = i % S2_TW;
    if (y0 + y >= h || x0 + xx >= w) continue;
    const float vc = V3(y, xx), hc = H3(y, xx), hv = HV(y, xx);
    float dgrb0 = hv * vc + (1.0f - hv) * hc;
    if (NY2(y, xx)) {
      const float gvarh = EPSSQ + gquinc(CH, y, xx);
      const float gvarv = EPSSQ + gquinc(CV, y, xx);
      dgrb0 = (hc * gvarv + vc * gvarh) * rcp(gvarv + gvarh);
    }
    const size_t g = static_cast<size_t>(y0 + y) * w + x0 + xx;
    out[g] = rb(y, xx) ? X(y, xx) + dgrb0 : G0(y, xx);
    out[n + g] = hv;
  }
}

// ---------------------------------------------------------------- B3
//
// Stages 7-8 in one kernel, s3_tile: one block of S3_THREADS per output
// tile of S3_TH x S3_TW, every intermediate in shared memory over the
// tile grown by its reach (measured outward from the output tile):
//
//   the propagated chroma            1   chroma at G sites (+-1)
//   green, hvwt, pmwt', dgrb0        4   the propagation (+-3)
//   rbint                            6   the G correction (+-2)
//   pmwt before its smoothing        7   the smoothing (+-1)
//   delm, delp                       8   the diagonal weights (+-2)
//   the diagonal squares sq1m, sq1p  9   rbvarm, rbvarp (+-2)
//   x                               10   the squares (+-1)
//
// (R3_* below; tests/test_torch_amaze_tiles.py checks the reach on the
// CPU). The output is the padded plane cropped by HALO = 24 > R3_X, so a
// tile never reads across the plane's wrap and every position has its
// regular Bayer colour: no tables of wrapped rows and columns. Rows and
// columns past the plane's far edge, read only by the positions of a
// ragged tile whose outputs are not written, are clamped to the edge.
//
// The first design ran 5 passes over 9 scratch planes of the padded
// plane (0.9 GB at 24 MP, ~2 GB of traffic a call) and recomputed the
// mosaic-only helpers (delm, delp, 24 diagonal squares) at every
// neighbour; this one reads x and stage 2's planes (the halos' re-reads
// mostly from L2), writes RGB, and computes each helper once a position.
//
// What bounds it: a few hundred float operations a pixel (12 correctly
// rounded reciprocals among them) against 24 bytes of device memory, so
// the kernel is made to issue little besides that arithmetic. The plain
// version computes every intermediate at every site, but its result
// reads pmwt, rbint, the G correction and the propagation only at R/B
// sites, delm/delp only at R/B sites and the squares only at G sites:
// the kernel computes each only there (a thread per R/B site, half the
// positions) and keeps a G-site and an R/B-site value in one plane (see
// the layout below). That leaves room to copy stage 2's planes in with
// x, all loads asynchronous (cp.async) and in flight together, 16 bytes
// at a time where the rows are aligned.
//
// Bit-equality: the per-pixel bodies take their planes through
// accessors (a shared Tile, the R/B coset view), with the float32
// operations of stage3_plain in its order.

constexpr int S3_TH = 32, S3_TW = 64;  // output tile
// on an H100 (700 W) 512 threads ran faster than 384 and 256 (a tuning
// build not kept): more warps hide the latency of the phases between
// barriers
constexpr int S3_THREADS = 512;
constexpr int R3_X = 10, R3_SQ = 9, R3_DEL = 8, R3_PMR = 7, R3_RI = 6,
              R3_G = 4, R3_PROP = 1;

template <typename T, int HALO, int LEFT = HALO,
          int PITCH = S3_TW + 2 * HALO>
using Tile3 = TileOf<T, S3_TH, S3_TW, HALO, LEFT, PITCH>;
// x from column -12 and stage 2's planes from -4: the tile's first
// column is HALO + a multiple of S3_TW, so both start at a multiple of 4
using T3X = Tile3<float, R3_X, 12, S3_TW + 24>;
using T3SD = Tile3<float, R3_SQ>;
using T3Q = Tile3<float, R3_PMR>;
using T3G = Tile3<float, R3_G, 4, S3_TW + 8>;
// the extents of the later phases (no storage of their own)
using T3RI = Tile3<float, R3_RI>;
using T3PROP = Tile3<float, R3_PROP>;
static_assert(T3X::L % 4 == 0 && T3X::P % 4 == 0 && T3G::L % 4 == 0 &&
                  T3G::P % 4 == 0 && T3X::P - T3X::L >= T3G::P - T3G::L,
              "16-byte copies");
static_assert(T3G::W % 2 == 0 && T3PROP::W % 2 == 0,
              "one R/B site in two columns");

template <int R>
__device__ __forceinline__ bool inside3(int y, int x) {
  return y >= -R && y < S3_TH + R && x >= -R && x < S3_TW + R;
}

// asynchronous copies of src (h, w) into tile t, whose position (0, 0)
// is the plane's (y0, x0): 16 bytes at a time when by16, else 4 bytes at
// a time; rows and columns past the far edges clamped to them
template <class T>
__device__ __forceinline__ void copy3(const T& t, const float* src, int h,
                                      int w, int y0, int x0, bool by16) {
  const int lane = threadIdx.x % 32;
  const int gx0 = x0 - T::L;
  for (int r = threadIdx.x / 32; r < T::H; r += S3_THREADS / 32) {
    const int gy = min(y0 - T::R + r, h - 1);
    const float* srow = src + static_cast<size_t>(gy) * w;
    float* drow = t.p + r * T::P;
    if (by16) {
      for (int c = 4 * lane; c < T::P; c += 128)
        __pipeline_memcpy_async(drow + c, srow + gx0 + c, 16);
    } else {
      for (int c = lane; c < T::P; c += 32)
        __pipeline_memcpy_async(drow + c, srow + min(gx0 + c, w - 1), 4);
    }
  }
}

// f(y, x) at every R/B site of tile T (a row of the tile's width holds
// T::W / 2 of them), the block's threads in turn; (y0, x0): the plane's
// position of the tile's (0, 0)
template <class T, class F>
__device__ __forceinline__ void each_rb(int pat, int y0, int x0, F f) {
  constexpr int PER_ROW = T::W / 2;
  for (int i = threadIdx.x; i < T::H * PER_ROW; i += S3_THREADS) {
    const int y = i / PER_ROW - T::R;
    const int first = color(pat, y0 + y, x0 - T::RX) == 1 ? 1 : 0;
    f(y, 2 * (i % PER_ROW) + first - T::RX);
  }
}

// the diagonal estimate in one direction pair
__device__ __forceinline__ float diag_rb(float c, float n1, float n2) {
  const float cr = 2.0f * n1 * rcp(EPS + c + n2);
  return fabsf(1.0f - cr) < ARTHRESH ? c * cr : n1 + 0.5f * (c - n2);
}

__device__ __forceinline__ float bound_rb(float rb, float x, float nm,
                                          float np, float clip) {
  const float med = med3(rb, nm, np);
  const bool strong = 2.0f * rb < x;
  const float wt = 2.0f * (x - rb) * rcp(EPS + rb + x);
  const float blended = wt * rb + (1.0f - wt) * med;
  const float out = rb < x ? (strong ? med : blended) : rb;
  return out > clip ? med3(out, nm, np) : out;
}

__device__ __forceinline__ float bound_g2(float g, float rbint, float nm,
                                          float np, float clip) {
  const float med = med3(g, nm, np);
  const bool strong = 2.0f * g < rbint;
  const float wt = 2.0f * (rbint - g) * rcp(EPS + g + rbint);
  const float blended = wt * g + (1.0f - wt) * med;
  const float out = g < rbint ? (strong ? med : blended) : g;
  return out > clip ? med3(out, nm, np) : out;
}

// the G estimate from a cardinal neighbour n1 and the same-coset rbint
__device__ __forceinline__ float card_g(float ri, float n1, float ri2) {
  const float cr = n1 * 2.0f * rcp(EPS + ri + ri2);
  return fabsf(1.0f - cr) < ARTHRESH ? ri * cr : n1 + 0.5f * (ri - ri2);
}

// Dgrb of one R/B coset (src) at a position, zero elsewhere
template <class P>
struct Coset {
  P D;
  int pat, y0, x0, src;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return color(pat, y0 + y, x0 + x) == src ? D(y, x) : 0.0f;
  }
};

template <class C>
__device__ float propagate(const C& dg, int y, int x) {
  const float nw = dg(y - 1, x - 1), ne = dg(y - 1, x + 1);
  const float sw = dg(y + 1, x - 1), se = dg(y + 1, x + 1);
  const float nw3 = dg(y - 3, x - 3), ne3 = dg(y - 3, x + 3);
  const float sw3 = dg(y + 3, x - 3), se3 = dg(y + 3, x + 3);
  const float wtnw = rcp(EPS + fabsf(nw - se) + fabsf(nw - nw3) + fabsf(se - nw3));
  const float wtne = rcp(EPS + fabsf(ne - sw) + fabsf(ne - ne3) + fabsf(sw - ne3));
  const float wtsw = rcp(EPS + fabsf(sw - ne) + fabsf(sw - se3) + fabsf(ne - sw3));
  const float wtse = rcp(EPS + fabsf(se - nw) + fabsf(se - sw3) + fabsf(nw - se3));
  return (wtnw * (C1325 * nw - C0175 * nw3 - C0075 * dg(y - 1, x - 3) -
                  C0075 * dg(y - 3, x - 1)) +
          wtne * (C1325 * ne - C0175 * ne3 + CM0075 * dg(y - 1, x + 3) -
                  C0075 * dg(y - 3, x + 1)) +
          wtsw * (C1325 * sw - C0175 * sw3 - C0075 * dg(y + 1, x - 3) -
                  C0075 * dg(y + 3, x - 1)) +
          wtse * (C1325 * se - C0175 * se3 - C0075 * dg(y + 1, x + 3) -
                  C0075 * dg(y + 3, x + 1))) *
         rcp(wtnw + wtne + wtsw + wtse);
}

// shared memory of s3_tile, in bytes: x, stage 2's green and hvwt, and
// three planes whose Bayer sites change roles between phases (a value
// of an R/B site q kept "right of q" lies at q + (0, 1), a G site):
//
//   SDM  G: sq1m, then pmwt' right of its site; R/B: delm
//   SDP  G: sq1p;                               R/B: delp, then dgrb0
//   Q    R/B: pmwt, then the propagated chroma; G: rbint right of its site
constexpr size_t OFF3_X = 0;
constexpr size_t OFF3_GS = OFF3_X + al16(T3X::BYTES);
constexpr size_t OFF3_HV = OFF3_GS + al16(T3G::BYTES);
constexpr size_t OFF3_SDM = OFF3_HV + al16(T3G::BYTES);
constexpr size_t OFF3_SDP = OFF3_SDM + al16(T3SD::BYTES);
constexpr size_t OFF3_Q = OFF3_SDP + al16(T3SD::BYTES);
constexpr size_t S3_SMEM = OFF3_Q + T3Q::BYTES;
static_assert(R3_G + 1 <= R3_SQ && R3_RI + 1 <= R3_PMR,
              "a value kept right of its site stays in its plane");
static_assert(2 * (S3_SMEM + 1024) <= 233472, "two blocks an SM");

// x: the padded plane (h, w); s2: stage 2's green, hvwt; out: RGB
// (3, h - 2*halo, w - 2*halo), halo >= R3_X
__global__ void __launch_bounds__(S3_THREADS, 2)
    s3_tile(const float* __restrict__ x, const float* __restrict__ s2,
            const float* __restrict__ clips, float* __restrict__ out, int h,
            int w, int halo, int pat, bool aligned) {
  extern __shared__ float4 s3_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(s3_smem);
  auto fp = [&](size_t off) { return reinterpret_cast<float*>(sm + off); };
  const T3X X{fp(OFF3_X)};
  const T3G GS{fp(OFF3_GS)}, HV{fp(OFF3_HV)};
  const T3SD SDM{fp(OFF3_SDM)}, SDP{fp(OFF3_SDP)};
  const T3Q Q{fp(OFF3_Q)};
  // rbint and pmwt' of the R/B site (y, xx), kept right of it
  auto RI = [&](int y, int xx) -> float& { return Q(y, xx + 1); };
  auto PM = [&](int y, int xx) -> float& { return SDM(y, xx + 1); };
  const int ho = h - 2 * halo, wo = w - 2 * halo;
  const int k0 = blockIdx.y * S3_TH, j0 = blockIdx.x * S3_TW;
  // the plane's position of the tile's (0, 0)
  const int y0 = halo + k0, x0 = halo + j0;
  const bool by16 = aligned && x0 - T3X::L + T3X::P <= w;
  const float clip = __ldg(clips);

  copy3(X, x, h, w, y0, x0, by16);
  copy3(GS, s2, h, w, y0, x0, by16);
  copy3(HV, s2 + static_cast<size_t>(h) * w, h, w, y0, x0, by16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // the mosaic's diagonal helpers, once a position: the squares at G
  // sites (rbvarm/rbvarp read them there), delm/delp at R/B sites
  each<T3SD, S3_THREADS>([&](int y, int xx) {
    const float c = X(y, xx);
    const float nw = X(y - 1, xx - 1), se = X(y + 1, xx + 1);
    const float ne = X(y - 1, xx + 1), sw = X(y + 1, xx - 1);
    if (color(pat, y0 + y, x0 + xx) == 1) {
      SDM(y, xx) = sq(c - nw) + sq(c - se);
      SDP(y, xx) = sq(c - sw) + sq(c - ne);
    } else if (inside3<R3_DEL>(y, xx)) {
      SDM(y, xx) = fabsf(se - nw);
      SDP(y, xx) = fabsf(ne - sw);
    }
  });
  __syncthreads();
  // stage 7: pmwt from the diagonal variances, at R/B sites (the only
  // ones whose rbint is read)
  each_rb<T3Q>(pat, y0, x0, [&](int y, int xx) {
    auto m = [&](int dy, int dx) { return SDM(y + dy, xx + dx); };
    auto p = [&](int dy, int dx) { return SDP(y + dy, xx + dx); };
    const float rbvarm =
        EPSSQ + (GE0 * (m(-1, 0) + m(0, -1) + m(0, 1) + m(1, 0)) +
                 GE1 * (m(-2, -1) + m(-2, 1) + m(-1, -2) + m(-1, 2) +
                        m(1, -2) + m(1, 2) + m(2, -1) + m(2, 1)));
    const float rbvarp =
        EPSSQ + (GE0 * (p(-1, 0) + p(0, -1) + p(0, 1) + p(1, 0)) +
                 GE1 * (p(-2, -1) + p(-2, 1) + p(-1, -2) + p(-1, 2) +
                        p(1, -2) + p(1, 2) + p(2, -1) + p(2, 1)));
    Q(y, xx) = rbvarm * rcp(rbvarp + rbvarm);
  });
  __syncthreads();
  // the diagonal R/B estimates, bounded; pmwt smoothed -> rbint, pmwt'
  each_rb<T3RI>(pat, y0, x0, [&](int y, int xx) {
    const float c = X(y, xx);
    const float nw = X(y - 1, xx - 1), se = X(y + 1, xx + 1);
    const float ne = X(y - 1, xx + 1), sw = X(y + 1, xx - 1);
    const float rbse = diag_rb(c, se, X(y + 2, xx + 2));
    const float rbnw = diag_rb(c, nw, X(y - 2, xx - 2));
    const float rbne = diag_rb(c, ne, X(y - 2, xx + 2));
    const float rbsw = diag_rb(c, sw, X(y + 2, xx - 2));
    const float dm = SDM(y, xx), dp = SDP(y, xx);
    const float wtse = EPS + dm + SDM(y + 1, xx + 1) + SDM(y + 2, xx + 2);
    const float wtnw = EPS + dm + SDM(y - 1, xx - 1) + SDM(y - 2, xx - 2);
    const float wtne = EPS + dp + SDP(y - 1, xx + 1) + SDP(y - 2, xx + 2);
    const float wtsw = EPS + dp + SDP(y + 1, xx - 1) + SDP(y + 2, xx - 2);
    float rbm = (wtse * rbnw + wtnw * rbse) * rcp(wtse + wtnw);
    float rbp = (wtne * rbsw + wtsw * rbne) * rcp(wtne + wtsw);
    rbp = bound_rb(rbp, c, sw, ne, clip);
    rbm = bound_rb(rbm, c, nw, se, clip);
    const float alt = 0.25f * (Q(y - 1, xx - 1) + Q(y - 1, xx + 1) +
                               Q(y + 1, xx - 1) + Q(y + 1, xx + 1));
    float pm = Q(y, xx);
    if (fabsf(0.5f - pm) < fabsf(0.5f - alt)) pm = alt;
    RI(y, xx) = 0.5f * (c + rbm * (1.0f - pm) + rbp * pm);
    if (inside3<R3_G>(y, xx)) PM(y, xx) = pm;
  });
  __syncthreads();
  // G correction where the diagonal discrimination is stronger, at R/B
  // sites -> green in place, dgrb0
  each_rb<T3G>(pat, y0, x0, [&](int y, int xx) {
    const float c = X(y, xx);
    const float ri = RI(y, xx);
    const float xu = X(y - 1, xx), xd = X(y + 1, xx);
    const float xl = X(y, xx - 1), xr = X(y, xx + 1);
    const float gu = card_g(ri, xu, RI(y - 2, xx));
    const float gd = card_g(ri, xd, RI(y + 2, xx));
    const float gl = card_g(ri, xl, RI(y, xx - 2));
    const float gr = card_g(ri, xr, RI(y, xx + 2));
    const float d0u = dirwts0(X, y - 1, xx), d0d = dirwts0(X, y + 1, xx);
    const float d1l = dirwts1(X, y, xx - 1), d1r = dirwts1(X, y, xx + 1);
    float gintv = (d0u * gd + d0d * gu) * rcp(d0d + d0u);
    float ginth = (d1l * gr + d1r * gl) * rcp(d1l + d1r);
    gintv = bound_g2(gintv, ri, xu, xd, clip);
    ginth = bound_g2(ginth, ri, xl, xr, clip);
    const float hv = HV(y, xx), pm = PM(y, xx);
    float green = GS(y, xx);
    if (fabsf(0.5f - pm) >= fabsf(0.5f - hv))
      green = ginth * (1.0f - hv) + gintv * hv;
    GS(y, xx) = green;
    SDP(y, xx) = green - c;
  });
  __syncthreads();
  // stage 8: chroma of the opposite R/B coset, at R/B sites
  each_rb<T3PROP>(pat, y0, x0, [&](int y, int xx) {
    const int src = 2 - color(pat, y0 + y, x0 + xx);
    Q(y, xx) = propagate(Coset<T3SD>{SDP, pat, y0, x0, src}, y, xx);
  });
  __syncthreads();
  // dgr (want 0) or dgb (want 2) at a position
  auto dg_of = [&](int y, int xx, int want) {
    const int c = color(pat, y0 + y, x0 + xx);
    return c == want ? SDP(y, xx) : (c == 1 ? 0.0f : Q(y, xx));
  };
  const size_t no = static_cast<size_t>(ho) * wo;
#pragma unroll 2
  for (int i = threadIdx.x; i < S3_TH * S3_TW; i += S3_THREADS) {
    const int y = i / S3_TW, xx = i % S3_TW;
    if (k0 + y >= ho || j0 + xx >= wo) continue;
    float dgr, dgb;
    if (color(pat, y0 + y, x0 + xx) == 1) {  // chroma at G sites
      const float hu = HV(y - 1, xx), hd = HV(y + 1, xx);
      const float hl = HV(y, xx - 1), hr = HV(y, xx + 1);
      const float iwsum = rcp(hu + hd + (1.0f - hl) + (1.0f - hr));
      dgr = (hu * dg_of(y - 1, xx, 0) + (1.0f - hr) * dg_of(y, xx + 1, 0) +
             (1.0f - hl) * dg_of(y, xx - 1, 0) + hd * dg_of(y + 1, xx, 0)) *
            iwsum;
      dgb = (hu * dg_of(y - 1, xx, 2) + (1.0f - hr) * dg_of(y, xx + 1, 2) +
             (1.0f - hl) * dg_of(y, xx - 1, 2) + hd * dg_of(y + 1, xx, 2)) *
            iwsum;
    } else {
      dgr = dg_of(y, xx, 0);
      dgb = dg_of(y, xx, 2);
    }
    const float g = GS(y, xx);
    const size_t o = static_cast<size_t>(k0 + y) * wo + j0 + xx;
    out[o] = fmaxf((g - dgr) * 65535.0f, 0.0f);
    out[no + o] = fmaxf(g * 65535.0f, 0.0f);
    out[2 * no + o] = fmaxf((g - dgb) * 65535.0f, 0.0f);
  }
}

dim3 grid_for(int h, int w, dim3 blk) {
  return dim3((w + blk.x - 1) / blk.x, (h + blk.y - 1) / blk.y);
}

}  // namespace

// x: (hp, wp) padded mosaic / 65535; clips: (clip_pt, clip_pt8);
// out: (3, hp, wp) vcd, hcd, hvwt; no scratch
extern "C" int art_amaze_stage1(const float* x, const float* clips,
                                float* out, int hp, int wp, int pat,
                                void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      s1_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S1_SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  // 16-byte copies need x's rows at 16-byte alignment
  const bool aligned = reinterpret_cast<size_t>(x) % 16 == 0 && wp % 4 == 0;
  s1_tile<<<grid_for(hp, wp, dim3(S1_TW, S1_TH)), S1_THREADS, S1_SMEM,
            static_cast<cudaStream_t>(stream)>>>(x, clips, out, hp, wp, pat,
                                                 aligned);
  return static_cast<int>(cudaGetLastError());
}

// s1: stage 1's (3, hp, wp); out: (2, hp, wp) green, hvwt; no scratch
extern "C" int art_amaze_stage2(const float* x, const float* s1, float* out,
                                int hp, int wp, int pat, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      s2_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S2_SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  // 16-byte copies need the planes' rows at 16-byte alignment
  const bool aligned =
      ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(s1)) % 16 ==
       0) &&
      wp % 4 == 0;
  s2_tile<<<grid_for(hp, wp, dim3(S2_TW, S2_TH)), S2_THREADS, S2_SMEM,
            static_cast<cudaStream_t>(stream)>>>(x, s1, out, hp, wp, pat,
                                                 aligned);
  return static_cast<int>(cudaGetLastError());
}

// B1's, B2's and B3's kernels as loaded: registers, shared memory
// (static and dynamic) and local memory, and their tiles, one line each
// of text into buf (cap bytes, NUL-terminated)
extern "C" int art_amaze_layout(char* buf, int cap) {
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes f1, f2, f3;
  cudaError_t e = cudaFuncGetAttributes(&f1, s1_tile);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&f2, s2_tile);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&f3, s3_tile);
  if (e != cudaSuccess) return static_cast<int>(e);
  const char* fmt =
      "%s: %d registers, %zu B static + %zu B dynamic shared memory, %zu B "
      "local (spills and stack), tile %dx%d, %d threads, halo %d\n";
  const struct {
    const char* name;
    const cudaFuncAttributes& f;
    size_t smem;
    int th, tw, threads, halo;
  } k[] = {{"s1_tile", f1, S1_SMEM, S1_TH, S1_TW, S1_THREADS, R1_X},
           {"s2_tile", f2, S2_SMEM, S2_TH, S2_TW, S2_THREADS, R_X},
           {"s3_tile", f3, S3_SMEM, S3_TH, S3_TW, S3_THREADS, R3_X}};
  int at = 0;
  for (const auto& q : k) {
    const int m = snprintf(buf + at, cap - at, fmt, q.name, q.f.numRegs,
                           q.f.sharedSizeBytes, q.smem, q.f.localSizeBytes,
                           q.th, q.tw, q.threads, q.halo);
    if (m < 0 || m >= cap - at) break;
    at += m;
  }
  return 0;
}

// s2: stage 2's (2, hp, wp); out: (3, hp - 2*halo, wp - 2*halo) RGB in
// 0..65535; no scratch
extern "C" int art_amaze_stage3(const float* x, const float* s2,
                                const float* clips, float* out, int hp,
                                int wp, int halo, int pat, void* stream) {
  if (halo < R3_X || hp <= 2 * halo || wp <= 2 * halo)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      s3_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S3_SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  // 16-byte copies need the planes' rows, and the tiles' first columns,
  // at 16-byte alignment
  const bool aligned =
      ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(s2)) % 16 ==
       0) &&
      wp % 4 == 0 && halo % 4 == 0;
  s3_tile<<<grid_for(hp - 2 * halo, wp - 2 * halo, dim3(S3_TW, S3_TH)),
            S3_THREADS, S3_SMEM, static_cast<cudaStream_t>(stream)>>>(
      x, s2, clips, out, hp, wp, halo, pat, aligned);
  return static_cast<int>(cudaGetLastError());
}
