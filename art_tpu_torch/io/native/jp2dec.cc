// jp2dec: the JPEG 2000 decode of OpenJPEG 2.5.4 as Pillow 12.1.0 drives
// it (Jpeg2KDecode.c): opj_read_header, then opj_read_tile_header and
// opj_decode_tile_data for each tile, then opj_end_decompress, over the
// whole file, with OpenJPEG's defaults (strict mode, reduce 0, all
// layers, one thread). Written from ITU-T T.800 and OpenJPEG's observable
// behaviour; the entry points at the end mirror those four calls.
//
// - The JP2 boxes as opj_jp2_read_header_procedure reads them: jP, ftyp,
//   jp2h (ihdr, colr, bpcc, pclr, cmap, cdef parsed for their errors; a
//   palette or channel definition is not applied, as it is not on the
//   tile-by-tile path), jp2c, and the boxes after the codestream that
//   opj_end_decompress reads.
// - The codestream: SOC, SIZ, COD/COC, QCD/QCC, RGN, POC, PPM/PPT,
//   TLM/PLM/PLT, CRG, COM, unknown markers skipped two bytes at a time,
//   SOT/SOD with tile-parts in any order, EOC; the marker states and the
//   checks that decide a damaged file's outcome (Psot past the end,
//   TPsot against TNsot, sizes).
// - Tier 2: the five progression orders and POC (opj_pi_next_*), the
//   precinct partition, the inclusion and zero bit-plane tag trees, the
//   pass counts, Lblock, segment lengths split by BYPASS and TERMALL, SOP
//   and EPH, the bit stuffing of packet headers.
// - Tier 1: the MQ decoder, the significance, refinement and cleanup
//   passes (raw in BYPASS), RESET, TERMALL, VSC, ERTERM and SEGSYM; the
//   coefficients carry one more bit (1.5 steps on significance, a half
//   step each refinement) and ROI maxshift. HTJ2K code-blocks (ITU-T
//   T.814, the code-block style's bit 0x40) through OpenJPEG's HT
//   decoder: the cleanup pass and one SigProp and MagRef pass.
// - Dequantisation (a reversible coefficient halved with C's division, an
//   irreversible one a float product with half the band's step), the
//   inverse 5/3 in integers and 9/7 in float32 (OpenJPEG's lifting
//   order, its historic 2/K of 1.625732422 and a unit band gain), RCT or
//   ICT, the DC level shift with lrintf's rounding and the clamp.
//
// Built with -ffp-contract=off so that no multiply-add fuses: OpenJPEG's
// x86-64 build rounds each product and each sum.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <vector>

namespace {

typedef uint8_t u8;
typedef uint32_t u32;
typedef int32_t i32;
typedef int64_t i64;
typedef uint64_t u64;

// -- the stream (opj_stream over the file, its length the file's) ----------

struct Stream {
  const u8* buf;
  size_t len, pos;
  // opj_stream_read_data: the bytes read, or SIZE_MAX where none are left
  size_t read(u8* dst, size_t n) {
    size_t k = len - pos < n ? len - pos : n;
    if (k == 0) return (size_t)-1;
    if (dst) memcpy(dst, buf + pos, k);
    pos += k;
    return k;
  }
  // opj_stream_skip: past the end it stops there and fails
  bool skip(u64 n) {
    if (n > len - pos) {
      pos = len;
      return false;
    }
    pos += (size_t)n;
    return true;
  }
  i64 left() const { return (i64)(len - pos); }
};

static inline u32 rd16(const u8* p) { return (u32)p[0] << 8 | p[1]; }
static inline u32 rd32(const u8* p) {
  return (u32)p[0] << 24 | (u32)p[1] << 16 | (u32)p[2] << 8 | p[3];
}
static inline u32 rdn(const u8* p, int n) {
  u32 v = 0;
  for (int i = 0; i < n; ++i) v = v << 8 | p[i];
  return v;
}

static inline i32 ceildiv(i32 a, i32 b) { return (i32)(((i64)a + b - 1) / b); }
static inline u32 uceildiv(u32 a, u32 b) { return (u32)(((u64)a + b - 1) / b); }
static inline i32 ceildivpow2(i32 a, int b) {
  return (i32)(((i64)a + ((i64)1 << b) - 1) >> b);
}
static inline i32 floordivpow2(i32 a, int b) { return a >> b; }
static inline u32 floorlog2(u32 a) {
  u32 l = 0;
  while (a > 1) {
    a >>= 1;
    ++l;
  }
  return l;
}

// -- markers, states -------------------------------------------------------

enum : u32 {
  M_SOC = 0xff4f, M_SOT = 0xff90, M_SOD = 0xff93, M_EOC = 0xffd9,
  M_CAP = 0xff50, M_SIZ = 0xff51, M_COD = 0xff52, M_COC = 0xff53,
  M_TLM = 0xff55, M_PLM = 0xff57, M_PLT = 0xff58, M_CPF = 0xff59,
  M_QCD = 0xff5c, M_QCC = 0xff5d, M_RGN = 0xff5e, M_POC = 0xff5f,
  M_PPM = 0xff60, M_PPT = 0xff61, M_CRG = 0xff63, M_COM = 0xff64,
  M_SOP = 0xff91, M_MCT = 0xff74, M_MCC = 0xff75,
  M_MCO = 0xff77, M_CBD = 0xff78, M_UNK = 0
};
enum : u32 {
  S_MHSOC = 0x1, S_MHSIZ = 0x2, S_MH = 0x4, S_TPHSOT = 0x8, S_TPH = 0x10,
  S_NEOC = 0x40, S_DATA = 0x80, S_EOC = 0x100, S_ERR = 0x8000
};

// the marker a code names (unknown ones, and SOD, EOC, EPH, as UNK) and
// the states it may appear in
static u32 marker_states(u32 m, u32* id) {
  switch (m) {
    case M_SOT: *id = m; return S_MH | S_TPHSOT;
    case M_COD: case M_COC: case M_RGN: case M_QCD: case M_QCC: case M_POC:
    case M_COM: case M_MCT: case M_MCC: case M_MCO:
      *id = m; return S_MH | S_TPH;
    case M_SIZ: *id = m; return S_MHSIZ;
    case M_TLM: case M_PLM: case M_PPM: case M_CRG: case M_CBD: case M_CAP:
    case M_CPF:
      *id = m; return S_MH;
    case M_PLT: case M_PPT: *id = m; return S_TPH;
    case M_SOP: *id = m; return 0;
    default: *id = M_UNK; return S_MH | S_TPH;
  }
}

// -- coding parameters -----------------------------------------------------

enum { MAXRLVLS = 33, MAXBANDS = 3 * MAXRLVLS - 2 };
enum { CSTY_PRT = 1, CSTY_SOP = 2, CSTY_EPH = 4 };
// code-block styles (ERTERM, 16, changes nothing in the decode)
enum { CB_LAZY = 1, CB_RESET = 2, CB_TERMALL = 4, CB_VSC = 8, CB_SEGSYM = 32,
       CB_HT = 64, CB_HTMIXED = 128 };
enum { LRCP = 0, RLCP, RPCL, PCRL, CPRL, PROG_UNKNOWN = -1 };

struct StepSize {
  i32 expn = 0, mant = 0;
};

struct Tccp {
  u32 csty = 0, numresolutions = 0, cblkw = 0, cblkh = 0, cblksty = 0;
  u32 qmfbid = 0, qntsty = 0, numgbits = 0;
  i32 roishift = 0;
  StepSize stepsizes[MAXBANDS];
  u32 prcw[MAXRLVLS] = {0}, prch[MAXRLVLS] = {0};
  i32 dc_level_shift = 0;
};

struct Poc {
  u32 resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0;
  int prg = 0;
};

struct Tcp {
  u32 csty = 0;
  int prg = 0;
  u32 numlayers = 0, mct = 0;
  bool cod = false;
  bool poc = false;
  u32 numpocs = 0;
  Poc pocs[32];
  std::vector<Tccp> tccps;
  i32 current_tile_part = -1;
  u32 nb_tile_parts = 0;
  bool has_data = false;
  std::vector<u8> data;  // the tile-parts' data joined
  bool ppt = false;
  std::map<u32, std::vector<u8>> ppt_markers;
  std::vector<u8> ppt_buf;
  size_t ppt_pos = 0, ppt_len = 0;
};

struct ImageComp {
  u32 dx = 0, dy = 0, w = 0, h = 0, x0 = 0, y0 = 0, prec = 0, sgnd = 0;
  u32 resno_decoded = 0;
};

struct Image {
  u32 x0 = 0, y0 = 0, x1 = 0, y1 = 0, numcomps = 0;
  int color_space = 0;
  std::vector<ImageComp> comps;
};

// -- tag trees (opj_tgt) ---------------------------------------------------

struct TagTree {
  struct Node {
    int parent;
    i32 value, low;
  };
  std::vector<Node> nodes;
  void build(u32 w, u32 h) {
    nodes.clear();
    if (w == 0 || h == 0) return;
    int nplh[32], nplv[32];
    nplh[0] = (int)w;
    nplv[0] = (int)h;
    int numlvls = 0;
    u32 n, total = 0;
    do {
      n = (u32)(nplh[numlvls] * nplv[numlvls]);
      nplh[numlvls + 1] = (nplh[numlvls] + 1) / 2;
      nplv[numlvls + 1] = (nplv[numlvls] + 1) / 2;
      total += n;
      ++numlvls;
    } while (n > 1);
    nodes.assign(total, Node{-1, 999, 0});
    int node = 0;
    int parent = (int)(w * h), parent0 = parent;
    for (int i = 0; i < numlvls - 1; ++i) {
      for (int j = 0; j < nplv[i]; ++j) {
        int k = nplh[i];
        while (--k >= 0) {
          nodes[node++].parent = parent;
          if (--k >= 0) nodes[node++].parent = parent;
          ++parent;
        }
        if ((j & 1) || j == nplv[i] - 1) {
          parent0 = parent;
        } else {
          parent = parent0;
          parent0 += nplh[i];
        }
      }
    }
    nodes[node].parent = -1;
  }
  void reset() {
    for (auto& nd : nodes) {
      nd.value = 999;
      nd.low = 0;
    }
  }
};

// -- packet header bits (opj_bio) -----------------------------------------

struct Bio {
  const u8 *start, *end, *bp;
  u32 buf = 0, ct = 0;
  Bio(const u8* p, size_t n) : start(p), end(p + n), bp(p) {}
  bool bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp >= end) return false;
    buf |= *bp++;
    return true;
  }
  u32 getbit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  u32 read(u32 n) {
    u32 v = 0;
    for (u32 i = n - 1; i < n; i--) v |= getbit() << i;
    return v;
  }
  bool inalign() {
    if ((buf & 0xff) == 0xff) {
      if (!bytein()) return false;
    }
    ct = 0;
    return true;
  }
  size_t numbytes() const { return (size_t)(bp - start); }
};

static u32 tgt_decode(Bio& bio, TagTree& tree, u32 leafno, i32 threshold) {
  int stk[32];
  int sp = 0;
  int node = (int)leafno;
  while (tree.nodes[node].parent >= 0) {
    stk[sp++] = node;
    node = tree.nodes[node].parent;
  }
  i32 low = 0;
  for (;;) {
    TagTree::Node& nd = tree.nodes[node];
    if (low > nd.low) {
      nd.low = low;
    } else {
      low = nd.low;
    }
    while (low < threshold && low < nd.value) {
      if (bio.read(1)) {
        nd.value = low;
      } else {
        ++low;
      }
    }
    nd.low = low;
    if (sp == 0) break;
    node = stk[--sp];
  }
  return tree.nodes[node].value < threshold ? 1 : 0;
}

// -- tile structures (opj_tcd) ---------------------------------------------

struct Seg {
  u32 len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0;
  u32 numnewpasses = 0, newlen = 0;
};

struct Chunk {
  const u8* data;
  u32 len;
};

struct Cblk {
  i32 x0, y0, x1, y1;
  u32 Mb = 0, numbps = 0, numlenbits = 0, numnewpasses = 0;
  u32 numsegs = 0, real_num_segs = 0;
  std::vector<Seg> segs;
  std::vector<Chunk> chunks;
};

struct Prec {
  i32 x0, y0, x1, y1;
  u32 cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  u32 bandno = 0;
  i32 x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  float stepsize = 0;
  i32 numbps = 0;
  std::vector<Prec> precs;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
  i32 x0, y0, x1, y1;
  u32 pw = 0, ph = 0, pdx = 0, pdy = 0, numbands = 0;
  Band bands[3];
};

struct TileComp {
  i32 x0, y0, x1, y1;
  u32 numresolutions = 0, minimum_num_resolutions = 0;
  std::vector<Res> res;
  std::vector<i32> data;  // ints, or float32 bit patterns on the 9/7 path
};

struct Tile {
  i32 x0, y0, x1, y1;
  std::vector<TileComp> comps;
};

// -- the MQ decoder (ISO 15444-1 C.3) ---------------------------------------

struct MqState {
  u32 qeval;
  u8 nmps, nlps, sw;
};
static const MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0ac1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1c01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1c01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0ac1, 31, 28, 0}, {0x09c1, 32, 29, 0}, {0x08a1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02a1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18,
       NUMCTXS = 19 };

struct Mq {
  const u8 *bp, *end;
  u32 a = 0, c = 0, ct = 0;
  u8 state[NUMCTXS], mps[NUMCTXS];
  void reset_states() {
    for (int i = 0; i < NUMCTXS; ++i) state[i] = 0, mps[i] = 0;
    state[CTX_UNI] = 46;
    state[CTX_AGG] = 3;
    state[CTX_ZC] = 4;
  }
  // the segment's bytes are followed by 0xFF 0xFF (the caller's buffer)
  void bytein() {
    if (*bp == 0xff) {
      if (bp[1] > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        bp++;
        c += (u32)*bp << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += (u32)*bp << 8;
      ct = 8;
    }
  }
  void init(const u8* p, u32 len) {
    bp = p;
    end = p + len;
    c = len == 0 ? 0xffu << 16 : (u32)*bp << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void raw_init(const u8* p, u32 len) {
    bp = p;
    end = p + len;
    c = 0;
    ct = 0;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }
  u32 decode(int cx) {
    const MqState& s = kMq[state[cx]];
    u32 d;
    a -= s.qeval;
    if ((c >> 16) < s.qeval) {
      if (a < s.qeval) {
        a = s.qeval;
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        a = s.qeval;
        d = !mps[cx];
        if (s.sw) mps[cx] = !mps[cx];
        state[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= s.qeval << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qeval) {
          d = !mps[cx];
          if (s.sw) mps[cx] = !mps[cx];
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  u32 raw_decode() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp;
          bp++;
          ct = 7;
        }
      } else {
        c = *bp;
        bp++;
        ct = 8;
      }
    }
    ct--;
    return (c >> ct) & 1;
  }
};

// -- tier 1 ----------------------------------------------------------------

// per-sample flags: the eight neighbours' significance, four neighbours'
// signs, the sample's own state
enum : uint16_t {
  F_N = 1, F_S = 2, F_W = 4, F_E = 8, F_NW = 16, F_NE = 32, F_SW = 64,
  F_SE = 128, G_N = 256, G_S = 512, G_W = 1024, G_E = 2048,
  F_SIG = 4096, F_VISIT = 8192, F_REF = 16384
};

struct Luts {
  u8 zc[4][256];
  u8 sc[256], spb[256];
  Luts() {
    for (int o = 0; o < 4; ++o) {
      for (int f = 0; f < 256; ++f) {
        int h = !!(f & F_W) + !!(f & F_E);
        int v = !!(f & F_N) + !!(f & F_S);
        int d = !!(f & F_NW) + !!(f & F_NE) + !!(f & F_SW) + !!(f & F_SE);
        int n = 0;
        if (o == 1) std::swap(h, v);
        if (o == 3) {
          int hv = h + v;
          if (d >= 3) n = 8;
          else if (d == 2) n = hv >= 1 ? 7 : 6;
          else if (d == 1) n = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
          else n = hv >= 2 ? 2 : hv == 1 ? 1 : 0;
        } else {
          if (h == 2) n = 8;
          else if (h == 1) n = v >= 1 ? 7 : d >= 1 ? 6 : 5;
          else if (v == 2) n = 4;
          else if (v == 1) n = 3;
          else n = d >= 2 ? 2 : d == 1 ? 1 : 0;
        }
        zc[o][f] = (u8)(CTX_ZC + n);
      }
    }
    // index: N S W E significance (bits 0-3), their signs (bits 4-7)
    for (int i = 0; i < 256; ++i) {
      auto contrib = [&](int sigbit, int sgnbit) {
        if (!(i & sigbit)) return 0;
        return (i & sgnbit) ? -1 : 1;
      };
      int hc = contrib(4, 64) + contrib(8, 128);
      int vc = contrib(1, 16) + contrib(2, 32);
      hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
      vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
      int cx, x;
      if (hc == 1) { x = 0; cx = vc == 1 ? 13 : vc == 0 ? 12 : 11; }
      else if (hc == 0) {
        if (vc == 1) { cx = 10; x = 0; }
        else if (vc == 0) { cx = 9; x = 0; }
        else { cx = 10; x = 1; }
      } else { x = 1; cx = vc == 1 ? 11 : vc == 0 ? 12 : 13; }
      sc[i] = (u8)cx;
      spb[i] = (u8)x;
    }
  }
};
static const Luts kLuts;

static inline u32 sc_index(uint16_t f) {
  return (f & 15) | (((f >> 8) & 15) << 4);
}

// the samples' flags column by column within each stripe of four rows:
// the word of (stripe s, column x, row r) at ((s + 1) * (w + 2) + x + 1) *
// 4 + r, a border of one stripe and one column around
struct T1 {
  u32 w = 0, h = 0, sstride = 0;
  std::vector<i32> data;  // row-major
  std::vector<uint16_t> flags;
  Mq mq;
  const u8* zc = nullptr;

  void alloc(u32 cw, u32 chh) {
    w = cw;
    h = chh;
    sstride = (w + 2) * 4;
    data.assign((size_t)w * h, 0);
    flags.assign((size_t)sstride * ((h + 3) / 4 + 2), 0);
  }
  uint16_t* col(u32 k, u32 x) {  // the column's four words, k = 4 s
    return &flags[(size_t)(k / 4 + 1) * sstride + (x + 1) * 4];
  }
  static uint64_t word4(const uint16_t* f) {
    uint64_t v;
    memcpy(&v, f, 8);
    return v;
  }

  // sample r of the column at f became significant with sign s
  void update(uint16_t* f, u32 r, u32 s, bool vsc) {
    uint16_t* c = f + r;
    c[-4] |= F_E | (s ? G_E : 0);
    c[4] |= F_W | (s ? G_W : 0);
    if (r > 0) {
      c[-1] |= F_S | (s ? G_S : 0);
      c[-5] |= F_SE;
      c[3] |= F_SW;
    } else if (!vsc) {
      uint16_t* n = c - sstride + 3;
      n[0] |= F_S | (s ? G_S : 0);
      n[-4] |= F_SE;
      n[4] |= F_SW;
    }
    if (r < 3) {
      c[1] |= F_N | (s ? G_N : 0);
      c[-3] |= F_NE;
      c[5] |= F_NW;
    } else {
      uint16_t* so = c + sstride - 3;
      so[0] |= F_N | (s ? G_N : 0);
      so[-4] |= F_NE;
      so[4] |= F_NW;
    }
    *c |= F_SIG;
  }

  void sign(uint16_t* f, u32 r, i32* d, i32 oneplushalf, bool vsc) {
    u32 lu = sc_index(f[r]);
    u32 v = mq.decode(kLuts.sc[lu]) ^ kLuts.spb[lu];
    *d = v ? -oneplushalf : oneplushalf;
    update(f, r, v, vsc);
  }

  void sigpass(i32 bpno, bool raw, bool vsc) {
    i32 one = 1 << bpno, half = one >> 1, oph = one | half;
    for (u32 k = 0; k < h; k += 4) {
      const u32 rows = h - k < 4 ? h - k : 4;
      for (u32 x = 0; x < w; ++x) {
        uint16_t* f = col(k, x);
        if (!word4(f)) continue;
        for (u32 r = 0; r < rows; ++r) {
          if ((f[r] & (F_SIG | F_VISIT)) || !(f[r] & 0xff)) continue;
          i32* d = &data[(size_t)(k + r) * w + x];
          if (raw) {
            if (mq.raw_decode()) {
              u32 v = mq.raw_decode();
              *d = v ? -oph : oph;
              update(f, r, v, vsc);
            }
          } else if (mq.decode(zc[f[r] & 0xff])) {
            sign(f, r, d, oph, vsc);
          }
          f[r] |= F_VISIT;
        }
      }
    }
  }

  void refpass(i32 bpno, bool raw) {
    i32 one = 1 << bpno, poshalf = one >> 1;
    const uint64_t sig4 = 0x0001000100010001ull * F_SIG;
    for (u32 k = 0; k < h; k += 4) {
      const u32 rows = h - k < 4 ? h - k : 4;
      for (u32 x = 0; x < w; ++x) {
        uint16_t* f = col(k, x);
        if (!(word4(f) & sig4)) continue;
        for (u32 r = 0; r < rows; ++r) {
          if ((f[r] & (F_SIG | F_VISIT)) != F_SIG) continue;
          u32 v;
          if (raw) {
            v = mq.raw_decode();
          } else {
            int cx = (f[r] & F_REF) ? CTX_MAG + 2
                     : (f[r] & 0xff) ? CTX_MAG + 1 : CTX_MAG;
            v = mq.decode(cx);
          }
          i32& d = data[(size_t)(k + r) * w + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          f[r] |= F_REF;
        }
      }
    }
  }

  void clnpass(i32 bpno, bool vsc, bool segsym) {
    i32 one = 1 << bpno, half = one >> 1, oph = one | half;
    const uint64_t busy4 = 0x0001000100010001ull * (0xff | F_SIG | F_VISIT);
    const uint16_t novisit = (uint16_t)~F_VISIT;
    for (u32 k = 0; k < h; k += 4) {
      const u32 rows = h - k < 4 ? h - k : 4;
      for (u32 x = 0; x < w; ++x) {
        uint16_t* f = col(k, x);
        i32* d = &data[(size_t)k * w + x];
        u32 r = 0;
        if (rows == 4 && !(word4(f) & busy4)) {
          if (!mq.decode(CTX_AGG)) continue;
          r = mq.decode(CTX_UNI);
          r = (r << 1) | mq.decode(CTX_UNI);
          sign(f, r, d + (size_t)r * w, oph, vsc);
          ++r;
        }
        for (; r < rows; ++r) {
          if (f[r] & (F_SIG | F_VISIT)) continue;
          if (mq.decode(zc[f[r] & 0xff])) sign(f, r, d + (size_t)r * w, oph, vsc);
        }
        f[0] &= novisit;
        f[1] &= novisit;
        f[2] &= novisit;
        f[3] &= novisit;
      }
    }
    if (segsym) {  // a bad symbol is only a warning
      for (int i = 0; i < 4; ++i) mq.decode(CTX_UNI);
    }
  }
};

// opj_t1_decode_cblk: false where OpenJPEG's fails
static bool decode_cblk(T1& t1, Cblk& cblk, u32 orient, i32 roishift,
                        u32 cblksty) {
  t1.zc = kLuts.zc[orient];
  t1.alloc((u32)(cblk.x1 - cblk.x0), (u32)(cblk.y1 - cblk.y0));
  i32 bpno_plus_one = (i32)((u32)roishift + cblk.numbps);
  if (bpno_plus_one >= 31) return false;
  u32 passtype = 2;
  t1.mq.reset_states();
  if (cblk.chunks.empty()) return true;
  std::vector<u8> buf;
  size_t total = 0;
  for (auto& ch : cblk.chunks) total += ch.len;
  buf.resize(total + 2);
  size_t o = 0;
  for (auto& ch : cblk.chunks) {
    memcpy(buf.data() + o, ch.data, ch.len);
    o += ch.len;
  }
  const bool vsc = cblksty & CB_VSC;
  u32 index = 0;
  std::vector<u8> seg;
  for (u32 segno = 0; segno < cblk.real_num_segs; ++segno) {
    Seg& s = cblk.segs[segno];
    bool raw = (bpno_plus_one <= (i32)cblk.numbps - 4) && passtype < 2 &&
               (cblksty & CB_LAZY);
    // the segment followed by an artificial 0xFF 0xFF
    seg.assign(buf.begin() + index, buf.begin() + index + s.len);
    seg.push_back(0xff);
    seg.push_back(0xff);
    if (raw) t1.mq.raw_init(seg.data(), s.len);
    else t1.mq.init(seg.data(), s.len);
    index += s.len;
    for (u32 passno = 0; passno < s.real_num_passes && bpno_plus_one >= 1;
         ++passno) {
      switch (passtype) {
        case 0: t1.sigpass(bpno_plus_one, raw, vsc); break;
        case 1: t1.refpass(bpno_plus_one, raw); break;
        case 2: t1.clnpass(bpno_plus_one, vsc, cblksty & CB_SEGSYM); break;
      }
      if ((cblksty & CB_RESET) && !raw) t1.mq.reset_states();
      if (++passtype == 3) {
        passtype = 0;
        bpno_plus_one--;
      }
    }
  }
  return true;
}

// -- HTJ2K code-blocks (OpenJPEG 2.5.4's ht_dec.c) --------------------------
//
// opj_t1_ht_decode_cblk as OpenJPEG 2.5.4 builds it (ITU-T T.814): the
// cleanup pass (the forward MagSgn stream, the MEL run decoder, the
// backward VLC stream with its U-VLC prefixes and suffixes) and the
// SigProp and MagRef passes of one HT set. A significant sample lands in
// OpenJPEG's word as (2 mu + 1) << (p - 1) with p the code-block's numbps
// (the bin centre below its last bit), the sign in bit 31 until the end,
// where each word becomes a two's complement integer. OpenJPEG's readers
// first take 1 to 4 bytes by the address of the data, then a word at a
// time; any grouping gives the same bits, so the readers here start with
// one byte. Only mel_init's first reads depend on the address (their
// count is 4 less the address modulo 4, and a byte above 0x8F after a
// 0xFF among them fails the block), so the decode takes the address
// modulo 4.
//
// The tables were read off Pillow 12.1.0's libopenjp2 2.5.4 (built -O0,
// so each static table sits in .rodata as the source has it):
// vlc_tbl0 at 0x77ae0 and vlc_tbl1 at 0x782e0 (1024 uint16 each, read
// by opj_t1_ht_decode_cblk at 0x191f2 as tbl[(c_q << 7) | (vlc & 0x7f)]),
// mel_exp at 0x791c0 (13 int32, read by mel_decode at 0x17997) and the
// U-VLC prefix table at 0x791a8 and 0x791f8 (8 bytes each, the same in
// decode_init_uvlc at 0x18654 and decode_noninit_uvlc at 0x18980). The
// tests hold them to a T.814 encoder of their own whose streams Pillow
// decodes to the encoder's input.

static const uint16_t kVlcTbl0[1024] = {
    0x0023, 0x00a5, 0x0043, 0x0066, 0x0083, 0xa8ee, 0x0014, 0xd8df,
    0x0023, 0x10be, 0x0043, 0xf5ff, 0x0083, 0x207e, 0x0055, 0x515f,
    0x0023, 0x0035, 0x0043, 0x444e, 0x0083, 0xc4ce, 0x0014, 0xcccf,
    0x0023, 0xe2fe, 0x0043, 0x99ff, 0x0083, 0x0096, 0x00c5, 0x313f,
    0x0023, 0x00a5, 0x0043, 0x445e, 0x0083, 0xc8ce, 0x0014, 0x11df,
    0x0023, 0xf4fe, 0x0043, 0xfcff, 0x0083, 0x009e, 0x0055, 0x0077,
    0x0023, 0x0035, 0x0043, 0xf1ff, 0x0083, 0x88ae, 0x0014, 0x00b7,
    0x0023, 0xf8fe, 0x0043, 0xe4ef, 0x0083, 0x888e, 0x00c5, 0x111f,
    0x0023, 0x00a5, 0x0043, 0x0066, 0x0083, 0xa8ee, 0x0014, 0x54df,
    0x0023, 0x10be, 0x0043, 0x22ef, 0x0083, 0x207e, 0x0055, 0x227f,
    0x0023, 0x0035, 0x0043, 0x444e, 0x0083, 0xc4ce, 0x0014, 0x11bf,
    0x0023, 0xe2fe, 0x0043, 0x00f7, 0x0083, 0x0096, 0x00c5, 0x223f,
    0x0023, 0x00a5, 0x0043, 0x445e, 0x0083, 0xc8ce, 0x0014, 0x00d7,
    0x0023, 0xf4fe, 0x0043, 0xbaff, 0x0083, 0x009e, 0x0055, 0x006f,
    0x0023, 0x0035, 0x0043, 0xe6ff, 0x0083, 0x88ae, 0x0014, 0xa2af,
    0x0023, 0xf8fe, 0x0043, 0x00e7, 0x0083, 0x888e, 0x00c5, 0x222f,
    0x0002, 0x00c5, 0x0084, 0x207e, 0x0002, 0xc4ce, 0x0024, 0x00f7,
    0x0002, 0xa2fe, 0x0044, 0x0056, 0x0002, 0x009e, 0x0014, 0x00d7,
    0x0002, 0x10be, 0x0084, 0x0066, 0x0002, 0x88ae, 0x0024, 0x11df,
    0x0002, 0xa8ee, 0x0044, 0x0036, 0x0002, 0x888e, 0x0014, 0x111f,
    0x0002, 0x00c5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0x88ff,
    0x0002, 0xb8fe, 0x0044, 0x444e, 0x0002, 0x0096, 0x0014, 0x00b7,
    0x0002, 0xe4fe, 0x0084, 0x445e, 0x0002, 0x00a6, 0x0024, 0x00e7,
    0x0002, 0x54de, 0x0044, 0x222e, 0x0002, 0x003e, 0x0014, 0x0077,
    0x0002, 0x00c5, 0x0084, 0x207e, 0x0002, 0xc4ce, 0x0024, 0xf1ff,
    0x0002, 0xa2fe, 0x0044, 0x0056, 0x0002, 0x009e, 0x0014, 0x11bf,
    0x0002, 0x10be, 0x0084, 0x0066, 0x0002, 0x88ae, 0x0024, 0x22ef,
    0x0002, 0xa8ee, 0x0044, 0x0036, 0x0002, 0x888e, 0x0014, 0x227f,
    0x0002, 0x00c5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0xe4ef,
    0x0002, 0xb8fe, 0x0044, 0x444e, 0x0002, 0x0096, 0x0014, 0xa2af,
    0x0002, 0xe4fe, 0x0084, 0x445e, 0x0002, 0x00a6, 0x0024, 0xd8df,
    0x0002, 0x54de, 0x0044, 0x222e, 0x0002, 0x003e, 0x0014, 0x515f,
    0x0002, 0x0055, 0x0084, 0x0066, 0x0002, 0x88de, 0x0024, 0x32ff,
    0x0002, 0x11fe, 0x0044, 0x444e, 0x0002, 0x00ae, 0x0014, 0x00b7,
    0x0002, 0x317e, 0x0084, 0x515e, 0x0002, 0x00c6, 0x0024, 0x00d7,
    0x0002, 0x20ee, 0x0044, 0x111e, 0x0002, 0x009e, 0x0014, 0x0077,
    0x0002, 0x0055, 0x0084, 0x545e, 0x0002, 0x44ce, 0x0024, 0x00e7,
    0x0002, 0xf1fe, 0x0044, 0x0036, 0x0002, 0x00a6, 0x0014, 0x555f,
    0x0002, 0x74fe, 0x0084, 0x113e, 0x0002, 0x20be, 0x0024, 0x747f,
    0x0002, 0xc4de, 0x0044, 0xf8ff, 0x0002, 0x0096, 0x0014, 0x222f,
    0x0002, 0x0055, 0x0084, 0x0066, 0x0002, 0x88de, 0x0024, 0x00f7,
    0x0002, 0x11fe, 0x0044, 0x444e, 0x0002, 0x00ae, 0x0014, 0x888f,
    0x0002, 0x317e, 0x0084, 0x515e, 0x0002, 0x00c6, 0x0024, 0xc8cf,
    0x0002, 0x20ee, 0x0044, 0x111e, 0x0002, 0x009e, 0x0014, 0x006f,
    0x0002, 0x0055, 0x0084, 0x545e, 0x0002, 0x44ce, 0x0024, 0xd1df,
    0x0002, 0xf1fe, 0x0044, 0x0036, 0x0002, 0x00a6, 0x0014, 0x227f,
    0x0002, 0x74fe, 0x0084, 0x113e, 0x0002, 0x20be, 0x0024, 0x22bf,
    0x0002, 0xc4de, 0x0044, 0x22ef, 0x0002, 0x0096, 0x0014, 0x323f,
    0x0003, 0xd4de, 0xf4fd, 0xfcff, 0x0014, 0x113e, 0x0055, 0x888f,
    0x0003, 0x32be, 0x0085, 0x00e7, 0x0025, 0x515e, 0xaafe, 0x727f,
    0x0003, 0x44ce, 0xf8fd, 0x44ef, 0x0014, 0x647e, 0x0045, 0xa2af,
    0x0003, 0x00a6, 0x555d, 0x99df, 0xf1fd, 0x0036, 0xf5fe, 0x626f,
    0x0003, 0xd1de, 0xf4fd, 0xe6ff, 0x0014, 0x717e, 0x0055, 0xb1bf,
    0x0003, 0x88ae, 0x0085, 0xd5df, 0x0025, 0x444e, 0xf2fe, 0x667f,
    0x0003, 0x00c6, 0xf8fd, 0xe2ef, 0x0014, 0x545e, 0x0045, 0x119f,
    0x0003, 0x0096, 0x555d, 0xc8cf, 0xf1fd, 0x111e, 0xc8ee, 0x0067,
    0x0003, 0xd4de, 0xf4fd, 0xf3ff, 0x0014, 0x113e, 0x0055, 0x11bf,
    0x0003, 0x32be, 0x0085, 0xd8df, 0x0025, 0x515e, 0xaafe, 0x222f,
    0x0003, 0x44ce, 0xf8fd, 0x00f7, 0x0014, 0x647e, 0x0045, 0x989f,
    0x0003, 0x00a6, 0x555d, 0x00d7, 0xf1fd, 0x0036, 0xf5fe, 0x446f,
    0x0003, 0xd1de, 0xf4fd, 0xb9ff, 0x0014, 0x717e, 0x0055, 0x00b7,
    0x0003, 0x88ae, 0x0085, 0xdcdf, 0x0025, 0x444e, 0xf2fe, 0x0077,
    0x0003, 0x00c6, 0xf8fd, 0xe4ef, 0x0014, 0x545e, 0x0045, 0x737f,
    0x0003, 0x0096, 0x555d, 0xb8bf, 0xf1fd, 0x111e, 0xc8ee, 0x323f,
    0x0002, 0x00a5, 0x0084, 0x407e, 0x0002, 0x10de, 0x0024, 0x11df,
    0x0002, 0x72fe, 0x0044, 0x0056, 0x0002, 0xa8ae, 0x0014, 0xb2bf,
    0x0002, 0x0096, 0x0084, 0x0066, 0x0002, 0x00c6, 0x0024, 0x00e7,
    0x0002, 0xc8ee, 0x0044, 0x222e, 0x0002, 0x888e, 0x0014, 0x0077,
    0x0002, 0x00a5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0x00f7,
    0x0002, 0x91fe, 0x0044, 0x0036, 0x0002, 0xa2ae, 0x0014, 0xaaaf,
    0x0002, 0xb8fe, 0x0084, 0x005e, 0x0002, 0x00be, 0x0024, 0xc4cf,
    0x0002, 0x44ee, 0x0044, 0xf4ff, 0x0002, 0x223e, 0x0014, 0x111f,
    0x0002, 0x00a5, 0x0084, 0x407e, 0x0002, 0x10de, 0x0024, 0x99ff,
    0x0002, 0x72fe, 0x0044, 0x0056, 0x0002, 0xa8ae, 0x0014, 0x00b7,
    0x0002, 0x0096, 0x0084, 0x0066, 0x0002, 0x00c6, 0x0024, 0x00d7,
    0x0002, 0xc8ee, 0x0044, 0x222e, 0x0002, 0x888e, 0x0014, 0x444f,
    0x0002, 0x00a5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0xe2ef,
    0x0002, 0x91fe, 0x0044, 0x0036, 0x0002, 0xa2ae, 0x0014, 0x447f,
    0x0002, 0xb8fe, 0x0084, 0x005e, 0x0002, 0x00be, 0x0024, 0x009f,
    0x0002, 0x44ee, 0x0044, 0x76ff, 0x0002, 0x223e, 0x0014, 0x313f,
    0x0003, 0x00c6, 0x0085, 0xd9ff, 0xf2fd, 0x647e, 0xf1fe, 0x99bf,
    0x0003, 0xa2ae, 0x0025, 0x66ef, 0xf4fd, 0x0056, 0xe2ee, 0x737f,
    0x0003, 0x98be, 0x0045, 0x00f7, 0xf8fd, 0x0066, 0x76fe, 0x889f,
    0x0003, 0x888e, 0x0015, 0xd5df, 0x00a5, 0x222e, 0x98de, 0x444f,
    0x0003, 0xb2be, 0x0085, 0xfcff, 0xf2fd, 0x226e, 0x0096, 0x00b7,
    0x0003, 0xaaae, 0x0025, 0xd1df, 0xf4fd, 0x0036, 0xd4de, 0x646f,
    0x0003, 0xa8ae, 0x0045, 0xeaef, 0xf8fd, 0x445e, 0xe8ee, 0x717f,
    0x0003, 0x323e, 0x0015, 0xc4cf, 0x00a5, 0xfaff, 0x88ce, 0x313f,
    0x0003, 0x00c6, 0x0085, 0x77ff, 0xf2fd, 0x647e, 0xf1fe, 0xb3bf,
    0x0003, 0xa2ae, 0x0025, 0x00e7, 0xf4fd, 0x0056, 0xe2ee, 0x0077,
    0x0003, 0x98be, 0x0045, 0xe4ef, 0xf8fd, 0x0066, 0x76fe, 0x667f,
    0x0003, 0x888e, 0x0015, 0x00d7, 0x00a5, 0x222e, 0x98de, 0x333f,
    0x0003, 0xb2be, 0x0085, 0x75ff, 0xf2fd, 0x226e, 0x0096, 0x919f,
    0x0003, 0xaaae, 0x0025, 0x99df, 0xf4fd, 0x0036, 0xd4de, 0x515f,
    0x0003, 0xa8ae, 0x0045, 0xecef, 0xf8fd, 0x445e, 0xe8ee, 0x727f,
    0x0003, 0x323e, 0x0015, 0xb1bf, 0x00a5, 0xf3ff, 0x88ce, 0x111f,
    0x0003, 0x54de, 0xf2fd, 0x111e, 0x0014, 0x647e, 0xf8fe, 0xcccf,
    0x0003, 0x91be, 0x0045, 0x22ef, 0x0025, 0x222e, 0xf3fe, 0x888f,
    0x0003, 0x00c6, 0x0085, 0x00f7, 0x0014, 0x115e, 0xfcfe, 0xa8af,
    0x0003, 0x00a6, 0x0035, 0xc8df, 0xf1fd, 0x313e, 0x66fe, 0x646f,
    0x0003, 0xc8ce, 0xf2fd, 0xf5ff, 0x0014, 0x0066, 0xf4fe, 0xbabf,
    0x0003, 0x22ae, 0x0045, 0x00e7, 0x0025, 0x323e, 0xeafe, 0x737f,
    0x0003, 0xb2be, 0x0085, 0x55df, 0x0014, 0x0056, 0x717e, 0x119f,
    0x0003, 0x0096, 0x0035, 0xc4cf, 0xf1fd, 0x333e, 0xe8ee, 0x444f,
    0x0003, 0x54de, 0xf2fd, 0x111e, 0x0014, 0x647e, 0xf8fe, 0x99bf,
    0x0003, 0x91be, 0x0045, 0xe2ef, 0x0025, 0x222e, 0xf3fe, 0x667f,
    0x0003, 0x00c6, 0x0085, 0xe4ef, 0x0014, 0x115e, 0xfcfe, 0x989f,
    0x0003, 0x00a6, 0x0035, 0x00d7, 0xf1fd, 0x313e, 0x66fe, 0x226f,
    0x0003, 0xc8ce, 0xf2fd, 0xb9ff, 0x0014, 0x0066, 0xf4fe, 0x00b7,
    0x0003, 0x22ae, 0x0045, 0xd1df, 0x0025, 0x323e, 0xeafe, 0x0077,
    0x0003, 0xb2be, 0x0085, 0xecef, 0x0014, 0x0056, 0x717e, 0x727f,
    0x0003, 0x0096, 0x0035, 0xb8bf, 0xf1fd, 0x333e, 0xe8ee, 0x545f,
    0xf1fc, 0xd1de, 0xfafd, 0x00d7, 0xf8fc, 0x0016, 0xfffd, 0x747f,
    0xf4fc, 0x717e, 0xf3fd, 0xb3bf, 0xf2fc, 0xeaef, 0xe8ee, 0x444f,
    0xf1fc, 0x22ae, 0x0005, 0xb8bf, 0xf8fc, 0x00f7, 0xfcfe, 0x0077,
    0xf4fc, 0x115e, 0xf5fd, 0x757f, 0xf2fc, 0xd8df, 0xe2ee, 0x333f,
    0xf1fc, 0xb2be, 0xfafd, 0x88cf, 0xf8fc, 0xfbff, 0xfffd, 0x737f,
    0xf4fc, 0x006e, 0xf3fd, 0x00b7, 0xf2fc, 0x66ef, 0xf9fe, 0x313f,
    0xf1fc, 0x009e, 0x0005, 0xbabf, 0xf8fc, 0xfdff, 0xf6fe, 0x0067,
    0xf4fc, 0x0026, 0xf5fd, 0x888f, 0xf2fc, 0xdcdf, 0xd4de, 0x222f,
    0xf1fc, 0xd1de, 0xfafd, 0xc4cf, 0xf8fc, 0x0016, 0xfffd, 0x727f,
    0xf4fc, 0x717e, 0xf3fd, 0x99bf, 0xf2fc, 0xecef, 0xe8ee, 0x0047,
    0xf1fc, 0x22ae, 0x0005, 0x00a7, 0xf8fc, 0xf7ff, 0xfcfe, 0x0057,
    0xf4fc, 0x115e, 0xf5fd, 0x0097, 0xf2fc, 0xd5df, 0xe2ee, 0x0037,
    0xf1fc, 0xb2be, 0xfafd, 0x00c7, 0xf8fc, 0xfeff, 0xfffd, 0x667f,
    0xf4fc, 0x006e, 0xf3fd, 0xa8af, 0xf2fc, 0x00e7, 0xf9fe, 0x323f,
    0xf1fc, 0x009e, 0x0005, 0xb1bf, 0xf8fc, 0xe4ef, 0xf6fe, 0x545f,
    0xf4fc, 0x0026, 0xf5fd, 0x0087, 0xf2fc, 0x99df, 0xd4de, 0x111f,
};
static const uint16_t kVlcTbl1[1024] = {
    0x0013, 0x0065, 0x0043, 0x00de, 0x0083, 0x888d, 0x0023, 0x444e,
    0x0013, 0x00a5, 0x0043, 0x88ae, 0x0083, 0x0035, 0x0023, 0x00d7,
    0x0013, 0x00c5, 0x0043, 0x009e, 0x0083, 0x0055, 0x0023, 0x222e,
    0x0013, 0x0095, 0x0043, 0x007e, 0x0083, 0x10fe, 0x0023, 0x0077,
    0x0013, 0x0065, 0x0043, 0x88ce, 0x0083, 0x888d, 0x0023, 0x111e,
    0x0013, 0x00a5, 0x0043, 0x005e, 0x0083, 0x0035, 0x0023, 0x00e7,
    0x0013, 0x00c5, 0x0043, 0x00be, 0x0083, 0x0055, 0x0023, 0x11ff,
    0x0013, 0x0095, 0x0043, 0x003e, 0x0083, 0x40ee, 0x0023, 0xa2af,
    0x0013, 0x0065, 0x0043, 0x00de, 0x0083, 0x888d, 0x0023, 0x444e,
    0x0013, 0x00a5, 0x0043, 0x88ae, 0x0083, 0x0035, 0x0023, 0x44ef,
    0x0013, 0x00c5, 0x0043, 0x009e, 0x0083, 0x0055, 0x0023, 0x222e,
    0x0013, 0x0095, 0x0043, 0x007e, 0x0083, 0x10fe, 0x0023, 0x00b7,
    0x0013, 0x0065, 0x0043, 0x88ce, 0x0083, 0x888d, 0x0023, 0x111e,
    0x0013, 0x00a5, 0x0043, 0x005e, 0x0083, 0x0035, 0x0023, 0xc4cf,
    0x0013, 0x00c5, 0x0043, 0x00be, 0x0083, 0x0055, 0x0023, 0x00f7,
    0x0013, 0x0095, 0x0043, 0x003e, 0x0083, 0x40ee, 0x0023, 0x006f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0014, 0x0001, 0x00d7,
    0x0001, 0x0024, 0x0001, 0x0096, 0x0001, 0x0045, 0x0001, 0x0077,
    0x0001, 0x0084, 0x0001, 0x00c6, 0x0001, 0x0014, 0x0001, 0x888f,
    0x0001, 0x0024, 0x0001, 0x00f7, 0x0001, 0x0035, 0x0001, 0x222f,
    0x0001, 0x0084, 0x0001, 0x40fe, 0x0001, 0x0014, 0x0001, 0x00b7,
    0x0001, 0x0024, 0x0001, 0x00bf, 0x0001, 0x0045, 0x0001, 0x0067,
    0x0001, 0x0084, 0x0001, 0x00a6, 0x0001, 0x0014, 0x0001, 0x444f,
    0x0001, 0x0024, 0x0001, 0x00e7, 0x0001, 0x0035, 0x0001, 0x113f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0014, 0x0001, 0x00cf,
    0x0001, 0x0024, 0x0001, 0x0096, 0x0001, 0x0045, 0x0001, 0x006f,
    0x0001, 0x0084, 0x0001, 0x00c6, 0x0001, 0x0014, 0x0001, 0x009f,
    0x0001, 0x0024, 0x0001, 0x00ef, 0x0001, 0x0035, 0x0001, 0x323f,
    0x0001, 0x0084, 0x0001, 0x40fe, 0x0001, 0x0014, 0x0001, 0x00af,
    0x0001, 0x0024, 0x0001, 0x44ff, 0x0001, 0x0045, 0x0001, 0x005f,
    0x0001, 0x0084, 0x0001, 0x00a6, 0x0001, 0x0014, 0x0001, 0x007f,
    0x0001, 0x0024, 0x0001, 0x00df, 0x0001, 0x0035, 0x0001, 0x111f,
    0x0001, 0x0024, 0x0001, 0x0056, 0x0001, 0x0085, 0x0001, 0x00bf,
    0x0001, 0x0014, 0x0001, 0x00f7, 0x0001, 0x00c6, 0x0001, 0x0077,
    0x0001, 0x0024, 0x0001, 0xf8ff, 0x0001, 0x0045, 0x0001, 0x007f,
    0x0001, 0x0014, 0x0001, 0x00df, 0x0001, 0x00a6, 0x0001, 0x313f,
    0x0001, 0x0024, 0x0001, 0x222e, 0x0001, 0x0085, 0x0001, 0x00b7,
    0x0001, 0x0014, 0x0001, 0x44ef, 0x0001, 0xa2ae, 0x0001, 0x0067,
    0x0001, 0x0024, 0x0001, 0x51ff, 0x0001, 0x0045, 0x0001, 0x0097,
    0x0001, 0x0014, 0x0001, 0x00cf, 0x0001, 0x0036, 0x0001, 0x223f,
    0x0001, 0x0024, 0x0001, 0x0056, 0x0001, 0x0085, 0x0001, 0xb2bf,
    0x0001, 0x0014, 0x0001, 0x40ef, 0x0001, 0x00c6, 0x0001, 0x006f,
    0x0001, 0x0024, 0x0001, 0x72ff, 0x0001, 0x0045, 0x0001, 0x009f,
    0x0001, 0x0014, 0x0001, 0x00d7, 0x0001, 0x00a6, 0x0001, 0x444f,
    0x0001, 0x0024, 0x0001, 0x222e, 0x0001, 0x0085, 0x0001, 0xa8af,
    0x0001, 0x0014, 0x0001, 0x00e7, 0x0001, 0xa2ae, 0x0001, 0x005f,
    0x0001, 0x0024, 0x0001, 0x44ff, 0x0001, 0x0045, 0x0001, 0x888f,
    0x0001, 0x0014, 0x0001, 0xaaaf, 0x0001, 0x0036, 0x0001, 0x111f,
    0x0002, 0xf8fe, 0x0024, 0x0056, 0x0002, 0x00b6, 0x0085, 0x66ff,
    0x0002, 0x00ce, 0x0014, 0x111e, 0x0002, 0x0096, 0x0035, 0xa8af,
    0x0002, 0x00f6, 0x0024, 0x313e, 0x0002, 0x00a6, 0x0045, 0xb3bf,
    0x0002, 0xb2be, 0x0014, 0xf5ff, 0x0002, 0x0066, 0x517e, 0x545f,
    0x0002, 0xf2fe, 0x0024, 0x222e, 0x0002, 0x22ae, 0x0085, 0x44ef,
    0x0002, 0x00c6, 0x0014, 0xf4ff, 0x0002, 0x0076, 0x0035, 0x447f,
    0x0002, 0x40de, 0x0024, 0x323e, 0x0002, 0x009e, 0x0045, 0x00d7,
    0x0002, 0x88be, 0x0014, 0xfaff, 0x0002, 0x115e, 0xf1fe, 0x444f,
    0x0002, 0xf8fe, 0x0024, 0x0056, 0x0002, 0x00b6, 0x0085, 0xc8ef,
    0x0002, 0x00ce, 0x0014, 0x111e, 0x0002, 0x0096, 0x0035, 0x888f,
    0x0002, 0x00f6, 0x0024, 0x313e, 0x0002, 0x00a6, 0x0045, 0x44df,
    0x0002, 0xb2be, 0x0014, 0xa8ff, 0x0002, 0x0066, 0x517e, 0x006f,
    0x0002, 0xf2fe, 0x0024, 0x222e, 0x0002, 0x22ae, 0x0085, 0x00e7,
    0x0002, 0x00c6, 0x0014, 0xe2ef, 0x0002, 0x0076, 0x0035, 0x727f,
    0x0002, 0x40de, 0x0024, 0x323e, 0x0002, 0x009e, 0x0045, 0xb1bf,
    0x0002, 0x88be, 0x0014, 0x73ff, 0x0002, 0x115e, 0xf1fe, 0x333f,
    0x0001, 0x0084, 0x0001, 0x20ee, 0x0001, 0x00c5, 0x0001, 0xc4cf,
    0x0001, 0x0044, 0x0001, 0x32ff, 0x0001, 0x0015, 0x0001, 0x888f,
    0x0001, 0x0084, 0x0001, 0x0066, 0x0001, 0x0025, 0x0001, 0x00af,
    0x0001, 0x0044, 0x0001, 0x22ef, 0x0001, 0x00a6, 0x0001, 0x005f,
    0x0001, 0x0084, 0x0001, 0x444e, 0x0001, 0x00c5, 0x0001, 0xcccf,
    0x0001, 0x0044, 0x0001, 0x00f7, 0x0001, 0x0015, 0x0001, 0x006f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0025, 0x0001, 0x009f,
    0x0001, 0x0044, 0x0001, 0x00df, 0x0001, 0x30fe, 0x0001, 0x222f,
    0x0001, 0x0084, 0x0001, 0x20ee, 0x0001, 0x00c5, 0x0001, 0xc8cf,
    0x0001, 0x0044, 0x0001, 0x11ff, 0x0001, 0x0015, 0x0001, 0x0077,
    0x0001, 0x0084, 0x0001, 0x0066, 0x0001, 0x0025, 0x0001, 0x007f,
    0x0001, 0x0044, 0x0001, 0x00e7, 0x0001, 0x00a6, 0x0001, 0x0037,
    0x0001, 0x0084, 0x0001, 0x444e, 0x0001, 0x00c5, 0x0001, 0x00b7,
    0x0001, 0x0044, 0x0001, 0x00bf, 0x0001, 0x0015, 0x0001, 0x003f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0025, 0x0001, 0x0097,
    0x0001, 0x0044, 0x0001, 0x00d7, 0x0001, 0x30fe, 0x0001, 0x111f,
    0x0002, 0xa8ee, 0x0044, 0x888e, 0x0002, 0x00d6, 0x00c5, 0xf3ff,
    0x0002, 0xfcfe, 0x0025, 0x003e, 0x0002, 0x00b6, 0x0055, 0xd8df,
    0x0002, 0xf8fe, 0x0044, 0x0066, 0x0002, 0x207e, 0x0085, 0x99ff,
    0x0002, 0x00e6, 0x00f5, 0x0036, 0x0002, 0x00a6, 0x0015, 0x009f,
    0x0002, 0xf2fe, 0x0044, 0x0076, 0x0002, 0x44ce, 0x00c5, 0x76ff,
    0x0002, 0xf1fe, 0x0025, 0x444e, 0x0002, 0x00ae, 0x0055, 0xc8cf,
    0x0002, 0xf4fe, 0x0044, 0x445e, 0x0002, 0x10be, 0x0085, 0xe4ef,
    0x0002, 0x54de, 0x00f5, 0x111e, 0x0002, 0x0096, 0x0015, 0x222f,
    0x0002, 0xa8ee, 0x0044, 0x888e, 0x0002, 0x00d6, 0x00c5, 0xfaff,
    0x0002, 0xfcfe, 0x0025, 0x003e, 0x0002, 0x00b6, 0x0055, 0x11bf,
    0x0002, 0xf8fe, 0x0044, 0x0066, 0x0002, 0x207e, 0x0085, 0x22ef,
    0x0002, 0x00e6, 0x00f5, 0x0036, 0x0002, 0x00a6, 0x0015, 0x227f,
    0x0002, 0xf2fe, 0x0044, 0x0076, 0x0002, 0x44ce, 0x00c5, 0xd5ff,
    0x0002, 0xf1fe, 0x0025, 0x444e, 0x0002, 0x00ae, 0x0055, 0x006f,
    0x0002, 0xf4fe, 0x0044, 0x445e, 0x0002, 0x10be, 0x0085, 0x11df,
    0x0002, 0x54de, 0x00f5, 0x111e, 0x0002, 0x0096, 0x0015, 0x515f,
    0x0003, 0x00f6, 0x0014, 0x111e, 0x0044, 0x888e, 0x00a5, 0xd4df,
    0x0003, 0xa2ae, 0x0055, 0x76ff, 0x0024, 0x223e, 0x00b6, 0xaaaf,
    0x0003, 0x00e6, 0x0014, 0xf5ff, 0x0044, 0x0066, 0x0085, 0xcccf,
    0x0003, 0x009e, 0x00c5, 0x44ef, 0x0024, 0x0036, 0xf8fe, 0x317f,
    0x0003, 0xe8ee, 0x0014, 0xf1ff, 0x0044, 0x0076, 0x00a5, 0xc4cf,
    0x0003, 0x227e, 0x0055, 0xd1df, 0x0024, 0x444e, 0xf4fe, 0x515f,
    0x0003, 0x00d6, 0x0014, 0xe2ef, 0x0044, 0x445e, 0x0085, 0x22bf,
    0x0003, 0x0096, 0x00c5, 0xc8df, 0x0024, 0x222e, 0xf2fe, 0x226f,
    0x0003, 0x00f6, 0x0014, 0x111e, 0x0044, 0x888e, 0x00a5, 0xb1bf,
    0x0003, 0xa2ae, 0x0055, 0x33ff, 0x0024, 0x223e, 0x00b6, 0xa8af,
    0x0003, 0x00e6, 0x0014, 0xb9ff, 0x0044, 0x0066, 0x0085, 0xa8bf,
    0x0003, 0x009e, 0x00c5, 0xe4ef, 0x0024, 0x0036, 0xf8fe, 0x646f,
    0x0003, 0xe8ee, 0x0014, 0xfcff, 0x0044, 0x0076, 0x00a5, 0xc8cf,
    0x0003, 0x227e, 0x0055, 0xeaef, 0x0024, 0x444e, 0xf4fe, 0x747f,
    0x0003, 0x00d6, 0x0014, 0xfaff, 0x0044, 0x445e, 0x0085, 0xb2bf,
    0x0003, 0x0096, 0x00c5, 0x44df, 0x0024, 0x222e, 0xf2fe, 0x313f,
    0x00f3, 0xfafe, 0xf1fd, 0x0036, 0x0004, 0x32be, 0x0075, 0x11df,
    0x00f3, 0x54de, 0xf2fd, 0xe4ef, 0x00d5, 0x717e, 0xfcfe, 0x737f,
    0x00f3, 0xf3fe, 0xf8fd, 0x111e, 0x0004, 0x0096, 0x0055, 0xb1bf,
    0x00f3, 0x00ce, 0x00b5, 0xd8df, 0xf4fd, 0x0066, 0xb9fe, 0x545f,
    0x00f3, 0x76fe, 0xf1fd, 0x0026, 0x0004, 0x00a6, 0x0075, 0x009f,
    0x00f3, 0x00ae, 0xf2fd, 0xf7ff, 0x00d5, 0x0046, 0xf5fe, 0x747f,
    0x00f3, 0x00e6, 0xf8fd, 0x0016, 0x0004, 0x0086, 0x0055, 0x888f,
    0x00f3, 0x00c6, 0x00b5, 0xe2ef, 0xf4fd, 0x115e, 0xa8ee, 0x113f,
    0x00f3, 0xfafe, 0xf1fd, 0x0036, 0x0004, 0x32be, 0x0075, 0xd1df,
    0x00f3, 0x54de, 0xf2fd, 0xfbff, 0x00d5, 0x717e, 0xfcfe, 0x447f,
    0x00f3, 0xf3fe, 0xf8fd, 0x111e, 0x0004, 0x0096, 0x0055, 0x727f,
    0x00f3, 0x00ce, 0x00b5, 0x22ef, 0xf4fd, 0x0066, 0xb9fe, 0x444f,
    0x00f3, 0x76fe, 0xf1fd, 0x0026, 0x0004, 0x00a6, 0x0075, 0x11bf,
    0x00f3, 0x00ae, 0xf2fd, 0xffff, 0x00d5, 0x0046, 0xf5fe, 0x323f,
    0x00f3, 0x00e6, 0xf8fd, 0x0016, 0x0004, 0x0086, 0x0055, 0x006f,
    0x00f3, 0x00c6, 0x00b5, 0xb8bf, 0xf4fd, 0x115e, 0xa8ee, 0x222f,
};

static const int kMelExp[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};
// 2 bits prefix length, 3 bits suffix length, 3 bits prefix value
static const u8 kUvlcDec[8] = {0xb7, 0x21, 0x42, 0x21, 0x67, 0x21, 0x42, 0x21};

static inline u32 popcount32(u32 v) { return (u32)__builtin_popcount(v); }
static inline u32 clz32(u32 v) { return (u32)__builtin_clz(v); }
// x86's shift, the count taken modulo 32, as OpenJPEG's build computes
// its shifts by p - 2
static inline u32 shl32(u32 v, u32 n) { return v << (n & 31); }

// the MEL decoder (dec_mel_t)
struct HtMel {
  const u8* data;
  u64 tmp;
  int bits, size;
  bool unstuff;
  int k, num_runs;
  u64 runs;

  void read() {
    if (bits > 32) return;
    u32 val = 0xffffffffu;
    if (size > 4) {
      val = (u32)data[0] | (u32)data[1] << 8 | (u32)data[2] << 16 |
            (u32)data[3] << 24;
      data += 4;
      size -= 4;
    } else if (size > 0) {
      int i = 0;
      while (size > 1) {
        u32 v = *data++;
        u32 m = ~(0xffu << i);
        val = (val & m) | (v << i);
        --size;
        i += 8;
      }
      u32 v = *data++;
      v |= 0xf;
      u32 m = ~(0xffu << i);
      val = (val & m) | (v << i);
      --size;
    }
    int nb = 32 - (int)unstuff;
    u32 t = val & 0xff;
    bool u = (val & 0xff) == 0xff;
    nb -= (int)u;
    t = t << (8 - (int)u);
    t |= (val >> 8) & 0xff;
    u = ((val >> 8) & 0xff) == 0xff;
    nb -= (int)u;
    t = t << (8 - (int)u);
    t |= (val >> 16) & 0xff;
    u = ((val >> 16) & 0xff) == 0xff;
    nb -= (int)u;
    t = t << (8 - (int)u);
    t |= (val >> 24) & 0xff;
    unstuff = ((val >> 24) & 0xff) == 0xff;
    tmp |= (u64)t << (64 - nb - bits);
    bits += nb;
  }

  void decode() {
    if (bits < 6) read();
    while (bits >= 6 && num_runs < 8) {
      int eval = kMelExp[k];
      int run;
      if (tmp & (1ull << 63)) {
        run = (1 << eval) - 1;
        k = (k < 11 ? k : 11) + 1;
        tmp <<= 1;
        bits -= 1;
        run = run << 1;
      } else {
        run = (int)(tmp >> (63 - eval)) & ((1 << eval) - 1);
        k = (k > 1 ? k : 1) - 1;
        tmp <<= eval + 1;
        bits -= eval + 1;
        run = (run << 1) + 1;
      }
      int sh = num_runs * 7;
      runs &= ~((u64)0x3f << sh);
      runs |= (u64)(i64)run << sh;
      num_runs++;
    }
  }

  // mel_init; addr4 is the address of the MEL data modulo 4
  bool init(const u8* bbuf, int lcup, int scup, u32 addr4) {
    data = bbuf + lcup - scup;
    bits = 0;
    tmp = 0;
    unstuff = false;
    size = scup - 1;
    k = 0;
    num_runs = 0;
    runs = 0;
    int num = 4 - (int)(addr4 & 3);
    for (int i = 0; i < num; ++i) {
      if (unstuff && data[0] > 0x8f) return false;
      u64 d = size > 0 ? *data : 0xff;
      if (size == 1) d |= 0xf;
      data += size-- > 0;
      int d_bits = 8 - (int)unstuff;
      tmp = (tmp << d_bits) | d;
      bits += d_bits;
      unstuff = (d & 0xff) == 0xff;
    }
    tmp <<= (64 - bits);
    return true;
  }

  int get_run() {
    if (num_runs == 0) decode();
    int t = (int)(runs & 0x7f);
    runs >>= 7;
    num_runs--;
    return t;
  }
};

// the backward readers (rev_struct_t): the VLC segment, and the MagRef
// segment (rev_*_mrp, which differs only in its start)
struct HtRev {
  const u8* data;
  u64 tmp;
  u32 bits;
  int size;
  bool unstuff;

  void read() {
    if (bits > 32) return;
    u32 val = 0;
    if (size > 3) {
      val = (u32)data[-3] | (u32)data[-2] << 8 | (u32)data[-1] << 16 |
            (u32)data[0] << 24;
      data -= 4;
      size -= 4;
    } else if (size > 0) {
      int i = 24;
      while (size > 0) {
        u32 v = *data--;
        val |= v << i;
        --size;
        i -= 8;
      }
    }
    u32 t = val >> 24;
    u32 nb = 8u - ((unstuff && (((val >> 24) & 0x7f) == 0x7f)) ? 1u : 0u);
    bool u = (val >> 24) > 0x8f;
    t |= ((val >> 16) & 0xff) << nb;
    nb += 8u - ((u && (((val >> 16) & 0x7f) == 0x7f)) ? 1u : 0u);
    u = ((val >> 16) & 0xff) > 0x8f;
    t |= ((val >> 8) & 0xff) << nb;
    nb += 8u - ((u && (((val >> 8) & 0x7f) == 0x7f)) ? 1u : 0u);
    u = ((val >> 8) & 0xff) > 0x8f;
    t |= (val & 0xff) << nb;
    nb += 8u - ((u && ((val & 0x7f) == 0x7f)) ? 1u : 0u);
    u = (val & 0xff) > 0x8f;
    tmp |= (u64)t << bits;
    bits += nb;
    unstuff = u;
  }

  // rev_init: the VLC segment ends at byte lcup - 2, whose low half is
  // Scup's
  void init_vlc(const u8* d0, int lcup, int scup) {
    data = d0 + lcup - 2;
    size = scup - 2;
    u32 d = *data--;
    tmp = d >> 4;
    bits = 4 - ((tmp & 7) == 7);
    unstuff = (d | 0xf) > 0x8f;
    // OpenJPEG reads 1 to 4 bytes here by the address; any count gives
    // the same bits
    int tnum = 1 < size ? 1 : size;
    for (int i = 0; i < tnum; ++i) {
      u64 b = *data--;
      u32 d_bits = 8u - ((unstuff && ((b & 0x7f) == 0x7f)) ? 1u : 0u);
      tmp |= b << bits;
      bits += d_bits;
      unstuff = b > 0x8f;
    }
    size -= tnum;
    read();
  }

  // rev_init_mrp: the MagRef segment is read back from the end of the
  // second segment
  void init_mrp(const u8* d0, int lcup, int len2) {
    data = d0 + lcup + len2 - 1;
    size = len2;
    unstuff = true;
    bits = 0;
    tmp = 0;
    u64 b = size-- > 0 ? *data-- : 0;
    u32 d_bits = 8u - ((unstuff && ((b & 0x7f) == 0x7f)) ? 1u : 0u);
    tmp |= b << bits;
    bits += d_bits;
    unstuff = b > 0x8f;
    read();
  }

  u32 fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return (u32)tmp;
  }
  u32 advance(u32 n) {
    tmp >>= n;
    bits -= n;
    return (u32)tmp;
  }
};

// the forward readers (frwd_struct_t): MagSgn (X = 0xff) and SigProp
// (X = 0)
struct HtFwd {
  const u8* data;
  u64 tmp;
  u32 bits;
  bool unstuff;
  int size;
  u32 X;

  void read() {
    u32 val;
    if (size > 3) {
      val = (u32)data[0] | (u32)data[1] << 8 | (u32)data[2] << 16 |
            (u32)data[3] << 24;
      data += 4;
      size -= 4;
    } else if (size > 0) {
      int i = 0;
      val = X != 0 ? 0xffffffffu : 0;
      while (size > 0) {
        u32 v = *data++;
        u32 m = ~(0xffu << i);
        val = (val & m) | (v << i);
        --size;
        i += 8;
      }
    } else {
      val = X != 0 ? 0xffffffffu : 0;
    }
    u32 nb = 8u - (unstuff ? 1u : 0u);
    u32 t = val & 0xff;
    bool u = (val & 0xff) == 0xff;
    t |= ((val >> 8) & 0xff) << nb;
    nb += 8u - (u ? 1u : 0u);
    u = ((val >> 8) & 0xff) == 0xff;
    t |= ((val >> 16) & 0xff) << nb;
    nb += 8u - (u ? 1u : 0u);
    u = ((val >> 16) & 0xff) == 0xff;
    t |= ((val >> 24) & 0xff) << nb;
    nb += 8u - (u ? 1u : 0u);
    unstuff = ((val >> 24) & 0xff) == 0xff;
    tmp |= (u64)t << bits;
    bits += nb;
  }

  void init(const u8* d0, int sz, u32 x) {
    data = d0;
    tmp = 0;
    bits = 0;
    unstuff = false;
    size = sz;
    X = x;
    // OpenJPEG reads 1 to 4 bytes here by the address; one gives the
    // same bits
    u64 d = size-- > 0 ? *data++ : X;
    tmp |= d << bits;
    bits += 8u - (unstuff ? 1u : 0u);
    unstuff = (d & 0xff) == 0xff;
    read();
  }

  void advance(u32 n) {
    tmp >>= n;
    bits -= n;
  }
  u32 fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return (u32)tmp;
  }
};

// one U-VLC prefix (a kUvlcDec entry) taken off the head of vlc
static inline u32 uvlc_prefix(u32& vlc, u32& consumed) {
  u32 d = kUvlcDec[vlc & 0x7];
  vlc >>= d & 0x3;
  consumed += d & 0x3;
  return d;
}

// the u a prefix's suffix gives (prefix value plus suffix)
static inline u32 uvlc_suffix(u32 d, u32& vlc, u32& consumed) {
  u32 suffix_len = (d >> 2) & 0x7;
  consumed += suffix_len;
  u32 u = (d >> 5) + (vlc & ((1u << suffix_len) - 1));
  vlc >>= suffix_len;
  return u;
}

// decode_init_uvlc (first row) and decode_noninit_uvlc: u + kappa for
// both quads of a pair by mode (bit 0 and 1: each quad's u_off; in the
// first row 4 where both are set and the MEL event is 1, which adds 2
// to each); the bits consumed
static u32 decode_uvlc(u32 vlc, u32 mode, u32* u, bool first_row) {
  u32 consumed = 0;
  if (mode == 0) {
    u[0] = u[1] = 1;
  } else if (mode <= 2) {
    u32 d = uvlc_suffix(uvlc_prefix(vlc, consumed), vlc, consumed);
    u[0] = (mode == 1) ? d + 1 : 1;
    u[1] = (mode == 1) ? 1 : d + 1;
  } else if (mode == 3 && first_row && (kUvlcDec[vlc & 0x7] & 0x3) > 2) {
    // u_q1 above 2: the other quad's u is 1 or 2, in one bit
    u32 d1 = uvlc_prefix(vlc, consumed);
    u[1] = (vlc & 1) + 1 + 1;
    ++consumed;
    vlc >>= 1;
    u[0] = uvlc_suffix(d1, vlc, consumed) + 1;
  } else if (mode <= 4) {
    u32 d1 = uvlc_prefix(vlc, consumed);
    u32 d2 = uvlc_prefix(vlc, consumed);
    u32 add = mode == 4 ? 3 : 1;
    u[0] = uvlc_suffix(d1, vlc, consumed) + add;
    u[1] = uvlc_suffix(d2, vlc, consumed) + add;
  }
  return consumed;
}

// one significant sample of the cleanup pass: m_n bits of MagSgn (the
// sign in the first), the EMB bit e_1 above them, the bin centre below
static inline u32 ht_sample(HtFwd& ms, u32 U, u32 qinf, int i, u32 p,
                            u32* vn_out) {
  u32 ms_val = ms.fetch();
  u32 m_n = U - ((qinf >> (12 + i)) & 1);
  ms.advance(m_n);
  u32 val = ms_val << 31;
  u32 v_n = ms_val & ((1u << m_n) - 1);
  v_n |= ((qinf >> (8 + i)) & 1) << m_n;
  v_n |= 1;
  *vn_out = v_n;
  return val | ((v_n + 2) << (p - 1));
}

// the four samples of a quad (columns sp and sp + 1, two rows) as the
// cleanup pass gives them, zero where significance marks none inside the
// block (locs4), and the line state of the row's lower samples: lsp[0]
// takes the larger exponent of the column pair it spans, lsp[1] the
// right column's
static void ht_quad(HtFwd& ms, u32 U, u32 qinf, u32 locs4, u32 p, u32* sp,
                    i32 stride, u8* lsp, bool first_row) {
  u32 v_n;
  if (qinf & 0x10) sp[0] = ht_sample(ms, U, qinf, 0, p, &v_n);
  else if (locs4 & 0x1) sp[0] = 0;
  if (qinf & 0x20) {
    sp[stride] = ht_sample(ms, U, qinf, 1, p, &v_n);
    u32 t = lsp[0] & 0x7f;
    v_n = 32 - clz32(v_n);
    lsp[0] = (u8)(0x80 | (t > v_n ? t : v_n));
  } else if (locs4 & 0x2) {
    sp[stride] = 0;
  }
  if (qinf & 0x40) sp[1] = ht_sample(ms, U, qinf, 2, p, &v_n);
  else if (locs4 & 0x4) sp[1] = 0;
  if (first_row) lsp[1] = 0;
  if (qinf & 0x80) {
    sp[1 + stride] = ht_sample(ms, U, qinf, 3, p, &v_n);
    lsp[1] = (u8)(0x80 | (32 - clz32(v_n)));
  } else if (locs4 & 0x8) {
    sp[1 + stride] = 0;
  }
}

// the significance found by SigProp in one stripe (4 rows, or `pattern`'s
// rows of the last), its signs, and the membership it passes on:
// OpenJPEG's loop over groups of 8 columns, run for a whole stripe and
// for the last
static void ht_sigprop_stripe(u32* dec, i32 stride, i32 width, i32 row,
                              u32* cur_sig, u32* cur_mbr, u32* nxt_sig,
                              u32* nxt_mbr, u32 pattern, u32 val,
                              HtFwd& sigprop) {
  for (i32 i = 0; i < width;
       i += 8, cur_sig++, cur_mbr++, nxt_sig++, nxt_mbr++) {
    u32 mbr = *cur_mbr & pattern;
    u32 new_sig = 0;
    if (mbr) {
      for (i32 n = 0; n < 8; n += 4) {
        u32 cwd = sigprop.fetch();
        u32 cnt = 0;
        u32* dp = dec + (size_t)row * stride + i + n;
        u32 col_mask = 0xfu << (4 * n);
        u32 inv_sig = ~cur_sig[0] & pattern;
        i32 end = n + 4 + i < width ? n + 4 : width - i;
        for (i32 j = n; j < end; ++j, ++dp, col_mask <<= 4) {
          if ((col_mask & mbr) == 0) continue;
          static const u32 prop[4] = {0x32u, 0x74u, 0xe8u, 0xc0u};
          u32 sample_mask = 0x11111111u & col_mask;
          for (int r = 0; r < 4; ++r, sample_mask += sample_mask) {
            if (mbr & sample_mask) {
              if (cwd & 1) {
                new_sig |= sample_mask;
                u32 t = prop[r] << (j * 4);
                mbr |= t & inv_sig;
              }
              cwd >>= 1;
              ++cnt;
            }
          }
        }
        if (new_sig & (0xffffu << (4 * n))) {
          u32* dq = dec + (size_t)row * stride + i + n;
          u32 cm = 0xfu << (4 * n);
          for (i32 j = n; j < end; ++j, ++dq, cm <<= 4) {
            if ((cm & new_sig) == 0) continue;
            u32 sample_mask = 0x11111111u & cm;
            for (int r = 0; r < 4; ++r, sample_mask += sample_mask) {
              if (new_sig & sample_mask) {
                dq[(size_t)r * stride] |= ((cwd & 1) << 31) | val;
                cwd >>= 1;
                ++cnt;
              }
            }
          }
        }
        sigprop.advance(cnt);
        if (n == 4) {
          u32 t = new_sig >> 28;
          t |= ((t & 0xe) >> 1) | ((t & 7) << 1);
          cur_mbr[1] |= t & ~cur_sig[1];
        }
      }
    }
    new_sig |= cur_sig[0];
    u32 ux = (new_sig & 0x88888888u) >> 3;
    u32 tx = ux | (ux << 4) | (ux >> 4);
    if (i > 0) nxt_mbr[-1] |= (ux << 28) & ~nxt_sig[-1];
    nxt_mbr[0] |= tx & ~nxt_sig[0];
    nxt_mbr[1] |= (ux >> 28) & ~nxt_sig[1];
  }
}

// MagRef over one stripe's samples made significant by the cleanup pass
static void ht_magref_stripe(u32* dpp, i32 stride, i32 width, u32* cur_sig,
                             u32 p, HtRev& magref) {
  const u32 half = shl32(1u, p - 2);
  for (i32 i = 0; i < width; i += 8) {
    u32 cwd = magref.fetch();
    u32 sig = *cur_sig++;
    u32 col_mask = 0xfu;
    u32* dp = dpp + i;
    if (sig) {
      for (int j = 0; j < 8; ++j, dp++) {
        if (sig & col_mask) {
          u32 sample_mask = 0x11111111u & col_mask;
          for (int k = 0; k < 4; ++k) {
            if (sig & sample_mask) {
              u32 sym = cwd & 1;
              dp[(size_t)k * stride] ^= shl32(1 - sym, p - 1);
              dp[(size_t)k * stride] |= half;
              cwd >>= 1;
            }
            sample_mask += sample_mask;
          }
        }
        col_mask <<= 4;
      }
    }
    magref.advance(popcount32(sig));
  }
}

// the membership of one stripe from its own significance: its samples'
// neighbours left, right, above and below within the stripe
static void ht_stripe_mbr(u32* sig, u32* mbr, i32 width) {
  u32 prev = 0;
  for (i32 i = 0; i < width; i += 8, mbr++, sig++) {
    mbr[0] = sig[0];
    mbr[0] |= prev >> 28;
    mbr[0] |= sig[0] << 4;
    mbr[0] |= sig[0] >> 4;
    mbr[0] |= sig[1] << 28;
    prev = sig[0];
    u32 t = mbr[0], z = mbr[0];
    z |= (t & 0x77777777u) << 1;
    z |= (t & 0xeeeeeeeeu) >> 1;
    mbr[0] = z & ~sig[0];
  }
}

// the next stripe's first row as the neighbour below this stripe's last
static void ht_mbr_from_next(u32* cur_sig, u32* cur_mbr, u32* nxt_sig,
                             i32 width, bool stripe_causal) {
  u32 prev = 0;
  for (i32 i = 0; i < width; i += 8, cur_mbr++, cur_sig++, nxt_sig++) {
    u32 t = nxt_sig[0];
    t |= prev >> 28;
    t |= nxt_sig[0] << 4;
    t |= nxt_sig[0] >> 4;
    t |= nxt_sig[1] << 28;
    prev = nxt_sig[0];
    if (!stripe_causal) cur_mbr[0] |= (t & 0x11111111u) << 3;
    cur_mbr[0] &= ~cur_sig[0];
  }
}

// opj_t1_ht_decode_cblk into t1.data (w x h, zeroed first): false where
// OpenJPEG's returns false. align4 is the address of the block's bytes
// modulo 4 (OpenJPEG reads a block of one chunk where the tile's data
// holds it, and copies a block of more into a buffer of its own).
static bool ht_decode_cblk(T1& t1, Cblk& cblk, i32 roishift, u32 cblksty,
                           u32 align4) {
  const bool stripe_causal = (cblksty & CB_VSC) != 0;
  if (roishift != 0) return false;  // "We do not support ROI ..."
  const u32 cw = (u32)(cblk.x1 - cblk.x0), chh = (u32)(cblk.y1 - cblk.y0);
  t1.w = cw;
  t1.h = chh;
  t1.data.assign((size_t)cw * chh, 0);
  if (cblk.Mb == 0) return true;
  const u32 zero_bplanes = (cblk.Mb + 1) - cblk.numbps;
  u32 cblk_len = 0;
  for (auto& ch : cblk.chunks) cblk_len += ch.len;
  std::vector<u8> joined;
  const u8* coded;
  if (cblk.chunks.size() > 1) {
    joined.resize(cblk_len);
    size_t o = 0;
    for (auto& ch : cblk.chunks) {
      if (ch.len) memcpy(joined.data() + o, ch.data, ch.len);
      o += ch.len;
    }
    coded = joined.data();
    align4 = 0;
  } else if (cblk.chunks.size() == 1) {
    coded = cblk.chunks[0].data;
  } else {
    return true;
  }
  u32 num_passes = cblk.numsegs > 0 ? cblk.segs[0].real_num_passes : 0;
  num_passes += cblk.numsegs > 1 ? cblk.segs[1].real_num_passes : 0;
  const u32 lengths1 = num_passes > 0 ? cblk.segs[0].len : 0;
  // a second segment that was never made reads as OpenJPEG's zeroed one
  const u32 lengths2 =
      num_passes > 1 && cblk.segs.size() > 1 ? cblk.segs[1].len : 0;
  const i32 width = (i32)cw, height = (i32)chh, stride = width;
  if (num_passes > 1 && lengths2 == 0) num_passes = 1;  // a warning
  if (num_passes > 3) return false;
  if (cblk.Mb > 30) return false;
  if (zero_bplanes > cblk.Mb) return false;
  if (zero_bplanes == cblk.Mb && num_passes > 1) num_passes = 1;  // warning
  const u32 p = cblk.numbps;
  const u32 zero_bplanes_p1 = zero_bplanes + 1;
  if (lengths1 < 2 || lengths1 > cblk_len || lengths1 + lengths2 > cblk_len)
    return false;
  const int lcup = (int)lengths1;
  const int scup = ((int)coded[lcup - 1] << 4) + (coded[lcup - 2] & 0xf);
  if (scup < 2 || scup > lcup || scup > 4079) return false;

  // sigma1, sigma2, mbr1, mbr2 (132 words each) and the line state
  std::vector<u32> flags(132 * 4 + 528 / 4, 0);
  u32* sigma1 = flags.data();
  u32* sigma2 = sigma1 + 132;
  u32* mbr1 = sigma2 + 132;
  u32* mbr2 = mbr1 + 132;
  u8* line_state = (u8*)(mbr2 + 132);
  u32* sip = sigma1;
  u32 sip_shift = 0;
  u32* decoded = (u32*)t1.data.data();

  HtMel mel;
  if (!mel.init(coded, lcup, scup, (align4 + (u32)(lcup - scup)) & 3))
    return false;
  HtRev vlc;
  vlc.init_vlc(coded, lcup, scup);
  HtFwd magsgn;
  magsgn.init(coded, lcup - scup, 0xff);
  HtFwd sigprop;
  if (num_passes > 1) sigprop.init(coded + lengths1, (int)lengths2, 0);
  HtRev magref;
  if (num_passes > 2) magref.init_mrp(coded, (int)lengths1, (int)lengths2);

  u32 qinf[2];
  u32 U_q[2];

  // the first row of quads
  u8* lsp = line_state;
  lsp[0] = 0;
  int run = mel.get_run();
  u32 vlc_val;
  u32 c_q = 0;
  u32* sp = decoded;
  for (i32 x = 0; x < width; x += 4) {
    vlc_val = vlc.fetch();
    qinf[0] = kVlcTbl0[(c_q << 7) | (vlc_val & 0x7f)];
    if (c_q == 0) {
      run -= 2;
      qinf[0] = (run == -1) ? qinf[0] : 0;
      if (run < 0) run = mel.get_run();
    }
    c_q = ((qinf[0] & 0x10) >> 4) | ((qinf[0] & 0xe0) >> 5);
    vlc_val = vlc.advance(qinf[0] & 0x7);
    *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xc0) >> 2)) << sip_shift;

    qinf[1] = 0;
    if (x + 2 < width) {
      qinf[1] = kVlcTbl0[(c_q << 7) | (vlc_val & 0x7f)];
      if (c_q == 0) {
        run -= 2;
        qinf[1] = (run == -1) ? qinf[1] : 0;
        if (run < 0) run = mel.get_run();
      }
      c_q = ((qinf[1] & 0x10) >> 4) | ((qinf[1] & 0xe0) >> 5);
      vlc_val = vlc.advance(qinf[1] & 0x7);
    }
    *sip |= (((qinf[1] & 0x30) | ((qinf[1] & 0xc0) << 2))) << (4 + sip_shift);
    sip += x & 0x7 ? 1 : 0;
    sip_shift ^= 0x10;

    u32 uvlc_mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
    if (uvlc_mode == 3) {
      run -= 2;
      uvlc_mode += (run == -1) ? 1 : 0;
      if (run < 0) run = mel.get_run();
    }
    u32 consumed = decode_uvlc(vlc_val, uvlc_mode, U_q, true);
    if (U_q[0] > zero_bplanes_p1 || U_q[1] > zero_bplanes_p1) return false;
    vlc_val = vlc.advance(consumed);

    u32 locs = 0xff;
    if (x + 4 > width) locs >>= (x + 4 - width) << 1;
    locs = height > 1 ? locs : (locs & 0x55);
    if ((((qinf[0] & 0xf0) >> 4) | (qinf[1] & 0xf0)) & ~locs) return false;

    ht_quad(magsgn, U_q[0], qinf[0], locs & 0xf, p, sp, stride, lsp, true);
    ht_quad(magsgn, U_q[1], qinf[1], locs >> 4, p, sp + 2, stride, lsp + 1,
            true);
    lsp += 2;
    sp += 4;
  }

  // the later rows of quads
  for (i32 y = 2; y < height;) {
    sip_shift ^= 0x2;
    sip_shift &= 0xffffffefu;
    sip = y & 0x4 ? sigma2 : sigma1;
    lsp = line_state;
    u8 ls0 = lsp[0];
    lsp[0] = 0;
    sp = decoded + (size_t)y * stride;
    c_q = 0;
    for (i32 x = 0; x < width; x += 4) {
      c_q |= (ls0 >> 7);
      c_q |= (lsp[1] >> 5) & 0x4;
      vlc_val = vlc.fetch();
      qinf[0] = kVlcTbl1[(c_q << 7) | (vlc_val & 0x7f)];
      if (c_q == 0) {
        run -= 2;
        qinf[0] = (run == -1) ? qinf[0] : 0;
        if (run < 0) run = mel.get_run();
      }
      c_q = ((qinf[0] & 0x40) >> 5) | ((qinf[0] & 0x80) >> 6);
      vlc_val = vlc.advance(qinf[0] & 0x7);
      *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xc0) >> 2)) << sip_shift;

      qinf[1] = 0;
      if (x + 2 < width) {
        c_q |= (lsp[1] >> 7);
        c_q |= (lsp[2] >> 5) & 0x4;
        qinf[1] = kVlcTbl1[(c_q << 7) | (vlc_val & 0x7f)];
        if (c_q == 0) {
          run -= 2;
          qinf[1] = (run == -1) ? qinf[1] : 0;
          if (run < 0) run = mel.get_run();
        }
        c_q = ((qinf[1] & 0x40) >> 5) | ((qinf[1] & 0x80) >> 6);
        vlc_val = vlc.advance(qinf[1] & 0x7);
      }
      *sip |= (((qinf[1] & 0x30) | ((qinf[1] & 0xc0) << 2))) << (4 + sip_shift);
      sip += x & 0x7 ? 1 : 0;
      sip_shift ^= 0x10;

      u32 uvlc_mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
      u32 consumed = decode_uvlc(vlc_val, uvlc_mode, U_q, false);
      vlc_val = vlc.advance(consumed);

      if ((qinf[0] & 0xf0) & ((qinf[0] & 0xf0) - 1)) {
        u32 E = (ls0 & 0x7fu);
        E = E > (lsp[1] & 0x7fu) ? E : (lsp[1] & 0x7fu);
        U_q[0] += E > 2 ? E - 2 : 0;
      }
      if ((qinf[1] & 0xf0) & ((qinf[1] & 0xf0) - 1)) {
        u32 E = (lsp[1] & 0x7fu);
        E = E > (lsp[2] & 0x7fu) ? E : (lsp[2] & 0x7fu);
        U_q[1] += E > 2 ? E - 2 : 0;
      }
      if (U_q[0] > zero_bplanes_p1 || U_q[1] > zero_bplanes_p1) return false;

      ls0 = lsp[2];
      lsp[1] = lsp[2] = 0;

      u32 locs = 0xff;
      if (x + 4 > width) locs >>= (x + 4 - width) << 1;
      locs = y + 2 <= height ? locs : (locs & 0x55);
      if ((((qinf[0] & 0xf0) >> 4) | (qinf[1] & 0xf0)) & ~locs) return false;

      ht_quad(magsgn, U_q[0], qinf[0], locs & 0xf, p, sp, stride, lsp,
              false);
      ht_quad(magsgn, U_q[1], qinf[1], locs >> 4, p, sp + 2, stride,
              lsp + 1, false);
      lsp += 2;
      sp += 4;
    }

    y += 2;
    if (num_passes > 1 && (y & 3) == 0) {
      if (num_passes > 2)
        ht_magref_stripe(decoded + (size_t)(y - 4) * stride, stride, width,
                         y & 0x4 ? sigma1 : sigma2, p, magref);
      if (y >= 4)
        ht_stripe_mbr(y & 0x4 ? sigma1 : sigma2, y & 0x4 ? mbr1 : mbr2, width);
      if (y >= 8) {
        u32* cur_sig = y & 0x4 ? sigma2 : sigma1;
        u32* cur_mbr = y & 0x4 ? mbr2 : mbr1;
        u32* nxt_sig = y & 0x4 ? sigma1 : sigma2;
        u32* nxt_mbr = y & 0x4 ? mbr1 : mbr2;
        ht_mbr_from_next(cur_sig, cur_mbr, nxt_sig, width, stripe_causal);
        ht_sigprop_stripe(decoded, stride, width, y - 8, cur_sig, cur_mbr,
                          nxt_sig, nxt_mbr, 0xffffffffu, 3u << (p - 2),
                          sigprop);
        memset(cur_sig, 0, ((((u32)width + 7u) >> 3) + 1u) << 2);
      }
    }
  }

  // the last stripes
  if (num_passes > 1) {
    if (num_passes > 2 && ((height & 3) == 1 || (height & 3) == 2))
      ht_magref_stripe(decoded + (size_t)(height & 0xfffffc) * stride, stride,
                       width, height & 0x4 ? sigma2 : sigma1, p, magref);
    if ((height & 3) == 1 || (height & 3) == 2)
      ht_stripe_mbr(height & 0x4 ? sigma2 : sigma1,
                    height & 0x4 ? mbr2 : mbr1, width);
    i32 st = height;
    st -= height > 6 ? (((height + 1) & 3) + 3) : height;
    for (i32 y = st; y < height; y += 4) {
      u32 pattern = 0xffffffffu;
      if (height - y == 3) pattern = 0x77777777u;
      else if (height - y == 2) pattern = 0x33333333u;
      else if (height - y == 1) pattern = 0x11111111u;
      u32* cur_sig = y & 0x4 ? sigma2 : sigma1;
      u32* cur_mbr = y & 0x4 ? mbr2 : mbr1;
      u32* nxt_sig = y & 0x4 ? sigma1 : sigma2;
      u32* nxt_mbr = y & 0x4 ? mbr1 : mbr2;
      if (height - y > 4)
        ht_mbr_from_next(cur_sig, cur_mbr, nxt_sig, width, stripe_causal);
      ht_sigprop_stripe(decoded, stride, width, y, cur_sig, cur_mbr, nxt_sig,
                        nxt_mbr, pattern, 3u << (p - 2), sigprop);
    }
  }

  for (i32 y = 0; y < height; ++y) {
    i32* row = t1.data.data() + (size_t)y * stride;
    for (i32 x = 0; x < width; ++x) {
      u32 w = (u32)row[x];
      i32 v = (i32)(w & 0x7fffffffu);
      row[x] = (w & 0x80000000u) ? -v : v;
    }
  }
  return true;
}

// -- the inverse wavelets --------------------------------------------------

// opj_idwt53_h/v on one line of len samples, low band first
static void idwt53(i32* a, i32 sn, i32 dn, int cas, std::vector<i32>& tmp) {
  const i32 len = sn + dn;
  if (cas == 0) {
    if (len <= 1) return;
    const i32* in_even = a;
    const i32* in_odd = a + sn;
    i32 s1n = in_even[0], d1n = in_odd[0];
    i32 s0n = s1n - ((d1n + 1) >> 1);
    i32 i, j;
    for (i = 0, j = 1; i < len - 3; i += 2, j++) {
      i32 d1c = d1n, s0c = s0n;
      s1n = in_even[j];
      d1n = in_odd[j];
      s0n = s1n - ((d1c + d1n + 2) >> 2);
      tmp[i] = s0c;
      tmp[i + 1] = (i32)((u32)d1c + (u32)(((i32)((u32)s0c + (u32)s0n)) >> 1));
    }
    tmp[i] = s0n;
    if (len & 1) {
      tmp[len - 1] = in_even[(len - 1) / 2] - ((d1n + 1) >> 1);
      tmp[len - 2] = d1n + ((s0n + tmp[len - 1]) >> 1);
    } else {
      tmp[len - 1] = d1n + s0n;
    }
  } else {
    if (len < 1) return;
    if (len == 1) {
      a[0] /= 2;
      return;
    }
    if (len == 2) {
      const i32* in_even = a + sn;
      const i32* in_odd = a;
      tmp[1] = in_odd[0] - ((in_even[0] + 1) >> 1);
      tmp[0] = in_even[0] + tmp[1];
    } else {
      const i32* in_even = a + sn;
      const i32* in_odd = a;
      i32 s1 = in_even[1];
      i32 dc = in_odd[0] - ((in_even[0] + s1 + 2) >> 2);
      tmp[0] = in_even[0] + dc;
      i32 i, j;
      for (i = 1, j = 1; i < len - 2 - !(len & 1); i += 2, j++) {
        i32 s2 = in_even[j + 1];
        i32 dn2 = in_odd[j] - ((s1 + s2 + 2) >> 2);
        tmp[i] = dc;
        tmp[i + 1] = (i32)((u32)s1 + (u32)(((i32)((u32)dn2 + (u32)dc)) >> 1));
        dc = dn2;
        s1 = s2;
      }
      tmp[i] = dc;
      if (!(len & 1)) {
        i32 dn2 = in_odd[len / 2 - 1] - ((s1 + 1) >> 1);
        tmp[len - 2] = s1 + ((dn2 + dc) >> 1);
        tmp[len - 1] = dn2;
      } else {
        tmp[len - 1] = s1 + dc;
      }
    }
  }
  memcpy(a, tmp.data(), (size_t)len * sizeof(i32));
}

static const float kAlpha = -1.586134342f, kBeta = -0.052980118f,
                   kGamma = 0.882911075f, kDelta = 0.443506852f,
                   kK = 1.230174105f, kTwoInvK = 1.625732422f;

static void step1(float* w, u32 n, float c) {
  for (u32 i = 0; i < n; ++i) w[2 * i] = w[2 * i] * c;
}
static void step2(float* l, float* w, u32 end, u32 m, float c) {
  u32 imax = end < m ? end : m;
  for (u32 i = 0; i < imax; ++i) {
    w[-1] = w[-1] + ((l[0] + w[0]) * c);
    l = w;
    w += 2;
  }
  if (m < end) {
    c += c;
    w[-1] = w[-1] + l[0] * c;
  }
}

// opj_v8dwt_decode on one interleaved line
static void idwt97(float* x, i32 sn, i32 dn, int cas) {
  int a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0;
    b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1;
    b = 0;
  }
  step1(x + a, (u32)sn, kK);
  step1(x + b, (u32)dn, kTwoInvK);
  u32 m1 = (u32)(sn < dn - a ? sn : dn - a);
  u32 m2 = (u32)(dn < sn - b ? dn : sn - b);
  step2(x + b, x + a + 1, (u32)sn, m1, -kDelta);
  step2(x + a, x + b + 1, (u32)dn, m2, -kGamma);
  step2(x + b, x + a + 1, (u32)sn, m1, -kBeta);
  step2(x + a, x + b + 1, (u32)dn, m2, -kAlpha);
}

static void dwt_decode(TileComp& tc, u32 numres, bool real) {
  if (numres <= 1) return;
  const Res& top = tc.res[tc.minimum_num_resolutions - 1];
  const size_t w = (size_t)(top.x1 - top.x0);
  u32 rw = (u32)(tc.res[0].x1 - tc.res[0].x0);
  u32 rh = (u32)(tc.res[0].y1 - tc.res[0].y0);
  size_t maxlen = 0;
  for (u32 r = 0; r < numres; ++r) {
    maxlen = std::max(maxlen, (size_t)(tc.res[r].x1 - tc.res[r].x0));
    maxlen = std::max(maxlen, (size_t)(tc.res[r].y1 - tc.res[r].y0));
  }
  std::vector<i32> tmp(maxlen + 1), line(maxlen + 1);
  std::vector<float> fl(maxlen + 2);
  i32* d = tc.data.data();
  for (u32 r = 1; r < numres; ++r) {
    const Res& res = tc.res[r];
    i32 hsn = (i32)rw, vsn = (i32)rh;
    rw = (u32)(res.x1 - res.x0);
    rh = (u32)(res.y1 - res.y0);
    i32 hdn = (i32)rw - hsn, hcas = res.x0 % 2;
    i32 vdn = (i32)rh - vsn, vcas = res.y0 % 2;
    for (u32 j = 0; j < rh; ++j) {
      i32* row = d + j * w;
      if (!real) {
        idwt53(row, hsn, hdn, hcas, tmp);
      } else {
        // interleave: low band to positions cas, cas+2, ..., high to the
        // others
        for (i32 i = 0; i < hsn; ++i) memcpy(&fl[hcas + 2 * i], &row[i], 4);
        for (i32 i = 0; i < hdn; ++i)
          memcpy(&fl[1 - hcas + 2 * i], &row[hsn + i], 4);
        idwt97(fl.data(), hsn, hdn, hcas);
        memcpy(row, fl.data(), (size_t)rw * 4);
      }
    }
    for (u32 i = 0; i < rw; ++i) {
      for (u32 j = 0; j < rh; ++j) line[j] = d[j * w + i];
      if (!real) {
        idwt53(line.data(), vsn, vdn, vcas, tmp);
        for (u32 j = 0; j < rh; ++j) d[j * w + i] = line[j];
      } else {
        for (i32 j = 0; j < vsn; ++j) memcpy(&fl[vcas + 2 * j], &line[j], 4);
        for (i32 j = 0; j < vdn; ++j)
          memcpy(&fl[1 - vcas + 2 * j], &line[vsn + j], 4);
        idwt97(fl.data(), vsn, vdn, vcas);
        for (u32 j = 0; j < rh; ++j) memcpy(&d[j * w + i], &fl[j], 4);
      }
    }
  }
}

// -- the decoder -----------------------------------------------------------

struct Decoder {
  Stream st;
  bool jp2 = false;
  // JP2 state (opj_jp2)
  u32 jp2_state = 0;
  bool has_jp2h = false, has_ihdr = false, ihdr_read = false;
  u32 ihdr_w = 0, ihdr_h = 0, ihdr_nc = 0, enumcs = 0;
  bool has_colr = false;
  bool has_pclr = false, has_cmap = false, has_cdef = false;
  u32 pclr_channels = 0;
  // codestream state (opj_j2k)
  u32 state = 0;
  Image img;
  u32 tx0 = 0, ty0 = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
  Tcp default_tcp;
  std::vector<Tcp> tcps;
  u32 current_tile = 0;
  bool can_decode = false, last_tile_part = false;
  u32 sot_length = 0;
  bool ppm = false;
  std::map<u32, std::vector<u8>> ppm_markers;
  std::vector<u8> ppm_buf;
  size_t ppm_pos = 0, ppm_len = 0;
  // the tile being decoded
  Tile tile;
  u32 tile_index = 0;

  Tcp& cur_tcp() {
    return state == S_TPH ? tcps[current_tile] : default_tcp;
  }

  // -- main header marker handlers ------------------------------------

  bool read_siz(const u8* p, u32 n) {
    if (n < 36) return false;
    if ((n - 36) % 3 != 0) return false;
    u32 nb_comp = (n - 36) / 3;
    img.x1 = rd32(p + 2);
    img.y1 = rd32(p + 6);
    img.x0 = rd32(p + 10);
    img.y0 = rd32(p + 14);
    tdx = rd32(p + 18);
    tdy = rd32(p + 22);
    tx0 = rd32(p + 26);
    ty0 = rd32(p + 30);
    u32 csiz = rd16(p + 34);
    if (csiz < 16385) img.numcomps = csiz;
    else return false;
    if (img.numcomps != nb_comp) return false;
    if (img.x0 >= img.x1 || img.y0 >= img.y1) return false;
    if (tdx == 0 || tdy == 0) return false;
    u32 ltx1 = (u64)tx0 + tdx > 0xffffffffu ? 0xffffffffu : tx0 + tdx;
    u32 lty1 = (u64)ty0 + tdy > 0xffffffffu ? 0xffffffffu : ty0 + tdy;
    if (tx0 > img.x0 || ty0 > img.y0 || ltx1 <= img.x0 || lty1 <= img.y0)
      return false;
    if (ihdr_w > 0 && ihdr_h > 0 &&
        (ihdr_w != img.x1 - img.x0 || ihdr_h != img.y1 - img.y0))
      return false;
    img.comps.assign(img.numcomps, ImageComp());
    const u8* q = p + 36;
    for (u32 i = 0; i < img.numcomps; ++i) {
      ImageComp& c = img.comps[i];
      u32 t = q[0];
      c.prec = (t & 0x7f) + 1;
      c.sgnd = t >> 7;
      c.dx = q[1];
      c.dy = q[2];
      q += 3;
      if (c.dx < 1 || c.dx > 255 || c.dy < 1 || c.dy > 255) return false;
      if (c.prec > 31) return false;
    }
    tw = uceildiv(img.x1 - tx0, tdx);
    th = uceildiv(img.y1 - ty0, tdy);
    if (tw == 0 || th == 0 || tw > 65535 / th) return false;
    default_tcp.tccps.assign(img.numcomps, Tccp());
    for (u32 i = 0; i < img.numcomps; ++i)
      if (!img.comps[i].sgnd)
        default_tcp.tccps[i].dc_level_shift = 1 << (img.comps[i].prec - 1);
    tcps.assign((size_t)tw * th, Tcp());  // tccps: at the main header end
    for (u32 i = 0; i < img.numcomps; ++i) {
      ImageComp& c = img.comps[i];
      c.x0 = uceildiv(img.x0, c.dx);
      c.y0 = uceildiv(img.y0, c.dy);
      c.w = uceildiv(img.x1, c.dx) - c.x0;
      c.h = uceildiv(img.y1, c.dy) - c.y0;
    }
    state = S_MH;
    return true;
  }

  bool read_spcod(u32 compno, const u8*& p, u32& n) {
    Tcp& tcp = cur_tcp();
    if (compno >= img.numcomps) return false;
    Tccp& tc = tcp.tccps[compno];
    if (n < 5) return false;
    tc.numresolutions = p[0] + 1u;
    if (tc.numresolutions > MAXRLVLS) return false;
    tc.cblkw = p[1] + 2u;
    tc.cblkh = p[2] + 2u;
    if (tc.cblkw > 10 || tc.cblkh > 10 || tc.cblkw + tc.cblkh > 12)
      return false;
    tc.cblksty = p[3];
    if (tc.cblksty & CB_HTMIXED) return false;
    tc.qmfbid = p[4];
    if (tc.qmfbid > 1) return false;
    p += 5;
    n -= 5;
    if (tc.csty & CSTY_PRT) {
      if (n < tc.numresolutions) return false;
      for (u32 i = 0; i < tc.numresolutions; ++i) {
        u32 t = p[i];
        if (i != 0 && ((t & 0xf) == 0 || (t >> 4) == 0)) return false;
        tc.prcw[i] = t & 0xf;
        tc.prch[i] = t >> 4;
      }
      p += tc.numresolutions;
      n -= tc.numresolutions;
    } else {
      for (u32 i = 0; i < tc.numresolutions; ++i) tc.prcw[i] = tc.prch[i] = 15;
    }
    return true;
  }

  void copy_component_params() {
    Tcp& tcp = cur_tcp();
    const Tccp& r = tcp.tccps[0];
    for (u32 i = 1; i < img.numcomps; ++i) {
      Tccp& c = tcp.tccps[i];
      c.numresolutions = r.numresolutions;
      c.cblkw = r.cblkw;
      c.cblkh = r.cblkh;
      c.cblksty = r.cblksty;
      c.qmfbid = r.qmfbid;
      memcpy(c.prcw, r.prcw, sizeof r.prcw);
      memcpy(c.prch, r.prch, sizeof r.prch);
    }
  }

  bool read_cod(const u8* p, u32 n) {
    Tcp& tcp = cur_tcp();
    tcp.cod = true;
    if (n < 5) return false;
    tcp.csty = p[0];
    if (tcp.csty & ~(u32)(CSTY_PRT | CSTY_SOP | CSTY_EPH)) return false;
    tcp.prg = p[1];
    if (tcp.prg > CPRL) tcp.prg = PROG_UNKNOWN;
    tcp.numlayers = rd16(p + 2);
    if (tcp.numlayers < 1) return false;
    tcp.mct = p[4];
    if (tcp.mct > 1) return false;
    p += 5;
    n -= 5;
    for (u32 i = 0; i < img.numcomps; ++i) tcp.tccps[i].csty = tcp.csty & CSTY_PRT;
    if (!read_spcod(0, p, n)) return false;
    if (n != 0) return false;
    copy_component_params();
    return true;
  }

  bool read_coc(const u8* p, u32 n) {
    Tcp& tcp = cur_tcp();
    u32 room = img.numcomps <= 256 ? 1 : 2;
    if (n < room + 1) return false;
    n -= room + 1;
    u32 compno = rdn(p, (int)room);
    p += room;
    if (compno >= img.numcomps) return false;
    tcp.tccps[compno].csty = *p++;
    if (!read_spcod(compno, p, n)) return false;
    if (n != 0) return false;
    return true;
  }

  bool read_sqcd(u32 compno, const u8*& p, u32& n) {
    Tcp& tcp = cur_tcp();
    if (compno >= img.numcomps) return false;
    Tccp& tc = tcp.tccps[compno];
    if (n < 1) return false;
    n -= 1;
    u32 t = *p++;
    tc.qntsty = t & 0x1f;
    tc.numgbits = t >> 5;
    u32 num_band;
    if (tc.qntsty == 1) num_band = 1;
    else num_band = tc.qntsty == 0 ? n : n / 2;
    if (tc.qntsty == 0) {
      if (n < num_band) return false;
      for (u32 b = 0; b < num_band; ++b) {
        u32 v = p[b];
        if (b < MAXBANDS) {
          tc.stepsizes[b].expn = (i32)(v >> 3);
          tc.stepsizes[b].mant = 0;
        }
      }
      p += num_band;
      n -= num_band;
    } else {
      if (n < 2 * num_band) return false;
      for (u32 b = 0; b < num_band; ++b) {
        u32 v = rd16(p + 2 * b);
        if (b < MAXBANDS) {
          tc.stepsizes[b].expn = (i32)(v >> 11);
          tc.stepsizes[b].mant = (i32)(v & 0x7ff);
        }
      }
      p += 2 * num_band;
      n -= 2 * num_band;
    }
    if (tc.qntsty == 1) {
      for (u32 b = 1; b < MAXBANDS; ++b) {
        i32 e = tc.stepsizes[0].expn - (i32)((b - 1) / 3);
        tc.stepsizes[b].expn = e > 0 ? e : 0;
        tc.stepsizes[b].mant = tc.stepsizes[0].mant;
      }
    }
    return true;
  }

  bool read_qcd(const u8* p, u32 n) {
    if (!read_sqcd(0, p, n)) return false;
    if (n != 0) return false;
    Tcp& tcp = cur_tcp();
    const Tccp& r = tcp.tccps[0];
    for (u32 i = 1; i < img.numcomps; ++i) {
      Tccp& c = tcp.tccps[i];
      c.qntsty = r.qntsty;
      c.numgbits = r.numgbits;
      memcpy(c.stepsizes, r.stepsizes, sizeof r.stepsizes);
    }
    return true;
  }

  bool read_qcc(const u8* p, u32 n) {
    u32 compno;
    if (img.numcomps <= 256) {
      if (n < 1) return false;
      compno = *p++;
      n -= 1;
    } else {
      if (n < 2) return false;
      compno = rd16(p);
      p += 2;
      n -= 2;
    }
    if (compno >= img.numcomps) return false;
    if (!read_sqcd(compno, p, n)) return false;
    return n == 0;
  }

  bool read_rgn(const u8* p, u32 n) {
    u32 room = img.numcomps <= 256 ? 1 : 2;
    if (n != 2 + room) return false;
    Tcp& tcp = cur_tcp();
    u32 compno = rdn(p, (int)room);
    p += room;
    p++;  // Srgn, not checked
    if (compno >= img.numcomps) return false;
    tcp.tccps[compno].roishift = *p;
    return true;
  }

  bool read_poc(const u8* p, u32 n) {
    u32 room = img.numcomps <= 256 ? 1 : 2;
    u32 chunk = 5 + 2 * room;
    u32 nb = n / chunk;
    if (nb == 0 || n % chunk != 0) return false;
    Tcp& tcp = cur_tcp();
    u32 old = tcp.poc ? tcp.numpocs + 1 : 0;
    nb += old;
    if (nb >= 32) return false;
    tcp.poc = true;
    for (u32 i = old; i < nb; ++i) {
      Poc& pc = tcp.pocs[i];
      pc.resno0 = *p++;
      pc.compno0 = rdn(p, (int)room);
      p += room;
      pc.layno1 = rd16(p);
      p += 2;
      pc.resno1 = *p++;
      pc.compno1 = rdn(p, (int)room);
      p += room;
      pc.prg = *p++;
      pc.compno1 = std::min(pc.compno1, img.numcomps);
    }
    tcp.numpocs = nb - 1;
    return true;
  }

  bool read_tlm(const u8* p, u32 n) {
    if (n < 2) return false;
    n -= 2;
    u32 stlm = p[1];
    u32 st = (stlm >> 4) & 3;
    if (st == 3) return false;
    u32 sp = (stlm >> 6) & 1;
    u32 q = (sp + 1) * 2 + st;
    return n % q == 0;
  }

  bool read_plt(const u8* p, u32 n) {
    if (n < 1) return false;
    p++;
    n--;
    u32 len = 0;
    for (u32 i = 0; i < n; ++i) {
      u32 t = p[i];
      len |= t & 0x7f;
      if (t & 0x80) len <<= 7;
      else len = 0;
    }
    return len == 0;
  }

  bool read_crg(const u8*, u32 n) { return n == img.numcomps * 4; }

  bool read_ppm(const u8* p, u32 n) {
    if (n < 2) return false;
    ppm = true;
    u32 z = p[0];
    if (ppm_markers.count(z)) return false;
    ppm_markers[z].assign(p + 1, p + n);
    return true;
  }

  bool merge_ppm() {
    if (!ppm) return true;
    u64 total = 0, remaining = 0;
    std::vector<std::pair<const u8*, u32>> pieces;
    for (auto& kv : ppm_markers) {
      const u8* d = kv.second.data();
      u32 size = (u32)kv.second.size();
      if (remaining >= size) {
        remaining -= size;
        pieces.push_back({d, size});
        size = 0;
      } else {
        pieces.push_back({d, (u32)remaining});
        d += remaining;
        size -= (u32)remaining;
        remaining = 0;
      }
      while (size > 0) {
        if (size < 4) return false;
        u32 nppm = rd32(d);
        d += 4;
        size -= 4;
        if (total > 0xffffffffu - nppm) return false;
        total += nppm;
        if (size >= nppm) {
          pieces.push_back({d, nppm});
          size -= nppm;
          d += nppm;
        } else {
          pieces.push_back({d, size});
          remaining = nppm - size;
          size = 0;
        }
      }
    }
    if (remaining != 0) return false;
    ppm_buf.clear();
    for (auto& pc : pieces) ppm_buf.insert(ppm_buf.end(), pc.first, pc.first + pc.second);
    ppm_pos = 0;
    ppm_len = ppm_buf.size();
    return true;
  }

  bool read_ppt(const u8* p, u32 n) {
    if (n < 2) return false;
    if (ppm) return false;
    Tcp& tcp = tcps[current_tile];
    tcp.ppt = true;
    u32 z = p[0];
    if (tcp.ppt_markers.count(z)) return false;
    tcp.ppt_markers[z].assign(p + 1, p + n);
    return true;
  }

  bool merge_ppt(Tcp& tcp) {
    if (!tcp.ppt) return true;
    if (!tcp.ppt_buf.empty() || tcp.ppt_len) return true;
    for (auto& kv : tcp.ppt_markers)
      tcp.ppt_buf.insert(tcp.ppt_buf.end(), kv.second.begin(), kv.second.end());
    tcp.ppt_markers.clear();
    tcp.ppt_pos = 0;
    tcp.ppt_len = tcp.ppt_buf.size();
    return true;
  }

  bool read_sot(const u8* p, u32 n) {
    if (n != 8) return false;
    current_tile = rd16(p);
    u32 tot_len = rd32(p + 2);
    u32 current_part = p[6];
    u32 num_parts = p[7];
    if (current_tile >= tw * th) return false;
    Tcp& tcp = tcps[current_tile];
    if (tcp.current_tile_part + 1 != (i32)current_part) return false;
    ++tcp.current_tile_part;
    if (tot_len != 0 && tot_len < 14 && tot_len != 12) return false;
    if (!tot_len) last_tile_part = true;
    if (tcp.nb_tile_parts != 0 && current_part >= tcp.nb_tile_parts) {
      last_tile_part = true;
      return false;
    }
    if (num_parts != 0) {
      if (tcp.nb_tile_parts && current_part >= tcp.nb_tile_parts) {
        last_tile_part = true;
        return false;
      }
      if (current_part >= num_parts) {
        last_tile_part = true;
        return false;
      }
      tcp.nb_tile_parts = num_parts;
    }
    if (tcp.nb_tile_parts && tcp.nb_tile_parts == current_part + 1)
      can_decode = true;
    sot_length = last_tile_part ? 0 : tot_len - 12;
    state = S_TPH;
    return true;
  }

  bool handle(u32 id, const u8* p, u32 n) {
    switch (id) {
      case M_SOT: return read_sot(p, n);
      case M_COD: return read_cod(p, n);
      case M_COC: return read_coc(p, n);
      case M_RGN: return read_rgn(p, n);
      case M_QCD: return read_qcd(p, n);
      case M_QCC: return read_qcc(p, n);
      case M_POC: return read_poc(p, n);
      case M_SIZ: return read_siz(p, n);
      case M_TLM: return read_tlm(p, n);
      case M_PLM: return n >= 1;
      case M_PLT: return read_plt(p, n);
      case M_PPM: return read_ppm(p, n);
      case M_PPT: return read_ppt(p, n);
      case M_CRG: return read_crg(p, n);
      case M_COM: case M_CAP: case M_CPF: return true;
      // Part 2's multiple component transforms: only what decides their
      // errors (a record of another index or stage is skipped)
      case M_MCT: return n >= 2 && (rd16(p) != 0 || n > 6);
      case M_MCC: return n >= 2 && (rd16(p) != 0 || n >= 7);
      case M_MCO: return n >= 1 && (p[0] > 1 || n == p[0] + 1u);
      case M_CBD:
        return n >= 2 && n - 2 == img.numcomps && rd16(p) == img.numcomps;
      default: return false;
    }
  }

  // opj_j2k_read_unk: skip two bytes at a time to a known marker
  bool read_unk(u32* out) {
    u8 hd[2];
    for (;;) {
      if (st.read(hd, 2) != 2) return false;
      u32 m = rd16(hd);
      if (m >= 0xff00) {
        u32 id;
        u32 states = marker_states(m, &id);
        if (!(state & states)) return false;
        if (id != M_UNK) {
          *out = id;
          return true;
        }
      }
    }
  }

  // opj_j2k_read_header_procedure
  bool read_main_header() {
    state = S_MHSOC;
    u8 hd[2];
    if (st.read(hd, 2) != 2 || rd16(hd) != M_SOC) return false;
    state = S_MHSIZ;
    if (st.read(hd, 2) != 2) return false;
    u32 m = rd16(hd);
    bool has_siz = false, has_cod = false, has_qcd = false;
    std::vector<u8> data;
    while (m != M_SOT) {
      if (m < 0xff00) return false;
      u32 id;
      u32 states = marker_states(m, &id);
      if (id == M_UNK) {
        if (!read_unk(&m)) return false;
        if (m == M_SOT) break;
        states = marker_states(m, &id);
      }
      if (id == M_SIZ) has_siz = true;
      if (id == M_COD) has_cod = true;
      if (id == M_QCD) has_qcd = true;
      if (!(state & states)) return false;
      if (st.read(hd, 2) != 2) return false;
      u32 size = rd16(hd);
      if (size < 2) return false;
      size -= 2;
      data.resize(size + 1);
      if (size && st.read(data.data(), size) != size) return false;
      if (!handle(id, data.data(), size)) return false;
      if (st.read(hd, 2) != 2) return false;
      m = rd16(hd);
    }
    if (!has_siz || !has_cod || !has_qcd) return false;
    if (!merge_ppm()) return false;
    state = S_TPHSOT;
    // opj_j2k_copy_default_tcp_and_create_tcd
    for (auto& t : tcps) {
      std::vector<Tccp> keep;
      t.csty = default_tcp.csty;
      t.prg = default_tcp.prg;
      t.numlayers = default_tcp.numlayers;
      t.mct = default_tcp.mct;
      t.poc = default_tcp.poc;
      t.numpocs = default_tcp.numpocs;
      memcpy(t.pocs, default_tcp.pocs, sizeof t.pocs);
      t.tccps = default_tcp.tccps;
      t.cod = false;
      t.ppt = false;
      t.current_tile_part = -1;
    }
    return true;
  }

  // -- tile headers (opj_j2k_read_tile_header) -------------------------

  // 1: a tile to decode (tile_index), 0: none left, -1: failure
  int read_tile_header() {
    u32 m = M_SOT;
    const u32 nb_tiles = tw * th;
    if (state == S_EOC) m = M_EOC;
    else if (state != S_TPHSOT) return -1;
    u8 hd[2];
    std::vector<u8> data;
    while (!can_decode && m != M_EOC) {
      while (m != M_SOD) {
        if (st.left() == 0) {
          state = S_NEOC;
          break;
        }
        if (st.read(hd, 2) != 2) return -1;
        u32 size = rd16(hd);
        if (size < 2) return -1;
        if (m == 0x8080 && st.left() == 0) {
          state = S_NEOC;
          break;
        }
        if ((state & S_TPH) && sot_length != 0) {
          if (sot_length < size + 2) return -1;
          sot_length -= size + 2;
        }
        size -= 2;
        u32 id;
        u32 states = marker_states(m, &id);
        if (!(state & states)) return -1;
        data.resize(size + 1);
        if (size && st.read(data.data(), size) != size) return -1;
        if (id == M_UNK) return -1;  // no handler
        if (!handle(id, data.data(), size)) return -1;
        if (st.read(hd, 2) != 2) return -1;
        m = rd16(hd);
      }
      if (st.left() == 0 && state == S_NEOC) break;
      if (!read_sod()) return -1;
      if (!can_decode) {
        if (st.read(hd, 2) != 2) {
          // SPOT6's last row of tiles: TPsot == TNsot == 0, no EOC
          if (current_tile + 1 == nb_tiles) {
            u32 t;
            for (t = 0; t < nb_tiles; ++t)
              if (tcps[t].current_tile_part == 0 && tcps[t].nb_tile_parts == 0)
                break;
            if (t < nb_tiles) {
              current_tile = t;
              m = M_EOC;
              state = S_EOC;
              break;
            }
          }
          return -1;
        }
        m = rd16(hd);
      }
    }
    if (m == M_EOC) {
      if (state != S_EOC) {
        current_tile = 0;
        state = S_EOC;
      }
    }
    if (!can_decode) {
      while (current_tile < nb_tiles && !tcps[current_tile].has_data)
        ++current_tile;
      if (current_tile == nb_tiles) return 0;
    }
    if (!merge_ppt(tcps[current_tile])) return -1;
    if (!init_tile(current_tile)) return -1;
    tile_index = current_tile;
    state |= S_DATA;
    return 1;
  }

  bool read_sod() {
    Tcp& tcp = tcps[current_tile];
    if (last_tile_part) {
      sot_length = (u32)(st.left() - 2);
    } else if (sot_length >= 2) {
      sot_length -= 2;
    }
    bool pb = sot_length == 0;
    if (!pb) {
      if ((i64)sot_length > st.left()) return false;  // strict mode
    }
    size_t got = 0;
    if (!pb) {
      size_t old = tcp.data.size();
      tcp.data.resize(old + sot_length);
      got = st.read(tcp.data.data() + old, sot_length);
      tcp.data.resize(old + sot_length);  // (strict: all of it was there)
      tcp.has_data = true;
    }
    state = got != sot_length ? S_NEOC : S_TPHSOT;
    return true;
  }

  // -- the tile's geometry (opj_tcd_init_tile) -----------------------------

  bool init_tile(u32 tileno) {
    const Tcp& tcp = tcps[tileno];
    u32 p = tileno % tw, q = tileno / tw;
    u32 ltx0 = tx0 + p * tdx;
    tile.x0 = (i32)std::max(ltx0, img.x0);
    u64 tx1 = (u64)ltx0 + tdx;
    tile.x1 = (i32)std::min<u64>(tx1 > 0xffffffffu ? 0xffffffffu : tx1, img.x1);
    if (tile.x0 < 0 || tile.x1 <= tile.x0) return false;
    u32 lty0 = ty0 + q * tdy;
    tile.y0 = (i32)std::max(lty0, img.y0);
    u64 ty1 = (u64)lty0 + tdy;
    tile.y1 = (i32)std::min<u64>(ty1 > 0xffffffffu ? 0xffffffffu : ty1, img.y1);
    if (tile.y0 < 0 || tile.y1 <= tile.y0) return false;
    if (tcp.tccps[0].numresolutions == 0) return false;
    tile.comps.assign(img.numcomps, TileComp());
    for (u32 c = 0; c < img.numcomps; ++c) {
      const Tccp& tccp = tcp.tccps[c];
      ImageComp& ic = img.comps[c];
      ic.resno_decoded = 0;
      TileComp& tc = tile.comps[c];
      tc.x0 = ceildiv(tile.x0, (i32)ic.dx);
      tc.y0 = ceildiv(tile.y0, (i32)ic.dy);
      tc.x1 = ceildiv(tile.x1, (i32)ic.dx);
      tc.y1 = ceildiv(tile.y1, (i32)ic.dy);
      tc.numresolutions = tccp.numresolutions;
      tc.minimum_num_resolutions = tccp.numresolutions;
      if (tc.numresolutions == 0) return false;
      u64 area = (u64)(tc.x1 - tc.x0) * (u64)(tc.y1 - tc.y0);
      if (area > ((u64)1 << 31)) return false;
      tc.res.assign(tc.numresolutions, Res());
      u32 level = tc.numresolutions;
      i32 tlcbgx = 0, tlcbgy = 0;
      u32 cbgw = 0, cbgh = 0;
      for (u32 r = 0; r < tc.numresolutions; ++r) {
        Res& rs = tc.res[r];
        --level;
        rs.x0 = ceildivpow2(tc.x0, (int)level);
        rs.y0 = ceildivpow2(tc.y0, (int)level);
        rs.x1 = ceildivpow2(tc.x1, (int)level);
        rs.y1 = ceildivpow2(tc.y1, (int)level);
        u32 pdx = tccp.prcw[r], pdy = tccp.prch[r];
        rs.pdx = pdx;
        rs.pdy = pdy;
        i32 tlprcx = floordivpow2(rs.x0, (int)pdx) << pdx;
        i32 tlprcy = floordivpow2(rs.y0, (int)pdy) << pdy;
        u64 brx = (u64)(u32)ceildivpow2(rs.x1, (int)pdx) << pdx;
        u64 bry = (u64)(u32)ceildivpow2(rs.y1, (int)pdy) << pdy;
        if (brx > 0x7fffffff || bry > 0x7fffffff) return false;
        i32 brprcx = (i32)brx, brprcy = (i32)bry;
        rs.pw = rs.x0 == rs.x1 ? 0 : (u32)((brprcx - tlprcx) >> pdx);
        rs.ph = rs.y0 == rs.y1 ? 0 : (u32)((brprcy - tlprcy) >> pdy);
        if (rs.pw != 0 && 0xffffffffu / rs.pw < rs.ph) return false;
        u32 nbprec = rs.pw * rs.ph;
        if (nbprec > (1u << 24)) return false;
        if (r == 0) {
          tlcbgx = tlprcx;
          tlcbgy = tlprcy;
          cbgw = pdx;
          cbgh = pdy;
          rs.numbands = 1;
        } else {
          tlcbgx = ceildivpow2(tlprcx, 1);
          tlcbgy = ceildivpow2(tlprcy, 1);
          cbgw = pdx - 1;
          cbgh = pdy - 1;
          rs.numbands = 3;
        }
        u32 cbw = std::min(tccp.cblkw, cbgw), cbh = std::min(tccp.cblkh, cbgh);
        for (u32 b = 0; b < rs.numbands; ++b) {
          Band& bd = rs.bands[b];
          if (r == 0) {
            bd.bandno = 0;
            bd.x0 = ceildivpow2(tc.x0, (int)level);
            bd.y0 = ceildivpow2(tc.y0, (int)level);
            bd.x1 = ceildivpow2(tc.x1, (int)level);
            bd.y1 = ceildivpow2(tc.y1, (int)level);
          } else {
            bd.bandno = b + 1;
            i64 x0b = bd.bandno & 1, y0b = bd.bandno >> 1;
            auto cdp = [](i64 a, int s) {
              return (i32)((a + ((i64)1 << s) - 1) >> s);
            };
            bd.x0 = cdp(tc.x0 - (x0b << level), (int)level + 1);
            bd.y0 = cdp(tc.y0 - (y0b << level), (int)level + 1);
            bd.x1 = cdp(tc.x1 - (x0b << level), (int)level + 1);
            bd.y1 = cdp(tc.y1 - (y0b << level), (int)level + 1);
          }
          const StepSize& ss =
              tccp.stepsizes[r == 0 ? 0 : 3 * (r - 1) + b + 1];
          i32 log2_gain = tccp.qmfbid == 0 ? 0
                          : bd.bandno == 0 ? 0 : bd.bandno == 3 ? 2 : 1;
          i32 rb = (i32)ic.prec + log2_gain;
          bd.stepsize = (float)((1.0 + ss.mant / 2048.0) *
                                pow(2.0, (i32)(rb - ss.expn)));
          bd.numbps = ss.expn + (i32)tccp.numgbits - 1;
          bd.precs.assign(nbprec, Prec());
          for (u32 pn = 0; pn < nbprec; ++pn) {
            Prec& pr = bd.precs[pn];
            i32 cbgxs = tlcbgx + (i32)(pn % rs.pw) * (1 << cbgw);
            i32 cbgys = tlcbgy + (i32)(pn / rs.pw) * (1 << cbgh);
            i32 cbgxe = cbgxs + (1 << cbgw), cbgye = cbgys + (1 << cbgh);
            pr.x0 = std::max(cbgxs, bd.x0);
            pr.y0 = std::max(cbgys, bd.y0);
            pr.x1 = std::min(cbgxe, bd.x1);
            pr.y1 = std::min(cbgye, bd.y1);
            i32 tlcbx = floordivpow2(pr.x0, (int)cbw) << cbw;
            i32 tlcby = floordivpow2(pr.y0, (int)cbh) << cbh;
            i32 brcbx = ceildivpow2(pr.x1, (int)cbw) << cbw;
            i32 brcby = ceildivpow2(pr.y1, (int)cbh) << cbh;
            pr.cw = (u32)((brcbx - tlcbx) >> cbw);
            pr.ch = (u32)((brcby - tlcby) >> cbh);
            if (pr.cw && 0xffffffffu / pr.cw < pr.ch) return false;
            u32 nbc = pr.cw * pr.ch;
            if (nbc > (1u << 24)) return false;
            pr.cblks.assign(nbc, Cblk());
            for (u32 cn = 0; cn < nbc; ++cn) {
              Cblk& cb = pr.cblks[cn];
              i32 cxs = tlcbx + (i32)(cn % pr.cw) * (1 << cbw);
              i32 cys = tlcby + (i32)(cn / pr.cw) * (1 << cbh);
              cb.x0 = std::max(cxs, pr.x0);
              cb.y0 = std::max(cys, pr.y0);
              cb.x1 = std::min(cxs + (1 << cbw), pr.x1);
              cb.y1 = std::min(cys + (1 << cbh), pr.y1);
            }
            pr.incl.build(pr.cw, pr.ch);
            pr.imsb.build(pr.cw, pr.ch);
          }
        }
      }
    }
    return true;
  }

  // opj_tcd_get_decoded_tile_size
  u64 decoded_size() const {
    u64 size = 0;
    for (u32 c = 0; c < img.numcomps; ++c) {
      u32 sc = (img.comps[c].prec + 7) >> 3;
      if (sc == 3) sc = 4;
      const TileComp& tc = tile.comps[c];
      const Res& r = tc.res[tc.minimum_num_resolutions - 1];
      u64 t = (u64)(r.x1 - r.x0) * (u64)(r.y1 - r.y0) * sc;
      size += t;
      if (size > 0xffffffffu) return 0xffffffffu;
    }
    return size;
  }


  // -- tier 2: the packet iterator (opj_pi) --------------------------------

  struct Packet {
    u32 layno, resno, compno, precno;
  };

  // the packets of one progression (one POC) in order, each (layer,
  // resolution, component, precinct) once across all (the shared include
  // array); an iterator error ends the list as opj_pi_next's false does
  void packets(const Tcp& tcp, int prg, u32 resno0, u32 resno1, u32 compno0,
               u32 compno1, u32 layno1, std::vector<u8>& include,
               std::vector<Packet>& out) {
    const u32 nc = img.numcomps;
    u32 max_res = 0, max_prec = 0;
    for (u32 c = 0; c < nc; ++c) {
      const TileComp& tc = tile.comps[c];
      max_res = std::max(max_res, tc.numresolutions);
      for (u32 r = 0; r < tc.numresolutions; ++r)
        max_prec = std::max(max_prec, tc.res[r].pw * tc.res[r].ph);
    }
    const u64 step_p = 1, step_c = max_prec * step_p, step_r = nc * step_c,
              step_l = max_res * step_r;
    const u64 include_size = (u64)(tcp.numlayers + 1) * step_l;
    if (include.size() != include_size) include.assign(include_size, 0);
    const u32 ptx0 = (u32)tile.x0, pty0 = (u32)tile.y0, ptx1 = (u32)tile.x1,
              pty1 = (u32)tile.y1;
    // false: the iterator's error
    auto emit = [&](u32 l, u32 r, u32 c, u32 p) -> int {
      u64 index = l * step_l + r * step_r + c * step_c + p * step_p;
      if (index >= include_size) return -1;
      if (!include[index]) {
        include[index] = 1;
        out.push_back({l, r, c, p});
      }
      return 0;
    };
    if (prg < 0 || prg > CPRL) return;
    if (compno0 >= nc || compno1 >= nc + 1) return;
    if (prg == LRCP || prg == RLCP) {
      if (prg == LRCP) {
        for (u32 l = 0; l < layno1; ++l)
          for (u32 r = resno0; r < resno1; ++r)
            for (u32 c = compno0; c < compno1; ++c) {
              const TileComp& tc = tile.comps[c];
              if (r >= tc.numresolutions) continue;
              u32 np = tc.res[r].pw * tc.res[r].ph;
              for (u32 p = 0; p < np; ++p)
                if (emit(l, r, c, p) < 0) return;
            }
      } else {
        for (u32 r = resno0; r < resno1; ++r)
          for (u32 l = 0; l < layno1; ++l)
            for (u32 c = compno0; c < compno1; ++c) {
              const TileComp& tc = tile.comps[c];
              if (r >= tc.numresolutions) continue;
              u32 np = tc.res[r].pw * tc.res[r].ph;
              for (u32 p = 0; p < np; ++p)
                if (emit(l, r, c, p) < 0) return;
            }
      }
      return;
    }
    auto mins = [&](u32 c0, u32 c1, u32* dxo, u32* dyo) {
      u32 dxm = 0, dym = 0;
      for (u32 c = c0; c < c1; ++c) {
        const TileComp& tc = tile.comps[c];
        const ImageComp& ic = img.comps[c];
        for (u32 r = 0; r < tc.numresolutions; ++r) {
          const Res& rs = tc.res[r];
          u32 sx = rs.pdx + tc.numresolutions - 1 - r;
          if (sx < 32 && ic.dx <= 0xffffffffu / (1u << sx)) {
            u32 d = ic.dx * (1u << sx);
            dxm = !dxm ? d : std::min(dxm, d);
          }
          u32 sy = rs.pdy + tc.numresolutions - 1 - r;
          if (sy < 32 && ic.dy <= 0xffffffffu / (1u << sy)) {
            u32 d = ic.dy * (1u << sy);
            dym = !dym ? d : std::min(dym, d);
          }
        }
      }
      *dxo = dxm;
      *dyo = dym;
    };
    // the body shared by RPCL, PCRL and CPRL at (x, y): 1 emitted or
    // skipped, -1 the iterator's error
    auto body = [&](u32 r, u32 c, u32 x, u32 y) -> int {
      const TileComp& tc = tile.comps[c];
      const ImageComp& ic = img.comps[c];
      if (r >= tc.numresolutions) return 0;
      const Res& rs = tc.res[r];
      u32 levelno = tc.numresolutions - 1 - r;
      if (levelno >= 32 || ((ic.dx << levelno) >> levelno) != ic.dx ||
          ((ic.dy << levelno) >> levelno) != ic.dy)
        return 0;
      if ((ic.dx << levelno) > 0x7fffffffu || (ic.dy << levelno) > 0x7fffffffu)
        return 0;
      u32 trx0 = uceildiv(ptx0, ic.dx << levelno);
      u32 try0 = uceildiv(pty0, ic.dy << levelno);
      u32 trx1 = uceildiv(ptx1, ic.dx << levelno);
      u32 try1 = uceildiv(pty1, ic.dy << levelno);
      u32 rpx = rs.pdx + levelno, rpy = rs.pdy + levelno;
      if (rpx >= 31 || ((ic.dx << rpx) >> rpx) != ic.dx || rpy >= 31 ||
          ((ic.dy << rpy) >> rpy) != ic.dy)
        return 0;
      if (!(((u64)y % ((u64)ic.dy << rpy) == 0) ||
            ((y == pty0) && (((u64)try0 << levelno) % ((u64)1 << rpy)))))
        return 0;
      if (!(((u64)x % ((u64)ic.dx << rpx) == 0) ||
            ((x == ptx0) && (((u64)trx0 << levelno) % ((u64)1 << rpx)))))
        return 0;
      if (rs.pw == 0 || rs.ph == 0) return 0;
      if (trx0 == trx1 || try0 == try1) return 0;
      u32 prci = (uceildiv(x, ic.dx << levelno) >> rs.pdx) - (trx0 >> rs.pdx);
      u32 prcj = (uceildiv(y, ic.dy << levelno) >> rs.pdy) - (try0 >> rs.pdy);
      u32 precno = prci + prcj * rs.pw;
      for (u32 l = 0; l < layno1; ++l)
        if (emit(l, r, c, precno) < 0) return -1;
      return 0;
    };
    if (prg == RPCL || prg == PCRL) {
      u32 dx, dy;
      mins(0, nc, &dx, &dy);
      if (dx == 0 || dy == 0) return;
      if (prg == RPCL) {
        for (u32 r = resno0; r < resno1; ++r)
          for (u32 y = pty0; y < pty1; y += dy - (y % dy))
            for (u32 x = ptx0; x < ptx1; x += dx - (x % dx))
              for (u32 c = compno0; c < compno1; ++c)
                if (body(r, c, x, y) < 0) return;
      } else {
        for (u32 y = pty0; y < pty1; y += dy - (y % dy))
          for (u32 x = ptx0; x < ptx1; x += dx - (x % dx))
            for (u32 c = compno0; c < compno1; ++c) {
              u32 rend = std::min(resno1, tile.comps[c].numresolutions);
              for (u32 r = resno0; r < rend; ++r)
                if (body(r, c, x, y) < 0) return;
            }
      }
      return;
    }
    for (u32 c = compno0; c < compno1; ++c) {  // CPRL
      u32 dx, dy;
      mins(c, c + 1, &dx, &dy);
      if (dx == 0 || dy == 0) return;
      for (u32 y = pty0; y < pty1; y += dy - (y % dy))
        for (u32 x = ptx0; x < ptx1; x += dx - (x % dx)) {
          u32 rend = std::min(resno1, tile.comps[c].numresolutions);
          for (u32 r = resno0; r < rend; ++r)
            if (body(r, c, x, y) < 0) return;
        }
    }
  }

  // -- tier 2: a packet (opj_t2_read_packet_header, _data) ------------------

  static bool init_seg(Cblk& cb, u32 index, u32 cblksty, bool first) {
    if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
    Seg& s = cb.segs[index];
    s = Seg();
    if (cblksty & CB_TERMALL) {
      s.maxpasses = 1;
    } else if (cblksty & CB_LAZY) {
      if (first) {
        s.maxpasses = 10;
      } else {
        u32 prev = cb.segs[index - 1].maxpasses;
        s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
      }
    } else {
      s.maxpasses = 109;
    }
    return true;
  }

  static u32 getnumpasses(Bio& bio) {
    u32 n;
    if (!bio.read(1)) return 1;
    if (!bio.read(1)) return 2;
    if ((n = bio.read(2)) != 3) return 3 + n;
    if ((n = bio.read(5)) != 31) return 6 + n;
    return 37 + bio.read(7);
  }

  bool decode_packet(const Tcp& tcp, const Packet& pk, const u8* src,
                     size_t max_length, size_t* data_read) {
    TileComp& tc = tile.comps[pk.compno];
    Res& rs = tc.res[pk.resno];
    const u32 cblksty = tcp.tccps[pk.compno].cblksty;
    if (pk.layno == 0) {
      for (u32 b = 0; b < rs.numbands; ++b) {
        Band& bd = rs.bands[b];
        if (bd.empty()) continue;
        if (pk.precno >= bd.precs.size()) return false;
        Prec& pr = bd.precs[pk.precno];
        pr.incl.reset();
        pr.imsb.reset();
        for (auto& cb : pr.cblks) {
          cb.numsegs = 0;
          cb.real_num_segs = 0;
        }
      }
    }
    for (u32 b = 0; b < rs.numbands; ++b)
      if (!rs.bands[b].empty() && pk.precno >= rs.bands[b].precs.size())
        return false;
    const u8* cur = src;
    if (tcp.csty & CSTY_SOP) {
      // SOP (a missing one is only a warning)
      if (max_length >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
    }
    const u8* hstart;
    size_t* hlen;
    size_t remaining;
    Tcp& mtcp = tcps[tile_index];
    if (ppm) {
      hstart = ppm_buf.data() + ppm_pos;
      hlen = &ppm_len;
    } else if (mtcp.ppt) {
      hstart = mtcp.ppt_buf.data() + mtcp.ppt_pos;
      hlen = &mtcp.ppt_len;
    } else {
      hstart = cur;
      remaining = (size_t)(src + max_length - cur);
      hlen = &remaining;
    }
    Bio bio(hstart, *hlen);
    const u8* hdata = hstart;
    bool present = bio.read(1);
    auto finish_header = [&]() {
      hdata += bio.numbytes();
      if (tcp.csty & CSTY_EPH) {  // EPH (a missing one is only a warning)
        size_t used = (size_t)(hdata - hstart);
        if (*hlen - used >= 2 && hdata[0] == 0xff && hdata[1] == 0x92)
          hdata += 2;
      }
      size_t hl = (size_t)(hdata - hstart);
      *hlen -= hl;
      if (ppm) ppm_pos += hl;
      else if (mtcp.ppt) mtcp.ppt_pos += hl;
      else cur += hl;
    };
    if (!present) {
      bio.inalign();
      finish_header();
      *data_read = (size_t)(cur - src);
      return true;
    }
    for (u32 b = 0; b < rs.numbands; ++b) {
      Band& bd = rs.bands[b];
      if (bd.empty()) continue;
      Prec& pr = bd.precs[pk.precno];
      u32 ncb = pr.cw * pr.ch;
      for (u32 cn = 0; cn < ncb; ++cn) {
        Cblk& cb = pr.cblks[cn];
        u32 included;
        if (!cb.numsegs) {
          included = tgt_decode(bio, pr.incl, cn, (i32)(pk.layno + 1));
        } else {
          included = bio.read(1);
        }
        if (!included) {
          cb.numnewpasses = 0;
          continue;
        }
        if (!cb.numsegs) {
          u32 i = 0;
          while (!tgt_decode(bio, pr.imsb, cn, (i32)i)) {
            ++i;
            if (i > 0x10000000) return false;  // a stream of zero bits
          }
          cb.Mb = (u32)bd.numbps;
          cb.numbps = (u32)bd.numbps + 1 - i;
          cb.numlenbits = 3;
        }
        cb.numnewpasses = getnumpasses(bio);
        u32 increment = 0;
        while (bio.read(1)) ++increment;
        cb.numlenbits += increment;
        u32 segno = 0;
        if (!cb.numsegs) {
          init_seg(cb, segno, cblksty, true);
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
            ++segno;
            init_seg(cb, segno, cblksty, false);
          }
        }
        i32 n = (i32)cb.numnewpasses;
        do {
          Seg& s = cb.segs[segno];
          // an HT block's first segment takes one pass (the cleanup), any
          // later one the rest, whatever its maxpasses
          if (cblksty & CB_HT)
            s.numnewpasses = segno == 0 ? 1 : (u32)n;
          else
            s.numnewpasses =
                (u32)std::min((i32)(s.maxpasses - s.numpasses), n);
          u32 bits = cb.numlenbits + floorlog2(s.numnewpasses);
          if (bits > 32) return false;
          s.newlen = bio.read(bits);
          n -= (i32)s.numnewpasses;
          if (n > 0) {
            ++segno;
            init_seg(cb, segno, cblksty, false);
          }
        } while (n > 0);
      }
    }
    if (!bio.inalign()) return false;
    finish_header();
    const u8* dsrc = cur;
    size_t dmax = max_length - (size_t)(cur - src);
    // opj_t2_read_packet_data
    const u8* dcur = dsrc;
    for (u32 b = 0; b < rs.numbands; ++b) {
      Band& bd = rs.bands[b];
      if (bd.empty()) continue;
      Prec& pr = bd.precs[pk.precno];
      for (auto& cb : pr.cblks) {
        if (!cb.numnewpasses) continue;
        size_t si;
        if (!cb.numsegs) {
          si = 0;
          ++cb.numsegs;
        } else {
          si = cb.numsegs - 1;
          if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
            ++si;
            ++cb.numsegs;
          }
        }
        do {
          Seg& s = cb.segs[si];
          if ((u64)(dcur - dsrc) + s.newlen > dmax) return false;  // strict
          cb.chunks.push_back({dcur, s.newlen});
          dcur += s.newlen;
          s.len += s.newlen;
          s.numpasses += s.numnewpasses;
          cb.numnewpasses -= s.numnewpasses;
          s.real_num_passes = s.numpasses;
          if (cb.numnewpasses > 0) {
            ++si;
            ++cb.numsegs;
          }
        } while (cb.numnewpasses > 0);
        cb.real_num_segs = cb.numsegs;
      }
    }
    *data_read = (size_t)(cur - src) + (size_t)(dcur - dsrc);
    return true;
  }

  bool t2_decode(const Tcp& tcp) {
    const u8* src = tcp.data.data();
    size_t max_len = tcp.data.size();
    std::vector<u8> include;
    const u32 npocs = tcp.poc ? tcp.numpocs + 1 : 1;
    u32 max_res = 0;
    for (auto& tc : tile.comps) max_res = std::max(max_res, tc.numresolutions);
    for (u32 pino = 0; pino < npocs; ++pino) {
      int prg;
      u32 r0, r1, c0, c1, l1;
      if (tcp.poc) {
        const Poc& pc = tcp.pocs[pino];
        prg = pc.prg;
        r0 = pc.resno0;
        r1 = pc.resno1;
        c0 = pc.compno0;
        c1 = pc.compno1;
        l1 = std::min(pc.layno1, tcp.numlayers);
      } else {
        prg = tcp.prg;
        r0 = 0;
        r1 = max_res;
        c0 = 0;
        c1 = img.numcomps;
        l1 = tcp.numlayers;
      }
      if (prg == PROG_UNKNOWN) return false;
      std::vector<Packet> list;
      packets(tcp, prg, r0, r1, c0, c1, l1, include, list);
      for (const Packet& pk : list) {
        size_t nread = 0;
        if (!decode_packet(tcp, pk, src, max_len, &nread)) return false;
        ImageComp& ic = img.comps[pk.compno];
        ic.resno_decoded = std::max(pk.resno, ic.resno_decoded);
        src += nread;
        max_len -= nread;
      }
    }
    return true;
  }

  // -- the tile's decode (opj_tcd_decode_tile) ------------------------------

  bool decode_tile() {
    Tcp& tcp = tcps[tile_index];
    if (!tcp.has_data) return false;
    for (u32 c = 0; c < img.numcomps; ++c) {
      TileComp& tc = tile.comps[c];
      const Res& top = tc.res[tc.minimum_num_resolutions - 1];
      tc.data.assign((size_t)(top.x1 - top.x0) * (size_t)(top.y1 - top.y0), 0);
    }
    if (!t2_decode(tcp)) return false;
    T1 t1;
    for (u32 c = 0; c < img.numcomps; ++c) {
      TileComp& tc = tile.comps[c];
      const Tccp& tccp = tcp.tccps[c];
      const Res& top = tc.res[tc.minimum_num_resolutions - 1];
      const size_t tile_w = (size_t)(top.x1 - top.x0);
      for (u32 r = 0; r < tc.minimum_num_resolutions; ++r) {
        Res& rs = tc.res[r];
        for (u32 b = 0; b < rs.numbands; ++b) {
          Band& bd = rs.bands[b];
          for (auto& pr : bd.precs) {
            for (auto& cb : pr.cblks) {
              if (tccp.cblksty & CB_HT) {
                // the address of a block's one chunk modulo 4, OpenJPEG's
                // tile data being malloc'd (16-aligned)
                u32 a4 = cb.chunks.size() == 1
                             ? (u32)(cb.chunks[0].data - tcp.data.data()) & 3
                             : 0;
                if (!ht_decode_cblk(t1, cb, tccp.roishift, tccp.cblksty, a4))
                  return false;
              } else if (!decode_cblk(t1, cb, bd.bandno, tccp.roishift,
                                      tccp.cblksty)) {
                return false;
              }
              i32 x = cb.x0 - bd.x0, y = cb.y0 - bd.y0;
              if (bd.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
              if (bd.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
              const u32 cw = t1.w, chh = t1.h;
              i32* dp = t1.data.data();
              if (tccp.roishift) {
                if (tccp.roishift >= 31) {
                  for (size_t i = 0; i < (size_t)cw * chh; ++i) dp[i] = 0;
                } else {
                  i32 thresh = 1 << tccp.roishift;
                  for (size_t i = 0; i < (size_t)cw * chh; ++i) {
                    i32 val = dp[i];
                    i32 mag = val < 0 ? -val : val;
                    if (mag >= thresh) {
                      mag >>= tccp.roishift;
                      dp[i] = val < 0 ? -mag : mag;
                    }
                  }
                }
              }
              i32* tp = tc.data.data() + (size_t)y * tile_w + x;
              if (tccp.qmfbid == 1) {
                for (u32 j = 0; j < chh; ++j)
                  for (u32 i = 0; i < cw; ++i)
                    tp[j * tile_w + i] = dp[j * cw + i] / 2;
              } else {
                const float stepsize = 0.5f * bd.stepsize;
                for (u32 j = 0; j < chh; ++j)
                  for (u32 i = 0; i < cw; ++i) {
                    float v = (float)dp[j * cw + i] * stepsize;
                    memcpy(&tp[j * tile_w + i], &v, 4);
                  }
              }
              cb.chunks.clear();
            }
          }
        }
      }
    }
    for (u32 c = 0; c < img.numcomps; ++c)
      dwt_decode(tile.comps[c], img.comps[c].resno_decoded + 1,
                 tcp.tccps[c].qmfbid != 1);
    // MCT
    if (tcp.mct) {
      TileComp& t0 = tile.comps[0];
      const Res& r0 = t0.res[t0.minimum_num_resolutions - 1];
      size_t samples = (size_t)(r0.x1 - r0.x0) * (size_t)(r0.y1 - r0.y0);
      if (img.numcomps >= 3) {
        const u32 mr = t0.minimum_num_resolutions;
        if (mr != tile.comps[1].minimum_num_resolutions ||
            mr != tile.comps[2].minimum_num_resolutions)
          return false;
        const Res& r1 = tile.comps[1].res[mr - 1];
        const Res& r2 = tile.comps[2].res[mr - 1];
        if (img.comps[0].resno_decoded != img.comps[1].resno_decoded ||
            img.comps[0].resno_decoded != img.comps[2].resno_decoded ||
            (size_t)(r1.x1 - r1.x0) * (size_t)(r1.y1 - r1.y0) != samples ||
            (size_t)(r2.x1 - r2.x0) * (size_t)(r2.y1 - r2.y0) != samples)
          return false;
        i32* c0 = tile.comps[0].data.data();
        i32* c1 = tile.comps[1].data.data();
        i32* c2 = tile.comps[2].data.data();
        if (tcp.tccps[0].qmfbid == 1) {
          for (size_t i = 0; i < samples; ++i) {
            i32 y = c0[i], u = c1[i], v = c2[i];
            i32 g = y - ((u + v) >> 2);
            i32 r = v + g, b = u + g;
            c0[i] = r;
            c1[i] = g;
            c2[i] = b;
          }
        } else {
          for (size_t i = 0; i < samples; ++i) {
            float y, u, v;
            memcpy(&y, &c0[i], 4);
            memcpy(&u, &c1[i], 4);
            memcpy(&v, &c2[i], 4);
            float r = y + (v * 1.402f);
            float g = y - (u * 0.34413f) - (v * 0.71414f);
            float b = y + (u * 1.772f);
            memcpy(&c0[i], &r, 4);
            memcpy(&c1[i], &g, 4);
            memcpy(&c2[i], &b, 4);
          }
        }
      }
    }
    // DC level shift and clamp
    for (u32 c = 0; c < img.numcomps; ++c) {
      TileComp& tc = tile.comps[c];
      const ImageComp& ic = img.comps[c];
      const Tccp& tccp = tcp.tccps[c];
      const Res& rr = tc.res[ic.resno_decoded];
      const Res& top = tc.res[tc.minimum_num_resolutions - 1];
      const u32 w = (u32)(rr.x1 - rr.x0), h = (u32)(rr.y1 - rr.y0);
      const size_t stride = (size_t)(top.x1 - top.x0);
      i32 lmin, lmax;
      if (ic.sgnd) {
        lmin = -(1 << (ic.prec - 1));
        lmax = (1 << (ic.prec - 1)) - 1;
      } else {
        lmin = 0;
        lmax = (i32)((1u << ic.prec) - 1);
      }
      for (u32 j = 0; j < h; ++j) {
        i32* row = tc.data.data() + j * stride;
        if (tccp.qmfbid == 1) {
          for (u32 i = 0; i < w; ++i) {
            i32 v = (i32)((u32)row[i] + (u32)tccp.dc_level_shift);
            row[i] = v < lmin ? lmin : v > lmax ? lmax : v;
          }
        } else {
          for (u32 i = 0; i < w; ++i) {
            float f;
            memcpy(&f, &row[i], 4);
            if (f > (float)2147483647) {
              row[i] = lmax;
            } else if (f < (float)(-2147483647 - 1)) {
              row[i] = lmin;
            } else if (std::isnan(f)) {
              row[i] = lmin;
            } else {
              i64 v = (i64)lrintf(f) + tccp.dc_level_shift;
              row[i] = (i32)(v < lmin ? lmin : v > lmax ? lmax : v);
            }
          }
        }
      }
    }
    return true;
  }

  // opj_tcd_update_tile_data
  bool copy_out(u8* dst, u64 size) {
    u64 need = decoded_size();
    if (need == 0xffffffffu || need > size) return false;
    for (u32 c = 0; c < img.numcomps; ++c) {
      const TileComp& tc = tile.comps[c];
      const ImageComp& ic = img.comps[c];
      const Res& rr = tc.res[ic.resno_decoded];
      const Res& top = tc.res[tc.minimum_num_resolutions - 1];
      const u32 w = (u32)(rr.x1 - rr.x0), h = (u32)(rr.y1 - rr.y0);
      const size_t stride = (size_t)(top.x1 - top.x0);
      u32 sc = (ic.prec + 7) >> 3;
      if (sc == 3) sc = 4;
      for (u32 j = 0; j < h; ++j) {
        const i32* row = tc.data.data() + j * stride;
        for (u32 i = 0; i < w; ++i) {
          i32 v = row[i];
          if (sc == 1) {
            *dst++ = (u8)v;
          } else if (sc == 2) {
            uint16_t s = (uint16_t)v;
            memcpy(dst, &s, 2);
            dst += 2;
          } else {
            memcpy(dst, &v, 4);
            dst += 4;
          }
        }
      }
    }
    return true;
  }

  // the rest of opj_j2k_decode_tile: the next marker read
  bool after_tile() {
    tcps[tile_index].data.clear();
    tcps[tile_index].data.shrink_to_fit();
    tcps[tile_index].has_data = false;
    can_decode = false;
    state &= ~S_DATA;
    if (st.left() == 0 && state == S_NEOC) return true;
    if (state != S_EOC) {
      u8 hd[2];
      if (st.read(hd, 2) != 2) return false;
      u32 m = rd16(hd);
      if (m == M_EOC) {
        current_tile = 0;
        state = S_EOC;
      } else if (m != M_SOT) {
        if (st.left() == 0) {
          state = S_NEOC;
          return true;
        }
        return false;
      }
    }
    return true;
  }

  // -- JP2 (opj_jp2) -----------------------------------------------------

  enum : u32 {
    B_JP = 0x6a502020, B_FTYP = 0x66747970, B_JP2H = 0x6a703268,
    B_IHDR = 0x69686472, B_COLR = 0x636f6c72, B_BPCC = 0x62706363,
    B_PCLR = 0x70636c72, B_CMAP = 0x636d6170, B_CDEF = 0x63646566,
    B_JP2C = 0x6a703263
  };
  enum : u32 { J_SIG = 1, J_FTYP = 2, J_HEADER = 4, J_CODESTREAM = 8,
               J_UNKNOWN = 0x7fffffff };

  static bool img_box(u32 t) {
    return t == B_IHDR || t == B_COLR || t == B_BPCC || t == B_PCLR ||
           t == B_CMAP || t == B_CDEF;
  }

  bool img_handler(u32 type, const u8* p, u32 n) {
    switch (type) {
      case B_IHDR: {
        if (ihdr_read) return true;  // a second ihdr is ignored
        if (n != 14) return false;
        ihdr_h = rd32(p);
        ihdr_w = rd32(p + 4);
        ihdr_nc = rd16(p + 8);
        if (ihdr_nc - 1u >= 16384u) return false;
        ihdr_read = true;
        has_ihdr = true;
        return true;
      }
      case B_COLR: {
        if (n < 3) return false;
        if (has_colr) return true;
        const u32 meth = p[0];
        if (meth == 1) {
          if (n < 7) return false;
          enumcs = rd32(p + 3);  // CIELab's parameters (14) fail nothing
          has_colr = true;
        } else if (meth == 2) {  // an ICC profile: enumcs stays 0
          has_colr = true;
        }
        return true;
      }
      case B_BPCC:
        return n == ihdr_nc;
      case B_PCLR: {
        if (has_pclr) return false;
        if (n < 3) return false;
        u32 ne = rd16(p), nch = p[2];
        if (ne == 0 || ne > 1024) return false;
        if (nch == 0) return false;
        if (n < 3 + nch) return false;
        u32 size[256];
        for (u32 i = 0; i < nch; ++i) size[i] = (p[3 + i] & 0x7f) + 1u;
        size_t off = 3 + nch;
        for (u32 j = 0; j < ne; ++j)
          for (u32 i = 0; i < nch; ++i) {
            u32 b = (size[i] + 7) >> 3;
            if (b > 4) b = 4;
            if ((i64)n < (i64)off + b) return false;
            off += b;
          }
        has_pclr = true;
        pclr_channels = nch;
        return true;
      }
      case B_CMAP: {
        if (!has_pclr) return false;
        if (has_cmap) return false;
        if (n < pclr_channels * 4) return false;
        has_cmap = true;
        return true;
      }
      case B_CDEF: {
        if (has_cdef) return false;
        if (n < 2) return false;
        u32 nd = rd16(p);
        if (nd == 0) return false;
        if (n < 2 + nd * 6) return false;
        has_cdef = true;
        return true;
      }
    }
    return true;
  }

  bool read_jp2h(const u8* p, u32 n) {
    if ((jp2_state & J_FTYP) != J_FTYP) return false;
    bool seen_ihdr = false;
    while (n > 0) {
      if (n < 8) return false;
      u32 len = rd32(p), type = rd32(p + 4), hl = 8;
      if (len == 1) {
        if (n < 16) return false;
        if (rd32(p + 8) != 0) return false;
        len = rd32(p + 12);
        hl = 16;
        if (len == 0) return false;
      } else if (len == 0) {
        return false;
      }
      if (len < hl) return false;
      if (len > n) return false;
      if (img_box(type)) {
        if (!img_handler(type, p + hl, len - hl)) return false;
      }
      if (type == B_IHDR) seen_ihdr = true;
      p += len;
      n -= len;
    }
    if (!seen_ihdr) return false;
    jp2_state |= J_HEADER;
    has_jp2h = true;
    return true;
  }

  // opj_jp2_read_boxhdr: false at the stream's end or on an error
  bool boxhdr(u32* len, u32* type, u32* nread) {
    u8 hd[8];
    size_t r = st.read(hd, 8);
    *nread = (u32)r;
    if (r != 8) return false;
    *len = rd32(hd);
    *type = rd32(hd + 4);
    if (*len == 0) {
      i64 left = st.left();
      if (left > (i64)(0xffffffffu - 8u)) return false;
      *len = (u32)left + 8u;
      return true;
    }
    if (*len == 1) {
      size_t r2 = st.read(hd, 8);
      if (r2 != 8) return false;
      *nread = 16;
      if (rd32(hd) != 0) return false;
      *len = rd32(hd + 4);
    }
    return true;
  }

  // opj_jp2_read_header_procedure
  bool jp2_boxes() {
    u32 len, type, nread;
    std::vector<u8> data;
    while (boxhdr(&len, &type, &nread)) {
      if (type == B_JP2C) {
        if (jp2_state & J_HEADER) {
          jp2_state |= J_CODESTREAM;
          return true;
        }
        return false;
      } else if (len == 0) {
        return false;
      } else if (len < nread) {
        return false;
      }
      u32 size = len - nread;
      bool top = type == B_JP || type == B_FTYP || type == B_JP2H;
      bool misplaced = img_box(type);
      if (top || misplaced) {
        if (!top) {
          if (!(jp2_state & J_HEADER)) {
            jp2_state |= J_UNKNOWN;
            if (!st.skip(size)) return false;
            continue;
          }
        }
        if ((i64)size > st.left()) return false;
        data.resize(size + 1);
        size_t r = size ? st.read(data.data(), size) : 0;
        if (size && r != size) return false;
        const u8* p = data.data();
        bool ok;
        if (type == B_JP) {
          ok = jp2_state == 0 && size == 4 && rd32(p) == 0x0d0a870a;
          if (ok) jp2_state |= J_SIG;
        } else if (type == B_FTYP) {
          ok = jp2_state == J_SIG && size >= 8 && ((size - 8) & 3) == 0;
          if (ok) jp2_state |= J_FTYP;
        } else if (type == B_JP2H) {
          ok = read_jp2h(p, size);
        } else {
          ok = img_handler(type, p, size);
        }
        if (!ok) return false;
      } else {
        if (!(jp2_state & J_SIG)) return false;
        if (!(jp2_state & J_FTYP)) return false;
        jp2_state |= J_UNKNOWN;
        if (!st.skip(size)) return (jp2_state & J_CODESTREAM) != 0;
      }
    }
    return true;
  }

  int color_space_of() const {
    if (!jp2) return 0;  // OPJ_CLRSPC_UNSPECIFIED
    switch (enumcs) {
      case 16: return 1;
      case 17: return 2;
      case 18: return 3;
      case 24: return 4;
      case 12: return 5;
      default: return -1;  // OPJ_CLRSPC_UNKNOWN
    }
  }

  bool read_header() {
    if (jp2) {
      if (!jp2_boxes()) return false;
      if (!has_jp2h || !has_ihdr) return false;
    }
    if (!read_main_header()) return false;
    img.color_space = color_space_of();
    return true;
  }
};

}  // namespace

extern "C" {

// Each entry point fails (returns 0) where OpenJPEG's call fails, an
// allocation that fails included.

void* j2k_create(const uint8_t* buf, size_t len, int jp2) {
  try {
    Decoder* d = new Decoder();
    d->st.buf = buf;
    d->st.len = len;
    d->st.pos = 0;
    d->jp2 = jp2 != 0;
    return d;
  } catch (...) {
    return nullptr;
  }
}

void j2k_destroy(void* h) { delete (Decoder*)h; }

// opj_read_header: 1, or 0 where it fails. info: numcomps,
// color space, x0, y0, x1, y1, then per component dx, dy, prec, sgnd
int j2k_read_header(void* h, int64_t* info, int maxinfo) try {
  Decoder* d = (Decoder*)h;
  if (!d || !d->read_header()) return 0;
  const Image& im = d->img;
  if (6 + 4 * (int64_t)im.numcomps > maxinfo) return 0;
  info[0] = im.numcomps;
  info[1] = im.color_space;
  info[2] = im.x0;
  info[3] = im.y0;
  info[4] = im.x1;
  info[5] = im.y1;
  for (u32 c = 0; c < im.numcomps; ++c) {
    info[6 + 4 * c] = im.comps[c].dx;
    info[7 + 4 * c] = im.comps[c].dy;
    info[8 + 4 * c] = im.comps[c].prec;
    info[9 + 4 * c] = im.comps[c].sgnd;
  }
  return 1;
} catch (...) {
  return 0;
}

// opj_read_tile_header: 1, or 0 where it fails. tinfo:
// should_continue, tile index, data size, x0, y0, x1, y1, component count
int j2k_read_tile_header(void* h, int64_t* tinfo) try {
  Decoder* d = (Decoder*)h;
  int r = d->read_tile_header();
  if (r < 0) return 0;
  tinfo[0] = r;
  if (r == 0) return 1;
  u64 size = d->decoded_size();
  if (size == 0xffffffffu) return 0;
  tinfo[1] = d->tile_index;
  tinfo[2] = (int64_t)size;
  tinfo[3] = d->tile.x0;
  tinfo[4] = d->tile.y0;
  tinfo[5] = d->tile.x1;
  tinfo[6] = d->tile.y1;
  tinfo[7] = d->img.numcomps;
  return 1;
} catch (...) {
  return 0;
}

// opj_decode_tile_data into out (size bytes): 1, or 0 where it fails
int j2k_decode_tile_data(void* h, uint32_t tile_index, uint8_t* out,
                         uint64_t size) try {
  Decoder* d = (Decoder*)h;
  if (!(d->state & S_DATA) || tile_index != d->current_tile) return 0;
  if (!d->decode_tile()) {
    d->state |= S_ERR;
    return 0;
  }
  if (!d->copy_out(out, size)) return 0;
  return d->after_tile() ? 1 : 0;
} catch (...) {
  return 0;
}

// opj_end_decompress: a JP2 reads the boxes after its codestream
int j2k_end_decompress(void* h) try {
  Decoder* d = (Decoder*)h;
  if (d->jp2) return d->jp2_boxes() ? 1 : 0;
  return 1;
} catch (...) {
  return 0;
}

}  // extern "C"
