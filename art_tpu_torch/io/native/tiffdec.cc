// TIFF strip codecs that the port's TIFF reader (io/tiff.py) needs and
// Python's standard library lacks, as libtiff 4.7.1 runs them for Pillow
// 12.1.0:
//
//   - ZSTD (compression 50000): the frame format of RFC 8878 as libtiff's
//     ZSTDDecode drives libzstd 1.5.7's ZSTD_decompressStream: raw, RLE and
//     compressed blocks; Huffman literals (FSE-coded or direct weights, one
//     or four streams, treeless repeats); FSE sequences (predefined, RLE,
//     compressed and repeat tables); repeat offsets; the window; the
//     content checksum (XXH64). The single-pass shortcut libzstd takes when
//     a whole frame of known size fits the strip, and the streaming path
//     that stops once the strip is full, are both followed, since they see
//     a damaged frame differently;
//   - CCITT (compressions 2, 3, 4 and 32771): tif_fax3.c's decoders,
//     modified Huffman with byte or word alignment (RLE, RLEW), Group 3 one-
//     and two-dimensional with its EOL search, and Group 4, with libtiff's
//     handling of a bad code word (the line ends and is padded white), of a
//     line of the wrong length and of the data ending early;
//   - ThunderScan (compression 32809): tif_thunder.c, 4-bit grey.
//
// Every codec works on one strip or tile and only on integers. C interface
// (ctypes, io/tiff.py):
//
//   int tiffdec_zstd(const uint8_t* in, size_t n, uint8_t* out, size_t occ,
//                    char* msg, int msg_len)
//   int tiffdec_fax(const uint8_t* in, size_t n, uint8_t* out, size_t occ,
//                   int width, int kind, int options, char* msg, int msg_len)
//   int tiffdec_thunder(const uint8_t* in, size_t n, uint8_t* out,
//                       size_t occ, int width, char* msg, int msg_len)
//
// Each returns 1 where libtiff's decode succeeds and 0 where it fails
// (TIFFReadEncodedStrip returns -1 and Pillow raises "decoder error -2");
// `out` then holds what libtiff had written before it failed.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Fail {
  std::string msg;
};
[[noreturn]] void fail(const std::string& m) { throw Fail{m}; }

void put_msg(const std::string& m, char* msg, int msg_len) {
  if (!msg || msg_len <= 0) return;
  size_t n = std::min(m.size(), (size_t)msg_len - 1);
  memcpy(msg, m.data(), n);
  msg[n] = 0;
}

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------- XXH64

const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
               P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
               P5 = 2870177450012600261ULL;

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
uint64_t xx_round(uint64_t acc, uint64_t in) {
  acc += in * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}
uint64_t xx_merge(uint64_t acc, uint64_t v) {
  acc ^= xx_round(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xx_round(v1, rd64(p));
      v2 = xx_round(v2, rd64(p + 8));
      v3 = xx_round(v3, rd64(p + 16));
      v4 = xx_round(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xx_merge(h, v1);
    h = xx_merge(h, v2);
    h = xx_merge(h, v3);
    h = xx_merge(h, v4);
  } else {
    h = P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h ^= xx_round(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)rd32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- ZSTD

const size_t BLOCK_MAX = 128 * 1024;

// a backward bit stream (FSE and Huffman): read from the end, the first
// bit read the most significant; bits before the start read as zeros
struct BackBits {
  const uint8_t* p;
  int64_t pos;  // bits left above the read point
  BackBits(const uint8_t* src, size_t n) : p(src) {
    if (n == 0) fail("corruption: empty bit stream");
    uint8_t last = src[n - 1];
    if (last == 0) fail("corruption: bit stream without its end mark");
    pos = (int64_t)n * 8 - (8 - highbit(last));
  }
  uint64_t read(int nb) {
    if (nb == 0) return 0;
    uint64_t v = 0;
    for (int i = 0; i < nb; i++) {
      int64_t b = pos - 1 - i;
      int bit = b >= 0 ? (p[b >> 3] >> (b & 7)) & 1 : 0;
      v = (v << 1) | (uint64_t)bit;
    }
    pos -= nb;
    return v;
  }
  uint64_t peek(int nb) const {
    uint64_t v = 0;
    for (int i = 0; i < nb; i++) {
      int64_t b = pos - 1 - i;
      int bit = b >= 0 ? (p[b >> 3] >> (b & 7)) & 1 : 0;
      v = (v << 1) | (uint64_t)bit;
    }
    return v;
  }
};

// a forward little-endian bit reader (FSE table descriptions)
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  FwdBits(const uint8_t* src, size_t len) : p(src), n(len) {}
  uint32_t peek(int nb) const {
    uint32_t v = 0;
    for (int i = 0; i < nb; i++) {
      size_t b = bit + i;
      int x = b / 8 < n ? (p[b / 8] >> (b & 7)) & 1 : 0;
      v |= (uint32_t)x << i;
    }
    return v;
  }
  void skip(int nb) { bit += nb; }
};

struct FseEntry {
  uint16_t sym;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

// FSE_readNCount: the normalized counts; returns the bytes read
size_t read_ncount(const uint8_t* src, size_t n, int max_sym, int max_log, std::vector<int>& norm,
                   int& log) {
  if (n == 0) fail("corruption: no FSE table description");
  FwdBits br(src, n);
  log = (int)(br.peek(4)) + 5;
  br.skip(4);
  if (log > 15) fail("corruption: FSE table log too large");
  if (log > max_log) fail("corruption: FSE table log above its limit");
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nbits = log + 1;
  int sym = 0;
  norm.assign(max_sym + 1, 0);
  bool prev0 = false;
  while (remaining > 1) {
    if (prev0) {
      int r;
      do {
        r = (int)br.peek(2);
        br.skip(2);
        sym += r;
      } while (r == 3);
      if (sym > max_sym) break;
    }
    int mx = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = br.peek(nbits - 1) & (threshold - 1);
    if ((int)low < mx) {
      count = (int)low;
      br.skip(nbits - 1);
    } else {
      count = (int)(br.peek(nbits) & (2 * threshold - 1));
      if (count >= threshold) count -= mx;
      br.skip(nbits);
    }
    count--;
    if (count >= 0)
      remaining -= count;
    else
      remaining += count;
    if (sym > max_sym) fail("corruption: FSE symbol above its limit");
    norm[sym++] = count;
    prev0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nbits = highbit(remaining) + 1;
      threshold = 1 << (nbits - 1);
    }
    if (sym > max_sym) break;
  }
  if (remaining != 1) fail("corruption: FSE counts do not sum");
  if (sym > max_sym + 1) fail("corruption: FSE symbol above its limit");
  size_t used = (br.bit + 7) / 8;
  if (used > n) fail("corruption: FSE table description cut short");
  norm.resize(sym);
  return used;
}

void build_fse(const std::vector<int>& norm, int log, FseTable& tab) {
  int size = 1 << log;
  tab.log = log;
  tab.t.assign(size, FseEntry{0, 0, 0});
  int high = size - 1;
  std::vector<int> next(norm.size());
  for (size_t s = 0; s < norm.size(); s++) {
    if (norm[s] == -1) {
      tab.t[high--].sym = (uint16_t)s;
      next[s] = 1;
    } else {
      next[s] = norm[s];
    }
  }
  int step = (size >> 1) + (size >> 3) + 3;
  int mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < norm.size(); s++) {
    for (int i = 0; i < norm[s]; i++) {
      tab.t[pos].sym = (uint16_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) fail("corruption: FSE spread");
  for (int i = 0; i < size; i++) {
    int s = tab.t[i].sym;
    int ns = next[s]++;
    int nb = log - highbit((uint32_t)ns);
    tab.t[i].nbits = (uint8_t)nb;
    tab.t[i].base = (uint16_t)((ns << nb) - size);
  }
}

// Huffman literals
struct Huff {
  int log = 0;
  std::vector<uint8_t> sym, nbits;  // indexed by the next `log` bits
};

size_t read_huff_table(const uint8_t* src, size_t n, Huff& h) {
  if (n == 0) fail("corruption: no Huffman tree description");
  uint8_t w[256 + 1];
  memset(w, 0, sizeof(w));
  int isize = src[0];
  int osize;
  if (isize >= 128) {
    osize = isize - 127;
    isize = (osize + 1) / 2;
    if ((size_t)isize + 1 > n) fail("corruption: Huffman weights cut short");
    if (osize >= 256) fail("corruption: too many Huffman weights");
    for (int i = 0; i < osize; i += 2) {
      w[i] = src[1 + i / 2] >> 4;
      w[i + 1] = src[1 + i / 2] & 15;
    }
  } else {
    if ((size_t)isize + 1 > n) fail("corruption: Huffman weights cut short");
    std::vector<int> norm;
    int log;
    size_t used = read_ncount(src + 1, isize, 255, 6, norm, log);
    FseTable t;
    build_fse(norm, log, t);
    BackBits bb(src + 1 + used, isize - used);
    int s1 = (int)bb.read(log), s2 = (int)bb.read(log);
    osize = 0;
    for (;;) {
      if (osize > 255 - 2) fail("corruption: too many Huffman weights");
      w[osize++] = (uint8_t)t.t[s1].sym;
      s1 = t.t[s1].base + (int)bb.read(t.t[s1].nbits);
      if (bb.pos < 0) {
        w[osize++] = (uint8_t)t.t[s2].sym;
        break;
      }
      if (osize > 255 - 2) fail("corruption: too many Huffman weights");
      w[osize++] = (uint8_t)t.t[s2].sym;
      s2 = t.t[s2].base + (int)bb.read(t.t[s2].nbits);
      if (bb.pos < 0) {
        w[osize++] = (uint8_t)t.t[s1].sym;
        break;
      }
    }
  }
  uint32_t rank[16] = {0};
  uint32_t total = 0;
  for (int i = 0; i < osize; i++) {
    if (w[i] > 12) fail("corruption: Huffman weight too large");
    rank[w[i]]++;
    total += (1u << w[i]) >> 1;
  }
  if (total == 0) fail("corruption: Huffman weights all zero");
  int log = highbit(total) + 1;
  if (log > 12) fail("corruption: Huffman table too deep");
  uint32_t rest = (1u << log) - total;
  uint32_t verif = 1u << highbit(rest);
  if (verif != rest) fail("corruption: Huffman weights do not close");
  int lastw = highbit(rest) + 1;
  w[osize] = (uint8_t)lastw;
  rank[lastw]++;
  if (rank[1] < 2 || (rank[1] & 1)) fail("corruption: Huffman tree");
  int nsym = osize + 1;
  h.log = log;
  h.sym.assign(1u << log, 0);
  h.nbits.assign(1u << log, 0);
  uint32_t start[16] = {0};
  uint32_t acc = 0;
  for (int wt = 1; wt <= log; wt++) {
    start[wt] = acc;
    acc += rank[wt] << (wt - 1);
  }
  for (int s = 0; s < nsym; s++) {
    int wt = w[s];
    if (!wt) continue;
    uint32_t len = (1u << wt) >> 1;
    for (uint32_t k = 0; k < len; k++) {
      h.sym[start[wt] + k] = (uint8_t)s;
      h.nbits[start[wt] + k] = (uint8_t)(log + 1 - wt);
    }
    start[wt] += len;
  }
  return (size_t)isize + 1;
}

void huff_stream(const Huff& h, const uint8_t* src, size_t n, uint8_t* out, size_t count) {
  BackBits bb(src, n);
  for (size_t i = 0; i < count; i++) {
    uint32_t k = (uint32_t)bb.peek(h.log);
    out[i] = h.sym[k];
    bb.pos -= h.nbits[k];
  }
  if (bb.pos != 0) fail("corruption: Huffman stream not consumed exactly");
}

const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,   10,   11,
                              12, 13, 14, 15, 16, 18, 20, 22, 24, 28,  32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                            2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Frame {
  // the entropy carried from block to block
  Huff huff;
  bool have_huff = false;
  FseTable ll, of, ml;
  bool have_fse = false;
  uint64_t rep[3] = {1, 4, 8};
  size_t block_max = BLOCK_MAX;
  std::vector<uint8_t> out;  // the frame's output so far
};

// one sequence table: mode 0 predefined, 1 RLE, 2 FSE, 3 repeat
size_t seq_table(int mode, const uint8_t* src, size_t n, int max_sym, int max_log,
                 const int* deflt, int dlen, int dlog, FseTable& tab, bool have) {
  std::vector<int> norm;
  switch (mode) {
    case 0:
      norm.assign(deflt, deflt + dlen);
      build_fse(norm, dlog, tab);
      return 0;
    case 1:
      if (n < 1) fail("corruption: sequences cut short");
      if (src[0] > max_sym) fail("corruption: RLE symbol above its limit");
      tab.log = 0;
      tab.t.assign(1, FseEntry{src[0], 0, 0});
      return 1;
    case 2: {
      int log;
      size_t used = read_ncount(src, n, max_sym, max_log, norm, log);
      build_fse(norm, log, tab);
      return used;
    }
    default:
      if (!have) fail("corruption: repeated table with none before");
      return 0;
  }
}

// one compressed block appended to f.out
void zstd_block(Frame& f, const uint8_t* src, size_t n) {
  if (n > f.block_max) fail("corruption: block larger than its maximum");
  if (n < 2) fail("corruption: compressed block too small");
  // literals section
  int ltype = src[0] & 3, sf = (src[0] >> 2) & 3;
  size_t lhsize, litsize, litcsize = 0;
  std::vector<uint8_t> lits;
  if (ltype <= 1) {
    if ((sf & 1) == 0) {
      lhsize = 1;
      litsize = src[0] >> 3;
    } else if (sf == 1) {
      if (n < 2) fail("corruption: literals header cut short");
      lhsize = 2;
      litsize = (src[0] | (src[1] << 8)) >> 4;
    } else {
      if (n < 3) fail("corruption: literals header cut short");
      lhsize = 3;
      litsize = (src[0] | (src[1] << 8) | ((size_t)src[2] << 16)) >> 4;
    }
    if (litsize > f.block_max) fail("corruption: literals larger than a block");
    if (ltype == 0) {
      if (lhsize + litsize > n) fail("corruption: raw literals cut short");
      lits.assign(src + lhsize, src + lhsize + litsize);
      litcsize = litsize;
    } else {
      if (lhsize + 1 > n) fail("corruption: RLE literals cut short");
      lits.assign(litsize, src[lhsize]);
      litcsize = 1;
    }
  } else {
    if (n < 5) fail("corruption: literals header cut short");
    bool single = sf == 0;
    uint64_t hdr = src[0] | (src[1] << 8) | ((uint64_t)src[2] << 16) | ((uint64_t)src[3] << 24) |
                   ((uint64_t)src[4] << 32);
    if (sf <= 1) {
      lhsize = 3;
      litsize = (hdr >> 4) & 0x3FF;
      litcsize = (hdr >> 14) & 0x3FF;
    } else if (sf == 2) {
      lhsize = 4;
      litsize = (hdr >> 4) & 0x3FFF;
      litcsize = (hdr >> 18) & 0x3FFF;
    } else {
      lhsize = 5;
      litsize = (hdr >> 4) & 0x3FFFF;
      litcsize = (hdr >> 22) & 0x3FFFF;
    }
    if (litsize > f.block_max) fail("corruption: literals larger than a block");
    if (!single && litsize < 6) fail("corruption: too few literals for four streams");
    if (litcsize + lhsize > n) fail("corruption: compressed literals cut short");
    const uint8_t* p = src + lhsize;
    size_t left = litcsize;
    if (ltype == 2) {
      size_t used = read_huff_table(p, left, f.huff);
      f.have_huff = true;
      p += used;
      left -= used;
    } else if (!f.have_huff) {
      fail("corruption: treeless literals with no table before");
    }
    lits.assign(litsize, 0);
    if (single) {
      huff_stream(f.huff, p, left, lits.data(), litsize);
    } else {
      if (left < 10) fail("corruption: four literal streams too small");
      size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8), s3 = p[4] | (p[5] << 8);
      if (s1 + s2 + s3 + 6 > left) fail("corruption: jump table");
      size_t s4 = left - 6 - s1 - s2 - s3;
      size_t seg = (litsize + 3) / 4;
      if (3 * seg > litsize) fail("corruption: literal streams");
      const uint8_t* q = p + 6;
      huff_stream(f.huff, q, s1, lits.data(), seg);
      huff_stream(f.huff, q + s1, s2, lits.data() + seg, seg);
      huff_stream(f.huff, q + s1 + s2, s3, lits.data() + 2 * seg, seg);
      huff_stream(f.huff, q + s1 + s2 + s3, s4, lits.data() + 3 * seg, litsize - 3 * seg);
    }
  }
  const uint8_t* ip = src + lhsize + litcsize;
  const uint8_t* iend = src + n;
  // sequences section
  if (ip >= iend) fail("corruption: no sequences section");
  size_t nseq = *ip++;
  if (nseq == 0) {
    if (ip != iend) fail("corruption: data after an empty sequences section");
  } else if (nseq < 128) {
  } else if (nseq < 255) {
    if (ip >= iend) fail("corruption: sequences header cut short");
    nseq = ((nseq - 128) << 8) + *ip++;
  } else {
    if (ip + 2 > iend) fail("corruption: sequences header cut short");
    nseq = ip[0] + (ip[1] << 8) + 0x7F00;
    ip += 2;
  }
  size_t block_start = f.out.size();
  size_t lit_pos = 0;
  if (nseq > 0) {
    if (ip >= iend) fail("corruption: sequences header cut short");
    int modes = *ip++;
    int llm = modes >> 6, ofm = (modes >> 4) & 3, mlm = (modes >> 2) & 3;
    ip += seq_table(llm, ip, iend - ip, 35, 9, LL_DEFAULT, 36, 6, f.ll, f.have_fse);
    ip += seq_table(ofm, ip, iend - ip, 31, 8, OF_DEFAULT, 29, 5, f.of, f.have_fse);
    ip += seq_table(mlm, ip, iend - ip, 52, 9, ML_DEFAULT, 53, 6, f.ml, f.have_fse);
    if (ip > iend) fail("corruption: sequence tables cut short");
    f.have_fse = true;
    BackBits bb(ip, iend - ip);
    uint32_t sll = (uint32_t)bb.read(f.ll.log);
    uint32_t sof = (uint32_t)bb.read(f.of.log);
    uint32_t sml = (uint32_t)bb.read(f.ml.log);
    for (size_t i = 0; i < nseq; i++) {
      int llc = f.ll.t[sll].sym, ofc = f.of.t[sof].sym, mlc = f.ml.t[sml].sym;
      if (ofc > 31) fail("corruption: offset code");
      uint64_t offset;
      uint64_t ofv = ((uint64_t)1 << ofc) + bb.read(ofc);
      uint64_t ml = ML_BASE[mlc] + bb.read(ML_BITS[mlc]);
      uint64_t ll = LL_BASE[llc] + bb.read(LL_BITS[llc]);
      if (ofc > 1) {
        offset = ofv - 3;
        f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = offset;
      } else {
        int ll0 = ll == 0;
        if (ofc == 0) {
          offset = f.rep[ll0];
          f.rep[1] = f.rep[!ll0];
          f.rep[0] = offset;
        } else {
          int idx = (int)(ofv - 2) + 1 + ll0;  // 1 + ll0 + the extra bit
          uint64_t temp = idx == 3 ? f.rep[0] - 1 : f.rep[idx];
          if (temp == 0) temp = (uint64_t)-1;
          if (idx != 1) f.rep[2] = f.rep[1];
          f.rep[1] = f.rep[0];
          f.rep[0] = offset = temp;
        }
      }
      if (i + 1 < nseq) {
        sll = f.ll.t[sll].base + (uint32_t)bb.read(f.ll.t[sll].nbits);
        sml = f.ml.t[sml].base + (uint32_t)bb.read(f.ml.t[sml].nbits);
        sof = f.of.t[sof].base + (uint32_t)bb.read(f.of.t[sof].nbits);
      }
      // execute
      if (f.out.size() - block_start + ll + ml > f.block_max)
        fail("corruption: block output above its maximum");
      if (lit_pos + ll > lits.size()) fail("corruption: literals overrun");
      f.out.insert(f.out.end(), lits.begin() + lit_pos, lits.begin() + lit_pos + ll);
      lit_pos += ll;
      if (offset > f.out.size()) fail("corruption: offset before the frame");
      size_t from = f.out.size() - offset;
      for (uint64_t k = 0; k < ml; k++) f.out.push_back(f.out[from + k]);
    }
    if (bb.pos != 0) fail("corruption: sequence stream not consumed exactly");
  }
  size_t rest = lits.size() - lit_pos;
  if (f.out.size() - block_start + rest > f.block_max)
    fail("corruption: block output above its maximum");
  f.out.insert(f.out.end(), lits.begin() + lit_pos, lits.end());
}

struct FrameHeader {
  size_t size;  // header bytes
  bool checksum;
  bool fcs_known;
  uint64_t fcs;
  uint64_t window;
};

FrameHeader frame_header(const uint8_t* in, size_t n) {
  if (n < 5) fail("truncated frame header");
  if (rd32(in) != 0xFD2FB528u) fail("unknown frame descriptor");
  int fhd = in[4];
  int fcs_flag = fhd >> 6;
  bool single = (fhd >> 5) & 1;
  if ((fhd >> 3) & 1) fail("reserved frame header bit set");
  FrameHeader h;
  h.checksum = (fhd >> 2) & 1;
  int did = fhd & 3;
  size_t did_size = did == 3 ? 4 : did;
  size_t fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1u << fcs_flag);
  h.size = 5 + (single ? 0 : 1) + did_size + fcs_size;
  if (n < h.size) fail("truncated frame header");
  size_t p = 5;
  uint64_t window = 0;
  if (!single) {
    int wd = in[p++];
    int exponent = wd >> 3, mantissa = wd & 7;
    int wlog = 10 + exponent;
    if (wlog > 31) fail("window too large");
    uint64_t base = (uint64_t)1 << wlog;
    window = base + (base / 8) * mantissa;
  }
  uint64_t dict = 0;
  for (size_t i = 0; i < did_size; i++) dict |= (uint64_t)in[p++] << (8 * i);
  if (dict != 0) fail("dictionary frame with no dictionary");
  uint64_t fcs = 0;
  for (size_t i = 0; i < fcs_size; i++) fcs |= (uint64_t)in[p++] << (8 * i);
  if (fcs_size == 2) fcs += 256;
  h.fcs_known = fcs_size > 0;
  h.fcs = fcs;
  h.window = single ? fcs : window;
  return h;
}

// ZSTD_findFrameCompressedSize: the frame's bytes where they are all
// present, else 0
size_t frame_extent(const uint8_t* in, size_t n, const FrameHeader& h) {
  size_t p = h.size;
  for (;;) {
    if (p + 3 > n) return 0;
    uint32_t bh = in[p] | (in[p + 1] << 8) | (in[p + 2] << 16);
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t bsize = bh >> 3;
    if (type == 3) return 0;
    size_t csize = type == 1 ? 1 : bsize;
    p += 3 + csize;
    if (p > n) return 0;
    if (last) break;
  }
  if (h.checksum) p += 4;
  return p <= n ? p : 0;
}

// libtiff's ZSTDDecode over one strip: ZSTD_decompressStream until the
// strip is full, the frame ends or the input is spent
bool zstd_strip(const uint8_t* in, size_t n, uint8_t* out, size_t occ, std::string& err) {
  size_t produced = 0;
  try {
    FrameHeader h = frame_header(in, n);
    Frame f;
    f.block_max = std::min<uint64_t>(std::max<uint64_t>(h.window, 1), BLOCK_MAX);
    size_t extent = 0;
    if (h.fcs_known && h.fcs <= occ) extent = frame_extent(in, n, h);
    bool single_pass = extent > 0;
    if (!single_pass && h.window > ((uint64_t)1 << 27) + 1) fail("window too large");
    size_t p = h.size;
    size_t flushed = 0;  // bytes of f.out copied to `out`
    for (;;) {
      if (!single_pass && flushed < f.out.size()) break;  // strip full
      if (p + 3 > n) break;                                // input spent
      uint32_t bh = in[p] | (in[p + 1] << 8) | (in[p + 2] << 16);
      int last = bh & 1, type = (bh >> 1) & 3;
      size_t bsize = bh >> 3;
      if (type == 3) fail("reserved block type");
      size_t csize = type == 1 ? 1 : bsize;
      if (p + 3 + csize > n) break;  // the block is not all there
      const uint8_t* b = in + p + 3;
      if (type == 0) {
        if (bsize > f.block_max) fail("raw block larger than its maximum");
        f.out.insert(f.out.end(), b, b + bsize);
      } else if (type == 1) {
        if (bsize > f.block_max) fail("RLE block larger than its maximum");
        f.out.insert(f.out.end(), bsize, b[0]);
      } else {
        zstd_block(f, b, csize);
      }
      p += 3 + csize;
      if (single_pass && f.out.size() > occ) fail("destination buffer too small");
      if (last && h.fcs_known && f.out.size() != h.fcs) fail("frame content size mismatch");
      if (!single_pass) {
        size_t c = std::min(occ - flushed, f.out.size() - flushed);
        memcpy(out + flushed, f.out.data() + flushed, c);
        flushed += c;
      }
      if (!last) continue;
      // the checksum, read once the last block is flushed
      if (h.checksum && (single_pass || flushed == f.out.size())) {
        if (p + 4 > n) {
          if (single_pass) fail("checksum cut short");
          break;
        }
        if ((uint32_t)xxh64(f.out.data(), f.out.size()) != rd32(in + p)) fail("checksum mismatch");
      }
      break;
    }
    if (single_pass) {
      flushed = std::min<size_t>(f.out.size(), occ);
      memcpy(out, f.out.data(), flushed);
    }
    produced = flushed;
  } catch (Fail& e) {
    err = "ZSTD_decompressStream: " + e.msg;
    return false;
  }
  if (produced < occ) {
    err = "Not enough data (short " + std::to_string(occ - produced) + " bytes)";
    return false;
  }
  return true;
}

// ---------------------------------------------------------------- CCITT

// codes as (bits, length, run); run -1 EOL
struct Code {
  uint16_t bits;
  uint8_t len;
  int16_t run;
};

const Code WHITE[] = {
    {0x35, 8, 0},     {0x7, 6, 1},      {0x7, 4, 2},      {0x8, 4, 3},      {0xB, 4, 4},
    {0xC, 4, 5},      {0xE, 4, 6},      {0xF, 4, 7},      {0x13, 5, 8},     {0x14, 5, 9},
    {0x7, 5, 10},     {0x8, 5, 11},     {0x8, 6, 12},     {0x3, 6, 13},     {0x34, 6, 14},
    {0x35, 6, 15},    {0x2A, 6, 16},    {0x2B, 6, 17},    {0x27, 7, 18},    {0xC, 7, 19},
    {0x8, 7, 20},     {0x17, 7, 21},    {0x3, 7, 22},     {0x4, 7, 23},     {0x28, 7, 24},
    {0x2B, 7, 25},    {0x13, 7, 26},    {0x24, 7, 27},    {0x18, 7, 28},    {0x2, 8, 29},
    {0x3, 8, 30},     {0x1A, 8, 31},    {0x1B, 8, 32},    {0x12, 8, 33},    {0x13, 8, 34},
    {0x14, 8, 35},    {0x15, 8, 36},    {0x16, 8, 37},    {0x17, 8, 38},    {0x28, 8, 39},
    {0x29, 8, 40},    {0x2A, 8, 41},    {0x2B, 8, 42},    {0x2C, 8, 43},    {0x2D, 8, 44},
    {0x4, 8, 45},     {0x5, 8, 46},     {0xA, 8, 47},     {0xB, 8, 48},     {0x52, 8, 49},
    {0x53, 8, 50},    {0x54, 8, 51},    {0x55, 8, 52},    {0x24, 8, 53},    {0x25, 8, 54},
    {0x58, 8, 55},    {0x59, 8, 56},    {0x5A, 8, 57},    {0x5B, 8, 58},    {0x4A, 8, 59},
    {0x4B, 8, 60},    {0x32, 8, 61},    {0x33, 8, 62},    {0x34, 8, 63},    {0x1B, 5, 64},
    {0x12, 5, 128},   {0x17, 6, 192},   {0x37, 7, 256},   {0x36, 8, 320},   {0x37, 8, 384},
    {0x64, 8, 448},   {0x65, 8, 512},   {0x68, 8, 576},   {0x67, 8, 640},   {0xCC, 9, 704},
    {0xCD, 9, 768},   {0xD2, 9, 832},   {0xD3, 9, 896},   {0xD4, 9, 960},   {0xD5, 9, 1024},
    {0xD6, 9, 1088},  {0xD7, 9, 1152},  {0xD8, 9, 1216},  {0xD9, 9, 1280},  {0xDA, 9, 1344},
    {0xDB, 9, 1408},  {0x98, 9, 1472},  {0x99, 9, 1536},  {0x9A, 9, 1600},  {0x18, 6, 1664},
    {0x9B, 9, 1728},
};

const Code BLACK[] = {
    {0x37, 10, 0},    {0x2, 3, 1},      {0x3, 2, 2},      {0x2, 2, 3},      {0x3, 3, 4},
    {0x3, 4, 5},      {0x2, 4, 6},      {0x3, 5, 7},      {0x5, 6, 8},      {0x4, 6, 9},
    {0x4, 7, 10},     {0x5, 7, 11},     {0x7, 7, 12},     {0x4, 8, 13},     {0x7, 8, 14},
    {0x18, 9, 15},    {0x17, 10, 16},   {0x18, 10, 17},   {0x8, 10, 18},    {0x67, 11, 19},
    {0x68, 11, 20},   {0x6C, 11, 21},   {0x37, 11, 22},   {0x28, 11, 23},   {0x17, 11, 24},
    {0x18, 11, 25},   {0xCA, 12, 26},   {0xCB, 12, 27},   {0xCC, 12, 28},   {0xCD, 12, 29},
    {0x68, 12, 30},   {0x69, 12, 31},   {0x6A, 12, 32},   {0x6B, 12, 33},   {0xD2, 12, 34},
    {0xD3, 12, 35},   {0xD4, 12, 36},   {0xD5, 12, 37},   {0xD6, 12, 38},   {0xD7, 12, 39},
    {0x6C, 12, 40},   {0x6D, 12, 41},   {0xDA, 12, 42},   {0xDB, 12, 43},   {0x54, 12, 44},
    {0x55, 12, 45},   {0x56, 12, 46},   {0x57, 12, 47},   {0x64, 12, 48},   {0x65, 12, 49},
    {0x52, 12, 50},   {0x53, 12, 51},   {0x24, 12, 52},   {0x37, 12, 53},   {0x38, 12, 54},
    {0x27, 12, 55},   {0x28, 12, 56},   {0x58, 12, 57},   {0x59, 12, 58},   {0x2B, 12, 59},
    {0x2C, 12, 60},   {0x5A, 12, 61},   {0x66, 12, 62},   {0x67, 12, 63},   {0xF, 10, 64},
    {0xC8, 12, 128},  {0xC9, 12, 192},  {0x5B, 12, 256},  {0x33, 12, 320},  {0x34, 12, 384},
    {0x35, 12, 448},  {0x6C, 13, 512},  {0x6D, 13, 576},  {0x4A, 13, 640},  {0x4B, 13, 704},
    {0x4C, 13, 768},  {0x4D, 13, 832},  {0x72, 13, 896},  {0x73, 13, 960},  {0x74, 13, 1024},
    {0x75, 13, 1088}, {0x76, 13, 1152}, {0x77, 13, 1216}, {0x52, 13, 1280}, {0x53, 13, 1344},
    {0x54, 13, 1408}, {0x55, 13, 1472}, {0x5A, 13, 1536}, {0x5B, 13, 1600}, {0x64, 13, 1664},
    {0x65, 13, 1728},
};

// the extended make-up codes, shared by both colours
const Code EXTRA[] = {
    {0x8, 11, 1792},  {0xC, 11, 1856},  {0xD, 11, 1920},  {0x12, 12, 1984}, {0x13, 12, 2048},
    {0x14, 12, 2112}, {0x15, 12, 2176}, {0x16, 12, 2240}, {0x17, 12, 2304}, {0x1C, 12, 2368},
    {0x1D, 12, 2432}, {0x1E, 12, 2496}, {0x1F, 12, 2560},
};

// a lookup of `width` bits (tif_fax3sm.c's tables): state, length, run
enum { S_Null = 0, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW,
       S_MakeUpB, S_MakeUp, S_EOL };

struct Ent {
  uint8_t state = S_Null, width = 0;
  int32_t param = 0;
};

struct Tables {
  std::vector<Ent> white, black, main;
  Tables() {
    white.resize(1 << 12);
    black.resize(1 << 13);
    main.resize(1 << 7);
    auto fill = [](std::vector<Ent>& t, int wbits, uint32_t code, int len, int state, int param) {
      int free = wbits - len;
      for (uint32_t k = 0; k < (1u << free); k++) {
        Ent& e = t[(code << free) | k];
        e.state = (uint8_t)state;
        e.width = (uint8_t)len;
        e.param = param;
      }
    };
    for (const Code& c : WHITE)
      fill(white, 12, c.bits, c.len, c.run < 64 ? S_TermW : S_MakeUpW, c.run);
    for (const Code& c : BLACK)
      fill(black, 13, c.bits, c.len, c.run < 64 ? S_TermB : S_MakeUpB, c.run);
    for (const Code& c : EXTRA) {
      fill(white, 12, c.bits, c.len, S_MakeUp, c.run);
      fill(black, 13, c.bits, c.len, S_MakeUp, c.run);
    }
    // mkg3states.c's EOLH: eleven zeros end the line (width 11: the EOL's
    // closing 1 is left for SYNC_EOL, or starts the next RLE line)
    fill(white, 12, 0, 11, S_EOL, 0);
    fill(black, 13, 0, 11, S_EOL, 0);
    // the 2D modes; the EOL's leading zeros and the extension
    fill(main, 7, 1, 1, S_V0, 0);
    fill(main, 7, 3, 3, S_VR, 1);
    fill(main, 7, 3, 6, S_VR, 2);
    fill(main, 7, 3, 7, S_VR, 3);
    fill(main, 7, 2, 3, S_VL, 1);
    fill(main, 7, 2, 6, S_VL, 2);
    fill(main, 7, 2, 7, S_VL, 3);
    fill(main, 7, 1, 3, S_Horiz, 0);
    fill(main, 7, 1, 4, S_Pass, 0);
    fill(main, 7, 1, 7, S_Ext, 0);
    fill(main, 7, 0, 7, S_EOL, 0);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// the modes of tif_fax3.c
enum { FAX_RLE = 0, FAX_G3 = 1, FAX_G4 = 2 };
const int MODE_NOEOL = 2, MODE_BYTEALIGN = 4, MODE_WORDALIGN = 8;

struct Fax {
  const uint8_t* cp;
  const uint8_t* ep;
  const uint8_t* start;
  uint32_t acc = 0;  // the next bits, the first in the most significant place
  int avail = 0;
  int lastx;
  int mode;
  int eolcnt = 0;
  int line = 0;
  std::vector<int32_t> runs;
  int nruns;
  int32_t *cur, *ref;
  int eof_count = 0;

  bool end_of_data() const { return cp >= ep; }
  // NeedBits: false at the end of the data with no bits left
  bool need(int n) {
    while (avail < n) {
      if (end_of_data()) {
        if (avail == 0) return false;
        avail = n;  // pad with zeros
        return true;
      }
      acc |= (uint32_t)(*cp++) << (24 - avail);
      avail += 8;
    }
    return true;
  }
  uint32_t get(int n) const { return acc >> (32 - n); }
  void clr(int n) {
    acc <<= n;
    avail -= n;
  }
};

struct Overflow {};

// one line of runs into packed bits (_TIFFFax3fillruns): runs alternate
// white and black from white; 1 bits are black
// (_TIFFFax3fillruns; a run past the line is cut to it, in the array too)
void fill_runs(uint8_t* buf, int32_t* runs, int32_t* erun, int lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0, lx = (uint32_t)lastx;
  for (; runs < erun; runs += 2) {
    uint32_t run = (uint32_t)runs[0];
    if (x + run > lx || run > lx) run = (uint32_t)(runs[0] = (int32_t)(lx - x));
    for (uint32_t i = x; i < x + run; i++) buf[i >> 3] &= (uint8_t)~(0x80 >> (i & 7));
    x += run;
    run = (uint32_t)runs[1];
    if (x + run > lx || run > lx) run = (uint32_t)(runs[1] = (int32_t)(lx - x));
    for (uint32_t i = x; i < x + run; i++) buf[i >> 3] |= (uint8_t)(0x80 >> (i & 7));
    x += run;
  }
}

// decode one strip; returns 1 or 0 as libtiff's decoder
int fax_strip(const uint8_t* in, size_t n, uint8_t* out, size_t occ, int width, int kind,
              int options, std::string& err) {
  const Tables& T = tables();
  Fax s;
  s.cp = in;
  s.start = in;
  s.ep = in + n;
  s.lastx = width;
  s.mode = 0;
  bool is2d = false;
  if (kind == FAX_RLE) {
    s.mode = MODE_NOEOL | ((options & 1) ? MODE_WORDALIGN : MODE_BYTEALIGN);
  } else if (kind == FAX_G3) {
    is2d = options & 1;
  } else {
    is2d = true;
  }
  bool needs_ref = kind == FAX_G4 || is2d;
  int odd_offset = (options >> 1) & 1;  // the strip starts at an odd offset
  int nruns = ((width + 1 + 31) / 32) * 32;
  if (needs_ref) nruns *= 2;
  s.nruns = nruns;
  s.runs.assign((size_t)nruns * 2 + 4, 0);  // fill_runs may pad a run
  s.cur = s.runs.data();
  s.ref = needs_ref ? s.runs.data() + nruns : nullptr;
  if (s.ref) {
    s.ref[0] = width;
    s.ref[1] = 0;
  }
  int rowbytes = (width + 7) / 8;
  if (rowbytes == 0 || occ % rowbytes) {
    err = "Fractional scanlines cannot be read";
    return 0;
  }
  memset(out, 0, occ);
  uint8_t* buf = out;
  long left = (long)occ;
  int32_t a0 = 0, run_length = 0;
  int32_t* pa = nullptr;
  int32_t* thisrun = nullptr;
  int32_t* pb = nullptr;
  int32_t b1 = 0;
  const int lastx = width;
  auto setvalue = [&](int32_t x) {
    if (pa >= thisrun + s.nruns) throw Overflow{};
    *pa++ = run_length + x;
    a0 += x;
    run_length = 0;
  };
  auto cleanup = [&]() {
    if (run_length) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= *--pa;
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  };
  // a run of one colour: its make-up codes then its terminating code;
  // 0 done, 1 EOL (1D only), 2 bad code, 3 end of data
  auto expand_run = [&](bool black, bool in2d) -> int {
    for (;;) {
      int wbits = black ? 13 : 12;
      if (!s.need(wbits)) return 3;
      const Ent& e = black ? T.black[s.get(13)] : T.white[s.get(12)];
      s.clr(e.width);
      switch (e.state) {
        case S_EOL:
          if (in2d) return 2;
          s.eolcnt = 1;
          return 1;
        case S_TermW:
        case S_TermB:
          if ((e.state == S_TermB) != black) return 2;
          setvalue(e.param);
          return 0;
        case S_MakeUpW:
        case S_MakeUpB:
          if ((e.state == S_MakeUpB) != black) return 2;
          a0 += e.param;
          run_length += e.param;
          break;
        case S_MakeUp:
          a0 += e.param;
          run_length += e.param;
          break;
        default:
          return 2;
      }
    }
  };
  // EXPAND1D: 0 line done, 3 end of data
  auto expand1d = [&]() -> int {
    for (;;) {
      int r = expand_run(false, false);
      if (r == 3) {
        cleanup();
        return 3;
      }
      if (r != 0) break;
      if (a0 >= lastx) break;
      r = expand_run(true, false);
      if (r == 3) {
        cleanup();
        return 3;
      }
      if (r != 0) break;
      if (a0 >= lastx) break;
      if (pa - 1 >= thisrun + 1 && *(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
    }
    cleanup();
    return 0;
  };
  auto check_b1 = [&]() {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= s.ref + s.nruns) throw Overflow{};
        b1 += pb[0] + pb[1];
        pb += 2;
      }
  };
  // EXPAND2D: 0 line done, 3 end of data
  auto expand2d = [&]() -> int {
    bool eol = false;
    while (a0 < lastx) {
      if (pa >= thisrun + s.nruns) throw Overflow{};
      if (!s.need(7)) {
        cleanup();
        return 3;
      }
      const Ent& e = T.main[s.get(7)];
      s.clr(e.width);
      switch (e.state) {
        case S_Pass:
          check_b1();
          if (pb >= s.ref + s.nruns) throw Overflow{};
          b1 += *pb++;
          run_length += b1 - a0;
          a0 = b1;
          b1 += *pb++;
          break;
        case S_Horiz: {
          bool black_first = (pa - thisrun) & 1;
          int r = expand_run(black_first, true);
          if (r == 3) {
            cleanup();
            return 3;
          }
          if (r == 0) {
            r = expand_run(!black_first, true);
            if (r == 3) {
              cleanup();
              return 3;
            }
          }
          if (r != 0) {
            eol = true;
            break;
          }
          check_b1();
          break;
        }
        case S_V0:
          check_b1();
          setvalue(b1 - a0);
          if (pb >= s.ref + s.nruns) throw Overflow{};
          b1 += *pb++;
          break;
        case S_VR:
          check_b1();
          setvalue(b1 - a0 + e.param);
          if (pb >= s.ref + s.nruns) throw Overflow{};
          b1 += *pb++;
          break;
        case S_VL:
          check_b1();
          if (b1 < a0 + e.param) {
            eol = true;
            break;
          }
          setvalue(b1 - a0 - e.param);
          if (pb <= s.ref) throw Overflow{};
          b1 -= *--pb;
          break;
        case S_Ext:
          *pa++ = lastx - a0;
          eol = true;
          break;
        case S_EOL:
          *pa++ = lastx - a0;
          if (!s.need(4)) {
            cleanup();
            return 3;
          }
          s.clr(4);
          s.eolcnt = 1;
          eol = true;
          break;
        default:
          eol = true;
          break;
      }
      if (eol) break;
    }
    if (!eol && run_length) {
      if (run_length + a0 < lastx) {
        if (!s.need(1)) {
          cleanup();
          return 3;
        }
        if (!s.get(1)) {
          cleanup();
          return 0;
        }
        s.clr(1);
      }
      setvalue(0);
    }
    cleanup();
    return 0;
  };
  // SYNC_EOL: false at the end of the data
  auto sync_eol = [&]() -> bool {
    if (s.mode & MODE_NOEOL) return true;
    if (s.eolcnt == 0) {
      for (;;) {
        if (!s.need(11)) return false;
        if (s.get(11) == 0) break;
        s.clr(1);
      }
    }
    for (;;) {
      if (!s.need(8)) return false;
      if (s.get(8)) break;
      s.clr(8);
    }
    while (s.get(1) == 0) s.clr(1);
    s.clr(1);
    s.eolcnt = 0;
    return true;
  };
  try {
    if (kind == FAX_RLE) {
      while (left > 0) {
        a0 = 0;
        run_length = 0;
        pa = thisrun = s.cur;
        int r = expand1d();
        if (r == 3) {
          fill_runs(buf, thisrun, pa, lastx);
          err = "Premature EOF";
          return 0;
        }
        fill_runs(buf, thisrun, pa, lastx);
        // align to a byte (RLE) or to a 16-bit word of the file (RLEW)
        if (s.mode & MODE_BYTEALIGN) {
          s.clr(s.avail & 7);
        } else {
          s.clr(s.avail & 15);
          if (s.avail == 0 && ((s.cp - s.start) + odd_offset) % 2 == 1) s.cp++;
        }
        buf += rowbytes;
        left -= rowbytes;
        s.line++;
      }
      return 1;
    }
    if (kind == FAX_G3 && !is2d) {
      while (left > 0) {
        a0 = 0;
        run_length = 0;
        pa = thisrun = s.cur;
        if (!sync_eol()) {
          cleanup();
          fill_runs(buf, thisrun, pa, lastx);
          err = "Premature EOF";
          return 0;
        }
        int r = expand1d();
        fill_runs(buf, thisrun, pa, lastx);
        if (r == 3) {
          err = "Premature EOF";
          return 0;
        }
        buf += rowbytes;
        left -= rowbytes;
        s.line++;
      }
      return 1;
    }
    if (kind == FAX_G3) {
      while (left > 0) {
        a0 = 0;
        run_length = 0;
        pa = thisrun = s.cur;
        if (!sync_eol()) {
          cleanup();
          fill_runs(buf, thisrun, pa, lastx);
          err = "Premature EOF";
          return 0;
        }
        if (!s.need(1)) {
          cleanup();
          fill_runs(buf, thisrun, pa, lastx);
          err = "Premature EOF";
          return 0;
        }
        bool one_d = s.get(1);
        s.clr(1);
        pb = s.ref;
        b1 = *pb++;
        int r = one_d ? expand1d() : expand2d();
        fill_runs(buf, thisrun, pa, lastx);
        if (r == 3) {
          err = "Premature EOF";
          return 0;
        }
        if (pa < thisrun + s.nruns) setvalue(0);
        std::swap(s.cur, s.ref);
        buf += rowbytes;
        left -= rowbytes;
        s.line++;
      }
      return 1;
    }
    // Group 4
    int start = s.line;
    while (left > 0) {
      a0 = 0;
      run_length = 0;
      pa = thisrun = s.cur;
      pb = s.ref;
      b1 = *pb++;
      int r = expand2d();
      if (r == 3 || s.eolcnt) {
        if (r == 3) s.eof_count++;
        if (s.need(13)) s.clr(13);
        fill_runs(buf, thisrun, pa, lastx);
        if (s.line != start) return 1;  // a badly terminated strip
        err = "Premature EOF";
        return 0;
      }
      fill_runs(buf, thisrun, pa, lastx);
      setvalue(0);
      std::swap(s.cur, s.ref);
      buf += rowbytes;
      left -= rowbytes;
      s.line++;
    }
    return 1;
  } catch (Overflow&) {
    err = "Buffer overflow";
    return 0;
  }
}

// ---------------------------------------------------------------- ThunderScan

int thunder_row(const uint8_t*& bp, long& cc, uint8_t* op0, long maxpixels, std::string& err) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  unsigned lastpixel = 0;
  long npixels = 0;
  uint8_t* op = op0;
  auto setpixel = [&](unsigned v) {
    lastpixel = v & 0xf;
    if (npixels < maxpixels) {
      if (npixels++ & 1)
        *op++ |= (uint8_t)lastpixel;
      else
        op[0] = (uint8_t)(lastpixel << 4);
    }
  };
  while (cc > 0 && npixels < maxpixels) {
    int n = *bp++, delta;
    cc--;
    switch (n & 0xc0) {
      case 0x00:
        if (npixels & 1) {
          op[0] |= (uint8_t)lastpixel;
          lastpixel = *op++;
          npixels++;
          n--;
        } else {
          lastpixel |= lastpixel << 4;
        }
        npixels += n;
        if (npixels <= maxpixels)  // a run may end the row
          for (; n > 0; n -= 2) *op++ = (uint8_t)lastpixel;
        if (n == -1) *--op &= 0xf0;
        lastpixel &= 0xf;
        break;
      case 0x40:
        if ((delta = (n >> 4) & 3) != 2) setpixel((unsigned)((int)lastpixel + two[delta]));
        if ((delta = (n >> 2) & 3) != 2) setpixel((unsigned)((int)lastpixel + two[delta]));
        if ((delta = n & 3) != 2) setpixel((unsigned)((int)lastpixel + two[delta]));
        break;
      case 0x80:
        if ((delta = (n >> 3) & 7) != 4) setpixel((unsigned)((int)lastpixel + three[delta]));
        if ((delta = n & 7) != 4) setpixel((unsigned)((int)lastpixel + three[delta]));
        break;
      default:
        setpixel((unsigned)n);
        break;
    }
  }
  if (npixels != maxpixels) {
    uint8_t* op_end = op0 + (maxpixels + 1) / 2;
    if (op < op_end) memset(op, 0, op_end - op);
    err = std::string(npixels < maxpixels ? "Not enough" : "Too much") + " data at scanline";
    return 0;
  }
  return 1;
}

}  // namespace

extern "C" {

int tiffdec_zstd(const uint8_t* in, size_t n, uint8_t* out, size_t occ, char* msg, int msg_len) {
  std::string err;
  bool ok = zstd_strip(in, n, out, occ, err);
  put_msg(err, msg, msg_len);
  return ok ? 1 : 0;
}

// kind: 0 modified Huffman (options bit 0: word aligned, RLEW; bit 1: the
// strip starts at an odd file offset), 1 Group 3 (options: T4Options),
// 2 Group 4
int tiffdec_fax(const uint8_t* in, size_t n, uint8_t* out, size_t occ, int width, int kind,
                int options, char* msg, int msg_len) {
  std::string err;
  int r = fax_strip(in, n, out, occ, width, kind, options, err);
  put_msg(err, msg, msg_len);
  return r;
}

int tiffdec_thunder(const uint8_t* in, size_t n, uint8_t* out, size_t occ, int width, char* msg,
                    int msg_len) {
  std::string err;
  long rowbytes = (width + 1) / 2;
  if (rowbytes == 0 || occ % rowbytes) {
    put_msg("Fractional scanlines cannot be read", msg, msg_len);
    return 0;
  }
  const uint8_t* bp = in;
  long cc = (long)n;
  for (size_t off = 0; off < occ; off += rowbytes) {
    if (!thunder_row(bp, cc, out + off, width, err)) {
      put_msg(err, msg, msg_len);
      return 0;
    }
  }
  return 1;
}

}  // extern "C"
