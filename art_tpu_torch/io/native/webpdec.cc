// webpdec: the WebP bitstream decoders for the port's image reads
// (io/webpdec.py), bit for bit as libwebp 1.6.0 (the copy Pillow 12.1.0
// bundles) decodes a frame into RGBA that is not premultiplied:
//
// - VP8L, the lossless format (src/dec/vp8l_dec.c, src/dsp/lossless.c,
//   src/utils/huffman_utils.c, src/utils/bit_reader_utils.c): the header,
//   the four transforms undone in reverse order (predictor with its 14
//   modes, 14 and 15 as black; cross-colour; subtract-green; colour
//   indexing with pixel bundling, an index past the palette transparent
//   black), the meta prefix codes, simple and normal prefix codes with
//   the code-length code and its repeat codes 16/17/18 (an incomplete or
//   over-full code is an error, a code of one symbol reads no bits), LZ77
//   with the 120-entry distance map, the colour cache. The bit reader is
//   libwebp's: bits past the end read as zeros and the stream is broken
//   once more bits are read than max(64, 8 * length) (VP8LIsEndOfStream).
// - VP8, the lossy key frame (src/dec/vp8_dec.c, tree_dec.c, quant_dec.c,
//   frame_dec.c, src/dsp/dec.c): the boolean decoder (bit_reader_inl_utils.h,
//   its end-of-data rule included), the frame header with segments,
//   filter and partitions, the token tree with dequantisation, the
//   inverse WHT and DCT with libwebp's shortcuts for DC-only and
//   three-coefficient blocks (the full DCT in the 16-bit lanes of
//   Transform_SSE2, which Pillow's x86-64 build runs), the intra
//   predictors (127 above the frame, 129 at its left, the 4x4 top-right
//   rule), the simple and normal loop
//   filters (no inner edges for a macroblock that has no coefficients and
//   is not 4x4). Prediction reads unfiltered samples; each row is filtered
//   after it is rebuilt, in libwebp's order. The output is libwebp's fancy
//   upsampler (src/dsp/upsampling.c, UPSAMPLE_FUNC) and its fixed-point
//   YUV to RGB (src/dsp/yuv.h, VP8YUVToR/G/B); no dithering.
// - ALPH (src/dec/alpha_dec.c, src/dsp/filters.c): raw or a header-less
//   VP8L stream whose green is the alpha (with libwebp's 8-bit path when
//   only colour indexing is used and no cache: a stream whose last symbol
//   reads past its end still decodes there), then the horizontal,
//   vertical or gradient unfilter. The pre-processing bit changes nothing
//   without dithering.
//
// C ABI for ctypes:
//   int webp_vp8l_decode(const uint8_t* data, size_t len, int w, int h,
//                        uint8_t* rgba, int stride)
//   int webp_vp8_decode(const uint8_t* data, size_t len,
//                       const uint8_t* alph, size_t alph_len, int w, int h,
//                       uint8_t* rgba, int stride)
// data: the VP8L or VP8 chunk's payload to the end of the frame's data
// (its padding byte included, as libwebp reads it); alph: the ALPH
// chunk's payload (its declared size), or NULL where the frame has none;
// w, h: the size the bitstream's header gives (checked again here);
// rgba: w x h pixels of 4 bytes, rows `stride` bytes apart. Returns 0 when
// the frame decodes, else libwebp's VP8StatusCode (3 a broken bitstream,
// 7 data that ends too soon).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum { kOk = 0, kBitstream = 3, kUnsupported = 4, kNotEnough = 7 };

// ---- VP8L: the bit reader (VP8LBitReader) --------------------------------

constexpr int kLBits = 64;
constexpr int kWBits = 32;

struct LBitReader {
  uint64_t val;
  const uint8_t* buf;
  size_t len, pos;
  int bit_pos;
  int eos;
};

void LInit(LBitReader* br, const uint8_t* start, size_t length) {
  const size_t n = length > 8 ? 8 : length;
  uint64_t value = 0;
  for (size_t i = 0; i < n; ++i) value |= (uint64_t)start[i] << (8 * i);
  br->val = value;
  br->buf = start;
  br->len = length;
  br->pos = n;
  br->bit_pos = 0;
  br->eos = 0;
}

inline bool LIsEndOfStream(const LBitReader* br) {
  return br->eos || (br->pos == br->len && br->bit_pos > kLBits);
}

inline void LSetEndOfStream(LBitReader* br) {
  br->eos = 1;
  br->bit_pos = 0;
}

inline void LShiftBytes(LBitReader* br) {
  while (br->bit_pos >= 8 && br->pos < br->len) {
    br->val >>= 8;
    br->val |= (uint64_t)br->buf[br->pos] << (kLBits - 8);
    ++br->pos;
    br->bit_pos -= 8;
  }
  if (LIsEndOfStream(br)) LSetEndOfStream(br);
}

inline uint32_t LPrefetch(const LBitReader* br) {
  return (uint32_t)(br->val >> (br->bit_pos & (kLBits - 1)));
}

inline void LFill(LBitReader* br) {
  if (br->bit_pos >= kWBits) LShiftBytes(br);
}

uint32_t LReadBits(LBitReader* br, int n) {
  if (!br->eos && n <= 24) {
    const uint32_t val = LPrefetch(br) & ((1u << n) - 1);
    br->bit_pos += n;
    LShiftBytes(br);
    return val;
  }
  LSetEndOfStream(br);
  return 0;
}

// ---- VP8L: prefix codes (huffman_utils.c) --------------------------------

struct HCode {
  uint8_t bits;    // bits of this entry, or the root bits plus a
                   // second-level table's bits
  uint16_t value;  // the symbol, or the offset of the second-level table
};

constexpr int kMaxCodeLength = 15;
constexpr int kRootBits = 8;         // HUFFMAN_TABLE_BITS
constexpr int kLengthsRootBits = 7;  // LENGTHS_TABLE_BITS

uint32_t GetNextKey(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void ReplicateValue(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

int NextTableBitSize(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// The table of a canonical code (least significant bit first) of the
// given code lengths: its size, or 0 where the lengths make no code (all
// zero, a length past 15, more codes of a length than fit, a code that is
// not complete unless it has one symbol). root == nullptr only checks.
int BuildHuffmanTable(HCode* root, int root_bits, const int* lengths, int n) {
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(n);
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = (uint16_t)s;
  }
  int total_size = 1 << root_bits;
  if (offset[kMaxCodeLength] == 1) {  // one symbol: a code of no bits
    if (root != nullptr) {
      HCode code;
      code.bits = 0;
      code.value = sorted[0];
      ReplicateValue(root, 1, total_size, code);
    }
    return total_size;
  }
  HCode* table = root;
  uint32_t low = 0xffffffffu;
  const uint32_t mask = (uint32_t)total_size - 1;
  uint32_t key = 0;
  int num_nodes = 1, num_open = 1;
  int table_bits = root_bits, table_size = 1 << table_bits;
  int symbol = 0, len, step;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    if (root == nullptr) continue;
    for (; count[len] > 0; --count[len]) {
      HCode code;
      code.bits = (uint8_t)len;
      code.value = sorted[symbol++];
      ReplicateValue(&table[key], step, table_size, code);
      key = GetNextKey(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= kMaxCodeLength; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        if (root != nullptr) table += table_size;
        table_bits = NextTableBitSize(count, len, root_bits);
        table_size = 1 << table_bits;
        total_size += table_size;
        low = key & mask;
        if (root != nullptr) {
          root[low].bits = (uint8_t)(table_bits + root_bits);
          root[low].value = (uint16_t)((table - root) - low);
        }
      }
      if (root != nullptr) {
        HCode code;
        code.bits = (uint8_t)(len - root_bits);
        code.value = sorted[symbol++];
        ReplicateValue(&table[key >> root_bits], step, table_size, code);
      }
      key = GetNextKey(key, len);
    }
  }
  if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;
  return total_size;
}

inline int ReadSymbol(const HCode* table, LBitReader* br) {
  uint32_t val = LPrefetch(br);
  table += val & ((1u << kRootBits) - 1);
  const int nbits = table->bits - kRootBits;
  if (nbits > 0) {
    br->bit_pos += kRootBits;
    val = LPrefetch(br);
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br->bit_pos += table->bits;
  return table->value;
}

// ---- VP8L: the decoder ---------------------------------------------------

enum { kGreen = 0, kRed = 1, kBlue = 2, kAlpha = 3, kDist = 4 };
enum { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2, kColorIndexing = 3 };
constexpr int kNumLiteral = 256, kNumLength = 24, kNumDistance = 40;
const int kAlphabetSize[5] = {kNumLiteral + kNumLength, kNumLiteral, kNumLiteral,
                              kNumLiteral, kNumDistance};
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                          7, 8, 9, 10, 11, 12, 13, 14, 15};
// the 120 short distances as (dy << 4) | (8 - dx) (the spec's distance map)
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

struct Group {
  std::vector<HCode> t[5];
};

struct Meta {
  int cache_bits = 0;
  int huffman_bits = 0;
  int huffman_xsize = 0;
  int huffman_mask = ~0;
  std::vector<uint32_t> image;  // group index by tile
  std::vector<Group> groups;
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0, num_colors = 0;
  std::vector<uint32_t> data;
};

struct LDec {
  LBitReader br;
  Transform tr[4];
  int ntrans = 0;
  unsigned seen = 0;
  int width = 0;  // the width of the entropy-coded image
  Meta hdr;
};

inline int SubSampleSize(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

bool DecodeImageStream(int xsize, int ysize, bool level0, LDec* dec,
                       std::vector<uint32_t>* out);

bool ReadHuffmanCodeLengths(LDec* dec, const int* cl_lengths, int num_symbols,
                            int* lengths) {
  LBitReader* br = &dec->br;
  HCode table[1 << kLengthsRootBits];
  if (!BuildHuffmanTable(table, kLengthsRootBits, cl_lengths, 19)) return false;
  int max_symbol;
  if (LReadBits(br, 1)) {
    const int length_nbits = 2 + 2 * (int)LReadBits(br, 3);
    max_symbol = 2 + (int)LReadBits(br, length_nbits);
    if (max_symbol > num_symbols) return false;
  } else {
    max_symbol = num_symbols;
  }
  int symbol = 0, prev_len = 8;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    LFill(br);
    const HCode* p = &table[LPrefetch(br) & ((1u << kLengthsRootBits) - 1)];
    br->bit_pos += p->bits;
    const int code_len = p->value;
    if (code_len < 16) {
      lengths[symbol++] = code_len;
      if (code_len != 0) prev_len = code_len;
    } else {
      static const int kExtraBits[3] = {2, 3, 7};
      static const int kRepeatOffsets[3] = {3, 3, 11};
      const int slot = code_len - 16;
      int repeat = (int)LReadBits(br, kExtraBits[slot]) + kRepeatOffsets[slot];
      if (symbol + repeat > num_symbols) return false;
      const int length = code_len == 16 ? prev_len : 0;
      while (repeat-- > 0) lengths[symbol++] = length;
    }
  }
  return true;
}

// One prefix code: its table into *out (nullptr: only checked). Returns
// the table's size, 0 on error.
int ReadHuffmanCode(int alphabet_size, LDec* dec, std::vector<int>& lengths,
                    std::vector<HCode>* out) {
  LBitReader* br = &dec->br;
  bool ok;
  std::fill(lengths.begin(), lengths.begin() + alphabet_size, 0);
  if (LReadBits(br, 1)) {  // simple code: one or two symbols
    const int num_symbols = (int)LReadBits(br, 1) + 1;
    const int first_len_code = (int)LReadBits(br, 1);
    int symbol = (int)LReadBits(br, first_len_code == 0 ? 1 : 8);
    lengths[symbol] = 1;
    if (num_symbols == 2) {
      symbol = (int)LReadBits(br, 8);
      lengths[symbol] = 1;
    }
    ok = true;
  } else {
    int cl_lengths[19] = {0};
    const int num_codes = (int)LReadBits(br, 4) + 4;
    for (int i = 0; i < num_codes; ++i) {
      cl_lengths[kCodeLengthCodeOrder[i]] = (int)LReadBits(br, 3);
    }
    ok = ReadHuffmanCodeLengths(dec, cl_lengths, alphabet_size, lengths.data());
  }
  ok = ok && !br->eos;
  if (!ok) return 0;
  const int size = BuildHuffmanTable(nullptr, kRootBits, lengths.data(), alphabet_size);
  if (size == 0 || out == nullptr) return size;
  // the largest table a code of up to 15 bits can need: the root and a
  // second-level table of 7 bits under each of its entries
  out->assign((1 << kRootBits) * (1 + (1 << (kMaxCodeLength - kRootBits))), HCode{0, 0});
  out->resize(BuildHuffmanTable(out->data(), kRootBits, lengths.data(), alphabet_size));
  return size;
}

bool ReadHuffmanCodes(LDec* dec, int xsize, int ysize, int cache_bits,
                      bool allow_recursion, Meta* hdr) {
  LBitReader* br = &dec->br;
  int num_groups = 1;
  std::vector<uint8_t> used;
  if (allow_recursion && LReadBits(br, 1)) {  // meta prefix codes
    const int bits = 2 + (int)LReadBits(br, 3);
    const int hx = SubSampleSize(xsize, bits), hy = SubSampleSize(ysize, bits);
    if (!DecodeImageStream(hx, hy, false, dec, &hdr->image)) return false;
    hdr->huffman_bits = bits;
    for (auto& p : hdr->image) {
      p = (p >> 8) & 0xffff;
      if ((int)p >= num_groups) num_groups = (int)p + 1;
    }
    used.assign(num_groups, 0);
    for (const auto p : hdr->image) used[p] = 1;
  }
  if (br->eos) return false;
  const int cache_size = cache_bits > 0 ? 1 << cache_bits : 0;
  std::vector<int> lengths(kAlphabetSize[0] + cache_size + 256, 0);
  hdr->groups.assign(num_groups, Group());
  for (int i = 0; i < num_groups; ++i) {
    const bool keep = used.empty() || used[i];
    for (int j = 0; j < 5; ++j) {
      const int alphabet = kAlphabetSize[j] + (j == 0 ? cache_size : 0);
      if (!ReadHuffmanCode(alphabet, dec, lengths, keep ? &hdr->groups[i].t[j] : nullptr)) {
        return false;
      }
    }
  }
  return true;
}

bool ExpandColorMap(int num_colors, Transform* t) {
  const int final_num_colors = 1 << (8 >> t->bits);
  std::vector<uint32_t> map(final_num_colors, 0);
  uint8_t* const data = reinterpret_cast<uint8_t*>(t->data.data());
  uint8_t* const out = reinterpret_cast<uint8_t*>(map.data());
  map[0] = t->data[0];
  for (int i = 4; i < 4 * num_colors; ++i) out[i] = (uint8_t)(data[i] + out[i - 4]);
  t->data.swap(map);
  return true;
}

bool ReadTransform(int* xsize, int* ysize, LDec* dec) {
  LBitReader* br = &dec->br;
  const int type = (int)LReadBits(br, 2);
  if (dec->seen & (1u << type)) return false;
  dec->seen |= 1u << type;
  Transform* t = &dec->tr[dec->ntrans++];
  t->type = type;
  t->xsize = *xsize;
  t->ysize = *ysize;
  t->data.clear();
  switch (type) {
    case kPredictor:
    case kCrossColor:
      t->bits = (int)LReadBits(br, 3) + 2;
      return DecodeImageStream(SubSampleSize(t->xsize, t->bits),
                               SubSampleSize(t->ysize, t->bits), false, dec, &t->data);
    case kColorIndexing: {
      const int num_colors = (int)LReadBits(br, 8) + 1;
      t->num_colors = num_colors;
      const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = SubSampleSize(t->xsize, bits);
      t->bits = bits;
      if (!DecodeImageStream(num_colors, 1, false, dec, &t->data)) return false;
      return ExpandColorMap(num_colors, t);
    }
    default:  // subtract green
      return true;
  }
}

inline const Group* GroupForPos(const Meta* hdr, int x, int y) {
  if (hdr->huffman_bits == 0) return &hdr->groups[0];
  return &hdr->groups[hdr->image[(size_t)hdr->huffman_xsize * (y >> hdr->huffman_bits) +
                                 (x >> hdr->huffman_bits)]];
}

inline int GetCopyDistance(int symbol, LBitReader* br) {
  if (symbol < 4) return symbol + 1;
  const int extra_bits = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra_bits;
  return offset + (int)LReadBits(br, extra_bits) + 1;
}

inline int PlaneCodeToDistance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

inline uint32_t HashPix(uint32_t argb, int shift) {
  return (uint32_t)((argb * 0x1e35a7bdu) >> shift);
}

// DecodeImageData: the entropy-coded pixels of a width x height image.
bool DecodeImageData(LDec* dec, const Meta* hdr, uint32_t* data, int width, int height) {
  LBitReader* br = &dec->br;
  uint32_t* src = data;
  uint32_t* const src_end = data + (size_t)width * height;
  const int len_code_limit = kNumLiteral + kNumLength;
  const int cache_size = hdr->cache_bits > 0 ? 1 << hdr->cache_bits : 0;
  const int cache_limit = len_code_limit + cache_size;
  const int cache_shift = 32 - hdr->cache_bits;
  std::vector<uint32_t> cache(cache_size, 0);
  const int mask = hdr->huffman_bits == 0 ? ~0 : (1 << hdr->huffman_bits) - 1;
  int row = 0, col = 0;
  const Group* g = src < src_end ? GroupForPos(hdr, col, row) : nullptr;
  while (src < src_end) {
    if ((col & mask) == 0) g = GroupForPos(hdr, col, row);
    LFill(br);
    const int code = ReadSymbol(g->t[kGreen].data(), br);
    if (LIsEndOfStream(br)) break;
    if (code < kNumLiteral || (code >= len_code_limit && code < cache_limit)) {
      if (code < kNumLiteral) {
        const int red = ReadSymbol(g->t[kRed].data(), br);
        LFill(br);
        const int blue = ReadSymbol(g->t[kBlue].data(), br);
        const int alpha = ReadSymbol(g->t[kAlpha].data(), br);
        if (LIsEndOfStream(br)) break;
        *src = ((uint32_t)alpha << 24) | (red << 16) | (code << 8) | blue;
      } else {
        *src = cache[code - len_code_limit];
      }
      if (cache_size) cache[HashPix(*src, cache_shift)] = *src;
      ++src;
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < len_code_limit) {  // backward reference
      const int length = GetCopyDistance(code - kNumLiteral, br);
      const int dist_symbol = ReadSymbol(g->t[kDist].data(), br);
      LFill(br);
      const int dist_code = GetCopyDistance(dist_symbol, br);
      const int dist = PlaneCodeToDistance(width, dist_code);
      if (LIsEndOfStream(br)) break;
      if (src - data < (ptrdiff_t)dist || src_end - src < (ptrdiff_t)length) return false;
      for (int i = 0; i < length; ++i) {
        src[i] = src[i - dist];
        if (cache_size) cache[HashPix(src[i], cache_shift)] = src[i];
      }
      src += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (src < src_end && (col & mask)) g = GroupForPos(hdr, col, row);
    } else {
      return false;
    }
  }
  br->eos = LIsEndOfStream(br);
  return !br->eos;
}

bool DecodeImageStream(int xsize, int ysize, bool level0, LDec* dec,
                       std::vector<uint32_t>* out) {
  LBitReader* br = &dec->br;
  int txs = xsize, tys = ysize;
  if (level0) {
    while (LReadBits(br, 1)) {
      if (!ReadTransform(&txs, &tys, dec)) return false;
    }
  }
  int cache_bits = 0;
  if (LReadBits(br, 1)) {
    cache_bits = (int)LReadBits(br, 4);
    if (cache_bits < 1 || cache_bits > 11) return false;
  }
  Meta local;
  Meta* hdr = level0 ? &dec->hdr : &local;
  if (!ReadHuffmanCodes(dec, txs, tys, cache_bits, level0, hdr)) return false;
  hdr->cache_bits = cache_bits;
  hdr->huffman_xsize = SubSampleSize(txs, hdr->huffman_bits);
  dec->width = txs;
  if (level0) return true;
  out->assign((size_t)txs * tys, 0);
  return DecodeImageData(dec, hdr, out->data(), txs, tys) && !br->eos;
}

// ---- VP8L: the inverse transforms (lossless.c) ---------------------------

inline uint32_t AddPixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t Average2(uint32_t a0, uint32_t a1) {
  return (((a0 ^ a1) & 0xfefefefeu) >> 1) + (a0 & a1);
}

inline uint32_t Clip255(uint32_t a) {
  if (a < 256) return a;
  return ~a >> 24;
}

inline int Sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return std::abs(pb) - std::abs(pa);
}

inline uint32_t Select(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = Sub3((a >> 24), (b >> 24), (c >> 24)) +
                          Sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          Sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          Sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}

inline uint32_t ClampedAddSubtractFull(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = (int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) - (int)((c2 >> s) & 0xff);
    out |= Clip255((uint32_t)v) << s;
  }
  return out;
}

inline uint32_t ClampedAddSubtractHalf(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = Average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (int)((ave >> s) & 0xff), b = (int)((c2 >> s) & 0xff);
    out |= Clip255((uint32_t)(a + (a - b) / 2)) << s;
  }
  return out;
}

inline uint32_t Predict(int mode, const uint32_t* out, const uint32_t* top) {
  const uint32_t left = out[-1];
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return Average2(Average2(left, top[1]), top[0]);
    case 6: return Average2(left, top[-1]);
    case 7: return Average2(left, top[0]);
    case 8: return Average2(top[-1], top[0]);
    case 9: return Average2(top[0], top[1]);
    case 10: return Average2(Average2(left, top[-1]), Average2(top[0], top[1]));
    case 11: return Select(top[0], left, top[-1]);
    case 12: return ClampedAddSubtractFull(left, top[0], top[-1]);
    case 13: return ClampedAddSubtractHalf(left, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

// One transform undone over the whole image; in holds the image as the
// transform left it (narrower for colour indexing with bundling).
void InverseTransform(const Transform* t, const uint32_t* in, uint32_t* out) {
  const int w = t->xsize, h = t->ysize;
  switch (t->type) {
    case kPredictor: {
      out[0] = AddPixels(in[0], 0xff000000u);
      for (int x = 1; x < w; ++x) out[x] = AddPixels(in[x], out[x - 1]);
      const int tiles = SubSampleSize(w, t->bits);
      for (int y = 1; y < h; ++y) {
        const uint32_t* src = in + (size_t)y * w;
        uint32_t* dst = out + (size_t)y * w;
        const uint32_t* top = dst - w;
        const uint32_t* modes = t->data.data() + (size_t)(y >> t->bits) * tiles;
        dst[0] = AddPixels(src[0], top[0]);
        for (int x = 1; x < w; ++x) {
          const int mode = (modes[x >> t->bits] >> 8) & 0xf;
          dst[x] = AddPixels(src[x], Predict(mode, dst + x, top + x));
        }
      }
      break;
    }
    case kCrossColor: {
      const int tiles = SubSampleSize(w, t->bits);
      for (int y = 0; y < h; ++y) {
        const uint32_t* codes = t->data.data() + (size_t)(y >> t->bits) * tiles;
        for (int x = 0; x < w; ++x) {
          const uint32_t code = codes[x >> t->bits];
          const int8_t g2r = (int8_t)(code & 0xff), g2b = (int8_t)((code >> 8) & 0xff);
          const int8_t r2b = (int8_t)((code >> 16) & 0xff);
          const uint32_t argb = in[(size_t)y * w + x];
          const int8_t green = (int8_t)(argb >> 8);
          int new_red = (argb >> 16) & 0xff;
          int new_blue = argb & 0xff;
          new_red += ((int)g2r * green) >> 5;
          new_red &= 0xff;
          new_blue += ((int)g2b * green) >> 5;
          new_blue += ((int)r2b * (int8_t)new_red) >> 5;
          new_blue &= 0xff;
          out[(size_t)y * w + x] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | new_blue;
        }
      }
      break;
    }
    case kSubtractGreen: {
      const size_t n = (size_t)w * h;
      for (size_t i = 0; i < n; ++i) {
        const uint32_t argb = in[i];
        const uint32_t green = (argb >> 8) & 0xff;
        uint32_t rb = argb & 0x00ff00ffu;
        rb += (green << 16) | green;
        out[i] = (argb & 0xff00ff00u) | (rb & 0x00ff00ffu);
      }
      break;
    }
    default: {  // colour indexing
      const int bits_per_pixel = 8 >> t->bits;
      const int count_mask = (1 << t->bits) - 1;
      const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
      const int in_w = SubSampleSize(w, t->bits);
      const uint32_t* map = t->data.data();
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = in + (size_t)y * in_w;
        uint32_t* dst = out + (size_t)y * w;
        uint32_t packed = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
          dst[x] = map[packed & bit_mask];
          packed >>= bits_per_pixel;
        }
      }
      break;
    }
  }
}

// The ARGB image of a VP8L stream after its header (level 0 decoded).
bool DecodeArgb(LDec* dec, int height, std::vector<uint32_t>* argb) {
  std::vector<uint32_t> px((size_t)dec->width * height);
  if (!DecodeImageData(dec, &dec->hdr, px.data(), dec->width, height)) return false;
  for (int n = dec->ntrans - 1; n >= 0; --n) {
    const Transform* t = &dec->tr[n];
    std::vector<uint32_t> next((size_t)t->xsize * t->ysize);
    InverseTransform(t, px.data(), next.data());
    px.swap(next);
  }
  argb->swap(px);
  return true;
}

// ---- ALPH (alpha_dec.c, filters.c) ---------------------------------------

// WebPUnfilters: row by row in place; prev is the row above, or nullptr
// for the first row.
void Unfilter(int filter, const uint8_t* prev, uint8_t* row, int width) {
  if (filter == 1 || ((filter == 2 || filter == 3) && prev == nullptr)) {
    uint8_t pred = prev == nullptr ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      row[i] = (uint8_t)(pred + row[i]);
      pred = row[i];
    }
  } else if (filter == 2) {
    for (int i = 0; i < width; ++i) row[i] = (uint8_t)(prev[i] + row[i]);
  } else if (filter == 3) {
    int top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      const int g = left + top - top_left;
      const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
      left = (uint8_t)(row[i] + pred);
      top_left = top;
      row[i] = (uint8_t)left;
    }
  }
}

// VP8LDecodeAlphaHeader and VP8LDecodeAlphaImageStream: the alpha plane
// (w x h, before its unfilter) of a header-less VP8L stream.
bool DecodeAlphaLossless(const uint8_t* data, size_t len, int w, int h, uint8_t* alpha) {
  LDec dec;
  LInit(&dec.br, data, len);
  if (!DecodeImageStream(w, h, true, &dec, nullptr)) return false;
  const Meta* hdr = &dec.hdr;
  bool is8b = dec.ntrans == 1 && dec.tr[0].type == kColorIndexing && hdr->cache_bits == 0;
  for (const Group& g : hdr->groups) {
    if (g.t[kRed].empty()) continue;  // a group no tile uses
    if (g.t[kRed][0].bits > 0 || g.t[kBlue][0].bits > 0 || g.t[kAlpha][0].bits > 0) is8b = false;
  }
  if (!is8b) {
    std::vector<uint32_t> argb;
    if (!DecodeArgb(&dec, h, &argb)) return false;
    for (size_t i = 0; i < (size_t)w * h; ++i) alpha[i] = (uint8_t)(argb[i] >> 8);
    return true;
  }
  // DecodeAlphaData: green symbols as palette indices, one byte a pixel
  LBitReader* br = &dec.br;
  const int width = dec.width;
  const int end = width * h;
  std::vector<uint8_t> idx(end);
  const int mask = hdr->huffman_bits == 0 ? ~0 : (1 << hdr->huffman_bits) - 1;
  int pos = 0, col = 0, row = 0;
  bool ok = true;
  const Group* g = pos < end ? GroupForPos(hdr, 0, 0) : nullptr;
  while (!br->eos && pos < end) {
    if ((col & mask) == 0) g = GroupForPos(hdr, col, row);
    LFill(br);
    const int code = ReadSymbol(g->t[kGreen].data(), br);
    if (code < kNumLiteral) {
      idx[pos++] = (uint8_t)code;
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < kNumLiteral + kNumLength) {
      const int length = GetCopyDistance(code - kNumLiteral, br);
      const int dist_symbol = ReadSymbol(g->t[kDist].data(), br);
      LFill(br);
      const int dist_code = GetCopyDistance(dist_symbol, br);
      const int dist = PlaneCodeToDistance(width, dist_code);
      if (pos >= dist && end - pos >= length) {
        for (int i = 0; i < length; ++i) idx[pos + i] = idx[pos + i - dist];
      } else {
        ok = false;
        break;
      }
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (pos < end && (col & mask)) g = GroupForPos(hdr, col, row);
    } else {
      ok = false;
      break;
    }
    br->eos = LIsEndOfStream(br);
  }
  br->eos = LIsEndOfStream(br);
  if (!ok || (br->eos && pos < end)) return false;
  const Transform* t = &dec.tr[0];
  const int bits_per_pixel = 8 >> t->bits;
  const int count_mask = (1 << t->bits) - 1;
  const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = idx.data() + (size_t)y * width;
    uint8_t* dst = alpha + (size_t)y * w;
    uint32_t packed = 0;
    for (int x = 0; x < w; ++x) {
      if ((x & count_mask) == 0) packed = *src++;
      dst[x] = (uint8_t)(t->data[packed & bit_mask] >> 8);
      packed >>= bits_per_pixel;
    }
  }
  return true;
}

// ALPHInit and ALPHDecode: the alpha plane of an ALPH chunk's payload.
bool DecodeAlpha(const uint8_t* data, size_t size, int w, int h, uint8_t* alpha) {
  if (size <= 1) return false;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre_processing = (data[0] >> 4) & 3, reserved = (data[0] >> 6) & 3;
  if (method > 1 || pre_processing > 1 || reserved != 0) return false;
  if (method == 0) {
    if (size - 1 < (size_t)w * h) return false;
    std::memcpy(alpha, data + 1, (size_t)w * h);
  } else if (!DecodeAlphaLossless(data + 1, size - 1, w, h, alpha)) {
    return false;
  }
  if (filter != 0) {
    for (int y = 0; y < h; ++y) {
      Unfilter(filter, y ? alpha + (size_t)(y - 1) * w : nullptr, alpha + (size_t)y * w, w);
    }
  }
  return true;
}

// ---- VP8: the boolean decoder (bit_reader_utils.c, bit_reader_inl_utils.h)

struct BoolReader {
  uint64_t value;
  uint32_t range;  // the range less one, in [126, 254]
  int bits;        // the number of valid bits left
  const uint8_t* buf;
  const uint8_t* buf_end;
  const uint8_t* buf_max;
  int eof;
};

void LoadFinalBytes(BoolReader* br) {
  if (br->buf < br->buf_end) {
    br->bits += 8;
    br->value = (uint64_t)(*br->buf++) | (br->value << 8);
  } else if (!br->eof) {
    br->value <<= 8;
    br->bits += 8;
    br->eof = 1;
  } else {
    br->bits = 0;
  }
}

inline void LoadNewBytes(BoolReader* br) {
  if (br->buf < br->buf_max) {  // 56 bits at a time
    uint64_t bits = 0;
    for (int i = 0; i < 8; ++i) bits = (bits << 8) | br->buf[i];
    br->buf += 7;
    br->value = (bits >> 8) | (br->value << 56);
    br->bits += 56;
  } else {
    LoadFinalBytes(br);
  }
}

void BoolInit(BoolReader* br, const uint8_t* start, size_t size) {
  br->range = 255 - 1;
  br->value = 0;
  br->bits = -8;
  br->eof = 0;
  br->buf = start;
  br->buf_end = start + size;
  br->buf_max = size >= 8 ? start + size - 8 + 1 : start;
  LoadNewBytes(br);
}

inline int GetBit(BoolReader* br, int prob) {
  uint32_t range = br->range;
  if (br->bits < 0) LoadNewBytes(br);
  const int pos = br->bits;
  const uint32_t split = (range * (uint32_t)prob) >> 8;
  const uint32_t value = (uint32_t)(br->value >> pos);
  const int bit = value > split;
  if (bit) {
    range -= split;
    br->value -= (uint64_t)(split + 1) << pos;
  } else {
    range = split + 1;
  }
  const int shift = 7 ^ (31 ^ __builtin_clz(range));
  range <<= shift;
  br->bits -= shift;
  br->range = range - 1;
  return bit;
}

// VP8GetSigned: a bit of probability 1/2 as the sign of v
inline int GetSigned(BoolReader* br, int v) {
  if (br->bits < 0) LoadNewBytes(br);
  const int pos = br->bits;
  const uint32_t split = br->range >> 1;
  const uint32_t value = (uint32_t)(br->value >> pos);
  const int32_t mask = (int32_t)(split - value) >> 31;  // -1 or 0
  br->bits -= 1;
  br->range += (uint32_t)mask;
  br->range |= 1;
  br->value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
  return (v ^ mask) - mask;
}

uint32_t GetValue(BoolReader* br, int bits) {
  uint32_t v = 0;
  while (bits-- > 0) v |= (uint32_t)GetBit(br, 0x80) << bits;
  return v;
}

int GetSignedValue(BoolReader* br, int bits) {
  const int value = (int)GetValue(br, bits);
  return GetBit(br, 0x80) ? -value : value;
}

// ---- VP8: tables -----------------------------------------------------------

// kDcTable, kAcTable (RFC 6386 section 14.1, dc_qlookup and ac_qlookup)
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
// the coefficient probabilities' update probabilities and defaults
// (RFC 6386 section 13.4 and 13.5), [type][band][context][node]
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
// the 4x4 intra modes' probabilities (RFC 6386 section 11.5), [above][left]
// in this file's mode order (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU)
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[16 + 1] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// the 16x16 and chroma modes, and the 4x4 modes in this order
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
  B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
  B_DC_PRED_NOTOP = 4, B_DC_PRED_NOLEFT = 5, B_DC_PRED_NOTOPLEFT = 6
};

constexpr int BPS = 32;  // the work buffer's stride
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline uint8_t Clip8b(int v) { return (!(v & ~0xff)) ? (uint8_t)v : (v < 0) ? 0 : 255; }
inline int Abs(int v) { return v < 0 ? -v : v; }
inline int SClip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // VP8ksclip1
inline int SClip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // VP8ksclip2
inline uint8_t Clip1(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }  // VP8kclip1

// ---- VP8: inverse transforms (dsp/dec.c) -----------------------------------

inline int Mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int Mul2(int a) { return (a * 35468) >> 16; }

inline void Store(uint8_t* dst, int x, int y, int v) {
  dst[x + y * BPS] = Clip8b(dst[x + y * BPS] + (v >> 3));
}

// 16-bit lanes as SSE2 computes them: a sum wraps, a product keeps its
// high half (_mm_mulhi_epi16)
inline int16_t W16(int v) { return (int16_t)v; }
inline int16_t MulHi(int16_t x, int k) { return (int16_t)(((int)x * k) >> 16); }

// The inverse DCT as Transform_SSE2 (dsp/dec_sse2.c, the x86-64 build)
// computes it: the C version's arithmetic in 16-bit lanes (K1 = 20091 +
// 2^16, K2 = 35468 = -30068 + 2^16, so x * K >> 16 is mulhi(x, k) + x).
// Inside an encoder's coefficient range (+-2048) no sum wraps and it equals
// TransformOne_C; a damaged stream's larger coefficients wrap as there.
void TransformOne(const int16_t* in, uint8_t* dst) {
  int16_t T[4][4];  // T[i]: column i after the vertical pass
  for (int i = 0; i < 4; ++i) {
    const int16_t in0 = in[i], in1 = in[4 + i], in2 = in[8 + i], in3 = in[12 + i];
    const int16_t a = W16(in0 + in2), b = W16(in0 - in2);
    const int16_t c = W16(W16(in1 - in3) + W16(MulHi(in1, -30068) - MulHi(in3, 20091)));
    const int16_t d = W16(W16(in1 + in3) + W16(MulHi(in1, 20091) + MulHi(in3, -30068)));
    T[i][0] = W16(a + d);
    T[i][1] = W16(b + c);
    T[i][2] = W16(b - c);
    T[i][3] = W16(a - d);
  }
  for (int j = 0; j < 4; ++j) {  // output row j
    const int16_t t0 = T[0][j], t1 = T[1][j], t2 = T[2][j], t3 = T[3][j];
    const int16_t dc = W16(t0 + 4);
    const int16_t a = W16(dc + t2), b = W16(dc - t2);
    const int16_t c = W16(W16(t1 - t3) + W16(MulHi(t1, -30068) - MulHi(t3, 20091)));
    const int16_t d = W16(W16(t1 + t3) + W16(MulHi(t1, 20091) + MulHi(t3, -30068)));
    const int o[4] = {W16(a + d) >> 3, W16(b + c) >> 3, W16(b - c) >> 3, W16(a - d) >> 3};
    for (int x = 0; x < 4; ++x) {
      uint8_t* px = dst + x + j * BPS;
      *px = Clip8b(W16(*px + o[x]));  // _mm_packus_epi16
    }
  }
}

void TransformDC(const int16_t* in, uint8_t* dst) {
  const int DC = in[0] + 4;
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) Store(dst, i, j, DC);
}

void TransformAC3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = Mul2(in[4]), d4 = Mul1(in[4]);
  const int c1 = Mul2(in[1]), d1 = Mul1(in[1]);
  const int dcs[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    Store(dst, 0, y, dcs[y] + d1);
    Store(dst, 1, y, dcs[y] + c1);
    Store(dst, 2, y, dcs[y] - c1);
    Store(dst, 3, y, dcs[y] - d1);
  }
}

void TransformWHT(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

void DoTransform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: TransformOne(src, dst); break;
    case 2: TransformAC3(src, dst); break;
    case 1: TransformDC(src, dst); break;
    default: break;
  }
}

void DoUVTransform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits & 0xff) {
    if (bits & 0xaa) {  // TransformUV: all four blocks
      TransformOne(src, dst);
      TransformOne(src + 16, dst + 4);
      TransformOne(src + 32, dst + 4 * BPS);
      TransformOne(src + 48, dst + 4 * BPS + 4);
    } else {  // TransformDCUV
      if (src[0]) TransformDC(src, dst);
      if (src[16]) TransformDC(src + 16, dst + 4);
      if (src[32]) TransformDC(src + 32, dst + 4 * BPS);
      if (src[48]) TransformDC(src + 48, dst + 4 * BPS + 4);
    }
  }
}

// ---- VP8: intra predictors (dsp/dec.c) -------------------------------------

inline uint8_t Avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t Avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }
#define DST(x, y) dst[(x) + (y) * BPS]

void TrueMotion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int corner = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = Clip1(top[x] + left - corner);
    dst += BPS;
  }
}

void Pred4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, (int)dc, 4);
      break;
    }
    case B_TM_PRED: TrueMotion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {Avg3(top[-1], top[0], top[1]), Avg3(top[0], top[1], top[2]),
                               Avg3(top[1], top[2], top[3]), Avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS];
      const int D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
      std::memset(dst + 0 * BPS, Avg3(A, B, C), 4);
      std::memset(dst + 1 * BPS, Avg3(B, C, D), 4);
      std::memset(dst + 2 * BPS, Avg3(C, D, E), 4);
      std::memset(dst + 3 * BPS, Avg3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      const int X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 3) = Avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = Avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = Avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = Avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = Avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = Avg3(C, B, A);
      DST(3, 0) = Avg3(D, C, B);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS];
      const int X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 0) = DST(1, 2) = Avg2(X, A);
      DST(1, 0) = DST(2, 2) = Avg2(A, B);
      DST(2, 0) = DST(3, 2) = Avg2(B, C);
      DST(3, 0) = Avg2(C, D);
      DST(0, 3) = Avg3(K, J, I);
      DST(0, 2) = Avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = Avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = Avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = Avg3(A, B, C);
      DST(3, 1) = Avg3(B, C, D);
      break;
    }
    case B_LD_PRED: {
      const int A = top[0], B = top[1], C = top[2], D = top[3];
      const int E = top[4], F = top[5], G = top[6], H = top[7];
      DST(0, 0) = Avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = Avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = Avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = Avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = Avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = Avg3(F, G, H);
      DST(3, 3) = Avg3(G, H, H);
      break;
    }
    case B_VL_PRED: {
      const int A = top[0], B = top[1], C = top[2], D = top[3];
      const int E = top[4], F = top[5], G = top[6], H = top[7];
      DST(0, 0) = Avg2(A, B);
      DST(1, 0) = DST(0, 2) = Avg2(B, C);
      DST(2, 0) = DST(1, 2) = Avg2(C, D);
      DST(3, 0) = DST(2, 2) = Avg2(D, E);
      DST(0, 1) = Avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = Avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = Avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = Avg3(D, E, F);
      DST(3, 2) = Avg3(E, F, G);
      DST(3, 3) = Avg3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      const int X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2];
      DST(0, 0) = DST(2, 1) = Avg2(I, X);
      DST(0, 1) = DST(2, 2) = Avg2(J, I);
      DST(0, 2) = DST(2, 3) = Avg2(K, J);
      DST(0, 3) = Avg2(L, K);
      DST(3, 0) = Avg3(A, B, C);
      DST(2, 0) = Avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = Avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = Avg3(X, I, J);
      DST(1, 2) = DST(3, 3) = Avg3(I, J, K);
      DST(1, 3) = Avg3(J, K, L);
      break;
    }
    default: {  // B_HU_PRED
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      DST(0, 0) = Avg2(I, J);
      DST(2, 0) = DST(0, 1) = Avg2(J, K);
      DST(2, 1) = DST(0, 2) = Avg2(K, L);
      DST(1, 0) = Avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = Avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = Avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
      break;
    }
  }
}
#undef DST

void PutBlock(int v, uint8_t* dst, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

// the 16x16 (size 16) and chroma (size 8) predictors
void PredBig(int mode, uint8_t* dst, int size) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      PutBlock(dc >> (shift + 1), dst, size);
      break;
    }
    case TM_PRED: TrueMotion(dst, size); break;
    case V_PRED:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[-1 + j * BPS], size);
      break;
    case B_DC_PRED_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      PutBlock(dc >> shift, dst, size);
      break;
    }
    case B_DC_PRED_NOLEFT: {
      int dc = size >> 1;
      for (int i = 0; i < size; ++i) dc += dst[i - BPS];
      PutBlock(dc >> shift, dst, size);
      break;
    }
    default: PutBlock(0x80, dst, size); break;  // no top, no left
  }
}

inline int CheckMode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT;
    return mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED;
  }
  return mode;
}

// ---- VP8: loop filters (dsp/dec.c) -----------------------------------------

inline void DoFilter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + SClip1(p1 - q1);
  const int a1 = SClip2((a + 4) >> 3);
  const int a2 = SClip2((a + 3) >> 3);
  p[-step] = Clip1(p0 + a2);
  p[0] = Clip1(q0 - a1);
}

inline void DoFilter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = SClip2((a + 4) >> 3);
  const int a2 = SClip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = Clip1(p1 + a3);
  p[-step] = Clip1(p0 + a2);
  p[0] = Clip1(q0 - a1);
  p[step] = Clip1(q1 - a3);
}

inline void DoFilter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = SClip1(3 * (q0 - p0) + SClip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = Clip1(p2 + a3);
  p[-2 * step] = Clip1(p1 + a2);
  p[-step] = Clip1(p0 + a1);
  p[0] = Clip1(q0 - a1);
  p[step] = Clip1(q1 - a2);
  p[2 * step] = Clip1(q2 - a3);
}

inline bool Hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return Abs(p1 - p0) > thresh || Abs(q1 - q0) > thresh;
}

inline bool NeedsFilter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * Abs(p0 - q0) + Abs(p1 - q1) <= t;
}

inline bool NeedsFilter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * Abs(p0 - q0) + Abs(p1 - q1) > t) return false;
  return Abs(p3 - p2) <= it && Abs(p2 - p1) <= it && Abs(p1 - p0) <= it &&
         Abs(q3 - q2) <= it && Abs(q2 - q1) <= it && Abs(q1 - q0) <= it;
}

// the simple filter across one edge of 16 samples: hstride crosses it
void SimpleFilter16(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i) {
    if (NeedsFilter(p + i * vstride, hstride, thresh2)) DoFilter2(p + i * vstride, hstride);
  }
}

void FilterLoop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (NeedsFilter2(p, hstride, thresh2, ithresh)) {
      if (Hev(p, hstride, hev_thresh)) {
        DoFilter2(p, hstride);
      } else if (mb_edge) {
        DoFilter6(p, hstride);
      } else {
        DoFilter4(p, hstride);
      }
    }
    p += vstride;
  }
}

// ---- VP8: the decoder (vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c) -----

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
};

struct Top {
  uint8_t y[16], u[8], v[8];
};

struct VP8Dec {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  BoolReader parts[8];
  int num_parts_minus_one = 0;
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t segment_probs[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  struct {
    int y1[2], y2[2], uv[2];
  } dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];
};

bool ParseSegmentHeader(VP8Dec* d) {
  BoolReader* br = &d->br;
  d->use_segment = GetValue(br, 1);
  if (d->use_segment) {
    d->update_map = GetValue(br, 1);
    if (GetValue(br, 1)) {
      d->absolute_delta = GetValue(br, 1);
      for (int s = 0; s < 4; ++s) d->quantizer[s] = GetValue(br, 1) ? GetSignedValue(br, 7) : 0;
      for (int s = 0; s < 4; ++s) {
        d->filter_strength[s] = GetValue(br, 1) ? GetSignedValue(br, 6) : 0;
      }
    }
    if (d->update_map) {
      for (int s = 0; s < 3; ++s) {
        d->segment_probs[s] = GetValue(br, 1) ? (uint8_t)GetValue(br, 8) : 255u;
      }
    }
  } else {
    d->update_map = 0;
  }
  return !br->eof;
}

bool ParseFilterHeader(VP8Dec* d) {
  BoolReader* br = &d->br;
  d->simple = GetValue(br, 1);
  d->level = GetValue(br, 6);
  d->sharpness = GetValue(br, 3);
  d->use_lf_delta = GetValue(br, 1);
  if (d->use_lf_delta) {
    if (GetValue(br, 1)) {
      for (int i = 0; i < 4; ++i) {
        if (GetValue(br, 1)) d->ref_lf_delta[i] = GetSignedValue(br, 6);
      }
      for (int i = 0; i < 4; ++i) {
        if (GetValue(br, 1)) d->mode_lf_delta[i] = GetSignedValue(br, 6);
      }
    }
  }
  d->filter_type = d->level == 0 ? 0 : d->simple ? 1 : 2;
  return !br->eof;
}

int ParsePartitions(VP8Dec* d, const uint8_t* buf, size_t size) {
  const uint8_t* sz = buf;
  const uint8_t* buf_end = buf + size;
  d->num_parts_minus_one = (1 << GetValue(&d->br, 2)) - 1;
  const size_t last_part = (size_t)d->num_parts_minus_one;
  if (size < 3 * last_part) return kNotEnough;
  const uint8_t* part_start = buf + last_part * 3;
  size_t size_left = size - last_part * 3;
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    BoolInit(&d->parts[p], part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  BoolInit(&d->parts[last_part], part_start, size_left);
  return part_start < buf_end ? kOk : kNotEnough;
}

inline int ClipQ(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

void ParseQuant(VP8Dec* d) {
  BoolReader* br = &d->br;
  const int base_q0 = GetValue(br, 7);
  const int dqy1_dc = GetValue(br, 1) ? GetSignedValue(br, 4) : 0;
  const int dqy2_dc = GetValue(br, 1) ? GetSignedValue(br, 4) : 0;
  const int dqy2_ac = GetValue(br, 1) ? GetSignedValue(br, 4) : 0;
  const int dquv_dc = GetValue(br, 1) ? GetSignedValue(br, 4) : 0;
  const int dquv_ac = GetValue(br, 1) ? GetSignedValue(br, 4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (d->use_segment) {
      q = d->quantizer[i];
      if (!d->absolute_delta) q += base_q0;
    } else if (i > 0) {
      d->dqm[i] = d->dqm[0];
      continue;
    } else {
      q = base_q0;
    }
    auto& m = d->dqm[i];
    m.y1[0] = kDcTable[ClipQ(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[ClipQ(q, 127)];
    m.y2[0] = kDcTable[ClipQ(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[ClipQ(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[ClipQ(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[ClipQ(q + dquv_ac, 127)];
  }
}

void ParseProba(VP8Dec* d) {
  BoolReader* br = &d->br;
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          d->proba[t][b][c][p] = GetBit(br, kCoeffsUpdateProba[t][b][c][p])
                                     ? (uint8_t)GetValue(br, 8)
                                     : kCoeffsProba0[t][b][c][p];
        }
  d->use_skip_proba = GetValue(br, 1);
  if (d->use_skip_proba) d->skip_p = GetValue(br, 8);
}

void PrecomputeFilterStrengths(VP8Dec* d) {
  if (d->filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (d->use_segment) {
      base_level = d->filter_strength[s];
      if (!d->absolute_delta) base_level += d->level;
    } else {
      base_level = d->level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo* info = &d->fstrengths[s][i4x4];
      int level = base_level;
      if (d->use_lf_delta) {
        level += d->ref_lf_delta[0];
        if (i4x4) level += d->mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (d->sharpness > 0) {
          ilevel >>= d->sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - d->sharpness) ilevel = 9 - d->sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info->ilevel = ilevel;
        info->limit = 2 * level + ilevel;
        info->hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info->limit = 0;
      }
      info->inner = i4x4;
    }
  }
}

void ParseIntraMode(VP8Dec* d, uint8_t* top, uint8_t* left, MBData* block) {
  BoolReader* br = &d->br;
  if (d->update_map) {
    block->segment = !GetBit(br, d->segment_probs[0]) ? GetBit(br, d->segment_probs[1])
                                                      : GetBit(br, d->segment_probs[2]) + 2;
  } else {
    block->segment = 0;
  }
  if (d->use_skip_proba) block->skip = GetBit(br, d->skip_p);
  block->is_i4x4 = !GetBit(br, 145);
  if (!block->is_i4x4) {
    const int ymode = GetBit(br, 156) ? (GetBit(br, 128) ? TM_PRED : H_PRED)
                                      : (GetBit(br, 163) ? V_PRED : DC_PRED);
    block->imodes[0] = (uint8_t)ymode;
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = block->imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        ymode = !GetBit(br, prob[0])   ? B_DC_PRED
                : !GetBit(br, prob[1]) ? B_TM_PRED
                : !GetBit(br, prob[2]) ? B_VE_PRED
                : !GetBit(br, prob[3])
                    ? (!GetBit(br, prob[4]) ? B_HE_PRED
                                            : (!GetBit(br, prob[5]) ? B_RD_PRED : B_VR_PRED))
                    : (!GetBit(br, prob[6])
                           ? B_LD_PRED
                           : (!GetBit(br, prob[7])
                                  ? B_VL_PRED
                                  : (!GetBit(br, prob[8]) ? B_HD_PRED : B_HU_PRED)));
        top[x] = (uint8_t)ymode;
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  block->uvmode = !GetBit(br, 142)   ? DC_PRED
                  : !GetBit(br, 114) ? V_PRED
                  : GetBit(br, 183)  ? TM_PRED
                                     : H_PRED;
}

int GetLargeValue(BoolReader* br, const uint8_t* p) {
  int v;
  if (!GetBit(br, p[3])) {
    if (!GetBit(br, p[4])) {
      v = 2;
    } else {
      v = 3 + GetBit(br, p[5]);
    }
  } else {
    if (!GetBit(br, p[6])) {
      if (!GetBit(br, p[7])) {
        v = 5 + GetBit(br, 159);
      } else {
        v = 7 + 2 * GetBit(br, 165);
        v += GetBit(br, 145);
      }
    } else {
      const int bit1 = GetBit(br, p[8]);
      const int bit0 = GetBit(br, p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + GetBit(br, *tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// GetCoeffs: the tokens of one 4x4 block from coefficient n, dequantised
// into out; the index past the last one read.
int GetCoeffs(BoolReader* br, const uint8_t (*bands)[3][11], int ctx, const int* dq, int n,
              int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!GetBit(br, p[0])) return n;
    while (!GetBit(br, p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t(*p_ctx)[11] = bands[kBands[n + 1]];
    int v;
    if (!GetBit(br, p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = GetLargeValue(br, p);
      p = p_ctx[2];
    }
    out[kZigzag[n]] = (int16_t)(GetSigned(br, v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t NzCodeBits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

struct NzCtx {
  uint8_t nz = 0, nz_dc = 0;
};

// ParseResiduals: whether the macroblock has no non-zero coefficient
bool ParseResiduals(VP8Dec* d, NzCtx* mb, NzCtx* left_mb, BoolReader* br, MBData* block) {
  const auto& q = d->dqm[block->segment];
  int16_t* dst = block->coeffs;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  const uint8_t(*ac_proba)[3][11];
  int first;
  std::memset(dst, 0, 384 * sizeof(*dst));
  if (!block->is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = mb->nz_dc + left_mb->nz_dc;
    const int nz = GetCoeffs(br, d->proba[1], ctx, q.y2, 0, dc);
    mb->nz_dc = left_mb->nz_dc = (nz > 0);
    if (nz > 1) {
      TransformWHT(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_proba = d->proba[0];
  } else {
    first = 0;
    ac_proba = d->proba[3];
  }
  uint8_t tnz = mb->nz & 0x0f, lnz = left_mb->nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = GetCoeffs(br, ac_proba, ctx, q.y1, first, dst);
      l = (nz > first);
      tnz = (uint8_t)((tnz >> 1) | (l << 7));
      nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (uint8_t)((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = (uint8_t)(mb->nz >> (4 + ch));
    lnz = (uint8_t)(left_mb->nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = GetCoeffs(br, d->proba[2], ctx, q.uv, 0, dst);
        l = (nz > 0);
        tnz = (uint8_t)((tnz >> 1) | (l << 3));
        nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (uint8_t)((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (uint32_t)(tnz << 4) << ch;
    out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
  }
  mb->nz = (uint8_t)out_t_nz;
  left_mb->nz = (uint8_t)out_l_nz;
  block->non_zero_y = non_zero_y;
  block->non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                       0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                       0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

// ReconstructRow: one row of macroblocks, predicted from the unfiltered
// samples around each, into the frame's planes
void ReconstructRow(const VP8Dec* d, int mb_y, const MBData* blocks, Top* tops, uint8_t* yuv_b,
                    uint8_t* Y, uint8_t* U, uint8_t* V, int ystride, int uvstride) {
  uint8_t* const y_dst = yuv_b + Y_OFF;
  uint8_t* const u_dst = yuv_b + U_OFF;
  uint8_t* const v_dst = yuv_b + V_OFF;
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
  for (int j = 0; j < 8; ++j) {
    u_dst[j * BPS - 1] = 129;
    v_dst[j * BPS - 1] = 129;
  }
  if (mb_y > 0) {
    y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
  } else {
    std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    std::memset(u_dst - BPS - 1, 127, 8 + 1);
    std::memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < d->mb_w; ++mb_x) {
    const MBData* block = blocks + mb_x;
    if (mb_x > 0) {
      for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
      for (int j = -1; j < 8; ++j) {
        std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
        std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
      }
    }
    Top* const top_yuv = tops + mb_x;
    const int16_t* coeffs = block->coeffs;
    uint32_t bits = block->non_zero_y;
    if (mb_y > 0) {
      std::memcpy(y_dst - BPS, top_yuv[0].y, 16);
      std::memcpy(u_dst - BPS, top_yuv[0].u, 8);
      std::memcpy(v_dst - BPS, top_yuv[0].v, 8);
    }
    if (block->is_i4x4) {
      uint8_t* const top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= d->mb_w - 1) {
          std::memset(top_right, top_yuv[0].y[15], 4);
        } else {
          std::memcpy(top_right, top_yuv[1].y, 4);
        }
      }
      for (int k = 1; k <= 3; ++k) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* const dst = y_dst + kScan[n];
        Pred4(block->imodes[n], dst);
        DoTransform(bits, coeffs + n * 16, dst);
      }
    } else {
      PredBig(CheckMode(mb_x, mb_y, block->imodes[0]), y_dst, 16);
      if (bits != 0) {
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          DoTransform(bits, coeffs + n * 16, y_dst + kScan[n]);
        }
      }
    }
    const uint32_t bits_uv = block->non_zero_uv;
    const int pred_func = CheckMode(mb_x, mb_y, block->uvmode);
    PredBig(pred_func, u_dst, 8);
    PredBig(pred_func, v_dst, 8);
    DoUVTransform(bits_uv >> 0, coeffs + 16 * 16, u_dst);
    DoUVTransform(bits_uv >> 8, coeffs + 20 * 16, v_dst);
    if (mb_y < d->mb_h - 1) {
      std::memcpy(top_yuv[0].y, y_dst + 15 * BPS, 16);
      std::memcpy(top_yuv[0].u, u_dst + 7 * BPS, 8);
      std::memcpy(top_yuv[0].v, v_dst + 7 * BPS, 8);
    }
    uint8_t* const y_out = Y + (size_t)mb_y * 16 * ystride + mb_x * 16;
    uint8_t* const u_out = U + (size_t)mb_y * 8 * uvstride + mb_x * 8;
    uint8_t* const v_out = V + (size_t)mb_y * 8 * uvstride + mb_x * 8;
    for (int j = 0; j < 16; ++j) std::memcpy(y_out + (size_t)j * ystride, y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(u_out + (size_t)j * uvstride, u_dst + j * BPS, 8);
      std::memcpy(v_out + (size_t)j * uvstride, v_dst + j * BPS, 8);
    }
  }
}

// DoFilter: the loop filter of one macroblock, in the frame's planes
void FilterMB(const VP8Dec* d, const FInfo& f, int mb_x, int mb_y, uint8_t* Y, uint8_t* U,
              uint8_t* V, int ystride, int uvstride) {
  const int limit = f.limit;
  if (limit == 0) return;
  uint8_t* const y_dst = Y + (size_t)mb_y * 16 * ystride + mb_x * 16;
  if (d->filter_type == 1) {  // simple
    if (mb_x > 0) SimpleFilter16(y_dst, 1, ystride, limit + 4);
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) SimpleFilter16(y_dst + 4 * k, 1, ystride, limit);
    }
    if (mb_y > 0) SimpleFilter16(y_dst, ystride, 1, limit + 4);
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) SimpleFilter16(y_dst + 4 * k * ystride, ystride, 1, limit);
    }
    return;
  }
  uint8_t* const u_dst = U + (size_t)mb_y * 8 * uvstride + mb_x * 8;
  uint8_t* const v_dst = V + (size_t)mb_y * 8 * uvstride + mb_x * 8;
  const int ilevel = f.ilevel, hev = f.hev_thresh;
  if (mb_x > 0) {
    FilterLoop(y_dst, 1, ystride, 16, limit + 4, ilevel, hev, true);
    FilterLoop(u_dst, 1, uvstride, 8, limit + 4, ilevel, hev, true);
    FilterLoop(v_dst, 1, uvstride, 8, limit + 4, ilevel, hev, true);
  }
  if (f.inner) {
    for (int k = 1; k <= 3; ++k) FilterLoop(y_dst + 4 * k, 1, ystride, 16, limit, ilevel, hev, false);
    FilterLoop(u_dst + 4, 1, uvstride, 8, limit, ilevel, hev, false);
    FilterLoop(v_dst + 4, 1, uvstride, 8, limit, ilevel, hev, false);
  }
  if (mb_y > 0) {
    FilterLoop(y_dst, ystride, 1, 16, limit + 4, ilevel, hev, true);
    FilterLoop(u_dst, uvstride, 1, 8, limit + 4, ilevel, hev, true);
    FilterLoop(v_dst, uvstride, 1, 8, limit + 4, ilevel, hev, true);
  }
  if (f.inner) {
    for (int k = 1; k <= 3; ++k) {
      FilterLoop(y_dst + 4 * k * ystride, ystride, 1, 16, limit, ilevel, hev, false);
    }
    FilterLoop(u_dst + 4 * uvstride, uvstride, 1, 8, limit, ilevel, hev, false);
    FilterLoop(v_dst + 4 * uvstride, uvstride, 1, 8, limit, ilevel, hev, false);
  }
}

// ---- VP8: the output (dsp/yuv.h, dsp/upsampling.c) -------------------------

inline int MultHi(int v, int coeff) { return (v * coeff) >> 8; }
inline int YuvClip8(int v) { return ((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255; }

inline void YuvToRgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = (uint8_t)YuvClip8(MultHi(y, 19077) + MultHi(v, 26149) - 14234);
  rgba[1] = (uint8_t)YuvClip8(MultHi(y, 19077) - MultHi(u, 6419) - MultHi(v, 13320) + 8708);
  rgba[2] = (uint8_t)YuvClip8(MultHi(y, 19077) + MultHi(u, 33050) - 17685);
}

// UPSAMPLE_FUNC: a pair of output rows from their luma and the two chroma
// rows around them (bottom_y nullptr: the top row alone)
void UpsampleLinePair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                      const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                      uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  YuvToRgba(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y != nullptr) {
    YuvToRgba(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    YuvToRgba(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
              top_dst + (2 * x - 1) * 4);
    YuvToRgba(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 4);
    if (bottom_y != nullptr) {
      YuvToRgba(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                bottom_dst + (2 * x - 1) * 4);
      YuvToRgba(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bottom_dst + 2 * x * 4);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    YuvToRgba(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
              top_dst + (len - 1) * 4);
    if (bottom_y != nullptr) {
      YuvToRgba(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                bottom_dst + (len - 1) * 4);
    }
  }
}

// EmitFancyRGB over the whole frame: row 0 alone, then the pairs (1, 2),
// (3, 4), ..., and the last row alone when the height is even
void EmitFancyRgba(const uint8_t* Y, const uint8_t* U, const uint8_t* V, int ystride,
                   int uvstride, int w, int h, uint8_t* rgba, int stride) {
  UpsampleLinePair(Y, nullptr, U, V, U, V, rgba, nullptr, w);
  int y = 1;
  for (; y + 1 < h; y += 2) {
    const int cu = (y + 1) >> 1;
    UpsampleLinePair(Y + (size_t)y * ystride, Y + (size_t)(y + 1) * ystride,
                     U + (size_t)(cu - 1) * uvstride, V + (size_t)(cu - 1) * uvstride,
                     U + (size_t)cu * uvstride, V + (size_t)cu * uvstride,
                     rgba + (size_t)y * stride, rgba + (size_t)(y + 1) * stride, w);
  }
  if (y < h) {  // an even height leaves its last row
    const int cu = y >> 1;
    UpsampleLinePair(Y + (size_t)y * ystride, nullptr, U + (size_t)cu * uvstride,
                     V + (size_t)cu * uvstride, U + (size_t)cu * uvstride,
                     V + (size_t)cu * uvstride, rgba + (size_t)y * stride, nullptr, w);
  }
}

// VP8GetHeaders, VP8Decode and the output of one frame into rgba
// stats (nullable): [0] simple filter, [1] filter level, [2] sharpness,
// [3] segments on, [4] segment map coded, [5] token partitions, [6] the
// segments the macroblocks use (a bit each), [7] 4x4 macroblocks, [8]
// macroblocks with the skip flag
int DecodeVP8(const uint8_t* data, size_t size, int w, int h, uint8_t* rgba, int stride,
              int* stats) {
  VP8Dec d;
  const uint8_t* buf = data;
  size_t buf_size = size;
  if (buf_size < 4) return kNotEnough;
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3) return kBitstream;
  if (!show) return kUnsupported;
  buf += 3;
  buf_size -= 3;
  if (!key_frame) return kUnsupported;
  if (buf_size < 7) return kNotEnough;
  if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) return kBitstream;
  d.width = ((buf[4] << 8) | buf[3]) & 0x3fff;
  d.height = ((buf[6] << 8) | buf[5]) & 0x3fff;
  buf += 7;
  buf_size -= 7;
  if (d.width != w || d.height != h) return kBitstream;
  d.mb_w = (d.width + 15) >> 4;
  d.mb_h = (d.height + 15) >> 4;
  if (partition_length > buf_size) return kNotEnough;
  BoolInit(&d.br, buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;
  GetValue(&d.br, 1);  // colour space
  GetValue(&d.br, 1);  // clamping type
  if (!ParseSegmentHeader(&d)) return kBitstream;
  if (!ParseFilterHeader(&d)) return kBitstream;
  const int status = ParsePartitions(&d, buf, buf_size);
  if (status != kOk) return status;
  ParseQuant(&d);
  GetValue(&d.br, 1);  // update_proba, ignored
  ParseProba(&d);
  PrecomputeFilterStrengths(&d);
  if (stats != nullptr) {
    stats[0] = d.simple;
    stats[1] = d.level;
    stats[2] = d.sharpness;
    stats[3] = d.use_segment;
    stats[4] = d.update_map;
    stats[5] = d.num_parts_minus_one + 1;
    stats[6] = stats[7] = stats[8] = 0;
  }

  const int ystride = d.mb_w * 16, uvstride = d.mb_w * 8;
  std::vector<uint8_t> Y((size_t)ystride * d.mb_h * 16), U((size_t)uvstride * d.mb_h * 8),
      V((size_t)uvstride * d.mb_h * 8);
  std::vector<MBData> blocks(d.mb_w);
  std::vector<FInfo> finfo(d.mb_w);
  std::vector<Top> tops(d.mb_w);
  std::vector<uint8_t> intra_t(4 * d.mb_w, B_DC_PRED);
  std::vector<NzCtx> nz(d.mb_w + 1);  // nz[0]: the left macroblock's
  std::vector<uint8_t> yuv_b(YUV_SIZE, 0);
  for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
    BoolReader* token_br = &d.parts[mb_y & d.num_parts_minus_one];
    uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      blocks[mb_x].skip = 0;
      ParseIntraMode(&d, &intra_t[4 * mb_x], intra_l, &blocks[mb_x]);
    }
    if (d.br.eof) return kNotEnough;
    nz[0] = NzCtx();
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      MBData* block = &blocks[mb_x];
      NzCtx* left = &nz[0];
      NzCtx* mb = &nz[1 + mb_x];
      int skip = d.use_skip_proba ? block->skip : 0;
      if (stats != nullptr) {
        stats[6] |= 1 << block->segment;
        stats[7] += block->is_i4x4;
        stats[8] += skip;
      }
      if (!skip) {
        skip = ParseResiduals(&d, mb, left, token_br, block);
      } else {
        left->nz = mb->nz = 0;
        if (!block->is_i4x4) left->nz_dc = mb->nz_dc = 0;
        block->non_zero_y = 0;
        block->non_zero_uv = 0;
      }
      if (d.filter_type > 0) {
        finfo[mb_x] = d.fstrengths[block->segment][block->is_i4x4];
        finfo[mb_x].inner |= !skip;
      }
      if (token_br->eof) return kNotEnough;
    }
    ReconstructRow(&d, mb_y, blocks.data(), tops.data(), yuv_b.data(), Y.data(), U.data(),
                   V.data(), ystride, uvstride);
    if (d.filter_type > 0) {
      for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
        FilterMB(&d, finfo[mb_x], mb_x, mb_y, Y.data(), U.data(), V.data(), ystride, uvstride);
      }
    }
  }
  EmitFancyRgba(Y.data(), U.data(), V.data(), ystride, uvstride, w, h, rgba, stride);
  return kOk;
}

}  // namespace

extern "C" {

int webp_vp8l_decode(const uint8_t* data, size_t len, int w, int h, uint8_t* rgba,
                     int stride) {
  LDec dec;
  LInit(&dec.br, data, len);
  LBitReader* br = &dec.br;
  if (LReadBits(br, 8) != 0x2f) return kBitstream;
  const int width = (int)LReadBits(br, 14) + 1;
  const int height = (int)LReadBits(br, 14) + 1;
  LReadBits(br, 1);  // alpha is used
  if (LReadBits(br, 3) != 0) return kBitstream;
  if (br->eos || width != w || height != h) return kBitstream;
  if (!DecodeImageStream(width, height, true, &dec, nullptr)) return kBitstream;
  std::vector<uint32_t> argb;
  if (!DecodeArgb(&dec, height, &argb)) return kBitstream;
  for (int y = 0; y < height; ++y) {
    const uint32_t* src = argb.data() + (size_t)y * width;
    uint8_t* dst = rgba + (size_t)y * stride;
    for (int x = 0; x < width; ++x) {
      const uint32_t p = src[x];
      dst[4 * x + 0] = (uint8_t)(p >> 16);
      dst[4 * x + 1] = (uint8_t)(p >> 8);
      dst[4 * x + 2] = (uint8_t)p;
      dst[4 * x + 3] = (uint8_t)(p >> 24);
    }
  }
  return kOk;
}

int webp_vp8_decode(const uint8_t* data, size_t len, const uint8_t* alph, size_t alph_len,
                    int w, int h, uint8_t* rgba, int stride) {
  const int status = DecodeVP8(data, len, w, h, rgba, stride, nullptr);
  if (status != kOk) return status;
  if (alph == nullptr) {
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) rgba[(size_t)y * stride + 4 * x + 3] = 255;
    return kOk;
  }
  std::vector<uint8_t> alpha((size_t)w * h);
  if (!DecodeAlpha(alph, alph_len, w, h, alpha.data())) return kBitstream;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) rgba[(size_t)y * stride + 4 * x + 3] = alpha[(size_t)y * w + x];
  return kOk;
}

// What a stream holds, for tests. VP8L: [0] transforms, [1..4] their
// types in stream order, [5] palette colours, [6] colour cache bits, [7]
// meta prefix code bits (0: none), [8] prefix code groups. VP8: DecodeVP8's
// stats. Returns the decode's status.
int webp_vp8l_info(const uint8_t* data, size_t len, int* info) {
  LDec dec;
  LInit(&dec.br, data, len);
  LBitReader* br = &dec.br;
  if (LReadBits(br, 8) != 0x2f) return kBitstream;
  const int width = (int)LReadBits(br, 14) + 1;
  const int height = (int)LReadBits(br, 14) + 1;
  LReadBits(br, 4);
  if (!DecodeImageStream(width, height, true, &dec, nullptr)) return kBitstream;
  info[0] = dec.ntrans;
  info[5] = 0;
  for (int i = 0; i < 4; ++i) {
    info[1 + i] = i < dec.ntrans ? dec.tr[i].type : -1;
    if (i < dec.ntrans && dec.tr[i].type == kColorIndexing) info[5] = dec.tr[i].num_colors;
  }
  info[6] = dec.hdr.cache_bits;
  info[7] = dec.hdr.huffman_bits;
  info[8] = (int)dec.hdr.groups.size();
  return kOk;
}

int webp_vp8_info(const uint8_t* data, size_t len, int w, int h, int* info) {
  std::vector<uint8_t> rgba((size_t)w * h * 4);
  return DecodeVP8(data, len, w, h, rgba.data(), w * 4, info);
}

}  // extern "C"
