// artraw: host-side raw decoder for the ART-TPU framework.
//
// Scope (ARCHITECTURE.md / SURVEY §7 decision 2): the formats named by the
// build plan — DNG (TIFF/EP container: uncompressed, bit-packed and
// lossless-JPEG LJ92/ITU-T81-process-14 payloads), Canon CR2 (sliced
// lossless JPEG + MakerNote SensorInfo/ColorData), Nikon NEF (lossless
// type-2 bitstream + MakerNote linearization header), and classic Fuji
// RAF (big-endian container, CFA-header records, uncompressed
// X-Trans/Bayer payloads) — decoded natively on host and handed to the device pipeline
// as a float32 CFA plane plus levels/matrices/WB metadata. Other camera
// formats route through DNG conversion or external preconverters, the
// same escape hatch the reference exposes (rtengine/imgiomanager.h).
// This replaces the dcraw.cc role (reference rtengine/dcraw.cc) for the
// supported scope; it is a fresh implementation from the TIFF6/DNG/
// JPEG-lossless/public-CR2/RAF specs, not a dcraw derivative.
//
// C ABI for ctypes. Thread-safe (no globals).
//
// Build: make -C art_tpu/io/native

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>
#include <vector>
#include <string>
#include <algorithm>
#include <atomic>
#include <functional>
#include <thread>

namespace {

// ---------------------------------------------------------------------------
// byte readers
// ---------------------------------------------------------------------------

struct Reader {
    const uint8_t* buf;
    size_t len;
    bool little;

    uint16_t u16(size_t off) const {
        if (off + 2 > len) return 0;
        return little ? (uint16_t)(buf[off] | buf[off + 1] << 8)
                      : (uint16_t)(buf[off] << 8 | buf[off + 1]);
    }
    uint32_t u32(size_t off) const {
        if (off + 4 > len) return 0;
        return little
            ? (uint32_t)buf[off] | (uint32_t)buf[off + 1] << 8 |
              (uint32_t)buf[off + 2] << 16 | (uint32_t)buf[off + 3] << 24
            : (uint32_t)buf[off] << 24 | (uint32_t)buf[off + 1] << 16 |
              (uint32_t)buf[off + 2] << 8 | (uint32_t)buf[off + 3];
    }
};

// TIFF tag value: we normalize everything to double / string
struct TagValue {
    std::vector<double> nums;
    std::string str;
    uint16_t type = 0;
    uint32_t count = 0;
    size_t off = 0;  // file offset of the value (for nested blobs)
};

struct IFD {
    // tag -> value
    std::vector<std::pair<uint16_t, TagValue>> tags;
    const TagValue* find(uint16_t tag) const {
        for (auto& kv : tags)
            if (kv.first == tag) return &kv.second;
        return nullptr;
    }
    double num(uint16_t tag, double dflt, size_t idx = 0) const {
        const TagValue* v = find(tag);
        if (!v || idx >= v->nums.size()) return dflt;
        return v->nums[idx];
    }
};

static size_t type_size(uint16_t t) {
    switch (t) {
        case 1: case 2: case 6: case 7: return 1;
        case 3: case 8: return 2;
        case 4: case 9: case 11: return 4;
        case 5: case 10: case 12: return 8;
        default: return 1;
    }
}

static void parse_ifd(const Reader& r, size_t off, IFD& out,
                      std::vector<uint32_t>& sub_offsets, int depth);

static TagValue read_tag_value(const Reader& r, uint16_t type, uint32_t count,
                               size_t voff) {
    TagValue tv;
    tv.type = type;
    tv.count = count;
    tv.off = voff;
    size_t esz = type_size(type);
    if (type == 7 && count > 64) return tv;  // opaque blob: keep offset only
    for (uint32_t i = 0; i < count && i < (1u << 22); ++i) {
        size_t o = voff + i * esz;
        if (o + esz > r.len) break;
        switch (type) {
            case 1: case 7: tv.nums.push_back(r.buf[o]); break;
            case 2: tv.str.push_back((char)r.buf[o]); break;
            case 3: tv.nums.push_back(r.u16(o)); break;
            case 4: tv.nums.push_back(r.u32(o)); break;
            case 6: tv.nums.push_back((int8_t)r.buf[o]); break;
            case 8: tv.nums.push_back((int16_t)r.u16(o)); break;
            case 9: tv.nums.push_back((int32_t)r.u32(o)); break;
            case 5: {
                uint32_t n = r.u32(o), d = r.u32(o + 4);
                tv.nums.push_back(d ? (double)n / d : 0.0);
                break;
            }
            case 10: {
                int32_t n = (int32_t)r.u32(o), d = (int32_t)r.u32(o + 4);
                tv.nums.push_back(d ? (double)n / d : 0.0);
                break;
            }
            case 11: {
                uint32_t b = r.u32(o);
                float f;
                memcpy(&f, &b, 4);
                tv.nums.push_back(f);
                break;
            }
            case 12: {
                uint64_t b = (uint64_t)r.u32(o) |
                             ((uint64_t)r.u32(o + 4) << 32);
                if (!r.little)
                    b = ((uint64_t)r.u32(o) << 32) | r.u32(o + 4);
                double d;
                memcpy(&d, &b, 8);
                tv.nums.push_back(d);
                break;
            }
            default: break;
        }
    }
    return tv;
}

static void parse_ifd(const Reader& r, size_t off, IFD& out,
                      std::vector<uint32_t>& sub_offsets, int depth) {
    if (depth > 4 || off + 2 > r.len) return;
    uint16_t n = r.u16(off);
    if (n > 1024) return;
    for (uint16_t i = 0; i < n; ++i) {
        size_t e = off + 2 + (size_t)i * 12;
        if (e + 12 > r.len) break;
        uint16_t tag = r.u16(e);
        uint16_t type = r.u16(e + 2);
        uint32_t count = r.u32(e + 4);
        size_t total = (size_t)count * type_size(type);
        size_t voff = (total <= 4) ? e + 8 : r.u32(e + 8);
        TagValue tv = read_tag_value(r, type, count, voff);
        if (tag == 330 /*SubIFDs*/ || tag == 34665 /*EXIF IFD*/) {
            for (double d : tv.nums) sub_offsets.push_back((uint32_t)d);
        }
        out.tags.emplace_back(tag, std::move(tv));
    }
}

// ---------------------------------------------------------------------------
// LJ92 (lossless JPEG, ITU-T81 process 14, SOF3) decoder
// ---------------------------------------------------------------------------

struct HuffTable {
    // decode table: maxcode/mincode/valptr per length
    int32_t mincode[17];
    int32_t maxcode[18];
    int32_t valptr[17];
    uint8_t vals[256];
    // 8-bit-lookahead fast path: lut_len[peek8] = code length (0 =
    // code longer than 8 bits, take the canonical walk)
    uint8_t lut_len[256] = {};
    uint8_t lut_val[256] = {};
    // 16-bit-lookahead combined symbol+magnitude LUT (LJ92 scan only):
    // fast16[peek16] = consumed_bits << 16 | (uint16)diff; 0 = slow
    // path (one 256KB array keeps the lookup a single cache access)
    std::vector<int32_t> fast16;
    bool valid = false;
};

// Fill the 8-bit fast-decode LUT from the canonical tables (codes of
// length <= 8 cover virtually every symbol in real raw streams).
static void build_hufflut(HuffTable& h) {
    for (int l = 1; l <= 8; ++l) {
        for (int code = h.mincode[l]; code <= h.maxcode[l]; ++code) {
            uint8_t val = h.vals[h.valptr[l] + code - h.mincode[l]];
            int base = code << (8 - l);
            for (int j = 0; j < (1 << (8 - l)); ++j) {
                h.lut_len[base + j] = (uint8_t)l;
                h.lut_val[base + j] = val;
            }
        }
    }
}

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t bits = 0;  // top-aligned at bit 63
    int nbits = 0;
    bool eof = false;

    BitReader(const uint8_t* p_, const uint8_t* e_) : p(p_), end(e_) {}

    void fill() {
        while (nbits <= 48) {
            if (p >= end) {
                eof = true;
                nbits += 8; // feed zeros
                continue;
            }
            uint8_t b = *p++;
            if (b == 0xFF) {
                if (p < end && *p == 0x00) {
                    ++p; // stuffed byte
                } else {
                    // marker: stop (DNL or EOI); feed zeros
                    --p;
                    eof = true;
                    nbits += 8;
                    continue;
                }
            }
            bits |= (uint64_t)b << (56 - nbits);
            nbits += 8;
        }
    }
    int get(int n) {
        if (n == 0) return 0;
        if (nbits < n) fill();
        int v = (int)(bits >> (64 - n));
        bits <<= n;
        nbits -= n;
        return v;
    }
    int peek(int n) {
        if (nbits < n) fill();
        return (int)(bits >> (64 - n));
    }
    void skip(int n) {
        bits <<= n;
        nbits -= n;
    }
};

static int huff_decode(BitReader& br, const HuffTable& h) {
    int code = br.get(1);
    int l = 1;
    while (l <= 16 && code > h.maxcode[l]) {
        code = (code << 1) | br.get(1);
        ++l;
    }
    if (l > 16) return -1;
    return h.vals[h.valptr[l] + code - h.mincode[l]];
}

// Combined symbol+magnitude table over a 16-bit lookahead: one peek
// decodes both the SSSS category and its extend()ed difference when
// code_len + ssss <= 16 (the overwhelmingly common case).
static void build_hufflut16(HuffTable& h) {
    h.fast16.assign(65536, 0);
    for (int idx = 0; idx < 65536; ++idx) {
        int top8 = idx >> 8;
        int l = h.lut_len[top8];
        if (!l) continue;
        int t = h.lut_val[top8];
        if (t == 0) {
            h.fast16[idx] = l << 16;
            continue;
        }
        if (t >= 16 || l + t > 16) continue;  // slow path
        int mag = (idx >> (16 - l - t)) & ((1 << t) - 1);
        int diff = (mag < (1 << (t - 1))) ? mag - (1 << t) + 1 : mag;
        h.fast16[idx] = ((l + t) << 16) | (uint16_t)(int16_t)diff;
    }
}

static inline int huff_decode_fast(BitReader& br, const HuffTable& h) {
    int idx = br.peek(8);
    int l = h.lut_len[idx];
    if (l) {
        br.skip(l);
        return h.lut_val[idx];
    }
    return huff_decode(br, h);
}

static int extend(int v, int t) {
    // sign-extend a t-bit magnitude (ITU-T81 F.2.2.1)
    if (t == 0) return 0;
    return (v < (1 << (t - 1))) ? v - (1 << t) + 1 : v;
}

struct LJ92 {
    int width = 0, height = 0, precision = 0, components = 0;
    int pred = 1, pt = 0;
    HuffTable tables[4];
    int comp_tbl[4] = {0, 0, 0, 0};
    const uint8_t* scan_start = nullptr;
    const uint8_t* data_end = nullptr;
    int restart_interval = 0;

    // parse headers; returns false on failure
    bool parse(const uint8_t* buf, size_t len) {
        if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return false;
        size_t off = 2;
        while (off + 4 <= len) {
            if (buf[off] != 0xFF) return false;
            uint8_t marker = buf[off + 1];
            if (marker == 0xD8) { off += 2; continue; }
            uint16_t seglen = (uint16_t)(buf[off + 2] << 8 | buf[off + 3]);
            // the declared segment must fit inside the buffer (corrupt
            // lengths otherwise put seg reads / scan_start out of bounds)
            if (seglen < 2 || off + 2 + (size_t)seglen > len) return false;
            const uint8_t* seg = buf + off + 4;
            switch (marker) {
                case 0xC3: { // SOF3
                    if (seglen < 8) return false;
                    precision = seg[0];
                    height = seg[1] << 8 | seg[2];
                    width = seg[3] << 8 | seg[4];
                    components = seg[5];
                    for (int c = 0; c < components && c < 4; ++c) {
                        // id, sampling, tq — sampling must be 1x1 for ljpeg
                    }
                    break;
                }
                case 0xC4: { // DHT
                    const uint8_t* q = seg;
                    const uint8_t* qe = seg + seglen - 2;
                    while (q < qe) {
                        if (qe - q < 17) return false;
                        int tc_th = *q++;
                        int th = tc_th & 15;
                        if (th > 3) return false;
                        HuffTable& h = tables[th];
                        uint8_t counts[17];
                        int total = 0;
                        for (int i = 1; i <= 16; ++i) {
                            counts[i] = *q++;
                            total += counts[i];
                        }
                        if (total > 256 || qe - q < total) return false;
                        for (int i = 0; i < total; ++i) h.vals[i] = *q++;
                        // build decode tables (ITU-T81 C.2)
                        int code = 0, k = 0;
                        for (int l = 1; l <= 16; ++l) {
                            h.valptr[l] = k;
                            h.mincode[l] = code;
                            code += counts[l];
                            k += counts[l];
                            h.maxcode[l] = counts[l] ? code - 1 : -1;
                            code <<= 1;
                        }
                        h.maxcode[17] = 0x7FFFFFFF;
                        build_hufflut(h);
                        build_hufflut16(h);
                        h.valid = true;
                    }
                    break;
                }
                case 0xDD: // DRI
                    if (seglen < 4) return false;
                    restart_interval = seg[0] << 8 | seg[1];
                    break;
                case 0xDA: { // SOS
                    if (seglen < 3) return false;
                    int ns = seg[0];
                    if (ns < 1 || ns > 4 || seglen < 6 + 2 * ns)
                        return false;
                    for (int c = 0; c < ns && c < 4; ++c) {
                        comp_tbl[c] = seg[1 + 2 * c + 1] >> 4;
                    }
                    pred = seg[1 + 2 * ns];     // Ss = predictor
                    pt = seg[3 + 2 * ns] & 15;  // Al = point transform
                    scan_start = seg + seglen - 2;
                    data_end = buf + len;
                    return width > 0 && height > 0;
                }
                case 0xD9: // EOI
                    return false;
                default:
                    break;
            }
            off += 2 + seglen;
        }
        return false;
    }

    // decode into out[row * width * components + col * components + c]
    bool decode(uint16_t* out) {
        if (!scan_start) return false;
        // header sanity (corrupt SOF3 fields otherwise reach UB shifts
        // and the 4-entry comp_tbl/tables arrays)
        if (precision < 1 || precision > 16 || pt < 0 || pt >= precision ||
            components < 1 || components > 4)
            return false;
        BitReader br(scan_start, data_end);
        int nc = components;
        std::vector<int> prev_row((size_t)width * nc, 0);
        std::vector<int> cur_row((size_t)width * nc, 0);
        int default_val = 1 << (precision - pt - 1);
        int maxval = (1 << precision) - 1;
        int rst_count = 0;

        for (int c = 0; c < nc; ++c)
            if (!tables[comp_tbl[c]].valid) return false;

        // fast path for the dominant DNG shape: one component,
        // left-predictor scan, no restart markers. Only the previous
        // row's first value is live (col 0 predicts from above), so no
        // row buffers; the combined 16-bit LUT decodes symbol +
        // difference in one lookup.
        if (nc == 1 && pred == 1 && restart_interval == 0) {
            const HuffTable& h = tables[comp_tbl[0]];
            const int32_t* ft = h.fast16.data();
            int rowstart = 0;
            for (int row = 0; row < height; ++row) {
                uint16_t* orow = out + (size_t)row * width;
                int val = 0;
                for (int col = 0; col < width; ++col) {
                    int diff;
                    int e = ft[br.peek(16)];
                    if (e) {
                        br.skip(e >> 16);
                        diff = (int16_t)e;
                    } else {
                        int t = huff_decode_fast(br, h);
                        if (t < 0) return false;
                        if (t == 16) {
                            diff = 32768;
                        } else {
                            diff = extend(br.get(t), t);
                        }
                    }
                    int px;
                    if (col > 0) {
                        px = val;
                    } else if (row > 0) {
                        px = rowstart;
                    } else {
                        px = default_val;
                    }
                    val = (px + diff) & 0xFFFF;
                    if (col == 0) rowstart = val;
                    orow[col] =
                        (uint16_t)(std::min(val << pt, maxval << pt));
                }
            }
            return true;
        }

        for (int row = 0; row < height; ++row) {
            for (int col = 0; col < width; ++col) {
                for (int c = 0; c < nc; ++c) {
                    const HuffTable& h = tables[comp_tbl[c]];
                    if (!h.valid) return false;
                    int t = huff_decode_fast(br, h);
                    if (t < 0) return false;
                    int diff;
                    if (t == 16) {
                        diff = 32768;
                    } else {
                        int v = br.get(t);
                        diff = extend(v, t);
                    }
                    int Ra = (col > 0) ? cur_row[(size_t)(col - 1) * nc + c]
                                       : 0;
                    int Rb = (row > 0) ? prev_row[(size_t)col * nc + c] : 0;
                    int Rc = (row > 0 && col > 0)
                                 ? prev_row[(size_t)(col - 1) * nc + c]
                                 : 0;
                    int px;
                    if (row == 0 && col == 0) {
                        px = default_val;
                    } else if (row == 0) {
                        px = Ra;
                    } else if (col == 0) {
                        px = Rb;
                    } else {
                        switch (pred) {
                            case 1: px = Ra; break;
                            case 2: px = Rb; break;
                            case 3: px = Rc; break;
                            case 4: px = Ra + Rb - Rc; break;
                            case 5: px = Ra + ((Rb - Rc) >> 1); break;
                            case 6: px = Rb + ((Ra - Rc) >> 1); break;
                            case 7: px = (Ra + Rb) >> 1; break;
                            default: px = Ra; break;
                        }
                    }
                    int val = (px + diff) & 0xFFFF;
                    cur_row[(size_t)col * nc + c] = val;
                    out[((size_t)row * width + col) * nc + c] =
                        (uint16_t)(std::min(val << pt, maxval << pt));
                }
            }
            std::swap(prev_row, cur_row);
            if (restart_interval && ++rst_count == restart_interval &&
                row + 1 < height) {
                rst_count = 0;
                // resync: skip to marker, reset bit reader + predictors
                // (rare in DNG; minimal support)
            }
        }
        return true;
    }
};

// ---------------------------------------------------------------------------
// bit-packed unpacking (uncompressed DNG with BitsPerSample 10/12/14)
// ---------------------------------------------------------------------------

static void unpack_bits(const uint8_t* src, size_t src_len, uint16_t* dst,
                        size_t count, int bps, bool msb_first = true) {
    if (bps == 8) {
        for (size_t i = 0; i < count && i < src_len; ++i) dst[i] = src[i];
        return;
    }
    if (bps == 16) {
        // TIFF byte order handled by caller for 16-bit
        return;
    }
    uint64_t acc = 0;
    int nbits = 0;
    size_t si = 0, di = 0;
    while (di < count) {
        while (nbits < bps && si < src_len) {
            acc = (acc << 8) | src[si++];
            nbits += 8;
        }
        if (nbits < bps) break;
        dst[di++] = (uint16_t)((acc >> (nbits - bps)) & ((1u << bps) - 1));
        nbits -= bps;
        acc &= (nbits ? ((1ull << nbits) - 1) : 0);
    }
}

} // namespace

// ---------------------------------------------------------------------------
// public C ABI
// ---------------------------------------------------------------------------

extern "C" {

struct ArtRawMeta {
    int32_t width, height;
    int32_t cfa_pattern[4];   // 2x2 colors 0=R 1=G 2=B; -1 if not CFA
    double black[4];
    double white[4];
    double as_shot_neutral[3];  // camera-space neutral (1/wb gains); 0 if n/a
    double color_matrix1[9];    // XYZ->cam
    double color_matrix2[9];
    int32_t has_cm1, has_cm2;
    int32_t illuminant1, illuminant2;
    double baseline_exposure;
    double iso;
    int32_t orientation;
    int32_t active_area[4];  // top,left,bottom,right; -1 if absent
    int32_t crop[4];         // x,y,w,h (DefaultCropOrigin/Size); -1 absent
    int32_t xtrans[36];      // 6x6 X-Trans pattern row-major; [0]=-1 if n/a
    char make[64];
    char model[64];
    int32_t channels;        // 0/1 = mosaic or gray; 3 = Foveon planes
};

// Decode a DNG buffer. On success fills meta and returns a malloc'd
// uint16 image (caller frees via artraw_free); returns nullptr on failure.
// Writes the raw (mosaic) IFD image, in raw coordinates.
uint16_t* artraw_decode_dng(const uint8_t* buf, size_t len, ArtRawMeta* meta);
void artraw_free(uint16_t* p) { free(p); }

// ---------------------------------------------------------------------------
// Strip/tile-parallel decode (the reference parallelizes multi-frame
// decode, rawimagesource.cc:1285-1308; here the independent units are
// the strips/tiles/row-streams within one frame). Thread count from
// ART_TPU_DECODE_THREADS (default: hardware concurrency, cap 16).
// Returns true iff every chunk decoded cleanly.
// ---------------------------------------------------------------------------
static int decode_threads() {
    static int n = [] {
        const char* e = getenv("ART_TPU_DECODE_THREADS");
        int v = e ? atoi(e) : (int)std::thread::hardware_concurrency();
        if (v < 1) v = 1;
        if (v > 16) v = 16;
        return v;
    }();
    return n;
}

static bool parallel_chunks(size_t n, const std::function<bool(size_t)>& fn) {
    int nt = decode_threads();
    if (n <= 1 || nt <= 1) {
        for (size_t i = 0; i < n; ++i)
            if (!fn(i)) return false;
        return true;
    }
    if ((size_t)nt > n) nt = (int)n;
    std::atomic<size_t> next(0);
    std::atomic<bool> ok(true);
    auto work = [&] {
        for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= n || !ok.load(std::memory_order_relaxed)) return;
            if (!fn(i)) ok.store(false, std::memory_order_relaxed);
        }
    };
    std::vector<std::thread> ts;
    for (int t = 1; t < nt; ++t) ts.emplace_back(work);
    work();
    for (auto& t : ts) t.join();
    return ok.load();
}

static bool decode_strips_tiles(const Reader& r, const IFD& ifd, int width,
                                int height, int bps, int spp,
                                int compression, uint16_t* out) {
    const TagValue* tile_off = ifd.find(324);
    const TagValue* tile_cnt = ifd.find(325);
    size_t pixcount = (size_t)width * height * spp;

    if (tile_off && tile_cnt) {
        int tw = (int)ifd.num(322, width);
        int th = (int)ifd.num(323, height);
        if (tw <= 0 || th <= 0 || tw > 65535 || th > 65535) return false;
        int tiles_x = (width + tw - 1) / tw;
        // tiles decode to disjoint output rects: strip/tile-parallel
        return parallel_chunks(tile_off->nums.size(), [&](size_t t) {
            size_t off = (size_t)tile_off->nums[t];
            size_t cnt = t < tile_cnt->nums.size()
                             ? (size_t)tile_cnt->nums[t] : 0;
            if (off + cnt > r.len) return false;
            int tx = (int)(t % tiles_x) * tw;
            int ty = (int)(t / tiles_x) * th;
            std::vector<uint16_t> tilebuf((size_t)tw * th * spp);
            if (compression == 7) {
                LJ92 lj;
                if (!lj.parse(r.buf + off, cnt)) return false;
                // LJ92 components may span the tile width (e.g. 2 comps,
                // each half-width)
                size_t n = (size_t)lj.width * lj.height * lj.components;
                if (n != (size_t)tw * th * spp) {
                    // component interleave = columns: common DNG layout
                    if ((size_t)lj.width * lj.components != (size_t)tw * spp ||
                        lj.height != th) {
                        // accept anyway if total matches
                        if (n != (size_t)tw * th * spp) return false;
                    }
                }
                if (!lj.decode(tilebuf.data())) return false;
            } else if (compression == 1) {
                if (bps == 16) {
                    for (size_t i = 0; i < (size_t)tw * th * spp; ++i)
                        tilebuf[i] = r.u16(off + 2 * i);
                } else {
                    unpack_bits(r.buf + off, cnt, tilebuf.data(),
                                (size_t)tw * th * spp, bps);
                }
            } else {
                return false;
            }
            // blit into out
            for (int y = 0; y < th && ty + y < height; ++y) {
                int copy_w = std::min(tw, width - tx);
                if (copy_w <= 0) continue;
                memcpy(out + ((size_t)(ty + y) * width + tx) * spp,
                       tilebuf.data() + (size_t)y * tw * spp,
                       (size_t)copy_w * spp * sizeof(uint16_t));
            }
            return true;
        });
    }

    const TagValue* strip_off = ifd.find(273);
    const TagValue* strip_cnt = ifd.find(279);
    if (!strip_off) return false;
    int rps = (int)ifd.num(278, height);
    if (compression == 7) {
        // one independent LJ92 stream per strip; strip s starts at row
        // s * rps — strip-parallel
        if (rps <= 0) return false;
        return parallel_chunks(strip_off->nums.size(), [&](size_t s) {
            size_t row0 = s * (size_t)rps;
            if (row0 >= (size_t)height) return true;  // trailing entries
            size_t off = (size_t)strip_off->nums[s];
            if (off >= r.len) return false;
            size_t cnt = strip_cnt && s < strip_cnt->nums.size()
                             ? (size_t)strip_cnt->nums[s]
                             : r.len - off;
            if (cnt > r.len - off) cnt = r.len - off;
            LJ92 lj;
            if (!lj.parse(r.buf + off, cnt)) return false;
            size_t sn = (size_t)lj.width * lj.height * lj.components;
            if (sn == 0 || sn > ((size_t)1 << 28)) return false;
            std::vector<uint16_t> sbuf(sn);
            if (!lj.decode(sbuf.data())) return false;
            size_t rows = std::min((size_t)rps, (size_t)height - row0);
            size_t need = (size_t)width * rows * spp;
            memcpy(out + row0 * width * spp, sbuf.data(),
                   std::min(need, sbuf.size()) * sizeof(uint16_t));
            return true;
        });
    }
    if (compression != 1) return false;
    int row0 = 0;
    for (size_t s = 0; s < strip_off->nums.size() && row0 < height; ++s) {
        size_t off = (size_t)strip_off->nums[s];
        size_t rows = std::min((size_t)rps, (size_t)(height - row0));
        size_t n = (size_t)width * rows * spp;
        size_t cnt = strip_cnt && s < strip_cnt->nums.size()
                         ? (size_t)strip_cnt->nums[s]
                         : r.len - off;
        if (bps == 16) {
            for (size_t i = 0; i < n; ++i)
                out[(size_t)row0 * width * spp + i] = r.u16(off + 2 * i);
        } else {
            unpack_bits(r.buf + off, cnt,
                        out + (size_t)row0 * width * spp, n, bps);
        }
        row0 += (int)rows;
    }
    return true;
}

// ---------------------------------------------------------------------------
// Canon CR2 (reference decode boundary: rtengine/dcraw.cc lossless JPEG +
// cr2 slices; fresh implementation from the TIFF6/ITU-T81 specs and the
// public CR2 format description)
// ---------------------------------------------------------------------------

static uint16_t* decode_cr2(const Reader& r, const std::vector<IFD>& ifds,
                            ArtRawMeta* meta) {
    // raw IFD: the one carrying the cr2 slice tag or the largest
    // compression-6 strip
    const IFD* raw = nullptr;
    for (auto& ifd : ifds) {
        if (ifd.find(0xC640)) { raw = &ifd; break; }
    }
    if (!raw) {
        size_t best = 0;
        for (auto& ifd : ifds) {
            const TagValue* sc = ifd.find(279);
            if ((int)ifd.num(259, 0) == 6 && sc && !sc->nums.empty() &&
                (size_t)sc->nums[0] > best) {
                best = (size_t)sc->nums[0];
                raw = &ifd;
            }
        }
    }
    if (!raw) return nullptr;
    const TagValue* so = raw->find(273);
    const TagValue* sc = raw->find(279);
    if (!so || so->nums.empty()) return nullptr;
    size_t off = (size_t)so->nums[0];
    if (off >= r.len) return nullptr;
    size_t cnt = sc && !sc->nums.empty() ? (size_t)sc->nums[0] : r.len - off;
    if (cnt > r.len - off) cnt = r.len - off;

    LJ92 lj;
    if (!lj.parse(r.buf + off, cnt)) return nullptr;
    size_t jwide = (size_t)lj.width * lj.components;
    size_t total = jwide * lj.height;
    int height = lj.height;

    // slices: [n, slice_width, last_slice_width] (u16); width = n*sw + lw
    int n_sl = 0, sw = 0, lw = (int)jwide;
    const TagValue* sl = raw->find(0xC640);
    if (sl && sl->nums.size() >= 3 && sl->nums[0] > 0) {
        n_sl = (int)sl->nums[0];
        sw = (int)sl->nums[1];
        lw = (int)sl->nums[2];
    }
    // 64-bit: corrupt slice tags otherwise overflow the int product
    int64_t w64 = (int64_t)n_sl * sw + lw;
    int width = (w64 > 0 && w64 <= 65535) ? (int)w64 : 0;
    if (width <= 0 || (size_t)width * height != total) {
        // inconsistent slice data: fall back to unsliced layout
        n_sl = 0;
        sw = 0;
        lw = width = (int)jwide;
        if ((size_t)width * height != total) return nullptr;
    }

    std::vector<uint16_t> flat(total);
    if (!lj.decode(flat.data())) return nullptr;

    uint16_t* out = (uint16_t*)calloc((size_t)width * height,
                                      sizeof(uint16_t));
    if (!out) return nullptr;
    if (n_sl == 0) {
        memcpy(out, flat.data(), total * sizeof(uint16_t));
    } else {
        // stream fills slice-by-slice, row-major inside each slice
        size_t per_slice = (size_t)sw * height;
        for (size_t jidx = 0; jidx < total; ++jidx) {
            size_t i = jidx / per_slice;
            int ws = sw;
            size_t rem = jidx - i * per_slice;
            if ((int)i >= n_sl) {
                i = n_sl;
                rem = jidx - (size_t)n_sl * per_slice;
                ws = lw;
            }
            size_t row = rem / ws;
            size_t col = rem % ws + i * sw;
            if (row < (size_t)height)
                out[row * width + col] = flat[jidx];
        }
    }

    memset(meta, 0, sizeof(*meta));
    meta->xtrans[0] = -1;
    meta->width = width;
    meta->height = height;
    // Canon sensors are RGGB at the sensor origin; the active-area offset
    // below keeps the phase consistent
    static const int rggb[4] = {0, 1, 1, 2};
    for (int i = 0; i < 4; ++i) meta->cfa_pattern[i] = rggb[i];
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    double wmax = (1 << lj.precision) - 1;
    for (int i = 0; i < 4; ++i) meta->white[i] = wmax;
    meta->iso = 100.0;

    const IFD* ifd0 = &ifds[0];
    meta->orientation = (int)ifd0->num(274, 1);
    const TagValue* mk = ifd0->find(271);
    if (mk) strncpy(meta->make, mk->str.c_str(), 63);
    const TagValue* md = ifd0->find(272);
    if (md) strncpy(meta->model, md->str.c_str(), 63);
    for (auto& ifd : ifds) {
        const TagValue* iso = ifd.find(34855);
        if (iso && !iso->nums.empty()) { meta->iso = iso->nums[0]; break; }
    }

    // Canon MakerNote: plain IFD with absolute file offsets
    const IFD* mn = nullptr;
    IFD mn_store;
    for (auto& ifd : ifds) {
        const TagValue* v = ifd.find(0x927C);
        if (v && v->off) {
            std::vector<uint32_t> subs;
            parse_ifd(r, v->off, mn_store, subs, 3);
            mn = &mn_store;
            break;
        }
    }
    int a_top = -1, a_left = -1, a_bot = -1, a_right = -1;
    if (mn) {
        const TagValue* si = mn->find(0x00E0);  // SensorInfo
        if (si && si->nums.size() >= 9) {
            a_left = (int)si->nums[5];
            a_top = (int)si->nums[6];
            a_right = (int)si->nums[7];
            a_bot = (int)si->nums[8];
            if (a_left > 0 && a_top > 0 && a_right > a_left &&
                a_bot > a_top && a_right < width && a_bot < height) {
                meta->active_area[0] = a_top;
                meta->active_area[1] = a_left;
                meta->active_area[2] = a_bot + 1;
                meta->active_area[3] = a_right + 1;
            }
        }
        const TagValue* cd = mn->find(0x4001);  // ColorData
        if (cd && cd->off && cd->count > 100) {
            size_t woff = cd->count == 582 ? 25
                         : cd->count == 653 ? 34 : 63;
            double wb[4];
            for (int i = 0; i < 4; ++i)
                wb[i] = r.u16(cd->off + 2 * (woff + i));  // R G G B
            if (wb[0] > 0 && wb[1] > 0 && wb[3] > 0) {
                meta->as_shot_neutral[0] = wb[1] / wb[0];
                meta->as_shot_neutral[1] = 1.0;
                meta->as_shot_neutral[2] = wb[1] / wb[3];
            }
        }
    }
    // black level: average of the optically-masked left border per CFA
    // channel (the CR2 carries no black tag; the mask is the reference's
    // source too)
    if (meta->active_area[1] > 4) {
        double acc[4] = {0, 0, 0, 0};
        long cns[4] = {0, 0, 0, 0};
        int x1 = meta->active_area[1] - 2;
        int y0 = meta->active_area[0];
        int y1 = meta->active_area[2];
        for (int y = y0; y < y1; ++y)
            for (int x = 2; x < x1; ++x) {
                int c = (y & 1) * 2 + (x & 1);
                acc[c] += out[(size_t)y * width + x];
                cns[c]++;
            }
        for (int c = 0; c < 4; ++c)
            meta->black[c] = cns[c] ? acc[c] / cns[c] : 0.0;
    }
    return out;
}

// ---------------------------------------------------------------------------
// Nikon NEF, lossless-compressed (reference decode boundary:
// rtengine/dcraw.cc nikon_load_raw; fresh implementation from the public
// NEF format description). Scope: compression 34713 with the type-2
// lossless bitstream (12/14-bit), the MakerNote linearization-table
// header (version bytes, initial predictors, curve) and the classic
// unencrypted WB tag; encrypted ColorBalance WB falls back to the
// matrix-derived estimate on the Python side.
// ---------------------------------------------------------------------------

// The fixed NEF huffman code tables, indexed by (version, bit depth):
// pairs of (code length in bits, diff bit count). These are format
// constants from the public specification.
struct NefTree {
    uint8_t bits[16];   // count of codes per length, 1..16 (JPEG style)
    uint8_t vals[20];
};

// The six fixed code tables of the NEF bitstream, JPEG-DHT style
// (counts per code length + symbols; symbols encode shift<<4 | length
// for the lossy trees). Format constants of the public NEF spec, in
// canonical order: 12-bit lossy / lossy-after-split / lossless, then
// the 14-bit trio.
static const NefTree kNefTrees[6] = {
    {{0,1,5,1,1,1,1,1,1,2,0,0,0,0,0,0},
     {5,4,3,6,2,7,1,0,8,9,11,10,12}},
    {{0,1,5,1,1,1,1,1,1,2,0,0,0,0,0,0},
     {0x39,0x5a,0x38,0x27,0x16,5,4,3,2,1,0,11,12,12}},
    {{0,1,4,2,3,1,2,0,0,0,0,0,0,0,0,0},
     {5,4,6,3,7,2,8,1,9,0,10,11,12}},
    {{0,1,4,3,1,1,1,1,1,2,0,0,0,0,0,0},
     {5,6,4,7,8,3,9,2,1,0,10,11,12,13,14}},
    {{0,1,5,1,1,1,1,1,1,1,2,0,0,0,0,0},
     {8,0x5c,0x4b,0x3a,0x29,7,6,5,4,3,2,1,0,13,14}},
    {{0,1,4,2,2,3,1,2,0,0,0,0,0,0,0,0},
     {7,6,8,5,9,4,10,3,11,12,2,0,1,13,14}},
};

static void build_nef_hufftable(const NefTree& t, HuffTable& h) {
    int total = 0;
    int code = 0, k = 0;
    for (int i = 0; i < (int)sizeof(t.vals); ++i) h.vals[i] = t.vals[i];
    for (int l = 1; l <= 16; ++l) {
        int cnt = t.bits[l - 1];  // counts are stored for lengths 1..16
        h.valptr[l] = k;
        h.mincode[l] = code;
        code += cnt;
        k += cnt;
        h.maxcode[l] = cnt ? code - 1 : -1;
        code <<= 1;
        total += cnt;
    }
    h.maxcode[17] = 0x7FFFFFFF;
    build_hufflut(h);
    h.valid = total > 0;
}

// MSB-first bit reader without JPEG marker stuffing
struct RawBitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t bits = 0;
    int nbits = 0;

    RawBitReader(const uint8_t* p_, const uint8_t* e_) : p(p_), end(e_) {}
    void fill() {
        while (nbits <= 48) {
            uint8_t b = (p < end) ? *p++ : 0;
            bits = (bits << 8) | b;
            nbits += 8;
        }
    }
    int get(int n) {
        if (n == 0) return 0;
        if (nbits < n) fill();
        int v = (int)((bits >> (nbits - n)) & ((1ull << n) - 1));
        nbits -= n;
        return v;
    }
    int peek(int n) {
        if (nbits < n) fill();
        return (int)((bits >> (nbits - n)) & ((1ull << n) - 1));
    }
    void skip(int n) { nbits -= n; }
};

static int nef_huff_decode(RawBitReader& br, const HuffTable& h) {
    int code = br.get(1);
    int l = 1;
    while (l <= 16 && code > h.maxcode[l]) {
        code = (code << 1) | br.get(1);
        ++l;
    }
    if (l > 16) return -1;
    return h.vals[h.valptr[l] + code - h.mincode[l]];
}

static inline int nef_huff_decode_fast(RawBitReader& br,
                                       const HuffTable& h) {
    int idx = br.peek(8);
    int l = h.lut_len[idx];
    if (l) {
        br.skip(l);
        return h.lut_val[idx];
    }
    return nef_huff_decode(br, h);
}

static uint16_t* decode_nef(const Reader& r, const std::vector<IFD>& ifds,
                            ArtRawMeta* meta) {
    // raw IFD: compression 34713
    const IFD* raw = nullptr;
    for (auto& ifd : ifds)
        if ((int)ifd.num(259, 0) == 34713) { raw = &ifd; break; }
    if (!raw) return nullptr;
    int width = (int)raw->num(256, 0);
    int height = (int)raw->num(257, 0);
    int bps = (int)raw->num(258, 12);
    if (width <= 0 || height <= 0 || (bps != 12 && bps != 14))
        return nullptr;
    const TagValue* so = raw->find(273);
    if (!so || so->nums.empty()) return nullptr;
    size_t off = (size_t)so->nums[0];
    if (off >= r.len) return nullptr;

    // MakerNote: "Nikon\0..\0" + embedded TIFF at +10; tag offsets are
    // relative to that embedded base
    const TagValue* mn = nullptr;
    for (auto& ifd : ifds) {
        const TagValue* v = ifd.find(0x927C);
        if (v && v->off) { mn = v; break; }
    }
    int ver0 = 0x46, ver1 = 0x30;
    uint16_t vpred[2][2] = {{(uint16_t)(1 << (bps - 1)),
                             (uint16_t)(1 << (bps - 1))},
                            {(uint16_t)(1 << (bps - 1)),
                             (uint16_t)(1 << (bps - 1))}};
    std::vector<uint16_t> curve;
    int split = 0;
    double wb[4] = {0, 0, 0, 0};
    if (mn && mn->off + 18 < r.len
        && memcmp(r.buf + mn->off, "Nikon", 5) == 0) {
        size_t base = mn->off + 10;
        Reader mr{r.buf, r.len, r.little};
        if (r.buf[base] == 'I') mr.little = true;
        else if (r.buf[base] == 'M') mr.little = false;
        uint32_t ifdoff = mr.u32(base + 4);
        IFD nifd;
        std::vector<uint32_t> subs;
        // parse with offsets relative to `base`: shift reader
        Reader nr{r.buf + base, r.len - base, mr.little};
        parse_ifd(nr, ifdoff, nifd, subs, 3);
        const TagValue* lt = nifd.find(0x96);
        if (lt && lt->off && base + lt->off + 12 < r.len) {
            const uint8_t* d = r.buf + base + lt->off;
            ver0 = d[0];
            ver1 = d[1];
            size_t p = 2;
            if (ver0 == 0x49 || ver1 == 0x58) p += 2110;
            for (int i = 0; i < 2; ++i)
                for (int j = 0; j < 2; ++j) {
                    vpred[i][j] = nr.u16(lt->off + p);
                    p += 2;
                }
            int csize = nr.u16(lt->off + p);
            p += 2;
            int step = 0;
            if (ver0 == 0x44 && (ver1 == 0x20 || ver1 == 0x40) && csize > 1)
                step = ((1 << bps) - 1) / (csize - 1);
            if (step) {
                curve.resize(1 << bps);
                for (int i = 0; i < csize; ++i) {
                    int v = nr.u16(lt->off + p + 2 * i);
                    curve[i * step] = (uint16_t)v;
                }
                // linear interp between points
                for (int i = 0; i < (int)curve.size() - 1; ++i) {
                    if (i % step) {
                        int i0 = (i / step) * step;
                        int i1 = std::min(i0 + step,
                                          (int)curve.size() - 1);
                        curve[i] = (uint16_t)(curve[i0]
                            + ((long)(curve[i1] - curve[i0]) * (i - i0))
                              / std::max(i1 - i0, 1));
                    }
                }
                if (ver1 != 0x20) {
                    split = nr.u16(lt->off + p + 2 * csize);
                }
            }
        }
        const TagValue* wbt = nifd.find(0x0C);  // classic WB R,B,G1,G2
        if (wbt && wbt->nums.size() >= 4) {
            wb[0] = wbt->nums[0];
            wb[2] = wbt->nums[1];
            wb[1] = wbt->nums[2];
            wb[3] = wbt->nums[3];
        }
    }

    // tree selection (public NEF spec): base tree by version, +3 for 14b
    int tree = 0;
    if (ver0 == 0x46) tree = 2;
    if (bps == 14) tree += 3;
    HuffTable huff;
    build_nef_hufftable(kNefTrees[tree], huff);
    if (!huff.valid) return nullptr;

    uint16_t* out = (uint16_t*)calloc((size_t)width * height,
                                      sizeof(uint16_t));
    if (!out) return nullptr;
    RawBitReader br(r.buf + off, r.buf + r.len);
    int maxval = (1 << bps) - 1;
    uint16_t pred[2][2];
    memcpy(pred, vpred, sizeof(pred));
    bool ok = true;
    for (int row = 0; row < height && ok; ++row) {
        if (split && row == split) {
            // lossy type streams switch trees mid-image; not in scope
            ok = false;
            break;
        }
        for (int col = 0; col < width; ++col) {
            int t = nef_huff_decode_fast(br, huff);
            if (t < 0) { ok = false; break; }
            int len = t & 15;
            int shl = t >> 4;
            int diff = 0;
            if (len > 0) {
                int nb = len - shl;
                int bitsv = nb > 0 ? br.get(nb) : 0;
                diff = (((bitsv << 1) + 1) << shl) >> 1;
                if ((diff & (1 << (len - 1))) == 0)
                    diff -= (1 << len) - (shl ? 0 : 1);
            }
            int idx = col & 1;
            int val;
            if (col < 2) {
                pred[row & 1][idx] = (uint16_t)(pred[row & 1][idx] + diff);
                val = pred[row & 1][idx];
            } else {
                val = out[(size_t)row * width + col - 2] + diff;
                // raw-domain value stored; curve applied after the loop
            }
            val &= 0xFFFF;
            out[(size_t)row * width + col] = (uint16_t)val;
        }
    }
    if (!ok) { free(out); return nullptr; }
    // apply linearization curve (lossy variants); clamp to bps range
    for (size_t i = 0; i < (size_t)width * height; ++i) {
        int v = out[i];
        if (!curve.empty())
            v = curve[std::min(v, (int)curve.size() - 1)];
        else
            v = std::min(v, maxval);
        out[i] = (uint16_t)v;
    }

    memset(meta, 0, sizeof(*meta));
    meta->xtrans[0] = -1;
    meta->width = width;
    meta->height = height;
    meta->orientation = (int)ifds[0].num(274, 1);
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    // Nikon CFA: RGGB on most bodies (camconst overrides per model)
    const TagValue* cfa = raw->find(33422);
    static const int rggb[4] = {0, 1, 1, 2};
    for (int i = 0; i < 4; ++i)
        meta->cfa_pattern[i] =
            (cfa && cfa->nums.size() >= 4) ? (int)cfa->nums[i] : rggb[i];
    double wmax = curve.empty() ? (double)maxval
                                : (double)curve[curve.size() - 1];
    for (int i = 0; i < 4; ++i) meta->white[i] = wmax;
    meta->iso = 100.0;
    for (auto& ifd : ifds) {
        const TagValue* iso = ifd.find(34855);
        if (iso && !iso->nums.empty()) { meta->iso = iso->nums[0]; break; }
    }
    if (wb[0] > 0 && wb[1] > 0 && wb[2] > 0) {
        meta->as_shot_neutral[0] = wb[1] / wb[0];
        meta->as_shot_neutral[1] = 1.0;
        meta->as_shot_neutral[2] = wb[1] / wb[2];
    }
    const TagValue* mk = ifds[0].find(271);
    if (mk) strncpy(meta->make, mk->str.c_str(), 63);
    const TagValue* md = ifds[0].find(272);
    if (md) strncpy(meta->model, md->str.c_str(), 63);
    return out;
}

// ---------------------------------------------------------------------------
// Olympus ORF (reference decode boundary: rtengine/dcraw.cc
// olympus_load_raw :2684; TIFF container with magic "RO"/"RS"). The
// compressed stream codes each pixel as: 3 bits (sign + 2 low bits), a
// unary "high" count (12 zeros = escape to an explicit (16-nbits)-bit
// field), and nbits magnitude bits, where nbits adapts from a per-column-
// parity carry state; the reconstructed magnitude feeds a median-style
// gradient predictor over the pixels two back/two up. Uncompressed
// 16-bit ORFs are plain LE u16 planes. (12-bit packed uncompressed — a
// rarity among Olympus bodies, which default to compression — still goes
// through the preconverter hook.)
// ---------------------------------------------------------------------------

static bool orf_decode_stream(RawBitReader& br, uint16_t* out, int width,
                              int height) {
    for (int row = 0; row < height; ++row) {
        int acarry[2][3] = {{0, 0, 0}, {0, 0, 0}};
        for (int col = 0; col < width; ++col) {
            int* carry = acarry[col & 1];
            int i = 2 * (carry[2] < 3);
            int nbits = 2 + i;
            while (((uint16_t)carry[0]) >> (nbits + i)) nbits++;
            int sign3 = br.get(3);
            int low = sign3 & 3;
            int sign = (sign3 & 4) ? -1 : 0;
            // unary high: zeros-then-one; 12 zeros (no terminator) is
            // the escape to an explicit field (huff[0] = 0xc0c)
            int high = 0;
            while (high < 12 && br.get(1) == 0) high++;
            if (high == 12)
                high = br.get(16 - nbits) >> 1;
            carry[0] = (high << nbits) | br.get(nbits);
            int diff = (carry[0] ^ sign) + carry[1];
            carry[1] = (diff * 3 + carry[1]) >> 5;
            carry[2] = carry[0] > 16 ? 0 : carry[2] + 1;
            int pred;
            uint16_t* rp = out + (size_t)row * width;
            if (row < 2 && col < 2) {
                pred = 0;
            } else if (row < 2) {
                pred = rp[col - 2];
            } else if (col < 2) {
                pred = rp[col - 2 * width];
            } else {
                int w = rp[col - 2];
                int n = rp[col - 2 * width];
                int nw = rp[col - 2 * width - 2];
                if ((w < nw && nw < n) || (n < nw && nw < w)) {
                    if (abs(w - nw) > 32 || abs(n - nw) > 32)
                        pred = w + n - nw;
                    else
                        pred = (w + n) >> 1;
                } else {
                    pred = abs(w - nw) > abs(n - nw) ? w : n;
                }
            }
            int val = pred + diff * 4 + low;
            if ((unsigned)val >> 12) return false;  // dcraw derror()
            rp[col] = (uint16_t)val;
        }
    }
    return true;
}

static uint16_t* decode_orf(const Reader& r, const std::vector<IFD>& ifds,
                            ArtRawMeta* meta) {
    // raw IFD: CFA photometric or the largest strip-bearing IFD
    const IFD* raw = nullptr;
    size_t best = 0;
    for (auto& ifd : ifds) {
        if (!ifd.find(273)) continue;
        size_t area = (size_t)ifd.num(256, 0) * (size_t)ifd.num(257, 0);
        if (ifd.num(262, 0) == 32803 || area > best) {
            raw = &ifd;
            best = area;
        }
    }
    if (!raw) return nullptr;
    int width = (int)raw->num(256, 0);
    int height = (int)raw->num(257, 0);
    if (width <= 0 || height <= 0) return nullptr;
    const TagValue* so = raw->find(273);
    if (!so || so->nums.empty()) return nullptr;
    size_t off = (size_t)so->nums[0];
    size_t nbytes = (size_t)raw->num(279, 0);
    if (off >= r.len) return nullptr;

    uint16_t* out = (uint16_t*)calloc((size_t)width * height,
                                      sizeof(uint16_t));
    if (!out) return nullptr;
    bool ok = false;
    int bps = (int)raw->num(258, 12);
    // compressed when the strip is smaller than an unpacked plane yet
    // above dcraw's bytes*7 > w*h floor; a declared 12-bit depth forces
    // the compressed path even for incompressible (oversized) streams
    bool compressed = nbytes * 7 > (size_t)width * height
        && (nbytes < (size_t)width * height * 2 || bps == 12);
    if (compressed) {
        // compressed: 7 header bytes precede the bitstream (dcraw
        // fseek(ifp, 7, SEEK_CUR))
        if (off + 7 < r.len) {
            RawBitReader br(r.buf + off + 7, r.buf + r.len);
            ok = orf_decode_stream(br, out, width, height);
        }
    } else if (nbytes >= (size_t)width * height * 2
               && off + (size_t)width * height * 2 <= r.len) {
        // uncompressed 16-bit plane
        for (size_t i = 0; i < (size_t)width * height; ++i)
            out[i] = r.u16(off + 2 * i);
        ok = true;
    }
    if (!ok) { free(out); return nullptr; }

    memset(meta, 0, sizeof(*meta));
    meta->xtrans[0] = -1;
    meta->width = width;
    meta->height = height;
    meta->orientation = (int)ifds[0].num(274, 1);
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    // Olympus Bayer bodies are RGGB unless the raw IFD says otherwise
    const TagValue* cfa = raw->find(33422);
    static const int rggb[4] = {0, 1, 1, 2};
    for (int i = 0; i < 4; ++i)
        meta->cfa_pattern[i] =
            (cfa && cfa->nums.size() >= 4) ? (int)cfa->nums[i] : rggb[i];
    for (int i = 0; i < 4; ++i) meta->black[i] = 0.0;
    for (int i = 0; i < 4; ++i) meta->white[i] = 4095.0;

    // MakerNote: new-style "OLYMPUS\0II" (offsets relative to the note
    // base) or old-style "OLYMP\0" (offsets file-absolute). WB/black live
    // in the 0x2040 ImageProcessing sub-IFD (tags 0x100/0x600) new-style,
    // or directly as 0x1017/0x1018/0x1012 old-style
    // (dcraw parse_makernote :5812-5832).
    const TagValue* mn = nullptr;
    for (auto& ifd : ifds) {
        const TagValue* v = ifd.find(0x927C);
        if (v && v->off) { mn = v; break; }
    }
    double wb_r = 0, wb_b = 0;
    double cbl[4] = {0, 0, 0, 0};
    bool have_cbl = false;
    if (mn && mn->off + 12 < r.len) {
        const uint8_t* d = r.buf + mn->off;
        IFD oifd;
        size_t obase = 0;
        bool have = false;
        if (memcmp(d, "OLYMPUS", 7) == 0 && d[7] == 0) {
            Reader nr{r.buf + mn->off, r.len - mn->off, d[8] == 'I'};
            std::vector<uint32_t> subs;
            parse_ifd(nr, 12, oifd, subs, 3);
            obase = mn->off;
            have = true;
        } else if (memcmp(d, "OLYMP", 5) == 0 && d[5] == 0) {
            std::vector<uint32_t> subs;
            parse_ifd(r, mn->off + 8, oifd, subs, 3);
            obase = 0;
            have = true;
        }
        if (have) {
            const TagValue* ip = oifd.find(0x2040);
            if (ip && !ip->nums.empty()) {
                size_t ipoff = obase + (size_t)ip->nums[0];
                if (ipoff + 2 < r.len) {
                    Reader nr{r.buf, r.len, r.little};
                    IFD pifd;
                    std::vector<uint32_t> subs;
                    // new-style sub-IFD offsets are note-relative too
                    if (obase) {
                        Reader sub{r.buf + obase, r.len - obase,
                                   r.little};
                        parse_ifd(sub, ipoff - obase, pifd, subs, 3);
                    } else {
                        parse_ifd(nr, ipoff, pifd, subs, 3);
                    }
                    const TagValue* wbt = pifd.find(0x0100);
                    if (wbt && wbt->nums.size() >= 2) {
                        wb_r = wbt->nums[0] / 256.0;
                        wb_b = wbt->nums[1] / 256.0;
                    }
                    const TagValue* blt = pifd.find(0x0600);
                    if (blt && blt->nums.size() >= 4) {
                        for (int i = 0; i < 4; ++i)
                            cbl[i] = blt->nums[i];
                        have_cbl = true;
                    }
                }
            }
            const TagValue* rt = oifd.find(0x1017);
            if (rt && !rt->nums.empty()) wb_r = rt->nums[0] / 256.0;
            const TagValue* bt = oifd.find(0x1018);
            if (bt && !bt->nums.empty()) wb_b = bt->nums[0] / 256.0;
            const TagValue* kt = oifd.find(0x1012);
            if (kt && kt->nums.size() >= 4) {
                for (int i = 0; i < 4; ++i) cbl[i] = kt->nums[i];
                have_cbl = true;
            }
        }
    }
    if (have_cbl) {
        // stored order is color-indexed via c ^ (c >> 1): [R, G1, B, G2]
        bool first_g = true;
        for (int i = 0; i < 4; ++i) {
            int c = meta->cfa_pattern[i];
            if (c == 1) {
                meta->black[i] = first_g ? cbl[1] : cbl[3];
                first_g = false;
            } else {
                meta->black[i] = cbl[c == 0 ? 0 : 2];
            }
        }
    }
    if (wb_r > 0 && wb_b > 0) {
        meta->as_shot_neutral[0] = 1.0 / wb_r;
        meta->as_shot_neutral[1] = 1.0;
        meta->as_shot_neutral[2] = 1.0 / wb_b;
    }
    const TagValue* mk = ifds[0].find(271);
    if (mk) strncpy(meta->make, mk->str.c_str(), 63);
    const TagValue* md = ifds[0].find(272);
    if (md) strncpy(meta->model, md->str.c_str(), 63);
    return out;
}

// ---------------------------------------------------------------------------
// Pentax PEF (reference decode boundary: rtengine/dcraw.cc Pentax branch,
// rawimage.cc loadRaw; fresh implementation from the public PEF format
// description). The raw IFD uses compression 65535; pixels are coded as a
// plain MSB-first bitstream of (huffman ssss category, magnitude bits)
// with LJPEG sign extension. Predictors: the first two columns of a row
// continue the row-pair two above (per row/column parity), later columns
// add onto the same-parity pixel two back. The code table ships in
// Pentax MakerNote tag 0x220: u16 header (dep = (v+12)&15), 12 reserved
// bytes, dep left-aligned 12-bit code-start values (u16), dep code
// lengths (u8); entry c covers 4096>>len consecutive 12-bit windows.
// ---------------------------------------------------------------------------

static uint16_t* decode_pef(const Reader& r, const std::vector<IFD>& ifds,
                            ArtRawMeta* meta) {
    const IFD* raw = nullptr;
    for (auto& ifd : ifds)
        if ((int)ifd.num(259, 0) == 65535) { raw = &ifd; break; }
    if (!raw) return nullptr;
    int width = (int)raw->num(256, 0);
    int height = (int)raw->num(257, 0);
    int bps = (int)raw->num(258, 12);
    if (width <= 0 || height <= 0 || bps < 8 || bps > 14) return nullptr;
    const TagValue* so = raw->find(273);
    if (!so || so->nums.empty()) return nullptr;
    size_t off = (size_t)so->nums[0];
    if (off >= r.len) return nullptr;

    // Pentax MakerNote: "AOC\0" + "II"/"MM" with an IFD at +6 whose value
    // offsets are file-absolute, or "PENTAX \0" + "II"/"MM" with an IFD
    // at +10 and offsets relative to the makernote start.
    const TagValue* mn = nullptr;
    for (auto& ifd : ifds) {
        const TagValue* v = ifd.find(0x927C);
        if (v && v->off) { mn = v; break; }
    }
    IFD pifd;
    size_t pbase = 0;       // base the tag value offsets are relative to
    bool have_mn = false;
    if (mn && mn->off + 12 < r.len) {
        const uint8_t* d = r.buf + mn->off;
        if (memcmp(d, "AOC", 3) == 0 && d[3] == 0) {
            Reader nr{r.buf, r.len, d[4] == 'I'};
            std::vector<uint32_t> subs;
            parse_ifd(nr, mn->off + 6, pifd, subs, 3);
            pbase = 0;
            have_mn = true;
        } else if (memcmp(d, "PENTAX ", 7) == 0) {
            Reader nr{r.buf + mn->off, r.len - mn->off, d[8] == 'I'};
            std::vector<uint32_t> subs;
            parse_ifd(nr, 10, pifd, subs, 3);
            pbase = mn->off;
            have_mn = true;
        }
    }
    if (!have_mn) return nullptr;

    // huffman LUT from tag 0x220
    const TagValue* ht = pifd.find(0x220);
    if (!ht || !ht->off) return nullptr;
    size_t hoff = pbase + ht->off;
    if (hoff + 16 > r.len) return nullptr;
    Reader hr{r.buf, r.len, r.little};
    int dep = ((int)hr.u16(hoff) + 12) & 15;
    size_t p = hoff + 2 + 12;
    if (p + (size_t)dep * 3 > r.len || dep < 1 || dep > 13) return nullptr;
    uint8_t lut_len[4096];
    uint8_t lut_cat[4096];
    memset(lut_len, 0, sizeof(lut_len));
    memset(lut_cat, 0, sizeof(lut_cat));
    for (int c = 0; c < dep; ++c) {
        int start = hr.u16(p + 2 * c) & 4095;
        int len = r.buf[p + 2 * dep + c];
        if (len < 1 || len > 12) return nullptr;
        int span = 4096 >> len;
        for (int i = 0; i < span; ++i) {
            int idx = (start + i) & 4095;
            lut_len[idx] = (uint8_t)len;
            lut_cat[idx] = (uint8_t)c;
        }
    }

    uint16_t* out = (uint16_t*)calloc((size_t)width * height,
                                      sizeof(uint16_t));
    if (!out) return nullptr;
    RawBitReader br(r.buf + off, r.buf + r.len);
    int vpred[2][2] = {{0, 0}, {0, 0}};
    bool ok = true;
    for (int row = 0; row < height && ok; ++row) {
        for (int col = 0; col < width; ++col) {
            int w12 = br.peek(12);
            int clen = lut_len[w12];
            if (!clen) { ok = false; break; }
            br.skip(clen);
            int cat = lut_cat[w12];
            int diff = 0;
            if (cat > 0) {
                diff = br.get(cat);
                if ((diff & (1 << (cat - 1))) == 0)
                    diff -= (1 << cat) - 1;
            }
            int val;
            if (col < 2)
                val = vpred[row & 1][col] += diff;
            else
                val = out[(size_t)row * width + col - 2] + diff;
            // corrupted streams make the predictor leave the bps range
            // (dcraw pentax_load_raw flags hpred >> tiff_bps as an error)
            if ((unsigned)val >> bps) { ok = false; break; }
            out[(size_t)row * width + col] = (uint16_t)val;
        }
    }
    if (!ok) { free(out); return nullptr; }

    memset(meta, 0, sizeof(*meta));
    meta->xtrans[0] = -1;
    meta->width = width;
    meta->height = height;
    meta->orientation = (int)ifds[0].num(274, 1);
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    // Pentax Bayer bodies are RGGB unless the raw IFD says otherwise
    const TagValue* cfa = raw->find(33422);
    static const int rggb[4] = {0, 1, 1, 2};
    for (int i = 0; i < 4; ++i)
        meta->cfa_pattern[i] =
            (cfa && cfa->nums.size() >= 4) ? (int)cfa->nums[i] : rggb[i];
    // makernote 0x200 = BlackPoint (4), 0x201 = WhitePoint (camera WB,
    // stored R,G1,G2,B); white level from bps (camconst refines per-ISO).
    // Blacks are remapped from the stored R,G1,G2,B order to CFA pattern
    // positions (dcraw stores them color-indexed via cblack[c ^ (c >> 1)])
    // so non-RGGB layouts land on the right channels.
    const TagValue* bp = pifd.find(0x200);
    if (bp && bp->nums.size() >= 4) {
        // color-indexed blacks: [R, G1, B, G2]
        double cbl[4] = {bp->nums[0], bp->nums[1], bp->nums[3],
                         bp->nums[2]};
        bool first_g = true;
        for (int i = 0; i < 4; ++i) {
            int c = meta->cfa_pattern[i];
            if (c == 1) {
                meta->black[i] = first_g ? cbl[1] : cbl[3];
                first_g = false;
            } else {
                meta->black[i] = cbl[c];
            }
        }
    } else {
        for (int i = 0; i < 4; ++i) meta->black[i] = 0.0;
    }
    for (int i = 0; i < 4; ++i) meta->white[i] = (1 << bps) - 1;
    const TagValue* wp = pifd.find(0x201);
    if (wp && wp->nums.size() >= 4 && wp->nums[0] > 0 && wp->nums[3] > 0) {
        double g = 0.5 * (wp->nums[1] + wp->nums[2]);
        meta->as_shot_neutral[0] = g / wp->nums[0];
        meta->as_shot_neutral[1] = 1.0;
        meta->as_shot_neutral[2] = g / wp->nums[3];
    }
    meta->iso = 100.0;
    for (auto& ifd : ifds) {
        const TagValue* iso = ifd.find(34855);
        if (iso && !iso->nums.empty()) { meta->iso = iso->nums[0]; break; }
    }
    const TagValue* mk = ifds[0].find(271);
    if (mk) strncpy(meta->make, mk->str.c_str(), 63);
    const TagValue* md = ifds[0].find(272);
    if (md) strncpy(meta->model, md->str.c_str(), 63);
    return out;
}

// ---------------------------------------------------------------------------
// Samsung SRW (reference decode boundary: rtengine/dcraw.cc
// samsung_load_raw :3441, samsung2_load_raw :3473, samsung3_load_raw
// :3495; TIFF container whose raw IFD carries compression 32770/32772/
// 32773 and, for the v0 stream, a row-offset-table pointer in tag
// 40976). The three bitstream models are undocumented outside the dcraw
// decoder lineage, so the opcode/predictor semantics are DERIVED from
// that published behavior (honest provenance, as with CRX); the code is
// structured on this repo's Reader/bit-reader idiom.
// ---------------------------------------------------------------------------

// MSB-first bit reader over little-endian 32-bit words (the "ph1 bits"
// source Samsung streams use: pull a LE u32, consume its bits high
// first). `p` advances in whole words, so `p - start` is the file-
// position delta dcraw's ftell would report.
struct WordBitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t bitbuf = 0;
    int vbits = 0;

    WordBitReader(const uint8_t* s, const uint8_t* e) : p(s), end(e) {}
    uint32_t get(int nbits) {
        if (nbits <= 0) return 0;
        if (vbits < nbits) {
            uint32_t w = 0;
            for (int i = 0; i < 4; ++i)
                w |= (uint32_t)(p < end ? *p++ : 0) << (8 * i);
            bitbuf = bitbuf << 32 | w;
            vbits += 32;
        }
        uint32_t c = (uint32_t)(bitbuf << (64 - vbits) >> (64 - nbits));
        vbits -= nbits;
        return c;
    }
};

// v0 (compression 32770, NX10-generation): per-row bitstreams located by
// a u32 offset table; 16-pixel blocks headed by a direction bit and four
// 2-bit code-length opcodes (3 = explicit 4-bit reload, 2 = decrement,
// 1 = increment); pixels are coded as sign-extended len-bit deltas from
// the previous block's last even/odd pixel (horizontal) or from one/two
// rows up (vertical), even pixels first; the stored rows interleave the
// CFA, undone by a final pairwise swap.
static bool srw_decode_v0(const Reader& r, size_t table_off,
                          size_t data_off, uint16_t* out, int width,
                          int height) {
    for (int row = 0; row < height; ++row) {
        if (table_off + 4 * (size_t)row + 4 > r.len) return false;
        size_t roff = data_off + r.u32(table_off + 4 * (size_t)row);
        if (roff >= r.len) return false;
        WordBitReader br(r.buf + roff, r.buf + r.len);
        int len[4];
        for (int c = 0; c < 4; ++c) len[c] = row < 2 ? 7 : 4;
        uint16_t* rp = out + (size_t)row * width;
        for (int col = 0; col + 15 < width; col += 16) {
            int dir = (int)br.get(1);
            for (int c = 0; c < 4; ++c) {
                int op = (int)br.get(2);
                if (op == 3) len[c] = (int)br.get(4);
                else if (op == 2) len[c]--;
                else if (op == 1) len[c]++;
                if (len[c] < 0 || len[c] > 16) return false;
            }
            for (int pass = 0; pass < 2; ++pass) {
                for (int c = pass; c < 16; c += 2) {
                    int nb = len[((c & 1) << 1) | (c >> 3)];
                    int32_t diff = (int32_t)br.get(nb);
                    if (nb)
                        diff = (int32_t)((uint32_t)diff << (32 - nb))
                               >> (32 - nb);
                    int pred;
                    if (dir) {
                        int dy = (c & 1) ? 2 : 1;   // odd pixels: 2 up
                        if (row < dy) return false;
                        pred = rp[(long)(col + c) - (long)dy * width];
                    } else if (col) {
                        pred = rp[col - 2 + (c & 1)];
                    } else {
                        pred = 128;
                    }
                    rp[col + c] = (uint16_t)(pred + diff);
                }
            }
        }
    }
    // un-interleave the stored CFA rows back to the sensor layout
    for (int row = 0; row + 1 < height; row += 2)
        for (int col = 0; col + 1 < width; col += 2)
            std::swap(out[(size_t)row * width + col + 1],
                      out[(size_t)(row + 1) * width + col]);
    return true;
}

// v2 (compression 32772): one fixed huffman table of diff categories
// over an MSB-first byte stream, NEF-style two-seed vertical predictors
// in the first two columns then horizontal accumulation by parity.
static bool srw_decode_v2(const Reader& r, size_t off, uint16_t* out,
                          int width, int height, int bps) {
    // (code length << 8) | category pairs, expanded into a 10-bit LUT in
    // listed order (canonical prefix codes)
    static const uint16_t tab[14] = {
        0x304, 0x307, 0x206, 0x205, 0x403, 0x600, 0x709,
        0x80a, 0x90b, 0xa0c, 0xa0d, 0x501, 0x408, 0x402};
    uint8_t lut_len[1024], lut_cat[1024];
    int n = 0;
    for (int i = 0; i < 14; ++i) {
        int span = 1024 >> (tab[i] >> 8);
        for (int j = 0; j < span && n < 1024; ++j, ++n) {
            lut_len[n] = (uint8_t)(tab[i] >> 8);
            lut_cat[n] = (uint8_t)(tab[i] & 0xff);
        }
    }
    RawBitReader br(r.buf + off, r.buf + r.len);
    int vpred[2][2] = {{0, 0}, {0, 0}};
    int hpred[2] = {0, 0};
    for (int row = 0; row < height; ++row) {
        for (int col = 0; col < width; ++col) {
            int w10 = br.peek(10);
            br.skip(lut_len[w10]);
            int cat = lut_cat[w10];
            int diff = 0;
            if (cat > 0) {
                diff = br.get(cat);
                if ((diff & (1 << (cat - 1))) == 0)
                    diff -= (1 << cat) - 1;
            }
            int val;
            if (col < 2)
                val = hpred[col] = (vpred[row & 1][col] += diff);
            else
                val = (hpred[col & 1] += diff);
            if ((unsigned)val >> bps) return false;
            out[(size_t)row * width + col] = (uint16_t)val;
        }
    }
    return true;
}

// v3 (compression 32773, NX1/NX500): a 14-byte header carries an option
// byte and the row-0 seed; rows restart on 16-byte-aligned stream
// positions. Blocks of 16 pixels share a quantization magnitude `mag`
// (nudged by 2-bit codes or reloaded from 12 bits), a predictor mode
// (7 = horizontal-from-previous-block, 0-6 = an averaged pair from the
// green row above / same-color row two up at mode-dependent lateral
// offsets) and four adaptive code lengths chained per channel parity.
static bool srw_decode_v3(const Reader& r, size_t data_off, uint16_t* out,
                          int width, int height) {
    if (data_off + 16 > r.len) return false;
    int opt = r.buf[data_off + 9];
    int init = (int)r.u16(data_off + 12);
    static const int off1[7] = {-4, -2, -2, 0, 0, 2, 4};
    static const int off2[7] = {-4, -2, 0, 0, 2, 2, 4};
    static const int ladj[3] = {0, 1, -1};
    size_t pos = data_off + 14;
    for (int row = 0; row < height; ++row) {
        pos += (data_off - pos) & 15;   // align vs the stream base
        if (pos >= r.len) return false;
        WordBitReader br(r.buf + pos, r.buf + r.len);
        const uint8_t* row_start = r.buf + pos;
        int mag = 0, pmode = 7;
        int lent[3][2];
        for (int i = 0; i < 3; ++i)
            lent[i][0] = lent[i][1] = row < 2 ? 7 : 4;
        int len[4] = {0, 0, 0, 0};
        uint16_t* rp = out + (size_t)row * width;
        // predictor row bases: green neighbours one row up (shifted to
        // the opposite column parity), same-colour two rows up
        long gbase = (long)(row - 1) * width + (1 - ((row & 1) << 1));
        long sbase = (long)(row - 2) * width;
        for (int tab2 = 0; tab2 + 15 < width; tab2 += 16) {
            if (!(opt & 4) && !(tab2 & 63)) {
                int i = (int)br.get(2);
                mag = i == 0 ? mag : i == 1 ? mag - 2
                    : i == 2 ? mag + 2 : (int)br.get(12);
            }
            if (opt & 2)
                pmode = 7 - 4 * (int)br.get(1);
            else if (!br.get(1))
                pmode = (int)br.get(3);
            if ((opt & 1) || !br.get(1)) {
                for (int c = 0; c < 4; ++c) len[c] = (int)br.get(2);
                for (int c = 0; c < 4; ++c) {
                    int i = (((row & 1) << 1) | (c & 1)) % 3;
                    len[c] = len[c] < 3 ? lent[i][0] + ladj[len[c]]
                                        : (int)br.get(4);
                    if (len[c] < 0 || len[c] > 16) return false;
                    lent[i][0] = lent[i][1];
                    lent[i][1] = len[c];
                }
            }
            for (int c = 0; c < 16; ++c) {
                int col = tab2 + ((((c & 7) << 1) ^ (c >> 3)) ^ (row & 1));
                int pred;
                if (pmode == 7 || row < 2) {
                    pred = tab2 ? rp[tab2 - 2 + (col & 1)] : init;
                } else {
                    long base = ((col & 1) == (row & 1)) ? gbase : sbase;
                    long i1 = base + col + off1[pmode];
                    long i2 = base + col + off2[pmode];
                    if (i1 < 0) i1 = 0;
                    if (i2 < 0) i2 = 0;
                    pred = ((int)out[i1] + (int)out[i2] + 1) >> 1;
                }
                int nb = len[c >> 2];
                int diff = (int)br.get(nb);
                if (nb && (diff >> (nb - 1))) diff -= 1 << nb;
                diff = diff * (mag * 2 + 1) + mag;
                rp[col] = (uint16_t)(pred + diff);
            }
        }
        pos += (size_t)(br.p - row_start);
    }
    return true;
}

// ---------------------------------------------------------------------------
// Hasselblad 3FR (reference decode boundary: dcraw.cc hasselblad_load_raw).
// Fresh implementation: the container is TIFF with an ljpeg-marker header
// (SOI/SOF3/DHT/SOS parsed by the LJ92 struct above), but the entropy
// stream is Phase-One-style — bits consumed MSB-first from little-endian
// 32-bit words — coding column pairs as two Huffman bit-length codes
// followed by the two raw difference fields; predictor is the same-color
// left neighbor (0x8000 at row start), psv 11 adding half the vertical
// gradient of the two-rows-up line. Scope: single-sample (non-multishot)
// streams; CFA is GRBG (dcraw filters 0x61616161).
// ---------------------------------------------------------------------------
struct Ph1Bits {
    const uint8_t* p;
    size_t n;
    size_t pos = 0;
    uint64_t bitbuf = 0;
    int vbits = 0;
    inline uint32_t get4() {
        uint32_t v = 0;
        for (int i = 0; i < 4; ++i)
            if (pos + i < n) v |= (uint32_t)p[pos + i] << (8 * i);
        pos += 4;
        return v;
    }
    inline uint32_t bits(int nbits) {
        // corrupt huffman tables can yield symbol values > 32; clamp to
        // keep the shifts defined (the caller then fails on range checks)
        if (nbits <= 0 || nbits > 32) return 0;
        if (vbits < nbits) {
            bitbuf = bitbuf << 32 | get4();
            vbits += 32;
        }
        uint32_t c = (uint32_t)(bitbuf << (64 - vbits) >> (64 - nbits));
        vbits -= nbits;
        return c;
    }
};

static int ph1_huff_decode(Ph1Bits& br, const HuffTable& h) {
    int code = (int)br.bits(1);
    int l = 1;
    while (l <= 16 && code > h.maxcode[l]) {
        code = (code << 1) | (int)br.bits(1);
        ++l;
    }
    if (l > 16) return -1;
    return h.vals[h.valptr[l] + code - h.mincode[l]];
}

static uint16_t* decode_3fr(const Reader& r, const std::vector<IFD>& ifds,
                            const IFD* rawifd, ArtRawMeta* meta) {
    int width = (int)rawifd->num(256, 0);
    int height = (int)rawifd->num(257, 0);
    const TagValue* so = rawifd->find(273);
    const TagValue* sc = rawifd->find(279);
    if (width <= 0 || height <= 0 || !so || so->nums.empty()) return nullptr;
    size_t off = (size_t)so->nums[0];
    size_t cnt = (sc && !sc->nums.empty()) ? (size_t)sc->nums[0]
                                           : r.len - off;
    if (off >= r.len) return nullptr;
    if (off + cnt > r.len) cnt = r.len - off;

    LJ92 lj;
    if (!lj.parse(r.buf + off, cnt) || !lj.tables[0].valid) return nullptr;
    // stream dims can differ from the IFD (height halved on some backs);
    // trust the IFD like the reference (raw_width/raw_height stay TIFF's)
    Ph1Bits br{lj.scan_start, (size_t)(lj.data_end - lj.scan_start)};

    size_t npix = (size_t)width * height;
    uint16_t* out = (uint16_t*)calloc(npix, sizeof(uint16_t));
    if (!out) return nullptr;
    std::vector<int32_t> l0(width, 0), l1(width, 0), l2(width, 0);
    int32_t *b0 = l0.data(), *b1 = l1.data(), *b2 = l2.data();
    const HuffTable& h0 = lj.tables[0];
    bool ok = true;
    for (int row = 0; row < height && ok; ++row) {
        int32_t* t = b0;  // rotate: b0 <- b1 <- b2 <- (reused)
        b0 = b1;
        b1 = b2;
        b2 = t;
        uint16_t* rp = out + (size_t)row * width;
        for (int col = 0; col < width - 1; col += 2) {
            int len0 = ph1_huff_decode(br, h0);
            int len1 = ph1_huff_decode(br, h0);
            // valid length codes are 0..16; larger means a corrupt table
            if (len0 < 0 || len1 < 0 || len0 > 16 || len1 > 16) {
                ok = false;
                break;
            }
            int d[2];
            for (int c = 0; c < 2; ++c) {
                int l = c ? len1 : len0;
                int v = (int)br.bits(l);
                if (l && !(v & (1 << (l - 1)))) v -= (1 << l) - 1;
                if (v == 65535) v = -32768;
                d[c] = v;
            }
            for (int s = col; s < col + 2; ++s) {
                int pred = 0x8000;
                if (col) pred = b2[s - 2];
                if (col && row > 1 && lj.pred == 11)
                    pred += b0[s] / 2 - b0[s - 2] / 2;
                pred += d[s & 1];
                rp[s] = (uint16_t)(pred & 0xFFFF);
                b2[s] = pred;
            }
        }
    }
    if (!ok) { free(out); return nullptr; }

    memset(meta, 0, sizeof(*meta));
    meta->width = width;
    meta->height = height;
    meta->orientation = (int)ifds[0].num(274, 1);
    meta->xtrans[0] = -1;
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    static const int grbg[4] = {1, 0, 2, 1};
    for (int i = 0; i < 4; ++i) meta->cfa_pattern[i] = grbg[i];
    for (int i = 0; i < 4; ++i) {
        meta->white[i] = 65535.0;
        meta->black[i] = 0.0;
    }
    meta->iso = 100.0;
    for (auto& ifd : ifds) {
        const TagValue* iso = ifd.find(34855);
        if (iso && !iso->nums.empty()) { meta->iso = iso->nums[0]; break; }
    }
    const TagValue* mk = ifds[0].find(271);
    if (mk) strncpy(meta->make, mk->str.c_str(), 63);
    const TagValue* md = ifds[0].find(272);
    if (md) strncpy(meta->model, md->str.c_str(), 63);
    return out;
}

// ---------------------------------------------------------------------------
// Phase One IIQ (reference decode boundary: dcraw.cc parse_phase_one :7593
// + phase_one_load_raw_c). Fresh implementation: a "Raw" directory of
// (tag, type, len, data) entries holds dims/format/offsets/black tables;
// the compressed payload (formats 5/6) is one ph1 bit stream per row
// (per-row offset table) coding two interleaved parity chains — every 8
// columns a unary+1-bit code reselects each chain's difference bit-length
// from a fixed class table; len 14 escapes to a raw 16-bit sample. Output
// applies <<2 scaling (format != 8), the format-5 toe curve, and the
// per-row/column black correction tables.
// ---------------------------------------------------------------------------
static uint16_t* decode_iiq(const uint8_t* buf, size_t len,
                            ArtRawMeta* meta, size_t base) {
    Reader r{buf, len, true};
    if ((r.u32(base) & 0xFFFF) != 0x4949) return nullptr;  // II only
    if ((r.u32(base + 4) >> 8) != 0x526177) return nullptr;  // "Raw"
    size_t dir = base + r.u32(base + 8);
    if (dir + 8 > len) return nullptr;
    uint32_t entries = r.u32(dir);
    if (entries > 4096) return nullptr;

    int rw = 0, rh = 0, format = 0, flip_code = 0;
    uint32_t data_off = 0, strip_off = 0, black = 0;
    uint32_t split_col = 0, black_col = 0, split_row = 0, black_row = 0;
    double wb[3] = {0, 0, 0};
    char model[64] = {0};
    size_t p = dir + 8;
    for (uint32_t e = 0; e < entries && p + 16 <= len; ++e, p += 16) {
        uint32_t tag = r.u32(p);
        uint32_t data = r.u32(p + 12);
        switch (tag) {
            case 0x100: flip_code = (int)(data & 3); break;
            case 0x107:
                for (int c = 0; c < 3; ++c) {
                    uint32_t b = r.u32(base + data + 4u * c);
                    float f;
                    memcpy(&f, &b, 4);
                    wb[c] = f;
                }
                break;
            case 0x108: rw = (int)data; break;
            case 0x109: rh = (int)data; break;
            case 0x10e: format = (int)data; break;
            case 0x10f: data_off = data + (uint32_t)base; break;
            case 0x21c: strip_off = data + (uint32_t)base; break;
            case 0x21d: black = data; break;
            case 0x222: split_col = data; break;
            case 0x223: black_col = data + (uint32_t)base; break;
            case 0x224: split_row = data; break;
            case 0x225: black_row = data + (uint32_t)base; break;
            case 0x301: {
                for (int i = 0; i < 63 && base + data + i < len; ++i) {
                    char c = (char)buf[base + data + i];
                    if (!c) break;
                    model[i] = c;
                }
                char* cam = strstr(model, " camera");
                if (cam) *cam = 0;
                break;
            }
        }
    }
    if (rw <= 0 || rh <= 0 || rw > 65535 || rh > 65535) return nullptr;
    if (format < 3 || !data_off || !strip_off)
        return nullptr;  // uncompressed IIQ: preconverter scope

    // per-row stream offsets
    std::vector<uint32_t> rowoff(rh);
    for (int row = 0; row < rh; ++row) {
        if (strip_off + 4u * row + 4 > len) return nullptr;
        rowoff[row] = r.u32(strip_off + 4u * row);
    }
    // black correction tables (signed shorts, two per row/col)
    std::vector<int16_t> cblk((size_t)rh * 2, 0), rblk((size_t)rw * 2, 0);
    if (black_col && black_col + (size_t)rh * 4 <= len)
        for (int i = 0; i < rh * 2; ++i)
            cblk[i] = (int16_t)r.u16(black_col + 2u * i);
    if (black_row && black_row + (size_t)rw * 4 <= len)
        for (int i = 0; i < rw * 2; ++i)
            rblk[i] = (int16_t)r.u16(black_row + 2u * i);
    uint16_t curve[256];
    for (int i = 0; i < 256; ++i)
        curve[i] = (uint16_t)(i * i / 3.969 + 0.5);

    static const int kLen[] = {8, 7, 6, 9, 11, 10, 5, 12, 14, 13};
    size_t npix = (size_t)rw * rh;
    uint16_t* out = (uint16_t*)calloc(npix, sizeof(uint16_t));
    if (!out) return nullptr;
    int shift = 2 * (format != 8);
    // each row has its own bit stream (rowoff table): row-parallel
    bool all_ok = parallel_chunks((size_t)rh, [&](size_t rowi) {
        int row = (int)rowi;
        std::vector<uint16_t> pix(rw);
        size_t so = (size_t)data_off + rowoff[row];
        if (so >= len) return false;
        Ph1Bits br{buf + so, len - so};
        int pred[2] = {0, 0}, ln[2] = {0, 0};
        int tail = rw & ~7;
        for (int col = 0; col < rw; ++col) {
            if (col >= tail) {
                ln[0] = ln[1] = 14;
            } else if ((col & 7) == 0) {
                for (int i = 0; i < 2; ++i) {
                    int j = 0;
                    while (j < 5 && !br.bits(1)) ++j;
                    if (j) ln[i] = kLen[(j - 1) * 2 + (int)br.bits(1)];
                }
            }
            int i = ln[col & 1];
            if (i == 14)
                pix[col] = (uint16_t)(pred[col & 1] = (int)br.bits(16));
            else if (i > 0)
                pix[col] = (uint16_t)(pred[col & 1] +=
                    (int)br.bits(i) + 1 - (1 << (i - 1)));
            else  // corrupt stream: zero-length code, predictor unchanged
                pix[col] = (uint16_t)pred[col & 1];
            if ((unsigned)pred[col & 1] >> 16) return false;
            if (format == 5 && pix[col] < 256)
                pix[col] = curve[pix[col]];
        }
        uint16_t* rp = out + (size_t)row * rw;
        for (int col = 0; col < rw; ++col) {
            int v = (pix[col] << shift) - (int)black
                  + cblk[(size_t)row * 2 + (col >= (int)split_col)]
                  + rblk[(size_t)col * 2 + (row >= (int)split_row)];
            rp[col] = v > 0 ? (uint16_t)v : 0;
        }
        return true;
    });
    if (!all_ok) { free(out); return nullptr; }

    memset(meta, 0, sizeof(*meta));
    meta->width = rw;
    meta->height = rh;
    // dcraw maps tag 0x100 through "0653" (dcraw flip 0/6/5/3; as EXIF
    // orientation: 1 / 6 / 8 / 3)
    static const int kFlipOri[4] = {1, 6, 8, 3};
    meta->orientation = kFlipOri[flip_code & 3];
    meta->xtrans[0] = -1;
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    static const int rggb[4] = {0, 1, 1, 2};
    for (int i = 0; i < 4; ++i) meta->cfa_pattern[i] = rggb[i];
    double wmax = 0xFFFC - (double)black;
    for (int i = 0; i < 4; ++i) { meta->white[i] = wmax; meta->black[i] = 0; }
    meta->iso = 100.0;
    if (wb[0] > 0 && wb[1] > 0 && wb[2] > 0) {
        meta->as_shot_neutral[0] = wb[1] / wb[0];
        meta->as_shot_neutral[1] = 1.0;
        meta->as_shot_neutral[2] = wb[1] / wb[2];
    }
    strncpy(meta->make, "Phase One", 63);
    if (model[0]) strncpy(meta->model, model, 63);
    return out;
}

static uint16_t* decode_srw(const Reader& r, const std::vector<IFD>& ifds,
                            const IFD* raw, ArtRawMeta* meta) {
    int width = (int)raw->num(256, 0);
    int height = (int)raw->num(257, 0);
    int bps = (int)raw->num(258, 12);
    int comp = (int)raw->num(259, 0);
    if (width <= 0 || height <= 0 || width > 65535 || height > 65535)
        return nullptr;
    const TagValue* so = raw->find(273);
    if (!so || so->nums.empty()) return nullptr;
    size_t data_off = (size_t)so->nums[0];
    if (data_off >= r.len) return nullptr;

    uint16_t* out = (uint16_t*)calloc((size_t)width * height,
                                      sizeof(uint16_t));
    if (!out) return nullptr;
    bool ok = false;
    if (comp == 32770) {
        size_t table_off = (size_t)raw->num(40976, 0);
        ok = table_off && srw_decode_v0(r, table_off, data_off, out,
                                        width, height);
    } else if (comp == 32772) {
        ok = srw_decode_v2(r, data_off, out, width, height, bps);
    } else if (comp == 32773) {
        ok = srw_decode_v3(r, data_off, out, width, height);
    }
    if (!ok) { free(out); return nullptr; }

    memset(meta, 0, sizeof(*meta));
    meta->xtrans[0] = -1;
    meta->width = width;
    meta->height = height;
    meta->orientation = (int)ifds[0].num(274, 1);
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    const TagValue* cfa = raw->find(33422);
    static const int rggb[4] = {0, 1, 1, 2};
    for (int i = 0; i < 4; ++i)
        meta->cfa_pattern[i] =
            (cfa && cfa->nums.size() >= 4) ? (int)cfa->nums[i] : rggb[i];
    for (int i = 0; i < 4; ++i) meta->black[i] = 0.0;
    for (int i = 0; i < 4; ++i) meta->white[i] = (1 << bps) - 1;
    // Samsung MakerNote: a bare IFD at the note offset whose value
    // offsets are relative to the note start; 0xa021 = WB RGGB levels
    // stored R,G1,G2,B, 0xa028 = per-channel offsets to subtract
    const TagValue* mn = nullptr;
    for (auto& ifd : ifds) {
        const TagValue* v = ifd.find(0x927C);
        if (v && v->off) { mn = v; break; }
    }
    if (mn && mn->off + 2 < r.len) {
        Reader nr{r.buf + mn->off, r.len - mn->off, r.little};
        IFD sifd;
        std::vector<uint32_t> subs;
        parse_ifd(nr, 0, sifd, subs, 3);
        const TagValue* wb = sifd.find(0xa021);
        const TagValue* sub = sifd.find(0xa028);
        if (wb && wb->nums.size() >= 4) {
            double lv[4];
            for (int i = 0; i < 4; ++i) {
                lv[i] = wb->nums[i];
                if (sub && sub->nums.size() >= 4) lv[i] -= sub->nums[i];
            }
            if (lv[0] > 0 && lv[3] > 0) {
                double g = 0.5 * (lv[1] + lv[2]);
                meta->as_shot_neutral[0] = g / lv[0];
                meta->as_shot_neutral[1] = 1.0;
                meta->as_shot_neutral[2] = g / lv[3];
            }
        }
    }
    meta->iso = 100.0;
    for (auto& ifd : ifds) {
        const TagValue* iso = ifd.find(34855);
        if (iso && !iso->nums.empty()) { meta->iso = iso->nums[0]; break; }
    }
    const TagValue* mk = ifds[0].find(271);
    if (mk) strncpy(meta->make, mk->str.c_str(), 63);
    const TagValue* md = ifds[0].find(272);
    if (md) strncpy(meta->model, md->str.c_str(), 63);
    return out;
}

// ---------------------------------------------------------------------------
// Panasonic RW2 (reference decode boundary: rtengine/panasonic_decoders.cc
// + dcraw.cc RW2 tag block; fresh implementation from the public RW2
// format descriptions). Scope: the legacy predictive bitstream, v5
// byte-blocks, cs6 (10/14-bit sliced pages) and cs7 byte-blocks.
// ---------------------------------------------------------------------------

// Panasonic streams page the file in 16KB chunks rotated by `load_flags`
// bytes (the first 0x2008 file bytes of each chunk land at the END of
// the working buffer). Legacy bit reads walk the page top-down with a
// 16-byte-group complement on the byte index.
struct PanaPager {
    const uint8_t* src;
    size_t len;
    size_t pos = 0;      // next chunk start in src
    uint8_t buf[0x4000];
    uint32_t vbits = 0;
    int load_flags;
    bool ok = true;

    PanaPager(const uint8_t* s, size_t l, int lf)
        : src(s), len(l), load_flags(lf) {}

    void load_page() {
        size_t first = 0x4000 - (size_t)load_flags;
        memset(buf, 0, sizeof(buf));
        // file order: [first bytes] then [load_flags bytes], rotated
        for (size_t i = 0; i < first && pos + i < len; ++i)
            buf[load_flags + i] = src[pos + i];
        for (size_t j = 0; j < (size_t)load_flags
             && pos + first + j < len; ++j)
            buf[j] = src[pos + first + j];
        pos += 0x4000;
    }

    uint32_t bits(int nbits) {  // legacy bit reader
        if (!vbits) load_page();
        vbits = (vbits - (uint32_t)nbits) & 0x1ffff;
        int byte = (int)(vbits >> 3) ^ 0x3ff0;
        uint32_t v = (uint32_t)buf[byte] | ((uint32_t)buf[byte + 1] << 8);
        return (v >> (vbits & 7)) & ((1u << nbits) - 1);
    }

    void bytes16(uint8_t* out) {  // v5 sequential 16-byte block
        if (!vbits) load_page();
        for (int i = 0; i < 16; ++i) {
            out[i] = buf[vbits++];
            vbits &= 0x3fff;
        }
    }
};

// cs6: one 16-byte page holds 14 bit-sliced symbols (widths
// 14,14,2,10,10,10,2,10,10,10,2,10,10,10); bytes are consumed reversed
static void rw2_cs6_page(const uint8_t* b, uint32_t* pb) {
    uint16_t w[16];
    for (int i = 0; i < 16; ++i) w[i] = b[15 - i];
    pb[0] = ((uint32_t)w[0] << 6) | (w[1] >> 2);
    pb[1] = ((((uint32_t)w[1] & 0x3) << 12) | ((uint32_t)w[2] << 4)
             | (w[3] >> 4)) & 0x3fff;
    pb[2] = (w[3] >> 2) & 0x3;
    pb[3] = (((uint32_t)w[3] & 0x3) << 8) | w[4];
    pb[4] = ((uint32_t)w[5] << 2) | (w[6] >> 6);
    pb[5] = (((uint32_t)w[6] & 0x3f) << 4) | (w[7] >> 4);
    pb[6] = (w[7] >> 2) & 0x3;
    pb[7] = (((uint32_t)w[7] & 0x3) << 8) | w[8];
    pb[8] = (((uint32_t)w[9] << 2) & 0x3fc) | (w[10] >> 6);
    pb[9] = (((uint32_t)w[10] << 4) | (w[11] >> 4)) & 0x3ff;
    pb[10] = (w[11] >> 2) & 0x3;
    pb[11] = (((uint32_t)w[11] & 0x3) << 8) | w[12];
    pb[12] = ((((uint32_t)w[13] << 2) & 0x3fc) | (w[14] >> 6)) & 0x3ff;
    pb[13] = (((uint32_t)w[14] << 4) | (w[15] >> 4)) & 0x3ff;
}

static uint16_t* decode_rw2(const Reader& r, const std::vector<IFD>& ifds,
                            ArtRawMeta* meta) {
    const IFD& ifd0 = ifds[0];
    int rw = (int)ifd0.num(2, 0);    // sensor width
    int rh = (int)ifd0.num(3, 0);    // sensor height
    int bpp = (int)ifd0.num(10, 12);
    int encoding = (int)ifd0.num(45, 0);
    if (rw <= 0 || rh <= 0 || rw > 65535 || rh > 65535) return nullptr;
    const TagValue* offt = ifd0.find(280);
    if (!offt) offt = ifd0.find(273);
    if (!offt || offt->nums.empty()) return nullptr;
    size_t off = (size_t)offt->nums[0];
    if (off >= r.len) return nullptr;

    uint16_t* out = (uint16_t*)calloc((size_t)rw * rh, sizeof(uint16_t));
    if (!out) return nullptr;
    bool ok = true;

    if (encoding == 5) {
        // v5: 16-byte blocks through the rotated pager, 10 (12-bit) or
        // 9 (14-bit) pixels per block
        int blk = bpp == 12 ? 10 : 9;
        PanaPager pg(r.buf + off, r.len - off, 0x2008);
        uint8_t by[16];
        for (int row = 0; row < rh; ++row) {
            uint16_t* rp = out + (size_t)row * rw;
            for (int col = 0; col < rw; col += blk) {
                pg.bytes16(by);
                if (bpp == 12) {
                    rp[col] = (uint16_t)(((by[1] & 0xF) << 8) + by[0]);
                    if (col + 1 < rw) rp[col + 1] =
                        (uint16_t)(16 * by[2] + (by[1] >> 4));
                    if (col + 2 < rw) rp[col + 2] =
                        (uint16_t)(((by[4] & 0xF) << 8) + by[3]);
                    if (col + 3 < rw) rp[col + 3] =
                        (uint16_t)(16 * by[5] + (by[4] >> 4));
                    if (col + 4 < rw) rp[col + 4] =
                        (uint16_t)(((by[7] & 0xF) << 8) + by[6]);
                    if (col + 5 < rw) rp[col + 5] =
                        (uint16_t)(16 * by[8] + (by[7] >> 4));
                    if (col + 6 < rw) rp[col + 6] =
                        (uint16_t)(((by[10] & 0xF) << 8) + by[9]);
                    if (col + 7 < rw) rp[col + 7] =
                        (uint16_t)(16 * by[11] + (by[10] >> 4));
                    if (col + 8 < rw) rp[col + 8] =
                        (uint16_t)(((by[13] & 0xF) << 8) + by[12]);
                    if (col + 9 < rw) rp[col + 9] =
                        (uint16_t)(16 * by[14] + (by[13] >> 4));
                } else {
                    rp[col] = (uint16_t)(by[0] + ((by[1] & 0x3F) << 8));
                    if (col + 1 < rw) rp[col + 1] = (uint16_t)
                        ((by[1] >> 6) + 4 * by[2] + ((by[3] & 0xF) << 10));
                    if (col + 2 < rw) rp[col + 2] = (uint16_t)
                        ((by[3] >> 4) + 16 * by[4] + ((by[5] & 3) << 12));
                    if (col + 3 < rw) rp[col + 3] = (uint16_t)
                        (((by[5] & 0xFC) >> 2) + (by[6] << 6));
                    if (col + 4 < rw) rp[col + 4] = (uint16_t)
                        (by[7] + ((by[8] & 0x3F) << 8));
                    if (col + 5 < rw) rp[col + 5] = (uint16_t)
                        ((by[8] >> 6) + 4 * by[9] + ((by[10] & 0xF) << 10));
                    if (col + 6 < rw) rp[col + 6] = (uint16_t)
                        ((by[10] >> 4) + 16 * by[11] + ((by[12] & 3) << 12));
                    if (col + 7 < rw) rp[col + 7] = (uint16_t)
                        (((by[12] & 0xFC) >> 2) + (by[13] << 6));
                    if (col + 8 < rw) rp[col + 8] = (uint16_t)
                        (by[14] + ((by[15] & 0x3F) << 8));
                }
            }
        }
    } else if (encoding == 6) {
        // cs6: 16-row strides of 11-pixel blocks with base/multiplier
        // coded pixel groups
        int blocksperrow = rw / 11;
        size_t rowbytes = (size_t)blocksperrow * 16;
        for (int row = 0; row < rh - 15 && ok; row += 16) {
            int rows = std::min(16, rh - row);
            const uint8_t* iobuf = r.buf + off
                                 + (size_t)(row / 16) * rowbytes * 16;
            if (off + (size_t)(row / 16) * rowbytes * 16
                + rowbytes * rows > r.len) { ok = false; break; }
            for (int crow = 0; crow < rows; ++crow) {
                uint16_t* rp = out + (size_t)(row + crow) * rw;
                int col = 0;
                for (int rb = 0; rb < blocksperrow; ++rb) {
                    uint32_t pb[14];
                    rw2_cs6_page(iobuf + (size_t)crow * rowbytes
                                 + (size_t)rb * 16, pb);
                    int cur = 0;
                    uint32_t oddeven[2] = {0, 0}, nonzero[2] = {0, 0};
                    uint32_t pmul = 0, pixel_base = 0;
                    for (int pix = 0; pix < 11; ++pix) {
                        if (pix % 3 == 2) {
                            uint32_t base = pb[cur++];
                            if (base == 3) base = 4;
                            pixel_base = 0x200u << base;
                            pmul = 1u << base;
                        }
                        uint32_t epixel = pb[cur++];
                        if (oddeven[pix % 2]) {
                            epixel *= pmul;
                            if (pixel_base < 0x2000
                                && nonzero[pix % 2] > pixel_base)
                                epixel += nonzero[pix % 2] - pixel_base;
                            nonzero[pix % 2] = epixel;
                        } else {
                            oddeven[pix % 2] = epixel;
                            if (epixel)
                                nonzero[pix % 2] = epixel;
                            else
                                epixel = nonzero[pix % 2];
                        }
                        uint32_t spix = epixel - 0xf;
                        if (spix <= 0xffff)
                            rp[col++] = (uint16_t)(spix & 0xffff);
                        else {
                            epixel = (uint32_t)(((int32_t)(epixel
                                     + 0x7ffffff1)) >> 0x1f);
                            rp[col++] = (uint16_t)(epixel & 0x3fff);
                        }
                    }
                }
            }
        }
    } else if (encoding == 7) {
        // cs7: sequential 16-byte blocks of 9 (14-bit) / 10 (12-bit)
        // pixels in 16-row strides
        int blk = bpp == 14 ? 9 : 10;
        const uint8_t* bytes = r.buf + off;
        size_t avail = r.len - off;
        size_t consumed = 0;
        for (int row = 0; row < rh - 15 && ok; row += 16) {
            int rows = std::min(16, rh - row);
            for (int crow = 0; crow < rows; ++crow) {
                uint16_t* rp = out + (size_t)(row + crow) * rw;
                for (int col = 0; col < rw - blk + 1; col += blk) {
                    if (consumed + 16 > avail) { ok = false; break; }
                    const uint8_t* by = bytes + consumed;
                    consumed += 16;
                    if (bpp == 14) {
                        rp[col] = (uint16_t)(by[0] + ((by[1] & 0x3F) << 8));
                        rp[col + 1] = (uint16_t)((by[1] >> 6) + 4 * by[2]
                                      + ((by[3] & 0xF) << 10));
                        rp[col + 2] = (uint16_t)((by[3] >> 4) + 16 * by[4]
                                      + ((by[5] & 3) << 12));
                        rp[col + 3] = (uint16_t)(((by[5] & 0xFC) >> 2)
                                      + (by[6] << 6));
                        rp[col + 4] = (uint16_t)(by[7]
                                      + ((by[8] & 0x3F) << 8));
                        rp[col + 5] = (uint16_t)((by[8] >> 6) + 4 * by[9]
                                      + ((by[10] & 0xF) << 10));
                        rp[col + 6] = (uint16_t)((by[10] >> 4) + 16 * by[11]
                                      + ((by[12] & 3) << 12));
                        rp[col + 7] = (uint16_t)(((by[12] & 0xFC) >> 2)
                                      + (by[13] << 6));
                        rp[col + 8] = (uint16_t)(by[14]
                                      + ((by[15] & 0x3F) << 8));
                    } else {
                        rp[col] = (uint16_t)(((by[1] & 0xF) << 8) + by[0]);
                        rp[col + 1] = (uint16_t)(16 * by[2] + (by[1] >> 4));
                        rp[col + 2] = (uint16_t)(((by[4] & 0xF) << 8)
                                      + by[3]);
                        rp[col + 3] = (uint16_t)(16 * by[5] + (by[4] >> 4));
                        rp[col + 4] = (uint16_t)(((by[7] & 0xF) << 8)
                                      + by[6]);
                        rp[col + 5] = (uint16_t)(16 * by[8] + (by[7] >> 4));
                        rp[col + 6] = (uint16_t)(((by[10] & 0xF) << 8)
                                      + by[9]);
                        rp[col + 7] = (uint16_t)(16 * by[11]
                                      + (by[10] >> 4));
                        rp[col + 8] = (uint16_t)(((by[13] & 0xF) << 8)
                                      + by[12]);
                        rp[col + 9] = (uint16_t)(16 * by[14]
                                      + (by[13] >> 4));
                    }
                }
            }
        }
    } else {
        // legacy predictive bitstream: 14-pixel groups, two parity
        // predictors, shift codes every third pixel
        PanaPager pg(r.buf + off, r.len - off, 0x2008);
        int sh = 0, pred[2], nonz[2];
        for (int row = 0; row < rh; ++row) {
            for (int col = 0; col < rw; ++col) {
                int i = col % 14;
                if (i == 0)
                    pred[0] = pred[1] = nonz[0] = nonz[1] = 0;
                if (i % 3 == 2)
                    sh = 4 >> (3 - (int)pg.bits(2));
                if (nonz[i & 1]) {
                    int j = (int)pg.bits(8);
                    if (j) {
                        if ((pred[i & 1] -= 0x80 << sh) < 0 || sh == 4)
                            pred[i & 1] &= ~(-1 << sh);
                        pred[i & 1] += j << sh;
                    }
                } else if ((nonz[i & 1] = (int)pg.bits(8)) || i > 11) {
                    pred[i & 1] = nonz[i & 1] << 4 | (int)pg.bits(4);
                }
                out[(size_t)row * rw + col] = (uint16_t)pred[col & 1];
            }
        }
    }
    if (!ok) { free(out); return nullptr; }

    memset(meta, 0, sizeof(*meta));
    meta->xtrans[0] = -1;
    meta->width = rw;
    meta->height = rh;
    meta->orientation = (int)ifd0.num(274, 1);
    // crop borders: top, left, bottom, right (tags 4-7)
    int top = (int)ifd0.num(4, 0), left = (int)ifd0.num(5, 0);
    int bot = (int)ifd0.num(6, 0), right = (int)ifd0.num(7, 0);
    if (bot > top && right > left && bot <= rh && right <= rw) {
        meta->active_area[0] = top;
        meta->active_area[1] = left;
        meta->active_area[2] = bot;
        meta->active_area[3] = right;
    } else {
        for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    }
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    // CFA: tag 9, 1..4 -> pattern at raw (0,0)
    static const int kPat[4][4] = {{0, 1, 1, 2},   // RGGB
                                   {1, 0, 2, 1},   // GRBG
                                   {1, 2, 0, 1},   // GBRG
                                   {2, 1, 1, 0}};  // BGGR
    int cfa = (int)ifd0.num(9, 1);
    if (cfa < 1 || cfa > 4) cfa = 1;
    for (int i = 0; i < 4; ++i)
        meta->cfa_pattern[i] = kPat[cfa - 1][i];
    // per-channel black (tags 28-30: R, G, B); camconst black adds a
    // pedestal on top (dcraw scale merges `black` into cblack)
    double cbl[3] = {ifd0.num(28, 0), ifd0.num(29, 0), ifd0.num(30, 0)};
    for (int i = 0; i < 4; ++i)
        meta->black[i] = cbl[meta->cfa_pattern[i]];
    double wmax = (1 << std::min(bpp, 16)) - 1;
    for (int i = 0; i < 4; ++i) meta->white[i] = wmax;
    meta->iso = ifd0.num(23, 100);
    // WB: tags 36-38 (R, G, B levels) or legacy 17/18 (R, B over 256)
    double wr = ifd0.num(36, 0), wg = ifd0.num(37, 0),
           wb2 = ifd0.num(38, 0);
    if (wr <= 0 || wg <= 0 || wb2 <= 0) {
        double r17 = ifd0.num(17, 0), b18 = ifd0.num(18, 0);
        if (r17 > 0 && b18 > 0) { wr = r17; wg = 256.0; wb2 = b18; }
    }
    if (wr > 0 && wg > 0 && wb2 > 0) {
        meta->as_shot_neutral[0] = wg / wr;
        meta->as_shot_neutral[1] = 1.0;
        meta->as_shot_neutral[2] = wg / wb2;
    }
    const TagValue* mk = ifd0.find(271);
    if (mk) strncpy(meta->make, mk->str.c_str(), 63);
    const TagValue* md = ifd0.find(272);
    if (md) strncpy(meta->model, md->str.c_str(), 63);
    return out;
}

// ---------------------------------------------------------------------------
// Sony ARW (reference decode boundary: rtengine/dcraw.cc
// sony_arw2_load_raw; fresh implementation from the public ARW2 "cRAW"
// block description). Scope: ARW 2.x compressed (compression 32767,
// 1 byte/pixel 16-pixel delta blocks + the tag-0x7010 linearization
// curve), lossless-compressed (compression 7: LJ92 tiles whose
// 4-component samples are 2x2 Bayer quads — the layout LibRaw's
// sony_ljpeg_load_raw implements; the reference reaches it only through
// the optional LibRaw backend, rawimage.h:81, rawimage.cc:506-540),
// and uncompressed 14/16-bit strips. ARW 1.0 routes through the
// preconverter hook.
// ---------------------------------------------------------------------------

// Decode one LJ92 tile stream of 2x2-quad samples into the mosaic at
// (ty, tx). Each LJPEG sample row of `4 * lj.width` values covers two
// mosaic rows and `2 * lj.width` columns: group k of 4 consecutive
// values is the quad at (2*jrow, 2*k) = {v0 v1 / v2 v3}.
static bool blit_ljpeg_quads(const LJ92& lj, const uint16_t* tilebuf,
                             int ty, int tx, int width, int height,
                             uint16_t* out) {
    for (int jrow = 0; jrow < lj.height; ++jrow) {
        int row0 = ty + 2 * jrow;
        if (row0 >= height) break;
        const uint16_t* sp = tilebuf + (size_t)jrow * lj.width * 4;
        for (int k = 0; k < lj.width; ++k) {
            int col0 = tx + 2 * k;
            if (col0 >= width) break;
            uint16_t* d0 = out + (size_t)row0 * width + col0;
            d0[0] = sp[4 * k];
            if (col0 + 1 < width) d0[1] = sp[4 * k + 1];
            if (row0 + 1 < height) {
                uint16_t* d1 = d0 + width;
                d1[0] = sp[4 * k + 2];
                if (col0 + 1 < width) d1[1] = sp[4 * k + 3];
            }
        }
    }
    return true;
}

static bool decode_arw_lossless(const Reader& r, const IFD& raw, int width,
                                int height, uint16_t* out) {
    const TagValue* tile_off = raw.find(324);
    const TagValue* tile_cnt = raw.find(325);
    if (!tile_off || tile_off->nums.empty()) return false;
    int tw = (int)raw.num(322, width);
    int th = (int)raw.num(323, height);
    if (tw <= 0 || th <= 0 || (tw | th) & 1) return false;
    int tiles_x = (width + tw - 1) / tw;
    // quad tiles land in disjoint output rects: tile-parallel
    return parallel_chunks(tile_off->nums.size(), [&](size_t t) {
        size_t off = (size_t)tile_off->nums[t];
        size_t cnt = (tile_cnt && t < tile_cnt->nums.size())
                         ? (size_t)tile_cnt->nums[t]
                         : (off < r.len ? r.len - off : 0);
        if (off >= r.len || off + cnt > r.len) return false;
        LJ92 lj;
        if (!lj.parse(r.buf + off, cnt)) return false;
        if (lj.components != 4) return false;
        if (2 * lj.width != tw || 2 * lj.height != th) return false;
        std::vector<uint16_t> tilebuf((size_t)lj.width * lj.height * 4);
        if (!lj.decode(tilebuf.data())) return false;
        int tx = (int)(t % tiles_x) * tw;
        int ty = (int)(t / tiles_x) * th;
        blit_ljpeg_quads(lj, tilebuf.data(), ty, tx, width, height, out);
        return true;
    });
}

static uint16_t* decode_arw(const Reader& r, const std::vector<IFD>& ifds,
                            const IFD* raw, ArtRawMeta* meta) {
    int width = (int)raw->num(256, 0);
    int height = (int)raw->num(257, 0);
    int bps = (int)raw->num(258, 16);
    int compression = (int)raw->num(259, 1);
    if (width <= 0 || height <= 0 || width > 65535 || height > 65535)
        return nullptr;

    auto find_any = [&](uint16_t tag) -> const TagValue* {
        for (auto& ifd : ifds) {
            const TagValue* v = ifd.find(tag);
            if (v) return v;
        }
        return nullptr;
    };

    // Sony linearization curve (tag 0x7010 = 28688): four knots in the
    // 12-bit domain; five segments of slope 1,2,4,8,16
    std::vector<uint16_t> curve(0x1000);
    for (int i = 0; i < 0x1000; ++i) curve[i] = (uint16_t)i;
    const TagValue* sk = find_any(28688);
    bool have_curve = sk && sk->nums.size() >= 4;
    if (have_curve) {
        uint32_t knots[6] = {0, 0, 0, 0, 0, 4095};
        for (int i = 0; i < 4; ++i)
            knots[i + 1] = ((uint32_t)sk->nums[i] >> 2) & 0xfff;
        for (int i = 0; i < 5; ++i)
            for (uint32_t j = knots[i] + 1;
                 j <= knots[i + 1] && j < 0x1000; ++j)
                curve[j] = (uint16_t)(curve[j - 1] + (1u << i));
    }

    const TagValue* so = raw->find(273);
    const TagValue* sc = raw->find(279);
    // lossless tiles carry TileOffsets (324) instead of strips
    if ((!so || so->nums.empty()) && compression != 7) return nullptr;
    size_t off = (so && !so->nums.empty()) ? (size_t)so->nums[0] : 0;
    size_t bytes = sc && !sc->nums.empty() ? (size_t)sc->nums[0]
                                           : (off < r.len ? r.len - off : 0);
    if (off >= r.len && compression != 7) return nullptr;

    uint16_t* out = (uint16_t*)calloc((size_t)width * height,
                                      sizeof(uint16_t));
    if (!out) return nullptr;

    double wmax = (1 << std::min(bps, 16)) - 1;
    if (compression == 32767 && bytes >= (size_t)width * height
        && off + (size_t)width * height <= r.len) {
        // ARW2 cRAW: each 16-byte block packs 16 pixels of one CFA color
        // (written to every other column): 32-bit header with 11-bit
        // max/min and their 4-bit positions, then fourteen 7-bit deltas
        // shifted so the span max-min fits 7 bits
        for (int row = 0; row < height; ++row) {
            const uint8_t* data = r.buf + off + (size_t)row * width;
            int col = 0;
            for (const uint8_t* dp = data; col < width - 30; dp += 16) {
                uint32_t val = (uint32_t)dp[0] | ((uint32_t)dp[1] << 8)
                             | ((uint32_t)dp[2] << 16)
                             | ((uint32_t)dp[3] << 24);
                int vmax = (int)(val & 0x7ff);
                int vmin = (int)((val >> 11) & 0x7ff);
                int imax = (int)((val >> 22) & 0x0f);
                int imin = (int)((val >> 26) & 0x0f);
                int sh;
                for (sh = 0; sh < 4 && (0x80 << sh) <= vmax - vmin; ++sh) {}
                int bit = 30;
                uint16_t pix[16];
                for (int i = 0; i < 16; ++i) {
                    if (i == imax) {
                        pix[i] = (uint16_t)vmax;
                    } else if (i == imin) {
                        pix[i] = (uint16_t)vmin;
                    } else {
                        // the high byte of the last 7-bit field of the
                        // final block sits one past the strip; its bits
                        // are never selected — read it only if in range
                        const uint8_t* hb = dp + (bit >> 3) + 1;
                        int hi = hb < r.buf + r.len ? *hb : 0;
                        int b16 = dp[bit >> 3] | (hi << 8);
                        int p = (((b16 >> (bit & 7)) & 0x7f) << sh) + vmin;
                        pix[i] = (uint16_t)std::min(p, 0x7ff);
                        bit += 7;
                    }
                }
                for (int i = 0; i < 16; ++i, col += 2)
                    out[(size_t)row * width + col] = curve[(pix[i] << 1)
                                                           & 0xfff];
                // two interleaved color phases per 32-column span
                col -= (col & 1) ? 1 : 31;
            }
        }
        // conservative ARW2 white level (dcraw.cc RT fix); camconst
        // per-ISO levels override per model
        wmax = 16300.0;
    } else if (compression == 7) {
        // lossless-compressed: LJ92 2x2-quad tiles, no linearization
        // curve (the stream carries the full 14-bit values)
        if (!decode_arw_lossless(r, *raw, width, height, out)) {
            free(out);
            return nullptr;
        }
    } else if (compression == 1) {
        if (!decode_strips_tiles(r, *raw, width, height, bps, 1, 1, out)) {
            free(out);
            return nullptr;
        }
        if (have_curve) wmax = (double)curve[0xffe];
    } else {
        free(out);
        return nullptr;
    }

    memset(meta, 0, sizeof(*meta));
    meta->xtrans[0] = -1;
    meta->width = width;
    meta->height = height;
    meta->orientation = (int)ifds[0].num(274, 1);
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    const TagValue* cfa = raw->find(33422);
    static const int rggb[4] = {0, 1, 1, 2};
    for (int i = 0; i < 4; ++i)
        meta->cfa_pattern[i] =
            (cfa && cfa->nums.size() >= 4) ? (int)cfa->nums[i] : rggb[i];
    for (int i = 0; i < 4; ++i) meta->white[i] = wmax;
    // black level: camconst supplies per-model values (512 on most
    // bodies); the container itself does not carry a DNG BlackLevel
    meta->iso = 100.0;
    const TagValue* iso = find_any(34855);
    if (iso && !iso->nums.empty()) meta->iso = iso->nums[0];

    // white balance: tag 0x7313 (WB_RGGBLevels) preferred, else 0x7303
    // (dcraw.cc:6660-6667 ordering fixes)
    double cm[4] = {0, 0, 0, 0};
    const TagValue* wb = find_any(29459);
    if (wb && wb->nums.size() >= 4) {
        for (int i = 0; i < 4; ++i) cm[i] = wb->nums[i];
        int i = (cm[1] == 1024 && cm[2] == 1024) ? 2 : 0;
        std::swap(cm[i], cm[i + 1]);
    } else if ((wb = find_any(29443)) && wb->nums.size() >= 4) {
        for (int c = 0; c < 4; ++c) cm[c ^ (c < 2 ? 1 : 0)] = wb->nums[c];
    }
    if (cm[0] > 0 && cm[1] > 0 && cm[2] > 0) {
        meta->as_shot_neutral[0] = cm[1] / cm[0];
        meta->as_shot_neutral[1] = 1.0;
        meta->as_shot_neutral[2] = cm[1] / cm[2];
    }
    const TagValue* mk = ifds[0].find(271);
    if (mk) strncpy(meta->make, mk->str.c_str(), 63);
    const TagValue* md = ifds[0].find(272);
    if (md) strncpy(meta->model, md->str.c_str(), 63);
    return out;
}

// ---------------------------------------------------------------------------
// Fuji lossless compression ("RAF compressed", X-Trans and GFX Bayer
// bodies). Reference decode boundary: rtengine/fujicompressed.cc (the
// LibRaw-derived strip decoder). This is a fresh implementation of the
// published bitstream model: per-768-column strips, 6-sensor-row line
// groups held in per-color sliding line buffers (5 R, 8 G, 5 B lines),
// adaptive Golomb coding with 41 quantized-gradient contexts per parity,
// and a fixed 6-pass traversal schedule in which some even lanes are
// reconstructed by deterministic interpolation instead of being coded.
// ---------------------------------------------------------------------------

namespace {

struct FujiQuant {
    int bits;            // 12 / 14 / 16
    int total;           // 1 << bits
    int qmax;            // total - 1
    int line_width;      // samples per color line (block cols * 2/3 or /2)
    int escape_at;       // zero-run >= this => raw escape (3*bits - 1)
    int max_grad_base;   // gradient accumulator reset base (total >> 6)
    std::vector<int8_t> qtab;  // diff -> level, index diff + qmax

    void init(int bits_, int line_width_) {
        bits = bits_;
        total = 1 << bits;
        qmax = total - 1;
        line_width = line_width_;
        escape_at = 4 * bits - bits - 1;
        max_grad_base = total >> 6;
        qtab.assign(2 * total - 1, 0);
        // level thresholds of the published model: 0x12 / 0x43 / 0x114
        const int q1 = 0x12, q2 = 0x43, q3 = 0x114;
        for (int d = -qmax; d <= qmax; ++d) {
            int a = d < 0 ? -d : d, lv;
            if (d == 0) lv = 0;
            else if (a < q1) lv = 1;
            else if (a < q2) lv = 2;
            else if (a < q3) lv = 3;
            else lv = 4;
            qtab[d + qmax] = (int8_t)(d < 0 ? -lv : lv);
        }
        // negative side uses <= at the thresholds (asymmetric by 1)
        for (int d = -qmax; d < 0; ++d) {
            int a = -d, lv;
            if (a >= q3) lv = 4;
            else if (a >= q2) lv = 3;
            else if (a >= q1) lv = 2;
            else lv = 1;
            qtab[d + qmax] = (int8_t)(-lv);
        }
    }
    int quant_grad(int v1, int v2) const {
        auto clampi = [&](int v) {
            return v < -qmax ? -qmax : (v > qmax ? qmax : v);
        };
        return 9 * qtab[clampi(v1) + qmax] + qtab[clampi(v2) + qmax];
    }
};

// MSB-first bit reader over an in-memory strip; reads past the end
// yield zeros (the container's size table may understate a strip).
struct FujiBits {
    const uint8_t* p;
    size_t n;
    size_t pos = 0;  // bit position
    int zero_run() {
        int c = 0;
        while (c < 512) {
            size_t byte = pos >> 3;
            int bit = byte < n ? (p[byte] >> (7 - (pos & 7))) & 1 : 1;
            ++pos;
            if (bit) break;
            ++c;
        }
        return c;
    }
    int read(int k) {
        int v = 0;
        while (k-- > 0) {
            size_t byte = pos >> 3;
            int bit = byte < n ? (p[byte] >> (7 - (pos & 7))) & 1 : 0;
            v = v << 1 | bit;
            ++pos;
        }
        return v;
    }
};

// context accumulators: (sum of |code|, count) per quantized gradient
struct FujiGrad { int acc, cnt; };

// number of shift bits so that cnt << k >= acc (the adaptive Golomb k)
static int fuji_code_bits(const FujiGrad& g) {
    int k = 0;
    if (g.acc > g.cnt)
        while (k <= 12 && (g.cnt << ++k) < g.acc) {}
    return k;
}

// line-buffer indices: 5 red, 8 green, 5 blue sliding lines
enum { FL_R = 0, FL_G = 5, FL_B = 13, FL_TOTAL = 18 };

struct FujiStrip {
    const FujiQuant& q;
    FujiBits bits;
    std::vector<uint16_t> lines;         // FL_TOTAL x (line_width + 2)
    FujiGrad grad_even[3][41], grad_odd[3][41];

    explicit FujiStrip(const FujiQuant& q_, const uint8_t* data, size_t n)
        : q(q_), bits{data, n} {
        lines.assign((size_t)FL_TOTAL * (q.line_width + 2), 0);
        for (int s = 0; s < 3; ++s)
            for (int g = 0; g < 41; ++g) {
                grad_even[s][g] = {q.max_grad_base, 1};
                grad_odd[s][g] = {q.max_grad_base, 1};
            }
    }
    uint16_t* line(int i) { return lines.data() + (size_t)i * (q.line_width + 2); }

    // neighbor fetches; `pos` is the sample index, storage is offset by
    // the 1-element left border.
    // even lanes predict from the two prior lines of the same color;
    // odd lanes also see the already-decoded flanking even samples.
    int decode_code(FujiGrad& g) {
        int run = bits.zero_run();
        int code;
        if (run < q.escape_at) {
            int k = fuji_code_bits(g);
            code = (run << k) | bits.read(k);
        } else {
            code = bits.read(q.bits) + 1;
        }
        // sign unfold + context update
        int mag = code & 1 ? -1 - code / 2 : code / 2;
        g.acc += mag < 0 ? -mag : mag;
        if (g.cnt == 0x40) { g.acc >>= 1; g.cnt >>= 1; }
        g.cnt++;
        return mag;
    }
    void store(uint16_t* cur, int pos, int val) {
        if (val < 0) val += q.total;
        else if (val > q.qmax) val -= q.total;
        cur[1 + pos] = val < 0 ? 0 : (val > q.qmax ? q.qmax : val);
    }
    void sample_even(int li, int pos, FujiGrad* grads) {
        uint16_t* cur = line(li);
        const uint16_t* up = line(li - 1);
        const uint16_t* up2 = line(li - 2);
        int b = up[1 + pos], c = up[pos], d = up[2 + pos], f = up2[1 + pos];
        int grad = q.quant_grad(b - f, c - b);
        int db = std::abs(c - b), df = std::abs(f - b), dd = std::abs(d - b);
        int pred;
        if (db > df && db > dd) pred = f + d + 2 * b;
        else if (dd > db && dd > df) pred = f + c + 2 * b;
        else pred = d + c + 2 * b;
        int mag = decode_code(grads[std::abs(grad)]);
        store(cur, pos, (pred >> 2) + (grad < 0 ? -mag : mag));
    }
    void sample_odd(int li, int pos, FujiGrad* grads) {
        uint16_t* cur = line(li);
        const uint16_t* up = line(li - 1);
        int a = cur[pos], b = up[1 + pos], c = up[pos], d = up[2 + pos],
            gg = cur[2 + pos];
        int grad = q.quant_grad(b - c, c - a);
        int pred = ((b > c && b > d) || (b < c && b < d))
                       ? (gg + a + 2 * b) >> 2
                       : (a + gg) >> 1;
        int mag = decode_code(grads[std::abs(grad)]);
        store(cur, pos, pred + (grad < 0 ? -mag : mag));
    }
    void interp_even(int li, int pos) {
        uint16_t* cur = line(li);
        const uint16_t* up = line(li - 1);
        const uint16_t* up2 = line(li - 2);
        int b = up[1 + pos], c = up[pos], d = up[2 + pos], f = up2[1 + pos];
        int db = std::abs(c - b), df = std::abs(f - b), dd = std::abs(d - b);
        if (db > df && db > dd) cur[1 + pos] = (f + d + 2 * b) >> 2;
        else if (dd > db && dd > df) cur[1 + pos] = (f + c + 2 * b) >> 2;
        else cur[1 + pos] = (d + c + 2 * b) >> 2;
    }
    // propagate the left/right borders of a color group from each line's
    // predecessor (interior first/last sample)
    void extend(int first, int last) {
        for (int i = first; i <= last; ++i) {
            uint16_t* cur = line(i);
            const uint16_t* prev = line(i - 1);
            cur[0] = prev[1];
            cur[q.line_width + 1] = prev[q.line_width];
        }
    }
};

// Even-lane coding mode per (pass, line): the X-Trans schedule leaves
// some lanes interpolated (they carry no sensor sample at that offset).
enum FujiEvenMode {
    FEM_SAMPLE,        // every even lane coded
    FEM_INTERP,        // every even lane interpolated
    FEM_INTERP_MOD0,   // interpolated when pos % 4 == 0, coded otherwise
    FEM_INTERP_MOD2,   // interpolated when pos % 4 == 2, coded otherwise
};

struct FujiPass {
    int la, lb;       // the two lines decoded in this pass
    int gset;         // gradient context set (0..2)
    FujiEvenMode ma, mb;
};

// The six passes cover lines (R2,G2)(G3,B2)(R3,G4)(G5,B3)(R4,G6)(G7,B4)
// with gradient sets 0,1,2,0,1,2. X-Trans additionally interpolates the
// even lanes listed below; Bayer codes every lane.
static const FujiPass kFujiPassesXtrans[6] = {
    {FL_R + 2, FL_G + 2, 0, FEM_INTERP, FEM_SAMPLE},
    {FL_G + 3, FL_B + 2, 1, FEM_SAMPLE, FEM_INTERP},
    {FL_R + 3, FL_G + 4, 2, FEM_INTERP_MOD0, FEM_INTERP},
    {FL_G + 5, FL_B + 3, 0, FEM_SAMPLE, FEM_INTERP_MOD2},
    {FL_R + 4, FL_G + 6, 1, FEM_INTERP_MOD2, FEM_SAMPLE},
    {FL_G + 7, FL_B + 4, 2, FEM_INTERP, FEM_INTERP_MOD0},
};
static const FujiPass kFujiPassesBayer[6] = {
    {FL_R + 2, FL_G + 2, 0, FEM_SAMPLE, FEM_SAMPLE},
    {FL_G + 3, FL_B + 2, 1, FEM_SAMPLE, FEM_SAMPLE},
    {FL_R + 3, FL_G + 4, 2, FEM_SAMPLE, FEM_SAMPLE},
    {FL_G + 5, FL_B + 3, 0, FEM_SAMPLE, FEM_SAMPLE},
    {FL_R + 4, FL_G + 6, 1, FEM_SAMPLE, FEM_SAMPLE},
    {FL_G + 7, FL_B + 4, 2, FEM_SAMPLE, FEM_SAMPLE},
};

// one even lane of one pass-line: coded or interpolated per the mode.
// X-Trans passes 5/2 interpolate B4/R3 on pos%4==0 and pass 3/4 on
// pos%4==2; the remaining lanes are coded against the pass context set.
static inline void fuji_even_step(FujiStrip& st, int li, int pos,
                                  FujiEvenMode m, FujiGrad* grads) {
    bool interp;
    switch (m) {
        case FEM_SAMPLE: interp = false; break;
        case FEM_INTERP: interp = true; break;
        case FEM_INTERP_MOD0: interp = (pos & 3) == 0; break;
        default: interp = (pos & 3) == 2; break;
    }
    if (interp) st.interp_even(li, pos);
    else st.sample_even(li, pos, grads);
}

static void fuji_decode_pass(FujiStrip& st, const FujiPass& ps) {
    const int lw = st.q.line_width;
    int even = 0, odd = 1;
    while (even < lw || odd < lw) {
        if (even < lw) {
            fuji_even_step(st, ps.la, even, ps.ma, st.grad_even[ps.gset]);
            fuji_even_step(st, ps.lb, even, ps.mb, st.grad_even[ps.gset]);
            even += 2;
        }
        // odd lanes trail the even front by 4 samples (they need the
        // flanking even values of the *next* even position)
        if (even > 8) {
            st.sample_odd(ps.la, odd, st.grad_odd[ps.gset]);
            st.sample_odd(ps.lb, odd, st.grad_odd[ps.gset]);
            odd += 2;
        }
    }
    // border propagation: R/G after the R-passes, G/B after the B-passes
    if (ps.la < FL_G) {  // pass decoded an R line
        st.extend(FL_R + 2, FL_R + 4);
        st.extend(FL_G + 2, FL_G + 7);
    } else {
        st.extend(FL_G + 2, FL_G + 7);
        st.extend(FL_B + 2, FL_B + 4);
    }
}

// map one decoded 6-row line group into the output mosaic
static void fuji_emit_lines(FujiStrip& st, uint16_t* out, int out_w,
                            int row0, int col0, int ncols,
                            const int* xtrans /* 36 or null */,
                            const int* bayer2x2 /* 4 */) {
    for (int rr = 0; rr < 6; ++rr) {
        uint16_t* dst = out + (size_t)(row0 + rr) * out_w + col0;
        for (int p = 0; p < ncols; ++p) {
            int color = xtrans ? xtrans[rr * 6 + p % 6]
                               : bayer2x2[(rr & 1) * 2 + (p & 1)];
            int li, idx;
            if (xtrans) {
                // X-Trans line packing: 2/3 of the lanes carry samples
                idx = (((p * 2 / 3) & ~1) | (p % 3 & 1)) + ((p % 3) >> 1);
            } else {
                idx = p >> 1;
            }
            if (color == 0) li = FL_R + 2 + (rr >> 1);
            else if (color == 2) li = FL_B + 2 + (rr >> 1);
            else li = FL_G + 2 + rr;
            dst[p] = st.line(li)[1 + idx];
        }
    }
    // slide history: last two decoded lines of each color become the
    // predecessors for the next group, the rest reset to zero
    const int lw2 = st.q.line_width + 2;
    auto cp = [&](int dst_i, int src_i) {
        memcpy(st.line(dst_i), st.line(src_i), lw2 * sizeof(uint16_t));
    };
    cp(FL_R + 0, FL_R + 3); cp(FL_R + 1, FL_R + 4);
    cp(FL_G + 0, FL_G + 6); cp(FL_G + 1, FL_G + 7);
    cp(FL_B + 0, FL_B + 3); cp(FL_B + 1, FL_B + 4);
    auto zero_group = [&](int first, int count) {
        memset(st.line(first), 0, (size_t)count * lw2 * sizeof(uint16_t));
        st.line(first)[0] = st.line(first - 1)[1];
        st.line(first)[st.q.line_width + 1] =
            st.line(first - 1)[st.q.line_width];
    };
    zero_group(FL_R + 2, 3);
    zero_group(FL_G + 2, 6);
    zero_group(FL_B + 2, 3);
}

struct FujiHeader {
    int raw_type;        // 16 = X-Trans, 0 = Bayer
    int bits;
    int height, width, rounded_width;
    int block_size, blocks, total_lines;
};

// parse + validate the 16-byte stream header (big-endian)
static bool fuji_parse_header(const uint8_t* p, size_t n, FujiHeader* h) {
    if (n < 16) return false;
    auto u16 = [&](int off) { return p[off] << 8 | p[off + 1]; };
    if (u16(0) != 0x4953 || p[2] != 1) return false;
    h->raw_type = p[3];
    h->bits = p[4];
    h->height = u16(5);
    h->rounded_width = u16(7);
    h->width = u16(9);
    h->block_size = u16(11);
    h->blocks = p[13];
    h->total_lines = u16(14);
    if (h->height > 0x3000 || h->height < 6 || h->height % 6) return false;
    if (h->width > 0x3000 || h->width < 0x300 || h->width % 24) return false;
    if (h->block_size != 0x300) return false;
    if (h->rounded_width > 0x3000 || h->rounded_width < h->block_size ||
        h->rounded_width % h->block_size ||
        h->rounded_width - h->width >= h->block_size)
        return false;
    if (h->blocks == 0 || h->blocks > 0x10 ||
        h->blocks != h->rounded_width / h->block_size)
        return false;
    if (h->total_lines == 0 || h->total_lines > 0x800 ||
        h->total_lines != h->height / 6)
        return false;
    if (h->bits != 12 && h->bits != 14 && h->bits != 16) return false;
    if (h->raw_type != 16 && h->raw_type != 0) return false;
    if (h->raw_type == 16 && h->block_size % 3) return false;
    if (h->raw_type == 0 && h->block_size & 1) return false;
    return true;
}

// full-stream decode: header, block size table, then per-strip decode.
// `data` points at the 16-byte header. Returns a height x width plane.
static uint16_t* fuji_compressed_decode(const uint8_t* data, size_t n,
                                        FujiHeader* h,
                                        const int* xtrans,
                                        const int* bayer2x2) {
    if (!fuji_parse_header(data, n, h)) return nullptr;
    size_t table = 16;
    size_t strip0 = (size_t)h->blocks * 4;
    if (strip0 & 0xC) strip0 += 0x10 - (strip0 & 0xC);
    strip0 += 16;
    if (strip0 > n) return nullptr;

    FujiQuant q;
    int bw = h->block_size;
    q.init(h->bits, h->raw_type == 16 ? bw * 2 / 3 : bw / 2);

    uint16_t* out = (uint16_t*)calloc((size_t)h->height * h->width,
                                      sizeof(uint16_t));
    if (!out) return nullptr;

    size_t off = strip0;
    for (int blk = 0; blk < h->blocks; ++blk) {
        uint32_t bsz = (uint32_t)data[table + 4 * blk] << 24 |
                       (uint32_t)data[table + 4 * blk + 1] << 16 |
                       (uint32_t)data[table + 4 * blk + 2] << 8 |
                       (uint32_t)data[table + 4 * blk + 3];
        size_t avail = off < n ? n - off : 0;
        FujiStrip st(q, data + (off < n ? off : n),
                     std::min((size_t)bsz + 16, avail));
        int col0 = blk * bw;
        int ncols = std::min(bw, h->width - col0);
        const FujiPass* sched =
            h->raw_type == 16 ? kFujiPassesXtrans : kFujiPassesBayer;
        for (int ln = 0; ln < h->total_lines; ++ln) {
            for (int ps = 0; ps < 6; ++ps) fuji_decode_pass(st, sched[ps]);
            fuji_emit_lines(st, out, h->width, ln * 6, col0, ncols,
                            h->raw_type == 16 ? xtrans : nullptr, bayer2x2);
        }
        off += bsz;
    }
    return out;
}

// Fuji 14-bit packed payload (7 bytes -> 4 samples, byte-swapped dwords)
static void fuji_unpack14(const uint8_t* src, size_t n, uint16_t* dst,
                          int height, int width) {
    size_t linelen = (size_t)width * 7 / 4;
    std::vector<uint8_t> sw(linelen);
    for (int row = 0; row < height; ++row) {
        const uint8_t* ln = src + row * linelen;
        if (ln + linelen > src + n) break;
        // undo the 32-bit byte swap, then read 14-bit fields MSB-first
        for (size_t i = 0; i + 3 < linelen; i += 4) {
            sw[i] = ln[i + 3]; sw[i + 1] = ln[i + 2];
            sw[i + 2] = ln[i + 1]; sw[i + 3] = ln[i];
        }
        for (size_t i = linelen & ~size_t(3); i < linelen; ++i) sw[i] = 0;
        uint16_t* drow = dst + (size_t)row * width;
        for (int sp = 0, dp = 0; dp + 4 <= width &&
                                 sp + 7 <= (int)linelen; sp += 7, dp += 4) {
            const uint8_t* s = sw.data() + sp;
            drow[dp] = s[0] << 6 | s[1] >> 2;
            drow[dp + 1] = (s[1] & 0x3) << 12 | s[2] << 4 | s[3] >> 4;
            drow[dp + 2] = (s[3] & 0xF) << 10 | s[4] << 2 | s[5] >> 6;
            drow[dp + 3] = (s[5] & 0x3F) << 8 | s[6];
        }
    }
}

}  // namespace

// ---------------------------------------------------------------------------
// Fuji RAF (reference decode boundary: rtengine/dcraw.cc parse_fuji +
// rawimage.cc:724 fuji dispatch; fresh implementation from the public RAF
// container description). Layouts: the classic record-list container with
// a direct uncompressed payload, and the modern container whose CFA
// section is an embedded TIFF whose strip is uncompressed 16-bit, 14-bit
// packed, or Fuji-lossless-compressed (fujicompressed.cc role).
// ---------------------------------------------------------------------------

static uint16_t* decode_raf(const uint8_t* buf, size_t len,
                            ArtRawMeta* meta) {
    Reader br{buf, len, false};  // big-endian
    // header: 0x54 jpeg off/len, 0x5C cfa header off/len, 0x64 cfa off/len
    uint32_t cfa_hdr_off = br.u32(0x5C);
    uint32_t cfa_hdr_len = br.u32(0x60);
    uint32_t cfa_off = br.u32(0x64);
    uint32_t cfa_len = br.u32(0x68);
    if (!cfa_hdr_off || cfa_hdr_off + cfa_hdr_len > len) return nullptr;
    if (!cfa_off || cfa_off > len) return nullptr;
    if (cfa_off + cfa_len > len) cfa_len = (uint32_t)(len - cfa_off);

    int rh = 0, rw = 0;
    int xtrans[36];
    bool has_xtrans = false;
    double wb_grb[4] = {0, 0, 0, 0};
    bool has_wb = false;

    uint32_t n = br.u32(cfa_hdr_off);
    size_t p = cfa_hdr_off + 4;
    for (uint32_t i = 0; i < n && i < 256 && p + 4 <= len; ++i) {
        uint16_t id = br.u16(p);
        uint16_t sz = br.u16(p + 2);
        size_t dp = p + 4;
        if (dp + sz > len) break;
        switch (id) {
            case 0x100:  // raw height, width
                rh = br.u16(dp);
                rw = br.u16(dp + 2);
                break;
            case 0x121:  // (super CCD dims; prefer 0x100 when present)
                if (!rh) { rh = br.u16(dp); rw = br.u16(dp + 2); }
                break;
            case 0x131: {  // X-Trans pattern, 36 bytes (stored reversed:
                           // byte k is pattern cell 35-k, dcraw.cc:7683)
                if (sz >= 36) {
                    for (int k = 0; k < 36; ++k) {
                        int v = buf[dp + 35 - k] & 3;
                        if (v > 2) v = 1;
                        xtrans[k] = v;
                    }
                    has_xtrans = true;
                }
                break;
            }
            case 0x2ff0:  // as-shot WB: G R B (G2) u16s
                if (sz >= 8) {
                    wb_grb[0] = br.u16(dp);
                    wb_grb[1] = br.u16(dp + 2);
                    wb_grb[2] = br.u16(dp + 4);
                    wb_grb[3] = br.u16(dp + 6);
                    has_wb = wb_grb[0] > 0 && wb_grb[1] > 0 && wb_grb[2] > 0;
                }
                break;
            default:
                break;
        }
        p = dp + sz;
    }
    if (rh <= 0 || rw <= 0 || rh > 65535 || rw > 65535) return nullptr;

    size_t npix = (size_t)rh * rw;
    int bps = 16;
    uint16_t* out = nullptr;
    static const int kRGGB[4] = {0, 1, 1, 2};
    FujiHeader fh{};
    bool compressed = cfa_len >= 16 &&
                      fuji_parse_header(buf + cfa_off, cfa_len, &fh);
    if (compressed) {
        // Fuji lossless-compressed stream (fujicompressed.cc role).
        // Dims come from the stream header (parse_fuji_compressed_header
        // overrides raw_width/raw_height, fujicompressed.cc:1026-1027).
        if (fh.raw_type == 16 && !has_xtrans) return nullptr;
        out = fuji_compressed_decode(buf + cfa_off, cfa_len, &fh,
                                     has_xtrans ? xtrans : nullptr, kRGGB);
        if (!out) return nullptr;
        rh = fh.height;
        rw = fh.width;
        npix = (size_t)rh * rw;
        bps = fh.bits;
    } else if (cfa_len >= npix * 2) {
        out = (uint16_t*)calloc(npix, sizeof(uint16_t));
        if (!out) return nullptr;
        // 16-bit; RAF payloads are little-endian on modern bodies
        for (size_t i = 0; i < npix; ++i)
            out[i] = (uint16_t)(buf[cfa_off + 2 * i]
                                | buf[cfa_off + 2 * i + 1] << 8);
        uint16_t mx = 0;
        for (size_t i = 0; i < npix; i += 97) mx = std::max(mx, out[i]);
        bps = mx > 16383 ? 16 : 14;
    } else if (cfa_len * 4 >= npix * 7) {
        // 14-bit packed, 7 bytes -> 4 samples in byte-swapped dwords
        // (fuji_14bit_load_raw, rawimage.cc:726-727)
        out = (uint16_t*)calloc(npix, sizeof(uint16_t));
        if (!out) return nullptr;
        fuji_unpack14(buf + cfa_off, cfa_len, out, rh, rw);
        bps = 14;
    } else if (cfa_len * 8 >= npix * 12) {
        out = (uint16_t*)calloc(npix, sizeof(uint16_t));
        if (!out) return nullptr;
        unpack_bits(buf + cfa_off, cfa_len, out, npix, 12, true);
        bps = 12;
    } else {
        return nullptr;  // unknown payload: preconverter scope
    }

    memset(meta, 0, sizeof(*meta));
    meta->xtrans[0] = -1;
    meta->width = rw;
    meta->height = rh;
    meta->orientation = 1;
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    double wmax = (1 << (bps > 14 ? 16 : bps)) - 1;
    for (int i = 0; i < 4; ++i) { meta->white[i] = wmax; meta->black[i] = 0; }
    meta->iso = 100.0;
    meta->cfa_pattern[0] = -1;
    if (has_xtrans) {
        for (int k = 0; k < 36; ++k) meta->xtrans[k] = xtrans[k];
    } else {
        static const int gggr[4] = {0, 1, 1, 2};
        for (int i = 0; i < 4; ++i) meta->cfa_pattern[i] = gggr[i];
    }
    if (has_wb) {
        // records are G, R, B(, G2): neutral = 1/gain, G-normalized
        meta->as_shot_neutral[0] = wb_grb[0] / wb_grb[1];
        meta->as_shot_neutral[1] = 1.0;
        meta->as_shot_neutral[2] = wb_grb[0] / wb_grb[2];
    }
    // make/model from the header (0x10: make? model string at 0x1C..0x3C)
    strncpy(meta->make, "FUJIFILM", 63);
    {
        char mdl[33];
        memset(mdl, 0, sizeof(mdl));
        for (int i = 0; i < 32 && 0x1C + i < (int)len; ++i) {
            char c = (char)buf[0x1C + i];
            if (!c) break;
            mdl[i] = c;
        }
        strncpy(meta->model, mdl, 63);
    }
    return out;
}

// ---------------------------------------------------------------------------
// Canon CR3 (reference decode boundary: rtengine/canon_cr3_decoder.cc,
// itself LibRaw's CRX decoder). CRX is an undocumented format whose only
// public "spec" is that decoder lineage, so this section is DERIVED from
// the published decoder: the predictor/K-parameter math, the JS/J
// run-length tables, and the per-line decode structure follow
// canon_cr3_decoder.cc (crxPredictKParameter :910, run tables :784,
// crxDecodeTopLine/crxDecodeLine) — they cannot be independently
// re-derived without corpus reverse-engineering. The container walk
// (ISO-BMFF), buffer management, and integration are this repo's own.
// Bitstream model: CRAW tracks; per tile / per Bayer-subplane subbands
// coded with an adaptive Rice-Golomb residual stream over a median
// (LOCO-I-style) predictor plus zero-run-length coding. Scope: the
// lossless profile (imageLevels 0, encType 0, 4 planes) and the lossy
// (wavelet) cRAW profile (subband Rice streams + 5/3 IDWT, below).
// ---------------------------------------------------------------------------

// MSB-first bit reader over a memory span; reads past the end yield 0.
struct CrxBits {
    const uint8_t* p;
    size_t n;
    size_t byte = 0;
    int bit = 0;
    inline int get1() {
        if (byte >= n) return 0;
        int v = (p[byte] >> (7 - bit)) & 1;
        if (++bit == 8) { bit = 0; ++byte; }
        return v;
    }
    inline uint32_t bits(int k) {
        uint32_t v = 0;
        while (k--) v = (v << 1) | get1();
        return v;
    }
    // count zeros up to the terminating 1 (consumed)
    inline uint32_t zeros() {
        uint32_t z = 0;
        while (byte < n && !get1()) ++z;
        return z;
    }
    inline bool eof() const { return byte >= n; }
};

// adaptive Rice parameter update (canon_cr3_decoder.cc:910
// crxPredictKParameter)
static inline int crx_predict_k(int prevK, uint32_t bitCode, int maxVal) {
    int newK = prevK - (bitCode < (uint32_t)(1 << prevK >> 1))
             + ((bitCode >> prevK) > 2) + ((bitCode >> prevK) > 5);
    return (!maxVal || newK < maxVal) ? newK : maxVal;
}

// run-length adaptation tables (:784): JS = run chunk per sParam,
// J = extra raw bits when a run ends mid-chunk
static const uint32_t kCrxJS[32] = {
    1, 1, 1, 1, 2, 2, 2, 2, 4, 4, 4, 4, 8, 8, 8, 8,
    0x10, 0x10, 0x20, 0x20, 0x40, 0x40, 0x80, 0x80,
    0x100, 0x200, 0x400, 0x800, 0x1000, 0x2000, 0x4000, 0x8000};
static const uint32_t kCrxJ[32] = {
    0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct CrxBandState {
    CrxBits br;
    int kParam = 0;
    int sParam = 0;
};

// one Golomb residual: unary prefix (escape 41 -> 21 raw bits) +
// kParam raw bits (crxDecodeSymbolL1's code read)
static inline uint32_t crx_code(CrxBandState& st) {
    uint32_t bitCode = st.br.zeros();
    if (bitCode >= 41)
        bitCode = st.br.bits(21);
    else if (st.kParam)
        bitCode = st.br.bits(st.kParam) | (bitCode << st.kParam);
    return bitCode;
}

// run length via the adaptive JS/J ladder (crxDecodeLine run branch).
// Returns the run count, <= maxLen; advances sParam.
static inline int crx_run_length(CrxBandState& st, int maxLen, bool* err) {
    int nSyms = 1;
    while (st.br.get1()) {
        nSyms += (int)kCrxJS[st.sParam];
        if (nSyms > maxLen) { nSyms = maxLen; break; }
        if (st.sParam < 31) ++st.sParam;
        if (nSyms == maxLen) break;
    }
    if (nSyms < maxLen) {
        if (kCrxJ[st.sParam])
            nSyms += st.br.bits((int)kCrxJ[st.sParam]);
        if (st.sParam > 0) --st.sParam;
        if (nSyms > maxLen) *err = true;
    }
    return nSyms;
}

// top line of a subband (crxDecodeTopLine): no previous line, runs of
// zeros + residuals against the previous pixel
static bool crx_decode_top_line(CrxBandState& st, int32_t* line1, int width) {
    line1[0] = 0;
    int length = width;
    int pos = 1;  // writing line1[pos]
    for (; length > 1; --length) {
        if (line1[pos - 1]) {
            line1[pos] = line1[pos - 1];
        } else {
            if (st.br.get1()) {
                bool err = false;
                int nSyms = crx_run_length(st, length, &err);
                if (err) return false;
                length -= nSyms;
                while (nSyms-- > 0) {
                    line1[pos] = line1[pos - 1];
                    ++pos;
                }
                if (length <= 0) break;
            }
            line1[pos] = 0;
        }
        uint32_t bitCode = crx_code(st);
        line1[pos] += -(int32_t)(bitCode & 1) ^ (int32_t)(bitCode >> 1);
        st.kParam = crx_predict_k(st.kParam, bitCode, 15);
        ++pos;
    }
    if (length == 1) {
        line1[pos] = line1[pos - 1];
        uint32_t bitCode = crx_code(st);
        line1[pos] += -(int32_t)(bitCode & 1) ^ (int32_t)(bitCode >> 1);
        st.kParam = crx_predict_k(st.kParam, bitCode, 15);
        ++pos;
    }
    line1[pos] = line1[pos - 1] + 1;  // right guard for the next line
    return true;
}

// interior line (crxDecodeLine + crxDecodeSymbolL1): median predictor
// with zero-run coding when the (left, top, top-right) context repeats
static bool crx_decode_line(CrxBandState& st, const int32_t* line0,
                            int32_t* line1, int width) {
    line1[0] = line0[1];
    int length = width;
    int p0 = 0;  // index into line0 (reference's lineBuf0 pointer)
    int p1 = 1;  // next write position in line1

    auto symbol = [&](int doMedian, int notEOL) {
        if (doMedian) {
            int32_t delta = line0[p0 + 1] - line0[p0];
            int32_t top = line0[p0 + 1];
            int32_t left = line1[p1 - 1];
            int32_t symb[4] = {delta + left, delta + left, left, top};
            line1[p1] = symb[(((line0[p0] < left) ^ (delta < 0)) << 1)
                             + ((left < top) ^ (delta < 0))];
        } else {
            line1[p1] = line0[p0 + 1];
        }
        uint32_t bitCode = crx_code(st);
        line1[p1] += -(int32_t)(bitCode & 1) ^ (int32_t)(bitCode >> 1);
        if (notEOL) {
            int32_t nextDelta = (line0[p0 + 2] - line0[p0 + 1]) * 2;
            bitCode = (bitCode + (uint32_t)(nextDelta < 0 ? -nextDelta
                                                          : nextDelta)) >> 1;
            ++p0;
        }
        st.kParam = crx_predict_k(st.kParam, bitCode, 15);
        ++p1;
    };

    for (; length > 1; --length) {
        if (line1[p1 - 1] != line0[p0 + 1] || line1[p1 - 1] != line0[p0 + 2]) {
            symbol(1, 1);
        } else {
            if (st.br.get1()) {
                bool err = false;
                int nSyms = crx_run_length(st, length, &err);
                if (err) return false;
                length -= nSyms;
                p0 += nSyms;
                while (nSyms-- > 0) {
                    line1[p1] = line1[p1 - 1];
                    ++p1;
                }
            }
            if (length > 0) symbol(0, length > 1);
        }
    }
    if (length == 1) symbol(1, 0);
    line1[p1] = line1[p1 - 1] + 1;
    return true;
}

// one subband (LL-only, lossless) of one tile decoded into the output
// mosaic subplane (crxDecodePlane levels==0 branch + crxConvertPlaneLine
// nPlanes==4 path)
static bool crx_decode_tile_plane(const uint8_t* data, size_t dataSize,
                                  int tw, int th, int nBits, uint16_t* out,
                                  size_t outStride, size_t outStep) {
    CrxBandState st;
    st.br = CrxBits{data, dataSize};
    std::vector<int32_t> bufs(2 * (tw + 2), 0);
    int32_t* lineA = bufs.data();
    int32_t* lineB = bufs.data() + (tw + 2);
    const int32_t median = 1 << (nBits - 1);
    const int32_t maxVal = (1 << nBits) - 1;
    for (int row = 0; row < th; ++row) {
        int32_t* l0 = (row & 1) ? lineB : lineA;
        int32_t* l1 = (row & 1) ? lineA : lineB;
        if (row == 0) {
            st.sParam = 0;
            st.kParam = 0;
            if (!crx_decode_top_line(st, lineB, tw)) return false;
            l1 = lineB;
        } else {
            if (!crx_decode_line(st, l0, l1, tw)) return false;
        }
        uint16_t* dst = out + (size_t)row * outStride;
        for (int i = 0; i < tw; ++i) {
            int32_t v = median + l1[1 + i];
            if (v < 0) v = 0;
            if (v > maxVal) v = maxVal;
            dst[(size_t)i * outStep] = (uint16_t)v;
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// Lossy (wavelet) CRX. The cRAW profile codes each Bayer subplane as
// 3*levels+1 subbands (LL + per-level HL/LH/HH), each an independent
// Rice/Golomb bitstream, dequantized by a per-band qParam (v0x100, updated
// per LL line from the stream) or a per-tile QP map (v0x200), then
// reconstructed with an integer LeGall 5/3 inverse lifting.
//
// Architecture note: unlike the published decoder's line-streamed rolling
// IDWT (canon_cr3_decoder.cc crxIdwt53Filter*), this implementation decodes
// each subband fully into memory and synthesizes whole planes level by
// level — simpler and equally fast on a host feeding a TPU. The bitstream
// model itself (residual coding, run ladders, qParam/qStep dequantization,
// lifting arithmetic, ExCoef band geometry) is DERIVED from the published
// decoder — it cannot be re-derived independently; per-function citations
// below.
// ---------------------------------------------------------------------------

// q_step_tbl (canon_cr3_decoder.cc:782)
static const uint32_t kCrxQStepTbl[6] = {0x28, 0x2D, 0x33, 0x39, 0x40, 0x48};

// exCoefNumTbl (canon_cr3_decoder.cc:776): per (levels-1, tile_dim & 7)
// counts of extra boundary coefficients per band
static const int kCrxExCoef[144] = {
    1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0,
    1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 0, 0, 1, 0, 1, 0, 0, 0, 1, 2, 2, 1, 0, 0, 1, 1, 1, 1, 0, 0,
    1, 1, 1, 1, 0, 0, 1, 0, 1, 0, 0, 0, 1, 2, 2, 1, 0, 0, 1, 1, 1, 1, 0, 0,
    1, 1, 1, 1, 1, 1, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2, 1, 1, 1, 1, 2, 2, 1,
    1, 1, 1, 2, 2, 1, 1, 0, 1, 1, 1, 1, 1, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1};

enum {
    kCrxTileRight = 1,
    kCrxTileLeft = 2,
    kCrxTileBottom = 4,
    kCrxTileTop = 8,
};

struct CrxBandInfo {
    int width = 0, height = 0;
    int64_t dataOff = 0;      // within the comp's data region
    uint64_t dataSize = 0;
    int qParam = 4;
    bool hdrPartial = false;  // FF03 bit 27: per-line qParam updates
    uint32_t qStepBase = 0, qStepMult = 0;  // FF13 headers
    int rowStartAddOn = 0, rowEndAddOn = 0;
    int colStartAddOn = 0, colEndAddOn = 0;
    int levelShift = 0;
};

struct CrxCompInfo {
    int64_t dataOff = 0;
    uint32_t compSize = 0;
    bool supportsPartial = false;
    int roundedBits = 0;      // levels==0 lossy-lite; unsupported -> fail
    std::vector<CrxBandInfo> bands;
};

struct CrxTileInfo {
    uint64_t dataOff = 0;     // from the mdat data start
    uint32_t tileSize = 0;
    uint32_t qpSize = 0;
    uint32_t extraSize = 0;
    bool hasQP = false;
    int width = 0, height = 0;
    int flags = 0;
    std::vector<CrxCompInfo> comps;
    // per transform level (0 = coarsest) qStep tables, v0x200
    std::vector<std::vector<uint32_t>> qsTbl;
    std::vector<int> qsW, qsH;
};

// per-band geometry incl. neighbouring-tile extension coefficients
// (crxProcessSubbands + crxSetupSubbandIdx)
static void crx_band_geometry(int levels, int tileW, int tileH, int flags,
                              std::vector<CrxBandInfo>& bands) {
    bands.assign(3 * levels + 1, CrxBandInfo());
    int bandWidth = tileW, bandHeight = tileH;
    if (levels == 0) {
        bands[0].width = tileW;
        bands[0].height = tileH;
        return;
    }
    const int* rowEx = kCrxExCoef + 0x30 * (levels - 1) + 6 * (tileW & 7);
    const int* colEx = kCrxExCoef + 0x30 * (levels - 1) + 6 * (tileH & 7);
    int bi = 3 * levels;  // walk from the finest level's HH down
    for (int lv = 0; lv < levels; ++lv) {
        int wOdd = bandWidth & 1, hOdd = bandHeight & 1;
        bandWidth = (bandWidth + wOdd) >> 1;
        bandHeight = (bandHeight + hOdd) >> 1;
        int wEx0 = 0, wEx1 = 0, hEx0 = 0, hEx1 = 0;
        int colStart = 0, rowStart = 0;
        if (flags & kCrxTileRight) {
            wEx0 = rowEx[2 * lv];
            wEx1 = rowEx[2 * lv + 1];
        }
        if (flags & kCrxTileLeft) { ++wEx0; colStart = 1; }
        if (flags & kCrxTileBottom) {
            hEx0 = colEx[2 * lv];
            hEx1 = colEx[2 * lv + 1];
        }
        if (flags & kCrxTileTop) { ++hEx0; rowStart = 1; }
        int levelShift = 3 - (lv + 1);
        // HH (high x, high y)
        CrxBandInfo& hh = bands[bi];
        hh.width = bandWidth + wEx0 - wOdd;
        hh.height = bandHeight + hEx0 - hOdd;
        hh.colStartAddOn = colStart; hh.colEndAddOn = wEx0 - colStart;
        hh.rowStartAddOn = rowStart; hh.rowEndAddOn = hEx0 - rowStart;
        hh.levelShift = levelShift;
        // LH (low x, high y)
        CrxBandInfo& lh = bands[bi - 1];
        lh.width = bandWidth + wEx1;
        lh.height = bandHeight + hEx0 - hOdd;
        lh.colStartAddOn = 0; lh.colEndAddOn = wEx1;
        lh.rowStartAddOn = rowStart; lh.rowEndAddOn = hEx0 - rowStart;
        lh.levelShift = levelShift;
        // HL (high x, low y)
        CrxBandInfo& hl = bands[bi - 2];
        hl.width = bandWidth + wEx0 - wOdd;
        hl.height = bandHeight + hEx1;
        hl.colStartAddOn = colStart; hl.colEndAddOn = wEx0 - colStart;
        hl.rowStartAddOn = 0; hl.rowEndAddOn = hEx1;
        hl.levelShift = levelShift;
        bi -= 3;
    }
    int wExLL = (flags & kCrxTileRight) ? rowEx[2 * levels - 1] : 0;
    int hExLL = (flags & kCrxTileBottom) ? colEx[2 * levels - 1] : 0;
    CrxBandInfo& ll = bands[0];
    ll.width = bandWidth + wExLL;
    ll.height = bandHeight + hExLL;
    ll.colStartAddOn = 0; ll.colEndAddOn = wExLL;
    ll.rowStartAddOn = 0; ll.rowEndAddOn = hExLL;
    ll.levelShift = 3 - levels;
}

// Rice code with the QP escape (crxUpdateQparam / crxReadQP): unary
// escape at 23 zeros -> 8 raw bits
static inline uint32_t crx_code_qp(CrxBits& br, int k) {
    uint32_t z = br.zeros();
    if (z >= 23) return br.bits(8);
    if (k) return br.bits(k) | (z << k);
    return z;
}

static inline int32_t crx_zigzag(uint32_t bitCode) {
    return -(int32_t)(bitCode & 1) ^ (int32_t)(bitCode >> 1);
}

// top line of a non-progressive (H) subband
// (crxDecodeTopLineNoRefPrevLine): zero-runs against the left value with
// a per-column K history in kbuf
static bool crx_decode_top_line_noref(CrxBandState& st, int32_t* line1,
                                      int32_t* kbuf, int width) {
    line1[0] = 0;
    int length = width;
    int pos = 1;
    int kpos = 0;
    for (; length > 1; --length) {
        if (line1[pos - 1]) {
            uint32_t bitCode = crx_code(st);
            line1[pos] = crx_zigzag(bitCode);
            st.kParam = crx_predict_k(st.kParam, bitCode, 15);
        } else {
            int nSyms = 0;
            if (st.br.get1()) {
                bool err = false;
                nSyms = crx_run_length(st, length, &err);
                if (err) return false;
            }
            length -= nSyms;
            while (nSyms-- > 0) {
                kbuf[kpos] = 0;
                line1[pos] = 0;
                ++pos;
                ++kpos;
            }
            if (length <= 0) break;
            uint32_t bitCode = crx_code(st);
            line1[pos] = crx_zigzag(bitCode + 1);
            st.kParam = crx_predict_k(st.kParam, bitCode, 15);
        }
        kbuf[kpos] = st.kParam;
        ++kpos;
        ++pos;
    }
    if (length == 1) {
        uint32_t bitCode = crx_code(st);
        line1[pos] = crx_zigzag(bitCode);
        st.kParam = crx_predict_k(st.kParam, bitCode, 15);
        kbuf[kpos] = st.kParam;
        ++pos;
    }
    line1[pos] = 0;  // zero guard for the next line's context test
    return true;
}

// interior line of a non-progressive subband (crxDecodeLineNoRefPrevLine):
// values are pure residuals (no median prediction); run mode entered when
// the (top, top-right, left) context is all zero
static bool crx_decode_line_noref(CrxBandState& st, const int32_t* line0,
                                  int32_t* line1, int32_t* kbuf, int width) {
    int i = 0;
    for (; i < width - 1; ++i) {
        if (line0[i + 2] | line0[i + 1] | line1[i]) {
            uint32_t bitCode = crx_code(st);
            line1[i + 1] = crx_zigzag(bitCode);
            st.kParam = crx_predict_k(st.kParam, bitCode, 0);
            if (kbuf[i + 1] - st.kParam <= 1) {
                if (st.kParam >= 15) st.kParam = 15;
            } else {
                ++st.kParam;
            }
        } else {
            int nSyms = 0;
            if (st.br.get1()) {
                nSyms = 1;
                while (st.br.get1()) {
                    nSyms += (int)kCrxJS[st.sParam];
                    if (i + nSyms > width) { nSyms = width - i; break; }
                    if (st.sParam < 31) ++st.sParam;
                    if (i + nSyms == width) break;
                }
                if (i + nSyms < width) {
                    if (kCrxJ[st.sParam])
                        nSyms += st.br.bits((int)kCrxJ[st.sParam]);
                    if (st.sParam > 0) --st.sParam;
                }
                if (i + nSyms > width) return false;
            }
            if (nSyms > 0) {
                memset(line1 + i + 1, 0, nSyms * sizeof(int32_t));
                memset(kbuf + i, 0, nSyms * sizeof(int32_t));
                i += nSyms;
            }
            if (i >= width - 1) {
                if (i == width - 1) {
                    uint32_t bitCode = crx_code(st);
                    line1[i + 1] = crx_zigzag(bitCode + 1);
                    st.kParam = crx_predict_k(st.kParam, bitCode, 15);
                    kbuf[i] = st.kParam;
                }
                continue;  // skips the loop-bottom kbuf store, then exits
            }
            uint32_t bitCode = crx_code(st);
            line1[i + 1] = crx_zigzag(bitCode + 1);
            st.kParam = crx_predict_k(st.kParam, bitCode, 0);
            if (kbuf[i + 1] - st.kParam <= 1) {
                if (st.kParam >= 15) st.kParam = 15;
            } else {
                ++st.kParam;
            }
        }
        kbuf[i] = st.kParam;
    }
    if (i == width - 1) {
        uint32_t bitCode = crx_code(st);
        line1[i + 1] = crx_zigzag(bitCode);
        st.kParam = crx_predict_k(st.kParam, bitCode, 15);
        kbuf[i] = st.kParam;
    }
    return true;
}

// decode one whole subband, dequantized (crxDecodeLineWithIQuantization).
// compPartial selects the median-predictor decoders (LL band of a
// partial-capable comp) vs the non-progressive ones. qsTbl (v0x200) is the
// per-level QP table, else the v0x100 qParam scale is used; `wavelet`
// false = lossless levels==0 (no quantization at all).
static bool crx_decode_band(const uint8_t* data, const CrxBandInfo& b,
                            bool compPartial, bool wavelet,
                            const uint32_t* qsTbl, int qsW, int qsH,
                            std::vector<int32_t>& out) {
    if (b.width < 0 || b.height < 0) return false;
    out.assign((size_t)b.width * (size_t)b.height, 0);
    if (b.width == 0 || b.height == 0) return true;
    if (!b.dataSize) return true;  // empty band: zeros

    CrxBandState st;
    st.br = CrxBits{data, (size_t)b.dataSize};
    int qParam = b.qParam;
    int qK = 0;
    std::vector<int32_t> lbuf(2 * ((size_t)b.width + 2), 0);
    std::vector<int32_t> kvec;
    if (!compPartial) kvec.assign((size_t)b.width + 1, 0);
    int32_t* lineA = lbuf.data();
    int32_t* lineB = lbuf.data() + (b.width + 2);

    for (int row = 0; row < b.height; ++row) {
        if (wavelet && b.hdrPartial && !qsTbl) {
            // per-line qParam delta on the same stream, own K adaptation
            // (crxUpdateQparam)
            uint32_t bitCode = crx_code_qp(st.br, qK);
            qParam += crx_zigzag(bitCode);
            qK = crx_predict_k(qK, (int)bitCode, 0);
            if (qK > 7) return false;
        }
        int32_t* l0 = (row & 1) ? lineB : lineA;
        int32_t* l1 = (row & 1) ? lineA : lineB;
        if (row == 0) {
            st.kParam = 0;
            st.sParam = 0;
            l1 = lineB;
            bool ok = compPartial
                          ? crx_decode_top_line(st, lineB, b.width)
                          : crx_decode_top_line_noref(st, lineB, kvec.data(),
                                                      b.width);
            if (!ok) return false;
        } else {
            bool ok = compPartial
                          ? crx_decode_line(st, l0, l1, b.width)
                          : crx_decode_line_noref(st, l0, l1, kvec.data(),
                                                  b.width);
            if (!ok) return false;
        }
        int32_t* dst = out.data() + (size_t)row * b.width;
        if (!wavelet) {
            memcpy(dst, l1 + 1, (size_t)b.width * sizeof(int32_t));
        } else if (qsTbl) {
            // v0x200 per-column steps (crxDecodeLineWithIQuantization
            // qStep branch + getSubbandRow)
            int r = row;
            int qrow = r < b.rowStartAddOn
                           ? 0
                           : (r < b.height - b.rowEndAddOn
                                  ? r - b.rowEndAddOn
                                  : b.height - b.rowEndAddOn
                                        - b.rowStartAddOn - 1);
            if (qrow < 0) qrow = 0;
            if (qrow > qsH - 1) qrow = qsH - 1;
            const uint32_t* tp = qsTbl + (size_t)qsW * qrow;
            auto qmul = [&](uint32_t t) -> int32_t {
                uint32_t quantVal =
                    b.qStepBase + (uint32_t)((t * b.qStepMult) >> 3);
                if ((int32_t)quantVal < 1) quantVal = 1;
                if (quantVal > 0x168000u) quantVal = 0x168000u;
                return (int32_t)quantVal;
            };
            int lastIdx = (b.width - b.colEndAddOn - b.colStartAddOn - 1)
                          >> b.levelShift;
            if (lastIdx < 0) lastIdx = 0;
            if (lastIdx > qsW - 1) lastIdx = qsW - 1;
            for (int i = 0; i < b.colStartAddOn && i < b.width; ++i)
                dst[i] = (int32_t)((int64_t)l1[1 + i] * qmul(tp[0]));
            for (int i = b.colStartAddOn; i < b.width - b.colEndAddOn; ++i) {
                int ci = (i - b.colStartAddOn) >> b.levelShift;
                if (ci > qsW - 1) ci = qsW - 1;
                dst[i] = (int32_t)((int64_t)l1[1 + i] * qmul(tp[ci]));
            }
            for (int i = b.width - b.colEndAddOn; i < b.width; ++i)
                if (i >= 0)
                    dst[i] = (int32_t)((int64_t)l1[1 + i]
                                       * qmul(tp[lastIdx]));
        } else {
            // v0x100 scalar scale (crxDecodeLineWithIQuantization tail)
            int32_t qScale;
            if (qParam / 6 >= 6)
                qScale = (int32_t)(kCrxQStepTbl[qParam % 6]
                                   * (1u << (qParam / 6 + 26)));
            else
                qScale = (int32_t)(kCrxQStepTbl[qParam % 6]
                                   >> (6 - qParam / 6));
            if (qScale != 1)
                for (int i = 0; i < b.width; ++i)
                    dst[i] = (int32_t)((int64_t)l1[1 + i] * qScale);
            else
                memcpy(dst, l1 + 1, (size_t)b.width * sizeof(int32_t));
        }
    }
    return true;
}

// inverse 5/3 lifting along one axis (the arithmetic of crxHorizontal53 /
// crxIdwt53FilterTransform, whole-array form). extLead/extTrail: the
// neighbouring-tile extension coefficients replace symmetric extension.
static void crx_idwt53_1d(const int32_t* lo, const int32_t* hi, int32_t* out,
                          int outN, bool extLead, bool extTrail) {
    if (outN <= 0) return;
    if (outN == 1) { out[0] = lo[0]; return; }
    int li = 0, hj = 0, o = 0;
    if (extLead) {
        out[0] = lo[0] - ((hi[0] + hi[1] + 2) >> 2);
        ++hj;
    } else {
        out[0] = lo[0] - ((hi[0] + 1) >> 1);
    }
    ++li;
    for (int i = 0; i < outN - 3; i += 2) {
        int32_t delta = lo[li] - ((hi[hj] + hi[hj + 1] + 2) >> 2);
        out[o + 1] = hi[hj] + ((delta + out[o]) >> 1);
        out[o + 2] = delta;
        ++li;
        ++hj;
        o += 2;
    }
    if (extTrail) {
        int32_t delta = lo[li] - ((hi[hj] + hi[hj + 1] + 2) >> 2);
        out[o + 1] = hi[hj] + ((delta + out[o]) >> 1);
        if (outN & 1) out[o + 2] = delta;
    } else if (outN & 1) {
        int32_t delta = lo[li] - ((hi[hj] + 1) >> 1);
        out[o + 1] = hi[hj] + ((delta + out[o]) >> 1);
        out[o + 2] = delta;
    } else {
        out[o + 1] = out[o] + hi[hj];
    }
}

// samples consumed by crx_idwt53_1d from each input
static inline void crx_idwt53_need(int outN, bool extLead, bool extTrail,
                                   int* loNeed, int* hiNeed) {
    if (outN <= 1) { *loNeed = 1; *hiNeed = 0; return; }
    int niter = (outN - 2) >> 1;
    *loNeed = 1 + niter + ((extTrail || (outN & 1)) ? 1 : 0);
    *hiNeed = (extLead ? 1 : 0) + niter + (extTrail ? 2 : 1);
}

// one synthesis level: (LL, HL, LH, HH) -> outW x outH plane
static bool crx_idwt_level(const std::vector<int32_t>& LL, int llW, int llH,
                           const std::vector<int32_t>& HL, int hlW, int hlH,
                           const std::vector<int32_t>& LH, int lhW, int lhH,
                           const std::vector<int32_t>& HH, int hhW, int hhH,
                           int outW, int outH, int flags,
                           std::vector<int32_t>& out) {
    const bool left = flags & kCrxTileLeft, right = flags & kCrxTileRight;
    const bool top = flags & kCrxTileTop, bottom = flags & kCrxTileBottom;
    int loNeedC, hiNeedC, loNeedR, hiNeedR;
    crx_idwt53_need(outW, left, right, &loNeedC, &hiNeedC);
    crx_idwt53_need(outH, top, bottom, &loNeedR, &hiNeedR);
    if (llW < loNeedC || (outW > 1 && hlW < hiNeedC)) return false;
    if (lhW < loNeedC || (outW > 1 && hhW < hiNeedC)) return false;
    if (llH < loNeedR || hlH < loNeedR) return false;
    if (outH > 1 && (lhH < hiNeedR || hhH < hiNeedR)) return false;

    // horizontal pass: low rows from (LL,HL), high rows from (LH,HH)
    std::vector<int32_t> lowP((size_t)loNeedR * outW);
    std::vector<int32_t> highP((size_t)hiNeedR * outW);
    for (int j = 0; j < loNeedR; ++j)
        crx_idwt53_1d(LL.data() + (size_t)j * llW, HL.data() + (size_t)j * hlW,
                      lowP.data() + (size_t)j * outW, outW, left, right);
    for (int j = 0; j < hiNeedR; ++j)
        crx_idwt53_1d(LH.data() + (size_t)j * lhW, HH.data() + (size_t)j * hhW,
                      highP.data() + (size_t)j * outW, outW, left, right);

    // vertical pass, row-vector form of the same lifting
    out.assign((size_t)outW * outH, 0);
    auto lrow = [&](int j) { return lowP.data() + (size_t)j * outW; };
    auto hrow = [&](int j) { return highP.data() + (size_t)j * outW; };
    auto orow = [&](int j) { return out.data() + (size_t)j * outW; };
    if (outH == 1) {
        memcpy(orow(0), lrow(0), (size_t)outW * sizeof(int32_t));
        return true;
    }
    int lj = 0, hj = 0, oj = 0;
    if (top) {
        const int32_t *l = lrow(0), *h0 = hrow(0), *h1 = hrow(1);
        int32_t* d = orow(0);
        for (int x = 0; x < outW; ++x)
            d[x] = l[x] - ((h0[x] + h1[x] + 2) >> 2);
        ++hj;
    } else {
        const int32_t *l = lrow(0), *h0 = hrow(0);
        int32_t* d = orow(0);
        for (int x = 0; x < outW; ++x) d[x] = l[x] - ((h0[x] + 1) >> 1);
    }
    ++lj;
    for (int i = 0; i < outH - 3; i += 2) {
        const int32_t *l = lrow(lj), *h0 = hrow(hj), *h1 = hrow(hj + 1);
        const int32_t* prevE = orow(oj);
        int32_t *dOdd = orow(oj + 1), *dEven = orow(oj + 2);
        for (int x = 0; x < outW; ++x) {
            int32_t delta = l[x] - ((h0[x] + h1[x] + 2) >> 2);
            dOdd[x] = h0[x] + ((delta + prevE[x]) >> 1);
            dEven[x] = delta;
        }
        ++lj;
        ++hj;
        oj += 2;
    }
    if (bottom) {
        const int32_t *l = lrow(lj), *h0 = hrow(hj), *h1 = hrow(hj + 1);
        const int32_t* prevE = orow(oj);
        int32_t* dOdd = orow(oj + 1);
        int32_t* dEven = (outH & 1) ? orow(oj + 2) : nullptr;
        for (int x = 0; x < outW; ++x) {
            int32_t delta = l[x] - ((h0[x] + h1[x] + 2) >> 2);
            dOdd[x] = h0[x] + ((delta + prevE[x]) >> 1);
            if (dEven) dEven[x] = delta;
        }
    } else if (outH & 1) {
        const int32_t *l = lrow(lj), *h0 = hrow(hj);
        const int32_t* prevE = orow(oj);
        int32_t *dOdd = orow(oj + 1), *dEven = orow(oj + 2);
        for (int x = 0; x < outW; ++x) {
            int32_t delta = l[x] - ((h0[x] + 1) >> 1);
            dOdd[x] = h0[x] + ((delta + prevE[x]) >> 1);
            dEven[x] = delta;
        }
    } else {
        const int32_t *h0 = hrow(hj), *prevE = orow(oj);
        int32_t* dOdd = orow(oj + 1);
        for (int x = 0; x < outW; ++x) dOdd[x] = prevE[x] + h0[x];
    }
    return true;
}

// v0x200 QP map: Golomb-coded per-8x2 block deltas (crxDecodeGolombTop /
// crxDecodeGolombNormal), then per-level step tables (crxMakeQStep)
static bool crx_decode_qsteps(const uint8_t* data, size_t qpSize, int levels,
                              int tileW, int tileH, CrxTileInfo& tile) {
    int qpW = (tileW >> 3) + ((tileW & 7) != 0);
    int qpH = (tileH >> 1) + (tileH & 1);
    if (qpW <= 0 || qpH <= 0 || levels < 1 || levels > 3) return false;
    CrxBits br{data, qpSize};
    std::vector<int32_t> qp((size_t)qpW * qpH);
    std::vector<int32_t> lines(2 * ((size_t)qpW + 2), 0);
    int32_t* bufA = lines.data();
    int32_t* bufB = lines.data() + qpW + 2;
    int k = 0;
    for (int row = 0; row < qpH; ++row) {
        int32_t* l0 = (row & 1) ? bufB : bufA;
        int32_t* l1 = (row & 1) ? bufA : bufB;
        if (row == 0) {
            l1 = bufB;
            l1[0] = 0;
            for (int i = 0; i < qpW; ++i) {
                uint32_t c = crx_code_qp(br, k);
                l1[i + 1] = l1[i] + crx_zigzag(c);
                k = crx_predict_k(k, (int)c, 7);
            }
            l1[qpW + 1] = l1[qpW] + 1;
        } else {
            l1[0] = l0[1];
            int32_t deltaH = l0[1] - l0[0];
            for (int i = 0; i < qpW; ++i) {
                // median prediction (crxPrediction)
                int32_t left = l1[i], topv = l0[i + 1];
                int32_t deltaV = l0[i] - l1[i];
                int32_t symb[4] = {left + deltaH, left + deltaH, left, topv};
                int32_t pred = symb[(((deltaV < 0) ^ (deltaH < 0)) << 1)
                                    + ((left < topv) ^ (deltaH < 0))];
                uint32_t c = crx_code_qp(br, k);
                l1[i + 1] = pred + crx_zigzag(c);
                if (i + 1 < qpW) {
                    int32_t nd = l0[i + 2] - l0[i + 1];
                    k = crx_predict_k(
                        k, (int)((c + 2 * (uint32_t)(nd < 0 ? -nd : nd)) >> 1),
                        7);
                    deltaH = nd;
                } else {
                    k = crx_predict_k(k, (int)c, 7);
                }
            }
            l1[qpW + 1] = l1[qpW] + 1;
        }
        for (int i = 0; i < qpW; ++i)
            qp[(size_t)qpW * row + i] = l1[i + 1] + 4;
    }

    // build per-level tables (coarsest first), crxMakeQStep
    auto stepOf = [](int32_t q) -> uint32_t {
        if (q < 0) q = 0;
        if (q / 6 >= 6)
            return kCrxQStepTbl[q % 6] * (1u << (q / 6 + 26));
        return kCrxQStepTbl[q % 6] >> (6 - q / 6);
    };
    tile.qsTbl.assign(levels, {});
    tile.qsW.assign(levels, qpW);
    tile.qsH.assign(levels, 0);
    int qpH4 = (tileH >> 2) + ((tileH & 3) != 0);
    int qpH8 = (tileH >> 3) + ((tileH & 7) != 0);
    int lvlIdx = 0;
    if (levels == 3) {
        auto& t = tile.qsTbl[lvlIdx];
        t.resize((size_t)qpW * qpH8);
        tile.qsH[lvlIdx] = qpH8;
        for (int r = 0; r < qpH8; ++r) {
            int r0 = std::min(4 * r, qpH - 1), r1 = std::min(4 * r + 1, qpH - 1);
            int r2 = std::min(4 * r + 2, qpH - 1),
                r3 = std::min(4 * r + 3, qpH - 1);
            for (int c = 0; c < qpW; ++c) {
                int32_t q = qp[(size_t)qpW * r0 + c] + qp[(size_t)qpW * r1 + c]
                            + qp[(size_t)qpW * r2 + c]
                            + qp[(size_t)qpW * r3 + c];
                q = ((q < 0) * 3 + q) >> 2;
                t[(size_t)qpW * r + c] = stepOf(q);
            }
        }
        ++lvlIdx;
    }
    if (levels >= 2) {
        auto& t = tile.qsTbl[lvlIdx];
        t.resize((size_t)qpW * qpH4);
        tile.qsH[lvlIdx] = qpH4;
        for (int r = 0; r < qpH4; ++r) {
            int r0 = std::min(2 * r, qpH - 1), r1 = std::min(2 * r + 1, qpH - 1);
            for (int c = 0; c < qpW; ++c) {
                int32_t q = (qp[(size_t)qpW * r0 + c]
                             + qp[(size_t)qpW * r1 + c]) / 2;
                t[(size_t)qpW * r + c] = stepOf(q);
            }
        }
        ++lvlIdx;
    }
    {
        auto& t = tile.qsTbl[lvlIdx];
        t.resize((size_t)qpW * qpH);
        tile.qsH[lvlIdx] = qpH;
        for (int r = 0; r < qpH; ++r)
            for (int c = 0; c < qpW; ++c)
                t[(size_t)qpW * r + c] = stepOf(qp[(size_t)qpW * r + c]);
    }
    return true;
}

// decode one lossy plane-component of one tile: all subbands, then the
// level-by-level whole-plane synthesis (equivalent in output to the
// reference's rolling line IDWT, crxDecodePlane levels!=0 branch), then
// the median offset into the strided CFA output (crxConvertPlaneLine
// nPlanes==4 case).
static bool crx_decode_lossy_comp(const uint8_t* compData, uint64_t compAvail,
                                  const CrxCompInfo& ci, const CrxTileInfo& ti,
                                  int levels, int tileW, int tileH, int nBits,
                                  uint16_t* dst, size_t dstStride,
                                  size_t dstStep) {
    int nb = 3 * levels + 1;
    if ((int)ci.bands.size() != nb) return false;
    std::vector<std::vector<int32_t>> bd(nb);
    for (int b = 0; b < nb; ++b) {
        const CrxBandInfo& bi = ci.bands[b];
        if (bi.dataOff < 0 || (uint64_t)bi.dataOff + bi.dataSize > compAvail)
            return false;
        int level = b == 0 ? 0 : (b - 1) / 3;
        const uint32_t* qs = nullptr;
        int qsW = 0, qsH = 0;
        if (level < (int)ti.qsTbl.size() && !ti.qsTbl[level].empty()) {
            qs = ti.qsTbl[level].data();
            qsW = ti.qsW[level];
            qsH = ti.qsH[level];
        }
        bool compPartial = ci.supportsPartial && b == 0;
        if (!crx_decode_band(compData + bi.dataOff, bi, compPartial, true,
                             qs, qsW, qsH, bd[b]))
            return false;
    }
    std::vector<int32_t> cur = std::move(bd[0]);
    int curW = ci.bands[0].width, curH = ci.bands[0].height;
    for (int lv = 0; lv < levels; ++lv) {
        // intermediate synthesized planes carry the next level's subband
        // extents (crxSetupSubbandData transformWidth/height selection)
        int outW = (lv == levels - 1) ? tileW
                                      : ci.bands[3 * (lv + 1) + 2].width;
        int outH = (lv == levels - 1) ? tileH
                                      : ci.bands[3 * (lv + 1) + 1].height;
        const CrxBandInfo& b1 = ci.bands[3 * lv + 1];
        const CrxBandInfo& b2 = ci.bands[3 * lv + 2];
        const CrxBandInfo& b3 = ci.bands[3 * lv + 3];
        std::vector<int32_t> next;
        if (!crx_idwt_level(cur, curW, curH,
                            bd[3 * lv + 1], b1.width, b1.height,
                            bd[3 * lv + 2], b2.width, b2.height,
                            bd[3 * lv + 3], b3.width, b3.height,
                            outW, outH, ti.flags, next))
            return false;
        cur = std::move(next);
        curW = outW;
        curH = outH;
        bd[3 * lv + 1] = {};
        bd[3 * lv + 2] = {};
        bd[3 * lv + 3] = {};
    }
    if (curW < tileW || curH < tileH) return false;
    int32_t median = 1 << (nBits - 1), maxVal = (1 << nBits) - 1;
    for (int y = 0; y < tileH; ++y) {
        const int32_t* src = cur.data() + (size_t)y * curW;
        uint16_t* d = dst + dstStride * (size_t)y;
        for (int x = 0; x < tileW; ++x) {
            int32_t v = median + src[x];
            if (v < 0) v = 0;
            if (v > maxVal) v = maxVal;
            d[dstStep * (size_t)x] = (uint16_t)v;
        }
    }
    return true;
}

struct Cr3Track {
    int type = 0;        // hdlr: 2=vide, 4=meta
    int mediaType = 0;   // 1=RAW (CMP1 parsed ok), 2=JPEG
    uint64_t mediaOffset = 0;
    uint64_t mediaSize = 0;
    std::string format;  // stsd format id
    // CMP1 header fields (crxParseImageHeader)
    int version = 0, f_width = 0, f_height = 0, tileWidth = 0,
        tileHeight = 0, nBits = 0, nPlanes = 0, cfaLayout = 0,
        encType = 0, imageLevels = 0, mdatHdrSize = 0;
};

static uint32_t be32(const uint8_t* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
         | ((uint32_t)p[2] << 8) | p[3];
}
static uint16_t be16(const uint8_t* p) {
    return (uint16_t)((p[0] << 8) | p[1]);
}

// recursive ISO-BMFF walk (parseCR3's atom list, without the
// dcraw-global state)
static void cr3_walk(const uint8_t* buf, size_t len, uint64_t off,
                     uint64_t end, const std::string& path,
                     std::vector<Cr3Track>& tracks, int& curTrack,
                     std::vector<std::pair<uint64_t, uint64_t>>& cmt,
                     int depth) {
    static const char* containers[] = {
        "moov", "trak", "mdia", "minf", "stbl", "dinf", "edts", "stsd",
        "CRAW", "CCTP"};
    if (depth > 16) return;
    while (off + 8 <= end) {
        uint64_t sz = be32(buf + off);
        char name[5] = {0};
        memcpy(name, buf + off + 4, 4);
        uint64_t content = off + 8;
        if (sz == 1 && off + 16 <= end) {
            sz = ((uint64_t)be32(buf + off + 8) << 32) | be32(buf + off + 12);
            content = off + 16;
        } else if (sz == 0) {
            sz = end - off;
        }
        if (sz < 8 || off + sz > end) return;
        uint64_t cend = off + sz;
        std::string p2 = path + name;

        if (strcmp(name, "trak") == 0) {
            tracks.push_back(Cr3Track());
            curTrack = (int)tracks.size() - 1;
        }
        bool recurse = false;
        uint64_t skip = 0;
        for (const char* c : containers)
            if (strcmp(name, c) == 0) { recurse = true; break; }
        if (p2 == "moovuuid") {
            static const uint8_t kCanonUuid[16] = {
                0x85, 0xc0, 0xb6, 0x87, 0x82, 0x0f, 0x11, 0xe0,
                0x81, 0x11, 0xf4, 0xce, 0x46, 0x2b, 0x6a, 0x48};
            if (content + 16 <= cend
                    && memcmp(buf + content, kCanonUuid, 16) == 0) {
                recurse = true;
                skip = 16;
            }
        } else if (p2.size() >= 8
                   && p2.compare(p2.size() - 8, 8, "uuidCMT1") == 0) {
            cmt.push_back({content, cend - content});  // IFD0 TIFF
        } else if (p2.size() >= 8
                   && p2.compare(p2.size() - 8, 8, "uuidCMT2") == 0) {
            cmt.push_back({content, cend - content});  // EXIF TIFF
        } else if (p2.size() >= 8
                   && p2.compare(p2.size() - 8, 8, "uuidCMT3") == 0) {
            cmt.push_back({content, cend - content});  // makernote TIFF
        } else if (strcmp(name, "hdlr") == 0 && curTrack >= 0
                   && content + 12 <= cend) {
            const uint8_t* h = buf + content + 8;
            if (memcmp(h, "vide", 4) == 0) tracks[curTrack].type = 2;
            else if (memcmp(h, "meta", 4) == 0) tracks[curTrack].type = 4;
        } else if (strcmp(name, "stsd") == 0 && curTrack >= 0
                   && content + 16 <= cend) {
            // version/flags + entry count, then the first sample entry
            char fmt[5] = {0};
            memcpy(fmt, buf + content + 12, 4);
            tracks[curTrack].format = fmt;
            skip = 8;  // stsd header before the sample entries
        } else if (strcmp(name, "CRAW") == 0) {
            skip = 82;  // CRAW sample-entry fields before child boxes
        } else if (strcmp(name, "CMP1") == 0 && curTrack >= 0
                   && content + 36 <= cend) {
            // 36-byte header blob; first 4 bytes are box flags
            // (crxParseImageHeader offsets are relative to the blob)
            const uint8_t* t = buf + content;
            Cr3Track& tk = tracks[curTrack];
            tk.version = be16(t + 4);
            tk.f_width = (int)be32(t + 8);
            tk.f_height = (int)be32(t + 12);
            tk.tileWidth = (int)be32(t + 16);
            tk.tileHeight = (int)be32(t + 20);
            tk.nBits = t[24];
            tk.nPlanes = t[25] >> 4;
            tk.cfaLayout = t[25] & 0xF;
            tk.encType = t[26] >> 4;
            tk.imageLevels = t[26] & 0xF;
            tk.mdatHdrSize = (int)be32(t + 28);
            bool ok = (tk.version == 0x100 || tk.version == 0x200)
                      && tk.mdatHdrSize > 0 && tk.f_width > 0
                      && tk.f_height > 0 && tk.tileWidth > 0
                      && tk.tileHeight > 0;
            if (ok) tk.mediaType = 1;
        } else if (strcmp(name, "JPEG") == 0 && curTrack >= 0) {
            tracks[curTrack].mediaType = 2;
        } else if (strcmp(name, "stsz") == 0 && curTrack >= 0) {
            uint64_t csz = cend - content;
            if (csz == 12)
                tracks[curTrack].mediaSize = be32(buf + content + 4);
            else if (csz >= 16)
                tracks[curTrack].mediaSize = be32(buf + content + 12);
        } else if (strcmp(name, "co64") == 0 && curTrack >= 0
                   && cend - content >= 16) {
            tracks[curTrack].mediaOffset =
                ((uint64_t)be32(buf + content + 8) << 32)
                | be32(buf + content + 12);
        } else if (strcmp(name, "stco") == 0 && curTrack >= 0
                   && cend - content >= 12) {
            tracks[curTrack].mediaOffset = be32(buf + content + 8);
        }

        if (recurse)
            cr3_walk(buf, len, content + skip, cend, p2, tracks, curTrack,
                     cmt, depth + 1);
        off = cend;
    }
}

// Canon ColorData as-shot WB word offset by blob length (the CR2 table
// extended with the CR3-era ColorData generations)
static int canon_colordata_wb_off(uint32_t count) {
    switch (count) {
        case 582: return 25;
        case 653: return 34;
        case 1273: case 1275: return 71;
        case 1312: case 1313: case 1316: return 63;
        case 1560: return 63;
        case 1820: case 1869: return 71;
        case 2024: case 3656: return 85;
        default: return 63;
    }
}

static uint16_t* decode_cr3(const uint8_t* buf, size_t len,
                            ArtRawMeta* meta) {
    const bool dbg = getenv("ARTRAW_DEBUG") != nullptr;
    std::vector<Cr3Track> tracks;
    std::vector<std::pair<uint64_t, uint64_t>> cmt;
    int curTrack = -1;
    cr3_walk(buf, len, 0, len, "", tracks, curTrack, cmt, 0);
    if (dbg) {
        fprintf(stderr, "cr3: %zu tracks, %zu cmt\n", tracks.size(),
                cmt.size());
        for (auto& t : tracks)
            fprintf(stderr,
                    "  track type=%d media=%d off=%llu size=%llu fmt=%s "
                    "w=%d h=%d bits=%d planes=%d enc=%d lvl=%d hdr=%d\n",
                    t.type, t.mediaType, (unsigned long long)t.mediaOffset,
                    (unsigned long long)t.mediaSize, t.format.c_str(),
                    t.f_width, t.f_height, t.nBits, t.nPlanes, t.encType,
                    t.imageLevels, t.mdatHdrSize);
    }

    // biggest RAW track (selectCRXTrack)
    const Cr3Track* best = nullptr;
    int64_t bestBits = 0;
    for (auto& t : tracks) {
        if (t.mediaType == 1 && t.mediaSize && t.mediaOffset) {
            int64_t bits = (int64_t)t.nBits * t.f_width * t.f_height;
            if (bits > bestBits) { bestBits = bits; best = &t; }
        }
    }
    if (!best) return nullptr;
    // scope: lossless (imageLevels 0) + lossy wavelet cRAW (1-3 levels);
    // encType 1/3 (the 1- and YCC-plane preview profiles) out of scope
    if (best->encType != 0 || best->nPlanes != 4 || best->imageLevels > 3
            || best->nBits < 9 || best->nBits > 15)
        return nullptr;
    if (best->mediaOffset + best->mediaSize > len) return nullptr;

    // subplane geometry (crxLoadRaw halves plane dims for nPlanes 4)
    int fullW = best->f_width, fullH = best->f_height;
    int pw = fullW >> 1, ph = fullH >> 1;
    int tw = best->tileWidth >> 1, thh = best->tileHeight >> 1;
    int tileCols = (pw + tw - 1) / tw;
    int tileRows = (ph + thh - 1) / thh;

    const uint8_t* mdat = buf + best->mediaOffset;
    int hdrSize = best->mdatHdrSize;
    if ((size_t)hdrSize > best->mediaSize) return nullptr;

    uint16_t* out = (uint16_t*)calloc((size_t)fullW * fullH,
                                      sizeof(uint16_t));
    if (!out) return nullptr;

    // output subplane bases per cfaLayout (crxSetupImageData)
    size_t rowSize = (size_t)fullW;
    size_t base[4];
    switch (best->cfaLayout) {
        case 1:  // G R / B G
            base[1] = 0; base[0] = 1; base[3] = rowSize;
            base[2] = rowSize + 1; break;
        case 2:  // G B / R G
            base[2] = 0; base[3] = 1; base[0] = rowSize;
            base[1] = rowSize + 1; break;
        case 3:  // B G / G R
            base[3] = 0; base[2] = 1; base[1] = rowSize;
            base[0] = rowSize + 1; break;
        default:  // 0: R G / G B
            base[0] = 0; base[1] = 1; base[2] = rowSize;
            base[3] = rowSize + 1; break;
    }

    // walk the mdat header: FF01/FF11 tile + per plane FF02 + subband
    // FF03/FF13 headers (crxReadImageHeaders layout)
    const int levels = best->imageLevels;
    const int nb = 3 * levels + 1;
    const uint8_t* hp = mdat;
    int hleft = hdrSize;
    uint64_t tileOffset = 0;
    bool ok = true;
    for (int t = 0; t < tileRows * tileCols && ok; ++t) {
        if (hleft < 12) { ok = false; break; }
        int sign = be16(hp), hsz = be16(hp + 2);
        if ((sign != 0xFF01 && sign != 0xFF11)
                || (hsz != 8 && hsz != 16)) { ok = false; break; }
        CrxTileInfo ti;
        ti.tileSize = be32(hp + 4);
        if (hsz == 16) {
            if (hleft < 20) { ok = false; break; }
            ti.qpSize = be32(hp + 12);
            ti.extraSize = be16(hp + 16);
            ti.hasQP = true;
        }
        hp += hsz + 4;
        hleft -= hsz + 4;

        int tRow = t / tileCols, tCol = t % tileCols;
        int thisW = (tCol == tileCols - 1) ? pw - tw * (tileCols - 1) : tw;
        int thisH = (tRow == tileRows - 1) ? ph - thh * (tileRows - 1) : thh;
        ti.width = thisW;
        ti.height = thisH;
        if (tileCols > 1) {
            if (tCol < tileCols - 1) ti.flags |= kCrxTileRight;
            if (tCol > 0) ti.flags |= kCrxTileLeft;
        }
        if (tileRows > 1) {
            if (tRow < tileRows - 1) ti.flags |= kCrxTileBottom;
            if (tRow > 0) ti.flags |= kCrxTileTop;
        }

        // v0x200 QP map sits at the head of the tile's data region
        if (levels > 0 && ti.hasQP && ti.qpSize > 0) {
            uint64_t qpOff = best->mediaOffset + hdrSize + tileOffset;
            if (qpOff + ti.qpSize > len
                    || !crx_decode_qsteps(buf + qpOff, ti.qpSize, levels,
                                          thisW, thisH, ti)) {
                ok = false;
                break;
            }
        }

        uint64_t compOffset = 0;
        for (int c = 0; c < 4 && ok; ++c) {
            if (hleft < 12) { ok = false; break; }
            sign = be16(hp); hsz = be16(hp + 2);
            if ((sign != 0xFF02 && sign != 0xFF12) || hsz != 8) {
                ok = false; break;
            }
            CrxCompInfo ci;
            ci.compSize = be32(hp + 4);
            ci.supportsPartial = (hp[8] & 8) != 0;
            ci.roundedBits = (hp[8] >> 1) & 3;
            hp += 12;
            hleft -= 12;
            // roundedBits ("lossy lite") profile out of scope
            if (ci.roundedBits) { ok = false; break; }

            crx_band_geometry(levels, thisW, thisH, ti.flags, ci.bands);
            uint64_t bandOff = 0;
            for (int b = 0; b < nb && ok; ++b) {
                if (hleft < 12) { ok = false; break; }
                sign = be16(hp); hsz = be16(hp + 2);
                CrxBandInfo& bi = ci.bands[b];
                if (sign == 0xFF03 && hsz == 8) {
                    uint32_t subbandSize = be32(hp + 4);
                    uint32_t bitData = be32(hp + 8);
                    if ((int)((hp[8] & 0xF0) >> 4) != b
                            || (bitData & 0x7FFFF) > subbandSize) {
                        ok = false; break;
                    }
                    bi.dataSize = subbandSize - (bitData & 0x7FFFF);
                    bi.hdrPartial = (bitData & 0x8000000u) != 0;
                    bi.qParam = (int)((bitData >> 19) & 0xFF);
                    bi.dataOff = (int64_t)bandOff;
                    bandOff += subbandSize;
                    hp += 12;
                    hleft -= 12;
                } else if (sign == 0xFF13 && hsz == 16) {
                    if (hleft < 20) { ok = false; break; }
                    uint32_t subbandSize = be32(hp + 4);
                    if ((int)((hp[8] & 0xF0) >> 4) != b
                            || (be16(hp + 8) & 0xFFF) || be16(hp + 18)
                            || be16(hp + 16) > subbandSize) {
                        ok = false; break;
                    }
                    bi.qStepMult = be16(hp + 10);
                    bi.qStepBase = be32(hp + 12);
                    bi.dataSize = subbandSize - be16(hp + 16);
                    bi.dataOff = (int64_t)bandOff;
                    bandOff += subbandSize;
                    hp += 20;
                    hleft -= 20;
                } else {
                    ok = false; break;
                }
            }
            if (!ok) break;

            uint64_t dataOff = best->mediaOffset + hdrSize + tileOffset
                               + ti.qpSize + ti.extraSize + compOffset;
            if (dataOff + ci.compSize > len) { ok = false; break; }
            uint16_t* dst = out + base[c]
                + 2 * rowSize * (size_t)(tRow * (size_t)thh)
                + 2 * (size_t)(tCol * (size_t)tw);
            if (levels == 0) {
                const CrxBandInfo& bi = ci.bands[0];
                if (bi.dataSize == 0) {
                    // empty band: zeros (median value after conversion)
                    for (int y = 0; y < thisH; ++y)
                        for (int x = 0; x < thisW; ++x)
                            dst[2 * rowSize * y + 2 * (size_t)x] =
                                (uint16_t)(1 << (best->nBits - 1));
                } else if (!crx_decode_tile_plane(
                               buf + dataOff + bi.dataOff, bi.dataSize,
                               thisW, thisH, best->nBits, dst,
                               2 * rowSize, 2)) {
                    ok = false;
                }
            } else if (!crx_decode_lossy_comp(
                           buf + dataOff, ci.compSize, ci, ti, levels,
                           thisW, thisH, best->nBits, dst, 2 * rowSize, 2)) {
                ok = false;
            }
            compOffset += ci.compSize;
        }
        tileOffset += ti.tileSize;
    }
    if (!ok) {
        if (dbg) fprintf(stderr, "cr3: tile decode failed\n");
        free(out);
        return nullptr;
    }

    // ---- metadata ----
    memset(meta, 0, sizeof(*meta));
    meta->xtrans[0] = -1;
    meta->width = fullW;
    meta->height = fullH;
    static const int kLayouts[4][4] = {
        {0, 1, 1, 2}, {1, 0, 2, 1}, {1, 2, 0, 1}, {2, 1, 1, 0}};
    for (int i = 0; i < 4; ++i)
        meta->cfa_pattern[i] = kLayouts[best->cfaLayout & 3][i];
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    double wmax = (1 << best->nBits) - 1;
    for (int i = 0; i < 4; ++i) meta->white[i] = wmax;
    meta->iso = 100.0;
    meta->orientation = 1;
    strncpy(meta->make, "Canon", 63);

    // CMT boxes: CMT1 = IFD0 (make/model), CMT2 = EXIF (iso),
    // CMT3 = makernote (SensorInfo crop + ColorData WB)
    for (auto& c : cmt) {
        if (c.first + 8 > len) continue;
        Reader cr{buf + c.first, (size_t)c.second,
                  buf[c.first] == 'I'};
        if (cr.u16(2) != 42) continue;
        IFD ifd;
        std::vector<uint32_t> subs;
        parse_ifd(cr, cr.u32(4), ifd, subs, 0);
        const TagValue* mk = ifd.find(271);
        if (mk) strncpy(meta->make, mk->str.c_str(), 63);
        const TagValue* md = ifd.find(272);
        if (md) strncpy(meta->model, md->str.c_str(), 63);
        const TagValue* ori = ifd.find(274);
        if (ori && !ori->nums.empty())
            meta->orientation = (int)ori->nums[0];
        const TagValue* iso = ifd.find(34855);
        if (iso && !iso->nums.empty()) meta->iso = iso->nums[0];
        const TagValue* si = ifd.find(0x00E0);  // SensorInfo (CMT3)
        if (si && si->nums.size() >= 9) {
            int a_left = (int)si->nums[5], a_top = (int)si->nums[6];
            int a_right = (int)si->nums[7], a_bot = (int)si->nums[8];
            if (a_left >= 0 && a_top >= 0 && a_right > a_left
                    && a_bot > a_top && a_right < fullW && a_bot < fullH) {
                meta->active_area[0] = a_top;
                meta->active_area[1] = a_left;
                meta->active_area[2] = a_bot + 1;
                meta->active_area[3] = a_right + 1;
            }
        }
        const TagValue* cd = ifd.find(0x4001);  // ColorData (CMT3)
        if (cd && cd->off && cd->count > 100) {
            int woff = canon_colordata_wb_off(cd->count);
            double wb[4];
            for (int i = 0; i < 4; ++i)
                wb[i] = cr.u16(cd->off + 2 * (size_t)(woff + i));
            if (wb[0] > 0 && wb[1] > 0 && wb[3] > 0) {
                meta->as_shot_neutral[0] = wb[1] / wb[0];
                meta->as_shot_neutral[1] = 1.0;
                meta->as_shot_neutral[2] = wb[1] / wb[3];
            }
        }
    }
    return out;
}

// ---------------------------------------------------------------------------
// Kodak DCR/KDC (DCS Pro 14n/SLR-class; TIFF container, compression
// 65000). Reference decode boundary: dcraw.cc kodak_65000_decode :3199 +
// kodak_65000_load_raw :3245 + linear_table :?. Honest provenance, as
// with CRX/CRW: no public spec; restructured with bounds guards.
// Stream: per <=256-pixel row segment, nibble-packed bit lengths then
// var-length diffs refilled 32 bits at a time with byte pairs swapped
// (two big-endian u16s), column-parity predictors; an all-raw escape
// block when any nibble exceeds 12; values map through the tag-2317
// linearization curve.
// ---------------------------------------------------------------------------
// returns -1 on error, 0 for compressed diffs, 1 for the absolute-value
// escape block. `little` is the container byte order: the escape-block
// u16s follow it (dcraw's read_shorts), while the nibble stream and the
// 32-bit refill are raw bytes, order-independent.
static int dcr_65000_decode(const uint8_t*& p, const uint8_t* end,
                            int16_t* out, int bsize_in, bool little) {
    int bsize = (bsize_in + 3) & ~3;
    if (bsize > 768) return -1;
    uint8_t blen[768];
    const uint8_t* save = p;
    bool escape = false;
    for (int i = 0; i < bsize; i += 2) {
        if (p >= end) return -1;
        uint8_t c = *p++;
        blen[i] = c & 15;
        blen[i + 1] = c >> 4;
        if (blen[i] > 12 || blen[i + 1] > 12) { escape = true; break; }
    }
    if (escape) {
        // uncompressed escape: groups of 8 values from six u16s
        p = save;
        for (int i = 0; i < bsize; i += 8) {
            if (p + 12 > end) return -1;
            uint16_t raw[6];
            for (int j = 0; j < 6; ++j) {
                raw[j] = little ? (uint16_t)(p[0] | (p[1] << 8))
                                : (uint16_t)((p[0] << 8) | p[1]);
                p += 2;
            }
            out[i] = (int16_t)((raw[0] >> 12 << 8) | (raw[2] >> 12 << 4)
                               | (raw[4] >> 12));
            out[i + 1] = (int16_t)((raw[1] >> 12 << 8) | (raw[3] >> 12 << 4)
                                   | (raw[5] >> 12));
            for (int j = 0; j < 6; ++j)
                out[i + 2 + j] = (int16_t)(raw[j] & 0xfff);
        }
        return 1;
    }
    uint64_t bitbuf = 0;
    int bits = 0;
    if ((bsize & 7) == 4) {
        if (p + 2 > end) return -1;
        bitbuf = (uint64_t)(*p++) << 8;
        bitbuf += *p++;
        bits = 16;
    }
    for (int i = 0; i < bsize; ++i) {
        int len = blen[i];
        if (bits < len) {
            for (int j = 0; j < 32; j += 8) {
                uint8_t b = (p < end) ? *p++ : 0;
                bitbuf += (uint64_t)b << (bits + (j ^ 8));
            }
            bits += 32;
        }
        int diff = (int)(bitbuf & (0xffff >> (16 - len)));
        bitbuf >>= len;
        bits -= len;
        if (len && (diff & (1 << (len - 1))) == 0)
            diff -= (1 << len) - 1;
        out[i] = (int16_t)diff;
    }
    return 0;
}

static uint16_t* decode_dcr(const Reader& r, const std::vector<IFD>& ifds,
                            const IFD* raw, ArtRawMeta* meta) {
    int W = (int)raw->num(256, 0);
    int H = (int)raw->num(257, 0);
    if (W <= 0 || H <= 0 || (int64_t)W * H > (int64_t)1 << 28)
        return nullptr;
    const TagValue* so = raw->find(273);
    if (!so || so->nums.empty()) return nullptr;
    size_t off = (size_t)so->nums[0];
    if (off >= r.len) return nullptr;

    // linearization curve (tag 2317 in the Kodak IFD chain)
    std::vector<uint16_t> curve(0x10000);
    for (int i = 0; i < 0x10000; ++i) curve[i] = (uint16_t)i;
    double white = 0xfff;
    for (auto& ifd : ifds) {
        const TagValue* tv = ifd.find(2317);
        if (tv && !tv->nums.empty()) {
            size_t n = tv->nums.size() < (size_t)0x10000
                       ? tv->nums.size() : (size_t)0x10000;
            for (size_t i = 0; i < n; ++i)
                curve[i] = (uint16_t)tv->nums[i];
            for (size_t i = n; i < 0x10000; ++i) curve[i] = curve[n - 1];
            white = curve[n < 0x1000 ? 0xfff : n - 1];
            break;
        }
    }

    uint16_t* img = (uint16_t*)calloc((size_t)W * H, 2);
    if (!img) return nullptr;
    const uint8_t* p = r.buf + off;
    const uint8_t* end = r.buf + r.len;
    int16_t buf[768];
    for (int row = 0; row < H; ++row) {
        for (int col = 0; col < W; col += 256) {
            int len = W - col < 256 ? W - col : 256;
            int pred[2] = {0, 0};
            int ret = dcr_65000_decode(p, end, buf, len, r.little);
            if (ret < 0) {
                free(img);
                return nullptr;
            }
            // escape blocks carry absolute values; compressed blocks
            // carry column-parity predicted diffs
            for (int i = 0; i < len; ++i) {
                int idx = ret ? buf[i] : (pred[i & 1] += buf[i]);
                if (idx < 0 || idx > 0xffff) { free(img); return nullptr; }
                img[(size_t)row * W + col + i] = curve[idx];
            }
        }
    }

    memset(meta, 0, sizeof(*meta));
    meta->xtrans[0] = -1;
    meta->width = W;
    meta->height = H;
    meta->cfa_pattern[0] = 0; meta->cfa_pattern[1] = 1;
    meta->cfa_pattern[2] = 1; meta->cfa_pattern[3] = 2;
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    meta->orientation = (int)ifds[0].num(274, 1);
    meta->iso = 100.0;
    for (int i = 0; i < 4; ++i) {
        meta->black[i] = 0.0;
        meta->white[i] = white;
    }
    const TagValue* mk = ifds[0].find(271);
    const TagValue* md = ifds[0].find(272);
    if (mk) snprintf(meta->make, 64, "%s", mk->str.c_str());
    if (md) snprintf(meta->model, 64, "%s", md->str.c_str());
    // software WB (tag 1021, 72 bytes: R,G,B at offset 40, 2048/x)
    for (auto& ifd : ifds) {
        const TagValue* wb = ifd.find(1021);
        if (wb && wb->nums.size() >= 23) {
            double r_ = wb->nums[20], g_ = wb->nums[21], b_ = wb->nums[22];
            if (r_ > 0 && g_ > 0 && b_ > 0) {
                // cam_mul = 2048/x; neutral = g_mul/c_mul = x_c/x_g
                meta->as_shot_neutral[0] = r_ / g_;
                meta->as_shot_neutral[1] = 1.0;
                meta->as_shot_neutral[2] = b_ / g_;
            }
            break;
        }
    }
    return img;
}

// ---------------------------------------------------------------------------
// Kodak RADC (DC40/DC50 KDC, Apple QuickTake 150/200, Logitech Fotoman
// Pixtura). Reference decode boundary: rtengine/dcraw.cc
// kodak_radc_load_raw :2830 + the identify() model routing
// :10555-10582. Honest provenance, as with CRW/DCR: the format has no
// public spec and dcraw is the de-facto documentation. The 18 per-band
// huffman code tables and the 12->14-bit tone points ARE the format
// (fixed camera-side constants); the decoder is restructured here —
// canonical-code tables through the shared HuffTable machinery, an
// explicit per-channel band-state vector, value guards, and a separate
// emit/roll step — rather than dcraw's flat 256-slot LUT + macro loops.
//
// Bitstream model: 4-row bands. Each band opens with three 6-bit
// channel multipliers (G, R, B); per channel the persistent 3-row
// half-width state is rescaled from the previous band's multiplier,
// then one (chroma) or two (green) half-row token passes refine it:
// a tree-selection token (tables 0..9) either switches to one of 7
// delta tables (11..17, value*16 + neighborhood predictor), emits
// quantized literals (table 18), or enters a run of predictor-only
// column pairs (run length from table 9, odd-step corrections from
// table 10). Chroma planes are coded as 2048-biased half-differences
// against green and reconstructed after the band; a fixed piecewise-
// linear curve expands 12-bit code values to the 14-bit output domain.
// ---------------------------------------------------------------------------
// (length, value) pairs per table; codes are assigned by sequential
// slot filling over an 8-bit lookahead (see build_radc_lut). Each
// table is a complete prefix code.
static const int8_t kRadcPairs[][2] = {
    // tables 0..9: tree-selection contexts (values 0..8)
    {1,1},{2,3},{3,4},{4,2},{5,7},{6,5},{7,6},{7,8},
    {1,0},{2,1},{3,3},{4,4},{5,2},{6,7},{7,6},{8,5},{8,8},
    {2,1},{2,3},{3,0},{3,2},{3,4},{4,6},{5,5},{6,7},{6,8},
    {2,0},{2,1},{2,3},{3,2},{4,4},{5,6},{6,7},{7,5},{7,8},
    {2,1},{2,4},{3,0},{3,2},{3,3},{4,7},{5,5},{6,6},{6,8},
    {2,3},{3,1},{3,2},{3,4},{3,5},{3,6},{4,7},{5,0},{5,8},
    {2,3},{2,6},{3,0},{3,1},{4,4},{4,5},{4,7},{5,2},{5,8},
    {2,4},{2,7},{3,3},{3,6},{4,1},{4,2},{4,5},{5,0},{5,8},
    {2,6},{3,1},{3,3},{3,5},{3,7},{3,8},{4,0},{5,2},{5,4},
    {2,0},{2,1},{3,2},{3,3},{4,4},{4,5},{5,6},{5,7},{4,8},
    // table 10: run odd-step corrections
    {1,0},{2,2},{2,-2},
    // table 11: delta table for tree 1
    {1,-3},{1,3},
    // tables 12..14
    {2,-17},{2,-5},{2,5},{2,17},
    {2,-7},{2,2},{2,9},{2,18},
    {2,-18},{2,-9},{2,-2},{2,7},
    // tables 15..17
    {2,-28},{2,28},{3,-49},{3,-9},{3,9},{4,49},{5,-79},{5,79},
    {2,-1},{2,13},{2,26},{3,39},{4,-16},{5,55},{6,-37},{6,76},
    {2,-26},{2,-13},{2,1},{3,-39},{4,16},{5,-55},{6,-76},{6,37},
};
static const uint8_t kRadcCount[18] = {
    8, 9, 9, 9, 9, 9, 9, 9, 9, 9, 3, 2, 4, 4, 4, 8, 8, 8};

// Prefix codes assigned by sequential slot filling over an 8-bit
// lookahead (each (len, val) pair claims the next 256>>len slots) —
// NOT canonical-by-length: table 9 lists a length-4 code after its
// length-5 codes, so the code for a value is defined by its slot
// position, and decode is a flat 256-entry lookup.
struct RadcLut {
    uint8_t len[256];
    int8_t val[256];
    bool valid = false;
};

static void build_radc_lut(const int8_t (*pairs)[2], int n, RadcLut& t) {
    int s = 0;
    for (int i = 0; i < n; ++i) {
        int ln = pairs[i][0];
        if (ln < 1 || ln > 8) return;
        int cnt = 256 >> ln;
        if (s + cnt > 256) return;
        for (int j = 0; j < cnt; ++j) {
            t.len[s] = (uint8_t)ln;
            t.val[s] = pairs[i][1];
            ++s;
        }
    }
    t.valid = s == 256;
}

static int radc_token(RawBitReader& br, const RadcLut& t) {
    int idx = br.peek(8);
    br.skip(t.len[idx]);
    return t.val[idx];
}

// Decode the RADC stream into a width x height GRBG mosaic in the
// 14-bit output domain. cbpp: EXIF CompressedBitsPerPixel (243 on the
// DC50 class selects the coarser 6-bit literal quantizer).
static uint16_t* radc_decode_stream(const uint8_t* p, const uint8_t* end,
                                    int width, int height, int cbpp) {
    if (width < 4 || height < 4 || width > 4096 || height > 4096 ||
        (width & 1) || (height & 3) || p >= end)
        return nullptr;
    RadcLut huff[18];
    {
        int off = 0;
        for (int t = 0; t < 18; ++t) {
            build_radc_lut(kRadcPairs + off, kRadcCount[t], huff[t]);
            if (!huff[t].valid) return nullptr;
            off += kRadcCount[t];
        }
    }
    const int lit_shift = cbpp == 243 ? 2 : 3;  // table-18 quantizer
    const int half = width / 2;
    const int stride = half + 2;
    // persistent band state: [channel][3 rows][half+2]; the extra two
    // columns hold the right boundary seed and the green diagonal shift
    std::vector<int16_t> st((size_t)3 * 3 * stride, 2048);
    auto B = [&](int c, int y, int x) -> int16_t& {
        return st[((size_t)c * 3 + y) * stride + x];
    };
    uint16_t* img = (uint16_t*)calloc((size_t)width * height, 2);
    if (!img) return nullptr;

    RawBitReader br(p, end);
    int last[3] = {16, 16, 16};
    bool bad = false;
    for (int row = 0; row < height && !bad; row += 4) {
        int mul[3];
        for (int c = 0; c < 3; ++c) {
            mul[c] = br.get(6);
            if (!mul[c]) mul[c] = 1;  // corrupt stream: keep going
        }
        for (int c = 0; c < 3 && !bad; ++c) {
            // rescale the carried state old-mul -> new-mul in fixed point
            int val = ((0x1000000 / last[c] + 0x7ff) >> 12) * mul[c];
            int sh = val > 65564 ? 10 : 12;
            int rnd = (1 << (sh - 1)) - 1;
            val <<= 12 - sh;
            int16_t* cst = &st[(size_t)c * 3 * stride];
            for (int i = 0; i < 3 * stride; ++i)
                cst[i] = (int16_t)(((int64_t)cst[i] * val + rnd) >> sh);
            last[c] = mul[c];
            const int passes = c ? 1 : 2;  // green covers all 4 rows
            for (int pass = 0; pass < passes; ++pass) {
                B(c, 1, half) = B(c, 2, half) = (int16_t)(mul[c] << 7);
                // neighborhood predictor; x+1 (right) is already decoded
                auto pred = [&](int y, int x) -> int {
                    if (c == 0)
                        return (B(0, y - 1, x + 1) + 2 * B(0, y - 1, x) +
                                B(0, y, x + 1)) / 4;
                    return (B(c, y - 1, x) + B(c, y, x + 1)) / 2;
                };
                int tree = 1, col = half;
                while (col > 0) {
                    tree = radc_token(br, huff[tree]);
                    if (tree < 0 || tree > 8) { bad = true; break; }
                    if (tree) {
                        col -= 2;
                        for (int y = 1; y < 3; ++y)
                            for (int x = col + 1; x >= col; --x) {
                                if (tree == 8) {
                                    // quantized literal: top bits + half
                                    int q = br.get(8 - lit_shift);
                                    int lit = (q << lit_shift) |
                                              (1 << (lit_shift - 1));
                                    B(c, y, x) =
                                        (int16_t)(lit * mul[c]);
                                } else {
                                    int d = radc_token(br,
                                                       huff[tree + 10]);
                                    B(c, y, x) = (int16_t)(d * 16 +
                                                           pred(y, x));
                                }
                            }
                    } else {
                        // run of predictor-only column pairs
                        int nreps;
                        do {
                            nreps = col > 2
                                ? radc_token(br, huff[9]) + 1
                                : 1;
                            if (nreps < 1) { bad = true; break; }
                            for (int rep = 0;
                                 rep < 8 && rep < nreps && col > 0; ++rep) {
                                col -= 2;
                                for (int y = 1; y < 3; ++y)
                                    for (int x = col + 1; x >= col; --x)
                                        B(c, y, x) =
                                            (int16_t)pred(y, x);
                                if (rep & 1) {
                                    int step = 16 *
                                        radc_token(br, huff[10]);
                                    for (int y = 1; y < 3; ++y)
                                        for (int x = col + 1; x >= col;
                                             --x)
                                            B(c, y, x) = (int16_t)(
                                                B(c, y, x) + step);
                                }
                            }
                        } while (nreps == 9 && !bad);
                    }
                }
                if (bad) break;
                // emit: green fills the (row+col)-even diagonal of the
                // pass's two rows; chroma lands on its parity column
                for (int y = 0; y < 2; ++y)
                    for (int x = 0; x < half; ++x) {
                        int v = (int)B(c, y + 1, x) * 16 / mul[c];
                        if (v < 0) v = 0;
                        int orow, ocol;
                        if (c) {
                            orow = row + y * 2 + c - 1;
                            ocol = x * 2 + 2 - c;
                        } else {
                            orow = row + pass * 2 + y;
                            ocol = x * 2 + y;
                        }
                        if (orow < height && ocol < width)
                            img[(size_t)orow * width + ocol] =
                                (uint16_t)(v > 0xffff ? 0xffff : v);
                    }
                // roll row 2 into row 0 for the next pass/band; the
                // green plane shifts one column (diagonal lattice)
                if (c == 0)
                    memmove(&B(0, 0, 1), &B(0, 2, 0),
                            (size_t)(stride - 1) * 2);
                else
                    memmove(&B(c, 0, 0), &B(c, 2, 0), (size_t)stride * 2);
            }
        }
        // chroma reconstruction: values were coded as 2048-biased
        // half-differences vs the horizontal green average
        for (int y = row; y < row + 4; ++y)
            for (int x = (y & 1) ^ 1; x < width; x += 2) {
                int l = x ? x - 1 : x + 1;
                int rr = x + 1 < width ? x + 1 : x - 1;
                int v = ((int)img[(size_t)y * width + x] - 2048) * 2 +
                        ((int)img[(size_t)y * width + l] +
                         (int)img[(size_t)y * width + rr]) / 2;
                if (v < 0) v = 0;
                if (v > 0xffff) v = 0xffff;
                img[(size_t)y * width + x] = (uint16_t)v;
            }
    }
    if (bad) { free(img); return nullptr; }
    // 12-bit -> 14-bit tone expansion (fixed points; +0.5 rounding)
    static const int kPt[6][2] = {{0, 0}, {1280, 1344}, {2320, 3616},
                                  {3328, 8000}, {4095, 16383},
                                  {65535, 16383}};
    std::vector<uint16_t> curve(0x10000);
    for (int seg = 1; seg < 6; ++seg) {
        int x0 = kPt[seg - 1][0], y0 = kPt[seg - 1][1];
        int x1 = kPt[seg][0], y1 = kPt[seg][1];
        for (int x = x0; x <= x1; ++x)
            curve[x] = (uint16_t)((double)(x - x0) / (x1 - x0) *
                                      (y1 - y0) + y0 + 0.5);
    }
    for (size_t i = 0; i < (size_t)width * height; ++i)
        img[i] = curve[img[i]];
    return img;
}

static void radc_fill_meta(ArtRawMeta* meta, int width, int height,
                           const char* make, const char* model) {
    memset(meta, 0, sizeof(*meta));
    meta->xtrans[0] = -1;
    meta->width = width;
    meta->height = height;
    // GRBG (the reference's filters = 0x61616161 for every RADC camera)
    meta->cfa_pattern[0] = 1; meta->cfa_pattern[1] = 0;
    meta->cfa_pattern[2] = 2; meta->cfa_pattern[3] = 1;
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    meta->orientation = 1;
    meta->iso = 100.0;
    for (int i = 0; i < 4; ++i) {
        meta->black[i] = 0.0;
        meta->white[i] = 0x3fff;
    }
    snprintf(meta->make, 64, "%s", make);
    snprintf(meta->model, 64, "%s", model);
}

// Apple QuickTake 100 ("qktk" magic): three-stage 4/2-bit delta-coded
// GRBG mosaic (dcraw.cc quicktake_100_load_raw :2756). The green plane
// is predicted from three causal neighbors plus a 16-step table; the
// chroma plane in two row-parity passes with a sharpness-classified
// 6x4 step table; a final pass unbiases chroma against green; a fixed
// 256->10-bit tone curve finishes. The step/tone tables are fixed
// camera-side constants — they ARE the format.
static const int16_t kQtkGStep[16] = {-89, -60, -44, -32, -22, -15, -8,
                                      -2, 2, 8, 15, 22, 32, 44, 60, 89};
static const int16_t kQtkRStep[6][4] = {
    {-3, -1, 1, 3},   {-5, -1, 1, 5},   {-8, -2, 2, 8},
    {-13, -3, 3, 13}, {-19, -4, 4, 19}, {-28, -6, 6, 28}};
static const uint16_t kQtkCurve[256] = {
    0,1,2,3,4,5,6,7,8,9,11,12,13,14,15,16,17,18,19,20,21,22,23,24,25,26,
    27,28,29,30,32,33,34,35,36,37,38,39,40,41,42,43,44,45,46,47,48,49,50,
    51,53,54,55,56,57,58,59,60,61,62,63,64,65,66,67,68,69,70,71,72,74,75,
    76,77,78,79,80,81,82,83,84,86,88,90,92,94,97,99,101,103,105,107,110,
    112,114,116,118,120,123,125,127,129,131,134,136,138,140,142,144,147,
    149,151,153,155,158,160,162,164,166,168,171,173,175,177,179,181,184,
    186,188,190,192,195,197,199,201,203,205,208,210,212,214,216,218,221,
    223,226,230,235,239,244,248,252,257,261,265,270,274,278,283,287,291,
    296,300,305,309,313,318,322,326,331,335,339,344,348,352,357,361,365,
    370,374,379,383,387,392,396,400,405,409,413,418,422,426,431,435,440,
    444,448,453,457,461,466,470,474,479,483,487,492,496,500,508,519,531,
    542,553,564,575,587,598,609,620,631,643,654,665,676,687,698,710,721,
    732,743,754,766,777,788,799,810,822,833,844,855,866,878,889,900,911,
    922,933,945,956,967,978,989,1001,1012,1023};

static uint16_t* decode_qtk100(const uint8_t* buf, size_t len,
                               ArtRawMeta* meta) {
    if (len < 740) return nullptr;
    auto be16 = [&](size_t o) { return (buf[o] << 8) | buf[o + 1]; };
    int height = be16(544), width = be16(546);
    size_t off = be16(552) == 30 ? 738 : 736;
    int orientation = 1;
    if (height > width) {
        int t = width; width = height; height = t;
        orientation = (~be16(off - 6) & 3) ? 8 : 6;
    }
    // the working buffer is a fixed 484x644 (image + 2-pixel apron)
    if (width < 4 || height < 4 || width > 640 || height > 480 ||
        (width & 1) || (height & 1))
        return nullptr;
    auto lim = [](int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); };
    std::vector<uint8_t> px((size_t)484 * 644, 0x80);
    auto P = [&](int r, int c) -> uint8_t& {
        return px[(size_t)r * 644 + c];
    };
    RawBitReader br(buf + off, buf + len);
    int val = 0;
    // stage 1: green diagonal, causal 3-tap prediction + 4-bit steps
    for (int row = 2; row < height + 2; ++row) {
        int col = 2 + (row & 1);
        for (; col < width + 2; col += 2) {
            val = ((P(row - 1, col - 1) + 2 * P(row - 1, col + 1) +
                    P(row, col - 2)) >> 2) + kQtkGStep[br.get(4)];
            val = lim(val);
            P(row, col) = (uint8_t)val;
            if (col < 4)
                P(row, col - 2) = P(row + 1, ~row & 1) = (uint8_t)val;
            if (row == 2)
                P(row - 1, col + 1) = P(row - 1, col + 3) = (uint8_t)val;
        }
        P(row, col) = (uint8_t)val;
    }
    // stage 2: chroma, two row-parity passes, sharpness-classified steps
    for (int rb = 0; rb < 2; ++rb)
        for (int row = 2 + rb; row < height + 2; row += 2)
            for (int col = 3 - (row & 1); col < width + 2; col += 2) {
                int sharp;
                if (row < 4 || col < 4) {
                    sharp = 2;
                } else {
                    int v = abs(P(row - 2, col) - P(row, col - 2)) +
                            abs(P(row - 2, col) - P(row - 2, col - 2)) +
                            abs(P(row, col - 2) - P(row - 2, col - 2));
                    sharp = v < 4 ? 0 : v < 8 ? 1 : v < 16 ? 2
                            : v < 32 ? 3 : v < 48 ? 4 : 5;
                }
                val = ((P(row - 2, col) + P(row, col - 2)) >> 1) +
                      kQtkRStep[sharp][br.get(2)];
                val = lim(val);
                P(row, col) = (uint8_t)val;
                if (row < 4) P(row - 2, col + 2) = (uint8_t)val;
                if (col < 4) P(row + 2, col - 2) = (uint8_t)val;
            }
    // stage 3: unbias chroma against horizontal green
    for (int row = 2; row < height + 2; ++row)
        for (int col = 3 - (row & 1); col < width + 2; col += 2) {
            val = ((P(row, col - 1) + (P(row, col) << 2) +
                    P(row, col + 1)) >> 1) - 0x100;
            P(row, col) = (uint8_t)lim(val);
        }
    uint16_t* img = (uint16_t*)calloc((size_t)width * height, 2);
    if (!img) return nullptr;
    for (int row = 0; row < height; ++row)
        for (int col = 0; col < width; ++col)
            img[(size_t)row * width + col] = kQtkCurve[P(row + 2, col + 2)];
    radc_fill_meta(meta, width, height, "Apple", "QuickTake 100");
    meta->orientation = orientation;
    for (int i = 0; i < 4; ++i) meta->white[i] = 0x3ff;
    return img;
}

// Kodak DC120: 848-byte 8-bit rows with a per-row rotating shift
// (dcraw.cc kodak_dc120_load_raw :3077; mul/add are the format's fixed
// row-phase constants).
static uint16_t* decode_kdc_dc120(const Reader& r,
                                  const std::vector<IFD>& ifds,
                                  ArtRawMeta* meta) {
    static const int mul[4] = {162, 192, 187, 92};
    static const int add[4] = {0, 636, 424, 212};
    const int width = 848, height = 976;
    const TagValue* so = ifds[0].find(273);
    size_t off = so && !so->nums.empty() ? (size_t)so->nums[0] : 0;
    if (!off || off + (size_t)height * 848 > r.len) return nullptr;
    uint16_t* img = (uint16_t*)calloc((size_t)width * height, 2);
    if (!img) return nullptr;
    for (int row = 0; row < height; ++row) {
        const uint8_t* line = r.buf + off + (size_t)row * 848;
        int shift = row * mul[row & 3] + add[row & 3];
        for (int col = 0; col < width; ++col)
            img[(size_t)row * width + col] = line[(col + shift) % 848];
    }
    radc_fill_meta(meta, width, height, "KODAK", "DC120");
    for (int i = 0; i < 4; ++i) meta->white[i] = 0xff;
    return img;
}

// Kodak DC40/DC50 KDC: TIFF container, RADC stream at a fixed offset.
static uint16_t* decode_kdc_radc(const Reader& r,
                                 const std::vector<IFD>& ifds,
                                 bool dc50, ArtRawMeta* meta) {
    const int width = 768, height = 512;
    size_t off = dc50 ? 19712 : 1152;
    if (off >= r.len) return nullptr;
    int cbpp = 0;
    for (auto& ifd : ifds) {
        const TagValue* tv = ifd.find(37122);
        if (tv && !tv->nums.empty()) { cbpp = (int)tv->nums[0]; break; }
    }
    uint16_t* img = radc_decode_stream(r.buf + off, r.buf + r.len,
                                       width, height, cbpp);
    if (!img) return nullptr;
    radc_fill_meta(meta, width, height, "KODAK", dc50 ? "DC50" : "DC40");
    return img;
}

// Apple QuickTake 150/200 ("qktn" magic): big-endian dims at 544,
// RADC stream at 736/738 (an indicator short at 552 selects).
static uint16_t* decode_qktn(const uint8_t* buf, size_t len,
                             ArtRawMeta* meta) {
    if (len < 740) return nullptr;
    auto be16 = [&](size_t o) { return (buf[o] << 8) | buf[o + 1]; };
    int height = be16(544), width = be16(546);
    size_t off = be16(552) == 30 ? 738 : 736;
    int orientation = 1;
    if (height > width) {
        // portrait capture: the stream is landscape; a short just
        // before the data selects the rotation direction
        int t = width; width = height; height = t;
        orientation = (~be16(off - 6) & 3) ? 8 : 6;
    }
    uint16_t* img = radc_decode_stream(buf + off, buf + len,
                                       width, height, 0);
    if (!img) return nullptr;
    radc_fill_meta(meta, width, height, "Apple",
                   buf[5] ? "QuickTake 200" : "QuickTake 150");
    meta->orientation = orientation;
    return img;
}

// Logitech Fotoman Pixtura ("PXN" magic): fixed 768x512 RADC stream.
static uint16_t* decode_pxn(const uint8_t* buf, size_t len,
                            ArtRawMeta* meta) {
    const int width = 768, height = 512;
    const size_t off = 3632;
    if (len <= off) return nullptr;
    uint16_t* img = radc_decode_stream(buf + off, buf + len,
                                       width, height, 0);
    if (!img) return nullptr;
    radc_fill_meta(meta, width, height, "Logitech", "Fotoman Pixtura");
    return img;
}

// ---------------------------------------------------------------------------
// Canon CRW (CIFF container; D30/D60/10D/300D, PowerShot G/S/Pro RAW).
// Reference decode boundary: rtengine/dcraw.cc parse_ciff :7418 +
// crw_init_tables :700 + canon_load_raw :783. Honest provenance, as with
// CRX: the format has no public spec and dcraw is the de-facto
// documentation. The three first/second code-table pairs ARE the format
// (fixed camera-side tables); the stream walker is restructured around
// our BitReader (which already implements the 0xff00 stuffing the format
// shares with JPEG) with bounds guards dcraw lacks.
// ---------------------------------------------------------------------------
static const uint8_t kCrwFirstTree[3][29] = {
    {0,1,4,2,3,1,2,0,0,0,0,0,0,0,0,0,
     0x04,0x03,0x05,0x06,0x02,0x07,0x01,0x08,0x09,0x00,0x0a,0x0b,0xff},
    {0,2,2,3,1,1,1,1,2,0,0,0,0,0,0,0,
     0x03,0x02,0x04,0x01,0x05,0x00,0x06,0x07,0x09,0x08,0x0a,0x0b,0xff},
    {0,0,6,3,1,1,2,0,0,0,0,0,0,0,0,0,
     0x06,0x05,0x07,0x04,0x08,0x03,0x09,0x02,0x00,0x0a,0x01,0x0b,0xff},
};
static const uint8_t kCrwSecondTree[3][180] = {
    {0,2,2,2,1,4,2,1,2,5,1,1,0,0,0,139,
     0x03,0x04,0x02,0x05,0x01,0x06,0x07,0x08,
     0x12,0x13,0x11,0x14,0x09,0x15,0x22,0x00,0x21,0x16,0x0a,0xf0,
     0x23,0x17,0x24,0x31,0x32,0x18,0x19,0x33,0x25,0x41,0x34,0x42,
     0x35,0x51,0x36,0x37,0x38,0x29,0x79,0x26,0x1a,0x39,0x56,0x57,
     0x28,0x27,0x52,0x55,0x58,0x43,0x76,0x59,0x77,0x54,0x61,0xf9,
     0x71,0x78,0x75,0x96,0x97,0x49,0xb7,0x53,0xd7,0x74,0xb6,0x98,
     0x47,0x48,0x95,0x69,0x99,0x91,0xfa,0xb8,0x68,0xb5,0xb9,0xd6,
     0xf7,0xd8,0x67,0x46,0x45,0x94,0x89,0xf8,0x81,0xd5,0xf6,0xb4,
     0x88,0xb1,0x2a,0x44,0x72,0xd9,0x87,0x66,0xd4,0xf5,0x3a,0xa7,
     0x73,0xa9,0xa8,0x86,0x62,0xc7,0x65,0xc8,0xc9,0xa1,0xf4,0xd1,
     0xe9,0x5a,0x92,0x85,0xa6,0xe7,0x93,0xe8,0xc1,0xc6,0x7a,0x64,
     0xe1,0x4a,0x6a,0xe6,0xb3,0xf1,0xd3,0xa5,0x8a,0xb2,0x9a,0xba,
     0x84,0xa4,0x63,0xe5,0xc5,0xf3,0xd2,0xc4,0x82,0xaa,0xda,0xe4,
     0xf2,0xca,0x83,0xa3,0xa2,0xc3,0xea,0xc2,0xe2,0xe3,0xff,0xff},
    {0,2,2,1,4,1,4,1,3,3,1,0,0,0,0,140,
     0x02,0x03,0x01,0x04,0x05,0x12,0x11,0x06,
     0x13,0x07,0x08,0x14,0x22,0x09,0x21,0x00,0x23,0x15,0x31,0x32,
     0x0a,0x16,0xf0,0x24,0x33,0x41,0x42,0x19,0x17,0x25,0x18,0x51,
     0x34,0x43,0x52,0x29,0x35,0x61,0x39,0x71,0x62,0x36,0x53,0x26,
     0x38,0x1a,0x37,0x81,0x27,0x91,0x79,0x55,0x45,0x28,0x72,0x59,
     0xa1,0xb1,0x44,0x69,0x54,0x58,0xd1,0xfa,0x57,0xe1,0xf1,0xb9,
     0x49,0x47,0x63,0x6a,0xf9,0x56,0x46,0xa8,0x2a,0x4a,0x78,0x99,
     0x3a,0x75,0x74,0x86,0x65,0xc1,0x76,0xb6,0x96,0xd6,0x89,0x85,
     0xc9,0xf5,0x95,0xb4,0xc7,0xf7,0x8a,0x97,0xb8,0x73,0xb7,0xd8,
     0xd9,0x87,0xa7,0x7a,0x48,0x82,0x84,0xea,0xf4,0xa6,0xc5,0x5a,
     0x94,0xa4,0xc6,0x92,0xc3,0x68,0xb5,0xc8,0xe4,0xe5,0xe6,0xe9,
     0xa2,0xa3,0xe3,0xc2,0x66,0x67,0x93,0xaa,0xd4,0xd5,0xe7,0xf8,
     0x88,0x9a,0xd7,0x77,0xc4,0x64,0xe2,0x98,0xa5,0xca,0xda,0xe8,
     0xf3,0xf6,0xa9,0xb2,0xb3,0xf2,0xd2,0x83,0xba,0xd3,0xff,0xff},
    {0,0,6,2,1,3,3,2,5,1,2,2,8,10,0,117,
     0x04,0x05,0x03,0x06,0x02,0x07,0x01,0x08,
     0x09,0x12,0x13,0x14,0x11,0x15,0x0a,0x16,0x17,0xf0,0x00,0x22,
     0x21,0x18,0x23,0x19,0x24,0x32,0x31,0x25,0x33,0x38,0x37,0x34,
     0x35,0x36,0x39,0x79,0x57,0x58,0x59,0x28,0x56,0x78,0x27,0x41,
     0x29,0x77,0x26,0x42,0x76,0x99,0x1a,0x55,0x98,0x97,0xf9,0x48,
     0x54,0x96,0x89,0x47,0xb7,0x49,0xfa,0x75,0x68,0xb6,0x67,0x69,
     0xb9,0xb8,0xd8,0x52,0xd7,0x88,0xb5,0x74,0x51,0x46,0xd9,0xf8,
     0x3a,0xd6,0x87,0x45,0x7a,0x95,0xd5,0xf6,0x86,0xb4,0xa9,0x94,
     0x53,0x2a,0xa8,0x43,0xf5,0xf7,0xd4,0x66,0xa7,0x5a,0x44,0x8a,
     0xc9,0xe8,0xc8,0xe7,0x9a,0x6a,0x73,0x4a,0x61,0xc7,0xf4,0xc6,
     0x65,0xe9,0x72,0xe6,0x71,0x91,0x93,0xa6,0xda,0x92,0x85,0x62,
     0xf3,0xc5,0xb2,0xa4,0x84,0xba,0x64,0xa5,0xb3,0xd2,0x81,0xe5,
     0xd3,0xaa,0xc4,0xca,0xf2,0xb1,0xe4,0xd1,0x83,0x63,0xea,0xc3,
     0xe2,0x82,0xf1,0xa3,0xc2,0xa1,0xc1,0xe3,0xa2,0xe1,0xff,0xff},
};

// Build a HuffTable from the CRW table layout: 16 counts per code
// length followed by the symbol list (JPEG-DHT canonical codes).
static void build_crw_hufftable(const uint8_t* t, size_t tlen,
                                HuffTable& h) {
    int total = 0;
    for (int i = 0; i < 16; ++i) total += t[i];
    if (total <= 0 || 16 + total > (int)tlen || total > 256) return;
    for (int i = 0; i < total; ++i) h.vals[i] = t[16 + i];
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
        int cnt = t[l - 1];
        h.valptr[l] = k;
        h.mincode[l] = code;
        code += cnt;
        k += cnt;
        h.maxcode[l] = cnt ? code - 1 : -1;
        code <<= 1;
    }
    h.maxcode[17] = 0x7FFFFFFF;
    build_hufflut(h);
    h.valid = true;
}

// Recursive CIFF heap walk (parse_ciff): directory offset in the last 4
// bytes of the heap; 10-byte records (type, len, heap-relative offset).
struct CrwInfo {
    int raw_w = 0, raw_h = 0;
    int table = 0;
    double cam_mul[4] = {0, 0, 0, 0};
    char make[64] = {0}, model[64] = {0};
    int wbi = 0;
};

static void crw_parse_heap(const Reader& r, size_t off, size_t length,
                           int depth, CrwInfo* info) {
    if (depth > 8 || length < 4 || off + length > r.len) return;
    size_t tboff = off + r.u32(off + length - 4);
    if (tboff + 2 > r.len) return;
    int nrecs = r.u16(tboff);
    if (nrecs > 127) return;
    for (int i = 0; i < nrecs; ++i) {
        size_t rec = tboff + 2 + (size_t)i * 10;
        if (rec + 10 > r.len) return;
        uint16_t type = r.u16(rec);
        uint32_t rlen = r.u32(rec + 2);
        size_t roff = off + r.u32(rec + 6);
        if ((((type >> 8) + 8) | 8) == 0x38)  // sub-heap
            crw_parse_heap(r, roff, rlen, depth + 1, info);
        if (roff + 8 > r.len) continue;
        if (type == 0x080a && roff + 128 <= r.len) {
            memcpy(info->make, r.buf + roff, 63);
            size_t mlen = strnlen(info->make, 63);
            memcpy(info->model, r.buf + roff + mlen + 1, 63);
        }
        if (type == 0x1031 && roff + 8 <= r.len) {
            info->raw_w = r.u16(roff + 2);
            info->raw_h = r.u16(roff + 4);
        }
        if (type == 0x1835) info->table = (int)r.u32(roff);
        if (type == 0x102a && roff + 16 <= r.len) {
            // record layout: u32, iso u16, skip, aperture, shutter,
            // skip, wbi (the (get2(),get2()) walk of parse_ciff)
            int wbi = r.u16(roff + 14);
            if (wbi < 0 || wbi > 17) wbi = 0;
            info->wbi = wbi;
        }
        if (type == 0x10a9 && roff + 10 <= r.len) {
            // D60/10D/300D class white balance table
            int wbi = info->wbi;
            if (rlen > 66) {
                const char* map = "0134567028";
                if (wbi >= 0 && wbi < 10) wbi = map[wbi] - '0';
            }
            size_t p = roff + 2 + (size_t)wbi * 8;
            if (p + 8 <= r.len) {
                for (int c = 0; c < 4; ++c)
                    info->cam_mul[c ^ (c >> 1)] = r.u16(p + c * 2);
            }
        }
    }
}

// In Canon compressed data 0xff is always followed by 0x00; a stray
// 0xff xx in the leading 0x4000 bytes means they are uncompressed
// low-order bits (canon_has_lowbits).
static int crw_has_lowbits(const uint8_t* buf, size_t len) {
    size_t n = len < 0x4000 ? len : 0x4000;
    int ret = 1;
    for (size_t i = 540; i + 1 < n; ++i) {
        if (buf[i] == 0xff) {
            if (buf[i + 1]) return 1;
            ret = 0;
        }
    }
    return ret;
}

static uint16_t* decode_crw(const uint8_t* buf, size_t len,
                            ArtRawMeta* meta) {
    Reader r{buf, len, buf[0] == 'I'};
    size_t hlen = r.u32(2);
    if (hlen >= len) return nullptr;
    CrwInfo info;
    crw_parse_heap(r, hlen, len - hlen, 0, &info);
    int W = info.raw_w, H = info.raw_h;
    if (W <= 0 || H <= 0 || (int64_t)W * H > (int64_t)1 << 28)
        return nullptr;
    if ((W & 7) || ((int64_t)W * 8) % 64) return nullptr;

    HuffTable huff[2];
    int tbl = info.table > 2 ? 2 : info.table;
    build_crw_hufftable(kCrwFirstTree[tbl], sizeof(kCrwFirstTree[tbl]),
                        huff[0]);
    build_crw_hufftable(kCrwSecondTree[tbl], sizeof(kCrwSecondTree[tbl]),
                        huff[1]);
    if (!huff[0].valid || !huff[1].valid) return nullptr;

    int lowbits = crw_has_lowbits(buf, len);
    size_t low_off = 26;
    size_t data_off = 540 + (lowbits ? (size_t)H * W / 4 : 0);
    if (data_off >= len) return nullptr;

    uint16_t* img = (uint16_t*)calloc((size_t)W * H, 2);
    if (!img) return nullptr;
    BitReader br(buf + data_off, buf + len);  // 0xff00-stuffed stream

    int carry = 0;
    int64_t pnum = 0;
    int base[2] = {0, 0};
    int diffbuf[64];
    for (int row = 0; row < H; row += 8) {
        uint16_t* pixel = img + (size_t)row * W;
        int64_t nblocks = (int64_t)(H - row < 8 ? H - row : 8) * W >> 6;
        for (int64_t block = 0; block < nblocks; ++block) {
            memset(diffbuf, 0, sizeof(diffbuf));
            for (int i = 0; i < 64; ++i) {
                int leaf = huff_decode_fast(br, huff[i > 0]);
                if (leaf < 0) { free(img); return nullptr; }
                if (leaf == 0 && i) break;       // EOB
                if (leaf == 0xff) continue;
                i += leaf >> 4;                  // zero run
                int blen = leaf & 15;
                if (blen == 0) continue;
                int diff = br.get(blen);
                if ((diff & (1 << (blen - 1))) == 0)
                    diff -= (1 << blen) - 1;
                if (i < 64) diffbuf[i] = diff;
            }
            diffbuf[0] += carry;
            carry = diffbuf[0];
            for (int i = 0; i < 64; ++i) {
                if (pnum++ % W == 0) base[0] = base[1] = 512;
                int v = base[i & 1] += diffbuf[i];
                if (v < 0) v = 0;
                if (v > 0xffff) v = 0xffff;
                pixel[(block << 6) + i] = (uint16_t)v;
            }
        }
        if (lowbits) {
            // merge the 2-bit planes stored at the file head
            size_t lp = low_off + (size_t)row * W / 4;
            uint16_t* prow = pixel;
            for (int64_t i = 0; i < (int64_t)W * 2; ++i) {
                if (lp >= len) break;
                int c = buf[lp++];
                for (int rsh = 0; rsh < 8; rsh += 2, ++prow) {
                    int val = (*prow << 2) + ((c >> rsh) & 3);
                    if (W == 2672 && val < 512) val += 2;
                    *prow = (uint16_t)(val > 0xffff ? 0xffff : val);
                }
            }
        }
    }

    memset(meta, 0, sizeof(*meta));
    meta->xtrans[0] = -1;
    meta->width = W;
    meta->height = H;
    // all CRW Bayer bodies are RGGB (dcraw filter word 0x94949494);
    // per-model margins/black come from camconst
    meta->cfa_pattern[0] = 0; meta->cfa_pattern[1] = 1;
    meta->cfa_pattern[2] = 1; meta->cfa_pattern[3] = 2;
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    meta->orientation = 1;
    meta->iso = 100.0;
    for (int i = 0; i < 4; ++i) {
        meta->black[i] = 0.0;
        meta->white[i] = lowbits ? 4095.0 : 1023.0;
    }
    if (info.cam_mul[0] > 0 && info.cam_mul[1] > 0 && info.cam_mul[2] > 0) {
        meta->as_shot_neutral[0] = info.cam_mul[1] / info.cam_mul[0];
        meta->as_shot_neutral[1] = 1.0;
        meta->as_shot_neutral[2] = info.cam_mul[1] / info.cam_mul[2];
    }
    if (info.make[0]) snprintf(meta->make, 64, "%s", info.make);
    if (info.model[0]) snprintf(meta->model, 64, "%s", info.model);
    return img;
}

// ---------------------------------------------------------------------------
// Minolta MRW (DiMAGE 5/7/A1/A2/A200, Dynax/Maxxum 5D/7D; reference decode
// boundary: rtengine/dcraw.cc parse_minolta :7304 + packed_load_raw).
// Fresh implementation from the publicly documented container: big-endian
// "\0MRM"<len> block chain holding \0PRD (sensor dims, bit depth, storage
// method), \0WBG (per-channel WB gains R,G1,G2,B), \0TTW (embedded TIFF
// with make/model/EXIF); the CFA payload follows the MRM block, 12-bit
// big-endian MSB-packed (storage 0x59) or 16-bit unpacked (0x52).
// ---------------------------------------------------------------------------
static uint16_t* decode_mrw(const uint8_t* buf, size_t len,
                            ArtRawMeta* meta) {
    Reader r{buf, len, false};  // big-endian throughout
    size_t data_off = 8 + (size_t)r.u32(4);
    if (data_off >= len) return nullptr;

    int rh = 0, rw = 0, data_bits = 16, storage = 0x52;
    double wb[4] = {0, 0, 0, 0};
    char make[64] = {0}, model[64] = {0};
    int orient = 1;
    double iso = 0.0;

    size_t pos = 8;
    while (pos + 8 <= data_off) {
        uint32_t tag = r.u32(pos);
        uint32_t blen = r.u32(pos + 4);
        size_t p = pos + 8;
        if (p + blen > data_off) break;
        if (tag == 0x00505244 && blen >= 19) {  // \0PRD
            // version[8], ccdH(2), ccdW(2), imgH(2), imgW(2),
            // dataSize bits(1), pixelSize bits(1), storageMethod(1)
            rh = r.u16(p + 8);
            rw = r.u16(p + 10);
            data_bits = buf[p + 16];
            storage = buf[p + 18];
        } else if (tag == 0x00574247 && blen >= 12) {  // \0WBG
            // 4 scale nibbles, then u16 gains in R,G1,G2,B order
            for (int c = 0; c < 4; ++c) wb[c] = r.u16(p + 4 + 2 * c);
        } else if (tag == 0x00545457 && blen >= 8) {  // \0TTW: TIFF
            // embedded TIFF; offsets are relative to its own header
            Reader tr{buf + p, len - p, buf[p] == 'I'};
            if ((buf[p] == 'I' || buf[p] == 'M') && tr.u16(2) == 42) {
                std::vector<uint32_t> queue{tr.u32(4)};
                std::vector<uint32_t> seen;
                bool first = true;
                while (!queue.empty()) {
                    uint32_t off = queue.back();
                    queue.pop_back();
                    if (!off || off + 2 > tr.len) continue;
                    bool dup = false;
                    for (uint32_t s : seen) if (s == off) { dup = true; break; }
                    if (dup) continue;
                    seen.push_back(off);
                    IFD ifd;
                    std::vector<uint32_t> subs;
                    parse_ifd(tr, off, ifd, subs, 0);
                    for (uint32_t s : subs) queue.push_back(s);
                    if (first) {
                        const TagValue* mk = ifd.find(271);
                        if (mk) strncpy(make, mk->str.c_str(), 63);
                        const TagValue* md = ifd.find(272);
                        if (md) strncpy(model, md->str.c_str(), 63);
                        orient = (int)ifd.num(274, 1);
                        first = false;
                    }
                    const TagValue* is = ifd.find(34855);
                    if (is && !is->nums.empty() && iso <= 0)
                        iso = is->nums[0];
                }
            }
        }
        pos = p + blen;
    }
    if (rh <= 0 || rw <= 0 || rh > 65535 || rw > 65535) return nullptr;

    size_t npix = (size_t)rh * rw;
    uint16_t* out = (uint16_t*)calloc(npix, sizeof(uint16_t));
    if (!out) return nullptr;
    size_t avail = len - data_off;
    if (storage == 0x59 && data_bits == 12) {  // 12-bit MSB packed
        if (avail * 8 < npix * 12) { free(out); return nullptr; }
        unpack_bits(buf + data_off, avail, out, npix, 12, true);
    } else {  // 16-bit big-endian words holding 12-bit samples
        if (avail < npix * 2) { free(out); return nullptr; }
        for (size_t i = 0; i < npix; ++i)
            out[i] = (uint16_t)((buf[data_off + 2 * i] << 8)
                                | buf[data_off + 2 * i + 1]);
    }

    memset(meta, 0, sizeof(*meta));
    meta->width = rw;
    meta->height = rh;
    meta->orientation = orient;
    meta->xtrans[0] = -1;
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    // RGGB for all bodies except the DiMAGE A200 (GBRG; dcraw.cc
    // filters=0x49494949 at :10170)
    static const int rggb[4] = {0, 1, 1, 2};
    static const int gbrg[4] = {1, 2, 0, 1};
    bool a200 = strstr(model, "A200") != nullptr;
    for (int i = 0; i < 4; ++i)
        meta->cfa_pattern[i] = a200 ? gbrg[i] : rggb[i];
    // white level: 12-bit range; per-model ceilings from the camconst/
    // adobe tables land via the Python-side camconst override
    double wmax = (1 << 12) - 1;
    for (int i = 0; i < 4; ++i) { meta->white[i] = wmax; meta->black[i] = 0; }
    meta->iso = iso > 0 ? iso : 100.0;
    if (wb[0] > 0 && wb[1] > 0 && wb[3] > 0) {
        meta->as_shot_neutral[0] = wb[1] / wb[0];
        meta->as_shot_neutral[1] = 1.0;
        meta->as_shot_neutral[2] = wb[1] / wb[3];
    }
    strncpy(meta->make, make[0] ? make : "Minolta", 63);
    if (model[0]) strncpy(meta->model, model, 63);
    return out;
}

uint16_t* artraw_decode(const uint8_t* buf, size_t len, ArtRawMeta* meta);

// ---------------------------------------------------------------------------
// Sigma X3F (Foveon). Reference decode boundary: rtengine/dcraw.cc
// parse_foveon (dcraw.cc:7899), foveon_dp_load_raw (:3867, the "TRUE"
// engine of Merrill/DP/SD1 bodies: three planes of ljpeg-style
// differential huffman with dual row-parity predictors),
// foveon_sd_load_raw (:3820, SD9-SD14: shared-tree huffman over a
// 1024-entry diff table, or 10-bit packed words) and foveon_decoder
// (:3749). ART treats Foveon frames as non-mosaic 3-color images
// (filters = 0, dcraw.cc:9917-9921; ST_FOVEON, rawimage.cc:115) and
// never runs dcraw's foveon_interpolate() color pipeline — the camera
// matrix comes from camconst and WB from the matrix-derived neutral.
// Honest provenance, as with CRX: the bitstream model follows dcraw
// (the only public spec); the code is a fresh structured
// implementation with bounds guards dcraw lacks. Scope: raw section
// formats 30 (TRUE), 6 (huffman tree), 5 (packed), and 35 (Quattro
// mixed-resolution planes — beyond-reference: dcraw has no Quattro
// support at all; the layout follows the public x3f_tools x3f_io.c).
// ---------------------------------------------------------------------------

namespace {

// MSB-first bit reader over a byte range (TRUE-engine planes; the
// stream is not ff-stuffed)
struct X3FBits {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t acc = 0;
    int n = 0;
    X3FBits(const uint8_t* p_, const uint8_t* e) : p(p_), end(e) {}
    void fill(int nb) {
        while (n < nb) {
            acc = (acc << 8) | (p < end ? *p++ : 0);
            n += 8;
        }
    }
    uint32_t get(int nb) {
        if (!nb) return 0;
        fill(nb);
        n -= nb;
        return (uint32_t)((acc >> n) & ((1ull << nb) - 1));
    }
    uint32_t peek8() {
        fill(8);
        return (uint32_t)((acc >> (n - 8)) & 0xff);
    }
    void drop(int nb) { n -= nb; }
};

static inline int x3f_extend(int v, int t) {
    // ITU-T81 sign extension (same as ljpeg_diff)
    if (t && v < (1 << (t - 1))) v -= (1 << t) - 1;
    return v;
}

// dcraw's 32-bit big-endian group walker (foveon_sd_load_raw bit state:
// bit counts down within each 4-byte refill group)
struct X3FBits32 {
    const uint8_t* p;
    const uint8_t* end;
    uint32_t bitbuf = 0;
    int bit = -1;  // dcraw init: the row-0 quirk check must not fire
    X3FBits32(const uint8_t* p_, const uint8_t* e) : p(p_), end(e) {}
    int next() {
        bit = (bit - 1) & 31;
        if (bit == 31) {
            bitbuf = 0;
            for (int i = 0; i < 4; ++i)
                bitbuf = (bitbuf << 8) | (p < end ? *p++ : 0);
        }
        return (bitbuf >> bit) & 1;
    }
};

struct X3FNode {
    int leaf = -1;
    int br[2] = {-1, -1};
};

// foveon_decoder (dcraw.cc:3749): binary tree from a table of
// (len<<27 | path) code words
static void x3f_build_tree(std::vector<X3FNode>& nodes,
                           const uint32_t* codes, int size, uint32_t code) {
    int cur = (int)nodes.size();
    nodes.push_back(X3FNode());
    if (nodes.size() > 4096) return;  // bounded (dcraw caps at 2048)
    if (code) {
        for (int i = 0; i < size; ++i)
            if (codes[i] == code) {
                nodes[cur].leaf = i;
                return;
            }
    }
    int len = (int)(code >> 27);
    if (len > 26) return;
    code = (uint32_t)(len + 1) << 27 | (code & 0x3ffffff) << 1;
    nodes[cur].br[0] = (int)nodes.size();
    x3f_build_tree(nodes, codes, size, code);
    if (nodes.size() > 4096) return;
    nodes[cur].br[1] = (int)nodes.size();
    x3f_build_tree(nodes, codes, size, code + 1);
}

// UTF-16LE -> ascii-ish copy (PROP values)
static void x3f_gets(const uint8_t* buf, size_t len, size_t off, char* out,
                     size_t outlen) {
    size_t i = 0;
    while (i + 1 < outlen && off + 1 < len) {
        uint16_t ch = (uint16_t)(buf[off] | (buf[off + 1] << 8));
        off += 2;
        if (!ch) break;
        out[i++] = (char)(ch < 128 ? ch : '?');
    }
    out[i] = 0;
}

// TRUE-engine plane (foveon_dp_load_raw inner loop): 8-bit-prefix
// huffman of diff categories, dual column predictors, row-parity
// vertical predictors for the first two columns
static void x3f_true_plane(const uint8_t* data, const uint8_t* end,
                           int width, int height,
                           const uint8_t* tbl_len, const uint8_t* tbl_leaf,
                           uint16_t* out, size_t stride) {
    X3FBits br(data, end);
    uint16_t vpred[2][2] = {{512, 512}, {512, 512}};
    uint16_t hpred[2] = {0, 0};
    for (int row = 0; row < height; ++row) {
        for (int col = 0; col < width; ++col) {
            uint32_t idx = br.peek8();
            int clen = tbl_len[idx];
            int t = tbl_leaf[idx];
            if (!clen) return;  // invalid prefix
            br.drop(clen);
            int diff = x3f_extend((int)br.get(t), t);
            if (col < 2)
                hpred[col] = vpred[row & 1][col] =
                    (uint16_t)(vpred[row & 1][col] + diff);
            else
                hpred[col & 1] = (uint16_t)(hpred[col & 1] + diff);
            out[(size_t)row * stride + col] = hpred[col & 1];
        }
    }
}

}  // namespace

static uint16_t* decode_x3f(const uint8_t* buf, size_t len,
                            ArtRawMeta* meta) {
    if (len < 44 || memcmp(buf, "FOVb", 4) != 0) return nullptr;
    auto u32 = [&](size_t off) -> uint32_t {
        if (off + 4 > len) return 0;
        return (uint32_t)buf[off] | ((uint32_t)buf[off + 1] << 8)
             | ((uint32_t)buf[off + 2] << 16)
             | ((uint32_t)buf[off + 3] << 24);
    };
    uint32_t rotation = u32(36);  // degrees (parse_foveon flip)
    size_t dir = u32(len - 4);
    if (dir + 12 > len || memcmp(buf + dir, "SECd", 4) != 0) return nullptr;
    uint32_t entries = u32(dir + 8);
    if (entries > 64) entries = 64;

    // pick the raw image section: prefer type 3 (raw), largest dims
    size_t raw_off = 0, raw_len = 0;
    int fmt = -1, width = 0, height = 0, stride = 0;
    char make[64] = "SIGMA", model[64] = "", wbdesc[64] = "";
    double iso = 100.0;
    for (uint32_t e = 0; e < entries; ++e) {
        size_t ent = dir + 12 + (size_t)e * 12;
        if (ent + 12 > len) break;
        size_t off = u32(ent);
        size_t sz = u32(ent + 4);
        if (off + 28 > len || off + sz > len) continue;
        if (memcmp(buf + ent + 8, "IMA", 3) == 0) {
            uint32_t type = u32(off + 8);
            int f = (int)u32(off + 12);
            int w = (int)u32(off + 16);
            int h = (int)u32(off + 20);
            bool raw_like = (f == 30 || f == 6 || f == 5 || f == 35);
            if ((type == 3 || raw_like) && w > width && h > height) {
                width = w;
                height = h;
                stride = (int)u32(off + 24);
                fmt = f;
                raw_off = off + 28;
                raw_len = sz > 28 ? sz - 28 : 0;
            }
        } else if (memcmp(buf + ent + 8, "PROP", 4) == 0) {
            // property list: UTF-16 name/value offset pairs (u16 units
            // from the char data start at off+24+pent*8)
            uint32_t pent = u32(off + 8);
            if (pent > 256) pent = 256;
            size_t tbl = off + 24;
            size_t chars = tbl + (size_t)pent * 8;
            for (uint32_t i = 0; i < pent; ++i) {
                size_t noff = chars + (size_t)u32(tbl + 8 * i) * 2;
                size_t voff = chars + (size_t)u32(tbl + 8 * i + 4) * 2;
                char name[64], value[64];
                x3f_gets(buf, len, noff, name, sizeof(name));
                x3f_gets(buf, len, voff, value, sizeof(value));
                if (!strcmp(name, "ISO")) iso = atof(value);
                else if (!strcmp(name, "CAMMANUF"))
                    strncpy(make, value, 63);
                else if (!strcmp(name, "CAMMODEL"))
                    strncpy(model, value, 63);
                else if (!strcmp(name, "WB_DESC"))
                    strncpy(wbdesc, value, 63);
            }
        }
    }
    (void)wbdesc;
    if (fmt < 0 || width <= 0 || height <= 0 || width > 65535
        || height > 65535)
        return nullptr;
    const uint8_t* data = buf + raw_off;
    const uint8_t* dend = data + raw_len;

    size_t npix = (size_t)width * height;
    uint16_t* out = (uint16_t*)calloc(npix * 3, sizeof(uint16_t));
    if (!out) return nullptr;
    bool ok = false;

    if (fmt == 35) {
        // Quattro (sd Quattro / dp Quattro, beyond-reference: the
        // reference needs LibRaw for these). Layout per the public
        // x3f_tools (x3f_io.c) de-facto spec: a 16-byte prefix of
        // per-plane dims (3 x {u16 rows, u16 cols} + u32 layout word),
        // then the same TRUE-engine structure as format 30 shifted by
        // 16. The top (blue) plane is full resolution; the other two
        // are quarter resolution and are 2x2-replicated here into the
        // (3, H, W) output the Foveon pipeline expects.
        if (raw_len >= 16 + 48) {
            int prow[3], pcol[3];
            bool sane = true;
            for (int c = 0; c < 3; ++c) {
                prow[c] = data[4 * c] | (data[4 * c + 1] << 8);
                pcol[c] = data[4 * c + 2] | (data[4 * c + 3] << 8);
                if (prow[c] <= 0 || pcol[c] <= 0 || prow[c] > height ||
                    pcol[c] > width)
                    sane = false;
            }
            const uint8_t* th = data + 16;  // TRUE header
            uint8_t tbl_len[256] = {0};
            uint8_t tbl_leaf[256] = {0};
            for (int i = 0; i < 13; ++i) {
                int clen = th[8 + 2 * i];
                int code = th[8 + 2 * i + 1];
                if (clen > 8) continue;
                for (int j = 0; j < (256 >> clen); ++j) {
                    int k = code + j;
                    if (k < 256) {
                        tbl_len[k] = (uint8_t)clen;
                        tbl_leaf[k] = (uint8_t)i;
                    }
                }
            }
            size_t roff[4];
            roff[0] = 16 + 48;
            for (int c = 0; c < 3 && sane; ++c) {
                uint32_t plen = (uint32_t)(th[36 + 4 * c]
                    | (th[36 + 4 * c + 1] << 8)
                    | (th[36 + 4 * c + 2] << 16)
                    | (th[36 + 4 * c + 3] << 24));
                roff[c + 1] = (roff[c] + plen + 15) & ~(size_t)15;
                if (roff[c + 1] > raw_len + 16) sane = false;
            }
            if (sane) {
                std::vector<uint16_t> tmp;
                ok = true;
                for (int c = 0; c < 3; ++c) {
                    const uint8_t* ps = data + roff[c];
                    const uint8_t* pe =
                        roff[c + 1] <= raw_len ? data + roff[c + 1] : dend;
                    uint16_t* dst = out + (size_t)c * npix;
                    if (prow[c] == height && pcol[c] == width) {
                        x3f_true_plane(ps, pe, width, height, tbl_len,
                                       tbl_leaf, dst, width);
                    } else if (prow[c] * 2 >= height &&
                               pcol[c] * 2 >= width) {
                        tmp.assign((size_t)prow[c] * pcol[c], 0);
                        x3f_true_plane(ps, pe, pcol[c], prow[c], tbl_len,
                                       tbl_leaf, tmp.data(), pcol[c]);
                        for (int y = 0; y < height; ++y) {
                            const uint16_t* sr =
                                tmp.data() +
                                (size_t)std::min(y / 2, prow[c] - 1) *
                                    pcol[c];
                            uint16_t* dr = dst + (size_t)y * width;
                            for (int x = 0; x < width; ++x)
                                dr[x] = sr[std::min(x / 2, pcol[c] - 1)];
                        }
                    } else {
                        ok = false;
                    }
                }
            }
        }
    } else if (fmt == 30) {
        // TRUE engine header: 8 bytes skipped, 13 (clen, code) huffman
        // pairs, 2 pad bytes, three u32 plane sizes; plane c data starts
        // 16-byte aligned from the section data origin (roff[0] = 48)
        if (raw_len >= 48) {
            uint8_t tbl_len[256] = {0};
            uint8_t tbl_leaf[256] = {0};
            for (int i = 0; i < 13; ++i) {
                int clen = data[8 + 2 * i];
                int code = data[8 + 2 * i + 1];
                if (clen > 8) continue;
                for (int j = 0; j < (256 >> clen); ++j) {
                    int k = code + j;
                    if (k < 256) {
                        tbl_len[k] = (uint8_t)clen;
                        tbl_leaf[k] = (uint8_t)i;
                    }
                }
            }
            size_t roff[4];
            roff[0] = 48;
            bool sane = true;
            for (int c = 0; c < 3; ++c) {
                uint32_t plen = (uint32_t)(data[36 + 4 * c]
                    | (data[36 + 4 * c + 1] << 8)
                    | (data[36 + 4 * c + 2] << 16)
                    | (data[36 + 4 * c + 3] << 24));
                roff[c + 1] = (roff[c] + plen + 15) & ~(size_t)15;
                if (roff[c + 1] > raw_len + 16) sane = false;
            }
            if (sane) {
                for (int c = 0; c < 3; ++c) {
                    const uint8_t* ps = data + roff[c];
                    const uint8_t* pe =
                        roff[c + 1] <= raw_len ? data + roff[c + 1] : dend;
                    x3f_true_plane(ps, pe, width, height, tbl_len,
                                   tbl_leaf, out + (size_t)c * npix,
                                   width);
                }
                ok = true;
            }
        }
    } else if (fmt == 5) {
        // 10-bit packed: 1024-entry i16 diff table, then one u32 per
        // pixel holding three indices (c-th 10 bits -> plane 2-c)
        if (raw_len >= 2048 + npix * 4) {
            int16_t difft[1024];
            for (int i = 0; i < 1024; ++i)
                difft[i] = (int16_t)(data[2 * i] | (data[2 * i + 1] << 8));
            const uint8_t* q = data + 2048;
            for (int row = 0; row < height; ++row) {
                int pred[3] = {0, 0, 0};
                for (int col = 0; col < width; ++col, q += 4) {
                    uint32_t v = (uint32_t)q[0] | ((uint32_t)q[1] << 8)
                               | ((uint32_t)q[2] << 16)
                               | ((uint32_t)q[3] << 24);
                    for (int c = 0; c < 3; ++c)
                        pred[2 - c] += difft[(v >> (c * 10)) & 0x3ff];
                    for (int c = 0; c < 3; ++c)
                        out[(size_t)c * npix + (size_t)row * width + col] =
                            (uint16_t)(pred[c] < 0 ? 0
                                       : (pred[c] > 65535 ? 65535
                                                          : pred[c]));
                }
            }
            ok = true;
        }
    } else if (fmt == 6) {
        // huffman tree over the diff table: 1024 i16 diffs, 1024 u32
        // code words, then the row-aligned bitstream
        if (raw_len >= 2048 + 4096) {
            int16_t difft[1024];
            for (int i = 0; i < 1024; ++i)
                difft[i] = (int16_t)(data[2 * i] | (data[2 * i + 1] << 8));
            std::vector<uint32_t> codes(1024);
            for (int i = 0; i < 1024; ++i) {
                size_t o = 2048 + 4 * (size_t)i;
                codes[i] = (uint32_t)data[o] | ((uint32_t)data[o + 1] << 8)
                         | ((uint32_t)data[o + 2] << 16)
                         | ((uint32_t)data[o + 3] << 24);
            }
            std::vector<X3FNode> nodes;
            nodes.reserve(2048);
            x3f_build_tree(nodes, codes.data(), 1024, 0);
            // model quirk (dcraw: atoi(model+2) < 14): SD9/SD10 streams
            // carry an extra u32 at rows that start bit-aligned
            int modelnum = 99;
            if (model[0] == 'S' && model[1] == 'D') modelnum = atoi(model + 2);
            X3FBits32 br(data + 2048 + 4096, dend);
            ok = true;
            for (int row = 0; row < height && ok; ++row) {
                int pred[3] = {0, 0, 0};
                if (br.bit == 0 && modelnum < 14) {
                    for (int i = 0; i < 4; ++i)
                        if (br.p < br.end) ++br.p;
                }
                br.bit = 0;
                for (int col = 0; col < width; ++col) {
                    for (int c = 0; c < 3; ++c) {
                        int cur = 0;
                        while (cur >= 0 && nodes[cur].br[0] >= 0)
                            cur = nodes[cur].br[br.next()];
                        if (cur < 0 || nodes[cur].leaf < 0) {
                            ok = false;
                            break;
                        }
                        pred[c] += difft[nodes[cur].leaf];
                        out[(size_t)c * npix + (size_t)row * width + col] =
                            (uint16_t)(pred[c] < 0 ? 0
                                       : (pred[c] > 65535 ? 65535
                                                          : pred[c]));
                    }
                    if (!ok) break;
                }
            }
        }
    }
    if (!ok) {
        free(out);
        return nullptr;
    }
    (void)stride;

    memset(meta, 0, sizeof(*meta));
    meta->channels = 3;
    meta->xtrans[0] = -1;
    meta->width = width;
    meta->height = height;
    for (int i = 0; i < 4; ++i) meta->cfa_pattern[i] = -1;
    for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    for (int i = 0; i < 4; ++i) meta->black[i] = 0.0;
    // container carries no levels; camconst per-model values override
    for (int i = 0; i < 4; ++i) meta->white[i] = 16383.0;
    meta->iso = iso;
    int o = 1;
    switch (rotation % 360) {
        case 90: o = 6; break;
        case 180: o = 3; break;
        case 270: o = 8; break;
    }
    meta->orientation = o;
    strncpy(meta->make, make, 63);
    strncpy(meta->model, model, 63);
    return out;
}

uint16_t* artraw_decode_dng(const uint8_t* buf, size_t len,
                            ArtRawMeta* meta) {
    if (len < 8) return nullptr;
    if (memcmp(buf, "FOVb", 4) == 0)
        return decode_x3f(buf, len, meta);
    if (len > 8 && buf[0] == 0 && memcmp(buf + 1, "MRM", 3) == 0)
        return decode_mrw(buf, len, meta);
    if (len > 600 && (buf[0] == 'I' || buf[0] == 'M') && buf[0] == buf[1]
            && memcmp(buf + 6, "HEAPCCDR", 8) == 0)
        return decode_crw(buf, len, meta);
    // Phase One IIQ: "IIII" magic within the first 32 bytes
    for (size_t b = 0; b + 12 <= len && b + 4 <= 32; ++b) {
        if (memcmp(buf + b, "IIII", 4) == 0)
            return decode_iiq(buf, len, meta, b);
    }
    if (len > 16 && memcmp(buf, "FUJIFILMCCD-RAW", 15) == 0)
        return decode_raf(buf, len, meta);
    if (len > 740 && memcmp(buf, "qktn", 4) == 0)
        return decode_qktn(buf, len, meta);
    if (len > 740 && memcmp(buf, "qktk", 4) == 0)
        return decode_qtk100(buf, len, meta);
    if (len > 3700 && memcmp(buf, "PXN\0", 4) == 0)
        return decode_pxn(buf, len, meta);
    if (len > 24 && memcmp(buf + 4, "ftyp", 4) == 0
            && (memcmp(buf + 8, "crx ", 4) == 0
                || memcmp(buf + 8, "crx\0", 4) == 0))
        return decode_cr3(buf, len, meta);
    Reader r{buf, len, true};
    if (buf[0] == 'I' && buf[1] == 'I')
        r.little = true;
    else if (buf[0] == 'M' && buf[1] == 'M')
        r.little = false;
    else
        return nullptr;
    uint16_t magic = r.u16(2);
    // 85 = Panasonic RW2; 0x4F52/0x5352 ("RO"/"RS") = Olympus ORF
    if (magic != 42 && magic != 85 && magic != 0x4F52 && magic != 0x5352)
        return nullptr;

    // walk all IFDs (main chain + SubIFDs)
    std::vector<IFD> ifds;
    std::vector<uint32_t> queue{r.u32(4)};
    std::vector<uint32_t> seen;
    while (!queue.empty()) {
        uint32_t off = queue.back();
        queue.pop_back();
        if (!off || off + 2 > r.len) continue;
        bool dup = false;
        for (uint32_t s : seen) if (s == off) { dup = true; break; }
        if (dup) continue;
        seen.push_back(off);
        IFD ifd;
        std::vector<uint32_t> subs;
        parse_ifd(r, off, ifd, subs, 0);
        // next IFD in chain
        uint16_t n = r.u16(off);
        uint32_t next = r.u32(off + 2 + (size_t)n * 12);
        if (next) queue.push_back(next);
        for (uint32_t s : subs) queue.push_back(s);
        ifds.push_back(std::move(ifd));
    }
    if (ifds.empty()) return nullptr;

    // Panasonic RW2: TIFF magic 85
    if (magic == 85)
        return decode_rw2(r, ifds, meta);

    // Olympus ORF: TIFF magic "RO"/"RS"
    if (magic == 0x4F52 || magic == 0x5352)
        return decode_orf(r, ifds, meta);

    // Canon CR2: TIFF with "CR" magic at offset 8
    if (len > 10 && buf[8] == 'C' && buf[9] == 'R')
        return decode_cr2(r, ifds, meta);

    // Nikon NEF: TIFF with a compression-34713 raw IFD
    for (auto& ifd : ifds) {
        if ((int)ifd.num(259, 0) == 34713)
            return decode_nef(r, ifds, meta);
    }

    // Pentax PEF: compression-65535 raw IFD
    for (auto& ifd : ifds) {
        if ((int)ifd.num(259, 0) == 65535)
            return decode_pef(r, ifds, meta);
    }

    // Samsung SRW: compression-32770/32772/32773 raw IFD
    for (auto& ifd : ifds) {
        int comp = (int)ifd.num(259, 0);
        if (comp == 32770 || comp == 32772 || comp == 32773)
            return decode_srw(r, ifds, &ifd, meta);
    }

    // Kodak DCR/KDC: compression-65000 raw IFD. DCR files also carry
    // 65000-compressed RGB (phint 2) / YCbCr (phint 6) preview IFDs, so
    // route only phint 32803 (CFA) here, preferring the largest area —
    // the reference's phint switch (dcraw.cc:7250-7256).
    {
        const IFD* dcr = nullptr;
        size_t best = 0;
        for (auto& ifd : ifds) {
            if ((int)ifd.num(259, 0) != 65000) continue;
            if ((int)ifd.num(262, 0) != 32803) continue;
            size_t area = (size_t)ifd.num(256, 0) * (size_t)ifd.num(257, 0);
            if (area > best) { dcr = &ifd; best = area; }
        }
        if (dcr) return decode_dcr(r, ifds, dcr, meta);
    }

    // Hasselblad 3FR: compression-7 CFA stream with the ph1 bit order
    // (FFF exports are plain TIFF and take the generic path below)
    {
        const TagValue* mk0 = ifds[0].find(271);
        if (mk0 && mk0->str.compare(0, 10, "Hasselblad") == 0
                && !ifds[0].find(50706)) {
            for (auto& ifd : ifds) {
                if ((int)ifd.num(259, 0) == 7)
                    return decode_3fr(r, ifds, &ifd, meta);
            }
        }
    }

    // Sony ARW: compression-32767 raw IFD (ARW2 cRAW), or an
    // uncompressed Sony TIFF that is not a DNG (no DNGVersion tag)
    for (auto& ifd : ifds) {
        if ((int)ifd.num(259, 0) == 32767)
            return decode_arw(r, ifds, &ifd, meta);
    }
    {
        const TagValue* mk0 = ifds[0].find(271);
        bool is_sony = mk0 && mk0->str.compare(0, 4, "SONY") == 0;
        if (is_sony && !ifds[0].find(50706)) {
            const IFD* raw = nullptr;
            size_t best = 0;
            for (auto& ifd : ifds) {
                size_t area = (size_t)ifd.num(256, 0)
                            * (size_t)ifd.num(257, 0);
                if (ifd.num(262, 0) == 32803 && area > best) {
                    raw = &ifd;
                    best = area;
                }
            }
            if (raw) return decode_arw(r, ifds, raw, meta);
        }
    }

    // Kodak DC40/DC50 KDC: TIFF wrapper, RADC stream at a fixed offset
    {
        const TagValue* mk0 = ifds[0].find(271);
        const TagValue* md0 = ifds[0].find(272);
        if (mk0 && md0 && strncasecmp(mk0->str.c_str(), "KODAK", 5) == 0) {
            const std::string& m = md0->str;
            bool dc50 = m.find("DC50") != std::string::npos;
            // the DC40 Model tag is the bare string "40" (possibly
            // NUL-padded); accept that or an explicit DC40
            bool dc40 = m.compare(0, 2, "40") == 0 ||
                        m.find("DC40") != std::string::npos;
            if (dc40 || dc50)
                return decode_kdc_radc(r, ifds, dc50, meta);
            if (m.find("DC120") != std::string::npos &&
                (int)ifds[0].num(259, 1) != 7)
                return decode_kdc_dc120(r, ifds, meta);
        }
    }

    // pick the raw IFD: prefer PhotometricInterpretation 32803 (CFA) or
    // 34892 (LinearRaw); fall back to largest area
    const IFD* raw = nullptr;
    const IFD* ifd0 = &ifds[0];
    size_t best_area = 0;
    for (auto& ifd : ifds) {
        double phot = ifd.num(262, 0);
        size_t area = (size_t)ifd.num(256, 0) * (size_t)ifd.num(257, 0);
        if (phot == 32803 || phot == 34892) {
            if (area > best_area || !raw ||
                ifd.num(262, 0) == 32803) {
                raw = &ifd;
                best_area = area;
            }
        }
    }
    if (!raw) {
        for (auto& ifd : ifds) {
            size_t area = (size_t)ifd.num(256, 0) * (size_t)ifd.num(257, 0);
            if (area > best_area) { raw = &ifd; best_area = area; }
        }
    }
    if (!raw) return nullptr;

    int width = (int)raw->num(256, 0);
    int height = (int)raw->num(257, 0);
    int bps = (int)raw->num(258, 16);
    int spp = (int)raw->num(277, 1);
    int compression = (int)raw->num(259, 1);
    if (width <= 0 || height <= 0 || width > 65535 || height > 65535)
        return nullptr;

    uint16_t* out = (uint16_t*)calloc((size_t)width * height * spp,
                                      sizeof(uint16_t));
    if (!out) return nullptr;
    if (!decode_strips_tiles(r, *raw, width, height, bps, spp, compression,
                             out)) {
        free(out);
        return nullptr;
    }

    // ---- metadata ----
    memset(meta, 0, sizeof(*meta));
    meta->xtrans[0] = -1;
    meta->width = width;
    meta->height = height;
    meta->orientation = (int)ifd0->num(274, 1);
    for (int i = 0; i < 4; ++i) meta->cfa_pattern[i] = -1;
    const TagValue* cfa = raw->find(33422);
    if (cfa && cfa->nums.size() >= 4) {
        for (int i = 0; i < 4; ++i)
            meta->cfa_pattern[i] = (int)cfa->nums[i];
    }
    // black/white levels (possibly per repeat-dim); average to per-c4
    const TagValue* bl = raw->find(50714);
    double black = 0;
    for (int i = 0; i < 4; ++i) {
        meta->black[i] = bl && !bl->nums.empty()
            ? bl->nums[std::min((size_t)i, bl->nums.size() - 1)]
            : 0.0;
    }
    (void)black;
    const TagValue* wl = raw->find(50717);
    double wmax = (1 << std::min(bps * spp == 0 ? 16 : bps, 16)) - 1;
    for (int i = 0; i < 4; ++i) {
        meta->white[i] = wl && !wl->nums.empty()
            ? wl->nums[std::min((size_t)i, wl->nums.size() - 1)]
            : wmax;
    }
    // search tags across IFD0 (DNG puts color tags there)
    auto find_any = [&](uint16_t tag) -> const TagValue* {
        for (auto& ifd : ifds) {
            const TagValue* v = ifd.find(tag);
            if (v) return v;
        }
        return nullptr;
    };
    const TagValue* asn = find_any(50728);
    if (asn && asn->nums.size() >= 3)
        for (int i = 0; i < 3; ++i) meta->as_shot_neutral[i] = asn->nums[i];
    const TagValue* cm1 = find_any(50721);
    if (cm1 && cm1->nums.size() >= 9) {
        for (int i = 0; i < 9; ++i) meta->color_matrix1[i] = cm1->nums[i];
        meta->has_cm1 = 1;
    }
    const TagValue* cm2 = find_any(50722);
    if (cm2 && cm2->nums.size() >= 9) {
        for (int i = 0; i < 9; ++i) meta->color_matrix2[i] = cm2->nums[i];
        meta->has_cm2 = 1;
    }
    meta->illuminant1 = (int)(find_any(50778) ? find_any(50778)->nums[0] : 0);
    meta->illuminant2 = (int)(find_any(50779) ? find_any(50779)->nums[0] : 0);
    const TagValue* be = find_any(50730);
    meta->baseline_exposure = be && !be->nums.empty() ? be->nums[0] : 0.0;
    const TagValue* iso = find_any(34855);
    meta->iso = iso && !iso->nums.empty() ? iso->nums[0] : 100.0;
    const TagValue* aa = raw->find(50829);
    if (aa && aa->nums.size() >= 4)
        for (int i = 0; i < 4; ++i) meta->active_area[i] = (int)aa->nums[i];
    else
        for (int i = 0; i < 4; ++i) meta->active_area[i] = -1;
    const TagValue* co = raw->find(50719);
    const TagValue* csz = raw->find(50720);
    if (co && csz && co->nums.size() >= 2 && csz->nums.size() >= 2) {
        meta->crop[0] = (int)co->nums[0];
        meta->crop[1] = (int)co->nums[1];
        meta->crop[2] = (int)csz->nums[0];
        meta->crop[3] = (int)csz->nums[1];
    } else {
        for (int i = 0; i < 4; ++i) meta->crop[i] = -1;
    }
    const TagValue* mk = ifd0->find(271);
    if (mk) strncpy(meta->make, mk->str.c_str(), 63);
    const TagValue* md = ifd0->find(272);
    if (md) strncpy(meta->model, md->str.c_str(), 63);
    return out;
}

} // extern "C"
