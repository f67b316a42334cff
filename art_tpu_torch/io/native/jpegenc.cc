// jpegenc: a baseline JPEG encoder for 8-bit RGB, written to produce the
// same bytes as libjpeg(-turbo)'s default compressor (the one behind
// OpenCV's imwrite/imencode) for a given quality and chroma subsampling.
//
// What it mirrors, step by step (the libjpeg source files in brackets):
// - RGB -> YCbCr in 16-bit fixed point with table rounding terms, the
//   Cb/Cr tables carrying CBCR_OFFSET + ONE_HALF - 1 [jccolor.c];
// - 4:2:2 / 4:2:0 chroma by 2x1 / 2x2 box averages with the alternating
//   bias 0,1,0,1... / 1,2,1,2... along a row [jcsample.c]; each plane is
//   first widened to whole blocks by repeating its last column, and the
//   full-size rows past the image by repeating its last row; for 4:2:0,
//   the chroma rows past the last averaged one repeat that row
//   [jcprepct.c];
// - the "islow" integer forward DCT (13-bit constants, 2 pass-1 bits,
//   DESCALE rounding) on samples less 128 [jfdctint.c, jcdctmgr.c];
// - quantisation by (|c| + q/2) / q with q the table entry times 8 (the
//   DCT's scale), the sign restored after, as libjpeg-turbo computes it:
//   a multiply by a reciprocal, exact for every |c| + q/2 below 2^15
//   [jcdctmgr.c compute_reciprocal];
// - the Annex K tables scaled by jpeg_quality_scaling and clamped to
//   1..255 (force_baseline) [jcparam.c];
// - dummy blocks where an MCU overhangs the image: all-zero with the DC
//   of the block to their left, or of the last block of the row above
//   in the same MCU [jccoefct.c];
// - the standard (not optimised) Huffman tables, 0xFF byte stuffing, and
//   a last byte padded with 1 bits [jchuff.c, jstdhuff.c];
// - the markers SOI, JFIF APP0 (1.01, aspect 1:1), DQT x2, SOF0,
//   DHT x4, SOS, EOI in libjpeg's order and layout [jcmarker.c].
//
// Single-threaded, as libjpeg is. C ABI for ctypes:
//   int jpegenc_encode(const uint8_t* rgb, int h, int w, int quality,
//                      int subsampling, uint8_t** out, size_t* out_len)
// rgb is interleaved (h, w, 3); subsampling 1 = 4:2:0, 2 = 4:2:2,
// 3 = 4:4:4 (ART-cli's -js1..3). Returns 0, or -1 on bad arguments; free
// *out with jpegenc_free.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const unsigned kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const unsigned kChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 tables: bits[1..16] (index 0 unused) and values
const uint8_t kBitsDcLum[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kBitsDcChrom[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kValDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};

const uint8_t kBitsAcLum[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kValAcLum[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

const uint8_t kBitsAcChrom[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kValAcChrom[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ---- colour conversion (jccolor.c) -------------------------------------

const int kScaleBits = 16;
const int32_t kCbCrOffset = 128 << kScaleBits;
const int32_t kOneHalf = 1 << (kScaleBits - 1);

constexpr int32_t fix(double x) { return (int32_t)(x * (1L << kScaleBits) + 0.5); }

struct ColorTables {
    int32_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256], gcr[256],
        bcr[256];
    ColorTables() {
        for (int i = 0; i < 256; i++) {
            ry[i] = fix(0.29900) * i;
            gy[i] = fix(0.58700) * i;
            by[i] = fix(0.11400) * i + kOneHalf;
            rcb[i] = (-fix(0.16874)) * i;
            gcb[i] = (-fix(0.33126)) * i;
            // the B->Cb and R->Cr tables are the same; 0.5 - epsilon
            // rounds the largest value to 255, not 256
            bcb[i] = fix(0.50000) * i + kCbCrOffset + kOneHalf - 1;
            gcr[i] = (-fix(0.41869)) * i;
            bcr[i] = (-fix(0.08131)) * i;
        }
    }
};

// ---- forward DCT (jfdctint.c) --------------------------------------------

const int kConstBits = 13;
const int kPass1Bits = 2;
const int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270,
              F_0_899 = 7373, F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137,
              F_1_961 = 16069, F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

void fdct_islow(int32_t* d) {
    for (int pass = 0; pass < 2; pass++) {
        // pass 0: rows, scaled up by 2^kPass1Bits; pass 1: columns,
        // leaving an overall scale of 8
        const int step = pass == 0 ? 1 : 8;
        const int stride = pass == 0 ? 8 : 1;
        const int sh = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
        for (int ctr = 0; ctr < 8; ctr++) {
            int32_t* p = d + ctr * stride;
            int32_t tmp0 = p[0 * step] + p[7 * step], tmp7 = p[0 * step] - p[7 * step];
            int32_t tmp1 = p[1 * step] + p[6 * step], tmp6 = p[1 * step] - p[6 * step];
            int32_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
            int32_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];

            int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            if (pass == 0) {
                p[0 * step] = (tmp10 + tmp11) * (1 << kPass1Bits);
                p[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
            } else {
                p[0 * step] = descale(tmp10 + tmp11, kPass1Bits);
                p[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
            }
            int32_t z1 = (tmp12 + tmp13) * F_0_541;
            p[2 * step] = descale(z1 + tmp13 * F_0_765, sh);
            p[6 * step] = descale(z1 + tmp12 * (-F_1_847), sh);

            z1 = tmp4 + tmp7;
            int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
            int32_t z5 = (z3 + z4) * F_1_175;
            tmp4 *= F_0_298;
            tmp5 *= F_2_053;
            tmp6 *= F_3_072;
            tmp7 *= F_1_501;
            z1 *= -F_0_899;
            z2 *= -F_2_562;
            z3 *= -F_1_961;
            z4 *= -F_0_390;
            z3 += z5;
            z4 += z5;
            p[7 * step] = descale(tmp4 + z1 + z3, sh);
            p[5 * step] = descale(tmp5 + z2 + z4, sh);
            p[3 * step] = descale(tmp6 + z2 + z3, sh);
            p[1 * step] = descale(tmp7 + z1 + z4, sh);
        }
    }
}

// ---- quantisation (jcdctmgr.c) ---------------------------------------------

// (|c| + d/2) / d as ((|c| + corr) * recip) >> shift, d = quantval << 3
struct Divisor {
    uint32_t recip, corr;
    int shift;
    explicit Divisor(int q = 1) {
        const uint32_t d = (uint32_t)q << 3;
        const int b = 31 - __builtin_clz(d);
        int r = 16 + b;
        uint32_t fq = (1u << r) / d;
        const uint32_t fr = (1u << r) % d;
        uint32_t c = d / 2;
        if (fr == 0) {  // a power of two
            fq >>= 1;
            r--;
        } else if (fr <= d / 2) {
            c++;
        } else {
            fq++;
        }
        recip = fq;
        corr = c;
        shift = r;
    }
    int16_t apply(int32_t t) const {
        if (t < 0) return (int16_t) - (int32_t)(((uint32_t)(-t) + corr) * recip >> shift);
        return (int16_t)(((uint32_t)t + corr) * recip >> shift);
    }
};

// ---- output ---------------------------------------------------------------

struct Writer {
    std::vector<uint8_t> out;
    uint64_t acc = 0;  // pending bits, right-aligned
    int n = 0;

    void byte(int b) { out.push_back((uint8_t)b); }
    void u16(int v) { byte((v >> 8) & 0xFF); byte(v & 0xFF); }
    void marker(int m) { byte(0xFF); byte(m); }

    // append `size` (<= 16) bits; whole bytes leave once 32 are pending,
    // each 0xFF followed by a stuffed 0x00
    void bits(uint32_t code, int size) {
        acc = (acc << size) | (code & ((1u << size) - 1));
        n += size;
        if (n >= 32) drain();
    }
    void drain() {
        while (n >= 8) {
            const int b = (int)(acc >> (n - 8)) & 0xFF;
            out.push_back((uint8_t)b);
            if (b == 0xFF) out.push_back(0);
            n -= 8;
        }
        acc &= (1ull << n) - 1;
    }
    // pad the last byte with 1 bits
    void flush() { bits(0x7F, 7); drain(); acc = 0; n = 0; }
};

struct Huff {
    uint16_t code[256];
    uint8_t size[256];
    Huff(const uint8_t* bits, const uint8_t* vals) {
        memset(size, 0, sizeof size);
        uint16_t c = 0;
        int k = 0;
        for (int len = 1; len <= 16; len++) {
            for (int i = 0; i < bits[len]; i++, k++) {
                code[vals[k]] = c++;
                size[vals[k]] = (uint8_t)len;
            }
            c <<= 1;
        }
    }
    void put(Writer& w, int sym) const { w.bits(code[sym], size[sym]); }
};

void write_dht(Writer& w, int cls_id, const uint8_t* bits, const uint8_t* vals) {
    int n = 0;
    for (int i = 1; i <= 16; i++) n += bits[i];
    w.marker(0xC4);
    w.u16(2 + 1 + 16 + n);
    w.byte(cls_id);
    for (int i = 1; i <= 16; i++) w.byte(bits[i]);
    for (int i = 0; i < n; i++) w.byte(vals[i]);
}

inline int nbits(int v) { return v ? 32 - __builtin_clz((unsigned)v) : 0; }

void encode_block(Writer& w, const int16_t* blk, int& last_dc, const Huff& dc,
                  const Huff& ac) {
    int temp = blk[0] - last_dc, temp2 = temp;
    last_dc = blk[0];
    if (temp < 0) { temp = -temp; temp2--; }
    int nb = nbits(temp);
    dc.put(w, nb);
    if (nb) w.bits((uint32_t)temp2, nb);
    int r = 0;
    for (int k = 1; k < 64; k++) {
        temp = blk[kNatural[k]];
        if (temp == 0) { r++; continue; }
        while (r > 15) { ac.put(w, 0xF0); r -= 16; }
        temp2 = temp;
        if (temp < 0) { temp = -temp; temp2--; }
        nb = nbits(temp);
        ac.put(w, (r << 4) + nb);
        w.bits((uint32_t)temp2, nb);
        r = 0;
    }
    if (r > 0) ac.put(w, 0);
}

// A component's samples as libjpeg's coefficient controller reads them:
// (rows x cols) whole blocks, edges already repeated.
struct Plane {
    int rows, cols;
    std::vector<uint8_t> px;
    uint8_t* row(int y) { return px.data() + (size_t)y * cols; }
};

}  // namespace

extern "C" {

int jpegenc_encode(const uint8_t* rgb, int h, int w, int quality, int subsampling,
                   uint8_t** out, size_t* out_len) {
    if (!rgb || !out || !out_len || h < 1 || w < 1 || h > 65535 || w > 65535 ||
        subsampling < 1 || subsampling > 3)
        return -1;
    const int hmax = subsampling == 3 ? 1 : 2, vmax = subsampling == 1 ? 2 : 1;

    // quantisation tables (jcparam.c: jpeg_quality_scaling, force_baseline)
    if (quality <= 0) quality = 1;
    if (quality > 100) quality = 100;
    const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    int quant[2][64];
    Divisor div[2][64];
    for (int t = 0; t < 2; t++)
        for (int i = 0; i < 64; i++) {
            long q = ((long)(t ? kChromQuant : kLumQuant)[i] * scale + 50L) / 100L;
            if (q <= 0) q = 1;
            if (q > 255) q = 255;
            quant[t][i] = (int)q;
            div[t][i] = Divisor((int)q);
        }

    // component geometry (jcmaster.c): block counts, MCU counts
    const int hs[3] = {hmax, 1, 1}, vs[3] = {vmax, 1, 1};
    const int mcu_cols = (w + 8 * hmax - 1) / (8 * hmax);
    const int mcu_rows = (h + 8 * vmax - 1) / (8 * vmax);
    int wblk[3], hblk[3];
    for (int c = 0; c < 3; c++) {
        wblk[c] = (int)(((long)w * hs[c] + 8L * hmax - 1) / (8L * hmax));
        hblk[c] = (int)(((long)h * vs[c] + 8L * vmax - 1) / (8L * vmax));
    }

    // colour conversion into full-size planes widened to whole blocks of
    // the full-size component (or to twice the chroma blocks' width), rows
    // repeated to whole MCU rows
    static const ColorTables T;
    const int fcols = hmax == 1 ? wblk[0] * 8 : wblk[1] * 16;
    const int frows = mcu_rows * 8 * vmax;
    Plane full[3];
    for (int c = 0; c < 3; c++) {
        full[c].rows = frows;
        full[c].cols = fcols;
        full[c].px.resize((size_t)frows * fcols);
    }
    for (int y = 0; y < h; y++) {
        const uint8_t* s = rgb + (size_t)y * w * 3;
        uint8_t *py = full[0].row(y), *pb = full[1].row(y), *pr = full[2].row(y);
        for (int x = 0; x < w; x++, s += 3) {
            const int r = s[0], g = s[1], b = s[2];
            py[x] = (uint8_t)((T.ry[r] + T.gy[g] + T.by[b]) >> kScaleBits);
            pb[x] = (uint8_t)((T.rcb[r] + T.gcb[g] + T.bcb[b]) >> kScaleBits);
            pr[x] = (uint8_t)((T.bcb[r] + T.gcr[g] + T.bcr[b]) >> kScaleBits);
        }
        for (int c = 0; c < 3; c++) {
            uint8_t* p = full[c].row(y);
            memset(p + w, p[w - 1], fcols - w);
        }
    }
    for (int y = h; y < frows; y++)
        for (int c = 0; c < 3; c++)
            memcpy(full[c].row(y), full[c].row(h - 1), fcols);

    // downsampling (jcsample.c), then chroma rows past the last averaged
    // one repeat it (jcprepct.c)
    Plane comp[3];
    comp[0] = std::move(full[0]);
    for (int c = 1; c < 3; c++) {
        if (hmax == 1) {
            comp[c] = std::move(full[c]);
            continue;
        }
        Plane& d = comp[c];
        d.cols = wblk[c] * 8;
        d.rows = hblk[c] * 8;
        d.px.resize((size_t)d.rows * d.cols);
        const int computed = (h + vmax - 1) / vmax;
        for (int y = 0; y < d.rows; y++) {
            uint8_t* o = d.row(y);
            if (y >= computed) {
                memcpy(o, d.row(computed - 1), d.cols);
                continue;
            }
            if (vmax == 1) {
                const uint8_t* i0 = full[c].row(y);
                int bias = 0;  // 0, 1, 0, 1, ...
                for (int x = 0; x < d.cols; x++, i0 += 2) {
                    o[x] = (uint8_t)((i0[0] + i0[1] + bias) >> 1);
                    bias ^= 1;
                }
            } else {
                const uint8_t* i0 = full[c].row(2 * y);
                const uint8_t* i1 = full[c].row(2 * y + 1);
                int bias = 1;  // 1, 2, 1, 2, ...
                for (int x = 0; x < d.cols; x++, i0 += 2, i1 += 2) {
                    o[x] = (uint8_t)((i0[0] + i0[1] + i1[0] + i1[1] + bias) >> 2);
                    bias ^= 3;
                }
            }
        }
        full[c].px.clear();
        full[c].px.shrink_to_fit();
    }

    Writer wr;
    wr.out.reserve((size_t)h * w + 1024);
    wr.marker(0xD8);
    // JFIF APP0: version 1.01, no units, aspect 1:1, no thumbnail
    wr.marker(0xE0);
    wr.u16(16);
    const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    for (uint8_t b : jfif) wr.byte(b);
    for (int t = 0; t < 2; t++) {
        wr.marker(0xDB);
        wr.u16(67);
        wr.byte(t);
        for (int i = 0; i < 64; i++) wr.byte(quant[t][kNatural[i]]);
    }
    wr.marker(0xC0);
    wr.u16(17);
    wr.byte(8);
    wr.u16(h);
    wr.u16(w);
    wr.byte(3);
    for (int c = 0; c < 3; c++) {
        wr.byte(c + 1);
        wr.byte((hs[c] << 4) | vs[c]);
        wr.byte(c ? 1 : 0);
    }
    write_dht(wr, 0x00, kBitsDcLum, kValDc);
    write_dht(wr, 0x10, kBitsAcLum, kValAcLum);
    write_dht(wr, 0x01, kBitsDcChrom, kValDc);
    write_dht(wr, 0x11, kBitsAcChrom, kValAcChrom);
    wr.marker(0xDA);
    wr.u16(12);
    wr.byte(3);
    for (int c = 0; c < 3; c++) {
        wr.byte(c + 1);
        wr.byte(c ? 0x11 : 0x00);
    }
    wr.byte(0);
    wr.byte(63);
    wr.byte(0);

    const Huff dc_lum(kBitsDcLum, kValDc), ac_lum(kBitsAcLum, kValAcLum);
    const Huff dc_chrom(kBitsDcChrom, kValDc), ac_chrom(kBitsAcChrom, kValAcChrom);
    int last_dc[3] = {0, 0, 0};
    int16_t mcu[4][64];
    int32_t ws[64];
    for (int mr = 0; mr < mcu_rows; mr++) {
        for (int mc = 0; mc < mcu_cols; mc++) {
            for (int c = 0; c < 3; c++) {
                const Divisor* q = div[c ? 1 : 0];
                // blocks of this component inside the image in the last MCU
                // column and row (jcmaster.c last_col_width/last_row_height)
                const int lcw = wblk[c] % hs[c] ? wblk[c] % hs[c] : hs[c];
                const int lrh = hblk[c] % vs[c] ? hblk[c] % vs[c] : vs[c];
                const int bcnt = mc < mcu_cols - 1 ? hs[c] : lcw;
                int blkn = 0;
                for (int yi = 0; yi < vs[c]; yi++) {
                    if (mr < mcu_rows - 1 || yi < lrh) {
                        for (int xi = 0; xi < bcnt; xi++) {
                            const int by = (mr * vs[c] + yi) * 8;
                            const int bx = (mc * hs[c] + xi) * 8;
                            for (int y = 0; y < 8; y++) {
                                const uint8_t* p = comp[c].row(by + y) + bx;
                                for (int x = 0; x < 8; x++) ws[y * 8 + x] = p[x] - 128;
                            }
                            fdct_islow(ws);
                            int16_t* o = mcu[blkn + xi];
                            for (int i = 0; i < 64; i++) o[i] = q[i].apply(ws[i]);
                        }
                        for (int xi = bcnt; xi < hs[c]; xi++) {
                            memset(mcu[blkn + xi], 0, sizeof mcu[0]);
                            mcu[blkn + xi][0] = mcu[blkn + xi - 1][0];
                        }
                    } else {
                        for (int xi = 0; xi < hs[c]; xi++) {
                            memset(mcu[blkn + xi], 0, sizeof mcu[0]);
                            mcu[blkn + xi][0] = mcu[blkn - 1][0];
                        }
                    }
                    blkn += hs[c];
                }
                for (int b = 0; b < blkn; b++)
                    encode_block(wr, mcu[b], last_dc[c], c ? dc_chrom : dc_lum,
                                 c ? ac_chrom : ac_lum);
            }
        }
    }
    wr.flush();
    wr.marker(0xD9);

    uint8_t* buf = (uint8_t*)malloc(wr.out.size());
    if (!buf) return -1;
    memcpy(buf, wr.out.data(), wr.out.size());
    *out = buf;
    *out_len = wr.out.size();
    return 0;
}

void jpegenc_free(uint8_t* p) { free(p); }

}  // extern "C"
