// jpegdec: a decoder for 8-bit JPEG (baseline, extended sequential and
// progressive, Huffman- or arithmetic-coded; lossless, Huffman-coded)
// that gives the bytes libjpeg-turbo's default decompressor gives to a
// caller that feeds it as Pillow does, for the port's JPEG reads
// (previews, Hald CLUTs, PSFs, masks, non-raw inputs).
//
// What it mirrors (libjpeg-turbo source files in brackets):
// - the marker reader: SOI first, the table and frame markers with their
//   length checks, JFIF APP0 and Adobe APP14 detection, garbage before a
//   marker skipped, restart-marker resync [jdmarker.c];
// - the Huffman tables with their 8-bit lookahead, and the standard
//   tables for slots 0 and 1 where a sequential file defines none
//   [jdhuff.c; a progressive file gets none, jdphuff.c];
// - the bit reader: it tops its 64-bit buffer up to 57 bits at each
//   fill, and after a marker it feeds zero bits (the rest of that
//   segment then decodes as zero coefficients) [jdhuff.c];
// - sequential decoding by the fast path where at least 512 bytes a
//   block are buffered and no restart interval is set, else by the slow
//   path, which suspends where a fill runs out of data [jdhuff.c];
// - the four progressive decoders with EOB runs and refinement
//   [jdphuff.c], and the coefficient bits per component and scan;
// - block smoothing of the output pass where a progressive file ends
//   before its last refinement: the 5x5 DC-neighbourhood estimates of
//   the first AC coefficients, from the previous scan's bits below the
//   last iMCU row decoded with data [jdcoefct.c];
// - the islow integer inverse DCT as the x86-64 SIMD build computes it
//   [jidctint.c, simd/x86_64/jidctint-avx2.asm];
// - the triangular upsamplers h2v1 and h2v2 (above 2 samples wide) and
//   h1v2, else replication [jdsample.c], with the first and last sample
//   rows repeated as context [jdmainct.c];
// - the table-driven YCbCr to RGB and YCCK to CMYK conversions
//   [jdcolor.c];
// - the arithmetic decoder with its conditioning tables (DAC), its
//   statistics bins and the Qe table, sequential and progressive; it
//   cannot suspend, so where it needs bytes past those fed it fails
//   [jdarith.c, jaricom.c];
// - lossless decoding: the Huffman-coded sample differences, the seven
//   predictors with the point transform, restarts on whole MCU rows, and
//   replication upsampling [jdlhuff.c, jdlossls.c, jddiffct.c].
//
// Suspension: Pillow hands the decoder 64 KiB of the file a call and
// suspends it where it needs more; the bytes fed so far decide whether a
// sequential MCU takes the fast path, so the decoder counts them the same
// way. Under Pillow's LOAD_TRUNCATED_IMAGES an EOI marker follows the
// file's last byte (`salvage`).
//
// C ABI for ctypes:
//   int jpegdec_decode(const uint8_t* data, size_t len, int salvage,
//                      int* info, uint8_t** out, char* msg, int msg_len)
// info[0]: 0 every scanline was output and the rest of the stream read
// (to EOI, or to its end); 1 every scanline was output but a later
// marker failed; 2 the data ended first; 3 an error came first.
// info[1..3]: height, width, output channels (1 grey, 3 RGB, 4 CMYK as
// libjpeg outputs it), where the frame header was read. *out holds
// (height, width, channels) uint8 for outcomes 0 and 1; free it with
// jpegdec_free. Outcome 4: an error came while the one scan of a
// single-scan file was decoded; *out holds the scanlines output before
// it (info[4] of them) and zeros after. Returns 0, or -1 on bad
// arguments. msg gets the error's text.
//   int jpegdec_decode_as(..., int salvage, int color, int* info, ...)
// is the same with the colour space of a three-component frame set as
// libtiff sets it for a JPEG-compressed TIFF: color -1 libjpeg's guess
// (jpegdec_decode), 0 the components unconverted (JCS_UNKNOWN), 1 YCbCr;
// color 2 reads a four-component frame as CMYK whatever its Adobe
// transform (Pillow's jpeg mode "CMYK", JCS_CMYK: no YCCK conversion).
// Colour 0 takes any number of components, output as they are.
//   int jpegdec_decode_raw(data, len, int* info, int* geom, ...)
// gives the components' planes unconverted and not upsampled, as
// libjpeg's jpeg_read_raw_data does (libtiff's old-style JPEG).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zigzag index -> natural index, with 16 extra entries for runs past 63
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

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

const size_t kChunk = 65536;  // Pillow's read size (ImageFile.MAXBLOCK)
const int kMinGetBits = 57;   // BIT_BUF_SIZE - 7 for a 64-bit buffer
const int kLookahead = 8;

// jaricom.c: Qe, Next_Index_MPS, Switch_MPS and Next_Index_LPS of Table D.2
// packed as (Qe << 16) | (NMPS << 8) | (SWITCH << 7) | NLPS, plus entry
// 113, the fixed 0.5 estimate
#define V(i, qe, nlps, nmps, sw) \
  (((int64_t)(qe) << 16) | ((int64_t)(nmps) << 8) | ((int64_t)(sw) << 7) | (nlps))
const int64_t kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),      V(1, 0x2586, 14, 2, 0),     V(2, 0x1114, 16, 3, 0),
    V(3, 0x080b, 18, 4, 0),     V(4, 0x03d8, 20, 5, 0),     V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),     V(7, 0x006f, 28, 8, 0),     V(8, 0x0036, 30, 9, 0),
    V(9, 0x001a, 33, 10, 0),    V(10, 0x000d, 35, 11, 0),   V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),   V(13, 0x0001, 12, 13, 0),   V(14, 0x5a7f, 15, 15, 1),
    V(15, 0x3f25, 36, 16, 0),   V(16, 0x2cf2, 38, 17, 0),   V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),   V(19, 0x1182, 42, 20, 0),   V(20, 0x0cef, 43, 21, 0),
    V(21, 0x09a1, 45, 22, 0),   V(22, 0x072f, 46, 23, 0),   V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),   V(25, 0x0303, 51, 26, 0),   V(26, 0x0240, 52, 27, 0),
    V(27, 0x01b1, 54, 28, 0),   V(28, 0x0144, 56, 29, 0),   V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),   V(31, 0x008a, 60, 32, 0),   V(32, 0x0068, 62, 33, 0),
    V(33, 0x004e, 63, 34, 0),   V(34, 0x003b, 32, 35, 0),   V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),   V(37, 0x484c, 64, 38, 0),   V(38, 0x3a0d, 65, 39, 0),
    V(39, 0x2ef1, 67, 40, 0),   V(40, 0x261f, 68, 41, 0),   V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),   V(43, 0x1518, 72, 44, 0),   V(44, 0x1177, 73, 45, 0),
    V(45, 0x0e74, 74, 46, 0),   V(46, 0x0bfb, 75, 47, 0),   V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),   V(49, 0x0706, 79, 50, 0),   V(50, 0x05cd, 48, 51, 0),
    V(51, 0x04de, 50, 52, 0),   V(52, 0x040f, 50, 53, 0),   V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),   V(55, 0x025c, 53, 56, 0),   V(56, 0x01f8, 54, 57, 0),
    V(57, 0x01a4, 55, 58, 0),   V(58, 0x0160, 56, 59, 0),   V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),   V(61, 0x00cb, 59, 62, 0),   V(62, 0x00ab, 61, 63, 0),
    V(63, 0x008f, 61, 32, 0),   V(64, 0x5b12, 65, 65, 1),   V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),   V(67, 0x37d8, 82, 68, 0),   V(68, 0x2fe8, 83, 69, 0),
    V(69, 0x293c, 84, 70, 0),   V(70, 0x2379, 86, 71, 0),   V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),   V(73, 0x174e, 72, 74, 0),   V(74, 0x1424, 72, 75, 0),
    V(75, 0x119c, 74, 76, 0),   V(76, 0x0f6b, 74, 77, 0),   V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),   V(79, 0x0a40, 77, 48, 0),   V(80, 0x5832, 80, 81, 1),
    V(81, 0x4d1c, 88, 82, 0),   V(82, 0x438e, 89, 83, 0),   V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),   V(85, 0x2eae, 92, 86, 0),   V(86, 0x299a, 93, 87, 0),
    V(87, 0x2516, 86, 71, 0),   V(88, 0x5570, 88, 89, 1),   V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),   V(91, 0x3e22, 97, 92, 0),   V(92, 0x3824, 99, 93, 0),
    V(93, 0x32b4, 99, 94, 0),   V(94, 0x2e17, 93, 86, 0),   V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),  V(97, 0x47e5, 102, 98, 0),  V(98, 0x41cf, 103, 99, 0),
    V(99, 0x3c3d, 104, 100, 0), V(100, 0x375e, 99, 93, 0),  V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0), V(104, 0x415e, 103, 99, 0),
    V(105, 0x5627, 105, 106, 1), V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0), V(110, 0x5a10, 110, 111, 1),
    V(111, 0x5522, 112, 109, 0), V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

struct Suspend {};   // the data ended: the decoder suspends for good
struct NeedMore {};  // the bytes fed so far ended inside a sequential MCU
struct Fail {
  std::string msg;
};

[[noreturn]] void fail(const std::string& m) { throw Fail{m}; }

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t val[256] = {0};
};

struct Derived {
  int64_t maxcode[18];
  int64_t valoffset[18];
  int lookup[1 << kLookahead];
  const HuffTable* pub;
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int wb = 0, hb = 0;          // width / height in blocks
  int dw = 0, dh = 0;          // downsampled width / height in samples
  int wb_pad = 0, hb_pad = 0;  // blocks rounded up to whole MCUs
  bool latched = false;        // quantisation table latched
  uint16_t q[64] = {0};        // natural order
  std::vector<int16_t> coef;   // (hb_pad, wb_pad, 64), natural order
  int coef_bits[64];           // progressive: Al of the last scan, or -1
  int prev_bits[64];           // the same before that scan
  int16_t* block(int r, int c) {
    return &coef[((size_t)r * wb_pad + c) * 64];
  }
};

struct Decoder {
  std::vector<uint8_t> d;  // the stream (with the salvage EOI)
  size_t file_len = 0;     // bytes of the file itself
  size_t pos = 0;          // next byte to read
  size_t fed = 0;          // bytes fed to the decoder so far
  bool in_mcu = false;     // inside a sequential MCU: the fast or slow
                           // path is chosen again when more is fed

  // marker state
  int unread_marker = 0;
  bool saw_SOI = false, saw_SOF = false;
  bool saw_JFIF = false, saw_Adobe = false;
  // the caller's jpeg_color_space for three components: -1 libjpeg's
  // guess, 0 none (JCS_UNKNOWN: the components as they are), 1 YCbCr
  int color_override = -1;
  int adobe_transform = 0;
  int restart_interval = 0;
  int next_restart_num = 0;
  bool progressive = false;
  bool arith = false, lossless = false;
  int precision = 8;
  uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];
  int height = 0, width = 0;
  int ncomp = 0;
  Component comp[10];
  uint16_t qtbl[4][64];
  bool qtbl_present[4] = {false, false, false, false};
  HuffTable dc_tbl[4], ac_tbl[4];

  // frame geometry
  int max_h = 1, max_v = 1;
  int total_imcu_rows = 0;

  // scan state
  int comps_in_scan = 0;
  int scan_comp[4];
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
  int input_scan_number = 0;
  int mcus_per_row = 0, mcu_rows_in_scan = 0;
  int blocks_in_mcu = 0;
  int mcu_membership[10];
  bool has_multiple_scans = false;

  // entropy state
  uint64_t get_buffer = 0;
  int bits_left = 0;
  bool insufficient = false;
  int last_dc[4] = {0, 0, 0, 0};
  unsigned eobrun = 0;
  int restarts_to_go = 0;
  Derived dtbl_dc[4], dtbl_ac[4];

  int last_good_imcu_row = 0;

  // arithmetic decoder state [jdarith.c]
  int64_t ar_c = 0, ar_a = 0;
  int ar_ct = -16;
  int dc_context[4] = {0, 0, 0, 0};
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};
  bool no_suspend = false;  // inside the arithmetic decoder

  // lossless: each component's sample rows (downsampled size, padded to
  // whole MCUs) as undifferenced values, and its predictor state
  std::vector<std::vector<int>> diffs;   // the MCU row's differences
  std::vector<std::vector<uint8_t>> lsamples;  // output samples
  std::vector<std::vector<int>> undiff_prev;   // last undifferenced row
  bool first_row[10];
  int restart_rows_to_go = 0;

  // a single-scan file: the iMCU row being decoded, for the scanlines
  // libjpeg has output where an error stops it
  bool single_scan = false;
  int imcu_in_progress = 0;

  // ------------------------------------------------------------ input
  void more() {
    if (no_suspend) fail("Suspension not allowed here");
    if (fed < file_len) {
      if (in_mcu) throw NeedMore{};
      fed = std::min(fed + kChunk, file_len);
    } else if (fed < d.size()) {
      if (in_mcu) throw NeedMore{};
      fed = d.size();
    } else {
      throw Suspend{};
    }
  }
  void feed_more() {  // after a NeedMore: the next call gets another chunk
    if (fed < file_len)
      fed = std::min(fed + kChunk, file_len);
    else
      fed = d.size();
  }
  int byte() {
    if (pos >= fed) more();
    return d[pos++];
  }
  int two_bytes() {
    int a = byte();
    return (a << 8) | byte();
  }
  void skip(long n) {
    // the source skips without suspending; reading past what was fed
    // resumes after more is fed
    while (n > 0) {
      if (pos >= fed) more();
      size_t take = std::min((size_t)n, fed - pos);
      pos += take;
      n -= (long)take;
    }
  }

  // ---------------------------------------------------------- markers
  void first_marker() {
    int c = byte(), c2 = byte();
    if (c != 0xFF || c2 != 0xD8) fail("Not a JPEG file: starts with 0x" +
                                       hex(c) + " 0x" + hex(c2));
    unread_marker = c2;
  }
  static std::string hex(int v) {
    const char* h = "0123456789abcdef";
    std::string s;
    s += h[(v >> 4) & 15];
    s += h[v & 15];
    return s;
  }
  void next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do {
        c = byte();
      } while (c == 0xFF);
      if (c != 0) {
        unread_marker = c;
        return;
      }
    }
  }

  void get_soi() {
    if (saw_SOI) fail("Invalid JPEG file structure: two SOI markers");
    restart_interval = 0;
    saw_JFIF = false;
    saw_Adobe = false;
    adobe_transform = 0;
    for (int i = 0; i < 16; i++) {
      arith_dc_L[i] = 0;
      arith_dc_U[i] = 1;
      arith_ac_K[i] = 5;
    }
    saw_SOI = true;
  }

  void get_sof(bool prog, bool is_lossless, bool is_arith) {
    long length = two_bytes();
    precision = byte();
    height = two_bytes();
    width = two_bytes();
    int n = byte();
    length -= 8;
    if (saw_SOF) fail("Invalid JPEG file structure: two SOF markers");
    if (height <= 0 || width <= 0 || n <= 0) fail("Empty JPEG image (DNL not supported)");
    if (length != n * 3) fail("Bogus marker length");
    if (n > 10) fail("Too many color components");
    ncomp = n;
    for (int ci = 0; ci < n; ci++) {
      Component& c = comp[ci];
      c = Component();
      c.id = byte();
      int f = byte();
      c.h = (f >> 4) & 15;
      c.v = f & 15;
      c.tq = byte();
    }
    progressive = prog;
    this->lossless = is_lossless;
    this->arith = is_arith;
    saw_SOF = true;
  }

  void get_sos() {
    if (!saw_SOF) fail("Invalid JPEG file structure: SOS before SOF");
    long length = two_bytes();
    int n = byte();
    if (length != n * 2 + 6 || n > 4 || (n == 0 && !progressive))
      fail("Bogus marker length");
    comps_in_scan = n;
    for (int i = 0; i < n; i++) {
      int cc = byte();
      int c = byte();
      for (int j = 0; j < i; j++)
        if (cc == comp[scan_comp[j]].id) fail("Invalid component ID in SOS");
      int ci = 0;
      for (; ci < ncomp; ci++)
        if (comp[ci].id == cc) break;
      if (ci == ncomp) fail("Invalid component ID in SOS");
      scan_comp[i] = ci;
      comp[ci].dc_tbl = (c >> 4) & 15;
      comp[ci].ac_tbl = c & 15;
    }
    Ss = byte();
    Se = byte();
    int c = byte();
    Ah = (c >> 4) & 15;
    Al = c & 15;
    next_restart_num = 0;
    input_scan_number++;
  }

  void get_dht() {
    long length = two_bytes() - 2;
    while (length > 16) {
      int index = byte();
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = (uint8_t)byte();
        count += bits[i];
      }
      length -= 1 + 16;
      if (count > 256 || count > length) fail("Bogus Huffman table definition");
      uint8_t val[256];
      memset(val, 0, sizeof(val));
      for (int i = 0; i < count; i++) val[i] = (uint8_t)byte();
      length -= count;
      HuffTable* t;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index >= 4) fail("Bogus DHT index");
        t = &ac_tbl[index];
      } else {
        if (index < 0 || index >= 4) fail("Bogus DHT index");
        t = &dc_tbl[index];
      }
      t->present = true;
      memcpy(t->bits, bits, 17);
      memcpy(t->val, val, 256);
    }
    if (length != 0) fail("Bogus marker length");
  }

  void get_dqt() {
    long length = two_bytes() - 2;
    while (length > 0) {
      int n = byte();
      int prec = n >> 4;
      n &= 15;
      if (n >= 4) fail("Bogus DQT index");
      for (int i = 0; i < 64; i++) {
        int t = prec ? two_bytes() : byte();
        qtbl[n][kNatural[i]] = (uint16_t)t;
      }
      qtbl_present[n] = true;
      length -= 64 + 1;
      if (prec) length -= 64;
    }
    if (length != 0) fail("Bogus marker length");
  }

  void get_dac() {
    long length = two_bytes() - 2;
    while (length > 0) {
      int index = byte();
      int val = byte();
      length -= 2;
      if (index < 0 || index >= 32) fail("Bogus DAC index " + std::to_string(index));
      if (index >= 16) {
        arith_ac_K[index - 16] = (uint8_t)val;
      } else {
        arith_dc_L[index] = (uint8_t)(val & 15);
        arith_dc_U[index] = (uint8_t)(val >> 4);
        if (arith_dc_L[index] > arith_dc_U[index]) fail("Bogus DAC value 0x" + hex(val));
      }
    }
    if (length != 0) fail("Bogus marker length");
  }

  void get_dri() {
    long length = two_bytes();
    if (length != 4) fail("Bogus marker length");
    restart_interval = two_bytes();
  }

  void get_app(int marker) {
    // APP0 and APP14 are examined (the first 14 bytes), others skipped
    long length = two_bytes() - 2;
    if (marker != 0xE0 && marker != 0xEE) {
      if (length > 0) skip(length);
      return;
    }
    long numtoread = length >= 14 ? 14 : (length > 0 ? length : 0);
    uint8_t b[14];
    for (long i = 0; i < numtoread; i++) b[i] = (uint8_t)byte();
    length -= numtoread;
    if (marker == 0xE0) {
      if (numtoread >= 14 && b[0] == 0x4A && b[1] == 0x46 && b[2] == 0x49 &&
          b[3] == 0x46 && b[4] == 0)
        saw_JFIF = true;
    } else {
      if (numtoread >= 12 && b[0] == 0x41 && b[1] == 0x64 && b[2] == 0x6F &&
          b[3] == 0x62 && b[4] == 0x65) {
        saw_Adobe = true;
        adobe_transform = b[11];
      }
    }
    if (length > 0) skip(length);
  }

  void skip_variable() {
    long length = two_bytes() - 2;
    if (length > 0) skip(length);
  }

  // read markers up to SOS (returns true) or EOI (returns false)
  bool read_markers() {
    for (;;) {
      if (unread_marker == 0) {
        if (!saw_SOI)
          first_marker();
        else
          next_marker();
      }
      int m = unread_marker;
      switch (m) {
        case 0xD8:
          get_soi();
          break;
        case 0xC0:
        case 0xC1:
          get_sof(false, false, false);
          break;
        case 0xC2:
          get_sof(true, false, false);
          break;
        case 0xC3:
          get_sof(false, true, false);
          break;
        case 0xC9:
          get_sof(false, false, true);
          break;
        case 0xCA:
          get_sof(true, false, true);
          break;
        case 0xCB:
          get_sof(false, true, true);
          break;
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xC8:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail("Unsupported JPEG process: SOF type 0x" + hex(m));
        case 0xDA:
          get_sos();
          unread_marker = 0;
          return true;
        case 0xD9:
          unread_marker = 0;
          return false;
        case 0xCC:
          get_dac();
          break;
        case 0xC4:
          get_dht();
          break;
        case 0xDB:
          get_dqt();
          break;
        case 0xDD:
          get_dri();
          break;
        case 0xFE:
          skip_variable();
          break;
        case 0xD0:
        case 0xD1:
        case 0xD2:
        case 0xD3:
        case 0xD4:
        case 0xD5:
        case 0xD6:
        case 0xD7:
        case 0x01:
          break;
        case 0xDC:
          skip_variable();
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF) {
            get_app(m);
            break;
          }
          fail("Unsupported marker type 0x" + hex(m));
      }
      unread_marker = 0;
    }
  }

  // ---------------------------------------------------- frame set-up
  void initial_setup() {
    if (height > 65500 || width > 65500) fail("Maximum supported image dimension is 65500 pixels");
    if (precision != 8) fail("Unsupported JPEG data precision " + std::to_string(precision));
    max_h = max_v = 1;
    for (int ci = 0; ci < ncomp; ci++) {
      Component& c = comp[ci];
      if (c.h <= 0 || c.h > 4 || c.v <= 0 || c.v > 4) fail("Bogus sampling factors");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    // a block is 8x8 samples, or one sample in a lossless frame
    const int dct = lossless ? 1 : 8;
    for (int ci = 0; ci < ncomp; ci++) {
      Component& c = comp[ci];
      c.wb = (int)(((long)width * c.h + max_h * dct - 1) / (max_h * dct));
      c.hb = (int)(((long)height * c.v + max_v * dct - 1) / (max_v * dct));
      c.dw = (int)(((long)width * c.h + max_h - 1) / max_h);
      c.dh = (int)(((long)height * c.v + max_v - 1) / max_v);
      c.wb_pad = (c.wb + c.h - 1) / c.h * c.h;
      c.hb_pad = (c.hb + c.v - 1) / c.v * c.v;
      // room for the MCU columns of an interleaved scan
      int mcus = (width + max_h * dct - 1) / (max_h * dct);
      c.wb_pad = std::max(c.wb_pad, mcus * c.h);
      for (int i = 0; i < 64; i++) c.coef_bits[i] = -1;
    }
    total_imcu_rows = (height + max_v * dct - 1) / (max_v * dct);
    if (lossless) {
      diffs.resize(ncomp);
      lsamples.resize(ncomp);
      undiff_prev.resize(ncomp);
    }
    for (int ci = 0; ci < ncomp; ci++) {
      Component& c = comp[ci];
      c.hb_pad = std::max(c.hb_pad, total_imcu_rows * c.v);
      if (lossless) {
        diffs[ci].assign((size_t)c.v * c.wb_pad, 0);
        lsamples[ci].assign((size_t)c.hb_pad * c.wb_pad, 0);
        undiff_prev[ci].assign((size_t)c.wb_pad, 0);
      } else {
        c.coef.assign((size_t)c.hb_pad * c.wb_pad * 64, 0);
      }
    }
    // the upsampling each component needs must be one libjpeg has
    for (int ci = 0; ci < ncomp; ci++) {
      Component& c = comp[ci];
      if (max_h % c.h != 0 || max_v % c.v != 0)
        fail("Fractional sampling not implemented yet");
    }
  }

  void per_scan_setup() {
    if (comps_in_scan == 1) {
      Component& c = comp[scan_comp[0]];
      mcus_per_row = c.wb;
      mcu_rows_in_scan = c.hb;
      blocks_in_mcu = 1;
      mcu_membership[0] = 0;
    } else {
      if (comps_in_scan <= 0 || comps_in_scan > 4) fail("Too many color components");
      const int dct = lossless ? 1 : 8;
      mcus_per_row = (width + max_h * dct - 1) / (max_h * dct);
      mcu_rows_in_scan = (height + max_v * dct - 1) / (max_v * dct);
      blocks_in_mcu = 0;
      for (int i = 0; i < comps_in_scan; i++) {
        Component& c = comp[scan_comp[i]];
        int n = c.h * c.v;
        if (blocks_in_mcu + n > 10) fail("Sampling factors too large for interleaved scan");
        while (n-- > 0) mcu_membership[blocks_in_mcu++] = i;
      }
    }
  }

  void latch_quant_tables() {
    for (int i = 0; i < comps_in_scan; i++) {
      Component& c = comp[scan_comp[i]];
      if (c.latched) continue;
      if (c.tq < 0 || c.tq >= 4 || !qtbl_present[c.tq])
        fail("Quantization table 0x" + hex(c.tq) + " was not defined");
      memcpy(c.q, qtbl[c.tq], sizeof(c.q));
      c.latched = true;
    }
  }

  void std_huff_tables() {
    auto put = [](HuffTable& t, const uint8_t* bits, const uint8_t* val, int n) {
      if (t.present) return;
      t.present = true;
      memcpy(t.bits, bits, 17);
      memset(t.val, 0, 256);
      memcpy(t.val, val, n);
    };
    put(dc_tbl[0], kBitsDcLum, kValDc, 12);
    put(ac_tbl[0], kBitsAcLum, kValAcLum, 162);
    put(dc_tbl[1], kBitsDcChrom, kValDc, 12);
    put(ac_tbl[1], kBitsAcChrom, kValAcChrom, 162);
  }

  void make_derived(bool is_dc, int tblno, Derived& dt) {
    if (tblno < 0 || tblno >= 4) fail("Huffman table 0x" + hex(tblno) + " was not defined");
    const HuffTable& ht = is_dc ? dc_tbl[tblno] : ac_tbl[tblno];
    if (!ht.present) fail("Huffman table 0x" + hex(tblno) + " was not defined");
    dt.pub = &ht;
    char huffsize[257];
    unsigned huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      int i = ht.bits[l];
      if (p + i > 256) fail("Bogus Huffman table definition");
      while (i--) huffsize[p++] = (char)l;
    }
    huffsize[p] = 0;
    int numsymbols = p;
    unsigned code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while ((int)huffsize[p] == si) {
        huffcode[p++] = code;
        code++;
      }
      if ((int64_t)code >= ((int64_t)1 << si)) fail("Bogus Huffman table definition");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (ht.bits[l]) {
        dt.valoffset[l] = (int64_t)p - (int64_t)huffcode[p];
        p += ht.bits[l];
        dt.maxcode[l] = huffcode[p - 1];
      } else {
        dt.maxcode[l] = -1;
      }
    }
    dt.valoffset[17] = 0;
    dt.maxcode[17] = 0xFFFFFL;
    for (int i = 0; i < (1 << kLookahead); i++) dt.lookup[i] = (kLookahead + 1) << kLookahead;
    p = 0;
    for (int l = 1; l <= kLookahead; l++) {
      for (int i = 1; i <= (int)ht.bits[l]; i++, p++) {
        int lookbits = huffcode[p] << (kLookahead - l);
        for (int ctr = 1 << (kLookahead - l); ctr > 0; ctr--) {
          dt.lookup[lookbits] = (l << kLookahead) | ht.val[p];
          lookbits++;
        }
      }
    }
    if (is_dc) {
      for (int i = 0; i < numsymbols; i++)
        if (ht.val[i] > (lossless ? 16 : 15)) fail("Bogus Huffman table definition");
    }
  }

  void start_input_pass() {
    per_scan_setup();
    if (lossless) {
      start_pass_lossless();
      return;
    }
    latch_quant_tables();
    if (arith) {
      start_pass_arith();
      return;
    }
    if (progressive) {
      start_pass_phuff();
    } else {
      for (int i = 0; i < comps_in_scan; i++) {
        Component& c = comp[scan_comp[i]];
        make_derived(true, c.dc_tbl, dtbl_dc[c.dc_tbl]);
        make_derived(false, c.ac_tbl, dtbl_ac[c.ac_tbl]);
        last_dc[i] = 0;
      }
    }
    bits_left = 0;
    get_buffer = 0;
    insufficient = false;
    eobrun = 0;
    for (int i = 0; i < 4; i++) last_dc[i] = 0;
    restarts_to_go = restart_interval;
  }

  void start_pass_phuff() {
    bool is_dc = (Ss == 0);
    bool bad = false;
    if (is_dc) {
      if (Se != 0) bad = true;
    } else {
      if (Ss > Se || Se >= 64) bad = true;
      if (comps_in_scan != 1) bad = true;
    }
    if (Ah != 0 && Al != Ah - 1) bad = true;
    if (Al > 13) bad = true;
    if (bad) bad_progression();
    update_coef_bits();
    for (int i = 0; i < comps_in_scan; i++) {
      Component& c = comp[scan_comp[i]];
      if (is_dc) {
        if (Ah == 0) make_derived(true, c.dc_tbl, dtbl_dc[c.dc_tbl]);
      } else {
        make_derived(false, c.ac_tbl, dtbl_ac[c.ac_tbl]);
      }
    }
  }

  [[noreturn]] void bad_progression() {
    fail("Invalid progressive/lossless parameters Ss=" + std::to_string(Ss) +
         " Se=" + std::to_string(Se) + " Ah=" + std::to_string(Ah) + " Al=" + std::to_string(Al));
  }
  void update_coef_bits() {
    for (int i = 0; i < comps_in_scan; i++) {
      Component& c = comp[scan_comp[i]];
      for (int k = std::min(Ss, 1); k <= std::max(Se, 9); k++)
        c.prev_bits[k] = input_scan_number > 1 ? c.coef_bits[k] : 0;
      for (int k = Ss; k <= Se; k++) c.coef_bits[k] = Al;
    }
  }

  // jdarith.c start_pass
  void start_pass_arith() {
    if (progressive) {
      bool bad = false;
      if (Ss == 0) {
        if (Se != 0) bad = true;
      } else {
        if (Se < Ss || Se > 63) bad = true;
        if (comps_in_scan != 1) bad = true;
      }
      if (Ah != 0 && Ah - 1 != Al) bad = true;
      if (Al > 13) bad = true;
      if (bad) bad_progression();
      update_coef_bits();
    }
    for (int i = 0; i < comps_in_scan; i++) {
      Component& c = comp[scan_comp[i]];
      if (!progressive || (Ss == 0 && Ah == 0)) {
        if (c.dc_tbl < 0 || c.dc_tbl >= 16)
          fail("Arithmetic table 0x" + hex(c.dc_tbl) + " was not defined");
        memset(dc_stats[c.dc_tbl], 0, 64);
        last_dc[i] = 0;
        dc_context[i] = 0;
      }
      if (!progressive || Ss) {
        if (c.ac_tbl < 0 || c.ac_tbl >= 16)
          fail("Arithmetic table 0x" + hex(c.ac_tbl) + " was not defined");
        memset(ac_stats[c.ac_tbl], 0, 256);
      }
    }
    ar_c = 0;
    ar_a = 0;
    ar_ct = -16;
    insufficient = false;
    restarts_to_go = restart_interval;
  }

  // jdlossls.c, jddiffct.c start_input_pass
  void start_pass_lossless() {
    if (arith) fail("Sorry, arithmetic coding is not implemented");
    if (Ss < 1 || Ss > 7 || Se != 0 || Ah != 0 || Al >= precision) bad_progression();
    if (restart_interval % mcus_per_row != 0)
      fail("Invalid restart interval " + std::to_string(restart_interval) +
           "; must be an integer multiple of the number of MCUs in an MCU row (" +
           std::to_string(mcus_per_row) + ")");
    for (int i = 0; i < comps_in_scan; i++) {
      Component& c = comp[scan_comp[i]];
      make_derived(true, c.dc_tbl, dtbl_dc[c.dc_tbl]);
    }
    for (int ci = 0; ci < ncomp; ci++) first_row[ci] = true;
    bits_left = 0;
    get_buffer = 0;
    insufficient = false;
    restart_rows_to_go = restart_interval / mcus_per_row;
  }

  // ------------------------------------------------------ bit reader
  void fill_bits(int nbits) {
    if (unread_marker == 0) {
      // bytes are read into locals and kept only once the fill ends
      size_t p = pos;
      uint64_t gb = get_buffer;
      int bl = bits_left;
      bool marker = false;
      while (bl < kMinGetBits) {
        if (p >= fed) more();
        int c = d[p++];
        if (c == 0xFF) {
          do {
            if (p >= fed) more();
            c = d[p++];
          } while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker = c;
            marker = true;
            break;
          }
        }
        gb = (gb << 8) | (uint64_t)c;
        bl += 8;
      }
      pos = p;
      get_buffer = gb;
      bits_left = bl;
      if (!marker) return;
    }
    if (nbits > bits_left) {
      insufficient = true;
      get_buffer <<= kMinGetBits - bits_left;
      bits_left = kMinGetBits;
    }
  }
  int get_bits(int n) {
    bits_left -= n;
    return (int)(get_buffer >> bits_left) & ((1 << n) - 1);
  }
  int peek_bits(int n) { return (int)(get_buffer >> (bits_left - n)) & ((1 << n) - 1); }
  void check_bits(int n) {
    if (bits_left < n) fill_bits(n);
  }
  int huff_slow(const Derived& t, int min_bits) {
    int l = min_bits;
    check_bits(l);
    int64_t code = get_bits(l);
    while (code > t.maxcode[l]) {
      code <<= 1;
      check_bits(1);
      code |= get_bits(1);
      l++;
    }
    if (l > 16) return 0;
    return t.pub->val[(int)(code + t.valoffset[l])];
  }
  int huff_decode(const Derived& t) {
    int nb;
    if (bits_left < kLookahead) {
      fill_bits(0);
      if (bits_left < kLookahead) return huff_slow(t, 1);
    }
    int look = peek_bits(kLookahead);
    if ((nb = (t.lookup[look] >> kLookahead)) <= kLookahead) {
      bits_left -= nb;
      return t.lookup[look] & ((1 << kLookahead) - 1);
    }
    return huff_slow(t, nb);
  }
  static int huff_extend(int x, int s) {
    return x < (1 << (s - 1)) ? x + (int)((~0u) << s) + 1 : x;
  }

  // ------------------------------------------------------- restarts
  void read_restart_marker() {
    if (unread_marker == 0) next_marker();
    if (unread_marker == 0xD0 + next_restart_num) {
      unread_marker = 0;
    } else {
      resync_to_restart(next_restart_num);
    }
    next_restart_num = (next_restart_num + 1) & 7;
  }
  void resync_to_restart(int desired) {
    int marker = unread_marker;
    for (;;) {
      int action;
      if (marker < 0xC0)
        action = 2;
      else if (marker < 0xD0 || marker > 0xD7)
        action = 3;
      else if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7))
        action = 3;
      else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7))
        action = 2;
      else
        action = 1;
      if (action == 1) {
        unread_marker = 0;
        return;
      }
      if (action == 3) return;
      next_marker();
      marker = unread_marker;
    }
  }
  void process_restart() {
    bits_left = 0;
    read_restart_marker();
    for (int i = 0; i < comps_in_scan; i++) last_dc[i] = 0;
    eobrun = 0;
    restarts_to_go = restart_interval;
    if (unread_marker == 0) insufficient = false;
  }

  // --------------------------------------------- sequential decoding
  void mcu_blocks(int mcu_row, int mcu_col, int16_t** blocks) {
    if (comps_in_scan == 1) {
      blocks[0] = comp[scan_comp[0]].block(mcu_row, mcu_col);
      return;
    }
    int b = 0;
    for (int i = 0; i < comps_in_scan; i++) {
      Component& c = comp[scan_comp[i]];
      for (int y = 0; y < c.v; y++)
        for (int x = 0; x < c.h; x++)
          blocks[b++] = c.block(mcu_row * c.v + y, mcu_col * c.h + x);
    }
  }

  void decode_mcu_slow(int16_t** blocks) {
    for (int b = 0; b < blocks_in_mcu; b++) {
      int16_t* block = blocks[b];
      Component& c = comp[scan_comp[mcu_membership[b]]];
      const Derived& dct = dtbl_dc[c.dc_tbl];
      const Derived& act = dtbl_ac[c.ac_tbl];
      int s = huff_decode(dct);
      if (s) {
        check_bits(s);
        int r = get_bits(s);
        s = huff_extend(r, s);
      }
      int ci = mcu_membership[b];
      s = (int)((unsigned)s + (unsigned)last_dc[ci]);
      last_dc[ci] = s;
      block[0] = (int16_t)s;
      for (int k = 1; k < 64; k++) {
        s = huff_decode(act);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          check_bits(s);
          r = get_bits(s);
          s = huff_extend(r, s);
          block[kNatural[k]] = (int16_t)s;
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  // the fast path: 6 bytes at a time, a marker ends it (the MCU is then
  // decoded again by the slow path)
  void fast_fill() {
    if (bits_left <= 16) {
      for (int i = 0; i < 6; i++) {
        int c0 = fast_byte(pos), c1 = fast_byte(pos + 1);
        pos++;
        get_buffer = (get_buffer << 8) | (uint64_t)c0;
        bits_left += 8;
        if (c0 == 0xFF) {
          pos++;
          if (c1 != 0) {
            unread_marker = c1;
            pos -= 2;
            get_buffer &= ~(uint64_t)0xFF;
          }
        }
      }
    }
  }
  int fast_byte(size_t p) const { return p < d.size() ? d[p] : 0; }
  int huff_decode_fast(const Derived& t) {
    fast_fill();
    int s = peek_bits(kLookahead);
    s = t.lookup[s];
    int nb = s >> kLookahead;
    bits_left -= nb;
    s &= (1 << kLookahead) - 1;
    if (nb > kLookahead) {
      int64_t code = (int64_t)(get_buffer >> bits_left) & ((1 << nb) - 1);
      while (code > t.maxcode[nb]) {
        code <<= 1;
        code |= get_bits(1);
        nb++;
      }
      if (nb > 16)
        s = 0;
      else
        s = t.pub->val[(int)(code + t.valoffset[nb]) & 0xFF];
    }
    return s;
  }
  bool decode_mcu_fast(int16_t** blocks) {
    int dc[4];
    memcpy(dc, last_dc, sizeof(dc));
    for (int b = 0; b < blocks_in_mcu; b++) {
      int16_t* block = blocks[b];
      Component& c = comp[scan_comp[mcu_membership[b]]];
      const Derived& dct = dtbl_dc[c.dc_tbl];
      const Derived& act = dtbl_ac[c.ac_tbl];
      int s = huff_decode_fast(dct);
      if (s) {
        fast_fill();
        int r = get_bits(s);
        s = huff_extend(r, s);
      }
      int ci = mcu_membership[b];
      s = (int)((unsigned)s + (unsigned)dc[ci]);
      dc[ci] = s;
      block[0] = (int16_t)s;
      for (int k = 1; k < 64; k++) {
        s = huff_decode_fast(act);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          fast_fill();
          r = get_bits(s);
          s = huff_extend(r, s);
          block[kNatural[k]] = (int16_t)s;
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    if (unread_marker != 0) {
      unread_marker = 0;
      return false;
    }
    memcpy(last_dc, dc, sizeof(dc));
    return true;
  }

  void decode_mcu_sequential(int16_t** blocks) {
    if (restart_interval && restarts_to_go == 0) process_restart();
    if (!insufficient) {
      for (;;) {
        size_t pos0 = pos;
        uint64_t gb0 = get_buffer;
        int bl0 = bits_left;
        int dc0[4];
        memcpy(dc0, last_dc, sizeof(dc0));
        bool usefast = !restart_interval && unread_marker == 0 &&
                       fed - pos >= (size_t)512 * blocks_in_mcu;
        try {
          in_mcu = true;
          if (!usefast || !decode_mcu_fast(blocks)) {
            pos = pos0;
            get_buffer = gb0;
            bits_left = bl0;
            memcpy(last_dc, dc0, sizeof(dc0));
            decode_mcu_slow(blocks);
          }
          in_mcu = false;
          break;
        } catch (NeedMore&) {
          in_mcu = false;
          pos = pos0;
          get_buffer = gb0;
          bits_left = bl0;
          memcpy(last_dc, dc0, sizeof(dc0));
          feed_more();
        } catch (...) {
          in_mcu = false;
          throw;
        }
      }
    }
    if (restart_interval) restarts_to_go--;
  }

  // -------------------------------------------- progressive decoding
  void decode_mcu_dc_first(int16_t** blocks) {
    for (int b = 0; b < blocks_in_mcu; b++) {
      int16_t* block = blocks[b];
      int ci = mcu_membership[b];
      const Derived& t = dtbl_dc[comp[scan_comp[ci]].dc_tbl];
      int s = huff_decode(t);
      if (s) {
        check_bits(s);
        int r = get_bits(s);
        s = huff_extend(r, s);
      }
      s = (int)((unsigned)s + (unsigned)last_dc[ci]);
      last_dc[ci] = s;
      block[0] = (int16_t)((unsigned)s << Al);
    }
  }
  void decode_mcu_dc_refine(int16_t** blocks) {
    int p1 = 1 << Al;
    for (int b = 0; b < blocks_in_mcu; b++) {
      check_bits(1);
      if (get_bits(1)) blocks[b][0] = (int16_t)(blocks[b][0] | p1);
    }
  }
  void decode_mcu_ac_first(int16_t** blocks) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    int16_t* block = blocks[0];
    const Derived& t = dtbl_ac[comp[scan_comp[0]].ac_tbl];
    for (int k = Ss; k <= Se; k++) {
      int s = huff_decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        check_bits(s);
        r = get_bits(s);
        s = huff_extend(r, s);
        block[kNatural[k]] = (int16_t)((unsigned)s << Al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1u << r;
          if (r) {
            check_bits(r);
            r = get_bits(r);
            eobrun += r;
          }
          eobrun--;
          break;
        }
      }
    }
  }
  void decode_mcu_ac_refine(int16_t** blocks) {
    int p1 = 1 << Al;
    int m1 = (int)((unsigned)-1 << Al);
    int16_t* block = blocks[0];
    const Derived& t = dtbl_ac[comp[scan_comp[0]].ac_tbl];
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; k++) {
        int s = huff_decode(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          check_bits(1);
          s = get_bits(1) ? p1 : m1;
        } else {
          if (r != 15) {
            eobrun = 1u << r;
            if (r) {
              check_bits(r);
              r = get_bits(r);
              eobrun += r;
            }
            break;
          }
        }
        do {
          int16_t* coef = block + kNatural[k];
          if (*coef != 0) {
            check_bits(1);
            if (get_bits(1)) {
              if ((*coef & p1) == 0) {
                if (*coef >= 0)
                  *coef = (int16_t)(*coef + p1);
                else
                  *coef = (int16_t)(*coef + m1);
              }
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= Se);
        if (s) block[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; k++) {
        int16_t* coef = block + kNatural[k];
        if (*coef != 0) {
          check_bits(1);
          if (get_bits(1)) {
            if ((*coef & p1) == 0) {
              if (*coef >= 0)
                *coef = (int16_t)(*coef + p1);
              else
                *coef = (int16_t)(*coef + m1);
            }
          }
        }
      }
      eobrun--;
    }
  }
  // the progressive decoders have no fast path, so a suspension and the
  // MCU decoded again on more data read the same bits as reading on
  void decode_mcu_progressive(int16_t** blocks) {
    if (restart_interval && restarts_to_go == 0) process_restart();
    if (!insufficient) {
      if (Ah == 0) {
        if (Ss == 0)
          decode_mcu_dc_first(blocks);
        else
          decode_mcu_ac_first(blocks);
      } else {
        if (Ss == 0)
          decode_mcu_dc_refine(blocks);
        else
          decode_mcu_ac_refine(blocks);
      }
    }
    if (restart_interval) restarts_to_go--;
  }


  // ------------------------------------------- arithmetic decoding
  // jdarith.c: the decoder reads the data itself and cannot suspend
  int arith_byte() {
    if (pos >= fed) fail("Suspension not allowed here");
    return d[pos++];
  }
  int arith_decode(uint8_t* st) {
    while (ar_a < 0x8000) {
      if (--ar_ct < 0) {
        int data;
        if (unread_marker) {
          data = 0;  // past a marker: zero data to the end of the scan
        } else {
          data = arith_byte();
          if (data == 0xFF) {
            do data = arith_byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread_marker = data;
              data = 0;
            }
          }
        }
        ar_c = (ar_c << 8) | data;
        if ((ar_ct += 8) < 0)
          if (++ar_ct == 0) ar_a = 0x8000;  // the two initial bytes read
      }
      ar_a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    int nl = (int)(qe & 0xFF);
    qe >>= 8;
    int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = ar_a - qe;
    ar_a = temp;
    temp <<= ar_ct;
    if (ar_c >= temp) {
      ar_c -= temp;
      if (ar_a < qe) {
        ar_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        ar_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ar_a < 0x8000) {
      if (ar_a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  void arith_restart() {
    read_restart_marker();
    for (int i = 0; i < comps_in_scan; i++) {
      Component& c = comp[scan_comp[i]];
      if (!progressive || (Ss == 0 && Ah == 0)) {
        memset(dc_stats[c.dc_tbl], 0, 64);
        last_dc[i] = 0;
        dc_context[i] = 0;
      }
      if (!progressive || Ss) memset(ac_stats[c.ac_tbl], 0, 256);
    }
    ar_c = 0;
    ar_a = 0;
    ar_ct = -16;
    restarts_to_go = restart_interval;
  }
  // a DC difference (Figures F.19-F.24) added to component ci's
  // prediction; false where the magnitude overflows
  bool arith_dc(int ci, int tbl) {
    uint8_t* st = dc_stats[tbl] + dc_context[ci];
    if (arith_decode(st) == 0) {
      dc_context[ci] = 0;
      return true;
    }
    int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < (int)((1L << arith_dc_L[tbl]) >> 1))
      dc_context[ci] = 0;
    else if (m > (int)((1L << arith_dc_U[tbl]) >> 1))
      dc_context[ci] = 12 + sign * 4;
    else
      dc_context[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc[ci] = (last_dc[ci] + v) & 0xffff;
    return true;
  }
  // an AC value at k, whose bins start at st (Figures F.21-F.24); false
  // where the magnitude overflows
  bool arith_ac_value(int tbl, int k, uint8_t* st, int* out) {
    int sign = arith_decode(fixed_bin);
    st += 2;
    int m = arith_decode(st);
    if (m != 0) {
      if (arith_decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= arith_ac_K[tbl] ? 189 : 217);
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          st += 1;
        }
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    *out = sign ? -v : v;
    return true;
  }
  void arith_sequential(int16_t** blocks) {
    for (int b = 0; b < blocks_in_mcu; b++) {
      int16_t* block = blocks[b];
      int ci = mcu_membership[b];
      Component& c = comp[scan_comp[ci]];
      if (!arith_dc(ci, c.dc_tbl)) {
        ar_ct = -1;
        return;
      }
      block[0] = (int16_t)last_dc[ci];
      int tbl = c.ac_tbl;
      for (int k = 1; k <= 63; k++) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (arith_decode(st)) break;  // EOB
        while (arith_decode(st + 1) == 0) {
          st += 3;
          if (++k > 63) {
            ar_ct = -1;
            return;
          }
        }
        int v;
        if (!arith_ac_value(tbl, k, st, &v)) {
          ar_ct = -1;
          return;
        }
        block[kNatural[k]] = (int16_t)v;
      }
    }
  }
  void arith_dc_first(int16_t** blocks) {
    for (int b = 0; b < blocks_in_mcu; b++) {
      int ci = mcu_membership[b];
      if (!arith_dc(ci, comp[scan_comp[ci]].dc_tbl)) {
        ar_ct = -1;
        return;
      }
      blocks[b][0] = (int16_t)(int64_t)((uint64_t)(int64_t)last_dc[ci] << Al);
    }
  }
  void arith_ac_first(int16_t** blocks) {
    int16_t* block = blocks[0];
    int tbl = comp[scan_comp[0]].ac_tbl;
    for (int k = Ss; k <= Se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > Se) {
          ar_ct = -1;
          return;
        }
      }
      int v;
      if (!arith_ac_value(tbl, k, st, &v)) {
        ar_ct = -1;
        return;
      }
      block[kNatural[k]] = (int16_t)((unsigned)v << Al);
    }
  }
  void arith_dc_refine(int16_t** blocks) {
    int p1 = 1 << Al;
    for (int b = 0; b < blocks_in_mcu; b++)
      if (arith_decode(fixed_bin)) blocks[b][0] = (int16_t)(blocks[b][0] | p1);
  }
  void arith_ac_refine(int16_t** blocks) {
    int16_t* block = blocks[0];
    int tbl = comp[scan_comp[0]].ac_tbl;
    int p1 = 1 << Al;
    int m1 = (int)((unsigned)-1 << Al);
    int kex;
    for (kex = Se; kex > 0; kex--)
      if (block[kNatural[kex]]) break;
    for (int k = Ss; k <= Se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex)
        if (arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = block + kNatural[k];
        if (*coef) {
          if (arith_decode(st + 2)) *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (arith_decode(st + 1)) {
          *coef = (int16_t)(arith_decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > Se) {
          ar_ct = -1;
          return;
        }
      }
    }
  }
  void decode_mcu_arith(int16_t** blocks) {
    no_suspend = true;
    if (restart_interval) {
      if (restarts_to_go == 0) arith_restart();
      restarts_to_go--;
    }
    if (ar_ct != -1) {  // after a bad code the rest of the interval is zero
      if (!progressive)
        arith_sequential(blocks);
      else if (Ah == 0)
        Ss == 0 ? arith_dc_first(blocks) : arith_ac_first(blocks);
      else
        Ss == 0 ? arith_dc_refine(blocks) : arith_ac_refine(blocks);
    }
    no_suspend = false;
  }

  // --------------------------------------------- lossless decoding
  // one MCU's sample differences into the rows of its MCU row (a
  // single-component scan's MCU: one sample, in row yo) [jdlhuff.c
  // decode_mcus]
  void lossless_mcu(int mcu_col, int yo) {
    for (int b = 0; b < blocks_in_mcu; b++) {
      int ci_scan = mcu_membership[b];
      int ci = scan_comp[ci_scan];
      Component& c = comp[ci];
      int s = huff_decode(dtbl_dc[c.dc_tbl]);
      if (s) {
        if (s == 16) {
          s = 32768;
        } else {
          check_bits(s);
          int r = get_bits(s);
          s = huff_extend(r, s);
        }
      }
      // the sample's place: block b's offset within its component's run
      int first = 0;
      while (mcu_membership[first] != ci_scan) first++;
      int k = b - first;
      int hh = comps_in_scan == 1 ? 1 : c.h;
      int row = comps_in_scan == 1 ? yo : k / hh, col = mcu_col * hh + k % hh;
      diffs[ci][(size_t)row * c.wb_pad + col] = s;
    }
  }
  // jdlossls.c: one row undifferenced by the scan's predictor (the first
  // row of a scan or restart interval by its initial value and Ra), then
  // scaled by the point transform
  void undifference(int ci, const int* diff, uint8_t* out) {
    Component& c = comp[ci];
    int width = c.wb;
    std::vector<int>& prev = undiff_prev[ci];
    std::vector<int> row(width);
    if (first_row[ci]) {
      int Ra = (diff[0] + (1 << (precision - Al - 1))) & 0xFFFF;
      row[0] = Ra;
      for (int x = 1; x < width; x++) row[x] = Ra = (diff[x] + Ra) & 0xFFFF;
      first_row[ci] = false;
    } else {
      int Rb = prev[0];
      int Ra = (diff[0] + Rb) & 0xFFFF;
      row[0] = Ra;
      for (int x = 1; x < width; x++) {
        int Rc = Rb;
        Rb = prev[x];
        int64_t pred;
        switch (Ss) {
          case 1: pred = Ra; break;
          case 2: pred = Rb; break;
          case 3: pred = Rc; break;
          case 4: pred = (int64_t)Ra + Rb - Rc; break;
          case 5: pred = (int64_t)Ra + (((int64_t)Rb - Rc) >> 1); break;
          case 6: pred = (int64_t)Rb + (((int64_t)Ra - Rc) >> 1); break;
          default: pred = ((int64_t)Ra + Rb) >> 1; break;
        }
        row[x] = Ra = (int)((diff[x] + pred) & 0xFFFF);
      }
    }
    for (int x = 0; x < width; x++) {
      prev[x] = row[x];
      out[x] = (uint8_t)(row[x] << Al);
    }
  }
  // one scan, an iMCU row at a time [jddiffct.c decompress_data]
  void decode_scan_lossless() {
    int mcu_rows_per_imcu = comps_in_scan == 1 ? comp[scan_comp[0]].v : 1;
    if (comps_in_scan == 1) mcu_rows_in_scan = comp[scan_comp[0]].hb;
    int imcu_rows = (mcu_rows_in_scan + mcu_rows_per_imcu - 1) / mcu_rows_per_imcu;
    for (int imcu = 0; imcu < imcu_rows; imcu++) {
      imcu_in_progress = imcu;
      for (int yo = 0; yo < mcu_rows_per_imcu; yo++) {
        int mrow = imcu * mcu_rows_per_imcu + yo;
        if (mrow >= mcu_rows_in_scan) break;
        if (restart_interval && restart_rows_to_go == 0) {
          process_restart();
          for (int ci = 0; ci < ncomp; ci++) first_row[ci] = true;
          restart_rows_to_go = restart_interval / mcus_per_row;
        }
        // the differences land in rows yo (single component) or 0..v-1
        if (insufficient) {
          // out of data: zero differences, every predictor restarted
          for (int i = 0; i < comps_in_scan; i++) {
            int ci = scan_comp[i];
            size_t w = comp[ci].wb_pad;
            if (comps_in_scan == 1)
              std::fill(diffs[ci].begin() + yo * w, diffs[ci].begin() + (yo + 1) * w, 0);
            else
              std::fill(diffs[ci].begin(), diffs[ci].end(), 0);
          }
          for (int ci = 0; ci < ncomp; ci++) first_row[ci] = true;
        } else {
          for (int col = 0; col < mcus_per_row; col++) {
            for (;;) {
              size_t pos0 = pos;
              uint64_t gb0 = get_buffer;
              int bl0 = bits_left;
              try {
                in_mcu = true;
                lossless_mcu(col, yo);
                in_mcu = false;
                break;
              } catch (NeedMore&) {
                in_mcu = false;
                pos = pos0;
                get_buffer = gb0;
                bits_left = bl0;
                feed_more();
              } catch (...) {
                in_mcu = false;
                throw;
              }
            }
          }
        }
        if (restart_interval) restart_rows_to_go--;
      }
      for (int i = 0; i < comps_in_scan; i++) {
        int ci = scan_comp[i];
        Component& c = comp[ci];
        int vrows = comps_in_scan == 1 ? mcu_rows_per_imcu : c.v;
        for (int r = 0; r < vrows; r++) {
          int y = imcu * vrows + r;
          if (y >= c.hb) break;
          undifference(ci, &diffs[ci][(size_t)r * c.wb_pad],
                       &lsamples[ci][(size_t)y * c.wb_pad]);
        }
      }
    }
  }

  // one scan, MCU by MCU, in the order of libjpeg's coefficient controller
  void decode_scan() {
    if (lossless) {
      decode_scan_lossless();
      return;
    }
    int16_t* blocks[10];
    if (comps_in_scan == 1) {
      Component& c = comp[scan_comp[0]];
      for (int imcu = 0; imcu < total_imcu_rows; imcu++) {
        int rows = c.v;
        if (imcu == total_imcu_rows - 1) {
          rows = c.hb % c.v;
          if (rows == 0) rows = c.v;
        }
        for (int y = 0; y < rows; y++) {
          int r = imcu * c.v + y;
          if (r >= c.hb) break;
          for (int col = 0; col < mcus_per_row; col++) {
            mcu_blocks(r, col, blocks);
            decode_one(imcu, blocks);
          }
        }
      }
    } else {
      for (int row = 0; row < mcu_rows_in_scan; row++)
        for (int col = 0; col < mcus_per_row; col++) {
          mcu_blocks(row, col, blocks);
          decode_one(row, blocks);
        }
    }
  }
  void decode_one(int imcu_row, int16_t** blocks) {
    if (!insufficient) last_good_imcu_row = imcu_row;
    imcu_in_progress = imcu_row;
    if (arith)
      decode_mcu_arith(blocks);
    else if (progressive)
      decode_mcu_progressive(blocks);
    else
      decode_mcu_sequential(blocks);
  }

  // ---------------------------------------------------- output side
  // jidctint.c's islow IDCT as libjpeg-turbo's SIMD version computes it
  // (jidctint-sse2.asm, -avx2.asm), which is what runs on x86-64: the
  // dequantisation keeps the low 16 bits of each product, the sums
  // in0 +- in4, in7 + in3 and in5 + in1 wrap at 16 bits, the other terms
  // are exact 32-bit multiply-adds of the original's constants regrouped
  // in pairs, pass 1 saturates its outputs to 16 bits (or, where rows 1-7
  // of the block are all zero, shifts the dequantised row 0 left by 2 in
  // 16 bits), and pass 2 saturates to -128..127 before adding 128. On
  // in-range data this is the C code's result; past it (a corrupt or
  // zero-filled block) it saturates where the C range-limit table wraps.
  static int32_t w32(int64_t x) { return (int32_t)(uint32_t)(uint64_t)x; }
  static int16_t sat16(int32_t x) {
    return (int16_t)(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
  }
  static void idct_1d(const int16_t* in, int stride, int32_t* out8) {
    const int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    int32_t i0 = in[0], i1 = in[stride], i2 = in[2 * stride], i3 = in[3 * stride],
            i4 = in[4 * stride], i5 = in[5 * stride], i6 = in[6 * stride], i7 = in[7 * stride];
    int32_t tmp3 = w32((int64_t)i2 * (F0541 + F0765) + (int64_t)i6 * F0541);
    int32_t tmp2 = w32((int64_t)i2 * F0541 + (int64_t)i6 * (F0541 - F1847));
    int32_t s04 = (int16_t)(i0 + i4), d04 = (int16_t)(i0 - i4);
    int32_t tmp0 = s04 * 8192, tmp1 = d04 * 8192;
    int32_t tmp10 = w32((int64_t)tmp0 + tmp3), tmp13 = w32((int64_t)tmp0 - tmp3);
    int32_t tmp11 = w32((int64_t)tmp1 + tmp2), tmp12 = w32((int64_t)tmp1 - tmp2);
    int32_t z3 = (int16_t)(i7 + i3), z4 = (int16_t)(i5 + i1);
    int32_t z3p = w32((int64_t)z3 * (F1175 - F1961) + (int64_t)z4 * F1175);
    int32_t z4p = w32((int64_t)z3 * F1175 + (int64_t)z4 * (F1175 - F0390));
    int32_t o0 = w32((int64_t)i7 * (F0298 - F0899) + (int64_t)i1 * -F0899);
    int32_t o3 = w32((int64_t)i7 * -F0899 + (int64_t)i1 * (F1501 - F0899));
    int32_t o1 = w32((int64_t)i5 * (F2053 - F2562) + (int64_t)i3 * -F2562);
    int32_t o2 = w32((int64_t)i5 * -F2562 + (int64_t)i3 * (F3072 - F2562));
    o0 = w32((int64_t)o0 + z3p);
    o1 = w32((int64_t)o1 + z4p);
    o2 = w32((int64_t)o2 + z3p);
    o3 = w32((int64_t)o3 + z4p);
    out8[0] = w32((int64_t)tmp10 + o3);
    out8[7] = w32((int64_t)tmp10 - o3);
    out8[1] = w32((int64_t)tmp11 + o2);
    out8[6] = w32((int64_t)tmp11 - o2);
    out8[2] = w32((int64_t)tmp12 + o1);
    out8[5] = w32((int64_t)tmp12 - o1);
    out8[3] = w32((int64_t)tmp13 + o0);
    out8[4] = w32((int64_t)tmp13 - o0);
  }
  static int32_t descale32(int32_t x, int n) {
    return w32((int64_t)x + (1 << (n - 1))) >> n;
  }
  static void idct_islow(const int16_t* in, const uint16_t* qtab, uint8_t* out, int stride) {
    int16_t deq[64], ws[64];
    bool ac_zero = true;
    for (int i = 8; i < 64; i++)
      if (in[i] != 0) ac_zero = false;
    for (int i = 0; i < 64; i++) deq[i] = (int16_t)(in[i] * (int16_t)qtab[i]);
    if (ac_zero) {
      for (int col = 0; col < 8; col++) {
        int16_t v = (int16_t)(deq[col] << 2);
        for (int r = 0; r < 8; r++) ws[r * 8 + col] = v;
      }
    } else {
      int32_t o[8];
      for (int col = 0; col < 8; col++) {
        idct_1d(deq + col, 8, o);
        for (int r = 0; r < 8; r++) ws[r * 8 + col] = sat16(descale32(o[r], 11));
      }
    }
    int32_t o[8];
    for (int row = 0; row < 8; row++) {
      idct_1d(ws + row * 8, 1, o);
      uint8_t* dst = out + (size_t)row * stride;
      for (int i = 0; i < 8; i++) {
        int32_t v = sat16(descale32(o[i], 18));
        v = v < -128 ? -128 : v > 127 ? 127 : v;
        dst[i] = (uint8_t)(v + 128);
      }
    }
  }

  // smoothing_ok: latches the coefficient bits; true where some of the
  // first nine AC coefficients are not fully known
  bool smoothing_ok(int latch[][10], int prev_latch[][10]) {
    if (!progressive) return false;
    bool useful = false;
    for (int ci = 0; ci < ncomp; ci++) {
      Component& c = comp[ci];
      if (!c.latched) return false;
      const uint16_t* q = c.q;
      if (q[0] == 0 || q[1] == 0 || q[8] == 0 || q[16] == 0 || q[9] == 0 || q[2] == 0 ||
          q[3] == 0 || q[10] == 0 || q[17] == 0 || q[24] == 0)
        return false;
      if (c.coef_bits[0] < 0) return false;
      latch[ci][0] = c.coef_bits[0];
      for (int k = 1; k < 10; k++) {
        prev_latch[ci][k] = input_scan_number > 1 ? c.prev_bits[k] : -1;
        latch[ci][k] = c.coef_bits[k];
        if (c.coef_bits[k] != 0) useful = true;
      }
    }
    return useful;
  }

  static int smooth_pred(int64_t num, int64_t q, int Al) {
    int pred;
    if (num >= 0) {
      pred = (int)(((q << 7) + num) / (q << 8));
      if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
    } else {
      pred = (int)(((q << 7) - num) / (q << 8));
      if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
      pred = -pred;
    }
    return pred;
  }

  // decompress_smooth_data for component ci into plane (stride pw)
  void smooth_component(int ci, const int* latch_cur, const int* latch_prev, uint8_t* plane,
                        int pw) {
    Component& c = comp[ci];
    int last_imcu = total_imcu_rows - 1;
    const uint16_t* qt = c.q;
    int64_t Q00 = qt[0], Q01 = qt[1], Q10 = qt[8], Q20 = qt[16], Q11 = qt[9], Q02 = qt[2];
    int64_t Q03 = qt[3], Q12 = qt[10], Q21 = qt[17], Q30 = qt[24];
    int16_t ws[64];
    for (int orow = 0; orow < total_imcu_rows; orow++) {
      int block_rows;
      if (orow < last_imcu) {
        block_rows = c.v;
      } else {
        block_rows = c.hb % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      const int* cb = orow > last_good_imcu_row ? latch_prev : latch_cur;
      bool change_dc = cb[1] == -1 && cb[2] == -1 && cb[3] == -1 && cb[4] == -1 &&
                       cb[5] == -1 && cb[6] == -1 && cb[7] == -1 && cb[8] == -1 &&
                       cb[9] == -1;
      int base = orow * c.v;  // buffer[0]
      for (int br = 0; br < block_rows; br++) {
        int cur = base + br;
        // the neighbour rows, by libjpeg-turbo's count of image block rows
        // (block_rows a row times the iMCU rows: in the last iMCU row
        // only the rows it holds)
        int ibr = orow * block_rows + br, ibrs = block_rows * total_imcu_rows;
        int prev = ibr > 0 ? cur - 1 : cur;
        int prev2 = ibr > 1 ? cur - 2 : prev;
        int next = ibr < ibrs - 1 ? cur + 1 : cur;
        int next2 = ibr < ibrs - 2 ? cur + 2 : next;
        int last_col = c.wb - 1;
        auto dcat = [&](int r, int col) -> int { return c.block(r, col)[0]; };
        int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13,
            DC14, DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
        for (int bn = 0; bn <= last_col; bn++) {
          memcpy(ws, c.block(cur, bn), sizeof(ws));
          auto cl = [&](int k) { return std::min(std::max(k, 0), last_col); };
          int cs[5] = {cl(bn - 2), cl(bn - 1), bn, cl(bn + 1), cl(bn + 2)};
          DC01 = dcat(prev2, cs[0]); DC02 = dcat(prev2, cs[1]); DC03 = dcat(prev2, cs[2]); DC04 = dcat(prev2, cs[3]); DC05 = dcat(prev2, cs[4]);
          DC06 = dcat(prev, cs[0]); DC07 = dcat(prev, cs[1]); DC08 = dcat(prev, cs[2]); DC09 = dcat(prev, cs[3]); DC10 = dcat(prev, cs[4]);
          DC11 = dcat(cur, cs[0]); DC12 = dcat(cur, cs[1]); DC13 = dcat(cur, cs[2]); DC14 = dcat(cur, cs[3]); DC15 = dcat(cur, cs[4]);
          DC16 = dcat(next, cs[0]); DC17 = dcat(next, cs[1]); DC18 = dcat(next, cs[2]); DC19 = dcat(next, cs[3]); DC20 = dcat(next, cs[4]);
          DC21 = dcat(next2, cs[0]); DC22 = dcat(next2, cs[1]); DC23 = dcat(next2, cs[2]); DC24 = dcat(next2, cs[3]); DC25 = dcat(next2, cs[4]);
          int Al;
          int64_t num;
          if ((Al = cb[1]) != 0 && ws[1] == 0) {
            num = Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                                      13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 -
                                      38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                                      13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                                   : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
            ws[1] = (int16_t)smooth_pred(num, Q01, Al);
          }
          if ((Al = cb[2]) != 0 && ws[8] == 0) {
            num = Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                      13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                                      13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                                      3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                   : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
            ws[8] = (int16_t)smooth_pred(num, Q10, Al);
          }
          if ((Al = cb[3]) != 0 && ws[16] == 0) {
            num = Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                                      14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 +
                                      2 * DC19 + DC23)
                                   : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
            ws[16] = (int16_t)smooth_pred(num, Q20, Al);
          }
          if ((Al = cb[4]) != 0 && ws[9] == 0) {
            num = Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                                      9 * DC19 + DC21 - DC25)
                                   : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                                      DC22 - DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
            ws[9] = (int16_t)smooth_pred(num, Q11, Al);
          }
          if ((Al = cb[5]) != 0 && ws[2] == 0) {
            num = Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                                      14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                                      2 * DC19)
                                   : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
            ws[2] = (int16_t)smooth_pred(num, Q02, Al);
          }
          if (change_dc) {
            if ((Al = cb[6]) != 0 && ws[3] == 0) {
              num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
              ws[3] = (int16_t)smooth_pred(num, Q03, Al);
            }
            if ((Al = cb[7]) != 0 && ws[10] == 0) {
              num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
              ws[10] = (int16_t)smooth_pred(num, Q12, Al);
            }
            if ((Al = cb[8]) != 0 && ws[17] == 0) {
              num = Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
              ws[17] = (int16_t)smooth_pred(num, Q21, Al);
            }
            if ((Al = cb[9]) != 0 && ws[24] == 0) {
              num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
              ws[24] = (int16_t)smooth_pred(num, Q30, Al);
            }
            num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                         6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                         152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 +
                         42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 -
                         6 * DC24 - 2 * DC25);
            int pred;
            if (num >= 0) {
              pred = (int)(((Q00 << 7) + num) / (Q00 << 8));
            } else {
              pred = (int)(((Q00 << 7) - num) / (Q00 << 8));
              pred = -pred;
            }
            ws[0] = (int16_t)pred;
          }
          idct_islow(ws, c.q, plane + (size_t)cur * 8 * pw + (size_t)bn * 8, pw);
        }
      }
    }
  }

  // the sample planes: every block of each component through the IDCT
  void sample_planes(std::vector<std::vector<uint8_t>>& planes, std::vector<int>& pws) {
    if (lossless) {
      planes = lsamples;
      pws.resize(ncomp);
      for (int ci = 0; ci < ncomp; ci++) pws[ci] = comp[ci].wb_pad;
      return;
    }
    int latch[10][10], prev_latch[10][10];
    bool smooth = smoothing_ok(latch, prev_latch);
    planes.resize(ncomp);
    pws.resize(ncomp);
    for (int ci = 0; ci < ncomp; ci++) {
      Component& c = comp[ci];
      int pw = c.wb_pad * 8;
      pws[ci] = pw;
      planes[ci].assign((size_t)c.hb_pad * 8 * pw, 0);
      if (smooth) {
        smooth_component(ci, latch[ci], prev_latch[ci], planes[ci].data(), pw);
        continue;
      }
      uint16_t q[64];
      if (c.latched)
        memcpy(q, c.q, sizeof(q));
      else
        memset(q, 0, sizeof(q));  // a component no scan carried
      for (int r = 0; r < c.hb; r++)
        for (int col = 0; col < c.wb; col++)
          idct_islow(c.block(r, col), q, planes[ci].data() + (size_t)r * 8 * pw + col * 8, pw);
    }
  }

  // jdsample.c: one component at full size, (height, width)
  void upsample(int ci, const std::vector<uint8_t>& plane, int pw, std::vector<uint8_t>& out) {
    Component& c = comp[ci];
    out.resize((size_t)height * width);
    int hx = max_h / c.h, vx = max_v / c.v;
    auto S = [&](int r, int col) -> int {
      r = std::min(std::max(r, 0), c.dh - 1);
      col = std::min(std::max(col, 0), c.dw - 1);
      return plane[(size_t)r * pw + col];
    };
    // a lossless frame is upsampled by replication (libjpeg's fancy
    // upsampling needs a DCT size above 1)
    bool fancy_h2 = c.dw > 2 && !lossless;
    for (int y = 0; y < height; y++) {
      uint8_t* o = &out[(size_t)y * width];
      if (lossless && !(hx == 1 && vx == 1)) {
        int sy = y / vx;
        for (int x = 0; x < width; x++) o[x] = (uint8_t)S(sy, x / hx);
      } else if (hx == 1 && vx == 1) {
        for (int x = 0; x < width; x++) o[x] = plane[(size_t)y * pw + x];
      } else if (hx == 2 && vx == 1) {
        for (int x = 0; x < width; x++) {
          int sx = x >> 1;
          if (!fancy_h2) {
            o[x] = (uint8_t)S(y, sx);
          } else if ((x & 1) == 0) {
            o[x] = (uint8_t)((S(y, sx) * 3 + S(y, sx - 1) + 1) >> 2);
          } else {
            o[x] = (uint8_t)((S(y, sx) * 3 + S(y, sx + 1) + 2) >> 2);
          }
        }
      } else if (hx == 1 && vx == 2) {
        int sy = y >> 1;
        int far = (y & 1) ? sy + 1 : sy - 1;
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; x++) o[x] = (uint8_t)((S(sy, x) * 3 + S(far, x) + bias) >> 2);
      } else if (hx == 2 && vx == 2 && fancy_h2) {
        int sy = y >> 1;
        int far = (y & 1) ? sy + 1 : sy - 1;
        auto colsum = [&](int col) { return S(sy, col) * 3 + S(far, col); };
        for (int x = 0; x < width; x++) {
          int sx = x >> 1;
          if ((x & 1) == 0)
            o[x] = (uint8_t)((colsum(sx) * 3 + colsum(sx - 1) + 8) >> 4);
          else
            o[x] = (uint8_t)((colsum(sx) * 3 + colsum(sx + 1) + 7) >> 4);
        }
      } else {
        int sy = y / vx;
        for (int x = 0; x < width; x++) o[x] = (uint8_t)S(sy, x / hx);
      }
    }
  }

  // jdcolor.c: the output image, (height, width, channels)
  void output(uint8_t* out, int channels) {
    std::vector<std::vector<uint8_t>> planes;
    std::vector<int> pws;
    sample_planes(planes, pws);
    std::vector<std::vector<uint8_t>> full(ncomp);
    for (int ci = 0; ci < ncomp; ci++) upsample(ci, planes[ci], pws[ci], full[ci]);
    size_t n = (size_t)height * width;
    if (channels == 1) {
      memcpy(out, full[0].data(), n);
      return;
    }
    if (color_override == 0 && channels != 3) {  // JCS_UNKNOWN: as they are
      for (size_t i = 0; i < n; i++)
        for (int ci = 0; ci < channels; ci++) out[(size_t)channels * i + ci] = full[ci][i];
      return;
    }
    if (channels == 4) {
      output_cmyk(out, full);
      return;
    }
    bool ycc = color_space_is_ycc();
    if (!ycc) {
      for (size_t i = 0; i < n; i++) {
        out[3 * i] = full[0][i];
        out[3 * i + 1] = full[1][i];
        out[3 * i + 2] = full[2][i];
      }
      return;
    }
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto FIX = [](double x) -> int64_t { return (int64_t)(x * 65536.0 + 0.5); };
    int crr[256], cbb[256];
    int64_t crg[256], cbg[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
      crr[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cbb[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      crg[i] = -FIX(0.71414) * x;
      cbg[i] = -FIX(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) -> uint8_t { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (size_t i = 0; i < n; i++) {
      int y = full[0][i], cb = full[1][i], cr = full[2][i];
      out[3 * i] = clamp(y + crr[cr]);
      out[3 * i + 1] = clamp(y + (int)((cbg[cb] + crg[cr]) >> SCALEBITS));
      out[3 * i + 2] = clamp(y + cbb[cb]);
    }
  }

  // jdcolor.c for four components: CMYK copied, YCCK through
  // ycck_cmyk_convert (YCbCr to RGB, inverted, K as it is)
  void output_cmyk(uint8_t* out, std::vector<std::vector<uint8_t>>& full) {
    size_t n = (size_t)height * width;
    bool ycck = color_override != 2 && saw_Adobe && adobe_transform != 0;
    if (!ycck) {
      for (size_t i = 0; i < n; i++)
        for (int k = 0; k < 4; k++) out[4 * i + k] = full[k][i];
      return;
    }
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto FIX = [](double x) -> int64_t { return (int64_t)(x * 65536.0 + 0.5); };
    int crr[256], cbb[256];
    int64_t crg[256], cbg[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
      crr[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cbb[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      crg[i] = -FIX(0.71414) * x;
      cbg[i] = -FIX(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) -> uint8_t { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (size_t i = 0; i < n; i++) {
      int y = full[0][i], cb = full[1][i], cr = full[2][i];
      out[4 * i] = clamp(255 - (y + crr[cr]));
      out[4 * i + 1] = clamp(255 - (y + (int)((cbg[cb] + crg[cr]) >> SCALEBITS)));
      out[4 * i + 2] = clamp(255 - (y + cbb[cb]));
      out[4 * i + 3] = full[3][i];
    }
  }

  // the scanlines libjpeg has output where an error stops the decode of
  // iMCU row imcu_in_progress of a single-scan file: the whole iMCU rows
  // before it, less the last row group of the one before where the
  // upsampler needs context rows (fancy h1v2 or h2v2) [jdmainct.c]
  int rows_output() const {
    int dct = lossless ? 1 : 8;
    bool context = false;
    for (int ci = 0; ci < ncomp && !lossless; ci++) {
      const Component& c = comp[ci];
      int hx = max_h / c.h, vx = max_v / c.v;
      if (vx == 2 && (hx == 1 || (hx == 2 && c.dw > 2))) context = true;
    }
    int k = imcu_in_progress;
    int rows = k * max_v * dct;
    if (context && k > 0) rows -= max_v;
    return std::min(std::max(rows, 0), height);
  }

  // jdapimin.c default_decompress_parms for three components
  bool color_space_is_ycc() const {
    if (color_override == 0 || color_override == 1) return color_override == 1;
    if (saw_JFIF) return true;
    if (saw_Adobe) return adobe_transform != 0;
    int c0 = comp[0].id, c1 = comp[1].id, c2 = comp[2].id;
    if (c0 == 82 && c1 == 71 && c2 == 66) return false;
    return !lossless;  // a lossless frame is taken for RGB
  }
};

}  // namespace

extern "C" {

static int decode_impl(const uint8_t* data, size_t len, int salvage, int color, int* info,
                       int* geom, uint8_t** out, char* msg, int msg_len) {
  if (!data || !info || !out) return -1;
  *out = nullptr;
  info[0] = 3;
  info[1] = info[2] = info[3] = info[4] = 0;
  Decoder* dp = new Decoder();
  Decoder& dec = *dp;
  dec.color_override = color;
  dec.d.assign(data, data + len);
  dec.file_len = len;
  if (salvage) {
    dec.d.push_back(0xFF);
    dec.d.push_back(0xD9);
  }
  dec.fed = std::min(kChunk, len);
  std::string err;
  int outcome = 3;
  bool rows_done = false;
  uint8_t* img = nullptr;
  int channels = 0;
  try {
    // jpeg_read_header: markers up to the first SOS
    for (;;) {
      if (!dec.read_markers()) {
        // EOI before any scan: a tables-only stream
        if (dec.saw_SOF) fail("Invalid JPEG file structure: missing SOS marker");
        throw Suspend{};
      }
      if (dec.comps_in_scan > 0) break;  // a pseudo SOS is passed over
    }
    // any count with the components unconverted (JCS_UNKNOWN) or raw
    bool any_count = color == 0 || color == 3;
    if (!any_count && dec.ncomp != 1 && dec.ncomp != 3 && dec.ncomp != 4)
      fail("unsupported: " + std::to_string(dec.ncomp) + " components");
    dec.initial_setup();
    channels = dec.ncomp == 1 ? 1 : dec.ncomp == 4 ? 4 : 3;
    if (any_count) channels = dec.ncomp;
    info[1] = dec.height;
    info[2] = dec.width;
    info[3] = channels;
    dec.has_multiple_scans = dec.comps_in_scan < dec.ncomp || dec.progressive;
    if (!dec.progressive) dec.std_huff_tables();  // jinit_huff_decoder only
    dec.start_input_pass();
    if (!dec.has_multiple_scans) {
      dec.single_scan = true;
      dec.decode_scan();
      dec.single_scan = false;
    } else {
      // jpeg_start_decompress: every scan into the coefficient buffer,
      // up to EOI
      dec.decode_scan();
      while (dec.read_markers()) {
        if (dec.comps_in_scan == 0) continue;  // a pseudo SOS
        dec.start_input_pass();
        dec.decode_scan();
      }
    }
    if (color == 3) {
      // jpeg_read_raw_data: each component's plane at its own size,
      // whole blocks, one after another
      std::vector<std::vector<uint8_t>> planes;
      std::vector<int> pws;
      dec.sample_planes(planes, pws);
      size_t total = 0;
      for (int ci = 0; ci < dec.ncomp; ci++) total += planes[ci].size();
      img = (uint8_t*)malloc(std::max<size_t>(total, 1));
      if (!img) fail("out of memory");
      size_t at = 0;
      for (int ci = 0; ci < dec.ncomp; ci++) {
        memcpy(img + at, planes[ci].data(), planes[ci].size());
        at += planes[ci].size();
        if (geom) {
          geom[4 * ci] = (int)(planes[ci].size() / pws[ci]);
          geom[4 * ci + 1] = pws[ci];
          geom[4 * ci + 2] = dec.comp[ci].h;
          geom[4 * ci + 3] = dec.comp[ci].v;
        }
      }
    } else {
      img = (uint8_t*)malloc((size_t)dec.height * dec.width * channels);
      if (!img) fail("out of memory");
      dec.output(img, channels);
    }
    rows_done = true;
    outcome = 0;
    if (!dec.has_multiple_scans) {
      // jpeg_finish_decompress: markers up to EOI
      for (;;) {
        if (!dec.read_markers()) break;
        fail("Invalid JPEG file structure: two SOS markers");
      }
    }
  } catch (Suspend&) {
    outcome = rows_done ? 0 : 2;
  } catch (Fail& f) {
    err = f.msg;
    outcome = rows_done ? 1 : 3;
    if (!rows_done && color != 3 && dec.single_scan && dec.rows_output() > 0) {
      // the scanlines output before the error, zeros after
      int rows = dec.rows_output();
      img = (uint8_t*)malloc((size_t)dec.height * dec.width * channels);
      if (img) {
        dec.output(img, channels);
        size_t line = (size_t)dec.width * channels;
        memset(img + (size_t)rows * line, 0, (size_t)(dec.height - rows) * line);
        info[4] = rows;
        outcome = 4;
        rows_done = true;
      }
    }
  } catch (NeedMore&) {
    err = "internal: unexpected NeedMore";
    outcome = rows_done ? 1 : 3;
  }
  if (!rows_done && img) {
    free(img);
    img = nullptr;
  }
  delete dp;
  info[0] = outcome;
  *out = img;
  if (msg && msg_len > 0) {
    size_t n = std::min(err.size(), (size_t)msg_len - 1);
    memcpy(msg, err.data(), n);
    msg[n] = 0;
  }
  return 0;
}

int jpegdec_decode_as(const uint8_t* data, size_t len, int salvage, int color, int* info,
                      uint8_t** out, char* msg, int msg_len) {
  return decode_impl(data, len, salvage, color, info, nullptr, out, msg, msg_len);
}

// color 3 of jpegdec_decode_as: the components' planes as
// jpeg_read_raw_data gives them (no upsampling, no colour conversion),
// one after another; geom[4 * ci ..]: the plane's rows and row length and
// the component's sampling factors (at most 10 components)
int jpegdec_decode_raw(const uint8_t* data, size_t len, int* info, int* geom, uint8_t** out,
                       char* msg, int msg_len) {
  return decode_impl(data, len, 0, 3, info, geom, out, msg, msg_len);
}

int jpegdec_decode(const uint8_t* data, size_t len, int salvage, int* info, uint8_t** out,
                   char* msg, int msg_len) {
  return jpegdec_decode_as(data, len, salvage, -1, info, out, msg, msg_len);
}

void jpegdec_free(uint8_t* p) { free(p); }

}  // extern "C"
