// rasterdec: the byte-stream decoders of the simple raster formats the
// port reads (io/rasterformats.py), as Pillow 12.1.0 decodes them:
//
// - tga_rle: TgaRleDecode.c. A packet's byte counts the pixel's bytes
//   (depth / 8, 0 for a 1-bit image, which then never fills a row); a
//   literal that crosses the end of a row goes on into the next rows; a
//   run that crosses it is Pillow's IMAGING_CODEC_OVERRUN.
// - pcx: PcxDecode.c. A run byte (two top bits set) repeats the next
//   byte; a run that crosses the end of a line (bytesperline x planes
//   bytes) stops there and sets the overrun error, which Pillow raises
//   once the image is done; where a plane's share of the line is longer
//   than its pixels' bytes, each plane after the first is moved down to
//   follow the one before (Pillow's fix for padded lines; the share is
//   the line over the raw mode's bits for 2- and 4-plane bit images,
//   else the line over its count of whole widths).
// - packbits: PackDecode.c, one PSD channel. 0x80 is no operation; a
//   run or a literal that crosses the end of a row is cut there.
// - sgi_rle: SgiRleDecode.c, 8 and 16 bits: the offset and length
//   tables, rows in any order, a row ended by a zero count or cut short
//   by its length (a last count byte that is not zero ends the image
//   with no error), the bounds checks against the file's last byte.
// - qoi: QoiImagePlugin.QoiDecoder (Python in Pillow): the six ops, the
//   64-entry index, the run; the end marker is not read.
// - clut8: LittleCMS's 8-bit evaluation of a 16-bit CLUT of three
//   inputs and outputs (PrelinEval8, or TetrahedralInterp16 on the
//   bytes times 257) and From16To8: each byte's base node, upper node
//   and rest from the caller's tables, the six tetrahedra in the C
//   code's int32 arithmetic. Pillow's convert("RGB") of "LAB" and every
//   embedded profile color/lcms.py resamples to a CLUT.
// - sun_rle: SunRleDecode.c. 0x80 0 is a literal 0x80, 0x80 n v a run
//   of n + 1 bytes v that goes on into the next rows; rows of
//   ceil(bits x xsize / 8) bytes (no 16-bit padding).
// - xbm: XbmDecode.c. Each "x" starts a hex byte (a character that is no
//   hex digit counts 0), rows of ceil(xsize / 8) bytes.
// - pcd: PcdDecode.c. Photo CD's base image, 768 x 512: pairs of luma
//   rows over one row of half-width Cb and Cr, each pixel turned to RGB
//   by Pillow's "YCC;P" unpacker (Kodak's PhotoYCC tables, below).
// - fli: FliDecode.c, one call on the bytes Pillow's load hands it
//   (frame 0, at most its frame size): the COLOR chunks skipped, SS2,
//   LC, BLACK, BRUN, COPY, PSTAMP; its bounds checks and error codes.
// - bcn: BcnDecode.c, BC1 to BC7: BC1's two 5-6-5 colours and their
//   thirds (c0 > c1) or mean and transparent black, BC2's 4-bit alpha,
//   BC3's interpolated alpha (BC4's grey, BC5's red and green, signed or
//   not), BC6H's 14 modes of half floats clamped to 8 bits, BC7's 8
//   modes; blocks past the edge cut.
// - blp_dxt: BlpImagePlugin's own DXT1/3/5 decode (Python in Pillow,
//   whose arithmetic differs from BcnDecode.c's).
// - bitdec: BitDecode.c as ImImagePlugin asks for it (fill 3, pad 8, no
//   sign, bottom-up rows): `bits`-bit unsigned samples read LSB first
//   into float32.
// - ycc_to_rgb, ycbcr_to_rgb: Pillow's PhotoYCC unpacker ("YCC;P") and
//   its fixed-point YCbCr to RGB conversion, their tables read off
//   Pillow 12.1.0 on all 2^24 triples.
//
// Every stream decoder reads the file from the image data's start to
// the file's end as Pillow's ImageFile.load feeds it (the chunk
// boundaries never matter to these decoders) and writes rows in stream
// order; the caller places and unpacks them.
//
// C ABI for ctypes. Return codes: 0 the image is done, 1 the data ended
// first (Pillow's "image file is truncated"), 2 Pillow's decoder error
// (IMAGING_CODEC_OVERRUN); qoi: 3 a short read of an RGB or RGBA op
// (Python's ValueError in Pillow), 1 the file ended at an op byte or a
// luma op's second byte (IndexError in Pillow).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {

// rows x row_bytes bytes of output; *done: the rows written.
int tga_rle(const uint8_t* data, size_t len, int depth, size_t row_bytes, int64_t rows,
            uint8_t* out, int64_t* done) {
  size_t pos = 0, x = 0;
  int64_t y = 0;
  *done = 0;
  std::vector<uint8_t> line(row_bytes + 1);
  for (;;) {
    if (pos >= len) return 1;
    const uint8_t c = data[pos];
    size_t n = (size_t)depth * ((c & 0x7f) + 1);
    if (c & 0x80) {
      if (len - pos < 1 + (size_t)depth) return 1;
      if (x + n > row_bytes) return 2;
      for (size_t i = 0; i < n; i += depth) std::memcpy(&line[x + i], data + pos + 1, depth);
      pos += 1 + depth;
    } else {
      if (len - pos < 1 + n) return 1;
      size_t extra = 0;
      if (x + n > row_bytes) {  // the rest goes on into the next rows
        extra = n - (row_bytes - x);
        n = row_bytes - x;
      }
      std::memcpy(&line[x], data + pos + 1, n);
      pos += 1 + n;
      for (;;) {
        x += n;
        if (x >= row_bytes) {
          std::memcpy(out + (size_t)y * row_bytes, line.data(), row_bytes);
          x = 0;
          *done = ++y;
          if (y >= rows) return 0;
        }
        if (extra == 0 || x > 0) break;
        n = extra < row_bytes ? extra : row_bytes;
        std::memcpy(&line[x], data + pos, n);
        pos += n;
        extra -= n;
      }
      continue;
    }
    x += n;
    if (x >= row_bytes) {
      std::memcpy(out + (size_t)y * row_bytes, line.data(), row_bytes);
      x = 0;
      *done = ++y;
      if (y >= rows) return 0;
    }
  }
}

// line_bytes: bytesperline x planes; bits: the raw mode's bits a pixel.
int pcx(const uint8_t* data, size_t len, int bits, int64_t xsize, size_t line_bytes, int64_t rows,
        uint8_t* out, int64_t* done) {
  *done = 0;
  if ((size_t)((xsize * bits + 7) / 8) > line_bytes) return 2;
  std::vector<uint8_t> line(line_bytes);
  size_t pos = 0, x = 0;
  int64_t y = 0;
  int err = 0;
  for (;;) {
    if (pos >= len) return 1;
    if ((data[pos] & 0xC0) == 0xC0) {
      if (len - pos < 2) return 1;
      int n = data[pos] & 0x3F;
      while (n > 0) {
        if (x >= line_bytes) {
          err = 2;
          break;
        }
        line[x++] = data[pos + 1];
        n--;
      }
      pos += 2;
    } else {
      line[x++] = data[pos++];
    }
    if (x >= line_bytes) {
      // each plane after the first moved down to follow the one before
      size_t width, bands, stride = 0;
      if (bits == 2 || bits == 4) {
        width = (size_t)(xsize + 7) / 8;
        bands = bits;
        stride = line_bytes / bits;
      } else {
        width = (size_t)xsize;
        bands = line_bytes / width;
        if (bands) stride = line_bytes / bands;
      }
      if (stride > width)
        for (size_t i = 1; i < bands; i++) std::memmove(&line[i * width], &line[i * stride], width);
      std::memcpy(out + (size_t)y * line_bytes, line.data(), line_bytes);
      x = 0;
      *done = ++y;
      if (y >= rows) return err;
    }
  }
}

// One channel of rows x row_bytes; *consumed: the bytes read.
int packbits(const uint8_t* data, size_t len, size_t row_bytes, int64_t rows, uint8_t* out,
             size_t* consumed) {
  std::vector<uint8_t> line(row_bytes);
  size_t pos = 0, x = 0;
  int64_t y = 0;
  *consumed = 0;
  for (;;) {
    if (pos >= len) return 1;
    const uint8_t c = data[pos];
    if (c & 0x80) {
      if (c == 0x80) {
        pos++;
        continue;
      }
      if (len - pos < 2) return 1;
      for (int n = 0; n <= 256 - c; n++, x++)
        if (x < row_bytes) line[x] = data[pos + 1];
      pos += 2;
    } else {
      size_t n = (size_t)c + 2;
      if (len - pos < n) return 1;
      for (size_t i = 1; i < n; i++, x++)
        if (x < row_bytes) line[x] = data[pos + i];
      pos += n;
    }
    if (x >= row_bytes) {
      std::memcpy(out + (size_t)y * row_bytes, line.data(), row_bytes);
      x = 0;
      if (++y >= rows) {
        *consumed = pos;
        return 0;
      }
    }
  }
}

static int expandrow(uint8_t* dest, const uint8_t* src, int64_t n, int z, int64_t xsize,
                     const uint8_t* end) {
  int64_t x = 0;
  for (; n > 0; n--) {
    if (src > end) return -1;
    uint8_t pixel = *src++;
    if (n == 1 && pixel != 0) return (int)n;
    uint8_t count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + count > end) return -1;
      while (count--) {
        *dest = *src++;
        dest += z;
      }
    } else {
      if (src > end) return -1;
      pixel = *src++;
      while (count--) {
        *dest = pixel;
        dest += z;
      }
    }
  }
  return 0;
}

static int expandrow2(uint8_t* dest, const uint8_t* src, int64_t n, int z, int64_t xsize,
                      const uint8_t* end) {
  int64_t x = 0;
  for (; n > 0; n--) {
    if (src + 1 > end) return -1;
    uint8_t pixel = src[1];
    src += 2;
    if (n == 1 && pixel != 0) return (int)n;
    uint8_t count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + 2 * count > end) return -1;
      while (count--) {
        std::memcpy(dest, src, 2);
        src += 2;
        dest += z * 2;
      }
    } else {
      if (src + 2 > end) return -1;
      while (count--) {
        std::memcpy(dest, src, 2);
        dest += z * 2;
      }
      src += 2;
    }
  }
  return 0;
}

// file: the whole file; out: ysize rows of xsize x bands x bpc bytes in
// image order (top first), rows never reached left as given (zeros).
int sgi_rle(const uint8_t* file, size_t len, int64_t xsize, int64_t ysize, int bands, int bpc,
            uint8_t* out) {
  const size_t head = 512;
  if (len < head) return 2;
  const int64_t bufsize = (int64_t)len - (int64_t)head;
  const int64_t tablen = bands * ysize;
  if (bufsize < 8 * tablen) return 2;
  const uint8_t* ptr = file + head;
  const uint8_t* end = ptr + bufsize - 1;
  std::vector<uint32_t> start(tablen), length(tablen);
  for (int64_t i = 0; i < tablen; i++) {
    const uint8_t* b = ptr + 4 * i;
    start[i] = (uint32_t)b[0] << 24 | (uint32_t)b[1] << 16 | (uint32_t)b[2] << 8 | b[3];
    b = ptr + 4 * (tablen + i);
    length[i] = (uint32_t)b[0] << 24 | (uint32_t)b[1] << 16 | (uint32_t)b[2] << 8 | b[3];
  }
  const size_t row = (size_t)xsize * bands * bpc;
  std::vector<uint8_t> line(row);
  int64_t y = ysize - 1;
  for (int64_t r = 0; r < ysize; r++, y--) {
    for (int ch = 0; ch < bands; ch++) {
      uint32_t off = start[r + ch * ysize];
      const uint32_t n = length[r + ch * ysize];
      if (off < head) return 2;
      off -= head;
      if ((uint32_t)(off + n) < off) return 2;  // the sum wraps
      // the length goes to Pillow's int argument
      const int64_t count = (int32_t)n;
      int status = bpc == 1
                       ? expandrow(&line[ch], ptr + off, count, bands, xsize, end)
                       : expandrow2(&line[ch * 2], ptr + off, count, bands, xsize, end);
      if (status == -1) return 2;
      if (status == 1) return 0;
    }
    std::memcpy(out + (size_t)y * row, line.data(), row);
  }
  return 0;
}

// out: npix x bands bytes.
int qoi(const uint8_t* data, size_t len, int64_t npix, int bands, uint8_t* out) {
  uint8_t index[64][4];
  bool seen[64] = {false};
  uint8_t prev[4] = {0, 0, 0, 255};
  const size_t dest = (size_t)npix * bands;
  size_t n = 0, pos = 0;
  auto put = [&](const uint8_t* v) {
    for (int i = 0; i < bands && n < dest; i++) out[n++] = v[i];
  };
  while (n < dest) {
    if (pos >= len) return 1;
    const uint8_t b = data[pos++];
    uint8_t v[4];
    if (b == 0xFE) {
      if (len - pos < 3) return 3;
      v[0] = data[pos], v[1] = data[pos + 1], v[2] = data[pos + 2], v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {
      if (len - pos < 4) return 3;
      std::memcpy(v, data + pos, 4);
      pos += 4;
    } else {
      const int op = b >> 6;
      if (op == 0) {
        if (seen[b & 63]) {
          std::memcpy(v, index[b & 63], 4);
        } else {
          v[0] = v[1] = v[2] = v[3] = 0;
        }
      } else if (op == 1) {
        v[0] = (uint8_t)(prev[0] + ((b >> 4) & 3) - 2);
        v[1] = (uint8_t)(prev[1] + ((b >> 2) & 3) - 2);
        v[2] = (uint8_t)(prev[2] + (b & 3) - 2);
        v[3] = prev[3];
      } else if (op == 2) {
        if (pos >= len) return 1;
        const uint8_t s = data[pos++];
        const int dg = (b & 63) - 32, dr = (s >> 4) - 8, db = (s & 15) - 8;
        v[0] = (uint8_t)(prev[0] + dg + dr);
        v[1] = (uint8_t)(prev[1] + dg);
        v[2] = (uint8_t)(prev[2] + dg + db);
        v[3] = prev[3];
      } else {
        for (int k = (b & 63) + 1; k > 0 && n < dest; k--) put(prev);
        continue;
      }
    }
    std::memcpy(prev, v, 4);
    const int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    std::memcpy(index[h], v, 4);
    seen[h] = true;
    put(v);
  }
  return 0;
}

// rgb: npix x 3 bytes; tables: for each input channel 256 base nodes,
// 256 upper nodes and 256 16-bit rests (int32, indexed by the byte);
// clut: n^3 x 3 16-bit values (the first channel slowest); out: npix x
// 3 bytes. Rest and the sums wrap as the C code's int32s do.
void clut8(const uint8_t* rgb, int64_t npix, const int32_t* tables,
           const uint16_t* clut, int n, uint8_t* out) {
  const int opta[3] = {n * n * 3, n * 3, 3};
  for (int64_t p = 0; p < npix; p++) {
    int i0[3], i1[3], r[3];
    for (int k = 0; k < 3; k++) {
      const int v = rgb[3 * p + k];
      i0[k] = tables[768 * k + v] * opta[k];
      i1[k] = tables[768 * k + 256 + v] * opta[k];
      r[k] = tables[768 * k + 512 + v];
    }
    const int x0 = i0[0], y0 = i0[1], z0 = i0[2];
    const int x1 = i1[0], y1 = i1[1], z1 = i1[2];
    const int rx = r[0], ry = r[1], rz = r[2];
    for (int c = 0; c < 3; c++) {
      auto d = [&](int x, int y, int z) { return (int32_t)clut[x + y + z + c]; };
      const int32_t c0 = d(x0, y0, z0);
      int32_t c1 = 0, c2 = 0, c3 = 0;
      if (rx >= ry && ry >= rz) {
        c1 = d(x1, y0, z0) - c0;
        c2 = d(x1, y1, z0) - d(x1, y0, z0);
        c3 = d(x1, y1, z1) - d(x1, y1, z0);
      } else if (rx >= rz && rz >= ry) {
        c1 = d(x1, y0, z0) - c0;
        c2 = d(x1, y1, z1) - d(x1, y0, z1);
        c3 = d(x1, y0, z1) - d(x1, y0, z0);
      } else if (rz >= rx && rx >= ry) {
        c1 = d(x1, y0, z1) - d(x0, y0, z1);
        c2 = d(x1, y1, z1) - d(x1, y0, z1);
        c3 = d(x0, y0, z1) - c0;
      } else if (ry >= rx && rx >= rz) {
        c1 = d(x1, y1, z0) - d(x0, y1, z0);
        c2 = d(x0, y1, z0) - c0;
        c3 = d(x1, y1, z1) - d(x1, y1, z0);
      } else if (ry >= rz && rz >= rx) {
        c1 = d(x1, y1, z1) - d(x0, y1, z1);
        c2 = d(x0, y1, z0) - c0;
        c3 = d(x0, y1, z1) - d(x0, y1, z0);
      } else {  // rz >= ry >= rx
        c1 = d(x1, y1, z1) - d(x0, y1, z1);
        c2 = d(x0, y1, z1) - d(x0, y0, z1);
        c3 = d(x0, y0, z1) - c0;
      }
      const int32_t rest = (int32_t)((uint32_t)c1 * (uint32_t)rx + (uint32_t)c2 * (uint32_t)ry +
                                     (uint32_t)c3 * (uint32_t)rz + 0x8001u);
      const int32_t s = (int32_t)((uint32_t)rest + (uint32_t)(rest >> 16));
      const uint32_t o16 = ((uint32_t)c0 + (uint32_t)(s >> 16)) & 0xFFFF;
      out[3 * p + c] = (uint8_t)(((o16 * 65281u + 8388608u) >> 24) & 0xFF);
    }
  }
}

// sun_rle: out rows x row_bytes bytes.
int sun_rle(const uint8_t* data, size_t len, size_t row_bytes, int64_t rows, uint8_t* out) {
  size_t pos = 0, x = 0;
  int64_t y = 0;
  std::vector<uint8_t> buf(row_bytes);
  for (;;) {
    size_t n;
    size_t extra = 0;
    uint8_t extra_v = 0;
    if (pos >= len) return 1;
    if (data[pos] == 0x80) {
      if (len - pos < 2) return 1;
      n = data[pos + 1];
      if (n == 0) {
        n = 1;
        buf[x] = 0x80;
        pos += 2;
      } else {
        if (len - pos < 3) return 1;
        n += 1;
        const uint8_t v = data[pos + 2];
        if (x + n > row_bytes) {
          extra = n - (row_bytes - x);
          n = row_bytes - x;
          extra_v = v;
        }
        std::memset(buf.data() + x, v, n);
        pos += 3;
      }
    } else {
      n = 1;
      buf[x] = data[pos];
      pos += 1;
    }
    for (;;) {
      x += n;
      if (x >= row_bytes) {
        std::memcpy(out + (size_t)y * row_bytes, buf.data(), row_bytes);
        x = 0;
        if (++y >= rows) return 0;
      }
      if (extra == 0 || x > 0) break;
      n = extra >= row_bytes ? row_bytes : extra;
      std::memset(buf.data(), extra_v, n);
      extra -= n;
    }
  }
}

static inline int hexv(uint8_t v) {
  return v >= '0' && v <= '9' ? v - '0' : v >= 'a' && v <= 'f' ? v - 'a' + 10
         : v >= 'A' && v <= 'F' ? v - 'A' + 10 : 0;
}

// xbm: out rows x row_bytes bytes, as stored (bits LSB first).
int xbm(const uint8_t* data, size_t len, size_t row_bytes, int64_t rows, uint8_t* out) {
  size_t pos = 0, x = 0;
  int64_t y = 0;
  for (;;) {
    while (pos < len && data[pos] != 'x') pos++;
    if (len - pos < 3) return 1;
    out[(size_t)y * row_bytes + x] = (uint8_t)((hexv(data[pos + 1]) << 4) + hexv(data[pos + 2]));
    if (++x >= row_bytes) {
      x = 0;
      if (++y >= rows) return 0;
    }
    pos += 3;
  }
}

static const int16_t PYCC_L[256] = {
    0, 1, 3, 4, 5, 7, 8, 10, 11, 12, 14, 15, 16, 18, 19, 20,
    22, 23, 24, 26, 27, 29, 30, 31, 33, 34, 35, 37, 38, 39, 41, 42,
    43, 45, 46, 48, 49, 50, 52, 53, 54, 56, 57, 58, 60, 61, 62, 64,
    65, 67, 68, 69, 71, 72, 73, 75, 76, 77, 79, 80, 82, 83, 84, 86,
    87, 88, 90, 91, 92, 94, 95, 96, 98, 99, 101, 102, 103, 105, 106, 107,
    109, 110, 111, 113, 114, 115, 117, 118, 120, 121, 122, 124, 125, 126, 128, 129,
    130, 132, 133, 134, 136, 137, 139, 140, 141, 143, 144, 145, 147, 148, 149, 151,
    152, 153, 155, 156, 158, 159, 160, 162, 163, 164, 166, 167, 168, 170, 171, 173,
    174, 175, 177, 178, 179, 181, 182, 183, 185, 186, 187, 189, 190, 192, 193, 194,
    196, 197, 198, 200, 201, 202, 204, 205, 206, 208, 209, 211, 212, 213, 215, 216,
    217, 219, 220, 221, 223, 224, 225, 227, 228, 230, 231, 232, 234, 235, 236, 238,
    239, 240, 242, 243, 245, 246, 247, 249, 250, 251, 253, 254, 255, 257, 258, 259,
    261, 262, 264, 265, 266, 268, 269, 270, 272, 273, 274, 276, 277, 278, 280, 281,
    283, 284, 285, 287, 288, 289, 291, 292, 293, 295, 296, 297, 299, 300, 302, 303,
    304, 306, 307, 308, 310, 311, 312, 314, 315, 317, 318, 319, 321, 322, 323, 325,
    326, 327, 329, 330, 331, 333, 334, 336, 337, 338, 340, 341, 342, 344, 345, 346,
};
static const int16_t PYCC_CB[256] = {
    -345, -343, -341, -338, -336, -334, -332, -329, -327, -325, -323, -321, -318, -316, -314, -312,
    -310, -307, -305, -303, -301, -298, -296, -294, -292, -290, -287, -285, -283, -281, -278, -276,
    -274, -272, -270, -267, -265, -263, -261, -258, -256, -254, -252, -250, -247, -245, -243, -241,
    -239, -236, -234, -232, -230, -227, -225, -223, -221, -219, -216, -214, -212, -210, -207, -205,
    -203, -201, -199, -196, -194, -192, -190, -188, -185, -183, -181, -179, -176, -174, -172, -170,
    -168, -165, -163, -161, -159, -156, -154, -152, -150, -148, -145, -143, -141, -139, -137, -134,
    -132, -130, -128, -125, -123, -121, -119, -117, -114, -112, -110, -108, -105, -103, -101, -99,
    -97, -94, -92, -90, -88, -85, -83, -81, -79, -77, -74, -72, -70, -68, -66, -63,
    -61, -59, -57, -54, -52, -50, -48, -46, -43, -41, -39, -37, -34, -32, -30, -28,
    -26, -23, -21, -19, -17, -15, -12, -10, -8, -6, -3, -1, 0, 2, 4, 7,
    9, 11, 13, 16, 18, 20, 22, 24, 27, 29, 31, 33, 35, 38, 40, 42,
    44, 47, 49, 51, 53, 55, 58, 60, 62, 64, 67, 69, 71, 73, 75, 78,
    80, 82, 84, 86, 89, 91, 93, 95, 98, 100, 102, 104, 106, 109, 111, 113,
    115, 118, 120, 122, 124, 126, 129, 131, 133, 135, 138, 140, 142, 144, 146, 149,
    151, 153, 155, 157, 160, 162, 164, 166, 169, 171, 173, 175, 177, 180, 182, 184,
    186, 189, 191, 193, 195, 197, 200, 202, 204, 206, 208, 211, 213, 215, 217, 220,
};
static const int16_t PYCC_CR[256] = {
    -249, -247, -245, -243, -241, -239, -238, -236, -234, -232, -230, -229, -227, -225, -223, -221,
    -219, -218, -216, -214, -212, -210, -208, -207, -205, -203, -201, -199, -198, -196, -194, -192,
    -190, -188, -187, -185, -183, -181, -179, -178, -176, -174, -172, -170, -168, -167, -165, -163,
    -161, -159, -157, -156, -154, -152, -150, -148, -147, -145, -143, -141, -139, -137, -136, -134,
    -132, -130, -128, -127, -125, -123, -121, -119, -117, -116, -114, -112, -110, -108, -106, -105,
    -103, -101, -99, -97, -96, -94, -92, -90, -88, -86, -85, -83, -81, -79, -77, -76,
    -74, -72, -70, -68, -66, -65, -63, -61, -59, -57, -55, -54, -52, -50, -48, -46,
    -45, -43, -41, -39, -37, -35, -34, -32, -30, -28, -26, -25, -23, -21, -19, -17,
    -15, -14, -12, -10, -8, -6, -4, -3, -1, 0, 2, 4, 5, 7, 9, 11,
    13, 15, 16, 18, 20, 22, 24, 26, 27, 29, 31, 33, 35, 36, 38, 40,
    42, 44, 46, 47, 49, 51, 53, 55, 56, 58, 60, 62, 64, 66, 67, 69,
    71, 73, 75, 77, 78, 80, 82, 84, 86, 87, 89, 91, 93, 95, 97, 98,
    100, 102, 104, 106, 107, 109, 111, 113, 115, 117, 118, 120, 122, 124, 126, 128,
    129, 131, 133, 135, 137, 138, 140, 142, 144, 146, 148, 149, 151, 153, 155, 157,
    158, 160, 162, 164, 166, 168, 169, 171, 173, 175, 177, 179, 180, 182, 184, 186,
    188, 189, 191, 193, 195, 197, 199, 200, 202, 204, 206, 208, 209, 211, 213, 215,
};
static const int16_t PYCC_GB[256] = {
    67, 67, 66, 66, 65, 65, 65, 64, 64, 63, 63, 62, 62, 62, 61, 61,
    60, 60, 59, 59, 59, 58, 58, 57, 57, 56, 56, 56, 55, 55, 54, 54,
    53, 53, 52, 52, 52, 51, 51, 50, 50, 49, 49, 49, 48, 48, 47, 47,
    46, 46, 46, 45, 45, 44, 44, 43, 43, 43, 42, 42, 41, 41, 40, 40,
    40, 39, 39, 38, 38, 37, 37, 37, 36, 36, 35, 35, 34, 34, 34, 33,
    33, 32, 32, 31, 31, 31, 30, 30, 29, 29, 28, 28, 28, 27, 27, 26,
    26, 25, 25, 25, 24, 24, 23, 23, 22, 22, 22, 21, 21, 20, 20, 19,
    19, 19, 18, 18, 17, 17, 16, 16, 15, 15, 15, 14, 14, 13, 13, 12,
    12, 12, 11, 11, 10, 10, 9, 9, 9, 8, 8, 7, 7, 6, 6, 6,
    5, 5, 4, 4, 3, 3, 3, 2, 2, 1, 1, 0, 0, 0, 0, 0,
    -1, -1, -2, -2, -2, -3, -3, -4, -4, -5, -5, -5, -6, -6, -7, -7,
    -8, -8, -8, -9, -9, -10, -10, -11, -11, -11, -12, -12, -13, -13, -14, -14,
    -14, -15, -15, -16, -16, -17, -17, -18, -18, -18, -19, -19, -20, -20, -21, -21,
    -21, -22, -22, -23, -23, -24, -24, -24, -25, -25, -26, -26, -27, -27, -27, -28,
    -28, -29, -29, -30, -30, -30, -31, -31, -32, -32, -33, -33, -33, -34, -34, -35,
    -35, -36, -36, -36, -37, -37, -38, -38, -39, -39, -39, -40, -40, -41, -41, -42,
};
static const int16_t PYCC_GR[256] = {
    127, 126, 125, 124, 123, 122, 121, 121, 120, 119, 118, 117, 116, 115, 114, 113,
    112, 111, 110, 109, 108, 108, 107, 106, 105, 104, 103, 102, 101, 100, 99, 98,
    97, 96, 95, 95, 94, 93, 92, 91, 90, 89, 88, 87, 86, 85, 84, 83,
    83, 82, 81, 80, 79, 78, 77, 76, 75, 74, 73, 72, 71, 70, 70, 69,
    68, 67, 66, 65, 64, 63, 62, 61, 60, 59, 58, 57, 57, 56, 55, 54,
    53, 52, 51, 50, 49, 48, 47, 46, 45, 45, 44, 43, 42, 41, 40, 39,
    38, 37, 36, 35, 34, 33, 32, 32, 31, 30, 29, 28, 27, 26, 25, 24,
    23, 22, 21, 20, 19, 19, 18, 17, 16, 15, 14, 13, 12, 11, 10, 9,
    8, 7, 6, 6, 5, 4, 3, 2, 1, 0, 0, -1, -2, -3, -4, -5,
    -5, -6, -7, -8, -9, -10, -11, -12, -13, -14, -15, -16, -17, -18, -18, -19,
    -20, -21, -22, -23, -24, -25, -26, -27, -28, -29, -30, -31, -31, -32, -33, -34,
    -35, -36, -37, -38, -39, -40, -41, -42, -43, -44, -44, -45, -46, -47, -48, -49,
    -50, -51, -52, -53, -54, -55, -56, -56, -57, -58, -59, -60, -61, -62, -63, -64,
    -65, -66, -67, -68, -69, -69, -70, -71, -72, -73, -74, -75, -76, -77, -78, -79,
    -80, -81, -82, -82, -83, -84, -85, -86, -87, -88, -89, -90, -91, -92, -93, -94,
    -94, -95, -96, -97, -98, -99, -100, -101, -102, -103, -104, -105, -106, -107, -107, -108,
};
static const int16_t YCC_R[256] = {
    -180, -179, -177, -176, -174, -173, -172, -170, -169, -167, -166, -165, -163, -162, -160, -159,
    -158, -156, -155, -153, -152, -150, -149, -148, -146, -145, -143, -142, -141, -139, -138, -136,
    -135, -134, -132, -131, -129, -128, -127, -125, -124, -122, -121, -120, -118, -117, -115, -114,
    -113, -111, -110, -108, -107, -106, -104, -103, -101, -100, -99, -97, -96, -94, -93, -92,
    -90, -89, -87, -86, -85, -83, -82, -80, -79, -78, -76, -75, -73, -72, -71, -69,
    -68, -66, -65, -64, -62, -61, -59, -58, -57, -55, -54, -52, -51, -50, -48, -47,
    -45, -44, -43, -41, -40, -38, -37, -36, -34, -33, -31, -30, -29, -27, -26, -24,
    -23, -22, -20, -19, -17, -16, -14, -13, -12, -10, -9, -7, -6, -5, -3, -2,
    0, 1, 2, 4, 5, 7, 8, 9, 11, 12, 14, 15, 16, 18, 19, 21,
    22, 23, 25, 26, 28, 29, 30, 32, 33, 35, 36, 37, 39, 40, 42, 43,
    44, 46, 47, 49, 50, 51, 53, 54, 56, 57, 58, 60, 61, 63, 64, 65,
    67, 68, 70, 71, 72, 74, 75, 77, 78, 79, 81, 82, 84, 85, 86, 88,
    89, 91, 92, 93, 95, 96, 98, 99, 100, 102, 103, 105, 106, 107, 109, 110,
    112, 113, 114, 116, 117, 119, 120, 121, 123, 124, 126, 127, 128, 130, 131, 133,
    134, 136, 137, 138, 140, 141, 143, 144, 145, 147, 148, 150, 151, 152, 154, 155,
    157, 158, 159, 161, 162, 164, 165, 166, 168, 169, 171, 172, 173, 175, 176, 178,
};
static const int16_t YCC_B[256] = {
    -227, -226, -224, -222, -220, -218, -217, -215, -213, -211, -210, -208, -206, -204, -202, -201,
    -199, -197, -195, -194, -192, -190, -188, -187, -185, -183, -181, -179, -178, -176, -174, -172,
    -171, -169, -167, -165, -164, -162, -160, -158, -156, -155, -153, -151, -149, -148, -146, -144,
    -142, -140, -139, -137, -135, -133, -132, -130, -128, -126, -125, -123, -121, -119, -117, -116,
    -114, -112, -110, -109, -107, -105, -103, -101, -100, -98, -96, -94, -93, -91, -89, -87,
    -86, -84, -82, -80, -78, -77, -75, -73, -71, -70, -68, -66, -64, -62, -61, -59,
    -57, -55, -54, -52, -50, -48, -47, -45, -43, -41, -39, -38, -36, -34, -32, -31,
    -29, -27, -25, -24, -22, -20, -18, -16, -15, -13, -11, -9, -8, -6, -4, -2,
    0, 1, 3, 5, 7, 8, 10, 12, 14, 15, 17, 19, 21, 23, 24, 26,
    28, 30, 31, 33, 35, 37, 38, 40, 42, 44, 46, 47, 49, 51, 53, 54,
    56, 58, 60, 62, 63, 65, 67, 69, 70, 72, 74, 76, 77, 79, 81, 83,
    85, 86, 88, 90, 92, 93, 95, 97, 99, 101, 102, 104, 106, 108, 109, 111,
    113, 115, 116, 118, 120, 122, 124, 125, 127, 129, 131, 132, 134, 136, 138, 139,
    141, 143, 145, 147, 148, 150, 152, 154, 155, 157, 159, 161, 163, 164, 166, 168,
    170, 171, 173, 175, 177, 178, 180, 182, 184, 186, 187, 189, 191, 193, 194, 196,
    198, 200, 202, 203, 205, 207, 209, 210, 212, 214, 216, 217, 219, 221, 223, 225,
};
static const int16_t YCC_GB[256] = {
    2817, 2773, 2761, 2753, 2707, 2697, 2653, 2643, 2633, 2587, 2579, 2567, 2523, 2514, 2501, 2459,
    2448, 2437, 2394, 2382, 2373, 2328, 2318, 2308, 2263, 2254, 2242, 2199, 2187, 2177, 2134, 2121,
    2113, 2068, 2057, 2048, 2003, 1993, 1948, 1939, 1928, 1883, 1875, 1862, 1819, 1809, 1797, 1755,
    1743, 1733, 1689, 1678, 1669, 1623, 1614, 1603, 1559, 1549, 1537, 1495, 1483, 1473, 1430, 1417,
    1409, 1364, 1353, 1344, 1299, 1289, 1243, 1235, 1223, 1179, 1170, 1157, 1115, 1104, 1093, 1050,
    1038, 1029, 984, 974, 964, 919, 910, 898, 855, 844, 833, 791, 778, 769, 725, 713,
    705, 659, 649, 605, 595, 585, 539, 531, 519, 475, 466, 453, 411, 399, 389, 345,
    334, 325, 279, 270, 259, 215, 205, 193, 151, 139, 129, 86, 73, 65, 20, 9,
    0, -45, -55, -99, -109, -119, -165, -173, -185, -229, -238, -251, -293, -304, -315, -358,
    -370, -379, -424, -434, -444, -489, -499, -511, -553, -565, -575, -618, -631, -639, -684, -695,
    -704, -749, -759, -804, -813, -824, -869, -877, -890, -933, -943, -955, -997, -1009, -1019, -1063,
    -1074, -1083, -1129, -1138, -1149, -1193, -1203, -1215, -1257, -1269, -1279, -1322, -1335, -1343, -1389, -1399,
    -1443, -1453, -1463, -1509, -1517, -1529, -1573, -1582, -1595, -1637, -1648, -1659, -1702, -1714, -1723, -1768,
    -1778, -1788, -1833, -1842, -1854, -1897, -1908, -1919, -1961, -1974, -1983, -2027, -2039, -2047, -2093, -2103,
    -2147, -2157, -2167, -2213, -2221, -2234, -2277, -2287, -2299, -2341, -2353, -2363, -2407, -2418, -2427, -2473,
    -2482, -2493, -2537, -2547, -2559, -2601, -2613, -2623, -2666, -2679, -2687, -2732, -2743, -2752, -2797, -2807,
};
static const int16_t YCC_GR[256] = {
    5869, 5815, 5759, 5737, 5682, 5627, 5605, 5549, 5495, 5439, 5417, 5362, 5307, 5285, 5229, 5175,
    5119, 5097, 5043, 4987, 4965, 4909, 4855, 4799, 4777, 4723, 4667, 4645, 4589, 4535, 4479, 4457,
    4403, 4347, 4325, 4270, 4215, 4159, 4137, 4083, 4027, 4005, 3950, 3895, 3839, 3818, 3763, 3707,
    3685, 3630, 3575, 3519, 3498, 3443, 3387, 3365, 3310, 3255, 3199, 3178, 3123, 3067, 3046, 2990,
    2935, 2879, 2858, 2803, 2747, 2726, 2670, 2615, 2559, 2538, 2483, 2427, 2406, 2350, 2295, 2240,
    2218, 2163, 2107, 2086, 2030, 1975, 1920, 1898, 1843, 1787, 1766, 1710, 1655, 1600, 1578, 1523,
    1468, 1446, 1390, 1335, 1280, 1258, 1203, 1148, 1126, 1070, 1016, 960, 938, 883, 828, 806,
    750, 696, 640, 618, 563, 508, 486, 430, 376, 320, 298, 244, 188, 166, 110, 56,
    0, -21, -75, -131, -153, -209, -263, -285, -341, -395, -451, -473, -528, -583, -605, -661,
    -715, -771, -793, -848, -903, -925, -981, -1035, -1091, -1113, -1168, -1223, -1245, -1300, -1355, -1411,
    -1433, -1488, -1543, -1565, -1620, -1675, -1731, -1752, -1808, -1863, -1885, -1940, -1995, -2051, -2072, -2128,
    -2183, -2205, -2260, -2315, -2371, -2392, -2448, -2503, -2524, -2580, -2635, -2691, -2712, -2768, -2823, -2844,
    -2900, -2955, -3011, -3032, -3088, -3143, -3164, -3220, -3275, -3330, -3352, -3408, -3463, -3484, -3540, -3595,
    -3650, -3672, -3728, -3783, -3804, -3860, -3915, -3970, -3992, -4048, -4102, -4124, -4180, -4235, -4290, -4312,
    -4368, -4422, -4444, -4500, -4554, -4610, -4632, -4688, -4742, -4764, -4820, -4874, -4930, -4952, -5008, -5062,
    -5084, -5140, -5194, -5250, -5272, -5327, -5382, -5404, -5460, -5514, -5570, -5592, -5647, -5702, -5724, -5780,
};

static inline uint8_t clamp8(int v) { return v <= 0 ? 0 : v >= 255 ? 255 : (uint8_t)v; }

// PhotoYCC (Y, Cb, Cr) to RGB, as Pillow's "YCC;P" unpacker.
static inline void pycc(uint8_t* o, int y, int cb, int cr) {
  const int l = PYCC_L[y];
  o[0] = clamp8(l + PYCC_CR[cr]);
  o[1] = clamp8(l + PYCC_GR[cr] + PYCC_GB[cb]);
  o[2] = clamp8(l + PYCC_CB[cb]);
}

void ycc_to_rgb(const uint8_t* in, int64_t npix, uint8_t* out) {
  for (int64_t p = 0; p < npix; p++) pycc(out + 3 * p, in[3 * p], in[3 * p + 1], in[3 * p + 2]);
}

void ycbcr_to_rgb(const uint8_t* in, int64_t npix, uint8_t* out) {
  for (int64_t p = 0; p < npix; p++) {
    const int y = in[3 * p], cb = in[3 * p + 1], cr = in[3 * p + 2];
    out[3 * p] = clamp8(y + YCC_R[cr]);
    out[3 * p + 1] = clamp8(y + ((YCC_GB[cb] + YCC_GR[cr]) >> 6));
    out[3 * p + 2] = clamp8(y + YCC_B[cb]);
  }
}

// pcd: out 512 x 768 x 3 bytes of RGB; 0 done, 1 the data ended first.
int pcd(const uint8_t* data, size_t len, uint8_t* out) {
  const int xs = 768, ys = 512;
  const size_t chunk = 3 * (size_t)xs;
  size_t pos = 0;
  for (int y = 0; y < ys; y += 2) {
    if (len - pos < chunk || pos > len) return 1;
    const uint8_t* p = data + pos;
    for (int k = 0; k < 2; k++) {
      uint8_t* o = out + (size_t)(y + k) * xs * 3;
      for (int x = 0; x < xs; x++)
        pycc(o + 3 * x, p[x + k * xs], p[(x + 4 * xs) / 2], p[(x + 5 * xs) / 2]);
    }
    pos += chunk;
  }
  return 0;
}

static inline int32_t fli_i32(const uint8_t* p) {
  return (int32_t)((uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
                   (uint32_t)p[3] << 24);
}
static inline int fli_i16(const uint8_t* p) { return p[0] | p[1] << 8; }

// fli: one call of FliDecode.c on `bytes` bytes into the xs x ys image
// `im`. Returns the bytes consumed (>= 0: it wants more data) or -1
// (the frame is done) with *err Pillow's error code (0, -1 overrun,
// -2 broken, -3 unknown).
int64_t fli(const uint8_t* buf, int64_t bytes, int xs, int ys, uint8_t* im, int* err) {
  *err = 0;
  if (bytes < 4) return 0;
  const uint8_t* ptr = buf;
  const int64_t framesize = (uint32_t)fli_i32(ptr);
  if (bytes + (bytes % 2) < framesize) return 0;
  if (bytes < 8) return *err = -1, -1;
  if (fli_i16(ptr + 4) != 0xF1FA) return *err = -3, -1;
  const int chunks = fli_i16(ptr + 6);
  ptr += 16;
  bytes -= 16;
#define OOB(o) if ((data + (o)) > ptr + bytes) return *err = -1, -1;
  for (int c = 0; c < chunks; c++) {
    if (bytes < 10) return *err = -1, -1;
    const uint8_t* data = ptr + 6;
    int x = 0, y, i = 0, j, l, lines, ymax;
    switch (fli_i16(ptr + 4)) {
      case 4:
      case 11:
        break;
      case 7: {
        lines = fli_i16(data);
        data += 2;
        for (l = y = 0; l < lines && y < ys; l++, y++) {
          uint8_t* row = im + (size_t)y * xs;
          int p, packets;
          OOB(2)
          packets = fli_i16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= ys) return *err = -1, -1;
              row = im + (size_t)y * xs;
            } else {
              row[xs - 1] = (uint8_t)packets;
            }
            OOB(2)
            packets = fli_i16(data);
            data += 2;
          }
          for (p = x = 0; p < packets; p++) {
            OOB(2)
            x += data[0];
            if (data[1] >= 128) {
              OOB(4)
              i = 256 - data[1];
              if (x + i + i > xs) break;
              for (j = 0; j < i; j++) {
                row[x++] = data[2];
                row[x++] = data[3];
              }
              data += 4;
            } else {
              i = 2 * (int)data[1];
              if (x + i > xs) break;
              OOB(2 + i)
              std::memcpy(row + x, data + 2, i);
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) return *err = -1, -1;
        break;
      }
      case 12: {
        y = fli_i16(data);
        ymax = y + fli_i16(data + 2);
        data += 4;
        for (; y < ymax && y < ys; y++) {
          uint8_t* out = im + (size_t)y * xs;
          OOB(1)
          int p, packets = *data++;
          for (p = x = 0; p < packets; p++, x += i) {
            OOB(2)
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > xs) break;
              OOB(3)
              std::memset(out + x, data[2], i);
              data += 3;
            } else {
              i = data[1];
              if (x + i > xs) break;
              OOB(2 + i)
              std::memcpy(out + x, data + 2, i);
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) return *err = -1, -1;
        break;
      }
      case 13:
        std::memset(im, 0, (size_t)xs * ys);
        break;
      case 15:
        for (y = 0; y < ys; y++) {
          uint8_t* out = im + (size_t)y * xs;
          data += 1;
          for (x = 0; x < xs; x += i) {
            OOB(2)
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > xs) break;
              OOB(i + 1)
              std::memcpy(out + x, data + 1, i);
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > xs) break;
              std::memset(out + x, data[1], i);
              data += 2;
            }
          }
          if (x != xs) return *err = -1, -1;
        }
        break;
      case 16:
        if (INT32_MAX / xs < ys) return *err = -1, -1;
        if (data + (int64_t)xs * ys > ptr + bytes) return ptr - buf;
        for (y = 0; y < ys; y++) {
          std::memcpy(im + (size_t)y * xs, data, xs);
          data += xs;
        }
        break;
      case 18:
        break;
      default:
        return *err = -3, -1;
    }
    const int64_t advance = fli_i32(ptr);
    if (advance == 0) return *err = -2, -1;
    if (advance < 0 || advance > bytes) return *err = -1, -1;
    ptr += advance;
    bytes -= advance;
  }
#undef OOB
  return -1;
}

// -- bcn: BcnDecode.c ---------------------------------------------------

namespace {

struct Rgba {
  uint8_t r, g, b, a;
};

// decode_565: each field's top bits replicated into its low bits
Rgba from565(int c) {
  int r = (c >> 11) & 31, g = (c >> 5) & 63, b = c & 31;
  return Rgba{(uint8_t)(r << 3 | r >> 2), (uint8_t)(g << 2 | g >> 4),
              (uint8_t)(b << 3 | b >> 2), 255};
}

// decode_bc1_color: BC2 and BC3 (`four`) always take the thirds
void bc1_color(Rgba* dst, const uint8_t* s, bool four) {
  const int c0 = s[0] | s[1] << 8, c1 = s[2] | s[3] << 8;
  const uint32_t lut = (uint32_t)s[4] | (uint32_t)s[5] << 8 | (uint32_t)s[6] << 16 |
                       (uint32_t)s[7] << 24;
  Rgba p[4];
  p[0] = from565(c0);
  p[1] = from565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  const int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || four) {
    p[2] = Rgba{(uint8_t)((2 * r0 + r1) / 3), (uint8_t)((2 * g0 + g1) / 3),
                (uint8_t)((2 * b0 + b1) / 3), 255};
    p[3] = Rgba{(uint8_t)((r0 + 2 * r1) / 3), (uint8_t)((g0 + 2 * g1) / 3),
                (uint8_t)((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = Rgba{(uint8_t)((r0 + r1) / 2), (uint8_t)((g0 + g1) / 2),
                (uint8_t)((b0 + b1) / 2), 255};
    p[3] = Rgba{0, 0, 0, 0};
  }
  for (int n = 0; n < 16; n++) dst[n] = p[(lut >> (2 * n)) & 3];
}

// decode_bc3_alpha: 16 values into dst[n * stride]; `sign` reads the two
// ends as int8 plus 128 (BC5S)
void bc3_alpha(uint8_t* dst, const uint8_t* s, int stride, bool sign) {
  int a0 = s[0], a1 = s[1];
  if (sign) {
    a0 = (int8_t)s[0] + 128;
    a1 = (int8_t)s[1] + 128;
  }
  const uint32_t lut1 = s[2] | s[3] << 8 | s[4] << 16;
  const uint32_t lut2 = s[5] | s[6] << 8 | s[7] << 16;
  uint8_t a[8];
  a[0] = (uint8_t)a0;
  a[1] = (uint8_t)a1;
  if (a0 > a1) {
    for (int k = 1; k < 7; k++) a[k + 1] = (uint8_t)(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k < 5; k++) a[k + 1] = (uint8_t)(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 255;
  }
  for (int n = 0; n < 8; n++) dst[stride * n] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; n++) dst[stride * (8 + n)] = a[7 & (lut2 >> (3 * n))];
}

// the BC7 two- and three-subset partitions, 2 bits a pixel (pixel i at
// bits 2i), and the anchor of each subset past the first
const uint32_t PART2[64] = {
    0x50505050, 0x40404040, 0x54545454, 0x54505040, 0x50404000, 0x55545450, 0x55545040,
    0x54504000, 0x50400000, 0x55555450, 0x55544000, 0x54400000, 0x55555440, 0x55550000,
    0x55555500, 0x55000000, 0x55150100, 0x00004054, 0x15010000, 0x00405054, 0x00004050,
    0x15050100, 0x05010000, 0x40505054, 0x00404050, 0x05010100, 0x14141414, 0x05141450,
    0x01155440, 0x00555500, 0x15014054, 0x05414150, 0x44444444, 0x55005500, 0x11441144,
    0x05055050, 0x05500550, 0x11114444, 0x41144114, 0x44111144, 0x15055054, 0x01055040,
    0x05041050, 0x05455150, 0x14414114, 0x50050550, 0x41411414, 0x00141400, 0x00041504,
    0x00105410, 0x10541000, 0x04150400, 0x50410514, 0x41051450, 0x05415014, 0x14054150,
    0x41050514, 0x41505014, 0x40011554, 0x54150140, 0x50505500, 0x00555050, 0x15151010,
    0x54540404};
const uint32_t PART3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0,
    0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4,
    0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454,
    0x6a6a4040, 0xa4a45000, 0x1a1a0500, 0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400,
    0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050,
    0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600, 0xaa444444,
    0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44,
    0x2a4a5254};
const uint8_t ANCHOR2[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                             15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                             15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                             6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t ANCHOR3A[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                              3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                              8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                              3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t ANCHOR3B[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                              15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                              15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                              15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const uint8_t WEIGHTS2[4] = {0, 21, 43, 64};
const uint8_t WEIGHTS3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t WEIGHTS4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) {
  return bits == 2 ? WEIGHTS2 : bits == 3 ? WEIGHTS3 : WEIGHTS4;
}

struct Bits {
  const uint8_t* s;
  int pos = 0;
  int get(int n) {
    int v = 0;
    for (int i = 0; i < n; i++, pos++) v |= ((s[pos >> 3] >> (pos & 7)) & 1) << i;
    return v;
  }
};

int subset(int ns, int part, int i) {
  if (ns == 1) return 0;
  return ((ns == 2 ? PART2[part] : PART3[part]) >> (2 * i)) & 3;
}

bool anchor(int ns, int part, int i) {
  if (i == 0) return true;
  if (ns == 2) return i == ANCHOR2[part];
  return ns == 3 && (i == ANCHOR3A[part] || i == ANCHOR3B[part]);
}

// BC7's modes: subsets, partition bits, rotation bits, index selection
// bits, colour bits, alpha bits, a p-bit per endpoint, one per subset,
// index bits, second index bits
struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode BC7_MODES[8] = {{3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
                              {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
                              {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
                              {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

// decode_bc7_block: a mode byte of zeros is reserved (black, opaque)
void bc7_block(Rgba* col, const uint8_t* s) {
  for (int i = 0; i < 16; i++) col[i] = Rgba{0, 0, 0, 255};
  Bits br{s};
  int mode = 0;
  while (mode < 8 && !br.get(1)) mode++;
  if (mode == 8) return;
  const Bc7Mode& m = BC7_MODES[mode];
  const int part = br.get(m.pb), rot = br.get(m.rb), isel = br.get(m.isb);
  const int ne = 2 * m.ns;
  int ep[6][4] = {};
  for (int c = 0; c < 3; c++)
    for (int e = 0; e < ne; e++) ep[e][c] = br.get(m.cb);
  for (int e = 0; e < ne; e++) ep[e][3] = br.get(m.ab);
  int cb = m.cb, ab = m.ab;
  if (m.epb || m.spb) {
    for (int e = 0; e < ne; e++) {
      const int p = m.epb ? br.get(1) : (e & 1) ? ep[e - 1][0] & 1 : br.get(1);
      for (int c = 0; c < 4; c++) ep[e][c] = ep[e][c] << 1 | p;
    }
    cb++;
    if (ab) ab++;
  }
  for (int e = 0; e < ne; e++) {
    for (int c = 0; c < 4; c++) {
      const int n = c == 3 ? ab : cb;
      if (n == 0) {
        ep[e][c] = 255;
      } else {
        const int v = ep[e][c] << (8 - n);
        ep[e][c] = v | v >> n;
      }
    }
  }
  int idx[16], idx2[16] = {};
  for (int i = 0; i < 16; i++) idx[i] = br.get(m.ib - (anchor(m.ns, part, i) ? 1 : 0));
  if (m.ib2)
    for (int i = 0; i < 16; i++) idx2[i] = br.get(m.ib2 - (i == 0 ? 1 : 0));
  const uint8_t *w1 = weights(m.ib), *w2 = weights(m.ib2 ? m.ib2 : m.ib);
  for (int i = 0; i < 16; i++) {
    const int* e0 = ep[2 * subset(m.ns, part, i)];
    const int* e1 = e0 + 4;
    int wc = w1[idx[i]], wa = wc;
    if (m.ib2) {
      wc = isel ? w2[idx2[i]] : w1[idx[i]];
      wa = isel ? w1[idx[i]] : w2[idx2[i]];
    }
    uint8_t v[4];
    for (int c = 0; c < 3; c++) v[c] = (uint8_t)((e0[c] * (64 - wc) + e1[c] * wc + 32) >> 6);
    v[3] = ab ? (uint8_t)((e0[3] * (64 - wa) + e1[3] * wa + 32) >> 6) : 255;
    if (rot) std::swap(v[3], v[rot - 1]);
    col[i] = Rgba{v[0], v[1], v[2], v[3]};
  }
}

// BC6H's modes: regions, transformed, partition bits, endpoint bits, and
// the delta bits of red, green and blue
struct Bc6Mode {
  int ns, tr, pb, epb, rb, gb, bb;
};
const Bc6Mode BC6_MODES[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5},  {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},   {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};
// where each header bit goes: endpoint (r0 g0 b0 r1 g1 b1 r2 ... b3) << 4
// | its bit (the format's table of bit fields, mode by mode)
const uint8_t BC6_BITS[14][75] = {
    {116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20, 21, 22, 133, 178, 116, 32, 33, 34, 35, 36, 37, 38, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 26, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145, 146, 147, 116, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 42, 128, 129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146, 147, 180, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24, 116, 32, 33, 34, 35, 36, 37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178, 116, 32, 33, 34, 35, 36, 37, 38, 39, 179, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117, 116, 32, 33, 34, 35, 36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133, 116, 32, 33, 34, 35, 36, 37, 38, 39, 181, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133, 178, 116, 32, 33, 34, 35, 36, 37, 165, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85, 86, 87, 88, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85, 86, 87, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10, 64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46, 45, 44, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
};

int sign_extend(int v, int bits) {
  v &= (1 << bits) - 1;
  return v & (1 << (bits - 1)) ? v - (1 << bits) : v;
}

// bc6_unquantize: signed endpoints are read as the int16 of their low
// 16 bits
int bc6_unquantize(int v, int bits, bool sign) {
  if (!sign) {
    v &= 0xffff;
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xffff;
    return ((v << 16) + 0x8000) >> bits;
  }
  int x = (int16_t)(uint16_t)v;
  if (bits >= 16) return x;
  const bool neg = x < 0;
  if (neg) x = -x;
  if (x == 0) {
  } else if (x >= (1 << (bits - 1)) - 1) {
    x = 0x7fff;
  } else {
    x = ((x << 15) + 0x4000) >> (bits - 1);
  }
  return neg ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = (uint32_t)(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= (uint32_t)(h & 0x8000) << 16;
  return o.f;
}

// bc6_finalize and bc6_clamp: the half float of the interpolated value,
// truncated to 8 bits within 0..1 (NaN, which Pillow's float-to-int
// conversion turns to 0x80000000, to 0)
uint8_t bc6_out(int v, bool sign) {
  uint16_t h;
  if (sign)
    h = v < 0 ? (uint16_t)(0x8000 | ((-v) * 31) / 32) : (uint16_t)((v * 31) / 32);
  else
    h = (uint16_t)((v * 31) / 64);
  const float f = half_to_float(h);
  if (f != f) return 0;
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return (uint8_t)(int)(f * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* s, bool sign) {
  int mode = s[0] & 31, first = 5, epbits = 75, ib = 3;
  if ((mode & 3) == 0 || (mode & 3) == 1) {
    mode &= 3;
    first = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    epbits = 72;
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {
    for (int i = 0; i < 16; i++) col[i] = Rgba{0, 0, 0, 0};
    return;
  }
  const Bc6Mode& m = BC6_MODES[mode];
  Bits br{s};
  br.pos = first;
  int ep[12] = {};
  for (int i = 0; i < epbits; i++) {
    const int d = BC6_BITS[mode][i];
    ep[d >> 4] |= br.get(1) << (d & 15);
  }
  const int part = br.get(m.pb);
  const int numep = m.ns == 2 ? 12 : 6;
  const int dbits[3] = {m.rb, m.gb, m.bb};
  if (sign)
    for (int c = 0; c < 3; c++) ep[c] = sign_extend(ep[c], m.epb);
  if (sign || m.tr)
    for (int i = 3; i < numep; i++) ep[i] = sign_extend(ep[i], dbits[i % 3]);
  if (m.tr)  // the deltas added, kept to the endpoint's bits
    for (int i = 3; i < numep; i++) ep[i] = (ep[i] + ep[i % 3]) & ((1 << m.epb) - 1);
  int u[12];
  for (int i = 0; i < numep; i++) u[i] = bc6_unquantize(ep[i], m.epb, sign);
  const uint8_t* w = weights(ib);
  for (int i = 0; i < 16; i++) {
    const int sub = subset(m.ns, part, i);
    const int k = w[br.get(ib - (anchor(m.ns, part, i) ? 1 : 0))];
    const int* e0 = u + 6 * sub;
    uint8_t v[3];
    for (int c = 0; c < 3; c++) v[c] = bc6_out((e0[c] * (64 - k) + e0[3 + c] * k) >> 6, sign);
    col[i] = Rgba{v[0], v[1], v[2], 0};
  }
}

}  // namespace

// bcn: BcnDecode.c, n = 1 (BC1/DXT1), 2 (BC2/DXT3), 3 (BC3/DXT5), 4 (BC4,
// L), 5 (BC5, RGB: red and green, blue 0, or 128 where `sign`), 6 (BC6H,
// UF16 or SF16 where `sign`, RGB), 7 (BC7): blocks of 8 (n = 1, 4) or 16
// bytes, 4 x 4 pixels each, left to right and top to bottom, those past
// the image's edge cut; out h x w x 4 bytes (RGBA), 1 (n = 4) or 3 (n =
// 5, 6). 0 done, 1 the data ended first.
int bcn(int n, int sign, const uint8_t* data, size_t len, int64_t w, int64_t h, uint8_t* out) {
  const int64_t bw = (w + 3) / 4, bh = (h + 3) / 4;
  const size_t size = n == 1 || n == 4 ? 8 : 16;
  const int bands = n == 4 ? 1 : n == 5 || n == 6 ? 3 : 4;
  size_t pos = 0;
  for (int64_t by = 0; by < bh; by++) {
    for (int64_t bx = 0; bx < bw; bx++, pos += size) {
      if (len < size || pos > len - size) return 1;
      const uint8_t* s = data + pos;
      Rgba col[16];
      switch (n) {
        case 1:
          bc1_color(col, s, false);
          break;
        case 2:
          bc1_color(col, s + 8, true);
          for (int k = 0; k < 16; k++) {
            const int a = (s[k >> 1] >> ((k & 1) * 4)) & 15;
            col[k].a = (uint8_t)(a << 4 | a);
          }
          break;
        case 3:
          bc1_color(col, s + 8, true);
          bc3_alpha(&col[0].a, s, 4, false);
          break;
        case 4:
          bc3_alpha(&col[0].r, s, 4, false);
          break;
        case 5: {
          const uint8_t fill = sign ? 128 : 0;
          for (int k = 0; k < 16; k++) col[k] = Rgba{fill, fill, fill, fill};
          bc3_alpha(&col[0].r, s, 4, sign);
          bc3_alpha(&col[0].g, s + 8, 4, sign);
          break;
        }
        case 6:
          bc6_block(col, s, sign);
          break;
        default:
          bc7_block(col, s);
      }
      for (int k = 0; k < 16; k++) {
        const int64_t y = by * 4 + k / 4, x = bx * 4 + k % 4;
        if (y >= h || x >= w) continue;
        std::memcpy(out + (y * w + x) * bands, &col[k], bands);
      }
    }
  }
  return 0;
}

// blp_dxt: BlpImagePlugin's own Python decode_dxt1, decode_dxt3 and
// decode_dxt5 (kind 1, 3, 5), not BcnDecode.c: its 5-6-5 shifted with no
// bits replicated, DXT3 and DXT5 colours always the floored thirds,
// DXT3's alpha times 17; `rows` block rows of `bw` blocks each, every
// block row 4 pixel rows of 4 bw pixels, RGBA, or RGB for DXT1 without
// `alpha` (its transparent black then black), into out.
void blp_dxt(int kind, int alpha, const uint8_t* data, int64_t bw, int64_t rows, uint8_t* out) {
  const int size = kind == 1 ? 8 : 16;
  const int bands = kind == 1 && !alpha ? 3 : 4;
  const int64_t stride = bw * 4 * bands;
  for (int64_t by = 0; by < rows; by++) {
    for (int64_t bx = 0; bx < bw; bx++) {
      const uint8_t* s = data + (by * bw + bx) * size;
      const uint8_t* c = kind == 1 ? s : s + 8;
      const int c0 = c[0] | c[1] << 8, c1 = c[2] | c[3] << 8;
      const uint32_t code = (uint32_t)c[4] | (uint32_t)c[5] << 8 | (uint32_t)c[6] << 16 |
                            (uint32_t)c[7] << 24;
      const int e[2][3] = {{(c0 >> 11 & 31) << 3, (c0 >> 5 & 63) << 2, (c0 & 31) << 3},
                           {(c1 >> 11 & 31) << 3, (c1 >> 5 & 63) << 2, (c1 & 31) << 3}};
      int p[4][4];
      for (int q = 0; q < 3; q++) {
        p[0][q] = e[0][q];
        p[1][q] = e[1][q];
        if (c0 > c1 || kind != 1) {
          p[2][q] = (2 * e[0][q] + e[1][q]) / 3;
          p[3][q] = (2 * e[1][q] + e[0][q]) / 3;
        } else {
          p[2][q] = (e[0][q] + e[1][q]) / 2;
          p[3][q] = 0;
        }
      }
      p[0][3] = p[1][3] = p[2][3] = 255;
      p[3][3] = c0 > c1 || kind != 1 ? 255 : 0;
      int a[8] = {};
      if (kind == 5) {
        const int a0 = s[0], a1 = s[1];
        a[0] = a0;
        a[1] = a1;
        for (int k = 2; k < 8; k++)
          a[k] = a0 > a1 ? ((8 - k) * a0 + (k - 1) * a1) / 7
                 : k == 6 ? 0
                 : k == 7 ? 255
                          : ((6 - k) * a0 + (k - 1) * a1) / 5;
      }
      const uint64_t acode = (uint64_t)s[2] | (uint64_t)s[3] << 8 | (uint64_t)s[4] << 16 |
                             (uint64_t)s[5] << 24 | (uint64_t)s[6] << 32 | (uint64_t)s[7] << 40;
      for (int k = 0; k < 16; k++) {
        const int* px = p[(code >> (2 * k)) & 3];
        uint8_t* o = out + (by * 4 + k / 4) * stride + (bx * 4 + k % 4) * bands;
        o[0] = (uint8_t)px[0];
        o[1] = (uint8_t)px[1];
        o[2] = (uint8_t)px[2];
        if (bands == 4) {
          if (kind == 1)
            o[3] = (uint8_t)px[3];
          else if (kind == 3)
            o[3] = (uint8_t)(((s[k >> 1] >> ((k & 1) * 4)) & 15) * 17);
          else
            o[3] = (uint8_t)a[(acode >> (3 * k)) & 7];
        }
      }
    }
  }
}

// bitdec: out ys x xs float32; 0 done, 1 the data ended first, 2 a
// width Pillow's decoder refuses (IMAGING_CODEC_CONFIG).
int bitdec(const uint8_t* data, size_t len, int bits, int64_t xs, int64_t ys, float* out) {
  if (bits < 1 || bits >= 32) return 2;
  const uint64_t mask = ((uint64_t)1 << bits) - 1;
  uint64_t buffer = 0;
  int count = 0;
  int64_t x = 0, y = ys - 1;
  for (size_t pos = 0; pos < len; pos++) {
    const uint8_t byte = data[pos];
    buffer |= (uint64_t)byte << count;
    count += 8;
    while (count >= bits) {
      const uint64_t v = buffer & mask;
      if (count > 32)
        buffer = byte >> (8 - (count - bits));
      else
        buffer >>= bits;
      count -= bits;
      out[y * xs + x] = (float)v;
      if (++x >= xs) {
        if (--y < 0) return 0;
        x = 0;
        count = 0;
      }
    }
  }
  return 1;
}

}  // extern "C"
