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
// - lab_to_rgb: LittleCMS's 8-bit transform from Pillow's "LAB" to
//   sRGB as Pillow's convert("RGB") builds it, a tetrahedral
//   interpolation (TetrahedralInterp16) on a 33^3 16-bit CLUT the
//   caller samples.
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

// lab: npix x 3 bytes of Pillow's LAB; clut: 33^3 x 3 16-bit values
// (L slowest); out: npix x 3 bytes of RGB.
void lab_to_rgb(const uint8_t* lab, int64_t npix, const uint16_t* clut, uint8_t* out) {
  const int g1 = 32;
  const int opta[3] = {33 * 33 * 3, 33 * 3, 3};  // L, a, b strides
  for (int64_t p = 0; p < npix; p++) {
    int i0[3], i1[3], r[3];
    for (int k = 0; k < 3; k++) {
      const int w = lab[3 * p + k] * 257;
      const int64_t a = (int64_t)w * g1;
      const int64_t f = a + (a + 0x7FFF) / 0xFFFF;  // _cmsToFixedDomain
      i0[k] = (int)(f >> 16);
      r[k] = (int)(f & 0xFFFF);
      i1[k] = w == 0xFFFF ? i0[k] : i0[k] + 1;
    }
    const int x0 = i0[0] * opta[0], y0 = i0[1] * opta[1], z0 = i0[2] * opta[2];
    const int x1 = i1[0] * opta[0], y1 = i1[1] * opta[1], z1 = i1[2] * opta[2];
    const int rx = r[0], ry = r[1], rz = r[2];
    for (int c = 0; c < 3; c++) {
      auto d = [&](int x, int y, int z) { return (int64_t)clut[x + y + z + c]; };
      const int64_t c0 = d(x0, y0, z0);
      int64_t c1 = 0, c2 = 0, c3 = 0;
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
      } else if (rz >= ry && ry >= rx) {
        c1 = d(x1, y1, z1) - d(x0, y1, z1);
        c2 = d(x0, y1, z1) - d(x0, y0, z1);
        c3 = d(x0, y0, z1) - c0;
      }
      const int64_t rest = c1 * rx + c2 * ry + c3 * rz + 0x8001;
      const uint32_t o16 = (uint32_t)((c0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF);
      out[3 * p + c] = (uint8_t)(((o16 * 65281u + 8388608u) >> 24) & 0xFF);
    }
  }
}

}  // extern "C"
