// lzwdec: the GIF image data decoder for the port's image reads
// (io/stdformats.py::read_gif), as Pillow 12.1.0 decodes a frame:
// GifDecode.c fed by ImageFile.load, which reads the file from the
// frame's data in chunks of 64 KiB and calls the decoder once a chunk.
// Data sub-blocks run from the frame's data to the end of the file (a
// zero-length block is an empty one, and what follows the frame's
// terminator is read as more blocks); a block is taken whole, once the
// chunks read hold it. Codes are read least significant bit first, from
// the minimum code size plus one up to 12 bits; the code size grows once
// the entry just added is the last its width can name; a full table
// (4096 entries) adds nothing more until the next clear code. An end
// code ends the decoder's call: decoding goes on after it once the next
// chunk is read, and the file is cut short where there is none. The
// frame ends when its last pixel is written.
//
// C ABI for ctypes:
//   int gif_lzw_decode(const uint8_t* data, size_t len, int bits,
//                      uint8_t* out, size_t npix, size_t* written)
// data: the file from the byte after the minimum code size to its end;
// bits: the minimum code size (0 to 12); out: room for npix indices in
// stream order. Returns 0 where npix indices were written, 1 where the
// file ended first (Pillow's "image file is truncated"), 2 on a code
// past the table (Pillow's IMAGING_CODEC_BROKEN). *written: indices
// written.

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

int gif_lzw_decode(const uint8_t* data, size_t len, int bits, uint8_t* out, size_t npix,
                   size_t* written) {
  const int kTable = 4096;
  const size_t kChunk = 65536;  // ImageFile.MAXBLOCK
  *written = 0;
  if (bits < 0 || bits > 12) return 2;
  const int clear = 1 << bits, end = clear + 1;
  std::vector<uint8_t> suffix(kTable), first(kTable);
  std::vector<int> link(kTable);
  for (int i = 0; i < clear && i < kTable; i++) {
    suffix[i] = (uint8_t)i;
    first[i] = (uint8_t)i;
    link[i] = -1;
  }
  int codesize = bits + 1, codemask = (1 << codesize) - 1;
  int next = clear + 2, last = -1;
  uint64_t buf = 0;
  int nbuf = 0;
  size_t pos = 0, block = 0, n = 0;
  size_t avail = len < kChunk ? len : kChunk;  // the bytes read so far
  std::vector<uint8_t> stack(kTable + 1);
  while (n < npix) {
    while (nbuf < codesize) {
      if (block == 0) {  // the next sub-block, whole or not at all
        if (pos >= avail || avail - pos < (size_t)data[pos] + 1) {
          if (avail == len) {
            *written = n;
            return 1;
          }
          avail = len - avail < kChunk ? len : avail + kChunk;
          continue;
        }
        block = data[pos++];
        continue;
      }
      buf |= (uint64_t)data[pos++] << nbuf;
      nbuf += 8;
      block--;
    }
    int c = (int)(buf & (uint64_t)codemask);
    buf >>= codesize;
    nbuf -= codesize;
    if (c == clear) {
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      next = clear + 2;
      last = -1;
      continue;
    }
    if (c == end) {  // the call ends; the next chunk resumes it
      if (avail == len) {
        *written = n;
        return 1;
      }
      avail = len - avail < kChunk ? len : avail + kChunk;
      continue;
    }
    int code = c;
    int sp = 0;
    if (last < 0) {
      if (c >= next) {
        *written = n;
        return 2;
      }
    } else if (c > next) {
      *written = n;
      return 2;
    }
    if (c == next) {
      // the entry not yet made: the last string and its own first byte;
      // a full table (or a minimum code size of 12, where next starts
      // past it) has no such entry
      if (last < 0 || last >= kTable) {
        *written = n;
        return 2;
      }
      stack[sp++] = first[last];
      code = last;
    }
    while (code >= clear && code < kTable && sp < kTable) {
      stack[sp++] = suffix[code];
      code = link[code];
    }
    if (code < 0 || code >= clear) {
      *written = n;
      return 2;
    }
    const uint8_t lead = (uint8_t)code;
    stack[sp++] = lead;
    while (sp > 0 && n < npix) out[n++] = stack[--sp];
    if (last >= 0 && next < kTable) {
      suffix[next] = lead;
      first[next] = first[last];
      link[next] = last;
      if (next == codemask && codesize < 12) {
        codesize++;
        codemask = (1 << codesize) - 1;
      }
      next++;
    }
    last = c;
  }
  *written = n;
  return 0;
}

}  // extern "C"
