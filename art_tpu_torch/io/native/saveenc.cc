// Image encoders of the formats Pillow 12.1.0 writes that need a loop
// over every pixel, with the bytes Pillow's encoders give:
//
//   saveenc_qoi       QOI (QoiImagePlugin.QoiEncoder, Python in Pillow);
//   saveenc_pcx       PCX's RLE of an RGB image in line planes
//                     (PcxEncode.c);
//   saveenc_eps       EPS's hex lines (EpsEncode.c);
//   saveenc_quantize  Image.quantize's median cut, method 0, no k-means
//                     (Quantize.c, QuantHash.c, QuantHeap.c): the colour
//                     histogram at the least scale that holds at most
//                     65536 colours, the median cut into up to `colors`
//                     boxes, each box's mean colour, and each pixel's
//                     nearest palette entry found from its box's entry
//                     through the distance-sorted table;
//   saveenc_gif_lzw   GIF's LZW (GifEncode.c, Raymond Gardner's encoder)
//                     in sub-blocks as Pillow's buffer gives them, rows
//                     in GIF's interlaced order where asked;
//   saveenc_resample  Image.resize's 8-bit fixed-point two-pass resample
//                     of an RGB image (Resample.c) with the bicubic
//                     (a = -0.5) or Lanczos (support 3) filter.
//
// Plain C interface, built by art_tpu_torch/hostbuild.py with g++.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

uint8_t* give(const std::vector<uint8_t>& v, size_t* n) {
  uint8_t* p = (uint8_t*)malloc(std::max<size_t>(v.size(), 1));
  if (!p) return nullptr;
  if (!v.empty()) memcpy(p, v.data(), v.size());
  *n = v.size();
  return p;
}

// ------------------------------------------------------------ median cut
struct Entry {
  uint8_t v[3];  // the scaled colour
  uint32_t count;
};

struct Box {
  std::vector<int> items;  // entry indices
  uint32_t count = 0;
  int volume = -1;
  int lo[3], hi[3];
  int left = -1, right = -1;
  void bounds(const std::vector<Entry>& e) {
    for (int a = 0; a < 3; a++) {
      lo[a] = 255;
      hi[a] = 0;
    }
    for (int i : items)
      for (int a = 0; a < 3; a++) {
        lo[a] = std::min<int>(lo[a], e[i].v[a]);
        hi[a] = std::max<int>(hi[a], e[i].v[a]);
      }
    volume = (hi[0] - lo[0] + 1) * (hi[1] - lo[1] + 1) * (hi[2] - lo[2] + 1);
  }
};

// QuantHeap.c: a max-heap of boxes on their pixel counts, its own sift
struct Heap {
  std::vector<int> h{0};  // 1-based
  const std::vector<Box>* boxes;
  int cmp(int a, int b) const {
    return (int)(*boxes)[a].count - (int)(*boxes)[b].count;
  }
  void add(int v) {
    h.push_back(0);
    size_t k = h.size() - 1;
    while (k != 1) {
      if (cmp(v, h[k / 2]) <= 0) break;
      h[k] = h[k / 2];
      k >>= 1;
    }
    h[k] = v;
  }
  bool remove(int* r) {
    size_t n = h.size() - 1;
    if (!n) return false;
    *r = h[1];
    int v = h[n];
    h.pop_back();
    n--;
    size_t k = 1, l;
    for (; k * 2 <= n; k = l) {
      l = k * 2;
      if (l < n && cmp(h[l], h[l + 1]) < 0) l++;
      if (cmp(v, h[l]) > 0) break;
      h[k] = h[l];
    }
    if (n) h[k] = v;
    return true;
  }
};

// splitlists: entries sorted on `axis` from the highest value down, the
// left box up to the entry whose running count passes half the box's,
// with every entry of that entry's value
bool split(std::vector<Box>& boxes, const std::vector<Entry>& e, int node) {
  Box& b = boxes[node];
  const int w[3] = {77, 150, 29};
  int axis = 0, best = (b.hi[0] - b.lo[0]) * w[0];
  for (int a = 1; a < 3; a++) {
    int f = (b.hi[a] - b.lo[a]) * w[a];
    if (best < f) {
      best = f;
      axis = a;
    }
  }
  std::vector<int> sorted(b.items);
  std::stable_sort(sorted.begin(), sorted.end(),
                   [&](int x, int y) { return e[x].v[axis] > e[y].v[axis]; });
  size_t n = sorted.size(), i = 0;
  uint32_t left = 0;
  while (i < n) {
    left += e[sorted[i]].count;
    i++;
    if ((uint64_t)left * 2 > b.count) break;
  }
  if (i < n) {
    int val = e[sorted[i - 1]].v[axis];
    while (i < n && e[sorted[i]].v[axis] == val) i++;
  }
  if (i == n) {  // no right box: the lowest value's entries go right
    int val = e[sorted[n - 1]].v[axis];
    while (i > 0 && e[sorted[i - 1]].v[axis] == val) i--;
  }
  if (i == 0) return false;
  Box l, r;
  l.items.assign(sorted.begin(), sorted.begin() + i);
  r.items.assign(sorted.begin() + i, sorted.end());
  for (int k : l.items) l.count += e[k].count;
  for (int k : r.items) r.count += e[k].count;
  l.bounds(e);
  r.bounds(e);
  boxes[node].items.clear();
  boxes[node].items.shrink_to_fit();
  boxes.push_back(std::move(l));
  boxes.push_back(std::move(r));
  boxes[node].left = (int)boxes.size() - 2;
  boxes[node].right = (int)boxes.size() - 1;
  return true;
}

void leaves(const std::vector<Box>& boxes, int node, std::vector<int>& out) {
  const Box& b = boxes[node];
  if (b.left >= 0) {
    leaves(boxes, b.left, out);
    leaves(boxes, b.right, out);
  } else {
    out.push_back(node);
  }
}

inline uint32_t dist2(const uint8_t* a, const uint8_t* b) {
  int dr = (int)a[0] - (int)b[0], dg = (int)a[1] - (int)b[1],
      db = (int)a[2] - (int)b[2];
  return (uint32_t)(dr * dr + dg * dg + db * db);
}

// -------------------------------------------------------------- resample
double bicubic(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}
double sinc(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return sin(x) / x;
}
double lanczos(double x) {
  if (-3.0 <= x && x < 3.0) return sinc(x) * sinc(x / 3);
  return 0.0;
}

const int kPrecision = 32 - 8 - 2;

// precompute_coeffs and normalize_coeffs_8bpc: (first index, count) of
// each output sample, and its fixed-point taps
int coeffs(int in_size, int out_size, int filter, std::vector<int>& bounds,
           std::vector<int32_t>& kk) {
  double (*f)(double) = filter == 3 ? bicubic : lanczos;
  double support0 = filter == 3 ? 2.0 : 3.0;
  double scale = (double)(float)(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = support0 * filterscale;
  int ksize = (int)ceil(support) * 2 + 1;
  bounds.assign(out_size * 2, 0);
  kk.assign((size_t)out_size * ksize, 0);
  std::vector<double> k(ksize);
  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0, ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; x++) {
      double w = f((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++)
      if (ww != 0.0) k[x] /= ww;
    for (int x = xmax; x < ksize; x++) k[x] = 0;
    for (int x = 0; x < ksize; x++) {
      double v = k[x] * (1 << kPrecision);
      kk[(size_t)xx * ksize + x] = v < 0 ? (int32_t)(-0.5 + v) : (int32_t)(0.5 + v);
    }
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  return ksize;
}

inline uint8_t clip8(int32_t in) {
  int v = in >> kPrecision;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

}  // namespace

extern "C" {

int saveenc_qoi(const uint8_t* rgb, int w, int h, uint8_t** out, size_t* n) {
  std::vector<uint8_t> d;
  d.reserve((size_t)w * h * 2 + 8);
  uint8_t seen[64][4];
  memset(seen, 0, sizeof seen);
  bool known[64] = {false};
  known[0] = true;  // {0: (0, 0, 0, 0)}
  uint8_t prev[4] = {0, 0, 0, 255};
  int run = 0;
  auto delta = [](int a, int b) {
    int r = (a - b) & 255;
    return r >= 128 ? r - 256 : r;
  };
  size_t np = (size_t)w * h;
  for (size_t i = 0; i < np; i++) {
    const uint8_t* p = rgb + 3 * i;
    uint8_t px[4] = {p[0], p[1], p[2], 255};
    if (!memcmp(px, prev, 4)) {
      run++;
      if (run == 62) {
        d.push_back(0xC0 | (run - 1));
        run = 0;
      }
    } else {
      if (run) {
        d.push_back(0xC0 | (run - 1));
        run = 0;
      }
      int hv = (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64;
      if (known[hv] && !memcmp(seen[hv], px, 4)) {
        d.push_back((uint8_t)hv);
      } else {
        memcpy(seen[hv], px, 4);
        known[hv] = true;
        int dr = delta(px[0], prev[0]), dg = delta(px[1], prev[1]),
            db = delta(px[2], prev[2]);
        if (-2 <= dr && dr < 2 && -2 <= dg && dg < 2 && -2 <= db && db < 2) {
          d.push_back(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2));
        } else {
          int dgr = delta(dr, dg), dgb = delta(db, dg);
          if (-8 <= dgr && dgr < 8 && -32 <= dg && dg < 32 && -8 <= dgb && dgb < 8) {
            d.push_back(0x80 | (dg + 32));
            d.push_back((dgr + 8) << 4 | (dgb + 8));
          } else {
            d.push_back(0xFE);
            d.insert(d.end(), px, px + 3);
          }
        }
      }
    }
    memcpy(prev, px, 4);
  }
  if (run) d.push_back(0xC0 | (run - 1));
  const uint8_t pad[8] = {0, 0, 0, 0, 0, 0, 0, 1};
  d.insert(d.end(), pad, pad + 8);
  *out = give(d, n);
  return *out ? 0 : 1;
}

int saveenc_pcx(const uint8_t* rgb, int w, int h, uint8_t** out, size_t* n) {
  const int planes = 3, bpl = w, padding = (bpl % 2);
  std::vector<uint8_t> d, line((size_t)planes * bpl);
  d.reserve((size_t)w * h * 3 + 16);
  for (int y = 0; y < h; y++) {
    const uint8_t* row = rgb + (size_t)y * w * 3;
    for (int c = 0; c < planes; c++)
      for (int x = 0; x < w; x++) line[(size_t)c * bpl + x] = row[3 * x + c];
    int count = 1, last = line[0];
    size_t x = 1, end = (size_t)planes * bpl;
    do {
      while (x % bpl) {
        if (count == 63) {
          d.push_back(0xC0 | count);
          d.push_back(last);
          count = 0;
        }
        int cur = line[x];
        if (cur == last) {
          x++;
          count++;
        } else {
          if (count == 1 && last < 0xC0) {
            d.push_back(last);
          } else if (count > 0) {
            d.push_back(0xC0 | count);
            d.push_back(last);
          }
          last = cur;
          count = 1;
          x++;
        }
      }
      if (count == 1 && last < 0xC0) {
        d.push_back(last);
      } else if (count > 0) {
        d.push_back(0xC0 | count);
        d.push_back(last);
      }
      for (int i = 0; i < padding; i++) d.push_back(0);
      if (x < end) {
        count = 1;
        last = line[x];
        x++;
      }
    } while (x < end);
  }
  *out = give(d, n);
  return *out ? 0 : 1;
}

int saveenc_eps(const uint8_t* rgb, int w, int h, uint8_t** out, size_t* n) {
  static const char hex[] = "0123456789abcdef";
  size_t total = (size_t)w * h * 3;
  std::vector<uint8_t> d;
  d.reserve(total * 2 + total / 39 + 1);
  int count = 0;
  bool newline = false;
  for (size_t i = 0; i < total; i++) {
    if (newline) {
      d.push_back('\n');
      newline = false;
    }
    d.push_back(hex[rgb[i] >> 4]);
    d.push_back(hex[rgb[i] & 15]);
    if (++count >= 79 / 2) {
      newline = true;
      count = 0;
    }
  }
  *out = give(d, n);
  return *out ? 0 : 1;
}

// the indices (npix bytes) and palette (3 * 256 bytes, *npal entries)
int saveenc_quantize(const uint8_t* rgb, size_t npix, int colors, uint8_t* idx, uint8_t* pal,
                     int* npal) {
  // the least scale whose histogram holds at most 65536 colours
  int scale = 0;
  for (;; scale++) {
    int bits = 8 - scale;
    size_t cells = (size_t)1 << (3 * bits);
    std::vector<uint64_t> seen((cells + 63) / 64, 0);
    size_t distinct = 0;
    for (size_t i = 0; i < npix; i++) {
      const uint8_t* p = rgb + 3 * i;
      size_t key = ((size_t)(p[0] >> scale) << (2 * bits)) | ((size_t)(p[1] >> scale) << bits) |
                   (size_t)(p[2] >> scale);
      uint64_t bit = (uint64_t)1 << (key & 63);
      if (!(seen[key >> 6] & bit)) {
        seen[key >> 6] |= bit;
        distinct++;
      }
    }
    if (distinct <= 65536) break;
  }
  int bits = 8 - scale;
  size_t cells = (size_t)1 << (3 * bits);
  std::vector<int32_t> slot(cells, -1);
  std::vector<Entry> e;
  std::vector<size_t> keys(npix);
  for (size_t i = 0; i < npix; i++) {
    const uint8_t* p = rgb + 3 * i;
    size_t key = ((size_t)(p[0] >> scale) << (2 * bits)) | ((size_t)(p[1] >> scale) << bits) |
                 (size_t)(p[2] >> scale);
    keys[i] = key;
    if (slot[key] < 0) {
      slot[key] = (int32_t)e.size();
      e.push_back(Entry{{(uint8_t)(p[0] >> scale), (uint8_t)(p[1] >> scale),
                         (uint8_t)(p[2] >> scale)},
                        0});
    }
    e[slot[key]].count++;
  }
  std::vector<Box> boxes;
  boxes.reserve(2 * colors + 1);
  Box root;
  root.items.resize(e.size());
  for (size_t i = 0; i < e.size(); i++) root.items[i] = (int)i;
  root.count = (uint32_t)npix;
  root.bounds(e);
  boxes.push_back(std::move(root));
  Heap heap;
  heap.boxes = &boxes;
  heap.add(0);
  int left = colors;
  while (--left) {
    int node;
    bool got = false;
    while (heap.remove(&node)) {
      if (boxes[node].volume != 1) {
        got = true;
        break;
      }
    }
    if (!got) break;
    if (!split(boxes, e, node)) return 2;
    heap.add(boxes[node].left);
    heap.add(boxes[node].right);
  }
  std::vector<int> order;
  leaves(boxes, 0, order);
  int n = (int)order.size();
  std::vector<int32_t> box_of(e.size());
  for (int b = 0; b < n; b++)
    for (int i : boxes[order[b]].items) box_of[i] = b;
  // each box's mean colour (uint32 sums, as Quantize.c's)
  std::vector<uint32_t> sum(3 * n, 0), cnt(n, 0);
  for (size_t i = 0; i < npix; i++) {
    int b = box_of[slot[keys[i]]];
    const uint8_t* p = rgb + 3 * i;
    sum[3 * b] += p[0];
    sum[3 * b + 1] += p[1];
    sum[3 * b + 2] += p[2];
    cnt[b]++;
  }
  std::vector<uint8_t> pl(3 * n);
  for (int b = 0; b < n; b++)
    for (int c = 0; c < 3; c++)
      pl[3 * b + c] = (uint8_t)(int)(.5 + (double)sum[3 * b + c] / (double)cnt[b]);
  // the distance tables and each row's order by (distance, index)
  std::vector<uint32_t> dist((size_t)n * n);
  for (int i = 0; i < n; i++)
    for (int j = 0; j < n; j++) dist[(size_t)i * n + j] = dist2(&pl[3 * i], &pl[3 * j]);
  std::vector<int> sortkey((size_t)n * n);
  for (int i = 0; i < n; i++) {
    int* row = &sortkey[(size_t)i * n];
    for (int j = 0; j < n; j++) row[j] = j;
    const uint32_t* d = &dist[(size_t)i * n];
    std::sort(row, row + n, [d](int a, int b) { return d[a] != d[b] ? d[a] < d[b] : a < b; });
  }
  std::vector<int16_t> cache((size_t)1 << 24, -1);
  for (size_t i = 0; i < npix; i++) {
    const uint8_t* p = rgb + 3 * i;
    size_t ck = ((size_t)p[0] << 16) | ((size_t)p[1] << 8) | p[2];
    if (cache[ck] >= 0) {
      idx[i] = (uint8_t)cache[ck];
      continue;
    }
    int b = box_of[slot[keys[i]]];
    uint32_t best = dist2(&pl[3 * b], p), bound = best << 2;
    int match = b;
    const int* row = &sortkey[(size_t)b * n];
    const uint32_t* d = &dist[(size_t)b * n];
    for (int j = 0; j < n; j++) {
      int k = row[j];
      if (d[k] > bound) break;
      uint32_t dd = dist2(&pl[3 * k], p);
      if (dd < best) {
        best = dd;
        match = k;
      }
    }
    cache[ck] = (int16_t)match;
    idx[i] = (uint8_t)match;
  }
  memcpy(pal, pl.data(), pl.size());
  *npal = n;
  return 0;
}

int saveenc_gif_lzw(const uint8_t* idx, int w, int h, int interlace, size_t bufsize,
                    uint8_t** out, size_t* n) {
  // the rows in the order the encoder fetches them
  std::vector<int> rows;
  if (interlace) {
    const int start[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
    for (int pass = 0; pass < 4; pass++)
      for (int y = start[pass]; y < h; y += step[pass]) rows.push_back(y);
  } else {
    for (int y = 0; y < h; y++) rows.push_back(y);
  }
  std::vector<uint8_t> code;
  code.reserve((size_t)w * h / 2 + 16);
  uint32_t buffer = 0;
  int nbits = 0, width = 9;
  const int clear = 256, eoi = 257;
  int next = eoi + 1, max_code = 2 * clear - 1;
  std::vector<uint16_t> table((size_t)4096 * 256, 0);
  auto put = [&](int c) {
    buffer |= (uint32_t)c << nbits;
    nbits += width;
    while (nbits >= 8) {
      code.push_back(buffer & 255);
      buffer >>= 8;
      nbits -= 8;
    }
  };
  auto reset = [&]() {
    next = eoi + 1;
    max_code = 2 * clear - 1;
    width = 9;
    std::fill(table.begin(), table.end(), 0);
  };
  put(clear);
  int head = -1;
  for (int y : rows) {
    const uint8_t* r = idx + (size_t)y * w;
    for (int x = 0; x < w; x++) {
      int tail = r[x];
      if (head < 0) {
        head = tail;
        continue;
      }
      uint16_t hit = table[(size_t)head * 256 + tail];
      if (hit) {
        head = hit;
        continue;
      }
      put(head);
      if (next < 4096) {
        table[(size_t)head * 256 + tail] = (uint16_t)next;
        if (next > max_code) {
          max_code = max_code * 2 + 1;
          width++;
        }
        next++;
      } else {
        put(clear);
        reset();
      }
      head = tail;
    }
  }
  if (head >= 0) put(head);
  put(eoi);
  if (nbits > 0) code.push_back(buffer & 255);
  // sub-blocks of at most 255 bytes, none across the encoder's buffer of
  // `bufsize` bytes, each one opened with at least two bytes left there
  std::vector<uint8_t> d;
  d.reserve(code.size() + code.size() / 255 + 16);
  size_t at = 0, pos = 0;
  while (at < code.size()) {
    if (bufsize - pos < 2) pos = 0;
    size_t cap = std::min<size_t>(256, bufsize - pos) - 1;
    size_t k = std::min(cap, code.size() - at);
    d.push_back((uint8_t)k);
    d.insert(d.end(), code.begin() + at, code.begin() + at + k);
    at += k;
    pos += 1 + k;
  }
  *out = give(d, n);
  return *out ? 0 : 1;
}

// filter: 1 Lanczos, 3 bicubic (Pillow's Resampling numbers)
int saveenc_resample(const uint8_t* rgb, int w, int h, int ow, int oh, int filter, uint8_t* out) {
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  int ksh = coeffs(w, ow, filter, bh, kh);
  int ksv = coeffs(h, oh, filter, bv, kv);
  bool need_h = ow != w, need_v = oh != h;
  int first = bv[0], last = bv[oh * 2 - 2] + bv[oh * 2 - 1];
  const uint8_t* src = rgb;
  int sw = w, sh = h;
  std::vector<uint8_t> tmp;
  if (need_h) {
    for (int i = 0; i < oh; i++) bv[i * 2] -= first;
    int rows = last - first;
    tmp.assign((size_t)rows * ow * 3, 0);
    for (int yy = 0; yy < rows; yy++) {
      const uint8_t* in = rgb + (size_t)(yy + first) * w * 3;
      uint8_t* o = &tmp[(size_t)yy * ow * 3];
      for (int xx = 0; xx < ow; xx++) {
        int xmin = bh[xx * 2], xmax = bh[xx * 2 + 1];
        const int32_t* k = &kh[(size_t)xx * ksh];
        int32_t s0 = 1 << (kPrecision - 1), s1 = s0, s2 = s0;
        for (int x = 0; x < xmax; x++) {
          const uint8_t* p = in + (size_t)(x + xmin) * 3;
          s0 += p[0] * k[x];
          s1 += p[1] * k[x];
          s2 += p[2] * k[x];
        }
        o[3 * xx] = clip8(s0);
        o[3 * xx + 1] = clip8(s1);
        o[3 * xx + 2] = clip8(s2);
      }
    }
    src = tmp.data();
    sw = ow;
    sh = rows;
  }
  if (need_v) {
    for (int yy = 0; yy < oh; yy++) {
      int ymin = bv[yy * 2], ymax = bv[yy * 2 + 1];
      const int32_t* k = &kv[(size_t)yy * ksv];
      uint8_t* o = out + (size_t)yy * sw * 3;
      for (int xx = 0; xx < sw; xx++) {
        int32_t s0 = 1 << (kPrecision - 1), s1 = s0, s2 = s0;
        for (int y = 0; y < ymax; y++) {
          const uint8_t* p = src + ((size_t)(y + ymin) * sw + xx) * 3;
          s0 += p[0] * k[y];
          s1 += p[1] * k[y];
          s2 += p[2] * k[y];
        }
        o[3 * xx] = clip8(s0);
        o[3 * xx + 1] = clip8(s1);
        o[3 * xx + 2] = clip8(s2);
      }
    }
  } else {
    memcpy(out, src, (size_t)sw * sh * 3);
  }
  (void)sh;
  return 0;
}

void saveenc_free(uint8_t* p) { free(p); }

}  // extern "C"
