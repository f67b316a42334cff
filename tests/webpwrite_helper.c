/* WebP files with the encoder options Pillow's save does not expose, for
 * the decoder tests: libwebp's WebPEncode (the copy Pillow bundles, loaded
 * by the caller with RTLD_GLOBAL) on an RGBA image.
 *
 * opts: lossless, quality, method, segments, sns_strength,
 * filter_strength, filter_sharpness, filter_type, autofilter,
 * alpha_compression, alpha_filtering, alpha_quality, partitions, exact,
 * use_alpha (0: import RGB only, so the file has no alpha), pass.
 * Returns 0 and the file in *out (free with webp_helper_free), or a
 * negative code. */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <webp/encode.h>

int webp_helper_encode(const uint8_t* rgba, int w, int h, const int* o,
                       uint8_t** out, size_t* size) {
  /* room for a larger struct of a later minor ABI version */
  union { WebPConfig c; char pad[2048]; } cfg;
  union { WebPPicture p; char pad[8192]; } pic;
  union { WebPMemoryWriter m; char pad[1024]; } wr;
  memset(&cfg, 0, sizeof(cfg));
  memset(&pic, 0, sizeof(pic));
  memset(&wr, 0, sizeof(wr));
  if (!WebPConfigInit(&cfg.c)) return -1;
  cfg.c.lossless = o[0];
  cfg.c.quality = (float)o[1];
  cfg.c.method = o[2];
  cfg.c.segments = o[3];
  cfg.c.sns_strength = o[4];
  cfg.c.filter_strength = o[5];
  cfg.c.filter_sharpness = o[6];
  cfg.c.filter_type = o[7];
  cfg.c.autofilter = o[8];
  cfg.c.alpha_compression = o[9];
  cfg.c.alpha_filtering = o[10];
  cfg.c.alpha_quality = o[11];
  cfg.c.partitions = o[12];
  cfg.c.exact = o[13];
  cfg.c.pass = o[15];
  if (!WebPValidateConfig(&cfg.c)) return -2;
  if (!WebPPictureInit(&pic.p)) return -3;
  pic.p.use_argb = o[0];
  pic.p.width = w;
  pic.p.height = h;
  int ok;
  if (o[14]) {
    ok = WebPPictureImportRGBA(&pic.p, rgba, w * 4);
  } else {
    ok = WebPPictureImportRGBX(&pic.p, rgba, w * 4);
  }
  if (!ok) return -4;
  WebPMemoryWriterInit(&wr.m);
  pic.p.writer = WebPMemoryWrite;
  pic.p.custom_ptr = &wr.m;
  ok = WebPEncode(&cfg.c, &pic.p);
  const int err = pic.p.error_code;
  WebPPictureFree(&pic.p);
  if (!ok) {
    WebPMemoryWriterClear(&wr.m);
    return -100 - err;
  }
  *out = wr.m.mem;
  *size = wr.m.size;
  return 0;
}

void webp_helper_free(void* p) { WebPFree(p); }
