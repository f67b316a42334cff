/* A JPEG writer over the system's libjpeg for the port's decoder tests:
 * the forms Pillow cannot write (arithmetic coding, YCCK, CMYK with or
 * without an Adobe marker, restart intervals, sampling factors).
 *
 *   jpegwrite_helper IN OUT W H COMPONENTS SPACE ARITH PROGRESSIVE
 *                    QUALITY RESTART H0 V0 [ADOBE]
 *
 * IN: W*H*COMPONENTS raw bytes; SPACE: the file's colour space (gray,
 * rgb, ycc, cmyk, ycck); H0 V0: the first component's sampling factors
 * (the others 1x1); ADOBE: 0 leaves out the Adobe APP14 marker that
 * libjpeg writes for CMYK and YCCK.
 * Build: cc -O2 -o jpegwrite_helper jpegwrite_helper.c -ljpeg
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

int main(int argc, char** argv) {
  if (argc < 13) {
    fprintf(stderr, "usage: see the source\n");
    return 2;
  }
  int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]);
  const char* space = argv[6];
  int arith = atoi(argv[7]), prog = atoi(argv[8]), q = atoi(argv[9]);
  int restart = atoi(argv[10]), h0 = atoi(argv[11]), v0 = atoi(argv[12]);
  int adobe = argc > 13 ? atoi(argv[13]) : 1;
  size_t n = (size_t)w * h * nc;
  unsigned char* px = malloc(n);
  FILE* f = fopen(argv[1], "rb");
  if (!f || fread(px, 1, n, f) != n) return 3;
  fclose(f);
  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  FILE* out = fopen(argv[2], "wb");
  if (!out) return 3;
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = nc;
  cinfo.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&cinfo);
  J_COLOR_SPACE js = JCS_YCbCr;
  if (!strcmp(space, "gray")) js = JCS_GRAYSCALE;
  if (!strcmp(space, "rgb")) js = JCS_RGB;
  if (!strcmp(space, "cmyk")) js = JCS_CMYK;
  if (!strcmp(space, "ycck")) js = JCS_YCCK;
  jpeg_set_colorspace(&cinfo, js);
  jpeg_set_quality(&cinfo, q, TRUE);
  cinfo.arith_code = arith ? TRUE : FALSE;
  cinfo.restart_interval = restart;
  cinfo.comp_info[0].h_samp_factor = h0;
  cinfo.comp_info[0].v_samp_factor = v0;
  for (int i = 1; i < cinfo.num_components; i++) {
    cinfo.comp_info[i].h_samp_factor = 1;
    cinfo.comp_info[i].v_samp_factor = 1;
  }
  if (!adobe) cinfo.write_Adobe_marker = FALSE;
  if (prog) jpeg_simple_progression(&cinfo);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = px + (size_t)cinfo.next_scanline * w * nc;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  free(px);
  return 0;
}
