// io/native/tiffdec.cc under AddressSanitizer and UBSan, for the tests:
// each argument names a case file, one line of text "codec occ width
// options" followed by the strip's bytes; each is decoded and its result
// (1 or 0) printed.
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <iterator>
#include <sstream>
#include <string>
#include <vector>

#include "../art_tpu_torch/io/native/tiffdec.cc"

int main(int argc, char** argv) {
  for (int a = 1; a < argc; a++) {
    std::ifstream f(argv[a], std::ios::binary);
    std::string head;
    std::getline(f, head);
    std::istringstream hs(head);
    std::string codec;
    size_t occ;
    int width, opts;
    hs >> codec >> occ >> width >> opts;
    std::vector<uint8_t> in((std::istreambuf_iterator<char>(f)), std::istreambuf_iterator<char>());
    std::vector<uint8_t> out(occ + 1);
    char msg[256];
    int r;
    if (codec == "zstd")
      r = tiffdec_zstd(in.data(), in.size(), out.data(), occ, msg, 256);
    else if (codec == "thunder")
      r = tiffdec_thunder(in.data(), in.size(), out.data(), occ, width, msg, 256);
    else
      r = tiffdec_fax(in.data(), in.size(), out.data(), occ, width, atoi(codec.c_str() + 3), opts,
                      msg, 256);
    printf("%d", r);
  }
  printf("\n");
  return 0;
}
