// ltc_dump: evaluate the REFERENCE renderer's LTC runtime
// (reference src/LTC/ltc.cpp GetPDF:59-87 / GetRandom:113-143) on a
// grid of inputs, for numerical parity tests of rgk/ops/ltc.py.
//
// Links against the reference objects compiled by build.sh
// (src_LTC_ltc.cpp.o + the generated tables + glm shim).
//
// Input : .npy f32 [N, 11]  rows = (kind, vi.xyz, vr.xyz, alpha,
//                                   rand_hscos.xyz)
//         kind 0 = Beckmann, 1 = GGX; vectors in the local +Z frame.
// Output: .npy f32 [N, 4]   rows = (GetPDF(N=+Z, vr, vi, alpha),
//                                   GetRandom(N=+Z, vi, alpha, rand))
//
// Build (see build.sh): g++ ltc_dump.cpp <ltc objects> -o ltc_dump
// Usage: ltc_dump in.npy out.npy
#include "../../../reference/src/LTC/ltc.hpp"

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

static float* read_npy_f32(const char* path, int* rows, int* cols) {
  FILE* f = fopen(path, "rb");
  if (!f) { perror("fopen"); exit(1); }
  char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "\x93NUMPY", 6)) {
    fprintf(stderr, "bad npy magic\n"); exit(1);
  }
  uint16_t hlen;
  if (fread(&hlen, 2, 1, f) != 1) { exit(1); }
  std::vector<char> hdr(hlen + 1, 0);
  if (fread(hdr.data(), 1, hlen, f) != hlen) { exit(1); }
  // Expect "{'descr': '<f4', 'fortran_order': False, 'shape': (N, C), }"
  const char* sh = strstr(hdr.data(), "shape");
  if (!sh || !strstr(hdr.data(), "<f4")) {
    fprintf(stderr, "npy must be little-endian f32 with a shape\n");
    exit(1);
  }
  if (sscanf(sh, "shape': (%d, %d)", rows, cols) != 2) {
    fprintf(stderr, "unparseable shape\n"); exit(1);
  }
  float* data = (float*)malloc((size_t)*rows * *cols * 4);
  if (fread(data, 4, (size_t)*rows * *cols, f) != (size_t)*rows * *cols) {
    fprintf(stderr, "short read\n"); exit(1);
  }
  fclose(f);
  return data;
}

static void write_npy_f32(const char* path, const float* data,
                          int rows, int cols) {
  char dict[128];
  int n = snprintf(dict, sizeof dict,
                   "{'descr': '<f4', 'fortran_order': False, "
                   "'shape': (%d, %d), }", rows, cols);
  int pad = (64 - (10 + n) % 64) % 64;
  FILE* f = fopen(path, "wb");
  if (!f) { perror("fopen"); exit(1); }
  uint16_t hlen = (uint16_t)(n + pad);
  fwrite("\x93NUMPY\x01\x00", 1, 8, f);
  fwrite(&hlen, 2, 1, f);
  fwrite(dict, 1, n, f);
  for (int i = 0; i < pad - 1; i++) fputc(' ', f);
  fputc('\n', f);
  fwrite(data, 4, (size_t)rows * cols, f);
  fclose(f);
}

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: ltc_dump in.npy out.npy\n");
    return 2;
  }
  int n, c;
  float* in = read_npy_f32(argv[1], &n, &c);
  if (c != 11) { fprintf(stderr, "need 11 cols, got %d\n", c); return 2; }
  std::vector<float> out((size_t)n * 4);
  const glm::vec3 N(0.0f, 0.0f, 1.0f);
  for (int i = 0; i < n; i++) {
    const float* r = in + (size_t)i * 11;
    LTCdef def = (r[0] < 0.5f) ? LTC::Beckmann : LTC::GGX;
    glm::vec3 vi(r[1], r[2], r[3]);
    glm::vec3 vr(r[4], r[5], r[6]);
    float alpha = r[7];
    glm::vec3 rnd(r[8], r[9], r[10]);
    out[(size_t)i * 4 + 0] = LTC::GetPDF(def, N, vr, vi, alpha);
    glm::vec3 s = LTC::GetRandom(def, N, vi, alpha, rnd);
    out[(size_t)i * 4 + 1] = s.x;
    out[(size_t)i * 4 + 2] = s.y;
    out[(size_t)i * 4 + 3] = s.z;
  }
  write_npy_f32(argv[2], out.data(), n, 4);
  return 0;
}
