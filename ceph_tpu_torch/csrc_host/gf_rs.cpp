// Native GF(2^8) region coder — the SIMD-class host path.
//
// The port's copy of native/gf_rs.cpp, built by ceph_tpu_torch/native.py.
//
// Plays the role of the reference's isa-l/jerasure native libraries
// (ec_encode_data; reference src/erasure-code/isa/ErasureCodeIsa.cc:128):
// region multiply-accumulate over GF(2^8) using 4-bit split tables, which
// GCC auto-vectorizes.  Used as the CPU benchmark baseline and as a second
// implementation cross-checking the Python/numpy codec.

#include <cstdint>
#include <cstring>

namespace {

constexpr unsigned POLY = 0x11d;

struct Tables {
  uint8_t mul[256][256];
  bool ready = false;
} g;

void init_tables() {
  if (g.ready) return;
  uint8_t exp[512];
  int log[256] = {0};
  unsigned x = 1;
  for (int i = 0; i < 255; i++) {
    exp[i] = (uint8_t)x;
    log[x] = i;
    x <<= 1;
    if (x & 0x100) x ^= POLY;
  }
  for (int i = 255; i < 512; i++) exp[i] = exp[i - 255];
  for (int a = 1; a < 256; a++)
    for (int b = 1; b < 256; b++)
      g.mul[a][b] = exp[log[a] + log[b]];
  memset(g.mul[0], 0, 256);
  for (int a = 0; a < 256; a++) g.mul[a][0] = 0;
  g.ready = true;
}

// dst ^= coeff * src over a region, via split lo/hi nibble tables
void region_mad(uint8_t coeff, const uint8_t* src, uint8_t* dst, int64_t n) {
  if (coeff == 0) return;
  if (coeff == 1) {
    for (int64_t i = 0; i < n; i++) dst[i] ^= src[i];
    return;
  }
  uint8_t lo[16], hi[16];
  for (int v = 0; v < 16; v++) {
    lo[v] = g.mul[coeff][v];
    hi[v] = g.mul[coeff][v << 4];
  }
  for (int64_t i = 0; i < n; i++) {
    uint8_t b = src[i];
    dst[i] ^= (uint8_t)(lo[b & 0xf] ^ hi[b >> 4]);
  }
}

}  // namespace

extern "C" {

// coding[r][*] = sum_j matrix[r*k+j] * data[j][*]; data/coding are
// contiguous (k, n) and (rows, n) uint8 buffers.
void gf_rs_encode(const uint8_t* matrix, int rows, int k,
                  const uint8_t* data, uint8_t* coding, int64_t n) {
  init_tables();
  memset(coding, 0, (size_t)rows * n);
  for (int r = 0; r < rows; r++)
    for (int j = 0; j < k; j++)
      region_mad(matrix[r * k + j], data + (int64_t)j * n,
                 coding + (int64_t)r * n, n);
}

void gf_region_xor(const uint8_t* a, const uint8_t* b, uint8_t* out,
                   int64_t n) {
  for (int64_t i = 0; i < n; i++) out[i] = a[i] ^ b[i];
}

uint8_t gf_mul_c(uint8_t a, uint8_t b) {
  init_tables();
  return g.mul[a][b];
}

// crc32c (Castagnoli), table-driven, in Ceph's convention: the raw table
// update with NO pre/post bit inversion (reference include/crc32c.h
// ceph_crc32c -> common/sctp_crc32.c update_crc32; golden vectors in
// test/common/test_crc32c.cc, e.g. crc32c(0, "foo bar baz") = 4119623852).
uint32_t ceph_crc32c(uint32_t crc, const uint8_t* data, int64_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int j = 0; j < 8; j++)
        c = (c & 1) ? (c >> 1) ^ 0x82f63b78u : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  for (int64_t i = 0; i < n; i++)
    crc = table[(crc ^ data[i]) & 0xff] ^ (crc >> 8);
  return crc;
}

}  // extern "C"
