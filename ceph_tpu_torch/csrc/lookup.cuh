// Shared-memory table lookups of the port's kernels (gf_bit_matmul.cu, crc32c.cu,
// fused_encode_crc.cu), included by each.
//
// Every table is 16 u32 entries indexed by one nibble, so a warp-wide lookup spans at most 16
// banks and is one shared-memory wavefront whatever the data.  A table sits at a 256-byte
// aligned base plus a constant offset: one byte permute writes the lookup's index (nibble * 4)
// into the base's low byte and yields its shared address, and the offset rides in the load's
// immediate, so no add is spent on an address.
#pragma once

#include <stdint.h>

namespace {

template <int OFF>
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1+%2];" : "=r"(v) : "r"(addr), "n"(OFF));
  return v;
}

// The GF(2^8) product: acc[b] ^= T_J[byte b of x] for the four bytes of x, where data row J of
// the chunk of rows at shared address `base` holds its low-nibble table L at +128 J and its
// high-nibble table H at +128 J + 64 (T_J[x] = L[x & 15] ^ H[x >> 4], one u32 holding four
// output rows' bytes).
template <int J>
__device__ __forceinline__ void lookup_word(uint32_t x, uint32_t base, uint32_t* acc) {
  const uint32_t lo4 = (x << 2) & 0x3c3c3c3cu;   // low nibble * 4, per byte
  const uint32_t hi4 = (x >> 2) & 0x3c3c3c3cu;   // high nibble * 4, per byte
#pragma unroll
  for (int b = 0; b < 4; ++b)
    acc[b] ^= lds<J * 128>(__byte_perm(lo4, base, 0x7650 + b)) ^
              lds<J * 128 + 64>(__byte_perm(hi4, base, 0x7650 + b));
}

// The product's transpose: acc[4c + b] holds column 4c + b's four output bytes (byte q: row q
// of the group); o[q][c] is word c of output row q.
__device__ __forceinline__ void transpose(const uint32_t* acc, uint32_t (*o)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t* a = acc + 4 * c;
    const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140), t1 = __byte_perm(a[0], a[1], 0x7362);
    const uint32_t t2 = __byte_perm(a[2], a[3], 0x5140), t3 = __byte_perm(a[2], a[3], 0x7362);
    o[0][c] = __byte_perm(t0, t2, 0x5410);
    o[1][c] = __byte_perm(t0, t2, 0x7632);
    o[2][c] = __byte_perm(t1, t3, 0x5410);
    o[3][c] = __byte_perm(t1, t3, 0x7632);
  }
}

// The crc: XOR over the four bytes b of x of table K + 2b (64 B each) at the low nibble and
// K + 2b + 1 at the high.
template <int K>
__device__ __forceinline__ uint32_t nib_word(uint32_t x, uint32_t base) {
  const uint32_t lo4 = (x << 2) & 0x3c3c3c3cu, hi4 = (x >> 2) & 0x3c3c3c3cu;
  return lds<64 * K>(__byte_perm(lo4, base, 0x7650)) ^
         lds<64 * (K + 1)>(__byte_perm(hi4, base, 0x7650)) ^
         lds<64 * (K + 2)>(__byte_perm(lo4, base, 0x7651)) ^
         lds<64 * (K + 3)>(__byte_perm(hi4, base, 0x7651)) ^
         lds<64 * (K + 4)>(__byte_perm(lo4, base, 0x7652)) ^
         lds<64 * (K + 5)>(__byte_perm(hi4, base, 0x7652)) ^
         lds<64 * (K + 6)>(__byte_perm(lo4, base, 0x7653)) ^
         lds<64 * (K + 7)>(__byte_perm(hi4, base, 0x7653));
}

// x times the GF(2) matrix whose column q is m[q].
__device__ __forceinline__ uint32_t apply(const uint32_t* m, uint32_t x) {
  uint32_t y = 0u;
#pragma unroll
  for (int q = 0; q < 32; ++q) y ^= m[q] & (0u - ((x >> q) & 1u));
  return y;
}

}  // namespace
