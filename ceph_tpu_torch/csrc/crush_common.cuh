// What the port's CRUSH kernels share (crush_fast.cu: K7a, K7b, K6; crush_legacy.cu: K8),
// included by each: the rjenkins hashes of crush/hash.c and mapper.c's is_out.
#pragma once

#include <stdint.h>

namespace {

constexpr uint32_t kSeed = 1315423911u;

// ---- rjenkins (crush/hash.c) ------------------------------------------------------------------

#define CRUSH_MIX(a, b, c)          \
  do {                              \
    a -= b; a -= c; a ^= (c >> 13); \
    b -= c; b -= a; b ^= (a << 8);  \
    c -= a; c -= b; c ^= (b >> 13); \
    a -= b; a -= c; a ^= (c >> 12); \
    b -= c; b -= a; b ^= (a << 16); \
    c -= a; c -= b; c ^= (b >> 5);  \
    a -= b; a -= c; a ^= (c >> 3);  \
    b -= c; b -= a; b ^= (a << 10); \
    c -= a; c -= b; c ^= (b >> 15); \
  } while (0)

__device__ __forceinline__ uint32_t hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = kSeed ^ a ^ b, x = 231232u, y = 1232u;
  CRUSH_MIX(a, b, h);
  CRUSH_MIX(x, a, h);
  CRUSH_MIX(b, y, h);
  return h;
}

__device__ __forceinline__ uint32_t hash32_3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = kSeed ^ a ^ b ^ c, x = 231232u, y = 1232u;
  CRUSH_MIX(a, b, h);
  CRUSH_MIX(c, x, h);
  CRUSH_MIX(y, a, h);
  CRUSH_MIX(b, x, h);
  CRUSH_MIX(y, c, h);
  return h;
}

// ---- rjenkins split across the integer and FMA pipes -------------------------------------------
//
// A sub-partition of an H100 SM issues one warp instruction per clock, but its integer pipe
// (IADD3, LOP3, SHF, ISETP, SEL, LEA) has 16 lanes and takes one only every other clock; IMAD
// runs on the FMA pipe, which has the other half.  hash32_3 above compiles, per mix, to 9
// IADD3, 9 LOP3 and 6 SHF on the integer pipe and 3 IMAD.SHL (ptxas' own form of the left
// shifts): the integer pipe sets the pace, 48 clocks a mix where the issue rate allows 27.
// Mod 2^32, a - b - c is c * 0xFFFFFFFF + (b * 0xFFFFFFFF + a), two IMADs, so the same hash,
// bit for bit, can move work onto the FMA pipe.  hash32_3_split takes the subtractions of the
// first 7 of each mix's 9 lines there, the split chip_smoke.py's hash probe timed fastest
// (PERF.md section 6).  The multiplier `neg1` (0xFFFFFFFF) comes from the launch, not from a
// literal, so that ptxas cannot turn a known multiply back into subtractions.

__device__ __forceinline__ uint32_t mad_lo(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// a - b - c on the FMA pipe, a - b first (a and b are the older words, off the chain)
__device__ __forceinline__ uint32_t sub_fma(uint32_t a, uint32_t b, uint32_t c, uint32_t neg1) {
  return mad_lo(c, neg1, mad_lo(b, neg1, a));
}

__device__ __forceinline__ void mix_split(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t neg1) {
  a = sub_fma(a, b, c, neg1) ^ (c >> 13);
  b = sub_fma(b, c, a, neg1) ^ (a << 8);
  c = sub_fma(c, a, b, neg1) ^ (b >> 13);
  a = sub_fma(a, b, c, neg1) ^ (c >> 12);
  b = sub_fma(b, c, a, neg1) ^ (a << 16);
  c = sub_fma(c, a, b, neg1) ^ (b >> 5);
  a = sub_fma(a, b, c, neg1) ^ (c >> 3);
  b = (b - c - a) ^ (a << 10);
  c = (c - a - b) ^ (b >> 15);
}

__device__ __forceinline__ uint32_t hash32_3_split(uint32_t a, uint32_t b, uint32_t c,
                                                   uint32_t neg1) {
  uint32_t h = kSeed ^ a ^ b ^ c, x = 231232u, y = 1232u;
  mix_split(a, b, h, neg1);
  mix_split(c, x, h, neg1);
  mix_split(y, a, h, neg1);
  mix_split(b, x, h, neg1);
  mix_split(y, c, h, neg1);
  return h;
}

// ---- mapper.c is_out -------------------------------------------------------------------------

// is_out with the item's weight already loaded (`w`, any value past the vector): a device past
// the weight vector is out; w >= 1.0 keeps it, 0 rejects it, otherwise the hash of (x, item)
// decides.
__device__ __forceinline__ bool is_out_w(int item, uint32_t w, int n_weight, uint32_t x) {
  if (item >= n_weight) return true;
  if (w >= 0x10000u) return false;
  if (w == 0) return true;
  return (hash32_2(x, (uint32_t)item) & 0xFFFFu) >= w;
}

__device__ __forceinline__ uint32_t weight_of(const uint32_t* weight, int n_weight, int item) {
  return item < n_weight ? __ldg(weight + max(item, 0)) : 0u;
}

}  // namespace
