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
