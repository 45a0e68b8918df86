// K8: the legacy-tunables CRUSH mapper on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the jitted XLA function of ceph_tpu/ops/crush_legacy.py: LegacyFastRule._resolve_all
// (:387, jitted :174) with _draw_tables (:177), _is_out (:244), _upper (:256), _leaf_machine
// (:265) and _stage_machine (:310).  It maps x under one firstn rule of a map with pre-bobtail
// tunables (choose_local_tries / choose_local_fallback_tries > 0), straw (v1) and straw2 buckets:
// a single take, chained choose steps, a chooseleaf of depth 1 in the last, vary_r 0.
//
// The JAX formulation materialises, per x, both draws of every bucket at every retry value, and
// the Fisher-Yates permutation behind the fallback draw as an (x, bucket, r, item) tensor: ~435 KB
// per x on a 1000-OSD map, ~43 GB for 100000 x.  This kernel instead runs one thread per x
// through mapper.c's crush_choose_firstn (mapper.c:443-636; ceph_tpu_torch/crush/mapper.py
// _choose_firstn) as written, drawing only what that x's walk reaches:
//
// - A stage's intervening levels are plain draws at the slot's descent r = rep + ftotal; the
//   bottom bucket's draw is the straw (v1) draw, (hash32_3(x, item, r) & 0xffff) * straw as a u64,
//   the first maximum winning, or the straw2 draw (the s64 G[u] / w of K6, the first minimum).
// - A collision or rejection retries at the failing bucket (flocal++) while the local counts
//   allow, then descends again while ftotal < tries.  Once flocal >= size >> 1 and flocal >
//   choose_local_fallback_tries, the draw is bucket_perm_choose (mapper.c:76-131): with pr = r %
//   size, Fisher-Yates steps p = 0..pr (p < size - 1) swap position p with p + hash32_3(x, id, p)
//   % (size - p) in a per-thread scratch of the bucket's size (local memory, kMaxBucket items;
//   the wrapper refuses a wider bucket before launching), and item perm[pr] is drawn.
// - The chooseleaf recursion is an inner loop over the chosen host's devices with its own
//   ftotal/flocal, recurse_tries descents, base r = outpos (0 under chooseleaf_stable), and the
//   leaves emitted so far as its collision scope.
// - A stage runs over every parent the previous one emitted, each with the room that is left of
//   result_max, appending in order; EMIT writes the row.
//
// So every x runs to the reference's own end and no x is left for the host.  An item past the
// weight vector is out, as mapper.c's is_out has it.
//
// Bound on this card: instructions.  Each item the walk hashes (an item of a straw draw, a
// Fisher-Yates step, an is_out test) costs one hash32_3 or hash32_2 plus a few operations,
// ~141 instructions at most (K7a's draw), at the card's instruction rate (132 SMs x 4 schedulers
// x 32 lanes x 1.98 GHz).  On the 1000-OSD rack map an x of the size-3 chooseleaf rule hashes
// ~110 items when every OSD is in: ~0.05 ms for 100000 x.  This first form keeps each x on one
// thread, its slot arrays and permutation scratch in local memory, and the straw loops serial;
// the lanes of a warp diverge where their x retry differently.
#include <cuda_runtime.h>
#include <stdint.h>

#include "crush_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRep = 32;                   // most slots of result_max (w, o, c)
constexpr int kMaxBucket = 256;               // widest bucket the perm scratch holds
constexpr int kNone = 0x7FFFFFFF;             // CRUSH_ITEM_NONE
constexpr int kAlgStraw2 = 5;                 // CRUSH_BUCKET_STRAW2
constexpr long long kZeroDraw = 1LL << 62;    // a zero straw2 weight's quotient (sorts last)

struct Map {
  const int* items;         // (nb, S) item ids, NONE past a bucket's size
  const int* sizes;         // (nb,)
  const int* algs;          // (nb,) CRUSH_BUCKET_*
  const uint32_t* straws;   // (nb, S) straw (v1) scalers
  const uint32_t* weights;  // (nb, S) straw2 weights (position 0)
  const long long* g;       // (65536,) G[u] = 2^48 - crush_ln(u)
  const uint32_t* weight;   // (n_weight,) the epoch's 16.16 device weights
  int nb, s, n_weight;
};

struct Rule {
  const int* prog;          // (n_stages, 4): numrep, depth, leafy, recurse tries
  int n_stages, take_b, tries, local_retries, local_fallback, stable, result_max;
};

// The bucket's own draw at r (mapper.c bucket_straw_choose / bucket_straw2_choose).
__device__ int bucket_draw(const Map& m, int b, uint32_t x, uint32_t r) {
  const int size = __ldg(m.sizes + b);
  const long long row = (long long)b * m.s;
  int win = 0;
  if (__ldg(m.algs + b) == kAlgStraw2) {
    long long best = 0;
    for (int k = 0; k < size; ++k) {
      const uint32_t wk = __ldg(m.weights + row + k);
      long long q = kZeroDraw;
      if (wk) {
        const uint32_t u = hash32_3(x, (uint32_t)__ldg(m.items + row + k), r) & 0xFFFFu;
        q = __ldg(m.g + u) / (long long)wk;
      }
      if (k == 0 || q < best) { best = q; win = k; }
    }
  } else {
    unsigned long long best = 0;
    for (int k = 0; k < size; ++k) {
      const uint32_t u = hash32_3(x, (uint32_t)__ldg(m.items + row + k), r) & 0xFFFFu;
      const unsigned long long d = (unsigned long long)u * __ldg(m.straws + row + k);
      if (k == 0 || d > best) { best = d; win = k; }
    }
  }
  return __ldg(m.items + row + win);
}

// bucket_perm_choose: item perm[r % size] of the (bucket, x) Fisher-Yates shuffle, whose steps
// after r % size never touch that position.
__device__ int perm_draw(const Map& m, int b, uint32_t x, uint32_t r, uint8_t* perm) {
  const int size = __ldg(m.sizes + b);
  const int pr = (int)(r % (uint32_t)size);
  for (int i = 0; i < size; ++i) perm[i] = (uint8_t)i;
  for (int p = 0; p <= pr && p < size - 1; ++p) {
    const int i = (int)(hash32_3(x, (uint32_t)(-1 - b), (uint32_t)p) % (uint32_t)(size - p));
    if (i) {
      const uint8_t t = perm[p];
      perm[p] = perm[p + i];
      perm[p + i] = t;
    }
  }
  return __ldg(m.items + (long long)b * m.s + perm[pr]);
}

// The draw of a retry at bucket b: the permutation once the local count has passed size >> 1
// and the fallback count (mapper.c:470-476).
__device__ __forceinline__ int retry_draw(const Map& m, const Rule& ru, int b, int size,
                                          uint32_t x, uint32_t r, int flocal, uint8_t* perm) {
  if (ru.local_fallback > 0 && flocal >= (size >> 1) && flocal > ru.local_fallback)
    return perm_draw(m, b, x, r, perm);
  return bucket_draw(m, b, x, r);
}

__device__ __forceinline__ bool is_out(const Map& m, int item, uint32_t x) {
  return is_out_w(item, weight_of(m.weight, m.n_weight, item), m.n_weight, x);
}

// The chooseleaf recursion (mapper.c:541-558 into crush_choose_firstn with numrep 1, type 0):
// one device of host bucket hb that is none of leaves[0..outpos), at r = rep + ftotal.
__device__ bool choose_leaf(const Map& m, const Rule& ru, int hb, uint32_t x, int rep,
                            int tries, const int* leaves, int outpos, int* leaf,
                            uint8_t* perm) {
  const int size = __ldg(m.sizes + hb);
  int ftotal = 0, flocal = 0;
  while (true) {
    bool collide = false, reject = true;
    int item = 0;
    if (size > 0) {
      item = retry_draw(m, ru, hb, size, x, (uint32_t)(rep + ftotal), flocal, perm);
      for (int i = 0; i < outpos; ++i) collide |= leaves[i] == item;
      reject = !collide && is_out(m, item, x);
    }
    if (!reject && !collide) {
      *leaf = item;
      return true;
    }
    ++ftotal;
    ++flocal;
    if (collide && flocal <= ru.local_retries) continue;
    if (ru.local_fallback > 0 && flocal <= size + ru.local_fallback) continue;
    if (ftotal < tries) {
      flocal = 0;
      continue;
    }
    return false;
  }
}

// crush_choose_firstn (mapper.c:443-636) from bucket b0 with `count` slots of room: writes the
// chosen items to o[0..) and, when leafy, their leaves to c[0..); returns how many.
__device__ int choose_firstn(const Map& m, const Rule& ru, int b0, uint32_t x, int numrep,
                             int depth, bool leafy, int recurse, int* o, int* c, int count,
                             uint8_t* perm) {
  int outpos = 0;
  for (int rep = 0; rep < numrep && count > 0; ++rep) {
    int ftotal = 0, flocal = 0, in_b = b0, item = 0;
    bool descend = true, skip = false;
    while (true) {
      if (descend) {                       // retry_descent: down to the stage's bottom bucket
        in_b = b0;
        flocal = 0;
        for (int d = 1; d < depth; ++d)
          in_b = -1 - bucket_draw(m, in_b, x, (uint32_t)(rep + ftotal));
        descend = false;
      }
      const int size = __ldg(m.sizes + in_b);
      bool collide = false, reject = true;
      if (size > 0) {
        item = retry_draw(m, ru, in_b, size, x, (uint32_t)(rep + ftotal), flocal, perm);
        for (int i = 0; i < outpos; ++i) collide |= o[i] == item;
        reject = false;
        if (!collide && leafy) {
          if (item < 0) {
            int leaf;
            reject = !choose_leaf(m, ru, -1 - item, x, ru.stable ? 0 : outpos, recurse, c, outpos,
                                  &leaf, perm);
            if (!reject) c[outpos] = leaf;
          } else {
            c[outpos] = item;
          }
        }
        if (!reject && !collide && item >= 0) reject = is_out(m, item, x);
      }
      if (!reject && !collide) break;
      ++ftotal;
      ++flocal;
      if (collide && flocal <= ru.local_retries) continue;                   // retry_bucket
      if (ru.local_fallback > 0 && flocal <= size + ru.local_fallback) continue;
      if (ftotal < ru.tries) {
        descend = true;
        continue;
      }
      skip = true;
      break;
    }
    if (!skip) {
      o[outpos++] = item;
      --count;
    }
  }
  return outpos;
}

__global__ void __launch_bounds__(kThreads)
crush_legacy_kernel(const int* __restrict__ xs, long long n, int* __restrict__ out,
                    int* __restrict__ counts, Map m, Rule ru) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = (uint32_t)xs[i];
  uint8_t perm[kMaxBucket];
  int w[kMaxRep], o[kMaxRep], c[kMaxRep];
  int wsize = 1;
  w[0] = -1 - ru.take_b;
  for (int s = 0; s < ru.n_stages; ++s) {
    const int numrep = __ldg(ru.prog + 4 * s), depth = __ldg(ru.prog + 4 * s + 1);
    const bool leafy = __ldg(ru.prog + 4 * s + 2) != 0;
    const int recurse = __ldg(ru.prog + 4 * s + 3);
    int osize = 0;
    for (int p = 0; p < wsize && osize < ru.result_max; ++p)
      osize += choose_firstn(m, ru, -1 - w[p], x, numrep, depth, leafy, recurse, o + osize,
                             c + osize, ru.result_max - osize, perm);
    for (int k = 0; k < osize; ++k) w[k] = leafy ? c[k] : o[k];
    wsize = osize;
  }
  for (int k = 0; k < ru.result_max; ++k) out[i * ru.result_max + k] = k < wsize ? w[k] : kNone;
  counts[i] = wsize;
}

}  // namespace

// K8 over n x: out (n, result_max) int32 rows (NONE past each count) and counts (n,).  The map
// tables, the rule program and the weights live on the device; nothing is allocated here.
extern "C" int crush_legacy_launch(const int* xs, long long n, int* out, int* counts,
                                   const int* items, const int* sizes, const int* algs,
                                   const uint32_t* straws, const uint32_t* weights,
                                   const long long* g, int nb, int s, const int* prog,
                                   int n_stages, int take_b, int tries, int local_retries,
                                   int local_fallback, int stable, int result_max,
                                   const uint32_t* weight, int n_weight, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (result_max < 1 || result_max > kMaxRep || s > kMaxBucket) return (int)cudaErrorInvalidValue;
  const Map m{items, sizes, algs, straws, weights, g, weight, nb, s, n_weight};
  const Rule ru{prog, n_stages, take_b, tries, local_retries, local_fallback, stable, result_max};
  const long long blocks = (n + kThreads - 1) / kThreads;
  crush_legacy_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(xs, n, out, counts, m, ru);
  return (int)cudaGetLastError();
}
