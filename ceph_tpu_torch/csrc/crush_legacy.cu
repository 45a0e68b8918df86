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
// per x on a 1000-OSD map, ~43 GB for 100000 x.  This kernel instead walks mapper.c's
// crush_choose_firstn (mapper.c:443-636; ceph_tpu_torch/crush/mapper.py _choose_firstn) for each
// x as written, drawing only what that x's walk reaches:
//
// - A stage's intervening levels are plain draws at the slot's descent r = rep + ftotal; the
//   bottom bucket's draw is the straw (v1) draw, (hash32_3(x, item, r) & 0xffff) * straw as a u64,
//   the first maximum winning, or the straw2 draw (the s64 G[u] / w of K6, the first minimum).
// - A collision or rejection retries at the failing bucket (flocal++) while the local counts
//   allow, then descends again while ftotal < tries.  Once flocal >= size >> 1 and flocal >
//   choose_local_fallback_tries, the draw is bucket_perm_choose (mapper.c:76-131): with pr = r %
//   size, Fisher-Yates steps p = 0..pr (p < size - 1) swap position p with p + hash32_3(x, id, p)
//   % (size - p), and item perm[pr] is drawn.
// - The chooseleaf recursion draws from the chosen host's devices with its own ftotal/flocal,
//   recurse_tries descents, base r = outpos (0 under chooseleaf_stable), and the leaves emitted
//   so far as its collision scope.
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
// ~106 items when every OSD is in: ~0.045 ms for 100000 x.
//
// The design: a group of G = 4 lanes per x (kLanes), 8 x per warp.  One thread per x (the first
// form) spent its time on three things: x that retry held their whole warp of 32 x, each x hashed
// its ~106 items as one dependent chain, and the slot arrays and permutation scratch sat in local
// memory.  Here
// - a straw draw is shared: lane l hashes items l, l + G, ... (two independent chains per step
//   while the bucket is that wide) and keeps its own first best; log2(G) xor shuffles over
//   (value, item index) leave the winner on every lane, with the reference's tie rules (straw
//   v1: the higher value, then the lower index; straw2: the lower value, then the lower index).
//   Every branch after a draw depends only on group-uniform values (the winner, ballots, the
//   rule program), so a group never diverges inside itself; groups of one warp do, and every
//   shuffle and ballot names its own group's lanes only (`mask`);
// - crush_choose_firstn and the chooseleaf recursion run as one flat machine per group with one
//   draw site: whatever step each group's x is at, the warp's groups draw together, and only the
//   few integer operations between draws diverge;
// - slot s of the outputs o, the leaves c and the stage's parents w lives in a register of lane
//   s % G (NS = 1 register per array when result_max <= G, the (L) rules' case; 32 / G
//   otherwise, indexed by unrolled selects): a collision test is one ballot, a write one lane's;
// - the permutation draw, rare, runs on the group's leader lane over a 256-byte scratch per group
//   in shared memory, and one shuffle hands perm[pr] to the group.
// G = 4 is the one lane count: wider groups (8, 16, 32) were slower on every rule and epoch of
// (L) timed, its 20-item host draws included (PERF.md section 6, PR 10).  A wider G comes back
// only with a timed case on a map whose buckets need it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "crush_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 4;                     // G: lanes per x
constexpr int kMaxRegs = 96;                  // registers a thread may take (see the kernel)
constexpr long long kMaxBlocks = 1 << 20;     // the grid's reach; its groups stride past it
constexpr int kUnroll = 2;                    // hash chains a lane interleaves in a draw
constexpr int kMaxRep = 32;                   // most slots of result_max (w, o, c)
constexpr int kMaxBucket = 256;               // widest bucket the perm scratch holds
constexpr int kNone = 0x7FFFFFFF;             // CRUSH_ITEM_NONE
constexpr int kAlgStraw2 = 5;                 // CRUSH_BUCKET_STRAW2
constexpr long long kZeroDraw = 1LL << 62;    // a zero straw2 weight's quotient (sorts last)
constexpr int kIntMax = 0x7FFFFFFF;
constexpr long long kLongMax = 0x7FFFFFFFFFFFFFFFLL;

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

// One x's lanes: this lane's rank in its group, the group's lanes in the warp, and the group's
// permutation scratch in shared memory.
struct Lanes {
  int lane;
  unsigned mask;
  uint8_t* perm;
};

// ---- the group's reductions ---------------------------------------------------------------------

// The first strict minimum over the lanes' (value, item index) pairs (straw2): the lower value
// first, the lower index on a tie; every lane ends on the winner's index.
__device__ __forceinline__ int first_min(unsigned mask, long long best, int bi) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const long long ov = __shfl_xor_sync(mask, best, off, kLanes);
    const int oi = __shfl_xor_sync(mask, bi, off, kLanes);
    if (ov < best || (ov == best && oi < bi)) { best = ov; bi = oi; }
  }
  return bi;
}

// The first strict maximum (straw v1, mapper.c's strict `>`): the higher value first, the lower
// index on a tie.
__device__ __forceinline__ int first_max(unsigned mask, unsigned long long best, int bi) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const unsigned long long ov = __shfl_xor_sync(mask, best, off, kLanes);
    const int oi = __shfl_xor_sync(mask, bi, off, kLanes);
    if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
  }
  return bi;
}

// ---- slot state: slot s in lane s % G, register s / G -------------------------------------------

template <int NS>
__device__ __forceinline__ int pick(const int (&a)[NS], int j) {
  int v = a[0];
#pragma unroll
  for (int k = 1; k < NS; ++k)
    if (j == k) v = a[k];
  return v;
}

template <int NS>
__device__ __forceinline__ int read_slot(const int (&a)[NS], int s, const Lanes& g) {
  return __shfl_sync(g.mask, pick<NS>(a, s / kLanes), s % kLanes, kLanes);
}

template <int NS>
__device__ __forceinline__ void write_slot(int (&a)[NS], int s, int v, const Lanes& g) {
  if (g.lane != s % kLanes) return;
#pragma unroll
  for (int k = 0; k < NS; ++k)
    if (s / kLanes == k) a[k] = v;
}

// Does any of slots [lo, hi) hold v?  One ballot.
template <int NS>
__device__ __forceinline__ bool holds(const int (&a)[NS], int lo, int hi, int v, const Lanes& g) {
  bool hit = false;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int s = k * kLanes + g.lane;
    hit |= s >= lo && s < hi && a[k] == v;
  }
  return __ballot_sync(g.mask, hit) != 0;
}

// ---- the draws ----------------------------------------------------------------------------------

// One lane's share of a straw draw over items k0 + lane, k0 + lane + G, ...: kUnroll independent
// hash chains per step while the bucket has kUnroll * G items left, one at a time after that,
// each lane keeping its first best (`better`: the draw's order, strict as mapper.c's).  The step
// counts depend only on the bucket, so a group's lanes take them together.
template <class V, class Draw, class Better>
__device__ __forceinline__ void lane_best(int size, int lane, Draw draw, Better better, V& best,
                                          int& bi) {
  int k0 = 0;
  for (; k0 + kUnroll * kLanes <= size; k0 += kUnroll * kLanes) {
    V v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) v[j] = draw(k0 + j * kLanes + lane);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (bi == kIntMax || better(v[j], best)) { best = v[j]; bi = k0 + j * kLanes + lane; }
  }
  for (; k0 < size; k0 += kLanes) {
    const int k = k0 + lane;
    if (k < size) {
      const V v = draw(k);
      if (bi == kIntMax || better(v, best)) { best = v; bi = k; }
    }
  }
}

// The bucket's own draw at r (mapper.c bucket_straw_choose / bucket_straw2_choose), shared by the
// group: each lane's first best, then the group's.
__device__ __forceinline__ int bucket_draw(const Map& m, int b, uint32_t x, uint32_t r,
                                           const Lanes& g) {
  const int size = __ldg(m.sizes + b);
  const long long row = (long long)b * m.s;
  if (size == 0) return __ldg(m.items + row);
  int bi = kIntMax;
  if (__ldg(m.algs + b) == kAlgStraw2) {
    long long best = kLongMax;
    lane_best<long long>(
        size, g.lane,
        [&](int k) {
          const uint32_t wk = __ldg(m.weights + row + k);
          const uint32_t u = hash32_3(x, (uint32_t)__ldg(m.items + row + k), r) & 0xFFFFu;
          return wk ? __ldg(m.g + u) / (long long)wk : kZeroDraw;
        },
        [](long long v, long long best) { return v < best; }, best, bi);
    bi = first_min(g.mask, best, bi);
  } else {
    unsigned long long best = 0;
    lane_best<unsigned long long>(
        size, g.lane,
        [&](int k) {
          const uint32_t u = hash32_3(x, (uint32_t)__ldg(m.items + row + k), r) & 0xFFFFu;
          return (unsigned long long)u * __ldg(m.straws + row + k);
        },
        [](unsigned long long v, unsigned long long best) { return v > best; }, best, bi);
    bi = first_max(g.mask, best, bi);
  }
  return __ldg(m.items + row + bi);
}

// bucket_perm_choose: item perm[r % size] of the (bucket, x) Fisher-Yates shuffle, whose steps
// after r % size never touch that position.  The lanes fill the group's scratch, the leader runs
// the dependent swaps, and one shuffle hands perm[pr] to the group.
__device__ __forceinline__ int perm_draw(const Map& m, int b, uint32_t x, uint32_t r,
                                         const Lanes& g) {
  const int size = __ldg(m.sizes + b);
  const int pr = (int)(r % (uint32_t)size);
  uint8_t* perm = g.perm;
  for (int i = g.lane; i < size; i += kLanes) perm[i] = (uint8_t)i;
  __syncwarp(g.mask);
  int slot = 0;
  if (g.lane == 0) {
    for (int p = 0; p <= pr && p < size - 1; ++p) {
      const int i = (int)(hash32_3(x, (uint32_t)(-1 - b), (uint32_t)p) % (uint32_t)(size - p));
      if (i) {
        const uint8_t t = perm[p];
        perm[p] = perm[p + i];
        perm[p + i] = t;
      }
    }
    slot = perm[pr];
  }
  slot = __shfl_sync(g.mask, slot, 0, kLanes);
  return __ldg(m.items + (long long)b * m.s + slot);
}

// Whether a retry at a bucket of `size` items draws from the permutation: once the local count
// has passed size >> 1 and the fallback count (mapper.c:470-476).
__device__ __forceinline__ bool perm_due(const Rule& ru, int size, int flocal) {
  return ru.local_fallback > 0 && flocal >= (size >> 1) && flocal > ru.local_fallback;
}

__device__ __forceinline__ bool is_out(const Map& m, int item, uint32_t x) {
  return is_out_w(item, weight_of(m.weight, m.n_weight, item), m.n_weight, x);
}

// ---- the walk -----------------------------------------------------------------------------------

// The walk's steps between two draws.  crush_choose_firstn and its chooseleaf recursion run as
// one flat machine per group, so that the warp's groups reach the one draw site of the kernel's
// loop together whatever step their x is at: a group's steps diverge from the others' only in
// these few integer operations, never in a draw.
enum : int {
  kXStart,        // load the next x: w = {take}, stage 0
  kStage,         // the stage's program row, its first parent (or the row's end)
  kParent,        // crush_choose_firstn from parent p with the room left, or the stage's end
  kRepStart,      // the next rep of the parent's choose, or its end
  kDescend,       // retry_descent: back to the parent bucket, flocal = 0
  kDescendDraw,   // draw an intervening level (d < depth), else the bottom bucket
  kBottomDraw,    // retry_bucket: draw at the bottom bucket in_b
  kBottomResolve, // commit the rep's item, or fail it
  kBottomFail,    // mapper.c's retry decision after a failure at in_b
  kLeafDraw,      // the chooseleaf recursion's draw at host hb
  kLeafFail,      // its retry decision
};
enum : int { kPhaseDescend, kPhaseBottom, kPhaseLeaf };

// G lanes per x, NS slot registers per lane (result_max <= G * NS).  Each group walks its x,
// then the next x of its grid stride, in the same loop: a group that finishes an x takes up the
// next one without waiting for the other groups of its warp.  The register cap (kMaxRegs, for
// blocks of kThreads) leaves ptxas room to keep every slot and the walk's state in registers.
template <int NS>
__global__ void __maxnreg__(kMaxRegs)
crush_legacy_kernel(const int* __restrict__ xs, long long n, int* __restrict__ out,
                    int* __restrict__ counts, Map m, Rule ru) {
  constexpr int kGroups = kThreads / kLanes;
  __shared__ uint8_t scratch[kGroups * kMaxBucket];
  const int t = threadIdx.x;
  Lanes g;
  g.lane = t & (kLanes - 1);
  g.mask = ((1u << kLanes) - 1u) << ((t & 31) & ~(kLanes - 1));
  g.perm = scratch + (t / kLanes) * kMaxBucket;
  const long long stride = (long long)gridDim.x * kGroups;
  long long i = (long long)blockIdx.x * kGroups + t / kLanes;
  if (i >= n) return;
  const int R = ru.result_max;
  int w[NS], o[NS], c[NS];
  uint32_t x = 0;
  // the rule program's row and the stage's parents
  int s = 0, numrep = 0, depth = 0, recurse = 0, wsize = 0, osize = 0, p = 0;
  bool leafy = false;
  // crush_choose_firstn from bucket b0 into slots [base, base + outpos)
  int b0 = 0, base = 0, count = 0, rep = 0, outpos = 0, ftotal = 0, flocal = 0, in_b = 0, d = 0;
  int item = 0, size = 0;
  bool collide = false, reject = false;
  // the chooseleaf recursion at host hb
  int hb = 0, hsize = 0, lrep = 0, lft = 0, lfl = 0;
  bool lcollide = false;
  // the next draw: bucket db at r, the permutation or the bucket's own draw
  int step = kXStart, phase = kPhaseDescend, db = 0;
  uint32_t r = 0;
  bool perm = false;
  for (;;) {
    for (bool ready = false; !ready;) {
      switch (step) {
        case kXStart:
          x = (uint32_t)xs[i];
#pragma unroll
          for (int k = 0; k < NS; ++k) w[k] = o[k] = c[k] = kNone;
          write_slot<NS>(w, 0, -1 - ru.take_b, g);
          wsize = 1;
          s = 0;
          step = kStage;
          break;
        case kStage:
          if (s == ru.n_stages) {
#pragma unroll
            for (int k = 0; k < NS; ++k) {
              const int slot = k * kLanes + g.lane;
              if (slot < R) out[i * R + slot] = slot < wsize ? w[k] : kNone;
            }
            if (g.lane == 0) counts[i] = wsize;
            i += stride;
            if (i >= n) return;
            step = kXStart;
            break;
          }
          numrep = __ldg(ru.prog + 4 * s);
          depth = __ldg(ru.prog + 4 * s + 1);
          leafy = __ldg(ru.prog + 4 * s + 2) != 0;
          recurse = __ldg(ru.prog + 4 * s + 3);
          osize = 0;
          p = 0;
          step = kParent;
          break;
        case kParent:
          if (p < wsize && osize < R) {
            b0 = -1 - read_slot<NS>(w, p, g);
            base = osize;
            count = R - osize;
            rep = outpos = 0;
            step = kRepStart;
          } else {                                         // the stage's end
#pragma unroll
            for (int k = 0; k < NS; ++k) w[k] = leafy ? c[k] : o[k];
            wsize = osize;
            ++s;
            step = kStage;
          }
          break;
        case kRepStart:
          if (rep < numrep && count > 0) {
            ftotal = 0;
            step = kDescend;
          } else {                                         // the parent's choose ends
            osize += outpos;
            ++p;
            step = kParent;
          }
          break;
        case kDescend:
          in_b = b0;
          flocal = 0;
          d = 1;
          step = kDescendDraw;
          break;
        case kDescendDraw:
          if (d < depth) {
            phase = kPhaseDescend;
            db = in_b;
            r = (uint32_t)(rep + ftotal);
            perm = false;
            ready = true;
          } else {
            step = kBottomDraw;
          }
          break;
        case kBottomDraw:
          size = __ldg(m.sizes + in_b);
          collide = false;
          if (size > 0) {
            phase = kPhaseBottom;
            db = in_b;
            r = (uint32_t)(rep + ftotal);
            perm = perm_due(ru, size, flocal);
            ready = true;
          } else {
            reject = true;
            step = kBottomFail;
          }
          break;
        case kBottomResolve:
          if (!reject && !collide) {
            write_slot<NS>(o, base + outpos, item, g);
            ++outpos;
            --count;
            ++rep;
            step = kRepStart;
          } else {
            step = kBottomFail;
          }
          break;
        case kBottomFail:
          ++ftotal;
          ++flocal;
          if ((collide && flocal <= ru.local_retries) ||                      // retry_bucket
              (ru.local_fallback > 0 && flocal <= size + ru.local_fallback)) {
            step = kBottomDraw;
          } else if (ftotal < ru.tries) {
            step = kDescend;
          } else {                                         // skip_rep
            ++rep;
            step = kRepStart;
          }
          break;
        case kLeafDraw:
          hsize = __ldg(m.sizes + hb);
          lcollide = false;
          if (hsize > 0) {
            phase = kPhaseLeaf;
            db = hb;
            r = (uint32_t)(lrep + lft);
            perm = perm_due(ru, hsize, lfl);
            ready = true;
          } else {
            step = kLeafFail;
          }
          break;
        case kLeafFail:
          ++lft;
          ++lfl;
          if ((lcollide && lfl <= ru.local_retries) ||
              (ru.local_fallback > 0 && lfl <= hsize + ru.local_fallback)) {
            step = kLeafDraw;
          } else if (lft < recurse) {
            lfl = 0;
            step = kLeafDraw;
          } else {                                         // no leaf: the rep's item is rejected
            reject = true;
            step = kBottomResolve;
          }
          break;
      }
    }
    // the one draw site
    const int drawn = perm ? perm_draw(m, db, x, r, g) : bucket_draw(m, db, x, r, g);
    if (phase == kPhaseDescend) {
      in_b = -1 - drawn;
      ++d;
      step = kDescendDraw;
    } else if (phase == kPhaseBottom) {
      item = drawn;
      collide = holds<NS>(o, base, base + outpos, item, g);
      reject = false;
      step = kBottomResolve;
      if (!collide && leafy) {
        if (item < 0) {                                    // the chooseleaf recursion
          hb = -1 - item;
          lrep = ru.stable ? 0 : outpos;
          lft = lfl = 0;
          step = kLeafDraw;
        } else {
          write_slot<NS>(c, base + outpos, item, g);
        }
      }
      if (step == kBottomResolve && !collide && item >= 0) reject = is_out(m, item, x);
    } else {
      lcollide = holds<NS>(c, base, base + outpos, drawn, g);
      if (!lcollide && !is_out(m, drawn, x)) {
        write_slot<NS>(c, base + outpos, drawn, g);
        reject = false;
        step = kBottomResolve;
      } else {
        step = kLeafFail;
      }
    }
  }
}

// One launch of the NS instance: a group per x, the groups striding over x past the grid's reach.
template <int NS>
int launch(const int* xs, long long n, int* out, int* counts, const Map& m, const Rule& ru,
           cudaStream_t stream) {
  constexpr long long kGroups = kThreads / kLanes;
  long long blocks = (n + kGroups - 1) / kGroups;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  crush_legacy_kernel<NS><<<(unsigned)blocks, kThreads, 0, stream>>>(xs, n, out, counts, m, ru);
  return (int)cudaGetLastError();
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
  return result_max <= kLanes ? launch<1>(xs, n, out, counts, m, ru, stream)
                              : launch<kMaxRep / kLanes>(xs, n, out, counts, m, ru, stream);
}
