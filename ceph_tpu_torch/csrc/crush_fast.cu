// The candidate-table CRUSH mapper on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the jitted XLA functions of ceph_tpu/ops/crush_fast.py (K7):
//
// - K7a crush_descend: FastRule._candidates (:592) through _descend (:489), _straw2_int (:431)
//   and _straw2_exact64 (:445).  One thread per flattened lane (x, start bucket, r, position)
//   walks `depth` levels down the map; each level is one straw2 draw over the bucket's items
//   (mapper.c:322-367): u = hash32_3(x, id, r) & 0xFFFF, then on a level whose buckets all have
//   one uniform weight w >= 0x10000 the i32 quotient T_w[u] = floor(G[u] / w) - 2^31 from a
//   64K table, elsewhere the exact s64 quotient G[u] / w, G[u] = 2^48 - crush_ln(u) (a zero
//   weight draws 2^62).  The first strict minimum wins, as the reference's strict-greater update
//   does, so a bucket whose weights are all zero still returns item 0.  The main descent, the
//   mid-stage descents of chained rules and the leaf attempts are all launches of this kernel
//   on differently flattened lanes (the broadcasts stay in torch, ops/crush_fast.py).
// - K7b crush_resolve: FastRule._resolve (:714), _resolve_firstn (:752), _resolve_indep (:826)
//   and _resolve_packed (:882).  One thread per x replays the firstn/indep retry semantics
//   (mapper.c:443-636, :638-790) over the cached candidates of its parents x numrep slots:
//   collisions, the is_out rejection against the epoch's weight vector, the leaf attempts,
//   the residual flags where the round caps stop short of the rule's tries; then the EMIT
//   compaction (firstn drops NONE gaps in slot order; indep keeps holes but drops absent
//   parents' blocks) and the tail column count | residual << 16.  Under mode 1 the same
//   machine, without leaves or is_out, is the collision pass of a chained rule's middle step
//   (_mid_candidates, :548-589): one thread per lane writes its `slots` picks and a risk flag.
//
// Candidates are laid out (R, P, N) and leaf attempts (R, L, P, N) with the lane N on the fast
// axis, so a warp's loads of one (r, position) are 32 neighbouring words.
//
// Bound on this card.  K7a: integer instructions.  A draw is one hash32_3 (5 Jenkins mixes of
// 9 lines, each at least a 3-input add, a shift and an XOR), the mask, the table gather, the
// compare and the select, ~141 instructions; the tables it gathers from (64K x 4 B per
// weight, 512 KiB for G) stay in L2.  At 100000 x, firstn size 3 on 50 hosts of 20 OSDs,
// that is 700,000 lanes x 70 draws, 6.9e9 instructions, ~0.21 ms at the card's instruction
// rate (132 SMs x 4 schedulers x 32 lanes x 1.98 GHz; adds may run on the FMA pipe, so the
// integer pipe's 64 lanes are no bound).  The exact s64 divide of a non-uniform level is a
// software routine of a few dozen instructions on top.  K7b: bytes, the candidates and leaf
// attempts read once and the packed rows written once: ~8 MB for firstn size 3 (2.4 us at
// 3.35 TB/s), ~150 MB for the EC rule, 12 slots x 5 rounds x 5 leaf attempts (45 us).  Its
// loads depend on each other slot by slot, and a thread skips the rounds a slot no longer
// needs, so it is latency-bound, not bandwidth-bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRep = 32;                   // most slots of one choose step (numrep)
constexpr int kNone = 0x7FFFFFFF;             // CRUSH_ITEM_NONE
constexpr int kUndef = 0x7FFFFFFE;            // CRUSH_ITEM_UNDEF
constexpr uint32_t kSeed = 1315423911u;
constexpr long long kZeroDraw = 1LL << 62;    // the draw of a zero weight (sorts last)

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

// ---- K7a ---------------------------------------------------------------------------------------

struct MapTables {
  const int* items;       // (nb, S) item ids, NONE past a bucket's size
  const int* hash_ids;    // (nb, S) ids hashed in the draw
  const int* sizes;       // (nb,)
  const uint32_t* weights;  // (npos, nb, S) straw2 weights
  const int* qidx;        // (nb,) quotient table of a bucket on an integer level
  const int* qtables;     // (n_tables, 65536) i32 quotients, biased by -2^31
  const long long* g;     // (65536,) G[u] = 2^48 - crush_ln(u)
  int nb, s, npos;
};

__global__ void __launch_bounds__(kThreads)
crush_descend_kernel(const int* __restrict__ xs, const int* __restrict__ start,
                     const int* __restrict__ rs, const int* __restrict__ pos,
                     int* __restrict__ out, long long n, MapTables t, unsigned int_mask, int depth) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = (uint32_t)xs[i];
  const uint32_t r = (uint32_t)rs[i];
  const int p = min(pos[i], t.npos - 1);
  int b = start[i];
  int item = 0;
  for (int d = 0; d < depth; ++d) {
    const int size = __ldg(t.sizes + b);
    const long long row = (long long)b * t.s;
    int win = 0;
    if ((int_mask >> d) & 1u) {
      const int* q = t.qtables + ((long long)__ldg(t.qidx + b) << 16);
      int best = 0;
      for (int k = 0; k < size; ++k) {
        const uint32_t u = hash32_3(x, (uint32_t)__ldg(t.hash_ids + row + k), r) & 0xFFFFu;
        const int v = __ldg(q + u);
        if (k == 0 || v < best) { best = v; win = k; }
      }
    } else {
      const uint32_t* w = t.weights + ((long long)p * t.nb) * t.s + row;
      long long best = 0;
      for (int k = 0; k < size; ++k) {
        const uint32_t wk = __ldg(w + k);
        long long v = kZeroDraw;
        if (wk) {
          const uint32_t u = hash32_3(x, (uint32_t)__ldg(t.hash_ids + row + k), r) & 0xFFFFu;
          v = __ldg(t.g + u) / (long long)wk;
        }
        if (k == 0 || v < best) { best = v; win = k; }
      }
    }
    item = __ldg(t.items + row + win);
    b = max(-1 - item, 0);
  }
  out[i] = item;
}

// ---- K7b ---------------------------------------------------------------------------------------

struct Resolve {
  const int* cand;        // (R, P, N)
  const int* leaf;        // (R, L, P, N), read only when leafy
  const uint32_t* weight; // (n_weight,) the epoch's 16.16 device weights
  long long n;            // lanes N
  int p, l, numrep, n_rounds, n_leaf, tries, recurse_tries, n_weight;
  int firstn, leafy, check_out, gate;
};

// mapper.c is_out: a device past the weight vector is out; w >= 1.0 keeps it, 0 rejects it,
// otherwise the hash of (x, item) decides.
__device__ __forceinline__ bool is_out(const Resolve& a, int item, uint32_t x) {
  if (item >= a.n_weight) return true;
  const uint32_t w = __ldg(a.weight + max(item, 0));
  if (w >= 0x10000u) return false;
  if (w == 0) return true;
  return (hash32_2(x, (uint32_t)item) & 0xFFFFu) >= w;
}

// firstn (_resolve_firstn): slot j tries r = j + ft; with leaves, the first acceptable leaf
// attempt; with positions, the lane's dynamic outpos (its success count so far).  `gate`
// stops further takes once the lane is flagged (the last step); the middle steps run without.
__device__ bool resolve_firstn(const Resolve& a, long long lane, uint32_t x, bool residual,
                               int* sel) {
  int outs[kMaxRep], leaves[kMaxRep];
  for (int j = 0; j < a.numrep; ++j) outs[j] = leaves[j] = kNone;
  for (int j = 0; j < a.numrep; ++j) {
    int pos = 0;
    if (a.p > 1) {
      int c = 0;
      for (int k = 0; k < a.numrep; ++k) c += outs[k] != kNone;
      pos = min(c, a.p - 1);
    }
    bool done = false;
    for (int ft = 0; ft < a.n_rounds && !done; ++ft) {   // a done slot changes nothing more
      const int r = j + ft;
      const int item = __ldg(a.cand + ((long long)r * a.p + pos) * a.n + lane);
      bool coll = false;
      for (int k = 0; k < a.numrep; ++k) coll |= outs[k] == item;
      bool ok, maybe_more = false;
      int lsel = item;
      if (a.leafy) {
        bool lok = false;
        lsel = kNone;
        for (int f2 = 0; f2 < a.n_leaf; ++f2) {
          const int lf = __ldg(a.leaf + (((long long)r * a.l + f2) * a.p + pos) * a.n + lane);
          bool lcoll = false;
          for (int k = 0; k < a.numrep; ++k) lcoll |= leaves[k] == lf;
          if (!lok && !lcoll && !is_out(a, lf, x)) { lsel = lf; lok = true; }
        }
        maybe_more = a.n_leaf < a.recurse_tries && !lok;
        ok = !coll && lok;
      } else {
        ok = !coll && !(a.check_out && is_out(a, item, x));
      }
      if (ok && !done && !(a.gate && residual)) { outs[j] = item; leaves[j] = lsel; }
      if (maybe_more && !done) residual = true;
      done |= ok;
    }
    if (a.n_rounds < a.tries && !done) residual = true;
  }
  for (int j = 0; j < a.numrep; ++j) sel[j] = a.leafy ? leaves[j] : outs[j];
  return residual;
}

// indep (_resolve_indep): rounds over the slots still UNDEF, r = rep + numrep * ft; slots at or
// past `room` are never filled (the reference's out_size when the result is narrower).
__device__ bool resolve_indep(const Resolve& a, long long lane, uint32_t x, bool residual,
                              int room, int* sel) {
  int outs[kMaxRep], leaves[kMaxRep];
  for (int j = 0; j < a.numrep; ++j) outs[j] = leaves[j] = kUndef;
  for (int ft = 0; ft < a.n_rounds; ++ft) {
    for (int rep = 0; rep < a.numrep; ++rep) {
      if (outs[rep] != kUndef || rep >= room) continue;   // only an unfilled slot can change
      const int r = rep + a.numrep * ft;
      const int item = __ldg(a.cand + (long long)r * a.n + lane);
      bool coll = false;
      for (int k = 0; k < a.numrep; ++k) coll |= outs[k] == item;
      bool ok;
      int lsel = item;
      if (a.leafy) {
        bool lok = false;
        lsel = kNone;
        for (int f2 = 0; f2 < a.n_leaf; ++f2) {
          const int lf = __ldg(a.leaf + ((long long)r * a.l + f2) * a.n + lane);
          if (!lok && !is_out(a, lf, x)) { lsel = lf; lok = true; }
        }
        if (a.n_leaf < a.recurse_tries && !coll && !lok) residual = true;
        ok = !coll && lok;
      } else {
        ok = !coll && !(a.check_out && is_out(a, item, x));
      }
      if (ok) { outs[rep] = item; leaves[rep] = lsel; }
    }
  }
  bool unfinished = false;
  for (int rep = 0; rep < a.numrep; ++rep) unfinished |= outs[rep] == kUndef && rep < room;
  if (a.n_rounds < a.tries && unfinished) residual = true;
  for (int j = 0; j < a.numrep; ++j) {
    const int v = a.leafy ? leaves[j] : outs[j];
    sel[j] = v == kUndef ? kNone : v;
  }
  return residual;
}

// mode 0: one thread per x over its `parents` lanes, out (n_x, width + 1) packed rows
// (width = result_max).  mode 1: one thread per lane, out (n_x, width) picks (width = the
// middle step's slots) and risky (n_x,).
__global__ void __launch_bounds__(kThreads)
crush_resolve_kernel(Resolve a, const int* __restrict__ lane_x,
                     const uint8_t* __restrict__ valid, const uint8_t* __restrict__ risk0,
                     int* __restrict__ out, uint8_t* __restrict__ risky, long long n_x,
                     int parents, int width, int mode) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_x) return;
  int sel[kMaxRep];
  if (mode == 1) {
    const uint32_t x = (uint32_t)lane_x[t];
    const bool rk = a.firstn ? resolve_firstn(a, t, x, false, sel)
                             : resolve_indep(a, t, x, false, width, sel);
    const bool v = valid[t] != 0;
    int* row = out + t * width;
    int c = 0;
    for (int j = 0; j < (a.firstn ? a.numrep : width); ++j)
      if ((!a.firstn || sel[j] != kNone) && c < width) row[c++] = v ? sel[j] : kNone;
    for (; c < width; ++c) row[c] = kNone;
    risky[t] = rk;
    return;
  }
  int* row = out + t * (width + 1);
  int c = 0, total = 0, n_valid = 0;
  bool residual = false;
  for (int q = 0; q < parents; ++q) {
    const long long lane = t * parents + q;
    const uint32_t x = (uint32_t)lane_x[lane];
    const bool v = valid[lane] != 0;
    const bool r0 = risk0[lane] != 0;
    bool lres;
    if (a.firstn) {
      lres = resolve_firstn(a, lane, x, r0, sel);
    } else {
      const int room = min(max(width - n_valid * a.numrep, 0), a.numrep);
      lres = resolve_indep(a, lane, x, r0, room, sel);
    }
    residual |= r0 || (v && lres);
    if (!v) continue;
    ++n_valid;
    for (int j = 0; j < a.numrep; ++j) {
      if (a.firstn && sel[j] == kNone) continue;
      ++total;
      if (c < width) row[c++] = sel[j];
    }
  }
  for (int k = c; k < width; ++k) row[k] = kNone;
  const int count = min(a.firstn ? total : n_valid * a.numrep, width);
  row[width] = count | ((int)residual << 16);
}

inline unsigned blocks(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int crush_descend_launch(const void* xs, const void* start, const void* rs,
                                    const void* pos, void* out, long long n, const void* items,
                                    const void* hash_ids, const void* sizes, const void* weights,
                                    const void* qidx, const void* qtables, const void* g, int nb,
                                    int s, int npos, int int_mask, int depth, void* stream) {
  if (n <= 0) return 0;
  MapTables t{(const int*)items, (const int*)hash_ids, (const int*)sizes,
              (const uint32_t*)weights, (const int*)qidx, (const int*)qtables,
              (const long long*)g, nb, s, npos};
  crush_descend_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)xs, (const int*)start, (const int*)rs, (const int*)pos, (int*)out, n, t,
      (unsigned)int_mask, depth);
  return (int)cudaGetLastError();
}

extern "C" int crush_resolve_launch(const void* cand, const void* leaf, const void* lane_x,
                                    const void* valid, const void* risk0, const void* weight,
                                    void* out, void* risky, long long n_x, long long n_lanes,
                                    int parents, int p, int l, int numrep, int n_rounds,
                                    int n_leaf, int tries, int recurse_tries, int n_weight,
                                    int firstn, int leafy, int check_out, int gate, int width,
                                    int mode, void* stream) {
  if (numrep > kMaxRep || numrep < 1) return (int)cudaErrorInvalidValue;
  if (n_x <= 0) return 0;
  Resolve a{(const int*)cand, (const int*)leaf, (const uint32_t*)weight, n_lanes, p, l, numrep,
            n_rounds, n_leaf, tries, recurse_tries, n_weight, firstn, leafy, check_out, gate};
  crush_resolve_kernel<<<blocks(n_x), kThreads, 0, (cudaStream_t)stream>>>(
      a, (const int*)lane_x, (const uint8_t*)valid, (const uint8_t*)risk0, (int*)out,
      (uint8_t*)risky, n_x, parents, width, mode);
  return (int)cudaGetLastError();
}
