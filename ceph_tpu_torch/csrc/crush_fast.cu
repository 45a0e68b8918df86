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
//   Each thread first issues the loads that do not depend on its decisions, then decides:
//   indep loads the candidate and the first leaf attempts of every slot still open in a round
//   before it tests any of them, firstn the round-0 row of every slot.  The slot state lives in
//   registers for the main path's numrep 3 and 12 (template instances); any other numrep <= 32
//   takes the generic instance.
// - K6 crush_rule: ceph_tpu/ops/crush_kernels.py's DeviceCrushMapper (:445) through _descend
//   (:242), _is_out (:280), _choose_firstn (:290-362) and _choose_indep (:364-435).  One thread
//   per x runs the rule program (ops/crush_kernels.py: TAKE, the choose steps with the tries,
//   recurse tries, vary_r and stable in force, EMIT) with the rule's full choose_tries and
//   recurse_tries, exactly as crush_do_rule (mapper.c:883-1087) does, firstn's count and
//   indep's out_size bounded by what is left of result_max.  Each draw is K7a's: the quotient
//   table of a bucket whose items all weigh one w >= 0x10000, else the s64 G[u] / w.  It runs on
//   a list of x, or on the first *n_live entries of an index list into the candidate set's x,
//   writing the exact rows into K7b's packed table (FastRule: the x K7b flags).
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
// reads depend on the slots decided before them, and a thread skips the rounds a slot no
// longer needs, so it is latency-bound, not bandwidth-bound.  K6: instructions, ~141 per
// straw2 item drawn (K7a's draw) times the items the rule's walk draws for this run's x (the
// plain version counts them); a warp runs as long as its slowest x.
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

// ---- the straw2 draw (K7a, K6) --------------------------------------------------------------

struct MapTables {
  const int* items;       // (nb, S) item ids, NONE past a bucket's size
  const int* hash_ids;    // (nb, S) ids hashed in the draw
  const int* sizes;       // (nb,)
  const uint32_t* weights;  // (npos, nb, S) straw2 weights
  const int* qidx;        // (nb,) quotient table of a bucket (K7a: on an integer level; K6: -1 none)
  const int* qtables;     // (n_tables, 65536) i32 quotients, biased by -2^31
  const long long* g;     // (65536,) G[u] = 2^48 - crush_ln(u)
  int nb, s, npos;
};

// One straw2 draw from bucket b at position p: the item at the first strict minimum of the
// bucket's quotients, from quotient table `table` (>= 0) or the exact s64 G[u] / w.  U items'
// hashes are interleaved (K6's lone threads have no other warps to hide their latency).
template <int U>
__device__ __forceinline__ int straw2_win(const MapTables& t, int b, uint32_t x, uint32_t r,
                                          int p, int table) {
  const int size = __ldg(t.sizes + b);
  const long long row = (long long)b * t.s;
  int win = 0;
  if (table >= 0) {
    const int* q = t.qtables + ((long long)table << 16);
    int best = 0;
#pragma unroll (U)
    for (int k = 0; k < size; ++k) {
      const uint32_t u = hash32_3(x, (uint32_t)__ldg(t.hash_ids + row + k), r) & 0xFFFFu;
      const int v = __ldg(q + u);
      if (k == 0 || v < best) { best = v; win = k; }
    }
  } else {
    const uint32_t* w = t.weights + ((long long)p * t.nb) * t.s + row;
    long long best = 0;
#pragma unroll (U)
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
  return __ldg(t.items + row + win);
}

// ---- K7a ---------------------------------------------------------------------------------------

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
    item = straw2_win<1>(t, b, x, r, p, ((int_mask >> d) & 1u) ? __ldg(t.qidx + b) : -1);
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

// mapper.c is_out with the item's weight already loaded (`w`, any value past the vector): a
// device past the weight vector is out; w >= 1.0 keeps it, 0 rejects it, otherwise the hash of
// (x, item) decides.
__device__ __forceinline__ bool is_out_w(int item, uint32_t w, int n_weight, uint32_t x) {
  if (item >= n_weight) return true;
  if (w >= 0x10000u) return false;
  if (w == 0) return true;
  return (hash32_2(x, (uint32_t)item) & 0xFFFFu) >= w;
}

__device__ __forceinline__ uint32_t weight_of(const uint32_t* weight, int n_weight, int item) {
  return item < n_weight ? __ldg(weight + max(item, 0)) : 0u;
}

__device__ __forceinline__ bool is_out(const Resolve& a, int item, uint32_t x) {
  return is_out_w(item, weight_of(a.weight, a.n_weight, item), a.n_weight, x);
}

// Leaf attempts f2 < LP of (r, pos) go in registers; the rest are loaded where they are tested.
template <int LP>
__device__ __forceinline__ void load_leaves(const Resolve& a, int r, int pos, long long lane,
                                            bool want, int (&lf)[LP]) {
#pragma unroll
  for (int f2 = 0; f2 < LP; ++f2)
    lf[f2] = (want && f2 < a.n_leaf)
                 ? __ldg(a.leaf + (((long long)r * a.l + f2) * a.p + pos) * a.n + lane) : kNone;
}

// The first acceptable leaf attempt of (r, pos) (firstn also rejects a leaf already taken):
// its weights are loaded together before any test.
template <int NR, int LP>
__device__ __forceinline__ bool pick_leaf(const Resolve& a, int r, int pos, long long lane,
                                          uint32_t x, const int (&lf)[LP], bool firstn,
                                          const int (&leaves)[NR], int nrep, int& lsel) {
  uint32_t w[LP];
#pragma unroll
  for (int f2 = 0; f2 < LP; ++f2)
    w[f2] = f2 < a.n_leaf ? weight_of(a.weight, a.n_weight, lf[f2]) : 0u;
  bool lok = false;
  lsel = kNone;
#pragma unroll
  for (int f2 = 0; f2 < LP; ++f2) {
    if (f2 >= a.n_leaf || lok) continue;
    bool lcoll = false;
    if (firstn) {
#pragma unroll (NR < kMaxRep ? NR : 1)
      for (int k = 0; k < NR; ++k) lcoll |= k < nrep && leaves[k] == lf[f2];
    }
    if (!lcoll && !is_out_w(lf[f2], w[f2], a.n_weight, x)) { lsel = lf[f2]; lok = true; }
  }
  for (int f2 = LP; f2 < a.n_leaf && !lok; ++f2) {
    const int v = __ldg(a.leaf + (((long long)r * a.l + f2) * a.p + pos) * a.n + lane);
    bool lcoll = false;
    if (firstn) {
#pragma unroll (NR < kMaxRep ? NR : 1)
      for (int k = 0; k < NR; ++k) lcoll |= k < nrep && leaves[k] == v;
    }
    if (!lcoll && !is_out(a, v, x)) { lsel = v; lok = true; }
  }
  return lok;
}

// firstn (_resolve_firstn): slot j tries r = j + ft; with leaves, the first acceptable leaf
// attempt; with positions, the lane's dynamic outpos (its success count so far).  `gate`
// stops further takes once the lane is flagged (the last step); the middle steps run without.
// NR < kMaxRep fixes numrep = NR (every slot index a constant, the slots in registers); the
// generic instance takes a.numrep.
template <int NR, int LP>
__device__ bool resolve_firstn(const Resolve& a, long long lane, uint32_t x, bool residual,
                               int (&sel)[NR]) {
  constexpr bool kFixed = NR < kMaxRep;
  const int nrep = kFixed ? NR : a.numrep;
  int outs[NR], leaves[NR];
  // round 0 of slot j reads row j at position 0 (one position) whatever came before
  int c0[NR], l0[NR][LP];
#pragma unroll (NR < kMaxRep ? NR : 1)
  for (int j = 0; j < NR; ++j) {
    outs[j] = leaves[j] = kNone;
    const bool want = j < nrep && a.p == 1;
    c0[j] = want ? __ldg(a.cand + (long long)j * a.n + lane) : kNone;
    load_leaves<LP>(a, j, 0, lane, want && a.leafy, l0[j]);
  }
#pragma unroll (NR < kMaxRep ? NR : 1)
  for (int j = 0; j < (kFixed ? NR : a.numrep); ++j) {
    int pos = 0;
    if (a.p > 1) {
      int c = 0;
#pragma unroll (NR < kMaxRep ? NR : 1)
      for (int k = 0; k < NR; ++k) c += k < nrep && outs[k] != kNone;
      pos = min(c, a.p - 1);
    }
    bool done = false;
    for (int ft = 0; ft < a.n_rounds && !done; ++ft) {   // a done slot changes nothing more
      const int r = j + ft;
      int item, lf[LP];
      if (ft == 0 && a.p == 1) {
        item = c0[j];
#pragma unroll
        for (int f2 = 0; f2 < LP; ++f2) lf[f2] = l0[j][f2];
      } else {
        item = __ldg(a.cand + ((long long)r * a.p + pos) * a.n + lane);
        load_leaves<LP>(a, r, pos, lane, a.leafy, lf);
      }
      bool coll = false;
#pragma unroll (NR < kMaxRep ? NR : 1)
      for (int k = 0; k < NR; ++k) coll |= k < nrep && outs[k] == item;
      bool ok, maybe_more = false;
      int lsel = item;
      if (a.leafy) {
        const bool lok = pick_leaf<NR, LP>(a, r, pos, lane, x, lf, true, leaves, nrep, lsel);
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
#pragma unroll (NR < kMaxRep ? NR : 1)
  for (int j = 0; j < NR; ++j) sel[j] = a.leafy ? leaves[j] : outs[j];
  return residual;
}

// indep (_resolve_indep): rounds over the slots still UNDEF, r = rep + numrep * ft; slots at or
// past `room` are never filled (the reference's out_size when the result is narrower).  A
// round first loads the candidate and leaf attempts of every open slot, then tests them.
template <int NR, int LP>
__device__ bool resolve_indep(const Resolve& a, long long lane, uint32_t x, bool residual,
                              int room, int (&sel)[NR]) {
  constexpr bool kFixed = NR < kMaxRep;
  const int nrep = kFixed ? NR : a.numrep;
  int outs[NR], leaves[NR];
#pragma unroll (NR < kMaxRep ? NR : 1)
  for (int j = 0; j < NR; ++j) outs[j] = leaves[j] = kUndef;
  for (int ft = 0; ft < a.n_rounds; ++ft) {
    int ci[NR], li[NR][LP];
    bool open[NR];
#pragma unroll (NR < kMaxRep ? NR : 1)
    for (int rep = 0; rep < NR; ++rep) {
      open[rep] = rep < nrep && rep < room && outs[rep] == kUndef;
      const int r = rep + nrep * ft;
      ci[rep] = open[rep] ? __ldg(a.cand + (long long)r * a.n + lane) : kNone;
      load_leaves<LP>(a, r, 0, lane, open[rep] && a.leafy, li[rep]);
    }
#pragma unroll (NR < kMaxRep ? NR : 1)
    for (int rep = 0; rep < NR; ++rep) {
      if (!open[rep]) continue;   // only an unfilled slot can change
      const int r = rep + nrep * ft;
      const int item = ci[rep];
      bool coll = false;
#pragma unroll (NR < kMaxRep ? NR : 1)
      for (int k = 0; k < NR; ++k) coll |= k < nrep && outs[k] == item;
      bool ok;
      int lsel = item;
      if (a.leafy) {
        const bool lok = pick_leaf<NR, LP>(a, r, 0, lane, x, li[rep], false, leaves, nrep,
                                           lsel);
        if (a.n_leaf < a.recurse_tries && !coll && !lok) residual = true;
        ok = !coll && lok;
      } else {
        ok = !coll && !(a.check_out && is_out(a, item, x));
      }
      if (ok) { outs[rep] = item; leaves[rep] = lsel; }
    }
  }
  bool unfinished = false;
#pragma unroll (NR < kMaxRep ? NR : 1)
  for (int rep = 0; rep < NR; ++rep) unfinished |= rep < nrep && rep < room && outs[rep] == kUndef;
  if (a.n_rounds < a.tries && unfinished) residual = true;
#pragma unroll (NR < kMaxRep ? NR : 1)
  for (int j = 0; j < NR; ++j) {
    const int v = a.leafy ? leaves[j] : outs[j];
    sel[j] = v == kUndef ? kNone : v;
  }
  return residual;
}

// mode 0: one thread per x over its `parents` lanes, out (n_x, width + 1) packed rows
// (width = result_max).  mode 1: one thread per lane, out (n_x, width) picks (width = the
// middle step's slots) and risky (n_x,).
template <int NR, int LP>
__global__ void __launch_bounds__(kThreads)
crush_resolve_kernel(Resolve a, const int* __restrict__ lane_x,
                     const uint8_t* __restrict__ valid, const uint8_t* __restrict__ risk0,
                     int* __restrict__ out, uint8_t* __restrict__ risky, long long n_x,
                     int parents, int width, int mode) {
  constexpr bool kFixed = NR < kMaxRep;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_x) return;
  int sel[NR];
  if (mode == 1) {
    const uint32_t x = (uint32_t)lane_x[t];
    const bool rk = a.firstn ? resolve_firstn<NR, LP>(a, t, x, false, sel)
                             : resolve_indep<NR, LP>(a, t, x, false, width, sel);
    const bool v = valid[t] != 0;
    int* row = out + t * width;
    int c = 0;
#pragma unroll (NR < kMaxRep ? NR : 1)
    for (int j = 0; j < NR; ++j)
      if (j < (a.firstn ? a.numrep : width) && (!a.firstn || sel[j] != kNone) && c < width)
        row[c++] = v ? sel[j] : kNone;
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
      lres = resolve_firstn<NR, LP>(a, lane, x, r0, sel);
    } else {
      const int room = min(max(width - n_valid * a.numrep, 0), a.numrep);
      lres = resolve_indep<NR, LP>(a, lane, x, r0, room, sel);
    }
    residual |= r0 || (v && lres);
    if (!v) continue;
    ++n_valid;
#pragma unroll (NR < kMaxRep ? NR : 1)
    for (int j = 0; j < NR; ++j) {
      if (!kFixed && j >= a.numrep) break;
      if (a.firstn && sel[j] == kNone) continue;
      ++total;
      if (c < width) row[c++] = sel[j];
    }
  }
  for (int k = c; k < width; ++k) row[k] = kNone;
  const int count = min(a.firstn ? total : n_valid * a.numrep, width);
  row[width] = count | ((int)residual << 16);
}

// ---- K6 ----------------------------------------------------------------------------------------

constexpr int kProgCols = 8;      // op, arg, type, numrep, tries, recurse, vary_r, stable
constexpr int kOpTake = 1, kOpChooseFirstn = 2, kOpChooseIndep = 3, kOpEmit = 4;
constexpr int kOpChooseleafFirstn = 6, kOpChooseleafIndep = 7;
constexpr int kMaxDescent = 12;   // > CRUSH_MAX_DEPTH, as ops/crush_kernels.py's MAX_DESCENT
constexpr int kRuleUnroll = 4;    // items per straw2 loop iteration in K6
enum { kOk = 0, kDead = 1, kEmpty = 2 };

struct Rule {
  MapTables t;
  const int* types;       // (nb,) bucket type, -1 where the map has no bucket
  const uint32_t* weight; // (n_weight,) the epoch's device weights
  int n_weight;
};

// Slot state of width NR < kMaxRep in registers: every index below is a constant after
// unrolling.  The generic instance (kMaxRep) indexes its arrays in local memory.
template <int NR>
__device__ __forceinline__ int get(const int (&v)[NR], int i) {
  if constexpr (NR == kMaxRep) {
    return v[i];
  } else {
    int r = v[0];
#pragma unroll
    for (int k = 1; k < NR; ++k)
      if (k == i) r = v[k];
    return r;
  }
}

template <int NR>
__device__ __forceinline__ void put(int (&v)[NR], int i, int val) {
  if constexpr (NR == kMaxRep) {
    v[i] = val;
  } else {
#pragma unroll
    for (int k = 0; k < NR; ++k)
      if (k == i) v[k] = val;
  }
}

template <int NR>
__device__ __forceinline__ bool holds(const int (&v)[NR], int lo, int hi, int val) {
  bool c = false;
  if constexpr (NR == kMaxRep) {
    for (int k = lo; k < hi; ++k) c |= v[k] == val;
  } else {
#pragma unroll
    for (int k = 0; k < NR; ++k) c |= k >= lo && k < hi && v[k] == val;
  }
  return c;
}

__device__ __forceinline__ int type_of(const Rule& k, int item) {
  return item >= 0 ? 0 : __ldg(k.types + (-1 - item));
}

// _descend: from bucket index b draw with r fixed until an item of `type` (do-while: the start
// bucket is always drawn from).  kEmpty at an empty bucket, kDead at a device of another type.
__device__ __forceinline__ int descend(const Rule& k, int b, uint32_t x, uint32_t r, int pos,
                                       int type, int& status) {
  const int p = min(pos, k.t.npos - 1);
  for (int depth = 0; depth < kMaxDescent; ++depth) {
    if (__ldg(k.t.sizes + b) == 0) { status = kEmpty; return 0; }
    const int item = straw2_win<kRuleUnroll>(k.t, b, x, r, p, __ldg(k.t.qidx + b));
    if (type_of(k, item) == type) { status = kOk; return item; }
    if (item >= 0) { status = kDead; return item; }
    b = -1 - item;
  }
  status = kDead;
  return 0;
}

// The chooseleaf recursion of firstn (mapper.c:541-558): numrep 1 from rep 0 when stable, else
// from outpos, r' = rep + (r >> (vary_r - 1)) + ft for ft < recurse; a leaf must not repeat
// c[base, base + outpos).
template <int NR>
__device__ bool firstn_leaf(const Rule& k, int b, uint32_t x, uint32_t r, int base, int outpos,
                            int recurse, int vary_r, int stable, const int (&c)[NR], int& leaf) {
  const uint32_t sub_r = vary_r ? (vary_r - 1 < 32 ? r >> (vary_r - 1) : 0u) : 0u;
  const uint32_t rep = stable ? 0u : (uint32_t)outpos;
  for (int ft = 0;;) {
    int st;
    const int lf = descend(k, b, x, rep + sub_r + ft, outpos, 0, st);
    if (st == kDead) return false;
    if (st == kOk && !holds<NR>(c, base, base + outpos, lf) &&
        !is_out_w(lf, weight_of(k.weight, k.n_weight, lf), k.n_weight, x)) {
      leaf = lf;
      return true;
    }
    if (++ft >= recurse) return false;
  }
}

// crush_choose_firstn with bobtail+ tunables (mapper.c:443-636), writing o/c from `base`:
// every reject or collision restarts the descent with ftotal + 1.  Returns the picks made.
template <int NR>
__device__ int choose_firstn(const Rule& k, const int* st, int b0, uint32_t x, int base,
                             int count, int (&o)[NR], int (&c)[NR]) {
  const int op = st[0], type = st[2], numrep = st[3], tries = st[4], recurse = st[5];
  const bool leafy = op == kOpChooseleafFirstn;
  int outpos = 0;
  for (int rep = 0; rep < numrep && count > 0; ++rep) {
    for (int ftotal = 0;;) {
      const uint32_t r = (uint32_t)(rep + ftotal);
      int status;
      const int item = descend(k, b0, x, r, outpos, type, status);
      if (status == kDead) break;                   // skip_rep
      bool reject = status == kEmpty, collide = false;
      if (!reject) {
        collide = holds<NR>(o, base, base + outpos, item);
        if (!collide && leafy) {
          if (item < 0) {
            int leaf;
            if (firstn_leaf<NR>(k, -1 - item, x, r, base, outpos, recurse, st[6], st[7], c, leaf))
              put<NR>(c, base + outpos, leaf);
            else
              reject = true;
          } else {
            put<NR>(c, base + outpos, item);
          }
        }
        if (!reject && !collide && type_of(k, item) == 0)
          reject = is_out_w(item, weight_of(k.weight, k.n_weight, item), k.n_weight, x);
      }
      if (!reject && !collide) {
        put<NR>(o, base + outpos, item);
        ++outpos;
        --count;
        break;
      }
      if (++ftotal >= tries) break;
    }
  }
  return outpos;
}

// The chooseleaf recursion of indep (mapper.c:725-741): the slot at outpos rep, r' = rep + r +
// numrep * ft for ft < recurse; NONE when it fails.
__device__ int indep_leaf(const Rule& k, int b, uint32_t x, int rep, uint32_t r, int numrep,
                          int recurse) {
  for (int ft = 0; ft < recurse; ++ft) {
    int st;
    const int lf = descend(k, b, x, (uint32_t)rep + r + (uint32_t)(numrep * ft), rep, 0, st);
    if (st == kDead) return kNone;
    if (st == kOk && !is_out_w(lf, weight_of(k.weight, k.n_weight, lf), k.n_weight, x)) return lf;
  }
  return kNone;
}

// crush_choose_indep (mapper.c:638-790) on o/c[base, base + out_size): rounds retry the UNDEF
// slots with r' = rep + numrep * ftotal until tries run out (straw2 only, so never the uniform
// bucket's (numrep + 1) * ftotal); dead ends become NONE.  A device picked directly is written
// to c before its is_out test, as mapper.c:736-742 does.
template <int NR>
__device__ void choose_indep(const Rule& k, const int* st, int b0, uint32_t x, int base,
                             int out_size, int (&o)[NR], int (&c)[NR]) {
  const int op = st[0], type = st[2], numrep = st[3], tries = st[4], recurse = st[5];
  const bool leafy = op == kOpChooseleafIndep;
  const int end = base + out_size;
#pragma unroll (NR < kMaxRep ? NR : 1)
  for (int i = 0; i < NR; ++i)
    if (i >= base && i < end) o[i] = c[i] = kUndef;
  int left = out_size;
  for (int ftotal = 0; left > 0 && ftotal < tries; ++ftotal) {
    for (int rep = 0; rep < out_size; ++rep) {
      if (get<NR>(o, base + rep) != kUndef) continue;
      const uint32_t r = (uint32_t)(rep + numrep * ftotal);
      int status;
      const int item = descend(k, b0, x, r, 0, type, status);
      if (status == kEmpty) continue;
      if (status == kDead) {
        put<NR>(o, base + rep, kNone);
        put<NR>(c, base + rep, kNone);
        --left;
        continue;
      }
      if (holds<NR>(o, base, end, item)) continue;
      if (leafy) {
        if (item < 0) {
          const int leaf = indep_leaf(k, -1 - item, x, rep, r, numrep, recurse);
          put<NR>(c, base + rep, leaf);
          if (leaf == kNone) continue;
        } else {
          put<NR>(c, base + rep, item);
        }
      }
      if (type_of(k, item) == 0 &&
          is_out_w(item, weight_of(k.weight, k.n_weight, item), k.n_weight, x))
        continue;
      put<NR>(o, base + rep, item);
      --left;
    }
  }
#pragma unroll (NR < kMaxRep ? NR : 1)
  for (int i = 0; i < NR; ++i) {
    if (i >= base && i < end && o[i] == kUndef) o[i] = kNone;
    if (i >= base && i < end && c[i] == kUndef) c[i] = kNone;
  }
}

// One thread per x: the thread of entry i maps x = xs[j], j = idx ? idx[i] : i (i < *n_live
// when given), and writes row j of out (stride ld): result_max items, NONE past the count; the
// count goes to out[j * ld + result_max] (packed) or counts[j].  When the live entries are no
// more than the grid's warps, entry i takes lane 0 of warp i alone: a flagged x needs the most
// draws of all, and x sharing a warp would wait on each other's divergent paths.
template <int NR>
__global__ void __launch_bounds__(kThreads)
crush_rule_kernel(Rule k, const int* __restrict__ prog, int n_steps, const int* __restrict__ xs,
                  const int* __restrict__ idx, const int* __restrict__ n_live, long long n,
                  int* __restrict__ out, int* __restrict__ counts, long long ld, int packed,
                  int result_max) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n_live != nullptr) {
    const long long live = *n_live;
    if (live <= (long long)gridDim.x * (kThreads / 32)) {
      if (threadIdx.x % 32 != 0) return;
      i /= 32;
    }
    if (i >= live) return;
  }
  if (i >= n) return;
  const long long j = idx != nullptr ? idx[i] : i;
  const uint32_t x = (uint32_t)xs[j];
  int* row = out + j * ld;
  int w[NR], o[NR], c[NR];
#pragma unroll (NR < kMaxRep ? NR : 1)
  for (int s = 0; s < NR; ++s) w[s] = o[s] = c[s] = kNone;
  int wsize = 0, nres = 0;
  for (int s = 0; s < n_steps; ++s) {
    const int* st = prog + s * kProgCols;
    const int op = __ldg(st);
    if (op == kOpTake) {
      w[0] = __ldg(st + 1);
      wsize = 1;
    } else if (op == kOpEmit) {
      for (int q = 0; q < wsize && nres < result_max; ++q) row[nres++] = get<NR>(w, q);
      wsize = 0;
    } else if (wsize > 0) {
      const bool firstn = op == kOpChooseFirstn || op == kOpChooseleafFirstn;
      const bool leafy = op == kOpChooseleafFirstn || op == kOpChooseleafIndep;
      const int numrep = __ldg(st + 3);
      int osize = 0;
      for (int q = 0; q < wsize && numrep > 0; ++q) {
        const int parent = get<NR>(w, q);
        if (parent >= 0 || -1 - parent >= k.t.nb || __ldg(k.types + (-1 - parent)) < 0)
          continue;                                   // a device or NONE: no bucket to draw from
        const int room = result_max - osize;
        if (firstn) {
          osize += choose_firstn<NR>(k, st, -1 - parent, x, osize, room, o, c);
        } else {
          const int out_size = min(numrep, room);
          choose_indep<NR>(k, st, -1 - parent, x, osize, out_size, o, c);
          osize += out_size;
        }
      }
#pragma unroll (NR < kMaxRep ? NR : 1)
      for (int q = 0; q < NR; ++q) w[q] = leafy && q < osize ? c[q] : o[q];
      wsize = osize;
    }
  }
  for (int q = nres; q < result_max; ++q) row[q] = kNone;
  if (packed) row[result_max] = nres;
  else counts[j] = nres;
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
  const cudaStream_t st = (cudaStream_t)stream;
  // the main path's slot counts get their own instances (slots in registers)
#define RESOLVE(NR, LP)                                                               \
  crush_resolve_kernel<NR, LP><<<blocks(n_x), kThreads, 0, st>>>(                       \
      a, (const int*)lane_x, (const uint8_t*)valid, (const uint8_t*)risk0, (int*)out, \
      (uint8_t*)risky, n_x, parents, width, mode)
  if (numrep == 3) RESOLVE(3, 1);
  else if (numrep == 12) RESOLVE(12, 1);
  else RESOLVE(kMaxRep, 1);
#undef RESOLVE
  return (int)cudaGetLastError();
}

extern "C" int crush_rule_launch(const void* xs, const void* idx, const void* n_live, long long n,
                                 void* out, void* counts, long long ld, int packed,
                                 const void* items, const void* hash_ids, const void* sizes,
                                 const void* weights, const void* qsel, const void* qtables,
                                 const void* g, const void* types, int nb, int s, int npos,
                                 const void* prog, int n_steps, const void* weight, int n_weight,
                                 int result_max, void* stream) {
  if (result_max < 1 || result_max > kMaxRep) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Rule k{{(const int*)items, (const int*)hash_ids, (const int*)sizes, (const uint32_t*)weights,
          (const int*)qsel, (const int*)qtables, (const long long*)g, nb, s, npos},
         (const int*)types, (const uint32_t*)weight, n_weight};
  const cudaStream_t st = (cudaStream_t)stream;
#define RULE(NR)                                                                         \
  crush_rule_kernel<NR><<<blocks(n), kThreads, 0, st>>>(                                   \
      k, (const int*)prog, n_steps, (const int*)xs, (const int*)idx, (const int*)n_live, n, \
      (int*)out, (int*)counts, ld, packed, result_max)
  if (result_max <= 3) RULE(3);
  else if (result_max <= 12) RULE(12);
  else RULE(kMaxRep);
#undef RULE
  return (int)cudaGetLastError();
}
