// The candidate-table CRUSH mapper on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the jitted XLA functions of ceph_tpu/ops/crush_fast.py (K7):
//
// - K7a crush_descend: FastRule._candidates (:592) through _descend (:489), _straw2_int (:431)
//   and _straw2_exact64 (:445).  One launch per stage of the candidate phase: the grid is
//   (N parent lanes) x (R retries x P weight-set positions), and thread (lane, r, p) reads the
//   lane's x and start bucket and walks `depth` levels down the map, each level one straw2
//   draw over the bucket's items (mapper.c:322-367): u = hash32_3(x, id, r) & 0xFFFF, then on a
//   level whose buckets all have one uniform weight w >= 0x10000 the i32 quotient
//   T_w[u] = floor(G[u] / w) - 2^31 from a 64K table, elsewhere floor(G[u] / w) exactly: from
//   the item's int64 table of its weight where the map has few distinct weights, else as a
//   multiply-high by the weight's magic number (straw2_quotient); G[u] = 2^48 - crush_ln(u)
//   (a zero weight draws 2^62).  The first strict minimum wins, as the reference's
//   strict-greater update does, so a bucket whose weights are all zero still returns item 0.
//   For a leaf rule the same thread then draws the candidate's L leaf attempts with
//   _candidates' sub-r and position and writes them into the (R, L, P, N) table.
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
// - K6 crush_rule: ceph_tpu/ops/crush_kernels.py's DeviceCrushMapper (:436, vmapped :455) through
//   _straw2_choose (:224), _descend (:242), _is_out (:280), _choose_firstn (:290-362) and
//   _choose_indep (:364-435).  It runs the rule program (ops/crush_kernels.py: TAKE, the choose
//   steps with the tries, recurse tries, vary_r and stable in force, EMIT) for each x with the
//   rule's full choose_tries and recurse_tries, exactly as crush_do_rule (mapper.c:883-1087)
//   does, firstn's count and indep's out_size bounded by what is left of result_max.  Each draw
//   (straw2_win) hashes with hash32_3 and takes the quotient table of a bucket whose items all
//   weigh one w >= 0x10000, else the s64 G[u] / w (K7a's split hash and multiply-high are not
//   taken here).
//
//   Bound: instructions, ~141 per straw2 item drawn (K7a's draw, below) times the items this
//   run's x draw (the plain version counts them).  The main path launches K6 on the first
//   *n_live entries of an index list into the candidate set's x, writing exact rows into K7b's
//   packed table: the x K7b flags, a few hundred of 100000, counted on the device.  Those are
//   the rule's slowest x (~1165 items against a mean of ~918 on the EC rule); one lone thread
//   each, as K6 first ran, walks its items as one dependent hash-and-gather chain, a few hundred
//   threads fill ~3% of the card's warp slots, and the launch lasts one chain: 0.58 ms for 287 x
//   against a 0.0014 ms bound on an H100, ~1000 cycles per item.  So the index-list launch runs
//   one warp per x.  Its 32 lanes share every draw: lane l hashes items l, l + 32 (two
//   independent chains on a 50-wide bucket), and a 5-step xor-shuffle argmin over (value,
//   index) reduces them, so a draw costs one hash and one gather of latency instead of `size`
//   of them.  Lane s holds slot s of w, o and c (kMaxRep slots, the warp's width, so every
//   result_max the wrapper takes fits): a slot read is a shuffle, a write one lane's register,
//   a collision test one ballot, and nothing goes to local memory.  Every branch outside a
//   draw depends on warp-uniform values (the program, the reduced winner, the ballots), so the
//   lanes never diverge there.  The grid holds at most what the card runs at once and its warps
//   stride over the live entries, so a few hundred flagged x each get a warp of their own.  The
//   map's tables are read through the read-only cache: staging the bucket tables (20-31 KB) in
//   shared memory measured no faster on the flagged launch.
//
//   A launch over a whole list of x (DeviceCrushMapper.map_batch) runs one thread per x: there
//   the 32 x of a warp mostly walk the same steps, every lane draws, and nothing is reduced, and
//   on the firstn rule that form measured faster than the warp form (which wins on the EC rule).
//   Its slot state lives in registers for result_max 3 and 12 (template instances) and in local
//   memory for any other result_max <= 32.
//
// Candidates are laid out (R, P, N) and leaf attempts (R, L, P, N) with the lane N on the fast
// axis, so a warp's loads of one (r, position) are 32 neighbouring words.
//
// Bound on this card.  K7a: integer instructions.  A draw is one hash32_3 (5 Jenkins mixes of 9
// lines, each at least a 3-input add, a shift and an XOR), the mask, the table gather, the compare
// and the select, ~141 instructions (a draw on a 64-bit quotient ~3 more); the tables it gathers
// from (256 KiB per i32 weight, 512 KiB per int64 one or G << 15) stay in L2.  At 100000 x, firstn
// size 3 on 50 hosts of 20 OSDs, that is 700,000 threads x 70 draws, 6.9e9 instructions, ~0.21 ms
// at the card's instruction rate (132 SMs x 4 schedulers x 32 lanes x 1.98 GHz).  As ptxas compiles
// hash32_3, 120 of its 140 instructions issue on the integer pipe, which takes half that rate, and
// a hash-only probe (crush_probe.cu) runs it at the integer pipe's ceiling; so K7a's draw takes the
// hash with 7 of each mix's 9 subtractions on the FMA pipe (IMADs by 0xFFFFFFFF, hash32_3_split):
// 173 instructions, 86 integer and 84 FMA, the fastest split the probe timed (0.90 of hash32_3's
// time).  Its index arithmetic is one IMAD.WIDE per load (elem), and the lanes' (x, start, r,
// position) come from the thread's index, so nothing but the tables and the outputs moves through
// memory.  K7b: bytes, the candidates and leaf attempts read once and the packed rows written once:
// ~8 MB for firstn size 3 (2.4 us at 3.35 TB/s), ~150 MB for the EC rule, 12 slots x 5 rounds x 5
// leaf attempts (45 us).  Its reads depend on the slots decided before them, and a thread skips the
// rounds a slot no longer needs, so it is latency-bound, not bandwidth-bound.  K6: see above.
#include <cuda_runtime.h>
#include <stdint.h>

#include "crush_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRep = 32;                   // most slots of one choose step (numrep)
constexpr int kNone = 0x7FFFFFFF;             // CRUSH_ITEM_NONE
constexpr int kUndef = 0x7FFFFFFE;            // CRUSH_ITEM_UNDEF
constexpr long long kZeroDraw = 1LL << 62;    // the draw of a zero weight (sorts last)
constexpr int kIntMax = 0x7FFFFFFF;
constexpr long long kLongMax = 0x7FFFFFFFFFFFFFFFLL;

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

// K6's straw2 draw from bucket b at position p: the item at the first strict minimum of the
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

// What K7a reads of the map: a straw2 weight enters as its item's int64 table or its
// multiply-high word (Q64 or not), an i32 table on an integer level.
struct DescentMap {
  const int* items;                  // (nb, S) item ids, NONE past a bucket's size
  const int* hash_ids;               // (nb, S) ids hashed in the draw
  const int* sizes;                  // (nb,)
  const unsigned long long* magic;   // (npos, nb, S) m | t << 58 of each weight, 0 for a zero one
  const int* qidx;                   // (nb,) quotient table of a bucket on an integer level
  const int* qtables;                // (n_tables, 65536) i32 quotients, biased by -2^31
  const unsigned long long* g15;     // (65536,) G[u] << 15
  const int* qitem;                  // (npos, nb, S) i64 quotient table of each item, -1 zero
  const long long* q64;              // (n_q64, 65536) floor(G[u] / w); both null: magic
  int nb, s, npos;
};

// One launch's grid: blockIdx.y = r * P + p, the threads of blockIdx.x the N parent lanes.
struct DescentGrid {
  const int* xl;      // (N,) x of each parent lane
  const int* roots;   // (N,) bucket index each lane starts from
  int* cand;          // (R, P, N)
  int* leaf;          // (R, L, P, N) when L > 0
  long long n;
  int p_count, l_count;
  int depth, leaf_depth;           // levels of the candidate and of each leaf attempt (0: the
  unsigned int_mask, leaf_mask;    // candidate is its own leaf); levels on the i32 tables
  int leaf_firstn, vary_r, numrep;
};

constexpr unsigned long long kMagicMask = (1ULL << 58) - 1;

// floor(G / w) for 0 <= G <= 2^48: the high word of (G << 15) * m, shifted right by t, with
// t = ceil(log2 w) and m = ceil(2^(49 + t) / w) packed in one word (ops/crush_fast.py,
// straw2_magic).  m w - 2^(49 + t) < w, so the error of the product stays below one unit.
__device__ __forceinline__ unsigned long long straw2_quotient(unsigned long long g15,
                                                              unsigned long long w) {
  return __umul64hi(g15, w & kMagicMask) >> (unsigned)(w >> 58);
}

// base + i, as one IMAD.WIDE.U32 (i < 2^32); left to itself ptxas widens a loop's index with
// 64-bit adds on the integer pipe before every load
template <class T>
__device__ __forceinline__ const T* elem(const T* base, uint32_t i) {
  unsigned long long p;
  asm("mad.wide.u32 %0, %1, %2, %3;"
      : "=l"(p)
      : "r"(i), "n"((int)sizeof(T)), "l"((unsigned long long)base));
  return (const T*)p;
}

// One straw2 draw from bucket b at position p: the item at the first strict minimum of the
// quotients, from quotient table `table` (>= 0), else from each item's int64 table (Q64; one
// IMAD.WIDE and a gather) or the multiply-high of its weight (~10 more instructions, half of
// them IMADs).  The tables measured ~5% faster on maps of up to 48 distinct weights and slower
// from 64 on, where their 512 KiB each no longer stay in L2 (ops/crush_fast.py,
// Q64_MAX_TABLES).
template <bool Q64>
__device__ __forceinline__ int descend_draw(const DescentMap& t, int b, uint32_t x, uint32_t r,
                                            int p, int table, uint32_t neg1) {
  const uint32_t size = (uint32_t)__ldg(t.sizes + b);
  const long long row = (long long)b * t.s;
  const int* ids = t.hash_ids + row;
  uint32_t win = 0;
  if (table >= 0) {
    const int* q = t.qtables + ((long long)table << 16);
    int best = 0;
    for (uint32_t k = 0; k < size; ++k) {
      const uint32_t u = hash32_3_split(x, (uint32_t)__ldg(elem(ids, k)), r, neg1) & 0xFFFFu;
      const int v = __ldg(elem(q, u));
      if (k == 0 || v < best) { best = v; win = k; }
    }
  } else {
    const long long at = (long long)p * t.nb * t.s + row;
    unsigned long long best = 0;
    for (uint32_t k = 0; k < size; ++k) {
      unsigned long long v = (unsigned long long)kZeroDraw;
      if constexpr (Q64) {
        const int tq = __ldg(elem(t.qitem + at, k));
        if (tq >= 0) {
          const uint32_t u = hash32_3_split(x, (uint32_t)__ldg(elem(ids, k)), r, neg1) & 0xFFFFu;
          v = (unsigned long long)__ldg(elem(t.q64 + ((long long)tq << 16), u));
        }
      } else {
        const unsigned long long w = __ldg(elem(t.magic + at, k));
        if ((uint32_t)(w >> 32)) {    // m >= 2^49: only a zero weight has a zero high word
          const uint32_t u = hash32_3_split(x, (uint32_t)__ldg(elem(ids, k)), r, neg1) & 0xFFFFu;
          v = straw2_quotient(__ldg(elem(t.g15, u)), w);
        }
      }
      if (k == 0 || v < best) { best = v; win = k; }
    }
  }
  return __ldg(elem(t.items + row, win));
}

template <bool Q64>
__device__ __forceinline__ int descend_path(const DescentMap& t, int b, uint32_t x, uint32_t r,
                                            int p, int depth, unsigned mask,
                                            uint32_t neg1) {
  int item = 0;
  for (int d = 0; d < depth; ++d) {
    item = descend_draw<Q64>(t, b, x, r, p, ((mask >> d) & 1u) ? __ldg(t.qidx + b) : -1, neg1);
    b = max(-1 - item, 0);
  }
  return item;
}

// Thread (lane, r, p) writes cand[r, p, lane] and, for a leaf rule, its L leaf attempts
// leaf[r, :, p, lane], drawn from the candidate's bucket with _candidates' sub-r and position:
// firstn (r >> (vary_r - 1)) + f2 (f2 alone when vary_r is 0) at position p; indep
// rep + r + numrep f2 at position rep = r % numrep.
template <bool Q64>
__global__ void __launch_bounds__(kThreads)
crush_descend_kernel(DescentMap t, DescentGrid g, uint32_t neg1) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= g.n) return;
  const int r = (int)blockIdx.y / g.p_count;
  const int pi = (int)blockIdx.y - r * g.p_count;
  const uint32_t x = (uint32_t)__ldg(g.xl + lane);
  const int item = descend_path<Q64>(t, __ldg(g.roots + lane), x, (uint32_t)r,
                                     min(pi, t.npos - 1), g.depth, g.int_mask, neg1);
  g.cand[(long long)blockIdx.y * g.n + lane] = item;
  if (g.l_count == 0) return;
  int sub_r, lpos, step;
  if (g.leaf_firstn) {
    sub_r = g.vary_r ? r >> (g.vary_r - 1) : 0;
    lpos = pi;
    step = 1;
  } else {
    lpos = r % g.numrep;
    sub_r = lpos + r;
    step = g.numrep;
  }
  lpos = min(lpos, t.npos - 1);
  const int lb = max(-1 - item, 0);
  int* out = g.leaf + ((long long)r * g.l_count * g.p_count + pi) * g.n + lane;
  for (int f2 = 0; f2 < g.l_count; ++f2) {
    out[(long long)f2 * g.p_count * g.n] =
        g.leaf_depth ? descend_path<Q64>(t, lb, x, (uint32_t)(sub_r + step * f2), lpos,
                                         g.leaf_depth, g.leaf_mask, neg1)
                     : item;
  }
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
constexpr int kOpTake = 1, kOpChooseFirstn = 2, kOpEmit = 4;
constexpr int kOpChooseleafFirstn = 6, kOpChooseleafIndep = 7;
constexpr int kMaxDescent = 12;   // > CRUSH_MAX_DEPTH, as ops/crush_kernels.py's MAX_DESCENT
constexpr int kRuleWarps = 4;     // warps (x in flight) per block of the warp form
constexpr int kRuleUnroll = 4;    // items per straw2 loop iteration of the thread form
constexpr unsigned kFull = 0xFFFFFFFFu;
enum { kOk = 0, kDead = 1, kEmpty = 2 };

struct Rule {
  MapTables t;            // qidx: a bucket's quotient table, -1 for the s64 divide
  const int* types;       // (nb,) bucket type, -1 where the map has no bucket
  const uint32_t* weight; // (n_weight,) the epoch's device weights
  int n_weight;
};

struct Step {
  int op, type, numrep, tries, recurse, vary_r, stable;
};

__device__ __forceinline__ Step load_step(const int* p) {
  return Step{__ldg(p), __ldg(p + 2), __ldg(p + 3), __ldg(p + 4), __ldg(p + 5), __ldg(p + 6),
              __ldg(p + 7)};
}

__device__ __forceinline__ int type_of(const Rule& k, int item) {
  return item >= 0 ? 0 : __ldg(k.types + (-1 - item));
}

__device__ __forceinline__ bool rule_is_out(const Rule& k, int item, uint32_t x) {
  return is_out_w(item, weight_of(k.weight, k.n_weight, item), k.n_weight, x);
}

// A parent of a choose step that is no bucket to draw from: a device, NONE, or no bucket.
__device__ __forceinline__ bool no_bucket(const Rule& k, int parent) {
  return parent >= 0 || -1 - parent >= k.t.nb || __ldg(k.types + (-1 - parent)) < 0;
}

// ---- K6, the warp form: one warp per x (the index-list launch) ----------------------------------

namespace per_warp {

// The first strict minimum over the lanes' (value, item index) pairs: a butterfly of xor-shuffles,
// the lower value first and the lower index on a tie (the serial loop's strict `<`, mapper.c's
// strict `>`), leaves the winner's index on every lane.
template <class V>
__device__ __forceinline__ int argmin(V best, int bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const V ov = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (ov < best || (ov == best && oi < bi)) { best = ov; bi = oi; }
  }
  return bi;
}

// The warp's straw2 draw from bucket b of `size` items at position p: lane l draws items l,
// l + 32, ... and keeps its own first strict minimum, then the warp reduces.
__device__ __forceinline__ int straw2(const MapTables& t, int b, int size, uint32_t x, uint32_t r,
                                      int p, int lane) {
  const long long row = (long long)b * t.s;
  const int table = __ldg(t.qidx + b);
  int win;
  if (table >= 0) {
    const int* q = t.qtables + ((long long)table << 16);
    int best = kIntMax, bi = kIntMax;
    // two items per iteration: two independent hash-and-gather chains per lane
    for (int k = lane; k < size; k += 64) {
      const bool two = k + 32 < size;
      const uint32_t u0 = hash32_3(x, (uint32_t)__ldg(t.hash_ids + row + k), r) & 0xFFFFu;
      const uint32_t u1 =
          two ? hash32_3(x, (uint32_t)__ldg(t.hash_ids + row + k + 32), r) & 0xFFFFu : 0u;
      const int v0 = __ldg(q + u0);
      const int v1 = __ldg(q + u1);
      if (bi == kIntMax || v0 < best) { best = v0; bi = k; }
      if (two && v1 < best) { best = v1; bi = k + 32; }
    }
    win = argmin<int>(best, bi);
  } else {
    const uint32_t* w = t.weights + ((long long)p * t.nb) * t.s + row;
    long long best = kLongMax;
    int bi = kIntMax;
    for (int k = lane; k < size; k += 32) {
      const uint32_t wk = __ldg(w + k);
      long long v = kZeroDraw;
      if (wk) {
        const uint32_t u = hash32_3(x, (uint32_t)__ldg(t.hash_ids + row + k), r) & 0xFFFFu;
        v = __ldg(t.g + u) / (long long)wk;
      }
      if (bi == kIntMax || v < best) { best = v; bi = k; }
    }
    win = argmin<long long>(best, bi);
  }
  return __ldg(t.items + row + win);
}

// Does the lanes' slot state hold v in slots [lo, hi)?  One ballot.
__device__ __forceinline__ bool holds(int slot, int lo, int hi, int v, int lane) {
  return __ballot_sync(kFull, lane >= lo && lane < hi && slot == v) != 0;
}

// _descend: from bucket index b draw with r fixed until an item of `type` (do-while: the start
// bucket is always drawn from).  kEmpty at an empty bucket, kDead at a device of another type.
__device__ __forceinline__ int descend(const Rule& k, int b, uint32_t x, uint32_t r, int pos,
                                       int type, int lane, int& status) {
  const int p = min(pos, k.t.npos - 1);
  for (int depth = 0; depth < kMaxDescent; ++depth) {
    const int size = __ldg(k.t.sizes + b);
    if (size == 0) { status = kEmpty; return 0; }
    const int item = straw2(k.t, b, size, x, r, p, lane);
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
__device__ __forceinline__ bool firstn_leaf(const Rule& k, const Step& st, int b, uint32_t x,
                                            uint32_t r, int base, int outpos, int c, int lane,
                                            int& leaf) {
  const uint32_t sub_r = st.vary_r ? (st.vary_r - 1 < 32 ? r >> (st.vary_r - 1) : 0u) : 0u;
  const uint32_t rep = st.stable ? 0u : (uint32_t)outpos;
  for (int ft = 0;;) {
    int status;
    const int lf = descend(k, b, x, rep + sub_r + ft, outpos, 0, lane, status);
    if (status == kDead) return false;
    if (status == kOk && !holds(c, base, base + outpos, lf, lane) && !rule_is_out(k, lf, x)) {
      leaf = lf;
      return true;
    }
    if (++ft >= st.recurse) return false;
  }
}

// crush_choose_firstn with bobtail+ tunables (mapper.c:443-636), writing the lanes' o/c from slot
// `base`: every reject or collision restarts the descent with ftotal + 1.  Returns the picks.
__device__ __forceinline__ int choose_firstn(const Rule& k, const Step& st, int b0, uint32_t x,
                                             int base, int count, int& o, int& c, int lane) {
  const bool leafy = st.op == kOpChooseleafFirstn;
  int outpos = 0;
  for (int rep = 0; rep < st.numrep && count > 0; ++rep) {
    for (int ftotal = 0;;) {
      const uint32_t r = (uint32_t)(rep + ftotal);
      int status;
      const int item = descend(k, b0, x, r, outpos, st.type, lane, status);
      if (status == kDead) break;                   // skip_rep
      const int slot = base + outpos;
      bool reject = status == kEmpty, collide = false;
      if (!reject) {
        collide = holds(o, base, slot, item, lane);
        if (!collide && leafy) {
          int leaf = item;
          if (item < 0 && !firstn_leaf(k, st, -1 - item, x, r, base, outpos, c, lane, leaf))
            reject = true;
          else if (lane == slot)
            c = leaf;
        }
        if (!reject && !collide && type_of(k, item) == 0) reject = rule_is_out(k, item, x);
      }
      if (!reject && !collide) {
        if (lane == slot) o = item;
        ++outpos;
        --count;
        break;
      }
      if (++ftotal >= st.tries) break;
    }
  }
  return outpos;
}

// The chooseleaf recursion of indep (mapper.c:725-741): the slot at outpos rep, r' = rep + r +
// numrep * ft for ft < recurse; NONE when it fails.
__device__ __forceinline__ int indep_leaf(const Rule& k, const Step& st, int b, uint32_t x,
                                          int rep, uint32_t r, int lane) {
  for (int ft = 0; ft < st.recurse; ++ft) {
    int status;
    const int lf =
        descend(k, b, x, (uint32_t)rep + r + (uint32_t)(st.numrep * ft), rep, 0, lane, status);
    if (status == kDead) return kNone;
    if (status == kOk && !rule_is_out(k, lf, x)) return lf;
  }
  return kNone;
}

// crush_choose_indep (mapper.c:638-790) on the lanes' o/c in slots [base, base + out_size):
// rounds retry the UNDEF slots with r' = rep + numrep * ftotal until tries run out (straw2 only,
// so never the uniform bucket's (numrep + 1) * ftotal); dead ends become NONE.  A device picked
// directly is written to c before its is_out test, as mapper.c:736-742 does.
__device__ __forceinline__ void choose_indep(const Rule& k, const Step& st, int b0, uint32_t x,
                                             int base, int out_size, int& o, int& c, int lane) {
  const bool leafy = st.op == kOpChooseleafIndep;
  const int end = base + out_size;
  const bool mine = lane >= base && lane < end;
  if (mine) o = c = kUndef;
  int left = out_size;
  for (int ftotal = 0; left > 0 && ftotal < st.tries; ++ftotal) {
    for (int rep = 0; rep < out_size; ++rep) {
      const int slot = base + rep;
      if (__shfl_sync(kFull, o, slot) != kUndef) continue;
      const uint32_t r = (uint32_t)(rep + st.numrep * ftotal);
      int status;
      const int item = descend(k, b0, x, r, 0, st.type, lane, status);
      if (status == kEmpty) continue;
      if (status == kDead) {
        if (lane == slot) o = c = kNone;
        --left;
        continue;
      }
      if (holds(o, base, end, item, lane)) continue;
      if (leafy) {
        const int leaf = item < 0 ? indep_leaf(k, st, -1 - item, x, rep, r, lane) : item;
        if (lane == slot) c = leaf;
        if (leaf == kNone) continue;
      }
      if (type_of(k, item) == 0 && rule_is_out(k, item, x)) continue;
      if (lane == slot) o = item;
      --left;
    }
  }
  if (mine && o == kUndef) o = kNone;
  if (mine && c == kUndef) c = kNone;
}

// The rule program for one x.  Lane s holds slot s of the working vector w and of the choose
// step's o/c (kMaxRep slots, the warp's width); every branch depends on warp-uniform values only
// (the program, the reduced draws, the ballots).  Writes the row's result_max items, NONE past
// the count, and the count after them.
__device__ __forceinline__ void one_x(const Rule& k, const int* __restrict__ prog, int n_steps,
                                      uint32_t x, int* row, int result_max, int lane) {
  int w = kNone, o = kNone, c = kNone;
  int wsize = 0, nres = 0;
  for (int s = 0; s < n_steps; ++s) {
    const int* p = prog + s * kProgCols;
    const Step st = load_step(p);
    if (st.op == kOpTake) {
      if (lane == 0) w = __ldg(p + 1);
      wsize = 1;
    } else if (st.op == kOpEmit) {
      const int take = min(wsize, result_max - nres);
      if (lane < take) row[nres + lane] = w;
      nres += take;
      wsize = 0;
    } else if (wsize > 0) {
      const bool firstn = st.op == kOpChooseFirstn || st.op == kOpChooseleafFirstn;
      const bool leafy = st.op == kOpChooseleafFirstn || st.op == kOpChooseleafIndep;
      int osize = 0;
      for (int q = 0; q < wsize && st.numrep > 0; ++q) {
        const int parent = __shfl_sync(kFull, w, q);
        if (no_bucket(k, parent)) continue;
        const int room = result_max - osize;
        if (firstn) {
          osize += choose_firstn(k, st, -1 - parent, x, osize, room, o, c, lane);
        } else {
          const int out_size = min(st.numrep, room);
          choose_indep(k, st, -1 - parent, x, osize, out_size, o, c, lane);
          osize += out_size;
        }
      }
      w = leafy && lane < osize ? c : o;
      wsize = osize;
    }
  }
  if (lane >= nres && lane < result_max) row[lane] = kNone;
  if (lane == 0) row[result_max] = nres;
}

}  // namespace per_warp

// Warp i of the grid maps the entries i, i + (the grid's warps), ... below live = min(n,
// *n_live): x = xs[j], j = idx[i], into row j of the packed table out (result_max items, then the
// count).  The grid is at most what the card holds at once, so every live entry starts at launch
// and, while the live entries are fewer than the grid's warps, each has a warp of its own.
__global__ void __launch_bounds__(kRuleWarps * 32, 8)
crush_rule_warp_kernel(Rule k, const int* __restrict__ prog, int n_steps,
                       const int* __restrict__ xs, const int* __restrict__ idx,
                       const int* __restrict__ n_live, long long n, int* __restrict__ out,
                       int result_max) {
  const long long live = min(n, (long long)*n_live);
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kRuleWarps;
  for (long long i = (long long)blockIdx.x * kRuleWarps + threadIdx.x / 32; i < live;
       i += stride) {
    const long long j = idx[i];
    per_warp::one_x(k, prog, n_steps, (uint32_t)xs[j], out + j * (result_max + 1), result_max,
                    lane);
  }
}

// The warp form's grid: enough blocks for n warps, no more than the card holds at once.
unsigned rule_warp_blocks(long long n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crush_rule_warp_kernel, kRuleWarps * 32,
                                                0);
  const long long want = (n + kRuleWarps - 1) / kRuleWarps;
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  return (unsigned)(want < most ? want : most);
}

// ---- K6, the thread form: one thread per x (a launch over a whole list of x) --------------------

namespace per_thread {

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
    if (st == kOk && !holds<NR>(c, base, base + outpos, lf) && !rule_is_out(k, lf, x)) {
      leaf = lf;
      return true;
    }
    if (++ft >= recurse) return false;
  }
}

// crush_choose_firstn with bobtail+ tunables (mapper.c:443-636), writing o/c from `base`:
// every reject or collision restarts the descent with ftotal + 1.  Returns the picks made.
template <int NR>
__device__ int choose_firstn(const Rule& k, const Step& st, int b0, uint32_t x, int base,
                             int count, int (&o)[NR], int (&c)[NR]) {
  const int op = st.op, type = st.type, numrep = st.numrep, tries = st.tries,
            recurse = st.recurse;
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
            if (firstn_leaf<NR>(k, -1 - item, x, r, base, outpos, recurse, st.vary_r, st.stable, c,
                               leaf))
              put<NR>(c, base + outpos, leaf);
            else
              reject = true;
          } else {
            put<NR>(c, base + outpos, item);
          }
        }
        if (!reject && !collide && type_of(k, item) == 0)
          reject = rule_is_out(k, item, x);
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
    if (st == kOk && !rule_is_out(k, lf, x)) return lf;
  }
  return kNone;
}

// crush_choose_indep (mapper.c:638-790) on o/c[base, base + out_size): rounds retry the UNDEF
// slots with r' = rep + numrep * ftotal until tries run out (straw2 only, so never the uniform
// bucket's (numrep + 1) * ftotal); dead ends become NONE.  A device picked directly is written
// to c before its is_out test, as mapper.c:736-742 does.
template <int NR>
__device__ void choose_indep(const Rule& k, const Step& st, int b0, uint32_t x, int base,
                             int out_size, int (&o)[NR], int (&c)[NR]) {
  const int op = st.op, type = st.type, numrep = st.numrep, tries = st.tries,
            recurse = st.recurse;
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
      if (type_of(k, item) == 0 && rule_is_out(k, item, x)) continue;
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

}  // namespace per_thread

// One thread per x: x = xs[i] into row i of out (result_max items, NONE past the count) and the
// count into counts[i].  Over a whole list of x, the x of one warp mostly walk the same steps.
template <int NR>
__global__ void __launch_bounds__(kThreads)
crush_rule_thread_kernel(Rule k, const int* __restrict__ prog, int n_steps,
                         const int* __restrict__ xs, long long n, int* __restrict__ out,
                         int* __restrict__ counts, int result_max) {
  using namespace per_thread;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = (uint32_t)xs[i];
  int* row = out + i * result_max;
  int w[NR], o[NR], c[NR];
#pragma unroll (NR < kMaxRep ? NR : 1)
  for (int s = 0; s < NR; ++s) w[s] = o[s] = c[s] = kNone;
  int wsize = 0, nres = 0;
  for (int s = 0; s < n_steps; ++s) {
    const int* p = prog + s * kProgCols;
    const Step st = load_step(p);
    if (st.op == kOpTake) {
      w[0] = __ldg(p + 1);
      wsize = 1;
    } else if (st.op == kOpEmit) {
      for (int q = 0; q < wsize && nres < result_max; ++q) row[nres++] = get<NR>(w, q);
      wsize = 0;
    } else if (wsize > 0) {
      const bool firstn = st.op == kOpChooseFirstn || st.op == kOpChooseleafFirstn;
      const bool leafy = st.op == kOpChooseleafFirstn || st.op == kOpChooseleafIndep;
      int osize = 0;
      for (int q = 0; q < wsize && st.numrep > 0; ++q) {
        const int parent = get<NR>(w, q);
        if (no_bucket(k, parent)) continue;
        const int room = result_max - osize;
        if (firstn) {
          osize += choose_firstn<NR>(k, st, -1 - parent, x, osize, room, o, c);
        } else {
          const int out_size = min(st.numrep, room);
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
  counts[i] = nres;
}

inline unsigned blocks(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int crush_descend_launch(const void* xl, const void* roots, void* cand, void* leaf,
                                    long long n, int r_count, int p_count, int l_count,
                                    const void* items, const void* hash_ids, const void* sizes,
                                    const void* magic, const void* qidx, const void* qtables,
                                    const void* g15, const void* qitem, const void* q64, int nb,
                                    int s, int npos, int depth, int int_mask, int leaf_depth,
                                    int leaf_mask, int leaf_firstn, int vary_r, int numrep,
                                    void* stream) {
  if (r_count < 1 || p_count < 1 || (long long)r_count * p_count > 65535 || l_count < 0 ||
      (l_count > 0 && leaf == nullptr) || (qitem == nullptr) != (q64 == nullptr) ||
      (!leaf_firstn && numrep < 1))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const DescentMap t{(const int*)items, (const int*)hash_ids, (const int*)sizes,
                     (const unsigned long long*)magic, (const int*)qidx, (const int*)qtables,
                     (const unsigned long long*)g15, (const int*)qitem, (const long long*)q64,
                     nb, s, npos};
  const DescentGrid g{(const int*)xl, (const int*)roots, (int*)cand, (int*)leaf, n, p_count,
                      l_count, depth, leaf_depth, (unsigned)int_mask, (unsigned)leaf_mask,
                      leaf_firstn, vary_r, numrep};
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)(r_count * p_count));
  if (q64 != nullptr)
    crush_descend_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(t, g, 0xFFFFFFFFu);
  else
    crush_descend_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(t, g, 0xFFFFFFFFu);
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
  // an index list goes with the packed table (the warp form), a whole list with rows and counts
  if ((idx != nullptr) != (packed != 0) || (idx != nullptr) != (n_live != nullptr) ||
      ld != result_max + packed)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const Rule k{{(const int*)items, (const int*)hash_ids, (const int*)sizes,
                (const uint32_t*)weights, (const int*)qsel, (const int*)qtables,
                (const long long*)g, nb, s, npos},
               (const int*)types, (const uint32_t*)weight, n_weight};
  const cudaStream_t st = (cudaStream_t)stream;
  if (idx != nullptr) {
    crush_rule_warp_kernel<<<rule_warp_blocks(n), kRuleWarps * 32, 0, st>>>(
        k, (const int*)prog, n_steps, (const int*)xs, (const int*)idx, (const int*)n_live, n,
        (int*)out, result_max);
    return (int)cudaGetLastError();
  }
#define RULE(NR)                                                                       \
  crush_rule_thread_kernel<NR><<<blocks(n), kThreads, 0, st>>>(                          \
      k, (const int*)prog, n_steps, (const int*)xs, n, (int*)out, (int*)counts, result_max)
  if (result_max <= 3) RULE(3);
  else if (result_max <= 12) RULE(12);
  else RULE(kMaxRep);
#undef RULE
  return (int)cudaGetLastError();
}
