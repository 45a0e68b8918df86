// Native CRUSH map evaluator — independent C++ implementation.
//
// Second, independently written implementation of the CRUSH mapping
// semantics (reference: src/crush/mapper.c) used to cross-validate the
// Python host mapper and the TPU kernels, and as the fast CPU batch
// baseline (the ParallelPGMapper analog, reference osd/OSDMapMapping.h).
//
// The port's copy of native/crush_mapper.cpp, built by
// ceph_tpu_torch/native.py.  The map arrives as a flat int64 blob
// serialized by ceph_tpu_torch/native.py:serialize_map; see that file
// for the layout.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t HASH_SEED = 1315423911u;

#define MIXER(a, b, c)                                    \
  do {                                                    \
    a = a - b; a = a - c; a = a ^ (c >> 13);              \
    b = b - c; b = b - a; b = b ^ (a << 8);               \
    c = c - a; c = c - b; c = c ^ (b >> 13);              \
    a = a - b; a = a - c; a = a ^ (c >> 12);              \
    b = b - c; b = b - a; b = b ^ (a << 16);              \
    c = c - a; c = c - b; c = c ^ (b >> 5);               \
    a = a - b; a = a - c; a = a ^ (c >> 3);               \
    b = b - c; b = b - a; b = b ^ (a << 10);              \
    c = c - a; c = c - b; c = c ^ (b >> 15);              \
  } while (0)

uint32_t hash2(uint32_t a, uint32_t b) {
  uint32_t h = HASH_SEED ^ a ^ b, x = 231232u, y = 1232u;
  MIXER(a, b, h);
  MIXER(x, a, h);
  MIXER(b, y, h);
  return h;
}

uint32_t hash3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = HASH_SEED ^ a ^ b ^ c, x = 231232u, y = 1232u;
  MIXER(a, b, h);
  MIXER(c, x, h);
  MIXER(y, a, h);
  MIXER(b, x, h);
  MIXER(y, c, h);
  return h;
}

uint32_t hash4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  uint32_t h = HASH_SEED ^ a ^ b ^ c ^ d, x = 231232u, y = 1232u;
  MIXER(a, b, h);
  MIXER(c, d, h);
  MIXER(a, x, h);
  MIXER(y, b, h);
  MIXER(c, x, h);
  MIXER(y, d, h);
  return h;
}

// ---- crush_ln: fixed point 2^44*log2(x+1); tables injected from python ---
static int64_t g_rh_lh[258];
static int64_t g_ll[256];

int64_t crush_ln_fp(uint32_t xin) {
  uint32_t x = xin + 1;
  int iexpon = 15;
  if (!(x & 0x18000)) {
    int bits = __builtin_clz(x & 0x1FFFF) - 16;
    x <<= bits;
    iexpon = 15 - bits;
  }
  int index1 = (x >> 8) << 1;
  uint64_t RH = (uint64_t)g_rh_lh[index1 - 256];
  uint64_t LH = (uint64_t)g_rh_lh[index1 + 1 - 256];
  uint64_t xl64 = ((uint64_t)x * RH) >> 48;
  int index2 = xl64 & 0xff;
  uint64_t LL = (uint64_t)g_ll[index2];
  uint64_t result = ((uint64_t)iexpon << 44) + ((LH + LL) >> 4);
  return (int64_t)result;
}

// ---- flattened map --------------------------------------------------------

enum Alg { UNIFORM = 1, LIST = 2, TREE = 3, STRAW = 4, STRAW2 = 5 };

struct FlatBucket {
  int32_t id = 0, alg = 0, type = 0, size = 0;
  const int64_t* items = nullptr;
  const int64_t* weights = nullptr;      // per-item (list/straw/straw2)
  const int64_t* aux = nullptr;          // sum_weights / straws
  const int64_t* node_weights = nullptr; // tree
  int64_t item_weight = 0;               // uniform
  int32_t num_nodes = 0;
  bool present = false;
  // choose_args overrides (crush.h crush_choose_arg): straw2 hashing
  // ids and per-position weight replacements
  const int64_t* arg_ids = nullptr;
  const int64_t* arg_weights = nullptr;  // (arg_npos, size) row-major
  int32_t arg_npos = 0;
};

struct FlatRule {
  int32_t ruleset, type, min_size, max_size, len;
  const int64_t* steps;  // 3 per step
  bool present = false;
};

struct FlatMap {
  int64_t max_devices = 0;
  int64_t choose_local_tries = 0, choose_local_fallback_tries = 0;
  int64_t choose_total_tries = 50, chooseleaf_descend_once = 1;
  int64_t chooseleaf_vary_r = 1, chooseleaf_stable = 1;
  std::vector<FlatBucket> buckets;
  std::vector<FlatRule> rules;

  const FlatBucket* bucket(int64_t item) const {
    int64_t bno = -1 - item;
    if (bno < 0 || bno >= (int64_t)buckets.size() || !buckets[bno].present)
      return nullptr;
    return &buckets[bno];
  }
};

bool parse_map(const int64_t* p, int64_t n, FlatMap* m) {
  int64_t i = 0;
  if (n < 10) return false;
  m->max_devices = p[i++];
  m->choose_local_tries = p[i++];
  m->choose_local_fallback_tries = p[i++];
  m->choose_total_tries = p[i++];
  m->chooseleaf_descend_once = p[i++];
  m->chooseleaf_vary_r = p[i++];
  m->chooseleaf_stable = p[i++];
  int64_t nb = p[i++];
  int64_t nr = p[i++];
  m->buckets.resize(nb);
  for (int64_t b = 0; b < nb; b++) {
    FlatBucket& fb = m->buckets[b];
    int64_t present = p[i++];
    if (!present) continue;
    fb.present = true;
    fb.id = (int32_t)p[i++];
    fb.alg = (int32_t)p[i++];
    fb.type = (int32_t)p[i++];
    fb.size = (int32_t)p[i++];
    fb.items = &p[i]; i += fb.size;
    switch (fb.alg) {
      case UNIFORM:
        fb.item_weight = p[i++];
        break;
      case LIST:
        fb.weights = &p[i]; i += fb.size;
        fb.aux = &p[i]; i += fb.size;   // cumulative sums
        break;
      case TREE:
        fb.num_nodes = (int32_t)p[i++];
        fb.node_weights = &p[i]; i += fb.num_nodes;
        break;
      case STRAW:
        fb.weights = &p[i]; i += fb.size;
        fb.aux = &p[i]; i += fb.size;   // straw scalers
        break;
      case STRAW2:
        fb.weights = &p[i]; i += fb.size;
        break;
      default:
        return false;
    }
  }
  m->rules.resize(nr);
  for (int64_t r = 0; r < nr; r++) {
    FlatRule& fr = m->rules[r];
    int64_t present = p[i++];
    if (!present) continue;
    fr.present = true;
    fr.ruleset = (int32_t)p[i++];
    fr.type = (int32_t)p[i++];
    fr.min_size = (int32_t)p[i++];
    fr.max_size = (int32_t)p[i++];
    fr.len = (int32_t)p[i++];
    fr.steps = &p[i]; i += 3 * fr.len;
  }
  // trailing choose_args section (older blobs simply end here).
  // Every advance is bounds-checked BEFORE the dereference — a
  // truncated blob must fail the parse, not read past the buffer.
  if (i < n) {
    int64_t nca = p[i++];
    for (int64_t e = 0; e < nca; e++) {
      if (i + 3 > n) return false;
      int64_t bno = p[i++];
      int64_t has_ids = p[i++];
      int64_t size = p[i++];
      if (bno < 0 || bno >= nb || size < 0 ||
          size != m->buckets[bno].size)
        return false;
      FlatBucket& fb = m->buckets[bno];
      if (has_ids) {
        if (i + size > n) return false;
        fb.arg_ids = &p[i]; i += size;
      }
      if (i + 1 > n) return false;
      int64_t npos = p[i++];
      if (npos < 0 || npos > (n - i) / (size ? size : 1)) return false;
      fb.arg_npos = (int32_t)npos;
      if (npos) {
        if (i + npos * size > n) return false;
        fb.arg_weights = &p[i]; i += npos * size;
      }
    }
  }
  return i <= n;
}

// ---- bucket choosers ------------------------------------------------------

int64_t perm_choose(const FlatBucket* b, int64_t x, int64_t r) {
  int size = b->size;
  unsigned pr = (unsigned)(r % size);
  std::vector<uint32_t> perm(size);
  for (int i = 0; i < size; i++) perm[i] = i;
  for (unsigned p = 0; p <= pr; p++) {
    if ((int)p < size - 1) {
      unsigned i = hash3((uint32_t)x, (uint32_t)b->id, p) % (size - p);
      if (i) std::swap(perm[p], perm[p + i]);
    }
  }
  return b->items[perm[pr]];
}

int64_t list_choose(const FlatBucket* b, int64_t x, int64_t r) {
  for (int i = b->size - 1; i >= 0; i--) {
    uint64_t w = hash4((uint32_t)x, (uint32_t)b->items[i], (uint32_t)r,
                       (uint32_t)b->id) & 0xffff;
    w = (w * (uint64_t)b->aux[i]) >> 16;
    if ((int64_t)w < b->weights[i]) return b->items[i];
  }
  return b->items[0];
}

int64_t tree_choose(const FlatBucket* b, int64_t x, int64_t r) {
  int n = b->num_nodes >> 1;
  while (!(n & 1)) {
    uint64_t w = (uint64_t)b->node_weights[n];
    uint64_t t = ((uint64_t)hash4((uint32_t)x, (uint32_t)n, (uint32_t)r,
                                  (uint32_t)b->id) * w) >> 32;
    int h = __builtin_ctz(n);
    int left = n - (1 << (h - 1));
    if ((int64_t)t < b->node_weights[left])
      n = left;
    else
      n = left + (1 << h);
  }
  return b->items[n >> 1];
}

int64_t straw_choose(const FlatBucket* b, int64_t x, int64_t r) {
  int high = 0;
  uint64_t high_draw = 0;
  for (int i = 0; i < b->size; i++) {
    uint64_t draw = hash3((uint32_t)x, (uint32_t)b->items[i],
                          (uint32_t)r) & 0xffff;
    draw *= (uint64_t)b->aux[i];
    if (i == 0 || draw > high_draw) {
      high = i;
      high_draw = draw;
    }
  }
  return b->items[high];
}

int64_t straw2_choose(const FlatBucket* b, int64_t x, int64_t r,
                      int position) {
  // choose_args override the weights (clamped position, mapper.c:
  // get_choose_arg_weights) and the ids hashed (get_choose_arg_ids);
  // only straw2 consumes them (crush_bucket_choose)
  const int64_t* weights = b->weights;
  if (b->arg_npos > 0) {
    int pos = position >= b->arg_npos ? b->arg_npos - 1 : position;
    weights = b->arg_weights + (int64_t)pos * b->size;
  }
  const int64_t* ids = b->arg_ids ? b->arg_ids : b->items;
  int high = 0;
  int64_t high_draw = 0;
  for (int i = 0; i < b->size; i++) {
    int64_t w = weights[i];
    int64_t draw;
    if (w) {
      uint32_t u = hash3((uint32_t)x, (uint32_t)ids[i],
                         (uint32_t)r) & 0xffff;
      int64_t ln = crush_ln_fp(u) - 0x1000000000000ll;
      draw = ln / w;  // C++ division truncates toward zero, as required
    } else {
      draw = INT64_MIN;
    }
    if (i == 0 || draw > high_draw) {
      high = i;
      high_draw = draw;
    }
  }
  return b->items[high];
}

int64_t bucket_choose(const FlatMap& m, const FlatBucket* b, int64_t x,
                      int64_t r, int position) {
  switch (b->alg) {
    case UNIFORM: return perm_choose(b, x, r);
    case LIST:    return list_choose(b, x, r);
    case TREE:    return tree_choose(b, x, r);
    case STRAW:   return straw_choose(b, x, r);
    case STRAW2:  return straw2_choose(b, x, r, position);
  }
  return b->items[0];
}

bool is_out(const FlatMap& m, const uint32_t* weight, int64_t weight_max,
            int64_t item, int64_t x) {
  if (item >= weight_max) return true;
  uint32_t w = weight[item];
  if (w >= 0x10000) return false;
  if (w == 0) return true;
  return (hash2((uint32_t)x, (uint32_t)item) & 0xffff) >= w;
}

constexpr int64_t ITEM_NONE = 0x7fffffff;
constexpr int64_t ITEM_UNDEF = 0x7ffffffe;

// ---- choose firstn/indep --------------------------------------------------

int choose_firstn(const FlatMap& m, const FlatBucket* bucket,
                  const uint32_t* weight, int64_t weight_max, int64_t x,
                  int numrep, int type, int64_t* out, int outpos,
                  int out_size, int tries, int recurse_tries,
                  int local_retries, int local_fallback_retries,
                  bool recurse_to_leaf, int vary_r, int stable,
                  int64_t* out2, int parent_r) {
  int count = out_size;
  int64_t item = 0;
  for (int rep = stable ? 0 : outpos; rep < numrep && count > 0; rep++) {
    unsigned ftotal = 0;
    bool skip_rep = false;
    bool retry_descent = true;
    while (retry_descent) {
      retry_descent = false;
      const FlatBucket* in = bucket;
      unsigned flocal = 0;
      bool retry_bucket = true;
      while (retry_bucket) {
        retry_bucket = false;
        bool collide = false, reject = false;
        int64_t r = rep + parent_r + ftotal;
        if (in->size == 0) {
          reject = true;
        } else {
          if (local_fallback_retries > 0 &&
              flocal >= (unsigned)(in->size >> 1) &&
              flocal > (unsigned)local_fallback_retries)
            item = perm_choose(in, x, r);
          else
            // position = outpos, the dynamic success count
            // (mapper.c:513)
            item = bucket_choose(m, in, x, r, outpos);
          if (item >= m.max_devices) {
            skip_rep = true;
            break;
          }
          int itemtype = 0;
          if (item < 0) {
            const FlatBucket* sub = m.bucket(item);
            if (!sub) { skip_rep = true; break; }
            itemtype = sub->type;
          }
          if (itemtype != type) {
            const FlatBucket* sub = (item < 0) ? m.bucket(item) : nullptr;
            if (!sub) { skip_rep = true; break; }
            in = sub;
            retry_bucket = true;
            continue;
          }
          for (int i = 0; i < outpos; i++) {
            if (out[i] == item) { collide = true; break; }
          }
          if (!collide && recurse_to_leaf) {
            if (item < 0) {
              int sub_r = vary_r ? (int)(r >> (vary_r - 1)) : 0;
              if (choose_firstn(m, m.bucket(item), weight, weight_max, x,
                                stable ? 1 : outpos + 1, 0, out2, outpos,
                                count, recurse_tries, 0, local_retries,
                                local_fallback_retries, false, vary_r,
                                stable, nullptr, sub_r) <= outpos)
                reject = true;
            } else {
              out2[outpos] = item;
            }
          }
          if (!reject && !collide && itemtype == 0)
            reject = is_out(m, weight, weight_max, item, x);
        }
        if (reject || collide) {
          ftotal++;
          flocal++;
          if (collide && flocal <= (unsigned)local_retries)
            retry_bucket = true;
          else if (local_fallback_retries > 0 &&
                   flocal <= (unsigned)(in->size + local_fallback_retries))
            retry_bucket = true;
          else if (ftotal < (unsigned)tries)
            retry_descent = true;
          else
            skip_rep = true;
          if (!retry_bucket) break;
        }
      }
    }
    if (skip_rep) continue;
    out[outpos] = item;
    outpos++;
    count--;
  }
  return outpos;
}

void choose_indep(const FlatMap& m, const FlatBucket* bucket,
                  const uint32_t* weight, int64_t weight_max, int64_t x,
                  int left, int numrep, int type, int64_t* out, int outpos,
                  int tries, int recurse_tries, bool recurse_to_leaf,
                  int64_t* out2, int64_t parent_r) {
  int endpos = outpos + left;
  for (int rep = outpos; rep < endpos; rep++) {
    out[rep] = ITEM_UNDEF;
    if (out2) out2[rep] = ITEM_UNDEF;
  }
  for (unsigned ftotal = 0; left > 0 && ftotal < (unsigned)tries; ftotal++) {
    for (int rep = outpos; rep < endpos; rep++) {
      if (out[rep] != ITEM_UNDEF) continue;
      const FlatBucket* in = bucket;
      for (;;) {
        int64_t r = rep + parent_r;
        if (in->alg == UNIFORM && in->size % numrep == 0)
          r += (numrep + 1) * ftotal;
        else
          r += numrep * ftotal;
        if (in->size == 0) break;
        // position = the invocation's constant starting outpos
        // (mapper.c:723) — 0 from do_rule, rep inside leaf recursion
        int64_t item = bucket_choose(m, in, x, r, outpos);
        if (item >= m.max_devices) {
          out[rep] = ITEM_NONE;
          if (out2) out2[rep] = ITEM_NONE;
          left--;
          break;
        }
        int itemtype = 0;
        if (item < 0) {
          const FlatBucket* sub = m.bucket(item);
          if (!sub) {
            out[rep] = ITEM_NONE;
            if (out2) out2[rep] = ITEM_NONE;
            left--;
            break;
          }
          itemtype = sub->type;
        }
        if (itemtype != type) {
          const FlatBucket* sub = (item < 0) ? m.bucket(item) : nullptr;
          if (!sub) {
            out[rep] = ITEM_NONE;
            if (out2) out2[rep] = ITEM_NONE;
            left--;
            break;
          }
          in = sub;
          continue;
        }
        bool collide = false;
        for (int i = outpos; i < endpos; i++) {
          if (out[i] == item) { collide = true; break; }
        }
        if (collide) break;
        if (recurse_to_leaf) {
          if (item < 0) {
            choose_indep(m, m.bucket(item), weight, weight_max, x, 1, numrep,
                         0, out2, rep, recurse_tries, 0, false, nullptr, r);
            if (out2[rep] == ITEM_NONE) break;
          } else {
            out2[rep] = item;
          }
        }
        if (itemtype == 0 && is_out(m, weight, weight_max, item, x)) break;
        out[rep] = item;
        left--;
        break;
      }
    }
  }
  for (int rep = outpos; rep < endpos; rep++) {
    if (out[rep] == ITEM_UNDEF) out[rep] = ITEM_NONE;
    if (out2 && out2[rep] == ITEM_UNDEF) out2[rep] = ITEM_NONE;
  }
}

enum Op {
  OP_NOOP = 0, OP_TAKE = 1, OP_CHOOSE_FIRSTN = 2, OP_CHOOSE_INDEP = 3,
  OP_EMIT = 4, OP_CHOOSELEAF_FIRSTN = 6, OP_CHOOSELEAF_INDEP = 7,
  OP_SET_CHOOSE_TRIES = 8, OP_SET_CHOOSELEAF_TRIES = 9,
  OP_SET_CHOOSE_LOCAL_TRIES = 10, OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11,
  OP_SET_CHOOSELEAF_VARY_R = 12, OP_SET_CHOOSELEAF_STABLE = 13,
};

int do_rule(const FlatMap& m, int ruleno, int64_t x, int64_t* result,
            int result_max, const uint32_t* weight, int64_t weight_max) {
  if (ruleno < 0 || ruleno >= (int)m.rules.size() ||
      !m.rules[ruleno].present)
    return 0;
  const FlatRule& rule = m.rules[ruleno];

  std::vector<int64_t> a(result_max), b(result_max), c(result_max);
  int64_t* w = a.data();
  int64_t* o = b.data();
  int wsize = 0, result_len = 0;

  int choose_tries = (int)m.choose_total_tries + 1;
  int choose_leaf_tries = 0;
  int choose_local_retries = (int)m.choose_local_tries;
  int choose_local_fallback_retries = (int)m.choose_local_fallback_tries;
  int vary_r = (int)m.chooseleaf_vary_r;
  int stable = (int)m.chooseleaf_stable;

  for (int s = 0; s < rule.len; s++) {
    int op = (int)rule.steps[3 * s];
    int64_t arg1 = rule.steps[3 * s + 1];
    int64_t arg2 = rule.steps[3 * s + 2];
    bool firstn = false;
    switch (op) {
      case OP_TAKE:
        if ((arg1 >= 0 && arg1 < m.max_devices) || m.bucket(arg1)) {
          w[0] = arg1;
          wsize = 1;
        }
        break;
      case OP_SET_CHOOSE_TRIES:
        if (arg1 > 0) choose_tries = (int)arg1;
        break;
      case OP_SET_CHOOSELEAF_TRIES:
        if (arg1 > 0) choose_leaf_tries = (int)arg1;
        break;
      case OP_SET_CHOOSE_LOCAL_TRIES:
        if (arg1 >= 0) choose_local_retries = (int)arg1;
        break;
      case OP_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
        if (arg1 >= 0) choose_local_fallback_retries = (int)arg1;
        break;
      case OP_SET_CHOOSELEAF_VARY_R:
        if (arg1 >= 0) vary_r = (int)arg1;
        break;
      case OP_SET_CHOOSELEAF_STABLE:
        if (arg1 >= 0) stable = (int)arg1;
        break;
      case OP_CHOOSELEAF_FIRSTN:
      case OP_CHOOSE_FIRSTN:
        firstn = true;
        [[fallthrough]];
      case OP_CHOOSELEAF_INDEP:
      case OP_CHOOSE_INDEP: {
        if (wsize == 0) break;
        bool recurse_to_leaf =
            (op == OP_CHOOSELEAF_FIRSTN || op == OP_CHOOSELEAF_INDEP);
        int osize = 0;
        for (int i = 0; i < wsize; i++) {
          int numrep = (int)arg1;
          if (numrep <= 0) {
            numrep += result_max;
            if (numrep <= 0) continue;
          }
          const FlatBucket* bkt = m.bucket(w[i]);
          if (!bkt) continue;
          if (firstn) {
            int recurse_tries;
            if (choose_leaf_tries)
              recurse_tries = choose_leaf_tries;
            else if (m.chooseleaf_descend_once)
              recurse_tries = 1;
            else
              recurse_tries = choose_tries;
            osize += choose_firstn(
                m, bkt, weight, weight_max, x, numrep, (int)arg2, o + osize,
                0, result_max - osize, choose_tries, recurse_tries,
                choose_local_retries, choose_local_fallback_retries,
                recurse_to_leaf, vary_r, stable, c.data() + osize, 0);
          } else {
            int out_size = numrep < (result_max - osize)
                               ? numrep : (result_max - osize);
            choose_indep(m, bkt, weight, weight_max, x, out_size, numrep,
                         (int)arg2, o + osize, 0, choose_tries,
                         choose_leaf_tries ? choose_leaf_tries : 1,
                         recurse_to_leaf, c.data() + osize, 0);
            osize += out_size;
          }
        }
        if (recurse_to_leaf) memcpy(o, c.data(), osize * sizeof(int64_t));
        std::swap(w, o);
        wsize = osize;
        break;
      }
      case OP_EMIT:
        for (int i = 0; i < wsize && result_len < result_max; i++)
          result[result_len++] = w[i];
        wsize = 0;
        break;
      default:
        break;
    }
  }
  return result_len;
}

}  // namespace

extern "C" {

void crush_set_ln_tables(const int64_t* rh_lh, const int64_t* ll) {
  memcpy(g_rh_lh, rh_lh, sizeof(g_rh_lh));
  memcpy(g_ll, ll, sizeof(g_ll));
}

// Evaluate one x; returns result length.
int crush_do_rule_c(const int64_t* blob, int64_t blob_len, int ruleno,
                    int64_t x, int64_t* result, int result_max,
                    const uint32_t* weight, int64_t weight_max) {
  FlatMap m;
  if (!parse_map(blob, blob_len, &m)) return -1;
  return do_rule(m, ruleno, x, result, result_max, weight, weight_max);
}

// Batch evaluate xs[0..nx); out is (nx, result_max), NONE-padded.
// Lengths land in out_len[0..nx).  This is the CPU baseline the TPU
// kernel is benchmarked against.
int crush_do_rule_batch(const int64_t* blob, int64_t blob_len, int ruleno,
                        const int64_t* xs, int64_t nx, int64_t* out,
                        int result_max, int32_t* out_len,
                        const uint32_t* weight, int64_t weight_max) {
  FlatMap m;
  if (!parse_map(blob, blob_len, &m)) return -1;
  for (int64_t i = 0; i < nx; i++) {
    int64_t* row = out + i * result_max;
    for (int j = 0; j < result_max; j++) row[j] = ITEM_NONE;
    out_len[i] = do_rule(m, ruleno, xs[i], row, result_max, weight,
                         weight_max);
  }
  return 0;
}

}  // extern "C"
