// GF(2^8) bit-matrix product on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel ceph_tpu/ops/gf_pallas.py::_kernel (and serves the
// XLA function ceph_tpu/ops/gf_matmul.py::gf_bit_matmul, same contract):
//
//   data (S, k, C) uint8  x  B (8k, 8r) 0/1  ->  out (S, r, C) uint8
//   out bit (ro*8 + i) of column c = parity( bits(column c) . B[:, ro*8 + i] )
//
// where bits(column c) is the 8k-bit vector of the k data bytes data[s, :, c],
// LSB first per byte.  This equals the GF(2^8) matrix product behind B
// (erasure-code encode with the coding rows, reconstruction with the
// inverted survivor rows).
//
// Design: nibble tables in shared memory.  The product is linear over GF(2)
// in each data byte, for any 0/1 matrix B: with T_i[b] the XOR of the rows
// 8i+t of B over the set bits t of b, output column c is XOR_i
// T_i[data[i, c]], and T_i[b] = L_i[b & 15] ^ H_i[b >> 4].  The host packs L_i
// and H_i once per matrix (ops/gf_pallas.py::pack_tables) for each group of
// four output rows, one u32 per entry holding the four output bytes of a
// column: 128 B per data row and group.  Each block stages its groups'
// tables into shared memory once, then walks a grid-stride loop over
// (stripe, 16-column) items: a thread loads 16 bytes of each data row (one
// 16-byte load, eight rows issued together), does two shared lookups per
// row and column, XORs them, and transposes the sixteen u32 results back
// into four 16-byte output rows with byte permutes.  A 16-entry table spans
// 16 banks and every lane of a warp reads the same table, so each lookup is
// one shared-memory wavefront whatever the data.  Any k <= 256, r >= 1 and
// C >= 1 are taken: groups whose tables do not fit in one block's shared
// memory go to more blocks along grid y, and a ragged tail of columns and
// misaligned rows take byte loads and stores inside the same kernel.
//
// Bound on this card: bytes.  The function must read S*k*C bytes and write
// S*r*C bytes; at 3.35 TB/s (H100 SXM) the main shape S=8192, k=8, r=4,
// C=4096 (402,653,184 B) takes at least ~0.120 ms.  Against it stand two
// pipes.  Shared memory: 2k lookups per column, 16.8e6 warp wavefronts at
// that shape, ~0.064 ms at one wavefront per clock on 132 SMs at 1.98 GHz.
// The integer pipe, 64 lanes per SM: per row and column two byte permutes
// that each yield a lookup's whole shared address (below), one three-way
// XOR and a share of the nibble masks, about 4 operations, 1.07e9 at that
// shape, ~0.064 ms.  An address add per lookup would make that 6 and the
// integer pipe the bound, which is why the addresses are built by the
// permutes.  The popcount pipe of the first design (below) is off the path,
// and at 80 registers three blocks stay resident per SM, enough 16-byte
// loads in flight to keep memory busy.
//
// The first design stays as gf_bit_matmul_popc_launch, reached only by the
// chip smoke's A/B: one thread per VEC byte columns gathers each column's k
// bytes into ceil(k/8) u64 words and forms every output bit as
// popc(XOR_w vec[w] & mask[j][w]) & 1, which at k=8, r=4 costs 32 __popcll
// per column and bounds it on the popcount pipe.
//
// gfw_bit_matmul_launch is K3, the GF(2^w) word layout of jerasure's reed_sol
// codes at w = 16 and 32 (replaces the XLA function
// ceph_tpu/ops/gf_matmul.py::gfw_bit_matmul):
//
//   data (S, k, C) uint8 read as little-endian w-bit words  x  B (k*w, r*w) 0/1
//     ->  out (S, r, C) uint8, the same words
//
// With ws = w/8, bit 8b + i of word j is row j*w + 8b + i = 8(j*ws + b) + i of B,
// so K3 is K1's product over a virtual byte layout: virtual data row j*ws + b
// is byte b of every word of row j (bytes b, b + ws, b + 2ws, ...), and the
// output's virtual rows interleave the same way.  The host's pack_tables is
// unchanged (k' = k*ws virtual rows, r' = r*ws); only the addressing differs.
// A thread takes 16 words of each data row (ws 16-byte loads), splits them
// into ws virtual 16-byte rows with byte permutes, runs K1's lookups over the
// virtual rows, and joins each group's four virtual output rows back into
// 4/ws real rows of 16 words (at w = 32 a group is one output row as it
// stands).  Bound and pipes as K1: at k=4, m=2, w=16 the bytes per lookup are
// K1's at k=8, m=4; at w=32 each word column needs twice the lookups.  Tails
// (C not a multiple of 16 words, a multiple of ws) and misaligned pointers
// take byte loads and stores in the same kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup.cuh"

typedef unsigned long long u64;

namespace {

constexpr int kThreads = 256;

template <int VEC>
struct Bytes {
  static constexpr int NQ = (VEC + 3) / 4;
  uint32_t q[NQ];
  __device__ __forceinline__ uint32_t get(int v) const {
    return (q[v / 4] >> ((v % 4) * 8)) & 0xffu;
  }
};

// Load VEC bytes at p.  `full` means all VEC bytes lie inside the row and p is
// VEC-aligned, so one vector load serves; otherwise n_valid bytes are loaded
// one at a time and the rest read as zero.
template <int VEC>
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ p, int n_valid,
                                           bool full, Bytes<VEC>& b) {
  if (full) {
    if constexpr (VEC == 16) {
      uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
      b.q[0] = t.x; b.q[1] = t.y; b.q[2] = t.z; b.q[3] = t.w;
      return;
    } else if constexpr (VEC == 8) {
      uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      b.q[0] = t.x; b.q[1] = t.y;
      return;
    } else if constexpr (VEC == 4) {
      b.q[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < Bytes<VEC>::NQ; ++i) b.q[i] = 0;
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    if (v < n_valid) b.q[v / 4] |= uint32_t(__ldg(p + v)) << ((v % 4) * 8);
}

template <int VEC>
__device__ __forceinline__ void store_bytes(uint8_t* __restrict__ p, int n_valid,
                                            bool full, const Bytes<VEC>& b) {
  if (full) {
    if constexpr (VEC == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(b.q[0], b.q[1], b.q[2], b.q[3]);
      return;
    } else if constexpr (VEC == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(b.q[0], b.q[1]);
      return;
    } else if constexpr (VEC == 4) {
      *reinterpret_cast<unsigned int*>(p) = b.q[0];
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    if (v < n_valid) p[v] = uint8_t(b.get(v));
}

// First design.  W: 64-bit words per column vector (exact for W <= 4; W = 32
// serves any k <= 256 with nw = ceil(k/8) words live).  VEC: byte columns
// per thread.
template <int W, int VEC>
__global__ void __launch_bounds__(kThreads)
gf_popc_kernel(const uint8_t* __restrict__ data, const u64* __restrict__ masks,
               uint8_t* __restrict__ out, long long S, int k, int r, long long C, int nw,
               bool aligned) {
  const long long groups = (C + VEC - 1) / VEC;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= S * groups) return;
  const long long s = tid / groups;
  const long long col0 = (tid - s * groups) * VEC;
  const int n_valid = (int)(C - col0 < VEC ? C - col0 : VEC);
  const bool full = aligned && n_valid == VEC;

  // gather: vec[v][w] byte cb = data[s, w*8 + cb, col0 + v]
  u64 vec[VEC][W];
#pragma unroll
  for (int v = 0; v < VEC; ++v)
#pragma unroll
    for (int w = 0; w < W; ++w) vec[v][w] = 0ull;
  const uint8_t* src = data + (s * k) * C + col0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
#pragma unroll
    for (int cb = 0; cb < 8; ++cb) {
      const int c = w * 8 + cb;
      if (c < k) {
        Bytes<VEC> b;
        load_bytes<VEC>(src + (long long)c * C, n_valid, full, b);
#pragma unroll
        for (int v = 0; v < VEC; ++v) vec[v][w] |= u64(b.get(v)) << (cb * 8);
      }
    }
  }

  uint8_t* dst = out + (s * r) * C + col0;
  for (int ro = 0; ro < r; ++ro) {
    Bytes<VEC> ob;
#pragma unroll
    for (int i = 0; i < Bytes<VEC>::NQ; ++i) ob.q[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const u64* mj = masks + (long long)(ro * 8 + i) * nw;
      u64 m[W];
#pragma unroll
      for (int w = 0; w < W; ++w) m[w] = (w < nw) ? __ldg(mj + w) : 0ull;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        u64 x = 0ull;
#pragma unroll
        for (int w = 0; w < W; ++w) x ^= vec[v][w] & m[w];
        ob.q[v / 4] |= uint32_t(__popcll(x) & 1) << ((v % 4) * 8 + i);
      }
    }
    store_bytes<VEC>(dst + (long long)ro * C, n_valid, full, ob);
  }
}

template <int W, int VEC>
cudaError_t launch_popc(const uint8_t* data, const u64* masks, uint8_t* out, long long S,
                        int k, int r, long long C, int nw, cudaStream_t stream) {
  const bool aligned = (C % VEC == 0) && (reinterpret_cast<uintptr_t>(data) % VEC == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % VEC == 0);
  const long long threads = S * ((C + VEC - 1) / VEC);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gf_popc_kernel<W, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      data, masks, out, S, k, r, C, nw, aligned);
  return cudaGetLastError();
}

// Nibble-table design.  tables: (n_groups, k, 32) u32; entry [g][i][n] is
// L_i[n] and [g][i][16 + n] is H_i[n], each on output rows 4g..4g+3
// (bit 8q + b of an entry is bit b of output row 4g + q).  In shared memory
// row i's 128 B sit at 128 i from its group's base, and each group's base is
// 256-B aligned, so the base of every chunk of eight rows has a zero low
// byte: one byte permute then writes a lookup's index (nibble * 4) into it
// and yields the shared address, and the row within the chunk and L/H go
// into the load's immediate offset (lookup_word, lookup.cuh).
constexpr int kVec = 16;       // byte columns per thread: one 16-byte load a row
constexpr int kRowChunk = 8;   // data rows whose loads are issued together
constexpr int kTableWords = 32;

template <int J>
__device__ __forceinline__ void lookup_rows(const Bytes<kVec>* w, int n_rows, uint32_t base,
                                            uint32_t* acc) {
  if constexpr (J < kRowChunk) {
    if (J < n_rows) {
#pragma unroll
      for (int q = 0; q < 4; ++q) lookup_word<J>(w[J].q[q], base, acc + 4 * q);
      lookup_rows<J + 1>(w, n_rows, base, acc);
    }
  }
}

// At most 80 registers: three blocks of 256 threads stay resident per SM.
__global__ void __launch_bounds__(kThreads, 3)
gf_nibble_kernel(const uint8_t* __restrict__ data, const uint32_t* __restrict__ tables,
                 uint8_t* __restrict__ out, long long S, int k, int r, long long C,
                 int n_groups, int chunk_groups, bool aligned) {
  extern __shared__ __align__(256) uint32_t tab[];   // (groups of this block, gstride)
  const int gstride = (k + 1) / 2 * 2 * kTableWords;   // words, a multiple of 256 B
  const int g0 = blockIdx.y * chunk_groups;
  const int ng = min(chunk_groups, n_groups - g0);
  const uint32_t* tsrc = tables + (long long)g0 * k * kTableWords;
  for (int t = threadIdx.x; t < ng * k * kTableWords; t += kThreads)
    tab[t / (k * kTableWords) * gstride + t % (k * kTableWords)] = __ldg(tsrc + t);
  __syncthreads();
  const uint32_t tab_s = static_cast<uint32_t>(__cvta_generic_to_shared(tab));

  const long long per_s = (C + kVec - 1) / kVec;   // 16-column items per stripe
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (first >= S * per_s) return;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long ds = stride / per_s, dcg = stride - ds * per_s;
  long long s = first / per_s, cg = first - s * per_s;
  while (s < S) {
    const long long col0 = cg * kVec;
    const int n_valid = (int)(C - col0 < kVec ? C - col0 : kVec);
    const bool full = aligned && n_valid == kVec;
    const uint8_t* src = data + s * k * C + col0;
    for (int gl = 0; gl < ng; ++gl) {
      uint32_t acc[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[v] = 0u;
      for (int i0 = 0; i0 < k; i0 += kRowChunk) {
        Bytes<kVec> w[kRowChunk];
#pragma unroll
        for (int j = 0; j < kRowChunk; ++j)
          if (i0 + j < k) load_bytes<kVec>(src + (long long)(i0 + j) * C, n_valid, full, w[j]);
        lookup_rows<0>(w, k - i0, tab_s + 4u * (gl * gstride + i0 * kTableWords), acc);
      }
      // transpose: byte q of acc[4c + b] is byte b of word c of output row q
      uint32_t t[4][4];
      transpose(acc, t);
      Bytes<kVec> o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[q].q[c] = t[q][c];
      const int row0 = 4 * (g0 + gl);
      uint8_t* dst = out + (s * r + row0) * C + col0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (row0 + q < r) store_bytes<kVec>(dst + (long long)q * C, n_valid, full, o[q]);
    }
    cg += dcg;
    s += ds;
    if (cg >= per_s) { cg -= per_s; ++s; }
  }
}

cudaError_t launch_nibble(const uint8_t* data, const uint32_t* tables, uint8_t* out,
                          long long S, int k, int r, long long C, cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int n_groups = (r + 3) / 4;
  const int group_bytes = (k + 1) / 2 * 2 * kTableWords * (int)sizeof(uint32_t);
  const int chunk = n_groups < optin / group_bytes ? n_groups : optin / group_bytes;
  const int n_chunks = (n_groups + chunk - 1) / chunk;
  if (chunk < 1 || n_chunks > 65535) return cudaErrorInvalidConfiguration;
  const int smem = chunk * group_bytes;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(gf_nibble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gf_nibble_kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items = S * ((C + kVec - 1) / kVec);
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  const bool aligned = (C % kVec == 0) && (reinterpret_cast<uintptr_t>(data) % kVec == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % kVec == 0);
  gf_nibble_kernel<<<dim3((unsigned)blocks, (unsigned)n_chunks), kThreads, smem, stream>>>(
      data, tables, out, S, k, r, C, n_groups, chunk, aligned);
  return cudaGetLastError();
}

// K3.  Load 16 words (16 WS bytes) of one data row at p and split them into WS
// virtual rows: byte u of v[b].q[c] is byte b of word 4c + u.  `full` as in
// load_bytes; otherwise n_valid bytes are read one at a time, the rest zero.
template <int WS>
__device__ __forceinline__ void load_words(const uint8_t* __restrict__ p, int n_valid, bool full,
                                           Bytes<kVec>* v) {
  uint32_t x[4 * WS];
  if (full) {
#pragma unroll
    for (int h = 0; h < WS; ++h) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + h);
      x[4 * h] = t.x; x[4 * h + 1] = t.y; x[4 * h + 2] = t.z; x[4 * h + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * WS; ++i) x[i] = 0u;
#pragma unroll
    for (int b = 0; b < 16 * WS; ++b)
      if (b < n_valid) x[b / 4] |= uint32_t(__ldg(p + b)) << ((b % 4) * 8);
  }
  if constexpr (WS == 2) {        // word t is bytes 0-1 or 2-3 of x[t / 2]
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[0].q[c] = __byte_perm(x[2 * c], x[2 * c + 1], 0x6420);
      v[1].q[c] = __byte_perm(x[2 * c], x[2 * c + 1], 0x7531);
    }
  } else {                        // word t is x[t]: a 4x4 byte transpose per 4 words
    uint32_t t[4][4];
    transpose(x, t);
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[b].q[c] = t[b][c];
  }
}

// K3.  Store a group's products: byte u of acc[v] is virtual output row 4g + u, i.e.
// byte (4g + u) % WS of word v of real row (4g + u) / WS.  `rows` real rows remain.
template <int WS>
__device__ __forceinline__ void store_words(const uint32_t* acc, uint8_t* __restrict__ dst,
                                            int rows, long long C, int n_valid, bool full) {
#pragma unroll
  for (int t = 0; t < 4 / WS; ++t) {
    if (t >= rows) return;
    uint32_t o[4 * WS];
    if constexpr (WS == 4) {      // the group is one output row as it stands
#pragma unroll
      for (int c = 0; c < 16; ++c) o[c] = acc[c];
    } else {                      // words 2c, 2c + 1: bytes 2t, 2t + 1 of acc[2c], acc[2c + 1]
#pragma unroll
      for (int c = 0; c < 8; ++c)
        o[c] = __byte_perm(acc[2 * c], acc[2 * c + 1], t ? 0x7632 : 0x5410);
    }
    uint8_t* p = dst + (long long)t * C;
    if (full) {
#pragma unroll
      for (int h = 0; h < WS; ++h)
        reinterpret_cast<uint4*>(p)[h] = make_uint4(o[4 * h], o[4 * h + 1], o[4 * h + 2],
                                                    o[4 * h + 3]);
    } else {
#pragma unroll
      for (int b = 0; b < 16 * WS; ++b)
        if (b < n_valid) p[b] = uint8_t(o[b / 4] >> ((b % 4) * 8));
    }
  }
}

// K3.  tables: (n_groups, k WS, 32) u32 from pack_tables of the (k w, r w) matrix, laid
// out in shared memory as in gf_nibble_kernel.  An item is 16 words of one stripe;
// a chunk of kRowChunk virtual rows is kRowChunk / WS real rows, so every chunk's
// table base keeps a zero low byte.  At most 128 registers: two blocks per SM.
template <int WS>
__global__ void __launch_bounds__(kThreads, 2)
gfw_nibble_kernel(const uint8_t* __restrict__ data, const uint32_t* __restrict__ tables,
                  uint8_t* __restrict__ out, long long S, int k, int r, long long C,
                  int n_groups, int chunk_groups, bool aligned) {
  constexpr int kBytes = kVec * WS;            // bytes of a row per item
  constexpr int kRealChunk = kRowChunk / WS;   // real data rows per chunk
  extern __shared__ __align__(256) uint32_t tab[];
  const int kv = k * WS;                       // virtual data rows
  const int gstride = (kv + 1) / 2 * 2 * kTableWords;
  const int g0 = blockIdx.y * chunk_groups;
  const int ng = min(chunk_groups, n_groups - g0);
  const uint32_t* tsrc = tables + (long long)g0 * kv * kTableWords;
  for (int t = threadIdx.x; t < ng * kv * kTableWords; t += kThreads)
    tab[t / (kv * kTableWords) * gstride + t % (kv * kTableWords)] = __ldg(tsrc + t);
  __syncthreads();
  const uint32_t tab_s = static_cast<uint32_t>(__cvta_generic_to_shared(tab));

  const long long per_s = (C + kBytes - 1) / kBytes;   // items per stripe
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (first >= S * per_s) return;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long ds = stride / per_s, dcg = stride - ds * per_s;
  long long s = first / per_s, cg = first - s * per_s;
  while (s < S) {
    const long long col0 = cg * kBytes;
    const int n_valid = (int)(C - col0 < kBytes ? C - col0 : kBytes);
    const bool full = aligned && n_valid == kBytes;
    const uint8_t* src = data + s * k * C + col0;
    for (int gl = 0; gl < ng; ++gl) {
      uint32_t acc[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[v] = 0u;
      for (int i0 = 0; i0 < k; i0 += kRealChunk) {
        Bytes<kVec> w[kRowChunk];
#pragma unroll
        for (int j = 0; j < kRealChunk; ++j)
          if (i0 + j < k) load_words<WS>(src + (long long)(i0 + j) * C, n_valid, full, w + j * WS);
        lookup_rows<0>(w, (k - i0) * WS, tab_s + 4u * (gl * gstride + i0 * WS * kTableWords),
                       acc);
      }
      const int row0 = (g0 + gl) * 4 / WS;
      store_words<WS>(acc, out + (s * r + row0) * C + col0, r - row0, C, n_valid, full);
    }
    cg += dcg;
    s += ds;
    if (cg >= per_s) { cg -= per_s; ++s; }
  }
}

template <int WS>
cudaError_t launch_words(const uint8_t* data, const uint32_t* tables, uint8_t* out,
                         long long S, int k, int r, long long C, cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int kv = k * WS;
  const int n_groups = (r * WS + 3) / 4;
  const int group_bytes = (kv + 1) / 2 * 2 * kTableWords * (int)sizeof(uint32_t);
  const int chunk = n_groups < optin / group_bytes ? n_groups : optin / group_bytes;
  const int n_chunks = chunk < 1 ? 0 : (n_groups + chunk - 1) / chunk;
  if (chunk < 1 || n_chunks > 65535) return cudaErrorInvalidConfiguration;
  const int smem = chunk * group_bytes;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(gfw_nibble_kernel<WS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gfw_nibble_kernel<WS>, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items = S * ((C + kVec * WS - 1) / (kVec * WS));
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  const bool aligned = (C % kVec == 0) && (reinterpret_cast<uintptr_t>(data) % kVec == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % kVec == 0);
  gfw_nibble_kernel<WS><<<dim3((unsigned)blocks, (unsigned)n_chunks), kThreads, smem, stream>>>(
      data, tables, out, S, k, r, C, n_groups, chunk, aligned);
  return cudaGetLastError();
}

}  // namespace

// data (S, k, C) u8, tables (ceil(r/4), k, 32) u32 from pack_tables, out
// (S, r, C) u8, all contiguous on the current device.  Launches on `stream`
// and does not synchronise.  Returns the launch's cudaError_t (0 = success).
extern "C" int gf_bit_matmul_launch(const void* data, const void* tables, void* out,
                                    long long S, int k, int r, long long C, void* stream) {
  if (S < 0 || C < 0 || k < 1 || k > 256 || r < 1) return (int)cudaErrorInvalidValue;
  if (S == 0 || C == 0) return (int)cudaSuccess;
  return (int)launch_nibble(static_cast<const uint8_t*>(data),
                            static_cast<const uint32_t*>(tables), static_cast<uint8_t*>(out),
                            S, k, r, C, static_cast<cudaStream_t>(stream));
}

// K3: data (S, k, C) u8 of LE words of ws = w/8 bytes (ws 2 or 4, C % ws == 0),
// tables (ceil(r ws / 4), k ws, 32) u32 from pack_tables of the (k w, r w) matrix,
// out (S, r, C) u8, all contiguous on the current device; k ws <= 256.  Launches on
// `stream` and does not synchronise.  Returns the launch's cudaError_t.
extern "C" int gfw_bit_matmul_launch(const void* data, const void* tables, void* out,
                                     long long S, int k, int r, long long C, int ws,
                                     void* stream) {
  if (S < 0 || C < 0 || k < 1 || r < 1 || (ws != 2 && ws != 4) || k * ws > 256 || C % ws)
    return (int)cudaErrorInvalidValue;
  if (S == 0 || C == 0) return (int)cudaSuccess;
  const uint8_t* d = static_cast<const uint8_t*>(data);
  const uint32_t* t = static_cast<const uint32_t*>(tables);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(ws == 2 ? launch_words<2>(d, t, o, S, k, r, C, st)
                       : launch_words<4>(d, t, o, S, k, r, C, st));
}

// The first design, for the A/B only: masks (8r, nw) u64 with nw = ceil(k/8)
// from pack_masks, otherwise as above.
extern "C" int gf_bit_matmul_popc_launch(const void* data, const void* masks, void* out,
                                              long long S, int k, int r, long long C, int nw,
                                         void* stream) {
  if (S < 0 || C < 0 || k < 1 || k > 256 || r < 1 || nw != (k + 7) / 8)
    return (int)cudaErrorInvalidValue;
  if (S == 0 || C == 0) return (int)cudaSuccess;
  const uint8_t* d = static_cast<const uint8_t*>(data);
  const u64* mk = static_cast<const u64*>(masks);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nw) {
    case 1: return (int)launch_popc<1, 16>(d, mk, o, S, k, r, C, nw, st);
    case 2: return (int)launch_popc<2, 8>(d, mk, o, S, k, r, C, nw, st);
    case 3: return (int)launch_popc<3, 4>(d, mk, o, S, k, r, C, nw, st);
    case 4: return (int)launch_popc<4, 4>(d, mk, o, S, k, r, C, nw, st);
    default: return (int)launch_popc<32, 1>(d, mk, o, S, k, r, C, nw, st);
  }
}
