// Fused device-resident EC encode on Hopper (sm_90a), plain C interface for ctypes: GF(2^8)
// encode, shard-body layout and crc32c of every body in ONE pass over the stripes.
//
// Replaces the XLA function ceph_tpu/ops/resident.py::_fused_encode_crc (K5):
//
//   stripes (S, k, C) u8  ->  n = k + r bodies of S*C bytes, body i = chunk i of every stripe
//                             (data chunks copied, parity chunks = the GF(2^8) product through
//                             the (8k, 8r) bit matrix), and out[i] ^= crc32c(0xFFFFFFFF, body i)
//
// with Ceph's crc conventions (seed -1, no final inversion; out must hold zeros on entry).  The
// port's first form of it was two launches: the bit-matmul (csrc/gf_bit_matmul.cu) into an
// (S, r, C) intermediate, then the crc32c kernel's gather mode (csrc/crc32c.cu) reading chunk
// column i of the stripes or of that intermediate into body i while hashing it.  That reads the
// stripes twice and writes and reads back the parity: 1152 MiB at S=8192, k=8, r=4, C=4096
// where one pass needs 640 MiB.  This kernel is that one pass.
//
// Body i is chunk i of every stripe, concatenated, so a contiguous run of the flattened
// (stripe, column) space of the stripes is a contiguous run of every body at once.  A WARP takes
// a run of `ws` bytes of that space (a multiple of kIter) and walks it in iterations of kIter
// bytes; in each, lane l takes the four 16-byte chunks at 512 u + 16 l (u = 0..3), so every
// warp-wide load of a data row and every store to a body covers 512 contiguous bytes.  C is a
// multiple of kIter, so an iteration never straddles two stripes.  Per chunk u the lane:
//
// - loads 16 bytes of each of the k data rows (four rows' loads issued together), stores each
//   into its data body and folds it into that body's crc;
// - forms the r parity chunks by the bit-matmul's nibble tables (for each data row i and byte x,
//   T_i[x] = L_i[x & 15] ^ H_i[x >> 4], one u32 holding four output rows' bytes; one pass per
//   group of four parity rows, as csrc/gf_bit_matmul.cu does for r > 4), transposes them into
//   four 16-byte rows by byte permutes, stores each into its parity body and folds it into that
//   body's crc.
//
// The crc is crc32c.cu's coalesced scheme, one accumulator per body and lane: lane l's chunks
// lie 512 bytes apart, so acc <- M_2048 acc ^ sum_u M_{512 (3 - u)} crc(0, chunk_u) (Horner),
// every term a lookup into 16-entry nibble tables whose chunk advance is folded in.  At the end
// of a run: sum_l M_{16 (31 - l)} acc_l (the lane matrices, then a warp XOR), advanced over the
// runs after it, the seed term M_L 0xFFFFFFFF (computed by the host, L = S*C) on the first run,
// and one atomicXor per body and warp.  Runs are taken as if preceded by zeros up to a whole
// number of runs; L is a multiple of kIter, so the zeros are whole iterations, which a warp
// skips (a register from 0 stays 0 over zeros).
//
// n and k are launch values, so the n accumulators cannot live in registers (registers are not
// indexed at run time).  They live in shared memory, one word per body and lane at a stride of
// the block's threads: conflict-free, 4 loads and 4 stores per body and iteration against the
// 136 lookups of its crc.  Both kinds of lookup are those of the two kernels it merges
// (lookup.cuh), each table at a 256-byte aligned base (checked).
//
// Bound on this card: bytes.  The function must read S*k*C bytes and write n*S*C bytes; at
// S=8192, k=8, r=4, C=4096 (671,088,640 B) that is ~0.200 ms at 3.35 TB/s (H100 SXM).  Against
// it stands the shared-memory pipe, which also serves the 16-byte loads and stores: 2k lookups
// per column for the product (16.8e6 warp wavefronts at that shape) and 136 per 2 KiB and warp
// for the crcs of the 384 MiB of bodies (26.7e6), ~0.17 ms at one wavefront per clock on 132
// SMs at 1.98 GHz; and the integer pipe, which forms the lookups' addresses and XORs their
// results.
//
// The kernel takes C a multiple of kIter, 16-byte aligned stripes and bodies, 2 <= n <= 128
// (body addresses by value, 1 KiB of kernel parameters) and tables that fit in a block's shared
// memory; the caller routes any other shape to the two-launch form (ops/resident.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBodies = 128;
constexpr int kChunks = 4;                    // 16-byte chunks per lane and iteration
constexpr int kIter = 32 * 16 * kChunks;      // bytes of column space per warp and iteration
constexpr int kNib = kChunks * 32 + 8;        // crc nibble tables of 16 words (crc32c.cu)
constexpr int kLane = 32 * 32;                // lane matrices
constexpr int kLanePitch = 33;                // padded: lane l reads column q at bank l + q
constexpr int kTableWords = 32;               // product tables: words per data row and group
constexpr int kRowChunk = 4;                  // data rows whose loads are issued together
constexpr long long kMaxLen = 1LL << 47;      // the advance matrices reach 2^47 bytes

struct Bodies {
  long long ptr[kMaxBodies];
};

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The product of a chunk of up to kRowChunk data rows (lookup_word, lookup.cuh) into acc.
template <int J>
__device__ __forceinline__ void lookup_rows(const uint4* v, int n_rows, uint32_t base,
                                            uint32_t* acc) {
  if constexpr (J < kRowChunk) {
    if (J < n_rows) {
#pragma unroll
      for (int q = 0; q < 4; ++q) lookup_word<J>(word(v[J], q), base, acc + 4 * q);
      lookup_rows<J + 1>(v, n_rows, base, acc);
    }
  }
}

// Store chunk u of a body (at byte d of it) and fold it into the body's accumulator `acc`:
// M_{512 (3 - u)} crc(0, chunk) from the tables of chunk u at `tbu`, and on u == 0 the
// register's advance M_2048 acc (tables kChunks * 32.., at `tb`).
__device__ __forceinline__ void emit(const Bodies& bodies, int body, long long d, const uint4& v,
                                     int u, uint32_t tb, uint32_t tbu, uint32_t* acc) {
  *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(bodies.ptr[body]) + d) = v;
  uint32_t* a = acc + body * kThreads;
  const uint32_t t = nib_word<0>(v.x, tbu) ^ nib_word<8>(v.y, tbu) ^ nib_word<16>(v.z, tbu) ^
                     nib_word<24>(v.w, tbu);
  *a = (u == 0 ? nib_word<kChunks * 32>(*a, tb) : *a) ^ t;
}

// Shared memory, in 32-bit words: the product tables (n_groups x gstride, gstride a multiple
// of 64 words so that every group and every chunk of four rows starts 256-byte aligned), the
// crc nibble tables, the lane matrices, then the accumulators (n x kThreads).
__host__ __device__ __forceinline__ int group_stride(int k) {
  return (k + 1) / 2 * 2 * kTableWords;
}

__host__ __device__ __forceinline__ long long smem_words(int n, int k) {
  return (long long)((n - k + 3) / 4) * group_stride(k) + kNib * 16 + 32 * kLanePitch +
         (long long)n * kThreads;
}

__global__ void __launch_bounds__(kThreads, 2)
fused_encode_crc_kernel(const uint8_t* __restrict__ stripes, const uint32_t* __restrict__ tables,
                        const uint32_t* __restrict__ fast_tables,
                        const uint32_t* __restrict__ adv_cols, const Bodies bodies, int n, int k,
                        long long C, long long length, long long ws, long long runs,
                        uint32_t seed, unsigned int* __restrict__ out) {
  extern __shared__ __align__(256) uint32_t smem[];
  const int r = n - k;
  const int n_groups = (r + 3) / 4;
  const int gstride = group_stride(k);
  uint32_t* ptab = smem;
  uint32_t* nib = ptab + n_groups * gstride;
  uint32_t* lanem = nib + kNib * 16;
  uint32_t* accs = lanem + 32 * kLanePitch;
  for (int t = threadIdx.x; t < n_groups * k * kTableWords; t += kThreads)
    ptab[t / (k * kTableWords) * gstride + t % (k * kTableWords)] = __ldg(tables + t);
  for (int t = threadIdx.x; t < kNib * 16; t += kThreads) nib[t] = __ldg(fast_tables + t);
  for (int t = threadIdx.x; t < kLane; t += kThreads)
    lanem[t / 32 * kLanePitch + t % 32] = __ldg(fast_tables + kNib * 16 + t);
  __syncthreads();
  const uint32_t ptab_s = static_cast<uint32_t>(__cvta_generic_to_shared(ptab));
  const uint32_t tb = static_cast<uint32_t>(__cvta_generic_to_shared(nib));
  if ((ptab_s | tb) & 255u) __trap();           // the byte permutes need the alignment

  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= runs) return;                        // whole warps leave together
  uint32_t* acc = accs + threadIdx.x;           // body b's accumulator at acc[b * kThreads]
  for (int b = 0; b < n; ++b) acc[b * kThreads] = 0u;

  // This run's first iteration; the zeros in front (whole iterations) are skipped.
  long long o = w * ws - (runs * ws - length);
  long long iters = ws / kIter;
  if (o < 0) {
    iters += o / kIter;
    o = 0;
  }
  long long col = o % C;                        // column of the iteration in its stripe
  const uint8_t* src = stripes + (o / C) * k * C + col + 16 * lane;
  long long d = o + 16 * lane;                  // this lane's byte in every body
  for (; iters > 0; --iters) {
#pragma unroll 1
    for (int u = 0; u < kChunks; ++u) {
      const uint32_t tbu = tb + u * 32 * 64;    // chunk u's crc tables
      const uint8_t* p = src + 512 * u;
      const long long du = d + 512 * u;
#pragma unroll 1
      for (int g = 0; g < n_groups; ++g) {
        uint32_t par[16];
#pragma unroll
        for (int v = 0; v < 16; ++v) par[v] = 0u;
        for (int i0 = 0; i0 < k; i0 += kRowChunk) {
          uint4 v[kRowChunk];
#pragma unroll
          for (int j = 0; j < kRowChunk; ++j)
            if (i0 + j < k) v[j] = __ldg(reinterpret_cast<const uint4*>(p + (i0 + j) * C));
          if (g == 0) {
#pragma unroll
            for (int j = 0; j < kRowChunk; ++j)
              if (i0 + j < k) emit(bodies, i0 + j, du, v[j], u, tb, tbu, acc);
          }
          lookup_rows<0>(v, k - i0, ptab_s + 4u * (g * gstride + i0 * kTableWords), par);
        }
        uint32_t rows[4][4];
        transpose(par, rows);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (4 * g + q < r)
            emit(bodies, k + 4 * g + q, du,
                 make_uint4(rows[q][0], rows[q][1], rows[q][2], rows[q][3]), u, tb, tbu, acc);
      }
    }
    src += kIter;
    d += kIter;
    if ((col += kIter) == C) {                  // on to the next stripe
      col = 0;
      src += (long long)(k - 1) * C;
    }
  }

  // The run's crc from 0, per body: sum_l M_{16 (31 - l)} acc_l, a warp XOR.  Lane j keeps body
  // b0 + j's, advances it over the runs after this one and adds it to out.
  for (int b0 = 0; b0 < n; b0 += 32) {
    const int nb = n - b0 < 32 ? n - b0 : 32;
    uint32_t mine = 0u;
    for (int j = 0; j < nb; ++j) {
      const uint32_t x = __reduce_xor_sync(
          0xffffffffu, apply(lanem + lane * kLanePitch, acc[(b0 + j) * kThreads]));
      if (lane == j) mine = x;
    }
    if (lane < nb) {
      long long after = runs - 1 - w;
      for (int b = 0; after; ++b, after >>= 1)
        if (after & 1) mine = apply(adv_cols + b * 32, mine);
      if (w == 0) mine ^= seed;
      atomicXor(out + b0 + lane, mine);
    }
  }
}

}  // namespace

// stripes (S, k, C) u8 contiguous; tables (ceil(r/4), k, 32) u32 from pack_tables
// (ops/gf_pallas.py) for r = n - k parity rows; fast_tables crc32c.cu's coalesced tables (the
// kNib nibble tables, then the lane matrices); adv the 48 x 32 columns of M_{ws * 2^b}; bodies
// a HOST array of n device addresses, each of S*C bytes; seed = M_{S*C} 0xFFFFFFFF; out (n,)
// int32 holding zeros.  ws: bytes per warp run, a multiple of 2048.  Needs C a multiple of 2048,
// 16-byte aligned stripes and bodies, 2 <= n <= 128, k < n.  Launches on `stream` and does not
// synchronise.  Returns the launch's cudaError_t (0 = success).
extern "C" int fused_encode_crc_launch(const void* stripes, const void* tables,
                                       const void* fast_tables, const void* adv,
                                       const long long* bodies, int n, long long S, int k,
                                       long long C, long long ws, unsigned int seed, void* out,
                                       void* stream) {
  if (n < 2 || n > kMaxBodies || k < 1 || k >= n || S < 1 || C < kIter || C % kIter ||
      ws < kIter || ws % kIter || S > kMaxLen / C)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(stripes) % 16) return (int)cudaErrorMisalignedAddress;
  Bodies table{};
  for (int i = 0; i < n; ++i) {
    if (bodies[i] % 16) return (int)cudaErrorMisalignedAddress;
    table.ptr[i] = bodies[i];
  }
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const long long smem = smem_words(n, k) * 4;
  if (smem > optin) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fused_encode_crc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long length = S * C;
  const long long runs = (length + ws - 1) / ws;
  const long long blocks = (runs + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fused_encode_crc_kernel<<<(unsigned)blocks, kThreads, (size_t)smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(stripes), static_cast<const uint32_t*>(tables),
      static_cast<const uint32_t*>(fast_tables), static_cast<const uint32_t*>(adv), table, n, k,
      C, length, ws, runs, seed, static_cast<unsigned int*>(out));
  return (int)cudaGetLastError();
}
