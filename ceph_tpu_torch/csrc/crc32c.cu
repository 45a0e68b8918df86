// crc32c (Castagnoli) of many byte rows on Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the XLA function ceph_tpu/ops/crc32c_device.py::_crc_one (with crc_core, _crc_batch,
// _crc_dev_one and crc32c_device_padded around it), Ceph's convention: register seeded with
// 0xFFFFFFFF, raw table updates, no final inversion, so an empty row gives 0xFFFFFFFF.
//
//   rows: n rows of L_i bytes  ->  out[i] = crc32c(0xFFFFFFFF, row i)   (u32 bits in an int32)
//
// and, for the two-launch form of the fused resident encode (ops/resident.py, at the shapes the
// one-pass kernel csrc/fused_encode_crc.cu does not take), the same while copying each row out:
// a row there is S pieces of C bytes at a pitch (chunk i of every stripe), gathered into one
// contiguous body as it is hashed, so the layout costs no pass of its own.
//
// The JAX form walks each row in one sequential loop (slicing-by-8 over 8-byte words, then a
// byte tail).  One thread per row would walk a 32 MiB shard body alone, some 4M dependent steps.
// This kernel cuts the chain instead, by the linearity of the CRC over GF(2):
//
//   crc(c, A || B) = crc(0, B) ^ M_|B| crc(c, A)
//
// where M_L is the 32x32 GF(2) matrix that advances the register over L zero bytes (host-built
// columns, ops/crc32c_device.py).  Pieces of a row are hashed apart and combined by advancing
// each over the bytes after it and XORing: within a warp by shuffles, across warps by one
// atomicXor per warp into the zeroed output.  XOR is commutative, so the result does not depend
// on the order the atomics land in.  Two paths, chosen per launch by the caller:
//
// - Coalesced (rows 16-byte aligned, lengths multiples of 16, pieces multiples of 2048): a warp
//   takes a run of bytes and its lanes interleave over it in 16-byte chunks, so every load and
//   store covers 512 contiguous bytes, and every lookup goes to a 16-entry nibble table, one
//   shared-memory wavefront whatever the data (see crc32c_coalesced_kernel).  This is the path
//   of the shard bodies and of the device verify.
// - Per-thread segments (everything else: any alignment, any length, per-row lengths): each
//   row is cut into segments of `seg` bytes aligned to its END, so every segment but the first
//   is whole; one thread per segment runs slicing-by-8 with byte tables in shared memory (the
//   first segment from the seed, the others from 0, a head and a tail of up to 15 bytes a byte
//   at a time) and advances its value by M_{seg * 2^b} for the set bits b of the number of
//   whole segments after it.  A row's threads share a warp, or own whole warps beyond 32
//   segments.
//
// Bound on this card: bytes.  Every input byte is read once (and written once when copied)
// and 4 B are written per row, so 12 bodies of 32 MiB (402,653,184 B) take at least ~0.120 ms
// at 3.35 TB/s (H100 SXM).  Against it stands shared memory: the coalesced path does 2 nibble
// lookups per byte plus the register's advance, 136 one-wavefront lookups per 2 KiB and warp,
// ~0.10 ms at that shape on 132 SMs at 1.98 GHz, on the pipe that also serves the loads.  The
// per-thread path's byte tables meet ~3.5-way bank conflicts at random indices (~0.17 ms at
// that shape) and its lanes read 32 segments 4 KiB apart, 32 cache lines per warp-wide load;
// its copies store 16 bytes into 32 lines at a time, which is why rows of pieces take the
// coalesced path wherever they can.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAdv = 48;                      // advance matrices M_{seg * 2^b}, b < kAdv
constexpr long long kMaxLen = 1LL << 47;
constexpr int kTableRows = 128;               // rows whose addresses one launch takes by value

// ---- the per-thread path --------------------------------------------------------------------
// t: the eight slicing tables, 256 words each, table k at t + 256 k.
__device__ __forceinline__ uint32_t byte_step(uint32_t c, uint32_t b, const uint32_t* t) {
  return t[(c ^ b) & 0xffu] ^ (c >> 8);
}

// Eight bytes, little endian in lo (bytes 0..3) and hi (bytes 4..7); table k advances k+1 bytes.
__device__ __forceinline__ uint32_t word_step(uint32_t c, uint32_t lo, uint32_t hi,
                                              const uint32_t* t) {
  lo ^= c;
  return t[7 * 256 + (lo & 0xffu)] ^ t[6 * 256 + ((lo >> 8) & 0xffu)] ^
         t[5 * 256 + ((lo >> 16) & 0xffu)] ^ t[4 * 256 + (lo >> 24)] ^
         t[3 * 256 + (hi & 0xffu)] ^ t[2 * 256 + ((hi >> 8) & 0xffu)] ^
         t[1 * 256 + ((hi >> 16) & 0xffu)] ^ t[hi >> 24];
}

__device__ __forceinline__ void store_bytes16(uint8_t* d, const uint4& w) {
  const uint32_t q[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = uint8_t(q[i / 4] >> (8 * (i % 4)));
}

// Raw CRC of len bytes at p, continued from register c; with COPY the bytes also go to d.
template <bool COPY>
__device__ uint32_t crc_run(const uint8_t* __restrict__ p, uint8_t* __restrict__ d,
                            long long len, uint32_t c, const uint32_t* t) {
  for (; len > 0 && (reinterpret_cast<uintptr_t>(p) & 15u); --len, ++p) {
    const uint8_t b = __ldg(p);
    if (COPY) *d++ = b;
    c = byte_step(c, b, t);
  }
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const long long n16 = len >> 4;
  const bool vec = COPY && (reinterpret_cast<uintptr_t>(d) & 15u) == 0;
#pragma unroll 4
  for (long long i = 0; i < n16; ++i) {
    const uint4 w = __ldg(q + i);
    if (COPY) {
      if (vec)
        reinterpret_cast<uint4*>(d)[i] = w;
      else
        store_bytes16(d + 16 * i, w);
    }
    c = word_step(c, w.x, w.y, t);
    c = word_step(c, w.z, w.w, t);
  }
  p += n16 << 4;
  if (COPY) d += n16 << 4;
  for (len -= n16 << 4; len > 0; --len, ++p) {
    const uint8_t b = __ldg(p);
    if (COPY) *d++ = b;
    c = byte_step(c, b, t);
  }
  return c;
}

// Rows given by address, passed by value so that rows in separate allocations need no copy
// of their addresses to the card (3 KiB of the 4 KiB of kernel parameters).  Row i is read
// from src[i], its piece s (of seg bytes) at src[i] + s * pitch[i]; pitch == seg is a
// contiguous row of any length.  With COPY its bytes are written to dst[i], contiguous.
struct RowTable {
  long long src[kTableRows];
  long long dst[kTableRows];
  long long pitch[kTableRows];
};

// One thread per (row, segment slot); `slots` per row is a power of two <= 32 or a multiple
// of 32.  Without use_table, row i is contiguous at base + i * stride.
template <bool COPY>
__global__ void __launch_bounds__(kThreads)
crc32c_kernel(const RowTable rows, bool use_table, const uint8_t* __restrict__ base,
              long long stride, const long long* __restrict__ lengths, long long length,
              long long seg, int n, int slots, const uint32_t* __restrict__ tables,
              const uint32_t* __restrict__ adv_cols, unsigned int* __restrict__ out) {
  __shared__ uint32_t t[8 * 256];
  __shared__ uint32_t adv[kAdv][32];
  for (int i = threadIdx.x; i < 8 * 256; i += kThreads) t[i] = __ldg(tables + i);
  for (int i = threadIdx.x; i < kAdv * 32; i += kThreads) (&adv[0][0])[i] = __ldg(adv_cols + i);
  __syncthreads();

  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = gid / slots;
  const long long j = gid - row * slots;
  uint32_t v = 0u;
  if (row < n) {
    const long long L = lengths ? lengths[row] : length;
    const long long nseg = L > 0 ? (L + seg - 1) / seg : 1;
    if (j < nseg) {
      const long long l0 = L - (nseg - 1) * seg;                // the first segment's bytes
      const long long start = j == 0 ? 0 : l0 + (j - 1) * seg;  // its place in the row
      const uint8_t* p;
      uint8_t* d = nullptr;
      if (use_table) {
        const long long pitch = rows.pitch[row];
        p = reinterpret_cast<const uint8_t*>(rows.src[row]) + (pitch == seg ? start : j * pitch);
        if (COPY) d = reinterpret_cast<uint8_t*>(rows.dst[row]) + start;
      } else {
        p = base + row * stride + start;
      }
      v = crc_run<COPY>(p, d, j == 0 ? l0 : seg, j == 0 ? 0xffffffffu : 0u, t);
      long long r = nseg - 1 - j;                               // whole segments after this one
      for (int b = 0; r; ++b, r >>= 1)
        if (r & 1) v = apply(adv[b], v);
    }
  }
  const int group = slots < 32 ? slots : 32;
  for (int o = 1; o < group; o <<= 1) v ^= __shfl_xor_sync(0xffffffffu, v, o);
  if (row < n && (threadIdx.x & (group - 1)) == 0) atomicXor(out + row, v);
}

// ---- the coalesced path ---------------------------------------------------------------------
// Where every row starts 16-byte aligned and its length is a multiple of 16 (and, for rows of
// pieces, the piece a multiple of kIter with aligned pitches), a WARP takes a run of `ws` bytes
// (a multiple of kIter) and its lanes interleave over it: in iteration i, lane l takes the four
// 16-byte chunks at i * kIter + 512 u + 16 l (u = 0..3), so every warp-wide load and store
// covers 512 contiguous bytes.  Lane l's chunks lie 512 bytes apart, so it keeps
//   acc_l = sum over its chunks of M_{512 * (chunks after it)} crc(0, chunk)
// by Horner, four chunks at a time: acc <- M_2048 acc ^ sum_u M_{512 (3 - u)} crc(0, chunk_u).
// Every term is a table lookup: crc(0, chunk) is the XOR over its 16 bytes of T_{15-p}[byte p]
// (T_k advances k+1 bytes), and the tables for chunk u carry its M_{512 (3 - u)} already; the
// register's advance M_2048 is eight more lookups.  The tables are NIBBLE tables (16 entries,
// the low and the high nibble of each byte looked up apart): a 16-entry table spans 16 banks,
// so every warp-wide lookup is one shared-memory wavefront whatever the data, where a byte table
// would meet ~3.5-way bank conflicts.  Only the eight register lookups depend on the previous
// iteration.  The run's CRC from 0 is then sum_l M_{16 * (31 - l)} acc_l (a per-lane matrix,
// then a warp XOR), advanced over the runs after it as above.  Rows are taken as if preceded by
// zeros up to a whole number of runs: zeros in front do not move a CRC from register 0, and the
// seed enters once per row as M_L 0xFFFFFFFF.
constexpr int kChunks = 4;                    // 16-byte chunks per lane and iteration
constexpr int kIter = 32 * 16 * kChunks;      // bytes per warp and iteration
constexpr int kNib = kChunks * 32 + 8;        // nibble tables of 16 words
constexpr int kLane = 32 * 32;

// fast_tables: the kNib nibble tables (table u * 32 + 2 p + h: chunk u, byte p, h = 0 for the
// low nibble and 1 for the high one; table kChunks * 32 + q: nibble q of the register, through
// M_2048), then the 32 lane matrices M_{16 * (31 - l)} (32 x 32), then the 48 matrices M_{2^e}
// (48 x 32) for the seed.  In shared memory table k sits at base + 64 k with base 256-byte
// aligned, so one byte permute writes a lookup's index (nibble * 4) into the base's low byte and
// the table goes into the load's immediate offset (nib_word, lookup.cuh).

// M_{512 (3 - U)} crc(0, chunk) for chunk U of an iteration.
template <int U>
__device__ __forceinline__ uint32_t chunk_crc(const uint4& v, uint32_t base) {
  return nib_word<U * 32>(v.x, base) ^ nib_word<U * 32 + 8>(v.y, base) ^
         nib_word<U * 32 + 16>(v.z, base) ^ nib_word<U * 32 + 24>(v.w, base);
}

template <bool COPY>
__global__ void __launch_bounds__(kThreads)
crc32c_coalesced_kernel(const RowTable rows, bool use_table, const uint8_t* __restrict__ base,
                        long long stride, long long length, long long piece, long long ws,
                        int n, int runs, const uint32_t* __restrict__ adv_cols,
                        const uint32_t* __restrict__ fast_tables, unsigned int* __restrict__ out) {
  __shared__ __align__(256) uint32_t nib[kNib * 16];
  __shared__ uint32_t lanem[32][33];          // padded: lane l reads column q at bank l + q
  __shared__ uint32_t adv[kAdv][32];
  for (int i = threadIdx.x; i < kNib * 16; i += kThreads) nib[i] = __ldg(fast_tables + i);
  for (int i = threadIdx.x; i < kLane; i += kThreads)
    lanem[i / 32][i % 32] = __ldg(fast_tables + kNib * 16 + i);
  for (int i = threadIdx.x; i < kAdv * 32; i += kThreads) (&adv[0][0])[i] = __ldg(adv_cols + i);
  __syncthreads();
  const uint32_t tb = static_cast<uint32_t>(__cvta_generic_to_shared(nib));
  if (tb & 255u) __trap();                    // the byte permutes need the alignment

  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  const long long row = warp / runs;
  if (row >= n) return;                       // whole warps leave together
  const long long w = warp - row * runs;
  const long long z = (long long)runs * ws - length;   // virtual zeros in front
  const uint8_t* src = use_table ? reinterpret_cast<const uint8_t*>(rows.src[row])
                                 : base + row * stride;
  const long long pitch = use_table ? rows.pitch[row] : 0;
  uint8_t* dst = COPY ? reinterpret_cast<uint8_t*>(rows.dst[row]) : nullptr;

  long long o = w * ws - z;                   // real offset of this iteration (< 0: zeros)
  long long pidx = 0, within = 0;             // its piece and place in it (rows of pieces)
  if (piece && o > 0) {
    pidx = o / piece;
    within = o - pidx * piece;
  }
  uint32_t acc = 0u;
  for (long long i = 0; i < ws / kIter; ++i) {
    // chunks before the row's start are the zeros in front (the first run of a row of pieces
    // starts them at a whole iteration; a contiguous row at any multiple of 16)
    uint4 v[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const long long co = o + 512 * u + 16 * lane;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (co >= 0) {
        const long long at = piece ? pidx * pitch + within + 512 * u + 16 * lane : co;
        v[u] = __ldg(reinterpret_cast<const uint4*>(src + at));
        if (COPY) *reinterpret_cast<uint4*>(dst + co) = v[u];
      }
    }
    acc = nib_word<kChunks * 32>(acc, tb) ^ chunk_crc<0>(v[0], tb) ^ chunk_crc<1>(v[1], tb) ^
          chunk_crc<2>(v[2], tb) ^ chunk_crc<3>(v[3], tb);
    o += kIter;
    if (piece && o > 0 && (within += kIter) == piece) {
      within = 0;
      ++pidx;
    }
  }
  uint32_t x = apply(lanem[lane], acc);
  x = __reduce_xor_sync(0xffffffffu, x);
  if (lane == 0) {
    long long r = runs - 1 - w;               // whole runs after this one
    for (int b = 0; r; ++b, r >>= 1)
      if (r & 1) x = apply(adv[b], x);
    if (w == 0) {                             // the seed: M_L 0xFFFFFFFF
      const uint32_t* pow2 = fast_tables + kNib * 16 + kLane;
      uint32_t sd = 0xffffffffu;
      for (int e = 0; e < 48; ++e)
        if (length >> e & 1) {
          uint32_t m[32];
#pragma unroll
          for (int q = 0; q < 32; ++q) m[q] = __ldg(pow2 + e * 32 + q);
          sd = apply(m, sd);
        }
      x ^= sd;
    }
    atomicXor(out + row, x);
  }
}

}  // namespace

// n rows -> out[n] (int32, u32 bits), which must hold zeros on entry.
//
// Rows: with src null, row i is contiguous at base + i * stride.  Otherwise src, pitch and
// (when dst is not null) dst are HOST arrays of n entries: row i is read from device address
// src[i] in pieces of `seg` bytes at pitch[i] (pitch[i] == seg: contiguous), and with dst its
// bytes are copied to device address dst[i] as they are hashed.  Lengths: lengths[i] (a
// device array of n int64) or, when lengths is null, `length`; max_len bounds every length.
// A row whose pitch is not seg must be whole pieces: length % seg == 0, no per-row lengths.
// tables: the 8 * 256 slicing-by-8 words.  ws == 0 takes the per-thread segments, with adv the
// 48 * 32 columns of M_{seg * 2^b}; ws > 0 (a multiple of 2048) takes the coalesced path in
// runs of ws bytes, with adv = M_{ws * 2^b} and fast_tables as above, and needs uniform
// lengths that are multiples of 16, 16-byte aligned rows, strides, pitches and destinations,
// and pieces that are multiples of 2048 (the caller checks; ops/crc32c_device.py).  Launches on
// `stream` (one launch per 128 rows of a table) and does not synchronise.  Returns the first
// failing launch's cudaError_t (0 = success).
extern "C" int crc32c_launch(const long long* src, const long long* dst, const long long* pitch,
                             const void* base, long long stride, const void* lengths,
                             long long length, long long max_len, long long seg, long long ws,
                             int n, const void* tables, const void* adv, const void* fast_tables,
                             void* out, void* stream) {
  if (n < 0 || length < 0 || max_len < 0 || max_len >= kMaxLen || length > max_len || seg < 1 ||
      ws < 0 || ws % kIter)
    return (int)cudaErrorInvalidValue;
  bool pieces = false;
  if (src) {
    for (int i = 0; i < n; ++i)
      if (pitch[i] != seg) {
        if (lengths || length % seg) return (int)cudaErrorInvalidValue;
        pieces = true;
      }
  } else if (dst) {
    return (int)cudaErrorInvalidValue;
  }
  if (ws && (lengths || length % 16 || (pieces && seg % kIter)))
    return (int)cudaErrorInvalidValue;
  long long slots = 1;                        // threads (ws == 0) or warps (ws > 0) per row
  if (ws) {
    slots = length > 0 ? (length + ws - 1) / ws : 1;
  } else {
    const long long max_seg = max_len > 0 ? (max_len + seg - 1) / seg : 1;
    if (max_seg <= 32) {
      while (slots < max_seg) slots <<= 1;
    } else {
      slots = (max_seg + 31) / 32 * 32;
    }
  }
  const int step = src ? kTableRows : (n > 0 ? n : 1);
  const long long* lens = static_cast<const long long*>(lengths);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* tb = static_cast<const uint32_t*>(tables);
  const uint32_t* av = static_cast<const uint32_t*>(adv);
  const uint32_t* ft = static_cast<const uint32_t*>(fast_tables);
  RowTable table{};
  for (int r0 = 0; r0 < n; r0 += step) {
    const int rows = n - r0 < step ? n - r0 : step;
    for (int i = 0; src && i < rows; ++i) {
      table.src[i] = src[r0 + i];
      table.pitch[i] = pitch[r0 + i];
      table.dst[i] = dst ? dst[r0 + i] : 0;
    }
    const long long threads = (long long)rows * slots * (ws ? 32 : 1);
    const long long blocks = (threads + kThreads - 1) / kThreads;
    if (slots > 0x7fffffffLL || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const uint8_t* b = src ? nullptr : static_cast<const uint8_t*>(base) + r0 * stride;
    const long long* l = lens ? lens + r0 : nullptr;
    unsigned int* o = static_cast<unsigned int*>(out) + r0;
    const long long pc = pieces ? seg : 0;
    if (ws && dst)
      crc32c_coalesced_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
          table, true, b, stride, length, pc, ws, rows, (int)slots, av, ft, o);
    else if (ws)
      crc32c_coalesced_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
          table, src != nullptr, b, stride, length, pc, ws, rows, (int)slots, av, ft, o);
    else if (dst)
      crc32c_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
          table, true, b, stride, l, length, seg, rows, (int)slots, tb, av, o);
    else
      crc32c_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
          table, src != nullptr, b, stride, l, length, seg, rows, (int)slots, tb, av, o);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
