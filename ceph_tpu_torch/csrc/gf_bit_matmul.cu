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
// Design.  The Pallas kernel unpacks (k, T) bytes into (8k, T) int8 planes for
// a 128x128 MXU; here the work stays in bits.  One thread owns VEC
// neighbouring byte columns of one stripe.  It loads each of the k data rows
// with one VEC-byte load (16 B when k <= 8), gathers each column's k bytes
// into W = ceil(k/8) 64-bit words, and forms every output bit as
// popc( XOR_w (vec[w] & mask[j][w]) ) & 1.  The masks are B's columns packed
// on the host into (8r, W) u64 words and cached with the matrix; every thread
// of a warp reads the same mask word, so the loads broadcast from L1.  Any
// k <= 256, any r >= 1 and any C >= 1 are taken: a ragged tail of columns and
// misaligned rows fall back to byte loads inside the same kernel.
//
// Bound on this card: bytes.  The function must read S*k*C bytes and write
// S*r*C bytes; at 3.35 TB/s (H100 SXM) the smoke shape S=8192, k=8, r=4,
// C=4096 (402,653,184 B) takes at least ~0.120 ms.  The arithmetic is 8r
// AND/popc per column, so at small k this simple kernel is limited by the
// integer pipes (popc issues at a quarter of the ALU rate) before it reaches
// the memory bound; a tensor-core or table-driven redesign is queued.
#include <cuda_runtime.h>
#include <stdint.h>

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

// W: 64-bit words per column vector (exact for W <= 4; W = 32 serves any
// k <= 256 with nw = ceil(k/8) words live).  VEC: byte columns per thread.
template <int W, int VEC>
__global__ void __launch_bounds__(kThreads)
gf_bit_matmul_kernel(const uint8_t* __restrict__ data, const u64* __restrict__ masks,
                     uint8_t* __restrict__ out, long long S, int k, int r, long long C,
                     int nw, bool aligned) {
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
cudaError_t launch(const uint8_t* data, const u64* masks, uint8_t* out, long long S,
                   int k, int r, long long C, int nw, cudaStream_t stream) {
  const bool aligned = (C % VEC == 0) && (reinterpret_cast<uintptr_t>(data) % VEC == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % VEC == 0);
  const long long threads = S * ((C + VEC - 1) / VEC);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gf_bit_matmul_kernel<W, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      data, masks, out, S, k, r, C, nw, aligned);
  return cudaGetLastError();
}

}  // namespace

// data (S, k, C) u8, masks (8r, nw) u64 with nw = ceil(k/8), out (S, r, C) u8,
// all contiguous on the current device.  Launches on `stream` and does not
// synchronise.  Returns the launch's cudaError_t (0 = cudaSuccess).
extern "C" int gf_bit_matmul_launch(const void* data, const void* masks, void* out,
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
    case 1: return (int)launch<1, 16>(d, mk, o, S, k, r, C, nw, st);
    case 2: return (int)launch<2, 8>(d, mk, o, S, k, r, C, nw, st);
    case 3: return (int)launch<3, 4>(d, mk, o, S, k, r, C, nw, st);
    case 4: return (int)launch<4, 4>(d, mk, o, S, k, r, C, nw, st);
    default: return (int)launch<32, 1>(d, mk, o, S, k, r, C, nw, st);
  }
}
