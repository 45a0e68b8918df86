// XOR all-reduce of the mesh's partial products on Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the collective of ceph_tpu/parallel/ec.py::_collective_decode_jit
// (a lax.psum of each member's int32 bit-accumulators over the shard axis,
// then the parity bit): in the survivor-sharded decode every member runs K1
// on its k-slice of the survivors with the matching rows of the decode
// bit-matrix, which gives a u8 partial product, and over GF(2) the parity of
// the summed accumulators is the XOR of those partials.
//
//   partials (n, S, r, C) uint8, contiguous  ->  out (S, r, C) uint8
//   out[j] = partials[0][j] ^ partials[1][j] ^ ... ^ partials[n-1][j]
//
// One thread per 16 bytes of the output: it reads the n partials' 16 bytes
// (one 16-byte load each) and writes once.  When the per-partial byte count
// is not a multiple of 16, or a pointer is not 16-byte aligned, every thread
// takes one byte instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void xor_reduce_vec(const uint4* __restrict__ in, uint4* __restrict__ out,
                               long long n16, int n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n16; i += stride) {
    uint4 acc = in[i];
    for (int p = 1; p < n; ++p) {
      const uint4 v = in[(long long)p * n16 + i];
      acc.x ^= v.x;
      acc.y ^= v.y;
      acc.z ^= v.z;
      acc.w ^= v.w;
    }
    out[i] = acc;
  }
}

__global__ void xor_reduce_byte(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                                long long nbytes, int n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nbytes; i += stride) {
    uint8_t acc = in[i];
    for (int p = 1; p < n; ++p) acc ^= in[(long long)p * nbytes + i];
    out[i] = acc;
  }
}

}  // namespace

// partials: n contiguous blocks of nbytes each; out: nbytes.  Returns a
// cudaError_t (0 on success).
extern "C" int mesh_xor_launch(const void* partials, void* out, long long nbytes, int n,
                               void* stream) {
  if (n < 1 || nbytes < 0) return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return 0;
  const int threads = 256;
  const long long max_blocks = 132LL * 32;   // enough to fill 132 SMs
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = nbytes % 16 == 0 && ((uintptr_t)partials % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  if (vec) {
    const long long n16 = nbytes / 16;
    long long blocks = (n16 + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    xor_reduce_vec<<<(unsigned)blocks, threads, 0, s>>>((const uint4*)partials, (uint4*)out,
                                                        n16, n);
  } else {
    long long blocks = (nbytes + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    xor_reduce_byte<<<(unsigned)blocks, threads, 0, s>>>((const uint8_t*)partials,
                                                         (uint8_t*)out, nbytes, n);
  }
  return (int)cudaGetLastError();
}
