// Measurement kernel for the CRUSH hash on Hopper (sm_90a), plain C interface for ctypes.
// It is off every entry point of the package: chip_smoke.py times it to learn which pipe
// bounds the rjenkins hash that K7a, K6 and K8 draw with, and what K7a's split of it across the
// integer and FMA pipes (crush_common.cuh, hash32_3_split) gains.
//
// crush_hash_probe_kernel<SPLIT>: thread t hashes (x = t, id, r) for n_id ids and folds the
// hashes into one word by XOR, so nothing can be dropped; both forms write the same words.
// SPLIT 0 is hash32_3, 1 hash32_3_split.
#include <cuda_runtime.h>
#include <stdint.h>

#include "crush_common.cuh"

namespace {

constexpr int kProbeThreads = 256;
constexpr int kProbeUnroll = 16;   // hashes per loop step (the SASS count per hash divides by it)

template <bool SPLIT>
__global__ void __launch_bounds__(kProbeThreads)
crush_hash_probe_kernel(uint32_t* __restrict__ out, int n_id, uint32_t r, uint32_t neg1) {
  const uint32_t x = blockIdx.x * kProbeThreads + threadIdx.x;
  uint32_t acc = 0;
  for (int id = 0; id < n_id; id += kProbeUnroll) {
#pragma unroll
    for (int j = 0; j < kProbeUnroll; ++j)
      acc ^= SPLIT ? hash32_3_split(x, (uint32_t)(id + j), r, neg1)
                   : hash32_3(x, (uint32_t)(id + j), r);
  }
  out[x] = acc;
}

}  // namespace

// split 0 (hash32_3) or 1 (hash32_3_split); n threads (a multiple of 256), n_id ids each (a
// multiple of 16)
extern "C" int crush_hash_probe_launch(int split, void* out, long long n, int n_id, int r,
                                       void* stream) {
  if (n <= 0 || n % kProbeThreads || n_id <= 0 || n_id % kProbeUnroll || split < 0 || split > 1)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(n / kProbeThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  if (split)
    crush_hash_probe_kernel<true><<<blocks, kProbeThreads, 0, st>>>((uint32_t*)out, n_id,
                                                                    (uint32_t)r, 0xFFFFFFFFu);
  else
    crush_hash_probe_kernel<false><<<blocks, kProbeThreads, 0, st>>>((uint32_t*)out, n_id,
                                                                     (uint32_t)r, 0xFFFFFFFFu);
  return (int)cudaGetLastError();
}
