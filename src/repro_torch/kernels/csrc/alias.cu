// K5 — alias table draw on Hopper.
//
// Replaces the TPU kernel repro/kernels/precomp_kernel.py:154 alias_pick
// (body _alias_kernel :124); the draw itself is alias_offset (alias.cuh).
// The TPU kernel read the tables from [R, 128] row-aligned float32 streams
// (alias offsets stored as floats); here they are the flat CSR-order
// arrays, prob as float32 and the alias offsets as int32.
//
// What bounds it on the H100: two dependent rounds of 4 B reads per walker
// (indptr, then prob and alias of one column), one Threefry: a few random
// 32 B sectors per walker, so bytes in sectors, not instructions.  Design:
// one thread per walker.
#include <cuda_runtime.h>
#include <cstdint>

#include "alias.cuh"

namespace repro {

__global__ void alias_kernel(const int32_t* __restrict__ indptr,
                             const float* __restrict__ prob,
                             const int32_t* __restrict__ alias,
                             const float* __restrict__ total,
                             const int64_t* __restrict__ cur,
                             const int64_t* __restrict__ keys, int n,
                             int64_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = alias_offset(indptr, prob, alias, total, cur[i],
                        static_cast<uint32_t>(keys[2 * i]),
                        static_cast<uint32_t>(keys[2 * i + 1]));
}

}  // namespace repro

extern "C" int repro_alias_pick(const int32_t* indptr, const float* prob,
                                const int32_t* alias, const float* total,
                                const int64_t* cur, const int64_t* keys, int n,
                                int64_t* out, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  repro::alias_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      indptr, prob, alias, total, cur, keys, n, out);
  return static_cast<int>(cudaGetLastError());
}
