// K3 — inverse-transform (ITS) table draw on Hopper.
//
// Replaces the TPU kernel repro/kernels/precomp_kernel.py:95 its_search
// (body _its_kernel :53); the draw itself is its_offset (its.cuh).  It
// searches the flat CSR-order CDF through the row offsets: the TPU
// kernel's [R, 128] row alignment was a DMA constraint and is not needed.
//
// What bounds it on the H100: log2(d) dependent 4 B reads of the CDF per
// walker (latency), one Threefry and a handful of flops.  Design: one
// thread per walker; the first probes of hub rows stay hot in L2 across
// the walkers that share a hub.
#include <cuda_runtime.h>
#include <cstdint>

#include "its.cuh"

namespace repro {

__global__ void its_kernel(const int32_t* __restrict__ indptr,
                           const float* __restrict__ cdf,
                           const float* __restrict__ total,
                           const int64_t* __restrict__ cur,
                           const int64_t* __restrict__ keys, int n,
                           int64_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = its_offset(indptr, cdf, total, cur[i],
                      static_cast<uint32_t>(keys[2 * i]),
                      static_cast<uint32_t>(keys[2 * i + 1]));
}

}  // namespace repro

extern "C" int repro_its_search(const int32_t* indptr, const float* cdf,
                                const float* total, const int64_t* cur,
                                const int64_t* keys, int n, int64_t* out,
                                void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  repro::its_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      indptr, cdf, total, cur, keys, n, out);
  return static_cast<int>(cudaGetLastError());
}
