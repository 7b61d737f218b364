// K3 — inverse-transform (ITS) table draw on Hopper.
//
// Replaces the TPU kernel repro/kernels/precomp_kernel.py:95 its_search
// (body _its_kernel :53); the draw itself is its_offset (its.cuh).  The
// engine's entry searches the flat CSR-order CDF through the row offsets:
// the TPU kernel's [R, 128] row alignment was a DMA constraint and is not
// needed there.  The aligned entry runs the same draw on the [R, 128]
// stream of kernels/ops.py, for the standalone op.
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

// The standalone op on the tile-aligned stream (repro_torch.kernels.ops):
// walker i's row starts at flat offset row0[i] * 128 of cdf2d, whose last
// flat index is `last` (probes past either end read that end).
__global__ void its_aligned_kernel(const float* __restrict__ cdf2d,
                                   const int32_t* __restrict__ row0,
                                   const int32_t* __restrict__ degs,
                                   const float* __restrict__ totals,
                                   const int64_t* __restrict__ seeds, int n,
                                   int64_t last, int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = its_row_offset(cdf2d, static_cast<int64_t>(row0[i]) * 128, degs[i],
                          totals[i], static_cast<uint32_t>(seeds[2 * i]),
                          static_cast<uint32_t>(seeds[2 * i + 1]), last);
}

}  // namespace repro

extern "C" int repro_its_search_aligned(const float* cdf2d,
                                        const int32_t* row0,
                                        const int32_t* degs,
                                        const float* totals,
                                        const int64_t* seeds, int n,
                                        int64_t last, int32_t* out,
                                        void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  repro::its_aligned_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      cdf2d, row0, degs, totals, seeds, n, last, out);
  return static_cast<int>(cudaGetLastError());
}

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
