// K5 — alias table draw on Hopper.
//
// Replaces the TPU kernel repro/kernels/precomp_kernel.py:154 alias_pick
// (body _alias_kernel :124); the draw itself is alias_offset (alias.cuh).
// The TPU kernel read the tables from [R, 128] row-aligned float32 streams
// (alias offsets stored as floats); here they are the flat CSR-order
// arrays, prob as float32 and the alias offsets as int32.  The aligned
// entry runs the same draw on the [R, 128] float32 streams of
// kernels/ops.py, for the standalone op.
//
// What bounds it on the H100: two dependent rounds of random reads per
// walker (the row, then the column), one Threefry: a few random 32 B
// sectors per walker, so bytes in sectors, not instructions.  Design: one
// thread per walker; the engine's entry reads the row's start, degree and
// total as one 16 B node record and the column's prob and alias as one
// 8 B word of the pair table (alias_offset in alias.cuh): two random
// sectors a walker where indptr, total, prob and alias cost four.
#include <cuda_runtime.h>
#include <cstdint>

#include "alias.cuh"

namespace repro {

__global__ void alias_kernel(const int4* __restrict__ rec,
                             const int2* __restrict__ pair,
                             const int64_t* __restrict__ cur,
                             const int64_t* __restrict__ keys, int n,
                             int64_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = alias_offset(rec, pair, cur[i],
                        static_cast<uint32_t>(keys[2 * i]),
                        static_cast<uint32_t>(keys[2 * i + 1]));
}

// The standalone op on the tile-aligned streams (repro_torch.kernels.ops):
// walker i's row starts at flat offset row0[i] * 128; alias offsets are
// float32 there; `last` is the streams' last flat index (a column past
// either end reads that end).
__global__ void alias_aligned_kernel(const float* __restrict__ prob2d,
                                     const float* __restrict__ alias2d,
                                     const int32_t* __restrict__ row0,
                                     const int32_t* __restrict__ degs,
                                     const float* __restrict__ totals,
                                     const int64_t* __restrict__ seeds, int n,
                                     int64_t last, int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = alias_row_offset(prob2d, alias2d,
                            static_cast<int64_t>(row0[i]) * 128, degs[i],
                            totals[i], static_cast<uint32_t>(seeds[2 * i]),
                            static_cast<uint32_t>(seeds[2 * i + 1]), last);
}

}  // namespace repro

extern "C" int repro_alias_pick_aligned(const float* prob2d,
                                        const float* alias2d,
                                        const int32_t* row0,
                                        const int32_t* degs,
                                        const float* totals,
                                        const int64_t* seeds, int n,
                                        int64_t last, int32_t* out,
                                        void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  repro::alias_aligned_kernel<<<blocks, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      prob2d, alias2d, row0, degs, totals, seeds, n, last, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_alias_pick(const int4* rec, const int2* pair,
                                const int64_t* cur, const int64_t* keys,
                                int n, int64_t* out, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  repro::alias_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rec, pair, cur, keys, n, out);
  return static_cast<int>(cudaGetLastError());
}
