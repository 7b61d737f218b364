// K7 — bound-based rejection over a stored weight row on Hopper.
//
// Replaces the TPU kernel repro/kernels/erjs_kernel.py:73 erjs_select
// (body _erjs_kernel :32, pallas_call :81); its plain version is
// repro_torch/kernels/ref.py:erjs_select_ref.  Walker i's row is the
// tile-aligned [R, 128] stream at flat start row0[i] * 128 (as in the
// reference, a row index outside [0, R) reads row 0 or R - 1).  Trial t
// draws uniform_pair_01(seed, (t, 0x00C0FFEE)), proposes offset
// min(int(u_idx * deg), deg - 1), reads that ONE stored weight and
// accepts iff u_acc * bound <= w and w > 0; the walker stops at
// acceptance or after `limit` (trials * max_rounds) trials, and returns
// -1 when none was accepted (or when deg or bound is not positive).
//
// Unlike K2 (erjs.cu), which evaluates a program's weight rule on the
// graph, this reads a stored weight, so it shares only threefry.cuh.
//
// What bounds it on the H100: one dependent random 4 B read per trial
// (latency; a 32 B sector moves per read) and one Threefry.  Design: one
// thread per walker.
#include <cuda_runtime.h>
#include <cstdint>

#include "threefry.cuh"

namespace repro {

constexpr uint32_t kErjsSalt = 0x00C0FFEEu;

__device__ __forceinline__ int64_t clip(int64_t x, int64_t hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

__global__ void erjs_block_kernel(const float* __restrict__ w2d,
                                  const int32_t* __restrict__ row0,
                                  const int32_t* __restrict__ degs,
                                  const float* __restrict__ bounds,
                                  const int64_t* __restrict__ seeds, int n,
                                  int64_t rows, int limit,
                                  int32_t* __restrict__ off_out,
                                  int32_t* __restrict__ trials_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t r0 = row0[i];
  const int deg = degs[i];
  const float bound = bounds[i];
  const uint32_t k0 = static_cast<uint32_t>(seeds[2 * i]);
  const uint32_t k1 = static_cast<uint32_t>(seeds[2 * i + 1]);
  const bool feasible = deg > 0 && bound > 0.0f;
  int t = 0, off = -1;
  while (feasible && off < 0 && t < limit) {
    float u_idx, u_acc;
    uniform_pair_01(k0, k1, static_cast<uint32_t>(t), kErjsSalt, u_idx, u_acc);
    const int cand =
        min(__float2int_rz(__fmul_rn(u_idx, __int2float_rn(deg))), deg - 1);
    const int64_t r = clip(r0 + (cand >> 7), rows - 1);
    const float w = w2d[r * 128 + (cand & 127)];
    if (__fmul_rn(u_acc, bound) <= w && w > 0.0f) off = cand;
    ++t;
  }
  off_out[i] = off;
  trials_out[i] = t;
}

}  // namespace repro

extern "C" int repro_erjs_block_select(const float* w2d, const int32_t* row0,
                                       const int32_t* degs,
                                       const float* bounds,
                                       const int64_t* seeds, int n,
                                       int64_t rows, int limit, int32_t* off,
                                       int32_t* trials,
                                       void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  repro::erjs_block_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      w2d, row0, degs, bounds, seeds, n, rows, limit, off, trials);
  return static_cast<int>(cudaGetLastError());
}
