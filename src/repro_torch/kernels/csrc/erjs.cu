// K2 — per-step eRJS (bound-based rejection) selection on Hopper.
//
// Replaces the rejection work of the TPU mega-step kernel
// (repro/kernels/megastep_kernel.py:225, rejection_lane) as the staged
// step runs it (repro/core/erjs.py: erjs_step).  Each walker makes up to
// rounds x trials proposals: trial k of round r draws
//   u_idx from uniform(fold_in(key, r*2K + 2k)), u_acc from (... + 1),
//   offset = min(int(u_idx * float(deg)), deg - 1),
// and accepts iff u_acc * bound <= w && w > 0.  Walkers unresolved after
// the last round are flagged for the reservoir fallback.
//
// What bounds it on the H100: dependent random reads.  A trial is one
// gather of (neighbour, h) at a random offset of a hub's row, plus for
// Node2Vec a binary search of the previous node's row (log2 d dependent
// 4 B reads), and four Threefry evaluations.  Design: one thread per
// walker, looping over its own trials and stopping at its first accept
// (a walker's result never depends on the others, so this reproduces the
// reference's batch while_loop).  Warps diverge on trial counts; at the
// bound's ~35% acceptance on uniform weights most walkers finish within
// a few trials.  Sorting walkers by expected trials is a later step.
#include <cuda_runtime.h>
#include <cstdint>

#include "threefry.cuh"
#include "weights.cuh"

namespace repro {

__device__ __forceinline__ float fold_uniform(uint32_t k0, uint32_t k1,
                                              uint32_t counter) {
  uint32_t a0, a1;
  fold_in(k0, k1, counter, a0, a1);
  return uniform_from_bits(random_bits(a0, a1, 0u));
}

__global__ void erjs_kernel(Graph g, Rule rule, const int64_t* __restrict__ cur,
                            const int64_t* __restrict__ prev,
                            const int64_t* __restrict__ keys,
                            const float* __restrict__ bound, int n, int trials,
                            int rounds, int64_t* __restrict__ out,
                            bool* __restrict__ fallback,
                            int32_t* __restrict__ used) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t v = cur[i];
  const int64_t p = prev[i];
  const int64_t start = g.indptr[v];
  const int deg = g.indptr[v + 1] - g.indptr[v];
  const float c = bound[i];
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * i]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * i + 1]);
  const bool feasible = deg > 0 && c > 0.0f;
  const float degf = __int2float_rn(deg);
  int64_t chosen = -1;
  bool done = !feasible;
  int count = 0;
  for (int r = 0; r < rounds && !done; ++r) {
    for (int k = 0; k < trials && !done; ++k) {
      const uint32_t ctr = static_cast<uint32_t>(r * 2 * trials + 2 * k);
      const float u_idx = fold_uniform(k0, k1, ctr);
      const float u_acc = fold_uniform(k0, k1, ctr + 1u);
      const int off = min(__float2int_rz(__fmul_rn(u_idx, degf)), deg - 1);
      const int64_t nbr = g.indices[start + off];
      const float w = edge_weight(g, rule, p, start + off, nbr);
      ++count;
      if (__fmul_rn(u_acc, c) <= w && w > 0.0f) {
        chosen = nbr;
        done = true;
      }
    }
  }
  out[i] = chosen;
  fallback[i] = feasible && !done;
  used[i] = count;
}

}  // namespace repro

extern "C" int repro_erjs_select(const int32_t* indptr, const int32_t* indices,
                                 const float* h, int program, int weighted,
                                 float c0, float c2, const int64_t* cur,
                                 const int64_t* prev, const int64_t* keys,
                                 const float* bound, int n, int trials,
                                 int rounds, int64_t* out, bool* fallback,
                                 int32_t* used, void* stream) {
  const repro::Graph g{indptr, indices, h};
  const repro::Rule rule{program, weighted, c0, c2};
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  repro::erjs_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, rule, cur, prev, keys, bound, n, trials, rounds, out, fallback, used);
  return static_cast<int>(cudaGetLastError());
}
