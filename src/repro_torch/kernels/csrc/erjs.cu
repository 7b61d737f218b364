// K2 — per-step eRJS (bound-based rejection) selection on Hopper.
//
// Replaces the rejection work of the TPU mega-step kernel
// (repro/kernels/megastep_kernel.py:225, rejection_lane) as the staged
// step runs it (repro/core/erjs.py: erjs_step).  The trials themselves are
// erjs_trials (erjs.cuh); walkers unresolved after the last round are
// flagged for the reservoir fallback.
//
// Every program's device rule (weights.cuh) runs here, with the walker's
// step, the edge labels and the lane's ring row (visited-avoiding, read
// for every proposal).
//
// What bounds it on the H100: dependent random reads.  A trial is one
// gather of (neighbour, h) at a random offset of a hub's row, plus for
// the second-order rules a binary search of the previous node's row
// (log2 d dependent 4 B reads), and four Threefry evaluations.  Design:
// one thread per walker, looping over its own trials and stopping at its
// first accept (a walker's result never depends on the others, so this
// reproduces the reference's batch while_loop).  Warps diverge on trial
// counts; at the bound's ~35% acceptance on uniform weights most walkers
// finish within a few trials.  Sorting walkers by expected trials is a
// later step.
#include <cuda_runtime.h>
#include <cstdint>

#include "erjs.cuh"

namespace repro {

__global__ void erjs_kernel(Graph g, Rule rule, const int64_t* __restrict__ cur,
                            const int64_t* __restrict__ prev,
                            const int64_t* __restrict__ step,
                            const int32_t* __restrict__ ring,
                            const int64_t* __restrict__ keys,
                            const float* __restrict__ bound, int n, int trials,
                            int rounds, int64_t* __restrict__ out,
                            bool* __restrict__ fallback,
                            int32_t* __restrict__ used) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const WalkerCtx wc = walker_ctx(
      g, rule, cur[i], prev[i], step[i],
      ring ? ring + static_cast<int64_t>(i) * rule.window : nullptr);
  const ErjsResult r = erjs_trials(
      g, rule, wc, static_cast<uint32_t>(keys[2 * i]),
      static_cast<uint32_t>(keys[2 * i + 1]), bound[i], trials, rounds);
  out[i] = r.chosen;
  fallback[i] = r.fallback;
  used[i] = r.trials;
}

}  // namespace repro

extern "C" int repro_erjs_select(const int32_t* indptr, const int32_t* indices,
                                 const float* h, const int32_t* labels,
                                 const repro::Rule* rule_in, const int64_t* cur,
                                 const int64_t* prev, const int64_t* step,
                                 const int32_t* ring, const int64_t* keys,
                                 const float* bound, int n, int trials,
                                 int rounds, int64_t* out, bool* fallback,
                                 int32_t* used, void* stream) {
  const repro::Graph g{indptr, indices, h, labels};
  const repro::Rule rule = *rule_in;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  repro::erjs_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, rule, cur, prev, step, ring, keys, bound, n, trials, rounds, out,
      fallback, used);
  return static_cast<int>(cudaGetLastError());
}
