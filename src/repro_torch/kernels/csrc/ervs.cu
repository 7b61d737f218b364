// K1 — per-step eRVS reservoir selection on Hopper.
//
// Replaces the reservoir work of the TPU mega-step kernel
// (repro/kernels/megastep_kernel.py:185, reservoir_lane) as the staged
// step runs it (repro/core/ervs.py: ervs_step and ervs_jump_step).  The
// selection itself is ervs_warp_select (ervs.cuh): plain exponential keys,
// or the lane-strided A-ExpJ jump variant for hub lanes
// (deg >= jump_threshold).
//
// Every program's device rule (weights.cuh) runs here: the walker's
// step feeds MetaPath's schema, the edge labels its test, the previous
// node's degree second-order PageRank, and each lane's ring row
// (visited-avoiding, read for every scanned edge) the tabu test.
//
// What bounds it on the H100: memory latency, not bandwidth or ALU.  Each
// scanned edge reads its neighbour id and h (8 B, coalesced across the
// warp) and, for the second-order rules, binary-searches the previous
// node's row (log2 d dependent 4 B reads), plus one Threefry (~120
// integer ops) and a logf.  Design: one warp per walker looping over the
// walker's own degree.  Low-degree walkers leave most of a warp idle;
// packing several walkers per warp is a later optimisation.
#include <cuda_runtime.h>
#include <cstdint>

#include "ervs.cuh"

namespace repro {

template <bool JUMP>
__global__ void ervs_kernel(Graph g, Rule rule, const int64_t* __restrict__ cur,
                            const int64_t* __restrict__ prev,
                            const int64_t* __restrict__ step,
                            const int32_t* __restrict__ ring,
                            const int64_t* __restrict__ keys, int n, int tile,
                            int64_t* __restrict__ out) {
  const int walker = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (walker >= n) return;  // whole warps exit together
  const WalkerCtx wc = walker_ctx(
      g, rule, cur[walker], prev[walker], step[walker],
      ring ? ring + static_cast<int64_t>(walker) * rule.window : nullptr);
  const int64_t nxt = ervs_warp_select<JUMP>(
      g, rule, wc, static_cast<uint32_t>(keys[2 * walker]),
      static_cast<uint32_t>(keys[2 * walker + 1]), tile, lane);
  if (lane == 0) out[walker] = nxt;
}

}  // namespace repro

extern "C" int repro_ervs_select(const int32_t* indptr, const int32_t* indices,
                                 const float* h, const int32_t* labels,
                                 const repro::Rule* rule_in, const int64_t* cur,
                                 const int64_t* prev, const int64_t* step,
                                 const int32_t* ring, const int64_t* keys,
                                 int n, int tile, int jump, int64_t* out,
                                 void* stream) {
  const repro::Graph g{indptr, indices, h, labels};
  const repro::Rule rule = *rule_in;
  const int threads = 256;  // 8 walkers per block, one warp each
  const int blocks = static_cast<int>((static_cast<int64_t>(n) * 32 + threads - 1) / threads);
  auto s = static_cast<cudaStream_t>(stream);
  if (jump) {
    repro::ervs_kernel<true><<<blocks, threads, 0, s>>>(g, rule, cur, prev, step, ring, keys, n, tile, out);
  } else {
    repro::ervs_kernel<false><<<blocks, threads, 0, s>>>(g, rule, cur, prev, step, ring, keys, n, tile, out);
  }
  return static_cast<int>(cudaGetLastError());
}
