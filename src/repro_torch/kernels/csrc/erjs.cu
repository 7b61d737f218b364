// K2 — per-step eRJS (bound-based rejection) selection on Hopper.
//
// Replaces the rejection work of the TPU mega-step kernel
// (repro/kernels/megastep_kernel.py:225, rejection_lane) as the staged
// step runs it (repro/core/erjs.py: erjs_step).  The trials themselves are
// erjs.cuh's (erjs_round0, erjs_passes); walkers unresolved after the last
// round are flagged for the reservoir fallback.
//
// Every program's device rule (weights.cuh) runs here, with the walker's
// step, the edge labels and the lane's ring row (visited-avoiding, read
// for every proposal).
//
// What bounds it on the H100: dependent random reads.  A trial is one
// gather of (neighbour, h) at a random offset of a hub's row, plus for
// the second-order rules a binary search of the previous node's row
// (log2 d dependent 4 B reads), and four Threefry evaluations (two when
// w = 0).  With every trial of a walker on its own thread, a warp waits
// for the slowest of its 32 geometric trial counts: a fifth of 2ndpr's
// walkers fall back, so nearly every warp would run 128 serial trials with
// a few lanes active.  Design: two launches.  Round 0, a thread per walker
// (erjs_round0, erjs.cuh), resolves most walkers and lists the rest; then
// warps take the listed walkers, a few or up to 32 a warp by the list's
// length, and share their lanes among them pass by pass (erjs_passes): a
// walker alone makes 32 trials a pass.  A walker that falls back costs
// ceil((rounds - 1) x trials / 32) passes, each one trial's chain of
// dependent reads.  Round 0 keeps the registers of a loop of scalar trials
// (warps in flight are what it needs: most walkers of most programs accept
// there); in one kernel with the later rounds it took 48-56 registers
// against 40, and node2vec's K2 6-14% more time on an H100.
#include <cuda_runtime.h>
#include <cstdint>

#include "erjs.cuh"

namespace repro {

// Round 0, a thread per walker.  A walker it resolves (an accept, an
// infeasible walker, a budget of one round) gets its results here; the
// others are listed in todo ([0] their count, zero at the launch; [1...]
// their indices) for erjs_rounds_kernel.
__global__ void erjs_round0_kernel(Graph g, Rule rule,
                                   const int64_t* __restrict__ cur,
                                   const int64_t* __restrict__ prev,
                                   const int64_t* __restrict__ step,
                                   const int32_t* __restrict__ ring,
                                   const int64_t* __restrict__ keys,
                                   const float* __restrict__ bound, int n,
                                   int trials, int rounds,
                                   int64_t* __restrict__ out,
                                   bool* __restrict__ fallback,
                                   int32_t* __restrict__ used,
                                   int32_t* __restrict__ todo,
                                   GenLeaves leaves) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if ((i & ~31) >= n) return;  // whole warps exit together
  // a lane past the end stays in its warp's vote with no walker
  const bool on = i < n;
  bool feasible = false, done = true;
  ErjsResult r{-1, false, 0};
  if (on) {
    WalkerCtx wc = walker_ctx(
        g, rule, cur[i], prev[i], step[i],
        ring ? ring + static_cast<int64_t>(i) * rule.window : nullptr);
    load_gen(wc, leaves, i);
    const float b = bound[i];
    feasible = wc.deg_cur > 0 && b > 0.0f;
    r = erjs_round0(g, rule, wc, feasible ? g.indptr[wc.cur] : 0,
                    static_cast<uint32_t>(keys[2 * i]),
                    static_cast<uint32_t>(keys[2 * i + 1]), b, trials,
                    feasible, done);
  }
  const bool later = !done && rounds > 1;
  if (on && !later) {
    out[i] = r.chosen;
    fallback[i] = !done;
    used[i] = r.trials;
  }
  const unsigned m = __ballot_sync(kFullWarp, later);
  if (m) {  // one atomic a warp
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(m) - 1;
    int at = 0;
    if (lane == leader) at = atomicAdd(todo, __popc(m));
    at = __shfl_sync(kFullWarp, at, leader);
    if (later) todo[1 + at + __popc(m & ((1u << lane) - 1u))] = i;
  }
}

// The later rounds of the listed walkers, on a grid of resident blocks:
// the list is spread over the grid's warps, `per` walkers a warp at a time
// (at most 32), which share its lanes pass by pass (erjs_passes).  A short
// list gives each warp a walker or a few, so no warp serves many walkers
// one after another while others idle; a long one fills every lane.
__global__ void erjs_rounds_kernel(Graph g, Rule rule,
                                   const int64_t* __restrict__ cur,
                                   const int64_t* __restrict__ prev,
                                   const int64_t* __restrict__ step,
                                   const int32_t* __restrict__ ring,
                                   const int64_t* __restrict__ keys,
                                   const float* __restrict__ bound,
                                   int trials, int rounds,
                                   const int32_t* __restrict__ todo,
                                   int64_t* __restrict__ out,
                                   bool* __restrict__ fallback,
                                   int32_t* __restrict__ used,
                                   GenLeaves leaves) {
  const int count = todo[0];
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * blockDim.x / 32;
  const int per = min(32, (count + warps - 1) / warps);
  for (int k0 = (blockIdx.x * blockDim.x + threadIdx.x) / 32 * per;
       k0 < count; k0 += warps * per) {  // warp-uniform
    const bool on = lane < per && k0 + lane < count;
    WalkerCtx wc{-1, -1, 0, 0, 0, nullptr};
    uint32_t s0 = 0, s1 = 0;
    float b = 0.0f;
    int64_t start = 0;
    int i = 0;
    if (on) {
      i = todo[1 + k0 + lane];
      wc = walker_ctx(
          g, rule, cur[i], prev[i], step[i],
          ring ? ring + static_cast<int64_t>(i) * rule.window : nullptr);
      load_gen(wc, leaves, i);
      s0 = static_cast<uint32_t>(keys[2 * i]);
      s1 = static_cast<uint32_t>(keys[2 * i + 1]);
      b = bound[i];
      start = g.indptr[wc.cur];
    }
    ErjsResult r{-1, false, trials};
    const bool acc = erjs_passes(g, rule, wc, start, s0, s1, b, trials,
                                 trials * rounds, on, r);
    if (on) {
      out[i] = r.chosen;
      fallback[i] = !acc;
      used[i] = r.trials;
    }
  }
}

}  // namespace repro

namespace {

// The blocks of erjs_rounds_kernel that fit on device `dev` at once, of
// `threads` threads each (a device's count does not change: kept once a
// device).
int rounds_grid(int dev, int threads) {
  constexpr int kDevices = 64;
  static int grid[kDevices] = {};
  if (dev >= 0 && dev < kDevices && grid[dev] > 0) return grid[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, repro::erjs_rounds_kernel, threads, 0);
  const int n = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < kDevices && sms > 0 && per_sm > 0) grid[dev] = n;
  return n;
}

}  // namespace

extern "C" int repro_erjs_select(const int32_t* indptr, const int32_t* indices,
                                 const float* h, const int32_t* labels,
                                 const repro::Rule* rule_in, const int64_t* cur,
                                 const int64_t* prev, const int64_t* step,
                                 const int32_t* ring, void* const* leaves,
                                 const int64_t* keys,
                                 const float* bound, int n, int trials,
                                 int rounds, int64_t* out, bool* fallback,
                                 int32_t* used, int32_t* todo, void* stream) {
  const repro::Graph g{indptr, indices, h, labels};
  const repro::Rule rule = *rule_in;
  const repro::GenLeaves L = repro::gen_leaves(leaves);
  auto s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const cudaError_t clear = cudaMemsetAsync(todo, 0, sizeof(int32_t), s);
  if (clear != cudaSuccess) return static_cast<int>(clear);
  repro::erjs_round0_kernel<<<blocks, threads, 0, s>>>(
      g, rule, cur, prev, step, ring, keys, bound, n, trials, rounds, out,
      fallback, used, todo, L);
  if (rounds > 1) {  // a grid of the blocks that fit on the card at once
    int dev = 0;
    const cudaError_t got = cudaGetDevice(&dev);
    if (got != cudaSuccess) return static_cast<int>(got);
    const int grid = rounds_grid(dev, threads);
    repro::erjs_rounds_kernel<<<blocks < grid ? blocks : grid, threads, 0,
                                s>>>(
        g, rule, cur, prev, step, ring, keys, bound, trials, rounds, todo,
        out, fallback, used, L);
  }
  return static_cast<int>(cudaGetLastError());
}
