// K1 — per-step eRVS reservoir selection on Hopper.
//
// Replaces the reservoir work of the TPU mega-step kernel
// (repro/kernels/megastep_kernel.py:185, reservoir_lane) as the staged
// step runs it (repro/core/ervs.py: ervs_step and ervs_jump_step).  Two
// instances: plain exponential keys (ervs_warp_select, ervs.cuh, the code
// K4 runs too) and the lane-strided A-ExpJ jump variant for hub lanes
// (deg >= jump_threshold; ervs_jump_select, ervs_jump.cuh).  A third
// entry, K1 interleaved (repro_ervs_interleaved_select, the interleaved
// sampler's; ervs_interleaved.cuh), is the plain instance with tile 0 read
// from the walker's prefetch carry and the chosen node's first tile
// written back into it.
//
// Every program's device rule (weights.cuh) runs here: the walker's
// step feeds MetaPath's schema, the edge labels its test, the previous
// node's degree second-order PageRank, and each lane's ring row
// (visited-avoiding, read for every scanned edge) the tabu test.
//
// What bounds them on the H100.  Plain: one Threefry per scanned edge, on
// the integer ALU; ervs.cuh keeps everything else off the edge (no
// division, tile keys folded once per warp, the exact key only where a
// cheap bound says it may win, one edge loop per rule class reading only
// what the rule reads, the dist(v', u) test by a cursor per thread).  One
// warp per walker over the walker's own degree: low-degree walkers leave
// most of a warp idle and wait on their dependent reads; packing several
// walkers per warp is a later optimisation.  Jump: the 8 B an edge reads;
// it draws no random numbers and searches nothing on an edge it does not
// take (ervs_jump.cuh says how), and a walker on a long row gets a block.
#include <cuda_runtime.h>
#include <cstdint>

#include "ervs.cuh"
#include "ervs_interleaved.cuh"
#include "ervs_jump.cuh"

namespace repro {

// Plain.  Held to 6 blocks of 256 threads an SM (40 registers a thread):
// most walkers' rows are short and wait on dependent reads, so warps in
// flight are what they need (on an H100, adaptive node2vec's plain lanes
// took 14% longer at 48 registers).
__global__ void __launch_bounds__(256, 6)
ervs_kernel(Graph g, Rule rule, const int64_t* __restrict__ cur,
            const int64_t* __restrict__ prev, const int64_t* __restrict__ step,
            const int32_t* __restrict__ ring, const int64_t* __restrict__ keys,
            int n, int tile, int64_t* __restrict__ out, GenLeaves leaves) {
  const int walker = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (walker >= n) return;  // whole warps exit together
  const ScanTile st = scan_tile(tile, lane);
  WalkerCtx wc = walker_ctx(
      g, rule, cur[walker], prev[walker], step[walker],
      ring ? ring + static_cast<int64_t>(walker) * rule.window : nullptr);
  load_gen(wc, leaves, walker);
  const int64_t nxt = ervs_warp_select(
      g, rule, wc, static_cast<uint32_t>(keys[2 * walker]),
      static_cast<uint32_t>(keys[2 * walker + 1]), st, lane);
  if (lane == 0) out[walker] = nxt;
}

// Interleaved: a warp a walker, as the plain instance, held to the same
// bounds; `lanes` maps walker i to its slot (its carry row).
__global__ void __launch_bounds__(256, 6)
ervs_interleaved_kernel(Graph g, Rule rule, const int64_t* __restrict__ cur,
                        const int64_t* __restrict__ prev,
                        const int64_t* __restrict__ step,
                        const int32_t* __restrict__ ring,
                        const int64_t* __restrict__ keys, int n, int tile,
                        const int64_t* __restrict__ lanes, Carry c, int flags,
                        int64_t* __restrict__ out, GenLeaves leaves) {
  const int walker = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (walker >= n) return;  // whole warps exit together
  WalkerCtx wc = walker_ctx(
      g, rule, cur[walker], prev[walker], step[walker],
      ring ? ring + static_cast<int64_t>(walker) * rule.window : nullptr);
  load_gen(wc, leaves, walker);
  const int64_t nxt = ervs_interleaved_warp_select(
      g, rule, wc, static_cast<uint32_t>(keys[2 * walker]),
      static_cast<uint32_t>(keys[2 * walker + 1]), tile, c, lanes[walker],
      flags, lane);
  if (lane == 0) out[walker] = nxt;
}

// Jump.  A walker whose row fills every jump lane of a tile larger than a
// warp (deg >= tile > 32) is served by a whole block of kJumpWarps warps,
// one lane a thread (ervs_jump_block_kernel); every other walker by one
// warp (ervs_jump_warp_kernel).  The warp kernel lists the block walkers
// in `todo` ([0] their count, [1] the next to serve, [2...] their
// indices); the block kernel, a grid of resident blocks, takes them one
// at a time, so hub rows of any length balance across the card.  The
// block kernel's launch bounds hold it to 5 blocks of 256 threads an SM (at
// most 48 registers a thread): the scan waits on memory, and more warps in
// flight hide more of it.  The warp kernel's register count is ptxas's
// own (the smoke logs it): held to the same bound, it spills.
constexpr int kJumpWarps = 8;
constexpr int kJumpThreads = 32 * kJumpWarps;

__device__ __forceinline__ bool jump_by_block(int deg, int tile) {
  return tile > 32 && deg >= tile;
}

__global__ void __launch_bounds__(kJumpThreads)
ervs_jump_warp_kernel(Graph g, Rule rule, const int64_t* __restrict__ cur,
                      const int64_t* __restrict__ prev,
                      const int64_t* __restrict__ step,
                      const int32_t* __restrict__ ring,
                      const int64_t* __restrict__ keys, int n, int tile,
                      int64_t* __restrict__ out, int32_t* __restrict__ todo,
                      GenLeaves leaves) {
  __shared__ uint2 tkeys[kJumpWarps][32];
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n) return;  // whole warps exit together
  const JumpWalker jw =
      jump_walker(g, rule, cur, prev, step, ring, leaves, w);
  if (jump_by_block(jw.ctx.deg_cur, tile)) {
    if (lane == 0) todo[2 + atomicAdd(todo, 1)] = static_cast<int32_t>(w);
    return;
  }
  const int64_t nxt = ervs_jump_select(
      g, rule, jw, static_cast<uint32_t>(keys[2 * w]),
      static_cast<uint32_t>(keys[2 * w + 1]), tile, 0, 1, lane,
      tkeys[threadIdx.x >> 5], nullptr, nullptr, nullptr);
  if (lane == 0) out[w] = nxt;
}

__global__ void __launch_bounds__(kJumpThreads, 5)
ervs_jump_block_kernel(Graph g, Rule rule, const int64_t* __restrict__ cur,
                       const int64_t* __restrict__ prev,
                       const int64_t* __restrict__ step,
                       const int32_t* __restrict__ ring,
                       const int64_t* __restrict__ keys, int tile,
                       int64_t* __restrict__ out, int32_t* __restrict__ todo,
                       GenLeaves leaves) {
  __shared__ float red_key[kJumpWarps];
  __shared__ int32_t red_idx[kJumpWarps], red_nbr[kJumpWarps];
  __shared__ int32_t next;
  __shared__ uint2 tkeys[kJumpWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int32_t count = todo[0];
  for (;;) {
    if (threadIdx.x == 0) next = atomicAdd(todo + 1, 1);
    __syncthreads();
    const int32_t k = next;
    __syncthreads();  // `next` is read before thread 0 writes it again
    if (k >= count) return;
    const int64_t w = todo[2 + k];
    const int64_t nxt = ervs_jump_select(
        g, rule, jump_walker(g, rule, cur, prev, step, ring, leaves, w),
        static_cast<uint32_t>(keys[2 * w]),
        static_cast<uint32_t>(keys[2 * w + 1]), tile, warp, kJumpWarps, lane,
        tkeys[warp], red_key, red_idx, red_nbr);
    if (threadIdx.x == 0) out[w] = nxt;
  }
}

// Resident blocks of ervs_jump_block_kernel on the current device, cached
// per device.
int jump_block_grid() {
  constexpr int kCached = 64;
  static int grid[kCached] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kCached && grid[dev]) return grid[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ervs_jump_block_kernel, kJumpThreads, 0);
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kCached) grid[dev] = n;
  return n;
}

}  // namespace repro

// The jump instance's `todo` is n + 2 int32 of scratch (see above); the
// plain instance takes none (null).  `leaves`: kMaxGenLeaves pointers to
// the wstate leaves a generated rule reads (null for a hand rule).
extern "C" int repro_ervs_select(const int32_t* indptr, const int32_t* indices,
                                 const float* h, const int32_t* labels,
                                 const repro::Rule* rule_in, const int64_t* cur,
                                 const int64_t* prev, const int64_t* step,
                                 const int32_t* ring, void* const* leaves,
                                 const int64_t* keys, int n, int tile,
                                 int jump, int64_t* out, int32_t* todo,
                                 void* stream) {
  const repro::Graph g{indptr, indices, h, labels};
  const repro::GenLeaves L = repro::gen_leaves(leaves);
  const repro::Rule rule = *rule_in;
  const int threads = 256;  // 8 walkers per block
  const int blocks = static_cast<int>((static_cast<int64_t>(n) * 32 + threads - 1) / threads);
  auto s = static_cast<cudaStream_t>(stream);
  if (!jump) {
    repro::ervs_kernel<<<blocks, threads, 0, s>>>(g, rule, cur, prev, step, ring, keys, n, tile, out, L);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaMemsetAsync(todo, 0, 2 * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  repro::ervs_jump_warp_kernel<<<blocks, threads, 0, s>>>(g, rule, cur, prev, step, ring, keys, n, tile, out, todo, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  repro::ervs_jump_block_kernel<<<repro::jump_block_grid(), repro::kJumpThreads, 0, s>>>(g, rule, cur, prev, step, ring, keys, tile, out, todo, L);
  return static_cast<int>(cudaGetLastError());
}

// The interleaved entry: the n walkers' slots `lanes` index the carry
// (node [W], nbr / h / label [W, tile]), rewritten in place; `flags` as
// ervs_interleaved_warp_select takes them.  The caller tags every other
// slot -1.
extern "C" int repro_ervs_interleaved_select(
    const int32_t* indptr, const int32_t* indices, const float* h,
    const int32_t* labels, const repro::Rule* rule_in, const int64_t* cur,
    const int64_t* prev, const int64_t* step, const int32_t* ring,
    void* const* leaves, const int64_t* keys, int n, int tile,
    const int64_t* lanes, int64_t* c_node, int32_t* c_nbr, float* c_h,
    int32_t* c_label, int flags, int64_t* out, void* stream) {
  const repro::Graph g{indptr, indices, h, labels};
  const repro::Carry c{c_node, c_nbr, c_h, c_label};
  const int threads = 256;  // 8 walkers per block
  const int blocks = static_cast<int>((static_cast<int64_t>(n) * 32 + threads - 1) / threads);
  repro::ervs_interleaved_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, *rule_in, cur, prev, step, ring, keys, n, tile, lanes, c, flags, out,
      repro::gen_leaves(leaves));
  return static_cast<int>(cudaGetLastError());
}
