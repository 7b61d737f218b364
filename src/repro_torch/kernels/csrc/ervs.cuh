// eRVS reservoir selection of one walker by one warp, exponential keys
// ln(u)/w over the row, first offset holding the maximum key wins: the
// device code of kernel K1's plain instance (ervs.cu), which the fused
// epoch K4 (megastep.cu) calls too.  The jump instance is ervs_jump.cuh.
// The reference's logical tiling feeds the RNG: offset j is lane j % tile
// of tile t = j / tile, and its uniform is that lane of
// uniform(fold_in(key, t)).
//
// The 32 threads of a warp stride over the walker's OWN degree (never a
// padded maximum), so the row reads coalesce; per-thread best keys are
// reduced by shuffle with the reference's tie rule.  The tile's Threefry
// key is recomputed only when a thread crosses a tile.  Every thread of the
// warp must call ervs_warp_select with the same walker; all get its result.
#pragma once
#include <cstdint>
#include <math_constants.h>

#include "threefry.cuh"
#include "weights.cuh"

namespace repro {

struct Best {
  float key;
  int32_t idx;  // offset (plain) or lane (jump); INT32_MAX = none
};

__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  return a.key > b.key || (a.key == b.key && a.idx < b.idx);
}

__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    Best o;
    o.key = __shfl_down_sync(0xffffffffu, b.key, s);
    o.idx = __shfl_down_sync(0xffffffffu, b.idx, s);
    if (better(o, b)) b = o;
  }
  return b;
}

__device__ __forceinline__ float log_key(float u, float w) {
  return w > 0.0f ? __fdiv_rn(logf(u), w) : -CUDART_INF_F;
}

// Next node of walker `wc` (per-step key (k0, k1)), or -1 when no
// neighbour has a positive weight.  `lane` = threadIdx.x & 31.
__device__ int64_t ervs_warp_select(const Graph& g, const Rule& rule,
                                    const WalkerCtx& wc, uint32_t k0,
                                    uint32_t k1, int tile, int lane) {
  const int64_t start = g.indptr[wc.cur];
  const int deg = wc.deg_cur;
  Best best{-CUDART_INF_F, INT32_MAX};
  int cached_t = -1;
  uint32_t t0 = 0, t1 = 0;
  for (int j = lane; j < deg; j += 32) {
    const int t = j / tile;
    if (t != cached_t) {
      fold_in(k0, k1, static_cast<uint32_t>(t), t0, t1);
      cached_t = t;
    }
    const float u = uniform_from_bits(
        random_bits(t0, t1, static_cast<uint32_t>(j - t * tile)));
    const int64_t nbr = g.indices[start + j];
    const float lk = log_key(u, edge_weight(g, rule, wc, start + j, nbr));
    if (lk > best.key) best = Best{lk, j};  // offsets rise: first max kept
  }
  const Best top = warp_best(best);
  const int32_t win = __shfl_sync(0xffffffffu, top.idx, 0);
  const float win_key = __shfl_sync(0xffffffffu, top.key, 0);
  if (win_key == -CUDART_INF_F) return -1;
  return static_cast<int64_t>(g.indices[start + win]);
}

}  // namespace repro
