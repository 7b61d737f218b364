// eRVS reservoir selection of one walker by one warp: the device code of
// kernel K1 (ervs.cu), which the fused epoch K4 (megastep.cu) calls too.
//
// Two instances:
//   JUMP = false: exponential keys ln(u)/w over the row, first offset
//                 holding the maximum key wins;
//   JUMP = true:  lane-strided A-ExpJ (lane l owns offsets l, l+tile, ...),
//                 first lane holding the maximum key wins; its exp, logs
//                 and the multiply-add of u2 are XLA's (xla_math.cuh),
//                 because A-ExpJ turns a 1-ulp change into a different
//                 crossing on long rows.
// The reference's logical tiling feeds the RNG: offset j is lane j % tile
// of tile t = j / tile, and its uniform is that lane of
// uniform(fold_in(key, t)) (u0/u1 from fold_in(key, 2t) / (2t+1) for jump).
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
#include "xla_math.cuh"

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

// The jump instance's key: XLA's log, as its plain version and the
// reference compute it (see xla_math.cuh).
__device__ __forceinline__ float xla_log_key(float u, float w) {
  return w > 0.0f ? __fdiv_rn(xla_log(u), w) : -CUDART_INF_F;
}

// Next node of walker `wc` (per-step key (k0, k1)), or -1 when no
// neighbour has a positive weight.  `lane` = threadIdx.x & 31.
template <bool JUMP>
__device__ int64_t ervs_warp_select(const Graph& g, const Rule& rule,
                                    const WalkerCtx& wc, uint32_t k0,
                                    uint32_t k1, int tile, int lane) {
  const int64_t start = g.indptr[wc.cur];
  const int deg = wc.deg_cur;
  Best best{-CUDART_INF_F, INT32_MAX};
  int64_t best_nbr = -1;  // jump: neighbour held by this thread's best lane

  if (!JUMP) {
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
  } else {
    const float eps38 = __double2float_rn(1e-38);
    const float tiny = __double2float_rn(-1e-30);
    for (int l = lane; l < tile && l < deg; l += 32) {
      float lk_max = -CUDART_INF_F, thresh = 0.0f, cumw = 0.0f;
      int64_t nbr_best = -1;
      for (int t = 0; t * tile + l < deg; ++t) {
        const int j = t * tile + l;
        uint32_t a0, a1, b0, b1;
        fold_in(k0, k1, static_cast<uint32_t>(2 * t), a0, a1);
        fold_in(k0, k1, static_cast<uint32_t>(2 * t + 1), b0, b1);
        const float u0 = uniform_from_bits(random_bits(a0, a1, l));
        const float u1 = uniform_from_bits(random_bits(b0, b1, l));
        const int64_t nbr = g.indices[start + j];
        const float w = edge_weight(g, rule, wc, start + j, nbr);
        const bool is_first = lk_max == -CUDART_INF_F;
        const float init_lk = xla_log_key(u0, w);
        const bool crossed = (__fadd_rn(cumw, w) >= thresh) && (w > 0.0f);
        const float t_w =
            xla_exp(fminf(fmaxf(__fmul_rn(w, lk_max), -80.0f), 0.0f));
        const float u2 = fma32(u0, __fsub_rn(1.0f, t_w), t_w);
        const float cross_lk = xla_log_key(fminf(fmaxf(u2, eps38), 1.0f), w);
        const float new_key = is_first ? init_lk : cross_lk;
        const bool take = (is_first && w > 0.0f) || crossed;
        const float lk_new = take ? new_key : lk_max;
        const float denom = lk_new < 0.0f ? lk_new : tiny;
        if (take) {
          thresh = __fdiv_rn(xla_log(u1), denom);
          cumw = 0.0f;
          nbr_best = nbr;
        } else {
          cumw = __fadd_rn(cumw, w);
        }
        lk_max = lk_new;
      }
      if (lk_max > best.key) {  // lanes rise: first max kept
        best = Best{lk_max, l};
        best_nbr = nbr_best;
      }
    }
  }
  const Best top = warp_best(best);
  const int32_t win = __shfl_sync(0xffffffffu, top.idx, 0);
  const float win_key = __shfl_sync(0xffffffffu, top.key, 0);
  if (JUMP) {
    best_nbr = __shfl_sync(0xffffffffu, best_nbr, win == INT32_MAX ? 0 : (win & 31));
  }
  if (win_key == -CUDART_INF_F) return -1;
  return JUMP ? best_nbr : static_cast<int64_t>(g.indices[start + win]);
}

}  // namespace repro
