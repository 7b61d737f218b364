// K1's jump instance: lane-strided A-ExpJ reservoir selection of one walker
// (ervs.cu).  Lane l of the reference's logical tile owns the row offsets
// l, l + tile, l + 2 tile, ...; tile t draws u0 from fold_in(key, 2t) and
// u1 from fold_in(key, 2t + 1), at the lane's index.  The lane with the
// largest final key wins, the first lane on ties.  Its exp, logs and the
// multiply-add of u2 are XLA's (xla_math.cuh), because A-ExpJ turns a
// 1-ulp change into a different crossing on long rows.
//
// What bounds it on the H100: reading each scanned edge's neighbour and h
// (8 B) — on 2nd-order PageRank's hub lanes ~9x10^10 edges a step.  The
// design keeps everything else off the per-edge path:
//   * one lane a thread: a warp runs 32 consecutive lanes through the
//     tiles together (jump_warp_pass), so its reads coalesce and each
//     thread carries one A-ExpJ chain (key, threshold, running sum) in
//     registers; a walker whose row fills a tile gets a block of warps
//     (ervs.cu), the others one warp;
//   * the tile keys fold_in(key, 2t), fold_in(key, 2t + 1) are computed by
//     the warp together, one Threefry a thread for 16 tiles, into shared
//     memory, where a lane reads them only when it draws;
//   * u0 and u1 are drawn only where a lane takes an edge (its first
//     positive weight, or a crossing), u1 only when the lane has an edge
//     left: every other edge costs its weight, an add and a compare.  A
//     lane takes about ln(n) of its n edges, but while any of a warp's 32
//     lanes takes, the whole warp waits on it;
//   * the second-order rules' dist(v', u) test walks a cursor per lane
//     forward through v''s sorted row (the lane's neighbours rise), with a
//     galloping search from the cursor, instead of a binary search of the
//     whole row per edge.  The answer is exact, so the weights and the
//     bits are the plain version's.
#pragma once
#include <cstdint>
#include <math_constants.h>

#include "ervs.cuh"
#include "threefry.cuh"
#include "weights.cuh"
#include "xla_math.cuh"

namespace repro {

// Tiles whose two keys one warp-wide Threefry round provides.
constexpr int kJumpKeyTiles = 16;

// A walker as the jump scan reads it: its context, where its row starts,
// and v''s row [p_begin, p_end) for the rules that test dist(v', u) (empty
// for the others and before the first step).
struct JumpWalker {
  WalkerCtx ctx;
  int64_t start;
  int p_begin, p_end;
};

// Walker `w`'s JumpWalker, every row bound read at once.
__device__ __forceinline__ JumpWalker jump_walker(
    const Graph& g, const Rule& rule, const int64_t* __restrict__ cur,
    const int64_t* __restrict__ prev, const int64_t* __restrict__ step,
    const int32_t* __restrict__ ring, const GenLeaves& leaves, int64_t w) {
  const int64_t c = cur[w], p = prev[w];
  const bool prow = p >= 0 && (reads_dist(rule) || reads_deg_prev(rule));
  const int32_t s0 = g.indptr[c], s1 = g.indptr[c + 1];
  const int32_t p0 = prow ? g.indptr[p] : 0, p1 = prow ? g.indptr[p + 1] : 0;
  JumpWalker jw;
  jw.ctx = WalkerCtx{c, p, step[w], s1 - s0,
                     reads_deg_prev(rule) ? p1 - p0 : 0,
                     ring ? ring + w * rule.window : nullptr};
  load_gen(jw.ctx, leaves, w);
  jw.start = s0;
  jw.p_begin = p0;
  jw.p_end = p1;
  return jw;
}

// The jump instance's key: XLA's log, as its plain version and the
// reference compute it (see xla_math.cuh).
__device__ __forceinline__ float xla_log_key(float u, float w) {
  return w > 0.0f ? __fdiv_rn(xla_log(u), w) : -CUDART_INF_F;
}

// Lanes base + lane (lane = threadIdx.x & 31, base warp-uniform) of walker
// `jw` through every tile that reaches them: this thread's lane's final
// (key, neighbour) in lk / nbr, (-inf, -1) when the lane holds no
// positive weight or does not exist (lane >= `lanes`).  The whole warp
// calls with the same walker and base; `tkeys` is the warp's 32 entries of
// shared memory for the tile keys.
__device__ __forceinline__ void jump_warp_pass(
    const Graph& g, const Rule& rule, const JumpWalker& jw, uint32_t k0,
    uint32_t k1, int tile, int lanes, int base, int lane, uint2* tkeys,
    float& lk, int32_t& nbr_out) {
  const WalkerCtx& wc = jw.ctx;
  const int64_t start = jw.start;
  const int deg = wc.deg_cur;
  const int p_begin = jw.p_begin, p_end = jw.p_end;
  const int l = base + lane;
  const bool has = l < lanes;
  const float eps38 = __double2float_rn(1e-38);
  const float tiny = __double2float_rn(-1e-30);
  float lk_max = -CUDART_INF_F, thresh = 0.0f, cumw = 0.0f;
  int32_t nbr_best = -1;
  int cursor = p_begin - 1;  // not placed yet
  // tile t reaches lane l while t * tile + l < deg; lane `base` is reached
  // by the most tiles
  const int tiles = static_cast<int>(
      (static_cast<unsigned>(deg - base) + tile - 1) / tile);
  for (int t = 0; t < tiles; ++t) {
    const int64_t j = static_cast<int64_t>(t) * tile + l;
    const bool on = has && j < deg;
    // the edge's loads first: the tile keys' Threefry runs meanwhile
    const int64_t nbr = on ? g.indices[start + j] : -1;
    const float h = on && rule.weighted ? g.h[start + j] : 1.0f;
    const int s = t % kJumpKeyTiles;
    if (s == 0) {  // the next 16 tiles' keys, fold_in(key, 2 t + lane)
      uint2 k;
      fold_in(k0, k1, static_cast<uint32_t>(2 * t + lane), k.x, k.y);
      __syncwarp();  // every lane is done with the last 16
      tkeys[lane] = k;
      __syncwarp();
    }
    if (!on) continue;
    // tile 0: nearly every lane takes its first edge, so draw its u0 before
    // the weight's reads return; later tiles draw only where a lane takes
    const float u0_first =
        t == 0 ? uniform_from_bits(random_bits(
                     tkeys[0].x, tkeys[0].y, static_cast<uint32_t>(l)))
               : 0.0f;
    const float w = edge_weight_by(g, rule, wc, start + j, nbr, h, [&] {
      if (wc.prev < 0) return 1;
      if (nbr == wc.prev) return 0;
      return search_from(g.indices, cursor, p_begin, p_end, nbr) ? 1 : 2;
    });
    const bool is_first = lk_max == -CUDART_INF_F;
    const bool crossed = (__fadd_rn(cumw, w) >= thresh) && (w > 0.0f);
    if ((is_first && w > 0.0f) || crossed) {
      const uint2 a = tkeys[2 * s], b = tkeys[2 * s + 1];
      const float u0 =
          t == 0 ? u0_first
                 : uniform_from_bits(
                       random_bits(a.x, a.y, static_cast<uint32_t>(l)));
      float key;
      if (is_first) {
        key = xla_log_key(u0, w);
      } else {
        const float t_w =
            xla_exp(fminf(fmaxf(__fmul_rn(w, lk_max), -80.0f), 0.0f));
        const float u2 = fma32(u0, __fsub_rn(1.0f, t_w), t_w);
        key = xla_log_key(fminf(fmaxf(u2, eps38), 1.0f), w);
      }
      if (j + tile < deg) {  // the next threshold, unless this was the last edge
        const float u1 = uniform_from_bits(
            random_bits(b.x, b.y, static_cast<uint32_t>(l)));
        thresh = __fdiv_rn(xla_log(u1), key < 0.0f ? key : tiny);
      }
      cumw = 0.0f;
      nbr_best = static_cast<int32_t>(nbr);
      lk_max = key;
    } else {
      cumw = __fadd_rn(cumw, w);
    }
  }
  lk = lk_max;
  nbr_out = nbr_best;
}

// The warp's best (key, lane) with its neighbour, in every thread, from
// one candidate a thread.
__device__ __forceinline__ Best warp_best_nbr(Best b, int32_t& nbr) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    Best o;
    o.key = __shfl_down_sync(0xffffffffu, b.key, s);
    o.idx = __shfl_down_sync(0xffffffffu, b.idx, s);
    const int32_t n = __shfl_down_sync(0xffffffffu, nbr, s);
    if (better(o, b)) {
      b = o;
      nbr = n;
    }
  }
  nbr = __shfl_sync(0xffffffffu, nbr, 0);
  return Best{__shfl_sync(0xffffffffu, b.key, 0),
              __shfl_sync(0xffffffffu, b.idx, 0)};
}

// Next node of walker `wc` (per-step key (k0, k1)) by A-ExpJ over lanes of
// `tile`, or -1 when no neighbour has a positive weight, by `warps` warps:
// warp `warp` runs lanes 32 warp, 32 (warp + warps), ...  With one warp
// (warps = 1) every thread gets the result; with several, the block's
// threads meet at __syncthreads and thread 0 gets it (`red_*` are shared
// arrays of `warps` entries).
__device__ __forceinline__ int64_t ervs_jump_select(
    const Graph& g, const Rule& rule, const JumpWalker& jw, uint32_t k0,
    uint32_t k1, int tile, int warp, int warps, int lane, uint2* tkeys,
    float* red_key, int32_t* red_idx, int32_t* red_nbr) {
  const int lanes = min(tile, jw.ctx.deg_cur);
  Best best{-CUDART_INF_F, INT32_MAX};
  int32_t best_nbr = -1;  // neighbour held by this thread's best lane
  for (int base = 32 * warp; base < lanes; base += 32 * warps) {
    float lk;
    int32_t nbr;
    jump_warp_pass(g, rule, jw, k0, k1, tile, lanes, base, lane, tkeys, lk,
                   nbr);
    if (lk > best.key) {  // lanes rise: first max kept
      best = Best{lk, base + lane};
      best_nbr = nbr;
    }
  }
  {  // lane l sits in thread l % 32
    const Best top = warp_best(best);
    const int32_t win = __shfl_sync(0xffffffffu, top.idx, 0);
    best_nbr = __shfl_sync(0xffffffffu, best_nbr,
                           win == INT32_MAX ? 0 : (win & 31));
    best = Best{__shfl_sync(0xffffffffu, top.key, 0), win};
  }
  if (warps > 1) {
    if (lane == 0) {
      red_key[warp] = best.key;
      red_idx[warp] = best.idx;
      red_nbr[warp] = best_nbr;
    }
    __syncthreads();
    if (warp == 0) {
      const bool on = lane < warps;
      best = Best{on ? red_key[lane] : -CUDART_INF_F,
                  on ? red_idx[lane] : INT32_MAX};
      best_nbr = on ? red_nbr[lane] : -1;
      best = warp_best_nbr(best, best_nbr);
    }
    __syncthreads();  // the shared arrays are free again
  }
  if (best.key == -CUDART_INF_F) return -1;
  return best_nbr;
}

}  // namespace repro
