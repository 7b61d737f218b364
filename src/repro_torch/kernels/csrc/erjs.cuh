// eRJS trials of one walker by one thread: the device code of kernel K2
// (erjs.cu), which the fused epoch K4 (megastep.cu) calls too.
//
// Up to rounds x trials proposals: trial k of round r (trial t = r*K + k)
// draws u_idx from uniform(fold_in(key, 2t)) and u_acc from
// uniform(fold_in(key, 2t + 1)), offset = min(int(u_idx * float(deg)),
// deg - 1), and accepts iff u_acc * bound <= w && w > 0.  A walker
// unresolved after the last trial needs the reservoir fallback.
#pragma once
#include <cstdint>

#include "threefry.cuh"
#include "weights.cuh"

namespace repro {

struct ErjsResult {
  int64_t chosen;  // accepted neighbour, or -1
  bool fallback;   // feasible but unresolved: the reservoir decides
  int32_t trials;  // proposals made
};

__device__ __forceinline__ float fold_uniform(uint32_t k0, uint32_t k1,
                                              uint32_t counter) {
  uint32_t a0, a1;
  fold_in(k0, k1, counter, a0, a1);
  return uniform_from_bits(random_bits(a0, a1, 0u));
}

__device__ __forceinline__ ErjsResult erjs_trials(const Graph& g,
                                                  const Rule& rule,
                                                  const WalkerCtx& wc,
                                                  uint32_t k0, uint32_t k1,
                                                  float bound, int trials,
                                                  int rounds) {
  const int64_t start = g.indptr[wc.cur];
  const int deg = wc.deg_cur;
  const bool feasible = deg > 0 && bound > 0.0f;
  const float degf = __int2float_rn(deg);
  ErjsResult res{-1, false, 0};
  bool done = !feasible;
  for (int r = 0; r < rounds && !done; ++r) {
    for (int k = 0; k < trials && !done; ++k) {
      const uint32_t ctr = static_cast<uint32_t>(r * 2 * trials + 2 * k);
      const float u_idx = fold_uniform(k0, k1, ctr);
      const float u_acc = fold_uniform(k0, k1, ctr + 1u);
      const int off = min(__float2int_rz(__fmul_rn(u_idx, degf)), deg - 1);
      const int64_t nbr = g.indices[start + off];
      const float w = edge_weight(g, rule, wc, start + off, nbr);
      ++res.trials;
      if (__fmul_rn(u_acc, bound) <= w && w > 0.0f) {
        res.chosen = nbr;
        done = true;
      }
    }
  }
  res.fallback = feasible && !done;
  return res;
}

}  // namespace repro
