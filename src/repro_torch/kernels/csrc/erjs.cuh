// eRJS trials of the walkers of one warp, a walker per lane: the device
// code of kernel K2 (erjs.cu), which the fused epoch K4 (megastep.cu)
// calls too.
//
// Up to rounds x trials proposals a walker: trial t (trial k of round r,
// t = r*K + k) draws u_idx from uniform(fold_in(key, 2t)) and u_acc from
// uniform(fold_in(key, 2t + 1)), offset = min(int(u_idx * float(deg)),
// deg - 1), and accepts iff u_acc * bound <= w && w > 0.  The walker takes
// its first accepting trial; one unresolved after the last trial needs the
// reservoir fallback.  Trials are independent of each other (a trial
// reads only its own two counters), so any order that evaluates trials
// and keeps the lowest accepting t chooses what the sequential loop
// chooses, `used` included (t + 1, or rounds x trials for a fallback).
//
// The order here.  Round 0 (trials 0 .. K-1, erjs_round0) runs on the
// walker's own lane, one trial after another, as the per-step loop always
// did: most walkers accept there.  The walkers still pending then share
// the lanes of a warp, pass by pass (erjs_passes): with P pending, each
// takes a group of L = 32 / nextpow2(P) lanes, its context and key
// broadcast, and lane j of the group makes trial next + j, `next` being the
// walker's first trial not yet made (K after round 0).  The lowest set bit
// of the group's accepts is its lowest accepting trial of the pass; every
// lower trial was made and rejected in this pass or an earlier one (a
// walker's passes cover next, next + L, ... without a gap), so it is the
// walker's first accept.  A walker alone makes 32 trials a pass (2ndpr's
// fallbacks); many make a few each, so the warp makes few trials past a
// walker's accept (MetaPath: a third of its walkers pending after round
// 0, ~8 proposals each).  Under the rules that binary-search v''s row for
// each trial, a warp serves one walker a pass, so that the pass's 32
// searches share v''s row (their upper probes are the same addresses; on
// an H100, 2ndpr's K2 took 15% longer with the lanes split among walkers).
// No warp waits on one lane's serial trials after round 0.  K4 runs both
// parts in one loop of its epoch (erjs_trials); K2 runs round 0 and lists
// the pending walkers, and a second launch serves them (erjs.cu).
//
// Inside a trial, the gather (neighbour, h, label) is issued before the
// acceptance uniform, and that uniform's two Threefry evaluations are made
// only for w > 0: a trial with w <= 0 cannot accept whatever u_acc is
// (the test is u_acc * bound <= w && w > 0), and it still counts as a
// proposal made.
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

// Trial t of walker wc (row at `start`, deg_cur > 0, step key (k0, k1)):
// whether it accepts; its proposal's neighbour in nbr.
__device__ __forceinline__ bool erjs_trial(const Graph& g, const Rule& rule,
                                           const WalkerCtx& wc, int64_t start,
                                           uint32_t k0, uint32_t k1,
                                           float bound, int t, int64_t& nbr) {
  const int deg = wc.deg_cur;
  const uint32_t ctr = 2u * static_cast<uint32_t>(t);
  const float u_idx = fold_uniform(k0, k1, ctr);
  const int off =
      min(__float2int_rz(__fmul_rn(u_idx, __int2float_rn(deg))), deg - 1);
  nbr = g.indices[start + off];
  const float w = edge_weight(g, rule, wc, start + off, nbr);
  if (!(w > 0.0f)) return false;  // no u_acc can accept it
  return __fmul_rn(fold_uniform(k0, k1, ctr + 1u), bound) <= w;
}

// WalkerCtx field by field from lane src.
__device__ __forceinline__ WalkerCtx shfl_ctx(const WalkerCtx& wc, int src) {
  WalkerCtx c;
  c.cur = __shfl_sync(kFullWarp, static_cast<long long>(wc.cur), src);
  c.prev = __shfl_sync(kFullWarp, static_cast<long long>(wc.prev), src);
  c.step = __shfl_sync(kFullWarp, static_cast<long long>(wc.step), src);
  c.deg_cur = __shfl_sync(kFullWarp, wc.deg_cur, src);
  c.deg_prev = __shfl_sync(kFullWarp, wc.deg_prev, src);
  c.ring = reinterpret_cast<const int32_t*>(__shfl_sync(
      kFullWarp, reinterpret_cast<unsigned long long>(wc.ring), src));
  c.gen = gen_state_shfl(wc.gen, src);
  return c;
}

// Round 0 of this lane's walker: its trials 0 .. K-1 one after another,
// stopping at the first accept.  `done`: the walker needs no later round
// (it accepted, or is not `feasible`).
__device__ __forceinline__ ErjsResult erjs_round0(const Graph& g,
                                                  const Rule& rule,
                                                  const WalkerCtx& wc,
                                                  int64_t start, uint32_t k0,
                                                  uint32_t k1, float bound,
                                                  int trials, bool feasible,
                                                  bool& done) {
  ErjsResult res{-1, false, 0};
  done = !feasible;
  for (int t = 0; t < trials && !done; ++t) {
    int64_t nbr;
    ++res.trials;
    if (erjs_trial(g, rule, wc, start, k0, k1, bound, t, nbr)) {
      res.chosen = nbr;
      done = true;
    }
  }
  return res;
}

// The later rounds of the warp's walkers with `want` set (pending after
// round 0, res.trials = K), by passes of the warp as the header says: lane
// l of group l / L makes trial next + l % L of the group's pending walker
// (by rank).  Returns whether this lane's walker accepted; res holds its
// result.  Every lane of the warp calls it together.
__device__ __forceinline__ bool erjs_passes(const Graph& g, const Rule& rule,
                                            const WalkerCtx& wc, int64_t start,
                                            uint32_t k0, uint32_t k1,
                                            float bound, int trials,
                                            int budget, bool want,
                                            ErjsResult& res) {
  const int lane = threadIdx.x & 31;
  const int max_shift = reads_dist(rule) ? 0 : 5;  // at most 2^max_shift walkers
  bool done = false;
  int next = trials;  // this lane's walker's next trial
  unsigned pending = __ballot_sync(kFullWarp, want && trials < budget);
  while (pending) {  // warp-uniform
    const int P = __popc(pending);
    const int shift = min(P > 1 ? 32 - __clz(P - 1) : 0, max_shift);
    const int L = 32 >> shift;  // 2^shift groups of L lanes
    const int grp = lane >> (5 - shift);
    const int src =
        grp < P ? static_cast<int>(__fns(pending, 0, grp + 1)) : lane;
    const WalkerCtx c = shfl_ctx(wc, src);
    const int64_t c_start = __shfl_sync(kFullWarp,
                                        static_cast<long long>(start), src);
    const uint32_t c0 = __shfl_sync(kFullWarp, k0, src);
    const uint32_t c1 = __shfl_sync(kFullWarp, k1, src);
    const float c_bound = __shfl_sync(kFullWarp, bound, src);
    const int t = __shfl_sync(kFullWarp, next, src) + (lane & (L - 1));
    int64_t nbr = -1;
    const bool acc = grp < P && t < budget &&
                     erjs_trial(g, rule, c, c_start, c0, c1, c_bound, t, nbr);
    const unsigned hit = __ballot_sync(kFullWarp, acc);
    // this lane's walker, if pending and served (the first 2^shift by
    // rank): its group's accepts, the first one's neighbour
    const bool me = (pending >> lane) & 1u;
    const int rank = __popc(pending & ((1u << lane) - 1u));
    const bool mine = me && rank < (1 << shift);
    const unsigned group =
        !mine ? 0u
              : (L == 32 ? hit : (hit >> (rank * L)) & ((1u << L) - 1u));
    const int first = __ffs(group) - 1;
    const long long chosen = __shfl_sync(
        kFullWarp, static_cast<long long>(nbr), group ? rank * L + first : lane);
    if (mine) {
      if (group) {
        res.trials = next + first + 1;
        res.chosen = chosen;
        done = true;
      } else {
        next += L;
        if (next >= budget) res.trials = budget;
      }
    }
    pending = __ballot_sync(kFullWarp, me && !done && next < budget);
  }
  return done;
}

// eRJS of this lane's walker (`on`: the lane holds one), bound `bound` and
// step key (k0, k1): round 0 on the lane, then the warp's passes.  Every
// lane of the warp calls it together.
__device__ __forceinline__ ErjsResult erjs_trials(const Graph& g,
                                                  const Rule& rule,
                                                  const WalkerCtx& wc,
                                                  uint32_t k0, uint32_t k1,
                                                  float bound, int trials,
                                                  int rounds, bool on) {
  const bool feasible = on && wc.deg_cur > 0 && bound > 0.0f;
  const int64_t start = feasible ? g.indptr[wc.cur] : 0;
  bool done;
  ErjsResult res =
      erjs_round0(g, rule, wc, start, k0, k1, bound, trials, feasible, done);
  if (erjs_passes(g, rule, wc, start, k0, k1, bound, trials, trials * rounds,
                  !done, res))
    done = true;
  res.fallback = feasible && !done;
  return res;
}

}  // namespace repro
