// eRVS reservoir selection of one walker by one warp, exponential keys
// ln(u)/w over the row, first offset holding the maximum key wins: the
// device code of kernel K1's plain instance (ervs.cu) and of the fused
// epoch K4's reservoir regime (megastep.cu).  The jump instance is
// ervs_jump.cuh.
// The reference's logical tiling feeds the RNG: offset j is lane j % tile
// of tile t = j / tile, and its uniform is that lane of
// uniform(fold_in(key, t)).  An edge's key is __fdiv_rn(logf(u), w) for
// w > 0, else -inf; the largest key wins, the lowest offset on equal keys,
// and the result is -1 when the best key is -inf.
//
// What bounds the scan on the H100: one Threefry-2x32 per scanned edge,
// integer work (20 rounds of add, rotate, xor: the rotates and xors are
// 42 SHF / LOP3 that only the integer ALU runs, 64 lanes an SM a clock,
// among ~70 instructions an edge to issue at 128 an SM a clock).  A walker
// on a hub scans the hub's row every step it stays there: ~10^11 edges a
// step on deepwalk's mid-walk lanes.  Bytes come second (4 B of h an
// edge; many warps scan the same hub rows, which stay in L2).  So the
// design keeps every other instruction off the edge:
//   * offsets without division: a pass of the warp covers 32 offsets, and
//     a thread steps its offset's tile and lane in the tile by 32 with one
//     compare, from quotients taken once per launch (ScanTile).  When the
//     tile is a multiple of 32 (the engine's 256), a pass lies in one
//     tile and the warp walks the row tile by tile, with no compare;
//   * tile keys once per warp: lane k folds tile w0 + k of a window of 32
//     and the warp takes a new tile's key by shuffle: one fold a thread
//     per 32 tiles, not one per tile a thread crosses;
//   * filter, then verify: a conservative bound of the key (MUFU.LG2 and a
//     multiply-add, may_beat) against the thread's running best decides
//     whether the exact logf and __fdiv_rn run.  A thread's offsets rise,
//     so only a strictly greater exact key replaces its best, and about
//     ln(n) of its n edges do.  The exact key is the unfiltered scan's
//     arithmetic, so the scan chooses exactly what the unfiltered one does;
//     the cross-thread tie rule stays in warp_best;
//   * one edge loop per rule class (scan_row<RC, W>), chosen once per
//     walker step: DeepWalk and PPR-Nibble read h (nothing when
//     unweighted), MetaPath its label too, and only Node2Vec, 2nd-order
//     PageRank and visited-avoiding read each edge's neighbour; the others
//     read the winner's once.  A generated rule (kScanGenerated) reads
//     what its generated_weight reads (kGenReads*, weights.cuh).  An edge's reads are issued before its
//     Threefry, which does not wait on them;
//   * the dist(v', u) test walks a cursor per thread through v''s sorted
//     row (search_from; a thread's neighbours rise with its offsets) in
//     place of a binary search of the whole row per edge;
//   * the loop is a function of its own (scan_row_call), whose registers
//     stay apart from the kernel's.  Short rows (most walker steps) wait on
//     their dependent reads, so what they need is warps in flight: K1's
//     kernel and K4's reservoir instances are held to 40 registers.  An
//     inline pass for rows of at most 32 edges made those rows 7% faster
//     on an H100 but the hub rows, where the time goes, 3-5% slower
//     (PERF.md, PR 18), so every row takes the loop.
// K4's other regimes scan a row only on their rare paths (an eRJS
// fallback, a stale table row).  There they keep the unfiltered loop
// (ervs_warp_select_unfiltered), which chooses the same: on an H100 the
// new scan, inline or as a call, cost their epoch loop registers and
// their common steps 6-18% (PERF.md, PR 18).
// Not done: 16-byte loads.  A warp-wide 4 B load is one 128-B line already,
// 1/32 of an instruction an edge against ~70 for the Threefry and the
// uniform; a peeled head and tail would add more than they save.  Nor two
// edges a thread a pass (two Threefry chains side by side): measured, it
// gained nothing, since 40-48 warps an SM already hide the chain.
//
// The 32 threads of a warp stride over the walker's OWN degree (never a
// padded maximum), so the row reads coalesce.  Every thread of the warp must
// call ervs_warp_select with the same walker; all get its result.
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
    o.key = __shfl_down_sync(kFullWarp, b.key, s);
    o.idx = __shfl_down_sync(kFullWarp, b.idx, s);
    if (better(o, b)) b = o;
  }
  return b;
}

__device__ __forceinline__ float log_key(float u, float w) {
  return w > 0.0f ? __fdiv_rn(logf(u), w) : -CUDART_INF_F;
}

// lg2.approx of a normal float (MUFU.LG2; u is never subnormal).
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Whether an edge of uniform u and weight w > 0 may have a key
// log_key(u, w) above `best`.  Conservative: an edge it rejects never
// replaces the best.  Proof:
//   Rounding is monotone, so a key above best needs L / w > best in exact
//   arithmetic, L = logf(u); that is L > P = best * w.  logf is within 1
//   ulp, so L <= ln u (1 - 2^-23) (ln u < 0).  la = lg2.approx(u) is within
//   2^-22 (1 + |la|) of log2 u (2^-22 absolute on [0.5, 2), 2 ulp
//   elsewhere: CUDA's bound for __log2f).  With m = 2^-18,
//   c = fma(la, ln2 (1 - m), ln2 m) exceeds ln u by at least
//   ln2 (m - 2^-22 - 2^-23) (1 + |la|) before its own rounding (2^-24
//   relative, like that of the two constants), so c >= L + 2^-20 (1 + |L|).
//   p, best * w rounded, is at most P + 2^-24 |P| + 2^-150.  If L > P,
//   both negative, then |P| > |L| >= 1.19e-7 (u <= 1 - 2^-23):
//   |P| <= 2 |L| gives p < L + 2^-23 |L| + 2^-150 < c, and |P| > 2 |L|
//   gives p < -2 |L| (1 - 2^-24) + 2^-150 < L < c.  So c > p.
//   Edge cases: best = -inf (nothing yet) gives p = -inf, so every edge
//   passes; a product that overflows is -inf and passes; one that
//   underflows has |P| < 2^-126 < |L|, so L > P is false and rejecting is
//   right.  w = +inf: the key is -0.0, above best iff best < 0, where
//   p = -inf and the edge passes; best = -0.0 gives p = NaN, and
//   -0.0 > -0.0 is false.  Subnormal and huge w are covered by the
//   argument as it stands (u is never subnormal: u >= 1e-12).  w = 0
//   never comes here: its key is -inf.
__device__ __forceinline__ bool may_beat(float u, float w, float best) {
  constexpr float kA = 0x1.62e3d8p-1f;  // ln 2 (1 - 2^-18), rounded
  constexpr float kB = 0x1.62e43p-19f;  // ln 2 * 2^-18, rounded
  return __fmaf_rn(lg2_approx(u), kA, kB) > __fmul_rn(best, w);
}

// The logical tile as a thread steps through it: offset `lane` lies in
// tile lane_t at lane lane_r of it; 32 offsets on, the tile moves by
// step_t and the lane by step_r, with at most one carry.  Taken once per
// scan, dividing only for a tile below 32, so the scan itself divides by
// nothing.
struct ScanTile {
  int tile, lane_t, lane_r, step_t, step_r;
  bool whole;  // tile % 32 == 0: a pass of the warp lies in one tile
};

__device__ __forceinline__ ScanTile scan_tile(int tile, int lane) {
  if (tile >= 32) {  // offsets 0..31 lie in tile 0: no division
    const bool one = tile == 32;
    return ScanTile{tile, 0, lane, one ? 1 : 0, one ? 0 : 32,
                    (tile & 31) == 0};
  }
  return ScanTile{tile, lane / tile, lane % tile, 32 / tile, 32 % tile, false};
}

// Rule classes of the edge loop, by what an edge's weight reads.
constexpr int kScanH = 0;         // DeepWalk, PPR-Nibble: w = h
constexpr int kScanMetaPath = 1;  // [label == the step's label] * h
constexpr int kScanDist = 2;      // Node2Vec, 2nd-order PageRank: f[dist] * h
constexpr int kScanVisited = 3;   // the same, 0 for a neighbour in the ring
constexpr int kScanGenerated = 4; // PROGRAM_GENERATED: generated_weight

// One walker's scan: its row, the step key, and the rule's per-walker
// constants.  The dist rules' weight is f[dist(v', u)] * h: Node2Vec's
// factors (1/a, 1, 1/b), or 2nd-order PageRank's
// ((1-g)/d(v) + [dist = 1] g/d(v')) * max(d(v), d(v')) taken once a walker.
struct ScanArgs {
  Graph g;
  int64_t start;       // the row's first edge (scanned from here)
  uint32_t t0;         // the logical tile of `start`, which keys the RNG
  int64_t prev;        // v', -1 before the first step
  const int32_t* ring;  // visited-avoiding: the walker's ring
  uint32_t k0, k1;     // the step key
  int deg;
  int p_begin, p_end;  // v''s row (the dist rules, v' >= 0)
  int label;           // MetaPath: the schema's label at this step
  int window;          // visited-avoiding: the ring's length
  float f0, f1, f2;    // the dist rules' factors at dist 0, 1, 2
};

// What an edge's weight reads (h is 1 for an unweighted rule).
struct EdgeIn {
  float h;
  int32_t nbr, label;
};

template <int RC, bool W>
__device__ __forceinline__ EdgeIn load_edge(const Graph& g, int64_t pos) {
  EdgeIn e{1.0f, -1, 0};
  if (W) e.h = __ldg(g.h + pos);
  if (RC == kScanMetaPath) e.label = __ldg(g.labels + pos);
  if (RC == kScanDist || RC == kScanVisited) e.nbr = __ldg(g.indices + pos);
  if (RC == kScanGenerated) {
    if (kGenReadsLabel) e.label = __ldg(g.labels + pos);
    if (kGenReadsNbr) e.nbr = __ldg(g.indices + pos);
  }
  return e;
}

// The edge's w~, clamped at 0, with the operations of edge_weight
// (weights.cuh) in the same order, so the bits are the same.
// `wc`: the walker, read by a generated rule only.
template <int RC, bool W>
__device__ __forceinline__ float scan_weight(const ScanArgs& a,
                                             const EdgeIn& e, int& cursor,
                                             const WalkerCtx* wc) {
  float x = e.h;
  if constexpr (RC == kScanGenerated) {
#ifdef REPRO_GENERATED_RULE
    x = generated_weight(*wc, e.h, e.label, e.nbr, [&]() -> long long {
      return a.prev < 0 ? 1
             : e.nbr == a.prev
                 ? 0
                 : (search_from(a.g.indices, cursor, a.p_begin, a.p_end,
                                e.nbr) ? 1 : 2);
    });
#endif
  } else if (RC == kScanMetaPath) {
    x = __fmul_rn(e.label == a.label ? 1.0f : 0.0f, e.h);
  } else if (RC == kScanDist || RC == kScanVisited) {
    bool tabu = false;
    if (RC == kScanVisited) {
      for (int i = 0; i < a.window; ++i) tabu |= a.ring[i] == e.nbr;
    }
    if (tabu) {
      x = 0.0f;
    } else {
      const int d = a.prev < 0 ? 1
                    : e.nbr == a.prev
                        ? 0
                        : (search_from(a.g.indices, cursor, a.p_begin,
                                       a.p_end, e.nbr) ? 1 : 2);
      x = __fmul_rn(d == 0 ? a.f0 : (d == 1 ? a.f1 : a.f2), e.h);
    }
  }
  return fmaxf(x, 0.0f);
}

// This thread's best (key, offset) over offsets lane, lane + 32, ... of
// the walker's row; the whole warp calls it together.  Full passes of the
// warp run without a bounds test, a last, partial one masks its lanes.
// When a pass lies in one tile (st.whole), the warp walks the row tile by
// tile and takes each tile's key from the window by one shuffle; else each
// thread steps its tile and lane, and a thread that enters a tile takes its
// key from the window (one vote a pass says whether any did).
template <int RC, bool W>
__device__ __forceinline__ Best scan_row(const ScanArgs& a,
                                         const ScanTile& st, int lane,
                                         const WalkerCtx* wc = nullptr) {
  Best best{-CUDART_INF_F, INT32_MAX};
  uint32_t tk0, tk1;  // the key of this thread's tile
  int w0 = -32;       // the warp's window of keys, tiles w0 + lane (none yet)
  uint32_t wk0 = 0, wk1 = 0;
  int cursor = a.p_begin - 1;  // v''s row, not placed yet
  // offset j, lane r of its tile, if `on`
  auto edge = [&](int j, int r, bool on) {
    if (!on) return;
    const EdgeIn e = load_edge<RC, W>(a.g, a.start + j);
    auto draw = [&] {
      return uniform_from_bits(
          random_bits(tk0, tk1, static_cast<uint32_t>(r)));
    };
    // the draw first, so the edge's reads land while it runs; MetaPath,
    // whose weight is mostly 0, draws only for a positive weight
    float u = RC == kScanMetaPath ? 0.0f : draw();
    const float w = scan_weight<RC, W>(a, e, cursor, wc);
    if (RC == kScanMetaPath && w > 0.0f) u = draw();
    if ((w > 0.0f) & may_beat(u, w, best.key)) {
      const float lk = __fdiv_rn(logf(u), w);
      if (lk > best.key) best = Best{lk, j};  // offsets rise: first max kept
    }
  };
  if (st.whole) {
    // every pass in one tile: the tile's key is the warp's, by one shuffle
    // from the window when the warp enters it (tile 0's, folded by all)
    fold_in(a.k0, a.k1, a.t0, tk0, tk1);
    for (int t = 0, base = 0; base < a.deg; ++t, base += st.tile) {
      if (t > 0) {  // warp-uniform
        if (t - w0 >= 32) {
          w0 = t;
          fold_in(a.k0, a.k1, a.t0 + static_cast<uint32_t>(w0 + lane), wk0,
                  wk1);
        }
        tk0 = __shfl_sync(kFullWarp, wk0, t - w0);
        tk1 = __shfl_sync(kFullWarp, wk1, t - w0);
      }
      const int stop = min(st.tile, a.deg - base);  // the tile's offsets
      const int full = stop & ~31;
      int r = lane;
      for (; r < full; r += 32) edge(base + r, r, true);
      if (full < stop) edge(base + r, r, r < stop);
    }
    return best;
  }
  // any other tile: each thread steps its tile and lane with a carry
  int t = st.lane_t, r = st.lane_r;
  fold_in(a.k0, a.k1, a.t0 + static_cast<uint32_t>(t), tk0, tk1);
  // 32 offsets on; a thread that entered a tile and is `on` there takes
  // the tile's key (every thread comes here)
  auto advance = [&](bool on) {
    r += st.step_r;
    t += st.step_t;
    bool moved = st.step_t > 0;
    if (r >= st.tile) {
      r -= st.tile;
      ++t;
      moved = true;
    }
    const bool want = moved && on;
    if (__any_sync(kFullWarp, want)) {
      if (__any_sync(kFullWarp, want && t - w0 >= 32)) {  // past the window
        w0 = __shfl_sync(kFullWarp, t, 0);  // lane 0 holds the lowest tile
        fold_in(a.k0, a.k1, a.t0 + static_cast<uint32_t>(w0 + lane), wk0,
                wk1);
      }
      const int src = (t - w0) & 31;
      const uint32_t x0 = __shfl_sync(kFullWarp, wk0, src);
      const uint32_t x1 = __shfl_sync(kFullWarp, wk1, src);
      if (want) {
        tk0 = x0;
        tk1 = x1;
      }
    }
  };
  const int full = a.deg & ~31;  // the offsets of full passes
  int j = lane;
  for (; j < full; j += 32) {  // warp-uniform: full is a multiple of 32
    edge(j, r, true);
    advance(j + 32 < a.deg);
  }
  if (full < a.deg) edge(j, r, j < a.deg);
  return best;
}

// scan_row as a function of its own: K1's kernel and K4's eight share one
// copy of each instance (K4's build time; and a call of its own keeps the
// long loop's registers apart from the kernel's).
template <int RC, bool W>
__device__ __noinline__ Best scan_row_call(const ScanArgs a,
                                           const ScanTile st, int lane) {
  return scan_row<RC, W>(a, st, lane);
}

// The generated rule's scan, a function of its own like scan_row_call; it
// also takes the walker, which generated_weight reads.
template <bool W>
__device__ __noinline__ Best scan_row_generated(const ScanArgs a,
                                                const ScanTile st, int lane,
                                                const WalkerCtx wc) {
  return scan_row<kScanGenerated, W>(a, st, lane, &wc);
}

// The scan of rule class RC.
template <int RC>
__device__ __forceinline__ Best scan_rule(bool weighted, const ScanArgs& a,
                                          const ScanTile& st, int lane) {
  return weighted ? scan_row_call<RC, true>(a, st, lane)
                  : scan_row_call<RC, false>(a, st, lane);
}

// The warp's winner: its neighbour, or -1 when the best key is -inf.
__device__ __forceinline__ int64_t warp_winner(const Graph& g, int64_t start,
                                               Best top) {
  top = warp_best(top);
  const int32_t win = __shfl_sync(kFullWarp, top.idx, 0);
  const float win_key = __shfl_sync(kFullWarp, top.key, 0);
  if (win_key == -CUDART_INF_F) return -1;
  return static_cast<int64_t>(g.indices[start + win]);
}

// The scan's inputs for walker `wc`'s whole row (per-step key (k0, k1)):
// the row, the step key and the rule's per-walker constants.
__device__ __forceinline__ ScanArgs scan_args(const Graph& g,
                                              const Rule& rule,
                                              const WalkerCtx& wc,
                                              uint32_t k0, uint32_t k1) {
  ScanArgs a;
  a.g = g;
  a.start = g.indptr[wc.cur];
  a.t0 = 0;
  a.prev = wc.prev;
  a.ring = wc.ring;
  a.k0 = k0;
  a.k1 = k1;
  a.deg = wc.deg_cur;
  a.p_begin = a.p_end = 0;
  a.label = 0;
  a.window = rule.window;
  a.f0 = a.f1 = a.f2 = 1.0f;
  if (reads_dist(rule) && wc.prev >= 0) {
    a.p_begin = g.indptr[wc.prev];
    a.p_end = g.indptr[wc.prev + 1];
  }
  switch (rule.program) {
    case PROGRAM_METAPATH: {
      int64_t s = wc.step % rule.schema_len;
      if (s < 0) s += rule.schema_len;
      a.label = rule.schema[s];
      break;
    }
    case PROGRAM_NODE2VEC:
    case PROGRAM_VISITED:
      a.f0 = rule.c0;
      a.f2 = rule.c2;
      break;
    case PROGRAM_SECOND_ORDER_PR: {
      const float dv = fmaxf(__int2float_rn(wc.deg_cur), 1.0f);
      const float dp = fmaxf(__int2float_rn(wc.deg_prev), 1.0f);
      const float base = __fdiv_rn(rule.g1, dv);
      const float dmax = fmaxf(dv, dp);
      a.f1 = __fmul_rn(__fadd_rn(base, __fdiv_rn(rule.g, dp)), dmax);
      a.f0 = a.f2 = __fmul_rn(__fadd_rn(base, 0.0f), dmax);
      break;
    }
    default:
      break;
  }
  return a;
}

// This thread's best over `a`'s row (offsets relative to a.start) by the
// scan of the rule's class; the whole warp calls it together.
__device__ __forceinline__ Best scan_dispatch(const Rule& rule,
                                              const ScanArgs& a,
                                              const ScanTile& st, int lane,
                                              const WalkerCtx& wc) {
  switch (rule.program) {
    case PROGRAM_METAPATH:
      return scan_rule<kScanMetaPath>(rule.weighted, a, st, lane);
    case PROGRAM_NODE2VEC:
      return scan_rule<kScanDist>(rule.weighted, a, st, lane);
    case PROGRAM_VISITED:
      return scan_rule<kScanVisited>(rule.weighted, a, st, lane);
    case PROGRAM_SECOND_ORDER_PR:
      return scan_rule<kScanDist>(rule.weighted, a, st, lane);
#ifdef REPRO_GENERATED_RULE
    case PROGRAM_GENERATED:
      return rule.weighted ? scan_row_generated<true>(a, st, lane, wc)
                           : scan_row_generated<false>(a, st, lane, wc);
#endif
    default:  // DeepWalk, PPR-Nibble
      return scan_rule<kScanH>(rule.weighted, a, st, lane);
  }
}

// Next node of walker `wc` (per-step key (k0, k1)), or -1 when no
// neighbour has a positive weight.  `st` is scan_tile(tile, lane), lane =
// threadIdx.x & 31.
__device__ __forceinline__ int64_t ervs_warp_select(const Graph& g,
                                                    const Rule& rule,
                                                    const WalkerCtx& wc,
                                                    uint32_t k0, uint32_t k1,
                                                    const ScanTile& st,
                                                    int lane) {
  const ScanArgs a = scan_args(g, rule, wc, k0, k1);
  return warp_winner(g, a.start, scan_dispatch(rule, a, st, lane, wc));
}

// The same choice by the unfiltered loop: a division, a fold per tile a
// thread crosses, the rule's weight and the exact key on every edge.  K4's
// rare paths run it (see the header).
__device__ int64_t ervs_warp_select_unfiltered(const Graph& g,
                                               const Rule& rule,
                                               const WalkerCtx& wc,
                                               uint32_t k0, uint32_t k1,
                                               int tile, int lane) {
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
  return warp_winner(g, start, best);
}

}  // namespace repro
