// Device code of the baseline row kernels K9-K12 (baselines.cu): a
// walker's row read by one warp, the nested scans and sums in XLA's CPU
// orders over the walker's own row, and Skywalker's serial Vose build.
#pragma once
#include <cstdint>
#include <math_constants.h>

#include "threefry.cuh"
#include "weights.cuh"

namespace repro {

// jax.random.uniform(float32, minval=0, maxval=1) from its bits: the
// mantissa in [1, 2) minus 1 (times 1, plus 0: exact).
__device__ __forceinline__ float uniform0_from_bits(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// A walker and where its rows start: its own (cur) and the previous
// node's (for the dist(v', u) tests).
struct RowWalker {
  WalkerCtx wc;
  int64_t start;
  int deg;
  int p_begin, p_end;
};

__device__ __forceinline__ RowWalker row_walker(
    const Graph& g, const Rule& rule, const int64_t* __restrict__ cur,
    const int64_t* __restrict__ prev, const int64_t* __restrict__ step,
    const int32_t* __restrict__ ring, const GenLeaves& leaves, int i) {
  RowWalker rw;
  rw.wc = walker_ctx(
      g, rule, cur[i], prev[i], step[i],
      ring ? ring + static_cast<int64_t>(i) * rule.window : nullptr);
  load_gen(rw.wc, leaves, i);
  rw.deg = rw.wc.deg_cur;
  rw.start = rw.wc.cur >= 0 ? g.indptr[rw.wc.cur] : 0;
  const bool has_prev = rw.wc.prev >= 0;
  rw.p_begin = has_prev ? g.indptr[rw.wc.prev] : 0;
  rw.p_end = has_prev ? g.indptr[rw.wc.prev + 1] : 0;
  return rw;
}

// w~ of the walker's neighbour j, clamped at 0 (edge_weight's operations);
// dist(v', u) walks `cursor` through v''s sorted row (search_from): a
// thread's offsets, and so its neighbours, rise.  Start it at p_begin - 1.
__device__ __forceinline__ float row_weight(const Graph& g, const Rule& rule,
                                            const RowWalker& rw, int j,
                                            int& cursor) {
  const int64_t pos = rw.start + j;
  const int64_t nbr = g.indices[pos];
  return edge_weight_by(
      g, rule, rw.wc, pos, nbr, rule.weighted ? g.h[pos] : 1.0f, [&] {
        return rw.wc.prev < 0
                   ? 1
                   : (nbr == rw.wc.prev
                          ? 0
                          : (search_from(g.indices, cursor, rw.p_begin,
                                         rw.p_end, nbr) ? 1 : 2));
      });
}

// The row's weights into w [deg], the warp's lanes striding the row (the
// reads coalesce).
__device__ __forceinline__ void eval_row(const Graph& g, const Rule& rule,
                                         const RowWalker& rw, float* w,
                                         int lane) {
  int cursor = rw.p_begin - 1;
  for (int j = lane; j < rw.deg; j += 32) {
    w[j] = row_weight(g, rule, rw, j, cursor);
  }
  __syncwarp();
}

// ------------------------------------------------- base-16 scan (K9, K10)
// Level 0 is the row's n weights; level k + 1 holds the sequential sums of
// level k's 16-chunks, for every level of more than 16 entries; the top
// level K has at most 16.  A level's prefix at j is its chunk's
// sequential prefix at j plus the level above's prefix at chunk - 1 (plus
// 0 in chunk 0): ref.xla_cumsum at any pad of at least n.
constexpr int kMaxScanLevels = 9;  // 16^8 entries and more: any row

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct ScanLevels {
  int K;                        // top level
  int n[kMaxScanLevels];        // entries of level k
  float* lev[kMaxScanLevels];   // level k (lev[0]: the weights)
  float* pf[kMaxScanLevels];    // prefixes of level k >= 1
};

// The layout of a walker's scratch from `base`: the weights, every upper
// level's entries, every upper level's prefixes.
__device__ __forceinline__ ScanLevels scan_levels(float* base, int n) {
  ScanLevels lv;
  lv.K = 0;
  lv.n[0] = n;
  lv.lev[0] = base;
  int64_t words = 0;
  while (lv.n[lv.K] > 16) {
    lv.n[lv.K + 1] = (lv.n[lv.K] + 15) / 16;
    ++lv.K;
    lv.lev[lv.K] = base + n + words;
    words += lv.n[lv.K];
  }
  int64_t at = 0;
  for (int k = 1; k <= lv.K; ++k) {
    lv.pf[k] = base + n + words + at;
    at += lv.n[k];
  }
  return lv;
}

// Level totals bottom up, then the upper levels' prefixes top down.
__device__ __forceinline__ void build_scan_levels(const ScanLevels& lv,
                                                  int lane) {
  for (int k = 0; k < lv.K; ++k) {
    const float* src = lv.lev[k];
    float* dst = lv.lev[k + 1];
    const int m = lv.n[k];
    for (int c = lane; c < lv.n[k + 1]; c += 32) {
      const int end = min(16 * c + 16, m);
      float acc = src[16 * c];
      for (int j = 16 * c + 1; j < end; ++j) acc = __fadd_rn(acc, src[j]);
      dst[c] = acc;
    }
    __syncwarp();
  }
  if (lv.K == 0) return;
  if (lane == 0) {
    const float* top = lv.lev[lv.K];
    float acc = top[0];
    lv.pf[lv.K][0] = acc;
    for (int j = 1; j < lv.n[lv.K]; ++j) {
      acc = __fadd_rn(acc, top[j]);
      lv.pf[lv.K][j] = acc;
    }
  }
  __syncwarp();
  for (int k = lv.K - 1; k >= 1; --k) {
    const float* src = lv.lev[k];
    const int m = lv.n[k];
    for (int c = lane; c < lv.n[k + 1]; c += 32) {
      const float e = c >= 1 ? lv.pf[k + 1][c - 1] : 0.0f;
      const int end = min(16 * c + 16, m);
      float acc = src[16 * c];
      lv.pf[k][16 * c] = __fadd_rn(acc, e);
      for (int j = 16 * c + 1; j < end; ++j) {
        acc = __fadd_rn(acc, src[j]);
        lv.pf[k][j] = __fadd_rn(acc, e);
      }
    }
    __syncwarp();
  }
}

// Entry idx of level k, the levels past the top being the one entry that
// is the top level's sum (the pad's further levels).
__device__ __forceinline__ float level_at(const ScanLevels& lv, int k,
                                          int64_t idx) {
  if (k <= lv.K) return lv.lev[k][idx];
  const float* top = lv.lev[lv.K];
  float acc = top[0];
  for (int j = 1; j < lv.n[lv.K]; ++j) acc = __fadd_rn(acc, top[j]);
  return acc;
}

// Level k's chunk prefix at j with the zeros past its entries.
__device__ __forceinline__ float chunk_prefix(const ScanLevels& lv, int k,
                                              int64_t j) {
  const int64_t n = k <= lv.K ? lv.n[k] : 1;
  const int64_t c0 = j / 16 * 16;
  if (c0 >= n) return 0.0f;
  const int64_t last = j < n - 1 ? j : n - 1;
  float acc = level_at(lv, k, c0);
  for (int64_t t = c0 + 1; t <= last; ++t) {
    acc = __fadd_rn(acc, level_at(lv, k, t));
  }
  return acc;
}

// Level k's prefix at any position j (past the row too): its chunk
// prefix plus the level above's prefix at chunk - 1, to the top.
__device__ __forceinline__ float scan_prefix_chain(const ScanLevels& lv,
                                                   int k, int64_t j) {
  float terms[kMaxScanLevels + 1];
  int m = 0;
  for (;;) {
    terms[m++] = chunk_prefix(lv, k, j);
    if (j / 16 < 1) break;
    j = j / 16 - 1;
    ++k;
  }
  float acc = __fadd_rn(terms[m - 1], 0.0f);
  for (int t = m - 2; t >= 0; --t) acc = __fadd_rn(terms[t], acc);
  return acc;
}

// How many padded positions [n, pad) hold a prefix <= r.  They fall in
// groups of one value: at level 0 the rest of the last chunk, holding the
// prefix at n; the later chunks c hold level 1's prefix at c - 1, whose
// positions from c - 1 = n / 16 on repeat the pattern one level up.  A
// group of level-k positions [a, b] spans the level-(k - 1) positions
// [16 (a + 1), 16 (b + 1) + 15], cut at that level's last position.
__device__ __forceinline__ int64_t padded_count_at_most(const ScanLevels& lv,
                                                        int64_t pad,
                                                        float r) {
  int64_t his[kMaxScanLevels + 1];
  int64_t lo = lv.n[0], hi = pad - 1, count = 0;
  int k = 0;
  while (lo <= hi) {
    const float v = scan_prefix_chain(lv, k, lo);
    if (v <= r) {
      int64_t a = lo, b = min64(lo / 16 * 16 + 15, hi);
      for (int kk = k - 1; kk >= 0; --kk) {
        a = 16 * (a + 1);
        b = min64(16 * (b + 1) + 15, his[kk]);
      }
      count += b - a + 1;
    }
    if (hi / 16 - 1 < lo / 16) break;
    his[k] = hi;
    lo /= 16;
    hi = hi / 16 - 1;
    ++k;
  }
  return count;
}

// Level 0's prefixes, chunk by chunk (a lane a chunk): f(j, prefix) for
// each neighbour j of the lane's chunks, in rising order.
template <class F>
__device__ __forceinline__ void for_each_prefix(const ScanLevels& lv,
                                                int lane, F f) {
  const float* w = lv.lev[0];
  const int n = lv.n[0];
  for (int c = lane; 16 * c < n; c += 32) {
    const float e = c >= 1 ? lv.pf[1][c - 1] : 0.0f;
    const int end = min(16 * c + 16, n);
    float acc = w[16 * c];
    f(16 * c, __fadd_rn(acc, e));
    for (int j = 16 * c + 1; j < end; ++j) {
      acc = __fadd_rn(acc, w[j]);
      f(j, __fadd_rn(acc, e));
    }
  }
}

// K9: #{j < n : prefix_j <= r} over the warp (every lane gets it).
__device__ __forceinline__ int64_t count_at_most(const ScanLevels& lv,
                                                 float r, int lane) {
  int count = 0;
  for_each_prefix(lv, lane, [&](int, float p) { count += p <= r; });
  return __reduce_add_sync(kFullWarp, static_cast<unsigned>(count));
}

// K10: the last neighbour j with u_j * prefix_j < w_j and w_j > 0
// (u_j: jax's uniform at counter j, minval 1e-12), or -1.
__device__ __forceinline__ int last_accept(const ScanLevels& lv, uint32_t k0,
                                           uint32_t k1, int lane) {
  const float* w = lv.lev[0];
  int last = -1;
  for_each_prefix(lv, lane, [&](int j, float p) {
    const float u = uniform_from_bits(random_bits(k0, k1, j));
    const float wj = w[j];
    if (__fmul_rn(u, p) < wj && wj > 0.0f) last = j;
  });
  return __reduce_max_sync(kFullWarp, last);
}

// ------------------------------------------------------------------ K11
// jnp.sum's order (ref.xla_tree_sum): rows of more than 32 weights are
// cut into 32-wide windows summed sequentially, level by level, until at
// most 32 sums remain, which are summed sequentially.  `lev`: scratch of
// the upper levels.
__device__ __forceinline__ float tree_sum32(const float* w, int n, float* lev,
                                            int lane) {
  const float* src = w;
  int m = n;
  while (m > 32) {
    const int mm = (m + 31) / 32;
    for (int c = lane; c < mm; c += 32) {
      const int end = min(32 * c + 32, m);
      float acc = src[32 * c];
      for (int j = 32 * c + 1; j < end; ++j) acc = __fadd_rn(acc, src[j]);
      lev[c] = acc;
    }
    __syncwarp();
    src = lev;
    lev += mm;
    m = mm;
  }
  float total = 0.0f;
  if (lane == 0) {
    total = src[0];
    for (int j = 1; j < m; ++j) total = __fadd_rn(total, src[j]);
  }
  return __shfl_sync(kFullWarp, total, 0);
}

struct VoseStacks {
  int small, large;  // heights
};

// q = w n / max(total, 1e-30) over the row (in place), alias = -1 (not
// finalised), and the two stacks in lane order: the small lanes (q < 1)
// from stk[0] up, the large ones (q >= 1) from stk[n - 1] down.
__device__ __forceinline__ VoseStacks vose_stacks(float* q, int32_t* alias,
                                                  int32_t* stk, int n,
                                                  float total, int lane) {
  const float nf = __int2float_rn(n);
  const float den = fmaxf(total, 1e-30f);
  const unsigned below = (1u << lane) - 1u;
  VoseStacks st{0, 0};
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    const bool valid = j < n;
    float v = 0.0f;
    if (valid) {
      v = __fdiv_rn(__fmul_rn(q[j], nf), den);
      q[j] = v;
      alias[j] = -1;
    }
    const bool small = valid && v < 1.0f;
    const bool large = valid && v >= 1.0f;
    const unsigned sm = __ballot_sync(kFullWarp, small);
    const unsigned lg = __ballot_sync(kFullWarp, large);
    if (small) stk[st.small + __popc(sm & below)] = j;
    if (large) stk[n - 1 - (st.large + __popc(lg & below))] = j;
    st.small += __popc(sm);
    st.large += __popc(lg);
  }
  __syncwarp();
  return st;
}

// The serial two-stack build (one thread): pop the top small s and the
// top large l, finalise s (its prob is q[s], which no later step changes;
// alias[s] = l), take 1 - q[s] off q[l], and move l to the small stack
// once q[l] < 1.  Lanes never finalised keep alias -1 (prob 1, alias
// themselves).
__device__ __forceinline__ void vose_build(float* q, int32_t* alias,
                                           int32_t* stk, int n,
                                           VoseStacks st) {
  int s_top = st.small, l_top = st.large;
  while (s_top > 0 && l_top > 0) {
    const int s = stk[s_top - 1];
    const int l = stk[n - l_top];
    const float qs = q[s];
    alias[s] = l;
    const float ql = __fsub_rn(q[l], __fsub_rn(1.0f, qs));
    q[l] = ql;
    --s_top;
    if (ql < 1.0f) {
      --l_top;
      stk[s_top++] = l;
    }
  }
}

}  // namespace repro
