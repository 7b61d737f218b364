// Device rules of the walk programs the kernels serve.  The wrapper passes
// a program id (repro_torch/kernels/rules.py), its float32 constants and,
// for a program with on_step / should_stop hooks, a hook id; the kernels
// evaluate the rule here with the reference's float32 operations, each
// rounded on its own (__f*_rn, never an FMA).  PROGRAM_GENERATED is any
// other program: its traced weight, generated as generated_weight() by
// repro_torch/kernels/rulegen.py into generated_rule.cuh, which a source
// built with -DREPRO_GENERATED_RULE includes (each generated rule builds
// its own instances of the kernels).  The hand-written rules:
//   DeepWalk, PPR-Nibble  w = h
//   Node2Vec              w = factor(dist) * h
//   MetaPath              w = [label == schema[step mod L]] * h
//   2nd-order PageRank    w = ((1-g)/d(v) + [dist = 1] g/d(v'))
//                             * max(d(v), d(v')) * h, d clamped at 1
//   visited-avoiding      w = nbr in the walker's ring ? 0 : Node2Vec's w
// and PPR-Nibble's hooks (K4): mass *= 1-alpha on a step, stop when
// mass < eps * d(v).  HOOK_GENERATED is any other program's hooks, generated
// into the same header as generated_on_step() / generated_should_stop().
// A generated rule reads the walker's wstate leaves through GenState (one
// walker's leaves: a scalar by value, a vector of at most kMaxGenWidth as a
// pointer to the walker's row of its [W, width] array), loaded from the
// leaves' arrays (GenLeaves, one pointer a leaf) by gen_state().
#pragma once
#include <cstdint>

namespace repro {

constexpr unsigned kFullWarp = 0xffffffffu;

constexpr int PROGRAM_DEEPWALK = 0;
constexpr int PROGRAM_NODE2VEC = 1;
constexpr int PROGRAM_METAPATH = 2;
constexpr int PROGRAM_SECOND_ORDER_PR = 3;
constexpr int PROGRAM_VISITED = 4;
constexpr int PROGRAM_PPR_NIBBLE = 5;
constexpr int PROGRAM_GENERATED = 6;
constexpr int kMaxSchema = 8;

constexpr int HOOK_NONE = 0;
constexpr int HOOK_PPR_NIBBLE = 1;
constexpr int HOOK_GENERATED = 2;

// The most wstate leaves, and values of one a walker, a generated rule
// reads (repro_torch.kernels.rules.MAX_GEN_LEAVES / MAX_GEN_WIDTH).
constexpr int kMaxGenLeaves = 8;
constexpr int kMaxGenWidth = 64;

struct Graph {
  const int32_t* indptr;   // [V+1]
  const int32_t* indices;  // [E], sorted within each row
  const float* h;          // [E]
  const int32_t* labels;   // [E]
};

// Mirrors repro_torch.kernels.rules.RuleStruct field by field.
struct Rule {
  int program;
  int weighted;
  float c0;  // Node2Vec factor at dist 0 (1/a)
  float c2;  // Node2Vec factor at dist 2 (1/b)
  float g1;  // 2nd-order PageRank 1 - gamma
  float g;   // 2nd-order PageRank gamma
  int schema_len;
  int schema[kMaxSchema];
  int window;  // visited-avoiding ring length
};

// The arrays of a program's wstate leaves, leaf i at p[i] ([W] or
// [W, width], its dtype), null where a kernel is not given it.
struct GenLeaves {
  void* p[kMaxGenLeaves];
};

// The transition a hook sees (the staged step's transition ctx): the node
// moved to, the walker before the move, and their degrees; h is 1, label
// and dist -1.
struct HookCtx {
  int64_t cur, prev, step, nbr;
  int deg_cur, deg_prev;
};

#ifdef REPRO_GENERATED_RULE
}  // namespace repro
#include "xla_math.cuh"
#include "generated_rule.cuh"
namespace repro {
#else
constexpr bool kGenReadsLabel = false;
constexpr bool kGenReadsNbr = false;
constexpr bool kGenReadsDist = false;
constexpr bool kGenReadsDegPrev = false;
constexpr bool kGenHooks = false;
constexpr bool kGenHooksReadDegPrev = false;
constexpr bool kGenVectorState = false;  // a vector leaf: rows in memory
struct GenState {};
template <bool kAll>
__device__ __forceinline__ GenState gen_state(const GenLeaves&, int64_t) {
  return GenState{};
}
__device__ __forceinline__ void gen_state_store(const GenLeaves&, int64_t,
                                                const GenState&) {}
__device__ __forceinline__ GenState gen_state_shfl(const GenState& s, int) {
  return s;
}
__device__ __forceinline__ void generated_on_step(const HookCtx&, GenState&,
                                                  bool) {}
__device__ __forceinline__ bool generated_should_stop(const HookCtx&,
                                                      const GenState&) {
  return false;
}
#endif

// The walker's side of every candidate edge's context.
struct WalkerCtx {
  int64_t cur, prev, step;
  int deg_cur, deg_prev;
  const int32_t* ring;  // [window] of the walker (visited-avoiding), or null
  GenState gen;         // its wstate leaves (a generated rule), or empty
};

// The GenLeaves of a host array of kMaxGenLeaves pointers (null: none).
inline GenLeaves gen_leaves(void* const* p) {
  GenLeaves L{};
  for (int i = 0; p && i < kMaxGenLeaves; ++i) L.p[i] = p[i];
  return L;
}

// The leaves of walker w that a generated weight reads (none for a hand
// rule).
__device__ __forceinline__ void load_gen(WalkerCtx& wc, const GenLeaves& L,
                                         int64_t w) {
  wc.gen = gen_state<false>(L, w);
}

// Whether the rule reads dist(v', u), and so v''s row.
__device__ __forceinline__ bool reads_dist(const Rule& rule) {
  return rule.program == PROGRAM_NODE2VEC ||
         rule.program == PROGRAM_SECOND_ORDER_PR ||
         rule.program == PROGRAM_VISITED ||
         (kGenReadsDist && rule.program == PROGRAM_GENERATED);
}

// Whether the rule reads d(v').
__device__ __forceinline__ bool reads_deg_prev(const Rule& rule) {
  return rule.program == PROGRAM_SECOND_ORDER_PR ||
         (kGenReadsDegPrev && rule.program == PROGRAM_GENERATED);
}

// degrees_of(): 0 for the -1 sentinel.
__device__ __forceinline__ int degree(const Graph& g, int64_t v) {
  return v >= 0 ? g.indptr[v + 1] - g.indptr[v] : 0;
}

// deg_prev is read only by the rules that need it (reads_deg_prev).
__device__ __forceinline__ WalkerCtx walker_ctx(const Graph& g,
                                                const Rule& rule, int64_t cur,
                                                int64_t prev, int64_t step,
                                                const int32_t* ring) {
  const int deg_prev = reads_deg_prev(rule) ? degree(g, prev) : 0;
  return WalkerCtx{cur, prev, step, degree(g, cur), deg_prev, ring};
}

// Edge (v, u) exists: lower bound of u in v's sorted row.
__device__ __forceinline__ bool has_edge(const Graph& g, int64_t v, int64_t u) {
  int64_t lo = g.indptr[v];
  const int64_t end = g.indptr[v + 1];
  int64_t hi = end;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (g.indices[mid] < u) lo = mid + 1; else hi = mid;
  }
  return lo < end && g.indices[lo] == u;
}

// Whether u lies in idx[c, end), given that every entry before c is below
// u; moves c to u's lower bound.  The first search (c < begin) is a binary
// search of [begin, end); a later one gallops from c (1, 2, 4, ... entries
// on), then binary-searches the last step.  A scan whose neighbours rise
// walks one cursor through v''s row this way instead of searching it whole
// per edge.
__device__ __forceinline__ bool search_from(const int32_t* __restrict__ idx,
                                            int& c, int begin, int end,
                                            int64_t u) {
  int lo = c < begin ? begin : c, hi = end;
  if (c >= begin) {
    if (lo < end && idx[lo] < u) {
      for (int step = 1;; step <<= 1) {  // idx[lo] < u
        if (step >= end - lo) break;
        const int probe = lo + step;
        if (idx[probe] >= u) {
          hi = probe;
          break;
        }
        lo = probe;
      }
      ++lo;
    } else {
      hi = lo;
    }
  }
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (idx[mid] < u) lo = mid + 1; else hi = mid;
  }
  c = lo;
  return lo < end && idx[lo] == u;
}

// Node2Vec's dist(v', u): 0 if u == v', 1 if (v' -> u) is an edge, else 2;
// 1 before the first step (v' == -1).
__device__ __forceinline__ int dist_code(const Graph& g, int64_t prev, int64_t u) {
  if (prev < 0) return 1;
  if (u == prev) return 0;
  return has_edge(g, prev, u) ? 1 : 2;
}

__device__ __forceinline__ float n2v_weight(const Rule& rule, int d,
                                            float h) {
  return __fmul_rn(d == 0 ? rule.c0 : (d == 1 ? 1.0f : rule.c2), h);
}

// w~ of edge `pos` (neighbour `nbr`, h the edge's h or 1 when the rule is
// unweighted) for walker `w`, clamped at 0 like the reference's
// eval_weights; `dist()` gives Node2Vec's dist(v', nbr) and is called only
// by the rules that read it.
template <class Dist>
__device__ __forceinline__ float edge_weight_by(const Graph& g,
                                                const Rule& rule,
                                                const WalkerCtx& w,
                                                int64_t pos, int64_t nbr,
                                                float h, Dist dist) {
  float x = h;
  switch (rule.program) {
    case PROGRAM_NODE2VEC:
      x = n2v_weight(rule, dist(), h);
      break;
    case PROGRAM_METAPATH: {
      int64_t s = w.step % rule.schema_len;
      if (s < 0) s += rule.schema_len;
      x = __fmul_rn(g.labels[pos] == rule.schema[s] ? 1.0f : 0.0f, h);
      break;
    }
    case PROGRAM_SECOND_ORDER_PR: {
      const float dv = fmaxf(__int2float_rn(w.deg_cur), 1.0f);
      const float dp = fmaxf(__int2float_rn(w.deg_prev), 1.0f);
      const float base = __fdiv_rn(rule.g1, dv);
      const float bonus =
          dist() == 1 ? __fdiv_rn(rule.g, dp) : 0.0f;
      x = __fmul_rn(__fmul_rn(__fadd_rn(base, bonus), fmaxf(dv, dp)), h);
      break;
    }
    case PROGRAM_VISITED: {
      bool tabu = false;
      for (int i = 0; i < rule.window; ++i) tabu |= w.ring[i] == nbr;
      x = tabu ? 0.0f : n2v_weight(rule, dist(), h);
      break;
    }
#ifdef REPRO_GENERATED_RULE
    case PROGRAM_GENERATED:
      x = generated_weight(
          w, h, kGenReadsLabel ? static_cast<long long>(g.labels[pos]) : 0LL,
          nbr, [&]() -> long long { return dist(); });
      break;
#endif
    default:  // DeepWalk, PPR-Nibble: h * 1.0
      break;
  }
  return fmaxf(x, 0.0f);
}

// edge_weight_by with dist(v', nbr) from a binary search of v''s row.
__device__ __forceinline__ float edge_weight(const Graph& g, const Rule& rule,
                                             const WalkerCtx& w, int64_t pos,
                                             int64_t nbr) {
  return edge_weight_by(g, rule, w, pos, nbr,
                        rule.weighted ? g.h[pos] : 1.0f,
                        [&] { return dist_code(g, w.prev, nbr); });
}

// A program's hooks in device form (K4), mirroring
// repro_torch.kernels.rules.HookRule.
struct Hooks {
  int kind;
  float decay;  // PPR-Nibble 1 - alpha
  float eps;    // PPR-Nibble epsilon
};

}  // namespace repro
