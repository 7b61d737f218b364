// Device weight rules of the walk programs the kernels serve.  A Python
// weight rule cannot be traced into a hand-written kernel, so the wrapper
// passes a program id (repro_torch/kernels/rules.py) and its float32
// constants, and the kernel evaluates the rule here, with the reference's
// float32 operations: Node2Vec w = factor(dist) * h, DeepWalk w = h.
#pragma once
#include <cstdint>

namespace repro {

constexpr int PROGRAM_DEEPWALK = 0;
constexpr int PROGRAM_NODE2VEC = 1;

struct Graph {
  const int32_t* indptr;   // [V+1]
  const int32_t* indices;  // [E], sorted within each row
  const float* h;          // [E]
};

struct Rule {
  int program;
  int weighted;
  float c0;  // Node2Vec factor at dist 0 (1/a)
  float c2;  // Node2Vec factor at dist 2 (1/b)
};

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

// Node2Vec's dist(v', u): 0 if u == v', 1 if (v' -> u) is an edge, else 2;
// 1 before the first step (v' == -1).
__device__ __forceinline__ int dist_code(const Graph& g, int64_t prev, int64_t u) {
  if (prev < 0) return 1;
  if (u == prev) return 0;
  return has_edge(g, prev, u) ? 1 : 2;
}

// w~ of edge `pos` (neighbour `nbr`) for a walker whose previous node is
// `prev`, clamped at 0 like the reference's eval_weights.
__device__ __forceinline__ float edge_weight(const Graph& g, const Rule& rule,
                                             int64_t prev, int64_t pos,
                                             int64_t nbr) {
  const float h = rule.weighted ? g.h[pos] : 1.0f;
  float w = h;
  if (rule.program == PROGRAM_NODE2VEC) {
    const int d = dist_code(g, prev, nbr);
    const float f = d == 0 ? rule.c0 : (d == 1 ? 1.0f : rule.c2);
    w = __fmul_rn(f, h);
  }
  return fmaxf(w, 0.0f);
}

}  // namespace repro
