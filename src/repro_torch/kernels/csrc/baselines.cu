// K9-K12 -- the Table 2 baseline samplers' row kernels on Hopper.
//
// Replace the reference's padded-block step functions (plain jnp there,
// repro/core/baselines.py; the published systems are GPU kernels):
//   K9  its_row         its_step          :51   C-SAW's inverse transform
//   K10 rvs_prefix_row  rvs_prefix_step   :69   FlowWalker's prefix reservoir
//   K11 als_row         als_step          :108  Skywalker's per-step alias build
//   K12 row_max         rjs_maxreduce_step :89  NextDoor's full-row max (then
//                                              K2 and K9, from the wrapper)
// Each keeps its baseline's full-row work and drops only the padding to the
// global power of two `pad`: a warp serves one walker over its OWN row, and
// gives the plain padded version's bits (repro_torch/core/baselines.py).
//
// Arithmetic orders.  The reference's jnp.cumsum runs on XLA's CPU as a
// recursive scan with base 16 (repro_torch/kernels/ref.py xla_cumsum): a
// 16-chunk is scanned sequentially and the chunk's prefix adds the
// exclusive prefix of the chunk totals, scanned the same way one level up.
// No prefix at a real neighbour depends on pad (the padding adds zeros at
// the end), so K9 and K10 build the levels of the walker's own row in
// scratch (baselines.cuh: level totals bottom up, level prefixes top down)
// and scan the weights once more against them.  Only ITS reads positions
// past the row: its total is the prefix at pad - 1, and the padded
// positions take part in the count #{prefix <= r}; they hold a handful of
// distinct values, one group of a known number of positions per level
// (padded_count_at_most).  jnp.sum (ALS's total) is XLA's tree of 32-wide
// windows summed sequentially (ref.xla_tree_sum).  Uniforms are jax's:
// minval 0 for ITS and ALS, 1e-12 for RVS (one draw per neighbour, its
// position the counter).  Every operation is __f*_rn (and the build adds
// -fmad=false).
//
// Scratch: the wrapper lays out each walker's words at offs[i]
// (repro_torch/kernels/baselines.py scratch_words): K9 / K10 the weights
// [n], then each upper level's entries, then each upper level's prefixes;
// K11 q [n], the alias column [n], the two stacks in one array [n] (small
// from the bottom, large from the top: together they never hold more than
// n lanes), then the upper levels of the 32-wide sum.
#include <cuda_runtime.h>
#include <cstdint>

#include "baselines.cuh"

namespace repro {

constexpr int kIts = 0;
constexpr int kRvs = 1;
constexpr int kAls = 2;
constexpr int kRowThreads = 128;  // 4 walkers a block

// K9 / K10: a warp per walker.
template <int KIND>
__global__ void __launch_bounds__(kRowThreads)
prefix_row_kernel(Graph g, Rule rule, const int64_t* __restrict__ cur,
                  const int64_t* __restrict__ prev,
                  const int64_t* __restrict__ step,
                  const int32_t* __restrict__ ring,
                  const int64_t* __restrict__ keys, int n, int64_t pad,
                  const int64_t* __restrict__ offs, float* scratch,
                  int64_t* __restrict__ out, GenLeaves leaves) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // whole warps exit together
  const RowWalker rw = row_walker(g, rule, cur, prev, step, ring, leaves, i);
  if (rw.deg == 0) {
    if (lane == 0) out[i] = -1;
    return;
  }
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * i]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * i + 1]);
  ScanLevels lv = scan_levels(scratch + offs[i], rw.deg);
  eval_row(g, rule, rw, lv.lev[0], lane);
  build_scan_levels(lv, lane);
  if (KIND == kIts) {
    // the total, the draw and the padded positions' groups: one lane
    float total = 0.0f, r = 0.0f;
    int64_t pad_count = 0;
    if (lane == 0) {
      total = scan_prefix_chain(lv, 0, pad - 1);
      r = __fmul_rn(uniform0_from_bits(random_bits(k0, k1, 0u)), total);
      pad_count = padded_count_at_most(lv, pad, r);
    }
    total = __shfl_sync(kFullWarp, total, 0);
    r = __shfl_sync(kFullWarp, r, 0);
    const int64_t count = count_at_most(lv, r, lane) + pad_count;
    if (lane == 0) {
      const int64_t sel = count < pad - 1 ? count : pad - 1;
      out[i] = total > 0.0f && sel < rw.deg ? g.indices[rw.start + sel] : -1;
    }
  } else {
    const int last = last_accept(lv, k0, k1, lane);
    if (lane == 0) out[i] = last >= 0 ? g.indices[rw.start + last] : -1;
  }
}

// K11: a warp per walker; lane 0 runs the serial build.
__global__ void __launch_bounds__(kRowThreads)
als_row_kernel(Graph g, Rule rule, const int64_t* __restrict__ cur,
               const int64_t* __restrict__ prev,
               const int64_t* __restrict__ step,
               const int32_t* __restrict__ ring,
               const int64_t* __restrict__ keys, int n,
               const int64_t* __restrict__ offs, float* scratch,
               int64_t* __restrict__ out, GenLeaves leaves) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const RowWalker rw = row_walker(g, rule, cur, prev, step, ring, leaves, i);
  if (rw.deg == 0) {
    if (lane == 0) out[i] = -1;
    return;
  }
  const int d = rw.deg;
  float* q = scratch + offs[i];
  int32_t* alias = reinterpret_cast<int32_t*>(q + d);
  int32_t* stk = alias + d;
  float* lev = reinterpret_cast<float*>(stk + d);
  eval_row(g, rule, rw, q, lane);
  const float total = tree_sum32(q, d, lev, lane);
  const VoseStacks st = vose_stacks(q, alias, stk, d, total, lane);
  if (lane == 0) {
    vose_build(q, alias, stk, d, st);
    const uint32_t k0 = static_cast<uint32_t>(keys[2 * i]);
    const uint32_t k1 = static_cast<uint32_t>(keys[2 * i + 1]);
    const float u0 = uniform0_from_bits(random_bits(k0, k1, 0u));
    const float u1 = uniform0_from_bits(random_bits(k0, k1, 1u));
    int col = __float2int_rz(__fmul_rn(u0, __int2float_rn(d)));
    col = col < d - 1 ? col : d - 1;
    const int32_t a = alias[col];
    const float p = a >= 0 ? q[col] : 1.0f;
    const int sel = u1 < p ? col : (a >= 0 ? a : col);
    out[i] = total > 0.0f ? g.indices[rw.start + sel] : -1;
  }
}

// K12: a warp per walker, the exact max of the clamped weights (the
// padding's 0 too when the row is shorter than pad).
__global__ void __launch_bounds__(256)
row_max_kernel(Graph g, Rule rule, const int64_t* __restrict__ cur,
               const int64_t* __restrict__ prev,
               const int64_t* __restrict__ step,
               const int32_t* __restrict__ ring, int n, int64_t pad,
               float* __restrict__ out, GenLeaves leaves) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const RowWalker rw = row_walker(g, rule, cur, prev, step, ring, leaves, i);
  float m = -CUDART_INF_F;
  int cursor = rw.p_begin - 1;
  for (int j = lane; j < rw.deg; j += 32) {
    m = fmaxf(m, row_weight(g, rule, rw, j, cursor));
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(kFullWarp, m, s));
  }
  if (rw.deg < pad) m = fmaxf(m, 0.0f);
  if (lane == 0) out[i] = m;
}

}  // namespace repro

// `kind`: 0 K9 (its_row), 1 K10 (rvs_prefix_row), 2 K11 (als_row).
// `offs` [n]: each walker's first scratch word; `leaves`: kMaxGenLeaves
// pointers to the wstate leaves a generated rule reads (null for a hand
// rule).
extern "C" int repro_baseline_rows(int kind, const int32_t* indptr,
                                   const int32_t* indices, const float* h,
                                   const int32_t* labels,
                                   const repro::Rule* rule_in,
                                   const int64_t* cur, const int64_t* prev,
                                   const int64_t* step, const int32_t* ring,
                                   void* const* leaves, const int64_t* keys,
                                   int n, int64_t pad, const int64_t* offs,
                                   float* scratch, int64_t* out,
                                   void* stream) {
  const repro::Graph g{indptr, indices, h, labels};
  const repro::GenLeaves L = repro::gen_leaves(leaves);
  const repro::Rule rule = *rule_in;
  auto s = static_cast<cudaStream_t>(stream);
  const int threads = repro::kRowThreads;
  const int blocks = static_cast<int>(
      (static_cast<int64_t>(n) * 32 + threads - 1) / threads);
  switch (kind) {
    case repro::kIts:
      repro::prefix_row_kernel<repro::kIts><<<blocks, threads, 0, s>>>(
          g, rule, cur, prev, step, ring, keys, n, pad, offs, scratch, out,
          L);
      break;
    case repro::kRvs:
      repro::prefix_row_kernel<repro::kRvs><<<blocks, threads, 0, s>>>(
          g, rule, cur, prev, step, ring, keys, n, pad, offs, scratch, out,
          L);
      break;
    case repro::kAls:
      repro::als_row_kernel<<<blocks, threads, 0, s>>>(
          g, rule, cur, prev, step, ring, keys, n, offs, scratch, out, L);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_row_max(const int32_t* indptr, const int32_t* indices,
                             const float* h, const int32_t* labels,
                             const repro::Rule* rule_in, const int64_t* cur,
                             const int64_t* prev, const int64_t* step,
                             const int32_t* ring, void* const* leaves, int n,
                             int64_t pad, float* out, void* stream) {
  const repro::Graph g{indptr, indices, h, labels};
  const repro::GenLeaves L = repro::gen_leaves(leaves);
  const repro::Rule rule = *rule_in;
  const int threads = 256;
  const int blocks = static_cast<int>(
      (static_cast<int64_t>(n) * 32 + threads - 1) / threads);
  repro::row_max_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      g, rule, cur, prev, step, ring, n, pad, out, L);
  return static_cast<int>(cudaGetLastError());
}
