// K6 — block-jump A-ExpJ reservoir selection over 1024-weight tiles on
// Hopper.
//
// Replaces the TPU kernel repro/kernels/ervs_kernel.py:109 ervs_select
// (body _ervs_kernel :38, pallas_call :118); its plain version is
// repro_torch/kernels/ref.py:ervs_select_ref.  Each walker carries one
// A-ExpJ reservoir across the 1024-weight tiles of its row on the
// tile-aligned [R, 128] stream (row0 * 128 is the row's flat start; as
// in the reference, a row index outside [0, R) reads row 0 or R - 1):
//
//   * a tile whose sum stays below the carried threshold t_rem is retired
//     with that sum alone — no Threefry draw, no log, no prefix sum;
//   * a crossing tile builds its prefix sums and loops: the first
//     position whose prefix reaches base + t_rem (and whose weight is
//     positive; position 0 when none does) takes the reservoir, one draw
//     uniform_pair_01(seed, (draws, 0x9E3779B9)) sets its key and the next
//     threshold.
//
// Bitwise with the plain version, which is bitwise with the reference on
// the CPU: the tile sum adds 32 windows of 32 weights sequentially, then
// the window sums in window order; the prefix sums are the base-16
// recursive scan; exp and log are XLA's CPU polynomials and every
// multiply feeding an add is one fused multiply-add (xla_math.cuh; the
// plain version computes the same value exactly).  All other float ops
// are __f*_rn, and the build adds -fmad=false.
//
// Design (simple first): one warp per walker.  The warp loads a tile into
// shared memory with coalesced reads (lane l of round j reads weight
// 32j + l); lane l then owns weights [32l, 32l + 32) — window l of the
// sum and 16-chunks 2l and 2l + 1 of the scan — in a padded layout
// (index i at i + i / 32) free of bank conflicts.  Window sums meet by
// shuffles in lane order; the scan's second level runs over the 16 chunk
// totals of each 8-lane group, its third over the 4 group totals.  A
// crossing's first hit is a ballot and __ffs.  Every lane carries the
// same walker state, so every branch is warp-uniform.
//
// What bounds it on the H100: reading the row once (4 B per weight) —
// tiles are retired by their sum, draws are O(log d) per walker.  Hub
// rows stream tile after tile through one warp; a block per hub and
// staging the next tile while the warp sums this one are for later.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

#include "threefry.cuh"
#include "xla_math.cuh"

namespace repro {

constexpr int kLanes = 128;
constexpr int kSublanes = 8;
constexpr int kTile = 1024;
constexpr int kWarps = 4;  // walkers per block
constexpr int kPadded = kTile + kTile / 32;
constexpr uint32_t kErvsSalt = 0x9E3779B9u;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ int64_t clip(int64_t x, int64_t hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kWarps * 32)
ervs_block_kernel(const float* __restrict__ w2d,
                  const int32_t* __restrict__ row0,
                  const int32_t* __restrict__ degs,
                  const int64_t* __restrict__ seeds, int n,
                  int64_t rows, int32_t* __restrict__ off_out,
                  int32_t* __restrict__ draws_out,
                  int32_t* __restrict__ jumped_out) {
  __shared__ float w_sh[kWarps][kPadded];
  __shared__ float c_sh[kWarps][kPadded];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= n) return;  // whole warps exit together
  float* ws = w_sh[warp];
  float* cs = c_sh[warp];
  const int64_t r0 = row0[i];
  const int deg = degs[i];
  const uint32_t k0 = static_cast<uint32_t>(seeds[2 * i]);
  const uint32_t k1 = static_cast<uint32_t>(seeds[2 * i + 1]);
  const int n_tiles = deg > 0 ? (deg + kTile - 1) / kTile : 0;

  float best_lk = -CUDART_INF_F, t_rem = 0.0f;
  int best_off = -1, draws = 0, jumped = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int valid = min(deg - t * kTile, kTile);
    const int64_t row_t = r0 + t * kSublanes;  // the tile's first row
    if (row_t >= 0 && row_t + (valid - 1) / kLanes < rows) {
      const float* tile = w2d + row_t * kLanes;  // the tile lies inside
      for (int j = 0; j < 32; ++j) {
        const int o = 32 * j + lane;
        ws[pad(o)] = o < valid ? tile[o] : 0.0f;
      }
    } else {  // warp-uniform: only rows outside the stream come here
      for (int j = 0; j < 32; ++j) {
        const int o = 32 * j + lane;
        const int64_t r = clip(row_t + (o >> 7), rows - 1);
        ws[pad(o)] = o < valid ? w2d[r * kLanes + (o & (kLanes - 1))] : 0.0f;
      }
    }
    __syncwarp();
    // window sums, then the sum of the windows in window order
    float part = 0.0f;
    for (int j = 0; j < 32; ++j) part = __fadd_rn(part, ws[pad(32 * lane + j)]);
    float blocksum = 0.0f;
    for (int l = 0; l < 32; ++l)
      blocksum = __fadd_rn(blocksum, __shfl_sync(kFull, part, l));
    if (!(blocksum >= t_rem && blocksum > 0.0f)) {  // jump the tile
      t_rem = __fsub_rn(t_rem, blocksum);
      ++jumped;
      __syncwarp();
      continue;
    }
    // prefix sums, base-16 scan: inclusive scans of this lane's chunks
    float ce = 0.0f, co = 0.0f;
    for (int j = 0; j < 16; ++j) {
      ce = j ? __fadd_rn(ce, ws[pad(32 * lane + j)]) : ws[pad(32 * lane)];
      cs[pad(32 * lane + j)] = ce;
    }
    for (int j = 16; j < 32; ++j) {
      co = j > 16 ? __fadd_rn(co, ws[pad(32 * lane + j)])
                  : ws[pad(32 * lane + 16)];
      cs[pad(32 * lane + j)] = co;
    }
    // level 2: the 16 chunk totals of this lane's 8-lane group
    const int g = lane >> 3;
    float s = 0.0f, s_even = 0.0f, s_odd = 0.0f;
    for (int k = 0; k < 16; ++k) {
      const float e = __shfl_sync(kFull, ce, 8 * g + (k >> 1));
      const float o = __shfl_sync(kFull, co, 8 * g + (k >> 1));
      const float v = (k & 1) ? o : e;
      s = k ? __fadd_rn(s, v) : v;
      if (k == 2 * (lane & 7)) s_even = s;
      if (k == 2 * (lane & 7) + 1) s_odd = s;
    }
    // level 3: the 4 group totals
    float tot = 0.0f, excl = 0.0f;
    for (int gg = 0; gg < 4; ++gg) {
      const float gt = __shfl_sync(kFull, s, 8 * gg);
      if (gg == g) excl = tot;
      tot = gg ? __fadd_rn(tot, gt) : gt;
    }
    const float S_even = __fadd_rn(s_even, excl);
    const float S_odd = __fadd_rn(s_odd, excl);
    float before = __shfl_up_sync(kFull, S_odd, 1);
    if (lane == 0) before = 0.0f;
    for (int j = 0; j < 16; ++j)
      cs[pad(32 * lane + j)] = __fadd_rn(cs[pad(32 * lane + j)], before);
    for (int j = 16; j < 32; ++j)
      cs[pad(32 * lane + j)] = __fadd_rn(cs[pad(32 * lane + j)], S_even);
    __syncwarp();
    // the crossings of this tile
    float base = 0.0f;
    while (__fsub_rn(blocksum, base) >= t_rem) {
      const float target = __fadd_rn(base, t_rem);
      int local = 32;
      for (int j = 0; j < 32; ++j) {
        const int p = pad(32 * lane + j);
        if (cs[p] >= target && ws[p] > 0.0f) { local = j; break; }
      }
      const unsigned hits = __ballot_sync(kFull, local < 32);
      const int src = hits ? __ffs(hits) - 1 : 0;
      const int first = __shfl_sync(kFull, local, src);
      const int pos = hits ? 32 * src + first : 0;
      const float w_m = ws[pad(pos)];
      float u1, u2;
      uniform_pair_01(k0, k1, static_cast<uint32_t>(draws), kErvsSalt, u1, u2);
      const float t_w =
          xla_exp(fminf(fmaxf(__fmul_rn(w_m, best_lk), -80.0f), 0.0f));
      const float uu = best_lk == -CUDART_INF_F
                           ? u1 : fma32(u1, __fsub_rn(1.0f, t_w), t_w);
      const float lk_new =
          __fdiv_rn(xla_log(fminf(fmaxf(uu, 1e-38f), 1.0f)), fmaxf(w_m, 1e-30f));
      t_rem = __fdiv_rn(xla_log(u2), fminf(lk_new, -1e-30f));
      best_lk = lk_new;
      best_off = t * kTile + pos;
      ++draws;
      base = cs[pad(pos)];
    }
    t_rem = __fsub_rn(t_rem, __fsub_rn(blocksum, base));
    __syncwarp();  // before the next tile overwrites ws and cs
  }
  if (lane == 0) {
    off_out[i] = best_off;
    draws_out[i] = draws;
    jumped_out[i] = jumped;
  }
}

}  // namespace repro

extern "C" int repro_ervs_block_select(const float* w2d, const int32_t* row0,
                                       const int32_t* degs,
                                       const int64_t* seeds, int n,
                                       int64_t rows, int32_t* off,
                                       int32_t* draws,
                                       int32_t* jumped, void* stream) {
  const int blocks = (n + repro::kWarps - 1) / repro::kWarps;
  repro::ervs_block_kernel<<<blocks, repro::kWarps * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      w2d, row0, degs, seeds, n, rows, off, draws, jumped);
  return static_cast<int>(cudaGetLastError());
}
