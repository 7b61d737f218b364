// Alias table draw of one walker by one thread: the device code of kernel
// K5 (alias.cu), which the fused epoch K4 (megastep.cu) calls too.
//
// (u1, u2) = uniform_pair_01(key, (0, ALIAS_SALT)), column
// min(int(u1 * float(deg)), deg - 1), kept iff u2 < prob[column], else the
// column's alias partner; -1 for empty or zero-total rows.
//
// alias_row_offset reads the column's prob and alias from two arrays (two
// random 32 B sectors).  alias_offset, the draw on the CSR, reads them as
// one 8 B word of the pair table (prob's bits, then the alias offset), so
// a column costs one sector; K5's reads the row's start, degree and total
// as one 16 B node record too.
#pragma once
#include <cstdint>

#include "threefry.cuh"

namespace repro {

constexpr uint32_t kAliasSalt = 0xA11A5u;

// The draw on the row of deg columns at prob[start] / alias[start], of
// total tot; alias offsets are int32, or float32 holding integers (the
// aligned streams), which convert toward zero.  A column outside
// prob[0 .. last] reads the nearer end.
template <typename A>
__device__ __forceinline__ int alias_row_offset(const float* __restrict__ prob,
                                                const A* __restrict__ alias,
                                                int64_t start, int deg,
                                                float tot, uint32_t k0,
                                                uint32_t k1,
                                                int64_t last = INT64_MAX) {
  if (deg <= 0 || !(tot > 0.0f)) return -1;
  float u1, u2;
  uniform_pair_01(k0, k1, 0u, kAliasSalt, u1, u2);
  const int col = min(__float2int_rz(__fmul_rn(u1, __int2float_rn(deg))),
                      deg - 1);
  int64_t p = start + col;
  p = p < 0 ? 0 : (p > last ? last : p);
  return u2 < prob[p] ? col : static_cast<int>(alias[p]);
}

// The draw on the row [s, s + d) of total tot, from the [E] pair table.
__device__ __forceinline__ int alias_pair_offset(const int2* __restrict__ pair,
                                                 int s, int d, float tot,
                                                 uint32_t k0, uint32_t k1) {
  if (d <= 0 || !(tot > 0.0f)) return -1;
  float u1, u2;
  uniform_pair_01(k0, k1, 0u, kAliasSalt, u1, u2);
  const int col = min(__float2int_rz(__fmul_rn(u1, __int2float_rn(d))),
                      d - 1);
  const int2 pa = pair[s + col];
  return u2 < __int_as_float(pa.x) ? col : pa.y;
}

// K5's draw at node v: its row from the node's 16 B record (start, degree,
// total's bits, 0), one random read where indptr and total are two.
__device__ __forceinline__ int alias_offset(const int4* __restrict__ rec,
                                            const int2* __restrict__ pair,
                                            int64_t v, uint32_t k0,
                                            uint32_t k1) {
  const int4 r = rec[v];
  return alias_pair_offset(pair, r.x, r.y, __int_as_float(r.z), k0, k1);
}

// K4's draw at node v of a CSR graph (its walker already read indptr[v]).
__device__ __forceinline__ int alias_offset(const int32_t* __restrict__ indptr,
                                            const int2* __restrict__ pair,
                                            const float* __restrict__ total,
                                            int64_t v, uint32_t k0,
                                            uint32_t k1) {
  const int s = indptr[v];
  return alias_pair_offset(pair, s, indptr[v + 1] - s, total[v], k0, k1);
}

}  // namespace repro
