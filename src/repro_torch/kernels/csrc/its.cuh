// ITS table draw of one walker by one thread: the device code of kernel K3
// (its.cu), which the fused epoch K4 (megastep.cu) calls too.
//
// u = uniform_01(key, (0, ITS_SALT)), target u * total[v], and the first
// offset of v's inclusive float32 CDF row whose prefix exceeds the target
// (zero-weight neighbours share the previous prefix and are never landed
// on); -1 for empty or zero-total rows.
#pragma once
#include <cstdint>

#include "threefry.cuh"

namespace repro {

constexpr uint32_t kItsSalt = 0x175CDFu;

// The draw on the row of deg CDF entries at cdf[start], of total tot;
// a probe outside cdf[0 .. last] reads the nearer end.
__device__ __forceinline__ int its_row_offset(const float* __restrict__ cdf,
                                              int64_t start, int deg,
                                              float tot, uint32_t k0,
                                              uint32_t k1,
                                              int64_t last = INT64_MAX) {
  const float target = __fmul_rn(uniform_01(k0, k1, 0u, kItsSalt), tot);
  int lo = 0, hi = deg;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int64_t p = start + mid;
    if (cdf[p < 0 ? 0 : (p > last ? last : p)] <= target) lo = mid + 1;
    else hi = mid;
  }
  return (deg > 0 && tot > 0.0f) ? min(lo, deg - 1) : -1;
}

// The draw at node v of a CSR graph.
__device__ __forceinline__ int its_offset(const int32_t* __restrict__ indptr,
                                          const float* __restrict__ cdf,
                                          const float* __restrict__ total,
                                          int64_t v, uint32_t k0,
                                          uint32_t k1) {
  return its_row_offset(cdf, indptr[v], indptr[v + 1] - indptr[v], total[v],
                        k0, k1);
}

}  // namespace repro
