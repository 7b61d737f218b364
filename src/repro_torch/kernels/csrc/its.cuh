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

__device__ __forceinline__ int its_offset(const int32_t* __restrict__ indptr,
                                          const float* __restrict__ cdf,
                                          const float* __restrict__ total,
                                          int64_t v, uint32_t k0,
                                          uint32_t k1) {
  const int64_t start = indptr[v];
  const int deg = indptr[v + 1] - indptr[v];
  const float tot = total[v];
  const float target = __fmul_rn(uniform_01(k0, k1, 0u, kItsSalt), tot);
  int lo = 0, hi = deg;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[start + mid] <= target) lo = mid + 1; else hi = mid;
  }
  return (deg > 0 && tot > 0.0f) ? min(lo, deg - 1) : -1;
}

}  // namespace repro
