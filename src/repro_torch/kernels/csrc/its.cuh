// ITS table draw of one walker by one thread: the device code of kernel K3
// (its.cu), which the fused epoch K4 (megastep.cu) calls too.
//
// u = uniform_01(key, (0, ITS_SALT)), target u * total[v], and the first
// offset of v's inclusive float32 CDF row whose prefix exceeds the target
// (zero-weight neighbours share the previous prefix and are never landed
// on); -1 for empty or zero-total rows.
//
// its_row_offset binary-searches the row: a dependent 4 B read a probe,
// each in its own 64 B segment until the range fits one.
// its_aligned_offset, the draw on the aligned stream, runs the same
// search probe for probe but reads a row of at most 16 entries whole
// before the Threefry.
// its_offset, the draw on the CSR, searches a fence table instead
// (fence[b] = cdf[16 b + 15], the last entry of the CDF's b-th aligned
// 64 B block; 12 MB at 48M edges, so it stays in L2) and then reads one
// block of the CDF whole.
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

// CDF entries a fence stands for: one 64 B segment of float32
constexpr int kFenceBlock = 16;

// kN entries at p into x: 16 B loads where p is 16 B aligned (kVec), else
// one 4 B load each.
template <bool kVec, int kN>
__device__ __forceinline__ void load_entries(const float* __restrict__ p,
                                             float (&x)[kN]) {
  if (kVec) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int j = 0; j < kN / 4; ++j) {
      const float4 f = q[j];
      x[4 * j] = f.x;
      x[4 * j + 1] = f.y;
      x[4 * j + 2] = f.z;
      x[4 * j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j) x[j] = p[j];
  }
}

// The binary search's levels inside one block of kN entries, from the
// range [lo, hi) of the block: bit j of le answers the probe of entry j
// (x[j] <= target), so each level reads a bit where the plain search
// reads the entry.  kLevels levels end a range of at most 2^(kLevels-1)
// entries; the bits keep the search off a register array indexed at run
// time.  Returns lo.
template <int kLevels>
__device__ __forceinline__ int search_bits(uint32_t le, int lo, int hi) {
#pragma unroll
  for (int k = 0; k < kLevels; ++k) {
    const int mid = (lo + hi) >> 1;
    const bool live = lo < hi;
    const bool right = (le >> mid) & 1u;
    lo = live && right ? mid + 1 : lo;
    hi = live && !right ? mid : hi;
  }
  return lo;
}

template <int kN>
__device__ __forceinline__ uint32_t at_or_below(const float (&x)[kN],
                                                float target) {
  uint32_t le = 0;
#pragma unroll
  for (int j = 0; j < kN; ++j) le |= (x[j] <= target ? 1u : 0u) << j;
  return le;
}

// its_row_offset on the tile-aligned stream cdf[0 .. last], whose length
// is a multiple of 128 and whose rows start at multiples of 128 (kVec:
// cdf is 16 B aligned): the same binary search, probe for probe, so it is
// bitwise on any values (non-monotone rows too).  What changes is when
// its bytes arrive.  A row of at most 16 entries is read whole (8 entries
// as one 32 B sector, 16 as the 64 B block) before the Threefry, and
// searched from registers.  A longer row, or one that starts before the
// stream or runs past its end, is its_row_offset's: a first probe in
// flight during the Threefry and the last levels read from one block
// were measured on hub rows and lost.
template <bool kVec>
__device__ __forceinline__ int its_aligned_offset(
    const float* __restrict__ cdf, int64_t start, int deg, float tot,
    uint32_t k0, uint32_t k1, int64_t last) {
  if (deg <= 0 || !(tot > 0.0f)) return -1;
  if (deg > kFenceBlock || start < 0 || start + deg - 1 > last)
    return its_row_offset(cdf, start, deg, tot, k0, k1, last);
  const float* __restrict__ row = cdf + start;
  if (deg <= kFenceBlock / 2) {
    float x[kFenceBlock / 2];
    load_entries<kVec>(row, x);
    const float target = __fmul_rn(uniform_01(k0, k1, 0u, kItsSalt), tot);
    return min(search_bits<4>(at_or_below(x, target), 0, deg), deg - 1);
  }
  float x[kFenceBlock];
  load_entries<kVec>(row, x);
  const float target = __fmul_rn(uniform_01(k0, k1, 0u, kItsSalt), tot);
  return min(search_bits<5>(at_or_below(x, target), 0, deg), deg - 1);
}

// A fence read that asks L2 to keep its line (evict_last): the fence table
// is searched by every walker and its top levels are shared.
__device__ __forceinline__ float fence_load(const float* p) {
  float v;
  asm("{\n\t.reg .b64 pol;\n\t"
      "createpolicy.fractional.L2::evict_last.b64 pol, 1.0;\n\t"
      "ld.global.nc.L2::cache_hint.f32 %0, [%1], pol;\n\t}"
      : "=f"(v)
      : "l"(p));
  return v;
}

// The draw on the row [s, s + d) of total tot of a CDF (16 B aligned) of
// n_edges entries, through its fence table.  The row covers blocks b0 =
// s / 16 to b1 = (s + d - 1) / 16; the fences of b0 .. b1 - 1 are entries
// of the row other than its last, in order.  The first of them above the
// target names the block the answer lies in (b1 if none is).  The row is
// non-decreasing, so the answer is the count of the row's entries at or
// below the target: all of those before that block, plus those of the
// block, counted from its 16 entries read as four 16 B loads.  That is the
// binary search's answer bit for bit (zero-weight plateaus, a target that
// rounds to the total).  kHinted: the fence probes ask L2 to keep their
// lines and the block is read as a stream (evict first); K3 gains by it,
// K4's ITS instance lost.
template <bool kHinted>
__device__ __forceinline__ int its_fence_offset(
    const float* __restrict__ cdf, const float* __restrict__ fence,
    int64_t n_edges, int s, int d, float tot, uint32_t k0, uint32_t k1) {
  if (d <= 0 || !(tot > 0.0f)) return -1;
  const float target = __fmul_rn(uniform_01(k0, k1, 0u, kItsSalt), tot);
  int lo = s / kFenceBlock, hi = (s + d - 1) / kFenceBlock;
  while (lo < hi) {  // the first fence above the target
    const int mid = (lo + hi) >> 1;
    if ((kHinted ? fence_load(fence + mid) : fence[mid]) <= target)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int64_t base = static_cast<int64_t>(lo) * kFenceBlock;
  float x[kFenceBlock];
  if (base + kFenceBlock <= n_edges) {
    const float4* q = reinterpret_cast<const float4*>(cdf + base);
#pragma unroll
    for (int j = 0; j < kFenceBlock / 4; ++j) {
      const float4 f = kHinted ? __ldcs(q + j) : q[j];
      x[4 * j] = f.x;
      x[4 * j + 1] = f.y;
      x[4 * j + 2] = f.z;
      x[4 * j + 3] = f.w;
    }
  } else {
    // the CDF's last block, cut short: its entries past the end are no row's
#pragma unroll
    for (int j = 0; j < kFenceBlock; ++j)
      x[j] = base + j < n_edges ? cdf[base + j] : 0.0f;
  }
  // the block's entries in the row: [from, to) of the block
  const int from = max(s - static_cast<int>(base), 0);
  const int to = min(s + d - static_cast<int>(base), kFenceBlock);
  int below = 0;
#pragma unroll
  for (int j = 0; j < kFenceBlock; ++j)
    below += (j >= from && j < to && x[j] <= target) ? 1 : 0;
  return min(static_cast<int>(base) + from - s + below, d - 1);
}

// K3's draw at node v: its row from the node's 16 B record (start, degree,
// total's bits, 0), one random read where indptr and total are two.
__device__ __forceinline__ int its_offset(const int4* __restrict__ rec,
                                          const float* __restrict__ cdf,
                                          const float* __restrict__ fence,
                                          int64_t n_edges, int64_t v,
                                          uint32_t k0, uint32_t k1) {
  const int4 r = rec[v];
  return its_fence_offset<true>(cdf, fence, n_edges, r.x, r.y,
                                __int_as_float(r.z), k0, k1);
}

// K4's draw at node v of a CSR graph (its walker already read indptr[v]).
__device__ __forceinline__ int its_offset(const int32_t* __restrict__ indptr,
                                          const float* __restrict__ cdf,
                                          const float* __restrict__ fence,
                                          const float* __restrict__ total,
                                          int64_t n_edges, int64_t v,
                                          uint32_t k0, uint32_t k1) {
  const int s = indptr[v];
  return its_fence_offset<false>(cdf, fence, n_edges, s, indptr[v + 1] - s,
                                 total[v], k0, k1);
}

}  // namespace repro
