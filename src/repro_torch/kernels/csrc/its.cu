// K3 — inverse-transform (ITS) table draw on Hopper.
//
// Replaces the TPU kernel repro/kernels/precomp_kernel.py:95 its_search
// (body _its_kernel :53); the draw itself is its_offset (its.cuh).  The
// engine's entry searches the flat CSR-order CDF through the row offsets:
// the TPU kernel's [R, 128] row alignment was a DMA constraint and is not
// needed there.  The aligned entry draws on the [R, 128] stream of
// kernels/ops.py, for the standalone op (its_aligned_offset).
//
// What bounds it on the H100: random DRAM reads per walker, each a 64 B
// access of which a binary search uses 4 B.  Design: one thread per
// walker; the engine's entry reads the walker's row as one 16 B node
// record (start, degree, total), searches the fence table (its_offset in
// its.cuh: 12 MB at 48M edges, so its probes stay in L2, and the top
// levels of a hub's row are shared by the walkers on it; the probes ask
// L2 to keep their lines), then reads one aligned 64 B block of the CDF
// with four 16 B loads in flight.  A walker costs its record and that
// block from DRAM, where the binary search cost indptr, total and every
// probe below the range's last 64 B.  The aligned entry promises the
// binary search's answer on any values (non-monotone rows, rows clipped
// at the stream's ends), so it keeps the search probe for probe.  Its
// walkers are in node order on rows 512 B apart, and most rows of the
// smoke's graph hold at most 8 entries: it reads such a row as one
// 32 B sector, one of up to 16 as its 64 B block, before the Threefry,
// so the draw's ~70 instructions overlap the DRAM round trip, and
// searches it from registers; a longer row is searched a probe at a time.
#include <cuda_runtime.h>
#include <cstdint>

#include "its.cuh"

namespace repro {

__global__ void its_kernel(const int4* __restrict__ rec,
                           const float* __restrict__ cdf,
                           const float* __restrict__ fence, int64_t n_edges,
                           const int64_t* __restrict__ cur,
                           const int64_t* __restrict__ keys, int n,
                           int64_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = its_offset(rec, cdf, fence, n_edges, cur[i],
                      static_cast<uint32_t>(keys[2 * i]),
                      static_cast<uint32_t>(keys[2 * i + 1]));
}

// The standalone op on the tile-aligned stream (repro_torch.kernels.ops):
// walker i's row starts at flat offset row0[i] * 128 of cdf2d, whose last
// flat index is `last` (probes past either end read that end).  kVec:
// cdf2d is 16 B aligned, so a block is read as 16 B loads.
template <bool kVec>
__global__ void its_aligned_kernel(const float* __restrict__ cdf2d,
                                   const int32_t* __restrict__ row0,
                                   const int32_t* __restrict__ degs,
                                   const float* __restrict__ totals,
                                   const int64_t* __restrict__ seeds, int n,
                                   int64_t last, int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = its_aligned_offset<kVec>(
      cdf2d, static_cast<int64_t>(row0[i]) * 128, degs[i], totals[i],
      static_cast<uint32_t>(seeds[2 * i]),
      static_cast<uint32_t>(seeds[2 * i + 1]), last);
}

}  // namespace repro

extern "C" int repro_its_search_aligned(const float* cdf2d,
                                        const int32_t* row0,
                                        const int32_t* degs,
                                        const float* totals,
                                        const int64_t* seeds, int n,
                                        int64_t last, int32_t* out,
                                        void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const auto s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(cdf2d) % 16 == 0)
    repro::its_aligned_kernel<true><<<blocks, threads, 0, s>>>(
        cdf2d, row0, degs, totals, seeds, n, last, out);
  else
    repro::its_aligned_kernel<false><<<blocks, threads, 0, s>>>(
        cdf2d, row0, degs, totals, seeds, n, last, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_its_search(const int4* rec, const float* cdf,
                                const float* fence, int64_t n_edges,
                                const int64_t* cur, const int64_t* keys,
                                int n, int64_t* out, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  repro::its_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rec, cdf, fence, n_edges, cur, keys, n, out);
  return static_cast<int>(cudaGetLastError());
}
