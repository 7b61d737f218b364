// The interleaved sampler's eRVS step of one walker by one warp: tile 0 of
// the walker's row read from its prefetch carry when the carry's tag is
// the walker's node (a hit), else from the graph; the rest of the row by
// ervs.cuh's scan from tile 1 on; then the chosen node's first tile
// written into the walker's carry row.  The choice is plain eRVS's, bit
// for bit: the same uniforms (offset j of tile 0 draws lane j of
// uniform(fold_in(key, 0)), the scan keys its tiles from 1 on) and the
// same keys, the lowest offset of the largest key winning.
//
// Tile 0 holds at most `tile` edges, a few a thread: it takes every edge's
// exact key, without the scan's filter, and reads the fields the rule
// reads from the carry row or the graph row alike (EdgeSrc).  The carry
// row is written in place by the warp that read it, after the choice
// (__syncwarp orders the warp's reads before its writes); a row is
// read and written by one warp only, since a slot serves one walker.
// Entries past min(deg, tile) of a written row are left as they were.
#pragma once
#include <cstdint>
#include <math_constants.h>

#include "ervs.cuh"

namespace repro {

// Where a tile-0 edge's fields are read: the walker's carry row, or its
// graph row (offset j of the row at nbr[j], h[j], label[j]).
struct EdgeSrc {
  const int32_t* nbr;
  const float* h;
  const int32_t* label;
};

// The interleaved sampler's carry of every slot ([W], [W, tile] each).
struct Carry {
  int64_t* node;  // tag: the node the row was gathered for, -1 for none
  int32_t* nbr;
  float* h;
  int32_t* label;
};

template <int RC, bool W>
__device__ __forceinline__ EdgeIn load_head(const EdgeSrc& src, int j) {
  EdgeIn e{1.0f, -1, 0};
  if (W) e.h = src.h[j];
  if (RC == kScanMetaPath || (RC == kScanGenerated && kGenReadsLabel)) {
    e.label = src.label[j];
  }
  if (RC == kScanDist || RC == kScanVisited ||
      (RC == kScanGenerated && kGenReadsNbr)) {
    e.nbr = src.nbr[j];
  }
  return e;
}

// This thread's best (key, offset) over offsets lane, lane + 32, ... below
// n0 = min(deg, tile) of tile 0, each edge's exact key.
template <int RC, bool W>
__device__ __noinline__ Best scan_head(const ScanArgs a, const EdgeSrc src,
                                       int n0, int lane, const WalkerCtx wc) {
  Best best{-CUDART_INF_F, INT32_MAX};
  uint32_t tk0, tk1;
  fold_in(a.k0, a.k1, 0u, tk0, tk1);
  int cursor = a.p_begin - 1;
  for (int j = lane; j < n0; j += 32) {
    const EdgeIn e = load_head<RC, W>(src, j);
    const float u = uniform_from_bits(
        random_bits(tk0, tk1, static_cast<uint32_t>(j)));
    const float lk = log_key(u, scan_weight<RC, W>(a, e, cursor, &wc));
    if (lk > best.key) best = Best{lk, j};  // offsets rise: first max kept
  }
  return best;
}

template <int RC>
__device__ __forceinline__ Best head_rule(bool weighted, const ScanArgs& a,
                                          const EdgeSrc& src, int n0,
                                          int lane, const WalkerCtx& wc) {
  return weighted ? scan_head<RC, true>(a, src, n0, lane, wc)
                  : scan_head<RC, false>(a, src, n0, lane, wc);
}

// Tile 0's scan by the rule's class (as scan_dispatch picks the row's).
__device__ __forceinline__ Best head_dispatch(const Rule& rule,
                                              const ScanArgs& a,
                                              const EdgeSrc& src, int n0,
                                              int lane, const WalkerCtx& wc) {
  switch (rule.program) {
    case PROGRAM_METAPATH:
      return head_rule<kScanMetaPath>(rule.weighted, a, src, n0, lane, wc);
    case PROGRAM_NODE2VEC:
    case PROGRAM_SECOND_ORDER_PR:
      return head_rule<kScanDist>(rule.weighted, a, src, n0, lane, wc);
    case PROGRAM_VISITED:
      return head_rule<kScanVisited>(rule.weighted, a, src, n0, lane, wc);
#ifdef REPRO_GENERATED_RULE
    case PROGRAM_GENERATED:
      return head_rule<kScanGenerated>(rule.weighted, a, src, n0, lane, wc);
#endif
    default:  // DeepWalk, PPR-Nibble
      return head_rule<kScanH>(rule.weighted, a, src, n0, lane, wc);
  }
}

// The warp's best (on every lane): the largest key, the lowest offset on
// equal keys.
__device__ __forceinline__ Best warp_best_all(Best b) {
  b = warp_best(b);
  return Best{__shfl_sync(kFullWarp, b.key, 0),
              __shfl_sync(kFullWarp, b.idx, 0)};
}

// Next node of walker `wc` in carry row `slot`, or -1 when no neighbour
// has a positive weight; rewrites the carry row and its tag.  `flags`:
// bit 0 the program is weighted (else h is 1), bit 1 it reads labels
// (else the label is 0), as the plain version fills the row.
__device__ __forceinline__ int64_t ervs_interleaved_warp_select(
    const Graph& g, const Rule& rule, const WalkerCtx& wc, uint32_t k0,
    uint32_t k1, int tile, const Carry& c, int64_t slot, int flags,
    int lane) {
  const ScanArgs a = scan_args(g, rule, wc, k0, k1);
  const int64_t row = slot * tile;
  const bool hit = c.node[slot] == wc.cur;  // an active lane's cur >= 0
  const EdgeSrc src = hit ? EdgeSrc{c.nbr + row, c.h + row, c.label + row}
                          : EdgeSrc{g.indices + a.start, g.h + a.start,
                                    g.labels + a.start};
  const Best head = warp_best_all(
      head_dispatch(rule, a, src, min(a.deg, tile), lane, wc));
  Best top = head;
  if (a.deg > tile) {  // warp-uniform
    ScanArgs rest = a;
    rest.start += tile;
    rest.deg -= tile;
    rest.t0 = 1;
    const Best tail = warp_best_all(
        scan_dispatch(rule, rest, scan_tile(tile, lane), lane, wc));
    if (tail.key > head.key) top = Best{tail.key, tail.idx + tile};
  }
  int64_t nxt = -1;
  if (lane == 0 && top.key != -CUDART_INF_F) {
    nxt = top.idx < tile ? src.nbr[top.idx] : g.indices[a.start + top.idx];
  }
  nxt = __shfl_sync(kFullWarp, nxt, 0);
  __syncwarp();  // the warp's reads of the carry row come before its writes
  if (lane == 0) c.node[slot] = nxt;
  if (nxt >= 0) {
    const int ns = g.indptr[nxt];
    const int dn = min(g.indptr[nxt + 1] - ns, tile);
    for (int j = lane; j < dn; j += 32) {
      c.nbr[row + j] = g.indices[ns + j];
      c.h[row + j] = (flags & 1) ? g.h[ns + j] : 1.0f;
      c.label[row + j] = (flags & 2) ? g.labels[ns + j] : 0;
    }
  }
  return nxt;
}

}  // namespace repro
