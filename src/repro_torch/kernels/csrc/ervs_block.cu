// K6 — block-jump A-ExpJ reservoir selection over 1024-weight tiles on
// Hopper.
//
// Replaces the TPU kernel repro/kernels/ervs_kernel.py:109 ervs_select
// (body _ervs_kernel :38, pallas_call :118); its plain version is
// repro_torch/kernels/ref.py:ervs_select_ref, and the plain versions of
// its tables are ref.py:ervs_leaders_ref and ervs_tile_tables_ref.  Each
// walker carries one A-ExpJ reservoir across the 1024-weight tiles of its
// row on the tile-aligned [R, 128] stream (row0 * 128 is the row's flat
// start; as in the reference, a row index outside [0, R) reads row 0 or
// R - 1):
//
//   * a tile whose sum stays below the carried threshold t_rem is retired
//     with that sum alone — no Threefry draw, no log, no prefix sum;
//   * a crossing tile loops: the first position whose prefix reaches
//     base + t_rem (and whose weight is positive; position 0 when none
//     does) takes the reservoir, one draw uniform_pair_01(seed, (draws,
//     0x9E3779B9)) sets its key and the next threshold.
//
// Bitwise with the plain version, which is bitwise with the reference on
// the CPU: the tile sum adds 32 windows of 32 weights sequentially, then
// the window sums in window order; the prefix sums cs are the base-16
// recursive scan (sequential 16-chunks, their totals scanned in groups of
// 16, the group totals scanned); exp and log are XLA's CPU polynomials
// and every multiply feeding an add is one fused multiply-add
// (xla_math.cuh).  All other float ops are __f*_rn, and the build adds
// -fmad=false.
//
// Design.  A tile's sum and prefix sums depend on the tile alone (its
// first stream row, and for the sum its valid count), not on the walker.
// At a crossing the walk needs the first position p whose running maximum
//   M[p] = max{cs[q] : q <= p, w[q] > 0}          (-inf before the first)
// reaches the target: cs is not monotone (its sums associate differently
// at 16-chunk boundaries), M is; the first p >= first (the first position
// counted in M) with M[p] >= target is the rule's hit, and M there equals
// cs.  A call runs three steps:
//
//   1. plan, a thread per walker: walkers whose rows hold more than
//      kShortMax weights ("tabled") elect one leader per distinct
//      (row0, deg): an atomicMax of the walker index on the row's slot,
//      the slot's owner kept only where its (row0, deg) is the walker's
//      own (else the walker leads a job of its own).  Leaders take their
//      places in the tables by block-wide scans and one atomicAdd a block.
//      A counting sort by work class gives the walk's order.  The host
//      reads the three totals (jobs, tiles, M entries) to size the
//      tables: one synchronisation a call.
//   2. tables, a thread per tile of every leader: the tile's sum, its
//      first counted position and M over its valid count rounded up to
//      32 (a 128 B line of weights at a time, 16 B loads and stores).
//   3. walk, a thread per walker: a tabled walker reads one sum a tile
//      and binary-searches M at a crossing (from its last hit: the next
//      one is never before it); a short walker reads its few weights
//      itself, once for the sum and once for the prefixes up to each hit.
//      Walkers run in order of their work (tile count, or degree for a
//      short row; the plan's order kernel), so the lanes of a warp retire
//      about as many tiles; the lanes first advance to their next
//      crossing tile, reading kAhead tile sums at once, then cross
//      together, so their draw chains run side by side.
//
// What bounds it on the H100: reading each distinct row once (4 B a
// weight) and the walkers' draws (a Threefry, an exp, two logs and two
// divides each); the walkers' table reads hit L2.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

#include "threefry.cuh"
#include "xla_math.cuh"

namespace repro {

constexpr int kLanes = 128;
constexpr int kSublanes = 8;
constexpr int kTile = 1024;
constexpr int kThreads = 256;
constexpr int kAhead = 8;  // tile sums a walker reads at once
// rows of more weights are tabled; a walker on a shorter row reads it
// itself (ref.py ERVS_SHORT_MAX holds the same number)
constexpr int kShortMax = 64;
constexpr uint32_t kErvsSalt = 0x9E3779B9u;

__device__ __forceinline__ int64_t clip(int64_t x, int64_t hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

__device__ __forceinline__ int tiles_of(int deg) {
  return deg > 0 ? (deg + kTile - 1) / kTile : 0;
}

// M entries of a row: 1,024 a full tile, the last tile's valid count
// rounded up to 32
__device__ __forceinline__ int64_t m_len_of(int deg) {
  return (static_cast<int64_t>(deg) + 31) / 32 * 32;
}

// weights o .. o + 3 (o a multiple of 4) of the tile at stream row row_t
__device__ __forceinline__ float4 weights4(const float* w2d, int64_t row_t,
                                           int o, int64_t rows) {
  const int64_t r = clip(row_t + (o >> 7), rows - 1);
  return __ldg(reinterpret_cast<const float4*>(w2d + r * kLanes +
                                               (o & (kLanes - 1))));
}

__device__ __forceinline__ float weight(const float* w2d, int64_t row_t,
                                        int o, int64_t rows) {
  return __ldg(w2d + clip(row_t + (o >> 7), rows - 1) * kLanes +
               (o & (kLanes - 1)));
}

// A tile's sum in XLA's order, a weight at a time: each 32-weight window
// summed from its first weight, the window sums added in window order.
struct TileSum {
  float part = 0.0f, total = 0.0f;
  __device__ __forceinline__ void push(int p, float w) {
    const int q = p & 31;
    part = q ? __fadd_rn(part, w) : w;
    if (q == 31) total = p >> 5 ? __fadd_rn(total, part) : part;
  }
  // the sum of positions [0, n); the zeros past n change nothing
  __device__ __forceinline__ float value(int n) const {
    if (n & 31) return n >> 5 ? __fadd_rn(total, part) : part;
    return total;
  }
};

// A tile's base-16 prefix sums in XLA's order and their running maximum
// M over positive weights, a position at a time.  cs[p] = inner + ex1:
// inner is the sequential sum of p's 16-chunk, ex1 the chunk's exclusive
// prefix (the previous chunk's level-2 value inner2 + ex2: inner2 scans
// the chunk totals of a group of 16 chunks, ex2 the groups before).
struct TileScan {
  float inner, inner2, ex1, ex2;
  float m;    // M at the last position pushed (once first >= 0)
  float w;    // the last weight pushed
  int n;      // positions pushed
  int first;  // the first position counted in M, -1 before
  __device__ __forceinline__ void reset() {
    n = 0;
    first = -1;
  }
  __device__ __forceinline__ void push(float x) {
    const int p = n++;
    const int j = p & 15, c = p >> 4;
    inner = j ? __fadd_rn(inner, x) : x;
    const float cs = c ? __fadd_rn(inner, ex1) : inner;
    if (x > 0.0f && cs == cs) {  // a positive weight whose prefix is a number
      if (first < 0) {
        first = p;
        m = cs;
      } else if (cs > m) {
        m = cs;
      }
    }
    if (j == 15) {  // the chunk's total enters the upper levels
      const int k = c & 15, g = c >> 4;
      inner2 = k ? __fadd_rn(inner2, inner) : inner;
      ex1 = g ? __fadd_rn(inner2, ex2) : inner2;
      if (k == 15) ex2 = g ? __fadd_rn(ex2, inner2) : inner2;
    }
    w = x;
  }
  __device__ __forceinline__ float value() const {
    return first >= 0 ? m : -CUDART_INF_F;
  }
};

// ------------------------------------------------------------- 1. plan
// The walk runs the walkers in order of their work, most first, so that
// the lanes of a warp do about as much: tabled rows by their tile count,
// 2^(b-1) to 2^b - 1 tiles in slot 22 - b, then short rows by their
// degree, 2^(b-1) to 2^b - 1 weights in slot 63 - b, empty rows last.
constexpr int kSlots = 64;

__device__ __forceinline__ int order_slot(int deg) {
  if (deg <= 0) return kSlots - 1;
  if (deg <= kShortMax) return kSlots - 1 - (32 - __clz(deg));
  return max(0, 22 - (32 - __clz(tiles_of(deg))));
}

__global__ void __launch_bounds__(kThreads)
ervs_mark_kernel(const int32_t* __restrict__ row0,
                 const int32_t* __restrict__ degs, int n, int64_t rows,
                 int32_t* __restrict__ owner,
                 unsigned* __restrict__ slot_count) {
  __shared__ unsigned hist[kSlots];
  if (threadIdx.x < kSlots) hist[threadIdx.x] = 0;
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    const int deg = degs[i];
    if (deg > kShortMax) atomicMax(owner + clip(row0[i], rows - 1), i);
    atomicAdd(hist + order_slot(deg), 1u);
  }
  __syncthreads();
  if (threadIdx.x < kSlots && hist[threadIdx.x])
    atomicAdd(slot_count + threadIdx.x, hist[threadIdx.x]);
}

// order[] = the walkers slot by slot: each block reserves its range of a
// slot with one atomicAdd (slot_fill) past the slot's start (the prefix of
// slot_count)
__global__ void __launch_bounds__(kThreads)
ervs_order_kernel(const int32_t* __restrict__ degs, int n,
                  const unsigned* __restrict__ slot_count,
                  unsigned* __restrict__ slot_fill,
                  int32_t* __restrict__ order) {
  __shared__ unsigned start[kSlots], count[kSlots];
  if (threadIdx.x < kSlots) {
    unsigned before = 0;
    for (int k = 0; k < static_cast<int>(threadIdx.x); ++k)
      before += slot_count[k];
    start[threadIdx.x] = before;
    count[threadIdx.x] = 0;
  }
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int slot = 0;
  unsigned rank = 0;
  if (i < n) {
    slot = order_slot(degs[i]);
    rank = atomicAdd(count + slot, 1u);
  }
  __syncthreads();
  if (threadIdx.x < kSlots && count[threadIdx.x])
    start[threadIdx.x] += atomicAdd(slot_fill + threadIdx.x,
                                    count[threadIdx.x]);
  __syncthreads();
  if (i < n) order[start[slot] + rank] = i;
}

// exclusive prefix of v over the block's threads; `total` gets the sum
__device__ __forceinline__ long long block_scan(long long v, long long* sh,
                                                long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  long long before = 0, sum = 0;
  for (int k = 0; k < kThreads / 32; ++k) {
    if (k < warp) before += sh[k];
    sum += sh[k];
  }
  __syncthreads();  // sh is the next scan's
  total = sum;
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads)
ervs_plan_kernel(const int32_t* __restrict__ row0,
                 const int32_t* __restrict__ degs, int n, int64_t rows,
                 const int32_t* __restrict__ owner,
                 int32_t* __restrict__ src_of, int32_t* __restrict__ tb_of,
                 int64_t* __restrict__ mb_of, int32_t* __restrict__ jobs,
                 unsigned long long* __restrict__ counts) {
  __shared__ long long sh[kThreads / 32];
  __shared__ unsigned long long base[3];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int own = 0;
  long long nt = 0, ml = 0;
  if (i < n && degs[i] > kShortMax) {
    const int lead = owner[clip(row0[i], rows - 1)];
    own = lead == i || row0[lead] != row0[i] || degs[lead] != degs[i];
    src_of[i] = own ? i : lead;
    if (own) {
      nt = tiles_of(degs[i]);
      ml = m_len_of(degs[i]);
    }
  }
  long long tot[3];
  const long long ej = block_scan(own, sh, tot[0]);
  const long long et = block_scan(nt, sh, tot[1]);
  const long long em = block_scan(ml, sh, tot[2]);
  if (threadIdx.x < 3)
    base[threadIdx.x] = tot[threadIdx.x]
        ? atomicAdd(counts + threadIdx.x,
                    static_cast<unsigned long long>(tot[threadIdx.x]))
        : 0ull;
  __syncthreads();
  if (own) {
    jobs[base[0] + ej] = i;
    tb_of[i] = static_cast<int32_t>(base[1] + et);
    mb_of[i] = static_cast<int64_t>(base[2] + em);
  }
}

// ----------------------------------------------------------- 2. tables
__global__ void __launch_bounds__(kThreads)
ervs_tile_map_kernel(const int32_t* __restrict__ degs,
                     const int32_t* __restrict__ jobs, int n_jobs,
                     const int32_t* __restrict__ tb_of,
                     int32_t* __restrict__ tile_job) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_jobs) return;
  const int lead = jobs[j];
  const int nt = tiles_of(degs[lead]);
  const int tb = tb_of[lead];
  for (int t = 0; t < nt; ++t) tile_job[tb + t] = lead;
}

__global__ void __launch_bounds__(kThreads)
ervs_tile_kernel(const float* __restrict__ w2d,
                 const int32_t* __restrict__ row0,
                 const int32_t* __restrict__ degs, int64_t rows, int n_tiles,
                 const int32_t* __restrict__ tile_job,
                 const int32_t* __restrict__ tb_of,
                 const int64_t* __restrict__ mb_of, float* __restrict__ sums,
                 int32_t* __restrict__ firsts, float* __restrict__ mtab) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_tiles) return;
  const int lead = tile_job[g];
  const int t = g - tb_of[lead];
  const int valid = min(degs[lead] - t * kTile, kTile);
  const int64_t row_t = row0[lead] + static_cast<int64_t>(t) * kSublanes;
  float* m = mtab + mb_of[lead] + static_cast<int64_t>(t) * kTile;
  TileSum sum;
  TileScan scan;
  scan.reset();
  const int len = (valid + 31) & ~31;
  for (int o = 0; o < len; o += 32) {  // a 128 B line of weights a step
    float4 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = o + 4 * q < valid ? weights4(w2d, row_t, o + 4 * q, rows)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float x[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
      float out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = o + 4 * q + k;
        const float xk = p < valid ? x[k] : 0.0f;  // the tile's zeros
        if (p < valid) sum.push(p, xk);
        scan.push(xk);
        out[k] = scan.value();
      }
      *reinterpret_cast<float4*>(m + o + 4 * q) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
  }
  sums[g] = sum.value(valid);
  firsts[g] = scan.first;
}

// ------------------------------------------------------------- 3. walk
// the sum of a short row (one tile of `deg` weights at stream row r0)
__device__ __forceinline__ float short_sum(const float* w2d, int64_t r0,
                                           int deg, int64_t rows) {
  TileSum sum;
  for (int o = 0; o < deg; o += 4) {
    const float4 v = weights4(w2d, r0, o, rows);
    sum.push(o, v.x);
    if (o + 1 < deg) sum.push(o + 1, v.y);
    if (o + 2 < deg) sum.push(o + 2, v.z);
    if (o + 3 < deg) sum.push(o + 3, v.w);
  }
  return sum.value(deg);
}

__global__ void __launch_bounds__(kThreads)
ervs_walk_kernel(const float* __restrict__ w2d,
                 const int32_t* __restrict__ row0,
                 const int32_t* __restrict__ degs,
                 const int64_t* __restrict__ seeds, int n, int64_t rows,
                 const int32_t* __restrict__ src_of,
                 const int32_t* __restrict__ tb_of,
                 const int64_t* __restrict__ mb_of,
                 const float* __restrict__ sums,
                 const int32_t* __restrict__ firsts,
                 const float* __restrict__ mtab,
                 const int32_t* __restrict__ order,
                 int32_t* __restrict__ off_out,
                 int32_t* __restrict__ draws_out,
                 int32_t* __restrict__ jumped_out) {
  const int at = blockIdx.x * kThreads + threadIdx.x;
  if (at >= n) return;
  const int i = order[at];
  const int64_t r0 = row0[i];
  const int deg = degs[i];
  const uint32_t k0 = static_cast<uint32_t>(seeds[2 * i]);
  const uint32_t k1 = static_cast<uint32_t>(seeds[2 * i + 1]);
  const int nt = tiles_of(deg);
  const bool tabled = deg > kShortMax;
  int tb = 0;
  const float* mrow = mtab;
  if (tabled) {
    const int src = src_of[i];
    tb = tb_of[src];
    mrow = mtab + mb_of[src];
  }
  TileScan scan;
  float best_lk = -CUDART_INF_F, t_rem = 0.0f;
  int best_off = -1, draws = 0, jumped = 0;
  int t = 0;
  for (;;) {
    // retire the tiles whose sum stays below t_rem, their sums read
    // kAhead at a time
    float s = 0.0f;
    bool cross = false;
    while (t < nt && !cross) {
      float ahead[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k)
        ahead[k] = !tabled ? (k ? 0.0f : short_sum(w2d, r0, deg, rows))
                           : (t + k < nt ? sums[tb + t + k] : 0.0f);
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        if (cross || t >= nt) continue;
        s = ahead[k];
        if (s >= t_rem && s > 0.0f) {
          cross = true;
        } else {
          t_rem = __fsub_rn(t_rem, s);
          ++jumped;
          ++t;
        }
      }
    }
    if (!cross) break;
    // tile t crosses
    const int valid = min(deg - t * kTile, kTile);
    const int64_t row_t = r0 + static_cast<int64_t>(t) * kSublanes;
    const float* m = mrow + static_cast<int64_t>(t) * kTile;
    const int first = tabled ? firsts[tb + t] : -1;
    int lo = first < 0 ? valid : first;
    scan.reset();
    float base = 0.0f;
    while (__fsub_rn(s, base) >= t_rem) {
      const float target = __fadd_rn(base, t_rem);
      int pos;
      float w_m;
      if (tabled) {  // the first p in [lo, valid) with M[p] >= target
        int a = lo, b = valid;
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (__ldg(m + mid) >= target) b = mid; else a = mid + 1;
        }
        if (a < valid) {
          pos = a;
          base = __ldg(m + a);
          lo = a;
        } else {  // no position reaches the target: position 0
          pos = 0;
          base = weight(w2d, row_t, 0, rows);
          lo = first < 0 ? valid : first;
        }
        w_m = weight(w2d, row_t, pos, rows);
      } else {  // push positions until M reaches the target
        for (;;) {
          if (scan.first >= 0 && scan.m >= target) {
            pos = scan.n - 1;
            base = scan.m;
            w_m = scan.w;
            break;
          }
          if (scan.n == valid) {
            pos = 0;
            w_m = base = weight(w2d, row_t, 0, rows);
            scan.reset();
            break;
          }
          scan.push(weight(w2d, row_t, scan.n, rows));
        }
      }
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
    }
    t_rem = __fsub_rn(t_rem, __fsub_rn(s, base));
    ++t;
  }
  off_out[i] = best_off;
  draws_out[i] = draws;
  jumped_out[i] = jumped;
}

}  // namespace repro

namespace {
inline int blocks_for(long long n) {
  return static_cast<int>((n + repro::kThreads - 1) / repro::kThreads);
}
}  // namespace

// 1. plan: the leaders, their places in the tables, and counts[0..2] =
// (jobs, tiles, M entries).  owner holds `rows` int32, src_of / tb_of /
// jobs n int32, mb_of n int64.
extern "C" int repro_ervs_block_plan(const int32_t* row0, const int32_t* degs,
                                     int n, int64_t rows, int32_t* owner, int32_t* src_of,
                                     int32_t* tb_of, int64_t* mb_of,
                                     int32_t* jobs, int32_t* order,
                                     int64_t* counts, void* stream) {
  // counts: the three totals, then 2 x kSlots unsigned (count, fill)
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* slots = reinterpret_cast<unsigned*>(counts + 3);
  cudaError_t err = cudaMemsetAsync(owner, 0xFF, rows * sizeof(int32_t), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counts, 0,
                          3 * sizeof(int64_t) + 2 * repro::kSlots * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  repro::ervs_mark_kernel<<<blocks_for(n), repro::kThreads, 0, s>>>(
      row0, degs, n, rows, owner, slots);
  repro::ervs_plan_kernel<<<blocks_for(n), repro::kThreads, 0, s>>>(
      row0, degs, n, rows, owner, src_of, tb_of, mb_of, jobs,
      reinterpret_cast<unsigned long long*>(counts));
  repro::ervs_order_kernel<<<blocks_for(n), repro::kThreads, 0, s>>>(
      degs, n, slots, slots + repro::kSlots, order);
  return static_cast<int>(cudaGetLastError());
}

// 2. tables of the plan's n_jobs leaders: n_tiles sums and firsts, M
extern "C" int repro_ervs_block_tables(const float* w2d, const int32_t* row0,
                                       const int32_t* degs, int64_t rows,
                                       const int32_t* jobs, int n_jobs,
                                       int n_tiles, const int32_t* tb_of,
                                       const int64_t* mb_of,
                                       int32_t* tile_job, float* sums,
                                       int32_t* firsts, float* mtab,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  repro::ervs_tile_map_kernel<<<blocks_for(n_jobs), repro::kThreads, 0, s>>>(
      degs, jobs, n_jobs, tb_of, tile_job);
  repro::ervs_tile_kernel<<<blocks_for(n_tiles), repro::kThreads, 0, s>>>(
      w2d, row0, degs, rows, n_tiles, tile_job, tb_of, mb_of, sums, firsts,
      mtab);
  return static_cast<int>(cudaGetLastError());
}

// 3. walk: every walker's offset, draws and jumped tiles
extern "C" int repro_ervs_block_walk(const float* w2d, const int32_t* row0,
                                     const int32_t* degs,
                                     const int64_t* seeds, int n,
                                     int64_t rows, const int32_t* src_of,
                                     const int32_t* tb_of,
                                     const int64_t* mb_of, const float* sums,
                                     const int32_t* firsts, const float* mtab,
                                     const int32_t* order, int32_t* off,
                                     int32_t* draws, int32_t* jumped,
                                     void* stream) {
  repro::ervs_walk_kernel<<<blocks_for(n), repro::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      w2d, row0, degs, seeds, n, rows, src_of, tb_of, mb_of, sums,
      firsts, mtab, order, off, draws, jumped);
  return static_cast<int>(cudaGetLastError());
}
