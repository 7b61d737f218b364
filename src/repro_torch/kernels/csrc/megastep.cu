// K4 — the fused epoch on Hopper: epoch_len walk steps of every walker in
// one launch.
//
// Replaces the TPU mega-step kernel repro/kernels/megastep_kernel.py:423
// make_streamed_epoch / :517 make_fused_epoch (body _make_kernel :150,
// pallas_call :494), its hook branch (:347-361) included.  Each walker
// lane runs the staged step (repro/core/runtime.py, step) epoch_len times
// without returning to the host: its degree, the per-step key
// fold_in(rng, step), the regime's draw, the program's hooks, the
// live/stepped/alive update, and a per-(lane, step) int32 flag word (bits
// LIVE, RJS, FALLBACK, PRECOMP, STALE = 0..4, reduced to StepStats
// outside) beside the emitted node.
//
// Hooks (one instance per hook rule, HOOK): each lane loads its program
// state into registers at epoch start (PPR-Nibble: one float32 mass),
// builds the transition ctx the staged step builds (nbr = the node moved
// to; cur, prev, step and deg_cur = d(cur) before the move), commits
// on_step only when the lane stepped, evaluates should_stop on the new
// state, folds a stop into alive, and writes the state back at epoch end.
// One instance per (regime, hook rule); the regimes (FUSED_KINDS):
//   reservoir      ervs_warp_select (ervs.cuh), the code K1 runs;
//   rejection      erjs_trials (erjs.cuh, K2's code) against the baked
//                  per-node bound bmax, the reservoir's choice (by
//                  ervs_warp_select_unfiltered) when trials run out;
//   precomp_its    its_offset (its.cuh, K3's code) on valid rows,
//   precomp_alias  alias_offset (alias.cuh, K5's code) on valid rows;
//                  stale rows take the reservoir's choice (the same).
// Every draw comes from the same Threefry counters as the staged scan, so
// paths, end state and flags equal it bit for bit.  The TPU kernel's
// [R, 128] row alignment and slack tiles were DMA constraints: this reads
// the plain CSR.  The logical tile still feeds the reservoir's counters.
//
// What bounds it on the H100: the reservoir's row scans, one Threefry per
// scanned edge on the integer ALU (ervs.cuh says how the scan keeps
// everything else off the edge), and, for the other regimes, chains of
// dependent 4 B reads (degree, CDF probes, alias columns); their rare row
// scans (eRJS fallbacks, stale rows) keep the unfiltered loop.  Design: one
// warp per walker lane for the whole epoch.  The scalar regimes run on all
// 32 threads alike (same addresses, one transaction), so control flow stays
// warp-uniform and the reservoir can use the whole warp.  A warp whose
// walker sits on a hub scans that hub's row every step it stays there.
// The logical tile's steps are taken at each scan (scan_tile), where they
// cost no division for the engine's tiles and hold no register meanwhile.
#include <cuda_runtime.h>
#include <cstdint>

#include "alias.cuh"
#include "erjs.cuh"
#include "ervs.cuh"
#include "its.cuh"

namespace repro {

constexpr int kReservoir = 0, kRejection = 1, kPrecompIts = 2,
              kPrecompAlias = 3;
constexpr int32_t kLive = 1 << 0, kRjs = 1 << 1, kFallback = 1 << 2,
                  kPrecomp = 1 << 3, kStale = 1 << 4;

struct EpochIn {
  const int64_t* cur;
  const int64_t* prev;
  const int64_t* step;
  const bool* alive;
  const int64_t* rng;     // [W, 2] per-query key data
  const float* bmax;      // [V] rejection bound per node (rejection)
  const float* cdf;       // [E] ITS tables (precomp_its)
  const float* total;     // [V] row totals (precomp kinds)
  const float* prob;      // [E] alias tables (precomp_alias)
  const int32_t* alias;   // [E]
  const bool* invalid;    // [V] stale rows (precomp kinds)
  const float* mass;      // [W] PPR-Nibble residual mass (HOOK_PPR_NIBBLE)
};

struct EpochOut {
  int32_t* emitted;  // [W, T]
  int32_t* flags;    // [W, T]
  int64_t* cur;
  int64_t* prev;
  int64_t* step;
  bool* alive;
  float* mass;
};

// The reservoir instances are held to 6 blocks of 256 threads an SM (40
// registers; on an H100 a deepwalk step took 2-3% less than at 48: most
// steps wait on dependent reads, so warps in flight matter).  The other
// regimes keep ptxas's own count.
template <int KIND, int HOOK>
__global__ void __launch_bounds__(256, KIND == kReservoir ? 6 : 1)
fused_epoch_kernel(Graph g, Rule rule, Hooks hooks, EpochIn in, EpochOut out,
                   int n, int tile, int trials, int rounds, int epoch_len,
                   int64_t num_steps) {
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n) return;  // whole warps exit together
  int64_t cur = in.cur[w], prev = in.prev[w], step = in.step[w];
  bool alive = in.alive[w];
  float mass = HOOK == HOOK_PPR_NIBBLE ? in.mass[w] : 0.0f;
  if (!(alive && step < num_steps)) {
    // a lane that cannot step this epoch emits -1 and flag 0 at every step
    // and keeps its state, as the loop below would (most of PPR-Nibble's
    // lanes, stopped early)
    for (int t = lane; t < epoch_len; t += 32) {
      out.emitted[w * epoch_len + t] = -1;
      out.flags[w * epoch_len + t] = 0;
    }
    if (lane == 0) {
      out.cur[w] = cur;
      out.prev[w] = prev;
      out.step[w] = step;
      out.alive[w] = alive;
      if (HOOK == HOOK_PPR_NIBBLE) out.mass[w] = mass;
    }
    return;
  }
  const uint32_t s0 = static_cast<uint32_t>(in.rng[2 * w]);
  const uint32_t s1 = static_cast<uint32_t>(in.rng[2 * w + 1]);
  for (int t = 0; t < epoch_len; ++t) {
    const WalkerCtx wc = walker_ctx(g, rule, cur, prev, step, nullptr);
    const int deg = wc.deg_cur;
    const bool wants = alive && step < num_steps;
    const bool live = wants && deg > 0;
    int64_t nxt = -1;
    int32_t flag = 0;
    if (live) {
      uint32_t k0, k1;  // the per-step key: the stream folded with step
      fold_in(s0, s1, static_cast<uint32_t>(step), k0, k1);
      flag = kLive;
      if (KIND == kReservoir) {
        nxt = ervs_warp_select(g, rule, wc, k0, k1, scan_tile(tile, lane),
                               lane);
      } else if (KIND == kRejection) {
        const ErjsResult r = erjs_trials(g, rule, wc, k0, k1, in.bmax[cur],
                                         trials, rounds);
        if (r.fallback) {
          nxt = ervs_warp_select_unfiltered(g, rule, wc, k0, k1, tile, lane);
          flag |= kFallback;
        } else {
          nxt = r.chosen;
          if (nxt >= 0) flag |= kRjs;
        }
      } else if (!in.invalid[cur]) {
        const int off =
            KIND == kPrecompIts
                ? its_offset(g.indptr, in.cdf, in.total, cur, k0, k1)
                : alias_offset(g.indptr, in.prob, in.alias, in.total, cur, k0,
                               k1);
        if (off >= 0) {
          nxt = g.indices[g.indptr[cur] + off];
          flag |= kPrecomp;
        }
      } else {  // stale row: the dynamic path
        nxt = ervs_warp_select_unfiltered(g, rule, wc, k0, k1, tile, lane);
        if (nxt >= 0) flag |= kStale;
      }
    }
    const bool stepped = live && nxt >= 0;
    if (lane == 0) {
      out.emitted[w * epoch_len + t] = stepped ? static_cast<int32_t>(nxt) : -1;
      out.flags[w * epoch_len + t] = flag;
    }
    bool stop = false;
    if (HOOK == HOOK_PPR_NIBBLE && stepped) {
      mass = __fmul_rn(mass, hooks.decay);  // on_step
      stop = mass < __fmul_rn(hooks.eps, __int2float_rn(deg));  // should_stop
    }
    // a lane that wanted to step but could not has dead-ended; a lane
    // whose program said stop is equally finished
    alive = alive && !(wants && !stepped) && !stop;
    if (stepped) {
      prev = cur;
      cur = nxt;
      ++step;
    }
  }
  if (lane == 0) {
    out.cur[w] = cur;
    out.prev[w] = prev;
    out.step[w] = step;
    out.alive[w] = alive;
    if (HOOK == HOOK_PPR_NIBBLE) out.mass[w] = mass;
  }
}

template <int KIND>
int launch(int hook, unsigned blocks, int threads, cudaStream_t s,
           const Graph& g, const Rule& rule, const Hooks& hooks,
           const EpochIn& in, const EpochOut& out, int n, int tile,
           int trials, int rounds, int epoch_len, int64_t num_steps) {
  switch (hook) {
    case HOOK_NONE:
      fused_epoch_kernel<KIND, HOOK_NONE><<<blocks, threads, 0, s>>>(
          g, rule, hooks, in, out, n, tile, trials, rounds, epoch_len,
          num_steps);
      break;
    case HOOK_PPR_NIBBLE:
      fused_epoch_kernel<KIND, HOOK_PPR_NIBBLE><<<blocks, threads, 0, s>>>(
          g, rule, hooks, in, out, n, tile, trials, rounds, epoch_len,
          num_steps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

extern "C" int repro_fused_epoch(
    const int32_t* indptr, const int32_t* indices, const float* h,
    const int32_t* labels, const repro::Rule* rule_in, int hook, float decay,
    float eps, int kind, const int64_t* cur, const int64_t* prev,
    const int64_t* step, const bool* alive, const int64_t* rng,
    const float* mass, const float* bmax, const float* cdf, const float* total,
    const float* prob, const int32_t* alias, const bool* invalid, int n,
    int tile, int trials, int rounds, int epoch_len, int64_t num_steps,
    int32_t* emitted, int32_t* flags, int64_t* ocur, int64_t* oprev,
    int64_t* ostep, bool* oalive, float* omass, void* stream) {
  const repro::Graph g{indptr, indices, h, labels};
  const repro::Rule rule = *rule_in;
  const repro::Hooks hooks{hook, decay, eps};
  const repro::EpochIn in{cur, prev, step, alive, rng, bmax, cdf,
                          total, prob, alias, invalid, mass};
  const repro::EpochOut out{emitted, flags, ocur, oprev, ostep, oalive, omass};
  const int threads = 256;  // 8 walker lanes per block, one warp each
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<int64_t>(n) * 32 + threads - 1) / threads);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case repro::kReservoir:
      return repro::launch<repro::kReservoir>(hook, blocks, threads, s, g, rule,
                                              hooks, in, out, n, tile, trials,
                                              rounds, epoch_len, num_steps);
    case repro::kRejection:
      return repro::launch<repro::kRejection>(hook, blocks, threads, s, g, rule,
                                              hooks, in, out, n, tile, trials,
                                              rounds, epoch_len, num_steps);
    case repro::kPrecompIts:
      return repro::launch<repro::kPrecompIts>(hook, blocks, threads, s, g,
                                               rule, hooks, in, out, n, tile,
                                               trials, rounds, epoch_len,
                                               num_steps);
    case repro::kPrecompAlias:
      return repro::launch<repro::kPrecompAlias>(hook, blocks, threads, s, g,
                                                 rule, hooks, in, out, n, tile,
                                                 trials, rounds, epoch_len,
                                                 num_steps);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
