// K4 — the fused epoch on Hopper: epoch_len walk steps of every walker in
// one launch.
//
// Replaces the TPU mega-step kernel repro/kernels/megastep_kernel.py:423
// make_streamed_epoch / :517 make_fused_epoch (body _make_kernel :150,
// pallas_call :494), its hook branch (:347-361) included.  Each walker
// runs the staged step (repro/core/runtime.py, step) epoch_len times
// without returning to the host: its degree, the per-step key
// fold_in(rng, step), the regime's draw, the program's hooks, the
// live/stepped/alive update, and a per-(lane, step) int32 flag word (bits
// LIVE, RJS, FALLBACK, PRECOMP, STALE = 0..4, reduced to StepStats
// outside) beside the emitted node.
//
// Hooks (one instance per hook rule, HOOK): each walker loads its program
// state into registers at epoch start (PPR-Nibble: one float32 mass;
// HOOK_GENERATED: its GenState, every scalar leaf by value and a pointer
// to its row of each vector leaf), builds the transition ctx the staged
// step builds (nbr = the node moved to; cur, prev, step and deg_cur =
// d(cur) before the move), commits on_step only when the lane stepped,
// evaluates should_stop on the new state, folds a stop into alive, and
// writes the state back at epoch end.  A generated weight reads the same
// GenState in the reservoir scan, the rejection trials and the stale-row
// scans.  The wrapper hands HOOK_GENERATED a copy of the input leaves
// (out.leaves): a vector leaf's row is read and updated there in place,
// its slots written by one lane of the warp that serves the walker, and
// the warp meets at __syncwarp() before any lane reads it again
// (kGenVectorState; scalar leaves need no memory).
// One instance per (regime, hook rule); the regimes (FUSED_KINDS):
//   reservoir      ervs_warp_select (ervs.cuh), the code K1 runs;
//   rejection      erjs_trials (erjs.cuh, K2's code) against the baked
//                  per-node bound bmax, the reservoir's choice (by
//                  ervs_warp_select_unfiltered) when trials run out;
//   precomp_its    its_offset (its.cuh, K3's code: the fence table, then
//                  one CDF block) on valid rows,
//   precomp_alias  alias_offset (alias.cuh, K5's code: the pair table) on
//                  valid rows;
//                  stale rows take the reservoir's choice (the same).
// Every draw comes from the same Threefry counters as the staged scan, so
// paths, end state and flags equal it bit for bit.  The TPU kernel's
// [R, 128] row alignment and slack tiles were DMA constraints: this reads
// the plain CSR.  The logical tile still feeds the reservoir's counters.
//
// What bounds it on the H100.  The reservoir: its row scans, one Threefry
// per scanned edge on the integer ALU (ervs.cuh says how the scan keeps
// everything else off the edge).  Design: one warp per walker for the
// whole epoch (fused_epoch_kernel); a warp whose walker sits on a hub
// scans that hub's row every step it stays there.  The logical tile's
// steps are taken at each scan (scan_tile), where they cost no division
// for the engine's tiles and hold no register meanwhile.
// The other regimes: chains of dependent 4 B reads a step (degree, bound
// or invalid flag and total, the trials' gathers, the CDF probes or alias
// columns, the neighbour), so what they need is walkers in flight.
// Design: one walker per lane for the whole epoch (fused_epoch_lanes):
// degree, step key, hooks and state in that lane's registers, the step
// loop in lockstep over the warp (a lane that cannot step stays in it,
// masked), eRJS by erjs_trials (round 0 on the lane, the later rounds by
// passes of the warp).  A walker that needs a row scan (an eRJS
// fallback, a stale row) is served by the whole warp, one after another,
// with its context broadcast, through the unfiltered loop
// (ervs_warp_select_unfiltered).  A warp a walker would leave 31 lanes
// repeating the first one's scalar steps and ~40 walkers an SM in flight.
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
  const float* fence;     // [E / 16]
  int64_t n_edges;        // E
  const float* total;     // [V] row totals (precomp kinds)
  const int2* pair;       // [E] alias tables (precomp_alias): prob, alias
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
  // the wstate leaves a generated rule reads (HOOK_GENERATED: all of them,
  // a copy of the input that the kernel updates in place)
  GenLeaves leaves;
};

// The reservoir: a warp per walker.  Held to 6 blocks of 256 threads an
// SM (40 registers; on an H100 a deepwalk step took 2-3% less than at 48:
// most steps wait on dependent reads, so warps in flight matter).
template <int HOOK>
__global__ void __launch_bounds__(256, 6)
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
    // lanes, stopped early; out.leaves hold it already)
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
  GenState gs = gen_state<HOOK == HOOK_GENERATED>(out.leaves, w);
  const uint32_t s0 = static_cast<uint32_t>(in.rng[2 * w]);
  const uint32_t s1 = static_cast<uint32_t>(in.rng[2 * w + 1]);
  for (int t = 0; t < epoch_len; ++t) {
    WalkerCtx wc = walker_ctx(g, rule, cur, prev, step, nullptr);
    wc.gen = gs;
    const int deg = wc.deg_cur;
    const bool wants = alive && step < num_steps;
    const bool live = wants && deg > 0;
    int64_t nxt = -1;
    int32_t flag = 0;
    if (live) {
      uint32_t k0, k1;  // the per-step key: the stream folded with step
      fold_in(s0, s1, static_cast<uint32_t>(step), k0, k1);
      flag = kLive;
      nxt = ervs_warp_select(g, rule, wc, k0, k1, scan_tile(tile, lane),
                             lane);
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
    if constexpr (HOOK == HOOK_GENERATED) {
      if (stepped) {  // warp-uniform: every lane holds the walker
        const HookCtx hc{cur, prev, step, nxt, deg,
                         kGenHooksReadDegPrev ? degree(g, prev) : 0};
        generated_on_step(hc, gs, lane == 0);
        stop = generated_should_stop(hc, gs);
      }
      // lane 0's slot writes, before the next scan reads (scalar leaves
      // live in every lane's registers)
      if (kGenVectorState) __syncwarp();
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
    if (HOOK == HOOK_GENERATED) gen_state_store(out.leaves, w, gs);
  }
}

// The walker on lane `src` and its step key, served by the whole warp's
// row scan (the unfiltered loop); the scan's choice, on every lane.
__device__ __forceinline__ int64_t warp_scan_for(const Graph& g,
                                                 const Rule& rule,
                                                 const WalkerCtx& wc,
                                                 uint32_t k0, uint32_t k1,
                                                 int tile, int src, int lane) {
  const WalkerCtx c = shfl_ctx(wc, src);
  return ervs_warp_select_unfiltered(g, rule, c,
                                     __shfl_sync(kFullWarp, k0, src),
                                     __shfl_sync(kFullWarp, k1, src), tile,
                                     lane);
}

// The scalar regimes (rejection, precomp_its, precomp_alias): a walker per
// lane.  Every lane of a warp runs the step loop together, so the warp's
// votes and scans see all 32; a lane without a walker (past n) or that
// cannot step runs it masked and writes -1 and flag 0 as a walker that
// cannot step does.  A warp none of whose walkers can step this epoch
// writes its rows and leaves.  A lane's per-step words would be 4 B
// writes a row apart; the warp buffers kStage steps of them in shared
// memory and writes whole 32 B segments (on an H100 that took deepwalk's
// 16-step epochs 21-28% and ppr_nibble's 47-65% less time).  Registers are
// ptxas's own: held to 40 or 32, deepwalk's epochs took 16-55% longer.
constexpr int kLanesWarps = 8;  // warps a block of fused_epoch_lanes
constexpr int kStage = 8;       // steps whose output words a warp buffers

template <int KIND, int HOOK>
__global__ void __launch_bounds__(kLanesWarps * 32)
fused_epoch_lanes(Graph g, Rule rule, Hooks hooks, EpochIn in, EpochOut out,
                  int n, int tile, int trials, int rounds, int epoch_len,
                  int64_t num_steps) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int64_t w0 = w - lane;  // the warp's first walker
  if (w0 >= n) return;  // whole warps exit together
  const bool on = w < n;
  int64_t cur = -1, prev = -1, step = 0;
  bool alive = false;
  float mass = 0.0f;
  GenState gs{};
  uint32_t s0 = 0, s1 = 0;
  if (on) {
    cur = in.cur[w];
    prev = in.prev[w];
    step = in.step[w];
    alive = in.alive[w];
    if (HOOK == HOOK_PPR_NIBBLE) mass = in.mass[w];
    gs = gen_state<HOOK == HOOK_GENERATED>(out.leaves, w);
    s0 = static_cast<uint32_t>(in.rng[2 * w]);
    s1 = static_cast<uint32_t>(in.rng[2 * w + 1]);
  }
  if (!__any_sync(kFullWarp, alive && step < num_steps)) {
    // the warp's rows of -1 and 0 are contiguous: write them together
    // (most of PPR-Nibble's warps, stopped early)
    const int64_t end = (n < w0 + 32 ? n : w0 + 32) * epoch_len;
    for (int64_t j = w0 * epoch_len + lane; j < end; j += 32) {
      out.emitted[j] = -1;
      out.flags[j] = 0;
    }
  } else {
    // per warp, kStage steps of its walkers' emitted and flag words (a row
    // padded by one word, so that neither side's accesses share a bank)
    __shared__ int32_t stage_e[kLanesWarps][32][kStage + 1],
        stage_f[kLanesWarps][32][kStage + 1];
    const int warp = threadIdx.x >> 5;
    for (int t = 0; t < epoch_len; ++t) {  // warp-uniform
      const bool wants = alive && step < num_steps;
      WalkerCtx wc{cur, prev, step, 0, 0, nullptr};
      if (wants) wc = walker_ctx(g, rule, cur, prev, step, nullptr);
      wc.gen = gs;
      const int deg = wc.deg_cur;
      const bool live = wants && deg > 0;
      int64_t nxt = -1;
      int32_t flag = 0;
      uint32_t k0 = 0, k1 = 0;
      bool scan = false;  // the walker needs the warp's row scan
      if (live) {  // the per-step key: the stream folded with step
        fold_in(s0, s1, static_cast<uint32_t>(step), k0, k1);
        flag = kLive;
      }
      if (KIND == kRejection) {
        const ErjsResult r = erjs_trials(g, rule, wc, k0, k1,
                                         live ? in.bmax[cur] : 0.0f, trials,
                                         rounds, live);
        nxt = r.chosen;
        scan = r.fallback;
        if (r.fallback) flag |= kFallback;
        else if (nxt >= 0) flag |= kRjs;
      } else if (live) {
        if (in.invalid[cur]) {  // stale row: the dynamic path
          scan = true;
        } else {
          const int off =
              KIND == kPrecompIts
                  ? its_offset(g.indptr, in.cdf, in.fence, in.total,
                               in.n_edges, cur, k0, k1)
                  : alias_offset(g.indptr, in.pair, in.total, cur, k0, k1);
          if (off >= 0) {
            nxt = g.indices[g.indptr[cur] + off];
            flag |= kPrecomp;
          }
        }
      }
      for (unsigned todo = __ballot_sync(kFullWarp, scan); todo;
           todo &= todo - 1) {  // warp-uniform: one walker a scan
        const int src = __ffs(todo) - 1;
        const int64_t x = warp_scan_for(g, rule, wc, k0, k1, tile, src, lane);
        if (lane == src) {
          nxt = x;
          if (KIND != kRejection && x >= 0) flag |= kStale;
        }
      }
      const bool stepped = live && nxt >= 0;
      // the step's words wait in the warp's buffer; every kStage steps (and
      // at the last) the warp writes them as its walkers' row segments,
      // consecutive lanes on consecutive words
      const int ts = t % kStage;
      stage_e[warp][lane][ts] = stepped ? static_cast<int32_t>(nxt) : -1;
      stage_f[warp][lane][ts] = flag;
      if (ts == kStage - 1 || t == epoch_len - 1) {  // warp-uniform
        __syncwarp();
        const int m = ts + 1;  // steps in the buffer
        for (int k = lane; k < 32 * m; k += 32) {
          const int j = k / m, s = k - j * m;  // walker w0 + j, step t - ts + s
          if (w0 + j < n) {
            const int64_t at = (w0 + j) * epoch_len + t - ts + s;
            out.emitted[at] = stage_e[warp][j][s];
            out.flags[at] = stage_f[warp][j][s];
          }
        }
        __syncwarp();
      }
      bool stop = false;
      if (HOOK == HOOK_PPR_NIBBLE && stepped) {
        mass = __fmul_rn(mass, hooks.decay);  // on_step
        stop = mass < __fmul_rn(hooks.eps, __int2float_rn(deg));  // should_stop
      }
      if constexpr (HOOK == HOOK_GENERATED) {
        if (stepped) {  // the lane's own walker: it writes its slots
          const HookCtx hc{cur, prev, step, nxt, deg,
                           kGenHooksReadDegPrev ? degree(g, prev) : 0};
          generated_on_step(hc, gs, true);
          stop = generated_should_stop(hc, gs);
        }
        // the slot writes, before a warp scan reads them
        if (kGenVectorState) __syncwarp();
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
  }
  if (on) {
    out.cur[w] = cur;
    out.prev[w] = prev;
    out.step[w] = step;
    out.alive[w] = alive;
    if (HOOK == HOOK_PPR_NIBBLE) out.mass[w] = mass;
    if (HOOK == HOOK_GENERATED) gen_state_store(out.leaves, w, gs);
  }
}

// K4's instance of regime KIND and hook rule `hook` over n walkers: a
// warp a walker for the reservoir, a lane a walker for the others.
template <int KIND, int HOOK>
void launch_one(int n, cudaStream_t s, const Graph& g, const Rule& rule,
                const Hooks& hooks, const EpochIn& in, const EpochOut& out,
                int tile, int trials, int rounds, int epoch_len,
                int64_t num_steps) {
  const int threads = 256;  // kLanesWarps warps for the lane instances
  const int64_t lanes = static_cast<int64_t>(n) * (KIND == kReservoir ? 32 : 1);
  const unsigned blocks = static_cast<unsigned>((lanes + threads - 1) /
                                                threads);
  if constexpr (KIND == kReservoir) {
    fused_epoch_kernel<HOOK><<<blocks, threads, 0, s>>>(
        g, rule, hooks, in, out, n, tile, trials, rounds, epoch_len,
        num_steps);
  } else {
    fused_epoch_lanes<KIND, HOOK><<<blocks, threads, 0, s>>>(
        g, rule, hooks, in, out, n, tile, trials, rounds, epoch_len,
        num_steps);
  }
}

template <int KIND>
int launch(int hook, cudaStream_t s, const Graph& g, const Rule& rule,
           const Hooks& hooks, const EpochIn& in, const EpochOut& out, int n,
           int tile, int trials, int rounds, int epoch_len,
           int64_t num_steps) {
  switch (hook) {
    case HOOK_NONE:
      launch_one<KIND, HOOK_NONE>(n, s, g, rule, hooks, in, out, tile, trials,
                                  rounds, epoch_len, num_steps);
      break;
    case HOOK_PPR_NIBBLE:
      launch_one<KIND, HOOK_PPR_NIBBLE>(n, s, g, rule, hooks, in, out, tile,
                                        trials, rounds, epoch_len, num_steps);
      break;
#ifdef REPRO_GENERATED_RULE
    case HOOK_GENERATED:  // the instances of a header with generated hooks
      if (!kGenHooks) return static_cast<int>(cudaErrorInvalidValue);
      launch_one<KIND, HOOK_GENERATED>(n, s, g, rule, hooks, in, out, tile,
                                       trials, rounds, epoch_len, num_steps);
      break;
#endif
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
    const float* mass, void* const* leaves, const float* bmax,
    const float* cdf, const float* fence,
    int64_t n_edges, const float* total, const int2* pair, const bool* invalid,
    int n,
    int tile, int trials, int rounds, int epoch_len, int64_t num_steps,
    int32_t* emitted, int32_t* flags, int64_t* ocur, int64_t* oprev,
    int64_t* ostep, bool* oalive, float* omass, void* stream) {
  const repro::Graph g{indptr, indices, h, labels};
  const repro::Rule rule = *rule_in;
  const repro::Hooks hooks{hook, decay, eps};
  const repro::EpochIn in{cur, prev, step, alive, rng, bmax, cdf, fence,
                          n_edges, total, pair, invalid, mass};
  const repro::EpochOut out{emitted, flags, ocur, oprev, ostep, oalive, omass,
                            repro::gen_leaves(leaves)};
  auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case repro::kReservoir:
      return repro::launch<repro::kReservoir>(hook, s, g, rule, hooks, in, out,
                                              n, tile, trials, rounds,
                                              epoch_len, num_steps);
    case repro::kRejection:
      return repro::launch<repro::kRejection>(hook, s, g, rule, hooks, in, out,
                                              n, tile, trials, rounds,
                                              epoch_len, num_steps);
    case repro::kPrecompIts:
      return repro::launch<repro::kPrecompIts>(hook, s, g, rule, hooks, in,
                                               out, n, tile, trials, rounds,
                                               epoch_len, num_steps);
    case repro::kPrecompAlias:
      return repro::launch<repro::kPrecompAlias>(hook, s, g, rule, hooks, in,
                                                 out, n, tile, trials, rounds,
                                                 epoch_len, num_steps);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
