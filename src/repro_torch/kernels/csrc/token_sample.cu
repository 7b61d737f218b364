// K8 — Gumbel-max token sampling over [B, V] float32 logits on Hopper.
//
// Replaces the TPU kernel repro/kernels/token_sampler.py:68 token_sample
// (body _token_kernel :32, pallas_call :85); its plain version is
// repro_torch/kernels/ref.py:token_sample_ref.  For row b the key of token
// v is
//
//   key = logit * inv_t + g,  g = -log(-log(u)),
//   u   = uniform_01(seed0 + b mod 2^32, seed1, v, 0x700C0DE)
//
// (greedy: key = logit), and the row's token is the lowest index of the
// largest key — the reference's running tile carry updates on a strict
// ">" and argmax takes the first maximum.  NaN ranks above every number,
// as argmax takes it.  The multiply-add and the logs are XLA's CPU
// arithmetic (xla_math.cuh), so K8 is bitwise with its plain version,
// which is bitwise with the reference.
//
// What bounds it on the H100: greedy, reading the logits once (4 B a
// token); sampled, the operations — per token a Threefry-2x32 (~122
// integer operations) and two Cephes logs.  At decode batch 8 the whole
// read is 4.9 MB, a few microseconds: there the launch and the wrapper's
// host work are the cost.
//
// Design: one launch.  A grid of (row, 4,096-token chunk) blocks of 256
// threads; each thread loads its 16 tokens as four 16-byte loads issued
// together (scalar loads, 16 a thread, when the row is not 16-byte
// aligned or V % 4 != 0: with as many bytes in flight they read [128, V]
// markedly slower, as chip_smoke.py's phase 1b shows by timing both), draws
// their noise in registers (no [B, V] noise tensor exists) and
// keeps its best (key, index); the block reduces by shuffles and shared
// memory and writes its chunk's pair.  Then it counts itself in on the
// row's arrival counter; the row's last block reduces the row's pairs and
// writes the token, and resets the counter to 0, so the scratch (pairs
// and counters, kept by the wrapper) needs no clearing between calls.
// The TPU kernel's (8 rows x 512 lanes) blocks and its sequential carry
// across vocab blocks are TPU shape and are not carried over: blocks here
// run in no order, and the order of the comparisons does not change the
// winner, because (NaN, key, index) ranks every pair.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

#include "threefry.cuh"
#include "xla_math.cuh"

namespace repro {

constexpr int kTokenThreads = 256;
constexpr int kTokenLoads = 4;  // 16-byte loads in flight per thread
constexpr int kTokenPerThread = 4 * kTokenLoads;
constexpr int kTokenChunk = kTokenThreads * kTokenPerThread;  // 4,096
constexpr uint32_t kTokenSalt = 0x700C0DEu;
constexpr unsigned kAllLanes = 0xffffffffu;

// argmax order: NaN first, then the larger key, then the lower index.
__device__ __forceinline__ bool ranks_before(float ka, int32_t ia, float kb,
                                             int32_t ib) {
  const bool na = ka != ka, nb = kb != kb;
  if (na != nb) return na;
  if (!na && ka != kb) return ka > kb;
  return ia < ib;
}

__device__ __forceinline__ void warp_argmax(float& key, int32_t& idx) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float k = __shfl_down_sync(kAllLanes, key, s);
    const int32_t i = __shfl_down_sync(kAllLanes, idx, s);
    if (ranks_before(k, i, key, idx)) {
      key = k;
      idx = i;
    }
  }
}

// Token v with logit x into the thread's best pair.
template <bool GREEDY>
__device__ __forceinline__ void take_token(float x, int32_t v, uint32_t k0,
                                           uint32_t k1, float inv_t,
                                           float& best, int32_t& arg) {
  float key = x;
  if (!GREEDY) {
    const float u = uniform_01(k0, k1, static_cast<uint32_t>(v), kTokenSalt);
    key = fma32(x, inv_t, -xla_log(-xla_log(u)));
  }
  if (ranks_before(key, v, best, arg)) {
    best = key;
    arg = v;
  }
}

// Block-wide best pair; the result is valid in thread 0.
__device__ __forceinline__ void block_argmax(float& best, int32_t& arg) {
  __shared__ float warp_key[kTokenThreads / 32];
  __shared__ int32_t warp_idx[kTokenThreads / 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  warp_argmax(best, arg);
  if (lane == 0) {
    warp_key[warp] = best;
    warp_idx[warp] = arg;
  }
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < kTokenThreads / 32;
    best = has ? warp_key[lane] : -CUDART_INF_F;
    arg = has ? warp_idx[lane] : INT32_MAX;
    warp_argmax(best, arg);
  }
}

template <bool GREEDY, bool VEC>
__global__ void __launch_bounds__(kTokenThreads)
token_sample_kernel(const float* __restrict__ logits,
                    const int64_t* __restrict__ seed, int vocab, int chunks,
                    float inv_t, float* __restrict__ part_key,
                    int32_t* __restrict__ part_idx,
                    unsigned* __restrict__ arrived,
                    int32_t* __restrict__ out) {
  const int row = blockIdx.x / chunks;
  const int chunk = blockIdx.x - row * chunks;
  const float* lg = logits + static_cast<int64_t>(row) * vocab;
  uint32_t k0 = 0, k1 = 0;
  if (!GREEDY) {
    k0 = static_cast<uint32_t>(seed[0]) + static_cast<uint32_t>(row);
    k1 = static_cast<uint32_t>(seed[1]);
  }
  float best = -CUDART_INF_F;
  int32_t arg = INT32_MAX;  // loses to any token, even at key -inf
  const int base = chunk * kTokenChunk;
  if (VEC) {  // vocab % 4 == 0, so a vector that starts in the row ends in it
    const float4* lg4 = reinterpret_cast<const float4*>(lg);
    float4 x[kTokenLoads];
#pragma unroll
    for (int k = 0; k < kTokenLoads; ++k) {
      const int v = base + 4 * (threadIdx.x + kTokenThreads * k);
      if (v < vocab) x[k] = __ldcs(lg4 + v / 4);
    }
#pragma unroll
    for (int k = 0; k < kTokenLoads; ++k) {
      const int v = base + 4 * (threadIdx.x + kTokenThreads * k);
      if (v < vocab) {
        take_token<GREEDY>(x[k].x, v, k0, k1, inv_t, best, arg);
        take_token<GREEDY>(x[k].y, v + 1, k0, k1, inv_t, best, arg);
        take_token<GREEDY>(x[k].z, v + 2, k0, k1, inv_t, best, arg);
        take_token<GREEDY>(x[k].w, v + 3, k0, k1, inv_t, best, arg);
      }
    }
  } else {
    float x[kTokenPerThread];
#pragma unroll
    for (int k = 0; k < kTokenPerThread; ++k) {
      const int v = base + threadIdx.x + kTokenThreads * k;
      if (v < vocab) x[k] = __ldcs(lg + v);
    }
#pragma unroll
    for (int k = 0; k < kTokenPerThread; ++k) {
      const int v = base + threadIdx.x + kTokenThreads * k;
      if (v < vocab) take_token<GREEDY>(x[k], v, k0, k1, inv_t, best, arg);
    }
  }
  block_argmax(best, arg);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    const int64_t at = static_cast<int64_t>(row) * chunks + chunk;
    part_key[at] = best;
    part_idx[at] = arg;
    __threadfence();  // the pair is visible before the block counts in
    last = atomicAdd(arrived + row, 1u) == static_cast<unsigned>(chunks - 1);
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  // the row's last block: every other block's pair is written
  __threadfence();
  best = -CUDART_INF_F;
  arg = INT32_MAX;
  const int64_t row0 = static_cast<int64_t>(row) * chunks;
  for (int c = threadIdx.x; c < chunks; c += 32) {
    const float k = __ldcg(part_key + row0 + c);
    const int32_t i = __ldcg(part_idx + row0 + c);
    if (ranks_before(k, i, best, arg)) {
      best = k;
      arg = i;
    }
  }
  warp_argmax(best, arg);
  if (threadIdx.x == 0) {
    out[row] = arg;
    arrived[row] = 0u;  // ready for the next call on this stream
  }
}

template <bool GREEDY>
cudaError_t launch(bool vec, int blocks, cudaStream_t s,
                   const float* logits, const int64_t* seed, int vocab,
                   int chunks, float inv_t, float* part_key,
                   int32_t* part_idx, unsigned* arrived, int32_t* out) {
  if (vec) {
    token_sample_kernel<GREEDY, true><<<blocks, kTokenThreads, 0, s>>>(
        logits, seed, vocab, chunks, inv_t, part_key, part_idx, arrived,
        out);
  } else {
    token_sample_kernel<GREEDY, false><<<blocks, kTokenThreads, 0, s>>>(
        logits, seed, vocab, chunks, inv_t, part_key, part_idx, arrived,
        out);
  }
  return cudaGetLastError();
}

}  // namespace repro

// logits [rows, vocab] float32, seed [2] int64 holding uint32; scratch
// part_key / part_idx [rows * chunks], arrived [rows] uint32, all 0 before
// the first call (the kernel leaves them 0); out [rows] int32.  rows >= 1,
// vocab >= 1, chunks = ceil(vocab / 4,096) (the wrapper computes it;
// anything else is refused), rows * chunks < 2^31.
extern "C" int repro_token_sample(const float* logits, const int64_t* seed,
                                  int rows, int vocab, int chunks,
                                  float inv_t, int greedy, float* part_key,
                                  int32_t* part_idx, unsigned* arrived,
                                  int32_t* out, void* stream) {
  if (rows < 1 || vocab < 1 ||
      chunks != (vocab + repro::kTokenChunk - 1) / repro::kTokenChunk ||
      static_cast<int64_t>(rows) * chunks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec =
      vocab % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0;
  const int blocks = rows * chunks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      greedy ? repro::launch<true>(vec, blocks, s, logits, seed, vocab,
                                   chunks, inv_t, part_key, part_idx,
                                   arrived, out)
             : repro::launch<false>(vec, blocks, s, logits, seed, vocab,
                                    chunks, inv_t, part_key, part_idx,
                                    arrived, out);
  return static_cast<int>(err);
}
