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
// Design (simple first): a grid of (row, 4,096-token chunk) blocks of 256
// threads; thread t takes tokens t, t + 256, ... of its chunk, draws their
// noise in registers (no [B, V] noise tensor exists) and keeps its best
// (key, index); the block reduces by shuffles and shared memory to one
// pair per chunk.  A second launch of one warp per row reduces the row's
// chunk pairs, lower index first on equal keys.  The TPU kernel's (8 rows
// x 512 lanes) blocks and its sequential carry across vocab blocks are
// TPU shape and are not carried over: blocks here run in no order.
//
// What bounds it on the H100: sampled, the operations — per token a
// Threefry-2x32 (~122 integer operations) and two Cephes logs — against
// 4 bytes of logits; greedy, reading the logits once.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

#include "threefry.cuh"
#include "xla_math.cuh"

namespace repro {

constexpr int kTokenThreads = 256;
constexpr int kTokenChunk = kTokenThreads * 16;  // tokens per block
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

template <bool GREEDY>
__global__ void __launch_bounds__(kTokenThreads)
token_chunk_kernel(const float* __restrict__ logits,
                   const int64_t* __restrict__ seed, int vocab, float inv_t,
                   float* __restrict__ part_key,
                   int32_t* __restrict__ part_idx) {
  const int row = blockIdx.x;
  const int chunk = blockIdx.y;
  const float* lg = logits + static_cast<int64_t>(row) * vocab;
  uint32_t k0 = 0, k1 = 0;
  if (!GREEDY) {
    k0 = static_cast<uint32_t>(seed[0]) + static_cast<uint32_t>(row);
    k1 = static_cast<uint32_t>(seed[1]);
  }
  float best = -CUDART_INF_F;
  int32_t arg = INT32_MAX;  // loses to any token, even at key -inf
  const int end = min(vocab, (chunk + 1) * kTokenChunk);
  for (int v = chunk * kTokenChunk + threadIdx.x; v < end;
       v += kTokenThreads) {
    float key = lg[v];
    if (!GREEDY) {
      const float u =
          uniform_01(k0, k1, static_cast<uint32_t>(v), kTokenSalt);
      key = fma32(key, inv_t, -xla_log(-xla_log(u)));
    }
    if (ranks_before(key, v, best, arg)) {  // v rises: first max kept
      best = key;
      arg = v;
    }
  }
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
    if (lane == 0) {
      const int64_t at = static_cast<int64_t>(row) * gridDim.y + chunk;
      part_key[at] = best;
      part_idx[at] = arg;
    }
  }
}

// One warp per row over the row's chunk pairs.
__global__ void token_row_kernel(const float* __restrict__ part_key,
                                 const int32_t* __restrict__ part_idx,
                                 int chunks, int32_t* __restrict__ out) {
  const int row = blockIdx.x;
  float best = -CUDART_INF_F;
  int32_t arg = INT32_MAX;
  for (int c = threadIdx.x; c < chunks; c += 32) {
    const int64_t at = static_cast<int64_t>(row) * chunks + c;
    if (ranks_before(part_key[at], part_idx[at], best, arg)) {
      best = part_key[at];
      arg = part_idx[at];
    }
  }
  warp_argmax(best, arg);
  if (threadIdx.x == 0) out[row] = arg;
}

}  // namespace repro

extern "C" int repro_token_sample_chunks(int vocab) {
  return (vocab + repro::kTokenChunk - 1) / repro::kTokenChunk;
}

// logits [rows, vocab] float32, seed [2] int64 holding uint32; scratch
// part_key / part_idx [rows, chunks]; out [rows] int32.  rows >= 1,
// 1 <= vocab, chunks <= 65,535.
extern "C" int repro_token_sample(const float* logits, const int64_t* seed,
                                  int rows, int vocab, float inv_t,
                                  int greedy, float* part_key,
                                  int32_t* part_idx, int32_t* out,
                                  void* stream) {
  const int chunks = repro_token_sample_chunks(vocab);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(rows, chunks);
  if (greedy) {
    repro::token_chunk_kernel<true><<<grid, repro::kTokenThreads, 0, s>>>(
        logits, seed, vocab, inv_t, part_key, part_idx);
  } else {
    repro::token_chunk_kernel<false><<<grid, repro::kTokenThreads, 0, s>>>(
        logits, seed, vocab, inv_t, part_key, part_idx);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  repro::token_row_kernel<<<rows, 32, 0, s>>>(part_key, part_idx, chunks,
                                              out);
  return static_cast<int>(cudaGetLastError());
}
