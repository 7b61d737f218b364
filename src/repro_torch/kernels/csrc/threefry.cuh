// Counter-based Threefry-2x32 (20 rounds) as device code, bit-compatible
// with repro_torch/kernels/prng.py and with jax.random's threefry under
// jax_threefry_partitionable=True:
//   fold_in(k, d)      = threefry(k, (0, d))
//   bits(k, (n,))[i]   = r0 ^ r1 of threefry(k, (0, i)); a scalar draw uses i = 0
//   uniform(minval=1e-12) and the kernels' uniform_01 / uniform_pair_01
//   as below.
// Float maps use __f*_rn so nvcc never contracts them into an FMA (the
// reference rounds the multiply and the add separately).
#pragma once
#include <cstdint>

namespace repro {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t& r0, uint32_t& r1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, rot[(block % 2) * 4 + r]) ^ x0;
    }
    const int inj = block + 1;
    x0 += ks[inj % 3];
    x1 += ks[(inj + 1) % 3] + static_cast<uint32_t>(inj);
  }
  r0 = x0;
  r1 = x1;
}

// jax.random.fold_in on raw key data.
__device__ __forceinline__ void fold_in(uint32_t k0, uint32_t k1, uint32_t d,
                                        uint32_t& o0, uint32_t& o1) {
  threefry2x32(k0, k1, 0u, d, o0, o1);
}

// Lane i of jax.random.bits(key, (n,)).
__device__ __forceinline__ uint32_t random_bits(uint32_t k0, uint32_t k1,
                                                uint32_t i) {
  uint32_t r0, r1;
  threefry2x32(k0, k1, 0u, i, r0, r1);
  return r0 ^ r1;
}

// jax.random.uniform(float32, minval=1e-12, maxval=1.0) from its bits:
// 23 mantissa bits into [1, 2), minus 1, times (maxval - minval), plus
// minval, clamped below by minval.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  const float lo = __double2float_rn(1e-12);
  const float scale = __fsub_rn(1.0f, lo);
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, __fadd_rn(__fmul_rn(f, scale), lo));
}

// The reference kernels' uniform_01: top 24 bits of r0 plus a half ulp.
__device__ __forceinline__ float uniform_01(uint32_t k0, uint32_t k1,
                                            uint32_t c0, uint32_t c1) {
  uint32_t r0, r1;
  threefry2x32(k0, k1, c0, c1, r0, r1);
  const float f = __uint2float_rn(r0 >> 8);
  return __fadd_rn(__fmul_rn(f, 1.0f / 16777216.0f), 0.5f / 16777216.0f);
}

// The reference kernels' uniform_pair_01: the same map on r0 and on r1.
__device__ __forceinline__ void uniform_pair_01(uint32_t k0, uint32_t k1,
                                                uint32_t c0, uint32_t c1,
                                                float& u0, float& u1) {
  uint32_t r0, r1;
  threefry2x32(k0, k1, c0, c1, r0, r1);
  u0 = __fadd_rn(__fmul_rn(__uint2float_rn(r0 >> 8), 1.0f / 16777216.0f),
                 0.5f / 16777216.0f);
  u1 = __fadd_rn(__fmul_rn(__uint2float_rn(r1 >> 8), 1.0f / 16777216.0f),
                 0.5f / 16777216.0f);
}

}  // namespace repro
