// XLA's float32 CPU arithmetic as device code, shared by K1's jump
// instance (ervs.cuh), K6 (ervs_block.cu) and K8 (token_sample.cu): the
// plain versions' fma32 / xla_exp / xla_log of repro_torch/kernels/ref.py,
// operation for operation, so each kernel is bitwise with its plain
// version, which is bitwise with the reference on the CPU.
//
// XLA on the CPU evaluates exp and log with Cephes polynomials (Eigen's
// pexp / plog for float32) and contracts every multiply feeding an add
// into one fused multiply-add.  fma32 is the hardware's fused multiply-add
// (fmaf, one rounding); the plain version's fma32 computes the same value
// exactly in float64 (a sum rounded to odd).  Every other operation is
// __f*_rn, and the build adds -fmad=false, which leaves an explicit fmaf
// alone.
#pragma once
#include <math_constants.h>

namespace repro {

// float32 a * b + c rounded once.
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return fmaf(a, b, c);
}

// XLA's CPU exp of float32 (Cephes: range reduction by ln 2, degree-5
// polynomial, scale by 2^n), for finite inputs.
__device__ __forceinline__ float xla_exp(float x) {
  x = fminf(fmaxf(x, -87.80000305175781f), 88.80000305175781f);
  float fx = floorf(fma32(x, 1.4426950216293335f, 0.5f));
  fx = fminf(fmaxf(fx, -127.0f), 127.0f);
  float r = fma32(-0.693359375f, fx, x);
  r = fma32(0.00021219444170128554f, fx, r);
  float y = fma32(r, 0.00019875691214110702f, 0.001398199936375022f);
  y = fma32(y, r, 0.008333452045917511f);
  y = fma32(y, r, 0.04166579619050026f);
  y = fma32(y, r, 0.1666666567325592f);
  y = fma32(y, r, 0.5f);
  y = __fadd_rn(fma32(y, __fmul_rn(r, r), r), 1.0f);
  return __fmul_rn(y, __int_as_float((__float2int_rz(fx) + 127) << 23));
}

// XLA's CPU log of float32 (Cephes: frexp, degree-8 polynomial in three
// interleaved parts), subnormal inputs read as zero.
__device__ __forceinline__ float xla_log(float x) {
  const float flt_min = 1.1754943508222875e-38f;
  const int bits = __float_as_int(fmaxf(x, flt_min));
  float e = __fadd_rn(__int2float_rn((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & 0x807FFFFF) | 0x3F000000);
  const bool small = m < 0.7071067690849304f;
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  float v = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  const float v2 = __fmul_rn(v, v);
  const float v3 = __fmul_rn(v2, v);
  float y = fma32(fma32(v, 0.07037683576345444f, -0.11514610052108765f), v,
                  0.11676998436450958f);
  const float y1 = fma32(fma32(v, -0.12420140951871872f, 0.14249323308467865f),
                         v, -0.16668057441711426f);
  const float y2 = fma32(fma32(v, 0.2000071406364441f, -0.24999994039535522f),
                         v, 0.3333333134651184f);
  y = fma32(fma32(y, v3, y1), v3, y2);
  y = fma32(y, v3, __fmul_rn(e, -0.00021219444170128554f));
  v = __fadd_rn(fma32(-0.5f, v2, v), y);
  const float out = fma32(0.693359375f, e, v);
  if (fabsf(x) < flt_min) return -CUDART_INF_F;
  if (x == CUDART_INF_F) return CUDART_INF_F;
  return x > 0.0f ? out : CUDART_NAN_F;
}

}  // namespace repro
