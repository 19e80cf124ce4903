// bfloat16 storage and arithmetic for the Jacobi kernels (sm_90a).
//
// The JAX kernels compute a bfloat16 field in bfloat16: every add and
// multiply is done in float32 and rounded to bfloat16 at once (XLA's CPU
// compiler and the TPU both round after each operation). The kernels
// here copy that: each sum and product is __fadd_rn / __fmul_rn (the
// library is built -fmad=false), rounded to nearest even with
// __float2bfloat16_rn, and widened back to float32 exactly for the next
// operation. A bfloat16 cell is widened by a 16-bit shift, and a value
// that is already bfloat16-exact is stored without a second rounding.

#pragma once

#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

// dt.type(1.0 / 6.0) for bfloat16: 1/6 rounded once to bfloat16 (bits
// 0x3E2B), not float32's 1/6
constexpr float kSixthBf16 = 0.1669921875f;

// a bfloat16 cell as the float32 of the same value (exact)
__device__ __forceinline__ float ld1(const bf16* p) {
  return __uint_as_float(
      static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
      << 16);
}

// two adjacent cells p[0], p[1] by one 4-byte load (p 4-byte aligned)
__device__ __forceinline__ float2 ld2(const bf16* p) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ void st1(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// p[0] = a, p[1] = b by one 4-byte store (p 4-byte aligned)
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// cells x and x + 1 of a row (x + 1 only where `two`): one 4-byte load
// where kVec (the pair 4-byte aligned), two 2-byte loads else
template <bool kVec>
__device__ __forceinline__ float2 pair(const bf16* p, bool two) {
  if (kVec) return ld2(p);
  return make_float2(ld1(p), two ? ld1(p + 1) : 0.0f);
}

// p[0] = a and, where `two`, p[1] = b
template <bool kVec>
__device__ __forceinline__ void put_pair(bf16* p, float a, float b,
                                         bool two) {
  if (kVec) {
    st2(p, a, b);
  } else {
    st1(p, a);
    if (two) st1(p + 1, b);
  }
}

__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a + b and a * b in bfloat16: computed in float32, rounded once
__device__ __forceinline__ float add_bf16(float a, float b) {
  return rnd_bf16(__fadd_rn(a, b));
}
__device__ __forceinline__ float mul_bf16(float a, float b) {
  return rnd_bf16(__fmul_rn(a, b));
}

}  // namespace
