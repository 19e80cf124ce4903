// bfloat16 storage and arithmetic for the Jacobi kernels and B8 (sm_90a).
//
// The JAX kernels compute a bfloat16 field in bfloat16: every add and
// multiply is done in float32 and rounded to bfloat16 at once (XLA's CPU
// compiler and the TPU both round after each operation), and the plain
// twins do the same (PyTorch's bfloat16 ops on the card).
//
// Two ways to give those bits here:
//   - packed (the Jacobi ring kernel, B8): Hopper's bfloat16 add and
//     multiply on both halves of a 32-bit bfloat16x2 register (add2,
//     mul2) or on one 16-bit value (add1, mul1), each result rounded ONCE
//     to nearest even from the exact result. That equals the float32
//     operation rounded to bfloat16: a product of two 8-bit significands
//     is exact in float32 (in float32's subnormal range its 16 bits
//     cannot reach both a bfloat16 midpoint and below float32's last
//     bit), and a float32 sum of two bfloat16 values is inexact only
//     where their exponents differ by 16 or more, where both roundings
//     give the larger operand (tests/test_torch_bf16_rounding.py holds
//     this on the CPU against exact fractions). The explicit .rn keeps
//     ptxas from fusing a multiply and an add. Nothing is widened and
//     nothing converted. A NaN result carries the card's own NaN bits,
//     which may differ from the twin's (PyTorch's conversion writes
//     0x7FC0) in sign and payload: both are NaN, their bits may differ;
//   - widened (K1, K3, B5, B7): each sum and product is __fadd_rn /
//     __fmul_rn on widened cells (the libraries are built -fmad=false),
//     rounded with __float2bfloat16_rn and widened back exactly for the
//     next operation. A bfloat16 cell is widened by a 16-bit shift, and a
//     value that is already bfloat16-exact is stored without a second
//     rounding.

#pragma once

#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

// dt.type(1.0 / 6.0) for bfloat16: 1/6 rounded once to bfloat16 (bits
// 0x3E2B), not float32's 1/6
constexpr float kSixthBf16 = 0.1669921875f;

// ---------------------------------------------------------------------
// packed: two lanes a 32-bit register (lane 0 in the low half), or one
// 16-bit value
// ---------------------------------------------------------------------

// bf16(1/6) and 1.0 in both lanes
constexpr unsigned kSixth2 = 0x3E2B3E2Bu;
constexpr unsigned short kSixth1 = 0x3E2B;
constexpr unsigned short kOne1 = 0x3F80;

// two bfloat16-exact floats packed without rounding
__device__ __forceinline__ unsigned pk(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned mul2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned short add1(unsigned short a,
                                               unsigned short b) {
  unsigned short d;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}
__device__ __forceinline__ unsigned short mul1(unsigned short a,
                                               unsigned short b) {
  unsigned short d;
  asm("mul.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}

// the bits of a bfloat16 cell, and of two adjacent cells p[0] (low half)
// and p[1] by one 4-byte load (p 4-byte aligned)
__device__ __forceinline__ unsigned short bits1(const bf16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}
__device__ __forceinline__ unsigned bits2(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// ---------------------------------------------------------------------
// widened: cells as the float32 of the same value
// ---------------------------------------------------------------------

// a bfloat16 cell as the float32 of the same value (exact)
__device__ __forceinline__ float ld1(const bf16* p) {
  return __uint_as_float(static_cast<unsigned>(bits1(p)) << 16);
}

// two adjacent cells p[0], p[1] by one 4-byte load (p 4-byte aligned)
__device__ __forceinline__ float2 ld2(const bf16* p) {
  const unsigned u = bits2(p);
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
