// LeakyReLU in bf16 + per-channel symmetric int8 quantize of one element,
// shared by kernel B4's stream route (leaky_quantize.cu) and its fused route
// (groupnorm_onepass.cu's int8 output), so that the two cannot drift apart.
//
// The result equals the plain version (kernels/leaky_quantize.py,
// leaky_quantize_plain) code for code: x * slope rounded to bf16 where
// x < 0, x / s rounded to nearest in fp32, round half to even, clamp to
// +-127. Every step avoids the SM's quarter-rate pipes (MUFU, conversions,
// FRND) on the per-element path:
//   - bf16 rounding of x * slope by integer round-to-nearest-even (the
//     formula torch's fp32 -> bf16 cast uses);
//   - the quotient as q = x * r, corrected once by an FMA remainder, with
//     r = RN(1 / s) computed once per channel (Markstein: for a correctly
//     rounded r and no over- or underflow this is the correctly rounded
//     x / s). Channels whose scale lies outside [2^-64, 2^64] keep the IEEE
//     division (kFast = false): there 1 / s may not be a normal number, or
//     the remainder of a quotient that matters may be subnormal;
//   - clamp to +-127 first (the same codes as rounding first, since both
//     bounds are integers; NaN gives -127 and +-inf +-127, as fmaxf/fminf
//     did after rintf in the element kernel), then add 1.5 * 2^23: that
//     FADD rounds half to even, and the sum's low byte is the two's-
//     complement code.
#pragma once

#include <stdint.h>

namespace msr {

// whether quant_code<..., true> is exact for scale s
__device__ __forceinline__ bool quant_fast_ok(float s) {
  const float a = fabsf(s);
  return a >= 0x1p-64f && a <= 0x1p64f;
}

// x (a bf16 value held in fp32) through LeakyReLU, rounded to bf16
__device__ __forceinline__ float leaky_bf16(float x, float slope) {
  if (!(x < 0.f)) return x;
  uint32_t u = __float_as_uint(x * slope);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// The int8 code of leaky(x) / s in the low byte of the result (the upper
// bytes are not zero). r = __frcp_rn(s); kLeaky false means slope 1.0,
// which is exact without any work since x is already bf16.
template <bool kLeaky, bool kFast>
__device__ __forceinline__ uint32_t quant_code(float x, float slope, float s,
                                               float r) {
  if (kLeaky) x = leaky_bf16(x, slope);
  float q;
  if (kFast) {
    const float q0 = x * r;
    const float q1 = fmaf(fmaf(-q0, s, x), r, q0);
    // |q0| >= 2^20 saturates either way; it also keeps an infinite q0
    // (x * r overflowing, or x infinite) out of the FMAs, where it would
    // make a NaN
    q = fabsf(q0) < 0x1p20f ? q1 : q0;
  } else {
    q = __fdiv_rn(x, s);
  }
  return __float_as_uint(fminf(fmaxf(q, -127.f), 127.f) + 12582912.f);
}

// the low bytes of four codes as one word, a first
__device__ __forceinline__ uint32_t pack_codes(uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

}  // namespace msr
