// Drift-pinned float32 transcendentals for the CUDA kernels.
//
// The same formulas, constants and operation order as
// juicy_tpu_torch/ops/precise.py (and the numpy path of
// juicy_tpu/ops/precise.py): f32 Horner chains on IEEE mul/add/div, exact
// exponent scaling through the integer bits. Bit-identical to the plain
// version only when every a*b+c stays two roundings, so the kernels build
// with -fmad=false; CUDA's tanhf/expf/__expf are another math library and
// are not used anywhere in the kernels.
#pragma once

namespace juicy {

// 2^r = exp(r*ln2), Taylor degree 8; each coefficient is the f32 rounding of
// ln(2)^k / k! (hex literals, so that no decimal conversion can differ).
__device__ __forceinline__ float exp2_poly(float r) {
  float acc = 0x1.62c022p-20f;
  acc = acc * r + 0x1.ffcbfcp-17f;
  acc = acc * r + 0x1.430912p-13f;
  acc = acc * r + 0x1.5d87fep-10f;
  acc = acc * r + 0x1.3b2ab6p-7f;
  acc = acc * r + 0x1.c6b08ep-5f;
  acc = acc * r + 0x1.ebfbe0p-3f;
  acc = acc * r + 0x1.62e430p-1f;
  acc = acc * r + 1.0f;
  return acc;
}

// cos(z) for |z| <= 2.9: Taylor degree 20, even Horner in u = z*z; each
// coefficient is the f32 rounding of (-1)^k / (2k)!.
__device__ __forceinline__ float cos32(float z) {
  const float u = z * z;
  float acc = 0x1.e542bap-62f;
  acc = acc * u + -0x1.682786p-53f;
  acc = acc * u + 0x1.ae7f3ep-45f;
  acc = acc * u + -0x1.93974ap-37f;
  acc = acc * u + 0x1.1eed8ep-29f;
  acc = acc * u + -0x1.27e4fcp-22f;
  acc = acc * u + 0x1.a01a02p-16f;
  acc = acc * u + -0x1.6c16c2p-10f;
  acc = acc * u + 0x1.555556p-5f;
  acc = acc * u + -0.5f;
  acc = acc * u + 1.0f;
  return acc;
}

// exp(x) for x in [-2.5, 0]: Taylor degree 18; each coefficient is the f32
// rounding of 1/k!.
__device__ __forceinline__ float exp32(float x) {
  float acc = 0x1.682786p-53f;
  acc = acc * x + 0x1.952c78p-49f;
  acc = acc * x + 0x1.ae7f3ep-45f;
  acc = acc * x + 0x1.ae7f3ep-41f;
  acc = acc * x + 0x1.93974ap-37f;
  acc = acc * x + 0x1.612462p-33f;
  acc = acc * x + 0x1.1eed8ep-29f;
  acc = acc * x + 0x1.ae6456p-26f;
  acc = acc * x + 0x1.27e4fcp-22f;
  acc = acc * x + 0x1.71de3ap-19f;
  acc = acc * x + 0x1.a01a02p-16f;
  acc = acc * x + 0x1.a01a02p-13f;
  acc = acc * x + 0x1.6c16c2p-10f;
  acc = acc * x + 0x1.111112p-7f;
  acc = acc * x + 0x1.555556p-5f;
  acc = acc * x + 0x1.555556p-3f;
  acc = acc * x + 0x1p-1f;
  acc = acc * x + 0x1p+0f;
  acc = acc * x + 0x1p+0f;
  return acc;
}

// exp(x) for x in [-0.7, 0]: the degree-9 truncation of exp32's series.
__device__ __forceinline__ float exp32_narrow(float x) {
  float acc = 0x1.71de3ap-19f;
  acc = acc * x + 0x1.a01a02p-16f;
  acc = acc * x + 0x1.a01a02p-13f;
  acc = acc * x + 0x1.6c16c2p-10f;
  acc = acc * x + 0x1.111112p-7f;
  acc = acc * x + 0x1.555556p-5f;
  acc = acc * x + 0x1.555556p-3f;
  acc = acc * x + 0.5f;
  acc = acc * x + 1.0f;
  acc = acc * x + 1.0f;
  return acc;
}

// sin(x) for |x| <= 7.2: branch-free reduction to [-pi, pi] (two steps each
// way), the fold sin(pi - x) = sin(x) to [-pi/2, pi/2], then an odd Horner
// polynomial of degree 13 whose coefficients are the f32 roundings of
// (-1)^k / (2k+1)!.
__device__ __forceinline__ float sin32(float x) {
  constexpr float kPi = 0x1.921fb6p+1f;
  constexpr float kTwoPi = 0x1.921fb6p+2f;
  constexpr float kHalfPi = 0x1.921fb6p+0f;
  x = x > kPi ? x - kTwoPi : x;
  x = x > kPi ? x - kTwoPi : x;
  x = x < -kPi ? x + kTwoPi : x;
  x = x < -kPi ? x + kTwoPi : x;
  x = x > kHalfPi ? kPi - x : x;
  x = x < -kHalfPi ? -kPi - x : x;
  const float u = x * x;
  float acc = 0x1.612462p-33f;
  acc = acc * u + -0x1.ae6456p-26f;
  acc = acc * u + 0x1.71de3ap-19f;
  acc = acc * u + -0x1.a01a02p-13f;
  acc = acc * u + 0x1.111112p-7f;
  acc = acc * u + -0x1.555556p-3f;
  acc = acc * u + 1.0f;
  return x * acc;
}

// The clamps and extrema of the plain version keep a NaN (torch.clamp,
// torch.maximum and torch.minimum, as jnp.clip and the C++ jlimit do), where
// fminf and fmaxf would map it to the other operand. PTX's max.NaN and
// min.NaN give NaN when either operand is NaN, in one instruction, as
// cheap as max and min; for any other operands they are max and min, the
// operations fmaxf and fminf compile to. The NaN they give is the
// canonical one, the NaN every arithmetic result on the card already is.

// torch.maximum(a, b) and torch.minimum(a, b)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// torch.clamp(x, lo, hi)
__device__ __forceinline__ float clamp_to(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

// torch.clamp(x, min=0)
__device__ __forceinline__ float max0(float x) { return max_nan(x, 0.0f); }

// 2^x for |x| <= 125 (clipped outside; a NaN stays NaN).
__device__ __forceinline__ float exp2_32(float x) {
  x = clamp_to(x, -125.0f, 125.0f);
  const float k = rintf(x);               // ties to even, as np.rint
  const float r = x - k;
  const float two_k = __int_as_float((static_cast<int>(k) + 127) << 23);
  return exp2_poly(r) * two_k;
}

// tanh(x) = sign(x) * (1 - 2 / (2^(2|x| log2 e) + 1)), exactly +-1 beyond
// |x| > 9.1.
__device__ __forceinline__ float tanh32(float x) {
  const float ax = fabsf(x);
  const float sign = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  const float e2 = exp2_32(ax * 0x1.715476p+1f);  // f32(2) * f32(log2 e)
  float t = 1.0f - 2.0f / (e2 + 1.0f);
  t = ax > 0x1.233334p+3f ? 1.0f : t;               // f32(9.1)
  return sign * t;
}

// log2(x) for normal positive x: the exponent from the bits, the mantissa
// folded to [sqrt(2)/2, sqrt(2)] and an atanh series in s = (m-1)/(m+1),
// coefficients the f32 roundings of 2/(ln 2 (2k+1)).
__device__ __forceinline__ float log2_32(float x) {
  const int bits = __float_as_int(x);
  int e = ((bits >> 23) & 0xFF) - 127;
  float m = __int_as_float((bits & 0x7FFFFF) | 0x3F800000);
  const bool big = m > 0x1.6a09e6p+0f;  // f32(sqrt 2)
  m = big ? m * 0.5f : m;
  e += big ? 1 : 0;
  const float s = (m - 1.0f) / (m + 1.0f);
  const float u = s * s;
  float acc = 0x1.0c9a84p-2f;
  acc = acc * u + 0x1.484b14p-2f;
  acc = acc * u + 0x1.a61762p-2f;
  acc = acc * u + 0x1.2776c6p-1f;
  acc = acc * u + 0x1.ec709ep-1f;
  acc = acc * u + 0x1.715476p+1f;
  return static_cast<float>(e) + s * acc;
}

// a^b for a > 0 as exp2(b log2 a); a = 0 gives 2^-125 scaled, as on every
// other path.
__device__ __forceinline__ float pow32(float a, float b) {
  return exp2_32(b * log2_32(a));
}

// 1 - exp(-2 pi f / sr) for a per-sample cutoff f; `narrow` when the
// caller's cutoff bound keeps the argument in [-0.7, 0] (the host decides,
// as ops/precise.py::onepole_coeff32 does).
__device__ __forceinline__ float onepole_coeff32(float f, float sr,
                                                 bool narrow) {
  const float arg = (-0x1.921fb6p+2f * f) / sr;
  return 1.0f - (narrow ? exp32_narrow(arg) : exp32(arg));
}

// One step of the reference's 32-bit LCG, with native u32 wrap.
__device__ __forceinline__ unsigned lcg_step(unsigned r) {
  return r * 1664525u + 1013904223u;
}

}  // namespace juicy
