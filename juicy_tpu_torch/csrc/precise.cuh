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

// 2^x for |x| <= 125 (clipped outside).
__device__ __forceinline__ float exp2_32(float x) {
  x = fminf(fmaxf(x, -125.0f), 125.0f);
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

}  // namespace juicy
