// JuicyCohere's per-sample and per-block bodies for one clip, as __device__
// functions that the chain kernel calls: the mono 3-band analysis, the
// block's learn EMA / context fit / band gains, and the per-channel render.
//
// Replaces the cohere part of juicy_tpu/kernels/chain_kernel.py
// ::_back_kernel (loop 1's analysis, the block-level learn/fit/gains, loop
// 2's render). The op order is that of juicy_tpu_torch/models/cohere.py
// (analysis, block_gains, render), which is the C++'s
// (PluginProcessor.cpp:62-118). The three (e + eps) / (t + eps) ratios of
// the error and the three of the gains, and the division of the deviation by
// 3, stay true divisions. Every a*b+c must stay two roundings: build with
// -fmad=false.
#pragma once

#include "precise.cuh"

namespace juicy {

// The per-block constants, in kernels/chain_kernel.py::back_param_list
// order: the 220 Hz and 2400 Hz one-pole coefficients, then match, learn,
// decay, tail, mix and output gain, then (for the caller) the infer trim
// gain and 1/n.
struct CohereConsts {
  float low_c, high_c, match, learn, decay, tail, mix, out_gain;
};

// The analysis filters and the band energy sums of one block.
struct CohereAnalysis {
  float lo, hi, le, me, he;
};

// One mono analysis sample (cpp:62-76).
__device__ __forceinline__ void cohere_analyze(CohereAnalysis& a, float m,
                                               const CohereConsts& k) {
  a.lo = a.lo + k.low_c * (m - a.lo);
  a.hi = a.hi + k.high_c * (m - a.hi);
  const float high_v = m - a.hi;
  const float mid_v = m - a.lo - high_v;
  a.le = a.le + a.lo * a.lo;
  a.me = a.me + mid_v * mid_v;
  a.he = a.he + high_v * high_v;
}

// utils/convert.py::gain_to_db: (20 / log2 10) * log2(gain), floored at
// -100 dB.
__device__ __forceinline__ float cohere_gain_to_db(float gain) {
  const float db = 0x1.815182p+2f * log2_32(fmaxf(gain, 0x1.4484cp-100f));
  return gain > 0.0f ? fmaxf(db, -100.0f) : -100.0f;
}

// The block's band gains from the mean band energies (cpp:78-96): the learn
// EMA moves the targets `t` in place, `fit` is the context fit, `g` the
// low/mid/high gains.
__device__ __forceinline__ void cohere_block_gains(float le, float me,
                                                   float he, float* t,
                                                   float& fit, float* g,
                                                   const CohereConsts& k) {
  constexpr float eps = 1.0e-6f;
  const float e[3] = {le, me, he};
  if (k.learn > 0.5f) {
#pragma unroll
    for (int j = 0; j < 3; ++j) t[j] = t[j] + (e[j] - t[j]) * 0.02f;
  }
  float err[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    err[j] = fabsf(cohere_gain_to_db((e[j] + eps) / (t[j] + eps)));
  const float deviation = (err[0] + err[1] + err[2]) / 3.0f;
  fit = clamp_to(100.0f - deviation * 10.0f, 0.0f, 100.0f);
  const float expo = 0.25f * k.match;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    g[j] = clamp_to(pow32((t[j] + eps) / (e[j] + eps), expo), 0.5f, 1.8f);
}

// One render sample of one channel (cpp:99-118), the split filters lp_a and
// lp_b from zero at the block's start; `fb` is clamp(decay, 0, 0.93) and
// `tail_k` tail * 0.35. Returns the mixed output before the infer trim.
__device__ __forceinline__ float cohere_render(float d, float& lp_a,
                                               float& lp_b, float& tail,
                                               const float* g, float fb,
                                               float tail_k,
                                               const CohereConsts& k) {
  lp_a = lp_a + k.low_c * (d - lp_a);
  lp_b = lp_b + k.high_c * (d - lp_b);
  const float low_v = lp_a * g[0];
  const float high_v = (d - lp_b) * g[2];
  const float mid_v = (d - lp_a - (d - lp_b)) * g[1];
  const float matched = low_v + mid_v + high_v;
  tail = matched + tail * fb;
  const float wet = matched + tail_k * tail;
  return (d + k.mix * (wet - d)) * k.out_gain;
}

}  // namespace juicy
