// JuicySaturator's per-sample body for one channel of one clip, as a
// __device__ function that a stage kernel or the chain kernel can call.
//
// Replaces the in-kernel body of juicy_tpu/kernels/stage_kernels.py
// (_sat_kernel's drive/skew/tanh/tone/mix). The op order is that of
// juicy_tpu_torch/models/saturator.py (sat_pre, sat_post), which is also the
// plain version's. Every a*b+c must stay two roundings: build with
// -fmad=false.
#pragma once

#include "precise.cuh"

namespace juicy {

// The per-block constants, in models/saturator.py::sat_consts order
// (kernels/stage_kernels.py::_sat_scalars after the lane constants).
struct SatConsts {
  float in_gain, asym, tone_c, out_gain, mix;
};

// drive -> asymmetric skew -> tanh (sat_soft, which reads no state) ->
// tone one-pole -> output gain -> mix (sat_tone_mix, which carries the
// tone). saturator_stage.cu runs the two parts on different warps.
__device__ __forceinline__ float sat_soft(float d, const SatConsts& p) {
  const float driven = d * p.in_gain;
  const float skewed = driven + p.asym * driven * driven;
  return tanh32(skewed);
}

__device__ __forceinline__ float sat_tone_mix(float d, float soft,
                                              float& tone,
                                              const SatConsts& p) {
  tone = tone + p.tone_c * (soft - tone);
  const float wet = tone * p.out_gain;
  return d + p.mix * (wet - d);
}

__device__ __forceinline__ float sat_sample(float d, float& tone,
                                            const SatConsts& p) {
  return sat_tone_mix(d, sat_soft(d, p), tone, p);
}

}  // namespace juicy
