// JuicyPunch's per-sample body for one channel of one clip, as __device__
// functions that a stage kernel or the chain kernel can call.
//
// Replaces the in-kernel body of juicy_tpu/kernels/stage_kernels.py
// (_punch_kernel's follower update and _punch_shape_gain). The op order is
// that of juicy_tpu_torch/models/punch.py (follow, punch_shape), which is
// also the plain version's (PluginProcessor.cpp:92-111). Every a*b+c must
// stay two roundings: build with -fmad=false.
#pragma once

#include "precise.cuh"

namespace juicy {

// The per-block constants, in kernels/stage_kernels.py::punch_param_list
// order: the two followers' (1 - c, c) pairs, then models/punch.py
// ::shape_consts.
struct PunchConsts {
  float one_fast, fast_c, one_slow, slow_c;
  float curve_exp, punch_k, sustain_k, drive, tanh_drive, clip, hard_k, mix,
      out_gain;
};

// Fast and slow |x| followers (cpp:96-97), then the transient curve, the
// punch and sustain gains, the soft/hard clip blend, the mix and the output
// gain (cpp:99-110). tanh32(wet * drive) / tanh32(drive) stays a true
// division per sample, as in the TPU kernel.
__device__ __forceinline__ float punch_sample(float d, float& fast,
                                              float& slow,
                                              const PunchConsts& k) {
  const float a = fabsf(d);
  fast = k.one_fast * a + k.fast_c * fast;
  slow = k.one_slow * a + k.slow_c * slow;
  const float transient = max0(fast - slow);
  const float punch_gain = 1.0f + k.punch_k * pow32(transient, k.curve_exp);
  const float sustain_gain =
      1.0f + k.sustain_k * max0(slow - transient * 0.6f);
  float wet = d * punch_gain * sustain_gain;
  const float soft = tanh32(wet * k.drive) / k.tanh_drive;
  const float hard = clamp_to(wet * k.hard_k, -0.95f, 0.95f);
  wet = soft + k.clip * (hard - soft);
  return (d + k.mix * (wet - d)) * k.out_gain;
}

// punch_sample split in two for punch_stage.cu, which runs the followers
// and the shaping on different warps: the same operations in the same
// order.
__device__ __forceinline__ void punch_follow(float d, float& fast,
                                             float& slow,
                                             const PunchConsts& k) {
  const float a = fabsf(d);
  fast = k.one_fast * a + k.fast_c * fast;
  slow = k.one_slow * a + k.slow_c * slow;
}

__device__ __forceinline__ float punch_shape(float d, float fast, float slow,
                                             const PunchConsts& k) {
  const float transient = max0(fast - slow);
  const float punch_gain = 1.0f + k.punch_k * pow32(transient, k.curve_exp);
  const float sustain_gain =
      1.0f + k.sustain_k * max0(slow - transient * 0.6f);
  float wet = d * punch_gain * sustain_gain;
  const float soft = tanh32(wet * k.drive) / k.tanh_drive;
  const float hard = clamp_to(wet * k.hard_k, -0.95f, 0.95f);
  wet = soft + k.clip * (hard - soft);
  return (d + k.mix * (wet - d)) * k.out_gain;
}

}  // namespace juicy
