// JuicyWidth's per-sample body for one stereo clip, as a __device__ function
// that the chain kernel calls.
//
// Replaces the width part of juicy_tpu/kernels/chain_kernel.py::_back_kernel
// (loop W and the vectorized Haas read and mix). The op order is that of
// juicy_tpu_torch/models/width.py, which is the C++'s (PluginProcessor.cpp
// :92-138): a correlation proxy clamp(L*R*12, +-1); below -0.1 the
// block-local width is multiplied by the mono-safety limit, in sample order
// (the shrink restarts from the width param each block); M/S with
// side * (1 + w); the right channel read `delay` whole samples behind the
// write head; then mix and output gain. Every a*b+c must stay two
// roundings: build with -fmad=false.
//
// The Haas delay line is the caller's: width_widen hands back the wet right
// channel to write at the head, and the caller reads the value `delay`
// samples behind the head after that write (with delay 0, the value just
// written) and mixes it with width_mix.
#pragma once

#include "precise.cuh"

namespace juicy {

// The per-block constants, in kernels/chain_kernel.py::back_param_list
// order: width, the mono-safety limit (jmap(monoSafe, 1, 0.35)), mix,
// output gain and the delay in whole samples (as a float).
struct WidthConsts {
  float width, limit, mix, out_gain, delay;
};

// The block-local width after this sample's dip test (cpp:109-112).
__device__ __forceinline__ float width_shrink(float l, float r, float w,
                                              const WidthConsts& k) {
  const float corr = clamp_to(l * r * 12.0f, -1.0f, 1.0f);
  return corr < -0.1f ? w * k.limit : w;
}

// Mid/side widening (cpp:114-118): the wet left channel, and the wet right
// channel before the delay in `wet_r_pre`.
__device__ __forceinline__ float width_widen(float l, float r, float w,
                                             float& wet_r_pre) {
  const float mid = 0.5f * (l + r);
  const float side = 0.5f * (l - r) * (1.0f + w);
  wet_r_pre = mid - side;
  return mid + side;
}

// Mix and output gain of one channel (cpp:129-133).
__device__ __forceinline__ float width_mix(float dry, float wet,
                                           const WidthConsts& k) {
  return (dry + k.mix * (wet - dry)) * k.out_gain;
}

}  // namespace juicy
