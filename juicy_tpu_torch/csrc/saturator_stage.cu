// Saturator full-stage kernel for Hopper (sm_90a): pre-analyze + saturator
// + post-analyze of one block, for every clip of a batch, in one launch.
//
// Replaces the TPU kernel juicy_tpu/kernels/stage_kernels.py
// ::saturator_stage_step (_sat_kernel, with the lane _lane_step,
// _lane_from_ref, _lane_reset and _store_lane). Plain version beside the
// wrapper: juicy_tpu_torch/kernels/stage_kernels.py::_sat_lanes_plain.
//
// What bounds it: every quantity is a serial per-sample recurrence (the
// envelopes, the onset cooldown, the band one-poles, the tone one-pole), so
// the kernel gives one thread to one clip, carrying both channels, and walks
// the block's samples in order. At B = 4096 clips that is only 4096 threads
// (128 warps) for 132 SMs: latency, not bytes, sets the pace. The design's
// answers are few: the input is time-major and clip-contiguous ([N, C, B]),
// so the 32 threads of a warp load 32 neighbouring floats per sample and
// channel; the lane and the tone state live in registers; the post lane
// re-reads the output the same thread has just written (L1/L2 hits).
//
// Numerics: built with -fmad=false and without fast math, so each a*b+c is
// two roundings, as in the plain version; every transcendental is a
// precise.cuh polynomial.
#include <cuda_runtime.h>

#include "lane.cuh"
#include "precise.cuh"
#include "saturator.cuh"

namespace juicy {

// x, out: [N, C, B]; tone_in, tone_out: [C, B]; lane_in, *_fin: [5, B];
// *_acc: [10, B]. Mono (C = 1) analyzes r = l.
template <int C>
__global__ void __launch_bounds__(128)
saturator_stage_kernel(const float* __restrict__ x,
                       const float* __restrict__ tone_in,
                       const float* __restrict__ lane_in,
                       float* __restrict__ out, float* __restrict__ tone_out,
                       float* __restrict__ pre_fin, float* __restrict__ pre_acc,
                       float* __restrict__ post_fin,
                       float* __restrict__ post_acc, int B, int N,
                       LaneConsts k, SatConsts p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // ragged edge of the batch
  const size_t sB = static_cast<size_t>(B);

  Lane lane = lane_load(lane_in, b, B);
  float tone[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) tone[ch] = tone_in[ch * sB + b];

  // loop 1: pre lane on the input, saturator in the same sample loop
  for (int t = 0; t < N; ++t) {
    const size_t row = static_cast<size_t>(t) * C * sB + b;
    float d[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) d[ch] = x[row + ch * sB];
    lane_step(lane, d[0], d[C - 1], k);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) out[row + ch * sB] = sat_sample(d[ch], tone[ch], p);
  }
  lane_store(lane, pre_fin, pre_acc, b, B);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) tone_out[ch * sB + b] = tone[ch];

  // loop 2: post lane on the output just written
  lane_reset(lane);
  for (int t = 0; t < N; ++t) {
    const size_t row = static_cast<size_t>(t) * C * sB + b;
    lane_step(lane, out[row], out[row + (C - 1) * sB], k);
  }
  lane_store(lane, post_fin, post_acc, b, B);
}

}  // namespace juicy

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted). Arguments are device pointers laid out as the kernel
// documents; the constants are f32 values the host computed.
int juicy_saturator_stage(const float* x, const float* tone_in,
                          const float* lane_in, float* out, float* tone_out,
                          float* pre_fin, float* pre_acc, float* post_fin,
                          float* post_acc, int B, int C, int N, float atk_s,
                          float rel_s, float atk_l, float rel_l, float low_c,
                          float high_c, float cd_samples, float in_gain,
                          float asym, float tone_c, float out_gain, float mix,
                          void* stream) {
  const juicy::LaneConsts k{atk_s, rel_s, atk_l, rel_l, low_c, high_c,
                            cd_samples};
  const juicy::SatConsts p{in_gain, asym, tone_c, out_gain, mix};
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1) {
    juicy::saturator_stage_kernel<1><<<blocks, threads, 0, s>>>(
        x, tone_in, lane_in, out, tone_out, pre_fin, pre_acc, post_fin,
        post_acc, B, N, k, p);
  } else if (C == 2) {
    juicy::saturator_stage_kernel<2><<<blocks, threads, 0, s>>>(
        x, tone_in, lane_in, out, tone_out, pre_fin, pre_acc, post_fin,
        post_acc, B, N, k, p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* juicy_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
