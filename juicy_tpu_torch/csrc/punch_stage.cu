// Punch full-stage kernel for Hopper (sm_90a): pre-analyze + punch +
// post-analyze of one block, for every clip of a batch, in one launch.
//
// Replaces the TPU kernel juicy_tpu/kernels/stage_kernels.py
// ::punch_stage_step (_punch_kernel, _punch_shape_gain). Plain version
// beside the wrapper: juicy_tpu_torch/kernels/stage_kernels.py
// ::_punch_lanes_plain.
//
// What bounds it: the two followers and the analyzer lane are serial
// per-sample recurrences, so one thread carries one clip (both channels)
// through the block in order, as in the saturator kernel; per channel-sample
// the body adds a pow32 (log2 and exp2 polynomials) and a tanh32 to the
// saturator's work. At B = 4096 that is 128 warps, launched as 32-thread
// blocks so that each warp gets an SM of its own: latency, not bytes, sets
// the pace. Audio is time-major and clip-contiguous ([N, C, B]) so a warp's
// loads and stores coalesce; the followers and the lane live in registers;
// the post lane re-reads the output the thread has just written.
//
// Numerics: built with -fmad=false and without fast math; every
// transcendental is a precise.cuh polynomial.
#include <cuda_runtime.h>

#include <cstring>

#include "lane.cuh"
#include "precise.cuh"
#include "punch.cuh"

namespace juicy {

constexpr int kPunchThreads = 32;

// x, out: [N, C, B]; env_in/out: [2, B, C] (fast, slow); lane_in, *_fin:
// [5, B]; *_acc: [10, B]. Mono analyzes r = l.
template <int C>
__global__ void __launch_bounds__(kPunchThreads)
punch_stage_kernel(const float* __restrict__ x,
                   const float* __restrict__ env_in,
                   const float* __restrict__ lane_in, float* __restrict__ out,
                   float* __restrict__ env_out, float* __restrict__ pre_fin,
                   float* __restrict__ pre_acc, float* __restrict__ post_fin,
                   float* __restrict__ post_acc, int B, int N, LaneConsts lk,
                   PunchConsts k) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // ragged edge of the batch
  const size_t sB = static_cast<size_t>(B);

  Lane lane = lane_load(lane_in, b, B);
  float fast[C], slow[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    fast[ch] = env_in[b * C + ch];
    slow[ch] = env_in[(sB + b) * C + ch];
  }

  // loop 1: pre lane on the input, punch in the same sample loop
  for (int t = 0; t < N; ++t) {
    const size_t row = static_cast<size_t>(t) * C * sB + b;
    float d[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) d[ch] = x[row + ch * sB];
    lane_step(lane, d[0], d[C - 1], lk);
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      out[row + ch * sB] = punch_sample(d[ch], fast[ch], slow[ch], k);
  }
  lane_store(lane, pre_fin, pre_acc, b, B);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    env_out[b * C + ch] = fast[ch];
    env_out[(sB + b) * C + ch] = slow[ch];
  }

  // loop 2: post lane on the output just written
  lane_reset(lane);
  for (int t = 0; t < N; ++t) {
    const size_t row = static_cast<size_t>(t) * C * sB + b;
    lane_step(lane, out[row], out[row + (C - 1) * sB], lk);
  }
  lane_store(lane, post_fin, post_acc, b, B);
}

}  // namespace juicy

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted). Device pointers are laid out as the kernel
// documents; `consts` is a host array of the 7 lane constants and the 13
// punch constants (punch_param_list order).
int juicy_punch_stage(const float* x, const float* env_in,
                      const float* lane_in, float* out, float* env_out,
                      float* pre_fin, float* pre_acc, float* post_fin,
                      float* post_acc, int B, int C, int N,
                      const float* consts, int n_consts, void* stream) {
  constexpr int kLane = sizeof(juicy::LaneConsts) / sizeof(float);
  constexpr int kPunch = sizeof(juicy::PunchConsts) / sizeof(float);
  if (n_consts != kLane + kPunch || B <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  juicy::LaneConsts lk;
  juicy::PunchConsts k;
  std::memcpy(&lk, consts, sizeof(lk));
  std::memcpy(&k, consts + kLane, sizeof(k));
  const int blocks = (B + juicy::kPunchThreads - 1) / juicy::kPunchThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1) {
    juicy::punch_stage_kernel<1><<<blocks, juicy::kPunchThreads, 0, s>>>(
        x, env_in, lane_in, out, env_out, pre_fin, pre_acc, post_fin,
        post_acc, B, N, lk, k);
  } else if (C == 2) {
    juicy::punch_stage_kernel<2><<<blocks, juicy::kPunchThreads, 0, s>>>(
        x, env_in, lane_in, out, env_out, pre_fin, pre_acc, post_fin,
        post_acc, B, N, lk, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
