// Motion full-stage kernel for Hopper (sm_90a): pre-analyze + motion's two
// passes + post-analyze of one block, for every clip of a batch, in one
// launch.
//
// Replaces the TPU kernel juicy_tpu/kernels/stage_kernels.py
// ::motion_stage_step (_motion_kernel with make_motion_p1_body and
// motion.make_p2_step). Plain version beside the wrapper:
// juicy_tpu_torch/kernels/stage_kernels.py::_motion_lanes_plain.
//
// What bounds it: every quantity is a serial per-sample recurrence, and pass
// 2 runs the channels one after the other (channel 1 starts from the
// slew/LFO/budget state channel 0 left), so one thread carries one clip
// through four loops: the pre lane with pass 1, pass 2 on channel 0, pass 2
// on channel 1, the post lane. Each pass-2 sample is a dependent chain
// through a sin32 and an exp polynomial, 2N of them per thread. At B = 4096
// that is 128 warps, launched as 32-thread blocks so that each warp gets an
// SM of its own: latency, not bytes, sets the pace. Audio is time-major and
// clip-contiguous ([N, C, B]) so a warp's loads and stores coalesce; each
// channel pass writes its own rows of the output directly (the TPU kernel's
// per-channel scratch and merge loop have no counterpart); the state lives
// in registers; the LCG is a native u32 and the cooldown an int.
//
// Numerics: built with -fmad=false and without fast math; every
// transcendental is a precise.cuh polynomial.
#include <cuda_runtime.h>

#include <cstring>

#include "lane.cuh"
#include "motion.cuh"
#include "precise.cuh"

namespace juicy {

constexpr int kMotionThreads = 32;
constexpr int kMotionMono = 10;  // models/motion.py::MONO_KEYS

// x, out: [N, C, B]; mono_in/out: [10, B] (env, repetition, budget_env, vt,
// vtr, vtl, vt_t, vtr_t, vtl_t, phase); cd_in/out: [B]; rng_in/out: [B]
// (u32); chan_in/out: [3, B, C] (lp, tail, prev); lane_in, *_fin: [5, B];
// *_acc: [10, B]. Mono analyzes and detects on r = l.
template <int C>
__global__ void __launch_bounds__(kMotionThreads)
motion_stage_kernel(const float* __restrict__ x,
                    const float* __restrict__ mono_in,
                    const int* __restrict__ cd_in,
                    const unsigned* __restrict__ rng_in,
                    const float* __restrict__ chan_in,
                    const float* __restrict__ lane_in, float* __restrict__ out,
                    float* __restrict__ mono_out, int* __restrict__ cd_out,
                    unsigned* __restrict__ rng_out,
                    float* __restrict__ chan_out, float* __restrict__ pre_fin,
                    float* __restrict__ pre_acc, float* __restrict__ post_fin,
                    float* __restrict__ post_acc, int B, int N,
                    int cooldown_samples, int narrow, LaneConsts lk,
                    MotionConsts k) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // ragged edge of the batch
  const size_t sB = static_cast<size_t>(B);

  float m[kMotionMono];
#pragma unroll
  for (int i = 0; i < kMotionMono; ++i) m[i] = mono_in[i * sB + b];
  MotionP1 p1{m[0], cd_in[b], m[1], rng_in[b], m[6], m[7], m[8]};
  MotionShared sh{m[3], m[4], m[5], m[9], m[2]};

  // loop 1: pre lane and pass 1 on the input
  Lane lane = lane_load(lane_in, b, B);
  for (int t = 0; t < N; ++t) {
    const size_t row = static_cast<size_t>(t) * C * sB + b;
    const float l = x[row];
    const float r = x[row + (C - 1) * sB];
    lane_step(lane, l, r, lk);
    motion_p1(p1, fabsf(0.5f * (l + r)), cooldown_samples, k);
  }
  lane_store(lane, pre_fin, pre_acc, b, B);
  float scale, recovery;
  motion_scales(p1.repetition, k, scale, recovery);

  // loops 2 and 3: pass 2 on channel 0, then on channel 1 from the shared
  // state channel 0 left
#pragma unroll 1
  for (int ch = 0; ch < C; ++ch) {
    MotionChan c{chan_in[b * C + ch], chan_in[(sB + b) * C + ch],
                 chan_in[(2 * sB + b) * C + ch]};
    const float ch_offset = ch == 0 ? 0.0f : 0.85f;
    for (int t = 0; t < N; ++t) {
      const size_t at = static_cast<size_t>(t) * C * sB + ch * sB + b;
      out[at] = motion_p2(x[at], sh, c, p1, scale, recovery, ch_offset,
                          narrow != 0, k);
    }
    chan_out[b * C + ch] = c.lp;
    chan_out[(sB + b) * C + ch] = c.tail;
    chan_out[(2 * sB + b) * C + ch] = c.prev;
  }
  const float mo[kMotionMono] = {p1.env,   p1.repetition, sh.budget_env,
                                 sh.vt,    sh.vtr,        sh.vtl,
                                 p1.vt_t,  p1.vtr_t,      p1.vtl_t,
                                 sh.phase};
#pragma unroll
  for (int i = 0; i < kMotionMono; ++i) mono_out[i * sB + b] = mo[i];
  cd_out[b] = p1.cooldown;
  rng_out[b] = p1.rng;

  // loop 4: post lane on the output just written
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
// documents; `consts` is a host array of the 7 lane constants and the 24
// motion constants (motion_param_list order); `narrow` selects the cutoff
// coefficient's narrow exp.
int juicy_motion_stage(const float* x, const float* mono_in, const int* cd_in,
                       const unsigned* rng_in, const float* chan_in,
                       const float* lane_in, float* out, float* mono_out,
                       int* cd_out, unsigned* rng_out, float* chan_out,
                       float* pre_fin, float* pre_acc, float* post_fin,
                       float* post_acc, int B, int C, int N,
                       int cooldown_samples, int narrow, const float* consts,
                       int n_consts, void* stream) {
  constexpr int kLane = sizeof(juicy::LaneConsts) / sizeof(float);
  constexpr int kMotion = sizeof(juicy::MotionConsts) / sizeof(float);
  if (n_consts != kLane + kMotion || B <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  juicy::LaneConsts lk;
  juicy::MotionConsts k;
  std::memcpy(&lk, consts, sizeof(lk));
  std::memcpy(&k, consts + kLane, sizeof(k));
  const int blocks = (B + juicy::kMotionThreads - 1) / juicy::kMotionThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1) {
    juicy::motion_stage_kernel<1><<<blocks, juicy::kMotionThreads, 0, s>>>(
        x, mono_in, cd_in, rng_in, chan_in, lane_in, out, mono_out, cd_out,
        rng_out, chan_out, pre_fin, pre_acc, post_fin, post_acc, B, N,
        cooldown_samples, narrow, lk, k);
  } else if (C == 2) {
    juicy::motion_stage_kernel<2><<<blocks, juicy::kMotionThreads, 0, s>>>(
        x, mono_in, cd_in, rng_in, chan_in, lane_in, out, mono_out, cd_out,
        rng_out, chan_out, pre_fin, pre_acc, post_fin, post_acc, B, N,
        cooldown_samples, narrow, lk, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
