// Texture full-stage kernel for Hopper (sm_90a): pre-analyze + texture +
// post-analyze of one block, for every clip of a batch, in one launch, for a
// material fixed per launch (0 gel, 1 metal, 2 wood, 3 plastic, 4 flesh).
//
// Replaces the TPU kernel juicy_tpu/kernels/stage_kernels.py
// ::texture_stage_step (_texture_kernel with make_tex_sample and
// make_white_at). Plain version beside the wrapper:
// juicy_tpu_torch/kernels/stage_kernels.py::_tex_lanes_plain.
//
// What bounds it: the material models, the envelopes, the tail, the
// auto-gain, the DC blocker and the limiter are serial per-sample
// recurrences, so one thread carries one clip (both channels) through the
// block in order, as in the saturator kernel. At B = 4096 that is 128 warps
// for 132 SMs, launched as 32-thread blocks so that each warp gets an SM of
// its own: latency, not bytes, sets the pace. Metal is the heavy material
// (four cos32 polynomials per channel per sample). The design's answers:
//   * audio time-major and clip-contiguous ([N, C, B]), so a warp's loads
//     and stores coalesce; all state in registers;
//   * the LCG without tables: each thread carries channel 0's state (draws
//     1..N) and channel 1's (draws N+1..2N, one host jump pair) and advances
//     both with native u32 wrap;
//   * the waveguide ring of wood and plastic stays in device memory,
//     time-major [L, C, B] and updated in place: each sample reads two
//     neighbouring rows and writes one, coalesced while the clips share
//     their write index (the wrapper checks that they do when it converts
//     the state). The rows read were written a few hundred samples before,
//     so they come from L2;
//   * the ~50 constants arrive by value in two structs, worked out on the
//     host once per (params, sample rate, material).
//
// Numerics: built with -fmad=false and without fast math; every
// transcendental is a precise.cuh polynomial.
#include <cuda_runtime.h>

#include <cstring>

#include "lane.cuh"
#include "precise.cuh"
#include "texture.cuh"

namespace juicy {

constexpr int kTexThreads = 32;
constexpr int kTexDsp = 9;  // env, lp, hp, noise_hp, tail, wet_env, dc_in, dc_out, pg

// x, out: [N, C, B]; dsp_in/out: [9, B, C]; mat_in/out: [NMAT, B, C];
// rng_in/out: [B] (u32); widx_in/out: [B, C]; ring: [L, C, B] (wave modes,
// in place); lane_in, *_fin: [5, B]; *_acc: [10, B]. Mono analyzes r = l.
template <int C, int MODE>
__global__ void __launch_bounds__(kTexThreads)
texture_stage_kernel(const float* __restrict__ x,
                     const float* __restrict__ dsp_in,
                     const float* __restrict__ mat_in,
                     const unsigned* __restrict__ rng_in,
                     const int* __restrict__ widx_in,
                     const float* __restrict__ lane_in, float* ring,
                     float* __restrict__ out, float* __restrict__ dsp_out,
                     float* __restrict__ mat_out,
                     unsigned* __restrict__ rng_out,
                     int* __restrict__ widx_out, float* __restrict__ pre_fin,
                     float* __restrict__ pre_acc,
                     float* __restrict__ post_fin,
                     float* __restrict__ post_acc, int B, int N, int L,
                     unsigned jump_a, unsigned jump_b, LaneConsts lk,
                     TexConsts k) {
  constexpr int NMAT = tex_nmat(MODE);
  constexpr bool kWave = MODE == 2 || MODE == 3;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // ragged edge of the batch
  const size_t sB = static_cast<size_t>(B);

  Lane lane = lane_load(lane_in, b, B);
  TexChan s[C];
  float m[C][NMAT];
  int widx[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    float v[kTexDsp];
#pragma unroll
    for (int i = 0; i < kTexDsp; ++i) v[i] = dsp_in[(i * sB + b) * C + ch];
    s[ch] = TexChan{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8]};
#pragma unroll
    for (int j = 0; j < NMAT; ++j) m[ch][j] = mat_in[(j * sB + b) * C + ch];
    // the wrapper checks the index; the wrap only keeps a bad one in bounds
    widx[ch] = kWave ? ((widx_in[b * C + ch] % L) + L) % L : 0;
  }
  // channel 0 takes draws 1..N, channel 1 draws N+1..2N (cpp:239)
  unsigned r[C];
  r[0] = rng_in[b];
  if constexpr (C == 2) r[1] = jump_a * r[0] + jump_b;

  // loop 1: pre lane on the input, texture in the same sample loop
  for (int t = 0; t < N; ++t) {
    const size_t row = static_cast<size_t>(t) * C * sB + b;
    float d[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) d[ch] = x[row + ch * sB];
    lane_step(lane, d[0], d[C - 1], lk);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      r[ch] = lcg_step(r[ch]);
      const TexDrive v = tex_front(d[ch], s[ch], k);
      float shaped;
      if constexpr (MODE == 0) {
        shaped = gel_step(m[ch], v, k);
      } else if constexpr (MODE == 1) {
        shaped = metal_step(m[ch], v, s[ch].hp, k);
      } else if constexpr (kWave) {
        const RingTap tap = tex_ring_tap(widx[ch], k.m[12], L);
        const float v0 = ring[(tap.i0 * static_cast<size_t>(C) + ch) * sB + b];
        const float v1 = ring[(tap.i1 * static_cast<size_t>(C) + ch) * sB + b];
        const float delayed = v0 + tap.frac * (v1 - v0);
        float new_wave;
        shaped = wave_step(m[ch], v, delayed, new_wave, k);
        ring[(widx[ch] * static_cast<size_t>(C) + ch) * sB + b] = new_wave;
        widx[ch] = widx[ch] + 1 >= L ? 0 : widx[ch] + 1;
      } else {
        shaped = flesh_step(m[ch], v, k);
      }
      out[row + ch * sB] = tex_back(d[ch], shaped, tex_white(r[ch]), v, s[ch], k);
    }
  }
  lane_store(lane, pre_fin, pre_acc, b, B);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float v[kTexDsp] = {s[ch].env, s[ch].lp, s[ch].hp,
                              s[ch].noise_hp, s[ch].tail, s[ch].wet_env,
                              s[ch].dc_in, s[ch].dc_out, s[ch].pg};
#pragma unroll
    for (int i = 0; i < kTexDsp; ++i) dsp_out[(i * sB + b) * C + ch] = v[i];
#pragma unroll
    for (int j = 0; j < NMAT; ++j) mat_out[(j * sB + b) * C + ch] = m[ch][j];
    if constexpr (kWave) widx_out[b * C + ch] = widx[ch];
  }
  rng_out[b] = r[C - 1];

  // loop 2: post lane on the output just written
  lane_reset(lane);
  for (int t = 0; t < N; ++t) {
    const size_t row = static_cast<size_t>(t) * C * sB + b;
    lane_step(lane, out[row], out[row + (C - 1) * sB], lk);
  }
  lane_store(lane, post_fin, post_acc, b, B);
}

template <int C, int MODE>
void launch(const float* x, const float* dsp_in, const float* mat_in,
            const unsigned* rng_in, const int* widx_in, const float* lane_in,
            float* ring, float* out, float* dsp_out, float* mat_out,
            unsigned* rng_out, int* widx_out, float* pre_fin, float* pre_acc,
            float* post_fin, float* post_acc, int B, int N, int L,
            unsigned jump_a, unsigned jump_b, const LaneConsts& lk,
            const TexConsts& k, cudaStream_t s) {
  const int blocks = (B + kTexThreads - 1) / kTexThreads;
  texture_stage_kernel<C, MODE><<<blocks, kTexThreads, 0, s>>>(
      x, dsp_in, mat_in, rng_in, widx_in, lane_in, ring, out, dsp_out,
      mat_out, rng_out, widx_out, pre_fin, pre_acc, post_fin, post_acc, B, N,
      L, jump_a, jump_b, lk, k);
}

template <int C>
int launch_mode(int mode, const float* x, const float* dsp_in,
                const float* mat_in, const unsigned* rng_in,
                const int* widx_in, const float* lane_in, float* ring,
                float* out, float* dsp_out, float* mat_out, unsigned* rng_out,
                int* widx_out, float* pre_fin, float* pre_acc,
                float* post_fin, float* post_acc, int B, int N, int L,
                unsigned jump_a, unsigned jump_b, const LaneConsts& lk,
                const TexConsts& k, cudaStream_t s) {
#define JUICY_TEX_LAUNCH(M)                                                 \
  launch<C, M>(x, dsp_in, mat_in, rng_in, widx_in, lane_in, ring, out,     \
               dsp_out, mat_out, rng_out, widx_out, pre_fin, pre_acc,      \
               post_fin, post_acc, B, N, L, jump_a, jump_b, lk, k, s)
  switch (mode) {
    case 0: JUICY_TEX_LAUNCH(0); break;
    case 1: JUICY_TEX_LAUNCH(1); break;
    case 2: JUICY_TEX_LAUNCH(2); break;
    case 3: JUICY_TEX_LAUNCH(3); break;
    case 4: JUICY_TEX_LAUNCH(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef JUICY_TEX_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace juicy

extern "C" {

// Launches the kernel for material `mode` on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted). Device pointers are
// laid out as the kernel documents; `ring` may be null for modes 0, 1, 4.
// `consts` is a host array of n_consts floats: the 7 lane constants, the
// 16 common texture constants, then the material's (tex_param_list order).
int juicy_texture_stage(const float* x, const float* dsp_in,
                        const float* mat_in, const unsigned* rng_in,
                        const int* widx_in, const float* lane_in, float* ring,
                        float* out, float* dsp_out, float* mat_out,
                        unsigned* rng_out, int* widx_out, float* pre_fin,
                        float* pre_acc, float* post_fin, float* post_acc,
                        int B, int C, int N, int L, int mode, unsigned jump_a,
                        unsigned jump_b, const float* consts, int n_consts,
                        void* stream) {
  constexpr int kLane = sizeof(juicy::LaneConsts) / sizeof(float);
  constexpr int kTex = sizeof(juicy::TexConsts) / sizeof(float);
  if (n_consts < kLane + 16 || n_consts > kLane + kTex || B <= 0 || N <= 0 ||
      ((mode == 2 || mode == 3) && (ring == nullptr || L <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  juicy::LaneConsts lk;
  juicy::TexConsts k;
  std::memset(&k, 0, sizeof(k));
  std::memcpy(&lk, consts, sizeof(lk));
  std::memcpy(&k, consts + kLane, (n_consts - kLane) * sizeof(float));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1)
    return juicy::launch_mode<1>(mode, x, dsp_in, mat_in, rng_in, widx_in,
                                 lane_in, ring, out, dsp_out, mat_out, rng_out,
                                 widx_out, pre_fin, pre_acc, post_fin,
                                 post_acc, B, N, L, jump_a, jump_b, lk, k, s);
  if (C == 2)
    return juicy::launch_mode<2>(mode, x, dsp_in, mat_in, rng_in, widx_in,
                                 lane_in, ring, out, dsp_out, mat_out, rng_out,
                                 widx_out, pre_fin, pre_acc, post_fin,
                                 post_acc, B, N, L, jump_a, jump_b, lk, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
