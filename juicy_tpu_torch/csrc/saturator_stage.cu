// Saturator full-stage kernel for Hopper (sm_90a): pre-analyze + saturator
// + post-analyze of one block, for every clip of a batch, in one launch.
//
// Replaces the TPU kernel juicy_tpu/kernels/stage_kernels.py
// ::saturator_stage_step (_sat_kernel, with the lane _lane_step,
// _lane_from_ref, _lane_reset and _store_lane); juicy_tpu/kernels/
// saturator_kernel.py::_run computes the same and is a launch of this
// kernel too. Plain version beside the wrapper:
// juicy_tpu_torch/kernels/stage_kernels.py::_sat_lanes_plain.
//
// What bounds it: latency, not bytes or operations. The tone one-pole and
// the analyzer lanes are serial per-sample recurrences; one thread carrying
// a clip through all of it, as the first version of this kernel did, waits
// on every dependent operation, and 128-thread blocks left 100 of 132 SMs
// idle at B = 4096. Most of the work sits on no recurrence: the drive, the
// skew and tanh32 (33 of the saturator's 40 operations per channel-sample)
// read only the input sample, and the lane's band energies and six
// stateless sums do not touch its envelopes and onsets.
//
// So each CTA serves 32 clips, one per lane of every warp (loads and stores
// coalesce over the clip axis of [N, C, B]), and each clip's stage is split
// across nine warps with their own roles:
//   V L E  the analyzer lanes split in three (stage_lane.cuh): V the
//          envelopes, L the transient sum and the onsets, E the band
//          energies and the six stateless sums; each runs its part of the
//          pre lane over the input, then of the post lane over the output
//          from the pre lane's end state;
//   H0-H3  drive, skew and tanh32 of both channels, taking chunks in turn,
//          into a ring of slots in shared memory behind the chunk's "soft"
//          barrier;
//   S0 S1  the tone one-pole, output gain and mix, one channel each: the
//          chunk's output to device memory, then its "written" barrier,
//          after which H may reuse the slot and L and E read the output
//          back with cp.async a chunk ahead, as every reader here reads its
//          stream (pipe.cuh).
// Lanes past B run every role on their batch's last clip and store
// nothing, so every barrier counts 32 arrivals per warp. Mono (C = 1)
// analyzes r = l; S1 then has nothing to do.
//
// Numerics: each recurrence and each sum stays on one thread in the plain
// version's order (saturator.cuh sat_soft / sat_tone_mix and lane.cuh
// lane_step_envelopes / _onsets / _energy are sat_sample and lane_step
// split, the same operations in the same order). Built with -fmad=false and
// without fast math; every transcendental is a precise.cuh polynomial.
#include <cuda_runtime.h>

#include "lane.cuh"
#include "pipe.cuh"
#include "precise.cuh"
#include "saturator.cuh"
#include "stage_lane.cuh"

namespace juicy {
namespace saturator_stage {

using pipe::kChunk;

enum : int {
  kWarpV, kWarpL, kWarpE, kWarpS0, kWarpS1, kWarpH0, kWarps = kWarpH0 + 4
};
constexpr int kHelpers = kWarps - kWarpH0;
constexpr int kThreads = kWarps * 32;
constexpr int kClips = 32;
constexpr int kSlots = 8;  // ring slots per channel: each sample's soft

// x, out: [N, C, B]; tone_in, tone_out: [C, B]; lane_in, *_fin: [5, B];
// *_acc: [10, B].
struct Args {
  const float* __restrict__ x;
  const float* __restrict__ tone_in;
  const float* __restrict__ lane_in;
  float* __restrict__ out;
  float* __restrict__ tone_out;
  float* __restrict__ pre_fin;
  float* __restrict__ pre_acc;
  float* __restrict__ post_fin;
  float* __restrict__ post_acc;
  int B, N;
  LaneConsts lk;
  SatConsts k;
};

// Shared memory: the barriers ("soft" then "written", one per chunk each,
// then the lanes'), the ring, the lanes' ring, then each reader's double
// buffer.
__host__ __device__ constexpr int stage_rows(int w) {
  return (w == kWarpV || w == kWarpE) ? stage_lane::kStageRows
         : (w == kWarpS0 || w == kWarpS1) ? 2 * kChunk : 0;
}
struct Layout {
  int nc, bars;
  size_t ring, lanes, stage, bytes;  // byte offsets; barriers at 0
};
__host__ __device__ inline Layout layout(int N) {
  Layout l;
  l.nc = (N + kChunk - 1) / kChunk;
  l.bars = 2 * l.nc + stage_lane::link_bars(l.nc);
  l.ring = (sizeof(uint64_t) * l.bars + 15) / 16 * 16;
  l.lanes = l.ring + sizeof(float) * kSlots * 2 * kChunk * 32;
  l.stage = l.lanes + sizeof(float) * stage_lane::kRingRows * 32;
  int rows = 0;
  for (int w = 0; w < kWarps; ++w) rows += stage_rows(w);
  l.bytes = l.stage + sizeof(float) * 32 * rows;
  return l;
}

struct Ctx {
  int b, bl;       // the clip, the clip clamped into the batch
  bool live;       // b < B: only live lanes store
  size_t sB;
  int nc;
  uint64_t* bars;  // soft [nc], written [nc], then the lanes'
  float* ring;     // at this lane
  float* stage;    // the warp's reader buffer, at this lane
  stage_lane::Link link;

  __device__ uint64_t* soft() const { return bars; }
  __device__ uint64_t* out_bar() const { return bars + nc; }
  // sample i of chunk j's slot, channel ch: [i * 32]
  __device__ float* slot(int j, int ch) const {
    return ring + ((j % kSlots) * 2 + ch) * kChunk * 32;
  }
};

// ---- V, L and E: one part of both lanes each (stage_lane.cuh)
template <int C, int PART>
__device__ void run_lane(const Args& a, const Ctx& c) {
  stage_lane::run<PART>(
      pipe::chunk_reader<2>(a.x, C, c.sB, c.bl, 0, a.N, nullptr, c.stage),
      pipe::chunk_reader<2>(a.out, C, c.sB, c.bl, 0, a.N, c.out_bar(),
                            c.stage),
      c.link, a.lane_in, a.pre_fin, a.pre_acc, a.post_fin, a.post_acc, c.b,
      c.bl, c.live, a.B, a.lk);
}

// ---- H: drive, skew and tanh32 of chunks h, h + kHelpers, ..., both
// channels. Each chunk's input is loaded into registers one turn ahead
// (independent loads, their latency behind the previous chunk's tanh32s).
template <int C>
__device__ void run_soft(const Args& a, const Ctx& c, int h) {
  const size_t row = static_cast<size_t>(C) * c.sB;
  const float* src = a.x + c.bl;
  float nx[C][kChunk];
  auto load = [&](int j) {
    const int t0 = j * kChunk, n = min(kChunk, a.N - t0);
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        if (i < n) nx[ch][i] = src[static_cast<size_t>(t0 + i) * row + ch * c.sB];
  };
  if (h < c.nc) load(h);
  for (int j = h; j < c.nc; j += kHelpers) {
    const int n = min(kChunk, a.N - j * kChunk);
    float d[C][kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
#pragma unroll
      for (int ch = 0; ch < C; ++ch) d[ch][i] = nx[ch][i];
    if (j + kHelpers < c.nc) load(j + kHelpers);
    if (j >= kSlots) pipe::mbar_wait(c.out_bar() + j - kSlots);  // slot free
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        if (i < n) c.slot(j, ch)[i * 32] = sat_soft(d[ch][i], a.k);
    pipe::mbar_arrive(c.soft() + j);
  }
}

// ---- S: the tone one-pole, output gain and mix of channel ch, behind H;
// the output to device memory
template <int C>
__device__ void run_tone(const Args& a, const Ctx& c, int ch) {
  float tone = a.tone_in[ch * c.sB + c.bl];
  auto in = pipe::chunk_reader<1>(a.x, C, c.sB, c.bl, ch, a.N, nullptr,
                                  c.stage);
  float* __restrict__ y = a.out + ch * c.sB + c.b;
  for (int j = 0; j < c.nc; ++j) {
    const float* v = in.begin(j);
    const int t0 = j * kChunk, n = in.len(j);
    pipe::mbar_wait(c.soft() + j);
    const float* r = c.slot(j, ch);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const float o = sat_tone_mix(v[i * 32], r[i * 32], tone, a.k);
      if (c.live) y[static_cast<size_t>(t0 + i) * C * c.sB] = o;
    }
    pipe::mbar_arrive(c.out_bar() + j);
  }
  if (c.live) a.tone_out[ch * c.sB + c.b] = tone;
}

// One block of 32 clips; see the file comment.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    saturator_stage_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(a.N);
  const int warp = threadIdx.x / 32;
  Ctx c;
  const int lane = threadIdx.x % 32;
  c.b = blockIdx.x * kClips + lane;
  c.live = c.b < a.B;
  c.bl = c.live ? c.b : a.B - 1;  // lanes past B run on the last clip
  c.sB = static_cast<size_t>(a.B);
  c.nc = l.nc;
  c.bars = reinterpret_cast<uint64_t*>(smem);
  c.ring = reinterpret_cast<float*>(smem + l.ring) + lane;
  c.link = {reinterpret_cast<float*>(smem + l.lanes) + lane,
            c.bars + 2 * l.nc};
  int rows = 0;
  for (int w = 0; w < warp; ++w) rows += stage_rows(w);
  c.stage = reinterpret_cast<float*>(smem + l.stage) + rows * 32 + lane;
  // soft: one helper per chunk; written: S0 and S1; the lanes': one warp
  for (int i = threadIdx.x; i < l.bars; i += kThreads)
    pipe::mbar_init(c.bars + i, i >= l.nc && i < 2 * l.nc ? 32 * C : 32);
  __syncthreads();

  switch (warp) {
    case kWarpV: run_lane<C, stage_lane::kEnvelopes>(a, c); break;
    case kWarpL: run_lane<C, stage_lane::kOnsets>(a, c); break;
    case kWarpE: run_lane<C, stage_lane::kEnergy>(a, c); break;
    case kWarpS0: run_tone<C>(a, c, 0); break;
    case kWarpS1: if (C == 2) run_tone<C>(a, c, 1); break;
    default: run_soft<C>(a, c, warp - kWarpH0); break;
  }
}

template <int C>
int prepare(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      saturator_stage_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(saturator_stage_kernel<C>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

template <int C>
int launch(const Args& a, cudaStream_t s) {
  const size_t smem = layout(a.N).bytes;
  const int err = prepare<C>(smem);
  if (err != 0) return err;
  const int blocks = (a.B + kClips - 1) / kClips;
  saturator_stage_kernel<C><<<blocks, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// clips and warps per CTA, threads, shared memory bytes, resident CTAs per
// SM, registers and local (spill) bytes per thread, chunk samples
template <int C>
int geometry(int N, int* g) {
  const size_t smem = layout(N).bytes;
  int err = prepare<C>(smem);
  cudaFuncAttributes attr;
  if (err == 0)
    err = static_cast<int>(
        cudaFuncGetAttributes(&attr, saturator_stage_kernel<C>));
  int ctas = 0;
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, saturator_stage_kernel<C>, kThreads, smem));
  if (err != 0) return err;
  const int v[8] = {kClips, kWarps, kThreads, static_cast<int>(smem), ctas,
                    attr.numRegs, static_cast<int>(attr.localSizeBytes),
                    kChunk};
  for (int i = 0; i < 8; ++i) g[i] = v[i];
  return 0;
}

}  // namespace saturator_stage
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
  namespace ss = juicy::saturator_stage;
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const ss::Args a{x, tone_in, lane_in, out, tone_out, pre_fin, pre_acc,
                   post_fin, post_acc, B, N,
                   {atk_s, rel_s, atk_l, rel_l, low_c, high_c, cd_samples},
                   {in_gain, asym, tone_c, out_gain, mix}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1) return ss::launch<1>(a, s);
  if (C == 2) return ss::launch<2>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The saturator kernel's geometry for C channels and block size N into g[8]
// (juicy::saturator_stage::geometry's order); returns a CUDA error code.
int juicy_saturator_geometry(int C, int N, int* g) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 1) return juicy::saturator_stage::geometry<1>(N, g);
  if (C == 2) return juicy::saturator_stage::geometry<2>(N, g);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* juicy_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
