// Punch full-stage kernel for Hopper (sm_90a): pre-analyze + punch +
// post-analyze of one block, for every clip of a batch, in one launch.
//
// Replaces the TPU kernel juicy_tpu/kernels/stage_kernels.py
// ::punch_stage_step (_punch_kernel, _punch_shape_gain). Plain version
// beside the wrapper: juicy_tpu_torch/kernels/stage_kernels.py
// ::_punch_lanes_plain.
//
// What bounds it: latency, not bytes or operations. The two followers and
// the analyzer lanes are serial per-sample recurrences; one thread carrying
// a clip through all of it, as the first version of this kernel did, waits
// on every dependent operation, and one-warp blocks left three of an SM's
// four schedulers idle. Most of the work sits on no recurrence: everything
// after the followers (pow32, tanh32, a true division, the clip, the mix;
// ~94 of punch's ~98 operations per channel-sample) reads no earlier
// sample, and the lane's band energies and six stateless sums do not
// touch its envelopes and onsets.
//
// So each CTA serves 32 clips, one per lane of every warp (loads and stores
// coalesce over the clip axis of [N, C, B]), and each clip's stage is split
// across eleven warps with their own roles:
//   V L E  the analyzer lanes split in three (stage_lane.cuh): V the
//          envelopes, L the transient sum and the onsets, E the band
//          energies and the six stateless sums; each runs its part of the
//          pre lane over the input, then of the post lane over the output
//          from the pre lane's end state;
//   F0 F1  the fast and slow followers, one channel each;
//   H0-H5  the shaping after the followers, taking chunks in turn.
// F hands each chunk of kChunk samples (the input, fast, slow) to the
// helpers through a ring of slots in shared memory behind the chunk's
// "followed" barrier; a helper writes the chunk's output to device memory
// and arrives on its "shaped" barrier, after which F may reuse the slot
// and L and S read the output back with cp.async a chunk ahead, as every
// reader here reads its stream (pipe.cuh).
// Lanes past B run every role on their batch's last clip and store
// nothing, so every barrier counts 32 arrivals per warp. Mono (C = 1)
// analyzes r = l; F1 then has nothing to do.
//
// Numerics: each recurrence and each sum stays on one thread in the plain
// version's order (punch.cuh punch_follow / punch_shape and lane.cuh
// lane_step_envelopes / _onsets / _energy are punch_sample and lane_step split,
// the same operations in the same order). Built with -fmad=false and
// without fast math; every transcendental is a precise.cuh polynomial.
#include <cuda_runtime.h>

#include <cstring>

#include "lane.cuh"
#include "pipe.cuh"
#include "precise.cuh"
#include "stage_lane.cuh"
#include "punch.cuh"

namespace juicy {
namespace punch_stage {

using pipe::kChunk;

enum : int {
  kWarpV, kWarpL, kWarpE, kWarpF0, kWarpF1, kWarpH0, kWarps = kWarpH0 + 6
};
constexpr int kHelpers = kWarps - kWarpH0;
constexpr int kThreads = kWarps * 32;
constexpr int kClips = 32;
constexpr int kSlots = 8;   // ring slots per channel
constexpr int kFields = 3;  // per sample in a slot: input, fast, slow

// x, out: [N, C, B]; env_in/out: [2, B, C] (fast, slow); lane_in, *_fin:
// [5, B]; *_acc: [10, B].
struct Args {
  const float* __restrict__ x;
  const float* __restrict__ env_in;
  const float* __restrict__ lane_in;
  float* __restrict__ out;
  float* __restrict__ env_out;
  float* __restrict__ pre_fin;
  float* __restrict__ pre_acc;
  float* __restrict__ post_fin;
  float* __restrict__ post_acc;
  int B, N;
  LaneConsts lk;
  PunchConsts k;
};

// Shared memory: the barriers ("followed" then "shaped", one per chunk
// each, then the lanes'), the ring, the lanes' ring, then each reader's
// double buffer.
__host__ __device__ constexpr int stage_rows(int w) {
  return (w == kWarpV || w == kWarpE) ? stage_lane::kStageRows
         : (w == kWarpF0 || w == kWarpF1) ? 2 * kChunk : 0;
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
  l.lanes = l.ring + sizeof(float) * kSlots * 2 * kFields * kChunk * 32;
  l.stage = l.lanes + sizeof(float) * stage_lane::kRingRows * 32;
  int rows = 0;
  for (int w = 0; w < kWarps; ++w) rows += stage_rows(w);
  l.bytes = l.stage + sizeof(float) * 32 * rows;
  return l;
}

struct Ctx {
  int b, bl, lane;   // the clip, the clip clamped into the batch
  bool live;         // b < B: only live lanes store
  size_t sB;
  int nc;
  uint64_t* bars;    // followed [nc], shaped [nc], then the lanes'
  float* ring;       // at this lane
  float* stage;      // the warp's reader buffer, at this lane
  stage_lane::Link link;

  __device__ uint64_t* followed() const { return bars; }
  __device__ uint64_t* out_bar() const { return bars + nc; }
  // field f of sample i in slot s, channel ch
  __device__ float* slot(int s, int ch) const {
    return ring + (s * 2 + ch) * kFields * kChunk * 32;
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

// ---- F: the followers of channel ch, into the ring
template <int C>
__device__ void run_follow(const Args& a, const Ctx& c, int ch) {
  float fast = a.env_in[c.bl * C + ch];
  float slow = a.env_in[(c.sB + c.bl) * C + ch];
  auto in = pipe::chunk_reader<1>(a.x, C, c.sB, c.bl, ch, a.N, nullptr,
                                  c.stage);
  for (int j = 0; j < c.nc; ++j) {
    if (j >= kSlots) pipe::mbar_wait(c.out_bar() + j - kSlots);
    const float* v = in.begin(j);
    const int n = in.len(j);
    float* r = c.slot(j % kSlots, ch);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const float d = v[i * 32];
      punch_follow(d, fast, slow, a.k);
      r[i * 32] = d;
      r[(kChunk + i) * 32] = fast;
      r[(2 * kChunk + i) * 32] = slow;
    }
    pipe::mbar_arrive(c.followed() + j);
  }
  if (c.live) {
    a.env_out[c.b * C + ch] = fast;
    a.env_out[(c.sB + c.b) * C + ch] = slow;
  }
}

// ---- H: the shaping of chunks h, h + kHelpers, ...
template <int C>
__device__ void run_shape(const Args& a, const Ctx& c, int h) {
  for (int j = h; j < c.nc; j += kHelpers) {
    pipe::mbar_wait(c.followed() + j);
    const int t0 = j * kChunk, n = min(kChunk, a.N - t0);
    for (int ch = 0; ch < C; ++ch) {
      const float* r = c.slot(j % kSlots, ch);
      float* __restrict__ y = a.out + ch * c.sB + c.b;
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const float o = punch_shape(r[i * 32], r[(kChunk + i) * 32],
                                    r[(2 * kChunk + i) * 32], a.k);
        if (c.live) y[static_cast<size_t>(t0 + i) * C * c.sB] = o;
      }
    }
    pipe::mbar_arrive(c.out_bar() + j);
  }
}

// One block of 32 clips; see the file comment.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    punch_stage_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(a.N);
  const int warp = threadIdx.x / 32;
  Ctx c;
  c.lane = threadIdx.x % 32;
  c.b = blockIdx.x * kClips + c.lane;
  c.live = c.b < a.B;
  c.bl = c.live ? c.b : a.B - 1;  // lanes past B run on the last clip
  c.sB = static_cast<size_t>(a.B);
  c.nc = l.nc;
  c.bars = reinterpret_cast<uint64_t*>(smem);
  c.ring = reinterpret_cast<float*>(smem + l.ring) + c.lane;
  c.link = {reinterpret_cast<float*>(smem + l.lanes) + c.lane,
            c.bars + 2 * l.nc};
  int rows = 0;
  for (int w = 0; w < warp; ++w) rows += stage_rows(w);
  c.stage = reinterpret_cast<float*>(smem + l.stage) + rows * 32 + c.lane;
  for (int i = threadIdx.x; i < l.bars; i += kThreads)
    pipe::mbar_init(c.bars + i, i < l.nc ? 32 * C : 32);
  __syncthreads();

  switch (warp) {
    case kWarpV: run_lane<C, stage_lane::kEnvelopes>(a, c); break;
    case kWarpL: run_lane<C, stage_lane::kOnsets>(a, c); break;
    case kWarpE: run_lane<C, stage_lane::kEnergy>(a, c); break;
    case kWarpF0: run_follow<C>(a, c, 0); break;
    case kWarpF1: if (C == 2) run_follow<C>(a, c, 1); break;
    default: run_shape<C>(a, c, warp - kWarpH0); break;
  }
}

template <int C>
int prepare(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      punch_stage_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(punch_stage_kernel<C>,
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
  punch_stage_kernel<C><<<blocks, kThreads, smem, s>>>(a);
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
        cudaFuncGetAttributes(&attr, punch_stage_kernel<C>));
  int ctas = 0;
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, punch_stage_kernel<C>, kThreads, smem));
  if (err != 0) return err;
  const int v[8] = {kClips, kWarps, kThreads, static_cast<int>(smem), ctas,
                    attr.numRegs, static_cast<int>(attr.localSizeBytes),
                    kChunk};
  for (int i = 0; i < 8; ++i) g[i] = v[i];
  return 0;
}

}  // namespace punch_stage
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
  namespace ps = juicy::punch_stage;
  constexpr int kLane = sizeof(juicy::LaneConsts) / sizeof(float);
  constexpr int kPunch = sizeof(juicy::PunchConsts) / sizeof(float);
  if (n_consts != kLane + kPunch || B <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ps::Args a{x, env_in, lane_in, out, env_out, pre_fin, pre_acc, post_fin,
             post_acc, B, N, {}, {}};
  std::memcpy(&a.lk, consts, sizeof(a.lk));
  std::memcpy(&a.k, consts + kLane, sizeof(a.k));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1) return ps::launch<1>(a, s);
  if (C == 2) return ps::launch<2>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The punch kernel's geometry for C channels and block size N into g[8]
// (juicy::punch_stage::geometry's order); returns a CUDA error code.
int juicy_punch_geometry(int C, int N, int* g) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 1) return juicy::punch_stage::geometry<1>(N, g);
  if (C == 2) return juicy::punch_stage::geometry<2>(N, g);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
