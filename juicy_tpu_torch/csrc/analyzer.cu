// Analyzer kernel for Hopper (sm_90a): the JuicinessAnalyzer alone over one
// block, for every clip of a batch, in one launch.
//
// Replaces the TPU kernel juicy_tpu/kernels/analyzer_kernel.py::_run_kernel
// (the _kernel pallas_call under analyze_fused). Plain version beside the
// wrapper: juicy_tpu_torch/kernels/analyzer_kernel.py::_analyzer_lanes_plain
// (the stage kernels' _lane_step loop).
//
// What bounds it: bytes on paper (the block is read once; 42 f32 operations
// per clip-sample), the issue of each warp's instructions in practice. The
// envelopes, the onset cooldown and the band one-poles are serial
// per-sample recurrences, so a clip's samples go in order; what the kernel
// can choose is how many instructions each warp spends on a sample and
// how many clips run at once.
//
// So each CTA serves 32 clips, one per lane of every warp, and the lane is
// split across four warps with their own roles, one on each of the SM's
// schedulers (lane.cuh's split bodies):
//   V   the two envelopes (lane_step_envelopes: each update taken for both
//       coefficients, then selected, with the coefficients in registers),
//       and each sample's transient into a ring of chunk slots for L;
//   L   the transient sum and the onsets (count and cooldown);
//   E   the band one-poles and their energies and the six stateless sums;
//   P   the copies: the block in its own layout [B, C, N], whose 32 clips
//       are 32 * C consecutive rows, chunk by chunk into a ring of slots in
//       shared memory with 16-byte cp.async (pipe.cuh RowRing: each sector
//       fetched once, the slots swizzled so that V and E read a group of
//       four samples of 32 clips without bank conflicts).
// V and E read each chunk from the ring; V hands L the chunk's transients
// through a second ring. Barriers have phases, one per use of a slot, so
// shared memory does not grow with N. Chunks are 64 samples, so each warp
// pays its barriers once per 64 samples (chunks of 32 measured 1.1x slower
// in stereo, 1.3x in mono); the loops take eight samples an iteration.
// Lanes past B run on their batch's last clip and store nothing. Mono
// (C = 1) analyzes r = l.
//
// The TPU kernel runs its lane on the mono mix and leaves the side, corr,
// L^2 and R^2 sums to XLA; here E takes them in the same pass, in sample
// order.
//
// Numerics: each variable stays on one thread with lane_step's operations
// in its order. Built with -fmad=false, as every kernel of the library.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lane.cuh"
#include "pipe.cuh"

namespace juicy {
namespace analyzer {

constexpr int kClips = 32;
constexpr int kChunk = 64;  // samples per chunk
constexpr int kSlots = 4;   // chunks in flight, in each ring
enum : int { kWarpL, kWarpV, kWarpE, kWarpP, kWarps };
constexpr int kThreads = kWarps * 32;
constexpr int kReaders = 2;  // V and E read the block's ring

template <int C>
using Ring = pipe::RowRing<C, kChunk, kSlots>;

// x: [B, C, N]; lane_in, fin: [5, B]; acc: [10, B].
struct Args {
  const float* __restrict__ x;
  const float* __restrict__ lane_in;
  float* __restrict__ fin;
  float* __restrict__ acc;
  int B, N;
  LaneConsts k;
};

// Shared memory: the barriers (full, empty, ready, taken: kSlots each), the
// constants, the block's ring, the transients' ring.
struct Layout {
  size_t consts, ring, tr, bytes;  // byte offsets; barriers at 0
};
template <int C>
__host__ __device__ constexpr Layout layout() {
  Layout l{};
  l.consts = sizeof(uint64_t) * 4 * kSlots;
  l.ring = l.consts + 32;
  l.tr = l.ring + sizeof(float) * kSlots * Ring<C>::kSlotFloats;
  l.bytes = l.tr + sizeof(float) * kSlots * kChunk * 32;
  return l;
}

template <int C>
struct Ctx {
  int b, bl;  // the clip, the clip clamped into the batch
  int lane;   // the clip within the CTA
  bool live;  // b < B: only live lanes store
  Ring<C> ring;
  float* tr;  // the transients' slots, at this lane: [kSlots][kChunk][32]
  uint64_t* ready;  // [kSlots]: V's lanes have written the slot
  uint64_t* taken;  // [kSlots]: L's lanes have read it
  const LaneConsts* k;  // in shared memory
};

// ---- V: the envelopes, each chunk's transients to L
template <int C>
__device__ void run_envelopes(const Args& a, const Ctx<C>& c) {
  Lane s = lane_load(a.lane_in, c.bl, a.B);
  const EnvConsts e = env_consts(*c.k);
  for (int j = 0; j < c.ring.nc; ++j) {
    const int slot = j % kSlots;
    if (j >= kSlots) pipe::mbar_wait_phase(c.taken + slot, j / kSlots - 1);
    float* t = c.tr + slot * kChunk * 32;
    c.ring.read(j, c.lane, [&](int i, float l, float r) {
      t[i * 32] = lane_step_envelopes(s, l, r, e);
    });
    pipe::mbar_arrive(c.ready + slot);
  }
  if (c.live) lane_store_envelopes(s, a.fin, c.b, a.B);
}

// ---- L: the transient sum and the onsets
template <int C>
__device__ void run_onsets(const Args& a, const Ctx<C>& c) {
  Lane s = lane_load(a.lane_in, c.bl, a.B);
  const LaneConsts k = *c.k;
  for (int j = 0; j < c.ring.nc; ++j) {
    const int slot = j % kSlots, m = c.ring.len(j);
    pipe::mbar_wait_phase(c.ready + slot, j / kSlots);
    const float* t = c.tr + slot * kChunk * 32;
    if (m == kChunk) {
#pragma unroll 8
      for (int i = 0; i < kChunk; ++i) lane_step_onsets(s, t[i * 32], k);
    } else {
#pragma unroll 1
      for (int i = 0; i < m; ++i) lane_step_onsets(s, t[i * 32], k);
    }
    pipe::mbar_arrive(c.taken + slot);
  }
  if (c.live) lane_store_onsets(s, a.fin, a.acc, c.b, a.B);
}

// ---- E: the band energies and the six stateless sums
template <int C>
__device__ void run_energy(const Args& a, const Ctx<C>& c) {
  Lane s = lane_load(a.lane_in, c.bl, a.B);
  const LaneConsts k = *c.k;
  for (int j = 0; j < c.ring.nc; ++j)
    c.ring.read(j, c.lane,
                [&](int, float l, float r) { lane_step_energy(s, l, r, k); });
  if (c.live) lane_store_energy(s, a.fin, a.acc, c.b, a.B);
}

// ---- P: every chunk of the CTA's rows into the ring
template <int C>
__device__ void run_copies(const Args& a, const Ctx<C>& c) {
  const bool vec =
      a.N % 4 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  const int b0 = c.b - c.lane;
  for (int j = 0; j < c.ring.nc; ++j)
    c.ring.fill(a.x, b0, a.B, j, vec, c.lane);
  pipe::cp_wait<0>();
}

// One block of 32 clips; see the file comment.
template <int C>
__global__ void __launch_bounds__(kThreads)
    analyzer_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr Layout l = layout<C>();
  const int warp = threadIdx.x / 32;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  Ctx<C> c;
  c.lane = threadIdx.x % 32;
  c.b = blockIdx.x * kClips + c.lane;
  c.live = c.b < a.B;
  c.bl = c.live ? c.b : a.B - 1;  // lanes past B run on the last clip
  c.ring.slots = reinterpret_cast<float*>(smem + l.ring);
  c.ring.full = bars;
  c.ring.empty = bars + kSlots;
  c.ring.n = a.N;
  c.ring.nc = (a.N + kChunk - 1) / kChunk;
  c.ready = bars + 2 * kSlots;
  c.taken = bars + 3 * kSlots;
  c.tr = reinterpret_cast<float*>(smem + l.tr) + c.lane;
  LaneConsts* k = reinterpret_cast<LaneConsts*>(smem + l.consts);
  c.k = k;
  if (threadIdx.x < 4 * kSlots) {
    const int kind = threadIdx.x / kSlots;  // full, empty, ready, taken
    pipe::mbar_init(bars + threadIdx.x, kind == 1 ? 32 * kReaders : 32);
  }
  if (threadIdx.x == 0) *k = a.k;
  __syncthreads();

  switch (warp) {
    case kWarpV: run_envelopes<C>(a, c); break;
    case kWarpL: run_onsets<C>(a, c); break;
    case kWarpE: run_energy<C>(a, c); break;
    default: run_copies<C>(a, c); break;
  }
}

template <int C>
int prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      analyzer_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(layout<C>().bytes)));
}

template <int C>
int launch(const Args& a, cudaStream_t s) {
  const int err = prepare<C>();
  if (err != 0) return err;
  const int blocks = (a.B + kClips - 1) / kClips;
  analyzer_kernel<C><<<blocks, kThreads, layout<C>().bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// clips and warps per CTA, threads, shared memory bytes, resident CTAs per
// SM, registers and local (spill) bytes per thread, chunk samples
template <int C>
int geometry(int* g) {
  const size_t smem = layout<C>().bytes;
  int err = prepare<C>();
  cudaFuncAttributes attr;
  if (err == 0)
    err = static_cast<int>(cudaFuncGetAttributes(&attr, analyzer_kernel<C>));
  int ctas = 0;
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, analyzer_kernel<C>, kThreads, smem));
  if (err != 0) return err;
  const int v[8] = {kClips, kWarps, kThreads, static_cast<int>(smem), ctas,
                    attr.numRegs, static_cast<int>(attr.localSizeBytes),
                    kChunk};
  for (int i = 0; i < 8; ++i) g[i] = v[i];
  return 0;
}

}  // namespace analyzer
}  // namespace juicy

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted). x is the block [B, C, N], lane_in and fin [5, B],
// acc [10, B], device pointers; the lane constants are f32 values the host
// computed.
int juicy_analyzer_block(const float* x, const float* lane_in, float* fin,
                         float* acc, int B, int C, int N, float atk_s,
                         float rel_s, float atk_l, float rel_l, float low_c,
                         float high_c, float cd_samples, void* stream) {
  namespace an = juicy::analyzer;
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const an::Args a{x, lane_in, fin, acc, B, N,
                   {atk_s, rel_s, atk_l, rel_l, low_c, high_c, cd_samples}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1) return an::launch<1>(a, s);
  if (C == 2) return an::launch<2>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The analyzer kernel's geometry for C channels into g[8]
// (juicy::analyzer::geometry's order; N does not change it); returns a CUDA
// error code.
int juicy_analyzer_geometry(int C, int N, int* g) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 1) return juicy::analyzer::geometry<1>(g);
  if (C == 2) return juicy::analyzer::geometry<2>(g);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
