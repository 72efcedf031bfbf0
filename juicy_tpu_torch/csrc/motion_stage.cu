// Motion full-stage kernel for Hopper (sm_90a): pre-analyze + motion's two
// passes + post-analyze of one block, for every clip of a batch, in one
// launch.
//
// Replaces the TPU kernel juicy_tpu/kernels/stage_kernels.py
// ::motion_stage_step (_motion_kernel with make_motion_p1_body and
// motion.make_p2_step). Plain version beside the wrapper:
// juicy_tpu_torch/kernels/stage_kernels.py::_motion_lanes_plain.
//
// What bounds it: latency, not bytes or operations. Pass 1, pass 2 and the
// analyzer lanes are serial per-sample recurrences, and pass 2 runs the
// channels one after the other (channel 1 starts from the slew, LFO and
// budget state channel 0 left); one thread carrying a clip through all of
// it, as the first version of this kernel did, waits on every dependent
// operation, and one-warp blocks left three of an SM's four schedulers
// idle. Most of pass 2 reads no audio: the slew and the LFO phase depend
// only on pass 1's block-final targets, and the LFO's sin32, the cutoff,
// its one-pole coefficient (a division and an exp polynomial), the
// transient boost, the tone factor and the tail feedback (~70 of pass 2's
// ~109 operations per channel-sample) only on the slew. Per channel only
// lp, prev and tail carry audio, and channel 1 needs channel 0 only through
// the budget limiter's envelope.
//
// So each CTA serves 32 clips, one per lane of every warp (loads and stores
// coalesce over the clip axis of [N, C, B]), and each clip's stage is split
// across seventeen warps with their own roles:
//   V L E  the analyzer lanes split in three (stage_lane.cuh): V the
//          envelopes, L the transient sum and the onsets, E the band
//          energies and the six stateless sums; each runs its part of the
//          pre lane over the input, then of the post lane over the output
//          from the pre lane's end state;
//   P      pass 1 over the input, beside the pre lane, then the block's
//          scales; it publishes the targets, scale and recovery behind the
//          "scales" barrier;
//   Z0 Z1  the slew and the LFO phase, one channel each, into a ring of
//          chunk slots: Z0 runs channel 0's N steps from the block's start
//          state; Z1 runs the same N steps without storing them, then
//          channel 1's N from where they end, the serial code's sequence
//          (so both channels' rings fill at once);
//   H0-H7  taking channel-chunks in turn: the audio-free part of pass 2
//          (motion_p2_mod), in place in the ring, and behind G the
//          limiter's gain (a division), the mix and the output gain
//          (motion_limit_out), the chunk's output to device memory;
//   C0 C1  lp, prev, tail and the wet signal (motion_p2_carry), one channel
//          each, concurrently; the wet signal goes to the output's rows in
//          device memory;
//   G      the budget envelope (motion_budget) over channel 0's wet signal,
//          then channel 1's, carried across, into a ring of chunk slots.
// Each channel-chunk has a once-barrier per hand-off: "slewed" (Z), "mod"
// (H), "wet" (C), after which Z may reuse the slot and G reads the wet
// signal, "budget" (G) and "out" (H), after which G may reuse its slot.
// Once a chunk's output is written in both channels, its "written"
// barrier is complete, and L and E read the output back with cp.async a
// chunk ahead, as every reader here reads its stream (pipe.cuh). Lanes past
// B run every role on their batch's last clip and store nothing, so every
// barrier counts 32 arrivals per warp. Mono (C = 1) analyzes and detects
// on r = l; Z1 and C1 then have nothing to do.
//
// Numerics: each recurrence and each sum stays on one thread in the plain
// version's order (motion.cuh motion_p2_mod / motion_p2_carry are
// motion_p2_wet split, lane.cuh lane_step_envelopes / _onsets / _energy
// lane_step, the same operations in the same order). Built with
// -fmad=false and without fast math (the onset comparator flips on one
// contracted ulp); every transcendental is a precise.cuh polynomial. The
// LCG is a native u32 and the cooldown an int.
#include <cuda_runtime.h>

#include <cstring>

#include "lane.cuh"
#include "motion.cuh"
#include "pipe.cuh"
#include "precise.cuh"
#include "stage_lane.cuh"

namespace juicy {
namespace motion_stage {

using pipe::kChunk;

enum : int {
  kWarpV, kWarpL, kWarpE, kWarpP, kWarpZ0, kWarpZ1, kWarpC0, kWarpC1,
  kWarpG, kWarpH0, kWarps = kWarpH0 + 8
};
constexpr int kHelpers = kWarps - kWarpH0;
constexpr int kThreads = kWarps * 32;
constexpr int kClips = 32;
constexpr int kSlots = 8;    // ring slots per channel
constexpr int kBudgetSlots = 4;  // G's ring slots per channel
// ring fields per sample: the slew (vt, vtr, vtl, phase), which H replaces
// with motion_p2_mod's (lp_c, tone_f, boost, fb)
constexpr int kFields = 4;
// what P publishes per clip: the targets, scale and recovery
enum : int { kVt, kVtr, kVtl, kScale, kRecovery, kPublished };

// Once-barrier sets by channel and chunk (2 * nc each): "slewed" (Z),
// "mod" (H), "wet" (C), "budget" (G), "out" (H); then "written" by chunk
// (H, once per channel), "scales" (P), and the lanes'.
enum : int { kBarSlew, kBarMod, kBarWet, kBarBudget, kBarOut, kChanSets };

// x, out: [N, C, B]; mono_in/out: [10, B] (env, repetition, budget_env, vt,
// vtr, vtl, vt_t, vtr_t, vtl_t, phase); cd_in/out: [B]; rng_in/out: [B]
// (u32); chan_in/out: [3, B, C] (lp, tail, prev); lane_in, *_fin: [5, B];
// *_acc: [10, B].
struct Args {
  const float* __restrict__ x;
  const float* __restrict__ mono_in;
  const int* __restrict__ cd_in;
  const unsigned* __restrict__ rng_in;
  const float* __restrict__ chan_in;
  const float* __restrict__ lane_in;
  float* out;  // C writes the wet signal, G and H read it, H overwrites it
  float* __restrict__ mono_out;
  int* __restrict__ cd_out;
  unsigned* __restrict__ rng_out;
  float* __restrict__ chan_out;
  float* __restrict__ pre_fin;
  float* __restrict__ pre_acc;
  float* __restrict__ post_fin;
  float* __restrict__ post_acc;
  int B, N, cooldown_samples, narrow;
  LaneConsts lk;
  MotionConsts k;
};

// Shared memory: the barriers, the ring, G's ring, P's published values,
// the lanes' ring, then each reader's double buffer.
__host__ __device__ constexpr int stage_rows(int w) {
  return (w == kWarpV || w == kWarpE || w == kWarpP) ? 4 * kChunk
         : (w == kWarpC0 || w == kWarpC1 || w == kWarpG) ? 2 * kChunk : 0;
}
static_assert(stage_lane::kStageRows == 4 * kChunk, "the lanes' reader");
struct Layout {
  int nc, bars;
  size_t ring, budget, pub, lanes, stage, bytes;  // byte offsets
};
__host__ __device__ inline Layout layout(int N) {
  Layout l;
  l.nc = (N + kChunk - 1) / kChunk;
  l.bars = kChanSets * 2 * l.nc + l.nc + 1 + stage_lane::link_bars(l.nc);
  l.ring = (sizeof(uint64_t) * l.bars + 15) / 16 * 16;
  l.budget = l.ring + sizeof(float) * kSlots * 2 * kFields * kChunk * 32;
  l.pub = l.budget + sizeof(float) * kBudgetSlots * 2 * kChunk * 32;
  l.lanes = l.pub + sizeof(float) * kPublished * 32;
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
  uint64_t* bars;
  float* ring;     // at this lane
  float* budget;   // G's ring, at this lane
  float* pub;      // at this lane: [f * 32]
  float* stage;    // the warp's reader buffer, at this lane
  stage_lane::Link link;

  __device__ uint64_t* bar(int set, int ch, int j) const {
    return bars + (set * 2 + ch) * nc + j;
  }
  __device__ uint64_t* out_bar() const { return bars + kChanSets * 2 * nc; }
  __device__ uint64_t* scales() const { return out_bar() + nc; }
  // chunk j's slot of channel ch; field f of sample i at [(f * kChunk + i) * 32]
  __device__ float* slot(int j, int ch) const {
    return ring + ((j % kSlots) * 2 + ch) * kFields * kChunk * 32;
  }
  // sample i of G's slot for chunk j of channel ch: [i * 32]
  __device__ float* budget_slot(int j, int ch) const {
    return budget + ((j % kBudgetSlots) * 2 + ch) * kChunk * 32;
  }
  __device__ int len(int j, int N) const { return min(kChunk, N - j * kChunk); }
};

__device__ __forceinline__ float& at(float* slot, int f, int i) {
  return slot[(f * kChunk + i) * 32];
}

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

// ---- P: pass 1 on |0.5 (l + r)| over the input, then the scales
template <int C>
__device__ void run_pass1(const Args& a, const Ctx& c) {
  const float* m = a.mono_in + c.bl;
  MotionP1 p1{m[0], a.cd_in[c.bl], m[c.sB], a.rng_in[c.bl], m[6 * c.sB],
              m[7 * c.sB], m[8 * c.sB]};
  auto in = pipe::chunk_reader<2>(a.x, C, c.sB, c.bl, 0, a.N, nullptr,
                                  c.stage);
  for (int j = 0; j < c.nc; ++j) {
    const float* v = in.begin(j);
    const int n = in.len(j);
    float xn = fabsf(0.5f * (v[0] + v[32]));  // each |mono| a sample ahead
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const float xi = xn;
      const int nx = i + 1 < n ? i + 1 : i;
      xn = fabsf(0.5f * (v[(2 * nx) * 32] + v[(2 * nx + 1) * 32]));
      motion_p1(p1, xi, a.cooldown_samples, a.k);
    }
  }
  float scale, recovery;
  motion_scales(p1.repetition, a.k, scale, recovery);
  const float pub[kPublished] = {p1.vt_t, p1.vtr_t, p1.vtl_t, scale,
                                 recovery};
#pragma unroll
  for (int f = 0; f < kPublished; ++f) c.pub[f * 32] = pub[f];
  pipe::mbar_arrive(c.scales());
  if (c.live) {
    const float mo[5] = {p1.env, p1.repetition, p1.vt_t, p1.vtr_t, p1.vtl_t};
    const int row[5] = {0, 1, 6, 7, 8};
#pragma unroll
    for (int f = 0; f < 5; ++f) a.mono_out[row[f] * c.sB + c.b] = mo[f];
    a.cd_out[c.b] = p1.cooldown;
    a.rng_out[c.b] = p1.rng;
  }
}

// ---- Z: the slew and the phase of channel ch, into the ring
template <int C>
__device__ void run_slew(const Args& a, const Ctx& c, int ch) {
  const float* m = a.mono_in + c.bl;
  MotionShared sh{m[3 * c.sB], m[4 * c.sB], m[5 * c.sB], m[9 * c.sB], 0.0f};
  pipe::mbar_wait(c.scales());
  const MotionP1 p1{0.0f, 0, 0.0f, 0u, c.pub[kVt * 32], c.pub[kVtr * 32],
                    c.pub[kVtl * 32]};
  if (ch == 1) {  // channel 0's steps: channel 1 starts where they end
#pragma unroll 1
    for (int t = 0; t < a.N; ++t) motion_slew(sh, p1, a.k);
  }
  for (int j = 0; j < c.nc; ++j) {
    if (j >= kSlots) pipe::mbar_wait(c.bar(kBarWet, ch, j - kSlots));
    float* s = c.slot(j, ch);
    const int n = c.len(j, a.N);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      motion_slew(sh, p1, a.k);
      at(s, 0, i) = sh.vt;
      at(s, 1, i) = sh.vtr;
      at(s, 2, i) = sh.vtl;
      at(s, 3, i) = sh.phase;
    }
    pipe::mbar_arrive(c.bar(kBarSlew, ch, j));
  }
  if (ch == C - 1 && c.live) {
    const float mo[4] = {sh.vt, sh.vtr, sh.vtl, sh.phase};
    const int row[4] = {3, 4, 5, 9};
#pragma unroll
    for (int f = 0; f < 4; ++f) a.mono_out[row[f] * c.sB + c.b] = mo[f];
  }
}

// ---- H: the units h, h + kHelpers, ... of the 2 C nc below, in order:
// motion_p2_mod of a channel-chunk, in place in the ring, or the limiter's
// output of one behind G. The channels' mod units alternate, chunk by
// chunk, and channel 0's output of chunk j - kLag follows chunk j's mod,
// so that G, which carries the budget envelope through channel 0 whole
// before channel 1, keeps pace with C0; channel 1's outputs come last.
// Each unit depends only on units before it, so no helper waits on one
// after.
constexpr int kLag = 2;
struct Unit {
  bool mod;
  int ch, j;
};
template <int C>
__device__ __forceinline__ Unit unit(int u, int nc) {
  const int lag = min(kLag, nc);
  const int k = u - C * lag;          // past the first lag chunks' mod
  const int lead = (C + 1) * (nc - lag);
  if (k < 0) return {true, u % C, u / C};
  if (k < lead) {
    const int r = k % (C + 1), j = lag + k / (C + 1);
    return r < C ? Unit{true, r, j} : Unit{false, 0, j - lag};
  }
  const int q = k - lead;             // the last lag outputs of channel 0,
  if (q < lag) return {false, 0, nc - lag + q};
  return {false, 1, q - lag};         // then channel 1's
}

template <int C>
__device__ void run_helper(const Args& a, const Ctx& c, int h) {
  const size_t row = static_cast<size_t>(C) * c.sB;
  for (int u = h; u < 2 * C * c.nc; u += kHelpers) {
    const Unit t = unit<C>(u, c.nc);
    const int ch = t.ch, j = t.j, n = c.len(j, a.N);
    if (t.mod) {
      const float ch_offset = ch == 0 ? 0.0f : 0.85f;
      pipe::mbar_wait(c.bar(kBarSlew, ch, j));
      float* s = c.slot(j, ch);
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const MotionShared sh{at(s, 0, i), at(s, 1, i), at(s, 2, i),
                              at(s, 3, i), 0.0f};
        const MotionMod md = motion_p2_mod(sh, ch_offset, a.narrow != 0, a.k);
        at(s, 0, i) = md.lp_c;
        at(s, 1, i) = md.tone_f;
        at(s, 2, i) = md.boost;
        at(s, 3, i) = md.fb;
      }
      pipe::mbar_arrive(c.bar(kBarMod, ch, j));
      continue;
    }
    // the chunk's input and wet signal, loaded at once, then the output
    const size_t at0 = static_cast<size_t>(j * kChunk) * row + ch * c.sB;
    float d[kChunk], w[kChunk];
    pipe::mbar_wait(c.bar(kBarBudget, ch, j));
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < n) {
        d[i] = a.x[at0 + i * row + c.bl];
        w[i] = a.out[at0 + i * row + c.bl];
      }
    }
    const float* be = c.budget_slot(j, ch);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < n) {
        const float o = motion_limit_out(d[i], w[i], be[i * 32], a.k);
        if (c.live) a.out[at0 + i * row + c.b] = o;
      }
    }
    pipe::mbar_arrive(c.bar(kBarOut, ch, j));
    pipe::mbar_arrive(c.out_bar() + j);
  }
}

// ---- C: lp, prev, tail and the wet signal of channel ch, behind H; the
// wet signal to the output's rows
template <int C>
__device__ void run_carry(const Args& a, const Ctx& c, int ch) {
  MotionChan mc{a.chan_in[c.bl * C + ch], a.chan_in[(c.sB + c.bl) * C + ch],
                a.chan_in[(2 * c.sB + c.bl) * C + ch]};
  auto in = pipe::chunk_reader<1>(a.x, C, c.sB, c.bl, ch, a.N, nullptr,
                                  c.stage);
  float* __restrict__ y = a.out + ch * c.sB + c.b;
  pipe::mbar_wait(c.scales());
  const float scale = c.pub[kScale * 32], recovery = c.pub[kRecovery * 32];
  for (int j = 0; j < c.nc; ++j) {
    const float* v = in.begin(j);
    const int t0 = j * kChunk, n = in.len(j);
    pipe::mbar_wait(c.bar(kBarMod, ch, j));
    float* s = c.slot(j, ch);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const MotionMod md{at(s, 0, i), at(s, 1, i), at(s, 2, i), at(s, 3, i)};
      const float w = motion_p2_carry(v[i * 32], mc, md, scale, recovery,
                                      a.k);
      if (c.live) y[static_cast<size_t>(t0 + i) * C * c.sB] = w;
    }
    pipe::mbar_arrive(c.bar(kBarWet, ch, j));
  }
  if (c.live) {
    a.chan_out[c.b * C + ch] = mc.lp;
    a.chan_out[(c.sB + c.b) * C + ch] = mc.tail;
    a.chan_out[(2 * c.sB + c.b) * C + ch] = mc.prev;
  }
}

// ---- G: the budget envelope over channel 0's wet signal, then channel
// 1's, carried across, into G's ring for the helpers' output
template <int C>
__device__ void run_budget(const Args& a, const Ctx& c) {
  float budget_env = a.mono_in[2 * c.sB + c.bl];
#pragma unroll 1
  for (int ch = 0; ch < C; ++ch) {
    auto wet = pipe::chunk_reader<1>(a.out, C, c.sB, c.bl, ch, a.N,
                                     c.bar(kBarWet, ch, 0), c.stage);
    for (int j = 0; j < c.nc; ++j) {
      const float* w = wet.begin(j);
      const int n = wet.len(j);
      if (j >= kBudgetSlots)
        pipe::mbar_wait(c.bar(kBarOut, ch, j - kBudgetSlots));  // slot free
      float* r = c.budget_slot(j, ch);
      float wn = w[0];
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const float wi = wn;
        wn = w[(i + 1 < n ? i + 1 : i) * 32];
        motion_budget(wi, budget_env, a.k);
        r[i * 32] = budget_env;
      }
      pipe::mbar_arrive(c.bar(kBarBudget, ch, j));
    }
  }
  if (c.live) a.mono_out[2 * c.sB + c.b] = budget_env;
}

// One block of 32 clips; see the file comment.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    motion_stage_kernel(const __grid_constant__ Args a) {
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
  c.budget = reinterpret_cast<float*>(smem + l.budget) + lane;
  c.pub = reinterpret_cast<float*>(smem + l.pub) + lane;
  c.link = {reinterpret_cast<float*>(smem + l.lanes) + lane,
            c.scales() + 1};
  int rows = 0;
  for (int w = 0; w < warp; ++w) rows += stage_rows(w);
  c.stage = reinterpret_cast<float*>(smem + l.stage) + rows * 32 + lane;
  // "written": once per channel; every other barrier: one warp
  const int written = kChanSets * 2 * l.nc;
  for (int i = threadIdx.x; i < l.bars; i += kThreads)
    pipe::mbar_init(c.bars + i,
                    i >= written && i < written + l.nc ? 32 * C : 32);
  __syncthreads();

  switch (warp) {
    case kWarpV: run_lane<C, stage_lane::kEnvelopes>(a, c); break;
    case kWarpL: run_lane<C, stage_lane::kOnsets>(a, c); break;
    case kWarpE: run_lane<C, stage_lane::kEnergy>(a, c); break;
    case kWarpP: run_pass1<C>(a, c); break;
    case kWarpZ0: run_slew<C>(a, c, 0); break;
    case kWarpZ1: if (C == 2) run_slew<C>(a, c, 1); break;
    case kWarpC0: run_carry<C>(a, c, 0); break;
    case kWarpC1: if (C == 2) run_carry<C>(a, c, 1); break;
    case kWarpG: run_budget<C>(a, c); break;
    default: run_helper<C>(a, c, warp - kWarpH0); break;
  }
}

template <int C>
int prepare(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      motion_stage_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(motion_stage_kernel<C>,
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
  motion_stage_kernel<C><<<blocks, kThreads, smem, s>>>(a);
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
        cudaFuncGetAttributes(&attr, motion_stage_kernel<C>));
  int ctas = 0;
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, motion_stage_kernel<C>, kThreads, smem));
  if (err != 0) return err;
  const int v[8] = {kClips, kWarps, kThreads, static_cast<int>(smem), ctas,
                    attr.numRegs, static_cast<int>(attr.localSizeBytes),
                    kChunk};
  for (int i = 0; i < 8; ++i) g[i] = v[i];
  return 0;
}

}  // namespace motion_stage
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
  namespace ms = juicy::motion_stage;
  constexpr int kLane = sizeof(juicy::LaneConsts) / sizeof(float);
  constexpr int kMotion = sizeof(juicy::MotionConsts) / sizeof(float);
  if (n_consts != kLane + kMotion || B <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ms::Args a{x,       mono_in,  cd_in,    rng_in,  chan_in, lane_in,
             out,     mono_out, cd_out,   rng_out, chan_out, pre_fin,
             pre_acc, post_fin, post_acc, B,       N,       cooldown_samples,
             narrow,  {},       {}};
  std::memcpy(&a.lk, consts, sizeof(a.lk));
  std::memcpy(&a.k, consts + kLane, sizeof(a.k));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1) return ms::launch<1>(a, s);
  if (C == 2) return ms::launch<2>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The motion kernel's geometry for C channels and block size N into g[8]
// (juicy::motion_stage::geometry's order); returns a CUDA error code.
int juicy_motion_geometry(int C, int N, int* g) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 1) return juicy::motion_stage::geometry<1>(N, g);
  if (C == 2) return juicy::motion_stage::geometry<2>(N, g);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
