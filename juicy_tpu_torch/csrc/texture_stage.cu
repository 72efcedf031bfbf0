// Texture full-stage kernel for Hopper (sm_90a): pre-analyze + texture +
// post-analyze of one block, for every clip of a batch, in one launch, for a
// material fixed per launch (0 gel, 1 metal, 2 wood, 3 plastic, 4 flesh)
// or, in texture_stage_mixed, one material per CTA of 32 clips.
//
// Replaces the TPU kernel juicy_tpu/kernels/stage_kernels.py
// ::texture_stage_step (_texture_kernel with make_tex_sample and
// make_white_at). Plain version beside the wrapper:
// juicy_tpu_torch/kernels/stage_kernels.py::_tex_lanes_plain.
//
// What bounds it: latency, not bytes or operations. The envelopes, the band
// split, the material models, the noise high-pass, the tail, the wet
// envelope, the DC blocker, the limiter, the LCG and the analyzer lanes are
// serial per-sample recurrences; one thread carrying a clip through all of
// it, as the first version of this kernel did, waits on every dependent
// operation. Much of the work feeds no state: metal's four cos32 depend on
// the front's impact alone, gel's and flesh's tanh32 read the material
// state but never feed it, and the auto-gain's division reads the wet
// envelope but feeds no recurrence; six of the lane's ten sums carry
// nothing.
//
// So each CTA serves 32 clips, one per lane of every warp (loads and stores
// coalesce over the clip axis of [N, C, B]), and each clip's stage is split
// across fifteen warps with their own roles:
//   V L E  the analyzer lanes split in three (stage_lane.cuh): V the
//          envelopes, L the transient sum and the onsets, E the band
//          energies and the six stateless sums; each runs its part of the
//          pre lane over the input, then of the post lane over the output
//          from the pre lane's end state;
//   F0 F1  one channel each: the front (envelope, band split);
//   M0 M1  one channel each, behind F: the material's state (metal's mode
//          bank behind the helpers' a1);
//   W0 W1  one channel each, behind M: the LCG, the noise high-pass,
//          dynamics, tail and wet envelope;
//   D0 D1  one channel each, behind the helpers' auto-gain: the DC blocker
//          and the limiter;
//   H0-H3  chunks in turn, both channels: metal's a1 from the impact
//          (F -> H -> M), gel's and flesh's tanh32 (M -> H -> W),
//          and for every material the auto-gain, mix and output gain
//          (W -> H -> D).
// The hand-offs are rings of chunk slots in shared memory: FB (F to M, W
// and H: the input, impact, body, core, the material's output; metal adds
// hp and the four a1) and WD (W to H to D: the wet signal, then the value
// before the DC blocker, and the wet envelope). Each chunk has a
// once-barrier per stage (pipe.cuh): F, H's a1 or tanh32, M, W, H's
// auto-gain, and the output, which D writes to
// device memory and L and E read back with cp.async a chunk ahead, as
// every reader here reads its stream. F reuses an FB slot once the
// auto-gain of the slot's previous chunk is done, W a WD slot once D is.
//
// Wood's and plastic's ring [L, C, B] stays in device memory and is written
// in place by M: at each chunk's start the taps that fall before the chunk
// are fetched with cp.async; the ones inside it (a delay shorter than a
// chunk) come from the chunk's own history in shared memory.
//
// Lanes past B run every role on their batch's last clip and store
// nothing, so every barrier counts 32 arrivals per warp. Mono (C = 1)
// analyzes r = l; the channel-1 warps then have nothing to do.
//
// Numerics: each recurrence and each sum stays on one thread in the plain
// version's order; the pieces in texture.cuh and lane.cuh are the composed
// bodies split, the same operations in the same order. Built with
// -fmad=false and without fast math; every transcendental is a precise.cuh
// polynomial.
#include <cuda_runtime.h>

#include <cstring>

#include "lane.cuh"
#include "pipe.cuh"
#include "precise.cuh"
#include "stage_lane.cuh"
#include "texture.cuh"

namespace juicy {
namespace texture_stage {

using pipe::kChunk;

enum : int {
  kWarpV, kWarpL, kWarpE, kWarpF0, kWarpF1, kWarpM0, kWarpM1, kWarpW0,
  kWarpW1, kWarpD0, kWarpD1, kWarpH0, kWarps = kWarpH0 + 4
};
constexpr int kHelpers = kWarps - kWarpH0;
constexpr int kThreads = kWarps * 32;
constexpr int kClips = 32;

// FB ring fields per sample, then metal's
enum : int { kFbD, kFbImpact, kFbBody, kFbCore, kFbShaped, kFbHp, kFbA1 };
// WD ring fields per sample: the wet signal (then the value before the DC
// blocker) and the wet envelope
enum : int { kWdWet, kWdEnv, kWdFields };
constexpr int kSlotsWD = 3;

__host__ __device__ constexpr int fb_fields(int mode) {
  return mode == 1 ? kFbA1 + 4 : kFbHp;
}
__host__ __device__ constexpr int fb_slots(int mode) {
  return mode == 1 ? 4 : 6;
}

// Once-barrier sets, one barrier per chunk each: F, H's a1 (metal) or
// tanh32 (gel, flesh), M, W, H's auto-gain, the output (D). F, M, W and D
// arrive once per channel, a helper once per chunk.
enum : int { kBarFront, kBarAux, kBarMat, kBarWet, kBarGain, kBarOut, kBarSets };
__host__ __device__ constexpr bool by_channel(int set) {
  return set != kBarAux && set != kBarGain;
}

// x, out: [N, C, B]; dsp_in/out: [9, B, C]; mat_in/out: [NMAT, B, C];
// rng_in/out: [B] (u32); widx_in/out: [B, C]; ring: [L, C, B] (wave modes,
// in place); lane_in, *_fin: [5, B]; *_acc: [10, B].
struct Args {
  const float* __restrict__ x;
  const float* __restrict__ dsp_in;
  const float* __restrict__ mat_in;
  const unsigned* __restrict__ rng_in;
  const int* __restrict__ widx_in;
  const float* __restrict__ lane_in;
  float* ring;
  float* __restrict__ out;
  float* __restrict__ dsp_out;
  float* __restrict__ mat_out;
  unsigned* __restrict__ rng_out;
  int* __restrict__ widx_out;
  float* __restrict__ pre_fin;
  float* __restrict__ pre_acc;
  float* __restrict__ post_fin;
  float* __restrict__ post_acc;
  int B, N, L;
  unsigned jump_a, jump_b;  // channel 1's LCG start from channel 0's
  LaneConsts lk;
  TexConsts k;
};

// ---- shared memory: the barriers (then the lanes'), the FB and WD rings,
// the lanes' ring, then each reader's double buffer (and, for wave M, the
// ring taps, the chunk's history and each sample's tap positions)
__host__ __device__ constexpr int stage_rows(int w, int mode) {
  return (w == kWarpV || w == kWarpE) ? stage_lane::kStageRows
         : (w == kWarpF0 || w == kWarpF1) ? 2 * kChunk
         : ((w == kWarpM0 || w == kWarpM1) && (mode == 2 || mode == 3))
             ? 6 * kChunk
             : 0;
}
__host__ __device__ constexpr int rows_before(int w, int mode) {
  int r = 0;
  for (int i = 0; i < w; ++i) r += stage_rows(i, mode);
  return r;
}

struct Layout {
  int nc, bars;
  size_t fb, wd, lanes, stage, bytes;  // byte offsets; barriers at 0
};
template <int MODE>
__host__ __device__ inline Layout layout(int N) {
  Layout l;
  l.nc = (N + kChunk - 1) / kChunk;
  l.bars = kBarSets * l.nc + stage_lane::link_bars(l.nc);
  l.fb = (sizeof(uint64_t) * l.bars + 15) / 16 * 16;
  l.wd = l.fb + sizeof(float) * fb_slots(MODE) * 2 * fb_fields(MODE) *
                    kChunk * 32;
  l.lanes = l.wd + sizeof(float) * kSlotsWD * 2 * kWdFields * kChunk * 32;
  l.stage = l.lanes + sizeof(float) * stage_lane::kRingRows * 32;
  l.bytes = l.stage + sizeof(float) * 32 * rows_before(kWarps, MODE);
  return l;
}

// What every role knows of its lane; Ctx<MODE> adds the FB ring's shape,
// which depends on the material.
struct CtxBase {
  int b, bl;       // the clip, the clip clamped into the batch
  bool live;       // b < B: only live lanes store
  size_t sB;
  int nc;
  uint64_t* bars;
  float* fb;       // at this lane
  float* wd;       // at this lane
  float* stage;    // the warp's reader buffer, at this lane
  stage_lane::Link link;

  __device__ uint64_t* bar(int set, int j = 0) const {
    return bars + set * nc + j;
  }
  __device__ uint64_t* out_bar() const { return bar(kBarOut); }
  // field f of sample i of a slot at [(f * kChunk + i) * 32]
  __device__ float* wd_slot(int j, int ch) const {
    return wd + ((j % kSlotsWD) * 2 + ch) * kWdFields * kChunk * 32;
  }
  __device__ int len(int j, int N) const { return min(kChunk, N - j * kChunk); }
};

template <int MODE>
struct Ctx : CtxBase {
  static constexpr int kSlotsFB = fb_slots(MODE);
  static constexpr int kFieldsFB = fb_fields(MODE);
  // chunk j's slot of channel ch
  __device__ float* fb_slot(int j, int ch) const {
    return fb + ((j % kSlotsFB) * 2 + ch) * kFieldsFB * kChunk * 32;
  }
};

__device__ __forceinline__ float& at(float* slot, int f, int i) {
  return slot[(f * kChunk + i) * 32];
}

// ---- V, L and E: one part of both lanes each (stage_lane.cuh)
template <int C, int PART>
__device__ void run_lane(const Args& a, const CtxBase& c) {
  stage_lane::run<PART>(
      pipe::chunk_reader<2>(a.x, C, c.sB, c.bl, 0, a.N, nullptr, c.stage),
      pipe::chunk_reader<2>(a.out, C, c.sB, c.bl, 0, a.N, c.out_bar(),
                            c.stage),
      c.link, a.lane_in, a.pre_fin, a.pre_acc, a.post_fin, a.post_acc, c.b,
      c.bl, c.live, a.B, a.lk);
}

// ---- F: the front of channel ch (envelope, band split), into the FB ring
template <int C, int MODE>
__device__ void run_front(const Args& a, const Ctx<MODE>& c, int ch) {
  constexpr int R = Ctx<MODE>::kSlotsFB;
  const TexConsts& k = a.k;
  TexChan s{};
  s.env = a.dsp_in[(0 * c.sB + c.bl) * C + ch];
  s.lp = a.dsp_in[(1 * c.sB + c.bl) * C + ch];
  s.hp = a.dsp_in[(2 * c.sB + c.bl) * C + ch];
  auto in = pipe::chunk_reader<1>(a.x, C, c.sB, c.bl, ch, a.N, nullptr,
                                  c.stage);
  for (int j = 0; j < c.nc; ++j) {
    if (j >= R) pipe::mbar_wait(c.bar(kBarGain, j - R));  // slot free
    const float* v = in.begin(j);
    const int n = in.len(j);
    float* r = c.fb_slot(j, ch);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const float d = v[i * 32];
      const TexDrive dv = tex_front(d, s, k);
      at(r, kFbD, i) = d;
      at(r, kFbImpact, i) = dv.impact;
      at(r, kFbBody, i) = dv.body;
      at(r, kFbCore, i) = dv.core;
      if constexpr (MODE == 1) at(r, kFbHp, i) = s.hp;
    }
    pipe::mbar_arrive(c.bar(kBarFront, j));
  }
  if (c.live) {
    const float v3[3] = {s.env, s.lp, s.hp};
#pragma unroll
    for (int i = 0; i < 3; ++i) a.dsp_out[(i * c.sB + c.b) * C + ch] = v3[i];
  }
}

// ---- M: the material of channel ch, behind F (metal: behind the helpers'
// a1); gel's and flesh's output before its tanh32
template <int C, int MODE>
__device__ void run_material(const Args& a, const Ctx<MODE>& c, int ch) {
  constexpr int NMAT = tex_nmat(MODE);
  constexpr bool kWave = MODE == 2 || MODE == 3;
  const TexConsts& k = a.k;
  float m[NMAT];
#pragma unroll
  for (int j = 0; j < NMAT; ++j) m[j] = a.mat_in[(j * c.sB + c.bl) * C + ch];
  const int L = a.L;
  // the wrapper checks the index; the wrap only keeps a bad one in bounds
  int widx = kWave ? ((a.widx_in[c.bl * C + ch] % L) + L) % L : 0;
  float* pre = c.stage;                    // wave: 2 * kChunk rows of taps
  float* hist = pre + 2 * kChunk * 32;     // wave: kChunk rows written
  // wave: per sample, where its two taps lie after the chunk's first write
  // index, and the interpolation fraction
  int* rel = reinterpret_cast<int*>(hist + kChunk * 32);
  float* frac = hist + 3 * kChunk * 32;
  const float* ring = kWave ? a.ring + ch * c.sB + c.bl : nullptr;
  const size_t ring_row = static_cast<size_t>(C) * c.sB;
  for (int j = 0; j < c.nc; ++j) {
    const int n = c.len(j, a.N);
    const int w0 = widx;
    if constexpr (kWave) {
      int w = w0;
      for (int i = 0; i < n; ++i) {
        const RingTap tap = tex_ring_tap(w, k.m[12], L);
        const int r0 = pipe::ring_rel(tap.i0, w0, L);
        const int r1 = pipe::ring_rel(tap.i1, w0, L);
        if (r0 >= i)
          pipe::cp_async4(pre + (2 * i) * 32, ring + tap.i0 * ring_row);
        if (r1 >= i)
          pipe::cp_async4(pre + (2 * i + 1) * 32, ring + tap.i1 * ring_row);
        rel[(2 * i) * 32] = r0;
        rel[(2 * i + 1) * 32] = r1;
        frac[i * 32] = tap.frac;
        w = w + 1 >= L ? 0 : w + 1;
      }
      pipe::cp_commit();
    }
    pipe::mbar_wait(c.bar(MODE == 1 ? kBarAux : kBarFront, j));
    if constexpr (kWave) pipe::cp_wait<0>();
    float* r = c.fb_slot(j, ch);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const float impact = at(r, kFbImpact, i), core = at(r, kFbCore, i);
      float shaped;
      if constexpr (MODE == 1) {
        const float a1[4] = {at(r, kFbA1, i), at(r, kFbA1 + 1, i),
                             at(r, kFbA1 + 2, i), at(r, kFbA1 + 3, i)};
        shaped = metal_bank(m, core, impact, at(r, kFbHp, i), a1, k);
      } else {
        const TexDrive dv{core, impact, at(r, kFbBody, i),
                          tex_trail(impact, k)};
        if constexpr (MODE == 0) {
          shaped = gel_arg(m, dv, k);
        } else if constexpr (kWave) {
          const int r0 = rel[(2 * i) * 32], r1 = rel[(2 * i + 1) * 32];
          const float v0 = r0 < i ? hist[r0 * 32] : pre[(2 * i) * 32];
          const float v1 = r1 < i ? hist[r1 * 32] : pre[(2 * i + 1) * 32];
          const float delayed = v0 + frac[i * 32] * (v1 - v0);
          float new_wave;
          shaped = wave_step(m, dv, delayed, new_wave, k);
          hist[i * 32] = new_wave;
          if (c.live)
            a.ring[(widx * static_cast<size_t>(C) + ch) * c.sB + c.b] =
                new_wave;
          widx = widx + 1 >= L ? 0 : widx + 1;
        } else {
          shaped = flesh_arg(m, dv, k);
        }
      }
      at(r, kFbShaped, i) = shaped;
    }
    pipe::mbar_arrive(c.bar(kBarMat, j));
  }
  if (c.live) {
#pragma unroll
    for (int j = 0; j < NMAT; ++j) a.mat_out[(j * c.sB + c.b) * C + ch] = m[j];
    if constexpr (kWave) a.widx_out[c.b * C + ch] = widx;
  }
}

// ---- W: tex_back up to the wet envelope for channel ch, behind M.
// Channel 0 takes draws 1..N, channel 1 draws N+1..2N (cpp:239): its LCG
// starts at jump_a * rng0 + jump_b, and the last channel writes the LCG
// back.
template <int C, int MODE>
__device__ void run_wet(const Args& a, const Ctx<MODE>& c, int ch) {
  constexpr int kShapedBar = (MODE == 0 || MODE == 4) ? kBarAux : kBarMat;
  const TexConsts& k = a.k;
  TexChan s{};
  s.noise_hp = a.dsp_in[(3 * c.sB + c.bl) * C + ch];
  s.tail = a.dsp_in[(4 * c.sB + c.bl) * C + ch];
  s.wet_env = a.dsp_in[(5 * c.sB + c.bl) * C + ch];
  const unsigned rng0 = a.rng_in[c.bl];
  unsigned rng = ch == 0 ? rng0 : a.jump_a * rng0 + a.jump_b;
  for (int j = 0; j < c.nc; ++j) {
    const int n = c.len(j, a.N);
    pipe::mbar_wait(c.bar(kShapedBar, j));
    if (j >= kSlotsWD) pipe::mbar_wait(c.out_bar() + j - kSlotsWD);
    float* r = c.fb_slot(j, ch);
    float* w = c.wd_slot(j, ch);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      rng = lcg_step(rng);
      at(w, kWdWet, i) = tex_back_wet(at(r, kFbShaped, i), tex_white(rng),
                                      at(r, kFbImpact, i), at(r, kFbBody, i),
                                      s, k);
      at(w, kWdEnv, i) = s.wet_env;
    }
    pipe::mbar_arrive(c.bar(kBarWet, j));
  }
  if (c.live) {
    const float v3[3] = {s.noise_hp, s.tail, s.wet_env};
#pragma unroll
    for (int i = 0; i < 3; ++i)
      a.dsp_out[((3 + i) * c.sB + c.b) * C + ch] = v3[i];
    if (ch == C - 1) a.rng_out[c.b] = rng;
  }
}

// ---- D: the DC blocker and the limiter of channel ch, behind the helpers'
// auto-gain; the output to device memory
template <int C>
__device__ void run_limit(const Args& a, const CtxBase& c, int ch) {
  const TexConsts& k = a.k;
  TexChan s{};
  s.dc_in = a.dsp_in[(6 * c.sB + c.bl) * C + ch];
  s.dc_out = a.dsp_in[(7 * c.sB + c.bl) * C + ch];
  s.pg = a.dsp_in[(8 * c.sB + c.bl) * C + ch];
  float* __restrict__ y = a.out + ch * c.sB + c.b;
  for (int j = 0; j < c.nc; ++j) {
    const int t0 = j * kChunk, n = c.len(j, a.N);
    pipe::mbar_wait(c.bar(kBarGain, j));
    float* w = c.wd_slot(j, ch);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const float o = tex_back_limit(at(w, kWdWet, i), s, k);
      if (c.live) y[static_cast<size_t>(t0 + i) * C * c.sB] = o;
    }
    pipe::mbar_arrive(c.out_bar() + j);
  }
  if (c.live) {
    const float v3[3] = {s.dc_in, s.dc_out, s.pg};
#pragma unroll
    for (int i = 0; i < 3; ++i)
      a.dsp_out[((6 + i) * c.sB + c.b) * C + ch] = v3[i];
  }
}

// ---- H: chunks h, h + kHelpers, ..., both channels
template <int C, int MODE>
__device__ void run_helper(const Args& a, const Ctx<MODE>& c, int h) {
  const TexConsts& k = a.k;
  for (int j = h; j < c.nc; j += kHelpers) {
    const int n = c.len(j, a.N);
    if constexpr (MODE == 1) {  // a1 of the four modes, from the impact
      pipe::mbar_wait(c.bar(kBarFront, j));
      for (int ch = 0; ch < C; ++ch) {
        float* r = c.fb_slot(j, ch);
#pragma unroll 1
        for (int i = 0; i < n; ++i) {
          const float impact = at(r, kFbImpact, i);
#pragma unroll
          for (int m = 0; m < 4; ++m)
            at(r, kFbA1 + m, i) = metal_a1(impact, m, k);
        }
      }
      pipe::mbar_arrive(c.bar(kBarAux, j));
    } else if constexpr (MODE == 0 || MODE == 4) {  // the material's tanh32
      pipe::mbar_wait(c.bar(kBarMat, j));
      for (int ch = 0; ch < C; ++ch) {
        float* r = c.fb_slot(j, ch);
#pragma unroll 1
        for (int i = 0; i < n; ++i)
          at(r, kFbShaped, i) = tanh32(at(r, kFbShaped, i));
      }
      pipe::mbar_arrive(c.bar(kBarAux, j));
    }
    pipe::mbar_wait(c.bar(kBarWet, j));
    for (int ch = 0; ch < C; ++ch) {
      float* r = c.fb_slot(j, ch);
      float* w = c.wd_slot(j, ch);
#pragma unroll 1
      for (int i = 0; i < n; ++i)
        at(w, kWdWet, i) = tex_back_gain(at(r, kFbD, i), at(w, kWdWet, i),
                                         at(w, kWdEnv, i), k);
    }
    pipe::mbar_arrive(c.bar(kBarGain, j));
  }
}

// The CTA's context for material MODE, its barriers initialized.
template <int C, int MODE>
__device__ __forceinline__ CtxBase texture_ctx(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout<MODE>(a.N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  CtxBase c;
  c.b = blockIdx.x * kClips + lane;
  c.live = c.b < a.B;
  c.bl = c.live ? c.b : a.B - 1;  // lanes past B run on the last clip
  c.sB = static_cast<size_t>(a.B);
  c.nc = l.nc;
  c.bars = reinterpret_cast<uint64_t*>(smem);
  c.fb = reinterpret_cast<float*>(smem + l.fb) + lane;
  c.wd = reinterpret_cast<float*>(smem + l.wd) + lane;
  c.link = {reinterpret_cast<float*>(smem + l.lanes) + lane,
            c.bars + kBarSets * l.nc};
  c.stage = reinterpret_cast<float*>(smem + l.stage) +
            rows_before(warp, MODE) * 32 + lane;
  for (int i = threadIdx.x; i < l.bars; i += kThreads)
    pipe::mbar_init(c.bars + i,
                    i < kBarSets * l.nc && by_channel(i / l.nc) ? 32 * C : 32);
  return c;
}

// The roles whose code depends on the material: F, M, W and H.
template <int C, int MODE>
__device__ __forceinline__ void material_roles(const Args& a,
                                               const CtxBase& base,
                                               int warp) {
  const Ctx<MODE> c{base};
  switch (warp) {
    case kWarpF0: run_front<C, MODE>(a, c, 0); break;
    case kWarpF1: if (C == 2) run_front<C, MODE>(a, c, 1); break;
    case kWarpM0: run_material<C, MODE>(a, c, 0); break;
    case kWarpM1: if (C == 2) run_material<C, MODE>(a, c, 1); break;
    case kWarpW0: run_wet<C, MODE>(a, c, 0); break;
    case kWarpW1: if (C == 2) run_wet<C, MODE>(a, c, 1); break;
    default: run_helper<C, MODE>(a, c, warp - kWarpH0); break;
  }
}

// The roles whose code is the same for every material: V, L and E (the
// lanes) and D (the DC blocker and limiter, whose constant, dc_r, is the
// same in every material's row). Returns false for the other warps.
template <int C>
__device__ __forceinline__ bool shared_roles(const Args& a, const CtxBase& c,
                                             int warp) {
  switch (warp) {
    case kWarpV: run_lane<C, stage_lane::kEnvelopes>(a, c); return true;
    case kWarpL: run_lane<C, stage_lane::kOnsets>(a, c); return true;
    case kWarpE: run_lane<C, stage_lane::kEnergy>(a, c); return true;
    case kWarpD0: run_limit<C>(a, c, 0); return true;
    case kWarpD1: if (C == 2) run_limit<C>(a, c, 1); return true;
    default: return false;
  }
}

// One block of 32 clips, material MODE; see the file comment.
template <int C, int MODE>
__device__ __forceinline__ void texture_cta(const Args& a) {
  const CtxBase c = texture_ctx<C, MODE>(a);
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if (!shared_roles<C>(a, c, warp)) material_roles<C, MODE>(a, c, warp);
}

// One static material for the whole launch.
template <int C, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    texture_stage_kernel(const __grid_constant__ Args a) {
  texture_cta<C, MODE>(a);
}

// A material per CTA: a[m] holds the launch's buffers with material m's
// constants (all five rows filled), cta_mode one material per 32 clips,
// mask bit m each material present. Each CTA lays out its shared memory
// for its material; the material's roles (F, M, W, H) switch once into
// that material's code, reading a[m] as the static kernel reads its Args;
// the lanes and D are the one copy every material shares, reading a[0]
// (the same buffers and lane constants, and dc_r). One body per material
// measured 1.4-1.6x slower than either material alone when CTAs of two
// materials shared an SM (PERF.md).
struct MixedArgs {
  Args a[5];
  const int* __restrict__ cta_mode;
  int mask;
};

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    texture_stage_mixed(const __grid_constant__ MixedArgs m) {
  const int mode = m.cta_mode[blockIdx.x];
  if (mode < 0 || mode > 4 || !((m.mask >> mode) & 1)) __trap();
  CtxBase c;
  switch (mode) {
    case 0: c = texture_ctx<C, 0>(m.a[0]); break;
    case 1: c = texture_ctx<C, 1>(m.a[1]); break;
    case 2: c = texture_ctx<C, 2>(m.a[2]); break;
    case 3: c = texture_ctx<C, 3>(m.a[3]); break;
    default: c = texture_ctx<C, 4>(m.a[4]); break;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if (shared_roles<C>(m.a[0], c, warp)) return;
  switch (mode) {
    case 0: material_roles<C, 0>(m.a[0], c, warp); break;
    case 1: material_roles<C, 1>(m.a[1], c, warp); break;
    case 2: material_roles<C, 2>(m.a[2], c, warp); break;
    case 3: material_roles<C, 3>(m.a[3], c, warp); break;
    default: material_roles<C, 4>(m.a[4], c, warp); break;
  }
}

// The dynamic shared memory of a launch holding the materials of `mask`:
// the largest that one of them needs.
inline size_t mixed_smem(int mask, int N) {
  const size_t b[5] = {layout<0>(N).bytes, layout<1>(N).bytes,
                       layout<2>(N).bytes, layout<3>(N).bytes,
                       layout<4>(N).bytes};
  size_t smem = 0;
  for (int m = 0; m < 5; ++m)
    if ((mask >> m) & 1) smem = b[m] > smem ? b[m] : smem;
  return smem;
}

template <typename K>
int prepare(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

template <int C, int MODE>
int launch(const Args& a, cudaStream_t s) {
  const size_t smem = layout<MODE>(a.N).bytes;
  const int err = prepare(texture_stage_kernel<C, MODE>, smem);
  if (err != 0) return err;
  const int blocks = (a.B + kClips - 1) / kClips;
  texture_stage_kernel<C, MODE><<<blocks, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_mixed(const MixedArgs& m, cudaStream_t s) {
  const size_t smem = mixed_smem(m.mask, m.a[0].N);
  const int err = prepare(texture_stage_mixed<C>, smem);
  if (err != 0) return err;
  const int blocks = (m.a[0].B + kClips - 1) / kClips;
  texture_stage_mixed<C><<<blocks, kThreads, smem, s>>>(m);
  return static_cast<int>(cudaGetLastError());
}

// clips and warps per CTA, threads, shared memory bytes, resident CTAs per
// SM, registers and local (spill) bytes per thread, chunk samples
template <typename K>
int geometry(K kernel, size_t smem, int* g) {
  int err = prepare(kernel, smem);
  cudaFuncAttributes attr;
  if (err == 0) err = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
  int ctas = 0;
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, kernel, kThreads, smem));
  if (err != 0) return err;
  const int v[8] = {kClips, kWarps, kThreads, static_cast<int>(smem), ctas,
                    attr.numRegs, static_cast<int>(attr.localSizeBytes),
                    kChunk};
  for (int i = 0; i < 8; ++i) g[i] = v[i];
  return 0;
}

template <int C>
int launch_mode(int mode, const Args& a, cudaStream_t s) {
  switch (mode) {
    case 0: return launch<C, 0>(a, s);
    case 1: return launch<C, 1>(a, s);
    case 2: return launch<C, 2>(a, s);
    case 3: return launch<C, 3>(a, s);
    case 4: return launch<C, 4>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int C>
int geometry_mode(int mode, int N, int* g) {
  switch (mode) {
    case 0: return geometry(texture_stage_kernel<C, 0>, layout<0>(N).bytes, g);
    case 1: return geometry(texture_stage_kernel<C, 1>, layout<1>(N).bytes, g);
    case 2: return geometry(texture_stage_kernel<C, 2>, layout<2>(N).bytes, g);
    case 3: return geometry(texture_stage_kernel<C, 3>, layout<3>(N).bytes, g);
    case 4: return geometry(texture_stage_kernel<C, 4>, layout<4>(N).bytes, g);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace texture_stage
}  // namespace juicy

#define JUICY_TEXTURE_PARAMS                                                  \
  const float *x, const float *dsp_in, const float *mat_in,                  \
      const unsigned *rng_in, const int *widx_in, const float *lane_in,      \
      float *ring, float *out, float *dsp_out, float *mat_out,               \
      unsigned *rng_out, int *widx_out, float *pre_fin, float *pre_acc,      \
      float *post_fin, float *post_acc, int B, int C, int N, int L

namespace {
constexpr int kLane = sizeof(juicy::LaneConsts) / sizeof(float);
constexpr int kTex = sizeof(juicy::TexConsts) / sizeof(float);

// The launch's Args with one material's constants (n_consts floats: the
// lane's, then the texture's), checked; false when one is out of range.
bool texture_args(juicy::texture_stage::Args& a, bool wave,
                  JUICY_TEXTURE_PARAMS, unsigned jump_a, unsigned jump_b,
                  const float* consts, int n_consts) {
  if (n_consts < kLane + 16 || n_consts > kLane + kTex || B <= 0 || N <= 0 ||
      (wave && (ring == nullptr || L < juicy::pipe::kChunk)))
    return false;
  a = juicy::texture_stage::Args{
      x,       dsp_in,  mat_in,  rng_in,   widx_in,  lane_in,
      ring,    out,     dsp_out, mat_out,  rng_out,  widx_out,
      pre_fin, pre_acc, post_fin, post_acc, B,       N,
      L,       jump_a,  jump_b,  {},       {}};
  std::memset(&a.k, 0, sizeof(a.k));
  std::memcpy(&a.lk, consts, sizeof(a.lk));
  std::memcpy(&a.k, consts + kLane, (n_consts - kLane) * sizeof(float));
  return true;
}
}  // namespace

#define JUICY_TEXTURE_ARGS                                                    \
  x, dsp_in, mat_in, rng_in, widx_in, lane_in, ring, out, dsp_out, mat_out,  \
      rng_out, widx_out, pre_fin, pre_acc, post_fin, post_acc, B, C, N, L

extern "C" {

// Launches the kernel for material `mode` on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted). Device pointers are
// laid out as the kernel documents; `ring` may be null for modes 0, 1, 4.
// `consts` is a host array of n_consts floats: the 7 lane constants, the
// 16 common texture constants, then the material's (tex_param_list order).
int juicy_texture_stage(JUICY_TEXTURE_PARAMS, int mode, unsigned jump_a,
                        unsigned jump_b, const float* consts, int n_consts,
                        void* stream) {
  namespace ts = juicy::texture_stage;
  ts::Args a;
  if (!texture_args(a, mode == 2 || mode == 3, JUICY_TEXTURE_ARGS, jump_a,
                    jump_b, consts, n_consts))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1) return ts::launch_mode<1>(mode, a, s);
  if (C == 2) return ts::launch_mode<2>(mode, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The mixed-material launch: `cta_mode` is a device array of one material
// per 32 clips (ceil(B / 32) ints) whose clips share it; `mode_mask` has
// bit m set for each material present; `consts` holds five host rows of
// n_consts floats, row m material m's (rows of absent materials unread).
// mat_in/mat_out hold [NMAT, B, C] with NMAT the largest of the materials
// present, each clip's own material's leaves first.
int juicy_texture_stage_mixed(JUICY_TEXTURE_PARAMS, const int* cta_mode,
                              int mode_mask, unsigned jump_a,
                              unsigned jump_b, const float* consts,
                              int n_consts, void* stream) {
  namespace ts = juicy::texture_stage;
  if (cta_mode == nullptr || mode_mask <= 0 || mode_mask >= 32)
    return static_cast<int>(cudaErrorInvalidValue);
  ts::MixedArgs m{};
  for (int k = 0; k < 5; ++k)
    if (!texture_args(m.a[k], (mode_mask & 0b01100) != 0, JUICY_TEXTURE_ARGS,
                      jump_a, jump_b, consts + k * n_consts, n_consts))
      return static_cast<int>(cudaErrorInvalidValue);
  m.cta_mode = cta_mode;
  m.mask = mode_mask;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 1) return ts::launch_mixed<1>(m, s);
  if (C == 2) return ts::launch_mixed<2>(m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The texture kernel's geometry for material `mode`, C channels and block
// size N into g[8] (juicy::texture_stage::geometry's order); returns a CUDA
// error code.
int juicy_texture_geometry(int mode, int C, int N, int* g) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 1) return juicy::texture_stage::geometry_mode<1>(mode, N, g);
  if (C == 2) return juicy::texture_stage::geometry_mode<2>(mode, N, g);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The mixed kernel's geometry for the materials of `mode_mask`, C channels
// and block size N into g[8]; returns a CUDA error code.
int juicy_texture_mixed_geometry(int mode_mask, int C, int N, int* g) {
  namespace ts = juicy::texture_stage;
  if (N <= 0 || mode_mask <= 0 || mode_mask >= 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ts::mixed_smem(mode_mask, N);
  if (C == 1) return ts::geometry(ts::texture_stage_mixed<1>, smem, g);
  if (C == 2) return ts::geometry(ts::texture_stage_mixed<2>, smem, g);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
