// Chain kernel for Hopper (sm_90a): the whole seven-stage chain (punch ->
// saturator -> texture -> motion -> width -> cohere -> infer) with its 14
// analyzer lanes, for one block of every clip of a stereo batch, in one
// launch, for a texture material fixed per launch (0 gel, 1 metal, 2 wood,
// 3 plastic, 4 flesh).
//
// Replaces the TPU kernel juicy_tpu/kernels/chain_kernel.py::_mono_machinery
// (the _mono_kernel pallas_call = _front_kernel + _back_kernel), which
// chain_kernel_stream and chain_kernel_step launch once per block. Plain
// version beside the wrapper: juicy_tpu_torch/kernels/chain_kernel.py
// ::chain_block_plain (each model's process between a serial pre lane and a
// serial post lane).
//
// What bounds it: every stage is a serial per-sample recurrence, motion's
// pass 2 runs the channels one after the other, and cohere's render needs
// the whole block's band energies first. So one thread carries one clip
// (both channels) through the stages in chain order, one loop over the
// block per stage:
//   P   punch, with punch's pre lane over the input;
//   S   saturator, with punch's post lane and the saturator's pre lane over
//       punch's output (stage i's post lane and stage i+1's pre lane read
//       the same stream, so they share a loop);
//   T   texture (LCG, ring), with the saturator's post and texture's pre;
//   M1  motion pass 1, with texture's post and motion's pre; the block
//       scales; M2 pass 2 on channel 0, then on channel 1;
//   W   width (shrink, M/S, Haas ring), with motion's post and width's pre;
//   C1  cohere's analysis, with width's post and cohere's pre; the learn
//       EMA, context fit and band gains; C2 cohere's render;
//   I   infer's trim, with cohere's post and infer's pre; I2 infer's post.
// At B = 4096 that is 128 warps, launched as 32-thread blocks so that each
// warp gets an SM of its own: latency, not bytes or operations, sets the
// pace (the stage kernels run at 2-4% of their bounds for that reason).
// What the design does about it is what the stage kernels do: audio
// time-major and clip-contiguous ([N, C, B]) so that a warp's loads and
// stores coalesce; each stage's state and constants live in registers for
// its own loop only; the stream between two stages goes through one of two
// ping-pong [N, C, B] scratch buffers in device memory, written and read
// back by the same thread (L1/L2 hits). Fusing stages into shared loops, as
// the TPU kernel's front loop 1 does, is left for later.
//
// State stays in device memory from block to block and is updated in place
// (each thread reads and writes only its own clip's): punch's followers, the
// saturator's tone, texture's state and LCG, the wood/plastic ring [L, C, B]
// with a block-uniform write index passed per launch, motion's mono and
// channel state and LCG, the Haas window as a ring [D, B] with a
// block-uniform write head passed per launch, and cohere's analysis
// filters, targets and tails. Each stage's pre lane starts from that
// analyzer's post lane of the previous block (`lane_prev`), as one analyzer
// instance per plugin does; the 14 lanes are written to `fin` / `acc`.
//
// The constants come from one float array (kernels/chain_kernel.py
// ::chain_constants), read through a clip stride: 0 here (every clip reads
// the same row), a row per clip or per block for later modes.
//
// Numerics: built with -fmad=false and without fast math; every
// transcendental is a precise.cuh polynomial; cohere's ratios stay true
// divisions.
#include <cuda_runtime.h>

#include "cohere.cuh"
#include "lane.cuh"
#include "motion.cuh"
#include "precise.cuh"
#include "punch.cuh"
#include "saturator.cuh"
#include "texture.cuh"
#include "width.cuh"

namespace juicy {

constexpr int kChainThreads = 32;

// offsets into a constant row (kernels/chain_kernel.py::chain_constants)
constexpr int kLaneN = sizeof(LaneConsts) / sizeof(float);
constexpr int kOffPunch = kLaneN;
constexpr int kOffSat = kOffPunch + sizeof(PunchConsts) / sizeof(float);
constexpr int kOffTex = kOffSat + sizeof(SatConsts) / sizeof(float);
constexpr int kOffMotion = kOffTex + sizeof(TexConsts) / sizeof(float);
constexpr int kOffWidth = kOffMotion + sizeof(MotionConsts) / sizeof(float);
constexpr int kOffCohere = kOffWidth + sizeof(WidthConsts) / sizeof(float);
constexpr int kOffTrim = kOffCohere + sizeof(CohereConsts) / sizeof(float);
constexpr int kOffInvN = kOffTrim + 1;
constexpr int kChainConsts = kOffInvN + 1;
static_assert(kChainConsts == 105, "chain_constants layout changed");

struct ChainArgs {
  const float* x;     // [N, 2, B], this block's input
  float* out;         // [N, 2, B], this block's output
  float* s0;          // [N, 2, B] scratch
  float* s1;          // [N, 2, B] scratch
  const float* consts;
  int cstride;        // floats between two clips' constant rows
  float* punch_env;   // [2, B, 2] fast, slow
  float* sat_tone;    // [B, 2]
  float* tex_dsp;     // [9, B, 2]
  float* tex_mat;     // [NMAT, B, 2]
  unsigned* tex_rng;  // [B]
  float* tex_ring;    // [L, 2, B] (wood, plastic)
  float* mot_mono;    // [10, B] models/motion.py::MONO_KEYS
  int* mot_cd;        // [B]
  unsigned* mot_rng;  // [B]
  float* mot_chan;    // [3, B, 2] lp, tail, prev
  float* haas;        // [D, B]
  float* co_mono;     // [5, B] analysis low/high, targets low/mid/high
  float* co_tail;     // [B, 2]
  float* co_fit;      // [B] this block's context fit
  const float* lane_prev;  // [14, 5, B] the previous block's lanes
  float* fin;         // [14, 5, B]
  float* acc;         // [14, 10, B]
  int B, N, L, tex_widx, D, haas_pos;
  unsigned jump_a, jump_b;  // channel 1's LCG start from channel 0's
  int mot_cooldown, narrow;
};

template <typename T>
__device__ __forceinline__ T load_consts(const float* __restrict__ src) {
  T v;
  float* dst = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int j = 0; j < static_cast<int>(sizeof(T) / sizeof(float)); ++j)
    dst[j] = __ldg(src + j);
  return v;
}

// One clip's block through the chain; see the file comment for the loops.
template <int MODE>
__global__ void __launch_bounds__(kChainThreads) chain_kernel(ChainArgs a) {
  constexpr int NMAT = tex_nmat(MODE);
  constexpr bool kWave = MODE == 2 || MODE == 3;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;  // ragged edge of the batch
  const int B = a.B, N = a.N;
  const size_t sB = static_cast<size_t>(B);
  const float* row = a.consts + static_cast<size_t>(b) * a.cstride;
  const LaneConsts lk = load_consts<LaneConsts>(row);
  auto at = [sB, b](int t, int ch) {
    return (static_cast<size_t>(t) * 2 + ch) * sB + b;
  };
  auto seed = [&](int stage) {  // previous block's post lane of `stage`
    return lane_load(a.lane_prev + (2 * stage + 1) * 5 * sB, b, B);
  };
  auto store = [&](const Lane& lane, int slot) {
    lane_store(lane, a.fin + slot * 5 * sB, a.acc + slot * 10 * sB, b, B);
  };

  // ---- P: punch, pre lane 0 over the input -> s0
  Lane pre = seed(0);
  {
    const PunchConsts k = load_consts<PunchConsts>(row + kOffPunch);
    float fast[2], slow[2];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      fast[ch] = a.punch_env[b * 2 + ch];
      slow[ch] = a.punch_env[(sB + b) * 2 + ch];
    }
    for (int t = 0; t < N; ++t) {
      const float l = a.x[at(t, 0)], r = a.x[at(t, 1)];
      lane_step(pre, l, r, lk);
      a.s0[at(t, 0)] = punch_sample(l, fast[0], slow[0], k);
      a.s0[at(t, 1)] = punch_sample(r, fast[1], slow[1], k);
    }
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      a.punch_env[b * 2 + ch] = fast[ch];
      a.punch_env[(sB + b) * 2 + ch] = slow[ch];
    }
  }
  store(pre, 0);
  Lane post = pre;
  lane_reset(post);

  // ---- S: saturator on s0 -> s1; post lane 0 and pre lane 1 over s0
  pre = seed(1);
  {
    const SatConsts k = load_consts<SatConsts>(row + kOffSat);
    float tone[2] = {a.sat_tone[b * 2], a.sat_tone[b * 2 + 1]};
    for (int t = 0; t < N; ++t) {
      const float l = a.s0[at(t, 0)], r = a.s0[at(t, 1)];
      lane_step(post, l, r, lk);
      lane_step(pre, l, r, lk);
      a.s1[at(t, 0)] = sat_sample(l, tone[0], k);
      a.s1[at(t, 1)] = sat_sample(r, tone[1], k);
    }
    a.sat_tone[b * 2] = tone[0];
    a.sat_tone[b * 2 + 1] = tone[1];
  }
  store(post, 1);
  store(pre, 2);
  post = pre;
  lane_reset(post);

  // ---- T: texture on s1 -> s0; post lane 1 and pre lane 2 over s1
  pre = seed(2);
  {
    const TexConsts k = load_consts<TexConsts>(row + kOffTex);
    TexChan s[2];
    float m[2][NMAT];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      float v[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) v[i] = a.tex_dsp[(i * sB + b) * 2 + ch];
      s[ch] = TexChan{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8]};
#pragma unroll
      for (int j = 0; j < NMAT; ++j) m[ch][j] = a.tex_mat[(j * sB + b) * 2 + ch];
    }
    // channel 0 takes draws 1..N, channel 1 draws N+1..2N (cpp:239)
    unsigned rng[2];
    rng[0] = a.tex_rng[b];
    rng[1] = a.jump_a * rng[0] + a.jump_b;
    int widx = a.tex_widx;
    for (int t = 0; t < N; ++t) {
      const float d[2] = {a.s1[at(t, 0)], a.s1[at(t, 1)]};
      lane_step(post, d[0], d[1], lk);
      lane_step(pre, d[0], d[1], lk);
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        rng[ch] = lcg_step(rng[ch]);
        const TexDrive v = tex_front(d[ch], s[ch], k);
        float shaped;
        if constexpr (MODE == 0) {
          shaped = gel_step(m[ch], v, k);
        } else if constexpr (MODE == 1) {
          shaped = metal_step(m[ch], v, s[ch].hp, k);
        } else if constexpr (kWave) {
          const RingTap tap = tex_ring_tap(widx, k.m[12], a.L);
          const float v0 = a.tex_ring[(tap.i0 * static_cast<size_t>(2) + ch) * sB + b];
          const float v1 = a.tex_ring[(tap.i1 * static_cast<size_t>(2) + ch) * sB + b];
          const float delayed = v0 + tap.frac * (v1 - v0);
          float new_wave;
          shaped = wave_step(m[ch], v, delayed, new_wave, k);
          a.tex_ring[(widx * static_cast<size_t>(2) + ch) * sB + b] = new_wave;
        } else {
          shaped = flesh_step(m[ch], v, k);
        }
        a.s0[at(t, ch)] = tex_back(d[ch], shaped, tex_white(rng[ch]), v, s[ch], k);
      }
      if constexpr (kWave) widx = widx + 1 >= a.L ? 0 : widx + 1;
    }
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      const float v[9] = {s[ch].env,  s[ch].lp,      s[ch].hp,
                          s[ch].noise_hp, s[ch].tail, s[ch].wet_env,
                          s[ch].dc_in, s[ch].dc_out, s[ch].pg};
#pragma unroll
      for (int i = 0; i < 9; ++i) a.tex_dsp[(i * sB + b) * 2 + ch] = v[i];
#pragma unroll
      for (int j = 0; j < NMAT; ++j) a.tex_mat[(j * sB + b) * 2 + ch] = m[ch][j];
    }
    a.tex_rng[b] = rng[1];
  }
  store(post, 3);
  store(pre, 4);
  post = pre;
  lane_reset(post);

  // ---- M1, M2: motion on s0 -> s1; post lane 2 and pre lane 3 over s0
  pre = seed(3);
  {
    const MotionConsts k = load_consts<MotionConsts>(row + kOffMotion);
    float mm[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) mm[i] = a.mot_mono[i * sB + b];
    MotionP1 p1{mm[0], a.mot_cd[b], mm[1], a.mot_rng[b], mm[6], mm[7], mm[8]};
    MotionShared sh{mm[3], mm[4], mm[5], mm[9], mm[2]};
    for (int t = 0; t < N; ++t) {
      const float l = a.s0[at(t, 0)], r = a.s0[at(t, 1)];
      lane_step(post, l, r, lk);
      lane_step(pre, l, r, lk);
      motion_p1(p1, fabsf(0.5f * (l + r)), a.mot_cooldown, k);
    }
    float scale, recovery;
    motion_scales(p1.repetition, k, scale, recovery);
    // pass 2 on channel 0, then on channel 1 from the shared state channel
    // 0 left
#pragma unroll 1
    for (int ch = 0; ch < 2; ++ch) {
      MotionChan c{a.mot_chan[b * 2 + ch], a.mot_chan[(sB + b) * 2 + ch],
                   a.mot_chan[(2 * sB + b) * 2 + ch]};
      const float ch_offset = ch == 0 ? 0.0f : 0.85f;
      for (int t = 0; t < N; ++t)
        a.s1[at(t, ch)] = motion_p2(a.s0[at(t, ch)], sh, c, p1, scale,
                                    recovery, ch_offset, a.narrow != 0, k);
      a.mot_chan[b * 2 + ch] = c.lp;
      a.mot_chan[(sB + b) * 2 + ch] = c.tail;
      a.mot_chan[(2 * sB + b) * 2 + ch] = c.prev;
    }
    const float mo[10] = {p1.env,  p1.repetition, sh.budget_env, sh.vt,
                          sh.vtr,  sh.vtl,        p1.vt_t,       p1.vtr_t,
                          p1.vtl_t, sh.phase};
#pragma unroll
    for (int i = 0; i < 10; ++i) a.mot_mono[i * sB + b] = mo[i];
    a.mot_cd[b] = p1.cooldown;
    a.mot_rng[b] = p1.rng;
  }
  store(post, 5);
  store(pre, 6);
  post = pre;
  lane_reset(post);

  // ---- W: width on s1 -> s0; post lane 3 and pre lane 4 over s1
  pre = seed(4);
  {
    const WidthConsts k = load_consts<WidthConsts>(row + kOffWidth);
    const int D = a.D;
    int head = a.haas_pos;                     // write head of the ring
    // `delay` samples behind the head, read after the head's write: exact
    // for 0 <= delay < D (the host checks)
    int tap = head - static_cast<int>(k.delay);
    tap = tap < 0 ? tap + D : tap;
    float w = k.width;                         // the block-local width
    for (int t = 0; t < N; ++t) {
      const float l = a.s1[at(t, 0)], r = a.s1[at(t, 1)];
      lane_step(post, l, r, lk);
      lane_step(pre, l, r, lk);
      w = width_shrink(l, r, w, k);
      float wet_r_pre;
      const float wet_l = width_widen(l, r, w, wet_r_pre);
      a.haas[head * sB + b] = wet_r_pre;
      const float wet_r = a.haas[tap * sB + b];
      a.s0[at(t, 0)] = width_mix(l, wet_l, k);
      a.s0[at(t, 1)] = width_mix(r, wet_r, k);
      head = head + 1 == D ? 0 : head + 1;
      tap = tap + 1 == D ? 0 : tap + 1;
    }
  }
  store(post, 7);
  store(pre, 8);
  post = pre;
  lane_reset(post);

  // ---- C1, C2: cohere on s0 -> s1; post lane 4 and pre lane 5 over s0
  pre = seed(5);
  {
    const CohereConsts k = load_consts<CohereConsts>(row + kOffCohere);
    CohereAnalysis an{a.co_mono[b], a.co_mono[sB + b], 0.0f, 0.0f, 0.0f};
    for (int t = 0; t < N; ++t) {
      const float l = a.s0[at(t, 0)], r = a.s0[at(t, 1)];
      lane_step(post, l, r, lk);
      lane_step(pre, l, r, lk);
      cohere_analyze(an, 0.5f * (l + r), k);
    }
    const float inv_n = __ldg(row + kOffInvN);
    float tgt[3] = {a.co_mono[2 * sB + b], a.co_mono[3 * sB + b],
                    a.co_mono[4 * sB + b]};
    float fit, g[3];
    cohere_block_gains(an.le * inv_n, an.me * inv_n, an.he * inv_n, tgt, fit,
                       g, k);
    a.co_mono[b] = an.lo;
    a.co_mono[sB + b] = an.hi;
#pragma unroll
    for (int j = 0; j < 3; ++j) a.co_mono[(2 + j) * sB + b] = tgt[j];
    a.co_fit[b] = fit;

    const float fb = clamp_to(k.decay, 0.0f, 0.93f);
    const float tail_k = k.tail * 0.35f;
    float lp_a[2] = {0.0f, 0.0f}, lp_b[2] = {0.0f, 0.0f};  // zeroed per block
    float tail[2] = {a.co_tail[b * 2], a.co_tail[b * 2 + 1]};
    for (int t = 0; t < N; ++t) {
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
        a.s1[at(t, ch)] = cohere_render(a.s0[at(t, ch)], lp_a[ch], lp_b[ch],
                                        tail[ch], g, fb, tail_k, k);
    }
    a.co_tail[b * 2] = tail[0];
    a.co_tail[b * 2 + 1] = tail[1];
  }
  store(post, 9);
  store(pre, 10);
  post = pre;
  lane_reset(post);

  // ---- I: infer's trim on s1 -> out; post lane 5 and pre lane 6 over s1
  pre = seed(6);
  {
    const float trim = __ldg(row + kOffTrim);
    for (int t = 0; t < N; ++t) {
      const float l = a.s1[at(t, 0)], r = a.s1[at(t, 1)];
      lane_step(post, l, r, lk);
      lane_step(pre, l, r, lk);
      a.out[at(t, 0)] = l * trim;
      a.out[at(t, 1)] = r * trim;
    }
  }
  store(post, 11);
  store(pre, 12);
  post = pre;
  lane_reset(post);

  // ---- I2: infer's post lane over the output
  for (int t = 0; t < N; ++t) lane_step(post, a.out[at(t, 0)], a.out[at(t, 1)], lk);
  store(post, 13);
}

template <int MODE>
int launch(const ChainArgs& a, cudaStream_t s) {
  const int blocks = (a.B + kChainThreads - 1) / kChainThreads;
  chain_kernel<MODE><<<blocks, kChainThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace juicy

extern "C" {

// Launches the chain kernel for texture material `mode` on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted). Device
// pointers are laid out as juicy::ChainArgs documents; `tex_ring` may be
// null for modes 0, 1, 4. `consts` is a device array of rows of n_consts
// floats (chain_constants order), clip b reading the row at b * cstride.
int juicy_chain_block(const float* x, float* out, float* s0, float* s1,
                      const float* consts, int cstride, int n_consts,
                      float* punch_env, float* sat_tone, float* tex_dsp,
                      float* tex_mat, unsigned* tex_rng, float* tex_ring,
                      float* mot_mono, int* mot_cd, unsigned* mot_rng,
                      float* mot_chan, float* haas, float* co_mono,
                      float* co_tail, float* co_fit, const float* lane_prev,
                      float* fin, float* acc, int B, int N, int mode, int L,
                      int tex_widx, int D, int haas_pos, unsigned jump_a,
                      unsigned jump_b, int mot_cooldown, int narrow,
                      void* stream) {
  const bool wave = mode == 2 || mode == 3;
  if (n_consts != juicy::kChainConsts || cstride < 0 || B <= 0 || N <= 0 ||
      D <= 0 || haas_pos < 0 || haas_pos >= D ||
      (wave && (tex_ring == nullptr || L <= 0 || tex_widx < 0 ||
                tex_widx >= L)))
    return static_cast<int>(cudaErrorInvalidValue);
  const juicy::ChainArgs a{x,        out,      s0,       s1,       consts,
                           cstride,  punch_env, sat_tone, tex_dsp, tex_mat,
                           tex_rng,  tex_ring, mot_mono, mot_cd,   mot_rng,
                           mot_chan, haas,     co_mono,  co_tail,  co_fit,
                           lane_prev, fin,     acc,      B,        N,
                           L,        tex_widx, D,        haas_pos, jump_a,
                           jump_b,   mot_cooldown, narrow};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return juicy::launch<0>(a, s);
    case 1: return juicy::launch<1>(a, s);
    case 2: return juicy::launch<2>(a, s);
    case 3: return juicy::launch<3>(a, s);
    case 4: return juicy::launch<4>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
