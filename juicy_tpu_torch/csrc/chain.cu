// Chain kernel for Hopper (sm_90a): the whole seven-stage chain (punch ->
// saturator -> texture -> motion -> width -> cohere -> infer) with its 14
// analyzer lanes, for one block of every clip of a stereo batch, in one
// launch, for a texture material fixed per launch (0 gel, 1 metal, 2 wood,
// 3 plastic, 4 flesh) or, in chain_kernel_mixed, one material per CTA of
// 32 clips (the host sorts a mixed corpus into such runs).
//
// Replaces the TPU kernel juicy_tpu/kernels/chain_kernel.py::_mono_machinery
// (the _mono_kernel pallas_call = _front_kernel + _back_kernel), which
// chain_kernel_stream and chain_kernel_step launch once per block. Plain
// version beside the wrapper: juicy_tpu_torch/kernels/chain_kernel.py
// ::chain_block_plain (each model's process between a serial pre lane and a
// serial post lane).
//
// What bounds it: every stage is a serial per-sample recurrence, so latency
// sets the pace, not bytes or operations. One thread carrying one clip
// through the whole chain would run ~1,440 dependent operations per sample,
// and one-warp blocks of 32 clips would leave the SM's issue slots almost
// empty.
// So each CTA serves 32 clips, one per lane of every warp (loads and stores
// coalesce over the clip axis of [N, 2, B]), and each clip's chain is split
// across twelve warps with their own roles:
//   P0 P1  punch, one channel each;
//   S0 S1  the saturator, one channel each, a chunk behind punch;
//   T0 T1  texture, one channel each (channel 1's LCG jumps ahead of
//          channel 0's; the ring write index is block-uniform); then T1
//          runs motion's pass 2 on channel 1 up to its budget limiter,
//          beside channel 0's pass on M (nothing there but the limiter's
//          envelope passes from channel 0 to channel 1);
//   M      motion pass 1 behind texture, the block scales, pass 2 on channel
//          0, then channel 1's limiter from the envelope channel 0 left;
//          then cohere's render and infer's trim of channel 1;
//   W      width (the Haas ring) and cohere's analysis behind motion's
//          channel 1, the learn EMA, context fit and band gains; then
//          cohere's render and infer's trim of channel 0;
//   A0-A3  the seven analyzers, each a pre lane over its stage's input and
//          then a post lane over its output from the pre lane's end state:
//          A0 runs analyzers 0 and 3, A1 1 and 4, A2 2 and 5, A3 6.
// The DSP warps never run a lane. Every stream between two stages (the
// outputs of P, S, T, M, W and cohere) is kept whole for the block in
// device memory ([3, N, 2, B] in each of the two scratch buffers), because
// a post lane reads it from sample 0 after its pre lane is done. A
// producer writes a chunk of kChunk samples and arrives on that chunk's
// mbarrier (one per stream, channel and chunk, each used once per launch);
// a consumer waits on it and reads the chunk with cp.async into its own
// double buffer in shared memory, prefetching the next chunk when it is
// ready, so no sample waits on a load. Each lane copies and reads only its
// own clip's column. The Haas ring and wood's and plastic's waveguide ring
// are read the same way: the taps that fall before a chunk are fetched at
// its start, the ones inside it come from the chunk's own history in
// shared memory.
//
// Geometry: 12 warps (384 threads) per CTA; 107,408 bytes of shared memory
// at N = 512; __launch_bounds__(384, 2) so that two CTAs share an SM and B =
// 8192 (256 CTAs) runs in one wave on 132 SMs. The sample loops are not
// unrolled: unrolled by 2, 4 or 8, all of them or only the light ones, the
// kernel measured no faster on the H100 (PERF.md). Threads past B run every
// role on their batch's last clip and store nothing: every lane arrives on
// every barrier.
//
// State stays in device memory from block to block and is updated in place:
// punch's followers, the saturator's tone, texture's state and LCG, the
// wood/plastic ring [L, C, B] with a block-uniform write index passed per
// launch, motion's mono and channel state and LCG, the Haas window as a
// ring [D, B] with a block-uniform write head passed per launch, and
// cohere's analysis filters, targets and tails. Each warp reads and writes
// only its own channel's or role's state. Each analyzer's pre lane starts
// from its post lane of the previous block (`lane_prev`); the 14 lanes are
// written to `fin` / `acc`.
//
// The constants come from one float array (kernels/chain_kernel.py
// ::chain_constants), read through a clip stride: 0 (every clip reads the
// same row) or a row per clip; each CTA copies its clips' rows to shared
// memory.
//
// Numerics: each recurrence and each sum stays on one thread in the plain
// version's order. Built with -fmad=false and without fast math; every
// transcendental is a precise.cuh polynomial; cohere's ratios stay true
// divisions.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cohere.cuh"
#include "lane.cuh"
#include "motion.cuh"
#include "precise.cuh"
#include "punch.cuh"
#include "saturator.cuh"
#include "texture.cuh"
#include "width.cuh"

namespace juicy {

constexpr int kClips = 32;   // clips per CTA: one per lane of every warp
constexpr int kChunk = 16;   // samples per handoff chunk

enum : int {
  kWarpP0, kWarpP1, kWarpS0, kWarpS1, kWarpT0, kWarpT1,  // one channel each
  kWarpM, kWarpW,                                        // both channels
  kWarpA0, kWarpA1, kWarpA2, kWarpA3,                    // analyzer lanes
  kWarps
};
constexpr int kThreads = kWarps * 32;

// Barrier sets of nc chunks each: punch, saturator and texture per channel,
// motion (channel 1's limiter, which completes a chunk), width, cohere's
// render per channel (its output and infer's), channel 1's wet motion
// signal; then single barriers: motion's targets and scales, the gains.
enum : int {
  kBarP = 0, kBarS = 2, kBarT = 4, kBarM = 6, kBarW = 7, kBarC = 8,
  kBarWet = 10, kBarSets = 11
};
enum : int { kScalesReady = 0, kGainsReady = 1, kSingles = 2 };

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
  const float* __restrict__ x;  // [N, 2, B], this block's input
  float* __restrict__ out;      // [N, 2, B], this block's output
  float* __restrict__ s0;       // [3, N, 2, B]: punch's, texture's, width's output
  float* __restrict__ s1;       // [3, N, 2, B]: the saturator's, motion's, cohere's
  const float* __restrict__ consts;
  int cstride;                  // floats between two clips' constant rows
  float* __restrict__ punch_env;   // [2, B, 2] fast, slow
  float* __restrict__ sat_tone;    // [B, 2]
  float* __restrict__ tex_dsp;     // [9, B, 2]
  float* __restrict__ tex_mat;     // [NMAT, B, 2]
  unsigned* __restrict__ tex_rng;  // [B]
  float* __restrict__ tex_ring;    // [L, 2, B] (wood, plastic)
  float* __restrict__ mot_mono;    // [10, B] models/motion.py::MONO_KEYS
  int* __restrict__ mot_cd;        // [B]
  unsigned* __restrict__ mot_rng;  // [B]
  float* __restrict__ mot_chan;    // [3, B, 2] lp, tail, prev
  float* __restrict__ haas;        // [D, B]
  float* __restrict__ co_mono;     // [5, B] analysis low/high, targets
  float* __restrict__ co_tail;     // [B, 2]
  float* __restrict__ co_fit;      // [B] this block's context fit
  const float* __restrict__ lane_prev;  // [14, 5, B] the previous block's
  float* __restrict__ fin;         // [14, 5, B]
  float* __restrict__ acc;         // [14, 10, B]
  int B, N, L, tex_widx, D, haas_pos;
  unsigned jump_a, jump_b;  // channel 1's LCG start from channel 0's
  int mot_cooldown, narrow;
};

// Values handed from one warp to another, one row of 32 each: the band
// gains (W to M), motion's three targets, scale and recovery (M to T1).
constexpr int kXferRows = 8;

// ---- shared memory: barriers, the clips' constant rows, the handed values,
// then each warp's rows (one float per lane each): its double buffer of
// input chunks and, for texture and width, a ring's taps and the chunk's
// history.
__host__ __device__ constexpr int stage_rows(int w) {
  return (w < kWarpM ? 1 : 2) * 2 * kChunk;
}
__host__ __device__ constexpr int aux_rows(int w) {
  return (w == kWarpT0 || w == kWarpT1) ? 3 * kChunk
                                        : w == kWarpW ? 2 * kChunk : 0;
}
__host__ __device__ constexpr int rows_before(int w) {
  int r = 0;
  for (int i = 0; i < w; ++i) r += stage_rows(i) + aux_rows(i);
  return r;
}

struct Layout {
  int nc;                             // chunks per block
  size_t consts, xfer, rows, bytes;  // byte offsets; bars at 0
};

__host__ __device__ inline Layout layout(int N) {
  Layout l;
  l.nc = (N + kChunk - 1) / kChunk;
  l.consts = sizeof(uint64_t) * (kBarSets * l.nc + kSingles);
  l.xfer = l.consts + sizeof(float) * kClips * kChainConsts;
  l.rows = l.xfer + sizeof(float) * kXferRows * kClips;
  l.bytes = l.rows + sizeof(float) * 32 * rows_before(kWarps);
  return l;
}

// ---- PTX: mbarriers (one arrival per lane of the producing warp, phase 0
// only) and 4-byte cp.async
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}" ::"r"(smem_u32(bar))
      : "memory");
}
// Has phase 0 completed? (non-blocking; acquire when it has)
__device__ __forceinline__ bool mbar_test(const uint64_t* bar) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], 0;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(smem_u32(bar))
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void mbar_wait(const uint64_t* bar) {
  uint32_t ok;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(smem_u32(bar))
        : "memory");
  } while (!ok);
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(K) : "memory");
}

// A stage's constants as a reference into the clip's row in shared memory:
// the roles with the most state (texture, motion) read them there at each
// use (see sample_fence) instead of holding them in registers.
template <typename T>
__device__ __forceinline__ const T& row_ref(const float* src) {
  return *reinterpret_cast<const T*>(src);
}

// At the top of a sample: the compiler may not carry a value loaded from
// memory across it, so the constants read through row_ref are loaded where
// they are used and hold no register across the loop.
__device__ __forceinline__ void sample_fence() {
  asm volatile("" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T row_consts(const float* src) {
  T v;
  float* dst = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int j = 0; j < static_cast<int>(sizeof(T) / sizeof(float)); ++j)
    dst[j] = src[j];
  return v;
}

// What every role knows of its lane.
struct Ctx {
  int b, bl, B, N, nc;  // the clip, the clip clamped into the batch
  bool live;            // b < B: only live lanes store
  size_t sB, nb;        // B, and one stream's floats (N * 2 * B)
  const float* row;     // the clip's constant row in shared memory
  float* rows;          // the warp's rows in shared memory, at this lane
  uint64_t* bars;
  float* gains;         // [3][32] in shared memory, at this lane
  float* mot;           // [5][32] in shared memory, at this lane

  __device__ uint64_t* bar(int set, int j) const { return bars + set * nc + j; }
  __device__ uint64_t* single(int k) const { return bars + kBarSets * nc + k; }
  __device__ size_t at(int t, int ch) const {
    return (static_cast<size_t>(t) * 2 + ch) * sB;
  }
  __device__ int chunk_len(int j) const { return min(kChunk, N - j * kChunk); }
};

// A warp's reader of NCH channels of streams [N, 2, B], chunk by chunk: it waits on the chunk's barriers (none for a stream that is
// ready), copies the chunk into one half of its double buffer with
// cp.async, and starts on the next chunk at once if every lane sees it
// ready. Each lane copies and reads its own clip's column only.
template <int NCH>
struct Reader {
  const float* src[NCH];          // each channel at this lane's clip
  const uint64_t* full[NCH];      // barrier sets by channel, or null
  float* stage;                   // 2 * kChunk * NCH rows at this lane
  int issued;

  __device__ bool ready(int j) const {
    bool ok = true;
#pragma unroll
    for (int k = 0; k < NCH; ++k)
      if (full[k] != nullptr) ok = ok && mbar_test(full[k] + j);
    return ok;
  }
  __device__ void issue(const Ctx& c, int j) {
    float* dst = stage + (j & 1) * (kChunk * NCH * 32);
    const int t0 = j * kChunk, n = c.chunk_len(j);
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int k = 0; k < NCH; ++k)
        cp_async4(dst + (i * NCH + k) * 32,
                  src[k] + static_cast<size_t>(t0 + i) * 2 * c.sB);
    cp_commit();
    issued = j;
  }
  // Chunk j in shared memory (value of channel k at sample i: [(i * NCH +
  // k) * 32]); chunk j + 1 on its way if it is ready. Copy groups that the
  // caller committed before this call are complete too.
  __device__ const float* begin(const Ctx& c, int j) {
    if (issued < j) {
#pragma unroll
      for (int k = 0; k < NCH; ++k)
        if (full[k] != nullptr) mbar_wait(full[k] + j);
      issue(c, j);
    }
    if (j + 1 < c.nc && __all_sync(0xffffffffu, ready(j + 1))) issue(c, j + 1);
    if (issued > j)
      cp_wait<1>();
    else
      cp_wait<0>();
    return stage + (j & 1) * (kChunk * NCH * 32);
  }
};

// Channel ch0 (and ch0 + 1 when NCH is 2) of `stream`.
template <int NCH>
__device__ __forceinline__ Reader<NCH> reader(const float* stream,
                                              const Ctx& c, int ch0,
                                              const uint64_t* f0,
                                              const uint64_t* f1 = nullptr) {
  Reader<NCH> r;
#pragma unroll
  for (int k = 0; k < NCH; ++k) r.src[k] = stream + (ch0 + k) * c.sB + c.bl;
  r.full[0] = f0;
  if constexpr (NCH == 2) r.full[1] = f1;
  r.stage = c.rows;
  r.issued = -1;
  return r;
}

// Channel ch0 of stream s0 beside channel ch1 of stream s1.
__device__ __forceinline__ Reader<2> reader_pair(const Ctx& c,
                                                 const float* s0, int ch0,
                                                 const uint64_t* f0,
                                                 const float* s1, int ch1,
                                                 const uint64_t* f1) {
  Reader<2> r = reader<2>(s0, c, ch0, f0, f1);
  r.src[1] = s1 + ch1 * c.sB + c.bl;
  return r;
}

// ---- P and S: one channel of punch or the saturator
__device__ __forceinline__ void run_punch(const ChainArgs& a, const Ctx& c, int ch) {
  const PunchConsts k = row_consts<PunchConsts>(c.row + kOffPunch);
  float fast = a.punch_env[c.bl * 2 + ch];
  float slow = a.punch_env[(c.sB + c.bl) * 2 + ch];
  Reader<1> in = reader<1>(a.x, c, ch, nullptr);
  float* __restrict__ y = a.s0 + c.b;
  for (int j = 0; j < c.nc; ++j) {
    const float* v = in.begin(c, j);
    const int t0 = j * kChunk, n = c.chunk_len(j);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const float o = punch_sample(v[i * 32], fast, slow, k);
      if (c.live) y[c.at(t0 + i, ch)] = o;
    }
    mbar_arrive(c.bar(kBarP + ch, j));
  }
  if (c.live) {
    a.punch_env[c.b * 2 + ch] = fast;
    a.punch_env[(c.sB + c.b) * 2 + ch] = slow;
  }
}

__device__ __forceinline__ void run_saturator(const ChainArgs& a, const Ctx& c, int ch) {
  const SatConsts k = row_consts<SatConsts>(c.row + kOffSat);
  float tone = a.sat_tone[c.bl * 2 + ch];
  Reader<1> in = reader<1>(a.s0, c, ch, c.bar(kBarP + ch, 0));
  float* __restrict__ y = a.s1 + c.b;
  for (int j = 0; j < c.nc; ++j) {
    const float* v = in.begin(c, j);
    const int t0 = j * kChunk, n = c.chunk_len(j);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const float o = sat_sample(v[i * 32], tone, k);
      if (c.live) y[c.at(t0 + i, ch)] = o;
    }
    mbar_arrive(c.bar(kBarS + ch, j));
  }
  if (c.live) a.sat_tone[c.b * 2 + ch] = tone;
}

// How far ring position q lies after w0 (the chunk's first write index).
__device__ __forceinline__ int ring_rel(int q, int w0, int L) {
  const int d = q - w0;
  return d < 0 ? d + L : d;
}

// ---- T: one channel of texture. Channel 0 takes draws 1..N, channel 1
// draws N+1..2N (cpp:239): its LCG starts at jump_a * rng0 + jump_b, and
// only it writes the LCG back.
template <int MODE>
__device__ __forceinline__ void run_texture(const ChainArgs& a, const Ctx& c, int ch,
                            unsigned rng0) {
  constexpr int NMAT = tex_nmat(MODE);
  constexpr bool kWave = MODE == 2 || MODE == 3;
  const TexConsts& k = row_ref<TexConsts>(c.row + kOffTex);
  float v9[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) v9[i] = a.tex_dsp[(i * c.sB + c.bl) * 2 + ch];
  TexChan s{v9[0], v9[1], v9[2], v9[3], v9[4], v9[5], v9[6], v9[7], v9[8]};
  float m[NMAT];
#pragma unroll
  for (int j = 0; j < NMAT; ++j) m[j] = a.tex_mat[(j * c.sB + c.bl) * 2 + ch];
  unsigned rng = ch == 0 ? rng0 : a.jump_a * rng0 + a.jump_b;
  const int L = a.L;
  int widx = a.tex_widx;
  // wave modes: the chunk's taps from before it, then its own writes
  float* pre = c.rows + stage_rows(kWarpT0) * 32;  // 2 * kChunk rows
  float* hist = pre + 2 * kChunk * 32;             // kChunk rows
  const float* ring = kWave ? a.tex_ring + ch * c.sB + c.bl : nullptr;
  Reader<1> in = reader<1>(a.s1, c, ch, c.bar(kBarS + ch, 0));
  float* __restrict__ y = a.s0 + c.nb + c.b;
  for (int j = 0; j < c.nc; ++j) {
    const int t0 = j * kChunk, n = c.chunk_len(j);
    const int w0 = widx;
    if constexpr (kWave) {
      int w = w0;
      for (int i = 0; i < n; ++i) {
        sample_fence();
        const RingTap tap = tex_ring_tap(w, k.m[12], L);
        if (ring_rel(tap.i0, w0, L) >= i)
          cp_async4(pre + (2 * i) * 32, ring + tap.i0 * 2 * c.sB);
        if (ring_rel(tap.i1, w0, L) >= i)
          cp_async4(pre + (2 * i + 1) * 32, ring + tap.i1 * 2 * c.sB);
        w = w + 1 >= L ? 0 : w + 1;
      }
      cp_commit();
    }
    const float* v = in.begin(c, j);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      sample_fence();
      const float d = v[i * 32];
      rng = lcg_step(rng);
      const TexDrive dv = tex_front(d, s, k);
      float shaped;
      if constexpr (MODE == 0) {
        shaped = gel_step(m, dv, k);
      } else if constexpr (MODE == 1) {
        shaped = metal_step(m, dv, s.hp, k);
      } else if constexpr (kWave) {
        const RingTap tap = tex_ring_tap(widx, k.m[12], L);
        const int r0 = ring_rel(tap.i0, w0, L), r1 = ring_rel(tap.i1, w0, L);
        const float v0 = r0 < i ? hist[r0 * 32] : pre[(2 * i) * 32];
        const float v1 = r1 < i ? hist[r1 * 32] : pre[(2 * i + 1) * 32];
        const float delayed = v0 + tap.frac * (v1 - v0);
        float new_wave;
        shaped = wave_step(m, dv, delayed, new_wave, k);
        hist[i * 32] = new_wave;
        if (c.live)
          a.tex_ring[(widx * static_cast<size_t>(2) + ch) * c.sB + c.b] =
              new_wave;
        widx = widx + 1 >= L ? 0 : widx + 1;
      } else {
        shaped = flesh_step(m, dv, k);
      }
      const float o = tex_back(d, shaped, tex_white(rng), dv, s, k);
      if (c.live) y[c.at(t0 + i, ch)] = o;
    }
    mbar_arrive(c.bar(kBarT + ch, j));
  }
  if (c.live) {
    const float w9[9] = {s.env,  s.lp,     s.hp,    s.noise_hp, s.tail,
                         s.wet_env, s.dc_in, s.dc_out, s.pg};
#pragma unroll
    for (int i = 0; i < 9; ++i) a.tex_dsp[(i * c.sB + c.b) * 2 + ch] = w9[i];
#pragma unroll
    for (int j = 0; j < NMAT; ++j) a.tex_mat[(j * c.sB + c.b) * 2 + ch] = m[j];
    if (ch == 1) a.tex_rng[c.b] = rng;
  }
}

// ---- cohere's render and infer's trim of one channel, after the gains
__device__ __forceinline__ void run_render(const ChainArgs& a, const Ctx& c, int ch,
                           const float* g) {
  const CohereConsts k = row_consts<CohereConsts>(c.row + kOffCohere);
  const float trim = c.row[kOffTrim];
  const float fb = clamp_to(k.decay, 0.0f, 0.93f);
  const float tail_k = k.tail * 0.35f;
  float lp_a = 0.0f, lp_b = 0.0f;  // zeroed per block
  float tail = a.co_tail[c.bl * 2 + ch];
  Reader<1> in = reader<1>(a.s0 + 2 * c.nb, c, ch, nullptr);
  float* __restrict__ y = a.s1 + 2 * c.nb + c.b;
  float* __restrict__ o = a.out + c.b;
  for (int j = 0; j < c.nc; ++j) {
    const float* v = in.begin(c, j);
    const int t0 = j * kChunk, n = c.chunk_len(j);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const float r = cohere_render(v[i * 32], lp_a, lp_b, tail, g, fb,
                                    tail_k, k);
      if (c.live) {
        y[c.at(t0 + i, ch)] = r;
        o[c.at(t0 + i, ch)] = r * trim;
      }
    }
    mbar_arrive(c.bar(kBarC + ch, j));
  }
  if (c.live) a.co_tail[c.b * 2 + ch] = tail;
}

// ---- M: motion, then the render of channel 1. Pass 2 of channel 1 is
// split: up to its budget limiter it needs only the slewed targets, its own
// channel state and texture's output, so T1 runs that part (run_motion_wet)
// beside channel 0's pass here; the limiter, whose envelope channel 1 takes
// from channel 0's end, runs here after it.
__device__ __forceinline__ void run_motion(const ChainArgs& a, const Ctx& c) {
  const MotionConsts& k = row_ref<MotionConsts>(c.row + kOffMotion);
  float mm[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) mm[i] = a.mot_mono[i * c.sB + c.bl];
  MotionP1 p1{mm[0], a.mot_cd[c.bl], mm[1], a.mot_rng[c.bl], mm[6], mm[7],
              mm[8]};
  MotionShared sh{mm[3], mm[4], mm[5], mm[9], mm[2]};
  const float* tex = a.s0 + c.nb;
  {
    Reader<2> in = reader<2>(tex, c, 0, c.bar(kBarT, 0), c.bar(kBarT + 1, 0));
    for (int j = 0; j < c.nc; ++j) {
      const float* v = in.begin(c, j);
      const int n = c.chunk_len(j);
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        sample_fence();
        motion_p1(p1, fabsf(0.5f * (v[(2 * i) * 32] + v[(2 * i + 1) * 32])),
                  a.mot_cooldown, k);
      }
    }
  }
  float scale, recovery;
  motion_scales(p1.repetition, k, scale, recovery);
  const float mot[5] = {p1.vt_t, p1.vtr_t, p1.vtl_t, scale, recovery};
#pragma unroll
  for (int i = 0; i < 5; ++i) c.mot[i * 32] = mot[i];
  mbar_arrive(c.single(kScalesReady));
  // pass 2 on channel 0; texture's output is all here by now
  float* __restrict__ y = a.s1 + c.nb + c.b;
  {
    MotionChan mc{a.mot_chan[c.bl * 2], a.mot_chan[(c.sB + c.bl) * 2],
                  a.mot_chan[(2 * c.sB + c.bl) * 2]};
    Reader<1> in = reader<1>(tex, c, 0, nullptr);
    for (int j = 0; j < c.nc; ++j) {
      const float* v = in.begin(c, j);
      const int t0 = j * kChunk, n = c.chunk_len(j);
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        sample_fence();
        const float o = motion_p2(v[i * 32], sh, mc, p1, scale, recovery,
                                  0.0f, a.narrow != 0, k);
        if (c.live) y[c.at(t0 + i, 0)] = o;
      }
    }
    if (c.live) {
      a.mot_chan[c.b * 2] = mc.lp;
      a.mot_chan[(c.sB + c.b) * 2] = mc.tail;
      a.mot_chan[(2 * c.sB + c.b) * 2] = mc.prev;
    }
  }
  // channel 1's limiter on its wet signal, from channel 0's envelope
  {
    Reader<2> in = reader_pair(c, tex, 1, nullptr, a.s1 + c.nb, 1,
                               c.bar(kBarWet, 0));
    for (int j = 0; j < c.nc; ++j) {
      const float* v = in.begin(c, j);
      const int t0 = j * kChunk, n = c.chunk_len(j);
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        sample_fence();
        const float o = motion_p2_limit(v[(2 * i) * 32], v[(2 * i + 1) * 32],
                                        sh.budget_env, k);
        if (c.live) y[c.at(t0 + i, 1)] = o;
      }
      mbar_arrive(c.bar(kBarM, j));
    }
  }
  if (c.live) {  // slew, phase and channel 1's state: run_motion_wet's
    const float mo[6] = {p1.env, p1.repetition, sh.budget_env,
                         p1.vt_t, p1.vtr_t, p1.vtl_t};
    const int at[6] = {0, 1, 2, 6, 7, 8};
#pragma unroll
    for (int i = 0; i < 6; ++i) a.mot_mono[at[i] * c.sB + c.b] = mo[i];
    a.mot_cd[c.b] = p1.cooldown;
    a.mot_rng[c.b] = p1.rng;
  }
  mbar_wait(c.single(kGainsReady));  // the gains, and width's whole output
  const float g[3] = {c.gains[0], c.gains[32], c.gains[64]};
  run_render(a, c, 1, g);
}

// ---- T1, after texture: channel 1's pass 2 up to its budget limiter,
// written to motion's channel-1 stream for run_motion's limiter. The slew
// and phase that channel 1 starts from are channel 0's end: N steps of
// motion_slew from the block's start.
__device__ __forceinline__ void run_motion_wet(const ChainArgs& a,
                                               const Ctx& c) {
  const MotionConsts& k = row_ref<MotionConsts>(c.row + kOffMotion);
  MotionShared sh{a.mot_mono[3 * c.sB + c.bl], a.mot_mono[4 * c.sB + c.bl],
                  a.mot_mono[5 * c.sB + c.bl], a.mot_mono[9 * c.sB + c.bl],
                  0.0f};
  MotionChan mc{a.mot_chan[c.bl * 2 + 1], a.mot_chan[(c.sB + c.bl) * 2 + 1],
                a.mot_chan[(2 * c.sB + c.bl) * 2 + 1]};
  mbar_wait(c.single(kScalesReady));
  const MotionP1 p1{0.0f, 0, 0.0f, 0u, c.mot[0], c.mot[32], c.mot[64]};
  const float scale = c.mot[96], recovery = c.mot[128];
#pragma unroll 1
  for (int t = 0; t < c.N; ++t) {
    sample_fence();
    motion_slew(sh, p1, k);
  }
  Reader<1> in = reader<1>(a.s0 + c.nb, c, 1, nullptr);  // T1's own output
  float* __restrict__ y = a.s1 + c.nb + c.b;
  for (int j = 0; j < c.nc; ++j) {
    const float* v = in.begin(c, j);
    const int t0 = j * kChunk, n = c.chunk_len(j);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      sample_fence();
      const float w = motion_p2_wet(v[i * 32], sh, mc, p1, scale, recovery,
                                    0.85f, a.narrow != 0, k);
      if (c.live) y[c.at(t0 + i, 1)] = w;
    }
    mbar_arrive(c.bar(kBarWet, j));
  }
  if (c.live) {
    a.mot_chan[c.b * 2 + 1] = mc.lp;
    a.mot_chan[(c.sB + c.b) * 2 + 1] = mc.tail;
    a.mot_chan[(2 * c.sB + c.b) * 2 + 1] = mc.prev;
    const float mo[4] = {sh.vt, sh.vtr, sh.vtl, sh.phase};
    const int at[4] = {3, 4, 5, 9};
#pragma unroll
    for (int i = 0; i < 4; ++i) a.mot_mono[at[i] * c.sB + c.b] = mo[i];
  }
}

// ---- W: width and cohere's analysis, the gains, then the render of
// channel 0
__device__ __forceinline__ void run_width(const ChainArgs& a, const Ctx& c) {
  const WidthConsts k = row_consts<WidthConsts>(c.row + kOffWidth);
  const CohereConsts kc = row_consts<CohereConsts>(c.row + kOffCohere);
  const int D = a.D;
  const int delay = static_cast<int>(k.delay);  // whole samples, < D
  // the wet right channel is read `delay` samples behind the write head,
  // after the head's write: taps before the chunk come from the ring, the
  // others from the chunk's own history
  int head = a.haas_pos;
  int tap = head - delay;
  tap = tap < 0 ? tap + D : tap;
  float* pre = c.rows + stage_rows(kWarpW) * 32;  // kChunk rows
  float* hist = pre + kChunk * 32;                // kChunk rows
  float wv = k.width;                             // the block-local width
  CohereAnalysis an{a.co_mono[c.bl], a.co_mono[c.sB + c.bl], 0.0f, 0.0f, 0.0f};
  Reader<2> in = reader<2>(a.s1 + c.nb, c, 0, c.bar(kBarM, 0), c.bar(kBarM, 0));
  float* __restrict__ y = a.s0 + 2 * c.nb + c.b;
  for (int j = 0; j < c.nc; ++j) {
    const int t0 = j * kChunk, n = c.chunk_len(j);
    {
      const int m = min(n, delay);
      int q = tap;
      for (int i = 0; i < m; ++i) {
        cp_async4(pre + i * 32, a.haas + q * c.sB + c.bl);
        q = q + 1 == D ? 0 : q + 1;
      }
      cp_commit();
    }
    const float* v = in.begin(c, j);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const float l = v[(2 * i) * 32], r = v[(2 * i + 1) * 32];
      wv = width_shrink(l, r, wv, k);
      float wet_r_pre;
      const float wet_l = width_widen(l, r, wv, wet_r_pre);
      hist[i * 32] = wet_r_pre;
      if (c.live) a.haas[head * c.sB + c.b] = wet_r_pre;
      const float wet_r = i >= delay ? hist[(i - delay) * 32] : pre[i * 32];
      const float ol = width_mix(l, wet_l, k), orr = width_mix(r, wet_r, k);
      if (c.live) {
        y[c.at(t0 + i, 0)] = ol;
        y[c.at(t0 + i, 1)] = orr;
      }
      cohere_analyze(an, 0.5f * (ol + orr), kc);
      head = head + 1 == D ? 0 : head + 1;
      tap = tap + 1 == D ? 0 : tap + 1;
    }
    mbar_arrive(c.bar(kBarW, j));
  }
  const float inv_n = c.row[kOffInvN];
  float tgt[3] = {a.co_mono[2 * c.sB + c.bl], a.co_mono[3 * c.sB + c.bl],
                  a.co_mono[4 * c.sB + c.bl]};
  float fit, g[3];
  cohere_block_gains(an.le * inv_n, an.me * inv_n, an.he * inv_n, tgt, fit, g,
                     kc);
  if (c.live) {
    a.co_mono[c.b] = an.lo;
    a.co_mono[c.sB + c.b] = an.hi;
#pragma unroll
    for (int j = 0; j < 3; ++j) a.co_mono[(2 + j) * c.sB + c.b] = tgt[j];
    a.co_fit[c.b] = fit;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) c.gains[j * 32] = g[j];
  mbar_arrive(c.single(kGainsReady));
  run_render(a, c, 0, g);
}

// ---- A: analyzer `an` (of stage `an`): its pre lane over stream an, then
// its post lane over stream an + 1 from the pre lane's end state. Streams:
// 0 the input, 1 punch's output, 2 the saturator's, 3 texture's, 4
// motion's, 5 width's, 6 cohere's, 7 infer's (the block's output).
__device__ __forceinline__ void lane_pass(const ChainArgs& a, const Ctx& c, int stream,
                          Lane& s, const LaneConsts& lk) {
  const float* src;
  const uint64_t *f0 = nullptr, *f1 = nullptr;
  switch (stream) {
    case 0: src = a.x; break;
    case 1: src = a.s0; f0 = c.bar(kBarP, 0); f1 = c.bar(kBarP + 1, 0); break;
    case 2: src = a.s1; f0 = c.bar(kBarS, 0); f1 = c.bar(kBarS + 1, 0); break;
    case 3: src = a.s0 + c.nb; f0 = c.bar(kBarT, 0); f1 = c.bar(kBarT + 1, 0); break;
    case 4: src = a.s1 + c.nb; f0 = f1 = c.bar(kBarM, 0); break;
    case 5: src = a.s0 + 2 * c.nb; f0 = f1 = c.bar(kBarW, 0); break;
    case 6: src = a.s1 + 2 * c.nb; f0 = c.bar(kBarC, 0); f1 = c.bar(kBarC + 1, 0); break;
    default: src = a.out; f0 = c.bar(kBarC, 0); f1 = c.bar(kBarC + 1, 0); break;
  }
  Reader<2> in = reader<2>(src, c, 0, f0, f1);
  for (int j = 0; j < c.nc; ++j) {
    const float* v = in.begin(c, j);
    const int n = c.chunk_len(j);
#pragma unroll 1
    for (int i = 0; i < n; ++i)
      lane_step(s, v[(2 * i) * 32], v[(2 * i + 1) * 32], lk);
  }
}

__device__ __forceinline__ void run_analyzer(const ChainArgs& a, const Ctx& c, int an) {
  const LaneConsts lk = row_consts<LaneConsts>(c.row);
  const size_t sB = c.sB;
  Lane s = lane_load(a.lane_prev + (2 * an + 1) * 5 * sB, c.bl, c.B);
  lane_pass(a, c, an, s, lk);
  if (c.live)
    lane_store(s, a.fin + 2 * an * 5 * sB, a.acc + 2 * an * 10 * sB, c.b, c.B);
  lane_reset(s);
  lane_pass(a, c, an + 1, s, lk);
  if (c.live)
    lane_store(s, a.fin + (2 * an + 1) * 5 * sB, a.acc + (2 * an + 1) * 10 * sB,
               c.b, c.B);
}

// Texture's warp for material MODE, or for MODE < 0 the material `mode`
// read at run time: only these two warps' code differs between materials,
// so two CTAs of different materials on one SM share every other role's
// instructions.
template <int MODE>
__device__ __forceinline__ void run_texture_of(const ChainArgs& a,
                                               const Ctx& c, int ch,
                                               unsigned rng0, int mode) {
  if constexpr (MODE >= 0) {
    run_texture<MODE>(a, c, ch, rng0);
  } else {
    switch (mode) {
      case 0: run_texture<0>(a, c, ch, rng0); break;
      case 1: run_texture<1>(a, c, ch, rng0); break;
      case 2: run_texture<2>(a, c, ch, rng0); break;
      case 3: run_texture<3>(a, c, ch, rng0); break;
      default: run_texture<4>(a, c, ch, rng0); break;
    }
  }
}

// One block of 32 clips through the chain, texture material MODE (or, for
// MODE < 0, `mode`); see the file comment.
template <int MODE>
__device__ __forceinline__ void chain_cta(const ChainArgs& a, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(a.N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b0 = blockIdx.x * kClips;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* rows = reinterpret_cast<float*>(smem + l.consts);
  float* xfer = reinterpret_cast<float*>(smem + l.xfer);
  for (int i = threadIdx.x; i < kBarSets * l.nc + kSingles; i += kThreads)
    mbar_init(bars + i, 32);
  for (int i = threadIdx.x; i < kClips * kChainConsts; i += kThreads) {
    const int clip = min(b0 + i / kChainConsts, a.B - 1);
    rows[i] = a.consts[static_cast<size_t>(clip) * a.cstride +
                       i % kChainConsts];
  }
  Ctx c;
  c.b = b0 + lane;
  c.live = c.b < a.B;
  c.bl = c.live ? c.b : a.B - 1;  // threads past B run on the last clip
  c.B = a.B;
  c.N = a.N;
  c.nc = l.nc;
  c.sB = static_cast<size_t>(a.B);
  c.nb = static_cast<size_t>(a.N) * 2 * c.sB;
  c.row = rows + lane * kChainConsts;
  c.rows = reinterpret_cast<float*>(smem + l.rows) + rows_before(warp) * 32 +
           lane;
  c.bars = bars;
  c.gains = xfer + lane;
  c.mot = xfer + 3 * 32 + lane;
  // texture channel 1 writes the LCG back: both channels read it first
  const unsigned rng0 =
      (warp == kWarpT0 || warp == kWarpT1) ? a.tex_rng[c.bl] : 0u;
  __syncthreads();

  switch (warp) {
    case kWarpP0: case kWarpP1: run_punch(a, c, warp - kWarpP0); break;
    case kWarpS0: case kWarpS1: run_saturator(a, c, warp - kWarpS0); break;
    case kWarpT0: run_texture_of<MODE>(a, c, 0, rng0, mode); break;
    case kWarpT1:
      run_texture_of<MODE>(a, c, 1, rng0, mode);
      run_motion_wet(a, c);
      break;
    case kWarpM: run_motion(a, c); break;
    case kWarpW: run_width(a, c); break;
    case kWarpA0: run_analyzer(a, c, 0); run_analyzer(a, c, 3); break;
    case kWarpA1: run_analyzer(a, c, 1); run_analyzer(a, c, 4); break;
    case kWarpA2: run_analyzer(a, c, 2); run_analyzer(a, c, 5); break;
    default: run_analyzer(a, c, 6); break;
  }
}

// One static material for the whole launch.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    chain_kernel(const __grid_constant__ ChainArgs a) {
  chain_cta<MODE>(a, MODE);
}

// A material per CTA: CTA i runs material cta_mode[i] (its 32 clips share
// it; their constant rows, cstride 105, hold that material's constants).
// The two texture warps switch once, before their loop, into that
// material's run_texture; every other role is the one copy all materials
// share (the layout does not depend on the material). One body per
// material measured 1.6x slower than either material alone when CTAs of
// two materials shared an SM (PERF.md). `mask` has bit m set for each
// material the launch holds.
__global__ void __launch_bounds__(kThreads, 2)
    chain_kernel_mixed(const __grid_constant__ ChainArgs a,
                       const int* __restrict__ cta_mode, int mask) {
  const int mode = cta_mode[blockIdx.x];
  if (mode < 0 || mode > 4 || !((mask >> mode) & 1)) __trap();
  chain_cta<-1>(a, mode);
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

template <int MODE>
int launch(const ChainArgs& a, cudaStream_t s) {
  const size_t smem = layout(a.N).bytes;
  const int err = prepare(chain_kernel<MODE>, smem);
  if (err != 0) return err;
  const int blocks = (a.B + kClips - 1) / kClips;
  chain_kernel<MODE><<<blocks, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_mixed(const ChainArgs& a, const int* cta_mode, int mask,
                        cudaStream_t s) {
  const size_t smem = layout(a.N).bytes;
  const int err = prepare(chain_kernel_mixed, smem);
  if (err != 0) return err;
  const int blocks = (a.B + kClips - 1) / kClips;
  chain_kernel_mixed<<<blocks, kThreads, smem, s>>>(a, cta_mode, mask);
  return static_cast<int>(cudaGetLastError());
}

// clips and warps per CTA, threads, shared memory bytes, resident CTAs per
// SM, registers and local (spill) bytes per thread, chunk samples
template <typename K>
int geometry(K kernel, int N, int* g) {
  const size_t smem = layout(N).bytes;
  int err = prepare(kernel, smem);
  cudaFuncAttributes attr;
  if (err == 0)
    err = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
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

}  // namespace juicy

#define JUICY_CHAIN_PARAMS                                                    \
  const float *x, float *out, float *s0, float *s1, const float *consts,     \
      int cstride, int n_consts, float *punch_env, float *sat_tone,          \
      float *tex_dsp, float *tex_mat, unsigned *tex_rng, float *tex_ring,    \
      float *mot_mono, int *mot_cd, unsigned *mot_rng, float *mot_chan,      \
      float *haas, float *co_mono, float *co_tail, float *co_fit,            \
      const float *lane_prev, float *fin, float *acc, int B, int N
#define JUICY_CHAIN_TAIL                                                      \
  int L, int tex_widx, int D, int haas_pos, unsigned jump_a, unsigned jump_b, \
      int mot_cooldown, int narrow

// The launch's arguments checked (`wave`: a wood or plastic CTA is in it)
// and packed; false when one is out of range.
static bool chain_args(juicy::ChainArgs& a, bool wave, JUICY_CHAIN_PARAMS,
                       JUICY_CHAIN_TAIL) {
  if (n_consts != juicy::kChainConsts || cstride < 0 || B <= 0 || N <= 0 ||
      D <= 0 || haas_pos < 0 || haas_pos >= D ||
      (wave && (tex_ring == nullptr || L < juicy::kChunk || tex_widx < 0 ||
                tex_widx >= L)))
    return false;
  a = juicy::ChainArgs{x,        out,      s0,       s1,       consts,
                       cstride,  punch_env, sat_tone, tex_dsp, tex_mat,
                       tex_rng,  tex_ring, mot_mono, mot_cd,   mot_rng,
                       mot_chan, haas,     co_mono,  co_tail,  co_fit,
                       lane_prev, fin,     acc,      B,        N,
                       L,        tex_widx, D,        haas_pos, jump_a,
                       jump_b,   mot_cooldown, narrow};
  return true;
}
#define JUICY_CHAIN_ARGS                                                      \
  x, out, s0, s1, consts, cstride, n_consts, punch_env, sat_tone, tex_dsp,   \
      tex_mat, tex_rng, tex_ring, mot_mono, mot_cd, mot_rng, mot_chan, haas, \
      co_mono, co_tail, co_fit, lane_prev, fin, acc, B, N, L, tex_widx, D,   \
      haas_pos, jump_a, jump_b, mot_cooldown, narrow

extern "C" {

// Launches the chain kernel for texture material `mode` on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted). Device
// pointers are laid out as juicy::ChainArgs documents (s0 and s1 hold three
// [N, 2, B] streams each); `tex_ring` may be null for modes 0, 1, 4.
// `consts` is a device array of rows of n_consts floats (chain_constants
// order), clip b reading the row at b * cstride.
int juicy_chain_block(JUICY_CHAIN_PARAMS, int mode, JUICY_CHAIN_TAIL,
                      void* stream) {
  juicy::ChainArgs a;
  if (!chain_args(a, mode == 2 || mode == 3, JUICY_CHAIN_ARGS))
    return static_cast<int>(cudaErrorInvalidValue);
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

// The mixed-material launch: `cta_mode` is a device array of one material
// per 32 clips (ceil(B / 32) ints); `mode_mask` has bit m set for each
// material present. Every CTA's clips must share their material, and each
// clip's constant row (cstride 105) holds its material's constants.
int juicy_chain_block_mixed(JUICY_CHAIN_PARAMS, int mode_mask,
                            JUICY_CHAIN_TAIL, const int* cta_mode,
                            void* stream) {
  juicy::ChainArgs a;
  if (cta_mode == nullptr || mode_mask <= 0 || mode_mask >= 32 ||
      !chain_args(a, (mode_mask & 0b01100) != 0, JUICY_CHAIN_ARGS))
    return static_cast<int>(cudaErrorInvalidValue);
  return juicy::launch_mixed(a, cta_mode, mode_mask,
                             static_cast<cudaStream_t>(stream));
}

// The chain kernel's geometry for material `mode` and block size N into
// g[8] (juicy::geometry's order); returns a CUDA error code.
int juicy_chain_geometry(int mode, int N, int* g) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case 0: return juicy::geometry(juicy::chain_kernel<0>, N, g);
    case 1: return juicy::geometry(juicy::chain_kernel<1>, N, g);
    case 2: return juicy::geometry(juicy::chain_kernel<2>, N, g);
    case 3: return juicy::geometry(juicy::chain_kernel<3>, N, g);
    case 4: return juicy::geometry(juicy::chain_kernel<4>, N, g);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The mixed kernel's (a material per CTA) geometry for block size N, as
// juicy_chain_geometry's.
int juicy_chain_mixed_geometry(int N, int* g) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return juicy::geometry(juicy::chain_kernel_mixed, N, g);
}

}  // extern "C"
