// JuicyMotion's per-sample bodies, as __device__ functions that a stage
// kernel or the chain kernel can call: pass 1 (mono onset detection and the
// LCG variation rolls), the block scales, and pass 2 for one channel.
//
// Replaces the in-kernel bodies of juicy_tpu/kernels/stage_kernels.py
// (make_motion_p1_body) and juicy_tpu/models/motion.py (make_p2_step, which
// the TPU kernel calls). The op order is that of
// juicy_tpu_torch/models/motion.py, which is also the plain version's
// (PluginProcessor.cpp:75-142). Every a*b+c must stay two roundings (build
// with -fmad=false): the onset comparator x > env * 1.35 + 0.02 flips on one
// contracted ulp, and an onset moves the LCG for the rest of the clip.
#pragma once

#include "precise.cuh"

namespace juicy {

// The per-block constants, in kernels/stage_kernels.py::motion_param_list
// order: pass 1's, the repetition control, then pass 2's
// (models/motion.py::p2_consts and p2_factors), then the sample rate.
struct MotionConsts {
  float env_c, one_env, micro_var, repeat_ctrl;
  float var_slew, one_slew, motion_inc, lfo_depth, cut_depth, boost_depth,
      lfo_mv, lfo_depth2, tone_depth, trans_mv, trans_depth, tail_feedback,
      tail_mix, budget_coeff, one_budget, budget_target, wet_boost, mix,
      out_gain, sr;
};

// Pass 1's carry: the detector envelope, the cooldown, the repetition
// accumulator, the LCG and the three variation targets.
struct MotionP1 {
  float env;
  int cooldown;
  float repetition;
  unsigned rng;
  float vt_t, vtr_t, vtl_t;
};

// The shared slew/LFO/budget state, which pass 2 threads channel 0 ->
// channel 1, and one channel's own filter state.
struct MotionShared {
  float vt, vtr, vtl, phase, budget_env;
};
struct MotionChan {
  float lp, tail, prev;
};

// ((r >> shift) & 0x7FFF) / 16384 - 1 (cpp:87-92); exact.
__device__ __forceinline__ float motion_draw(unsigned r, int shift) {
  return static_cast<float>(static_cast<int>((r >> shift) & 0x7FFFu)) *
             0x1p-14f -
         1.0f;
}

// One pass-1 sample on x = |0.5 (l + r)| (cpp:75-95): three LCG draws on an
// onset, the cooldown counted in whole samples.
__device__ __forceinline__ void motion_p1(MotionP1& s, float x,
                                          int cooldown_samples,
                                          const MotionConsts& k) {
  s.env = k.env_c * s.env + k.one_env * x;
  s.cooldown = max(s.cooldown - 1, 0);
  const bool onset = (x > s.env * 1.35f + 0.02f) && (s.cooldown <= 0);
  s.cooldown = onset ? cooldown_samples : s.cooldown;
  s.repetition = onset ? s.repetition + 1.0f : s.repetition;
  const unsigned r1 = lcg_step(s.rng);
  const unsigned r2 = lcg_step(r1);
  const unsigned r3 = lcg_step(r2);
  if (onset) {
    s.vt_t = motion_draw(r1, 7) * k.micro_var * 0.9f;
    s.vtr_t = motion_draw(r2, 9) * k.micro_var * 0.8f;
    s.vtl_t = motion_draw(r3, 11) * k.micro_var * 0.8f;
    s.rng = r3;
  }
  s.repetition = s.repetition * 0.997f;
}

// The block's repetition scale and recovery boost (cpp:97-99).
__device__ __forceinline__ void motion_scales(float repetition,
                                              const MotionConsts& k,
                                              float& scale, float& recovery) {
  const float rep_norm = clamp_to(repetition * 0.08f, 0.0f, 1.0f);
  scale = 1.0f - k.repeat_ctrl * rep_norm * 0.65f;
  recovery = 1.0f + k.repeat_ctrl * (1.0f - rep_norm) * 0.25f;
}

// Pass 2's slew of the variation targets and its 4 pi-wrapped LFO phase
// (cpp:101-106): the part of the shared state that no channel's audio moves.
__device__ __forceinline__ void motion_slew(MotionShared& s,
                                            const MotionP1& p1,
                                            const MotionConsts& k) {
  constexpr float kTwoPi = 0x1.921fb6p+2f;
  constexpr float kFourPi = 0x1.921fb6p+3f;
  s.vt = k.var_slew * s.vt + k.one_slew * p1.vt_t;
  s.vtr = k.var_slew * s.vtr + k.one_slew * p1.vtr_t;
  s.vtl = k.var_slew * s.vtl + k.one_slew * p1.vtl_t;
  s.phase = s.phase + k.motion_inc;
  s.phase = s.phase > kTwoPi ? s.phase - kFourPi : s.phase;
}

// Pass 2 of one channel-sample up to the budget limiter (cpp:101-131),
// after motion_slew, in two parts that motion_stage.cu runs on different
// warps. motion_p2_mod is the part no audio moves: the sin32 LFO at
// phase + ch_offset, the cutoff and its one-pole coefficient (`narrow`
// selects its narrow exp; the host decides), the tone factor, the
// transient boost and the tail feedback.
struct MotionMod {
  float lp_c, tone_f, boost, fb;
};

__device__ __forceinline__ MotionMod motion_p2_mod(const MotionShared& s,
                                                   float ch_offset,
                                                   bool narrow,
                                                   const MotionConsts& k) {
  MotionMod m;
  const float lfo = sin32(s.phase + ch_offset);
  const float cutoff = clamp_to(
      900.0f + s.vt * 1100.0f * k.cut_depth + lfo * k.lfo_depth, 120.0f,
      4200.0f);
  m.lp_c = onepole_coeff32(cutoff, k.sr, narrow);
  m.boost =
      1.0f + s.vtr * 1.2f * k.boost_depth + k.lfo_mv * lfo * k.lfo_depth2;
  m.tone_f = 1.0f + s.vt * 0.65f * k.tone_depth;
  m.fb = clamp_to(k.tail_feedback + s.vtl * 0.06f, 0.0f, 0.93f);
  return m;
}

// The part that carries audio: the modulated one-pole LP, the transient
// and the tail feedback of one channel; returns the wet signal.
__device__ __forceinline__ float motion_p2_carry(float d, MotionChan& c,
                                                 const MotionMod& m,
                                                 float scale, float recovery,
                                                 const MotionConsts& k) {
  c.lp = c.lp + m.lp_c * (d - c.lp);
  const float hp = d - c.lp;
  const float transient = d - c.prev;
  c.prev = d;
  const float tone_shift = c.lp * m.tone_f + hp * m.boost +
                           transient * k.trans_mv * k.trans_depth;
  c.tail = tone_shift + c.tail * m.fb;
  return tone_shift * scale * recovery + k.tail_mix * c.tail;
}

// The slew, then both parts. s.budget_env is neither read nor written.
__device__ __forceinline__ float motion_p2_wet(float d, MotionShared& s,
                                               MotionChan& c,
                                               const MotionP1& p1,
                                               float scale, float recovery,
                                               float ch_offset, bool narrow,
                                               const MotionConsts& k) {
  motion_slew(s, p1, k);
  return motion_p2_carry(d, c, motion_p2_mod(s, ch_offset, narrow, k), scale,
                         recovery, k);
}

// The budget limiter, mix and output gain of one pass-2 sample
// (cpp:132-142), the only part that carries state (`budget_env`) from
// channel 0 into channel 1, in two parts that motion_stage.cu runs on
// different warps: the envelope, then the limiter's gain (a division that
// feeds no state), the mix and the output gain.
__device__ __forceinline__ void motion_budget(float wet, float& budget_env,
                                              const MotionConsts& k) {
  budget_env = k.budget_coeff * budget_env + k.one_budget * fabsf(wet);
}

__device__ __forceinline__ float motion_limit_out(float d, float wet,
                                                  float budget_env,
                                                  const MotionConsts& k) {
  const float limiter_gain = budget_env > k.budget_target
                                 ? k.budget_target / (budget_env + 1.0e-5f)
                                 : 1.0f;
  wet = wet * limiter_gain;
  return (d + k.mix * (wet * k.wet_boost - d)) * k.out_gain;
}

__device__ __forceinline__ float motion_p2_limit(float d, float wet,
                                                 float& budget_env,
                                                 const MotionConsts& k) {
  motion_budget(wet, budget_env, k);
  return motion_limit_out(d, wet, budget_env, k);
}

// One pass-2 sample of one channel (cpp:101-142).
__device__ __forceinline__ float motion_p2(float d, MotionShared& s,
                                           MotionChan& c, const MotionP1& p1,
                                           float scale, float recovery,
                                           float ch_offset, bool narrow,
                                           const MotionConsts& k) {
  const float wet =
      motion_p2_wet(d, s, c, p1, scale, recovery, ch_offset, narrow, k);
  return motion_p2_limit(d, wet, s.budget_env, k);
}

}  // namespace juicy
