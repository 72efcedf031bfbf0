// The JuicinessAnalyzer lane: one analyzer instance advanced one sample at a
// time inside a kernel, for one clip per thread.
//
// Replaces the in-kernel lane of juicy_tpu/kernels/stage_kernels.py
// (_lane_step, _lane_from_ref, _lane_reset, _store_lane). The op order is
// that of _lane_step, which is also the plain version in
// juicy_tpu_torch/kernels/stage_kernels.py. The onset cooldown counts in
// float here, as in the TPU kernel; the host casts it to int32.
#pragma once

#include "precise.cuh"

namespace juicy {

struct LaneConsts {
  float atk_s, rel_s, atk_l, rel_l;   // envelope attack/release coefficients
  float low_c, high_c;                // 250 Hz / 2500 Hz one-pole coefficients
  float cd_samples;                   // onset cooldown (35 ms) in samples
};

struct Lane {
  // carried from block to block
  float s_env, l_env, cooldown, lo, hi;
  // per-block accumulators
  float t_acc, count, lo_acc, hi_acc, rms_acc, peak, side_acc, corr_acc,
      l_acc, r_acc;
};

// fin rows: s_env, l_env, low, high, cooldown ([5, B], row stride B)
__device__ __forceinline__ Lane lane_load(const float* fin, int b, int B) {
  Lane s;
  s.s_env = fin[0 * B + b];
  s.l_env = fin[1 * B + b];
  s.lo = fin[2 * B + b];
  s.hi = fin[3 * B + b];
  s.cooldown = fin[4 * B + b];
  s.t_acc = s.count = s.lo_acc = s.hi_acc = s.rms_acc = s.peak = 0.0f;
  s.side_acc = s.corr_acc = s.l_acc = s.r_acc = 0.0f;
  return s;
}

// Fresh accumulators, carried state kept (pre lane -> post lane).
__device__ __forceinline__ void lane_reset(Lane& s) {
  s.t_acc = s.count = s.lo_acc = s.hi_acc = s.rms_acc = s.peak = 0.0f;
  s.side_acc = s.corr_acc = s.l_acc = s.r_acc = 0.0f;
}

// fin [5, B] as lane_load reads it; acc [10, B]: transient sum, onset count,
// low energy, high energy, rms, peak, side, corr, L^2, R^2.
__device__ __forceinline__ void lane_store(const Lane& s, float* fin,
                                           float* acc, int b, int B) {
  fin[0 * B + b] = s.s_env;
  fin[1 * B + b] = s.l_env;
  fin[2 * B + b] = s.lo;
  fin[3 * B + b] = s.hi;
  fin[4 * B + b] = s.cooldown;
  acc[0 * B + b] = s.t_acc;
  acc[1 * B + b] = s.count;
  acc[2 * B + b] = s.lo_acc;
  acc[3 * B + b] = s.hi_acc;
  acc[4 * B + b] = s.rms_acc;
  acc[5 * B + b] = s.peak;
  acc[6 * B + b] = s.side_acc;
  acc[7 * B + b] = s.corr_acc;
  acc[8 * B + b] = s.l_acc;
  acc[9 * B + b] = s.r_acc;
}

// One analyzer sample (JuicinessAnalyzer.cpp:57-92 plus the stateless
// accumulators). (1 - c) * x + c * env must stay unfused: it feeds the
// onset comparison, where one contracted ulp can flip an onset.
// The envelopes here select the coefficient first; lane_step_envelopes
// below computes both updates and then selects (EnvConsts), the same bits.
// Keep the two in step by hand until lane_step calls the split bodies
// (PERF.md §7).
__device__ __forceinline__ void lane_step(Lane& s, float l, float r,
                                          const LaneConsts& k) {
  const float mono = 0.5f * (l + r);
  const float x = fabsf(mono);
  const float cs = x > s.s_env ? k.atk_s : k.rel_s;
  s.s_env = (1.0f - cs) * x + cs * s.s_env;
  const float cl = x > s.l_env ? k.atk_l : k.rel_l;
  s.l_env = (1.0f - cl) * x + cl * s.l_env;
  const float transient = max0(s.s_env - s.l_env);
  s.t_acc = s.t_acc + transient;
  s.cooldown = max0(s.cooldown - 1.0f);
  const bool onset = (transient > 0x1.70a3d8p-5f) && (s.cooldown <= 0.0f);
  s.count = s.count + (onset ? 1.0f : 0.0f);
  s.cooldown = onset ? k.cd_samples : s.cooldown;
  s.rms_acc = s.rms_acc + mono * mono;
  s.peak = max_nan(s.peak, x);
  s.lo = s.lo + k.low_c * (mono - s.lo);
  s.hi = s.hi + k.high_c * (mono - s.hi);
  const float high_v = mono - s.hi;
  s.lo_acc = s.lo_acc + s.lo * s.lo;
  s.hi_acc = s.hi_acc + high_v * high_v;
  const float side = 0.5f * (l - r);
  s.side_acc = s.side_acc + side * side;
  s.corr_acc = s.corr_acc + l * r;
  s.l_acc = s.l_acc + l * l;
  s.r_acc = s.r_acc + r * r;
}

// lane_step split in three for the stage kernels (stage_lane.cuh), which
// run the parts on three warps: the envelopes, which give the transient;
// the transient's sum and the onsets (count and cooldown); the energies
// (the band one-poles and their energies, then the six stateless sums:
// rms, peak, side, corr, L^2, R^2). Each variable gets the same operations
// in the same order as in lane_step.
//
// The envelopes part keeps the coefficients in registers (EnvConsts) and
// takes each envelope's update for both coefficients before the compare
// selects one: the recurrence then waits on a multiply, an add and a select
// of two registers. Selecting the coefficient first, from the kernel's
// parameters, put a constant-bank load inside the recurrence (PERF.md §7).
// The selected value is lane_step's operations in its order,
// (1 - c) * x + c * env with 1 - c taken once per coefficient, so it is
// bit-equal.
struct EnvConsts {
  float atk_s, rel_s, atk_l, rel_l;
  float oma_s, omr_s, oma_l, omr_l;  // 1 - each
};

__device__ __forceinline__ EnvConsts env_consts(const LaneConsts& k) {
  return {k.atk_s,        k.rel_s,        k.atk_l,        k.rel_l,
          1.0f - k.atk_s, 1.0f - k.rel_s, 1.0f - k.atk_l, 1.0f - k.rel_l};
}

__device__ __forceinline__ float lane_step_envelopes(Lane& s, float l,
                                                     float r,
                                                     const EnvConsts& e) {
  const float mono = 0.5f * (l + r);
  const float x = fabsf(mono);
  const float s_atk = e.oma_s * x + e.atk_s * s.s_env;
  const float s_rel = e.omr_s * x + e.rel_s * s.s_env;
  s.s_env = x > s.s_env ? s_atk : s_rel;
  const float l_atk = e.oma_l * x + e.atk_l * s.l_env;
  const float l_rel = e.omr_l * x + e.rel_l * s.l_env;
  s.l_env = x > s.l_env ? l_atk : l_rel;
  return max0(s.s_env - s.l_env);
}

__device__ __forceinline__ void lane_step_onsets(Lane& s, float transient,
                                                 const LaneConsts& k) {
  s.t_acc = s.t_acc + transient;
  s.cooldown = max0(s.cooldown - 1.0f);
  const bool onset = (transient > 0x1.70a3d8p-5f) && (s.cooldown <= 0.0f);
  s.count = s.count + (onset ? 1.0f : 0.0f);
  s.cooldown = onset ? k.cd_samples : s.cooldown;
}

__device__ __forceinline__ void lane_step_energy(Lane& s, float l, float r,
                                                 const LaneConsts& k) {
  const float mono = 0.5f * (l + r);
  s.lo = s.lo + k.low_c * (mono - s.lo);
  s.hi = s.hi + k.high_c * (mono - s.hi);
  const float high_v = mono - s.hi;
  s.lo_acc = s.lo_acc + s.lo * s.lo;
  s.hi_acc = s.hi_acc + high_v * high_v;
  s.rms_acc = s.rms_acc + mono * mono;
  s.peak = max_nan(s.peak, fabsf(mono));
  const float side = 0.5f * (l - r);
  s.side_acc = s.side_acc + side * side;
  s.corr_acc = s.corr_acc + l * r;
  s.l_acc = s.l_acc + l * l;
  s.r_acc = s.r_acc + r * r;
}

// lane_store's rows of each part.
__device__ __forceinline__ void lane_store_envelopes(const Lane& s, float* fin,
                                                     int b, int B) {
  fin[0 * B + b] = s.s_env;
  fin[1 * B + b] = s.l_env;
}

__device__ __forceinline__ void lane_store_onsets(const Lane& s, float* fin,
                                                  float* acc, int b, int B) {
  fin[4 * B + b] = s.cooldown;
  acc[0 * B + b] = s.t_acc;
  acc[1 * B + b] = s.count;
}

__device__ __forceinline__ void lane_store_energy(const Lane& s, float* fin,
                                                  float* acc, int b, int B) {
  fin[2 * B + b] = s.lo;
  fin[3 * B + b] = s.hi;
  acc[2 * B + b] = s.lo_acc;
  acc[3 * B + b] = s.hi_acc;
  acc[4 * B + b] = s.rms_acc;
  acc[5 * B + b] = s.peak;
  acc[6 * B + b] = s.side_acc;
  acc[7 * B + b] = s.corr_acc;
  acc[8 * B + b] = s.l_acc;
  acc[9 * B + b] = s.r_acc;
}

}  // namespace juicy
