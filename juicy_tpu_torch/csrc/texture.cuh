// JuicyTexture's per-sample body for one channel of one clip, as __device__
// functions that a stage kernel or the chain kernel can call.
//
// Replaces the in-kernel body of juicy_tpu/kernels/stage_kernels.py
// (make_tex_sample: the shared tex_sample and one material step per mode;
// make_white_at's noise mapping). The op order is that of
// juicy_tpu_torch/models/texture.py::make_sample_step and
// _material_substep, which is also the plain version's (PluginProcessor.cpp
// :107-277). Every a*b+c must stay two roundings: build with -fmad=false.
//
// A sample runs tex_front (envelopes, band split -> the material's drive),
// then the material's step, then tex_back (roughness noise, dynamics, tail,
// auto-gain, mix, DC blocker, limiter). The wave materials read and write
// their ring through the caller, which knows its layout: tex_ring_tap gives
// the interpolated read position, wave_step takes the value read and hands
// back the value to write.
#pragma once

#include "precise.cuh"

namespace juicy {

constexpr int kTexMatConsts = 25;  // the most material constants (wood/plastic)

// The per-block constants: _TEX_COMMON, then the material's in
// kernels/stage_kernels.py::tex_param_list order.
struct TexConsts {
  float tail_shape, texture, mix, out_gain, decay, low_boost, split_low,
      split_high, env_atk, env_rel, wet_atk, wet_rel, dc_r, auto_gain_base,
      in_trim, mat_trim;
  float m[kTexMatConsts];
};

// Material state floats per channel: gel pos/vel; metal y1[4], y2[4];
// wood/plastic y1[4], y2[4], prev_wave; flesh pa, va, pb, vb.
__host__ __device__ constexpr int tex_nmat(int mode) {
  return mode == 0 ? 2 : mode == 1 ? 8 : mode == 4 ? 4 : 9;
}

// One channel's carried state, material aside.
struct TexChan {
  float env, lp, hp, noise_hp, tail, wet_env, dc_in, dc_out, pg;
};

// What the front hands the material step.
struct TexDrive {
  float core, impact, body, trail;
};

// ((rng >> 8) & 0xFFFF) / 32768 - 1 (cpp:240); exact.
__device__ __forceinline__ float tex_white(unsigned r) {
  return static_cast<float>(static_cast<int>((r >> 8) & 0xFFFFu)) * 0x1p-15f -
         1.0f;
}

// Envelopes and band split (cpp:114-133).
__device__ __forceinline__ TexDrive tex_front(float d, TexChan& s,
                                              const TexConsts& k) {
  const float driven = d * k.in_trim;
  const float adry = fabsf(d);
  const float env_c = adry > s.env ? k.env_atk : k.env_rel;
  s.env = env_c * s.env + (1.0f - env_c) * adry;
  TexDrive v;
  v.impact = clamp_to(max0(adry - s.env) * 10.0f, 0.0f, 1.0f);
  v.body = clamp_to(s.env * 3.2f, 0.0f, 1.0f);
  v.trail = clamp_to(1.0f - v.impact, 0.0f, 1.0f) * k.tail_shape;
  s.lp = s.lp + k.split_low * (driven - s.lp);
  s.hp = s.hp + k.split_high * (driven - s.hp);
  const float low = s.lp * k.low_boost;
  const float high = driven - s.hp;
  const float mid = driven - s.lp - high;
  v.core = low + mid + high * (0.9f + k.texture * 1.3f);
  return v;
}

// Roughness noise through the limiter (cpp:239-277); returns the output.
__device__ __forceinline__ float tex_back(float d, float shaped, float w,
                                          const TexDrive& v, TexChan& s,
                                          const TexConsts& k) {
  s.noise_hp = s.noise_hp + 0.08f * (w - s.noise_hp);
  const float rough = w - s.noise_hp;
  shaped = shaped + rough * (0.004f + 0.022f * k.texture) *
                        (0.14f + 0.64f * v.impact);
  const float dynamics =
      1.0f + v.impact * (0.18f + k.texture * 0.12f) + v.body * 0.06f;
  shaped = shaped * dynamics * k.mat_trim;
  const float tail_input =
      clamp_to(shaped, -2.0f, 2.0f) * (0.45f + 0.55f * v.trail);
  s.tail = tail_input + s.tail * k.decay;
  float wet = shaped + s.tail * (0.30f + 0.45f * v.trail);
  const float wet_abs = fabsf(wet);
  const float wet_c = wet_abs > s.wet_env ? k.wet_atk : k.wet_rel;
  s.wet_env = wet_c * s.wet_env + (1.0f - wet_c) * wet_abs;
  const float auto_comp = k.auto_gain_base / (1.0f + 1.8f * s.wet_env);
  wet = wet * clamp_to(auto_comp, 0.18f, 1.0f);
  const float mixed = d + k.mix * (wet - d);
  const float pre_dc = mixed * k.out_gain;
  const float dc = pre_dc - s.dc_in + k.dc_r * s.dc_out;
  s.dc_in = pre_dc;
  s.dc_out = dc;
  const float peak = fabsf(dc);
  s.pg = peak > 0.88f ? min_nan(s.pg, (0.88f / peak) * 0.98f)
                      : s.pg + (1.0f - s.pg) * 0.0028f;
  const float o = dc * clamp_to(s.pg, 0.2f, 1.0f);
  return clamp_to(o, -0.98f, 0.98f);
}

// Gel (cpp:137-151). m: omega, kspring. st: pos, vel.
__device__ __forceinline__ float gel_step(float* st, const TexDrive& v,
                                          const TexConsts& k) {
  const float zeta = 0.62f + v.trail * 0x1.a8f5c4p-1f;  // f32(1.45) - f32(0.62)
  const float cdamp = 2.0f * zeta * k.m[0];
  const float force = v.core * (0.52f + 0.62f * v.body);
  const float acc = k.m[1] * (force - st[0]) - cdamp * st[1];
  st[1] = st[1] + acc;
  st[0] = st[0] + st[1];
  const float shaped = 0.48f * v.core + 1.85f * st[0];
  return tanh32(shaped * (0.96f + 0.28f * k.texture));
}

// Metal (cpp:152-169): a 4-mode bank whose angles bend with the impact.
// m: freqs[4], radii[4], a2[4], gains[4], hz_cap, theta_scale.
// st: y1[4], y2[4].
__device__ __forceinline__ float metal_step(float* st, const TexDrive& v,
                                            float hp, const TexConsts& k) {
  const float exc = v.core * (0.19f + 0.52f * v.impact);
  const float bend = 1.0f + 0.09f * v.impact;
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float f = clamp_to(k.m[j] * bend, 20.0f, k.m[16]);
    const float a1 = 2.0f * k.m[4 + j] * cos32(f * k.m[17]);
    y[j] = exc * k.m[12 + j] + a1 * st[j] + k.m[8 + j] * st[4 + j];
  }
  const float modes = ((y[0] + y[1]) + y[2]) + y[3];
  const float bright = 0.03f * v.impact * (v.core - hp);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    st[4 + j] = st[j];
    st[j] = y[j];
  }
  return (0.44f * v.core + 0.42f * modes + bright) * (0.78f + 0.10f * k.texture);
}

// The interpolated ring read behind write index `widx` (cpp:91-105), in
// the scan path's float math; i0 wraps when pos + L rounds up to L.
struct RingTap {
  int i0, i1;
  float frac;
};

__device__ __forceinline__ RingTap tex_ring_tap(int widx, float delay, int L) {
  float pos = static_cast<float>(widx) - delay;
  pos = pos < 0.0f ? pos + static_cast<float>(L) : pos;
  RingTap tap;
  tap.i0 = static_cast<int>(pos);
  tap.frac = pos - static_cast<float>(tap.i0);
  if (tap.i0 >= L) tap.i0 -= L;
  tap.i1 = tap.i0 + 1 >= L ? tap.i0 + 1 - L : tap.i0 + 1;
  return tap;
}

// Wood / plastic (cpp:170-212), given the value `delayed` read from the
// ring; `new_wave` is the value to write at the write index.
// m: a1[4], a2[4], gains[4], delay, damp, wg_m0, wg_m1, exc_s0, exc_s1,
// exc_b0, exc_b1, om0..om4. st: y1[4], y2[4], prev_wave.
__device__ __forceinline__ float wave_step(float* st, const TexDrive& v,
                                           float delayed, float& new_wave,
                                           const TexConsts& k) {
  const float exc = v.core * (k.m[16] + k.m[17] * v.impact);
  new_wave = k.m[13] * (k.m[14] * delayed + k.m[15] * st[8]) +
             exc * (k.m[18] + k.m[19] * v.body);
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = exc * k.m[8 + j] + k.m[j] * st[j] + k.m[4 + j] * st[4 + j];
  const float modes = ((y[0] + y[1]) + y[2]) + y[3];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    st[4 + j] = st[j];
    st[j] = y[j];
  }
  st[8] = delayed;
  return (k.m[20] * v.core + k.m[21] * delayed + k.m[22] * modes) *
         (k.m[23] + k.m[24] * k.texture);
}

// Flesh-like (cpp:214-236). m: k_a, k_b, c_a, c_b, k_couple.
// st: pa, va, pb, vb.
__device__ __forceinline__ float flesh_step(float* st, const TexDrive& v,
                                            const TexConsts& k) {
  const float force = v.core * (0.55f + 0.65f * v.body);
  const float acc_a = k.m[0] * (force - st[0]) - k.m[2] * st[1] -
                      k.m[4] * (st[0] - st[2]);
  const float acc_b = k.m[1] * (st[0] - st[2]) - k.m[3] * st[3];
  st[1] = st[1] + acc_a;
  st[3] = st[3] + acc_b;
  st[0] = st[0] + st[1];
  st[2] = st[2] + st[3];
  const float tissue = 0.92f * st[0] + 0.58f * st[2];
  const float nl = tissue - 0.19f * tissue * tissue * tissue;
  return tanh32((0.50f * v.core + 1.34f * nl) * (0.98f + 0.16f * k.texture));
}

// ---- The same bodies split for texture_stage.cu, which runs the carried
// recurrences on their own warps and leaves the pointwise work that feeds
// no state to helper warps. Each piece does the operations of the composed
// body above in the same order, so the results are the same floats.

// tex_front's trail, from the impact alone.
__device__ __forceinline__ float tex_trail(float impact, const TexConsts& k) {
  return clamp_to(1.0f - impact, 0.0f, 1.0f) * k.tail_shape;
}

// Gel and flesh without their final tanh32: the argument it takes.
__device__ __forceinline__ float gel_arg(float* st, const TexDrive& v,
                                         const TexConsts& k) {
  const float zeta = 0.62f + v.trail * 0x1.a8f5c4p-1f;  // f32(1.45) - f32(0.62)
  const float cdamp = 2.0f * zeta * k.m[0];
  const float force = v.core * (0.52f + 0.62f * v.body);
  const float acc = k.m[1] * (force - st[0]) - cdamp * st[1];
  st[1] = st[1] + acc;
  st[0] = st[0] + st[1];
  const float shaped = 0.48f * v.core + 1.85f * st[0];
  return shaped * (0.96f + 0.28f * k.texture);
}

__device__ __forceinline__ float flesh_arg(float* st, const TexDrive& v,
                                           const TexConsts& k) {
  const float force = v.core * (0.55f + 0.65f * v.body);
  const float acc_a = k.m[0] * (force - st[0]) - k.m[2] * st[1] -
                      k.m[4] * (st[0] - st[2]);
  const float acc_b = k.m[1] * (st[0] - st[2]) - k.m[3] * st[3];
  st[1] = st[1] + acc_a;
  st[3] = st[3] + acc_b;
  st[0] = st[0] + st[1];
  st[2] = st[2] + st[3];
  const float tissue = 0.92f * st[0] + 0.58f * st[2];
  const float nl = tissue - 0.19f * tissue * tissue * tissue;
  return (0.50f * v.core + 1.34f * nl) * (0.98f + 0.16f * k.texture);
}

// Metal's pole coefficient a1 of mode j, from the impact alone.
__device__ __forceinline__ float metal_a1(float impact, int j,
                                          const TexConsts& k) {
  const float bend = 1.0f + 0.09f * impact;
  const float f = clamp_to(k.m[j] * bend, 20.0f, k.m[16]);
  return 2.0f * k.m[4 + j] * cos32(f * k.m[17]);
}

// Metal's mode bank given the four a1.
__device__ __forceinline__ float metal_bank(float* st, float core,
                                            float impact, float hp,
                                            const float* a1,
                                            const TexConsts& k) {
  const float exc = core * (0.19f + 0.52f * impact);
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = exc * k.m[12 + j] + a1[j] * st[j] + k.m[8 + j] * st[4 + j];
  const float modes = ((y[0] + y[1]) + y[2]) + y[3];
  const float bright = 0.03f * impact * (core - hp);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    st[4 + j] = st[j];
    st[j] = y[j];
  }
  return (0.44f * core + 0.42f * modes + bright) * (0.78f + 0.10f * k.texture);
}

// tex_back up to the wet envelope: the noise high-pass, dynamics, tail and
// wet envelope; returns the wet signal before the auto-gain.
__device__ __forceinline__ float tex_back_wet(float shaped, float w,
                                              float impact, float body,
                                              TexChan& s,
                                              const TexConsts& k) {
  const float trail = tex_trail(impact, k);
  s.noise_hp = s.noise_hp + 0.08f * (w - s.noise_hp);
  const float rough = w - s.noise_hp;
  shaped = shaped + rough * (0.004f + 0.022f * k.texture) *
                        (0.14f + 0.64f * impact);
  const float dynamics =
      1.0f + impact * (0.18f + k.texture * 0.12f) + body * 0.06f;
  shaped = shaped * dynamics * k.mat_trim;
  const float tail_input =
      clamp_to(shaped, -2.0f, 2.0f) * (0.45f + 0.55f * trail);
  s.tail = tail_input + s.tail * k.decay;
  const float wet = shaped + s.tail * (0.30f + 0.45f * trail);
  const float wet_abs = fabsf(wet);
  const float wet_c = wet_abs > s.wet_env ? k.wet_atk : k.wet_rel;
  s.wet_env = wet_c * s.wet_env + (1.0f - wet_c) * wet_abs;
  return wet;
}

// The auto-gain (a true division), the mix and the output gain: pointwise,
// given the wet signal and the wet envelope after this sample.
__device__ __forceinline__ float tex_back_gain(float d, float wet,
                                               float wet_env,
                                               const TexConsts& k) {
  const float auto_comp = k.auto_gain_base / (1.0f + 1.8f * wet_env);
  wet = wet * clamp_to(auto_comp, 0.18f, 1.0f);
  const float mixed = d + k.mix * (wet - d);
  return mixed * k.out_gain;
}

// The DC blocker and the limiter; returns the output. The limiter's
// division is taken only where its result is used (peak > 0.88).
__device__ __forceinline__ float tex_back_limit(float pre_dc, TexChan& s,
                                                const TexConsts& k) {
  const float dc = pre_dc - s.dc_in + k.dc_r * s.dc_out;
  s.dc_in = pre_dc;
  s.dc_out = dc;
  const float peak = fabsf(dc);
  if (peak > 0.88f)
    s.pg = min_nan(s.pg, (0.88f / peak) * 0.98f);
  else
    s.pg = s.pg + (1.0f - s.pg) * 0.0028f;
  const float o = dc * clamp_to(s.pg, 0.2f, 1.0f);
  return clamp_to(o, -0.98f, 0.98f);
}

}  // namespace juicy
