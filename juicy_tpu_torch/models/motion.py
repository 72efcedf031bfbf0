"""JuicyMotion, the anti-repetition variation engine: PyTorch port of
juicy_tpu/models/motion.py.

Two passes per block (reference PluginProcessor.cpp:75-142):

Pass 1, mono: an envelope-gated onset detector (|x| > env·1.35 + 0.02, with
a 40 ms cooldown). Each onset rolls three LCG variation targets (tone,
transient, tail; bit shifts 7/9/11) scaled by microvar, and bumps a
repetition accumulator that decays ×0.997 per sample. Then, per block, a
repetition scale and a recovery boost (cpp:97-99).

Pass 2, channel 0 then channel 1: a 20 ms slew of the variation values, a
sine LFO, an LFO/variation-modulated one-pole lowpass (cutoff clamped to
120..4200 Hz), a first-difference transient boost, tail feedback and a
contrast-budget limiter (80 ms envelope).

Quirks kept exactly (PARITY.md §2.2): the slew/LFO/budget state is one mono
state advanced inside each channel's loop, so stereo advances it twice per
block, channel 1 starting where channel 0 left it; the phase wraps by 4π
when it passes 2π; channel 1's LFO reads ``sin32(phase + 0.85)``.

The LCG state ``rng`` is a u32 carrier (int64, ops/noise.py); the cooldown
is int32. Everything runs serially in the op order of the CUDA stage kernel
(csrc/motion.cuh), which is also the C++'s.
"""

from __future__ import annotations

import numpy as np
import torch

from juicy_tpu_torch.models import base
from juicy_tpu_torch.ops.noise import lcg_step
from juicy_tpu_torch.ops.precise import (F32, as_f32, div_const, f32,
                                         onepole_coeff32, sin32)
from juicy_tpu_torch.runtime.device import resolve_device
from juicy_tpu_torch.utils.convert import (db_to_gain, jlimit, jmap, jmap5,
                                           tau_coeff)

PARAMS = (
    base.ParamSpec("microvar", "Micro Variation", 0.0, 1.0, 0.55),
    base.ParamSpec("motiondepth", "Motion Depth", 0.0, 2.0, 1.0),
    base.ParamSpec("repeatctrl", "Repetition Control", 0.0, 1.0, 0.65),
    base.ParamSpec("budget", "Contrast Budget", 0.0, 1.0, 0.5),
    base.mix_param(1.0),
    base.output_param(-18.0, 18.0, -2.0),
    base.juiciness_param(),
)

PRESETS = ()  # the reference declares no presets for Motion

TWO_PI = f32(2.0 * 3.14159265358979323846)
FOUR_PI = f32(4.0 * 3.14159265358979323846)
RNG_SEED = 0x93AB12F0  # PluginProcessor.h:65
#: channel 1's LFO phase offset (channel 0's is 0)
CH_OFFSET = f32(0.85)
#: the cutoff's upper clamp, which lets onepole_coeff32 take the narrow exp
MAX_CUTOFF_HZ = 4200.0

#: the mono (per-clip) float leaves of the state
MONO_KEYS = ("env", "repetition", "budget_env", "variation_tone",
             "variation_transient", "variation_tail", "variation_tone_target",
             "variation_transient_target", "variation_tail_target",
             "motion_phase")
#: the per-channel leaves
CHAN_KEYS = ("lp", "tail", "prev")


def init(sr: float, channels: int, batch_shape=(), device=None):
    """State zeroed at prepareToPlay (cpp:12-29): mono leaves
    [*batch_shape], per-channel leaves [*batch_shape, C], the cooldown
    int32 and ``rng`` a u32 carrier; `device` None is the card."""
    del sr
    dev = resolve_device(device)
    st = {k: torch.zeros(batch_shape, dtype=F32, device=dev)
          for k in MONO_KEYS}
    st["onset_cooldown"] = torch.zeros(batch_shape, dtype=torch.int32,
                                       device=dev)
    st["rng"] = torch.full(batch_shape, RNG_SEED, dtype=torch.int64,
                           device=dev)
    st.update({k: torch.zeros((*batch_shape, channels), dtype=F32, device=dev)
               for k in CHAN_KEYS})
    return st


def cooldown_samples(sr: float) -> int:
    """The onset detector's 40 ms cooldown in samples."""
    return int(sr * 0.04)


def _draw(r, shift: int):
    """LCG bits → a variation value in [−1, 1) (cpp:87-92); exact."""
    bits = (r >> shift) & 0x7FFF
    return bits.to(F32) * f32(1.0 / 16384.0) - 1.0


def p1_consts(sr):
    """Pass 1's detector envelope coefficient (τ = 15 ms) and 1 − it, as
    f32 Python floats."""
    env_c = float(tau_coeff(0.015, sr))
    return env_c, f32(np.float32(1.0) - np.float32(env_c))


def make_p1_step(micro_var, sr):
    """Pass-1 per-sample body (cpp:75-95): envelope-gated onset detection
    and the conditional LCG target rolls. Carry: (env, cooldown,
    repetition, rng, vt, vtr, vtl); `x` is |mono|."""
    env_c, one_env = p1_consts(sr)
    cd = cooldown_samples(sr)

    def step(c, x):
        env, cooldown, repetition, rng, vt, vtr, vtl = c
        env = env_c * env + one_env * x
        cooldown = torch.clamp(cooldown - 1, min=0)
        onset = (x > env * f32(1.35) + f32(0.02)) & (cooldown <= 0)
        cooldown = torch.where(onset, cd, cooldown)
        repetition = torch.where(onset, repetition + 1.0, repetition)
        r1 = lcg_step(rng)
        r2 = lcg_step(r1)
        r3 = lcg_step(r2)
        vt = torch.where(onset, _draw(r1, 7) * micro_var * f32(0.9), vt)
        vtr = torch.where(onset, _draw(r2, 9) * micro_var * f32(0.8), vtr)
        vtl = torch.where(onset, _draw(r3, 11) * micro_var * f32(0.8), vtl)
        rng = torch.where(onset, r3, rng)
        repetition = repetition * f32(0.997)
        return env, cooldown, repetition, rng, vt, vtr, vtl

    return step


def p1_init(carry, batch):
    """Pass-1 carry from the state dict."""
    return tuple(torch.broadcast_to(carry[k], batch) for k in (
        "env", "onset_cooldown", "repetition", "rng", "variation_tone_target",
        "variation_transient_target", "variation_tail_target"))


def block_scales(repetition, repeat_ctrl):
    """Block-level repetition scale and recovery boost (cpp:97-99)."""
    rep_norm = jlimit(0.0, 1.0, repetition * f32(0.08))
    repetition_scale = 1.0 - repeat_ctrl * rep_norm * f32(0.65)
    recovery = 1.0 + repeat_ctrl * (1.0 - rep_norm) * 0.25
    return repetition_scale, recovery


def p2_consts(params, sr):
    """Pass-2 constants from params (cpp:64-73), 0-dim or [B] float32
    tensors on the params' device."""
    micro_var = as_f32(params["microvar"])
    depth = jlimit(0.0, 2.0, params["motiondepth"])
    motion_rate = jmap(micro_var, 0.25, 2.0) * jmap5(depth, 0.0, 2.0, 0.75, 1.6)
    return dict(
        var_slew=float(tau_coeff(0.020, sr)),
        motion_inc=div_const(TWO_PI * motion_rate, sr),
        lfo_depth=(250.0 + 550.0 * micro_var) * (0.5 + f32(0.9) * depth),
        depth=depth, micro_var=micro_var,
        tail_feedback=jmap(params["repeatctrl"], 0.15, 0.88),
        mix=as_f32(params["mix"]),
        out_gain=db_to_gain(params["output"]),
        budget_coeff=float(tau_coeff(0.080, sr)),
        budget_target=jmap(params["budget"], 0.8, 0.25))


def p2_factors(consts):
    """The products of constants alone that the pass-2 body multiplies in,
    each rounded once as the body's op order rounds it; shared by the body
    and the stage kernel's constants."""
    depth, mv = consts["depth"], consts["micro_var"]
    return dict(
        one_slew=f32(np.float32(1.0) - np.float32(consts["var_slew"])),
        one_budget=f32(np.float32(1.0) - np.float32(consts["budget_coeff"])),
        cut_depth=f32(0.6) + f32(0.6) * depth,
        boost_depth=f32(0.6) + f32(0.7) * depth,
        lfo_mv=f32(0.35) * mv,
        lfo_depth2=f32(0.6) + f32(0.8) * depth,
        tone_depth=f32(0.55) + f32(0.7) * depth,
        trans_mv=f32(0.12) + f32(0.30) * mv,
        trans_depth=0.5 + f32(0.8) * depth,
        tail_mix=(f32(0.26) + f32(0.24) * mv) * (f32(0.6) + f32(0.7) * depth),
        wet_boost=1.0 + f32(0.9) * mv * (f32(0.55) + f32(0.9) * depth))


def make_p2_step(consts, targets, scales, ch_offset, sr):
    """Pass-2 per-sample body for one channel (cpp:101-142), threading the
    shared slew/LFO/budget state. Carry: (vt, vtr, vtl, phase, lp, tail,
    prev, budget_env). Constants broadcast against the carry and lie on
    its device: ``budget_target / (be + 1e-5)`` must be a true division,
    which a CPU scalar divisor on CUDA is not."""
    k = dict(consts, **p2_factors(consts))
    vt_t, vtr_t, vtl_t = targets
    repetition_scale, recovery = scales
    var_slew, one_slew = k["var_slew"], k["one_slew"]
    bc, one_bc, target = k["budget_coeff"], k["one_budget"], k["budget_target"]

    def step(c, d):
        vt, vtr, vtl, phase, lp, tail, prev, be = c
        vt = var_slew * vt + one_slew * vt_t
        vtr = var_slew * vtr + one_slew * vtr_t
        vtl = var_slew * vtl + one_slew * vtl_t
        phase = phase + k["motion_inc"]
        phase = torch.where(phase > TWO_PI, phase - FOUR_PI, phase)

        lfo = sin32(phase + ch_offset)
        cutoff = jlimit(120.0, 4200.0, 900.0 + vt * 1100.0 * k["cut_depth"]
                        + lfo * k["lfo_depth"])
        lp_c = onepole_coeff32(cutoff, sr, max_hz=MAX_CUTOFF_HZ)
        lp = lp + lp_c * (d - lp)
        hp = d - lp
        transient = d - prev
        prev = d

        transient_boost = 1.0 + vtr * f32(1.2) * k["boost_depth"] \
            + k["lfo_mv"] * lfo * k["lfo_depth2"]
        tone_shift = lp * (1.0 + vt * f32(0.65) * k["tone_depth"]) \
            + hp * transient_boost \
            + transient * k["trans_mv"] * k["trans_depth"]
        tail = tone_shift + tail * jlimit(0.0, 0.93, k["tail_feedback"]
                                          + vtl * f32(0.06))

        wet = tone_shift * repetition_scale * recovery + k["tail_mix"] * tail
        be = bc * be + one_bc * torch.abs(wet)
        limiter_gain = torch.where(be > target,
                                   torch.div(target, be + f32(1.0e-5)), 1.0)
        wet = wet * limiter_gain
        y = (d + k["mix"] * (wet * k["wet_boost"] - d)) * k["out_gain"]
        return (vt, vtr, vtl, phase, lp, tail, prev, be), y

    return step


def process(params, carry, block, sr: float):
    """block [..., C, N] → (out, carry'). The constants are worked out on
    the params' device and moved to the audio's."""
    block = as_f32(block)
    channels, n = block.shape[-2:]
    dev = block.device
    batch = block.shape[:-2]

    def on(v):
        return v.to(dev) if isinstance(v, torch.Tensor) else v

    micro_var = on(as_f32(params["microvar"]))
    # --- pass 1: mono detection (cpp:75-95) ---
    mono = 0.5 * (block[..., 0, :] + block[..., min(1, channels - 1), :])
    x = torch.abs(mono)
    step1 = make_p1_step(micro_var, sr)
    c1 = p1_init(carry, batch)
    for t in range(n):
        c1 = step1(c1, x[..., t])
    env, cooldown, repetition, rng, vt_t, vtr_t, vtl_t = c1
    scales = block_scales(repetition, on(as_f32(params["repeatctrl"])))

    # --- pass 2, channel 0 then channel 1, sharing the slew/LFO/budget ---
    consts = {key: on(v) for key, v in p2_consts(params, sr).items()}
    shared = tuple(torch.broadcast_to(carry[k], batch) for k in (
        "variation_tone", "variation_transient", "variation_tail",
        "motion_phase"))
    be = torch.broadcast_to(carry["budget_env"], batch)
    out = torch.empty_like(block)
    finals = {k: [] for k in CHAN_KEYS}
    for ch in range(channels):
        step2 = make_p2_step(consts, (vt_t, vtr_t, vtl_t), scales,
                             0.0 if ch == 0 else CH_OFFSET, sr)
        c2 = (*shared, *(torch.broadcast_to(carry[k][..., ch], batch)
                         for k in CHAN_KEYS), be)
        for t in range(n):
            c2, out[..., ch, t] = step2(c2, block[..., ch, t])
        shared, be = c2[:4], c2[7]
        for key, v in zip(CHAN_KEYS, c2[4:7]):
            finals[key].append(v)

    new_carry = {
        "env": env, "repetition": repetition, "budget_env": be,
        "variation_tone": shared[0], "variation_transient": shared[1],
        "variation_tail": shared[2], "motion_phase": shared[3],
        "variation_tone_target": vt_t, "variation_transient_target": vtr_t,
        "variation_tail_target": vtl_t,
        "onset_cooldown": cooldown, "rng": rng,
    }
    new_carry.update({k: torch.stack(v, dim=-1) for k, v in finals.items()})
    return out, new_carry


base.register(base.ProcessorDef(
    name="motion",
    title="Juicy Motion",
    code="JMOT",
    params=PARAMS,
    presets=PRESETS,
    init=init,
    process=process,
))
