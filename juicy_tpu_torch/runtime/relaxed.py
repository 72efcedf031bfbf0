"""The relaxed tier: block-parallel forms of the stages, PyTorch port of
juicy_tpu/runtime/relaxed.py.

The exact executors run each block as a length-N dependent chain, in the
reference's per-sample order. This tier solves a block with O(log N)-depth
primitives instead, for a bounded, measured numeric deviation:

  * every linear recurrence (one-poles, band splits, tail integrators, DC
    blockers, punch's followers, the modal and spring systems) is an
    associative scan (``ops/scan_utils.py``), in JAX's operation order;
  * the branching attack/release followers use ``ar_envelope_relaxed``
    (``AR_ITERS`` refinement passes): the tier's one true approximation,
    with the matrix scans' reassociation scaled by the resonators' Q;
  * onset detection with a cooldown at least one block long fires at most
    once a block, so :func:`_first_onset` finds it exactly;
  * texture's peak limiter composes exactly in the (min, affine) semiring
    (:func:`min_affine_scan`).

State is carried across blocks as in the exact executors, in the states of
``Plugin.init_state``. Punch, cohere, motion and texture's gel, metal and
flesh have relaxed forms; the saturator, width, infer and texture's wood
and plastic run their exact ``process`` (the port's, serial where the
port's is serial: width's shrink and the saturator's tone one-pole).

Every function takes batched tensors (a leading clip axis where JAX maps
one clip at a time) on any device; ``relaxed_chain_stream`` is the entry
point, on the card unless the caller names a device.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

from juicy_tpu_torch import analyzer as _an
from juicy_tpu_torch.models import base
from juicy_tpu_torch.ops.envelopes import ar_envelope_relaxed
from juicy_tpu_torch.ops.noise import lcg_step
from juicy_tpu_torch.ops.precise import (F32, as_f32, f32, onepole_coeff32,
                                         rdiv_const, sin32, tanh32)
from juicy_tpu_torch.ops.scan_utils import (associative_scan,
                                            leaky_integrator,
                                            linear_matrix_scan,
                                            linear_scan_assoc,
                                            onepole_lowpass_assoc)
from juicy_tpu_torch.runtime.device import resolve_device
from juicy_tpu_torch.runtime.plugin import _default_finalize, _stack
from juicy_tpu_torch.utils.convert import (db_to_gain, jlimit, onepole_coeff,
                                           tau_coeff)

AR_ITERS = 4        # refinement passes for the relaxed a/r envelopes

#: texture materials with a relaxed form: gel, metal, flesh
RELAXED_MATERIALS = (0, 1, 4)


# ---------------------------------------------------------------------------
# shared parallel helpers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _libm_powf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.restype = ctypes.c_float
    fn.argtypes = (ctypes.c_float, ctypes.c_float)
    return fn


@functools.lru_cache(maxsize=64)
def _powf_row(base_value: float, k0: int, count: int,
              device=torch.device("cpu")) -> torch.Tensor:
    """base^k for k = k0 … k0+count−1 as float32 on `device`, each value
    the C library's ``powf``: the function XLA:CPU's ``pow`` calls, which
    ``torch.pow`` differs from by an ulp on ~2% of these arguments."""
    powf = _libm_powf()
    row = torch.tensor([powf(base_value, float(k))
                        for k in range(k0, k0 + count)], dtype=F32)
    return row.to(device)


def _first_onset(eligible, entry_cooldown, n: int, cooldown_samples: int):
    """Onset with a cooldown, exactly, for a cooldown of at least one block.

    `eligible` [..., N] bool: the trigger condition without the cooldown.
    The serial loop decrements the cooldown before it tests, so sample t
    may fire iff t + 1 >= entry_cooldown; a hit reloads `cooldown_samples`
    >= N, which silences the rest of the block. Returns (count 0/1 int32,
    exit cooldown int32, onset sample or n int32). A cooldown shorter than
    the block could let a second onset fire, which this form cannot count:
    ValueError (JAX's form returns a wrong count there)."""
    if cooldown_samples < n:
        raise ValueError(
            f"the relaxed onset detector needs a cooldown of at least one "
            f"block: {cooldown_samples} samples < block of {n}")
    t = torch.arange(n, dtype=torch.int32, device=eligible.device)
    ok = eligible & (t + 1 >= entry_cooldown[..., None])
    t_onset = torch.amin(torch.where(ok, t, n), dim=-1)    # first True or n
    any_onset = t_onset < n
    exit_cd = torch.where(any_onset,
                          cooldown_samples - (n - 1 - t_onset),
                          torch.clamp(entry_cooldown - n, min=0))
    return (any_onset.to(torch.int32), exit_cd.to(torch.int32),
            t_onset.to(torch.int32))


def _minaffine_compose(f, g):
    """g∘f for maps x ↦ min(c, a·x + b) with a > 0 (texture's peak
    limiter: engage = min-cap, recover = affine toward 1)."""
    c1, a1, b1 = f
    c2, a2, b2 = g
    return torch.minimum(c2, a2 * c1 + b2), a2 * a1, a2 * b1 + b2


def min_affine_scan(caps, coeffs, offsets, init, dim: int = 0):
    """g[t] = min(caps[t], coeffs[t]·g[t−1] + offsets[t]) exactly in
    O(log N) depth: the (min, affine) maps are closed under composition."""
    c, a, b = associative_scan(_minaffine_compose, (caps, coeffs, offsets),
                               dim=dim)
    return torch.minimum(c, a * init + b)


def _bc(v, batch):
    return torch.broadcast_to(v, batch)


# ---------------------------------------------------------------------------
# analyzer
# ---------------------------------------------------------------------------

def analyze_relaxed(state, block, sr: float):
    """Block-parallel JuicinessAnalyzer, with ``analyzer.analyze``'s
    contract: relaxed envelopes, the onset count exact, the band splits as
    associative scans, the score formulas shared."""
    block = as_f32(block)
    channels, n = block.shape[-2:]
    left = block[..., 0, :]
    right = block[..., 1, :] if channels > 1 else left
    mono = 0.5 * (left + right)
    abs_mono = torch.abs(mono)
    batch = abs_mono.shape[:-1]

    s_env_seq = ar_envelope_relaxed(abs_mono, tau_coeff(0.003, sr),
                                    tau_coeff(0.030, sr),
                                    _bc(state["short_env"], batch),
                                    iters=AR_ITERS)
    l_env_seq = ar_envelope_relaxed(abs_mono, tau_coeff(0.050, sr),
                                    tau_coeff(0.300, sr),
                                    _bc(state["long_env"], batch),
                                    iters=AR_ITERS)
    transient = torch.clamp(s_env_seq - l_env_seq, min=0.0)
    transient_accum = torch.sum(transient, dim=-1)
    onset_count, cooldown, _ = _first_onset(
        transient > f32(0.045), _bc(state["onset_cooldown"], batch), n,
        int(sr * 0.035))

    low_seq = onepole_lowpass_assoc(mono, onepole_coeff(250.0, sr),
                                    state["low_state"])
    high_state_seq = onepole_lowpass_assoc(mono, onepole_coeff(2500.0, sr),
                                           state["high_state"])
    high_seq = mono - high_state_seq

    inv_n = f32(1.0 / n)
    rms_accum = torch.sum(mono * mono, dim=-1)
    peak = torch.amax(abs_mono, dim=-1)
    low_accum = torch.sum(low_seq * low_seq, dim=-1)
    high_accum = torch.sum(high_seq * high_seq, dim=-1)
    side = 0.5 * (left - right)
    side_accum = torch.sum(side * side, dim=-1)
    corr_accum = torch.sum(left * right, dim=-1)
    l_energy = torch.sqrt(torch.sum(left * left, dim=-1) * inv_n)
    r_energy = torch.sqrt(torch.sum(right * right, dim=-1) * inv_n)

    return _an._finalize_metrics(
        state, s_env_seq[..., -1], l_env_seq[..., -1], low_seq[..., -1],
        high_state_seq[..., -1], cooldown, transient_accum, onset_count,
        rms_accum, peak, low_accum, high_accum, side_accum, rms_accum,
        corr_accum, l_energy, r_energy, n, sr)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def _punch_relaxed(params, carry, block, sr: float, static):
    """Punch: the two |x| followers are unbranched one-poles, so exact
    associative scans; the shaping is stateless (models/punch.py)."""
    from juicy_tpu_torch.models import punch as _p
    dry = as_f32(block)
    adry = torch.abs(dry)
    fast_c, slow_c = (torch.tensor(c, dtype=F32, device=dry.device)
                      for c in _p.env_coeffs(sr))
    f_env = linear_scan_assoc(fast_c, (1.0 - fast_c) * adry,
                              carry["fast_env"])
    s_env = linear_scan_assoc(slow_c, (1.0 - slow_c) * adry,
                              carry["slow_env"])
    out = _p.punch_shape(dry, f_env, s_env, _p.shape_consts(
        params, lambda v: base.bcast_param(v, dry, 2)))
    return out, {"fast_env": f_env[..., -1], "slow_env": s_env[..., -1]}


def _cohere_relaxed(params, carry, block, sr: float, static):
    """Cohere: every recurrence is linear (the analysis one-poles with
    their state, the per-channel split filters from zero every block, the
    tail integrator); the block gains are the exact path's
    (models/cohere.py::block_gains)."""
    from juicy_tpu_torch.models import cohere as _c
    block = as_f32(block)
    channels, n = block.shape[-2:]

    def bb(v):
        return base.bcast_param(v, block, 2)

    ch1 = min(1, channels - 1)
    mono = 0.5 * (block[..., 0, :] + block[..., ch1, :])
    low_coeff = onepole_coeff(220.0, sr)
    high_coeff = onepole_coeff(2400.0, sr)
    lo_seq = onepole_lowpass_assoc(mono, low_coeff, carry["analysis_low"])
    hi_seq = onepole_lowpass_assoc(mono, high_coeff, carry["analysis_high"])
    low_v = lo_seq
    high_v = mono - hi_seq
    mid_v = mono - low_v - high_v
    inv_n = f32(1.0 / max(1, n))
    low_e = torch.sum(low_v * low_v, dim=-1) * inv_n
    mid_e = torch.sum(mid_v * mid_v, dim=-1) * inv_n
    high_e = torch.sum(high_v * high_v, dim=-1) * inv_n

    (t_low, t_mid, t_high), context_fit, comps, fb = _c.block_gains(
        carry, low_e, mid_e, high_e, params)

    dry = block
    zeros = torch.zeros(dry.shape[:-1], dtype=F32, device=dry.device)
    lp_a = onepole_lowpass_assoc(dry, low_coeff, zeros)
    lp_b = onepole_lowpass_assoc(dry, high_coeff, zeros)
    low_r = lp_a * bb(comps[0])
    high_r = (dry - lp_b) * bb(comps[2])
    mid_r = (dry - lp_a - (dry - lp_b)) * bb(comps[1])
    matched = low_r + mid_r + high_r
    tail = leaky_integrator(matched, bb(fb), carry["tail"])
    wet = matched + bb(params["tail"]) * f32(0.35) * tail
    out = (dry + bb(params["mix"]) * (wet - dry)) * \
        bb(db_to_gain(params["output"]))

    new_carry = dict(carry)
    new_carry.update({
        "target_low": t_low, "target_mid": t_mid, "target_high": t_high,
        "analysis_low": lo_seq[..., -1], "analysis_high": hi_seq[..., -1],
        "tail": tail[..., -1], "context_fit": context_fit,
    })
    return out, new_carry


def _motion_relaxed(params, carry, block, sr: float, static):
    """Motion block-parallel.

    Pass 1: the gate envelope is an unbranched one-pole; the onset with its
    40 ms cooldown is exact; the repetition accumulator is linear; the LCG
    rolls happen at most once a block, so the three draws select directly.
    Pass 2: the slews are one-poles toward block-constant targets (closed
    form, the powers as ``powf``), the LFO phase is a closed-form ramp with
    its one 4π wrap counted by a cumsum, the modulated lowpass, the tail
    and the budget envelope are linear scans; channel 1 runs the shared
    slew/phase state from where channel 0 left it (the stereo quirk)."""
    from juicy_tpu_torch.models import motion as _m
    block = as_f32(block)
    channels, n = block.shape[-2:]
    dev = block.device

    def on(v):
        return as_f32(v).to(dev) if isinstance(v, torch.Tensor) else v

    def col(v):
        """A per-clip value [B] against the [B, N] sample rows."""
        v = on(v)
        return v[..., None] if isinstance(v, torch.Tensor) and v.ndim else v

    micro_var = on(params["microvar"])
    repeat_ctrl = on(params["repeatctrl"])

    # ---- pass 1 ----
    ch1 = min(1, channels - 1)
    mono = 0.5 * (block[..., 0, :] + block[..., ch1, :])
    x = torch.abs(mono)
    batch = x.shape[:-1]
    env_coeff = tau_coeff(0.015, sr).to(dev)
    env_seq = linear_scan_assoc(env_coeff, (1.0 - env_coeff) * x,
                                _bc(carry["env"], batch))
    eligible = x > env_seq * f32(1.35) + f32(0.02)
    count, cooldown, t_onset = _first_onset(
        eligible, _bc(carry["onset_cooldown"], batch), n,
        _m.cooldown_samples(sr))
    onset_any = count > 0

    # repetition: rep[t] = 0.997·(rep[t−1] + onset[t]), final value only;
    # the one onset at t1 contributes 0.997^(n − t1)
    decay = f32(0.997)
    contrib = torch.where(
        onset_any, _powf_row(decay, 0, n + 1, dev)[(n - t_onset).long()], 0.0)
    repetition = _bc(carry["repetition"], batch) \
        * float(_powf_row(decay, n, 1)[0]) + contrib

    # the LCG: exactly three draws at the (single) onset
    rng0 = _bc(carry["rng"], batch)
    r1 = lcg_step(rng0)
    r2 = lcg_step(r1)
    r3 = lcg_step(r2)
    vt_t = torch.where(onset_any, _m._draw(r1, 7) * micro_var * f32(0.9),
                       _bc(carry["variation_tone_target"], batch))
    vtr_t = torch.where(onset_any, _m._draw(r2, 9) * micro_var * f32(0.8),
                        _bc(carry["variation_transient_target"], batch))
    vtl_t = torch.where(onset_any, _m._draw(r3, 11) * micro_var * f32(0.8),
                        _bc(carry["variation_tail_target"], batch))
    rng = torch.where(onset_any, r3, rng0)

    repetition_scale, recovery = _m.block_scales(repetition, repeat_ctrl)
    consts = _m.p2_consts(params, sr)
    depth, mv = col(consts["depth"]), col(consts["micro_var"])
    bc = torch.tensor(consts["budget_coeff"], dtype=F32, device=dev)
    target = col(consts["budget_target"])

    # ---- pass 2 (the shared slew/phase/budget advanced ch0 then ch1) ----
    t_idx = torch.arange(n, dtype=F32, device=dev)

    def slewed(v0, tgt, step0):
        # v[k] = a^k·v0 + (1 − a^k)·target, k = step0+1 … step0+n
        ak = _powf_row(consts["var_slew"], step0 + 1, n, dev)
        return ak * v0[..., None] + (1.0 - ak) * tgt[..., None]

    def phase_seq(p0, step0):
        # serial: phase += inc; if phase > 2π: phase −= 4π. inc·n is far
        # below 2π, so at most one wrap a block, replicated on the ramp
        k = t_idx + float(step0 + 1)
        u = p0[..., None] + col(consts["motion_inc"]) * k
        wraps = torch.cumsum((u > _m.TWO_PI).to(F32), dim=-1)
        wraps = torch.clamp(wraps, max=1.0)
        return u - _m.FOUR_PI * wraps

    vt0 = _bc(carry["variation_tone"], batch)
    vtr0 = _bc(carry["variation_transient"], batch)
    vtl0 = _bc(carry["variation_tail"], batch)
    phase0 = _bc(carry["motion_phase"], batch)
    be0 = _bc(carry["budget_env"], batch)

    lp_f, tail_f, prev_f, outs = [], [], [], []
    for ch in range(channels):
        off = 0.0 if ch == 0 else _m.CH_OFFSET
        step0 = ch * n
        vt = slewed(vt0, vt_t, step0)
        vtr = slewed(vtr0, vtr_t, step0)
        vtl = slewed(vtl0, vtl_t, step0)
        phase = phase_seq(phase0, step0)
        d = block[..., ch, :]

        lfo = sin32(phase + off)
        cutoff = jlimit(120.0, 4200.0,
                        900.0 + vt * 1100.0 * (f32(0.6) + f32(0.6) * depth)
                        + lfo * col(consts["lfo_depth"]))
        lp_c = onepole_coeff32(cutoff, sr, max_hz=_m.MAX_CUTOFF_HZ)
        lp = linear_scan_assoc(1.0 - lp_c, lp_c * d,
                               _bc(carry["lp"][..., ch], batch))
        hp = d - lp
        prev0 = _bc(carry["prev"][..., ch], batch)
        transient = d - torch.cat([prev0[..., None], d[..., :-1]], dim=-1)

        transient_boost = 1.0 + vtr * f32(1.2) * (f32(0.6) + f32(0.7) * depth) \
            + f32(0.35) * mv * lfo * (f32(0.6) + f32(0.8) * depth)
        tone_shift = lp * (1.0 + vt * f32(0.65) * (f32(0.55) + f32(0.7) * depth)) \
            + hp * transient_boost \
            + transient * (f32(0.12) + f32(0.30) * mv) * (0.5 + f32(0.8) * depth)
        tail_fb = jlimit(0.0, 0.93, col(consts["tail_feedback"])
                         + vtl * f32(0.06))
        tail = linear_scan_assoc(tail_fb, tone_shift,
                                 _bc(carry["tail"][..., ch], batch))

        wet_pre = tone_shift * repetition_scale[..., None] \
            * recovery[..., None] \
            + (f32(0.26) + f32(0.24) * mv) * (f32(0.6) + f32(0.7) * depth) \
            * tail
        be = linear_scan_assoc(bc, (1.0 - bc) * torch.abs(wet_pre), be0)
        limiter_gain = torch.where(be > target,
                                   torch.div(target, be + f32(1.0e-5)), 1.0)
        wet = wet_pre * limiter_gain
        wet_boost = 1.0 + f32(0.9) * mv * (f32(0.55) + f32(0.9) * depth)
        y = (d + col(consts["mix"]) * (wet * wet_boost - d)) \
            * col(consts["out_gain"])

        outs.append(y)
        lp_f.append(lp[..., -1])
        tail_f.append(tail[..., -1])
        prev_f.append(d[..., -1])
        vt0f, vtr0f, vtl0f = vt[..., -1], vtr[..., -1], vtl[..., -1]
        phase0f = phase[..., -1]
        be0 = be[..., -1]

    new_carry = dict(carry)
    new_carry.update({
        "env": env_seq[..., -1], "repetition": repetition,
        "budget_env": be0,
        "variation_tone": vt0f, "variation_transient": vtr0f,
        "variation_tail": vtl0f,
        "variation_tone_target": vt_t,
        "variation_transient_target": vtr_t,
        "variation_tail_target": vtl_t,
        "onset_cooldown": cooldown, "rng": rng,
        "tail": torch.stack(tail_f, dim=-1),
        "lp": torch.stack(lp_f, dim=-1),
        "prev": torch.stack(prev_f, dim=-1),
        "motion_phase": phase0f,
    })
    return torch.stack(outs, dim=-2), new_carry


def _row(*vals):
    return torch.stack(torch.broadcast_tensors(*vals), dim=-1)


def _texture_relaxed(params, carry, block, sr: float, static):
    """Texture block-parallel for the materials without a waveguide (gel,
    metal, flesh). The envelopes relax; the spring and modal systems are
    (time-varying) linear, so matrix scans; tail, DC blocker and the noise
    highpass are linear; the peak limiter is exact in the (min, affine)
    semiring. Wood and plastic raise NotImplementedError (their ring delay
    feeds back within the block at a knob-dependent lag: the exact
    executor runs them)."""
    from juicy_tpu_torch.models import texture as _t
    mode = static if static is not None else _t.static_material(params)
    if mode not in RELAXED_MATERIALS:
        raise NotImplementedError(
            "relaxed texture supports gel/metal/flesh; waveguide materials "
            "(wood/plastic) use the exact executor")
    block = as_f32(block)
    channels, n = block.shape[-2:]
    dev = block.device
    L = _t.waveguide_size(sr)

    def rows(tree):
        # per-clip values [..., 1] (against [..., C]) gain an axis so that
        # they broadcast against the [..., C, N] sample rows
        return {k: v[..., None] if v.ndim else v for k, v in tree.items()}

    # the constants are worked out on the CPU, then moved
    kc, mp = _t.common_consts(params, sr, mode)
    kc, mp = rows(kc), rows(mp)
    mc = _t._on(_t.material_consts(mode, mp, sr, L), dev)
    kc = _t._on(kc, dev)

    d = block
    batch = d.shape[:-1]                       # [..., C]

    # the exact per-channel LCG noise (the exact executor's draws)
    w, rng_f = _t.block_noise(carry["rng"], channels, n)

    driven = d * kc["in_trim"]
    adry = torch.abs(d)
    env = ar_envelope_relaxed(adry, kc["env_atk"], kc["env_rel"],
                              _bc(carry["env"], batch), iters=AR_ITERS)
    impact = jlimit(0.0, 1.0, torch.clamp(adry - env, min=0.0) * 10.0)
    body = jlimit(0.0, 1.0, env * f32(3.2))
    trail = jlimit(0.0, 1.0, 1.0 - impact) * kc["tail_shape"]

    lp = onepole_lowpass_assoc(driven, kc["split_low"],
                               _bc(carry["lp"], batch))
    hp = onepole_lowpass_assoc(driven, kc["split_high"],
                               _bc(carry["hp"], batch))
    low = lp * kc["low_boost"]
    high = driven - hp
    mid = driven - lp - high
    core = low + mid + high * (f32(0.9) + kc["texture"] * f32(1.3))

    one = torch.ones((), dtype=F32, device=dev)
    if mode == 0:       # gel: a time-varying 2×2 spring (cdamp from trail)
        zeta = f32(0.62) + trail * (f32(1.45) - f32(0.62))
        cdamp = 2.0 * zeta * mc["omega"]
        k = mc["k"]
        force = core * (f32(0.52) + f32(0.62) * body)
        # state [vel, pos]: vel' = (1−cdamp)·vel − k·pos + k·force;
        #                   pos' = vel' + pos
        a11 = 1.0 - cdamp
        mats = torch.stack([_row(a11, -k),
                            _row(a11, one - k + torch.zeros_like(a11))],
                           dim=-2)
        vec = k * force
        vecs = torch.stack([vec, vec], dim=-1)
        init = torch.stack([_bc(carry["spring_vel"], batch),
                            _bc(carry["spring_pos"], batch)], dim=-1)
        xs = linear_matrix_scan(mats.movedim(-3, 0), vecs.movedim(-2, 0),
                                init)
        vel_seq = xs[..., 0].movedim(0, -1)
        pos_seq = xs[..., 1].movedim(0, -1)
        shaped = f32(0.48) * core + f32(1.85) * pos_seq
        shaped = tanh32(shaped * (f32(0.96) + f32(0.28) * kc["texture"]))
        mat_updates = {"spring_pos": pos_seq[..., -1],
                       "spring_vel": vel_seq[..., -1]}
    elif mode == 1:     # metal: 4 modes, a per-sample a1 through the bend
        exc = core * (f32(0.19) + f32(0.52) * impact)
        bend = 1.0 + f32(0.09) * impact
        f0 = mc["f0"]
        f0 = f0[..., None] if f0.ndim else f0
        a1, a2 = _t._modal_coeffs(f0 * mc["ratios"] * bend[..., None],
                                  mc["t60s"], sr)
        # bend [..., C, N] → a1 [..., C, N, 4]; a2 = −r² is per mode only
        a2 = torch.broadcast_to(a2, a1.shape)
        z = torch.zeros_like(a1)
        mats = torch.stack([torch.stack([a1, a2], dim=-1),
                            torch.stack([torch.ones_like(a1), z], dim=-1)],
                           dim=-2)                     # [..., C, N, 4, 2, 2]
        vec = exc[..., None] * mc["gains"]     # [..., C, N, 4]
        vecs = torch.stack([vec, torch.zeros_like(vec)], dim=-1)
        init = torch.stack([_bc(carry["modal_y1"], batch + (4,)),
                            _bc(carry["modal_y2"], batch + (4,))], dim=-1)
        xs = linear_matrix_scan(mats.movedim(-4, 0), vecs.movedim(-3, 0),
                                init)
        y_seq = xs[..., 0].movedim(0, -2)              # [..., C, N, 4]
        y1_seq = xs[..., 1].movedim(0, -2)
        modes = _t._serial_mode_sum(y_seq)
        bright = f32(0.03) * impact * (core - hp)
        shaped = (f32(0.44) * core + f32(0.42) * modes + bright) \
            * (f32(0.78) + f32(0.10) * kc["texture"])
        mat_updates = {"modal_y1": y_seq[..., -1, :],
                       "modal_y2": y1_seq[..., -1, :]}
    else:               # flesh: a constant 4×4 two-mass system
        k_a, k_b = mc["k_a"], mc["k_b"]
        c_a, c_b, k_cp = mc["c_a"], mc["c_b"], mc["k_couple"]
        force = core * (f32(0.55) + f32(0.65) * body)
        # state [va, pa, vb, pb]
        # va' = va + k_a(force−pa) − c_a·va − k_cp(pa−pb)
        # vb' = vb + k_b(pa−pb) − c_b·vb ;  pa' = pa+va' ; pb' = pb+vb'
        z = 0.0 * one
        a_mat = torch.stack([
            _row(one - c_a, -(k_a + k_cp), z, k_cp * one),
            _row(one - c_a, one - (k_a + k_cp), z, k_cp * one),
            _row(z, k_b, one - c_b, -k_b),
            _row(z, k_b, one - c_b, one - k_b)], dim=-2)   # [..., 4, 4]
        bvec = torch.stack([k_a * force, k_a * force,
                            torch.zeros_like(force), torch.zeros_like(force)],
                           dim=-1)                          # [..., C, N, 4]
        mats = torch.broadcast_to(a_mat, bvec.shape[:-1] + (4, 4))
        init = torch.stack([_bc(carry["flesh_vel_a"], batch),
                            _bc(carry["flesh_pos_a"], batch),
                            _bc(carry["flesh_vel_b"], batch),
                            _bc(carry["flesh_pos_b"], batch)], dim=-1)
        xs = linear_matrix_scan(mats.movedim(-3, 0), bvec.movedim(-2, 0),
                                init)
        pa_seq = xs[..., 1].movedim(0, -1)
        pb_seq = xs[..., 3].movedim(0, -1)
        tissue = f32(0.92) * pa_seq + f32(0.58) * pb_seq
        nl = tissue - f32(0.19) * tissue * tissue * tissue
        shaped = tanh32((f32(0.50) * core + f32(1.34) * nl)
                        * (f32(0.98) + f32(0.16) * kc["texture"]))
        mat_updates = {"flesh_pos_a": pa_seq[..., -1],
                       "flesh_vel_a": xs[..., 0].movedim(0, -1)[..., -1],
                       "flesh_pos_b": pb_seq[..., -1],
                       "flesh_vel_b": xs[..., 2].movedim(0, -1)[..., -1]}

    # roughness noise (cpp:239-243)
    noise_hp = onepole_lowpass_assoc(w, torch.tensor(f32(0.08), device=dev),
                                     _bc(carry["noise_hp"], batch))
    rough = w - noise_hp
    shaped = shaped + rough * (f32(0.004) + f32(0.022) * kc["texture"]) \
        * (f32(0.14) + f32(0.64) * impact)

    dynamics = 1.0 + impact * (f32(0.18) + kc["texture"] * f32(0.12)) \
        + body * f32(0.06)
    shaped = shaped * dynamics * kc["mat_trim"]

    tail_input = jlimit(-2.0, 2.0, shaped) * (f32(0.45) + f32(0.55) * trail)
    tail = leaky_integrator(tail_input, kc["decay"], _bc(carry["tail"], batch))
    wet = shaped + tail * (f32(0.30) + f32(0.45) * trail)

    wet_env = ar_envelope_relaxed(torch.abs(wet), kc["wet_atk"],
                                  kc["wet_rel"], _bc(carry["wet_env"], batch),
                                  iters=AR_ITERS)
    auto_comp = torch.div(kc["auto_gain_base"], 1.0 + f32(1.8) * wet_env)
    wet = wet * jlimit(0.18, 1.0, auto_comp)

    mixed = d + kc["mix"] * (wet - d)
    pre_dc = mixed * kc["out_gain"]

    # DC blocker: dc[t] = pre_dc[t] − pre_dc[t−1] + R·dc[t−1]
    prev_in = torch.cat([_bc(carry["dc_in"], batch)[..., None],
                         pre_dc[..., :-1]], dim=-1)
    dc = linear_scan_assoc(kc["dc_r"], pre_dc - prev_in,
                           _bc(carry["dc_out"], batch))

    # the peak limiter, exactly: engaged g ↦ min(g, 0.98·0.88/peak);
    # released g ↦ (1 − r)·g + r
    peak = torch.abs(dc)
    over = peak > f32(0.88)
    r = f32(0.0028)
    caps = torch.where(over, rdiv_const(0.88, peak) * f32(0.98), f32(1.0e9))
    coeffs = torch.where(over, 1.0, f32(np.float32(1.0) - np.float32(r)))
    offsets = torch.where(over, 0.0, r)
    pg = min_affine_scan(caps.movedim(-1, 0), coeffs.movedim(-1, 0),
                         offsets.movedim(-1, 0),
                         _bc(carry["protect_gain"], batch))
    pg = pg.movedim(0, -1)
    out = jlimit(-0.98, 0.98, dc * jlimit(0.2, 1.0, pg))

    new_carry = dict(carry)
    new_carry.update(mat_updates)
    new_carry.update({
        "env": env[..., -1], "lp": lp[..., -1], "hp": hp[..., -1],
        "noise_hp": noise_hp[..., -1], "tail": tail[..., -1],
        "wet_env": wet_env[..., -1], "dc_in": pre_dc[..., -1],
        "dc_out": dc[..., -1], "protect_gain": pg[..., -1],
        "rng": rng_f,
    })
    return out, new_carry


#: stage name -> relaxed process (params, carry, block, sr, static) ->
#: (out, carry'). Stages absent here fall back to their exact
#: ``defn.process`` inside relaxed_step: the saturator, width and infer
#: (block-parallel in JAX's models already; the saturator's tone one-pole
#: and width's shrink are serial loops in the port's).
RELAXED_PROCESS = {
    "punch": _punch_relaxed,
    "cohere": _cohere_relaxed,
    "motion": _motion_relaxed,
    "texture": _texture_relaxed,
}


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def relaxed_step(plugin, params, state, block):
    """One processBlock on the relaxed tier, with ``Plugin.step``'s
    contract. Texture runs its relaxed form for a static gel, metal or
    flesh and its exact process otherwise (wood, plastic, or a material
    per clip, which takes ``process_traced``), as JAX's does."""
    block = as_f32(block)
    p = plugin.full_params(params)
    sr = plugin.sr
    pre_state, pre = analyze_relaxed(state["analyzer"], block, sr)
    fn = RELAXED_PROCESS.get(plugin.defn.name)
    static = None
    if fn is not None and plugin.defn.name == "texture":
        from juicy_tpu_torch.models import texture as _t
        static = _t.static_material(p)
        if static not in RELAXED_MATERIALS:
            fn = None
    if fn is None:
        out, dsp = plugin.defn.process(p, state["dsp"], block, sr)
    else:
        out, dsp = fn(p, state["dsp"], block, sr, static)
    post_state, post = analyze_relaxed(pre_state, out, sr)
    finalize = plugin.defn.finalize_metrics or _default_finalize
    return out, {"analyzer": post_state, "dsp": dsp}, \
        finalize(p, pre, post, dsp)


def relaxed_chain_stream(chain, states, clips, device=None):
    """Stream a [B, C, T] corpus (a tensor or a numpy array) through `chain`
    on the relaxed tier, stage-major, on `device` (the card when None,
    which must then exist), with the states on it as ``Chain.batched_run``
    takes them (``chain.init_state((B,), device)``).
    Returns (out [B, C, T], new states, per-stage metrics [nb, B]).

    A texture stage with a material per clip (a [B] row on a
    ``with_traced("material")`` plugin) raises ValueError, as JAX's
    relaxed_chain_stream does for such a row."""
    device = resolve_device(device)
    if isinstance(clips, np.ndarray):
        clips = torch.from_numpy(clips)
    out = as_f32(clips).to(device)
    n = chain.block_size
    nb = chain.plugins[0].num_blocks(out)
    for plug, params in zip(chain.plugins, chain.params):
        m = plug.full_params(params).get("material")
        if plug.defn.name == "texture" and m is not None \
                and torch.as_tensor(m).numel() > 1:
            raise ValueError(
                "relaxed_chain_stream takes one texture material for the "
                "whole corpus; a material per clip runs on run_corpus_chain")
    new_states, metrics = [], []
    for plug, params, st in zip(chain.plugins, chain.params, states,
                                strict=True):
        nxt = torch.empty_like(out)
        ms = []
        for i in range(nb):
            sl = slice(i * n, (i + 1) * n)
            nxt[..., sl], st, m = relaxed_step(plug, params, st, out[..., sl])
            ms.append(m)
        out = nxt
        new_states.append(st)
        metrics.append(_stack(ms))
    return out, new_states, metrics
