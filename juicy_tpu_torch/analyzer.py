"""JuicinessAnalyzer: per-sample feature extractor and 0–100 scorer.

PyTorch port of juicy_tpu/analyzer.py. ``analyze(state, block, sr)`` returns
``(state', metrics)``; state and metrics are dicts of tensors whose shape is
the block's leading (batch) shape. The per-sample envelope/onset recurrence
and the band one-poles run as serial loops over the block; the stateless
reductions are tensor sums. The score formulas (``_lane_stateless``,
``_ema_update``) are shared with the stage kernels' finalize.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from juicy_tpu_torch.ops.precise import F32, div_const, f32
from juicy_tpu_torch.ops.scan_utils import onepole_lowpass
from juicy_tpu_torch.runtime.device import resolve_device
from juicy_tpu_torch.utils.convert import jlimit, onepole_coeff, tau_coeff

Metrics = Dict[str, torch.Tensor]

STATE_FIELDS = ("short_env", "long_env", "low_state", "high_state",
                "repetition_ema", "fatigue_ema", "onset_cooldown")


def analyzer_init(batch_shape=(), device=None) -> Dict[str, torch.Tensor]:
    """Fresh analyzer state (prepare()/reset()); the cooldown is int32.
    `device` None is the card (runtime/device.py)."""
    device = resolve_device(device)
    st = {k: torch.zeros(batch_shape, dtype=F32, device=device)
          for k in STATE_FIELDS}
    st["onset_cooldown"] = torch.zeros(batch_shape, dtype=torch.int32,
                                       device=device)
    return st


def lane_consts(sr: float):
    """The lane's seven per-sample constants: attack and release of the
    short and long envelopes and the two band coefficients as Python floats
    (exact f32), then the onset cooldown in samples (int)."""
    return (float(tau_coeff(0.003, sr)), float(tau_coeff(0.030, sr)),
            float(tau_coeff(0.050, sr)), float(tau_coeff(0.300, sr)),
            float(onepole_coeff(250.0, sr)), float(onepole_coeff(2500.0, sr)),
            int(sr * 0.035))


def _envelope_onset_scan(abs_mono, state, sr: float):
    """Dual envelopes and cooldown-gated onset counting, serially over the
    last axis. Returns (s_env, l_env, cooldown, count, transient sum)."""
    atk_s, rel_s, atk_l, rel_l, _lo, _hi, cd_samples = lane_consts(sr)
    batch_shape = abs_mono.shape[:-1]
    s_env = torch.broadcast_to(state["short_env"], batch_shape)
    l_env = torch.broadcast_to(state["long_env"], batch_shape)
    cooldown = torch.broadcast_to(state["onset_cooldown"], batch_shape)
    count = torch.zeros(batch_shape, dtype=torch.int32, device=abs_mono.device)
    accum = torch.zeros(batch_shape, dtype=F32, device=abs_mono.device)
    for i in range(abs_mono.shape[-1]):
        x = abs_mono[..., i]
        cs = torch.where(x > s_env, atk_s, rel_s)
        s_env = (1.0 - cs) * x + cs * s_env
        cl = torch.where(x > l_env, atk_l, rel_l)
        l_env = (1.0 - cl) * x + cl * l_env
        transient = torch.clamp(s_env - l_env, min=0.0)
        accum = accum + transient
        cooldown = torch.clamp(cooldown - 1, min=0)
        onset = (transient > f32(0.045)) & (cooldown <= 0)
        count = count + onset.to(torch.int32)
        cooldown = torch.where(onset, cd_samples, cooldown)
    return s_env, l_env, cooldown, count, accum


# ---------------------------------------------------------------------------
# Lane form: the analyzer's per-sample work as a body over one sample, with
# the band energies accumulated serially in the C++ order. Carry per lane:
# (s_env, l_env, cooldown, t_accum, count, low, high, low_acc, high_acc).
# ---------------------------------------------------------------------------

def lane_init(state: Dict[str, torch.Tensor], batch_shape):
    device = state["short_env"].device
    z = torch.zeros(batch_shape, dtype=F32, device=device)
    return (torch.broadcast_to(state["short_env"], batch_shape),
            torch.broadcast_to(state["long_env"], batch_shape),
            torch.broadcast_to(state["onset_cooldown"], batch_shape),
            z, torch.zeros(batch_shape, dtype=torch.int32, device=device),
            torch.broadcast_to(state["low_state"], batch_shape),
            torch.broadcast_to(state["high_state"], batch_shape), z, z)


def make_lane_body(sr: float):
    """Per-sample lane body: (carry, l, r) -> carry'."""
    atk_s, rel_s, atk_l, rel_l, low_c, high_c, cd_samples = lane_consts(sr)

    def body(c, l, r):
        s_env, l_env, cooldown, accum, count, lo, hi, lo_acc, hi_acc = c
        mono = 0.5 * (l + r)
        x = torch.abs(mono)
        cs = torch.where(x > s_env, atk_s, rel_s)
        s_env = (1.0 - cs) * x + cs * s_env
        cl = torch.where(x > l_env, atk_l, rel_l)
        l_env = (1.0 - cl) * x + cl * l_env
        transient = torch.clamp(s_env - l_env, min=0.0)
        accum = accum + transient
        cooldown = torch.clamp(cooldown - 1, min=0)
        onset = (transient > f32(0.045)) & (cooldown <= 0)
        count = count + onset.to(torch.int32)
        cooldown = torch.where(onset, cd_samples, cooldown)
        lo = lo + low_c * (mono - lo)
        hi = hi + high_c * (mono - hi)
        high_v = mono - hi
        lo_acc = lo_acc + lo * lo
        hi_acc = hi_acc + high_v * high_v
        return (s_env, l_env, cooldown, accum, count, lo, hi, lo_acc, hi_acc)

    return body


def stream_stats(block: torch.Tensor, channels: int) -> Dict[str, torch.Tensor]:
    """Stateless per-block reductions of one audio stream [..., C, N]."""
    left = block[..., 0, :]
    right = block[..., 1, :] if channels > 1 else left
    mono = 0.5 * (left + right)
    inv_n = f32(1.0 / block.shape[-1])
    side = 0.5 * (left - right)
    return {
        "rms_accum": torch.sum(mono * mono, dim=-1),
        "peak": torch.amax(torch.abs(mono), dim=-1),
        "side_accum": torch.sum(side * side, dim=-1),
        "corr_accum": torch.sum(left * right, dim=-1),
        "l_energy": torch.sqrt(torch.sum(left * left, dim=-1) * inv_n),
        "r_energy": torch.sqrt(torch.sum(right * right, dim=-1) * inv_n),
    }


def lane_finalize(c, state: Dict[str, torch.Tensor],
                  stats: Dict[str, torch.Tensor], n: int, sr: float):
    """(final lane carry, prior state, stream stats) -> (state', metrics)."""
    s_env, l_env, cooldown, accum, count, lo, hi, lo_acc, hi_acc = c
    return _finalize_metrics(
        state, s_env, l_env, lo, hi, cooldown, accum, count,
        stats["rms_accum"], stats["peak"], lo_acc, hi_acc,
        stats["side_accum"], stats["rms_accum"], stats["corr_accum"],
        stats["l_energy"], stats["r_energy"], n, sr)


def analyze(state: Dict[str, torch.Tensor], block: torch.Tensor, sr: float
            ) -> Tuple[Dict[str, torch.Tensor], Metrics]:
    """Analyze one block [..., C, N] float32; returns (state', metrics)."""
    if block.dtype != F32:
        raise TypeError(f"expected float32 audio, got {block.dtype}")
    channels = block.shape[-2]
    n = block.shape[-1]
    left = block[..., 0, :]
    right = block[..., 1, :] if channels > 1 else left
    mono = 0.5 * (left + right)
    abs_mono = torch.abs(mono)

    s_env, l_env, cooldown, onset_count, transient_accum = \
        _envelope_onset_scan(abs_mono, state, sr)

    low_seq = onepole_lowpass(mono, onepole_coeff(250.0, sr),
                              state["low_state"])
    high_state_seq = onepole_lowpass(mono, onepole_coeff(2500.0, sr),
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

    return _finalize_metrics(state, s_env, l_env, low_seq[..., -1],
                             high_state_seq[..., -1], cooldown,
                             transient_accum, onset_count, rms_accum, peak,
                             low_accum, high_accum, side_accum, rms_accum,
                             corr_accum, l_energy, r_energy, n, sr)


def _lane_stateless(s_env, l_env, low_state, high_state, cooldown,
                    transient_accum, onset_count, rms_accum, peak,
                    low_accum, high_accum, side_accum, mid_accum,
                    corr_accum, l_energy, r_energy, n: int, sr: float):
    """The score formulas that depend only on this block's accumulators.
    Returns (metrics without the EMA fields, EMA inputs)."""
    inv_n = f32(1.0 / n)
    rms = torch.sqrt(rms_accum * inv_n + f32(1.0e-12))
    crest = peak / (rms + f32(1.0e-6))
    low_energy = low_accum * inv_n
    high_energy = high_accum * inv_n
    low_high_ratio = low_energy / (high_energy + f32(1.0e-8))
    width_ratio = side_accum / (mid_accum + side_accum + f32(1.0e-8))

    # correlation normalized by the product of per-channel RMS (not a true
    # Pearson correlation; reproduced as the reference computes it)
    corr = jlimit(-1.0, 1.0,
                  corr_accum * inv_n / (l_energy * r_energy + f32(1.0e-6)))

    transient_mean = transient_accum * inv_n
    punch = jlimit(0.0, 1.0, 6.0 * transient_mean / (rms + f32(1.0e-5)))
    richness = jlimit(0.0, 1.0, (f32(2.3) - crest) * f32(0.65) + rms * 2.0)

    clarity = 1.0 - torch.where(
        low_high_ratio > 2.5,
        jlimit(0.0, 0.6, (low_high_ratio - 2.5) * f32(0.15)), 0.0)
    clarity = clarity - torch.where(
        high_energy > f32(0.03),
        jlimit(0.0, 0.5, (high_energy - f32(0.03)) * 8.0), 0.0)
    clarity = jlimit(0.0, 1.0, clarity)

    width = jlimit(0.0, 1.0, width_ratio * 2.0)
    mono_safety = jlimit(0.0, 1.0, 0.5 * (corr + 1.0))

    onset_rate = div_const(onset_count.to(F32), f32(n / sr))

    emphasis = jlimit(0.0, 1.0, f32(0.62) * punch + f32(0.38)
                      * jlimit(0.0, 1.0, transient_mean * 8.5))
    coherence = jlimit(0.0, 1.0, 0.50 * clarity
                       + f32(0.30) * mono_safety
                       + f32(0.20) * (1.0 - torch.abs(width - f32(0.45))))
    synesthesia = jlimit(0.0, 1.0, f32(0.45) * richness
                         + f32(0.30) * jlimit(0.0, 1.0,
                                              div_const(low_high_ratio, 3.5))
                         + 0.25 * jlimit(0.0, 1.0, transient_mean * 5.0))

    crest_penalty = jlimit(0.0, 1.0, (f32(1.8) - crest) * f32(1.1))
    harsh_penalty = jlimit(0.0, 1.0, high_energy * 12.0)

    score = 100.0 * (f32(0.30) * punch
                     + 0.25 * richness
                     + 0.25 * clarity
                     + f32(0.20) * width)
    score = score * (f32(0.6) + f32(0.4) * mono_safety)
    score = jlimit(0.0, 100.0, score)

    metrics = {
        "score": score,
        "pre_score": torch.zeros_like(score),
        "post_score": torch.zeros_like(score),
        "emphasis": emphasis,
        "coherence": coherence,
        "synesthesia": synesthesia,
        "punch": punch,
        "richness": richness,
        "clarity": clarity,
        "width": width,
        "mono_safety": mono_safety,
    }
    ema_in = {"onset_rate": onset_rate, "crest_penalty": crest_penalty,
              "harsh_penalty": harsh_penalty}
    return metrics, ema_in


def _ema_update(repetition_ema, fatigue_ema, ema_in):
    """The repetition/fatigue EMA pair, advanced once per block."""
    repetition_ema = repetition_ema + \
        (ema_in["onset_rate"] - repetition_ema) * f32(0.08)
    repetition_density = jlimit(0.0, 1.0, div_const(repetition_ema, 12.0))

    instant_fatigue = jlimit(0.0, 1.0, f32(0.35) * ema_in["crest_penalty"]
                             + f32(0.35) * ema_in["harsh_penalty"]
                             + f32(0.30) * repetition_density)
    fatigue_ema = fatigue_ema + (instant_fatigue - fatigue_ema) * f32(0.06)
    fatigue_risk = jlimit(0.0, 1.0, fatigue_ema)
    return repetition_ema, fatigue_ema, repetition_density, fatigue_risk


def _finalize_metrics(state, s_env, l_env, low_state, high_state, cooldown,
                      transient_accum, onset_count, rms_accum, peak,
                      low_accum, high_accum, side_accum, mid_accum,
                      corr_accum, l_energy, r_energy, n: int, sr: float):
    """Score formulas from the block accumulators: _lane_stateless composed
    with _ema_update."""
    metrics, ema_in = _lane_stateless(
        s_env, l_env, low_state, high_state, cooldown, transient_accum,
        onset_count, rms_accum, peak, low_accum, high_accum, side_accum,
        mid_accum, corr_accum, l_energy, r_energy, n, sr)
    repetition_ema, fatigue_ema, repetition_density, fatigue_risk = \
        _ema_update(state["repetition_ema"], state["fatigue_ema"], ema_in)

    new_state = {
        "short_env": s_env,
        "long_env": l_env,
        "low_state": low_state,
        "high_state": high_state,
        "repetition_ema": repetition_ema,
        "fatigue_ema": fatigue_ema,
        "onset_cooldown": cooldown,
    }
    metrics = dict(metrics)
    metrics["repetition_density"] = repetition_density
    metrics["fatigue_risk"] = fatigue_risk
    return new_state, metrics
