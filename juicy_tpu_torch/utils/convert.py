"""Scalar conversion helpers (JUCE semantics), PyTorch port of
juicy_tpu/utils/convert.py. Every helper goes through the drift-pinned
polynomials of ``ops/precise.py`` and is bit-identical to the JAX package."""

from __future__ import annotations

import math

import numpy as np
import torch

from juicy_tpu_torch.ops.precise import (as_f32, div_const, exp2_32, exp32,
                                         f32, log2_32)

_MINUS_INFINITY_DB = -100.0


def db_to_gain(db):
    """10^(db/20) with the JUCE −100 dB ⇒ 0 gain floor, as
    exp2(db·log2(10)/20)."""
    db = as_f32(db)
    gain = exp2_32(db * f32(math.log2(10.0) / 20.0))
    return torch.where(db > _MINUS_INFINITY_DB, gain, 0.0)


def gain_to_db(gain):
    """20·log10(gain) as (20/log2 10)·log2(gain), floored at −100 dB."""
    gain = as_f32(gain)
    safe = torch.clamp(gain, min=f32(1e-30))
    db = f32(20.0 / math.log2(10.0)) * log2_32(safe)
    return torch.where(gain > 0.0, torch.clamp(db, min=_MINUS_INFINITY_DB),
                       _MINUS_INFINITY_DB)


def jmap(v01, lo, hi):
    """Map a 0..1 value into [lo, hi] (juce::jmap 3-arg form)."""
    span = f32(np.float32(hi) - np.float32(lo))
    return f32(lo) + as_f32(v01) * span


def jmap5(v, smin, smax, tmin, tmax):
    """Map v from [smin, smax] into [tmin, tmax] (juce::jmap 5-arg form)."""
    t_span = f32(np.float32(tmax) - np.float32(tmin))
    s_span = f32(np.float32(smax) - np.float32(smin))
    return f32(tmin) + t_span * div_const(as_f32(v) - f32(smin), s_span)


def jlimit(lo, hi, v):
    """Clamp v into [lo, hi] (juce::jlimit argument order)."""
    return torch.clamp(as_f32(v), f32(lo), f32(hi))


def onepole_coeff(freq_hz, sr):
    """1 − exp(−2π·f/sr): one-pole lowpass smoothing coefficient."""
    two_pi = f32(2.0 * 3.14159265358979323846)
    return 1.0 - exp32(div_const(-two_pi * as_f32(freq_hz), sr))


def tau_coeff(tau_seconds, sr):
    """exp(−1/(sr·τ)): envelope attack/release coefficient."""
    return exp32(np.float32(-1.0) / np.float32(sr * tau_seconds))
