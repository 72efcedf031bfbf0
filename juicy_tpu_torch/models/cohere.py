"""JuicyCohere, the spectral context-fit matcher: PyTorch port of
juicy_tpu/models/cohere.py.

Per block (reference PluginProcessor.cpp:62-118): a mono 3-band energy
analysis through persistent 220/2400 Hz one-poles; in learn mode an EMA of
the band targets (α = 0.02 per block); the context-fit readout
``100 − meanAbsDbError·10``; per-band gains
``clamp(pow32(target/energy, 0.25·match), 0.5, 1.8)``; then per channel a
re-split with those gains and a tail ``tail = matched + tail·decay``.

Quirk kept (PARITY.md §2.2): the per-channel split filters start from zero
every block (cpp:103-104), while the analysis filters persist. Both loops
run serially in the C++ op and summation order.
"""

from __future__ import annotations

import torch

from juicy_tpu_torch.models import base
from juicy_tpu_torch.ops.precise import F32, as_f32, div_const, f32, pow32
from juicy_tpu_torch.runtime.device import resolve_device
from juicy_tpu_torch.utils.convert import (db_to_gain, gain_to_db, jlimit,
                                           onepole_coeff)

PARAMS = (
    base.ParamSpec("match", "Spectral Match", 0.0, 1.0, 0.65),
    base.ParamSpec("learn", "Learn Target", 0.0, 1.0, 0.0, boolean=True),
    base.ParamSpec("tail", "Tail Coherence", 0.0, 1.0, 0.45),
    base.ParamSpec("decay", "Tail Decay", 0.1, 0.95, 0.65),
    base.mix_param(1.0),
    base.output_param(-18.0, 18.0, 0.0),
    base.ParamSpec("contextfit", "Context Fit", 0.0, 100.0, 0.0, readonly=True),
    base.juiciness_param(),
)

PRESETS = ()  # the reference declares no presets for Cohere


def init(sr: float, channels: int, batch_shape=(), device=None):
    """Learned band targets (0.2, PluginProcessor.h:55-57), the analysis
    one-poles, per-channel tails [*batch_shape, C] and the last context
    fit; `device` None is the card."""
    del sr
    dev = resolve_device(device)

    def full(v):
        return torch.full(batch_shape, v, dtype=F32, device=dev)

    return {
        "target_low": full(f32(0.2)), "target_mid": full(f32(0.2)),
        "target_high": full(f32(0.2)),
        "analysis_low": full(0.0), "analysis_high": full(0.0),
        "tail": torch.zeros((*batch_shape, channels), dtype=F32, device=dev),
        "context_fit": full(0.0),
    }


def band_coeffs(sr):
    """The 220 Hz and 2400 Hz one-pole coefficients as f32 Python floats."""
    return float(onepole_coeff(220.0, sr)), float(onepole_coeff(2400.0, sr))


def analysis(mono, lo, hi, sr):
    """Mono 3-band analysis (cpp:62-76), serially: (low state, high state,
    low/mid/high energy sums)."""
    low_c, high_c = band_coeffs(sr)
    le = me = he = torch.zeros_like(mono[..., 0])
    for t in range(mono.shape[-1]):
        m = mono[..., t]
        lo = lo + low_c * (m - lo)
        hi = hi + high_c * (m - hi)
        high_v = m - hi
        mid_v = m - lo - high_v
        le = le + lo * lo
        me = me + mid_v * mid_v
        he = he + high_v * high_v
    return lo, hi, le, me, he


def block_gains(carry, low_e, mid_e, high_e, params):
    """The learn EMA, the context fit and the band gains (cpp:78-96).
    Returns (targets', context_fit, (low, mid, high gain), feedback)."""
    dev = low_e.device
    match_amt = as_f32(params["match"]).to(dev)
    learn = as_f32(params["learn"]).to(dev) > 0.5
    eps = f32(1.0e-6)

    def ema(t, e):
        return torch.where(learn, t + (e - t) * f32(0.02), t)

    t_low = ema(carry["target_low"], low_e)
    t_mid = ema(carry["target_mid"], mid_e)
    t_high = ema(carry["target_high"], high_e)

    def err(e, t):
        return torch.abs(gain_to_db((e + eps) / (t + eps)))

    deviation = div_const(err(low_e, t_low) + err(mid_e, t_mid)
                          + err(high_e, t_high), 3.0)
    context_fit = jlimit(0.0, 100.0, 100.0 - deviation * 10.0)

    expo = 0.25 * match_amt

    def comp(t, e):
        return jlimit(0.5, 1.8, pow32((t + eps) / (e + eps), expo))

    gains = (comp(t_low, low_e), comp(t_mid, mid_e), comp(t_high, high_e))
    fb = jlimit(0.0, 0.93, as_f32(params["decay"]).to(dev))
    return (t_low, t_mid, t_high), context_fit, gains, fb


def render(dry, tail, gains, fb, tail_amt, sr):
    """Per-channel re-split and recombine (cpp:99-118) over [..., C, N],
    the split filters from zero (the per-block reset); `gains`, `fb` and
    `tail_amt` broadcast against [..., C]. Returns (wet, tail')."""
    low_c, high_c = band_coeffs(sr)
    low_g, mid_g, high_g = gains
    tail_k = tail_amt * f32(0.35)
    lp_a = lp_b = torch.zeros_like(dry[..., 0])
    wet = torch.empty_like(dry)
    for t in range(dry.shape[-1]):
        d = dry[..., t]
        lp_a = lp_a + low_c * (d - lp_a)
        lp_b = lp_b + high_c * (d - lp_b)
        low_v = lp_a * low_g
        high_v = (d - lp_b) * high_g
        mid_v = (d - lp_a - (d - lp_b)) * mid_g
        matched = low_v + mid_v + high_v
        tail = matched + tail * fb
        wet[..., t] = matched + tail_k * tail
    return wet, tail


def process(params, carry, block, sr: float):
    block = as_f32(block)
    channels, n = block.shape[-2:]

    def b(v, dims=1):
        return base.bcast_param(v, block, dims)

    mono = 0.5 * (block[..., 0, :] + block[..., min(1, channels - 1), :])
    batch = mono.shape[:-1]
    a_low, a_high, low_e, mid_e, high_e = analysis(
        mono, torch.broadcast_to(carry["analysis_low"], batch),
        torch.broadcast_to(carry["analysis_high"], batch), sr)
    inv_n = f32(1.0 / max(1, n))
    low_e, mid_e, high_e = low_e * inv_n, mid_e * inv_n, high_e * inv_n

    (t_low, t_mid, t_high), context_fit, gains, fb = block_gains(
        carry, low_e, mid_e, high_e, params)
    wet, tail = render(block, torch.broadcast_to(carry["tail"], (*batch, channels)),
                       tuple(g[..., None] for g in gains), b(fb),
                       b(params["tail"]), sr)
    mix, out_gain = b(params["mix"], 2), b(db_to_gain(params["output"]), 2)
    out = (block + mix * (wet - block)) * out_gain
    return out, {"target_low": t_low, "target_mid": t_mid,
                 "target_high": t_high, "analysis_low": a_low,
                 "analysis_high": a_high, "tail": tail,
                 "context_fit": context_fit}


def finalize_metrics(params, pre, post, carry=None):
    """The default metrics plus the block's context fit (cpp:86-92)."""
    del params
    m = dict(post)
    m["pre_score"] = pre["score"]
    m["post_score"] = post["score"]
    if carry is not None:
        m["context_fit"] = carry["context_fit"]
    return m


base.register(base.ProcessorDef(
    name="cohere",
    title="Juicy Cohere",
    code="JCOH",
    params=PARAMS,
    presets=PRESETS,
    init=init,
    process=process,
    finalize_metrics=finalize_metrics,
))
