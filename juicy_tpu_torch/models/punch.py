"""JuicyPunch, the transient/impact shaper: PyTorch port of
juicy_tpu/models/punch.py.

Per channel, per sample (reference PluginProcessor.cpp:92-111): fast
(τ = 1.5 ms) and slow (τ = 110 ms) one-pole followers of |x|;
``transient = max(0, fast − slow)`` shaped by ``pow32(transient, curve)``
into a punch gain, a sustain gain from the slow envelope, then a
tanh/hard-clip blend, the dry/wet mix and the output gain.

The followers run serially, in the op order of the CUDA stage kernel
(csrc/punch.cuh); everything after them is elementwise.
"""

from __future__ import annotations

import torch

from juicy_tpu_torch.models import base
from juicy_tpu_torch.ops.precise import F32, as_f32, f32, pow32, tanh32
from juicy_tpu_torch.runtime.device import resolve_device
from juicy_tpu_torch.utils.convert import db_to_gain, jlimit, jmap, tau_coeff

PARAMS = (
    base.ParamSpec("punch", "Punch", 0.0, 1.5, 0.9),
    base.ParamSpec("sustain", "Sustain", 0.0, 1.5, 0.35),
    base.ParamSpec("slam", "Slam", 0.0, 1.0, 0.65),
    base.ParamSpec("clip", "Clip", 0.0, 1.0, 0.25),
    base.mix_param(1.0),
    base.output_param(-24.0, 18.0, -4.0),
    base.juiciness_param(),
)

# Reference cpp:18-24.
PRESETS = (
    ("Solar Snap",     dict(punch=0.9, sustain=0.35, slam=0.65, clip=0.25, mix=1.0,  output=-4.0)),
    ("Crater Impact",  dict(punch=1.4, sustain=0.2,  slam=0.95, clip=0.65, mix=1.0,  output=-8.0)),
    ("Elastic Slam",   dict(punch=1.1, sustain=0.8,  slam=0.8,  clip=0.4,  mix=0.85, output=-6.0)),
    ("Steel Bounce",   dict(punch=0.7, sustain=0.55, slam=0.45, clip=0.1,  mix=0.75, output=-2.0)),
    ("Apocalypse Tap", dict(punch=1.5, sustain=1.1,  slam=1.0,  clip=1.0,  mix=1.0,  output=-12.0)),
)


def init(sr: float, channels: int, batch_shape=(), device=None):
    """Per-channel fast/slow envelope states, zeroed: [*batch_shape, C] on
    `device` (None is the card)."""
    del sr
    dev = resolve_device(device)
    z = torch.zeros((*batch_shape, channels), dtype=F32, device=dev)
    return {"fast_env": z, "slow_env": z.clone()}


def env_coeffs(sr):
    """Fast/slow follower coefficients (cpp:83-84) as f32 Python floats."""
    return float(tau_coeff(0.0015, sr)), float(tau_coeff(0.110, sr))


def shape_consts(params, b=lambda v: v):
    """The shaper's constants from params (cpp:99-110), each rounded as the
    per-sample formulas round it; `b` puts a param on the audio's device
    and broadcasts a batched one against the audio. The stage kernel takes
    the same values (kernels/stage_kernels.py)."""
    slam, clip = b(params["slam"]), b(params["clip"])
    drive = 1.0 + clip * 8.0 + slam * 4.0
    return dict(
        curve_exp=jmap(slam, 0.95, 0.55),
        punch_k=b(params["punch"]) * 12.0 + slam * 22.0,
        sustain_k=b(params["sustain"]) * 4.0 + slam * f32(1.5),
        drive=drive, tanh_drive=tanh32(drive), clip=clip,
        hard_k=1.0 + clip * 2.0, mix=b(params["mix"]),
        out_gain=b(db_to_gain(params["output"])))


def punch_shape(dry, f_env, s_env, k):
    """Stateless per-sample shaping after the envelopes (cpp:99-110) with
    the constants `k` of :func:`shape_consts`; rank-polymorphic. The soft
    clip stays a true division by tanh32(drive)."""
    transient = torch.clamp(f_env - s_env, min=0.0)
    punch_gain = 1.0 + k["punch_k"] * pow32(transient, k["curve_exp"])
    sustain_gain = 1.0 + k["sustain_k"] * \
        torch.clamp(s_env - transient * f32(0.6), min=0.0)
    wet = dry * punch_gain * sustain_gain
    soft = torch.div(tanh32(wet * k["drive"]), k["tanh_drive"])
    hard = jlimit(-0.95, 0.95, wet * k["hard_k"])
    wet = soft + k["clip"] * (hard - soft)
    return (dry + k["mix"] * (wet - dry)) * k["out_gain"]


def follow(adry, fast, slow, fast_c: float, slow_c: float):
    """The two linear followers env' = (1 − c)·|x| + c·env, serially over
    the last axis of `adry`. Returns (fast [..., N], slow [..., N])."""
    one_f, one_s = f32(1.0 - fast_c), f32(1.0 - slow_c)
    f_env, s_env = torch.empty_like(adry), torch.empty_like(adry)
    for t in range(adry.shape[-1]):
        a = adry[..., t]
        fast = one_f * a + fast_c * fast
        slow = one_s * a + slow_c * slow
        f_env[..., t], s_env[..., t] = fast, slow
    return f_env, s_env


def process(params, carry, block, sr: float):
    """block [..., C, N] → (out, carry')."""
    dry = as_f32(block)
    fast_c, slow_c = env_coeffs(sr)
    f_env, s_env = follow(torch.abs(dry), carry["fast_env"],
                          carry["slow_env"], fast_c, slow_c)
    out = punch_shape(dry, f_env, s_env, shape_consts(
        params, lambda v: base.bcast_param(v, dry, 2)))
    return out, {"fast_env": f_env[..., -1], "slow_env": s_env[..., -1]}


base.register(base.ProcessorDef(
    name="punch",
    title="Juicy Punch",
    code="JPCH",
    params=PARAMS,
    presets=PRESETS,
    init=init,
    process=process,
))
