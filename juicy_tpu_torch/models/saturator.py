"""JuicySaturator, PyTorch port of juicy_tpu/models/saturator.py.

Per sample: drive gain → asymmetric skew ``x + a·x²`` → tanh → one-pole tone
lowpass (tone ∈ [0, 1] mapped to 2500..16000 Hz) → output gain → dry/wet mix.
The tone one-pole runs serially (ops/scan_utils.py), in the op order of the
CUDA stage kernel.
"""

from __future__ import annotations

import torch

from juicy_tpu_torch.models import base
from juicy_tpu_torch.ops.precise import F32, as_f32, tanh32
from juicy_tpu_torch.ops.scan_utils import onepole_lowpass
from juicy_tpu_torch.runtime.device import resolve_device
from juicy_tpu_torch.utils.convert import db_to_gain, jmap, onepole_coeff

PARAMS = (
    base.ParamSpec("drive", "Drive (dB)", 0.0, 24.0, 6.0),
    base.ParamSpec("asymmetry", "Asymmetry", -0.5, 0.5, 0.1),
    base.ParamSpec("tone", "Tone", 0.0, 1.0, 0.55),
    base.mix_param(1.0),
    base.output_param(-18.0, 18.0, -3.0),
    base.juiciness_param(),
)

PRESETS = (
    ("Amber Heat",    dict(drive=6.0,  asymmetry=0.1,   tone=0.55, mix=1.0,  output=-3.0)),
    ("Velvet Burn",   dict(drive=11.0, asymmetry=0.2,   tone=0.4,  mix=0.85, output=-6.0)),
    ("Mirror Glow",   dict(drive=8.0,  asymmetry=-0.15, tone=0.75, mix=0.7,  output=-4.0)),
    ("Grain Reactor", dict(drive=18.0, asymmetry=0.35,  tone=0.32, mix=1.0,  output=-10.0)),
    ("Crystal Edge",  dict(drive=4.0,  asymmetry=-0.05, tone=0.9,  mix=0.55, output=-1.0)),
)


def init(sr: float, channels: int, batch_shape=(), device=None):
    """Per-channel tone filter state, zeroed: [*batch_shape, C] on `device`
    (None is the card)."""
    del sr
    return {"tone_state": torch.zeros((*batch_shape, channels), dtype=F32,
                                      device=resolve_device(device))}


def sat_consts(params, sr):
    """Per-block constants, as float32 tensors on the params' device."""
    return dict(
        in_gain=db_to_gain(params["drive"]),
        out_gain=db_to_gain(params["output"]),
        asym=as_f32(params["asymmetry"]),
        mix=as_f32(params["mix"]),
        tone_coeff=onepole_coeff(jmap(params["tone"], 2500.0, 16000.0), sr))


def sat_pre(dry, k, b=lambda v: v):
    """Stateless drive → skew → tanh front; rank-polymorphic."""
    driven = dry * b(k["in_gain"])
    skewed = driven + b(k["asym"]) * driven * driven
    return tanh32(skewed)


def sat_post(dry, toned, k, b=lambda v: v):
    """Output gain and dry/wet mix after the tone filter."""
    wet = toned * b(k["out_gain"])
    return dry + b(k["mix"]) * (wet - dry)


def process(params, carry, block, sr: float):
    """block [..., C, N] → (out, carry'). The per-block constants are built
    on the params' device and moved to the audio's."""
    dry = as_f32(block)
    k = sat_consts(params, sr)
    b = lambda v: base.bcast_param(v, dry, 2)  # noqa: E731
    soft = sat_pre(dry, k, b)
    toned = onepole_lowpass(soft, b(k["tone_coeff"]), carry["tone_state"])
    out = sat_post(dry, toned, k, b)
    return out, {"tone_state": toned[..., -1]}


base.register(base.ProcessorDef(
    name="saturator",
    title="Juicy Saturator",
    code="JSAT",
    params=PARAMS,
    presets=PRESETS,
    init=init,
    process=process,
))
