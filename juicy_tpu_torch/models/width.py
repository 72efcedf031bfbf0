"""JuicyWidth, the mid/side widener with a Haas delay: PyTorch port of
juicy_tpu/models/width.py.

Stereo only; mono input passes through unchanged (reference
PluginProcessor.cpp:76-89). Per sample (cpp:104-138): a correlation proxy
``clamp(L·R·12, ±1)``; whenever it dips below −0.1 the block-local width is
multiplied by the mono-safety limit. The shrink accumulates within the block
and restarts from the width param at the next one (cpp:93, 109-112), kept
here as the C++ writes it: repeated multiplications in sample order. Then
the M/S widen, a Haas delay of ``int(sr · haasMs · 0.001)`` whole samples
(the float product truncated toward zero, cpp:92) on the right channel, the
mix and the output gain.

The ring buffer is a window carry of the last D samples of the wet right
channel (ops/delays.py), D = delay_buffer_size(sr).
"""

from __future__ import annotations

import torch

from juicy_tpu_torch.models import base
from juicy_tpu_torch.ops.delays import block_delay_read, update_tail_window
from juicy_tpu_torch.ops.precise import F32, as_f32, f32
from juicy_tpu_torch.ops.shapers import mid_side_decode, mid_side_encode
from juicy_tpu_torch.runtime.device import resolve_device
from juicy_tpu_torch.utils.convert import db_to_gain, jlimit, jmap

PARAMS = (
    base.ParamSpec("width", "Stereo Width", 0.0, 1.0, 0.45),
    base.ParamSpec("haasMs", "Haas Delay (ms)", 0.0, 35.0, 12.0),
    base.ParamSpec("monoSafe", "Mono Safety", 0.0, 1.0, 0.7),
    base.mix_param(1.0),
    base.output_param(-18.0, 18.0, 0.0),
    base.juiciness_param(),
)

# Reference cpp:17-23.
PRESETS = (
    ("Prism Arc",     dict(width=0.45, haasMs=12.0, monoSafe=0.7,  mix=1.0,  output=0.0)),
    ("Outer Halo",    dict(width=0.9,  haasMs=22.0, monoSafe=0.35, mix=1.0,  output=-1.5)),
    ("Studio Spine",  dict(width=0.35, haasMs=8.0,  monoSafe=0.95, mix=0.8,  output=0.0)),
    ("Ribbon Drift",  dict(width=0.7,  haasMs=16.0, monoSafe=0.55, mix=0.65, output=-0.5)),
    ("Monolith Wide", dict(width=1.0,  haasMs=30.0, monoSafe=0.2,  mix=1.0,  output=-3.0)),
)


def delay_buffer_size(sr: float) -> int:
    """The Haas window: the most the read head trails the write head
    (``int(sr·0.035)``, haasMs ≤ 35) plus headroom, rounded up to 8."""
    d = int(sr * 0.035) + 16
    return max(8, (d + 7) // 8 * 8)


def init(sr: float, channels: int, batch_shape=(), device=None):
    """The last D samples of the wet right channel, zeroed:
    [*batch_shape, D] on `device` (None is the card)."""
    del channels
    return {"haas_window": torch.zeros(
        (*batch_shape, delay_buffer_size(sr)), dtype=F32,
        device=resolve_device(device))}


def delay_samples(haas_ms, sr: float) -> torch.Tensor:
    """int(sr · (haasMs · 0.001)) in float32, truncated (cpp:92)."""
    return (f32(sr) * (as_f32(haas_ms) * f32(0.001))).to(torch.int32)


def width_shrink(left, right, width0, limit):
    """The block-local width per sample [..., N]: starting from `width0`,
    multiplied by `limit` at every sample whose correlation proxy dips
    below −0.1 (cpp:109-112), in sample order."""
    corr = jlimit(-1.0, 1.0, left * right * 12.0)
    dips = corr < f32(-0.1)
    w = torch.broadcast_to(width0, left.shape[:-1])
    seq = torch.empty_like(left)
    for t in range(left.shape[-1]):
        w = torch.where(dips[..., t], w * limit, w)
        seq[..., t] = w
    return seq


def process(params, carry, block, sr: float):
    block = as_f32(block)
    if block.shape[-2] < 2:
        return block, carry          # mono passthrough (cpp:76-89)

    def b(v):
        return base.bcast_param(v, block, 1)

    dry_l, dry_r = block[..., 0, :], block[..., 1, :]
    mix, out_gain = b(params["mix"]), b(db_to_gain(params["output"]))
    delay = delay_samples(params["haasMs"], sr).to(block.device)
    if delay.ndim == 0:
        delay = int(delay)

    width_seq = width_shrink(
        dry_l, dry_r, base.bcast_param(params["width"], block, 0),
        base.bcast_param(jmap(params["monoSafe"], 1.0, 0.35), block, 0))
    mid, side = mid_side_encode(dry_l, dry_r)
    wet_l, wet_r_pre = mid_side_decode(mid, side * (1.0 + width_seq))

    # Haas: the right channel reads `delay` samples behind the write head
    wet_r = block_delay_read(carry["haas_window"], wet_r_pre, delay)
    new_window = update_tail_window(carry["haas_window"], wet_r_pre)

    out_l = (dry_l + mix * (wet_l - dry_l)) * out_gain
    out_r = (dry_r + mix * (wet_r - dry_r)) * out_gain
    out = torch.cat([torch.stack([out_l, out_r], dim=-2), block[..., 2:, :]],
                    dim=-2)
    return out, {"haas_window": new_window}


base.register(base.ProcessorDef(
    name="width",
    title="Juicy Width",
    code="JWID",
    params=PARAMS,
    presets=PRESETS,
    init=init,
    process=process,
))
