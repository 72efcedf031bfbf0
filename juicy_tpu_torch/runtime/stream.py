"""Block-streaming helpers: padding, automation curves, metric streams.
PyTorch port of juicy_tpu/runtime/stream.py."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from juicy_tpu_torch.ops.precise import F32


def pad_to_blocks(audio, block_size: int):
    """Zero-pad [..., T] so that T is a multiple of `block_size`; returns
    (padded float32 tensor, T)."""
    audio = torch.as_tensor(audio)
    t = audio.shape[-1]
    rem = t % block_size
    if rem == 0:
        return audio, t
    return torch.nn.functional.pad(audio.to(F32), (0, block_size - rem)), t


def automation_curve(values, num_blocks: int) -> torch.Tensor:
    """A parameter automation curve resampled to one value per block, by
    linear interpolation in float32 as the JAX package does (the host
    writing parameter values between processBlock calls; parameters are
    read once per block, JuicyPunch/PluginProcessor.cpp:74-80)."""
    values = np.asarray(values, np.float32)
    if values.ndim == 0:
        return torch.full((num_blocks,), float(values), dtype=F32)
    idx = np.linspace(0, len(values) - 1, num_blocks)
    return torch.from_numpy(np.interp(idx, np.arange(len(values)), values)
                            .astype(np.float32))


def metrics_to_rows(metrics: Dict[str, torch.Tensor]):
    """[nb]-per-field metrics -> a list of per-block dicts (for JSONL)."""
    keys = sorted(metrics)
    arrs = {k: np.asarray(torch.as_tensor(metrics[k]).cpu()) for k in keys}
    nb = len(next(iter(arrs.values())))
    return [{k: float(arrs[k][i]) for k in keys} for i in range(nb)]
