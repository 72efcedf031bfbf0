"""Block delay lines as a window carry, PyTorch port of
juicy_tpu/ops/delays.py.

The reference's ring buffer (JuicyWidth's Haas delay,
PluginProcessor.cpp:119-137) becomes a carry of the last D samples written:
reading a whole-sample delay d within a block is a slice of
``cat(window, block)``, and the next window is that concatenation's tail.
"""

from __future__ import annotations

import torch


def block_delay_read(window, x, delay_samples):
    """`x` [..., N] delayed by `delay_samples` (0 ≤ d ≤ D, an int or an int
    tensor broadcasting against x's leading dims), where `window` [..., D]
    holds the previous D samples, oldest first."""
    d_len, n = window.shape[-1], x.shape[-1]
    ext = torch.cat([torch.broadcast_to(window, (*x.shape[:-1], d_len)), x],
                    dim=-1)
    if isinstance(delay_samples, int):
        return ext[..., d_len - delay_samples:d_len - delay_samples + n]
    start = (d_len - delay_samples.to(torch.int64))[..., None]
    idx = start + torch.arange(n, device=x.device)
    return torch.gather(ext, -1, torch.broadcast_to(idx, x.shape))


def update_tail_window(window, x):
    """The last D samples of ``cat(window, x)`` along the last axis."""
    d_len = window.shape[-1]
    ext = torch.cat([torch.broadcast_to(window, (*x.shape[:-1], d_len)), x],
                    dim=-1)
    return ext[..., ext.shape[-1] - d_len:]
