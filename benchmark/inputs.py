"""Inputs drawn from the run's seed: the traffic's signal, made on the
device in a few large calls, and the seeded choices of the harness (the
texture material of each clip, the clips the check compares)."""

from __future__ import annotations

import math

import numpy as np


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of the run's `seed` (any whole number)."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *path))


def clicks(sig, batch: int, channels: int, t: int, sr: float, device,
           seed: int):
    """[batch, channels, t] float32: a quiet bed (a sine and noise) and a
    decaying burst every `period_s` from a per-clip offset, so that onsets
    fall inside the blocks at every block boundary's phase."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    period = int(sr * sig["period_s"])
    tt = torch.arange(t, dtype=torch.float32, device=device)
    offset = torch.randint(0, period, (batch, 1, 1), generator=g,
                           device=device).float()
    since = torch.remainder(tt - offset, period)
    burst = torch.exp(-since / sig["decay_samples"]) * sig["burst_gain"] \
        * torch.sin((2 * math.pi * sig["burst_hz"] / sr) * since)
    gain = torch.tensor(sig["channel_gains"][:channels],
                        device=device)[None, :, None]
    bed = sig["bed_gain"] * torch.sin((2 * math.pi * sig["bed_hz"] / sr) * tt)
    x = torch.randn((batch, channels, t), generator=g, device=device)
    x.mul_(sig["noise_gain"]).add_(bed).add_(gain * burst)
    return x.clamp_(-sig["limit"], sig["limit"])


def signal(sig, batch, channels, t, sr, device, seed):
    """The traffic's signal (its `kind` is "clicks")."""
    if sig["kind"] != "clicks":
        raise ValueError(f"signal kind {sig['kind']!r}: the generator makes "
                         f"\"clicks\"")
    return clicks(sig, batch, channels, t, sr, device, seed)
