"""Inputs for the finalize's repetition/fatigue EMA walk (``ema_scan``) and a
bit-level comparison, shared by the CPU tests and the CUDA tests (this
module imports no JAX). The CUDA tests import it as ``ema_cases``, from
the tests' own directory on ``sys.path``, since a package named ``tests``
installed elsewhere can shadow ``tests.ema_cases``; the CPU tests as
``tests.ema_cases``, as their JAX subprocess imports them."""

import torch

#: analyzers per chain (each with a pre and a post lane)
ANALYZERS = 7


def ema_inputs(nb, batch, device="cpu", seed=0):
    """(rep, fat [7, B], onset_rate, crest_penalty, harsh_penalty
    [nb, 14, B]) in the ranges the finalize gives (onset rates up to 40/s,
    penalties in [0, 1], a few below), seeded, with a NaN, +inf and -inf
    among the inputs and a NaN in the seed state: each poisons its own
    (analyzer, clip) walk from its step on."""
    g = torch.Generator().manual_seed(seed)
    lanes = 2 * ANALYZERS
    rep = torch.rand((ANALYZERS, batch), generator=g) * 3.0
    fat = torch.rand((ANALYZERS, batch), generator=g)
    onset = torch.rand((nb, lanes, batch), generator=g) * 40.0
    crest = torch.rand((nb, lanes, batch), generator=g) * 1.1 - 0.1
    harsh = torch.rand((nb, lanes, batch), generator=g)
    last = nb - 1
    onset[last // 2, 1, 0] = float("nan")
    onset[last, 2, (batch - 1) // 2] = float("inf")
    crest[0, 9, batch - 1] = float("-inf")
    harsh[last, 12, batch // 3] = float("nan")
    rep[5, batch // 2] = float("nan")
    return tuple(t.to(device) for t in (rep, fat, onset, crest, harsh))


def assert_same_bits(got, want, what=""):
    """NaN where `want` has NaN, every other value the same float32 bits
    (so -0.0 and 0.0 differ)."""
    assert got.shape == want.shape and got.dtype == want.dtype, what
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32)), what
