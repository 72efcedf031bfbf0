"""LCG noise with the reference's exact integer semantics, PyTorch port of
juicy_tpu/ops/noise.py.

The reference advances a 32-bit LCG ``rng = 1664525·rng + 1013904223`` once
per sample (JuicyTexture/PluginProcessor.cpp:239). An LCG is an affine map
on u32, so the k-th state is ``A_k·rng_0 + B_k (mod 2³²)``: a block's draws
come out in parallel, bit-exact with the serial loop.

PyTorch's uint32 support is partial, so the port carries a u32 value in an
int64 tensor (the *u32 carrier*) and masks with ``& 0xFFFFFFFF`` after every
multiply-add. One LCG step multiplies by a 21-bit constant and stays below
2⁵³. A jump multiplies two u32 values, whose product would overflow int64,
so :func:`mul_u32` splits the multiplier into 16-bit halves.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from juicy_tpu_torch.ops.precise import F32, f32

LCG_A = 1664525
LCG_C = 1013904223
MASK = 0xFFFFFFFF


@lru_cache(maxsize=64)
def _jump_coefficients(n: int):
    """(A_k, B_k) for k = 1..n such that rng_k = A_k·rng_0 + B_k (mod 2³²),
    as uint32 numpy arrays."""
    a = np.empty(n, dtype=np.uint32)
    b = np.empty(n, dtype=np.uint32)
    ak, bk = 1, 0
    for k in range(n):                    # python ints, masked mod 2³²
        ak = (ak * LCG_A) & MASK
        bk = (bk * LCG_A + LCG_C) & MASK
        a[k] = ak
        b[k] = bk
    return a, b


def jump(n: int):
    """(A_n, B_n) as Python ints: n sequential advances in one affine map."""
    if n == 0:
        return 1, 0
    a, b = _jump_coefficients(n)
    return int(a[n - 1]), int(b[n - 1])


def mul_u32(x: torch.Tensor, a) -> torch.Tensor:
    """(x · a) mod 2³² for u32 carriers `x` and `a` (tensor or int), with
    every intermediate below 2⁴⁹."""
    lo = x * (a & 0xFFFF)
    hi = ((x * (a >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def lcg_step(rng: torch.Tensor) -> torch.Tensor:
    """One LCG advance of a u32 carrier."""
    return (rng * LCG_A + LCG_C) & MASK


def lcg_sequence(rng0: torch.Tensor, n: int) -> torch.Tensor:
    """All n successor states of `rng0`: ``rng0.shape + (n,)``, where
    ``[..., k]`` is the state after k+1 sequential advances."""
    a_np, b_np = _jump_coefficients(n)
    a = torch.from_numpy(a_np.astype(np.int64)).to(rng0.device)
    b = torch.from_numpy(b_np.astype(np.int64)).to(rng0.device)
    return (mul_u32(rng0[..., None], a) + b) & MASK


def lcg_advance(rng0: torch.Tensor, n: int) -> torch.Tensor:
    """The state after exactly n sequential advances (closed form)."""
    a, b = jump(n)
    return (mul_u32(rng0, a) + b) & MASK


def white_from_bits(states: torch.Tensor, shift: int = 8, mask: int = 0xFFFF,
                    scale: float = 1.0 / 32768.0) -> torch.Tensor:
    """LCG states -> floats as the reference maps them, for texture
    ``((rng >> 8) & 0xFFFF)/32768 − 1`` (PluginProcessor.cpp:240). The
    bits fit in 16 bits and `scale` is a power of two: exact."""
    bits = (states >> shift) & mask
    return bits.to(F32) * f32(scale) - 1.0


def u32_to_i32_bits(rng: torch.Tensor) -> torch.Tensor:
    """u32 carrier -> int32 tensor with the same 32 bits (a kernel reads it
    as ``unsigned``)."""
    return torch.where(rng >= 2 ** 31, rng - 2 ** 32, rng).to(torch.int32)


def i32_bits_to_u32(bits: torch.Tensor) -> torch.Tensor:
    """int32 bits -> u32 carrier."""
    return bits.to(torch.int64) & MASK
