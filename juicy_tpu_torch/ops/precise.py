"""Drift-pinned float32 transcendentals, PyTorch port of juicy_tpu/ops/precise.py.

Plain f32 Horner polynomials with exact integer bit manipulation for the
exponent. Every function is bit-identical to the numpy path of the JAX
package's module (its jax-free oracle): the same f32 constants, the same
operation order, one rounding per operation. The CUDA kernels carry the same
formulas in ``csrc/precise.cuh``.

Two PyTorch habits would break that and are avoided here:
  * ``c / tensor`` with a Python scalar ``c`` runs as ``reciprocal() * c``;
  * on CUDA, ``tensor / c`` with a host scalar ``c`` runs as a multiply by the
    reciprocal.
Division by a constant therefore goes through :func:`div_const`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32


def f32(v) -> float:
    """A Python float holding ``v`` rounded once to float32 (exact in f32
    arithmetic whatever precision PyTorch picks for a Python scalar)."""
    return float(np.float32(v))


def as_f32(x) -> torch.Tensor:
    """A float32 tensor for ``x``; tensors keep their device, other values
    land on the CPU."""
    if isinstance(x, torch.Tensor):
        if x.dtype != F32:
            raise TypeError(f"expected float32, got {x.dtype}")
        return x
    return torch.tensor(np.float32(x), dtype=F32)


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on any device (see the module note)."""
    return torch.div(x, torch.full((), f32(c), dtype=F32, device=x.device))


def rdiv_const(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` as an IEEE division on any device."""
    return torch.div(torch.full((), f32(c), dtype=F32, device=x.device), x)


# Taylor coefficients in float32 (exact rationals rounded once).
_EXP_C = [f32(1.0 / math.factorial(k)) for k in range(19)]          # deg 18
_COS_C = [f32((-1.0) ** k / math.factorial(2 * k)) for k in range(11)]  # deg 20
_SIN_C = [f32((-1.0) ** k / math.factorial(2 * k + 1)) for k in range(7)]  # deg 13
_PI = f32(3.14159265358979323846)
_TWO_PI = f32(2.0 * 3.14159265358979323846)
_HALF_PI = f32(0.5 * 3.14159265358979323846)
_LOG2E = f32(1.4426950408889634)
_SQRT2 = f32(math.sqrt(2.0))
# 2^r = exp(r·ln2), Taylor degree 8 on r ∈ [−0.5, 0.5]
_EXP2_C = [f32(math.log(2.0) ** k / math.factorial(k)) for k in range(9)]
# log2(m) = (2/ln2)·atanh(s), s = (m−1)/(m+1)
_LOG2_C = [f32(2.0 / math.log(2.0) / (2 * k + 1)) for k in range(6)]
_TWO_LOG2E = f32(np.float32(2.0) * np.float32(_LOG2E))


def _horner(coeffs, x):
    acc = coeffs[-1]
    for c in coeffs[-2::-1]:
        acc = acc * x + c
    return acc


def _f2i(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _i2f(i: torch.Tensor) -> torch.Tensor:
    return i.view(F32)


def _rint(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest, ties to even (as np.rint and CUDA rintf)."""
    return torch.round(x)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.clamp(x, f32(lo), f32(hi))


def exp32(x):
    """exp(x) for x ∈ [−2.5, 0], f32 Horner."""
    return _horner(_EXP_C, as_f32(x))


def cos32(z):
    """cos(z) for |z| ≤ 2.9, f32 even Horner in u = z²."""
    z = as_f32(z)
    return _horner(_COS_C, z * z)


def exp32_narrow(x):
    """exp(x) for x ∈ [−0.7, 0]: the degree-9 truncation of exp32's Taylor
    series (motion's per-sample cutoff coefficient)."""
    return _horner(_EXP_C[:10], as_f32(x))


def sin32(x):
    """sin(x) for |x| ≤ 7.2: branch-free reduction to [−π, π], a fold to
    [−π/2, π/2], then an odd Horner polynomial of degree 13."""
    x = as_f32(x)
    x = torch.where(x > _PI, x - _TWO_PI, x)
    x = torch.where(x > _PI, x - _TWO_PI, x)
    x = torch.where(x < -_PI, x + _TWO_PI, x)
    x = torch.where(x < -_PI, x + _TWO_PI, x)
    x = torch.where(x > _HALF_PI, _PI - x, x)
    x = torch.where(x < -_HALF_PI, -_PI - x, x)
    return x * _horner(_SIN_C, x * x)


def onepole_coeff32(freq_hz, sr, max_hz: float = None):
    """1 − exp(−2π·f/sr) for a per-sample cutoff; the narrow exp when the
    caller's cutoff is bounded by `max_hz` and 2π·max_hz/sr ≤ 0.7."""
    arg = div_const(-_TWO_PI * as_f32(freq_hz), sr)
    if max_hz is not None and onepole_narrow(max_hz, sr):
        return 1.0 - exp32_narrow(arg)
    return 1.0 - exp32(arg)


def onepole_narrow(max_hz: float, sr: float) -> bool:
    """Whether a cutoff bounded by `max_hz` keeps onepole_coeff32's argument
    inside exp32_narrow's domain (2π·max_hz/sr ≤ 0.7)."""
    return _TWO_PI * float(max_hz) / float(sr) <= 0.7


def exp2_32(x):
    """2^x for |x| ≤ 125: exact exponent scale via int bits, degree-8 f32
    Horner for the fractional part."""
    x = _clip(as_f32(x), -125.0, 125.0)
    k = _rint(x)
    r = x - k
    acc = _horner(_EXP2_C, r)
    two_k = _i2f((k.to(torch.int32) + 127) << 23)
    return acc * two_k


def log2_32(x):
    """log2(x) for normal positive x: exact exponent extraction plus an
    atanh-series mantissa on [√2/2, √2]."""
    bits = _f2i(as_f32(x))
    e = ((bits >> 23) & 0xFF) - 127
    m = _i2f((bits & 0x7FFFFF) | 0x3F800000)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = e + big.to(torch.int32)
    s = (m - 1.0) / (m + 1.0)
    acc = _horner(_LOG2_C, s * s)
    return e.to(F32) + s * acc


def pow32(a, b):
    """a^b for a > 0 via exp2(b·log2 a)."""
    return exp2_32(as_f32(b) * log2_32(a))


def tanh32(x):
    """tanh(x) as sign(x)·(1 − 2/(e^{2|x|} + 1)), saturating exactly to ±1
    beyond |x| > 9.1."""
    x = as_f32(x)
    ax, sign = torch.abs(x), torch.sign(x)
    e2 = exp2_32(ax * _TWO_LOG2E)
    t = 1.0 - rdiv_const(2.0, e2 + 1.0)
    t = torch.where(ax > f32(9.1), 1.0, t)
    return sign * t
