"""Float32 arithmetic of the plain reference, in NumPy.

Every operation rounds once to float32 (NumPy >= 2 keeps a Python scalar
weak, so ``array_f32 * 0.5`` stays float32). The transcendentals are the
drift-pinned polynomials that the plugins' published numerics fix: Taylor
or atanh series in float32 Horner form with exact exponent bit arithmetic
(exp, exp2, log2, cos, sin, tanh, pow). No fused multiply-add: NumPy's
ufuncs round every multiply and every add.

Constants are ``np.float32`` scalars, never Python floats, wherever they
meet ``np.where``: a Python float there would promote to float64.
"""

from __future__ import annotations

import math

import numpy as np

F = np.float32


def f32(v):
    """`v` rounded once to float32, as an np.float32 scalar."""
    return np.float32(v)


def _horner(coeffs, x):
    acc = coeffs[-1]
    for c in coeffs[-2::-1]:
        acc = acc * x + c
    return acc


_EXP_C = [float(f32(1.0 / math.factorial(k))) for k in range(19)]
_COS_C = [float(f32((-1.0) ** k / math.factorial(2 * k))) for k in range(11)]
_SIN_C = [float(f32((-1.0) ** k / math.factorial(2 * k + 1)))
          for k in range(7)]
PI = f32(3.14159265358979323846)
TWO_PI = f32(2.0 * 3.14159265358979323846)
HALF_PI = f32(0.5 * 3.14159265358979323846)
_LOG2E = f32(1.4426950408889634)
_SQRT2 = f32(math.sqrt(2.0))
_EXP2_C = [float(f32(math.log(2.0) ** k / math.factorial(k)))
           for k in range(9)]
_LOG2_C = [float(f32(2.0 / math.log(2.0) / (2 * k + 1))) for k in range(6)]
_TWO_LOG2E = f32(f32(2.0) * _LOG2E)


def exp32(x):
    """exp(x) for x in [-2.5, 0]: degree-18 Taylor series."""
    return _horner(_EXP_C, x)


def exp32_narrow(x):
    """exp(x) for x in [-0.7, 0]: the degree-9 truncation."""
    return _horner(_EXP_C[:10], x)


def cos32(z):
    """cos(z) for |z| <= 2.9: even series in z*z."""
    return _horner(_COS_C, z * z)


def sin32(x):
    """sin(x) for |x| <= 7.2: reduced to [-pi/2, pi/2], odd series."""
    x = np.where(x > PI, x - TWO_PI, x)
    x = np.where(x > PI, x - TWO_PI, x)
    x = np.where(x < -PI, x + TWO_PI, x)
    x = np.where(x < -PI, x + TWO_PI, x)
    x = np.where(x > HALF_PI, PI - x, x)
    x = np.where(x < -HALF_PI, -PI - x, x)
    return x * _horner(_SIN_C, x * x)


def exp2_32(x):
    """2**x for |x| <= 125: exponent by bits, degree-8 series for the rest."""
    x = np.minimum(np.maximum(x, F(-125.0)), F(125.0))
    k = np.rint(x)
    r = x - k
    acc = _horner(_EXP2_C, r)
    two_k = ((np.asarray(k, np.int32) + 127) << 23).view(np.float32)
    return acc * two_k


def log2_32(x):
    """log2(x) for normal positive x: exponent by bits, atanh series."""
    bits = np.asarray(x, dtype=np.float32).view(np.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x7FFFFF) | 0x3F800000).view(np.float32)
    big = m > _SQRT2
    m = np.where(big, m * F(0.5), m)
    e = e + big.astype(np.int32)
    s = (m - F(1.0)) / (m + F(1.0))
    acc = _horner(_LOG2_C, s * s)
    return e.astype(np.float32) + s * acc


def pow32(a, b):
    """a**b for a > 0."""
    return exp2_32(b * log2_32(a))


def tanh32(x):
    """sign(x) * (1 - 2 / (e**(2|x|) + 1)), exactly +-1 beyond |x| > 9.1."""
    ax, sign = np.abs(x), np.sign(x)
    e2 = exp2_32(ax * _TWO_LOG2E)
    t = F(1.0) - F(2.0) / (e2 + F(1.0))
    t = np.where(ax > F(9.1), F(1.0), t)
    return sign * t


def clamp(x, lo, hi):
    return np.minimum(np.maximum(x, F(lo)), F(hi))


def db_to_gain(db):
    """10**(db / 20) as exp2(db * log2(10) / 20), 0 at or below -100 dB."""
    db = F(db)
    gain = exp2_32(db * F(math.log2(10.0) / 20.0))
    return np.where(db > F(-100.0), gain, F(0.0))


def gain_to_db(gain):
    """20 log10(gain) as (20 / log2 10) log2(gain), floored at -100 dB."""
    safe = np.maximum(gain, F(1e-30))
    db = F(20.0 / math.log2(10.0)) * log2_32(safe)
    return np.where(gain > F(0.0), np.maximum(db, F(-100.0)), F(-100.0))


def jmap(v01, lo, hi):
    """lo + v * (hi - lo), the span rounded once."""
    return F(lo) + v01 * F(F(hi) - F(lo))


def jmap5(v, smin, smax, tmin, tmax):
    t_span = F(F(tmax) - F(tmin))
    s_span = F(F(smax) - F(smin))
    return F(tmin) + t_span * ((v - F(smin)) / s_span)


def onepole_coeff(freq_hz, sr):
    """1 - exp(-2 pi f / sr)."""
    return F(1.0) - exp32((-TWO_PI * F(freq_hz)) / F(sr))


def onepole_coeff_narrow(freq_hz, sr):
    """1 - exp(-2 pi f / sr) through the degree-9 exp (2 pi f / sr <= 0.7)."""
    return F(1.0) - exp32_narrow((-TWO_PI * freq_hz) / F(sr))


def tau_coeff(tau_seconds, sr):
    """exp(-1 / (sr * tau)): an envelope's attack or release."""
    return F(exp32(F(-1.0) / F(sr * tau_seconds)))


# The 32-bit LCG of the plugins' noise and variation draws, on uint32
# arrays (wrapping arithmetic).
LCG_A = 1664525
LCG_C = 1013904223


def lcg_step(r):
    return (r * np.uint32(LCG_A) + np.uint32(LCG_C)).astype(np.uint32)


def lcg_sequence(r0, n: int):
    """The n states after r0 ([..., n]): state k = A_k r0 + B_k (mod 2**32)."""
    a = np.empty(n, np.uint64)
    b = np.empty(n, np.uint64)
    ak, bk = 1, 0
    for k in range(n):
        ak = (ak * LCG_A) & 0xFFFFFFFF
        bk = (bk * LCG_A + LCG_C) & 0xFFFFFFFF
        a[k], b[k] = ak, bk
    r = np.asarray(r0, np.uint64)[..., None]
    return ((r * a + b) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
