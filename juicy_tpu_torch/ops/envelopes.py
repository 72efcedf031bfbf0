"""Attack/release envelope followers, PyTorch port of
juicy_tpu/ops/envelopes.py.

The follower branches on ``x[n] > env[n−1]`` per sample (reference
src/shared/JuicinessAnalyzer.cpp:24-29), so it has no exact associative
form. :func:`ar_envelope` and :func:`ar_envelope_final` run it serially;
:func:`ar_envelope_relaxed` is the relaxed tier's block-parallel
approximation (runtime/relaxed.py): the branch pattern is fixed from the
previous iterate and the then linear recurrence is solved as an
associative scan.
"""

from __future__ import annotations

import torch

from juicy_tpu_torch.ops.precise import as_f32
from juicy_tpu_torch.ops.scan_utils import linear_scan_assoc


def _serial(x, attack_coeff, release_coeff, init, dim, keep):
    x_t = as_f32(x).movedim(dim, 0)
    atk = as_f32(attack_coeff).to(x_t.device)
    rel = as_f32(release_coeff).to(x_t.device)
    env = torch.broadcast_to(as_f32(init).to(x_t.device), x_t.shape[1:])
    out = torch.empty_like(x_t) if keep else None
    for i in range(x_t.shape[0]):
        xi = x_t[i]
        c = torch.where(xi > env, atk, rel)
        env = (1.0 - c) * xi + c * env
        if keep:
            out[i] = env
    return out.movedim(0, dim) if keep else env


def ar_envelope(x, attack_coeff, release_coeff, init, dim: int = -1):
    """env[n] = (1−c)·x[n] + c·env[n−1], c = attack if x[n] > env[n−1]
    else release, serially along `dim`. Returns every env (x's shape);
    `init` has x's shape without `dim`."""
    return _serial(x, attack_coeff, release_coeff, init, dim, keep=True)


def ar_envelope_final(x, attack_coeff, release_coeff, init, dim: int = -1):
    """:func:`ar_envelope`'s last value only."""
    return _serial(x, attack_coeff, release_coeff, init, dim, keep=False)


def ar_envelope_relaxed(x, attack_coeff, release_coeff, init, dim: int = -1,
                        iters: int = 2):
    """The follower in O(iters·log N) depth: a first pass with the release
    coefficient everywhere, then `iters` passes (at least one) that take
    c[n] = attack where x[n] exceeds the previous iterate's env[n−1], each
    solved as an associative linear scan. Exact (to reassociation) when
    attack == release."""
    x_t = as_f32(x).movedim(dim, 0)
    atk = as_f32(attack_coeff).to(x_t.device)
    rel = as_f32(release_coeff).to(x_t.device)
    init = as_f32(init).to(x_t.device)
    env = linear_scan_assoc(rel, (1.0 - rel) * x_t, init, dim=0)
    for _ in range(max(1, iters)):
        prev = torch.cat([torch.broadcast_to(init, x_t.shape[1:])[None],
                          env[:-1]], dim=0)
        c = torch.where(x_t > prev, atk, rel)
        env = linear_scan_assoc(c, (1.0 - c) * x_t, init, dim=0)
    return env.movedim(0, dim)
