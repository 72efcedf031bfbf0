"""First-order linear recurrences along the last axis, PyTorch port of
juicy_tpu/ops/scan_utils.py.

The JAX package solves these as associative scans (O(log N) depth on the
TPU). Here they run serially, in the reference C++'s op order, which is also
the op order of the CUDA kernels: a plain version that the kernels match bit
for bit. Against the JAX scans they differ by reassociation ulps only.
"""

from __future__ import annotations

import torch

from juicy_tpu_torch.ops.precise import as_f32


def linear_scan(a, b, init):
    """Solve y[n] = a[n]·y[n−1] + b[n] along the last axis, y[−1] = init.

    `a` is a scalar or broadcasts against `b`; `init` broadcasts against
    `b[..., 0]`. Returns all y, shaped like `b`."""
    b = as_f32(b)
    a = torch.broadcast_to(as_f32(a).to(b.device), b.shape)
    y = torch.broadcast_to(as_f32(init), b.shape[:-1])
    out = torch.empty_like(b)
    for i in range(b.shape[-1]):
        y = a[..., i] * y + b[..., i]
        out[..., i] = y
    return out


def onepole_lowpass(x, coeff, init):
    """One-pole smoother y[n] = y[n−1] + coeff·(x[n] − y[n−1]) along the last
    axis. `coeff` is a scalar or broadcasts against `x` (per-sample)."""
    x = as_f32(x)
    c = torch.broadcast_to(as_f32(coeff).to(x.device), x.shape)
    y = torch.broadcast_to(as_f32(init), x.shape[:-1])
    out = torch.empty_like(x)
    for i in range(x.shape[-1]):
        y = y + c[..., i] * (x[..., i] - y)
        out[..., i] = y
    return out


# ---------------------------------------------------------------------------
# Associative forms (the relaxed tier, runtime/relaxed.py). The same
# recurrences solved in O(log N) depth, in the JAX package's operation
# order: the odd/even recursion of ``jax.lax.associative_scan`` step for
# step, so that with the same combine the port rounds as JAX does.
# ---------------------------------------------------------------------------

def associative_scan(fn, elems, dim: int = -1, reverse: bool = False):
    """Inclusive scan of `elems` with the associative `fn` along `dim`.

    `elems` is a tensor or a tuple of tensors of one length along `dim`
    (`dim` counted on the first); ``fn(f, g)`` combines two such (f applied
    first) elementwise. The recursion is ``jax.lax.associative_scan``'s:
    pairs ``[0:-1:2]`` with ``[1::2]`` are combined and scanned recursively
    (the odd outputs); the even outputs combine the odd ones (all but the
    last when the length is even) with ``[2::2]``; the first element leads,
    and the two are interleaved, each value written as ``value + 0`` as
    JAX's pad-and-add interleave writes it (a −0.0 comes out as +0.0)."""
    single = isinstance(elems, torch.Tensor)
    flat = [elems] if single else list(elems)
    dim = dim % flat[0].ndim
    if reverse:
        flat = [torch.flip(e, (dim,)) for e in flat]

    def at(s):
        return (slice(None),) * dim + (s,)

    def combine(a, b):
        if single:
            return [fn(a[0], b[0])]
        return list(fn(tuple(a), tuple(b)))

    def scan(xs):
        n = xs[0].shape[dim]
        if n < 2:
            return xs
        odd = scan(combine([x[at(slice(0, -1, 2))] for x in xs],
                           [x[at(slice(1, None, 2))] for x in xs]))
        heads = odd if n % 2 else [o[at(slice(0, -1))] for o in odd]
        even = combine(heads, [x[at(slice(2, None, 2))] for x in xs])
        outs = []
        for x, ev, od in zip(xs, even, odd):
            shape = list(ev.shape)
            shape[dim] = n
            out = torch.empty(shape, dtype=ev.dtype, device=ev.device)
            torch.add(x[at(slice(0, 1))], 0, out=out[at(slice(0, 1))])
            torch.add(ev, 0, out=out[at(slice(2, None, 2))])
            torch.add(od, 0, out=out[at(slice(1, None, 2))])
            outs.append(out)
        return outs

    outs = scan(flat)
    if reverse:
        outs = [torch.flip(o, (dim,)) for o in outs]
    return outs[0] if single else tuple(outs)


def _affine_compose(f, g):
    """g∘f for affine maps y ↦ a·y + b, f = (a1, b1) applied first."""
    a1, b1 = f
    a2, b2 = g
    return a2 * a1, a2 * b1 + b2


def linear_scan_assoc(a, b, init, dim: int = -1, reverse: bool = False):
    """y[n] = a[n]·y[n−1] + b[n] along `dim`, y[−1] = init, as an
    associative scan (JAX's ``linear_scan``). `a` is a scalar or
    broadcasts against `b`; `init` has `b`'s shape without `dim` (or
    broadcasts against it)."""
    b = as_f32(b)
    a = torch.broadcast_to(as_f32(a).to(b.device), b.shape)
    big_a, big_b = associative_scan(_affine_compose, (a, b), dim=dim,
                                    reverse=reverse)
    init = as_f32(init).to(b.device)
    if init.ndim < b.ndim:
        init = init.unsqueeze(dim)
    return big_a * init + big_b


def onepole_lowpass_assoc(x, coeff, init, dim: int = -1):
    """y[n] = y[n−1] + coeff·(x[n] − y[n−1]) as an associative scan (JAX's
    ``onepole_lowpass``): a = 1 − coeff, b = coeff·x."""
    x = as_f32(x)
    coeff = as_f32(coeff).to(x.device)
    return linear_scan_assoc(1.0 - coeff, coeff * x, init, dim=dim)


def leaky_integrator(x, decay, init, dim: int = -1):
    """The tail integrator y[n] = x[n] + decay·y[n−1], associative."""
    return linear_scan_assoc(decay, x, init, dim=dim)


def _matmul_sum(a, b):
    """Batched a @ b over the last two axes as elementwise products summed
    over k in index order: no FMA contraction on either device."""
    d = a.shape[-1]
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, d):
        acc = acc + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return acc


def _matvec_sum(a, v):
    """Batched a @ v (v [..., d]) summed over k in index order."""
    acc = a[..., :, 0] * v[..., 0:1]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., :, k] * v[..., k:k + 1]
    return acc


def _matrix_affine_compose(f, g):
    """g∘f for maps x ↦ A·x + b (f first): (A2·A1, A2·b1 + b2)."""
    a1, b1 = f
    a2, b2 = g
    return _matmul_sum(a2, a1), _matvec_sum(a2, b1) + b2


def linear_matrix_scan(mats, vecs, init):
    """x[n] = A[n]·x[n−1] + b[n] in O(log N) depth, time first: `mats`
    [N, ..., d, d], `vecs` [N, ..., d], `init` [..., d]; returns x
    [N, ..., d]. JAX's products are einsums, whose summation order is the
    library's; here each is a sum over k in index order, so the two agree
    to reassociation of the sums."""
    mats, vecs = as_f32(mats), as_f32(vecs)
    big_a, big_b = associative_scan(_matrix_affine_compose, (mats, vecs),
                                    dim=0)
    init = as_f32(init).to(vecs.device)
    return _matvec_sum(big_a, torch.broadcast_to(init, big_b.shape)) + big_b
