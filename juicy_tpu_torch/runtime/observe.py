"""Observability: tracing, spans and failure guards. PyTorch port of
juicy_tpu/runtime/observe.py.

The reference has no tracing or sanitizers; its only hygiene is
ScopedNoDenormals (JuicyPunch/PluginProcessor.cpp:67) and JuicyTexture's
runaway protection (auto-gain → DC block → limiter → clamp,
JuicyTexture/PluginProcessor.cpp:252-276). Here:

  * ``trace()``: a ``torch.profiler`` context that writes a Chrome trace
    (``trace.json``, chrome://tracing or Perfetto) into its directory;
  * ``span(name)``: a ``torch.profiler.record_function`` span around a
    phase of the program while a profiler records (``trace()`` or any
    ``torch.profiler.profile``), a shared no-op otherwise; the spans land
    in the profiler's trace beside the device's kernels and copies;
  * ``enable_nan_checks()``: raise ``FloatingPointError`` at the first
    operation whose floating output holds a NaN, as ``jax_debug_nans``
    does: a ``TorchDispatchMode`` checks every PyTorch operation's outputs,
    and the hand-written kernels' wrappers check their outputs after each
    launch (``check_kernel_outputs``);
  * ``validate_block`` / ``sanitize_block``: input checks and NaN/Inf
    guards;
  * ``guarded_step``: wraps a step function, zeroes non-finite outputs and
    returns a per-clip fault flag, rolling the faulted clips' state back.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the body with ``torch.profiler`` (the CPU, and the card when
    there is one) and write its Chrome trace to ``log_dir/trace.json``
    (``log_dir`` defaults to ``juicy_trace`` in the temporary directory).
    Yields `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "juicy_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records the phase `name` as a ``user_annotation``
    span of the profiler's trace (``torch.profiler.record_function``) while
    a profiler records, and that is a shared no-op otherwise: a
    ``record_function`` costs host time even with no profiler on, some
    fifty times the check whether one records. Open it once per phase of
    a call, not per launch."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


# operations whose outputs are uninitialized memory, not results
_UNINITIALIZED = frozenset({"empty", "empty_like", "empty_strided",
                            "new_empty", "new_empty_strided", "resize_"})


def _raise_on_nan(where: str, tensors) -> None:
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_floating_point() \
                and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"invalid value (nan) encountered in "
                                     f"{where}")


class _NanChecks(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALIZED:
            _raise_on_nan(str(func), tree_leaves(out))
        return out


_nan_mode: Optional[_NanChecks] = None


def enable_nan_checks(enabled: bool = True):
    """Raise ``FloatingPointError`` at the first operation whose floating
    output holds a NaN (the sanitizer analog: the hazard left is numeric),
    in the calling thread: every PyTorch operation, and every launch of
    the port's CUDA kernels, checked at its wrapper's outputs. Each check
    reads the output back (a device sync): a debugging switch."""
    global _nan_mode
    if enabled and _nan_mode is None:
        _nan_mode = _NanChecks()
        _nan_mode.__enter__()
    elif not enabled and _nan_mode is not None:
        mode, _nan_mode = _nan_mode, None
        mode.__exit__(None, None, None)


def check_kernel_outputs(name: str, tensors) -> None:
    """With NaN checks on, raise if a floating output of the kernel `name`
    (just launched) holds a NaN; nothing otherwise."""
    if _nan_mode is not None:
        _raise_on_nan(name, tensors)


def validate_block(block, channels: Optional[int] = None):
    """Static validation (the isBusesLayoutSupported analog): a [..., C, N]
    block with `channels` channels, as float32."""
    block = torch.as_tensor(block)
    if block.ndim < 2:
        raise ValueError(f"block must be [..., C, N], got shape "
                         f"{tuple(block.shape)}")
    if channels is not None and block.shape[-2] != channels:
        raise ValueError(f"expected {channels} channels, got "
                         f"{block.shape[-2]}")
    return block.to(torch.float32)


def sanitize_block(block, limit: float = 4.0):
    """NaN/Inf → 0, then |x| hard-limited to `limit`."""
    block = torch.as_tensor(block, dtype=torch.float32)
    block = torch.where(torch.isfinite(block), block, torch.zeros_like(block))
    return torch.clamp(block, -limit, limit)


def guarded_step(step_fn: Callable) -> Callable:
    """Wrap a step function with fault detection.

    The wrapper returns (out, state, metrics, fault), `fault` a per-clip
    bool: True where the raw output held non-finite samples, which are
    zeroed. The state of a faulted clip is rolled back to the state it came
    in with, so a stream can skip a poisoned block and go on."""
    def wrapped(params, state, block):
        block = sanitize_block(validate_block(block))
        out, new_state, metrics = step_fn(params, state, block)
        finite = torch.isfinite(out).all(dim=-1).all(dim=-1)
        fault = ~finite
        out = torch.where(finite[..., None, None], out, torch.zeros_like(out))

        def roll(new, old):
            new = torch.as_tensor(new)
            old = torch.as_tensor(old, device=new.device)
            extra = new.ndim - fault.ndim
            if extra < 0:
                # a leaf the step kept shared across the batch (a scalar
                # advanced once for all clips): made per clip, so each
                # faulted clip gets its own value back and the healthy
                # ones keep the new one
                new = torch.broadcast_to(new, fault.shape + new.shape)
                extra = 0
            old = torch.broadcast_to(old, new.shape)
            mask = fault.to(new.device).reshape(fault.shape + (1,) * extra)
            return torch.where(mask, old, new)

        return out, tree_map(roll, new_state, state), metrics, fault

    return wrapped
