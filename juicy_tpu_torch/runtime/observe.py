"""Observability: tracing, throughput counters and failure guards. PyTorch
port of juicy_tpu/runtime/observe.py.

The reference has no tracing or sanitizers; its only hygiene is
ScopedNoDenormals (JuicyPunch/PluginProcessor.cpp:67) and JuicyTexture's
runaway protection (auto-gain → DC block → limiter → clamp,
JuicyTexture/PluginProcessor.cpp:252-276). Here:

  * ``trace()``: a ``torch.profiler`` context that writes a Chrome trace
    (``trace.json``, chrome://tracing or Perfetto) into its directory;
  * ``enable_nan_checks()``: raise ``FloatingPointError`` at the first
    operation whose floating output holds a NaN, as ``jax_debug_nans``
    does: a ``TorchDispatchMode`` checks every PyTorch operation's outputs,
    and the hand-written kernels' wrappers check their outputs after each
    launch (``check_kernel_outputs``);
  * ``ThroughputMeter``: per-stage audio-seconds per second, with jsonl;
  * ``validate_block`` / ``sanitize_block``: input checks and NaN/Inf
    guards;
  * ``guarded_step``: wraps a step function, zeroes non-finite outputs and
    returns a per-clip fault flag, rolling the faulted clips' state back.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, Optional

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


class ThroughputMeter:
    """Running audio-sec/sec counters per pipeline stage."""

    def __init__(self, sr: float = 48000.0):
        self.sr = sr
        self.stages: Dict[str, Dict[str, float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, samples: int, batch: int = 1):
        t0 = time.perf_counter()
        yield
        wall = time.perf_counter() - t0
        s = self.stages.setdefault(name, {"audio_s": 0.0, "wall_s": 0.0,
                                          "calls": 0})
        s["audio_s"] += batch * samples / self.sr
        s["wall_s"] += wall
        s["calls"] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {**v, "x_realtime": (v["audio_s"] / v["wall_s"]
                                        if v["wall_s"] else 0.0)}
                for k, v in self.stages.items()}

    def write_jsonl(self, path: str):
        with open(path, "a") as f:
            f.write(json.dumps({"ts": time.time(), **self.report()}) + "\n")


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
