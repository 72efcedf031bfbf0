"""The traced stretch of a `--trace 1` run: a few consecutive batches in the
window under ``torch.profiler``, read back from its Chrome trace.

``Stretch`` records the batches (the benchmark's own spans: each batch,
and the host time of each call into the program), then ``read()`` parses
the trace into what the per-layer metric readers take (``Trace``): the
device's operations (kernels, copies, fills) with their times, which of
them the port's own CUDA library launched, the host's launch calls and
its operators, the stretch's bounds, and the program's spans with the
launch behind each device operation (read by benchmark/spans.py).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")


@dataclass
class Trace:
    """What a metric reader sees. Times in microseconds on the trace's
    clock; `batches` the number of batches traced; `dispatch_s` the host
    time of each traced call into the program; `cell` the cell's context
    (configuration, traffic, the work per block); `spans` every user
    annotation as (name, tid, start, end); `launched` for each entry of
    `device` the (tid, ts) of the call that launched it, or None where the
    trace holds none (``attach``)."""
    start: float
    end: float
    batches: int
    device: list          # (name, start, end, from the port's library)
    chip: list            # the device index of each entry of `device`
    launches: int
    host_ops: list        # (name, start, end): the host's operators
    dispatch_s: list
    cell: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)
    launched: list = field(default_factory=list)

    @property
    def seconds(self):
        return (self.end - self.start) * 1e-6

    def busy_intervals(self, chip=None):
        """The union of the devices' operation intervals (of one `chip`
        where given), clipped to the stretch, as sorted disjoint (start,
        end) pairs."""
        spans = sorted((max(s, self.start), min(e, self.end))
                       for (_n, s, e, _lib), k in zip(self.device, self.chip)
                       if e > self.start and s < self.end
                       and chip in (None, k))
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_seconds(self):
        """Seconds in which an operation ran on a chip, averaged over the
        run's chips (``cell["chips"]``)."""
        chips = sorted(set(self.chip))
        total = sum(e - s for k in chips
                    for s, e in self.busy_intervals(k)) * 1e-6
        return total / max(int(self.cell.get("chips", 1)), len(chips), 1)


class Stretch:
    """Profiles `count` consecutive batches of a window: call
    ``batch(fn)`` for each; ``fn`` makes the call into the program and
    returns its result; the batch ends at `sync()`, which waits for every
    device the run uses."""

    def __init__(self, count: int, sync):
        import torch

        self.count, self.sync = count, sync
        self.dispatch_s = []
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()

    def batch(self, call):
        import torch

        with torch.profiler.record_function("bench.batch"):
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.dispatch"):
                result = call()
            self.dispatch_s.append(time.perf_counter() - t0)
            self.sync()
        return result

    def done(self) -> bool:
        return len(self.dispatch_s) >= self.count

    def close(self):
        self._prof.__exit__(None, None, None)

    def read(self, cell) -> Trace:
        """Parse the stretch's trace (written to a temporary file and
        removed)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return parse(events, len(self.dispatch_s), self.dispatch_s, cell)


def _by_tid(ops):
    out = {}
    for e in ops:
        out.setdefault(e.get("tid"), []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


class _Cover:
    """Whether a time lies inside any of a set of intervals."""

    def __init__(self, intervals):
        intervals = sorted(intervals)
        self.starts = [s for s, _e in intervals]
        self.reach, top = [], float("-inf")
        for _s, e in intervals:
            top = max(top, e)
            self.reach.append(top)

    def holds(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.reach[i] >= t


def parse(events, batches, dispatch_s, cell) -> Trace:
    """A Trace from Chrome trace events, the program's spans attached. The
    stretch runs from the first traced batch's start to the last one's
    end. A device operation counts as the port's own when the launch that
    made it ran outside every PyTorch operator on its thread (the library
    is called by ctypes)."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") == "bench.batch"]
    if not spans:
        raise RuntimeError("the trace holds no traced batch")
    start = min(float(e["ts"]) for e in spans)
    end = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op"]
    inside = {tid: _Cover(v) for tid, v in _by_tid(ops).items()}
    launches, outside = 0, set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("cuda_runtime",
                                                       "cuda_driver"):
            continue
        name = e.get("name", "")
        ts = float(e["ts"])
        if not name.startswith(LAUNCH_PREFIXES) or not start <= ts <= end:
            continue
        launches += 1
        cover = inside.get(e.get("tid"))
        if cover is None or not cover.holds(ts):
            outside.add((e.get("args") or {}).get("correlation"))
    device, chip = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        args = e.get("args") or {}
        device.append((e.get("name", ""), s, s + float(e.get("dur", 0.0)),
                       e.get("cat") == "kernel"
                       and args.get("correlation") in outside))
        chip.append(args.get("device", e.get("pid")))
    host = [(e.get("name", ""), float(e["ts"]),
             float(e["ts"]) + float(e["dur"])) for e in ops]
    tr = Trace(start, end, batches, device, chip, launches, host,
               list(dispatch_s), dict(cell))
    attach(tr, events)
    return tr


def attach(tr, events) -> None:
    """Set `tr.spans` and `tr.launched` from the Chrome trace `events` that
    `tr` was parsed from (its device operations are the events of
    DEVICE_CATS, in order). The program's spans
    (``juicy_tpu_torch/runtime/observe.py::span``) reach the trace as
    ``user_annotation`` events on the device's clock; each device
    operation's launch (the CUDA runtime or driver call with its
    correlation id) runs on the thread of the span it was issued in."""
    calls, spans, launched = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "user_annotation":
            s = float(e["ts"])
            spans.append((e.get("name", ""), e.get("tid"), s,
                          s + float(e["dur"])))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                calls[corr] = (e.get("tid"), float(e["ts"]))
        elif cat in DEVICE_CATS:
            launched.append((e.get("args") or {}).get("correlation"))
    if len(launched) != len(tr.device):
        raise ValueError(f"{len(launched)} device events against the "
                         f"trace's {len(tr.device)}")
    tr.spans = spans
    tr.launched = [calls.get(c) for c in launched]


def breakdown(tr: Trace, top: int = 10):
    """The device operations that took most time in the stretch, by name,
    and the longest idle gaps of the device, each named by the host
    operator that overlapped it most (or "host")."""
    by_name = {}
    for name, s, e, _lib in tr.device:
        s, e = max(s, tr.start), min(e, tr.end)
        if e > s:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = tr.busy_intervals()
    gaps, prev = [], tr.start
    for s, e in busy + [[tr.end, tr.end]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for gs, ge in gaps[:top]:
        best, cover = "host", 0.0
        for name, s, e in tr.host_ops:
            c = min(e, ge) - max(s, gs)
            if c > cover:
                best, cover = name, c
        named.append([best, (ge - gs) * 1e-6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
