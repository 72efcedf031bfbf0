"""The program's spans in a traced stretch, and the device time each phase
adds to a batch.

The port opens ``torch.profiler.record_function`` spans around the phases
of a call (``juicy_tpu_torch/runtime/observe.py::span``): they reach the
Chrome trace as ``user_annotation`` events on the same clock as the
device's operations, and each operation's launch (the CUDA runtime or
driver call with its correlation id) runs on the thread of the span it
was issued in. ``tracing.parse`` gives every ``tracing.Trace`` both
(``tracing.attach``):

* ``tr.spans``: every user annotation as (name, tid, start, end);
* ``tr.launched``: for each entry of ``tr.device`` the (tid, ts) of the
  call that launched it, or None where the trace holds none.

A span instance's device window runs from the later of its start on the
host and the latest end among the device operations launched before it
opened, to the later of its end on the host and the end of the last
device operation launched inside it (on its thread). On one stream that
is the time the phase adds to the batch: the host work that starts it
while the device waits, and the gaps its own launches leave, are in; the
wait behind operations queued before it is not.

Where the trace holds none of a span's instances (a program without the
spans, or a route that does not open it) the readers here return None.
"""

from __future__ import annotations

# re-exported for callers that attach the spans to a trace themselves
# (tools/bench_spans.py); tracing.parse already does.
from benchmark.tracing import attach  # noqa: F401

#: the span of one call into the program on one device
CALL = "juicy.corpus_chain"


def _chips(tr):
    return max(int(tr.cell.get("chips", 1)), len(set(tr.chip)), 1)


def instances(tr, name):
    """The instances of span `name` that open inside the stretch, as
    (tid, start, end)."""
    return [(tid, s, e) for n, tid, s, e in tr.spans
            if n == name and tr.start <= s <= tr.end]


def window(tr, tid, start, end):
    """The device window (start, end) of a span instance on thread `tid`
    over host times [start, end]: on the devices its own operations ran
    on (every device where it launched none)."""
    ops = [(at[0], at[1], e, chip) for (_n, _s, e, _lib), chip, at
           in zip(tr.device, tr.chip, tr.launched) if at is not None]
    own = [(e, chip) for ltid, ts, e, chip in ops
           if ltid == tid and start <= ts <= end]
    chips = {chip for _e, chip in own}
    before = max((e for _t, ts, e, chip in ops
                  if ts < start and (not chips or chip in chips)),
                 default=start)
    return max(start, before), max([end] + [e for e, _c in own])


def phase_ms(tr, *names):
    """The device windows of every instance of the spans `names`, summed,
    per traced batch and chip, in milliseconds; None where none ran."""
    found = [i for name in names for i in instances(tr, name)]
    if not found or not tr.batches:
        return None
    total = sum(max(0.0, e - s)
                for s, e in (window(tr, *i) for i in found))
    return total * 1e-3 / tr.batches / _chips(tr)


def _measure(intervals):
    """The length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def call_idle_pct(tr, name=CALL):
    """The share of the stretch in which a device ran nothing while the
    thread issuing to it was inside span `name` (a call into the program),
    averaged over the chips as ``device_idle_pct`` is, in percent; None
    where the span did not run."""
    inside = [(max(s, tr.start), min(e, tr.end))
              for _tid, s, e in instances(tr, name)]
    if not inside or tr.seconds <= 0.0:
        return None
    idle = 0.0
    for chip in sorted(set(tr.chip)) or [None]:
        busy = tr.busy_intervals(chip)
        # time inside the spans less the busy time inside them
        overlap = [(max(s, bs), min(e, be)) for s, e in inside
                   for bs, be in busy if min(e, be) > max(s, bs)]
        idle += _measure(inside) - _measure(overlap)
    return 100.0 * idle * 1e-6 / _chips(tr) / tr.seconds
