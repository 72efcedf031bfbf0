"""The readers of the program's spans (benchmark/spans.py and the metrics
that use it) on synthetic Chrome-trace events, as ``tracing.parse`` gives
them every traced run: a phase whose operations wait behind queued chain
kernels starts its window where the last of them ends; a phase with host
work before its first operation starts at its host start; a reader of a
span that did not run reads None, as does every span reader of a trace
without the program's spans; the call's idle is part of the device's; the
spans change nothing that the trace's other readers and its breakdown
read, a chain-kernel launch inside the call's span included; and the
parse reads what the parse of the commit before the spans reached it
read, with the spans read as ``spans.attach`` read them there."""

import pytest

from benchmark import harness, spans, tracing

NEW = ("finalize_ms", "pack_ms", "unpack_ms", "material_order_ms",
       "program_idle_pct")
OLD = ("chain_roofline", "device_idle_pct", "launches_per_batch",
       "dispatch_ms")
CELL = {"blocks": 2, "chips": 1, "bound_ms": 0.01, "bound_by": "operations"}
TID = 7


class Events:
    """A trace's events, built in host order: spans, launches (each a
    runtime call and its device operation), PyTorch operators."""

    def __init__(self):
        self.events, self.corr = [], 0

    def span(self, name, ts, end, cat="user_annotation"):
        self.events.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                            "dur": end - ts, "tid": TID})

    def launch(self, ts, start, end, kernel="k", cat="kernel",
               call="cudaLaunchKernel"):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": call,
                            "ts": ts, "dur": 1.0, "tid": TID,
                            "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": cat, "name": kernel,
                            "ts": start, "dur": end - start, "tid": 99,
                            "args": {"correlation": self.corr,
                                     "device": 0}})


def _read(events, batches=1):
    return tracing.parse(events, batches, [0.001] * batches, CELL)


def _queue():
    """One batch, [0, 1000] µs: a zeros operator launches a fill; the
    pack's host work runs 100 µs before its copy; two chain kernels
    queue from 210 µs and run until 600; the finalize's two kernels,
    launched at 300 and 320, wait behind them."""
    ev = Events()
    ev.span("bench.batch", 0.0, 1000.0)
    ev.span("juicy.corpus_chain", 10.0, 400.0)
    ev.span("aten::zeros", 20.0, 40.0, cat="cpu_op")
    ev.launch(30.0, 35.0, 45.0, kernel="fill", cat="gpu_memset",
              call="cudaMemsetAsync")
    ev.span("juicy.chain.pack", 50.0, 200.0)
    ev.launch(150.0, 155.0, 190.0, kernel="copy", cat="gpu_memcpy",
              call="cudaMemcpyAsync")
    ev.launch(210.0, 215.0, 400.0, kernel="juicy_chain_block")
    ev.launch(220.0, 400.0, 600.0, kernel="juicy_chain_block")
    ev.span("juicy.finalize", 290.0, 390.0)
    ev.launch(300.0, 600.0, 610.0)
    ev.launch(320.0, 610.0, 630.0)
    return ev.events


def test_a_phase_behind_a_queue_starts_where_the_queue_ends():
    tr = _read(_queue())
    # the finalize: from the last chain kernel's end (600) to its last
    # kernel's end (630)
    assert harness.reader("finalize_ms")(tr) == pytest.approx(0.030)


def test_a_phase_with_host_work_first_starts_on_the_host():
    tr = _read(_queue())
    # the pack: the device idle from its host start (50; the fill ended at
    # 45) to its host end (200; its copy ended at 190)
    assert harness.reader("pack_ms")(tr) == pytest.approx(0.150)


def _ordered():
    """Two batches of the sorted route: a gather with one launch, a
    scatter with none."""
    ev = Events()
    for b in range(2):
        t = 1000.0 * b
        ev.span("bench.batch", t, t + 1000.0)
        ev.span("juicy.corpus_chain", t + 10.0, t + 900.0)
        ev.span("juicy.order.gather", t + 20.0, t + 60.0)
        ev.launch(t + 50.0, t + 55.0, t + 80.0)
        ev.span("juicy.order.scatter", t + 700.0, t + 720.0)
    return ev.events


def test_windows_are_per_batch_and_summed_over_instances():
    tr = _read(_ordered(), batches=2)
    # gather 20 -> 80, scatter 700 -> 720, each batch
    assert harness.reader("material_order_ms")(tr) == pytest.approx(0.080)
    assert harness.reader("unpack_ms")(tr) is None


def test_spans_that_did_not_run_read_none():
    tr = _read(_queue())
    assert harness.reader("material_order_ms")(tr) is None
    assert harness.reader("unpack_ms")(tr) is None
    bare = _read(_without_program_spans(_queue()))
    for name in NEW:
        assert harness.reader(name)(bare) is None, name


def test_call_idle_is_part_of_the_device_idle():
    tr = _read(_queue())
    call = harness.reader("program_idle_pct")(tr)
    device = harness.reader("device_idle_pct")(tr)
    # inside the call [10, 400]: busy 35-45, 155-190, 215-400 -> idle 25,
    # 110 and 25 µs = 160 of the stretch's 1000
    assert call == pytest.approx(16.0)
    assert 0.0 < call <= device


def _without_program_spans(events):
    return [e for e in events if not e["name"].startswith("juicy.")]


def test_spans_change_no_other_reading():
    events = _queue()
    with_spans = _read(events)
    without = _read(_without_program_spans(events))
    for name in OLD:
        got, want = (harness.reader(name)(t) for t in (with_spans, without))
        assert got == want, name
    # the kernels launched inside the call's span and outside every
    # operator are the port's own; the fill under aten::zeros and the copy
    # are not
    assert [d[3] for d in with_spans.device] == [
        False, False, True, True, True, True]
    assert harness.reader("chain_roofline")(with_spans) is not None
    assert tracing.breakdown(with_spans) == tracing.breakdown(without)
    assert set(tracing.breakdown(with_spans)) == {"device_ops", "idle_gaps"}


def test_attach_matches_each_operation_to_its_launch():
    events = _queue()
    tr = _read(events)
    assert [name for name, *_ in tr.spans] == [
        "bench.batch", "juicy.corpus_chain", "juicy.chain.pack",
        "juicy.finalize"]
    assert [at[1] for at in tr.launched] == [30.0, 150.0, 210.0, 220.0,
                                            300.0, 320.0]
    with pytest.raises(ValueError):
        spans.attach(tr, events[:-1])


#: each reader on each trace, read at the commit before ``tracing.parse``
#: kept the spans: the old readers from its parse, the span readers after
#: its ``spans.attach``
PARENT = {
    "queue": {"chain_roofline": 4.8192771084337345, "device_idle_pct": 54.0,
              "launches_per_batch": 4.0, "dispatch_ms": 1.0,
              "finalize_ms": 0.03, "pack_ms": 0.15, "unpack_ms": None,
              "material_order_ms": None, "program_idle_pct": 16.0},
    "ordered": {"chain_roofline": 80.0, "device_idle_pct": 97.5,
                "launches_per_batch": 1.0, "dispatch_ms": 1.0,
                "finalize_ms": None, "pack_ms": None, "unpack_ms": None,
                "material_order_ms": 0.08,
                "program_idle_pct": 86.49999999999999},
}


@pytest.mark.parametrize("case", sorted(PARENT))
def test_parse_reads_what_the_parents_parse_and_attach_read(case):
    events, batches = {"queue": (_queue(), 1),
                       "ordered": (_ordered(), 2)}[case]
    tr = _read(events, batches)
    assert {name: harness.reader(name)(tr) for name in OLD + NEW} \
        == PARENT[case]
    again = _read(events, batches)
    spans.attach(again, events)
    assert (again.spans, again.launched) == (tr.spans, tr.launched)
