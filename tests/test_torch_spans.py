"""The port's spans (``runtime/observe.py::span``) in the profiler's trace.

``span`` records a ``user_annotation`` event (never a ``cpu_op``: a
reader of the trace counts a kernel as the port's own when its launch runs
outside every ``cpu_op``) under ``observe.trace()`` and under any
``torch.profiler.profile``, and enters no ``record_function`` when no
profiler records. ``run_corpus_chain`` opens one ``juicy.corpus_chain`` a
call; inside it, on the sorted route of per-clip materials,
``juicy.order.gather``, ``juicy.order.scatter`` and ``juicy.finalize`` in
that order, each once, and a static material opens no ``juicy.order.*``
span; traced or not, the outputs are the same bits. On the card
(``cuda``), the chain stream's ``juicy.chain.pack`` and
``juicy.chain.unpack`` open twice each a call (the state's pack and the
input permute; the output permute and the state's unpack), around the
launch loop and never inside it. This file imports no JAX.
"""

import json

import numpy as np
import pytest
import torch

from juicy_tpu_torch.kernels import chain_kernel as ck
from juicy_tpu_torch.parallel.corpus import run_corpus_chain
from juicy_tpu_torch.runtime import observe
from juicy_tpu_torch.runtime.plugin import Chain

SR = 48000.0
N = 64
STAGES = [("punch", "Solar Snap"), ("saturator", "Amber Heat"),
          ("texture", None), ("motion", None), ("width", "Prism Arc"),
          ("cohere", None), ("infer", "Reference Lens")]
#: per-clip materials whose CTAs do not share theirs: the sorted route
MATS = [3, 0, 4, 1, 2, 0, 2, 1, 3, 4, 0, 2]


def _clips(b, blocks, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(blocks * N)
    sig = 0.3 * np.sin(2 * np.pi * 220.0 * t / SR) * (1.0 + (t % 96 < 12))
    x = sig + 0.05 * rng.standard_normal((b, 2, blocks * N))
    return torch.from_numpy(np.clip(x, -0.99, 0.99).astype(np.float32))


def _events(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _spans(events, prefix="juicy."):
    """The host's spans named `prefix`... as (name, start, end), in start
    order; fails if one is recorded as an operator. (On the card the
    profiler adds each span's device side as a ``gpu_user_annotation``.)"""
    out = []
    for e in events:
        if e.get("name", "").startswith(prefix):
            assert e["cat"] in ("user_annotation", "gpu_user_annotation"), e
            if e["cat"] == "user_annotation":
                out.append((e["name"], float(e["ts"]),
                            float(e["ts"]) + float(e["dur"])))
    return sorted(out, key=lambda s: s[1])


def _profile(fn):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        result = fn()
    return prof, result


@pytest.mark.parametrize("how", ["observe_trace", "profiler"])
def test_span_records_a_user_annotation(tmp_path, how):
    def body():
        with observe.span("juicy.test"):
            return torch.ones(4) * 2.0
    if how == "observe_trace":
        with observe.trace(str(tmp_path)):
            body()
    else:
        prof, _ = _profile(body)
        prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = _events(tmp_path / "trace.json")
    (name, start, end), = _spans(events)
    assert name == "juicy.test" and end >= start
    # the operator inside the span is recorded as one, inside it
    mul = [e for e in events if e["name"] == "aten::mul"]
    assert mul and mul[0]["cat"] == "cpu_op"
    assert start <= float(mul[0]["ts"]) <= end


def test_span_without_a_profiler_enters_no_record_function(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first, second = observe.span("juicy.a"), observe.span("juicy.b")
    assert first is second                 # one shared no-op context
    with first:
        pass
    chain = Chain(STAGES, SR, 2, N)
    out, ms, _agg = run_corpus_chain(chain, _clips(4, 1), device="cpu")
    assert out.shape == (4, 2, N) and ms[-1]["score"].shape == (4,)


def test_mixed_corpus_spans_in_order(tmp_path):
    """The sorted route's spans inside the call's, once each and in order;
    the outputs of the traced call are the untraced call's bits."""
    chain = Chain(STAGES, SR, 2, N)
    clips = _clips(len(MATS), 2)

    def call():
        return run_corpus_chain(chain, clips, metrics="blocks",
                                materials=MATS, device="cpu")
    want = call()
    with observe.trace(str(tmp_path)):
        got = call()
    spans = _spans(_events(tmp_path / "trace.json"))
    names = [s[0] for s in spans]
    assert names == ["juicy.corpus_chain", "juicy.order.gather",
                     "juicy.order.scatter", "juicy.finalize"]
    (_n, start, end), *inner = spans
    prev = start
    for _name, s, e in inner:
        assert prev <= s <= e <= end
        prev = e
    assert torch.equal(got[0], want[0])
    for m_got, m_want in zip(got[1], want[1], strict=True):
        assert m_got.keys() == m_want.keys()
        for key in m_want:
            assert torch.equal(m_got[key], m_want[key]), key


def test_static_corpus_opens_no_order_span(tmp_path):
    chain = Chain(STAGES, SR, 2, N)
    with observe.trace(str(tmp_path)):
        run_corpus_chain(chain, _clips(5, 2), device="cpu")
    names = [s[0] for s in _spans(_events(tmp_path / "trace.json"))]
    assert names == ["juicy.corpus_chain", "juicy.finalize"]


@pytest.mark.cuda
def test_chain_pack_and_unpack_spans_on_card(tmp_path):
    """On the card the chain stream packs and unpacks outside its launch
    loop: two spans of each a call, inside ``juicy.corpus_chain``, the
    launches between the last pack and the first unpack; the traced call
    gives the untraced call's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    chain = Chain(STAGES, SR, 2, 512)
    clips = _clips(100, 3).repeat_interleave(8, dim=-1).cuda()

    def call():
        return run_corpus_chain(chain, clips, device="cuda:0")
    want = call()
    before = ck.chain_kernel_step.launches
    prof, got = _profile(call)
    torch.cuda.synchronize()
    assert ck.chain_kernel_step.launches - before == 3
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = _events(tmp_path / "trace.json")
    spans = _spans(events)
    names = [s[0] for s in spans]
    assert names == ["juicy.corpus_chain", "juicy.chain.pack",
                     "juicy.chain.pack", "juicy.chain.unpack",
                     "juicy.chain.unpack", "juicy.finalize"]
    outer = spans[0]
    assert all(outer[1] <= s <= e <= outer[2] for _n, s, e in spans[1:])
    packed, unpacking = spans[2][2], spans[3][1]
    chain_launches = [e for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and e["name"].startswith(("cudaLaunchKernel",
                                                "cuLaunchKernel"))
                      and packed <= float(e["ts"]) <= unpacking]
    assert len(chain_launches) >= 3
    assert torch.equal(got[0], want[0])
    for key in want[1][-1]:
        assert torch.equal(got[1][-1][key], want[1][-1][key]), key
