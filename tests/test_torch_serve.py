"""PyTorch port vs JAX: ``StreamServer``, the serving pool
(juicy_tpu_torch/runtime/serve.py), on the cases of tests/test_serve.py that
need neither a TPU mesh nor a traced texture material.

Each case is a script of server calls (open, submit, set_params, tick, ...)
played on the port's ``StreamServer(device="cpu")`` and on JAX's
``StreamServer`` with the same inputs (make_clip and the burst input, from
numpy seeds); JAX's run is made in one process without FMA contraction
(tests/torch_jax_ref.py), and every tick's audio and scores are compared:

- bench.py's three-stage serving chain ``STAGES`` (punch "Solar Snap",
  saturator "Amber Heat", infer) at N = 512, which both servers run through
  the block-major executor: audio <= -110 dBFS, scores within 1e-5 of
  max(1, |value|) (the analyzers' block sums are taken in another order:
  eight ulps of a score after eleven ticks); an i16
  wire's audio within one LSB (a rounding boundary can fall between two
  float values -110 dBFS apart);
- the canonical seven-stage chain with texture wood at N = 64, S = 8, with
  per-slot edits of punch, infer's trim, width's Haas delay and a texture
  knob: the port serves it on the chain kernel's tick (its plain version on
  the CPU) with per-slot constant rows, JAX through its vmapped fused
  fallback: audio <= -100 dBFS, every stage's metrics within 1e-5 of
  max(1, |value|), cohere's context fit within 1e-5 of its 0..100 range
  (ROADMAP.md Queue 3: XLA's reciprocal multiply moves it by ulps of 100).

Each test also makes the checks of its JAX counterpart on the port alone,
and the port's own: ``chain_kernel_step(params_rows=)`` with every row equal
is the shared step bit for bit, each per-slot setting gives what a chain of
that setting gives alone, the per-row delay checks raise, ``mesh=`` raises
ValueError beside a device or for a slot count that does not divide (the
sharded server itself: tests/test_torch_mesh.py), and a traced material
takes the block-major executor. The
CUDA pool is held to the CPU pool on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from juicy_tpu_torch.kernels import chain_kernel as ck
from juicy_tpu_torch.runtime.plugin import Chain
from juicy_tpu_torch.runtime.serve import StreamServer
from tests.conftest import make_clip, residual_dbfs
from tests.test_torch_punch_motion import burst_clips
from tests.torch_jax_ref import no_fma_reference

SR = 48000.0
BLOCK = 512
STAGES = [("punch", "Solar Snap"), ("saturator", "Amber Heat"),
          ("infer", None)]
N7, S7 = 64, 8
CHAIN7 = [("punch", "Solar Snap"), ("saturator", "Amber Heat"),
          ("texture", {"material": 2}), ("motion", None),
          ("width", "Prism Arc"), ("cohere", None), ("infer", "Reference Lens")]

# Scripts: ("open",) appends a stream; streams are named by their index in
# the order they were opened. ("submit", i, clip, k, scale) submits block k
# of clip `clip` times `scale`; "submit_pcm" its PCM16 quantization,
# "submit_deq" that PCM as float. ("tick",), ("arrays",) and ("result", j)
# (the j-th ("async",) handle) are recorded.
_BULK = [("open",), ("open",), ("submit_many", [0, 1], [(0, 0, 1.0),
                                                        (1, 0, 0.5)]),
         ("arrays",)]
_ASYNC = [("open",)] + [op for k in range(4) for op in (
    ("submit", 0, 0, k, 1.0), ("async",))
    + ((("result", k - 2),) if k >= 2 else ())] + [("result", 2),
                                                   ("result", 3)]
CASES = {
    "solo": ("stages", 4, {}, [("open",), ("open",)] + [
        op for k in range(3) for op in (("submit", 0, 0, k, 1.0),
                                        ("submit", 1, 1, k, 0.5), ("tick",))]),
    "warmup": ("stages", 2, {}, [
        ("warmup",), ("open",), ("submit", 0, 0, 0, 1.0), ("tick",),
        ("set_params", 0, "punch", {"punch": 0.9}), ("submit", 0, 0, 0, 1.0),
        ("tick",)]),
    "recycle": ("stages", 1, {}, [
        ("open",), ("submit", 0, 0, 0, 1.0), ("tick",), ("close", 0),
        ("open",), ("submit", 1, 0, 0, 1.0), ("tick",)]),
    "bulk_dict": ("stages", 4, {}, [
        ("open",), ("open",), ("submit", 0, 0, 0, 1.0),
        ("submit", 1, 1, 0, 0.5), ("tick",)]),
    "bulk": ("stages", 4, {}, _BULK),
    "idle": ("stages", 2, {}, [("open",), ("open",), ("submit", 0, 0, 0, 1.0),
                               ("tick",)]),
    "presets": ("stages", 4, {}, [
        ("open",), ("open",), ("set_preset", 1, "punch", "Crater Impact"),
        ("set_params", 1, "saturator", {"drive": 13.5})] + [
        op for k in range(3) for op in (("submit", 0, 0, k, 1.0),
                                        ("submit", 1, 0, k, 1.0), ("tick",))]),
    "recover": ("stages", 2, {}, [
        ("open",), ("open",), ("submit", 0, 0, 0, 1.0), ("tick",),
        ("set_params", 1, "saturator", {"drive": 13.5}),
        ("submit", 0, 0, 0, 1.0), ("submit", 1, 0, 0, 1.0), ("tick",),
        ("close", 1), ("open",), ("close", 0), ("open",),
        ("submit", 3, 0, 0, 1.0), ("tick",)]),
    "all_stages": ("stages", 2, {"stage_metrics": "all"}, [
        ("open",), ("submit", 0, 0, 0, 1.0), ("tick",)]),
    "i16": ("stages", 2, {"wire": "i16"}, [
        ("open",), ("submit", 0, 0, 0, 1.0), ("tick",),
        ("submit_pcm", 0, 0, 1), ("tick",)]),
    "i16_f32": ("stages", 2, {}, [
        ("open",), ("submit_deq", 0, 0, 0), ("tick",),
        ("submit_deq", 0, 0, 1), ("tick",)]),
    "async": ("stages", 2, {}, _ASYNC),
    "inflight": ("stages", 2, {}, [("open",)] + [
        op for _ in range(StreamServer.MAX_INFLIGHT + 3)
        for op in (("submit", 0, 0, 0, 1.0), ("async",))] + [
        ("result", j) for j in range(StreamServer.MAX_INFLIGHT + 3)]),
    "meter": ("stages", 2, {"audio_out": False, "wire": "i16"}, [
        ("open",), ("submit_pcm", 0, 0, 0), ("tick",),
        ("submit_pcm", 0, 0, 1), ("tick",), ("submit_pcm", 0, 0, 0),
        ("arrays",)]),
    "staging": ("stages", 2, {}, [
        ("open",), ("submit", 0, 0, 0, 3.0), ("submit", 0, 0, 0, 1.0),
        ("tick",), ("tick",), ("submit", 0, 0, 0, 1.0), ("tick",),
        ("open",), ("submit", 1, 0, 0, 5.0), ("close", 1)]),
    "chain7": ("chain7", S7, {"stage_metrics": "all"}, [
        ("open",) for _ in range(5)] + [
        ("set_params", 1, "punch", {"punch": 0.85, "clip": 0.4}),
        ("set_params", 2, "infer", {"trim": -4.0}),
        ("set_params", 3, "width", {"haasMs": 9.0}),
        ("set_params", 4, "texture", {"texture": 0.9})] + [
        op for k in range(2) for op in [
            ("submit", i, i, k, 1.0) for i in range(5)] + [("tick",)]] + [
        ("close", 1), ("close", 2), ("close", 3), ("close", 4), ("open",)] + [
        ("submit", 0, 0, 2, 1.0), ("submit", 5, 5, 2, 1.0), ("tick",)]),
}


def _clip(kind, c):
    """Clip `c` of a case: make_clip (STAGES) or the burst input (chain7),
    four blocks, from a numpy seed."""
    if kind == "chain7":
        return burst_clips(200 + c, 1, 2, 4 * N7)[0]
    return make_clip(np.random.default_rng(100 + c), 2, 4 * BLOCK)


def _block(kind, clip, k, scale=1.0):
    n = N7 if kind == "chain7" else BLOCK
    return _clip(kind, clip)[:, k * n:(k + 1) * n] * np.float32(scale)


def _pcm(x):
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def play(server, kind, script):
    """Run `script` on `server`; returns (the recorded outputs as a flat
    dict of arrays, the stream ids, the async handles)."""
    sids, handles, rec = [], [], {}

    def record_arrays(r, res):
        s, audio, scores, pre = res
        rec[f"{r}/sids"] = np.asarray(s)
        for key, v in (("audio", audio), ("scores", scores), ("pre", pre)):
            if v is not None:
                rec[f"{r}/{key}"] = np.asarray(v)

    r = 0
    for op in script:
        name = op[0]
        if name == "open":
            sids.append(server.open_stream())
        elif name == "close":
            server.close_stream(sids[op[1]])
        elif name == "submit":
            server.submit(sids[op[1]], _block(kind, *op[2:]))
        elif name == "submit_pcm":
            server.submit(sids[op[1]], _pcm(_block(kind, *op[2:])))
        elif name == "submit_deq":
            server.submit(sids[op[1]], _pcm(_block(kind, *op[2:]))
                          .astype(np.float32) / 32768.0)
        elif name == "submit_many":
            server.submit_many([sids[i] for i in op[1]],
                               np.stack([_block(kind, *b) for b in op[2]]))
        elif name == "set_params":
            server.set_params(sids[op[1]], op[2], **op[3])
        elif name == "set_preset":
            server.set_preset(sids[op[1]], op[2], op[3])
        elif name == "warmup":
            server.warmup()
        elif name == "async":
            handles.append(server.tick_arrays_async())
        else:
            if name == "tick":
                res = server.tick()
                rec[f"{r}/sids"] = np.asarray(sorted(res))
                for sid, entry in res.items():
                    for key, v in entry.items():
                        if key == "stages":
                            for s, row in enumerate(v):
                                for mk, mv in row.items():
                                    rec[f"{r}/{sid}/stage{s}/{mk}"] = \
                                        np.asarray(mv)
                        else:
                            rec[f"{r}/{sid}/{key}"] = np.asarray(v)
            elif name == "arrays":
                record_arrays(r, server.tick_arrays())
            else:                                       # "result"
                record_arrays(r, handles[op[1]].result())
            r += 1
    return rec, sids, handles


def _jax_serve_refs():
    """Every case played on JAX's StreamServer (run without FMA)."""
    from juicy_tpu.runtime.plugin import Chain as JChain
    from juicy_tpu.runtime.serve import StreamServer as JServer

    out = {}
    for case, (kind, s, kw, script) in CASES.items():
        stages, n = (CHAIN7, N7) if kind == "chain7" else (STAGES, BLOCK)
        server = JServer(JChain(stages, sr=SR, channels=2, block_size=n),
                         max_streams=s, **kw)
        rec, _sids, _h = play(server, kind, script)
        out.update({f"{case}/{k}": v for k, v in rec.items()})
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_serve", "_jax_serve_refs",
                            tmp_path_factory.mktemp("serve"))


def _server(case):
    kind, s, kw, _script = CASES[case]
    stages, n = (CHAIN7, N7) if kind == "chain7" else (STAGES, BLOCK)
    return StreamServer(Chain(stages, SR, 2, n), s, device="cpu", **kw)


def run_case(case, jax_ref, server=None):
    """Play `case` on the port (a fresh CPU server unless given) and hold
    every recorded output to JAX's. Returns (server, record, sids,
    handles)."""
    kind, _s, _kw, script = CASES[case]
    server = _server(case) if server is None else server
    rec, sids, handles = play(server, kind, script)
    ref = {k[len(case) + 1:]: v for k, v in jax_ref.items()
           if k.startswith(case + "/")}
    assert set(rec) == set(ref), case
    worst = -np.inf
    for key, v in rec.items():
        r, leaf = ref[key], key.rsplit("/", 1)[-1]
        if leaf == "sids":
            np.testing.assert_array_equal(v, r)
        elif leaf == "audio" and v.dtype == np.int16:
            assert r.dtype == np.int16
            lsb = np.abs(v.astype(np.int64) - r.astype(np.int64)).max()
            assert lsb <= 1, (case, key, lsb)
        elif leaf == "audio":
            db = residual_dbfs(v, r)
            worst = max(worst, db)
            assert db <= (-100.0 if kind == "chain7" else -110.0), \
                (case, key, db)
        elif kind == "chain7":
            scale = 100.0 if leaf == "context_fit" else \
                np.maximum(1.0, np.abs(r))
            assert np.all(np.abs(v - r) <= 1e-5 * scale), (case, key)
        else:
            assert np.all(np.abs(v - r) <= 1e-5 * np.maximum(1.0, np.abs(r))), \
                (case, key, v, r)
    print(f"{case}: audio {worst:.1f} dBFS vs JAX")
    return server, rec, sids, handles


def test_torch_stream_server_matches_solo_run(jax_ref):
    """Two concurrent streams against JAX's server, and against the port's
    Chain.run of each clip alone."""
    srv, rec, (a, b), _h = run_case("solo", jax_ref)
    assert srv.active_streams == 2
    chain = Chain(STAGES, SR, 2, BLOCK)
    for sid, clip, scale in ((a, 0, 1.0), (b, 1, 0.5)):
        got = np.concatenate([rec[f"{t}/{sid}/audio"] for t in range(3)], -1)
        want, _st, _m = chain.run(chain.init_state((), "cpu"), torch.from_numpy(
            _clip("stages", clip)[:, :3 * BLOCK] * np.float32(scale)))
        assert residual_dbfs(got, want.numpy()) <= -120.0
        assert all(0.0 <= rec[f"{t}/{sid}/score"] <= 100.0 for t in range(3))


def test_torch_stream_server_warmup(jax_ref):
    """warmup() advances no slot state: a warmed server's ticks, on the
    shared and the per-slot route, equal a cold server's bit for bit."""
    _srv, warm, _s, _h = run_case("warmup", jax_ref)
    script = [op for op in CASES["warmup"][3] if op[0] != "warmup"]
    cold, _sids, _h = play(_server("warmup"), "stages", script)
    assert set(cold) == set(warm)
    for key, v in cold.items():
        np.testing.assert_array_equal(warm[key], v, key)


def test_torch_stream_server_slot_recycling(jax_ref):
    """A full pool refuses a stream; a recycled slot starts fresh."""
    srv, rec, (a, b), _h = run_case("recycle", jax_ref)
    assert a == b == 0
    with pytest.raises(RuntimeError):
        srv.open_stream()
    np.testing.assert_array_equal(rec["1/0/audio"], rec["0/0/audio"])


def test_torch_stream_server_double_close_rejected():
    srv = _server("idle")
    a = srv.open_stream()
    srv.close_stream(a)
    with pytest.raises(KeyError):
        srv.close_stream(a)
    with pytest.raises(KeyError):
        srv.close_stream(99)
    s1, s2 = srv.open_stream(), srv.open_stream()
    assert s1 != s2
    with pytest.raises(RuntimeError):
        srv.open_stream()


def test_torch_stream_server_bulk_api_matches_scalar(jax_ref):
    """submit_many + tick_arrays give what submit + tick give."""
    _srv, want, (ra, rb), _h = run_case("bulk_dict", jax_ref)
    _srv, got, (a, b), _h = run_case("bulk", jax_ref)
    np.testing.assert_array_equal(got["0/sids"], sorted([a, b]))
    for k, (sid, rsid) in enumerate(((a, ra), (b, rb))):
        np.testing.assert_array_equal(got["0/audio"][k],
                                      want[f"0/{rsid}/audio"])
        assert got["0/scores"][k] == want[f"0/{rsid}/score"]
        assert got["0/pre"][k] == want[f"0/{rsid}/pre_score"]


def test_torch_stream_server_idle_stream_advances(jax_ref):
    _srv, rec, (a, b), _h = run_case("idle", jax_ref)
    assert f"0/{a}/audio" in rec and f"0/{b}/audio" not in rec


def test_torch_stream_server_rejects_bad_block_shape():
    srv = _server("recycle")
    a = srv.open_stream()
    with pytest.raises(ValueError):
        srv.submit(a, np.zeros((2, BLOCK // 2), np.float32))
    with pytest.raises(KeyError):
        srv.submit(99, np.zeros((2, BLOCK), np.float32))
    with pytest.raises(ValueError):
        srv.submit_many([a], np.zeros((2, 2, BLOCK), np.float32))
    with pytest.raises(KeyError):
        srv.set_params(a, "punch", nonsense=1.0)
    with pytest.raises(KeyError):
        srv.set_params(a, "width", width=1.0)


def test_torch_stream_server_per_stream_presets(jax_ref):
    """A slot's preset and knob edit give what a chain of that setting
    gives alone; the streams differ; a recycled slot has the defaults."""
    srv, rec, (a, b), _h = run_case("presets", jax_ref)
    chain_b = Chain([("punch", "Crater Impact"), ("saturator", "Amber Heat"),
                     ("infer", None)], SR, 2, BLOCK)
    chain_b.params[1]["drive"] = torch.tensor(13.5)
    want_b, _st, _m = chain_b.run(chain_b.init_state((), "cpu"),
                                  torch.from_numpy(_clip("stages", 0)[
                                      :, :3 * BLOCK]))
    got = {sid: np.concatenate([rec[f"{t}/{sid}/audio"] for t in range(3)],
                               -1) for sid in (a, b)}
    assert residual_dbfs(got[b], want_b.numpy()) <= -120.0
    assert residual_dbfs(got[a], got[b]) > -40.0
    assert srv.get_params(b, "saturator")["drive"] == 13.5
    srv.close_stream(b)
    c = srv.open_stream()
    assert c == b
    assert srv.get_params(c, "punch")["punch"] == pytest.approx(
        float(srv.chain.params[0]["punch"]))


def test_torch_stream_server_fast_path_recovers_after_custom_tenant(jax_ref):
    """Closing the last edited tenant restores its rows and the shared
    route; a fresh stream then serves what the first one did."""
    srv, rec, sids, _h = run_case("recover", jax_ref)
    assert not srv._custom_slots
    assert srv.get_params(sids[2], "saturator")["drive"] == pytest.approx(
        float(srv.chain.params[1]["drive"]))
    np.testing.assert_array_equal(rec[f"2/{sids[3]}/audio"],
                                  rec[f"0/{sids[0]}/audio"])


def test_torch_stream_server_all_stage_metrics(jax_ref):
    _srv, rec, (a,), _h = run_case("all_stages", jax_ref)
    stages = {k.split("/")[2] for k in rec if "/stage" in k}
    assert len(stages) == len(STAGES)
    for s in range(len(STAGES)):
        assert 0.0 <= rec[f"0/{a}/stage{s}/score"] <= 100.0
    assert rec[f"0/{a}/score"] == rec[f"0/{a}/stage2/score"]


def test_torch_stream_server_i16_wire_matches_f32(jax_ref):
    """An i16 wire (float then int16 submits) against an f32 wire fed the
    same PCM: within one output quantization step."""
    _srv, got, (a,), _h = run_case("i16", jax_ref)
    _srv, want, (b,), _h = run_case("i16_f32", jax_ref)
    for t in range(2):
        assert got[f"{t}/{a}/audio"].dtype == np.int16
        np.testing.assert_allclose(
            got[f"{t}/{a}/audio"].astype(np.float32) / 32768.0,
            want[f"{t}/{b}/audio"], rtol=0, atol=1.01 / 32768.0)
    with pytest.raises(ValueError):
        StreamServer(Chain(STAGES, SR, 2, BLOCK), 2, wire="i24", device="cpu")


def test_torch_stream_server_async_ticks_match_sync(jax_ref):
    """Pipelined two deep, async results equal blocking ones bit for bit."""
    srv, got, (a,), handles = run_case("async", jax_ref)
    assert not srv._inflight
    sync = [("open",)] + [op for k in range(4)
                          for op in (("submit", 0, 0, k, 1.0), ("arrays",))]
    want, _sids, _h = play(_server("async"), "stages", sync)
    assert set(got) == set(want)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, key)


def test_torch_stream_server_async_inflight_capped(jax_ref):
    """Past MAX_INFLIGHT the oldest handle is resolved at dispatch; every
    handle still returns its own tick."""
    srv = _server("inflight")
    sid = srv.open_stream()
    handles = []
    for _ in range(srv.MAX_INFLIGHT + 3):
        srv.submit(sid, _block("stages", 0, 0))
        handles.append(srv.tick_arrays_async())
        assert len(srv._inflight) <= srv.MAX_INFLIGHT
    assert handles[0].result()[0].tolist() == [sid]
    srv, rec, _sids, handles = run_case("inflight", jax_ref)
    assert not srv._inflight


def test_torch_stream_server_metering_rail(jax_ref):
    """audio_out=False: scores only, the audio never copied out; the same
    scores as a full server fed the same PCM."""
    srv, rec, (a,), _h = run_case("meter", jax_ref)
    assert not any(k.endswith("audio") for k in rec)
    assert "2/scores" in rec and "2/audio" not in rec
    full, _sids, _h = play(_server("i16_f32"), "stages",
                           CASES["i16_f32"][3])
    for t in range(2):
        assert rec[f"{t}/{a}/score"] == full[f"{t}/{a}/score"]
        assert rec[f"{t}/{a}/pre_score"] == full[f"{t}/{a}/pre_score"]
    with pytest.raises(ValueError):
        StreamServer(Chain(STAGES, SR, 2, BLOCK), 2, audio_out=False,
                     metrics="none", device="cpu")


def test_torch_stream_server_staging_semantics(jax_ref):
    """Last submit before a tick wins, an idle slot goes back to silence,
    and closing a staged but unticked stream leaves its row clean."""
    srv, rec, (a, c), _h = run_case("staging", jax_ref)
    ref, _sids, _h = play(_server("staging"), "stages", [
        ("open",), ("submit", 0, 0, 0, 1.0), ("tick",), ("tick",),
        ("submit", 0, 0, 0, 1.0), ("tick",)])
    np.testing.assert_array_equal(rec[f"0/{a}/audio"], ref[f"0/{a}/audio"])
    assert f"1/{a}/audio" not in rec
    np.testing.assert_array_equal(rec[f"2/{a}/audio"], ref[f"2/{a}/audio"])
    assert not np.any(srv._assembly[c])


def test_torch_stream_server_chain_kernel_tick_vs_jax(jax_ref, monkeypatch):
    """The seven-stage chain (wood) on the chain kernel's tick with per-slot
    rows (punch, infer's trim, width's Haas delay, a texture knob), against
    JAX's server, which serves those edits through its fused fallback; the
    pool recovers the shared row when the edited tenants close. On the CPU
    the tick is the kernel's plain version: no launch."""
    step, routes = ck.chain_kernel_step, []

    def spy(*args, params_rows=None):
        routes.append(None if params_rows is None else len(params_rows.groups))
        return step(*args, params_rows=params_rows)

    monkeypatch.setattr(ck, "chain_kernel_step", spy)
    before = step.launches
    srv, _rec, _sids, _h = run_case("chain7", jax_ref)
    assert srv._kernel_tick and srv._pools[0].kc is None
    assert step.launches == before
    assert routes == [5, 5, None]        # four edited slots and the default
    assert not srv._custom_slots


def test_torch_chain_kernel_step_params_rows():
    """Per-clip rows: all rows equal to the chain's gives the shared step
    bit for bit (the table's rows are the shared row); each distinct row
    gives what a chain of that setting gives alone, clip by clip."""
    chain = Chain(CHAIN7, SR, 2, N7)
    b = 5
    states = chain.init_state((b,), "cpu")
    x = torch.from_numpy(burst_clips(7, b, 2, N7))
    out, st, m = ck.chain_kernel_step(chain, states, x)
    rows = [{k: torch.full((b,), float(v)) for k, v in p.items()}
            for p in chain.params]
    pr = ck.ParamRows(chain, rows, b)
    assert len(pr.groups) == 1
    np.testing.assert_array_equal(pr.table("cpu").numpy(),
                                  np.broadcast_to(ck.chain_constants(chain),
                                                  (b, ck.N_CONSTS)))
    out_r, st_r, m_r = ck.chain_kernel_step(chain, states, x, params_rows=rows)
    assert torch.equal(out, out_r)
    for a_, b_ in zip(m, m_r):
        for key, v in a_.items():
            assert torch.equal(b_[key], v), key
    rows[0]["punch"][1] = 0.3
    rows[6]["sensitivity"][2] = 1.5
    rows[4]["haasMs"][3] = 30.0
    rows[2]["weight"][4] = 0.9
    out_r, st_r, m_r = ck.chain_kernel_step_plain(chain, states, x,
                                                  params_rows=rows)
    assert len(ck.ParamRows(chain, rows, b).groups) == 5
    for j in range(b):
        solo = Chain(CHAIN7, SR, 2, N7)
        solo.params = [{k: torch.tensor(float(v[j])) for k, v in r.items()}
                       for r in rows]
        sj = [{g: {k: v[j:j + 1] for k, v in s[g].items()}
               for g in ("analyzer", "dsp")} for s in states]
        o, s_, mj = ck.chain_kernel_step(solo, sj, x[j:j + 1])
        assert torch.equal(o[0], out_r[j])
        for stage, (a_, b_) in enumerate(zip(mj, m_r)):
            for key, v in a_.items():
                assert torch.equal(b_[key][j], v[0]), (j, stage, key)
            for group in ("analyzer", "dsp"):
                for key, v in s_[stage][group].items():
                    assert torch.equal(st_r[stage][group][key][j], v[0]), \
                        (j, stage, key)


def test_torch_chain_kernel_rows_checked():
    """Every row's delays are checked: a Haas delay past the window raises,
    and so does a waveguide delay past the ring (a row the params cannot
    make: the model clamps it)."""
    chain = Chain(CHAIN7, SR, 2, N7)
    states = chain.init_state((3,), "cpu")
    rows = [{k: torch.full((3,), float(v)) for k, v in p.items()}
            for p in chain.params]
    rows[4]["haasMs"][2] = 40.0
    with pytest.raises(ck.ChainKernelUnsupported, match="Haas"):
        ck.KernelChain(chain, states, 3, "cpu", ck.ParamRows(chain, rows, 3))
    kc = ck.KernelChain(chain, states, 3, "cpu")
    table = np.stack([ck.chain_constants(chain)] * 3)
    table[1, ck._WAVE_DELAY] = kc.L
    with pytest.raises(ck.ChainKernelUnsupported, match="waveguide"):
        ck.check_rows(table, kc.D, kc.L, kc.wave)
    ck.check_rows(table, kc.D, kc.L, False)
    with pytest.raises(ValueError):
        ck.ParamRows(chain, rows[:3], 3)
    with pytest.raises(ValueError):
        ck.ParamRows(chain, [dict(r, extra=0.0) for r in rows], 3)


def _assert_rows_equal(got, want):
    np.testing.assert_array_equal(got.consts, want.consts)
    assert torch.equal(got.table("cpu"), want.table("cpu"))
    for g, w in zip(got.full_on("cpu"), want.full_on("cpu")):
        assert set(g) == set(w)
        for key, v in w.items():
            assert torch.equal(torch.as_tensor(g[key]), torch.as_tensor(v))
    assert len(got.groups) == len(want.groups)
    for (gp, gi), (wp, wi) in zip(got.groups, want.groups):
        assert torch.equal(gi, wi)
        assert gp == wp


def test_torch_param_rows_edited_in_place():
    """An edit rewrites one clip's row of the table (host and device copies
    alike) and nothing else: the edited rows equal rows built afresh from
    the edited params. The pool keeps its table from the warmup on, edit
    after edit and close after close, and an unknown key writes nothing."""
    chain = Chain(CHAIN7, SR, 2, N7)
    b = 6
    params = [{k: np.full(b, float(v), np.float32) for k, v in p.items()}
              for p in chain.params]
    pr = ck.ParamRows(chain, params, b)
    pr.table("cpu")                               # a device copy to keep up
    for j, stage, key, v in ((1, 0, "punch", 0.3), (4, 6, "trim", -4.0),
                             (1, 4, "haasMs", 30.0), (5, 2, "weight", 0.9),
                             (4, 6, "trim", 0.0)):
        values = [{} for _ in params]
        values[stage][key] = v
        pr.set_row(j, values)
        params[stage][key][j] = v
        _assert_rows_equal(pr, ck.ParamRows(chain, params, b))
    with pytest.raises(KeyError):
        pr.set_row(0, [{"nope": 1.0}] + [{} for _ in params[1:]])

    srv = StreamServer(chain, 4, device="cpu")
    srv.warmup()
    rows = srv._pools[0].rows
    sids = [srv.open_stream() for _ in range(3)]
    srv.set_params(sids[0], "punch", punch=0.3, clip=0.4)
    srv.set_params(sids[2], "width", haasMs=30.0)
    with pytest.raises(KeyError):
        srv.set_params(sids[1], "infer", trim=-4.0, nope=1.0)
    assert srv.get_params(sids[1], "infer")["trim"] == \
        float(chain.params[6]["trim"])
    srv.close_stream(sids[0])
    assert srv._pools[0].rows is rows
    _assert_rows_equal(rows, ck.ParamRows(
        chain, [{k: torch.from_numpy(v) for k, v in p.items()}
                for p in srv._params], 4))
    assert len(rows.groups) == 2


def test_torch_stream_server_not_ported_raise():
    """mesh= takes the place of device= and must divide the slots, as
    JAX's does (ValueError); a traced texture material (per-stream
    materials, tests/test_torch_materials.py) is served on the block-major
    executor; the pool runs on the card unless asked for the CPU."""
    from juicy_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="not both"):
        StreamServer(Chain(STAGES, SR, 2, BLOCK), 2, mesh=mesh,
                     device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        StreamServer(Chain(STAGES, SR, 2, BLOCK), 3, mesh=mesh)
    chain = Chain([("punch", None), ("texture", None), ("infer", None)],
                  SR, 2, BLOCK)
    chain.params[1]["material"] = torch.tensor(0.0)
    assert not StreamServer(chain, 2, device="cpu")._kernel_tick
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamServer(Chain(STAGES, SR, 2, BLOCK), 2)
