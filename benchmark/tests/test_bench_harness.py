"""The harness rehearsed on the CPU: BENCHMARK.json's entries resolve to
their files by name and keep to the contract's characters, each driver
brings its rehearsal (``tiny``) and its faults (``FAULTS``), each per-layer
metric moves an end-to-end metric that its cells report, a run without a
card prints no result, and a run whose timed path is broken underneath
comes out not correct, once for each fault its driver plants.

The cases come from BENCHMARK.json and the drivers alone, so a cell of a
new driver is rehearsed without an edit here: a toy driver of another kind
shows it."""

import json
import re
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from benchmark import compare, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def check_entries(spec):
    """Every cell of `spec` resolves by name to its files, its driver and
    its readers; the driver brings ``tiny`` and a fault of each kind; each
    configuration's file is its own and ``reduced`` names keys of it."""
    for w in spec["workloads"]:
        cell = harness.resolve(spec, w["name"])
        assert cell["config"]["name"] == w["config"]
        drv = harness.driver(cell["driver"])
        assert callable(drv.run)
        assert callable(getattr(drv, "tiny", None)), cell["driver"]
        faults = getattr(drv, "FAULTS", {})
        assert set(harness.FAULT_KINDS) <= set(faults), (cell["driver"],
                                                         sorted(faults))
        assert all(callable(f) for f in faults.values())
        for m in cell["per_layer"]:
            assert callable(harness.reader(m["name"]))
    files = [c["file"] for c in spec["configs"]]
    assert len(set(files)) == len(files)
    for c in spec["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in spec["paths"]))
        assert (harness.ROOT / c["file"]).is_file()
        with open(harness.ROOT / c["file"]) as f:
            keys = set(json.load(f))
        reduced = c["reduced"]
        assert isinstance(reduced, list) and len(reduced) <= 16
        for key in reduced:
            assert isinstance(key, str) and NAME.match(key), key
            assert key in keys, (c["name"], key)


def test_entries_resolve_by_name():
    check_entries(SPEC)


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)
    for name in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(name), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [c["source"] for c in SPEC["configs"]] + [
            w["why"] for w in SPEC["workloads"]] + [
            m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_per_layer_metrics_move_what_their_cells_report():
    for cell_name in CELLS:
        cell = harness.resolve(SPEC, cell_name)
        reported = {m["name"] for m in cell["e2e"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in reported
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)


def _spec_with(**extra):
    spec = json.loads(json.dumps(SPEC))
    for key, entries in extra.items():
        spec[key] = spec[key] + entries
    return spec


def test_an_end_to_end_metric_of_some_cells_is_theirs_alone():
    spec = _spec_with(end_to_end=[{
        "name": "only_here", "unit": "ms", "better": "lower", "bound": 0.1,
        "source": "host_clock", "workloads": [CELLS[0]]}])
    for cell_name in CELLS:
        names = {m["name"] for m in harness.resolve(spec, cell_name)["e2e"]}
        assert ("only_here" in names) == (cell_name == CELLS[0])


def test_a_per_layer_metric_without_workloads_follows_its_moves():
    """Without a `workloads` key a per-layer metric is read in every cell
    that reports the end-to-end metric it moves."""
    spec = _spec_with(
        end_to_end=[{"name": "only_here", "unit": "ms", "better": "lower",
                     "bound": 0.1, "source": "host_clock",
                     "workloads": [CELLS[0]]}],
        per_layer=[{"name": "every_rate", "unit": "%", "better": "higher",
                    "source": "device_trace", "layer": "device",
                    "moves": "audio_s_per_s"},
                   {"name": "first_only", "unit": "ms", "better": "lower",
                    "source": "host_clock", "layer": "device",
                    "moves": "only_here"}])
    for cell_name in CELLS:
        names = {m["name"] for m in harness.resolve(spec, cell_name)
                 ["per_layer"]}
        assert "every_rate" in names
        assert ("first_only" in names) == (cell_name == CELLS[0])


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=120)
    assert proc.returncode != 0
    assert "metrics" not in proc.stdout


def test_run_without_the_program_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert "metrics" not in proc.stdout


# ------------------------------------------------------------ rehearsals

def rehearsal(spec, cell_name):
    """A cell of `spec` with its driver's tiny mix, and the driver."""
    cell = harness.resolve(spec, cell_name)
    drv = harness.driver(cell["driver"])
    cell["traffic"] = drv.tiny(cell["traffic"])
    return cell, drv


def rehearsals(spec):
    """(cell, fault) for each cell of `spec` and each fault its driver
    plants."""
    return [(w["name"], kind) for w in spec["workloads"]
            for kind in sorted(harness.driver(
                harness.resolve(spec, w["name"])["driver"]).FAULTS)]


def _tiny(cell_name):
    return rehearsal(SPEC, cell_name)[0]


def _run(cell, seed=2**31 + 7, devices=("cpu",), trace=False, seconds=0.01):
    res = harness.run_cell(cell, seed, seconds, trace, list(devices),
                           time.perf_counter())
    return harness.result_line(cell, res)


def _broken(spec, cell_name, fault, monkeypatch):
    cell, drv = rehearsal(spec, cell_name)
    drv.FAULTS[fault](monkeypatch)
    return _run(cell)


@pytest.mark.parametrize("cell_name", CELLS)
def test_sound_run_is_correct(cell_name):
    line = _run(_tiny(cell_name))
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


def test_a_run_over_two_devices_counts_both():
    """A cell over several chips splits its corpus over a mesh of them, as
    the program does for a user's cards; the line counts the devices."""
    line = _run(_tiny(CELLS[0]), devices=("cpu", "cpu"))
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 2


def test_setup_is_timed_in_parts():
    line = _run(_tiny(CELLS[0]))
    parts = line["setup_parts"]
    for key in ("context_s", "program_import_s", "library_s", "inputs_s",
                "warm_s"):
        assert parts[key] >= 0.0
    assert list(line)[-1] == "checks"


def test_traced_run_reads_its_metrics():
    """A traced run on the CPU: the profiler's stretch is read, the
    program's spans with it; no kernel of the port runs there, so the
    roofline is left out, not read as 0, as are the chain's pack and
    unpack, whose spans only the CUDA route opens."""
    cell = _tiny(CELLS[0])
    cell["traffic"]["trace_batches"] = 1
    line = _run(cell, trace=True, seconds=0.0)   # traced from its start
    assert line["correct"], line["checks"]
    assert "chain_roofline" not in line["metrics"]
    assert line["metrics"]["finalize_ms"]["value"] > 0.0
    assert line["metrics"]["program_idle_pct"]["value"] > 0.0
    assert not {"pack_ms", "unpack_ms", "material_order_ms"} \
        & set(line["metrics"])
    assert line["metrics"]["dispatch_ms"]["value"] > 0.0
    assert line["metrics"]["launches_per_batch"]["value"] == 0.0
    assert line["device"]["window_s"] > 0.0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_busy_seconds_average_over_chips():
    from benchmark import tracing

    def op(dev, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts,
                "dur": dur, "args": {"device": dev}}
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.batch",
               "ts": 0.0, "dur": 1000.0},
              op(0, 0.0, 600.0), op(0, 500.0, 300.0), op(1, 100.0, 200.0)]
    tr = tracing.parse(events, 1, [0.001], {"chips": 2})
    assert tr.busy_seconds() == pytest.approx((800.0 + 200.0) / 2 * 1e-6)
    one = tracing.parse(events[:3], 1, [0.001], {"chips": 1})
    assert one.busy_seconds() == pytest.approx(800.0 * 1e-6)


@pytest.mark.parametrize("cell_name,fault", [
    pytest.param(c, f, id=f"{c}-{f}") for c, f in rehearsals(SPEC)])
def test_broken_timed_path_is_not_correct(monkeypatch, cell_name, fault):
    line = _broken(SPEC, cell_name, fault, monkeypatch)
    assert not line["correct"], line["checks"]


# ------------------------------------------------- a driver of another kind

def _toy_step(state, x):
    """The toy program's step over every stream: a leaky sum carried in
    the state, each stream's answer its tanh."""
    new = 0.5 * state + x
    return np.tanh(new), new


def _toy_run(cell, prog):
    """A run of the toy driver: `steps` steps of `prog` over `streams`
    streams, each step's answers held to a plain loop after the window."""
    t0 = time.perf_counter()
    steps = int(cell["traffic"]["steps"])
    g = np.random.default_rng(cell["seed"])
    x = g.standard_normal((steps, int(cell["traffic"]["streams"])))
    setup_s = time.perf_counter() - t0
    w0 = time.perf_counter()
    state, outs, lat = np.zeros(x.shape[1]), [], []
    for row in x:
        s0 = time.perf_counter()
        out, state = prog.step(state, row)
        outs.append(out)
        lat.append(time.perf_counter() - s0)
    window_s = time.perf_counter() - w0
    ref_state, ref = 0.0, []
    for row in x:
        ref_state = 0.5 * ref_state + row
        ref.append(np.tanh(ref_state))
    return {"setup_s": setup_s, "setup_parts": {"inputs_s": setup_s},
            "e2e": {"steps_per_s": steps / window_s},
            "samples": {"steps_per_s": steps}, "attempted": steps,
            "failed": 0, "memory_peak_bytes": 0,
            "readings": compare.readings(np.array(outs), [], np.array(ref),
                                         []),
            "trace": None, "batch_ms": [1e3 * min(lat),
                                        1e3 * float(np.median(lat)),
                                        1e3 * max(lat)],
            "checked_clips": steps * x.shape[1], "reference_s": 0.0,
            "window_s": window_s, "devices": ["cpu"]}


def _toy_faults(prog):
    """The toy's faults, planted in its program's step."""
    real = prog.step

    def state_unchanged(monkeypatch):
        monkeypatch.setattr(prog, "step",
                            lambda state, x: (real(state, x)[0], state))

    def half_batch(monkeypatch):
        def half(state, x):
            b = x.shape[0] // 2
            out, new = real(state[:b], x[:b])
            fill = np.full(x.shape[0] - b, out.mean())
            return (np.concatenate([out, fill]),
                    np.concatenate([new, np.full(x.shape[0] - b,
                                                 new.mean())]))
        monkeypatch.setattr(prog, "step", half)

    def altered_answer(monkeypatch):
        def alter(state, x):
            out, new = real(state, x)
            out = out.copy()
            out[0] += 1e-3
            return out, new
        monkeypatch.setattr(prog, "step", alter)
    return {"state_unchanged": state_unchanged, "half_batch": half_batch,
            "altered_answer": altered_answer}


TOY_SPEC = {
    "command": ["python3", "benchmark/run.py"], "paths": ["benchmark"],
    "run_seconds": 10,
    "configs": [{"name": "toy", "source": "https://example.org/toy",
                 "file": "benchmark/configs/toy.json", "reduced": ["streams"],
                 "why": "a leaky sum per stream"}],
    "workloads": [{"name": "toy.stream", "config": "toy",
                   "traffic": "toy_stream", "chips": 1,
                   "why": "every stream stepped at once, open loop"}],
    "end_to_end": [
        {"name": "steps_per_s", "unit": "steps/s", "better": "higher",
         "bound": 0.1, "source": "host_clock"},
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock"}],
    "per_layer": [{"name": "toy_step_ms", "unit": "ms", "better": "lower",
                   "source": "program_span", "layer": "toy step",
                   "moves": "steps_per_s", "workloads": ["toy.stream"]}],
}


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """A checkout whose one cell names the toy driver: its configuration,
    mix and metric reader as files, the driver as a module; returns its
    spec and the driver."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        (bench / sub).mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(TOY_SPEC))
    (bench / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "decay": 0.5, "streams": 4096}))
    (bench / "traffic" / "toy_stream.json").write_text(json.dumps(
        {"driver": "toy", "streams": 4096, "steps": 1000}))
    (bench / "metrics" / "toy_step_ms.py").write_text(
        "def read(tr):\n    return None\n")
    prog = types.SimpleNamespace(step=_toy_step)
    drv = types.ModuleType("benchmark.drivers.toy")
    drv.run = lambda cell: _toy_run(cell, prog)
    drv.tiny = lambda traffic: dict(traffic, streams=6, steps=3)
    drv.FAULTS = _toy_faults(prog)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "BENCH_DIR", bench)
    monkeypatch.setitem(sys.modules, "benchmark.drivers.toy", drv)
    return harness.load_spec(), drv


def test_a_cell_of_another_driver_is_rehearsed_by_the_same_cases(
        toy, monkeypatch, capsys):
    """The toy cell resolves and passes the entries' check; the cases that
    the tests above take from BENCHMARK.json cover it: its sound run is
    correct, and each fault its driver plants is not. The run's command
    prints its line from the keys the contract names."""
    import torch

    spec, _drv = toy
    check_entries(spec)
    assert rehearsals(spec) == [("toy.stream", k)
                                for k in sorted(harness.FAULT_KINDS)]
    line = _run(rehearsal(spec, "toy.stream")[0])
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"steps_per_s", "setup_s"}
    for cell_name, fault in rehearsals(spec):
        with monkeypatch.context() as mp:
            line = _broken(spec, cell_name, fault, mp)
        assert not line["correct"], (fault, line["checks"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "forbidden_modules", list)
    assert harness.main(["--workload", "toy.stream", "--seed", "5",
                         "--seconds", "0.01"], time.perf_counter()) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and list(out)[-1] == "checks"
    assert out["attempted"] == 1000


@pytest.mark.parametrize("missing", ("tiny",) + harness.FAULT_KINDS)
def test_a_driver_without_its_rehearsal_fails_the_entries_check(toy,
                                                                missing):
    spec, drv = toy
    if missing == "tiny":
        del drv.tiny
    else:
        drv.FAULTS = {k: v for k, v in drv.FAULTS.items() if k != missing}
    with pytest.raises(AssertionError):
        check_entries(spec)
