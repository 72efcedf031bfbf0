"""The harness rehearsed on the CPU: BENCHMARK.json's entries resolve to
their files by name and keep to the contract's characters, each per-layer
metric moves an end-to-end metric that its cells report, a run without a
card prints no result, and a run whose timed path is broken underneath
comes out not correct, once for each fault the cells can have."""

import json
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_entries_resolve_by_name():
    for w in SPEC["workloads"]:
        cell = harness.resolve(SPEC, w["name"])
        assert cell["config"]["name"] == w["config"]
        assert harness.driver(cell["driver"]).run
        for m in cell["per_layer"]:
            assert callable(harness.reader(m["name"]))
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert (harness.ROOT / c["file"]).is_file()
        assert c["reduced"] == []


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


# --------------------------------------------------------------- faults

def _tiny(cell_name):
    cell = harness.resolve(SPEC, cell_name)
    cell["traffic"].update(batch=6, blocks=2, corpora=1, check_clips=4)
    return cell


def _run(cell, seed=2**31 + 7, devices=("cpu",), trace=False, seconds=0.01):
    res = harness.run_cell(cell, seed, seconds, trace, list(devices),
                           time.perf_counter())
    return harness.result_line(cell, res)


def _state_unchanged(monkeypatch):
    """Each block starts from the state the block before started from."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    plain = ck.chain_block_plain

    def block(chain, dsps, lane_prev, blk):
        out, _new, fin, acc = plain(chain, dsps, lane_prev, blk)
        return out, dsps, fin, acc
    monkeypatch.setattr(ck, "chain_block_plain", block)


def _half_batch(monkeypatch):
    """The second half of the clips left out, given the mean of the rest."""
    from juicy_tpu_torch.parallel import corpus

    real = corpus.run_corpus_chain

    def half(chain, clips, **kw):
        b = clips.shape[0] // 2
        mats = kw.pop("materials", None)
        out, ms, agg = real(chain, clips[:b], materials=None if mats is None
                            else mats[:b], **kw)

        def fill(v):
            rest = v.mean(0, keepdim=True).expand(clips.shape[0] - b,
                                                  *v.shape[1:])
            return np.concatenate([v.numpy(), rest.numpy()])
        import torch
        out = None if out is None else torch.from_numpy(fill(out))
        return out, [{k: torch.from_numpy(fill(v)) for k, v in m.items()}
                     for m in ms], agg
    monkeypatch.setattr(corpus, "run_corpus_chain", half)


def _altered(monkeypatch):
    """One answer altered where it is produced: one sample of each clip's
    audio, and the final score of each clip."""
    from juicy_tpu_torch.parallel import corpus

    real = corpus.run_corpus_chain

    def alter(chain, clips, **kw):
        out, ms, agg = real(chain, clips, **kw)
        if out is not None:
            out[:, 0, 100] += 1e-3
        ms[-1]["score"] = ms[-1]["score"] + 0.5
        return out, ms, agg
    monkeypatch.setattr(corpus, "run_corpus_chain", alter)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "altered_answer": _altered}


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
    """A traced run on the CPU: the profiler's stretch is read; no kernel
    of the port runs there, so the roofline is left out, not read as 0."""
    cell = _tiny(CELLS[0])
    cell["traffic"]["trace_batches"] = 1
    line = _run(cell, trace=True, seconds=0.0)   # traced from its start
    assert line["correct"], line["checks"]
    assert "chain_roofline" not in line["metrics"]
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


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell_name", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, cell_name, fault):
    FAULTS[fault](monkeypatch)
    line = _run(_tiny(cell_name))
    assert not line["correct"], line["checks"]
