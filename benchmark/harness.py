"""The benchmark's harness: finds a cell's configuration, traffic mix,
driver and metric readers by the names in BENCHMARK.json, runs the cell
once and prints its result line.

Nothing here is keyed to one cell: a configuration is
``benchmark/configs/<config>.json`` (the file BENCHMARK.json names), a mix
``benchmark/traffic/<traffic>.json``, whose ``driver`` names
``benchmark/drivers/<driver>.py``, and a per-layer metric
``benchmark/metrics/<metric>.py`` with ``read(trace)`` (a
``tracing.Trace``, the program's spans attached; None where it finds
nothing to read, and the line leaves the metric out).

A driver holds three things:

* ``run(cell) -> dict``: one run. `cell` is what ``resolve`` gives, with
  ``seed``, ``seconds``, ``trace``, ``devices`` (one per chip the cell asks
  for, ``cuda:0`` on; ``cpu`` in a rehearsal), ``t0`` (the process's start,
  on ``time.perf_counter``) and ``parts`` (the set-up's parts timed before
  the driver, in seconds). It makes its inputs from the seed, warms up
  every shape the window uses, measures for ``seconds`` (a traced stretch
  inside the window where ``trace`` is set: ``tracing.Stretch``), reads
  the device's peak, then holds what the timed path produced to the plain
  reference. It returns:

  - ``setup_s``: seconds from ``t0`` to the window's start;
  - ``setup_parts``: {part: seconds, or a flag} of the set-up;
  - ``e2e``: {metric: value} for the cell's end-to-end metrics but
    ``setup_s``; ``samples``: {metric: how many samples it was taken over};
  - ``attempted``, ``failed``: the requests (batches, ticks) of the window
    and those that failed;
  - ``memory_peak_bytes``: the fullest device's peak over the window;
  - ``readings``: {number: reading} of the numbers benchmark/compare.py
    holds to their limits;
  - ``trace``: the traced stretch's ``Trace``, or None;
  - ``batch_ms``: [min, median, max] ms of the window's requests;
    ``checked_clips``: how many answers (clips, streams) were compared;
    ``reference_s``: the reference's seconds; ``window_s``: the window's;
  - ``devices`` (optional): those it ran on, by default those given.

* ``tiny(traffic) -> dict``: a copy of the mix cut so that ``run`` takes
  every path of the driver on the CPU in seconds; benchmark/tests rehearse
  every cell with it.

* ``FAULTS``: {kind: plant(monkeypatch)}, faults planted in the program
  under the driver's timed path through pytest's ``monkeypatch``, one
  rehearsal each, which has to come out not correct. It holds one of each
  kind in ``FAULT_KINDS``: ``state_unchanged`` (each step starts from the
  state the step before started from), ``half_batch`` (part of the work,
  clips or slots, left out and filled in) and ``altered_answer`` (one
  answer changed where it is produced).

A cell of a new driver, configuration or mix is so added with new files
and new entries in BENCHMARK.json alone.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "juicy_tpu")
#: the kinds of fault each driver's FAULTS plants, one of each
FAULT_KINDS = ("state_unchanged", "half_batch", "altered_answer")


def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(spec: dict, workload: str) -> dict:
    """A cell by name: its entry, configuration (the file its `configs`
    entry names), traffic mix and driver module name, and the metrics it
    reports (end-to-end, and per layer in a traced run)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    entry = {cfg["name"]: cfg for cfg in spec["configs"]}[w["config"]]
    with open(ROOT / entry["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {"name": workload, "entry": w, "config": config,
            "traffic": traffic, "driver": traffic["driver"], "e2e": e2e,
            "per_layer": per_layer}


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def reader(name: str):
    """The `read(trace)` of ``benchmark/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the whole name before the first dot)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _num(v):
    """A reading as JSON can hold it: non-finite reads as 1e308."""
    v = float(v)
    return v if math.isfinite(v) else 1e308


def result_line(cell: dict, res: dict) -> dict:
    """The run's result: correct, attempted, failed, metrics, device, and
    in a traced run the breakdown; the compared numbers last."""
    import torch

    from benchmark import compare, tracing

    table, correct = compare.checks(res["readings"])
    devs = res["devices"]
    cuda = devs[0].startswith("cuda")
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"]}
    device = {"platform": "gpu" if cuda else devs[0],
              "kind": torch.cuda.get_device_name(devs[0]) if cuda else "cpu",
              "count": len(devs),
              "memory_peak_bytes": res["memory_peak_bytes"]}
    tr = res["trace"]
    if tr is None:
        vals = dict(res["e2e"], setup_s=res["setup_s"])
        metrics = {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                   for m in cell["e2e"]}
        line["metrics"] = metrics
        line["device"] = device
    else:
        metrics = {}
        for m in cell["per_layer"]:
            v = reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        line["metrics"] = metrics
        device.update(busy_s=tr.busy_seconds(), window_s=tr.seconds)
        line["device"] = device
        line["breakdown"] = tracing.breakdown(tr)
    line["samples"] = res.get("samples", {})
    line["setup_parts"] = res["setup_parts"]
    line["checks"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                      for k, v in table.items()}
    return line


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             devices: list, t0: float, parts: dict | None = None) -> dict:
    """One run of `cell` on `devices` (one per chip the cell asks for);
    the driver's result, with the devices it ran on. `parts` holds the
    set-up's parts timed before the driver, in seconds."""
    res = driver(cell["driver"]).run(dict(
        cell, seed=seed, seconds=seconds, trace=trace, devices=list(devices),
        t0=t0, parts=dict(parts or {})))
    res.setdefault("devices", list(devices))
    return res


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = resolve(load_spec(), args.workload)
    chips = int(cell["entry"]["chips"])
    import torch

    parts = {"import_s": time.perf_counter() - t0}

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no result", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   [f"cuda:{i}" for i in range(chips)], t0, parts)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    line = result_line(cell, res)
    lo, mid, hi = res["batch_ms"]
    print(f"samples {res['samples']}; batch ms min {lo:.2f} median {mid:.2f} "
          f"max {hi:.2f}; checked clips {res['checked_clips']}; reference "
          f"{res['reference_s']:.1f} s; window {res['window_s']:.2f} s",
          file=sys.stderr)
    print("setup " + ", ".join(f"{k} {v!r}" for k, v in
                               res["setup_parts"].items()), file=sys.stderr)
    for name, v in line["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
