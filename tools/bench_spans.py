"""A benchmark cell's traced run with the program's spans read.

    python3 tools/bench_spans.py --workload chain_gel.corpus --seed <n> \
        --seconds 50 [--out spans_gel.json]

Runs the cell as ``benchmark/run.py --trace 1`` does, on one card per chip
the cell asks for, and reads its traced stretch with the spans that the
program opens (``juicy.*``, ``runtime/observe.py::span``) attached to the
trace (``benchmark/spans.py``). Prints the cell's traced result line with
the span readers of ``benchmark/metrics/`` (``finalize_ms``, ``pack_ms``,
``unpack_ms``, ``material_order_ms``, ``program_idle_pct``) among its
metrics, then a JSON object with the card's name and power limit, each
phase's device window per batch beside the device time of the port's own
kernels and the traced batch's time, and, for each span, its host time and
the CUDA runtime calls that ran directly inside it (in no span nested in
it) per batch: where the call into the program blocks. Needs a CUDA
device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness, spans, tracing  # noqa: E402

#: the span readers, as BENCHMARK.json entries name them
READERS = {"finalize_ms": "ms", "pack_ms": "ms", "unpack_ms": "ms",
           "material_order_ms": "ms", "program_idle_pct": "%"}
PHASES = {"pack": ("juicy.chain.pack",), "unpack": ("juicy.chain.unpack",),
          "finalize": ("juicy.finalize",),
          "material_order": ("juicy.order.gather", "juicy.order.scatter")}


def waits(tr, events, prefix="juicy."):
    """{span: {"host_ms": its host time, "calls": {runtime call: [ms,
    count]}}} per traced batch, each runtime call given to the innermost
    `prefix` span around it on its thread."""
    inner = sorted(((n, tid, s, e) for n, tid, s, e in tr.spans
                    if n.startswith(prefix) and tr.start <= s <= tr.end),
                   key=lambda sp: sp[2])
    out = {}
    for n, _tid, s, e in inner:
        row = out.setdefault(n, {"host_ms": 0.0, "calls": {}})
        row["host_ms"] += (e - s) * 1e-3 / tr.batches
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in ("cuda_runtime",
                                                         "cuda_driver"):
            continue
        ts, tid = float(ev["ts"]), ev.get("tid")
        around = [sp for sp in inner if sp[1] == tid and sp[2] <= ts <= sp[3]]
        if not around:
            continue
        calls = out[around[-1][0]]["calls"]
        ms, count = calls.get(ev["name"], [0.0, 0.0])
        calls[ev["name"]] = [ms + float(ev["dur"]) * 1e-3 / tr.batches,
                             count + 1.0 / tr.batches]
    for row in out.values():
        row["calls"] = dict(sorted(row["calls"].items(),
                                   key=lambda kv: -kv[1][0]))
    return out


def phases(tr):
    """Each phase's device window per batch (ms), the port's own kernels'
    device time per batch, the traced batch's time, and their sum."""
    out = {k: spans.phase_ms(tr, *names) for k, names in PHASES.items()}
    own = sum(min(e, tr.end) - max(s, tr.start)
              for _n, s, e, lib in tr.device if lib and e > tr.start)
    out["own_kernels"] = own * 1e-3 / tr.batches
    out["batch"] = (tr.end - tr.start) * 1e-3 / tr.batches
    out["sum"] = sum(v for k, v in out.items() if k != "batch" and v)
    return out


def run(cell, seed, seconds, devices):
    """The cell's traced run with the spans attached: (result line,
    report)."""
    parse, seen = tracing.parse, {}

    def parse_with_spans(events, *args):
        tr = parse(events, *args)
        spans.attach(tr, events)
        seen.update(tr=tr, events=events)
        return tr

    cell = dict(cell, per_layer=cell["per_layer"] + [
        {"name": n, "unit": u} for n, u in READERS.items()])
    tracing.parse = parse_with_spans
    try:
        res = harness.run_cell(cell, seed, seconds, True, devices, T0)
    finally:
        tracing.parse = parse
    line = harness.result_line(cell, res)
    tr = seen["tr"]
    return line, {"phases": phases(tr), "waits": waits(tr, seen["events"]),
                  "batch_ms": res["batch_ms"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    cell = harness.resolve(harness.load_spec(), args.workload)
    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise SystemExit(f"bench_spans: needs {chips} CUDA device(s)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    line, report = run(cell, args.seed, args.seconds,
                       [f"cuda:{i}" for i in range(chips)])
    report = dict(workload=args.workload, seed=args.seed, card=card,
                  **report)
    print(json.dumps(line), flush=True)
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"line": line, **report}, f, indent=1)


if __name__ == "__main__":
    main()
