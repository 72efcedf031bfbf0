"""The control of the comparison that decides `correct`: the plain
reference with its audio and state held in bfloat16 (reference/bf16.py)
put in the program's place, at a cell's own size, on the clips that a run of that seed
compares. It has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

draws each seed's corpora on the card as a run does, takes the clips its
check compares, runs the float32 reference and the bfloat16 one over
them in worker processes on the host (one per core at most), and prints
one JSON line per seed: the control's readings against the limits. The
benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import compare, harness  # noqa: E402


def clip_sets(cell, seed, device):
    """The inputs [K, C, T] and materials of the clips a run of `seed`
    compares (each corpus's sample, in turn)."""
    import numpy as np
    import torch

    from benchmark.drivers import corpus as drv

    run = dict(cell, seed=seed, device=device)
    xs, mats = [], []
    for i in range(int(cell["traffic"]["corpora"])):
        x, m = drv.draw(run, i)
        idx = drv.check_clips(cell["traffic"], x.shape[0], m, seed, i)
        xs.append(x.index_select(0, torch.from_numpy(idx).to(x.device))
                  .cpu().numpy())
        mats.append(None if m is None else m[idx])
        del x
    return (np.concatenate(xs),
            None if mats[0] is None else np.concatenate(mats))


def control(args):
    """(seed, readings of the bfloat16 control against the float32
    reference, seconds) for one seed's clips."""
    cell, seed, x, mats = args
    from benchmark.reference.chain import run_chain

    t0 = time.perf_counter()
    ref_out, ref_ms = run_chain(cell["config"], x, mats)
    low_out, low_ms = run_chain(cell["config"], x, mats,
                                precision="bfloat16")
    import numpy as np

    got = compare.readings(
        np.asarray(low_out) if cell["traffic"]["return_audio"] else None,
        [{k: np.asarray(v) for k, v in m.items()} for m in low_ms],
        ref_out, ref_ms)
    return seed, got, time.perf_counter() - t0


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args(argv)
    cell = harness.resolve(harness.load_spec(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    import torch

    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    work = [(cell, s, *clip_sets(cell, s, device)) for s in seeds]
    torch.cuda.empty_cache() if device != "cpu" else None
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(args.jobs, len(work))) as pool:
        for seed, got, secs in pool.imap_unordered(control, work):
            table, ok = compare.checks(got)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control_correct": ok, "seconds": secs,
                              "checks": {k: {"value": harness._num(v["value"]),
                                             "limit": v["limit"]}
                                         for k, v in table.items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
