"""Where the time of the port's corpus scoring goes, on one NVIDIA GPU.

    python3 tools/profile_corpus_torch.py [--plugin texture --material 1]
    python3 tools/profile_corpus_torch.py --plugin chain [--mixed]
    python3 tools/profile_corpus_torch.py --plugin texture --mixed
    python3 tools/profile_corpus_torch.py --plugin serve
    python3 tools/profile_corpus_torch.py --plugin relaxed

Runs ``juicy_tpu_torch.parallel.corpus.run_corpus`` at chip_smoke.py's full
width (4096 stereo clips of 94 blocks of 512 samples at 48 kHz, inputs made
on the card as there: punch and motion get its burst input, the others its
noise over a sine), or with ``--plugin chain`` ``run_corpus_chain`` on
bench.py's seven-stage chain as chip_smoke.py's phase 4e runs it (8192
clips, the burst input, ``metrics="final"``), or with ``--plugin serve`` 30
serving ticks (``submit_many`` and ``tick_arrays``) of a ``StreamServer`` on
that chain with all of chip_smoke.py's 4096 slots open, fed its PCM16 burst
input, or with ``--plugin relaxed`` ``relaxed_chain_stream`` (the relaxed
tier, plain PyTorch operations on the card) on that chain at chip_smoke.py
phase 7's width (256 clips, the burst input) over RELAXED_PROFILE_BLOCKS
blocks. ``--mixed`` gives the corpus a texture material per clip
(``arange(B) % 5``, bench.py's ``bench_mixed_materials``; the chain without
its audio, as there): one warm-up run, one timed run, then one run under
``torch.profiler``. Prints the card's name and power limit, the timed and
profiled walls, the profiled run's device busy time (the sum of its
kernels' times) by kernel name, its host ops by their own host time, its
count of ``cudaLaunchKernel`` calls (and per block), and its device idle
share: one minus
busy over that same run's wall. The
profiler's own host cost is in that wall, so the share is an upper bound
for the unprofiled run. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import (BATCH, BLOCK, CHAIN, CHAIN_CORPUS_BATCH,  # noqa: E402
                        CHANNELS, NUM_BLOCKS, PRESET, PUNCH_PRESET,
                        RELAXED_BATCH, SERVE_BLOCKS, SERVE_SLOTS,
                        SERVE_TIMED, SR, make_batch, make_clicks)

#: blocks of the relaxed chain per run (each makes ~36 k launches, which
#: the profiler records one by one)
RELAXED_PROFILE_BLOCKS = 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plugin", choices=("punch", "saturator", "texture",
                                         "motion", "chain", "serve",
                                         "relaxed"),
                    default="texture")
    ap.add_argument("--material", type=int, default=1)
    ap.add_argument("--mixed", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_corpus_torch: needs a CUDA device")
    from juicy_tpu_torch.parallel.corpus import run_corpus, run_corpus_chain
    from juicy_tpu_torch.runtime.plugin import Chain, Plugin

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    device = torch.device("cuda", 0)
    batch = CHAIN_CORPUS_BATCH if args.plugin == "chain" else BATCH
    if args.plugin == "chain":
        chain = Chain(CHAIN, SR, CHANNELS, BLOCK)
        clips = make_clicks(batch, CHANNELS, NUM_BLOCKS * BLOCK, device,
                            seed=31)

        kw = {"materials": torch.arange(batch) % 5,
              "return_audio": False} if args.mixed else {}

        def run():
            run_corpus_chain(chain, clips, **kw)
            torch.cuda.synchronize()

        profile_run(run, "chain, mixed materials" if args.mixed else "chain",
                    batch)
        return
    if args.plugin == "serve":
        profile_serve(device)
        return
    if args.plugin == "relaxed":
        profile_relaxed(device)
        return
    plugin = Plugin(args.plugin, SR, CHANNELS, BLOCK)
    if args.plugin == "texture":
        plugin = plugin.with_traced("material") if args.mixed else \
            plugin.with_static(material=args.material)
    params = {"saturator": lambda: plugin.preset(PRESET),
              "punch": lambda: plugin.preset(PUNCH_PRESET)}.get(
                  args.plugin, plugin.default_params)()
    if args.mixed:
        params["material"] = (torch.arange(BATCH) % 5).float()
    if args.plugin in ("punch", "motion"):
        clips = make_clicks(BATCH, CHANNELS, NUM_BLOCKS * BLOCK, device,
                            seed=23)
    else:
        clips = make_batch(BATCH, CHANNELS, NUM_BLOCKS * BLOCK, device)

    def run():
        run_corpus(plugin, params, clips)
        torch.cuda.synchronize()

    what = "mixed materials" if args.mixed else f"material {args.material}"
    profile_run(run, args.plugin + (f" {what}" if args.plugin == "texture"
                                    else ""), batch)


def profile_serve(device):
    from juicy_tpu_torch.runtime.plugin import Chain
    from juicy_tpu_torch.runtime.serve import StreamServer

    s, n = SERVE_SLOTS, BLOCK
    srv = StreamServer(Chain(CHAIN, SR, CHANNELS, n), s)
    srv.warmup()
    sids = [srv.open_stream() for _ in range(s)]
    x = make_clicks(s, CHANNELS, SERVE_BLOCKS * n, device, seed=47)
    clips = (torch.round(x * 32768.0) / 32768.0).cpu().numpy()

    def run():
        for k in range(SERVE_TIMED):
            j = k % SERVE_BLOCKS
            srv.submit_many(sids, clips[..., j * n:(j + 1) * n])
            srv.tick_arrays()

    profile_run(run, f"serve ({SERVE_TIMED} ticks)", s, SERVE_TIMED)


def profile_relaxed(device):
    from juicy_tpu_torch.runtime.plugin import Chain
    from juicy_tpu_torch.runtime.relaxed import relaxed_chain_stream

    b, nb = RELAXED_BATCH, RELAXED_PROFILE_BLOCKS
    chain = Chain(CHAIN, SR, CHANNELS, BLOCK)
    clips = make_clicks(b, CHANNELS, nb * BLOCK, device, seed=71)

    def run():
        relaxed_chain_stream(chain, chain.init_state((b,), device), clips)
        torch.cuda.synchronize()

    profile_run(run, "relaxed chain", b, nb)


def profile_run(run, tag, batch, blocks=NUM_BLOCKS):
    """A warm-up, a timed run and a profiled run of `run`; prints the
    walls, the device busy time by kernel and the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()                                   # warm-up: build, caches
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernels only: the aten ops that launched them carry the same time
    device = sorted(((e.key, e.self_device_time_total, e.count)
                     for e in events if e.device_type == DeviceType.CUDA
                     and e.self_device_time_total > 0),
                    key=lambda r: -r[1])
    busy = sum(t for _k, t, _c in device) / 1e6      # us -> s
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"{tag}: B={batch} blocks={blocks}: wall {wall:.4f} s, "
          f"profiled wall {prof_wall:.4f} s, device busy {busy:.4f} s, "
          f"cudaLaunchKernel {launches} ({launches / blocks:.0f} per block)")
    for key, t, count in device[:10]:
        print(f"  {t / 1e3:10.3f} ms  x{count:<6d} {key[:90]}")
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in events
                   if e.device_type == DeviceType.CPU
                   and e.self_cpu_time_total > 0), key=lambda r: -r[1])
    print("host ops by their own host time:")
    for key, t, count in host[:12]:
        print(f"  {t / 1e3:10.3f} ms  x{count:<6d} {key[:90]}")
    print(f"device idle {100 * (1 - busy / prof_wall):.1f}% of the profiled "
          f"run's wall")


if __name__ == "__main__":
    main()
