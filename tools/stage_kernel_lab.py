"""Measurements of the stage kernels (csrc/punch_stage.cu,
csrc/saturator_stage.cu, csrc/texture_stage.cu, csrc/motion_stage.cu) that
need a scratch build, on one NVIDIA GPU.

    python3 tools/stage_kernel_lab.py compare --parent DIR [--kernels K,...]
    python3 tools/stage_kernel_lab.py roles [--kernels K,...]
    python3 tools/stage_kernel_lab.py unroll 1,2 [--kernels K,...]

``--kernels`` picks among punch, saturator, motion and texture (every
material); all four by default. Each subcommand copies a ``csrc/`` into the
git-ignored ``_archive/lab/``, patches the copy there where it needs to and
builds it with the package's own nvcc flags (tools/chain_kernel_lab.py's
helpers); nothing in the package changes, and no stamp is compiled into it.

- ``compare``: the kernels of DIR (a parent's ``csrc/``, e.g. from
  ``git archive 3402282 juicy_tpu_torch/csrc``; the same C interface)
  against the present ones, for each kernel (texture: every material) at
  B = 4096 and 8192 (N = 512, stereo): outputs, state and both lanes held
  equal bit for bit, then each alone per block in turns (parent, new, new,
  parent); then ``run_corpus`` for punch, the saturator, motion and
  texture gel, metal and wood at B = 4096 x 94 blocks in the same turns.
- ``roles``: ``clock64()`` stamps in the present kernels at the end of
  each warp's role and of the pre lane, in cycles since the CTA's start,
  and each warp's cycles spent waiting on its barriers (pipe.cuh's
  mbar_wait), mean (and max) over CTAs.
- ``unroll``: the present kernels with the lanes' sample loops
  (stage_lane.cuh part_pass) unrolled by each factor, side by side:
  registers and spills, outputs equal to the plain version's on a ragged
  batch, times in turns.

Kernels are timed alone with chip_smoke.py's kernel_ms (launches queued
behind a spin kernel, so the host's launch time is not counted). Each run
prints the card's name and power limit first. Inputs are chip_smoke.py's,
from a seed. Needs a CUDA device and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import chain_kernel_lab as lab  # noqa: E402
from chain_kernel_lab import cs  # noqa: E402
from juicy_tpu_torch.kernels import _build  # noqa: E402
from juicy_tpu_torch.kernels import stage_kernels as sk  # noqa: E402

KERNELS = ("punch", "saturator", "motion", "texture")
#: (kernel, texture material or None)
CASES = (("punch", None), ("saturator", None), ("motion", None),
         *(("texture", m) for m in range(5)))
#: the run_corpus cells of ``compare``
CORPORA = (("punch", None), ("saturator", None), ("motion", None),
           ("texture", 0), ("texture", 1), ("texture", 2))
BATCHES = (4096, 8192)


def _name(case):
    kernel, mode = case
    return kernel if mode is None else f"texture {cs.MATERIALS[mode]}"


def _plugin(case, n=cs.BLOCK):
    """(plugin, params) of a case: punch "Solar Snap", the saturator "Amber
    Heat", motion and texture at their defaults."""
    from juicy_tpu_torch.runtime.plugin import Plugin

    kernel, mode = case
    plug = Plugin(kernel, cs.SR, cs.CHANNELS, n)
    if kernel == "texture":
        plug = plug.with_static(material=mode)
        return plug, plug.full_params(plug.default_params())
    params = {"punch": lambda: plug.preset(cs.PUNCH_PRESET),
              "saturator": lambda: plug.preset(cs.PRESET),
              "motion": plug.default_params}[kernel]()
    return plug, params


def _setup(case, b, device):
    """(params, block, a maker of fresh states) for `case`: punch and motion
    on the burst input, the saturator and texture on bench.py's signal."""
    kernel, mode = case
    plug, params = _plugin(case)
    if kernel in ("punch", "motion"):
        x = cs.make_clicks(b, cs.CHANNELS, cs.BLOCK, device, seed=19)
    else:
        x = cs.make_batch(b, cs.CHANNELS, cs.BLOCK, device, seed=13)

    def state():
        st = plug.init_state((b,), device)
        if kernel == "texture":
            st = {"analyzer": st["analyzer"],
                  "dsp": sk.texture_kernel_state(st["dsp"], mode)}
        return st

    return params, x, state


def _route(case, route, params, x, st):
    """The kernel's (route "cuda") or the plain version's raw results:
    (out, state', pre fin, pre acc, post fin, post acc)."""
    kernel, mode = case
    lane0 = sk.pack_lane(st["analyzer"], x.shape[0])
    if kernel == "saturator":
        return getattr(sk, f"_sat_lanes_{route}")(
            x, st["dsp"]["tone_state"], lane0, sk._sat_scalars(params, cs.SR))
    if kernel == "texture":
        return getattr(sk, f"_tex_lanes_{route}")(x, st["dsp"], lane0, params,
                                                  cs.SR, mode)
    return getattr(sk, f"_{kernel}_lanes_{route}")(x, st["dsp"], lane0,
                                                   params, cs.SR)


def _launcher(case, params, x, st):
    """One launch on prepared buffers, for timing."""
    kernel, mode = case
    lane0 = sk.pack_lane(st["analyzer"], x.shape[0])
    if kernel == "saturator":
        bufs = sk.sat_cuda_buffers(x, st["dsp"]["tone_state"], lane0)
        scalars = sk._sat_scalars(params, cs.SR)
        return lambda: sk.sat_cuda_launch(bufs, scalars)
    if kernel == "texture":
        bufs = sk.tex_cuda_buffers(x, st["dsp"], lane0, mode)
        return lambda: sk.tex_cuda_launch(bufs, params, cs.SR, mode)
    bufs = getattr(sk, f"{kernel}_cuda_buffers")(x, st["dsp"], lane0)
    launch = getattr(sk, f"{kernel}_cuda_launch")
    return lambda: launch(bufs, params, cs.SR)


def _picked(cases, kernels):
    return [c for c in cases if c[0] in kernels]


def _equal(a, b):
    out_a, dsp_a, *raw_a = a
    out_b, dsp_b, *raw_b = b
    if isinstance(dsp_a, torch.Tensor):
        dsp_a, dsp_b = {"tone_state": dsp_a}, {"tone_state": dsp_b}
    return (torch.equal(out_a, out_b) and set(dsp_a) == set(dsp_b)
            and all(torch.equal(dsp_a[k], dsp_b[k]) for k in dsp_a)
            and all(torch.equal(p, q) for p, q in zip(raw_a, raw_b)))


def cmd_compare(args, device):
    from juicy_tpu_torch.parallel.corpus import run_corpus

    sources = tuple(f"{k}_stage.cu" for k in args.kernels)
    libs = {"parent": lab._load(lab._copy(Path(args.parent), "parent"),
                                sources=sources)[0],
            "new": lab._load(lab._copy(_build.SRC_DIR, "new"),
                             sources=sources)[0]}
    order = ("parent", "new", "new", "parent")
    all_equal = True
    for b in BATCHES:
        for case in _picked(CASES, args.kernels):
            params, x, state = _setup(case, b, device)
            res = {}
            for name, lib in libs.items():
                lab._use(lib)
                res[name] = _route(case, "cuda", params, x, state())
            torch.cuda.synchronize()
            same = _equal(res["parent"], res["new"])
            all_equal = all_equal and same
            del res
            times = []
            for name in order:
                lab._use(libs[name])
                times.append(cs.kernel_ms(_launcher(case, params, x, state()),
                                          20))
            parent = (times[0] + times[3]) / 2
            new = (times[1] + times[2]) / 2
            print(f"{_name(case)} B={b}: " + ", ".join(
                f"{n} {t:.4f}" for n, t in zip(order, times))
                + f" ms alone; parent {parent:.4f}, new {new:.4f}, "
                f"speed-up {parent / new:.2f}x; outputs, state and lanes "
                f"equal: {same}", flush=True)
    b, n = cs.BATCH, cs.BLOCK
    for case in _picked(CORPORA, args.kernels):
        plug, _params = _plugin(case, n)
        params = (plug.default_params() if case[0] == "texture"
                  else _params)
        if case[0] in ("punch", "motion"):
            clips = cs.make_clicks(b, cs.CHANNELS, cs.NUM_BLOCKS * n, device,
                                   seed=23)
        else:
            clips = cs.make_batch(b, cs.CHANNELS, cs.NUM_BLOCKS * n, device,
                                  seed=17)
        walls, outs = [], {}
        for name in order:
            lab._use(libs[name])
            run_corpus(plug, params, clips)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _last, _agg = run_corpus(plug, params, clips)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            outs.setdefault(name, out)
            del out
        same = torch.equal(outs["parent"], outs["new"])
        all_equal = all_equal and same
        t = clips.shape[-1]
        print(f"run_corpus {_name(case)} B={b} x {cs.NUM_BLOCKS} blocks: "
              + ", ".join(f"{nm} {w:.4f} s ({b * t / cs.SR / w:.1f} "
                          f"audio-s/s)" for nm, w in zip(order, walls))
              + f"; outputs equal: {same}", flush=True)
        del outs, clips
    print(f"every output equal, parent against new: {all_equal}")
    if not all_equal:
        raise SystemExit("the new kernels differ from the parent's")


ROLES = {
    "punch_stage.cu": ("V", "L", "E", "F0", "F1", "H0", "H1", "H2", "H3",
                       "H4", "H5"),
    "saturator_stage.cu": ("V", "L", "E", "S0", "S1", "H0", "H1", "H2",
                           "H3"),
    "motion_stage.cu": ("V", "L", "E", "P", "Z0", "Z1", "C0", "C1", "G",
                        "H0", "H1", "H2", "H3", "H4", "H5", "H6", "H7"),
    "texture_stage.cu": ("V", "L", "E", "F0", "F1", "M0", "M1", "W0", "W1",
                         "D0", "D1", "H0", "H1", "H2", "H3"),
}
PRE = 31  # the stamp of L's pre lane


WAIT_HELPERS = "__device__ long long g_wait[32 * 1024];\n"
WAIT_ADD = ("  if (threadIdx.x % 32 == 0) g_wait[(threadIdx.x / 32) * 1024 + "
            "blockIdx.x] += clock64() - t_wait;\n")
WAIT_OUT = """
extern "C" int juicy_stage_waits(long long* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, g_wait, n * sizeof(long long), 0, cudaMemcpyDeviceToDevice));
}
extern "C" int juicy_stage_waits_clear() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, g_wait);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_wait));
  return static_cast<int>(err);
}
"""


def cmd_roles(args, device):
    libs = {}
    for src_name in (f"{k}_stage.cu" for k in args.kernels):
        src = lab._copy(_build.SRC_DIR, f"roles_{src_name.split('.')[0]}")
        lane = (src / "stage_lane.cuh").read_text()
        lane = lab._insert(lane, "namespace juicy {\n", lab.STAMP_HELPERS + (
            "#define JS(k) if (threadIdx.x % 32 == 0) g_lab[(k) * 1024 + "
            "blockIdx.x] = clock64() - g_lab_t0[blockIdx.x];\n"))
        lane = lab._insert(lane, "  part_pass<PART>(s, pre, link, 0, k);\n",
                           f"  if (PART == kOnsets) JS({PRE})\n", before=False)
        (src / "stage_lane.cuh").write_text(lane)
        s = (src / src_name).read_text()
        s = lab._insert(s, "  __syncthreads();\n\n  switch (warp) {",
                        "  if (threadIdx.x == 0) g_lab_t0[blockIdx.x] = "
                        "clock64();\n")
        end = s.index("  switch (warp) {")
        end = s.index("\n  }\n", end) + len("\n  }\n")
        s = s[:end] + "  JS(warp)\n" + s[end:]
        (src / src_name).write_text(s + lab.STAMP_OUT + WAIT_OUT)
        pipe = (src / "pipe.cuh").read_text()
        pipe = lab._insert(pipe, "namespace juicy {\n", WAIT_HELPERS)
        pipe = lab._insert(pipe, "  uint32_t ok;\n  unsigned polls = 0;\n",
                           "  const long long t_wait = clock64();\n",
                           before=False)
        pipe = lab._insert(pipe, "  } while (!ok);\n", WAIT_ADD,
                           before=False)
        (src / "pipe.cuh").write_text(pipe)
        libs[src_name] = lab._load(
            src, ("juicy_chain_stamps", "juicy_stage_waits"),
            sources=(src_name,))[0]
        libs[src_name].juicy_stage_waits_clear.argtypes = []
    for b in BATCHES:
        for case in _picked(CASES, args.kernels):
            src_name = f"{case[0]}_stage.cu"
            names = (*ROLES[src_name], "L: the pre lane")
            lib = libs[src_name]
            lab._use(lib)
            params, x, state = _setup(case, b, device)
            launch = _launcher(case, params, x, state())
            ms = cs.kernel_ms(launch, 20)
            torch.cuda.synchronize()
            if lib.juicy_stage_waits_clear():
                raise SystemExit("wait counter clear failed")
            launch()
            torch.cuda.synchronize()
            st = torch.zeros((32, 1024), dtype=torch.int64, device=device)
            wt = torch.zeros((32, 1024), dtype=torch.int64, device=device)
            if (lib.juicy_chain_stamps(st.data_ptr(), st.numel())
                    or lib.juicy_stage_waits(wt.data_ptr(), wt.numel())):
                raise SystemExit("stamp copy failed")
            ctas = (b + 31) // 32
            rows = [*range(len(names) - 1), PRE]
            st = st[rows, :ctas].double()
            wt = wt[rows, :ctas].double()
            print(f"{_name(case)} B={b}: {ms:.4f} ms per launch; cycles "
                  f"since each CTA's start, mean over {ctas} CTAs (max); "
                  f"cycles waiting on barriers, mean:")
            for k, (name, m, mx) in enumerate(zip(
                    names, st.mean(1).tolist(), st.max(1).values.tolist())):
                w = (f", waiting {float(wt[k].mean()):10.0f}"
                     if k < len(names) - 1 else "")
                print(f"  {name:16s} {m:10.0f} ({mx:.0f}), "
                      f"{m / cs.BLOCK:7.1f} per sample{w}", flush=True)


def cmd_unroll(args, device):
    import re

    factors = [int(u) for u in args.factors.split(",")]
    sources = tuple(f"{k}_stage.cu" for k in args.kernels)
    libs = {}
    for u in factors:
        src = lab._copy(_build.SRC_DIR, f"unroll{u}")
        lane = (src / "stage_lane.cuh").read_text()
        if lane.count("#pragma unroll 1\n") != 2:
            raise SystemExit("stage_lane.cuh: the lane loops' pragmas moved")
        (src / "stage_lane.cuh").write_text(
            lane.replace("#pragma unroll 1\n", f"#pragma unroll {u}\n"))
        libs[u], log = lab._load(src, sources=sources)
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"unroll {u}: registers {regs}, spill stores {spills}")
    for case in _picked(CASES, args.kernels):
        params, x, state = _setup(case, cs.RAGGED_BATCH, device)
        ref = _route(case, "plain", params, x, state())
        for u, lib in libs.items():
            lab._use(lib)
            res = _route(case, "cuda", params, x, state())
            torch.cuda.synchronize()
            print(f"unroll {u} {_name(case)} B={cs.RAGGED_BATCH}: equal to "
                  f"the plain version {_equal(res, ref)}")
    for b in BATCHES:
        for case in _picked(CASES, args.kernels):
            params, x, state = _setup(case, b, device)
            times = {u: [] for u in libs}
            for u in [*libs, *reversed(list(libs))]:
                lab._use(libs[u])
                times[u].append(cs.kernel_ms(_launcher(case, params, x,
                                                       state()), 20))
            print(f"{_name(case)} B={b}: " + ", ".join(
                f"unroll {u} {sum(t) / len(t):.4f} ms"
                for u, t in times.items()), flush=True)


def _kernels(text):
    names = tuple(k for k in text.split(",") if k)
    bad = [k for k in names if k not in KERNELS]
    if bad:
        raise argparse.ArgumentTypeError(f"unknown kernels {bad}; pick from "
                                         f"{','.join(KERNELS)}")
    return names


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    cmds = {"compare": sub.add_parser("compare"), "roles": sub.add_parser("roles"),
            "unroll": sub.add_parser("unroll")}
    cmds["compare"].add_argument("--parent", required=True)
    cmds["unroll"].add_argument("factors")
    for p in cmds.values():
        p.add_argument("--kernels", type=_kernels, default=KERNELS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stage_kernel_lab: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    try:
        {"compare": cmd_compare, "roles": cmd_roles,
         "unroll": cmd_unroll}[args.cmd](
            args, torch.device("cuda", 0))
    finally:
        _build.load_library = lab._LOAD


if __name__ == "__main__":
    main()
