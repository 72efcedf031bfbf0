"""Measurements of the chain kernel (csrc/chain.cu) that need a scratch
build, on one NVIDIA GPU.

    python3 tools/chain_kernel_lab.py loops --src DIR
    python3 tools/chain_kernel_lab.py roles
    python3 tools/chain_kernel_lab.py compare --parent DIR
    python3 tools/chain_kernel_lab.py unroll 1,2,4 [--loops all|light]

Each subcommand copies a ``csrc/`` into the git-ignored ``_archive/lab/``,
patches the copy there and builds it with the package's own nvcc flags;
nothing in the package changes, and no stamp or switch is compiled into it.

- ``loops``: ``clock64()`` stamps after each of the eleven loops of the
  one-thread-per-clip chain kernel of PR 5 (its ``csrc/`` in DIR, e.g. from
  ``git archive b66ecca juicy_tpu_torch/csrc``); each loop's share of a
  thread's cycles, mean over threads.
- ``roles``: stamps in the present kernel at the end of each warp's role
  and of its phases, in cycles since the CTA's start, mean (and max) over
  CTAs.
- ``compare``: the kernel of DIR (a parent's ``csrc/``, the same C
  interface) against the present one, alone per block in turns (parent,
  new, new, parent) at B = 4096 (gel, wood) and 8192 (gel), their outputs
  and metrics held equal, then ``run_corpus_chain`` at B = 8192 × 94 blocks
  in the same turns.
- ``unroll``: the present kernel with its sample loops (``all``, or only
  the ``light`` ones: motion's pass 1, limiter and slew, width, the render,
  the lanes) unrolled by each factor, side by side: registers and spills,
  bit-equality with the plain version on a ragged batch, times in turns.

Each run prints the card's name and power limit first. Inputs are
chip_smoke.py's burst input from a seed. Needs a CUDA device and nvcc;
imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from juicy_tpu_torch.kernels import _build  # noqa: E402
from juicy_tpu_torch.kernels import chain_kernel as ck  # noqa: E402

LAB = ROOT / "_archive" / "lab"
_LOAD = _build.load_library            # the package's own library
CASES = ((0, 4096), (2, 4096), (0, 8192))       # (material, B)


def _insert(src, anchor, text, before=True):
    if src.count(anchor) != 1:
        raise SystemExit(f"anchor not found once in chain.cu: {anchor!r}")
    return src.replace(anchor, text + anchor if before else anchor + text)


def _copy(src_dir, name):
    dst = LAB / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src_dir, dst)
    return dst


ENTRIES = ("juicy_chain_block", "juicy_cuda_error_string",
           "juicy_chain_geometry", "juicy_punch_stage", "juicy_texture_stage",
           "juicy_saturator_stage", "juicy_motion_stage",
           "juicy_punch_geometry", "juicy_texture_geometry",
           "juicy_saturator_geometry", "juicy_motion_geometry")


def _load(src_dir, extra=(), sources=("chain.cu",)):
    """Build `src_dir`'s `sources` (with saturator_stage.cu for the error
    strings) into one library and declare the entry points it has."""
    so = src_dir / "lib.so"
    cmd = [_build.find_nvcc(), *_build.COMPILE_FLAGS, "-shared", "-I",
           str(src_dir), "-o", str(so),
           *(str(src_dir / f)
             for f in dict.fromkeys((*sources, "saturator_stage.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {src_dir}:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    ref = _LOAD()
    for fn in (*ENTRIES, *extra):
        if hasattr(lib, fn) and hasattr(ref, fn):
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
            getattr(lib, fn).restype = getattr(ref, fn).restype
    for fn in extra:
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib, proc.stdout + proc.stderr


def _use(lib):
    """Make KernelChain.launch call `lib`."""
    _build.load_library = lambda: lib


def _launcher(mode, b, device, seed=31):
    chain = _chain(mode)
    st0 = chain.init_state((b,), device)
    x = cs.make_clicks(b, cs.CHANNELS, cs.BLOCK, device, seed=seed)
    kc = ck.KernelChain(chain, st0, b, device)
    xt = x.permute(2, 1, 0).contiguous()
    out = torch.empty_like(xt)
    fin, acc, fit = (v[0] for v in ck._lane_buffers(1, b, device))
    prev = ck.lane_seed([s["analyzer"] for s in st0], b, device)
    return chain, st0, x, lambda: kc.launch(xt, out, prev, fin, acc, fit)


def _chain(mode=None):
    """bench.py's chain, with texture `mode` when given."""
    from juicy_tpu_torch.runtime.plugin import Chain

    stages = cs.CHAIN if mode is None else cs.chain_stages(mode)
    return Chain(stages, cs.SR, cs.CHANNELS, cs.BLOCK)


STAMP_HELPERS = """
__device__ long long g_lab[32 * 16384];
__device__ long long g_lab_t0[1024];
"""
STAMP_OUT = """
extern "C" int juicy_chain_stamps(long long* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, g_lab, n * sizeof(long long), 0, cudaMemcpyDeviceToDevice));
}
"""

LOOP_NAMES = ("P", "S", "T", "M1", "M2 ch0", "M2 ch1", "W", "C1", "C2",
              "I", "I2")


def cmd_loops(args, device):
    src = _copy(Path(args.src), "loops")
    s = (src / "chain.cu").read_text()
    s = _insert(s, "namespace juicy {\n", STAMP_HELPERS + (
        "#define JSTAMP(k) g_lab[(k) * 16384 + b] = clock64();\n"))
    for anchor, k, before in (
            ("  const int B = a.B, N = a.N;\n", 0, True),
            ("  store(pre, 0);\n", 1, True),
            ("  store(post, 1);\n", 2, True),
            ("  store(post, 3);\n", 3, True),
            ("    float scale, recovery;\n", 4, True),
            ("      a.mot_chan[(2 * sB + b) * 2 + ch] = c.prev;\n", "5 + ch",
             False),
            ("  store(post, 7);\n", 7, True),
            ("    const float inv_n = __ldg(row + kOffInvN);\n", 8, True),
            ("    a.co_tail[b * 2] = tail[0];\n", 9, True),
            ("  store(post, 11);\n", 10, True),
            ("  store(post, 13);\n", 11, True)):
        s = _insert(s, anchor, f"  JSTAMP({k})\n", before)
    (src / "chain.cu").write_text(s + STAMP_OUT)
    lib, _log = _load(src, ("juicy_chain_stamps",))
    _use(lib)
    for mode, b in CASES:
        _chain_, _st, _x, launch = _launcher(mode, b, device)
        ms = cs.cuda_ms(launch, 20)
        launch()
        torch.cuda.synchronize()
        st = torch.empty((12, 16384), dtype=torch.int64, device=device)
        if lib.juicy_chain_stamps(st.data_ptr(), st.numel()):
            raise SystemExit("stamp copy failed")
        st = st[:, :b].double()
        d = st[1:] - st[:-1]
        tot = st[11] - st[0]
        print(f"{cs.MATERIALS[mode]} B={b}: {ms:.4f} ms per launch; thread "
              f"cycles mean {float(tot.mean()):.0f} "
              f"({float(tot.mean()) / cs.BLOCK:.0f} per sample)")
        for name, m in zip(LOOP_NAMES, d.mean(1).tolist()):
            print(f"  {name:7s} {m:10.0f} cycles ({m / float(tot.mean()):6.1%})"
                  f", {m / cs.BLOCK:7.1f} per sample")


ROLE_POINTS = (
    # (name, anchor, before?) in the present chain.cu; the warp ends follow
    ("M: pass 1 and the scales",
     "  motion_scales(p1.repetition, k, scale, recovery);\n", False),
    ("M: pass 2 on channel 0",
     "      a.mot_chan[(2 * c.sB + c.b) * 2] = mc.prev;\n    }\n  }\n", False),
    ("M: channel 1's limiter",
     "      mbar_arrive(c.bar(kBarM, j));\n    }\n  }\n", False),
    ("M: the gains arrived",
     "  const float g[3] = {c.gains[0], c.gains[32], c.gains[64]};\n", True),
    ("W: width and cohere's analysis",
     "  const float inv_n = c.row[kOffInvN];\n", True),
    ("T1: texture",
     "      run_texture<MODE>(a, c, 1, rng0);\n", False),
    ("T1: the slew of channel 0's steps",
     "  Reader<1> in = reader<1>(a.s0 + c.nb, c, 1, nullptr);"
     "  // T1's own output\n", True),
)
WARP_NAMES = ("P0", "P1", "S0", "S1", "T0", "T1 (+ motion ch1 wet)",
              "M (+ render ch1)", "W (+ render ch0)", "A0 (analyzers 0, 3)",
              "A1 (1, 4)", "A2 (2, 5)", "A3 (6)")


def cmd_roles(args, device):
    src = _copy(_build.SRC_DIR, "roles")
    s = (src / "chain.cu").read_text()
    s = _insert(s, "namespace juicy {\n", STAMP_HELPERS + (
        "#define JS(k) if (threadIdx.x % 32 == 0) g_lab[(k) * 1024 + "
        "blockIdx.x] = clock64() - g_lab_t0[blockIdx.x];\n"))
    s = _insert(s, "  __syncthreads();\n\n  switch (warp) {",
                "  if (threadIdx.x == 0) g_lab_t0[blockIdx.x] = clock64();\n")
    s = _insert(s, "    default: run_analyzer(a, c, 6); break;\n  }\n",
                "  JS(warp)\n", before=False)
    names = list(WARP_NAMES)
    for name, anchor, before in ROLE_POINTS:
        s = _insert(s, anchor, f"  JS({len(names)})\n", before)
        names.append(name)
    for an in (0, 1, 2):
        s = _insert(s, f"run_analyzer(a, c, {an}); ", f"JS({len(names)}) ",
                    before=False)
        names.append(f"A{an}: analyzer {an}")
    (src / "chain.cu").write_text(s + STAMP_OUT)
    lib, _log = _load(src, ("juicy_chain_stamps",))
    _use(lib)
    for mode, b in CASES:
        _chain_, _st, _x, launch = _launcher(mode, b, device)
        ms = cs.cuda_ms(launch, 20)
        launch()
        torch.cuda.synchronize()
        st = torch.zeros((32, 1024), dtype=torch.int64, device=device)
        if lib.juicy_chain_stamps(st.data_ptr(), st.numel()):
            raise SystemExit("stamp copy failed")
        ctas = (b + 31) // 32
        st = st[:len(names), :ctas].double()
        print(f"{cs.MATERIALS[mode]} B={b}: {ms:.4f} ms per launch; cycles "
              f"since each CTA's start, mean over {ctas} CTAs (max):")
        for name, m, mx in zip(names, st.mean(1).tolist(),
                               st.max(1).values.tolist()):
            print(f"  {name:34s} {m:10.0f} ({mx:.0f}), "
                  f"{m / cs.BLOCK:7.1f} per sample")


def cmd_compare(args, device):
    from juicy_tpu_torch.parallel.corpus import run_corpus_chain

    libs = {"parent": _load(_copy(Path(args.parent), "parent"))[0],
            "new": _load(_copy(_build.SRC_DIR, "new"))[0]}
    order = ("parent", "new", "new", "parent")
    for mode, b in CASES:
        chain = _chain(mode)
        st0 = chain.init_state((b,), device)
        blk = cs.make_clicks(b, cs.CHANNELS, cs.BLOCK, device, seed=31)
        outs = {}
        for name, lib in libs.items():
            _use(lib)
            outs[name] = ck.chain_kernel_step(chain, st0, blk)
        torch.cuda.synchronize()
        same = torch.equal(outs["parent"][0], outs["new"][0]) and all(
            torch.equal(p[k], n[k]) for p, n in zip(outs["parent"][2],
                                                    outs["new"][2])
            for k in p)
        times = []
        for name in order:
            _use(libs[name])
            times.append(cs.chain_kernel_ms(chain, st0, blk)[0])
        parent = (times[0] + times[3]) / 2
        new = (times[1] + times[2]) / 2
        print(f"{cs.MATERIALS[mode]} B={b}: " + ", ".join(
            f"{n} {t:.4f}" for n, t in zip(order, times))
            + f" ms alone; parent {parent:.4f}, new {new:.4f}, speed-up "
            f"{parent / new:.2f}x; outputs and metrics equal: {same}")
    b, n = cs.CHAIN_CORPUS_BATCH, cs.BLOCK
    chain = _chain()
    clips = cs.make_clicks(b, cs.CHANNELS, cs.NUM_BLOCKS * n, device, seed=31)
    first = {}
    for name in order:
        _use(libs[name])
        run_corpus_chain(chain, clips)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ms, _agg = run_corpus_chain(chain, clips)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"run_corpus_chain {name} B={b} x {cs.NUM_BLOCKS} blocks: "
              f"{wall:.4f} s, {b * clips.shape[-1] / cs.SR / wall:.1f} "
              f"audio-s/s")
        first.setdefault(name, out)
        del out
    print("corpus outputs parent == new:",
          torch.equal(first["parent"], first["new"]))


LIGHT = ("motion_p1(", "motion_p2_limit(", "motion_slew(", "cohere_render(",
         "width_shrink(", "lane_step(")


def cmd_unroll(args, device):
    factors = [int(u) for u in args.factors.split(",")]
    libs = {}
    for u in factors:
        src = _copy(_build.SRC_DIR, f"unroll{u}")
        lines = (src / "chain.cu").read_text().split("\n")
        for i, line in enumerate(lines):
            if line != "#pragma unroll 1":
                continue
            body = "\n".join(lines[i + 1:i + 5])
            if args.loops == "all" or any(k in body for k in LIGHT):
                lines[i] = f"#pragma unroll {u}"
        (src / "chain.cu").write_text("\n".join(lines))
        libs[u], log = _load(src)
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"unroll {u} ({args.loops}): registers {regs}, spill stores "
              f"{spills}")
    for mode in (0, 2):
        chain = _chain(mode)
        x = cs.make_clicks(100, cs.CHANNELS, 2 * cs.BLOCK, device, seed=39,
                           period=2 * cs.BLOCK)
        st0 = chain.init_state((100,), device)
        ref = ck._run_plain(chain, st0, x, True)
        for u, lib in libs.items():
            _use(lib)
            res = ck._run_cuda(chain, st0, x, True)
            torch.cuda.synchronize()
            ok = all(torch.equal(r, p) for r, p in zip(
                (res[0], res[2], res[3]), (ref[0], ref[2], ref[3]))) and all(
                torch.equal(a[k], v) for a, p in zip(res[1], ref[1])
                for k, v in p.items())
            print(f"unroll {u} {cs.MATERIALS[mode]} B=100: bit-equal {ok}")
    for mode, b in CASES:
        chain = _chain(mode)
        st0 = chain.init_state((b,), device)
        blk = cs.make_clicks(b, cs.CHANNELS, cs.BLOCK, device, seed=31)
        times = {u: [] for u in libs}
        for u in [*libs, *reversed(list(libs))]:
            _use(libs[u])
            times[u].append(cs.chain_kernel_ms(chain, st0, blk)[0])
        print(f"{cs.MATERIALS[mode]} B={b}: " + ", ".join(
            f"unroll {u} {sum(t) / len(t):.4f} ms" for u, t in times.items()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("loops").add_argument("--src", required=True)
    sub.add_parser("roles")
    sub.add_parser("compare").add_argument("--parent", required=True)
    un = sub.add_parser("unroll")
    un.add_argument("factors")
    un.add_argument("--loops", choices=("all", "light"), default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chain_kernel_lab: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    try:
        {"loops": cmd_loops, "roles": cmd_roles, "compare": cmd_compare,
         "unroll": cmd_unroll}[args.cmd](args, torch.device("cuda", 0))
    finally:
        _build.load_library = _LOAD


if __name__ == "__main__":
    main()
