"""Measurements of the stage kernels (csrc/punch_stage.cu,
csrc/saturator_stage.cu, csrc/texture_stage.cu, csrc/motion_stage.cu) and
of the analyzer kernel (csrc/analyzer.cu) that need a scratch build, on one
NVIDIA GPU.

    python3 tools/stage_kernel_lab.py compare --parent DIR [--kernels K,...]
    python3 tools/stage_kernel_lab.py roles [--kernels K,...] [--src DIR,...]
    python3 tools/stage_kernel_lab.py unroll 1,2 [--kernels K,...]

``--kernels`` picks among punch, saturator, motion, texture (every
material) and analyzer; all five by default (``unroll`` takes the stage
kernels only). Each subcommand copies a ``csrc/`` into the
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

For the analyzer: ``compare`` runs the parent's analyzer kernel (the one-
thread-per-clip kernel, which reads the block time-major, [N, C, B])
against the present one (the block as given, [B, C, N]) at B = 4096 and
8192 stereo and 4096 mono (N = 512, the burst input): fin and acc held
equal, then each alone and with its layout (the parent's permute) in turns;
and it builds the parent's whole library to list the other kernels whose
SASS differs from the parent's (``cuobjdump -sass``). ``roles`` takes
each ``csrc/`` of ``--src`` (the present one by default; a parent's, or a
scratch copy with an edit to try): its analyzer kernel where it has warp
roles, and the stage kernels' lane alone (stage_lane.cuh's two passes over
pipe.cuh's ChunkReader, a scratch kernel built against that ``csrc/``).
It times each alone in turns with the others at the same shapes, and
stamps each warp of a second build: its cycles per sample, the part of
them spent waiting (mbarriers; cp.async groups) and the rest, the loop
body. It writes each build's SASS to
``_archive/lab/analyzer_sass_<build>.txt``.

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

KERNELS = ("punch", "saturator", "motion", "texture", "analyzer")
STAGES = KERNELS[:4]
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

    all_equal = True
    if "analyzer" in args.kernels:
        all_equal = compare_analyzer(Path(args.parent), device)
    stages = [k for k in args.kernels if k in STAGES]
    if not stages:
        print(f"every output equal, parent against new: {all_equal}")
        if not all_equal:
            raise SystemExit("the new kernels differ from the parent's")
        return
    sources = tuple(f"{k}_stage.cu" for k in stages)
    libs = {"parent": lab._load(lab._copy(Path(args.parent), "parent"),
                                sources=sources)[0],
            "new": lab._load(lab._copy(_build.SRC_DIR, "new"),
                             sources=sources)[0]}
    order = ("parent", "new", "new", "parent")
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
    if "analyzer" in args.kernels:
        roles_analyzer(device, args.src)
    libs = {}
    for src_name in (f"{k}_stage.cu" for k in args.kernels if k in STAGES):
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
    sources = tuple(f"{k}_stage.cu" for k in args.kernels if k in STAGES)
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


# ---------------------------------------------------------------------------
# The analyzer kernel (csrc/analyzer.cu)
# ---------------------------------------------------------------------------

AN_BATCHES = ((4096, 2), (8192, 2), (4096, 1))  # (B, channels) of compare
AN_ROLES = {"V": 1, "L": 0, "E": 2, "P": 3}  # name: warp
LANE_ROLES = {"V": 0, "L": 1, "E": 2}  # the stage lane's warps
OUT = lab.LAB

#: the stage kernels' lane alone: stage_lane.cuh's run (both passes, the
#: second over the input again) on pipe.cuh's ChunkReader of [N, C, B]
LANE_CU = r"""
#include <cuda_runtime.h>

#include "lane.cuh"
#include "pipe.cuh"
#include "stage_lane.cuh"

namespace juicy {
namespace lab_lane {

enum : int { kWarpV, kWarpL, kWarpE, kWarps };

struct Args {
  const float* __restrict__ x;
  const float* __restrict__ lane_in;
  float* __restrict__ fin[2];
  float* __restrict__ acc[2];
  int B, N;
  LaneConsts k;
};

template <int C, int PART>
__device__ void part(const Args& a, float* stage, const stage_lane::Link& link,
                     int b, int bl, bool live) {
  const size_t sB = static_cast<size_t>(a.B);
  stage_lane::run<PART>(
      pipe::chunk_reader<2>(a.x, C, sB, bl, 0, a.N, nullptr, stage),
      pipe::chunk_reader<2>(a.x, C, sB, bl, 0, a.N, nullptr, stage), link,
      a.lane_in, a.fin[0], a.acc[0], a.fin[1], a.acc[1], b, bl, live, a.B,
      a.k);
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
    lane_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = (a.N + pipe::kChunk - 1) / pipe::kChunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * 32 + lane;
  const bool live = b < a.B;
  const int bl = live ? b : a.B - 1;
  const int nb = stage_lane::link_bars(nc);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + (8 * nb + 15) / 16 * 16);
  float* stage = ring + stage_lane::kRingRows * 32 +
                 (warp == kWarpE ? stage_lane::kStageRows * 32 : 0) + lane;
  const stage_lane::Link link{ring + lane, bars};
  for (int i = threadIdx.x; i < nb; i += kWarps * 32) pipe::mbar_init(bars + i, 32);
  __syncthreads();

  switch (warp) {
    case kWarpV: part<C, stage_lane::kEnvelopes>(a, stage, link, b, bl, live); break;
    case kWarpL: part<C, stage_lane::kOnsets>(a, stage, link, b, bl, live); break;
    default: part<C, stage_lane::kEnergy>(a, stage, link, b, bl, live); break;
  }
}

}  // namespace lab_lane
}  // namespace juicy

extern "C" int juicy_lab_lane(const float* x, const float* lane_in,
                              float* fin0, float* acc0, float* fin1,
                              float* acc1, int B, int C, int N, float atk_s,
                              float rel_s, float atk_l, float rel_l,
                              float low_c, float high_c, float cd,
                              void* stream) {
  namespace ll = juicy::lab_lane;
  const int nc = (N + juicy::pipe::kChunk - 1) / juicy::pipe::kChunk;
  const size_t smem = (8 * juicy::stage_lane::link_bars(nc) + 15) / 16 * 16 +
                      sizeof(float) * 32 *
                          (juicy::stage_lane::kRingRows +
                           2 * juicy::stage_lane::kStageRows);
  const ll::Args a{x, lane_in, {fin0, fin1}, {acc0, acc1}, B, N,
                   {atk_s, rel_s, atk_l, rel_l, low_c, high_c, cd}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (B + 31) / 32;
  if (C == 1) {
    cudaFuncSetAttribute(ll::lane_kernel<1>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ll::lane_kernel<1><<<blocks, ll::kWarps * 32, smem, s>>>(a);
  } else {
    cudaFuncSetAttribute(ll::lane_kernel<2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ll::lane_kernel<2><<<blocks, ll::kWarps * 32, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

#: the cycles each warp spends in pipe.cuh's waits: mbarriers (mbar_wait,
#: mbar_wait_phase) into g_wait, cp.async groups (cp_wait) into g_cpwait
AN_WAIT_HELPERS = ("__device__ long long g_wait[32 * 1024];\n"
                   "__device__ long long g_cpwait[32 * 1024];\n")
AN_WAIT_OUT = """
extern "C" int juicy_lab_waits(long long* dst, int n) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, g_wait, n * sizeof(long long),
                                         0, cudaMemcpyDeviceToDevice);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(dst + n, g_cpwait, n * sizeof(long long), 0,
                               cudaMemcpyDeviceToDevice);
  return static_cast<int>(err);
}
extern "C" int juicy_lab_waits_clear() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, g_wait);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_wait));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, g_cpwait);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_cpwait));
  return static_cast<int>(err);
}
"""


def _wait_stamps(pipe):
    """pipe.cuh with each wait's cycles added to its warp's counter."""
    add = ("  if (threadIdx.x % 32 == 0) {0}[(threadIdx.x / 32) * 1024 + "
           "blockIdx.x] += clock64() - t_wait;\n")
    pipe = lab._insert(pipe, "namespace juicy {\n", AN_WAIT_HELPERS)
    for start, end in (("  uint32_t ok;\n  unsigned polls = 0;\n",
                        "  } while (!ok);\n"),
                       ("  uint32_t landed;\n  unsigned tries = 0;\n",
                        "  } while (!landed);\n")):
        if start not in pipe:   # mbar_wait_phase, a parent may not have it
            continue
        pipe = lab._insert(pipe, start, "  const long long t_wait = clock64();\n",
                           before=False)
        pipe = lab._insert(pipe, end, add.replace("{0}", "g_wait"),
                           before=False)
    cp = '  asm volatile("cp.async.wait_group %0;" ::"n"(K) : "memory");\n'
    return _sub(pipe, cp, "  const long long t_wait = clock64();\n" + cp
                + add.replace("{0}", "g_cpwait"))


def _stamped(src, name):
    """Kernel source `name` with a CTA start stamp and each warp's end."""
    s = (src / name).read_text()
    s = lab._insert(s, "namespace juicy {\n", lab.STAMP_HELPERS + (
        "#define JS(k) if (threadIdx.x % 32 == 0) g_lab[(k) * 1024 + "
        "blockIdx.x] = clock64() - g_lab_t0[blockIdx.x];\n"))
    s = lab._insert(s, "  __syncthreads();\n\n  switch (warp) {",
                    "  if (threadIdx.x == 0) g_lab_t0[blockIdx.x] = clock64();\n")
    end = s.index("  switch (warp) {")
    end = s.index("\n  }\n", end) + len("\n  }\n")
    return s[:end] + "  JS(warp)\n" + s[end:] + lab.STAMP_OUT + AN_WAIT_OUT


def _sub(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"anchor not found once: {old!r}")
    return text.replace(old, new)


def _nvcc_lib(src_dir, source):
    """Start nvcc on `source` of `src_dir` into lib.so; (Popen, path)."""
    so = src_dir / "lib.so"
    cmd = [_build.find_nvcc(), *_build.COMPILE_FLAGS, "-shared", "-I",
           str(src_dir), "-o", str(so), str(src_dir / source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), so


def _open(proc, so, entries):
    """Wait for an nvcc from _nvcc_lib; load its library, declare entries."""
    import ctypes

    out, err = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {so.parent}:\n{err[-4000:]}")
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sig = {"juicy_analyzer_block": [ptr] * 4 + [i32] * 3 + [f32] * 7 + [ptr],
           "juicy_lab_lane": [ptr] * 6 + [i32] * 3 + [f32] * 7 + [ptr],
           "juicy_chain_stamps": [ptr, i32], "juicy_lab_waits": [ptr, i32],
           "juicy_lab_waits_clear": []}
    for fn in entries:
        getattr(lib, fn).argtypes = sig[fn]
        getattr(lib, fn).restype = i32
    return lib, out + err


def _an_inputs(b, c, device, seed=43):
    """The burst input [B, C, N] and a fresh analyzer state's lane [5, B]."""
    from juicy_tpu_torch.analyzer import analyzer_init

    x = cs.make_clicks(b, c, cs.BLOCK, device, seed=seed)
    return x, sk.pack_lane(analyzer_init((b,), device), b)


def _an_call(lib, entry, x, dims, lane0, outs):
    """One launch of `entry` (the analyzer's C interface, or the stage
    lane's with two lanes out) on `x`, of shape `dims` = (B, C, N)."""
    err = getattr(lib, entry)(
        x.data_ptr(), lane0.data_ptr(), *(o.data_ptr() for o in outs),
        *dims, *sk._lane_consts(cs.SR),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"{entry} launch failed: CUDA error {err}")


def _outs(b, n_lanes, device):
    return [torch.empty(((5, 10)[i % 2], b), device=device)
            for i in range(2 * n_lanes)]


def _sass(so):
    """{kernel name: its SASS} of a library (cuobjdump -sass)."""
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


def compare_analyzer(parent, device):
    """The parent's analyzer kernel (in `parent`, reading [N, C, B]) against
    the present one; every
    other kernel's SASS against the parent's. Returns: all equal."""
    par_dir = lab._copy(parent, "an_parent")
    new_dir = lab._copy(_build.SRC_DIR, "an_new")
    jobs = {k: _nvcc_lib(d, "analyzer.cu")
            for k, d in (("parent", par_dir), ("new", new_dir))}
    saved = (_build.SRC_DIR, _build.BUILD_DIR)
    _build.SRC_DIR, _build.BUILD_DIR = par_dir, lab.LAB / "an_parent_build"
    try:
        par_so = _build.build()
    finally:
        _build.SRC_DIR, _build.BUILD_DIR = saved
    new_so = _build.build()
    libs = {k: _open(*job, ("juicy_analyzer_block",))[0]
            for k, job in jobs.items()}
    par_sass, new_sass = _sass(par_so), _sass(new_so)
    others = sorted(k for k in par_sass if "analyzer" not in k)
    differ = [k for k in others if new_sass.get(k) != par_sass[k]]
    print(f"SASS of the other kernels: {len(others) - len(differ)} of "
          f"{len(others)} functions the same as the parent's; differ: "
          f"{differ}", flush=True)
    all_equal = True
    order = ("parent", "new", "new", "parent")
    for b, c in AN_BATCHES:
        x, lane0 = _an_inputs(b, c, device)
        dims = (b, c, cs.BLOCK)
        xt = x.permute(2, 1, 0).contiguous()
        res = {}
        for name, lib in libs.items():
            res[name] = _outs(b, 1, device)
            _an_call(lib, "juicy_analyzer_block",
                     xt if name == "parent" else x, dims, lane0, res[name])
        torch.cuda.synchronize()
        equal = all(torch.equal(p, q) for p, q in zip(res["parent"],
                                                      res["new"]))
        all_equal = all_equal and equal
        outs = res["new"]

        def launch(name, layout):
            lib = libs[name]
            if name == "new":
                return lambda: _an_call(lib, "juicy_analyzer_block", x, dims,
                                        lane0, outs)
            if layout:
                return lambda: _an_call(
                    lib, "juicy_analyzer_block",
                    x.permute(2, 1, 0).contiguous(), dims, lane0, outs)
            return lambda: _an_call(lib, "juicy_analyzer_block", xt, dims,
                                    lane0, outs)

        for layout in (False, True):
            times = [cs.kernel_ms(launch(name, layout), 20) for name in order]
            parent_ms = (times[0] + times[3]) / 2
            new_ms = (times[1] + times[2]) / 2
            bound_ms, bound_by = cs.analyzer_bound(b, c, cs.BLOCK)
            print(f"analyzer B={b} C={c} "
                  f"{'with layout' if layout else 'alone'}: "
                  + ", ".join(f"{n} {t:.4f}" for n, t in zip(order, times))
                  + f" ms; parent {parent_ms:.4f}, new {new_ms:.4f}, "
                  f"speed-up {parent_ms / new_ms:.2f}x; bound "
                  f"{bound_ms:.4f} ms ({bound_by}), new at "
                  f"{bound_ms / new_ms:.1%} of it; fin and acc equal: "
                  f"{equal}", flush=True)
    return all_equal


def _builds(srcs):
    """{name: (csrc/ dir, is the stage lane)} of ``roles``: each directory's
    analyzer kernel where it runs on warp roles, and its stage lane."""
    builds = {}
    for d in srcs:
        d = Path(d).resolve()
        name = ("present" if d == Path(_build.SRC_DIR).resolve()
                else str(d.relative_to(lab.ROOT)
                         if d.is_relative_to(lab.ROOT) else d))
        if "switch (warp)" in (d / "analyzer.cu").read_text():
            builds[name] = (d, False)
        else:
            print(f"{name}: its analyzer kernel has no warp roles; its "
                  f"stage lane only", flush=True)
        builds[f"{name}, stage lane"] = (d, True)
    return builds


def roles_analyzer(device, srcs):
    """For each build of _builds(srcs): its time alone in turns with the
    others (an unstamped build), its SASS, and per role the cycles per
    sample, waits and body (a stamped build)."""
    from juicy_tpu_torch.kernels import analyzer_kernel as ak

    OUT.mkdir(exist_ok=True)
    stamp_entries = ("juicy_chain_stamps", "juicy_lab_waits",
                     "juicy_lab_waits_clear")
    builds = _builds(srcs)
    jobs = {}
    for i, (name, (d, is_lane)) in enumerate(builds.items()):
        source = "lab_lane.cu" if is_lane else "analyzer.cu"
        for stamped in (False, True):
            src = lab._copy(d, f"an_roles{i}{'s' * stamped}")
            if is_lane:
                (src / "lab_lane.cu").write_text(LANE_CU)
            if stamped:
                (src / source).write_text(_stamped(src, source))
                (src / "pipe.cuh").write_text(
                    _wait_stamps((src / "pipe.cuh").read_text()))
            jobs[name, stamped] = (is_lane, _nvcc_lib(src, source))
    libs = {}
    for (name, stamped), (is_lane, job) in jobs.items():
        entry = "juicy_lab_lane" if is_lane else "juicy_analyzer_block"
        libs[name, stamped] = (is_lane, _open(
            *job, (entry, *(stamp_entries if stamped else ())))[0])
        if stamped:
            continue
        sass = _sass(job[1])
        tag = "".join(ch if ch.isalnum() else "_" for ch in name)
        (OUT / f"analyzer_sass_{tag}.txt").write_text(
            "\n\n".join(f"Function : {k}\n{v}" for k, v in sass.items()))
        ops = {}
        for k, v in sass.items():
            for line in v.splitlines():
                parts = line.split("*/")
                words = parts[1].split() if len(parts) > 1 else []
                if words and words[0].startswith("@"):
                    words = words[1:]
                if words:
                    op = words[0].split(".")[0].rstrip(";")
                    ops[op] = ops.get(op, 0) + 1
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
        print(f"{name}: {sum(ops.values())} SASS instructions, "
              f"{dict(top)}", flush=True)
    names = list(builds)
    n = cs.BLOCK
    for b, c in AN_BATCHES:
        x, lane0 = _an_inputs(b, c, device)
        xt = x.permute(2, 1, 0).contiguous()
        plain = ak._analyzer_lanes_plain(x, lane0, sk._lane_consts(cs.SR))
        calls = {}
        for name in names:
            is_lane = builds[name][1]
            entry = "juicy_lab_lane" if is_lane else "juicy_analyzer_block"
            xin = xt if is_lane else x
            for stamped in (False, True):
                lib = libs[name, stamped][1]
                outs = _outs(b, 2 if is_lane else 1, device)
                calls[name, stamped] = (lib, outs, (
                    lambda lib=lib, entry=entry, xin=xin, outs=outs: _an_call(
                        lib, entry, xin, (b, c, n), lane0, outs)))
        times = {name: [] for name in names}
        for name in [*names, *reversed(names)]:
            times[name].append(cs.kernel_ms(calls[name, False][2], 20))
        print(f"B={b}, C={c}: each build alone in turns (forward, then "
              f"back), ms per launch:")
        for name in names:
            lib, outs, launch = calls[name, False]
            launch()
            torch.cuda.synchronize()
            same = all(torch.equal(p, q) for p, q in zip(outs[:2], plain))
            print(f"  {name:56s} {times[name][0]:.4f} {times[name][1]:.4f} "
                  f"mean {sum(times[name]) / 2:.4f}; fin and acc equal to "
                  f"the plain version: {same}", flush=True)
        for name in names:
            is_lane = builds[name][1]
            lib, outs, launch = calls[name, True]
            if lib.juicy_lab_waits_clear():
                raise SystemExit("wait counter clear failed")
            launch()
            torch.cuda.synchronize()
            st = torch.zeros((32, 1024), dtype=torch.int64, device=device)
            wt = torch.zeros((64, 1024), dtype=torch.int64, device=device)
            if (lib.juicy_chain_stamps(st.data_ptr(), st.numel())
                    or lib.juicy_lab_waits(wt.data_ptr(), 32 * 1024)):
                raise SystemExit("stamp copy failed")
            ctas = (b + 31) // 32
            roles = LANE_ROLES if is_lane else AN_ROLES
            samples = 2 * n if is_lane else n
            print(f"{name} B={b} C={c}, stamped: per role, mean over {ctas} CTAs, "
                  f"cycles per sample ({samples} samples): total, mbarrier "
                  f"waits, cp.async waits, body")
            for role, w in roles.items():
                tot = float(st[w, :ctas].double().mean()) / samples
                mw = float(wt[w, :ctas].double().mean()) / samples
                cw = float(wt[32 + w, :ctas].double().mean()) / samples
                print(f"  {role:3s} {tot:8.1f} {mw:8.1f} {cw:8.1f} "
                      f"{tot - mw - cw:8.1f}", flush=True)


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
    cmds["roles"].add_argument(
        "--src", type=lambda t: [d for d in t.split(",") if d],
        default=[str(_build.SRC_DIR)],
        help="csrc/ directories for the analyzer target (default: the "
             "present one)")
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
