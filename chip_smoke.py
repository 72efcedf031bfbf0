"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at full width: full-chain corpus scoring
(``juicy_tpu_torch.parallel.corpus.run_corpus_chain``, the main path: 8192
clips of 94 blocks of 512 stereo samples at 48 kHz through the seven-stage
chain kernel), punch, saturator, texture and motion corpus scoring
(``run_corpus``, 4096 clips of the same length), the seven-stage ``Chain``
and chain executor, serving (``StreamServer``, 4096 live streams on the
chain kernel), ``analyze_fused`` and ``saturator_step_fused``, the host
entry points, the relaxed tier (``relaxed_chain_stream``) and the mesh
entry points; inputs made on the card from a seed. Phases, each of which
raises on failure:

1.  the card's name and power limit (nvidia-smi), torch and CUDA versions;
2.  build the CUDA kernels from ``juicy_tpu_torch/csrc`` (one nvcc per
    source, all started together);
3.  the saturator stage kernel against its plain PyTorch version on the
    card, two consecutive blocks at B = 4096 and at a ragged B = 100 (its
    last CTA partly past B), N = 512, preset "Amber Heat": audio, the tone
    state and both lanes (onset counts and cooldowns included) bit-equal,
    scores within 1e-4, other metrics within 1e-5; the kernel's geometry
    (clips and warps per CTA, registers, shared memory, resident CTAs per
    SM; no spills); its time per block alone, with the layout permutes,
    the whole step's and the plain version's; and its time alone at
    B = 4096 and 8192;
3b. the texture stage kernel against its plain version, the same way, for
    each material 0..4 (gel, metal, wood, plastic, flesh) at the defaults,
    at B = 4096 and at a ragged B = 100 (its last CTA partly past B), with
    the audio and every state leaf (the LCG state and the waveguide ring
    included) bit-equal; the kernel's geometry (clips and warps per CTA,
    registers, shared memory, resident CTAs per SM; no spills); its time
    per block alone and with the layout permutes, the whole step's and the
    plain version's; and its time alone at B = 4096 and 8192;
3c. the punch stage kernel against its plain version, two blocks at
    B = 4096 and at B = 100, N = 512, preset "Solar Snap", on an input with
    a burst every 100 ms at a per-clip offset (onsets inside the blocks):
    audio, every state leaf and both lanes bit-equal; its geometry and the
    same times as 3b;
3d. the motion stage kernel the same way at its defaults, with ``rng`` and
    ``onset_cooldown`` among the state leaves and pass 1's LCG rolled in
    most clips;
3e. the chain kernel against its plain version, two blocks at B = 4096,
    N = 512 on the burst input, for bench.py's chain (texture gel) and the
    same chain with wood (the ring): audio <= -120 dBFS, every state leaf
    bit-equal (the LCG states, cooldowns, the texture ring and the Haas
    window included), the lanes' onset counts and cooldowns equal, every
    stage's metrics within 1e-5 of max(1, |value|); the same four times as
    3b; the same bars at a ragged B = 100 (its last CTA partly past B); and
    the kernel's geometry (clips and warps per CTA, registers, shared
    memory, resident CTAs per SM; no spills);
3f. ``analyze_fused`` (csrc/analyzer.cu), two blocks of N = 512 on the
    burst input at B = 4096 and 8192 and a ragged B = 100, mono and
    stereo, one launch per block and no other kernel; against its plain
    version: the lanes (fin, acc) bit-equal, cooldowns equal, metrics
    within 1e-5; the kernel's geometry (no spills); its time per block
    alone and through the wrapper (the block in its own layout) at B =
    4096 and 8192, mono and stereo, with its bound; the whole step's and
    the plain version's at B = 4096;
3g. ``saturator_step_fused`` the same way (one launch of
    csrc/saturator_stage.cu per block under its own count), bit for bit
    against its plain version and against ``saturator_stage_step``;
4.  ``run_corpus`` saturator at full width: exactly one kernel launch per
    block, finite output, scores in [0, 100]; the warm wall time and rate;
    the timed run's first 256 clips against ``use_kernel="never"`` (plain
    ``batched_run`` on the card) at <= -100 dBFS with last-block scores
    within 1e-3;
4b. ``run_corpus`` texture at full width for gel, metal and wood, checked
    the same way: wood (the ring) at full depth, gel and metal against
    ``use_kernel="never"`` on the first 256 clips × 8 blocks (the kernel
    route run there too, and equal to the timed run's first blocks bit for
    bit), as 4e does: at full depth they would take the script past
    ~1,100 s of its 1,200;
4c. ``run_corpus`` punch ("Solar Snap") and motion (defaults, its LCG) at
    full width on the burst input, checked as 4: punch at full depth,
    motion (its never-path ~164-235 s at full depth) over the first 256
    clips x 8 blocks, so that phases 7 and 8 fit the time limit;
4d. the seven-stage ``Chain`` of bench.py (``Chain.batched_run``) on the
    card at B = 256, two blocks, against the same call on the CPU: audio
    <= -100 dBFS, every stage's metrics within 1e-5 of max(1, |value|); and
    the block-major executor (``fused_chain_stream``) on the card against
    ``Chain.batched_run`` there, bit for bit;
4e. ``run_corpus_chain`` on bench.py's chain at full width (B = 8192, 94
    blocks of 512, ``metrics="final"``): exactly one chain-kernel launch per
    block and no other kernel launch, finite output, scores in [0, 100]; the
    warm wall time and rate; the timed run equal to the warm-up run bit for
    bit; the kernel's time per block alone at B = 4096, 8192 and 16384,
    at this width its bound and the plain version's time; then, at a depth
    that fits the time limit, ``use_kernel="always"`` against ``"never"``
    on the first 256 clips × 8 blocks (<= -100 dBFS, last-block scores
    within 1e-3), and the timed run's first 256 clips × 8 blocks equal to
    the "always" run bit for bit (the chain is causal);
4f. per-clip texture materials: the mixed chain kernel (a material per CTA
    of 32 clips) and the mixed texture stage kernel against their plain
    versions at B = 100 with a material per clip at random (sorted into
    runs padded to 32) over two blocks, audio, every state leaf and both
    lanes bit-equal, and a uniform material array through each bit-equal
    to the static launch; ``run_corpus_chain(materials=arange(B) % 5)`` on
    bench.py's chain at B = 8192 (bench.py:450 ``bench_mixed_materials``,
    94 blocks): one launch per block and no other, its scoring-only wall
    beside gel's, its first 256 clips x 2 blocks against "never" (<= -100
    dBFS, scores within 1e-3) and equal to a separate run of them; the two
    mixed kernels alone at B = 4096 and 8192 beside gel's static launch in
    turns, with their bounds for the mixed corpus and their geometry; and
    ``run_corpus`` on a texture plugin with a material per clip at B =
    4096 (94 launches; 256 clips x 4 blocks against "never");
4g. per-block automation: the automated chain stream (a constant row per
    block) against its plain version at B = 100 over three blocks, audio,
    every state leaf and both lanes bit-equal; ``run_corpus_chain`` with
    the saturator's drive, punch's mix and infer's sensitivity automated
    at B = 8192 (94 launches and no other; its wall beside the
    unautomated one; 256 clips x 4 blocks against "never"); the automated
    launch alone beside the unautomated one, in turns;
4h. the finalize's EMA kernel (``ema_scan``, csrc/finalize.cu, which
    replaces no TPU kernel): one launch per ``run_corpus_chain`` call at
    B = 8192; on the chain's own lanes (bench.py's chain on the burst
    input, 94 blocks, the formulas' onset rates and penalties) bit-equal to
    its plain walk, and at a ragged B = 100 with an inf and a NaN among the
    inputs and a NaN in the state; its time alone at B = 8192, nb = 94
    with its bytes bound, the plain walk's and the whole
    ``finalize_stream``'s. ``--phase 4h`` runs it alone, after the build;
5.  serving: ``StreamServer`` on bench.py's chain with 4096 slots, all
    open, fed the burst input (PCM16 values) by ``submit_many``: 8 ticks,
    one chain-kernel launch per tick and no other; then per-slot edits on a
    quarter of the slots (punch, infer's trim, width's Haas delay), 2
    ticks with one launch each, equal bit for bit to a direct
    ``chain_kernel_step(params_rows=)`` from a copy of the pool's state, and
    the first 64 slots equal to the plain rows step (<= -120 dBFS, every
    state leaf bit-equal); the i16 wire within 1.01/32768 of the f32 wire,
    the metering rail's scores and async ticks equal to the f32 pool's; the
    walls of submit_many and of the tick (p50/p95 over 30 ticks, shared and
    with per-slot rows), sustained async, i16 and metering-rail ticks, and,
    with every slot a setting of its own, of one ``set_params`` and the
    tick after it (one launch each), against the 10.667 ms block deadline
    (reported, not gated);
6.  the host entry points: the CLI's corpus command (``cli.main``, what
    ``python -m juicy_tpu_torch corpus`` runs) on 64 one-second WAVs in
    two batches with a checkpoint, then again from the cursor rewound to
    half-way (one chain-kernel launch per block of each batch, every output
    bit-equal to ``run_corpus_chain``); its serve command on 4 WAVs (one
    launch per tick, equal to a direct ``StreamServer``); its process
    command with punch (one punch launch per block, bit-equal to the
    ``StreamStep`` loop, its first 3 blocks to the plain stage step on the
    card; texture and motion through ``StreamStep`` at B = 1 against their
    plain steps, audio and every state leaf bit-equal); ``PipelinedStream`` on the canonical chain, depth
    2, 94 ticks (one launch per tick, audio bit-equal to
    ``chain_kernel_stream`` and its first ticks to the plain step on the
    card, tick walls against the 10.667 ms block); ``HostBridge`` on the
    saturator over 200 blocks (every block back in order, bit-equal to
    ``run_corpus`` and its first 3 blocks to the plain stage step on the
    card, at least 1x realtime); one block alone of width, cohere
    and infer (no kernel: ``Plugin.step``), timed. ``--phase 6`` runs this
    phase alone, after the build;
7.  the relaxed tier: ``relaxed_chain_stream`` on bench.py's chain at
    B = 256 (bench.py:820), 94 blocks of the burst input: finite, scores in
    [0, 100], no launch of the port's kernels; against ``run_corpus_chain
    (metrics="blocks")`` gated over the first 4 blocks (the depth JAX
    certified: <= -90 dBFS, the last stage's scores within 0.01) and
    reported over all 94 (the residual per block, the first past -90
    dBFS); the same call on the CPU over 16 clips x 2 blocks (<= -110
    dBFS, metrics within 1e-5 of max(1, |value|), onset counts, cooldowns
    and motion's rng equal); the warm wall and audio-s/s, the launches
    per block (``torch.profiler``) and one block at B = 8192, timed.
    ``--phase 7`` runs it alone;
8.  the mesh: every visible card, or ``[cuda:0, cuda:0]`` on one (the
    split and the gather only): ``run_corpus_chain`` at B = 8192 (94
    blocks, ``metrics="blocks"``) and ``run_corpus`` saturator at B =
    4096, every output bit-equal to the unsharded run, 94 launches per
    shard; ``run_corpus_resumable`` (macro batches of 301, padded) with
    the unsharded scores; ``StreamServer(mesh=)`` with 8 slots on JAX's
    script (tests/test_serve.py:278-307): the kernel tick bit-equal to the
    solo server, the fused tick bit-equal to a solo server of its pools'
    size and within JAX's tolerances of the solo server (PyTorch's CUDA
    sums follow the batch's shape); ``sequence_parallel_linear_scan`` at
    T = 94 x 512 bit-equal to the same split on the CPU and within JAX's
    rtol 1e-4 / atol 1e-5 of ``linear_scan_assoc``. ``--phase 8`` runs it
    alone.

Before each path every launch count is set to 0, and read after it.
The line before the last is a JSON summary of the kernels, with each one's
bound (the least time the card could take for the same work, from the bytes
and operations this run's shapes need); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SR = 48000.0
BLOCK = 512
NUM_BLOCKS = 94
CHANNELS = 2
BATCH = 4096
CHECK_CLIPS = 256
PRESET = "Amber Heat"
PUNCH_PRESET = "Solar Snap"
CHAIN = [("punch", "Solar Snap"), ("saturator", "Amber Heat"),
         ("texture", None), ("motion", None), ("width", "Prism Arc"),
         ("cohere", None), ("infer", "Reference Lens")]        # bench.py:41-49
CHAIN_BATCH = 256
CHAIN_CORPUS_BATCH = 8192        # bench.py:798, the full_chain row
#: batches at which 4e times the chain kernel alone
CHAIN_TIMED_BATCHES = (4096, 8192, 16384)
#: batches at which 3-3d time the stage kernels alone
STAGE_TIMED_BATCHES = (4096, 8192)
#: clock cycles of the spin kernel that kernel_ms queues its launches behind
#: (~10 ms, longer than the host takes to make 20 launches)
SPIN_CYCLES = 20_000_000
#: 3's to 3e's ragged batch: not a multiple of the warp-role kernels' 32
#: clips per CTA
RAGGED_BATCH = 100
CHAIN_CHECK_BLOCKS = 8
#: corpus paths whose never-path check runs at full depth (4, 4b, 4c); the
#: others run CHAIN_CHECK_BLOCKS blocks
FULL_DEPTH_CHECKS = ("saturator", "texture wood", "punch")
SERVE_SLOTS = 4096               # bench.py:658, bench_serve_e2e's rows_at
SERVE_BLOCKS = 12
SERVE_CHECK_SLOTS = 64
SERVE_TIMED = 30                 # bench.py:658, steps
CHAIN_MATERIALS = (0, 2)         # gel (bench.py's chain) and wood (bench.py:796)
MATERIALS = ("gel", "metal", "wood", "plastic", "flesh")
MIXED_BATCH = 8192                # bench.py:450, bench_mixed_materials
MIXED_SEED = 53
MIXED_CHECK_BLOCKS = 2
MIXED_TEX_CHECK_BLOCKS = 4
AUTO_CHECK_BLOCKS = 4
# curves over the corpus, resampled to one value per block
# (runtime/stream.py::automation_curve): the saturator's drive, punch's mix
# and infer's sensitivity
AUTOMATION = {1: {"drive": [3.0, 15.0, 6.0]}, 0: {"mix": [0.4, 1.0]},
              6: {"sensitivity": [0.6, 1.4]}}
# BASELINE.json config #3, punch with automation: its amount and mix
PUNCH_AUTOMATION = {"punch": [0.2, 1.4, 0.7, 1.1], "mix": [1.0, 0.6]}
CORPUS_MATERIALS = (0, 1, 2)      # bench.py's texture rows
REFERENCE_MATERIAL = 1            # the texture row of the kernels line
RELAXED_BATCH = 256               # bench.py:820, full_chain_relaxed_b256
#: the depth at which JAX certified the relaxed tier (tests/test_relaxed.py)
RELAXED_GATED_BLOCKS = 4
RELAXED_CPU_CLIPS = 16
RELAXED_CPU_BLOCKS = 2
RELAXED_WIDE_BATCH = 8192
MESH_CORPUS_BATCH = 4096          # run_corpus's width (4)
MESH_RESUME_CLIPS = 1024
MESH_MACRO = 301                  # not a multiple of the mesh: padded
MESH_SLOTS = 8                    # tests/test_serve.py:278-307

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per sample that the loop bodies need, counted from the CUDA
# sources: each add, subtract, multiply, divide, min, max, rint and compare
# counts one; abs, selects and integer work (the LCG, index and conversion
# arithmetic) count nothing, nor do terms of the constants alone, which the
# compiler hoists. tanh32 is 29, cos32 21. The analyzer lane (lane.cuh
# lane_step, per clip-sample, run twice), the saturator per channel-sample
# (saturator_stage.cu), texture's front, back and noise per channel-sample
# (texture.cuh) and each material's step (wood and plastic with the ring
# tap and its interpolation). pow32 is 40 (log2 18, exp2 21, one multiply),
# sin32 26, exp32_narrow 18. Punch per channel-sample (punch.cuh
# punch_sample); motion's pass 1 per clip-sample and pass 2 per
# channel-sample (motion.cuh motion_p1, motion_p2). Left out, as under a
# thousandth of the work here: motion's three draws on an onset (12 ops, at
# most one onset per 1920 samples) and the once-per-block terms. The chain
# kernel adds width per clip-sample (width.cuh: the dip test, M/S, both
# mixes), cohere's analysis per clip-sample and its render per
# channel-sample (cohere.cuh), and infer's trim per channel-sample.
LANE_OPS = 42
SAT_OPS = 40
TEX_OPS = 84
TEX_MAT_OPS = (46, 140, 47, 47, 57)
TEX_NMAT = (2, 8, 9, 9, 4)
PUNCH_OPS = 98
MOTION_P1_OPS = 10
MOTION_P2_OPS = 109
WIDTH_OPS = 22
COHERE_A_OPS = 17
COHERE_R_OPS = 23
INFER_OPS = 1


def make_batch(batch, channels, t, device, seed=7):
    """bench.make_batch's signal, drawn on the device: noise * 0.1 plus a
    0.2 sine at 220 Hz, clipped to +-0.99."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, channels, t), generator=g, device=device) * 0.1
    tt = torch.arange(t, dtype=torch.float32, device=device)
    x += 0.2 * torch.sin((2 * math.pi * 220.0 / SR) * tt)
    return torch.clamp(x, -0.99, 0.99)


def make_clicks(batch, channels, t, device, seed, period=int(SR * 0.1)):
    """A quiet bed (|mono| < 0.02: a 220 Hz tone and noise) and a decaying
    900 Hz burst every `period` samples (100 ms, longer than motion's 40 ms
    cooldown) from a per-clip offset, so that onsets fall inside the blocks.
    Drawn on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    tt = torch.arange(t, dtype=torch.float32, device=device)
    offset = torch.randint(0, period, (batch, 1, 1), generator=g,
                           device=device).float()
    since = torch.remainder(tt - offset, period)
    burst = torch.exp(-since / 120.0) * 0.6 * torch.sin(
        (2 * math.pi * 900.0 / SR) * since)
    gain = torch.tensor([1.0, 0.9][:channels], device=device)[None, :, None]
    bed = 0.008 * torch.sin((2 * math.pi * 220.0 / SR) * tt)
    noise = torch.randn((batch, channels, t), generator=g, device=device)
    return torch.clamp(bed + gain * burst + 0.002 * noise, -0.99, 0.99)


def residual_dbfs(a, b):
    diff = float(torch.max(torch.abs(a.double() - b.double())))
    return -math.inf if diff == 0 else 20.0 * math.log10(diff)


def max_diff(a, b):
    return float(torch.max(torch.abs(a.double() - b.double())))


def cuda_ms(fn, reps):
    """Mean milliseconds per call of `fn` on the current stream."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps):
    """Mean device milliseconds per call of `fn`, a kernel launch: the calls
    are queued behind a spin kernel (``torch.cuda._sleep``) so that they run
    back to back on the card, and the host's time to make each launch,
    which can exceed a short kernel's, is not counted."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops):
    """(bound ms, what sets it): the larger of bytes over the memory rate
    and operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def saturator_bound(b, c, n):
    """Audio in and out, tone state in and out, lane in, two lanes out."""
    nbytes = 4 * (2 * b * c * n + 2 * b * c + 5 * b + 2 * 15 * b)
    return bound(nbytes, b * n * (2 * LANE_OPS + c * SAT_OPS))


def texture_work(b, c, n, mode, delay):
    """(bytes, operations) of one texture block: audio, state and lanes
    once each way. Wood and plastic also read the ring rows this block
    reads before it writes them (ceil(delay) + 1 of them, at most n + 1)
    and write n rows, plus the write indices."""
    nbytes = 4 * (2 * b * c * n + 2 * (9 + TEX_NMAT[mode]) * b * c + 2 * b
                  + 5 * b + 2 * 15 * b)
    if mode in (2, 3):
        rows_in = min(math.ceil(delay) + 1, n + 1)
        nbytes += 4 * b * c * (rows_in + n) + 2 * 4 * b * c
    return nbytes, b * n * (2 * LANE_OPS + c * (TEX_OPS + TEX_MAT_OPS[mode]))


def texture_bound(b, c, n, mode, delay):
    return bound(*texture_work(b, c, n, mode, delay))


def punch_bound(b, c, n):
    """Audio in and out, the followers in and out, lane in, two lanes out."""
    nbytes = 4 * (2 * b * c * n + 2 * 2 * b * c + 5 * b + 2 * 15 * b)
    return bound(nbytes, b * n * (2 * LANE_OPS + c * PUNCH_OPS))


def motion_bound(b, c, n):
    """Audio in and out; the 10 mono leaves, cooldown, rng and 3 channel
    leaves in and out; lane in, two lanes out."""
    nbytes = 4 * (2 * b * c * n + 2 * (12 * b + 3 * b * c) + 5 * b
                  + 2 * 15 * b)
    return bound(nbytes, b * n * (2 * LANE_OPS + MOTION_P1_OPS
                                  + c * MOTION_P2_OPS))


def chain_bound(b, c, n, mode, tex_delay, haas_delay):
    return bound(*chain_work(b, c, n, mode, tex_delay, haas_delay))


def mixed_bound(work, counts):
    """The bound of a mixed-material launch: each material's (bytes,
    operations) from `work(clips, mode)` for the corpus's own clips of it
    (`counts` {mode: clips}), summed. The padding clips that the sort adds
    are not work the function needs: their time is lost efficiency."""
    nbytes = ops = 0
    for mode, nb in counts.items():
        w = work(nb, mode)
        nbytes, ops = nbytes + w[0], ops + w[1]
    return bound(nbytes, ops)


def chain_work(b, c, n, mode, tex_delay, haas_delay):
    """(bytes, operations) of the chain kernel per block: audio in and out;
    every stage's state in and out (texture's ring rows as in texture_work;
    the Haas ring's rows this block reads before it writes them,
    min(delay, n), and the n it writes; cohere's context fit out); seven
    lanes in and 14 out."""
    state = (2 * c + c + (9 + TEX_NMAT[mode]) * c + 3 * c + c   # per clip
             + 1 + 12 + 5)
    nbytes = 4 * (2 * b * c * n + 2 * state * b + b + 7 * 5 * b
                  + 14 * 15 * b + b * (min(haas_delay, n) + n))
    if mode in (2, 3):
        rows_in = min(math.ceil(tex_delay) + 1, n + 1)
        nbytes += 4 * b * c * (rows_in + n)
    per_clip = (14 * LANE_OPS + MOTION_P1_OPS + WIDTH_OPS + COHERE_A_OPS
                + c * (PUNCH_OPS + SAT_OPS + TEX_OPS + TEX_MAT_OPS[mode]
                       + MOTION_P2_OPS + COHERE_R_OPS + INFER_OPS))
    return nbytes, b * n * per_clip


def stage_steps():
    """Every stage kernel's wrapper, by name; each counts its launches."""
    from juicy_tpu_torch.kernels import stage_kernels as sk

    return {"punch": sk.punch_stage_step, "saturator": sk.saturator_stage_step,
            "texture": sk.texture_stage_step, "motion": sk.motion_stage_step}


def chain_step():
    """The chain kernel's wrapper; it counts the launches of its step and
    its stream."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    return ck.chain_kernel_step


def entry_steps():
    """The wrappers of the kernels that are entry points of their own:
    ``analyze_fused`` (csrc/analyzer.cu) and ``saturator_step_fused`` (a
    launch of csrc/saturator_stage.cu under its own count)."""
    from juicy_tpu_torch.kernels import analyzer_kernel as ak
    from juicy_tpu_torch.kernels import saturator_kernel as satk

    return {"analyzer": ak.analyze_fused,
            "saturator_step_fused": satk.saturator_step_fused}


def all_steps():
    return [*stage_steps().values(), chain_step(), *entry_steps().values()]


def reset_launches():
    for step in all_steps():
        step.launches = 0


def other_launches(step):
    """Launches counted since the reset by every wrapper but `step`."""
    return sum(s.launches for s in all_steps() if s is not step)


def check_corpus_outputs(out, clips, last):
    if tuple(out.shape) != tuple(clips.shape) or not bool(torch.isfinite(out).all()):
        raise AssertionError("corpus output is not finite or has the wrong shape")
    for key, v in last.items():
        if tuple(v.shape) != (clips.shape[0],) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"metric {key} is not finite [B]")
    for key in ("score", "pre_score", "post_score"):
        if not bool(((last[key] >= 0) & (last[key] <= 100)).all()):
            raise AssertionError(f"{key} outside [0, 100]")


def check_metrics(tag, m_k, m_p):
    for key in m_k:
        tol = 1e-4 if key.endswith("score") else 1e-5
        d = max_diff(m_k[key], m_p[key])
        if d > tol:
            raise AssertionError(f"{tag}: metric {key} off by {d}")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")


def phase_build():
    from juicy_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {_build.library_path()}")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")


def check_lanes(tag, raw_k, raw_p):
    """Both lanes (pre fin, pre acc, post fin, post acc; the cooldowns are
    fin row 4, the onset counts acc row 1) bit-equal."""
    for j, (a, b) in enumerate(zip(raw_k, raw_p)):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: lane output {j} differs")


def saturator_kernel_vs_plain(device, plugin, params, x, timed=True):
    """The saturator stage kernel against its plain version, two blocks,
    state carried: audio, tone state and both lanes bit-equal; then, if
    `timed`, the times per block."""
    from juicy_tpu_torch.kernels import stage_kernels as sk

    b, n = x.shape[0], BLOCK
    st_k = st_p = plugin.init_state((b,), device)
    scalars = sk._sat_scalars(params, plugin.sr)
    worst = 0.0
    for i in range(2):
        blk = x[..., i * n:(i + 1) * n]
        tag = f"saturator B={b} block {i}"
        lane0 = sk.pack_lane(st_k["analyzer"], b)
        raw_k = sk._sat_lanes_cuda(blk, st_k["dsp"]["tone_state"], lane0, scalars)
        raw_p = sk._sat_lanes_plain(blk, st_k["dsp"]["tone_state"], lane0, scalars)
        check_lanes(tag, raw_k[2:], raw_p[2:])
        out_k, st_k, m_k = sk.saturator_stage_step(params, st_k, blk, plugin.sr)
        out_p, st_p, m_p = sk.saturator_stage_step_plain(params, st_p, blk,
                                                         plugin.sr)
        db = residual_dbfs(out_k, out_p)
        worst = max(worst, max_diff(out_k, out_p))
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"{tag}: kernel vs plain {db:.1f} dBFS")
        if not torch.equal(st_k["dsp"]["tone_state"], st_p["dsp"]["tone_state"]):
            raise AssertionError(f"{tag}: tone_state differs")
        if not torch.equal(st_k["analyzer"]["onset_cooldown"],
                           st_p["analyzer"]["onset_cooldown"]):
            raise AssertionError(f"{tag}: onset_cooldown differs")
        check_metrics(tag, m_k, m_p)
        print(f"{tag}: audio, tone state and both lanes bit-equal, lane "
              f"onsets {int(raw_k[3][1].sum())} pre / {int(raw_k[5][1].sum())} "
              f"post, score {max_diff(m_k['score'], m_p['score']):.3g}")
    if not timed:
        return {"max_abs_err": worst}

    blk = x[..., :n]
    st0 = plugin.init_state((b,), device)
    lane0 = sk.pack_lane(st0["analyzer"], b)
    tone0 = st0["dsp"]["tone_state"]
    bufs = sk.sat_cuda_buffers(blk, tone0, lane0)
    ms = kernel_ms(lambda: sk.sat_cuda_launch(bufs, scalars), 20)
    layout_ms = cuda_ms(lambda: sk._sat_lanes_cuda(blk, tone0, lane0, scalars),
                        20)
    step_ms = cuda_ms(lambda: sk.saturator_stage_step(params, st0, blk,
                                                      plugin.sr), 20)
    plain_ms = cuda_ms(lambda: sk._sat_lanes_plain(blk, tone0, lane0, scalars), 1)
    bound_ms, bound_by = saturator_bound(b, CHANNELS, n)
    print(f"saturator per block at B={b}, N={n}: kernel {ms:.4f} ms alone, "
          f"{layout_ms:.4f} ms with layout, whole step {step_ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "layout_ms": layout_ms, "step_ms": step_ms}


def phase_kernel_vs_plain(device, plugin, params):
    """3: the saturator at B = 4096 and at a ragged batch (its last CTA
    partly past B), its geometry and its times alone."""
    geo = stage_geometry(device, "saturator")
    res = saturator_kernel_vs_plain(
        device, plugin, params, make_batch(BATCH, CHANNELS, 2 * BLOCK, device,
                                           seed=11))
    err = saturator_kernel_vs_plain(
        device, plugin, params, make_batch(RAGGED_BATCH, CHANNELS, 2 * BLOCK,
                                           device, seed=12), timed=False)
    res["max_abs_err"] = max(res["max_abs_err"], err["max_abs_err"])
    res["geometry"] = geo
    res["ms_by_batch"] = stage_ms_by_batch(device, "saturator")
    return res


def texture_kernel_vs_plain(device, mode, x, timed=True):
    """One material: kernel and plain version over two blocks, each from its
    own copy of the state; then, if `timed`, the times per block."""
    from juicy_tpu_torch.kernels import stage_kernels as sk
    from juicy_tpu_torch.models import texture as tex
    from juicy_tpu_torch.runtime.plugin import Plugin

    b, n = x.shape[0], BLOCK
    plugin = Plugin("texture", SR, CHANNELS, n).with_static(material=mode)
    params = plugin.full_params(plugin.default_params())
    st0 = plugin.init_state((b,), device)
    st_k, st_p = ({"analyzer": st0["analyzer"],
                   "dsp": sk.texture_kernel_state(st0["dsp"], mode)}
                  for _ in range(2))
    worst = 0.0
    for i in range(2):
        blk = x[..., i * n:(i + 1) * n]
        lanes_k = sk._tex_lanes_cuda(blk, st_k["dsp"], sk.pack_lane(
            st_k["analyzer"], b), params, SR, mode)
        lanes_p = sk._tex_lanes_plain(blk, st_p["dsp"], sk.pack_lane(
            st_p["analyzer"], b), params, SR, mode)
        (out_k, dsp_k, *raw_k), (out_p, dsp_p, *raw_p) = lanes_k, lanes_p
        tag = f"texture {MATERIALS[mode]} B={b} block {i}"
        db = residual_dbfs(out_k, out_p)
        worst = max(worst, max_diff(out_k, out_p))
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"{tag}: kernel vs plain {db:.1f} dBFS")
        for key, v in dsp_p.items():
            if not torch.equal(dsp_k[key], v):
                raise AssertionError(f"{tag}: state {key} differs")
        for j in (0, 2):       # fin row 4 = cooldown, acc row 1 = onsets
            if not torch.equal(raw_k[j][4], raw_p[j][4]):
                raise AssertionError(f"{tag}: lane cooldowns differ")
            if not torch.equal(raw_k[j + 1][1], raw_p[j + 1][1]):
                raise AssertionError(f"{tag}: onset counts differ")
        an_k, m_k, _ = sk.metrics_from_lanes(*raw_k, st_k["analyzer"], n, SR)
        an_p, m_p, _ = sk.metrics_from_lanes(*raw_p, st_p["analyzer"], n, SR)
        check_metrics(tag, m_k, m_p)
        st_k, st_p = {"analyzer": an_k, "dsp": dsp_k}, {"analyzer": an_p,
                                                       "dsp": dsp_p}
        print(f"{tag}: audio {db:.1f} dBFS, state bit-equal, onsets "
              f"{int(raw_k[1][1].sum())}, score "
              f"{max_diff(m_k['score'], m_p['score']):.3g}")
    if not timed:
        return {"max_abs_err": worst}

    blk = x[..., :n]
    lane0 = sk.pack_lane(st_k["analyzer"], b)
    bufs = sk.tex_cuda_buffers(blk, st_k["dsp"], lane0, mode)
    ms = kernel_ms(lambda: sk.tex_cuda_launch(bufs, params, SR, mode), 20)
    layout_ms = cuda_ms(lambda: sk._tex_lanes_cuda(blk, st_k["dsp"], lane0,
                                                   params, SR, mode), 20)
    step_ms = cuda_ms(lambda: sk.texture_stage_step(params, st_k, blk, SR), 20)
    plain_ms = cuda_ms(lambda: sk._tex_lanes_plain(blk, st_p["dsp"], lane0,
                                                   params, SR, mode), 1)
    delay = float(tex.material_consts(mode, tex.common_consts(
        params, SR, mode)[1], SR, tex.waveguide_size(SR))["delay_samp"]) \
        if mode in tex.WAVE_MODES else 0.0
    bound_ms, bound_by = texture_bound(b, CHANNELS, n, mode, delay)
    print(f"texture {MATERIALS[mode]} per block at B={b}, N={n}: kernel "
          f"{ms:.4f} ms alone, {layout_ms:.4f} ms with layout, whole step "
          f"{step_ms:.4f} ms, plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by})")
    return {"max_abs_err": worst, "ms": ms, "layout_ms": layout_ms,
            "step_ms": step_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_texture_kernel_vs_plain(device):
    """3b: every material at B = 4096 and at a ragged batch (its last CTA
    partly past B), the kernel's geometry and its times alone."""
    x = make_batch(BATCH, CHANNELS, 2 * BLOCK, device, seed=13)
    ragged = make_batch(RAGGED_BATCH, CHANNELS, 2 * BLOCK, device, seed=15)
    res = {}
    for mode in range(5):
        geo = stage_geometry(device, "texture", mode)
        r = texture_kernel_vs_plain(device, mode, x)
        err = texture_kernel_vs_plain(device, mode, ragged, timed=False)
        r["max_abs_err"] = max(r["max_abs_err"], err["max_abs_err"])
        r["geometry"] = geo
        r["ms_by_batch"] = stage_ms_by_batch(device, "texture", mode)
        res[MATERIALS[mode]] = r
    return res


def corpus_run(tag, plugin, params, clips, step, automation=None):
    """One corpus path at full width: a warm-up, then the timed run with
    every launch count set to 0 before it and read after it; `step`'s kernel
    must have launched once per block and no other. The timed run's first
    CHECK_CLIPS clips are then held against ``use_kernel="never"``: at full
    depth for the FULL_DEPTH_CHECKS, else over CHAIN_CHECK_BLOCKS blocks, as
    4e does (the kernel route run there too, and equal to the timed run's
    first blocks bit for bit: the plugins are causal). `automation`
    ({param: [NUM_BLOCKS]}) goes to every run, cut to the check's blocks.
    Returns (launches, the timed run's wall)."""
    from juicy_tpu_torch.parallel.corpus import run_corpus

    run_corpus(plugin, params, clips, automation=automation)     # warm-up
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    out, last, agg = run_corpus(plugin, params, clips, automation=automation)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = step.launches
    other = other_launches(step)
    if launches != NUM_BLOCKS or other:
        raise AssertionError(f"{tag}: {launches} kernel launches (and {other} "
                             f"of another kernel) for {NUM_BLOCKS} blocks")
    check_corpus_outputs(out, clips, last)
    t = clips.shape[-1]
    print(f"run_corpus {tag} B={BATCH} T={t}: {wall:.4f} s warm, "
          f"{BATCH * t / SR / wall:.1f} audio-s/s, mean score "
          f"{float(agg['score']['mean']):.4f}")

    t0 = time.perf_counter()
    full = tag in FULL_DEPTH_CHECKS
    depth = t if full else CHAIN_CHECK_BLOCKS * BLOCK
    sub = clips[:CHECK_CLIPS, :, :depth]
    auto = None if automation is None else {
        k: v[:depth // BLOCK] for k, v in automation.items()}
    if full:
        out_k, last_k = out[:CHECK_CLIPS], {"score": last["score"][:CHECK_CLIPS]}
    else:
        out_k, last_k, _ = run_corpus(plugin, params, sub, automation=auto)
        if not torch.equal(out_k, out[:CHECK_CLIPS, :, :depth]):
            raise AssertionError(f"{tag}: the timed run's first clips differ "
                                 f"from the check run")
    out_n, last_n, _ = run_corpus(plugin, params, sub, use_kernel="never",
                                  automation=auto)
    torch.cuda.synchronize()
    db = residual_dbfs(out_k, out_n)
    ds = max_diff(last_k["score"], last_n["score"])
    print(f"{tag} kernel path vs never on {CHECK_CLIPS} clips x "
          f"{depth // BLOCK} blocks: audio {db:.1f} dBFS, last-block score "
          f"{ds:.3g} ({time.perf_counter() - t0:.1f} s)")
    if db > -100.0 or ds > 1e-3:
        raise AssertionError(f"{tag}: kernel corpus path disagrees with "
                             f"batched_run")
    return launches, wall


def phase_corpus(device, plugin, params):
    from juicy_tpu_torch.kernels import stage_kernels as sk

    clips = make_batch(BATCH, CHANNELS, NUM_BLOCKS * BLOCK, device)
    return corpus_run("saturator", plugin, params, clips,
                      sk.saturator_stage_step)[0]


def model_kernel_vs_plain(device, name, params, x, timed=True):
    """Punch or motion: kernel and plain version over two blocks, each from
    its own copy of the state; then, if `timed`, the times per block."""
    from juicy_tpu_torch.kernels import stage_kernels as sk
    from juicy_tpu_torch.runtime.plugin import Plugin

    b, n = x.shape[0], BLOCK
    plugin = Plugin(name, SR, CHANNELS, n)
    lanes_cuda = getattr(sk, f"_{name}_lanes_cuda")
    lanes_plain = getattr(sk, f"_{name}_lanes_plain")
    st0 = st_k = st_p = plugin.init_state((b,), device)
    worst = 0.0
    for i in range(2):
        blk = x[..., i * n:(i + 1) * n]
        out_k, dsp_k, *raw_k = lanes_cuda(blk, st_k["dsp"], sk.pack_lane(
            st_k["analyzer"], b), params, SR)
        out_p, dsp_p, *raw_p = lanes_plain(blk, st_p["dsp"], sk.pack_lane(
            st_p["analyzer"], b), params, SR)
        tag = f"{name} B={b} block {i}"
        db = residual_dbfs(out_k, out_p)
        worst = max(worst, max_diff(out_k, out_p))
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"{tag}: kernel vs plain {db:.1f} dBFS")
        if set(dsp_k) != set(dsp_p):
            raise AssertionError(f"{tag}: state keys differ")
        for key, v in dsp_p.items():
            if dsp_k[key].dtype != v.dtype or not torch.equal(dsp_k[key], v):
                raise AssertionError(f"{tag}: state {key} differs")
        check_lanes(tag, raw_k, raw_p)
        an_k, m_k, _ = sk.metrics_from_lanes(*raw_k, st_k["analyzer"], n, SR)
        an_p, m_p, _ = sk.metrics_from_lanes(*raw_p, st_p["analyzer"], n, SR)
        check_metrics(tag, m_k, m_p)
        st_k, st_p = {"analyzer": an_k, "dsp": dsp_k}, {"analyzer": an_p,
                                                       "dsp": dsp_p}
        extra = ""
        if name == "motion":
            rolled = float((dsp_k["rng"] != st0["dsp"]["rng"]).float().mean())
            extra = (f", rng rolled in {rolled:.1%} of clips, cooldown "
                     f"running in {float((dsp_k['onset_cooldown'] > 0).float().mean()):.1%}")
        print(f"{tag}: audio, state and both lanes bit-equal, lane onsets "
              f"{int(raw_k[1][1].sum())} pre / {int(raw_k[3][1].sum())} post, "
              f"score {max_diff(m_k['score'], m_p['score']):.3g}{extra}")
    if name == "motion" and rolled < 0.9:
        raise AssertionError(f"motion: pass 1 rolled the LCG in only "
                             f"{rolled:.1%} of clips")
    if not timed:
        return {"max_abs_err": worst}

    blk = x[..., :n]
    lane0 = sk.pack_lane(st_k["analyzer"], b)
    bufs = getattr(sk, f"{name}_cuda_buffers")(blk, st_k["dsp"], lane0)
    launch = getattr(sk, f"{name}_cuda_launch")
    step = stage_steps()[name]
    ms = kernel_ms(lambda: launch(bufs, params, SR), 20)
    layout_ms = cuda_ms(lambda: lanes_cuda(blk, st_k["dsp"], lane0, params,
                                           SR), 20)
    step_ms = cuda_ms(lambda: step(params, st_k, blk, SR), 20)
    plain_ms = cuda_ms(lambda: lanes_plain(blk, st_p["dsp"], lane0, params,
                                           SR), 1)
    bound_ms, bound_by = {"punch": punch_bound,
                          "motion": motion_bound}[name](b, CHANNELS, n)
    print(f"{name} per block at B={b}, N={n}: kernel {ms:.4f} ms alone, "
          f"{layout_ms:.4f} ms with layout, whole step {step_ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "layout_ms": layout_ms, "step_ms": step_ms}


def phase_punch_motion_kernels(device):
    """3c and 3d: punch ("Solar Snap") and motion (defaults)."""
    from juicy_tpu_torch.runtime.plugin import Plugin

    # one burst per clip, somewhere in the two blocks
    x = make_clicks(BATCH, CHANNELS, 2 * BLOCK, device, seed=19,
                    period=2 * BLOCK)
    ragged = make_clicks(RAGGED_BATCH, CHANNELS, 2 * BLOCK, device, seed=21,
                         period=2 * BLOCK)
    res = {}
    for name in ("punch", "motion"):
        plugin = Plugin(name, SR, CHANNELS, BLOCK)
        params = (plugin.preset(PUNCH_PRESET) if name == "punch"
                  else plugin.default_params())
        geo = stage_geometry(device, name)
        res[name] = model_kernel_vs_plain(device, name, params, x)
        err = model_kernel_vs_plain(device, name, params, ragged, timed=False)
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                       err["max_abs_err"])
        res[name]["geometry"] = geo
        res[name]["ms_by_batch"] = stage_ms_by_batch(device, name)
    return res


def phase_punch_motion_corpus(device):
    """4c: punch and motion at full width on the burst input."""
    from juicy_tpu_torch.runtime.plugin import Plugin

    clips = make_clicks(BATCH, CHANNELS, NUM_BLOCKS * BLOCK, device, seed=23)
    launches = {}
    for name, preset in (("punch", PUNCH_PRESET), ("motion", None)):
        plugin = Plugin(name, SR, CHANNELS, BLOCK)
        params = plugin.preset(preset) if preset else plugin.default_params()
        launches[name] = corpus_run(name, plugin, params, clips,
                                    stage_steps()[name])[0]
    return launches


def phase_chain(device):
    """4d: the seven-stage Chain on the card against the CPU, and the
    block-major executor against Chain.batched_run on the card."""
    from juicy_tpu_torch.runtime.chain_fused import fused_chain_stream
    from juicy_tpu_torch.runtime.plugin import Chain

    chain = Chain(CHAIN, SR, CHANNELS, BLOCK)
    clips = make_clicks(CHAIN_BATCH, CHANNELS, 2 * BLOCK, device, seed=29)
    t0 = time.perf_counter()
    out_g, _st, m_g = chain.batched_run(chain.init_state((CHAIN_BATCH,),
                                                         device), clips)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_c, _st, m_c = chain.batched_run(chain.init_state((CHAIN_BATCH,),
                                                         "cpu"), clips.cpu())
    t_cpu = time.perf_counter() - t0
    if out_g.device != clips.device or not bool(torch.isfinite(out_g).all()):
        raise AssertionError("chain: output not finite on the card")
    db = residual_dbfs(out_g.cpu(), out_c)
    worst = 0.0
    for s, (stage_g, stage_c) in enumerate(zip(m_g, m_c, strict=True)):
        for key, v in stage_c.items():
            d = (stage_g[key].cpu().double() - v.double()).abs()
            rel = float((d / v.double().abs().clamp(min=1.0)).max())
            worst = max(worst, rel)
            if rel > 1e-5:
                raise AssertionError(f"chain stage {CHAIN[s][0]}: metric "
                                     f"{key} off by {rel:.3g} of its scale")
    print(f"chain ({len(CHAIN)} stages) B={CHAIN_BATCH} 2 blocks, card vs "
          f"CPU: audio {db:.1f} dBFS, metrics within {worst:.3g} of their "
          f"scale ({t_card:.1f} s on the card, {t_cpu:.1f} s on the CPU)")
    if db > -100.0:
        raise AssertionError(f"chain: card vs CPU {db:.1f} dBFS")
    t0 = time.perf_counter()
    out_f, _st, m_f = fused_chain_stream(
        chain, chain.init_state((CHAIN_BATCH,), device), clips)
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    if not torch.equal(out_f, out_g) or any(
            not torch.equal(mf[key], v) for mf, mg in zip(m_f, m_g)
            for key, v in mg.items()):
        raise AssertionError("fused_chain_stream differs from "
                             "Chain.batched_run on the card")
    print(f"fused_chain_stream on the card equals Chain.batched_run bit for "
          f"bit ({t_fused:.1f} s)")


def chain_stages(material):
    """bench.py's chain with texture `material` (gel is bench.py's)."""
    stages = list(CHAIN)
    stages[2] = ("texture", {"material": material})
    return stages


def chain_kernel_ms(chain, states, blk):
    """The chain kernel's ms per block on `blk` [B, 2, N]: the launch alone
    on prepared buffers, and with the layout permutes each way."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    b, device = blk.shape[0], blk.device
    kc = ck.KernelChain(chain, states, b, device)
    xt = blk.permute(2, 1, 0).contiguous()
    out_t = torch.empty_like(xt)
    fin, acc, fit = (v[0] for v in ck._lane_buffers(1, b, device))
    prev = ck.lane_seed([st["analyzer"] for st in states], b, device)

    def with_layout():
        kc.launch(blk.permute(2, 1, 0).contiguous(), out_t, prev, fin, acc,
                  fit)
        return out_t.permute(2, 1, 0).contiguous()

    return (cuda_ms(lambda: kc.launch(xt, out_t, prev, fin, acc, fit), 20),
            cuda_ms(with_layout, 20))


def kernel_ptxas(mangled):
    """The build log's ptxas lines for the kernel whose mangled name holds
    `mangled`."""
    from juicy_tpu_torch.kernels import _build

    lines, on = [], False
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:
            on = mangled in line
        elif on and ("registers" in line or "spill" in line
                     or "smem" in line):
            lines.append(line.strip())
    return lines


def show_geometry(tag, geo, mangled):
    """Print a warp-role kernel's geometry (clips and warps per CTA,
    registers and shared memory, resident CTAs per SM) and fail on
    spills."""
    print(f"{tag} geometry (N={BLOCK}): "
          f"{geo['clips_per_cta']} clips and {geo['warps_per_cta']} warps "
          f"({geo['threads_per_cta']} threads) per CTA, "
          f"{geo['registers_per_thread']} registers and "
          f"{geo['local_bytes_per_thread']} local bytes per thread, "
          f"{geo['smem_bytes_per_cta']} bytes of shared memory per CTA, "
          f"{geo['ctas_per_sm']} CTAs resident per SM, chunks of "
          f"{geo['chunk_samples']} samples; ptxas: {kernel_ptxas(mangled)}")
    if geo["local_bytes_per_thread"]:
        raise AssertionError(f"{tag} spills "
                             f"({geo['local_bytes_per_thread']} local bytes)")
    return geo


def chain_geometry(device, mode):
    """The chain kernel's geometry for `mode` at N = BLOCK, printed."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    return show_geometry(f"chain kernel ({MATERIALS[mode]})",
                         ck.chain_geometry(mode, BLOCK, device),
                         f"chain_kernelILi{mode}E")


def stage_geometry(device, name, mode=None):
    """A warp-role stage kernel's geometry, stereo, at N = BLOCK, printed."""
    from juicy_tpu_torch.kernels import stage_kernels as sk

    if name == "texture":
        return show_geometry(f"texture kernel ({MATERIALS[mode]})",
                             sk.texture_geometry(mode, BLOCK, 2, device),
                             f"texture_stage_kernelILi2ELi{mode}E")
    geo = getattr(sk, f"{name}_geometry")(BLOCK, 2, device)
    return show_geometry(f"{name} kernel", geo, f"{name}_stage_kernelILi2E")


def stage_alone_ms(device, name, b, mode=None):
    """A stage kernel's ms per block alone at batch `b` (N = BLOCK, stereo)
    on prepared buffers, from a fresh state: punch ("Solar Snap") and
    motion on the burst input, the saturator ("Amber Heat") and texture
    `mode` on bench.py's signal."""
    from juicy_tpu_torch.kernels import stage_kernels as sk
    from juicy_tpu_torch.runtime.plugin import Plugin

    if name == "texture":
        plugin = Plugin("texture", SR, CHANNELS,
                        BLOCK).with_static(material=mode)
        params = plugin.full_params(plugin.default_params())
        x = make_batch(b, CHANNELS, BLOCK, device, seed=41)
        st = plugin.init_state((b,), device)
        bufs = sk.tex_cuda_buffers(x, sk.texture_kernel_state(st["dsp"], mode),
                                   sk.pack_lane(st["analyzer"], b), mode)
        return kernel_ms(lambda: sk.tex_cuda_launch(bufs, params, SR, mode), 20)
    plugin = Plugin(name, SR, CHANNELS, BLOCK)
    params = {"punch": lambda: plugin.preset(PUNCH_PRESET),
              "saturator": lambda: plugin.preset(PRESET),
              "motion": plugin.default_params}[name]()
    x = (make_batch(b, CHANNELS, BLOCK, device, seed=41) if name == "saturator"
         else make_clicks(b, CHANNELS, BLOCK, device, seed=41))
    st = plugin.init_state((b,), device)
    lane0 = sk.pack_lane(st["analyzer"], b)
    if name == "saturator":
        bufs = sk.sat_cuda_buffers(x, st["dsp"]["tone_state"], lane0)
        scalars = sk._sat_scalars(params, SR)
        return kernel_ms(lambda: sk.sat_cuda_launch(bufs, scalars), 20)
    bufs = getattr(sk, f"{name}_cuda_buffers")(x, st["dsp"], lane0)
    launch = getattr(sk, f"{name}_cuda_launch")
    return kernel_ms(lambda: launch(bufs, params, SR), 20)


def stage_ms_by_batch(device, name, mode=None):
    tag = f"{name} {MATERIALS[mode]}" if name == "texture" else name
    by_batch = {}
    for bt in STAGE_TIMED_BATCHES:
        by_batch[bt] = stage_alone_ms(device, name, bt, mode)
        print(f"{tag} kernel alone at B={bt}, N={BLOCK}: {by_batch[bt]:.4f} ms "
              f"per block")
    return by_batch


def chain_kernel_vs_plain(device, mode, x, timed=True):
    """3e for one material: the kernel route and the plain route over two
    blocks from the same state; then, if `timed`, the times per block."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.models import texture as tex
    from juicy_tpu_torch.models import width as wid
    from juicy_tpu_torch.runtime.plugin import Chain

    b, n = x.shape[0], BLOCK
    chain = Chain(chain_stages(mode), SR, CHANNELS, n)
    st0 = chain.init_state((b,), device)
    clips = x[..., :2 * n]
    out_k, dsp_k, fin_k, acc_k, fit_k = ck._run_cuda(chain, st0, clips, True)
    out_p, dsp_p, fin_p, acc_p, fit_p = ck._run_plain(chain, st0, clips, True)
    tag = f"chain {MATERIALS[mode]}"
    db = residual_dbfs(out_k, out_p)
    if db > -120.0:
        raise AssertionError(f"{tag}: kernel vs plain {db:.1f} dBFS")
    for s, (dk, dp) in enumerate(zip(dsp_k, dsp_p, strict=True)):
        if set(dk) != set(dp):
            raise AssertionError(f"{tag}: stage {s} state keys differ")
        for key, v in dp.items():
            if dk[key].dtype != v.dtype or not torch.equal(dk[key], v):
                raise AssertionError(f"{tag}: stage {s} state {key} differs")
    # fin row 4 = the lanes' cooldowns, acc row 1 = their onset counts
    if not torch.equal(fin_k[:, :, 4], fin_p[:, :, 4]):
        raise AssertionError(f"{tag}: lane cooldowns differ")
    if not torch.equal(acc_k[:, :, 1], acc_p[:, :, 1]):
        raise AssertionError(f"{tag}: onset counts differ")
    an0 = [st["analyzer"] for st in st0]
    an_k, m_k = ck.finalize_stream(chain, an0, fin_k, acc_k, fit_k)
    an_p, m_p = ck.finalize_stream(chain, an0, fin_p, acc_p, fit_p)
    worst = 0.0
    for s, (mk, mp) in enumerate(zip(m_k, m_p, strict=True)):
        for key, v in mp.items():
            rel = float(((mk[key].double() - v.double()).abs()
                         / v.double().abs().clamp(min=1.0)).max())
            worst = max(worst, rel)
            if rel > 1e-5:
                raise AssertionError(f"{tag}: stage {CHAIN[s][0]} metric "
                                     f"{key} off by {rel:.3g} of its scale")
        for key, v in an_p[s].items():
            if not torch.equal(an_k[s][key], v):
                raise AssertionError(f"{tag}: analyzer {s} state {key} "
                                     f"differs")
    onsets = acc_k[:, :, 1].sum(dim=-1)                 # [2 blocks, 14 lanes]
    rolled = float((dsp_k[3]["rng"] != st0[3]["dsp"]["rng"]).float().mean())
    print(f"{tag} 2 blocks at B={b}: audio {db:.1f} dBFS, every state leaf "
          f"bit-equal, lane onsets per block {onsets.int().tolist()}, motion "
          f"rng rolled in {rolled:.1%} of clips, metrics within {worst:.3g}")
    if rolled < 0.9:
        raise AssertionError(f"{tag}: motion rolled the LCG in only "
                             f"{rolled:.1%} of clips")
    if not timed:
        return {"max_abs_err": max_diff(out_k, out_p)}

    blk = x[..., :n]
    ms, layout_ms = chain_kernel_ms(chain, st0, blk)
    step_ms = cuda_ms(lambda: ck.chain_kernel_step(chain, st0, blk), 5)
    plain_ms = cuda_ms(lambda: ck.chain_kernel_step_plain(chain, st0, blk), 1)
    params = [p.full_params(pr) for p, pr in zip(chain.plugins, chain.params)]
    tex_delay = float(tex.material_consts(mode, tex.common_consts(
        params[2], SR, mode)[1], SR, tex.waveguide_size(SR))["delay_samp"]) \
        if mode in tex.WAVE_MODES else 0.0
    haas_delay = int(wid.delay_samples(params[4]["haasMs"], SR))
    bound_ms, bound_by = chain_bound(b, CHANNELS, n, mode, tex_delay,
                                     haas_delay)
    print(f"{tag} per block at B={b}, N={n}: kernel {ms:.4f} ms alone, "
          f"{layout_ms:.4f} ms with layout, whole step {step_ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": max_diff(out_k, out_p), "ms": ms,
            "layout_ms": layout_ms, "step_ms": step_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_chain_kernel_vs_plain(device):
    """3e: the chain kernel against its plain version, gel and wood, at
    B = 4096 and on a ragged batch (its last CTA partly past B)."""
    x = make_clicks(BATCH, CHANNELS, 2 * BLOCK, device, seed=37,
                    period=2 * BLOCK)
    ragged = make_clicks(RAGGED_BATCH, CHANNELS, 2 * BLOCK, device, seed=39,
                         period=2 * BLOCK)
    res = {}
    for mode in CHAIN_MATERIALS:
        geo = chain_geometry(device, mode)
        res[MATERIALS[mode]] = {**chain_kernel_vs_plain(device, mode, x),
                                "geometry": geo}
        err = chain_kernel_vs_plain(device, mode, ragged, timed=False)
        res[MATERIALS[mode]]["max_abs_err"] = max(
            res[MATERIALS[mode]]["max_abs_err"], err["max_abs_err"])
    return res


def phase_chain_corpus(device):
    """4e: run_corpus_chain at full width, the main path."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.models import width as wid
    from juicy_tpu_torch.parallel.corpus import run_corpus_chain
    from juicy_tpu_torch.runtime.plugin import Chain

    b, n = CHAIN_CORPUS_BATCH, BLOCK
    chain = Chain(CHAIN, SR, CHANNELS, n)
    clips = make_clicks(b, CHANNELS, NUM_BLOCKS * n, device, seed=31)
    out0, ms0, _ = run_corpus_chain(chain, clips)    # warm-up
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    out, ms, agg = run_corpus_chain(chain, clips)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = chain_step().launches
    other = other_launches(chain_step())
    if launches != NUM_BLOCKS or other:
        raise AssertionError(f"chain corpus: {launches} chain-kernel "
                             f"launches (and {other} of another kernel) for "
                             f"{NUM_BLOCKS} blocks")
    if tuple(out.shape) != tuple(clips.shape) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError("chain corpus output is not finite or has the "
                             "wrong shape")
    for s, m in enumerate(ms):
        for key, v in m.items():
            if tuple(v.shape) != (b,) or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"stage {s} metric {key} is not finite "
                                     f"[B]")
        for key in ("score", "pre_score", "post_score"):
            if not bool(((m[key] >= 0) & (m[key] <= 100)).all()):
                raise AssertionError(f"stage {s} {key} outside [0, 100]")
    t = clips.shape[-1]
    print(f"run_corpus_chain B={b} T={t}: {wall:.4f} s warm, "
          f"{b * t / SR / wall:.1f} audio-s/s, mean score "
          f"{float(agg['score']['mean']):.4f}")
    same = torch.equal(out, out0) and all(
        torch.equal(m[key], m0[key]) for m, m0 in zip(ms, ms0, strict=True)
        for key in m)
    print(f"chain corpus: the timed run equals the warm-up run bit for bit: "
          f"{same}")
    if not same:
        raise AssertionError("chain corpus: two runs of the same corpus "
                             "differ")
    del out0, ms0

    haas = int(wid.delay_samples(chain.params[4]["haasMs"], SR))
    by_batch = {}
    for bt in CHAIN_TIMED_BATCHES:
        blk_t = make_clicks(bt, CHANNELS, n, device, seed=33)
        by_batch[bt] = chain_kernel_ms(
            chain, chain.init_state((bt,), device), blk_t)[0]
        bms, _ = chain_bound(bt, CHANNELS, n, 0, 0.0, haas)
        print(f"chain kernel alone at B={bt}, N={n}: {by_batch[bt]:.4f} ms "
              f"per block (bound {bms:.4f} ms)")
    blk = clips[..., :n]
    st0 = chain.init_state((b,), device)
    chain_ms, _layout_ms = chain_kernel_ms(chain, st0, blk)
    plain_ms = cuda_ms(lambda: ck.chain_kernel_step_plain(chain, st0, blk), 1)
    bound_ms, bound_by = chain_bound(b, CHANNELS, n, 0, 0.0, haas)
    print(f"chain kernel per block at B={b}, N={n}: {chain_ms:.4f} ms alone, "
          f"plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms ({bound_by})")

    t0 = time.perf_counter()
    sub = clips[:CHECK_CLIPS, :, :CHAIN_CHECK_BLOCKS * n]
    out_a, ms_a, _ = run_corpus_chain(chain, sub, use_kernel="always")
    out_n, ms_n, _ = run_corpus_chain(chain, sub, use_kernel="never")
    torch.cuda.synchronize()
    db = residual_dbfs(out_a, out_n)
    ds = max(max_diff(ma["score"], mn["score"]) for ma, mn in zip(ms_a, ms_n))
    same = torch.equal(out[:CHECK_CLIPS, :, :CHAIN_CHECK_BLOCKS * n], out_a)
    print(f"chain: always vs never on {CHECK_CLIPS} clips x "
          f"{CHAIN_CHECK_BLOCKS} blocks: audio {db:.1f} dBFS, last-block "
          f"scores {ds:.3g}; timed run equal to always there: {same} "
          f"({time.perf_counter() - t0:.1f} s)")
    if db > -100.0 or ds > 1e-3:
        raise AssertionError("chain: the kernel path disagrees with the "
                             "block-major executor")
    if not same:
        raise AssertionError("chain: the timed run's first clips differ "
                             "from the check run")
    return {"launches": launches, "wall": wall, "ms": chain_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "ms_by_batch": by_batch}


def tensors_equal(tag, got, want):
    """Two lists of tensors equal bit for bit (NaN where the other has
    NaN); raises naming the first that differs."""
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} tensors against {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or a.shape != b.shape or not bool(
                ((a == b) | (torch.isnan(a) & torch.isnan(b))).all()):
            raise AssertionError(f"{tag}: tensor {i} differs")


def bench_chain():
    """bench.py's chain (texture gel)."""
    from juicy_tpu_torch.runtime.plugin import Chain

    return Chain(CHAIN, SR, CHANNELS, BLOCK)


def traced_chain(materials):
    """bench.py's chain whose texture stage takes a material per clip."""
    from juicy_tpu_torch.runtime.plugin import Chain, Plugin

    chain = Chain(CHAIN, SR, CHANNELS, BLOCK)
    chain.plugins[2] = Plugin("texture", SR, CHANNELS,
                              BLOCK).with_traced("material")
    chain.params[2] = dict(
        {k: v for k, v in chain.params[2].items() if k != "material"},
        material=torch.as_tensor(np.asarray(materials), dtype=torch.float32))
    return chain


def raw_chain(route, chain, st0, clips, automation=None):
    """The chain kernel's raw route ("cuda" or "plain") over `clips`, sorted
    by material where the CTAs need it: [audio, every DSP state leaf, fin,
    acc, context fit] in corpus order."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.runtime.chain_fused import chain_automation

    run = ck._run_cuda if route == "cuda" else ck._run_plain
    curves = chain_automation(chain, automation, clips.shape[-1] // BLOCK)
    out, dsps, fin, acc, fit = ck._ordered(run, chain, list(st0), clips, True,
                                           None, curves)
    return [out, *[d[k] for d in dsps for k in sorted(d)], fin, acc, fit]


def kernel_launcher(chain, b, x, tables=None):
    """One chain-kernel launch on prepared buffers (block `x` [B, 2, N]);
    with per-block constant `tables`, block i's row in turn."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    device = x.device
    st0 = chain.init_state((b,), device)
    kc = ck.KernelChain(chain, st0, b, device)
    xt = x.permute(2, 1, 0).contiguous()
    out = torch.empty_like(xt)
    fin, acc, fit = (v[0] for v in ck._lane_buffers(1, b, device))
    prev = ck.lane_seed([st["analyzer"] for st in st0], b, device)
    turn = [0]

    def launch():
        if tables is not None:
            kc.consts = tables[turn[0] % len(tables)]
            turn[0] += 1
        kc.launch(xt, out, prev, fin, acc, fit)
    return kc, launch


def walls_in_turns(run, first, second):
    """Host walls of `run(tag)` (work that ends in a synchronize) for two
    tags in turns, first, second, second, first, after one warm-up each:
    {tag: [wall s, wall s]}."""
    walls = {first: [], second: []}
    for tag in (first, second):
        run(tag)
    torch.cuda.synchronize()
    for tag in (first, second, second, first):
        t0 = time.perf_counter()
        run(tag)
        torch.cuda.synchronize()
        walls[tag].append(time.perf_counter() - t0)
    return walls


def mixed_counts(mats):
    """{material: the corpus's clips of it} for per-clip materials `mats`
    (the padding of the sorted batch left out)."""
    return {m: int(c) for m, c in enumerate(np.bincount(mats, minlength=5))
            if c}


def phase_mixed_materials(device):
    """4f: per-clip texture materials. The mixed chain kernel (a material
    per CTA) and the mixed texture stage kernel against their plain
    versions at B = 100 with a material per clip at random (sorted and
    padded to runs of 32) over two blocks, audio, every state leaf and both
    lanes bit-equal; a uniform material array through each mixed kernel
    bit-equal to its static launch; then run_corpus_chain(materials=) on
    bench_mixed_materials' corpus (B = 8192, materials arange(B) % 5, 94
    blocks) and run_corpus on a texture plugin with a material per clip (B
    = 4096, 94 blocks): each path's launches, its walls beside gel's, its
    first clips against the never-path; the kernels alone at B = 4096 and
    8192 beside gel's, with their geometry and bounds."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.kernels import stage_kernels as sk
    from juicy_tpu_torch.models import texture as tex
    from juicy_tpu_torch.models import width as wid
    from juicy_tpu_torch.parallel.corpus import run_corpus, run_corpus_chain
    from juicy_tpu_torch.runtime.plugin import Chain, Plugin

    t_phase = time.perf_counter()
    n = BLOCK
    rng = np.random.default_rng(MIXED_SEED)
    mats = rng.integers(0, 5, RAGGED_BATCH)
    x = make_clicks(RAGGED_BATCH, CHANNELS, 2 * n, device, seed=43,
                    period=2 * n)
    chain = traced_chain(mats)
    st0 = chain.init_state((RAGGED_BATCH,), device)
    got = raw_chain("cuda", chain, st0, x)
    want = raw_chain("plain", chain, st0, x)
    tensors_equal("mixed chain", got, want)
    err = max_diff(got[0], want[0])
    static = Chain(chain_stages(0), SR, CHANNELS, n)
    tensors_equal("mixed chain, uniform gel",
                  raw_chain("cuda", traced_chain(np.zeros(RAGGED_BATCH)),
                            st0, x),
                  raw_chain("cuda", static, st0, x))
    print(f"mixed chain kernel 2 blocks at B={RAGGED_BATCH} (materials "
          f"{np.bincount(mats, minlength=5).tolist()} of gel..flesh, sorted "
          f"into runs of 32): audio, every state leaf and both lanes "
          f"bit-equal to the plain version; a uniform gel array bit-equal "
          f"to the static launch")

    mode = torch.from_numpy(mats)
    order = sk.MaterialOrder(mode)
    plug = Plugin("texture", SR, CHANNELS, n).with_traced("material")
    params = plug.full_params(dict(plug.default_params(),
                                   material=order.mode.float()))
    xs = order.clips(x)
    raws = {}
    for route in ("cuda", "plain"):
        st = plug.init_state((len(order.take),), device)
        dsp = sk.texture_kernel_state(st["dsp"], order.mode)
        lane0 = sk.pack_lane(st["analyzer"], len(order.take))
        fn = getattr(sk, f"_tex_lanes_{route}")
        res = []
        for k in range(2):
            out, dsp, *lanes = fn(xs[..., k * n:(k + 1) * n], dsp, lane0,
                                  params, SR, order.mode)
            res += [out, *[dsp[key] for key in sorted(dsp)], *lanes]
            lane0 = lanes[2]
        raws[route] = res
    tensors_equal("mixed texture", raws["cuda"], raws["plain"])
    tex_err = max_diff(raws["cuda"][0], raws["plain"][0])
    gel = Plugin("texture", SR, CHANNELS, n).with_static(material=0)
    p_gel = gel.full_params(gel.default_params())
    st = gel.init_state((RAGGED_BATCH,), device)
    uni = torch.zeros(RAGGED_BATCH, dtype=torch.int64)
    outs = []
    for mode_, p_ in ((uni, dict(p_gel, material=uni.float())), (0, p_gel)):
        bufs = sk.tex_cuda_buffers(x[..., :n], sk.texture_kernel_state(
            st["dsp"], mode_), sk.pack_lane(st["analyzer"], RAGGED_BATCH),
            mode_)
        sk.tex_cuda_launch(bufs, p_, SR, mode_)
        outs.append([bufs[k] for k in ("out", "dsp_out", "mat_out", "rng_out",
                                       "pre_fin", "pre_acc", "post_fin",
                                       "post_acc")])
    tensors_equal("mixed texture, uniform gel", *outs)
    print(f"mixed texture kernel 2 blocks at B={RAGGED_BATCH}: audio, every "
          f"state leaf and both lanes bit-equal to the plain version; a "
          f"uniform gel array bit-equal to the static launch")

    # the chain on bench_mixed_materials' corpus: the main path's mixed form
    b = MIXED_BATCH
    mats = np.arange(b) % 5
    clips = make_clicks(b, CHANNELS, NUM_BLOCKS * n, device, seed=31)
    run_corpus_chain(bench_chain(), clips, materials=mats)      # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out, ms, agg = run_corpus_chain(bench_chain(), clips, materials=mats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, other = chain_step().launches, other_launches(chain_step())
    if launches != NUM_BLOCKS or other:
        raise AssertionError(f"mixed chain corpus: {launches} chain-kernel "
                             f"launches (and {other} of another kernel) for "
                             f"{NUM_BLOCKS} blocks")
    check_corpus_outputs(out, clips, ms[-1])
    kws = {"gel": {}, "mixed": {"materials": mats}}
    walls = walls_in_turns(lambda tag: run_corpus_chain(
        bench_chain(), clips, return_audio=False, **kws[tag]), "gel", "mixed")
    ratio = sum(walls["mixed"]) / sum(walls["gel"])
    print(f"run_corpus_chain B={b}, materials arange(B) % 5: {wall:.4f} s "
          f"warm with audio ({b * clips.shape[-1] / SR / wall:.1f} "
          f"audio-s/s), {NUM_BLOCKS} launches; scoring only (return_audio="
          f"False) in turns gel, mixed, mixed, gel: mixed {walls['mixed']} s"
          f", gel {walls['gel']} s: {ratio:.4f}x (JAX's bar 1.3x)")
    t0 = time.perf_counter()
    depth = MIXED_CHECK_BLOCKS * n
    sub = clips[:CHECK_CLIPS, :, :depth]
    out_a, ms_a, _ = run_corpus_chain(bench_chain(), sub, use_kernel="always",
                                      materials=mats[:CHECK_CLIPS])
    out_n, ms_n, _ = run_corpus_chain(bench_chain(), sub, use_kernel="never",
                                      materials=mats[:CHECK_CLIPS])
    db = residual_dbfs(out_a, out_n)
    ds = max_diff(ms_a[-1]["score"], ms_n[-1]["score"])
    same = torch.equal(out[:CHECK_CLIPS, :, :depth], out_a)
    print(f"mixed chain: always vs never on {CHECK_CLIPS} clips x "
          f"{MIXED_CHECK_BLOCKS} blocks: audio {db:.1f} dBFS, last-block "
          f"scores {ds:.3g}; the corpus run's first clips equal: {same} "
          f"({time.perf_counter() - t0:.1f} s)")
    if db > -100.0 or ds > 1e-3 or not same:
        raise AssertionError("mixed chain corpus disagrees with the "
                             "executor or with itself")
    del out, clips
    # the per-clip constant rows the mixed corpus builds once: a ParamRows
    # of the sorted chain's params and its table on the card
    order = sk.MaterialOrder(torch.from_numpy(mats))
    sorted_chain = traced_chain(order.mode.numpy())
    rows_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        ck.ParamRows(sorted_chain, sorted_chain.params,
                     len(order.take)).table(device)
        torch.cuda.synchronize()
        rows_s.append(time.perf_counter() - t0)
    print(f"the mixed corpus's per-clip constant rows ({len(order.take)} "
          f"clips, ParamRows and its table on the card) built in {rows_s} s")

    # the kernels alone: mixed against gel's static launch, in turns
    haas = int(wid.delay_samples(bench_chain().params[4]["haasMs"], SR))
    p_wood = Plugin("texture", SR, CHANNELS, n).with_static(material=2)
    wood_delay = float(tex.material_consts(2, tex.common_consts(
        p_wood.full_params(p_wood.default_params()), SR, 2)[1], SR,
        tex.waveguide_size(SR))["delay_samp"])
    p_plastic = Plugin("texture", SR, CHANNELS, n).with_static(material=3)
    plastic_delay = float(tex.material_consts(3, tex.common_consts(
        p_plastic.full_params(p_plastic.default_params()), SR, 3)[1], SR,
        tex.waveguide_size(SR))["delay_samp"])
    delays = {2: wood_delay, 3: plastic_delay}
    chain_by, tex_by = {}, {}
    for bt in STAGE_TIMED_BATCHES:
        order = sk.MaterialOrder(torch.from_numpy(np.arange(bt) % 5))
        xb = make_clicks(bt, CHANNELS, n, device, seed=33)
        _kc, mixed = kernel_launcher(traced_chain(order.mode.numpy()),
                                     len(order.take), order.clips(xb))
        _kc, gel_l = kernel_launcher(Chain(CHAIN, SR, CHANNELS, n), bt, xb)
        t_gel, t_mix = [], []
        for _ in range(2):
            t_gel.append(kernel_ms(gel_l, 10))
            t_mix.append(kernel_ms(mixed, 10))
        counts = mixed_counts(np.arange(bt) % 5)
        bms, bby = mixed_bound(lambda nb, m: chain_work(
            nb, CHANNELS, n, m, delays.get(m, 0.0), haas), counts)
        chain_by[bt] = {"ms": min(t_mix), "gel_ms": min(t_gel),
                        "ratio": min(t_mix) / min(t_gel), "bound_ms": bms,
                        "bound_by": bby, "clips_run": len(order.take)}
        print(f"mixed chain kernel alone at B={bt} ({len(order.take)} clips "
              f"with the padding): {min(t_mix):.4f} ms per block, gel's "
              f"{min(t_gel):.4f} ms in turns, {min(t_mix) / min(t_gel):.3f}x; "
              f"bound {bms:.4f} ms ({bby})")
        xt = make_batch(bt, CHANNELS, n, device, seed=41)

        def tex_launch(mode_, bb, xx):
            pl = Plugin("texture", SR, CHANNELS, n)
            pp = pl.full_params(pl.default_params())
            pp = dict(pp, material=mode_.float()) if not isinstance(
                mode_, int) else dict(pp, material=mode_)
            st_ = pl.init_state((bb,), device)
            bufs = sk.tex_cuda_buffers(
                xx, sk.texture_kernel_state(st_["dsp"], mode_),
                sk.pack_lane(st_["analyzer"], bb), mode_)
            return lambda: sk.tex_cuda_launch(bufs, pp, SR, mode_)
        tm_l = tex_launch(order.mode, len(order.take), order.clips(xt))
        tg_l = tex_launch(0, bt, xt)
        t_gel, t_mix = [], []
        for _ in range(2):
            t_gel.append(kernel_ms(tg_l, 20))
            t_mix.append(kernel_ms(tm_l, 20))
        bms, bby = mixed_bound(lambda nb, m: texture_work(
            nb, CHANNELS, n, m, delays.get(m, 0.0)), counts)
        tex_by[bt] = {"ms": min(t_mix), "gel_ms": min(t_gel),
                      "ratio": min(t_mix) / min(t_gel), "bound_ms": bms,
                      "bound_by": bby, "clips_run": len(order.take)}
        print(f"mixed texture kernel alone at B={bt}: {min(t_mix):.4f} ms "
              f"per block, gel's {min(t_gel):.4f} ms in turns, "
              f"{min(t_mix) / min(t_gel):.3f}x; bound {bms:.4f} ms ({bby})")
    chain_geo = show_geometry("mixed chain kernel",
                              ck.chain_mixed_geometry(n, device),
                              "chain_kernel_mixed")
    tex_geo = show_geometry("mixed texture kernel (all five materials)",
                            sk.texture_mixed_geometry(range(5), n, 2, device),
                            "texture_stage_mixedILi2E")

    # texture corpus scoring with a material per clip: the mixed stage kernel
    tb = BATCH
    tmats = np.arange(tb) % 5
    tclips = make_batch(tb, CHANNELS, NUM_BLOCKS * n, device, seed=17)
    tplug = Plugin("texture", SR, CHANNELS, n).with_traced("material")
    tparams = dict(tplug.default_params(),
                   material=torch.as_tensor(tmats, dtype=torch.float32))
    run_corpus(tplug, tparams, tclips)                            # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    tout, tlast, _tagg = run_corpus(tplug, tparams, tclips)
    torch.cuda.synchronize()
    twall = time.perf_counter() - t0
    tlaunches = stage_steps()["texture"].launches
    other = other_launches(stage_steps()["texture"])
    if tlaunches != NUM_BLOCKS or other:
        raise AssertionError(f"mixed texture corpus: {tlaunches} launches "
                             f"(and {other} of another kernel)")
    check_corpus_outputs(tout, tclips, tlast)
    t0 = time.perf_counter()
    depth = MIXED_TEX_CHECK_BLOCKS * n
    sub = tclips[:CHECK_CLIPS, :, :depth]
    sub_p = dict(tparams, material=tparams["material"][:CHECK_CLIPS])
    out_n, last_n, _ = run_corpus(tplug, sub_p, sub, use_kernel="never")
    out_k, last_k, _ = run_corpus(tplug, sub_p, sub, use_kernel="always")
    db = residual_dbfs(out_k, out_n)
    ds = max_diff(last_k["score"], last_n["score"])
    same = torch.equal(tout[:CHECK_CLIPS, :, :depth], out_k)
    print(f"run_corpus texture B={tb}, materials arange(B) % 5: {twall:.4f} s "
          f"warm ({tb * tclips.shape[-1] / SR / twall:.1f} audio-s/s), "
          f"{tlaunches} launches; always vs never on {CHECK_CLIPS} clips x "
          f"{MIXED_TEX_CHECK_BLOCKS} blocks: audio {db:.1f} dBFS, scores "
          f"{ds:.3g}, the corpus run's first clips equal: {same} "
          f"({time.perf_counter() - t0:.1f} s)")
    if db > -100.0 or ds > 1e-3 or not same:
        raise AssertionError("mixed texture corpus disagrees with "
                             "batched_run or with itself")
    print(f"phase 4f: {time.perf_counter() - t_phase:.1f} s")
    return {
        "chain": {"launches": launches, "corpus_wall_s": wall,
                  "scoring_walls_s": walls["mixed"],
                  "gel_scoring_walls_s": walls["gel"],
                  "corpus_ratio": ratio, "rows_build_s": rows_s,
                  "max_abs_err": err, "ms_by_batch": chain_by,
                  "geometry": chain_geo},
        "texture": {"launches": tlaunches, "corpus_wall_s": twall,
                    "max_abs_err": tex_err, "ms_by_batch": tex_by,
                    "geometry": tex_geo},
    }


def phase_automation(device):
    """4g: per-block automation. On the chain kernel (a constant row per
    block): the automated stream against its plain version at B = 100 over
    three blocks (audio, every state leaf, both lanes bit-equal), then
    run_corpus_chain(automation=) at full width (B = 8192, 94 blocks): its
    launches, its first clips against the never-path, its wall and the
    unautomated one's in turns, with the host work automation adds (the
    table build, the finalize with per-block params); the automated launch
    alone (each block's row in turn) beside the unautomated one, in turns.
    On a stage kernel: run_corpus(punch, automation=) at B = 4096 (each
    launch takes its block's constants), its launches, its first clips
    against the never-path, its wall and the unautomated one's in turns."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.parallel.corpus import run_corpus, run_corpus_chain
    from juicy_tpu_torch.runtime.chain_fused import chain_automation
    from juicy_tpu_torch.runtime.plugin import Plugin
    from juicy_tpu_torch.runtime.stream import automation_curve

    t_phase = time.perf_counter()
    n = BLOCK
    x = make_clicks(RAGGED_BATCH, CHANNELS, 3 * n, device, seed=47,
                    period=2 * n)
    chain = bench_chain()
    st0 = chain.init_state((RAGGED_BATCH,), device)
    auto3 = {s: {k: automation_curve(v, 3) for k, v in c.items()}
             for s, c in AUTOMATION.items()}
    got = raw_chain("cuda", chain, st0, x, auto3)
    want = raw_chain("plain", chain, st0, x, auto3)
    tensors_equal("automated chain", got, want)
    flat = raw_chain("cuda", chain, st0, x)
    if torch.equal(got[0], flat[0]):
        raise AssertionError("automation did not change the render")
    print(f"automated chain kernel 3 blocks at B={RAGGED_BATCH}: audio, "
          f"every state leaf and both lanes bit-equal to the plain version")

    b = CHAIN_CORPUS_BATCH
    auto = {s: {k: automation_curve(v, NUM_BLOCKS) for k, v in c.items()}
            for s, c in AUTOMATION.items()}
    clips = make_clicks(b, CHANNELS, NUM_BLOCKS * n, device, seed=31)
    run_corpus_chain(chain, clips, automation=auto)               # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out, ms, agg = run_corpus_chain(chain, clips, automation=auto)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, other = chain_step().launches, other_launches(chain_step())
    if launches != NUM_BLOCKS or other:
        raise AssertionError(f"automated chain corpus: {launches} launches "
                             f"(and {other} of another kernel)")
    check_corpus_outputs(out, clips, ms[-1])
    kws = {"flat": {}, "automated": {"automation": auto}}
    walls = walls_in_turns(lambda tag: run_corpus_chain(chain, clips,
                                                        **kws[tag]),
                           "flat", "automated")
    print(f"run_corpus_chain B={b} with {sum(map(len, AUTOMATION.values()))} "
          f"params automated: {wall:.4f} s warm "
          f"({b * clips.shape[-1] / SR / wall:.1f} audio-s/s), {launches} "
          f"launches; in turns flat, automated, automated, flat: automated "
          f"{walls['automated']} s, unautomated {walls['flat']} s")
    # the host work automation adds to the corpus: the curves' table, and
    # the finalize with each automated param a [nb, 1] column
    curves = chain_automation(chain, auto, NUM_BLOCKS)
    st = chain.init_state((b,), device)
    _o, _d, fin, acc, fit = ck._run_cuda(chain, st, clips, False)
    an0 = [s_["analyzer"] for s_ in st]
    fin_params = {"flat": None,
                  "automated": ck._automated_params(chain, None, curves,
                                                    device)}
    fin_walls = walls_in_turns(lambda tag: ck.finalize_stream(
        chain, an0, fin, acc, fit, fin_params[tag]), "flat", "automated")
    del _o, _d, fin, acc, fit
    t0 = time.perf_counter()
    depth = AUTO_CHECK_BLOCKS * n
    sub = clips[:CHECK_CLIPS, :, :depth]
    auto_d = {s: {k: v[:AUTO_CHECK_BLOCKS] for k, v in c.items()}
              for s, c in auto.items()}
    out_a, ms_a, _ = run_corpus_chain(chain, sub, use_kernel="always",
                                      automation=auto_d)
    out_n, ms_n, _ = run_corpus_chain(chain, sub, use_kernel="never",
                                      automation=auto_d)
    db = residual_dbfs(out_a, out_n)
    ds = max_diff(ms_a[-1]["score"], ms_n[-1]["score"])
    same = torch.equal(out[:CHECK_CLIPS, :, :depth], out_a)
    print(f"automated chain: always vs never on {CHECK_CLIPS} clips x "
          f"{AUTO_CHECK_BLOCKS} blocks: audio {db:.1f} dBFS, scores {ds:.3g}"
          f"; the corpus run's first clips equal: {same} "
          f"({time.perf_counter() - t0:.1f} s)")
    if db > -100.0 or ds > 1e-3 or not same:
        raise AssertionError("automated chain corpus disagrees with the "
                             "executor or with itself")
    del out, clips

    xb = make_clicks(b, CHANNELS, n, device, seed=33)
    kc, flat_l = kernel_launcher(chain, b, xb)
    t0 = time.perf_counter()
    tables = ck.block_tables(kc, chain, chain_automation(chain, auto,
                                                         NUM_BLOCKS),
                             NUM_BLOCKS)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    _kc, auto_l = kernel_launcher(chain, b, xb, tables)
    t_flat, t_auto = [], []
    for _ in range(2):
        t_flat.append(kernel_ms(flat_l, 20))
        t_auto.append(kernel_ms(auto_l, 20))
    print(f"automated chain kernel alone at B={b}: {min(t_auto):.4f} ms per "
          f"block (a row per block), unautomated {min(t_flat):.4f} ms in "
          f"turns; the [{NUM_BLOCKS}, {ck.N_CONSTS}] table built in "
          f"{table_s:.4f} s; finalize_stream over the corpus in turns: "
          f"automated {fin_walls['automated']} s, unautomated "
          f"{fin_walls['flat']} s")
    del xb, kc, _kc, tables

    # a stage kernel with automation: punch, BASELINE.json config #3
    punch = Plugin("punch", SR, CHANNELS, n)
    p_params = punch.preset(PUNCH_PRESET)
    p_auto = {k: automation_curve(v, NUM_BLOCKS)
              for k, v in PUNCH_AUTOMATION.items()}
    p_clips = make_clicks(BATCH, CHANNELS, NUM_BLOCKS * n, device, seed=23)
    p_launches, p_wall = corpus_run("punch automated", punch, p_params,
                                    p_clips, stage_steps()["punch"], p_auto)
    kws = {"flat": {}, "automated": {"automation": p_auto}}
    p_walls = walls_in_turns(lambda tag: run_corpus(punch, p_params, p_clips,
                                                    **kws[tag]),
                             "flat", "automated")
    print(f"run_corpus punch B={BATCH} with {len(PUNCH_AUTOMATION)} params "
          f"automated, in turns flat, automated, automated, flat: automated "
          f"{p_walls['automated']} s, unautomated {p_walls['flat']} s")
    print(f"phase 4g: {time.perf_counter() - t_phase:.1f} s")
    return {"chain": {
        "launches": launches, "corpus_wall_s": wall,
        "corpus_walls_s": walls["automated"],
        "unautomated_walls_s": walls["flat"], "ms": min(t_auto),
        "unautomated_ms": min(t_flat), "table_build_s": table_s,
        "finalize_walls_s": fin_walls["automated"],
        "unautomated_finalize_walls_s": fin_walls["flat"],
        "max_abs_err": max_diff(got[0], want[0])},
        "punch": {"launches": p_launches, "corpus_wall_s": p_wall,
                  "corpus_walls_s": p_walls["automated"],
                  "unautomated_walls_s": p_walls["flat"]}}


#: f32 operations of one step of the finalize's EMA pair (csrc/finalize.cu
#: ema_step: two subtracts, two adds and two multiplies for the EMAs, a
#: divide, three multiplies and two adds for the instant fatigue, three
#: clamps of two extrema each)
EMA_OPS = 18


def ema_bound(b, nb):
    """ema_scan: the three inputs [nb, 14, B] read and the two outputs
    written once, the two EMA states [7, B] in and out."""
    nbytes = 4 * (5 * nb * 14 * b + 4 * 7 * b)
    return bound(nbytes, EMA_OPS * nb * 14 * b)


def phase_ema_scan(device):
    """4h: the finalize's EMA kernel (ema_scan, csrc/finalize.cu) on the
    main path's inputs."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.parallel.corpus import run_corpus_chain

    t_phase = time.perf_counter()
    b = CHAIN_CORPUS_BATCH
    chain = bench_chain()
    clips = make_clicks(b, CHANNELS, NUM_BLOCKS * BLOCK, device, seed=31)
    run_corpus_chain(chain, clips, metrics="final")     # warm-up
    torch.cuda.synchronize()
    ck.ema_scan.launches = 0
    run_corpus_chain(chain, clips, metrics="final")
    torch.cuda.synchronize()
    corpus_launches = ck.ema_scan.launches
    if corpus_launches != 1:
        raise AssertionError(f"ema_scan: {corpus_launches} launches in one "
                             f"run_corpus_chain call")
    st = chain.init_state((b,), device)
    an0 = [s["analyzer"] for s in st]
    _o, _d, fin, acc, fit = ck._run_cuda(chain, st, clips, False)
    del clips, _o, _d
    _mets, ema_in = ck._lane_formulas(chain, fin, acc)
    inputs = [ema_in[k].contiguous() for k in ck.EMA_INPUTS]
    del _mets, ema_in
    rep, fat = (torch.stack([torch.broadcast_to(a[k], (b,)) for a in an0])
                for k in ("repetition_ema", "fatigue_ema"))
    got = ck.ema_scan(rep, fat, *inputs)
    want = ck.ema_scan_plain(rep, fat, *inputs)
    torch.cuda.synchronize()
    tensors_equal(f"ema_scan B={b} nb={NUM_BLOCKS}", got, want)
    # a ragged batch, a NaN and an inf among the inputs, a NaN in the state
    rb = RAGGED_BATCH
    r_in = [v[..., :rb].clone() for v in inputs]
    r_in[0][NUM_BLOCKS // 2, 3, 7] = float("inf")
    r_in[1][NUM_BLOCKS - 1, 10, rb - 1] = float("nan")
    r_rep, r_fat = rep[:, :rb].clone(), fat[:, :rb].clone()
    r_fat[2, 0] = float("nan")
    r_got = ck.ema_scan(r_rep, r_fat, *r_in)
    tensors_equal(f"ema_scan B={rb} with NaN and inf", r_got,
                  ck.ema_scan_plain(r_rep, r_fat, *r_in))
    print(f"ema_scan: bit-equal to its plain walk at B={b}, nb={NUM_BLOCKS} "
          f"(the chain's lanes) and at B={rb} with NaN and inf; one launch "
          f"per run_corpus_chain call")

    def launch():
        ck.ema_scan(rep, fat, *inputs)

    ms = min(kernel_ms(launch, 50) for _ in range(3))
    plain_ms = cuda_ms(lambda: ck.ema_scan_plain(rep, fat, *inputs), 3)
    fin_ms = cuda_ms(lambda: ck.finalize_stream(chain, an0, fin, acc, fit), 3)
    bound_ms, bound_by = ema_bound(b, NUM_BLOCKS)
    print(f"ema_scan alone at B={b}, nb={NUM_BLOCKS}: {ms:.4f} ms "
          f"(bound {bound_ms:.4f} ms, {bound_by}: {100 * bound_ms / ms:.1f}%)"
          f"; plain walk {plain_ms:.2f} ms; finalize_stream whole "
          f"{fin_ms:.2f} ms")
    print(f"phase 4h: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": corpus_launches, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "finalize_stream_ms": fin_ms,
            "max_abs_err": max_diff(got[0], want[0])}


def phase_texture_corpus(device):
    """gel, metal and wood at full width; each run read on its own."""
    from juicy_tpu_torch.kernels import stage_kernels as sk
    from juicy_tpu_torch.runtime.plugin import Plugin

    clips = make_batch(BATCH, CHANNELS, NUM_BLOCKS * BLOCK, device, seed=17)
    launches = {}
    for mode in CORPUS_MATERIALS:
        plugin = Plugin("texture", SR, CHANNELS, BLOCK).with_static(material=mode)
        launches[MATERIALS[mode]] = corpus_run(
            f"texture {MATERIALS[mode]}", plugin, plugin.default_params(),
            clips, sk.texture_stage_step)[0]
    return launches


def analyzer_bound(b, c, n):
    """analyze_fused per block: audio in, lane in, fin and acc out."""
    return bound(4 * (b * c * n + 20 * b), b * n * LANE_OPS)


def check_all(tag, got, want, tol):
    """Every leaf of two dicts of tensors within `tol` (0: bit-equal)."""
    worst = 0.0
    for key, v in want.items():
        d = max_diff(got[key], v)
        worst = max(worst, d)
        if d > tol:
            raise AssertionError(f"{tag}: {key} off by {d}")
    return worst


#: 3f's (batch, channels): the main width and twice it, mono and stereo,
#: and a ragged batch
ANALYZER_CASES = ((BATCH, 2), (CHAIN_CORPUS_BATCH, 2), (BATCH, 1),
                  (CHAIN_CORPUS_BATCH, 1), (RAGGED_BATCH, 2),
                  (RAGGED_BATCH, 1))


def analyzer_vs_plain(device, b, c):
    """analyze_fused on two blocks of the burst input [b, c, 2N], counted
    (one launch per block and no other kernel); the lanes (fin, acc)
    bit-equal to the plain version's, the cooldowns equal, the metrics
    within 1e-5. Returns (launches, the worst metric difference)."""
    from juicy_tpu_torch.analyzer import analyzer_init
    from juicy_tpu_torch.kernels import analyzer_kernel as ak
    from juicy_tpu_torch.kernels import stage_kernels as sk

    n = BLOCK
    x = make_clicks(b, c, 2 * n, device, seed=43, period=2 * n)
    lane_k = sk._lane_consts(SR)
    step = entry_steps()["analyzer"]
    reset_launches()
    st, runs = analyzer_init((b,), device), []
    for i in range(2):
        runs.append((st, ak.analyze_fused(st, x[..., i * n:(i + 1) * n], SR)))
        st = runs[-1][1][0]
    torch.cuda.synchronize()
    launches = step.launches
    if launches != 2 or other_launches(step):
        raise AssertionError(f"analyze_fused B={b} C={c}: {launches} "
                             f"launches (and {other_launches(step)} of "
                             f"another kernel) for 2 blocks")
    worst = 0.0
    for i, (st_in, (st_k, m_k)) in enumerate(runs):
        blk = x[..., i * n:(i + 1) * n]
        lane0 = sk.pack_lane(st_in, b)
        raw_k = ak._analyzer_lanes_cuda(blk, lane0, lane_k)
        raw_p = ak._analyzer_lanes_plain(blk, lane0, lane_k)
        if not all(torch.equal(a, p) for a, p in zip(raw_k, raw_p)):
            raise AssertionError(f"analyze_fused B={b} C={c} block {i}: "
                                 f"fin/acc differ")
        st_p, m_p = ak.analyze_fused_plain(st_in, blk, SR)
        if not torch.equal(st_k["onset_cooldown"], st_p["onset_cooldown"]):
            raise AssertionError(f"analyze_fused B={b} C={c} block {i}: "
                                 f"cooldowns differ")
        worst = max(worst, check_all(f"analyze_fused B={b} C={c} block {i}",
                                     m_k, m_p, 1e-5))
    print(f"analyze_fused B={b} C={c}: 2 blocks, 2 launches and no other; "
          f"fin/acc bit-equal to the plain version, onsets "
          f"{int(raw_k[1][1].sum())} in block 1, cooldowns equal, metrics "
          f"within {worst:.3g}")
    return launches, worst


def phase_analyze_fused(device):
    """3f: analyze_fused (csrc/analyzer.cu) against its plain version at
    ANALYZER_CASES, each counted; the kernel's geometry; its time per
    block alone and through the wrapper (the block in its own layout), at
    B = 4096 and 8192, mono and stereo; the whole step's and the plain
    version's at B = 4096 stereo."""
    from juicy_tpu_torch.analyzer import analyzer_init
    from juicy_tpu_torch.kernels import analyzer_kernel as ak
    from juicy_tpu_torch.kernels import stage_kernels as sk

    worst, launches = 0.0, None
    for b, c in ANALYZER_CASES:
        got, w = analyzer_vs_plain(device, b, c)
        worst = max(worst, w)
        if launches is None:
            launches = got
    print("analyze_fused: the stage and chain kernels, which share lane.cuh "
          "and pipe.cuh with it, were held bit-equal to their plain versions "
          "in 3-3e above")
    geo = {c: show_geometry(f"analyzer kernel (C={c})",
                            ak.analyzer_geometry(BLOCK, c, device),
                            f"analyzer_kernelILi{c}E") for c in (2, 1)}
    n, lane_k = BLOCK, sk._lane_consts(SR)
    times = {}
    for b in STAGE_TIMED_BATCHES:
        for c in (2, 1):
            blk = make_clicks(b, c, n, device, seed=45)
            lane0 = sk.pack_lane(analyzer_init((b,), device), b)
            fin = torch.empty((5, b), device=device)
            acc = torch.empty((10, b), device=device)
            ms = kernel_ms(lambda: ak.analyzer_launch(blk, lane0, fin, acc,
                                                      lane_k), 50)
            layout_ms = kernel_ms(
                lambda: ak._analyzer_lanes_cuda(blk, lane0, lane_k), 50)
            bound_ms, bound_by = analyzer_bound(b, c, n)
            times[(b, c)] = (ms, layout_ms, bound_ms, bound_by)
            print(f"analyze_fused kernel per block at B={b}, C={c}, N={n}: "
                  f"{ms:.4f} ms alone, {layout_ms:.4f} ms through the "
                  f"wrapper (the block as given); bound {bound_ms:.4f} ms "
                  f"({bound_by}), {bound_ms / ms:.1%} of it")
    b = BATCH
    blk = make_clicks(b, CHANNELS, n, device, seed=45)
    st0 = analyzer_init((b,), device)
    lane0 = sk.pack_lane(st0, b)
    step_ms = cuda_ms(lambda: ak.analyze_fused(st0, blk, SR), 20)
    plain_ms = cuda_ms(lambda: ak._analyzer_lanes_plain(blk, lane0, lane_k), 1)
    ms, layout_ms, bound_ms, bound_by = times[(b, CHANNELS)]
    print(f"analyze_fused per block at B={b}, N={n}: kernel {ms:.4f} ms "
          f"alone, {layout_ms:.4f} ms with the layout, whole step "
          f"{step_ms:.4f} ms (finalize_lane's launches included), plain "
          f"{plain_ms:.2f} ms; bound {bound_ms:.4f} ms ({bound_by})")
    return {"launches": launches, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "layout_ms": layout_ms, "step_ms": step_ms,
            "ms_by_batch": {f"{bb}x{cc}": t[0] for (bb, cc), t in
                            times.items()},
            "geometry": geo[CHANNELS]}


def phase_saturator_step_fused(device, plugin, params):
    """3g: saturator_step_fused, two blocks at B = 4096, N = 512, counted
    (one launch of csrc/saturator_stage.cu each, under its own count); then
    bit for bit against its plain version and against saturator_stage_step;
    the times per block."""
    from juicy_tpu_torch.kernels import saturator_kernel as satk
    from juicy_tpu_torch.kernels import stage_kernels as sk

    b, n = BATCH, BLOCK
    x = make_batch(b, CHANNELS, 2 * n, device, seed=53)
    step = entry_steps()["saturator_step_fused"]
    st0 = plugin.init_state((b,), device)
    reset_launches()
    st, runs = st0, []
    for i in range(2):
        runs.append((st, satk.saturator_step_fused(
            plugin, params, st, x[..., i * n:(i + 1) * n])))
        st = runs[-1][1][1]
    torch.cuda.synchronize()
    launches = step.launches
    if launches != 2 or other_launches(step):
        raise AssertionError(f"saturator_step_fused: {launches} launches (and "
                             f"{other_launches(step)} of another kernel) "
                             f"for 2 blocks")
    p = plugin.full_params(params)
    for i, (st_in, (out_k, st_k, m_k)) in enumerate(runs):
        blk = x[..., i * n:(i + 1) * n]
        for tag, (out_o, st_o, m_o) in (
                ("plain", satk.saturator_step_fused_plain(plugin, params,
                                                          st_in, blk)),
                ("stage step", sk.saturator_stage_step(p, st_in, blk, SR))):
            if not torch.equal(out_k, out_o):
                raise AssertionError(f"saturator_step_fused block {i}: audio "
                                     f"differs from the {tag}")
            check_all(f"saturator_step_fused vs {tag}, block {i}",
                      {**st_k["analyzer"], **st_k["dsp"], **m_k},
                      {**st_o["analyzer"], **st_o["dsp"], **m_o}, 0.0)
        print(f"saturator_step_fused block {i}: audio, state and metrics "
              f"bit-equal to its plain version and to saturator_stage_step")
    blk = x[..., :n]
    lane0 = sk.pack_lane(st0["analyzer"], b)
    tone0 = st0["dsp"]["tone_state"]
    scalars = sk._sat_scalars(p, SR)
    ms = cuda_ms(lambda: satk._lanes_cuda(blk, tone0, lane0, scalars), 50)
    step_ms = cuda_ms(lambda: satk.saturator_step_fused(plugin, params, st0,
                                                        blk), 20)
    plain_ms = cuda_ms(lambda: sk._sat_lanes_plain(blk, tone0, lane0,
                                                   scalars), 1)
    bound_ms, bound_by = saturator_bound(b, CHANNELS, n)
    print(f"saturator_step_fused per block at B={b}, N={n}: kernel "
          f"{ms:.4f} ms (with layout), whole step {step_ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms; bound {bound_ms:.4f} ms ({bound_by})")
    return {"launches": launches, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "step_ms": step_ms}


def pool_states(srv, template):
    """A copy of a CUDA pool's whole state in the Chain form (cohere's
    context fit, an output of the block, left as in `template`)."""
    kc = srv._pools[0].kc.clone()
    dsps = kc.unpack(template, template[5]["dsp"]["context_fit"])
    return [{"analyzer": {k: v.clone() for k, v in st["analyzer"].items()},
             "dsp": d} for st, d in zip(srv._pools[0].states, dsps)]


def serve_ticks(srv, sids, block, ks):
    """Submit and tick for each block index in `ks`; (results, tick walls
    in ms, submit walls in ms)."""
    res, walls, subs = [], [], []
    for k in ks:
        t0 = time.perf_counter()
        srv.submit_many(sids, block(k))
        t1 = time.perf_counter()
        res.append(srv.tick_arrays())
        walls.append((time.perf_counter() - t1) * 1e3)
        subs.append((t1 - t0) * 1e3)
    return res, walls, subs


def check_launches(tag, want):
    step = chain_step()
    if step.launches != want or other_launches(step):
        raise AssertionError(f"{tag}: {step.launches} chain-kernel launches "
                             f"(and {other_launches(step)} of another "
                             f"kernel) for {want} ticks")


def pct(walls, q):
    return float(np.percentile(np.asarray(walls), q))


def phase_serve(device):
    """5: StreamServer on bench.py's chain with SERVE_SLOTS slots, all
    open, fed the burst input (PCM16 values) by submit_many."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.runtime.plugin import Chain
    from juicy_tpu_torch.runtime.serve import StreamServer

    s, n = SERVE_SLOTS, BLOCK
    chain = Chain(CHAIN, SR, CHANNELS, n)
    x = make_clicks(s, CHANNELS, SERVE_BLOCKS * n, device, seed=47)
    clips = (torch.round(x * 32768.0) / 32768.0).cpu().numpy()
    sids = np.arange(s)

    def block(k):
        k %= SERVE_BLOCKS
        return clips[..., k * n:(k + 1) * n]

    srv = StreamServer(chain, s)
    t0 = time.perf_counter()
    srv.warmup()
    warm_s = time.perf_counter() - t0
    if [srv.open_stream() for _ in range(s)] != sids.tolist():
        raise AssertionError("serve: slots opened out of order")

    reset_launches()
    base, walls8, _subs = serve_ticks(srv, sids, block, range(8))
    torch.cuda.synchronize()
    launches = chain_step().launches
    check_launches("serve", 8)
    for got_sids, audio, scores, pre in base:
        if not np.array_equal(got_sids, sids) or audio.shape != (s, 2, n) \
                or not np.isfinite(audio).all():
            raise AssertionError("serve: tick output not finite [S, 2, N]")
        if not ((scores >= 0) & (scores <= 100)).all():
            raise AssertionError("serve: scores outside [0, 100]")
    print(f"serve S={s}: warmup {warm_s:.2f} s; 8 ticks, 8 chain-kernel "
          f"launches and no other; tick walls {[round(w, 2) for w in walls8]} "
          f"ms")

    # per-slot edits on a quarter of the slots
    for sid in range(0, s, 4):
        kind = (sid // 4) % 3
        if kind == 0:
            srv.set_params(sid, "punch", punch=0.3)
        elif kind == 1:
            srv.set_params(sid, "infer", trim=-4.0)
        else:
            srv.set_params(sid, "width", haasMs=30.0)
    template = chain.init_state((s,), device)
    snap = pool_states(srv, template)
    reset_launches()
    edited, _w, _s = serve_ticks(srv, sids, block, (8, 9))
    torch.cuda.synchronize()
    edited_launches = chain_step().launches
    check_launches("serve with per-slot rows", 2)
    after = pool_states(srv, template)
    rows = srv._pools[0].param_rows()
    settings = len(rows.groups)
    out_d, _st, m_d = ck.chain_kernel_step(
        chain, snap, torch.from_numpy(block(8)).to(device), params_rows=rows)
    if not (np.array_equal(out_d.cpu().numpy(), edited[0][1]) and
            np.array_equal(m_d[-1]["score"].cpu().numpy(), edited[0][2])):
        raise AssertionError("serve: the tick differs from a direct "
                             "chain_kernel_step(params_rows=)")
    c = SERVE_CHECK_SLOTS
    sub_rows = ck.ParamRows(chain, [
        {k: torch.from_numpy(v[:c]) for k, v in stage.items()}
        for stage in srv._params], c)
    st = [{g: {k: v[:c] for k, v in grp.items()} for g, grp in stage.items()}
          for stage in snap]
    t0 = time.perf_counter()
    worst = -math.inf
    for j, k in enumerate((8, 9)):
        out_p, st, _m = ck.chain_kernel_step_plain(
            chain, st, torch.from_numpy(block(k)[:c]).to(device),
            params_rows=sub_rows)
        db = residual_dbfs(out_p.cpu(), torch.from_numpy(edited[j][1][:c]))
        worst = max(worst, db)
        if db > -120.0:
            raise AssertionError(f"serve: tick {k} vs the plain rows step "
                                 f"{db:.1f} dBFS")
    for i, (sp, sa) in enumerate(zip(st, after)):
        for g in ("analyzer", "dsp"):
            for key, v in sp[g].items():
                if key != "context_fit" and not torch.equal(sa[g][key][:c], v):
                    raise AssertionError(f"serve: stage {i} {g} {key} differs "
                                         f"from the plain rows step")
    print(f"serve with per-slot rows on {s // 4} slots ({settings} "
          f"settings): 2 ticks, 2 chain-kernel launches and no other; equal "
          f"to a direct chain_kernel_step(params_rows=) bit for bit; first "
          f"{c} slots vs the plain rows step: audio {worst:.1f} dBFS, state "
          f"bit-equal ({time.perf_counter() - t0:.1f} s)")

    # the i16 wire, the metering rail and async ticks against the first 8
    # ticks of the f32 pool (same input, no edits)
    i16, meter, asy = (StreamServer(chain, s, **kw) for kw in (
        {"wire": "i16"}, {"wire": "i16", "audio_out": False}, {}))
    for other in (i16, meter, asy):
        other.warmup()
        for _ in range(s):
            other.open_stream()
    got_i16, walls_i16, _s = serve_ticks(i16, sids, block, range(8))
    got_meter, walls_meter, _s = serve_ticks(meter, sids, block, range(8))
    pending, got_async = [], []
    for k in range(8):
        asy.submit_many(sids, block(k))
        pending.append(asy.tick_arrays_async())
        if len(pending) > 2:
            got_async.append(pending.pop(0).result())
    got_async += [h.result() for h in pending]
    lsb = 0.0
    for k in range(8):
        want = np.clip(base[k][1], -1.0, 32767.0 / 32768.0)
        if got_i16[k][1].dtype != np.int16:
            raise AssertionError("serve: the i16 wire did not return int16")
        lsb = max(lsb, float(np.abs(got_i16[k][1].astype(np.float32) / 32768.0
                                    - want).max()) * 32768.0)
        if not (np.array_equal(got_meter[k][2], base[k][2]) and
                np.array_equal(got_meter[k][3], base[k][3])
                and got_meter[k][1] is None):
            raise AssertionError("serve: the metering rail's scores differ")
        if not all(np.array_equal(a, b) for a, b in zip(got_async[k],
                                                        base[k])):
            raise AssertionError("serve: async ticks differ from sync ticks")
    if lsb > 1.01:
        raise AssertionError(f"serve: the i16 wire is {lsb:.3f} LSB from "
                             f"the f32 wire")
    print(f"serve: i16 wire within {lsb:.3f} LSB of the f32 wire; metering "
          f"rail scores equal; async ticks equal to sync ticks (8 each)")

    # times, against the block deadline (reported, not gated)
    deadline = 1e3 * n / SR
    _r, walls, subs = serve_ticks(asy, sids, block, range(SERVE_TIMED))
    _r, walls_rows, _s = serve_ticks(srv, sids, block, range(SERVE_TIMED))
    _r, walls_i16, _s = serve_ticks(i16, sids, block, range(SERVE_TIMED))
    _r, walls_meter, _s = serve_ticks(meter, sids, block, range(SERVE_TIMED))
    torch.cuda.synchronize()
    # every slot a setting of its own, then ticks that each follow one edit
    t0 = time.perf_counter()
    for sid in range(s):
        srv.set_params(sid, "infer", trim=-6.0 + 6.0 * sid / s)
    spread_s = time.perf_counter() - t0
    reset_launches()
    edits, walls_edit = [], []
    for k in range(SERVE_TIMED):
        t0 = time.perf_counter()
        srv.set_params(k, "punch", punch=0.2 + 0.01 * k)
        t1 = time.perf_counter()
        srv.submit_many(sids, block(k))
        t2 = time.perf_counter()
        srv.tick_arrays()
        walls_edit.append((time.perf_counter() - t2) * 1e3)
        edits.append((t1 - t0) * 1e3)
    torch.cuda.synchronize()
    check_launches("serve ticks after an edit", SERVE_TIMED)
    print(f"serve: {s} distinct settings set in {spread_s:.2f} s; "
          f"{SERVE_TIMED} ticks each after one edit, one launch each")
    t0 = time.perf_counter()
    pending = []
    for k in range(SERVE_TIMED):
        asy.submit_many(sids, block(k))
        pending.append(asy.tick_arrays_async())
        if len(pending) > 2:
            pending.pop(0).result()
    for h in pending:
        h.result()
    sustained = (time.perf_counter() - t0) * 1e3 / SERVE_TIMED
    timing = {
        "deadline_ms": deadline, "slots": s, "warmup_s": warm_s,
        "submit_p50_ms": pct(subs, 50),
        "tick_p50_ms": pct(walls, 50), "tick_p95_ms": pct(walls, 95),
        "rows_tick_p50_ms": pct(walls_rows, 50),
        "rows_tick_p95_ms": pct(walls_rows, 95),
        "async_sustained_ms": sustained,
        "i16_tick_p50_ms": pct(walls_i16, 50),
        "meter_tick_p50_ms": pct(walls_meter, 50),
        "edit_p50_ms": pct(edits, 50), "edit_p95_ms": pct(edits, 95),
        "edit_tick_p50_ms": pct(walls_edit, 50),
        "edit_tick_p95_ms": pct(walls_edit, 95),
        "edit_settings": s, "spread_s": spread_s,
        "launches": launches, "edited_launches": edited_launches,
        "rows_settings": settings}
    print(f"serve S={s} walls over {SERVE_TIMED} ticks (deadline "
          f"{deadline:.3f} ms): submit_many p50 {timing['submit_p50_ms']:.3f} "
          f"ms; tick_arrays p50 {timing['tick_p50_ms']:.3f} / p95 "
          f"{timing['tick_p95_ms']:.3f} ms shared, "
          f"{timing['rows_tick_p50_ms']:.3f} / "
          f"{timing['rows_tick_p95_ms']:.3f} ms with per-slot rows; async "
          f"sustained {sustained:.3f} ms per tick (submit included); i16 "
          f"p50 {timing['i16_tick_p50_ms']:.3f} ms; metering rail p50 "
          f"{timing['meter_tick_p50_ms']:.3f} ms; with {s} distinct "
          f"settings, one set_params p50 {timing['edit_p50_ms']:.3f} / p95 "
          f"{timing['edit_p95_ms']:.3f} ms and the tick after it p50 "
          f"{timing['edit_tick_p50_ms']:.3f} / p95 "
          f"{timing['edit_tick_p95_ms']:.3f} ms")
    return timing


HOST_CLIPS = 64                  # phase 6a: one-second WAVs
HOST_T = int(SR)                 # 6a, 6c: one second
HOST_BATCH = 32                  # 6a: the CLI's --batch (two macro batches)
HOST_SERVE_STREAMS = 4           # 6b
HOST_SERVE_BLOCKS = 24
HOST_PIPE_TICKS = NUM_BLOCKS     # 6d
HOST_PIPE_DEPTH = 2
HOST_PIPE_PLAIN_TICKS = 3        # 6d: the first ticks against the plain step
HOST_BRIDGE_BLOCKS = 200         # 6e
HOST_STAGE_PLAIN_BLOCKS = 3      # 6c, 6e: the first blocks at B = 1 against
                                 # the plain stage step on the card
HOST_ALONE = ("width", "cohere", "infer")    # 6f: no kernel in either package


def host_wavs(folder, clips):
    """Write each clip [C, T] (a tensor on the card) as a float32 WAV."""
    import os

    from juicy_tpu_torch.runtime.wav import write_wav

    paths = []
    for i, clip in enumerate(clips):
        path = os.path.join(folder, f"clip{i:03d}.wav")
        write_wav(path, clip.cpu().numpy(), int(SR))
        paths.append(path)
    return paths


def chain_spec():
    return ",".join(f"{n}:{p}" if p else n for n, p in CHAIN)


def host_corpus(device, folder):
    """6a: the CLI's corpus command (``cli.main``, what ``python -m
    juicy_tpu_torch corpus`` runs) on HOST_CLIPS one-second WAVs with a
    checkpoint, then again from a cursor rewritten to half-way."""
    import json as _json
    import os

    from juicy_tpu_torch.cli import main as cli_main
    from juicy_tpu_torch.parallel.corpus import run_corpus_chain
    from juicy_tpu_torch.runtime.wav import read_wav

    t = HOST_T
    clips = make_clicks(HOST_CLIPS, CHANNELS, t, device, seed=61)
    paths = host_wavs(folder, clips)
    out_dir, ck = os.path.join(folder, "out"), os.path.join(folder, "ck.json")
    args = ["corpus", *paths, "--stages", chain_spec(), "--out-dir", out_dir,
            "--checkpoint", ck, "--batch", str(HOST_BATCH)]
    nb = -(-t // BLOCK)
    reset_launches()
    t0 = time.perf_counter()
    cli_main(args)
    wall = time.perf_counter() - t0
    check_launches("6a corpus", nb * HOST_CLIPS // HOST_BATCH)
    with open(ck) as f:
        cursor = _json.load(f)
    if cursor["done"] != HOST_CLIPS:
        raise AssertionError(f"6a: cursor {cursor}")
    first = [read_wav(os.path.join(out_dir, os.path.basename(p)))[0]
             for p in paths]
    half = HOST_CLIPS // 2
    with open(ck, "w") as f:
        _json.dump(dict(cursor, done=half), f)
    for p in paths[half:]:
        os.remove(os.path.join(out_dir, os.path.basename(p)))
    reset_launches()
    cli_main(args)
    check_launches("6a resumed corpus", nb * (HOST_CLIPS - half) // HOST_BATCH)
    padded = torch.nn.functional.pad(clips, (0, nb * BLOCK - t))
    want, _ms, _agg = run_corpus_chain(bench_chain(), padded)
    want = want[..., :t].cpu().numpy()
    for i, p in enumerate(paths):
        got = read_wav(os.path.join(out_dir, os.path.basename(p)))[0]
        if not (np.array_equal(got, want[i]) and np.array_equal(first[i],
                                                                want[i])):
            raise AssertionError(f"6a: clip {i} differs from "
                                 f"run_corpus_chain")
    print(f"6a corpus CLI: {HOST_CLIPS} one-second WAVs in batches of "
          f"{HOST_BATCH}, {nb * HOST_CLIPS // HOST_BATCH} chain-kernel "
          f"launches, then {nb * (HOST_CLIPS - half) // HOST_BATCH} after the "
          f"cursor was rewound to {half}; every output bit-equal to "
          f"run_corpus_chain; first run {wall:.2f} s")
    return {"corpus_cli_s": wall,
            "corpus_launches": nb * HOST_CLIPS // HOST_BATCH}


def host_serve(device, folder):
    """6b: the CLI's serve command on HOST_SERVE_STREAMS WAVs through the
    canonical chain, against a direct StreamServer."""
    import os

    from juicy_tpu_torch.cli import main as cli_main
    from juicy_tpu_torch.runtime.serve import StreamServer
    from juicy_tpu_torch.runtime.wav import read_wav

    t = HOST_SERVE_BLOCKS * BLOCK - 100
    clips = make_clicks(HOST_SERVE_STREAMS, CHANNELS, t, device, seed=67)
    paths = host_wavs(folder, clips)
    prefix = os.path.join(folder, "served_")
    reset_launches()
    cli_main(["serve", *paths, "--stages", chain_spec(), "--out-prefix",
              prefix])
    check_launches("6b serve", HOST_SERVE_BLOCKS)
    srv = StreamServer(bench_chain(), max_streams=HOST_SERVE_STREAMS)
    sids = [srv.open_stream() for _ in paths]
    padded = torch.nn.functional.pad(clips, (0, HOST_SERVE_BLOCKS * BLOCK - t)
                                     ).cpu().numpy()
    outs = {sid: [] for sid in sids}
    for k in range(HOST_SERVE_BLOCKS):
        for sid, clip in zip(sids, padded):
            srv.submit(sid, clip[..., k * BLOCK:(k + 1) * BLOCK])
        for sid, res in srv.tick().items():
            outs[sid].append(res["audio"])
    for i, sid in enumerate(sids):
        want = np.concatenate(outs[sid], -1)[..., :t]
        if not np.array_equal(read_wav(f"{prefix}{i}.wav")[0], want):
            raise AssertionError(f"6b: stream {i} differs from a direct "
                                 f"StreamServer")
    print(f"6b serve CLI: {HOST_SERVE_STREAMS} streams, "
          f"{HOST_SERVE_BLOCKS} ticks, one chain-kernel launch per tick; "
          f"outputs equal to a direct StreamServer")


def stage_b1_vs_plain(tag, plug, params, audio, got=None):
    """The first HOST_STAGE_PLAIN_BLOCKS blocks of `audio` [1, C, T] on the
    card through the plugin's stage step at B = 1 twice: a StreamStep (its
    stage kernel, one CTA with one busy lane) and the same StreamStep with
    the plain stage step in its place. Audio and every state leaf
    bit-equal, the metrics within check_metrics' bars; `got` [C, T'], a
    main path's output over the same audio, bit-equal to the plain audio.
    Launches made here are comparisons: the caller has read its counts."""
    from juicy_tpu_torch.kernels import stage_kernels as sk
    from juicy_tpu_torch.runtime.host_bridge import StreamStep

    plain = {"punch": sk.punch_stage_step_plain,
             "saturator": sk.saturator_stage_step_plain,
             "texture": sk.texture_stage_step_plain,
             "motion": sk.motion_stage_step_plain}[plug.defn.name]
    kern, ref = StreamStep(plug, 1, audio.device), StreamStep(plug, 1,
                                                              audio.device)
    if kern.kstep is None:
        raise AssertionError(f"{tag}: {plug.defn.name} has no stage kernel")
    ref.kstep = plain
    nb = HOST_STAGE_PLAIN_BLOCKS
    for k in range(nb):
        blk = audio[..., k * BLOCK:(k + 1) * BLOCK]
        out_k, m_k = kern.step(params, blk)
        out_p, m_p = ref.step(params, blk)
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"{tag}: block {k} at B = 1: kernel vs "
                                 f"plain {residual_dbfs(out_k, out_p):.1f} "
                                 f"dBFS")
        check_metrics(f"{tag} block {k}", m_k, m_p)
        seg = None if got is None else got[:, k * BLOCK:(k + 1) * BLOCK]
        if seg is not None and not np.array_equal(
                seg, out_p[0, :, :seg.shape[-1]].cpu().numpy()):
            raise AssertionError(f"{tag}: block {k} of the main path "
                                 f"differs from the plain stage step")
    for part in ("analyzer", "dsp"):
        for key, v in ref.state[part].items():
            if not torch.equal(kern.state[part][key], v):
                raise AssertionError(f"{tag}: state {part}.{key} differs "
                                     f"at B = 1")
    print(f"{tag}: the first {nb} blocks at B = 1 bit-equal to the plain "
          f"stage step on the card (audio, every state leaf)"
          + ("" if got is None else ", the main path's output included"))


def host_process(device, folder):
    """6c: the CLI's process command with punch: one punch-kernel launch
    per block, the WAV bit-equal to the same step loop."""
    import os

    from juicy_tpu_torch.cli import main as cli_main
    from juicy_tpu_torch.runtime.host_bridge import StreamStep
    from juicy_tpu_torch.runtime.plugin import Plugin
    from juicy_tpu_torch.runtime.wav import read_wav

    t = HOST_T
    src = host_wavs(folder, make_clicks(1, CHANNELS, t, device, seed=71))[0]
    dst = os.path.join(folder, "punched.wav")
    nb = -(-t // BLOCK)
    reset_launches()
    t0 = time.perf_counter()
    cli_main(["process", src, dst, "--plugin", "punch", "--preset",
              PUNCH_PRESET])
    wall = time.perf_counter() - t0
    step = stage_steps()["punch"]
    if step.launches != nb or other_launches(step):
        raise AssertionError(f"6c: {step.launches} punch launches (and "
                             f"{other_launches(step)} other) for {nb} blocks")
    plug = Plugin("punch", SR, CHANNELS, BLOCK)
    params = plug.preset(PUNCH_PRESET)
    stepper = StreamStep(plug, 1, device)
    audio = torch.from_numpy(read_wav(src)[0]).to(device)
    audio = torch.nn.functional.pad(audio, (0, nb * BLOCK - t))[None]
    want = torch.cat([stepper.step(params, audio[..., k * BLOCK:
                                                 (k + 1) * BLOCK])[0]
                      for k in range(nb)], -1)[0, :, :t].cpu().numpy()
    if not np.array_equal(read_wav(dst)[0], want):
        raise AssertionError("6c: process output differs from the step loop")
    print(f"6c process CLI (punch, {nb} blocks): one punch-kernel launch per "
          f"block, output bit-equal to the stage-step loop; {wall:.2f} s")
    stage_b1_vs_plain("6c punch", plug, params, audio, read_wav(dst)[0])
    clip = make_clicks(1, CHANNELS, HOST_STAGE_PLAIN_BLOCKS * BLOCK, device,
                       seed=72)
    for name in ("texture", "motion"):
        plug = Plugin(name, SR, CHANNELS, BLOCK)
        stage_b1_vs_plain(f"6c {name}", plug, plug.default_params(), clip)
    return {"process_cli_s": wall}


def host_pipelined(device):
    """6d: PipelinedStream on the canonical chain, depth 2, one launch per
    tick; its audio against chain_kernel_stream over the same clip, and its
    first ticks against the plain step on the card."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.runtime.host_bridge import PipelinedStream

    chain = bench_chain()
    clip = make_clicks(1, CHANNELS, HOST_PIPE_TICKS * BLOCK, device,
                       seed=73)
    host = clip[0].cpu().numpy()
    ps = PipelinedStream(chain, depth=HOST_PIPE_DEPTH)
    if not ps.kernel_path:
        raise AssertionError("6d: the canonical chain missed the kernel path")
    ps.tick(host[:, :BLOCK])                    # warm-up: the build, pinned
    ps.flush()                                  # buffers and caches
    ps = PipelinedStream(chain, depth=HOST_PIPE_DEPTH)
    reset_launches()
    got, walls = [], []
    for k in range(HOST_PIPE_TICKS):
        t0 = time.perf_counter()
        res = ps.tick(host[:, k * BLOCK:(k + 1) * BLOCK])
        walls.append((time.perf_counter() - t0) * 1e3)
        if res is not None:
            got.append(res[0])
    got.extend(a for a, _ in ps.flush())
    check_launches("6d pipelined stream", HOST_PIPE_TICKS)
    got = np.concatenate(got, -1)
    want, _st, _ms = ck.chain_kernel_stream(
        chain, chain.init_state((1,), device), clip, metrics="final")
    if not np.array_equal(got, want[0].cpu().numpy()):
        raise AssertionError("6d: pipelined audio differs from "
                             "chain_kernel_stream")
    states = chain.init_state((1,), device)
    for k in range(HOST_PIPE_PLAIN_TICKS):
        out, states, _m = ck.chain_kernel_step_plain(
            chain, states, clip[..., k * BLOCK:(k + 1) * BLOCK])
        if not np.array_equal(got[:, k * BLOCK:(k + 1) * BLOCK],
                              out[0].cpu().numpy()):
            raise AssertionError(f"6d: tick {k} differs from the plain step "
                                 f"on the card")
    deadline = 1e3 * BLOCK / SR
    timing = {"tick_p50_ms": pct(walls, 50), "tick_p95_ms": pct(walls, 95),
              "deadline_ms": deadline, "latency_samples": ps.latency_samples}
    print(f"6d PipelinedStream (canonical chain, depth {HOST_PIPE_DEPTH}, "
          f"{HOST_PIPE_TICKS} ticks): one chain-kernel launch per tick, audio "
          f"bit-equal to chain_kernel_stream and its first "
          f"{HOST_PIPE_PLAIN_TICKS} ticks to the plain step on the card; "
          f"tick wall p50 {timing['tick_p50_ms']:.3f} / p95 "
          f"{timing['tick_p95_ms']:.3f} ms against {deadline:.3f} ms")
    return timing


def host_bridge(device):
    """6e: HostBridge on the saturator over HOST_BRIDGE_BLOCKS blocks pushed
    and pumped one at a time: every block back, in order, bit-equal to
    run_corpus over the clip; x realtime and the per-block latency."""
    from juicy_tpu_torch.parallel.corpus import run_corpus
    from juicy_tpu_torch.runtime.host_bridge import HostBridge
    from juicy_tpu_torch.runtime.plugin import Plugin

    plug = Plugin("saturator", SR, CHANNELS, BLOCK)
    params = plug.preset(PRESET)
    clip = make_batch(1, CHANNELS, HOST_BRIDGE_BLOCKS * BLOCK, device,
                      seed=79)
    host = clip[0].cpu().numpy()
    warm = HostBridge(plug, params)
    warm.push_block(host[:, :BLOCK])
    warm.process_available()
    warm.stop()
    bridge = HostBridge(plug, params)
    reset_launches()
    got, lat = [], []
    t0 = time.perf_counter()
    for k in range(HOST_BRIDGE_BLOCKS):
        t1 = time.perf_counter()
        if not bridge.push_block(host[:, k * BLOCK:(k + 1) * BLOCK]):
            raise AssertionError(f"6e: block {k} refused by the ring")
        bridge.process_available()
        out = bridge.pop_block()
        lat.append((time.perf_counter() - t1) * 1e3)
        if out is None:
            raise AssertionError(f"6e: block {k} lost")
        got.append(out)
    wall = time.perf_counter() - t0
    extra = bridge.pop_block()
    bridge.stop()
    step = stage_steps()["saturator"]
    if extra is not None or step.launches != HOST_BRIDGE_BLOCKS \
            or other_launches(step):
        raise AssertionError(f"6e: {step.launches} saturator launches for "
                             f"{HOST_BRIDGE_BLOCKS} blocks")
    want, _last, _agg = run_corpus(plug, params, clip)
    got = np.concatenate(got, -1)
    if not np.array_equal(got, want[0].cpu().numpy()):
        raise AssertionError("6e: bridge output differs from run_corpus")
    stage_b1_vs_plain("6e saturator", plug, params, clip, got)
    x_rt = HOST_BRIDGE_BLOCKS * BLOCK / SR / wall
    timing = {"x_realtime": x_rt, "latency_p50_ms": pct(lat, 50),
              "latency_p95_ms": pct(lat, 95)}
    print(f"6e HostBridge (saturator, {HOST_BRIDGE_BLOCKS} blocks): every "
          f"block back in order, one saturator launch each, bit-equal to "
          f"run_corpus; {x_rt:.2f}x realtime, push-to-pop p50 "
          f"{timing['latency_p50_ms']:.3f} / p95 "
          f"{timing['latency_p95_ms']:.3f} ms")
    if x_rt < 1.0:
        raise AssertionError(f"6e: HostBridge below realtime ({x_rt:.2f}x)")
    return timing


def host_alone(device):
    """6f: one block of width, cohere and infer alone through StreamStep on
    the card (Plugin.step: no kernel in either package), timed after one
    warm-up block."""
    from juicy_tpu_torch.runtime.host_bridge import StreamStep
    from juicy_tpu_torch.runtime.plugin import Plugin

    ms = {}
    clip = make_batch(1, CHANNELS, 2 * BLOCK, device, seed=83)
    for name in HOST_ALONE:
        plug = Plugin(name, SR, CHANNELS, BLOCK)
        stepper = StreamStep(plug, 1, device)
        stepper.step(plug.default_params(), clip[..., :BLOCK])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stepper.step(plug.default_params(), clip[..., BLOCK:])
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
    print("6f one block alone on the card (Plugin.step, B = 1): " +
          ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items()) +
          f" (the block lasts {1e3 * BLOCK / SR:.3f} ms)")
    return ms


def phase_host(device):
    """6: the host entry points on the card; raises on any failure."""
    import tempfile

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as folder:
        out.update(host_corpus(device, folder))
        host_serve(device, folder)
        out.update(host_process(device, folder))
    out["pipelined"] = host_pipelined(device)
    out["bridge"] = host_bridge(device)
    out["alone_block_ms"] = host_alone(device)
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 6: {out['phase_s']:.1f} s")
    print(json.dumps({"host": out}))
    return out


class OnsetRecorder:
    """Records every onset count the relaxed tier's detector returns
    (``runtime/relaxed.py::_first_onset``), in call order, on the CPU."""

    def __enter__(self):
        from juicy_tpu_torch.runtime import relaxed as trx

        self._mod, self._orig, self.counts = trx, trx._first_onset, []

        def spy(*args):
            res = self._orig(*args)
            self.counts.append(res[0].cpu())
            return res
        trx._first_onset = spy
        return self

    def __exit__(self, *exc):
        self._mod._first_onset = self._orig


def relaxed_block_db(out, ref, n):
    """The residual in dBFS of each block of `out` against `ref`."""
    d = (out.double() - ref.double()).abs().amax(dim=(0, 1))
    d = d.reshape(-1, n).amax(dim=1)
    return [-math.inf if float(v) == 0 else 20.0 * math.log10(float(v))
            for v in d]


def phase_relaxed(device):
    """7: relaxed_chain_stream (the relaxed tier) on the card; raises on
    any failure."""
    from juicy_tpu_torch.parallel.corpus import run_corpus_chain
    from juicy_tpu_torch.runtime.plugin import Chain
    from juicy_tpu_torch.runtime.relaxed import relaxed_chain_stream

    t_phase = time.perf_counter()
    b, n, nb = RELAXED_BATCH, BLOCK, NUM_BLOCKS
    chain = Chain(CHAIN, SR, CHANNELS, n)
    clips = make_clicks(b, CHANNELS, nb * n, device, seed=71)
    relaxed_chain_stream(chain, chain.init_state((b,), device),
                         clips[..., :n])                      # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out, _st, ms = relaxed_chain_stream(chain, chain.init_state((b,), device),
                                        clips)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = sum(s.launches for s in all_steps())
    if kernels:
        raise AssertionError(f"relaxed chain: {kernels} launches of the "
                             f"port's hand-written kernels (it has none)")
    if tuple(out.shape) != tuple(clips.shape) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError("relaxed chain output is not finite or has the "
                             "wrong shape")
    for s_, m in enumerate(ms):
        for key, v in m.items():
            if tuple(v.shape) != (nb, b) or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"relaxed stage {s_} metric {key} is "
                                     f"not finite [nb, B]")
        for key in ("score", "pre_score", "post_score"):
            if not bool(((m[key] >= 0) & (m[key] <= 100)).all()):
                raise AssertionError(f"relaxed stage {s_} {key} outside "
                                     f"[0, 100]")
    rate = b * nb * n / SR / wall
    print(f"relaxed_chain_stream B={b} T={nb * n}: {wall:.4f} s warm, "
          f"{rate:.1f} audio-s/s, {wall / nb * 1e3:.2f} ms per block")

    # against the chain kernel: gated over the depth JAX certified,
    # reported over the whole corpus
    out_k, ms_k, _agg = run_corpus_chain(chain, clips, metrics="blocks")
    torch.cuda.synchronize()
    g = RELAXED_GATED_BLOCKS
    db_gated = residual_dbfs(out[..., :g * n], out_k[..., :g * n])
    ds_gated = max(max_diff(m["score"][g - 1], mk["score"][g - 1])
                   for m, mk in zip(ms, ms_k))
    ds_last = max_diff(ms[-1]["score"][g - 1], ms_k[-1]["score"][g - 1])
    per_block = relaxed_block_db(out, out_k, n)
    past = next((k for k, v in enumerate(per_block) if v > -90.0), None)
    ds_full = max(max_diff(m["score"], mk["score"]) for m, mk in zip(ms, ms_k))
    print(f"relaxed vs chain kernel, first {g} blocks: audio {db_gated:.1f} "
          f"dBFS, last stage's block-{g} scores {ds_last:.3g} (every "
          f"stage's {ds_gated:.3g}); all {nb} blocks (reported, not "
          f"gated): audio {max(per_block):.1f} dBFS, scores {ds_full:.3g}, "
          f"first block past -90 dBFS: {past}")
    print("relaxed vs chain kernel, per block (dBFS): "
          + " ".join(f"{v:.1f}" for v in per_block))
    if db_gated > -90.0 or ds_last > 0.01:
        raise AssertionError("relaxed chain: beyond JAX's certification bar "
                             "against the chain kernel")
    del out_k, ms_k

    # the same call on the CPU
    sub = clips[:RELAXED_CPU_CLIPS, :, :RELAXED_CPU_BLOCKS * n]
    with OnsetRecorder() as rec_g:
        out_g, st_g, ms_g = relaxed_chain_stream(
            chain, chain.init_state((sub.shape[0],), device), sub)
    t0 = time.perf_counter()
    with OnsetRecorder() as rec_c:
        out_c, st_c, ms_c = relaxed_chain_stream(
            chain, chain.init_state((sub.shape[0],), "cpu"), sub.cpu(),
            device="cpu")
    cpu_s = time.perf_counter() - t0
    db_cpu = residual_dbfs(out_g.cpu(), out_c)
    rel = max(float(((mg[k].cpu().double() - mc[k].double()).abs()
                     / mc[k].double().abs().clamp(min=1.0)).max())
              for mg, mc in zip(ms_g, ms_c) for k in mc)
    counts_eq = len(rec_g.counts) == len(rec_c.counts) and all(
        torch.equal(a, c) for a, c in zip(rec_g.counts, rec_c.counts))
    states_eq = all(torch.equal(sg["analyzer"]["onset_cooldown"].cpu(),
                                sc["analyzer"]["onset_cooldown"])
                    for sg, sc in zip(st_g, st_c)) and all(
        torch.equal(st_g[3]["dsp"][k].cpu(), st_c[3]["dsp"][k])
        for k in ("rng", "onset_cooldown"))
    print(f"relaxed card vs CPU, {sub.shape[0]} clips x {RELAXED_CPU_BLOCKS} "
          f"blocks: audio {db_cpu:.1f} dBFS, metrics {rel:.3g} of "
          f"max(1, |value|), onset counts equal ({len(rec_g.counts)} "
          f"calls): {counts_eq}, cooldowns and motion's rng equal: "
          f"{states_eq} (CPU {cpu_s:.1f} s)")
    if db_cpu > -110.0 or rel > 1e-5 or not counts_eq or not states_eq:
        raise AssertionError("relaxed chain: the card disagrees with the CPU")

    # launches per block, and one block at B = 8192
    from torch.profiler import ProfilerActivity, profile
    blk = clips[..., :n]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        relaxed_chain_stream(chain, chain.init_state((b,), device), blk)
        torch.cuda.synchronize()
    per_block_launches = sum(e.count for e in prof.key_averages()
                             if e.key == "cudaLaunchKernel")
    wide = make_clicks(RELAXED_WIDE_BATCH, CHANNELS, n, device, seed=73)
    st_w = chain.init_state((RELAXED_WIDE_BATCH,), device)
    relaxed_chain_stream(chain, st_w, wide)                   # warm-up
    torch.cuda.synchronize()
    st_w = chain.init_state((RELAXED_WIDE_BATCH,), device)
    t0 = time.perf_counter()
    relaxed_chain_stream(chain, st_w, wide)
    torch.cuda.synchronize()
    wide_ms = (time.perf_counter() - t0) * 1e3
    print(f"relaxed chain: {per_block_launches} cudaLaunchKernel per block "
          f"at B={b} (torch.profiler); one block at B={RELAXED_WIDE_BATCH}: "
          f"{wide_ms:.1f} ms ({RELAXED_WIDE_BATCH * n / SR / wide_ms * 1e3:.1f}"
          f" audio-s/s)")
    res = {"batch": b, "blocks": nb, "wall_s": wall, "audio_s_per_s": rate,
           "block_ms": wall / nb * 1e3, "vs_kernel_gated_dbfs": db_gated,
           "vs_kernel_gated_score": ds_last, "vs_kernel_full_dbfs":
           max(per_block), "vs_kernel_full_score": ds_full,
           "first_block_past_90": past, "vs_cpu_dbfs": db_cpu,
           "vs_cpu_metrics": rel, "launches_per_block": per_block_launches,
           "wide_block_ms": wide_ms,
           "phase_s": time.perf_counter() - t_phase}
    print(f"phase 7: {res['phase_s']:.1f} s")
    print(json.dumps({"relaxed": res}))
    return res


def same_tree(tag, got, want):
    """Every tensor of two nested results bit-equal (None where None)."""
    if isinstance(want, dict):
        for k in want:
            same_tree(f"{tag}/{k}", got[k], want[k])
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            same_tree(f"{tag}/{i}", g, w)
    elif want is None:
        if got is not None:
            raise AssertionError(f"{tag}: None expected")
    elif not torch.equal(got, want):
        raise AssertionError(f"{tag}: the sharded result differs")


def shard_launches(corpus, name, step, run):
    """`run()` with `corpus.<name>` spied: the launches of `step` in each
    inner (per-shard) call."""
    orig = getattr(corpus, name)
    per = []

    def spy(*args, **kw):
        before = step.launches
        res = orig(*args, **kw)
        per.append(step.launches - before)
        return res
    setattr(corpus, name, spy)
    try:
        return run(orig), per
    finally:
        setattr(corpus, name, orig)


def phase_mesh(device):
    """8: the mesh entry points; raises on any failure."""
    import tempfile

    from juicy_tpu_torch.ops.scan_utils import linear_scan_assoc
    from juicy_tpu_torch.parallel import corpus
    from juicy_tpu_torch.parallel.mesh import make_mesh
    from juicy_tpu_torch.parallel.timeshard import \
        sequence_parallel_linear_scan
    from juicy_tpu_torch.runtime.plugin import Chain, Plugin
    from juicy_tpu_torch.runtime.serve import StreamServer

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(cards)] if cards > 1
               else [device, device])
    mesh = make_mesh(devices=devices)
    k = mesh.size
    print(f"phase 8 mesh: {[str(d) for d in devices]} ("
          + ("every visible card" if cards > 1 else
             "cuda:0 twice: the split and the gather only") + ")")
    res = {"devices": [str(d) for d in devices]}

    # run_corpus_chain at full width
    n = BLOCK
    chain = Chain(CHAIN, SR, CHANNELS, n)
    clips = make_clicks(CHAIN_CORPUS_BATCH, CHANNELS, NUM_BLOCKS * n, device,
                        seed=81)
    t0 = time.perf_counter()
    want = corpus.run_corpus_chain(chain, clips, metrics="blocks",
                                   device=device)
    torch.cuda.synchronize()
    wall_one = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    got, per = shard_launches(
        corpus, "run_corpus_chain", chain_step(),
        lambda run: run(chain, clips, metrics="blocks", mesh=mesh))
    torch.cuda.synchronize()
    wall_mesh = time.perf_counter() - t0
    same_tree("run_corpus_chain", got, want)
    if per != [NUM_BLOCKS] * k or other_launches(chain_step()):
        raise AssertionError(f"sharded chain corpus: launches per shard "
                             f"{per}, {other_launches(chain_step())} other")
    print(f"run_corpus_chain B={CHAIN_CORPUS_BATCH} over {k} shards: audio, "
          f"every stage's metrics per block and the aggregates bit-equal to "
          f"the unsharded run; chain-kernel launches per shard {per}; walls "
          f"{wall_one:.3f} s unsharded, {wall_mesh:.3f} s sharded")
    res["chain"] = {"launches_per_shard": per, "wall_one_s": wall_one,
                    "wall_mesh_s": wall_mesh}
    del want, got, clips

    # run_corpus, the saturator's stage kernel
    plug = Plugin("saturator", SR, CHANNELS, n)
    params = plug.preset(PRESET)
    clips = make_batch(MESH_CORPUS_BATCH, CHANNELS, NUM_BLOCKS * n, device,
                       seed=83)
    want = corpus.run_corpus(plug, params, clips, device=device)
    reset_launches()
    got, per = shard_launches(
        corpus, "run_corpus", stage_steps()["saturator"],
        lambda run: run(plug, params, clips, mesh=mesh))
    same_tree("run_corpus", got, want)
    if per != [NUM_BLOCKS] * k:
        raise AssertionError(f"sharded saturator corpus: launches per shard "
                             f"{per}")
    print(f"run_corpus saturator B={MESH_CORPUS_BATCH} over {k} shards: "
          f"bit-equal; stage-kernel launches per shard {per}")
    res["saturator_launches_per_shard"] = per

    # run_corpus_resumable
    sub = clips[:MESH_RESUME_CLIPS, :, :4 * n]
    with tempfile.TemporaryDirectory() as folder:
        one = corpus.run_corpus_resumable(
            plug, params, sub, f"{folder}/one.ckpt", macro_batch=MESH_MACRO,
            device=device)
        sharded = corpus.run_corpus_resumable(
            plug, params, sub, f"{folder}/mesh.ckpt", macro_batch=MESH_MACRO,
            mesh=mesh)
    if not np.array_equal(one, sharded):
        raise AssertionError("run_corpus_resumable: the sharded scores differ")
    print(f"run_corpus_resumable {MESH_RESUME_CLIPS} clips, macro batches of "
          f"{MESH_MACRO} over {k} shards: the same scores")
    del want, got, clips

    # StreamServer: tests/test_serve.py:278-307's script (three streams,
    # a per-slot edit on the second, two ticks), on bench.py's chain (the
    # kernel tick) and on JAX's test chain (the fused tick). The kernel
    # tick is bit-equal to the solo server. The fused tick sums each
    # block with PyTorch's CUDA reductions, whose order follows the
    # tensor's shape: a pool of S/K slots sums as a solo server of S/K
    # slots does, bit for bit, and within JAX's own tolerances for its
    # sharded server (audio 2e-6, scores 1e-3) of the solo server of S.
    x = make_clicks(1, CHANNELS, 2 * n, device, seed=85)[0].cpu().numpy()
    serve_stages = [("punch", "Solar Snap"), ("saturator", "Amber Heat"),
                    ("infer", None)]

    def play(stages, stage, edit, slots, **kw):
        srv = StreamServer(Chain(stages, SR, CHANNELS, n), slots, **kw)
        sids = [srv.open_stream() for _ in range(3)]
        srv.set_params(sids[1], stage, **edit)
        rec = []
        for j in range(2):
            blk = x[:, j * n:(j + 1) * n]
            for sid in sids:
                srv.submit(sid, blk * (1.0 + 0.1 * sid))
            _sids, audio, scores, pre = srv.tick_arrays()
            rec.append((audio, scores, pre))
        return rec

    def equal(ra, rb):
        return all(np.array_equal(a_, b_) for ta, tb in zip(ra, rb)
                   for a_, b_ in zip(ta, tb))

    sharded = play(CHAIN, "punch", {"punch": 0.3}, MESH_SLOTS, mesh=mesh)
    solo = play(CHAIN, "punch", {"punch": 0.3}, MESH_SLOTS, device=device)
    if not equal(sharded, solo):
        raise AssertionError("StreamServer(mesh=) kernel tick: differs from "
                             "the solo server")
    print(f"StreamServer(mesh=) {MESH_SLOTS} slots over {k} pools, kernel "
          f"tick: bit-equal to the solo server")
    edit = ("saturator", {"drive": 13.5})
    sharded = play(serve_stages, *edit, MESH_SLOTS, mesh=mesh)
    pool = play(serve_stages, *edit, MESH_SLOTS // k, device=device)
    solo = play(serve_stages, *edit, MESH_SLOTS, device=device)
    d_audio = max(max_diff(torch.from_numpy(a_[0]), torch.from_numpy(b_[0]))
                  for a_, b_ in zip(sharded, solo))
    d_score = max(max_diff(torch.from_numpy(a_[1]), torch.from_numpy(b_[1]))
                  for a_, b_ in zip(sharded, solo))
    print(f"StreamServer(mesh=) {MESH_SLOTS} slots over {k} pools, fused "
          f"tick: bit-equal to a solo server of {MESH_SLOTS // k} slots: "
          f"{equal(sharded, pool)}; against the solo server of "
          f"{MESH_SLOTS}: audio {d_audio:.3g}, scores {d_score:.3g}; a solo "
          f"server of {MESH_SLOTS // k} against it: bit-equal "
          f"{equal(pool, solo)}")
    if not equal(sharded, pool) or d_audio > 2e-6 or d_score > 1e-3:
        raise AssertionError("StreamServer(mesh=) fused tick: differs from "
                             "the solo servers")
    res["serve_fused_vs_solo"] = {"audio": d_audio, "score": d_score}

    # the sequence-parallel scan
    t = NUM_BLOCKS * n
    g = torch.Generator(device=device).manual_seed(87)
    a = 0.9 + 0.1 * torch.rand((64, t), generator=g, device=device)
    x = torch.randn((64, t), generator=g, device=device)
    init = torch.randn((64,), generator=g, device=device)
    seq = make_mesh((k,), ("seq",), devices=devices)
    y_sp = sequence_parallel_linear_scan(seq, a, x, init)
    y_cpu = sequence_parallel_linear_scan(
        make_mesh((k,), ("seq",), devices=["cpu"] * k), a.cpu(), x.cpu(),
        init.cpu())
    y_one = linear_scan_assoc(a, x, init)
    sp_cpu = torch.equal(y_sp.cpu(), y_cpu)
    d_one = max_diff(y_sp, y_one)
    close = bool(torch.allclose(y_sp, y_one, rtol=1e-4, atol=1e-5))
    print(f"sequence_parallel_linear_scan T={t} over {k} shards: bit-equal "
          f"to the same split on the CPU: {sp_cpu}; against "
          f"linear_scan_assoc on one device: max |diff| {d_one:.3g}, within "
          f"JAX's rtol 1e-4 / atol 1e-5: {close}")
    if not (sp_cpu and close):
        raise AssertionError("sequence_parallel_linear_scan disagrees")
    res["scan_vs_one_max_diff"] = d_one
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 8: {res['phase_s']:.1f} s")
    print(json.dumps({"mesh": res}))
    return res


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run "
                         "on an NVIDIA GPU only")
    from juicy_tpu_torch.runtime.plugin import Plugin

    device = torch.device("cuda", 0)
    phase_device()
    phase_build()
    alone = {"4h": phase_ema_scan, "6": phase_host, "7": phase_relaxed,
             "8": phase_mesh}
    if len(sys.argv) == 3 and sys.argv[1] == "--phase" \
            and sys.argv[2] in alone:                    # one phase alone
        alone[sys.argv[2]](device)
        return 0
    plugin = Plugin("saturator", SR, CHANNELS, BLOCK)
    params = plugin.preset(PRESET)
    sat_timing = phase_kernel_vs_plain(device, plugin, params)
    tex_timing = phase_texture_kernel_vs_plain(device)
    pm_timing = phase_punch_motion_kernels(device)
    chain_timing = phase_chain_kernel_vs_plain(device)
    analyzer = phase_analyze_fused(device)
    sat_fused = phase_saturator_step_fused(device, plugin, params)
    chain_corpus = phase_chain_corpus(device)
    mixed = phase_mixed_materials(device)
    automation = phase_automation(device)
    ema = phase_ema_scan(device)
    sat_launches = phase_corpus(device, plugin, params)
    tex_launches = phase_texture_corpus(device)
    pm_launches = phase_punch_motion_corpus(device)
    phase_chain(device)
    serve = phase_serve(device)
    phase_host(device)
    phase_relaxed(device)
    phase_mesh(device)
    ref = tex_timing[MATERIALS[REFERENCE_MATERIAL]]
    print(json.dumps({"kernels": [{
        "name": "saturator_stage",
        "route": "cuda",
        "source": "juicy_tpu_torch/csrc/saturator_stage.cu",
        "replaces": "juicy_tpu/kernels/stage_kernels.py:1226",
        "launches": sat_launches,
        **sat_timing,
    }, {
        "name": "texture_stage",
        "route": "cuda",
        "source": "juicy_tpu_torch/csrc/texture_stage.cu",
        "replaces": "juicy_tpu/kernels/stage_kernels.py:1055",
        "launches": sum(tex_launches.values()),
        "max_abs_err": max(v["max_abs_err"] for v in tex_timing.values()),
        "ms": ref["ms"], "plain_ms": ref["plain_ms"],
        "bound_ms": ref["bound_ms"], "bound_by": ref["bound_by"],
        "library_ms": None,
        "ms_by_batch": ref["ms_by_batch"],
        "timed_material": MATERIALS[REFERENCE_MATERIAL],
        "launches_by_material": tex_launches,
        "by_material": tex_timing,
        "by_material_mix": mixed["texture"],
    }, {
        "name": "punch_stage",
        "route": "cuda",
        "source": "juicy_tpu_torch/csrc/punch_stage.cu",
        "replaces": "juicy_tpu/kernels/stage_kernels.py:331",
        "launches": pm_launches["punch"],
        **pm_timing["punch"],
        "automation": automation["punch"],
    }, {
        "name": "motion_stage",
        "route": "cuda",
        "source": "juicy_tpu_torch/csrc/motion_stage.cu",
        "replaces": "juicy_tpu/kernels/stage_kernels.py:1490",
        "launches": pm_launches["motion"],
        **pm_timing["motion"],
    }, {
        "name": "chain",
        "route": "cuda",
        "source": "juicy_tpu_torch/csrc/chain.cu",
        "replaces": "juicy_tpu/kernels/chain_kernel.py:1268",
        "launches": chain_corpus["launches"],
        "max_abs_err": max(v["max_abs_err"] for v in chain_timing.values()),
        "ms": chain_corpus["ms"], "plain_ms": chain_corpus["plain_ms"],
        "bound_ms": chain_corpus["bound_ms"],
        "bound_by": chain_corpus["bound_by"], "library_ms": None,
        "timed_batch": CHAIN_CORPUS_BATCH,
        "ms_by_batch": chain_corpus["ms_by_batch"],
        "corpus_wall_s": chain_corpus["wall"],
        "by_material_b4096": chain_timing,
        "by_material_mix": mixed["chain"],
        "automation": automation["chain"],
        "serve": serve,
    }, {
        "name": "analyzer",
        "route": "cuda",
        "source": "juicy_tpu_torch/csrc/analyzer.cu",
        "replaces": "juicy_tpu/kernels/analyzer_kernel.py:128",
        **analyzer,
    }, {
        "name": "saturator_step_fused",
        "route": "cuda",
        "source": "juicy_tpu_torch/csrc/saturator_stage.cu",
        "replaces": "juicy_tpu/kernels/saturator_kernel.py:136",
        **sat_fused,
    }, {
        "name": "ema_scan",
        "route": "cuda",
        "source": "juicy_tpu_torch/csrc/finalize.cu",
        "replaces": None,
        "timed_batch": CHAIN_CORPUS_BATCH,
        **ema,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
