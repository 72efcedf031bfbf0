"""The chain kernel's least work per block, and the card's peaks: the
yardstick of the roofline metrics. Frozen here so that a change to the
program cannot move it.

Operations are float32 operations per sample of the loop bodies, counted
from the CUDA sources (``juicy_tpu_torch/csrc``) as built: each add,
subtract, multiply, divide, min, max, rint and compare counts one; abs,
selects and integer work (the LCG, index and conversion arithmetic) count
nothing, nor do terms of the constants alone. tanh32 is 29, cos32 21,
pow32 40 (log2 18, exp2 21, one multiply), sin32 26, exp32_narrow 18.
The sources are built with ``-fmad=false``, so each multiply and add is
its own instruction, while the peak below counts a fused multiply-add as
two operations: an operation bound read against it is low by up to 2x.
Left out, as under a thousandth of the work: motion's three draws on an
onset and the once-per-block terms.

Bytes: audio in and out, every stage's state in and out, the analyzer
lanes in and out, each counted once; the waveguide and Haas rings' rows
that a block reads before it writes them, and the rows it writes.
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM (data sheet, 700 W): HBM3 bytes/s, f32 FLOP/s off the
#: tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

LANE_OPS = 42           # the analyzer lane per clip-sample (lane.cuh)
SAT_OPS = 40            # per channel-sample
TEX_OPS = 84            # texture's front, back and noise per channel-sample
TEX_MAT_OPS = (46, 140, 47, 47, 57)     # gel, metal, wood, plastic, flesh
TEX_NMAT = (2, 8, 9, 9, 4)              # each material's state per channel
PUNCH_OPS = 98          # per channel-sample
MOTION_P1_OPS = 10      # per clip-sample
MOTION_P2_OPS = 109     # per channel-sample
WIDTH_OPS = 22          # per clip-sample
COHERE_A_OPS = 17       # analysis per clip-sample
COHERE_R_OPS = 23       # render per channel-sample
INFER_OPS = 1           # per channel-sample

MATERIALS = ("gel", "metal", "wood", "plastic", "flesh")
WAVE_MODES = (2, 3)


def bound(nbytes, ops):
    """(least ms, what sets it): the larger of bytes over the memory rate
    and operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def chain_work(b, c, n, mode, tex_delay, haas_delay):
    """(bytes, operations) of one block of the chain for `b` clips of
    material `mode`, `c` channels, `n` samples: audio in and out; every
    stage's state in and out (texture's ring rows as below; the Haas
    ring's rows this block reads before it writes them, min(delay, n), and
    the n it writes; cohere's context fit out); seven lanes in and 14
    out."""
    state = (2 * c + c + (9 + TEX_NMAT[mode]) * c + 3 * c + c   # per clip
             + 1 + 12 + 5)
    nbytes = 4 * (2 * b * c * n + 2 * state * b + b + 7 * 5 * b
                  + 14 * 15 * b + b * (min(haas_delay, n) + n))
    if mode in WAVE_MODES:
        rows_in = min(math.ceil(tex_delay) + 1, n + 1)
        nbytes += 4 * b * c * (rows_in + n)
    per_clip = (14 * LANE_OPS + MOTION_P1_OPS + WIDTH_OPS + COHERE_A_OPS
                + c * (PUNCH_OPS + SAT_OPS + TEX_OPS + TEX_MAT_OPS[mode]
                       + MOTION_P2_OPS + COHERE_R_OPS + INFER_OPS))
    return nbytes, b * n * per_clip


def mixed_bound(work, counts):
    """The bound of a launch over several materials: each material's
    (bytes, operations) from `work(clips, mode)` for the corpus's own clips
    of it (`counts` {mode: clips}), summed. Padding clips that the program
    adds are not work the chain needs."""
    nbytes = ops = 0
    for mode, nb in counts.items():
        w = work(nb, mode)
        nbytes, ops = nbytes + w[0], ops + w[1]
    return bound(nbytes, ops)


def delays(config):
    """The Haas delay in whole samples and each wave material's waveguide
    delay ({mode: samples}) of the configuration's params."""
    from benchmark.reference.chain import stage_params
    from benchmark.reference.stages import haas_delay, waveguide_delay

    sr = float(config["sample_rate"])
    p = stage_params(config)
    return haas_delay(p[4], sr), {m: float(waveguide_delay(p[2], m, sr))
                                  for m in WAVE_MODES}


def block_bound(config, counts):
    """(least ms, what sets it) of one block of the configuration's chain
    over the clips `counts` {material: clips}."""
    c, n = int(config["channels"]), int(config["block_size"])
    haas, tex_delay = delays(config)
    return mixed_bound(lambda nb, m: chain_work(
        nb, c, n, m, tex_delay.get(m, 0.0), haas), counts)
