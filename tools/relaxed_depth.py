"""The relaxed tier at full depth, on the CPU: JAX's and the port's, each
against its own exact executor, and the two against each other.

    JAX_PLATFORMS=cpu python3 tools/relaxed_depth.py [--clips 4]

Streams `--clips` clips of 94 blocks of 512 stereo samples (chip_smoke.py's
burst input, drawn on the CPU, seed 71) through bench.py's seven-stage
chain four ways: JAX's ``relaxed_chain_stream`` and its jitted
``Chain.batched_run`` (JAX's default XLA flags), the port's
``relaxed_chain_stream`` and its ``run_corpus_chain`` (the chain kernel's
plain version), all with ``metrics="blocks"``. Prints one JSON object: for
each comparison the residual of every block in dBFS, the largest, the
first block past -90 dBFS, and the last stage's score differences (at the
4th block and over all). It answers whether a departure of the relaxed
tier from the exact executors at depth is the tier's (JAX's does the
same) or the port's. Takes a few minutes.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

N = cs.BLOCK
NB = cs.NUM_BLOCKS


def compare(a, b, score_a, score_b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    d = d.max(axis=(0, 1)).reshape(NB, N).max(axis=1)
    db = [-np.inf if v == 0 else float(20 * np.log10(v)) for v in d]
    ds = np.abs(np.asarray(score_a, np.float64) - np.asarray(score_b))
    return {"per_block_dbfs": db, "max_dbfs": max(db),
            "first_block_past_90": next(
                (k for k, v in enumerate(db) if v > -90.0), None),
            "score_diff_block4": float(ds[3].max()),
            "score_diff_max": float(ds.max())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=int, default=4)
    b = ap.parse_args(argv).clips
    import jax
    import jax.numpy as jnp
    from juicy_tpu.runtime import relaxed as jrx
    from juicy_tpu.runtime.plugin import Chain as JChain

    from juicy_tpu_torch.parallel.corpus import run_corpus_chain
    from juicy_tpu_torch.runtime.plugin import Chain
    from juicy_tpu_torch.runtime.relaxed import relaxed_chain_stream

    clips = cs.make_clicks(b, cs.CHANNELS, NB * N, torch.device("cpu"),
                           seed=71).numpy()
    jchain = JChain(cs.CHAIN, sr=cs.SR, channels=cs.CHANNELS, block_size=N)

    def jstates():
        return [jax.vmap(lambda _, p=p: p.init_state())(jnp.arange(b))
                for p in jchain.plugins]

    j_r, _, jm_r = jrx.relaxed_chain_stream(jchain, jstates(), clips)
    j_e, _, jm_e = jax.jit(jchain.batched_run)(jstates(), clips)
    chain = Chain(cs.CHAIN, cs.SR, cs.CHANNELS, N)
    t_r, _, tm_r = relaxed_chain_stream(chain, chain.init_state((b,), "cpu"),
                                        clips, device="cpu")
    t_e, tm_e, _ = run_corpus_chain(chain, clips, metrics="blocks",
                                    device="cpu")

    def last(ms):
        return np.asarray(ms[-1]["score"])

    print(json.dumps({
        "clips": b, "blocks": NB,
        "jax_relaxed_vs_jax_exact": compare(j_r, j_e, last(jm_r), last(jm_e)),
        "port_relaxed_vs_port_exact": compare(t_r, t_e, last(tm_r),
                                              last(tm_e)),
        "port_relaxed_vs_jax_relaxed": compare(t_r, j_r, last(tm_r),
                                               last(jm_r))}))


if __name__ == "__main__":
    main()
