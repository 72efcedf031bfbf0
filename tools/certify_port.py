"""Full-depth certificate of the port's main path, in two halves.

    python3 tools/certify_port.py --half cpu     # needs JAX: port vs JAX
    python3 tools/certify_port.py --half card    # needs a CUDA card

The corpus is ``tools/certify_onchip.py::make_clips(512, 94 * 512)`` (seed
0xC0FFEE, stereo, 48 kHz, onset-rich) and the chain bench.py's seven-stage
chain, run twice: with texture gel, and with a material per clip
(``arange(512) % 5``: gel, metal, wood, plastic and flesh in the chain).

* ``--half cpu``: the port's ``run_corpus_chain(chain, clips,
  metrics="blocks", device="cpu")`` (the chain kernel's plain version)
  against JAX's ``fused_chain_stream`` run op by op, and beside it JAX's
  jitted ``run_corpus_chain``; JAX runs in a subprocess whose XLA:CPU
  emits no FMA (``tests/torch_jax_ref.py``), so this process never imports
  it. Per clip: the max-abs audio residual in dBFS and each stage's
  last-block score difference. The bar is JAX's product bar
  (``tests/test_artifacts.py``): every clip within -80 dBFS, the median at
  or below -100, scores within 1e-5 of max(1, |value|).
* ``--half card``: the chain kernel (``chain_kernel.py::_run_cuda``)
  against its plain version (``_run_plain``) on the card over the same two
  corpora, every block: audio <= -120 dBFS per clip, every state leaf
  bit-equal, the lanes' onset counts and cooldowns equal, every stage's
  metrics within 1e-5 of max(1, |value|).

Each half writes its own entry of ``PORT_CERT.json`` (the other is kept),
stamped with the code it ran (``--sha``, else ``git_stamp()``: HEAD's sha
and, where the working tree differs from HEAD, the hashes git gives the
port's package and this tool as they stand on disk) and the date; the card
half also with the card's name and power limit. A half written elsewhere
(``--out`` on the card's machine) is copied in with ``--merge FILE``. The
tool exits non-zero when a bar fails, after writing the entry, which then
names the clip and the block where the residual first breaks it; for the
worst clip of a failing corpus it adds where that clip parts from JAX
(``explain_clip``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np

SR = 48000.0
BLOCK = 512
CLIPS = 512
BLOCKS = 94
SEED = 0xC0FFEE
THREADS = 4                                               # the CPU half's
CHAIN = [("punch", "Solar Snap"), ("saturator", "Amber Heat"),
         ("texture", None), ("motion", None), ("width", "Prism Arc"),
         ("cohere", None), ("infer", "Reference Lens")]    # bench.py:41-49
CORPORA = ("gel", "mixed")
NMAT = 5
CPU_BAR_DBFS = -80.0
CPU_MEDIAN_DBFS = -100.0
CARD_BAR_DBFS = -120.0
SCORE_TOL = 1e-5


def make_clips() -> np.ndarray:
    """The certification corpus [CLIPS, 2, BLOCKS * BLOCK]."""
    before = set(os.environ)
    from tools.certify_onchip import make_clips as _make

    # that module sets JAX cache variables on import; this tool uses none
    for key in set(os.environ) - before:
        del os.environ[key]
    return _make(CLIPS, BLOCKS * BLOCK, SEED)


def materials(corpus: str):
    return None if corpus == "gel" else np.arange(CLIPS) % NMAT


def dbfs(x: np.ndarray) -> np.ndarray:
    """Max-abs residuals -> dBFS (an exact zero is -inf)."""
    with np.errstate(divide="ignore"):
        return 20.0 * np.log10(x)


def per_block_residual(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Max-abs residual of each clip in each block: [B, nb]."""
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    bsz, c, t = d.shape
    return d.reshape(bsz, c, t // BLOCK, BLOCK).max(axis=(1, 3))


def first_break(res_blocks: np.ndarray, bar_dbfs: float):
    """(clip, block) where the residual first breaks the bar: the earliest
    block over all clips, the lowest clip index within it; None if none."""
    over = res_blocks > 10.0 ** (bar_dbfs / 20.0)
    if not over.any():
        return None
    blocks = np.where(over.any(axis=0))[0]
    blk = int(blocks[0])
    return {"clip": int(np.where(over[:, blk])[0][0]), "block": blk}


def _num(x: float):
    """A JSON number; -inf (an exact match) as null."""
    return None if math.isinf(x) else round(float(x), 2)


def audio_summary(res_blocks: np.ndarray, bar_dbfs: float,
                  median_dbfs: float = None) -> dict:
    db = dbfs(res_blocks.max(axis=1))
    worst = int(np.argmax(db))
    summary = {
        "median_dbfs": _num(float(np.median(db))),
        "worst_dbfs": _num(float(db[worst])),
        "worst_clip": worst,
        "exact_clips": int(np.isneginf(db).sum()),
        "share_within_bar": float((db <= bar_dbfs).mean()),
        "bar_dbfs": bar_dbfs,
        "first_break": first_break(res_blocks, bar_dbfs),
        "per_clip_dbfs": [_num(v) for v in db],
    }
    ok = summary["share_within_bar"] == 1.0
    if median_dbfs is not None:
        summary["median_bar_dbfs"] = median_dbfs
        ok = ok and float(np.median(db)) <= median_dbfs
    summary["pass"] = bool(ok)
    return summary


def score_summary(port: np.ndarray, ref: np.ndarray) -> dict:
    """`port`, `ref`: last-block scores [stages, B]."""
    rel = np.abs(port.astype(np.float64) - ref) / np.maximum(
        1.0, np.abs(ref.astype(np.float64)))
    s, c = np.unravel_index(int(np.argmax(rel)), rel.shape)
    return {"worst_rel": float(rel.max()),
            "worst_stage": CHAIN[s][0], "worst_clip": int(c),
            "tol": SCORE_TOL, "pass": bool(rel.max() <= SCORE_TOL),
            "per_stage_worst_rel": {CHAIN[i][0]: float(rel[i].max())
                                    for i in range(len(CHAIN))}}


CERTIFIED = ("juicy_tpu_torch", "tools/certify_port.py")


def git_stamp() -> str:
    """HEAD's sha, and where the working tree differs from HEAD in the
    code a half runs (``CERTIFIED``), the object ids git gives that code
    as it stands on disk: ``git rev-parse <commit>:<path>`` finds the same
    ids in the commit that holds it. Hashed through a scratch index, so
    the repository's own index is left as it is."""
    def git(*cmd, env=None):
        proc = subprocess.run(["git", *cmd], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=60)
        return proc.stdout.strip() if proc.returncode == 0 else None

    try:
        head = git("rev-parse", "HEAD")
        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ, GIT_INDEX_FILE=os.path.join(tmp, "index"))
            git("read-tree", "HEAD", env=env)
            git("add", "-A", "--", *CERTIFIED, env=env)
            tree = git("write-tree", env=env)
    except OSError:
        return "unknown"
    if head is None or tree is None:
        return "unknown"
    ids = {path: git("rev-parse", "-q", "--verify", f"{tree}:{path}")
           for path in CERTIFIED}
    if all(ids[path] == git("rev-parse", "-q", "--verify", f"HEAD:{path}")
           for path in CERTIFIED):
        return head
    return f"{head} + the working tree (" + ", ".join(
        f"{path} {ids[path]}" for path in CERTIFIED) + ")"


def stamp(args) -> dict:
    return {"sha": args.sha or git_stamp(),
            "date": time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime()),
            "clips": CLIPS, "blocks": BLOCKS, "seed": SEED,
            "block_size": BLOCK, "sample_rate": SR,
            "chain": [list(s) for s in CHAIN],
            "corpus": "tools/certify_onchip.py::make_clips"}


# ---------------------------------------------------------------------------
# The CPU half: the port against JAX
# ---------------------------------------------------------------------------

def _jax_refs():
    """Run in the no-FMA subprocess (tests/torch_jax_ref.py): JAX's
    fused_chain_stream op by op (CERT_RUN "op") or its jitted
    run_corpus_chain ("jit") over the corpus that CERT_CORPUS names, or
    one clip's explanation ("explain": clip CERT_EXPLAIN)."""
    import jax
    import jax.numpy as jnp

    from juicy_tpu.parallel.corpus import run_corpus_chain
    from juicy_tpu.runtime.chain_fused import fused_chain_stream
    from juicy_tpu.runtime.plugin import Chain

    corpus = os.environ["CERT_CORPUS"]
    clips = make_clips()
    mats = materials(corpus)
    if os.environ["CERT_RUN"] == "explain":
        idx = int(os.environ["CERT_EXPLAIN"])
        return jax_explain(clips[idx], None if mats is None
                           else int(mats[idx]))
    b = CLIPS
    chain = Chain(CHAIN, SR, 2, BLOCK)
    op_chain = Chain(CHAIN, SR, 2, BLOCK)
    if mats is not None:
        op_chain.plugins[2] = op_chain.plugins[2].with_traced("material")
        op_chain.params[2] = dict(op_chain.params[2],
                                  material=jnp.asarray(mats, jnp.float32))
    out = {}
    t0 = time.perf_counter()
    if os.environ["CERT_RUN"] == "jit":
        o, ms, _agg = run_corpus_chain(chain, jnp.asarray(clips),
                                       metrics="final", materials=mats)
        out["out"] = np.asarray(o)
        out["scores"] = np.stack([np.asarray(m["score"]) for m in ms])
        out["seconds"] = np.float64(time.perf_counter() - t0)
        return out
    states = jax.vmap(lambda _: op_chain.init_state())(jnp.arange(b))
    o, _st, ms = fused_chain_stream(op_chain, states, jnp.asarray(clips),
                                    metrics="blocks")
    out["out"] = np.asarray(o)
    out["scores"] = np.stack([np.asarray(m["score"])[-1] for m in ms])
    out["seconds"] = np.float64(time.perf_counter() - t0)
    return out


def jax_explain(x: np.ndarray, material=None, prefixes=None) -> dict:
    """One clip [2, T] through JAX's two executors, stage by stage (JAX
    only; run it in the no-FMA subprocess): the fused executor op by op
    over each prefix of the chain ("fused/k", k stages; only k in
    `prefixes` when given), and stage-major, each stage's ``Plugin.run``
    jitted on the previous one's output ("stage/k"). `material`:
    texture's, when not gel."""
    import jax
    import jax.numpy as jnp

    from juicy_tpu.runtime.chain_fused import fused_chain_stream
    from juicy_tpu.runtime.plugin import Chain, Plugin

    out = {}
    for k in prefixes or range(1, len(CHAIN) + 1):
        chain = Chain(CHAIN[:k], SR, 2, BLOCK)
        if material is not None and k > 2:
            chain.plugins[2] = chain.plugins[2].with_traced("material")
            chain.params[2] = dict(chain.params[2], material=jnp.asarray(
                [material], jnp.float32))
        states = jax.vmap(lambda _: chain.init_state())(jnp.arange(1))
        o, _st, _m = fused_chain_stream(chain, states, jnp.asarray(x[None]))
        out[f"fused/{k}"] = np.asarray(o)[0]
    cur = jnp.asarray(x)
    for k, (name, preset) in enumerate(CHAIN, start=1):
        plug = Plugin(name, SR, 2, BLOCK)
        if name == "texture" and material is not None:
            plug = plug.with_static(material=material)
        params = plug.preset(preset) if preset else plug.default_params()
        cur, _st, _m = jax.jit(plug.run)(params, plug.init_state(), cur)
        out[f"stage/{k}"] = np.asarray(cur)
    return out


def width_dips(x: np.ndarray):
    """Width's block-local shrink test on its input [2, T]
    (models/width.py): corr_proxy = clip(l * r * 12, -1, 1) < -0.1."""
    c = np.clip(x[0] * x[1] * np.float32(12.0), np.float32(-1.0),
                np.float32(1.0))
    return c, c < np.float32(-0.1)


def port_stage_outputs(x: np.ndarray, material=None) -> dict:
    """One clip [2, T] through the port's main path on the CPU
    (``run_corpus_chain``: the chain kernel's plain version, each stage's
    model between its lanes, block by block), each stage's output recorded
    as it leaves the stage: {k: [2, T]} after k stages."""
    import torch

    from juicy_tpu_torch.parallel.corpus import run_corpus_chain
    from juicy_tpu_torch.runtime.plugin import Chain

    chain = Chain(CHAIN, SR, 2, BLOCK)
    outs = {k: [] for k in range(1, len(CHAIN) + 1)}
    for k, plug in enumerate(chain.plugins, start=1):
        def process(p, carry, block, sr, _f=plug.defn.process, _o=outs[k]):
            y, carry = _f(p, carry, block, sr)
            _o.append(y[0].clone())
            return y, carry
        plug.defn = dataclasses.replace(plug.defn, process=process)
    mats = None if material is None else np.asarray([material])
    out, _ms, _agg = run_corpus_chain(chain, torch.from_numpy(x[None]),
                                      materials=mats, device="cpu")
    rec = {k: torch.cat(v, dim=-1).numpy() for k, v in outs.items()}
    assert np.array_equal(rec[len(CHAIN)], out[0].numpy())
    return rec


def explain_clip(clips: np.ndarray, corpus: str, idx: int) -> dict:
    """Where one clip's port output parts from JAX's reference: the clip
    through JAX's two executors (``jax_explain``) and through the port's
    main path (``port_stage_outputs``), each stage's max-abs residual in
    dBFS between the three; where JAX's executors part at width, the
    samples where width's shrink test differs and its value there in
    each."""
    from tests.torch_jax_ref import no_fma_reference

    mats = materials(corpus)
    material = None if mats is None else int(mats[idx])
    os.environ.update(CERT_RUN="explain", CERT_EXPLAIN=str(idx),
                      CERT_CORPUS=corpus)
    with tempfile.TemporaryDirectory() as tmp:
        ref = no_fma_reference("tools.certify_port", "_jax_refs", tmp)
    port = port_stage_outputs(clips[idx], material)

    def db(a, b):
        return _num(float(dbfs(np.max(np.abs(a.astype(np.float64) - b)))))

    stages, parting = [], None
    for k, (name, _p) in enumerate(CHAIN, start=1):
        fused, stage = ref[f"fused/{k}"], ref[f"stage/{k}"]
        row = {"stage": name,
               "jax_fused_vs_jax_stage_major_dbfs": db(fused, stage),
               "port_vs_jax_stage_major_dbfs": db(port[k], stage),
               "port_vs_jax_fused_dbfs": db(port[k], fused)}
        stages.append(row)
        if parting is None and (row["jax_fused_vs_jax_stage_major_dbfs"]
                                or -999) > CPU_BAR_DBFS:
            parting = k
    rec = {"clip": idx,
           "port": "the main path (run_corpus_chain on the CPU), each "
                   "stage's output as it leaves the stage",
           "stages": stages,
           "executors_part_at": None if parting is None
           else CHAIN[parting - 1][0],
           "port_follows_jax_stage_major": all(
               (r["port_vs_jax_stage_major_dbfs"] or -999) <= CPU_MEDIAN_DBFS
               for r in stages)}
    if parting is not None and CHAIN[parting - 1][0] == "width":
        ins = {"jax_fused": ref[f"fused/{parting - 1}"],
               "jax_stage_major": ref[f"stage/{parting - 1}"],
               "port": port[parting - 1]}
        dips = {key: width_dips(v) for key, v in ins.items()}
        where = np.where(dips["jax_fused"][1]
                         != dips["jax_stage_major"][1])[0]
        rec["width_shrink_test"] = {
            "samples_differing_fused_vs_stage_major": where[:8].tolist(),
            "port_flags_equal_jax_stage_major": bool(np.array_equal(
                dips["port"][1], dips["jax_stage_major"][1])),
            "port_flags_equal_jax_fused": bool(np.array_equal(
                dips["port"][1], dips["jax_fused"][1])),
            "first_sample": int(where[0]) if len(where) else None,
            "block": int(where[0]) // BLOCK if len(where) else None,
            "corr_proxy_at_first": {
                key: float(v[0][where[0]]) for key, v in dips.items()}
            if len(where) else None,
            "threshold": -0.1}
    return rec


def port_run(clips: np.ndarray, corpus: str):
    """The port's main path on the CPU: (out, last-block scores [7, B],
    seconds)."""
    from juicy_tpu_torch.parallel.corpus import run_corpus_chain
    from juicy_tpu_torch.runtime.plugin import Chain

    chain = Chain(CHAIN, SR, 2, BLOCK)
    t0 = time.perf_counter()
    out, ms, _agg = run_corpus_chain(chain, clips, metrics="blocks",
                                     materials=materials(corpus),
                                     device="cpu")
    scores = np.stack([m["score"][-1].numpy() for m in ms])
    return out.numpy(), scores, time.perf_counter() - t0


def half_cpu(args) -> dict:
    import torch

    from tests.torch_jax_ref import no_fma_reference

    torch.set_num_threads(THREADS)
    clips = make_clips()
    entry = dict(stamp(args), torch_threads=THREADS,
                 reference="JAX fused_chain_stream op by op, XLA:CPU "
                           "without FMA (tests/torch_jax_ref.py)",
                 beside="JAX run_corpus_chain, jitted", corpora={})
    ok = True
    for corpus in CORPORA:
        out, scores, secs = port_run(clips, corpus)
        print(f"{corpus}: port {secs:.1f} s", flush=True)
        ref = {}
        for run in ("op", "jit"):
            os.environ.update(CERT_CORPUS=corpus, CERT_RUN=run)
            with tempfile.TemporaryDirectory() as tmp:
                got = no_fma_reference("tools.certify_port", "_jax_refs",
                                       tmp)
            ref.update({f"{run}/{k}": v for k, v in got.items()})
            print(f"{corpus}: JAX {run} {float(got['seconds']):.1f} s",
                  flush=True)
        res_op = per_block_residual(out, ref["op/out"])
        res_jit = per_block_residual(out, ref["jit/out"])
        rec = {
            "materials": "arange(B) % 5" if corpus == "mixed" else "gel",
            "port_seconds": secs,
            "jax_op_seconds": float(ref["op/seconds"]),
            "jax_jit_seconds": float(ref["jit/seconds"]),
            "audio_vs_op": audio_summary(res_op, CPU_BAR_DBFS,
                                         CPU_MEDIAN_DBFS),
            "scores_vs_op": score_summary(scores, ref["op/scores"]),
            "audio_vs_jit": audio_summary(res_jit, CPU_BAR_DBFS,
                                          CPU_MEDIAN_DBFS),
            "scores_vs_jit": score_summary(scores, ref["jit/scores"]),
            "jit_vs_op": audio_summary(
                per_block_residual(ref["jit/out"], ref["op/out"]),
                CPU_BAR_DBFS),
        }
        rec["pass"] = rec["audio_vs_op"]["pass"] and \
            rec["scores_vs_op"]["pass"]
        if not rec["audio_vs_op"]["pass"]:
            worst = rec["audio_vs_op"]["worst_clip"]
            rec["explain_worst_clip"] = explain_clip(clips, corpus, worst)
            print(f"{corpus}: clip {worst}: "
                  f"{json.dumps(rec['explain_worst_clip'])}", flush=True)
        ok = ok and rec["pass"]
        a, s = rec["audio_vs_op"], rec["scores_vs_op"]
        print(f"{corpus}: vs JAX op by op median {a['median_dbfs']} dBFS, "
              f"worst {a['worst_dbfs']} (clip {a['worst_clip']}), "
              f"{a['share_within_bar']:.2%} within {CPU_BAR_DBFS}; scores "
              f"worst {s['worst_rel']:.3g} ({s['worst_stage']}); vs jitted "
              f"median {rec['audio_vs_jit']['median_dbfs']}, worst "
              f"{rec['audio_vs_jit']['worst_dbfs']}", flush=True)
        entry["corpora"][corpus] = rec
    entry["pass"] = ok
    return entry


# ---------------------------------------------------------------------------
# The card half: the chain kernel against its plain version
# ---------------------------------------------------------------------------

def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def card_corpus(clips_gpu, corpus: str) -> dict:
    import torch

    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.parallel.corpus import with_materials
    from juicy_tpu_torch.runtime.plugin import Chain

    b = clips_gpu.shape[0]
    chain = Chain(CHAIN, SR, 2, BLOCK)
    mats = materials(corpus)
    if mats is not None:
        chain = with_materials(chain, mats)
    st0 = chain.init_state((b,), clips_gpu.device)
    launches = ck.chain_kernel_step.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_k, dsp_k, fin_k, acc_k, fit_k = ck._ordered(
        ck._run_cuda, chain, st0, clips_gpu, True)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    launches = ck.chain_kernel_step.launches - launches
    t0 = time.perf_counter()
    out_p, dsp_p, fin_p, acc_p, fit_p = ck._ordered(
        ck._run_plain, chain, st0, clips_gpu, True)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    res = per_block_residual(out_k.cpu().numpy(), out_p.cpu().numpy())
    rec = {"materials": "arange(B) % 5" if corpus == "mixed" else "gel",
           "kernel_seconds": t_k, "plain_seconds": t_p,
           "launches": launches,
           "audio": audio_summary(res, CARD_BAR_DBFS)}
    differ = []
    for s, (dk, dp) in enumerate(zip(dsp_k, dsp_p, strict=True)):
        for key in sorted(set(dk) | set(dp)):
            if key not in dk or key not in dp or dk[key].dtype != \
                    dp[key].dtype or not torch.equal(dk[key], dp[key]):
                differ.append(f"{CHAIN[s][0]}.{key}")
    rec["state_leaves_differing"] = differ
    rec["cooldowns_equal"] = bool(torch.equal(fin_k[..., 4, :],
                                              fin_p[..., 4, :]))
    rec["onset_counts_equal"] = bool(torch.equal(acc_k[..., 1, :],
                                                 acc_p[..., 1, :]))
    rec["onsets_total"] = int(acc_k[..., 1, :].sum())
    an0 = [st["analyzer"] for st in st0]
    an_k, m_k = ck.finalize_stream(chain, an0, fin_k, acc_k, fit_k)
    an_p, m_p = ck.finalize_stream(chain, an0, fin_p, acc_p, fit_p)
    worst = 0.0
    for s, (mk, mp) in enumerate(zip(m_k, m_p, strict=True)):
        for key, v in mp.items():
            rel = float(((mk[key].double() - v.double()).abs()
                         / v.double().abs().clamp(min=1.0)).max())
            worst = max(worst, rel)
        for key, v in an_p[s].items():
            if not torch.equal(an_k[s][key], v):
                differ.append(f"{CHAIN[s][0]}.analyzer.{key}")
    rec["metrics_worst_rel"] = worst
    rec["pass"] = bool(rec["audio"]["pass"] and not differ
                       and rec["cooldowns_equal"]
                       and rec["onset_counts_equal"] and worst <= SCORE_TOL
                       and launches == BLOCKS)
    return rec


def half_card(args) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("certify_port --half card: no CUDA device")
    smi = card_name()
    print(smi, flush=True)
    clips = torch.from_numpy(make_clips()).cuda()
    entry = dict(stamp(args), card=smi,
                 kind=torch.cuda.get_device_name(0),
                 reference="the chain kernel's plain version on the card "
                           "(chain_kernel.py::_run_plain)", corpora={})
    ok = True
    for corpus in CORPORA:
        rec = card_corpus(clips, corpus)
        a = rec["audio"]
        print(f"{corpus}: kernel {rec['kernel_seconds']:.2f} s "
              f"({rec['launches']} launches), plain "
              f"{rec['plain_seconds']:.1f} s; audio worst {a['worst_dbfs']} "
              f"dBFS (clip {a['worst_clip']}), {a['exact_clips']} clips "
              f"exact; state leaves differing {rec['state_leaves_differing']}"
              f"; cooldowns {rec['cooldowns_equal']}, onsets "
              f"{rec['onset_counts_equal']} ({rec['onsets_total']}); "
              f"metrics {rec['metrics_worst_rel']:.3g}", flush=True)
        ok = ok and rec["pass"]
        entry["corpora"][corpus] = rec
    entry["pass"] = ok
    return entry


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--half", choices=("cpu", "card"))
    ap.add_argument("--merge", metavar="FILE",
                    help="copy the halves of another PORT_CERT.json (e.g. a "
                         "card half written on another machine) into --out")
    ap.add_argument("--sha", help="the code certified, where the copy has "
                                  "no .git (default: git_stamp())")
    ap.add_argument("--out", default=str(ROOT / "PORT_CERT.json"))
    args = ap.parse_args(argv)
    if (args.half is None) == (args.merge is None):
        ap.error("give one of --half and --merge")
    try:
        with open(args.out) as f:
            cert = json.load(f)
    except FileNotFoundError:
        cert = {}
    if args.merge:
        with open(args.merge) as f:
            cert.update(json.load(f))
        with open(args.out, "w") as f:
            json.dump(cert, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"merged {args.merge} into {args.out}")
        return 0
    entry = half_cpu(args) if args.half == "cpu" else half_card(args)
    cert[args.half] = entry
    with open(args.out, "w") as f:
        json.dump(cert, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out} [{args.half}]: pass={entry['pass']}")
    return 0 if entry["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
