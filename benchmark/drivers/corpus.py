"""The corpus driver: a closed loop of one client that scores corpora
through ``run_corpus_chain``, one batch per call, back to back.

Set-up draws the traffic's corpora (and each clip's texture material,
where the mix asks for one per clip) on the device from the seed and runs
one warm batch of each corpus. The window then calls the entry point on
the corpora in turn, each call followed by a device synchronize, until
`seconds` have passed; every batch is timed from its call to the end of
its synchronize. After the window the last batch of each corpus is held
to the plain reference (benchmark/reference) on a sample of its clips
drawn from the seed: their audio, where the mix returns it, and every
stage's final-block metrics.

The driver keeps the contract of benchmark/harness.py: ``run(cell)``;
``tiny(traffic)``, the mix cut to 6 clips of 2 blocks, one corpus, 4 clips
checked, which runs every path of ``run`` on the CPU in seconds; and
``FAULTS``, the faults planted under the timed path, one of each kind:
``state_unchanged`` (every block of the chain starts from the state the
block before started from), ``half_batch`` (the second half of the clips
left out, given the mean of the rest) and ``altered_answer`` (one sample
of each clip's audio and each clip's final score changed where
``run_corpus_chain`` returns them).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import compare, inputs
from benchmark.work import MATERIALS, block_bound

N_MATERIALS = len(MATERIALS)


def _sync(devices):
    import torch

    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def _load_library():
    """Build (where the sources have no library yet) and load the program's
    CUDA library; True where this call built it, None where the program has
    no such loader."""
    try:
        from juicy_tpu_torch.kernels import _build
        built = not _build.library_path().exists()
        _build.load_library()
    except (ImportError, AttributeError):
        return None
    return built


def materials_for(traffic, config, batch, seed, corpus):
    """Each clip's texture material [B], or None for the configuration's.
    ``uniform``: every material an equal share (the first B % 5 one clip
    more), in an order drawn from the seed: seeds differ in the order of
    the work, not in how much of each material there is."""
    how = traffic["materials"]
    if how == "config":
        return None
    if how == "uniform":
        return inputs.rng(seed, 1, corpus).permutation(
            np.arange(batch) % N_MATERIALS)
    raise ValueError(f"traffic materials {how!r}: config or uniform")


def check_clips(traffic, batch, mats, seed, corpus):
    """The clips of a corpus that the check compares, drawn from the seed,
    in corpus order: `check_clips` of them, spread over the materials
    present where each clip has its own."""
    g = inputs.rng(seed, 2, corpus)
    want = int(traffic["check_clips"])
    if mats is None:
        return np.sort(g.choice(batch, size=min(want, batch), replace=False))
    present = np.unique(mats)
    per = -(-want // len(present))
    picks = [g.choice(np.nonzero(mats == m)[0],
                      size=min(per, int(np.sum(mats == m))), replace=False)
             for m in present]
    return np.sort(np.concatenate(picks))


def draw(cell, i):
    """Corpus `i` of the run's seed on the cell's first device, [B, C, T],
    and its clips' texture materials (None for the configuration's)."""
    config, traffic = cell["config"], cell["traffic"]
    b = int(traffic["batch"])
    t = int(traffic["blocks"]) * int(config["block_size"])
    x = inputs.signal(traffic["signal"], b, int(config["channels"]), t,
                      float(config["sample_rate"]), cell["devices"][0],
                      inputs.sub_seed(cell["seed"], 0, i))
    return x, materials_for(traffic, config, b, cell["seed"], i)


def material_counts(config, mats, batch):
    """{material: clips} of a corpus: the configuration's for every clip,
    or each clip's own."""
    if mats is None:
        return {int(config["stages"][2][1]["material"]): batch}
    modes, counts = np.unique(mats, return_counts=True)
    return {int(m): int(k) for m, k in zip(modes, counts)}


def run(cell):
    """One run of a corpus cell: {"setup_s", "setup_parts", "e2e",
    "attempted", "failed", "memory_peak_bytes", "readings", "trace",
    "samples", ...}. One device takes the corpus whole; several split it
    over a mesh's ``data`` axis, as the program does for a user's cards."""
    import torch

    t0, parts = cell["t0"], dict(cell["parts"])
    config, traffic, devices = cell["config"], cell["traffic"], cell["devices"]
    cuda = [d for d in devices if torch.device(d).type == "cuda"]
    seed, seconds = cell["seed"], cell["seconds"]

    def part(name, since):
        now = time.perf_counter()
        parts[name] = now - since
        return now

    t = time.perf_counter()
    for d in cuda:                         # each card's context
        torch.zeros(1, device=d)
    _sync(cuda)
    t = part("context_s", t)
    from juicy_tpu_torch.parallel.corpus import run_corpus_chain
    from juicy_tpu_torch.parallel.mesh import make_mesh
    from juicy_tpu_torch.runtime.plugin import Chain

    from benchmark.tracing import Stretch
    t = part("program_import_s", t)
    if cuda:
        parts["library_built"] = _load_library()
    t = part("library_s", t)

    sr, c, n = (float(config["sample_rate"]), int(config["channels"]),
                int(config["block_size"]))
    b, nb = int(traffic["batch"]), int(traffic["blocks"])
    t_len = nb * n
    chain = Chain([(name, dict(p)) for name, p in config["stages"]], sr, c, n)
    where = ({"device": devices[0]} if len(devices) == 1
             else {"mesh": make_mesh(devices=devices)})

    corpora, mats = [], []
    for i in range(int(traffic["corpora"])):
        x, m = draw(cell, i)
        corpora.append(x)
        mats.append(m)
    mats_t = [None if m is None else torch.from_numpy(m) for m in mats]
    _sync(cuda)
    t = part("inputs_s", t)

    def call(i):
        return run_corpus_chain(chain, corpora[i], metrics=traffic["metrics"],
                                return_audio=bool(traffic["return_audio"]),
                                materials=mats_t[i], **where)

    for i in range(len(corpora)):          # every shape and order, once
        call(i)
    _sync(cuda)
    part("warm_s", t)
    for d in cuda:
        torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t0

    lat, last, stretch, tr, traced = [], {}, None, None, []
    w0 = time.perf_counter()
    k = 0
    while True:
        i = k % len(corpora)
        if cell["trace"] and stretch is None and tr is None \
                and time.perf_counter() - w0 >= seconds / 2:
            stretch = Stretch(int(traffic["trace_batches"]),
                              lambda: _sync(cuda))
        b0 = time.perf_counter()
        if stretch is not None:
            traced.append(i)
            last[i] = stretch.batch(lambda: call(i))
            if stretch.done():
                stretch.close()
                tr, stretch = stretch, None
        else:
            last[i] = call(i)
            _sync(cuda)
        b1 = time.perf_counter()
        lat.append(b1 - b0)
        k += 1
        if b1 - w0 >= seconds and stretch is None:
            break
    window_s = time.perf_counter() - w0
    peak = max([torch.cuda.max_memory_allocated(d) for d in cuda] or [0])

    # the check: sampled clips of each corpus's last batch
    xs, outs, mss, ref_mats = [], [], [], []
    for i, (out, ms, _agg) in sorted(last.items()):
        idx = check_clips(traffic, b, mats[i], seed, i)
        sel = torch.from_numpy(idx).to(corpora[i].device)
        xs.append(corpora[i].index_select(0, sel).cpu().numpy())
        if out is not None:
            outs.append(out.index_select(0, sel).cpu().numpy())
        mss.append([{key: v.index_select(0, sel).cpu().numpy()
                     for key, v in m.items()} for m in ms])
        ref_mats.append(mats[i][idx] if mats[i] is not None else None)
    out = ms = None
    trace = None
    if tr is not None:
        bounds = [block_bound(config, material_counts(config, mats[i], b))
                  for i in traced]
        trace = tr.read({"blocks": nb, "chips": len(devices),
                         "bound_ms": sum(v for v, _by in bounds) / len(bounds),
                         "bound_by": bounds[0][1]})
    del corpora, last, call, mats_t
    if cuda:
        torch.cuda.empty_cache()

    from benchmark.reference.chain import run_chain

    r0 = time.perf_counter()
    x = np.concatenate(xs)
    ref_out, ref_ms = run_chain(
        config, x, None if ref_mats[0] is None else np.concatenate(ref_mats))
    got = compare.readings(
        np.concatenate(outs) if outs else None,
        [{key: np.concatenate([m[s][key] for m in mss]) for key in mss[0][s]}
         for s in range(len(mss[0]))],
        ref_out, ref_ms)
    audio_s = b * t_len / sr
    return {
        "setup_s": setup_s, "setup_parts": parts, "devices": list(devices),
        "e2e": {"audio_s_per_s": len(lat) * audio_s / window_s,
                "latency_p90_ms": float(np.percentile(lat, 90)) * 1e3},
        "samples": {"latency_p90_ms": len(lat)},
        "batch_ms": [float(np.min(lat)) * 1e3, float(np.median(lat)) * 1e3,
                     float(np.max(lat)) * 1e3],
        "attempted": len(lat), "failed": 0,
        "memory_peak_bytes": int(peak),
        "readings": got, "reference_s": time.perf_counter() - r0,
        "checked_clips": int(x.shape[0]), "window_s": window_s,
        "trace": trace,
    }


def tiny(traffic):
    """The mix cut to run every path of ``run`` on the CPU in seconds."""
    return dict(traffic, batch=6, blocks=2, corpora=1, check_clips=4)


# ------------------------------------------------ faults under the timed path

def _state_unchanged(monkeypatch):
    """Each block starts from the state the block before started from."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    plain = ck.chain_block_plain

    def block(chain, dsps, lane_prev, blk):
        out, _new, fin, acc = plain(chain, dsps, lane_prev, blk)
        return out, dsps, fin, acc
    monkeypatch.setattr(ck, "chain_block_plain", block)


def _half_batch(monkeypatch):
    """The second half of the clips left out, given the mean of the rest."""
    from juicy_tpu_torch.parallel import corpus

    real = corpus.run_corpus_chain

    def half(chain, clips, **kw):
        b = clips.shape[0] // 2
        mats = kw.pop("materials", None)
        out, ms, agg = real(chain, clips[:b], materials=None if mats is None
                            else mats[:b], **kw)

        def fill(v):
            rest = v.mean(0, keepdim=True).expand(clips.shape[0] - b,
                                                  *v.shape[1:])
            return np.concatenate([v.numpy(), rest.numpy()])
        import torch
        out = None if out is None else torch.from_numpy(fill(out))
        return out, [{k: torch.from_numpy(fill(v)) for k, v in m.items()}
                     for m in ms], agg
    monkeypatch.setattr(corpus, "run_corpus_chain", half)


def _altered(monkeypatch):
    """One answer altered where it is produced: one sample of each clip's
    audio, and the final score of each clip."""
    from juicy_tpu_torch.parallel import corpus

    real = corpus.run_corpus_chain

    def alter(chain, clips, **kw):
        out, ms, agg = real(chain, clips, **kw)
        if out is not None:
            out[:, 0, 100] += 1e-3
        ms[-1]["score"] = ms[-1]["score"] + 0.5
        return out, ms, agg
    monkeypatch.setattr(corpus, "run_corpus_chain", alter)


#: {kind: plant(monkeypatch)}, each planted in the program for one run
FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "altered_answer": _altered}
