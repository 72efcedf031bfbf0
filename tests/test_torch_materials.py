"""PyTorch port vs JAX: per-clip texture materials.

JAX's numbers come from one process without FMA contraction
(tests/torch_jax_ref.py). The port's side runs on the CPU:

- texture's traced model (``process_traced``) against JAX's for each of
  the five materials, and bit-equal to the port's own static path
  (tests/test_processors.py:205); a mixed batch with per-clip knobs
  against JAX's traced model clip by clip;
- ``run_grouped`` (tests/test_parallel.py:110) and ``run_corpus`` on a
  ``with_traced("material")`` texture plugin (the stage kernel's plain
  version over the corpus sorted by material, and ``batched_run``)
  against JAX's ``run_grouped``;
- ``run_corpus_chain(materials=)`` (tests/test_parallel.py:425, 491) on
  the chain kernel's plain version (the corpus sorted into runs of 32)
  and on the executor, and ``fused_chain_stream`` with a traced material
  (tests/test_chain_fused.py:200), against JAX's fused executor with a
  traced material, run op by op (JAX's run_corpus_chain jits the whole
  executor, where XLA rewrites it further: -99.99 dBFS from the op-by-op
  run on one of these clips; ROADMAP.md Queue 3), on bench.py's chain
  with cohere learning and the burst input;
- ``StreamServer`` with per-stream materials (tests/test_serve.py:245)
  against JAX's server on the same script;
- on the port alone: ``MaterialOrder`` (runs padded to 32, the padding
  silent and dropped), ``cta_modes``, the kernel form of a mixed material
  state and back.

Bars (PERF.md section 2): single stages <= -110 dBFS (wood and plastic
<= -90), the chain, the executor and the server <= -100 dBFS with metrics
within 1e-5 of max(1, |value|). ``assert_material_ran`` checks which
material's state moved. Each test makes its inputs from its own numpy
seed.
"""

import numpy as np
import pytest
import torch

from juicy_tpu_torch.kernels import chain_kernel as ck
from juicy_tpu_torch.kernels import stage_kernels as sk
from juicy_tpu_torch.models import texture as ttex
from juicy_tpu_torch.parallel.corpus import run_corpus, run_corpus_chain
from juicy_tpu_torch.parallel.grouping import run_grouped
from juicy_tpu_torch.runtime.chain_fused import fused_chain_stream
from juicy_tpu_torch.runtime.plugin import Chain as TChain
from juicy_tpu_torch.runtime.plugin import Plugin as TPlugin
from juicy_tpu_torch.runtime.serve import StreamServer
from juicy_tpu_torch.utils.from_jax import to_numpy
from tests.conftest import make_clip, residual_dbfs
from tests.test_torch_punch_motion import assert_metrics_close, burst_clips
from tests.torch_jax_ref import assert_material_ran, no_fma_reference

SR = 48000.0
N = 64
BASE = {"tailshape": 0.55, "damping": 0.5, "weight": 0.45, "texture": 0.5,
        "mix": 1.0, "output": -2.0}
#: a mixed batch: every material, wood twice, ragged against 32
MIXED = [0, 1, 2, 3, 4, 2]
#: the chain corpus: every material, in no order
CHAIN_MATS = [3, 0, 4, 1, 2, 0, 2, 1, 3, 4, 0, 2]
SHORT_STAGES = [("punch", "Solar Snap"), ("texture", None), ("infer", None)]
SERVE_MATS = (0.0, 1.0, 2.0)


def _bar(material):
    return -90.0 if material in (2, 3) else -110.0


def _clips(seed, b, t):
    rng = np.random.default_rng(seed)
    return np.stack([make_clip(rng, 2, t) for _ in range(b)])


def _knobs(b):
    """Per-clip texture knobs for a mixed batch."""
    rng = np.random.default_rng(5)
    return {k: np.clip(v + 0.3 * rng.uniform(-1, 1, b), 0.0, 1.0).astype(
        np.float32) if k != "output" else np.full(b, v, np.float32)
        for k, v in BASE.items()}


def _chain_stages():
    """bench.py's chain with cohere learning (its targets move from block
    to block), texture's material left to the corpus."""
    return [("punch", "Solar Snap"), ("saturator", "Amber Heat"),
            ("texture", None), ("motion", None), ("width", "Prism Arc"),
            ("cohere", {"learn": 1.0, "match": 0.9}),
            ("infer", "Reference Lens")]


def _serve_script(server, clip):
    """Three streams, gel (the default), metal and wood set per stream,
    two ticks: the audio and scores of each."""
    sids = [server.open_stream() for _ in SERVE_MATS]
    for sid, m in zip(sids[1:], SERVE_MATS[1:]):
        server.set_params(sid, "texture", material=m)
    rec = {}
    for k in range(2):
        for i, sid in enumerate(sids):
            server.submit(sid, clip[:, k * N:(k + 1) * N] * np.float32(
                1.0 - 0.2 * i))
        res = server.tick()
        for i, sid in enumerate(sids):
            rec[f"{k}/{i}/audio"] = np.asarray(res[sid]["audio"])
            rec[f"{k}/{i}/score"] = np.asarray(res[sid]["score"])
    return rec


def _jax_material_refs():
    """JAX's traced texture per material and on a mixed batch, run_grouped,
    the grouped chain corpus on the executor, the fused executor with a
    traced material and the server with per-stream materials (run without
    FMA)."""
    import jax
    import jax.numpy as jnp

    from juicy_tpu.models import texture as jtex
    from juicy_tpu.parallel.grouping import run_grouped as j_grouped
    from juicy_tpu.runtime.chain_fused import fused_chain_stream as j_stream
    from juicy_tpu.runtime.plugin import Chain, Plugin
    from juicy_tpu.runtime.serve import StreamServer as JServer

    out = {}
    base = {k: jnp.float32(v) for k, v in BASE.items()}
    clip = _clips(1, 1, 2 * N)[0]
    for m in range(5):
        o, carry = jtex.process_traced(dict(base, material=jnp.int32(m)),
                                       jtex.init(SR, 2), jnp.asarray(clip),
                                       SR)
        out[f"traced/{m}/out"] = np.asarray(o)
        out.update({f"traced/{m}/{k}": np.asarray(v)
                    for k, v in jax.device_get(carry).items()})
    clips = _clips(2, len(MIXED), 2 * N)
    knobs = {k: jnp.asarray(v) for k, v in _knobs(len(MIXED)).items()}

    def one(c, m, kn):
        return jtex.process_traced(dict(kn, material=m), jtex.init(SR, 2),
                                   c, SR)

    o, carry = jax.vmap(one)(jnp.asarray(clips), jnp.asarray(MIXED, jnp.int32),
                             knobs)
    out["mixed/out"] = np.asarray(o)
    out.update({f"mixed/{k}": np.asarray(v)
                for k, v in jax.device_get(carry).items()})
    plug = Plugin("texture", SR, 2, N)
    o, scores = j_grouped(plug, plug.default_params(), clips, MIXED)
    out["grouped/out"], out["grouped/scores"] = np.asarray(o), \
        np.asarray(scores)
    # the executor op by op: under one jit (as JAX's run_corpus_chain runs
    # it) XLA rewrites the chain further and lands up to -99.99 dBFS from
    # this on these clips (ROADMAP.md Queue 3)
    chain = Chain(_chain_stages(), SR, 2, N)
    chain.plugins[2] = chain.plugins[2].with_traced("material")
    chain.params[2]["material"] = jnp.asarray(CHAIN_MATS, jnp.float32)
    states = jax.vmap(lambda _: chain.init_state())(jnp.arange(len(CHAIN_MATS)))
    o, _st, ms = j_stream(chain, states, jnp.asarray(
        burst_clips(31, len(CHAIN_MATS), 2, 2 * N)), metrics="blocks")
    out["chain/out"] = np.asarray(o)
    for i, m in enumerate(ms):
        out.update({f"chain/{i}/{k}": np.asarray(v)
                    for k, v in jax.device_get(m).items()})
    short = Chain(SHORT_STAGES, SR, 2, N)
    short.plugins[1] = short.plugins[1].with_traced("material")
    short.params[1]["material"] = jnp.asarray(MIXED, jnp.float32)
    states = jax.vmap(lambda _: short.init_state())(jnp.arange(len(MIXED)))
    o, _st, ms = j_stream(short, states, jnp.asarray(
        _clips(3, len(MIXED), 3 * N)), unroll=1)
    out["fused/out"] = np.asarray(o)
    out["fused/score"] = np.asarray(ms[-1]["score"])
    srv_chain = Chain(SHORT_STAGES, SR, 2, N)
    srv_chain.plugins[1] = srv_chain.plugins[1].with_traced("material")
    srv_chain.params[1]["material"] = jnp.float32(0.0)
    rec = _serve_script(JServer(srv_chain, max_streams=4),
                        _clips(4, 1, 2 * N)[0])
    out.update({f"serve/{k}": v for k, v in rec.items()})
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_materials",
                            "_jax_material_refs",
                            tmp_path_factory.mktemp("materials"))


@pytest.mark.parametrize("material", range(5))
def test_torch_traced_matches_static(material, jax_ref):
    """process_traced with one material is the static process bit for bit
    on the port, and JAX's process_traced within the stage bar; the
    material's own state moved and no other's."""
    clip = torch.from_numpy(_clips(1, 1, 2 * N)[0])
    base = {k: torch.tensor(v) for k, v in BASE.items()}
    init = ttex.init(SR, 2, device="cpu")
    out_t, carry_t = ttex.process_traced(
        dict(base, material=torch.tensor(material)), init, clip, SR)
    out_s, carry_s = ttex.process(dict(base, material=material), init, clip,
                                  SR)
    assert torch.equal(out_t, out_s)
    for key, v in carry_s.items():
        assert torch.equal(carry_t[key], v), key
    db = residual_dbfs(out_t.numpy(), jax_ref[f"traced/{material}/out"])
    print(f"material {material}: {db:.1f} dBFS vs JAX")
    assert db <= _bar(material), f"{db:.1f} dBFS"
    for key, v in to_numpy(carry_t).items():
        np.testing.assert_allclose(v, jax_ref[f"traced/{material}/{key}"],
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    assert_material_ran(init, carry_t, material)


def test_torch_traced_mixed_batch_vs_jax(jax_ref):
    """A batch with a material and knobs per clip through the traced model
    in one call: each clip against JAX's traced model for that clip (wood
    and plastic at their bar), every material's leaves carried."""
    clips = torch.from_numpy(_clips(2, len(MIXED), 2 * N))
    params = {k: torch.from_numpy(v) for k, v in _knobs(len(MIXED)).items()}
    params["material"] = torch.tensor(MIXED, dtype=torch.float32)
    init = ttex.init(SR, 2, (len(MIXED),), device="cpu")
    out, carry = ttex.process(params, init, clips, SR)
    for i, m in enumerate(MIXED):
        db = residual_dbfs(out[i].numpy(), jax_ref["mixed/out"][i])
        assert db <= _bar(m), (i, m, db)
        assert_material_ran({k: v[i] for k, v in init.items()},
                            {k: v[i] for k, v in carry.items()}, m)
    for key, v in to_numpy(carry).items():
        np.testing.assert_allclose(v, jax_ref[f"mixed/{key}"], rtol=1e-4,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("route", ["grouped", "auto", "never"])
def test_torch_mixed_texture_corpus_vs_jax(route, jax_ref):
    """run_grouped (one static sub-batch per material) and run_corpus with
    a material per clip on the stage kernel's plain version ("auto": the
    corpus sorted into runs of 32, put back once) and on batched_run
    ("never"), against JAX's run_grouped; each clip ran its material."""
    clips = _clips(2, len(MIXED), 2 * N)
    if route == "grouped":
        plug = TPlugin("texture", SR, 2, N)
        out, scores = run_grouped(plug, plug.default_params(), clips, MIXED,
                                  device="cpu")
    else:
        plug = TPlugin("texture", SR, 2, N).with_traced("material")
        params = dict(plug.default_params(),
                      material=torch.tensor(MIXED, dtype=torch.float32))
        before = sk.texture_stage_step.launches
        out, last, agg = run_corpus(plug, params, clips, use_kernel=route,
                                    device="cpu")
        assert sk.texture_stage_step.launches == before
        scores = last["score"]
        assert out.shape == clips.shape and last["score"].shape == \
            (len(MIXED),)
        assert float(agg["score"]["mean"]) == pytest.approx(
            float(torch.mean(last["score"])))
    for i, m in enumerate(MIXED):
        db = residual_dbfs(out[i].numpy(), jax_ref["grouped/out"][i])
        assert db <= _bar(m), (route, i, m, db)
    np.testing.assert_allclose(scores.numpy(), jax_ref["grouped/scores"],
                               atol=1e-5 * 100)


def _compare_chain(tag, out, metrics, jax_ref):
    db = residual_dbfs(out.numpy(), jax_ref[f"{tag}/out"])
    print(f"{tag}: {db:.1f} dBFS vs JAX")
    assert db <= -100.0, f"{tag}: {db:.1f} dBFS"
    for i, m in enumerate(metrics):
        m = to_numpy(m)
        ref = {k: jax_ref[f"{tag}/{i}/{k}"] for k in m}
        fit, ref_fit = m.pop("context_fit", None), ref.pop("context_fit", None)
        assert_metrics_close(m, ref)
        if fit is not None:
            np.testing.assert_allclose(fit, ref_fit, rtol=0, atol=1e-5 * 100)


@pytest.mark.parametrize("use_kernel", ["auto", "never"])
def test_torch_corpus_chain_materials_vs_jax(use_kernel, jax_ref):
    """run_corpus_chain(materials=) on the chain kernel's plain version (the
    corpus sorted by material into runs padded to 32 and put back once:
    the padding reaches neither the output nor the aggregates) and on the
    executor (texture's traced model), against JAX's executor with the
    same materials."""
    chain = TChain(_chain_stages(), SR, 2, N)
    clips = burst_clips(31, len(CHAIN_MATS), 2, 2 * N)
    out, ms, agg = run_corpus_chain(chain, clips, metrics="blocks",
                                    use_kernel=use_kernel,
                                    materials=CHAIN_MATS, device="cpu")
    assert out.shape == clips.shape
    assert all(v.shape == (2, len(CHAIN_MATS)) for m in ms for v in m.values())
    _compare_chain("chain", out, ms, jax_ref)
    # the aggregates over the corpus's own clips only (every block here)
    assert float(agg["score"]["max"]) == float(ms[-1]["score"].max())
    assert float(agg["score"]["min"]) == float(ms[-1]["score"].min())
    none, ms_q, _ = run_corpus_chain(chain, clips, metrics="final",
                                     use_kernel=use_kernel,
                                     materials=CHAIN_MATS,
                                     return_audio=False, device="cpu")
    assert none is None
    for m, m_q in zip(ms, ms_q, strict=True):
        for key, v in m_q.items():
            assert torch.equal(v, m[key][-1]), key


def test_torch_fused_mixed_materials_vs_jax(jax_ref):
    """The executor with a traced-material texture stage renders each clip
    with its own material (tests/test_chain_fused.py:200)."""
    chain = TChain(SHORT_STAGES, SR, 2, N)
    chain.plugins[1] = chain.plugins[1].with_traced("material")
    chain.params[1]["material"] = torch.tensor(MIXED, dtype=torch.float32)
    clips = torch.from_numpy(_clips(3, len(MIXED), 3 * N))
    out, _st, ms = fused_chain_stream(chain, chain.init_state(
        (len(MIXED),), "cpu"), clips)
    db = residual_dbfs(out.numpy(), jax_ref["fused/out"])
    assert db <= -100.0, f"{db:.1f} dBFS"
    assert_metrics_close({"score": ms[-1]["score"].numpy()},
                         {"score": jax_ref["fused/score"]})


def test_torch_stream_server_per_stream_materials(jax_ref):
    """Tenants pick their texture material per stream: a traced-material
    stage makes `material` a per-slot row, served on the executor; the
    same script on JAX's server (tests/test_serve.py:245)."""
    chain = TChain(SHORT_STAGES, SR, 2, N)
    chain.plugins[1] = chain.plugins[1].with_traced("material")
    chain.params[1]["material"] = torch.tensor(0.0)
    server = StreamServer(chain, 4, device="cpu")
    assert not server._kernel_tick
    rec = _serve_script(server, _clips(4, 1, 2 * N)[0])
    for key, v in rec.items():
        ref = jax_ref[f"serve/{key}"]
        if key.endswith("audio"):
            db = residual_dbfs(v, ref)
            assert db <= -100.0, (key, db)
        else:
            assert abs(float(v) - float(ref)) <= 1e-5 * max(1.0, abs(float(ref)))
    assert residual_dbfs(rec["1/0/audio"], rec["1/1/audio"]) > -40.0


def test_torch_material_order():
    """MaterialOrder: the clips sorted by material (stable), each run padded
    to 32 with copies of its first clip, silent; scatter inverts gather and
    drops the padding; cta_modes gives one material per CTA and refuses a
    CTA that mixes two; cta_uniform tells the two apart."""
    mode = torch.tensor(CHAIN_MATS)
    order = sk.MaterialOrder(mode)
    assert len(order.take) == 32 * len(set(CHAIN_MATS))
    assert sk.cta_uniform(order.mode) and not sk.cta_uniform(mode)
    for m in set(CHAIN_MATS):
        run = order.take[order.mode == m]
        real = run[~order.pad[order.mode == m]]
        assert torch.equal(real, torch.nonzero(mode == m)[:, 0])
        assert bool(torch.all(run[len(real):] == real[0]))
    x = torch.arange(len(CHAIN_MATS), dtype=torch.float32)[:, None] + 1.0
    y = order.clips(x)
    assert bool(torch.all(y[order.pad] == 0.0))
    assert torch.equal(order.scatter(order.gather(x)), x)
    cta, mask = sk.cta_modes(order.mode, len(order.take), "cpu")
    assert cta.tolist() == sorted(set(CHAIN_MATS))
    assert mask == sum(1 << m for m in set(CHAIN_MATS))
    with pytest.raises(ValueError, match="MaterialOrder"):
        sk.cta_modes(mode, len(CHAIN_MATS), "cpu")
    ragged = torch.tensor([2] * 32 + [0] * 5)
    assert sk.cta_uniform(ragged)
    assert sk.cta_modes(ragged, 37, "cpu")[0].tolist() == [2, 0]


def test_torch_mixed_kernel_state_round_trip():
    """The kernel form of a mixed material state: the material leaves as
    [NMAT, B, 2] with each clip's own material's first (the largest NMAT
    present), the ring time-major with the wave clips' write index; back
    in the Chain form unchanged, the other clips' index untouched, and
    each clip's own leaves taken from the kernel form."""
    mats = torch.tensor([1.0] * 32 + [2.0] * 32 + [4.0] * 6)
    chain = TChain(_chain_stages(), SR, 2, N)
    chain.plugins[2] = chain.plugins[2].with_traced("material")
    chain.params[2] = dict(chain.params[2], material=mats)
    states = chain.init_state((70,), "cpu")
    g = torch.Generator().manual_seed(7)
    for st in states:
        for group in ("dsp", "analyzer"):
            for key, v in st[group].items():
                if v.dtype == torch.float32:
                    st[group][key] = torch.randn(v.shape, generator=g)
    states[2]["dsp"]["wave_idx"][32:64] = 9
    kc = ck.KernelChain(chain, states, 70, "cpu")
    assert kc.mixed and kc.tex_mat.shape == (9, 70, 2) and kc.tex_widx == 9
    assert kc.cta.tolist() == [1, 2, 4] and kc.cstride == ck.N_CONSTS
    dsps = kc.unpack(states, states[5]["dsp"]["context_fit"])
    for st, dsp in zip(states, dsps, strict=True):
        for key, v in st["dsp"].items():
            assert torch.equal(dsp[key], v), key
    kc.tex_mat.add_(1.0)
    kc.tex_widx = 11
    tex = kc.unpack(states, states[5]["dsp"]["context_fit"])[2]
    old = states[2]["dsp"]
    assert torch.equal(tex["modal_y1"][:64], old["modal_y1"][:64] + 1.0)
    assert torch.equal(tex["prev_wave"][32:64], old["prev_wave"][32:64] + 1.0)
    assert torch.equal(tex["prev_wave"][:32], old["prev_wave"][:32])
    assert torch.equal(tex["flesh_pos_a"][64:], old["flesh_pos_a"][64:] + 1.0)
    assert torch.equal(tex["spring_pos"], old["spring_pos"])
    assert bool(torch.all(tex["wave_idx"][32:64] == 11))
    assert torch.equal(tex["wave_idx"][:32], old["wave_idx"][:32])
