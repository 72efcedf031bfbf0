"""PyTorch port vs JAX: per-block parameter automation.

JAX's numbers come from one process without FMA contraction
(tests/torch_jax_ref.py). The port's side runs on the CPU:

- ``runtime/stream.py`` (``automation_curve``, ``pad_to_blocks``,
  ``metrics_to_rows``) bit-equal to JAX's;
- ``Plugin.run(automation=)`` on punch, as tests/test_runtime.py:177, and
  ``run_corpus(automation=)`` (the stage kernel's plain version and
  ``Plugin.batched_run``, each block with its own parameter set) against
  JAX's ``run_corpus``: audio <= -110 dBFS;
- the seven-stage chain with a drive, a mix and infer's sensitivity
  automated (tests/test_parallel.py:280, tests/test_chain_kernel.py:234):
  the chain kernel's plain version (``chain_kernel_stream_plain``), the
  block-major executor (``fused_chain_stream``) and ``run_corpus_chain``
  on both routes against JAX's ``fused_chain_stream(automation=)``, and a
  reordered chain on the executor: audio <= -100 dBFS, every stage's
  metrics within 1e-5 of max(1, |value|) (cohere's context fit of its
  0..100 range);
- the refusals: a curve of the wrong length, an unknown param, ``params``
  together with ``automation``, and texture's material on the kernels.

Each test makes its inputs from its own numpy seed.
"""

import numpy as np
import pytest
import torch

from juicy_tpu_torch.kernels import chain_kernel as ck
from juicy_tpu_torch.kernels import stage_kernels as sk
from juicy_tpu_torch.parallel.corpus import run_corpus, run_corpus_chain
from juicy_tpu_torch.runtime import stream as tstream
from juicy_tpu_torch.runtime.chain_fused import (block_params,
                                                 chain_automation,
                                                 fused_chain_stream)
from juicy_tpu_torch.runtime.plugin import Chain as TChain
from juicy_tpu_torch.runtime.plugin import Plugin as TPlugin
from juicy_tpu_torch.utils.from_jax import to_numpy
from tests.conftest import make_clip, residual_dbfs
from tests.test_torch_punch_motion import assert_metrics_close, burst_clips
from tests.torch_jax_ref import no_fma_reference

SR = 48000.0
N, NB, B = 64, 3, 6
CURVE_INPUTS = ([0.0, 1.5], np.linspace(0.0, 1.5, 32), [2.0], 0.7,
                [0.3, 0.9, 0.1, 0.5, 0.2])
PUNCH_AUTO = {"punch": [0.2, 1.4, 0.7, 1.1]}
CHAIN_AUTO = {0: {"mix": [0.3, 0.9, 0.6]}, 1: {"drive": [3.0, 15.0, 9.0]},
              6: {"sensitivity": [0.5, 1.5, 1.0]}}
REORDER = (1, 0, 2, 3, 4, 5, 6)


def _stages(order=None):
    """bench.py's chain with texture wood (its ring) and cohere learning."""
    stages = [("punch", "Solar Snap"), ("saturator", "Amber Heat"),
              ("texture", {"material": 2}), ("motion", None),
              ("width", "Prism Arc"), ("cohere", {"learn": 1.0, "match": 0.9}),
              ("infer", "Reference Lens")]
    return stages if order is None else [stages[i] for i in order]


def _auto(order=None):
    """CHAIN_AUTO's curves at the stages' places in `order`."""
    if order is None:
        return CHAIN_AUTO
    return {order.index(i): curves for i, curves in CHAIN_AUTO.items()}


def _punch_clips():
    rng = np.random.default_rng(11)
    return np.stack([make_clip(rng, 2, 4 * N) for _ in range(4)])


def _jax_automation_refs():
    """JAX's stream helpers, punch with automation (run and run_corpus) and
    the chain's fused executor with automation (run without FMA)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from juicy_tpu.parallel.corpus import run_corpus as j_run_corpus
    from juicy_tpu.runtime import stream as jstream
    from juicy_tpu.runtime.chain_fused import fused_chain_stream as j_stream
    from juicy_tpu.runtime.plugin import Chain, Plugin

    out = {}
    for i, v in enumerate(CURVE_INPUTS):
        out[f"curve/{i}"] = np.asarray(jstream.automation_curve(v, 7))
    padded, t = jstream.pad_to_blocks(jnp.ones((2, 1000)), 512)
    out["pad"], out["pad_t"] = np.asarray(padded), np.asarray(t)
    clips = _punch_clips()
    plug = Plugin("punch", SR, 2, N)
    auto = {k: jnp.asarray(v, jnp.float32) for k, v in PUNCH_AUTO.items()}
    o, _st, m = plug.run(plug.default_params(), plug.init_state(),
                         jnp.asarray(clips[0]), automation=auto)
    out["run/out"], out["run/score"] = np.asarray(o), np.asarray(m["score"])
    single = Mesh(np.array(jax.devices()[:1]), ("data",))
    o, last, _agg = j_run_corpus(plug, plug.default_params(), clips,
                                 mesh=single, automation=auto)
    out["corpus/out"] = np.asarray(o)
    out.update({f"corpus/last/{k}": np.asarray(v) for k, v in last.items()})
    for tag, order in (("chain", None), ("reordered", REORDER)):
        chain = Chain(_stages(order), SR, 2, N)
        states = jax.vmap(lambda _: chain.init_state())(jnp.arange(B))
        o, st, ms = j_stream(chain, states, jnp.asarray(
            burst_clips(21, B, 2, NB * N)), automation={
                s: {k: jnp.asarray(v, jnp.float32) for k, v in c.items()}
                for s, c in _auto(order).items()})
        out[f"{tag}/out"] = np.asarray(o)
        for i, m in enumerate(ms):
            out.update({f"{tag}/{i}/{k}": np.asarray(v)
                        for k, v in jax.device_get(m).items()})
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_automation",
                            "_jax_automation_refs",
                            tmp_path_factory.mktemp("automation"))


def test_torch_stream_helpers_bit_equal(jax_ref):
    """automation_curve (linear interpolation in float32, a scalar held)
    and pad_to_blocks bit-equal to JAX's; metrics_to_rows one dict per
    block."""
    for i, v in enumerate(CURVE_INPUTS):
        got = tstream.automation_curve(v, 7)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), jax_ref[f"curve/{i}"])
    padded, t = tstream.pad_to_blocks(torch.ones((2, 1000)), 512)
    assert t == int(jax_ref["pad_t"]) == 1000
    np.testing.assert_array_equal(padded.numpy(), jax_ref["pad"])
    same, t = tstream.pad_to_blocks(torch.ones((2, 1024)), 512)
    assert t == 1024 and same.shape == (2, 1024)
    rows = tstream.metrics_to_rows({"score": torch.tensor([1.0, 2.5]),
                                    "peak": torch.tensor([0.5, 0.25])})
    assert rows == [{"peak": 0.5, "score": 1.0}, {"peak": 0.25, "score": 2.5}]


def test_torch_automation_curve_streaming(jax_ref):
    """Per-block automation of punch's amount through Plugin.run (BASELINE
    config #3) against JAX; it changes the render."""
    clip = torch.from_numpy(_punch_clips()[0])
    plug = TPlugin("punch", SR, 2, N)
    auto = {k: torch.tensor(v) for k, v in PUNCH_AUTO.items()}
    out, _st, m = plug.run(plug.default_params(),
                           plug.init_state((), "cpu"), clip, automation=auto)
    db = residual_dbfs(out.numpy(), jax_ref["run/out"])
    assert db <= -110.0, f"{db:.1f} dBFS"
    np.testing.assert_allclose(m["score"].numpy(), jax_ref["run/score"],
                               atol=1e-5 * 100)
    flat, _st, _m = plug.run(plug.default_params(),
                             plug.init_state((), "cpu"), clip)
    assert not torch.allclose(out, flat)


@pytest.mark.parametrize("use_kernel", ["auto", "never"])
def test_torch_run_corpus_automation(use_kernel, jax_ref):
    """run_corpus(automation=) runs each block with its own parameter set
    on either setting ("auto": the stage kernel's plain version on a CPU
    corpus, which counts no launch): audio and the last block's metrics
    against JAX's run_corpus."""
    plug = TPlugin("punch", SR, 2, N)
    launches = sk.punch_stage_step.launches
    out, last, agg = run_corpus(plug, plug.default_params(), _punch_clips(),
                                use_kernel=use_kernel,
                                automation=PUNCH_AUTO, device="cpu")
    assert sk.punch_stage_step.launches == launches
    db = residual_dbfs(out.numpy(), jax_ref["corpus/out"])
    assert db <= -110.0, f"{db:.1f} dBFS"
    assert_metrics_close({k: v.numpy() for k, v in last.items()},
                         {k[len("corpus/last/"):]: v
                          for k, v in jax_ref.items()
                          if k.startswith("corpus/last/")})
    assert 0.0 <= float(agg["score"]["min"]) <= 100.0


def test_torch_run_corpus_automation_mixed_texture():
    """Texture with a material per clip and its mix and damping automated:
    run_corpus on "auto" (the stage kernel's plain version over the corpus
    sorted by material, each block's constants from the curves) against
    "never" (batched_run, the traced model): audio <= -110 dBFS, last-block
    metrics within 1e-5 of max(1, |value|); the curves move the render."""
    plug = TPlugin("texture", SR, 2, N).with_traced("material")
    params = dict(plug.default_params(), material=torch.tensor(
        [0.0, 1.0, 2.0, 3.0, 4.0, 2.0], dtype=torch.float32))
    rng = np.random.default_rng(17)
    clips = np.stack([make_clip(rng, 2, NB * N) for _ in range(6)])
    auto = {"mix": [0.4, 1.0, 0.7], "damping": [0.2, 0.8, 0.5]}
    runs = {use: run_corpus(plug, params, clips, use_kernel=use,
                            automation=auto, device="cpu")
            for use in ("auto", "never")}
    (out_a, last_a, _), (out_n, last_n, _) = runs["auto"], runs["never"]
    db = residual_dbfs(out_a.numpy(), out_n.numpy())
    assert db <= -110.0, f"{db:.1f} dBFS"
    assert_metrics_close({k: v.numpy() for k, v in last_a.items()},
                         {k: v.numpy() for k, v in last_n.items()})
    flat, _last, _agg = run_corpus(plug, params, clips, device="cpu")
    assert residual_dbfs(out_a.numpy(), flat.numpy()) > -40.0


def _compare(tag, out, metrics, jax_ref):
    db = residual_dbfs(out.numpy(), jax_ref[f"{tag}/out"])
    print(f"{tag}: {db:.1f} dBFS vs JAX")
    assert db <= -100.0, f"{tag}: {db:.1f} dBFS"
    for i, m in enumerate(metrics):
        m = to_numpy(m)
        ref = {k: jax_ref[f"{tag}/{i}/{k}"] for k in m}
        fit = m.pop("context_fit", None)
        ref_fit = ref.pop("context_fit", None)
        assert_metrics_close(m, ref)
        if fit is not None:
            np.testing.assert_allclose(fit, ref_fit, rtol=0, atol=1e-5 * 100)


def _chain_case(order=None):
    chain = TChain(_stages(order), SR, 2, N)
    clips = torch.from_numpy(burst_clips(21, B, 2, NB * N))
    return chain, clips, chain.init_state((B,), "cpu")


@pytest.mark.parametrize("route", ["kernel_plain", "fused"])
def test_torch_chain_automation_vs_jax(route, jax_ref):
    """The chain's stream with automation on the kernel's plain version
    (what the chain kernel runs block by block: a constant row per block)
    and on the executor, against JAX's fused executor; the curves move the
    render from the unautomated stream's."""
    chain, clips, states = _chain_case()
    stream = ck.chain_kernel_stream_plain if route == "kernel_plain" \
        else fused_chain_stream
    out, _st, ms = stream(chain, states, clips, automation=CHAIN_AUTO)
    assert all(v.shape == (NB, B) for m in ms for v in m.values())
    _compare("chain", out, ms, jax_ref)
    flat, _st, _ms = stream(chain, chain.init_state((B,), "cpu"), clips)
    assert residual_dbfs(out.numpy(), flat.numpy()) > -40.0


@pytest.mark.parametrize("use_kernel", ["auto", "never"])
def test_torch_corpus_chain_automation(use_kernel, jax_ref):
    """run_corpus_chain(automation=) on both routes (tests/test_parallel.py
    :280): the kernel's plain version and the executor against JAX, one
    route against the other; a reordered chain, which the kernel does not
    take, automates on the executor."""
    chain, clips, _st = _chain_case()
    out, ms, agg = run_corpus_chain(chain, clips, metrics="blocks",
                                    use_kernel=use_kernel,
                                    automation=CHAIN_AUTO, device="cpu")
    _compare("chain", out, ms, jax_ref)
    assert 0.0 <= float(agg["score"]["mean"]) <= 100.0
    reordered, clips, _st = _chain_case(REORDER)
    assert not ck.supports_chain_kernel(reordered)
    out, ms, _agg = run_corpus_chain(reordered, clips, metrics="blocks",
                                     use_kernel=use_kernel,
                                     automation=_auto(REORDER), device="cpu")
    _compare("reordered", out, ms, jax_ref)


def test_torch_block_tables_per_clip_rows():
    """The automated chain kernel's constant rows with a material per clip
    (``block_tables`` over the ``ParamRows`` a mixed ``KernelChain`` builds
    from the chain's params): clip j of block i reads the row of block i's
    chain params with clip j's material, the same row as the static
    material's chain; without per-clip rows, one row per block."""
    mats = np.repeat([0, 2, 3], 32)
    b = len(mats)
    chain = TChain(_stages(), SR, 2, N)
    chain.plugins[2] = TPlugin("texture", SR, 2, N).with_traced("material")
    chain.params[2] = dict(
        {k: v for k, v in chain.params[2].items() if k != "material"},
        material=torch.tensor(mats, dtype=torch.float32))
    kc = ck.KernelChain(chain, chain.init_state((b,), "cpu"), b, "cpu")
    curves = chain_automation(chain, CHAIN_AUTO, NB)
    tables = ck.block_tables(kc, chain, curves, NB)
    assert tables.shape == (NB, b, ck.N_CONSTS)
    for i in range(NB):
        params = block_params(chain, curves, i)
        for j in (0, 40, b - 1):
            static = [dict(p) for p in params]
            static[2]["material"] = float(mats[j])
            want = ck._constants_cached(ck._chain_key(chain, static), SR, N)
            np.testing.assert_array_equal(tables[i, j].numpy(), want)
    flat = TChain(_stages(), SR, 2, N)
    kc = ck.KernelChain(flat, flat.init_state((b,), "cpu"), b, "cpu")
    assert ck.block_tables(kc, flat, curves, NB).shape == (NB, ck.N_CONSTS)


def test_torch_automation_refusals():
    """A curve needs one value per block of an existing param, not together
    with `params`; texture's material selects the kernel's code path and is
    refused there (JAX's ChainKernelUnsupported), on the stage kernel too;
    "always" needs a CUDA corpus."""
    chain, clips, states = _chain_case()
    with pytest.raises(ValueError, match="one value per block"):
        fused_chain_stream(chain, states, clips,
                           automation={1: {"drive": [1.0, 2.0]}})
    with pytest.raises(KeyError):
        ck.chain_kernel_stream_plain(chain, states, clips,
                                     automation={1: {"nope": [1.0] * NB}})
    with pytest.raises(ValueError, match="not both"):
        fused_chain_stream(chain, states, clips, params=chain.params,
                           automation={1: {"drive": [1.0] * NB}})
    with pytest.raises(ck.ChainKernelUnsupported, match="automated"):
        ck.chain_kernel_stream_plain(chain, states, clips,
                                     automation={2: {"material": [1.0] * NB}})
    plug = TPlugin("punch", SR, 2, N)
    with pytest.raises(ValueError, match="CUDA"):
        run_corpus(plug, plug.default_params(), _punch_clips(),
                   use_kernel="always", automation=PUNCH_AUTO, device="cpu")
    tex = TPlugin("texture", SR, 2, N).with_static(material=2)
    with pytest.raises(ValueError, match="cannot be automated"):
        run_corpus(tex, tex.default_params(), _punch_clips(),
                   automation={"material": [0.0, 1.0, 2.0, 3.0]}, device="cpu")
    with pytest.raises(KeyError):
        plug.run(plug.default_params(), plug.init_state((), "cpu"),
                 torch.zeros((2, 2 * N)), automation={"nope": [0.0, 1.0]})
