"""PyTorch port vs JAX: width, cohere, infer and the seven-stage Chain.

JAX's numbers come from one process without FMA contraction
(tests/torch_jax_ref.py), on seeded clips (`make_clip`):

- width through `Plugin.batch_step`, two blocks of 64, B = 8: the default
  preset, anticorrelated input (the block-local shrink fires), a zero Haas
  delay, and mono (the passthrough);
- cohere with learn off and on (the targets move), its `context_fit`
  metric from `finalize_metrics`;
- infer's `finalize_metrics` (sensitivity scaling and the slot remap);
- the Chain of bench.py's seven stages (punch "Solar Snap", saturator
  "Amber Heat", texture, motion, width "Prism Arc", cohere, infer
  "Reference Lens"): `batched_run` on B = 4 clips of two blocks, and `run`
  on one clip.

Bars: audio ≤ −110 dBFS for the single models and ≤ −100 for the Chain;
every metric within 1e-5 of its scale (max(1, |value|)); state within 1e-6.
Also the param specs and presets of all seven models against JAX, the
normalized mapping, and the JAX → port → numpy round trip of every model's
params and state (motion's uint32 `rng` at values ≥ 2³¹ included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from juicy_tpu.models.base import get_processor as j_get_processor
from juicy_tpu.runtime.plugin import Chain as JChain
from juicy_tpu.runtime.plugin import Plugin as JPlugin
from juicy_tpu_torch.models.base import get_processor as t_get_processor
from juicy_tpu_torch.runtime.plugin import Chain as TChain
from juicy_tpu_torch.runtime.plugin import Plugin as TPlugin
from juicy_tpu_torch.utils.from_jax import to_numpy, to_torch
from tests.conftest import make_clip, residual_dbfs
from tests.test_torch_punch_motion import _flat, assert_metrics_close
from tests.torch_jax_ref import no_fma_reference

SR = 48000.0
N = 64
B = 8
B_CHAIN = 4
CHAIN = [("punch", "Solar Snap"), ("saturator", "Amber Heat"),
         ("texture", None), ("motion", None), ("width", "Prism Arc"),
         ("cohere", None), ("infer", "Reference Lens")]
MODELS = ("punch", "saturator", "texture", "motion", "width", "cohere",
          "infer")
# case -> (model, channels, clip kind, params over the defaults, preset)
CASES = {
    "width_default": ("width", 2, "mixed", {}, "Prism Arc"),
    "width_anticorrelated": ("width", 2, "anticorrelated", {}, "Outer Halo"),
    "width_zero_haas": ("width", 2, "mixed", {"haasMs": 0.0}, None),
    "width_mono": ("width", 1, "mixed", {}, None),
    "cohere_learn_off": ("cohere", 2, "mixed", {}, None),
    "cohere_learn_on": ("cohere", 2, "mixed", {"learn": 1.0, "match": 0.9},
                        None),
    "infer": ("infer", 2, "mixed", {}, "Macro Meter"),
}


def _clips(seed, channels, kind, batch=B, blocks=2):
    rng = np.random.default_rng(seed)
    return np.stack([make_clip(rng, channels, blocks * N, kind=kind)
                     for _ in range(batch)]).astype(np.float32)


def _params(plug, extra, preset):
    params = plug.preset(preset) if preset else plug.default_params()
    params.update({k: np.float32(v) for k, v in extra.items()})
    return params


def _jax_chain_refs():
    """The JAX side of every case here (run without FMA)."""
    out = {}
    for i, (case, (name, c, kind, extra, preset)) in enumerate(CASES.items()):
        plug = JPlugin(name, SR, c, N)
        params = {k: jnp.float32(v) for k, v in
                  _params(plug, extra, preset).items()}
        st = jax.vmap(lambda _: plug.init_state())(jnp.arange(B))
        step = jax.jit(plug.batch_step)
        clips = _clips(i, c, kind)
        for k in range(2):
            o, st, m = step(params, st, jnp.asarray(clips[..., k * N:(k + 1) * N]))
            out.update(_flat(f"{case}/{k}", o, st, m))
    chain = JChain(CHAIN, SR, 2, N)
    clips = _clips(99, 2, "mixed", B_CHAIN)
    states = [jax.vmap(lambda _: p.init_state())(jnp.arange(B_CHAIN))
              for p in chain.plugins]
    o, _st, metrics = chain.batched_run(states, jnp.asarray(clips))
    out["chain/batched_run/out"] = np.asarray(o)
    o1, _st, metrics1 = jax.jit(chain.run)(chain.init_state(),
                                           jnp.asarray(clips[0]))
    out["chain/run/out"] = np.asarray(o1)
    for tag, ms in (("batched_run", metrics), ("run", metrics1)):
        for s, m in enumerate(ms):
            for key, v in jax.device_get(m).items():
                out[f"chain/{tag}/{s}/{key}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_chain", "_jax_chain_refs",
                            tmp_path_factory.mktemp("chain"))


@pytest.mark.parametrize("case", list(CASES))
def test_torch_model_vs_jax(case, jax_ref):
    name, c, kind, extra, preset = CASES[case]
    jplug, tplug = JPlugin(name, SR, c, N), TPlugin(name, SR, c, N)
    params = to_torch(_params(jplug, extra, preset), "cpu")
    state = to_torch(jax.device_get(
        jax.vmap(lambda _: jplug.init_state())(jnp.arange(B))), "cpu")
    init = to_numpy(state["dsp"])
    clips = _clips(list(CASES).index(case), c, kind)
    for k in range(2):
        out, state, m = tplug.batch_step(
            params, state, torch.from_numpy(clips[..., k * N:(k + 1) * N]))
        ref = {key.split("/", 2)[2]: v for key, v in jax_ref.items()
               if key.startswith(f"{case}/{k}/")}
        db = residual_dbfs(out.numpy(), ref["out"])
        print(f"{case} block {k}: {db:.1f} dBFS vs JAX")
        assert db <= -110.0, f"{case} block {k}: {db:.1f} dBFS"
        dsp = to_numpy(state["dsp"])
        assert set(dsp) == {key[4:] for key in ref if key.startswith("dsp/")}
        for key, v in dsp.items():
            np.testing.assert_allclose(v, ref[f"dsp/{key}"], atol=1e-6,
                                       err_msg=key)
        assert set(m) == {key[2:] for key in ref if key.startswith("m/")}
        assert_metrics_close({key: v.numpy() for key, v in m.items()},
                             {key: ref[f"m/{key}"] for key in m})
    final = to_numpy(state["dsp"])
    if case == "width_mono":
        assert torch.equal(out, torch.from_numpy(clips[..., N:]))
    elif name == "width":
        assert not np.array_equal(final["haas_window"], init["haas_window"])
    if case == "cohere_learn_on":
        assert not np.array_equal(final["target_low"], init["target_low"])
    elif name == "cohere":
        np.testing.assert_array_equal(final["target_low"], init["target_low"])


def test_torch_width_shrink_and_delay():
    """The shrink multiplies once per dip, in sample order, and restarts
    each block; the Haas delay truncates int(sr·haasMs·0.001)."""
    import juicy_tpu_torch.models.width as tw

    left = torch.tensor([[0.5, 0.5, 0.5, 0.5]])
    right = torch.tensor([[-0.5, 0.0, -0.5, -0.5]])
    seq = tw.width_shrink(left, right, torch.tensor(0.8), torch.tensor(0.5))
    w, lim = np.float32(0.8), np.float32(0.5)
    want = [w * lim, w * lim, w * lim * lim, w * lim * lim * lim]
    np.testing.assert_array_equal(seq.numpy(), np.float32([want]))
    assert int(tw.delay_samples(12.0, SR)) == 576
    assert int(tw.delay_samples(0.0299, SR)) == 1            # 1.4352 -> 1
    assert tw.delay_buffer_size(SR) == 1696


@pytest.mark.parametrize("how", ["batched_run", "run"])
def test_torch_chain_vs_jax(how, jax_ref):
    tchain = TChain(CHAIN, SR, 2, N)
    jchain = JChain(CHAIN, SR, 2, N)
    assert [p.defn.name for p in tchain.plugins] == list(MODELS)
    for tp, jp in zip(tchain.params, jchain.params, strict=True):
        assert set(tp) == set(jp)
        for k, v in to_numpy(tp).items():
            np.testing.assert_array_equal(v, np.asarray(jp[k]), err_msg=k)
    clips = torch.from_numpy(_clips(99, 2, "mixed", B_CHAIN))
    if how == "batched_run":
        out, states, metrics = tchain.batched_run(
            tchain.init_state((B_CHAIN,), "cpu"), clips)
    else:
        out, states, metrics = tchain.run(tchain.init_state(device="cpu"),
                                          clips[0])
    db = residual_dbfs(out.numpy(), jax_ref[f"chain/{how}/out"])
    print(f"chain {how}: {db:.1f} dBFS vs JAX")
    assert db <= -100.0, f"chain {how}: {db:.1f} dBFS"
    assert len(metrics) == len(states) == 7
    for s, m in enumerate(metrics):
        ref = {key.rsplit("/", 1)[1]: v for key, v in jax_ref.items()
               if key.startswith(f"chain/{how}/{s}/")}
        assert set(m) == set(ref), s
        assert_metrics_close({k: v.numpy() for k, v in m.items()}, ref)
    assert "context_fit" in metrics[5]


def test_torch_chain_presets_bind_like_jax():
    """A dict preset over the defaults binds texture's static material with
    with_static, as JAX's Chain does; names and indices pick presets."""
    stages = [("texture", {"material": 2, "texture": 0.3}), ("punch", 1),
              ("width", "Outer Halo"), ("infer", None)]
    tchain, jchain = TChain(stages, SR, 2, N), JChain(stages, SR, 2, N)
    assert tchain.plugins[0]._static == jchain.plugins[0]._static == \
        {"material": 2}
    for tp, jp in zip(tchain.params, jchain.params, strict=True):
        assert set(tp) == set(jp) and "material" not in tp
        for k, v in tp.items():
            np.testing.assert_array_equal(np.float32(v), np.float32(jp[k]),
                                          err_msg=k)


def test_torch_param_specs_and_presets_match_jax():
    for name in MODELS:
        t, j = t_get_processor(name), j_get_processor(name)
        assert (t.title, t.code, t.static_params) == \
            (j.title, j.code, j.static_params), name
        for a, b in zip(t.params, j.params, strict=True):
            assert (a.id, a.name, a.lo, a.hi, a.default, a.readonly,
                    a.choices, a.boolean) == \
                (b.id, b.name, b.lo, b.hi, b.default, b.readonly, b.choices,
                 b.boolean), (name, a.id)
        assert t.presets == j.presets, name
        assert (t.finalize_metrics is None) == (j.finalize_metrics is None)
        for preset in [p for p, _ in j.presets] or [None]:
            tp = t.preset_params(preset if preset else 0)
            jp = j.preset_params(preset if preset else 0)
            assert set(tp) == set(jp)
            for k, v in to_numpy(tp).items():
                np.testing.assert_array_equal(v, np.asarray(jp[k]))


def test_torch_param_normalized_mapping():
    x = np.random.default_rng(3).uniform(-20.0, 20.0, 500).astype(np.float32)
    for name in MODELS:
        for t, j in zip(t_get_processor(name).params,
                        j_get_processor(name).params):
            for fn in ("to_normalized", "from_normalized", "clamp"):
                ours = getattr(t, fn)(torch.from_numpy(x)).numpy()
                ref = np.asarray(getattr(j, fn)(jnp.asarray(x)))
                np.testing.assert_array_equal(ours.view(np.int32),
                                              ref.view(np.int32))


@pytest.mark.parametrize("name", MODELS)
def test_torch_from_jax_round_trip(name):
    """Params (presets, full_params) and state (single and vmapped) cross
    JAX -> port -> numpy unchanged, dtypes and shapes included; the port's
    own init_state has the JAX tree's structure and dtypes."""
    jplug = JPlugin(name, SR, 2, N)
    vm = jax.device_get(jax.vmap(lambda _: jplug.init_state())(jnp.arange(3)))
    if name in ("texture", "motion"):
        vm["dsp"]["rng"] = np.array([0, 2 ** 31, 2 ** 32 - 1], np.uint32)
    trees = [jplug.init_state(), vm, jplug.full_params(jplug.default_params())]
    trees += [jplug.preset(p) for p, _ in jplug.defn.presets[:2]]
    for tree in trees:
        ref = jax.device_get(tree)
        back = to_numpy(to_torch(ref, "cpu"))
        flat_ref, tdef = jax.tree.flatten(ref)
        flat_back, tdef_back = jax.tree.flatten(back)
        assert tdef == tdef_back
        for a, b in zip(flat_ref, flat_back, strict=True):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    ours = to_numpy(TPlugin(name, SR, 2, N).init_state((3,), "cpu"))
    ref_leaves = jax.tree.leaves_with_path(vm)
    assert jax.tree.structure(ours) == jax.tree.structure(vm)
    for (path, a), b in zip(ref_leaves, jax.tree.leaves(ours), strict=True):
        assert np.asarray(a).dtype == b.dtype and np.shape(a) == b.shape, path


@pytest.mark.parametrize("name", ["punch", "motion", "width", "cohere",
                                  "infer"])
def test_torch_batched_params_match_per_clip_runs(name):
    """Per-clip params (`params_batched`): each clip's block equals a run
    of that clip alone with its own params."""
    plug = TPlugin(name, SR, 2, N)
    spec = {p.id: p for p in plug.defn.params if not p.readonly}
    settings = [{k: spec[k].from_normalized(torch.tensor(f))
                 for k in plug.default_params()} for f in (0.1, 0.5, 0.9)]
    clips = torch.from_numpy(_clips(11, 2, "anticorrelated", batch=3,
                                    blocks=1))
    batched = {k: torch.stack([s[k] for s in settings]) for k in settings[0]}
    out, st, m = plug.batch_step(batched, plug.init_state((3,), "cpu"),
                                 clips, params_batched=True)
    for i, params in enumerate(settings):
        o1, st1, m1 = plug.step(params, plug.init_state((1,), "cpu"),
                                clips[i:i + 1])
        assert torch.equal(out[i:i + 1], o1), i
        for key, v in st1["dsp"].items():
            assert torch.equal(st["dsp"][key][i:i + 1], v), (i, key)
        for key, v in m1.items():
            assert torch.equal(m[key][i:i + 1], v), (i, key)


def test_torch_plugin_finalize_dispatch():
    """Plugin.step goes through the model's finalize_metrics: infer scales
    and remaps, cohere adds context_fit, the others report pre/post
    scores."""
    clips = torch.from_numpy(_clips(7, 2, "mixed", batch=2, blocks=1))
    for name in ("infer", "cohere", "punch"):
        plug = TPlugin(name, SR, 2, N)
        params = plug.preset("Overdrive Audit") if name == "infer" else \
            plug.default_params()
        _out, _st, m = plug.batch_step(params, plug.init_state((2,), "cpu"),
                                       clips)
        assert torch.equal(m["post_score"], m["score"])
        if name == "infer":
            assert torch.equal(m["punch"], m["emphasis"])
            assert torch.equal(m["mono_safety"], m["repetition_density"])
        assert ("context_fit" in m) == (name == "cohere")
