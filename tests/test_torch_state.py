"""PyTorch port vs JAX: checkpoints (runtime/state.py), the program API and
resumable corpora.

- A JAX ``save_state`` of bench.py's seven-stage Chain's params and its
  batched state after two blocks (B = 4, N = 64) restores into the port
  leaf for leaf, each under the same name and bit-equal to ``to_torch`` of
  JAX's leaf (the u32 ``rng`` leaves included); the port's file of its own
  chain state restores into JAX the same way.
- ``save_plugin_state`` / ``load_plugin_state`` across the two packages:
  the program index, renamed programs and the params; JAX's wrong-plugin
  error.
- The program API of all seven processors against JAX's.
- ``run_corpus_resumable``: a resumed run equals an uninterrupted one; a
  checkpoint that JAX wrote when interrupted at ``done = 4`` resumes in the
  port, with scores within 1e-5 of max(1, |value|) of JAX's uninterrupted
  run, for infer (``batched_run``) and the saturator (the stage kernel's
  plain version).

JAX's chain state and corpus scores come from one process without FMA
contraction (tests/torch_jax_ref.py).
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from juicy_tpu.runtime import state as jstate
from juicy_tpu.runtime.plugin import Chain as JChain
from juicy_tpu.runtime.plugin import Plugin as JPlugin
from juicy_tpu_torch.parallel.corpus import run_corpus_resumable
from juicy_tpu_torch.runtime import state as tstate
from juicy_tpu_torch.runtime.chain_fused import fused_chain_stream
from juicy_tpu_torch.runtime.plugin import Chain as TChain
from juicy_tpu_torch.runtime.plugin import Plugin as TPlugin
from juicy_tpu_torch.utils.from_jax import to_numpy, to_torch
from tests.test_torch_punch_motion import burst_clips
from tests.torch_jax_ref import no_fma_reference

SR = 48000.0
N = 64
B = 4
CHAIN = [("punch", "Solar Snap"), ("saturator", "Amber Heat"),
         ("texture", None), ("motion", None), ("width", "Prism Arc"),
         ("cohere", None), ("infer", "Reference Lens")]
MODELS = ("punch", "saturator", "texture", "motion", "width", "cohere",
          "infer")
CORPUS_B = 8
RESUME_AT = 4
RESUMABLE = {"infer": None, "saturator": "Amber Heat"}


def _clips(seed, b, t):
    return burst_clips(seed, b, 2, t).astype(np.float32)


def _paths(tree, prefix=""):
    """Each leaf's path, in ``jax.tree_util.keystr``'s form, in the order of
    ``runtime/state.py::tree_leaves``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}[{i}]")]
    return [prefix]


class _Interrupted(Exception):
    pass


def _jax_state_refs():
    """In the no-FMA process: JAX's chain checkpoint after two blocks (the
    file's bytes, its leaves and their paths), and, per resumable plugin,
    JAX's uninterrupted scores and the checkpoint of a run interrupted at
    done = RESUME_AT."""
    import tempfile

    from juicy_tpu.parallel import corpus as jcorpus
    from juicy_tpu.runtime.chain_fused import fused_chain_stream as j_stream

    out = {}
    tmp = Path(tempfile.mkdtemp())
    chain = JChain(CHAIN, SR, 2, N)
    states = jax.vmap(lambda _: chain.init_state())(jnp.arange(B))
    _o, states, _m = j_stream(chain, states, jnp.asarray(_clips(1, B, 2 * N)))
    path = tmp / "chain.msgpack"
    jstate.save_state(str(path), chain.params, states, meta={"blocks": 2})
    out["chain/file"] = np.frombuffer(path.read_bytes(), np.uint8)
    for section, tree in (("params", chain.params), ("state", states)):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        out[f"chain/{section}/paths"] = np.array(
            [jax.tree_util.keystr(p) for p, _ in flat])
        for i, (_p, v) in enumerate(flat):
            out[f"chain/{section}/{i}"] = np.asarray(v)

    clips = _clips(2, CORPUS_B, 2 * N)
    real_save = jstate.save_state
    for name, preset in RESUMABLE.items():
        plug = JPlugin(name, SR, 2, N)
        params = plug.preset(preset) if preset else plug.default_params()
        out[f"{name}/full"] = np.asarray(jcorpus.run_corpus_resumable(
            plug, params, clips, str(tmp / f"{name}_full.ck"),
            macro_batch=RESUME_AT))

        def save_then_stop(*a, **k):
            real_save(*a, **k)
            raise _Interrupted

        ck = tmp / f"{name}_cut.ck"
        jstate.save_state = save_then_stop
        try:
            jcorpus.run_corpus_resumable(plug, params, clips, str(ck),
                                         macro_batch=RESUME_AT)
        except _Interrupted:
            pass
        finally:
            jstate.save_state = real_save
        out[f"{name}/cut"] = np.frombuffer(ck.read_bytes(), np.uint8)
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_state", "_jax_state_refs",
                            tmp_path_factory.mktemp("state"))


def _assert_leaves_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_torch_jax_checkpoint_restores_in_port(jax_ref, tmp_path):
    path = tmp_path / "from_jax.msgpack"
    path.write_bytes(jax_ref["chain/file"].tobytes())
    chain = TChain(CHAIN, SR, 2, N)
    like = chain.init_state((B,), "cpu")
    params, states, meta = tstate.load_state(str(path), chain.params, like,
                                             device="cpu")
    assert meta == {"blocks": "2"}
    for section, tree in (("params", params), ("state", states)):
        paths = [str(p) for p in jax_ref[f"chain/{section}/paths"]]
        assert _paths(tree) == paths
        leaves = tstate.tree_leaves(tree)
        for i, leaf in enumerate(leaves):
            want = jax_ref[f"chain/{section}/{i}"]
            _assert_leaves_equal(leaf, to_torch(want, "cpu"))
    rngs = [st["dsp"]["rng"] for st in states if "rng" in st["dsp"]]
    assert len(rngs) == 2 and all(r.dtype == torch.int64 for r in rngs)
    # the restored state keeps the chain going: one more block
    out, _st, _m = fused_chain_stream(chain, states, torch.from_numpy(
        _clips(3, B, N)))
    assert bool(torch.isfinite(out).all())


def test_torch_port_checkpoint_restores_in_jax(tmp_path):
    tchain = TChain(CHAIN, SR, 2, N)
    _o, states, _m = fused_chain_stream(
        tchain, tchain.init_state((B,), "cpu"),
        torch.from_numpy(_clips(4, B, 2 * N)))
    path = str(tmp_path / "from_port.msgpack")
    tstate.save_state(path, tchain.params, states, meta={"total": 7})
    jchain = JChain(CHAIN, SR, 2, N)
    like = jax.vmap(lambda _: jchain.init_state())(jnp.arange(B))
    params, jstates, meta = jstate.load_state(path, jchain.params, like)
    assert meta == {"total": "7"}
    for got, want in ((params, tchain.params), (jstates, states)):
        flat, _ = jax.tree_util.tree_flatten_with_path(got)
        assert [jax.tree_util.keystr(p) for p, _ in flat] == _paths(want)
        for (_p, g), w in zip(flat, tstate.tree_leaves(want), strict=True):
            w = to_numpy(w)
            g = np.asarray(g)
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert np.asarray(jstates[3]["dsp"]["rng"]).dtype == np.uint32


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_torch_plugin_state_across_packages(direction, tmp_path):
    path = str(tmp_path / "plug.msgpack")
    jp, tp = JPlugin("saturator", SR, 2, N), TPlugin("saturator", SR, 2, N)
    if direction == "jax_to_port":
        src, dst, save, load = jp, tp, jstate.save_plugin_state, \
            tstate.load_plugin_state
    else:
        src, dst, save, load = tp, jp, tstate.save_plugin_state, \
            jstate.load_plugin_state
    params = src.set_program(3)
    src.change_program_name(3, "Custom Grain")
    src_state = src.init_state() if src is jp else src.init_state(
        (), "cpu")
    save(path, src, params, src_state)
    if dst is tp:
        got, _st, meta = load(path, dst, dst.default_params(),
                              dst.init_state((), "cpu"), device="cpu")
    else:
        got, _st, meta = load(path, dst, dst.default_params(),
                              dst.init_state())
    assert dst.current_program == 3
    assert dst.program_name(3) == "Custom Grain"
    assert meta["processor"] == "saturator"
    for k, v in params.items():
        assert float(got[k]) == float(v), k
    # the wrong plugin raises JAX's error before the leaves are read
    wrong_j, wrong_t = JPlugin("punch", SR, 2, N), TPlugin("punch", SR, 2, N)
    with pytest.raises(ValueError) as ej:
        jstate.load_plugin_state(path, wrong_j, wrong_j.default_params(),
                                 wrong_j.init_state())
    with pytest.raises(ValueError) as et:
        tstate.load_plugin_state(path, wrong_t, wrong_t.default_params(),
                                 wrong_t.init_state((), "cpu"), device="cpu")
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("name", MODELS)
def test_torch_program_api(name):
    jp, tp = JPlugin(name, SR, 2, N), TPlugin(name, SR, 2, N)
    assert tp.num_programs == jp.num_programs
    assert tp.current_program == jp.current_program == 0
    n = jp.num_programs
    for i in range(-3, n + 3):
        assert tp.program_name(i) == jp.program_name(i)
    for i in (2, 99, -5, 0, n - 1):
        pj, pt = jp.set_program(i), tp.set_program(i)
        assert tp.current_program == jp.current_program
        assert set(pt) == set(pj)
        for k in pj:
            assert float(pt[k]) == float(np.asarray(pj[k])), k
    for nm in jp.defn.preset_names():
        jp.preset(nm)
        tp.preset(nm)
        assert tp.current_program == jp.current_program
    for i, label in ((0, "First"), (n - 1, "Last"), (n + 4, "Nowhere")):
        jp.change_program_name(i, label)
        tp.change_program_name(i, label)
    assert [tp.program_name(i) for i in range(n)] == \
        [jp.program_name(i) for i in range(n)]


@pytest.mark.parametrize("name", list(RESUMABLE))
def test_torch_resumable_corpus(name, jax_ref, tmp_path):
    clips = torch.from_numpy(_clips(2, CORPUS_B, 2 * N))
    plug = TPlugin(name, SR, 2, N)
    preset = RESUMABLE[name]
    params = plug.preset(preset) if preset else plug.default_params()
    path = str(tmp_path / "corpus.ck")
    full = run_corpus_resumable(plug, params, clips, path,
                                macro_batch=RESUME_AT, device="cpu")
    assert full.shape == (CORPUS_B,) and full.dtype == np.float32

    # rewind the cursor and poison what is left: the resumed run redoes it
    cur, saved, meta = tstate.load_state(
        path, {"done": torch.tensor(0, dtype=torch.int32)},
        {"scores": torch.zeros(CORPUS_B)}, device="cpu")
    assert int(cur["done"]) == CORPUS_B and meta == {"total": str(CORPUS_B)}
    partial = saved["scores"].clone()
    partial[RESUME_AT:] = -1.0
    tstate.save_state(path, {"done": torch.tensor(RESUME_AT,
                                                  dtype=torch.int32)},
                      {"scores": partial}, meta={"total": CORPUS_B})
    resumed = run_corpus_resumable(plug, params, clips, path,
                                   macro_batch=RESUME_AT, device="cpu")
    np.testing.assert_array_equal(resumed, full)

    # JAX's interrupted job resumes in the port
    cut = tmp_path / "jax_cut.ck"
    cut.write_bytes(jax_ref[f"{name}/cut"].tobytes())
    cur, _s, _m = tstate.load_state(
        str(cut), {"done": torch.tensor(0, dtype=torch.int32)},
        {"scores": torch.zeros(CORPUS_B)}, device="cpu")
    assert int(cur["done"]) == RESUME_AT
    from_jax = run_corpus_resumable(plug, params, clips, str(cut),
                                    macro_batch=RESUME_AT, device="cpu")
    want = jax_ref[f"{name}/full"]
    np.testing.assert_array_equal(from_jax[:RESUME_AT], want[:RESUME_AT])
    rel = np.abs(from_jax.astype(np.float64) - want) / np.maximum(
        1.0, np.abs(want))
    assert rel.max() <= 1e-5, rel
    rel = np.abs(full.astype(np.float64) - want) / np.maximum(
        1.0, np.abs(want))
    assert rel.max() <= 1e-5, rel
    # and the port's checkpoint resumes in JAX's reader
    _c, jsaved, _m = jstate.load_state(path, {"done": jnp.int32(0)},
                                       {"scores": jnp.zeros((CORPUS_B,))})
    np.testing.assert_array_equal(np.asarray(jsaved["scores"]), full)


def test_torch_resumable_mesh_raises():
    """A mesh takes the place of a device: both at once raise (the sharded
    resumable corpus itself: tests/test_torch_mesh.py)."""
    from juicy_tpu_torch.parallel.mesh import make_mesh

    plug = TPlugin("infer", SR, 2, N)
    with pytest.raises(ValueError, match="not both"):
        run_corpus_resumable(plug, plug.default_params(),
                             np.zeros((2, 2, N), np.float32),
                             os.devnull, mesh=make_mesh(devices=["cpu"] * 2),
                             device="cpu")
