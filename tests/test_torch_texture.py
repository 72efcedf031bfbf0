"""PyTorch port vs JAX: texture (static material) through the Plugin.

`Plugin("texture").with_static(material=m).batch_step` of the port against
the JAX package's `Plugin.batch_step` (vmapped state) on the same seeded
clips, all five materials, stereo and (metal, wood) mono, B = 16, N = 64.
State crosses with `from_jax` both ways. Bars: audio ≤ −110 dBFS for gel,
metal and flesh and ≤ −90 for wood and plastic; `rng` and `wave_idx`
bit-equal, `onset_cooldown` equal, scores within 1e-4. Every case checks
which material ran: its own state leaves moved and the others did not.

Two streamed blocks are held to JAX computed without FMA contraction
(tests/torch_jax_ref.py explains why); one block is also held to the
default XLA:CPU in this process. Also the static-param API (`_split_static`,
`with_static`, `full_params`) against JAX's, and the refusals.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juicy_tpu_torch.models.texture as ttex
from juicy_tpu.runtime.plugin import Plugin as JPlugin
from juicy_tpu_torch.runtime.plugin import Plugin as TPlugin
from juicy_tpu_torch.utils.from_jax import to_numpy, to_torch
from tests.conftest import make_clip, residual_dbfs
from tests.torch_jax_ref import assert_material_ran, no_fma_reference

SR = 48000.0
B, N = 16, 64
# (material, channels)
CASES = [(m, 2) for m in range(5)] + [(1, 1), (2, 1)]
AUDIO_BAR = {0: -110.0, 1: -110.0, 2: -90.0, 3: -90.0, 4: -110.0}
def _clips(channels, blocks=2):
    rng = np.random.default_rng(0x7E57 + channels)
    return np.stack([make_clip(rng, channels, blocks * N)
                     for _ in range(B)]).astype(np.float32)


def _jax_state(plug):
    return jax.vmap(lambda _: plug.init_state())(jnp.arange(B))


def _jax_model_blocks():
    """JAX batch_step over two blocks for every case (run without FMA)."""
    out = {}
    for m, c in CASES:
        plug = JPlugin("texture", SR, c, N).with_static(material=m)
        params = plug.default_params()
        st = _jax_state(plug)
        step = jax.jit(plug.batch_step)
        clips = _clips(c)
        for k in range(2):
            o, st, mt = step(params, st, jnp.asarray(clips[..., k * N:(k + 1) * N]))
            tag = f"{m}_{c}_{k}"
            out[f"{tag}/out"] = np.asarray(o)
            for group, tree in (("dsp", st["dsp"]), ("an", st["analyzer"]),
                                ("m", mt)):
                for key, v in jax.device_get(tree).items():
                    out[f"{tag}/{group}/{key}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_blocks(tmp_path_factory):
    return no_fma_reference("tests.test_torch_texture", "_jax_model_blocks",
                            tmp_path_factory.mktemp("texture"))


def _compare_block(out, state, metrics, ref, material, what):
    db = residual_dbfs(out.numpy(), ref("out"))
    print(f"texture model, material {material}, {what}: {db:.1f} dBFS vs JAX")
    assert db <= AUDIO_BAR[material], f"material {material}: {db:.1f} dBFS"
    dsp = to_numpy(state["dsp"])
    assert dsp["rng"].dtype == np.uint32
    np.testing.assert_array_equal(dsp["rng"], ref("dsp/rng"))
    np.testing.assert_array_equal(dsp["wave_idx"], ref("dsp/wave_idx"))
    np.testing.assert_array_equal(state["analyzer"]["onset_cooldown"].numpy(),
                                  ref("an/onset_cooldown"))
    for key in ("score", "pre_score", "post_score"):
        np.testing.assert_allclose(metrics[key].numpy(), ref(f"m/{key}"),
                                   atol=1e-4, err_msg=key)
    return db


@pytest.mark.parametrize("material,channels", CASES)
def test_torch_texture_streamed_vs_jax(material, channels, jax_blocks):
    jplug = JPlugin("texture", SR, channels, N).with_static(material=material)
    tplug = TPlugin("texture", SR, channels, N).with_static(material=material)
    params = tplug.default_params()
    state = to_torch(jax.device_get(_jax_state(jplug)), "cpu")
    init = to_numpy(state["dsp"])
    clips = _clips(channels)
    for k in range(2):
        blk = torch.from_numpy(clips[..., k * N:(k + 1) * N])
        out, state, m = tplug.batch_step(params, state, blk)
        tag = f"{material}_{channels}_{k}"
        _compare_block(out, state, m, lambda name: jax_blocks[f"{tag}/{name}"],
                       material, f"C={channels} block {k} (no FMA)")
    final = to_numpy(state["dsp"])
    assert_material_ran(init, final, material)
    ref_final = {key: jax_blocks[f"{material}_{channels}_1/dsp/{key}"]
                 for key in init}
    assert_material_ran(init, ref_final, material)


@functools.lru_cache(maxsize=None)
def _jit_batch_step(material):
    plug = JPlugin("texture", SR, 2, N).with_static(material=material)
    return plug, jax.jit(plug.batch_step)


@pytest.mark.parametrize("material", [0, 1, 2, 3, 4])
def test_torch_texture_one_block_vs_default_xla(material):
    """JAX as it runs by default here (XLA:CPU contracts FMAs): the first
    block meets the bars; the second is held at -90 dBFS, for the drift the
    contraction leaves on the resonant materials (ROADMAP.md Queue 3: metal
    -103.4, wood -97.9, plastic -96.1 dBFS)."""
    jplug, step = _jit_batch_step(material)
    tplug = TPlugin("texture", SR, 2, N).with_static(material=material)
    clips = _clips(2)
    j_st, state = _jax_state(jplug), tplug.init_state((B,), "cpu")
    for k in range(2):
        blk = clips[..., k * N:(k + 1) * N]
        j_out, j_st, j_m = step(jplug.default_params(), j_st, jnp.asarray(blk))
        out, state, m = tplug.batch_step(tplug.default_params(), state,
                                         torch.from_numpy(blk))
        if k == 0:
            ref = {"out": np.asarray(j_out)}
            for group, tree in (("dsp", j_st["dsp"]), ("an", j_st["analyzer"]),
                                ("m", j_m)):
                ref.update({f"{group}/{key}": np.asarray(v)
                            for key, v in jax.device_get(tree).items()})
            _compare_block(out, state, m, ref.__getitem__, material,
                           "block 0 (default XLA:CPU)")
        else:
            db = residual_dbfs(out.numpy(), np.asarray(j_out))
            print(f"texture model, material {material}, block 1 (default "
                  f"XLA:CPU): {db:.1f} dBFS vs JAX")
            assert db <= -90.0


def test_torch_texture_static_params():
    jp = JPlugin("texture", SR, 2, N)
    tp = TPlugin("texture", SR, 2, N)
    assert tp.defn.static_params == jp.defn.static_params == ("material",)
    for a, b in zip(tp.defn.params, jp.defn.params, strict=True):
        assert (a.id, a.lo, a.hi, a.default, a.readonly, a.choices) == \
            (b.id, b.lo, b.hi, b.default, b.readonly, b.choices)
    # default_params holds no material; full_params adds the bound one
    t_def, j_def = tp.default_params(), jp.default_params()
    assert set(t_def) == set(j_def) and "material" not in t_def
    for k, v in to_numpy(t_def).items():
        np.testing.assert_array_equal(v, np.asarray(j_def[k]), err_msg=k)
    for material in (3, 3.0, np.float32(4.0)):
        raw = dict(tp.defn.default_params(), material=torch.tensor(
            float(material)))
        rest, static = tp._split_static(raw)
        j_rest, j_static = jp._split_static(
            dict(jp.defn.default_params(), material=jnp.float32(material)))
        assert static == j_static == {"material": int(material)}
        assert set(rest) == set(j_rest)
    t2, j2 = tp.with_static(material=2), jp.with_static(material=2)
    assert t2.full_params(t_def)["material"] == \
        j2.full_params(j_def)["material"] == 2
    assert t2.with_static(material=4).full_params(t_def)["material"] == 4
    assert "material" not in tp.full_params(t_def) and tp._static == {}
    assert t2.defn is tp.defn and (t2.sr, t2.channels, t2.block_size) == \
        (tp.sr, tp.channels, tp.block_size)


def test_torch_texture_refusals():
    """A per-clip (traced) material and per-clip params run (against JAX in
    tests/test_torch_materials.py); what is refused: a static material
    where one is required, and a param whose batch is not the block's."""
    tp = TPlugin("texture", SR, 2, N)
    state = tp.init_state((2,), "cpu")
    blk = torch.zeros((2, 2, N))
    traced = dict(tp.default_params(), material=torch.tensor([0.0, 2.0]))
    out, _ = ttex.process(traced, state["dsp"], blk, SR)
    assert out.shape == blk.shape
    with pytest.raises(ValueError, match="per-clip"):
        ttex.require_static(traced)
    batched = {k: torch.stack([v, v]) for k, v in tp.default_params().items()}
    tp.with_static(material=1).batch_step(batched, state, blk,
                                          params_batched=True)
    with pytest.raises(ValueError, match="shape"):
        tp.with_static(material=1).batch_step(
            {k: torch.stack([v] * 3) for k, v in batched.items()}, state,
            blk, params_batched=True)
