"""PyTorch port vs JAX: saturator and texture corpus scoring.

`run_corpus` of the port with use_kernel "auto" (the stage-kernel path,
which on CPU tensors runs the kernel's plain version) and "never"
(`Plugin.batched_run`) against the JAX `run_corpus(..., use_kernel="always",
_interpret=True)` on 128 clips of 2 blocks of 128: audio within -110 dBFS,
last-block scores within 1e-4. Also the refusals ("always" on a CPU tensor,
automation) and the JAX <-> port carry of params and state.

Texture (metal) through `run_corpus` on the CPU against the JAX
`run_corpus(..., use_kernel="never")` on the same 128 clips of 2 blocks of
128, computed without FMA contraction (tests/torch_jax_ref.py): audio
≤ −100 dBFS, last-block scores within 1e-3. And the rule that the entry
points run on the card unless asked for the CPU: without CUDA their default
raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import juicy_tpu.kernels.stage_kernels as sk
import juicy_tpu_torch.kernels.stage_kernels as tsk
from juicy_tpu.parallel.corpus import corpus_metrics as j_corpus_metrics
from juicy_tpu.parallel.corpus import run_corpus as j_run_corpus
from juicy_tpu.runtime.plugin import Plugin as JPlugin
from juicy_tpu_torch.parallel.corpus import corpus_metrics, run_corpus
from juicy_tpu_torch.runtime.plugin import Plugin as TPlugin
from juicy_tpu_torch.utils.from_jax import to_numpy, to_torch
from tests.conftest import make_clip, residual_dbfs
from tests.torch_jax_ref import no_fma_reference

SR = 48000.0
N = 128


def _corpus(rng):
    return np.stack([make_clip(rng, 2, 2 * N) for _ in range(8)] * 16
                    ).astype(np.float32)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX stage-kernel corpus (interpret mode, one device)."""
    rng = np.random.default_rng(0xC0)
    clips = _corpus(rng)
    plug = JPlugin("saturator", SR, 2, N)
    params = plug.full_params(plug.preset("Velvet Burn"))
    tile, msub = sk.TILE, sk.MSUB
    sk.TILE, sk.MSUB = 128, 1
    try:
        single = Mesh(np.array(jax.devices()[:1]), ("data",))
        out, last, agg = j_run_corpus(plug, params, clips, mesh=single,
                                      use_kernel="always", _interpret=True)
    finally:
        sk.TILE, sk.MSUB = tile, msub
    return clips, params, np.asarray(out), jax.device_get(last)


@pytest.mark.parametrize("use_kernel", ["auto", "never"])
def test_torch_run_corpus_vs_jax_kernel(use_kernel, jax_reference):
    clips, params, j_out, j_last = jax_reference
    plug = TPlugin("saturator", SR, 2, N)
    out, last, agg = run_corpus(plug, to_torch(jax.device_get(dict(params)), "cpu"),
                                torch.from_numpy(clips), use_kernel=use_kernel,
                                device="cpu")
    assert out.shape == clips.shape
    db = residual_dbfs(out.numpy(), j_out)
    assert db <= -110.0, f"{use_kernel}: {db:.1f} dBFS"
    for key in ("score", "pre_score", "post_score"):
        np.testing.assert_allclose(last[key].numpy(), j_last[key], atol=1e-4,
                                   err_msg=key)
    assert 0.0 <= float(agg["score"]["min"]) <= float(agg["score"]["max"]) <= 100.0


def test_torch_run_corpus_refusals():
    plug = TPlugin("saturator", SR, 2, N)
    params = plug.default_params()
    clips = torch.zeros((4, 2, 2 * N))
    with pytest.raises(ValueError, match="CUDA"):
        run_corpus(plug, params, clips, use_kernel="always", device="cpu")
    # automation takes the stage kernel too, which "always" finds only on
    # a CUDA corpus; a curve needs one value per block
    with pytest.raises(ValueError, match="CUDA"):
        run_corpus(plug, params, clips, automation={"drive": torch.ones(2)},
                   use_kernel="always", device="cpu")
    with pytest.raises(ValueError, match="one value per block"):
        run_corpus(plug, params, clips, automation={"drive": torch.zeros(3)},
                   device="cpu")
    with pytest.raises(ValueError):
        run_corpus(plug, params, clips, use_kernel="sometimes", device="cpu")
    with pytest.raises(ValueError):
        run_corpus(plug, params, clips[..., :N + 3], device="cpu")
    with pytest.raises(ValueError):
        run_corpus(plug, params, clips.double(), device="cpu")


def test_torch_corpus_metrics_match_jax():
    rng = np.random.default_rng(0x6a0e)  # this test's own input
    per_clip = {"score": rng.uniform(0, 100, 64).astype(np.float32),
                "width": rng.uniform(0, 1, 64).astype(np.float32)}
    ours = corpus_metrics(to_torch(per_clip, "cpu"))
    ref = jax.device_get(j_corpus_metrics(
        {k: jnp.asarray(v) for k, v in per_clip.items()}))
    for k in per_clip:
        for stat in ("mean", "min", "max"):
            np.testing.assert_allclose(float(ours[k][stat]), ref[k][stat],
                                       rtol=1e-6)


def test_from_jax_round_trip():
    """init_state trees (single and vmapped, with the int32 cooldown),
    preset and full_params dicts cross JAX -> port -> numpy unchanged."""
    plug = JPlugin("saturator", SR, 2, N)
    trees = [plug.init_state(),
             jax.vmap(lambda _: plug.init_state())(jnp.arange(3)),
             plug.preset("Crystal Edge"),
             plug.full_params(plug.default_params())]
    for tree in trees:
        ref = jax.device_get(tree)
        ours = to_torch(ref, "cpu")
        back = to_numpy(ours)
        flat_ref, tdef = jax.tree.flatten(ref)
        flat_back, tdef_back = jax.tree.flatten(back)
        assert tdef == tdef_back
        for a, b in zip(flat_ref, flat_back):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    st = to_torch(jax.device_get(plug.init_state()), "cpu")
    assert st["analyzer"]["onset_cooldown"].dtype == torch.int32
    assert st["dsp"]["tone_state"].shape == (2,)
    port_state = TPlugin("saturator", SR, 2, N).init_state(device="cpu")
    assert jax.tree.structure(to_numpy(port_state)) == \
        jax.tree.structure(jax.device_get(plug.init_state()))
    with pytest.raises(TypeError):
        to_torch({"x": np.zeros(3, np.float64)}, "cpu")


def _texture_corpus():
    rng = np.random.default_rng(0x7C)
    return np.stack([make_clip(rng, 2, 2 * N) for _ in range(8)] * 16
                    ).astype(np.float32)


def _jax_texture_corpus():
    """JAX run_corpus for metal on the XLA path (run without FMA)."""
    plug = JPlugin("texture", SR, 2, N).with_static(material=1)
    single = Mesh(np.array(jax.devices()[:1]), ("data",))
    out, last, _ = j_run_corpus(plug, plug.full_params(plug.default_params()),
                                _texture_corpus(), mesh=single,
                                use_kernel="never")
    ref = {"out": np.asarray(out)}
    ref.update({f"last/{k}": np.asarray(v)
                for k, v in jax.device_get(last).items()})
    return ref


@pytest.fixture(scope="module")
def texture_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_corpus", "_jax_texture_corpus",
                            tmp_path_factory.mktemp("texture_corpus"))


@pytest.mark.parametrize("use_kernel", ["auto", "never"])
def test_torch_run_corpus_texture_vs_jax(use_kernel, texture_ref):
    ref = texture_ref
    plug = TPlugin("texture", SR, 2, N).with_static(material=1)
    before = tsk.texture_stage_step.launches
    out, last, agg = run_corpus(plug, plug.default_params(),
                                _texture_corpus(), use_kernel=use_kernel,
                                device="cpu")
    assert tsk.texture_stage_step.launches == before     # CPU: no launch
    db = residual_dbfs(out.numpy(), ref["out"])
    print(f"texture corpus ({use_kernel}) vs JAX: {db:.1f} dBFS")
    assert db <= -100.0, f"{use_kernel}: {db:.1f} dBFS"
    for key in ("score", "pre_score", "post_score"):
        np.testing.assert_allclose(last[key].numpy(), ref[f"last/{key}"],
                                   atol=1e-3, err_msg=key)
    assert 0.0 <= float(agg["score"]["min"]) <= float(agg["score"]["max"]) <= 100.0


def test_torch_run_corpus_texture_refusals():
    plug = TPlugin("texture", SR, 2, N).with_static(material=1)
    clips = torch.zeros((4, 2, 2 * N))
    with pytest.raises(ValueError, match="CUDA"):
        run_corpus(plug, plug.default_params(), clips, use_kernel="always",
                   device="cpu")
    # per-clip materials run (tests/test_torch_materials.py); the kernel
    # needs the card, and the row one material per clip
    traced = dict(plug.default_params(), material=torch.tensor([0., 1., 2., 4.]))
    with pytest.raises(ValueError, match="CUDA"):
        run_corpus(TPlugin("texture", SR, 2, N), traced, clips,
                   use_kernel="always", device="cpu")
    for use_kernel in ("auto", "never"):
        with pytest.raises(ValueError, match="materials"):
            run_corpus(TPlugin("texture", SR, 2, N),
                       dict(traced, material=torch.zeros(3)), clips,
                       use_kernel=use_kernel, device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA, the entry points called without a device raise; with
    device="cpu" they run the plain route."""
    import juicy_tpu_torch.models.texture as ttex
    from juicy_tpu_torch.analyzer import analyzer_init

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plug = TPlugin("saturator", SR, 2, N)
    clips = np.zeros((2, 2, N), np.float32)
    calls = [lambda d: plug.init_state((2,), *d),
             lambda d: TPlugin("texture", SR, 2, N).init_state((2,), *d),
             lambda d: analyzer_init((2,), *d),
             lambda d: ttex.init(SR, 2, (2,), *d),
             lambda d: to_torch({"x": np.zeros(2, np.float32)}, *d),
             lambda d: run_corpus(plug, plug.default_params(), clips, "auto",
                                  None, *d)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call(())
        call(("cpu",))
    out, _last, _agg = run_corpus(plug, plug.default_params(), clips,
                                  device="cpu")
    assert out.device.type == "cpu"
