"""PyTorch port vs JAX: the saturator and texture full-stage steps.

`saturator_stage_step` on CPU tensors runs the plain PyTorch version of the
CUDA kernel; it is held to the JAX Pallas kernel in interpret mode
(`sk.saturator_stage_step(..., interpret=True)`, with the clip tile shrunk
to 128 as tests/test_stage_kernels.py does) over two streamed blocks: audio
within -110 dBFS (XLA:CPU may fuse the interpret path differently), state
within 1e-6, cooldown exact, scores within 1e-4. Also: the wrapper's device
dispatch, its argument checks, and the kernel build's source hash. The CUDA
kernel itself is tested on the card (tests/test_torch_cuda.py).

`texture_stage_step` on CPU tensors (its plain version) is held to the JAX
Pallas kernel in interpret mode, one block per material at B = 128, N = 64
with the tile shrunk to 128, computed without FMA contraction
(tests/torch_jax_ref.py): audio ≤ −114 dBFS for gel, metal and flesh and
≤ −100 for wood and plastic (the JAX suite's own kernel↔scan bars), `rng`
bit-equal, cooldowns equal, scores within 1e-4, the wave materials'
reachable ring entries within 5e-6. Also: the kernel's constants against
JAX's `tex_param_list` bit for bit, the stage step against the port's own
`Plugin.batch_step`, and the kernel-form state conversion.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juicy_tpu.kernels.stage_kernels as sk
import juicy_tpu_torch.kernels.stage_kernels as tsk
from juicy_tpu.runtime.plugin import Plugin as JPlugin
from juicy_tpu_torch.kernels import _build
from juicy_tpu_torch.runtime.plugin import Plugin as TPlugin
from juicy_tpu_torch.utils.from_jax import to_numpy, to_torch
from tests.conftest import make_clip, residual_dbfs
from tests.torch_jax_ref import assert_material_ran, no_fma_reference

SR = 48000.0
B, N = 128, 128


@pytest.fixture
def small_tile():
    tile, msub = sk.TILE, sk.MSUB
    sk.TILE, sk.MSUB = 128, 1
    try:
        yield
    finally:
        sk.TILE, sk.MSUB = tile, msub


def _clips(rng, channels, blocks):
    return np.stack([make_clip(rng, channels, blocks * N)
                     for _ in range(B)]).astype(np.float32)


@pytest.mark.parametrize("channels", [1, 2])
def test_torch_saturator_stage_vs_pallas_interpret(channels, small_tile):
    rng = np.random.default_rng(0x6a07)  # this test's own input
    jplug = JPlugin("saturator", SR, channels, N)
    params = jplug.full_params(jplug.preset("Grain Reactor"))
    tparams = to_torch(jax.device_get(dict(params)), "cpu")
    j_st = jax.vmap(lambda _: jplug.init_state())(jnp.arange(B))
    t_st = to_torch(jax.device_get(j_st), "cpu")
    clips = _clips(rng, channels, 2)
    for k in range(2):
        blk = clips[..., k * N:(k + 1) * N]
        j_out, j_st, j_m = sk.saturator_stage_step(
            params, j_st, jnp.asarray(blk), SR, unroll=4, interpret=True)
        t_out, t_st, t_m = tsk.saturator_stage_step(
            tparams, t_st, torch.from_numpy(blk), SR)
        assert residual_dbfs(t_out.numpy(), np.asarray(j_out)) <= -110.0
        np.testing.assert_array_equal(
            t_st["analyzer"]["onset_cooldown"].numpy(),
            np.asarray(j_st["analyzer"]["onset_cooldown"]))
        for key in ("short_env", "long_env", "low_state", "high_state",
                    "repetition_ema", "fatigue_ema"):
            np.testing.assert_allclose(t_st["analyzer"][key].numpy(),
                                       np.asarray(j_st["analyzer"][key]),
                                       atol=1e-6, err_msg=key)
        np.testing.assert_allclose(t_st["dsp"]["tone_state"].numpy(),
                                   np.asarray(j_st["dsp"]["tone_state"]),
                                   atol=1e-6)
        for key in ("score", "pre_score", "post_score"):
            np.testing.assert_allclose(t_m[key].numpy(), np.asarray(j_m[key]),
                                       atol=1e-4, err_msg=key)
    assert int(t_st["analyzer"]["onset_cooldown"].max()) > 0  # onsets ran


def test_torch_stage_step_matches_plugin_batch_step():
    """The stage step and Plugin.batch_step run the same elementwise audio
    ops in the same order: bit-equal audio; metrics differ only by the
    summation order of the block reductions."""
    rng = np.random.default_rng(0x6a08)  # this test's own input
    plug = TPlugin("saturator", SR, 2, N)
    params = plug.preset("Mirror Glow")
    clips = torch.from_numpy(_clips(rng, 2, 2))
    st_k = st_x = plug.init_state((B,), "cpu")
    for k in range(2):
        blk = clips[..., k * N:(k + 1) * N]
        out_k, st_k, m_k = tsk.saturator_stage_step(params, st_k, blk, SR)
        out_x, st_x, m_x = plug.batch_step(params, st_x, blk)
        np.testing.assert_array_equal(out_k.numpy(), out_x.numpy())
        np.testing.assert_array_equal(st_k["dsp"]["tone_state"].numpy(),
                                      st_x["dsp"]["tone_state"].numpy())
        assert torch.equal(st_k["analyzer"]["onset_cooldown"],
                           st_x["analyzer"]["onset_cooldown"])
        for key in m_x:
            np.testing.assert_allclose(m_k[key].numpy(), m_x[key].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=key)


def test_torch_stage_wrapper_dispatch():
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing; other devices, batched params and bad shapes raise."""
    rng = np.random.default_rng(0x6a09)  # this test's own input
    plug = TPlugin("saturator", SR, 1, N)
    params = plug.preset(0)
    blk = torch.from_numpy(_clips(rng, 1, 1)[:5])
    st = plug.init_state((5,), "cpu")
    before = tsk.saturator_stage_step.launches
    out_w, st_w, m_w = tsk.saturator_stage_step(params, st, blk, SR)
    out_p, st_p, m_p = tsk.saturator_stage_step_plain(params, st, blk, SR)
    assert tsk.saturator_stage_step.launches == before
    assert torch.equal(out_w, out_p) and torch.equal(m_w["score"], m_p["score"])
    with pytest.raises(ValueError):
        tsk.saturator_stage_step(params, st, blk.to("meta"), SR)
    batched = dict(params, drive=torch.full((5,), 6.0))
    with pytest.raises(ValueError):
        tsk.saturator_stage_step(batched, st, blk, SR)
    with pytest.raises(ValueError):
        tsk.saturator_stage_step(params, st, blk.double(), SR)
    with pytest.raises(ValueError):
        tsk.saturator_stage_step(params, plug.init_state((4,), "cpu"), blk, SR)


def test_torch_kernel_build_hash(tmp_path, monkeypatch):
    """The library name follows the bytes of every .cu/.cuh source, so an
    edited source rebuilds; without nvcc the build raises."""
    names = {p.name for p in _build._sources()}
    assert {"saturator_stage.cu", "lane.cuh", "precise.cuh"} <= names
    h0 = _build.source_hash()
    src = tmp_path / "csrc"
    src.mkdir()
    for p in _build._sources():
        (src / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "SRC_DIR", src)
    assert _build.source_hash() == h0
    (src / "lane.cuh").write_bytes((src / "lane.cuh").read_bytes() + b"\n")
    assert _build.source_hash() != h0
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    if not Path("/usr/local/cuda/bin/nvcc").is_file():
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build()


# ---------------------------------------------------------------------------
# texture
# ---------------------------------------------------------------------------

TEX_N = 64
TEX_BAR = {0: -114.0, 1: -114.0, 2: -100.0, 3: -100.0, 4: -114.0}


def _tex_block(material):
    rng = np.random.default_rng(0x5EED + material)
    return np.stack([make_clip(rng, 2, TEX_N) for _ in range(B)]).astype(
        np.float32)


def _jax_texture_stage():
    """JAX texture_stage_step (interpret mode) per material, one block."""
    out = {}
    tile, msub = sk.TILE, sk.MSUB
    sk.TILE, sk.MSUB = 128, 1
    try:
        for m in range(5):
            plug = JPlugin("texture", SR, 2, TEX_N).with_static(material=m)
            states = jax.vmap(lambda _: plug.init_state())(jnp.arange(B))
            kstate = {"analyzer": states["analyzer"],
                      "dsp": sk.texture_kernel_state(states["dsp"], SR, m)}
            o, st, mt = sk.texture_stage_step(
                plug.full_params(plug.default_params()), kstate,
                jnp.asarray(_tex_block(m)), SR, unroll=4, interpret=True)
            dsp = dict(st["dsp"])
            if m in (2, 3):
                out[f"{m}/hist_len"] = np.asarray(dsp["waveguide"].shape[-1])
                dsp = sk.texture_ring_state(dsp, SR, m, 3840)
            out[f"{m}/out"] = np.asarray(o)
            for group, tree in (("dsp", dsp), ("an", st["analyzer"]),
                                ("m", mt)):
                for key, v in jax.device_get(tree).items():
                    out[f"{m}/{group}/{key}"] = np.asarray(v)
    finally:
        sk.TILE, sk.MSUB = tile, msub
    return out


@pytest.fixture(scope="module")
def jax_texture_stage(tmp_path_factory):
    return no_fma_reference("tests.test_torch_stage_kernels",
                            "_jax_texture_stage",
                            tmp_path_factory.mktemp("texture_stage"))


@pytest.mark.parametrize("material", [0, 1, 2, 3, 4])
def test_torch_texture_stage_vs_pallas_interpret(material, jax_texture_stage):
    ref = {k.split("/", 1)[1]: v for k, v in jax_texture_stage.items()
           if k.startswith(f"{material}/")}
    jplug = JPlugin("texture", SR, 2, TEX_N).with_static(material=material)
    tparams = to_torch(jax.device_get(
        jplug.full_params(jplug.default_params())), "cpu")
    assert tparams["material"] == material
    st = to_torch(jax.device_get(
        jax.vmap(lambda _: jplug.init_state())(jnp.arange(B))), "cpu")
    init = to_numpy(st["dsp"])
    st["dsp"] = tsk.texture_kernel_state(st["dsp"], material)
    out, st2, m = tsk.texture_stage_step(tparams, st, torch.from_numpy(
        _tex_block(material)), SR)
    db = residual_dbfs(out.numpy(), ref["out"])
    print(f"texture stage, material {material}: {db:.1f} dBFS vs JAX")
    assert db <= TEX_BAR[material], f"material {material}: {db:.1f} dBFS"
    dsp = to_numpy(tsk.texture_ring_state(st2["dsp"], material))
    assert_material_ran(init, dsp, material)
    np.testing.assert_array_equal(dsp["rng"], ref["dsp/rng"])
    np.testing.assert_array_equal(st2["analyzer"]["onset_cooldown"].numpy(),
                                  ref["an/onset_cooldown"])
    for key in ("score", "pre_score", "post_score"):
        np.testing.assert_allclose(m[key].numpy(), ref[f"m/{key}"],
                                   atol=1e-4, err_msg=key)
    for key in ("env", "tail", "wet_env", "dc_out", "protect_gain"):
        np.testing.assert_allclose(dsp[key], ref[f"dsp/{key}"], atol=2e-5,
                                   err_msg=key)
    if material in (2, 3):
        np.testing.assert_array_equal(dsp["wave_idx"], ref["dsp/wave_idx"])
        L = dsp["waveguide"].shape[-1]
        widx = int(dsp["wave_idx"].reshape(-1)[0])
        # only the last H ring samples are reachable (delay <= H)
        idx = (widx - np.arange(1, min(int(ref["hist_len"]), L) + 1)) % L
        np.testing.assert_allclose(dsp["waveguide"][..., idx],
                                   ref["dsp/waveguide"][..., idx], atol=5e-6)
        assert np.any(dsp["waveguide"][..., idx] != 0.0)


@pytest.mark.parametrize("material", [0, 1, 2, 3, 4])
def test_torch_tex_param_list_matches_jax(material):
    """The kernel's constants, bit for bit, at the defaults and at other
    settings (the TPU list ends with the write index, which the CUDA
    kernel reads per clip instead)."""
    jplug = JPlugin("texture", SR, 2, TEX_N).with_static(material=material)
    settings = [jplug.default_params(),
                dict(tailshape=0.9, damping=0.1, weight=0.8, texture=0.23,
                     mix=0.6, output=-7.5)]
    dsp = jplug.init_state()["dsp"]
    for params in settings:
        params = {k: jnp.float32(v) for k, v in params.items()}
        ref = np.asarray([np.float32(v) for v in sk.tex_param_list(
            jplug.full_params(params), dsp, SR, material)], np.float32)
        if material in (2, 3):
            ref = ref[:-1]
        ours = np.asarray(tsk.tex_param_list(
            to_torch(jax.device_get(params), "cpu"), SR, material), np.float32)
        np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("channels", [1, 2])
def test_torch_texture_stage_matches_plugin_batch_step(channels):
    """The stage step and Plugin.batch_step run the same per-sample body:
    bit-equal audio and state for every material; the LCG ends where
    lcg_advance(rng, C·N) puts it, per block."""
    rng = np.random.default_rng(0x6a0a)  # this test's own input
    from juicy_tpu_torch.ops.noise import lcg_advance

    clips = torch.from_numpy(np.stack([make_clip(rng, channels, 2 * TEX_N)
                                       for _ in range(6)]))
    for material in range(5):
        plug = TPlugin("texture", SR, channels, TEX_N).with_static(
            material=material)
        params = plug.full_params(plug.default_params())
        st_x = plug.init_state((6,), "cpu")
        init = dict(st_x["dsp"])
        st_k = {"analyzer": st_x["analyzer"],
                "dsp": tsk.texture_kernel_state(st_x["dsp"], material)}
        for k in range(2):
            blk = clips[..., k * TEX_N:(k + 1) * TEX_N]
            rng0 = st_x["dsp"]["rng"]
            out_k, st_k, m_k = tsk.texture_stage_step(params, st_k, blk, SR)
            out_x, st_x, m_x = plug.batch_step(plug.default_params(), st_x, blk)
            assert torch.equal(out_k, out_x), material
            back = tsk.texture_ring_state(st_k["dsp"], material)
            for key, v in st_x["dsp"].items():
                assert torch.equal(back[key], v), (material, key)
            assert torch.equal(back["rng"], lcg_advance(rng0, channels * TEX_N))
            assert torch.equal(st_k["analyzer"]["onset_cooldown"],
                               st_x["analyzer"]["onset_cooldown"])
            for key in m_x:
                np.testing.assert_allclose(m_k[key].numpy(), m_x[key].numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=key)
        assert_material_ran(init, back, material)


def test_torch_texture_kernel_state_conversion():
    """State -> kernel form -> state is exact; the kernel form is what the
    stage step takes; a batch whose clips disagree on the ring's write
    index is refused."""
    plug = TPlugin("texture", SR, 2, TEX_N).with_static(material=2)
    st = plug.init_state((4,), "cpu")
    gen = torch.Generator().manual_seed(3)
    st["dsp"]["waveguide"] = torch.randn(st["dsp"]["waveguide"].shape,
                                         generator=gen)
    st["dsp"]["wave_idx"] = torch.full((4, 2), 1234, dtype=torch.int32)
    st["dsp"]["rng"] = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1])
    for mode in range(5):
        kform = tsk.texture_kernel_state(st["dsp"], mode)
        assert kform["rng"].dtype == torch.int32
        back = tsk.texture_ring_state(kform, mode)
        for key, v in st["dsp"].items():
            assert torch.equal(back[key], v) and back[key].dtype == v.dtype, key
    assert tuple(tsk.texture_kernel_state(st["dsp"], 3)["waveguide"].shape) \
        == (3840, 2, 4)
    blk = torch.zeros((4, 2, TEX_N))
    params = plug.full_params(plug.default_params())
    with pytest.raises(ValueError, match="kernel form"):
        tsk.texture_stage_step(params, st, blk, SR)
    bad = dict(st["dsp"])
    bad["wave_idx"] = torch.tensor([[5, 5], [5, 5], [6, 6], [5, 5]],
                                   dtype=torch.int32)
    outside = dict(st["dsp"], wave_idx=torch.full((4, 2), 3840,
                                                   dtype=torch.int32))
    for mode in (2, 3):
        for wrong in (bad, outside):
            with pytest.raises(ValueError, match="wave_idx"):
                tsk.texture_kernel_state(wrong, mode)
    tsk.texture_kernel_state(bad, 1)        # no ring: the index is not read


def test_torch_texture_wrapper_dispatch():
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing; other devices, batched params and a traced material raise."""
    rng = np.random.default_rng(0x6a0b)  # this test's own input
    plug = TPlugin("texture", SR, 1, TEX_N).with_static(material=4)
    params = plug.full_params(plug.default_params())
    blk = torch.from_numpy(np.stack([make_clip(rng, 1, TEX_N)
                                     for _ in range(3)]))
    st = plug.init_state((3,), "cpu")
    st["dsp"] = tsk.texture_kernel_state(st["dsp"], 4)
    before = tsk.texture_stage_step.launches
    out_w, _st_w, m_w = tsk.texture_stage_step(params, st, blk, SR)
    out_p, _st_p, m_p = tsk.texture_stage_step_plain(params, st, blk, SR)
    assert tsk.texture_stage_step.launches == before
    assert torch.equal(out_w, out_p) and torch.equal(m_w["score"], m_p["score"])
    with pytest.raises(ValueError):
        tsk.texture_stage_step(params, st, blk.to("meta"), SR)
    with pytest.raises(ValueError, match="batched"):
        tsk.texture_stage_step(dict(params, texture=torch.full((3,), 0.5)),
                               st, blk, SR)
    # a material per clip runs (tests/test_torch_materials.py), one per clip
    with pytest.raises(ValueError, match="materials"):
        tsk.texture_stage_step(dict(params, material=torch.tensor([0, 4])),
                               st, blk, SR)
    with pytest.raises(ValueError):
        tsk.texture_stage_step(params, st, blk.double(), SR)
