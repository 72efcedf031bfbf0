"""PyTorch port vs JAX: a NaN meets the clamps and extrema as it does in JAX.

The port's CUDA kernels keep a NaN through every clamp and extremum
(csrc/precise.cuh clamp_to, max0, max_nan, min_nan), as torch.clamp,
torch.maximum and torch.minimum do in their plain versions. These tests hold
the plain versions to the JAX package, whose jnp.clip and jnp.maximum keep
it too; tests/test_torch_cuda.py holds the kernels to the plain versions on
the card, NaN for NaN.

- The precise ops on NaN and infinities against JAX's numpy path: NaN in
  the same places, every other value bit-equal; jlimit against jnp.clip.
- A block with one NaN sample (clip 3, channel 0, sample 10), then a clean
  block: the saturator stage step's plain version against JAX's kernel in
  interpret mode (the tile shrunk to 128), and motion's against JAX's,
  computed without FMA (tests/torch_jax_ref.py): NaN in the same places of
  the audio, the state and the metrics; the other values within the bars
  of tests/test_torch_stage_kernels.py and tests/test_torch_punch_motion.py.
- Plastic at a 2 kHz sample rate, whose filters lie past Nyquist, turns its
  output NaN within two blocks of 256: the port's texture model against
  JAX's without FMA, bit for bit, NaN in the same places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juicy_tpu.kernels.stage_kernels as sk
import juicy_tpu.ops.precise as jp
import juicy_tpu_torch.kernels.stage_kernels as tsk
import juicy_tpu_torch.ops.precise as tp
import juicy_tpu_torch.utils.convert as tc
from juicy_tpu.runtime.plugin import Plugin as JPlugin
from juicy_tpu_torch.runtime.plugin import Plugin as TPlugin
from juicy_tpu_torch.utils.from_jax import to_numpy, to_torch
from tests.torch_jax_ref import no_fma_reference

SR = 48000.0
B, N = 128, 64
NAN_AT = (3, 0, 10)
TEX_SR, TEX_B, TEX_N = 2000.0, 4, 256

SPECIALS = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, -3.0, 200.0],
                    np.float32)

# name -> (port fn, JAX numpy-path fn)
OPS = {
    "exp32": (tp.exp32, jp.exp32),
    "exp32_narrow": (tp.exp32_narrow, jp.exp32_narrow),
    "exp2_32": (tp.exp2_32, jp.exp2_32),
    "tanh32": (tp.tanh32, jp.tanh32),
    "sin32": (tp.sin32, jp.sin32),
    "cos32": (tp.cos32, jp.cos32),
    "onepole_coeff32": (lambda f: tp.onepole_coeff32(f, SR, 4200.0),
                        lambda f: jp.onepole_coeff32(f, SR, 4200.0)),
}


def _assert_same(ours, ref, what=""):
    """NaN in the same places, every other value bit-equal."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype, what
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(ours), nan, err_msg=what)
    np.testing.assert_array_equal(ours[~nan].view(np.int32) if ours.dtype ==
                                  np.float32 else ours[~nan],
                                  ref[~nan].view(np.int32) if ref.dtype ==
                                  np.float32 else ref[~nan], err_msg=what)


@pytest.mark.parametrize("name", sorted(OPS))
def test_precise_ops_keep_nan_as_jax(name):
    ours_fn, ref_fn = OPS[name]
    with np.errstate(invalid="ignore", over="ignore"):
        ref = ref_fn(SPECIALS)
    ours = ours_fn(torch.from_numpy(SPECIALS)).numpy()
    assert np.isnan(ours[0])
    _assert_same(ours, ref, name)


def test_jlimit_keeps_nan_as_jnp_clip():
    x = np.array([np.nan, -2.0, 0.25, 7.0, np.inf, -np.inf], np.float32)
    _assert_same(tc.jlimit(0.0, 1.0, torch.from_numpy(x)).numpy(),
                 np.asarray(jnp.clip(jnp.asarray(x), 0.0, 1.0)))


def _nan_clips(seed, channels, batch, n, blocks=2):
    rng = np.random.default_rng(seed)
    t = np.arange(blocks * n)
    sig = 0.25 * np.sin(2 * np.pi * 220.0 * t / SR) * (1.0 + (t % 960 < 160))
    x = np.clip(sig + 0.05 * rng.standard_normal((batch, channels, blocks * n)),
                -0.99, 0.99).astype(np.float32)
    x[NAN_AT] = np.nan
    return x


def _assert_close_nan(ours, ref, atol, what):
    """NaN in the same places, the other values within `atol`."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(ours), nan, err_msg=what)
    np.testing.assert_allclose(ours[~nan], ref[~nan], rtol=0, atol=atol,
                               err_msg=what)


def _assert_audio(ours, ref, what, bar_db=-110.0):
    """NaN in the same places (clip 3 only), the other samples within
    `bar_db` of full scale."""
    nan = np.isnan(ref)
    assert nan.any() and not nan[:3].any() and not nan[4:].any(), what
    _assert_close_nan(ours, ref, 10.0 ** (bar_db / 20.0), what)


@pytest.fixture
def small_tile():
    tile, msub = sk.TILE, sk.MSUB
    sk.TILE, sk.MSUB = 128, 1
    try:
        yield
    finally:
        sk.TILE, sk.MSUB = tile, msub


@pytest.mark.parametrize("channels", [1, 2])
def test_saturator_stage_nan_as_jax(channels, small_tile):
    jplug = JPlugin("saturator", SR, channels, N)
    params = jplug.full_params(jplug.preset("Grain Reactor"))
    tparams = to_torch(jax.device_get(dict(params)), "cpu")
    j_st = jax.vmap(lambda _: jplug.init_state())(jnp.arange(B))
    t_st = to_torch(jax.device_get(j_st), "cpu")
    clips = _nan_clips(0x4a4e + channels, channels, B, N)
    for k in range(2):
        blk = clips[..., k * N:(k + 1) * N]
        j_out, j_st, j_m = sk.saturator_stage_step(
            params, j_st, jnp.asarray(blk), SR, unroll=4, interpret=True)
        t_out, t_st, t_m = tsk.saturator_stage_step(
            tparams, t_st, torch.from_numpy(blk), SR)
        _assert_audio(t_out.numpy(), np.asarray(j_out), f"block {k}")
        _assert_close_nan(t_st["dsp"]["tone_state"].numpy(),
                          np.asarray(j_st["dsp"]["tone_state"]), 1e-6, "tone")
        for key, v in to_numpy(t_st["analyzer"]).items():
            _assert_close_nan(v, np.asarray(j_st["analyzer"][key]), 1e-6, key)
        for key in ("score", "pre_score", "post_score"):
            _assert_close_nan(t_m[key].numpy(), np.asarray(j_m[key]), 1e-4, key)


def _flat(tag, out, st, m):
    ref = {f"{tag}/out": np.asarray(out)}
    for group, tree in (("dsp", st["dsp"]), ("an", st["analyzer"]), ("m", m)):
        for key, v in jax.device_get(tree).items():
            ref[f"{tag}/{group}/{key}"] = np.asarray(v)
    return ref


def _jax_nan_refs():
    """JAX's motion stage kernel (interpret mode) over the NaN block and the
    block after it, and its plastic texture model at 2 kHz over two blocks
    (run without FMA)."""
    out = {}
    tile, msub = sk.TILE, sk.MSUB
    sk.TILE, sk.MSUB = 128, 1
    try:
        plug = JPlugin("motion", SR, 2, N)
        st = jax.vmap(lambda _: plug.init_state())(jnp.arange(B))
        clips = _nan_clips(0x4a50, 2, B, N)
        for k in range(2):
            o, st, m = sk.motion_stage_step(
                plug.full_params(plug.default_params()), st,
                jnp.asarray(clips[..., k * N:(k + 1) * N]), SR, unroll=4,
                interpret=True)
            out.update(_flat(f"motion/{k}", o, st, m))
    finally:
        sk.TILE, sk.MSUB = tile, msub
    plug = JPlugin("texture", TEX_SR, 2, TEX_N).with_static(material=3)
    st = jax.vmap(lambda _: plug.init_state())(jnp.arange(TEX_B))
    step = jax.jit(plug.batch_step)
    clips = _nan_clips(0x4a51, 2, TEX_B, TEX_N)
    clips[NAN_AT] = 0.0                   # plastic makes its own NaN
    for k in range(2):
        o, st, m = step(plug.default_params(), st,
                        jnp.asarray(clips[..., k * TEX_N:(k + 1) * TEX_N]))
        out.update(_flat(f"texture/{k}", o, st, m))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_nan", "_jax_nan_refs",
                            tmp_path_factory.mktemp("nan"))


def test_motion_stage_nan_as_jax(jax_ref):
    jplug = JPlugin("motion", SR, 2, N)
    params = to_torch(jax.device_get(jplug.full_params(jplug.default_params())),
                      "cpu")
    st = to_torch(jax.device_get(
        jax.vmap(lambda _: jplug.init_state())(jnp.arange(B))), "cpu")
    clips = _nan_clips(0x4a50, 2, B, N)
    for k in range(2):
        out, st, m = tsk.motion_stage_step(
            params, st, torch.from_numpy(clips[..., k * N:(k + 1) * N]), SR)
        ref = lambda key: jax_ref[f"motion/{k}/{key}"]  # noqa: E731
        _assert_audio(out.numpy(), ref("out"), f"block {k}")
        for key, v in to_numpy(st["dsp"]).items():
            if key in ("rng", "onset_cooldown", "repetition"):
                np.testing.assert_array_equal(v, ref(f"dsp/{key}"), key)
            else:
                _assert_close_nan(v, ref(f"dsp/{key}"), 1e-6, key)
        np.testing.assert_array_equal(st["analyzer"]["onset_cooldown"].numpy(),
                                      ref("an/onset_cooldown"))
        for key, v in m.items():
            r = ref(f"m/{key}")
            _assert_close_nan(v.numpy(), r, 1e-5 * max(1.0, float(np.nanmax(
                np.abs(r), initial=0.0))), key)


def test_plastic_2khz_nan_as_jax(jax_ref):
    tplug = TPlugin("texture", TEX_SR, 2, TEX_N).with_static(material=3)
    st = tplug.init_state((TEX_B,), "cpu")
    clips = _nan_clips(0x4a51, 2, TEX_B, TEX_N)
    clips[NAN_AT] = 0.0
    for k in range(2):
        out, st, m = tplug.batch_step(
            tplug.default_params(), st,
            torch.from_numpy(clips[..., k * TEX_N:(k + 1) * TEX_N]))
        ref = lambda key: jax_ref[f"texture/{k}/{key}"]  # noqa: E731
        _assert_same(out.numpy(), ref("out"), f"block {k}")
        for key, v in to_numpy(st["dsp"]).items():
            _assert_same(v, ref(f"dsp/{key}"), key)
    assert np.isnan(out.numpy()).any()
