"""PyTorch port vs JAX: the saturator through the Plugin lifecycle.

All five presets, mono and stereo: one clip streamed with `Plugin.step`
block by block, and a small corpus through `Plugin.batched_run`, against the
JAX package's XLA path on the same seeded inputs. Audio within -110 dBFS
(the JAX tone one-pole is an associative scan, the port's is serial),
metrics within rtol 1e-5 / atol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from juicy_tpu.models.saturator import PRESETS
from juicy_tpu.runtime.plugin import Plugin as JPlugin
from juicy_tpu_torch.runtime.plugin import Plugin as TPlugin
from juicy_tpu_torch.utils.from_jax import to_numpy, to_torch
from tests.conftest import make_clip, residual_dbfs

SR = 48000.0
N = 256
BATCH = 4


@functools.lru_cache(maxsize=None)
def _jax(channels):
    """One jitted step and batched_run per channel count (params traced)."""
    plug = JPlugin("saturator", SR, channels, N)
    return plug, jax.jit(plug.step), jax.jit(plug.batched_run)


def _assert_metrics(t_m, j_m):
    for k, v in j_m.items():
        np.testing.assert_allclose(t_m[k].numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("preset", [name for name, _ in PRESETS])
def test_torch_saturator_preset(preset, channels):
    rng = np.random.default_rng(0x6a0c)  # this test's own input
    jplug, jstep, jbatched = _jax(channels)
    tplug = TPlugin("saturator", SR, channels, N)
    params = jplug.preset(preset)
    tparams = tplug.preset(preset)
    assert set(tparams) == set(params)
    for k, v in to_numpy(tparams).items():
        np.testing.assert_array_equal(v, np.asarray(params[k]), err_msg=k)

    # one clip, block by block through step
    clip = make_clip(rng, channels, 2 * N)
    j_st, t_st = jplug.init_state(), tplug.init_state(device="cpu")
    for k in range(2):
        blk = clip[:, k * N:(k + 1) * N]
        j_out, j_st, j_m = jstep(params, j_st, jnp.asarray(blk))
        t_out, t_st, t_m = tplug.step(tparams, t_st, torch.from_numpy(blk))
        assert residual_dbfs(t_out.numpy(), np.asarray(j_out)) <= -110.0
        _assert_metrics(t_m, j_m)
    np.testing.assert_array_equal(t_st["analyzer"]["onset_cooldown"].numpy(),
                                  np.asarray(j_st["analyzer"]["onset_cooldown"]))

    # a corpus through batched_run, starting from JAX's batched init state
    clips = np.stack([make_clip(rng, channels, 2 * N) for _ in range(BATCH)])
    j_states = jax.vmap(lambda _: jplug.init_state())(jnp.arange(BATCH))
    j_out, j_states, j_ms = jbatched(params, j_states, jnp.asarray(clips))
    t_states = to_torch(jax.device_get(jax.vmap(
        lambda _: jplug.init_state())(jnp.arange(BATCH))), "cpu")
    t_out, t_states, t_ms = tplug.batched_run(tparams, t_states,
                                              torch.from_numpy(clips))
    assert t_out.shape == clips.shape
    assert residual_dbfs(t_out.numpy(), np.asarray(j_out)) <= -110.0
    _assert_metrics(t_ms, j_ms)
    np.testing.assert_allclose(t_states["dsp"]["tone_state"].numpy(),
                               np.asarray(j_states["dsp"]["tone_state"]),
                               atol=1e-6)


def test_torch_saturator_batched_params_and_run():
    """Per-clip params (params_batched) and Plugin.run on one clip agree with
    the clip-by-clip path."""
    rng = np.random.default_rng(0x6a0d)  # this test's own input
    plug = TPlugin("saturator", SR, 2, N)
    names = [name for name, _ in PRESETS[:3]]
    per = [plug.preset(n) for n in names]
    batched = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    clips = torch.from_numpy(np.stack([make_clip(rng, 2, 2 * N)
                                       for _ in names]))
    out, _st, ms = plug.batched_run(batched, plug.init_state((3,), "cpu"), clips,
                                    params_batched=True)
    for i, p in enumerate(per):
        out_i, _st_i, ms_i = plug.run(p, plug.init_state(device="cpu"), clips[i])
        np.testing.assert_array_equal(out[i].numpy(), out_i.numpy())
        np.testing.assert_allclose(ms["score"][:, i].numpy(),
                                   ms_i["score"].numpy(), atol=1e-4)
    with pytest.raises(ValueError):
        plug.batched_run(per[0], plug.init_state((3,), "cpu"), clips,
                         params_batched=True)
    with pytest.raises(ValueError):
        plug.run(per[0], plug.init_state(device="cpu"), clips[0, :, :N + 1])
