"""PyTorch port vs JAX: the JuicinessAnalyzer.

The cases of tests/test_analyzer.py (stereo, mono, anticorrelated, silence,
batched) plus a three-block state carry, with the same seeded inputs through
`juicy_tpu.analyzer.analyze` and `juicy_tpu_torch.analyzer.analyze`. Metrics
and float state within rtol 1e-5 / atol 1e-6 (the JAX band splits are
associative scans, the port's are serial: reassociation ulps), the onset
cooldown exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from juicy_tpu.analyzer import analyze as j_analyze
from juicy_tpu.analyzer import analyzer_init as j_init
from juicy_tpu_torch.analyzer import analyze as t_analyze
from juicy_tpu_torch.analyzer import analyzer_init as t_init
from juicy_tpu_torch.utils.from_jax import to_torch
from tests.conftest import make_clip

SR = 48000.0
BLOCK = 512
_j_analyze = jax.jit(lambda s, b: j_analyze(s, b, SR))


def _compare(j_state, j_m, t_state, t_m):
    for k, v in j_m.items():
        np.testing.assert_allclose(t_m[k].numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k, v in j_state.items():
        if k == "onset_cooldown":
            np.testing.assert_array_equal(t_state[k].numpy(), np.asarray(v))
            assert t_state[k].dtype == torch.int32
        else:
            np.testing.assert_allclose(t_state[k].numpy(), np.asarray(v),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def _run_both(clip, n_blocks=None):
    """Stream `clip` [..., C, T] block by block through both analyzers."""
    batch = clip.shape[:-2]
    j_state = jax.tree.map(lambda v: jnp.broadcast_to(v, batch), j_init())
    t_state = t_init(batch, "cpu")
    n_blocks = n_blocks or clip.shape[-1] // BLOCK
    for k in range(n_blocks):
        blk = clip[..., k * BLOCK:(k + 1) * BLOCK]
        j_state, j_m = _j_analyze(j_state, jnp.asarray(blk))
        t_state, t_m = t_analyze(t_state, torch.from_numpy(blk), SR)
        _compare(j_state, j_m, t_state, t_m)
    return t_m


def test_torch_analyzer_stereo():
    rng = np.random.default_rng(0x6a01)  # this test's own input
    _run_both(make_clip(rng, channels=2, samples=BLOCK * 2))


def test_torch_analyzer_mono():
    rng = np.random.default_rng(0x6a02)  # this test's own input
    _run_both(make_clip(rng, channels=1, samples=BLOCK * 2))


def test_torch_analyzer_anticorrelated():
    rng = np.random.default_rng(0x6a03)  # this test's own input
    m = _run_both(make_clip(rng, channels=2, samples=BLOCK * 2,
                            kind="anticorrelated"))
    assert float(m["mono_safety"]) < 0.3


def test_torch_analyzer_silence():
    m = _run_both(np.zeros((2, BLOCK * 2), np.float32))
    assert float(m["punch"]) == 0.0 and float(m["repetition_density"]) == 0.0


def test_torch_analyzer_batched():
    rng = np.random.default_rng(0x6a04)  # this test's own input
    clips = np.stack([make_clip(rng, 2, BLOCK) for _ in range(4)])
    m = _run_both(clips)
    assert m["score"].shape == (4,)


def test_torch_analyzer_state_carry():
    """Three blocks: envelopes, band states, cooldown and the EMAs carry,
    starting from a JAX state carried across with from_jax."""
    rng = np.random.default_rng(0x6a05)  # this test's own input
    clip = make_clip(rng, channels=2, samples=BLOCK * 4)
    j_state = j_init()
    j_state, _ = _j_analyze(j_state, jnp.asarray(clip[:, :BLOCK]))
    t_state = to_torch(jax.device_get(j_state), "cpu")
    for k in range(1, 4):
        blk = clip[:, k * BLOCK:(k + 1) * BLOCK]
        j_state, j_m = _j_analyze(j_state, jnp.asarray(blk))
        t_state, t_m = t_analyze(t_state, torch.from_numpy(blk), SR)
        _compare(j_state, j_m, t_state, t_m)
    assert float(t_state["repetition_ema"]) > 0.0


def test_torch_analyzer_lane_form():
    """The lane form (lane_init, make_lane_body per sample, stream_stats,
    lane_finalize) against JAX's lane form and against the port's analyze."""
    rng = np.random.default_rng(0x6a06)  # this test's own input
    import juicy_tpu.analyzer as ja
    import juicy_tpu_torch.analyzer as ta

    n = 256
    clips = np.stack([make_clip(rng, 2, n) for _ in range(4)])

    @jax.jit
    def j_lane(state, blk):
        body = ja.make_lane_body(SR)
        c, _ = jax.lax.scan(lambda c, x: (body(c, x[:, 0], x[:, 1]), None),
                            ja.lane_init(state, blk.shape[:1]),
                            jnp.moveaxis(blk, -1, 0))
        return ja.lane_finalize(c, state, ja.stream_stats(blk, 2), n, SR)

    j_state = jax.tree.map(lambda v: jnp.broadcast_to(v, (4,)), j_init())
    j_state, j_m = j_lane(j_state, jnp.asarray(clips))

    t_state = t_init((4,), "cpu")
    blk = torch.from_numpy(clips)
    c = ta.lane_init(t_state, (4,))
    body = ta.make_lane_body(SR)
    for i in range(n):
        c = body(c, blk[:, 0, i], blk[:, 1, i])
    t_state2, t_m = ta.lane_finalize(c, t_state, ta.stream_stats(blk, 2), n, SR)
    _compare(j_state, j_m, t_state2, t_m)
    a_state, a_m = t_analyze(t_state, blk, SR)
    _compare(jax.device_get(a_state), {k: v.numpy() for k, v in a_m.items()},
             t_state2, t_m)
