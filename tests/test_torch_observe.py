"""PyTorch port vs JAX: runtime/observe.py.

``validate_block``, ``sanitize_block`` and ``guarded_step`` against JAX's
on the same blocks (guarded_step over the saturator, and over motion with a
batch whose state leaves the step shares: the faulted clip gets its own
state back, the healthy ones keep the new one, the u32 ``rng`` carrier
included), ``trace`` writing a Chrome trace (its spans:
test_torch_spans.py), and ``enable_nan_checks`` raising
``FloatingPointError`` at the first operation that makes a NaN, as
``jax_debug_nans`` does.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from juicy_tpu.runtime import observe as jobs
from juicy_tpu.runtime.plugin import Plugin as JPlugin
from juicy_tpu_torch.runtime import observe as tobs
from juicy_tpu_torch.runtime.plugin import Plugin as TPlugin
from juicy_tpu_torch.utils.from_jax import to_numpy, to_torch
from tests.conftest import make_clip

SR = 48000.0
N = 128


@pytest.mark.parametrize("shape,channels", [((8,), None), ((4, 8), 2),
                                            ((3, 2, 8), 2), ((2, 8), None)])
def test_torch_validate_block(shape, channels):
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    try:
        want = np.asarray(jobs.validate_block(jnp.asarray(x, jnp.float32)
                                              if x.ndim else x, channels))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tobs.validate_block(torch.from_numpy(x), channels)
        assert str(got.value).split(",")[0] == str(e).split(",")[0]
        return
    got = tobs.validate_block(torch.from_numpy(x), channels)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_torch_sanitize_block():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 2, 64)) * 5).astype(np.float32)
    x[0, 0, :4] = [np.nan, np.inf, -np.inf, 9.0]
    for limit in (4.0, 1.0):
        want = np.asarray(jobs.sanitize_block(jnp.asarray(x), limit))
        got = tobs.sanitize_block(torch.from_numpy(x), limit)
        np.testing.assert_array_equal(got.numpy(), want)


def _bad(step, where):
    """`step` with one output sample set to NaN."""
    def bad(p, s, b):
        out, s2, m = step(p, s, b)
        if isinstance(out, torch.Tensor):
            out = out.clone()
            out[where] = float("nan")
        else:
            out = out.at[where].set(jnp.nan)
        return out, s2, m
    return bad


@pytest.mark.parametrize("poison", [False, True])
def test_torch_guarded_step_saturator(poison):
    rng = np.random.default_rng(5)
    clip = make_clip(rng, 2, N).copy()
    clip[0, 10] = np.nan            # sanitized on the way in
    jp, tp = JPlugin("saturator", SR, 2, N), TPlugin("saturator", SR, 2, N)
    jstep, tstep = jp.step, tp.step
    if poison:
        jstep, tstep = _bad(jp.step, (0, 0)), _bad(tp.step, (0, 0))
    j = jobs.guarded_step(jstep)(jp.default_params(), jp.init_state(),
                                 jnp.asarray(clip))
    t = tobs.guarded_step(tstep)(tp.default_params(),
                                 tp.init_state((), "cpu"),
                                 torch.from_numpy(clip))
    assert bool(t[3]) == bool(j[3]) == poison
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-6)
    assert np.all(np.isfinite(t[0].numpy()))
    np.testing.assert_allclose(to_numpy(t[1])["dsp"]["tone_state"],
                               np.asarray(j[1]["dsp"]["tone_state"]),
                               atol=1e-6)
    if poison:
        np.testing.assert_array_equal(t[1]["dsp"]["tone_state"].numpy(),
                                      np.zeros(2, np.float32))


def test_torch_guarded_step_rolls_back_shared_leaves():
    """Motion's state unbatched, a batch of three clips, clip 1 poisoned:
    the leaves the step shares across the batch are made per clip, clip 1
    gets its own pre-fault values back (rng, a u32 carrier, among them),
    clips 0 and 2 keep the new ones; as JAX's guarded_step does."""
    rng = np.random.default_rng(9)
    clips = np.stack([make_clip(rng, 2, N) * g for g in (1.0, 0.5, 0.25)])
    jp, tp = JPlugin("motion", SR, 2, N), TPlugin("motion", SR, 2, N)
    jstate = jp.init_state()
    tstate = to_torch(to_numpy(tp.init_state((), "cpu")), "cpu")
    j = jobs.guarded_step(_bad(jp.step, (1, 0, 0)))(
        jp.default_params(), jstate, jnp.asarray(clips))
    t = tobs.guarded_step(_bad(tp.step, (1, 0, 0)))(
        tp.default_params(), tstate, torch.from_numpy(clips))
    np.testing.assert_array_equal(t[3].numpy(), [False, True, False])
    np.testing.assert_array_equal(np.asarray(j[3]), [False, True, False])
    got, want = to_numpy(t[1]), j[1]
    assert got["dsp"]["rng"].dtype == np.uint32
    for group in ("dsp", "analyzer"):
        for key, v in want[group].items():
            g, w = got[group][key], np.asarray(v)
            assert g.shape == w.shape, key
            if key in ("rng", "onset_cooldown"):
                np.testing.assert_array_equal(g, w, err_msg=key)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                           err_msg=key)
    # clip 1's state is the state it came in with, bit for bit
    for key, v in tstate["dsp"].items():
        assert torch.equal(t[1]["dsp"][key][1], v), key


def test_torch_trace_writes_chrome_trace(tmp_path):
    plug = TPlugin("saturator", SR, 2, N)
    with tobs.trace(str(tmp_path / "tr")) as log_dir:
        plug.step(plug.default_params(), plug.init_state((), "cpu"),
                  torch.zeros(2, N))
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert log_dir == str(tmp_path / "tr")
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_torch_nan_checks():
    x = torch.tensor([1.0, -1.0])
    nan = torch.tensor([float("nan")])
    try:
        tobs.enable_nan_checks(True)
        torch.ones(3) * 2.0                     # no NaN: runs
        torch.empty(1 << 12)                    # uninitialized: not a result
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(x)
        with pytest.raises(FloatingPointError, match="juicy_test_kernel"):
            tobs.check_kernel_outputs("juicy_test_kernel", [nan])
    finally:
        tobs.enable_nan_checks(False)
    assert bool(torch.isnan(torch.sqrt(x)).any())     # off again
    tobs.check_kernel_outputs("juicy_test_kernel", [nan])
