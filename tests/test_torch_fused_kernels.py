"""PyTorch port vs JAX: ``analyze_fused`` and ``saturator_step_fused``.

JAX's numbers come from its interpret-mode Pallas kernels, run in one
process without FMA contraction (tests/torch_jax_ref.py), on the inputs of
tests/test_kernels.py: B = 1024 clips of make_clip (eight clips repeated),
blocks of 256, two blocks with the state carried. ``analyze_fused`` also
runs stereo blocks of 512 and mono blocks of 100 (JAX's unroll-1 path, and
a block that is not a whole number of the CUDA kernel's chunks).

- ``analyze_fused`` (its plain version: a CPU block) against JAX's
  ``analyze_fused``: states within 1e-6 (rel), ``onset_cooldown`` exact,
  metrics within 2e-5 (JAX's own bars, tests/test_kernels.py). The port
  takes the side, corr, L² and R² sums serially in the lane, JAX with
  ``jnp.sum``: ulps apart.
- ``saturator_step_fused`` (plain) against JAX's: audio <= -120 dBFS,
  ``tone_state`` within 1e-6 (rel), the analyzer's envelopes and EMAs
  within 1e-6, ``onset_cooldown`` exact, scores within 1e-5.

On the port alone: ``analyze_fused``'s plain version against the port's
``analyze`` (the batched analyzer), ``saturator_step_fused`` against the
stage step and ``Plugin.batch_step``, the routes and the refusals. The CUDA
kernels are held to their plain versions on the card in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from juicy_tpu_torch.analyzer import analyze, analyzer_init
from juicy_tpu_torch.kernels import stage_kernels as sk
from juicy_tpu_torch.kernels.analyzer_kernel import (analyze_fused,
                                                     analyze_fused_plain)
from juicy_tpu_torch.kernels.saturator_kernel import (
    saturator_step_fused, saturator_step_fused_plain)
from juicy_tpu_torch.runtime.plugin import Plugin
from juicy_tpu_torch.utils.from_jax import to_numpy
from tests.conftest import make_clip, residual_dbfs
from tests.test_torch_punch_motion import assert_metrics_close
from tests.torch_jax_ref import no_fma_reference

SR = 48000.0
N = 256
B = 1024
#: (channels, block length) of the analyze_fused cases
ANALYZER_CASES = ((2, N), (2, 512), (1, 100))
STATE_KEYS = ("short_env", "long_env", "low_state", "high_state",
              "repetition_ema", "fatigue_ema")


def _clips(seed, channels=2, n=N):
    """tests/test_kernels.py's batch: eight make_clip clips of two blocks,
    repeated."""
    rng = np.random.default_rng(seed)
    return np.stack([make_clip(rng, channels, 2 * n)
                     for _ in range(8)] * (B // 8))


def _jax_fused_refs():
    """JAX's analyze_fused and saturator_step_fused in interpret mode, two
    blocks each (run without FMA)."""
    from juicy_tpu.analyzer import analyzer_init as j_init
    from juicy_tpu.kernels.analyzer_kernel import analyze_fused as j_analyze
    from juicy_tpu.kernels.saturator_kernel import saturator_step_fused as j_sat
    from juicy_tpu.runtime.plugin import Plugin as JPlugin

    out = {}
    for c, n in ANALYZER_CASES:
        clips = _clips(1, c, n)
        st = jax.vmap(lambda _: j_init())(jnp.arange(B))
        for k in range(2):
            st, m = j_analyze(st, jnp.asarray(clips[..., k * n:(k + 1) * n]),
                              SR, interpret=True)
            for group, tree in (("st", st), ("m", m)):
                for key, v in jax.device_get(tree).items():
                    out[f"an/{c}x{n}/{k}/{group}/{key}"] = np.asarray(v)
    plug = JPlugin("saturator", SR, 2, N)
    params = plug.preset("Amber Heat")
    clips = _clips(2)
    st = jax.vmap(lambda _: plug.init_state())(jnp.arange(B))
    for k in range(2):
        o, st, m = j_sat(plug, params, st,
                         jnp.asarray(clips[..., k * N:(k + 1) * N]),
                         interpret=True)
        out[f"sat/{k}/out"] = np.asarray(o)
        for group, tree in (("an", st["analyzer"]), ("dsp", st["dsp"]),
                            ("m", m)):
            for key, v in jax.device_get(tree).items():
                out[f"sat/{k}/{group}/{key}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_fused_kernels",
                            "_jax_fused_refs",
                            tmp_path_factory.mktemp("fused_kernels"))


def _assert_state(st, ref, prefix, rtol=1e-6):
    st = to_numpy(st)
    np.testing.assert_array_equal(st["onset_cooldown"],
                                  ref[f"{prefix}/onset_cooldown"])
    for key in STATE_KEYS:
        np.testing.assert_allclose(st[key], ref[f"{prefix}/{key}"],
                                   rtol=rtol, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("channels,n", ANALYZER_CASES)
def test_torch_analyze_fused_vs_jax(channels, n, jax_ref):
    """Two blocks with the state carried; the onsets and cooldowns ran."""
    clips = torch.from_numpy(_clips(1, channels, n))
    st = analyzer_init((B,), "cpu")
    for k in range(2):
        st, m = analyze_fused(st, clips[..., k * n:(k + 1) * n], SR)
        tag = f"an/{channels}x{n}/{k}"
        _assert_state(st, jax_ref, f"{tag}/st")
        m = to_numpy(m)
        assert set(m) == {key.split("/")[-1] for key in jax_ref
                          if key.startswith(f"{tag}/m/")}
        for key, v in m.items():
            np.testing.assert_allclose(v, jax_ref[f"{tag}/m/{key}"],
                                       rtol=2e-5, atol=2e-5, err_msg=key)
    assert int(st["onset_cooldown"].max()) > 0


def test_torch_analyze_fused_matches_analyze():
    """The lane (serial band energies and stream sums) against the port's
    analyze (tensor sums): the carried state bit-equal, the metrics within
    1e-5 of their scale; any B runs, mono too."""
    for channels, b in ((2, 37), (1, 5)):
        rng = np.random.default_rng(channels)
        x = torch.from_numpy(np.stack([make_clip(rng, channels, N)
                                       for _ in range(b)]))
        st0 = analyzer_init((b,), "cpu")
        st_f, m_f = analyze_fused_plain(st0, x, SR)
        st_a, m_a = analyze(st0, x, SR)
        for key in ("short_env", "long_env", "onset_cooldown"):
            assert torch.equal(st_f[key], st_a[key]), key
        assert_metrics_close(to_numpy(m_f), to_numpy(m_a))
        assert_metrics_close(to_numpy(st_f), to_numpy(st_a))


def test_torch_analyze_fused_routes():
    """A CPU block runs the plain version (no launch); bad shapes and other
    devices raise."""
    st = analyzer_init((4,), "cpu")
    x = torch.zeros((4, 2, N))
    before = analyze_fused.launches
    a, m = analyze_fused(st, x, SR)
    b, m2 = analyze_fused_plain(st, x, SR)
    assert analyze_fused.launches == before
    for key in m:
        assert torch.equal(m[key], m2[key]), key
    with pytest.raises(ValueError):
        analyze_fused(st, torch.zeros((4, 3, N)), SR)
    with pytest.raises(ValueError):
        analyze_fused(st, x.double(), SR)
    with pytest.raises(ValueError):
        analyze_fused(st, x.to("meta"), SR)


def test_torch_saturator_step_fused_vs_jax(jax_ref):
    plug = Plugin("saturator", SR, 2, N)
    params = plug.preset("Amber Heat")
    clips = torch.from_numpy(_clips(2))
    st = plug.init_state((B,), "cpu")
    for k in range(2):
        out, st, m = saturator_step_fused(plug, params, st,
                                          clips[..., k * N:(k + 1) * N])
        db = residual_dbfs(out.numpy(), jax_ref[f"sat/{k}/out"])
        print(f"saturator_step_fused block {k}: {db:.1f} dBFS vs JAX")
        assert db <= -120.0, db
        np.testing.assert_allclose(st["dsp"]["tone_state"].numpy(),
                                   jax_ref[f"sat/{k}/dsp/tone_state"],
                                   rtol=1e-6, atol=1e-7)
        _assert_state(st["analyzer"], jax_ref, f"sat/{k}/an")
        m = to_numpy(m)
        assert set(m) == {key.split("/")[-1] for key in jax_ref
                          if key.startswith(f"sat/{k}/m/")}
        assert_metrics_close(m, {key: jax_ref[f"sat/{k}/m/{key}"]
                                 for key in m})


def test_torch_saturator_step_fused_matches_stage_and_batch_step():
    """The same function as the stage step (bit for bit) and as
    Plugin.batch_step (audio and tone bit-equal, metrics within 1e-5 of
    their scale: the analyzer's sums are taken in another order); a CPU
    block makes no launch; other plugins, shapes and devices raise."""
    for channels, b in ((2, 37), (1, 5)):
        plug = Plugin("saturator", SR, channels, N)
        params = plug.preset("Grain Reactor")
        rng = np.random.default_rng(10 + channels)
        x = torch.from_numpy(np.stack([make_clip(rng, channels, N)
                                       for _ in range(b)]))
        st0 = plug.init_state((b,), "cpu")
        before = (saturator_step_fused.launches,
                  sk.saturator_stage_step.launches)
        out, st, m = saturator_step_fused(plug, params, st0, x)
        assert before == (saturator_step_fused.launches,
                          sk.saturator_stage_step.launches)
        out_s, st_s, m_s = sk.saturator_stage_step_plain(
            plug.full_params(params), st0, x, SR)
        assert torch.equal(out, out_s)
        assert torch.equal(st["dsp"]["tone_state"],
                           st_s["dsp"]["tone_state"])
        for key, v in m_s.items():
            assert torch.equal(m[key], v), key
        out_b, st_b, m_b = plug.batch_step(params, st0, x)
        assert torch.equal(out, out_b)
        assert torch.equal(st["dsp"]["tone_state"],
                           st_b["dsp"]["tone_state"])
        assert set(m) == set(m_b)
        assert_metrics_close(to_numpy(m), to_numpy(m_b))
    plug = Plugin("saturator", SR, 2, N)
    st0 = plug.init_state((4,), "cpu")
    x = torch.zeros((4, 2, N))
    out, _st, _m = saturator_step_fused_plain(plug, plug.default_params(),
                                              st0, x)
    assert torch.equal(out, torch.zeros_like(x))
    with pytest.raises(ValueError):
        saturator_step_fused(Plugin("punch", SR, 2, N), {}, st0, x)
    with pytest.raises(ValueError):
        saturator_step_fused(plug, plug.default_params(), st0, x[:2])
    with pytest.raises(ValueError):
        saturator_step_fused(plug, plug.default_params(), st0, x.to("meta"))
