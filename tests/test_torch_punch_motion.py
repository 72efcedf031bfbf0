"""PyTorch port vs JAX: punch and motion, the models and the stage steps.

The inputs put a decaying burst at a seeded position in each clip, over a
background too quiet to trip motion's onset detector, so that most onsets
fall inside a block (motion's 40 ms cooldown allows one per clip here) and
pass 1's LCG rolls run mid-block. JAX's numbers come from a process without
FMA contraction (tests/torch_jax_ref.py): one onset comparator contracted
differently would move the LCG for the rest of the clip.

- The models through `Plugin.batch_step`, two blocks of 64, B = 16, stereo
  and mono, against JAX's `Plugin.batch_step`: audio ≤ −110 dBFS; motion's
  `rng`, `onset_cooldown` and `repetition` exactly equal, and onsets
  happened; the other state within 1e-6; metrics within 1e-5 of their scale
  (max(1, |value|), so scores within 1e-5 relative).
- `punch_stage_step_plain` and `motion_stage_step_plain` (the CPU route of
  the stage steps) against JAX's `sk.punch_stage_step` /
  `sk.motion_stage_step` in interpret mode, B = 128 with the tile shrunk to
  128, two blocks of 64, with the same bars.
- `run_corpus` "auto" (the stage steps' plain versions) against "never" on
  the CPU, the stage step against `Plugin.batch_step`, and the wrapper's
  dispatch and refusals. The CUDA kernels are tested on the card
  (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juicy_tpu.kernels.stage_kernels as sk
import juicy_tpu_torch.kernels.stage_kernels as tsk
from juicy_tpu.runtime.plugin import Plugin as JPlugin
from juicy_tpu_torch.parallel.corpus import run_corpus
from juicy_tpu_torch.runtime.plugin import Plugin as TPlugin
from juicy_tpu_torch.utils.from_jax import to_numpy, to_torch
from tests.conftest import residual_dbfs
from tests.torch_jax_ref import no_fma_reference

SR = 48000.0
N = 64
B_MODEL, B_STAGE = 16, 128
MODEL_CASES = [("punch", 2), ("punch", 1), ("motion", 2), ("motion", 1)]
EXACT = ("rng", "onset_cooldown", "repetition")


def burst_clips(seed, batch, channels, samples):
    """A quiet 220 Hz tone and noise (|mono| < 0.02), and per clip one
    decaying 900 Hz burst starting at a seeded sample."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples)
    clips = []
    for _ in range(batch):
        start = rng.integers(4, samples - 8)
        burst = np.where(t >= start, np.exp(-(t - start) / 40.0), 0.0) * \
            0.6 * np.sin(2 * np.pi * 900.0 * (t - start) / SR + 0.4)
        bed = 0.008 * np.sin(2 * np.pi * 220.0 * t / SR)
        left = bed + burst + 0.002 * rng.standard_normal(samples)
        right = bed + 0.9 * burst + 0.002 * rng.standard_normal(samples)
        clips.append(np.stack([left, right][:channels]))
    return np.clip(np.stack(clips), -0.99, 0.99).astype(np.float32)


def _flat(tag, out, st, m):
    ref = {f"{tag}/out": np.asarray(out)}
    for group, tree in (("dsp", st["dsp"]), ("an", st["analyzer"]), ("m", m)):
        for key, v in jax.device_get(tree).items():
            ref[f"{tag}/{group}/{key}"] = np.asarray(v)
    return ref


def _jax_punch_motion():
    """JAX batch_step per model case and the interpret-mode stage kernels,
    two blocks each (run without FMA)."""
    out = {}
    for name, c in MODEL_CASES:
        plug = JPlugin(name, SR, c, N)
        st = jax.vmap(lambda _: plug.init_state())(jnp.arange(B_MODEL))
        step = jax.jit(plug.batch_step)
        clips = burst_clips(1, B_MODEL, c, 2 * N)
        for k in range(2):
            o, st, m = step(plug.default_params(), st,
                            jnp.asarray(clips[..., k * N:(k + 1) * N]))
            out.update(_flat(f"model/{name}/{c}/{k}", o, st, m))
    tile, msub = sk.TILE, sk.MSUB
    sk.TILE, sk.MSUB = 128, 1
    try:
        for name in ("punch", "motion"):
            plug = JPlugin(name, SR, 2, N)
            st = jax.vmap(lambda _: plug.init_state())(jnp.arange(B_STAGE))
            fn = getattr(sk, f"{name}_stage_step")
            clips = burst_clips(2, B_STAGE, 2, 2 * N)
            for k in range(2):
                o, st, m = fn(plug.full_params(plug.default_params()), st,
                              jnp.asarray(clips[..., k * N:(k + 1) * N]), SR,
                              unroll=4, interpret=True)
                out.update(_flat(f"stage/{name}/{k}", o, st, m))
    finally:
        sk.TILE, sk.MSUB = tile, msub
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_punch_motion",
                            "_jax_punch_motion",
                            tmp_path_factory.mktemp("punch_motion"))


def assert_metrics_close(ours, ref, tol=1e-5):
    """Every metric within `tol` of its scale, max(1, |ref|)."""
    for key, v in ref.items():
        v = np.asarray(v, np.float64)
        d = np.abs(np.asarray(ours[key], np.float64) - v)
        assert np.all(d <= tol * np.maximum(1.0, np.abs(v))), \
            (key, float(d.max()))


def _compare(name, out, state, metrics, ref, what):
    db = residual_dbfs(out.numpy(), ref("out"))
    print(f"{name} {what}: {db:.1f} dBFS vs JAX")
    assert db <= -110.0, f"{name} {what}: {db:.1f} dBFS"
    dsp = to_numpy(state["dsp"])
    for key, v in dsp.items():
        r = ref(f"dsp/{key}")
        assert v.dtype == r.dtype and v.shape == r.shape, key
        if key in EXACT:
            np.testing.assert_array_equal(v, r, err_msg=key)
        else:
            np.testing.assert_allclose(v, r, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(state["analyzer"]["onset_cooldown"].numpy(),
                                  ref("an/onset_cooldown"))
    assert_metrics_close({k: v.numpy() for k, v in metrics.items()},
                         {k: ref(f"m/{k}") for k in metrics})


def _assert_onsets(init, final):
    """Pass 1 rolled the LCG in every clip, and cooldowns are running."""
    assert np.all(final["rng"] != init["rng"])
    assert np.all(final["onset_cooldown"] > 0)
    assert np.all(final["repetition"] > 0)


@pytest.mark.parametrize("name,channels", MODEL_CASES)
def test_torch_model_vs_jax(name, channels, jax_ref):
    jplug = JPlugin(name, SR, channels, N)
    tplug = TPlugin(name, SR, channels, N)
    state = to_torch(jax.device_get(
        jax.vmap(lambda _: jplug.init_state())(jnp.arange(B_MODEL))), "cpu")
    init = to_numpy(state["dsp"])
    clips = burst_clips(1, B_MODEL, channels, 2 * N)
    for k in range(2):
        out, state, m = tplug.batch_step(
            tplug.default_params(), state,
            torch.from_numpy(clips[..., k * N:(k + 1) * N]))
        tag = f"model/{name}/{channels}/{k}"
        _compare(name, out, state, m, lambda key: jax_ref[f"{tag}/{key}"],
                 f"model C={channels} block {k}")
    if name == "motion":
        _assert_onsets(init, to_numpy(state["dsp"]))


@pytest.mark.parametrize("name", ["punch", "motion"])
def test_torch_stage_plain_vs_pallas_interpret(name, jax_ref):
    jplug = JPlugin(name, SR, 2, N)
    params = to_torch(jax.device_get(jplug.full_params(jplug.default_params())),
                      "cpu")
    state = to_torch(jax.device_get(
        jax.vmap(lambda _: jplug.init_state())(jnp.arange(B_STAGE))), "cpu")
    init = to_numpy(state["dsp"])
    clips = burst_clips(2, B_STAGE, 2, 2 * N)
    step = getattr(tsk, f"{name}_stage_step")
    before = step.launches
    for k in range(2):
        out, state, m = step(params, state,
                             torch.from_numpy(clips[..., k * N:(k + 1) * N]), SR)
        _compare(name, out, state, m,
                 lambda key: jax_ref[f"stage/{name}/{k}/{key}"],
                 f"stage block {k}")
    assert step.launches == before              # CPU: the plain version
    if name == "motion":
        _assert_onsets(init, to_numpy(state["dsp"]))


@pytest.mark.parametrize("name,preset", [("punch", "Crater Impact"),
                                         ("motion", None)])
def test_torch_stage_step_matches_plugin_batch_step(name, preset):
    """The stage step's plain version is the model between the two lanes:
    bit-equal audio and state; metrics differ only by the summation order
    of the block reductions."""
    plug = TPlugin(name, SR, 2, N)
    params = plug.preset(preset) if preset else plug.default_params()
    clips = torch.from_numpy(burst_clips(3, 8, 2, 2 * N))
    st_k = st_x = plug.init_state((8,), "cpu")
    for k in range(2):
        blk = clips[..., k * N:(k + 1) * N]
        out_k, st_k, m_k = getattr(tsk, f"{name}_stage_step")(params, st_k,
                                                              blk, SR)
        out_x, st_x, m_x = plug.batch_step(params, st_x, blk)
        assert torch.equal(out_k, out_x)
        for key, v in st_x["dsp"].items():
            assert torch.equal(st_k["dsp"][key], v), key
        assert torch.equal(st_k["analyzer"]["onset_cooldown"],
                           st_x["analyzer"]["onset_cooldown"])
        assert_metrics_close({k: v.numpy() for k, v in m_k.items()},
                             {k: v.numpy() for k, v in m_x.items()})


@pytest.mark.parametrize("name", ["punch", "motion"])
def test_torch_run_corpus_auto_vs_never(name):
    """On the CPU, "auto" takes the stage step (its plain version, no
    launch) and equals "never" (Plugin.batched_run)."""
    plug = TPlugin(name, SR, 2, N)
    clips = burst_clips(4, 12, 2, 3 * N)
    step = getattr(tsk, f"{name}_stage_step")
    before = step.launches
    out_a, last_a, agg = run_corpus(plug, plug.default_params(), clips,
                                    device="cpu")
    out_n, last_n, _ = run_corpus(plug, plug.default_params(), clips,
                                  use_kernel="never", device="cpu")
    assert step.launches == before
    assert torch.equal(out_a, out_n)
    assert_metrics_close({k: v.numpy() for k, v in last_a.items()},
                         {k: v.numpy() for k, v in last_n.items()})
    assert 0.0 <= float(agg["score"]["min"]) <= float(agg["score"]["max"]) <= 100.0
    with pytest.raises(ValueError, match="CUDA"):
        run_corpus(plug, plug.default_params(), clips, use_kernel="always",
                   device="cpu")


@pytest.mark.parametrize("name", ["punch", "motion"])
def test_torch_stage_wrapper_dispatch(name):
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing; another device, batched params, a wrong dtype and a state of
    the wrong shape or type raise."""
    plug = TPlugin(name, SR, 1, N)
    params = plug.default_params()
    blk = torch.from_numpy(burst_clips(5, 3, 1, N))
    st = plug.init_state((3,), "cpu")
    step = getattr(tsk, f"{name}_stage_step")
    plain = getattr(tsk, f"{name}_stage_step_plain")
    before = step.launches
    out_w, _st_w, m_w = step(params, st, blk, SR)
    out_p, _st_p, m_p = plain(params, st, blk, SR)
    assert step.launches == before
    assert torch.equal(out_w, out_p) and torch.equal(m_w["score"], m_p["score"])
    with pytest.raises(ValueError):
        step(params, st, blk.to("meta"), SR)
    key = next(iter(params))
    with pytest.raises(ValueError, match="batched"):
        step(dict(params, **{key: torch.full((3,), 0.5)}), st, blk, SR)
    with pytest.raises(ValueError):
        step(params, st, blk.double(), SR)
    with pytest.raises(ValueError):
        step(params, plug.init_state((4,), "cpu"), blk, SR)
    if name == "motion":
        bad = dict(st["dsp"], rng=st["dsp"]["rng"].to(torch.int32))
        with pytest.raises(ValueError, match="rng"):
            step(params, {"analyzer": st["analyzer"], "dsp": bad}, blk, SR)
