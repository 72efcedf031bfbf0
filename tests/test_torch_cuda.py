"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA GPU and skip without one. This file imports no
JAX; on a machine without it, run it as

    JUICY_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda -q

(the variable keeps tests/conftest.py from setting up JAX's CPU devices).
The batch is ragged (not a multiple of the kernels' thread blocks) and mono
and stereo both run, which chip_smoke.py does not cover; texture runs all
five materials, punch and motion two presets or settings each, and the
seven-stage Chain runs on the card against the CPU. The four stage kernels
also run at batches that are not a multiple of their 32 clips per CTA (45
and 4099) and at a block length that is not a multiple of their chunk
(the saturator and motion also at one shorter than a chunk); at 4099 each
first block runs twice and must give the same bits; the saturator's,
punch's and motion's audio, state and both lanes are held bit-equal to
the plain version's; plastic runs at 3 kHz, where its waveguide's second
tap falls inside the chunk being written. A block with one NaN sample
runs through the saturator and motion kernels, and plastic at 2 kHz
(whose output turns NaN) through the texture kernel: NaN where the plain
version has NaN, every other value equal. The chain kernel runs
three blocks per texture material against its plain version (bit-equal
audio and state) at batches that are not a multiple of its 32 clips per
CTA (300, 45 and 4099), two runs of one input that must be bit-identical,
the Haas delay at 0 and at its largest over seven blocks, its stream
against its step, and ``run_corpus_chain``'s routes on the card.
``analyze_fused`` runs against its plain version at batches of 1, 31,
300 and 4097, mono and stereo, blocks of 1, 7, 100 and 512 samples, with
a NaN sample and on non-contiguous blocks; ``saturator_step_fused``
against its plain version and the saturator stage step; the chain
kernel with per-clip constant rows (at the same batches) against its plain
version run once per distinct row, and the serving pool on the card
against the plain step with the same rows. The finalize's EMA kernel
(``ema_scan``, csrc/finalize.cu) runs against its plain walk at nb = 1, 2
and 94 and B = 1, 33 and 8192 with NaN and +-inf inputs,
``finalize_stream`` on the card against ``finalize_block``, and each chain
stream or step call makes one EMA launch. The host entry points:
``PipelinedStream``'s kernel path at B = 1 against the plain step, one
launch per tick; ``HostBridge`` on the saturator at 1x realtime or faster
over 200 blocks; the CLI's corpus command against ``run_corpus_chain``.
The inputs
are made here, from a seed, so that the file needs nothing of the JAX
test harness.
"""

import numpy as np
import pytest
import torch

from juicy_tpu_torch.kernels import stage_kernels as sk
from juicy_tpu_torch.models import texture as _tex
from juicy_tpu_torch.parallel.corpus import run_corpus
from juicy_tpu_torch.runtime.plugin import Plugin

SR = 48000.0
B, N = 300, 256
#: batches that are not a multiple of the warp-role kernels' 32 clips per
#: CTA (the chain, texture and punch kernels)
RAGGED = (45, 4099)
#: one stream: StreamStep's batch (HostBridge, process, score, --live), one
#: CTA with one busy lane
SINGLE = 1
#: a block length that is not a multiple of the stage kernels' chunk
N_ODD = 203
#: a block length shorter than one chunk
N_SHORT = 5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _clips(seed, channels, blocks, device, batch=B, n=N):
    """Noise over a 220 Hz sine whose level doubles for 10 ms every 60 ms
    (onsets), clipped to +-0.99."""
    rng = np.random.default_rng(seed)
    t = np.arange(blocks * n)
    sig = 0.25 * np.sin(2 * np.pi * 220.0 * t / SR) * (1.0 + (t % 2880 < 480))
    x = sig + 0.05 * rng.standard_normal((batch, channels, blocks * n))
    return torch.from_numpy(np.clip(x, -0.99, 0.99).astype(np.float32)).to(device)


#: (batch, block length) of the saturator cases: the default, the ragged
#: batches (the last CTA part-filled), one stream, an odd block length and
#: one shorter than a chunk
_STAGE_SHAPES = [(B, N), (RAGGED[0], N), (RAGGED[1], N), (SINGLE, N),
                 (SINGLE, N_ODD), (RAGGED[0], N_ODD), (RAGGED[0], N_SHORT)]


def _raw_lanes(name, route, params, st, blk, sr=SR):
    """One block through the stage kernel's raw route ("cuda" or "plain")
    from state `st`: [audio, every state leaf by name, pre fin, pre acc,
    post fin, post acc]."""
    lane0 = sk.pack_lane(st["analyzer"], blk.shape[0])
    if name == "saturator":
        fn = getattr(sk, f"_sat_lanes_{route}")
        out, tone, *lanes = fn(blk, st["dsp"]["tone_state"], lane0,
                               sk._sat_scalars(params, sr))
        leaves = [tone]
    elif name == "texture":
        fn = getattr(sk, f"_tex_lanes_{route}")
        dsp = dict(st["dsp"])
        dsp["waveguide"] = dsp["waveguide"].clone()  # both update it in place
        out, new, *lanes = fn(blk, dsp, lane0, params, sr,
                              _tex.require_static(params))
        leaves = [new[k] for k in sorted(new)]
    else:
        fn = getattr(sk, f"_{name}_lanes_{route}")
        out, new, *lanes = fn(blk, st["dsp"], lane0, params, sr)
        leaves = [new[k] for k in sorted(new)]
    return [out, *leaves, *lanes]


def _assert_raw_equal(name, params, st, blk, sr=SR):
    """Audio, every state leaf and both lanes of the kernel route equal the
    plain version's bit for bit."""
    got = _raw_lanes(name, "cuda", params, st, blk, sr)
    want = _raw_lanes(name, "plain", params, st, blk, sr)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("batch,n", _STAGE_SHAPES)
def test_saturator_stage_kernel_matches_plain(batch, n, channels,
                                              cuda_device):
    """Two streamed blocks: audio, tone state and both lanes bit-equal
    (-fmad=false and the same op order), onset cooldowns equal, metrics
    within 1e-5 (scores 1e-4). At the largest batch the first block runs
    twice from one state and must give the same bits."""
    plug = Plugin("saturator", SR, channels, n)
    params = plug.preset("Grain Reactor")
    clips = _clips(channels, channels, 2, cuda_device, batch, n)
    st_k = st_p = st0 = plug.init_state((batch,), cuda_device)
    if batch == RAGGED[1]:
        runs = [sk.saturator_stage_step(params, st0, clips[..., :n], SR)
                for _ in range(2)]
        torch.cuda.synchronize()
        _assert_same_step(*runs)
    before = sk.saturator_stage_step.launches
    starts = []
    for k in range(2):
        blk = clips[..., k * n:(k + 1) * n]
        starts.append(st_p)
        out_k, st_k, m_k = sk.saturator_stage_step(params, st_k, blk, SR)
        out_p, st_p, m_p = sk.saturator_stage_step_plain(params, st_p, blk, SR)
        torch.cuda.synchronize()
        assert out_k.is_cuda and out_k.shape == blk.shape
        assert torch.equal(out_k, out_p)
        assert torch.equal(st_k["dsp"]["tone_state"], st_p["dsp"]["tone_state"])
        assert torch.equal(st_k["analyzer"]["onset_cooldown"],
                           st_p["analyzer"]["onset_cooldown"])
        for key in m_k:
            tol = 1e-4 if key.endswith("score") else 1e-5
            assert float((m_k[key] - m_p[key]).abs().max()) <= tol, key
    assert sk.saturator_stage_step.launches == before + 2
    if n >= N:
        assert int(st_k["analyzer"]["onset_cooldown"].max()) > 0  # onsets ran
    for k, st in enumerate(starts):
        _assert_raw_equal("saturator", params, st,
                          clips[..., k * n:(k + 1) * n])


@pytest.mark.cuda
def test_run_corpus_always_on_card(cuda_device):
    """use_kernel="always" runs the kernel once per block and agrees with
    "never" (plain batched_run on the card)."""
    plug = Plugin("saturator", SR, 2, N)
    params = plug.preset("Velvet Burn")
    clips = _clips(3, 2, 3, cuda_device)
    before = sk.saturator_stage_step.launches
    out_k, last_k, _ = run_corpus(plug, params, clips, use_kernel="always")
    assert sk.saturator_stage_step.launches == before + 3
    out_n, last_n, _ = run_corpus(plug, params, clips, use_kernel="never")
    assert torch.equal(out_k, out_n)
    assert float((last_k["score"] - last_n["score"]).abs().max()) <= 1e-4


# material -> the state leaves only that material's model moves
_TEX_OWN = {0: ("spring_pos", "spring_vel"), 1: ("modal_y1", "modal_y2"),
            2: ("modal_y1", "prev_wave", "waveguide", "wave_idx"),
            3: ("modal_y1", "prev_wave", "waveguide", "wave_idx"),
            4: ("flesh_pos_a", "flesh_vel_b")}
_TEX_MAT_LEAVES = ("spring_pos", "modal_y1", "prev_wave", "waveguide",
                   "flesh_pos_a")


def _kernel_form(st, material):
    return {"analyzer": st["analyzer"],
            "dsp": sk.texture_kernel_state(st["dsp"], material)}


# (material, batch, block length, sample rate): every material at the
# default batch, the ragged ones, one stream and an odd block length;
# plastic at 3 kHz, where its waveguide delay is 8 samples, one chunk, and
# the interpolation's second tap falls inside the chunk being written
_TEX_CASES = [(m, b, n, SR) for m in range(5)
              for b, n in ((B, N), (RAGGED[0], N), (RAGGED[1], N),
                           (SINGLE, N), (RAGGED[0], N_ODD))] + [
    (3, RAGGED[0], N, 3000.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("material,batch,n,sr", _TEX_CASES)
def test_texture_stage_kernel_matches_plain(material, batch, n, sr, channels,
                                            cuda_device):
    """Two streamed blocks per material: audio and every state leaf
    bit-equal (the ring included), onset cooldowns equal, metrics within
    1e-5 (scores 1e-4); the material's own state moved, the others not. At
    the largest batch the first block runs twice from copies of one state
    and must give the same bits (no result depends on how the warps of a
    CTA interleave)."""
    plug = Plugin("texture", sr, channels, n).with_static(material=material)
    params = plug.full_params(plug.default_params())
    clips = _clips(10 + material, channels, 2, cuda_device, batch, n)
    st0 = plug.init_state((batch,), cuda_device)
    st_k, st_p = (_kernel_form(st0, material) for _ in range(2))
    if batch == RAGGED[1]:
        runs = [sk.texture_stage_step(params, _kernel_form(st0, material),
                                      clips[..., :n], sr) for _ in range(2)]
        torch.cuda.synchronize()
        _assert_same_step(*runs)
    before = sk.texture_stage_step.launches
    for k in range(2):
        blk = clips[..., k * n:(k + 1) * n]
        out_k, st_k, m_k = sk.texture_stage_step(params, st_k, blk, sr)
        out_p, st_p, m_p = sk.texture_stage_step_plain(params, st_p, blk, sr)
        torch.cuda.synchronize()
        assert out_k.is_cuda and out_k.shape == blk.shape
        assert torch.equal(out_k, out_p)
        for key, v in st_p["dsp"].items():
            assert torch.equal(st_k["dsp"][key], v), key
        assert torch.equal(st_k["analyzer"]["onset_cooldown"],
                           st_p["analyzer"]["onset_cooldown"])
        for key in m_k:
            tol = 1e-4 if key.endswith("score") else 1e-5
            assert float((m_k[key] - m_p[key]).abs().max()) <= tol, key
    assert sk.texture_stage_step.launches == before + 2
    final = sk.texture_ring_state(st_k["dsp"], material)
    for key in _TEX_MAT_LEAVES:
        moved = not torch.equal(final[key], st0["dsp"][key])
        assert moved == (key in _TEX_OWN[material]), key
    assert torch.equal(final["rng"], _lcg_advance_twice(st0["dsp"]["rng"],
                                                        channels, n))


def _lcg_advance_twice(rng, channels, n):
    from juicy_tpu_torch.ops.noise import lcg_advance
    return lcg_advance(rng, 2 * channels * n)


def _assert_same_step(a, b):
    """Two (out, state, metrics) results equal bit for bit."""
    assert torch.equal(a[0], b[0])
    for group in ("dsp", "analyzer"):
        for key, v in a[1][group].items():
            assert torch.equal(b[1][group][key], v), (group, key)
    for key, v in a[2].items():
        assert torch.equal(b[2][key], v), key


@pytest.mark.cuda
def test_texture_run_corpus_always_on_card(cuda_device):
    """Wood through run_corpus: one launch per block, equal to "never"."""
    plug = Plugin("texture", SR, 2, N).with_static(material=2)
    params = plug.default_params()
    clips = _clips(4, 2, 3, cuda_device)
    before = sk.texture_stage_step.launches
    out_k, last_k, _ = run_corpus(plug, params, clips, use_kernel="always")
    assert sk.texture_stage_step.launches == before + 3
    out_n, last_n, _ = run_corpus(plug, params, clips, use_kernel="never")
    assert torch.equal(out_k, out_n)
    assert float((last_k["score"] - last_n["score"]).abs().max()) <= 1e-4


# (name, params, batch, block length) per case: params are a preset name,
# or a dict over the defaults; punch and motion also at the ragged batches,
# one stream, an odd block length and one shorter than a chunk
_PUNCH_MOTION = [("punch", "Solar Snap", B, N), ("punch", "Apocalypse Tap", B, N),
                 ("motion", None, B, N),
                 ("motion", dict(microvar=0.9, motiondepth=1.8,
                                 repeatctrl=0.2, budget=0.9, mix=0.7), B, N),
                 ("punch", "Solar Snap", RAGGED[0], N),
                 ("punch", "Solar Snap", RAGGED[1], N),
                 ("punch", "Apocalypse Tap", RAGGED[0], N_ODD),
                 ("motion", None, RAGGED[0], N),
                 ("motion", None, RAGGED[1], N),
                 ("motion", dict(microvar=0.9, motiondepth=1.8,
                                 repeatctrl=0.2, budget=0.9, mix=0.7),
                  RAGGED[0], N_ODD),
                 ("motion", None, RAGGED[0], N_SHORT),
                 ("punch", "Solar Snap", SINGLE, N),
                 ("punch", "Apocalypse Tap", SINGLE, N_ODD),
                 ("motion", None, SINGLE, N),
                 ("motion", dict(microvar=0.9, motiondepth=1.8,
                                 repeatctrl=0.2, budget=0.9, mix=0.7),
                  SINGLE, N_ODD)]


def _params(plug, preset):
    if isinstance(preset, dict):
        return dict(plug.default_params(), **{
            k: torch.tensor(v, dtype=torch.float32) for k, v in preset.items()})
    return plug.preset(preset) if preset else plug.default_params()


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("name,preset,batch,n", _PUNCH_MOTION)
def test_punch_motion_stage_kernel_matches_plain(name, preset, batch, n,
                                                 channels, cuda_device):
    """Two streamed blocks: audio, every state leaf (motion's rng,
    onset_cooldown and repetition included) and both lanes bit-equal,
    metrics within 1e-5 (scores 1e-4); motion's onsets ran inside the
    blocks in most clips. At the largest batch the first block runs twice
    from one state and must give the same bits."""
    plug = Plugin(name, SR, channels, n)
    params = _params(plug, preset)
    step = getattr(sk, f"{name}_stage_step")
    plain = getattr(sk, f"{name}_stage_step_plain")
    clips = _clips(20 + channels, channels, 2, cuda_device, batch, n)
    st_k = st_p = st0 = plug.init_state((batch,), cuda_device)
    if batch == RAGGED[1]:
        runs = [step(params, st0, clips[..., :n], SR) for _ in range(2)]
        torch.cuda.synchronize()
        _assert_same_step(*runs)
    before = step.launches
    starts = []
    for k in range(2):
        blk = clips[..., k * n:(k + 1) * n]
        starts.append(st_p)
        out_k, st_k, m_k = step(params, st_k, blk, SR)
        out_p, st_p, m_p = plain(params, st_p, blk, SR)
        torch.cuda.synchronize()
        assert out_k.is_cuda and out_k.shape == blk.shape
        assert torch.equal(out_k, out_p)
        assert set(st_k["dsp"]) == set(st_p["dsp"])
        for key, v in st_p["dsp"].items():
            assert st_k["dsp"][key].dtype == v.dtype, key
            assert torch.equal(st_k["dsp"][key], v), key
        assert torch.equal(st_k["analyzer"]["onset_cooldown"],
                           st_p["analyzer"]["onset_cooldown"])
        for key in m_k:
            tol = 1e-4 if key.endswith("score") else 1e-5
            assert float((m_k[key] - m_p[key]).abs().max()) <= tol, key
    assert step.launches == before + 2
    if name == "motion" and n >= N:
        moved = st_k["dsp"]["rng"] != st0["dsp"]["rng"]
        assert float(moved.float().mean()) > 0.9
        assert int(st_k["dsp"]["onset_cooldown"].max()) > 0
    for k, st in enumerate(starts):
        _assert_raw_equal(name, params, st, clips[..., k * n:(k + 1) * n])


def _nan_clips(seed, channels, batch, n):
    """_clips with one NaN sample: clip 3, channel 0, sample 10."""
    x = _clips(seed, channels, 2, "cpu", batch, n)
    x[3, 0, 10] = float("nan")
    return x


def _assert_raw_close_nan(name, params, st, blk, sr=SR):
    """The kernel route against the plain version: every value equal, NaN
    where the plain version has NaN."""
    got = _raw_lanes(name, "cuda", params, st, blk, sr)
    want = _raw_lanes(name, "plain", params, st, blk, sr)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=f"output {i}")
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("name", ["saturator", "motion"])
def test_stage_kernel_keeps_nan(name, channels, cuda_device):
    """A block with one NaN sample through the saturator and motion
    kernels, then a block after it: audio, every state leaf and both lanes
    equal the plain version's, NaN where it has NaN (the clamps and extrema
    keep a NaN, as torch.clamp and torch.maximum do)."""
    plug = Plugin(name, SR, channels, N)
    params = (plug.preset("Grain Reactor") if name == "saturator"
              else plug.default_params())
    plain = getattr(sk, f"{name}_stage_step_plain")
    clips = _nan_clips(90 + channels, channels, B, N).to(cuda_device)
    st = plug.init_state((B,), cuda_device)
    for k in range(2):
        blk = clips[..., k * N:(k + 1) * N]
        want = _assert_raw_close_nan(name, params, st, blk)
        assert bool(torch.isnan(want[0][3]).any())
        assert not bool(torch.isnan(want[0][:3]).any())  # the other clips
        st = plain(params, st, blk, SR)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2])
def test_texture_kernel_keeps_nan_plastic_2khz(channels, cuda_device):
    """Plastic at a 2 kHz sample rate: its filters lie past Nyquist and the
    plain version's output turns NaN within two blocks. The kernel keeps
    every NaN where the plain version has it and equals it elsewhere:
    audio, every state leaf (the ring included) and both lanes."""
    sr, batch = 2000.0, RAGGED[0]
    plug = Plugin("texture", sr, channels, N).with_static(material=3)
    params = plug.full_params(plug.default_params())
    clips = _clips(95 + channels, channels, 2, cuda_device, batch, N)
    st = _kernel_form(plug.init_state((batch,), cuda_device), 3)
    nan_seen = False
    for k in range(2):
        blk = clips[..., k * N:(k + 1) * N]
        want = _assert_raw_close_nan("texture", params, st, blk, sr)
        nan_seen = nan_seen or bool(torch.isnan(want[0]).any())
        st = sk.texture_stage_step_plain(params, st, blk, sr)[1]
    assert nan_seen


@pytest.mark.cuda
@pytest.mark.parametrize("name,preset", [("punch", "Crater Impact"),
                                         ("motion", None)])
def test_punch_motion_run_corpus_always_on_card(name, preset, cuda_device):
    """run_corpus: one launch per block, equal to "never"."""
    plug = Plugin(name, SR, 2, N)
    params = _params(plug, preset)
    step = getattr(sk, f"{name}_stage_step")
    clips = _clips(5, 2, 3, cuda_device)
    before = step.launches
    out_k, last_k, _ = run_corpus(plug, params, clips, use_kernel="always")
    assert step.launches == before + 3
    out_n, last_n, _ = run_corpus(plug, params, clips, use_kernel="never")
    assert torch.equal(out_k, out_n)
    assert float((last_k["score"] - last_n["score"]).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name,preset,auto", [
    ("punch", "Crater Impact", {"punch": [0.2, 1.4, 0.7]}),
    ("saturator", "Velvet Burn", {"drive": [3.0, 15.0, 9.0]})])
def test_run_corpus_automation_always_on_card(name, preset, auto,
                                              cuda_device):
    """run_corpus(automation=) on the stage kernel: one launch per block,
    each with its block's constants, equal to "never" (batched_run with
    the same curves); the curves move the render."""
    plug = Plugin(name, SR, 2, N)
    params = _params(plug, preset)
    step = getattr(sk, f"{name}_stage_step")
    clips = _clips(5, 2, 3, cuda_device)
    before = step.launches
    out_k, last_k, _ = run_corpus(plug, params, clips, use_kernel="always",
                                  automation=auto)
    assert step.launches == before + 3
    out_n, last_n, _ = run_corpus(plug, params, clips, use_kernel="never",
                                  automation=auto)
    assert torch.equal(out_k, out_n)
    assert float((last_k["score"] - last_n["score"]).abs().max()) <= 1e-4
    flat, _last, _agg = run_corpus(plug, params, clips, use_kernel="always")
    assert not torch.equal(out_k, flat)


@pytest.mark.cuda
def test_chain_on_card_matches_cpu(cuda_device):
    """The seven-stage Chain's batched_run on the card against the same call
    on the CPU: audio within -100 dBFS, every stage's metrics within 1e-5
    of their scale (max(1, |value|))."""
    from juicy_tpu_torch.runtime.plugin import Chain

    chain = Chain([("punch", "Solar Snap"), ("saturator", "Amber Heat"),
                   ("texture", None), ("motion", None), ("width", "Prism Arc"),
                   ("cohere", None), ("infer", "Reference Lens")], SR, 2, N)
    clips = _clips(6, 2, 2, cuda_device)[:64]
    out_g, _st, m_g = chain.batched_run(chain.init_state((64,), cuda_device),
                                        clips)
    out_c, _st, m_c = chain.batched_run(chain.init_state((64,), "cpu"),
                                        clips.cpu())
    diff = float((out_g.cpu().double() - out_c.double()).abs().max())
    assert diff <= 1e-5, diff
    for stage_g, stage_c in zip(m_g, m_c, strict=True):
        for key, v in stage_c.items():
            d = (stage_g[key].cpu().double() - v.double()).abs()
            assert bool((d <= 1e-5 * v.double().abs().clamp(min=1.0)).all()), key


# ---------------------------------------------------------------------------
# The chain kernel (csrc/chain.cu) against its plain version
# ---------------------------------------------------------------------------

def _bursts(seed, blocks, device, period=384, batch=B):
    """A quiet bed and a decaying 900 Hz burst every `period` samples from
    a per-clip offset (chip_smoke.py::make_clicks, drawn with numpy), so
    that onsets fall inside the blocks."""
    rng = np.random.default_rng(seed)
    t = np.arange(blocks * N)
    since = (t[None, :] - rng.integers(0, period, (batch, 1))) % period
    burst = np.exp(-since / 120.0) * 0.6 * np.sin(2 * np.pi * 900.0 * since / SR)
    bed = 0.008 * np.sin(2 * np.pi * 220.0 * t / SR)
    x = bed + np.array([1.0, 0.9])[None, :, None] * burst[:, None, :] + \
        0.002 * rng.standard_normal((batch, 2, blocks * N))
    return torch.from_numpy(np.clip(x, -0.99, 0.99).astype(np.float32)).to(device)


def _chain(material, learn=True, haas_ms=None):
    """bench.py's chain with texture `material` (cohere's learn on, so that
    its targets move); `haas_ms` replaces width's Haas delay."""
    from juicy_tpu_torch.runtime.plugin import Chain

    chain = Chain([("punch", "Solar Snap"), ("saturator", "Amber Heat"),
                   ("texture", {"material": material}), ("motion", None),
                   ("width", "Prism Arc"),
                   ("cohere", {"learn": 1.0, "match": 0.9} if learn else None),
                   ("infer", "Reference Lens")], SR, 2, N)
    if haas_ms is not None:
        chain.params[4] = dict(chain.params[4],
                               haasMs=torch.tensor(float(haas_ms)))
    return chain


def _assert_chain_equal(res_k, res_p):
    """Audio and every state leaf bit-equal, metrics within 1e-5 of
    max(1, |value|)."""
    (out_k, st_k, m_k), (out_p, st_p, m_p) = res_k, res_p
    assert out_k.is_cuda and torch.equal(out_k, out_p)
    for sk_, sp in zip(st_k, st_p, strict=True):
        for group in ("dsp", "analyzer"):
            assert set(sk_[group]) == set(sp[group])
            for key, v in sp[group].items():
                assert sk_[group][key].dtype == v.dtype, (group, key)
                assert torch.equal(sk_[group][key], v), (group, key)
    for mk, mp in zip(m_k, m_p, strict=True):
        for key, v in mp.items():
            d = (mk[key].double() - v.double()).abs()
            assert bool((d <= 1e-5 * v.double().abs().clamp(min=1.0)).all()), key


@pytest.mark.cuda
@pytest.mark.parametrize("batch", (B, *RAGGED))
@pytest.mark.parametrize("material", [0, 1, 2, 3, 4])
def test_chain_kernel_matches_plain(material, batch, cuda_device):
    """Three streamed blocks of a batch whose last CTA is partly past B
    (a lane past B that stored, or a barrier it skipped, would show here
    or hang): one launch per block and no stage kernel; audio and every
    state leaf (texture's ring and LCG, motion's rng and cooldown, the Haas
    window, cohere's targets) bit-equal to the plain version; onsets inside
    the blocks; the material's own state moved and no other's."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    chain = _chain(material)
    clips = _bursts(30 + material, 3, cuda_device, batch=batch)
    st0 = chain.init_state((batch,), cuda_device)
    stage_before = [s.launches for s in (
        sk.punch_stage_step, sk.saturator_stage_step, sk.texture_stage_step,
        sk.motion_stage_step)]
    before = ck.chain_kernel_step.launches
    res_k = ck.chain_kernel_stream(chain, st0, clips)
    assert ck.chain_kernel_step.launches == before + 3
    res_p = ck.chain_kernel_stream_plain(chain, st0, clips)
    torch.cuda.synchronize()
    _assert_chain_equal(res_k, res_p)
    assert stage_before == [s.launches for s in (
        sk.punch_stage_step, sk.saturator_stage_step, sk.texture_stage_step,
        sk.motion_stage_step)]
    st = res_k[1]
    rolled = (st[3]["dsp"]["rng"] != st0[3]["dsp"]["rng"]).float().mean()
    assert float(rolled) > 0.9
    assert not torch.equal(st[5]["dsp"]["target_low"],
                           st0[5]["dsp"]["target_low"])
    for key in _TEX_MAT_LEAVES:
        moved = not torch.equal(st[2]["dsp"][key], st0[2]["dsp"][key])
        assert moved == (key in _TEX_OWN[material]), key


@pytest.mark.cuda
@pytest.mark.parametrize("material", [0, 2])
def test_chain_kernel_deterministic(material, cuda_device):
    """Two runs of the same input from the same state are bit-identical:
    no result depends on how the warps of a CTA interleave."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    batch = RAGGED[1]
    chain = _chain(material)
    clips = _bursts(80 + material, 2, cuda_device, batch=batch)
    st0 = chain.init_state((batch,), cuda_device)
    res_a = ck.chain_kernel_stream(chain, st0, clips)
    res_b = ck.chain_kernel_stream(chain, st0, clips)
    torch.cuda.synchronize()
    assert torch.equal(res_a[0], res_b[0])
    for sa, sb in zip(res_a[1], res_b[1], strict=True):
        for group in ("dsp", "analyzer"):
            for key, v in sa[group].items():
                assert torch.equal(sb[group][key], v), (group, key)
    for ma, mb in zip(res_a[2], res_b[2], strict=True):
        for key, v in ma.items():
            assert torch.equal(mb[key], v), key


@pytest.mark.cuda
@pytest.mark.parametrize("haas_ms", [0.0, 35.0])
def test_chain_kernel_haas_delays(haas_ms, cuda_device):
    """The Haas ring at a delay of 0 (the read is the value just written)
    and at the largest (1680 of 1696 samples), over seven blocks so that
    the read crosses from the window into the blocks' own output."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    chain = _chain(0, learn=False, haas_ms=haas_ms)
    clips = _bursts(40, 7, cuda_device)[:64]
    st0 = chain.init_state((64,), cuda_device)
    res_k = ck.chain_kernel_stream(chain, st0, clips, metrics="final")
    res_p = ck.chain_kernel_stream_plain(chain, st0, clips, metrics="final")
    torch.cuda.synchronize()
    _assert_chain_equal(res_k, res_p)


@pytest.mark.cuda
def test_chain_kernel_stream_matches_step(cuda_device):
    """The stream (state packed once, lanes finalized once) equals the step
    applied block by block (packed and finalized per block), bit for bit."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    chain = _chain(2)
    clips = _bursts(50, 3, cuda_device)
    st0 = chain.init_state((B,), cuda_device)
    out_s, st_s, m_s = ck.chain_kernel_stream(chain, st0, clips)
    st = st0
    for k in range(3):
        out, st, m = ck.chain_kernel_step(chain, st, clips[..., k * N:(k + 1) * N])
        assert torch.equal(out, out_s[..., k * N:(k + 1) * N])
        for a, b in zip(m, m_s, strict=True):
            for key, v in a.items():
                assert torch.equal(b[key][k], v), (k, key)
    _assert_chain_equal((out_s, st_s, m_s), (out_s, st, m_s))


@pytest.mark.cuda
def test_run_corpus_chain_always_on_card(cuda_device):
    """use_kernel="always": one chain-kernel launch per block, the same
    result as "auto", and within -100 dBFS and 1e-3 (last-block scores) of
    "never" (the block-major executor on the card)."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.parallel.corpus import run_corpus_chain

    chain = _chain(0, learn=False)
    clips = _bursts(60, 3, cuda_device)
    before = ck.chain_kernel_step.launches
    out_k, ms_k, agg = run_corpus_chain(chain, clips, use_kernel="always")
    assert ck.chain_kernel_step.launches == before + 3
    out_a, ms_a, _ = run_corpus_chain(chain, clips)
    assert torch.equal(out_k, out_a)
    out_n, ms_n, _ = run_corpus_chain(chain, clips, use_kernel="never")
    diff = float((out_k.double() - out_n.double()).abs().max())
    assert diff <= 1e-5, diff
    assert float((ms_k[-1]["score"] - ms_n[-1]["score"]).abs().max()) <= 1e-3
    assert 0.0 <= float(agg["score"]["min"]) <= float(agg["score"]["max"]) <= 100.0


# ---------------------------------------------------------------------------
# The finalize's repetition/fatigue EMA walk (csrc/finalize.cu)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 33, 8192])
@pytest.mark.parametrize("nb", [1, 2, 94])
def test_ema_scan_matches_plain(nb, batch, cuda_device):
    """ema_scan on CUDA tensors: one launch of csrc/finalize.cu whose
    density, risk and final EMA states are the plain walk's on the card, bit
    for bit, NaN where it has NaN, with NaN and +-inf among the inputs and a
    NaN in the seed state."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from ema_cases import assert_same_bits, ema_inputs

    args = ema_inputs(nb, batch, cuda_device, seed=100 + nb)
    before = ck.ema_scan.launches
    got = ck.ema_scan(*args)
    assert ck.ema_scan.launches == before + 1
    want = ck.ema_scan_plain(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("density", "risk", "rep", "fat"), got, want,
                          strict=True):
        assert g.is_cuda, name
        assert_same_bits(g, w, name)
    assert bool(torch.isnan(got[0]).any())


@pytest.mark.cuda
def test_finalize_stream_on_card_matches_finalize_block(cuda_device):
    """The stream's finalize on the card (the formulas once, the EMA in one
    ema_scan launch) equals finalize_block applied block by block there,
    bit for bit: every stage's metrics and the analyzer states."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    nb = 4
    chain = _chain(0)
    clips = _bursts(70, nb, cuda_device, batch=RAGGED[0])
    st0 = chain.init_state((RAGGED[0],), cuda_device)
    _out, _dsps, fin, acc, fit = ck._run_cuda(chain, st0, clips, False)
    an = [st["analyzer"] for st in st0]
    before = ck.ema_scan.launches
    new_an, metrics = ck.finalize_stream(chain, an, fin, acc, fit)
    assert ck.ema_scan.launches == before + 1
    for blk in range(nb):
        an, m_blk = ck.finalize_block(chain, an, fin[blk], acc[blk], fit[blk])
        for m, mb in zip(metrics, m_blk, strict=True):
            assert set(m) == set(mb)
            for key, v in mb.items():
                assert torch.equal(m[key][blk], v), (blk, key)
    for a, b in zip(new_an, an, strict=True):
        for key, v in b.items():
            assert a[key].dtype == v.dtype and torch.equal(a[key], v), key


@pytest.mark.cuda
def test_chain_kernel_one_ema_launch_per_call(cuda_device):
    """One chain_kernel_stream call over three blocks raises ema_scan's
    count by exactly one (and the chain kernel's by three); one
    chain_kernel_step (the nb = 1 finalize) by one."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    chain = _chain(2)
    clips = _bursts(80, 3, cuda_device)
    st0 = chain.init_state((B,), cuda_device)
    ema, chain_launches = ck.ema_scan.launches, ck.chain_kernel_step.launches
    ck.chain_kernel_stream(chain, st0, clips, metrics="final")
    assert ck.ema_scan.launches == ema + 1
    assert ck.chain_kernel_step.launches == chain_launches + 3
    ck.chain_kernel_step(chain, st0, clips[..., :N])
    torch.cuda.synchronize()
    assert ck.ema_scan.launches == ema + 2
    assert ck.chain_kernel_step.launches == chain_launches + 4


# ---------------------------------------------------------------------------
# analyze_fused (csrc/analyzer.cu), saturator_step_fused, per-clip param rows
# and the serving pool on the card
# ---------------------------------------------------------------------------

#: analyze_fused's cases (batch, channels, block length, kind): one clip,
#: a CTA short of a lane, ragged, one past a multiple of 32; mono and
#: stereo; one sample, fewer than a group of four, not a whole number of
#: 32-sample chunks, the main path's 512. "nan": a NaN sample in the first
#: block; "strided": each block a non-contiguous view.
_ANALYZER_CASES = [
    *((b, c, n, "contiguous") for b in (1, 31, 300, 4097) for c in (1, 2)
      for n in (1, 7, 100, 512)),
    (300, 2, 512, "nan"), (300, 2, 512, "strided"), (31, 1, 100, "strided")]


def _bit_equal(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,channels,n,kind", _ANALYZER_CASES)
def test_analyze_fused_kernel_matches_plain(batch, channels, n, kind,
                                            cuda_device):
    """Two blocks, the second from the first's state: the lanes (fin, acc)
    bit-equal to the plain version's (NaN where it has NaN), so the state
    and the metrics are too, the cooldowns exactly; one launch per block."""
    from juicy_tpu_torch.analyzer import analyzer_init
    from juicy_tpu_torch.kernels import analyzer_kernel as ak

    clips = _clips(70 + channels, channels, 2, cuda_device, batch=batch, n=n)
    if kind == "nan":
        clips[batch // 2, 0, n // 3] = float("nan")
    lane_k = sk._lane_consts(SR)
    st_k = st_p = analyzer_init((batch,), cuda_device)
    for k in range(2):
        blk = clips[..., k * n:(k + 1) * n]
        blk = (blk.permute(2, 1, 0).contiguous().permute(2, 1, 0)
               if kind == "strided" else blk.contiguous())
        assert blk.is_contiguous() == (kind != "strided")
        lane0 = sk.pack_lane(st_k, batch)
        raw_k = ak._analyzer_lanes_cuda(blk, lane0, lane_k)
        raw_p = ak._analyzer_lanes_plain(blk, lane0, lane_k)
        for got, want in zip(raw_k, raw_p):
            _bit_equal(got, want)
        before = ak.analyze_fused.launches
        st_k, m_k = ak.analyze_fused(st_k, blk, SR)
        assert ak.analyze_fused.launches == before + 1
        st_p, m_p = ak.analyze_fused_plain(st_p, blk, SR)
        torch.cuda.synchronize()
        assert torch.equal(st_k["onset_cooldown"], st_p["onset_cooldown"])
        for tree_k, tree_p in ((st_k, st_p), (m_k, m_p)):
            for key, v in tree_p.items():
                _bit_equal(tree_k[key], v)
    if kind == "nan":
        assert bool(torch.isnan(st_k["short_env"][batch // 2]))
    if n >= 100:
        assert int(st_k["onset_cooldown"].max()) > 0  # onsets ran


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2])
def test_saturator_step_fused_matches_plain_and_stage(channels, cuda_device):
    """saturator_step_fused launches csrc/saturator_stage.cu under its own
    count: bit-equal to its plain version and to saturator_stage_step."""
    from juicy_tpu_torch.kernels import saturator_kernel as satk

    plug = Plugin("saturator", SR, channels, N)
    params = plug.preset("Amber Heat")
    clips = _clips(80 + channels, channels, 2, cuda_device)
    st_f = st_p = st_s = plug.init_state((B,), cuda_device)
    before = (satk.saturator_step_fused.launches,
              sk.saturator_stage_step.launches)
    for k in range(2):
        blk = clips[..., k * N:(k + 1) * N]
        out_f, st_f, m_f = satk.saturator_step_fused(plug, params, st_f, blk)
        out_p, st_p, m_p = satk.saturator_step_fused_plain(plug, params,
                                                           st_p, blk)
        torch.cuda.synchronize()
        assert out_f.is_cuda and torch.equal(out_f, out_p)
        assert torch.equal(st_f["dsp"]["tone_state"], st_p["dsp"]["tone_state"])
        for key, v in m_p.items():
            assert torch.equal(m_f[key], v), key
    assert satk.saturator_step_fused.launches == before[0] + 2
    out_s, st_s, m_s = sk.saturator_stage_step(plug.full_params(params), st_s,
                                               clips[..., :N], SR)
    assert sk.saturator_stage_step.launches == before[1] + 1
    out_f, _st, m_f = satk.saturator_step_fused(
        plug, params, plug.init_state((B,), cuda_device), clips[..., :N])
    assert torch.equal(out_f, out_s)
    for key, v in m_s.items():
        assert torch.equal(m_f[key], v), key


def _rows(chain, b, seed=0):
    """Per-clip rows over the chain's params: a quarter of the clips with
    punch, infer's trim and sensitivity, width's Haas delay or a texture
    knob edited."""
    rows = [{k: torch.full((b,), float(v)) for k, v in p.items()}
            for p in chain.params]
    for j in range(seed % 4, b, 4):
        kind = (j // 4) % 4
        if kind == 0:
            rows[0]["punch"][j] = 0.3
        elif kind == 1:
            rows[6]["trim"][j] = -4.0
            rows[6]["sensitivity"][j] = 1.5
        elif kind == 2:
            rows[4]["haasMs"][j] = 30.0
        else:
            rows[2]["weight"][j] = 0.9
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("batch", (B, *RAGGED))
@pytest.mark.parametrize("material", [0, 2])
def test_chain_kernel_params_rows_matches_plain(material, batch, cuda_device):
    """Per-clip constant rows (stride N_CONSTS) against the plain version
    run once per distinct row, over two blocks, ragged batches included;
    rows all equal to the chain's give the shared launch bit for bit."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    chain = _chain(material)
    clips = _bursts(90 + material, 2, cuda_device, batch=batch)
    st0 = chain.init_state((batch,), cuda_device)
    same = [{k: torch.full((batch,), float(v)) for k, v in p.items()}
            for p in chain.params]
    blk = clips[..., :N]
    res_shared = ck.chain_kernel_step(chain, st0, blk)
    res_same = ck.chain_kernel_step(chain, st0, blk, params_rows=same)
    _assert_chain_equal(res_same, res_shared)
    rows = ck.ParamRows(chain, _rows(chain, batch), batch)
    st_k = st_p = st0
    before = ck.chain_kernel_step.launches
    for k in range(2):
        blk = clips[..., k * N:(k + 1) * N]
        res_k = ck.chain_kernel_step(chain, st_k, blk, params_rows=rows)
        res_p = ck.chain_kernel_step_plain(chain, st_p, blk, params_rows=rows)
        torch.cuda.synchronize()
        _assert_chain_equal(res_k, res_p)
        st_k, st_p = res_k[1], res_p[1]
    assert ck.chain_kernel_step.launches == before + 2


@pytest.mark.cuda
def test_stream_server_on_card(cuda_device):
    """The pool on the card: one chain-kernel launch per tick and no other
    kernel; its ticks, with per-slot edits, equal the plain step with the
    same rows on the card (audio bit-equal, scores exactly); async ticks
    equal sync ones; the i16 wire within 1.01/32768 of the f32 wire."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.runtime.serve import StreamServer

    chain = _chain(2, learn=False)
    s = 40
    # PCM16 values as floats: the i16 wire's input is then the f32 wire's
    clips = np.round(_bursts(95, 4, cuda_device)[:s].cpu().numpy()
                     * 32768.0).astype(np.float32) / 32768.0
    servers = {name: StreamServer(chain, s, **kw) for name, kw in (
        ("sync", {}), ("async", {}), ("i16", {"wire": "i16"}))}
    for srv in servers.values():
        srv.warmup()
        sids = [srv.open_stream() for _ in range(s - 2)]   # two slots idle
        rows = _rows(chain, s)
        for j in sids[::3]:
            for i, stage_rows in enumerate(rows):
                srv.set_params(j, i, **{k: float(v[j])
                                        for k, v in stage_rows.items()})
    # the warmup built each pool's table; the edits rewrote its rows in place
    fresh = ck.ParamRows(chain, [{k: torch.from_numpy(v) for k, v in p.items()}
                                 for p in servers["sync"]._params], s)
    for srv in servers.values():
        assert torch.equal(srv._pools[0].param_rows().table(srv.device).cpu(),
                           fresh.table("cpu"))
    sids = np.arange(s - 2)
    states = chain.init_state((s,), cuda_device)
    pending = []
    for k in range(4):
        blk = clips[:s - 2, :, k * N:(k + 1) * N]
        for srv in servers.values():
            srv.submit_many(sids, blk)
        stage = [sk_.launches for sk_ in (sk.punch_stage_step,
                                          sk.saturator_stage_step,
                                          sk.texture_stage_step,
                                          sk.motion_stage_step)]
        before = ck.chain_kernel_step.launches
        got = servers["sync"].tick_arrays()
        assert ck.chain_kernel_step.launches == before + 1
        assert stage == [sk_.launches for sk_ in (
            sk.punch_stage_step, sk.saturator_stage_step,
            sk.texture_stage_step, sk.motion_stage_step)]
        pending.append((got, servers["async"].tick_arrays_async()))
        x = torch.zeros((s, 2, N), device=cuda_device)
        x[:s - 2] = torch.from_numpy(blk).to(cuda_device)
        out_p, states, m_p = ck.chain_kernel_step_plain(
            chain, states, x, params_rows=servers["sync"]._pools[0].param_rows())
        assert np.array_equal(got[1], out_p[:s - 2].cpu().numpy())
        assert np.array_equal(got[2], m_p[-1]["score"][:s - 2].cpu().numpy())
        i16 = servers["i16"].tick_arrays()
        assert i16[1].dtype == np.int16
        # the wire clamps to the PCM16 range; the chain's output passes 1.0
        np.testing.assert_allclose(i16[1].astype(np.float32) / 32768.0,
                                   np.clip(got[1], -1.0, 32767.0 / 32768.0),
                                   rtol=0, atol=1.01 / 32768.0)
    for want, handle in pending:
        for a, b in zip(handle.result(), want):
            assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# Per-clip texture materials (the mixed kernels, a material per CTA) and
# per-block automation of the chain kernel
# ---------------------------------------------------------------------------

def _traced_chain(materials, learn=True):
    """bench.py's chain (as _chain) whose texture stage takes a material
    per clip."""
    chain = _chain(0, learn=learn)
    chain.plugins[2] = Plugin("texture", SR, 2, N).with_traced("material")
    chain.params[2] = dict(
        {k: v for k, v in chain.params[2].items() if k != "material"},
        material=torch.as_tensor(np.asarray(materials), dtype=torch.float32))
    return chain


def _raw_chain(route, chain, st0, clips, automation=None):
    """The chain kernel's raw route ("cuda" or "plain") over `clips`, the
    clips sorted by material where the CTAs need it: [audio, every DSP
    state leaf, fin, acc, context fit]."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.runtime.chain_fused import chain_automation

    run = ck._run_cuda if route == "cuda" else ck._run_plain
    curves = chain_automation(chain, automation, clips.shape[-1] // N)
    out, dsps, fin, acc, fit = ck._ordered(run, chain, list(st0), clips, True,
                                           None, curves)
    return [out, *[d[k] for d in dsps for k in sorted(d)], fin, acc, fit]


def _assert_all_equal(got, want):
    """Every tensor equal bit for bit, NaN where the other has NaN."""
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, i
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=f"tensor {i}")


#: (materials, batch): CTA-uniform runs (gel, wood, flesh, plastic, metal),
#: and a ragged corpus whose material runs are not multiples of 32 (sorted
#: and padded by the wrapper)
_MIXED_CASES = [("runs", 160), ("ragged", 100), ("ragged", 301)]


def _mixed_materials(kind, batch, seed=0):
    if kind == "runs":
        return np.repeat([0, 2, 4, 3, 1], 32)[:batch]
    return np.random.default_rng(seed).integers(0, 5, batch)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,batch", _MIXED_CASES)
def test_chain_kernel_mixed_matches_plain(kind, batch, cuda_device):
    """The mixed chain kernel (a material per CTA) against its plain version
    over two blocks: audio, every state leaf and both lanes of every stage
    bit-equal; one launch per block over the whole corpus."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    mats = _mixed_materials(kind, batch)
    chain = _traced_chain(mats)
    clips = _bursts(90, 2, cuda_device, batch=batch)
    st0 = chain.init_state((batch,), cuda_device)
    before = ck.chain_kernel_step.launches
    got = _raw_chain("cuda", chain, st0, clips)
    assert ck.chain_kernel_step.launches == before + 2
    _assert_all_equal(got, _raw_chain("plain", chain, st0, clips))


@pytest.mark.cuda
@pytest.mark.parametrize("material", [0, 1, 2, 3, 4])
def test_chain_kernel_mixed_uniform_equals_static(material, cuda_device):
    """A uniform material array through the mixed kernel equals the static
    instantiation's launch bit for bit (audio, state, lanes)."""
    chain_m = _traced_chain(np.full(RAGGED[0], material))
    chain_s = _chain(material)
    clips = _bursts(91, 2, cuda_device, batch=RAGGED[0])
    st0 = chain_s.init_state((RAGGED[0],), cuda_device)
    _assert_all_equal(_raw_chain("cuda", chain_m, st0, clips),
                      _raw_chain("cuda", chain_s, st0, clips))


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [False, True])
def test_chain_kernel_automation_matches_plain(mixed, cuda_device):
    """The automated chain stream (a constant row per block; per clip and
    per block with mixed materials) against its plain version, bit for bit;
    the curves move the render."""
    from juicy_tpu_torch.kernels import chain_kernel as ck

    batch = RAGGED[0]
    chain = _traced_chain(_mixed_materials("ragged", batch, 3)) if mixed \
        else _chain(2)
    auto = {0: {"mix": [0.3, 0.9, 0.6]}, 1: {"drive": [3.0, 15.0, 9.0]},
            6: {"sensitivity": [0.5, 1.5, 1.0]}}
    clips = _bursts(92, 3, cuda_device, batch=batch)
    st0 = chain.init_state((batch,), cuda_device)
    got = _raw_chain("cuda", chain, st0, clips, auto)
    _assert_all_equal(got, _raw_chain("plain", chain, st0, clips, auto))
    flat = _raw_chain("cuda", chain, st0, clips)
    assert not torch.equal(got[0], flat[0])
    out, _st, ms = ck.chain_kernel_stream(chain, st0, clips, automation=auto)
    out_p, _st, ms_p = ck.chain_kernel_stream_plain(chain, st0, clips,
                                                    automation=auto)
    assert torch.equal(out, out_p) and torch.equal(ms[-1]["score"],
                                                   ms_p[-1]["score"])


def _tex_mixed_case(kind, batch, channels, sr, device, nan=False):
    """A texture batch with a material per clip in the mixed kernel's
    order (MaterialOrder) and its plugin, params and kernel-form state."""
    mats = torch.from_numpy(_mixed_materials(kind, batch, 7))
    order = sk.MaterialOrder(mats)
    plug = Plugin("texture", sr, channels, N).with_traced("material")
    params = plug.full_params(dict(plug.default_params(),
                                   material=order.mode.float()))
    clips = order.clips(_clips(11, channels, 2, device, batch))
    if nan:
        clips[len(order.take) // 2, 0, 100] = float("nan")
    st = plug.init_state((len(order.take),), device)
    st["dsp"] = sk.texture_kernel_state(st["dsp"], order.mode)
    return order, params, clips, st


def _raw_tex(route, params, st, clips, mode, sr=SR):
    """Two blocks through the texture kernel's raw route: [audio, every
    state leaf, both lanes] of each."""
    fn = getattr(sk, f"_tex_lanes_{route}")
    dsp = dict(st["dsp"])
    dsp["waveguide"] = dsp["waveguide"].clone()
    lane0 = sk.pack_lane(st["analyzer"], clips.shape[0])
    res = []
    for k in range(2):
        out, dsp, *lanes = fn(clips[..., k * N:(k + 1) * N], dsp, lane0,
                              params, sr, mode)
        res += [out, *[dsp[key] for key in sorted(dsp)], *lanes]
        lane0 = lanes[2]
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("kind,batch", _MIXED_CASES)
def test_texture_stage_kernel_mixed_matches_plain(kind, batch, channels,
                                                  cuda_device):
    """The mixed texture stage kernel (a material per CTA, each CTA's shared
    memory laid out for its material) against its plain version (the traced
    model) over two blocks: audio, every state leaf and both lanes
    bit-equal; the non-wave clips' ring index untouched."""
    order, params, clips, st = _tex_mixed_case(kind, batch, channels, SR,
                                               cuda_device)
    before = sk.texture_stage_step.launches
    got = _raw_tex("cuda", params, st, clips, order.mode)
    assert sk.texture_stage_step.launches == before + 2
    _assert_all_equal(got, _raw_tex("plain", params, st, clips, order.mode))


@pytest.mark.cuda
@pytest.mark.parametrize("material", [0, 1, 2, 3, 4])
def test_texture_stage_kernel_mixed_uniform_equals_static(material,
                                                          cuda_device):
    """A uniform material array through the mixed texture kernel equals the
    static instantiation's launch bit for bit."""
    plug = Plugin("texture", SR, 2, N).with_static(material=material)
    params = plug.full_params(plug.default_params())
    clips = _clips(12, 2, 2, cuda_device, RAGGED[0])
    st0 = plug.init_state((RAGGED[0],), cuda_device)
    mode = torch.full((RAGGED[0],), material, dtype=torch.int64)
    st_m = {"analyzer": st0["analyzer"],
            "dsp": sk.texture_kernel_state(st0["dsp"], mode)}
    _assert_all_equal(
        _raw_tex("cuda", dict(params, material=mode.float()), st_m, clips,
                 mode),
        _raw_tex("cuda", params, _kernel_form(st0, material), clips,
                 material))


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2])
def test_mixed_kernels_keep_nan_plastic_2khz(channels, cuda_device):
    """Plastic at 2 kHz (its filters past Nyquist, the output turning NaN)
    beside the other materials, one NaN sample in a mixed batch's clip: the
    mixed texture kernel NaN where its plain version is NaN and every other
    value equal."""
    sr = 2000.0
    order, params, clips, st = _tex_mixed_case("ragged", RAGGED[0], channels,
                                               sr, cuda_device, nan=True)
    got = _raw_tex("cuda", params, st, clips, order.mode, sr)
    _assert_all_equal(got, _raw_tex("plain", params, st, clips, order.mode,
                                    sr))
    assert bool(torch.isnan(got[0]).any())


@pytest.mark.cuda
def test_mixed_materials_run_corpus_on_card(cuda_device):
    """run_corpus_chain(materials=) and run_corpus on a traced texture
    plugin with "always": one launch per block over the sorted corpus, the
    result in corpus order equal to "auto" and within -100 dBFS and 1e-3
    (last-block scores) of "never"."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.parallel.corpus import run_corpus_chain

    mats = _mixed_materials("ragged", 70, 5)
    chain = _chain(0, learn=False)
    clips = _bursts(61, 3, cuda_device, batch=70)
    before = ck.chain_kernel_step.launches
    out_k, ms_k, _ = run_corpus_chain(chain, clips, use_kernel="always",
                                      materials=mats)
    assert ck.chain_kernel_step.launches == before + 3
    out_n, ms_n, _ = run_corpus_chain(chain, clips, use_kernel="never",
                                      materials=mats)
    assert float((out_k.double() - out_n.double()).abs().max()) <= 1e-5
    assert float((ms_k[-1]["score"] - ms_n[-1]["score"]).abs().max()) <= 1e-3
    plug = Plugin("texture", SR, 2, N).with_traced("material")
    params = dict(plug.default_params(),
                  material=torch.as_tensor(mats, dtype=torch.float32))
    before = sk.texture_stage_step.launches
    out_k, last_k, _ = run_corpus(plug, params, clips, use_kernel="always")
    assert sk.texture_stage_step.launches == before + 3
    out_n, last_n, _ = run_corpus(plug, params, clips, use_kernel="never")
    assert float((out_k.double() - out_n.double()).abs().max()) <= 1e-5
    assert float((last_k["score"] - last_n["score"]).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_pipelined_stream_kernel_path_on_card(cuda_device):
    """PipelinedStream on the canonical chain at B = 1: one chain-kernel
    launch per tick, its audio and metrics bit-equal to the chain kernel's
    plain step on the card, block by block."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.runtime.host_bridge import PipelinedStream

    chain = _chain(0, learn=False)
    clip = _bursts(83, 3, cuda_device, batch=1)
    host = clip[0].cpu().numpy()
    ps = PipelinedStream(chain, depth=1)
    assert ps.kernel_path and ps.latency_samples == N
    got = []
    for k in range(3):
        before = ck.chain_kernel_step.launches
        res = ps.tick(host[:, k * N:(k + 1) * N])
        assert ck.chain_kernel_step.launches == before + 1
        if res is not None:
            got.append(res)
    got.extend(ps.flush())
    states = chain.init_state((1,), cuda_device)
    for k in range(3):
        out, states, ms = ck.chain_kernel_step_plain(
            chain, states, clip[..., k * N:(k + 1) * N])
        np.testing.assert_array_equal(got[k][0], out[0].cpu().numpy())
        want = {key: float(v[0]) for key, v in ms[-1].items()}
        for key, v in want.items():
            assert abs(got[k][1][key] - v) <= 1e-5 * max(1.0, abs(v)), key


@pytest.mark.cuda
def test_host_bridge_realtime_on_card(cuda_device):
    """HostBridge on the saturator keeps up with the audio: 200 blocks of
    512 pushed and pumped one at a time at 1x realtime or faster, one
    stage-kernel launch each, every block back in order."""
    import time

    from juicy_tpu_torch.runtime.host_bridge import HostBridge

    n, blocks = 512, 200
    plug = Plugin("saturator", SR, 2, n)
    clip = _clips(89, 2, blocks, "cpu", batch=1, n=n)[0].numpy()
    warm = HostBridge(plug)
    warm.push_block(clip[:, :n])
    warm.process_available()
    warm.stop()
    bridge = HostBridge(plug)
    before = sk.saturator_stage_step.launches
    got = []
    t0 = time.perf_counter()
    for k in range(blocks):
        assert bridge.push_block(clip[:, k * n:(k + 1) * n])
        bridge.process_available()
        got.append(bridge.pop_block())
    wall = time.perf_counter() - t0
    bridge.stop()
    assert sk.saturator_stage_step.launches == before + blocks
    assert all(g is not None for g in got)
    want, _l, _a = run_corpus(plug, plug.default_params(),
                              torch.from_numpy(clip[None]).to(cuda_device))
    np.testing.assert_array_equal(np.concatenate(got, -1),
                                  want[0].cpu().numpy())
    assert blocks * n / SR / wall >= 1.0


@pytest.mark.cuda
def test_cli_corpus_on_card(cuda_device, tmp_path):
    """The CLI's corpus command on the card (the chain kernel, two macro
    batches) writes what run_corpus_chain gives on the same clips, bit for
    bit."""
    import os

    from juicy_tpu_torch.cli import main
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.parallel.corpus import run_corpus_chain
    from juicy_tpu_torch.runtime.wav import read_wav, write_wav

    clips = _bursts(97, 3, cuda_device, batch=5)
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"c{i}.wav"))
        write_wav(paths[-1], clips[i].cpu().numpy(), int(SR))
    stages = ("punch:Solar Snap,saturator:Amber Heat,texture,motion,"
              "width:Prism Arc,cohere,infer:Reference Lens")
    before = ck.chain_kernel_step.launches
    main(["corpus", *paths, "--stages", stages, "--block", str(N),
          "--out-dir", str(tmp_path / "out"), "--batch", "3"])
    assert ck.chain_kernel_step.launches == before + 2 * 3
    chain = _chain(0, learn=False)
    want, _ms, _a = run_corpus_chain(chain, clips)
    for i, p in enumerate(paths):
        got, _ = read_wav(str(tmp_path / "out" / os.path.basename(p)))
        np.testing.assert_array_equal(got, want[i].cpu().numpy())


# ---------------------------------------------------------------------------
# The relaxed tier and device meshes on the card (no kernel of their own:
# PyTorch operations on CUDA tensors, held to the same calls on the CPU).
# ---------------------------------------------------------------------------

def _scan_case(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (64, n)).astype(np.float32)
    b = rng.standard_normal((64, n)).astype(np.float32)
    init = rng.standard_normal(64).astype(np.float32)
    return [torch.from_numpy(v) for v in (a, b, init)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 512, 48128])
def test_associative_scans_on_card_match_cpu(n, cuda_device):
    """The affine and (min, affine) scans, forward and reversed: each
    elementwise operation in the same order on both devices, so bit-equal."""
    from juicy_tpu_torch.ops import scan_utils as ts
    from juicy_tpu_torch.runtime import relaxed as trx

    a, b, init = _scan_case(n, n)
    for reverse in (False, True):
        want = ts.linear_scan_assoc(a, b, init, reverse=reverse)
        got = ts.linear_scan_assoc(a.to(cuda_device), b.to(cuda_device),
                                   init.to(cuda_device), reverse=reverse)
        assert torch.equal(got.cpu(), want)
    over = (b > 1.0).T
    caps = torch.where(over, 0.5, 1e9)
    coeffs = torch.where(over, 1.0, 0.9972)
    offsets = torch.where(over, 0.0, 0.0028)
    want = trx.min_affine_scan(caps, coeffs, offsets, init.abs())
    got = trx.min_affine_scan(*(v.to(cuda_device) for v in
                                (caps, coeffs, offsets, init.abs())))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_linear_matrix_scan_on_card_matches_cpu(cuda_device):
    """2x2 and 4x4 maps over a block: <= -130 dBFS from the CPU."""
    from juicy_tpu_torch.ops import scan_utils as ts

    rng = np.random.default_rng(4)
    for d in (2, 4):
        mats = torch.from_numpy(
            (np.eye(d) * 0.98 + 0.02 * rng.standard_normal((512, 16, d, d)))
            .astype(np.float32))
        vecs = torch.from_numpy(rng.standard_normal((512, 16, d))
                                .astype(np.float32))
        init = torch.zeros(16, d)
        want = ts.linear_matrix_scan(mats, vecs, init)
        got = ts.linear_matrix_scan(mats.to(cuda_device),
                                    vecs.to(cuda_device),
                                    init.to(cuda_device)).cpu()
        diff = float((got.double() - want.double()).abs().max())
        assert diff == 0 or 20 * np.log10(diff) <= -130.0, diff


@pytest.mark.cuda
def test_relaxed_chain_on_card_matches_cpu(cuda_device):
    """relaxed_chain_stream at B = 16, two blocks of 512, on the card
    against the CPU (chip_smoke.py phase 7's bars): audio <= -110 dBFS,
    metrics within 1e-5 of max(1, |value|), every analyzer's cooldown and
    motion's rng equal."""
    from juicy_tpu_torch.runtime.plugin import Chain
    from juicy_tpu_torch.runtime.relaxed import relaxed_chain_stream

    chain = Chain([("punch", "Solar Snap"), ("saturator", "Amber Heat"),
                   ("texture", None), ("motion", None),
                   ("width", "Prism Arc"), ("cohere", None),
                   ("infer", "Reference Lens")], SR, 2, 512)
    clips = _clips(71, 2, 2, "cpu", batch=16, n=512)
    out_g, st_g, ms_g = relaxed_chain_stream(
        chain, chain.init_state((16,), cuda_device), clips.to(cuda_device))
    out_c, st_c, ms_c = relaxed_chain_stream(
        chain, chain.init_state((16,), "cpu"), clips, device="cpu")
    diff = float((out_g.cpu().double() - out_c.double()).abs().max())
    assert diff == 0 or 20 * np.log10(diff) <= -110.0, diff
    for mg, mc in zip(ms_g, ms_c):
        for key in mc:
            rel = (mg[key].cpu().double() - mc[key].double()).abs() / \
                mc[key].double().abs().clamp(min=1.0)
            assert float(rel.max()) <= 1e-5, key
    for sg, sc in zip(st_g, st_c):
        assert torch.equal(sg["analyzer"]["onset_cooldown"].cpu(),
                           sc["analyzer"]["onset_cooldown"])
    assert torch.equal(st_g[3]["dsp"]["rng"].cpu(), st_c[3]["dsp"]["rng"])


@pytest.mark.cuda
def test_mesh_on_one_card_matches_unsharded(cuda_device):
    """A [cuda:0, cuda:0] mesh (the split and the gather on one card)
    through run_corpus_chain (one chain-kernel launch per block per shard)
    and a StreamServer on the kernel tick with a per-slot edit: bit-equal
    to no mesh."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.parallel.corpus import run_corpus_chain
    from juicy_tpu_torch.parallel.mesh import make_mesh
    from juicy_tpu_torch.runtime.plugin import Chain
    from juicy_tpu_torch.runtime.serve import StreamServer

    mesh = make_mesh(devices=[cuda_device, cuda_device])
    stages = [("punch", "Solar Snap"), ("saturator", "Amber Heat"),
              ("texture", None), ("motion", None), ("width", "Prism Arc"),
              ("cohere", None), ("infer", "Reference Lens")]
    chain = Chain(stages, SR, 2, N)
    clips = _clips(72, 2, 3, cuda_device, batch=96)
    want = run_corpus_chain(chain, clips, metrics="blocks",
                            device=cuda_device)
    before = ck.chain_kernel_step.launches
    got = run_corpus_chain(chain, clips, metrics="blocks", mesh=mesh)
    assert ck.chain_kernel_step.launches - before == 2 * 3
    assert torch.equal(got[0], want[0])
    for mg, mw in zip(got[1], want[1]):
        for key in mw:
            assert torch.equal(mg[key], mw[key]), key

    def play(server):
        sids = [server.open_stream() for _ in range(64)]
        server.set_params(sids[40], "punch", punch=0.3)
        res = []
        for k in range(3):
            server.submit_many(sids, clips[:64, :, k * N:(k + 1) * N].cpu()
                               .numpy())
            res.append(server.tick_arrays())
        return res

    solo = play(StreamServer(chain, 64, device=cuda_device))
    sharded = play(StreamServer(chain, 64, mesh=mesh))
    for rs, ro in zip(sharded, solo):
        for vs, vo in zip(rs, ro):
            np.testing.assert_array_equal(vs, vo)
