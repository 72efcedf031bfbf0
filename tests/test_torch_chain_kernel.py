"""PyTorch port vs JAX: the chain kernel's plain version, the stream
finalize, the block-major chain executor and ``run_corpus_chain``.

JAX's numbers come from one process without FMA contraction
(tests/torch_jax_ref.py), on the burst input of
tests/test_torch_punch_motion.py (one decaying burst per clip at a seeded
sample, so that the onsets, motion's LCG rolls and the cooldowns fall inside
the blocks):

- ``chain_kernel_step_plain`` (what ``chain_kernel_step`` runs on a CPU
  tensor) against JAX's interpret-mode ``chain_kernel_step``, with the clip
  tile shrunk to 128 as tests/test_chain_kernel.py does: B = 128, one block
  of 64, the bench chain with texture gel and wood;
- ``chain_kernel_stream_plain`` (metrics "blocks") against JAX's
  ``fused_chain_stream`` over three blocks of 64, B = 16, with cohere's
  learn on (its targets move from block to block);
- the port's ``fused_chain_stream`` in all three metric modes against JAX's.

Bars: audio <= -100 dBFS; every stage's metrics (the repetition/fatigue EMA
metrics included) within 1e-5 of max(1, |value|), cohere's context fit
within 1e-5 of its 0..100 range (it is 100 - 10 * deviation, so the port's
audio, which sits ~-117 dBFS from JAX's on wood where XLA divides by the
sample rate as a reciprocal multiply, moves it by ulps of 100; ROADMAP.md
Queue 3); punch's followers,
motion's ``rng`` and every analyzer's ``onset_cooldown`` exactly equal; the
analyzers' EMA states within 1e-5. On the port alone: the stream equals
``Chain.batched_run`` (audio and DSP state bit-equal, metrics within 1e-6 of
their scale: the analyzer's block sums are taken in another order),
``finalize_stream`` equals ``finalize_block`` applied block by block bit for
bit, its EMA walk (``ema_scan_plain``, and ``ema_scan`` on CPU tensors) equals
``_ema_update`` step by step with NaN and +-inf among the inputs, ``ema_scan``
refuses a wrong dtype, layout, shape or device before any launch, the
kernel-form state goes back to the ``Chain`` form unchanged, and
``run_corpus_chain``'s routes and refusals. The CUDA kernel itself is held to
the plain version on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juicy_tpu.kernels.stage_kernels as jsk
from juicy_tpu.runtime.chain_fused import fused_chain_stream as j_fused_stream
from juicy_tpu.runtime.plugin import Chain as JChain
from juicy_tpu_torch import analyzer as tan
from juicy_tpu_torch.kernels import _build
from juicy_tpu_torch.kernels import chain_kernel as ck
from juicy_tpu_torch.parallel.corpus import run_corpus_chain
from juicy_tpu_torch.runtime.chain_fused import (fused_chain_step,
                                                 fused_chain_stream)
from juicy_tpu_torch.runtime.plugin import Chain as TChain
from juicy_tpu_torch.utils.from_jax import to_numpy
from tests.conftest import residual_dbfs
from tests.ema_cases import ANALYZERS, assert_same_bits, ema_inputs
from tests.test_torch_punch_motion import assert_metrics_close, burst_clips
from tests.torch_jax_ref import assert_material_ran, no_fma_reference

SR = 48000.0
N = 64
B_STEP, B_STREAM, NB = 128, 16, 3
MATERIALS = {"gel": 0, "wood": 2}
MODES = ("blocks", "final", "none")


def _stages(material=0, learn=False, order=None):
    """bench.py's chain (punch "Solar Snap", saturator "Amber Heat",
    texture, motion, width "Prism Arc", cohere, infer "Reference Lens")
    with a static texture material; `learn` turns cohere's learn on."""
    stages = [("punch", "Solar Snap"), ("saturator", "Amber Heat"),
              ("texture", {"material": material}), ("motion", None),
              ("width", "Prism Arc"),
              ("cohere", {"learn": 1.0, "match": 0.9} if learn else None),
              ("infer", "Reference Lens")]
    return stages if order is None else [stages[i] for i in order]


def _flat(tag, out, states, metrics):
    ref = {} if out is None else {f"{tag}/out": np.asarray(out)}
    for i, st in enumerate(states):
        for group in ("dsp", "analyzer"):
            for key, v in jax.device_get(st[group]).items():
                ref[f"{tag}/{i}/{group}/{key}"] = np.asarray(v)
        if metrics is not None:
            for key, v in jax.device_get(metrics[i]).items():
                ref[f"{tag}/{i}/m/{key}"] = np.asarray(v)
    return ref


def _jax_chain_kernel_refs():
    """JAX's interpret-mode chain kernel step (gel, wood) and its fused
    chain stream in the three metric modes (run without FMA)."""
    from juicy_tpu.kernels import chain_kernel as jck

    out = {}
    tile, msub = jsk.TILE, jsk.MSUB
    jsk.TILE, jsk.MSUB = 128, 1
    try:
        for name, mat in MATERIALS.items():
            chain = JChain(_stages(mat), SR, 2, N)
            states = jax.vmap(lambda _: chain.init_state())(jnp.arange(B_STEP))
            o, st, ms = jck.chain_kernel_step(
                chain, states, jnp.asarray(burst_clips(1, B_STEP, 2, N)),
                unroll=4, interpret=True)
            out.update(_flat(f"step/{name}", o, st, ms))
    finally:
        jsk.TILE, jsk.MSUB = tile, msub
    chain = JChain(_stages(learn=True), SR, 2, N)
    clips = jnp.asarray(burst_clips(2, B_STREAM, 2, NB * N))
    for mode in MODES:
        states = jax.vmap(lambda _: chain.init_state())(jnp.arange(B_STREAM))
        o, st, ms = j_fused_stream(chain, states, clips, metrics=mode)
        out.update(_flat(f"stream/{mode}", o, st, ms))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_chain_kernel",
                            "_jax_chain_kernel_refs",
                            tmp_path_factory.mktemp("chain_kernel"))


def _compare(tag, out, states, metrics, ref):
    db = residual_dbfs(out.numpy(), ref[f"{tag}/out"])
    print(f"{tag}: {db:.1f} dBFS vs JAX")
    assert db <= -100.0, f"{tag}: {db:.1f} dBFS"
    for i, st in enumerate(states):
        pre = f"{tag}/{i}"
        dsp, an = to_numpy(st["dsp"]), to_numpy(st["analyzer"])
        # JAX's kernel returns a wave material's texture state without the
        # other materials' leaves; the port keeps the Chain's whole state
        assert {k.split("/")[-1] for k in ref
                if k.startswith(f"{pre}/dsp/")} <= set(dsp), i
        for key in ("fast_env", "slow_env", "rng", "onset_cooldown"):
            if key in dsp:
                np.testing.assert_array_equal(dsp[key],
                                              ref[f"{pre}/dsp/{key}"], key)
        np.testing.assert_array_equal(an["onset_cooldown"],
                                      ref[f"{pre}/analyzer/onset_cooldown"])
        for key in ("repetition_ema", "fatigue_ema"):
            np.testing.assert_allclose(an[key], ref[f"{pre}/analyzer/{key}"],
                                       atol=1e-5, err_msg=key)
        if metrics is not None:
            m = {k: v.numpy() for k, v in metrics[i].items()}
            assert set(m) == {k.split("/")[-1] for k in ref
                              if k.startswith(f"{pre}/m/")}, i
            # cohere's context fit is 100 - 10 * deviation, rounded at the
            # scale of 100: held to 1e-5 of that range
            fit = m.pop("context_fit", None)
            assert_metrics_close(m, {k: ref[f"{pre}/m/{k}"] for k in m})
            if fit is not None:
                np.testing.assert_allclose(fit, ref[f"{pre}/m/context_fit"],
                                           rtol=0, atol=1e-5 * 100.0)


def _assert_onsets(states0, states):
    """Onsets inside the blocks: motion's pass 1 rolled the LCG in every
    clip and every analyzer's cooldown is running."""
    assert bool(torch.all(states[3]["dsp"]["rng"] != states0[3]["dsp"]["rng"]))
    for st in states:
        assert bool(torch.all(st["analyzer"]["onset_cooldown"] > 0))


@pytest.mark.parametrize("name", list(MATERIALS))
def test_torch_chain_step_plain_vs_jax_kernel(name, jax_ref):
    """The plain chain step (a CPU block, so no launch) against JAX's chain
    kernel in interpret mode; the material's own state moved."""
    mat = MATERIALS[name]
    chain = TChain(_stages(mat), SR, 2, N)
    states0 = chain.init_state((B_STEP,), "cpu")
    before = ck.chain_kernel_step.launches
    out, states, metrics = ck.chain_kernel_step(
        chain, states0, torch.from_numpy(burst_clips(1, B_STEP, 2, N)))
    assert ck.chain_kernel_step.launches == before
    _compare(f"step/{name}", out, states, metrics, jax_ref)
    _assert_onsets(states0, states)
    assert_material_ran(states0[2]["dsp"], states[2]["dsp"], mat)


def _stream_case():
    chain = TChain(_stages(learn=True), SR, 2, N)
    clips = torch.from_numpy(burst_clips(2, B_STREAM, 2, NB * N))
    return chain, clips, chain.init_state((B_STREAM,), "cpu")


def test_torch_chain_stream_plain_vs_jax_fused(jax_ref):
    chain, clips, states0 = _stream_case()
    out, states, metrics = ck.chain_kernel_stream_plain(chain, states0, clips)
    assert all(v.shape == (NB, B_STREAM) for m in metrics for v in m.values())
    _compare("stream/blocks", out, states, metrics, jax_ref)
    _assert_onsets(states0, states)
    assert not torch.equal(states[5]["dsp"]["target_low"],
                           states0[5]["dsp"]["target_low"])


def test_torch_chain_stream_matches_batched_run():
    """The plain stream is Chain.batched_run with the analyzer run as the
    kernel's lanes: audio and DSP state bit-equal, metrics and analyzer
    states within 1e-6 of their scale."""
    chain, clips, states0 = _stream_case()
    out, states, metrics = ck.chain_kernel_stream_plain(chain, states0, clips)
    out_b, states_b, metrics_b = chain.batched_run(states0, clips)
    assert torch.equal(out, out_b)
    for st, st_b, m, m_b in zip(states, states_b, metrics, metrics_b,
                                strict=True):
        assert set(st["dsp"]) == set(st_b["dsp"])
        for key, v in st_b["dsp"].items():
            assert torch.equal(st["dsp"][key], v), key
        assert_metrics_close(to_numpy(st["analyzer"]),
                             to_numpy(st_b["analyzer"]), tol=1e-6)
        assert set(m) == set(m_b)
        assert_metrics_close(to_numpy(m), to_numpy(m_b), tol=1e-6)


def test_torch_finalize_stream_matches_finalize_block():
    """The stream's finalize (the score formulas once over every lane and
    block, the EMA pair serially for all seven analyzers) equals the
    per-block finalize applied block by block, bit for bit."""
    chain, clips, states0 = _stream_case()
    _out, _dsps, fin, acc, fit = ck._run_plain(chain, states0, clips, False)
    an = [st["analyzer"] for st in states0]
    new_an, metrics = ck.finalize_stream(chain, an, fin, acc, fit)
    for blk in range(NB):
        an, m_blk = ck.finalize_block(chain, an, fin[blk], acc[blk], fit[blk])
        for m, mb in zip(metrics, m_blk, strict=True):
            assert set(m) == set(mb)
            for key, v in mb.items():
                assert torch.equal(m[key][blk], v), (blk, key)
    for a, b in zip(new_an, an, strict=True):
        for key, v in b.items():
            assert a[key].dtype == v.dtype and torch.equal(a[key], v), key


@pytest.mark.parametrize("nb", [1, 3, 94])
def test_torch_ema_scan_plain_matches_ema_update(nb):
    """The finalize's EMA walk (ema_scan_plain, and ema_scan on CPU tensors,
    which takes it without a launch) equals analyzer._ema_update applied
    step by step to each analyzer, block by block, its pre lane then its
    post lane, bit for bit, with NaN and +-inf among the inputs."""
    rep0, fat0, onset, crest, harsh = ema_inputs(nb, 5, seed=nb)
    got = ck.ema_scan_plain(rep0, fat0, onset, crest, harsh)
    launches = ck.ema_scan.launches
    routed = ck.ema_scan(rep0, fat0, onset, crest, harsh)
    assert ck.ema_scan.launches == launches
    for a, b in zip(routed, got, strict=True):
        assert_same_bits(a, b)
    density, risk, rep1, fat1 = got
    assert density.shape == risk.shape == onset.shape
    for i in range(ANALYZERS):
        rep, fat = rep0[i], fat0[i]
        for blk in range(nb):
            for s in (2 * i, 2 * i + 1):
                rep, fat, d, r = tan._ema_update(
                    rep, fat, {"onset_rate": onset[blk, s],
                               "crest_penalty": crest[blk, s],
                               "harsh_penalty": harsh[blk, s]})
                assert_same_bits(density[blk, s], d, (blk, s))
                assert_same_bits(risk[blk, s], r, (blk, s))
        assert_same_bits(rep1[i], rep, i)
        assert_same_bits(fat1[i], fat, i)
    assert bool(torch.isnan(density).any()) and bool(torch.isfinite(risk).any())


def _bad_ema_args(case):
    """ema_scan's arguments (rep, fat, onset, crest, harsh) with one fault."""
    rep, fat, onset, crest, harsh = ema_inputs(2, 4)
    if case == "float64":
        crest = crest.double()
    elif case == "strided":
        harsh = harsh.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "lanes":
        onset = onset[:, :12].contiguous()
    elif case == "batch":
        harsh = harsh[..., :3].contiguous()
    elif case == "no_blocks":
        onset, crest, harsh = (t[:0] for t in (onset, crest, harsh))
    elif case == "state_shape":
        fat = fat[:6].contiguous()
    elif case == "state_rank":
        rep, fat = rep[0], fat[0]
    elif case == "not_a_tensor":
        rep = rep.tolist()
    elif case == "device":
        crest = crest.to("meta")
    return rep, fat, onset, crest, harsh


@pytest.mark.parametrize("case", ["float64", "strided", "lanes", "batch",
                                  "no_blocks", "state_shape", "state_rank",
                                  "not_a_tensor", "device"])
def test_torch_ema_scan_refuses(case, monkeypatch):
    """ema_scan raises ValueError on a wrong dtype, layout, shape or device
    before it loads the library or launches anything."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_build, "load_library", no_library)
    launches = ck.ema_scan.launches
    with pytest.raises(ValueError, match="ema_scan"):
        ck.ema_scan(*_bad_ema_args(case))
    assert ck.ema_scan.launches == launches


@pytest.mark.parametrize("mode", MODES)
def test_torch_fused_chain_stream_vs_jax(mode, jax_ref):
    """The block-major executor in each metric mode: under "none" no
    analyzer runs and the analyzer state stays as it was."""
    chain, clips, states0 = _stream_case()
    out, states, metrics = fused_chain_stream(chain, states0, clips,
                                              metrics=mode)
    _compare(f"stream/{mode}", out, states, metrics, jax_ref)
    if mode == "none":
        assert metrics is None
        for st, st0 in zip(states, states0):
            assert st["analyzer"] is st0["analyzer"]
        _out, _st, ms = fused_chain_step(chain, states0, clips[..., :N],
                                         metrics="none")
        assert ms == [None] * 7
    else:
        shape = (NB, B_STREAM) if mode == "blocks" else (B_STREAM,)
        assert all(v.shape == shape for m in metrics for v in m.values())
        assert "context_fit" in metrics[5]


def test_torch_kernel_state_round_trip():
    """The kernel form (texture's ring time-major with a block-uniform write
    index, the LCG states as int32 bits, the Haas window as a ring [D, B]
    with a write head) goes back to the Chain form unchanged, also after
    the ring heads moved: the unpack reads the rings from their heads."""
    chain = TChain(_stages(material=2), SR, 2, N)
    states = chain.init_state((5,), "cpu")
    g = torch.Generator().manual_seed(3)
    for st in states:
        for group in ("dsp", "analyzer"):
            for key, v in st[group].items():
                if v.dtype == torch.float32:
                    st[group][key] = torch.randn(v.shape, generator=g)
    states[2]["dsp"]["wave_idx"].fill_(7)
    states[3]["dsp"]["rng"] = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1, 5])
    kc = ck.KernelChain(chain, states, 5, "cpu")
    assert kc.haas.shape == (kc.D, 5) and kc.tex_ring.shape == (kc.L, 2, 5)
    # as if blocks had run: both rings turned, the heads moved with them
    kc.haas = torch.roll(kc.haas, 11, 0)
    kc.haas_pos = 11
    kc.tex_ring = torch.roll(kc.tex_ring, 3, 0)
    kc.tex_widx = 10
    dsps = kc.unpack(states, states[5]["dsp"]["context_fit"])
    for st, dsp in zip(states, dsps, strict=True):
        assert set(dsp) == set(st["dsp"])
        for key, v in st["dsp"].items():
            want = torch.roll(v, 3, -1) if key == "waveguide" else \
                v + 3 if key == "wave_idx" else v
            assert dsp[key].dtype == v.dtype and torch.equal(dsp[key], want), key
    # the caller's state is not the kernel's: in-place updates leave it
    kc.sat_tone.add_(1.0)
    assert not torch.equal(kc.sat_tone, states[1]["dsp"]["tone_state"])


def test_torch_chain_constants():
    """One row: the four stage lists, then the back half's in _back_pvec
    order; cached per (params, sr, block size)."""
    chain = TChain(_stages(), SR, 2, N)
    row = ck.chain_constants(chain)
    assert row.shape == (ck.N_CONSTS,) and row.dtype == np.float32
    assert row is ck.chain_constants(TChain(_stages(), SR, 2, N))
    back = row[-15:]
    assert back[4] == 576.0                    # int(48000 · 12 ms)
    assert back[-1] == np.float32(1.0 / N)
    wide = TChain(_stages(), SR, 2, N)
    wide.params[4] = dict(wide.params[4], haasMs=torch.tensor(35.0))
    assert ck.chain_constants(wide)[-11] == 1680.0


def test_torch_supports_chain_kernel():
    """The cases of tests/test_chain_kernel.py that apply: the canonical
    chain (any static material, or per-clip materials: the kernel's
    material per CTA) yes; one stage, a reordered chain, mono or a batched
    param other than the material no."""
    assert ck.supports_chain_kernel(TChain(_stages(), SR, 2, N))
    assert ck.supports_chain_kernel(TChain(_stages(2), SR, 2, N))
    assert not ck.supports_chain_kernel(TChain([("punch", None)], SR, 2, N))
    assert not ck.supports_chain_kernel(
        TChain(_stages(order=(1, 0, 2, 3, 4, 5, 6)), SR, 2, N))
    assert not ck.supports_chain_kernel(TChain(_stages(), SR, 1, N))
    batched = TChain(_stages(), SR, 2, N)
    batched.params[0] = dict(batched.params[0], mix=torch.full((4,), 0.5))
    assert not ck.supports_chain_kernel(batched)
    stages = _stages()
    stages[2] = ("texture", None)              # no static material bound
    mixed = TChain(stages, SR, 2, N)
    mixed.params[2] = dict(mixed.params[2], material=torch.tensor([0., 1.]))
    assert ck.supports_chain_kernel(mixed)
    mixed.params[2] = dict(mixed.params[2], mix=torch.full((2,), 0.5))
    assert not ck.supports_chain_kernel(mixed)


def test_torch_run_corpus_chain_routes():
    """On the CPU: "auto" takes the chain kernel's plain version (no launch)
    and equals "never" (the block-major executor); without audio the
    metrics stay and `out` is None; "none" has no aggregates; "always"
    raises on a CPU corpus and on a reordered chain; automation= and
    materials= take the same routes (each equal to "never" here; against
    JAX in tests/test_torch_automation.py and test_torch_materials.py), and
    texture's material cannot be automated on the kernel."""
    chain = TChain(_stages(), SR, 2, N)
    clips = burst_clips(4, 6, 2, 2 * N)
    before = ck.chain_kernel_step.launches
    out_a, ms_a, agg = run_corpus_chain(chain, clips, device="cpu")
    assert ck.chain_kernel_step.launches == before
    out_n, ms_n, _ = run_corpus_chain(chain, clips, use_kernel="never",
                                      device="cpu")
    assert torch.equal(out_a, out_n)
    for m, m_n in zip(ms_a, ms_n, strict=True):
        assert all(v.shape == (6,) for v in m.values())
        assert_metrics_close(to_numpy(m), to_numpy(m_n), tol=1e-6)
    assert 0.0 <= float(agg["score"]["min"]) <= float(agg["score"]["max"]) \
        <= 100.0
    none, ms_q, _ = run_corpus_chain(chain, clips, return_audio=False,
                                     device="cpu")
    assert none is None
    for m, m_q in zip(ms_a, ms_q):
        for key, v in m.items():
            assert torch.equal(m_q[key], v), key
    _out, ms, agg = run_corpus_chain(chain, clips, metrics="none",
                                     device="cpu")
    assert ms is None and agg is None
    with pytest.raises(ck.ChainKernelUnsupported, match="CUDA"):
        run_corpus_chain(chain, clips, use_kernel="always", device="cpu")
    reordered = TChain(_stages(order=(0, 2, 1, 3, 4, 5, 6)), SR, 2, N)
    with pytest.raises(ck.ChainKernelUnsupported):
        run_corpus_chain(reordered, clips, use_kernel="always", device="cpu")
    for kw in ({"automation": {0: {"mix": [0.5, 0.9]}}},
               {"materials": np.arange(6) % 5}):
        out_k, ms_k, _ = run_corpus_chain(chain, clips, device="cpu", **kw)
        out_n, ms_n, _ = run_corpus_chain(chain, clips, use_kernel="never",
                                          device="cpu", **kw)
        assert torch.equal(out_k, out_n) and not torch.equal(out_k, out_a)
        for m, m_n in zip(ms_k, ms_n, strict=True):
            assert_metrics_close(to_numpy(m), to_numpy(m_n), tol=1e-6)
    with pytest.raises(ck.ChainKernelUnsupported, match="automated"):
        run_corpus_chain(chain, clips, automation={2: {"material": [1, 2]}},
                         device="cpu")
    with pytest.raises(ValueError):
        ck.chain_kernel_stream(chain, chain.init_state((6,), "cpu"),
                               torch.from_numpy(clips).to("meta"))
