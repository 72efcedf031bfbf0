"""The relaxed tier of the port (juicy_tpu_torch/runtime/relaxed.py and its
ops) against the JAX package's, on the CPU, and the port held to JAX's own
certification of the tier (tests/test_relaxed.py) against its exact
executors.

JAX's side: the associative scans, ``ar_envelope_relaxed`` and
``_first_onset`` are called here, eagerly, where XLA runs each primitive
alone; everything under ``lax.scan`` or a dot (``ar_envelope``,
``ar_envelope_final``, ``linear_matrix_scan``, whose einsums XLA:CPU
computes with fused multiply-adds even eagerly: metal's matrix scan lands
at -24 dBFS from the port in this process, and its relaxed texture at -60)
comes from a subprocess without FMA (tests/torch_jax_ref.py).
``relaxed_step`` against JAX's: tests/test_torch_relaxed_step.py.

Bars, stated before measurement: the scans, the envelopes and the onset
detector bit-equal; the matrix scans <= -120 dBFS (their sums run over k in
index order, JAX's in its dot's order: the 2x2 products are bit-equal,
flesh's 4x4 not). JAX's certification bars, copied.
"""

import numpy as np
import pytest
import torch

from tests.conftest import make_clip, residual_dbfs
from tests.torch_jax_ref import no_fma_reference

from juicy_tpu_torch.ops import envelopes as te
from juicy_tpu_torch.ops import scan_utils as ts
from juicy_tpu_torch.runtime import relaxed as trx
from juicy_tpu_torch.runtime.plugin import Plugin as TPlugin
from juicy_tpu_torch.utils.convert import tau_coeff

SR = 48000.0
BLOCK = 512
NB = 4
B = 4

# tests/test_relaxed.py: (stage, static, bar against the exact executor)
STAGE_BARS = [
    ("punch", None, -100.0),
    ("saturator", None, -100.0),
    ("width", None, -100.0),
    ("infer", None, -100.0),
    ("cohere", None, -100.0),
    ("motion", None, -100.0),
    ("texture", {"material": 0}, -80.0),
    ("texture", {"material": 1}, -60.0),
    ("texture", {"material": 4}, -60.0),
]
# against JAX's relaxed_step: (stage, material, audio bar)
JAX_CASES = [(n, None if s is None else s["material"],
              -90.0 if s is not None and s["material"] in (1, 4) else -110.0)
             for n, s, _ in STAGE_BARS] + [("texture", 2, -90.0)]


def _ids(cases):
    return [f"{c[0]}{'' if c[1] is None else c[1]}" for c in cases]


def _clips():
    local = np.random.default_rng(0xA0D10)
    return np.stack([make_clip(local, 2, BLOCK * NB)
                     for _ in range(B)]).astype(np.float32)


def _env_input():
    return np.abs(make_clip(np.random.default_rng(7), 3, BLOCK))


def _matrix_inputs():
    """(mats [N, 3, ..., d, d], vecs, init) at each material's own
    coefficients: gel's spring, metal's four modal resonators (its bend
    moving a1 per sample), flesh's two-mass system."""
    from juicy_tpu_torch.models import texture as tt

    rng = np.random.default_rng(5)
    knobs = {k: torch.tensor(v) for k, v in dict(
        tailshape=0.5, damping=0.4, weight=0.5, texture=0.6, mix=1.0,
        output=0.0).items()}
    _kc, mp = tt.common_consts(knobs, SR, 0)
    out = {}
    mc = tt.material_consts(0, mp, SR, 2048)
    k = mc["k"].numpy()
    a11 = 1.0 - np.float32(2.0) * np.float32(0.9) * mc["omega"].numpy() \
        * (1.0 + 0.1 * rng.random((BLOCK, 3))).astype(np.float32)
    mats = np.stack([np.stack([a11, np.broadcast_to(-k, a11.shape)], -1),
                     np.stack([a11, np.broadcast_to(1 - k, a11.shape)], -1)],
                    -2)
    f = k * (0.1 * rng.standard_normal((BLOCK, 3))).astype(np.float32)
    out["gel"] = (mats, np.stack([f, f], -1), np.zeros((3, 2)))
    mc = tt.material_consts(1, mp, SR, 2048)
    bend = 1.0 + 0.09 * rng.random((BLOCK, 3, 1)).astype(np.float32)
    a1, a2 = tt._modal_coeffs(mc["f0"] * mc["ratios"] * torch.from_numpy(bend),
                              mc["t60s"], SR)
    a1 = a1.numpy()
    a2 = np.broadcast_to(a2.numpy(), a1.shape)
    mats = np.stack([np.stack([a1, a2], -1),
                     np.stack([np.ones_like(a1), np.zeros_like(a1)], -1)], -2)
    exc = (0.1 * rng.standard_normal((BLOCK, 3, 1))) * mc["gains"].numpy()
    out["metal"] = (mats, np.stack([exc, np.zeros_like(exc)], -1),
                    0.01 * rng.standard_normal((3, 4, 2)))
    mc = tt.material_consts(4, mp, SR, 2048)
    ka, kb, ca, cb, kcp = (mc[x].numpy() for x in
                           ("k_a", "k_b", "c_a", "c_b", "k_couple"))
    a_mat = np.array([[1 - ca, -(ka + kcp), 0, kcp],
                      [1 - ca, 1 - (ka + kcp), 0, kcp],
                      [0, kb, 1 - cb, -kb], [0, kb, 1 - cb, 1 - kb]])
    f = ka * (0.1 * rng.standard_normal((BLOCK, 3)))
    out["flesh"] = (np.broadcast_to(a_mat, (BLOCK, 3, 4, 4)),
                    np.stack([f, f, 0 * f, 0 * f], -1), np.zeros((3, 4)))
    return {name: tuple(np.ascontiguousarray(v, np.float32) for v in arrs)
            for name, arrs in out.items()}


def _jax_relaxed_refs():
    """JAX's serial envelopes and matrix scans (run without FMA)."""
    import jax
    from juicy_tpu.ops import envelopes as je
    from juicy_tpu.ops import scan_utils as js
    from juicy_tpu.utils.convert import tau_coeff as jtau

    out = {}
    x = _env_input()
    atk, rel = jtau(0.003, SR), jtau(0.030, SR)
    init = np.float32([0.0, 0.01, 0.3])
    out["env/full"] = np.asarray(je.ar_envelope(x, atk, rel, init))
    out["env/final"] = np.asarray(je.ar_envelope_final(x, atk, rel, init))
    out["env/full0"] = np.asarray(je.ar_envelope(x.T, atk, rel, init,
                                                 axis=0))
    scan = jax.jit(js.linear_matrix_scan)
    for name, (mats, vecs, init) in _matrix_inputs().items():
        out[f"mat/{name}"] = np.asarray(scan(mats, vecs, init))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_relaxed", "_jax_relaxed_refs",
                            tmp_path_factory.mktemp("relaxed"))


def _bits_equal(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# ops, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 512])
def test_torch_associative_scans_match_jax(n, reverse):
    """The affine scan (linear_scan_assoc, JAX's linear_scan) and the
    (min, affine) scan, forward and reversed: JAX's recursion step for
    step, so bit-equal."""
    from juicy_tpu.ops import scan_utils as js
    from juicy_tpu.runtime import relaxed as rx

    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (3, n)).astype(np.float32)
    b = rng.standard_normal((3, n)).astype(np.float32)
    init = rng.standard_normal(3).astype(np.float32)
    want = js.linear_scan(a, b, init, axis=1, reverse=reverse)
    got = ts.linear_scan_assoc(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(init), reverse=reverse)
    _bits_equal(got.numpy(), want)

    caps = np.where(rng.random((n, 3)) < 0.2,
                    rng.uniform(0.3, 1.0, (n, 3)), 1e9).astype(np.float32)
    over = caps < 1e9
    coeffs = np.where(over, 1.0, np.float32(1.0) - np.float32(0.0028))
    offsets = np.where(over, 0.0, np.float32(0.0028))
    g0 = rng.uniform(0.2, 1.0, 3).astype(np.float32)
    want = rx.min_affine_scan(caps, coeffs.astype(np.float32),
                              offsets.astype(np.float32), g0)
    got = trx.min_affine_scan(*(torch.from_numpy(v.astype(np.float32))
                                for v in (caps, coeffs, offsets, g0)))
    _bits_equal(got.numpy(), want)


def test_torch_scan_forms_match_jax():
    """onepole_lowpass_assoc and leaky_integrator against JAX's
    onepole_lowpass and leaky_integrator, on [B, C, N] with a per-lane
    initial state and scalar and per-sample coefficients: bit-equal."""
    from juicy_tpu.ops import scan_utils as js

    x = _clips()[..., :BLOCK]
    rng = np.random.default_rng(3)
    init = rng.standard_normal(x.shape[:-1]).astype(np.float32)
    coeff = np.float32(0.0321)
    per_sample = rng.uniform(0.01, 0.3, x.shape).astype(np.float32)
    tx, ti = torch.from_numpy(x), torch.from_numpy(init)
    _bits_equal(ts.onepole_lowpass_assoc(tx, torch.tensor(coeff), ti).numpy(),
                js.onepole_lowpass(x, coeff, init))
    _bits_equal(ts.onepole_lowpass_assoc(tx, torch.from_numpy(per_sample),
                                         ti).numpy(),
                js.onepole_lowpass(x, per_sample, init))
    _bits_equal(ts.leaky_integrator(tx, torch.tensor(np.float32(0.93)),
                                    ti).numpy(),
                js.leaky_integrator(x, np.float32(0.93), init))


def test_torch_envelopes_match_jax(jax_ref):
    """ar_envelope, ar_envelope_final and ar_envelope_relaxed (2 and
    AR_ITERS passes), along the last axis and along axis 0: bit-equal."""
    from juicy_tpu.ops import envelopes as je
    from juicy_tpu.utils.convert import tau_coeff as jtau

    x = _env_input()
    init = np.float32([0.0, 0.01, 0.3])
    tx, ti = torch.from_numpy(x), torch.from_numpy(init)
    atk, rel = tau_coeff(0.003, SR), tau_coeff(0.030, SR)
    _bits_equal(te.ar_envelope(tx, atk, rel, ti).numpy(), jax_ref["env/full"])
    _bits_equal(te.ar_envelope_final(tx, atk, rel, ti).numpy(),
                jax_ref["env/final"])
    _bits_equal(te.ar_envelope(tx.T, atk, rel, ti, dim=0).numpy(),
                jax_ref["env/full0"])
    jatk, jrel = jtau(0.003, SR), jtau(0.030, SR)
    for iters in (2, trx.AR_ITERS):
        _bits_equal(te.ar_envelope_relaxed(tx, atk, rel, ti,
                                           iters=iters).numpy(),
                    je.ar_envelope_relaxed(x, jatk, jrel, init, iters=iters))
    _bits_equal(te.ar_envelope_relaxed(tx.T, atk, rel, ti, dim=0).numpy(),
                je.ar_envelope_relaxed(x.T, jatk, jrel, init, axis=0))


def test_torch_first_onset_matches_jax():
    """Onset count, exit cooldown and onset sample of the parallel
    detector, at the analyzer's 35 ms and motion's 40 ms cooldowns, from
    entry cooldowns before, inside and past the block: equal. A cooldown
    shorter than the block raises (JAX's returns a wrong count)."""
    from juicy_tpu.runtime import relaxed as rx

    rng = np.random.default_rng(11)
    for cd in (1680, 1920):
        for density in (0.0, 0.002, 0.05, 1.0):
            eligible = rng.random((64, BLOCK)) < density
            entry = rng.integers(0, 700, 64).astype(np.int32)
            entry[:4] = (0, 1, BLOCK, BLOCK + 1)
            want = rx._first_onset(eligible, entry, BLOCK, cd)
            got = trx._first_onset(torch.from_numpy(eligible),
                                   torch.from_numpy(entry), BLOCK, cd)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
                assert g.dtype == torch.int32
    with pytest.raises(ValueError, match="at least one block"):
        trx._first_onset(torch.zeros(2, 2048, dtype=torch.bool),
                         torch.zeros(2, dtype=torch.int32), 2048, 1680)


@pytest.mark.parametrize("name", ["gel", "metal", "flesh"])
def test_torch_linear_matrix_scan_matches_jax(name, jax_ref):
    """linear_matrix_scan at gel's 2x2, metal's 4 x 2x2 and flesh's 4x4
    coefficients over a block: <= -120 dBFS (measured: gel and metal
    bit-equal, flesh -197)."""
    mats, vecs, init = _matrix_inputs()[name]
    got = ts.linear_matrix_scan(torch.from_numpy(mats),
                                torch.from_numpy(vecs),
                                torch.from_numpy(init)).numpy()
    want = jax_ref[f"mat/{name}"]
    assert got.shape == want.shape
    assert residual_dbfs(got, want) <= -120.0


def _plugin(name, mat):
    plug = TPlugin(name, SR, 2, BLOCK)
    return plug if mat is None else plug.with_static(material=mat)


def _run_port(plug, params, clips, record=None):
    """relaxed_step block by block over `clips` [B, C, T] on the CPU:
    (audio, the last block's metrics, the final state); `record(k, state,
    metrics)` sees each block's."""
    st = plug.init_state((clips.shape[0],), "cpu")
    audio, last = [], None
    for k in range(clips.shape[-1] // BLOCK):
        o, st, last = trx.relaxed_step(
            plug, params, st, torch.from_numpy(clips[..., k * BLOCK:
                                                     (k + 1) * BLOCK]))
        audio.append(o.numpy())
        if record is not None:
            record(k, st, last)
    return np.concatenate(audio, -1), last, st


# ---------------------------------------------------------------------------
# JAX's certification of the tier (tests/test_relaxed.py), on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,static,bar", STAGE_BARS,
                         ids=_ids([(n, None if s is None else s["material"])
                                   for n, s, _ in STAGE_BARS]))
def test_torch_stage_relaxed_matches_exact(name, static, bar):
    clip = make_clip(np.random.default_rng(0xA0D10), 2, BLOCK * 4)
    plug = _plugin(name, None if static is None else static["material"])
    params = plug.full_params(plug.default_params())
    out_e, _, m_e = plug.run(params, plug.init_state((), "cpu"),
                             torch.from_numpy(clip))
    out_r, last_r, _ = _run_port(plug, params, clip[None])
    db = residual_dbfs(out_r[0], out_e.numpy())
    assert db <= bar, f"{name} relaxed audio {db:.1f} dBFS vs bar {bar}"
    sc_e = float(m_e["score"].reshape(-1)[-1])
    sc_r = float(last_r["score"].reshape(-1)[-1])
    assert abs(sc_e - sc_r) <= 0.15, f"{name} score {sc_r} vs exact {sc_e}"


def test_torch_relaxed_texture_waveguide_falls_back_exact():
    """Wood has no relaxed form: relaxed_step runs the exact process, so
    the audio is the exact executor's (JAX's bar: <= -110 dBFS)."""
    clip = make_clip(np.random.default_rng(0xA0D11), 2, BLOCK * 2)
    plug = _plugin("texture", 2)
    params = plug.full_params(plug.default_params())
    out_e, _, _ = plug.run(params, plug.init_state((), "cpu"),
                           torch.from_numpy(clip))
    out_r, _, _ = _run_port(plug, params, clip[None])
    assert residual_dbfs(out_r[0], out_e.numpy()) <= -110.0


def test_torch_relaxed_texture_per_clip_material_runs_exact():
    """A material per clip (a [B] row on a with_traced plugin) has no
    relaxed form: relaxed_step runs the exact traced process, as JAX's
    does for a mapped material, and its audio is the exact step's."""
    plug = TPlugin("texture", SR, 2, BLOCK).with_traced("material")
    params = dict(plug.default_params(),
                  material=torch.tensor([0.0, 1.0, 4.0, 2.0]))
    blk = torch.from_numpy(_clips()[..., :BLOCK])
    st = plug.init_state((B,), "cpu")
    out_r, _st, _m = trx.relaxed_step(plug, params, st, blk)
    out_e, _st, _m = plug.step(params, st, blk)
    _bits_equal(out_r.numpy(), out_e.numpy())


def test_torch_ar_envelope_relaxed_bounds():
    """Within -60 dBFS of the exact scan on onset-rich material; one
    linear recurrence (<= -120) when attack == release."""
    x = torch.from_numpy(np.abs(make_clip(np.random.default_rng(7), 1,
                                          2048)[0]))
    atk, rel = tau_coeff(0.003, SR), tau_coeff(0.030, SR)
    zero = torch.tensor(0.0)
    e = te.ar_envelope(x, atk, rel, zero).numpy()
    r = te.ar_envelope_relaxed(x, atk, rel, zero, iters=trx.AR_ITERS).numpy()
    assert residual_dbfs(r, e) <= -60.0
    e2 = te.ar_envelope(x, rel, rel, zero).numpy()
    r2 = te.ar_envelope_relaxed(x, rel, rel, zero).numpy()
    assert residual_dbfs(r2, e2) <= -120.0


def test_torch_parallel_onset_matches_scan_across_blocks():
    """On a click train throttled by the 35 ms cooldown, the relaxed
    analyzer's cooldown equals the exact analyzer's after every block, and
    its repetition density is within 1e-5."""
    from juicy_tpu_torch import analyzer as an

    local = np.random.default_rng(3)
    clip = np.zeros((2, BLOCK * 6), np.float32)
    clip[:, ::960] = 0.9
    clip += 0.01 * local.standard_normal(clip.shape).astype(np.float32)
    st_e = an.analyzer_init((), "cpu")
    st_r = an.analyzer_init((), "cpu")
    for k in range(clip.shape[-1] // BLOCK):
        blk = torch.from_numpy(clip[:, k * BLOCK:(k + 1) * BLOCK])
        st_e, m_e = an.analyze(st_e, blk, SR)
        st_r, m_r = trx.analyze_relaxed(st_r, blk, SR)
        assert int(st_e["onset_cooldown"]) == int(st_r["onset_cooldown"]), k
        assert abs(float(m_e["repetition_density"])
                   - float(m_r["repetition_density"])) < 1e-5
