"""``relaxed_step`` and ``analyze_relaxed`` of the port
(juicy_tpu_torch/runtime/relaxed.py) against JAX's relaxed_step, on the
CPU: the nine STAGE_BARS cases of tests/test_relaxed.py and wood's
fallback to the exact process, B = 4 clips of 4 blocks of 512. This file
holds the six stages without a material; tests/test_torch_relaxed_texture.py
and test_torch_relaxed_metal.py texture's four cases (each file's JAX
subprocess runs beside the others').

JAX's side comes from a subprocess without FMA (tests/torch_jax_ref.py):
even eagerly, XLA:CPU computes the matrix scans' einsums with fused
multiply-adds (metal's relaxed texture lands at -60 dBFS from the port in
this process), and wood's fallback is a ``lax.scan``. There it runs jitted
per stage (a fraction of its eager run's time) but for metal, whose
resonators amplify XLA's rewrites under jit (-91.9 dBFS from the port, a
width score 2.2e-5 off): metal runs eagerly, as the bars assume, and the
port is then bit-equal to it.

Bars, stated before measurement: audio <= -110 dBFS (metal, flesh and wood
<= -90), metrics within 1e-5 of max(1, |value|), the analyzers' cooldowns
and motion's ``rng`` and cooldown equal after every block.
"""

import numpy as np
import pytest

from tests.conftest import residual_dbfs
from tests.test_torch_relaxed import (B, BLOCK, JAX_CASES, NB, SR, _clips,
                                      _ids, _plugin, _run_port)
from tests.torch_jax_ref import no_fma_reference


def jax_step_refs(cases):
    """JAX's relaxed_step on `cases` (run without FMA)."""
    import jax
    import jax.numpy as jnp
    from juicy_tpu.runtime import relaxed as rx
    from juicy_tpu.runtime.plugin import Plugin

    out = {}
    clips = _clips()
    for (name, mat, _bar), key in zip(cases, _ids(cases)):
        plug = Plugin(name, SR, 2, BLOCK)
        if mat is not None:
            plug = plug.with_static(material=mat)
        params = plug.default_params()
        step = jax.vmap(
            lambda s, b, _p=plug, _q=params: rx.relaxed_step(_p, _q, s, b))
        if mat != 1:
            step = jax.jit(step)
        st = jax.vmap(lambda _, _p=plug: _p.init_state())(jnp.arange(B))
        audio = []
        for k in range(NB):
            o, st, m = step(st, clips[..., k * BLOCK:(k + 1) * BLOCK])
            audio.append(np.asarray(o))
            out[f"{key}/{k}/cooldown"] = np.asarray(
                st["analyzer"]["onset_cooldown"])
            if name == "motion":
                out[f"{key}/{k}/rng"] = np.asarray(
                    st["dsp"]["rng"]).astype(np.int64)
                out[f"{key}/{k}/motion_cooldown"] = np.asarray(
                    st["dsp"]["onset_cooldown"])
            out.update({f"{key}/{k}/m/{mk}": np.asarray(mv)
                        for mk, mv in m.items()})
        out[f"{key}/audio"] = np.concatenate(audio, -1)
    return out


#: the stages without a texture material (texture's four:
#: tests/test_torch_relaxed_texture.py, so that the two JAX subprocesses
#: run side by side)
CASES = [c for c in JAX_CASES if c[0] != "texture"]


def _jax_step_refs():
    return jax_step_refs(CASES)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_relaxed_step", "_jax_step_refs",
                            tmp_path_factory.mktemp("relaxed_step"))


def check_against_jax(name, mat, bar, jax_ref):
    """The port's relaxed_step over the clips against JAX's, to the bars."""
    key = _ids([(name, mat)])[0]
    plug = _plugin(name, mat)

    def record(k, st, m):
        np.testing.assert_array_equal(
            st["analyzer"]["onset_cooldown"].numpy(),
            jax_ref[f"{key}/{k}/cooldown"])
        if name == "motion":
            np.testing.assert_array_equal(st["dsp"]["rng"].numpy(),
                                          jax_ref[f"{key}/{k}/rng"])
            np.testing.assert_array_equal(
                st["dsp"]["onset_cooldown"].numpy(),
                jax_ref[f"{key}/{k}/motion_cooldown"])
        for mk, mv in m.items():
            want = jax_ref[f"{key}/{k}/m/{mk}"]
            rel = np.abs(mv.numpy().astype(np.float64) - want) / \
                np.maximum(1.0, np.abs(want))
            assert rel.max() <= 1e-5, (k, mk, rel.max())

    audio, _last, _st = _run_port(plug, plug.default_params(), _clips(),
                                  record)
    db = residual_dbfs(audio, jax_ref[f"{key}/audio"])
    assert db <= bar, f"{key}: {db:.1f} dBFS from JAX's relaxed_step"


@pytest.mark.parametrize("name,mat,bar", CASES, ids=_ids(CASES))
def test_torch_relaxed_step_matches_jax(name, mat, bar, jax_ref):
    check_against_jax(name, mat, bar, jax_ref)
