"""``relaxed_chain_stream`` (juicy_tpu_torch/runtime/relaxed.py) on the
CPU: against JAX's relaxed_chain_stream, and against the port's exact
executor as JAX's tests/test_relaxed.py holds JAX's.

JAX's side runs ``lax.scan`` under jit, so it comes from a subprocess
without FMA (tests/torch_jax_ref.py). Bars, stated before measurement: the
canonical chain, B = 4 clips of 4 blocks of 512, <= -100 dBFS from JAX's
and every stage's scores within 1e-5 of max(1, |value|) after every block;
against the port's exact ``Chain.batched_run``, JAX's own bar: <= -90 dBFS
and the last stage's last-block scores within 0.01 (JAX measured -104.8
and 5e-5 on its side).
"""

import numpy as np
import pytest
import torch

from tests.conftest import make_clip, residual_dbfs
from tests.torch_jax_ref import no_fma_reference

from juicy_tpu_torch.runtime import relaxed as trx
from juicy_tpu_torch.runtime.plugin import Chain

SR = 48000.0
BLOCK = 512
NB = 4
B = 4
STAGES = [("punch", None), ("saturator", None), ("texture", None),
          ("motion", None), ("width", None), ("cohere", None),
          ("infer", None)]


def _clips():
    local = np.random.default_rng(0xA0D10)
    return np.stack([make_clip(local, 2, BLOCK * NB)
                     for _ in range(B)]).astype(np.float32)


def _jax_chain_refs():
    """JAX's relaxed_chain_stream on the canonical chain (run without
    FMA)."""
    import jax
    import jax.numpy as jnp
    from juicy_tpu.runtime import relaxed as rx
    from juicy_tpu.runtime.plugin import Chain as JChain

    chain = JChain(STAGES, sr=SR, channels=2, block_size=BLOCK)
    states = [jax.vmap(lambda _, _p=p: _p.init_state())(jnp.arange(B))
              for p in chain.plugins]
    out, _st, ms = rx.relaxed_chain_stream(chain, states, _clips())
    res = {"audio": np.asarray(out)}
    for s, m in enumerate(ms):
        res.update({f"{s}/{k}": np.asarray(v) for k, v in m.items()})
    return res


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_relaxed_chain",
                            "_jax_chain_refs",
                            tmp_path_factory.mktemp("relaxed_chain"))


@pytest.fixture(scope="module")
def port_run():
    chain = Chain(STAGES, sr=SR, channels=2, block_size=BLOCK)
    return trx.relaxed_chain_stream(chain, chain.init_state((B,), "cpu"),
                                    _clips(), device="cpu")


def test_torch_relaxed_chain_matches_jax(port_run, jax_ref):
    out, _states, ms = port_run
    db = residual_dbfs(out.numpy(), jax_ref["audio"])
    assert db <= -100.0, f"relaxed chain {db:.1f} dBFS from JAX's"
    for s, m in enumerate(ms):
        for k, v in m.items():
            want = jax_ref[f"{s}/{k}"]
            assert v.shape == want.shape == (NB, B), (s, k)
            rel = np.abs(v.numpy().astype(np.float64) - want) / \
                np.maximum(1.0, np.abs(want))
            assert rel.max() <= 1e-5, (s, k, rel.max())


def test_torch_full_chain_relaxed_matches_exact(port_run):
    """The canonical seven-stage chain: the relaxed executor within -90
    dBFS of the exact batched executor, scores within 0.01."""
    chain = Chain(STAGES, sr=SR, channels=2, block_size=BLOCK)
    out_e, _, m_e = chain.batched_run(chain.init_state((B,), "cpu"),
                                      torch.from_numpy(_clips()))
    out_r, _, m_r = port_run
    db = residual_dbfs(out_r.numpy(), out_e.numpy())
    assert db <= -90.0, f"full-chain relaxed residual {db:.1f} dBFS"
    np.testing.assert_allclose(m_r[-1]["score"][-1].numpy(),
                               m_e[-1]["score"][-1].numpy(), atol=0.01)


def test_torch_relaxed_chain_device_and_materials():
    """No device is the card, which must exist; a texture material per
    clip raises ValueError, as JAX's relaxed_chain_stream does for a [B]
    material row."""
    from juicy_tpu_torch.parallel.corpus import with_materials

    chain = Chain(STAGES, sr=SR, channels=2, block_size=BLOCK)
    clips = _clips()[:2, :, :BLOCK]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trx.relaxed_chain_stream(chain, chain.init_state((2,), "cpu"),
                                     clips)
    mixed = with_materials(chain, [0, 1])
    with pytest.raises(ValueError, match="one texture material"):
        trx.relaxed_chain_stream(mixed, mixed.init_state((2,), "cpu"), clips,
                                 device="cpu")
    with pytest.raises(ValueError, match="multiple of block size"):
        trx.relaxed_chain_stream(chain, chain.init_state((2,), "cpu"),
                                 clips[..., :100], device="cpu")
