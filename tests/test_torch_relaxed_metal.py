"""``relaxed_step`` of the port against JAX's for texture's metal, whose
JAX side runs eagerly (under jit XLA's rewrites, amplified by the
resonators, put it at -91.9 dBFS and a width score 2.2e-5 from the port;
eagerly the port is bit-equal to it), in its own subprocess without FMA:
the checks and the bar (<= -90 dBFS) are tests/test_torch_relaxed_step.py's.
"""

import pytest

from tests.test_torch_relaxed import JAX_CASES, _ids
from tests.test_torch_relaxed_step import check_against_jax, jax_step_refs
from tests.torch_jax_ref import no_fma_reference

CASES = [c for c in JAX_CASES if c[0] == "texture" and c[1] == 1]


def _jax_metal_refs():
    return jax_step_refs(CASES)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_relaxed_metal",
                            "_jax_metal_refs",
                            tmp_path_factory.mktemp("relaxed_metal"))


@pytest.mark.parametrize("name,mat,bar", CASES, ids=_ids(CASES))
def test_torch_relaxed_metal_step_matches_jax(name, mat, bar, jax_ref):
    check_against_jax(name, mat, bar, jax_ref)
