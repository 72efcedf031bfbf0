"""``relaxed_step`` of the port against JAX's for texture: gel and flesh
on their relaxed forms, wood on its exact fallback (metal, whose JAX side
runs eagerly: tests/test_torch_relaxed_metal.py). The checks and the bars
are tests/test_torch_relaxed_step.py's (flesh and wood <= -90 dBFS, gel
<= -110); JAX's side runs in its own subprocess without FMA.
"""

import pytest

from tests.test_torch_relaxed import JAX_CASES, _ids
from tests.test_torch_relaxed_step import check_against_jax, jax_step_refs
from tests.torch_jax_ref import no_fma_reference

CASES = [c for c in JAX_CASES if c[0] == "texture" and c[1] != 1]


def _jax_texture_refs():
    return jax_step_refs(CASES)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_relaxed_texture",
                            "_jax_texture_refs",
                            tmp_path_factory.mktemp("relaxed_texture"))


@pytest.mark.parametrize("name,mat,bar", CASES, ids=_ids(CASES))
def test_torch_relaxed_texture_step_matches_jax(name, mat, bar, jax_ref):
    check_against_jax(name, mat, bar, jax_ref)
