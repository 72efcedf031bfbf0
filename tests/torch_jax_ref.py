"""JAX references for the port's texture tests, computed in a subprocess
whose XLA:CPU emits no fused multiply-add.

Under jit, XLA:CPU contracts ``a*b + c`` into one FMA (one rounding where
the reference C++ and the port round twice; the CUDA kernels build with
``-fmad=false``). Texture's near-unity modal poles and its ~0.99 waveguide
feedback amplify that difference block after block: against the default
XLA:CPU, the port's metal model is −117 dBFS after one block of 64 samples
and −103 after two. Started with ``--xla_cpu_max_isa=SSE4_2``, XLA has no
FMA instruction to contract into, and the same JAX code agrees with the
port bit for bit on metal, wood and plastic. The tests that hold texture to
JAX over several blocks, or at corpus width, take JAX's numbers from such a
process; each function named here returns a flat dict of numpy arrays.
Also the check, shared by the texture tests, of which material ran.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
NO_FMA_FLAG = "--xla_cpu_max_isa=SSE4_2"


def check_no_fma():
    """Raise unless jitted a*b + c rounds twice in this process."""
    import jax

    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(4096).astype(np.float32) for _ in range(3))
    got = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    if not np.array_equal(got, a * b + c):
        raise RuntimeError("XLA:CPU still contracts multiply-adds into FMA")


def no_fma_reference(module: str, func: str, out_dir: Path):
    """``module.func()`` run in a fresh process without FMA; its arrays."""
    path = Path(out_dir) / f"{func}.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} {NO_FMA_FLAG}".strip()
    code = ("import numpy as np, tests.torch_jax_ref as r, "
            f"{module} as m; r.check_no_fma(); "
            f"np.savez({str(path)!r}, **m.{func}())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"JAX reference {module}.{func} failed:\n"
                           f"{proc.stderr[-4000:]}")
    with np.load(path) as z:
        return dict(z)


# material -> the state leaves only that material's model moves
OWN = {0: ("spring_pos", "spring_vel"), 1: ("modal_y1", "modal_y2"),
       2: ("modal_y1", "modal_y2", "prev_wave", "waveguide", "wave_idx"),
       3: ("modal_y1", "modal_y2", "prev_wave", "waveguide", "wave_idx"),
       4: ("flesh_pos_a", "flesh_vel_b")}
# (prev_wave is left out: wood's delay outlasts the tests' short clips)
MATERIAL_LEAVES = ("spring_pos", "spring_vel", "modal_y1", "modal_y2",
                   "waveguide", "wave_idx", "flesh_pos_a", "flesh_vel_b")


def assert_material_ran(init, final, material):
    """The material's own state leaves moved and no other material's did
    (state dicts of arrays or tensors, in the state form)."""
    for key in MATERIAL_LEAVES:
        moved = not np.array_equal(np.asarray(init[key]), np.asarray(final[key]))
        assert moved == (key in OWN[material]), (material, key)
