"""The one clip of the full-depth certificate that breaks its bar, pinned at
the smallest size that shows it.

``PORT_CERT.json`` ("cpu", from ``tools/certify_port.py --half cpu``) holds
the port's main path to JAX's fused executor, run op by op, over 512 clips
x 94 blocks. Gel clip 507 parts from it at -28.77 dBFS from block 21. Its
first 22 blocks show why: JAX's own two executors, fused and stage-major,
compute width's input within 1e-6 of each other, and at sample 10,788
width's shrink test (``clip(l * r * 12, -1, 1) < -0.1``) falls on the
two sides of its threshold. The port's main path computes that input
within the same rounding of both, and its test falls on stage-major's
side at every sample; from there its output follows JAX's stage-major
chain. Which of
JAX's executors falls below the threshold is XLA's rounding choice: with
XLA:CPU's default flags, which contract ``a*b + c`` into FMAs, the two
swap sides at the same sample. A threshold flip between JAX's executors
(ROADMAP.md Queue 3: XLA:CPU's contraction under jit, and JAX under one
jit against op by op), not a fault of the port. JAX's numbers come from
one no-FMA subprocess (``tests/torch_jax_ref.py``) and one with XLA's
default flags.
"""

from __future__ import annotations

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from tests.torch_jax_ref import ROOT, no_fma_reference
from tools import certify_port as cp

CLIP = 507
BLOCKS = 22                      # the flip is in block 21
FLIP = 10788                     # the one sample where the executors part
WIDTH = 5                        # width is the chain's fifth stage
ROUNDING = 1e-6                  # -120 dBFS: the executors' own distance


def _clip():
    return cp.make_clips()[CLIP, :, :BLOCKS * cp.BLOCK]


def _jax_side():
    """In the no-FMA subprocess: the clip through JAX's two executors (the
    fused one up to width's input and whole)."""
    return cp.jax_explain(_clip(), prefixes=(WIDTH - 1, len(cp.CHAIN)))


def _jax_fma_side():
    """In a process with XLA's default flags: whether jitted a*b + c is one
    FMA there, and the clip through JAX's two executors."""
    import jax

    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 rounds to 1 + 2^-11 in float32;
    # only a fused multiply-add keeps the 2^-24
    a, c = np.float32(1 + 2 ** -12), np.float32(-(1 + 2 ** -11))
    contracts = float(jax.jit(lambda a, c: a * a + c)(a, c)) != 0.0
    return dict(_jax_side(), contracts=np.array(contracts))


def _default_xla_reference(func, out_dir):
    """``func()`` of this module in a fresh JAX process with XLA's default
    flags; its arrays."""
    path = Path(out_dir) / f"{func}.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = ("import numpy as np, tests.test_torch_cert as m; "
            f"np.savez({str(path)!r}, **m.{func}())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"JAX reference {func} failed:\n"
                           f"{proc.stderr[-4000:]}")
    with np.load(path) as z:
        return dict(z)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """JAX's sides in their subprocesses while the port's runs here."""
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(no_fma_reference, "tests.test_torch_cert",
                          "_jax_side", tmp_path_factory.mktemp("jax"))
        fma = pool.submit(_default_xla_reference, "_jax_fma_side",
                          tmp_path_factory.mktemp("fma"))
        port = cp.port_stage_outputs(_clip())
        return ref.result(), port, fma.result()


def _maxabs(a, b):
    return float(np.max(np.abs(a.astype(np.float64) - b)))


def test_torch_cert_clip507_width_input_within_rounding(sides):
    """Width's input (motion's output) from the port's main path and from
    JAX's two executors agree to the rounding the executors differ by."""
    ref, port, _fma = sides
    fused, stage = ref[f"fused/{WIDTH - 1}"], ref[f"stage/{WIDTH - 1}"]
    assert _maxabs(fused, stage) <= ROUNDING
    assert _maxabs(port[WIDTH - 1], stage) <= ROUNDING
    assert _maxabs(port[WIDTH - 1], fused) <= ROUNDING


def test_torch_cert_clip507_shrink_test_flips_between_jax_executors(sides):
    """JAX's executors part at one sample of width's shrink test, each
    within the rounding of the threshold there; the port's main path takes
    stage-major's side at every sample."""
    ref, port, _fma = sides
    val_f, dip_f = cp.width_dips(ref[f"fused/{WIDTH - 1}"])
    val_s, dip_s = cp.width_dips(ref[f"stage/{WIDTH - 1}"])
    val_p, dip_p = cp.width_dips(port[WIDTH - 1])
    assert np.where(dip_f != dip_s)[0].tolist() == [FLIP]
    assert dip_f[FLIP] and not dip_s[FLIP] and not dip_p[FLIP]
    for val in (val_f, val_s, val_p):
        assert abs(float(val[FLIP]) + 0.1) <= ROUNDING
    np.testing.assert_array_equal(dip_p, dip_s)


def test_torch_cert_clip507_port_follows_jax_stage_major(sides):
    """The port's output stays within -100 dBFS of JAX's stage-major chain
    over all 22 blocks, and of JAX's fused chain until block 21, where the
    flip takes the fused chain -28.77 dBFS away."""
    ref, port, _fma = sides
    out = port[len(cp.CHAIN)]
    stage, fused = ref[f"stage/{len(cp.CHAIN)}"], ref[f"fused/{len(cp.CHAIN)}"]
    assert 20 * np.log10(_maxabs(out, stage)) <= -100.0
    before = slice(0, (FLIP // cp.BLOCK) * cp.BLOCK)
    assert 20 * np.log10(_maxabs(out[:, before], fused[:, before])) <= -100.0
    assert 20 * np.log10(_maxabs(out, fused)) > -80.0


def test_torch_cert_clip507_jax_executors_swap_sides_with_fma(sides):
    """With FMA contraction, JAX's executors part at the same sample the
    other way round: stage-major below the threshold, fused above it, each
    within the rounding of it; the port, which rounds twice everywhere,
    then shares the fused executor's flags."""
    _ref, port, fma = sides
    if not bool(fma["contracts"]):
        pytest.skip("XLA:CPU emits no FMA on this host")
    val_f, dip_f = cp.width_dips(fma[f"fused/{WIDTH - 1}"])
    val_s, dip_s = cp.width_dips(fma[f"stage/{WIDTH - 1}"])
    assert np.where(dip_f != dip_s)[0].tolist() == [FLIP]
    assert dip_s[FLIP] and not dip_f[FLIP]
    for val in (val_f, val_s):
        assert abs(float(val[FLIP]) + 0.1) <= ROUNDING
    np.testing.assert_array_equal(cp.width_dips(port[WIDTH - 1])[1], dip_f)
