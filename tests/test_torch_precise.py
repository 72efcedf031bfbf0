"""PyTorch port vs JAX: the drift-pinned numerics, bit for bit.

`ops/precise.py` of the port against the numpy path of juicy_tpu's (its
jax-free oracle), and `utils/convert.py` against juicy_tpu's eager-jnp
helpers, compared as int32 bit views on a seeded grid plus the edges
(sin32 over ±π/2, ±π and 2π..7.2, the reach of motion's LFO phase;
exp32_narrow over [−0.7, 0]; onepole_coeff32 over motion's cutoffs). The
serial scans are held to a float32 numpy loop. One subprocess test checks
that the port imports neither JAX nor juicy_tpu.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juicy_tpu.ops.precise as jp
import juicy_tpu.utils.convert as jc
import juicy_tpu_torch.ops.precise as tp
import juicy_tpu_torch.utils.convert as tc
from juicy_tpu_torch.ops.scan_utils import linear_scan, onepole_lowpass

F = np.float32
SR = 48000.0


def _grid(lo, hi, edges, seed):
    x = np.random.default_rng(seed).uniform(lo, hi, 20000)
    return np.concatenate([x, edges]).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _assert_bit_equal(ours, ref):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    bad = np.flatnonzero(_bits(ours) != _bits(ref))
    assert bad.size == 0, f"{bad.size} values differ, first at {bad[:5]}"


EDGES = [0.0, 9.1, -9.1, 125.0, -125.0, 1.0, -1.0, 0.5, -0.5]

# name -> (port fn, JAX numpy-path fn, input grid)
PRECISE_CASES = {
    "exp32": (tp.exp32, jp.exp32, _grid(-2.5, 0.0, [0.0, -2.5, -1.0], 1)),
    "exp2_32": (tp.exp2_32, jp.exp2_32,
                _grid(-130.0, 130.0, EDGES + [130.0, -130.0], 2)),
    "log2_32": (tp.log2_32, jp.log2_32,
                np.abs(_grid(1e-30, 3e38, [1.0, 2.0, 1.4142135, 1e-38], 3))),
    "tanh32": (tp.tanh32, jp.tanh32, _grid(-12.0, 12.0, EDGES + [88.0, -88.0], 4)),
    "sin32_half_pi": (tp.sin32, jp.sin32,
                      _grid(-np.pi / 2, np.pi / 2, [0.0, 1.5707964, -1.5707964], 13)),
    "sin32_pi": (tp.sin32, jp.sin32,
                 _grid(-np.pi, np.pi, [3.1415927, -3.1415927, 3.1415925], 14)),
    "sin32_wide": (tp.sin32, jp.sin32,
                   np.concatenate([_grid(2 * np.pi, 7.2, [6.2831855, 7.2], 15),
                                   -_grid(2 * np.pi, 7.2, [6.2831855, 7.2], 16)])),
    "exp32_narrow": (tp.exp32_narrow, jp.exp32_narrow,
                     _grid(-0.7, 0.0, [0.0, -0.7, -0.5497787], 17)),
    "onepole_coeff32": (lambda f: tp.onepole_coeff32(f, SR, 4200.0),
                        lambda f: jp.onepole_coeff32(f, SR, 4200.0),
                        _grid(120.0, 4200.0, [120.0, 900.0, 4200.0], 18)),
    "onepole_coeff32_wide": (lambda f: tp.onepole_coeff32(f, 32000.0, 4200.0),
                             lambda f: jp.onepole_coeff32(f, 32000.0, 4200.0),
                             _grid(120.0, 4200.0, [120.0, 4200.0], 19)),
}


@pytest.mark.parametrize("name", sorted(PRECISE_CASES))
def test_precise_bit_identical(name):
    ours_fn, ref_fn, x = PRECISE_CASES[name]
    _assert_bit_equal(ours_fn(torch.from_numpy(x)), ref_fn(x))


def test_pow32_bit_identical():
    rng = np.random.default_rng(5)
    a = np.concatenate([rng.uniform(1e-6, 1e3, 20000), [1.0, 2.0, 10.0]]).astype(F)
    b = np.concatenate([rng.uniform(-4.0, 4.0, 20000), [0.0, 1.0, -1.0]]).astype(F)
    _assert_bit_equal(tp.pow32(torch.from_numpy(a), torch.from_numpy(b)),
                      jp.pow32(a, b))


# name -> (port fn, JAX fn, input grid); the JAX helpers run eagerly
CONVERT_CASES = {
    "db_to_gain": (tc.db_to_gain, jc.db_to_gain,
                   _grid(-120.0, 30.0, [-100.0, -99.99, 0.0, 24.0, -18.0], 6)),
    "gain_to_db": (tc.gain_to_db, jc.gain_to_db,
                   _grid(0.0, 4.0, [0.0, 1e-30, 1e-6, 1.0, -0.5], 7)),
    "onepole_coeff": (lambda f: tc.onepole_coeff(f, SR),
                      lambda f: jc.onepole_coeff(f, SR),
                      _grid(20.0, 20000.0, [250.0, 2500.0, 16000.0], 8)),
    "jmap": (lambda v: tc.jmap(v, 2500.0, 16000.0),
             lambda v: jc.jmap(v, 2500.0, 16000.0),
             _grid(0.0, 1.0, [0.0, 0.55, 1.0], 9)),
    "jlimit": (lambda v: tc.jlimit(0.0, 0.6, v), lambda v: jc.jlimit(0.0, 0.6, v),
               _grid(-1.0, 1.0, [0.0, 0.6, 0.6000001], 10)),
    "jmap5": (lambda v: tc.jmap5(v, 0.0, 2.0, 0.75, 1.6),
              lambda v: jc.jmap5(v, 0.0, 2.0, 0.75, 1.6),
              _grid(0.0, 2.0, [0.0, 1.0, 2.0], 20)),
}


@pytest.mark.parametrize("name", sorted(CONVERT_CASES))
def test_convert_bit_identical(name):
    ours_fn, ref_fn, x = CONVERT_CASES[name]
    _assert_bit_equal(ours_fn(torch.from_numpy(x)),
                      np.asarray(ref_fn(jnp.asarray(x))))


@pytest.mark.parametrize("sr", [44100.0, 48000.0, 96000.0])
def test_tau_coeff_bit_identical(sr):
    for tau in (0.003, 0.030, 0.050, 0.300):
        _assert_bit_equal(tc.tau_coeff(tau, sr),
                          np.asarray(jc.tau_coeff(tau, sr)))


def test_serial_scans_match_float32_loop():
    """The port's scans are serial: bit-equal to a float32 numpy loop in the
    same op order (the order the CUDA kernels use)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 2, 200)).astype(F)
    coeff = F(tc.onepole_coeff(2500.0, SR))
    init = rng.standard_normal((3, 2)).astype(F)
    y, ref = init.copy(), np.empty_like(x)
    for i in range(x.shape[-1]):
        y = y + coeff * (x[..., i] - y)
        ref[..., i] = y
    got = onepole_lowpass(torch.from_numpy(x), float(coeff), torch.from_numpy(init))
    np.testing.assert_array_equal(got.numpy(), ref)

    a = rng.uniform(0.5, 0.99, x.shape).astype(F)
    y, ref = init.copy(), np.empty_like(x)
    for i in range(x.shape[-1]):
        y = a[..., i] * y + x[..., i]
        ref[..., i] = y
    got = linear_scan(torch.from_numpy(a), torch.from_numpy(x),
                      torch.from_numpy(init))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_port_imports_no_jax():
    code = ("import importlib, pkgutil, sys, juicy_tpu_torch; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "juicy_tpu_torch.__path__, 'juicy_tpu_torch.')]; "
            "assert all(f'juicy_tpu_torch.{m}' in sys.modules for m in ("
            "'models.texture', 'models.punch', 'models.motion', 'models.width', "
            "'models.cohere', 'models.infer', 'ops.noise', 'ops.delays', "
            "'ops.shapers', 'runtime.plugin', 'kernels.chain_kernel', "
            "'runtime.chain_fused', 'parallel.corpus', "
            "'kernels.analyzer_kernel', 'kernels.saturator_kernel', "
            "'runtime.serve', 'runtime.state', 'runtime.wav', "
            "'runtime.native', 'runtime.observe', 'runtime.host_bridge', "
            "'ui.meters', 'ui.web', 'cli', '__main__')); "
            "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules); "
            "assert not any(m == 'juicy_tpu' or m.startswith('juicy_tpu.') "
            "for m in sys.modules)")
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cos32_bit_identical_over_metal_thetas():
    """cos32 on the metal bank's angles: f·theta_scale(sr) for f up to the
    0.45·sr cap, at 44.1, 48 and 96 kHz, plus a sweep of |z| <= 2.9."""
    import juicy_tpu_torch.models.texture as ttex

    f = np.concatenate([np.linspace(20.0, 21600.0, 20000), [20.0, 320.0,
                                                            21600.0]])
    zs = [_grid(-2.9, 2.9, [0.0, 2.9, -2.9, 1.0], 12)]
    for sr in (44100.0, 48000.0, 96000.0):
        cap = np.minimum(f, 0.45 * sr).astype(F)
        zs.append(cap * F(ttex.theta_scale(sr)))
        assert F(ttex.theta_scale(sr)) == F(F(2.0 * 3.14159265358979323846)
                                            / F(sr))
    for z in zs:
        z = z.astype(F)
        _assert_bit_equal(tp.cos32(torch.from_numpy(z)), jp.cos32(z))
