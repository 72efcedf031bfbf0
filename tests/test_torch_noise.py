"""PyTorch port vs JAX: the LCG noise, bit for bit.

`juicy_tpu_torch/ops/noise.py` carries u32 values in int64 tensors. Its jump
coefficients, `lcg_sequence`, `lcg_advance` and `white_from_bits` are held to
juicy_tpu/ops/noise.py on seeds that include the edges of the u32 range,
where a product of two u32 values would overflow int64 unless split. The
stage kernel's two-state scheme (channel 0 from rng, channel 1 from
lcg_advance(rng, N), each stepped N times) ends at lcg_advance(rng, 2N).
Also the uint32 leaf through from_jax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juicy_tpu.ops.noise as jn
import juicy_tpu_torch.ops.noise as tn
from juicy_tpu_torch.utils.from_jax import to_numpy, to_torch

SEEDS = np.concatenate([
    np.array([0, 1, 0x12345678, 0x93AB12F0, 2 ** 31 - 1, 2 ** 31,
              2 ** 32 - 2, 2 ** 32 - 1], dtype=np.uint64),
    np.random.default_rng(7).integers(0, 2 ** 32, 56, dtype=np.uint64),
]).astype(np.uint32)


def _carrier(u32):
    return torch.from_numpy(np.asarray(u32, np.uint32).astype(np.int64))


def test_jump_coefficients_bit_equal():
    for n in (1, 64, 1024):
        ours, ref = tn._jump_coefficients(n), jn._jump_coefficients(n)
        for a, b in zip(ours, ref):
            assert a.dtype == np.uint32
            np.testing.assert_array_equal(a, b)
        assert tn.jump(n) == (int(ref[0][-1]), int(ref[1][-1]))
    assert tn.jump(0) == (1, 0)


@pytest.mark.parametrize("n", [1, 7, 128, 1024])
def test_lcg_sequence_and_advance_bit_equal(n):
    seq = tn.lcg_sequence(_carrier(SEEDS), n)
    ref = np.asarray(jn.lcg_sequence(jnp.asarray(SEEDS), n))
    assert seq.dtype == torch.int64 and int(seq.min()) >= 0
    np.testing.assert_array_equal(seq.numpy().astype(np.uint32), ref)
    adv = tn.lcg_advance(_carrier(SEEDS), n)
    np.testing.assert_array_equal(adv.numpy().astype(np.uint32),
                                  np.asarray(jn.lcg_advance(SEEDS, n)))
    np.testing.assert_array_equal(adv.numpy(), seq[..., -1].numpy())
    white = tn.white_from_bits(seq)
    assert white.dtype == torch.float32
    np.testing.assert_array_equal(
        white.numpy().view(np.int32),
        np.asarray(jn.white_from_bits(jnp.asarray(ref))).view(np.int32))


def test_mul_u32_at_the_wrap():
    """(x·a) mod 2³² against Python's exact integers, at the edges."""
    edge = [0, 1, 0xFFFF, 0x10000, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    xs = _carrier(np.array(edge * len(edge), np.uint32))
    as_ = _carrier(np.repeat(np.array(edge, np.uint32), len(edge)))
    got = tn.mul_u32(xs, as_).tolist()
    want = [(int(x) * int(a)) & 0xFFFFFFFF for x, a in
            zip(xs.tolist(), as_.tolist())]
    assert got == want
    for a in edge:
        assert tn.mul_u32(xs, a).tolist() == \
            [(int(x) * a) & 0xFFFFFFFF for x in xs.tolist()]


def test_two_state_scheme_equals_lcg_advance():
    """The kernel's per-channel states: channel 0 stepped N times lands on
    channel 1's start, channel 1 stepped N times on lcg_advance(rng, 2N)."""
    n = 512
    r0 = _carrier(SEEDS)
    r1 = tn.lcg_advance(r0, n)
    seq = tn.lcg_sequence(r0, 2 * n)
    for t in range(n):
        r0, r1 = tn.lcg_step(r0), tn.lcg_step(r1)
        assert torch.equal(r0, seq[..., t]) and torch.equal(r1, seq[..., n + t])
    assert torch.equal(r1, tn.lcg_advance(_carrier(SEEDS), 2 * n))
    bits = tn.u32_to_i32_bits(r1)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  r1.numpy().astype(np.uint32))
    assert torch.equal(tn.i32_bits_to_u32(bits), r1)


def test_uint32_leaf_round_trip():
    tree = {"rng": SEEDS, "x": np.arange(3, dtype=np.float32),
            "idx": np.array([1, 2], np.int32), "material": 3}
    ours = to_torch(tree, "cpu")
    assert ours["rng"].dtype == torch.int64 and ours["material"] == 3
    back = to_numpy(ours)
    assert back["rng"].dtype == np.uint32
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError):
        to_numpy({"rng": torch.tensor([-1, 2 ** 32])})
