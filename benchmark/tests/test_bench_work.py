"""The frozen work counts reproduce the bounds that the port's kernel
table records: 0.0901 ms (operations) for one block of the chain at
B = 8192 on gel, and 0.0928 ms for five materials mixed at 8192."""

import json

import numpy as np

from benchmark import work
from benchmark.harness import ROOT


def _config(name):
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_gel_block_bound_at_8192():
    ms, by = work.block_bound(_config("chain_gel"), {0: 8192})
    assert by == "operations"
    assert round(ms, 4) == 0.0901


def test_mixed_block_bound_at_8192():
    mats = np.arange(8192) % 5
    counts = {m: int(np.sum(mats == m)) for m in range(5)}
    ms, by = work.block_bound(_config("chain_gel"), counts)
    assert by == "operations"
    assert round(ms, 4) == 0.0928


def test_wood_counts_its_ring():
    gel = work.block_bound(_config("chain_wood"), {0: 8192})
    wood = work.block_bound(_config("chain_wood"), {2: 8192})
    haas, delays = work.delays(_config("chain_wood"))
    assert haas == 576 and 16.0 <= delays[2] <= 512.0
    nbytes = work.chain_work(8192, 2, 512, 2, delays[2], haas)[0]
    assert nbytes > work.chain_work(8192, 2, 512, 0, 0.0, haas)[0]
    assert wood[0] >= gel[0]
