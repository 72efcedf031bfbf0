"""The plain reference (benchmark/reference) against the port's plain
route on the CPU, at a tiny size: the reference follows the port bit for
bit in the audio, the comparison passes the port's outputs, and it fails
the reference with its audio and state held in bfloat16 (the control)."""

import json

import numpy as np
import pytest

from benchmark import compare, inputs
from benchmark.harness import ROOT
from benchmark.reference.chain import run_chain

CLIPS, BLOCKS = 6, 2
CASES = {"gel": ("chain_gel", None), "wood": ("chain_wood", None),
         "mixed": ("chain_gel", np.array([0, 1, 2, 3, 4, 2]))}


def _config(name):
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        return json.load(f)


def _traffic():
    with open(ROOT / "benchmark" / "traffic" / "corpus.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs():
    """{case: (config, clips, materials, port audio, port metrics)}."""
    import torch

    from juicy_tpu_torch.parallel.corpus import run_corpus_chain
    from juicy_tpu_torch.runtime.plugin import Chain

    out = {}
    for case, (name, mats) in CASES.items():
        config = _config(name)
        n = config["block_size"]
        x = inputs.signal(_traffic()["signal"], CLIPS, 2, BLOCKS * n,
                          float(config["sample_rate"]), "cpu", 1234)
        chain = Chain([(s, dict(p)) for s, p in config["stages"]],
                      float(config["sample_rate"]), 2, n)
        audio, ms, _agg = run_corpus_chain(
            chain, x, materials=None if mats is None else torch.tensor(mats),
            device="cpu")
        out[case] = (config, x.numpy(), mats, audio.numpy(),
                     [{k: v.numpy() for k, v in m.items()} for m in ms])
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_port_plain_route(runs, case):
    config, x, mats, audio, ms = runs[case]
    ref_audio, ref_ms = run_chain(config, x, mats)
    assert np.array_equal(ref_audio, audio)
    for m, r in zip(ms, ref_ms, strict=True):
        assert sorted(r) == sorted(m)
        for key in r:
            # the score formulas round alike; PyTorch's vector kernels may
            # differ from NumPy's in the last place
            assert np.all(np.abs(m[key] - r[key])
                          <= 1e-6 * np.maximum(1.0, np.abs(r[key]))), key


@pytest.mark.parametrize("case", sorted(CASES))
def test_comparison_passes_port_outputs(runs, case):
    config, x, mats, audio, ms = runs[case]
    ref_audio, ref_ms = run_chain(config, x, mats)
    table, ok = compare.checks(compare.readings(audio, ms, ref_audio, ref_ms))
    assert ok, table


@pytest.mark.parametrize("case", sorted(CASES))
def test_comparison_fails_bfloat16(runs, case):
    config, x, mats, _audio, _ms = runs[case]
    ref_audio, ref_ms = run_chain(config, x, mats)
    low_audio, low_ms = run_chain(config, x, mats, precision="bfloat16")
    for audio in (np.asarray(low_audio), None):      # with and without audio
        got = compare.readings(
            audio, [{k: np.asarray(v) for k, v in m.items()} for m in low_ms],
            ref_audio, ref_ms)
        table, ok = compare.checks(got)
        assert not ok, table
        assert got["metric_err"] > compare.LIMITS["metric_err"]
