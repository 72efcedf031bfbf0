"""The import guard: a run loads neither JAX nor the JAX package (the
top-level module name before the first dot compared whole, since the
port's name begins with the JAX package's), and the plain reference
imports nothing of the port."""

import ast
import json
import subprocess
import sys

import pytest

from benchmark.harness import BENCH_DIR, FORBIDDEN, ROOT

DRIVE = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
cell = harness.resolve(harness.load_spec(), {cell!r})
cell["traffic"] = harness.driver(cell["driver"]).tiny(cell["traffic"])
res = harness.run_cell(cell, 2**31 + 3, 0.01, False, [{device!r}],
                       time.perf_counter())
print(json.dumps({{"loaded": harness.forbidden_modules(),
                   "correct": harness.result_line(cell, res)["correct"]}}))
"""


def _drive(device):
    proc = subprocess.run(
        [sys.executable, "-c", DRIVE.format(root=str(ROOT),
                                            cell="chain_gel.corpus",
                                            device=device)],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    got = _drive("cpu")
    assert got == {"loaded": [], "correct": True}


@pytest.mark.cuda
def test_a_run_on_the_card_loads_no_jax(card):
    got = _drive(card)
    assert got == {"loaded": [], "correct": True}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    files = sorted((BENCH_DIR / "reference").glob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("numpy", "math", "__future__", "benchmark"), \
                (path.name, name)
            if top == "benchmark":
                assert name.startswith("benchmark.reference"), \
                    (path.name, name)


def test_benchmark_imports_no_jax_and_no_repo_scripts():
    for path in sorted(BENCH_DIR.rglob("*.py")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, (path, name)
            assert top not in ("bench", "chip_smoke", "tools"), (path, name)
