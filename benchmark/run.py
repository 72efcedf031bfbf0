"""Run one cell of the benchmark of juicy_tpu_torch once, on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, metrics and bounds are in BENCHMARK.json at the root of the
checkout; the harness is benchmark/harness.py. The last line of standard
output is the run's result as one JSON object. Without enough CUDA
devices the run prints no result and exits with 2.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Python's compiled modules, torch's among them, are kept inside the
# checkout at a fixed path, so that only a checkout's first run compiles
# them, also where the environment turns the writing of bytecode off.
sys.pycache_prefix = str(ROOT / ".bench_cache" / "pycache")
sys.dont_write_bytecode = False
sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
