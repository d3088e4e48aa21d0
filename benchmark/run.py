#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the card, for one seed:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON; the numbers that decided `correct` are the last lines of
standard error. Exits non-zero without a card, or when the run loaded JAX
or the JAX package. Build caches stay inside the checkout (`build/`)."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the harness is imported as the package `benchmark`, never by its files' bare names
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
os.environ["USE_FLAX"] = "0"
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path.insert(0, str(ROOT))

from benchmark import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t_start=T_START))
