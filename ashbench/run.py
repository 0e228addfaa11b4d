#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 ashbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The kernels build with nvcc on a
checkout's first run, into ``build/`` inside the checkout; every other
cache the run may fill is kept there too.  The run exits non-zero and
prints no result without a CUDA card, or without the system under test
(``src/repro_torch``).
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "ashbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

if __name__ == "__main__":
    from ashbench import harness

    sys.exit(harness.main(t_start=T_START))
