"""The benchmark of gcslam_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program (gcslam_torch) on a
machine with a CUDA card; without one it exits with code 2 and prints no
result. See benchmark/harness.py."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")
# build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
# the checkout's root, not this script's directory, heads the module path
# (benchmark/trace.py would otherwise shadow the standard library's trace)
sys.path[0] = ROOT

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
