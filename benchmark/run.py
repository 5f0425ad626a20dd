"""The benchmark's command (see README.md):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Prints one JSON line last on standard
output, and the numbers that decided ``correct`` last on standard error.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this directory, so the package is "benchmark"
sys.path[0] = ROOT
# every cache of the run inside the checkout, at fixed paths
_CACHE = os.path.join(ROOT, "benchmark", "out", "cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
