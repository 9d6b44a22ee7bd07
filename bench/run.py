"""Run one cell of the port's benchmark (``BENCHMARK.json``) on this
machine's card, from the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It loads, warms up, measures for about ``--seconds`` seconds, checks what
the timed path produced against the plain reference, and prints one JSON
line as its last line of standard output (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics, read from a
profiler trace of the window). Without a CUDA device it exits 3 and prints
no result.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths: the
# port's nvcc libraries go to build/repro_torch/ (kernels/_build.py)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench" /
                                         "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
