"""Readings that set a cell's limits: for each seed, a short window at the
cell's own load (long enough to finish the mix's longest requests and to
compare as many as a run does), then the numbers the run's check compares,
for the program and, with ``--control``, for the control (the plain
reference in float8 e4m3 in the program's place). One process, so set-up
that every seed shares (the CUDA context, the kernels' build) is paid once.
The benchmark's own runs never run the control.

    python3 bench/control.py --workload zamba2_prefill --seeds 1 2 3 --control 1

One JSON line a seed on standard output.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402
from bench.reference.plain import FP8  # noqa: E402


def readings(workload: dict, seed: int, seconds: float, control: bool,
             device: str = "cuda", config_over=None, traffic_over=None):
    """{"program": {name: value}, "control": {name: value}} for one seed."""
    import torch
    config, traffic, limits, driver = harness.cell_files(
        workload, config_over, traffic_over)
    st = driver.setup(config, traffic, seed, device)
    items = driver.window(st, seconds, harness.Spans(False))
    out = {"seed": seed, "program": {}, "control": {}}
    t0 = time.perf_counter()
    for n, v, _ in driver.check(st, items, seed, limits):
        out["program"][n] = v
    out["check_s"] = time.perf_counter() - t0
    if control:
        t0 = time.perf_counter()
        for n, v, _ in driver.check(st, items, seed, limits, FP8):
            out["control"][n] = v
        out["control_s"] = time.perf_counter() - t0
    del st, items
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def main(argv):
    ap = argparse.ArgumentParser(prog="bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", type=int, default=0,
                    help="also read the control for the first N seeds")
    args = ap.parse_args(argv)
    spec = harness.benchmark_spec()
    workload = [w for w in spec["workloads"]
                if w["name"] == args.workload][0]
    for i, seed in enumerate(args.seeds):
        print(json.dumps(readings(workload, seed, args.seconds,
                                  i < args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
