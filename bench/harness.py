"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics and the result's line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
(config, traffic, chips), ``bench/configs/<config>.json`` (the sizes as
run), ``bench/traffic/<traffic>.json`` (the mix, and the driver that sends
it), ``bench/drivers/<driver>.py`` (set-up, window, check),
``bench/cells/<cell>.json`` (the limits of the check) and, for every metric
the cell reports, ``bench/metrics/<metric>.py`` (``read(run)``: a number,
or None when it finds nothing to read).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

from . import trace as trace_mod

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
WINDOW = "bench_window"
# top-level module names the measured process must not hold (compared
# whole: the port's own name, repro_torch, begins with repro)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module."""
    mod_name = f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(
        mod_name, BENCH / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_metrics(spec: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """(end-to-end, per-layer) metric entries the cell reports: an
    end-to-end one unless its ``workloads`` leave the cell out, a per-layer
    one where its ``workloads`` list the cell."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    per = [m for m in spec["per_layer"] if cell in m["workloads"]]
    return e2e, per


def cell_files(workload: dict, config_over: dict = None,
               traffic_over: dict = None):
    """(configuration, traffic mix, the cell's limits, the driver module) of
    a ``BENCHMARK.json`` workload entry; ``config_over`` and
    ``traffic_over`` replace keys of the first two (the tests' small
    sizes)."""
    config = {**load_json(BENCH / "configs" / f"{workload['config']}.json"),
              **(config_over or {})}
    traffic = {**load_json(BENCH / "traffic" /
                           f"{workload['traffic']}.json"),
               **(traffic_over or {})}
    limits = load_json(BENCH / "cells" / f"{workload['name']}.json")["check"]
    return config, traffic, limits, load_module("drivers", traffic["driver"])


def seed_of(seed: int, *tag: int) -> int:
    """A 63-bit seed for one stream (weights, inputs, sampling) of a run,
    from the run's seed: any whole number, negative ones too."""
    import numpy as np
    ss = np.random.SeedSequence([seed % (1 << 63), *tag])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


class Spans:
    """The benchmark's own host spans: (name, start, end) on the host
    clock, and with ``trace`` a profiler annotation of the same name."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.done: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch
        ann = torch.profiler.record_function(name) if self.trace \
            else contextlib.nullcontext()
        with ann:
            t0 = time.perf_counter()
            yield
            t1 = time.perf_counter()
        self.done.append((name, t0, t1))

    def seconds(self, name: str) -> Tuple[float, int]:
        d = [b - a for n, a, b in self.done if n == name]
        return sum(d), len(d)


class Laps(dict):
    """Seconds of each named phase of a set-up, in order; each lap waits
    for the device's work first."""

    def __init__(self, device: str):
        super().__init__()
        self.device = device
        self.t = time.perf_counter()

    def __call__(self, name: str):
        _sync(self.device)
        now = time.perf_counter()
        self[name], self.t = now - self.t, now


@dataclasses.dataclass
class Run:
    """What a metric reader sees of one run."""
    cell: str
    config: dict
    traffic: dict
    setup_s: float
    window_s: float                    # host clock, first start to last end
    items: List[dict]                  # one a completed batch
    spans: Spans
    trace: Optional[object] = None     # bench.trace.Trace, --trace 1


def _device(device: str):
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def _sync(device: str):
    import torch
    if device != "cpu":
        torch.cuda.synchronize()


def run_cell(workload: dict, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", spec: dict = None,
             config_over: dict = None, traffic_over: dict = None,
             limits: dict = None) -> dict:
    """One run; returns the result's object (the last line's keys) with its
    checks under ``checks``. ``config_over`` and ``traffic_over`` as for
    :func:`cell_files`, ``limits`` in place of the cell's (the tests' small
    sizes, whose readings differ from the cell's)."""
    import torch
    spec = spec or benchmark_spec()
    name = workload["name"]
    config, traffic, cell_limits, driver = cell_files(
        workload, config_over, traffic_over)
    e2e, per = cell_metrics(spec, name)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    t_setup = time.perf_counter()
    state = driver.setup(config, traffic, seed, device)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    print(f"setup: {t_setup - t_start:.3f} s to the driver, then "
          + ", ".join(f"{k} {v:.3f} s" for k, v in state.phases.items()),
          file=sys.stderr)

    spans = Spans(trace)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    with torch.profiler.record_function(WINDOW) if trace \
            else contextlib.nullcontext():
        t0 = time.perf_counter()
        items = driver.window(state, seconds, spans)
        _sync(device)
        window_s = time.perf_counter() - t0
    if trace:
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    t_check = time.perf_counter()
    checks = driver.check(state, items, seed, limits or cell_limits)
    del state
    check_s = time.perf_counter() - t_check

    run = Run(name, config, traffic, setup_s, window_s, items, spans)
    t_trace = time.perf_counter()
    if trace:
        run.trace = trace_mod.summarize(prof, WINDOW,
                                        {n for n, _, _ in spans.done})
        del prof
        if run.trace is None:
            print("the trace holds no operation on the device",
                  file=sys.stderr)
    metrics = {}
    for m in (per if trace else e2e):
        v = load_module("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {**_device(device), "memory_peak_bytes": int(peak)}
    out = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": sum(i.get("requests", 1) for i in items),
           "failed": 0, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.top_gaps()}
    out["seconds"] = {"setup": setup_s, "window": window_s,
                      "check": check_s,
                      "trace": time.perf_counter() - t_trace}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv: List[str], t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = benchmark_spec()
    found = [w for w in spec["workloads"] if w["name"] == args.workload]
    if not found:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    chips = found[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(found[0], args.seed, args.seconds, bool(args.trace),
                   t_start, spec=spec)
    bad = forbidden_modules()
    if bad:
        print(f"the measured process holds {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for n, c in out["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
