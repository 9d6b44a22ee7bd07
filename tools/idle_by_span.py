#!/usr/bin/env python3
"""Where a benchmark cell's device time and idle time fall, span by span
of the program (``repro_torch.obs``), on the profiler's clock.

    python3 tools/idle_by_span.py [--workload zamba2_prefill] [--seed 1]
        [--seconds 10] [--cost 2] [--out chiprun_out/idle_by_span.json]

Run from a checkout of the repository, on a card. It sets the cell up and
runs its window under ``torch.profiler`` as ``bench/harness.run_cell``
does (the benchmark's spans ``prefill`` and ``sample`` around each
batch), then:

  * gives each device operation to the innermost host span (the
    benchmark's or the program's) open when the host launched it: the
    runtime call with the operation's correlation id;
  * gives each idle gap of the window (``bench/trace.from_events``'s busy
    time, gaps and window edges) to the innermost host span open when the
    gap began;
  * prints, per span name, its busy and idle seconds (self: where it is
    the innermost span; inclusive: its children's too) beside the sum of
    the device intervals ``obs`` recorded for it (timing events on the
    stream) and of its host times, and for each layer span
    (``mamba2.layer``, ``shared.block``, ``moe.layer``, ``attn.layer``)
    how far busy plus idle lies from that interval;
  * prints the coverage of the root span ``serve.prefill_step`` (its
    intervals over the device time inside ``prefill``), the root's self
    share, where the window's ten largest operation names fall, and the
    idle by innermost span and the operation that ended the gap.

``--cost N`` then times N windows each with the spans off and with
``obs.enable()`` (no profiler), and N each under the profiler with the
spans on and forced off, in turns: what the spans cost. It writes the
whole table as JSON to ``--out`` and prints the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

BENCH_SPANS = ("prefill", "sample")
CHECKED = ("mamba2.layer", "shared.block", "moe.layer", "attn.layer")
ROOT_SPAN = "serve.prefill_step"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def _on_device(e) -> bool:
    return str(e.device_type()).split(".")[-1] == "CUDA"


def open_paths(spans, times):
    """``spans``: properly nested host intervals [(a, b, name)];
    ``times``: query instants. The names of the spans open at each
    instant, outermost first (a tuple a query)."""
    marks = [(a, 0, i) for i, (a, _, _) in enumerate(spans)]
    marks += [(b, 2, i) for i, (_, b, _) in enumerate(spans)]
    marks += [(t, 1, q) for q, t in enumerate(times)]
    marks.sort()
    stack, out = [], [()] * len(times)
    for _, kind, i in marks:
        if kind == 0:
            stack.append(i)
        elif kind == 2:
            del stack[len(stack) - 1 - stack[::-1].index(i)]
        else:
            out[i] = tuple(spans[j][2] for j in stack)
    return out


def attribute(evs, names, window):
    """From the profiler's raw events: per span name, busy and idle
    seconds (self and inclusive), the operations' seconds by innermost
    span and name, and the window's totals."""
    from bench.trace import from_events
    tr = from_events(evs, window, BENCH_SPANS)
    if tr is None:
        raise SystemExit("the trace holds no operation on the device")
    w0 = next(e.start_ns() for e in evs
              if e.name() == window and not _on_device(e))
    host, launch, by_corr = [], {}, {}
    for e in evs:
        if _on_device(e):
            continue
        if e.name() in names:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                         e.name()))
        elif e.name().startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
        else:
            by_corr[e.correlation_id()] = e.start_ns()
    host.sort(key=lambda h: (h[0], -h[1]))
    ops, when, linked = [], [], defaultdict(int)
    w1 = w0 + round(tr.window_s * 1e9)
    for e in evs:
        if not _on_device(e) or e.name() in BENCH_SPANS or \
                e.name() == window:
            continue
        a = max(e.start_ns(), w0)
        b = min(e.start_ns() + e.duration_ns(), w1)
        if b <= a:
            continue
        t = launch.get(e.correlation_id())
        how = "runtime"
        if t is None:
            t, how = by_corr.get(e.linked_correlation_id()), "op"
        if t is None:
            t, how = a, "start"
        linked[how] += 1
        ops.append((e.name()[:120], (b - a) / 1e9))
        when.append(t)
    gaps, edge = [], 0.0
    for name, s, d in sorted(tr.ops, key=lambda o: o[1]):
        if s > edge:
            gaps.append((edge, s - edge, name[:60]))
        edge = max(edge, s + d)
    if tr.window_s > edge:
        gaps.append((edge, tr.window_s - edge, "window_end"))
    paths = open_paths(host, when + [w0 + round(g[0] * 1e9) for g in gaps])
    row = defaultdict(lambda: {"busy_self": 0.0, "idle_self": 0.0,
                               "busy": 0.0, "idle": 0.0})
    by_op = defaultdict(lambda: defaultdict(float))
    for (name, d), path in zip(ops, paths):
        inner = path[-1] if path else "outside_spans"
        row[inner]["busy_self"] += d
        by_op[name][inner] += d
        for n in set(path):
            row[n]["busy"] += d
    waits = defaultdict(float)
    for (_, d, nxt), path in zip(gaps, paths[len(ops):]):
        inner = path[-1] if path else "outside_spans"
        row[inner]["idle_self"] += d
        waits[f"{inner} | {nxt}"] += d
        for n in set(path):
            row[n]["idle"] += d
    return {"window_s": tr.window_s, "busy_s": tr.busy_s,
            "gaps_s": sum(d for _, d in tr.gaps),
            "ops_s": sum(d for _, d in ops), "my_gaps_s":
            sum(g[1] for g in gaps), "linked": dict(linked),
            "waits": dict(waits),
            "rows": {k: dict(v) for k, v in row.items()},
            "top_ops": tr.top_ops(10),
            "by_op": {k: dict(v) for k, v in by_op.items()}}


def intervals(recs):
    """Per span name: count, the sum of its device intervals, of its self
    times and of its host times (seconds)."""
    from repro_torch import obs
    out = defaultdict(lambda: {"n": 0, "interval": 0.0, "self": 0.0,
                               "host": 0.0})
    for r, s in zip(recs, obs.self_us(recs)):
        o = out[r.name]
        o["n"] += 1
        o["interval"] += (r.device_us or 0.0) / 1e6
        o["self"] += (s or 0.0) / 1e6
        o["host"] += (r.t1_ns - r.t0_ns) / 1e9
    return {k: dict(v) for k, v in out.items()}


def window_run(driver, state, seconds, device, profile):
    """One window as the harness runs it; (items, seconds, profiler)."""
    import torch
    from bench.harness import WINDOW, Spans, _sync
    prof = None
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    with torch.profiler.record_function(WINDOW) if profile \
            else contextlib.nullcontext():
        t0 = time.perf_counter()
        items = driver.window(state, seconds, Spans(profile))
        _sync(device)
        secs = time.perf_counter() - t0
    if profile:
        prof.stop()
    return items, secs, prof


def cost(driver, state, seconds, device, n):
    """Prompt tokens a second with the spans off and on, without and
    under the profiler, in turns."""
    from repro_torch import obs
    real = obs._profiling
    rates = defaultdict(list)

    def rate(tag, profile, on):
        if profile and not on:
            obs._profiling = lambda: False
        elif on and not profile:
            obs.enable()
        try:
            items, secs, prof = window_run(driver, state, seconds, device,
                                           profile)
        finally:
            obs._profiling = real
            obs.disable()
        del prof
        obs.take()
        rates[tag].append(sum(it["prompt_tokens"] for it in items) / secs)
        print(f"cost: {tag} {rates[tag][-1]:.1f} prompt tokens/s",
              flush=True)
    for k in range(n):
        order = [("off", False, False), ("enabled", False, True)]
        order += [("profiler", True, True), ("profiler_no_spans", True,
                                             False)]
        for tag, profile, on in (order if k % 2 == 0 else order[::-1]):
            rate(tag, profile, on)
    return dict(rates)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="zamba2_prefill")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cost", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "idle_by_span.json"))
    args = ap.parse_args()
    from bench import harness
    from bench.harness import WINDOW
    from repro_torch import obs
    print(f"card: {card()}", flush=True)
    spec = harness.benchmark_spec()
    w = [x for x in spec["workloads"] if x["name"] == args.workload][0]
    config, traffic, _, driver = harness.cell_files(w)
    state = driver.setup(config, traffic, args.seed, args.device)
    harness._sync(args.device)
    obs.take()
    items, secs, prof = window_run(driver, state, args.seconds,
                                   args.device, True)
    recs = obs.take()
    names = set(BENCH_SPANS) | {r.name for r in recs}
    evs = prof.profiler.kineto_results.events()
    mirrored = sorted({e.name() for e in evs if _on_device(e)
                       and e.name() in names - set(BENCH_SPANS)})
    res = attribute(evs, names, WINDOW)
    del prof, evs
    res["intervals"] = intervals(recs)
    res["mirrored"] = mirrored
    res["tokens"] = sum(it["prompt_tokens"] for it in items)
    res["card"] = card()
    rows, iv = res["rows"], res["intervals"]
    print(f"window {res['window_s']:.4f} s, busy {res['busy_s']:.4f} s "
          f"(ops attributed {res['ops_s']:.4f} s), gaps "
          f"{res['gaps_s']:.4f} s (recomputed {res['my_gaps_s']:.4f} s); "
          f"{res['tokens']} prompt tokens; operations linked by "
          f"{res['linked']}; program span names on the device: "
          f"{mirrored or 'none'}")
    print(f"{'span':<22}{'n':>6}{'busy self':>11}{'idle self':>11}"
          f"{'busy':>10}{'idle':>10}{'interval':>10}{'self':>10}"
          f"{'host':>10}{'(b+i)/iv':>10}")
    for name in sorted(set(rows) | set(iv)):
        r = rows.get(name, {"busy_self": 0, "idle_self": 0, "busy": 0,
                            "idle": 0})
        v = iv.get(name, {"n": 0, "interval": 0.0, "self": 0.0,
                          "host": 0.0})
        ratio = (r["busy"] + r["idle"]) / v["interval"] \
            if v["interval"] else float("nan")
        print(f"{name:<22}{v['n']:>6}{r['busy_self']:>11.4f}"
              f"{r['idle_self']:>11.4f}{r['busy']:>10.4f}{r['idle']:>10.4f}"
              f"{v['interval']:>10.4f}{v['self']:>10.4f}{v['host']:>10.4f}"
              f"{ratio:>10.4f}")
    for name in CHECKED:
        if name in rows and iv.get(name, {}).get("interval"):
            off = (rows[name]["busy"] + rows[name]["idle"]) \
                / iv[name]["interval"] - 1
            print(f"{name}: busy + idle {100 * off:+.2f} % of the interval "
                  f"({'within' if abs(off) <= 0.05 else 'outside'} 5 %)")
    if iv.get(ROOT_SPAN, {}).get("interval") and "prefill" in rows:
        pre = rows["prefill"]["busy"] + rows["prefill"]["idle"]
        print(f"coverage: {ROOT_SPAN} intervals {iv[ROOT_SPAN]['interval']:.4f}"
              f" s over prefill's busy + idle {pre:.4f} s = "
              f"{100 * iv[ROOT_SPAN]['interval'] / pre:.2f} %; root self "
              f"{100 * iv[ROOT_SPAN]['self'] / iv[ROOT_SPAN]['interval']:.2f}"
              f" % of its intervals")
    print("top operations by innermost span (s):")
    for name, secs_ in res["top_ops"]:
        split = sorted(res["by_op"].get(name, {}).items(),
                       key=lambda kv: -kv[1])
        print(f"  {secs_:.4f} {name[:70]}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in split[:4]))
    print("idle by innermost span | the operation the card waited for (s):")
    for k, v in sorted(res["waits"].items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {v:.4f} {k}")
    if args.cost:
        res["cost"] = cost(driver, state, args.seconds, args.device,
                           args.cost)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
