"""The device's side of a traced window, from ``torch.profiler``'s raw
(kineto) events: which operations ran on the device and when, the time in
which any ran (busy), and the idle gaps, each labelled with the
benchmark's host span that was open when it began."""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]        # (name, start s, seconds)
    gaps: List[Tuple[str, float]]              # (host span, seconds)

    def op_seconds(self, names: Iterable[str]) -> Tuple[float, int]:
        """Device seconds and count of the operations whose name holds one
        of ``names`` as a whole word (a kernel's name as its source gives
        it, whatever template arguments or signature the trace adds)."""
        pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
            re.escape(n) for n in names) + r")(?![A-Za-z0-9_])")
        hits = [d for n, _, d in self.ops if pat.search(n)]
        return sum(hits), len(hits)

    def top_ops(self, k: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for n, _, d in self.ops:
            total[n[:120]] += d
        return [[n, s] for n, s in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def top_gaps(self, k: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for n, d in self.gaps:
            total[n] += d
        return [[n, s] for n, s in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:k]]


def kernel_names(csrc: Path) -> List[str]:
    """The ``__global__`` functions the CUDA sources in ``csrc`` define."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?([A-Za-z_]\w*)\s*\(")
    names = []
    for src in sorted(csrc.glob("*.cu")):
        names += pat.findall(src.read_text())
    return sorted(set(names))


def _on_device(e) -> bool:
    return str(e.device_type()).split(".")[-1] == "CUDA"


def summarize(prof, window: str, spans: Iterable[str]) -> Optional[Trace]:
    """The trace of ``prof`` (a stopped ``torch.profiler.profile``) over
    the host annotation ``window`` (a ``record_function`` around the
    measured window); ``spans``: the names of the benchmark's host spans,
    which label the idle gaps. None if the trace holds no operation on the
    device."""
    return from_events(prof.profiler.kineto_results.events(), window,
                       spans)


def from_events(evs, window: str, spans: Iterable[str]) -> Optional[Trace]:
    """:func:`summarize` of raw events (``name()``, ``device_type()``,
    ``start_ns()``, ``duration_ns()``). Operations on the device are the
    events on a CUDA device (kernels, copies, sets) but for the
    annotations the profiler mirrors there, which carry the host's
    names."""
    spans = set(spans)
    ours = spans | {window}
    w0 = w1 = None
    ops, host = [], []
    for e in evs:
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        if _on_device(e):
            if name not in ours:
                ops.append((a, b, name))
        elif name == window:
            w0, w1 = a, b
        elif name in spans:
            host.append((a, b, name))
    if w0 is None or not ops:
        return None
    ops.sort()
    host.sort()
    busy, gaps = 0, []
    cur0 = cur1 = None
    edge = w0
    for a, b, _ in ops:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if cur1 is None or a > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            if a > edge:
                gaps.append((edge, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
        edge = max(edge, cur1)
    if cur1 is not None:
        busy += cur1 - cur0
    if w1 > edge:
        gaps.append((edge, w1))
    labelled, j = [], 0
    for g0, g1 in gaps:
        while j < len(host) and host[j][1] <= g0:
            j += 1
        name = "outside_spans"
        if j < len(host) and host[j][0] <= g0:
            name = host[j][2]
        labelled.append((name, (g1 - g0) / 1e9))
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                 ops=[(n, (a - w0) / 1e9, (b - a) / 1e9) for a, b, n in ops
                      if w0 <= a < w1],
                 gaps=labelled)


def kernel_roofline(run, kernel: str) -> Optional[float]:
    """% of its roofline that the port's kernel ``kernel`` (its package
    under ``repro_torch/kernels``) reached over the traced window: the sum
    of the bounds of its calls (the items' ``bound_s[kernel]``) over the
    device time of the ``__global__`` functions its CUDA sources define.
    None when the trace holds none of them."""
    import importlib
    if run.trace is None:
        return None
    pkg = importlib.import_module(f"repro_torch.kernels.{kernel}")
    names = kernel_names(Path(pkg.__file__).resolve().parent / "csrc")
    secs, n = run.trace.op_seconds(names)
    bound = sum(it["bound_s"].get(kernel, 0.0) for it in run.items)
    if n == 0 or secs <= 0 or bound <= 0:
        return None
    return 100.0 * bound / secs


def step_mfu(run) -> Optional[float]:
    """% of the bf16 tensor peak: the frozen count of the operations the
    traced window's completed work needs, over the traced window."""
    from .counts.peaks import BF16_FLOPS
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * sum(it["flops"] for it in run.items) / (
        run.trace.window_s * BF16_FLOPS)


def idle_share(run) -> Optional[float]:
    """% of the traced window in which no operation ran on the device."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
