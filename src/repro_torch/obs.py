"""The port's spans and counters, in one place.

Spans. ``with span("mamba2.layer", x):`` marks a layer boundary. It is
off, and costs one check, unless a ``torch.profiler`` session is running
(``torch._C._autograd._profiler_enabled()``) or :func:`enable` has been
called; off, it returns one shared object that does nothing. On, it
records the span's name, its parent, the step (the id of its root span,
shared by every span under that root), the host's ``perf_counter_ns`` at
entry and exit, and, when ``x`` is a CUDA tensor, a timing event recorded
on ``x``'s device's current stream at entry and at exit; it also opens a
record function of the same name that the profiler keeps on its host
timeline but does not mirror onto the device's (not a user scope), so a
trace puts the span beside the kernels it launched without the span
counting as device work. :func:`take` hands the recorded spans over, with
each span's device interval in microseconds (the time between its two
events on the stream: its kernels and any wait for the host inside it).

Span names are "<layer>.<part>" (``serve.prefill_step``, ``mamba2.layer``,
``mamba2.in_proj``, ``mamba2.scan``, ``mamba2.out_proj``,
``shared.block``), never a bare word: the benchmark's own host spans are
bare words.

Counters. :data:`COUNTS` is one registry of named counts; each kernel
package's ``LAUNCHES`` is a :class:`Counters` view of its own keys in it
(``launches.<wrapper>``), read as the package's old dict was, and its
``reset_launches`` resets those keys.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections.abc import Mapping
from typing import Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

_profiling = torch._C._autograd._profiler_enabled
_EventBase = getattr(torch._C, "_CudaEventBase", None)

# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

COUNTS: Dict[str, int] = {}


class Counters(Mapping):
    """The keys ``names`` of :data:`COUNTS` under ``prefix + "."``, read by
    their short names (``view["rmsnorm"]`` is ``COUNTS["launches.rmsnorm"]``
    for ``Counters("launches", "rmsnorm")``)."""

    def __init__(self, prefix: str, *names: str):
        self._keys = {n: f"{prefix}.{n}" for n in names}
        for k in self._keys.values():
            COUNTS.setdefault(k, 0)

    def __getitem__(self, name: str) -> int:
        return COUNTS[self._keys[name]]

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def add(self, name: str, n: int = 1):
        COUNTS[self._keys[name]] += n

    def reset(self):
        for k in self._keys.values():
            COUNTS[k] = 0


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpanRecord:
    """One finished span. ``parent``: the index of its parent in the list
    :func:`take` returns (None for a root); ``step``: its root's id;
    ``device_us``: the device interval, None where no CUDA tensor was
    given."""
    name: str
    parent: Optional[int]
    step: int
    t0_ns: int
    t1_ns: int
    device_us: Optional[float] = None


class _Off:
    """The span that records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    def __init__(self):
        self.forced = False
        self.entries: List[list] = []     # [name, parent, step, t0, t1]
        self.events: List[tuple] = []     # (entry index, start, end event)
        self.free: Dict[int, list] = {}   # device index -> idle events
        self.streams: Dict[int, object] = {}   # device index -> last stream
        self.steps = itertools.count(1)
        self.local = threading.local()    # .stack: open (index, step)
        self.lock = threading.Lock()

    def stream(self, device: int):
        """The device's current stream, as an object made once a stream."""
        raw = torch._C._cuda_getCurrentRawStream(device)
        st = self.streams.get(device)
        if st is None or st.cuda_stream != raw:
            st = self.streams[device] = torch.cuda.current_stream(device)
        return st

    def event(self, device: int, stream):
        try:
            ev = self.free[device].pop()
        except (KeyError, IndexError):
            ev = torch.cuda.Event(enable_timing=True)
        _EventBase.record(ev, stream)     # the device guard is the C++ one
        return ev


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "x", "i", "entry", "rf", "ev0", "dev", "stream")

    def __init__(self, name: str, x):
        self.name, self.x = name, x

    def __enter__(self):
        rec = _REC
        stack = getattr(rec.local, "stack", None)
        if stack is None:
            stack = rec.local.stack = []
        parent, step = stack[-1] if stack else (None, next(rec.steps))
        entry = self.entry = [self.name, parent, step, 0, 0]
        with rec.lock:
            self.i = len(rec.entries)
            rec.entries.append(entry)
        stack.append((self.i, step))
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.ev0 = None
        x = self.x
        if isinstance(x, torch.Tensor) and x.is_cuda:
            self.dev = x.get_device()
            self.stream = rec.stream(self.dev)
            self.ev0 = rec.event(self.dev, self.stream)
        entry[3] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = _REC
        self.entry[4] = time.perf_counter_ns()
        if self.ev0 is not None:
            ev1 = rec.event(self.dev, self.stream)
            with rec.lock:
                rec.events.append((self.i, self.ev0, ev1))
        self.rf.__exit__(*exc)
        rec.local.stack.pop()
        return False


def enabled() -> bool:
    """Whether spans record now."""
    return _REC.forced or _profiling()


def enable():
    """Record spans from now on, with or without a profiler running."""
    _REC.forced = True


def disable():
    """Undo :func:`enable` (spans still record under a profiler)."""
    _REC.forced = False


def span(name: str, x: Optional[torch.Tensor] = None):
    """A context manager marking one span (the module docstring); ``x``:
    a tensor on the device the span's work runs on."""
    if not (_REC.forced or _profiling()):
        return _OFF
    return _Span(name, x)


def take() -> List[SpanRecord]:
    """The spans recorded since the last call, in the order they were
    entered, each with its device interval; clears them. Call it outside
    any span, after the device's work in them is done: it waits for each
    span's end event (no wait once the caller has synchronized)."""
    with _REC.lock:
        entries, events = _REC.entries, _REC.events
        _REC.entries, _REC.events = [], []
    records = [SpanRecord(*e) for e in entries]
    for i, ev0, ev1 in events:
        ev1.synchronize()
        records[i].device_us = 1e3 * ev0.elapsed_time(ev1)
        _REC.free.setdefault(ev0.device.index, []).extend((ev0, ev1))
    return records


def self_us(records: List[SpanRecord]) -> List[Optional[float]]:
    """Each span's device interval less the part its children cover
    (children run one after another on the span's stream); None where the
    span has no interval."""
    out = [r.device_us for r in records]
    for r in records:
        if r.parent is not None and out[r.parent] is not None \
                and r.device_us is not None:
            out[r.parent] -= r.device_us
    return out
