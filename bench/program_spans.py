"""Per-layer metrics from the program's own spans (``repro_torch.obs``):
device microseconds a prompt token of the traced window, from the timing
events each span records on the card's stream. The profiler's raw events
are gone by the time a metric is read; the spans are the program's, taken
once a run (:func:`spans`) and shared by every reader. A program without
``obs``, or a run whose spans hold no device interval (on the CPU), reads
nothing."""
from __future__ import annotations

from typing import Optional

_KEY = "program_spans"


def spans(run):
    """The program's spans recorded in ``run``'s window (``obs.take()``,
    taken at the first call and kept on the run), or None."""
    if _KEY not in vars(run):
        try:
            from repro_torch import obs
        except ImportError:
            vars(run)[_KEY] = None
        else:
            vars(run)[_KEY] = obs.take()
    return vars(run)[_KEY]


def us_per_token(run, name: str, self_time: bool = False
                 ) -> Optional[float]:
    """The device µs of the window's spans called ``name`` (their
    intervals, or with ``self_time`` their intervals less their
    children's) over the prompt tokens of the window's items; None when no
    such span has a device interval."""
    recs = spans(run)
    if not recs:
        return None
    from repro_torch import obs
    us = obs.self_us(recs) if self_time else [r.device_us for r in recs]
    vals = [v for r, v in zip(recs, us) if r.name == name and v is not None]
    tokens = sum(it["prompt_tokens"] for it in run.items)
    if not vals or tokens <= 0:
        return None
    return sum(vals) / tokens
