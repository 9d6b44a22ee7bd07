"""The whole prefill step's share of the bf16 peak over the traced window:
the frozen count of every request completed, at its own prompt length
(``bench/counts/flops.hybrid_prefill``; pads are not counted)."""
from bench.trace import step_mfu


def read(run):
    return step_mfu(run)
