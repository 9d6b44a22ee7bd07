"""Device µs a prompt token in the 38 Mamba-2 mixers: the ``mamba2.layer``
spans' intervals (the program's timing events, pre-norm to residual add;
under the profiler they include the card's waits for the host inside
them), over the window's prompt tokens."""
from bench.program_spans import us_per_token


def read(run):
    return us_per_token(run, "mamba2.layer")
