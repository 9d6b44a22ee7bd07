"""Device µs a prompt token in the routed experts' products alone: the
``moe.experts`` spans' intervals (the two grouped GEMMs over each expert's
own rows and their SwiGLU) over the window's prompt tokens."""
from bench.program_spans import us_per_token


def read(run):
    return us_per_token(run, "moe.experts")
