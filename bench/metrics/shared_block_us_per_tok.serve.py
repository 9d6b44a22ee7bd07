"""Device µs a prompt token in the hybrid's shared attention and SwiGLU
block (K4 twice, K5, four GEMMs): the ``shared.block`` spans' intervals,
over the window's prompt tokens."""
from bench.program_spans import us_per_token


def read(run):
    return us_per_token(run, "shared.block")
