"""Device µs a prompt token in the MoE sublayers (every layer's post-norm,
router, sort, the routed experts' grouped GEMMs, the combine, the shared
expert and the residual add): the ``moe.layer`` spans' intervals over the
window's prompt tokens."""
from bench.program_spans import us_per_token


def read(run):
    return us_per_token(run, "moe.layer")
