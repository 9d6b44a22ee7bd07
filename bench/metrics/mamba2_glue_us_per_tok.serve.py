"""Device µs a prompt token in the Mamba-2 layers' glue: the
``mamba2.layer`` intervals less their ``mamba2.in_proj``, ``mamba2.scan``
(K6) and ``mamba2.out_proj`` children (norms, the causal conv, SiLU,
softplus, the scan's f32 inputs, the D skip, the gate, casts), over the
window's prompt tokens."""
from bench.program_spans import us_per_token


def read(run):
    return us_per_token(run, "mamba2.layer", self_time=True)
