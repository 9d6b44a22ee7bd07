"""Weights from a seed, made on the device: a tree of specs, as a
reference's ``param_specs`` gives it, drawn leaf by leaf (one large call
each) from a generator on that device, in the dtype they are served in.

Specs: ``("normal", shape, std)``, ``("ones", shape)``, ``("zeros",
shape)``, ``("log_linspace", shape, lo, hi)`` (log of ``shape[-1]`` points
from lo to hi, repeated over the leading dims).
"""
from __future__ import annotations

import torch


def draw(specs, gen: torch.Generator, dtype, device):
    if isinstance(specs, dict):
        return {k: draw(v, gen, dtype, device) for k, v in specs.items()}
    kind, shape = specs[0], tuple(specs[1])
    if kind == "normal":
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32).mul_(specs[2])
        return w.to(dtype)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "log_linspace":
        row = torch.log(torch.linspace(specs[2], specs[3], shape[-1],
                                       dtype=torch.float32, device=device))
        return row.expand(shape).to(dtype).contiguous()
    raise ValueError(f"unknown weight spec {specs!r}")
