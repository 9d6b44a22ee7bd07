"""Compressed gradient collectives, as the reference's ``repro/dist/
collectives.py``: an int8-quantized sum with error feedback.

Each rank quantizes ``x + err`` to int8 against a scale every rank agrees
on (the max over the group of ``max |x + err|``), and carries the
quantization residual into the next round (error feedback), so the
accumulated reduction stays unbiased. The arithmetic is the reference's:
``q = clip(round((x + err) / s * 127), -127, 127)``, rounding half to
even as ``jnp.round`` does, and ``deq = q * (s / 127)``.

The reference's docstring promises a 4x cut in wire bytes, but its code
sums the f32 dequantized value (``psum(deq)``); the port follows the code
(ROADMAP Queue 3, R12): the sum is an ``all_reduce(SUM)`` of ``deq`` in
f32.

``group`` is a ``ProcessGroup``, a ``(DeviceMesh, dim name)`` pair (the
reference's bound axis name), or ``None`` for the default group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import tree as tree_util


def _group(group):
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    return group


def quantize_int8(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantization of ``x`` against ``scale`` (max-abs)."""
    s = torch.clamp(torch.as_tensor(scale, dtype=torch.float32,
                                    device=x.device),
                    min=torch.finfo(torch.float32).tiny)
    q = torch.round(x.float() / s * 127.0)
    return torch.clamp(q, -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    s = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    return q.float() * (s / 127.0)


def zeros_like_errors(tree):
    """Initial (zero) error-feedback state matching a gradient tree."""
    return tree_util.tree_map(
        lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device),
        tree)


def compressed_psum(x: torch.Tensor, err: torch.Tensor, group=None):
    """int8-compressed sum over ``group`` with error feedback.

    Returns (the sum of the dequantized values, the new local error). The
    scale is max-reduced so every rank quantizes against the same grid;
    the residual ``x + err - dequantize(quantize(...))`` is returned for
    the next round."""
    pg = _group(group)
    xe = x.float() + err
    scale = torch.amax(torch.abs(xe))
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=pg)
    deq = dequantize_int8(quantize_int8(xe, scale), scale)
    new_err = xe - deq
    total = deq.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=pg)
    return total, new_err


def compressed_tree_psum(tree, errs, group=None):
    """Leaf-wise :func:`compressed_psum` over a gradient tree.

    Returns (reduced tree, new error tree) with the input structure."""
    pairs = [compressed_psum(a, e, group) for a, e in
             zip(tree_util.leaves(tree), tree_util.leaves(errs))]
    return (tree_util.unflatten_like(tree, [p[0] for p in pairs]),
            tree_util.unflatten_like(tree, [p[1] for p in pairs]))
