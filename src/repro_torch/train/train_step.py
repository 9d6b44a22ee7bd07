"""Training step, as the reference's ``repro/train/train_step.py``:
mixed-precision forward and backward through ``forward_train``, then AdamW.

The reference traces this under ``jax.jit``; here it runs eagerly on the
params' device. Its sharding hint for accumulation
(``constrain_params_gathered``) has no counterpart on one card.
"""
from __future__ import annotations

import torch

from .. import tree as tree_util
from ..models import forward_train, init_params
from .optimizer import OptConfig, adamw_init, adamw_update


def make_train_step(cfg, opt: OptConfig, compute_dtype=torch.bfloat16,
                    remat: bool = True, accum_steps: int = 1):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics) with ``loss``, ``acc``, ``tokens``, ``grad_norm`` and ``lr``
    (and ``aux_loss`` for moe).

    Params stay f32 (master); each step casts those with ndim > 1 to
    ``compute_dtype`` once, and compute runs in it. The batch (numpy arrays
    or tensors) moves to the params' device in ``forward_train``.
    ``accum_steps`` > 1 splits the batch into microbatches along its first
    dim and accumulates f32 gradients, then divides by ``accum_steps`` as
    the reference does.
    """

    def loss_and_grads(params, batch):
        flat = [p.detach().requires_grad_(True)
                for p in tree_util.leaves(params)]
        with torch.enable_grad():
            pc = tree_util.tree_map(
                lambda w: w.to(compute_dtype)
                if w.dtype == torch.float32 and w.dim() > 1 else w,
                tree_util.unflatten_like(params, flat))
            loss, metrics = forward_train(cfg, pc, batch, compute_dtype,
                                          remat=remat)
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, tree_util.unflatten_like(params, list(grads))

    def step(params, opt_state, batch):
        if accum_steps <= 1:
            metrics, grads = loss_and_grads(params, batch)
        else:
            dev = tree_util.leaves(params)[0].device
            n = len(batch["tokens"]) // accum_steps
            mbs = [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                   for i in range(accum_steps)]
            grads = tree_util.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            keys = ("loss", "acc", "tokens") + \
                (("aux_loss",) if cfg.moe is not None else ())
            msum = {k: torch.zeros((), dtype=torch.float32, device=dev)
                    for k in keys}
            for mb in mbs:
                m, g = loss_and_grads(params, mb)
                grads = tree_util.tree_map(lambda a, b: a + b.float(),
                                           grads, g)
                msum = {k: msum[k] + m[k] for k in msum}
            grads = tree_util.tree_map(lambda g: g / accum_steps, grads)
            metrics = {k: v / accum_steps for k, v in msum.items()}
            metrics["tokens"] = msum["tokens"]
        params, opt_state, opt_metrics = adamw_update(grads, opt_state,
                                                      params, opt)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return step


def init_train_state(cfg, gen: torch.Generator, dtype=torch.float32,
                     device=None):
    """(params drawn from the CPU generator ``gen`` in ``dtype`` on
    ``device``, their AdamW state). ``device`` None means ``cuda``, an
    error without a card."""
    params = init_params(cfg, gen, dtype, device)
    return params, adamw_init(params)
