"""First-party AdamW, as the reference's ``repro/train/optimizer.py``.

Moments are f32 and ``step`` a 0-d int32 tensor. The update is functional:
it returns new tensors and leaves its arguments as they were, so a
checkpoint being saved from the old state never sees them change. Leaves
are walked in the reference's order (``repro_torch.tree``), so
``global_norm`` adds them up in the same order. Global-norm gradient
clipping and decoupled weight decay included.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from .. import tree as tree_util


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(opt: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in f32; ``step`` a tensor (or int)."""
    step = torch.as_tensor(step).float()
    warm = step / max(opt.warmup_steps, 1)
    t = torch.clamp((step - opt.warmup_steps)
                    / max(opt.total_steps - opt.warmup_steps, 1), 0.0, 1.0)
    cos = opt.min_lr_ratio + (1 - opt.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return opt.lr * torch.where(step < opt.warmup_steps, warm, cos)


def adamw_init(params) -> Dict[str, Any]:
    """Zero f32 moments shaped like ``params``, on their devices, and step
    0."""
    def zeros(p):
        return tree_util.tree_map(
            lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device), p)
    dev = tree_util.leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves, in the reference's order, of the
    sum of their squares in f32."""
    total = 0
    for x in tree_util.leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt_state, params, opt: OptConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new opt state, {"grad_norm", "lr"})."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(opt, step)
    b1, b2 = opt.b1, opt.b2
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(vh) + opt.eps) \
            + opt.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    flat_p = tree_util.leaves(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tree_util.leaves(grads), tree_util.leaves(opt_state["m"]),
        tree_util.leaves(opt_state["v"]))]
    new = [tree_util.unflatten_like(params, [o[i] for o in out])
           for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
