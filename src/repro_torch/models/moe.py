"""The Mixture-of-Experts layer of ``repro/models/moe.py``, in PyTorch.

Routing is softmax-then-top-k in f32 with the Switch load-balance loss
(``E * sum_e f_e * p_e``, ``f`` from each token's top-1 choice). Dispatch is
the reference's scatter with per-sequence groups: each sequence routes its
own tokens into an ``(E, C)`` capacity buffer, positions from an exclusive
cumsum of the expert one-hot along the sequence (never across the batch, as
the reference's ``vmap`` over sequences). A token past an expert's capacity
is dropped: its slot is clamped to position 0 and scatter-added times 0, as
in the reference (so an inf there gives the reference's NaN). Kept positions
are unique, so the scatter-add sums are exact on any device. The combine
weights each kept slot by its routing weight and does **not** renormalise
over the surviving slots: the reference's docstring says it does, its code
does not (``moe.py:112``; ROADMAP Queue 3, R9), and the port follows the
code. A single-token call (``S == 1``: decode, or a one-token prompt) takes
the reference's dense mixture over every expert.

The expert products are plain batched matmuls, which the reference leaves
to XLA outside any Pallas kernel; no kernel of the port runs here.

On a mesh the training step computes expert-parallel over 'model', as
the reference's dispatch constraint (``moe.py:103``) places the experts
(``moe_mlp`` given the 'model' group): each rank gathers the sequence,
routes it whole (so capacity and drop order are the reference's, per
sequence), fills the buffer slots of its own experts only, runs them on its slice of ``w13``/``w2`` and combines
their share of every token; the partial sums leave through a
reduce-scatter to its sequence slice. The load-balance statistics are
means over the global batch, which the reference's SPMD step takes: each
rank adds its sequence slice's share over 'model' (``reduce_model``) and
``batch_mean`` averages over the data axes (both the identity without a
mesh).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import normal_init, upcast


def init_moe(gen: torch.Generator, cfg, n_layers: int, dtype=torch.float32,
             device=None):
    """The reference's ``init_moe`` keys and shapes: ``router`` (L, D, E),
    ``w13`` (L, E, D, 2F) with gate and up fused, ``w2`` (L, E, F, D) at
    ``0.02 / sqrt(2 n_layers)``."""
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.n_experts, m.d_ff_expert
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    kw = dict(dtype=dtype, device=device)
    return {"router": normal_init(gen, (n_layers, D, E), **kw),
            "w13": normal_init(gen, (n_layers, E, D, 2 * Fe), **kw),
            "w2": normal_init(gen, (n_layers, E, Fe, D), out_scale, **kw)}


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last dim, largest
    first and, among equal values, the lower index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order among
    ties): a stable descending sort."""
    w, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], sel[..., :k]


def _route(x: torch.Tensor, router: torch.Tensor, m, grp=None):
    """x: (B, S, D) -> sel (B, S, k) int64, w (B, S, k) f32, aux loss (f32
    scalar; f64 for an f64 x). The router logits are a product in x's dtype,
    then widened. With ``grp`` (tensor-parallel, x the whole sequence on
    every rank) the statistics are taken over this rank's sequence slice
    and summed over the group."""
    logits = upcast(x @ router.to(x.dtype))
    probs = torch.softmax(logits, dim=-1)
    w, sel = top_k(probs, m.top_k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    E = probs.shape[-1]
    # over the global batch when a mesh splits it (identity otherwise);
    # imported here: ``dist`` imports ``core``, which imports the models
    from ..dist.sharding import batch_mean, reduce_model
    onehot = F.one_hot(sel[..., 0], E).to(probs.dtype)
    if grp is None:
        f, p = onehot.mean(dim=(0, 1)), probs.mean(dim=(0, 1))
    else:
        s0, s1 = grp.bounds(x.shape[1])
        count = x.shape[0] * x.shape[1]
        f, p = (reduce_model(t[:, s0:s1].sum(dim=(0, 1)) / count, grp)
                for t in (onehot, probs))
    f, p = batch_mean(f), batch_mean(p)
    return sel, w, E * torch.sum(f * p)


def _dispatch_seq(x: torch.Tensor, sel: torch.Tensor, w: torch.Tensor,
                  E: int, C: int, experts: Optional[Tuple[int, int]] = None):
    """Per-sequence dispatch. x: (..., S, D); sel, w: (..., S, k), the
    leading dims (if any) independent sequences. Returns the buffer (...,
    E * C, D), the flat slot index (..., S, k) and the keep mask (..., S, k).
    ``w`` is unused, as in the reference's signature. ``experts`` (e0, e1)
    fills only those experts' slots: the buffer is (..., (e1 - e0) * C, D),
    the index is into it and the mask keeps only their slots; positions
    and drops are the whole routing's."""
    *lead, S, k = sel.shape
    oh = F.one_hot(sel, E)                               # (..., S, k, E)
    row = oh.sum(-2)                                     # (..., S, E)
    excl = torch.cumsum(row, dim=-2) - row               # tokens before row s
    # earlier slots of the same row with the same expert (top-k gives
    # distinct experts; the reference stays safe, and so does this)
    intra = torch.cumsum(oh, dim=-2) - oh                # (..., S, k, E)
    pos = torch.gather(excl[..., None, :] + intra, -1, sel[..., None])[..., 0]
    keep = pos < C
    e0, e1 = (0, E) if experts is None else experts
    if experts is not None:
        keep = keep & (sel >= e0) & (sel < e1)
        sel = torch.where(keep, sel - e0, torch.zeros_like(sel))
    slot = torch.where(keep, pos, torch.zeros_like(pos))  # dropped: slot 0
    idx = sel * C + slot
    contrib = keep[..., None].to(x.dtype)
    vals = (x[..., None, :] * contrib).reshape(*lead, S * k, x.shape[-1])
    n = math.prod(lead)
    b = torch.arange(n, device=x.device).repeat_interleave(S * k)
    buf = torch.zeros((n, e1 - e0, C, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    buf = buf.index_put((b, sel.reshape(-1), slot.reshape(-1)),
                        vals.reshape(n * S * k, -1), accumulate=True)
    return buf.reshape(*lead, (e1 - e0) * C, x.shape[-1]), idx, keep


def capacity(cfg, S: int) -> int:
    """Slots an expert has per sequence of S tokens:
    ``max(1, ceil(S k capacity_factor / E))``."""
    m = cfg.moe
    return max(1, int(math.ceil(S * m.top_k * m.capacity_factor
                                / m.n_experts)))


def _experts(h: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor, eq_in: str,
             eq_out: str) -> torch.Tensor:
    """SwiGLU experts: gate and up are the two halves of ``w13``."""
    g1, g3 = torch.chunk(torch.einsum(eq_in, h, w13.to(h.dtype)), 2, dim=-1)
    return torch.einsum(eq_out, F.silu(g1) * g3, w2.to(h.dtype))


def experts_split(cfg, tp: int) -> bool:
    """Whether the experts split over a 'model' of ``tp`` ranks (expert
    parallel); else every rank runs them all."""
    return cfg.moe.n_experts % tp == 0


def moe_mlp(x: torch.Tensor, p, cfg, n: Optional[int] = None, grp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (B, S, D), aux loss. ``p`` holds this layer's
    slices (``router``, ``w13``, ``w2``). With ``grp`` (tensor-parallel)
    ``x`` is this rank's sequence slice of a sequence ``n`` long and the
    output its slice: the sequence is gathered and routed whole, the
    rank's experts (its slice of ``w13``/``w2``, where
    :func:`experts_split`) fill and run their slots, and the partial sums
    leave through a reduce-scatter; the aux loss is alike on every
    rank. With ``n`` None (a decode step: one token, the residual whole on
    every rank) the rank's experts' share of the dense mixture is
    all-reduced."""
    from ..dist.sharding import gather_seq, leave_block, seq_slice
    m = cfg.moe
    x = gather_seq(x, n, grp)
    B, S, D = x.shape
    E = m.n_experts
    # decode (n None): one token's statistics, taken on every rank
    sel, w, aux = _route(x, p["router"], m, None if n is None else grp)
    mine, El = None, E
    if grp is not None and experts_split(cfg, grp.size):
        El = E // grp.size
        mine = (grp.rank * El, (grp.rank + 1) * El)
    if S == 1:
        # the dense mixture over experts (the reference's decode branch),
        # expert-parallel: each rank its experts' share, summed
        gates = torch.sum(F.one_hot(sel, E).to(w.dtype) * w[..., None],
                          dim=2)                           # (B, 1, E)
        if mine is not None:
            gates = gates[..., mine[0]:mine[1]]
        y = _experts(x, p["w13"], p["w2"], "bsd,edf->bsef", "bsef,efd->bsed")
        out = torch.einsum("bsed,bse->bsd", y, gates.to(x.dtype))
        return (seq_slice(out, None if n is None else grp) if mine is None
                else leave_block(out, n, grp)), aux
    C = capacity(cfg, S)
    buf, idx, keep = _dispatch_seq(x, sel, w, E, C, mine)
    y = _experts(buf.reshape(B, El, C, D), p["w13"], p["w2"],
                 "becd,edf->becf", "becf,efd->becd").reshape(B, El * C, D)
    # combine: each slot's output, weighted, summed over the k slots
    gathered = torch.gather(y, 1, idx.reshape(B, S * m.top_k, 1)
                            .expand(-1, -1, D)).reshape(B, S, m.top_k, D)
    out = torch.einsum("bskd,bsk->bsd", gathered, (w * keep).to(x.dtype))
    return (seq_slice(out, grp) if mine is None
            else leave_block(out, n, grp)), aux
