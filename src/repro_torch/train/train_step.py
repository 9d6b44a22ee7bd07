"""Training step, as the reference's ``repro/train/train_step.py``:
mixed-precision forward and backward through ``forward_train``, then AdamW.

The reference traces this under ``jax.jit``; here it runs eagerly on the
params' device. With ``mesh=`` (a ``DeviceMesh``) the state is sharded as
the reference's specs place it: the f32 masters and the AdamW moments are
DTensors placed by ``param_specs`` (FSDP storage over every mesh axis),
``step`` is replicated, and each step

  * casts the masters to ``compute_dtype`` on each shard and builds the
    compute copy once, however many microbatches follow (the reference's
    G3b): ``constrain_params_gathered`` gathers each leaf over the data
    axes and lays it out over 'model' as ``compute_model_dims`` says
    (column-, row-, vocab- or expert-parallel, else whole), one or two
    collectives a leaf;
  * runs ``forward_train`` tensor-parallel over 'model' under the rules
    (``models/model.py``) on the rows of the global batch that
    ``Rules(mesh, "train").spec("batch")`` gives this rank: the ranks of
    one 'model' group share those rows and split the work on them;
  * weights each rank's loss by its share of the global batch's unmasked
    targets, so the summed gradient is that of the global token mean, as
    the reference's one loss over the whole batch (moe's load-balance
    statistics are global means through ``reduce_model`` and
    ``batch_mean``);
  * sums the gradients leaf by leaf (``grad_to_storage``) over the axes
    that split the batch and, for a leaf used whole (computed on each
    rank's sequence slice), over 'model'; a leaf split over 'model' is
    whole for its split and goes back to the storage's split (an
    all-to-all for a row-parallel weight or the experts); a reduce-scatter
    where the storage shards a summed axis, an all-reduce where it
    replicates it; then AdamW on the local shards after one global norm
    across them.

Per rank the card holds the f32 masters and moments of its shards (12
bytes a parameter over the ranks that shard it), plus, during a step, the
compute copy and its gradient in ``compute_dtype``: 1/tp of each split
leaf and the whole of each leaf used whole (2 + 2 bytes a parameter in
bf16), one leaf's f32 gradient, and the activations of this rank's rows
and sequence slice (``accum_steps`` > 1 adds an f32 gradient sum of the
compute copy's size).
"""
from __future__ import annotations

import torch

from .. import tree as tree_util
from ..models import forward_train, init_params
from .optimizer import (OptConfig, adamw_init, adamw_update,
                        adamw_update_sharded)


def make_train_step(cfg, opt: OptConfig, compute_dtype=torch.bfloat16,
                    remat: bool = True, accum_steps: int = 1, mesh=None,
                    count_targets=None):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics) with ``loss``, ``acc``, ``tokens``, ``grad_norm`` and ``lr``
    (and ``aux_loss`` for moe).

    Params stay f32 (master); each step casts those with ndim > 1 to
    ``compute_dtype`` once, and compute runs in it. The batch (numpy arrays
    or tensors) moves to the params' device in ``forward_train``.
    ``accum_steps`` > 1 splits the batch into microbatches along its first
    dim and accumulates f32 gradients, then divides by ``accum_steps`` as
    the reference does. With ``mesh`` the state is the one
    :func:`shard_train_state` places, and every rank passes the global
    batch (see the module docstring); the step also has ``step.grads(
    params, batch)`` -> (metrics, the reduced gradient tree, placed as the
    params), the gradient the optimizer would be given. A mesh step
    counts the unmasked targets of the global batch and of its rows to
    weight its loss; ``count_targets`` (targets -> that count) replaces
    the count, for a dry-run's fake tensors, which hold no values to
    count (every target of a dry-run is unmasked: ``Tensor.numel``).
    """
    if mesh is not None:
        return _make_mesh_step(cfg, opt, compute_dtype, remat, accum_steps,
                               mesh, count_targets)

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


# ---------------------------------------------------------------------------
# on a DeviceMesh
# ---------------------------------------------------------------------------

def shard_train_state(params, opt_state, mesh):
    """The full ``params`` and their AdamW state, which every rank holds
    alike on any device, as DTensors on ``mesh``: the params and both
    moments placed by ``param_specs``, ``step`` replicated. Each rank
    copies its own slice to the mesh's device (no collective), so full
    state drawn on the host never reaches the card whole. ``opt_state``
    None starts AdamW: zero moments made on the slices, step 0.
    :func:`draw_sharded_state` draws and places weights without the whole
    tree on the host."""
    from ..dist import sharding
    shard = sharding.shardings_for(mesh, sharding.param_specs(params, mesh))

    def place(tree):
        return tree_util.map_with_paths(
            lambda path, x: sharding.distribute(
                x, tree_util.at(shard, path)), tree)

    placed = place(params)
    if opt_state is None:
        return placed, _adamw_on(placed, mesh)
    replicated = sharding.NamedSharding(mesh, sharding.P())
    return placed, {"m": place(opt_state["m"]), "v": place(opt_state["v"]),
                    "step": sharding.distribute(opt_state["step"],
                                                replicated)}


def _adamw_on(placed, mesh):
    """AdamW's start on the DTensor params ``placed``: zero moments made
    on the slices, step 0 replicated."""
    from ..dist import sharding

    def zeros(p):
        return sharding.from_local(
            torch.zeros(p.to_local().shape, dtype=torch.float32,
                        device=p.to_local().device),
            mesh, p.placements, p.shape)
    return {"m": tree_util.tree_map(zeros, placed),
            "v": tree_util.tree_map(zeros, placed),
            "step": sharding.distribute(
                torch.zeros((), dtype=torch.int32),
                sharding.NamedSharding(mesh, sharding.P()))}


def draw_sharded_state(cfg, gen: torch.Generator, mesh,
                       dtype=torch.float32):
    """``shard_train_state(init_params(cfg, gen, dtype, device="cpu"),
    None, mesh)``, bit for bit, without the whole tree on the host: each
    leaf is drawn on the host in ``init_params``'s order from ``gen``,
    this rank keeps its slice on the mesh's device, and the leaf is freed
    before the next is drawn. A rank's host holds one leaf at a time (and
    the small leaves that are not drawn: norms, constants), not 4 bytes a
    parameter."""
    from torch.distributed.tensor import DTensor
    from ..dist import sharding
    from ..models.layers import draws_through
    stand_ins = []
    with draws_through(lambda w: stand_ins.append(w) or w):
        meta = init_params(cfg, None, dtype, device="meta")
    where = {id(x): path for path, x in tree_util.flatten_with_paths(meta)}
    missing = [tuple(w.shape) for w in stand_ins if id(w) not in where]
    if missing:
        raise RuntimeError(f"init_params drew leaves it did not keep as "
                           f"drawn: {missing}")
    shard = sharding.shardings_for(mesh, sharding.param_specs(meta, mesh))
    order = iter([where[id(w)] for w in stand_ins])

    def keep(w):
        return sharding.distribute(w, tree_util.at(shard, next(order)))
    with draws_through(keep):
        params = init_params(cfg, gen, dtype, device="cpu")
    placed = tree_util.map_with_paths(
        lambda path, x: x if isinstance(x, DTensor) else
        sharding.distribute(x, tree_util.at(shard, path)), params)
    return placed, _adamw_on(placed, mesh)


def _local_rows(batch, rules):
    """This rank's rows of a global batch: the slice of dim 0 that the
    rules' batch spec gives it (every row when the batch is
    replicated)."""
    from ..dist.sharding import NamedSharding
    rows = NamedSharding(rules.mesh, rules.spec("batch")).local_slices(
        (len(batch["tokens"]),))[0]
    return {k: v[rows] for k, v in batch.items()}


def _grad_reduce_dims(rules, split: bool):
    """The mesh axes a leaf's gradient is summed over: those whose ranks
    hold different rows, and for a leaf used whole (``split`` False) those
    whose ranks hold different sequence slices of them ('model' when the
    compute is tensor-parallel)."""
    from ..dist.sharding import batch_axes, seq_axes
    return batch_axes(rules) + (() if split else seq_axes(rules))


def _unmasked(targets) -> int:
    t = targets if torch.is_tensor(targets) else torch.as_tensor(targets)
    return int((t >= 0).sum())


def _dim_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def _make_mesh_step(cfg, opt, compute_dtype, remat, accum_steps, mesh,
                    count_targets=None):
    import torch.distributed as dist
    from ..dist import sharding

    def reduce(t, axes):
        for a in axes:
            if _dim_size(mesh, a) > 1:
                dist.all_reduce(t, group=mesh.get_group(a))
        return t

    def gathered(params, rules):
        """The compute copy: each leaf cast on its shard, then laid out as
        ``compute_model_dims`` says (a plain tensor each)."""
        with sharding.use_rules(rules):
            return tree_util.tree_map(
                lambda w: w.detach(), sharding.constrain_params_gathered(
                    params, cfg, compute_dtype))

    def micro(flat, pc, batch, rules):
        """(global metrics, this rank's gradient of its weighted loss, in
        ``compute_dtype``) for one global (micro)batch."""
        local = _local_rows(batch, rules)
        count = count_targets or _unmasked
        n_all = count(batch["targets"])
        w = count(local["targets"]) / max(n_all, 1)
        with torch.enable_grad(), sharding.use_rules(rules):
            loss, m = forward_train(cfg, pc, local, compute_dtype,
                                    remat=remat)
            ce = m["loss"]
            # the share of the global token mean; moe's aux term, already
            # a global mean, is every rank's whole
            obj = loss if w == 1.0 else ce * w + (loss - ce)
            grads = torch.autograd.grad(obj, flat, allow_unused=True,
                                        materialize_grads=True)
        sums = reduce(torch.stack([ce.detach() * w, m["acc"] * w]),
                      sharding.batch_axes(rules))
        metrics = {"loss": sums[0], "acc": sums[1],
                   "tokens": torch.tensor(float(n_all), device=ce.device)}
        if "aux_loss" in m:
            metrics["aux_loss"] = m["aux_loss"].detach()
        return metrics, list(grads)

    def grads(params, batch):
        B = len(batch["tokens"])
        n = B // max(accum_steps, 1)
        rules = sharding.Rules(mesh, "train", global_batch=n)
        pc = gathered(params, rules)
        flat = [t.requires_grad_(True) for t in tree_util.leaves(pc)]
        pc = tree_util.unflatten_like(params, flat)
        if accum_steps <= 1:
            metrics, gsum = micro(flat, pc, batch, rules)
        else:
            gsum = [torch.zeros(t.shape, dtype=torch.float32,
                                device=t.device) for t in flat]
            msum = None
            for i in range(accum_steps):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                m, g = micro(flat, pc, mb, rules)
                gsum = [a + b.float() for a, b in zip(gsum, g)]
                msum = m if msum is None else \
                    {k: msum[k] + m[k] for k in msum}
            metrics = {k: v / accum_steps for k, v in msum.items()}
            metrics["tokens"] = msum["tokens"]
        del flat, pc                    # the compute copy goes first
        with sharding.use_rules(rules):
            dims = sharding.compute_layout(params, cfg)
        out = []
        for i, (path, p) in enumerate(tree_util.flatten_with_paths(params)):
            d = tree_util.at(dims, path)
            # each compute-layout gradient is dropped once its shard is
            # taken
            mine, gsum[i] = sharding.grad_to_storage(
                gsum[i], p, d, _grad_reduce_dims(rules, d is not None)), None
            if accum_steps > 1:
                mine = mine / accum_steps
            out.append(sharding.from_local(mine, mesh, p.placements,
                                           p.shape))
        return metrics, tree_util.unflatten_like(params, out)

    def step(params, opt_state, batch):
        metrics, g = grads(params, batch)
        params, opt_state, opt_metrics = adamw_update_sharded(
            g, opt_state, params, opt)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    step.grads = grads
    return step

