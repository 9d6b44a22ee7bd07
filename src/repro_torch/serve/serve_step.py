"""Serving steps: batched prefill and single-token decode with KV/SSM
caches (``repro/serve/serve_step.py``), on one device or on a
``DeviceMesh``.

On a mesh (``mesh=``) the steps run the reference's sharded serving, its
``jit`` under ``use_rules(Rules(mesh, "prefill" | "decode" | "long"))``:

  * the weights are DTensors placed as ``launch.specs.state_specs(cfg,
    rules, torch.bfloat16)`` says (:func:`shard_serve_state`: FSDP over
    'data' and split over 'model', 'data' dropped where the weights fit
    the serving budget), whatever their dtype; each step computes on the
    compute copy ``dist.sharding.constrain_params_gathered`` lays out over
    'model', built at its first call with a params tree and kept with the
    step;
  * the cache is DTensors placed as ``launch.specs.cache_specs`` says:
    ``k``, ``v``, ``ck`` and ``cv`` over (batch, cache_seq), ``wkv`` and
    ``ssm`` over (batch, act_model), the rest over batch;
  * every rank passes the global batch (tokens, frames, patches) or a
    batch-sharded token DTensor, and computes its rows tensor-parallel
    over 'model' (``models.forward_prefill`` / ``forward_decode`` under
    the rules), the kernels K4-K7 on its share;
  * the logits come back vocab-sharded, (batch, vocab) as the reference's
    out-sharding says, and :func:`greedy_sample` takes the argmax across
    the vocabulary's ranks.

Under "long" the batch is replicated and the cache's sequence split over
every axis of the mesh (a decode's combine runs over the whole mesh).
"""
from __future__ import annotations

import torch

from .. import obs
from .. import tree as tree_util
from ..models import forward_decode, forward_prefill

def shard_serve_state(params, mesh, rules, cfg):
    """``params`` (whole tensors, alike on every rank, on any device) as
    DTensors on ``mesh``, placed as ``state_specs(cfg, rules,
    torch.bfloat16)`` places serving weights; each rank copies its own
    slice to the mesh's device (no collective). The dtype is kept."""
    from ..dist import sharding
    from ..launch.specs import state_specs
    shard = state_specs(cfg, rules, torch.bfloat16)[1]
    return tree_util.map_with_paths(
        lambda path, x: sharding.distribute(x, tree_util.at(shard, path)),
        params)


class _ComputeCopy:
    """A step's compute copy of the serving weights (gathered over 'data',
    laid out over 'model' by ``dist.sharding.constrain_params_gathered``,
    the Mamba-2 layers cut to the rank's share of their SSD heads once,
    ``models.mamba2.share_weights``), made at the first call with a params
    tree and kept for the calls that pass the same tree."""

    def __init__(self, cfg):
        self.cfg, self.src, self.copy = cfg, None, None

    def __call__(self, params, rules):
        from ..dist.sharding import (constrain_params_gathered, tp_group,
                                     use_rules)
        from ..models import mamba2
        if params is not self.src:
            with use_rules(rules):
                copy = constrain_params_gathered(params, self.cfg)
                grp = tp_group()
            layers = copy.get("layers", {})
            if "mamba" in layers and grp is not None \
                    and mamba2.ssd_heads_split(self.cfg, grp.size):
                copy = {**copy, "layers": {**layers, "mamba": mamba2.
                        share_weights(layers["mamba"], self.cfg, grp)}}
            self.copy, self.src = copy, params
        return self.copy


def _rows(rules, B: int) -> slice:
    from ..dist.sharding import NamedSharding
    return NamedSharding(rules.mesh, rules.spec("batch")).local_slices(
        (B,))[0]


def _placed(local: torch.Tensor, spec, rules, shape):
    """``local`` as the DTensor of global ``shape`` placed by ``spec``
    (guarded), after checking that it is this rank's shard's shape."""
    from ..dist.sharding import NamedSharding, _guard, from_local
    sh = NamedSharding(rules.mesh, _guard(spec, shape, rules.mesh))
    want = tuple(s.stop - s.start for s in sh.local_slices(shape))
    if tuple(local.shape) != want:
        raise RuntimeError(f"a local shard {tuple(local.shape)} where the "
                           f"spec {sh.spec} of {tuple(shape)} gives {want}")
    return from_local(local, rules.mesh, sh.placements, shape)


def _global_shape(cfg, name: str, shape, B: int, lens) -> tuple:
    """A cache leaf's whole shape from this rank's: the global batch, the
    KV sequence ``lens[name]``, every head of ``wkv`` and ``ssm``."""
    shape = list(shape)
    shape[1] = B
    if name in lens:
        shape[2] = lens[name]
    elif name == "wkv":
        shape[2] = cfg.n_heads
    elif name == "ssm":
        shape[2] = cfg.ssm.expand * cfg.d_model // cfg.ssm.d_head
    return tuple(shape)


def _place_cache(cfg, cache, rules, B: int, lens):
    """A cache of this rank's local shards (as ``forward_prefill`` returns
    it under ``rules``) as DTensors placed by ``cache_specs``' specs;
    ``lens``: the whole KV sequences by leaf name."""
    from ..dist.sharding import cache_leaf_spec

    def wrap(path, x):
        name = str(path[-1])
        shape = _global_shape(cfg, name, x.shape, B, lens)
        return _placed(x, cache_leaf_spec(name, shape, rules), rules, shape)
    return tree_util.map_with_paths(wrap, cache)


def zero_cache(cfg, B: int, seq_len: int, rules, dtype=torch.bfloat16):
    """``init_cache(cfg, B, seq_len, dtype)`` as DTensors placed by
    ``cache_specs``: each rank allocates only its shard, zeros."""
    from ..dist.sharding import (NamedSharding, cache_leaf_spec, from_local,
                                 mesh_device)
    from ..models import init_cache
    dev = mesh_device(rules.mesh)

    def zeros(path, m):
        sh = NamedSharding(rules.mesh,
                           cache_leaf_spec(str(path[-1]), m.shape, rules))
        local = tuple(s.stop - s.start for s in sh.local_slices(m.shape))
        return from_local(torch.zeros(local, dtype=m.dtype, device=dev),
                          rules.mesh, sh.placements, m.shape)
    return tree_util.map_with_paths(
        zeros, init_cache(cfg, B, seq_len, dtype, device="meta"))


def make_prefill_step(cfg, compute_dtype=torch.bfloat16, mesh=None,
                      long: bool = False):
    """prefill(params, batch) -> (last-token logits (B, V), cache). With
    ``mesh``: ``params`` from :func:`shard_serve_state`, the global
    ``batch`` on every rank, under ``Rules(mesh, "prefill")`` (``long``:
    "long"); the logits and the cache come back as DTensors (the module
    docstring). Each call is one ``serve.prefill_step`` span (``obs``),
    the root of the model's spans."""
    if mesh is None:
        def prefill(params, batch):
            with obs.span("serve.prefill_step", batch["tokens"]):
                return forward_prefill(cfg, params, batch, compute_dtype)
        return prefill
    from ..dist.sharding import Rules, use_rules
    copy = _ComputeCopy(cfg)

    def prefill(params, batch):
        with obs.span("serve.prefill_step", batch["tokens"]):
            return _mesh_prefill(params, batch)

    def _mesh_prefill(params, batch):
        B = batch["tokens"].shape[0]
        rules = Rules(mesh, "long" if long else "prefill", global_batch=B)
        rows = _rows(rules, B)
        pc = copy(params, rules)
        local = {k: v[rows] for k, v in batch.items()}
        with use_rules(rules):
            logits, cache = forward_prefill(cfg, pc, local, compute_dtype)
        n = batch["tokens"].shape[1] + (
            batch["embeds"].shape[1] if "embeds" in batch else 0)
        lens = {"k": n, "v": n}
        if "enc_embeds" in batch:
            lens["ck"] = lens["cv"] = batch["enc_embeds"].shape[1]
        V = cfg.vocab_size
        return (_placed(logits, rules.spec("batch", "vocab"), rules, (B, V)),
                _place_cache(cfg, cache, rules, B, lens))
    return prefill


def make_decode_step(cfg, compute_dtype=torch.bfloat16, mesh=None,
                     long: bool = False):
    """decode(params, cache, token (B,1), pos) -> (logits (B,1,V), cache).
    With ``mesh``: ``params`` from :func:`shard_serve_state`, the cache
    DTensors placed as ``cache_specs`` says (a prefill's, grafted, or
    :func:`zero_cache`), ``token`` the global (B, 1) or a batch-sharded
    DTensor, under ``Rules(mesh, "decode")`` (``long``: "long"); the KV
    shards are written in place and the logits come back as a DTensor."""
    if mesh is None:
        def decode(params, cache, token, pos):
            return forward_decode(cfg, params, cache, token, pos,
                                  compute_dtype)
        return decode
    from torch.distributed.tensor import DTensor
    from ..dist.sharding import Rules, from_local, use_rules
    copy = _ComputeCopy(cfg)

    def decode(params, cache, token, pos):
        B = tree_util.leaves(cache)[0].shape[1]
        rules = Rules(mesh, "long" if long else "decode", global_batch=B)
        pc = copy(params, rules)
        local = tree_util.tree_map(lambda c: c.to_local(), cache)
        tok = token.to_local() if isinstance(token, DTensor) \
            else torch.as_tensor(token)[_rows(rules, B)]
        lens = {k: cache[k].shape[2] for k in ("k", "ck") if k in cache}
        with use_rules(rules):
            logits, new = forward_decode(cfg, pc, local, tok, pos,
                                         compute_dtype, lens)
        # KV shards were written in place; the recurrent states are new
        out = tree_util.tree_map(
            lambda c, old, x: c if x is old else from_local(
                x, mesh, c.placements, c.shape), cache, local, new)
        V = cfg.vocab_size
        return (_placed(logits, rules.spec("batch", None, "vocab"), rules,
                        (B, 1, V)), out)
    return decode


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """The first index of the largest logit, as int32 (ties go to the
    lower index in both frameworks). Vocab-sharded logits (a DTensor from
    a mesh step) give a DTensor of tokens, placed as their rows: the
    argmax across the vocabulary's ranks (``dist.sharding.argmax_vocab``),
    ties to the lower global index."""
    from torch.distributed.tensor import DTensor
    if not isinstance(logits, DTensor):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    from torch.distributed.tensor import Replicate, Shard
    from ..dist.sharding import _flat_group, argmax_vocab, from_local
    mesh, last = logits.device_mesh, logits.dim() - 1
    local = logits.to_local()
    axes = tuple(name for name, pl in zip(mesh.mesh_dim_names,
                                          logits.placements)
                 if isinstance(pl, Shard) and pl.dim == last)
    grp = _flat_group(mesh, axes) if axes else None
    v0 = grp.rank * local.shape[-1] if axes else 0
    tok = argmax_vocab(local, v0, grp).to(torch.int32)
    placements = tuple(Replicate() if isinstance(pl, Shard) and pl.dim ==
                       last else pl for pl in logits.placements)
    return from_local(tok, mesh, placements, logits.shape[:-1])
