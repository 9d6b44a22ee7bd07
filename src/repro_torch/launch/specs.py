"""Shape-only input specs and their shardings for every (arch x shape)
cell, as the reference's ``repro/launch/specs.py``.

The stand-ins are tensors on the ``meta`` device: shapes and dtypes with no
storage, so a full-size config (internvl2-76b, ~300 GB of f32 weights) is
described without allocating or drawing anything. The param, cache and
optimizer trees come from the port's own ``init_params``, ``init_cache``
and ``adamw_init`` on ``meta``, with the reference's dtypes. Shardings are
:class:`~repro_torch.dist.sharding.NamedSharding` on any mesh the rules
take (a ``DeviceMesh`` or a shape-only ``MeshShape``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .. import tree as tree_util
from ..configs import ModelConfig, ShapeConfig
from ..dist.sharding import (NamedSharding, P, Rules, _guard, _mesh_sizes,
                             map_specs, param_specs, shardings_for)
from ..models import init_cache, init_params
from ..train.optimizer import adamw_init


def sds(shape, dtype) -> torch.Tensor:
    """A shape-only stand-in: a ``meta`` tensor of ``shape`` and
    ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def safe_sharding(mesh, spec, shape) -> NamedSharding:
    """NamedSharding with axes that don't divide the dim dropped."""
    return NamedSharding(mesh, _guard(spec, shape, mesh))


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, rules: Rules,
                kind: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (stand-in batch, matching NamedSharding tree)."""
    mesh = rules.mesh
    B, S = shape.global_batch, shape.seq_len
    bspec = rules.spec("batch", None)
    b3spec = rules.spec("batch", None, None)
    batch: Dict[str, Any] = {}
    shard: Dict[str, Any] = {}

    n_text = S
    if cfg.vlm is not None:
        n_text = S - cfg.vlm.n_patches
        batch["embeds"] = sds((B, cfg.vlm.n_patches, cfg.d_model),
                              torch.bfloat16)
        shard["embeds"] = NamedSharding(mesh, b3spec)
    if cfg.encoder is not None:
        batch["enc_embeds"] = sds((B, cfg.encoder.enc_seq, cfg.d_model),
                                  torch.bfloat16)
        shard["enc_embeds"] = NamedSharding(mesh, b3spec)

    batch["tokens"] = sds((B, n_text), torch.int32)
    shard["tokens"] = NamedSharding(mesh, bspec)
    if kind == "train":
        batch["targets"] = sds((B, S), torch.int32)
        shard["targets"] = NamedSharding(mesh, bspec)
    return batch, shard


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, rules: Rules):
    """Stand-ins + shardings for the decode cache."""
    mesh = rules.mesh
    cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                       torch.bfloat16, device="meta")

    def spec_for(path, leaf):
        name = str(path[-1])
        nd = leaf.dim()
        if name in ("k", "v", "ck", "cv"):
            s = rules.spec(*([None, "batch", "cache_seq"] + [None] * (nd - 3)))
        elif name in ("wkv", "ssm"):
            s = rules.spec(*([None, "batch", "act_model"] + [None] * (nd - 3)))
        else:
            s = rules.spec(*([None, "batch"] + [None] * (nd - 2)))
        # divisibility guard (e.g. whisper's 1500-frame cross-attn cache)
        return _guard(s, leaf.shape, mesh)

    specs = tree_util.map_with_paths(spec_for, cache)
    return cache, shardings_for(mesh, specs)


SERVE_REPLICATE_BUDGET = 6 * 2**30     # bf16 params/chip to allow TP-only


def _drop_data_axis(spec) -> P:
    return P(*[None if ax == "data" else
               (tuple(a for a in ax if a != "data") or None
                if isinstance(ax, tuple) else ax)
               for ax in spec])


def state_specs(cfg: ModelConfig, rules: Rules, dtype=torch.float32):
    """Param (+ optimizer) stand-ins and shardings.

    Serving (bf16 params, kind != train): FSDP-sharded weights would be
    re-gathered for every decoded token. When the TP-only footprint fits
    the budget, the 'data' axis is dropped from weight shardings, so
    weights stream from local memory instead of the wire (the reference's
    §Perf S2); big models keep FSDP storage (they cannot fit replicated).
    """
    params = init_params(cfg, None, dtype, device="meta")
    pspecs = param_specs(params, rules.mesh)
    if rules.kind != "train" and dtype == torch.bfloat16:
        tp = _mesh_sizes(rules.mesh).get("model", 1)
        if cfg.n_params() * 2 / max(tp, 1) <= SERVE_REPLICATE_BUDGET:
            pspecs = map_specs(_drop_data_axis, pspecs)
    pshard = shardings_for(rules.mesh, pspecs)
    opt = adamw_init(params)
    ospecs = {"m": pspecs, "v": pspecs, "step": P()}
    oshard = shardings_for(rules.mesh, ospecs)
    return params, pshard, opt, oshard


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig, rules: Rules):
    """(token, pos) stand-ins and shardings for a decode step."""
    mesh = rules.mesh
    B = shape.global_batch
    token = sds((B, 1), torch.int32)
    tshard = NamedSharding(mesh, rules.spec("batch", None))
    pos = sds((), torch.int32)
    pshard = NamedSharding(mesh, P())
    return (token, tshard), (pos, pshard)
