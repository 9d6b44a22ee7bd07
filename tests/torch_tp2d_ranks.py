"""What each gloo rank runs for ``test_torch_tp2d.py`` (through
``torch_ranks.run_ranks``): the port's training step and sharded serving
on a (1, 2, 2) ('data', 'model', 'model2') mesh built by
``launch.mesh.make_tp2d_mesh``, the compute tensor-parallel over the
flattened ('model', 'model2') group of 4 and the weights stored over
'model' alone, against the port's one-process runs and beside the JAX
package's sharded steps on the same mesh (``torch_tp2d_ref.py``).

Sizes as ``torch_mesh_ranks`` (training) and ``torch_serve_ranks``
(serving): 2 layers, vocab 128, f32. ``SEQ_HEADS`` is llama3.2-1b cut to
6 heads (6 KV) at 32 tokens: 4 does not factor over (KV, G), so attention
runs the "seq" layout (the rank's query positions against every key)."""
import contextlib

import torch

from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.data import make_lm_batches
from repro_torch.dist import sharding
from repro_torch.launch.mesh import make_tp2d_mesh
from repro_torch.models.layers import attn_choice
from repro_torch.models import forward_train, init_params
from repro_torch.train import make_train_step, shard_train_state
from torch_mesh_ranks import (OPT, batches, cfg_of, init_state, mesh_run,
                              one_device)
from torch_serve_ranks import compare

SHAPE = (1, 2, 2)
TP = 4
TRAIN = ("llama3.2-1b", "moonshot-v1-16b-a3b")
SERVE = ("llama3.2-1b", "zamba2-1.2b", "rwkv6-1.6b")
SEQ_HEADS = dict(n_heads=6, n_kv_heads=6, d_head=16)
# serving: 20 prompt tokens and 12 new, so that the flat group of 4
# splits both the prefill's cache (20) and the decode cache (32), at
# different bounds (the graft reslices it)
PROMPT, NEW = 20, 12


def seq_heads_cfg():
    return get_config("llama3.2-1b").reduced(n_layers=2, vocab_size=128,
                                             **SEQ_HEADS)


@contextlib.contextmanager
def _patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


def _no_model2_gather(g, dim, sub):
    """The broken control's ``_gather_model2``: the rank's own slice of
    the gradient stands for its 'model2' partner's too (nothing sent)."""
    return torch.cat([g] * sub.size, dim)


def _trained(cfg, params, bs, mesh):
    """Losses of len(bs) steps of the mesh step from ``params`` (numpy)."""
    p, opt_state = shard_train_state(from_jax(params, "cpu"), None, mesh)
    step = make_train_step(cfg, OPT, torch.float32, remat=True, mesh=mesh)
    losses = []
    for b in bs:
        p, opt_state, m = step(p, opt_state, b)
        losses.append(float(m["loss"]))
    return losses


def _loss_of(cfg, params, batch) -> float:
    """The one-process f32 loss of a params tree (DTensors gathered whole
    first: the stored state, every rank's shard)."""
    from torch.distributed.tensor import DTensor
    from repro_torch import tree as tree_util
    whole = tree_util.tree_map(
        lambda x: x.full_tensor() if isinstance(x, DTensor) else x, params)
    with torch.no_grad():
        return float(forward_train(cfg, whole, batch, torch.float32,
                                   remat=False)[0])


def trained_state_err(cfg, mesh, bs):
    """The mesh run of ``torch_mesh_ranks.mesh_run`` and, under
    "state_err", the loss of its trained state gathered whole on a batch
    it did not train on against the one-process trained state's, relative.
    Each rank computes on its own chunk of each split leaf only, so the
    steps' losses cannot see a chunk stored wrong; this loss reads every
    chunk."""
    held = make_lm_batches(cfg, len(bs[0]["tokens"]),
                           bs[0]["tokens"].shape[1], 1, seed=7)[0]
    params, opt_state = init_state(cfg)
    step = make_train_step(cfg, OPT, torch.float32, remat=True)
    for b in bs:
        params, opt_state, _ = step(params, opt_state, b)
    want = _loss_of(cfg, params, held)
    r = mesh_run(cfg, mesh, one_device(cfg, bs), bs=bs,
                 then=lambda p: _loss_of(cfg, p, held))
    r["state_err"] = abs(r.pop("then") - want) / abs(want)
    return r


def group_tp2d(rank, world, params):
    """On (1, 2, 2): the tensor-parallel group this rank sees; training
    of ``TRAIN`` and of ``SEQ_HEADS`` against the one-process step, and of
    the JAX package's params (``params``, numpy, by arch, as
    ``torch_tp2d_ref.py`` draws them) on its batches; the broken control
    (no 'model2' gather of the split gradients); serving of ``SERVE`` on
    the JAX package's params and of ``SEQ_HEADS`` on the port's against
    the one-process ``serve_batch``, and the "long" rules for llama."""
    mesh = make_tp2d_mesh(shape=SHAPE)
    rules = sharding.Rules(mesh, "train")
    with sharding.use_rules(rules):
        grp = sharding.tp_group()
    out = {"group": (grp.rank, grp.size, tuple(mesh.get_coordinate())),
           "seq_axes": sharding.seq_axes(rules)}
    for arch in TRAIN:
        cfg = cfg_of(arch)
        out["train", arch] = trained_state_err(cfg, mesh, batches(cfg))
    cfg = seq_heads_cfg()
    out["train", "seq_heads"] = trained_state_err(cfg, mesh, batches(cfg))
    out["seq_heads_choice"] = attn_choice(cfg, TP, 32)
    cfg = cfg_of("llama3.2-1b")
    with _patched(sharding, "_gather_model2", _no_model2_gather):
        out["no_model2_gather"] = trained_state_err(cfg, mesh,
                                                    batches(cfg))
    for arch in TRAIN:
        cfg = cfg_of(arch)
        out["ref", arch] = _trained(cfg, params[arch], batches(cfg), mesh)
    for arch in SERVE:
        r = compare(cfg_of(arch), from_jax(params[arch], "cpu"), PROMPT,
                    NEW, mesh)
        if rank:
            r.pop("logits")
        out["serve", arch] = r
    cfg = seq_heads_cfg()
    p = init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                    "cpu")
    r = compare(cfg, p, PROMPT, NEW, mesh)
    r.pop("logits")
    out["serve", "seq_heads"] = r
    r = compare(cfg_of("llama3.2-1b"), from_jax(params["llama3.2-1b"],
                                                "cpu"),
                PROMPT, NEW, mesh, long=True, batch=1)
    r.pop("logits")
    out["long", "llama3.2-1b"] = r
    return out
