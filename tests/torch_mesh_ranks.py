"""What each gloo rank runs for ``test_torch_mesh_train.py`` (through
``torch_ranks.run_ranks``): the port's training on a ``DeviceMesh`` against
its own one-process run, at reduced configs (2 layers, vocab 128, batch 4
x 32 tokens, f32 compute), with one rank's rows partly masked (-100
targets) so ranks hold different token counts. Each function returns
plain numbers and flags; the test file asserts on them."""
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import tree as tree_util
from repro_torch.ckpt import (CheckpointManager, restore_checkpoint,
                              save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data import make_lm_batches
from repro_torch.dist.sharding import (NamedSharding, P, param_specs,
                                       shardings_for)
from repro_torch.models import forward_train
from repro_torch.train import (OptConfig, init_train_state, make_train_step,
                               shard_train_state)
from repro_torch.train import train_step as train_step_mod

ARCHS = ("llama3.2-1b", "rwkv6-1.6b", "zamba2-1.2b", "moonshot-v1-16b-a3b")
STEPS, BATCH, SEQ = 3, 4, 32
OPT = OptConfig(lr=1e-3, warmup_steps=1)


def cfg_of(arch):
    return get_config(arch).reduced(n_layers=2, vocab_size=128)


def batches(cfg):
    out = make_lm_batches(cfg, BATCH, SEQ, STEPS, seed=1)
    for b in out:                  # rows 0-1 of the 4 partly masked
        b["targets"] = b["targets"].copy()
        b["targets"][0, :] = -100
        b["targets"][1, : SEQ // 2] = -100
    return out


def init_state(cfg):
    return init_train_state(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def one_device(cfg):
    """The port's one-process run: (losses, first-step gradient tree)."""
    params, opt_state = init_state(cfg)
    bs = batches(cfg)
    flat = [p.detach().requires_grad_(True) for p in tree_util.leaves(params)]
    loss, _ = forward_train(cfg, tree_util.unflatten_like(params, flat),
                            bs[0], torch.float32, remat=True)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    step = make_train_step(cfg, OPT, torch.float32, remat=True)
    losses = []
    for b in bs:
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m["loss"]))
    return losses, list(grads)


def _index(dt):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    size, off = compute_local_shape_and_global_offset(
        tuple(dt.shape), dt.device_mesh, dt.placements)
    return tuple(slice(o, o + n) for o, n in zip(off, size))


def grad_errors(got, want):
    """Per leaf: max |local reduced gradient - its slice of the one-device
    gradient| / the one-device leaf's max |g|."""
    out = []
    for g, w in zip(tree_util.leaves(got), want):
        scale = max(float(w.abs().max()), 1e-30)
        out.append(float((g.to_local() - w[_index(g)]).abs().max()) / scale)
    return out


def storage_mismatches(mesh, params, opt_state):
    """Leaves whose local shard or placements differ from the spec's."""
    specs = param_specs(params, mesh)
    bad = []
    for tree, name in ((params, "params"), (opt_state["m"], "m"),
                       (opt_state["v"], "v")):
        for path, x in tree_util.flatten_with_paths(tree):
            s = NamedSharding(mesh, tree_util.at(specs, path))
            want = tuple(sl.stop - sl.start
                         for sl in s.local_slices(x.shape))
            if tuple(x.to_local().shape) != want or \
                    tuple(x.placements) != s.placements:
                bad.append(f"{name}/{tree_util.path_key(path)}")
    return bad


def mesh_run(cfg, mesh, ref, *, save_to=None):
    """Train STEPS steps on ``mesh``: (loss errors relative to the
    one-device run, first-step gradient errors, storage mismatches, the
    losses). With ``save_to`` the state after step 2 is saved there, and
    its gathered values as a plain one-device save beside it."""
    ref_losses, ref_grads = ref
    params, opt_state = shard_train_state(*init_state(cfg), mesh)
    bad = storage_mismatches(mesh, params, opt_state)
    step = make_train_step(cfg, OPT, torch.float32, remat=True, mesh=mesh)
    bs = batches(cfg)
    _, g = step.grads(params, bs[0])
    gerr = grad_errors(g, ref_grads)
    losses = []
    for i, b in enumerate(bs):
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m["loss"]))
        if save_to is not None and i == 1:
            state = {"params": params, "opt": opt_state}
            save_checkpoint(save_to / "sharded", 2, state)
            full = tree_util.tree_map(lambda x: x.full_tensor(), state)
            if dist.get_rank() == 0:
                save_checkpoint(save_to / "plain", 2, full)
            dist.barrier()
    bad += storage_mismatches(mesh, params, opt_state)
    lerr = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    return {"loss_err": lerr, "grad_err": gerr, "storage": bad,
            "losses": losses}


def accum_run(cfg, mesh):
    """``accum_steps=2`` on ``mesh`` against the one-device run with it:
    (loss errors, how many leaves each step gathered)."""
    from repro_torch.dist import sharding
    params, opt_state = init_state(cfg)
    one = make_train_step(cfg, OPT, torch.float32, remat=True, accum_steps=2)
    want = []
    for b in batches(cfg):
        params, opt_state, m = one(params, opt_state, b)
        want.append(float(m["loss"]))
    # AdamW started on the slices (opt_state None), as the launcher does
    params, opt_state = shard_train_state(init_state(cfg)[0], None, mesh)
    step = make_train_step(cfg, OPT, torch.float32, remat=True,
                           accum_steps=2, mesh=mesh)
    real, calls = sharding.full, []

    def counted(x):
        calls.append(1)
        return real(x)
    sharding.full = counted
    try:
        got, gathers = [], []
        for b in batches(cfg):
            calls.clear()
            params, opt_state, m = step(params, opt_state, b)
            got.append(float(m["loss"]))
            gathers.append(len(calls))
    finally:
        sharding.full = real
    return {"loss_err": [abs(a - b) / abs(b) for a, b in zip(got, want)],
            "gathers": gathers, "leaves": len(tree_util.leaves(params))}


def failed_saves(cfg, mesh, where):
    """A sharded save whose write on rank 0 fails (its directory would lie
    under a file), synchronous and async: what each rank raised, and
    whether the group still meets at a barrier afterwards."""
    params, opt_state = shard_train_state(init_state(cfg)[0], None, mesh)
    state = {"params": params, "opt": opt_state}
    blocker = where / "a_file"
    if dist.get_rank() == 0:
        where.mkdir(parents=True, exist_ok=True)
        blocker.write_text("")
    dist.barrier()
    out = {}
    try:
        save_checkpoint(blocker / "ckpt", 1, state)
        out["sync"] = None
    except Exception as e:      # noqa: BLE001 — the outcome is the result
        out["sync"] = f"{type(e).__name__}: {e}"
    mgr = CheckpointManager(blocker / "ckpt")
    mgr.save_async(1, state)
    try:
        mgr.wait()
        out["async"] = None
    except Exception as e:      # noqa: BLE001
        out["async"] = f"{type(e).__name__}: {e}"
    dist.barrier()
    out["after"] = True
    return out


def mesh_of(shape):
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def template(cfg, mesh):
    params, opt_state = init_state(cfg)
    specs = param_specs(params, mesh)
    shard = shardings_for(mesh, {"params": specs, "opt": {
        "m": specs, "v": specs, "step": P()}})
    return {"params": params, "opt": opt_state}, shard


def restored_equal(ckpt, cfg, mesh):
    """Restore the sharded checkpoint onto ``mesh``: leaves whose local
    shard is not bit-equal to its slice of the plain restore."""
    tmpl, shard = template(cfg, mesh)
    got, step, _ = restore_checkpoint(ckpt / "sharded", tmpl, shardings=shard)
    want, _, _ = restore_checkpoint(ckpt / "plain", tmpl, device="cpu")
    bad = [tree_util.path_key(p) for (p, g), w in zip(
        tree_util.flatten_with_paths(got), tree_util.leaves(want))
        if g.dtype != w.dtype or not torch.equal(g.to_local(), w[_index(g)])]
    return step, bad, got


def group_two(rank, world, ckpt):
    """Meshes (2, 1) and (1, 2); the broken control; the checkpoint
    written on (2, 1) and resumed on (1, 2)."""
    from pathlib import Path
    ckpt = Path(ckpt)
    out = {}
    for arch in ARCHS:
        cfg = cfg_of(arch)
        ref = one_device(cfg)
        for shape in ((2, 1), (1, 2)):
            save = ckpt if (arch, shape) == ("llama3.2-1b", (2, 1)) else None
            out[arch, shape] = mesh_run(cfg, mesh_of(shape), ref,
                                        save_to=save)
    out["accum"] = accum_run(cfg_of("moonshot-v1-16b-a3b"), mesh_of((2, 1)))
    out["save_fails"] = failed_saves(cfg_of("llama3.2-1b"), mesh_of((2, 1)),
                                     ckpt / "failing")
    # broken control: gradients summed over 'model' too
    cfg = cfg_of("llama3.2-1b")
    real = train_step_mod._grad_reduce_dims
    train_step_mod._grad_reduce_dims = lambda rules: ("data", "model")
    try:
        out["broken"] = mesh_run(cfg, mesh_of((1, 2)), one_device(cfg))
    finally:
        train_step_mod._grad_reduce_dims = real
    # the (2, 1) checkpoint of step 2, resumed on (1, 2)
    mesh = mesh_of((1, 2))
    step, bad, state = restored_equal(ckpt, cfg, mesh)
    fn = make_train_step(cfg, OPT, torch.float32, remat=True, mesh=mesh)
    _, _, m = fn(state["params"], state["opt"], batches(cfg)[2])
    out["resume"] = {"step": step, "bad": bad, "loss": float(m["loss"]),
                     "uninterrupted": out["llama3.2-1b", (2, 1)]["losses"][2]}
    return out


def group_four(rank, world, ckpt):
    """Mesh (2, 2) for every arch, and the (2, 1) checkpoint restored onto
    it."""
    from pathlib import Path
    out = {}
    mesh = mesh_of((2, 2))
    for arch in ARCHS:
        cfg = cfg_of(arch)
        out[arch, (2, 2)] = mesh_run(cfg, mesh, one_device(cfg))
    step, bad, _ = restored_equal(Path(ckpt), cfg_of("llama3.2-1b"), mesh)
    out["restore"] = {"step": step, "bad": bad}
    return out
