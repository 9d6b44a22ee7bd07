"""What each gloo rank runs for ``test_torch_mesh_train.py`` and
``test_torch_tp.py`` (through ``torch_ranks.run_ranks``): the port's
training on a ``DeviceMesh``, tensor-parallel over 'model', against its own
one-process run, at reduced configs (2 layers, vocab 128, batch 4 x 32
tokens, f32 compute; whisper with 64 encoder frames, internvl2 with 16
patches ahead of the tokens), with one rank's rows partly masked (-100
targets) so ranks hold different token counts. Each function returns plain
numbers and flags; the test files assert on them."""
import contextlib

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
from repro_torch.train import (OptConfig, draw_sharded_state,
                               init_train_state, make_train_step,
                               shard_train_state)
from repro_torch.train import train_step as train_step_mod

ARCHS = ("llama3.2-1b", "rwkv6-1.6b", "zamba2-1.2b", "moonshot-v1-16b-a3b")
FAMILIES = ("whisper-small", "internvl2-76b")
STEPS, BATCH, SEQ = 3, 4, 32
OPT = OptConfig(lr=1e-3, warmup_steps=1)


def cfg_of(arch):
    return get_config(arch).reduced(n_layers=2, vocab_size=128)


def batches(cfg, seq=SEQ):
    """STEPS global batches; the frames (audio) or the patch embeddings
    (vlm, whose targets then cover the patches) the config takes."""
    import numpy as np
    out = make_lm_batches(cfg, BATCH, seq, STEPS, seed=1)
    rng = np.random.default_rng(1001)
    for b in out:                  # rows 0-1 of the 4 partly masked
        if cfg.encoder is not None:
            b["enc_embeds"] = rng.standard_normal(
                (BATCH, cfg.encoder.enc_seq, cfg.d_model)).astype(np.float32)
        if cfg.vlm is not None:
            P = cfg.vlm.n_patches
            b["embeds"] = rng.standard_normal(
                (BATCH, P, cfg.d_model)).astype(np.float32)
            b["targets"] = np.concatenate([rng.integers(
                0, cfg.vocab_size, (BATCH, P)).astype(np.int32),
                b["targets"]], axis=1)
        b["targets"] = b["targets"].copy()
        b["targets"][0, :] = -100
        b["targets"][1, : seq // 2] = -100
    return out


def init_state(cfg):
    return init_train_state(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def one_device(cfg, bs=None):
    """The port's one-process run: (losses, first-step gradient tree)."""
    params, opt_state = init_state(cfg)
    bs = bs or batches(cfg)
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


def copy_layout(cfg, mesh):
    """Records each leaf's compute copy as the step builds it:
    ``records`` gets (the 'model' dim it is split on or None, the leaf's
    elements, the copy's elements on this rank)."""
    from repro_torch.dist import sharding
    real, records = sharding.gather_for_compute, []

    def counted(w, dim, dtype=None):
        out = real(w, dim, dtype)
        records.append((dim, w.numel(), out.numel()))
        return out
    return counted, real, records


def mesh_run(cfg, mesh, ref, *, save_to=None, bs=None, flops=False,
             then=None):
    """Train STEPS steps on ``mesh``: (loss errors relative to the
    one-device run, first-step gradient errors, storage mismatches, the
    losses, the compute copy's layout of the first step: (split dim,
    leaf elements, local elements) a leaf; with ``flops`` the first
    step's counted flops on this rank; with ``then`` what it returns for
    the params after the last step, under "then"). With ``save_to`` the
    state after step 2 is saved there, and its gathered values as a plain
    one-device save beside it."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.dist import sharding
    ref_losses, ref_grads = ref
    params, opt_state = shard_train_state(*init_state(cfg), mesh)
    bad = storage_mismatches(mesh, params, opt_state)
    step = make_train_step(cfg, OPT, torch.float32, remat=True, mesh=mesh)
    bs = bs or batches(cfg)
    counted, real, layout = copy_layout(cfg, mesh)
    sharding.gather_for_compute = counted
    fc = FlopCounterMode(display=False) if flops else contextlib.nullcontext()
    try:
        with fc:
            _, g = step.grads(params, bs[0])
    finally:
        sharding.gather_for_compute = real
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
            "losses": losses, "layout": layout,
            "flops": fc.get_total_flops() if flops else None,
            "then": None if then is None else then(params)}


def one_device_flops(cfg, bs=None):
    """The counted flops of the one-process step's first step."""
    from torch.utils.flop_counter import FlopCounterMode
    params, opt_state = init_state(cfg)
    step = make_train_step(cfg, OPT, torch.float32, remat=True)
    with FlopCounterMode(display=False) as fc:
        step(params, opt_state, (bs or batches(cfg))[0])
    return fc.get_total_flops()


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
    real, calls = sharding.gather_for_compute, []

    def counted(w, dim, dtype=None):
        calls.append(1)
        return real(w, dim, dtype)
    sharding.gather_for_compute = counted
    try:
        got, gathers = [], []
        for b in batches(cfg):
            calls.clear()
            params, opt_state, m = step(params, opt_state, b)
            got.append(float(m["loss"]))
            gathers.append(len(calls))
    finally:
        sharding.gather_for_compute = real
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


def sharded_draws(mesh):
    """P5: ``draw_sharded_state`` on ``mesh`` for every arch: leaves (of
    params and moments) whose shard or placements differ from the
    one-process draw's placed by ``shard_train_state``."""
    bad = []
    for arch in ARCHS:
        cfg = cfg_of(arch)
        got = draw_sharded_state(cfg, torch.Generator().manual_seed(0), mesh)
        want = shard_train_state(init_state(cfg)[0], None, mesh)
        for (p, g), w in zip(tree_util.flatten_with_paths(got),
                             tree_util.leaves(want)):
            if g.placements != w.placements or g.dtype != w.dtype or \
                    not torch.equal(g.to_local(), w.to_local()):
                bad.append(f"{arch}: {tree_util.path_key(p)}")
    return bad


def draw_peak(mesh):
    """P5: CPU bytes at the peak of one rank's state build (MemTracker),
    the sharded draw's and the whole tree's, beside the largest f32
    leaf, the rank's slices of the state, the leaves that are not drawn
    (norms, constants) and 4 bytes a parameter."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch.models import init_params
    cfg = get_config("llama3.2-1b").reduced(n_layers=4, vocab_size=4096)
    meta = init_params(cfg, None, device="meta")
    out = {"largest": max(x.numel() for x in tree_util.leaves(meta)) * 4,
           "whole_tree": sum(x.numel() for x in tree_util.leaves(meta)) * 4,
           "undrawn": sum(x.numel() * 4 for p, x in
                          tree_util.flatten_with_paths(meta)
                          if "norm" in tree_util.path_key(p)
                          or "ln" in tree_util.path_key(p))}
    builds = {"draw": lambda: draw_sharded_state(
        cfg, torch.Generator().manual_seed(0), mesh),
        "whole": lambda: shard_train_state(init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"), None,
            mesh)}
    for name, build in builds.items():
        tracker = MemTracker()
        with tracker:
            state = build()
        out[name] = tracker.get_tracker_snapshot("peak")[
            torch.device("cpu")]["Total"]
        out["slices"] = sum(x.to_local().numel() * x.element_size()
                            for x in tree_util.leaves(state))
        del state
    return out


def checked_restore(ckpt, cfg, mesh):
    """P6: the elastic restore of the (2, 1) checkpoint onto ``mesh``,
    counting the fletcher64 checks this rank makes: (checks, leaves in
    the checkpoint, leaves not bit-equal to the plain restore)."""
    from repro_torch.ckpt import checkpoint as ckpt_mod
    tmpl, shard = template(cfg, mesh)
    real, calls = ckpt_mod.fletcher64, []
    ckpt_mod.fletcher64 = lambda a: calls.append(a.nbytes) or real(a)
    try:
        got, _, _ = restore_checkpoint(ckpt / "sharded", tmpl,
                                       shardings=shard)
    finally:
        ckpt_mod.fletcher64 = real
    want, _, _ = restore_checkpoint(ckpt / "plain", tmpl, device="cpu")
    bad = [tree_util.path_key(p) for (p, g), w in zip(
        tree_util.flatten_with_paths(got), tree_util.leaves(want))
        if not torch.equal(g.to_local(), w[_index(g)])]
    return {"checks": len(calls), "bytes": sum(calls),
            "leaves": len(tree_util.leaves(want)), "bad": bad}


def corrupted_restore(ckpt, cfg, mesh):
    """P6: the (2, 1) checkpoint copied with one leaf's bytes flipped
    (rank 0 writes it): what this rank's elastic restore raised."""
    import shutil
    src, dst = ckpt / "sharded", ckpt / "corrupt"
    if dist.get_rank() == 0:
        shutil.copytree(src, dst)
        leaf = dst / "step_00000002" / "params__final_norm.npy"
        data = bytearray(leaf.read_bytes())
        data[-4:] = bytes(b ^ 0xFF for b in data[-4:])
        leaf.write_bytes(bytes(data))
    dist.barrier()
    tmpl, shard = template(cfg, mesh)
    try:
        restore_checkpoint(dst, tmpl, shardings=shard)
        return None
    except Exception as e:      # noqa: BLE001 — the outcome is the result
        return f"{type(e).__name__}: {e}"


def group_two(rank, world, ckpt):
    """Meshes (2, 1) and (1, 2) (the audio and vlm families on (1, 2),
    with each arch's counted flops there); the broken control; the
    checkpoint written on (2, 1) and resumed on (1, 2)."""
    from pathlib import Path
    ckpt = Path(ckpt)
    out = {}
    for arch in ARCHS + FAMILIES:
        cfg = cfg_of(arch)
        ref = one_device(cfg)
        out["flops", arch] = one_device_flops(cfg)
        for shape in ((2, 1), (1, 2)):
            if arch in FAMILIES and shape == (2, 1):
                continue
            save = ckpt if (arch, shape) == ("llama3.2-1b", (2, 1)) else None
            out[arch, shape] = mesh_run(cfg, mesh_of(shape), ref,
                                        save_to=save, flops=shape == (1, 2))
    out["accum"] = accum_run(cfg_of("moonshot-v1-16b-a3b"), mesh_of((2, 1)))
    out["save_fails"] = failed_saves(cfg_of("llama3.2-1b"), mesh_of((2, 1)),
                                     ckpt / "failing")
    # broken control: the gradients of the leaves used whole (norms) not
    # summed over 'model', though each rank computed them on its own
    # sequence slice
    cfg = cfg_of("llama3.2-1b")
    real = train_step_mod._grad_reduce_dims
    train_step_mod._grad_reduce_dims = lambda rules, split: ("data",)
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
    out["draws"] = {shape: sharded_draws(mesh_of(shape))
                    for shape in ((2, 1), (1, 2))}
    out["draw_peak"] = draw_peak(mesh_of((2, 1)))
    out["checked"] = checked_restore(ckpt, cfg, mesh)
    out["corrupt"] = corrupted_restore(ckpt, cfg, mesh)
    return out


def group_four(rank, world, ckpt):
    """Mesh (2, 2) for every arch, and the (2, 1) checkpoint restored onto
    it."""
    from pathlib import Path
    out = {}
    mesh = mesh_of((2, 2))
    for arch in ARCHS + FAMILIES:
        cfg = cfg_of(arch)
        out[arch, (2, 2)] = mesh_run(cfg, mesh, one_device(cfg))
    step, bad, _ = restored_equal(Path(ckpt), cfg_of("llama3.2-1b"), mesh)
    out["restore"] = {"step": step, "bad": bad}
    out["draws"] = {(2, 2): sharded_draws(mesh)}
    out["checked"] = checked_restore(Path(ckpt), cfg_of("llama3.2-1b"), mesh)
    return out


# attention layouts over a 'model' of 4 (llama3.2-1b cut, 2 layers): the
# reference's attn_shard_choice is None for (H 4, KV 2), "q" for (6, 6) at
# 32 tokens, and None (nothing fits: replicate) for (6, 6) at 30 tokens,
# which 4 ranks split unevenly (8, 8, 8, 6), with a vocabulary of 130 that
# 4 does not divide (the embedding and the head used whole); "kv" (8, 4)
# and "g" (8, 2) are never returned, and are forced by replacing the
# function
BRANCHES = {"none": (dict(n_heads=4, n_kv_heads=2), 32, None),
            "q": (dict(n_heads=6, n_kv_heads=6, d_head=16), 32, None),
            "nothing_fits": (dict(n_heads=6, n_kv_heads=6, d_head=16,
                                  vocab_size=130), 30, None),
            "kv": (dict(n_heads=8, n_kv_heads=4, d_head=16), 32, "kv"),
            "g": (dict(n_heads=8, n_kv_heads=2, d_head=16), 32, "g")}


# blocks that a 'model' of 4 cannot split, so every rank runs them whole on
# the gathered sequence and keeps its slice: Mamba-2 with 6 SSD heads and an
# MLP whose gate and up are not interleaved (tp_fuse 1), experts 6, rwkv
# with 3 heads and a d_ff of 250
WHOLE = {"zamba2-1.2b": dict(d_model=96, tp_fuse=1),
         "moonshot-v1-16b-a3b": dict(tp_fuse=1, moe=dict(n_experts=6)),
         "rwkv6-1.6b": dict(d_model=96, n_heads=3, d_ff=250)}


def whole_cfg(arch):
    import dataclasses
    kw = dict(WHOLE[arch])
    cfg = get_config(arch)
    if "moe" in kw:
        kw["moe"] = dataclasses.replace(cfg.reduced().moe, **kw["moe"])
    return cfg.reduced(**{"n_layers": 2, "vocab_size": 128, **kw})


def branch_cfg(name):
    kw, seq, _ = BRANCHES[name]
    return get_config("llama3.2-1b").reduced(
        **{"n_layers": 2, "vocab_size": 128, **kw}), seq


def group_tp(rank, world, ref_params):
    """Mesh (1, 4): every arch and family, each attention layout
    (``BRANCHES``, with the choice the port's ``attn_shard_choice`` made),
    the blocks 4 ranks cannot split (``WHOLE``), and the reference's params (``ref_params``, a pickle of llama3.2-1b's
    and moonshot's) trained as ``torch_tp_ref.py`` trains them there."""
    import pickle
    from repro_torch.convert import from_jax
    from repro_torch.dist import sharding
    from repro_torch.models.layers import attn_choice
    mesh = mesh_of((1, 4))
    out = {}
    for arch in ARCHS + FAMILIES:
        cfg = cfg_of(arch)
        out[arch] = mesh_run(cfg, mesh, one_device(cfg))
    real = sharding.attn_shard_choice
    for name, (_, seq, forced) in BRANCHES.items():
        cfg, seq = branch_cfg(name)
        bs = batches(cfg, seq)
        if forced is not None:
            sharding.attn_shard_choice = lambda *a, c=forced: c
        try:
            out[name] = mesh_run(cfg, mesh, one_device(cfg, bs), bs=bs)
            out[name]["choice"] = attn_choice(cfg, 4, seq)
        finally:
            sharding.attn_shard_choice = real
    for arch in WHOLE:
        cfg = whole_cfg(arch)
        out["whole", arch] = mesh_run(cfg, mesh, one_device(cfg))
    with open(ref_params, "rb") as f:
        ref = pickle.load(f)
    for arch, params in ref["params"].items():
        cfg = cfg_of(arch)
        p, opt_state = shard_train_state(from_jax(params, "cpu"), None, mesh)
        step = make_train_step(cfg, OPT, torch.float32, remat=True,
                               mesh=mesh)
        losses = []
        for b in ref["batches"][arch]:
            p, opt_state, m = step(p, opt_state, b)
            losses.append(float(m["loss"]))
        out["ref", arch] = losses
    return out


def group_one(rank, world):
    """One rank, a (1, 1) mesh: three bf16 steps of every arch and family
    through the tensor-parallel path over a 'model' of one, and through
    the one-process step (no mesh): the losses of each."""
    mesh = mesh_of((1, 1))
    out = {}
    for arch in ARCHS + FAMILIES:
        cfg = cfg_of(arch)
        runs = []
        for m in (None, mesh):
            params, opt_state = init_state(cfg)
            if m is not None:
                params, opt_state = shard_train_state(params, opt_state, m)
            step = make_train_step(cfg, OPT, torch.bfloat16, remat=True,
                                   mesh=m)
            losses = []
            for b in batches(cfg):
                params, opt_state, met = step(params, opt_state, b)
                losses.append(float(met["loss"]))
            runs.append(losses)
        out[arch] = runs
    return out
