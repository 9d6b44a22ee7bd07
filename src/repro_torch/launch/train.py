"""Training entry point: data pipeline -> train loop -> async checkpoints, as
the reference's ``repro/launch/train.py``, on ``cuda`` unless the caller
asks for the CPU.

    python -m repro_torch.launch.train --arch llama3.2-1b --device cpu --steps 20
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch llama3.2-1b --device cpu

Reduced configs by default; ``--full`` runs the published config. One
process trains on one device. Several (``WORLD_SIZE`` > 1, as
``torch.distributed.run`` and the SLURM pod script set it) join a process
group, NCCL on ``cuda:LOCAL_RANK`` or gloo for ``--device cpu``, and train
on a ``DeviceMesh``: the production mesh at 256 ranks (two pods at 512),
else every rank on 'data' (``make_data_mesh()``: the compute is not
tensor-parallel yet, so ranks on 'model' would repeat each other's
work). The weights and AdamW moments are stored sharded by the
reference's specs; every rank draws the weights on the host from the
seeded CPU generator one leaf at a time, keeping only its slice on its
device (``draw_sharded_state``), and every rank reads the global batch
and keeps its rows, so a restart replays the same rows on any layout.
Each rank's card still holds the whole bf16 compute copy and gradient
during a step (``train/train_step.py``), so a config whose weights do not
fit one card twice over in bf16 cannot start (the dry-run's records give
each cell's peak a rank: ``launch/dryrun.py``). Fault tolerance: resume from the latest
checkpoint (``--resume``, onto whatever layout this run has), async
saves, deterministic data.
"""
from __future__ import annotations

import argparse
import os
import time
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ckpt import CheckpointManager, latest_step, restore_checkpoint
from ..configs import get_config
from ..data import DataPipeline, ShardedTokenSource
from ..device import resolve_device
from ..train import OptConfig, init_train_state, make_train_step


def dist_env(environ: Optional[Mapping[str, str]] = None) -> Dict:
    """The launcher's view of the torchrun / SLURM variables: ``world``
    (``WORLD_SIZE``, default 1), ``rank`` (``RANK``), ``local_rank``
    (``LOCAL_RANK``), ``addr`` (``MASTER_ADDR``) and ``port``
    (``MASTER_PORT``)."""
    env = os.environ if environ is None else environ
    return {"world": int(env.get("WORLD_SIZE", "1")),
            "rank": int(env.get("RANK", "0")),
            "local_rank": int(env.get("LOCAL_RANK", "0")),
            "addr": env.get("MASTER_ADDR", "127.0.0.1"),
            "port": int(env.get("MASTER_PORT", "29500"))}


def init_process_group(env: Dict, device) -> torch.device:
    """Join the process group ``env`` describes: NCCL on ``cuda:
    LOCAL_RANK`` for a cuda ``device``, gloo on the CPU. Returns the rank's
    device. Without a card a cuda launch raises; it never falls back to
    gloo."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", env["local_rank"])
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{env['addr']}:{env['port']}",
        world_size=env["world"], rank=env["rank"],
        device_id=dev if dev.type == "cuda" else None)
    return dev


def default_mesh():
    """The mesh by world size: the reference's production mesh at 256
    ranks, two pods at 512, else every rank on 'data' of an (N, 1) mesh
    (data parallelism). A (1, N) mesh would split each step's compute N
    ways over 'model' (tensor-parallel, ``train/train_step.py``) rather
    than repeat it; below the production sizes the data mesh is kept, as
    it moves no activations between ranks."""
    from .mesh import make_data_mesh, make_production_mesh
    world = dist.get_world_size()
    if world in (256, 512):
        return make_production_mesh(multi_pod=world == 512)
    return make_data_mesh()


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 128,
          data_dir: str = "data", ckpt_dir: str = "ckpt",
          reduced: bool = True, ckpt_every: int = 50, resume: bool = False,
          lr: float = 3e-4, log_every: int = 10, seed: int = 0,
          device=None, mesh=None):
    """Train ``arch`` for ``steps`` steps; returns (params, the losses of
    the steps this call ran). Weights come from a CPU ``torch.Generator``
    seeded ``seed``; ``device`` None means ``cuda``. ``mesh`` (a
    ``DeviceMesh`` over a process group the caller owns) trains sharded on
    it; without one, ``WORLD_SIZE`` > 1 joins (and on exit leaves) a
    process group and takes :func:`default_mesh`. Params come back as
    DTensors when sharded."""
    own_group = False
    if mesh is None and dist_env()["world"] > 1:
        dev = init_process_group(dist_env(), device)
        own_group = True
    try:
        if own_group:
            mesh = default_mesh()
        elif mesh is not None:
            from ..dist.sharding import mesh_device
            dev = mesh_device(mesh)
        else:
            dev = resolve_device(device)
        return _train(arch, steps=steps, batch=batch, seq=seq,
                      data_dir=data_dir, ckpt_dir=ckpt_dir, reduced=reduced,
                      ckpt_every=ckpt_every, resume=resume, lr=lr,
                      log_every=log_every, seed=seed, dev=dev, mesh=mesh)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(arch, *, steps, batch, seq, data_dir, ckpt_dir, reduced,
           ckpt_every, resume, lr, log_every, seed, dev, mesh):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    lead = mesh is None or dist.get_rank() == 0
    data_path = Path(data_dir)
    if lead and not (data_path / ShardedTokenSource.MANIFEST).exists():
        ShardedTokenSource.synthesize(
            data_path, n_shards=4,
            tokens_per_shard=max(batch * (seq + 1) * 8, 65536),
            vocab_size=cfg.vocab_size, seed=seed)
    if mesh is not None:
        dist.barrier()                  # rank 0 wrote the shards
    src = ShardedTokenSource(data_path)
    pipe = DataPipeline(src, batch=batch, seq_len=seq, seed=seed)

    gen = torch.Generator().manual_seed(seed)
    shardings = None
    if mesh is None:
        params, opt_state = init_train_state(cfg, gen, device=dev)
    else:
        from ..dist.sharding import P, param_specs, shardings_for
        from ..train import draw_sharded_state
        # drawn on the host leaf by leaf: only this rank's slices are kept
        params, opt_state = draw_sharded_state(cfg, gen, mesh)
        specs = param_specs(params, mesh)
        shardings = shardings_for(mesh, {"params": specs, "opt": {
            "m": specs, "v": specs, "step": P()}})
        if lead:
            print(f"mesh {tuple(mesh.shape)} over "
                  f"{', '.join(mesh.mesh_dim_names)}: "
                  f"{dist.get_world_size()} ranks, "
                  f"{dist.get_backend()}", flush=True)
    opt = OptConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                    total_steps=steps)
    step_fn = make_train_step(cfg, opt, mesh=mesh)
    mgr = CheckpointManager(ckpt_dir, keep=2, digest=cfg.digest())

    start = 0
    if resume and latest_step(ckpt_dir) is not None:
        restored, start, _ = restore_checkpoint(
            ckpt_dir, {"params": params, "opt": opt_state},
            shardings=shardings, device=dev)
        params, opt_state = restored["params"], restored["opt"]
        if lead:
            print(f"resumed from step {start}")

    where = dev if mesh is None else f"mesh {tuple(mesh.shape)} of {dev.type}"
    t0 = time.time()
    losses = []
    for s in range(start, steps):
        params, opt_state, m = step_fn(params, opt_state, pipe.batch_at(s))
        losses.append(float(m["loss"]))
        if (s + 1) % log_every == 0:
            tok_s = batch * seq * log_every / (time.time() - t0)
            if lead:
                print(f"step {s+1:5d}  loss "
                      f"{np.mean(losses[-log_every:]):.4f}  acc "
                      f"{float(m['acc']):.3f}  gnorm "
                      f"{float(m['grad_norm']):.2f}  lr "
                      f"{float(m['lr']):.2e}  {tok_s:,.0f} tok/s on {where}",
                      flush=True)
            t0 = time.time()
        if (s + 1) % ckpt_every == 0 or s + 1 == steps:
            mgr.save_async(s + 1, {"params": params, "opt": opt_state},
                           extra={"loss": float(m["loss"])})
    mgr.wait()
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--ckpt-dir", default="ckpt")
    ap.add_argument("--full", action="store_true",
                    help="the full published config")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
          data_dir=args.data_dir, ckpt_dir=args.ckpt_dir,
          reduced=not args.full, resume=args.resume, lr=args.lr,
          device=args.device)


if __name__ == "__main__":
    main()
