"""Training entry point: data pipeline -> train loop -> async checkpoints, as
the reference's ``repro/launch/train.py``, on ``cuda`` unless the caller
asks for the CPU.

    python -m repro_torch.launch.train --arch llama3.2-1b --device cpu --steps 20

Reduced configs by default; ``--full`` runs the published config on the one
card. Fault tolerance: resume from the latest checkpoint (``--resume``),
async saves, deterministic data (a restart replays the same batch
sequence).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..ckpt import CheckpointManager, latest_step, restore_checkpoint
from ..configs import get_config
from ..data import DataPipeline, ShardedTokenSource
from ..device import resolve_device
from ..train import OptConfig, init_train_state, make_train_step


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 128,
          data_dir: str = "data", ckpt_dir: str = "ckpt",
          reduced: bool = True, ckpt_every: int = 50, resume: bool = False,
          lr: float = 3e-4, log_every: int = 10, seed: int = 0,
          device=None):
    """Train ``arch`` for ``steps`` steps; returns (params, the losses of
    the steps this call ran). Weights come from a CPU ``torch.Generator``
    seeded ``seed``; ``device`` None means ``cuda``."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    data_path = Path(data_dir)
    if not (data_path / ShardedTokenSource.MANIFEST).exists():
        ShardedTokenSource.synthesize(
            data_path, n_shards=4,
            tokens_per_shard=max(batch * (seq + 1) * 8, 65536),
            vocab_size=cfg.vocab_size, seed=seed)
    src = ShardedTokenSource(data_path)
    pipe = DataPipeline(src, batch=batch, seq_len=seq, seed=seed)

    params, opt_state = init_train_state(
        cfg, torch.Generator().manual_seed(seed), device=dev)
    opt = OptConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                    total_steps=steps)
    step_fn = make_train_step(cfg, opt)
    mgr = CheckpointManager(ckpt_dir, keep=2, digest=cfg.digest())

    start = 0
    if resume and latest_step(ckpt_dir) is not None:
        restored, start, _ = restore_checkpoint(
            ckpt_dir, {"params": params, "opt": opt_state}, device=dev)
        params, opt_state = restored["params"], restored["opt"]
        print(f"resumed from step {start}")

    t0 = time.time()
    losses = []
    for s in range(start, steps):
        params, opt_state, m = step_fn(params, opt_state, pipe.batch_at(s))
        losses.append(float(m["loss"]))
        if (s + 1) % log_every == 0:
            tok_s = batch * seq * log_every / (time.time() - t0)
            print(f"step {s+1:5d}  loss {np.mean(losses[-log_every:]):.4f}  "
                  f"acc {float(m['acc']):.3f}  gnorm "
                  f"{float(m['grad_norm']):.2f}  lr {float(m['lr']):.2e}  "
                  f"{tok_s:,.0f} tok/s on {dev}", flush=True)
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
                    help="the full published config, on the one card")
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
