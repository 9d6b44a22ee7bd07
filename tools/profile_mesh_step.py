#!/usr/bin/env python3
"""Time and profile the training step of chip_smoke's phases 5c and 5e on
one GPU: llama3.2-1b at its published config, 4 x 2,048 tokens, bf16
compute with remat, AdamW, once without a mesh and once on a (1, 1)
DeviceMesh of one NCCL rank, whose compute takes the tensor-parallel path
over a 'model' of one (its gathers, scatters and all-to-alls run on a
group of one).

    python3 tools/profile_mesh_step.py [--steps 5] [--src PATH] [--tag NAME]

Run from a checkout of the repository, on a card. ``--src`` imports the
port from another tree's ``src`` (a parent commit unpacked with ``git
archive``), so two versions are compared in one call. For each path the
script draws the state from seed 0, runs two warm-up steps, times
``--steps`` steps (``perf_counter`` around each, synchronized) and traces
one more under ``torch.profiler``. It prints the card's name and power
limit, each path's step times and median, each path's 20 CUDA kernels and
collectives with the most device time, and the 20 largest per-name
differences of device time between the mesh step and the plain one (the
sum of their device times beside the difference of the medians, which is
what the profile does not see: host time and gaps).
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH, BATCH, SEQ = "llama3.2-1b", 4, 2048


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def batches(cfg, n: int):
    import torch
    g = torch.Generator().manual_seed(0)
    out = []
    for _ in range(n):
        t = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), generator=g)
        out.append({"tokens": t[:, :-1].cuda(), "targets": t[:, 1:].cuda()})
    return out


def device_times(prof) -> dict:
    """Self device time (us) by kernel name, over the traced step."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0:
            out[e.key] = out.get(e.key, 0.0) + t
    return out


def run_path(cfg, step_fn, params, opt_state, data, steps: int):
    import torch
    from torch.profiler import ProfilerActivity, profile
    for b in data[:2]:
        params, opt_state, _ = step_fn(params, opt_state, b)
    times = []
    for b in data[2:2 + steps]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, opt_state, m = step_fn(params, opt_state, data[-1])
        torch.cuda.synchronize()
    return times, device_times(prof), float(m["loss"])


def show(title: str, times, dev):
    print(f"{title}: step s {times}, median {statistics.median(times)}; "
          f"device time in the traced step {sum(dev.values()) / 1e3} ms")
    for name, t in sorted(dev.items(), key=lambda kv: -kv[1])[:20]:
        print(f"    {t / 1e3:10.3f} ms  {name[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import (OptConfig, draw_sharded_state,
                                   init_train_state, make_train_step)
    print(f"{card()}; torch {torch.__version__}; port from {args.src} "
          f"({args.tag})")
    cfg = get_config(ARCH)
    opt = OptConfig(lr=3e-4, warmup_steps=2, total_steps=100)
    data = batches(cfg, 3 + args.steps)
    params, opt_state = init_train_state(
        cfg, torch.Generator().manual_seed(0), device="cuda")
    plain = run_path(cfg, make_train_step(cfg, opt, torch.bfloat16,
                                          remat=True),
                     params, opt_state, data, args.steps)
    del params, opt_state
    torch.cuda.empty_cache()
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            mesh = make_local_mesh()
            params, opt_state = draw_sharded_state(
                cfg, torch.Generator().manual_seed(0), mesh)
            meshed = run_path(cfg, make_train_step(
                cfg, opt, torch.bfloat16, remat=True, mesh=mesh),
                params, opt_state, data, args.steps)
            del params, opt_state
        finally:
            dist.destroy_process_group()
    show(f"[{args.tag}] plain step (no mesh)", plain[0], plain[1])
    show(f"[{args.tag}] mesh step, (1, 1) NCCL mesh", meshed[0], meshed[1])
    diff = {k: meshed[1].get(k, 0.0) - plain[1].get(k, 0.0)
            for k in set(plain[1]) | set(meshed[1])}
    gap = statistics.median(meshed[0]) - statistics.median(plain[0])
    print(f"[{args.tag}] mesh - plain: median step {gap * 1e3} ms, device "
          f"time {sum(diff.values()) / 1e3} ms; losses of the traced step "
          f"{plain[2]} / {meshed[2]}; largest differences:")
    for name, t in sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:20]:
        print(f"    {t / 1e3:+10.3f} ms  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
