#!/usr/bin/env python3
"""Time and profile the training step of chip_smoke's phases 5c and 5e, or
(``--serve``) the serving of its phases 5b and 5h, on one GPU, once
without a mesh and once on a (1, 1) DeviceMesh of one NCCL rank, whose
compute takes the tensor-parallel path over a 'model' of one (its
gathers, scatters, all-to-alls and all-reduces run on a group of one).

    python3 tools/profile_mesh_step.py [--steps 5] [--src PATH] [--tag NAME]
    python3 tools/profile_mesh_step.py --serve [--arch A ...] [--new 9]

Run from a checkout of the repository, on a card. ``--src`` imports the
port from another tree's ``src`` (a parent commit unpacked with ``git
archive``), so two versions are compared in one call. It prints the
card's name and power limit first.

Training: llama3.2-1b at its published config, 4 x 2,048 tokens, bf16
compute with remat, AdamW. For each path the script draws the state from
seed 0, runs two warm-up steps, times ``--steps`` steps (``perf_counter``
around each, synchronized) and traces one more under ``torch.profiler``.
It prints each path's step times and median, each path's 20 CUDA kernels
and collectives with the most device time, and the 20 largest per-name
differences of device time between the mesh step and the plain one (the
sum of their device times beside the difference of the medians, which is
what the profile does not see: host time and gaps).

Serving: ``serve_batch`` of each ``--arch`` at its published config,
bf16 weights from seed 0, 4 prompts of 2,000 tokens. For each path it
serves 1 and ``--new`` new tokens, each once to warm up, once timed
(synchronized) and once under ``torch.profiler``; the decode's share is
the difference of the two, over ``--new`` - 1 tokens. It prints for each
path the decode's wall ms a token, its device ms a token (the traced
kernels' and copies' time) and the rest (host time the device waits
out), the device operations, aten calls and collectives a token (and
the mesh path's uncovered ms over the plain one's for each collective
it adds), and the 12 largest per-name differences of decode device
time, mesh less plain.
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


def _on_device(e) -> bool:
    """Whether a profiler row is the card's own (a kernel, copy or set),
    not a host op, whose self device time repeats its kernels'."""
    from torch.autograd import DeviceType
    return e.device_type == DeviceType.CUDA


def device_times(prof) -> dict:
    """Device time (us) by kernel name, over the traced run."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0 and _on_device(e):
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


SERVE_ARCHS = ("rwkv6-1.6b", "zamba2-1.2b", "llama3.2-1b")
SERVE_BATCH, SERVE_PROMPT = 4, 2000


def counts(prof) -> dict:
    """Device operations, aten calls and collectives (the host's
    ``nccl:`` records) in a trace."""
    out = {"device ops": 0, "aten calls": 0, "collectives": 0}
    for e in prof.key_averages():
        if _on_device(e):
            out["device ops"] += e.count
        elif e.key.startswith("nccl:"):
            out["collectives"] += e.count
        elif e.key.startswith("aten::"):
            out["aten calls"] += e.count
    return out


def serve_path(arch, prompts, new: int, **kw):
    """Wall seconds, device times and counts of ``serve_batch`` of 1 and
    of ``new`` new tokens (each warmed up, timed, then traced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as serve_mod
    out = {}
    for n in (1, new):
        def run():
            serve_mod.serve_batch(arch, prompts, n, reduced=False, **kw)
            torch.cuda.synchronize()
        run()
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        out[n] = (wall, device_times(prof), counts(prof))
    return out


def decode_share(runs, new: int):
    """A decode token's wall ms, device ms by name and counts: the run of
    ``new`` new tokens less the run of one, over ``new`` - 1 tokens."""
    (w1, d1, c1), (wn, dn, cn) = runs[1], runs[new]
    per = new - 1
    dev = {k: (dn.get(k, 0.0) - d1.get(k, 0.0)) / per
           for k in set(d1) | set(dn)}
    return (1e3 * (wn - w1) / per, dev,
            {k: (cn[k] - c1[k]) / per for k in cn})


def serve(args) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_params
    from repro_torch.serve import shard_serve_state
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            mesh = make_local_mesh()
            for arch in args.arch:
                cfg = get_config(arch)
                params = init_params(cfg, torch.Generator().manual_seed(0),
                                     torch.bfloat16, "cuda")
                prompts = np.random.default_rng(7).integers(
                    0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                    dtype=np.int32)
                rules = sharding.Rules(mesh, "decode",
                                       global_batch=SERVE_BATCH)
                placed = shard_serve_state(params, mesh, rules, cfg)
                got = {}
                for what, kw in (("plain", dict(device="cuda",
                                                params=params)),
                                 ("mesh", dict(mesh=mesh, params=placed))):
                    got[what] = decode_share(serve_path(
                        arch, prompts, args.new, **kw), args.new)
                    wall, dev, cnt = got[what]
                    d = sum(dev.values()) / 1e3
                    print(f"[{args.tag}] {arch} {what} decode: {wall} ms a "
                          f"token wall, {d} ms device, {wall - d} ms not "
                          f"covered by device work; a token {cnt}",
                          flush=True)
                diff = {k: got["mesh"][1].get(k, 0.0)
                        - got["plain"][1].get(k, 0.0)
                        for k in set(got["mesh"][1]) | set(got["plain"][1])}
                dw = got["mesh"][0] - got["plain"][0]
                dd = sum(diff.values()) / 1e3
                dc = got["mesh"][2]["collectives"] \
                    - got["plain"][2]["collectives"]
                print(f"[{args.tag}] {arch} mesh - plain, a decode token: "
                      f"wall {dw} ms, device {dd} ms, uncovered {dw - dd} "
                      f"ms over {dc} more collectives "
                      f"({(dw - dd) / dc if dc else None} ms each); "
                      f"largest differences:")
                for name, t in sorted(diff.items(),
                                      key=lambda kv: -abs(kv[1]))[:12]:
                    print(f"    {t / 1e3:+10.4f} ms  {name[:110]}")
                del params, placed
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--arch", nargs="+", default=list(SERVE_ARCHS))
    ap.add_argument("--new", type=int, default=9)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 1
    print(f"{card()}; torch {torch.__version__}; port from {args.src} "
          f"({args.tag})")
    return serve(args) if args.serve else train(args)


def train(args) -> int:
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import (OptConfig, draw_sharded_state,
                                   init_train_state, make_train_step)
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
