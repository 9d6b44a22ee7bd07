"""Dry-run of every (arch x shape x mesh) cell, as the reference's
``repro/launch/dryrun.py``, with nothing allocated on any device: each
cell's step is traced under ``FakeTensorMode`` on a placeholder mesh
(``launch.mesh.placeholder_mesh``: 16 x 16 ranks, 2 x 16 x 16 for two
pods, over a fake process group), seen from rank 0.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

It runs on the CPU and needs no card. What it records for a cell, one JSON
under ``experiments/dryrun_torch/`` (the reference's records stay in
``experiments/dryrun/``):

  * train cells trace the port's real step, ``make_train_step(cfg,
    OptConfig(), mesh=)``, on ``shard_train_state`` of fake f32 weights:
    the DTensor state, the cast copy gathered over 'data' and laid out
    over the tensor-parallel group, the rank's rows computed
    tensor-parallel over it (its sequence slice of the residual, its
    heads, columns, rows, vocab or experts), the gradients reduced leaf by
    leaf, AdamW on the shards; the group is 'model', or under ``--policy
    tp2d`` (the (16, 8, 2) mesh) the flattened ('model', 'model2') group
    of 16 while the weights are stored over 'model' (8) alone;
  * prefill, decode and long cells trace the mesh steps,
    ``make_prefill_step(cfg, mesh=)`` / ``make_decode_step(cfg, mesh=)``
    (``long=`` for the long cells), on ``shard_serve_state`` of fake bf16
    weights and, for decode, a fake ``zero_cache`` placed as
    ``cache_specs`` says: the rank's rows (over 'data'; all of them under
    "long"), the compute copy gathered and laid out over 'model', the
    prefill tensor-parallel on its sequence slice, its heads (K5-K7's
    plain versions), columns, rows, vocab or experts and the cache moved
    to its sequence slice, a decode step on its cache slice with the
    softmax joined over ``cache_seq`` (``"sharded_compute": true``);
  * ``"tp_compute"``: the size of the group the traced step's compute was
    split over (1 where it was not; the 40 records of the 16 x 16 mesh
    carry it for train cells only);
  * ``counted_flops_per_rank`` (``FlopCounterMode``) beside the reference's
    analytic count (``flops_per_chip``, ``analysis/flops.py``),
    ``peak_bytes_by_kind`` (``MemTracker``, the state passed to it with
    ``track_external``), the collectives by kind with their bytes
    (``analysis/comm_count.py``, counts held equal to ``CommDebugMode``'s)
    and the H100 roofline (``analysis/roofline.py``).

The CUDA kernels are ``ctypes`` calls that no dispatcher mode sees; under
the dry-run the CPU path runs, the kernels' plain versions, and each
record says so (``"kernels": "plain"``). Training launches no kernel, so
train cells lose nothing.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

import torch

from .. import tree as tree_util
from ..analysis.comm_count import CollectiveLog, comm_debug_counts
from ..analysis.flops import step_flops, step_hbm_bytes
from ..analysis.roofline import (H100, model_flops, rank_hbm_bytes,
                                 roofline_terms, summarize_memory)
from ..configs import (ARCH_IDS, SHAPE_BY_NAME, SHAPES, cell_is_runnable,
                       get_config)

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def rules_kind(shape) -> str:
    if shape.kind == "train":
        return "train"
    if shape.name.startswith("long"):
        return "long"
    return shape.kind


def mesh_layout(policy: str = "tp", multi_pod: bool = False):
    """(shape, axes) of the production mesh the reference compiles for;
    ``tp2d`` factors 'model' (8, 2)."""
    if policy == "tp2d":
        return (((2, 16, 8, 2), ("pod", "data", "model", "model2"))
                if multi_pod else ((16, 8, 2), ("data", "model", "model2")))
    return (((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else ((16, 16), ("data", "model")))


@contextmanager
def _placeholder(shape, axes):
    """A placeholder mesh over a fake process group, torn down after."""
    import torch.distributed as dist
    from .mesh import placeholder_mesh
    mesh = placeholder_mesh(shape, axes)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _fake_like(tree):
    """Fake CPU tensors shaped as the ``meta`` tree's (inside the mode)."""
    return tree_util.tree_map(
        lambda m: torch.empty(m.shape, dtype=m.dtype), tree)


def _local_tensors(tree):
    return [getattr(x, "_local_tensor", x) for x in tree_util.leaves(tree)
            if torch.is_tensor(x)]


def trace(cfg, shape, mesh_shape, axes, policy: str = "tp") -> dict:
    """Trace one step of the cell under fake tensors, as rank 0 of a
    placeholder mesh: the rows a rank computes, the counted flops,
    MemTracker's peak snapshot (the step's inputs and state included),
    the collectives, the size of the group the step's compute was split
    over and the seconds the trace took."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    from ..dist.sharding import NamedSharding, Rules, tp_group, use_rules
    from ..models import init_params
    from ..serve.serve_step import (make_decode_step, make_prefill_step,
                                    shard_serve_state, zero_cache)
    from ..train.optimizer import OptConfig
    from ..train.train_step import make_train_step, shard_train_state
    from .specs import batch_specs

    t0 = time.perf_counter()
    n_chips = math.prod(mesh_shape)
    with _placeholder(mesh_shape, axes) as mesh, \
            FakeTensorMode(allow_non_fake_inputs=True):
        rules = Rules(mesh, rules_kind(shape), policy,
                      global_batch=shape.global_batch)
        batch = {}
        B = shape.global_batch
        rows = NamedSharding(mesh, rules.spec("batch")).local_slices((B,))[0]
        rows = rows.stop - rows.start
        if shape.kind == "train":
            state = shard_train_state(_fake_like(init_params(
                cfg, None, torch.float32, device="meta")), None, mesh)
            batch = _fake_like(batch_specs(cfg, shape, rules, "train")[0])
            step = make_train_step(cfg, OptConfig(), mesh=mesh,
                                   accum_steps=cfg.accum_steps,
                                   count_targets=torch.Tensor.numel)

            def run(state):
                return step(*state, batch)[:2]
        else:
            long = rules.kind == "long"
            params = shard_serve_state(_fake_like(init_params(
                cfg, None, torch.bfloat16, device="meta")), mesh, rules, cfg)
            if shape.kind == "prefill":
                batch = _fake_like(batch_specs(cfg, shape, rules,
                                               "prefill")[0])
                prefill = make_prefill_step(cfg, mesh=mesh, long=long)
                state = params

                def run(params):
                    with torch.no_grad():
                        prefill(params, batch)
                    return params
            else:
                cache = zero_cache(cfg, B, shape.seq_len, rules)
                token = torch.empty((B, 1), dtype=torch.int32)
                decode = make_decode_step(cfg, mesh=mesh, long=long)
                state = (params, cache, token)

                def run(state):
                    with torch.no_grad():
                        _, new_cache = decode(*state, shape.seq_len - 1)
                    return state[0], new_cache, state[2]
        tracker = MemTracker()
        tracker.track_external(*_local_tensors((state, batch)))
        with tracker, FlopCounterMode(display=False) as flops, \
                CommDebugMode() as debug, CollectiveLog() as log:
            state = run(state)
        counts = comm_debug_counts(debug)
        collectives = log.summary()
        if counts != collectives["counts"]:
            raise RuntimeError(f"collectives seen {collectives['counts']}, "
                               f"CommDebugMode counted {counts}")
        peak = tracker.get_tracker_snapshot("peak")
        with use_rules(rules):
            grp = tp_group()
    return {"rows": rows, "flops": flops.get_total_flops(), "peak": peak,
            "collectives": collectives,
            "tp_compute": 1 if grp is None else grp.size,
            "trace_s": time.perf_counter() - t0}


def lower_cell(cfg, shape, mesh_shape=(16, 16), axes=("data", "model"), *,
               extra_tag: str = "", policy: str = "tp") -> dict:
    """Trace one cell; returns its record. The collectives are priced at
    the H100 row's link rate (NVLink 4 within a host). The analytic bytes
    a chip are the reference's, which divide the weights by 'model' alone;
    the port's own (``rank_hbm_bytes``) by the compute group."""
    t = trace(cfg, shape, mesh_shape, axes, policy)
    n_chips = math.prod(mesh_shape)
    tp = dict(zip(axes, mesh_shape)).get("model", 1)
    fl = step_flops(cfg, shape, shape.kind)
    flops_per_chip = fl["total"] / n_chips
    mem = summarize_memory(t["peak"])
    peak = mem.pop("peak_est_bytes")
    rank_bytes = rank_hbm_bytes(cfg, shape, shape.kind, n_chips, t["rows"],
                                t["tp_compute"])
    terms = roofline_terms(t["flops"], rank_bytes,
                           t["collectives"]["weighted_bytes"])
    terms.update(hardware=H100.name, link_bw=H100.link_bw)
    mf = model_flops(cfg, shape, shape.kind)
    return {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": "x".join(map(str, mesh_shape)), "mesh_axes": list(axes),
        "n_chips": n_chips, "tag": extra_tag, "policy": policy,
        "kernels": "plain", "sharded_compute": True,
        "tp_compute": t["tp_compute"],
        "rows_per_rank": t["rows"], "trace_s": round(t["trace_s"], 1),
        "flops_per_chip": flops_per_chip,
        "flops_breakdown": fl,
        "counted_flops_per_rank": t["flops"],
        "counted_to_analytic": t["flops"] / flops_per_chip,
        "bytes_per_chip": step_hbm_bytes(cfg, shape, shape.kind, n_chips,
                                         tp),
        "rank_hbm_bytes": rank_bytes,
        "collectives": t["collectives"],
        "roofline": terms,
        "model_flops_total": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flop_ratio": (mf / n_chips) / flops_per_chip
        if flops_per_chip else None,
        "peak_bytes_by_kind": mem,
        "peak_est_bytes": peak,
        "hbm_per_chip_gb": round(peak / 2**30, 3),
        "fits_80gb": peak <= H100.hbm_bytes,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, tag: str = "",
             policy: str = "tp") -> dict:
    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why,
                "mesh": "multi" if multi_pod else "single"}
    if policy == "auto":
        # the reference's choice: per-arch policies for training, the
        # standard TP mesh for inference shapes
        policy = cfg.preferred_policy if shape.kind == "train" else (
            "tp" if cfg.preferred_policy == "tp2d" else cfg.preferred_policy)
    mesh_shape, axes = mesh_layout(policy, multi_pod)
    return lower_cell(cfg, shape, mesh_shape, axes, extra_tag=tag,
                      policy=policy)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--policy", default="tp",
                    choices=("tp", "fsdp", "tp2d", "auto"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = [s.name for s in SHAPES] if args.all or not args.shape \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mtag = "multi" if mp else "single"
                name = f"{arch}_{shape}_{mtag}" + \
                    (f"_{args.tag}" if args.tag else "")
                out = Path(args.out) if args.out else OUT_DIR / f"{name}.json"
                try:
                    rec = run_cell(arch, shape, mp, args.tag, args.policy)
                    out.write_text(json.dumps(rec, indent=1))
                    if "skipped" in rec:
                        print(f"[skip] {name}: {rec['skipped']}")
                    else:
                        r = rec["roofline"]
                        print(f"[ok]   {name}: bound={r['bound']} "
                              f"c={r['compute_s']:.4f}s "
                              f"m={r['memory_s']:.4f}s "
                              f"x={r['collective_s']:.4f}s "
                              f"peak={rec['hbm_per_chip_gb']}GiB "
                              f"trace={rec['trace_s']}s", flush=True)
                except Exception as e:  # noqa: BLE001 — record and continue
                    failures.append(name)
                    out.write_text(json.dumps(
                        {"arch": arch, "shape": shape, "mesh": mtag,
                         "error": f"{type(e).__name__}: {e}"}, indent=1))
                    print(f"[FAIL] {name}: {type(e).__name__}: {e}",
                          flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("\nall cells passed")


if __name__ == "__main__":
    main()
