"""The port's dry-run (``repro_torch.launch.dryrun``) and its records
(``experiments/dryrun_torch/``), on the CPU.

Every trace runs in a fresh interpreter: ``placeholder_mesh`` replaces the
process group of its process with a fake one, which must never happen in
a test process that may hold a gloo group.

  * A reduced config's train step, traced on a (2, 2) placeholder mesh,
    issues the collectives ``train/train_step.py`` implies, with their
    bytes: first, per leaf of the cast copy, an all-gather over 'data'
    where the specs shard it there and its move over 'model' to the
    layout ``compute_model_dims`` gives (an all-gather where it is used
    whole, an all-to-all where it is split on another dim); last, one
    all-reduce of the step's metrics, per gradient leaf its move back
    over 'model' and its sum (a reduce-scatter where the storage shards
    the summed axis, an all-reduce where it replicates it: over 'data',
    and over 'model' for a leaf used whole), and the global norm's
    all-reduces; between them the tensor-parallel forward's and
    backward's collectives (the sequence gathers and scatters, the loss's
    reductions, moe's router sums and batch means, Mamba-2's norm moments:
    ``_expected_middle``), each over a group of 2.
  * The committed llama3.2-1b x train_4k record, regenerated through the
    CLI, equals the committed one in every count, its counted flops
    within 2 %.
  * The 40 committed records parse, cover every (arch x shape) cell, skip
    what ``cell_is_runnable`` skips, and give the reference's analytic
    numbers where the reference's records have them.
  * The report renders.
"""
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest

from repro_torch.analysis import report
from repro_torch.configs import (ARCH_IDS, SHAPES, cell_is_runnable,
                                 get_config)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
RECORDS = ROOT / "experiments" / "dryrun_torch"
REF_RECORDS = ROOT / "experiments" / "dryrun"
ARCHS = ("llama3.2-1b", "moonshot-v1-16b-a3b", "zamba2-1.2b")
BATCH, SEQ = 4, 32

_TRACE = """
import json, sys
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.dryrun import lower_cell
out = {}
for arch in sys.argv[1:]:
    cfg = get_config(arch).reduced(n_layers=2, vocab_size=128)
    out[arch] = lower_cell(cfg, ShapeConfig("tiny", %d, %d, "train"),
                           (2, 2), ("data", "model"))
print(json.dumps(out))
""" % (SEQ, BATCH)


def _run(args, timeout=300):
    out = subprocess.run([sys.executable] + args, capture_output=True,
                         text=True, timeout=timeout,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


@pytest.fixture(scope="module")
def small():
    return json.loads(_run(["-c", _TRACE, *ARCHS]).splitlines()[-1])


def _expected(cfg):
    """The (op, bytes) multisets one step on a (2, 2) ('data', 'model')
    mesh must issue before its forward (the compute copy) and after its
    backward (the metrics, the gradients, the global norm), from the specs
    and the compute copy's layout alone."""
    from torch.distributed.tensor import Shard
    from repro_torch import tree as tree_util
    from repro_torch.dist.sharding import MeshShape, param_specs, \
        placements_for
    from repro_torch.models import compute_model_dims, init_params
    mesh = MeshShape((2, 2), ("data", "model"))
    meta = init_params(cfg, None, device="meta")
    specs = param_specs(meta, mesh)
    dims = compute_model_dims(cfg, meta, 2)
    first, last, norm_groups = Counter(), Counter(), Counter()
    last["all-reduce", 2 * 4] += 1                  # loss and accuracy
    for path, leaf in tree_util.flatten_with_paths(meta):
        pl = placements_for(tree_util.at(specs, path), mesh)
        d = tree_util.at(dims, path)
        n = leaf.numel()
        size = 2 if leaf.dim() > 1 else 4           # the cast copy
        data, model = pl
        s = model.dim if isinstance(model, Shard) else None
        if isinstance(data, Shard):
            first["all-gather", n * size // (1 if s is None else 2)] += 1
        if d is None and s is not None:
            first["all-gather", n * size] += 1
        elif None not in (d, s) and d != s:
            first["all-to-all", n * size // 2] += 1
        g = n * 4                # the gradient, summed in f32
        if d is None:
            summed = (data, model)
        else:                    # moved back in the copy's dtype
            if s is None:
                last["all-gather", n * size] += 1
            else:
                g //= 2
                if d != s:
                    last["all-to-all", n * size // 2] += 1
            summed = (data,)
        for p in summed:
            kind = "reduce-scatter" if isinstance(p, Shard) else "all-reduce"
            last[kind, g] += 1
            g //= 2 if isinstance(p, Shard) else 1
        norm_groups[tuple(i for i, p in enumerate(pl)
                          if isinstance(p, Shard))] += 1
    for groups, k in norm_groups.items():           # the global norm
        for _ in groups:
            last["all-reduce", 4 * k] += 1
    return first, last


def _expected_middle(cfg):
    """The (op, bytes) multiset of the tensor-parallel forward and
    backward on (2, 2): a rank's rows, with the vocabulary and every block
    split over 'model'.

    * Each block (attention, the MLP or MoE, a Mamba-2 layer) all-gathers
      the sequence in and reduce-scatters it out, (B, S, D) in bf16: in
      the forward, again in remat's recompute of its layer (which stops
      before the layer's last reduce-scatter: nothing after it is saved)
      and, reversed, in the backward. The embedding's reduce-scatter and
      the loss's all-gather add one of each, and their backward one more.
    * The vocab-parallel loss all-reduces (B, S) rows: the logsumexp's max
      and sum, the target's logit and the argmax's max in f32, its min of
      int64 candidates; the first three again in the chunk's recompute.
    * Per moe layer, the router's two sums over 'model' and two batch
      means over 'data', (E,) f32, in the forward and the recompute.
    * Per Mamba-2 layer, the gated norm's moment, (B, S) f32, in the
      forward, the recompute and the backward."""
    rows = BATCH // 2
    seq = rows * SEQ * cfg.d_model * 2
    f32 = rows * SEQ * 4
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        blocks = [1 + 2 * (i % every == every - 1)
                  for i in range(cfg.n_layers)]
    else:
        blocks = [2] * cfg.n_layers
    mid = Counter()
    mid["all-gather", seq] += sum(3 * b for b in blocks) + 2
    mid["reduce-scatter", seq] += sum(3 * b - 1 for b in blocks) + 2
    mid["all-reduce", f32] += 7
    mid["all-reduce", 2 * f32] += 1
    if cfg.moe is not None:
        mid["all-reduce", cfg.moe.n_experts * 4] += 8 * cfg.n_layers
    if cfg.family == "hybrid":
        mid["all-reduce", f32] += 3 * cfg.n_layers
    return mid


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_are_the_ones_the_specs_imply(small, arch):
    cfg = get_config(arch).reduced(n_layers=2, vocab_size=128)
    rec = small[arch]
    ops = [(o["op"], o["bytes"]) for o in rec["collectives"]["ops"]]
    first, last = _expected(cfg)
    k, m = sum(first.values()), sum(last.values())
    assert Counter(ops[:k]) == first
    assert Counter(ops[-m:]) == last
    assert Counter(ops[k:-m]) == _expected_middle(cfg)
    assert rec["tp_compute"] == 2
    assert all(o["group"] == 2 for o in rec["collectives"]["ops"])
    c = rec["collectives"]
    assert c["weighted_bytes"] == c["raw_bytes"] + c["per_op"]["all-reduce"]


@pytest.mark.parametrize("arch", ARCHS)
def test_small_record_counts_the_step(small, arch):
    """Rows split over 'data'; counted flops above half the model's
    6·N·T of the rank's rows (the two 'model' ranks split the work, remat
    adds a forward); the peak holds the rank's state, which MemTracker
    was given."""
    cfg = get_config(arch).reduced(n_layers=2, vocab_size=128)
    rec = small[arch]
    assert rec["rows_per_rank"] == BATCH // 2
    assert rec["sharded_compute"] is True and rec["kernels"] == "plain"
    assert rec["n_chips"] == 4 and rec["mesh"] == "2x2"
    model = 6 * cfg.n_active_params() * BATCH // 2 * SEQ
    assert rec["counted_flops_per_rank"] > model / 2
    state = 3 * 4 * cfg.n_params() / 4            # f32 masters and moments
    assert rec["peak_bytes_by_kind"]["other"] >= state
    assert rec["peak_est_bytes"] > state
    assert rec["roofline"]["bound"] in ("compute", "memory", "collective")


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "cell.json"
    _run(["-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b",
          "--shape", "train_4k", "--out", str(out)])
    return json.loads(out.read_text())


def test_full_size_record_regenerates(regenerated):
    """llama3.2-1b x train_4k on the 16 x 16 placeholder mesh, traced
    again: every count equal to the committed record's (collectives op
    by op, bytes, peak by kind, analytic flops and bytes), counted flops
    within 2 %."""
    want = json.loads(
        (RECORDS / "llama3.2-1b_train_4k_single.json").read_text())
    got = dict(regenerated)
    for r in (got, want):
        r.pop("trace_s")
    assert got.pop("collectives") == want.pop("collectives")
    assert abs(got["counted_flops_per_rank"] /
               want["counted_flops_per_rank"] - 1) <= 0.02
    for k in ("counted_flops_per_rank", "counted_to_analytic", "roofline"):
        got.pop(k), want.pop(k)
    assert got == want


def _committed():
    return {p.name: json.loads(p.read_text())
            for p in sorted(RECORDS.glob("*_single.json"))}


def test_committed_records_cover_every_cell():
    recs = _committed()
    assert len(recs) == len(ARCH_IDS) * len(SHAPES) == 40
    for arch in ARCH_IDS:
        for s in SHAPES:
            r = recs[f"{arch}_{s.name}_single.json"]
            assert (r["arch"], r["shape"]) == (arch, s.name)
            assert "error" not in r, r
            ok, why = cell_is_runnable(get_config(arch), s)
            if not ok:
                assert r["skipped"] == why
                continue
            for key in ("counted_flops_per_rank", "peak_bytes_by_kind",
                        "fits_80gb", "trace_s", "collectives", "roofline"):
                assert key in r, (arch, s.name, key)
            assert r["kernels"] == "plain"
            assert r["sharded_compute"] is (s.kind == "train")
            assert r["counted_flops_per_rank"] > 0
            assert r["fits_80gb"] is (r["peak_est_bytes"] <= 80e9)


def test_committed_records_carry_the_reference_counts():
    """Where the reference's own records (``experiments/dryrun/``) have a
    cell, its analytic flops and bytes a chip, model flops and useful
    ratio are the port's record's, exactly."""
    keys = ("flops_per_chip", "flops_breakdown", "bytes_per_chip",
            "model_flops_total", "model_flops_per_chip",
            "useful_flop_ratio", "n_chips", "mesh", "mesh_axes")
    for name, r in _committed().items():
        ref = json.loads((REF_RECORDS / name).read_text())
        assert ("skipped" in r) == ("skipped" in ref), name
        if "skipped" not in r:
            assert {k: r[k] for k in keys} == {k: ref[k] for k in keys}, name


def test_report_renders(capsys):
    from repro_torch.analysis.__main__ import main
    recs = report.load_records("single")
    table = report.roofline_table(recs)
    assert len(table.splitlines()) == 2 + 40
    assert "fits 80 GB" in table.splitlines()[0]
    main([])
    out = capsys.readouterr().out
    assert "40 cells" in out and "| llama3.2-1b | train_4k |" in out
    main(["--collectives", "llama3.2-1b", "train_4k"])
    out = capsys.readouterr().out
    assert "| all-gather |" in out and "| reduce-scatter |" in out
    rec = next(r for r in recs if (r["arch"], r["shape"]) ==
               ("llama3.2-1b", "train_4k"))
    top = report.collective_breakdown(rec, top=3)
    assert [o["bytes"] for o in top] == sorted(
        (o["bytes"] for o in rec["collectives"]["ops"]), reverse=True)[:3]
