"""The port's dry-run (``repro_torch.launch.dryrun``) and its records
(``experiments/dryrun_torch/``), on the CPU.

Every trace runs in a fresh interpreter: ``placeholder_mesh`` replaces the
process group of its process with a fake one, which must never happen in
a test process that may hold a gloo group.

  * A reduced config's train step, traced on a (2, 2) placeholder mesh,
    issues the collectives ``train/train_step.py`` implies, with their
    bytes: per sharded leaf of the cast copy one all-gather per mesh dim
    that shards it (each one's output the leaf gathered so far, the last
    the whole leaf); per gradient leaf one reduce-scatter (sharded on
    'data') or all-reduce (replicated on it) of its f32 gradient, after
    cutting its 'model' chunk where that splits another dim; one
    all-reduce of the step's metrics; the global norm's all-reduces;
    moe's load-balance statistics' batch means.
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
    """The (op, bytes) multiset one step on a (2, 2) ('data', 'model')
    mesh must issue, from the specs alone."""
    import math
    from torch.distributed.tensor import Shard
    from repro_torch import tree as tree_util
    from repro_torch.dist.sharding import MeshShape, param_specs, \
        placements_for
    from repro_torch.models import init_params
    mesh = MeshShape((2, 2), ("data", "model"))
    meta = init_params(cfg, None, device="meta")
    specs = param_specs(meta, mesh)
    ops, norm_groups = Counter(), Counter()
    for path, leaf in tree_util.flatten_with_paths(meta):
        pl = placements_for(tree_util.at(specs, path), mesh)
        n = leaf.numel()
        size = 2 if leaf.dim() > 1 else 4           # the cast copy
        shard = [i for i, p in enumerate(pl) if isinstance(p, Shard)]
        left = [2] * len(shard)
        for _ in reversed(shard):                   # last mesh dim first
            left.pop()
            ops["all-gather", n * size // math.prod(left)] += 1
        data, model = pl
        cut = isinstance(model, Shard) and not (
            isinstance(data, Shard) and data.dim == model.dim)
        kind = "reduce-scatter" if isinstance(data, Shard) else "all-reduce"
        ops[kind, n * 4 // (2 if cut else 1)] += 1
        norm_groups[tuple(shard)] += 1
    ops["all-reduce", 2 * 4] += 1                   # loss and accuracy
    if cfg.moe is not None:     # two batch means a layer, again in remat
        ops["all-reduce", cfg.moe.n_experts * 4] += 2 * 2 * cfg.n_layers
    for dims, k in norm_groups.items():             # the global norm
        for _ in dims:
            ops["all-reduce", 4 * k] += 1
    return ops


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_are_the_ones_the_specs_imply(small, arch):
    cfg = get_config(arch).reduced(n_layers=2, vocab_size=128)
    rec = small[arch]
    got = Counter((o["op"], o["bytes"]) for o in rec["collectives"]["ops"])
    assert got == _expected(cfg)
    assert all(o["group"] == 2 for o in rec["collectives"]["ops"])
    c = rec["collectives"]
    assert c["weighted_bytes"] == c["raw_bytes"] + c["per_op"]["all-reduce"]


@pytest.mark.parametrize("arch", ARCHS)
def test_small_record_counts_the_step(small, arch):
    """Rows split over 'data'; counted flops above the model's 6·N·T of
    the rank's rows (remat adds a forward); the peak holds the rank's
    state, which MemTracker was given."""
    cfg = get_config(arch).reduced(n_layers=2, vocab_size=128)
    rec = small[arch]
    assert rec["rows_per_rank"] == BATCH // 2
    assert rec["sharded_compute"] is True and rec["kernels"] == "plain"
    assert rec["n_chips"] == 4 and rec["mesh"] == "2x2"
    model = 6 * cfg.n_active_params() * BATCH // 2 * SEQ
    assert rec["counted_flops_per_rank"] > model
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
