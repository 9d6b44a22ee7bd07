"""The port's dry-run analysis (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), on the CPU.

``flops.py`` is a copy of the reference's analytic count on the port's
``configs``: every (arch x shape) cell must give the same numbers exactly
(``step_flops``, ``model_flops``, and ``step_hbm_bytes`` at 256 and 512
chips, tp 1 and 16). ``roofline.py`` keeps the reference's terms with an
H100 row; ``summarize_memory`` reads a ``MemTracker`` snapshot;
``comm_count.summarize`` weights an all-reduce twice as ``hlo_parse``
does. Nothing here traces a step (``test_torch_dryrun.py`` does)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import flops as ref_flops
from repro.analysis import roofline as ref_roofline
from repro.configs import SHAPE_BY_NAME as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro_torch.analysis import comm_count, flops, roofline
from repro_torch.configs import ARCH_IDS, SHAPES, get_config

SRC = Path(__file__).resolve().parents[1] / "src"
CELLS = [(a, s.name) for a in ARCH_IDS for s in SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_flops_equal_the_reference_on_every_cell(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    s = next(x for x in SHAPES if x.name == shape)
    rs = REF_SHAPES[shape]
    assert flops.step_flops(cfg, s, s.kind) == \
        ref_flops.step_flops(ref_cfg, rs, rs.kind)
    assert roofline.model_flops(cfg, s, s.kind) == \
        ref_roofline.model_flops(ref_cfg, rs, rs.kind)
    for n_chips in (256, 512):
        for tp in (1, 16):
            assert flops.step_hbm_bytes(cfg, s, s.kind, n_chips, tp) == \
                ref_flops.step_hbm_bytes(ref_cfg, rs, rs.kind, n_chips, tp)


def test_h100_row():
    """The bounds PERF.md's kernel table uses, and NVLink 4's 900 GB/s
    both ways as the default link, one direction."""
    hw = roofline.H100
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == \
        (989e12, 3.35e12, 450e9, 80e9)


@pytest.mark.parametrize("flops_,bytes_,coll,bound", [
    (989e12, 3.35e9, 45e9, "compute"),        # 1 s, 1 ms, 0.1 s
    (989e9, 3.35e12, 45e9, "memory"),         # 1 ms, 1 s, 0.1 s
    (989e9, 3.35e9, 450e9, "collective"),     # 1 ms, 1 ms, 1 s
])
def test_roofline_terms_pick_the_dominant_term(flops_, bytes_, coll, bound):
    t = roofline.roofline_terms(flops_, bytes_, coll)
    assert t["bound"] == bound
    assert t["step_s_lower_bound"] == max(t["compute_s"], t["memory_s"],
                                          t["collective_s"]) == 1.0
    # the reference's terms, on the reference's constants
    ref = ref_roofline.roofline_terms(flops_, bytes_, coll)
    mine = roofline.roofline_terms(flops_, bytes_, coll, hw=roofline.Hardware(
        "v5e", ref_roofline.HW.peak_flops, ref_roofline.HW.hbm_bw,
        ref_roofline.HW.link_bw, 16e9))
    assert mine == ref


def test_link_rate_is_a_parameter():
    """Across hosts the link is the caller's: a slower network moves the
    collective term, and the bound with it."""
    t = roofline.roofline_terms(989e12, 0.0, 45e9, link_bw=25e9)
    assert t["collective_s"] == 45e9 / 25e9 and t["bound"] == "collective"


def test_summarize_memory_reads_a_mem_tracker_snapshot():
    from torch.distributed._tools.mem_tracker import MemTracker
    held = torch.zeros(1000)
    tracker = MemTracker()
    tracker.track_external(held)
    with tracker:
        a = torch.ones(2000)
        b = a * 2
        del a, b
    snap = tracker.get_tracker_snapshot("peak")
    got = roofline.summarize_memory(snap)
    assert got["peak_est_bytes"] == snap[torch.device("cpu")]["Total"]
    assert got["peak_est_bytes"] >= 4000 + 2 * 8000
    assert got["other"] == 4000              # what track_external was given
    assert sum(v for k, v in got.items() if k != "peak_est_bytes") == \
        got["peak_est_bytes"]


def test_rank_hbm_bytes_is_the_reference_count_at_tp_1():
    """A serve rank's bytes are the reference's per-chip count,
    ``step_hbm_bytes`` at the mesh's chips and 'model' size (its shard of
    the weights and of the cache: the mesh steps); at tp 1 its weights are
    whole. A train rank reads the whole copy."""
    cfg = get_config("llama3.2-1b")
    for name in ("prefill_32k", "decode_32k"):
        s = next(x for x in SHAPES if x.name == name)
        for tp in (1, 16):
            assert roofline.rank_hbm_bytes(cfg, s, s.kind, 256, 1, tp) == \
                flops.step_hbm_bytes(cfg, s, s.kind, 256, tp)
        assert roofline.rank_hbm_bytes(cfg, s, s.kind, 256, 1, 1) > \
            cfg.n_params() * 2 > roofline.rank_hbm_bytes(cfg, s, s.kind,
                                                          256, 1, 16)
    t = next(x for x in SHAPES if x.name == "train_4k")
    P = cfg.n_params()
    got = roofline.rank_hbm_bytes(cfg, t, "train", 256, 16)
    assert got > 10 * P > flops.step_hbm_bytes(cfg, t, "train", 256, 16)


def test_collective_summary_weights_all_reduce_twice():
    ops = [{"op": "all-gather", "bytes": 100}, {"op": "all-reduce",
                                                "bytes": 10},
           {"op": "reduce-scatter", "bytes": 40}, {"op": "all-gather",
                                                   "bytes": 5}]
    s = comm_count.summarize(ops)
    assert s["counts"] == {"all-gather": 2, "all-reduce": 1,
                           "reduce-scatter": 1, "all-to-all": 0,
                           "broadcast": 0}
    assert s["per_op"]["all-gather"] == 105
    assert s["raw_bytes"] == 155 and s["weighted_bytes"] == 165
    assert s["ops"] == ops


_KINDS = """
import json, torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.analysis.comm_count import CollectiveLog, comm_debug_counts
from repro_torch.launch.mesh import placeholder_mesh
mesh = placeholder_mesh((4, 4), ("data", "model"))
g = mesh.get_group("model")
with FakeTensorMode(allow_non_fake_inputs=True):
    x = torch.empty(4, 8)
    with CommDebugMode() as debug, CollectiveLog() as log:
        dist.all_gather_into_tensor(torch.empty(16, 8), x, group=g)
        dist.reduce_scatter_tensor(torch.empty(1, 8), x, group=g)
        dist.all_reduce(x, group=g)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
        dist.all_to_all_single(torch.empty(4, 8), x, group=g)
print(json.dumps([comm_debug_counts(debug), log.summary()["counts"],
                  log.summary()["per_op"], [o["group"] for o in log.ops]]))
"""


def test_collective_log_sees_every_kind_the_tp_step_issues():
    """The ``c10d`` ops the tensor-parallel step calls (all-gather,
    reduce-scatter, all-reduce of a sum and of a max, all-to-all) on fake
    tensors over a placeholder mesh's 'model' group (in a fresh
    interpreter: the placeholder replaces the process group): counted as
    ``CommDebugMode`` counts them, with their bytes (an all-gather's
    output, a reduce-scatter's and an all-to-all's input) and group."""
    out = subprocess.run([sys.executable, "-c", _KINDS], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-3000:]
    debug, counts, per_op, groups = json.loads(out.stdout.splitlines()[-1])
    assert debug == counts == {"all-gather": 1, "all-reduce": 2,
                               "reduce-scatter": 1, "all-to-all": 1,
                               "broadcast": 0}
    assert per_op == {"all-gather": 512, "all-reduce": 256,
                      "reduce-scatter": 128, "all-to-all": 128,
                      "broadcast": 0}
    assert groups == [4] * 5


_NO_JAX = (
    "import sys, importlib\n"
    "sys.modules['jax'] = None\n"
    "importlib.import_module({module!r})\n"
    "bad = [m for m, v in sys.modules.items() if v is not None and"
    " (m == 'repro' or m.startswith('repro.') or m.startswith('jax'))]\n"
    "assert not bad, bad\n")


@pytest.mark.parametrize("module", ["repro_torch.analysis",
                                    "repro_torch.analysis.report",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.core.cost"])
def test_dryrun_slice_modules_import_no_jax_and_no_reference(module):
    out = subprocess.run([sys.executable, "-c",
                          _NO_JAX.format(module=module)],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
