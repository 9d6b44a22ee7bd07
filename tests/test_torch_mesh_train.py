"""The port's training on a ``DeviceMesh`` (``make_train_step(mesh=)``,
``shard_train_state``, the sharded checkpoint and the elastic restore, the
launcher under ``torch.distributed.run``), on gloo ranks on the CPU.

The reference's mesh semantics are SPMD: a sharded step computes what the
one-device step computes. The port's one-device training is held to the
reference in ``test_torch_train.py``, so a mesh run is held to the port's
own one-process run here, and through it to the reference.

Two groups of ranks (``torch_mesh_ranks.py``, through ``torch_ranks``): two
ranks run meshes (2, 1) and (1, 2), four run (2, 2), each for a dense
(llama3.2-1b), rwkv (rwkv6-1.6b), hybrid (zamba2-1.2b) and moe
(moonshot-v1-16b-a3b, with its aux loss) config at 2 layers, vocab 128,
batch 4 x 32, with rows 0-1 partly masked (-100), so ranks of a split
batch hold different token counts; the audio (whisper-small) and vlm
(internvl2-76b) families on (1, 2) and (2, 2). The step computes
tensor-parallel over 'model' (``test_torch_tp.py`` runs (1, 4)): on (1, 2)
each rank's compute copy holds half of every split leaf, and its counted
flops are about half the one-process step's.

Tolerances and why:
  * losses of three f32-compute steps: 1e-5 relative. The mesh sums the
    same terms in another order (the token mean and the gradient over the
    data axes, the global norm over shards, the vocab-parallel logsumexp
    and the row-parallel partial sums over 'model'); the runs measure
    ~1e-7.
  * the first step's reduced gradient: 1e-5 of each leaf's largest |g|
    (~4e-7 to 1.2e-6 measured; ~7e-6 for Mamba-2's ``A_log`` and
    ``dt_bias`` on a split 'model', sums with much cancellation).
  * a rank's counted flops on (1, 2): at most 0.6 of the one-process
    step's (the router, Mamba-2's B and C and the loss's reductions are
    computed on both ranks). f32 compute, not bf16: a reduction in another order
    moves bf16's last bits, and AdamW's first steps turn a flipped sign of
    a near-zero gradient into a 2 lr move; the bf16 path is held on the
    card (chip_smoke phase 5e).
  * checkpoints and restores: bytes and bits, exactly.
Multi-rank semantics are tested here with gloo only: two NCCL ranks cannot
share the one GPU of the card machine, where chip_smoke runs one NCCL rank.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_mesh_ranks import ARCHS, FAMILIES, cfg_of, init_state, template
from torch_ranks import SRC, free_port, run_ranks

LOSS_TOL = GRAD_TOL = 1e-5
MESHES = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_ckpt")


@pytest.fixture(scope="module")
def two(ckpt):
    return run_ranks(2, "torch_mesh_ranks:group_two", {"ckpt": str(ckpt)},
                     timeout=240)


@pytest.fixture(scope="module")
def four(two, ckpt):
    return run_ranks(4, "torch_mesh_ranks:group_four", {"ckpt": str(ckpt)},
                     timeout=240)


def _runs(two, four, arch, shape):
    return [r[arch, shape] for r in (four if shape == (2, 2) else two)]


CASES = [(a, s) for a in ARCHS for s in MESHES] + \
    [(a, s) for a in FAMILIES for s in ((1, 2), (2, 2))]


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_losses_and_gradients_match_one_device(two, four, arch, shape):
    for rank, run in enumerate(_runs(two, four, arch, shape)):
        assert max(run["loss_err"]) <= LOSS_TOL, (rank, run["loss_err"])
        assert max(run["grad_err"]) <= GRAD_TOL, (rank, run["grad_err"])


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
@pytest.mark.parametrize("arch", FAMILIES)
def test_families_match_one_device(two, four, arch, shape):
    """The audio family (its encoder and cross-attention) and the vlm
    family (patch embeddings ahead of the tokens) on split 'model's."""
    for rank, run in enumerate(_runs(two, four, arch, shape)):
        assert max(run["loss_err"]) <= LOSS_TOL, (rank, run["loss_err"])
        assert max(run["grad_err"]) <= GRAD_TOL, (rank, run["grad_err"])


@pytest.mark.parametrize("arch,shape", CASES, ids=str)
def test_masters_and_moments_stored_by_the_specs(two, four, arch, shape):
    """Each rank's local master and moment shapes and placements are the
    spec's, before and after the steps."""
    for rank, run in enumerate(_runs(two, four, arch, shape)):
        assert run["storage"] == [], (rank, run["storage"])


def test_ranks_agree_on_the_losses(two, four):
    for arch, shape in CASES:
        runs = _runs(two, four, arch, shape)
        assert all(r["losses"] == runs[0]["losses"] for r in runs)


@pytest.mark.parametrize("arch,shape", [c for c in CASES if c[1] != (2, 1)],
                         ids=str)
def test_compute_copy_holds_its_share_of_split_leaves(two, four, arch,
                                                      shape):
    """During the step each rank's compute copy holds 1/tp of every leaf
    split over 'model' (tp = 2 here) and the whole of each leaf used
    whole, and split leaves hold most of the parameters."""
    tp = shape[1]
    for rank, run in enumerate(_runs(two, four, arch, shape)):
        split = [(n, m) for d, n, m in run["layout"] if d is not None]
        whole = [(n, m) for d, n, m in run["layout"] if d is None]
        assert split and all(m * tp == n for n, m in split), (rank, split)
        assert all(m == n for n, m in whole), (rank, whole)
        assert sum(n for n, _ in split) > sum(n for n, _ in whole)


@pytest.mark.parametrize("arch", ARCHS + FAMILIES)
def test_flops_on_one_by_two_about_halve(two, arch):
    """A rank's counted flops (``FlopCounterMode``: the matmuls, forward,
    recomputation and backward) of the first step on (1, 2) are at most
    0.6 of the one-process step's: 'model' splits the work, not repeats
    it."""
    for rank, r in enumerate(two):
        ratio = r[arch, (1, 2)]["flops"] / r["flops", arch]
        assert ratio <= 0.6, (rank, ratio)


def test_accumulation_gathers_once_a_step(two):
    """``accum_steps=2`` on (2, 1) (moe: its aux statistics over each
    global microbatch) gives the one-device accumulated losses, and the
    cast copy is gathered once a step: one ``gather_for_compute`` a leaf,
    not one a microbatch."""
    for r in (x["accum"] for x in two):
        assert max(r["loss_err"]) <= LOSS_TOL, r["loss_err"]
        assert r["gathers"] == [r["leaves"]] * 3, r


def test_gradients_summed_over_model_fail_the_check(two):
    """The broken control: under sequence parallelism the leaves used
    whole (the norms' scales) must be summed over 'model', where each rank
    computed them on its own sequence slice; with that sum dropped on a
    (1, 2) mesh a rank holds its slice's share only, which the gradient
    check must catch."""
    for run in (r["broken"] for r in two):
        assert max(run["grad_err"]) > 0.5


def test_failed_sharded_save_raises_on_every_rank(two):
    """Rank 0's write fails (its directory would lie under a file): a
    synchronous and an async save raise on both ranks, rank 1 with rank
    0's failure named, and the ranks still meet afterwards (none is left
    waiting in a collective)."""
    for rank, r in enumerate(x["save_fails"] for x in two):
        assert r["sync"] and r["async"] and r["after"], (rank, r)
        if rank:
            assert "rank 0 failed to write checkpoint step 1" in r["sync"]
            assert "rank 0 failed to write checkpoint step 1" in r["async"]


def test_sharded_checkpoint_is_byte_equal_to_one_device_save(two, ckpt):
    sharded = ckpt / "sharded" / "step_00000002"
    plain = ckpt / "plain" / "step_00000002"
    names = sorted(p.name for p in sharded.iterdir())
    assert names == sorted(p.name for p in plain.iterdir())
    assert "manifest.json" in names and len(names) > 3
    for name in names:
        a, b = (sharded / name).read_bytes(), (plain / name).read_bytes()
        if name == "provenance.json":
            a, b = json.loads(a), json.loads(b)
            for k in ("started_at", "finished_at", "host"):
                a.pop(k), b.pop(k)
        assert a == b, name


def test_restore_onto_two_by_two_is_bit_equal(four):
    for rank, r in enumerate(four):
        assert r["restore"] == {"step": 2, "bad": []}, rank


def test_resume_on_another_layout_continues_the_losses(two):
    for r in (x["resume"] for x in two):
        assert r["step"] == 2 and r["bad"] == []
        assert abs(r["loss"] - r["uninterrupted"]) <= \
            LOSS_TOL * abs(r["uninterrupted"])


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_sharded_draw_is_bit_equal_to_the_one_process_draw(two, four, shape):
    """P5: each rank draws leaf by leaf and keeps its slice; every shard
    (params and fresh moments, every arch) equals its slice of the
    one-process ``init_params`` draw, bit for bit."""
    for rank, r in enumerate(x["draws"][shape]
                             for x in (four if shape == (2, 2) else two)):
        assert r == [], (rank, r)


def test_sharded_draw_holds_one_leaf_on_the_host(two):
    """P5: MemTracker around one rank's build on the CPU: the sharded draw
    peaks at most at one f32 leaf plus the rank's slices and the small
    leaves that are not drawn; the whole-tree build it replaces holds
    4 bytes a parameter besides the slices."""
    for rank, r in enumerate(x["draw_peak"] for x in two):
        assert r["draw"] <= r["largest"] + r["slices"] + r["undrawn"], \
            (rank, r)
        assert r["whole"] >= r["whole_tree"] + r["slices"] // 3, (rank, r)
        assert r["draw"] < r["whole"] - r["whole_tree"] // 2, (rank, r)


@pytest.mark.parametrize("world", [2, 4])
def test_elastic_restore_checks_each_leaf_once(two, four, world):
    """P6: restoring onto (1, 2) and (2, 2), the ranks' fletcher64 checks
    add up to one a leaf, split over the ranks by bytes, and the shards
    stay bit-equal to the plain restore."""
    runs = [x["checked"] for x in (two if world == 2 else four)]
    assert all(r["bad"] == [] for r in runs), runs
    assert sum(r["checks"] for r in runs) == runs[0]["leaves"], runs
    assert all(r["checks"] > 0 for r in runs), runs
    total = sum(r["bytes"] for r in runs)
    assert max(r["bytes"] for r in runs) <= total / world * 1.5, runs


def test_corrupted_leaf_raises_on_every_rank(two):
    """P6: one leaf's bytes flipped; one rank checks it, and every rank
    raises ``IntegrityError`` (the outcome is all-reduced)."""
    got = [x["corrupt"] for x in two]
    assert all(g and g.startswith("IntegrityError") for g in got), got
    assert any("params/final_norm corrupted" in g for g in got), got


def test_restore_onto_one_device_with_shardings(two, ckpt, tmp_path):
    """One gloo rank in this process: the (2, 1) checkpoint restored with
    ``shardings=`` onto a (1, 1) mesh, bit-equal to the plain restore."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch import tree as tree_util
    from repro_torch.ckpt import restore_checkpoint
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = cfg_of("llama3.2-1b")
        tmpl, shard = template(cfg, mesh)
        got, step, _ = restore_checkpoint(ckpt / "sharded", tmpl,
                                          shardings=shard)
        want, _, _ = restore_checkpoint(ckpt / "plain", tmpl, device="cpu")
        assert step == 2
        for g, w in zip(tree_util.leaves(got), tree_util.leaves(want)):
            assert isinstance(g, DTensor)
            assert g.dtype == w.dtype and torch.equal(g.to_local(), w)
    finally:
        dist.destroy_process_group()


def test_shard_train_state_keeps_the_values(tmp_path):
    """Placing the full state on a (1, 1) mesh and gathering it back gives
    the same tensors; each shard is a copy that keeps nothing of the full
    tensor alive; without an AdamW state the moments start at zero on the
    shards, step 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import tree as tree_util
    from repro_torch.train import shard_train_state
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        params, opt = init_state(cfg_of("zamba2-1.2b"))
        sp, so = shard_train_state(params, opt, mesh)
        for a, b in zip(tree_util.leaves({"p": params, "o": opt}),
                        tree_util.leaves({"p": sp, "o": so})):
            assert torch.equal(a, b.full_tensor())
            assert b.to_local().untyped_storage().data_ptr() != \
                a.untyped_storage().data_ptr()
        _, fresh = shard_train_state(params, None, mesh)
        for a, b, c in zip(tree_util.leaves(opt), tree_util.leaves(fresh),
                           tree_util.leaves(so)):
            assert b.placements == c.placements and b.dtype == a.dtype
            assert torch.equal(a, b.full_tensor())
    finally:
        dist.destroy_process_group()


def test_cli_under_torchrun_prints_on_rank_zero(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train --device cpu``: two gloo ranks on the (2, 1)
    data mesh, exit 0, and every line printed once (rank 0)."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port",
         str(free_port()), "-m", "repro_torch.launch.train", "--device",
         "cpu", "--arch", "llama3.2-1b", "--steps", "10", "--batch", "4",
         "--seq", "32"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()
             and not ln.startswith("*")
             and "OMP_NUM_THREADS" not in ln]
    assert lines[0] == "mesh (2, 1) over data, model: 2 ranks, gloo", lines
    steps = [ln for ln in lines if ln.startswith("step")]
    assert [ln.split()[1] for ln in steps] == ["10"], lines
    assert all("on mesh (2, 1) of cpu" in ln for ln in steps)
    assert (tmp_path / "ckpt" / "step_00000010" / "manifest.json").exists()
