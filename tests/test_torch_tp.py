"""Tensor-parallel compute over 'model' in the port's training step, on
four gloo ranks on the CPU: a (1, 4) ('data', 'model') mesh, where every
rank of the one 'model' group shares the rows and splits the work.

``torch_mesh_ranks.group_tp`` runs, on (1, 4):
  * the dense, rwkv, hybrid and moe configs of ``test_torch_mesh_train.py``
    and the audio (whisper-small: encoder and cross-attention) and vlm
    (internvl2-76b) families, 2 layers, vocab 128, against the port's
    one-process run;
  * llama3.2-1b cut to head counts that take each attention layout
    (``BRANCHES``): the reference's ``attn_shard_choice`` None with fewer
    KV heads than ranks (4 heads, 2 KV: a KV head rebuilt from two
    ranks' slices of its Dh), "q" (6 heads at 32 tokens: query positions,
    whole weights), None because nothing fits (6 heads at 30 tokens,
    split 8, 8, 8, 6, with a vocabulary of 130 that 4 does not divide),
    and "kv" and "g", which the function never returns (its first test
    catches both) and which are forced by replacing it;
  * blocks that 4 ranks cannot split (``WHOLE``: Mamba-2 with 6 SSD
    heads, a SwiGLU MLP whose gate and up are not interleaved, 6
    experts, rwkv with 3 heads and a d_ff of 250), which every rank runs
    whole on the gathered sequence, keeping its slice of the output;
  * the JAX package's params trained from its own sharded step
    (``torch_tp_ref.py``: ``make_train_step`` jitted under
    ``use_rules(Rules(mesh (1, 4), "train"))`` on 4 XLA CPU devices) for
    llama3.2-1b and moonshot.

On one rank, a (1, 1) mesh runs the same path over a 'model' of one (as
chip_smoke's phase 5e does on its NCCL rank): in bf16 its losses are the
one-process step's bit for bit.

Tolerances and why: losses of three f32 steps 1e-5 relative and the first
step's reduced gradient 1e-5 of each leaf's largest |g|, as
``test_torch_mesh_train.py`` (the sums run in other orders: the
vocab-parallel logsumexp, the partial sums of the row-parallel blocks;
Mamba-2's ``A_log`` and ``dt_bias`` gradients, sums with much
cancellation, measure ~7e-6, the rest below 1.2e-6); against the
reference's sharded step 1e-5 relative. The compute copy's shares are
counted exactly.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.dist import sharding as ref_sharding
from torch_mesh_ranks import ARCHS, BRANCHES, FAMILIES, WHOLE, branch_cfg
from torch_ranks import SRC, run_ranks

HERE = Path(__file__).resolve().parent
TOL = 1e-5
TP = 4


class FakeMesh:
    """The reference test's shape-only mesh."""
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.zeros(shape)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_ref") / "ref.pkl"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")]),
        "OMP_NUM_THREADS": "1"}
    done = subprocess.run([sys.executable, str(HERE / "torch_tp_ref.py"),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    import pickle
    with open(out, "rb") as f:
        return str(out), pickle.load(f)


@pytest.fixture(scope="module")
def tp(ref):
    return run_ranks(TP, "torch_mesh_ranks:group_tp",
                     {"ref_params": ref[0]}, timeout=240)


def _check(runs):
    for rank, run in enumerate(runs):
        assert max(run["loss_err"]) <= TOL, (rank, run["loss_err"])
        assert max(run["grad_err"]) <= TOL, (rank, run["grad_err"])
        assert run["storage"] == [], (rank, run["storage"])
    assert all(r["losses"] == runs[0]["losses"] for r in runs)


@pytest.mark.parametrize("arch", ARCHS + FAMILIES)
def test_one_by_four_matches_one_device(tp, arch):
    _check([r[arch] for r in tp])


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_each_attention_layout_matches_one_device(tp, branch):
    _check([r[branch] for r in tp])


@pytest.mark.parametrize("arch", list(WHOLE))
def test_blocks_used_whole_match_one_device(tp, arch):
    """The layers 'model' cannot split run whole on every rank, their
    weights used whole and their gradients summed over 'model'."""
    runs = [r["whole", arch] for r in tp]
    _check(runs)
    for r in runs:
        assert r["layout"], arch


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_attention_choice_is_the_references(tp, branch):
    """The port's ``attn_shard_choice`` for each cut config's heads (as
    its step ran it) is the reference's for the same heads and query
    length on a 'model' of 4; "kv" and "g", forced, are choices the
    reference's function does not make for those heads."""
    cfg, seq = branch_cfg(branch)
    forced = BRANCHES[branch][2]
    with ref_sharding.use_rules(ref_sharding.Rules(
            FakeMesh((1, TP), ("data", "model")))):
        want = ref_sharding.attn_shard_choice(
            cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, min(seq, 2048))
    got = {r[branch]["choice"] for r in tp}
    assert got == {forced or want}
    assert want == {"none": None, "q": "q", "nothing_fits": None,
                    "kv": None, "g": None}[branch]


@pytest.mark.parametrize("tp_size", [2, 4, 8, 16])
def test_kv_and_g_are_never_chosen(tp_size):
    """The reference's ``attn_shard_choice`` over a grid of heads and
    query lengths: "kv" and "g" never come out (a KV or G that the size
    divides factors as (tp, 1) or (1, tp) first)."""
    with ref_sharding.use_rules(ref_sharding.Rules(
            FakeMesh((256 // tp_size, tp_size), ("data", "model")))):
        got = {ref_sharding.attn_shard_choice(kv, g, q)
               for kv in range(1, 33) for g in range(1, 17)
               for q in (1, 7, 30, 32, 2048)}
    assert got <= {None, "q"} and "q" in got


@pytest.mark.parametrize("case", ARCHS + FAMILIES + tuple(BRANCHES))
def test_compute_copy_holds_a_quarter_of_each_split_leaf(tp, case):
    """During the step each rank's compute copy holds 1/4 of every leaf
    split over 'model' (and the whole of each leaf used whole); most of
    the parameters are split."""
    for rank, r in enumerate(x[case] for x in tp):
        split = [(n, m) for d, n, m in r["layout"] if d is not None]
        whole = [(n, m) for d, n, m in r["layout"] if d is None]
        assert all(m * TP == n for n, m in split), (rank, split)
        assert all(m == n for n, m in whole), (rank, whole)
        assert split, rank
        if case != "nothing_fits":
            assert sum(n for n, _ in split) > sum(n for n, _ in whole), case


@pytest.mark.parametrize("arch", ["llama3.2-1b", "moonshot-v1-16b-a3b"])
def test_references_sharded_step_agrees(tp, ref, arch):
    """Three losses of the reference's jitted step under (1, 4) rules
    and of the port's (1, 4) ranks from the same params and batches."""
    want = ref[1]["losses"][arch]
    for rank, r in enumerate(tp):
        got = r["ref", arch]
        assert all(abs(a - b) <= TOL * abs(b) for a, b in zip(got, want)), \
            (rank, got, want)


@pytest.fixture(scope="module")
def one():
    return run_ranks(1, "torch_mesh_ranks:group_one", timeout=240)[0]


@pytest.mark.parametrize("arch", ARCHS + FAMILIES)
def test_one_rank_path_is_the_one_process_step_bit_for_bit(one, arch):
    """bf16, three steps: the path over a 'model' of one (its gathers,
    scatters, one-rank all-to-alls and the vocab-parallel loss) gives the
    losses of the step without a mesh exactly."""
    plain, mesh = one[arch]
    assert mesh == plain


class GroupMesh:
    """A mesh with process groups, as ``tp_group`` reads one: axis names,
    sizes and a group per axis (none needed here)."""
    def __init__(self, shape, axes):
        self.shape, self.mesh_dim_names = shape, axes

    def get_group(self, i):
        return None

    def get_local_rank(self, i):
        return 0

    def size(self, i):
        return self.shape[i]


@pytest.mark.parametrize("shape,axes,want", [
    ((1, 4), ("data", "model"), 4),
    ((2, 1), ("data", "model"), 1),
    ((1, 4, 1), ("data", "model", "model2"), 4),
    ((1, 2, 2), ("data", "model", "model2"), NotImplementedError),
])
def test_tensor_parallel_group_of_the_rules(shape, axes, want):
    """``tp_group`` under train rules: 'model' of each size (one rank
    included: the path runs its collectives there too); a 'model2' of
    one adds nothing; tp2d, a 'model2' larger than one, raises rather than
    falling back to a whole copy on every rank."""
    from repro_torch.dist.sharding import Rules, tp_group, use_rules
    with use_rules(Rules(GroupMesh(shape, axes), "train")):
        if want is NotImplementedError:
            with pytest.raises(NotImplementedError):
                tp_group()
        else:
            assert tp_group().size == want
