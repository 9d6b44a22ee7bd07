"""The tp2d layout in the port, on four gloo ranks on the CPU: a (1, 2, 2)
('data', 'model', 'model2') mesh from ``launch.mesh.make_tp2d_mesh``, the
weights stored over 'model' alone (2-way) and the compute tensor-parallel
over the flattened ('model', 'model2') group (4-way, 'model' major), as
the reference's (16, 8, 2) production tp2d mesh stores 8-way and computes
16-way.

``torch_tp2d_ranks.group_tp2d`` runs, at 2 layers and vocab 128 (f32):
  * training of llama3.2-1b, moonshot-v1-16b-a3b and llama3.2-1b cut to 6
    heads (``SEQ_HEADS``: 4 does not factor over its heads, so attention
    takes the "seq" layout) against the port's one-process step: three
    losses, the first step's reduced gradient, the storage's shards, the
    compute copy's quarter of each split leaf, and the loss of the
    trained state gathered whole on a batch it did not train on (each
    rank computes on its own chunk of a split leaf only, so the steps'
    losses cannot see a chunk stored wrong: this loss reads every one);
  * the JAX package's params trained by the port's (1, 2, 2) step, against
    the reference's own sharded step jitted under ``use_rules(Rules(mesh
    (1, 2, 2), "train"))`` on 4 XLA CPU devices (``torch_tp2d_ref.py``,
    run beside the ranks);
  * the broken control: ``_gather_model2`` dropped from
    ``grad_to_storage`` (each rank's gradient slice standing for its
    'model2' partner's too) must fail the trained state's loss check;
  * serving (prefill and every decode step's logits, tokens) of
    llama3.2-1b, zamba2-1.2b and rwkv6-1.6b on the JAX package's params,
    and of ``SEQ_HEADS`` on the port's, against the one-process
    ``serve_batch``, and under the "long" rules for llama3.2-1b; the three
    archs' against the reference's sharded prefill and decode on the same
    mesh of XLA devices. 20 prompt tokens and 12 new: the flat group
    splits the prefill's cache and the decode cache at other bounds.

R13: the reference's attention reads ``tp_size()``, the product of the
model axes; its ``make_tp2d_mesh`` docstring says the attention uses the
'model' sub-axis alone. On (1, 2, 2) and on the (16, 8, 2) production
shape the port's choice is the reference's code's, not its docstring's.

Tolerances, as ``test_torch_tp.py`` and ``test_torch_serve_mesh.py``:
losses of three f32 steps 1e-5 relative, the first step's reduced
gradient 1e-5 of each leaf's largest |g|, against the reference's step
1e-5 relative; the trained state's loss 1e-5 relative; logits within
1e-5 of the largest |logit|, tokens equal.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from torch_ranks import SRC, run_ranks
from torch_tp2d_ranks import SERVE, TP, TRAIN, seq_heads_cfg

HERE = Path(__file__).resolve().parent
TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the reference's, whose subprocess runs
    beside them."""
    params = {}
    for arch in dict.fromkeys(TRAIN + SERVE):
        cfg = jax_get_config(arch).reduced(n_layers=2, vocab_size=128)
        params[arch] = jax.tree.map(np.asarray, jax_init_params(
            cfg, jax.random.PRNGKey(0), jnp.float32))
    path = tmp_path_factory.mktemp("tp2d_ref") / "ref.pkl"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep
           .join([str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")])}
    with subprocess.Popen([sys.executable, str(HERE / "torch_tp2d_ref.py"),
                           str(path)], env=env, stderr=subprocess.PIPE,
                          text=True) as proc:
        try:
            got = run_ranks(TP, "torch_tp2d_ranks:group_tp2d",
                            {"params": params}, timeout=300)
            err = proc.communicate(timeout=300)[1]
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, err[-4000:]
    with open(path, "rb") as f:
        return got, pickle.load(f)


def test_the_group_is_model_major(runs):
    """Each rank's place in the tensor-parallel group is its 'model'
    coordinate times 2 plus its 'model2' one; the residual's sequence
    splits over both axes."""
    for r in runs[0]:
        rank, size, (_, m, m2) = r["group"]
        assert (rank, size) == (2 * m + m2, TP)
        assert r["seq_axes"] == ("model", "model2")
    assert sorted(r["group"][0] for r in runs[0]) == list(range(TP))


@pytest.mark.parametrize("case", TRAIN + ("seq_heads",))
def test_training_matches_one_process(runs, case):
    results = [r["train", case] for r in runs[0]]
    for rank, r in enumerate(results):
        assert max(r["loss_err"]) <= TOL, (rank, r["loss_err"])
        assert max(r["grad_err"]) <= TOL, (rank, r["grad_err"])
        assert r["state_err"] <= TOL, (rank, r["state_err"])
        assert r["storage"] == [], (rank, r["storage"])
    assert all(r["losses"] == results[0]["losses"] for r in results)


@pytest.mark.parametrize("case", TRAIN + ("seq_heads",))
def test_compute_copy_holds_a_quarter_of_each_split_leaf(runs, case):
    """The compute copy splits over all four ranks while the storage
    splits over two: each rank holds 1/4 of every leaf split in compute,
    the whole of each leaf used whole, and most parameters are split."""
    for rank, r in enumerate(x["train", case] for x in runs[0]):
        split = [(n, m) for d, n, m in r["layout"] if d is not None]
        whole = [(n, m) for d, n, m in r["layout"] if d is None]
        assert split and all(m * TP == n for n, m in split), (rank, split)
        assert all(m == n for n, m in whole), (rank, whole)
        assert sum(n for n, _ in split) > sum(n for n, _ in whole), case


def test_seq_heads_take_the_seq_layout(runs):
    from repro_torch.models.layers import attn_layout
    cfg = seq_heads_cfg()
    assert {r["seq_heads_choice"] for r in runs[0]} == {"q"}
    assert attn_layout(cfg, TP, "q") == "seq"


@pytest.mark.parametrize("arch", TRAIN)
def test_references_sharded_step_agrees(runs, arch):
    """Three losses of the reference's jitted step under (1, 2, 2) rules
    and of the port's (1, 2, 2) ranks from the same params and batches."""
    want = runs[1]["losses"][arch]
    for rank, r in enumerate(runs[0]):
        got = r["ref", arch]
        assert all(abs(a - b) <= TOL * abs(b) for a, b in zip(got, want)), \
            (rank, got, want)


def test_dropped_model2_gather_fails(runs):
    """Without the all-gather over 'model2' each rank stores its own
    gradient slice in its partner's chunk: the trained state leaves the
    bound ten times over on every rank."""
    errs = [r["no_model2_gather"]["state_err"] for r in runs[0]]
    assert min(errs) > 10 * TOL, errs


def _check_serving(results):
    for rank, r in enumerate(results):
        assert r["tokens_equal"], (rank, r["tokens"])
        assert r["err"] <= TOL, (rank, r["err"])
        assert r["bad"] == [], (rank, r["bad"])
    assert all(np.array_equal(r["tokens"], results[0]["tokens"])
               for r in results)


@pytest.mark.parametrize("case", [("serve", a) for a in SERVE] +
                         [("serve", "seq_heads"), ("long", "llama3.2-1b")])
def test_serving_matches_one_process(runs, case):
    _check_serving([r[case] for r in runs[0]])


@pytest.mark.parametrize("arch", SERVE)
def test_serving_matches_the_reference_sharded(runs, arch):
    """Rank 0's logits on (1, 2, 2) against the JAX package's sharded
    steps on 4 XLA devices, same params, same prompts."""
    got, ref = runs[0][0]["serve", arch], runs[1]["serve"][arch]
    assert np.array_equal(got["tokens"], ref["tokens"])
    assert len(got["logits"]) == len(ref["logits"])
    for g, w in zip(got["logits"], ref["logits"]):
        assert np.max(np.abs(g - w)) / np.max(np.abs(w)) <= TOL


@pytest.mark.parametrize("where,shape,kv,g,q", [
    ("r13_test_mesh", (1, 2, 2), 2, 1, 32),
    ("r13_production", (16, 8, 2), 8, 5, 4096)])
def test_attention_reads_both_model_axes(runs, where, shape, kv, g, q):
    """R13: under tp2d rules the reference's ``attn_shard_choice`` takes
    the product of 'model' and 'model2' (4 here, 16 on the production
    mesh), and so chooses "q" for heads that the 'model' axis alone would
    split (None): llama4-scout's KV 8, G 5 at 16. The port's choice under
    its own rules is the same, and its attention takes the "seq" layout
    there."""
    from repro_torch.dist import sharding
    from repro_torch.models.layers import attn_layout
    want = runs[1][where]
    assert want["tp_size"] == shape[1] * shape[2]
    assert (want["choice"], want["choice_model_only"]) == ("q", None)
    rules = sharding.Rules(sharding.MeshShape(
        shape, ("data", "model", "model2")), "train")
    with sharding.use_rules(rules):
        assert sharding.tp_size() == want["tp_size"]
        assert sharding.attn_shard_choice(kv, g, q) == want["choice"]
    assert sharding.attn_shard_choice(kv, g, q, shape[1]) is None
    if where == "r13_production":
        from repro_torch.configs import get_config
        cfg = get_config("llama4-scout-17b-a16e")
        assert (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads) == (kv, g)
        assert attn_layout(cfg, 16, "q") == "seq"
