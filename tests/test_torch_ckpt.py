"""The port's checkpoints (``repro_torch.ckpt``) against the JAX package's:
a checkpoint of the same state writes the same leaf ``.npy`` bytes,
fletcher64 sums and ``manifest.json`` (provenance equal apart from its
times and host), each package restores the other's, and the checks of
``tests/test_storage_ckpt.py:81-150`` hold on the port: round trip,
corruption detection, async retention and archive, a restart that resumes
training state. The training loop (``repro_torch.launch.train``) resumes
from its latest checkpoint and replays the same batches. No tolerance: the
bytes are equal, and the CPU runs are deterministic."""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as ref_restore
from repro.ckpt import save_checkpoint as ref_save
from repro.configs import get_config as ref_get_config
from repro.train import init_train_state as ref_init_train_state
from repro_torch import tree as tree_util
from repro_torch.ckpt import (CheckpointManager, latest_step,
                              restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.core import IntegrityError, TieredStore
from repro_torch.data import make_lm_batches
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train
from repro_torch.train import OptConfig, init_train_state, make_train_step

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these many small CPU ops: alone they run
    as fast, and beside other test processes on a few cores they do not
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_tree():
    return {"w": jnp.arange(12.0).reshape(3, 4),
            "nested": {"b": jnp.ones(5, jnp.bfloat16) * 1.5,
                       "seq": [jnp.int32(3), jnp.zeros((2, 0))]},
            "step": jnp.int32(7)}


def _tree():
    return from_jax(jax.tree.map(np.asarray, _ref_tree()), CPU)


def _ref_state(arch):
    cfg = ref_get_config(arch).reduced(n_layers=2, vocab_size=128)
    params, opt = ref_init_train_state(cfg, jax.random.PRNGKey(0))
    opt = dict(opt, m=jax.tree.map(lambda p: 0.5 * p, params),
               step=jnp.int32(11))
    return jax.tree.map(np.asarray, {"params": params, "opt": opt})


STATES = {"tree": lambda: jax.tree.map(np.asarray, _ref_tree()),
          "llama3.2-1b": lambda: _ref_state("llama3.2-1b"),
          "rwkv6-1.6b": lambda: _ref_state("rwkv6-1.6b"),
          "zamba2-1.2b": lambda: _ref_state("zamba2-1.2b")}


def _equal_trees(got, want):
    """Port tensors against reference arrays: same keys, shapes, dtypes
    (bf16 as bf16) and bits."""
    g, w = list(tree_util.flatten_with_paths(got)), \
        jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(g) == len(w)
    for (path, a), (_, b) in zip(g, w):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, path
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), path
        if b.dtype.name == "bfloat16":
            a, b = a.view(torch.int16), b.view(np.int16)
        assert np.array_equal(a.numpy(), b), path


@pytest.mark.parametrize("name", list(STATES))
def test_checkpoint_bytes_equal_the_reference(tmp_path, name):
    state = STATES[name]()
    ref_dir = ref_save(tmp_path / "ref", 3, state, digest="d1",
                       extra={"loss": 2.5})
    port_dir = save_checkpoint(tmp_path / "port", 3, from_jax(state, CPU),
                               digest="d1", extra={"loss": 2.5})
    files = sorted(p.name for p in ref_dir.iterdir())
    assert sorted(p.name for p in port_dir.iterdir()) == files
    for f in files:
        if f == "provenance.json":
            continue
        assert (port_dir / f).read_bytes() == (ref_dir / f).read_bytes(), f
    got = json.loads((port_dir / "provenance.json").read_text())
    want = json.loads((ref_dir / "provenance.json").read_text())
    for k in ("started_at", "finished_at", "host"):
        got.pop(k), want.pop(k)
    assert got == want


@pytest.mark.parametrize("name", list(STATES))
def test_each_package_restores_the_others(tmp_path, name):
    state = STATES[name]()
    ref_save(tmp_path / "ref", 5, state, extra={"s": 5})
    tmpl = from_jax(state, CPU)
    got, step, extra = restore_checkpoint(tmp_path / "ref", tmpl,
                                          device="cpu")
    assert step == 5 and extra == {"s": 5}
    _equal_trees(got, state)
    save_checkpoint(tmp_path / "port", 6, tmpl)
    back, step, _ = ref_restore(tmp_path / "port",
                                jax.eval_shape(lambda: state))
    assert step == 6
    _equal_trees(tmpl, back)


# the port alone, as tests/test_storage_ckpt.py:81-150 holds the reference

def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 10, tree, digest="abc", extra={"loss": 1.5})
    restored, step, extra = restore_checkpoint(tmp_path, tree, device="cpu")
    assert step == 10 and extra["loss"] == 1.5
    assert torch.equal(restored["w"], tree["w"])
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])
    assert restored["step"].dtype == torch.int32 and \
        restored["step"].dim() == 0
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, {**tree, "w": torch.ones(4, 3)},
                           device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(tmp_path, {**tree, "extra": torch.ones(1)},
                           device="cpu")


@pytest.mark.parametrize("leaf", ["w", "nested__b", "step"])
def test_checkpoint_corruption_detected(tmp_path, leaf):
    save_checkpoint(tmp_path, 1, _tree())
    victim = tmp_path / "step_00000001" / f"{leaf}.npy"
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0x01                   # one bit of the last value
    victim.write_bytes(bytes(raw))
    with pytest.raises(IntegrityError, match="corrupted"):
        restore_checkpoint(tmp_path, _tree(), device="cpu")


def test_checkpoint_manager_async_retention_and_archive(tmp_path):
    store = TieredStore(tmp_path / "store")
    mgr = CheckpointManager(tmp_path / "ckpt", keep=2, cold_store=store)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _tree(), extra={"s": s})
    mgr.wait()
    assert latest_step(tmp_path / "ckpt") == 4
    steps = sorted(p.name for p in (tmp_path / "ckpt").glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]        # retention
    assert store.exists("ckpt/step_00000004/manifest.json", tier="cold")
    got, step, extra = mgr.restore_latest(_tree(), device="cpu")
    assert step == 4 and extra == {"s": 4}


def test_async_save_copies_before_its_thread_starts(tmp_path):
    """A write into a tensor after ``save_async`` returns does not reach
    the checkpoint."""
    tree = _tree()
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save_async(1, tree)
    tree["w"].fill_(-1.0)
    mgr.wait()
    got, _, _ = restore_checkpoint(tmp_path / "ckpt", tree, device="cpu")
    assert torch.equal(got["w"], torch.arange(12.0).reshape(3, 4))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b",
                                  "zamba2-1.2b"])
def test_restart_resumes_training_state(tmp_path, arch):
    """Simulated node failure: the state restored bit-identical, and the
    next step from it gives the uninterrupted run's loss and params."""
    cfg = get_config(arch).reduced()
    params, opt_state = init_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    step_fn = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1))
    batches = make_lm_batches(cfg, 2, 32, 4)
    for b in batches[:2]:
        params, opt_state, _ = step_fn(params, opt_state, b)
    state = {"params": params, "opt": opt_state}
    save_checkpoint(tmp_path, 2, state)
    restored, step, _ = restore_checkpoint(tmp_path, state, device="cpu")
    assert step == 2
    for a, b in zip(tree_util.leaves(restored), tree_util.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    a1, _, m1 = step_fn(params, opt_state, batches[2])
    a2, _, m2 = step_fn(restored["params"], restored["opt"], batches[2])
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-6)
    for x, y in zip(tree_util.leaves(a1), tree_util.leaves(a2)):
        assert torch.equal(x, y)


def test_train_loop_resumes_and_replays_the_batches(tmp_path):
    """A run of 8 steps, and the same run cut after its step-4 checkpoint
    and resumed: the same losses from step 5 on and the same final
    params."""
    kw = dict(steps=8, batch=2, seq=32, ckpt_every=4, log_every=4,
              data_dir=str(tmp_path / "data"), device="cpu")
    full, losses = train("zamba2-1.2b", ckpt_dir=str(tmp_path / "a"), **kw)
    assert len(losses) == 8 and np.isfinite(losses).all()
    # the cut run: its checkpoints of steps 4 and 8, the step-8 one lost
    train("zamba2-1.2b", ckpt_dir=str(tmp_path / "b"), **kw)
    shutil.rmtree(tmp_path / "b" / "step_00000008")
    assert latest_step(tmp_path / "b") == 4
    resumed, tail = train("zamba2-1.2b", ckpt_dir=str(tmp_path / "b"),
                          resume=True, **kw)
    assert tail == losses[4:]
    for a, b in zip(tree_util.leaves(resumed), tree_util.leaves(full)):
        assert torch.equal(a, b)
    assert latest_step(tmp_path / "b") == 8


def test_train_cli_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    small = ["--batch", "2", "--seq", "32"]
    train_main(["--arch", "llama3.2-1b", "--device", "cpu", "--steps", "20",
                *small])
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[:2] for line in out] == [["step", "10"],
                                                 ["step", "20"]]
    assert all("tok/s on cpu" in line for line in out)
    assert latest_step(tmp_path / "ckpt") == 20
    train_main(["--arch", "llama3.2-1b", "--device", "cpu", "--steps", "25",
                "--resume", *small])
    assert capsys.readouterr().out.splitlines()[0] == "resumed from step 20"
    assert latest_step(tmp_path / "ckpt") == 25
