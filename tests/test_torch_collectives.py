"""The port's compressed gradient sum (``repro_torch.dist.collectives``)
against the JAX package's, on the CPU.

  * The reference's three collective tests (``tests/test_sharding.py``),
    ported to a one-rank gloo group in this process.
  * Four ranks: the reference's ``compressed_psum`` under ``shard_map`` on
    4 XLA CPU devices (a fresh interpreter, ``torch_collectives_io.py``)
    and the port on four gloo ranks (``torch_ranks``), on the same seeded
    inputs, one rank's values 100x the others'. Each rank's new error is
    bit-equal: the scale, the int8 grid and ``x + err - deq`` are the same
    f32 operations. The sum is within 4 ulp of its largest |value|: XLA
    and gloo add the four ranks in other orders.
  * Rounding half to even (``torch.round`` and ``jnp.round`` both do) on
    values at exactly .5 of a quantization step, in both runs.
The same four ranks also build a DTensor for each placement case of
``torch_sharding_ref.PLACEMENTS`` with ``distribute``: each rank's slice is
the one ``devices_indices_map`` gives the device at its mesh position.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.collectives import quantize_int8 as ref_quantize_int8
from repro_torch.dist.collectives import (compressed_psum,
                                          compressed_tree_psum,
                                          dequantize_int8, quantize_int8,
                                          zeros_like_errors)
from torch_collectives_io import inputs
from torch_ranks import run_ranks

HERE = Path(__file__).resolve().parent


@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_quantize_roundtrip_error_bounded():
    x = torch.linspace(-3, 3, 1000)
    scale = torch.max(torch.abs(x))
    err = x - dequantize_int8(quantize_int8(x, scale), scale)
    assert float(err.abs().max()) <= float(scale) / 127 + 1e-6


def test_compressed_psum_single_device_exact_with_error_feedback(one_rank):
    """On one rank the sum is the identity; error feedback captures the
    quantization residual, so value + err reconstructs the input."""
    x = torch.tensor([0.1, -2.5, 3.14159, 0.0])
    err0 = torch.zeros_like(x)
    y, err = compressed_psum(x, err0, None)
    assert torch.allclose(y + err, x, atol=1e-6)
    # next round with error feedback converges toward exact
    y2, err2 = compressed_psum(x - y + y, err, None)
    assert torch.allclose((y + y2) / 2, x,
                          atol=float(x.abs().max()) / 127)


def test_compressed_tree_psum_shapes(one_rank):
    g = {"a": torch.ones((4, 4)), "b": {"c": torch.full((3,), -2.0)}}
    e = zeros_like_errors(g)
    out, err = compressed_tree_psum(g, e, None)
    assert out["a"].shape == (4, 4) and out["b"]["c"].shape == (3,)
    assert torch.allclose(out["a"] + err["a"], torch.ones((4, 4)),
                          atol=1e-6)
    assert err["b"]["c"].dtype == torch.float32


def test_round_half_to_even_as_the_reference():
    x, _, n_half = inputs()
    halves = x[0, :n_half]
    assert n_half >= 20
    got = quantize_int8(torch.from_numpy(halves), 1000.0).numpy()
    want = np.asarray(ref_quantize_int8(jnp.asarray(halves), 1000.0))
    assert np.array_equal(got, want)
    step = halves / np.float32(1000.0) * np.float32(127.0)
    assert np.all(step - np.floor(step) == 0.5)        # exactly halfway
    assert np.all(got % 2 == 0)                        # to even


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coll")
    x, err, n_half = inputs()
    np.savez(tmp / "in.npz", x=x, err=err)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(HERE.parent / "src"),
                                          str(HERE)])}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(HERE / "torch_collectives_io.py"),
                           str(tmp / "in.npz"), str(tmp / "ref.pkl")],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = pickle.loads((tmp / "ref.pkl").read_bytes())
    port = run_ranks(4, "torch_collectives_io:four_ranks",
                     {"path": str(tmp / "in.npz")}, timeout=180)
    return x, err, n_half, ref, port


@pytest.mark.parametrize("rank", range(4))
def test_four_rank_new_error_bit_equal(parity, rank):
    x, err, n_half, ref, port = parity
    assert np.array_equal(port[rank]["err"], ref["err"][rank])
    assert np.array_equal(port[rank]["tree_err"], ref["err"][rank])
    assert np.abs(ref["err"][rank]).max() > 0


@pytest.mark.parametrize("rank", range(4))
def test_four_rank_sum_within_four_ulp(parity, rank):
    x, err, n_half, ref, port = parity
    want = ref["sum"][rank]
    tol = 4 * np.spacing(np.abs(want).max())
    assert np.abs(port[rank]["sum"] - want).max() <= tol
    assert np.array_equal(port[rank]["tree_sum"], port[rank]["sum"])
    assert np.array_equal(port[rank]["sum"], port[0]["sum"])


def test_four_rank_halfway_values_round_to_even(parity):
    """Rank 0's first values sit at .5 of a step of the agreed scale
    (1000): both runs leave the same error there, that of the even
    neighbour."""
    x, err, n_half, ref, port = parity
    halves = x[0, :n_half]
    q_even = quantize_int8(torch.from_numpy(halves), 1000.0)
    want = halves - dequantize_int8(q_even, 1000.0).numpy()
    assert np.array_equal(port[0]["err"][:n_half], want)
    assert np.array_equal(ref["err"][0][:n_half], want)


@pytest.mark.parametrize("rank", range(4))
def test_four_gloo_ranks_get_the_reference_slices(parity, rank):
    x, err, n_half, ref, port = parity
    assert port[rank]["slices"] == [s[rank] for s in ref["slices"]]
    assert all(port[rank]["whole"])
