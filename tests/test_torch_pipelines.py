"""The port's pipelines against the JAX package's on the same numpy volumes
(16^3 and 32x32x24), on the CPU.

Tolerances and why:
  * bias_correct, relative <= 1e-4: the port solves the full-rank
    least-squares system by float64 normal equations, the reference by a
    float32 SVD (about 1e-5 measured).
  * affine_register, theta <= 1e-4 abs and warped volume <= 5e-3 abs: the
    start (identity) puts every sample on a voxel corner, where the
    sampler's floor makes the gradient discontinuous. The grids therefore
    reproduce the bits of XLA's compiled linspace (``_linspace``); what is
    left is the order of the loss and gradient reductions, and the
    reference's eager linspace for the atlas and the final warp, which has
    other bits again.
  * dwi_prequal, relative <= 1e-4: LAPACK SVDs in two libraries; the
    rank-3 reconstruction does not depend on the singular vectors' signs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipelines import builtin_pipelines as jax_pipelines
from repro_torch.core.pipelines import _linspace, builtin_pipelines

SHAPES = [(16, 16, 16), (32, 32, 24)]


def _t1(shape, seed=0):
    """A bright off-centre blob on a noisy floor, under a bias ramp."""
    rng = np.random.default_rng(seed)
    gx, gy, gz = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape],
                             indexing="ij")
    v = 100 * np.exp(-3 * ((gx - 0.1) ** 2 + gy ** 2 + (gz + 0.05) ** 2))
    v = v + rng.normal(10, 2, shape)
    return (v * (1 + 0.2 * gx)).astype(np.float32)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def pipes():
    return jax_pipelines(), builtin_pipelines("cpu")


@pytest.mark.parametrize("n", [1, 2, 7, 16, 24, 32, 60, 96, 176, 256])
def test_linspace_bits_equal_xla_compiled(n):
    want = np.asarray(jax.jit(lambda: jnp.linspace(-1, 1, n))())
    got = _linspace(n, torch.device("cpu")).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_bias_correct_matches_reference(pipes, shape):
    ref, port = (p["bias_correct"].run({"T1w": _t1(shape)}) for p in pipes)
    assert set(port) == set(ref)
    for k in ref:
        assert port[k].dtype == np.float32 and port[k].shape == ref[k].shape
        assert _rel(port[k], ref[k]) <= 1e-4, k


@pytest.mark.parametrize("shape", SHAPES)
def test_affine_register_matches_reference(pipes, shape):
    ref, port = (p["affine_register"].run({"T1w": _t1(shape)})
                 for p in pipes)
    assert port["affine"].shape == (3, 4)
    assert port["reg_loss"].shape == (60,)
    assert np.max(np.abs(port["affine"] - ref["affine"])) <= 1e-4
    assert np.max(np.abs(port["T1w_reg"] - ref["T1w_reg"])) <= 5e-3
    assert np.max(np.abs(port["reg_loss"] - ref["reg_loss"])) <= 1e-4
    assert port["reg_loss"][-1] < port["reg_loss"][0]


@pytest.mark.parametrize("shape", SHAPES)
def test_dwi_prequal_matches_reference(pipes, shape):
    dwi = np.random.default_rng(1).normal(80, 15, shape + (6,)) \
        .astype(np.float32)
    inputs = {"T1w": _t1(shape), "dwi": dwi}
    ref, port = (p["dwi_prequal"].run(inputs) for p in pipes)
    assert port["dwi_denoised"].dtype == np.float32
    assert _rel(port["dwi_denoised"], ref["dwi_denoised"]) <= 1e-4
