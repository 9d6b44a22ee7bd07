"""The port's RMSNorm (K4) held against the JAX package on the CPU: its
Pallas kernel (interpret mode) and the model's own rmsnorm
(``rmsnorm_ref``), on the shapes and dtypes of ``tests/test_kernels.py``.

Here the wrapper runs the kernel's plain version (the tensors lie on the
CPU); the CUDA kernel is held against that plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Tolerances, as the reference sets them on its own kernel: 1e-5 absolute in
float32 (the f32 sum of squares is taken in another order), 3e-2 in
bfloat16 (both products are rounded to bf16 on both sides; the normaliser
may land on the other side of a bf16 rounding boundary).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.rmsnorm import rmsnorm_ref
from repro_torch.kernels.rmsnorm import LAUNCHES, rmsnorm, rmsnorm_plain
from repro_torch.models.layers import rmsnorm as layer_rmsnorm

SHAPES = [(8, 64, 128), (3, 100), (512, 256), (1, 7)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (np.abs(rng.standard_normal(shape[-1:])) + 0.5).astype(np.float32)
    return x, s


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                                - np.asarray(b, np.float32))))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_matches_pallas_and_model(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, s = _inputs(shape)
    xj = jnp.asarray(x).astype(jdt)
    pallas = jax_rmsnorm(xj, jnp.asarray(s), interpret=True)
    model = rmsnorm_ref(xj, jnp.asarray(s))
    got = rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(s))
    assert got.dtype == tdt and got.shape == shape
    got = got.float().numpy()
    assert _err(got, pallas) < tol
    assert _err(got, model) < tol


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bf16_scale_rounds_before_the_multiply(dtype):
    """The f32 scale of the params is cast to x's dtype first, as
    ``scale.astype(x.dtype)`` does; a bf16 scale reads the same."""
    jdt, tdt, tol = DTYPES[dtype]
    x, _ = _inputs((16, 128), seed=1)
    s = np.float32(1) + np.float32(2.0 ** -10) * np.arange(128, dtype=np.float32)
    want = rmsnorm_ref(jnp.asarray(x).astype(jdt), jnp.asarray(s))
    xt = torch.from_numpy(x).to(tdt)
    got = rmsnorm(xt, torch.from_numpy(s))
    assert _err(got.float(), want) < tol
    if tdt == torch.bfloat16:
        assert torch.equal(got, rmsnorm(xt, torch.from_numpy(s).to(tdt)))


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    x, s = _inputs((5, 64), seed=2)
    xt, st = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(s)
    before = LAUNCHES["rmsnorm"]
    assert torch.equal(rmsnorm(xt, st), rmsnorm_plain(xt, st))
    assert torch.equal(layer_rmsnorm(xt, st, 1e-5), rmsnorm_plain(xt, st))
    assert LAUNCHES["rmsnorm"] == before


@pytest.mark.parametrize("bad", ["dtype", "scale", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x, s = torch.zeros(4, 8), torch.ones(8)
    if bad == "dtype":
        x = x.to(torch.float16)
    elif bad == "scale":
        s = torch.ones(7)
    else:
        x, s = x.to("meta"), s.to("meta")
    with pytest.raises(ValueError):
        rmsnorm(x, s)
