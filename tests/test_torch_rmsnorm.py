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

# the reference's test shapes, then decode's (4 rows of d 2,048 and 4,096)
# and 16 rows of 4,096
SHAPES = [(8, 64, 128), (3, 100), (512, 256), (1, 7), (4, 2048), (4, 4096),
          (16, 4096)]
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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_with_a_bf16_scale_matches_pallas_and_model(shape, dtype):
    """The same with the scale in bf16, as the served models hold it: the
    reference rounds it to x's dtype (``scale.astype(x.dtype)``) as the
    port does. Within the tolerance of the Pallas kernel, and of the
    model's rmsnorm; where the reference's two disagree by the tolerance or
    more (f32 at d 4,096 here: 1.14e-5, their sums of 4,096 squares taken
    in other orders), no farther from the model than the Pallas kernel
    is."""
    jdt, tdt, tol = DTYPES[dtype]
    x, s = _inputs(shape, seed=3)
    sj = jnp.asarray(s).astype(jnp.bfloat16)
    xj = jnp.asarray(x).astype(jdt)
    pallas = jax_rmsnorm(xj, sj, interpret=True)
    model = rmsnorm_ref(xj, sj)
    got = rmsnorm(torch.from_numpy(x).to(tdt),
                  torch.from_numpy(s).to(torch.bfloat16))
    assert got.dtype == tdt and got.shape == shape
    got = got.float().numpy()
    assert _err(got, pallas) < tol
    assert _err(got, model) < tol or \
        _err(got, model) <= _err(pallas, model)


def _sum_of_squares(x, g):
    """The stated order in numpy, f32 throughout: the rows' values in
    groups of g, each group's squares added left to right, then a halving
    tree over the groups padded with zero groups to a power of two (group
    j with j + N/2, then j + N/4, ...). x: (rows, W) float32."""
    rows, W = x.shape
    n = -(-W // g)
    N = 1
    while N < n:
        N *= 2
    xp = np.zeros((rows, N * g), np.float32)
    xp[:, :W] = x
    sq = xp * xp
    sums = []
    for j in range(N):
        a = sq[:, j * g]
        for i in range(1, g):
            a = a + sq[:, j * g + i]
        sums.append(a)
    while len(sums) > 1:
        h = len(sums) // 2
        sums = [sums[j] + sums[j + h] for j in range(h)]
    return sums[0]


@pytest.mark.parametrize("d", [7, 100, 128, 2048])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_order_does_not_depend_on_the_padding(d, dtype):
    """The numpy order above gives the same bits on the row zero-padded to
    2x and 4x its width (a layout pads the groups to its own power of two),
    and the plain version's output is the one its sum gives."""
    _, tdt, _ = DTYPES[dtype]
    x, s = _inputs((4, d), seed=d)
    xt = torch.from_numpy(x).to(tdt)
    xv = xt.float().numpy()
    g = 16 // xt.element_size()
    ss = _sum_of_squares(xv, g)
    for k in (2, 4):
        wide = np.zeros((4, k * d), np.float32)
        wide[:, :d] = xv
        assert np.array_equal(_sum_of_squares(wide, g), ss), k
    t = torch.from_numpy(ss)[:, None]
    root = torch.sqrt((t / torch.full_like(t, d) + 1e-5).double()).float()
    r = (torch.ones_like(root) / root).to(tdt)
    st = torch.from_numpy(s)
    assert torch.equal(rmsnorm_plain(xt, st), (xt * r) * st.to(tdt))


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


@pytest.mark.parametrize("bad", ["dtype", "scale", "device", "scale dtype",
                                 "width"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x, s = torch.zeros(4, 8), torch.ones(8)
    if bad == "dtype":
        x = x.to(torch.float16)
    elif bad == "scale":
        s = torch.ones(7)
    elif bad == "scale dtype":            # the kernel reads f32, bf16, f16
        s = s.to(torch.float64)
    elif bad == "width":                  # more than 8,192 16-byte groups
        x, s = torch.zeros(1, 4 * 8192 + 1), torch.ones(4 * 8192 + 1)
    else:
        x, s = x.to("meta"), s.to("meta")
    with pytest.raises(ValueError):
        rmsnorm(x, s)
