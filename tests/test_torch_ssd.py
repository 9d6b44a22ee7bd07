"""The Mamba-2 SSD chunk scan (K6) of the PyTorch port and the port's
Mamba-2 layer, held against the JAX package on the CPU.

The CUDA kernel itself runs only on a card (``tests/test_torch_cuda.py``);
here its plain version, which repeats the kernel's per-chunk arithmetic,
stands for it. Inputs are made with numpy from a seed and handed to both
packages.

Tolerances and why:
  * plain version against the Pallas kernel (interpret mode), the
    reference's sequential ``ssd_ref`` and the reference model's
    ``ssd_chunked`` (y and final state): 1e-4 relative to max(1, max|ref|),
    the bound the reference holds its own kernel to
    (``tests/test_kernels.py``). The chunked and sequential forms sum in
    other orders (measured ~1e-6).
  * the port's torch ``ssd_ref`` against the reference's: 1e-5 relative
    (the same recurrence, einsums in another order).
  * the Mamba-2 layer (``mamba_block``, prefill and one decode step) on
    reduced zamba2 weights: 1e-4 relative in float32; 3e-2 relative in
    bfloat16, where torch and XLA round the conv, silu and gated norm at
    other places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.mamba2_ssd import ssd_chunked as pallas_ssd
from repro.kernels.mamba2_ssd import ssd_ref as jax_ssd_ref
from repro.models import mamba2 as RM
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.kernels import mamba2_ssd as K6
from repro_torch.models import mamba2 as TM

CPU = torch.device("cpu")


def _rel(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))
                 / max(1.0, float(np.max(np.abs(want)))))


def _inputs(B, H, S, dh, N, seed=0):
    """The reference's test distributions (``tests/test_kernels.py``)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, S, dh)).astype(np.float32)
    lw = (-np.abs(rng.standard_normal((B, H, S))) * 0.1).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    return x, lw, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# the reference's shapes, then the model's chunks (64 reduced, 256 full)
SHAPES = [(2, 3, 96, 32, 16, 32), (1, 2, 128, 64, 64, 128),
          (2, 2, 200, 32, 64, 64), (1, 2, 300, 32, 16, 64),
          (1, 2, 600, 64, 64, 256)]


@pytest.mark.parametrize("B,H,S,dh,N,chunk", SHAPES)
def test_plain_matches_pallas_and_sequential(B, H, S, dh, N, chunk):
    arrs = _inputs(B, H, S, dh, N)
    y, state = K6.ssd_chunked(*_t(*arrs), chunk=chunk)
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, H, S, dh)
    assert tuple(state.shape) == (B, H, dh, N)
    pallas = pallas_ssd(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                        interpret=True)
    assert _rel(y, pallas) < 1e-4
    assert _rel(y, jax_ssd_ref(*(jnp.asarray(a) for a in arrs))) < 1e-4
    assert K6.LAUNCHES["ssd_chunked"] == 0     # a CPU tensor: plain version


def test_port_sequential_ref_matches_reference():
    arrs = _inputs(2, 3, 70, 16, 8, seed=1)
    want = jax_ssd_ref(*(jnp.asarray(a) for a in arrs))
    assert _rel(K6.ssd_ref(*_t(*arrs)), want) < 1e-5


def _model_args(B, S, H, dh, N, seed):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1)) \
        .astype(np.float32)
    a_log = np.log(np.linspace(1, 16, H)).astype(np.float32)
    Bm, Cm = ((rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
              for _ in range(2))
    s0 = rng.standard_normal((B, H, dh, N)).astype(np.float32)
    return xh, dt, a_log, Bm, Cm, s0


@pytest.mark.parametrize("S,chunk,zero_state", [
    (150, 64, True), (150, 64, False), (520, 256, False), (64, 64, False)])
def test_final_and_initial_state_match_reference_model(S, chunk, zero_state):
    """The reference model's ``ssd_chunked`` returns the state it carries;
    the port's kernel path (through the model's function and the plain
    version) must return the same state and y, from zero or from a given
    state."""
    B, H, dh, N = 2, 3, 32, 16
    xh, dt, a_log, Bm, Cm, s0 = _model_args(B, S, H, dh, N, seed=S)
    if zero_state:
        s0 = np.zeros_like(s0)
    want_y, want_s = RM.ssd_chunked(*(jnp.asarray(a) for a in
                                      (xh, dt, a_log, Bm, Cm, s0)), chunk)
    got_y, got_s = TM.ssd_chunked(*_t(xh, dt, a_log, Bm, Cm, s0), chunk)
    assert tuple(got_y.shape) == (B, S, H, dh)
    assert _rel(got_y, want_y) < 1e-4 and _rel(got_s, want_s) < 1e-4
    # the same through the wrapper on the kernel's (B,H,S,dh) layout
    lw = torch.from_numpy(dt) * -torch.exp(torch.from_numpy(a_log))
    xs = torch.from_numpy(xh) * torch.from_numpy(dt)[..., None]
    y, s = K6.ssd_chunked(xs.transpose(1, 2), lw.transpose(1, 2),
                          *_t(Bm, Cm), chunk=chunk,
                          state=None if zero_state else torch.from_numpy(s0))
    assert _rel(y.transpose(1, 2), want_y) < 1e-4 and _rel(s, want_s) < 1e-4


def test_state_carries_across_calls():
    """Two calls, the second from the first's final state, equal one call
    over the whole sequence (what prefill hands to decode relies on)."""
    arrs = _t(*_inputs(1, 2, 300, 32, 16, seed=3))
    y, s = K6.ssd_chunked(*arrs, chunk=64)
    x, lw, Bm, Cm = arrs
    y1, s1 = K6.ssd_chunked(x[:, :, :128], lw[:, :, :128], Bm[:, :128],
                            Cm[:, :128], chunk=64)
    y2, s2 = K6.ssd_chunked(x[:, :, 128:], lw[:, :, 128:], Bm[:, 128:],
                            Cm[:, 128:], chunk=64, state=s1)
    assert _rel(torch.cat([y1, y2], 2), y.numpy()) < 1e-5
    assert _rel(s2, s.numpy()) < 1e-5


def test_wrapper_checks_its_inputs():
    x, lw, Bm, Cm = _t(*_inputs(1, 2, 10, 8, 4))
    with pytest.raises(ValueError):
        K6.ssd_chunked(x, lw[:, :1], Bm, Cm, chunk=4)
    with pytest.raises(ValueError):
        K6.ssd_chunked(x, lw, Bm, Cm, chunk=4,
                       state=torch.zeros(1, 2, 8, 5))
    with pytest.raises(ValueError, match="unsupported device"):
        K6.ssd_chunked(x.to("meta"), lw.to("meta"), Bm.to("meta"),
                       Cm.to("meta"), chunk=4)


def _layer_params(cfg, dtype):
    p = RM.init_mamba_layer(jax.random.PRNGKey(0), cfg, 1, dtype)
    return jax.tree.map(lambda a: np.asarray(a)[0], p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_prefill_and_step_match_reference(dtype):
    cfg = jax_get_config("zamba2-1.2b").reduced()
    tcfg = get_config("zamba2-1.2b").reduced()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p = _layer_params(cfg, jdt)
    B, S = 2, 100
    x = np.random.default_rng(4).standard_normal((B, S + 1, cfg.d_model)) \
        .astype(np.float32)
    st = jax.tree.map(lambda a: np.asarray(a)[0],
                      RM.init_mamba_state(cfg, 1, B, jdt))
    want, want_st = jax.jit(lambda x, p, s: RM.mamba_block(x, p, cfg, s))(
        jnp.asarray(x[:, :S]).astype(jdt), p, st)
    tp, tst = from_jax(p, CPU), from_jax(st, CPU)
    got, got_st = TM.mamba_block(torch.from_numpy(x[:, :S]).to(tdt), tp,
                                 tcfg, tst)
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert got.dtype == tdt
    assert _rel(got, want) < tol
    for k in ("ssm", "conv"):
        assert _rel(got_st[k], want_st[k]) < tol, k
    # one decode step from the prefill state (ssd_step, the recurrence)
    want1, want_st1 = jax.jit(lambda x, p, s: RM.mamba_block(x, p, cfg, s))(
        jnp.asarray(x[:, S:]).astype(jdt), p,
        jax.tree.map(np.asarray, want_st))
    got1, got_st1 = TM.mamba_block(torch.from_numpy(x[:, S:]).to(tdt), tp,
                                   tcfg, from_jax(jax.tree.map(
                                       np.asarray, want_st), CPU))
    assert _rel(got1, want1) < tol
    assert _rel(got_st1["ssm"], want_st1["ssm"]) < tol


def test_causal_conv_matches_reference_with_state():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    want = RM._causal_conv(*(jnp.asarray(a) for a in (x, w, b, st)))
    got = TM._causal_conv(*_t(x, w, b, st))
    for g, wa in zip(got, want):
        assert _rel(g, wa) < 1e-6
