"""The RWKV-6 chunked WKV (K7) of the PyTorch port and the port's RWKV-6
layer, held against the JAX package on the CPU.

The CUDA kernel itself runs only on a card (``tests/test_torch_cuda.py``);
here its plain version, which repeats the kernel's per-chunk arithmetic,
stands for it. Inputs are made with numpy from a seed and handed to both
packages.

Tolerances and why:
  * plain version against the Pallas kernel (interpret mode), the
    reference's sequential ``wkv6_ref`` and the reference model's
    ``wkv_chunked`` (out and final state): 1e-4 relative to max(1,
    max|ref|), the bound the reference holds its own kernel to
    (``tests/test_kernels.py``); the forms sum in other orders.
  * the port's torch ``wkv6_ref`` against the reference's: 1e-5 relative.
  * the RWKV-6 layer (``rwkv_block``, prefill and one decode step) on
    reduced rwkv6 weights: 1e-4 relative in float32; 3e-2 relative in
    bfloat16, where torch and XLA round the lerps, group norm and gates at
    other places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.rwkv6 import wkv6_chunked as pallas_wkv
from repro.kernels.rwkv6 import wkv6_ref as jax_wkv_ref
from repro.models import rwkv6 as RM
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.kernels import rwkv6 as K7
from repro_torch.models import rwkv6 as TM

CPU = torch.device("cpu")


def _rel(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))
                 / max(1.0, float(np.max(np.abs(want)))))


def _inputs(B, H, S, dh, seed=0, strong=False):
    """The reference's test distributions (``tests/test_kernels.py``);
    ``strong`` draws decays down to the model's clip at -20 per step."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, dh)).astype(np.float32)
               for _ in range(3))
    g = rng.standard_normal((B, H, S, dh))
    logw = -np.exp(g * 2 - 1) if strong else -np.exp(g * 0.5 - 2)
    logw = np.clip(logw, -20.0, -1e-6).astype(np.float32)
    u = (rng.standard_normal((H, dh)) * 0.3).astype(np.float32)
    return r, k, v, logw, u


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# the reference's shapes, then the model's chunks (32 reduced, 128 full)
SHAPES = [(2, 3, 96, 32, 32), (1, 2, 128, 64, 128), (2, 2, 200, 16, 64),
          (1, 2, 150, 32, 32), (1, 2, 300, 64, 128)]


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("B,H,S,dh,chunk", SHAPES)
def test_plain_matches_pallas_and_sequential(B, H, S, dh, chunk, strong):
    arrs = _inputs(B, H, S, dh, strong=strong)
    out, state = K7.wkv6_chunked(*_t(*arrs), chunk=chunk)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, H, S, dh)
    assert tuple(state.shape) == (B, H, dh, dh)
    assert bool(torch.isfinite(out).all() and torch.isfinite(state).all())
    pallas = pallas_wkv(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                        interpret=True)
    assert _rel(out, pallas) < 1e-4
    assert _rel(out, jax_wkv_ref(*(jnp.asarray(a) for a in arrs))) < 1e-4
    assert K7.LAUNCHES["wkv6_chunked"] == 0    # a CPU tensor: plain version


def test_port_sequential_ref_matches_reference():
    arrs = _inputs(2, 3, 70, 16, seed=1)
    want = jax_wkv_ref(*(jnp.asarray(a) for a in arrs))
    assert _rel(K7.wkv6_ref(*_t(*arrs)), want) < 1e-5


@pytest.mark.parametrize("S,chunk,zero_state", [
    (150, 32, True), (150, 32, False), (300, 128, False), (64, 32, False)])
def test_final_and_initial_state_match_reference_model(S, chunk, zero_state):
    """The reference model's ``wkv_chunked`` (model layout (B,S,H,dh))
    returns the state it carries; the port's must return the same state
    and output, from zero or from a given state."""
    B, H, dh = 2, 3, 32
    r, k, v, logw, u = (np.moveaxis(a, 1, 2) if a.ndim == 4 else a
                        for a in _inputs(B, H, S, dh, seed=S))
    s0 = np.random.default_rng(S + 1).standard_normal(
        (B, H, dh, dh)).astype(np.float32)
    if zero_state:
        s0 = np.zeros_like(s0)
    want_o, want_s = RM.wkv_chunked(*(jnp.asarray(a) for a in
                                      (r, k, v, logw, u, s0)), chunk)
    got_o, got_s = TM.wkv_chunked(*_t(r, k, v, logw, u, s0), chunk)
    assert tuple(got_o.shape) == (B, S, H, dh)
    assert _rel(got_o, want_o) < 1e-4 and _rel(got_s, want_s) < 1e-4
    o, s = K7.wkv6_chunked(*(t.transpose(1, 2) for t in
                             _t(r, k, v, logw)), torch.from_numpy(u),
                           chunk=chunk,
                           state=None if zero_state else torch.from_numpy(s0))
    assert _rel(o.transpose(1, 2), want_o) < 1e-4 and _rel(s, want_s) < 1e-4


def test_state_carries_across_calls():
    arrs = _t(*_inputs(1, 2, 300, 32, seed=3, strong=True))
    out, s = K7.wkv6_chunked(*arrs, chunk=32)
    r, k, v, lw, u = arrs
    o1, s1 = K7.wkv6_chunked(r[:, :, :96], k[:, :, :96], v[:, :, :96],
                             lw[:, :, :96], u, chunk=32)
    o2, s2 = K7.wkv6_chunked(r[:, :, 96:], k[:, :, 96:], v[:, :, 96:],
                             lw[:, :, 96:], u, chunk=32, state=s1)
    assert _rel(torch.cat([o1, o2], 2), out.numpy()) < 1e-5
    assert _rel(s2, s.numpy()) < 1e-5


def test_wrapper_checks_its_inputs():
    r, k, v, lw, u = _t(*_inputs(1, 2, 10, 8))
    with pytest.raises(ValueError):
        K7.wkv6_chunked(r, k, v[:, :, :5], lw, u, chunk=4)
    with pytest.raises(ValueError):
        K7.wkv6_chunked(r, k, v, lw, u[:1], chunk=4)
    with pytest.raises(ValueError, match="unsupported device"):
        K7.wkv6_chunked(*(t.to("meta") for t in (r, k, v, lw, u)), chunk=4)


def _layer_params(cfg, dtype):
    p = RM.init_rwkv_layer(jax.random.PRNGKey(0), cfg, 1, dtype)
    return jax.tree.map(lambda a: np.asarray(a)[0], p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_block_prefill_and_step_match_reference(dtype):
    cfg = jax_get_config("rwkv6-1.6b").reduced()
    tcfg = get_config("rwkv6-1.6b").reduced()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p = _layer_params(cfg, jdt)
    B, S = 2, 100
    x = np.random.default_rng(4).standard_normal((B, S + 1, cfg.d_model)) \
        .astype(np.float32)
    st = jax.tree.map(lambda a: np.asarray(a)[0],
                      RM.init_rwkv_state(cfg, B, jdt))
    block = jax.jit(lambda x, p, s: RM.rwkv_block(x, p, cfg, s))
    want, want_st = block(jnp.asarray(x[:, :S]).astype(jdt), p, st)
    tp = from_jax(p, CPU)
    got, got_st = TM.rwkv_block(torch.from_numpy(x[:, :S]).to(tdt), tp, tcfg,
                                from_jax(st, CPU))
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert got.dtype == tdt
    assert _rel(got, want) < tol
    for k in ("shift", "wkv", "cshift"):
        assert _rel(got_st[k], want_st[k]) < tol, k
    # one decode step from the prefill state (wkv_step, the recurrence)
    st1 = jax.tree.map(np.asarray, want_st)
    want1, want_st1 = block(jnp.asarray(x[:, S:]).astype(jdt), p, st1)
    got1, got_st1 = TM.rwkv_block(torch.from_numpy(x[:, S:]).to(tdt), tp,
                                  tcfg, from_jax(st1, CPU))
    assert _rel(got1, want1) < tol
    assert _rel(got_st1["wkv"], want_st1["wkv"]) < tol


def test_projections_clip_the_decay_like_the_reference():
    """w0 + lora pushed far both ways: logw is clipped to [-20, -1e-6]."""
    cfg = jax_get_config("rwkv6-1.6b").reduced()
    p = _layer_params(cfg, jnp.float32)
    p["w0"] = np.where(np.arange(cfg.rwkv.head_size) % 2, 8.0, -30.0) \
        .astype(np.float32) * np.ones_like(p["w0"])
    x = np.random.default_rng(6).standard_normal((1, 5, cfg.d_model)) \
        .astype(np.float32)
    H, dh = cfg.n_heads, cfg.rwkv.head_size
    want = RM._projections(jnp.asarray(x), jnp.asarray(x), p, H, dh)
    got = TM._projections(torch.from_numpy(x), torch.from_numpy(x),
                          from_jax(p, CPU), H, dh)
    assert float(got[4].min()) == -20.0
    assert float(got[4].max()) == float(np.float32(-1e-6))
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5
