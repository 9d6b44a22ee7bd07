"""The port's LM training (``repro_torch.train``, ``models.forward_train``
and its losses) against the JAX package's, on the CPU, at reduced configs
(2 layers, vocab 128): dense (llama3.2-1b), rwkv (rwkv6-1.6b) and hybrid
(zamba2-1.2b) throughout; moe (moonshot-v1-16b-a3b, with its aux loss),
audio (whisper-small: frames through the encoder) and vlm (internvl2-76b:
patch embeddings ahead of the tokens) in the loss, gradient and train-step
cases of ``FAMILIES``; with the reference's weights carried across by
``repro_torch.convert.from_jax``.

Tolerances and why:
  * ``lr_schedule``: 1e-7 relative, float32's last bit or so (both compute
    it in f32).
  * one ``adamw_update`` from the same grads: 1e-6 absolute (f32, the
    same formula; sums of squares in other orders).
  * ``forward_train``'s loss and metrics: 1e-4 relative in float32 (sums
    in other orders) and 3e-2 in bfloat16, the bf16 tolerance the reference
    sets on its own kernels.
  * each gradient leaf of the f32 loss against ``jax.grad``: 1e-4 of the
    leaf's largest |value|.
  * the first train step's updated params: AdamW's first step moves a
    weight by lr x g / (|g| + eps), about lr whatever g's size, so a
    gradient element near eps may move its weight anywhere in +-lr: the
    params are held to 2 lr absolute, and to 1e-6 where the two gradients
    are both farther than 1e-6 from zero (their signs then agree).
  * ``remat=True`` against ``remat=False``, and ``accum_steps=2`` against
    1: the port against itself, 1e-5 (the params after a step with eps 1,
    where the step is about lr x g).
  * moe's ``aux_loss`` metric: 1e-6 absolute (a mean of f32 products near
    1), with the experts each token chose equal to the reference's (the
    aux loss counts each token's top-1 choice).
The kernels K4-K7 have no backward: their wrappers refuse an input that
requires grad under grad mode, on the CPU as on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import forward_train as ref_forward_train
from repro.models import init_params as ref_init_params
from repro.train import OptConfig as RefOptConfig
from repro.train import adamw_init as ref_adamw_init
from repro.train import adamw_update as ref_adamw_update
from repro.train import global_norm as ref_global_norm
from repro.train import lr_schedule as ref_lr_schedule
from repro.train import make_train_step as ref_make_train_step
from repro_torch import tree as tree_util
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.data import make_lm_batches
from repro_torch.models import (chunked_cross_entropy, cross_entropy,
                                forward_train, init_params)
from repro_torch.train import (OptConfig, adamw_init, adamw_update,
                               global_norm, init_train_state, lr_schedule,
                               make_train_step)

CPU = torch.device("cpu")
ARCHS = ["llama3.2-1b", "rwkv6-1.6b", "zamba2-1.2b"]
FAMILIES = ["moonshot-v1-16b-a3b", "whisper-small", "internvl2-76b"]
MOE = "moonshot-v1-16b-a3b"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these many small CPU ops: alone they run
    as fast, and beside other test processes on a few cores they do not
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    kw = {"n_layers": 2, "vocab_size": 128, **kw}
    return ref_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _ref_params(cfg, seed=0):
    return jax.tree.map(np.asarray, ref_init_params(
        cfg, jax.random.PRNGKey(seed), jnp.float32))


def _batch(cfg, B=2, S=64, seed=1):
    """Tokens and next-token targets; with the frames (audio) or patch
    embeddings (vlm, whose targets then cover the patches too) the config
    takes, from the same seed."""
    b = make_lm_batches(cfg, B, S, 1, seed=seed)[0]
    rng = np.random.default_rng(seed + 1000)
    if cfg.encoder is not None:
        b["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.vlm is not None:
        P = cfg.vlm.n_patches
        b["embeds"] = rng.standard_normal((B, P, cfg.d_model)).astype(
            np.float32)
        b["targets"] = np.concatenate(
            [rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32),
             b["targets"]], axis=1)
    return b


def _cast(tree, dtype, jax_side):
    if jax_side:
        return jax.tree.map(lambda w: w.astype(dtype) if w.ndim > 1 else w,
                            tree)
    return tree_util.tree_map(lambda w: w.to(dtype) if w.dim() > 1 else w,
                              tree)


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


def _ref_loss_and_grads(rcfg, params, batch, dtype, remat=True):
    def loss_fn(p):
        return ref_forward_train(rcfg, _cast(p, getattr(jnp, dtype), True),
                                 batch, getattr(jnp, dtype), remat=remat)
    (loss, m), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(loss), {k: float(v) for k, v in m.items()}, g


def _port_loss_and_grads(cfg, params, batch, dtype, remat=True):
    leaves = [t.detach().requires_grad_(True)
              for t in tree_util.leaves(params)]
    p = _cast(tree_util.unflatten_like(params, leaves),
              getattr(torch, dtype), False)
    loss, m = forward_train(cfg, p, batch, getattr(torch, dtype),
                            remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in m.items()}, \
        tree_util.unflatten_like(params, list(grads))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(lr=1e-3, warmup_steps=10, total_steps=100),
    dict(lr=3e-4, warmup_steps=5, total_steps=60, min_lr_ratio=0.05),
    dict(lr=2e-2, warmup_steps=0, total_steps=100)])
def test_lr_schedule_matches_reference(kw):
    opt, ref = OptConfig(**kw), RefOptConfig(**kw)
    steps = (0, 5, 10, 50, 100)
    got = [float(lr_schedule(opt, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    want = [float(ref_lr_schedule(ref, jnp.int32(s))) for s in steps]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-7 * abs(w), (got, want)
    if opt.warmup_steps == 10:                  # tests/test_data_train.py
        assert got[0] < got[1] < got[2]
        assert got[2] >= got[3] >= got[4]
        assert got[4] >= opt.lr * opt.min_lr_ratio * 0.99


@pytest.mark.parametrize("clip_norm,weight_decay,step0", [
    (1.0, 0.1, 0), (1e-3, 0.1, 0), (1.0, 0.0, 7)])
def test_adamw_update_matches_reference(clip_norm, weight_decay, step0):
    """One update from the same params, grads and moments; ``clip_norm``
    1e-3 clips, 1.0 does not."""
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}}
    params = jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = jax.tree.map(lambda p: (0.1 * rng.standard_normal(p.shape))
                         .astype(np.float32), params)
    kw = dict(lr=1e-2, clip_norm=clip_norm, weight_decay=weight_decay,
              warmup_steps=3, total_steps=20)
    ref_state = ref_adamw_init(params)
    ref_state["m"] = jax.tree.map(lambda g: 0.5 * g, grads)
    ref_state["v"] = jax.tree.map(lambda g: g * g, grads)
    ref_state["step"] = jnp.int32(step0)
    want_p, want_s, want_m = ref_adamw_update(grads, ref_state, params,
                                              RefOptConfig(**kw))
    state = from_jax(jax.tree.map(np.asarray, ref_state), CPU)
    got_p, got_s, got_m = adamw_update(from_jax(grads, CPU), state,
                                       from_jax(params, CPU), OptConfig(**kw))
    assert int(got_s["step"]) == step0 + 1 and got_s["step"].dtype == \
        torch.int32
    for got, want in ((got_p, want_p), (got_s["m"], want_s["m"]),
                      (got_s["v"], want_s["v"])):
        for g, w in zip(tree_util.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)
    for k in ("grad_norm", "lr"):
        assert abs(float(got_m[k]) - float(want_m[k])) <= \
            1e-6 * abs(float(want_m[k]))
    # functional: the inputs are as they were
    assert np.array_equal(state["m"]["a"].numpy(),
                          np.asarray(ref_state["m"]["a"]))


def test_global_norm_and_init_match_reference():
    rcfg, cfg = _cfgs("zamba2-1.2b")
    params = _ref_params(rcfg)
    got = float(global_norm(from_jax(params, CPU)))
    assert abs(got - float(ref_global_norm(params))) <= 1e-6 * got
    st = adamw_init(from_jax(params, CPU))
    ref = ref_adamw_init(params)
    assert st["step"].dtype == torch.int32 and st["step"].dim() == 0
    assert [tuple(t.shape) for t in tree_util.leaves(st["m"])] == \
        [tuple(a.shape) for a in jax.tree.leaves(ref["m"])]
    assert all(t.dtype == torch.float32 and not t.any()
               for t in tree_util.leaves([st["m"], st["v"]]))


# ---------------------------------------------------------------------------
# forward_train and the losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_metrics_match_reference(arch, dtype):
    """100 tokens: ragged last chunks for both chunk scans (64 and 32)."""
    rcfg, cfg = _cfgs(arch)
    params = _ref_params(rcfg)
    batch = _batch(cfg, 2, 100, seed=4)
    want, want_m, _ = _ref_loss_and_grads(rcfg, params, batch, dtype)
    got, got_m = forward_train(
        cfg, _cast(from_jax(params, CPU), getattr(torch, dtype), False),
        batch, getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= TOL[dtype] * abs(want)
    assert float(got_m["tokens"]) == want_m["tokens"] == 200
    assert abs(float(got_m["acc"]) - want_m["acc"]) <= TOL[dtype] + 1 / 200


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_loss_at_1024_tokens(arch):
    """At S 1,024 the loss goes in two 512-token chunks: against the
    reference's chunked loss and the port's own unchunked one."""
    rcfg, cfg = _cfgs(arch)
    params = _ref_params(rcfg)
    batch = _batch(cfg, 1, 1024, seed=5)
    want, want_m, _ = _ref_loss_and_grads(rcfg, params, batch, "float32")
    p = from_jax(params, CPU)
    got, got_m = forward_train(cfg, p, batch, torch.float32)
    assert abs(float(got) - want) <= 1e-4 * want
    assert float(got_m["tokens"]) == 1024
    x = torch.randn((2, 1024, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    t = torch.randint(0, cfg.vocab_size, (2, 1024),
                      generator=torch.Generator().manual_seed(1))
    t[0, ::7] = -100
    loss_c, m_c = chunked_cross_entropy(cfg, p, x, t)
    head = p["embed"]["tok"].T if cfg.tie_embeddings else p["lm_head"]
    loss_u, m_u = cross_entropy(x @ head, t)
    assert abs(float(loss_c) - float(loss_u)) <= 1e-5 * float(loss_u)
    for k in ("acc", "tokens"):
        assert float(m_c[k]) == pytest.approx(float(m_u[k]), rel=1e-6)
    # and the chunked loss's gradient is the unchunked one's
    xc = x.clone().requires_grad_(True)
    xu = x.clone().requires_grad_(True)
    gc, = torch.autograd.grad(chunked_cross_entropy(cfg, p, xc, t)[0], xc)
    gu, = torch.autograd.grad(cross_entropy(xu @ head, t)[0], xu)
    assert _rel(gc, gu.numpy()) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_targets(arch):
    """-100 targets count in neither the loss, the accuracy nor the token
    count, as in the reference."""
    rcfg, cfg = _cfgs(arch)
    params = _ref_params(rcfg)
    batch = _batch(cfg, 2, 64, seed=6)
    batch["targets"][0, :40] = -100
    batch["targets"][1, 5::3] = -100
    n = int((batch["targets"] >= 0).sum())
    want, want_m, _ = _ref_loss_and_grads(rcfg, params, batch, "float32")
    got, got_m = forward_train(cfg, from_jax(params, CPU), batch,
                               torch.float32)
    assert float(got_m["tokens"]) == want_m["tokens"] == n
    assert abs(float(got) - want) <= 1e-4 * want
    # the same loss as the unmasked positions alone, through cross_entropy
    logits = torch.randn((2, 64, cfg.vocab_size))
    t = torch.as_tensor(batch["targets"]).long()
    loss, m = cross_entropy(logits, t)
    keep = t >= 0
    want_nll = torch.nn.functional.cross_entropy(logits[keep], t[keep])
    assert float(loss) == pytest.approx(float(want_nll), rel=1e-6)
    assert float(m["tokens"]) == n
    none, m0 = cross_entropy(logits, torch.full_like(t, -100))
    assert float(none) == 0.0 and float(m0["tokens"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    """Every gradient leaf of the f32 loss within 1e-4 of its largest
    |value|; and remat=True gives the gradients of remat=False."""
    rcfg, cfg = _cfgs(arch)
    params = _ref_params(rcfg)
    batch = _batch(cfg, 2, 100, seed=7)
    _, _, want = _ref_loss_and_grads(rcfg, params, batch, "float32")
    loss, _, got = _port_loss_and_grads(cfg, from_jax(params, CPU), batch,
                                        "float32")
    paths = [p for p, _ in tree_util.flatten_with_paths(got)]
    for path, g, w in zip(paths, tree_util.leaves(got),
                          jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        assert float(np.max(np.abs(np.asarray(w)))) > 0, path
        assert _rel(g, w) <= 1e-4, (path, _rel(g, w))
    loss_nr, _, got_nr = _port_loss_and_grads(
        cfg, from_jax(params, CPU), batch, "float32", remat=False)
    assert abs(float(loss_nr) - float(loss)) <= 1e-6 * float(loss)
    for a, b in zip(tree_util.leaves(got), tree_util.leaves(got_nr)):
        assert _rel(a, b.numpy()) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_in_float64(arch):
    """f64 params and compute stay f64 throughout (the f64 run a gradient
    check on the card holds f32 to): the loss and every gradient f64, and
    the f32 run within 1e-4 of it at this size."""
    _, cfg = _cfgs(arch)
    p = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    batch = _batch(cfg, 2, 100, seed=10)
    l32, _, g32 = _port_loss_and_grads(cfg, p, batch, "float32")
    l64, _, g64 = _port_loss_and_grads(
        cfg, tree_util.tree_map(lambda t: t.double(), p), batch, "float64")
    assert l64.dtype == torch.float64
    assert abs(float(l32) - float(l64)) <= 1e-6 * float(l64)
    for a, b in zip(tree_util.leaves(g32), tree_util.leaves(g64)):
        assert b.dtype == torch.float64 and _rel(a, b.numpy()) <= 1e-4


# ---------------------------------------------------------------------------
# the training scans: against the reference and the sequential oracles
# ---------------------------------------------------------------------------

def _scan_grads(fn, *args):
    """(output, gradient of sum(output * w) for each tensor argument), for a
    fixed random weighting w of the output."""
    args = [a.clone().requires_grad_(True) for a in args]
    out = fn(*args)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    return out.detach(), torch.autograd.grad((out * w).sum(), args)


@pytest.mark.parametrize("decay", [0.01, 1.0, 5.0])
@pytest.mark.parametrize("S,chunk", [(96, 32), (70, 32)])
def test_wkv_chunked_train_gradients_equal_the_sequential_oracle(decay, S,
                                                                 chunk):
    """The rwkv training scan and its gradients against autograd through
    the exact step-by-step recurrence (``kernels/rwkv6/ref.py``), at slow
    and strong decays and a ragged last chunk: 1e-4 of each one's largest
    |value|."""
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    from repro_torch.models.rwkv6 import wkv_chunked_train
    g = torch.Generator().manual_seed(3)
    B, H, dh = 2, 2, 8
    r, k, v = (torch.randn((B, S, H, dh), generator=g) for _ in range(3))
    lw = -decay * torch.rand((B, S, H, dh), generator=g) - 1e-3
    u = torch.randn((H, dh), generator=g)
    st = torch.zeros((B, H, dh, dh))
    got, gg = _scan_grads(lambda *a: wkv_chunked_train(*a, st, chunk)[0],
                          r, k, v, lw, u)
    want, gw = _scan_grads(
        lambda r, k, v, lw, u: wkv6_ref(*(t.transpose(1, 2)
                                          for t in (r, k, v, lw)), u)
        .transpose(1, 2), r, k, v, lw, u)
    assert _rel(got, want.numpy()) <= 1e-4
    for a, b in zip(gg, gw):
        assert bool(torch.isfinite(a).all()) and _rel(a, b.numpy()) <= 1e-4


def test_reference_wkv_gradient_is_nan_at_strong_decays():
    """ROADMAP R8: with strong decays the reference's ``wkv_chunked`` takes
    exp of a positive sum above the triangle; its output stays finite but
    its gradient is NaN. The port's training scan (the exponent clamped at
    0 there, which changes nothing below it) gives the finite gradient of
    the sequential oracle, and the reference's where that is finite."""
    from repro.models.rwkv6 import wkv_chunked as ref_wkv_chunked
    from repro_torch.models.rwkv6 import wkv_chunked_train
    rng = np.random.default_rng(0)
    r, k, v = (rng.standard_normal((1, 64, 2, 8)).astype(np.float32)
               for _ in range(3))
    u = rng.standard_normal((2, 8)).astype(np.float32)
    st = np.zeros((1, 2, 8, 8), np.float32)
    for lw_val, ref_nan in ((-0.01, False), (-5.0, True)):
        lw = np.full(r.shape, lw_val, np.float32)
        val, g_ref = jax.value_and_grad(lambda r: jnp.sum(
            ref_wkv_chunked(r, k, v, lw, u, st, 32)[0]))(r)
        g_ref = np.asarray(g_ref)
        assert np.isfinite(float(val))
        assert bool(np.isnan(g_ref).any()) == ref_nan
        rt = torch.tensor(r, requires_grad=True)
        out, _ = wkv_chunked_train(rt, *(torch.tensor(a)
                                         for a in (k, v, lw, u, st)), 32)
        assert abs(float(out.detach().sum()) - float(val)) <= \
            1e-5 * abs(float(val))
        g, = torch.autograd.grad(out.sum(), rt)
        assert bool(torch.isfinite(g).all())
        ok = np.isfinite(g_ref)
        assert float(np.max(np.abs(g.numpy() - g_ref)[ok])) <= \
            1e-4 * float(np.max(np.abs(g_ref[ok])))


@pytest.mark.parametrize("decay", [0.01, 1.0, 5.0])
@pytest.mark.parametrize("S,chunk", [(96, 32), (70, 32)])
def test_ssd_chunked_train_gradients_equal_the_sequential_oracle(decay, S,
                                                                 chunk):
    """The Mamba-2 training scan and its gradients against autograd
    through the exact recurrence (``kernels/mamba2_ssd/ref.py``), at slow
    and strong decays and a ragged last chunk: 1e-4 of each one's largest
    |value|."""
    from repro_torch.kernels.mamba2_ssd.ref import ssd_ref
    from repro_torch.models.mamba2 import ssd_chunked_train
    g = torch.Generator().manual_seed(4)
    B, H, dh, N = 2, 3, 8, 4
    xh = torch.randn((B, S, H, dh), generator=g)
    dt = decay * torch.rand((B, S, H), generator=g) + 1e-3
    a_log = torch.log(torch.linspace(1.0, 4.0, H))
    Bm, Cm = (torch.randn((B, S, N), generator=g) for _ in range(2))
    st = torch.zeros((B, H, dh, N))
    got, gg = _scan_grads(
        lambda *a: ssd_chunked_train(*a, st, chunk)[0], xh, dt, a_log, Bm,
        Cm)

    def oracle(xh, dt, a_log, Bm, Cm):
        lw = dt * -torch.exp(a_log)
        xs = xh * dt[..., None]
        return ssd_ref(xs.transpose(1, 2), lw.transpose(1, 2), Bm,
                       Cm).transpose(1, 2)
    want, gw = _scan_grads(oracle, xh, dt, a_log, Bm, Cm)
    assert _rel(got, want.numpy()) <= 1e-4
    for a, b in zip(gg, gw):
        assert bool(torch.isfinite(a).all()) and _rel(a, b.numpy()) <= 1e-4


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + [MOE])
def test_first_train_step_matches_reference(arch):
    """The first ``make_train_step`` step in f32 from the same params and
    batch: loss, grad_norm, lr (moe: aux_loss) and the updated params."""
    rcfg, cfg = _cfgs(arch)
    params = _ref_params(rcfg)
    batch = _batch(cfg, 2, 64, seed=8)
    kw = dict(lr=1e-3, warmup_steps=1)
    ref_step = jax.jit(ref_make_train_step(rcfg, RefOptConfig(**kw),
                                           jnp.float32))
    want_p, want_s, want_m = ref_step(params, ref_adamw_init(params), batch)
    _, _, ref_grads = _ref_loss_and_grads(rcfg, params, batch, "float32")
    p = from_jax(params, CPU)
    step = make_train_step(cfg, OptConfig(**kw), torch.float32)
    got_p, got_s, got_m = step(p, adamw_init(p), batch)
    assert set(got_m) == {"loss", "acc", "tokens", "grad_norm", "lr"} | \
        ({"aux_loss"} if cfg.moe is not None else set())
    if cfg.moe is not None:
        assert abs(float(got_m["aux_loss"]) - float(want_m["aux_loss"])) \
            <= 1e-6
    for k in ("loss", "grad_norm"):
        assert abs(float(got_m[k]) - float(want_m[k])) <= \
            1e-4 * abs(float(want_m[k])), k
    assert float(got_m["lr"]) == pytest.approx(float(want_m["lr"]),
                                               rel=1e-7)
    assert int(got_s["step"]) == 1
    _, _, got_grads = _port_loss_and_grads(cfg, p, batch, "float32")
    lr = kw["lr"]
    for g, w, gg, rg, p0 in zip(
            tree_util.leaves(got_p), jax.tree.leaves(want_p),
            tree_util.leaves(got_grads), jax.tree.leaves(ref_grads),
            tree_util.leaves(p)):
        d = np.abs(g.numpy() - np.asarray(w))
        assert float(d.max()) <= 2 * lr
        sure = (np.abs(gg.numpy()) > 1e-6) & (np.abs(np.asarray(rg)) > 1e-6)
        assert float(d[sure].max(initial=0.0)) <= 1e-6
        assert not torch.equal(g, p0)          # every leaf moved
    # the step is functional: the params given are as they were
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in
               zip(tree_util.leaves(p), jax.tree.leaves(params)))


@pytest.mark.parametrize("arch", ARCHS)
def test_accumulation_equals_one_batch(arch):
    """``accum_steps=2`` against 1 on the same 4-row batch (no masked
    targets, so every microbatch has as many tokens), and ``remat``
    on against off, through the whole step. eps 1 makes AdamW's first step
    about lr x g (not lr x sign(g), which turns on the last bits of a
    gradient near zero), so the params hold the gradients' agreement."""
    _, cfg = _cfgs(arch)
    params, st = init_train_state(cfg, torch.Generator().manual_seed(3),
                                  device="cpu")
    batch = _batch(cfg, 4, 64, seed=9)
    opt = OptConfig(lr=1e-3, warmup_steps=1, eps=1.0)
    out = {}
    for accum, remat in ((1, True), (2, True), (1, False)):
        step = make_train_step(cfg, opt, torch.float32, remat=remat,
                               accum_steps=accum)
        out[accum, remat] = step(params, st, batch)
    p1, _, m1 = out[1, True]
    for key in ((2, True), (1, False)):
        p2, s2, m2 = out[key]
        for k in ("loss", "acc", "grad_norm", "lr"):
            assert abs(float(m2[k]) - float(m1[k])) <= \
                1e-5 * max(abs(float(m1[k])), 1e-6), (key, k)
        assert float(m2["tokens"]) == float(m1["tokens"]) == 256
        for a, b in zip(tree_util.leaves(p2), tree_util.leaves(p1)):
            assert float((a - b).abs().max()) <= 1e-5, key


@pytest.mark.parametrize("arch", ARCHS)
def test_training_reduces_loss(arch):
    """The counterpart of ``test_training_reduces_loss``: a tiny model
    overfits a repeated batch in 30 steps, bf16 compute on f32 masters."""
    _, cfg = _cfgs(arch)
    params, st = init_train_state(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    step = make_train_step(cfg, OptConfig(lr=3e-3, warmup_steps=5,
                                          total_steps=60, weight_decay=0.0))
    batch = make_lm_batches(cfg, 4, 64, 1, seed=3)[0]
    losses = []
    for _ in range(30):
        params, st, m = step(params, st, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.6, losses[::6]
    assert np.isfinite(losses[-1]) and float(m["grad_norm"]) > 0
    assert int(st["step"]) == 30
    assert all(t.dtype == torch.float32 for t in tree_util.leaves(params))


# ---------------------------------------------------------------------------
# the kernels refuse what training would send them (P3)
# ---------------------------------------------------------------------------

def _kernel_calls():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_ssd import ssd_chunked
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.rwkv6 import wkv6_chunked
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)
    return {
        "rmsnorm": (rmsnorm, (r(4, 64), r(64)), {}),
        "flash_attention": (flash_attention, (r(1, 4, 16, 32), r(1, 2, 16, 32),
                                              r(1, 2, 16, 32)), {}),
        "ssd_chunked": (ssd_chunked, (r(1, 2, 20, 8), -r(1, 2, 20).abs(),
                                      r(1, 20, 4), r(1, 20, 4)),
                        {"chunk": 8}),
        "wkv6_chunked": (wkv6_chunked, (r(1, 2, 20, 8), r(1, 2, 20, 8),
                                        r(1, 2, 20, 8),
                                        -r(1, 2, 20, 8).abs() - 0.01,
                                        r(2, 8)), {"chunk": 8}),
    }


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention",
                                  "ssd_chunked", "wkv6_chunked"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    fn, args, kw = _kernel_calls()[name]
    plain = fn(*args, **kw)
    for i in range(len(args)):
        a = list(args)
        a[i] = a[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"{name}: an input requires "
                           "grad.*does not run through the kernel"):
            fn(*a, **kw)
        with torch.no_grad():
            out = fn(*a, **kw)
        with torch.inference_mode():
            fn(*a, **kw)
        for o, p in zip(out if isinstance(out, tuple) else (out,),
                        plain if isinstance(plain, tuple) else (plain,)):
            assert torch.equal(o, p)


def test_serving_path_unchanged_and_training_path_reaches_no_kernel(
        monkeypatch):
    """Prefill under inference mode runs on params that require grad, and
    without it refuses them; the training forward reaches none of K4-K7's
    wrappers."""
    from repro_torch.models import forward_prefill
    from repro_torch.models import mamba2 as mamba_mod
    from repro_torch.models import model as model_mod
    _, cfg = _cfgs("zamba2-1.2b")
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p = tree_util.tree_map(lambda t: t.requires_grad_(True), p)
    toks = torch.randint(0, cfg.vocab_size, (2, 70),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        logits, _ = forward_prefill(cfg, p, {"tokens": toks}, torch.float32)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(RuntimeError, match="requires grad"):
        forward_prefill(cfg, p, {"tokens": toks}, torch.float32)
    called = []
    for mod, name in ((model_mod, "rmsnorm"), (model_mod, "attention"),
                      (mamba_mod, "rmsnorm"), (mamba_mod, "ssd_chunked_op")):
        monkeypatch.setattr(mod, name,
                            lambda *a, _n=name, **k: called.append(_n))
    loss, _ = forward_train(cfg, p, {"tokens": toks[:, :-1],
                                     "targets": toks[:, 1:]}, torch.float32)
    assert not called and loss.requires_grad


def test_training_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.launch.train import train
    _, cfg = _cfgs("llama3.2-1b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    save_checkpoint(tmp_path / "c", 1, {"w": torch.ones(2)})
    for call in (lambda: init_train_state(cfg, torch.Generator()),
                 lambda: train("llama3.2-1b", steps=1,
                               data_dir=str(tmp_path / "d"),
                               ckpt_dir=str(tmp_path / "c")),
                 lambda: restore_checkpoint(tmp_path / "c",
                                            {"w": torch.ones(2)})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    params, st = init_train_state(cfg, torch.Generator(), device="cpu")
    assert tree_util.leaves(params)[0].device == CPU
    assert st["step"].device == CPU


# ---------------------------------------------------------------------------
# the moe, audio and vlm families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_and_gradients_match_jax_grad(arch):
    """``forward_train`` in f32 (moe: its aux loss added, and the
    ``aux_loss`` metric) and every gradient leaf against ``jax.grad``:
    the loss within 1e-4, each leaf within 1e-4 of its largest |value|."""
    rcfg, cfg = _cfgs(arch)
    params = _ref_params(rcfg)
    batch = _batch(cfg, 2, 64, seed=11)
    want, want_m, want_g = _ref_loss_and_grads(rcfg, params, batch,
                                               "float32")
    loss, m, got = _port_loss_and_grads(cfg, from_jax(params, CPU), batch,
                                        "float32")
    assert abs(float(loss) - want) <= 1e-4 * abs(want)
    assert set(m) == set(want_m)
    assert float(m["tokens"]) == want_m["tokens"] == batch["targets"].size
    if cfg.moe is not None:
        assert abs(float(m["aux_loss"]) - want_m["aux_loss"]) <= 1e-6
        assert float(m["aux_loss"]) > 0.5
    paths = [p for p, _ in tree_util.flatten_with_paths(got)]
    for path, g, w in zip(paths, tree_util.leaves(got),
                          jax.tree.leaves(want_g)):
        assert tuple(g.shape) == w.shape, path
        assert float(np.max(np.abs(np.asarray(w)))) > 0, path
        assert _rel(g, w) <= 1e-4, (path, _rel(g, w))


def test_moe_training_step_and_aux_loss():
    """The reference's ``test_moe_training_step_and_aux_loss``
    (``tests/test_data_train.py:84``) on the port: one bf16 step of
    moonshot at 2 layers, vocab 128, gives a finite loss and an aux loss
    near E * 1/E * 1 = 1, and the same loss and aux loss as the
    reference's step within the bf16 tolerance."""
    rcfg, cfg = _cfgs(MOE)
    params = _ref_params(rcfg)
    batch = make_lm_batches(cfg, 2, 64, 1)[0]
    _, _, want = jax.jit(ref_make_train_step(rcfg, RefOptConfig(lr=1e-3)))(
        params, ref_adamw_init(params), batch)
    p = from_jax(params, CPU)
    _, _, m = make_train_step(cfg, OptConfig(lr=1e-3))(p, adamw_init(p),
                                                       batch)
    assert np.isfinite(float(m["loss"]))
    assert float(m["aux_loss"]) > 0.5
    for k in ("loss", "aux_loss"):
        assert abs(float(m[k]) - float(want[k])) <= \
            TOL["bfloat16"] * abs(float(want[k])), k


def test_moe_accumulation_reports_aux_loss():
    """Under ``accum_steps=2`` the metrics keep ``aux_loss`` (the mean of
    the microbatches', as the reference's zero metrics gain it), and the
    step's metrics and params match the reference's accumulated step."""
    rcfg, cfg = _cfgs(MOE)
    params = _ref_params(rcfg)
    batch = _batch(cfg, 4, 64, seed=12)
    kw = dict(lr=1e-3, warmup_steps=1, eps=1.0)
    want_p, _, want_m = jax.jit(ref_make_train_step(
        rcfg, RefOptConfig(**kw), jnp.float32, accum_steps=2))(
            params, ref_adamw_init(params), batch)
    p = from_jax(params, CPU)
    got_p, _, got_m = make_train_step(cfg, OptConfig(**kw), torch.float32,
                                      accum_steps=2)(p, adamw_init(p), batch)
    assert set(got_m) == set(want_m) == {"loss", "acc", "tokens",
                                         "aux_loss", "grad_norm", "lr"}
    for k in ("loss", "grad_norm"):
        assert abs(float(got_m[k]) - float(want_m[k])) <= \
            1e-4 * abs(float(want_m[k])), k
    assert abs(float(got_m["aux_loss"]) - float(want_m["aux_loss"])) <= 1e-6
    assert float(got_m["tokens"]) == float(want_m["tokens"]) == 256
    for g, w in zip(tree_util.leaves(got_p), jax.tree.leaves(want_p)):
        assert float(np.max(np.abs(g.numpy() - np.asarray(w)))) <= 1e-5
