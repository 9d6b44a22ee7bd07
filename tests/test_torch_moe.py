"""The port's MoE layer (``repro_torch.models.moe``) held against the JAX
package's ``repro/models/moe.py`` on the CPU, on the same inputs made from
numpy seeds.

Tolerances and why:
  * ``_route``: ``sel`` equal; ``w`` and the aux loss within 1e-6 absolute
    in float32 (a softmax and a mean in other orders; the weights are at
    most 1 and the aux loss near 1). On inputs built with exact ties
    (router columns repeated, so equal logits give equal probabilities)
    ``sel`` is equal in float32 and bfloat16: among equal values the lower
    expert comes first, as ``jax.lax.top_k`` orders them.
  * ``_dispatch_seq``: the buffer, ``idx`` and ``keep`` bit-equal (the
    scatter-add moves each kept token to a slot of its own and adds exact
    zeros for dropped ones), NaN where the reference has NaN.
  * ``moe_mlp`` at S > 1 and S == 1 (the dense mixture): 1e-5 of the
    largest |output| in float32 (products summed in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as RM
from repro_torch.configs import MoEConfig, get_config
from repro_torch.convert import from_jax
from repro_torch.models import moe as TM

CPU = torch.device("cpu")


def _route_inputs(seed, B, S, D, E, dtype, tied=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    router = (0.3 * rng.standard_normal((D, E))).astype(np.float32)
    if tied:        # columns repeated: equal logits, equal probabilities
        src = rng.integers(0, max(E // 3, 1), E)
        router = router[:, src]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return ((jnp.asarray(x).astype(jdt), jnp.asarray(router).astype(jdt)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(router).to(tdt)))


@pytest.mark.parametrize("E,k", [(4, 2), (16, 1), (64, 6)])
def test_route_matches_reference(E, k):
    m = MoEConfig(n_experts=E, top_k=k, d_ff_expert=8)
    (xj, rj), (xt, rt) = _route_inputs(E + k, 2, 24, 64, E, "float32")
    want = RM._route(xj, rj, m)
    sel, w, aux = TM._route(xt, rt, m)
    assert np.array_equal(sel.numpy(), np.asarray(want[0]))
    assert w.dtype == aux.dtype == torch.float32
    assert np.max(np.abs(w.numpy() - np.asarray(want[1]))) <= 1e-6
    assert abs(float(aux) - float(want[2])) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,k", [(8, 2), (64, 6)])
def test_route_keeps_the_reference_order_on_exact_ties(E, k, dtype):
    m = MoEConfig(n_experts=E, top_k=k, d_ff_expert=8)
    (xj, rj), (xt, rt) = _route_inputs(7 * E, 2, 32, 64, E, dtype, tied=True)
    want = np.asarray(RM._route(xj, rj, m)[0])
    sel, w, _ = TM._route(xt, rt, m)
    probs = torch.softmax((xt @ rt).float(), -1)
    picked = torch.gather(probs, -1, sel)
    # the inputs do hold ties inside the top k, which the order decides
    assert bool((picked[..., 1:] == picked[..., :-1]).any())
    assert np.array_equal(sel.numpy(), want)
    # among equal probabilities, the lower expert first
    same = picked[..., 1:] == picked[..., :-1]
    assert bool((sel[..., 1:] > sel[..., :-1])[same].all())


def test_top_k_orders_ties_as_jax():
    p = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.2]])
    w, sel = TM.top_k(p, 4)
    want_w, want_sel = jax.lax.top_k(jnp.asarray(p.numpy()), 4)
    assert sel.tolist() == np.asarray(want_sel).tolist() == [[1, 2, 4, 3]]
    assert np.array_equal(w.numpy(), np.asarray(want_w))


def _dispatch_inputs(seed, S, E, k, D=16, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, D)).astype(dtype)
    sel = np.stack([rng.permutation(E)[:k] for _ in range(S)]).astype(
        np.int32)
    w = rng.random((S, k)).astype(np.float32)
    return x, sel, w


@pytest.mark.parametrize("S,E,k,C", [(32, 4, 2, 32), (32, 4, 2, 5),
                                     (40, 8, 1, 3), (24, 16, 6, 9)])
def test_dispatch_seq_bit_equal(S, E, k, C):
    """C 32 (= S) keeps every token; 5, 3 and 9 overflow, dropping some."""
    x, sel, w = _dispatch_inputs(S * E + C, S, E, k)
    want = [np.asarray(a) for a in RM._dispatch_seq(
        jnp.asarray(x), jnp.asarray(sel), jnp.asarray(w), E, C)]
    got = TM._dispatch_seq(torch.from_numpy(x), torch.from_numpy(sel).long(),
                           torch.from_numpy(w), E, C)
    for g, wt in zip(got, want):
        assert tuple(g.shape) == wt.shape
        assert np.array_equal(g.numpy(), wt)
    dropped = not want[2].all()
    assert dropped == (C < S)


def test_dispatch_per_sequence_never_across_the_batch():
    """A batch of sequences dispatches as each sequence alone (the
    reference's ``vmap``): capacity counts restart at every sequence."""
    E, k, C = 4, 2, 6
    seqs = [_dispatch_inputs(s, 20, E, k) for s in range(3)]
    x = torch.from_numpy(np.stack([s[0] for s in seqs]))
    sel = torch.from_numpy(np.stack([s[1] for s in seqs])).long()
    w = torch.from_numpy(np.stack([s[2] for s in seqs]))
    got = TM._dispatch_seq(x, sel, w, E, C)
    want = jax.vmap(lambda a, b, c: RM._dispatch_seq(a, b, c, E, C))(
        *(jnp.asarray(t.numpy()) for t in (x, sel.int(), w)))
    for b in range(3):
        alone = TM._dispatch_seq(x[b], sel[b], w[b], E, C)
        for g, a, wt in zip(got, alone, want):
            assert torch.equal(g[b], a)
            assert np.array_equal(g[b].numpy(), np.asarray(wt)[b])


def test_dispatch_dropped_inf_gives_the_reference_nan():
    """A dropped token is scatter-added times 0 into slot 0 of its expert:
    an inf in it gives NaN there, in the reference and in the port."""
    E, k, C = 2, 1, 1
    x = np.ones((3, 4), np.float32)
    x[2, 1] = np.inf
    sel = np.zeros((3, 1), np.int32)               # all to expert 0
    w = np.ones((3, 1), np.float32)
    want = np.asarray(RM._dispatch_seq(jnp.asarray(x), jnp.asarray(sel),
                                       jnp.asarray(w), E, C)[0])
    got = TM._dispatch_seq(torch.from_numpy(x), torch.from_numpy(sel).long(),
                           torch.from_numpy(w), E, C)[0].numpy()
    assert np.isnan(want[0, 1]) and np.isnan(got[0, 1])
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("S,E,C", [(2, 2, 2), (5, 3, 2), (9, 8, 3),
                                   (16, 2, 8), (16, 8, 2), (13, 5, 7)])
def test_moe_dispatch_conservation(S, E, C):
    """The reference's property (``tests/test_property.py:213``) on the
    port: every kept token appears exactly once in the buffer, the
    combine-gather gives it back, and rows no kept slot points at are
    zero."""
    rng = np.random.default_rng(S * 100 + E * 10 + C)
    x = torch.from_numpy(rng.standard_normal((S, 4)).astype(np.float32))
    sel = torch.from_numpy(rng.integers(0, E, (S, 1)))
    buf, idx, keep = TM._dispatch_seq(x, sel, torch.ones((S, 1)), E, C)
    kept = keep[:, 0]
    assert torch.equal(buf[idx[:, 0][kept]], x[kept])
    used = set(idx[:, 0][kept].tolist())
    for row in range(E * C):
        if row not in used:
            assert not buf[row].any()


def _ref_layer(arch, seed=0, **moe_kw):
    rcfg = ref_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if moe_kw:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **moe_kw))
    p = jax.tree.map(lambda a: np.asarray(a)[0], RM.init_moe(
        jax.random.PRNGKey(seed), rcfg, 1))
    return rcfg, cfg, p


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("S,cf", [(1, None), (40, None), (40, 0.5)])
def test_moe_mlp_matches_reference(arch, S, cf):
    """S 40 dispatches: at the config's capacity factor 1.25 every token is
    kept here, at 0.5 some are dropped; S 1 takes the dense mixture."""
    rcfg, cfg, p = _ref_layer(arch, **({} if cf is None
                                       else {"capacity_factor": cf}))
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    want_y, want_aux = jax.jit(lambda x, p: RM.moe_mlp(x, p, rcfg))(
        jnp.asarray(x), p)
    y, aux = TM.moe_mlp(torch.from_numpy(x), from_jax(p, CPU), cfg)
    want_y = np.asarray(want_y)
    assert y.shape == want_y.shape and y.dtype == torch.float32
    assert np.max(np.abs(y.numpy() - want_y)) <= \
        1e-5 * np.max(np.abs(want_y))
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    if S > 1:
        sel, w, _ = TM._route(torch.from_numpy(x),
                              from_jax(p, CPU)["router"], cfg.moe)
        keep = TM._dispatch_seq(torch.from_numpy(x), sel, w,
                                cfg.moe.n_experts, TM.capacity(cfg, S))[2]
        assert bool(keep.all()) == (cf is None)


def test_moe_mlp_does_not_renormalise_after_drops():
    """The reference's docstring says the combine renormalises over the
    surviving slots; its code (``moe.py:112``) weights them by ``w * keep``
    alone. The port follows the code: each token's output is the sum over
    its kept slots of the routing weight times that expert's output, and
    differs from the renormalised sum where a token lost a slot."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    g = torch.Generator().manual_seed(0)
    p = TM.init_moe(g, cfg, 1, device=CPU)
    p = {k: v[0] for k, v in p.items()}
    E, Fe, S = cfg.moe.n_experts, cfg.moe.d_ff_expert, 16
    x = torch.randn((2, S, cfg.d_model), generator=g)
    y, _ = TM.moe_mlp(x, p, cfg)
    sel, w, _ = TM._route(x, p["router"], cfg.moe)
    keep = TM._dispatch_seq(x, sel, w, E, TM.capacity(cfg, S))[2]

    def expert(e, v):
        gu = v @ p["w13"][e]
        return (torch.nn.functional.silu(gu[:Fe]) * gu[Fe:]) @ p["w2"][e]
    outs = torch.stack([torch.stack([torch.stack([
        expert(int(sel[b, s, j]), x[b, s]) for j in range(sel.shape[-1])])
        for s in range(S)]) for b in range(2)])           # (B, S, k, D)
    wk = w * keep
    want = torch.einsum("bskd,bsk->bsd", outs, wk)
    renorm = torch.einsum("bskd,bsk->bsd", outs, wk / torch.clamp(
        wk.sum(-1, keepdim=True), min=1e-9))
    part = keep.any(-1) & ~keep.all(-1)            # tokens that lost a slot
    assert bool(part.any())
    assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((y - renorm)[part].abs().max()) > \
        1e-2 * float(want.abs().max())
