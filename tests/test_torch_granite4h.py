"""granite-4.0-h-small (the hybrid_moe family: Mamba-2 and NoPE attention
mixers, each followed by a dropless MoE and a shared expert) through the
port's serving path, held against the plain float32 reference
``tests/plain/granite4_hybrid.py`` on the CPU, at ``reduced()`` size (one
whole period of 10 layers, attention at index 5; 8 experts, top 3; the
shared expert) with seeded weights.

Tolerances and why:
  * prefill and decode logits within ``TOL`` = 1e-4 of the largest
    |reference logit|: both sides compute in float32 with the same weights,
    and differ only in the order of their sums (the chunked scans, the
    grouped GEMMs and the gather against the reference's per-expert loop,
    attention's blocks), ~1e-6 relative over 10 layers; each planted fault
    below moves the logits by far more.
  * routing: ``sel`` and the gates' order exact (the same stable sort on
    the same f32 logits); the gates within 1e-6 (a softmax over k).
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro import configs as ref_configs
from repro_torch import obs
from repro_torch.configs import ARCH_IDS, MoEConfig, get_config, list_archs
from repro_torch.configs.hybrid_moe import DroplessMoEConfig
from repro_torch.models import forward_decode, init_params, moe
from repro_torch.models import model as model_mod
from repro_torch.serve import make_prefill_step

ARCH = "granite-4.0-h-small"
TOL = 1e-4
CPU = torch.device("cpu")
S, NEW = 16, 4


def _plain():
    path = Path(__file__).resolve().parent / "plain" / "granite4_hybrid.py"
    spec = importlib.util.spec_from_file_location("plain_granite4", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _plain()


def hf_config(cfg):
    """The reference's configuration (config.json's keys) of a port
    config."""
    s, m = cfg.ssm, cfg.moe
    di = s.expand * cfg.d_model
    return {"hidden_size": cfg.d_model, "n_layers": cfg.n_layers,
            "layer_types": list(cfg.layer_types),
            "vocab_size": cfg.vocab_size,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "rms_norm_eps": cfg.norm_eps,
            "embedding_multiplier": cfg.embedding_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "logits_scaling": cfg.logits_scaling,
            "attention_multiplier": cfg.attention_multiplier,
            "mamba_expand": s.expand, "mamba_n_heads": di // s.d_head,
            "mamba_d_head": s.d_head, "mamba_d_state": s.d_state,
            "mamba_n_groups": 1, "mamba_d_conv": s.d_conv,
            "mamba_chunk_size": s.chunk,
            "num_local_experts": m.n_experts,
            "num_experts_per_tok": m.top_k,
            "intermediate_size": m.d_ff_expert,
            "shared_intermediate_size": m.d_ff_shared}


def draw(specs, g):
    """Float32 weights from the reference's specs (``bench/weights.py``'s
    kinds), drawn on the CPU from ``g``."""
    if isinstance(specs, dict):
        return {k: draw(v, g) for k, v in specs.items()}
    kind, shape = specs[0], tuple(specs[1])
    if kind == "normal":
        return torch.randn(shape, generator=g) * specs[2]
    if kind == "log_linspace":
        return torch.log(torch.linspace(specs[2], specs[3], shape[-1])
                         ).expand(shape).contiguous()
    return (torch.ones if kind == "ones" else torch.zeros)(shape)


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH).reduced()
    g = torch.Generator().manual_seed(3)
    params = draw(REF.param_specs(hf_config(cfg)), g)
    # non-trivial biases, skips and norms, so each term is exercised
    lm = params["layers"]["mamba"]
    lm["conv_b"] = 0.1 * torch.randn(lm["conv_b"].shape, generator=g)
    for k in ("D", "norm", "ln"):
        lm[k] = 1 + 0.2 * torch.randn(lm[k].shape, generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (2, S + NEW), generator=g)
    return cfg, params, tokens


def _ref_logits(cfg, params, tokens, at):
    return REF.logits(hf_config(cfg), params, tokens, at)


def _err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _prefix_logits(cfg, params, tokens):
    """The program's logits at every position: one prefill a prefix."""
    step = make_prefill_step(cfg, torch.float32)
    with torch.inference_mode():
        return torch.stack([step(params, {"tokens": tokens[:, :n]})[0]
                            for n in range(1, tokens.shape[1] + 1)], 1)


def test_specs_are_the_programs_layout(model):
    """The reference's weight specs give the program's tree, key for key
    and shape for shape (the benchmark draws weights from them)."""
    cfg, _, _ = model
    params = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)

    def shapes(t, pre=""):
        if isinstance(t, dict):
            return {k2: v for k, v in t.items()
                    for k2, v in shapes(v, f"{pre}{k}/").items()}
        return {pre[:-1]: tuple(t[1]) if isinstance(t, tuple)
                else tuple(t.shape)}
    assert shapes(REF.param_specs(hf_config(cfg))) == shapes(params)


def test_prefill_matches_the_reference_at_every_position(model):
    cfg, params, tokens = model
    tok = tokens[:, :S]
    got = _prefix_logits(cfg, params, tok)
    want = _ref_logits(cfg, params, tok, range(S))
    assert got.shape == want.shape == (2, S, cfg.vocab_size)
    assert _err(got, want) < TOL


def test_prefill_then_decode_matches_the_reference(model):
    """Prefill of S tokens, then NEW decode steps through the cache (KV for
    the attention layer, {ssm, conv} for the nine Mamba-2 layers), each
    step's logits against the reference's full forward at its position."""
    cfg, params, tokens = model
    step = make_prefill_step(cfg, torch.float32)
    with torch.inference_mode():
        last, cache = step(params, {"tokens": tokens[:, :S]})
        # the prefill's cache grown to the decoded length
        cache = {**cache, **{k: torch.cat([cache[k], torch.zeros_like(
            cache[k][:, :, :NEW])], 2) for k in ("k", "v")}}
        assert cache["k"].shape[0] == 1
        assert cache["state"]["ssm"].shape[0] == 9
        got = [last]
        for i in range(NEW):
            lg, cache = forward_decode(cfg, params, cache,
                                       tokens[:, S + i:S + i + 1], S + i,
                                       torch.float32)
            got.append(lg[:, 0])
    want = _ref_logits(cfg, params, tokens, range(S - 1, S + NEW))
    assert _err(torch.stack(got, 1), want) < TOL


# -- planted faults: each must fail the prefill's tolerance ---------------

def _capacity_route(x, router, k):
    """The router with a 1.25 capacity: rows of an expert past
    ceil(1.25 T k / E), in token order, get no weight (dropped)."""
    sel, gates = REAL_ROUTE(x, router, k)
    E = router.shape[-1]
    cap = math.ceil(1.25 * sel.numel() / E)
    onehot = torch.nn.functional.one_hot(sel.reshape(-1), E)
    pos = (torch.cumsum(onehot, 0) - onehot).gather(
        1, sel.reshape(-1, 1))[:, 0].reshape(sel.shape)
    DROPPED.append(int((pos >= cap).sum()))
    return sel, gates * (pos < cap)


def _softmax_first(x, router, k):
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    w, sel = moe.top_k(probs, k)
    return sel, w


REAL_ROUTE = moe.route_topk_softmax
DROPPED = []


@pytest.mark.parametrize("fault", ["capacity 1.25 (drops)",
                                   "softmax before top-k", "RoPE applied",
                                   "residual multiplier left out",
                                   "shared expert left out"])
def test_planted_faults_fail(model, monkeypatch, fault):
    cfg, params, tokens = model
    tok = tokens[:, :S]
    want = _ref_logits(cfg, params, tok, [S - 1])[:, 0]
    if fault == "capacity 1.25 (drops)":
        DROPPED.clear()
        monkeypatch.setattr(moe, "route_topk_softmax", _capacity_route)
    elif fault == "softmax before top-k":
        monkeypatch.setattr(moe, "route_topk_softmax", _softmax_first)
    elif fault == "RoPE applied":
        real = model_mod.attention_block
        monkeypatch.setattr(model_mod, "attention_block",
                            lambda *a, **k: real(*a, **{**k, "rope": True}))
    elif fault == "residual multiplier left out":
        cfg = dataclasses.replace(cfg, residual_multiplier=1.0)
    else:
        layers = params["layers"]
        params = {**params, "layers": {**layers, "moe": {
            k: v for k, v in layers["moe"].items() if k != "shared"}}}
    with torch.inference_mode():
        got = make_prefill_step(cfg, torch.float32)(params,
                                                    {"tokens": tok})[0]
    if fault == "capacity 1.25 (drops)":
        assert sum(DROPPED) > 0
    assert _err(got, want) > 10 * TOL


# -- the dropless routing -------------------------------------------------

def _route_inputs(T=96, D=64, E=72, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(T, D, generator=g), \
        0.3 * torch.randn(D, E, generator=g)


def test_rows_per_expert_sum_to_every_token_expert_pair():
    x, router = _route_inputs()
    sel, gates = moe.route_topk_softmax(x, router, 10)
    order, offs = moe.sort_rows(sel, 72)
    assert offs.dtype == torch.int32 and offs.shape == (72,)
    assert int(offs[-1]) == x.shape[0] * 10
    assert torch.equal(torch.sort(order).values, torch.arange(960))
    flat = sel.reshape(-1)[order]
    assert torch.equal(flat, torch.sort(flat).values)     # grouped by expert
    counts = torch.diff(offs, prepend=offs.new_zeros(1))
    assert torch.equal(counts.long(), torch.bincount(sel.reshape(-1), None,
                                                     72))


def test_gates_follow_the_stable_top_k():
    """sel: the k largest logits, the lower expert first among equal ones
    (router columns repeated make exact ties); gates: a softmax over those
    k logits, largest first."""
    x, router = _route_inputs(seed=1)
    router = router[:, torch.arange(72) % 24]           # ties, in threes
    sel, gates = moe.route_topk_softmax(x, router, 10)
    logits = x.float() @ router.float()
    want = torch.sort(logits, dim=-1, descending=True, stable=True)
    assert torch.equal(sel, want.indices[:, :10])
    assert (torch.diff(gates, dim=-1) <= 0).all()
    assert torch.allclose(gates, torch.softmax(want.values[:, :10], -1),
                          atol=1e-6, rtol=0)
    assert torch.allclose(gates.sum(-1), torch.ones(x.shape[0]))


def test_counters_read_every_row_and_no_drop(model):
    cfg, params, tokens = model
    moe.COUNTS.reset()
    with torch.inference_mode():
        make_prefill_step(cfg, torch.float32)(params,
                                              {"tokens": tokens[:, :S]})
    assert obs.COUNTS["moe.rows"] == cfg.n_layers * 2 * S * cfg.moe.top_k
    assert obs.COUNTS["moe.dropped"] == 0


def test_spans_of_the_stack(model):
    """One attn.layer and ten moe.layer spans a prefill, each moe.layer
    holding moe.route, moe.experts and moe.shared."""
    cfg, params, tokens = model
    obs.take()
    obs.enable()
    try:
        with torch.inference_mode():
            make_prefill_step(cfg, torch.float32)(params,
                                                  {"tokens": tokens[:, :S]})
    finally:
        obs.disable()
    recs = obs.take()
    names = [r.name for r in recs]
    assert names.count("attn.layer") == 1
    assert names.count("mamba2.layer") == 9
    assert names.count("moe.layer") == 10
    for part in ("moe.route", "moe.experts", "moe.shared"):
        kids = [r for r in recs if r.name == part]
        assert len(kids) == 10
        assert all(recs[r.parent].name == "moe.layer" for r in kids)


def test_config_is_the_published_one():
    """The registered config: config.json's widths, layer pattern and
    multipliers; 32.2 B parameters, 16.3 B in the first 20 layers (the
    benchmark's cut); not among the reference's archs."""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (40, 4096, 100352)
    assert [i for i, t in enumerate(cfg.layer_types)
            if t == "attention"] == [5, 15, 25, 35]
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
            cfg.moe.d_ff_shared) == (72, 10, 768, 1536)
    assert isinstance(cfg.moe, DroplessMoEConfig)
    assert (cfg.ssm.d_state, cfg.ssm.d_head, cfg.ssm.expand * 4096 // 64) \
        == (128, 64, 128)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling, cfg.attention_multiplier) \
        == (12.0, 0.22, 16.0, 1 / 128)
    assert round(cfg.n_params() / 1e9, 1) == 32.2
    assert round(dataclasses.replace(cfg, n_layers=20).n_params() / 1e9,
                 2) == 16.31
    assert ARCH in list_archs() and ARCH not in ref_configs.list_archs()
    assert ARCH not in ARCH_IDS
    assert not isinstance(get_config("moonshot-v1-16b-a3b").moe,
                          DroplessMoEConfig)


def test_reduced_keeps_a_period_and_the_experts():
    r = get_config(ARCH).reduced()
    assert r.n_layers == 10 and set(r.mixers()) == {"mamba", "attention"}
    assert r.moe.n_experts >= 8 and r.moe.d_ff_shared > 0


def test_each_moe_path_takes_only_its_router(model):
    cfg, params, tokens = model
    x = torch.zeros(1, 4, cfg.d_model)
    p = {k: v[0] for k, v in params["layers"]["moe"].items()
         if k != "shared"}
    capacity = dataclasses.replace(get_config("moonshot-v1-16b-a3b")
                                   .reduced(), d_model=cfg.d_model,
                                   moe=MoEConfig(8, 3, 64))
    with pytest.raises(ValueError, match="top-k-then-softmax"):
        moe.moe_dropless(x, p, capacity)
    with pytest.raises(ValueError, match="softmax-then-top-k"):
        moe.moe_mlp(x, p, cfg)


def test_training_and_meshes_are_refused(model):
    from repro_torch.models import forward_train
    cfg, params, tokens = model
    with pytest.raises(ValueError, match="serves only"):
        forward_train(cfg, params, {"tokens": tokens, "targets": tokens})
