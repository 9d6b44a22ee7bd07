"""The moe, audio and vlm families on the port (``repro_torch.models``,
``launch.serve``) held against the JAX package on the CPU: moonshot-v1-16b-a3b
(top-2 of 4 experts at its reduced size), llama4-scout-17b-a16e (top-1,
``tp_fuse`` 8), whisper-small (an encoder of 2 layers over 64 frames,
cross-attention, learned positions) and internvl2-76b (16 patch embeddings
ahead of the prompt), at their reduced configs, with the reference's
weights carried across by ``repro_torch.convert.from_jax``. Inputs (tokens,
frames, patches) come from numpy seeds.

Tolerances and why:
  * prefill logits and every cache tensor: 1e-4 relative to the largest
    |value| in float32 (sums in other orders), with the experts each token
    chose (``sel``) equal in every layer; 3e-2 in bfloat16, the bf16
    tolerance of ``test_torch_serve.py``. In bfloat16 the two frameworks
    round the router's input at other places, and a token whose top-k
    experts are within a rounding of each other may choose another expert
    on each side. The test compares ``sel`` first and names each such
    token; it then holds a row's logits only if no token of the row chose
    otherwise, and a row's cache only before its first such token (causal:
    earlier positions never see it). It widens no tolerance.
  * decode consistency (prefill of S-1 tokens plus one decode step against
    prefill of S), the port's own, float32: 2e-3 absolute, the reference's
    bound (``tests/test_decode_consistency.py``), moe at capacity factor
    ``n_experts`` as there (no token dropped, so the dense decode mixture
    and the dispatched prefill compute the same function).
  * one decode step against the reference's from the same cache, float32:
    1e-4 of the largest |logit|.
  * ``serve_batch`` tokens: equal to the reference's on the same bf16
    weights, under ``test_torch_serve.py``'s rule for a first difference
    (the reference's top-2 logit gap within the bf16 tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.serve import serve_batch as ref_serve_batch
from repro.models import forward_decode as ref_decode
from repro.models import forward_prefill as ref_prefill
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import moe as ref_moe
from repro_torch import tree as tree_util
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import from_jax
from repro_torch.launch import serve as serve_mod
from repro_torch.models import (forward_decode, forward_prefill, init_cache,
                                init_params)
from repro_torch.models import moe as port_moe

CPU = torch.device("cpu")
ARCHS = ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "whisper-small",
         "internvl2-76b"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _cfgs(arch, no_drops=False):
    rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    if no_drops and cfg.moe is not None:
        cf = float(cfg.moe.n_experts)
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=cf))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return rcfg, cfg


def _batch(cfg, B, S, seed):
    """Tokens, and the frames or patches the config takes, as numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.encoder is not None:
        b["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.vlm is not None:
        b["embeds"] = rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.d_model)).astype(np.float32)
    return b


def _leaves(tree):
    return dict((tree_util.path_key(p), v)
                for p, v in tree_util.flatten_with_paths(tree))


def _max(a):
    return float(np.max(np.abs(np.asarray(a, np.float32))))


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else \
        np.asarray(t, np.float32)


@pytest.fixture
def sels(monkeypatch):
    """Records the ``sel`` of every ``_route`` call of both packages, by
    side, in call order (one per moe layer); the reference's, traced under
    ``jit``, through an ordered ``jax.debug.callback``."""
    out = {"ref": [], "port": []}

    def ref_route(*a, **k):
        sel, w, aux = real_ref(*a, **k)
        jax.debug.callback(lambda s: out["ref"].append(np.asarray(s)), sel,
                           ordered=True)
        return sel, w, aux

    def port_route(*a, **k):
        sel, w, aux = real_port(*a, **k)
        out["port"].append(sel.numpy())
        return sel, w, aux
    real_ref, real_port = ref_moe._route, port_moe._route
    monkeypatch.setattr(ref_moe, "_route", ref_route)
    monkeypatch.setattr(port_moe, "_route", port_route)
    yield out


def _first_flips(sels, B, S):
    """Per batch row, the first position where a layer's experts differ
    between the two sides (S if none), and the differences by (layer,
    row, position)."""
    first, named = [S] * B, []
    assert len(sels["ref"]) == len(sels["port"])
    for layer, (r, p) in enumerate(zip(sels["ref"], sels["port"])):
        assert r.shape == p.shape, (r.shape, p.shape)
        for b, s in zip(*np.nonzero((r != p).any(-1))):
            named.append((layer, int(b), int(s), r[b, s].tolist(),
                          p[b, s].tolist()))
            first[b] = min(first[b], int(s))
    return first, named


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference(arch, dtype, sels):
    """40 tokens, 2 rows (vlm: 56 positions with the patches)."""
    rcfg, cfg = _cfgs(arch)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    params = jax.tree.map(np.asarray, ref_init_params(
        rcfg, jax.random.PRNGKey(0), jdt))
    batch = _batch(cfg, 2, 40, seed=1)
    want_logits, want_cache = jax.jit(lambda p, b: ref_prefill(
        rcfg, p, b, jdt))(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    jax.effects_barrier()
    got_logits, got_cache = forward_prefill(
        cfg, from_jax(params, CPU),
        {k: torch.from_numpy(v) for k, v in batch.items()}, tdt)
    S = 40 + (cfg.vlm.n_patches if cfg.vlm is not None else 0)
    first, named = _first_flips(sels, 2, S)
    assert len(sels["port"]) == (cfg.n_layers if cfg.moe else 0)
    if named:
        print(f"{arch} {dtype}: tokens that chose other experts (layer, "
              f"row, position, reference, port): {named}")
    if dtype == "float32":
        assert not named, named
    tol = TOL[dtype]
    assert got_logits.dtype == tdt
    assert tuple(got_logits.shape) == want_logits.shape
    rows = [b for b in range(2) if first[b] == S]
    want_logits = np.asarray(want_logits, np.float32)
    assert rows or dtype == "bfloat16"
    for b in rows:
        assert np.max(np.abs(_np(got_logits[b]) - want_logits[b])) < \
            tol * _max(want_logits[b])
    want = _leaves(jax.tree.map(np.asarray, want_cache))
    got = _leaves(got_cache)
    assert set(got) == set(want) == ({"k", "v", "ck", "cv"}
                                     if cfg.encoder else {"k", "v"})
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        for b in range(2):
            n = first[b] if name in ("k", "v") else w.shape[2]
            err = np.max(np.abs(_np(g[:, b, :n]) - np.asarray(
                w[:, b, :n], np.float32)), initial=0.0)
            assert err < tol * _max(w), (name, b, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_and_reference(arch):
    """The reference's decode-consistency check on the port: prefill of
    S-1 tokens plus one decode step against prefill of S (float32). And
    the port's decode step against the reference's from the reference's
    prefill cache."""
    rcfg, cfg = _cfgs(arch, no_drops=True)
    params = jax.tree.map(np.asarray, ref_init_params(
        rcfg, jax.random.PRNGKey(1), jnp.float32))
    p = from_jax(params, CPU)
    B, S = 2, 32
    batch = _batch(cfg, B, S, seed=2)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    f32 = torch.float32
    full, _ = forward_prefill(cfg, p, tb, f32)
    short = dict(tb, tokens=tb["tokens"][:, :S - 1])
    _, cache = forward_prefill(cfg, p, short, f32)
    n_pre = cfg.vlm.n_patches if cfg.vlm is not None else 0
    cache = serve_mod.graft(init_cache(cfg, B, S + n_pre, f32, CPU), cache)
    step, _ = forward_decode(cfg, p, cache, tb["tokens"][:, S - 1:],
                             S - 1 + n_pre, f32)
    assert tuple(step.shape) == (B, 1, cfg.vocab_size)
    assert float((full - step[:, 0]).abs().max()) < 2e-3
    # the step against the reference's, from the reference's cache
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["tokens"] = jb["tokens"][:, :S - 1]
    _, rcache = ref_prefill(rcfg, params, jb, jnp.float32)
    rcache = jax.tree.map(
        lambda d, s: jnp.pad(s, [(0, a - b) for a, b in zip(d.shape,
                                                             s.shape)]),
        ref_init_cache(rcfg, B, S + n_pre, jnp.float32), rcache)
    want, _ = ref_decode(rcfg, params, rcache,
                         jnp.asarray(batch["tokens"][:, S - 1:]),
                         jnp.int32(S - 1 + n_pre), jnp.float32)
    got, _ = forward_decode(cfg, p, from_jax(jax.tree.map(np.asarray,
                                                          rcache), CPU),
                            tb["tokens"][:, S - 1:], S - 1 + n_pre, f32)
    want = np.asarray(want)
    assert np.max(np.abs(got.numpy() - want)) < 1e-4 * _max(want)


def _ref_loop(cfg, params, prompts, max_new):
    """The reference's ``serve_batch`` loop, keeping each step's logits."""
    B, S = prompts.shape
    batch = {"tokens": jnp.asarray(prompts)}
    n_pre = 0
    if cfg.encoder is not None:
        batch["enc_embeds"] = jnp.zeros((B, cfg.encoder.enc_seq,
                                         cfg.d_model), jnp.bfloat16)
    if cfg.vlm is not None:
        n_pre = cfg.vlm.n_patches
        batch["embeds"] = jnp.zeros((B, n_pre, cfg.d_model), jnp.bfloat16)
    logits, cache = jax.jit(lambda p, b: ref_prefill(cfg, p, b))(params,
                                                                  batch)
    cache = jax.tree.map(
        lambda d, s: jnp.pad(s.astype(d.dtype),
                             [(0, a - b) for a, b in zip(d.shape, s.shape)]),
        ref_init_cache(cfg, B, S + max_new + n_pre), cache)
    decode = jax.jit(lambda p, c, t, i: ref_decode(cfg, p, c, t, i))
    steps = [np.asarray(logits, np.float32)]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    toks = [tok]
    for i in range(max_new - 1):
        logits, cache = decode(params, cache, tok, jnp.int32(S + n_pre + i))
        steps.append(np.asarray(logits[:, 0], np.float32))
        tok = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)[:, None]
        toks.append(tok)
    return np.concatenate([np.asarray(t) for t in toks], 1), steps


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_tokens_match_reference(arch):
    max_new = 8
    rcfg, _ = _cfgs(arch)
    prompts = np.random.default_rng(3).integers(
        0, rcfg.vocab_size, (2, 24)).astype(np.int32)
    want = ref_serve_batch(arch, prompts, max_new=max_new)
    params = jax.tree.map(np.asarray, ref_init_params(
        rcfg, jax.random.PRNGKey(0), jnp.bfloat16))
    got = serve_mod.serve_batch(arch, prompts, max_new=max_new,
                                params=from_jax(params, CPU), device="cpu")
    assert got.dtype == np.int32 and got.shape == want.shape == (2, max_new)
    if np.array_equal(got, want):
        return
    loop_toks, steps = _ref_loop(rcfg, params, prompts, max_new)
    assert np.array_equal(loop_toks, want)
    for b in range(got.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if not len(diff):
            continue
        i = int(diff[0])
        lg = steps[i][b]
        top2 = np.sort(lg)[-2:]
        gap, bound = float(top2[1] - top2[0]), 3e-2 * float(np.abs(lg).max())
        print(f"{arch} row {b} step {i}: port {got[b, i]} vs reference "
              f"{want[b, i]}, reference top-2 gap {gap} <= {bound}")
        assert gap <= bound and lg[got[b, i]] >= top2[1] - bound


@pytest.mark.parametrize("arch", list_archs())
def test_every_config_builds(arch):
    """No family is refused any more: every config's reduced size builds,
    with the reference's keys, shapes and dtypes."""
    cfg = get_config(arch).reduced()
    port = init_params(cfg, torch.Generator(), device=CPU)
    ref = jax.eval_shape(lambda: ref_init_params(
        ref_get_config(arch).reduced(), jax.random.PRNGKey(0)))
    assert {k: tuple(v.shape) for k, v in _leaves(port).items()} == \
        {k: tuple(v.shape) for k, v in _leaves(ref).items()}
    assert all(v.dtype == torch.float32 for v in _leaves(port).values())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_has_the_reference_layout(arch):
    rcfg, cfg = _cfgs(arch)
    got = _leaves(init_cache(cfg, 2, 30, torch.float32, CPU))
    want = _leaves(jax.eval_shape(lambda: ref_init_cache(rcfg, 2, 30,
                                                         jnp.float32)))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert not any(v.any() for v in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_carries_the_family_trees(arch):
    """``from_jax`` carries the moe, encoder and ``pos_emb`` trees over as
    they are: the same keys, shapes, dtypes and bits, bf16 included."""
    rcfg, _ = _cfgs(arch)
    ref = jax.tree.map(np.asarray, ref_init_params(
        rcfg, jax.random.PRNGKey(4), jnp.bfloat16))
    got = _leaves(from_jax(ref, CPU))
    want = _leaves(ref)
    assert set(got) == set(want)
    extra = {"moonshot-v1-16b-a3b": "layers/moe/w13",
             "llama4-scout-17b-a16e": "layers/moe/router",
             "whisper-small": "encoder/layers/mlp/w1",
             "internvl2-76b": "layers/mlp/w13"}[arch]
    assert extra in got
    if rcfg.encoder is not None:
        assert {"pos_emb", "layers/xattn/wo", "encoder/final_norm"} <= \
            set(got)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape, k
        assert np.array_equal(g.view(torch.int16).numpy(),
                              w.view(np.int16)), k


def test_serve_cli_runs_whisper_on_the_cpu(capsys):
    serve_mod.main(["--arch", "whisper-small", "--batch", "1",
                    "--prompt-len", "9", "--max-new", "3", "--device",
                    "cpu"])
    out = capsys.readouterr().out
    assert "generated (1, 3)" in out and "on cpu" in out
