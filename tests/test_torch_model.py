"""The port's dense model (``repro_torch.models``) held against the JAX
package's on the CPU, with the reference's weights carried across by
``repro_torch.convert.from_jax``.

Tolerances and why:
  * ``rope_freqs``: bit-equal to the reference's compiled constant. At
    position 180,000 one bit of a frequency moves an angle by ~0.006 rad.
  * ``apply_rope`` at positions near 180,000, float32: 2e-6 absolute. The
    angles are bit-equal; what is left is two libraries' cos and sin
    (4.8e-7 measured).
  * ``mlp``, ``attn_qkv``: 1e-5 relative in float32 (sums in another
    order); 3e-2 absolute in bfloat16 (bf16 rounding of each product, and
    torch's tanh-gelu rounds once where XLA rounds each op).
  * ``attention`` at 4,096 tokens (the reference's 2048-query chunked
    branch): 2e-5 in float32; 3e-2 in bfloat16, where the reference rounds
    the probabilities to bf16 before P.V and the port keeps them in f32.
  * the stack + final norm + head on paper-unest reduced, bfloat16: 3e-2
    absolute on logits below 1 in magnitude (measured 2e-3: one bf16 step
    at 0.25-0.5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.models import init_params as jax_init_params
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.models import backbone_logits, init_params
from repro_torch.models import layers as TL

CPU = torch.device("cpu")


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                                - np.asarray(b, np.float32))))


def _rel(a, b):
    b = np.asarray(b, np.float32)
    return _err(a, b) / float(np.max(np.abs(b)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


ROPE_CASES = sorted({(c.d_head, c.rope_theta) for n in list_archs()
                     for c in (jax_get_config(n), jax_get_config(n).reduced())}
                    | {(16, 50000.0), (256, 50000.0), (96, 1234.5)})


@pytest.mark.parametrize("d_head,theta", ROPE_CASES)
def test_rope_freqs_bits_equal_xla_compiled(d_head, theta):
    want = np.asarray(jax.jit(lambda: RL.rope_freqs(d_head, theta))())
    got = TL.rope_freqs(d_head, theta).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("start", [0, 100_000, 176_128])
def test_apply_rope_at_large_positions(start):
    x = np.random.default_rng(start).standard_normal(
        (1, 2048, 2, 32)).astype(np.float32)
    pos = np.arange(start, start + 2048)
    want = jax.jit(lambda x, p: RL.apply_rope(x, p, 10_000.0))(x, pos)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        10_000.0)
    assert got.dtype == torch.float32
    err = _err(got, want)
    if err >= 2e-6:     # say which side moved (ROADMAP, Queue 3, F1)
        worst = np.unravel_index(np.argmax(np.abs(
            got.numpy() - np.asarray(want))), x.shape)
        same = np.array_equal(TL.rope_freqs(32, 10_000.0).numpy(), np.asarray(
            jax.jit(lambda: RL.rope_freqs(32, 10_000.0))()))
        pytest.fail(f"{err} >= 2e-6 at {worst}; frequencies bit-equal "
                    f"{same}; torch threads {torch.get_num_threads()}")


def test_apply_rope_keeps_bf16():
    x = np.random.default_rng(1).standard_normal((2, 16, 4, 32))
    pos = np.arange(100, 116)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = jax.jit(lambda x, p: RL.apply_rope(x, p, 10_000.0))(xj, pos)
    got = TL.apply_rope(torch.from_numpy(x).to(torch.bfloat16),
                        torch.from_numpy(pos), 10_000.0)
    assert got.dtype == torch.bfloat16
    assert _err(got.float(), want) < 3e-2


@pytest.mark.parametrize("kind", ["gelu", "swiglu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(kind, dtype):
    p = _np_tree(RL.init_mlp(jax.random.PRNGKey(0), 64, 128, kind))
    x = np.random.default_rng(2).standard_normal((2, 8, 64)) \
        .astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = RL.mlp(jnp.asarray(x).astype(jdt), p, kind, fuse=4)
    got = TL.mlp(torch.from_numpy(x).to(tdt), from_jax(p, CPU), kind,
                 fuse=4)
    assert got.dtype == tdt
    if dtype == "float32":
        assert _rel(got, want) < 1e-5
    else:
        assert _err(got.float(), want) < 3e-2


@pytest.mark.parametrize("tp_fuse", [16, 2])
def test_attn_qkv_and_out_match_reference(tp_fuse):
    """tp_fuse 16: separate wq/wk/wv (paper-unest); 2: the fused,
    interleaved wqkv of the configs that shard it."""
    cfg = dataclasses.replace(jax_get_config("paper-unest").reduced(),
                              tp_fuse=tp_fuse)
    assert RL.qkv_fusable(cfg) == (tp_fuse == 2) == TL.qkv_fusable(cfg)
    p = _np_tree(RL.init_attn(jax.random.PRNGKey(1), cfg))
    x = np.random.default_rng(3).standard_normal((2, 8, cfg.d_model)) \
        .astype(np.float32)
    want = RL.attn_qkv(jnp.asarray(x), p, cfg)
    got = TL.attn_qkv(torch.from_numpy(x), from_jax(p, CPU), cfg)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) < 1e-5
    o = np.array(want[0])
    assert _rel(TL.attn_out(torch.from_numpy(o), from_jax(p, CPU)),
                RL.attn_out(jnp.asarray(o), p)) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_reference_chunked_branch(dtype):
    """4,096 query rows: the reference takes its scan over 2048-row
    chunks, the port its plain version's loop over the same chunks."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 4096, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((1, 4096, 2, 32)).astype(np.float32)
            for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = RL.attention(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                        causal=True)
    got = TL.attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                       causal=True)
    assert got.shape == q.shape and got.dtype == tdt
    assert _err(got.float(), want) < (2e-5 if dtype == "float32" else 3e-2)


def test_attention_runs_any_length_above_the_chunk():
    """The reference asserts ``Sq % 2048 == 0`` above 2048 query rows
    (ROADMAP R5: a 182x218x182 T1w gives 109,350 patch tokens); the port
    runs any length, its last chunk ragged."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 2100, 2, 16)).astype(np.float32)
               for _ in range(3))
    with pytest.raises(AssertionError):
        RL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = TL.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = RL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        chunk=4096)
    assert _err(got, want) < 2e-5


def test_init_params_has_the_reference_layout():
    cfg = get_config("paper-unest").reduced(vocab_size=8)
    ref = _np_tree(jax_init_params(cfg, jax.random.PRNGKey(0)))
    port = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_p = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), port))[0]
    assert [(p, a.shape, a.dtype) for p, a in flat_r] == \
        [(p, a.shape, a.dtype) for p, a in flat_p]
    again = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    assert torch.equal(port["layers"]["mlp"]["w1"],
                       again["layers"]["mlp"]["w1"])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b",
                                  "llama3.2-1b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_families_init_params_have_the_reference_layout(arch, dtype):
    """Key names (``layers.rwkv``, ``layers.mamba``, ``shared``), shapes
    and dtypes of the served families, at their reduced configs."""
    cfg = get_config(arch).reduced()
    ref = _np_tree(jax_init_params(jax_get_config(arch).reduced(),
                                   jax.random.PRNGKey(0),
                                   getattr(jnp, dtype)))
    port = init_params(cfg, torch.Generator().manual_seed(0),
                       getattr(torch, dtype), CPU)
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_p = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.float().numpy(), port))[0]
    assert [(p, a.shape) for p, a in flat_r] == \
        [(p, a.shape) for p, a in flat_p]
    assert all(t.dtype == getattr(torch, dtype)
               for t in jax.tree.leaves(port))


def test_stack_norm_and_head_match_reference_in_bf16():
    cfg = jax_get_config("paper-unest").reduced(vocab_size=8)
    params = _np_tree(jax_init_params(cfg, jax.random.PRNGKey(0)))
    x = np.random.default_rng(5).standard_normal((1, 256, cfg.d_model)) \
        .astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    h, _, _ = RM._txf_stack(cfg, params, xj, jnp.arange(256), None,
                            remat=False, collect_cache=False)
    want = RM.lm_logits(cfg, params, RM.rmsnorm(h, params["final_norm"],
                                                cfg.norm_eps))
    tp = from_jax(params, CPU)
    tcfg = get_config("paper-unest").reduced(vocab_size=8)
    got = backbone_logits(tcfg, tp, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.max(np.abs(np.asarray(want, np.float32))) < 1.0
    assert _err(got.float(), want) < 3e-2
