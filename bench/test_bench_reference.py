"""Each plain reference held against the port on the CPU (the kernels'
plain versions) at a reduced size: in float32 to 1e-4 of the largest
|logit| (sums in other orders), in bfloat16 to 3e-2 (the bf16 tolerance of
the port's own serving tests), so a wrong reference is caught before the
chip. And the weights' layout the benchmark draws is the program's."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.models import model_config
from bench.reference import zamba2_hybrid
from bench.weights import draw

BENCH = Path(__file__).resolve().parent
ZAMBA = json.loads((BENCH / "configs" / "zamba2-1.2b.json").read_text())
SMALL = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
             d_ff=256, vocab_size=512)
FUSED = dict(SMALL, n_heads=16, n_kv_heads=16, d_head=8)   # one wqkv
HYBRID = dict(n_layers=4, shared_attn_every=2, ssm={
    "d_state": 16, "d_head": 32, "expand": 2, "chunk": 64, "d_conv": 4})
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _rel(got, want):
    return float((got.float() - want).abs().amax() / want.abs().amax())


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    return tuple(t.shape)


def test_drawn_layout_is_the_programs():
    from repro_torch.models import init_params
    meta = init_params(model_config(ZAMBA), None, device="meta")
    assert _tree(meta) == _shapes(zamba2_hybrid.param_specs(ZAMBA))


def _shapes(specs):
    if isinstance(specs, dict):
        return {k: _shapes(v) for k, v in specs.items()}
    return tuple(specs[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("over", [SMALL, FUSED], ids=["qkv", "wqkv"])
def test_zamba2_reference_matches_prefill_and_decode(over, dtype):
    """Prefill of 100 tokens (a ragged last chunk), then one decode step
    through the grafted cache, against the reference over all 101."""
    from repro_torch.launch.serve import graft
    from repro_torch.models import init_cache
    from repro_torch.serve import make_decode_step, make_prefill_step
    c = {**ZAMBA, **over, **HYBRID}
    cfg = model_config(c)
    params = draw(zamba2_hybrid.param_specs(c),
                  torch.Generator().manual_seed(4), dtype, "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, c["vocab_size"], (2, 101)))
    S = 100
    with torch.inference_mode():
        logits, cache = make_prefill_step(cfg, dtype)(
            params, {"tokens": toks[:, :S]})
        cache = graft(init_cache(cfg, 2, S + 2, dtype, device="cpu"), cache)
        step, _ = make_decode_step(cfg, dtype)(params, cache, toks[:, S:],
                                               S)
        want = zamba2_hybrid.logits(c, params, toks, [S - 1, S])
    assert _rel(logits, want[:, 0]) < TOL[dtype]
    assert _rel(step[:, 0], want[:, 1]) < TOL[dtype]
