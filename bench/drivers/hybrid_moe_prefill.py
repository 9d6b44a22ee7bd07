"""Prefill-only requests to a hybrid MoE model (granitemoehybrid) through
the port's one-device serving step: ``lm_prefill``'s traffic, batching,
closed loop and timed path (``make_prefill_step``, then ``greedy_sample``
on the host), with this family's set-up, counts and check.

Set-up builds the kernels the path runs (K4, K5, K6 and the Mamba-2 glue)
before anything is timed, and draws the weights on the card from the seed
layer by layer (``bench/weights.draw`` makes a leaf in f32 first, and one
stacked (L, 72, 4,096, 1,536) experts' leaf would be a 36 GB transient).
The serving step is wrapped so that each batch's last-token logits, the
step's own output tensor, stay on the card for the check (no copy; ~51 MB a
cycle). The window's items carry them, the operations the requests need
(``bench/counts/hybrid_moe``) and K6's bounds. The check compares the
served logits, not the sampled tokens, with the plain float32 reference
``bench/reference/granite4_hybrid.py``: with random weights the largest
logit moves on rounding, and bf16 routes a token's tenth expert otherwise
than f32 on near-ties.

Traffic keys: ``lm_prefill``'s.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from bench.counts import hybrid_moe
from bench.drivers.lm_prefill import (State, _gaps, _sample, batches,
                                      lengths, prompts, serve)
from bench.harness import Laps, Spans, seed_of
from bench.reference import granite4_hybrid
from bench.weights import draw

REF_ROWS = 8              # the reference's rows a call (its scores fit)
KERNELS = ["rmsnorm", "flash_attention", "mamba2_ssd", "mamba2_glue"]


def model_config(c: dict):
    """The program's ``ModelConfig`` of a configuration file: config.json's
    numbers as the file holds them, ``n_layers`` of them run."""
    from repro_torch.configs import SSMConfig
    from repro_torch.configs.hybrid_moe import (DroplessMoEConfig,
                                                HybridMoEConfig)
    D, Hq = c["hidden_size"], c["num_attention_heads"]
    if c["mamba_n_heads"] * c["mamba_d_head"] != c["mamba_expand"] * D \
            or c["mamba_n_groups"] != 1:
        raise ValueError("the port's Mamba-2 takes d_inner = heads x head "
                         "width and one group of B and C")
    if c["position_embedding_type"] != "nope":
        raise ValueError("the port's hybrid_moe attention has no position "
                         "embedding")
    return HybridMoEConfig(
        name=c["name"], family="hybrid_moe", n_layers=c["n_layers"],
        d_model=D, n_heads=Hq, n_kv_heads=c["num_key_value_heads"],
        d_head=D // Hq, d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], norm_eps=c["rms_norm_eps"],
        rope_theta=float(c["rope_theta"]),
        tie_embeddings=c["tie_word_embeddings"],
        moe=DroplessMoEConfig(n_experts=c["num_local_experts"],
                              top_k=c["num_experts_per_tok"],
                              d_ff_expert=c["intermediate_size"],
                              d_ff_shared=c["shared_intermediate_size"],
                              router_aux_weight=0.0),
        ssm=SSMConfig(d_state=c["mamba_d_state"], d_head=c["mamba_d_head"],
                      expand=c["mamba_expand"],
                      chunk=c["mamba_chunk_size"],
                      d_conv=c["mamba_d_conv"]),
        layer_types=tuple(c["layer_types"]),
        embedding_multiplier=float(c["embedding_multiplier"]),
        residual_multiplier=float(c["residual_multiplier"]),
        logits_scaling=float(c["logits_scaling"]),
        attention_multiplier=float(c["attention_multiplier"]),
        # q, k, v and the SwiGLU halves laid out as the reference's specs
        tp_fuse=1)


def draw_by_layer(specs, gen: torch.Generator, dtype, device):
    """:func:`bench.weights.draw` of ``specs``, a stacked leaf of three or
    more dims one layer at a time into its served dtype."""
    if isinstance(specs, dict):
        return {k: draw_by_layer(v, gen, dtype, device)
                for k, v in specs.items()}
    shape = tuple(specs[1])
    if specs[0] != "normal" or len(shape) < 3:
        return draw(specs, gen, dtype, device)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = draw(("normal", shape[1:], specs[2]), gen, dtype, device)
    return out


class KeptLogits:
    """The serving step, keeping a reference to each call's last-token
    logits (B, V) in ``rows`` (the step's output, not a copy)."""

    def __init__(self, step):
        self.step, self.rows = step, []

    def __call__(self, params, batch):
        logits, cache = self.step(params, batch)
        self.rows.append(logits)
        return logits, cache


def setup(c: dict, traffic: dict, seed: int, device: str) -> State:
    lap = Laps(device)
    from repro_torch.kernels import _build
    from repro_torch.serve import make_prefill_step
    if device != "cpu":
        _build.build_all(KERNELS)
    lap("build")
    dtype = getattr(torch, c["dtype"])
    gen = torch.Generator(device).manual_seed(seed_of(seed, 0))
    params = draw_by_layer(granite4_hybrid.param_specs(c), gen, dtype,
                           device)
    lap("weights")
    st = State(c, device, params, seed, traffic, lengths(traffic),
               batches(traffic),
               KeptLogits(make_prefill_step(model_config(c), dtype)), lap)
    shapes = {(S, len(reqs)): reqs for S, reqs in st.batches}
    for (S, _), reqs in sorted(shapes.items()):     # every shape sent
        serve(st, prompts(st, -1, reqs, S), Spans(False))
    st.prefill.rows.clear()
    lap("warm")
    return st


def window(st: State, seconds: float, spans) -> List[dict]:
    """Whole cycles, each begun while the window's ``seconds`` have not
    passed; one item a batch."""
    c = st.c
    items, cycle = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        order = np.random.default_rng(seed_of(st.seed, 11, cycle)) \
            .permutation(len(st.batches))
        for b in order.tolist():
            S, reqs = st.batches[b]
            ttft, served = serve(st, prompts(st, cycle, reqs, S), spans)
            lens = [st.lens[i] for i in reqs]
            items.append({
                "cycle": cycle, "batch": b, "S": S, "requests": len(reqs),
                "ttft_s": ttft, "prompt_tokens": sum(lens),
                "served": served, "logits": st.prefill.rows.pop(),
                "flops": sum(hybrid_moe.hybrid_moe_prefill(c, 1, n)["total"]
                             for n in lens),
                "bound_s": {"mamba2_ssd": sum(hybrid_moe.ssd_bounds(c, n)
                                              for n in lens)}})
        cycle += 1
    return items


def readings(st: State, items, seed: int, precision=None):
    """Over the sampled requests (``lm_prefill._sample``), row by row:
    (the distance of the served last-token logits from the plain float32
    reference's, over the norm of the reference's; the served logits' best
    less their logit of the served token), the reference run once over
    each padded prompt. With ``precision`` the reference in that precision
    stands in for the program, logits and token (its argmax): the
    control."""
    errs, gaps = [], []
    with torch.inference_mode():
        for it, rows in _sample(st, items, seed):
            S = it["S"]
            reqs = [st.batches[it["batch"]][1][r] for r in rows]
            toks = prompts(st, it["cycle"], reqs, S)
            for r0 in range(0, len(rows), REF_ROWS):
                part = rows[r0:r0 + REF_ROWS]
                tt = torch.as_tensor(toks[r0:r0 + REF_ROWS],
                                     device=st.device)
                ref = granite4_hybrid.logits(st.c, st.params, tt,
                                             [S - 1])[:, 0]
                if precision is None:
                    got = it["logits"][torch.as_tensor(
                        part, device=st.device)].float()
                    served = it["served"][part]
                else:
                    got = granite4_hybrid.logits(st.c, st.params, tt,
                                                 [S - 1], precision)[:, 0]
                    served = got.argmax(-1).cpu().numpy()
                errs.append((got - ref).norm(dim=-1) / ref.norm(dim=-1))
                gaps.append(_gaps(got, served))
    return torch.cat(errs).cpu(), torch.cat(gaps).cpu()


def check(st: State, items, seed: int, limits: dict, precision=None):
    """Of :func:`readings` over the sampled requests: ``logit_err``, the
    median logit distance (bf16's rounding and router near-ties against
    the reference, what a lower precision moves most); ``logit_err_max``,
    the largest (a request that the median would hide); and
    ``served_token_gap``, the largest gap (0 wherever the served token is
    the served logits' argmax). Returns [(name, value, limit)]."""
    err, gap = readings(st, items, seed, precision)
    return [("logit_err", float(err.median()), limits["logit_err"]),
            ("logit_err_max", float(err.amax()), limits["logit_err_max"]),
            ("served_token_gap", float(gap.amax()),
             limits["served_token_gap"])]
