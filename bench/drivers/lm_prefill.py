"""Prefill-only requests (one output token each) through the port's
one-device serving step, as ``launch/serve.py``'s ``serve_batch`` begins:
``make_prefill_step``, then the token by ``greedy_sample`` on the host. A
closed loop with one batch in flight.

Traffic keys: ``requests`` (a cycle's requests), ``prompt_median`` and
``prompt_sigma`` (a log-normal of prompt lengths: a cycle's lengths are
its (i + 1/2) / ``requests`` quantiles, so every seed sends the same mix),
``max_len`` (a longer prompt is cut to it), ``bucket`` (a prompt is batched
with those that round up to the same multiple of it, and left-padded to
that multiple with token 0, as the port's prefill takes one length a
batch), ``batch`` (the most requests a batch), ``check_requests``
(requests the reference recomputes). A cycle's batches go in an order
drawn from the seed; prompt ids are drawn from the seed, the cycle and the
request.
"""
from __future__ import annotations

import dataclasses
import math
import time
from statistics import NormalDist
from typing import List, Tuple

import numpy as np
import torch

from bench.counts import bounds, flops
from bench.harness import Laps, Spans, seed_of
from bench.models import model_config
from bench.reference import zamba2_hybrid
from bench.weights import draw

REF_ROWS = 8              # the reference's rows a call (its scores fit)


def lengths(traffic: dict) -> List[int]:
    """A cycle's prompt lengths, request by request."""
    n, med, sig = (traffic[k] for k in ("requests", "prompt_median",
                                        "prompt_sigma"))
    q = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    return [min(traffic["max_len"], max(1, round(med * math.exp(sig * z))))
            for z in q]


def batches(traffic: dict) -> List[Tuple[int, List[int]]]:
    """A cycle's batches: (padded length, the requests in it), bucket by
    bucket, at most ``batch`` requests each."""
    bk, B = traffic["bucket"], traffic["batch"]
    by = {}
    for i, n in enumerate(lengths(traffic)):
        by.setdefault(-(-n // bk) * bk, []).append(i)
    return [(S, reqs[j:j + B]) for S, reqs in sorted(by.items())
            for j in range(0, len(reqs), B)]


@dataclasses.dataclass
class State:
    c: dict
    device: str
    params: dict
    seed: int
    traffic: dict
    lens: List[int]
    batches: List[Tuple[int, List[int]]]
    prefill: object
    phases: Laps


def setup(c: dict, traffic: dict, seed: int, device: str) -> State:
    lap = Laps(device)
    from repro_torch.kernels import _build
    from repro_torch.serve import make_prefill_step
    if device != "cpu":
        _build.build_all(["rmsnorm", "flash_attention", "mamba2_ssd"])
    lap("build")
    dtype = getattr(torch, c["dtype"])
    gen = torch.Generator(device).manual_seed(seed_of(seed, 0))
    params = draw(zamba2_hybrid.param_specs(c), gen, dtype, device)
    lap("weights")
    st = State(c, device, params, seed, traffic, lengths(traffic),
               batches(traffic), make_prefill_step(model_config(c), dtype),
               lap)
    shapes = {(S, len(reqs)): reqs for S, reqs in st.batches}
    for (S, _), reqs in sorted(shapes.items()):     # every shape sent
        serve(st, prompts(st, -1, reqs, S), Spans(False))
    lap("warm")
    return st


def prompts(st: State, cycle: int, reqs: List[int], S: int) -> np.ndarray:
    """(len(reqs), S) token ids: each request's own, left-padded with 0."""
    out = np.zeros((len(reqs), S), dtype=np.int64)
    for r, i in enumerate(reqs):
        n = st.lens[i]
        rng = np.random.default_rng(seed_of(st.seed, 10, cycle + 1, i))
        out[r, S - n:] = rng.integers(0, st.c["vocab_size"], n)
    return out


def serve(st: State, toks: np.ndarray, spans) -> Tuple[float, np.ndarray]:
    """One batch through the timed path: (seconds from its submission to
    its tokens on the host, the (B,) served tokens)."""
    from repro_torch.serve import greedy_sample
    t0 = time.perf_counter()
    with torch.inference_mode():
        with spans("prefill"):
            batch = {"tokens": torch.as_tensor(toks, device=st.device)}
            logits, _ = st.prefill(st.params, batch)
        with spans("sample"):
            tok = greedy_sample(logits).cpu()
    return time.perf_counter() - t0, tok.numpy()


def window(st: State, seconds: float, spans) -> List[dict]:
    """Whole cycles, each begun while the window's ``seconds`` have not
    passed; one item a batch."""
    c = st.c
    s = c["ssm"]
    H = s["expand"] * c["d_model"] // s["d_head"]
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
                "served": served,
                "flops": sum(flops.hybrid_prefill(c, 1, n)["total"]
                             for n in lens),
                "bound_s": {"mamba2_ssd": c["n_layers"] * sum(
                    bounds.ssd_bound(1, H, n, s["d_head"], s["d_state"])
                    for n in lens)}})
        cycle += 1
    return items


def _sample(st: State, items, seed: int):
    """``check_requests`` of the window's requests drawn from the seed,
    with one of the longest among them: [(item, rows)] by batch."""
    done = [(k, r) for k, it in enumerate(items)
            for r in range(it["requests"])]
    rng = np.random.default_rng(seed_of(seed, 12))
    pick = rng.choice(len(done), min(st.traffic["check_requests"],
                                     len(done)), replace=False).tolist()

    def length(j):
        k, r = done[j]
        return st.lens[st.batches[items[k]["batch"]][1][r]]
    longest = max(length(j) for j in range(len(done)))
    if max(length(j) for j in pick) < longest:
        pick[0] = next(j for j in rng.permutation(len(done)).tolist()
                       if length(j) == longest)
    rows = {}
    for j in pick:
        k, r = done[j]
        rows.setdefault(k, []).append(r)
    return [(items[k], np.sort(rs)) for k, rs in sorted(rows.items())]


def _gaps(ref, toks):
    """ref (r, V) logits; toks (r,): how far each token's logit lies below
    the reference's best."""
    t = torch.as_tensor(toks, device=ref.device).long()
    return ref.amax(-1) - torch.gather(ref, -1, t[:, None])[:, 0]


def check(st: State, items, seed: int, limits: dict, precision=None):
    """``token_gap``: over the sampled requests, the largest amount by which
    the plain float32 reference's logit of the served token lies below its
    best logit, the reference run once over each padded prompt. With
    ``precision`` the reference in that precision stands in for the
    program, its token the one it ranks first (the control). Returns
    [(name, value, limit)]."""
    worst = 0.0
    with torch.inference_mode():
        for it, rows in _sample(st, items, seed):
            S = it["S"]
            reqs = [st.batches[it["batch"]][1][r] for r in rows]
            toks = prompts(st, it["cycle"], reqs, S)
            for r0 in range(0, len(rows), REF_ROWS):
                tt = torch.as_tensor(toks[r0:r0 + REF_ROWS],
                                     device=st.device)
                ref = zamba2_hybrid.logits(st.c, st.params, tt,
                                           [S - 1])[:, 0]
                served = it["served"][rows[r0:r0 + REF_ROWS]]
                if precision is not None:
                    served = zamba2_hybrid.logits(
                        st.c, st.params, tt, [S - 1], precision)[:, 0] \
                        .argmax(-1).cpu().numpy()
                worst = max(worst, float(_gaps(ref, served).amax()))
    return [("token_gap", worst, limits["token_gap"])]
