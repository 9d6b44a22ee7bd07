#!/usr/bin/env python3
"""How often the served bf16 path routes a token to other experts than the
plain float32 reference does, layer by layer, in ``granite4h_prefill``'s
configuration.

    python3 tools/router_flips.py [--seed 1] [--batch 4] [--len 1024]

Run from a checkout of the repository, on a card. It draws the cell's
weights from the seed as the benchmark does (``bench/drivers/
hybrid_moe_prefill.py``), serves ``--batch`` random prompts of ``--len``
tokens through ``make_prefill_step`` in bf16 and runs the reference
(``bench/reference/granite4_hybrid.py``) over them, recording each MoE
layer's top-k experts on both sides; it prints, per layer, the share of
tokens whose set of experts differs, their mean, and the prompts'
``token_gap`` (the reference's best logit less its logit of the served
token, largest over the prompts).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    import numpy as np
    import torch
    from bench.drivers import hybrid_moe_prefill as drv
    from bench.harness import seed_of
    from bench.reference import granite4_hybrid as ref
    from repro_torch.models import moe
    from repro_torch.serve import make_prefill_step
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--len", type=int, default=1024)
    args = ap.parse_args(argv)
    c = json.loads((ROOT / "bench" / "configs"
                    / "granite-4.0-h-small.json").read_text())
    gen = torch.Generator("cuda").manual_seed(seed_of(args.seed, 0))
    params = drv.draw_by_layer(ref.param_specs(c), gen, torch.bfloat16,
                               "cuda")
    B, S = args.batch, args.len
    toks = torch.as_tensor(np.random.default_rng(args.seed).integers(
        0, c["vocab_size"], (B, S)), device="cuda")
    served, want = [], []
    route, ref_moe = moe.route_topk_softmax, ref.moe

    def record(x, router, k):
        sel, gates = route(x, router, k)
        served.append(sel.sort(-1).values.cpu())
        return sel, gates

    def ref_record(cc, h, p, precision):
        x = h.reshape(-1, h.shape[-1])
        sel = torch.topk(ref.mm(x, p["router"], precision),
                         cc["num_experts_per_tok"], -1)[1]
        want.append(sel.sort(-1).values.cpu())
        return ref_moe(cc, h, p, precision)
    moe.route_topk_softmax, ref.moe = record, ref_record
    try:
        with torch.inference_mode():
            logits, _ = make_prefill_step(drv.model_config(c),
                                          torch.bfloat16)(
                params, {"tokens": toks})
            best = ref.logits(c, params, toks, [S - 1])[:, 0]
    finally:
        moe.route_topk_softmax, ref.moe = route, ref_moe
    share = [float((a != b).any(-1).float().mean())
             for a, b in zip(served, want)]
    tok = logits.argmax(-1, keepdim=True).long()
    gap = float((best.amax(-1) - best.gather(-1, tok)[:, 0]).amax())
    print("share of tokens routed to another set of experts, by layer:",
          [round(v, 4) for v in share])
    print(f"mean {sum(share) / len(share):.4f} over {len(share)} layers x "
          f"{B * S} tokens; token_gap of these prompts {gap}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
