#!/usr/bin/env python3
"""Time the port's flash-attention kernel (K5, ``flash_attention.cu``)
against other versions of its source, and against PyTorch's SDPA, in one
process on one GPU, in alternating rounds.

    python3 tools/k5_ab.py [--variant NAME=PATH ...] [--rounds 6] [--reps 3]

Run from a checkout of the repository, on a card. Each ``--variant`` is a
CUDA source with the same C interface (``repro_flash_attention``), for
example an earlier commit's ``flash_attention.cu`` (``git show
REV:src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``),
built with the port's nvcc flags (``kernels/_build.py``) beside the
committed source. Before it is timed, every version must agree with the
plain version within ``chip_smoke.K5_TOL`` on every 64-row query tile, at
every compiled head width (ragged S 1,000, causal), and is compared bit
for bit with the committed kernel. Shapes, bf16, causal, in the model's
(B, S, H, Dh) layout: the reduced paper-unest (S 180,224, H 4, KV 2, Dh
32), the published width (H 8, KV 8, Dh 64) and llama3.2-1b's prefill (B
4, S 2,000, H 32, KV 8, Dh 64). Each round times every version and SDPA
once (the median of ``--reps`` runs, CUDA events, L2 flushed,
``chip_smoke.Timer``), in turn forward and backward. Prints the card's
name and power limit, each version's ptxas lines and, per version and
shape, the median and quartiles over the rounds.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPES = {  # label -> (B, S, H, KV, Dh)
    "reduced": (1, 64 * 64 * 44, 4, 2, 32),
    "published": (1, 64 * 64 * 44, 8, 8, 64),
    "llama_prefill": (4, 2000, 32, 8, 64),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("k5_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention.flash_attention import (
        _ARGTYPES, HEAD_DIMS, run_kernel)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    sources = {"committed": _build.SOURCES["flash_attention"]}
    for spec in args.variant:
        name, _, path = spec.partition("=")
        sources[name] = Path(path).resolve()
    for name, path in sources.items():
        _build.SOURCES[f"k5_{name}"] = path
    libs = _build.build_all([f"k5_{n}" for n in sources])
    run = {}
    for name in sources:
        for line in _build.build_log(f"k5_{name}").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
        f = ctypes.CDLL(str(libs[f"k5_{name}"])).repro_flash_attention
        f.argtypes, f.restype = _ARGTYPES, ctypes.c_int

        def call(q, k, v, f=f):      # (B, S, H, Dh) bf16, causal
            return run_kernel(f, *(t.transpose(1, 2) for t in (q, k, v)),
                              stream=torch.cuda.current_stream().cuda_stream
                              ).transpose(1, 2)
        run[name] = call
    names = list(run)
    g = torch.Generator(device="cuda").manual_seed(0)

    def qkv(B, S, H, KV, Dh):
        return [torch.randn(B, S, n, Dh, device="cuda", generator=g)
                .to(torch.bfloat16) for n in (H, KV, KV)]

    for Dh in HEAD_DIMS:                    # every compiled width, ragged S
        x = qkv(2, 1000, 4, 2, Dh)
        want = fa.flash_attention_plain(*(t.transpose(1, 2) for t in x))
        base = run["committed"](*x)
        for name in names:
            chip_smoke.hold_k5(run[name](*x).transpose(1, 2), want,
                               f"{name} at Dh {Dh}")
            print(f"Dh {Dh} {name}: within K5_TOL of the plain version, bit "
                  f"equal to the committed kernel "
                  f"{torch.equal(run[name](*x), base)}", flush=True)
    timer = chip_smoke.Timer()
    for label, (B, S, H, KV, Dh) in SHAPES.items():
        x = qkv(B, S, H, KV, Dh)
        xt = [t.transpose(1, 2) for t in x]
        fns = dict(run)
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(
            *xt, is_causal=True, enable_gqa=True)
        times = {n: [] for n in fns}
        order = list(fns)
        for i in range(args.rounds):
            for name in order if i % 2 == 0 else order[::-1]:
                fn = fns[name]
                times[name].append(timer(
                    fn if name == "sdpa" else (lambda fn=fn: fn(*x)),
                    reps=args.reps))
        bound = chip_smoke.attention_bound(S, H, KV, Dh, 2, B)
        for name, t in times.items():
            q1, _, q3 = statistics.quantiles(t, n=4)
            print(f"{label} (B {B}, S {S}, H {H}, KV {KV}, Dh {Dh}; bound "
                  f"{bound[0]} ms, {bound[1]}) {name}: median "
                  f"{statistics.median(t)} ms, quartiles {q1} {q3} ms; "
                  f"rounds {t}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
