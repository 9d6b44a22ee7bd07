#!/usr/bin/env python3
"""Time the port's flash-attention kernel (K5, ``flash_attention.cu``)
against variants of how its bf16 kernel stages each V tile, in one process
on one GPU, interleaved (each variant in order, then in reverse order).

    python3 tools/k5_staging_ab.py [--rounds 10] [--reps 3]

Run from a checkout of the repository, on a card. Each variant is the
committed source with the V-staging loop replaced by exact text
substitution, built with the port's nvcc flags (``kernels/_build.py``).
Every variant must give the committed kernel's output bit for bit (staging
moves the same values) on every compiled head width before it is timed.
Shapes are the main path's: the reduced paper-unest (S 180,224, H 4, KV 2,
Dh 32) and the published width (H 8, KV 8, Dh 64), bf16, causal, read in
the model's (B, S, H, Dh) layout. Each round times every variant once
(the median of ``--reps`` runs, CUDA events, ``chip_smoke.Timer``), in
turn forward and backward. Prints the card's name and power limit and, per
variant and width, the median and quartiles over the rounds and in how
many rounds it beat the committed kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CU = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
TOKENS = 64 * 64 * 44

# the committed loop: a warp spans 4 dim pairs of 8 key pairs, so each
# 32-bit load reads 16 contiguous bytes of 8 rows and the transposed stores
# of a warp fall in 32 banks
COMMITTED = """\
    for (int idx = tid; idx < (kBK / 2) * PAIRS; idx += kThreads) {
      const int rest = idx >> 2;
      const int r = 2 * (rest % (kBK / 2)),
                c = 2 * (4 * (rest / (kBK / 2)) + (idx & 3));
"""
VARIANTS = {
    "committed": COMMITTED,
    # lanes take 32 key pairs at one dim pair: each lane reads its own key
    # row (32 rows per load), and the stores fall in 32 banks
    "keyrows": """\
    for (int idx = tid; idx < (kBK / 2) * PAIRS; idx += kThreads) {
      const int r = 2 * (idx % (kBK / 2)), c = 2 * (idx / (kBK / 2));
""",
    # lanes take consecutive dim pairs of one key pair: every load reads
    # whole rows (coalesced), and the transposed stores of a warp land in
    # 4 banks at the 72-element pitch (an 8-way conflict)
    "rowwise": """\
    for (int idx = tid; idx < (kBK / 2) * PAIRS; idx += kThreads) {
      const int r = 2 * (idx / PAIRS), c = 2 * (idx % PAIRS);
""",
}


def variant_sources(out_dir: Path):
    """Write each variant's source into ``out_dir``; returns name -> path."""
    src = CU.read_text()
    if src.count(COMMITTED) != 1:
        raise SystemExit(f"the V-staging loop of {CU} is not where this "
                         f"script expects it")
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, loop in VARIANTS.items():
        paths[name] = out_dir / f"k5_{name}.cu"
        paths[name].write_text(src.replace(COMMITTED, loop))
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k5_staging_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.flash_attention import (
        _ARGTYPES, HEAD_DIMS)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    names = []
    for name, path in variant_sources(ROOT / "build" / "k5_variants").items():
        _build.SOURCES[f"k5_{name}"] = path
        names.append(name)
    libs = _build.build_all([f"k5_{n}" for n in names])
    run = {}
    for name in names:
        for line in _build.build_log(f"k5_{name}").splitlines():
            if "registers" in line:
                print(f"ptxas {name}: {line.strip()}")
        f = ctypes.CDLL(str(libs[f"k5_{name}"])).repro_flash_attention
        f.argtypes, f.restype = _ARGTYPES, ctypes.c_int

        def call(q, k, v, f=f, name=name):  # (B,S,H,Dh) bf16, causal
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            B, H, Sq, Dh = qt.shape
            out = torch.empty_like(qt)
            st = [s for t in (qt, kt, vt, out) for s in t.stride()[:3]]
            rc = f(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
                   out.data_ptr(), 1, B, H, kt.shape[1], Sq, kt.shape[2],
                   Dh, *st, 1.0 / math.sqrt(Dh), 1, 0, 0,
                   torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            return out
        run[name] = call

    g = torch.Generator(device="cuda").manual_seed(0)

    def qkv(S, H, KV, Dh):
        return [torch.randn(1, S, n, Dh, device="cuda", generator=g)
                .to(torch.bfloat16) for n in (H, KV, KV)]

    for Dh in HEAD_DIMS:                    # every compiled width, ragged S
        x = qkv(1000, 4, 2, Dh)
        want = run["committed"](*x)
        for name in names:
            if not torch.equal(run[name](*x), want):
                raise SystemExit(f"{name} differs from the committed kernel "
                                 f"at Dh {Dh}")
    print(f"all variants equal the committed kernel bit for bit at Dh "
          f"{HEAD_DIMS}, S 1000", flush=True)
    timer = chip_smoke.Timer()
    for label, (H, KV, Dh) in (("reduced", (4, 2, 32)),
                               ("published", (8, 8, 64))):
        x = qkv(TOKENS, H, KV, Dh)
        want = run["committed"](*x)
        for name in names:
            if not torch.equal(run[name](*x), want):
                raise SystemExit(f"{name} differs at {label} width")
        times = {n: [] for n in names}
        for i in range(args.rounds):
            for name in names if i % 2 == 0 else names[::-1]:
                times[name].append(timer(lambda: run[name](*x),
                                         reps=args.reps))
        for name in names:
            t, base = times[name], times["committed"]
            q1, _, q3 = statistics.quantiles(t, n=4)
            print(f"{label} width (S {TOKENS}, H {H}, KV {KV}, Dh {Dh}) "
                  f"{name}: median {statistics.median(t)} ms, quartiles "
                  f"{q1} {q3} ms, faster than committed in "
                  f"{sum(a < b for a, b in zip(t, base))} of {len(t)} "
                  f"rounds; rounds {t}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
