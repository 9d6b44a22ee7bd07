"""Serve a small model with batched requests on the PyTorch port: prefill +
greedy decode against KV/SSM caches, across three architecture families.
Runs on the GPU; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve_batch

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

rng = np.random.default_rng(0)
for arch in ("llama3.2-1b", "rwkv6-1.6b", "zamba2-1.2b"):
    cfg = get_config(arch).reduced()
    prompts = rng.integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)
    toks = serve_batch(arch, prompts, max_new=8, device=args.device)
    print(f"{arch:14s} generated: {toks.tolist()}")
