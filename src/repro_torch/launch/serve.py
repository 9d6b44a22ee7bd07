"""Serving entry point: batched prefill + greedy decode loop with KV/SSM
caches (``repro/launch/serve.py``), on ``cuda`` unless the caller asks for
the CPU.

    python -m repro_torch.launch.serve --arch rwkv6-1.6b --device cpu
    python -m repro_torch.launch.serve --arch whisper-small --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import init_cache, init_params
from ..serve import greedy_sample, make_decode_step, make_prefill_step


def graft(dst, src):
    """Copy a prefill cache into its zeroed decode cache (in place) and
    return it: a KV cache's sequence axis (-3) is longer in ``dst``, whose
    tail stays zero; a recurrent state has one shape on both sides. Values
    are cast to the decode cache's dtype."""
    if isinstance(dst, dict):
        return {k: graft(dst[k], src[k]) for k in dst}
    src = src.to(dst.dtype)
    if dst.dim() >= 4 and dst.dim() == src.dim() \
            and dst.shape[-3] >= src.shape[-3] \
            and dst.shape[:-3] == src.shape[:-3]:
        dst[..., :src.shape[-3], :, :] = src
        return dst
    return src


def serve_batch(arch: str, prompts: np.ndarray, max_new: int = 16,
                reduced: bool = True, seed: int = 0, *, params=None,
                device=None) -> np.ndarray:
    """prompts: (B, S) integer tokens. Returns (B, max_new) int32 generated
    tokens. Weights are drawn from a CPU ``torch.Generator`` seeded
    ``seed`` in bf16, unless ``params`` (e.g. the reference's, through
    ``repro_torch.convert.from_jax``) are given; ``device`` ``None`` means
    ``cuda``. As in the reference, an encoder config gets zero frame
    embeddings (B, enc_seq, D) and a vlm config zero patch embeddings (B,
    n_patches, D), ahead of the prompt: its decode starts at S +
    n_patches."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed),
                             torch.bfloat16, dev)
    B, S = prompts.shape
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    with torch.inference_mode():
        batch = {"tokens": torch.as_tensor(np.asarray(prompts),
                                           dtype=torch.int64, device=dev)}
        if cfg.encoder is not None:
            batch["enc_embeds"] = torch.zeros(
                (B, cfg.encoder.enc_seq, cfg.d_model), dtype=torch.bfloat16,
                device=dev)
        n_patches = 0
        if cfg.vlm is not None:
            n_patches = cfg.vlm.n_patches
            batch["embeds"] = torch.zeros((B, n_patches, cfg.d_model),
                                          dtype=torch.bfloat16, device=dev)
        logits, cache = prefill(params, batch)
        # move the prefill cache into a max-length decode cache
        cache = graft(init_cache(cfg, B, S + max_new + n_patches,
                                 device=dev), cache)
        tok = greedy_sample(logits)[:, None]
        out = [tok]
        for i in range(max_new - 1):
            logits, cache = decode(params, cache, tok, S + n_patches + i)
            tok = greedy_sample(logits[:, 0])[:, None]
            out.append(tok)
        return torch.cat(out, dim=1).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).reduced()
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)
    t0 = time.time()
    toks = serve_batch(args.arch, prompts, max_new=args.max_new,
                       device=args.device)
    dt = time.time() - t0
    print(f"generated {toks.shape} in {dt:.1f}s on "
          f"{resolve_device(args.device)} ({toks.size / dt:.1f} tok/s)")
    print(toks)


if __name__ == "__main__":
    main()
