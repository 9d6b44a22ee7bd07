"""Serving entry point: batched prefill + greedy decode loop with KV/SSM
caches (``repro/launch/serve.py``), on ``cuda`` unless the caller asks for
the CPU; on a ``DeviceMesh`` when launched on several ranks.

    python -m repro_torch.launch.serve --arch rwkv6-1.6b --device cpu
    python -m repro_torch.launch.serve --arch whisper-small --device cpu
    python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.serve --arch llama3.2-1b --device cpu

Several ranks (``WORLD_SIZE`` > 1, as ``torch.distributed.run`` sets it)
join a process group (NCCL on ``cuda:LOCAL_RANK``, gloo for ``--device
cpu``) and serve on a (1, N) mesh, every rank on 'model': the weights
split over the ranks, each prefill and decode step tensor-parallel, the
KV cache's sequence split over them (``--long``: the reference's "long"
rules); rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import tree as tree_util
from ..configs import get_config
from ..device import resolve_device
from ..models import init_cache, init_params
from ..serve import (greedy_sample, make_decode_step, make_prefill_step,
                     shard_serve_state, zero_cache)


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


def graft_mesh(dst, src, rules):
    """:func:`graft` of DTensor caches placed as ``cache_specs`` says under
    ``rules``: a KV cache's sequence is redistributed from the prefill's
    slices to the decode cache's (``dist.sharding.reslice_seq``: the
    ranks' slices of S and of the longer decode length differ), zero past
    the prompt; a recurrent state, or a KV cache the decode cache is no
    longer than, is kept as it is. Values are cast to the decode cache's
    dtype."""
    from ..dist.sharding import (cache_seq_group, from_local, reslice_seq,
                                 use_rules)
    if isinstance(dst, dict):
        return {k: graft_mesh(dst[k], src[k], rules) for k in dst}
    if dst.dim() >= 4 and dst.dim() == src.dim() \
            and dst.shape[-3] > src.shape[-3] \
            and dst.shape[:-3] == src.shape[:-3]:
        n_src, n_dst = src.shape[-3], dst.shape[-3]
        with use_rules(rules):
            local = reslice_seq(src.to_local(), src.dim() - 3, n_src, n_dst,
                                cache_seq_group(n_src),
                                cache_seq_group(n_dst))
        return from_local(local.to(dst.dtype), dst.device_mesh,
                          dst.placements, dst.shape)
    if dst.dtype == src.dtype:
        return src
    return from_local(src.to_local().to(dst.dtype), src.device_mesh,
                      src.placements, src.shape)


def serve_batch(arch: str, prompts: np.ndarray, max_new: int = 16,
                reduced: bool = True, seed: int = 0, *, params=None,
                device=None, mesh=None, long: bool = False,
                compute_dtype=torch.bfloat16) -> np.ndarray:
    """prompts: (B, S) integer tokens. Returns (B, max_new) int32 generated
    tokens. Weights are drawn from a CPU ``torch.Generator`` seeded
    ``seed`` in bf16, unless ``params`` (e.g. the reference's, through
    ``repro_torch.convert.from_jax``) are given; ``device`` ``None`` means
    ``cuda``. As in the reference, an encoder config gets zero frame
    embeddings (B, enc_seq, D) and a vlm config zero patch embeddings (B,
    n_patches, D), ahead of the prompt: its decode starts at S +
    n_patches. ``compute_dtype`` is the steps' and the decode cache's.

    With ``mesh`` (a ``DeviceMesh`` over a process group the caller owns;
    every rank passes the same ``prompts``) it serves on the mesh steps
    under the "prefill" and "decode" rules (``long``: "long" for both):
    ``params`` (drawn on the host when None) are placed by
    ``shard_serve_state``, and every rank returns every row's tokens."""
    if mesh is not None:
        return _serve_mesh(arch, prompts, max_new, reduced, seed, params,
                           mesh, long, compute_dtype)
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed),
                             torch.bfloat16, dev)
    B, S = prompts.shape
    prefill = make_prefill_step(cfg, compute_dtype)
    decode = make_decode_step(cfg, compute_dtype)
    with torch.inference_mode():
        batch, n_patches = _batch(cfg, prompts, dev)
        logits, cache = prefill(params, batch)
        # move the prefill cache into a max-length decode cache
        cache = graft(init_cache(cfg, B, S + max_new + n_patches,
                                 compute_dtype, device=dev), cache)
        tok = greedy_sample(logits)[:, None]
        out = [tok]
        for i in range(max_new - 1):
            logits, cache = decode(params, cache, tok, S + n_patches + i)
            tok = greedy_sample(logits[:, 0])[:, None]
            out.append(tok)
        return torch.cat(out, dim=1).cpu().numpy()


def _batch(cfg, prompts, dev):
    """The prefill batch of ``prompts`` on ``dev``, with the reference's
    zero frames or patches; and the number of patches."""
    B = prompts.shape[0]
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
    return batch, n_patches


def _serve_mesh(arch, prompts, max_new, reduced, seed, params, mesh, long,
                compute_dtype):
    """:func:`serve_batch` on ``mesh``: the weights placed by
    ``shard_serve_state`` (unless they are DTensors already), the mesh
    steps, the decode cache placed as ``cache_specs`` says and grafted by
    :func:`graft_mesh`; every rank returns every row's tokens."""
    from torch.distributed.tensor import DTensor
    from ..dist.sharding import Rules, from_local, mesh_device
    dev = mesh_device(mesh)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    B, S = prompts.shape
    kind = "long" if long else "decode"
    rules = Rules(mesh, kind, global_batch=B)
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed),
                             torch.bfloat16, "cpu")
    if not isinstance(tree_util.leaves(params)[0], DTensor):
        params = shard_serve_state(params, mesh, rules, cfg)
    prefill = make_prefill_step(cfg, compute_dtype, mesh, long)
    decode = make_decode_step(cfg, compute_dtype, mesh, long)
    with torch.inference_mode():
        batch, n_patches = _batch(cfg, prompts, dev)
        logits, cache = prefill(params, batch)
        del prefill                         # and its compute copy
        cache = graft_mesh(zero_cache(cfg, B, S + max_new + n_patches, rules,
                                      compute_dtype), cache, rules)
        out = [greedy_sample(logits).to_local()[:, None]]
        for i in range(max_new - 1):
            tok = from_local(out[-1], mesh, _row_placements(logits),
                             (B, 1))
            logits, cache = decode(params, cache, tok, S + n_patches + i)
            out.append(greedy_sample(logits).to_local())
        toks = from_local(torch.cat(out, dim=1), mesh,
                          _row_placements(logits), (B, max_new))
        return toks.full_tensor().cpu().numpy()


def _row_placements(logits):
    """The placements of a tensor laid out as ``logits``' rows: its batch
    split kept, everything else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                 for pl in logits.placements)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--long", action="store_true",
                    help="on several ranks, the 'long' rules: the batch "
                         "replicated, the cache split over every rank")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).reduced()
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)
    from .train import dist_env, init_process_group
    env = dist_env()
    mesh, dev = None, resolve_device(args.device)
    if env["world"] > 1:
        from .mesh import make_local_mesh
        dev = init_process_group(env, args.device)
        mesh = make_local_mesh()
    try:
        lead = mesh is None or dist.get_rank() == 0
        if mesh is not None and lead:
            print(f"mesh {tuple(mesh.shape)} over "
                  f"{', '.join(mesh.mesh_dim_names)}: "
                  f"{dist.get_world_size()} ranks, {dist.get_backend()}",
                  flush=True)
        t0 = time.time()
        toks = serve_batch(args.arch, prompts, max_new=args.max_new,
                           device=args.device, mesh=mesh, long=args.long)
        dt = time.time() - t0
        if lead:
            print(f"generated {toks.shape} in {dt:.1f}s on {dev} "
                  f"({toks.size / dt:.1f} tok/s)")
            print(toks)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
