"""The JAX package's sharded serving on a (2, 2) ('data', 'model') mesh of 4
XLA CPU devices, for ``test_torch_serve_mesh.py``. Run in its own
interpreter (``main`` sets ``XLA_FLAGS`` before it imports JAX; importing
this module imports numpy alone, so the gloo ranks take their prompts and
sizes from here):

    python torch_serve_ref.py OUT.pkl

For each of ``ARCHS`` at 2 layers (vocab 128, f32), it draws the
reference's params, jits its ``make_prefill_step`` under
``use_rules(Rules(mesh, "prefill"))`` and its ``make_decode_step`` under
``use_rules(Rules(mesh, "decode"))`` (every ``constrain`` of the models
places its activation on the mesh, the caches over ``cache_seq``; GSPMD
inserts the collectives), and serves ``prompts(cfg, SEQ)`` as the
reference's ``serve_batch`` does (the prefill cache padded into the
longer decode cache, greedy tokens). Writes a pickle of the logits (the
prefill's, then each decode step's) and the tokens, by arch.
"""
import os
import pickle
import sys

import numpy as np

ARCHS = ("llama3.2-1b", "rwkv6-1.6b", "zamba2-1.2b")
BATCH = 4
# (prompt tokens, new tokens) by mesh shape: prompts that 'model' does and
# does not divide, decode caches that it does and does not
MESHES = {(1, 2): (22, 9), (1, 4): (23, 9), (2, 2): (20, 10)}


def prompts(vocab: int, seq: int, batch: int = BATCH) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, (batch, seq),
                                             dtype=np.int32)


def main(out):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.dist.sharding import Rules, use_rules
    from repro.models import init_cache, init_params
    from repro.serve import (greedy_sample, make_decode_step,
                             make_prefill_step)

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    seq, new = MESHES[(2, 2)]
    res = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced(n_layers=2, vocab_size=128)
        params = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
        batch = {"tokens": jnp.asarray(prompts(cfg.vocab_size, seq))}
        with mesh, use_rules(Rules(mesh, "prefill", global_batch=BATCH)):
            logits, cache = jax.jit(make_prefill_step(cfg, jnp.float32))(
                params, batch)
        full = init_cache(cfg, BATCH, seq + new, jnp.float32)

        def graft(dst, src):
            if dst.ndim >= 4 and dst.shape[-3] >= src.shape[-3] \
                    and dst.shape[:-3] == src.shape[:-3]:
                return jnp.pad(src.astype(dst.dtype),
                               [(0, d - s) for d, s in zip(dst.shape,
                                                           src.shape)])
            return src.astype(dst.dtype)
        cache = jax.tree.map(graft, full, cache)
        got = [np.asarray(logits)]
        tok = greedy_sample(logits)[:, None]
        toks = [np.asarray(tok)]
        with mesh, use_rules(Rules(mesh, "decode", global_batch=BATCH)):
            decode = jax.jit(make_decode_step(cfg, jnp.float32))
            for i in range(new - 1):
                logits, cache = decode(params, cache, tok,
                                       jnp.int32(seq + i))
                got.append(np.asarray(logits[:, 0]))
                tok = greedy_sample(logits[:, 0])[:, None]
                toks.append(np.asarray(tok))
        res[arch] = {"logits": got, "tokens": np.concatenate(toks, 1)}
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
