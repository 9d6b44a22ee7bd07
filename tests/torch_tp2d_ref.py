"""The JAX package's sharded training and serving on a (1, 2, 2) ('data',
'model', 'model2') mesh of 4 XLA CPU devices (the tp2d layout at test
size), for ``test_torch_tp2d.py``. Run in its own interpreter (``main``
sets ``XLA_FLAGS`` before it imports JAX):

    python torch_tp2d_ref.py OUT.pkl

  * training: for ``torch_tp_ref.ARCHS`` at 2 layers (vocab 128), the
    reference's params and ``make_train_step`` (f32) jitted under
    ``use_rules(Rules(mesh, "train"))``, three steps of
    ``torch_mesh_ranks``'s batches;
  * serving: for ``torch_serve_ref.ARCHS``, ``make_prefill_step`` and
    ``make_decode_step`` jitted under the "prefill" and "decode" rules,
    ``torch_tp2d_ranks``' prompt and new-token counts, greedy tokens, as
    ``torch_serve_ref.py`` serves on (2, 2);
  * R13: ``tp_size()`` and ``attn_shard_choice`` under these rules (KV
    2, G 1) and under a (16, 8, 2) shape-only mesh's (llama4-scout's
    heads, KV 8, G 5), against the same call under rules on a mesh of the
    'model' axis alone, (1, 2) and (16, 8).

Writes a pickle: params (numpy), batches and losses by arch; serving
logits (the prefill's, then each decode step's) and tokens by arch; the
R13 values.
"""
import os
import pickle
import sys

SHAPE = (1, 2, 2)
AXES = ("data", "model", "model2")


class FakeMesh:
    """A shape-only mesh, as the reference's tests build one."""
    def __init__(self, shape, axes):
        import numpy as np
        self.axis_names = axes
        self.devices = np.zeros(shape)


def main(out):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.dist.sharding import (Rules, attn_shard_choice, tp_size,
                                     use_rules)
    from repro.models import init_cache, init_params
    from repro.serve import greedy_sample, make_decode_step, \
        make_prefill_step
    from repro.train import OptConfig, adamw_init, make_train_step
    from torch_mesh_ranks import BATCH, OPT, batches
    from torch_serve_ref import ARCHS as SERVE_ARCHS
    from torch_serve_ref import BATCH as SERVE_BATCH
    from torch_serve_ref import prompts
    from torch_tp_ref import ARCHS as TRAIN_ARCHS
    from torch_tp2d_ranks import NEW, PROMPT

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(SHAPE), AXES)
    res = {"params": {}, "batches": {}, "losses": {}, "serve": {}}
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch).reduced(n_layers=2, vocab_size=128)
        params = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
        bs = batches(cfg)
        res["params"][arch] = jax.tree.map(np.asarray, params)
        res["batches"][arch] = bs
        opt = OptConfig(lr=OPT.lr, warmup_steps=OPT.warmup_steps)
        with mesh, use_rules(Rules(mesh, "train", global_batch=BATCH)):
            step = jax.jit(make_train_step(cfg, opt, jnp.float32))
            state, losses = adamw_init(params), []
            for b in bs:
                params, state, m = step(params, state, b)
                losses.append(float(m["loss"]))
        res["losses"][arch] = losses

    for arch in SERVE_ARCHS:
        cfg = get_config(arch).reduced(n_layers=2, vocab_size=128)
        params = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
        batch = {"tokens": jnp.asarray(prompts(cfg.vocab_size, PROMPT))}
        with mesh, use_rules(Rules(mesh, "prefill",
                                   global_batch=SERVE_BATCH)):
            logits, cache = jax.jit(make_prefill_step(cfg, jnp.float32))(
                params, batch)
        full = init_cache(cfg, SERVE_BATCH, PROMPT + NEW, jnp.float32)

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
        with mesh, use_rules(Rules(mesh, "decode",
                                   global_batch=SERVE_BATCH)):
            decode = jax.jit(make_decode_step(cfg, jnp.float32))
            for i in range(NEW - 1):
                logits, cache = decode(params, cache, tok,
                                       jnp.int32(PROMPT + i))
                got.append(np.asarray(logits[:, 0]))
                tok = greedy_sample(logits[:, 0])[:, None]
                toks.append(np.asarray(tok))
        res["serve"][arch] = {"logits": got,
                              "tokens": np.concatenate(toks, 1)}

    # R13: the attention layout reads tp_size(), the product of the model
    # axes, and not the 'model' axis alone (the same heads under rules on
    # a mesh of that axis alone)
    def r13(mesh_, model_only, kv, g, q):
        with use_rules(Rules(mesh_, "train")):
            n, choice = tp_size(), attn_shard_choice(kv, g, q)
        with use_rules(Rules(model_only, "train")):
            alone = attn_shard_choice(kv, g, q)
        return {"tp_size": n, "choice": choice, "choice_model_only": alone}
    res["r13_test_mesh"] = r13(mesh, FakeMesh((1, 2), AXES[:2]), 2, 1, 32)
    res["r13_production"] = r13(FakeMesh((16, 8, 2), AXES),
                                FakeMesh((16, 8), AXES[:2]), 8, 5, 4096)
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
