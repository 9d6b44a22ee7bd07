"""The JAX package's sharded training step on a (1, 4) ('data', 'model')
mesh, for ``test_torch_tp.py``. Run in its own interpreter with 4 XLA CPU
devices (``main`` sets ``XLA_FLAGS`` before it imports JAX; importing this
module sets nothing):

    python torch_tp_ref.py OUT.pkl

For llama3.2-1b and moonshot-v1-16b-a3b at 2 layers (vocab 128), it draws
the reference's params, jits its ``make_train_step`` (f32 compute, the
rank tests' optimizer) and runs three steps of ``torch_mesh_ranks``'s
batches under ``use_rules(Rules(mesh, "train"))``, so every ``constrain``
of the models places its activation on the mesh (GSPMD inserts the
collectives). Writes a pickle of the params (numpy), the batches and the
three losses, by arch.
"""
import os
import pickle
import sys

ARCHS = ("llama3.2-1b", "moonshot-v1-16b-a3b")


def main(out):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.dist.sharding import Rules, use_rules
    from repro.models import init_params
    from repro.train import OptConfig, adamw_init, make_train_step
    from torch_mesh_ranks import BATCH, OPT, batches

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    res = {"params": {}, "batches": {}, "losses": {}}
    for arch in ARCHS:
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
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
