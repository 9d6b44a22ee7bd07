"""The JAX package's specs and placements, dumped for
``test_torch_sharding.py``. Run in its own interpreter with 256 XLA CPU
devices (``main`` sets ``XLA_FLAGS`` before it imports JAX; importing
this module sets nothing):

    python torch_sharding_ref.py OUT.pkl

Writes a pickle of
  * ``cells``: for every runnable (arch x shape) cell on the single-pod
    production mesh (16, 16), the reference's ``state_specs``,
    ``batch_specs``, ``cache_specs`` and ``decode_inputs`` as the dry-run
    calls them: each stand-in's (shape, dtype) and each sharding's spec,
    keyed by path;
  * ``slices``: ``NamedSharding(mesh, spec).devices_indices_map(shape)``
    for the placement cases (``PLACEMENTS``) on 2 x 2 meshes, as each
    rank's (start, stop) per dim, ranks in mesh order.
"""
import os
import pickle
import sys

# (mesh axes, spec entries, shape); the meshes are 2 x 2
PLACEMENTS = [
    (("data", "model"), ("data", None), (8, 6)),
    (("data", "model"), (None, "model"), (8, 6)),
    (("data", "model"), ("data", "model"), (8, 6)),
    (("data", "model"), ("model", "data"), (8, 6)),
    (("data", "model"), (None, "data", "model"), (3, 4, 6)),
    (("data", "model"), (), (8, 6)),
    (("data", "model"), ("model", None), (6, 5)),
    (("pod", "data"), (("pod", "data"), None), (8, 6)),
    (("pod", "data"), (None, ("pod", "data")), (5, 8)),
    (("pod", "data"), ("data", "pod"), (4, 6)),
    (("pod", "data"), (("pod", "data"),), (12,)),
]


def rules_kind(shape) -> str:
    """The dry-run's kind of rules for a shape (``dryrun.rules_kind``)."""
    if shape.kind == "train":
        return "train"
    if shape.name.startswith("long"):
        return "long"
    return shape.kind


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def main(out):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import ARCH_IDS, SHAPES, cell_is_runnable, get_config
    from repro.dist.sharding import Rules
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import (batch_specs, cache_specs, decode_inputs,
                                    state_specs)

    def structs(tree):
        return {_key(p): (tuple(x.shape), str(x.dtype)) for p, x in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    def specs(tree):
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
        return {_key(p): tuple(s.spec) for p, s in flat}

    mesh = make_production_mesh()
    cells = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if not cell_is_runnable(cfg, shape)[0]:
                continue
            rules = Rules(mesh, rules_kind(shape), "tp",
                          global_batch=shape.global_batch)
            cell = {}
            dtype = jnp.float32 if shape.kind == "train" else jnp.bfloat16
            params, pshard, opt, oshard = state_specs(cfg, rules, dtype)
            cell["params"], cell["pshard"] = structs(params), specs(pshard)
            cell["opt"], cell["oshard"] = structs(opt), specs(oshard)
            if shape.kind in ("train", "prefill"):
                batch, bshard = batch_specs(cfg, shape, rules, shape.kind)
                cell["batch"], cell["bshard"] = structs(batch), specs(bshard)
            if shape.kind != "train":
                cache, cshard = cache_specs(cfg, shape, rules)
                cell["cache"], cell["cshard"] = structs(cache), specs(cshard)
            if shape.kind == "decode":
                (tok, tsh), (pos, psh) = decode_inputs(cfg, shape, rules)
                cell["decode"] = (structs(tok), tuple(tsh.spec),
                                  structs(pos), tuple(psh.spec))
            cells[arch, shape.name] = cell

    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    slices = []
    for axes, entries, shape in PLACEMENTS:
        m = Mesh(devs, axes)
        where = NamedSharding(m, P(*entries)).devices_indices_map(shape)
        slices.append([tuple(sl.indices(n)[:2] for sl, n in
                             zip(where[d], shape)) for d in devs.flat])
    with open(out, "wb") as f:
        pickle.dump({"cells": cells, "slices": slices}, f)


if __name__ == "__main__":
    main(sys.argv[1])
