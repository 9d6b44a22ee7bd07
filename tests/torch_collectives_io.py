"""Both sides of ``test_torch_collectives.py``'s four-rank parity.

    python torch_collectives_io.py INPUTS.npz OUT.pkl

runs the JAX package's ``compressed_psum`` under ``shard_map`` on 4 XLA CPU
devices (it sets ``XLA_FLAGS`` before JAX starts), rank r's inputs being
row r of ``x`` and ``err``, and dumps each rank's (sum, new error) and the
``devices_indices_map`` of the placement cases (``torch_sharding_ref.
PLACEMENTS``) on 2 x 2 meshes. :func:`four_ranks` is what each of the
port's four gloo ranks runs (``torch_ranks.run_ranks``) on the same
inputs.
"""
import os
import pickle
import sys

import numpy as np

from torch_sharding_ref import PLACEMENTS


def inputs(seed: int = 0, n: int = 1000):
    """Seeded x and err, (4, n) f32: rank 2's values 100x the others',
    the largest |x + err| 1000 (rank 2, element 0), and rank 0's first
    elements (err 0 there) at exactly .5 of a quantization step."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, n)).astype(np.float32)
    err = (rng.standard_normal((4, n)) * 0.01).astype(np.float32)
    x[2] *= 100
    x[2, 0], err[2, 0] = 1000.0, 0.0
    s = np.float32(1000.0)
    halves = []
    for k in range(-40, 40):
        v = np.float32((k + 0.5) * 1000.0 / 127.0)
        if np.float32(v / s) * np.float32(127.0) == np.float32(k + 0.5):
            halves.append(v)
    x[0, :len(halves)] = halves
    err[0, :len(halves)] = 0.0
    return x, err, len(halves)


def four_ranks(rank, world, path):
    """The port on this rank's row: compressed_psum over the default
    group and over a (mesh, dim) pair, and each placement case's local
    slice of a DTensor built by ``distribute``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.collectives import (compressed_psum,
                                              compressed_tree_psum)
    from repro_torch.dist.sharding import P, NamedSharding, distribute
    d = np.load(path)
    x, e = torch.from_numpy(d["x"][rank]), torch.from_numpy(d["err"][rank])
    total, new_err = compressed_psum(x, e, None)
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    tree, errs = compressed_tree_psum({"a": [x]}, {"a": [e]}, (mesh, "pod"))
    slices, whole = [], []
    for axes, entries, shape in PLACEMENTS:
        m = init_device_mesh("cpu", (2, 2), mesh_dim_names=axes)
        full = torch.arange(int(np.prod(shape)),
                            dtype=torch.float32).reshape(shape)
        dt = distribute(full, NamedSharding(m, P(*entries)))
        sl = NamedSharding(m, P(*entries)).local_slices(shape)
        slices.append(tuple((s.start, s.stop) for s in sl))
        whole.append(torch.equal(dt.full_tensor(), full)
                     and torch.equal(dt.to_local(), full[sl]))
    return {"sum": total.numpy(), "err": new_err.numpy(),
            "tree_sum": tree["a"][0].numpy(), "tree_err": errs["a"][0].numpy(),
            "slices": slices, "whole": whole}


def reference(path, out):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as Ps

    from repro.dist.collectives import compressed_psum
    d = np.load(path)
    mesh = Mesh(np.array(jax.devices()[:4]), ("pod",))

    def body(a, e):
        total, new_err = compressed_psum(a.reshape(a.shape[1:]),
                                         e.reshape(e.shape[1:]), "pod")
        return total[None], new_err[None]
    f = shard_map(body, mesh=mesh, in_specs=(Ps("pod"), Ps("pod")),
                  out_specs=(Ps("pod"), Ps("pod")))
    total, new_err = f(d["x"], d["err"])
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    slices = []
    for axes, entries, shape in PLACEMENTS:
        where = NamedSharding(Mesh(devs, axes), Ps(*entries)) \
            .devices_indices_map(shape)
        slices.append([tuple(sl.indices(n)[:2] for sl, n in
                             zip(where[dv], shape)) for dv in devs.flat])
    with open(out, "wb") as f:
        pickle.dump({"sum": np.asarray(total), "err": np.asarray(new_err),
                     "slices": slices}, f)


if __name__ == "__main__":
    reference(sys.argv[1], sys.argv[2])
