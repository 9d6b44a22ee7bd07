"""Device meshes of the port, as the reference's ``repro/launch/mesh.py``:
the production mesh's shapes and axis names, built with
``init_device_mesh`` over the process group that is already initialised
(NCCL ranks give a ``cuda`` mesh, gloo ranks a ``cpu`` one).

Functions, not module-level constants, so importing never touches the
process group. :func:`placeholder_mesh` builds a mesh of any size in one
process over a fake process group: it is for specs, shape-only planning and
tests, and never for training.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise one (NCCL on "
                           "cuda, gloo on cpu) before building a mesh")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: Sequence[int], axes: Sequence[str],
          device_type: Optional[str] = None):
    from torch.distributed.device_mesh import init_device_mesh
    device_type = device_type or _device_type()
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} "
                         f"ranks; the process group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_tp2d_mesh(*, multi_pod: bool = False,
                   shape: Optional[Sequence[int]] = None):
    """Same ranks, 'model' axis factored (8, 2) into ('model', 'model2'),
    the reference's §Perf L3 layout for archs whose head counts cannot
    carry a 16-way axis (llama4: H=40, KV=8). The weights are stored over
    'model' alone (8-way), and the compute is tensor-parallel over the
    flattened ('model', 'model2') group (16-way) everywhere, attention
    included: every rule that names the model axes (``act_model``,
    ``vocab``, ``cache_seq``, ``res_seq``) names both, so attention takes
    its layout at 16 ranks (llama4: "q", its query positions split, where
    the reference's docstring says 8-way heads). ``shape`` gives the same
    axes at another size, (data, model, model2) or with 'pod' first (a
    test's gloo ranks, one card)."""
    axes = (("pod", "data", "model", "model2") if multi_pod
            else ("data", "model", "model2"))
    if shape is None:
        shape = (2, 16, 8, 2) if multi_pod else (16, 8, 2)
    return _mesh(shape, axes)


def make_local_mesh():
    """Every rank of the process group, as a (1, N) ('data', 'model')
    mesh: the training step splits its compute over the N ranks of
    'model' (tensor-parallel), each rank computing its share of the same
    rows."""
    return _mesh((1, dist.get_world_size()), ("data", "model"))


def make_data_mesh():
    """Every rank of the process group on 'data', as an (N, 1) ('data',
    'model') mesh: data parallelism, each rank its own rows. The training
    launcher takes this mesh below the production sizes."""
    return _mesh((dist.get_world_size(), 1), ("data", "model"))


def placeholder_mesh(shape: Sequence[int], axes: Sequence[str],
                     rank: int = 0):
    """A ``cpu`` mesh of ``prod(shape)`` ranks in this process, seen from
    ``rank``, over a fake process group that moves no data. It replaces an
    earlier fake group; it refuses to replace a real one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised: a "
                               "placeholder mesh would replace it")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    return _mesh(shape, axes, "cpu")
