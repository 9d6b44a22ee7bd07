"""Sharding rules of the port, as the reference's ``repro/dist/sharding.py``:
logical activation axes -> mesh axes, and parameter placement on a
``torch.distributed.device_mesh.DeviceMesh``.

The names are the reference's. ``Rules`` maps logical names ("batch",
"act_model", "vocab", "cache_seq", ...) onto the axes of a mesh, and
``param_specs`` gives every parameter its spec: FSDP-style, matmul weights
shard their first core dim over 'data' and their last over 'model',
embeddings are vocab-sharded over 'model', norms and biases replicate. Every
assignment is divisibility-guarded: an axis that does not divide its dim is
dropped, never an error.

A spec is a :class:`P`, a tuple of per-dim entries (``None``, an axis name,
or a tuple of names, major to minor), equal to the tuple of the
reference's ``PartitionSpec`` entries. The rules read only axis names and
sizes, so they take a ``DeviceMesh`` or a shape-only :class:`MeshShape`:
the production mesh's specs come out without its 256 ranks.

:class:`NamedSharding` turns a spec into DTensor placements: for each mesh
dim, ``Shard(d)`` when tensor dim ``d`` names its axis, else
``Replicate()``. Several mesh dims sharding one tensor dim split it in mesh
order, the major one first, which is JAX's order for a tuple entry written
in mesh order (the only order ``Rules`` and ``param_specs`` write).

``constrain`` and its relatives are the identity outside ``use_rules``, as
in the reference. Under rules ``constrain`` redistributes a ``DTensor`` to
the guarded spec and returns a plain tensor unchanged: the port's models
compute on the whole gathered copy (``full_tensor`` of each cast leaf,
``train/train_step.py``), so they carry no ``constrain`` calls, and
``constrain_params_gathered``'s layout ('data' gathered, 'model' kept)
waits for tensor-parallel compute.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from contextlib import contextmanager
from typing import Any, Optional, Tuple

import torch

from .. import tree as tree_util

MODEL_AXES = ("model", "model2")

_ACTIVE = threading.local()


class P(tuple):
    """A partition spec: one entry per tensor dim, ``None``, an axis name
    or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A shape-only mesh: axis names and sizes, no ranks."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _mesh_sizes(mesh) -> dict:
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def _scalar(axes: Tuple[str, ...]):
    """() -> None, (a,) -> a, (a, b) -> (a, b): the PartitionSpec convention."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Rules:
    """Logical-axis -> mesh-axis map for one (mesh, kind, policy) cell.

    ``map`` is a plain dict (inspectable in tests); ``spec(*names)``
    resolves a sequence of logical names (or None) into a :class:`P`.
    """

    def __init__(self, mesh, kind: str = "train", policy: str = "tp",
                 global_batch: Optional[int] = None):
        self.mesh = mesh
        self.kind = kind
        self.policy = policy
        self.global_batch = global_batch
        sizes = _mesh_sizes(mesh)
        names = axis_names(mesh)
        data_axes = tuple(a for a in names if a not in MODEL_AXES)
        model_axes = tuple(a for a in names if a in MODEL_AXES)
        batch = _scalar(data_axes)
        if global_batch is not None and data_axes:
            n = 1
            for a in data_axes:
                n *= sizes[a]
            if global_batch % n:
                batch = None                      # not divisible: replicate
        model = _scalar(model_axes)
        self.map = {
            "batch": batch,
            "act_model": model,                   # TP axis for activations
            "vocab": model,                       # vocab-parallel head
            "embed": _scalar(data_axes),          # d_model of the lm head
            "cache_seq": model,                   # KV cache sequence dim
            "res_seq": model,                     # sequence-parallel residual
        }
        if kind == "long":
            # one enormous sequence: every chip holds a sequence slice
            self.map["batch"] = None
            self.map["cache_seq"] = _scalar(names)

    def spec(self, *names) -> P:
        return P(*[self.map.get(n) if n is not None else None for n in names])


@contextmanager
def use_rules(rules: Rules):
    """Activate ``rules`` for constrain()/tp_size() in this thread."""
    prev = getattr(_ACTIVE, "rules", None)
    _ACTIVE.rules = rules
    try:
        yield rules
    finally:
        _ACTIVE.rules = prev


def current_rules() -> Optional[Rules]:
    return getattr(_ACTIVE, "rules", None)


def tp_size() -> int:
    """Product of the model (TP) axes of the active mesh; 1 outside rules."""
    r = current_rules()
    if r is None:
        return 1
    sizes = _mesh_sizes(r.mesh)
    n = 1
    for a in axis_names(r.mesh):
        if a in MODEL_AXES:
            n *= sizes[a]
    return n


def _axis_n(sizes: dict, ax) -> int:
    n = 1
    for a in _axes(ax):
        n *= sizes.get(a, 1)
    return n


def _guard(spec, shape, mesh) -> P:
    """Drop every axis assignment that does not divide its dim."""
    sizes = _mesh_sizes(mesh)
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    return P(*[ax if (ax is not None and dim % _axis_n(sizes, ax) == 0)
               else None for dim, ax in zip(shape, padded)])


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------

def placements_for(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` when tensor dim ``d`` names the axis, else
    ``Replicate()``. A tuple entry must list its axes in mesh order (its
    first axis the major one, as JAX splits it)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    where = {}
    for d, entry in enumerate(spec):
        axs = _axes(entry)
        for a in axs:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, which the "
                                 f"mesh {names} lacks")
            if a in where:
                raise ValueError(f"axis {a!r} used twice in {spec}")
            where[a] = d
        if list(axs) != sorted(axs, key=names.index):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``. Unpacks as
    ``(mesh, placements)`` for ``torch.distributed.tensor``."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)

    def __iter__(self):
        return iter((self.mesh, self.placements))

    def local_slices(self, shape) -> Tuple[slice, ...]:
        """This rank's index of a tensor of global ``shape``."""
        return local_index(shape, self.mesh, self.placements)


def local_index(shape, mesh, placements) -> Tuple[slice, ...]:
    """This rank's index of a tensor of global ``shape`` placed by
    ``placements`` on ``mesh``. The mesh's coordinate is read as data, so
    under ``FakeTensorMode`` (a dry-run's fake weights on a real mesh) it
    is read outside the fake mode."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():
        size, off = compute_local_shape_and_global_offset(
            tuple(shape), mesh, placements)
    return tuple(slice(o, o + n) for o, n in zip(off, size))


def map_specs(fn, tree):
    """``fn`` at every :class:`P` (or :class:`NamedSharding`) of a tree,
    keeping its structure: a spec is a tuple, which ``repro_torch.tree``
    would walk into."""
    if tree is None:
        return None
    if isinstance(tree, (P, NamedSharding)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v) for v in tree)
    return fn(tree)


def from_local(local: torch.Tensor, mesh, placements, shape):
    """The ``DTensor`` of global ``shape`` (contiguous) whose shard on this
    rank is ``local``; no collective, no check."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=tuple(shape),
                              stride=_contiguous_stride(shape))


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: the current card for a ``cuda``
    mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """A ``DTensor`` of ``sharding`` built from the full tensor ``x`` that
    every rank holds, on any device: each rank copies its own slice to the
    mesh's device, with no collective, and keeps nothing of ``x`` (a host
    ``x`` puts only the slice on the card)."""
    local = x[sharding.local_slices(x.shape)].to(
        mesh_device(sharding.mesh), copy=True,
        memory_format=torch.contiguous_format)
    return from_local(local, sharding.mesh, sharding.placements, x.shape)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, n = [], 1
    for s in reversed(tuple(shape)):
        stride.append(n)
        n *= s
    return tuple(reversed(stride))


def full(x):
    """The whole tensor of a ``DTensor`` (a collective), else ``x``."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


# ---------------------------------------------------------------------------
# constraints
# ---------------------------------------------------------------------------

def constrain(x, *names):
    """Under the active rules, a ``DTensor`` redistributed to the guarded
    spec of ``names``; anything else unchanged (the identity without
    rules)."""
    r = current_rules()
    if r is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = _guard(r.spec(*names), x.shape, r.mesh)
    return x.redistribute(r.mesh, placements_for(spec, r.mesh))


def constrain_residual(x):
    """Residual stream (B, S, D): batch + sequence-parallel over TP axis."""
    return constrain(x, "batch", "res_seq", None)


def _drop_data(spec) -> P:
    out = []
    for ax in spec:
        out.append(_scalar(tuple(a for a in _axes(ax) if a in MODEL_AXES)))
    return P(*out)


def constrain_params_gathered(params):
    """The param tree (a cast copy) with its FSDP ('data') axes gathered
    and its TP axes kept, so the gather runs once a step and not once a
    microbatch (the reference's §Perf G3b). Leaves that are not DTensors
    pass through; the identity outside rules."""
    r = current_rules()
    if r is None:
        return params
    from torch.distributed.tensor import DTensor

    def apply(path, w):
        if not isinstance(w, DTensor) or w.dim() < 1:
            return w
        parts = [str(p) for p in path]
        spec = param_spec_for("/".join(parts), w.dim(), "layers" in parts)
        s = _guard(_drop_data(spec), w.shape, r.mesh)
        return w.redistribute(r.mesh, placements_for(s, r.mesh))

    return tree_util.map_with_paths(apply, params)


def batch_axes(rules: Rules) -> Tuple[str, ...]:
    """The mesh axes the rules split the batch over (none when it is
    replicated)."""
    return _axes(rules.map["batch"])


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """A per-rank mean over this rank's batch rows, made the mean over the
    global batch: averaged over the ranks that split the batch under the
    active rules (equal rows each). Its value is the global mean; its
    gradient reaches this rank's ``x`` scaled by 1/ranks, so gradients
    summed over those ranks are the global mean's. The identity outside
    rules, on a shape-only mesh and when the batch is not split. This is
    what the reference's SPMD batch means compute with no code (moe's
    load-balance statistics)."""
    r = current_rules()
    if r is None or not hasattr(r.mesh, "get_group"):
        return x
    axes = batch_axes(r)
    sizes = _mesh_sizes(r.mesh)
    n = math.prod(sizes[a] for a in axes)
    if n == 1:
        return x
    import torch.distributed as dist
    total = x.detach().clone()
    for a in axes:
        dist.all_reduce(total, group=r.mesh.get_group(a))
    return total / n + (x - x.detach()) / n


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_shard_choice(KV: int, G: int, q_len: int) -> Optional[str]:
    """Which attention dim should carry the TP axis for a (KV, G) head split.

    Returns None when tp = a*b factors with a | KV and b | G (a sharded
    layout needs no choice then). Otherwise pick the first dim the TP size
    divides: query positions ("q"), kv heads ("kv"), or the GQA group dim
    ("g"); None if nothing fits (replicate)."""
    tp = tp_size()
    if tp <= 1:
        return None
    if any(tp % a == 0 and KV % a == 0 and G % (tp // a) == 0
           for a in range(1, tp + 1)):
        return None
    if q_len % tp == 0:
        return "q"
    if KV % tp == 0:
        return "kv"
    if G % tp == 0:
        return "g"
    return None


# ---------------------------------------------------------------------------
# parameter placement
# ---------------------------------------------------------------------------

def param_spec_for(path: str, ndim: int, stacked: bool, shape=None,
                   mesh=None) -> P:
    """Spec for one param.

    ``stacked`` marks per-layer params whose leading dim is the layer dim
    (always replicated). Embedding tables ("embed" in the path) are
    vocab-sharded over 'model' with d_model over 'data'; other >=2D core
    weights shard (first core dim -> 'data', last -> 'model'); <=1D cores
    (norms, biases) replicate. With ``shape``+``mesh`` the assignment is
    divisibility-guarded."""
    core = ndim - 1 if stacked else ndim
    if core <= 1:
        spec = P(*([None] * ndim))
    else:
        if "embed" in path:
            axes = ["model"] + [None] * (core - 2) + ["data"]
        else:
            axes = ["data"] + [None] * (core - 2) + ["model"]
        if stacked:
            axes = [None] + axes
        spec = P(*axes)
    if shape is not None and mesh is not None:
        spec = _guard(spec, shape, mesh)
    return spec


def param_specs(params, mesh):
    """Spec tree matching ``params`` (divisibility-guarded). Paths are the
    reference's (``layers/attn/wqkv``); a leaf under ``layers`` is
    stacked."""
    def spec_for(path, leaf):
        parts = [str(p) for p in path]
        return param_spec_for("/".join(parts), len(leaf.shape),
                              "layers" in parts, tuple(leaf.shape), mesh)

    return tree_util.map_with_paths(spec_for, params)


def shardings_for(mesh, specs):
    """:class:`NamedSharding` tree from a spec tree."""
    return map_specs(lambda s: NamedSharding(mesh, s), specs)
