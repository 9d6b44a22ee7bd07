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
the guarded spec and returns a plain tensor unchanged.

Tensor-parallel compute (the second half of this module). The reference
constrains activations and lets GSPMD insert the collectives; the port's
models compute on plain tensors and issue them where the reference
constrains, each an ``autograd.Function`` with its backward, over the
'model' group of the active rules (:func:`tp_group`):

  * the ``res_seq`` residual: every stack keeps a sequence slice of (B, S,
    D) on each 'model' rank; :func:`gather_seq` (all-gather, backward
    reduce-scatter) enters a column-parallel block and :func:`scatter_seq`
    (reduce-scatter of partial sums, backward all-gather) leaves a
    row-parallel one;
  * :func:`gather_model` rebuilds a dim split over 'model' (a KV head
    split over more ranks than there are KV heads);
  * :func:`reduce_model` sums what every rank then uses alike (the
    vocab-parallel loss: backward the identity) and
    :func:`reduce_model_shared` what each rank uses on its own share (a
    norm over a split dim: backward an all-reduce).

On a tp2d mesh ('model' and a 'model2' larger than one, the rules mapping
``act_model``, ``vocab``, ``cache_seq`` and ``res_seq`` to the pair) the
compute splits over the flattened ('model', 'model2') group, 'model'
major, while the weights stay stored over 'model' alone
(:func:`param_specs`): a rank's compute slice of a leaf split on the dim
its storage splits is its 'model2' chunk of its 'model' shard, a narrow
(:func:`gather_for_compute`), and its gradient goes back by an
all-gather over 'model2' (:func:`grad_to_storage`). Everything else
takes the flat group wherever it took 'model'.

Serving (no backward) adds the ``cache_seq`` collectives, over the group
:func:`cache_seq_group` gives ('model', or the flat group on a tp2d mesh,
under the prefill and decode rules; the whole mesh under ``long``):
:func:`kv_heads_to_seq` moves a prefill's keys and values from the
rank's heads to its sequence slice of every KV head, :func:`combine`
joins a decode's partial softmax over the ranks' cache slices (its max,
then its sum and its P.V, all-reduced in f32), :func:`reslice_seq` moves a
cache's sequence slices to another length's (the prefill cache into the
longer decode cache), and :func:`leave_block` ends a row-parallel block:
a reduce-scatter to the sequence slice where the residual is
sequence-parallel, an all-reduce where it is whole (a decode step: one
token has no sequence to split).

``constrain_params_gathered(params, cfg)`` is the compute copy's layout
(:func:`compute_model_dims`): gathered over the data axes, and over 'model'
split column-parallel (the in-projections' output dim), row-parallel (the
out-projections' input dim), vocab-parallel (the embedding and the head)
or expert-parallel (the experts' dim), or else whole. A leaf used whole is
computed on a sequence slice, so its gradient is summed over 'model'; a
split leaf's gradient is whole for its split and is not.
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


def constrain_params_gathered(params, cfg=None, dtype=None):
    """The compute copy of a param tree of DTensors: each leaf gathered
    over the data axes, so the gather runs once a step and not once a
    microbatch (the reference's §Perf G3b), and over 'model' laid out as
    :func:`repro_torch.models.compute_model_dims` gives for ``cfg`` (split
    column-, row-, vocab- or expert-parallel, else whole). With ``dtype``
    each f32 leaf of more than one dim is cast to it on its shard first
    (the reference's cast of the compute copy). Returns plain tensors, one
    :func:`gather_for_compute` a leaf; leaves that are not DTensors pass
    through. The identity outside rules."""
    r = current_rules()
    if r is None:
        return params
    from torch.distributed.tensor import DTensor
    dims = compute_layout(params, cfg)

    def copy(path, w):
        if not isinstance(w, DTensor):
            return w
        cast = dtype if w.dtype == torch.float32 and w.dim() > 1 else None
        return gather_for_compute(w, tree_util.at(dims, path), cast)
    return tree_util.map_with_paths(copy, params)


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

def attn_shard_choice(KV: int, G: int, q_len: int,
                      tp: Optional[int] = None) -> Optional[str]:
    """Which attention dim should carry the TP axis for a (KV, G) head split.

    Returns None when tp = a*b factors with a | KV and b | G (a sharded
    layout needs no choice then). Otherwise pick the first dim the TP size
    divides: query positions ("q"), kv heads ("kv"), or the GQA group dim
    ("g"); None if nothing fits (replicate). ``tp`` defaults to the active
    rules' :func:`tp_size`.

    "kv" and "g" are never returned: KV % tp == 0 factors as (tp, 1) and
    G % tp == 0 as (1, tp), so both are caught by the first test (the
    reference's function is the same)."""
    tp = tp_size() if tp is None else tp
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


# ---------------------------------------------------------------------------
# tensor-parallel compute: the constraint sites as explicit collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPGroup:
    """One mesh axis's group (or several axes' as one) as this rank sees
    it: the process group, this rank's index in it and its size.
    :func:`tp_group` gives the tensor-parallel one."""
    group: Any
    rank: int
    size: int

    def bounds(self, n: int) -> Tuple[int, int]:
        """This rank's [start, stop) of a dim of ``n`` split over the
        group: ceil(n / size) a rank in rank order, so where the size does
        not divide ``n`` the last slice is shorter. A dim so short that a
        rank would get nothing raises."""
        c = -(-n // self.size)
        if (self.size - 1) * c >= n:
            raise ValueError(f"a dim of {n} split over {self.size} ranks "
                             f"would leave a rank empty")
        return min(self.rank * c, n), min((self.rank + 1) * c, n)


def _axis_group(mesh, i: int) -> TPGroup:
    return TPGroup(mesh.get_group(i), mesh.get_local_rank(i), mesh.size(i))


def _flat_process_group(mesh, axes: Tuple[str, ...]):
    """The process group of this rank's ranks over the mesh axes ``axes``
    flattened, the first axis major (``DeviceMesh._flatten``). Built at
    the first call, which every rank of the mesh makes at the same point
    (a collective), and kept by the mesh."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():          # the ranks are data
        return mesh[axes]._flatten().get_group()


def _flat_group(mesh, axes: Tuple[str, ...]) -> TPGroup:
    """The ranks that share this rank's coordinate on every mesh axis but
    ``axes`` (in mesh order), as one group ordered with the first of
    ``axes`` major: JAX's order for a spec entry naming them. Axes of one
    rank add nothing, and one axis gives its own group."""
    names = axis_names(mesh)
    axes = tuple(a for a in axes if mesh.size(names.index(a)) > 1) \
        or tuple(axes[:1])
    if len(axes) == 1:
        return _axis_group(mesh, names.index(axes[0]))
    coord = mesh.get_coordinate()
    rank, size = 0, 1
    for a in axes:
        i = names.index(a)
        rank, size = rank * mesh.size(i) + coord[i], size * mesh.size(i)
    return TPGroup(_flat_process_group(mesh, tuple(axes)), rank, size)


def _tp_axes(rules: Rules) -> Tuple[str, ...]:
    """The mesh axes the rules' compute is tensor-parallel over: 'model',
    or ('model', 'model2') on a tp2d mesh (a 'model2' larger than one),
    where ``act_model``, ``vocab`` and ``res_seq`` all map there; none
    where they map elsewhere."""
    sizes = _mesh_sizes(rules.mesh)
    maps = {tuple(a for a in _axes(rules.map.get(k))
                  if a == "model" or sizes.get(a, 1) > 1)
            for k in ("act_model", "vocab", "res_seq")}
    if len(maps) != 1:
        return ()
    axes = maps.pop()
    return axes if axes[:1] == ("model",) else ()


def tp_group() -> Optional[TPGroup]:
    """The tensor-parallel group of the active rules' mesh: its 'model'
    axis's, or on a tp2d mesh the flattened ('model', 'model2') group
    ('model' major), when the rules map ``act_model``, ``vocab`` and
    ``res_seq`` there (:func:`_tp_axes`); None outside rules, on a
    shape-only mesh and when they map elsewhere. A 'model2' of one adds
    nothing: the group is 'model''s."""
    r = current_rules()
    if r is None or not hasattr(r.mesh, "get_group"):
        return None
    axes = _tp_axes(r)
    return _flat_group(r.mesh, axes) if axes else None


def seq_axes(rules: Rules) -> Tuple[str, ...]:
    """The mesh axes the rules split the residual's sequence over when the
    compute is tensor-parallel (:func:`tp_group`'s), else none."""
    if not hasattr(rules.mesh, "get_group"):
        return ()
    return _tp_axes(rules)


def compute_layout(params, cfg):
    """The compute copy's layout under the active rules: per leaf the
    tensor dim split over the tensor-parallel group (``compute_model_dims``
    at the group's size: 16 on the tp2d production mesh), or None
    everywhere when the compute is not tensor-parallel."""
    from ..models import compute_model_dims
    tp = tp_group()
    if tp is None:
        return tree_util.tree_map(lambda _: None, params)
    return compute_model_dims(cfg, params, tp.size)


def _pad_to(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` zero-padded along ``dim`` to ``n`` (itself when as long)."""
    if x.shape[dim] == n:
        return x
    pad = list(x.shape)
    pad[dim] = n - x.shape[dim]
    return torch.cat([x, x.new_zeros(pad)], dim)


def _all_gather(x: torch.Tensor, dim: int, grp: TPGroup,
                n: int) -> torch.Tensor:
    """Every rank's slice of a dim of ``n`` split as :meth:`TPGroup.bounds`
    gives, along ``dim``: the whole dim, in rank order. The slices arrive
    stacked on a new leading dim and merge into ``dim``: a copy unless
    ``dim`` leads."""
    import torch.distributed as dist
    c = -(-n // grp.size)
    xs = _pad_to(x, dim, c).contiguous()     # a short (last) slice padded
    out = xs.new_empty((grp.size * xs.shape[0],) + xs.shape[1:])
    dist.all_gather_into_tensor(out, xs, group=grp.group)
    out = out.unflatten(0, (grp.size, xs.shape[0])).movedim(0, dim)
    out = out.flatten(dim, dim + 1)
    return out if n == out.shape[dim] else out.narrow(dim, 0, n)


def _reduce_scatter(x: torch.Tensor, dim: int,
                    grp: TPGroup) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's slice of ``dim`` of
    it (:meth:`TPGroup.bounds`). The ranks' slices move to a new leading
    dim first: a copy unless ``dim`` leads or the group is one rank."""
    import torch.distributed as dist
    n = x.shape[dim]
    c = -(-n // grp.size)
    xs = _pad_to(x, dim, c * grp.size).unflatten(dim, (grp.size, c))
    xs = xs.movedim(dim, 0).contiguous()
    out = xs.new_empty(xs.shape[1:])
    dist.reduce_scatter_tensor(out, xs.flatten(0, 1), group=grp.group)
    s0, s1 = grp.bounds(n)
    return out if s1 - s0 == c else out.narrow(dim, 0, s1 - s0)


def _all_reduce(x: torch.Tensor, grp: TPGroup, op=None) -> torch.Tensor:
    """The reduction (``op``, a sum by default) over the group of ``x``, in
    a new tensor."""
    import torch.distributed as dist
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=grp.group)
    return out


def _all_to_all(x: torch.Tensor, src: int, dst: int,
                grp: TPGroup) -> torch.Tensor:
    """``x``, this rank's even slice of tensor dim ``src``, re-split over
    the group on dim ``dst`` (``src`` whole): one all-to-all. Chunk j of
    ``dst`` goes to rank j from a new leading dim, and what comes back,
    rank j's slice of ``src``, merges into ``src``: a copy each way unless
    that dim leads or the group is one rank."""
    import torch.distributed as dist
    n = grp.size
    inp = x.unflatten(dst, (n, x.shape[dst] // n)).movedim(dst, 0)
    inp = inp.contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=grp.group)
    # out's dims are x's, one place on: rank j goes just before src
    return out.movedim(0, src).flatten(src, src + 1)


class _GatherSeq(torch.autograd.Function):
    """All-gather along a dim; backward reduce-scatter."""

    @staticmethod
    def forward(ctx, x, dim, grp, n):
        ctx.dim, ctx.grp = dim, grp
        return _all_gather(x, dim, grp, n)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.grp), None, None, None


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter of partial sums along a dim; backward all-gather."""

    @staticmethod
    def forward(ctx, x, dim, grp):
        ctx.dim, ctx.grp, ctx.n = dim, grp, x.shape[dim]
        return _reduce_scatter(x, dim, grp)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.grp, ctx.n), None, None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum); backward the identity, or an all-reduce when
    ``shared``."""

    @staticmethod
    def forward(ctx, x, grp, shared):
        ctx.grp, ctx.shared = grp, shared
        return _all_reduce(x, grp)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.grp) if ctx.shared else g), None, None


# The constraint sites. Each takes the group of :func:`tp_group` and is the
# identity (or the plain op) when it is None, so the model's blocks run one
# code path with and without tensor-parallel compute. Where autograd records
# nothing (serving) the collective is called without its Function.

def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def gather_seq(x: torch.Tensor, n: Optional[int], grp: Optional[TPGroup],
               dim: int = 1) -> torch.Tensor:
    """The whole sequence (``n`` long) of a ``res_seq`` residual, from
    this rank's slice: the entry of a column-parallel block. Its backward
    sums every rank's gradient and keeps this rank's slice. ``n`` None: the
    residual is whole on every rank (a decode step), and ``x`` is
    returned."""
    if grp is None or n is None:
        return x
    return _GatherSeq.apply(x, dim, grp, n) if _tracked(x) else \
        _all_gather(x, dim, grp, n)


def scatter_seq(x: torch.Tensor, grp: Optional[TPGroup],
                dim: int = 1) -> torch.Tensor:
    """This rank's sequence slice of the sum over the group of ``x``, the
    partial sums of a row-parallel block: its exit to the residual."""
    if grp is None:
        return x
    return _ScatterSeq.apply(x, dim, grp) if _tracked(x) else \
        _reduce_scatter(x, dim, grp)


def leave_block(x: torch.Tensor, n: Optional[int],
                grp: Optional[TPGroup]) -> torch.Tensor:
    """The exit of a row-parallel block: :func:`scatter_seq` where the
    residual is sequence-parallel (``n`` given), else the sum over the
    group whole on every rank (:func:`reduce_model`; a decode step)."""
    return scatter_seq(x, grp) if n is not None else reduce_model(x, grp)


def seq_slice(x: torch.Tensor, grp: Optional[TPGroup],
              dim: int = 1) -> torch.Tensor:
    """This rank's sequence slice of ``x``, which every rank holds alike
    (no collective)."""
    if grp is None:
        return x
    s0, s1 = grp.bounds(x.shape[dim])
    return x.narrow(dim, s0, s1 - s0)


def gather_model(x: torch.Tensor, grp: Optional[TPGroup],
                 dim: int = -1) -> torch.Tensor:
    """A dim split evenly over the group, whole (all-gather; backward
    reduce-scatter)."""
    if grp is None:
        return x
    dim = dim % x.dim()
    n = x.shape[dim] * grp.size
    return _GatherSeq.apply(x, dim, grp, n) if _tracked(x) else \
        _all_gather(x, dim, grp, n)


def gather_parts(parts, grp: TPGroup):
    """Each tensor of ``parts``, split evenly over the group on its last
    dim (a column-parallel projection's q, k and v), whole, in rank order:
    one all-gather of their concatenation (no gradient)."""
    widths = [t.shape[-1] for t in parts]
    cat = torch.cat(parts, -1)
    whole = _all_gather(cat, cat.dim() - 1, grp, cat.shape[-1] * grp.size)
    whole = whole.unflatten(-1, (grp.size, sum(widths)))
    return [t.flatten(-2) for t in torch.split(whole, widths, -1)]


def reduce_model(x: torch.Tensor, grp: Optional[TPGroup]) -> torch.Tensor:
    """The sum over the group of the ranks' ``x``, which every rank then
    uses alike (the loss's sums): backward the identity, so each rank's
    ``x`` gets the gradient of its own share."""
    if grp is None:
        return x
    return _Reduce.apply(x, grp, False) if _tracked(x) else \
        _all_reduce(x, grp)


def reduce_model_shared(x: torch.Tensor,
                        grp: Optional[TPGroup]) -> torch.Tensor:
    """The sum over the group of the ranks' ``x``, which each rank then
    uses on its own share of a split dim (a norm's moment): backward an
    all-reduce."""
    if grp is None:
        return x
    return _Reduce.apply(x, grp, True) if _tracked(x) else \
        _all_reduce(x, grp)


class _LogsumexpVocab(torch.autograd.Function):
    """logsumexp over a last dim split over the group: each rank's
    ``torch.logsumexp`` of its share, then the logsumexp of those across
    the ranks (on one rank the first alone, bit for bit); the backward is
    ``torch.logsumexp``'s, exp(x - result), on this rank's share."""

    @staticmethod
    def forward(ctx, x, grp):
        import torch.distributed as dist
        part = torch.logsumexp(x, dim=-1)
        m = _all_reduce(part, grp, dist.ReduceOp.MAX)
        out = m + torch.log(_all_reduce(torch.exp(part - m), grp))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g[..., None] * torch.exp(x - out[..., None]), None


def logsumexp_vocab(x: torch.Tensor,
                    grp: Optional[TPGroup]) -> torch.Tensor:
    """``torch.logsumexp(x, -1)`` of logits whose vocabulary (last dim) is
    split over the group, alike on every rank (the loss then taken from it
    is every rank's): each rank's gradient is its share's softmax."""
    if grp is None:
        return torch.logsumexp(x, dim=-1)
    return _LogsumexpVocab.apply(x, grp)


def argmax_vocab(x: torch.Tensor, v0: int,
                 grp: Optional[TPGroup]) -> torch.Tensor:
    """``torch.argmax(x, -1)`` over a last dim split over the group (this
    rank's share starts at global index ``v0``): the lowest global index
    of the row's largest value, as the argmax over the whole row picks it,
    alike on every rank (no gradient)."""
    import torch.distributed as dist
    top = x.detach().argmax(-1)
    if grp is None:
        return top + v0
    best = torch.gather(x.detach(), -1, top[..., None])[..., 0]
    cand = torch.where(best == _all_reduce(best, grp, dist.ReduceOp.MAX),
                       top + v0, torch.iinfo(top.dtype).max)
    return _all_reduce(cand, grp, dist.ReduceOp.MIN)


def fused_split_ok(widths, fuse: int, tp: int) -> bool:
    """Whether a projection whose fused output dim holds ``widths`` in
    ``fuse`` interleaved blocks (``split_fused``) splits over ``tp``
    ranks into each part's own columns: every block whole on one rank."""
    return tp == 1 or (fuse > 1 and fuse % tp == 0
                       and all(w % fuse == 0 for w in widths))


def _model_dim(p) -> Optional[int]:
    """The tensor dim the DTensor ``p`` splits over 'model' (None: whole
    there)."""
    from torch.distributed.tensor import Shard
    names = p.device_mesh.mesh_dim_names
    if "model" not in names:
        return None
    pl = p.placements[names.index("model")]
    return pl.dim if isinstance(pl, Shard) else None


def _model2_group(mesh) -> Optional[TPGroup]:
    """The 'model2' axis's group of a tp2d mesh (larger than one), where
    the compute splits each 'model' shard further; else None."""
    names = tuple(mesh.mesh_dim_names)
    if "model2" not in names or mesh.size(names.index("model2")) == 1:
        return None
    return _axis_group(mesh, names.index("model2"))


def gather_for_compute(w, model_dim: Optional[int],
                       dtype=None) -> torch.Tensor:
    """This rank's compute copy of the DTensor ``w``: its shard (cast to
    ``dtype`` first, if given) gathered over every data axis it is split
    on, and over 'model' re-split on tensor dim ``model_dim`` (None:
    gathered whole): nothing where the storage splits that dim already, a
    slice where it keeps the leaf whole, one all-to-all where it splits
    another dim (a row-parallel weight, the experts). On a tp2d mesh the
    compute splits ``model_dim`` over ('model', 'model2'): the rank's
    'model2' chunk of what that gives, a slice, taken before the
    all-to-all where there is one (each rank sends a 'model' rank only
    the chunk that rank's 'model2' partner of this rank keeps). A plain
    tensor."""
    from torch.distributed.tensor import Shard
    mesh = w.device_mesh
    x = w.to_local()
    if dtype is not None:
        x = x.to(dtype)
    for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, w.placements)):
        if name not in MODEL_AXES and isinstance(pl, Shard):
            x = _all_gather(x, pl.dim, _axis_group(mesh, i),
                            x.shape[pl.dim] * mesh.size(i))
    if "model" not in mesh.mesh_dim_names:
        return x
    grp = _axis_group(mesh, mesh.mesh_dim_names.index("model"))
    src, dst = _model_dim(w), model_dim
    if dst is None:
        return x if src is None else \
            _all_gather(x, src, grp, x.shape[src] * grp.size)
    sub = _model2_group(mesh)
    if src is None:
        x = _chunk(x, dst, grp)
    elif src != dst:
        if sub is not None:         # chunk m2 of each 'model' rank's chunk
            c = x.shape[dst] // (grp.size * sub.size)
            x = x.unflatten(dst, (grp.size, sub.size, c)).select(
                dst + 1, sub.rank).flatten(dst, dst + 1)
        return _all_to_all(x, src, dst, grp)
    return x if sub is None else _chunk(x, dst, sub)


def _chunk(x: torch.Tensor, dim: int, grp: TPGroup) -> torch.Tensor:
    """This rank's even chunk of ``x``'s ``dim`` over the group: a copy
    (a view, contiguous where ``dim`` leads, would keep all of ``x``)."""
    c = x.shape[dim] // grp.size
    return x.narrow(dim, grp.rank * c, c).clone(
        memory_format=torch.contiguous_format)


def _gather_model2(g: torch.Tensor, dim: int, sub: TPGroup) -> torch.Tensor:
    """A tp2d compute slice's gradient, split on ``dim`` over 'model2'
    (``sub``), as the 'model' rank's whole chunk: an all-gather."""
    return _all_gather(g, dim, sub, g.shape[dim] * sub.size)


def grad_to_storage(g: torch.Tensor, p, model_dim: Optional[int],
                    summed: Tuple[str, ...]) -> torch.Tensor:
    """The gradient of :func:`gather_for_compute`'s copy (laid out as it
    is, ``model_dim``), returned as this rank's shard of ``p`` (f32),
    summed over the mesh axes ``summed``: the data axes that split the
    batch and, for a leaf used whole (computed on each rank's sequence
    slice), the tensor-parallel axes. A split leaf's gradient is whole for
    its split: it is moved back to the storage's split (on a tp2d mesh
    gathered over 'model2' first), and the tensor-parallel axes in
    ``summed`` are not read for it."""
    mesh = p.device_mesh
    names = tuple(mesh.mesh_dim_names)
    if "model" not in names or model_dim is None:
        return _to_shard(g, p, summed)
    sub = _model2_group(mesh)
    if sub is not None:
        g = _gather_model2(g, model_dim, sub)
    grp = _axis_group(mesh, names.index("model"))
    src = _model_dim(p)
    if src is None:
        g = _all_gather(g, model_dim, grp, g.shape[model_dim] * grp.size)
        return _to_shard(g, p, summed)
    if src != model_dim:
        g = _all_to_all(g, model_dim, src, grp)
    return _to_shard(g, p, summed, held=("model",))


def _to_shard(g, p, axes, held=()):
    """This rank's shard, placed as the DTensor ``p``, of the per-rank
    gradient ``g`` summed over the mesh axes ``axes`` (f32). ``g`` is
    whole on every mesh axis but those in ``held``, where it is this
    rank's shard already. Mesh dims not in ``axes`` first cut this rank's
    chunk, where no summed dim splits the same tensor dim, so less is
    sent; the rest go in mesh order (a tensor dim split by several mesh
    dims is split major first): a summed dim reduce-scatters where ``p``
    is sharded on it and all-reduces where it is replicated, any other
    keeps its chunk. The specs are divisibility-guarded, so every split is
    even."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    mesh = p.device_mesh
    coord = mesh.get_coordinate()
    dims = [(i, name, pl) for i, (name, pl) in enumerate(
        zip(mesh.mesh_dim_names, p.placements))
        if mesh.size(i) > 1 and name not in held]
    summed = {pl.dim for _, name, pl in dims
              if name in axes and isinstance(pl, Shard)}
    first = [x for x in dims if x[1] not in axes
             and isinstance(x[2], Shard) and x[2].dim not in summed]
    g = g.float().contiguous()
    for i, name, pl in first + [x for x in dims if x not in first]:
        n = mesh.size(i)
        if not isinstance(pl, Shard):
            if name in axes:
                dist.all_reduce(g, group=mesh.get_group(i))
        elif name not in axes:      # a copy: the whole g is not kept
            g = g.chunk(n, dim=pl.dim)[coord[i]].clone(
                memory_format=torch.contiguous_format)
        else:
            src = g.movedim(pl.dim, 0).contiguous()
            out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
            dist.reduce_scatter_tensor(out, src, group=mesh.get_group(i))
            g = out.movedim(0, pl.dim).contiguous()
    return g


# ---------------------------------------------------------------------------
# serving: the cache's sequence over cache_seq
# ---------------------------------------------------------------------------

def cache_leaf_spec(name: str, shape, rules: Rules) -> P:
    """The guarded spec of one decode-cache leaf, as the reference's
    ``cache_specs`` places it: ``k``, ``v``, ``ck`` and ``cv`` over
    (batch, cache_seq), ``wkv`` and ``ssm`` over (batch, act_model),
    anything else over batch alone (stacked over layers first)."""
    nd = len(shape)
    if name in ("k", "v", "ck", "cv"):
        s = rules.spec(*([None, "batch", "cache_seq"] + [None] * (nd - 3)))
    elif name in ("wkv", "ssm"):
        s = rules.spec(*([None, "batch", "act_model"] + [None] * (nd - 3)))
    else:
        s = rules.spec(*([None, "batch"] + [None] * (nd - 2)))
    return _guard(s, tuple(shape), rules.mesh)


def _mesh_group(mesh) -> TPGroup:
    """Every rank of ``mesh`` as one group, in the mesh's row-major order
    (JAX's order for a spec entry naming every axis): the process group's
    world, which must hold the mesh's ranks in that order (as
    ``init_device_mesh`` and ``placeholder_mesh`` lay them out)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():          # the ranks are data
        ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise NotImplementedError("cache_seq over every axis of a mesh that "
                                  "is not the whole process group in rank "
                                  "order")
    return TPGroup(dist.group.WORLD, dist.get_rank(), len(ranks))


def cache_seq_group(n: int) -> Optional[TPGroup]:
    """The group a cache's sequence of ``n`` positions is split over under
    the active rules' ``cache_seq`` ('model', ('model', 'model2') flattened
    on a tp2d mesh, or under ``long`` every axis of the mesh, the model
    axes the minor ones), with this rank's place in it
    (:meth:`TPGroup.bounds` gives its slice); None outside rules, on a
    shape-only mesh, and where the guard keeps the sequence whole (the
    group's size does not divide ``n``)."""
    r = current_rules()
    if r is None or not hasattr(r.mesh, "get_group"):
        return None
    axes = _axes(r.map.get("cache_seq"))
    if not axes or n % _axis_n(_mesh_sizes(r.mesh), axes):
        return None
    names = axis_names(r.mesh)
    if tuple(axes) != names or len(axes) == 1:
        return _flat_group(r.mesh, axes)
    model = tuple(a for a in names if a in MODEL_AXES)
    if not model or names[-len(model):] != model:
        raise NotImplementedError(f"cache_seq over {axes} of {names}")
    return _mesh_group(r.mesh)


def kv_heads_to_seq(k: torch.Tensor, grp: TPGroup, cgrp: Optional[TPGroup],
                    rep: int = 1) -> torch.Tensor:
    """A prefill's keys or values (B, S, h, Dh) from the rank's KV heads
    over the whole sequence (the "heads" layout of ``attention_block``,
    split over the 'model' group ``grp``) to the cache's layout: this
    rank's slice of the sequence by ``cgrp`` (:func:`cache_seq_group`;
    None: the whole sequence) of every KV head, (B, S_c, KV, Dh). One
    all-to-all over 'model' (an all-gather of the heads where the cache is
    whole); under ``long`` each rank first keeps the block of the sequence
    its outer (data) coordinate holds. Where one KV head is rebuilt on
    ``rep`` ranks (more ranks than KV heads) each arrives ``rep`` times,
    and one copy is kept."""
    if cgrp is None:
        out = _all_gather(k, 2, grp, k.shape[2] * grp.size)
    else:
        outer = cgrp.size // grp.size
        blk = k.shape[1] // outer
        out = _all_to_all(k.narrow(1, (cgrp.rank // grp.size) * blk, blk),
                          2, 1, grp)
    return out if rep == 1 else out[:, :, ::rep]


def combine(x: torch.Tensor, grp: Optional[TPGroup],
            op: str = "sum") -> torch.Tensor:
    """The decode combine over a cache's sequence slices: the sum (or,
    with ``op="max"``, the largest) over ``grp`` of each rank's partial,
    whole on every rank; ``x`` without a group."""
    if grp is None:
        return x
    import torch.distributed as dist
    return _all_reduce(x, grp, dist.ReduceOp.MAX if op == "max" else None)


def last_position(x: torch.Tensor, n: int,
                  grp: Optional[TPGroup]) -> torch.Tensor:
    """(B, 1, ...): the last of ``n`` positions of a sequence whose slice
    ``x`` (dim 1) this rank holds, alike on every rank: the rank holding it
    adds its row to zeros from the others (exact)."""
    if grp is None:
        return x[:, -1:]
    row = x[:, -1:]
    if grp.bounds(n)[1] != n:
        row = torch.zeros_like(row)
    return reduce_model(row, grp)


def reslice_seq(x: torch.Tensor, dim: int, n_src: int, n_dst: int,
                src: Optional[TPGroup],
                dst: Optional[TPGroup]) -> torch.Tensor:
    """``x``, this rank's slice of a dim of ``n_src`` positions split over
    ``src`` (:meth:`TPGroup.bounds`; None: whole), as this rank's slice of
    a dim of ``n_dst`` >= ``n_src`` positions split over ``dst`` (None:
    whole), zero past ``n_src``: the prefill cache moved into the longer
    decode cache. ``src`` and ``dst``, where both are given, are one group
    (the cache_seq group of the active rules). One all-to-all with each
    pair's overlap where ``src`` splits the dim; a slice where it does
    not."""
    def rng(g, n, j):
        return (0, n) if g is None else dataclasses.replace(g, rank=j) \
            .bounds(n)
    me = 0 if dst is None else dst.rank
    b0, b1 = rng(dst, n_dst, me)
    if src is None:
        part = x.narrow(dim, min(b0, n_src), max(0, min(b1, n_src) - b0))
    else:
        import torch.distributed as dist
        a0, a1 = src.bounds(n_src)
        pieces, recv = [], []
        for j in range(src.size):
            c0, c1 = rng(dst, n_dst, j)
            s0, s1 = max(a0, c0), min(a1, c1)
            pieces.append(x.narrow(dim, s0 - a0, s1 - s0) if s1 > s0
                          else x.narrow(dim, 0, 0))
            r0, r1 = rng(src, n_src, j)
            recv.append(max(0, min(r1, b1) - max(r0, b0)))
        inp = torch.cat(pieces, dim).movedim(dim, 0).contiguous()
        out = inp.new_empty((sum(recv),) + inp.shape[1:])
        dist.all_to_all_single(out, inp, output_split_sizes=recv,
                               input_split_sizes=[p.shape[dim]
                                                  for p in pieces],
                               group=src.group)
        part = out.movedim(0, dim)
    return _pad_to(part, dim, b1 - b0)
