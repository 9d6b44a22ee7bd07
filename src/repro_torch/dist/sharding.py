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
    """One mesh axis's group as this rank sees it: the process group, this
    rank's index in it and its size. :func:`tp_group` gives the 'model'
    axis's."""
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


def tp_group() -> Optional[TPGroup]:
    """The 'model' group of the active rules' mesh, when the rules map
    ``act_model``, ``vocab`` and ``res_seq`` onto 'model' (the compute is
    tensor-parallel); None outside rules, on a shape-only mesh and when
    they map elsewhere. Rules that map them over 'model' and a 'model2'
    larger than 1 (``tp2d``) raise: the compute would split over both
    axes, the storage over 'model' alone."""
    r = current_rules()
    if r is None or not hasattr(r.mesh, "get_group"):
        return None
    names = axis_names(r.mesh)
    sizes = _mesh_sizes(r.mesh)
    maps = [tuple(a for a in _axes(r.map.get(k))
                  if a == "model" or sizes.get(a, 1) > 1)
            for k in ("act_model", "vocab", "res_seq")]
    if any("model2" in m for m in maps):
        raise NotImplementedError("tensor-parallel compute over 'model' "
                                  "and 'model2' (tp2d)")
    if any(m != ("model",) for m in maps):
        return None
    return _axis_group(r.mesh, names.index("model"))


def seq_axes(rules: Rules) -> Tuple[str, ...]:
    """The mesh axes the rules split the residual's sequence over when the
    compute is tensor-parallel (:func:`tp_group`), else none."""
    with use_rules(rules):
        return ("model",) if tp_group() is not None else ()


def compute_layout(params, cfg):
    """The compute copy's layout under the active rules: per leaf the
    tensor dim split over 'model' (``compute_model_dims`` at the group's
    size), or None everywhere when the compute is not tensor-parallel."""
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
    ``dim`` leads or the group is one rank."""
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
# code path with and without tensor-parallel compute.

def gather_seq(x: torch.Tensor, n: Optional[int], grp: Optional[TPGroup],
               dim: int = 1) -> torch.Tensor:
    """The whole sequence (``n`` long) of a ``res_seq`` residual, from
    this rank's slice: the entry of a column-parallel block. Its backward
    sums every rank's gradient and keeps this rank's slice."""
    return x if grp is None else _GatherSeq.apply(x, dim, grp, n)


def scatter_seq(x: torch.Tensor, grp: Optional[TPGroup],
                dim: int = 1) -> torch.Tensor:
    """This rank's sequence slice of the sum over the group of ``x``, the
    partial sums of a row-parallel block: its exit to the residual."""
    return x if grp is None else _ScatterSeq.apply(x, dim, grp)


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
    return _GatherSeq.apply(x, dim, grp, x.shape[dim] * grp.size)


def reduce_model(x: torch.Tensor, grp: Optional[TPGroup]) -> torch.Tensor:
    """The sum over the group of the ranks' ``x``, which every rank then
    uses alike (the loss's sums): backward the identity, so each rank's
    ``x`` gets the gradient of its own share."""
    return x if grp is None else _Reduce.apply(x, grp, False)


def reduce_model_shared(x: torch.Tensor,
                        grp: Optional[TPGroup]) -> torch.Tensor:
    """The sum over the group of the ranks' ``x``, which each rank then
    uses on its own share of a split dim (a norm's moment): backward an
    all-reduce."""
    return x if grp is None else _Reduce.apply(x, grp, True)


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


def gather_for_compute(w, model_dim: Optional[int],
                       dtype=None) -> torch.Tensor:
    """This rank's compute copy of the DTensor ``w``: its shard (cast to
    ``dtype`` first, if given) gathered over every data axis it is split
    on, and over 'model' re-split on tensor dim ``model_dim`` (None:
    gathered whole): nothing where the storage splits that dim already, a
    slice where it keeps the leaf whole, one all-to-all where it splits
    another dim (a row-parallel weight, the experts). A plain tensor."""
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
    if src == dst:
        return x
    if dst is None:
        return _all_gather(x, src, grp, x.shape[src] * grp.size)
    if src is None:
        c = x.shape[dst] // grp.size
        return x.narrow(dst, grp.rank * c, c).contiguous()
    return _all_to_all(x, src, dst, grp)


def grad_to_storage(g: torch.Tensor, p, model_dim: Optional[int],
                    summed: Tuple[str, ...]) -> torch.Tensor:
    """The gradient of :func:`gather_for_compute`'s copy (laid out as it
    is, ``model_dim``), returned as this rank's shard of ``p`` (f32),
    summed over the mesh axes ``summed``: the data axes that split the
    batch and, for a leaf used whole (computed on each rank's sequence
    slice), 'model'. A split leaf's gradient is whole for its split: it is
    moved back to the storage's split, and 'model' in ``summed`` is not
    read for it."""
    mesh = p.device_mesh
    names = tuple(mesh.mesh_dim_names)
    if "model" not in names or model_dim is None:
        return _to_shard(g, p, summed)
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
