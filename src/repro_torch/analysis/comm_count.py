"""The collectives a traced step issues, by kind, with their bytes: the
port's counterpart of the reference's ``repro/analysis/hlo_parse.py``.

The reference parses post-optimisation HLO text, finds the collective
instructions and multiplies those inside a ``while`` body by its trip
count. The port has no HLO: its step runs eagerly (under ``FakeTensorMode``
in a dry-run), so :class:`CollectiveLog`, a dispatch mode, sees each
collective op as often as it runs, and no loop multiplier is needed. It
sees the functional collectives DTensor issues (``full_tensor``:
``_c10d_functional.all_gather_into_tensor``) and the ``c10d`` ops the mesh
step and its tensor-parallel compute call directly
(``dist.all_gather_into_tensor``: ``c10d._allgather_base_``;
``dist.reduce_scatter_tensor``: ``c10d._reduce_scatter_base_``;
``dist.all_reduce``, of a sum, a max or a min: ``c10d.allreduce_``;
``dist.all_to_all_single``: ``c10d.alltoall_base_``).
``torch.distributed.tensor.debug.CommDebugMode`` counts the same ops but
gives no bytes; the dry-run runs both and holds their counts equal.

An op's bytes are those of the whole tensor it moves over its group, on
one rank: an all-gather's output, a reduce-scatter's input, an
all-reduce's (or a broadcast's) tensor, an all-to-all's input. The
reference counts each op's result bytes, so its reduce-scatters count the
scattered chunk. ``weighted_bytes`` counts an all-reduce twice, as
``hlo_parse.py`` does (a ring all-reduce is a reduce-scatter and an
all-gather).
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "broadcast")

# op name -> (kind, where its moved tensor is: "out" the result, or the
# index of the argument holding it; a list argument counts every tensor)
_OPS = {
    "all_gather_into_tensor": ("all-gather", "out"),
    "_allgather_base_": ("all-gather", 0),
    "allgather_": ("all-gather", 0),
    "all_reduce": ("all-reduce", 0),
    "allreduce_": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "all_to_all_single": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 1),
    "broadcast": ("broadcast", 0),
    "broadcast_": ("broadcast", 0),
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _group_size(args) -> int:
    """The size of the op's group: a functional op names it (its group
    name, a string), a ``c10d`` op passes the ``ProcessGroup`` object."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:        # a ReduceOp or Work, not a group
                continue
    name = next((a for a in reversed(args) if isinstance(a, str)), None)
    return _resolve_process_group(name).size() if name is not None else 0


class CollectiveLog(TorchDispatchMode):
    """Records every collective op dispatched while it is active:
    ``ops``, a list of ``{"op": kind, "bytes": ..., "group": ranks,
    "dtype": ..., "shape": [...]}`` in issue order (``shape`` the moved
    tensor's, the first one's for a list)."""

    def __init__(self):
        super().__init__()
        self.ops: List[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in _NAMESPACES and func._opname in _OPS:
            kind, where = _OPS[func._opname]
            moved = _tensors(out if where == "out" else args[where])
            self.ops.append({
                "op": kind,
                "bytes": sum(t.numel() * t.element_size() for t in moved),
                "group": _group_size(args),
                "dtype": str(moved[0].dtype).replace("torch.", ""),
                "shape": list(moved[0].shape)})
        return out

    def summary(self) -> Dict[str, object]:
        return summarize(self.ops)


def summarize(ops: List[dict]) -> Dict[str, object]:
    """``per_op`` bytes and ``counts`` by kind, ``raw_bytes``,
    ``weighted_bytes`` (all-reduce twice) and the ``ops`` themselves."""
    per_op = dict.fromkeys(KINDS, 0)
    counts = dict.fromkeys(KINDS, 0)
    for o in ops:
        per_op[o["op"]] += o["bytes"]
        counts[o["op"]] += 1
    weighted = sum(v * (2 if k == "all-reduce" else 1)
                   for k, v in per_op.items())
    return {"per_op": per_op, "counts": counts,
            "raw_bytes": sum(per_op.values()), "weighted_bytes": weighted,
            "ops": list(ops)}


def comm_debug_counts(mode) -> Dict[str, int]:
    """A ``CommDebugMode``'s counts, by this module's kinds; an op this
    module does not know keeps its own name, so the counts then differ
    from :class:`CollectiveLog`'s."""
    out = dict.fromkeys(KINDS, 0)
    for op, n in mode.get_comm_counts().items():
        name = getattr(op, "_qualified_op_name", str(op)).split("::")[-1]
        name = name.split(".")[-1]
        kind = _OPS[name][0] if name in _OPS else name
        out[kind] = out.get(kind, 0) + n
    return out
