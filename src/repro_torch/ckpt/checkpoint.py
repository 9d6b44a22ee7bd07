"""Fault-tolerant checkpointing, as the reference's ``repro/ckpt/
checkpoint.py`` (the paper's archival and provenance discipline applied to
training state):

  * every leaf saved as .npy with a fletcher64 checksum in the step
    manifest (a corrupted restore fails loudly);
  * provenance JSON (who, when, config digest) beside every step;
  * async save (a training step never waits on disk), its host copy taken
    before the saving thread starts;
  * elastic restore: leaves are saved with their global shapes, so a
    checkpoint written on one mesh restores onto any other;
  * cold-tier archival mirrors steps into a ``TieredStore``.

Leaves are keyed by their path in the reference's order (``a/b/0``,
``repro_torch.tree``), and written with the reference's bytes: the same
``.npy`` files (bf16 under the descr ``<V2`` that numpy gives the
reference's bfloat16), sums and ``manifest.json``, so a checkpoint of
either package restores in the other. Restored leaves are tensors on the
device asked for (``None``: ``cuda``).

Sharded state: a tree of DTensors saves as its global tensors. Every rank
gathers them (``full_tensor``) leaf by leaf in the calling thread, since a
collective must not run in the saving thread, and rank 0 keeps each on the
host (the card holds one whole leaf at a time; rank 0's host the whole
state); rank 0 alone writes, the same files a one-device save of those
values writes. Then every rank learns whether the write succeeded (for an
async save, in ``wait``) and raises if it did not. The elastic restore
(``shardings=``, the tree ``dist.sharding.shardings_for`` gives) rebuilds
each leaf as a DTensor from the slice its rank owns: every rank
memory-maps each leaf and copies only its own slice, with no broadcast;
each leaf's fletcher64 is computed by one rank (the leaves split over the
ranks) and the outcome all-reduced, so every rank raises on a corrupted
leaf. A checkpoint written on one layout restores onto any other (any
world size, any mesh).
"""
from __future__ import annotations

import json
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import tree as tree_util
from ..core.integrity import IntegrityError, fletcher64
from ..core.provenance import make_provenance
from ..device import DeviceLike, resolve_device

_BF16 = "bfloat16"


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(a numpy array holding the leaf's bytes, the reference's name of
    its dtype). A bf16 tensor comes back as its uint16 bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {tree_util.path_key(p): _host(leaf)
            for p, leaf in tree_util.flatten_with_paths(tree)}


def _save_npy(path: Path, arr: np.ndarray, dtype: str):
    if dtype != _BF16:
        np.save(path, arr)
        return
    # np.save of the reference's bfloat16 array: its header, then the bits
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _is_dtensor(x) -> bool:
    # DTensor is only imported once a sharded tree exists to be saved
    import sys
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _gathered(tree):
    """(``tree`` with every DTensor leaf gathered to a host copy of its
    global tensor on rank 0, whether any leaf was one). Leaf by leaf, a
    collective on every rank of the mesh; the other ranks keep nothing and
    get None."""
    sharded = any(_is_dtensor(x) for x in tree_util.leaves(tree))
    if not sharded:
        return tree, False
    lead = dist.get_rank() == 0

    def host(x):
        if _is_dtensor(x):
            x = x.full_tensor()         # a collective: every rank
        if not lead:
            return None
        return x.detach().to("cpu", copy=True) if torch.is_tensor(x) \
            else np.array(x)
    out = tree_util.tree_map(host, tree)
    return (out if lead else None), True


def _all_ok(ok: bool) -> bool:
    """Whether ``ok`` holds on every rank of the default group (one
    all_reduce)."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    flag = torch.tensor([int(ok)], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def _not_written(step: int, ckpt_dir) -> RuntimeError:
    return RuntimeError(f"rank 0 failed to write checkpoint step {step} "
                        f"under {ckpt_dir}")


def save_checkpoint(ckpt_dir: Path, step: int, tree, *, digest: str = "",
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    """Write one step synchronously. Returns the step directory. A tree
    with DTensor leaves is gathered on every rank and written by rank 0
    alone; every rank returns once it is on disk, and every rank raises
    if rank 0's write failed."""
    host, sharded = _gathered(tree)
    if not sharded:
        return _save(ckpt_dir, step, tree, digest, extra)
    err = None
    if dist.get_rank() == 0:
        try:
            _save(ckpt_dir, step, host, digest, extra)
        except Exception as e:      # noqa: BLE001 — raised on every rank
            err = e
    if not _all_ok(err is None):
        raise err if err is not None else _not_written(step, ckpt_dir)
    return Path(ckpt_dir) / f"step_{step:08d}"


def _save(ckpt_dir: Path, step: int, tree, digest: str,
          extra: Optional[Dict[str, Any]]) -> Path:
    t0 = time.time()
    step_dir = Path(ckpt_dir) / f"step_{step:08d}"
    tmp = step_dir.with_suffix(".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    sums = {}
    for key, (arr, dtype) in _flatten(tree).items():
        fn = key.replace("/", "__") + ".npy"
        _save_npy(tmp / fn, arr, dtype)
        sums[key] = {"file": fn, "fletcher64": fletcher64(arr),
                     "shape": list(arr.shape), "dtype": dtype}
    manifest = {"step": step, "leaves": sums, "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    make_provenance("checkpoint", digest, {}, {k: str(v["fletcher64"])
                                               for k, v in sums.items()},
                    t0).save(tmp)
    if step_dir.exists():
        shutil.rmtree(step_dir)
    tmp.rename(step_dir)          # atomic publish: partial writes never count
    return step_dir


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def restore_checkpoint(ckpt_dir: Path, template, step: Optional[int] = None,
                       shardings=None, device: DeviceLike = None):
    """Restore a step (the latest by default) into ``template``'s structure
    (leaves with a ``shape``): (tree of tensors on ``device``, step, the
    manifest's extra). Every leaf's fletcher64 is checked. With
    ``shardings`` (a tree of ``NamedSharding`` matching ``template``) each
    leaf is a DTensor on its sharding's mesh, built from this rank's slice
    on the mesh's device (``device`` is then unused); any layout, whatever
    wrote the checkpoint. There each leaf is memory-mapped and only this
    rank's slice is copied, and each leaf is checked by one rank of the
    default group (the leaves split over the ranks by size); every rank
    raises ``IntegrityError`` if any leaf fails."""
    dev = None if shardings is not None else resolve_device(device)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step_dir = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    leaves = manifest["leaves"]
    mine = _checked_here(leaves) if shardings is not None else set(leaves)
    flat, bad = {}, []
    for key, info in leaves.items():
        arr = np.load(step_dir / info["file"],
                      mmap_mode="r" if shardings is not None else None)
        want = np.dtype(np.uint16 if info["dtype"] == _BF16
                        else info["dtype"])
        if arr.dtype != want:
            arr = arr.view(want)            # np.load gives bf16 as void16
        if key in mine and fletcher64(arr) != info["fletcher64"]:
            bad.append(key)
        flat[key] = (arr, info["dtype"])
    if shardings is not None and not _all_ok(not bad) and not bad:
        raise IntegrityError(f"checkpoint step {step}: a leaf failed its "
                             f"fletcher64 on another rank")
    if bad:
        raise IntegrityError(f"checkpoint leaf {bad[0]} corrupted "
                             f"(step {step})")

    def leaf(path, tmpl):
        key = tree_util.path_key(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr, dtype = flat[key]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"{key}: shape {arr.shape} != expected "
                             f"{tuple(tmpl.shape)}")
        if shardings is not None:
            return _placed(arr, dtype, tree_util.at(shardings, path))
        return _to_tensor(arr, dtype, dev)
    tree = tree_util.map_with_paths(leaf, template)
    return tree, step, manifest.get("extra", {})


def _checked_here(leaves: Dict[str, dict]) -> set:
    """The keys of the leaves this rank checks: largest first, each to the
    rank with the fewest bytes so far (ties to the lower rank), the same
    split on every rank."""
    world, rank = dist.get_world_size(), dist.get_rank()
    load = [0] * world
    mine = set()
    for key in sorted(leaves, key=lambda k: -_nbytes(leaves[k])):
        r = min(range(world), key=lambda i: load[i])
        load[r] += _nbytes(leaves[key])
        if r == rank:
            mine.add(key)
    return mine


def _nbytes(info: dict) -> int:
    n = 2 if info["dtype"] == _BF16 else np.dtype(info["dtype"]).itemsize
    for d in info["shape"]:
        n *= d
    return n


def _placed(arr: np.ndarray, dtype: str, sharding):
    """A DTensor of ``sharding`` from this rank's slice of the global
    ``arr`` (the elastic restore: the reference's ``jax.device_put``)."""
    from ..dist.sharding import from_local, mesh_device
    mesh = sharding.mesh
    # a memory-mapped leaf: only the slice is read and copied
    local = _to_tensor(np.asarray(arr[sharding.local_slices(arr.shape)]),
                       dtype, mesh_device(mesh))
    return from_local(local, mesh, sharding.placements, arr.shape)


def latest_step(ckpt_dir: Path) -> Optional[int]:
    steps = []
    for p in Path(ckpt_dir).glob("step_*"):
        m = re.match(r"step_(\d+)$", p.name)
        if m and (p / "manifest.json").exists():
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


class CheckpointManager:
    """Async save + retention + optional cold-tier archival."""

    def __init__(self, ckpt_dir: Path, *, keep: int = 3, digest: str = "",
                 cold_store=None):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self.digest = digest
        self.cold_store = cold_store
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._sharded = None            # the step whose outcome is owed

    def save_async(self, step: int, tree, extra=None):
        """Save in a thread. A tree with DTensor leaves is gathered here,
        on every rank; rank 0's thread writes it, and in :meth:`wait`
        every rank learns whether it did, and raises if not."""
        self.wait()                     # one in-flight save at a time
        host_tree, sharded = _gathered(tree)
        if sharded:
            self._sharded = step
            if dist.get_rank() != 0:
                return
        else:
            # the host copy now, before the thread starts: a later step
            # or an in-place write cannot reach what is being saved
            host_tree = tree_util.tree_map(
                lambda t: t.detach().to("cpu", copy=True)
                if torch.is_tensor(t) else np.array(t), tree)

        def work():
            try:
                step_dir = save_checkpoint(self.ckpt_dir, step, host_tree,
                                           digest=self.digest, extra=extra)
                self._gc()
                if self.cold_store is not None:
                    for f in step_dir.iterdir():
                        self.cold_store.put(f, f"ckpt/{step_dir.name}/{f.name}",
                                            tier="cold")
            except BaseException as e:   # noqa: BLE001 — surfaced via wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded is not None:
            step, self._sharded = self._sharded, None
            if not _all_ok(self._error is None) and self._error is None:
                self._error = _not_written(step, self.ckpt_dir)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(p for p in self.ckpt_dir.glob("step_*") if p.is_dir())
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    def restore_latest(self, template, shardings=None,
                       device: DeviceLike = None):
        self.wait()
        return restore_checkpoint(self.ckpt_dir, template,
                                  shardings=shardings, device=device)
