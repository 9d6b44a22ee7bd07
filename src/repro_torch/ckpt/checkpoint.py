"""Fault-tolerant checkpointing, as the reference's ``repro/ckpt/
checkpoint.py`` (the paper's archival and provenance discipline applied to
training state):

  * every leaf saved as .npy with a fletcher64 checksum in the step
    manifest (a corrupted restore fails loudly);
  * provenance JSON (who, when, config digest) beside every step;
  * async save (a training step never waits on disk), its host copy taken
    before the saving thread starts;
  * cold-tier archival mirrors steps into a ``TieredStore``.

Leaves are keyed by their path in the reference's order (``a/b/0``,
``repro_torch.tree``), and written with the reference's bytes: the same
``.npy`` files (bf16 under the descr ``<V2`` that numpy gives the
reference's bfloat16), sums and ``manifest.json``, so a checkpoint of
either package restores in the other. Restored leaves are tensors on the
device asked for (``None``: ``cuda``). The reference's elastic restore onto
another sharding waits for the port's placement work.
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


def save_checkpoint(ckpt_dir: Path, step: int, tree, *, digest: str = "",
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    """Write one step synchronously. Returns the step directory."""
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
    manifest's extra). Every leaf's fletcher64 is checked."""
    if shardings is not None:
        raise NotImplementedError(
            "restore onto another sharding (the reference's elastic "
            "restore) waits for the port's placement work (ROADMAP Queue 1 "
            "item 4)")
    dev = resolve_device(device)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step_dir = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    flat = {}
    for key, info in manifest["leaves"].items():
        arr = np.load(step_dir / info["file"])
        want = np.dtype(np.uint16 if info["dtype"] == _BF16
                        else info["dtype"])
        if arr.dtype != want:
            arr = arr.view(want)            # np.load gives bf16 as void16
        if fletcher64(arr) != info["fletcher64"]:
            raise IntegrityError(f"checkpoint leaf {key} corrupted "
                                 f"(step {step})")
        flat[key] = (arr, info["dtype"])

    def leaf(path, tmpl):
        key = tree_util.path_key(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr, dtype = flat[key]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"{key}: shape {arr.shape} != expected "
                             f"{tuple(tmpl.shape)}")
        return _to_tensor(arr, dtype, dev)
    tree = tree_util.map_with_paths(leaf, template)
    return tree, step, manifest.get("extra", {})


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

    def save_async(self, step: int, tree, extra=None):
        self.wait()                     # one in-flight save at a time
        # the host copy now, before the thread starts: a later step or an
        # in-place write cannot reach what is being saved
        host_tree = tree_util.tree_map(
            lambda t: t.detach().to("cpu", copy=True) if torch.is_tensor(t)
            else np.array(t), tree)

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
