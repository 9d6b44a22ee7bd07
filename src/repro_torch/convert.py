"""Hand state from the JAX package to the port.

``from_jax`` turns numpy arrays taken from the JAX package (``np.asarray``
of its ``jax.Array``s, nested dicts, lists and tuples included) into the
port's tensors on a device. ``accumulator_from_jax`` continues a stream that
the reference's ``QAChecksumAccumulator`` began: its carry, the blocks it
folded and its unfolded tail move across, and the port's ``finalize()``
gives the ``QAStats`` the reference would have given. Nothing here imports
JAX or the JAX package; the reference's objects are read by their fields.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .kernels.checksum import QAChecksumAccumulator


def from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """Arrays (anything with ``__array__``) become tensors on ``device``
    (``None`` means ``cuda``); dicts, lists and tuples are walked; other
    leaves pass through unchanged. bfloat16 arrays keep their bits."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax(v, dev) for v in tree)
    if isinstance(tree, np.ndarray) or (hasattr(tree, "__array__")
                                        and not isinstance(tree, np.generic)):
        arr = np.ascontiguousarray(np.asarray(tree))
        if arr.dtype.name == "bfloat16":       # numpy holds it via ml_dtypes
            return torch.from_numpy(arr.view(np.uint16).copy()) \
                .view(torch.bfloat16).to(dev)
        return torch.from_numpy(arr.copy()).to(dev)
    return tree


def accumulator_from_jax(acc, device: DeviceLike = None, *,
                         backend: str = "auto") -> QAChecksumAccumulator:
    """A port accumulator that continues ``acc`` (the reference's
    ``QAChecksumAccumulator``, either backend) mid-stream: same array, same
    blocks, its carry ``(sums int32[2], qa f32[3], cnt int32[1])``, blocks
    done, bytes fed and buffered tail."""
    if acc.backend == "device":
        carry = tuple(np.asarray(c) for c in acc._carry)
    else:
        carry = (np.array([acc._s1, acc._s2], np.uint32).view(np.int32),
                 np.array([acc._vmin, acc._vmax, acc._vsum], np.float32),
                 np.array([acc._cnt], np.int32))
    port = QAChecksumAccumulator(acc.n_vals, acc.dtype, blk=acc.blk_v,
                                 backend=backend, device=device)
    if port.blk_v != acc.blk_v:
        raise ValueError(f"block size {port.blk_v} != {acc.blk_v}")
    carry_dev = device if port.backend == "device" else "cpu"
    port.resume(from_jax(carry, carry_dev), acc._blocks_done,
                acc._bytes_seen, bytes(acc._buf))
    return port
