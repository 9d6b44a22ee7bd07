"""Numpy oracle — bit-exact with the kernels.

Float reductions are the subtle part: to make the fused QA sum bit-exact
between the Pallas kernel and this oracle, both sides accumulate with the
SAME fixed reduction tree — a power-of-two halving tree inside each block
(elementwise IEEE f32 adds, no library reassociation), then a sequential
scalar add across blocks. Padding, masking, and block sizes are shared via
:func:`qa_block_size`; keep any change mirrored in ``checksum.py``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

M_POS = 65521


def device_checksum_ref(x: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(x).tobytes()
    pad = (-len(b)) % 4
    if pad:
        b += b"\0" * pad
    words = np.frombuffer(b, "<u4").astype(np.uint32)
    idx = (np.arange(words.size, dtype=np.uint64) % M_POS).astype(np.uint32)
    s1 = np.uint32(0)
    s2 = np.uint32(0)
    with np.errstate(over="ignore"):
        s1 = np.sum(words, dtype=np.uint32)
        s2 = np.sum(words * idx, dtype=np.uint32)
    return np.array([s1, s2], dtype=np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# fused QA + checksum oracle
# ---------------------------------------------------------------------------

def qa_block_size(n_vals: int, itemsize: int, blk: int = 1024) -> int:
    """Value-block size shared by kernel and oracle: a power of two whose
    byte extent is word-aligned, shrunk toward small inputs."""
    blk = 1 << (int(blk).bit_length() - 1)           # floor to power of two
    min_blk = max(8, 4 // itemsize)                  # word alignment floor
    while blk // 2 >= max(n_vals, min_blk) and (blk // 2) * itemsize % 4 == 0:
        blk //= 2
    while blk * itemsize % 4:                        # itemsize 1/2: stay aligned
        blk *= 2
    return max(blk, min_blk)


def tree_sum_f32(v: np.ndarray) -> np.float32:
    """Fixed power-of-two halving-tree sum (elementwise IEEE f32 adds).
    The kernel runs the identical tree in jnp — bit-exact by construction."""
    v = v.astype(np.float32, copy=True)
    n = v.shape[-1]
    while n > 1:
        n //= 2
        v = v[..., :n] + v[..., n:2 * n]
    return v[..., 0]


def _pack_words_ref(row_bytes: bytes) -> np.ndarray:
    pad = (-len(row_bytes)) % 4
    if pad:
        row_bytes += b"\0" * pad
    return np.frombuffer(row_bytes, "<u4").astype(np.uint32)


def qa_checksum_batched_ref(x: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Oracle for the batched fused kernel. ``x``: (G, ...) — each leading-dim
    slice is one volume of a shape bucket. Returns
    ``(sums int32 (G,2), qa float32 (G,3) = [min, max, sum], cnt int32 (G,1))``
    with min/max/sum over finite values only (min=+inf/max=-inf when none)."""
    x = np.ascontiguousarray(x)
    G = x.shape[0]
    vals = x.reshape(G, -1)
    nv = vals.shape[1]
    blk_v = qa_block_size(nv, x.dtype.itemsize)
    blk_w = blk_v * x.dtype.itemsize // 4

    sums = np.zeros((G, 2), np.uint32)
    qa = np.zeros((G, 3), np.float32)
    cnt = np.zeros((G, 1), np.int32)
    for g in range(G):
        row = vals[g]
        words = _pack_words_ref(row.tobytes())
        nw = words.size
        nsteps = max(-(-nw // blk_w), -(-nv // blk_v), 1)
        wpad = np.zeros(nsteps * blk_w, np.uint32)
        wpad[:nw] = words
        v = row.astype(np.float32)
        vpad = np.zeros(nsteps * blk_v, np.float32)
        vpad[:nv] = v
        s1 = np.uint32(0)
        s2 = np.uint32(0)
        vmin = np.float32(np.inf)
        vmax = np.float32(-np.inf)
        vsum = np.float32(0.0)
        n_fin = np.int32(0)
        with np.errstate(over="ignore"):
            for i in range(nsteps):
                w = wpad[i * blk_w:(i + 1) * blk_w]
                idx = np.arange(i * blk_w, (i + 1) * blk_w, dtype=np.int64)
                pos = np.where(idx < nw, (idx % M_POS).astype(np.uint32),
                               np.uint32(0))
                s1 = np.uint32(s1 + np.sum(w, dtype=np.uint32))
                s2 = np.uint32(s2 + np.sum(w * pos, dtype=np.uint32))
                vb = vpad[i * blk_v:(i + 1) * blk_v]
                vidx = np.arange(i * blk_v, (i + 1) * blk_v)
                finite = np.isfinite(vb) & (vidx < nv)
                n_fin = np.int32(n_fin + np.int32(np.sum(finite)))
                vmin = np.minimum(vmin, np.min(np.where(finite, vb, np.inf)))
                vmax = np.maximum(vmax, np.max(np.where(finite, vb, -np.inf)))
                vsum = np.float32(vsum + tree_sum_f32(np.where(finite, vb, 0.0)))
        sums[g] = (s1, s2)
        qa[g] = (vmin, vmax, vsum)
        cnt[g] = n_fin
    return sums.view(np.int32), qa, cnt


def qa_checksum_ref(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unbatched oracle: (int32[2], float32[3], int32[1])."""
    sums, qa, cnt = qa_checksum_batched_ref(
        np.ascontiguousarray(x).reshape(1, -1))
    return sums[0], qa[0], cnt[0]
