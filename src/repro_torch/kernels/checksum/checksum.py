"""Fused QA + transfer checksum (paper §2.3/§2.1) on the H100.

One pass over a volume's bytes emits

    s1 = sum_i w_i            (mod 2^32)                          \\ transfer
    s2 = sum_i (i mod M) w_i  (mod 2^32),  M = 65521             /  checksum
    min, max, sum             over finite float values            \\ fast QA
    finite_count                                                  /

over its little-endian uint32 word view and its values cast to float32.
The kernels are CUDA C++ in ``csrc/checksum.cu`` (built by ``nvcc`` at first
use, ``kernels/_build.py``); each has a plain PyTorch version here that
keeps its tiling and reduction order. A wrapper launches the kernel for a
CUDA tensor and runs the plain version only for a CPU tensor. Both agree
bit for bit with ``ref.py``: the float sum is a fixed power-of-two halving
tree inside each block of ``qa_block_size`` values, then a sequential f32
add across blocks in block order; integer sums wrap mod 2^32.

``LAUNCHES`` counts kernel launches per wrapper (never plain-version runs),
so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from .. import _build
from .ref import M_POS, qa_block_size, tree_sum_f32

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# dtypes the accumulator folds identically on every backend (the
# reference's list: little-endian numerics numpy and torch both hold)
ACCUMULATOR_DTYPES = ("float16", "float32", "int8", "uint8", "int16",
                      "uint16", "int32", "uint32")

# value dtype -> code of csrc/checksum.cu's DType enum
_DTYPE_CODES: Dict[torch.dtype, int] = {
    torch.float32: 0, torch.float16: 1, torch.bfloat16: 2, torch.int8: 3,
    torch.uint8: 4, torch.int16: 5, torch.uint16: 6, torch.int32: 7,
    torch.uint32: 8,
}

# kernel launches per wrapper; K1, K2 and K3 in that order
LAUNCHES: Dict[str, int] = {"qa_checksum": 0, "qa_checksum_chunk": 0,
                            "device_checksum": 0}

_MASK = 0xFFFFFFFF


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "repro_qa_checksum": [_P, _I64, _I64, _INT, _INT, _I64, _I64, _I64, _I64,
                          _I64, _P, _P, _P, _P, _P],
    "repro_qa_chunk": [_P, _I64, _INT, _INT, _I64, _I64, _I64, _I64, _I64,
                       _I64, _P, _P, _P, _P, _P, _P, _P, _P],
    "repro_device_checksum": [_P, _I64, _P, _P],
}


def _cuda_fn(name: str):
    lib = _build.load("checksum")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return fn, lib


def _launch(name: str, *args):
    fn, lib = _cuda_fn(name)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {rc} "
                           f"({lib.repro_error_string(rc).decode()})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {dtype} for the QA checksum "
                         f"(supported: {sorted(map(str, _DTYPE_CODES))})")
    return _DTYPE_CODES[dtype]


def _placement(t: torch.Tensor) -> str:
    """'cuda' -> launch the kernel, 'cpu' -> the plain version; anything
    else is refused (there is no fallback from a CUDA tensor)."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _empty_carry(G: int, device) -> Carry:
    qa = torch.tensor([[np.inf, -np.inf, 0.0]] * G, dtype=torch.float32,
                      device=device).reshape(G, 3)
    return (torch.zeros((G, 2), dtype=torch.int32, device=device), qa,
            torch.zeros((G, 1), dtype=torch.int32, device=device))


def initial_carry(device) -> Carry:
    """The carry a stream starts from: ``(sums int32[2] = 0, qa f32[3] =
    (+inf, -inf, 0.0), cnt int32[1] = 0)`` on ``device``."""
    return tuple(c[0] for c in _empty_carry(1, device))


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' tiling and reduction order)
# ---------------------------------------------------------------------------

def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> the int32 with the same 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _as_f32(x: torch.Tensor) -> torch.Tensor:
    """Values cast to f32 with round-to-nearest (numpy's astype); unsigned
    16/32-bit values widen through int64 first, since torch's barebones
    uint16/uint32 types do not convert on every device."""
    if x.dtype == torch.uint16:
        x = x.view(torch.int16).to(torch.int64) & 0xFFFF
    elif x.dtype == torch.uint32:
        x = x.view(torch.int32).to(torch.int64) & _MASK
    return x.to(torch.float32)


def _word_sums_plain(words: torch.Tensor, w0: int, nw: int) -> torch.Tensor:
    """(s1, s2) mod 2^32 as int64 (..., 2) over int32 ``words`` whose first
    column is global word ``w0``; words at or past ``nw`` are masked."""
    w = words.to(torch.int64) & _MASK
    gw = w0 + torch.arange(words.shape[-1], dtype=torch.int64,
                           device=words.device)
    valid = gw < nw
    w = torch.where(valid, w, 0)
    pos = torch.where(valid, gw % M_POS, 0)
    s1 = w.sum(-1) & _MASK
    s2 = ((w * pos) & _MASK).sum(-1) & _MASK        # per-product mask: no
    return torch.stack([s1, s2], -1)                 # int64 overflow


def _qa_blocks_plain(data: torch.Tensor, dtype: torch.dtype, blk_v: int,
                     nsteps: int, w0: int, v0: int, nw: int, nv: int,
                     carry: Optional[Carry] = None) -> Carry:
    """Plain version of ``qa_blocks_kernel`` + ``qa_fold_kernel``: fold
    ``nsteps`` blocks of each row of ``data`` (uint8 (G, nbytes), zero past
    its end) into ``carry`` (fresh when None)."""
    G, nbytes = data.shape
    itemsize = dtype.itemsize
    span = nsteps * blk_v * itemsize
    if nbytes > span:
        raise ValueError(f"{nbytes} bytes do not fit {nsteps} blocks")
    buf = torch.zeros((G, span), dtype=torch.uint8, device=data.device)
    buf[:, :nbytes] = data
    if carry is None:
        carry = _empty_carry(G, data.device)
    c_sums, c_qa, c_cnt = (c.reshape(G, -1) for c in carry)

    sums = _word_sums_plain(buf.view(torch.int32), w0, nw)
    sums = (sums + (c_sums.to(torch.int64) & _MASK)) & _MASK

    v = _as_f32(buf.view(dtype)).reshape(G, nsteps, blk_v)
    gv = v0 + torch.arange(nsteps * blk_v, device=data.device)
    finite = torch.isfinite(v) & (gv < nv).reshape(nsteps, blk_v)
    cnt = finite.sum((1, 2)).to(torch.int32)
    inf = torch.tensor(np.inf, dtype=torch.float32, device=data.device)
    vmin = torch.where(finite, v, inf).amin((1, 2))
    vmax = torch.where(finite, v, -inf).amax((1, 2))
    t = torch.where(finite, v, torch.zeros((), device=data.device))
    n = blk_v
    while n > 1:                                    # ref.tree_sum_f32
        n //= 2
        t = t[..., :n] + t[..., n:2 * n]
    partial = t[..., 0].cpu().numpy()               # (G, nsteps)
    start = c_qa[:, 2].cpu().numpy()
    vsum = np.empty(G, np.float32)
    with np.errstate(over="ignore", invalid="ignore"):   # inf/NaN are data
        for g in range(G):                          # sequential, block order
            acc = np.float32(start[g])
            for p in partial[g]:
                acc = np.float32(acc + p)
            vsum[g] = acc
    qa = torch.stack([torch.minimum(c_qa[:, 0], vmin),
                      torch.maximum(c_qa[:, 1], vmax),
                      torch.from_numpy(vsum).to(data.device)], -1)
    return _to_int32(sums), qa, c_cnt + cnt[:, None]


def _byte_rows(vals: torch.Tensor) -> torch.Tensor:
    """(G, nv) contiguous -> its bytes as uint8 (G, nv * itemsize)."""
    if vals.numel() == 0:          # numpy-born empties carry stride 0
        return torch.empty((vals.shape[0], 0), dtype=torch.uint8,
                           device=vals.device)
    return vals.view(torch.uint8).reshape(vals.shape[0], -1)


def _geometry(nv: int, itemsize: int, blk: int) -> Tuple[int, int, int]:
    """(blk_v, nw, nsteps) of one row of nv values: the shared block size,
    the word count (the row's last word zero-padded) and the block steps."""
    blk_v = qa_block_size(nv, itemsize, blk)
    blk_w = blk_v * itemsize // 4
    nw = (nv * itemsize + 3) // 4
    return blk_v, nw, max(-(-nw // blk_w), -(-nv // blk_v), 1)


def device_checksum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`device_checksum`, on ``x``'s device."""
    b = _byte_rows(x.contiguous().reshape(1, -1))[0]
    nw = (b.numel() + 3) // 4
    buf = torch.zeros(nw * 4, dtype=torch.uint8, device=b.device)
    buf[:b.numel()] = b
    return _to_int32(_word_sums_plain(buf.view(torch.int32), 0, nw))


# ---------------------------------------------------------------------------
# K3: transfer checksum
# ---------------------------------------------------------------------------

def device_checksum(x: torch.Tensor) -> torch.Tensor:
    """int32[2] = (s1, s2) over the uint32 word view of ``x``'s bytes, on
    ``x``'s device (the reference's ``device_checksum``)."""
    if _placement(x) == "cpu":
        return device_checksum_plain(x)
    b = x.contiguous().reshape(-1)
    out = torch.zeros(2, dtype=torch.int32, device=x.device)
    _launch("repro_device_checksum", b.data_ptr(),
            b.numel() * b.element_size(), out.data_ptr(), _stream(out))
    LAUNCHES["device_checksum"] += 1
    return out


# ---------------------------------------------------------------------------
# K1: fused QA + checksum, one shot over batched rows
# ---------------------------------------------------------------------------

def qa_checksum_batched_plain(x: torch.Tensor, *, blk: int = 1024) -> Carry:
    """Plain version of :func:`qa_checksum_batched`, on ``x``'s device."""
    vals = x.reshape(x.shape[0], -1).contiguous()
    G, nv = vals.shape
    _dtype_code(vals.dtype)
    blk_v, nw, nsteps = _geometry(nv, vals.element_size(), blk)
    if G == 0:
        return _empty_carry(0, vals.device)
    return _qa_blocks_plain(_byte_rows(vals), vals.dtype, blk_v, nsteps,
                            0, 0, nw, nv)


def _qa_checksum_2d(vals: torch.Tensor, blk: int) -> Carry:
    """vals: (G, nv). Returns (sums int32 (G,2), qa f32 (G,3) = [min, max,
    sum], cnt int32 (G,1)) on ``vals``' device."""
    if _placement(vals) == "cpu":
        return qa_checksum_batched_plain(vals, blk=blk)
    vals = vals.contiguous()
    G, nv = vals.shape
    code = _dtype_code(vals.dtype)
    itemsize = vals.element_size()
    blk_v, nw, nsteps = _geometry(nv, itemsize, blk)
    if G == 0:
        return _empty_carry(0, vals.device)
    out = (torch.empty((G, 2), dtype=torch.int32, device=vals.device),
           torch.empty((G, 3), dtype=torch.float32, device=vals.device),
           torch.empty((G, 1), dtype=torch.int32, device=vals.device))
    scratch = torch.empty(6 * G * nsteps, dtype=torch.int32,
                          device=vals.device)
    _launch("repro_qa_checksum", vals.data_ptr(), nv * itemsize,
            nv * itemsize, code, itemsize, blk_v, nsteps, G, nw, nv,
            *(o.data_ptr() for o in out), scratch.data_ptr(), _stream(vals))
    LAUNCHES["qa_checksum"] += 1
    return out


def qa_checksum_batched(x: torch.Tensor, *, blk: int = 1024) -> Carry:
    """Fused QA+checksum over a shape bucket: ``x`` is (N, ...), N volumes
    in one launch. Returns (int32 (N,2), float32 (N,3) [min, max, sum],
    int32 (N,1) finite counts)."""
    return _qa_checksum_2d(x.reshape(x.shape[0], -1), blk)


def qa_checksum(x: torch.Tensor, *, blk: int = 1024) -> Carry:
    """Unbatched fused QA+checksum: (int32[2], float32[3], int32[1])."""
    sums, qa, cnt = _qa_checksum_2d(x.reshape(1, -1), blk)
    return sums[0], qa[0], cnt[0]


@dataclasses.dataclass(frozen=True)
class QAStats:
    """Host-side view of one volume's fused QA+checksum pass."""
    s1: int
    s2: int
    vmin: float
    vmax: float
    vsum: float
    finite_count: int

    @property
    def checksum(self) -> int:
        return ((self.s2 & 0xFFFFFFFF) << 32) | (self.s1 & 0xFFFFFFFF)

    @classmethod
    def from_carry(cls, sums, qa, cnt) -> "QAStats":
        sums = np.asarray(sums).reshape(-1).view(np.uint32)
        qa = np.asarray(qa).reshape(-1)
        return cls(int(sums[0]), int(sums[1]), float(qa[0]), float(qa[1]),
                   float(qa[2]), int(np.asarray(cnt).reshape(-1)[0]))


def qa_stats(x: torch.Tensor, *, blk: int = 1024) -> QAStats:
    """Run :func:`qa_checksum` and pull the scalars to the host."""
    return QAStats.from_carry(*(t.cpu().numpy()
                                for t in qa_checksum(x, blk=blk)))


# ---------------------------------------------------------------------------
# K2: the chunk-accumulating variant (streaming ingest, core/stream.py)
# ---------------------------------------------------------------------------

def qa_checksum_chunk_plain(data: torch.Tensor,
                            off: Tuple[int, int, int, int], carry: Carry, *,
                            dtype: torch.dtype, blk_v: int,
                            nblocks: int) -> Carry:
    """Plain version of :func:`qa_checksum_chunk`, on ``data``'s device."""
    data = _chunk_bytes(data, dtype, blk_v, nblocks)
    sums, qa, cnt = _qa_blocks_plain(data[None], dtype, blk_v, nblocks,
                                     *(int(o) for o in off), carry)
    return sums[0], qa[0], cnt[0]


def _chunk_bytes(data: torch.Tensor, dtype: torch.dtype, blk_v: int,
                 nblocks: int) -> torch.Tensor:
    """Check a chunk: uint8, a whole number of values, within nblocks."""
    if data.dtype != torch.uint8:
        raise ValueError(f"chunk must be uint8 bytes, got {data.dtype}")
    data = data.contiguous().reshape(-1)
    if data.numel() % dtype.itemsize or \
            data.numel() > nblocks * blk_v * dtype.itemsize:
        raise ValueError(f"{data.numel()} bytes are not a whole number of "
                         f"{dtype} values within {nblocks} blocks")
    return data


def qa_checksum_chunk(data: torch.Tensor, off: Tuple[int, int, int, int],
                      carry: Carry, *, dtype: torch.dtype, blk_v: int,
                      nblocks: int) -> Carry:
    """Fold ``nblocks`` blocks of one array's bytes into ``carry``
    (``(sums int32[2], qa f32[3], cnt int32[1])``, on ``data``'s device).
    ``data`` is uint8, a whole number of values, block-aligned at its start,
    and reads as zero past its end; ``off = (word_offset, value_offset,
    total_words, total_values)``. Returns the new carry."""
    if _placement(data) == "cpu":
        return qa_checksum_chunk_plain(data, off, carry, dtype=dtype,
                                       blk_v=blk_v, nblocks=nblocks)
    data = _chunk_bytes(data, dtype, blk_v, nblocks)
    w0, v0, nw, nv = (int(o) for o in off)
    if any(c.device != data.device or not c.is_contiguous() for c in carry):
        raise ValueError("carry must be contiguous and on the chunk's device")
    itemsize = dtype.itemsize
    out = tuple(torch.empty_like(c) for c in carry)
    scratch = torch.empty(6 * nblocks, dtype=torch.int32, device=data.device)
    _launch("repro_qa_chunk", data.data_ptr(), data.numel(),
            _dtype_code(dtype), itemsize, blk_v, nblocks, w0, v0, nw, nv,
            *(c.data_ptr() for c in carry), *(o.data_ptr() for o in out),
            scratch.data_ptr(), _stream(data))
    LAUNCHES["qa_checksum_chunk"] += 1
    return out


_NP_TO_TORCH = {"float16": torch.float16, "float32": torch.float32,
                "int8": torch.int8, "uint8": torch.uint8,
                "int16": torch.int16, "uint16": torch.uint16,
                "int32": torch.int32, "uint32": torch.uint32}


class QAChecksumAccumulator:
    """Fold one array's bytes through the fused QA+checksum pass, chunk by
    chunk, bit-exact with one-shot :func:`qa_stats` on the whole array.

    :meth:`update` takes arbitrary byte chunks (a sub-block tail is carried
    to the next call) and :meth:`finalize` returns the :class:`QAStats` when
    the last byte is in. ``backend="auto"`` folds on ``device`` (``None``
    means ``cuda``): the K2 kernel on ``cuda``, its
    plain version on ``cpu``; the carry stays on the device and only
    :meth:`finalize` synchronises. ``backend="host"`` is the reference's
    vectorised numpy fold, with the same block tree.
    """

    def __init__(self, n_vals: int, dtype, *, blk: int = 1024,
                 backend: str = "auto", device: DeviceLike = None):
        self.dtype = np.dtype(dtype)
        if self.dtype.name not in ACCUMULATOR_DTYPES:
            raise ValueError(
                f"unsupported streaming-QA dtype {self.dtype} "
                f"(supported: {', '.join(ACCUMULATOR_DTYPES)})")
        if n_vals < 0:
            raise ValueError(f"negative n_vals {n_vals}")
        self.n_vals = int(n_vals)
        self.itemsize = self.dtype.itemsize
        self.blk_v = qa_block_size(self.n_vals, self.itemsize, blk)
        self.blk_w = self.blk_v * self.itemsize // 4
        self.align_bytes = self.blk_v * self.itemsize
        self.nw = (self.n_vals * self.itemsize + 3) // 4
        self.total_blocks = max(-(-self.n_vals // self.blk_v), 1)
        if backend not in ("auto", "host"):
            raise ValueError(f"unknown backend {backend!r}")
        backend = "device" if backend == "auto" else "host"
        if backend == "device" and self.dtype.byteorder == ">":
            raise ValueError(f"big-endian {self.dtype} has no device fold")
        self.backend = backend
        self.device = resolve_device(device) if backend == "device" else None
        self.device_seconds = 0.0      # staging + fold dispatch + final sync
        self._buf = bytearray()
        self._blocks_done = 0
        self._bytes_seen = 0
        self._stats: Optional[QAStats] = None
        if backend == "device":
            self._carry = initial_carry(self.device)
        else:
            self._s1 = np.uint32(0)
            self._s2 = np.uint32(0)
            self._vmin = np.float32(np.inf)
            self._vmax = np.float32(-np.inf)
            self._vsum = np.float32(0.0)
            self._cnt = 0

    def resume(self, carry: Carry, blocks_done: int, bytes_seen: int,
               tail: bytes):
        """Continue a stream another accumulator began: its carry
        (``(sums int32[2], qa f32[3], cnt int32[1])``), the whole blocks it
        folded, the bytes it was fed and its unfolded tail
        (``repro_torch.convert.accumulator_from_jax``)."""
        if self._bytes_seen or self._blocks_done:
            raise RuntimeError("resume() must come before update()")
        sums, qa, cnt = (torch.as_tensor(c).reshape(-1) for c in carry)
        if self.backend == "device":
            self._carry = tuple(c.to(self.device, copy=True).contiguous()
                                for c in (sums.to(torch.int32),
                                          qa.to(torch.float32),
                                          cnt.to(torch.int32)))
        else:
            s = sums.cpu().numpy().astype(np.int32).view(np.uint32)
            q = qa.cpu().numpy().astype(np.float32)
            self._s1, self._s2 = s[0], s[1]
            self._vmin, self._vmax, self._vsum = q[0], q[1], q[2]
            self._cnt = int(cnt[0])
        self._blocks_done = int(blocks_done)
        self._bytes_seen = int(bytes_seen)
        self._buf = bytearray(tail)

    # -- per-launch plumbing -------------------------------------------------

    def _chunk_arrays(self, chunk: bytes, nblocks: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Block-pad one aligned chunk into (words, vals) for the host fold:
        the same zero-pad + mask discipline as the one-shot kernel, applied
        at the chunk's global offset instead of index 0."""
        vals = np.frombuffer(chunk, dtype=self.dtype)
        want_v = nblocks * self.blk_v
        if vals.size < want_v:
            vals = np.concatenate(
                [vals, np.zeros(want_v - vals.size, self.dtype)])
        wpad = (-len(chunk)) % 4
        words = np.frombuffer(bytes(chunk) + b"\0" * wpad, "<u4")
        want_w = nblocks * self.blk_w
        if words.size < want_w:
            words = np.concatenate(
                [words, np.zeros(want_w - words.size, np.uint32)])
        return words.view(np.int32), vals

    def _fold_device(self, chunk: bytearray, nblocks: int, w0: int, v0: int):
        t0 = time.perf_counter()
        data = torch.frombuffer(chunk, dtype=torch.uint8) if chunk \
            else torch.empty(0, dtype=torch.uint8)
        self._carry = qa_checksum_chunk(
            data.to(self.device), (w0, v0, self.nw, self.n_vals), self._carry,
            dtype=_NP_TO_TORCH[self.dtype.name], blk_v=self.blk_v,
            nblocks=nblocks)
        self.device_seconds += time.perf_counter() - t0

    def _fold_host(self, words: np.ndarray, vals: np.ndarray, w0: int,
                   v0: int):
        """Vectorized numpy twin of the chunk kernel. Integer checksums are
        associative mod 2^32, so whole-chunk sums match the kernel's
        per-block folds bit-for-bit; the float sum keeps the kernel's exact
        shape — per-block halving tree, then one sequential scalar add per
        block in order."""
        t0 = time.perf_counter()
        w = words.view(np.uint32)
        idx = w0 + np.arange(w.size, dtype=np.int64)
        valid_w = idx < self.nw
        with np.errstate(over="ignore"):
            w = np.where(valid_w, w, np.uint32(0))
            pos = np.where(valid_w, (idx % M_POS).astype(np.uint32),
                           np.uint32(0))
            self._s1 = np.uint32(self._s1 + np.sum(w, dtype=np.uint32))
            self._s2 = np.uint32(self._s2 + np.sum(w * pos, dtype=np.uint32))
        nblocks = vals.size // self.blk_v
        v = vals.astype(np.float32).reshape(nblocks, self.blk_v)
        vidx = (v0 + np.arange(vals.size)).reshape(nblocks, self.blk_v)
        finite = np.isfinite(v) & (vidx < self.n_vals)
        self._cnt += int(np.sum(finite))
        self._vmin = np.minimum(self._vmin,
                                np.float32(np.min(np.where(finite, v, np.inf))))
        self._vmax = np.maximum(self._vmax,
                                np.float32(np.max(np.where(finite, v,
                                                           -np.inf))))
        for t in tree_sum_f32(np.where(finite, v, np.float32(0.0))):
            self._vsum = np.float32(self._vsum + t)
        self.device_seconds += time.perf_counter() - t0

    def _process(self, chunk: bytearray, nblocks: int):
        w0 = self._blocks_done * self.blk_w
        v0 = self._blocks_done * self.blk_v
        if self.backend == "device":
            self._fold_device(chunk, nblocks, w0, v0)
        else:
            self._fold_host(*self._chunk_arrays(chunk, nblocks), w0, v0)
        self._blocks_done += nblocks

    # -- public surface ------------------------------------------------------

    def update(self, data: bytes):
        """Fold the next ``data`` bytes of the array's buffer. Whole blocks
        launch at once (asynchronously on ``cuda``); a sub-block tail is
        carried to the next update/finalize."""
        if self._stats is not None:
            raise RuntimeError("accumulator already finalized")
        self._bytes_seen += len(data)
        if self._bytes_seen > self.n_vals * self.itemsize:
            raise ValueError(
                f"stream overrun: fed {self._bytes_seen} bytes for a "
                f"{self.n_vals * self.itemsize}-byte array")
        self._buf += data
        nblocks = len(self._buf) // self.align_bytes
        if nblocks:
            cut = nblocks * self.align_bytes
            self._process(self._buf[:cut], nblocks)
            del self._buf[:cut]

    def finalize(self) -> QAStats:
        """Fold the carried tail (zero-padded + masked exactly like the
        one-shot kernel's final block) and return the whole-array
        :class:`QAStats`. Raises ``ValueError`` if the byte count fed does
        not match the declared array size — a truncated transfer must fail
        verification, not silently pass QA on a prefix."""
        if self._stats is not None:
            return self._stats
        if self._bytes_seen != self.n_vals * self.itemsize:
            raise ValueError(
                f"stream truncated: fed {self._bytes_seen} of "
                f"{self.n_vals * self.itemsize} bytes")
        remaining = self.total_blocks - self._blocks_done
        if remaining:
            self._process(bytearray(self._buf), remaining)
            self._buf.clear()
        if self.backend == "device":
            t0 = time.perf_counter()
            self._stats = QAStats.from_carry(
                *(c.cpu().numpy() for c in self._carry))
            self.device_seconds += time.perf_counter() - t0
        else:
            self._stats = QAStats(int(self._s1), int(self._s2),
                                  float(self._vmin), float(self._vmax),
                                  float(self._vsum), self._cnt)
        return self._stats
