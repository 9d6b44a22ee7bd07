"""Streaming chunked ingest: verify bytes *while* they move (paper §2.3).

The paper's headline number is storage↔compute transfer throughput
(0.60 Gb/s lab network vs 0.33 Gb/s cloud), yet load-then-verify ingestion
pays for every byte twice on exactly that axis: once to move it, once more
(on the host, after the transfer finishes) to hash and QA it. Following
Kulkarni et al., *Resource-Efficient Streaming of Large-Scale Medical Image
Datasets* (PAPERS.md), this module chunks the storage→host→device path so
the three verification stages all overlap the transfer itself:

  storage ──chunk──▶ host ──┬─▶ incremental sha256           (integrity)
           (prefetch        ├─▶ fused QA+checksum fold       (device QA)
            thread)         │     kernels/checksum
                            └─▶ host→device chunk staging    (DMA rides the
                                                              fold dispatch)

* **Prefetch overlap** — a reader thread pulls chunk *n+1* off storage
  while chunk *n* is hashed and folded, so the link and the host never wait
  on each other (bounded lookahead: one chunk in flight).
* **Incremental sha256** — the digest provenance records is finished the
  moment the last chunk lands; there is no post-transfer hashing pass.
* **Chunked device QA** — :class:`~repro_torch.kernels.checksum
  .QAChecksumAccumulator` folds each chunk through the fused QA+checksum
  CUDA kernel (s1/s2 transfer checksum + min/max/sum/finite_count carried
  across launches), bit-exact with the one-shot ``qa_stats`` the resident
  path runs. Each fold stages its chunk host→device and launches
  asynchronously; only the final verdict read blocks.
* **Honest fallbacks** — non-npy bytes, unsupported dtypes, Fortran-order
  payloads, or a truncated stream degrade to hash-only (``qa=None``); the
  sha256 is always computed and always identical to the resident path's.

Per-stage wall times land in a :class:`StreamReport` — ``overlap_s`` is the
time the pipeline saved versus running the stages back-to-back — which the
callers stamp into provenance (``stream``) and ``InputCache.stats()``.

Runbook knobs (docs/operating.md): ``REPRO_STREAM_CHUNK_MB`` sizes the
chunk (default 4 MiB), ``REPRO_STREAM_INGEST=0`` disables streaming
everywhere and restores the load-then-verify sequence.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import os
import queue
import threading
import time
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike

STREAM_ENV = "REPRO_STREAM_INGEST"
CHUNK_MB_ENV = "REPRO_STREAM_CHUNK_MB"
DEFAULT_CHUNK_BYTES = 4 << 20
MIN_CHUNK_BYTES = 64 << 10


def stream_enabled() -> bool:
    """Streaming is the default data plane; ``REPRO_STREAM_INGEST=0`` is
    the kill switch back to load-then-verify."""
    return os.environ.get(STREAM_ENV, "1").lower() not in ("0", "", "false")


def stream_chunk_bytes() -> int:
    """Chunk size from ``REPRO_STREAM_CHUNK_MB`` (floored to 64 KiB so the
    per-chunk dispatch overhead cannot swamp the overlap win)."""
    mb = os.environ.get(CHUNK_MB_ENV)
    if not mb:
        return DEFAULT_CHUNK_BYTES
    try:
        return max(int(float(mb) * (1 << 20)), MIN_CHUNK_BYTES)
    except ValueError:
        return DEFAULT_CHUNK_BYTES


@dataclasses.dataclass
class StreamReport:
    """Per-stage wall time of one streamed transfer. ``read_s`` is time on
    the storage (or peer) link, ``hash_s`` host sha256 time, ``device_s``
    chunk staging + QA fold dispatch (plus the final verdict sync);
    ``wall_s`` is end-to-end. Because the stages run overlapped,
    ``overlap_s = read_s + hash_s + device_s - wall_s`` is the time the
    pipeline saved versus running them sequentially (clamped at 0)."""
    nbytes: int = 0
    chunks: int = 0
    chunk_bytes: int = 0
    read_s: float = 0.0
    hash_s: float = 0.0
    device_s: float = 0.0
    wall_s: float = 0.0
    device_qa: bool = False
    files: int = 1

    @property
    def overlap_s(self) -> float:
        return max(0.0, self.read_s + self.hash_s + self.device_s
                   - self.wall_s)

    def to_dict(self) -> dict:
        return {"nbytes": self.nbytes, "chunks": self.chunks,
                "chunk_bytes": self.chunk_bytes, "files": self.files,
                "read_s": round(self.read_s, 6),
                "hash_s": round(self.hash_s, 6),
                "device_s": round(self.device_s, 6),
                "wall_s": round(self.wall_s, 6),
                "overlap_s": round(self.overlap_s, 6),
                "device_qa": self.device_qa}

    @classmethod
    def from_dict(cls, d: dict) -> "StreamReport":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def merge(self, other: "StreamReport"):
        """Fold another transfer's report in (per-unit aggregation across a
        unit's input files)."""
        self.nbytes += other.nbytes
        self.chunks += other.chunks
        self.chunk_bytes = max(self.chunk_bytes, other.chunk_bytes)
        self.read_s += other.read_s
        self.hash_s += other.hash_s
        self.device_s += other.device_s
        self.wall_s += other.wall_s
        self.device_qa = self.device_qa or other.device_qa
        self.files += other.files


# ---------------------------------------------------------------------------
# chunk sources
# ---------------------------------------------------------------------------

def file_chunks(path: Path, chunk_bytes: int) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk_bytes)
            if not b:
                return
            yield b


def bytes_chunks(data: bytes, chunk_bytes: int) -> Iterator[bytes]:
    view = memoryview(data)
    for off in range(0, len(data), chunk_bytes):
        yield bytes(view[off:off + chunk_bytes])
    if not data:
        return


class _Prefetcher:
    """One-chunk-lookahead reader: a daemon thread drains the source
    iterator into a depth-2 queue, timing each pull — chunk *n+1* moves off
    the link while the consumer hashes and folds chunk *n*. Source
    exceptions re-raise at the consumer (a failed read must fail the load,
    not truncate it silently)."""

    _DONE = object()

    def __init__(self, source: Iterable[bytes]):
        self.read_s = 0.0
        self._q: "queue.Queue[object]" = queue.Queue(maxsize=2)
        self._thread = threading.Thread(
            target=self._pump, args=(iter(source),), daemon=True,
            name="stream-prefetch")
        self._thread.start()

    def _pump(self, it: Iterator[bytes]):
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    chunk = next(it)
                except StopIteration:
                    break
                self.read_s += time.perf_counter() - t0
                self._q.put(chunk)
            self._q.put(self._DONE)
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            self._q.put(e)

    def __iter__(self) -> Iterator[bytes]:
        while True:
            got = self._q.get()
            if got is self._DONE:
                return
            if isinstance(got, BaseException):
                raise got
            yield got  # type: ignore[misc]


# ---------------------------------------------------------------------------
# npy header sniffing (for in-flight device QA over the payload)
# ---------------------------------------------------------------------------

def _try_parse_npy_header(buf: bytes
                          ) -> Optional[Tuple[np.dtype, tuple, bool, int]]:
    """``(dtype, shape, fortran_order, payload_offset)`` once ``buf`` holds
    the complete npy header; ``None`` while more bytes are needed. Raises
    ``ValueError`` for bytes that are not an npy file at all."""
    if len(buf) < 10:
        if not b"\x93NUMPY".startswith(buf[:6]):
            raise ValueError("not an npy stream")
        return None
    if buf[:6] != b"\x93NUMPY":
        raise ValueError("not an npy stream")
    major = buf[6]
    if major == 1:
        hlen = int.from_bytes(buf[8:10], "little")
        off = 10 + hlen
    else:
        if len(buf) < 12:
            return None
        hlen = int.from_bytes(buf[8:12], "little")
        off = 12 + hlen
    if len(buf) < off:
        return None
    fp = io.BytesIO(buf[:off])
    version = np.lib.format.read_magic(fp)
    # the public readers: numpy 2.3 dropped the private _read_array_header
    # the reference calls; a 3.0 header (utf-8 field names, never a dtype
    # the fold takes) degrades to hash-only
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(fp)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(fp)
    else:
        raise ValueError(f"npy format {version} is not folded")
    return np.dtype(dtype), tuple(shape), bool(fortran), off


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def stream_chunks(chunks: Iterable[bytes], *, npy_qa: bool = False,
                  chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                  qa_backend: str = "auto", device: DeviceLike = None,
                  prefetch=None,
                  ) -> Tuple[bytes, str, Optional[object], StreamReport]:
    """Drive one transfer through the overlap pipeline.

    Returns ``(data, sha256_hex, qa_stats_or_None, report)``. ``data`` is
    the fully assembled byte string (callers still need the bytes — to
    ``np.load``, to insert into the blob cache, to write to disk); the
    win is that hashing, QA, and device staging happened *during* the
    transfer instead of after it. With ``npy_qa`` the npy header is sniffed
    off the first chunks and the payload folded through
    :class:`~repro_torch.kernels.checksum.QAChecksumAccumulator` on
    ``device`` (``None`` means ``cuda``); anything the
    accumulator cannot fold bit-exactly (non-npy bytes, unsupported dtype,
    Fortran order, truncation) degrades to ``qa=None`` — never an error and
    never a wrong verdict. ``prefetch`` (a :class:`_Prefetcher`) lets
    callers that already own the read thread contribute its link time."""
    t_wall = time.perf_counter()
    h = hashlib.sha256()
    parts: List[bytes] = []
    rep = StreamReport(chunk_bytes=chunk_bytes, device_qa=False)
    acc = None
    qa_dead = not npy_qa
    head = b""                     # buffered prefix until the header parses
    payload_fed = 0                # payload bytes already folded
    payload_off = 0
    n_payload = 0
    for chunk in chunks:
        parts.append(chunk)
        rep.chunks += 1
        rep.nbytes += len(chunk)
        t0 = time.perf_counter()
        h.update(chunk)
        rep.hash_s += time.perf_counter() - t0
        if qa_dead:
            continue
        if acc is None:
            head += chunk
            try:
                parsed = _try_parse_npy_header(head)
            except ValueError:
                qa_dead = True
                head = b""
                continue
            if parsed is None:
                continue
            dtype, shape, fortran, payload_off = parsed
            n_vals = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if fortran or dtype.hasobject:
                qa_dead = True
                head = b""
                continue
            try:
                from ..kernels.checksum import QAChecksumAccumulator
                acc = QAChecksumAccumulator(n_vals, dtype,
                                            backend=qa_backend,
                                            device=device)
            except ValueError:         # dtype the fold can't do bit-exactly
                qa_dead = True
                head = b""
                continue
            n_payload = n_vals * dtype.itemsize
            chunk = head[payload_off:]
            head = b""
        try:
            take = chunk[:n_payload - payload_fed]
            if take:
                acc.update(take)
                payload_fed += len(take)
        except ValueError:             # overrun vs the declared shape
            qa_dead = True
            acc = None
    qa = None
    if acc is not None:
        try:
            qa = acc.finalize()
            rep.device_s += acc.device_seconds
            rep.device_qa = True
        except ValueError:             # truncated vs the declared shape
            qa = None
    if prefetch is not None:
        rep.read_s += prefetch.read_s
    rep.wall_s = time.perf_counter() - t_wall
    return b"".join(parts), h.hexdigest(), qa, rep


def stream_file(path: Path, *, chunk_bytes: Optional[int] = None,
                npy_qa: bool = False, qa_backend: str = "auto",
                device: DeviceLike = None
                ) -> Tuple[bytes, str, Optional[object], StreamReport]:
    """Stream one file off storage through the overlap pipeline — the
    drop-in for ``read_bytes()`` + ``sha256(data)`` (+ one-shot QA). The
    digest is byte-identical to the resident path's."""
    cb = chunk_bytes or stream_chunk_bytes()
    pf = _Prefetcher(file_chunks(Path(path), cb))
    return stream_chunks(pf, npy_qa=npy_qa, chunk_bytes=cb,
                         qa_backend=qa_backend, device=device, prefetch=pf)


def stream_load_npy(path: Path, *, chunk_bytes: Optional[int] = None,
                    device_qa: bool = False, qa_backend: str = "auto",
                    device: DeviceLike = None
                    ) -> Tuple[np.ndarray, str, Optional[object],
                               StreamReport]:
    """Verify-and-load an .npy with the digest (and optionally the fused
    QA+checksum verdict) computed in-flight: the streaming twin of
    :func:`repro_torch.core.integrity.sha256_load_array` — same
    ``(array, digest)`` contract, no post-transfer hashing pass."""
    data, digest, qa, rep = stream_file(path, chunk_bytes=chunk_bytes,
                                        npy_qa=device_qa,
                                        qa_backend=qa_backend,
                                        device=device)
    arr = np.load(io.BytesIO(data), allow_pickle=False)
    return arr, digest, qa, rep


def stream_verify_bytes(data: bytes, *, chunk_bytes: Optional[int] = None,
                        npy_qa: bool = True, qa_backend: str = "auto",
                        device: DeviceLike = None
                        ) -> Tuple[str, Optional[object], StreamReport]:
    """Chunk an in-memory buffer through the pipeline (the ingest path:
    the serialized volume is already on the host, but sha256, the QA fold,
    and device staging still run per-chunk — on an accelerator the fold
    launch overlaps the next chunk's hashing). Returns
    ``(sha256_hex, qa_stats_or_None, report)``."""
    cb = chunk_bytes or stream_chunk_bytes()
    _, digest, qa, rep = stream_chunks(bytes_chunks(data, cb), npy_qa=npy_qa,
                                       chunk_bytes=cb, qa_backend=qa_backend,
                                       device=device)
    return digest, qa, rep
