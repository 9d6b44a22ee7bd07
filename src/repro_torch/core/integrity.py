"""Data integrity: checksums on every transfer (paper §2.3).

The paper checksums every storage<->compute copy and kills the job on
mismatch. We provide fletcher64 (fast, used for arrays and files) and sha256
(content addressing), a verified-copy primitive, and array checksums that the
Pallas kernel in ``kernels/checksum`` computes on-device.

Single-pass semantics (the data-plane hot path): every primitive here reads
each byte exactly once.

* :func:`verified_copy` streams src -> dst in one pass, hashing the bytes as
  they move, fsyncs, and commits with an atomic rename — so bytes-hashed per
  byte-moved is 1, not the 3 of the naive hash(src)/copy/hash(dst) dance.
  ``paranoid=True`` adds one extra read of the *destination* to defend
  against a lying disk (2 passes total, still never re-reading the source).
* :func:`fletcher64_file` is genuinely chunked (constant memory) and returns
  the identical value to one-shot :func:`fletcher64` for any chunk size.
* :func:`sha256_load_array` / :func:`sha256_save_array` hash arrays while
  loading/saving them so the workflow engine never does the
  ``sha256_file`` + ``np.load`` double-read.
"""
from __future__ import annotations

import hashlib
import io
import os
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Tuple, Union

import numpy as np


class IntegrityError(RuntimeError):
    """Checksum mismatch — the paper's semantics: terminate the job."""


# ---------------------------------------------------------------------------
# fletcher64
# ---------------------------------------------------------------------------

_MOD = np.uint64(0xFFFFFFFF)
_BLK = 1 << 16          # block the sums so intermediates stay in uint64 range


def _fletcher_update(words: np.ndarray, s1: np.uint64, s2: np.uint64
                     ) -> Tuple[np.uint64, np.uint64]:
    """Fold a word block into running (s1, s2); associative with streaming."""
    for i in range(0, len(words), _BLK):
        blk = words[i:i + _BLK]
        c1 = np.cumsum(blk, dtype=np.uint64)
        s2 = (s2 + np.uint64(len(blk)) * s1 + np.sum(c1, dtype=np.uint64)) % _MOD
        s1 = (s1 + c1[-1]) % _MOD
    return s1, s2


def fletcher64(data: Union[bytes, np.ndarray]) -> int:
    """Fletcher-64 over little-endian uint32 words (zero-padded tail)."""
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    pad = (-len(data)) % 4
    if pad:
        data = data + b"\0" * pad
    words = np.frombuffer(data, dtype="<u4").astype(np.uint64)
    s1 = np.uint64(0)
    s2 = np.uint64(0)
    if len(words):
        s1, s2 = _fletcher_update(words, s1, s2)
    return int((s2 << np.uint64(32)) | s1)


def fletcher64_file(path: Path, chunk: int = 1 << 22) -> int:
    """Streaming fletcher64 of a file: constant memory, one read pass, and
    the identical value to ``fletcher64(path.read_bytes())``."""
    s1 = np.uint64(0)
    s2 = np.uint64(0)
    tail = b""
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            buf = tail + buf
            cut = len(buf) - (len(buf) % 4)
            tail = buf[cut:]
            if cut:
                words = np.frombuffer(buf[:cut], dtype="<u4").astype(np.uint64)
                s1, s2 = _fletcher_update(words, s1, s2)
    if tail:                      # zero-pad the final partial word
        words = np.frombuffer(tail + b"\0" * ((-len(tail)) % 4),
                              dtype="<u4").astype(np.uint64)
        s1, s2 = _fletcher_update(words, s1, s2)
    return int((s2 << np.uint64(32)) | s1)


def sha256_file(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def array_checksum(arr: np.ndarray) -> int:
    return fletcher64(np.ascontiguousarray(arr))


# ---------------------------------------------------------------------------
# single-pass array I/O (hash while moving the bytes)
# ---------------------------------------------------------------------------

@contextmanager
def atomic_commit(path: Path, *, fsync: bool = True):
    """Write-then-rename commit protocol, shared by every writer here.

    Yields ``(file_handle, tmp_path)`` for an exclusive tmp file; on clean
    exit fsyncs and atomically renames onto ``path`` (a concurrent reader
    never sees a torn file; racing writers each commit whole-file, last
    rename wins). On exception the tmp file is removed and ``path`` is
    untouched."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}-{threading.get_ident()}")
    try:
        with open(tmp, "wb") as f:
            yield f, tmp
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def atomic_write_bytes(path: Path, data: bytes, *, fsync: bool = True):
    """Commit ``data`` to ``path`` via :func:`atomic_commit`."""
    with atomic_commit(path, fsync=fsync) as (f, _):
        f.write(data)


def sha256_load_array(path: Path) -> Tuple[np.ndarray, str]:
    """Load a .npy file and its sha256 with ONE read of the file."""
    data = Path(path).read_bytes()
    digest = hashlib.sha256(data).hexdigest()
    arr = np.load(io.BytesIO(data), allow_pickle=False)
    return arr, digest


def sha256_save_array(path: Path, arr: np.ndarray) -> str:
    """Serialize ``arr`` to ``path`` (atomic tmp+rename) and return the
    sha256 of the written bytes — hashed in memory, never re-read."""
    buf = io.BytesIO()
    np.save(buf, arr)
    data = buf.getvalue()
    digest = hashlib.sha256(data).hexdigest()
    atomic_write_bytes(path, data)
    return digest


# ---------------------------------------------------------------------------
# verified copy
# ---------------------------------------------------------------------------

def verified_copy(src: Path, dst: Path, *, paranoid: bool = False,
                  chunk: int = 1 << 20) -> str:
    """Copy with checksum capture in a single streaming pass.

    Reads the source exactly once, hashing each chunk as it is written to a
    temp file; fsyncs and atomically renames onto ``dst`` (a concurrent
    reader never sees a torn file, and racing copies commit whole-file).
    ``paranoid=True`` re-reads the destination once and raises
    :class:`IntegrityError` on mismatch (paper semantics: any mismatch
    terminates the job with an error notification)."""
    src, dst = Path(src), Path(dst)
    dst.parent.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256()
    with atomic_commit(dst) as (fout, tmp):
        with open(src, "rb") as fin:
            while True:
                b = fin.read(chunk)
                if not b:
                    break
                h.update(b)
                fout.write(b)
        digest = h.hexdigest()
        if paranoid:
            fout.flush()
            after = sha256_file(tmp)
            if after != digest:
                raise IntegrityError(
                    f"checksum mismatch copying {src} -> {dst}: "
                    f"wrote {digest}, read back {after}")
    return digest
