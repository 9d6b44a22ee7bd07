"""Per-host content-addressed input cache for the cluster data plane.

The paper's cost argument rests on keeping storage->compute transfer fast
(0.60 Gb/s over the lab network vs 0.33 Gb/s from cloud storage); once nodes
are real machines behind ``repro_torch.dist.rpc``, every input fetch
crosses that link. This cache makes repeated fetches free: a work unit whose
inputs were already pulled by *any* prior lease on the host — a retried
unit, a stolen unit whose neighbour shares a subject, a speculative twin —
hits node-local disk instead of shared storage.

Design:

* **Content-addressed blobs.** A cached file is stored once under the sha256
  of its bytes (``<cache>/blobs/<digest>``), so two source paths with equal
  content share one blob, and the digest a hit returns is byte-for-byte the
  digest the provenance records (``inputs: path -> sha256``).
* **Source index.** Lookups key on ``abspath:size:mtime_ns`` of the shared-
  storage file — anything cheaper than reading the bytes — mapping to the
  content digest. A source file whose rewrite changes its size or mtime
  gets a new key, so its stale blob is never served (the old blob ages out
  via LRU). The residual window is a same-size in-place rewrite within the
  storage filesystem's mtime granularity (coarse on NFS/FAT) — served bytes
  still match the *recorded* checksum, so provenance stays self-consistent,
  but archive-discipline (no in-place mutation of inputs) is what rules the
  window out; see the caveat in ``docs/operating.md``.
* **Verified hits.** A hit re-hashes the local bytes and falls back to a
  miss (dropping the blob) on mismatch — a corrupted cache degrades to
  shared-storage reads, never to wrong data. One read per byte either way,
  the same single-pass discipline as :mod:`repro_torch.core.integrity`.
* **Size-bounded LRU.** Total blob bytes are capped at ``max_bytes``;
  inserting past the cap evicts least-recently-used blobs. The source index
  persists as an append-only JSON-lines journal (O(1) per insert; compacted
  atomically on eviction, torn tail lines skipped on load) so a restarted
  worker re-uses the host's warm cache.
* **Device QA.** ``fetch_array(device_qa=True)`` folds a storage miss
  through the fused QA+checksum kernel (K2) on the cache's ``device``
  (``None`` means ``cuda``) while the bytes stream; without it no device is
  touched.
* **Peer fabric.** With a :class:`~repro_torch.dist.blobserve.PeerFabric`
  attached, a local miss whose content digest is known from the manifest
  first asks the coordinator which warm peer already holds that blob and
  streams it over the node-to-node link instead of the shared-storage choke
  point — the paper's 0.60 Gb/s storage link becomes a last resort, not the
  only path. Peer bytes are sha256-re-verified on arrival and every failure
  (dead peer, timeout, Bloom false positive, digest mismatch) falls back to
  the storage read, so correctness is never routed through the fabric.
* **Pinned reads.** Blob reads — local hits and peer serves alike — hold a
  refcount pin for the duration of the read, and ``_evict_to_budget`` skips
  pinned blobs (temporarily overshooting the byte budget rather than
  unlinking a file a concurrent reader has open).
* **Digest summary.** The cache maintains a :class:`DigestSummary` — a
  counting Bloom filter over the blob sha256s, updated on every insert and
  evict — that serializes to a few KB no matter how many blobs the host
  holds. Nodes push it (full on join, deltas piggybacked on heartbeats) to
  the coordinator, whose :class:`~repro_torch.dist.queue.WorkQueue` scores
  candidate units by estimated cache-local bytes and places work where its
  inputs already live. That turns this cache from a lucky retry win into a
  placement policy (see the placement-policy section of ``docs/cluster.md``).

Thread-safe: one lock guards index + LRU state; nodes sharing a host (and a
cache dir) within a process share one :class:`InputCache`. Cross-process
sharing of a cache dir is safe for blobs (content-addressed, atomically
committed) with last-writer-wins on the index — the loser's entries are
re-fetched, never corrupted.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import secrets
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from pathlib import Path
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..core import stream as stream_mod
from ..core.integrity import atomic_write_bytes
from ..device import DeviceLike

# Runbook knobs (docs/operating.md): where the host cache lives and how big
# it may grow. Read by the worker CLI (repro_torch.dist.rpc) and
# ClusterRunner.
CACHE_DIR_ENV = "REPRO_CACHE_DIR"
CACHE_MAX_MB_ENV = "REPRO_CACHE_MAX_MB"
DEFAULT_MAX_BYTES = 1 << 30          # 1 GiB per host


def cache_from_env(default_dir: Optional[Path] = None) -> Optional["InputCache"]:
    """Build an :class:`InputCache` from the runbook env knobs; ``None`` when
    no cache dir is configured (cold path: every fetch hits shared storage)."""
    root = os.environ.get(CACHE_DIR_ENV) or default_dir
    if not root:
        return None
    max_mb = os.environ.get(CACHE_MAX_MB_ENV)
    max_bytes = int(float(max_mb) * 2**20) if max_mb else DEFAULT_MAX_BYTES
    if max_bytes <= 0:
        return None                  # a zero budget means "no cache", not a crash
    return InputCache(Path(root), max_bytes=max_bytes)


SUMMARY_WIRE_VERSION = 1     # bump when the summary wire shape changes;
                             # receivers ignore versions they don't speak
                             # (locality-blind fallback, never a crash)

# retained per-cache op-log window: a consumer whose cursor fell further
# behind than this gets a full summary instead of a delta
SUMMARY_OPS_RETAINED = 4096

# Bloom positions require a sha256 of the digest *string*; the coordinator
# probes the same unit digests against every node's summary on every grant,
# so memoize the hash bytes process-wide (positions are then one cheap mod
# per cell). Bounded by wholesale clear; GIL makes the get/set race benign —
# a lost write just re-hashes once.
_DIGEST_HASH_CACHE: Dict[str, bytes] = {}
_DIGEST_HASH_CACHE_MAX = 1 << 16


def _digest_hash(digest: str) -> bytes:
    h = _DIGEST_HASH_CACHE.get(digest)
    if h is None:
        if len(_DIGEST_HASH_CACHE) >= _DIGEST_HASH_CACHE_MAX:
            _DIGEST_HASH_CACHE.clear()
        h = hashlib.sha256(digest.encode()).digest()
        _DIGEST_HASH_CACHE[digest] = h
    return h


class DigestSummary:
    """Counting Bloom filter over blob content digests.

    The compact "what does this host hold" answer the coordinator needs for
    locality-aware placement: ``d in summary`` is *probably in the cache*
    (false positives at the usual Bloom rate, never false negatives for
    balanced add/discard), costs O(k), and the whole structure serializes to
    a few KB regardless of blob count. Counting (not bit) cells make
    evictions removable, so one summary tracks a churning LRU cache for the
    life of the host.

    Positions are derived by re-hashing the digest string (sha256 of its
    UTF-8 bytes, k 4-byte windows mod m) — uniform for any key, including
    non-hex test digests. Not thread-safe on its own; :class:`InputCache`
    mutates it under its lock, and the coordinator under the queue lock.
    """

    def __init__(self, m: int = 8192, k: int = 4):
        if m <= 0 or k <= 0 or 4 * k > 32:
            raise ValueError(f"bad summary geometry m={m} k={k}")
        self.m = int(m)
        self.k = int(k)
        self._counts: List[int] = [0] * self.m
        self._n = 0                          # distinct adds currently held

    def _positions(self, digest: str) -> List[int]:
        raw = _digest_hash(digest)
        return [int.from_bytes(raw[4 * i:4 * i + 4], "big") % self.m
                for i in range(self.k)]

    def add(self, digest: str):
        for p in self._positions(digest):
            if self._counts[p] < 0xFFFF:     # saturate, never wrap
                self._counts[p] += 1
        self._n += 1

    def discard(self, digest: str):
        """Remove one prior ``add``. A discard for a digest never added is a
        no-op (decrementing would manufacture false negatives elsewhere)."""
        pos = self._positions(digest)
        if any(self._counts[p] == 0 for p in pos):
            return
        for p in pos:
            self._counts[p] -= 1
        self._n = max(0, self._n - 1)

    def __contains__(self, digest: str) -> bool:
        return all(self._counts[p] > 0 for p in self._positions(digest))

    def __len__(self) -> int:
        return self._n

    def to_wire(self) -> dict:
        """Sparse JSON encoding: only non-zero cells travel, so an empty or
        lightly-loaded summary is tens of bytes and a full one a few KB."""
        return {"v": SUMMARY_WIRE_VERSION, "m": self.m, "k": self.k,
                "n": self._n,
                "nz": [[i, c] for i, c in enumerate(self._counts) if c]}

    @classmethod
    def from_wire(cls, wire: object) -> Optional["DigestSummary"]:
        """Decode a :meth:`to_wire` payload; ``None`` for anything this
        version doesn't speak — the caller falls back to locality-blind."""
        if not isinstance(wire, dict) or wire.get("v") != SUMMARY_WIRE_VERSION:
            return None
        try:
            s = cls(int(wire["m"]), int(wire["k"]))
            for i, c in wire["nz"]:
                s._counts[int(i)] = min(0xFFFF, max(0, int(c)))
            s._n = max(0, int(wire.get("n", 0)))
            return s
        except (KeyError, TypeError, ValueError, IndexError):
            return None


class InputCache:
    """sha256-keyed, size-bounded LRU blob cache on node-local disk."""

    def __init__(self, root: Path, *, max_bytes: int = DEFAULT_MAX_BYTES,
                 device: DeviceLike = None):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        self.root = Path(root)
        # where fetch_array(device_qa=True) folds the QA kernel (None: cuda)
        self.device = device
        self.blob_dir = self.root / "blobs"
        self.blob_dir.mkdir(parents=True, exist_ok=True)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._index: Dict[str, str] = {}              # source key -> digest
        self._blobs: "OrderedDict[str, int]" = OrderedDict()  # digest -> bytes (LRU)
        self._total = 0                               # running blob byte total
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_from_cache = 0     # blob bytes served locally (hits)
        self.bytes_from_storage = 0   # bytes that crossed the storage link
        self.bytes_from_peer = 0      # bytes that crossed a node-to-node link
        self.peer_hits = 0            # misses satisfied by a warm peer
        self.peer_serves = 0          # blob reads served TO peers (blobserve)
        self.bytes_to_peers = 0
        self.storage_seconds = 0.0    # wall time on the storage link (misses)
        self.peer_seconds = 0.0       # wall time on peer links (fetch side)
        # streaming-ingest meters (repro_torch.core.stream): misses whose
        # digest was computed chunk-by-chunk while the bytes moved, and the wall
        # time the overlap pipeline saved versus a load-then-hash sequence
        self.stream_fetches = 0
        self.stream_bytes = 0
        self.stream_chunks = 0
        self.stream_hash_seconds = 0.0
        self.stream_device_seconds = 0.0
        self.stream_overlap_seconds = 0.0
        self._peer_bytes_by_addr: Dict[str, int] = {}   # per-link byte meter
        # optional PeerFabric (repro_torch.dist.blobserve): when attached,
        # misses with a manifest digest hint try warm peers before storage
        self.fabric = None
        self._pins: Dict[str, int] = {}     # digest -> open-reader refcount
        # digest summary + op log for locality-aware placement: every blob
        # insert/evict lands in the summary and in a bounded op window that
        # nodes drain as heartbeat-piggybacked deltas (multiple nodes sharing
        # one host cache each keep their own cursor; a cursor that falls off
        # the window triggers a full re-sync instead)
        self.summary = DigestSummary()
        self._ops: Deque[Tuple[int, str, str]] = deque()   # (seq, op, digest)
        # op seqs start at a per-life random base: a consumer's cursor from
        # a previous cache life (wiped dir, counter reset) can then never
        # alias into this life's seq range, so a cross-life delta request
        # degrades to a full resync instead of silently serving a partial
        # delta that leaves the consumer's summary drifted forever
        self._seq = secrets.randbits(48)
        self._load_persisted()

    # -- persistence ---------------------------------------------------------
    # append-only JSON-lines journal: O(1) write per insert (a full-index
    # rewrite per miss would make cold runs O(n^2)), last entry per key wins
    # on load, compacted to the live set whenever eviction shrinks it

    def _index_path(self) -> Path:
        return self.root / "index.jsonl"

    def _load_persisted(self):
        """Adopt blobs + index left by a previous worker on this host."""
        persisted: Dict[str, str] = {}
        try:
            for line in self._index_path().read_text().splitlines():
                try:
                    entry = json.loads(line)
                    persisted[entry["k"]] = entry["d"]
                except (json.JSONDecodeError, KeyError, TypeError):
                    continue             # torn tail line from a crash: skip
        except OSError:
            pass
        found = []
        for p in self.blob_dir.iterdir():
            if p.name.startswith("."):           # in-flight atomic-write tmps
                continue
            try:                                 # concurrent evict/rename race
                st = p.stat()
            except OSError:
                continue
            found.append((st.st_mtime, p.name, st.st_size))
        for _, name, size in sorted(found):      # oldest first = LRU order
            self._blobs[name] = size
            self.summary.add(name)
        self._total = sum(self._blobs.values())
        self._index = {k: d for k, d in persisted.items() if d in self._blobs}

    def _append_index(self, key: str, digest: str):
        with open(self._index_path(), "a") as f:
            f.write(json.dumps({"k": key, "d": digest}) + "\n")

    def _compact_index(self):
        lines = "".join(json.dumps({"k": k, "d": d}) + "\n"
                        for k, d in self._index.items())
        atomic_write_bytes(self._index_path(), lines.encode(), fsync=False)

    # -- core ----------------------------------------------------------------

    @staticmethod
    def _source_key(path: Path) -> Optional[str]:
        try:
            st = os.stat(path)
        except OSError:
            return None
        return f"{os.path.abspath(path)}:{st.st_size}:{st.st_mtime_ns}"

    def _blob_path(self, digest: str) -> Path:
        return self.blob_dir / digest

    def _record_op(self, op: str, digest: str):
        """Caller holds the lock: mirror a blob insert/evict into the digest
        summary and the bounded delta window nodes drain for the coordinator."""
        (self.summary.add if op == "add" else self.summary.discard)(digest)
        self._seq += 1
        self._ops.append((self._seq, op, digest))
        while len(self._ops) > SUMMARY_OPS_RETAINED:
            self._ops.popleft()

    def _evict_to_budget(self, evicted_out: List[str]) -> bool:
        """Caller holds the lock. Drops LRU entries from the in-memory state
        and appends their digests to ``evicted_out`` — the caller unlinks the
        files *after* releasing the lock (disk I/O never blocks peers).
        Pinned blobs (a concurrent local read or peer serve in flight) are
        never victims: the cache overshoots its byte budget until the pin is
        released rather than unlink a file a reader has open."""
        evicted = False
        while self._total > self.max_bytes:
            victim = next((d for d in self._blobs if d not in self._pins),
                          None)
            if victim is None:
                break                # every resident blob is mid-read
            size = self._blobs.pop(victim)
            self._total -= size
            evicted_out.append(victim)
            self.evictions += 1
            self._record_op("drop", victim)
            evicted = True
        if evicted:
            live = set(self._blobs)
            self._index = {k: d for k, d in self._index.items() if d in live}
        return evicted

    # -- pinned blob reads (local hits and the peer-serving path) ------------

    def pin(self, digest: str) -> bool:
        """Take a refcount hold on ``digest`` so eviction cannot unlink its
        file while a read is in flight. ``False`` (no pin taken) when the
        blob is not resident."""
        with self._lock:
            if digest not in self._blobs:
                return False
            self._pins[digest] = self._pins.get(digest, 0) + 1
            return True

    def unpin(self, digest: str):
        with self._lock:
            n = self._pins.get(digest, 0) - 1
            if n > 0:
                self._pins[digest] = n
            else:
                self._pins.pop(digest, None)

    @contextmanager
    def hold(self, digest: str):
        """Context-managed :meth:`pin`; yields whether the hold was taken."""
        ok = self.pin(digest)
        try:
            yield ok
        finally:
            if ok:
                self.unpin(digest)

    def read_blob(self, digest: str) -> Optional[bytes]:
        """Raw blob bytes for the peer-serving path
        (:class:`repro_torch.dist.blobserve.BlobServer`), pinned for the
        duration of the read so :meth:`_evict_to_budget` cannot unlink the file
        mid-serve. ``None`` when the blob is not resident — the requester's
        Bloom summary gave a false positive (or the summary is stale) and it
        falls back to shared storage. The *receiving* side re-verifies the
        sha256, so this path serves bytes without re-hashing them."""
        if not self.pin(digest):
            return None
        try:
            data = self._blob_path(digest).read_bytes()
        except OSError:
            return None
        finally:
            self.unpin(digest)
        with self._lock:
            if digest in self._blobs:
                self._blobs.move_to_end(digest)      # a served blob is warm
            self.peer_serves += 1
            self.bytes_to_peers += len(data)
        return data

    def attach_fabric(self, fabric):
        """Attach a :class:`repro_torch.dist.blobserve.PeerFabric`;
        subsequent misses with a manifest digest hint try warm peers before
        storage. The fabric rides the cache handle, so every call site that
        already passes ``cache=`` (workflow, cluster, retries that distrust
        the cache after attempt 1) inherits the peer path with no new
        plumbing."""
        self.fabric = fabric

    @staticmethod
    def _read_storage(src: Path) -> bytes:
        """The one seam every shared-storage read crosses. Benchmarks
        monkeypatch this to model the paper's 0.60 Gb/s storage link without
        faking the peer path; production never overrides it."""
        return Path(src).read_bytes()

    def _storage_chunks(self, src: Path, chunk_bytes: int):
        """Chunked twin of :meth:`_read_storage` for the streaming data
        plane (``repro_torch.core.stream``): yields the file's bytes in
        ``chunk_bytes`` pieces so hashing and QA can overlap the transfer.
        When a benchmark (or test) has monkeypatched ``_read_storage`` to
        model the storage link, that seam is honored — its whole-file
        result is re-chunked, so the modeled link cost still lands on the
        read stage — and benchmarks that model a *chunked* link override
        this method directly."""
        rs = self._read_storage
        if rs is not _DEFAULT_READ_STORAGE:
            yield from stream_mod.bytes_chunks(rs(src), chunk_bytes)
        else:
            yield from stream_mod.file_chunks(Path(src), chunk_bytes)

    def _insert_blob(self, digest: str, data: bytes, key: Optional[str]):
        """Commit ``data`` as blob ``digest``, map ``key`` to it (when
        given), then evict down to budget. The multi-MB blob write happens
        OUTSIDE the lock — it must not serialize the other prefetch threads'
        fetches. Content addressing + atomic rename make a racing duplicate
        writer idempotent (same bytes, last rename wins)."""
        with self._lock:
            known = digest in self._blobs
        if not known:
            atomic_write_bytes(self._blob_path(digest), data, fsync=False)
        evict: List[str] = []
        with self._lock:
            if digest not in self._blobs:
                self._total += len(data)
                self._record_op("add", digest)
            self._blobs[digest] = len(data)
            self._blobs.move_to_end(digest)
            if key:
                self._index[key] = digest
            if self._evict_to_budget(evict):
                self._compact_index()
            elif key:
                self._append_index(key, digest)
        for d in evict:                          # unlinks, after the lock
            self._blob_path(d).unlink(missing_ok=True)

    def fetch_array(self, src: Path, *, digest_hint: Optional[str] = None,
                    size_hint: Optional[int] = None,
                    device_qa: bool = False,
                    ) -> Tuple[np.ndarray, str, str, int, Optional[dict]]:
        """Load the .npy at ``src``, serving from the host cache when its
        bytes are already local. Returns
        ``(array, sha256, origin, nbytes, stream)`` where ``origin`` is
        ``"cache"`` (local blob hit), ``"peer"`` (blob streamed from a warm
        peer over the fabric) or ``"storage"`` (shared storage read) — the
        digest is of the file content in every case, so provenance input
        checksums are identical across origins, and ``nbytes`` is the file
        size that moved over (or stayed off) each link. ``stream`` is the
        :class:`repro_torch.core.stream.StreamReport` dict for a
        chunk-streamed storage miss (digest — and with ``device_qa`` the
        fused QA fold on the cache's ``device`` — computed while the bytes
        moved; see ``REPRO_STREAM_INGEST``), else ``None``. On a local miss,
        a manifest ``digest_hint`` plus an attached fabric tries the warmest
        peer first; any peer failure falls back to one storage read, after
        which the bytes are inserted locally (then evicted down to
        ``max_bytes``). ``size_hint`` (the manifest's byte count) guards the
        peer path against a source file rewritten since the manifest scan:
        on size disagreement the fetch goes straight to storage so it
        observes the current bytes."""
        src = Path(src)
        key = self._source_key(src)
        with self._lock:
            digest = self._index.get(key) if key else None
            pinned = False
            if digest is not None and digest in self._blobs:
                # pin under the same lock that resolved the index entry, so
                # eviction cannot unlink the file before read_bytes opens it
                self._pins[digest] = self._pins.get(digest, 0) + 1
                pinned = True
        if digest is not None:
            try:
                data = self._blob_path(digest).read_bytes()
            except OSError:
                data = None
            finally:
                if pinned:
                    self.unpin(digest)
            if data is not None and hashlib.sha256(data).hexdigest() == digest:
                with self._lock:
                    if digest in self._blobs:
                        self._blobs.move_to_end(digest)       # LRU touch
                    self.hits += 1
                    self.bytes_from_cache += len(data)
                return (np.load(io.BytesIO(data), allow_pickle=False),
                        digest, "cache", len(data), None)
            with self._lock:                # corrupt or vanished blob: drop it
                size = self._blobs.pop(digest, None)
                if size is not None:
                    self._total -= size
                    self._record_op("drop", digest)
                self._blob_path(digest).unlink(missing_ok=True)
                self._index = {k: d for k, d in self._index.items()
                               if d != digest}
        # local miss: try the peer fabric before touching the storage link.
        # The fabric re-verifies sha256(data) == digest_hint before handing
        # bytes back, so a lying or corrupted peer degrades to the storage
        # read below, never to wrong data.
        st_size: Optional[int] = None
        try:
            st_size = os.stat(src).st_size
        except OSError:
            pass                 # storage blip: the peer path may still save us
        fabric = self.fabric
        if (fabric is not None and digest_hint
                and (size_hint is None or st_size is None
                     or st_size == size_hint)):
            t0 = time.perf_counter()
            got = fabric.fetch(digest_hint)
            dt = time.perf_counter() - t0
            arr = None
            if got is not None:
                data, addr = got
                try:
                    arr = np.load(io.BytesIO(data), allow_pickle=False)
                except Exception:        # manifest digest of a non-npy: fall back
                    arr = None
            with self._lock:
                self.peer_seconds += dt
                if arr is not None:
                    self.misses += 1     # still a *local* miss
                    self.peer_hits += 1
                    self.bytes_from_peer += len(data)
                    self._peer_bytes_by_addr[addr] = (
                        self._peer_bytes_by_addr.get(addr, 0) + len(data))
            if arr is not None:
                if len(data) <= self.max_bytes:
                    # map the source key only when the file on storage still
                    # matches the fetched size — a stale manifest must not
                    # alias a rewritten source onto old content
                    self._insert_blob(digest_hint, data,
                                      key if st_size == len(data) else None)
                return arr, digest_hint, "peer", len(data), None
        # storage: one pass over the shared link. With streaming on (the
        # default) the bytes cross chunk-by-chunk and the sha256 — plus,
        # when asked, the fused device QA fold — runs *while* they move; a
        # prefetch thread keeps the link busy during each chunk's hashing.
        # REPRO_STREAM_INGEST=0 restores the read-then-hash sequence.
        stream_info: Optional[dict] = None
        t0 = time.perf_counter()
        if stream_mod.stream_enabled():
            cb = stream_mod.stream_chunk_bytes()
            pf = stream_mod._Prefetcher(self._storage_chunks(src, cb))
            data, digest, _qa, rep = stream_mod.stream_chunks(
                pf, npy_qa=device_qa, chunk_bytes=cb, device=self.device,
                prefetch=pf)
            stream_info = rep.to_dict()
        else:
            data = self._read_storage(src)
            digest = hashlib.sha256(data).hexdigest()
            rep = None
        dt = time.perf_counter() - t0
        arr = np.load(io.BytesIO(data), allow_pickle=False)
        with self._lock:
            self.misses += 1
            self.bytes_from_storage += len(data)
            self.storage_seconds += dt
            if rep is not None:
                self.stream_fetches += 1
                self.stream_bytes += rep.nbytes
                self.stream_chunks += rep.chunks
                self.stream_hash_seconds += rep.hash_s
                self.stream_device_seconds += rep.device_s
                self.stream_overlap_seconds += rep.overlap_s
        if len(data) > self.max_bytes:
            # an input bigger than the whole budget can never be served
            # later; inserting it would wipe every warm blob on the host
            # (and re-wipe on each fetch) for nothing — pass it through
            return arr, digest, "storage", len(data), stream_info
        self._insert_blob(digest, data, key)
        return arr, digest, "storage", len(data), stream_info

    def put_bytes(self, data: bytes, *, digest: Optional[str] = None,
                  source: Optional[Path] = None) -> Optional[str]:
        """Write-through insertion: commit ``data`` as a content-addressed
        blob without a fetch having missed first. This is how pipeline
        *outputs* land in the producer host's cache the moment their
        provenance commits, so a DAG child scheduled on the same host
        (producer placement, ``repro_torch.core.campaign``) hits local blobs
        instead of re-reading shared storage. ``source`` additionally maps
        the committed file's source key to the blob, making a later
        ``fetch_array`` of that exact path a direct hit; ``digest`` (when
        the caller already hashed the bytes, e.g. ``sha256_save_array``)
        skips re-hashing. Returns the digest, or ``None`` for data bigger
        than the whole budget (same passthrough rule as ``fetch_array`` —
        inserting it would wipe every warm blob for nothing)."""
        if len(data) > self.max_bytes:
            return None
        d = digest or hashlib.sha256(data).hexdigest()
        key = self._source_key(Path(source)) if source is not None else None
        self._insert_blob(d, data, key)
        return d

    # -- digest-summary sync (locality-aware placement) ----------------------

    def _stats_locked(self) -> Dict[str, object]:
        st: Dict[str, object] = {
            "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions,
            "bytes": self._total, "blobs": len(self._blobs),
            "bytes_from_cache": self.bytes_from_cache,
            "bytes_from_storage": self.bytes_from_storage,
            "bytes_from_peer": self.bytes_from_peer,
            "peer_hits": self.peer_hits,
            "peer_serves": self.peer_serves,
            "bytes_to_peers": self.bytes_to_peers,
            "storage_seconds": self.storage_seconds,
            "peer_seconds": self.peer_seconds,
            "stream_fetches": self.stream_fetches,
            "stream_bytes": self.stream_bytes,
            "stream_chunks": self.stream_chunks,
            "stream_hash_seconds": self.stream_hash_seconds,
            "stream_device_seconds": self.stream_device_seconds,
            "stream_overlap_seconds": self.stream_overlap_seconds,
            "peer_false_positives": 0,
            # per-link byte meter: {peer addr -> bytes fetched from it};
            # travels with the stats so WorkQueue.stats_snapshot can expose
            # cluster-wide link utilisation (numeric roll-ups skip it)
            "peer_bytes_by_addr": dict(self._peer_bytes_by_addr)}
        if self.fabric is not None:
            st.update(self.fabric.counters())
        return st

    # full-push wires list exact digests up to this many blobs (64-hex chars
    # each: 64k blobs ≈ 4 MiB, inside the rpc frame cap); a larger cache
    # omits the list and the coordinator's warm-set index rebuild falls back
    # to probing the Bloom filter, exactly the pre-list behaviour
    SUMMARY_DIGEST_LIST_CAP = 65536

    def summary_sync(self) -> Tuple[int, dict]:
        """Full summary push: ``(cursor, wire)`` where the wire carries the
        whole Bloom filter, an exact ``digests`` list (capped; lets the
        coordinator rebuild its warm-set index without Bloom false
        positives — old coordinators ignore the unknown key), plus current
        cache stats. A node sends this once on join
        (``register``/``put_summary``) and keeps ``cursor`` to drain deltas
        from."""
        with self._lock:
            wire = {"v": SUMMARY_WIRE_VERSION,
                    "full": self.summary.to_wire(),
                    "stats": self._stats_locked()}
            if len(self._blobs) <= self.SUMMARY_DIGEST_LIST_CAP:
                wire["digests"] = sorted(self._blobs)
            return self._seq, wire

    def summary_delta_since(self, cursor: int) -> Tuple[int, dict]:
        """Heartbeat piggyback: ``(new_cursor, wire)``. The wire carries the
        blob digests added/dropped since ``cursor`` (typically empty or a
        handful — bytes, not KB) and always the live stats counters. A
        cursor that fell off the retained op window degrades to a full
        summary, so a long-asleep node resyncs instead of drifting."""
        with self._lock:
            stats = self._stats_locked()
            # a delta is complete only for a cursor contiguous with the
            # retained window: within [oldest_seq - 1, seq] (with no ops
            # retained, exactly seq). Anything else — fell off the window,
            # ahead of the counter, or a cursor from a previous cache life
            # (the random per-life seq base makes those land outside the
            # range) — degrades to a full resync, never a partial delta
            oldest = self._ops[0][0] if self._ops else self._seq + 1
            if cursor > self._seq or cursor < oldest - 1:
                return self._seq, {"v": SUMMARY_WIRE_VERSION,
                                   "full": self.summary.to_wire(),
                                   "stats": stats}
            add = [d for seq, op, d in self._ops if seq > cursor and op == "add"]
            drop = [d for seq, op, d in self._ops if seq > cursor and op == "drop"]
            return self._seq, {"v": SUMMARY_WIRE_VERSION, "add": add,
                               "drop": drop, "stats": stats}

    # -- introspection -------------------------------------------------------

    def total_bytes(self) -> int:
        with self._lock:
            return self._total

    def blob_count(self) -> int:
        with self._lock:
            return len(self._blobs)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return self._stats_locked()


# Captured at import so ``_storage_chunks`` can tell whether a benchmark or
# test has monkeypatched the ``_read_storage`` seam (the modeled link then
# keeps its cost, re-chunked).
_DEFAULT_READ_STORAGE = InputCache._read_storage


# ---------------------------------------------------------------------------
# serialized summaries: the offline half of campaign planning
# ---------------------------------------------------------------------------
# A live coordinator serves per-node summaries over rpc
# (``WorkQueue.summaries_snapshot``); on an HPC login node there is no live
# coordinator, only last night's cache directories on each host. These
# helpers make summaries a file-shaped artifact: harvest them from cache
# dirs, ship one JSON to wherever ``repro_torch.core.campaign`` plans the next
# job array, and load them back — same versioned wire either way, so the
# planner cannot tell (and does not care) whether its view came off a
# socket or a filesystem.

def harvest_summary(cache_dir: Path) -> Optional[dict]:
    """The full summary wire for one host's persisted cache directory, by
    adopting its blobs exactly as a restarted worker would. ``None`` for a
    path that is not a cache dir (no ``blobs/``) — callers skip, not crash."""
    cache_dir = Path(cache_dir)
    if not (cache_dir / "blobs").is_dir():
        return None
    _, wire = InputCache(cache_dir).summary_sync()
    return wire


def summaries_from_cache_dirs(root: Path) -> Dict[str, dict]:
    """``{node_id: summary wire}`` for every ``<root>/<node_id>`` cache dir
    — the per-node layout ``ClusterRunner(cache_per_node=True)`` writes and
    a multi-host fleet mirrors one level up. Sorted for determinism."""
    root = Path(root)
    out: Dict[str, dict] = {}
    if not root.is_dir():
        return out
    for child in sorted(p for p in root.iterdir() if p.is_dir()):
        wire = harvest_summary(child)
        if wire is not None:
            out[child.name] = wire
    return out


def save_summary_file(path: Path, summaries: Dict[str, object]) -> Path:
    """Serialize ``{node_id: DigestSummary | wire}`` to one deterministic
    JSON file (the campaign planner's ``summaries=`` input)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    wires = {n: ({"v": SUMMARY_WIRE_VERSION, "full": s.to_wire()}
                 if isinstance(s, DigestSummary) else s)
             for n, s in summaries.items()}
    path.write_text(json.dumps(wires, sort_keys=True, indent=1) + "\n")
    return path


def load_summary_file(path: Path) -> Dict[str, dict]:
    """Load a :func:`save_summary_file` artifact. Wire validation happens at
    use (``DigestSummary.from_wire``) so version skew degrades to blind
    planning for that node, consistent with the coordinator's fail-soft."""
    raw = json.loads(Path(path).read_text())
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: summaries file must be a JSON object")
    return raw
