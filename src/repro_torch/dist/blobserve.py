"""Peer-to-peer blob fabric: content-addressed serving between worker hosts
(the port's copy of the reference's ``repro/dist/blobserve.py``, with the
same wire: a port fetcher reads a reference server and the other way round).

The paper's transfer ceiling — 0.60 Gb/s storage->compute over the lab
network, 0.33 Gb/s from cloud storage — is a property of the *shared
storage* link, which every :class:`~repro_torch.dist.cache.InputCache` miss
crosses. But after a warm-up pass the cluster collectively holds most hot
blobs on node-local disk, and the coordinator already knows who holds what
(the counting-Bloom :class:`~repro_torch.dist.cache.DigestSummary`s piggybacked
on heartbeats). This module turns those N private caches into one
cluster-wide serving tier:

* :class:`BlobServer` — a lightweight per-host TCP server answering
  content-addressed ``get <sha256>`` straight out of the host's
  ``InputCache``. Framing reuses the JSON-lines discipline of
  :mod:`repro_torch.dist.rpc` for the control half, with a length-prefixed
  binary path for the payload: request is one JSON line, response is one JSON
  header line (``{"id": n, "ok": true, "size": N}``) followed by exactly
  ``N`` raw bytes. Blob bodies never pass through ``json.dumps``. Serving
  reads are pinned (:meth:`InputCache.read_blob`) so LRU eviction cannot
  unlink a file mid-serve.
* :class:`PeerFabric` — the fetch side a cache consults on a local miss.
  It asks the coordinator for ranked peer candidates
  (``WorkQueue.locate_blobs``, answered from the summaries it already
  holds) and streams from the warmest live peer. Received bytes are
  **re-verified** against the requested sha256 before anyone trusts them.

Failure is the normal case and every mode degrades to the storage read the
caller was about to do anyway: dead peer / timeout (connection error),
Bloom false positive or stale summary (peer answers ``not found``), digest
mismatch (corrupted body or lying peer), coordinator too old to speak
``locate_blobs`` (the fabric disables itself after the first "unknown
method"). Each mode has its own counter, merged into ``InputCache.stats()``
so fallbacks are visible in ``WorkQueue.stats_snapshot()`` cluster-wide.
"""
from __future__ import annotations

import hashlib
import json
import socket
import socketserver
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..core.stream import stream_chunk_bytes

# Runbook knob (docs/operating.md): "host:port" this worker's blob server
# binds; the *advertised* address replaces a wildcard host with the
# machine's hostname so peers can actually reach it. Unset = no blob server
# (the worker still fetches from peers; it just never serves).
BLOB_ADDR_ENV = "REPRO_BLOB_ADDR"
# Runbook knob: set to "0" to disable peer *fetching* on a worker even when
# a cache is configured (serving is governed by BLOB_ADDR_ENV alone).
PEER_FETCH_ENV = "REPRO_PEER_FETCH"

_MAX_BLOB_BYTES = 1 << 34            # 16 GiB: sanity bound on header "size"


def parse_blob_addr(addr: str) -> Tuple[str, int]:
    """``"host:port"`` -> ``(host, port)``; bare ``":port"`` binds all
    interfaces (the advertised address then carries the hostname)."""
    host, _, port = addr.rpartition(":")
    return host or "0.0.0.0", int(port)


def advertised_addr(bound: Tuple[str, int]) -> str:
    """The address peers should dial for a server bound at ``bound``:
    wildcard hosts are unreachable from elsewhere, so advertise the
    machine's hostname instead."""
    host, port = bound
    if host in ("0.0.0.0", "::", ""):
        host = socket.gethostname()
    return f"{host}:{port}"


# ---------------------------------------------------------------------------
# server: GET <sha256> out of the host cache
# ---------------------------------------------------------------------------

class _BlobHandler(socketserver.StreamRequestHandler):
    def setup(self):
        super().setup()
        with self.server.conn_lock:                     # type: ignore[attr-defined]
            self.server.conns.add(self.connection)      # type: ignore[attr-defined]

    def finish(self):
        with self.server.conn_lock:                     # type: ignore[attr-defined]
            self.server.conns.discard(self.connection)  # type: ignore[attr-defined]
        super().finish()

    def handle(self):
        cache = self.server.cache                       # type: ignore[attr-defined]
        while True:
            line = self.rfile.readline()
            if not line:
                return                                   # client hung up
            req = None
            data: Optional[bytes] = None
            try:
                req = json.loads(line)
                if not isinstance(req, dict):
                    raise ValueError("request must be a JSON object")
                if req.get("method") != "get":
                    raise ValueError(f"unknown method {req.get('method')!r}")
                digest = req.get("digest")
                if not isinstance(digest, str) or not digest:
                    raise ValueError("get requires a digest")
                # pinned read: eviction cannot unlink the blob mid-serve.
                # None = not resident (requester's Bloom false positive or
                # stale summary): an explicit not-found, not an error — the
                # requester counts it and falls back to storage.
                data = cache.read_blob(digest)
                if data is None:
                    resp = {"id": req.get("id"), "ok": False,
                            "error": "not found"}
                else:
                    resp = {"id": req.get("id"), "ok": True,
                            "size": len(data)}
            except Exception as e:  # noqa: BLE001 — reported to the caller
                data = None
                resp = {"id": req.get("id") if isinstance(req, dict) else None,
                        "ok": False, "error": f"{type(e).__name__}: {e}"}
            try:
                self.wfile.write(json.dumps(resp).encode() + b"\n")
                if data is not None:
                    self.wfile.write(data)      # raw body, length in header
                self.wfile.flush()
            except OSError:
                return                                   # connection dropped


class _BlobTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.conn_lock = threading.Lock()
        self.conns: set = set()


class BlobServer:
    """Serve one host's :class:`~repro_torch.dist.cache.InputCache` blobs over
    TCP. ``port=0`` picks a free port; :attr:`addr_str` is the dialable
    bound address and :attr:`advertise` the one to publish to the
    coordinator (wildcard host replaced by the hostname)."""

    def __init__(self, cache, host: str = "127.0.0.1", port: int = 0):
        self.cache = cache
        self._srv = _BlobTCPServer((host, port), _BlobHandler)
        self._srv.cache = cache                          # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="blob-server", daemon=True)
        self._stopped = False

    @property
    def address(self) -> Tuple[str, int]:
        return self._srv.server_address[:2]

    @property
    def addr_str(self) -> str:
        host, port = self.address
        return f"{host}:{port}"

    @property
    def advertise(self) -> str:
        return advertised_addr(self.address)

    def start(self) -> "BlobServer":
        self._thread.start()
        return self

    def stop(self):
        if self._stopped:        # idempotent: Node.kill + runner teardown
            return
        self._stopped = True
        self._srv.shutdown()
        # as in QueueServer.stop: drop live connections so a peer blocked
        # mid-transfer sees a prompt ConnectionError (and falls back to
        # storage) instead of hanging until its timeout
        with self._srv.conn_lock:
            conns = list(self._srv.conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._srv.server_close()

    def __enter__(self) -> "BlobServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# ---------------------------------------------------------------------------
# fetch side
# ---------------------------------------------------------------------------

class BlobNotFound(Exception):
    """The peer answered: it does not hold that digest (Bloom false
    positive at the coordinator, or the peer evicted it since its last
    summary delta)."""


class _BlobConn:
    """One persistent connection to a peer blob server. Requests are
    serialized by :attr:`lock` (prefetch threads share the fabric); a
    transport or framing error leaves the stream unusable, so the owner
    drops the whole connection — an explicit :class:`BlobNotFound` leaves
    it aligned (header line, no body) and reusable."""

    def __init__(self, addr: str, timeout_s: float):
        self.addr = addr
        self.lock = threading.Lock()
        host, _, port = addr.rpartition(":")
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout_s)
        self._file = self._sock.makefile("rb")
        self._id = 0

    def get(self, digest: str) -> Tuple[bytes, str]:
        """Request one blob body. The body is read off the socket in
        streaming-ingest-sized chunks with the sha256 folded in as each
        chunk lands (``repro_torch.core.stream`` discipline: hashing overlaps
        the transfer, socket buffers refill while the CPU hashes), so the
        returned ``(data, sha256_hex)`` needs no post-transfer hashing
        pass. The *caller* still owns the verify-vs-requested-digest
        decision."""
        self._id += 1
        self._sock.sendall(json.dumps(
            {"id": self._id, "method": "get",
             "digest": digest}).encode() + b"\n")
        line = self._file.readline()
        if not line:
            raise ConnectionError(
                f"blob peer {self.addr} closed the connection")
        head = json.loads(line)
        if not isinstance(head, dict):
            raise ValueError(f"blob peer {self.addr}: malformed header")
        if not head.get("ok"):
            err = str(head.get("error", ""))
            if "not found" in err:
                raise BlobNotFound(f"{self.addr}: {digest} not held")
            raise ValueError(f"blob peer {self.addr}: {err}")
        size = head.get("size")
        if not isinstance(size, int) or not 0 <= size <= _MAX_BLOB_BYTES:
            raise ValueError(f"blob peer {self.addr}: bad size {size!r}")
        h = hashlib.sha256()
        parts: List[bytes] = []
        remaining = size
        chunk_bytes = stream_chunk_bytes()
        while remaining:
            piece = self._file.read(min(remaining, chunk_bytes))
            if not piece:
                raise ConnectionError(
                    f"blob peer {self.addr}: body truncated at "
                    f"{size - remaining}/{size} bytes")
            h.update(piece)
            parts.append(piece)
            remaining -= len(piece)
        return b"".join(parts), h.hexdigest()

    def close(self):
        try:
            self._file.close()
            self._sock.close()
        except OSError:
            pass


def fetch_blob(addr: str, digest: str, *, timeout_s: float = 5.0) -> bytes:
    """One-shot client: dial ``addr`` (``"host:port"``), request ``digest``,
    return the raw body. Raises :class:`BlobNotFound` on an explicit peer
    404 and ``OSError``/``ValueError`` on transport or framing trouble —
    the caller treats every one of those as "use shared storage". The body
    is returned unverified against ``digest``; :class:`PeerFabric` checks
    the in-flight hash (and reuses connections instead of paying this dial
    per blob)."""
    conn = _BlobConn(addr, timeout_s)
    try:
        return conn.get(digest)[0]
    finally:
        conn.close()


class PeerFabric:
    """The fetch policy an :class:`~repro_torch.dist.cache.InputCache`
    consults on a local miss (:meth:`InputCache.attach_fabric`).

    ``locate`` is any callable ``digests -> {digest: [addr, ...]}`` — in
    production ``WorkQueue.locate_blobs`` via the node's queue handle
    (in-process or :class:`~repro_torch.dist.rpc.QueueClient`), in tests a
    plain dict lookup. Candidates are tried warmest-first; the first peer whose
    bytes hash to the requested digest wins. Every failure mode increments
    its own counter (merged into ``InputCache.stats()``) and the fabric
    never raises — ``None`` means "go read shared storage".

    Version skew: a coordinator that predates ``locate_blobs`` answers
    "unknown method" once; the fabric then disables itself for the rest of
    the run instead of paying a doomed RPC per miss."""

    def __init__(self, locate: Callable[[List[str]], Dict[str, List[str]]],
                 *, self_addr: Optional[str] = None, timeout_s: float = 5.0,
                 max_peers: int = 3, quarantine_s: float = 5.0):
        self.locate = locate
        self.self_addr = self_addr
        self.timeout_s = float(timeout_s)
        self.max_peers = int(max_peers)
        # circuit breaker: a peer whose *connection* failed is skipped for
        # quarantine_s instead of paying a doomed dial (and its timeout) on
        # every subsequent miss — then retried, so a restarted peer rejoins
        self.quarantine_s = float(quarantine_s)
        self._quarantine: Dict[str, float] = {}    # addr -> retry-at (mono)
        self._lock = threading.Lock()
        self._disabled = False
        self._conns: Dict[str, _BlobConn] = {}
        self._counters = {"peer_false_positives": 0, "peer_dead": 0,
                          "peer_digest_mismatches": 0,
                          "peer_locate_failures": 0,
                          "peer_quarantine_skips": 0}

    def _bump(self, key: str):
        with self._lock:
            self._counters[key] += 1

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    # -- connection pool ----------------------------------------------------
    # dialing per blob would put a TCP handshake in front of every fetch —
    # at ~1 MiB blobs that fixed cost is what decides whether the peer link
    # beats the 0.60 Gb/s storage path. One persistent connection per peer;
    # transport errors drop it (next fetch re-dials, so a restarted peer is
    # picked back up), explicit 404s keep it.

    def _conn_for(self, addr: str) -> _BlobConn:
        with self._lock:
            conn = self._conns.get(addr)
        if conn is not None:
            return conn
        conn = _BlobConn(addr, self.timeout_s)      # dial outside the lock
        with self._lock:
            won = self._conns.setdefault(addr, conn)
        if won is not conn:
            conn.close()                             # lost the race: reuse won
        return won

    def _drop(self, addr: str, conn: _BlobConn):
        with self._lock:
            if self._conns.get(addr) is conn:
                del self._conns[addr]
        conn.close()

    # -- quarantine circuit breaker -----------------------------------------
    def _quarantine_peer(self, addr: str):
        if self.quarantine_s <= 0:
            return
        with self._lock:
            self._quarantine[addr] = time.monotonic() + self.quarantine_s

    def _quarantined(self, addr: str) -> bool:
        """True while ``addr`` is inside its quarantine window. Expiry
        clears the entry, so the next fetch re-dials (half-open probe)."""
        with self._lock:
            until = self._quarantine.get(addr)
            if until is None:
                return False
            if time.monotonic() >= until:
                del self._quarantine[addr]
                return False
            return True

    def close(self):
        """Close pooled peer connections (worker shutdown)."""
        with self._lock:
            conns, self._conns = list(self._conns.values()), {}
        for conn in conns:
            conn.close()

    def fetch(self, digest: str) -> Optional[Tuple[bytes, str]]:
        """``(verified bytes, peer addr)`` for ``digest``, or ``None`` when
        no live peer could produce bytes matching it."""
        with self._lock:
            if self._disabled:
                return None
        try:
            located = self.locate([digest]) or {}
        except (ConnectionError, OSError, RuntimeError) as e:
            if "unknown method" in str(e):
                with self._lock:         # pre-fabric coordinator: stand down
                    self._disabled = True
            else:
                self._bump("peer_locate_failures")
            return None
        for addr in list(located.get(digest) or [])[:self.max_peers]:
            if not isinstance(addr, str) or addr == self.self_addr:
                continue
            if self._quarantined(addr):
                self._bump("peer_quarantine_skips")
                continue
            conn = None
            try:
                conn = self._conn_for(addr)
                with conn.lock:
                    data, got_digest = conn.get(digest)
            except BlobNotFound:
                self._bump("peer_false_positives")
                continue
            except (OSError, ValueError):
                if conn is not None:
                    self._drop(addr, conn)     # stream state is unknown
                self._bump("peer_dead")
                self._quarantine_peer(addr)
                continue
            if got_digest != digest:
                # corrupted body or a lying peer: the in-flight hash
                # (folded chunk-by-chunk as the body streamed in) is the
                # fabric's correctness boundary — no post-transfer pass
                self._bump("peer_digest_mismatches")
                continue
            return data, addr
        return None
