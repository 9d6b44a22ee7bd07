"""Networked WorkQueue transport of the port: the reference's
``repro/dist/rpc.py`` over the port's queue, with the same wire, so a port
worker joins a reference coordinator and the other way round.

The in-process :class:`~repro_torch.dist.queue.WorkQueue` was designed as a
single lock-guarded object with a small JSON-serializable method surface;
this module wraps it in a socket server and gives workers a drop-in client:

* :class:`QueueServer` — owns the one real ``WorkQueue`` and serves it over
  TCP. Wire format is **JSON lines**: one request object per line
  (``{"id": n, "method": "...", "params": {...}}``), one response per line
  (``{"id": n, "ok": true, "result": ...}`` or ``{"id": n, "ok": false,
  "error": "..."}``), UTF-8, ``\\n``-framed. Hot paths may instead use
  **length-prefixed binary frames** (``0x00`` magic byte + 4-byte big-endian
  payload length + the same JSON payload): the server answers in whichever
  framing the request arrived in and tags every JSON-lines response with
  ``"bin": 1``, which is how a new client discovers it may upgrade — an old
  server never sees a binary frame, an old client never notices the tag.
  Both sides cap frames at ``MAX_FRAME_BYTES`` and reject oversize with a
  protocol error (a corrupt or hostile peer must not balloon memory). One
  thread per connection; a dropped connection kills only that worker's
  session — its leases die with its heartbeats and are reaped like any
  crashed node.
* :class:`QueueClient` — implements the exact ``WorkQueue`` method surface
  (``next_unit`` / ``complete`` / ``heartbeat`` / ``speculate`` / ``reap`` /
  ``renew`` / ``register`` / introspection, plus the batched
  ``next_units`` / ``complete_batch`` / ``renew_batch`` that fold N hot-path
  ops into one round trip and shed to per-op calls against a pre-batch
  coordinator) over one persistent connection, so
  :class:`~repro_torch.dist.cluster.Node` and ``ClusterRunner`` run
  unchanged against either the in-process queue or a remote one.

Only already-JSON data crosses the wire: ``WorkUnit`` and ``Lease`` are flat
dataclasses, and results travel as the ``meta`` payload of ``complete``.
Array bytes never do — nodes read inputs from shared storage (through the
per-host :mod:`repro_torch.dist.cache`) and commit outputs there directly, so
the coordinator link stays control-plane-thin (the paper's 0.60 Gb/s
storage->compute path is not funneled through one TCP socket).

CLI (the reference's flags; ``docs/operating.md`` is the runbook)::

    # coordinator host: serve a unit list
    python -m repro_torch.dist.rpc serve --units units.json --addr 0.0.0.0:7077

    # each worker host: join and drain (REPRO_QUEUE_ADDR also works); the
    # pipelines run on cuda, which must exist, unless --device cpu
    python -m repro_torch.dist.rpc work --addr coord:7077 \\
        --pipeline bias_correct --data-root /shared/dataset \\
        --node-id $(hostname)

The ``serve`` loop reaps dead workers every ``--reap-interval``, but not on
a tick that comes a heartbeat late: a stall of the coordinator process (a
GC pass, a starved CPU) also stalls the handler threads that would have
taken the workers' heartbeats, so their silence is then no evidence of
death. Such a tick defers reaping by two worker heartbeat intervals, as the
port's in-process cluster loop does; the reference reaps on it and reads
every worker as dead (ROADMAP.md, F3).
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import socket
import socketserver
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

from ..core.query import WorkUnit
from .queue import Lease, WorkQueue

QUEUE_ADDR_ENV = "REPRO_QUEUE_ADDR"

# The heartbeat interval of a worker process (run_worker's default): how
# late a serve-loop tick may come before it counts as the coordinator's own
# stall, and half the grace it then gives the workers' heartbeats to land.
WORKER_HEARTBEAT_S = 0.25

# Hard ceiling on one request/response frame, both framings, both sides.
# The control plane moves leases and digest summaries — a few KB; 8 MiB is
# two orders of headroom. Anything larger is a corrupt length prefix, a
# desynchronized stream, or a hostile peer, and the old unbounded readline
# would have buffered it all before failing.
MAX_FRAME_BYTES = 8 << 20

# First byte of a length-prefixed binary frame. JSON-lines requests always
# start with "{", so one peeked byte disambiguates the framings per request.
_FRAME_MAGIC = b"\x00"

# Per-attempt connect timeout while redialing (reconnect path only; the
# constructor's first dial keeps the caller's full timeout_s). Redials run
# under the client's transport lock, so one attempt must stay well under
# both the reconnect window and the coordinator's lease TTL — see
# QueueClient._connect_locked.
REDIAL_CONNECT_TIMEOUT_S = 1.5

# The queue surface a client may invoke. getattr-dispatch is gated on this
# allowlist so a malformed request can name only protocol methods, nothing
# else on the object.
_METHODS = frozenset({
    "next_unit", "next_units", "complete", "complete_batch", "mark_started",
    "heartbeat", "mark_dead",
    "reap", "speculate", "renew", "renew_batch", "register", "running",
    "finished",
    "pending", "alive_nodes", "done_status", "queue_depths", "active_leases",
    "results_snapshot", "stats_snapshot", "primary_log", "put_summary",
    "summaries_snapshot", "locate_blobs",
})


def parse_addr(addr: str) -> Tuple[str, int]:
    """``"host:port"`` -> ``(host, port)``; bare ``":port"`` binds all ifaces."""
    host, _, port = addr.rpartition(":")
    return host or "0.0.0.0", int(port)


def addr_from_env() -> Optional[Tuple[str, int]]:
    raw = os.environ.get(QUEUE_ADDR_ENV)
    return parse_addr(raw) if raw else None


# ---------------------------------------------------------------------------
# wire encoding: only two non-scalar types cross the boundary
# ---------------------------------------------------------------------------

def _encode(obj: Any) -> Any:
    """Make a queue-method return value JSON-safe. The queue already returns
    plain data except for ``WorkUnit``/``Lease`` dataclasses and the
    ``(unit, lease)`` grant tuple."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, Lease):
        return {"__lease__": dataclasses.asdict(obj)}
    if isinstance(obj, WorkUnit):
        # depends_on travels as a *sibling* of the __unit__ payload: an old
        # peer's decoder builds WorkUnit(**obj["__unit__"]) and never looks
        # at siblings, so version skew sheds the edge set instead of raising.
        # That is safe by construction — the queue only grants ready units,
        # so an old worker can hold a DAG child only after its parents
        # committed. New decoders restore the field below.
        d = dataclasses.asdict(obj)
        deps = d.pop("depends_on", None)
        out: Dict[str, Any] = {"__unit__": d}
        if deps:
            out["__deps__"] = list(deps)
        return out
    if isinstance(obj, dict):
        return {str(k): _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    raise TypeError(f"cannot encode {type(obj).__name__} for the wire")


def _decode(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "__lease__" in obj:
            return Lease(**obj["__lease__"])
        if "__unit__" in obj:
            fields = dict(obj["__unit__"])
            deps = obj.get("__deps__")
            if deps:
                fields["depends_on"] = [str(x) for x in deps]
            return WorkUnit(**fields)
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class _Handler(socketserver.StreamRequestHandler):
    def setup(self):
        super().setup()
        with self.server.conn_lock:                     # type: ignore[attr-defined]
            self.server.conns.add(self.connection)      # type: ignore[attr-defined]
            self.server.handler_threads.add(            # type: ignore[attr-defined]
                threading.current_thread())

    def finish(self):
        with self.server.conn_lock:                     # type: ignore[attr-defined]
            self.server.conns.discard(self.connection)  # type: ignore[attr-defined]
            self.server.handler_threads.discard(        # type: ignore[attr-defined]
                threading.current_thread())
        super().finish()

    def _reply(self, resp: dict, *, binary: bool):
        # every response is stamped with the server's incarnation id so a
        # reconnecting client can tell "same coordinator, transient blip"
        # from "new incarnation, re-register and re-push state". ~20 bytes;
        # old clients ignore the key (same posture as the "bin" tag).
        inc = getattr(self.server, "incarnation", None)
        if inc:
            resp["inc"] = inc
        data = json.dumps(resp).encode()
        if binary:
            self.wfile.write(_FRAME_MAGIC
                             + len(data).to_bytes(4, "big") + data)
        else:
            self.wfile.write(data + b"\n")
        self.wfile.flush()

    def handle(self):
        queue: WorkQueue = self.server.queue            # type: ignore[attr-defined]
        while True:
            head = self.rfile.read(1)
            if not head:
                return                                   # client hung up
            binary = head == _FRAME_MAGIC
            if binary:
                hdr = self.rfile.read(4)
                if len(hdr) < 4:
                    return                               # EOF mid-header
                n = int.from_bytes(hdr, "big")
                if n > MAX_FRAME_BYTES:
                    # a length prefix past the cap means the stream cannot
                    # be resynchronized: report and hang up (the client's
                    # ConnectionError path — the reaper's failure mode)
                    try:
                        self._reply({"id": None, "ok": False,
                                     "error": f"ProtocolError: {n}-byte "
                                              f"frame exceeds cap "
                                              f"{MAX_FRAME_BYTES}"},
                                    binary=True)
                    except OSError:
                        pass
                    return
                payload = self.rfile.read(n)
                if len(payload) < n:
                    return                               # EOF mid-frame
            else:
                rest = self.rfile.readline(MAX_FRAME_BYTES)
                payload = head + rest
                if not payload.endswith(b"\n"):
                    if len(payload) > MAX_FRAME_BYTES:
                        # oversize line: the rest of it is still in the
                        # socket — never try to resync past it
                        try:
                            self._reply(
                                {"id": None, "ok": False,
                                 "error": f"ProtocolError: line exceeds "
                                          f"frame cap {MAX_FRAME_BYTES}"},
                                binary=False)
                        except OSError:
                            pass
                    return                               # oversize or EOF
            req = None
            try:
                req = json.loads(payload)
                if not isinstance(req, dict):
                    raise ValueError("request must be a JSON object")
                method = req.get("method")
                if method not in _METHODS:
                    raise ValueError(f"unknown method {method!r}")
                params = req.get("params") or {}
                result = getattr(queue, method)(**params)
                resp = {"id": req.get("id"), "ok": True,
                        "result": _encode(result)}
            except Exception as e:  # noqa: BLE001 — reported to the caller
                resp = {"id": req.get("id") if isinstance(req, dict) else None,
                        "ok": False, "error": f"{type(e).__name__}: {e}"}
            if not binary:
                # advertise binary-framing support on every JSON-lines
                # response; a new client upgrades after its first call, an
                # old client ignores the extra key
                resp["bin"] = 1
            try:
                self._reply(resp, binary=binary)
            except OSError:
                return                                   # connection dropped


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.conn_lock = threading.Lock()
        self.conns: set = set()
        self.handler_threads: set = set()
        # fresh per server object: two QueueServers on the same port (a
        # restart) necessarily present different ids
        self.incarnation = uuid.uuid4().hex[:12]


class QueueServer:
    """Serve one :class:`WorkQueue` over TCP JSON-lines.

    The server owns nothing but the socket: the queue's semantics (leases,
    reaping, commit arbitration) are untouched, and the coordinator process
    keeps calling the queue object directly while remote workers go through
    the wire. ``port=0`` picks a free port; read it back from
    :attr:`address` after :meth:`start`."""

    def __init__(self, queue: WorkQueue, host: str = "127.0.0.1",
                 port: int = 0, *, drain_s: float = 5.0):
        self.queue = queue
        self.drain_s = float(drain_s)
        self._srv = _Server((host, port), _Handler)
        self._srv.queue = queue                          # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="queue-server", daemon=True)
        self._stop_lock = threading.Lock()
        self._stopped = False

    @property
    def address(self) -> Tuple[str, int]:
        return self._srv.server_address[:2]

    @property
    def addr_str(self) -> str:
        host, port = self.address
        return f"{host}:{port}"

    @property
    def incarnation(self) -> str:
        """This server object's identity on the wire (stamped into every
        response). A restarted coordinator necessarily presents a new one."""
        return self._srv.incarnation

    def start(self) -> "QueueServer":
        self._thread.start()
        return self

    def stop(self):
        """Graceful, idempotent shutdown: stop accepting, half-close every
        live connection (``SHUT_RD`` — no new requests arrive, but a reply
        already being computed still reaches its worker), join the handler
        threads up to ``drain_s``, then force-close stragglers. Safe to call
        twice (or concurrently with :meth:`crash`): the second call is a
        no-op, so tests and operators can stop/restart freely without racing
        half-written replies."""
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self._srv.shutdown()
        with self._srv.conn_lock:
            conns = list(self._srv.conns)
            threads = list(self._srv.handler_threads)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        deadline = time.monotonic() + self.drain_s
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        # anything still running after the drain budget is wedged mid-call:
        # cut it off rather than hang the operator
        with self._srv.conn_lock:
            conns = list(self._srv.conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._srv.server_close()

    def crash(self):
        """Simulated coordinator death: immediately sever every connection
        mid-whatever-it-was-doing — no drain, no goodbye frames. Idempotent
        like :meth:`stop`. The restart harness uses this to exercise the
        journal-recovery path against torn replies and half-served grants."""
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self._srv.shutdown()
        with self._srv.conn_lock:
            conns = list(self._srv.conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._srv.server_close()

    def __enter__(self) -> "QueueServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class _FatalStream(ConnectionError):
    """The server refused the stream itself (an id-less error reply, e.g.
    an oversize frame): deterministic, so retrying the same bytes would
    fail the same way forever. Never redialed."""


class QueueClient:
    """``WorkQueue``-shaped proxy over one persistent JSON-lines connection.

    Thread-safe: a node's worker, loader, and heartbeat threads share the
    client; one lock serializes request/response pairs on the socket (calls
    are sub-millisecond control-plane messages, never data transfers).

    **Reconnect** (default on): a transport error drops the socket and the
    call redials with capped exponential backoff + jitter for up to
    ``reconnect_window_s``, then replays the request — safe because the
    queue surface is idempotent, epoch-guarded, or lease-TTL-backstopped
    (a duplicate ``complete`` lands in the dup log, a duplicate
    ``register`` refreshes a heartbeat, a stale ``renew`` is rejected; a
    grant whose *reply* was lost — the one non-idempotent case, since the
    replayed call draws a fresh lease — is reclaimed by the coordinator's
    per-lease expiry: nobody ever renews a lease the node never received,
    so ``reap()`` requeues it after one TTL). Each redial renegotiates
    binary framing from scratch and re-registers the node with its last
    summary. Every server response carries an incarnation id; when it
    changes (the coordinator restarted), registered restart hooks fire so
    the node can re-push its full cache summary and blob address to the new
    incarnation. ``reconnect=False`` restores the pre-reconnect contract:
    any transport error permanently poisons the client and raises
    :class:`ConnectionError` — to the node loop that is indistinguishable
    from its own crash, which is exactly the failure semantics the reaper
    expects (silence -> lease requeue). With reconnect on the same terminal
    semantics apply once the window is exhausted."""

    def __init__(self, addr: Tuple[str, int], *, timeout_s: float = 30.0,
                 binary: bool = True, reconnect: bool = True,
                 reconnect_window_s: float = 20.0, backoff_s: float = 0.05,
                 backoff_max_s: float = 1.0):
        self.addr = addr
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._id = 0
        self._poisoned = False
        self._reconnect = bool(reconnect)
        self._reconnect_window_s = float(reconnect_window_s)
        self._backoff_s = float(backoff_s)
        self._backoff_max_s = float(backoff_max_s)
        self._closing = threading.Event()
        self._incarnation: Optional[str] = None
        self._register_params: Optional[Dict[str, Any]] = None
        self._restart_hooks: list = []
        self._hooks_lock = threading.Lock()
        self._hooks_running = False
        self._pending_restart = False
        # locality version-skew fail-soft: a server that predates cache
        # digest summaries rejects the extra params with a TypeError; after
        # the first such rejection this client stops sending summaries and
        # the run proceeds locality-blind (the pre-summary behaviour)
        self._summaries_ok = True
        # same discipline for the peer fabric's blob_addr advertisement: an
        # old coordinator rejects it once, then we stop advertising (the
        # worker still serves blobs; nobody is told, nobody dials in)
        self._fabric_ok = True
        # and for the batched hot-path methods: one "unknown method" from a
        # pre-batch coordinator downgrades this client to per-op calls
        self._batched_ok = True
        # binary framing is negotiated, never assumed: the first JSON-lines
        # response from a framing-capable server carries "bin": 1, after
        # which (with binary=True) every request is length-prefixed. An old
        # server therefore never receives a frame it would misread as a
        # garbled line. binary=False pins the client to JSON-lines — the
        # old-client-new-server compatibility shape, kept testable.
        self._binary_enabled = bool(binary)
        self._binary = False
        # the first dial fails loudly (OSError), reconnect or not: "the
        # coordinator was never there" is an operator error, not a blip
        self._sock: Optional[socket.socket] = \
            socket.create_connection(addr, timeout=timeout_s)
        self._file = self._sock.makefile("rb")

    def close(self):
        self._closing.set()            # wakes any backoff sleep immediately
        with self._lock:
            self._poison()

    def add_restart_hook(self, fn: Callable[[], None]):
        """Run ``fn()`` after this client detects a coordinator restart (the
        server incarnation id changed). Fired outside the transport lock, so
        hooks may freely call client methods (re-push a summary,
        re-advertise a blob server); hook exceptions are swallowed — a
        failed re-push degrades locality, never the reconnect."""
        with self._hooks_lock:
            self._restart_hooks.append(fn)

    def _read_response(self, method: str) -> bytes:
        """One response frame in whichever framing this connection speaks.
        Caller holds the lock. Raises :class:`ConnectionError` on EOF, a
        desynchronized stream, or an oversize frame — the cap protects the
        client's memory exactly as the server's protects its. The caller
        (:meth:`_call`) decides whether that means redial or poison."""
        if self._binary:
            head = self._file.read(1)
            if not head:
                raise ConnectionError(
                    f"queue server {self.addr} closed the connection")
            if head != _FRAME_MAGIC:
                raise ConnectionError(
                    f"queue rpc {method}: expected a binary frame from "
                    f"{self.addr} — stream desynchronized")
            hdr = self._file.read(4)
            if len(hdr) < 4:
                raise ConnectionError(
                    f"queue server {self.addr} closed the connection")
            n = int.from_bytes(hdr, "big")
            if n > MAX_FRAME_BYTES:
                # deterministic local rejection, not transport weather: the
                # same reply would blow the cap on every redial — fatal
                raise _FatalStream(
                    f"queue rpc {method}: {n}-byte response frame from "
                    f"{self.addr} exceeds frame cap {MAX_FRAME_BYTES}")
            payload = self._file.read(n)
            if len(payload) < n:
                raise ConnectionError(
                    f"queue server {self.addr} closed the connection")
            return payload
        line = self._file.readline(MAX_FRAME_BYTES + 1)
        if not line:
            raise ConnectionError(
                f"queue server {self.addr} closed the connection")
        if len(line) > MAX_FRAME_BYTES and not line.endswith(b"\n"):
            raise _FatalStream(
                f"queue rpc {method}: response line from {self.addr} "
                f"exceeds frame cap {MAX_FRAME_BYTES}")
        return line

    def _drop_socket_locked(self):
        """Tear down a dead/poisoned socket without judging the client."""
        if self._sock is not None:
            try:
                self._file.close()
                self._sock.close()
            except OSError:
                pass
        self._sock = None

    def _connect_locked(self, deadline: Optional[float] = None):
        """Redial. Framing restarts at JSON-lines — the server on the other
        end may be a different (even older) build than last time, so the
        binary upgrade is renegotiated per connection, never remembered.

        The dial itself uses a short per-attempt timeout, clamped to the
        time left before ``deadline`` (the reconnect window): this method
        runs under the transport lock, and a single full-``timeout_s``
        dial into a partition would both blow through the whole reconnect
        window and serialize the node's heartbeat/renew threads behind the
        lock — a healthy node would stop heartbeating and get reaped.
        Once connected the socket reverts to the full ``timeout_s`` for
        request/response traffic."""
        timeout = min(self.timeout_s, REDIAL_CONNECT_TIMEOUT_S)
        if deadline is not None:
            timeout = min(timeout, max(0.05, deadline - time.monotonic()))
        self._sock = socket.create_connection(self.addr, timeout=timeout)
        self._sock.settimeout(self.timeout_s)
        self._file = self._sock.makefile("rb")
        self._binary = False

    def _replay_session_locked(self):
        """Re-establish session state on a fresh connection: re-send the
        last successful ``register`` (node id + full summary + blob addr)
        so the server — possibly a brand-new incarnation that has never
        heard of this node — can place and route it again before the
        retried call lands. A ``False`` result (the node was reaped) is
        left for the node loop to discover through its own calls."""
        if self._register_params is not None:
            self._roundtrip_locked("register", dict(self._register_params))

    def _roundtrip_locked(self, method: str, params: dict) -> dict:
        """One request/response exchange on the current socket. Caller
        holds the lock. Transport trouble raises plain
        :class:`ConnectionError` (retryable: the caller may redial);
        a deterministic stream rejection raises :class:`_FatalStream`."""
        self._id += 1
        req = {"id": self._id, "method": method, "params": params}
        data = json.dumps(req).encode()
        try:
            if self._binary:
                self._sock.sendall(
                    _FRAME_MAGIC + len(data).to_bytes(4, "big") + data)
            else:
                self._sock.sendall(data + b"\n")
            raw = self._read_response(method)
        except ConnectionError:
            raise
        except OSError as e:
            # includes timeout: a timed-out call may leave its reply in
            # flight — the stream is no longer aligned, so this socket is
            # done either way
            raise ConnectionError(
                f"queue rpc {method} to {self.addr}: {e}") from e
        try:
            resp = json.loads(raw)
        except json.JSONDecodeError as e:
            # truncated line at EOF (server killed mid-reply): transport
            # death, not a protocol error
            raise ConnectionError(
                f"queue rpc {method}: truncated/garbage response "
                f"from {self.addr}: {e}") from e
        if resp.get("id") != req["id"]:
            if resp.get("id") is None and not resp.get("ok", True):
                # an id-less error is the server refusing the stream itself
                # (e.g. a frame past the cap) before closing it — the same
                # bytes would be refused again, so never retry
                raise _FatalStream(
                    f"queue rpc {method}: server {self.addr} rejected "
                    f"the stream: {resp.get('error')}")
            raise ConnectionError(
                f"queue rpc {method}: response id {resp.get('id')!r} != "
                f"request id {req['id']} — stream desynchronized")
        if not self._binary and self._binary_enabled and resp.get("bin"):
            self._binary = True           # server advertised frame support
        inc = resp.get("inc")
        if inc:
            if self._incarnation is None:
                self._incarnation = inc
            elif inc != self._incarnation:
                self._incarnation = inc
                self._pending_restart = True
        return resp

    def _call(self, method: str, **params) -> Any:
        deadline = None
        delay = self._backoff_s
        while True:
            resp = None
            with self._lock:
                if self._poisoned or self._closing.is_set():
                    raise ConnectionError(
                        f"queue rpc {method}: connection to {self.addr} "
                        f"is down")
                try:
                    if self._sock is None:
                        self._connect_locked(deadline)
                        self._replay_session_locked()
                    resp = self._roundtrip_locked(method, params)
                except _FatalStream as e:
                    self._poison()
                    raise ConnectionError(str(e)) from None
                except (ConnectionError, OSError) as e:
                    self._drop_socket_locked()
                    if not self._reconnect:
                        self._poison()
                        raise ConnectionError(
                            f"queue rpc {method} to {self.addr}: {e}") from e
                    if deadline is None:
                        deadline = time.monotonic() + self._reconnect_window_s
                    if time.monotonic() >= deadline:
                        self._poison()
                        raise ConnectionError(
                            f"queue rpc {method} to {self.addr}: gave up "
                            f"after {self._reconnect_window_s:.1f}s of "
                            f"redials: {e}") from e
            if resp is not None:
                # outside the lock: hooks re-enter the client
                self._maybe_fire_restart_hooks()
                if not resp.get("ok"):
                    raise RuntimeError(
                        f"queue rpc {method}: {resp.get('error')}")
                return _decode(resp.get("result"))
            # redial backoff, outside the lock so heartbeat/worker threads
            # aren't serialized behind the sleep; jitter de-synchronizes a
            # whole cluster's workers re-dialing one reborn coordinator
            if self._closing.wait(delay * (0.5 + random.random())):
                raise ConnectionError(
                    f"queue rpc {method}: client closed while redialing")
            delay = min(delay * 2, self._backoff_max_s)

    def _maybe_fire_restart_hooks(self):
        with self._hooks_lock:
            if not self._pending_restart or self._hooks_running:
                return        # no restart seen, or a hook is mid-flight
            #                   (hooks call client methods: don't recurse)
            self._pending_restart = False
            self._hooks_running = True
            hooks = list(self._restart_hooks)
        try:
            for fn in hooks:
                try:
                    fn()
                except Exception:   # noqa: BLE001 — a failed re-push
                    pass            # degrades locality, never the session
        finally:
            with self._hooks_lock:
                self._hooks_running = False

    def _poison(self):
        """Caller holds the lock: drop the socket; every later call raises."""
        self._poisoned = True
        self._drop_socket_locked()

    def _downgrade_on_type_error(self, exc: RuntimeError) -> bool:
        """An old server reports our new summary params as a ``TypeError:
        ... unexpected keyword ...`` RPC error. Flag the downgrade (so later
        calls skip summaries entirely) and tell the caller to retry bare."""
        if "TypeError" in str(exc):
            self._summaries_ok = False
            return True
        return False

    # -- the WorkQueue surface, verbatim ------------------------------------

    def next_unit(self, node_id: str):
        got = self._call("next_unit", node_id=node_id)
        return None if got is None else (got[0], got[1])

    def next_units(self, node_id: str, max_units: int = 1):
        """Batched grants: one round trip for up to ``max_units`` leases.
        Sheds to per-op :meth:`next_unit` calls (permanently, for this
        connection) against a coordinator that predates batching."""
        if self._batched_ok:
            try:
                got = self._call("next_units", node_id=node_id,
                                 max_units=max_units)
                return [(g[0], g[1]) for g in got]
            except RuntimeError as e:
                if "unknown method" not in str(e):
                    raise
                self._batched_ok = False
        out = []
        for _ in range(max(1, int(max_units))):
            one = self.next_unit(node_id)
            if one is None:
                break
            out.append(one)
        return out

    def complete(self, idx: int, node_id: str, status: str, *,
                 speculative: bool = False, meta: Optional[dict] = None):
        self._call("complete", idx=idx, node_id=node_id, status=status,
                   speculative=speculative, meta=meta)

    def complete_batch(self, completions):
        """Batched terminal reports (list of ``{"idx", "node_id", "status"}``
        dicts plus optional ``speculative``/``meta``); sheds to per-op
        :meth:`complete` calls against a pre-batch coordinator."""
        completions = list(completions)
        if self._batched_ok:
            try:
                self._call("complete_batch", completions=completions)
                return
            except RuntimeError as e:
                if "unknown method" not in str(e):
                    raise
                self._batched_ok = False
        for c in completions:
            meta = c.get("meta")
            self.complete(int(c["idx"]), str(c["node_id"]), str(c["status"]),
                          speculative=bool(c.get("speculative", False)),
                          meta=meta if isinstance(meta, dict) else None)

    def mark_started(self, idx: int):
        self._call("mark_started", idx=idx)

    def heartbeat(self, node_id: str, summary_delta=None, blob_addr=None):
        params: Dict[str, Any] = {"node_id": node_id}
        if summary_delta is not None and self._summaries_ok:
            params["summary_delta"] = summary_delta
        if blob_addr and self._fabric_ok:
            params["blob_addr"] = blob_addr
        while True:
            try:
                self._call("heartbeat", **params)
                return
            except RuntimeError as e:
                # shed new-protocol params one generation at a time: a
                # coordinator that rejects blob_addr may still speak
                # summaries, so don't throw both away on one TypeError
                if "blob_addr" in params and "TypeError" in str(e):
                    self._fabric_ok = False
                    params.pop("blob_addr")
                    continue
                if "summary_delta" in params and self._downgrade_on_type_error(e):
                    params.pop("summary_delta")
                    continue
                raise

    def mark_dead(self, node_id: str):
        self._call("mark_dead", node_id=node_id)

    def reap(self):
        return self._call("reap")

    def speculate(self, idx: int, node_id: Optional[str] = None):
        return self._call("speculate", idx=idx, node_id=node_id)

    def renew(self, idx: int, node_id: str, epoch: int,
              summary_delta=None) -> bool:
        if summary_delta is not None and self._summaries_ok:
            try:
                return self._call("renew", idx=idx, node_id=node_id,
                                  epoch=epoch, summary_delta=summary_delta)
            except RuntimeError as e:
                if not self._downgrade_on_type_error(e):
                    raise
        return self._call("renew", idx=idx, node_id=node_id, epoch=epoch)

    def renew_batch(self, node_id: str, leases, summary_delta=None):
        """Renew every held lease (``[[idx, epoch], ...]``) in one round
        trip, the ``summary_delta`` applied once. Sheds to per-op
        :meth:`renew` calls against a pre-batch coordinator — the delta then
        piggybacks on the first per-op renew, keeping its once-per-beat
        semantics."""
        leases = [[int(i), int(e)] for i, e in leases]
        if self._batched_ok:
            params: Dict[str, Any] = {"node_id": node_id, "leases": leases}
            if summary_delta is not None and self._summaries_ok:
                params["summary_delta"] = summary_delta
            try:
                return [bool(v) for v in self._call("renew_batch", **params)]
            except RuntimeError as e:
                if "unknown method" not in str(e):
                    raise
                self._batched_ok = False
        out = []
        delta = summary_delta
        for i, ep in leases:
            out.append(self.renew(i, node_id, ep, summary_delta=delta))
            delta = None
        return out

    def register(self, node_id: str, summary=None, blob_addr=None) -> bool:
        params: Dict[str, Any] = {"node_id": node_id}
        if summary is not None and self._summaries_ok:
            params["summary"] = summary
        if blob_addr and self._fabric_ok:
            params["blob_addr"] = blob_addr
        while True:
            try:
                joined = self._call("register", **params)
                # remember the post-shedding params: every future redial
                # replays exactly this registration before anything else
                self._register_params = dict(params)
                return joined
            except RuntimeError as e:
                if "blob_addr" in params and "TypeError" in str(e):
                    self._fabric_ok = False
                    params.pop("blob_addr")
                    continue
                if "summary" in params and self._downgrade_on_type_error(e):
                    params.pop("summary")
                    continue
                raise

    def put_summary(self, node_id: str, summary) -> bool:
        """Push a full cache digest summary; False (never an error) against
        a coordinator that predates locality-aware placement."""
        if not self._summaries_ok:
            return False
        try:
            return self._call("put_summary", node_id=node_id, summary=summary)
        except RuntimeError as e:
            if "unknown method" in str(e) or "TypeError" in str(e):
                self._summaries_ok = False
                return False
            raise

    def running(self):
        return [tuple(r) for r in self._call("running")]

    def finished(self) -> bool:
        return self._call("finished")

    def pending(self) -> int:
        return self._call("pending")

    def alive_nodes(self):
        return self._call("alive_nodes")

    def done_status(self):
        return {int(k): v for k, v in self._call("done_status").items()}

    def queue_depths(self):
        return self._call("queue_depths")

    def active_leases(self):
        return self._call("active_leases")

    def results_snapshot(self):
        snap = self._call("results_snapshot")
        return {"primaries": {int(k): v
                              for k, v in snap["primaries"].items()},
                "duplicates": snap["duplicates"]}

    def primary_log(self, start: int = 0):
        return self._call("primary_log", start=start)

    def stats_snapshot(self):
        return self._call("stats_snapshot")

    def summaries_snapshot(self):
        """Per-node summary wires for admission-time campaign planning;
        ``{}`` (never an error) against a coordinator that predates it."""
        try:
            return self._call("summaries_snapshot")
        except RuntimeError as e:
            if "unknown method" in str(e):
                return {}
            raise

    def locate_blobs(self, digests, node_id=None):
        """Peer candidates for content-addressed blobs (the fabric's routing
        question); ``{}`` (never an error) against a coordinator that
        predates the peer fabric — the fetcher then reads shared storage,
        exactly the pre-fabric behaviour."""
        if not self._fabric_ok:
            return {}
        try:
            return self._call("locate_blobs", digests=list(digests),
                              node_id=node_id)
        except RuntimeError as e:
            if "unknown method" in str(e):
                self._fabric_ok = False
                return {}
            raise

    # the in-process queue exposes these as attributes; mirror them so
    # observability code works against either implementation
    @property
    def steals(self):
        return self.stats_snapshot()["steals"]

    @property
    def requeues(self):
        return self.stats_snapshot()["requeues"]


# ---------------------------------------------------------------------------
# CLI: coordinator + worker entrypoints for real multi-host runs
# ---------------------------------------------------------------------------

def _main():
    import argparse
    ap = argparse.ArgumentParser(
        description="networked WorkQueue: serve a unit list / join as worker")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sv = sub.add_parser("serve", help="run the coordinator queue server")
    sv.add_argument("--units", required=True,
                    help="units JSON from generate_jobs (…_units.json)")
    sv.add_argument("--addr", default=os.environ.get(QUEUE_ADDR_ENV,
                                                     "127.0.0.1:7077"))
    sv.add_argument("--lease-ttl", type=float, default=30.0,
                    help="seconds of heartbeat silence before a node is reaped")
    sv.add_argument("--reap-interval", type=float, default=1.0)
    sv.add_argument("--journal", default=None, metavar="DIR",
                    help="write-ahead journal directory: every queue "
                         "mutation becomes durable, and re-serving with the "
                         "same DIR recovers the previous incarnation's "
                         "state instead of starting over")
    sv.add_argument("--fsync", default="interval",
                    choices=("always", "interval", "never"),
                    help="journal durability: fsync every record, on an "
                         "interval (default), or leave it to the OS")

    wk = sub.add_parser("work", help="join the queue and drain units")
    wk.add_argument("--addr", default=os.environ.get(QUEUE_ADDR_ENV),
                    help=f"coordinator host:port (or ${QUEUE_ADDR_ENV})")
    wk.add_argument("--pipeline", required=True)
    wk.add_argument("--data-root", required=True)
    wk.add_argument("--node-id", default=None,
                    help="default: <hostname>-<pid>")
    wk.add_argument("--prefetch", type=int, default=1)
    wk.add_argument("--max-retries", type=int, default=2)
    wk.add_argument("--cache-dir", default=None,
                    help="host input cache (or $REPRO_CACHE_DIR)")
    wk.add_argument("--cache-mb", type=float, default=None,
                    help="cache budget in MiB (or $REPRO_CACHE_MAX_MB)")
    wk.add_argument("--blob-addr", default=None,
                    help="host:port to serve cached blobs to peers on "
                         "(or $REPRO_BLOB_ADDR); needs --cache-dir")
    wk.add_argument("--device", default=None,
                    help="cuda (the default; must exist) or cpu")
    args = ap.parse_args()

    # allocator hygiene for this process's children (the LD_PRELOAD part)
    # and its own allocations; REPRO_ENV_PROFILE=off opts out — see
    # launch/env.py
    from ..launch.env import apply_env_profile
    apply_env_profile("coordinator" if args.cmd == "serve" else "worker")

    if args.cmd == "serve":
        from ..core.query import load_units
        units = load_units(Path(args.units))
        if args.journal:
            from .journal import Journal
            journal = Journal(args.journal, fsync=args.fsync)
            if journal.exists():
                # a previous incarnation died here: its journal, not the
                # --units file, is the authoritative state
                queue = WorkQueue.recover(journal,
                                          lease_ttl_s=args.lease_ttl)
                done = len(queue.done_status())
                print(f"recovered journal {args.journal}: "
                      f"{len(queue.units)} units, {done} already terminal",
                      flush=True)
            else:
                queue = WorkQueue(units, (), lease_ttl_s=args.lease_ttl,
                                  journal=journal)
        else:
            queue = WorkQueue(units, (), lease_ttl_s=args.lease_ttl)
        host, port = parse_addr(args.addr)
        server = QueueServer(queue, host, port).start()
        print(f"queue server on {server.addr_str}: {len(units)} units, "
              f"lease ttl {args.lease_ttl}s", flush=True)
        last_tick = time.monotonic()
        reap_after = last_tick
        try:
            while not queue.finished():
                time.sleep(args.reap_interval)
                tick = time.monotonic()
                if tick - last_tick > args.reap_interval + WORKER_HEARTBEAT_S:
                    # this loop overslept by more than a heartbeat: the
                    # process stalled, and the handler threads that take the
                    # workers' heartbeats stalled with it. Their silence is
                    # no evidence of death: let two beats land first.
                    reap_after = tick + 2 * WORKER_HEARTBEAT_S
                last_tick = tick
                if tick < reap_after:
                    continue
                reaped = queue.reap()
                if reaped:
                    print(f"reaped units {reaped} "
                          f"(alive: {queue.alive_nodes()})", flush=True)
        finally:
            server.stop()
        status = queue.done_status()
        ok = sum(1 for s in status.values() if s == "ok")
        print(f"finished: {ok}/{len(units)} ok", flush=True)
        raise SystemExit(0 if len(status) == len(units)
                         and all(s in ("ok", "skipped")
                                 for s in status.values()) else 1)

    # work
    if not args.addr:
        ap.error(f"--addr or ${QUEUE_ADDR_ENV} is required")
    from .cluster import run_worker            # late: pulls in the pipelines
    node_id = args.node_id or f"{socket.gethostname()}-{os.getpid()}"
    if args.cache_dir:                       # explicit flags beat the env
        os.environ["REPRO_CACHE_DIR"] = args.cache_dir
    if args.cache_mb is not None:
        os.environ["REPRO_CACHE_MAX_MB"] = str(args.cache_mb)
    if args.blob_addr:
        os.environ["REPRO_BLOB_ADDR"] = args.blob_addr
    try:
        processed = run_worker(parse_addr(args.addr), args.pipeline,
                               Path(args.data_root), node_id,
                               prefetch=args.prefetch,
                               max_retries=args.max_retries,
                               device=args.device)
    except (ConnectionError, OSError) as e:
        # the coordinator is gone (job finished, or not up yet): a worker
        # host exits quietly — its silence is the signal the reaper handles
        print(f"{node_id}: queue at {args.addr} unreachable ({e})", flush=True)
        raise SystemExit(3)
    print(f"{node_id}: processed {processed} unit(s)", flush=True)


if __name__ == "__main__":
    _main()
