"""Multi-node work-stealing executor: ``LocalRunner``'s stage graph
(prefetch -> compute -> arbitrated commit) generalized across N nodes.

The paper's burst path runs one pipelined executor per host; this module is
the next rung — a cluster of :class:`Node` workers draining one
:class:`~repro_torch.dist.queue.WorkQueue` of work units:

* **Per-node prefetch** — each node leases a small in-hand window of units
  and verifies+loads their inputs (``sha256_load_array``, one read per byte)
  on a loader thread while the current unit computes. Only *leased* units are
  prefetched, so work-stealing never invalidates a node's prefetch.
* **Work stealing** — a node that drains its deque steals the tail half of
  the longest peer deque, keeping completion counts balanced under
  heterogeneous node speeds (the paper's low-cost-hardware setting).
* **Cross-node speculation** — the coordinator watches compute start times;
  a unit running ``straggler_factor`` x the cluster-wide median gets a twin
  lease on a *different* node. Twins race the primary through the same
  idempotent atomic tmp+rename commit with exactly-one-ok-provenance
  arbitration (``repro_torch.core.workflow``), and every duplicate is
  reported as ``status="speculative"`` so per-image counts stay exact.
* **Heartbeats + lease reaping** — nodes heartbeat on a timer decoupled from
  compute; when a node misses ``lease_ttl_s`` of heartbeats the coordinator
  reaps it, requeuing its leased + queued units (lease epoch bumps) onto the
  surviving nodes. A zombie that later commits anyway loses the commit
  arbitration and surfaces as ``skipped``.

Every node<->coordinator interaction goes through the ``WorkQueue`` method
surface, which *is* an RPC boundary: with ``transport="rpc"`` the
coordinator serves its queue over ``repro_torch.dist.rpc`` and every local
:class:`Node` talks to it through a
:class:`~repro_torch.dist.rpc.QueueClient` socket — and worker processes on
other hosts join the same queue via :func:`run_worker` (or ``python -m
repro_torch.dist.rpc work``), register themselves, steal work, and commit to
shared storage. Their results flow back as ``complete(meta=...)`` payloads
and are folded into the coordinator's result list from
``results_snapshot()``. Long-haul leases stay alive through the node
heartbeat thread's **renewal loop** (``renew`` per held lease), and each
host serves repeated inputs from its content-addressed
:class:`~repro_torch.dist.cache.InputCache` instead of shared storage.

The coordinator loop, the local nodes and (over rpc) the queue server share
one process, so a stall of the whole process (a C call holding the GIL, a
starved CPU) silences every local heartbeat at once. The loop sees such a
stall as its own oversleep and does not reap on it: it waits two heartbeat
intervals for the nodes to beat again. The reference reaps on every tick,
and a stall longer than ``lease_ttl_s`` there declares every node dead
("all nodes dead with N units pending"; ROADMAP.md, F3).

Failure model: fail-stop nodes (crash = heartbeat silence; no Byzantine
nodes), shared storage survives node death, and commits are atomic. Under
those assumptions every unit ends in exactly one committed ok provenance (or
a terminal ``failed`` after per-node retries), no matter how many nodes die
or how many twins race — see ``docs/cluster.md``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from ..core.pipelines import Pipeline
from ..core.query import WorkUnit
from ..core.workflow import (StragglerDetector, UnitResult, dedupe_results,
                             run_unit, run_unit_with_retries,
                             safe_load_unit_inputs)
from ..device import DeviceLike
from .cache import InputCache, cache_from_env
from .queue import Lease, WorkQueue


def result_meta(res: UnitResult) -> dict:
    """JSON-safe result payload attached to ``complete`` so coordinators in
    other processes can rebuild a :class:`UnitResult` (sans the unit object,
    which both sides already hold by index). Carries the data-movement
    stamps too, so ``results_snapshot`` shows cache hit-rates and placement
    quality without anyone grepping provenance files."""
    return {"seconds": res.seconds, "attempts": res.attempts,
            "error": res.error, "bytes_from_cache": res.bytes_from_cache,
            "bytes_from_peer": res.bytes_from_peer,
            "locality_score": res.locality_score}


def _meta_result(unit: WorkUnit, m: dict) -> UnitResult:
    return UnitResult(unit, m["status"], m.get("seconds", 0.0),
                      m.get("attempts", 1), m.get("error"),
                      bytes_from_cache=m.get("bytes_from_cache", 0),
                      bytes_from_peer=m.get("bytes_from_peer", 0),
                      locality_score=m.get("locality_score", 0.0))


class Node:
    """One thread-backed worker: lease -> prefetch -> compute -> record.

    The worker thread is named after ``node_id`` so test fault hooks can
    target a node via ``threading.current_thread().name``. :meth:`kill`
    simulates a crash: the heartbeat stops immediately and no further unit is
    started — in-hand leases die with the node and are reaped by the
    coordinator. ``die_after=k`` self-crashes the node after recording ``k``
    units (fault injection for dead-node requeue tests).

    ``pipeline`` is either a single :class:`Pipeline` (every unit runs it,
    the original shape) or a ``Mapping[str, Pipeline]`` resolved per unit by
    ``unit.pipeline`` name — what a staged campaign DAG needs, where one
    queue mixes stages of different pipelines. A unit naming a pipeline the
    mapping lacks fails terminally (and blocks its DAG descendants) instead
    of crashing the node.
    """

    def __init__(self, node_id: str, queue: WorkQueue, pipeline,
                 data_root: Path,
                 record: Optional[Callable[[int, UnitResult, Lease],
                                           None]] = None, *,
                 prefetch: int = 1, max_retries: int = 2,
                 backoff_s: float = 0.05,
                 fault_hook: Optional[Callable[[WorkUnit, int], None]] = None,
                 hb_interval_s: float = 0.25, poll_s: float = 0.02,
                 die_after: Optional[int] = None,
                 cache: Optional[InputCache] = None, renew: bool = True,
                 summary_cursor: Optional[int] = None,
                 blob_server=None):
        self.node_id = node_id
        self.queue = queue
        self.pipeline = pipeline
        self.data_root = Path(data_root)
        self.record = record
        self.prefetch = max(0, int(prefetch))
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.fault_hook = fault_hook
        self.hb_interval_s = hb_interval_s
        self.poll_s = poll_s
        self.die_after = die_after
        self.cache = cache
        self.renew = renew
        # the host's BlobServer (peer fabric), when this node owns one: its
        # lifecycle is tied to the node — kill() stops it, so a simulated
        # node crash takes the host's serving down with it, exactly like a
        # real host dying mid-transfer (peers see a connection error and
        # fall back to shared storage)
        self.blob_server = blob_server
        # cache op-log position last pushed; a caller that already announced
        # the full summary (run_worker piggybacks it on register) hands the
        # sync cursor in, so the loop doesn't re-send an identical full push
        self._summary_cursor = summary_cursor or 0
        self._summary_pushed = summary_cursor is not None
        self._fabric_announced = False
        # reconnect-aware transports tell us when the coordinator was
        # replaced: everything we pushed (summary, blob addr) died with the
        # old incarnation, so flag both for a re-push on the next heartbeat
        hook = getattr(queue, "add_restart_hook", None)
        if hook is not None:
            hook(self._on_coordinator_restart)
        self.killed = threading.Event()
        self.processed = 0
        self.lease_lost = 0                  # renewals rejected (stale epoch)
        self.crash: Optional[str] = None
        self._held: set = set()              # (unit_idx, epoch) in-hand leases
        self._held_lock = threading.Lock()
        self._loader = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"{node_id}-loader")
        self._worker = threading.Thread(
            target=self._work, name=node_id, daemon=True)
        self._hb = threading.Thread(
            target=self._heartbeat, name=f"{node_id}-hb", daemon=True)

    def _pipeline_for(self, unit: WorkUnit) -> Optional[Pipeline]:
        if isinstance(self.pipeline, Mapping):
            return self.pipeline.get(unit.pipeline)
        return self.pipeline

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        self._worker.start()
        self._hb.start()

    def kill(self):
        """Crash the node: heartbeat and compute stop, leases go down with
        it — and so does the host's blob server, mid-transfer included."""
        self.killed.set()
        if self.blob_server is not None:
            try:
                self.blob_server.stop()
            except Exception:  # noqa: BLE001 — a dying node stays dead
                pass
        fabric = getattr(self.cache, "fabric", None)
        if fabric is not None:
            try:
                fabric.close()           # pooled peer connections
            except Exception:  # noqa: BLE001
                pass

    def join(self, timeout: Optional[float] = None):
        self._worker.join(timeout)

    def is_alive(self) -> bool:
        return self._worker.is_alive()

    # -- stages -------------------------------------------------------------

    def _push_summary(self):
        """Full digest-summary push for this host's cache — the coordinator
        learns what bytes this node already holds before it makes any
        placement decision for it. Best-effort: an old coordinator (no
        ``put_summary``) leaves the run locality-blind, never broken."""
        if self.cache is None or self._summary_pushed:
            return
        cursor, wire = self.cache.summary_sync()
        try:
            put = getattr(self.queue, "put_summary", None)
            if put is not None and put(self.node_id, wire) is not False:
                self._summary_cursor = cursor
                self._summary_pushed = True
        except RuntimeError:
            pass                           # pre-summary coordinator: blind

    def _on_coordinator_restart(self):
        """Restart-hook body (fires on whichever thread detected the new
        incarnation): only flips flags — the heartbeat loop does the actual
        re-pushing on its next beat, off the detecting thread's hot path."""
        self._summary_pushed = False
        self._fabric_announced = False

    def _announce_fabric(self):
        """Advertise this host's blob server to the coordinator (a register
        refresh carrying ``blob_addr``), so locate_blobs can route peers
        here. Best-effort with the same downgrade discipline as summaries:
        an old coordinator (TypeError on the param) leaves this host
        fabric-invisible — it still fetches from peers, never serves."""
        if self.blob_server is None or self._fabric_announced:
            return
        try:
            self.queue.register(self.node_id,
                                blob_addr=self.blob_server.advertise)
            self._fabric_announced = True
        except (TypeError, RuntimeError, ConnectionError):
            pass                       # pre-fabric coordinator: unadvertised

    def _summary_delta(self):
        """Delta wire for the heartbeat piggyback (None when the transport
        downgraded to the pre-summary protocol)."""
        if self.cache is None:
            return None
        cursor, wire = self.cache.summary_delta_since(self._summary_cursor)
        self._summary_cursor = cursor
        return wire

    def _heartbeat(self):
        """Node-level heartbeat plus the lease renewal loop: every interval,
        re-assert liveness — piggybacking the cache digest-summary delta, so
        coordinator-side placement scoring tracks this host's cache within a
        heartbeat — and renew each in-hand lease. A rejected renewal
        (the coordinator reaped us or re-granted the unit — WAN-scale TTLs
        make this routine) is counted and the stale lease dropped from the
        renew set; the unit itself still runs to completion, where commit
        arbitration makes the zombie write harmless."""
        while not self.killed.is_set():
            try:
                # no-ops while already pushed/announced; after a detected
                # coordinator restart the flags are down and the new
                # incarnation gets the full summary + blob addr within one
                # beat, without manual intervention
                self._push_summary()
                self._announce_fabric()
                self.queue.heartbeat(self.node_id,
                                     summary_delta=self._summary_delta())
                if self.renew:
                    with self._held_lock:
                        held = sorted(self._held)
                    verdicts = self._renew_held(held) if held else []
                    for (idx, epoch), ok in zip(held, verdicts):
                        if ok:
                            continue
                        with self._held_lock:
                            # only a lease we still hold counts as lost —
                            # a renew losing the race with its own unit's
                            # completion is routine, not a WAN event
                            lost = (idx, epoch) in self._held
                            self._held.discard((idx, epoch))
                        if lost:
                            self.lease_lost += 1
            except ConnectionError:
                return                       # transport gone: die silent,
            self.killed.wait(self.hb_interval_s)  # the reaper does the rest

    def _renew_held(self, held):
        """Renew a snapshot of in-hand leases: one ``renew_batch`` round trip
        when the queue has it (in-process queues and new coordinators via
        the shedding client), else per-op renews — same verdicts, N trips."""
        batch = getattr(self.queue, "renew_batch", None)
        if batch is not None:
            return batch(self.node_id, [[i, e] for i, e in held])
        return [self.queue.renew(i, self.node_id, e) for i, e in held]

    def _next_units(self, max_units: int):
        """Grant up to ``max_units`` leases: one ``next_units`` round trip
        when the queue has it, else one per-op grant (the caller's top-up
        loop keeps asking, preserving the old shape)."""
        batch = getattr(self.queue, "next_units", None)
        if batch is not None:
            return batch(self.node_id, max_units)
        got = self.queue.next_unit(self.node_id)
        return [] if got is None else [got]

    def _safe_load(self, unit: WorkUnit):
        return safe_load_unit_inputs(unit, self.data_root, cache=self.cache)

    def _report(self, idx: int, res: UnitResult, lease: Lease):
        """Commit a finished unit through this node's *own* queue handle.

        Over rpc that means the completion travels the node's socket — the
        one that survives (reconnects across) a coordinator restart — rather
        than a coordinator-side closure holding a reference to a queue
        object that may since have been replaced by recovery. The optional
        ``record`` callback is pure local bookkeeping (provenance fold,
        per-node tallies) and runs after the commit is accepted."""
        self.queue.complete(idx, lease.node_id, res.status,
                            speculative=lease.speculative,
                            meta=result_meta(res))
        if self.record is not None:
            self.record(idx, res, lease)

    def _work(self):
        inhand: deque = deque()            # [(unit, lease, load_future|None)]
        try:
            # announce this host's warm bytes before asking for work: the
            # very first grant can then already be locality-aware — and its
            # blob server, so peers can start pulling from it just as early
            self._push_summary()
            self._announce_fabric()
            while not self.killed.is_set():
                # top up the leased in-hand window — the whole shortfall in
                # one (batched) ask; prefetch primary inputs (a speculative
                # twin skips prefetch — it must start *now*)
                while len(inhand) < 1 + self.prefetch:
                    need = 1 + self.prefetch - len(inhand)
                    grants = self._next_units(need)
                    for unit, lease in grants:
                        with self._held_lock:
                            self._held.add((lease.unit_idx, lease.epoch))
                        fut = (None if lease.speculative
                               else self._loader.submit(self._safe_load, unit))
                        if lease.speculative:
                            inhand.appendleft((unit, lease, fut))
                        else:
                            inhand.append((unit, lease, fut))
                    if len(grants) < need:
                        break              # nothing more leasable right now
                if not inhand:
                    if self.queue.finished():
                        break
                    time.sleep(self.poll_s)
                    continue
                unit, lease, fut = inhand.popleft()
                if self.killed.is_set():
                    break
                idx = lease.unit_idx
                pipe = self._pipeline_for(unit)
                if pipe is None:
                    # a unit naming a pipeline this node doesn't carry is a
                    # terminal config failure, not a node crash: record it
                    # and keep working (its DAG descendants go blocked)
                    self.processed += 1
                    with self._held_lock:
                        self._held.discard((idx, lease.epoch))
                    self._report(idx, UnitResult(
                        unit, "failed", 0.0, attempts=1,
                        error=f"no pipeline named {unit.pipeline!r} "
                              f"available on node {self.node_id}"), lease)
                    continue
                pre = fut.result() if fut is not None else None
                # straggler clock starts at compute, not at the input load —
                # a slow prefetch must not trigger spurious speculation
                self.queue.mark_started(idx)
                # grant-time placement estimate, normalized to the unit's
                # input bytes — stamped into provenance as locality_score
                total = unit.total_input_bytes
                score = (min(1.0, lease.local_bytes / total) if total else 0.0)
                if lease.speculative:
                    res = run_unit(unit, pipe, self.data_root,
                                   attempt=self.max_retries + 2,
                                   fault_hook=self.fault_hook,
                                   node_id=self.node_id,
                                   lease_epoch=lease.epoch, cache=self.cache,
                                   locality_score=score)
                else:
                    res = run_unit_with_retries(
                        unit, pipe, self.data_root,
                        max_retries=self.max_retries,
                        backoff_s=self.backoff_s, fault_hook=self.fault_hook,
                        preloaded=pre, node_id=self.node_id,
                        lease_epoch=lease.epoch, cache=self.cache,
                        locality_score=score)
                self.processed += 1
                with self._held_lock:
                    self._held.discard((idx, lease.epoch))
                self._report(idx, res, lease)
                if self.die_after is not None and self.processed >= self.die_after:
                    self.kill()
        except Exception:  # noqa: BLE001 — a crashed node is a dead node
            self.crash = traceback.format_exc(limit=5)
            try:
                self.queue.mark_dead(self.node_id)
            except ConnectionError:
                pass     # transport already gone: silence reaches the reaper
        finally:
            self._loader.shutdown(wait=False)


@dataclasses.dataclass
class ClusterStats:
    """Per-run observability: what the control plane actually did."""
    processed: Dict[str, int]
    steals: Dict[str, int]
    requeued: List[int]
    speculated: int
    dead_nodes: List[str]
    remote_nodes: List[str] = dataclasses.field(default_factory=list)
    renew_rejections: int = 0
    cache: Optional[Dict[str, int]] = None    # coordinator-host cache stats
                                              # (summed over per-node caches)
    locality: Optional[Dict[str, int]] = None  # queue placement counters
    cache_by_node: Optional[Dict[str, Dict[str, int]]] = None
    fabric: Optional[Dict[str, int]] = None    # locate_blobs routing counters
    peer_links: Optional[Dict[str, Dict[str, int]]] = None
    # ^ {fetcher node: {peer addr: bytes}} — who pulled how much from whom


class ClusterRunner:
    """Drive ``nodes`` :class:`Node` workers over one unit list.

    Same result contract as ``LocalRunner.run``: one result per unit with a
    committed status, plus ``status="speculative"`` rows for every duplicate
    (twins and zombie re-runs) so ok-counts are never inflated. After
    :meth:`run`, :attr:`stats` holds steal/requeue/speculation counters.

    Transport injection: with ``transport="local"`` (default) nodes call the
    in-process :class:`WorkQueue` directly; with ``transport="rpc"`` the
    coordinator serves the queue over ``repro_torch.dist.rpc`` and every
    node — still threads here — talks to it through a socket-backed
    :class:`~repro_torch.dist.rpc.QueueClient`, byte-identical to what a
    worker on another machine uses. ``serve_addr`` (``"host:port"``, port
    0 = ephemeral; implied by ``transport="rpc"``) additionally opens the
    queue to external worker processes (:func:`run_worker`): they register,
    steal work, commit to shared storage, and their results are folded in
    from ``results_snapshot()``. ``cache_dir`` gives the coordinator host
    one content-addressed input cache shared by its nodes
    (``cache_per_node``: one per node, the multi-host shape; with
    ``peer_fabric`` each serves its blobs to the others). ``pipeline`` may
    be a single :class:`Pipeline` or a ``Mapping[str, Pipeline]`` resolved
    per unit by name (staged DAG campaigns mix pipelines in one queue)."""

    def __init__(self, pipeline, data_root: Path, *,
                 nodes: int = 4, prefetch: int = 1, max_retries: int = 2,
                 backoff_s: float = 0.05, straggler_factor: float = 3.0,
                 straggler_min_s: float = 0.5, lease_ttl_s: float = 2.0,
                 hb_interval_s: float = 0.25, poll_s: float = 0.05,
                 fault_hook: Optional[Callable[[WorkUnit, int], None]] = None,
                 die_after: Optional[Dict[str, int]] = None,
                 transport: str = "local", serve_addr: Optional[str] = None,
                 cache_dir: Optional[Path] = None,
                 cache_bytes: Optional[int] = None,
                 cache_per_node: bool = False, peer_fabric: bool = False,
                 locality: bool = True, partition: str = "round_robin",
                 plan=None, journal_dir: Optional[Path] = None,
                 journal_overwrite: bool = False,
                 client_kwargs: Optional[Dict] = None,
                 client_dial: Optional[Callable] = None):
        if nodes < 1:
            raise ValueError("need at least one node")
        if transport not in ("local", "rpc"):
            raise ValueError(f"unknown transport {transport!r}")
        if peer_fabric and not (cache_dir and cache_per_node):
            # the fabric is a between-hosts construct: it needs one cache
            # per simulated host to have distinct peers to route between
            raise ValueError("peer_fabric needs cache_dir + cache_per_node")
        self.pipeline = pipeline
        self.data_root = Path(data_root)
        self.n_nodes = int(nodes)
        self.prefetch = prefetch
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.straggler_factor = straggler_factor
        self.straggler_min_s = straggler_min_s
        self.lease_ttl_s = lease_ttl_s
        self.hb_interval_s = hb_interval_s
        self.poll_s = poll_s
        self.fault_hook = fault_hook
        self.die_after = dict(die_after or {})
        self.transport = transport
        self.serve_addr = serve_addr
        self.cache_dir = cache_dir
        self.cache_bytes = cache_bytes
        # cache_per_node gives every local node its own cache dir
        # (cache_dir/<node_id>) — the multi-host shape (one cache per host)
        # simulated in one process, which is what makes locality-aware
        # placement testable and benchmarkable without a real cluster
        self.cache_per_node = cache_per_node
        # peer_fabric starts one BlobServer per node cache (loopback,
        # ephemeral ports) and attaches a PeerFabric to each cache, so a
        # node's local miss streams from whichever sibling already holds
        # the blob — the multi-host content-delivery tier in one process
        self.peer_fabric = peer_fabric
        self.locality = locality
        self.partition = partition
        # a CampaignPlan (repro_torch.core.campaign) seeds the queue's
        # per-node partitions from the admission-time shards: the cluster
        # starts on the warm placement the planner computed instead of
        # rediscovering it grant by grant (plan implies partition="plan")
        self.plan = plan
        # journal_dir turns on the coordinator write-ahead log: every queue
        # mutation is journaled there, and restart_coordinator() (or a fresh
        # process pointed at the same dir) can rebuild the queue mid-run.
        # run() refuses a directory that already holds a journal unless
        # journal_overwrite=True — the leftover is a crashed run's only
        # recoverable state (`rpc serve` recovers it; see docs/operating.md)
        self.journal_dir = Path(journal_dir) if journal_dir else None
        self.journal_overwrite = bool(journal_overwrite)
        # client_kwargs feed every node's QueueClient (e.g. {"binary": False}
        # pins JSON framing; reconnect knobs); client_dial rewrites the
        # upstream (host, port) into the address clients actually dial —
        # the hook a fault-injection proxy routes through
        self.client_kwargs = dict(client_kwargs or {})
        self.client_dial = client_dial
        self.stats: Optional[ClusterStats] = None
        self.queue: Optional[WorkQueue] = None
        self.server = None                   # QueueServer once run() serves
        self._journal = None
        self._ctl_lock = threading.Lock()    # guards restart vs shutdown
        self._stopping = False

    def node_ids(self) -> List[str]:
        return [f"node-{i}" for i in range(self.n_nodes)]

    def _make_cache(self, node_id: Optional[str] = None) -> Optional[InputCache]:
        if self.cache_dir is None:
            return None
        root = Path(self.cache_dir)
        if self.cache_per_node and node_id is not None:
            root = root / node_id
        kw = {} if self.cache_bytes is None else {"max_bytes": self.cache_bytes}
        return InputCache(root, **kw)

    def run(self, units: List[WorkUnit]) -> List[UnitResult]:
        if not units:
            return []
        node_ids = self.node_ids()
        journal = None
        if self.journal_dir is not None:
            from .journal import Journal
            journal = Journal(self.journal_dir)
            if journal.exists() and not self.journal_overwrite:
                # attaching would truncate wal.log and overwrite state.json —
                # destroying the one copy of a crashed run's recoverable
                # state. Recovery is a deliberate act (`rpc serve --journal`
                # or WorkQueue.recover), never a side effect of starting a
                # new run over the same directory.
                raise RuntimeError(
                    f"{self.journal_dir} already holds a coordinator "
                    f"journal; recover it (python -m repro_torch.dist.rpc "
                    f"serve --journal {self.journal_dir} ...) or pass "
                    f"journal_overwrite=True to discard it")
        queue = WorkQueue(units, node_ids, lease_ttl_s=self.lease_ttl_s,
                          locality=self.locality, partition=self.partition,
                          plan=self.plan, journal=journal)
        self.queue = queue
        self._journal = journal
        self._stopping = False
        serving = self.transport == "rpc" or self.serve_addr is not None
        clients = []
        if serving:
            from .rpc import QueueServer, parse_addr
            host, port = parse_addr(self.serve_addr or "127.0.0.1:0")
            self.server = QueueServer(queue, host, port).start()
        detector = StragglerDetector(self.straggler_factor,
                                     self.straggler_min_s)
        primaries: Dict[int, UnitResult] = {}
        extras: List[Tuple[int, UnitResult]] = []
        rec_lock = threading.Lock()

        def record(idx: int, res: UnitResult, lease: Lease):
            # pure coordinator-side bookkeeping: the committing complete()
            # already travelled the node's own queue handle (see
            # Node._report), so this closure never touches the queue — it
            # must stay valid across a mid-run coordinator restart
            with rec_lock:
                if lease.speculative or idx in primaries:
                    extras.append((idx, res))
                else:
                    primaries[idx] = res
                if res.status == "ok":
                    detector.observe(res.seconds)

        def node_queue():
            """The queue handle a local node drives: the in-process object,
            or a per-node socket client when the transport is rpc."""
            if self.transport != "rpc":
                return queue
            from .rpc import QueueClient
            host, port = self.server.address
            if host in ("0.0.0.0", "::", ""):    # wildcard bind: dial loopback
                host = "127.0.0.1"
            dial = (host, port)
            if self.client_dial is not None:
                dial = self.client_dial(dial)
            client = QueueClient(dial, **self.client_kwargs)
            clients.append(client)
            return client

        caches = {nid: (self._make_cache(nid) if self.cache_per_node
                        else None) for nid in node_ids}
        shared_cache = None if self.cache_per_node else self._make_cache()
        nodes = []
        for nid in node_ids:
            nq = node_queue()
            cache = caches[nid] or shared_cache
            blob_server = None
            if self.peer_fabric:
                from .blobserve import BlobServer, PeerFabric
                blob_server = BlobServer(cache).start()

                def locate(digests, _q=nq, _nid=nid):
                    loc = getattr(_q, "locate_blobs", None)
                    return loc(digests, node_id=_nid) if loc else {}

                cache.attach_fabric(PeerFabric(
                    locate, self_addr=blob_server.advertise))
            nodes.append(Node(
                nid, nq, self.pipeline, self.data_root,
                record, prefetch=self.prefetch,
                max_retries=self.max_retries, backoff_s=self.backoff_s,
                fault_hook=self.fault_hook,
                hb_interval_s=self.hb_interval_s, poll_s=self.poll_s,
                die_after=self.die_after.get(nid),
                cache=cache, blob_server=blob_server))
        local_ids = set(node_ids)
        speculated: set = set()
        log_cursor = 0
        for nd in nodes:
            nd.start()
        last_tick = time.monotonic()
        reap_after = last_tick
        try:
            # the loop re-reads self.queue every tick: restart_coordinator()
            # swaps in the recovered queue object mid-run, and monitoring
            # must follow the live incarnation (a stray call against the old
            # object is harmless — its journal is closed, appends dropped)
            while not (q := self.queue).finished():
                time.sleep(self.poll_s)
                q = self.queue
                tick = time.monotonic()
                if tick - last_tick > self.poll_s + self.hb_interval_s:
                    # this loop overslept by more than a heartbeat: the
                    # process stalled (the GIL held, the CPU taken) and the
                    # nodes' heartbeat threads, in the same process, stalled
                    # with it. Their silence is then no evidence of death:
                    # give every node two beats to land before reaping.
                    reap_after = tick + 2 * self.hb_interval_s
                last_tick = tick
                if tick >= reap_after:
                    q.reap()
                alive = set(q.alive_nodes())
                if not alive and not q.finished():
                    raise RuntimeError(
                        f"all nodes dead with {q.pending()} units pending")
                # fold remote ok durations into the straggler median so
                # cross-node speculation sees the whole cluster's pace —
                # incremental (cursor into the retirement log), so a tick's
                # cost tracks new completions, not the whole history
                for m in q.primary_log(log_cursor):
                    log_cursor += 1
                    if m["node_id"] not in local_ids and m["status"] == "ok":
                        detector.observe(m.get("seconds", 0.0))
                # cross-node straggler speculation: twin on a different node,
                # placed by the queue itself — on the node already holding
                # the most of the unit's input bytes (least-loaded when no
                # summary covers it), so the twin starts from warm local disk
                now = time.time()
                for idx, t0, holder in q.running():
                    if idx in speculated or not detector.is_straggler(now - t0):
                        continue
                    if q.speculate(idx) is not None:
                        speculated.add(idx)
        finally:
            with self._ctl_lock:
                self._stopping = True        # fence out restart_coordinator
            for nd in nodes:
                nd.kill()
            for nd in nodes:
                nd.join(timeout=5.0)
            for client in clients:
                client.close()
            if self.server is not None:
                self.server.stop()
            if self._journal is not None:
                self._journal.close()
        # units finished by worker processes (never seen by record()) come
        # back through the queue's result metadata — read from the *final*
        # queue incarnation, which holds the whole run's state whether or
        # not the coordinator was restarted along the way
        queue = self.queue
        snap = queue.results_snapshot()
        remote_primaries = {idx: m for idx, m in snap["primaries"].items()
                            if m["node_id"] not in local_ids}
        remote_processed: Dict[str, int] = {}
        for idx, m in remote_primaries.items():
            remote_processed[m["node_id"]] = \
                remote_processed.get(m["node_id"], 0) + 1
            extras.append((idx, _meta_result(units[idx], m)))
        for m in snap["duplicates"]:
            if m["node_id"] not in local_ids:
                extras.append((m["idx"], _meta_result(units[m["idx"]], m)))
        # coordinator-host cache stats: one shared cache, or the sum over the
        # per-node caches (the simulated multi-host shape)
        node_caches = {nd.node_id: nd.cache.stats() for nd in nodes
                       if nd.cache is not None}
        if shared_cache is not None:
            cache_stats = shared_cache.stats()
        elif node_caches:
            cache_stats: Dict[str, int] = {}
            for st in node_caches.values():
                for k, v in st.items():
                    if isinstance(v, (int, float)):   # skip per-addr maps
                        cache_stats[k] = cache_stats.get(k, 0) + v
        else:
            cache_stats = None
        qstats = queue.stats_snapshot()
        self.stats = ClusterStats(
            processed={**{nd.node_id: nd.processed for nd in nodes},
                       **remote_processed},
            steals=dict(queue.steals), requeued=list(queue.requeues),
            speculated=len(speculated),
            dead_nodes=[n for n in node_ids if n not in queue.alive_nodes()],
            remote_nodes=sorted(set(queue.queue_depths()) - local_ids),
            renew_rejections=queue.renew_rejections,
            cache=cache_stats,
            locality=dict(qstats["locality"]),
            cache_by_node=(node_caches if self.cache_per_node else None),
            fabric=dict(qstats.get("fabric") or {}) or None,
            peer_links={nid: dict(st["peer_bytes_by_addr"])
                        for nid, st in node_caches.items()
                        if st.get("peer_bytes_by_addr")} or None)
        # fold: exactly one committed-status result per unit; a unit whose
        # only finisher was a twin (primary died mid-flight) promotes it
        pending_extras: List[Tuple[int, UnitResult]] = []
        for idx, res in sorted(extras, key=lambda e: e[1].status != "ok"):
            if idx not in primaries:
                primaries[idx] = res
            else:
                pending_extras.append((idx, res))
        # DAG failure policy: descendants of a terminally-failed parent were
        # never granted (no node ever saw them), so they have no completion
        # record anywhere — synthesize their terminal ``blocked`` result
        # instead of mistaking them for lost work
        for idx, st in queue.done_status().items():
            if st == "blocked" and idx not in primaries:
                primaries[idx] = UnitResult(
                    units[idx], "blocked", 0.0, attempts=0,
                    error="blocked: a depends_on ancestor failed terminally")
        if len(primaries) < len(units):
            crashes = "; ".join(nd.crash for nd in nodes if nd.crash)
            raise RuntimeError(
                f"{len(units) - len(primaries)} unit(s) ended without a "
                f"result{': ' + crashes if crashes else ''}")
        order = sorted(primaries)
        pos = {idx: p for p, idx in enumerate(order)}
        return dedupe_results([primaries[idx] for idx in order],
                              [(pos[idx], res) for idx, res in pending_extras])

    def restart_coordinator(self) -> Optional[Dict[str, float]]:
        """Kill the live coordinator mid-run and bring up a recovered one on
        the same port — the crash-recovery drill, callable from any thread
        while :meth:`run` is in flight.

        Requires ``transport="rpc"`` (clients must be able to redial; local
        nodes hold direct object references that recovery can't swap) and a
        ``journal_dir``. The sequence is exactly what a fresh process
        pointed at the journal would do: hard-crash the server (no drain —
        this simulates a dying host, in-flight frames are torn),
        close the old journal (fencing any zombie appends), replay
        snapshot + WAL tail into a new :class:`WorkQueue`, and rebind a
        :class:`~repro_torch.dist.rpc.QueueServer` on the *same* host:port so
        reconnecting clients land on the new incarnation without
        re-resolution. Returns timing/recovery facts, or ``None`` when the
        run is already shutting down (the race is expected under chaos
        harnesses — callers treat ``None`` as "too late, stand down")."""
        if self.transport != "rpc":
            raise ValueError("restart_coordinator needs transport='rpc'")
        if self.journal_dir is None:
            raise ValueError("restart_coordinator needs a journal_dir")
        from .journal import Journal
        from .rpc import QueueServer
        with self._ctl_lock:
            if self._stopping or self.server is None or self._journal is None:
                return None
            t0 = time.monotonic()
            host, port = self.server.address
            self.server.crash()
            self._journal.close()
            journal = Journal(self.journal_dir)
            q = WorkQueue.recover(journal, lease_ttl_s=self.lease_ttl_s,
                                  locality=self.locality)
            t_recovered = time.monotonic()
            self.queue = q
            self._journal = journal
            self.server = QueueServer(q, host, port).start()
            return {"recover_s": t_recovered - t0,
                    "total_s": time.monotonic() - t0,
                    "done": float(len(q.done_status())),
                    "pending": float(q.pending())}


def run_worker(addr, pipeline, data_root: Path, node_id: str, *,
               prefetch: int = 1, max_retries: int = 2,
               backoff_s: float = 0.05, hb_interval_s: float = 0.25,
               poll_s: float = 0.05,
               cache: Optional[InputCache] = None,
               device: DeviceLike = None) -> int:
    """Join a remote queue as one worker host and drain it: the process
    behind ``python -m repro_torch.dist.rpc work``.

    Dials ``addr``, registers ``node_id`` — announcing the host cache's
    digest summary, so a warm worker is placed locality-aware from its first
    grant — and runs one :class:`Node` loop — the same code the
    coordinator's threads run — against the socket-backed queue, with inputs
    served through this host's content-addressed cache
    (default: built from ``$REPRO_CACHE_DIR`` / ``$REPRO_CACHE_MAX_MB``).
    A string ``pipeline`` names one of ``builtin_pipelines(device)``
    (``"auto"``: all of them); ``device`` ``None`` means ``cuda``, which
    must exist.

    Peer fabric: with a cache configured, the worker joins the blob fabric
    as a *fetcher* automatically (local misses try warm peers before shared
    storage; disable with ``$REPRO_PEER_FETCH=0``), and as a *server* when
    ``$REPRO_BLOB_ADDR`` names a ``host:port`` to serve cached blobs on —
    the advertised address rides ``register``, and a coordinator that
    predates the fabric degrades both halves to plain storage reads.
    Results travel back as ``complete(meta=...)`` payloads; outputs and
    provenance are committed to shared storage exactly as in-process nodes
    commit them, so the coordinator's exactly-one-ok arbitration spans
    processes for free. Returns the number of units this worker recorded.
    A lost coordinator (connection drop) ends the worker quietly: its
    silence is the crash signal the reaper is built around."""
    import os as _os
    from ..core.pipelines import builtin_pipelines
    from .blobserve import (BLOB_ADDR_ENV, PEER_FETCH_ENV, BlobServer,
                            PeerFabric, parse_blob_addr)
    from .rpc import QueueClient
    if isinstance(pipeline, str):
        # "auto" hands the node the whole builtin registry, resolved per
        # unit by name — what a worker joining a staged (mixed-pipeline)
        # DAG campaign wants; any other string names a single pipeline
        pipes = builtin_pipelines(device)
        pipeline = pipes if pipeline == "auto" else pipes[pipeline]
    if cache is None:
        cache = cache_from_env()
    client = QueueClient(addr)
    cursor = summary = None
    blob_server = None
    if cache is not None:
        cursor, summary = cache.summary_sync()
        raw = _os.environ.get(BLOB_ADDR_ENV)
        if raw:
            blob_server = BlobServer(cache, *parse_blob_addr(raw)).start()
        if _os.environ.get(PEER_FETCH_ENV, "1") != "0":
            cache.attach_fabric(PeerFabric(
                lambda digests: client.locate_blobs(digests, node_id=node_id),
                self_addr=blob_server.advertise if blob_server else None))
    try:
        if not client.register(node_id, summary=summary,
                               blob_addr=(blob_server.advertise
                                          if blob_server else None)):
            raise RuntimeError(
                f"queue at {addr} rejected node id {node_id!r} "
                "(reaped earlier? rejoin under a fresh id)")

        # no record callback: the Node commits every completion through its
        # own client handle (Node._report), which is also what lets a
        # reconnecting worker keep committing across a coordinator restart
        node = Node(node_id, client, pipeline, Path(data_root),
                    prefetch=prefetch, max_retries=max_retries,
                    backoff_s=backoff_s, hb_interval_s=hb_interval_s,
                    poll_s=poll_s, cache=cache, summary_cursor=cursor,
                    blob_server=blob_server)
        blob_server = None               # the node owns its shutdown now
        node.start()
        try:
            while node.is_alive():
                node.join(timeout=poll_s * 4)
        except KeyboardInterrupt:
            node.kill()
            node.join(timeout=5.0)
        finally:
            node.kill()                  # stops the blob server too
            client.close()
        return node.processed
    finally:
        if blob_server is not None:      # register failed before handoff
            blob_server.stop()
