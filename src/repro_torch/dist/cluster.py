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
surface, which *is* an RPC boundary. The port runs it in process
(``transport="local"``): every :class:`Node` is a thread calling the one
:class:`~repro_torch.dist.queue.WorkQueue`, and inputs are served from each
host's content-addressed :class:`~repro_torch.dist.cache.InputCache`
instead of shared storage. The reference's socket transport
(``transport="rpc"``, ``serve_addr``, worker processes joining through
``run_worker``), its coordinator restart and its peer blob fabric need
``dist/rpc.py`` and ``dist/blobserve.py``, which the port does not have yet
(ROADMAP.md, Queue 1 item 3b): those settings raise
``NotImplementedError``. Nodes heartbeat through a **renewal loop**
(``renew`` per held lease), so a lease stays alive as long as its holder
does.

The coordinator loop and the nodes share one process, so a stall of the
whole process (a C call holding the GIL, a starved CPU) silences every
heartbeat at once. The loop sees such a stall as its own oversleep and does
not reap on it: it waits two heartbeat intervals for the nodes to beat
again. The reference reaps on every tick, and a stall longer than
``lease_ttl_s`` there declares every node dead ("all nodes dead with N
units pending"; ROADMAP.md, F3).

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
from ._pending import not_ported
from .cache import InputCache
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
                 cache: Optional[InputCache] = None, renew: bool = True):
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
        self._summary_cursor = 0         # cache op-log position last pushed
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
        it."""
        self.killed.set()

    def join(self, timeout: Optional[float] = None):
        self._worker.join(timeout)

    def is_alive(self) -> bool:
        return self._worker.is_alive()

    # -- stages -------------------------------------------------------------

    def _push_summary(self):
        """Full digest-summary push for this host's cache — the coordinator
        learns what bytes this node already holds before it makes any
        placement decision for it. A push the queue refuses leaves the
        cursor where it was, and the next heartbeat's delta falls back to
        a full summary."""
        if self.cache is None:
            return
        cursor, wire = self.cache.summary_sync()
        if self.queue.put_summary(self.node_id, wire):
            self._summary_cursor = cursor

    def _summary_delta(self):
        """Delta wire for the heartbeat piggyback (None without a cache)."""
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
            self.queue.heartbeat(self.node_id,
                                 summary_delta=self._summary_delta())
            if self.renew:
                with self._held_lock:
                    held = sorted(self._held)
                verdicts = (self.queue.renew_batch(
                    self.node_id, [[i, e] for i, e in held]) if held else [])
                for (idx, epoch), ok in zip(held, verdicts):
                    if ok:
                        continue
                    with self._held_lock:
                        # only a lease we still hold counts as lost — a
                        # renew losing the race with its own unit's
                        # completion is routine, not a WAN event
                        lost = (idx, epoch) in self._held
                        self._held.discard((idx, epoch))
                    if lost:
                        self.lease_lost += 1
            self.killed.wait(self.hb_interval_s)

    def _safe_load(self, unit: WorkUnit):
        return safe_load_unit_inputs(unit, self.data_root, cache=self.cache)

    def _report(self, idx: int, res: UnitResult, lease: Lease):
        """Commit a finished unit through this node's own queue handle,
        with its result as ``meta`` (what the journal records). The
        optional ``record`` callback is pure local bookkeeping (provenance
        fold, per-node tallies) and runs after the commit is accepted."""
        self.queue.complete(idx, lease.node_id, res.status,
                            speculative=lease.speculative,
                            meta=result_meta(res))
        if self.record is not None:
            self.record(idx, res, lease)

    def _work(self):
        inhand: deque = deque()            # [(unit, lease, load_future|None)]
        try:
            # announce this host's warm bytes before asking for work: the
            # very first grant can then already be locality-aware
            self._push_summary()
            while not self.killed.is_set():
                # top up the leased in-hand window — the whole shortfall in
                # one (batched) ask; prefetch primary inputs (a speculative
                # twin skips prefetch — it must start *now*)
                while len(inhand) < 1 + self.prefetch:
                    need = 1 + self.prefetch - len(inhand)
                    grants = self.queue.next_units(self.node_id, need)
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
            self.queue.mark_dead(self.node_id)
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
    renew_rejections: int = 0
    cache: Optional[Dict[str, int]] = None    # coordinator-host cache stats
                                              # (summed over per-node caches)
    locality: Optional[Dict[str, int]] = None  # queue placement counters
    cache_by_node: Optional[Dict[str, Dict[str, int]]] = None


class ClusterRunner:
    """Drive ``nodes`` :class:`Node` workers over one unit list.

    Same result contract as ``LocalRunner.run``: one result per unit with a
    committed status, plus ``status="speculative"`` rows for every duplicate
    (twins and zombie re-runs) so ok-counts are never inflated. After
    :meth:`run`, :attr:`stats` holds steal/requeue/speculation counters.

    Nodes are threads calling the in-process :class:`WorkQueue` directly
    (``transport="local"``). ``transport="rpc"``, ``serve_addr`` and
    ``peer_fabric=True`` need ``dist/rpc.py`` / ``dist/blobserve.py``, which
    the port does not have yet, and raise ``NotImplementedError``.
    ``cache_dir`` gives the coordinator host one content-addressed input
    cache shared by its nodes (``cache_per_node``: one per node, the
    multi-host shape). ``pipeline`` may be a single :class:`Pipeline` or a
    ``Mapping[str, Pipeline]`` resolved per unit by name (staged DAG
    campaigns mix pipelines in one queue)."""

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
                 journal_overwrite: bool = False):
        if nodes < 1:
            raise ValueError("need at least one node")
        if transport not in ("local", "rpc"):
            raise ValueError(f"unknown transport {transport!r}")
        if transport == "rpc":
            raise not_ported('ClusterRunner(transport="rpc")', "dist/rpc.py")
        if serve_addr is not None:
            raise not_ported("ClusterRunner(serve_addr=...)", "dist/rpc.py")
        if peer_fabric:
            raise not_ported("ClusterRunner(peer_fabric=True)",
                             "dist/blobserve.py")
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
        self.cache_dir = cache_dir
        self.cache_bytes = cache_bytes
        # cache_per_node gives every local node its own cache dir
        # (cache_dir/<node_id>) — the multi-host shape (one cache per host)
        # simulated in one process, which is what makes locality-aware
        # placement testable and benchmarkable without a real cluster
        self.cache_per_node = cache_per_node
        self.locality = locality
        self.partition = partition
        # a CampaignPlan (repro_torch.core.campaign) seeds the queue's
        # per-node partitions from the admission-time shards: the cluster
        # starts on the warm placement the planner computed instead of
        # rediscovering it grant by grant (plan implies partition="plan")
        self.plan = plan
        # journal_dir turns on the coordinator write-ahead log: every queue
        # mutation is journaled there, and WorkQueue.recover(Journal(dir))
        # rebuilds the queue from it. run() refuses a directory that already
        # holds a journal unless journal_overwrite=True — the leftover is a
        # crashed run's only recoverable state
        self.journal_dir = Path(journal_dir) if journal_dir else None
        self.journal_overwrite = bool(journal_overwrite)
        self.stats: Optional[ClusterStats] = None
        self.queue: Optional[WorkQueue] = None
        self._journal = None

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
                # state. Recovery is a deliberate act (WorkQueue.recover),
                # never a side effect of starting a new run over the same
                # directory.
                raise RuntimeError(
                    f"{self.journal_dir} already holds a coordinator "
                    f"journal; recover it (WorkQueue.recover(Journal(...))) "
                    f"or pass journal_overwrite=True to discard it")
        queue = WorkQueue(units, node_ids, lease_ttl_s=self.lease_ttl_s,
                          locality=self.locality, partition=self.partition,
                          plan=self.plan, journal=journal)
        self.queue = queue
        self._journal = journal
        detector = StragglerDetector(self.straggler_factor,
                                     self.straggler_min_s)
        primaries: Dict[int, UnitResult] = {}
        extras: List[Tuple[int, UnitResult]] = []
        rec_lock = threading.Lock()

        def record(idx: int, res: UnitResult, lease: Lease):
            # pure coordinator-side bookkeeping: the committing complete()
            # already went through the node's own queue handle (see
            # Node._report), so this closure never touches the queue
            with rec_lock:
                if lease.speculative or idx in primaries:
                    extras.append((idx, res))
                else:
                    primaries[idx] = res
                if res.status == "ok":
                    detector.observe(res.seconds)

        caches = {nid: (self._make_cache(nid) if self.cache_per_node
                        else None) for nid in node_ids}
        shared_cache = None if self.cache_per_node else self._make_cache()
        nodes = [Node(nid, queue, self.pipeline, self.data_root, record,
                      prefetch=self.prefetch, max_retries=self.max_retries,
                      backoff_s=self.backoff_s, fault_hook=self.fault_hook,
                      hb_interval_s=self.hb_interval_s, poll_s=self.poll_s,
                      die_after=self.die_after.get(nid),
                      cache=caches[nid] or shared_cache)
                 for nid in node_ids]
        speculated: set = set()
        for nd in nodes:
            nd.start()
        last_tick = time.monotonic()
        reap_after = last_tick
        try:
            while not queue.finished():
                time.sleep(self.poll_s)
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
                    queue.reap()
                if not queue.alive_nodes() and not queue.finished():
                    raise RuntimeError(
                        f"all nodes dead with {queue.pending()} units pending")
                # cross-node straggler speculation: twin on a different node,
                # placed by the queue itself — on the node already holding
                # the most of the unit's input bytes (least-loaded when no
                # summary covers it), so the twin starts from warm local disk
                now = time.time()
                for idx, t0, holder in queue.running():
                    if idx in speculated or not detector.is_straggler(now - t0):
                        continue
                    if queue.speculate(idx) is not None:
                        speculated.add(idx)
        finally:
            for nd in nodes:
                nd.kill()
            for nd in nodes:
                nd.join(timeout=5.0)
            if self._journal is not None:
                self._journal.close()
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
            processed={nd.node_id: nd.processed for nd in nodes},
            steals=dict(queue.steals), requeued=list(queue.requeues),
            speculated=len(speculated),
            dead_nodes=[n for n in node_ids if n not in queue.alive_nodes()],
            renew_rejections=queue.renew_rejections,
            cache=cache_stats,
            locality=dict(qstats["locality"]),
            cache_by_node=(node_caches if self.cache_per_node else None))
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

    def restart_coordinator(self):
        """The reference's crash-recovery drill rebinds a recovered queue's
        socket server on the same port; without ``dist/rpc.py`` the port
        has no server to rebind, so this raises ``NotImplementedError``.
        A journal written by :meth:`run` still recovers in process:
        ``WorkQueue.recover(Journal(journal_dir))``."""
        raise not_ported("ClusterRunner.restart_coordinator", "dist/rpc.py")


def run_worker(addr, pipeline, data_root: Path, node_id: str, **kwargs):
    """The reference's remote worker (``python -m repro.dist.rpc work``)
    dials a coordinator's socket; the port has no ``dist/rpc.py`` yet, so
    this raises ``NotImplementedError``."""
    raise not_ported("run_worker", "dist/rpc.py")
