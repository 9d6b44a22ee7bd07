"""Shared work-unit queue with per-node leases, tail-stealing, and heartbeat
reaping — the control plane of the multi-node executor
(``repro_torch.dist.cluster``).

Protocol (see ``docs/cluster.md`` for the failure model):

* **Partition** — units are dealt round-robin into one deque per node, so an
  N-node cluster starts with balanced locality and zero coordination.
* **Lease** — ``next_unit(node)`` pops the node's own deque head and grants a
  :class:`Lease` carrying a per-unit **epoch** (bumped on every grant). The
  epoch is stamped into the committed provenance, so a record tells apart a
  first-run commit from a post-requeue re-run.
* **Steal** — an idle node steals the *tail half* of the longest peer deque
  (tails preserve the victim's head locality and any prefetch it has issued
  for imminent units). Stealing moves only unleased entries; in-flight work
  is never stolen, only speculated or reaped.
* **Heartbeat + reap** — nodes heartbeat on a timer decoupled from compute
  (a long unit must not look like a dead node). ``reap()`` declares nodes
  whose heartbeat is older than ``lease_ttl_s`` dead, requeues their leased
  units (epoch++) and redistributes their queued entries to the
  least-loaded alive nodes. A reaped "zombie" that later finishes anyway is
  harmless: the provenance commit arbitration admits exactly one ok record.
  ``reap()`` also expires *individual* leases that went a full TTL without
  a renewal on a node that itself still heartbeats: holders renew every
  in-hand lease each heartbeat, so an unrenewed lease on a live node means
  the grant reply never reached the node (a connection dropped mid-reply
  and the client replayed into a fresh grant, or a coordinator crash after
  journaling the grant) — without per-lease expiry such an orphan would
  stay leased forever and the campaign would never finish.
* **Speculate** — ``speculate(idx, node)`` grants a *twin* lease on a
  different node for a straggling unit; twins race the primary through the
  same idempotent commit, and duplicates surface as ``status="speculative"``.
* **Renew** — ``renew(idx, node, epoch)`` is a lease-scoped heartbeat for
  WAN-scale TTLs: it refreshes the holder's liveness *and* confirms the
  lease is still authoritative. A renewal naming a stale epoch (the unit was
  reaped and re-granted), a retired unit, or a dead node is rejected — the
  holder learns it lost the lease instead of heartbeating into the void.
* **Register** — ``register(node)`` joins a node after construction (the
  network-transport case: worker hosts dial in whenever they boot). A queue
  may start with zero nodes; units wait in a backlog that the first
  registrant drains and later registrants steal from.
* **Locality** — nodes push compact digest summaries of their host input
  cache (:class:`~repro_torch.dist.cache.DigestSummary`; full on
  ``register``/``put_summary``, deltas piggybacked on ``heartbeat``/
  ``renew``). Every placement decision — grant, backlog fill, steal,
  speculation target, dead-node redistribution — scores candidate units by
  **estimated cache-local bytes** (``Σ input_bytes[s]`` over input digests
  the node's summary holds) and prefers keeping bytes where they already
  live. Scores come from an incremental **warm-set index**
  (:class:`~repro_torch.dist.placement.WarmSetIndex`): digest→unit posting
  lists built once at admission and folded per-node as summaries and deltas
  arrive, so bulk decisions read precomputed ``unit → warm bytes`` dicts
  instead of re-probing Bloom filters under the lock — backlog fills and
  steals stay scored at 10⁵–10⁶-unit backlogs (the old
  ``LOCALITY_BULK_SCAN_CAP`` blind fallback is gone). Scoring is purely
  advisory: a stale or missing summary degrades to the locality-blind
  behaviour of PR 2/3, never to a wrong schedule. See the placement-policy
  section of ``docs/cluster.md``.
* **Batching** — ``next_units`` / ``complete_batch`` / ``renew_batch``
  wrap N grants/completions/renewals in one lock acquisition (and, over
  rpc, one round trip). Same semantics as N per-op calls; old
  coordinators simply don't export them and new clients shed to per-op.
* **DAG gating** — units carrying ``depends_on`` edges (multi-stage
  curation pipelines) are **parked**: they sit in no deque and no backlog
  until every in-queue parent has retired ``ok``/``skipped`` — i.e. holds
  a committed ok provenance record — at which point the child is released
  exactly once, to its planned home node (or the backlog). Because release
  happens only at retirement, the edge set is epoch-safe for free: a
  reaped parent hasn't retired, so its children stay parked until the
  re-run's commit; a zombie or twin duplicate can't release twice because
  a unit retires exactly once. A terminally ``failed`` parent cascades:
  every transitive descendant lands in a terminal ``blocked`` state —
  counted done, surfaced in ``stats_snapshot()``, never granted.
  Dependency cycles are rejected at construction (``ValueError``); parents
  not present in the queue count as satisfied (the work query already
  excludes complete work).

Everything is guarded by one lock — the queue is the single shared-state
object, and the whole method surface is JSON-serializable by design:
``repro_torch.dist.rpc`` wraps it in a socket server (each call becomes one
JSON-lines RPC to the coordinator) without touching nodes. ``complete``
optionally carries a result ``meta`` payload so a coordinator can fold in
results from worker processes it never shared memory with
(:meth:`WorkQueue.results_snapshot`).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from pathlib import PurePath
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from ..core.query import WorkUnit, units_from_rows
from .cache import SUMMARY_WIRE_VERSION, DigestSummary
# best_node / unit_local_bytes are re-exported here on purpose even though
# grants now read the WarmSetIndex: the shared-scorer contract (campaign
# admission and queue grants rank identically) is pinned by identity tests
# against this module's attributes, and the index rebuild reproduces exactly
# their semantics.
from .placement import WarmSetIndex, best_node, best_peers, unit_local_bytes

# grant-time scoring looks this deep into a node's own deque for a
# higher-affinity unit; bounded so a grant disturbs at most a head window of
# the deque ordering even on six-figure unit lists
LOCALITY_SCAN_WINDOW = 16

# locate_blobs answers at most this many digests per call and ranks at most
# this many peers per digest — both bound lock time against a hostile or
# confused client, and three candidates already cover dead-peer + false-
# positive retry without fanning a thundering herd at one warm host
LOCATE_DIGEST_CAP = 256
LOCATE_PEERS_PER_DIGEST = 3


@dataclasses.dataclass(frozen=True)
class Lease:
    """One node's exclusive (or, for twins, speculative) claim on a unit.

    ``local_bytes`` is the coordinator's estimate, at grant time, of how many
    of the unit's input bytes were already in the holder's cache — stamped
    into provenance as ``locality_score`` (normalized) so placement quality
    is auditable after the fact."""
    unit_idx: int
    node_id: str
    epoch: int
    granted_at: float
    speculative: bool = False
    local_bytes: int = 0


class WorkQueue:
    """In-process coordinator state: per-node deques + leases + heartbeats.

    Thread-safe; every public method takes the single internal lock. ``now``
    is injectable for deterministic tests.
    """

    def __init__(self, units: Sequence[WorkUnit],
                 node_ids: Sequence[str] = (), *,
                 lease_ttl_s: float = 2.0, now=time.time,
                 locality: bool = True, partition: str = "round_robin",
                 plan=None, journal=None):
        if plan is not None:
            partition = "plan"
        if partition not in ("round_robin", "backlog", "plan"):
            raise ValueError(f"unknown partition {partition!r}")
        if partition == "plan" and plan is None:
            raise ValueError('partition="plan" needs a plan')
        self.units = list(units)
        self.lease_ttl_s = float(lease_ttl_s)
        self.locality = bool(locality)
        self._now = now
        self._lock = threading.Lock()
        self._queues: Dict[str, Deque[int]] = {n: deque() for n in node_ids}
        # with no nodes yet (network transport: workers register later) the
        # units wait in a backlog; otherwise round-robin partition as before.
        # partition="backlog" keeps even a node-listed queue unpartitioned so
        # the (locality-scored) backlog fill decides initial placement once
        # nodes have pushed their cache summaries. A ``plan``
        # (:class:`repro_torch.core.campaign.CampaignPlan`, or its loaded-JSON
        # shape) seeds each node's deque from its admission-time shard, so
        # the queue starts already warm instead of rediscovering locality.
        #
        # The backlog deque is consumed lazily: warm (scored) fills delete
        # membership from ``_backlog_seq`` and leave a stale deque entry
        # behind for the FIFO pop to skip, so no fill ever rebuilds the
        # deque. ``_backlog_seq`` doubles as the admission-order key (front
        # appends count down, back appends count up), which is what scored
        # fills use to break warmth ties in FIFO order.
        self._backlog: Deque[int] = deque()
        self._backlog_seq: Dict[int, int] = {}
        self._backlog_front = 0
        self._backlog_back = 1
        # DAG state, built before dealing so _admit can park non-ready units.
        # _parents holds each child's *unsatisfied* parent idxs (entries
        # drain as parents retire ok); _children the forward edges; _parked
        # maps a waiting child to its planned home node (None = backlog), so
        # release lands it exactly where the partition/plan wanted it.
        # Edges naming job_ids outside this queue are satisfied by
        # definition: the work query excludes already-complete work, so an
        # absent parent means "done before this submission".
        self._by_job: Dict[str, int] = {}
        for i, u in enumerate(self.units):
            self._by_job.setdefault(u.job_id, i)
        self._parents: Dict[int, set] = {}
        self._children: Dict[int, List[int]] = {}
        for i, u in enumerate(self.units):
            deps = getattr(u, "depends_on", None) or ()
            ps = {self._by_job[str(d)] for d in deps
                  if str(d) in self._by_job}
            if ps:
                self._parents[i] = ps
                for p in sorted(ps):
                    self._children.setdefault(p, []).append(i)
        self._check_acyclic()
        self._parked: Dict[int, Optional[str]] = {}
        if plan is not None:
            self._seed_from_plan(plan)
        elif node_ids and partition == "round_robin":
            for i in range(len(self.units)):
                self._admit(i, node_ids[i % len(node_ids)])
        else:
            for i in range(len(self.units)):
                self._admit(i, None)
        self._epochs: Dict[int, int] = {i: 0 for i in range(len(self.units))}
        self._leases: Dict[int, Lease] = {}          # primary lease per unit
        self._spec: Dict[int, Lease] = {}            # at most one twin per unit
        self._spec_queues: Dict[str, Deque[int]] = {n: deque() for n in node_ids}
        self._started: Dict[int, float] = {}         # compute began (post-prefetch)
        self._done: Dict[int, str] = {}              # unit idx -> terminal status
        self._failed_pending: Dict[int, str] = {}    # primary failed, twin racing
        self._heartbeats: Dict[str, float] = {n: now() for n in node_ids}
        self._dead: set = set()
        self.steals: Dict[str, int] = {n: 0 for n in node_ids}
        self.requeues: List[int] = []                # reaped unit idxs (log)
        self.renew_rejections: int = 0               # stale-lease renew count
        # locality state: per-node cache digest summaries (pushed by nodes)
        # plus the cache stats that piggyback on the same wire, the
        # incremental warm-set index every placement decision reads, and the
        # placement counters operators read from stats_snapshot(). The
        # summaries stay authoritative for blob location (locate_blobs
        # probes arbitrary digests); the index only covers digests this
        # queue's units reference.
        self._summaries: Dict[str, DigestSummary] = {}
        self._warm = WarmSetIndex(self.units)
        self._cache_stats: Dict[str, Dict[str, int]] = {}
        # peer-fabric state: blob-server addresses nodes advertised on
        # register/heartbeat (absence = "don't route peers at me"), plus
        # routing counters for stats_snapshot()
        self._blob_addrs: Dict[str, str] = {}
        self.fabric_stats: Dict[str, int] = {
            "locates": 0,             # locate_blobs calls answered
            "located_digests": 0,     # digests answered with >=1 peer
            "unlocated_digests": 0,   # digests no live peer (probably) holds
        }
        self._steal_rr = 0                           # round-robin tie cursor
        self.locality_stats: Dict[str, int] = {
            "scored_grants": 0,       # grants where affinity picked the unit
            "blind_grants": 0,        # grants with no usable summary/score
            "local_bytes_granted": 0,  # Σ estimated cache-local bytes granted
            "input_bytes_granted": 0,  # Σ total input bytes granted
            "steals_scored": 0,       # steals shaped by affinity scoring
            "steals_blind": 0,        # plain tail-half steals
            "stolen_local_bytes": 0,  # Σ thief-local bytes of stolen units
            "summary_rejected": 0,    # summary wires we couldn't decode
        }
        # result metadata carried by complete(meta=...): the retiring
        # completion per unit, plus every duplicate report (twin losers,
        # zombies) — what a coordinator folds into its result list for units
        # finished by worker processes it never shared memory with
        self._primary_meta: Dict[int, dict] = {}
        self._primary_log: List[dict] = []           # same entries, in order
        self._pending_meta: Dict[int, dict] = {}     # deferred primary failure
        self._dup_meta: List[dict] = []
        # durability (docs/cluster.md): with a Journal attached, every
        # mutation that changes what a restarted coordinator must know —
        # grants, completions, renewals, node joins, deaths — appends one
        # record under the lock it already holds, and compaction snapshots
        # the mutable state whenever the WAL grows past the journal's
        # threshold. _replaying gates the append sites while recover()
        # re-drives the same code paths from the log.
        self._journal = None
        self._replaying = False
        if journal is not None:
            journal.write_units(self.units)
            with self._lock:
                self._journal = journal
                journal.compact(self._snapshot_state_locked())

    def _seed_from_plan(self, plan):
        """Deal units into per-node deques per an admission-time campaign
        plan. Duck-typed: ``plan.shards`` (or ``plan["shards"]``) of
        ``{node_id, unit_ids}`` records, so both a live
        :class:`~repro_torch.core.campaign.CampaignPlan` and its parsed
        ``campaign.json`` work. Fail-soft by construction: shard entries
        naming unknown units are ignored, shards targeting unknown/absent
        nodes fall to the backlog (the locality-scored fill re-places them),
        and units the plan never mentions are backlogged too — a stale or
        partial plan degrades to PR 3 behaviour, never to lost work."""
        if isinstance(plan, (str, PurePath)):
            # a campaign.json path is explicit intent, not a stale artifact:
            # load it (version-checked) rather than duck-typing it to an
            # attribute-less string and silently backlogging everything
            from ..core.campaign import CampaignPlan
            plan = CampaignPlan.load(plan)
        shards = plan.get("shards", []) if isinstance(plan, dict) \
            else getattr(plan, "shards", [])
        by_job = {u.job_id: i for i, u in enumerate(self.units)}
        seeded: set = set()
        for shard in shards:
            if isinstance(shard, dict):
                node_id, unit_ids = shard.get("node_id"), shard.get("unit_ids")
            else:
                node_id = getattr(shard, "node_id", None)
                unit_ids = getattr(shard, "unit_ids", None)
            home = node_id if node_id in self._queues else None
            for jid in unit_ids or []:
                i = by_job.get(jid)
                if i is None or i in seeded:
                    continue
                seeded.add(i)
                self._admit(i, home)
        for i in range(len(self.units)):
            if i not in seeded:
                self._admit(i, None)

    # -- DAG gating ----------------------------------------------------------
    # Callers hold the lock (or run from __init__ before the queue is
    # shared). Correctness hinges on two facts: a unit retires exactly once
    # (every terminal transition funnels through _retire), and a parked unit
    # is in no deque/backlog, so nothing — grants, steals, backlog fills,
    # speculation, dead-node redistribution — can hand it out early.

    def _check_acyclic(self):
        """Kahn's algorithm over the in-queue edges; raises ``ValueError``
        naming the cyclic units. Cycles (including self-dependencies) would
        otherwise deadlock the queue as permanently-parked work."""
        remaining = {i: set(ps) for i, ps in self._parents.items()}
        ready = [i for i in range(len(self.units)) if i not in remaining]
        while ready:
            nxt: List[int] = []
            for p in ready:
                for c in self._children.get(p, ()):
                    ps = remaining.get(c)
                    if ps is not None:
                        ps.discard(p)
                        if not ps:
                            del remaining[c]
                            nxt.append(c)
            ready = nxt
        if remaining:
            cyc = sorted(self.units[i].job_id for i in remaining)
            raise ValueError(
                "depends_on cycle among work units: " + ", ".join(cyc))

    def _admit(self, idx: int, node_id: Optional[str]):
        """Deal ``idx`` to its home: parked (remembering the planned home
        for release) while any parent is unsatisfied, else straight onto the
        node's deque — or the backlog when ``node_id`` is None."""
        if self._parents.get(idx):
            self._parked[idx] = node_id
        elif node_id is None:
            self._backlog_append(idx)
        else:
            self._queues[node_id].append(idx)

    def _retire(self, idx: int, status: str):
        """The single point where a unit becomes terminal. On ``ok``/
        ``skipped`` — the unit's provenance commit is durable — satisfy its
        out-edges and release each child that just became ready, exactly
        once: to its planned home if that node is still alive, else the
        backlog. On ``failed`` (retries exhausted), cascade: every
        transitive descendant is necessarily still parked (a child releases
        only when *all* parents committed ok), so each lands terminally
        ``blocked`` without ever having been granted."""
        self._done[idx] = status
        if status in ("ok", "skipped"):
            for c in self._children.get(idx, ()):
                ps = self._parents.get(c)
                if ps is None:
                    continue
                ps.discard(idx)
                if ps or c in self._done:
                    continue
                home = self._parked.pop(c, None)
                if home is not None and home in self._queues \
                        and home not in self._dead:
                    self._queues[home].append(c)
                else:
                    self._backlog_append(c)
        elif status == "failed":
            stack = list(self._children.get(idx, ()))
            while stack:
                c = stack.pop()
                if c in self._done:
                    continue
                self._done[c] = "blocked"
                self._parked.pop(c, None)
                stack.extend(self._children.get(c, ()))

    def _retire_meta(self, idx: int, entry: dict):
        """Record the completion that retired ``idx``: keyed for the final
        fold, appended to the ordered log for incremental polling. Each unit
        retires exactly once, so the log never rewrites an entry."""
        self._primary_meta[idx] = entry
        self._primary_log.append(entry)

    # -- backlog bookkeeping -------------------------------------------------
    # Callers hold the lock. Membership and ordering live in _backlog_seq;
    # the deque exists only to give the FIFO pop its order without scans.

    def _backlog_append(self, idx: int):
        self._backlog.append(idx)
        self._backlog_seq[idx] = self._backlog_back
        self._backlog_back += 1

    def _backlog_appendleft(self, idx: int):
        self._backlog.appendleft(idx)
        self._backlog_front -= 1
        self._backlog_seq[idx] = self._backlog_front

    def _backlog_pop_fifo(self) -> Optional[int]:
        """Oldest live backlog entry, skipping entries a warm fill already
        took (stale deque copies) and units retired while parked."""
        while self._backlog:
            idx = self._backlog.popleft()
            if self._backlog_seq.pop(idx, None) is None:
                continue
            if idx not in self._done:
                return idx
        return None

    # -- durability (write-ahead journal) ------------------------------------
    # Callers hold the lock. The journal sees exactly the mutations a
    # restart must reconstruct; placement state (deques, backlog order,
    # summaries, the warm-set index) is deliberately NOT journaled —
    # recovery rebuilds it from scratch and reconnecting workers re-push
    # their summaries, so the log stays small and placement stays advisory.

    def _journal_append(self, rec: dict):
        j = self._journal
        if j is None or self._replaying:
            return
        j.append(rec)

    def _journal_maybe_compact(self):
        """Compaction runs only at public-method boundaries, never inside
        :meth:`_journal_append`: an append can precede its mutation (a
        death record lands before the leases are torn down), and a snapshot
        taken mid-mutation would claim the record's seq without containing
        its effect — replay would then skip the record and lose the event."""
        j = self._journal
        if j is not None and not self._replaying and j.should_compact():
            j.compact(self._snapshot_state_locked())

    def _snapshot_state_locked(self) -> dict:
        """The mutable-state snapshot compaction writes: everything a
        recovery needs that isn't the (immutable) unit list. JSON object
        keys must be strings, so int-keyed maps are stringified here and
        re-intified in :meth:`recover`."""
        leases = [[l.unit_idx, l.node_id, l.epoch,
                   1 if l.speculative else 0, l.local_bytes]
                  for l in list(self._leases.values())
                  + list(self._spec.values())]
        return {
            "nodes": list(self._queues),
            "dead": sorted(self._dead),
            "blob_addrs": dict(self._blob_addrs),
            "epochs": {str(i): e for i, e in self._epochs.items() if e},
            "done": {str(i): s for i, s in self._done.items()},
            "leases": leases,
            "failed_pending": {str(i): s
                               for i, s in self._failed_pending.items()},
            "pending_meta": {str(i): dict(m)
                             for i, m in self._pending_meta.items()},
            "primary_log": [dict(m) for m in self._primary_log],
            "dup_meta": [dict(m) for m in self._dup_meta],
            "requeues": list(self.requeues),
            "steals": dict(self.steals),
            "renew_rejections": self.renew_rejections,
        }

    def _apply_record(self, rec: dict):
        """Re-drive one WAL record during recovery (``_replaying`` is set,
        nothing is re-journaled). Completion and death records go through
        the real code paths so retirement/DAG-release/dup arbitration
        replay exactly as they ran; grants apply minimally (epoch + lease)
        because the normalization pass at the end of :meth:`recover`
        rebuilds all placement state anyway. Unknown record types are
        skipped — an old coordinator replaying a newer journal degrades to
        ignoring what it can't parse rather than crashing."""
        t = rec.get("t")
        try:
            if t == "register":
                n = str(rec["n"])
                if n in self._dead:
                    return
                if n not in self._queues:
                    self._queues[n] = deque()
                    self._spec_queues[n] = deque()
                    self.steals.setdefault(n, 0)
                    self._heartbeats[n] = self._now()
                b = rec.get("b")
                if b:
                    self._blob_addrs[n] = str(b)
            elif t == "grant":
                i, n, e = int(rec["i"]), str(rec["n"]), int(rec["e"])
                if i in self._done or e <= self._epochs.get(i, 0) \
                        or n not in self._queues or n in self._dead:
                    return
                self._epochs[i] = e
                spec = bool(rec.get("s"))
                lease = Lease(i, n, e, self._now(), speculative=spec,
                              local_bytes=int(rec.get("lb", 0)))
                (self._spec if spec else self._leases)[i] = lease
            elif t == "complete":
                m = rec.get("m")
                self._complete_locked(
                    int(rec["i"]), str(rec["n"]), str(rec["st"]),
                    speculative=bool(rec.get("s")),
                    meta=m if isinstance(m, dict) else None)
            elif t == "dead":
                self._declare_dead(str(rec["n"]))
            elif t == "expire":
                # re-drives the same drop/settle path; the requeue side is
                # irrelevant mid-replay (normalization rebuilds placement)
                self._expire_lease(int(rec["i"]), bool(rec.get("s")))
            elif t == "renew":
                pass    # pure liveness: recovery re-stamps every clock
        except (KeyError, TypeError, ValueError):
            pass        # a malformed-but-CRC-valid record loses one event,
            #             never the recovery

    @classmethod
    def recover(cls, journal, *, lease_ttl_s: float = 2.0, now=time.time,
                locality: bool = True) -> "WorkQueue":
        """Rebuild a queue from a dead coordinator's journal: replay
        snapshot + WAL tail (torn tail truncated), then normalize.

        What comes back durable: unit list, terminal statuses + result
        metadata, DAG gates (drained to match the done set), per-unit
        epochs, node membership incl. deaths, and in-flight leases — which
        resolve through the ordinary epoch/reap machinery: every lease
        restarts its TTL clock *now*, so a holder that reconnects and
        renews keeps its lease, and one that died with the old coordinator
        is reaped exactly like any other silent node. What is deliberately
        rebuilt fresh rather than restored: all placement state — every
        grantable unit returns to the backlog in admission order, spec
        twins re-enter their node's speculative queue, and the warm-set
        index is re-derived (summaries re-arrive as workers reconnect and
        re-push). Duplicate post-restart completions are harmless by the
        same arbitration that already absorbs zombies and twins."""
        rows, state, tail, _torn = journal.replay()
        q = cls(units_from_rows(rows), (), lease_ttl_s=lease_ttl_s,
                now=now, locality=locality)
        with q._lock:
            q._replaying = True
            st = state or {}
            for n in st.get("nodes", []):
                n = str(n)
                if n not in q._queues:
                    q._queues[n] = deque()
                    q._spec_queues[n] = deque()
                    q.steals.setdefault(n, 0)
                    q._heartbeats[n] = q._now()
            for n in st.get("dead", []):
                q._dead.add(str(n))
            for n, a in (st.get("blob_addrs") or {}).items():
                if str(n) not in q._dead:
                    q._blob_addrs[str(n)] = str(a)
            for i, e in (st.get("epochs") or {}).items():
                q._epochs[int(i)] = int(e)
            # terminal statuses, then drain the DAG gates to match: an
            # ok/skipped parent's edge is satisfied, any done unit leaves
            # the parked set (release/cascade already happened pre-crash)
            for i, s in (st.get("done") or {}).items():
                q._done[int(i)] = str(s)
            for i, s in q._done.items():
                q._parked.pop(i, None)
                if s in ("ok", "skipped"):
                    for c in q._children.get(i, ()):
                        ps = q._parents.get(c)
                        if ps is not None:
                            ps.discard(i)
            for c in [c for c, ps in q._parents.items()
                      if not ps and c not in q._done]:
                q._parked.pop(c, None)
            for le in st.get("leases", []):
                try:
                    i, n, e = int(le[0]), str(le[1]), int(le[2])
                    spec, lb = bool(le[3]), int(le[4])
                except (TypeError, ValueError, IndexError):
                    continue
                if i in q._done or n in q._dead or n not in q._queues:
                    continue
                lease = Lease(i, n, e, q._now(), speculative=spec,
                              local_bytes=lb)
                (q._spec if spec else q._leases)[i] = lease
            for i, s in (st.get("failed_pending") or {}).items():
                q._failed_pending[int(i)] = str(s)
            for i, m in (st.get("pending_meta") or {}).items():
                if isinstance(m, dict):
                    q._pending_meta[int(i)] = dict(m)
            for m in st.get("primary_log", []):
                if isinstance(m, dict) and "idx" in m:
                    q._retire_meta(int(m["idx"]), dict(m))
            q._dup_meta.extend(dict(m) for m in st.get("dup_meta", [])
                               if isinstance(m, dict))
            q.requeues.extend(int(i) for i in st.get("requeues", []))
            for n, c in (st.get("steals") or {}).items():
                q.steals[str(n)] = int(c)
            q.renew_rejections = int(st.get("renew_rejections", 0))
            for rec in tail:
                q._apply_record(rec)
            # normalization: placement state is rebuilt from scratch.
            # Mid-replay deque/backlog churn (requeues, DAG releases) left
            # stale entries; clearing and re-dealing makes "grantable ⇔
            # exactly one of backlog/lease" an invariant rather than an
            # accident of replay order.
            for n in q._queues:
                q._queues[n].clear()
                q._spec_queues[n].clear()
            q._backlog.clear()
            q._backlog_seq.clear()
            q._backlog_front, q._backlog_back = 0, 1
            for i in range(len(q.units)):
                if i in q._done or i in q._parked or i in q._leases:
                    continue
                q._backlog_append(i)
            t0 = q._now()
            for i, l in list(q._spec.items()):
                if i in q._done or l.node_id in q._dead:
                    q._spec.pop(i)
                    continue
                q._spec_queues[l.node_id].append(i)
                q._spec[i] = dataclasses.replace(l, granted_at=t0)
            for i, l in list(q._leases.items()):
                q._leases[i] = dataclasses.replace(l, granted_at=t0)
            q._started.clear()
            # one full TTL of grace for every surviving node to reconnect
            # to the new incarnation before the reaper may declare it dead
            for n in q._queues:
                if n not in q._dead:
                    q._heartbeats[n] = t0
            q._warm = WarmSetIndex(q.units, skip=q._done)
            q._replaying = False
            q._journal = journal
            journal.compact(q._snapshot_state_locked())
        return q

    # -- locality scoring ----------------------------------------------------
    # All helpers assume the caller holds the lock. Scores are *estimates*
    # (Bloom false positives, stale summaries) and only ever shape ordering —
    # correctness (exactly-one-ok, lease epochs, reaping) is score-blind.

    def _local_bytes(self, idx: int, node_id: str) -> int:
        """Estimated bytes of unit ``idx``'s inputs already in ``node_id``'s
        host cache — an O(1) warm-set index lookup. 0 without a summary
        (old client, no cache, version skew) — the locality-blind fallback.
        The index's full-push rebuild probes the same shared
        admission/grant scorer semantics
        (:func:`repro_torch.dist.placement.unit_local_bytes`), so campaign plans
        and live grants can never rank the same unit differently."""
        if not self.locality:
            return 0
        return self._warm.score(node_id, idx)

    def _node_scores(self, node_id: str) -> bool:
        """Whether scoring can distinguish anything for this node."""
        s = self._summaries.get(node_id)
        return self.locality and s is not None and len(s) > 0

    def _best_node(self, idx: int, candidates: List[str]) -> str:
        """The candidate holding the most of ``idx``'s input bytes; ties go
        to the shallowest deque, then lexicographic for determinism — the
        index-backed twin of :func:`repro_torch.dist.placement.best_node`."""
        if not self.locality:
            return min(candidates,
                       key=lambda n: (len(self._queues[n]), n))
        return self._warm.best_node(
            idx, candidates, {n: len(q) for n, q in self._queues.items()})

    def _apply_summary_wire(self, node_id: str, wire) -> bool:
        """Fold a summary push (full or delta) into the per-node state.
        Anything malformed or version-skewed is counted and dropped — the
        node stays schedulable, just locality-blind. Returns True iff the
        wire was understood and applied."""
        if node_id in self._dead or node_id not in self._queues:
            return False
        if not isinstance(wire, dict) or wire.get("v") != 1:
            self.locality_stats["summary_rejected"] += 1
            return False
        stats = wire.get("stats")
        if isinstance(stats, dict):
            self._cache_stats[node_id] = dict(stats)
        if "full" in wire:
            summary = DigestSummary.from_wire(wire["full"])
            if summary is None:
                self.locality_stats["summary_rejected"] += 1
                return False
            self._summaries[node_id] = summary
            if self.locality:
                # an exact digest list on the wire (new caches send one)
                # makes the rebuild exact; otherwise probe the Bloom filter
                # for every referenced digest, matching unit_local_bytes
                digests = wire.get("digests")
                self._warm.rebuild(
                    node_id, summary,
                    digests=digests if isinstance(digests, list) else None)
            return True
        summary = self._summaries.setdefault(node_id, DigestSummary())
        try:
            for d in wire.get("add") or []:
                summary.add(str(d))
                if self.locality:
                    self._warm.add(node_id, str(d))
            for d in wire.get("drop") or []:
                summary.discard(str(d))
                if self.locality:
                    self._warm.discard(node_id, str(d))
        except (TypeError, ValueError):
            self.locality_stats["summary_rejected"] += 1
            return False
        return True

    # -- leasing ------------------------------------------------------------

    def _grant(self, idx: int, node_id: str, speculative: bool,
               local_bytes: int = 0) -> Lease:
        self._epochs[idx] += 1
        lease = Lease(idx, node_id, self._epochs[idx], self._now(),
                      speculative=speculative, local_bytes=local_bytes)
        (self._spec if speculative else self._leases)[idx] = lease
        rec = {"t": "grant", "i": idx, "n": node_id, "e": lease.epoch,
               "lb": local_bytes}
        if speculative:
            rec["s"] = 1
        self._journal_append(rec)
        return lease

    def _pop_scored(self, node_id: str) -> Optional[Tuple[int, int]]:
        """Pop the next unit off ``node_id``'s deque: the highest-affinity
        unit within the head scan window when the node has a usable summary,
        the plain head otherwise (exact PR 2 behaviour). Returns
        ``(unit_idx, estimated_local_bytes)`` or ``None`` on an empty deque.
        Retired entries encountered anywhere in the window are dropped, so
        the pop — and therefore :meth:`next_unit` — never hands out a done
        unit."""
        q = self._queues[node_id]
        while True:
            while q and q[0] in self._done:
                q.popleft()
            if not q:
                return None
            if not self._node_scores(node_id):
                self.locality_stats["blind_grants"] += 1
                return q.popleft(), 0
            best_pos, best_score = None, -1
            dead: List[int] = []
            for pos in range(min(len(q), LOCALITY_SCAN_WINDOW)):
                idx = q[pos]
                if idx in self._done:
                    dead.append(pos)
                    continue
                score = self._local_bytes(idx, node_id)
                if score > best_score:     # ties keep the earliest (FIFO)
                    best_pos, best_score = pos, score
            for pos in reversed(dead):     # drop retired entries for good
                del q[pos]
            if best_pos is None:
                continue                   # window was all retired: rescan
            best_pos -= sum(1 for p in dead if p < best_pos)
            idx = q[best_pos]
            del q[best_pos]
            key = "scored_grants" if best_score > 0 else "blind_grants"
            self.locality_stats[key] += 1
            self.locality_stats["local_bytes_granted"] += max(0, best_score)
            self.locality_stats["input_bytes_granted"] += \
                self.units[idx].total_input_bytes
            return idx, max(0, best_score)

    def _next_unit_locked(self, node_id: str
                          ) -> Optional[Tuple[WorkUnit, Lease]]:
        if node_id in self._dead or node_id not in self._queues:
            return None
        sq = self._spec_queues[node_id]
        while sq:
            idx = sq.popleft()
            if idx in self._done:
                self._spec.pop(idx, None)
                continue
            lease = self._spec.get(idx)
            if lease is None:
                continue                   # twin evaporated while queued
            # delivery starts the twin's expiry clock: while the entry sat
            # in this queue the lease couldn't be lost in flight, so only
            # from here on does "unrenewed for a TTL" mean a lost grant
            lease = dataclasses.replace(lease, granted_at=self._now())
            self._spec[idx] = lease
            return self.units[idx], lease
        q = self._queues[node_id]
        if not q:
            self._fill_from_backlog(node_id)
        if not q:
            self._steal_into(node_id)
        got = self._pop_scored(node_id)   # never returns a retired unit
        if got is None:
            return None
        idx, score = got
        return self.units[idx], self._grant(idx, node_id, False,
                                            local_bytes=score)

    def next_unit(self, node_id: str) -> Optional[Tuple[WorkUnit, Lease]]:
        """Lease the next unit for ``node_id``: own speculative work first,
        then the best-affinity unit near the node's own deque head, then a
        (locality-scored) share of the registration backlog, then steal the
        lowest-affinity half of the fullest peer deque. Returns ``None``
        when no leasable work exists *right now* (the node should re-poll
        until :meth:`finished`) — including for unknown node ids, so a
        transport client that skipped :meth:`register` fails soft."""
        with self._lock:
            got = self._next_unit_locked(node_id)
            self._journal_maybe_compact()
            return got

    def next_units(self, node_id: str, max_units: int = 1
                   ) -> List[Tuple[WorkUnit, Lease]]:
        """Batched :meth:`next_unit`: up to ``max_units`` grants under one
        lock acquisition (over rpc: one round trip). Stops early when no
        leasable work exists right now; a short batch means exactly what a
        ``None`` from :meth:`next_unit` means."""
        out: List[Tuple[WorkUnit, Lease]] = []
        with self._lock:
            for _ in range(max(1, int(max_units))):
                got = self._next_unit_locked(node_id)
                if got is None:
                    break
                out.append(got)
            self._journal_maybe_compact()
        return out

    def _fill_from_backlog(self, node_id: str):
        """Move a fair share of never-partitioned units (queue built with no
        nodes or ``partition="backlog"``, or orphans reaped while no node was
        alive) onto ``node_id``'s deque — late registrants then rebalance via
        ordinary stealing. With a usable summary the share is the node's
        **top-k by cache-local bytes** (warmest first, so prefetch starts on
        the warmest work); otherwise FIFO, exactly the PR 3 behaviour.

        Cost is O(warm-set · log + k), independent of backlog depth: the
        warm candidates come straight off the node's warm-set index entry,
        so a million-unit backlog no longer forces the blind-FIFO fallback
        the old ``LOCALITY_BULK_SCAN_CAP`` imposed."""
        if not self._backlog_seq:
            return
        alive = max(1, sum(1 for n in self._queues if n not in self._dead))
        k = max(1, len(self._backlog_seq) // alive)
        q = self._queues[node_id]
        chosen: List[int] = []
        if self._node_scores(node_id):
            # intersect warm set and backlog by iterating whichever is
            # smaller — a deep backlog against a small cache scans the warm
            # set, a drained backlog against a big cache scans the backlog
            scores = self._warm.scores(node_id)
            if len(scores) <= len(self._backlog_seq):
                warm = [(idx, s) for idx, s in scores.items()
                        if idx in self._backlog_seq and idx not in self._done]
            else:
                warm = [(idx, s) for idx in self._backlog_seq
                        if (s := scores.get(idx, 0)) > 0
                        and idx not in self._done]
            # warmest first; ties in backlog (admission) order — the exact
            # ordering the old full sort produced
            warm.sort(key=lambda t: (-t[1], self._backlog_seq[t[0]]))
            for idx, _ in warm[:k]:
                del self._backlog_seq[idx]
                chosen.append(idx)
        while len(chosen) < k:
            idx = self._backlog_pop_fifo()
            if idx is None:
                break
            chosen.append(idx)
        q.extend(chosen)                    # warmest-first order

    def _steal_into(self, thief: str):
        """Steal half of the fullest peer deque. Victim ties break by a
        round-robin cursor over the tied node ids (deterministic for a fixed
        steal sequence, fair across victims — ``max`` on ``(len, node_id)``
        used to bias every tie toward the lexicographically-last node).
        With usable summaries the thief takes the entries that are
        **coldest for the victim** (preferring, among those, warmest for the
        thief); blind, it takes the tail half, preserving the victim's head
        locality and prefetch exactly as before.

        The scored selection reads both warm-set index entries — one cheap
        pass over the victim deque plus a sort of only the warm entries —
        so it stays scored at any depth (the old cap fell back to blind
        tail-half past 512 entries)."""
        lens = {n: len(q) for n, q in self._queues.items()
                if n != thief and n not in self._dead and len(q)}
        if not lens:
            return
        deepest = max(lens.values())
        tied = sorted(n for n, l in lens.items() if l == deepest)
        victim = tied[self._steal_rr % len(tied)]
        self._steal_rr += 1
        vq = self._queues[victim]
        k = max(1, len(vq) // 2)
        if self._node_scores(thief) or self._node_scores(victim):
            wv = self._warm.scores(victim) if self.locality else {}
            wt = self._warm.scores(thief) if self.locality else {}
            # selection order (matches the old full sort on
            # (victim_bytes, -thief_bytes, -pos)): victim-cold entries first
            # — thief-warm ones ahead of plain cold, tail-first within each —
            # then victim-warm entries coldest-first. Only warm entries get
            # sorted; the cold majority is consumed tail-first as-is.
            cold_thief_warm: List[Tuple[int, int, int]] = []
            cold_positions: List[int] = []
            victim_warm: List[Tuple[int, int, int, int]] = []
            for p, idx in enumerate(vq):
                v = wv.get(idx, 0)
                if v > 0:
                    victim_warm.append((v, -wt.get(idx, 0), -p, p))
                elif (t := wt.get(idx, 0)) > 0:
                    cold_thief_warm.append((-t, -p, p))
                else:
                    cold_positions.append(p)
            cold_thief_warm.sort()
            victim_warm.sort()
            sel = [e[-1] for e in cold_thief_warm]
            sel.extend(reversed(cold_positions))
            sel.extend(e[-1] for e in victim_warm)
            take = set(sel[:k])
            grabbed = [idx for p, idx in enumerate(vq) if p in take]
            self._queues[victim] = deque(idx for p, idx in enumerate(vq)
                                         if p not in take)
            self.locality_stats["steals_scored"] += 1
            self.locality_stats["stolen_local_bytes"] += \
                sum(wt.get(i, 0) for i in grabbed)
        else:
            grabbed = [vq.pop() for _ in range(k)]
            # reverse: popping the tail reversed the order; keep victim's order
            grabbed = list(reversed(grabbed))
            self.locality_stats["steals_blind"] += 1
        self._queues[thief].extend(grabbed)
        self.steals[thief] += 1

    def mark_started(self, idx: int):
        """Compute (not prefetch) began — the straggler clock starts here."""
        with self._lock:
            self._started.setdefault(idx, self._now())

    def complete(self, idx: int, node_id: str, status: str, *,
                 speculative: bool = False, meta: Optional[dict] = None):
        """Record a terminal result for a lease.

        Primary leases retire the unit on ``ok``/``skipped``; a terminal
        ``failed`` (retries exhausted — same semantics as ``LocalRunner``)
        retires it only when no speculative twin is still racing — otherwise
        retirement is deferred so the twin's ok can still save the unit. A
        twin retires the unit on ``ok``/``skipped``, and on ``failed`` only
        settles a deferred primary failure (both racers lost). Results from
        nodes already declared dead are ignored for retirement — their unit
        was requeued, and the provenance commit arbitration already made any
        late zombie write harmless — and late completions of already-done
        units are no-ops.

        ``meta`` (JSON-safe: e.g. ``{"seconds": ..., "attempts": ...,
        "error": ...}``) attaches the worker-side result to the completion so
        a coordinator that never shared memory with the worker can rebuild
        its result list: the retiring completion's meta lands in
        :meth:`results_snapshot` ``primaries``, every non-retiring report
        (twin losers, zombies, late duplicates) in ``duplicates``."""
        with self._lock:
            self._complete_locked(idx, node_id, status,
                                  speculative=speculative, meta=meta)
            self._journal_maybe_compact()

    def complete_batch(self, completions: Sequence[dict]):
        """Batched :meth:`complete`: N terminal reports under one lock
        acquisition (over rpc: one round trip). Each entry is a JSON-safe
        dict ``{"idx", "node_id", "status"}`` plus optional ``speculative``
        and ``meta`` — the same arguments, same semantics, same order as N
        per-op calls. Malformed entries are dropped (fail-soft: the worker
        retries nothing, exactly as a lost per-op duplicate report)."""
        with self._lock:
            for c in completions:
                if not isinstance(c, dict):
                    continue
                try:
                    idx = int(c["idx"])
                    node_id = str(c["node_id"])
                    status = str(c["status"])
                except (KeyError, TypeError, ValueError):
                    continue
                meta = c.get("meta")
                self._complete_locked(
                    idx, node_id, status,
                    speculative=bool(c.get("speculative", False)),
                    meta=meta if isinstance(meta, dict) else None)
            self._journal_maybe_compact()

    def _complete_locked(self, idx: int, node_id: str, status: str, *,
                         speculative: bool = False,
                         meta: Optional[dict] = None):
        # every report is journaled — retiring or not — so replay re-runs
        # the exact same arbitration (twin races, zombie dups, deferred
        # failures) the live queue ran, instead of a cleaned-up history
        rec = {"t": "complete", "i": idx, "n": node_id, "st": status}
        if speculative:
            rec["s"] = 1
        if meta is not None:
            rec["m"] = meta
        self._journal_append(rec)
        entry = None
        if meta is not None:
            entry = {"idx": idx, "node_id": node_id, "status": status,
                     "speculative": speculative, **meta}
        if node_id in self._dead:
            if entry is not None:
                self._dup_meta.append(entry)
            return
        if speculative:
            spec = self._spec.get(idx)
            if spec is not None and spec.node_id == node_id:
                self._spec.pop(idx)
            if idx in self._done:
                if entry is not None:
                    self._dup_meta.append(entry)
                return
            if status in ("ok", "skipped"):
                self._retire(idx, status)
                self._started.pop(idx, None)
                self._failed_pending.pop(idx, None)
                # the twin won: its result is the unit's result, and the
                # deferred primary failure (if any) is superseded
                self._pending_meta.pop(idx, None)
                if entry is not None:
                    self._retire_meta(idx, entry)
            elif idx in self._failed_pending:
                self._retire(idx, self._failed_pending.pop(idx))
                pend = self._pending_meta.pop(idx, None)
                if pend is not None:
                    self._retire_meta(idx, pend)
                if entry is not None:
                    self._dup_meta.append(entry)
            elif entry is not None:
                self._dup_meta.append(entry)
            return
        lease = self._leases.get(idx)
        if lease is not None and lease.node_id == node_id:
            self._leases.pop(idx)
            self._started.pop(idx, None)
        if idx in self._done:
            if entry is not None:
                self._dup_meta.append(entry)
            return
        if status == "failed" and idx in self._spec:
            self._failed_pending[idx] = status   # twin still racing
            if entry is not None:
                self._pending_meta[idx] = entry
            return
        self._retire(idx, status)
        self._failed_pending.pop(idx, None)
        self._pending_meta.pop(idx, None)
        if entry is not None:
            self._retire_meta(idx, entry)

    def renew(self, idx: int, node_id: str, epoch: int,
              summary_delta=None) -> bool:
        """Lease-scoped heartbeat for WAN-scale TTLs: refresh ``node_id``'s
        liveness *and* confirm its lease on ``idx`` (primary or twin) is still
        authoritative at ``epoch``. Returns False — without touching any
        state — when the lease is gone: the node is dead, the unit retired,
        or the unit was reaped and re-granted (epoch bumped), in which case
        the caller is now a zombie and should not expect its commit to win.
        A successful renewal refreshes the lease's ``granted_at``.

        ``summary_delta`` optionally piggybacks a cache digest-summary delta
        (same wire as :meth:`heartbeat`) so WAN workers renewing long leases
        keep their placement summaries fresh without extra round trips. It is
        applied even when the renewal itself is rejected — a zombie's cache
        contents are still real.

        ``renew_rejections`` counts only the *interesting* rejections (dead
        node, wrong holder, stale epoch) — a renew that loses an ordinary
        race with its own unit's completion is not a lost lease and stays
        out of the WAN-health signal."""
        with self._lock:
            if summary_delta is not None:
                self._apply_summary_wire(node_id, summary_delta)
            ok = self._renew_locked(idx, node_id, epoch)
            self._journal_maybe_compact()
            return ok

    def renew_batch(self, node_id: str, leases: Sequence[Sequence[int]],
                    summary_delta=None) -> List[bool]:
        """Batched :meth:`renew` for every lease a node holds: one lock
        acquisition (over rpc: one round trip) renews ``leases`` — a list of
        ``[unit_idx, epoch]`` pairs — and applies the piggybacked
        ``summary_delta`` once. Returns one verdict per pair, in order;
        malformed pairs are simply rejected (False), same fail-soft posture
        as every other wire surface."""
        with self._lock:
            if summary_delta is not None:
                self._apply_summary_wire(node_id, summary_delta)
            out: List[bool] = []
            for pair in leases:
                try:
                    idx, epoch = int(pair[0]), int(pair[1])
                except (TypeError, ValueError, IndexError):
                    out.append(False)
                    continue
                out.append(self._renew_locked(idx, node_id, epoch))
            self._journal_maybe_compact()
            return out

    def _renew_locked(self, idx: int, node_id: str, epoch: int) -> bool:
        if idx in self._done:
            return False                 # completed: routine, not counted
        if node_id in self._dead:
            self.renew_rejections += 1
            return False
        lease = self._leases.get(idx)
        if lease is None or lease.node_id != node_id or lease.epoch != epoch:
            lease = self._spec.get(idx)
        if lease is None or lease.node_id != node_id or lease.epoch != epoch:
            self.renew_rejections += 1
            return False
        self._heartbeats[node_id] = self._now()
        renewed = dataclasses.replace(lease, granted_at=self._now())
        (self._spec if lease.speculative else self._leases)[idx] = renewed
        self._journal_append({"t": "renew", "n": node_id, "i": idx,
                              "e": epoch})
        return True

    # -- speculation --------------------------------------------------------

    def speculate(self, idx: int, node_id: Optional[str] = None
                  ) -> Optional[Lease]:
        """Queue a speculative twin of ``idx`` on ``node_id`` (must differ
        from the primary lease holder; at most one twin per unit). With
        ``node_id=None`` the queue places the twin itself, on the alive node
        holding the most of the unit's input bytes (ties: shallowest deque) —
        a straggler's twin starts fastest where its inputs are already warm."""
        with self._lock:
            lease = self._leases.get(idx)
            if idx in self._done or idx in self._spec or lease is None:
                return None
            if node_id is None:
                candidates = [n for n in self._queues
                              if n not in self._dead and n != lease.node_id]
                if not candidates:
                    return None
                node_id = self._best_node(idx, candidates)
            if lease.node_id == node_id or node_id in self._dead \
                    or node_id not in self._queues:
                return None
            twin = self._grant(idx, node_id, True,
                               local_bytes=self._local_bytes(idx, node_id))
            self._spec_queues[node_id].append(idx)
            self._journal_maybe_compact()
            return twin

    def running(self) -> List[Tuple[int, float, str]]:
        """Units in compute: (idx, started_at, node) for straggler checks."""
        with self._lock:
            return [(i, t0, self._leases[i].node_id)
                    for i, t0 in self._started.items()
                    if i not in self._done and i in self._leases]

    # -- heartbeats + failure handling --------------------------------------

    def register(self, node_id: str, summary=None, blob_addr=None) -> bool:
        """Join ``node_id`` to the cluster after construction — the network-
        transport path where worker hosts dial in whenever they boot. A new
        node starts with an empty deque and picks up work from the backlog or
        by stealing. Re-registering an alive node just refreshes its
        heartbeat; a reaped node id stays dead (rejoin under a fresh id).

        ``summary`` optionally carries the host cache's full digest summary
        (``InputCache.summary_sync()`` wire), so a worker with a warm cache
        from a previous run is placed locality-aware from its very first
        grant. ``blob_addr`` optionally advertises the host's blob server
        (``host:port``) for the peer fabric; a worker that runs no blob
        server omits it and :meth:`locate_blobs` never routes peers at it.
        Old clients simply omit both — locality-blind and fabric-invisible,
        never rejected."""
        with self._lock:
            if node_id in self._dead:
                return False
            fresh = node_id not in self._queues
            if fresh:
                self._queues[node_id] = deque()
                self._spec_queues[node_id] = deque()
                self.steals.setdefault(node_id, 0)
            self._heartbeats[node_id] = self._now()
            if summary is not None:
                self._apply_summary_wire(node_id, summary)
            if blob_addr:
                addr_changed = self._blob_addrs.get(node_id) != str(blob_addr)
                self._blob_addrs[node_id] = str(blob_addr)
            else:
                addr_changed = False
            if fresh or addr_changed:
                rec = {"t": "register", "n": node_id}
                if node_id in self._blob_addrs:
                    rec["b"] = self._blob_addrs[node_id]
                self._journal_append(rec)
            self._journal_maybe_compact()
            return True

    def put_summary(self, node_id: str, summary) -> bool:
        """Replace ``node_id``'s cache digest summary (full-state push, the
        ``InputCache.summary_sync()`` wire). Nodes call it at loop start and
        whenever their delta cursor falls off the cache's op window. Unknown
        or dead nodes, and wires this coordinator version cannot decode, are
        dropped (counted in ``summary_rejected``) — locality degrades,
        scheduling never breaks. Returns True iff the summary was applied."""
        with self._lock:
            return self._apply_summary_wire(node_id, summary)

    def heartbeat(self, node_id: str, summary_delta=None, blob_addr=None):
        """Node-level liveness refresh. ``summary_delta`` optionally
        piggybacks the host cache's digest-summary delta since the node's
        last push (``InputCache.summary_delta_since()`` wire: a handful of
        added/dropped digests plus live cache counters) — the few-bytes
        message that keeps coordinator-side placement scoring current.
        ``blob_addr`` re-advertises the host's blob server, so a worker
        whose register predates the coordinator restart still becomes
        routable within one heartbeat."""
        with self._lock:
            # unknown ids are dropped (not auto-registered): a reap must never
            # see a heartbeat for a node that has no deque to clean up
            if node_id not in self._dead and node_id in self._queues:
                self._heartbeats[node_id] = self._now()
                if summary_delta is not None:
                    self._apply_summary_wire(node_id, summary_delta)
                if blob_addr and \
                        self._blob_addrs.get(node_id) != str(blob_addr):
                    self._blob_addrs[node_id] = str(blob_addr)
                    self._journal_append({"t": "register", "n": node_id,
                                          "b": str(blob_addr)})
                    self._journal_maybe_compact()

    def mark_dead(self, node_id: str):
        """Explicit fail-fast path (e.g. a node's thread crashed)."""
        with self._lock:
            self._declare_dead(node_id)
            self._journal_maybe_compact()

    def reap(self) -> List[int]:
        """Declare heartbeat-expired nodes dead; requeue their leased units
        (epoch bumps on re-grant) and redistribute their queued entries onto
        the least-loaded alive nodes. Then expire individual leases a full
        TTL past their last renewal even though their holder still
        heartbeats — the lost-grant case (see the module docstring): the
        node never learned of the lease, so nobody will ever renew,
        complete, or free it. Returns the requeued unit idxs."""
        with self._lock:
            now = self._now()
            newly_dead = [n for n, hb in self._heartbeats.items()
                          if n not in self._dead and now - hb > self.lease_ttl_s]
            requeued: List[int] = []
            for n in newly_dead:
                requeued.extend(self._declare_dead(n))
            requeued.extend(self._expire_stale_leases(now))
            self._journal_maybe_compact()
            return requeued

    def _expire_stale_leases(self, now: float) -> List[int]:
        """Caller holds the lock. Reclaim leases whose ``granted_at`` is
        older than ``lease_ttl_s`` while the holding node is alive: nodes
        renew every in-hand lease on each heartbeat (refreshing
        ``granted_at``), so staleness on a live node means the grant was
        lost in flight. Dead holders are left to :meth:`_declare_dead` —
        it already requeued (or will requeue) everything they held."""
        requeued: List[int] = []
        for idx, lease in list(self._leases.items()):
            if lease.node_id not in self._dead \
                    and now - lease.granted_at > self.lease_ttl_s:
                requeued.extend(self._expire_lease(idx, False))
        for idx, lease in list(self._spec.items()):
            if lease.node_id in self._dead \
                    or now - lease.granted_at <= self.lease_ttl_s:
                continue
            if idx in self._spec_queues.get(lease.node_id, ()):
                # still queued coordinator-side: the twin was never handed
                # out, so nothing was lost in flight — delivery (the spec
                # pop in _next_unit_locked) restarts its expiry clock
                continue
            self._expire_lease(idx, True)
        return requeued

    def _expire_lease(self, idx: int, speculative: bool) -> List[int]:
        """Caller holds the lock. Drop one stale lease and requeue its unit
        (primary) or settle a deferred primary failure (twin — mirroring
        the dead-node twin path). The epoch is deliberately *not* bumped
        here: the next grant bumps it, so a re-run outranks the lost
        lease, while a holder that merely received the grant late can
        still complete — its report retires the unit through the ordinary
        arbitration and the stale deque entry is skipped as done."""
        lease = (self._spec if speculative else self._leases).pop(idx, None)
        if lease is None:
            return []
        rec = {"t": "expire", "i": idx}
        if speculative:
            rec["s"] = 1
        self._journal_append(rec)
        if speculative:
            # an expired twin evaporates; if the primary already failed and
            # was only waiting on this twin, the unit settles as failed
            if idx in self._failed_pending and idx not in self._done:
                self._retire(idx, self._failed_pending.pop(idx))
                pend = self._pending_meta.pop(idx, None)
                if pend is not None:
                    self._retire_meta(idx, pend)
            return []
        self._started.pop(idx, None)
        if idx in self._done:
            return []
        alive = [n for n in self._queues if n not in self._dead]
        if alive:
            self._queues[self._best_node(idx, alive)].appendleft(idx)
        else:
            self._backlog_appendleft(idx)
        self.requeues.append(idx)
        return [idx]

    def _declare_dead(self, node_id: str) -> List[int]:
        if node_id in self._dead:
            return []
        self._journal_append({"t": "dead", "n": node_id})
        self._dead.add(node_id)
        alive = [n for n in self._queues if n not in self._dead]
        orphans: List[int] = []
        # leased-but-unfinished units held by the dead node
        for idx, lease in list(self._leases.items()):
            if lease.node_id == node_id and idx not in self._done:
                self._leases.pop(idx)
                self._started.pop(idx, None)
                orphans.append(idx)
        # a twin on a dead node just evaporates — the primary still runs,
        # unless the primary already failed and was waiting on this twin
        for idx, lease in list(self._spec.items()):
            if lease.node_id == node_id:
                self._spec.pop(idx)
                if idx in self._failed_pending and idx not in self._done:
                    self._retire(idx, self._failed_pending.pop(idx))
                    pend = self._pending_meta.pop(idx, None)
                    if pend is not None:
                        self._retire_meta(idx, pend)
        self._spec_queues[node_id].clear()
        self._summaries.pop(node_id, None)   # dead cache scores nothing
        self._warm.drop_node(node_id)        # and holds no warm set
        self._blob_addrs.pop(node_id, None)  # and serves no peers
        # unleased entries still sitting in its deque
        orphans.extend(i for i in self._queues[node_id] if i not in self._done)
        self._queues[node_id].clear()
        if alive:
            for idx in orphans:
                # affinity-aware requeue: a survivor that already holds the
                # orphan's bytes re-runs it off local disk; with no summary
                # coverage this degrades to least-loaded, as before
                target = self._best_node(idx, alive)
                # front of the queue: requeued work is the oldest work
                self._queues[target].appendleft(idx)
        else:
            # nobody alive to take them: park in the backlog so a later
            # register() (network transport) can still finish the job
            for idx in reversed(orphans):
                self._backlog_appendleft(idx)
        self.requeues.extend(orphans)
        return orphans

    # -- introspection ------------------------------------------------------

    def finished(self) -> bool:
        with self._lock:
            return len(self._done) == len(self.units)

    def pending(self) -> int:
        with self._lock:
            return len(self.units) - len(self._done)

    def alive_nodes(self) -> List[str]:
        with self._lock:
            return [n for n in self._queues if n not in self._dead]

    def done_status(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._done)

    def queue_depths(self) -> Dict[str, int]:
        with self._lock:
            return {n: len(q) for n, q in self._queues.items()}

    def results_snapshot(self) -> Dict[str, object]:
        """Everything ``complete(meta=...)`` has recorded so far:
        ``{"primaries": {idx: entry}, "duplicates": [entry, ...]}`` where an
        entry is the JSON-safe completion record (idx, node_id, status,
        speculative, plus the caller's meta). ``primaries`` holds the
        completion that retired each unit; ``duplicates`` every non-retiring
        report. A coordinator folds these into its result list for units
        finished by nodes in other processes."""
        with self._lock:
            return {"primaries": {i: dict(m)
                                  for i, m in self._primary_meta.items()},
                    "duplicates": [dict(m) for m in self._dup_meta]}

    def primary_log(self, start: int = 0) -> List[dict]:
        """Retiring completions in retirement order, from offset ``start`` —
        the incremental feed a coordinator polls each tick (pass the count
        it has already consumed) instead of re-copying the full snapshot."""
        with self._lock:
            return [dict(m) for m in self._primary_log[start:]]

    def stats_snapshot(self) -> Dict[str, object]:
        """Control-plane counters in one JSON-safe call (the transport client
        mirrors these as properties): steals, requeues, renew rejections,
        plus the data-movement view operators previously had to grep
        provenance for — per-node cache counters (as last piggybacked on
        heartbeats: hits/misses/evictions/bytes_from_cache/bytes_from_storage)
        with a cluster-wide ``cache_totals`` roll-up, the placement
        counters (``locality``: scored vs blind grants, granted local bytes,
        steal affinity stats, rejected summary wires), and the DAG view
        (``dag``: units ready to run vs parked blocked behind unfinished
        parents vs cancelled — terminally blocked by a failed ancestor —
        plus per-stage/pipeline progress). Old rpc clients simply ignore
        the extra key."""
        with self._lock:
            totals: Dict[str, int] = {}
            for st in self._cache_stats.values():
                for k, v in st.items():
                    if isinstance(v, (int, float)):
                        totals[k] = totals.get(k, 0) + v
            hits = totals.get("hits", 0)
            lookups = hits + totals.get("misses", 0)
            # per-link byte meter: {fetcher: {peer addr: bytes}} as last
            # piggybacked on heartbeats — who pulled how much from whom
            peer_links = {n: dict(st["peer_bytes_by_addr"])
                          for n, st in self._cache_stats.items()
                          if isinstance(st.get("peer_bytes_by_addr"), dict)
                          and st["peer_bytes_by_addr"]}
            # DAG progress: blocked = parked behind unfinished parents,
            # cancelled = terminally blocked by a failed ancestor, ready =
            # everything grantable or in flight right now
            cancelled = sum(1 for s in self._done.values() if s == "blocked")
            per_stage: Dict[str, Dict[str, int]] = {}
            for i, u in enumerate(self.units):
                row = per_stage.setdefault(u.pipeline, {
                    "total": 0, "ok": 0, "failed": 0, "cancelled": 0,
                    "blocked": 0, "ready": 0})
                row["total"] += 1
                s = self._done.get(i)
                if s in ("ok", "skipped"):
                    row["ok"] += 1
                elif s == "blocked":
                    row["cancelled"] += 1
                elif s is not None:
                    row["failed"] += 1
                elif i in self._parked:
                    row["blocked"] += 1
                else:
                    row["ready"] += 1
            dag = {"ready": (len(self.units) - len(self._done)
                             - len(self._parked)),
                   "blocked": len(self._parked),
                   "cancelled": cancelled,
                   "per_stage": per_stage}
            return {"steals": dict(self.steals),
                    "requeues": list(self.requeues),
                    "renew_rejections": self.renew_rejections,
                    "locality": dict(self.locality_stats),
                    "summary_nodes": sorted(self._summaries),
                    "cache": {n: dict(st)
                              for n, st in self._cache_stats.items()},
                    "cache_totals": totals,
                    "cache_hit_rate": (hits / lookups) if lookups else 0.0,
                    "fabric": dict(self.fabric_stats),
                    "fabric_nodes": sorted(self._blob_addrs),
                    "peer_links": peer_links,
                    "dag": dag}

    def locate_blobs(self, digests: Sequence[str],
                     node_id: Optional[str] = None) -> Dict[str, List[str]]:
        """Peer candidates for content-addressed blobs: ``{digest: [blob
        server addr, ...]}`` ranked warmest-first
        (:func:`~repro_torch.dist.placement.best_peers` over the digest summaries
        this coordinator already holds). Only alive nodes that advertised a
        blob server are candidates, and the requester (``node_id``) never
        gets itself back. Membership is Bloom-probabilistic — a candidate
        may 404, the fetcher falls back — and digests no live peer holds
        are simply absent from the answer, so an empty dict is the honest
        "go read shared storage". Bounded (``LOCATE_DIGEST_CAP`` digests,
        ``LOCATE_PEERS_PER_DIGEST`` peers each) to keep lock time flat."""
        with self._lock:
            self.fabric_stats["locates"] += 1
            out: Dict[str, List[str]] = {}
            cand = [n for n in self._queues
                    if n not in self._dead and n != node_id
                    and n in self._blob_addrs]
            if not cand:
                self.fabric_stats["unlocated_digests"] += min(
                    len(digests), LOCATE_DIGEST_CAP)
                return out
            load = {n: len(q) for n, q in self._queues.items()}
            for digest in list(digests)[:LOCATE_DIGEST_CAP]:
                if not isinstance(digest, str):
                    continue
                holders = best_peers(digest, cand, self._summaries, load,
                                     limit=LOCATE_PEERS_PER_DIGEST)
                if holders:
                    out[digest] = [self._blob_addrs[n] for n in holders]
                    self.fabric_stats["located_digests"] += 1
                else:
                    self.fabric_stats["unlocated_digests"] += 1
            return out

    def summaries_snapshot(self) -> Dict[str, dict]:
        """Per-alive-node cache digest summaries as versioned full wires
        (``{node_id: {"v": 1, "full": ...}}``) — what the campaign planner
        (:mod:`repro_torch.core.campaign`) pulls from a live coordinator to shard
        the *next* cohort's job array by where bytes already sit. Served
        over rpc like the rest of the surface; empty when no node has
        pushed a summary (the planner then degrades to blind admission)."""
        with self._lock:
            return {n: {"v": SUMMARY_WIRE_VERSION, "full": s.to_wire()}
                    for n, s in self._summaries.items() if n not in self._dead}

    def active_leases(self) -> Dict[str, str]:
        """``job_id -> node_id`` for every in-flight lease (primary + twin) —
        the view :func:`repro_torch.core.query.query_available_work` consumes to
        avoid double-submitting leased sessions."""
        with self._lock:
            out = {self.units[i].job_id: l.node_id
                   for i, l in self._leases.items() if i not in self._done}
            for i, l in self._spec.items():
                if i not in self._done:
                    out.setdefault(self.units[i].job_id, l.node_id)
            return out
