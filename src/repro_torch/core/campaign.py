"""Campaign planner: locality-aware admission at ``generate_jobs`` scale.

PR 4 made placement cache-aware at *grant* time, inside one live
:class:`~repro_torch.dist.queue.WorkQueue`. The paper's actual entry point is
batch admission — the automated query turned into a job array — and that
array was placement-blind: every SLURM task landed wherever the scheduler
had room, then pulled its inputs across the storage link. This module moves
the same scoring to *admission* time (brainlife.io's job-to-data routing at
the batch-system layer), and makes the resulting plan a deterministic,
replayable artifact (Clinica's campaign-level reproducibility argument):

* **Cohorts in** — N ``(manifest, pipeline)`` cohorts, each reduced by
  :func:`~repro_torch.core.query.query_available_work` to admitted units +
  exclusions (:func:`cohort_from_query`), or handed in pre-queried.
* **Summaries in** — per-host cache
  :class:`~repro_torch.dist.cache.DigestSummary` snapshots, pulled from a
  live coordinator (:func:`summaries_from_queue`, in process or over
  ``repro_torch.dist.rpc``) or loaded from a
  serialized summaries file for offline HPC planning
  (:func:`repro_torch.dist.cache.load_summary_file` /
  :func:`~repro_torch.dist.cache.summaries_from_cache_dirs`).
* **Plan out** — a :class:`CampaignPlan`: every admitted unit bucketed into
  exactly one shard, warm shards pinned to the node holding their bytes,
  cold units (no warm host anywhere) in an untargeted shard. Scoring is the
  **same function the queue uses at grant time**
  (:func:`repro_torch.dist.placement.unit_local_bytes`), so admission and grant
  ranking cannot drift. Admission throttling is derived from
  :func:`~repro_torch.core.workflow.resource_status` (the paper's query-before-
  submit discipline).

The plan serializes to a canonical ``campaign.json`` — sorted keys, no
timestamps, stamped with a sha256 over its *inputs* — so replanning from
identical inputs is byte-identical and an auditor can tell exactly which
data/summary state produced a submitted campaign. Both execution paths
consume it: :func:`~repro_torch.core.workflow.generate_jobs` writes one SLURM
array script per shard (``campaign=``/``summaries=``), and
``WorkQueue``/``ClusterRunner`` accept ``plan=`` to seed their backlog
partitions so a cluster starts warm instead of rediscovering locality.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import json
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

from ..dist.cache import DigestSummary
from ..dist.placement import best_node, unit_local_bytes
from .manifest import DatasetManifest
from .pipelines import Pipeline
from .query import Exclusion, WorkUnit, query_available_work

CAMPAIGN_VERSION = 1
DEFAULT_THROTTLE = 100


@dataclasses.dataclass
class Cohort:
    """One (dataset, pipeline) slice of a campaign: the admitted units plus
    the exclusions the query produced (the planner re-checks the exclusion
    list, so an excluded session can never be admitted by construction)."""
    dataset: str
    pipeline: str
    pipeline_digest: str
    units: List[WorkUnit]
    excluded: List[Exclusion] = dataclasses.field(default_factory=list)


def cohort_from_query(manifest: DatasetManifest, pipeline: Pipeline,
                      *, leases=None) -> Cohort:
    """The paper's automated query, packaged as a campaign cohort."""
    units, excluded = query_available_work(manifest, pipeline, leases=leases)
    return Cohort(manifest.name, pipeline.name, pipeline.digest(),
                  units, excluded)


@dataclasses.dataclass
class Shard:
    """One admission bucket = one SLURM job array = one seeded node deque.
    ``node_id=None`` marks the cold shard (no warm host for these units)."""
    shard_id: str
    node_id: Optional[str]
    unit_ids: List[str]                 # job_ids, admission order
    est_local_bytes: int                # Σ scorer estimate on the target
    est_total_bytes: int                # Σ total input bytes


@dataclasses.dataclass
class CampaignPlan:
    """The deterministic, replayable admission artifact.

    ``inputs_hash`` is a sha256 over the canonicalized planner inputs
    (cohort units + exclusions, summary wires, knobs, resource status), so
    two plans agree byte-for-byte iff they were computed from the same
    world-state — the campaign-level reproducibility check."""
    version: int
    inputs_hash: str
    cohorts: List[dict]                 # per-cohort admission accounting
    nodes: List[str]                    # summary-backed node ids, sorted
    shards: List[Shard]
    throttle: int                       # resource-derived admission throttle
    excluded: List[dict]                # every excluded session, with reason
    resource: dict = dataclasses.field(default_factory=dict)

    # -- introspection -------------------------------------------------------

    def assigned_unit_ids(self) -> List[str]:
        """Every assigned job_id, in shard order (each exactly once)."""
        return [jid for s in self.shards for jid in s.unit_ids]

    def est_local_fraction(self) -> float:
        """Planner's estimate of the input-byte fraction served node-local."""
        total = sum(s.est_total_bytes for s in self.shards)
        local = sum(s.est_local_bytes for s in self.shards)
        return local / total if total else 0.0

    # -- persistence ---------------------------------------------------------

    def to_json(self) -> str:
        """Canonical encoding: sorted keys, fixed indent, trailing newline —
        byte-identical across replans from identical inputs."""
        return json.dumps(dataclasses.asdict(self), sort_keys=True,
                          indent=1) + "\n"

    def save(self, path: Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())
        return path

    @classmethod
    def from_dict(cls, d: dict, source: str = "campaign plan"
                  ) -> "CampaignPlan":
        """Reconstruct from the parsed ``campaign.json`` shape. The version
        check lives here so every intake path (file, pre-parsed dict)
        rejects a future plan identically instead of misreading it."""
        if d.get("version") != CAMPAIGN_VERSION:
            raise ValueError(
                f"{source}: campaign version {d.get('version')!r}, "
                f"this build speaks {CAMPAIGN_VERSION}")
        d = dict(d)
        d["shards"] = [Shard(**s) if isinstance(s, dict) else s
                       for s in d.get("shards", [])]
        return cls(**d)

    @classmethod
    def load(cls, path: Path) -> "CampaignPlan":
        return cls.from_dict(json.loads(Path(path).read_text()), str(path))


def as_plan(obj) -> CampaignPlan:
    """Coerce whatever plan shape the caller holds — a live
    :class:`CampaignPlan`, a ``campaign.json`` path, or its parsed dict —
    into a :class:`CampaignPlan` (the replay path: resubmitting an audited
    campaign without re-planning)."""
    if isinstance(obj, CampaignPlan):
        return obj
    if isinstance(obj, (str, Path)):
        return CampaignPlan.load(obj)
    if isinstance(obj, dict):
        return CampaignPlan.from_dict(obj)
    raise TypeError(f"cannot interpret {type(obj).__name__} as a campaign "
                    "plan (expected CampaignPlan, path, or parsed dict)")


# ---------------------------------------------------------------------------
# summary intake: live coordinator, serialized file, or in-memory objects
# ---------------------------------------------------------------------------

def summaries_from_queue(queue_or_addr) -> Dict[str, dict]:
    """Per-node summary wires from a live coordinator: an in-process
    :class:`~repro_torch.dist.queue.WorkQueue`, an open
    :class:`~repro_torch.dist.rpc.QueueClient`, or a ``"host:port"`` string
    (a one-shot client is dialed and closed)."""
    if isinstance(queue_or_addr, str):
        from ..dist.rpc import QueueClient, parse_addr
        client = QueueClient(parse_addr(queue_or_addr))
        try:
            return client.summaries_snapshot()
        finally:
            client.close()
    return queue_or_addr.summaries_snapshot()


def _normalize_summaries(summaries) -> Dict[str, DigestSummary]:
    """Decode whatever summary shape the caller holds — live
    :class:`DigestSummary` objects, ``summaries_snapshot`` wires, raw
    ``to_wire`` payloads, or a summaries-file path — into per-node filters.
    Undecodable wires (version skew, garbage) drop that node to blind,
    mirroring the coordinator's fail-soft."""
    if summaries is None:
        return {}
    if isinstance(summaries, (str, Path)):
        from ..dist.cache import load_summary_file
        summaries = load_summary_file(summaries)
    out: Dict[str, DigestSummary] = {}
    for node_id, s in summaries.items():
        if isinstance(s, DigestSummary):
            out[str(node_id)] = s
            continue
        wire = s.get("full", s) if isinstance(s, dict) else s
        decoded = DigestSummary.from_wire(wire)
        if decoded is not None:
            out[str(node_id)] = decoded
    return out


# ---------------------------------------------------------------------------
# admission throttling: the resource query gating how hard we submit
# ---------------------------------------------------------------------------

def admission_throttle(status: Optional[Mapping[str, float]],
                       max_unit_bytes: int,
                       requested: int = DEFAULT_THROTTLE) -> int:
    """Cap the SLURM array throttle (``%N``) so concurrent tasks' scratch
    footprint stays inside the submit host's free disk. Each in-flight task
    holds roughly its inputs plus outputs (~2x inputs); keeping the
    concurrent total under half of free disk leaves headroom for everything
    else on the filesystem. Deterministic in its inputs; degenerate status
    (no free-disk reading, zero-byte units) keeps the requested throttle."""
    requested = max(1, int(requested))
    if not status or max_unit_bytes <= 0:
        return requested
    free = float(status.get("disk_free_gb", 0.0)) * 2**30
    if free <= 0:
        return requested
    cap = int(free // (4 * max_unit_bytes))
    return max(1, min(requested, cap))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

class _PlannedView:
    """Duck-typed summary union the scorer reads during DAG admission: the
    node's *real* cache summary plus the digests the plan predicts will land
    there (outputs of parents already assigned to the node, which write
    through into the host cache the moment they commit). Implements exactly
    the surface :func:`~repro_torch.dist.placement.unit_local_bytes` probes
    (``len`` + ``in``), so producer placement flows through the same shared
    scorer as every other placement decision — rankings cannot drift."""
    __slots__ = ("real", "planned")

    def __init__(self, real: DigestSummary, planned: set):
        self.real = real
        self.planned = planned

    def __contains__(self, digest) -> bool:
        return digest in self.planned or digest in self.real

    def __len__(self) -> int:
        return len(self.real) + len(self.planned)


def plan_campaign(cohorts: Sequence[Cohort], summaries=None, *,
                  throttle: int = DEFAULT_THROTTLE,
                  status: Optional[Mapping[str, float]] = None,
                  max_shard_units: Optional[int] = None) -> CampaignPlan:
    """Bucket N cohorts' admitted units into per-node shards by the shared
    placement score.

    Deterministic: units are admitted in cohort order then query order and
    assigned in dependency (topological) order — stable by admission order,
    so a dependency-free campaign assigns in exactly the admission walk —
    with nodes ranked by ``(-local_bytes, assigned_bytes, node_id)``.
    Replanning from identical inputs yields a byte-identical plan.
    Guarantees (property-tested): every admitted unit lands in exactly one
    shard; a session the cohort excluded is never assigned; a unit admitted
    by several cohorts (overlapping manifests) is assigned once, under its
    first admission.

    **Producer placement** (multi-stage DAGs): a parent's placement *is*
    the next stage's locality — its outputs write through into the host
    cache where it runs — so when a unit is assigned to a node, the input
    digests its ``depends_on`` children declare are folded into that node's
    planned warm set, and the children (assigned later: topological order)
    score those predicted bytes through the same scorer as real summary
    bytes. Children then shard to the node where their parents' outputs
    will land. A ``depends_on`` cycle among admitted units raises
    ``ValueError``; edges to job_ids outside the campaign count as
    satisfied and score nothing.

    ``max_shard_units`` splits a node's bucket into multiple arrays (site
    ``MaxArraySize`` limits); ``status`` (a
    :func:`~repro_torch.core.workflow.resource_status` dict) tightens the
    admission throttle. With no usable summaries every unit is cold and the
    plan degrades to one untargeted shard — blind admission, exactly what
    ``generate_jobs`` emitted before this module existed."""
    decoded = _normalize_summaries(summaries)
    nodes = sorted(decoded)
    status = dict(status or {})

    # pass 1 — admission: cohort order, exclusion re-check, first-cohort
    # dedup. Placement waits for pass 2 so parents are placed before the
    # children that score against their predicted outputs.
    admitted_units: List[WorkUnit] = []
    seen: set = set()
    cohort_rows: List[dict] = []
    excluded_rows: List[dict] = []
    max_unit_bytes = 0
    for cohort in cohorts:
        excl_keys = {(e.subject, e.session) for e in cohort.excluded}
        admitted = 0
        for e in cohort.excluded:
            excluded_rows.append({
                "dataset": cohort.dataset, "pipeline": cohort.pipeline,
                "subject": e.subject, "session": e.session,
                "reason": e.reason})
        for u in cohort.units:
            if (u.subject, u.session) in excl_keys or u.job_id in seen:
                continue
            seen.add(u.job_id)
            admitted += 1
            max_unit_bytes = max(max_unit_bytes, u.total_input_bytes)
            admitted_units.append(u)
        cohort_rows.append({
            "dataset": cohort.dataset, "pipeline": cohort.pipeline,
            "pipeline_digest": cohort.pipeline_digest,
            "admitted": admitted, "excluded": len(cohort.excluded)})

    # DAG edges among admitted units + predicted outputs per parent: a
    # child's declared input digests are, by definition of depends_on, bytes
    # its parents' commits will produce
    by_job = {u.job_id: k for k, u in enumerate(admitted_units)}
    children: Dict[int, List[int]] = {}
    indeg: Dict[int, int] = {}
    produced: Dict[int, set] = {}
    for k, u in enumerate(admitted_units):
        ps = {by_job[str(d)] for d in getattr(u, "depends_on", None) or ()
              if str(d) in by_job}
        if not ps:
            continue
        indeg[k] = len(ps)
        child_digests = set((u.input_digests or {}).values())
        for p in ps:
            children.setdefault(p, []).append(k)
            if child_digests:
                produced.setdefault(p, set()).update(child_digests)

    # pass 2 — assignment in topological order, stable by admission index
    # (a heap of ready units), so a dependency-free campaign walks exactly
    # the admission order the old single-pass planner did
    heap = [k for k in range(len(admitted_units)) if k not in indeg]
    heapq.heapify(heap)
    planned: Dict[str, set] = {n: set() for n in nodes}
    views = {n: _PlannedView(decoded[n], planned[n]) for n in nodes}
    assigned: Dict[str, List[WorkUnit]] = {n: [] for n in nodes}
    scores: Dict[str, int] = {}                      # job_id -> grant score
    loads: Dict[str, int] = {n: 0 for n in nodes}    # Σ bytes, tie-break
    cold: List[WorkUnit] = []
    placed = 0
    while heap:
        k = heapq.heappop(heap)
        placed += 1
        u = admitted_units[k]
        target = best_node(u, nodes, views, loads) if nodes else None
        score = (unit_local_bytes(u, views[target])
                 if target is not None else 0)
        if target is None or score <= 0:
            cold.append(u)
        else:
            assigned[target].append(u)
            scores[u.job_id] = score
            loads[target] += u.total_input_bytes
            planned[target].update(produced.get(k, ()))
        for c in children.get(k, ()):
            indeg[c] -= 1
            if indeg[c] == 0:
                del indeg[c]
                heapq.heappush(heap, c)
    if placed < len(admitted_units):
        cyc = sorted(admitted_units[k].job_id for k in indeg)
        raise ValueError(
            "depends_on cycle among admitted units: " + ", ".join(cyc))

    def chunks(units: List[WorkUnit]) -> List[List[WorkUnit]]:
        if not max_shard_units or max_shard_units < 1:
            return [units] if units else []
        return [units[i:i + max_shard_units]
                for i in range(0, len(units), max_shard_units)]

    shards: List[Shard] = []
    for node_id in nodes:
        for i, chunk in enumerate(chunks(assigned[node_id])):
            shards.append(Shard(
                shard_id=f"shard-{len(shards):03d}", node_id=node_id,
                unit_ids=[u.job_id for u in chunk],
                est_local_bytes=sum(scores[u.job_id] for u in chunk),
                est_total_bytes=sum(u.total_input_bytes for u in chunk)))
    for chunk in chunks(cold):
        shards.append(Shard(
            shard_id=f"shard-{len(shards):03d}", node_id=None,
            unit_ids=[u.job_id for u in chunk], est_local_bytes=0,
            est_total_bytes=sum(u.total_input_bytes for u in chunk)))

    return CampaignPlan(
        version=CAMPAIGN_VERSION,
        inputs_hash=_inputs_hash(cohorts, decoded, throttle, status,
                                 max_shard_units),
        cohorts=cohort_rows, nodes=nodes, shards=shards,
        throttle=admission_throttle(status, max_unit_bytes, throttle),
        excluded=excluded_rows, resource=status)


def _inputs_hash(cohorts: Sequence[Cohort],
                 decoded: Mapping[str, DigestSummary], throttle: int,
                 status: Mapping[str, float],
                 max_shard_units: Optional[int]) -> str:
    """sha256 over the canonicalized planner inputs — the stamp that makes
    two byte-identical plans mean 'planned from the same world-state'."""
    payload = {
        "version": CAMPAIGN_VERSION,
        "cohorts": [{
            "dataset": c.dataset, "pipeline": c.pipeline,
            "pipeline_digest": c.pipeline_digest,
            "units": [dataclasses.asdict(u) for u in c.units],
            "excluded": [dataclasses.asdict(e) for e in c.excluded],
        } for c in cohorts],
        "summaries": {n: s.to_wire() for n, s in sorted(decoded.items())},
        "throttle": throttle,
        "status": {k: status[k] for k in sorted(status)},
        "max_shard_units": max_shard_units,
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()
