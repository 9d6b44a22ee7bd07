"""Automated work query (paper §2.3): given a dataset manifest and a pipeline,
return exactly the sessions that (a) have the required inputs and (b) have no
completed, digest-matching derivative — plus a CSV of excluded sessions with
the cause (the paper's accompanying CSV)."""
from __future__ import annotations

import csv
import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

from .manifest import DatasetManifest, ImageRecord
from .pipelines import Pipeline
from .provenance import is_complete


@dataclasses.dataclass
class WorkUnit:
    dataset: str
    subject: str
    session: str
    pipeline: str
    pipeline_digest: str
    inputs: Dict[str, str]          # suffix -> path relative to dataset root
    out_dir: str                    # derivatives/<pipeline>/sub-x/ses-y
    # data-plane shape of the unit, straight from the manifest: content
    # digests and sizes per input suffix. The cluster queue scores these
    # against per-node cache summaries to place the unit where its bytes
    # already live (locality-aware scheduling, docs/cluster.md). Both default
    # empty so pre-existing units JSON (and manifests scanned with
    # checksum=False, whose digests are "") keep working — the unit is then
    # locality-blind, never broken.
    input_digests: Dict[str, str] = dataclasses.field(default_factory=dict)
    input_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Multi-stage curation DAGs: job_ids of units whose committed ok
    # provenance this unit's inputs are derived from (stage N outputs are
    # stage N+1 inputs — PyCURT's sort → label → convert → database).
    # The cluster queue grants a unit only once every parent listed here is
    # terminally ok/skipped; the campaign planner admits it to the shard
    # where the parents' outputs land (producer placement, docs/cluster.md).
    # Parents not present in the same queue/campaign count as satisfied —
    # the work query already excludes complete work, so a missing parent
    # means "done before this submission", not "unknowable".
    depends_on: List[str] = dataclasses.field(default_factory=list)

    @property
    def job_id(self) -> str:
        return f"{self.dataset}_{self.pipeline}_sub-{self.subject}_ses-{self.session}"

    @property
    def total_input_bytes(self) -> int:
        return sum(self.input_bytes.values())


@dataclasses.dataclass
class Exclusion:
    subject: str
    session: str
    reason: str


def query_available_work(manifest: DatasetManifest, pipeline: Pipeline, *,
                         leases: Optional[Mapping[str, str]] = None
                         ) -> Tuple[List[WorkUnit], List[Exclusion]]:
    """Sessions with the required inputs and no completed digest-matching
    derivative. ``leases`` (``job_id -> node_id``, e.g.
    ``WorkQueue.active_leases()``) additionally excludes sessions currently
    leased to a cluster node, so a second submitter racing a live cluster
    never double-schedules in-flight work — the exclusion CSV names the
    holding node."""
    work: List[WorkUnit] = []
    excluded: List[Exclusion] = []
    digest = pipeline.digest()
    leases = leases or {}
    for (sub, ses), recs in sorted(manifest.sessions().items()):
        by_suffix: Dict[str, ImageRecord] = {}
        for r in recs:
            by_suffix.setdefault(r.suffix, r)
        missing = [s for s in pipeline.spec.required_suffixes if s not in by_suffix]
        if missing:
            excluded.append(Exclusion(sub, ses, f"missing input(s): {','.join(missing)}"))
            continue
        out_dir = (Path(manifest.root) / "derivatives" / pipeline.name /
                   f"sub-{sub}" / f"ses-{ses}")
        if is_complete(out_dir, digest):
            excluded.append(Exclusion(sub, ses, "already processed (digest match)"))
            continue
        req = pipeline.spec.required_suffixes
        wu = WorkUnit(
            dataset=manifest.name, subject=sub, session=ses,
            pipeline=pipeline.name, pipeline_digest=digest,
            inputs={s: by_suffix[s].path for s in req},
            out_dir=str(out_dir),
            input_digests={s: by_suffix[s].sha256 for s in req
                           if by_suffix[s].sha256},
            input_bytes={s: by_suffix[s].size_bytes for s in req})
        if wu.job_id in leases:
            excluded.append(Exclusion(sub, ses,
                                      f"leased by {leases[wu.job_id]}"))
            continue
        work.append(wu)
    return work, excluded


def units_to_rows(units: List[WorkUnit]) -> List[dict]:
    """The JSON-row shape of a unit list — the one serialization every
    durable artifact shares (units JSON files, campaign shards, the
    coordinator journal's snapshot). ``depends_on`` is written only when
    non-empty: independent units keep the exact pre-DAG shape, so an old
    ``load_units`` still accepts them; a DAG unit fed to an old coordinator
    fails its ``WorkUnit(**u)`` with an unexpected-keyword ``TypeError``
    instead of silently running children before parents (version-skew
    fail-soft, docs/cluster.md)."""
    rows = []
    for u in units:
        d = dataclasses.asdict(u)
        if not d.get("depends_on"):
            d.pop("depends_on", None)
        rows.append(d)
    return rows


def units_from_rows(rows: List[dict]) -> List[WorkUnit]:
    """Inverse of :func:`units_to_rows` (missing digest fields —
    pre-locality rows — default empty: locality-blind, never broken; a
    missing ``depends_on`` key — pre-DAG rows — loads as an independent
    unit)."""
    return [WorkUnit(**u) for u in rows]


def dump_units(units: List[WorkUnit], path: Path) -> Path:
    """Serialize a unit list to the units-JSON artifact every execution path
    shares (SLURM array tasks, ``repro.dist.rpc serve``, campaign shards).
    Full-fidelity: the data-plane fields (``input_digests``/``input_bytes``)
    travel too, so a queue built from the file schedules locality-aware."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(units_to_rows(units), indent=1))
    return path


def load_units(path: Path) -> List[WorkUnit]:
    """Reload a :func:`dump_units` artifact into :class:`WorkUnit` objects
    identical to the originals."""
    return units_from_rows(json.loads(Path(path).read_text()))


def write_exclusion_csv(excluded: List[Exclusion], path: Path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["subject", "session", "reason"])
        for e in excluded:
            w.writerow([e.subject, e.session, e.reason])
