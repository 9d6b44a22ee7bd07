"""Workflow engine (paper §2.3, Fig. 3): query -> job scripts -> execution.

Generates a SLURM job-array script (the paper's HPC path) *and* a local
parallel runner (the paper's burst/debug path) from the same work list.

Execution data plane (``LocalRunner``) is built for throughput:

* **Multi-worker executor** — ``workers=N`` compute threads drain the unit
  list concurrently (torch releases the GIL, so pipeline compute overlaps).
* **Pipelined prefetch** — a loader stage verifies+hashes+loads the next
  units' inputs (one read per byte, see ``integrity.sha256_load_array``)
  while compute runs the current ones; lookahead is bounded by
  ``workers + prefetch`` units so memory stays flat.
* **Idempotent, concurrency-safe commits** — outputs are written via atomic
  tmp-file + rename; the ok-provenance commit is arbitrated per output dir
  (re-check under lock), so two workers racing the same unit produce exactly
  one committed provenance — the loser reports ``skipped``.
* **Retry + backoff** — failed units retry with exponential backoff, each
  attempt recorded in provenance.
* **Straggler speculation** — while a unit runs longer than
  ``straggler_factor`` x the running median (and ``workers > 1`` so there is
  spare capacity), a speculative duplicate is launched; provenance gating
  picks a single winner. Speculative results are reported with
  ``status="speculative"`` and never inflate per-image ok-counts.

``workers=1`` (the default) degrades to the serial paper behaviour with
prefetch still overlapping I/O and compute.

Campaign mode (``campaign=``/``summaries=``) and the host input cache
(``cache=``) arrive with the port's ``dist/`` slice (ROADMAP.md, Queue 1
item 3a); until then they raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import traceback
import weakref
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import stream as stream_mod
from .integrity import sha256_load_array, sha256_save_array
from .manifest import DatasetManifest
from .pipelines import Pipeline
from .provenance import make_provenance, is_complete
from .query import (WorkUnit, dump_units, load_units, query_available_work,
                    write_exclusion_csv)


# ---------------------------------------------------------------------------
# script generation
# ---------------------------------------------------------------------------

SLURM_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --array=0-{last_idx}%{throttle}
#SBATCH --cpus-per-task={cpus}
#SBATCH --mem={mem_gb}G
#SBATCH --time={walltime}
#SBATCH --output={log_dir}/%x_%a.out

set -euo pipefail
MANIFEST={manifest_json}
UNIT=$(python -m repro_torch.core.workflow --unit-from {units_json} --index $SLURM_ARRAY_TASK_ID)
# copy inputs to node-local scratch, run containerized pipeline, copy back
python -m repro_torch.core.workflow --run-one {units_json} --index $SLURM_ARRAY_TASK_ID \\
    --data-root {data_root} --scratch $SLURM_TMPDIR
"""


_DIST_SLICE = ("{} arrives with the port's dist/ slice (ROADMAP.md, Queue 1 "
               "item 3a)")


@dataclasses.dataclass
class JobPlan:
    units: List[WorkUnit]
    slurm_script: Optional[str] = None
    units_file: Optional[str] = None
    exclusion_csv: Optional[str] = None
    manifest_file: Optional[str] = None


def generate_jobs(manifest: DatasetManifest, pipeline: Pipeline, out_dir: Path,
                  *, cpus: int = 4, mem_gb: int = 16, walltime: str = "24:00:00",
                  throttle: int = 100, campaign=None, summaries=None) -> JobPlan:
    """The paper's single-line script generation: query + job array + CSV.

    Emits one untargeted array script over the whole unit list, with the
    manifest and units JSON next to it, so every path the generated script
    references exists at submit time. Campaign mode (``campaign=`` or
    ``summaries=``) is not ported yet and raises ``NotImplementedError``."""
    if campaign is not None or summaries is not None:
        raise NotImplementedError(_DIST_SLICE.format("campaign mode"))
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "logs").mkdir(exist_ok=True)      # SBATCH --output target
    units, excluded = query_available_work(manifest, pipeline)
    excl_csv = out_dir / f"{manifest.name}_{pipeline.name}_excluded.csv"
    write_exclusion_csv(excluded, excl_csv)
    units_file = dump_units(
        units, out_dir / f"{manifest.name}_{pipeline.name}_units.json")
    manifest_file = out_dir / "manifest.json"
    manifest.save(manifest_file)                 # referenced by every script
    plan = JobPlan(units=units, units_file=str(units_file),
                   exclusion_csv=str(excl_csv),
                   manifest_file=str(manifest_file))
    if not units:
        return plan

    script = SLURM_TEMPLATE.format(
        name=f"{manifest.name}_{pipeline.name}",
        last_idx=len(units) - 1, throttle=throttle, cpus=cpus,
        mem_gb=mem_gb, walltime=walltime,
        log_dir=str(out_dir / "logs"),
        manifest_json=str(manifest_file),
        units_json=str(units_file), data_root=manifest.root)
    sp = out_dir / f"{manifest.name}_{pipeline.name}.slurm"
    sp.write_text(script)
    plan.slurm_script = str(sp)
    return plan


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class UnitResult:
    unit: WorkUnit
    status: str                  # ok | failed | skipped | speculative | blocked
    seconds: float
    attempts: int
    error: Optional[str] = None
    # data-movement accounting (mirrors the provenance stamps): input bytes
    # served from the host cache on the committing run, input bytes streamed
    # from warm peers over the blob fabric, and the scheduler's grant-time
    # estimate of the locally-available input fraction
    bytes_from_cache: int = 0
    bytes_from_peer: int = 0
    locality_score: float = 0.0


# Commit arbitration for concurrent workers racing the same output dir.
# Thread-level: the atomic tmp+rename writes already make cross-process races
# safe at the file level; this lock adds the exactly-one-ok-commit guarantee
# within a runner process (the speculation + shared-queue case).


class _DirLock:
    """Weakref-able lock holder (a bare C lock cannot be weak-referenced)."""
    __slots__ = ("lock", "__weakref__")

    def __init__(self):
        self.lock = threading.Lock()


# WeakValueDictionary bounds memory in long-lived processes without an
# eviction policy: an entry lives exactly as long as some thread holds the
# returned _DirLock, so two racers can never end up with different locks
# for the same out_dir.
_COMMIT_LOCKS: "weakref.WeakValueDictionary[str, _DirLock]" = \
    weakref.WeakValueDictionary()
_COMMIT_LOCKS_GUARD = threading.Lock()


def _commit_lock(out_dir: Path) -> _DirLock:
    key = str(out_dir)
    with _COMMIT_LOCKS_GUARD:
        holder = _COMMIT_LOCKS.get(key)
        if holder is None:
            holder = _DirLock()
            _COMMIT_LOCKS[key] = holder
        return holder


# (inputs by suffix, rel-path -> sha256, every input served from host cache,
#  input bytes off node-local disk rather than shared storage, input bytes
#  streamed from warm peers over the blob fabric, per-unit streaming-ingest
#  report — StreamReport dict aggregated over the unit's streamed fetches,
#  None when nothing streamed)
LoadedInputs = Tuple[Dict[str, np.ndarray], Dict[str, str], bool, int, int,
                     Optional[Dict]]


def load_unit_inputs(unit: WorkUnit, data_root: Path,
                     cache=None) -> LoadedInputs:
    """Verify-and-load a unit's inputs with one read per file: each array is
    hashed from the same bytes it is deserialized from (no sha256_file +
    np.load double-read). This is the prefetch stage of the executor. With
    streaming on (``core/stream.py``) the digest is computed chunk by chunk
    while the bytes move, and the sixth element of the result is the unit's
    aggregated ``StreamReport`` dict (stamped into provenance as
    ``stream``); ``None`` when streaming is disabled. The cache and peer
    elements are False/0 until the ``dist/`` slice brings the host input
    cache; ``cache=`` raises ``NotImplementedError``."""
    if cache is not None:
        raise NotImplementedError(_DIST_SLICE.format("the host input cache"))
    data_root = Path(data_root)
    inputs: Dict[str, np.ndarray] = {}
    in_sums: Dict[str, str] = {}
    stream_rep: Optional[stream_mod.StreamReport] = None
    streaming = stream_mod.stream_enabled()
    for suffix, rel in unit.inputs.items():
        if streaming:
            arr, digest, _qa, rep = stream_mod.stream_load_npy(
                data_root / rel)
            if stream_rep is None:
                stream_rep = rep
            else:
                stream_rep.merge(rep)
        else:
            arr, digest = sha256_load_array(data_root / rel)
        in_sums[rel] = digest
        inputs[suffix] = arr
    return (inputs, in_sums, False, 0, 0,
            stream_rep.to_dict() if stream_rep is not None else None)


def safe_load_unit_inputs(unit: WorkUnit, data_root: Path,
                          cache=None) -> Optional[LoadedInputs]:
    """Prefetch-stage wrapper shared by both executors: a failed load returns
    ``None`` so the compute stage reloads and raises with full context."""
    try:
        return load_unit_inputs(unit, data_root, cache=cache)
    except Exception:  # noqa: BLE001 — the compute stage re-raises properly
        return None


def run_unit(unit: WorkUnit, pipeline: Pipeline, data_root: Path,
             attempt: int = 1,
             fault_hook: Optional[Callable[[WorkUnit, int], None]] = None,
             preloaded: Optional[LoadedInputs] = None,
             node_id: str = "", lease_epoch: int = 0,
             cache=None, locality_score: float = 0.0) -> UnitResult:
    """Execute one work unit: verify inputs, run, write outputs + provenance.

    ``preloaded`` short-circuits the input stage with already verified+loaded
    arrays from the prefetch pipeline. Output files are committed atomically
    and the ok-provenance is written under the per-out_dir commit lock with an
    ``is_complete`` re-check, so a racing duplicate commits exactly once; the
    loser returns ``skipped``. ``node_id``/``lease_epoch`` stamp the committed
    provenance when the unit runs under a cluster lease
    (the ``dist/`` slice). ``cache=`` (the host input cache) is not ported
    yet and raises ``NotImplementedError``. ``locality_score`` is the
    scheduler's grant-time estimate of the locally-available input fraction,
    stamped into provenance.
    """
    if cache is not None:
        raise NotImplementedError(_DIST_SLICE.format("the host input cache"))
    t0 = time.time()
    data_root = Path(data_root)
    out_dir = Path(unit.out_dir)
    if is_complete(out_dir, unit.pipeline_digest):
        return UnitResult(unit, "skipped", 0.0, attempt)
    try:
        if fault_hook is not None:
            fault_hook(unit, attempt)       # test hook: injected node failures
        if preloaded is not None:
            inputs, in_sums, cache_hit, hit_bytes, peer_bytes, stream = \
                preloaded
        else:
            inputs, in_sums, cache_hit, hit_bytes, peer_bytes, stream = \
                load_unit_inputs(unit, data_root)
        outputs = pipeline.run(inputs)
        out_sums = {}
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, arr in outputs.items():
            op = out_dir / f"sub-{unit.subject}_ses-{unit.session}_{name}.npy"
            out_sums[op.name] = sha256_save_array(op, arr)
        holder = _commit_lock(out_dir)   # keep referenced while lock is held
        with holder.lock:
            if is_complete(out_dir, unit.pipeline_digest):
                return UnitResult(unit, "skipped", time.time() - t0, attempt)
            make_provenance(unit.pipeline, unit.pipeline_digest, in_sums,
                            out_sums, t0, attempt=attempt, node_id=node_id,
                            lease_epoch=lease_epoch, cache_hit=cache_hit,
                            locality_score=locality_score,
                            bytes_from_cache=hit_bytes,
                            peer_fetch=peer_bytes > 0,
                            bytes_from_peer=peer_bytes,
                            stream=stream).save(out_dir)
        return UnitResult(unit, "ok", time.time() - t0, attempt,
                          bytes_from_cache=hit_bytes,
                          bytes_from_peer=peer_bytes,
                          locality_score=locality_score)
    except Exception as e:  # noqa: BLE001 — recorded, retried by the runner
        holder = _commit_lock(out_dir)
        with holder.lock:
            if not is_complete(out_dir, unit.pipeline_digest):
                out_dir.mkdir(parents=True, exist_ok=True)
                make_provenance(unit.pipeline, unit.pipeline_digest, {}, {}, t0,
                                status="failed", error=f"{type(e).__name__}: {e}",
                                attempt=attempt, node_id=node_id,
                                lease_epoch=lease_epoch).save(out_dir)
        return UnitResult(unit, "failed", time.time() - t0, attempt,
                          error=traceback.format_exc(limit=3))


def run_unit_with_retries(
        unit: WorkUnit, pipeline: Pipeline, data_root: Path, *,
        max_retries: int = 2, backoff_s: float = 0.05,
        fault_hook: Optional[Callable[[WorkUnit, int], None]] = None,
        preloaded: Optional[LoadedInputs] = None,
        node_id: str = "", lease_epoch: int = 0, cache=None,
        locality_score: float = 0.0) -> UnitResult:
    """The executor retry stage, shared by :class:`LocalRunner` workers and
    cluster nodes: run a unit up to ``max_retries + 1`` times with exponential
    backoff. Prefetched inputs are only trusted on the first attempt: a retry
    re-verifies from storage (the failure may have been a torn read)."""
    if cache is not None:
        raise NotImplementedError(_DIST_SLICE.format("the host input cache"))
    res = None
    for attempt in range(1, max_retries + 2):
        res = run_unit(unit, pipeline, data_root, attempt=attempt,
                       fault_hook=fault_hook,
                       preloaded=preloaded if attempt == 1 else None,
                       node_id=node_id, lease_epoch=lease_epoch,
                       locality_score=locality_score)
        if res.status in ("ok", "skipped"):
            break
        if attempt <= max_retries:          # no dead sleep after the last try
            time.sleep(backoff_s * (2 ** (attempt - 1)))
    return res


class StragglerDetector:
    """Running-median straggler policy shared by the single-host and cluster
    executors: a unit is a straggler once it has run ``factor`` x the median
    of completed-ok durations (with an absolute ``min_s`` floor, and only
    after ``min_samples`` completions so the median is meaningful)."""

    def __init__(self, factor: float = 3.0, min_s: float = 0.5,
                 min_samples: int = 4):
        self.factor = factor
        self.min_s = min_s
        self.min_samples = min_samples
        self._durations: List[float] = []
        self._lock = threading.Lock()

    def observe(self, seconds: float):
        with self._lock:
            self._durations.append(seconds)

    def median(self) -> Optional[float]:
        with self._lock:
            if len(self._durations) < self.min_samples:
                return None
            return float(np.median(self._durations))

    def is_straggler(self, elapsed: float) -> bool:
        med = self.median()
        return (med is not None and elapsed > self.min_s
                and elapsed > self.factor * med)


def dedupe_results(primaries: List[UnitResult],
                   speculative: List[Tuple[int, UnitResult]]) -> List[UnitResult]:
    """Fold speculative duplicates into the primary result list.

    Exactly one result per unit keeps a committed status; every duplicate is
    relabelled ``status="speculative"`` so ok-counts (benchmarks, reports)
    are never inflated. If the speculative twin won the commit race (the
    primary came back ``skipped``/``failed``), the unit's primary slot
    absorbs the twin's committed result."""
    primaries = list(primaries)
    extras: List[UnitResult] = []
    for idx, spec in speculative:
        prim = primaries[idx]
        if spec.status == "ok" and prim.status != "ok":
            primaries[idx] = dataclasses.replace(
                spec, attempts=max(prim.attempts, spec.attempts))
        extras.append(dataclasses.replace(spec, status="speculative"))
    return primaries + extras


class LocalRunner:
    """The paper's burst-to-local path: a pipelined parallel executor with
    retry, provenance-gated idempotency, and straggler speculation.

    Knobs:
      * ``workers``        — compute threads (1 = serial paper behaviour).
      * ``prefetch``       — extra units of input-load lookahead beyond
                             ``workers`` (the verify+load stage).
      * ``max_retries`` / ``backoff_s`` — retry failed units with
                             exponential backoff.
      * ``straggler_factor`` / ``straggler_min_s`` — speculate a duplicate
                             when a unit exceeds ``factor x running-median``
                             (and at least ``min_s`` seconds, >= 4 samples,
                             spare workers available).
    """

    def __init__(self, pipeline: Pipeline, data_root: Path, *,
                 max_retries: int = 2, backoff_s: float = 0.05,
                 straggler_factor: float = 3.0,
                 straggler_min_s: float = 0.5,
                 fault_hook: Optional[Callable[[WorkUnit, int], None]] = None,
                 workers: int = 1, prefetch: int = 2):
        self.pipeline = pipeline
        self.data_root = Path(data_root)
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.straggler_factor = straggler_factor
        self.straggler_min_s = straggler_min_s
        self.fault_hook = fault_hook
        self.workers = max(1, int(workers))
        self.prefetch = max(0, int(prefetch))

    # -- stages -------------------------------------------------------------

    def _execute(self, idx: int, unit: WorkUnit, loads: Dict[int, "object"],
                 loads_guard: threading.Lock, loader: ThreadPoolExecutor,
                 n_units: int, starts: Dict[int, float],
                 units: List[WorkUnit]) -> UnitResult:
        starts[idx] = time.time()
        # pick up (and release) this unit's prefetched inputs; top up the
        # lookahead window — popping keeps live arrays bounded by the window
        with loads_guard:
            pre_f = loads.pop(idx, None)
            nxt = idx + self.workers + self.prefetch
            if nxt < n_units and nxt not in loads:
                loads[nxt] = loader.submit(self._safe_load, units[nxt])
        pre = pre_f.result() if pre_f is not None else None
        return run_unit_with_retries(
            unit, self.pipeline, self.data_root, max_retries=self.max_retries,
            backoff_s=self.backoff_s, fault_hook=self.fault_hook, preloaded=pre)

    def _safe_load(self, unit: WorkUnit) -> Optional[LoadedInputs]:
        return safe_load_unit_inputs(unit, self.data_root)

    # -- driver -------------------------------------------------------------

    def run(self, units: List[WorkUnit]) -> List[UnitResult]:
        if not units:
            return []
        n = len(units)
        primaries: List[Optional[UnitResult]] = [None] * n
        detector = StragglerDetector(self.straggler_factor,
                                     self.straggler_min_s)
        starts: Dict[int, float] = {}
        speculated: set = set()
        spec_queue: List[int] = []
        spec_results: List[Tuple[int, UnitResult]] = []
        loads: Dict[int, "object"] = {}
        loads_guard = threading.Lock()
        next_primary = 0

        with ThreadPoolExecutor(max_workers=self.workers) as pool, \
                ThreadPoolExecutor(max_workers=max(1, min(self.workers, 2))) as loader:
            with loads_guard:
                for i in range(min(self.workers + self.prefetch, n)):
                    loads[i] = loader.submit(self._safe_load, units[i])
            # slot-based admission: at most ``workers`` tasks in the pool, so
            # a speculative twin dispatches into the NEXT free slot — ahead
            # of every waiting primary — and actually runs concurrently with
            # its straggler instead of queueing behind the whole work list
            inflight: Dict["object", Tuple[str, int]] = {}

            def dispatch():
                nonlocal next_primary
                while len(inflight) < self.workers:
                    if spec_queue:
                        i = spec_queue.pop(0)
                        f = pool.submit(run_unit, units[i], self.pipeline,
                                        self.data_root,
                                        attempt=self.max_retries + 2)
                        inflight[f] = ("spec", i)
                    elif next_primary < n:
                        i = next_primary
                        next_primary += 1
                        f = pool.submit(self._execute, i, units[i], loads,
                                        loads_guard, loader, n, starts, units)
                        inflight[f] = ("prim", i)
                    else:
                        break

            dispatch()
            # poll only when speculation is possible; with one worker there
            # is nothing to monitor, so block until a future completes
            poll = 0.05 if self.workers > 1 else None
            while inflight:
                done, _ = wait(set(inflight), timeout=poll,
                               return_when=FIRST_COMPLETED)
                for f in done:
                    kind, i = inflight.pop(f)
                    res = f.result()
                    if kind == "prim":
                        primaries[i] = res
                        if res.status == "ok":
                            detector.observe(res.seconds)
                    else:
                        spec_results.append((i, res))
                # straggler speculation: duplicate in-flight units running far
                # beyond the median (idempotent — provenance picks one winner)
                if self.workers > 1:
                    now = time.time()
                    for kind, i in list(inflight.values()):
                        if kind != "prim" or i in speculated or i not in starts:
                            continue
                        if detector.is_straggler(now - starts[i]):
                            speculated.add(i)
                            spec_queue.append(i)
                dispatch()

        return dedupe_results([r for r in primaries if r is not None],
                              spec_results)


def resource_status(root: Path) -> Dict[str, float]:
    """The paper's resource query informing when to submit (disk here; SLURM
    queue depth would come from `squeue` on a real cluster)."""
    st = os.statvfs(root)
    return {"disk_free_gb": st.f_bavail * st.f_frsize / 2**30,
            "disk_total_gb": st.f_blocks * st.f_frsize / 2**30,
            "load_1m": os.getloadavg()[0]}


# ---------------------------------------------------------------------------
# CLI used by the generated SLURM array scripts
# ---------------------------------------------------------------------------

def _main():
    import argparse
    from .pipelines import builtin_pipelines
    ap = argparse.ArgumentParser()
    ap.add_argument("--run-one", dest="units_json")
    ap.add_argument("--unit-from", dest="unit_from")
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--data-root", default=".")
    ap.add_argument("--scratch", default="/tmp")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; must exist) or cpu")
    args = ap.parse_args()
    src = args.units_json or args.unit_from
    units = load_units(Path(src))
    unit = units[args.index]
    if args.unit_from:
        print(unit.job_id)
        return
    pipe = builtin_pipelines(args.device)[unit.pipeline]
    res = run_unit(unit, pipe, Path(args.data_root))
    print(f"{unit.job_id}: {res.status} ({res.seconds:.1f}s)")
    if res.status == "failed":
        raise SystemExit(1)


if __name__ == "__main__":
    _main()
