"""Quickstart on the PyTorch port: the paper's workflow in ~40 lines.

Synthesizes a small BIDS dataset, queries the work available for a pipeline,
generates the SLURM array + runs locally, and shows the provenance trail.
Runs on the GPU; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import json
import tempfile
from pathlib import Path

from repro_torch.core import (LocalRunner, builtin_pipelines, generate_jobs,
                              query_available_work, synthesize_dataset)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

with tempfile.TemporaryDirectory() as td:
    # 1. a BIDS-organized dataset lands on the archive
    ds = synthesize_dataset(Path(td), "demo", n_subjects=2,
                            sessions_per_subject=1, shape=(12, 12, 12))
    print(f"dataset {ds.name}: {len(ds.images)} images, "
          f"{len(ds.sessions())} sessions, BIDS problems: {ds.validate()}")

    # 2. query what needs processing + generate the job array
    pipe = builtin_pipelines(args.device)["bias_correct"]
    plan = generate_jobs(ds, pipe, Path(td) / "jobs")
    print(f"pipeline {pipe.name} (digest {pipe.digest()}): "
          f"{len(plan.units)} work units")
    print(f"SLURM array script: {plan.slurm_script}")

    # 3. burst-to-local execution (same units the cluster would run)
    results = LocalRunner(pipe, ds.root).run(plan.units)
    print("results:", [(r.unit.job_id, r.status, f"{r.seconds:.2f}s")
                       for r in results])

    # 4. provenance: who / when / inputs / digest — next to every output
    prov = json.loads((Path(plan.units[0].out_dir) / "provenance.json").read_text())
    print("provenance keys:", sorted(prov))

    # 5. idempotency: the query now finds nothing to do
    work, excluded = query_available_work(ds, pipe)
    print(f"re-query: {len(work)} units to run; "
          f"exclusions: {[e.reason for e in excluded]}")
