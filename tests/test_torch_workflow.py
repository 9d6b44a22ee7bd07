"""The quickstart flow on the port with ``device="cpu"``: query, job
generation, the local runner, provenance-gated reruns and the CLI."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.core import (LocalRunner, builtin_pipelines, generate_jobs,
                              load_unit_inputs, query_available_work,
                              run_unit, synthesize_dataset)

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture()
def dataset(tmp_path):
    return synthesize_dataset(tmp_path, "demo", n_subjects=2,
                              sessions_per_subject=2, shape=(12, 12, 12))


@pytest.mark.parametrize("name", ["bias_correct", "affine_register",
                                  "dwi_prequal"])
def test_quickstart_flow(tmp_path, dataset, name):
    pipe = builtin_pipelines("cpu")[name]
    plan = generate_jobs(dataset, pipe, tmp_path / "jobs")
    n_sessions = len(dataset.sessions())
    n_excluded = 2 if name == "dwi_prequal" else 0   # odd subjects lack DWI
    assert len(plan.units) == n_sessions - n_excluded
    script = Path(plan.slurm_script).read_text()
    assert "python -m repro_torch.core.workflow --run-one" in script
    assert "repro.core.workflow" not in script
    results = LocalRunner(pipe, dataset.root, workers=2).run(plan.units)
    assert [r.status for r in results] == ["ok"] * len(plan.units)
    prov = json.loads((Path(plan.units[0].out_dir) / "provenance.json")
                      .read_text())
    assert prov["pipeline_digest"] == pipe.digest()
    assert prov["status"] == "ok" and prov["stream"]["nbytes"] > 0
    again = LocalRunner(pipe, dataset.root, workers=2).run(plan.units)
    assert [r.status for r in again] == ["skipped"] * len(plan.units)
    work, excluded = query_available_work(dataset, pipe)
    assert work == []
    assert sum(e.reason == "already processed (digest match)"
               for e in excluded) == len(plan.units)


def test_campaign_mode_and_cache_wait_for_the_dist_slice(tmp_path, dataset):
    pipe = builtin_pipelines("cpu")["bias_correct"]
    with pytest.raises(NotImplementedError, match="dist/ slice"):
        generate_jobs(dataset, pipe, tmp_path / "j", summaries=[])
    unit = generate_jobs(dataset, pipe, tmp_path / "j").units[0]
    with pytest.raises(NotImplementedError, match="dist/ slice"):
        load_unit_inputs(unit, dataset.root, cache=object())
    with pytest.raises(NotImplementedError, match="dist/ slice"):
        run_unit(unit, pipe, dataset.root, cache=object())


def _cli(args, **env):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.core.workflow", *args],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(SRC), **env})


def test_cli_run_one_device_rule(tmp_path, dataset):
    pipe = builtin_pipelines("cpu")["bias_correct"]
    plan = generate_jobs(dataset, pipe, tmp_path / "jobs")
    base = ["--run-one", plan.units_file, "--index", "0",
            "--data-root", dataset.root]
    # no card visible and no --device cpu: the default (cuda) refuses
    out = _cli(base, CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    out = _cli([*base, "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith(f"{plan.units[0].job_id}: ok")
    out = _cli([*base, "--device", "cpu"])
    assert ": skipped" in out.stdout
    out = _cli(["--unit-from", plan.units_file, "--index", "1"])
    assert out.stdout.strip() == plan.units[1].job_id
