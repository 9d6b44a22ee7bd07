"""The quickstart flow on the port with ``device="cpu"``: query, job
generation (blind and campaign mode), the local runner, the host input cache
under ``load_unit_inputs`` / ``run_unit``, provenance-gated reruns and the
CLI."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.core import (LocalRunner, Provenance, builtin_pipelines,
                              generate_jobs, load_unit_inputs,
                              query_available_work, run_unit,
                              run_unit_with_retries, synthesize_dataset)
from repro_torch.core.query import load_units
from repro_torch.core.workflow import (WRITE_THROUGH_ENV,
                                       safe_load_unit_inputs)
from repro_torch.dist import DigestSummary, InputCache

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


def _summary(units):
    s = DigestSummary()
    for u in units:
        for d in u.input_digests.values():
            s.add(d)
    return s


def test_generate_jobs_campaign_mode_shards_by_summary(tmp_path, dataset):
    pipe = builtin_pipelines("cpu")["bias_correct"]
    units, _ = query_available_work(dataset, pipe)
    plan = generate_jobs(dataset, pipe, tmp_path / "jobs",
                         summaries={"host-a": _summary(units[:1]),
                                    "host-b": _summary(units[1:3])})
    assert plan.slurm_script is None
    assert Path(plan.campaign_file) == tmp_path / "jobs" / "campaign.json"
    texts = [Path(s).read_text() for s in plan.shard_scripts]
    assert len(texts) == 3                 # host-a, host-b, the cold shard
    assert "--nodelist=host-a" in texts[0] and "--nodelist=host-b" in texts[1]
    assert "--nodelist" not in texts[2]
    assert all("python -m repro_torch.core.workflow --run-one" in t
               for t in texts)
    shard_units = [load_units(Path(f)) for f in plan.shard_units_files]
    assert sorted(u.job_id for us in shard_units for u in us) == \
        sorted(u.job_id for u in units)
    # a campaign plan replays byte-identically into a fresh directory
    again = generate_jobs(dataset, pipe, tmp_path / "again",
                          campaign=plan.campaign_file)
    assert Path(again.campaign_file).read_bytes() == \
        Path(plan.campaign_file).read_bytes()
    # a shard's units file drives the CLI like the monolithic one
    out = _cli(["--run-one", plan.shard_units_files[1], "--index", "0",
                "--data-root", dataset.root, "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith(f"{shard_units[1][0].job_id}: ok")


@pytest.mark.parametrize("stream", ["1", "0"])
def test_load_unit_inputs_through_the_cache_equals_the_reference(
        tmp_path, dataset, monkeypatch, stream):
    monkeypatch.setenv("REPRO_STREAM_INGEST", stream)
    import repro.core.workflow as RW
    import repro.dist.cache as RC
    pipe = builtin_pipelines("cpu")["dwi_prequal"]
    unit = query_available_work(dataset, pipe)[0][0]
    seen = {}
    for name, load, C in (("ref", RW.load_unit_inputs, RC.InputCache),
                          ("port", load_unit_inputs, InputCache)):
        cache = C(tmp_path / name)
        rows = []
        for _ in range(2):                 # a miss, then a hit
            inputs, sums, hit, from_cache, from_peer, stream_rep = \
                load(unit, dataset.root, cache=cache)
            rows.append((sorted(inputs), sums, hit, from_cache, from_peer,
                         stream_rep is not None))
        seen[name] = rows
    assert seen["port"] == seen["ref"]
    (miss, hit) = seen["port"]
    assert miss[2] is False and hit[2] is True and hit[3] > 0
    assert len(miss[1]) == 2               # T1w and dwi
    assert safe_load_unit_inputs(unit, dataset.root,
                                 cache=InputCache(tmp_path / "port"))[2]


def test_run_unit_with_cache_stamps_and_writes_through(tmp_path, dataset,
                                                       monkeypatch):
    pipe = builtin_pipelines("cpu")["bias_correct"]
    units = query_available_work(dataset, pipe)[0]
    cache = InputCache(tmp_path / "cache")
    for rel in units[0].inputs.values():   # warm the first unit's input
        cache.fetch_array(Path(dataset.root) / rel)
    res = run_unit(units[0], pipe, dataset.root, cache=cache,
                   node_id="node-0", locality_score=1.0)
    assert res.status == "ok" and res.bytes_from_cache > 0
    prov = Provenance.load(Path(units[0].out_dir))
    assert prov.cache_hit and prov.bytes_from_cache == res.bytes_from_cache
    assert prov.locality_score == 1.0 and prov.node_id == "node-0"
    # the committed outputs wrote through into the host cache
    assert all(cache.read_blob(d) is not None for d in prov.outputs.values())
    monkeypatch.setenv(WRITE_THROUGH_ENV, "0")
    blobs = cache.blob_count()
    assert run_unit(units[1], pipe, dataset.root, cache=cache).status == "ok"
    assert cache.blob_count() == blobs + 1  # its input only, no outputs


def test_retries_trust_the_cache_on_the_first_attempt_only(tmp_path,
                                                          dataset):
    pipe = builtin_pipelines("cpu")["bias_correct"]
    unit = query_available_work(dataset, pipe)[0][0]
    cache = InputCache(tmp_path / "cache")
    for rel in unit.inputs.values():
        cache.fetch_array(Path(dataset.root) / rel)
    hits = cache.stats()["hits"]

    def flaky(u, attempt):
        if attempt == 1:
            raise RuntimeError("transient")

    res = run_unit_with_retries(unit, pipe, dataset.root, cache=cache,
                                fault_hook=flaky, backoff_s=0.0)
    assert res.status == "ok" and res.attempts == 2
    prov = Provenance.load(Path(unit.out_dir))
    assert prov.attempt == 2 and not prov.cache_hit
    assert prov.bytes_from_cache == 0      # attempt 2 re-read storage
    assert cache.stats()["hits"] == hits   # and never asked the cache


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
