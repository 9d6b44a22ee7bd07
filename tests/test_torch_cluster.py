"""The port's cluster (``repro_torch.dist.cluster``): the safety invariant
over the reference's fixed grid with the host cache and the journal on, over
the socket transport, the peer fabric, coordinator restarts and network
chaos (the parameter sets of the reference's ``test_rpc.py`` and
``test_faults.py``), input digests committed equal to the reference's
``ClusterRunner`` on the same dataset, a whole-process stall that the
reference reads as every node dead (ROADMAP.md, F3), and the runner's
refusals of settings it cannot honour."""
import importlib
import shutil
import threading
import time
from pathlib import Path

import pytest

from torch_cluster_invariant import check_cluster_invariant

# the reference's test_cluster_invariant_fixed_grid cases
GRID = [(2, 2, 3, True, 1), (1, 1, 2, False, 0), (3, 1, 1, True, 0)]


@pytest.mark.parametrize("n_subjects,sessions,nodes,flaky,die", GRID)
@pytest.mark.parametrize("cache,journal", [(False, False), (True, True)])
def test_cluster_invariant_fixed_grid(n_subjects, sessions, nodes, flaky, die,
                                      cache, journal):
    check_cluster_invariant(n_subjects, sessions, nodes, flaky, die,
                            cache=cache, journal=journal)


@pytest.mark.parametrize("flaky,kw", [
    # not flaky: a retry re-reads storage, and the warm check wants the
    # first attempt's cache hits
    (False, dict(cache_per_node=True, plan=True, journal=True)),
    (True, dict(harass_renew=True, cache=True)),
    (True, dict(harass_locality=True)),
    (True, dict(dag_edges={2: [0], 3: [1, 2]}, fail_idx=1, journal=True)),
], ids=["plan", "renew", "locality", "dag"])
def test_cluster_invariant_variants(flaky, kw):
    check_cluster_invariant(2, 2, 3, flaky, 1, **kw)


# the reference's test_rpc.py::test_cluster_invariant_over_transport cases
TRANSPORT = [
    ("rpc", False, False, False, False),
    ("rpc", True, False, False, False),
    ("local", True, True, False, False),
    ("local", False, False, True, False),   # locality harassment
    ("rpc", False, True, True, False),      # both harassers over the socket
    ("local", False, False, False, True),   # peer-fabric harassment
    ("rpc", False, True, False, True),      # hostile peers over the socket
]


@pytest.mark.parametrize("transport,cache,harass,locality,peers", TRANSPORT)
def test_cluster_invariant_over_transport(transport, cache, harass, locality,
                                          peers):
    check_cluster_invariant(2, 2, 3, True, 1, transport=transport,
                            cache=cache, harass_renew=harass,
                            harass_locality=locality, harass_peers=peers)


# the reference's test_faults.py chaos runs
@pytest.mark.parametrize("framing", ["binary", "json"])
def test_cluster_invariant_survives_coordinator_restart(framing):
    check_cluster_invariant(5, 2, 3, True, 1, transport="rpc",
                            harass_coordinator=True, framing=framing)


def test_cluster_invariant_survives_network_chaos():
    check_cluster_invariant(4, 2, 3, True, 1, transport="rpc", netchaos=True)


def test_cluster_invariant_survives_restart_under_network_chaos():
    check_cluster_invariant(4, 2, 3, False, 0, transport="rpc",
                            harass_coordinator=True, netchaos=True)


def _cluster_inputs(pkg, root, pipe):
    core = importlib.import_module(f"{pkg}.core")
    dist = importlib.import_module(f"{pkg}.dist")
    m = core.DatasetManifest.scan(root, "same")
    units, _ = core.query_available_work(m, pipe)
    runner = dist.ClusterRunner(pipe, root, nodes=3, cache_dir=root / "c",
                                cache_per_node=True, die_after={"node-2": 1},
                                hb_interval_s=0.1, poll_s=0.02)
    results = runner.run(units)
    assert sorted(r.status for r in results if r.status != "speculative") \
        == ["ok"] * len(units)
    out = {}
    for u in units:
        prov = core.Provenance.load(Path(u.out_dir))
        out[u.job_id] = (prov.status, dict(prov.inputs))
    return out


def test_committed_input_digests_equal_the_reference(tmp_path):
    from repro.core import builtin_pipelines as ref_pipes
    from repro.core import synthesize_dataset
    from repro_torch.core import builtin_pipelines
    ds = synthesize_dataset(tmp_path / "a", "same", n_subjects=3,
                            sessions_per_subject=2, shape=(8, 8, 8))
    shutil.copytree(ds.root, tmp_path / "b")
    ref = _cluster_inputs("repro", Path(ds.root),
                          ref_pipes()["bias_correct"])
    port = _cluster_inputs("repro_torch", tmp_path / "b",
                           builtin_pipelines("cpu")["bias_correct"])
    assert port == ref and len(port) == 6


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_a_whole_process_stall_is_not_read_as_every_node_dead(pkg, tmp_path,
                                                             monkeypatch):
    """F3 (ROADMAP.md, Queue 3), made deterministic. The coordinator loop
    and the nodes' heartbeat threads share one process; a stall of the whole
    process (here: the loop's third sleep lasts 1 s while every heartbeat is
    held) leaves every heartbeat a full TTL old at the loop's next tick. The
    reference reaps on that tick and aborts the run with "all nodes dead";
    the port sees its own oversleep, waits two beats, and finishes."""
    core = importlib.import_module(f"{pkg}.core")
    dist = importlib.import_module(f"{pkg}.dist")
    cluster = importlib.import_module(f"{pkg}.dist.cluster")
    queue = importlib.import_module(f"{pkg}.dist.queue")
    pipe = (core.builtin_pipelines()["bias_correct"] if pkg == "repro"
            else core.builtin_pipelines("cpu")["bias_correct"])
    ds = core.synthesize_dataset(tmp_path, "stall", n_subjects=2,
                                 sessions_per_subject=2, shape=(6, 6, 6))
    units, _ = core.query_available_work(ds, pipe)

    beats = threading.Event()
    beats.set()
    real_heartbeat = queue.WorkQueue.heartbeat

    def heartbeat(self, *args, **kwargs):
        beats.wait()                      # held while the process "stalls"
        return real_heartbeat(self, *args, **kwargs)

    monkeypatch.setattr(queue.WorkQueue, "heartbeat", heartbeat)
    loop = threading.current_thread()
    sleeps = {"n": 0}

    class StallingClock:
        """The cluster module's ``time``: its run loop's third sleep is the
        stall; the one after it lets the heartbeats through again."""

        def __getattr__(self, name):
            return getattr(time, name)

        @staticmethod
        def sleep(s):
            if threading.current_thread() is not loop:
                return time.sleep(s)
            sleeps["n"] += 1
            if sleeps["n"] == 3:
                beats.clear()
                time.sleep(1.0)
                sleeps["pending"] = runner.queue.pending()
                return None
            beats.set()
            return time.sleep(s)

    monkeypatch.setattr(cluster, "time", StallingClock())

    def slow(unit, attempt):
        time.sleep(1.5)                   # keep work in flight past the stall

    runner = dist.ClusterRunner(pipe, ds.root, nodes=3, fault_hook=slow,
                                lease_ttl_s=0.4, hb_interval_s=0.1,
                                straggler_factor=100.0, poll_s=0.02)
    try:
        if pkg == "repro":
            with pytest.raises(RuntimeError, match="all nodes dead"):
                runner.run(units)
        else:
            results = runner.run(units)
    finally:
        beats.set()
    assert sleeps["pending"] > 0          # the stall hit a run in flight
    if pkg == "repro":
        return
    assert sorted(r.status for r in results) == ["ok"] * len(units)
    assert runner.stats.dead_nodes == [] and runner.stats.requeued == []


def test_settings_of_the_socket_slice_raise(tmp_path):
    from repro_torch.core import builtin_pipelines
    from repro_torch.dist import ClusterRunner
    pipe = builtin_pipelines("cpu")["bias_correct"]
    with pytest.raises(ValueError, match="unknown transport"):
        ClusterRunner(pipe, tmp_path, transport="carrier-pigeon")


def test_runner_refuses_to_overwrite_a_journal(tmp_path):
    from repro_torch.core import (builtin_pipelines, query_available_work,
                                  synthesize_dataset)
    from repro_torch.dist import ClusterRunner
    ds = synthesize_dataset(tmp_path, "j", n_subjects=1,
                            sessions_per_subject=2, shape=(6, 6, 6))
    pipe = builtin_pipelines("cpu")["bias_correct"]
    units, _ = query_available_work(ds, pipe)
    ClusterRunner(pipe, ds.root, nodes=2, journal_dir=tmp_path / "wal"
                  ).run(units)
    with pytest.raises(RuntimeError, match="already holds"):
        ClusterRunner(pipe, ds.root, nodes=2, journal_dir=tmp_path / "wal"
                      ).run(units)
    again = ClusterRunner(pipe, ds.root, nodes=2, journal_dir=tmp_path / "wal",
                          journal_overwrite=True).run(units)
    assert [r.status for r in again] == ["skipped"] * len(units)
