"""The distributed-executor safety invariant of ``cluster_invariant.py``, run
on the port's cluster (``repro_torch.dist``, in process or over the socket
transport) with ``bias_correct`` on the CPU: every unit ends with exactly
one committed ok provenance, a concurrent reader never sees a partial output
file or a torn provenance, and — with the host cache on — the committed
input digests equal the manifest's, whichever link (cache, peer, storage)
served them. The reference body's hostile peers, coordinator restarts and
network chaos run here too."""
import itertools
import json
import tempfile
import threading
import time
from pathlib import Path

import numpy as np


def dag_closure(edges, start):
    """Transitive descendants of ``start`` under ``{child: [parents]}``."""
    out, frontier = set(), {start}
    while frontier:
        frontier = {c for c, ps in edges.items()
                    if c not in out and frontier.intersection(ps)}
        out |= frontier
    return out


def check_cluster_invariant(n_subjects: int, sessions: int, nodes: int,
                            flaky: bool, die: int, *,
                            transport: str = "local", cache: bool = False,
                            cache_per_node: bool = False,
                            journal: bool = False, plan: bool = False,
                            harass_renew: bool = False,
                            harass_locality: bool = False,
                            harass_peers: bool = False,
                            harass_coordinator: bool = False,
                            netchaos: bool = False,
                            framing: str = "binary",
                            dag_edges=None, fail_idx=None):
    """For the given unit list / node count / injected failures: every unit
    must end with exactly one committed ok provenance, and a concurrent
    reader must never observe a partial output file or torn provenance.
    Returns ``{job_id: committed provenance inputs}``.

    ``cache=True`` serves inputs through host :class:`InputCache` s (one per
    node with ``cache_per_node``); ``journal=True`` journals every queue
    mutation and checks that a queue recovered from the journal holds every
    unit retired; ``plan=True`` seeds the queue from a campaign plan over
    the per-node cache summaries of a warm-up pass. ``harass_renew`` floods
    the queue with stale renewals; ``harass_locality`` with hostile digest
    summaries. ``dag_edges`` / ``fail_idx`` extend the invariant to DAGs as
    in the reference's body: children start after their parents commit, a
    poisoned unit ends ``failed`` and its descendants ``blocked``.

    As in the reference's body: ``transport="rpc"`` runs the schedule over
    the socket transport; ``harass_peers`` runs the peer blob fabric (per
    node caches and blob servers) against ghost peers at dead addresses,
    bogus summary digests and blob bodies corrupted on disk mid-run, every
    failure falling back to storage; ``harass_coordinator`` (rpc) journals
    the queue and crashes and recovers the coordinator twice mid-run;
    ``netchaos`` (rpc) puts a ``ChaosProxy`` between every client and the
    coordinator and asserts its faults fired; ``framing`` pins the wire
    (``"binary"`` negotiates frames, ``"json"`` forbids the upgrade)."""
    from repro_torch.core import (Provenance, builtin_pipelines,
                                  query_available_work, synthesize_dataset)
    from repro_torch.core.campaign import Cohort, plan_campaign
    from repro_torch.dist import ClusterRunner, InputCache, WorkQueue
    from repro_torch.dist.cache import summaries_from_cache_dirs
    from repro_torch.dist.journal import Journal

    with tempfile.TemporaryDirectory() as td:
        ds = synthesize_dataset(Path(td), "prop", n_subjects=n_subjects,
                                sessions_per_subject=sessions, shape=(6, 6, 6),
                                seed=n_subjects * 10 + sessions)
        pipe = builtin_pipelines("cpu")["bias_correct"]
        units, _ = query_available_work(ds, pipe)
        deriv = Path(ds.root) / "derivatives"

        dag_edges = {c: sorted({p for p in ps if 0 <= p < c})
                     for c, ps in (dag_edges or {}).items()
                     if 0 < c < len(units)}
        dag_edges = {c: ps for c, ps in dag_edges.items() if ps}
        for c, ps in dag_edges.items():
            units[c].depends_on = [units[p].job_id for p in ps]
        if fail_idx is not None and units:
            fail_idx %= len(units)
        fail_job = units[fail_idx].job_id if fail_idx is not None else None
        blocked = dag_closure(dag_edges, fail_idx) \
            if fail_idx is not None else set()
        runnable = [i for i in range(len(units))
                    if i not in blocked and i != fail_idx]

        use_cache = (cache or cache_per_node or harass_locality or plan
                     or harass_peers)
        per_node = cache_per_node or harass_locality or plan or harass_peers
        cache_root = Path(td) / "host-cache"
        campaign = None
        if plan:
            # warm node-0's cache with the first half of the inputs, then
            # plan the campaign from the harvested summaries
            warm = InputCache(cache_root / "node-0")
            for u in units[: max(1, len(units) // 2)]:
                for rel in u.inputs.values():
                    warm.fetch_array(Path(ds.root) / rel)
            campaign = plan_campaign(
                [Cohort(ds.name, pipe.name, pipe.digest(), units, [])],
                summaries_from_cache_dirs(cache_root))

        violations = []
        stop = threading.Event()

        def watcher():
            while not stop.is_set():
                for p in list(deriv.rglob("*")) if deriv.exists() else []:
                    try:
                        if p.name == "provenance.json":
                            json.loads(p.read_text())
                        elif p.suffix == ".npy":
                            np.load(p, allow_pickle=False)
                    except FileNotFoundError:
                        pass               # completed+renamed mid-scan: fine
                    except Exception as e:  # noqa: BLE001
                        violations.append(f"{p}: {type(e).__name__}: {e}")

        def fault(unit, attempt):
            if fail_job is not None and unit.job_id == fail_job:
                raise RuntimeError("permanent injected failure")
            if flaky and attempt == 1:
                raise RuntimeError("transient")

        if harass_coordinator or netchaos:
            assert transport == "rpc", \
                "coordinator/network chaos needs the socket transport"
        client_kwargs = {}
        if framing == "json":
            client_kwargs["binary"] = False
        elif framing != "binary":
            raise ValueError(f"unknown framing {framing!r}")
        if netchaos:
            # dropped chunks stall a call until the socket timeout: keep it
            # short so the reconnect loop (not the test timeout) pays for it
            client_kwargs.update(timeout_s=1.0, reconnect_window_s=60.0)
        if harass_coordinator:
            client_kwargs.setdefault("reconnect_window_s", 60.0)
        proxy_box = {}
        proxy_lock = threading.Lock()

        def client_dial(upstream):
            # one proxy for the whole run, built on first dial (the server
            # address is only known once run() serves); the coordinator
            # restarts on the *same* port, so the upstream stays valid
            with proxy_lock:
                if "proxy" not in proxy_box:
                    from repro_torch.dist.faults import ChaosProxy
                    proxy_box["proxy"] = ChaosProxy(
                        upstream, seed=die * 31 + nodes,
                        drop_rate=0.02, delay_rate=0.05, delay_s=0.01,
                        dup_rate=0.02, truncate_rate=0.02).start()
                return proxy_box["proxy"].address

        die_after = {f"node-{die % nodes}": 1} if nodes > 1 else {}
        w = threading.Thread(target=watcher, daemon=True)
        w.start()
        journal_dir = Path(td) / "journal"
        runner = ClusterRunner(
            pipe, ds.root, nodes=nodes, fault_hook=fault, die_after=die_after,
            # restart + reconnect take real wall time: chaos modes widen the
            # lease ttl as the reference's body does (netchaos: a dropped
            # chunk silences a healthy node for a socket timeout + redial)
            lease_ttl_s=(5.0 if netchaos
                         else 1.5 if harass_coordinator else 0.4),
            hb_interval_s=0.1, straggler_factor=100.0,
            poll_s=0.02, transport=transport,
            cache_dir=cache_root if use_cache else None,
            cache_per_node=per_node, peer_fabric=harass_peers, plan=campaign,
            partition="backlog" if harass_locality else "round_robin",
            journal_dir=(journal_dir if journal or harass_coordinator
                         else None),
            client_kwargs=client_kwargs or None,
            client_dial=client_dial if netchaos else None)

        wrongly_renewed = []

        def harasser():
            for i in itertools.count():
                if stop.is_set():
                    return
                q = runner.queue
                if q is not None and units:
                    if q.renew(i % len(units), f"node-{i % nodes}",
                               1000 + (i % 3)):
                        wrongly_renewed.append((i % len(units), 1000 + (i % 3)))

        def locality_harasser():
            wires = [
                {"v": 999, "full": {"m": 8, "k": 2, "n": 1, "nz": [[0, 1]]}},
                "garbage", {"v": 1}, {"v": 1, "full": "nope"},
                {"v": 1, "add": None, "drop": None},
            ]
            for i in itertools.count():
                if stop.is_set():
                    return
                q = runner.queue
                if q is None:
                    continue
                node = f"node-{i % (nodes + 2)}"
                if i % 3 == 0:
                    q.put_summary(node, wires[i % len(wires)])
                elif i % 3 == 1:
                    q.heartbeat(f"ghost-{i % 5}", summary_delta={
                        "v": 1, "add": [f"bogus-{i % 7}"],
                        "drop": [f"bogus-{(i + 3) % 7}"],
                        "stats": {"hits": i, "misses": -i}})
                else:
                    q.renew(i % max(1, len(units)), node, 1_000_000,
                            summary_delta={"v": 1, "add": [f"x{i % 5}"],
                                           "drop": []})

        def peer_harasser():
            # hostile peer-fabric traffic, every flavour of lying peer:
            # ghosts advertising unreachable blob addrs with a summary whose
            # every Bloom cell is hot (claims ALL digests -> locate routes
            # fetches at a dead address -> connection error -> storage
            # fallback); real summaries flooded with bogus digests (404s /
            # false positives); and blob bodies corrupted on disk mid-run
            # (digest mismatch when served to a peer, verified-miss when hit
            # locally). None of it may disturb retirement or output bytes.
            claims_everything = {"v": 1, "full": {
                "m": 8, "k": 2, "n": 4, "nz": [[i, 9] for i in range(8)]}}
            for i in itertools.count():
                if stop.is_set():
                    return
                q = runner.queue
                if q is None:
                    continue
                if i % 3 == 0:
                    # ghost peer at a port nothing listens on; it never
                    # heartbeats again, so the reaper collects it in one ttl
                    q.register(f"liar-{i % 4}", summary=claims_everything,
                               blob_addr=f"127.0.0.1:{1 + i % 3}")
                elif i % 3 == 1:
                    q.put_summary(f"node-{i % nodes}", {
                        "v": 1, "add": [f"bogus-{i % 11}"], "drop": [],
                        "stats": {}})
                else:
                    for blob in (list(cache_root.rglob("blobs/*"))
                                 if cache_root.exists() else [])[:2]:
                        if blob.name.startswith("."):
                            continue           # in-flight atomic-write tmps
                        try:
                            blob.write_bytes(b"corrupted mid-run")
                        except OSError:
                            pass               # evicted under us: fine

        coordinator_restarts = []

        def coordinator_harasser():
            # kill + recover the coordinator twice, at different progress
            # points, so recovery is exercised both nearly-cold and
            # mostly-done; a None from restart_coordinator means the run
            # beat us to shutdown — fine, the restart count is asserted
            # only to be >= 1 below
            targets = [max(1, len(units) // 4), max(2, len(units) // 2)]
            for want_done in targets:
                deadline = time.monotonic() + 30
                while not stop.is_set() and time.monotonic() < deadline:
                    q = runner.queue
                    if (q is not None and runner.server is not None
                            and len(q.done_status()) >= want_done):
                        break
                    time.sleep(0.02)
                if stop.is_set():
                    return
                info = runner.restart_coordinator()
                if info is not None:
                    coordinator_restarts.append(info)
                time.sleep(0.3)      # let reconnects land before round two

        threads = []
        if harass_coordinator:
            threads.append(threading.Thread(target=coordinator_harasser,
                                            daemon=True))
        if harass_peers:
            threads.append(threading.Thread(target=peer_harasser,
                                            daemon=True))
        if harass_renew:
            threads.append(threading.Thread(target=harasser, daemon=True))
        if harass_locality:
            threads.append(threading.Thread(target=locality_harasser,
                                            daemon=True))
        for t in threads:
            t.start()
        try:
            results = runner.run(units)
        finally:
            stop.set()
            w.join(timeout=5)
            for t in threads:
                t.join(timeout=5)
            if "proxy" in proxy_box:
                proxy_box["proxy"].stop()
        if harass_coordinator:
            # a chaos run that never injected its chaos fails loudly
            assert coordinator_restarts, "coordinator was never restarted"
            assert all(r["total_s"] >= r["recover_s"] >= 0
                       for r in coordinator_restarts)
        if netchaos:
            st = proxy_box["proxy"].stats()
            assert st["chunks"] > 0, "no traffic crossed the chaos proxy"
            assert (st["dropped"] + st["delayed"] + st["duplicated"]
                    + st["truncated"]) > 0, f"no faults fired: {st}"
        if transport == "rpc":
            assert runner.server is not None
        if harass_peers:
            assert runner.stats.fabric is not None
        assert wrongly_renewed == []
        assert violations == []
        assert sum(r.status == "ok" for r in results) == len(runnable)
        ok_ids = [r.unit.job_id for r in results if r.status == "ok"]
        assert len(ok_ids) == len(set(ok_ids))
        assert set(ok_ids) == {units[i].job_id for i in runnable}
        provs = {}
        for i in runnable:
            u = units[i]
            prov = Provenance.load(Path(u.out_dir))
            assert prov is not None and prov.status == "ok"
            assert prov.pipeline_digest == pipe.digest()
            provs[i] = prov
            if use_cache:
                for suffix, rel in u.inputs.items():
                    want = (u.input_digests or {}).get(suffix)
                    if want:
                        assert prov.inputs[rel] == want
        for c, ps in dag_edges.items():
            if c not in provs:
                continue
            for p in ps:
                assert provs[c].started_at >= provs[p].finished_at - 1e-6, \
                    (f"unit {c} started at {provs[c].started_at} before "
                     f"parent {p} committed at {provs[p].finished_at}")
        if fail_idx is not None:
            status_by_id = {}
            for r in results:
                if r.status != "speculative":
                    status_by_id.setdefault(r.unit.job_id, r.status)
            assert status_by_id[fail_job] == "failed"
            fprov = Provenance.load(Path(units[fail_idx].out_dir))
            assert fprov is not None and fprov.status == "failed"
            for b in sorted(blocked):
                bu = units[b]
                assert status_by_id[bu.job_id] == "blocked"
                bdir = Path(bu.out_dir)
                assert Provenance.load(bdir) is None
                assert not bdir.exists() or not any(bdir.iterdir())
        if dag_edges or fail_idx is not None:
            dag_stats = runner.queue.stats_snapshot()["dag"]
            assert dag_stats["cancelled"] == len(blocked)
            assert dag_stats["blocked"] == 0
            assert dag_stats["ready"] == 0
        if journal or harass_coordinator:
            # the journal alone rebuilds a queue with every unit retired
            # (after restarts: the last incarnation's journal)
            q = WorkQueue.recover(Journal(journal_dir))
            assert q.finished() and len(q.done_status()) == len(units)
            assert {units[i].job_id for i, s in q.done_status().items()
                    if s == "ok"} == {units[i].job_id for i in runnable}
            q._journal.close()
        if plan:
            # the units the campaign placed warm ran off node-0's cache
            warm_ids = {j for s in campaign.shards if s.node_id
                        for j in s.unit_ids}
            assert warm_ids
            assert any(provs[i].bytes_from_cache > 0 for i in runnable
                       if units[i].job_id in warm_ids)
        assert not list(deriv.rglob("*.tmp-*"))      # all commits atomic
        return {units[i].job_id: dict(provs[i].inputs) for i in runnable}
