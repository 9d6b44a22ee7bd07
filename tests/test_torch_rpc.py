"""The port's queue transport (``repro_torch.dist.rpc``) against the JAX
package's: the wire cross-tested under both framings in both directions (a
port client driving a reference server and the other way round, the answers
equal step by step, and the raw response bytes equal), the reference's
transport cases in the port's copy (frame caps, the binary upgrade,
downgrades, reconnects, restart hooks, an idempotent stop), the 64-unit
chaos acceptance with a port worker process, the worker's device rule, and
a stall of the ``serve`` process, which the reference reads as every worker
dead (ROADMAP.md, F3) and the port does not."""
import dataclasses
import importlib
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import pytest

from conftest import wait_until

import repro.core.query as RQ
import repro.dist.cache as RC
import repro.dist.queue as RW
import repro.dist.rpc as RR
import repro_torch.core.query as TQ
import repro_torch.dist.queue as TW
import repro_torch.dist.rpc as TR
from repro_torch.core import (Provenance, builtin_pipelines,
                              query_available_work, synthesize_dataset)
from repro_torch.dist import ClusterRunner, QueueClient, QueueServer, WorkQueue

REPO_ROOT = Path(__file__).resolve().parents[1]
SRC = REPO_ROOT / "src"
SIDES = {"ref": (RQ, RW, RR), "port": (TQ, TW, TR)}
POOL = [f"{i:064x}" for i in range(6)]


def _rows(n):
    rows = []
    for i in range(n):
        digs = {"T1w": POOL[i % len(POOL)]}
        rows.append(dict(
            dataset="ds", subject=f"{i:02d}", session="01", pipeline="p",
            pipeline_digest="pd", inputs={"T1w": f"{i}-T1w.npy"},
            out_dir=f"/out/{i}", input_digests=digs,
            input_bytes={"T1w": 100 * (i + 1)}))
    return rows


def _queue(side, n=6, nodes=(), clock=None, cls=None):
    Q, W, _ = SIDES[side]
    units = [Q.WorkUnit(**r) for r in _rows(n)]
    kw = {} if clock is None else {"now": lambda: clock["now"]}
    return (cls or W.WorkQueue)(units, list(nodes), lease_ttl_s=2.0, **kw)


def _norm(x):
    """A client's answer in one comparable shape, whichever package's
    ``Lease`` / ``WorkUnit`` it decoded into."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, _norm(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {str(k): _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _wire():
    s = RC.DigestSummary()
    for d in POOL[:3]:
        s.add(d)
    return {"v": 1, "full": s.to_wire()}


def _script(c, clock):
    """One scripted session through every method of the surface; returns
    the answers in order."""
    out = []

    def rec(step, value):
        out.append((step, _norm(value)))

    rec("register a", c.register("a", summary=_wire()))
    rec("register b", c.register("b", blob_addr="hb:9"))
    got = c.next_units("a", 3)
    rec("next_units", got)
    leases = [[lease.unit_idx, lease.epoch] for _u, lease in got]
    rec("renew_batch", c.renew_batch("a", leases, summary_delta={
        "v": 1, "add": POOL[3:5], "drop": [POOL[0]]}))
    rec("renew stale", c.renew(leases[0][0], "a", leases[0][1] + 7))
    c.mark_started(leases[0][0])
    rec("speculate", c.speculate(leases[0][0], "b"))
    rec("complete_batch", c.complete_batch(
        [{"idx": i, "node_id": "a", "status": "ok",
          "meta": {"seconds": 0.5, "attempts": 1}} for i, _e in leases[1:]]))
    rec("complete", c.complete(leases[0][0], "a", "ok",
                               meta={"seconds": 0.25}))
    rec("heartbeat", c.heartbeat("b", summary_delta={
        "v": 1, "add": [POOL[1]], "drop": []}, blob_addr="hb:9"))
    rec("put_summary", c.put_summary("b", _wire()))
    rec("locate_blobs", c.locate_blobs(POOL, node_id="a"))
    rec("next_unit", c.next_unit("b"))
    clock["now"] += 10.0                 # every lease past its TTL
    c.heartbeat("a")
    rec("reap", c.reap())
    for name in ("pending", "done_status", "queue_depths", "active_leases",
                 "alive_nodes", "results_snapshot", "stats_snapshot",
                 "summaries_snapshot", "running", "finished"):
        rec(name, getattr(c, name)())
    rec("primary_log", c.primary_log(1))
    rec("steals", c.steals)
    rec("requeues", c.requeues)
    rec("register dead", c.register("b"))
    return out


def _run_script(client_side, server_side, binary):
    clock = {"now": 1000.0}
    srv = SIDES[server_side][2].QueueServer(
        _queue(server_side, clock=clock)).start()
    try:
        c = SIDES[client_side][2].QueueClient(srv.address, binary=binary)
        answers = _script(c, clock)
        framing = c._binary
        c.close()
    finally:
        srv.stop()
    return answers, framing


@pytest.mark.parametrize("framing", ["binary", "json"])
@pytest.mark.parametrize("client,server", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_wire_cross_answers_equal_step_by_step(client, server, framing):
    binary = framing == "binary"
    want, want_framing = _run_script("ref", "ref", binary)
    got, got_framing = _run_script(client, server, binary)
    assert got_framing == want_framing == binary
    assert [s for s, _ in got] == [s for s, _ in want]
    for (step, g), (_, w) in zip(got, want):
        assert g == w, step


def _frame(obj, binary):
    data = json.dumps(obj).encode() if not isinstance(obj, bytes) else obj
    if binary:
        return TR._FRAME_MAGIC + len(data).to_bytes(4, "big") + data
    return data + b"\n"


def _raw_session(side, binary):
    clock = {"now": 1000.0}
    srv = SIDES[side][2].QueueServer(_queue(side, nodes=["a"],
                                            clock=clock)).start()
    requests = [
        {"id": 1, "method": "register", "params": {
            "node_id": "w", "summary": _wire(), "blob_addr": "hw:1"}},
        {"id": 2, "method": "next_units",
         "params": {"node_id": "a", "max_units": 2}},
        {"id": 3, "method": "renew_batch",
         "params": {"node_id": "a", "leases": [[0, 1], [1, 9]]}},
        {"id": 4, "method": "complete_batch", "params": {"completions": [
            {"idx": 0, "node_id": "a", "status": "ok",
             "meta": {"seconds": 0.5}}]}},
        {"id": 5, "method": "locate_blobs",
         "params": {"digests": POOL, "node_id": "a"}},
        {"id": 6, "method": "stats_snapshot"},
        {"id": 7, "method": "shutdown"},
        {"id": 8, "method": "next_unit", "params": {"nonsense": 1}},
        b"not json at all",
        [1, 2, 3],
        {"id": 9, "method": "results_snapshot"},
    ]
    out = bytearray()
    try:
        with socket.create_connection(srv.address, timeout=30) as s:
            f = s.makefile("rb")
            for req in requests:
                s.sendall(_frame(req, binary))
                if binary:
                    head = f.read(5)
                    out += head + f.read(int.from_bytes(head[1:], "big"))
                else:
                    out += f.readline()
            # a length prefix past the cap: one ProtocolError, then EOF
            s.sendall(TR._FRAME_MAGIC
                      + (TR.MAX_FRAME_BYTES + 1).to_bytes(4, "big"))
            out += f.read()
    finally:
        srv.stop()
    return bytes(out)


@pytest.mark.parametrize("framing", ["binary", "json"])
def test_raw_response_bytes_equal_the_reference(framing):
    binary = framing == "binary"
    ref = _raw_session("ref", binary)
    port = _raw_session("port", binary)

    def strip(b):
        # incarnation ids are fresh per server; a binary frame's length
        # prefix is unchanged by the substitution (same width)
        return re.sub(rb'"inc": "[0-9a-f]{12}"', b'"inc": "x"', b)
    assert b'"inc": "' in port
    assert strip(port) == strip(ref)
    assert b"ProtocolError" in port and b"unknown method" in port


# ---------------------------------------------------------------------------
# the reference's transport cases, in the port's copy
# ---------------------------------------------------------------------------

def test_rpc_roundtrip_matches_inprocess_surface():
    q = _queue("port", nodes=["a", "b"])
    with QueueServer(q) as srv:
        c = QueueClient(srv.address)
        unit, lease = c.next_unit("a")
        assert unit.job_id == q.units[lease.unit_idx].job_id
        assert lease.epoch == 1 and not lease.speculative
        c.mark_started(lease.unit_idx)
        assert c.renew(lease.unit_idx, "a", lease.epoch) is True
        twin = c.speculate(lease.unit_idx, "b")
        assert twin is not None and twin.speculative
        c.complete(lease.unit_idx, "a", "ok",
                   meta={"seconds": 0.25, "attempts": 1, "error": None})
        snap = c.results_snapshot()
        assert snap["primaries"][lease.unit_idx]["seconds"] == 0.25
        assert c.done_status() == q.done_status()
        assert c.pending() == len(q.units) - 1
        assert c.queue_depths() == q.queue_depths()
        assert c.active_leases() == q.active_leases()
        assert c.alive_nodes() == q.alive_nodes()
        assert isinstance(c.steals, dict) and isinstance(c.requeues, list)
        c.close()


def test_rpc_unknown_method_and_bad_params_report_not_crash():
    with QueueServer(_queue("port", nodes=["a"])) as srv:
        c = QueueClient(srv.address)
        with pytest.raises(RuntimeError, match="unknown method"):
            c._call("shutdown")
        with pytest.raises(RuntimeError, match="TypeError"):
            c._call("next_unit", nonsense=1)
        assert c.next_unit("a") is not None     # the connection survives
        c.close()


def test_rpc_dropped_connection_raises_connection_error():
    srv = QueueServer(_queue("port", nodes=["a"])).start()
    c = QueueClient(srv.address, reconnect_window_s=1.0)
    assert c.finished() is False
    srv.stop()
    with pytest.raises(ConnectionError):
        for _ in range(10):                      # buffered writes may need >1
            c.heartbeat("a")
            time.sleep(0.05)
    c.close()


def test_oversize_jsonl_request_rejected_then_connection_closed():
    with QueueServer(_queue("port", nodes=["a"])) as srv:
        s = socket.create_connection(srv.address, timeout=30)
        with s:
            s.sendall(b"{" + b"x" * (TR.MAX_FRAME_BYTES + 16))
            f = s.makefile("rb")
            resp = json.loads(f.readline())
            assert resp["ok"] is False and resp["id"] is None
            assert "ProtocolError" in resp["error"]
            assert f.readline() == b""           # server hung up
        c = QueueClient(srv.address)             # the server survives
        assert c.next_unit("a") is not None
        c.close()


def test_oversize_binary_length_prefix_rejected():
    with QueueServer(_queue("port", nodes=["a"])) as srv:
        with socket.create_connection(srv.address, timeout=30) as s:
            n = TR.MAX_FRAME_BYTES + 1
            s.sendall(TR._FRAME_MAGIC + n.to_bytes(4, "big"))
            f = s.makefile("rb")
            assert f.read(1) == TR._FRAME_MAGIC
            rlen = int.from_bytes(f.read(4), "big")
            resp = json.loads(f.read(rlen))
            assert resp["ok"] is False and "ProtocolError" in resp["error"]
            assert f.read(1) == b""              # server hung up


def test_client_poisons_on_oversize_response():
    srv = socket.create_server(("127.0.0.1", 0))
    addr = srv.getsockname()

    def fake_server():
        conn, _ = srv.accept()
        with conn:
            conn.makefile("rb").readline()       # consume the request
            conn.sendall(b"x" * (TR.MAX_FRAME_BYTES + 16))
    t = threading.Thread(target=fake_server, daemon=True)
    t.start()
    c = QueueClient(addr)
    with pytest.raises(ConnectionError, match="exceeds frame cap"):
        c.finished()
    with pytest.raises(ConnectionError, match="is down"):
        c.pending()
    t.join(timeout=30)
    srv.close()


def test_client_upgrades_to_binary_after_first_response():
    q = _queue("port", nodes=["a"])
    with QueueServer(q) as srv:
        c = QueueClient(srv.address)
        assert c._binary is False                # negotiated, never assumed
        assert c.finished() is False             # JSON-lines, sees "bin": 1
        assert c._binary is True
        unit, lease = c.next_unit("a")           # binary-framed round trip
        assert unit.job_id == q.units[lease.unit_idx].job_id
        c.complete(lease.unit_idx, "a", "ok")
        assert c.done_status()[lease.unit_idx] == "ok"
        c.close()


def test_binary_false_pins_client_to_jsonlines():
    with QueueServer(_queue("port", nodes=["a"])) as srv:
        c = QueueClient(srv.address, binary=False)
        for _ in range(3):
            assert c.finished() is False
        assert c._binary is False
        assert c.next_unit("a") is not None
        c.close()


def test_batched_grant_renew_complete_roundtrip():
    q = _queue("port", n=8, nodes=["a"])
    with QueueServer(q) as srv:
        c = QueueClient(srv.address)
        got = c.next_units("a", 5)
        assert len(got) == 5 and c._batched_ok is True
        leases = [[lease.unit_idx, lease.epoch] for _u, lease in got]
        assert c.renew_batch("a", leases) == [True] * 5
        stale = [[leases[0][0], leases[0][1] + 7]] + leases[1:]
        assert c.renew_batch("a", stale) == [False] + [True] * 4
        c.complete_batch([{"idx": i, "node_id": "a", "status": "ok",
                           "meta": {"seconds": 0.5}} for i, _e in leases])
        snap = c.results_snapshot()
        assert all(snap["primaries"][i]["seconds"] == 0.5
                   for i, _e in leases)
        assert len(c.next_units("a", 10_000)) == len(q.units) - 5
        c.close()


@pytest.mark.parametrize("pre_batch", [False, True])
def test_renew_batch_applies_summary_delta_once(pre_batch, monkeypatch):
    """Batched against a new server, and shed to per-op calls against one
    that predates batching: the delta lands exactly once either way."""
    if pre_batch:
        monkeypatch.setattr(TR, "_METHODS", frozenset(
            TR._METHODS - {"next_units", "complete_batch", "renew_batch"}))
    q = _queue("port", nodes=["a"])
    with QueueServer(q) as srv:
        c = QueueClient(srv.address)
        got = c.next_units("a", 4)
        assert len(got) == 4 and c._batched_ok is (not pre_batch)
        leases = [[lease.unit_idx, lease.epoch] for _u, lease in got]
        assert c.renew_batch("a", leases, summary_delta={
            "v": 1, "add": POOL[:2], "drop": []}) == [True] * 4
        c.complete_batch([{"idx": i, "node_id": "a", "status": "ok"}
                          for i, _e in leases])
        assert sum(1 for s in c.done_status().values() if s == "ok") == 4
        c.close()
    for d in POOL[:2]:                           # the delta landed once
        q._summaries["a"].discard(d)
    assert len(q._summaries["a"]) == 0


def test_new_client_downgrades_blob_addr_against_pre_fabric_server():
    class _PreFabricQueue(WorkQueue):
        def register(self, node_id, summary=None):
            return super().register(node_id, summary=summary)

        def heartbeat(self, node_id, summary_delta=None):
            return super().heartbeat(node_id, summary_delta=summary_delta)

    q = _queue("port", cls=_PreFabricQueue)
    with QueueServer(q) as srv:
        c = QueueClient(srv.address)
        assert c.register("w", summary=_wire(), blob_addr="wh:9") is True
        assert c._fabric_ok is False and c._summaries_ok is True
        assert "w" in q.stats_snapshot()["summary_nodes"]
        c.heartbeat("w", blob_addr="wh:9")       # silently bare now
        assert c.next_unit("w") is not None
        c.close()


def test_new_client_downgrades_stepwise_against_ancient_server():
    class _AncientQueue(WorkQueue):
        def register(self, node_id):
            return super().register(node_id)

    with QueueServer(_queue("port", cls=_AncientQueue)) as srv:
        c = QueueClient(srv.address)
        assert c.register("w", summary=_wire(), blob_addr="wh:9") is True
        assert c._fabric_ok is False and c._summaries_ok is False
        assert c.next_unit("w") is not None
        c.close()


def test_locate_blobs_returns_empty_against_pre_fabric_server(monkeypatch):
    monkeypatch.setattr(TR, "_METHODS", TR._METHODS - {"locate_blobs"})
    q = _queue("port", nodes=["a"])
    with QueueServer(q) as srv:
        c = QueueClient(srv.address)
        assert c.locate_blobs(["d" * 64], node_id="a") == {}
        assert c._fabric_ok is False
        assert c.locate_blobs(["d" * 64]) == {}  # no second wire call
        assert c.register("w", blob_addr="wh:1") is True
        assert q.stats_snapshot()["fabric_nodes"] == []
        c.close()


def test_old_worker_is_fabric_invisible_on_new_coordinator():
    q = _queue("port")
    with QueueServer(q) as srv:
        c = QueueClient(srv.address)
        assert c._call("register", node_id="oldw") is True   # old wire
        c._call("heartbeat", node_id="oldw")
        assert q.stats_snapshot()["fabric_nodes"] == []
        assert q.locate_blobs(["d" * 64]) == {}
        assert c.next_unit("oldw") is not None
        c.close()


def test_client_reconnects_across_server_restart_on_same_port():
    srv1 = QueueServer(_queue("port")).start()
    host, port = srv1.address
    c = QueueClient(srv1.address)
    assert c.register("a") is True
    c.next_unit("a")
    srv1.crash()                         # no goodbye frames
    q2 = _queue("port")
    srv2 = QueueServer(q2, host, port).start()
    try:
        # the redial replays the register: the new queue knows "a" already
        assert c.pending() == len(q2.units)
        assert "a" in q2.alive_nodes()
        _u2, l2 = c.next_unit("a")
        c.complete(l2.unit_idx, "a", "ok")
        assert q2.done_status()[l2.unit_idx] == "ok"
        c.close()
    finally:
        srv2.stop()


def test_restart_hook_fires_on_incarnation_change():
    srv1 = QueueServer(_queue("port", nodes=["a"])).start()
    host, port = srv1.address
    c = QueueClient(srv1.address)
    fired = []
    c.add_restart_hook(lambda: fired.append(c._incarnation))
    assert c.finished() is False
    assert fired == []                   # first incarnation is not a restart
    inc1 = c._incarnation
    assert inc1 == srv1.incarnation
    srv1.crash()
    srv2 = QueueServer(_queue("port", nodes=["a"]), host, port).start()
    try:
        c.pending()
        assert fired == [srv2.incarnation] and inc1 != srv2.incarnation
        c.pending()
        assert len(fired) == 1           # once per restart, not per call
        c.close()
    finally:
        srv2.stop()


def test_client_against_pre_incarnation_server():
    with QueueServer(_queue("port", nodes=["a"])) as srv:
        srv._srv.incarnation = None      # the old wire
        c = QueueClient(srv.address)
        fired = []
        c.add_restart_hook(lambda: fired.append(1))
        assert c.finished() is False
        _unit, lease = c.next_unit("a")
        c.complete(lease.unit_idx, "a", "ok")
        assert c.done_status()[lease.unit_idx] == "ok"
        assert c._incarnation is None and fired == []
        c.close()


def test_reconnect_false_preserves_poison_semantics():
    srv = QueueServer(_queue("port", nodes=["a"])).start()
    c = QueueClient(srv.address, reconnect=False)
    assert c.finished() is False
    srv.crash()
    with pytest.raises(ConnectionError):
        c.pending()
    with pytest.raises(ConnectionError, match="is down"):
        c.pending()
    c.close()


def test_reconnect_gives_up_after_window():
    srv = QueueServer(_queue("port", nodes=["a"])).start()
    c = QueueClient(srv.address, reconnect_window_s=0.5, backoff_s=0.05)
    assert c.finished() is False
    srv.crash()                          # nothing ever comes back up
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="gave up"):
        c.pending()
    assert 0.3 <= time.monotonic() - t0 < 10.0
    with pytest.raises(ConnectionError, match="is down"):
        c.pending()                      # window exhausted -> poisoned
    c.close()


def test_server_stop_is_idempotent_and_drains_inflight():
    entered = threading.Event()

    class SlowQueue(WorkQueue):
        def pending(self):
            entered.set()
            time.sleep(0.4)              # a handler mid-call during stop()
            return super().pending()

    q = _queue("port", nodes=["a"], cls=SlowQueue)
    srv = QueueServer(q, drain_s=5.0).start()
    c = QueueClient(srv.address)
    assert c.finished() is False
    res = {}

    def call():
        try:
            res["pending"] = c.pending()
        except ConnectionError as e:
            res["error"] = e
    t = threading.Thread(target=call, daemon=True)
    t.start()
    assert entered.wait(10)              # the call reached the handler
    srv.stop()
    srv.stop()                           # second stop: no-op
    t.join(timeout=10)
    assert res.get("pending") == len(q.units), res
    c.close()
    srv.crash()                          # after stop: still a no-op


def test_summaries_from_queue_dials_an_address():
    from repro_torch.core.campaign import summaries_from_queue
    q = _queue("port", nodes=["n0"])
    q.put_summary("n0", _wire())
    with QueueServer(q) as srv:
        assert summaries_from_queue(srv.addr_str) == q.summaries_snapshot()


# ---------------------------------------------------------------------------
# the cluster over the socket
# ---------------------------------------------------------------------------

@pytest.fixture()
def dataset(tmp_path):
    return synthesize_dataset(tmp_path / "ds", "rpcds", n_subjects=4,
                              sessions_per_subject=2, shape=(10, 10, 10))


def test_cluster_rpc_transport_completes_and_caches(dataset, tmp_path):
    import shutil
    pipe = builtin_pipelines("cpu")["bias_correct"]
    units, _ = query_available_work(dataset, pipe)
    runner = ClusterRunner(pipe, dataset.root, nodes=2, transport="rpc",
                           poll_s=0.03, cache_dir=tmp_path / "host-cache")
    results = runner.run(units)
    assert sum(r.status == "ok" for r in results) == len(units)
    assert runner.stats.cache["misses"] >= 1 and runner.server is not None
    shutil.rmtree(Path(dataset.root) / "derivatives")
    units2, _ = query_available_work(dataset, pipe)
    runner2 = ClusterRunner(pipe, dataset.root, nodes=2, transport="rpc",
                            poll_s=0.03, cache_dir=tmp_path / "host-cache")
    results2 = runner2.run(units2)
    assert sum(r.status == "ok" for r in results2) == len(units2)
    assert any(Provenance.load(Path(u.out_dir)).cache_hit for u in units2)
    assert runner2.stats.cache["hits"] >= 1


def _worker_env(tmp_path, **extra):
    return dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep
                + os.environ.get("PYTHONPATH", ""),
                REPRO_CACHE_DIR=str(tmp_path / "ext-cache"), **extra)


def test_acceptance_64_units_chaos_over_socket_with_worker_process(tmp_path):
    """The reference's acceptance run on the port: 64 units over the socket
    with a port worker process (``--device cpu``) — one local node dies
    mid-run, one unit straggles into a twin — and every unit ends with
    exactly one ok provenance."""
    ds = synthesize_dataset(tmp_path / "ds", "acc-rpc", n_subjects=32,
                            sessions_per_subject=2, shape=(8, 8, 8))
    pipe = builtin_pipelines("cpu")["bias_correct"]
    units, _ = query_available_work(ds, pipe)
    assert len(units) == 64
    slow_id = units[5].job_id
    slept = {"n": 0}
    lock = threading.Lock()

    def chaos(unit, attempt):
        # hold local nodes back (bounded per unit) until the worker process
        # has registered, so it provably commits real work; unit 5
        # straggles once, until anyone commits it
        deadline = time.time() + 1.0
        while time.time() < deadline:
            srv = runner.server
            if srv is not None and "ext-0" in srv.queue.alive_nodes():
                break
            time.sleep(0.05)
        time.sleep(0.01)
        if unit.job_id == slow_id:
            with lock:
                first = slept["n"] == 0
                slept["n"] += 1
            if first:
                wait_until(lambda: 5 in runner.server.queue.done_status(),
                           timeout=30, desc="unit 5 to be committed past "
                                            "the straggling primary")

    runner = ClusterRunner(pipe, ds.root, nodes=2, transport="rpc",
                           fault_hook=chaos, die_after={"node-1": 3},
                           lease_ttl_s=0.6, hb_interval_s=0.1,
                           straggler_factor=2.5, straggler_min_s=0.3,
                           poll_s=0.03, cache_dir=tmp_path / "host-cache")
    got = {}
    t = threading.Thread(target=lambda: got.update(r=runner.run(units)))
    t.start()
    wait_until(lambda: runner.server is not None or not t.is_alive(),
               timeout=30, desc="the coordinator to serve")
    assert runner.server is not None
    worker = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.dist.rpc", "work",
         "--addr", runner.server.addr_str, "--pipeline", "bias_correct",
         "--data-root", str(ds.root), "--node-id", "ext-0",
         "--device", "cpu"],
        env=_worker_env(tmp_path), cwd=REPO_ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    t.join(timeout=300)
    wout, _ = worker.communicate(timeout=60)
    assert not t.is_alive(), "coordinator did not finish"
    results = got["r"]
    assert Counter(r.status for r in results)["ok"] == 64
    ok_ids = [r.unit.job_id for r in results if r.status == "ok"]
    assert len(ok_ids) == len(set(ok_ids))
    provs = [Provenance.load(Path(u.out_dir)) for u in units]
    assert all(p is not None and p.status == "ok"
               and p.pipeline_digest == pipe.digest() for p in provs)
    assert "node-1" in runner.stats.dead_nodes
    assert "ext-0" in runner.stats.remote_nodes, wout
    ext_commits = [p for p in provs if p.node_id == "ext-0"]
    assert len(ext_commits) >= 1, (runner.stats.processed, wout)
    assert runner.stats.processed["ext-0"] >= len(ext_commits)
    assert worker.returncode in (0, 3), wout


def test_worker_without_a_device_needs_cuda(tmp_path):
    """``work`` with no ``--device`` runs on cuda, which must exist: without
    a card it exits non-zero before it dials anything."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.dist.rpc", "work",
         "--addr", "127.0.0.1:9", "--pipeline", "bias_correct",
         "--data-root", str(tmp_path), "--node-id", "w0"],
        env=_worker_env(tmp_path, CUDA_VISIBLE_DEVICES=""), cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr, out.stderr


# ---------------------------------------------------------------------------
# F3 in the serve loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_a_serve_process_stall_is_not_read_as_every_worker_dead(
        pkg, tmp_path, monkeypatch, capsys):
    """F3 (ROADMAP.md, Queue 3) in ``python -m ... rpc serve``, made
    deterministic. A worker holds leases and heartbeats every 0.1 s (TTL
    0.4 s). One tick of the serve loop then stalls 1 s while the server's
    heartbeat handling is held, as a stalled coordinator process holds its
    handler threads. The reference reaps on the tick after the stall and
    loses the worker; the port sees its own oversleep and waits for the
    held heartbeats to land."""
    Q = importlib.import_module(f"{pkg}.core.query")
    W = importlib.import_module(f"{pkg}.dist.queue")
    rpc = importlib.import_module(f"{pkg}.dist.rpc")
    units = [Q.WorkUnit(**r) for r in _rows(4)]
    units_file = tmp_path / "units.json"
    Q.dump_units(units, units_file)

    beats = threading.Event()
    beats.set()
    real_heartbeat = W.WorkQueue.heartbeat

    def heartbeat(self, *args, **kwargs):
        beats.wait()                     # held while the process "stalls"
        return real_heartbeat(self, *args, **kwargs)

    monkeypatch.setattr(W.WorkQueue, "heartbeat", heartbeat)
    servers = []

    class Captured(rpc.QueueServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(rpc, "QueueServer", Captured)
    exit_code = {}

    def serve():
        try:
            rpc._main()
        except SystemExit as e:
            exit_code["rc"] = e.code

    loop = threading.Thread(target=serve, daemon=True)
    real_sleep = time.sleep
    stall = {"armed": threading.Event(), "ticks_after": 0, "done": False}

    def sleep(s):
        if threading.current_thread() is not loop:
            return real_sleep(s)
        if stall["done"]:
            stall["ticks_after"] += 1
            beats.set()
        elif stall["armed"].is_set():
            stall["done"] = True
            beats.clear()
            real_sleep(1.0)
            return None
        return real_sleep(s)

    monkeypatch.setattr(time, "sleep", sleep)
    monkeypatch.setattr(sys, "argv", [
        "rpc", "serve", "--units", str(units_file), "--addr", "127.0.0.1:0",
        "--lease-ttl", "0.4", "--reap-interval", "0.05"])
    loop.start()
    wait_until(lambda: servers, timeout=30, desc="the server")
    srv = servers[0]
    c = rpc.QueueClient(srv.address)
    assert c.register("w0")
    held = [[lease.unit_idx, lease.epoch]
            for _u, lease in c.next_units("w0", len(units))]
    assert len(held) == len(units)
    stop = threading.Event()

    def beat():
        # a node's heartbeat thread: beat, then renew every lease in hand
        while not stop.is_set():
            c.heartbeat("w0")
            c.renew_batch("w0", held)
            stop.wait(0.1)
    hb = threading.Thread(target=beat, daemon=True)
    hb.start()
    try:
        stall["armed"].set()
        # the stall, then 2 s of ticks: four times the port's grace
        wait_until(lambda: stall["ticks_after"] >= 40, timeout=60,
                   desc="40 serve-loop ticks after the stall")
        alive = srv.queue.alive_nodes()
        requeued = list(srv.queue.requeues)
    finally:
        stop.set()
        hb.join(timeout=10)
        beats.set()
    if pkg == "repro":
        assert "w0" not in alive and requeued
    else:
        assert alive == ["w0"] and requeued == []
    # end the run: the worker goes, a second one drains the queue
    q = srv.queue
    q.mark_dead("w0")
    assert q.register("drain")
    while (got := q.next_unit("drain")) is not None:
        q.complete(got[1].unit_idx, "drain", "ok")
    loop.join(timeout=30)
    c.close()
    assert not loop.is_alive() and exit_code["rc"] == 0
    out = capsys.readouterr().out
    assert ("reaped units" in out) == (pkg == "repro")
