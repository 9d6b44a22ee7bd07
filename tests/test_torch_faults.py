"""The port's fault-injection proxy (``repro_torch.dist.faults``): the
reference's proxy cases in the port's copy, between the port's queue client
and server — passthrough by default, drops, duplicates and truncations the
client rides out, partitions that stall and heal, an idempotent stop, and a
dead upstream. The chaos runs of the cluster invariant that use it are in
``test_torch_cluster.py``."""
import threading
import time

import pytest

from repro_torch.core import builtin_pipelines, query_available_work, \
    synthesize_dataset
from repro_torch.dist import ChaosProxy, QueueClient, QueueServer, WorkQueue


@pytest.fixture()
def dataset(tmp_path):
    return synthesize_dataset(tmp_path / "ds", "chds", n_subjects=4,
                              sessions_per_subject=2, shape=(10, 10, 10))


def _queue(dataset):
    pipe = builtin_pipelines("cpu")["bias_correct"]
    units, _ = query_available_work(dataset, pipe)
    return WorkQueue(units, ["a"])


# ---------------------------------------------------------------------------
# the proxy itself
# ---------------------------------------------------------------------------

def test_proxy_is_transparent_by_default(dataset):
    q = _queue(dataset)
    with QueueServer(q) as srv, ChaosProxy(srv.address) as px:
        c = QueueClient(px.address)
        assert c.finished() is False
        unit, lease = c.next_unit("a")
        c.complete(lease.unit_idx, "a", "ok")
        assert c.done_status()[lease.unit_idx] == "ok"
        c.close()
        st = px.stats()
        assert st["conns"] == 1 and st["chunks"] > 0
        assert st["dropped"] == st["duplicated"] == st["truncated"] == 0


def test_client_survives_drops_dups_and_truncates(dataset):
    q = _queue(dataset)
    with QueueServer(q) as srv, \
            ChaosProxy(srv.address, seed=7, drop_rate=0.10, dup_rate=0.05,
                       truncate_rate=0.05, delay_rate=0.10,
                       delay_s=0.005) as px:
        c = QueueClient(px.address, timeout_s=1.0, reconnect_window_s=60.0)
        for _ in range(40):
            c.pending()                  # every call must come back correct
        assert c.pending() == len(q.units)
        c.close()
        st = px.stats()
        assert st["dropped"] + st["duplicated"] + st["truncated"] > 0, \
            f"weather never fired: {st}"


def test_close_mid_frame_forces_clean_redial(dataset):
    q = _queue(dataset)
    # truncate-only weather: every fault is a connection torn mid-frame
    with QueueServer(q) as srv, \
            ChaosProxy(srv.address, seed=3, truncate_rate=0.2) as px:
        c = QueueClient(px.address, timeout_s=1.0, reconnect_window_s=60.0)
        for _ in range(30):
            assert c.finished() is False
        c.close()
        st = px.stats()
        assert st["truncated"] > 0 and st["conns"] > 1


def test_partition_stalls_then_heals(dataset):
    q = _queue(dataset)
    with QueueServer(q) as srv, ChaosProxy(srv.address) as px:
        c = QueueClient(px.address, timeout_s=1.0, reconnect_window_s=60.0)
        assert c.finished() is False
        px.partition(True)
        res = {}

        def call():
            res["pending"] = c.pending()
        t = threading.Thread(target=call, daemon=True)
        t.start()
        time.sleep(0.3)
        assert "pending" not in res      # the network is gone, not erroring
        assert px.stats()["partition_stalls"] >= 1
        px.partition(False)
        t.join(timeout=30)
        assert res.get("pending") == len(q.units)
        c.close()


def test_proxy_stop_is_idempotent(dataset):
    q = _queue(dataset)
    with QueueServer(q) as srv:
        px = ChaosProxy(srv.address).start()
        c = QueueClient(px.address)
        assert c.finished() is False
        px.stop()
        px.stop()
        c.close()


def test_proxy_refuses_nothing_when_upstream_is_down(dataset):
    """Upstream dead (mid-restart): the proxy closes the client connection
    instead of hanging it, so the client's reconnect loop keeps driving."""
    q = _queue(dataset)
    srv = QueueServer(q).start()
    addr = srv.address
    with ChaosProxy(addr) as px:
        c = QueueClient(px.address, timeout_s=1.0, reconnect=False)
        assert c.finished() is False
        srv.crash()
        with pytest.raises(ConnectionError):
            for _ in range(3):
                c.pending()
        c.close()


def test_proxy_between_the_two_packages(dataset):
    """The proxy is protocol-blind: a reference client through the port's
    proxy to the port's server, and the port's client through it to the
    reference's, under the same weather, every answer correct."""
    import repro.dist.queue as RW
    import repro.dist.rpc as RR
    from repro.core import builtin_pipelines as ref_pipes
    from repro.core import query_available_work as ref_query
    units, _ = ref_query(dataset, ref_pipes()["bias_correct"])
    for server, client, q in (
            (QueueServer, RR.QueueClient, _queue(dataset)),
            (RR.QueueServer, QueueClient, RW.WorkQueue(units, ["a"]))):
        with server(q) as srv, \
                ChaosProxy(srv.address, seed=5, dup_rate=0.05,
                           truncate_rate=0.05) as px:
            c = client(px.address, timeout_s=1.0, reconnect_window_s=60.0)
            for _ in range(30):
                assert c.pending() == len(q.units)
            unit, lease = c.next_unit("a")
            c.complete(lease.unit_idx, "a", "ok")
            assert q.done_status() == {lease.unit_idx: "ok"}
            c.close()
            st = px.stats()
            assert st["duplicated"] + st["truncated"] > 0
