"""The port's peer blob fabric (``repro_torch.dist.blobserve``) against the
JAX package's: a blob's wire byte-equal between the two servers, each
package's fetcher reading the other's server, the reference's cases in the
port's copy (pinned serving, quarantine, every fallback to storage, the
cache's ``"peer"`` origin and counters), and a ``peer_fabric`` cluster run
whose outputs are byte-equal to an in-process run's."""
import hashlib
import io
import json
import shutil
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import repro.dist.blobserve as RB
import repro.dist.cache as RC
import repro_torch.dist.blobserve as TB
import repro_torch.dist.cache as TC
from repro_torch.core import (builtin_pipelines, query_available_work,
                              synthesize_dataset)
from repro_torch.core.provenance import Provenance
from repro_torch.core.workflow import load_unit_inputs
from repro_torch.dist import (BlobServer, ClusterRunner, InputCache,
                              PeerFabric, fetch_blob)
from repro_torch.dist.blobserve import (BlobNotFound, advertised_addr,
                                        parse_blob_addr)

SIDES = {"ref": (RB, RC), "port": (TB, TC)}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return synthesize_dataset(tmp_path_factory.mktemp("ds"), "blobfab",
                              n_subjects=3, sessions_per_subject=2,
                              shape=(6, 6, 6), seed=11)


def _work(dataset):
    pipe = builtin_pipelines("cpu")["bias_correct"]
    units, _ = query_available_work(dataset, pipe)
    return pipe, units


def _npy_bytes(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _seed_blob(cache, data: bytes) -> str:
    digest = hashlib.sha256(data).hexdigest()
    cache._insert_blob(digest, data, None)
    return digest


# ---------------------------------------------------------------------------
# the wire, against the reference
# ---------------------------------------------------------------------------

def _wire_session(side, tmp_path, data):
    B, C = SIDES[side]
    cache = C.InputCache(tmp_path / side)
    digest = _seed_blob(cache, data)
    requests = [{"id": 7, "method": "get", "digest": digest},
                {"id": 8, "method": "get", "digest": "0" * 64},
                {"id": 9, "method": "evil"}, b"not json at all",
                {"id": 10, "method": "get"},
                {"id": 11, "method": "get", "digest": digest}]
    out = bytearray()
    with B.BlobServer(cache) as srv:
        with socket.create_connection(srv.address, timeout=30) as sock:
            f = sock.makefile("rb")
            for req in requests:
                line = req if isinstance(req, bytes) else \
                    json.dumps(req).encode()
                sock.sendall(line + b"\n")
                head = f.readline()
                out += head
                size = json.loads(head).get("size")
                if size:
                    out += f.read(size)
    return bytes(out), cache.stats()


def test_blob_wire_bytes_equal_the_reference(tmp_path):
    data = _npy_bytes(np.arange(300, dtype=np.float32))
    ref, ref_st = _wire_session("ref", tmp_path, data)
    port, port_st = _wire_session("port", tmp_path, data)
    assert port == ref
    assert port.count(data) == 2          # the raw body, never JSON
    assert (port_st["peer_serves"], port_st["bytes_to_peers"]) == \
        (ref_st["peer_serves"], ref_st["bytes_to_peers"]) == (2, 2 * len(data))


@pytest.mark.parametrize("fetcher,server", [("port", "ref"), ("ref", "port")])
def test_fabric_fetches_across_packages(fetcher, server, tmp_path):
    data = _npy_bytes(np.linspace(0, 1, 97, dtype=np.float64))
    cache = SIDES[server][1].InputCache(tmp_path / "serve")
    digest = _seed_blob(cache, data)
    B = SIDES[fetcher][0]
    with SIDES[server][0].BlobServer(cache) as srv:
        fab = B.PeerFabric(lambda ds: {d: [srv.addr_str] for d in ds})
        assert fab.fetch(digest) == (data, srv.addr_str)
        assert fab.fetch("f" * 64) is None
        assert fab.counters()["peer_false_positives"] == 1
        assert B.fetch_blob(srv.addr_str, digest) == data
        fab.close()


# ---------------------------------------------------------------------------
# the reference's cases, in the port's copy
# ---------------------------------------------------------------------------

def test_blob_server_roundtrip_and_404(tmp_path):
    cache = InputCache(tmp_path / "c")
    data = _npy_bytes(np.arange(64, dtype=np.float32))
    digest = _seed_blob(cache, data)
    with BlobServer(cache) as srv:
        assert fetch_blob(srv.addr_str, digest) == data
        with pytest.raises(BlobNotFound):
            fetch_blob(srv.addr_str, "0" * 64)
    st = cache.stats()
    assert st["peer_serves"] == 1 and st["bytes_to_peers"] == len(data)


def test_blob_server_rejects_unknown_method_and_garbage(tmp_path):
    with BlobServer(InputCache(tmp_path / "c")) as srv:
        with socket.create_connection(srv.address) as sock:
            f = sock.makefile("rb")
            sock.sendall(b'{"id": 1, "method": "evil"}\n')
            assert json.loads(f.readline())["ok"] is False
            sock.sendall(b"not json at all\n")
            assert json.loads(f.readline())["ok"] is False


def test_parse_and_advertised_addr():
    assert parse_blob_addr("host:9") == ("host", 9)
    assert parse_blob_addr(":9") == ("0.0.0.0", 9)
    assert advertised_addr(("10.0.0.2", 7)) == "10.0.0.2:7"
    host = advertised_addr(("0.0.0.0", 7))
    assert host.endswith(":7") and not host.startswith("0.0.0.0")
    assert host == RB.advertised_addr(("0.0.0.0", 7))


def test_eviction_never_unlinks_pinned_blob(tmp_path):
    data = _npy_bytes(np.zeros(256, dtype=np.float64))
    size = len(data)
    cache = InputCache(tmp_path / "c", max_bytes=int(size * 1.5))
    pinned = _seed_blob(cache, data)
    with cache.hold(pinned) as ok:
        assert ok
        for i in range(4):
            _seed_blob(cache, _npy_bytes(np.full(256, i + 1, np.float64)))
            assert (cache.blob_dir / pinned).exists()
            assert cache.total_bytes() <= cache.max_bytes
        assert cache.read_blob(pinned) == data
        cache.max_bytes = size // 2
        _seed_blob(cache, _npy_bytes(np.full(256, 77, np.float64)))
        assert (cache.blob_dir / pinned).exists()
        assert cache.total_bytes() > cache.max_bytes   # overshoot, by design
    cache.max_bytes = int(size * 1.5)
    _seed_blob(cache, _npy_bytes(np.full(256, 99, np.float64)))
    assert cache.total_bytes() <= cache.max_bytes
    assert not (cache.blob_dir / pinned).exists()


def test_serving_a_pinned_blob_under_eviction_churn(tmp_path):
    """A blob pinned by a reader survives eviction and is served whole to
    a peer while the churn runs."""
    data = _npy_bytes(np.arange(512, dtype=np.float64))
    cache = InputCache(tmp_path / "c", max_bytes=int(len(data) * 1.5))
    digest = _seed_blob(cache, data)
    got = []
    with cache.hold(digest) as ok, BlobServer(cache) as srv:
        assert ok
        stop = threading.Event()

        def churn():
            i = 0
            while not stop.is_set():
                i += 1
                _seed_blob(cache, _npy_bytes(np.full(256, i, np.float64)))
        t = threading.Thread(target=churn, daemon=True)
        t.start()
        try:
            for _ in range(5):
                got.append(fetch_blob(srv.addr_str, digest))
        finally:
            stop.set()
            t.join(timeout=10)
    assert got == [data] * 5


def test_fabric_fetch_verifies_and_falls_back(tmp_path):
    cache = InputCache(tmp_path / "serve")
    data = _npy_bytes(np.arange(16, dtype=np.float32))
    digest = _seed_blob(cache, data)
    with BlobServer(cache) as srv:
        # first candidate dead, second serves
        fab = PeerFabric(lambda ds: {digest: ["127.0.0.1:1", srv.addr_str]},
                         timeout_s=2.0)
        assert fab.fetch(digest) == (data, srv.addr_str)
        assert fab.counters()["peer_dead"] == 1
        # not found: the peer 404s
        fab2 = PeerFabric(lambda ds: {d: [srv.addr_str] for d in ds})
        assert fab2.fetch("f" * 64) is None
        assert fab2.counters()["peer_false_positives"] == 1
        # digest mismatch: bytes under a name they do not hash to
        fab3 = PeerFabric(lambda ds: {d: [srv.addr_str] for d in ds},
                          timeout_s=2.0)
        wrong = hashlib.sha256(b"other").hexdigest()
        cache._insert_blob(wrong, data, None)
        assert fab3.fetch(wrong) is None
        assert fab3.counters()["peer_digest_mismatches"] == 1
        # self-exclusion: the fetcher's own address is never dialed
        fab4 = PeerFabric(lambda ds: {d: [srv.addr_str] for d in ds},
                          self_addr=srv.addr_str)
        assert fab4.fetch(digest) is None
        for f in (fab, fab2, fab3, fab4):
            f.close()


def test_fabric_disables_itself_on_unknown_method():
    calls = []

    def locate(ds):
        calls.append(ds)
        raise RuntimeError("queue rpc locate_blobs: unknown method")

    fab = PeerFabric(locate)
    assert fab.fetch("d1") is None
    assert fab.fetch("d2") is None               # no second locate
    assert calls == [["d1"]]


def test_fabric_counts_locate_failures():
    def locate(ds):
        raise ConnectionError("coordinator gone")

    fab = PeerFabric(locate)
    assert fab.fetch("d1") is None
    assert fab.counters()["peer_locate_failures"] == 1


@pytest.mark.parametrize("quarantine_s", [0.3, 0])
def test_fabric_quarantine(tmp_path, quarantine_s):
    """A dead peer is skipped for ``quarantine_s`` after its dial fails,
    then probed again; a window of 0 re-dials it on every fetch."""
    cache = InputCache(tmp_path / "serve")
    data = _npy_bytes(np.arange(16, dtype=np.float32))
    digest = _seed_blob(cache, data)
    dead = "127.0.0.1:1"
    with BlobServer(cache) as srv:
        fab = PeerFabric(lambda ds: {d: [dead, srv.addr_str] for d in ds},
                         timeout_s=2.0, quarantine_s=quarantine_s)
        for _ in range(3):
            assert fab.fetch(digest) == (data, srv.addr_str)
        c = fab.counters()
        if quarantine_s:
            assert c["peer_dead"] == 1 and c["peer_quarantine_skips"] == 2
            time.sleep(quarantine_s + 0.05)
            assert fab.fetch(digest) == (data, srv.addr_str)
            c = fab.counters()
            assert c["peer_dead"] == 2 and c["peer_quarantine_skips"] == 2
        else:
            assert c["peer_dead"] == 3 and c["peer_quarantine_skips"] == 0
        fab.close()


# ---------------------------------------------------------------------------
# the cache's peer path
# ---------------------------------------------------------------------------

def _two_caches_one_warm(tmp_path, src_arr):
    warm = InputCache(tmp_path / "warm")
    cold = InputCache(tmp_path / "cold")
    src = tmp_path / "input.npy"
    np.save(src, src_arr)
    _, digest, origin, *_ = warm.fetch_array(src)
    assert origin == "storage"
    return warm, cold, src, digest


def test_fetch_array_peer_origin_and_counters(tmp_path):
    arr = np.arange(128, dtype=np.float64)
    warm, cold, src, digest = _two_caches_one_warm(tmp_path, arr)
    with BlobServer(warm) as srv:
        cold.attach_fabric(PeerFabric(
            lambda ds: {d: [srv.addr_str] for d in ds}))
        got, d2, origin, nbytes, rep = cold.fetch_array(
            src, digest_hint=digest, size_hint=src.stat().st_size)
        assert origin == "peer" and d2 == digest and rep is None
        assert np.array_equal(got, arr)
        st = cold.stats()
        assert st["peer_hits"] == 1 and st["bytes_from_peer"] == nbytes
        assert st["bytes_from_storage"] == 0 and st["misses"] == 1
        assert st["peer_bytes_by_addr"] == {srv.addr_str: nbytes}
        assert st["peer_dead"] == 0          # the fabric's counters merged
        assert warm.stats()["peer_serves"] == 1
        # the peer-fetched blob is now local: the next fetch is a hit
        assert cold.fetch_array(src, digest_hint=digest)[2] == "cache"
        assert warm.fetch_array(src)[1] == digest


def test_fetch_array_peer_path_equals_the_reference(tmp_path):
    """The same warm server, a reference and a port cold cache: the same
    array, digest, origin, byte count and counters."""
    arr = np.arange(200, dtype=np.float32).reshape(10, 20)
    warm, _, src, digest = _two_caches_one_warm(tmp_path, arr)
    out = {}
    with BlobServer(warm) as srv:
        for side, (B, C) in SIDES.items():
            cold = C.InputCache(tmp_path / f"cold-{side}")
            cold.attach_fabric(B.PeerFabric(
                lambda ds: {d: [srv.addr_str] for d in ds}))
            got = cold.fetch_array(src, digest_hint=digest,
                                   size_hint=src.stat().st_size)
            st = cold.stats()
            keys = ("hits", "misses", "peer_hits", "bytes_from_peer",
                    "bytes_from_storage", "peer_bytes_by_addr", "peer_dead",
                    "peer_false_positives", "peer_digest_mismatches")
            out[side] = (got[0].tobytes(), got[1:4],
                         {k: st[k] for k in keys})
            cold.fabric.close()
    assert out["port"] == out["ref"]
    assert out["port"][1][1] == "peer"


def test_fetch_array_falls_back_to_storage_on_dead_peer(tmp_path):
    arr = np.arange(64, dtype=np.float32)
    _, cold, src, digest = _two_caches_one_warm(tmp_path, arr)
    cold.attach_fabric(PeerFabric(
        lambda ds: {d: ["127.0.0.1:1"] for d in ds}, timeout_s=1.0))
    got, d2, origin, *_ = cold.fetch_array(src, digest_hint=digest)
    assert origin == "storage" and d2 == digest
    assert np.array_equal(got, arr)
    st = cold.stats()
    assert st["peer_dead"] == 1 and st["bytes_from_storage"] > 0


def test_fetch_array_falls_back_on_a_corrupted_peer_blob(tmp_path):
    """The peer's blob is corrupted on its disk: the in-flight sha256
    rejects it and the fetch reads storage."""
    arr = np.arange(256, dtype=np.float32)
    warm, cold, src, digest = _two_caches_one_warm(tmp_path, arr)
    blob = warm.blob_dir / digest
    bad = bytearray(blob.read_bytes())
    bad[len(bad) // 2] ^= 0xFF
    blob.write_bytes(bytes(bad))
    with BlobServer(warm) as srv:
        cold.attach_fabric(PeerFabric(
            lambda ds: {d: [srv.addr_str] for d in ds}))
        got, d2, origin, nbytes, _ = cold.fetch_array(src,
                                                      digest_hint=digest)
        assert origin == "storage" and d2 == digest
        assert np.array_equal(got, arr)
        st = cold.stats()
        assert st["peer_digest_mismatches"] == 1
        assert st["bytes_from_storage"] == nbytes and st["peer_hits"] == 0
        cold.fabric.close()


def test_fetch_array_skips_peer_when_source_size_changed(tmp_path):
    arr = np.arange(32, dtype=np.float64)
    warm, cold, src, digest = _two_caches_one_warm(tmp_path, arr)
    stale_size = src.stat().st_size
    np.save(src, np.arange(48, dtype=np.float64))     # rewritten: new size
    with BlobServer(warm) as srv:
        dialed = []

        def locate(ds):
            dialed.append(ds)
            return {d: [srv.addr_str] for d in ds}

        cold.attach_fabric(PeerFabric(locate))
        _got, d2, origin, *_ = cold.fetch_array(src, digest_hint=digest,
                                                size_hint=stale_size)
        assert origin == "storage" and dialed == [] and d2 != digest


def test_load_unit_inputs_stamps_peer_bytes(dataset, tmp_path):
    _pipe, units = _work(dataset)
    warm = InputCache(tmp_path / "warm")
    load_unit_inputs(units[0], dataset.root, cache=warm)
    cold = InputCache(tmp_path / "cold")
    with BlobServer(warm) as srv:
        cold.attach_fabric(PeerFabric(
            lambda ds: {d: [srv.addr_str] for d in ds}))
        _inputs, sums, cache_hit, hit_bytes, peer_bytes, _ = \
            load_unit_inputs(units[0], dataset.root, cache=cold)
        assert cache_hit is False and hit_bytes == 0 and peer_bytes > 0
        assert cold.stats()["bytes_from_storage"] == 0
        _, ref_sums, *_ = load_unit_inputs(units[0], dataset.root)
        assert sums == ref_sums


# ---------------------------------------------------------------------------
# end to end: ClusterRunner(peer_fabric=True)
# ---------------------------------------------------------------------------

def _outputs(units):
    return {u.job_id: {f.name: f.read_bytes()
                       for f in sorted(Path(u.out_dir).glob("*.npy"))}
            for u in units}


def test_cluster_peer_fabric_outputs_equal_an_in_process_run(dataset,
                                                             tmp_path):
    """Warm node-0's cache, then rerun with cold siblings on the fabric:
    every unit ok, peer bytes stamped, fewer storage bytes than the cold
    pass, and outputs byte-equal to a ``transport="local"`` run's."""
    pipe, units = _work(dataset)
    deriv = Path(dataset.root) / "derivatives"
    local = ClusterRunner(pipe, dataset.root, nodes=2, lease_ttl_s=10.0)
    assert all(r.status == "ok" for r in local.run(units))
    want = _outputs(units)
    shutil.rmtree(deriv)
    cache_root = tmp_path / "hostcaches"
    r1 = ClusterRunner(pipe, dataset.root, nodes=1, lease_ttl_s=10.0,
                       cache_dir=cache_root, cache_per_node=True,
                       peer_fabric=True)
    assert all(r.status == "ok" for r in r1.run(units))
    cold_storage = r1.stats.cache["bytes_from_storage"]
    assert cold_storage > 0
    shutil.rmtree(deriv)
    r2 = ClusterRunner(pipe, dataset.root, nodes=3, lease_ttl_s=10.0,
                       cache_dir=cache_root, cache_per_node=True,
                       peer_fabric=True, partition="round_robin")
    res2 = r2.run(units)
    assert sum(r.status == "ok" for r in res2) == len(units)
    totals = r2.stats.cache
    assert totals["bytes_from_peer"] > 0 and totals["peer_hits"] > 0
    assert totals["bytes_from_storage"] < cold_storage
    assert r2.stats.peer_links and r2.stats.fabric["locates"] > 0
    peer_stamped = 0
    for u in units:
        prov = Provenance.load(Path(u.out_dir))
        assert prov is not None and prov.status == "ok"
        assert prov.inputs == {u.inputs["T1w"]: u.input_digests["T1w"]}
        peer_stamped += bool(prov.peer_fetch)
        if prov.peer_fetch:
            assert prov.bytes_from_peer > 0
    assert peer_stamped > 0
    assert sum(r.bytes_from_peer for r in res2) > 0
    assert _outputs(units) == want


def test_cluster_peer_fabric_requires_per_node_caches(dataset):
    pipe, _ = _work(dataset)
    with pytest.raises(ValueError, match="peer_fabric"):
        ClusterRunner(pipe, dataset.root, peer_fabric=True)
