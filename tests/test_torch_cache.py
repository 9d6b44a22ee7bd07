"""The port's host input cache against the JAX package's: the digest-summary
wire is byte-equal and each side reads the other's, ``fetch_array`` gives the
same digests, origins and byte counts over a miss / hit / evict script, a
corrupted blob is dropped by the verified hit on both, and the offline
summary harvest writes the same file."""
import json

import numpy as np
import pytest

import repro.dist.cache as RC
import repro_torch.dist.cache as TC


def _wire_bytes(wire):
    return json.dumps(wire, sort_keys=True).encode()


@pytest.mark.parametrize("m,k,n", [(8192, 4, 0), (8192, 4, 50), (64, 2, 40),
                                   (512, 8, 300)])
def test_digest_summary_wire_byte_equal_and_cross_read(m, k, n):
    rng = np.random.default_rng(n)
    digests = [f"{int(x):064x}" for x in rng.integers(0, 2**62, n)]
    rs, ts = RC.DigestSummary(m, k), TC.DigestSummary(m, k)
    for d in digests:
        rs.add(d), ts.add(d)
    for d in digests[: n // 3] + ["never-added"]:
        rs.discard(d), ts.discard(d)
    assert _wire_bytes(ts.to_wire()) == _wire_bytes(rs.to_wire())
    assert len(ts) == len(rs)
    for d in digests + ["x", "y"]:
        assert (d in ts) == (d in rs)
    # each side decodes the other's wire to the same filter
    assert _wire_bytes(TC.DigestSummary.from_wire(rs.to_wire()).to_wire()) \
        == _wire_bytes(rs.to_wire())
    assert _wire_bytes(RC.DigestSummary.from_wire(ts.to_wire()).to_wire()) \
        == _wire_bytes(ts.to_wire())


@pytest.mark.parametrize("wire", [None, "garbage", {"v": 2}, {"v": 1},
                                  {"v": 1, "m": 8, "k": 2, "nz": "x"},
                                  {"v": 1, "m": 8, "k": 2, "nz": [[99, 1]]}])
def test_undecodable_wires_rejected_alike(wire):
    assert TC.DigestSummary.from_wire(wire) is None
    assert RC.DigestSummary.from_wire(wire) is None
    assert TC.SUMMARY_WIRE_VERSION == RC.SUMMARY_WIRE_VERSION == 1


def _sources(tmp_path, n=5, shape=(8, 8, 8)):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        p = tmp_path / "storage" / f"v{i}.npy"
        p.parent.mkdir(parents=True, exist_ok=True)
        np.save(p, rng.standard_normal(shape).astype(np.float32))
        out.append(p)
    return out


SCRIPT = [0, 1, 0, 2, 3, 0, 4, 1, 1, 2, 0, 3]


@pytest.mark.parametrize("stream", ["1", "0"])
def test_fetch_script_origins_digests_and_evictions_equal(tmp_path,
                                                         monkeypatch, stream):
    monkeypatch.setenv("REPRO_STREAM_INGEST", stream)
    src = _sources(tmp_path)
    blob = src[0].stat().st_size
    trace = {}
    for name, C in (("ref", RC), ("port", TC)):
        c = C.InputCache(tmp_path / name, max_bytes=3 * blob)
        seq = []
        for i in SCRIPT:
            arr, digest, origin, nbytes, info = c.fetch_array(src[i])
            seq.append((i, digest, origin, nbytes, info is not None,
                        float(arr.sum())))
        st = c.stats()
        trace[name] = (seq, {k: st[k] for k in (
            "hits", "misses", "evictions", "bytes", "blobs",
            "bytes_from_cache", "bytes_from_storage", "stream_fetches",
            "stream_bytes", "stream_chunks")},
            sorted(p.name for p in (tmp_path / name / "blobs").iterdir()))
    assert trace["port"] == trace["ref"]
    assert trace["port"][1]["evictions"] > 0 and trace["port"][1]["hits"] > 0


def test_verified_hit_drops_a_corrupted_blob(tmp_path):
    src = _sources(tmp_path, n=2)
    for name, C in (("ref", RC), ("port", TC)):
        c = C.InputCache(tmp_path / name)
        _, d0, o0, _, _ = c.fetch_array(src[0])
        blob = tmp_path / name / "blobs" / d0
        blob.write_bytes(b"corrupted on disk" + blob.read_bytes()[17:])
        arr, d1, o1, n1, _ = c.fetch_array(src[0])
        assert (o0, o1) == ("storage", "storage") and d1 == d0
        np.testing.assert_array_equal(arr, np.load(src[0]))
        assert c.stats()["hits"] == 0 and c.stats()["misses"] == 2
        # the re-fetch re-inserted good bytes: the next read is a hit
        assert c.fetch_array(src[0])[2] == "cache"


def test_summary_sync_delta_and_harvest_equal(tmp_path):
    src = _sources(tmp_path, n=4)
    blob = src[0].stat().st_size
    wires = {}
    for name, C in (("ref", RC), ("port", TC)):
        c = C.InputCache(tmp_path / "hosts" / name, max_bytes=2 * blob)
        cur0, full0 = c.summary_sync()
        for p in src:
            c.fetch_array(p)
        cur1, delta = c.summary_delta_since(cur0)
        _, stale = c.summary_delta_since(cur0 - 10_000)   # off the window
        _, full1 = c.summary_sync()
        wires[name] = (full0["full"], full0["digests"], delta["add"],
                       delta["drop"], stale["full"], full1["full"],
                       full1["digests"], cur1 - cur0)
        # harvest a fresh adoption of the persisted dir
        wires[name] += (C.harvest_summary(tmp_path / "hosts" / name),
                        C.harvest_summary(tmp_path / "nothing-here"))
    assert _wire_bytes(wires["port"]) == _wire_bytes(wires["ref"])
    assert wires["port"][3]                           # evictions dropped


def test_summary_files_byte_equal_and_cross_loaded(tmp_path):
    src = _sources(tmp_path, n=3)
    for node, take in (("node-0", src[:2]), ("node-1", src[2:]),
                       ("node-2", [])):
        c = RC.InputCache(tmp_path / "hosts" / node)
        for p in take:
            c.fetch_array(p)
    (tmp_path / "hosts" / "not-a-cache").mkdir()
    r = RC.summaries_from_cache_dirs(tmp_path / "hosts")
    t = TC.summaries_from_cache_dirs(tmp_path / "hosts")
    assert _wire_bytes(t) == _wire_bytes(r)
    assert sorted(t) == ["node-0", "node-1", "node-2"]
    extra = {}
    for name, C in (("ref", RC), ("port", TC)):
        extra[name] = C.DigestSummary()
        extra[name].add("abc")
    rp = RC.save_summary_file(tmp_path / "r.json", {**r, "x": extra["ref"]})
    tp = TC.save_summary_file(tmp_path / "t.json", {**t, "x": extra["port"]})
    assert tp.read_bytes() == rp.read_bytes()
    assert TC.load_summary_file(rp) == RC.load_summary_file(tp)
    (tmp_path / "bad.json").write_text("[1]")
    with pytest.raises(ValueError, match="JSON object"):
        TC.load_summary_file(tmp_path / "bad.json")


def test_put_bytes_write_through_and_read_blob_equal(tmp_path):
    src = _sources(tmp_path, n=2)
    data = src[1].read_bytes()
    out = {}
    for name, C in (("ref", RC), ("port", TC)):
        c = C.InputCache(tmp_path / name, max_bytes=len(data) + 10)
        d = c.put_bytes(data, source=src[1])
        hit = c.fetch_array(src[1])[2]
        big = c.put_bytes(data + data)            # over the whole budget
        out[name] = (d, hit, big, c.read_blob(d) == data,
                     c.read_blob("0" * 64), c.stats()["peer_serves"])
    assert out["port"] == out["ref"]
    assert out["port"][1] == "cache"


def test_cache_from_env_knobs_equal(tmp_path, monkeypatch):
    for env in ({}, {"REPRO_CACHE_DIR": str(tmp_path / "c")},
                {"REPRO_CACHE_DIR": str(tmp_path / "c"),
                 "REPRO_CACHE_MAX_MB": "0"},
                {"REPRO_CACHE_DIR": str(tmp_path / "c"),
                 "REPRO_CACHE_MAX_MB": "1.5"}):
        for k in ("REPRO_CACHE_DIR", "REPRO_CACHE_MAX_MB"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        r, t = RC.cache_from_env(), TC.cache_from_env()
        assert (r is None) == (t is None)
        if t is not None:
            assert (t.root, t.max_bytes) == (r.root, r.max_bytes)


def test_device_qa_fetch_folds_on_the_given_device(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_STREAM_INGEST", "1")
    src = _sources(tmp_path, n=1, shape=(16, 16, 16))
    r = RC.InputCache(tmp_path / "r").fetch_array(src[0], device_qa=True)
    t = TC.InputCache(tmp_path / "t", device="cpu").fetch_array(
        src[0], device_qa=True)
    assert t[1:4] == r[1:4]
    assert t[4]["device_qa"] and r[4]["device_qa"]
    np.testing.assert_array_equal(t[0], r[0])
    # without device_qa no device is asked for: the default (cuda) cache
    # serves a miss on a machine with no card
    plain = TC.InputCache(tmp_path / "d").fetch_array(src[0])
    assert plain[1] == r[1] and plain[4]["device_qa"] is False
