"""The port's coordinator write-ahead journal against the JAX package's: the
same record sequence gives the same ``units.json``, ``wal.log`` and
``state.json`` bytes, each side replays what the other wrote, torn and
corrupt tails end the trusted prefix at the same record, and a queue
recovered from either journal holds the same state."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core.query as RQ
import repro.dist.journal as RJ
import repro.dist.queue as RW
import repro_torch.core.query as TQ
import repro_torch.dist.journal as TJ
import repro_torch.dist.queue as TW

SRC = Path(__file__).resolve().parents[1] / "src"
SIDES = {"ref": (RQ, RJ, RW), "port": (TQ, TJ, TW)}


def _rows(n=5):
    return [dict(dataset="ds", subject=f"{i:02d}", session="01",
                 pipeline="p", pipeline_digest="pd",
                 inputs={"T1w": f"sub-{i:02d}/ses-01/anat/t1.npy"},
                 out_dir=f"/out/{i}",
                 input_digests={"T1w": f"{i:064x}"},
                 input_bytes={"T1w": 1000 + i},
                 depends_on=(["ds_p_sub-00_ses-01"] if i == 3 else []))
            for i in range(n)]


RECORDS = [
    {"t": "register", "n": "node-0"},
    {"t": "register", "n": "node-1", "b": "127.0.0.1:7000"},
    {"t": "grant", "i": 0, "n": "node-0", "e": 1, "lb": 1000},
    {"t": "grant", "i": 1, "n": "node-1", "e": 1, "lb": 0, "s": 1},
    {"t": "renew", "n": "node-0", "i": 0, "e": 1},
    {"t": "complete", "i": 0, "n": "node-0", "st": "ok",
     "m": {"seconds": 0.25, "attempts": 1, "error": None,
           "bytes_from_cache": 1000, "bytes_from_peer": 0,
           "locality_score": 1.0}},
    {"t": "expire", "i": 1, "s": 1},
    {"t": "dead", "n": "node-1"},
    {"t": "complete", "i": 2, "n": "node-0", "st": "failed",
     "m": {"note": "ünïcode", "nested": [1, 2.5, None]}},
]


def _write(side, root, records=RECORDS, compact_at=None):
    Q, J, _ = SIDES[side]
    j = J.Journal(root, fsync="never")
    j.write_units([Q.WorkUnit(**r) for r in _rows()])
    for k, rec in enumerate(records):
        if compact_at is not None and k == compact_at:
            j.compact({"nodes": ["node-0"], "done": {"0": "ok"}})
        j.append(rec)
    j.close()
    return j


def _files(root):
    return {p.name: p.read_bytes() for p in sorted(Path(root).iterdir())}


@pytest.mark.parametrize("compact_at", [None, 0, 4])
def test_journal_files_byte_identical(tmp_path, compact_at):
    _write("ref", tmp_path / "r", compact_at=compact_at)
    _write("port", tmp_path / "t", compact_at=compact_at)
    assert _files(tmp_path / "t") == _files(tmp_path / "r")


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_side_replays_the_others_journal(tmp_path, writer, reader):
    _write(writer, tmp_path, compact_at=4)
    got = SIDES[reader][1].Journal(tmp_path).replay(truncate=False)
    want = SIDES[writer][1].Journal(tmp_path).replay(truncate=False)
    assert got == want
    rows, state, tail, torn = got
    assert len(rows) == 5 and state["seq"] == 4 and torn == 0
    assert [r["q"] for r in tail] == list(range(5, 10))


def _tear(path, how):
    data = bytearray(path.read_bytes())
    if how == "torn_payload":
        del data[-5:]
    elif how == "torn_header":
        data += b"\x00\x00\x00"
    elif how == "crc":                    # flip a byte inside the 4th record
        off = 8
        for _ in range(3):
            off += 8 + int.from_bytes(data[off:off + 4], "big")
        data[off + 8 + 2] ^= 0x41
    elif how == "oversize":
        data += (1 << 30).to_bytes(4, "big") + b"\x00" * 12
    elif how == "not_json":
        import zlib
        body = b"[1, 2, 3]"
        data += len(body).to_bytes(4, "big") + \
            zlib.crc32(body).to_bytes(4, "big") + body
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("how", ["torn_payload", "torn_header", "crc",
                                 "oversize", "not_json"])
def test_torn_and_corrupt_tails_end_the_prefix_alike(tmp_path, how):
    for side in SIDES:
        _write(side, tmp_path / side)
        _tear(tmp_path / side / "wal.log", how)
    scans = {side: SIDES[side][1].Journal(tmp_path / side).scan_wal()
             for side in SIDES}
    assert scans["port"] == scans["ref"]
    assert scans["port"][1] > 0 and scans["port"][2]
    # recovery truncates both files back to the same trusted prefix
    for side in SIDES:
        SIDES[side][1].Journal(tmp_path / side).replay(truncate=True)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


def test_bad_magic_is_corrupt_on_both(tmp_path):
    for side in SIDES:
        _write(side, tmp_path / side)
        wal = tmp_path / side / "wal.log"
        wal.write_bytes(b"NOTAWAL!" + wal.read_bytes()[8:])
        with pytest.raises(SIDES[side][1].JournalCorrupt, match="bad magic"):
            SIDES[side][1].Journal(tmp_path / side).replay()


def _queue_script(side, root):
    """One scripted run of a journaled queue on a fake clock."""
    Q, J, W = SIDES[side]
    t = [1000.0]
    units = [Q.WorkUnit(**r) for r in _rows()]
    q = W.WorkQueue(units, ["node-0", "node-1"], lease_ttl_s=1.0,
                    now=lambda: t[0], journal=J.Journal(root, fsync="never"))
    grants = [(lease.unit_idx, lease.node_id, lease.epoch)
              for _, lease in q.next_units("node-0", 2)]
    q.complete(grants[0][0], "node-0", "ok", meta={"seconds": 1.0})
    grants += [(lease.unit_idx, lease.node_id, lease.epoch)
               for _, lease in q.next_units("node-1", 2)]
    q.heartbeat("node-0")
    t[0] += 2.0
    q.heartbeat("node-0")
    q.reap()                          # node-1 dead: its leases requeue
    q._journal.close()
    return grants, q


def test_recovered_queues_hold_the_same_state(tmp_path):
    out = {}
    for side in SIDES:
        grants, q = _queue_script(side, tmp_path / side)
        _, J, W = SIDES[side]
        r = W.WorkQueue.recover(J.Journal(tmp_path / side, fsync="never"),
                                lease_ttl_s=1.0, now=lambda: 5000.0)
        out[side] = (grants, r.done_status(), r.alive_nodes(),
                     r.results_snapshot(), sorted(r.requeues),
                     r.pending(), r.active_leases())
        r._journal.close()
    assert out["port"] == out["ref"]
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


def test_inspect_cli_prints_the_same_summary(tmp_path):
    _write("ref", tmp_path / "r", compact_at=4)
    _write("port", tmp_path / "t", compact_at=4)
    outs = []
    for mod, root in (("repro.dist.journal", "r"),
                      ("repro_torch.dist.journal", "t")):
        p = subprocess.run([sys.executable, "-m", mod, "inspect",
                            str(tmp_path / root)],
                           capture_output=True, text=True, timeout=120,
                           env={**os.environ, "PYTHONPATH": str(SRC),
                                "JAX_PLATFORMS": "cpu"})
        assert p.returncode == 0, p.stderr
        outs.append(p.stdout.replace(str(tmp_path / root), "<dir>"))
    assert outs[1] == outs[0]
    assert "every CRC verified" in outs[1]
