"""Coordinator write-ahead journal: crash durability for the WorkQueue.

The queue's state — backlog, leases, DAG gates, result metadata — lives in
one process's memory; before this module, a coordinator restart lost a
whole campaign. A :class:`Journal` makes every mutation durable with three
files in one directory:

* ``units.json`` — the admitted unit list, written once at attach through
  the same :func:`~repro_torch.core.query.units_to_rows` serialization every
  other units artifact uses. Units are immutable after admission, so the
  (potentially huge) list never rides a snapshot again.
* ``state.json`` — a compaction snapshot of the *mutable* state (epochs,
  terminal statuses, live leases, result metadata, node membership) plus
  the journal sequence number it covers. Written atomically
  (tmp + rename), so a crash mid-compaction leaves the previous snapshot
  intact.
* ``wal.log`` — the append-only record stream since the last snapshot.
  Each record is CRC-framed: ``u32be payload length | u32be crc32(payload)
  | JSON payload``, after an 8-byte magic header. Replay verifies every
  CRC and **truncates the torn tail** — a record cut short by the crash
  (or corrupted on disk) ends the trustworthy prefix; everything before it
  is applied, everything after is dropped and counted.

Record payloads carry a monotonically increasing sequence number ``q``.
Compaction stamps the snapshot with the last sequence it covers and then
truncates the WAL; if the process dies *between* those two steps, replay
simply skips WAL records with ``q <= snapshot.seq`` — the crash window is
idempotent by construction, no record is ever applied twice.

Fsync policy (``fsync=``): ``"always"`` fsyncs every append (an
acknowledged grant is durable, WAN-safe), ``"interval"`` fsyncs at most
every ``fsync_interval_s`` seconds (default: bounded loss of the last few
milliseconds of acknowledgements — the epoch/reap machinery absorbs a
re-granted lease, and the atomic provenance commit absorbs a re-run), and
``"never"`` leaves flushing to the OS (tests, throwaway runs).

The queue side lives in :mod:`repro_torch.dist.queue`:
``WorkQueue(journal=...)`` appends a record inside the queue lock for every mutation, and
``WorkQueue.recover(journal)`` rebuilds a queue from snapshot + tail.

CLI::

    python -m repro_torch.dist.journal inspect <journal-dir>

verifies every CRC (read-only — no truncation) and prints a replay
summary: record counts by type, torn/corrupt tail bytes, and the unit
statuses a recovery would start from.
"""
from __future__ import annotations

import json
import os
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

_MAGIC = b"RPROWAL1"
_HEADER = 8                      # per-record framing: u32 len + u32 crc
# one record is a lease grant or a completion report — a few hundred bytes.
# Anything past this is a corrupt length field, and replay must not trust
# the rest of the file either way.
MAX_RECORD_BYTES = 8 << 20

FSYNC_POLICIES = ("always", "interval", "never")


class JournalCorrupt(Exception):
    """The journal cannot be trusted at all (bad magic, unreadable
    snapshot/units) — as opposed to a torn tail, which replay repairs."""


class Journal:
    """One coordinator's durable mutation log (see module docstring).

    Thread-safety: :meth:`append` and :meth:`compact` are called under the
    queue lock, but :meth:`close` may race them from another thread (a
    restart harness fencing off the dead incarnation), so the file handle
    is guarded by its own lock. A closed journal silently drops appends —
    that is the fence: a zombie queue keeps mutating its in-memory state
    harmlessly, but can never corrupt the WAL the new incarnation owns.
    """

    def __init__(self, root, *, fsync: str = "interval",
                 fsync_interval_s: float = 0.05,
                 compact_every: int = 4096, now=None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"unknown fsync policy {fsync!r} "
                             f"(want one of {FSYNC_POLICIES})")
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        self.fsync_interval_s = float(fsync_interval_s)
        self.compact_every = int(compact_every)
        import time as _time
        self._now = now or _time.monotonic
        self._lock = threading.Lock()
        self._closed = False
        self._wal = None                     # opened on first append/replay
        self._seq = 0
        self._since_snapshot = 0
        self._last_fsync = self._now()

    # -- paths --------------------------------------------------------------

    @property
    def units_path(self) -> Path:
        return self.root / "units.json"

    @property
    def state_path(self) -> Path:
        return self.root / "state.json"

    @property
    def wal_path(self) -> Path:
        return self.root / "wal.log"

    def exists(self) -> bool:
        """True when this directory already holds a journal to recover."""
        return self.units_path.exists()

    # -- write side ---------------------------------------------------------

    def _open_wal_locked(self):
        if self._wal is None:
            fresh = not self.wal_path.exists() \
                or self.wal_path.stat().st_size == 0
            self._wal = open(self.wal_path, "ab")
            if fresh:
                self._wal.write(_MAGIC)
                self._wal.flush()

    def _fsync_dir(self) -> None:
        """Durably record a rename in the journal directory itself — on a
        power loss an un-fsynced directory can resurface the rename with
        the *old* (or no) inode behind it. Best-effort where the platform
        can't fsync a directory handle."""
        try:
            fd = os.open(self.root, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    def write_units(self, units) -> None:
        """Persist the admitted unit list (once, at attach). Atomic *and*
        durable like the snapshot: the tmp file is fsynced before the
        rename and the directory after it — a rename that survives a power
        loss while its data doesn't would leave a truncated units.json,
        and replay treats an unreadable units.json as
        :class:`JournalCorrupt` (the intact snapshot and WAL become
        unreachable with it)."""
        from ..core.query import units_to_rows
        tmp = self.units_path.with_name(self.units_path.name + ".tmp")
        with open(tmp, "w") as f:
            f.write(json.dumps(units_to_rows(list(units)), indent=1))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.units_path)
        self._fsync_dir()

    def append(self, rec: Dict[str, Any]) -> None:
        """Frame + append one mutation record; fsync per policy. Dropped
        silently after :meth:`close` (the zombie fence)."""
        with self._lock:
            if self._closed:
                return
            self._open_wal_locked()
            self._seq += 1
            rec = dict(rec, q=self._seq)
            payload = json.dumps(rec, separators=(",", ":")).encode()
            self._wal.write(len(payload).to_bytes(4, "big")
                            + zlib.crc32(payload).to_bytes(4, "big")
                            + payload)
            self._since_snapshot += 1
            if self.fsync == "always":
                self._wal.flush()
                os.fsync(self._wal.fileno())
                self._last_fsync = self._now()
            elif self.fsync == "interval":
                self._wal.flush()
                t = self._now()
                if t - self._last_fsync >= self.fsync_interval_s:
                    os.fsync(self._wal.fileno())
                    self._last_fsync = t
            else:
                self._wal.flush()

    def should_compact(self) -> bool:
        with self._lock:
            return (not self._closed
                    and self._since_snapshot >= self.compact_every)

    def compact(self, state: Dict[str, Any]) -> None:
        """Snapshot the mutable state and reset the WAL. Crash-safe in
        both windows: before the rename the old snapshot+WAL still replay;
        between rename and truncate the WAL's records are all ``q <=
        snapshot.seq`` and replay skips them."""
        with self._lock:
            if self._closed:
                return
            state = dict(state, v=1, seq=self._seq)
            tmp = self.state_path.with_name(self.state_path.name + ".tmp")
            tmp.write_text(json.dumps(state, separators=(",", ":")))
            with open(tmp, "rb") as f:
                os.fsync(f.fileno())
            os.replace(tmp, self.state_path)
            self._fsync_dir()
            if self._wal is not None:
                self._wal.close()
            self._wal = open(self.wal_path, "wb")
            self._wal.write(_MAGIC)
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._since_snapshot = 0
            self._last_fsync = self._now()

    def close(self) -> None:
        """Stop writing, permanently. Safe to call twice, safe to race
        :meth:`append` — the fence a restart harness drops on the dead
        incarnation before recovering the new one."""
        with self._lock:
            self._closed = True
            if self._wal is not None:
                try:
                    self._wal.flush()
                    os.fsync(self._wal.fileno())
                except (OSError, ValueError):
                    pass
                self._wal.close()
                self._wal = None

    # -- read side ----------------------------------------------------------

    def scan_wal(self, *, truncate: bool = False
                 ) -> Tuple[List[dict], int, Optional[str]]:
        """Read the WAL's trustworthy prefix: ``(records, torn_bytes,
        torn_reason)``. A short read, CRC mismatch, oversize length, or
        undecodable payload ends the prefix; with ``truncate=True`` the
        file is cut back to the last good record (recovery), otherwise it
        is left untouched (the read-only ``inspect`` CLI)."""
        if not self.wal_path.exists():
            return [], 0, None
        data = self.wal_path.read_bytes()
        if not data:
            return [], 0, None
        if data[:len(_MAGIC)] != _MAGIC:
            raise JournalCorrupt(
                f"{self.wal_path}: bad magic {data[:len(_MAGIC)]!r}")
        records: List[dict] = []
        off = len(_MAGIC)
        torn_reason = None
        while off < len(data):
            if off + _HEADER > len(data):
                torn_reason = "torn header"
                break
            n = int.from_bytes(data[off:off + 4], "big")
            crc = int.from_bytes(data[off + 4:off + 8], "big")
            if n > MAX_RECORD_BYTES:
                torn_reason = f"length field {n} exceeds cap"
                break
            body = data[off + _HEADER:off + _HEADER + n]
            if len(body) < n:
                torn_reason = "torn payload"
                break
            if zlib.crc32(body) != crc:
                torn_reason = "crc mismatch"
                break
            try:
                rec = json.loads(body)
                if not isinstance(rec, dict):
                    raise ValueError("record must be a JSON object")
            except ValueError:
                torn_reason = "undecodable payload"
                break
            records.append(rec)
            off += _HEADER + n
        torn = len(data) - off
        if torn and truncate:
            with open(self.wal_path, "r+b") as f:
                f.truncate(off)
        return records, torn, torn_reason

    def replay(self, *, truncate: bool = True
               ) -> Tuple[List[dict], Optional[dict], List[dict], int]:
        """Everything recovery needs: ``(unit rows, snapshot state or None,
        tail records with q > snapshot.seq, torn tail bytes)``. Leaves the
        journal positioned for appending (``seq`` continues after the last
        good record)."""
        if not self.exists():
            raise JournalCorrupt(f"{self.root}: no units.json — nothing "
                                 f"was ever journaled here")
        try:
            rows = json.loads(self.units_path.read_text())
        except ValueError as e:
            raise JournalCorrupt(f"{self.units_path}: {e}") from e
        state = None
        if self.state_path.exists():
            try:
                state = json.loads(self.state_path.read_text())
            except ValueError as e:
                raise JournalCorrupt(f"{self.state_path}: {e}") from e
        snap_seq = int(state.get("seq", 0)) if state else 0
        records, _torn, _ = self.scan_wal(truncate=truncate)
        tail = [r for r in records if int(r.get("q", 0)) > snap_seq]
        with self._lock:
            self._seq = max(snap_seq,
                            *(int(r.get("q", 0)) for r in records)) \
                if records else snap_seq
            self._since_snapshot = len(tail)
        return rows, state, tail, _torn


# ---------------------------------------------------------------------------
# CLI: read-only journal inspection for operators
# ---------------------------------------------------------------------------

def _inspect(root: Path) -> int:
    j = Journal(root)
    if not j.exists():
        print(f"{root}: not a journal (no units.json)")
        return 2
    try:
        rows, state, tail, torn = j.replay(truncate=False)
    except JournalCorrupt as e:
        print(f"CORRUPT: {e}")
        print("recovery from this journal is impossible; restart the "
              "campaign from the units file (the work query + provenance "
              "digests skip everything already committed)")
        return 1
    _, _, torn_reason = j.scan_wal(truncate=False)
    snap_seq = int(state.get("seq", 0)) if state else 0
    print(f"journal {root}")
    print(f"  units           : {len(rows)}")
    print(f"  snapshot        : "
          + (f"seq {snap_seq}" if state else "none (WAL only)"))
    print(f"  wal tail records: {len(tail)} (q > {snap_seq})")
    if torn:
        print(f"  torn tail       : {torn} byte(s) dropped ({torn_reason})")
    else:
        print("  torn tail       : none — every CRC verified")
    counts: Dict[str, int] = {}
    for r in tail:
        counts[str(r.get("t"))] = counts.get(str(r.get("t")), 0) + 1
    if counts:
        print("  tail record counts: "
              + ", ".join(f"{t}={n}" for t, n in sorted(counts.items())))
    # the unit statuses a recovery would start from: snapshot terminal
    # statuses + tail completions folded the same way replay folds them
    done: Dict[int, str] = {int(k): str(v)
                            for k, v in (state or {}).get("done", {}).items()}
    leased = {int(le[0]) for le in (state or {}).get("leases", [])}
    for r in tail:
        t = r.get("t")
        if t == "grant":
            leased.add(int(r["i"]))
        elif t == "complete":
            i = int(r["i"])
            if i not in done and r.get("st") in ("ok", "skipped", "failed"):
                done.setdefault(i, str(r["st"]))
                leased.discard(i)
    by_status: Dict[str, int] = {}
    for s in done.values():
        by_status[s] = by_status.get(s, 0) + 1
    pending = len(rows) - len(done)
    print(f"  unit statuses   : "
          + ", ".join(f"{s}={n}" for s, n in sorted(by_status.items()))
          + (", " if by_status else "")
          + f"pending={pending} (of which ~{len(leased - set(done))} "
            f"were leased at the tail)")
    return 0


def _main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="coordinator write-ahead journal tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ins = sub.add_parser(
        "inspect", help="verify CRCs and print a replay summary (read-only)")
    ins.add_argument("path", help="journal directory")
    args = ap.parse_args(argv)
    if args.cmd == "inspect":
        raise SystemExit(_inspect(Path(args.path)))


if __name__ == "__main__":
    _main()
