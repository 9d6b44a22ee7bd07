"""Deterministic, resumable, integrity-checked data pipeline: a copy of
``repro/data/pipeline.py`` wired to the port's ``core.integrity`` (the same
fletcher64), so one seed gives the same shard bytes, manifest and batches.
Batches stay numpy; the train step moves them to its device.

The paper's data plane applied to training: data lives as checksummed shard
files in a manifest; the loader's *query* is "which (epoch, step) batches has
this run not consumed" — exactly-once, restart-safe. A background prefetch
thread double-buffers host->device transfers (compute never waits on I/O),
and every shard read is checksum-verified (corrupted storage fails loudly,
as in the paper's transfer protocol).
"""
from __future__ import annotations

import dataclasses
import json
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..core.integrity import IntegrityError, fletcher64


@dataclasses.dataclass
class ShardInfo:
    path: str
    n_tokens: int
    fletcher64: int


class ShardedTokenSource:
    """Token shards on disk with a manifest; deterministic global order."""

    MANIFEST = "shards.json"

    def __init__(self, root: Path):
        self.root = Path(root)
        m = json.loads((self.root / self.MANIFEST).read_text())
        self.shards = [ShardInfo(**s) for s in m["shards"]]
        self.vocab_size = m["vocab_size"]

    @classmethod
    def synthesize(cls, root: Path, *, n_shards: int = 4, tokens_per_shard: int = 65536,
                   vocab_size: int = 512, seed: int = 0) -> "ShardedTokenSource":
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        rng = np.random.default_rng(seed)
        shards = []
        for i in range(n_shards):
            toks = rng.integers(0, vocab_size, tokens_per_shard, dtype=np.int32)
            p = root / f"shard_{i:05d}.npy"
            np.save(p, toks)
            shards.append(ShardInfo(path=p.name, n_tokens=int(toks.size),
                                    fletcher64=fletcher64(toks)))
        (root / cls.MANIFEST).write_text(json.dumps(
            {"vocab_size": vocab_size,
             "shards": [dataclasses.asdict(s) for s in shards]}, indent=1))
        return cls(root)

    def load_shard(self, idx: int) -> np.ndarray:
        info = self.shards[idx]
        arr = np.load(self.root / info.path)
        if fletcher64(arr) != info.fletcher64:
            raise IntegrityError(f"shard {info.path} corrupted")
        return arr


class DataPipeline:
    """Deterministic batches of (tokens, targets); resumable from any step."""

    def __init__(self, source: ShardedTokenSource, *, batch: int, seq_len: int,
                 seed: int = 0, prefetch: int = 2,
                 dp_rank: int = 0, dp_size: int = 1):
        self.source = source
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.dp_rank, self.dp_size = dp_rank, dp_size
        self.prefetch = prefetch
        total = sum(s.n_tokens for s in source.shards)
        self.steps_per_epoch = max(total // (batch * (seq_len + 1)), 1)
        self._tokens: Optional[np.ndarray] = None

    def _all_tokens(self) -> np.ndarray:
        if self._tokens is None:
            self._tokens = np.concatenate(
                [self.source.load_shard(i) for i in range(len(self.source.shards))])
        return self._tokens

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step) — restartable & reproducible."""
        epoch = step // self.steps_per_epoch
        idx = step % self.steps_per_epoch
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(self.steps_per_epoch)
        toks = self._all_tokens()
        span = self.batch * (self.seq + 1)
        start = int(order[idx]) * span
        window = toks[start:start + span]
        if window.size < span:
            window = np.pad(window, (0, span - window.size))
        window = window.reshape(self.batch, self.seq + 1)
        # DP slice for this host
        per = self.batch // self.dp_size
        window = window[self.dp_rank * per:(self.dp_rank + 1) * per]
        return {"tokens": window[:, :-1].astype(np.int32),
                "targets": window[:, 1:].astype(np.int32)}

    def iter_from(self, start_step: int) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetching iterator starting at ``start_step`` (resume point)."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            s = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(s), timeout=0.1)
                    s += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def make_lm_batches(cfg, batch: int, seq: int, n: int, seed: int = 0
                    ) -> List[Dict[str, np.ndarray]]:
    """Quick synthetic batches for tests/benchmarks (no disk)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out
