"""Provenance records (paper §2.3): every derivative ships with a config file
recording when it ran, who ran it, the exact inputs (with checksums), and the
pipeline's content digest — file-level reproducibility years later."""
from __future__ import annotations

import dataclasses
import getpass
import json
import platform
import time
from pathlib import Path
from typing import Dict, List, Optional

PROVENANCE_NAME = "provenance.json"


@dataclasses.dataclass
class Provenance:
    pipeline: str
    pipeline_digest: str           # content hash of config+code ("container digest")
    user: str
    started_at: float
    finished_at: float
    inputs: Dict[str, str]         # path -> sha256
    outputs: Dict[str, str]
    status: str                    # ok | failed
    host: str = ""
    error: Optional[str] = None
    attempt: int = 1
    # multi-node execution (repro.dist.cluster): which node committed this
    # record and under which lease epoch. Epoch 0 = single-host execution;
    # a requeued unit's new lease bumps the epoch, so records tell apart a
    # first-run commit from a post-node-death re-run years later.
    node_id: str = ""
    lease_epoch: int = 0
    # True iff every input array was served from the host's content-addressed
    # input cache (repro.dist.cache) instead of shared storage. The input
    # checksums recorded above are identical either way (a cache hit re-hashes
    # the local bytes), so this flag is pure data-plane provenance: it lets a
    # reader audit which commits never touched the storage link.
    cache_hit: bool = False
    # Data-movement provenance for locality-aware scheduling: the fraction of
    # this unit's input bytes the coordinator *estimated* were already local
    # when it granted the lease (the placement score, from the node's digest
    # summary), and the input bytes that *actually* came off node-local disk.
    # Comparing the two audits the scheduler: a high score with low
    # bytes_from_cache means a stale summary or Bloom false positive.
    locality_score: float = 0.0
    bytes_from_cache: int = 0
    # Peer-fabric provenance (repro.dist.blobserve): True iff at least one
    # input blob was streamed from another host's cache instead of shared
    # storage, and how many bytes came over peer links. Peer bytes are
    # sha256-re-verified on arrival against the manifest digest, so the
    # recorded input checksums are identical across cache/peer/storage
    # origins — like cache_hit, this is pure data-plane provenance.
    peer_fetch: bool = False
    bytes_from_peer: int = 0
    # Streaming-ingest provenance (repro.core.stream): the per-unit
    # StreamReport dict when this commit's inputs were verified in-flight —
    # digests (and, when enabled, the fused device QA fold) computed
    # chunk-by-chunk while the bytes crossed the storage or peer link, with
    # per-stage wall times and the overlap the pipeline won. None when every
    # input was served resident or streaming was disabled; the recorded
    # input checksums are identical either way.
    stream: Optional[Dict] = None

    def save(self, out_dir: Path):
        """Atomic write (tmp + rename): a concurrent reader — or a racing
        speculative duplicate — never observes a torn provenance file."""
        from .integrity import atomic_write_bytes
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        atomic_write_bytes(out_dir / PROVENANCE_NAME,
                           json.dumps(dataclasses.asdict(self), indent=1).encode())

    @classmethod
    def load(cls, out_dir: Path) -> Optional["Provenance"]:
        p = Path(out_dir) / PROVENANCE_NAME
        if not p.exists():
            return None
        try:
            return cls(**json.loads(p.read_text()))
        except (json.JSONDecodeError, TypeError):
            return None


def make_provenance(pipeline: str, digest: str, inputs: Dict[str, str],
                    outputs: Dict[str, str], started: float, status: str = "ok",
                    error: Optional[str] = None, attempt: int = 1,
                    node_id: str = "", lease_epoch: int = 0,
                    cache_hit: bool = False, locality_score: float = 0.0,
                    bytes_from_cache: int = 0, peer_fetch: bool = False,
                    bytes_from_peer: int = 0,
                    stream: Optional[Dict] = None) -> Provenance:
    return Provenance(
        pipeline=pipeline, pipeline_digest=digest,
        user=getpass.getuser(), host=platform.node(),
        started_at=started, finished_at=time.time(),
        inputs=inputs, outputs=outputs, status=status, error=error,
        attempt=attempt, node_id=node_id, lease_epoch=lease_epoch,
        cache_hit=cache_hit, locality_score=locality_score,
        bytes_from_cache=bytes_from_cache, peer_fetch=peer_fetch,
        bytes_from_peer=bytes_from_peer, stream=stream)


def is_complete(out_dir: Path, digest: Optional[str] = None) -> bool:
    """A derivative counts as done iff its provenance says ok — and, when a
    digest is given, was produced by the same pipeline version (a changed
    pipeline re-runs everything, the paper's reproducibility contract)."""
    prov = Provenance.load(out_dir)
    if prov is None or prov.status != "ok":
        return False
    return digest is None or prov.pipeline_digest == digest
