"""Tiered storage (paper §2.2, Fig. 3).

Three tiers with the paper's cost/bandwidth characteristics:
  * HOT    — near-line RAID server (407 TB, high bandwidth, low latency)
  * SECURE — GDPR-compliant server (266 TB), surfaced into the general
             namespace via symlinks for authorized users only
  * COLD   — Glacier-style archive ($0.0036/GB-month), nightly backup target

Every put/get is checksummed (IntegrityError on mismatch). Transfers are
accounted (bytes, simulated seconds from tier bandwidth) so the cost model
and benchmarks can reproduce the paper's Table 1 without real networks.
"""
from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Dict, Optional

from .integrity import IntegrityError, sha256_file, verified_copy


@dataclasses.dataclass(frozen=True)
class TierSpec:
    name: str
    bandwidth_gbps: float          # Gb/s, paper Table 1
    latency_ms: float
    cost_per_tb_year: float


# paper-derived characteristics (HPC storage column + Glacier pricing)
TIERS: Dict[str, TierSpec] = {
    "hot": TierSpec("hot", 0.60, 0.16, 180.0 / 4),   # self-hosted RAID vs ACCRE $180
    "secure": TierSpec("secure", 0.60, 0.16, 180.0 / 4),
    "cold": TierSpec("cold", 0.25, 4000.0, 0.0036 * 1000 * 12),
}


@dataclasses.dataclass
class TransferLog:
    n_transfers: int = 0
    bytes_moved: int = 0
    simulated_seconds: float = 0.0
    wall_seconds: float = 0.0

    def record(self, nbytes: int, tier: TierSpec, wall: float):
        self.n_transfers += 1
        self.bytes_moved += nbytes
        self.simulated_seconds += tier.latency_ms / 1e3 + \
            nbytes * 8 / (tier.bandwidth_gbps * 1e9)
        self.wall_seconds += wall


class TieredStore:
    """Filesystem-backed tiered object store with checksummed transfers.

    Every transfer is a single-pass ``verified_copy`` (bytes hashed while
    they move). ``paranoid=True`` additionally re-reads each transfer's
    destination to defend against silent media corruption (one extra read
    pass per transfer — the paper's belt-and-braces mode)."""

    def __init__(self, root: Path, authorized_secure: bool = True,
                 paranoid: bool = False):
        self.root = Path(root)
        self.authorized_secure = authorized_secure
        self.paranoid = paranoid
        self.log: Dict[str, TransferLog] = {k: TransferLog() for k in TIERS}
        for t in TIERS:
            (self.root / t).mkdir(parents=True, exist_ok=True)

    def _tier_dir(self, tier: str) -> Path:
        if tier not in TIERS:
            raise KeyError(tier)
        if tier == "secure" and not self.authorized_secure:
            raise PermissionError("not authorized for the secure (GDPR) tier")
        return self.root / tier

    def put(self, src: Path, key: str, tier: str = "hot") -> str:
        dst = self._tier_dir(tier) / key
        t0 = time.time()
        digest = verified_copy(src, dst, paranoid=self.paranoid)
        self.log[tier].record(dst.stat().st_size, TIERS[tier], time.time() - t0)
        return digest

    def get(self, key: str, dst: Path, tier: str = "hot",
            expect_sha256: Optional[str] = None) -> str:
        src = self._tier_dir(tier) / key
        t0 = time.time()
        digest = verified_copy(src, dst, paranoid=self.paranoid)
        if expect_sha256 and digest != expect_sha256:
            raise IntegrityError(f"{key}: expected {expect_sha256}, got {digest}")
        self.log[tier].record(Path(dst).stat().st_size, TIERS[tier], time.time() - t0)
        return digest

    def exists(self, key: str, tier: str = "hot") -> bool:
        return (self.root / tier / key).exists()

    def link_secure_into_general(self, key: str) -> Path:
        """The paper's symlink arrangement: secure data appears in the general
        namespace for authorized users without duplicating bytes."""
        if not self.authorized_secure:
            raise PermissionError("not authorized for the secure (GDPR) tier")
        src = self.root / "secure" / key
        dst = self.root / "hot" / key
        dst.parent.mkdir(parents=True, exist_ok=True)
        if dst.is_symlink() or dst.exists():
            dst.unlink()
        os.symlink(src, dst)
        return dst

    def archive_to_cold(self, key: str, src_tier: str = "hot") -> str:
        """Nightly Glacier-style backup (paper §2.2)."""
        return self.put(self.root / src_tier / key, key, tier="cold")

    def storage_cost_per_year(self) -> Dict[str, float]:
        out = {}
        for t in TIERS:
            nbytes = sum(p.stat().st_size for p in (self.root / t).rglob("*")
                         if p.is_file() and not p.is_symlink())
            out[t] = nbytes / 1e12 * TIERS[t].cost_per_tb_year
        return out
