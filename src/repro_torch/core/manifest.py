"""BIDS-style manifest (paper §2.1, Fig. 2).

Layout mirrors the paper's tree:

    <root>/<dataset>/sub-<id>/ses-<id>/<modality>/sub-..._ses-..._<suffix>.npy
    <root>/<dataset>/derivatives/<pipeline>/sub-<id>/ses-<id>/...

Raw files may live on a *different* (secure) store and be symlinked into the
general namespace — the paper's GDPR arrangement. The manifest scans the
tree, validates naming, records checksums + sizes, and persists as JSON so
queries don't re-walk millions of files.
"""
from __future__ import annotations

import dataclasses
import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .integrity import sha256_file

# image payloads only — .json sidecars are metadata, not images
_NAME_RE = re.compile(
    r"^sub-(?P<sub>[A-Za-z0-9]+)_ses-(?P<ses>[A-Za-z0-9]+)_(?P<suffix>[A-Za-z0-9]+)\.(npy|nii)$")

MODALITIES = ("anat", "dwi", "func", "fmap")


@dataclasses.dataclass
class ImageRecord:
    path: str                    # relative to dataset root
    subject: str
    session: str
    modality: str                # anat | dwi | ...
    suffix: str                  # T1w | dwi | ...
    size_bytes: int
    sha256: str
    is_symlink: bool = False


@dataclasses.dataclass
class DatasetManifest:
    name: str
    root: str
    security_tier: str = "general"        # general | gdpr
    images: List[ImageRecord] = dataclasses.field(default_factory=list)
    scanned_at: float = 0.0

    # ---- construction ----------------------------------------------------
    @classmethod
    def scan(cls, root: Path, name: Optional[str] = None,
             security_tier: str = "general", checksum: bool = True
             ) -> "DatasetManifest":
        root = Path(root)
        m = cls(name=name or root.name, root=str(root), security_tier=security_tier)
        for p in sorted(root.rglob("*")):
            if not p.is_file() or "derivatives" in p.parts:
                continue
            nm = _NAME_RE.match(p.name)
            if not nm:
                continue
            rel = p.relative_to(root)
            modality = rel.parts[2] if len(rel.parts) >= 4 else "anat"
            m.images.append(ImageRecord(
                path=str(rel), subject=nm["sub"], session=nm["ses"],
                modality=modality, suffix=nm["suffix"],
                size_bytes=p.stat().st_size,
                sha256=sha256_file(p) if checksum else "",
                is_symlink=p.is_symlink()))
        m.scanned_at = time.time()
        return m

    # ---- validation (paper: python BIDS validator) ------------------------
    def validate(self) -> List[str]:
        problems = []
        for rec in self.images:
            parts = Path(rec.path).parts
            if len(parts) < 4:
                problems.append(f"{rec.path}: not sub-*/ses-*/<modality>/<file>")
                continue
            if not parts[0].startswith("sub-") or parts[0] != f"sub-{rec.subject}":
                problems.append(f"{rec.path}: subject dir mismatch")
            if not parts[1].startswith("ses-") or parts[1] != f"ses-{rec.session}":
                problems.append(f"{rec.path}: session dir mismatch")
            if parts[2] not in MODALITIES:
                problems.append(f"{rec.path}: unknown modality dir {parts[2]}")
        return problems

    # ---- queries -----------------------------------------------------------
    def sessions(self) -> Dict[tuple, List[ImageRecord]]:
        out: Dict[tuple, List[ImageRecord]] = {}
        for rec in self.images:
            out.setdefault((rec.subject, rec.session), []).append(rec)
        return out

    def derivatives_dir(self, pipeline: str) -> Path:
        return Path(self.root) / "derivatives" / pipeline

    # ---- persistence --------------------------------------------------------
    def save(self, path: Path):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dataclasses.asdict(self), indent=1))

    @classmethod
    def load(cls, path: Path) -> "DatasetManifest":
        d = json.loads(Path(path).read_text())
        d["images"] = [ImageRecord(**r) for r in d["images"]]
        return cls(**d)


def synthesize_dataset(root: Path, name: str, n_subjects: int = 4,
                       sessions_per_subject: int = 2, shape=(16, 16, 16),
                       seed: int = 0, with_dwi: bool = True) -> DatasetManifest:
    """Create a small synthetic BIDS dataset of .npy 'volumes' (tests/examples)."""
    rng = np.random.default_rng(seed)
    root = Path(root) / name
    for s in range(n_subjects):
        for ses in range(sessions_per_subject):
            base = root / f"sub-{s:03d}" / f"ses-{ses:02d}"
            t1 = base / "anat" / f"sub-{s:03d}_ses-{ses:02d}_T1w.npy"
            t1.parent.mkdir(parents=True, exist_ok=True)
            vol = rng.normal(100.0, 20.0, shape).astype(np.float32)
            # add a synthetic low-frequency bias field for the correction pipeline
            g = np.linspace(-1, 1, shape[0])
            bias = 1.0 + 0.3 * np.add.outer(np.add.outer(g, g), g)
            np.save(t1, vol * bias)
            if with_dwi and s % 2 == 0:    # some sessions lack DWI (exclusion CSV)
                dwi = base / "dwi" / f"sub-{s:03d}_ses-{ses:02d}_dwi.npy"
                dwi.parent.mkdir(parents=True, exist_ok=True)
                np.save(dwi, rng.normal(80.0, 15.0, shape + (6,)).astype(np.float32))
    return DatasetManifest.scan(root, name=name)
