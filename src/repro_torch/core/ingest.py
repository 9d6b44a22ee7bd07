"""Data acquisition & organization (paper §2.1).

The paper receives DICOM/NIFTI from providers, converts DICOM→NIfTI with
dcm2niix (producing JSON sidecars), filters scans by protocol / resolution /
matrix dimensions plus a fast visual QA, and lays files out as BIDS.

Here the scanner hand-off is a directory of raw dumps: ``<id>.raw.npz``
(voxel array + acquisition metadata — our DICOM stand-in). Ingestion:

  1. convert: raw.npz → .npy volume + .json sidecar (dcm2niix analogue),
     carrying acquisition metadata through; corrupted dumps are quarantined
     with a reason (the paper asks providers for complete versions).
  2. filter: protocol allow-list, resolution / matrix-dimension bounds.
  3. fast QA: intensity sanity (finite, non-constant, SNR proxy); with
     ``device_qa`` the finite/constant/mean passes and the transfer checksum
     fuse into ONE CUDA kernel launch per volume (kernels/checksum). With
     streaming on (the default, ``repro_torch.core.stream``) the serialized
     volume
     is chunked through the fold + an incremental sha256, so the integrity
     digest and the QA verdict land together — no second host-side pass —
     and the recorded checksum is bit-identical to the one-shot kernel's.
  4. organize: BIDS tree ``sub-*/ses-*/<modality>/...`` + manifest scan.
     Accepted volumes and the ingestion report commit via atomic
     tmp+fsync+rename (a crash mid-ingest never leaves a torn file).

Everything is recorded in an ingestion report (the paper's curation trail).
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import stream as stream_mod
from .integrity import atomic_write_bytes
from .manifest import DatasetManifest

PROTOCOL_MODALITY = {"T1w": "anat", "T2w": "anat", "dwi": "dwi", "bold": "func"}


@dataclasses.dataclass
class IngestRule:
    allowed_protocols: Tuple[str, ...] = ("T1w", "dwi")
    min_resolution_mm: float = 0.5
    max_resolution_mm: float = 3.0
    min_matrix: int = 8
    min_snr: float = 1.0


@dataclasses.dataclass
class IngestRecord:
    source: str
    status: str                  # ok | corrupted | filtered | failed_qa
    reason: str = ""
    dest: str = ""
    checksum: str = ""           # fused-QA device checksum (device_qa mode)
    sha256: str = ""             # content digest of the committed .npy bytes


def write_raw_dump(path: Path, vol: np.ndarray, *, subject: str, session: str,
                   protocol: str, resolution_mm: float = 1.0):
    """Scanner-side helper (tests/examples): one raw dump per acquisition."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, vol=vol, meta=json.dumps({
        "subject": subject, "session": session, "protocol": protocol,
        "resolution_mm": resolution_mm, "matrix": list(vol.shape)}))


def _convert(raw: Path) -> Tuple[Optional[np.ndarray], Optional[dict], str]:
    """dcm2niix analogue: raw dump → (volume, sidecar) or a rejection reason."""
    try:
        with np.load(raw, allow_pickle=False) as z:
            vol = z["vol"]
            meta = json.loads(str(z["meta"]))
    except Exception as e:  # noqa: BLE001 — corrupted provider data
        return None, None, f"corrupted: {type(e).__name__}"
    for key in ("subject", "session", "protocol", "resolution_mm"):
        if key not in meta:
            return None, None, f"missing metadata: {key}"
    return vol, meta, ""


def _bg_corner(vol: np.ndarray) -> np.ndarray:
    """Corner octant (air) used as the SNR-proxy background region."""
    c = tuple(slice(0, max(s // 4, 1)) for s in vol.shape[:3])
    return vol[c]


def _fast_qa(vol: np.ndarray, rule: IngestRule) -> str:
    # float32 throughout — the dtype the fused kernel reduces in and the
    # dtype ingest stores. Reducing in the volume's native dtype diverged
    # from the device verdict on float16 input (std/mean overflow to inf at
    # modest intensities), accepting scans on one path and rejecting the
    # same bytes on the other.
    vol = np.asarray(vol, dtype=np.float32)
    if not np.all(np.isfinite(vol)):
        return "non-finite voxels"
    if float(vol.std()) == 0.0:
        return "constant image"
    # SNR proxy: foreground mean over background std (corner octant = air)
    bg = _bg_corner(vol)
    snr = float(np.abs(vol.mean()) / (bg.std() + 1e-6))
    if snr < rule.min_snr:
        return f"low SNR proxy ({snr:.2f})"
    return ""


def _qa_verdict(st, vol: np.ndarray, rule: IngestRule) -> str:
    """The fused-kernel QA decision, shared by the one-shot and streamed
    paths: ``st`` is a ``QAStats`` (from ``qa_stats`` or the chunk
    accumulator — bit-identical either way), ``vol`` the float32 volume
    (only its corner octant is touched, for the SNR background std)."""
    if st.finite_count < vol.size:
        return "non-finite voxels"
    if st.vmin == st.vmax:
        return "constant image"
    mean = st.vsum / max(vol.size, 1)
    bg = _bg_corner(vol)
    snr = float(abs(mean) / (bg.std() + 1e-6))
    if snr < rule.min_snr:
        return f"low SNR proxy ({snr:.2f})"
    return ""


def _fast_qa_fused(vol: np.ndarray, rule: IngestRule, device: torch.device
                   ) -> Tuple[str, str]:
    """QA + transfer checksum in ONE device pass (kernels/checksum) on
    ``device``.

    Returns ``(reason, checksum_hex)``. Semantically equivalent to
    :func:`_fast_qa` — the full-volume finite / constant / mean passes come
    from the fused kernel's (min, max, sum, finite_count); only the SNR
    background std still touches the tiny corner octant (1/64 of voxels) on
    the host. The checksum rides along for free and is recorded so the BIDS
    transfer can be verified without another read; it is computed over the
    float32 view — the exact dtype :func:`ingest_directory` stores — so a
    later device-side pass over the saved array reproduces it."""
    from ..kernels.checksum import qa_stats
    vol = np.ascontiguousarray(vol, dtype=np.float32)
    st = qa_stats(torch.from_numpy(vol).to(device))
    return _qa_verdict(st, vol, rule), f"{st.checksum:016x}"


def _fast_qa_streamed(vol: np.ndarray, rule: IngestRule,
                      device: torch.device
                      ) -> Tuple[str, str, str, bytes,
                                 stream_mod.StreamReport]:
    """The streaming twin of :func:`_fast_qa_fused`: serialize the float32
    volume once, then chunk those bytes through the incremental sha256 and
    the chunk-accumulating fused kernel fold (``core/stream.py``), so the
    content digest of the exact bytes about to be committed and the QA
    verdict land together — no load-then-verify second pass, and on an
    accelerator each chunk's fold dispatch overlaps the next chunk's
    hashing. Returns ``(reason, checksum_hex, sha256_hex, npy_bytes,
    report)``; the checksum is bit-identical to the one-shot kernel's
    (same blocks, same fold order) and ``npy_bytes`` is what
    :func:`ingest_directory` commits, so digest == sha256 of the file."""
    vol = np.ascontiguousarray(vol, dtype=np.float32)
    buf = io.BytesIO()
    np.save(buf, vol)
    data = buf.getvalue()
    digest, st, rep = stream_mod.stream_verify_bytes(data, device=device)
    if st is None:       # cannot happen for a C-order float32 .npy; be safe
        reason, checksum = _fast_qa_fused(vol, rule, device)
    else:
        reason, checksum = _qa_verdict(st, vol, rule), f"{st.checksum:016x}"
    return reason, checksum, digest, data, rep


def ingest_directory(raw_dir: Path, bids_root: Path, dataset: str,
                     rule: Optional[IngestRule] = None,
                     device_qa: Optional[bool] = None,
                     device: DeviceLike = None
                     ) -> Tuple[DatasetManifest, List[IngestRecord]]:
    """Run the paper's §2.1 pipeline over a directory of raw dumps.

    ``device_qa=True`` routes the fast-QA stage through the fused CUDA
    QA+checksum kernel on ``device`` (``None`` means ``cuda``, which must
    exist) — one device pass per volume instead of ~5 numpy
    passes — and records the transfer checksum on each accepted scan.
    Defaults to the ``REPRO_DEVICE_QA`` env var (off). With streaming on
    (the default; ``REPRO_STREAM_INGEST=0`` disables) the device-QA path
    chunks the serialized volume through the fold + an incremental sha256
    (``core/stream.py``), committing exactly the verified bytes and
    recording their content digest on each record."""
    # construct the default per call: a shared mutable default instance
    # would leak one caller's rule edits into every later call
    rule = IngestRule() if rule is None else rule
    device = resolve_device(device)
    if device_qa is None:
        device_qa = os.environ.get("REPRO_DEVICE_QA", "0").lower() \
            not in ("0", "", "false")
    streaming = stream_mod.stream_enabled()
    raw_dir, bids_root = Path(raw_dir), Path(bids_root)
    records: List[IngestRecord] = []
    stream_rep: Optional[stream_mod.StreamReport] = None
    for raw in sorted(raw_dir.glob("*.npz")):
        vol, meta, err = _convert(raw)
        if err:
            records.append(IngestRecord(raw.name, "corrupted", err))
            continue
        proto = meta["protocol"]
        if proto not in rule.allowed_protocols:
            records.append(IngestRecord(raw.name, "filtered",
                                        f"protocol {proto} not in allow-list"))
            continue
        res = float(meta["resolution_mm"])
        if not (rule.min_resolution_mm <= res <= rule.max_resolution_mm):
            records.append(IngestRecord(raw.name, "filtered",
                                        f"resolution {res}mm out of bounds"))
            continue
        if min(vol.shape[:3]) < rule.min_matrix:
            records.append(IngestRecord(raw.name, "filtered",
                                        f"matrix {vol.shape} too small"))
            continue
        payload: Optional[bytes] = None
        digest = ""
        if device_qa and streaming:
            qa, checksum, digest, payload, rep = _fast_qa_streamed(
                vol, rule, device)
            if stream_rep is None:
                stream_rep = rep
            else:
                stream_rep.merge(rep)
        elif device_qa:
            qa, checksum = _fast_qa_fused(vol, rule, device)
        else:
            qa, checksum = _fast_qa(vol, rule), ""
        if qa:
            records.append(IngestRecord(raw.name, "failed_qa", qa,
                                        checksum=checksum))
            continue
        # BIDS placement + JSON sidecar (dcm2niix behaviour)
        sub, ses = meta["subject"], meta["session"]
        modality = PROTOCOL_MODALITY.get(proto, "anat")
        base = bids_root / dataset / f"sub-{sub}" / f"ses-{ses}" / modality
        base.mkdir(parents=True, exist_ok=True)
        stem = f"sub-{sub}_ses-{ses}_{proto}"
        if payload is None:
            buf = io.BytesIO()
            np.save(buf, np.ascontiguousarray(vol, dtype=np.float32))
            payload = buf.getvalue()
            digest = hashlib.sha256(payload).hexdigest()
        # commit the exact bytes the QA/digest pass saw, atomically
        atomic_write_bytes(base / f"{stem}.npy", payload)
        atomic_write_bytes(base / f"{stem}.json",
                           json.dumps(meta, indent=1).encode(), fsync=False)
        records.append(IngestRecord(raw.name, "ok",
                                    dest=str(base / f"{stem}.npy"),
                                    checksum=checksum, sha256=digest))
    manifest = DatasetManifest.scan(bids_root / dataset, name=dataset)
    report = {
        "dataset": dataset,
        "counts": {s: sum(r.status == s for r in records)
                   for s in ("ok", "corrupted", "filtered", "failed_qa")},
        "records": [dataclasses.asdict(r) for r in records],
    }
    if stream_rep is not None:
        report["stream"] = stream_rep.to_dict()
    rp = bids_root / dataset / "ingestion_report.json"
    rp.parent.mkdir(parents=True, exist_ok=True)
    # tmp + fsync + rename (journal discipline): a crash mid-write must
    # never leave a torn curation trail next to committed volumes
    atomic_write_bytes(rp, json.dumps(report, indent=1).encode())
    _fsync_dir(rp.parent)
    return manifest, records


def _fsync_dir(path: Path):
    """fsync a directory so a just-renamed report survives power loss
    (same discipline as the reference's ``dist/journal.py``); best-effort on
    filesystems that reject directory fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
