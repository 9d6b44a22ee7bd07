"""Ingest parity: the same raw dumps through ``repro.core.ingest_directory``
and the port's (``device="cpu"``), under REPRO_DEVICE_QA on/off and
REPRO_STREAM_INGEST 0/1, commit the same records, bytes and reports.

Bit-exact, no tolerance: counts, per-record status/reason/checksum/sha256,
the committed .npy and .json bytes, ``manifest`` images and the non-timing
fields of the streaming report."""
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core import ingest_directory as jax_ingest
from repro.core import stream as jax_stream
from repro_torch.core import IngestRule, ingest_directory, write_raw_dump
from repro_torch.core import stream as stream_mod

STREAM_FIELDS = ("nbytes", "chunks", "chunk_bytes", "device_qa", "files")


def _raw_dir(root: Path) -> Path:
    rng = np.random.default_rng(11)
    d = root / "raw"
    for i in range(2):
        vol = rng.normal(100, 20, (32, 32, 24)).astype(np.float32)
        write_raw_dump(d / f"t1_{i}.npz", vol, subject=f"s{i}", session="01",
                       protocol="T1w")
    write_raw_dump(d / "dwi_0.npz",
                   rng.normal(80, 15, (16, 16, 12, 5)).astype(np.float32),
                   subject="s0", session="01", protocol="dwi")
    write_raw_dump(d / "half.npz",             # float16 input, stored f32
                   rng.normal(90, 10, (16, 16, 16)).astype(np.float16),
                   subject="s2", session="01", protocol="T1w")
    nan = rng.normal(100, 20, (16, 16, 16)).astype(np.float32)
    nan[3, 4, 5] = np.nan
    write_raw_dump(d / "nan.npz", nan, subject="s3", session="01",
                   protocol="T1w")
    write_raw_dump(d / "flat.npz", np.full((16, 16, 16), 7, np.float32),
                   subject="s4", session="01", protocol="T1w")
    write_raw_dump(d / "bold.npz", rng.normal(size=(16, 16, 16, 3))
                   .astype(np.float32), subject="s5", session="01",
                   protocol="bold")
    write_raw_dump(d / "coarse.npz", rng.normal(size=(16, 16, 16))
                   .astype(np.float32), subject="s6", session="01",
                   protocol="T1w", resolution_mm=5.0)
    (d / "broken.npz").write_bytes(b"PK\x03\x04 truncated provider dump")
    return d


def _committed(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and p.name != "ingestion_report.json"}


def _report(root: Path):
    rep = json.loads((root / "ds" / "ingestion_report.json").read_text())
    for r in rep["records"]:
        r["dest"] = str(Path(r["dest"]).relative_to(root)) if r["dest"] else ""
    if "stream" in rep:
        rep["stream"] = {k: rep["stream"][k] for k in STREAM_FIELDS}
    return rep


@pytest.mark.parametrize("device_qa", [False, True])
@pytest.mark.parametrize("streaming", ["0", "1"])
def test_ingest_matches_reference(tmp_path, monkeypatch, device_qa,
                                  streaming):
    raw = _raw_dir(tmp_path)
    monkeypatch.setenv(stream_mod.STREAM_ENV, streaming)
    monkeypatch.setenv(stream_mod.CHUNK_MB_ENV, "0.0625")   # 64 KiB chunks
    assert jax_stream.STREAM_ENV == stream_mod.STREAM_ENV
    m_ref, rec_ref = jax_ingest(raw, tmp_path / "ref", "ds",
                                device_qa=device_qa)
    m_port, rec_port = ingest_directory(raw, tmp_path / "port", "ds",
                                        device_qa=device_qa, device="cpu")
    assert [r.__dict__ for r in rec_port] == [
        {**r.__dict__, "dest": r.dest.replace(str(tmp_path / "ref"),
                                              str(tmp_path / "port"))}
        for r in rec_ref]
    rep_ref, rep_port = _report(tmp_path / "ref"), _report(tmp_path / "port")
    assert rep_port == rep_ref
    assert rep_port["counts"] == {"ok": 4, "corrupted": 1, "filtered": 2,
                                  "failed_qa": 2}
    assert ("stream" in rep_port) == (device_qa and streaming == "1")
    if "stream" in rep_port:
        assert rep_port["stream"]["chunks"] > 3
        assert rep_port["stream"]["device_qa"] is True
    assert _committed(tmp_path / "port") == _committed(tmp_path / "ref")
    assert [r.sha256 for r in m_port.images] == \
        [r.sha256 for r in m_ref.images]
    by_status = {r.source: r for r in rec_port}
    assert by_status["nan.npz"].reason == "non-finite voxels"
    assert by_status["flat.npz"].reason == "constant image"
    assert by_status["broken.npz"].status == "corrupted"
    if device_qa:
        assert all(r.checksum for r in rec_port if r.status == "ok")
        assert all(r.sha256 for r in rec_port if r.status == "ok")


def test_rule_defaults_are_the_reference_rule():
    from repro.core.ingest import IngestRule as JaxRule
    assert IngestRule() == IngestRule(**JaxRule().__dict__)


@pytest.mark.parametrize("version", [(1, 0), (2, 0)])
def test_npy_header_parse_matches_reference(version):
    """The port reads npy headers with numpy's public readers (numpy 2.3
    has no ``_read_array_header``); the result is the reference's."""
    import io
    buf = io.BytesIO()
    np.lib.format.write_array(buf, np.zeros((3, 4, 5), "<f4"),
                              version=version)
    data = buf.getvalue()
    assert stream_mod._try_parse_npy_header(data) == \
        jax_stream._try_parse_npy_header(data)
    assert stream_mod._try_parse_npy_header(data[:9]) is None
    with pytest.raises(ValueError):
        stream_mod._try_parse_npy_header(b"not an npy stream")
