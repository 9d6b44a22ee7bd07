"""The framework-free core modules the port carries as copies (integrity,
manifest, provenance, query, storage, cost) give the JAX package's bytes
and values exactly."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro_torch.core import cost, integrity

REPO = Path(__file__).resolve().parents[1]

VERBATIM = ["core/integrity.py", "core/manifest.py", "core/provenance.py",
            "core/query.py", "core/storage.py", "kernels/checksum/ref.py"]


@pytest.mark.parametrize("rel", VERBATIM)
def test_copied_modules_are_verbatim(rel):
    assert (REPO / "src" / "repro_torch" / rel).read_bytes() == \
        (REPO / "src" / "repro" / rel).read_bytes()


def _tree(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("shape,dwi", [((12, 12, 12), True),
                                       ((16, 16, 16), False)])
def test_synthesize_dataset_identical_tree_and_manifest(tmp_path, shape, dwi):
    a = R.synthesize_dataset(tmp_path / "a", "ds", n_subjects=3,
                             sessions_per_subject=2, shape=shape, seed=7,
                             with_dwi=dwi)
    b = T.synthesize_dataset(tmp_path / "b", "ds", n_subjects=3,
                             sessions_per_subject=2, shape=shape, seed=7,
                             with_dwi=dwi)
    assert _tree(tmp_path / "a") == _tree(tmp_path / "b")
    a.save(tmp_path / "a.json")
    b.save(tmp_path / "b.json")
    ja, jb = (json.loads((tmp_path / f).read_text())
              for f in ("a.json", "b.json"))
    for j in (ja, jb):
        j.pop("root"), j.pop("scanned_at")
    assert ja == jb
    assert a.validate() == b.validate() == []
    assert T.DatasetManifest.load(tmp_path / "a.json").images == \
        [T.ImageRecord(**dataclasses.asdict(r)) for r in a.images]


def _units(mod):
    return [mod.WorkUnit("ds", "001", "01", "bias_correct", "ab12",
                         {"T1w": "sub-001/ses-01/anat/x.npy"},
                         "/d/derivatives/bias_correct/sub-001/ses-01",
                         input_digests={"T1w": "f" * 64},
                         input_bytes={"T1w": 1234}),
            mod.WorkUnit("ds", "002", "01", "dwi_prequal", "cd34",
                         {"T1w": "a.npy", "dwi": "b.npy"}, "/d/o",
                         depends_on=["ds_bias_correct_sub-001_ses-01"])]


def test_dump_units_identical_bytes(tmp_path):
    pa = R.dump_units(_units(R), tmp_path / "a.json")
    pb = T.dump_units(_units(T), tmp_path / "b.json")
    assert pa.read_bytes() == pb.read_bytes()
    assert [dataclasses.asdict(u) for u in T.load_units(pa)] == \
        [dataclasses.asdict(u) for u in _units(R)]
    R.write_exclusion_csv([R.Exclusion("1", "2", "why")], tmp_path / "a.csv")
    T.write_exclusion_csv([T.Exclusion("1", "2", "why")], tmp_path / "b.csv")
    assert (tmp_path / "a.csv").read_bytes() == \
        (tmp_path / "b.csv").read_bytes()


@pytest.mark.parametrize("n", [0, 1, 3, 4, 1001, 70_000])
def test_fletcher64_and_sha256_agree(tmp_path, n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert T.fletcher64(data) == R.fletcher64(data)
    p = tmp_path / "blob"
    p.write_bytes(data)
    assert T.fletcher64_file(p, chunk=4099) == R.fletcher64_file(p) == \
        R.fletcher64(data)
    assert T.sha256_file(p) == R.sha256_file(p)
    arr = np.frombuffer(data[:n - n % 4], np.float32)
    assert T.array_checksum(arr) == R.array_checksum(arr)


def test_array_io_and_verified_copy_agree(tmp_path):
    arr = np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32)
    da = R.sha256_save_array(tmp_path / "a.npy", arr)
    db = T.sha256_save_array(tmp_path / "b.npy", arr)
    assert da == db
    assert (tmp_path / "a.npy").read_bytes() == (tmp_path / "b.npy").read_bytes()
    got, dg = T.sha256_load_array(tmp_path / "a.npy")
    assert dg == da and np.array_equal(got, arr)
    assert T.verified_copy(tmp_path / "a.npy", tmp_path / "c.npy",
                           paranoid=True) == da


def test_provenance_gate_reads_reference_records(tmp_path):
    """Provenance files are interchangeable: each package's gate reads the
    other's records (the digest, not the writer, decides)."""
    R.make_provenance("p", "d1", {"i": "x"}, {"o": "y"}, 0.0,
                      stream={"nbytes": 1}).save(tmp_path)
    assert T.is_complete(tmp_path, "d1") and not T.is_complete(tmp_path, "d2")
    rec = T.Provenance.load(tmp_path)
    assert rec.inputs == {"i": "x"} and rec.stream == {"nbytes": 1}
    fields_r = [f.name for f in dataclasses.fields(R.Provenance)]
    assert [f.name for f in dataclasses.fields(T.Provenance)] == fields_r


def test_tiered_store_accounts_like_reference(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"x" * 5000)
    logs = []
    for mod, d in ((R, "r"), (T, "t")):
        st = mod.TieredStore(tmp_path / d)
        dig = st.put(src, "k/obj", tier="hot")
        st.archive_to_cold("k/obj")
        st.get("k/obj", tmp_path / d / "out.bin", expect_sha256=dig)
        logs.append({k: (v.n_transfers, v.bytes_moved, v.simulated_seconds)
                     for k, v in st.log.items()})
    assert logs[0] == logs[1]
    assert T.TIERS == {k: T.storage.TierSpec(*dataclasses.astuple(v))
                       for k, v in R.TIERS.items()}


def test_cost_model_matches_paper_table():
    assert T.paper_table1() == R.paper_table1()
    assert T.cost_ratio_cloud_vs_hpc(6) == R.cost_ratio_cloud_vs_hpc(6)
    env = T.PAPER_ENVS["hpc"]
    assert T.job_cost(env, 10, 5.0, 2.0) == \
        R.job_cost(R.PAPER_ENVS["hpc"], 10, 5.0, 2.0)
    assert not hasattr(cost, "TPU_ENVS") and \
        not hasattr(cost, "training_run_cost")
    assert integrity.IntegrityError is T.IntegrityError
