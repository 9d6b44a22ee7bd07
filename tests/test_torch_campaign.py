"""The port's campaign planner against the JAX package's: ``campaign.json``,
the per-shard units files and scripts from ``generate_jobs(summaries=)`` /
``generate_jobs(campaign=)`` are byte-equal (the scripts apart from the
module name), ``plan_campaign`` gives byte-equal plans for multi-cohort DAG
campaigns, and the planner invariant holds on the port wherever it holds on
the reference — under a deterministic grid and under hypothesis. The
reference's fault R2 (ROADMAP.md, Queue 3) shows on both: its minimal case
is ``xfail``."""
import dataclasses
import shutil
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.campaign as RK
import repro.core.manifest as RM
import repro.core.pipelines as RP
import repro.core.query as RQ
import repro.core.workflow as RW
import repro.dist.cache as RC
import repro.dist.queue as RQU
import repro_torch.core.campaign as TK
import repro_torch.core.manifest as TM
import repro_torch.core.pipelines as TP
import repro_torch.core.query as TQ
import repro_torch.core.workflow as TW
import repro_torch.dist.cache as TC
import repro_torch.dist.placement as TPL
import repro_torch.dist.queue as TQU

STATUS = {"disk_free_gb": 3.5, "disk_total_gb": 100.0, "load_1m": 0.25}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("campaign")
    return RM.synthesize_dataset(root / "ds", "campds", n_subjects=6,
                                 sessions_per_subject=2, shape=(8, 8, 8))


@pytest.fixture()
def fixed_status(monkeypatch):
    # resource_status reads live disk and load: both sides read one value
    for mod in (RW, TW):
        monkeypatch.setattr(mod, "resource_status", lambda root: dict(STATUS))


def _pipes():
    """The reference's bias_correct and a port pipeline with the same spec,
    so units (and their pipeline digests) agree byte for byte."""
    ref = RP.builtin_pipelines()["bias_correct"]
    port = TP.Pipeline(TP.PipelineSpec(**dataclasses.asdict(ref.spec)),
                       ref.fn)
    assert port.digest() == ref.digest()
    return ref, port


def _manifests(ds):
    """The reference's manifest and the port's load of its saved file (a
    fresh scan would stamp a new creation time)."""
    path = Path(ds.root) / "manifest.json"
    ds.save(path)
    return ds, TM.DatasetManifest.load(path)


def _summary(C, units, per=1):
    s = C.DigestSummary()
    for u in units[::per]:
        for d in u.input_digests.values():
            s.add(d)
    return s


def _snapshot(out):
    return {str(p.relative_to(out)): p.read_bytes()
            for p in sorted(Path(out).rglob("*")) if p.is_file()}


def _generate_both(dataset, out, **kw_by_side):
    """generate_jobs on each side into the same directory (the scripts name
    their own paths); returns each side's plan and files."""
    rm, tm = _manifests(dataset)
    rp, tp = _pipes()
    got = {}
    for side, (W, m, p) in (("ref", (RW, rm, rp)), ("port", (TW, tm, tp))):
        shutil.rmtree(out, ignore_errors=True)
        jp = W.generate_jobs(m, p, out, **kw_by_side[side])
        got[side] = (jp, _snapshot(out))
    return got


def _same_files(got):
    ref, port = got["ref"][1], got["port"][1]
    assert sorted(port) == sorted(ref)
    for name, data in ref.items():
        if name.endswith(".slurm"):
            data = data.replace(b"python -m repro.", b"python -m repro_torch.")
        assert port[name] == data, name


@pytest.mark.parametrize("split", [(6, 12), (3, 9), (0, 0), (12, 12)])
def test_generate_jobs_summaries_byte_equal(dataset, tmp_path, fixed_status,
                                            split):
    units, _ = RQ.query_available_work(dataset, _pipes()[0])
    a, b = split
    kw = {}
    for side, C in (("ref", RC), ("port", TC)):
        summ = {"host-a": _summary(C, units[:a]),
                "host-b": _summary(C, units[a:b])}
        f = C.save_summary_file(tmp_path / f"{side}.json", summ)
        kw[side] = {"summaries": f}
    got = _generate_both(dataset, tmp_path / "jobs", **kw)
    _same_files(got)
    rj, tj = got["ref"][0], got["port"][0]
    assert Path(tj.campaign_file).name == "campaign.json"
    assert [Path(s).name for s in tj.shard_scripts] == \
        [Path(s).name for s in rj.shard_scripts]
    assert tj.slurm_script is None and len(tj.shard_scripts) >= 1
    assert "repro_torch.core.workflow --run-one" in \
        Path(tj.shard_scripts[0]).read_text()


def test_generate_jobs_replays_a_saved_plan_and_covers_a_stale_one(
        dataset, tmp_path, fixed_status):
    rp, _ = _pipes()
    cohort = RK.cohort_from_query(dataset, rp)
    stale = RK.plan_campaign(
        [dataclasses.replace(cohort, units=cohort.units[:4])],
        {"h": _summary(RC, cohort.units[:4])}, status=STATUS)
    saved = stale.save(tmp_path / "audited.json")
    got = _generate_both(dataset, tmp_path / "jobs",
                         ref={"campaign": saved}, port={"campaign": saved})
    _same_files(got)
    tj = got["port"][0]
    assert Path(tj.campaign_file).read_bytes() == saved.read_bytes()
    assert any("shard-uncovered" in s for s in tj.shard_scripts)
    # a parsed dict and a live plan object replay to the same bytes
    for obj in (TK.CampaignPlan.load(saved), TK.CampaignPlan.load(saved)
                .__dict__ | {"shards": [dataclasses.asdict(s) for s in
                                        TK.CampaignPlan.load(saved).shards]}):
        assert TK.as_plan(obj).to_json() == saved.read_text()
    with pytest.raises(TypeError):
        TK.as_plan(3)


def _units(Q, rows):
    return [Q.WorkUnit(**r) for r in rows]


def _dag_rows(ds, n, dep_every=3, size=1000):
    rows = []
    for i in range(n):
        digs = {"T1w": f"{ds}-{i % 5:02d}"} if i % 4 else {}
        rows.append(dict(
            dataset=ds, subject=f"{i:02d}", session="01", pipeline="p",
            pipeline_digest="pd", inputs={k: f"{i}.npy" for k in digs},
            out_dir=f"/out/{ds}/{i}", input_digests=digs,
            input_bytes={k: size + i for k in digs},
            depends_on=([f"{ds}_p_sub-{i - 2:02d}_ses-01"]
                        if i >= 2 and i % dep_every == 0 else [])))
    return rows


def _cohorts(side_K, side_Q, spec):
    out = []
    for ds, n, excl in spec:
        rows = _dag_rows(ds, n)
        out.append(side_K.Cohort(
            ds, "p", "pd", _units(side_Q, rows),
            [side_Q.Exclusion(f"{i:02d}", "01", "excluded") for i in excl]))
    return out


def _summaries(C, held):
    out = {}
    for node, digs in held.items():
        s = C.DigestSummary(m=512, k=3)
        for d in digs:
            s.add(d)
        out[node] = s
    return out


PLAN_CASES = [
    ([("a", 9, [])], {}, None),
    ([("a", 9, [1]), ("b", 6, [])], {"n0": ["a-01", "b-02"]}, None),
    ([("a", 12, [0, 5]), ("a", 12, [])], {"n0": ["a-01"], "n1": ["a-02",
                                                                  "a-03"]}, 2),
    ([("a", 10, []), ("b", 10, [3])], {"n0": ["a-01", "a-02", "b-01"],
                                       "n1": [], "n2": ["b-04"]}, 3),
]


@pytest.mark.parametrize("spec,held,max_shard", PLAN_CASES)
def test_plan_campaign_byte_equal_and_invariant(spec, held, max_shard):
    from torch_campaign_invariant import check_campaign_invariant
    ref = RK.plan_campaign(_cohorts(RK, RQ, spec), _summaries(RC, held),
                           throttle=7, status=STATUS,
                           max_shard_units=max_shard)
    port = check_campaign_invariant(_cohorts(TK, TQ, spec),
                                    _summaries(TC, held), throttle=7,
                                    status=STATUS, max_shard_units=max_shard)
    assert port.to_json() == ref.to_json()
    assert port.est_local_fraction() == ref.est_local_fraction()


def test_admission_throttle_and_version_check_equal(tmp_path):
    for status, mb, req in [(None, 10, 50), ({"disk_free_gb": 0.0}, 1, 9),
                            ({"disk_free_gb": 1.0}, 2**20, 100),
                            ({"disk_free_gb": 1e-6}, 2**30, 5)]:
        assert TK.admission_throttle(status, mb, req) == \
            RK.admission_throttle(status, mb, req)
    bad = {"version": TK.CAMPAIGN_VERSION + 1}
    with pytest.raises(ValueError, match="campaign version"):
        TK.CampaignPlan.from_dict(bad)


def test_one_scorer_for_grants_and_admission():
    # the queue re-exports the placement scorer the planner uses: admission
    # and grant ranking are one function in the port as in the reference
    assert TQU.best_node is TPL.best_node is TK.best_node
    assert TQU.unit_local_bytes is TPL.unit_local_bytes is TK.unit_local_bytes


def test_summaries_from_queue(dataset):
    out = {}
    for side, (K, Q, C, W) in (("ref", (RK, RQ, RC, RQU)),
                               ("port", (TK, TQ, TC, TQU))):
        units = _units(Q, _dag_rows("a", 6))
        q = W.WorkQueue(units, ["n0", "n1"])
        q.put_summary("n0", {"v": 1, "full": _summaries(
            C, {"x": ["a-01", "a-02"]})["x"].to_wire()})
        out[side] = K.summaries_from_queue(q)
    assert out["port"] == out["ref"] and list(out["port"]) == ["n0"]
    # an address dials a live coordinator: the same wires over the socket
    from repro_torch.dist.rpc import QueueServer
    units = _units(TQ, _dag_rows("a", 6))
    q = TQU.WorkQueue(units, ["n0", "n1"])
    q.put_summary("n0", {"v": 1, "full": _summaries(
        TC, {"x": ["a-01", "a-02"]})["x"].to_wire()})
    with QueueServer(q) as srv:
        assert TK.summaries_from_queue(srv.addr_str) == out["ref"]


def test_lazy_exports_of_the_core_package():
    import repro_torch.core as core
    for name in ("CampaignPlan", "Cohort", "Shard", "admission_throttle",
                 "cohort_from_query", "plan_campaign",
                 "summaries_from_queue"):
        assert getattr(core, name) is getattr(TK, name)
    with pytest.raises(AttributeError):
        core.not_a_name


# R2 (ROADMAP.md, Queue 3): the reference's planner warm-places a DAG child
# whose parents went cold. n0 holds d0, so s00 goes warm to n0, and s02 (a
# child of s00) declares d1: d1 is then predicted on n0, and s03 — whose own
# parent s01 is cold — scores its d1 there. The port keeps the fault.
R2_HELD = {"n0": ["d0"]}
R2_COHORTS = [
    ("ds0", [("s00", {"d0": 1}, []), ("s01", {}, []),
             ("s02", {"d1": 0}, ["s00"]), ("s03", {"d1": 1}, ["s01"]),
             ("s04", {}, [])]),
    ("ds1", []),
    ("ds2", [("s00", {}, []), ("s01", {}, []), ("s02", {}, [])]),
]


def _r2(K, Q):
    cohorts = []
    for ds, spec in R2_COHORTS:
        units = []
        for subj, digs, deps in spec:
            names = {f"in{k}": d for k, d in enumerate(digs)}
            units.append(Q.WorkUnit(
                dataset=ds, subject=subj, session="01", pipeline="p",
                pipeline_digest="pd",
                inputs={k: f"{subj}-{k}.npy" for k in names},
                out_dir=f"/out/{ds}/{subj}", input_digests=names,
                input_bytes={k: digs[d] for k, d in names.items()},
                depends_on=[f"{ds}_p_sub-{d}_ses-01" for d in deps]))
        cohorts.append(K.Cohort(ds, "p", "pd", units, []))
    return cohorts


def test_r2_case_plans_byte_equal_to_the_reference():
    args = dict(throttle=1, status={"disk_free_gb": 0.0})
    ref = RK.plan_campaign(_r2(RK, RQ), _summaries(RC, R2_HELD), **args)
    port = TK.plan_campaign(_r2(TK, TQ), _summaries(TC, R2_HELD), **args)
    assert port.to_json() == ref.to_json()


@pytest.mark.xfail(strict=True, raises=AssertionError,
                   reason="R2 (ROADMAP.md, Queue 3): the reference's planner "
                          "warm-places ds0_p_sub-s03_ses-01 with cold "
                          "parents, and the port keeps its plan byte-equal")
def test_r2_minimal_case_breaks_the_invariant():
    from torch_campaign_invariant import check_campaign_invariant
    check_campaign_invariant(_r2(TK, TQ), _summaries(TC, R2_HELD),
                             throttle=1, status={"disk_free_gb": 0.0})


_POOL = [f"d{i}" for i in range(12)]


@st.composite
def _campaign_case(draw):
    """Random campaign inputs as plain rows (the reference's hypothesis
    strategy in ``test_property.py``, drawn once for both packages)."""
    cohorts = []
    for c in range(draw(st.integers(1, 3))):
        rows = []
        for i in range(draw(st.integers(0, 8))):
            digs = draw(st.lists(st.sampled_from(_POOL), max_size=2,
                                 unique=True))
            size = draw(st.integers(0, 1 << 16))
            rows.append(dict(
                dataset=f"ds{c}", subject=f"s{i:02d}", session="01",
                pipeline="p", pipeline_digest="pd",
                inputs={f"in{k}": f"{i}-{k}.npy" for k in range(len(digs))},
                out_dir=f"/out/ds{c}/{i}",
                input_digests={f"in{k}": d for k, d in enumerate(digs)},
                input_bytes={f"in{k}": size for k in range(len(digs))}))
        for i in range(1, len(rows)):
            ps = draw(st.lists(st.integers(0, i - 1), max_size=2,
                               unique=True))
            rows[i]["depends_on"] = [f"ds{c}_p_sub-s{p:02d}_ses-01"
                                     for p in ps]
        excl = [f"s{draw(st.integers(0, 9)):02d}"
                for _ in range(draw(st.integers(0, 3)))]
        cohorts.append((f"ds{c}", rows, excl))
    if draw(st.booleans()):
        cohorts.append(cohorts[0])
    held = {f"n{n}": draw(st.lists(st.sampled_from(_POOL), max_size=6,
                                   unique=True))
            for n in range(draw(st.integers(0, 3)))}
    throttle = draw(st.integers(1, 64))
    status = {"disk_free_gb": draw(st.floats(0.0, 64.0, allow_nan=False))}
    max_shard = draw(st.one_of(st.none(), st.integers(1, 4)))
    return cohorts, held, throttle, status, max_shard


def _build(K, Q, cohorts):
    return [K.Cohort(ds, "p", "pd", _units(Q, rows),
                     [Q.Exclusion(s, "01", "x") for s in excl])
            for ds, rows, excl in cohorts]


def _verdict(check, *args, **kw):
    try:
        return check(*args, **kw).to_json(), None
    except AssertionError as e:
        return None, str(e)


@given(_campaign_case())
@settings(max_examples=40, deadline=None)
def test_port_planner_keeps_the_invariant_where_the_reference_does(case):
    """The port's plan is byte-equal to the reference's on random cohorts
    and summaries, and the invariant check gives the same verdict on both:
    it passes wherever the reference's passes, and where the reference's
    fails (R2) the port's fails with the same message."""
    from campaign_invariant import check_campaign_invariant as ref_check
    from torch_campaign_invariant import check_campaign_invariant as port_check
    cohorts, held, throttle, status, max_shard = case
    kw = dict(throttle=throttle, status=status, max_shard_units=max_shard)
    ref = _verdict(ref_check, _build(RK, RQ, cohorts), _summaries(RC, held),
                   **kw)
    port = _verdict(port_check, _build(TK, TQ, cohorts),
                    _summaries(TC, held), **kw)
    assert port == ref
    plan_r = RK.plan_campaign(_build(RK, RQ, cohorts), _summaries(RC, held),
                              **kw)
    plan_t = TK.plan_campaign(_build(TK, TQ, cohorts), _summaries(TC, held),
                              **kw)
    assert plan_t.to_json() == plan_r.to_json()
