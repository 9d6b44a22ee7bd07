"""The port's work queue against the JAX package's: the same scripted and
seeded-random sequences of grants, steals, completions, renewals,
speculation, summary pushes, deaths and reaps give equal answers at every
step and an equal compacted state."""
import dataclasses
import json

import numpy as np
import pytest

import repro.core.campaign as RK
import repro.core.query as RQ
import repro.dist.cache as RC
import repro.dist.queue as RW
import repro_torch.core.campaign as TK
import repro_torch.core.query as TQ
import repro_torch.dist.cache as TC
import repro_torch.dist.queue as TW

SIDES = {"ref": (RQ, RC, RW, RK), "port": (TQ, TC, TW, TK)}
POOL = [f"{i:064x}" for i in range(10)]


def _rows(n, dag=False):
    rows = []
    for i in range(n):
        digs = {"T1w": POOL[i % len(POOL)], "dwi": POOL[(3 * i + 1) % 10]} \
            if i % 3 else {"T1w": POOL[i % len(POOL)]}
        rows.append(dict(
            dataset="ds", subject=f"{i:02d}", session="01", pipeline="p",
            pipeline_digest="pd", inputs={k: f"{i}-{k}.npy" for k in digs},
            out_dir=f"/out/{i}", input_digests=digs,
            input_bytes={k: 100 * (i + 1) + len(k) for k in digs},
            depends_on=([f"ds_p_sub-{i // 2:02d}_ses-01"]
                        if dag and i >= 2 and i % 2 == 0 else [])))
    return rows


def _norm(x):
    """Answers of either package in one comparable shape."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        if hasattr(x, "job_id"):
            return ("unit", x.job_id)
        return (type(x).__name__, _norm(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {str(k): _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


class _Side:
    def __init__(self, side, n, nodes, *, dag=False, plan_held=None,
                 **kw):
        Q, C, W, K = SIDES[side]
        self.C = C
        self.t = [1000.0]
        units = [Q.WorkUnit(**r) for r in _rows(n, dag)]
        plan = None
        if plan_held is not None:
            summ = {}
            for node, digs in plan_held.items():
                s = C.DigestSummary()
                for d in digs:
                    s.add(d)
                summ[node] = s
            plan = K.plan_campaign(
                [K.Cohort("ds", "p", "pd", units, [])], summ)
        self.q = W.WorkQueue(units, nodes, now=lambda: self.t[0],
                             lease_ttl_s=1.0, plan=plan, **kw)

    def wire(self, digests, full=True):
        if not full:
            return {"v": 1, "add": digests[:2], "drop": digests[2:3]}
        s = self.C.DigestSummary()
        for d in digests:
            s.add(d)
        return {"v": 1, "full": s.to_wire(), "digests": sorted(digests)}


def _views(q):
    return _norm([q.queue_depths(), q.done_status(), q.running(),
                  q.finished(), q.pending(), q.alive_nodes(),
                  q.stats_snapshot(), q.results_snapshot(),
                  q.summaries_snapshot(), q.active_leases(),
                  q._snapshot_state_locked()])


def _step(s, rng, nodes, held):
    """One random operation; returns its (normalized) answer."""
    q = s.q
    op = int(rng.integers(0, 12))
    n = nodes[int(rng.integers(0, len(nodes)))]
    if op <= 2:
        got = q.next_units(n, int(rng.integers(1, 3)))
        for _, lease in got:
            held.append(lease)
        return ("grant", _norm(got))
    if op == 3 and held:
        lease = held.pop(int(rng.integers(0, len(held))))
        st = ("ok", "ok", "failed", "skipped")[int(rng.integers(0, 4))]
        q.mark_started(lease.unit_idx)
        return ("complete", q.complete(
            lease.unit_idx, lease.node_id, st, speculative=lease.speculative,
            meta={"seconds": float(rng.integers(1, 9))}))
    if op == 4:
        digs = [POOL[int(i)] for i in rng.integers(0, 10, 4)]
        return ("summary", q.put_summary(n, s.wire(digs)))
    if op == 5:
        digs = [POOL[int(i)] for i in rng.integers(0, 10, 3)]
        return ("heartbeat", q.heartbeat(n, summary_delta=s.wire(
            digs, full=False)))
    if op == 6 and held:
        lease = held[int(rng.integers(0, len(held)))]
        epoch = lease.epoch + int(rng.integers(0, 2))
        return ("renew", q.renew(lease.unit_idx, lease.node_id, epoch))
    if op == 7:
        run = q.running()
        if run:
            return ("speculate", _norm(q.speculate(run[0][0])))
        return ("speculate", None)
    if op == 8:
        s.t[0] += float(rng.choice([0.3, 0.6, 1.5]))
        for m in nodes:
            if rng.random() < 0.7:
                q.heartbeat(m)
        return ("reap", q.reap())
    if op == 9 and rng.random() < 0.2 and n in q.queue_depths():
        return ("dead", q.mark_dead(n))
    if op == 10:
        return ("register", q.register(f"late-{int(rng.integers(0, 2))}",
                                       blob_addr="127.0.0.1:9"))
    if op == 11:
        return ("locate", q.locate_blobs(POOL[:4], node_id=n))
    return ("noop", None)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("shape", ["round_robin", "backlog", "plan", "dag"])
def test_random_operation_sequences_agree(seed, shape):
    nodes = ["n0", "n1", "n2"]
    kw = {"round_robin": {}, "backlog": {"partition": "backlog"},
          "plan": {"plan_held": {"n0": POOL[:3], "n1": POOL[5:7]}},
          "dag": {"dag": True}}[shape]
    sides = {k: _Side(k, 14, nodes, **kw) for k in SIDES}
    rngs = {k: np.random.default_rng(seed) for k in SIDES}
    held = {k: [] for k in SIDES}
    for _ in range(60):
        answers = {k: _step(sides[k], rngs[k], nodes + ["late-0"], held[k])
                   for k in SIDES}
        assert _norm(answers["port"]) == _norm(answers["ref"])
        assert _views(sides["port"].q) == _views(sides["ref"].q)
        # every unit retires exactly once, whatever the script did
        done = sides["port"].q.done_status()
        assert len(done) <= 14


def test_scripted_lease_steal_complete_reap():
    """The protocol in the queue's docstring, step by step: grants off each
    node's deque, a steal of the tail half, a straggler's twin, a death
    reaped with its leases requeued, and a zombie's late completion."""
    out = {}
    for side in SIDES:
        s = _Side(side, 9, ["a", "b"])
        q, log = s.q, []
        log.append(_norm(q.next_units("a", 2)))
        log.append(_norm(q.next_units("b", 5)))            # drains b
        log.append(_norm(q.next_units("b", 1)))            # steals from a
        q.mark_started(0)
        log.append(_norm(q.speculate(0)))                  # twin on b
        log.append(_norm(q.next_units("b", 1)))            # twin first
        s.t[0] += 2.0
        q.heartbeat("b")
        log.append(q.reap())                               # a dies
        log.append(_norm(q.next_units("b", 3)))
        q.complete(0, "a", "ok", meta={"seconds": 1.0})    # zombie: ignored
        q.complete(0, "b", "ok", speculative=True, meta={"seconds": 2.0})
        log.append(q.renew(1, "a", 1))                     # dead holder
        out[side] = (log, _views(q))
    assert out["port"] == out["ref"]
    json.dumps(out["port"])                                # JSON-safe


@pytest.mark.parametrize("bad", [{"v": 9}, "garbage", {"v": 1, "full": "x"},
                                 {"v": 1, "add": None, "drop": None}])
def test_hostile_summaries_fail_soft_alike(bad):
    out = {}
    for side in SIDES:
        q = _Side(side, 6, ["a", "b"]).q
        out[side] = (q.put_summary("a", bad), q.put_summary("ghost", bad),
                     _views(q))
    assert out["port"] == out["ref"]


def test_dag_cycle_rejected_alike():
    rows = _rows(3)
    rows[0]["depends_on"] = ["ds_p_sub-02_ses-01"]
    rows[2]["depends_on"] = ["ds_p_sub-00_ses-01"]
    msgs = []
    for side in SIDES:
        Q, _, W, _ = SIDES[side]
        with pytest.raises(ValueError) as e:
            W.WorkQueue([Q.WorkUnit(**r) for r in rows], ["a"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "cycle" in msgs[0]
