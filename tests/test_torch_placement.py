"""The port's placement scorer against the JAX package's: ``unit_local_bytes``,
``best_node``, ``best_peers`` and ``WarmSetIndex`` give equal scores and
rankings on the same seeded units and digest summaries."""
import numpy as np
import pytest

import repro.core.query as RQ
import repro.dist.cache as RC
import repro.dist.placement as RP
import repro_torch.core.query as TQ
import repro_torch.dist.cache as TC
import repro_torch.dist.placement as TP

NODES = ["n0", "n1", "n2", "n3"]


def _case(seed):
    """Seeded units (as plain rows) and per-node held digests."""
    rng = np.random.default_rng(seed)
    pool = [f"{i:064x}" for i in rng.integers(0, 2**62, 24)]
    rows = []
    for i in range(int(rng.integers(6, 14))):
        k = int(rng.integers(0, 4))
        digs = {f"s{j}": pool[int(rng.integers(0, len(pool)))]
                for j in range(k)}
        rows.append(dict(dataset="ds", subject=f"{i:02d}", session="01",
                         pipeline="p", pipeline_digest="pd",
                         inputs={s: f"sub-{i:02d}/{s}.npy" for s in digs},
                         out_dir=f"/out/{i}", input_digests=digs,
                         input_bytes={s: int(rng.integers(0, 5000))
                                      for s in digs}))
    held = {n: [pool[int(j)] for j in rng.integers(0, len(pool),
                                                   int(rng.integers(0, 9)))]
            for n in NODES}
    loads = {n: int(rng.integers(0, 3)) for n in NODES}
    return rows, held, loads


def _side(Q, C, rows, held, m=256, k=3):
    units = [Q.WorkUnit(**r) for r in rows]
    summaries = {}
    for n, digs in held.items():
        s = C.DigestSummary(m=m, k=k)
        for d in digs:
            s.add(d)
        summaries[n] = s
    return units, summaries


@pytest.mark.parametrize("seed", range(6))
def test_unit_local_bytes_and_best_node_equal(seed):
    rows, held, loads = _case(seed)
    ru, rs = _side(RQ, RC, rows, held)
    tu, ts = _side(TQ, TC, rows, held)
    for a, b in zip(ru, tu):
        for n in NODES:
            assert TP.unit_local_bytes(b, ts[n]) == \
                RP.unit_local_bytes(a, rs[n])
        assert TP.best_node(b, NODES, ts, loads) == \
            RP.best_node(a, NODES, rs, loads)
        assert TP.best_node(b, NODES, ts) == RP.best_node(a, NODES, rs)
    # a plain set is a summary too (the duck-typed surface)
    plain = {d for ds in held.values() for d in ds}
    assert [TP.unit_local_bytes(u, plain) for u in tu] == \
        [RP.unit_local_bytes(u, plain) for u in ru]
    assert TP.unit_local_bytes(tu[0], None) == 0


@pytest.mark.parametrize("seed", range(4))
def test_best_peers_equal(seed):
    rows, held, loads = _case(seed)
    _, rs = _side(RQ, RC, rows, held, m=64, k=2)     # small: false positives
    _, ts = _side(TQ, TC, rows, held, m=64, k=2)
    digests = sorted({d for r in rows for d in r["input_digests"].values()})
    for d in digests + ["absent"]:
        for limit in (None, 1, 3):
            assert TP.best_peers(d, NODES, ts, loads, limit=limit) == \
                RP.best_peers(d, NODES, rs, loads, limit=limit)


@pytest.mark.parametrize("seed", range(4))
def test_warm_set_index_equal_through_rebuild_add_discard(seed):
    rows, held, loads = _case(seed)
    ru, rs = _side(RQ, RC, rows, held)
    tu, ts = _side(TQ, TC, rows, held)
    ri, ti = RP.WarmSetIndex(ru, skip={1}), TP.WarmSetIndex(tu, skip={1})
    rng = np.random.default_rng(100 + seed)
    pool = sorted({d for r in rows for d in r["input_digests"].values()})

    def same():
        for n in NODES:
            assert dict(ti.scores(n)) == dict(ri.scores(n))
            for i in range(len(rows)):
                assert ti.score(n, i) == ri.score(n, i)
        for i in range(len(rows)):
            assert ti.best_node(i, NODES, loads) == \
                ri.best_node(i, NODES, loads)

    for j, n in enumerate(NODES):
        if j % 2:          # the Bloom probe: false positives and all
            ri.rebuild(n, rs[n]), ti.rebuild(n, ts[n])
        else:              # the exact digest list
            ri.rebuild(n, rs[n], digests=held[n])
            ti.rebuild(n, ts[n], digests=held[n])
    same()
    for _ in range(20):
        n = NODES[int(rng.integers(0, len(NODES)))]
        d = pool[int(rng.integers(0, len(pool)))] if pool else "x"
        op = ("add", "discard")[int(rng.integers(0, 2))]
        getattr(ri, op)(n, d), getattr(ti, op)(n, d)
        same()
    ri.drop_node("n0"), ti.drop_node("n0")
    same()
