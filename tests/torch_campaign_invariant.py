"""The campaign-planner invariant of ``campaign_invariant.py``, run on the
port's planner (``repro_torch.core.campaign``): the same body, importing the
port. ``test_torch_campaign.py`` drives it over a deterministic grid and
under hypothesis, holding every plan byte-equal to the JAX package's."""
import tempfile
from pathlib import Path


def reference_admitted(cohorts):
    """Independent model of admission: first cohort to admit a job_id wins;
    a session its own cohort excluded is never admitted by that cohort."""
    admitted, seen = [], set()
    for c in cohorts:
        excl = {(e.subject, e.session) for e in c.excluded}
        for u in c.units:
            if (u.subject, u.session) in excl or u.job_id in seen:
                continue
            seen.add(u.job_id)
            admitted.append(u.job_id)
    return admitted


def check_campaign_invariant(cohorts, summaries, throttle=100, status=None,
                             max_shard_units=None):
    """For the given cohorts and summary state: every admitted unit is
    assigned to exactly one shard, no excluded unit is ever assigned, the
    plan is structurally sound (no empty shards, submittable throttle, warm
    shards only name summary-backed nodes), and replanning — in memory and
    through a serialized ``campaign.json`` — is byte-identical.

    DAG cohorts additionally check **producer placement**: a child whose
    parents were all planned onto one node, and whose own input digests are
    invisible to every *real* summary (they are predicted parent outputs,
    not yet on any disk), must be planned onto that same node — its
    parents' placement *is* its locality. Children whose parents went cold
    carry no prediction and must stay cold like any blind unit."""
    from repro_torch.core.campaign import (CampaignPlan,
                                           _normalize_summaries,
                                           plan_campaign)

    plan = plan_campaign(cohorts, summaries, throttle=throttle,
                         status=status, max_shard_units=max_shard_units)
    assigned = plan.assigned_unit_ids()
    # exactly once, and exactly the reference admission set
    assert len(assigned) == len(set(assigned))
    assert sorted(assigned) == sorted(reference_admitted(cohorts))
    # structural sanity
    assert all(s.unit_ids for s in plan.shards)
    assert plan.throttle >= 1
    assert all(s.node_id is None or s.node_id in plan.nodes
               for s in plan.shards)
    if max_shard_units:
        assert all(len(s.unit_ids) <= max_shard_units for s in plan.shards)
    # producer placement, against an independent reading of the inputs
    decoded = _normalize_summaries(summaries)
    units_by_id = {}
    for c in cohorts:
        for u in c.units:
            units_by_id.setdefault(u.job_id, u)
    node_of = {jid: s.node_id for s in plan.shards for jid in s.unit_ids}
    for jid in assigned:
        u = units_by_id[jid]
        deps = [d for d in (getattr(u, "depends_on", None) or ())
                if d in node_of]
        digests = set((u.input_digests or {}).values())
        scoreable = sum((u.input_bytes or {}).get(s, 0)
                        for s in (u.input_digests or {}))
        if not deps or not digests or scoreable <= 0:
            continue          # nothing to score: cold is the right answer
        if any(d in s for d in digests for s in decoded.values()):
            continue          # real warmth somewhere may legitimately win
        parent_nodes = {node_of[d] for d in deps}
        if parent_nodes == {None}:
            # parents went cold: no prediction, the child must stay blind
            assert node_of[jid] is None, \
                f"{jid} warm-placed with cold parents"
        elif len(parent_nodes) == 1:
            (pn,) = parent_nodes
            assert node_of[jid] == pn, \
                (f"{jid} planned on {node_of[jid]}, parents' outputs land "
                 f"on {pn}")
    # determinism + byte-identical replay through disk
    again = plan_campaign(cohorts, summaries, throttle=throttle,
                          status=status, max_shard_units=max_shard_units)
    assert again.to_json() == plan.to_json()
    with tempfile.TemporaryDirectory() as td:
        p = plan.save(Path(td) / "campaign.json")
        assert CampaignPlan.load(p).to_json() == plan.to_json()
    return plan
