"""Multi-node burst processing on the PyTorch port: a 4-node in-process
cluster drains one work queue with work-stealing, survives an injected node
death via lease reaping, and speculates cross-node twins for stragglers —
all arbitrated down to exactly one ok provenance per image. Runs on the
GPU; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/torch_process_dataset_cluster.py [--device cpu]
"""
import argparse
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path

from repro_torch.core import (builtin_pipelines, query_available_work,
                              synthesize_dataset)
from repro_torch.dist import ClusterRunner

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

with tempfile.TemporaryDirectory() as td:
    ds = synthesize_dataset(Path(td), "MASIVar-cluster", n_subjects=12,
                            sessions_per_subject=2, shape=(16, 16, 16))
    pipe = builtin_pipelines(args.device)["bias_correct"]
    units, excluded = query_available_work(ds, pipe)
    print(f"work query: {len(units)} units, {len(excluded)} excluded")

    # one late-in-the-run unit straggles once (its speculative twin, the
    # second arrival, does not re-sleep and wins)
    slow = {"id": units[16].job_id, "n": 0}
    slow_lock = threading.Lock()

    def straggle(unit, attempt):
        if unit.job_id == slow["id"]:
            with slow_lock:
                first = slow["n"] == 0
                slow["n"] += 1
            if first:
                time.sleep(1.2)

    runner = ClusterRunner(pipe, ds.root, nodes=4,
                           die_after={"node-3": 2},      # node-3 crashes
                           lease_ttl_s=0.6, hb_interval_s=0.1,
                           straggler_factor=2.0, straggler_min_s=0.2,
                           fault_hook=straggle)
    t0 = time.time()
    results = runner.run(units)
    dt = time.time() - t0

    counts = Counter(r.status for r in results)
    st = runner.stats
    print(f"{counts['ok']}/{len(units)} ok in {dt:.2f}s "
          f"(+{counts.get('speculative', 0)} speculative duplicates)")
    print(f"per-node processed: {st.processed}")
    print(f"steals: {st.steals}  requeued after death: {st.requeued}  "
          f"dead: {st.dead_nodes}  twins launched: {st.speculated}")

    # a second submitter racing the (now finished) cluster sees zero work
    work2, excl2 = query_available_work(ds, pipe)
    print(f"re-query: {len(work2)} units remain; "
          f"{sum('digest match' in e.reason for e in excl2)} already processed")
    assert counts["ok"] == len(units)
