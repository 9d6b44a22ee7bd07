"""Full paper workflow (Fig. 3) on the PyTorch port: tiered storage,
multiple pipelines run by the parallel pipelined executor (workers=2, input
prefetch), fault injection + retry, straggler speculation, cold archival,
cost accounting. Runs on the GPU; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/torch_process_dataset.py [--device cpu]
"""
import argparse
import tempfile
from pathlib import Path

from repro_torch.core import (LocalRunner, TieredStore, builtin_pipelines,
                              generate_jobs, paper_table1, resource_status,
                              synthesize_dataset)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

with tempfile.TemporaryDirectory() as td:
    td = Path(td)
    ds = synthesize_dataset(td / "archive", "MASIVar-mini", n_subjects=3,
                            sessions_per_subject=2, shape=(16, 16, 16))
    store = TieredStore(td / "tiers")
    print("resource status:", resource_status(td))

    flaky = {"left": 2}

    def chaos(unit, attempt):      # two injected node failures
        if flaky["left"] > 0 and attempt == 1:
            flaky["left"] -= 1
            raise RuntimeError("injected node failure")

    pipes = builtin_pipelines(args.device)
    for name in ("bias_correct", "affine_register", "segment_unest"):
        pipe = pipes[name]
        plan = generate_jobs(ds, pipe, td / "jobs" / name)
        runner = LocalRunner(pipe, ds.root, max_retries=2, fault_hook=chaos,
                             workers=2)        # parallel pipelined executor
        results = runner.run(plan.units)
        ok = sum(r.status == "ok" for r in results)
        retried = sum(r.attempts > 1 for r in results if r.status == "ok")
        print(f"{name:16s}: {ok}/{len(plan.units)} ok "
              f"({retried} recovered by retry), "
              f"excluded CSV: {plan.exclusion_csv}")

    # nightly archival to the Glacier-style cold tier
    derivs = list((Path(ds.root) / "derivatives").rglob("*.npy"))[:4]
    for d in derivs:
        store.put(d, f"backup/{d.name}", tier="hot")
        store.archive_to_cold(f"backup/{d.name}")
    print(f"archived {len(derivs)} derivatives to cold tier; "
          f"yearly storage cost: {store.storage_cost_per_year()}")

    print("\npaper Table 1 reproduction:")
    for env, row in paper_table1().items():
        print(f"  {env:6s}: ${row['total_cost']:>5.2f} total, "
              f"{row['throughput_gbps']} Gb/s, {row['latency_ms']} ms")
