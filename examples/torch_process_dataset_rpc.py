"""Networked cluster processing on the PyTorch port: the coordinator serves
its WorkQueue over a TCP JSON-lines socket, its own nodes talk to it through
the same client a remote machine would use, and a genuinely separate worker
*process* (``python -m repro_torch.dist.rpc work``) dials in, registers,
steals work, and commits to shared storage — with every host serving
repeated inputs from its content-addressed cache instead of shared storage
(watch ``cache_hit`` flip to True on re-runs). Runs on the GPU, the worker
process too; ``--device cpu`` runs both on the CPU.

    PYTHONPATH=src python examples/torch_process_dataset_rpc.py [--device cpu]
"""
import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path

from repro_torch.core import (Provenance, builtin_pipelines,
                              query_available_work, synthesize_dataset)
from repro_torch.dist import ClusterRunner

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

with tempfile.TemporaryDirectory() as td:
    td = Path(td)
    ds = synthesize_dataset(td / "ds", "MASIVar-rpc", n_subjects=10,
                            sessions_per_subject=2, shape=(16, 16, 16))
    pipe = builtin_pipelines(args.device)["bias_correct"]
    units, _ = query_available_work(ds, pipe)
    print(f"work query: {len(units)} units")

    def run_once(tag):
        runner = ClusterRunner(pipe, ds.root, nodes=2, transport="rpc",
                               poll_s=0.03, cache_dir=td / "host-cache")
        got = {}
        t = threading.Thread(target=lambda: got.update(
            r=runner.run(query_available_work(ds, pipe)[0])))
        t.start()
        while runner.server is None and t.is_alive():
            time.sleep(0.01)

        # one worker host in its own process: joins via the CLI entrypoint,
        # with its own input cache (REPRO_CACHE_DIR) like a real machine
        env = dict(os.environ,
                   PYTHONPATH="src" + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   REPRO_CACHE_DIR=str(td / "ext-cache"))
        device = ["--device", args.device] if args.device else []
        worker = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.dist.rpc", "work",
             "--addr", runner.server.addr_str, "--pipeline", pipe.name,
             "--data-root", str(ds.root), "--node-id", "ext-host", *device],
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        t.join()
        print(f"[{tag}] worker process said: {worker.communicate()[0].strip()}")
        results = got["r"]
        counts = Counter(r.status for r in results)
        st = runner.stats
        hits = sum(1 for u in units
                   if Provenance.load(Path(u.out_dir)).cache_hit)
        print(f"[{tag}] {counts['ok']}/{len(units)} ok "
              f"(+{counts.get('speculative', 0)} speculative) · "
              f"processed {st.processed} · remote nodes {st.remote_nodes}")
        print(f"[{tag}] coordinator-host cache: {st.cache} · "
              f"{hits} commits stamped cache_hit=True")
        assert counts["ok"] == len(units)

    run_once("cold")
    # wipe derivatives but keep the host caches: the re-run's inputs never
    # touch shared storage — this is the repeated-cohort path the per-host
    # cache exists for
    shutil.rmtree(Path(ds.root) / "derivatives")
    run_once("warm")
