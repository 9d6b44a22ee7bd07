"""Run a function on N gloo ranks of the port, one OS process a rank, on the
CPU, for the multi-rank tests (``test_torch_collectives.py``,
``test_torch_mesh_train.py``).

    results = run_ranks(4, "torch_mesh_ranks:group_four", {"ckpt": "..."})

Each rank runs ``python torch_ranks.py`` with ``MASTER_ADDR=127.0.0.1`` and
a free port, joins a gloo process group, calls ``module.function(rank,
world, **kwargs)`` with one intra-op thread, and pickles what it returns.
Every wait has a time limit, and a rank that fails (or is killed at the
limit) fails the caller with its stderr.
"""
import os
import pickle
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, target: str, kwargs=None, timeout: float = 120):
    """``target`` ("module:function", a module beside this file) on
    ``world`` gloo ranks; returns each rank's result, by rank."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "args.pkl").write_bytes(pickle.dumps(kwargs or {}))
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(free_port()), "WORLD_SIZE": str(world),
               "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(
                   [str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")])}
        procs = []
        for rank in range(world):
            err = open(tmp / f"err{rank}", "w+")
            procs.append((subprocess.Popen(
                [sys.executable, str(Path(__file__)), target, str(tmp)],
                env={**env, "RANK": str(rank)}, stdout=err,
                stderr=subprocess.STDOUT), err))
        failed = []
        for rank, (p, err) in enumerate(procs):
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q, _ in procs:
                    q.kill()
                p.wait()
            if p.returncode != 0:
                err.seek(0)
                failed.append(f"rank {rank} exited {p.returncode}:\n"
                              f"{err.read()[-6000:]}")
            err.close()
        for q, _ in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
        assert not failed, "\n".join(failed)
        return [pickle.loads((tmp / f"out{r}.pkl").read_bytes())
                for r in range(world)]


def _main():
    import importlib

    import torch
    import torch.distributed as dist
    target, tmp = sys.argv[1], Path(sys.argv[2])
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world)
    try:
        mod, fn = target.split(":")
        kwargs = pickle.loads((tmp / "args.pkl").read_bytes())
        out = getattr(importlib.import_module(mod), fn)(rank, world,
                                                        **kwargs)
        (tmp / f"out{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()
