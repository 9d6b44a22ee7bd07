"""Shared by ``tests/`` and ``bench/``: under pytest-xdist, each worker's
torch intra-op pool gets its share of the cores, so the workers together
run no more threads than the machine has cores."""
import os


def pytest_configure(config):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        import torch
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
