import os
import time

import numpy as np
import pytest

# Hypothesis settings profiles, selected via HYPOTHESIS_PROFILE (default
# "dev"). Both print the reproduction blob on failure so a property-test
# counterexample can be replayed locally; "ci" additionally relaxes the
# per-example deadline (shared runners stall unpredictably — a slow example
# is not a flaky failure) and prints statistics for triage. CI uploads the
# .hypothesis example database as an artifact on failure, so the shrunk
# counterexample survives the runner.
try:
    from hypothesis import settings
    settings.register_profile("dev", print_blob=True)
    settings.register_profile("ci", print_blob=True, deadline=None,
                              derandomize=False)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "dev"))
except ImportError:  # hypothesis-free environments still run the rest
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: chaos/socket acceptance tests — excluded from the fast "
        "tier-1 job (-m 'not slow'), always run in the cluster matrix rows")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels); "
        "skips with a reason elsewhere")


def wait_until(predicate, timeout: float = 10.0, interval: float = 0.02,
               desc: str = "condition"):
    """Bounded poll: the deflaked replacement for fixed ``time.sleep`` waits
    in timing-sensitive tests (reap/renew TTL races). Returns as soon as
    ``predicate()`` is truthy; a loaded runner just polls longer instead of
    failing, and a genuinely broken condition fails loudly at ``timeout``
    instead of passing by luck."""
    deadline = time.monotonic() + timeout
    while True:
        got = predicate()
        if got:
            return got
        if time.monotonic() >= deadline:
            raise AssertionError(f"timed out after {timeout}s waiting for "
                                 f"{desc}")
        time.sleep(interval)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
