"""Sharded serving in the port: ``serve_batch(mesh=)`` through the mesh
prefill and decode steps on gloo ranks on the CPU, against the port's own
one-process ``serve_batch`` and against the JAX package's sharded steps.

``torch_serve_ranks.group_serve`` runs, on (1, 2), (1, 4) and (2, 2)
('data', 'model') meshes, llama3.2-1b, zamba2-1.2b, rwkv6-1.6b,
moonshot-v1-16b-a3b, whisper-small and internvl2-76b at 2 layers (vocab
128, f32 compute and cache), on the JAX package's params carried across by
``from_jax``: 4 prompts of 22, 23 and 20 tokens and 9, 9 and 10 new
tokens, so that 'model' divides the prefill's cache and not the decode
cache's, the other way round, and both. The weights are placed by
``state_specs``, the caches by ``cache_specs`` (their sequence over
``cache_seq``; whisper's 64 frames split at tp 2 and 4). On (2, 2) also:

  * the "long" rules (batch 1 replicated, the cache's sequence over all
    four ranks) for h2o-danube-1.8b with its window cut to 16 and a
    24-token prompt (the ring has wrapped: every slot valid, its owner
    rank at ``pos % 24``), zamba2 and rwkv6;
  * the JAX package's own sharded steps (``torch_serve_ref.py``:
    ``make_prefill_step`` / ``make_decode_step`` jitted under
    ``use_rules(Rules(mesh (2, 2), "prefill" | "decode"))`` on 4 XLA CPU
    devices) for llama3.2-1b, rwkv6-1.6b and zamba2-1.2b;
  * the broken controls: the decode combine dropped (each rank's partial
    softmax taken alone) must fail the logits check; Mamba-2's gated norm
    must not run K4 on a rank's part of ``d_inner`` (K4 runs once a layer
    where the one-process run has it twice), and doing so must fail it.

Tolerances and why: the logits of the prefill and of every decode step
within 1e-5 relative to the largest |logit| of the one-process run (or of
the reference's), f32: the sums run in other orders (the row-parallel
partial sums, the combine over the cache's slices, the vocab-parallel
head); tokens equal. Every rank's weight and cache shards hold exactly
their spec's elements (``_local_tensor``).
"""
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from torch_ranks import SRC, run_ranks
from torch_serve_ranks import CASES, LONG
from torch_serve_ref import ARCHS as REF_ARCHS
from torch_serve_ref import MESHES

HERE = Path(__file__).resolve().parent
TOL = 1e-5


@pytest.fixture(scope="module")
def params():
    out = {}
    for arch in dict.fromkeys(CASES + tuple(LONG)):
        cfg = jax_get_config(arch).reduced(n_layers=2, vocab_size=128)
        out[arch] = jax.tree.map(np.asarray, jax_init_params(
            cfg, jax.random.PRNGKey(0), jnp.float32))
    return out


@pytest.fixture(scope="module")
def runs(params, tmp_path_factory):
    """Each mesh's ranks' results, one spawn a mesh, and the reference's
    logits and tokens from its subprocess, which runs beside them."""
    path = tmp_path_factory.mktemp("serve_ref") / "ref.pkl"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep
           .join([str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")])}
    with subprocess.Popen([sys.executable, str(HERE / "torch_serve_ref.py"),
                           str(path)], env=env, stderr=subprocess.PIPE,
                          text=True) as proc:
        try:
            got = {shape: run_ranks(math.prod(shape),
                                    "torch_serve_ranks:group_serve",
                                    {"shape": shape, "params": params},
                                    timeout=240)
                   for shape in MESHES}
            err = proc.communicate(timeout=300)[1]
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, err[-4000:]
    with open(path, "rb") as f:
        return got, pickle.load(f)


def _check(results):
    for rank, r in enumerate(results):
        assert r["tokens_equal"], (rank, r["tokens"])
        assert r["err"] <= TOL, (rank, r["err"])
        assert r["bad"] == [], (rank, r["bad"])
    assert all(np.array_equal(r["tokens"], results[0]["tokens"])
               for r in results)


@pytest.mark.parametrize("shape", list(MESHES))
@pytest.mark.parametrize("arch", CASES)
def test_mesh_serving_matches_one_process(runs, shape, arch):
    results = [r[arch] for r in runs[0][shape]]
    _check(results)
    assert results[0]["steps"] == MESHES[shape][1]


@pytest.mark.parametrize("arch", list(LONG))
def test_long_rules_match_one_process(runs, arch):
    _check([r["long", arch] for r in runs[0][(2, 2)]])


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_mesh_serving_matches_the_reference_sharded(runs, arch):
    """Rank 0's logits on (2, 2) against the JAX package's sharded steps
    on 4 XLA devices, same params, same prompts."""
    got, ref = runs[0][(2, 2)][0][arch], runs[1][arch]
    assert np.array_equal(got["tokens"], ref["tokens"])
    assert len(got["logits"]) == len(ref["logits"])
    for g, w in zip(got["logits"], ref["logits"]):
        assert np.max(np.abs(g - w)) / np.max(np.abs(w)) <= TOL


def test_dropped_combine_fails(runs):
    """Each rank's partial softmax over its slice of the cache, not joined
    across the ranks: the decode logits leave the bound."""
    for r in runs[0][(2, 2)]:
        assert r["no_combine"]["err"] > 100 * TOL, r["no_combine"]["err"]


def test_gated_norm_does_not_run_k4_on_a_part(runs):
    """On (2, 2) Mamba-2's gated norm takes its moment over both ranks'
    shares of ``d_inner``: K4 (``mamba2.rmsnorm``) runs for the layer
    norm alone, half the one-process run's calls; K4 on the rank's part
    instead leaves the bound."""
    for r in runs[0][(2, 2)]:
        calls = r["mamba_k4_calls"]
        assert calls["mesh"] * 2 == calls["one"], calls
        assert r["norm_on_part"]["err"] > 100 * TOL, r["norm_on_part"]
