"""The port's examples (``examples/torch_*.py``) on the CPU, each run as a
subprocess with ``--device cpu``, against the reference's example of the
same name run beside it (``JAX_PLATFORMS=cpu``).

Each output line is held to the reference's line after masking what a run
cannot repeat: seconds, temporary directories, the host's disk and load,
and in the cluster examples what thread timing decides (which node took
which unit, steals, speculative twins, whether the worker process joined
before the queue drained). What is left is compared exactly: unit counts,
exclusion reasons, provenance keys, retries, the per-node totals, the
archived derivatives' storage cost and ``paper_table1``. The pipeline's
digest is the port's own (its spec names the torch backend, so the two
packages' digests never collide): it is masked in the comparison and held
to ``builtin_pipelines("cpu")``'s digest.

``torch_serve_lm`` draws its weights from a torch generator, so its
tokens are not the reference's: their shapes and range are checked.
``torch_train_lm`` runs at 2 steps, the fewest at which its own loss
assert holds here (one step, the crash, the resume from the checkpoint
and one more step).
"""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "process_dataset", "process_dataset_cluster",
            "process_dataset_rpc")
TIMEOUT = 240

TMP = re.compile(r"[^\s'\"]*/tmp[a-z0-9_]{8}")
SECONDS = re.compile(r"\d+\.\d+s\b")
DIGEST = re.compile(r"digest [0-9a-f]{16}")


def _env(jax: bool):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        "OMP_NUM_THREADS": "1"}
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    return env


def _start(cmd, jax=False):
    return subprocess.Popen([sys.executable, *cmd], cwd=ROOT, env=_env(jax),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def outputs():
    """Every example's stdout, the reference's and the port's, all run at
    once."""
    procs = {}
    for name in EXAMPLES:
        procs["ref", name] = _start([f"examples/{name}.py"], jax=True)
        procs["port", name] = _start([f"examples/torch_{name}.py",
                                      "--device", "cpu"])
    procs["port", "serve_lm"] = _start(["examples/torch_serve_lm.py",
                                        "--device", "cpu"])
    procs["port", "train_lm"] = _start(["examples/torch_train_lm.py",
                                        "--steps", "2", "--device", "cpu"])
    for name in EXAMPLES + ("serve_lm", "train_lm"):
        procs["no device", name] = _start([f"examples/torch_{name}.py"])
    out = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            out[key] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _masked(name: str, line: str) -> str:
    line = SECONDS.sub("<s>", TMP.sub("<tmp>", DIGEST.sub("digest <d>",
                                                          line)))
    if line.startswith("resource status:"):
        return "resource status: " + repr(sorted(ast.literal_eval(
            line.split(":", 1)[1].strip())))
    if name == "process_dataset_cluster":
        if line.startswith("per-node processed:"):
            counts = ast.literal_eval(line.split(":", 1)[1].strip())
            return f"per-node processed: total {sum(counts.values())}"
        if line.startswith("steals:"):
            return "steals: " + line.split("dead:")[1].split("twins")[0]
        line = re.sub(r"\(\+\d+ speculative duplicates\)",
                      "(+<n> speculative duplicates)", line)
    if name == "process_dataset_rpc":
        m = re.match(r"(\[\w+\]) (worker process said|coordinator-host "
                     r"cache):", line)
        if m:
            return m.group(0)
        line = re.sub(r"\(\+\d+ speculative\).*", "", line)
    return line


def _lines(name, result):
    rc, stdout, stderr = result
    assert rc == 0, stderr[-4000:]
    return [_masked(name, x) for x in stdout.splitlines()]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_matches_the_reference(outputs, name):
    want = _lines(name, outputs["ref", name])
    got = _lines(name, outputs["port", name])
    assert got == want


def test_quickstart_prints_the_ports_digest(outputs):
    from repro_torch.core import builtin_pipelines
    digest = builtin_pipelines("cpu")["bias_correct"].digest()
    assert f"(digest {digest})" in outputs["port", "quickstart"][1]


def test_rpc_example_starts_the_ports_worker(outputs):
    """The worker process is the port's CLI, on the device asked for."""
    said = [x for x in outputs["port", "process_dataset_rpc"][1].splitlines()
            if "worker process said:" in x]
    assert len(said) == 2 and all("ext-host:" in x for x in said), said
    src = (ROOT / "examples" / "torch_process_dataset_rpc.py").read_text()
    assert '"-m", "repro_torch.dist.rpc", "work"' in src


def test_serve_lm_tokens(outputs):
    from repro_torch.configs import get_config
    rc, stdout, stderr = outputs["port", "serve_lm"]
    assert rc == 0, stderr[-4000:]
    lines = stdout.splitlines()
    assert [x.split()[0] for x in lines] == ["llama3.2-1b", "rwkv6-1.6b",
                                             "zamba2-1.2b"]
    for line in lines:
        arch, rest = line.split(" generated: ")
        toks = ast.literal_eval(rest)
        vocab = get_config(arch.strip()).reduced().vocab_size
        assert len(toks) == 2 and all(len(t) == 8 for t in toks)
        assert all(0 <= v < vocab for t in toks for v in t)


def test_train_lm_resumes_and_reduces_the_loss(outputs):
    rc, stdout, stderr = outputs["port", "train_lm"]
    assert rc == 0, stderr[-4000:]
    assert "resumed from step 1" in stdout
    assert stdout.splitlines()[-1] == "OK"


@pytest.mark.parametrize("name", EXAMPLES + ("serve_lm", "train_lm"))
def test_example_needs_the_card_without_device_cpu(outputs, name):
    """Without ``--device cpu`` (and with no card) an example stops with
    the port's device error, never on the CPU quietly; none imports JAX or
    the JAX package."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    rc, _, stderr = outputs["no device", name]
    assert rc != 0 and "CUDA is not available" in stderr, stderr[-2000:]
    src = (ROOT / "examples" / f"torch_{name}.py").read_text()
    assert not re.search(r"^\s*(import|from) (jax|repro)\b", src, re.M)
