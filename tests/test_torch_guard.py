"""Guards of the PyTorch port: it imports no JAX and nothing of ``repro``,
its entry points default to CUDA and refuse to run without it, and its
pipeline digests never collide with the JAX package's."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import resolve_device

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and"
        " (m == 'repro' or m.startswith('repro.') or m.startswith('jax'))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_source_imports_no_jax_and_no_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_pipeline_digests_differ_from_reference():
    from repro.core.pipelines import builtin_pipelines as ref_pipelines
    from repro_torch.core.pipelines import builtin_pipelines
    ref = ref_pipelines()
    port = builtin_pipelines("cpu")
    assert set(port) == set(ref)
    for name, pipe in port.items():
        assert pipe.spec.config["backend"] == "torch"
        assert pipe.digest() != ref[name].digest(), name
        assert pipe.spec.required_suffixes == ref[name].spec.required_suffixes


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path):
    from repro_torch.core import builtin_pipelines, ingest_directory
    from repro_torch.kernels.checksum import QAChecksumAccumulator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: builtin_pipelines(),
                 lambda: ingest_directory(tmp_path, tmp_path / "b", "ds"),
                 lambda: QAChecksumAccumulator(4, np.float32)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    # the host fold needs no device at all
    assert QAChecksumAccumulator(4, np.float32, backend="host").device is None


def test_model_and_serve_entry_points_default_to_cuda(monkeypatch):
    """``init_params``, ``init_cache`` and ``serve_batch`` with no device
    mean ``cuda``, and raise without a card rather than place weights or
    caches on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.layers import normal_init
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("zamba2-1.2b").reduced()
    for call in (lambda: init_params(cfg, torch.Generator()),
                 lambda: normal_init(torch.Generator(), (2, 2)),
                 lambda: init_cache(cfg, 1, 8),
                 lambda: serve_batch("rwkv6-1.6b", np.zeros((1, 4), int))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    p = init_params(cfg, torch.Generator(), device="cpu")
    assert p["embed"]["tok"].device == torch.device("cpu")


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for a CPU tensor; any other
    device launches the kernel or raises, never falls back."""
    from repro_torch.kernels.checksum import device_checksum, qa_checksum
    x = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        qa_checksum(x)
    with pytest.raises(ValueError, match="unsupported device"):
        device_checksum(x)


def test_package_exports():
    assert repro_torch.__version__
    from repro_torch import core
    for name in core.__all__:
        assert hasattr(core, name), name
    assert "TPU_ENVS" not in core.__all__


_NO_JAX = (
    "import sys, runpy, importlib\n"
    "sys.modules['jax'] = None\n"
    "{body}\n"
    "bad = [m for m, v in sys.modules.items() if v is not None and"
    " (m == 'repro' or m.startswith('repro.') or m.startswith('jax'))]\n"
    "assert not bad, bad\n")


@pytest.mark.parametrize("module", ["repro_torch.dist.rpc",
                                    "repro_torch.dist.blobserve",
                                    "repro_torch.dist.faults",
                                    "repro_torch.launch.env"])
def test_socket_slice_modules_import_no_jax_and_no_reference(module):
    """The socket half of ``dist/`` and the env profile, each imported
    alone in a fresh interpreter: no ``jax``, nothing of ``repro``."""
    code = _NO_JAX.format(body=f"importlib.import_module({module!r})")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr


def test_worker_cli_help_imports_no_jax_and_no_reference():
    """``python -m repro_torch.dist.rpc --help``, as a worker host would
    first run it, with the import guard checked at exit."""
    code = _NO_JAX.format(body=(
        "sys.argv = ['rpc', '--help']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.dist.rpc', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert "serve" in out.stdout and "work" in out.stdout


@pytest.mark.parametrize("module", ["repro_torch.dist.sharding",
                                    "repro_torch.dist.collectives",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.launch.specs",
                                    "repro_torch.launch.train",
                                    "repro_torch.launch.slurm"])
def test_distribution_slice_modules_import_no_jax_and_no_fake_group(module):
    """The sharding, collectives, mesh, specs and launcher modules, each
    imported alone: no ``jax``, nothing of ``repro``, and no
    ``torch.testing`` fake process group (``placeholder_mesh`` imports it
    when called)."""
    code = _NO_JAX.format(body=(
        f"importlib.import_module({module!r})\n"
        "assert not [m for m in sys.modules if m.startswith("
        "'torch.testing._internal.distributed')]"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", ["repro_torch.dist.rpc",
                                    "repro_torch.launch.env"])
def test_cli_modules_do_not_load_dtensor(module):
    """``python -m repro_torch.dist.rpc`` and ``python -m
    repro_torch.launch.env`` stay light: the packages load ``sharding``,
    ``collectives`` and ``mesh`` only when one of their names is asked
    for."""
    code = _NO_JAX.format(body=(
        f"importlib.import_module({module!r})\n"
        "assert 'torch.distributed.tensor' not in sys.modules\n"
        "import repro_torch.dist as d, repro_torch.launch as l\n"
        "assert d.Rules and d.compressed_psum and l.make_local_mesh\n"
        "assert 'repro_torch.dist.sharding' in sys.modules\n"
        "assert 'repro_torch.launch.mesh' in sys.modules"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr


def test_dist_and_launch_exports():
    from repro_torch import dist, launch
    for pkg in (dist, launch):
        for name in pkg.__all__:
            assert getattr(pkg, name) is not None, name
    for name in ("Rules", "param_specs", "shardings_for", "constrain",
                 "compressed_psum", "compressed_tree_psum"):
        assert name in dist.__all__
    for name in ("make_production_mesh", "make_local_mesh"):
        assert name in launch.__all__
