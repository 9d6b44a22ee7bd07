"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's ``repro_torch`` begins with ``repro``),
and the references import nothing of the port either."""
import ast
import sys
from pathlib import Path

import pytest

from bench import harness

BENCH = Path(__file__).resolve().parent
SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if not p.name.startswith("test_"))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and isinstance(
                node.args[0], (ast.Constant, ast.JoinedStr)):
            arg = node.args[0]
            yield arg.value if isinstance(arg, ast.Constant) else \
                "".join(v.value for v in arg.values
                        if isinstance(v, ast.Constant))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_reference_package(path):
    banned = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    if "reference" in path.parts or "counts" in path.parts:
        banned.add("repro_torch")
    for mod in _imports(path):
        assert mod.split(".")[0] not in banned, f"{path}: imports {mod}"


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"repro.core", "jaxlib"} <= set(harness.forbidden_modules())


def test_a_run_of_the_harness_loads_no_jax():
    import subprocess
    root = BENCH.parent
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from bench import harness\n"
            "for k in ('drivers', 'metrics'):\n"
            "    for p in sorted((harness.BENCH / k).glob('*.py')):\n"
            "        harness.load_module(k, p.stem)\n"
            "import repro_torch.serve, repro_torch.models\n"
            "print(harness.forbidden_modules())\n") % (str(root),
                                                      str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
