"""Lazy ``nvcc`` builder for the port's CUDA C++ kernels.

Each kernel source under ``kernels/*/csrc/`` compiles into its own shared
library with a plain C interface (``nvcc -gencode arch=compute_90a,
code=sm_90a -O3 -shared -Xcompiler -fPIC``), loaded with ``ctypes``. Nothing
builds at import: the first wrapper call on a CUDA tensor builds, and the CPU
tests never do. Libraries land in ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads at once.
``build_all`` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"

# library name -> its CUDA source
SOURCES: Dict[str, Path] = {
    "checksum": _PKG / "checksum" / "csrc" / "checksum.cu",
    "rmsnorm": _PKG / "rmsnorm" / "csrc" / "rmsnorm.cu",
    "flash_attention": _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "mamba2_ssd": _PKG / "mamba2_ssd" / "csrc" / "mamba2_ssd.cu",
    "rwkv6": _PKG / "rwkv6" / "csrc" / "rwkv6.cu",
}

# no --use_fast_math and no -ftz: the checksum kernels keep subnormals, and
# rmsnorm, the SSD scan and flash attention's f32 kernel keep accurate
# sqrtf, division and expf. Flash attention's bf16 kernel and the WKV scan
# ask for their one fast instruction themselves (ex2.approx of x log2(e):
# last bits only, where flash attention rounds its weights to bf16 and the
# WKV scan holds 1e-4). No -lcuda: it takes cuTensorMapEncodeTiled from
# libcuda at run time.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def _target(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    out = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    with open(log, "wb") as lf:
        proc = subprocess.Popen(cmd, stdout=lf, stderr=subprocess.STDOUT)
    return tmp, out, proc


def build_all(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Build every named library that is not built yet, one ``nvcc`` per
    source, all started together. Returns ``name -> .so path``; raises
    ``RuntimeError`` with the compiler's output if any build fails."""
    names = list(names)
    pending: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    for name in names:
        if not _target(name).exists():
            pending.append((name, *_start(name)))
    errors = []
    for name, tmp, out, proc in pending:
        rc = proc.wait()
        if rc == 0:
            os.replace(tmp, out)          # atomic: racing builders both win
        else:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {SOURCES[name]} (rc {rc}):\n"
                          f"{out.with_suffix('.log').read_text()}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _target(name) for name in names}


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) from the build of ``name``, or '' if none is kept."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _loaded[name] = lib
        return lib


def launch(name: str, fn: str, argtypes: List, *args) -> None:
    """Call ``fn`` of library ``name`` (building it on first use): a C
    launcher that returns its ``cudaError_t``. Raises ``RuntimeError`` when
    that is not 0, so a launch the card refused (too much shared memory,
    too many threads) never passes unseen."""
    lib = load(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    rc = f(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {rc} "
                           f"({lib.repro_error_string(rc).decode()})")
