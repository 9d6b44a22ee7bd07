"""Build a CUDA source of the port for the CPU through ``shim.h``.

    python tools/cuda_shim/build.py SOURCE.cu OUT.so

The source is rewritten into C++: its CUDA includes go (``shim.h`` comes
first), the functions between its ``// ptx:begin`` and ``// ptx:end``
lines go (``shim.h`` defines them), ``extern __shared__ T name[];`` points
at the block's buffer, and each ``kernel<<<grid, block, smem, stream>>>(
args);`` becomes a ``shim_launch``. g++ builds it into a shared library
whose C functions (``repro_*``) take CPU pointers, as the card's take
device pointers.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

SHIM = Path(__file__).resolve().parent / "shim.h"


def rewrite(src: str) -> str:
    src = re.sub(r"#include <cuda[^>]*>[^\n]*\n", "", src)
    src = re.sub(r"// ptx:begin.*?// ptx:end", "", src, flags=re.S)
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(shim_smem());", src)

    def launch(m):
        cfg = [c.strip() for c in m.group(2).split(",")]
        return (f"shim_launch([&] {{ {m.group(1)}({m.group(3)}); }}, "
                f"{', '.join(cfg)});")
    src = re.sub(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\((.*?)\);", launch,
                 src, flags=re.S)
    return f'#include "{SHIM}"\n' + src


def build(cu: Path, out: Path) -> Path:
    """Rewrite ``cu`` and build it into ``out``; raises RuntimeError with
    the compiler's output if g++ fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    cpp = out.with_suffix(".cpp")
    cpp.write_text(rewrite(Path(cu).read_text()))
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                        "-shared", "-fPIC", "-pthread", "-o", str(out),
                        str(cpp)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ failed on {cu}:\n{r.stderr[-4000:]}")
    return out


if __name__ == "__main__":
    print(build(Path(sys.argv[1]), Path(sys.argv[2])))
