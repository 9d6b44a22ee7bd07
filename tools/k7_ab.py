#!/usr/bin/env python3
"""Time the port's RWKV-6 chunked WKV (K7, ``rwkv6.cu``) against other
versions of its source, in one process on one GPU, in alternating rounds.

    python3 tools/k7_ab.py [--variant NAME=PATH ...] [--unchecked NAME=PATH ...]
                           [--rounds 6] [--reps 5]

Run from a checkout of the repository, on a card. Each ``--variant`` is a
CUDA source with the C function ``repro_wkv6_chunked``, for example an
earlier commit's ``rwkv6.cu`` (``git show
REV:src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu``), built with the port's
nvcc flags (``kernels/_build.py``) beside the committed source. A source
without ``repro_wkv6_workspace_bytes`` is called with the first version's
one-kernel interface (no workspace argument). Before it is timed, every
version must agree with the plain version within ``chip_smoke.SCAN_TOL``
on ragged shapes (f32 and bf16, chunks 32, 100 and 128, slow and strong
decays) from a zero and a random state, and at the serving shape; an
``--unchecked`` one is a diagnostic (a version with part of its work taken
out, to see what that part costs) and is timed without the check. The
serving shape is rwkv6-1.6b's prefill (r, k, v (4, 32, 2,000, 64) bf16 and
logw f32, in the model's strided layout, chunk 128, from a zero state).
Each round times every version once (the median of ``--reps`` runs, CUDA
events, L2 flushed, ``chip_smoke.Timer``), in turn forward and backward.
Prints the card's name and power limit, each version's ptxas lines, its
device time per CUDA kernel (torch.profiler) and, per version, the median
and quartiles over the rounds.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _one_kernel_call(lib):
    """A caller of the first version's ``repro_wkv6_chunked``, which takes
    no workspace."""
    import torch
    from repro_torch.kernels.rwkv6.rwkv6 import (_ARGTYPES, _DTYPE_CODES,
                                                 _dense_rows)
    f = lib.repro_wkv6_chunked
    f.argtypes, f.restype = _ARGTYPES[:-2] + _ARGTYPES[-1:], ctypes.c_int

    def call(r, k, v, logw, u, *, chunk, state=None, stream=None):
        B, H, S, dh = r.shape
        r, k, v = (_dense_rows(t) for t in (r, k, v))
        logw = _dense_rows(logw.float())
        uf = u.float().contiguous()
        out = torch.empty_like(r, dtype=torch.float32)
        s_out = torch.empty((B, H, dh, dh), dtype=torch.float32,
                            device=r.device)
        rc = f(r.data_ptr(), *r.stride()[:3], k.data_ptr(), *k.stride()[:3],
               v.data_ptr(), *v.stride()[:3], logw.data_ptr(),
               *logw.stride()[:3], uf.data_ptr(),
               None if state is None else state.contiguous().data_ptr(),
               out.data_ptr(), *out.stride()[:3], s_out.data_ptr(),
               B, H, S, dh, chunk, _DTYPE_CODES[r.dtype], stream)
        if rc:
            raise RuntimeError(f"repro_wkv6_chunked failed: error {rc}")
        return out, s_out
    return call


def _inputs(B, H, S, dh, g, dtype, strong):
    """The card tests' distributions, in the model's strided layout."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=g)
    r, k, v = (randn(B, S, H, dh).to(dtype).cuda().transpose(1, 2)
               for _ in range(3))
    z = randn(B, S, H, dh)
    lw = -torch.exp(z * 2 - 1) if strong else -torch.exp(z * 0.5 - 2)
    lw = lw.clamp(-20.0, -1e-6).cuda().transpose(1, 2)
    return (r, k, v, lw, (randn(H, dh) * 0.3).cuda()), \
        randn(B, H, dh, dh).cuda()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--unchecked", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k7_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv6 as k7
    from repro_torch.kernels.rwkv6.rwkv6 import run_kernel
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    sources = {"committed": _build.SOURCES["rwkv6"]}
    for spec in args.variant + args.unchecked:
        name, _, path = spec.partition("=")
        sources[name] = Path(path).resolve()
    unchecked = {spec.partition("=")[0] for spec in args.unchecked}
    for name, path in sources.items():
        _build.SOURCES[f"k7_{name}"] = path
    libs = _build.build_all([f"k7_{n}" for n in sources])
    run = {}
    for name in sources:
        for line in _build.build_log(f"k7_{name}").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.strip()}")
        lib = ctypes.CDLL(str(libs[f"k7_{name}"]))
        call = (functools.partial(run_kernel, lib) if hasattr(
            lib, "repro_wkv6_workspace_bytes") else _one_kernel_call(lib))

        def go(*a, call=call, **kw):
            return call(*a, stream=torch.cuda.current_stream().cuda_stream,
                        **kw)
        run[name] = go
    names = [n for n in run if n not in unchecked]

    g = torch.Generator().manual_seed(5)
    for B, H, S, dh, T in ((2, 3, 1000, 64, 128), (1, 2, 300, 32, 32),
                           (2, 2, 77, 16, 100)):
        for dtype in (torch.float32, torch.bfloat16):
            for strong in (False, True):
                a, s0 = _inputs(B, H, S, dh, g, dtype, strong)
                for state in (None, s0):
                    op, sp = k7.wkv6_chunked_plain(*a, chunk=T, state=state)
                    for name in names:
                        o, st = run[name](*a, chunk=T, state=state)
                        e = max(chip_smoke._scan_rel(o, op),
                                chip_smoke._scan_rel(st, sp))
                        what = (f"(B, H, S, dh, chunk) {(B, H, S, dh, T)} "
                                f"{dtype}, strong {strong}, state given "
                                f"{state is not None}")
                        chip_smoke.check(e < chip_smoke.SCAN_TOL,
                                         f"{name} at {what}: {e}")
                        print(f"{name} at {what}: {e} of max(1, max|ref|)",
                              flush=True)
    a7, _ = chip_smoke._scan_inputs("wkv6_chunked", "reference",
                                    torch.Generator().manual_seed(12))
    op, sp = k7.wkv6_chunked_plain(*a7, chunk=128)
    for name in run:
        o, st = run[name](*a7, chunk=128)
        e = max(chip_smoke._scan_rel(o, op), chip_smoke._scan_rel(st, sp))
        if name not in unchecked:
            chip_smoke.check(e < chip_smoke.SCAN_TOL, f"{name} serving: {e}")
        us = chip_smoke.profile_kernels(lambda n=name: run[n](*a7, chunk=128))
        print(f"{name} at the serving shape: {e} of max(1, max|ref|); "
              f"device us per launch by kernel {us}", flush=True)
    names = list(run)
    bound = chip_smoke.scan_bound("wkv6_chunked", 4, 32, 2000, 64, 64, 2)
    timer = chip_smoke.Timer()
    times = {n: [] for n in names}
    for i in range(args.rounds):
        for name in names if i % 2 == 0 else names[::-1]:
            times[name].append(timer(lambda n=name: run[n](*a7, chunk=128),
                                     reps=args.reps))
    for name, t in times.items():
        q1, _, q3 = statistics.quantiles(t, n=4)
        print(f"serving (B 4, H 32, S 2000, dh 64, bf16, chunk 128; bound "
              f"{bound[0]} ms, {bound[1]}) {name}: median "
              f"{statistics.median(t)} ms, quartiles {q1} {q3} ms; rounds "
              f"{t}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
