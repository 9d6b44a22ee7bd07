#!/usr/bin/env python3
"""Time the port's Mamba-2 SSD chunk scan (K6, ``mamba2_ssd.cu``) against
other versions of its source, in one process on one GPU, in alternating
rounds.

    python3 tools/k6_ab.py [--variant NAME=PATH ...] [--unchecked NAME=PATH ...]
                           [--rounds 6] [--reps 5]

Run from a checkout of the repository, on a card. Each ``--variant`` is a
CUDA source with the C function ``repro_ssd_chunked``, for example an
earlier commit's ``mamba2_ssd.cu`` (``git show
REV:src/repro_torch/kernels/mamba2_ssd/csrc/mamba2_ssd.cu``), built with
the port's nvcc flags (``kernels/_build.py``) beside the committed source.
A source without ``repro_ssd_workspace_bytes`` is called with the first
version's one-kernel interface (no workspace argument). Before it is timed, every
version must agree with the plain version within ``chip_smoke.SCAN_TOL`` on
ragged shapes from a zero and a random state, and at the serving shape;
an ``--unchecked`` one is a diagnostic (a version with part of its work
taken out, to see what that part costs) and is timed without the check.
The serving shape is zamba2-1.2b's prefill (x (4, 64, 2,000, 64) f32 in
the model's strided layout, B/C (4, 2,000, 64) slices of one projection,
chunk 256, from a zero state). Each round times every version once (the
median of ``--reps`` runs, CUDA events, L2 flushed, ``chip_smoke.Timer``),
in turn forward and backward. Prints the card's name and power limit, each
version's ptxas lines, its device time per CUDA kernel (torch.profiler)
and, per version, the median and quartiles over the rounds.
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
    """A caller of the first version's ``repro_ssd_chunked``, which takes
    no workspace."""
    import torch
    from repro_torch.kernels.mamba2_ssd.mamba2_ssd import _ARGTYPES, _f32_rows
    f = lib.repro_ssd_chunked
    f.argtypes, f.restype = _ARGTYPES[:-2] + _ARGTYPES[-1:], ctypes.c_int

    def call(x, lw, Bm, Cm, *, chunk, state=None, stream=None):
        B, H, S, dh = x.shape
        N = Bm.shape[-1]
        x, Bm, Cm, lw = _f32_rows(x), _f32_rows(Bm), _f32_rows(Cm), lw.float()
        y = torch.empty_like(x)
        s_out = torch.empty((B, H, dh, N), dtype=torch.float32,
                            device=x.device)
        rc = f(x.data_ptr(), *x.stride()[:3], lw.data_ptr(), *lw.stride(),
               Bm.data_ptr(), *Bm.stride()[:2], Cm.data_ptr(),
               *Cm.stride()[:2],
               None if state is None else state.contiguous().data_ptr(),
               y.data_ptr(), *y.stride()[:3], s_out.data_ptr(),
               B, H, S, dh, N, chunk, stream)
        if rc:
            raise RuntimeError(f"repro_ssd_chunked failed: error {rc}")
        return y, s_out
    return call


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
        print("k6_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba2_ssd as k6
    from repro_torch.kernels.mamba2_ssd.mamba2_ssd import run_kernel
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    sources = {"committed": _build.SOURCES["mamba2_ssd"]}
    for spec in args.variant + args.unchecked:
        name, _, path = spec.partition("=")
        sources[name] = Path(path).resolve()
    unchecked = {spec.partition("=")[0] for spec in args.unchecked}
    for name, path in sources.items():
        _build.SOURCES[f"k6_{name}"] = path
    libs = _build.build_all([f"k6_{n}" for n in sources])
    run = {}
    for name in sources:
        for line in _build.build_log(f"k6_{name}").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.strip()}")
        lib = ctypes.CDLL(str(libs[f"k6_{name}"]))
        call = (functools.partial(run_kernel, lib) if hasattr(
            lib, "repro_ssd_workspace_bytes") else _one_kernel_call(lib))

        def go(*a, call=call, **kw):
            return call(*a, stream=torch.cuda.current_stream().cuda_stream,
                        **kw)
        run[name] = go
    names = [n for n in run if n not in unchecked]

    g = torch.Generator().manual_seed(5)
    for B, H, S, dh, N, T in ((2, 3, 1000, 64, 64, 256),
                              (1, 2, 300, 32, 16, 64), (2, 2, 77, 16, 8, 100)):
        x = torch.randn(B, S, H, dh, generator=g).cuda().transpose(1, 2)
        lw = (-torch.randn(B, S, H, generator=g).abs() * 0.1).cuda() \
            .transpose(1, 2)
        bc = torch.randn(B, S, 2 * N, generator=g).cuda() * 0.3
        s0 = torch.randn(B, H, dh, N, generator=g).cuda()
        for state in (None, s0):
            a = (x, lw, bc[..., :N], bc[..., N:])
            yp, sp = k6.ssd_chunked_plain(*a, chunk=T, state=state)
            for name in names:
                y, st = run[name](*a, chunk=T, state=state)
                e = max(chip_smoke._scan_rel(y, yp), chip_smoke._scan_rel(
                    st, sp))
                chip_smoke.check(e < chip_smoke.SCAN_TOL,
                                 f"{name} at {(B, H, S, dh, N, T)}: {e}")
                print(f"{name} at (B, H, S, dh, N, chunk) {(B, H, S, dh, N, T)}"
                      f", state given {state is not None}: {e} of max(1, "
                      f"max|ref|)", flush=True)
    a6, _ = chip_smoke._scan_inputs("ssd_chunked", "reference",
                                    torch.Generator().manual_seed(12))
    yp, sp = k6.ssd_chunked_plain(*a6, chunk=256)
    for name in run:
        y, st = run[name](*a6, chunk=256)
        e = max(chip_smoke._scan_rel(y, yp), chip_smoke._scan_rel(st, sp))
        if name not in unchecked:
            chip_smoke.check(e < chip_smoke.SCAN_TOL, f"{name} serving: {e}")
        us = chip_smoke.profile_kernels(lambda n=name: run[n](*a6, chunk=256))
        print(f"{name} at the serving shape: {e} of max(1, max|ref|); "
              f"device us per launch by kernel {us}", flush=True)
    names = list(run)
    bound = chip_smoke.scan_bound("ssd_chunked", 4, 64, 2000, 64, 64)
    timer = chip_smoke.Timer()
    times = {n: [] for n in names}
    for i in range(args.rounds):
        for name in names if i % 2 == 0 else names[::-1]:
            times[name].append(timer(lambda n=name: run[n](*a6, chunk=256),
                                     reps=args.reps))
    for name, t in times.items():
        q1, _, q3 = statistics.quantiles(t, n=4)
        print(f"serving (B 4, H 64, S 2000, dh 64, N 64, chunk 256; bound "
              f"{bound[0]} ms, {bound[1]}) {name}: median "
              f"{statistics.median(t)} ms, quartiles {q1} {q3} ms; rounds "
              f"{t}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
