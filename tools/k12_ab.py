#!/usr/bin/env python3
"""Time the port's fused QA + checksum kernels (K1 ``repro_qa_checksum``
and K2 ``repro_qa_chunk``, ``checksum.cu``) and its transfer checksum (K3
``repro_device_checksum``) against other versions of their source, in one
process on one GPU, in alternating rounds.

    python3 tools/k12_ab.py [--variant NAME=PATH ...] [--unchecked NAME=PATH ...]
                            [--rounds 6] [--reps 15]

Run from a checkout of the repository, on a card. Each ``--variant`` is a
CUDA source with the C functions ``repro_qa_checksum`` and
``repro_qa_chunk``, for example an earlier commit's ``checksum.cu`` (``git
show REV:src/repro_torch/kernels/checksum/csrc/checksum.cu``), built with
the port's nvcc flags (``kernels/_build.py``) beside the committed source.
A source without ``repro_qa_scratch_bytes`` is called with the first
versions' two-kernel interface (a scratch of 6 words a step, no ticket
buffer; ``git show 6eefe20:src/repro_torch/kernels/checksum/csrc/
checksum.cu``), and one without ``repro_device_checksum_scratch_bytes``
with the first K3's interface (an output zeroed by ``torch.zeros``, then
the kernel: two launches a call; ``git show f6b9811:...``).
Before it is timed, every version must agree bit for bit with the plain
versions (``checksum.qa_checksum_batched_plain``,
``qa_checksum_chunk_plain``; min/max by value) on every dtype (raw bit
patterns and normal floats), steps of 8 to 4,096 values, unaligned rows
and ragged last steps, and chunks from a carry, and K3 with
``device_checksum_plain`` at starts 0-15 bytes into a buffer and ragged
sizes up to a T1w's bytes; an ``--unchecked`` one is a diagnostic (a copy
with part of its work taken out) and is timed without the check. Three
shapes of the main path are timed: K1 on one T1w (256x256x176 f32, 11,264
steps of 1,024), K1 on one DWI (96x96x60x65 f32, 35,100 steps), K2 on one
4 MiB chunk (1,024 steps) from a carry 3 MiB into a T1w; and K3 on a T1w's
bytes (aligned, and 1 byte past a 16-byte boundary) and a DWI's. Each
round times every version once at each shape (the
median of ``--reps`` runs, CUDA events, L2 flushed, ``chip_smoke.Timer``),
in turn forward and backward. Prints the card's name and power limit,
each version's ptxas lines, its device time per CUDA kernel
(torch.profiler), the median and quartiles over the rounds with
``chip_smoke.qa_bound`` beside them, and the measured chain: one thread's
dependent adds of values staged in shared memory, read in several ways
(the fold's among them) and from a register (``tools/k12_chain.cu``), in
cycles an add and the SM clock over each run.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

T1W, DWI = (256, 256, 176), (96, 96, 60, 65)
BLK_V = 1024


class TwoKernelCall:
    """Caller of the first versions' interface: K1/K2 take a scratch of 6
    words a step and no ticket buffer."""

    def __init__(self, lib):
        from repro_torch.kernels.checksum.checksum import _SIGNATURES
        self.lib = lib
        for name in ("repro_qa_checksum", "repro_qa_chunk"):
            f = getattr(lib, name)
            f.argtypes = _SIGNATURES[name][:-2] + _SIGNATURES[name][-1:]
            f.restype = ctypes.c_int

    def _check(self, rc, name):
        if rc:
            raise RuntimeError(f"{name} failed to launch: CUDA error {rc}")

    def qa(self, vals, blk=1024, stream=None):
        import torch
        from repro_torch.kernels.checksum.checksum import (_dtype_code,
                                                           _geometry)
        G, nv = vals.shape
        itemsize = vals.element_size()
        blk_v, nw, nsteps = _geometry(nv, itemsize, blk)
        out = (torch.empty((G, 2), dtype=torch.int32, device=vals.device),
               torch.empty((G, 3), dtype=torch.float32, device=vals.device),
               torch.empty((G, 1), dtype=torch.int32, device=vals.device))
        scratch = torch.empty(6 * G * nsteps, dtype=torch.int32,
                              device=vals.device)
        self._check(self.lib.repro_qa_checksum(
            vals.data_ptr(), nv * itemsize, nv * itemsize,
            _dtype_code(vals.dtype), itemsize, blk_v, nsteps, G, nw, nv,
            *(o.data_ptr() for o in out), scratch.data_ptr(), stream),
            "repro_qa_checksum")
        return out

    def chunk(self, data, off, carry, *, dtype, blk_v, nblocks, stream=None):
        import torch
        from repro_torch.kernels.checksum.checksum import _dtype_code
        out = tuple(torch.empty_like(c) for c in carry)
        scratch = torch.empty(6 * nblocks, dtype=torch.int32,
                              device=data.device)
        self._check(self.lib.repro_qa_chunk(
            data.data_ptr(), data.numel(), _dtype_code(dtype), dtype.itemsize,
            blk_v, nblocks, *(int(o) for o in off),
            *(c.data_ptr() for c in carry), *(o.data_ptr() for o in out),
            scratch.data_ptr(), stream), "repro_qa_chunk")
        return out

    def k3(self, x, stream=None):
        return first_device_checksum(self.lib, x, stream)


def first_device_checksum(lib, x, stream=None):
    """The first K3 as its wrapper called it: the output zeroed by
    ``torch.zeros`` (a fill kernel), then the kernel adding into it."""
    import torch
    f = lib.repro_device_checksum
    f.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                  ctypes.c_void_p]
    f.restype = ctypes.c_int
    b = x.contiguous().reshape(-1)
    out = torch.zeros(2, dtype=torch.int32, device=x.device)
    rc = f(b.data_ptr(), b.numel() * b.element_size(), out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"repro_device_checksum failed: CUDA error {rc}")
    return out


class OneKernelCall:
    """Caller of the committed interface (``checksum.run_qa``,
    ``run_chunk``)."""

    def __init__(self, lib):
        import torch
        self.lib = lib
        # a ticket buffer of its own: a diagnostic copy may leave its
        # tickets set (one that never folds), and must not take others'
        self.sync = torch.zeros(1 << 20, dtype=torch.int32, device="cuda")

    def qa(self, vals, blk=1024, stream=None):
        from repro_torch.kernels.checksum.checksum import run_qa
        return run_qa(self.lib, vals, blk=blk, sync=self.sync, stream=stream)

    def chunk(self, data, off, carry, *, dtype, blk_v, nblocks, stream=None):
        from repro_torch.kernels.checksum.checksum import run_chunk
        return run_chunk(self.lib, data, off, carry, dtype=dtype,
                         blk_v=blk_v, nblocks=nblocks, sync=self.sync,
                         stream=stream)

    def k3(self, x, stream=None):
        from repro_torch.kernels.checksum.checksum import run_device_checksum
        if not hasattr(self.lib, "repro_device_checksum_scratch_bytes"):
            return first_device_checksum(self.lib, x, stream)
        return run_device_checksum(self.lib, x, sync=self.sync, stream=stream)


def _same(got, want, what):
    import chip_smoke
    err = chip_smoke.max_err(got, want)
    chip_smoke.check(err == 0.0, f"{what}: max abs err {err}")


def check_version(name, call, stream):
    """Bit-exact against the plain versions on ragged shapes and every
    dtype; raises SystemExit on the first difference."""
    import numpy as np
    import torch
    from repro_torch.kernels.checksum import checksum as ck
    rng = np.random.default_rng(12)
    dtypes = [torch.float32, torch.float16, torch.bfloat16, torch.int8,
              torch.uint8, torch.int16, torch.uint16, torch.int32,
              torch.uint32]
    n_checks = 0
    for dt in dtypes:
        for G, nv in ((3, 100_003), (1, 1_000_000)):
            for raw in (True, False):
                if raw:
                    b = rng.integers(0, 256, G * nv * dt.itemsize, np.uint8)
                    x = torch.from_numpy(b).cuda().view(dt).reshape(G, nv)
                else:
                    x = torch.from_numpy(rng.normal(0, 50, (G, nv)).astype(
                        np.float32)).cuda().to(dt)
                for blk in (8, 256, 1024, 4096):
                    _same(call.qa(x, blk=blk, stream=stream),
                          ck.qa_checksum_batched_plain(x, blk=blk),
                          f"{name} K1 {dt} G {G} nv {nv} raw {raw} blk {blk}")
                    n_checks += 1
    t1 = torch.from_numpy(rng.normal(0, 50, T1W).astype(np.float32)).cuda()
    payload = t1.view(torch.uint8).reshape(-1)
    n = t1.numel()
    for head, nb in ((768, 1024), (63, 4), (10_000, 1264)):
        carry = call.chunk(payload[:head * BLK_V * 4], (0, 0, n, n),
                           ck.initial_carry("cuda"), dtype=torch.float32,
                           blk_v=BLK_V, nblocks=head, stream=stream)
        part = payload[head * BLK_V * 4:(head + nb) * BLK_V * 4 - 12]
        kw = dict(dtype=torch.float32, blk_v=BLK_V, nblocks=nb)
        _same(call.chunk(part, (head * BLK_V, head * BLK_V, n, n), carry,
                         stream=stream, **kw),
              ck.qa_checksum_chunk_plain(part, (head * BLK_V, head * BLK_V,
                                                n, n), carry, **kw),
              f"{name} K2 head {head} nblocks {nb}")
        n_checks += 1
    buf = torch.from_numpy(rng.integers(0, 256, n * 4 + 64,
                                        np.uint8)).cuda()
    for offset in range(16):
        for nbytes in (0, 1, 3, 17, 4099, 262_083, 262_088, 1_000_003,
                       n * 4, n * 4 + 5):
            x = buf[offset:offset + nbytes]
            _same([call.k3(x, stream=stream)], [ck.device_checksum_plain(x)],
                  f"{name} K3 offset {offset} nbytes {nbytes}")
            n_checks += 1
    print(f"{name}: bit-exact with the plain versions in {n_checks} checks",
          flush=True)


CHAIN_WAYS = ("the fold's: float4 batches of 16 in turn, loads unbranched",
              "one float read an add, unrolled 32",
              "float4 batches of 32 in turn, loads behind a branch",
              "warp shuffles", "a register (the add's latency)",
              "float4 batches of 32 a batch ahead behind a branch, moved")


def measure_chain(lib, stream):
    """{way: (cycles an add, SM clock in MHz over the run)} of one
    thread's chain of dependent adds (``tools/k12_chain.cu``)."""
    import torch
    f = lib.repro_fadd_chain
    f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p]
    f.restype = ctypes.c_int
    n, reps = 8192, 200
    x = torch.rand(n, device="cuda")
    out = torch.zeros(2, dtype=torch.float64, device="cuda")
    res = {}
    for variant, way in enumerate(CHAIN_WAYS):
        for _ in range(2):                   # warm up, then the reading
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            rc = f(x.data_ptr(), n, reps, variant, out.data_ptr(), stream)
            b.record()
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"repro_fadd_chain failed: error {rc}")
        cycles = out[1].item()
        res[way] = (cycles / (n * reps), cycles / (a.elapsed_time(b) * 1e3))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--unchecked", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k12_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.checksum import checksum as ck
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    sources = {"committed": _build.SOURCES["checksum"]}
    for spec in args.variant + args.unchecked:
        name, _, path = spec.partition("=")
        sources[name] = Path(path).resolve()
    unchecked = {spec.partition("=")[0] for spec in args.unchecked}
    for name, path in sources.items():
        _build.SOURCES[f"k12_{name}"] = path
    _build.SOURCES["k12_chain"] = ROOT / "tools" / "k12_chain.cu"
    libs = _build.build_all([f"k12_{n}" for n in sources] + ["k12_chain"])
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name in sources:
        for line in _build.build_log(f"k12_{name}").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.strip()}")
        lib = ctypes.CDLL(str(libs[f"k12_{name}"]))
        calls[name] = (OneKernelCall(lib) if hasattr(
            lib, "repro_qa_scratch_bytes") else TwoKernelCall(lib))
    for name, call in calls.items():
        if name not in unchecked:
            check_version(name, call, stream)

    for way, (cyc, mhz) in measure_chain(
            ctypes.CDLL(str(libs["k12_chain"])), stream).items():
        print(f"chain, {way}: {cyc} cycles an add, SM clock {mhz} MHz over "
              f"the run (clock64 / CUDA events)", flush=True)

    rng = np.random.default_rng(0)
    t1 = torch.from_numpy(rng.normal(300, 80, T1W).astype(
        np.float32)).cuda().reshape(1, -1)
    dwi = torch.from_numpy(rng.normal(300, 80, DWI).astype(
        np.float32)).cuda().reshape(1, -1)
    payload = t1.view(torch.uint8).reshape(-1)
    n = t1.numel()
    nb4, head = (4 << 20) // (BLK_V * 4), 768
    carry = ck.qa_checksum_chunk_plain(
        payload[:head * BLK_V * 4], (0, 0, n, n), ck.initial_carry("cuda"),
        dtype=torch.float32, blk_v=BLK_V, nblocks=head)
    chunk = payload[head * BLK_V * 4:(head + nb4) * BLK_V * 4]
    off = (head * BLK_V, head * BLK_V, n, n)
    kw = dict(dtype=torch.float32, blk_v=BLK_V, nblocks=nb4)
    shifted = torch.empty(n * 4 + 16, dtype=torch.uint8, device="cuda")
    shifted[1:1 + n * 4].copy_(payload)
    dwi_bytes = dwi.view(torch.uint8).reshape(-1)
    k3_bound = {m: chip_smoke._bound(m + 8, m)
                + (m / chip_smoke.HBM_BYTES_PER_S * 1e3,)
                for m in (n * 4, dwi_bytes.numel())}
    shapes = {
        "K1 T1w": (lambda c: c.qa(t1, stream=stream),
                   chip_smoke.qa_bound(n, 4, n // BLK_V)),
        "K1 DWI": (lambda c: c.qa(dwi, stream=stream),
                   chip_smoke.qa_bound(dwi.numel(), 4,
                                       -(-dwi.numel() // BLK_V))),
        "K2 4 MiB from a carry": (
            lambda c: c.chunk(chunk, off, carry, stream=stream, **kw),
            chip_smoke.qa_bound(nb4 * BLK_V, 4, nb4)),
        "K3 T1w": (lambda c: c.k3(payload, stream=stream), k3_bound[n * 4]),
        "K3 T1w 1 byte past a 16-byte boundary": (
            lambda c: c.k3(shifted[1:1 + n * 4], stream=stream),
            k3_bound[n * 4]),
        "K3 DWI": (lambda c: c.k3(dwi_bytes, stream=stream),
                   k3_bound[dwi_bytes.numel()]),
    }
    for shape, (fn, _) in shapes.items():
        for name, call in calls.items():
            us = chip_smoke.profile_kernels(lambda c=call: fn(c))
            print(f"{name} at {shape}: device us per launch by kernel {us}",
                  flush=True)
    timer = chip_smoke.Timer()
    names = list(calls)
    for shape, (fn, (b_ms, b_by, bytes_ms)) in shapes.items():
        times = {n_: [] for n_ in names}
        for i in range(args.rounds):
            for name in names if i % 2 == 0 else names[::-1]:
                times[name].append(timer(lambda c=calls[name]: fn(c),
                                         reps=args.reps))
        for name, t in times.items():
            q1, _, q3 = statistics.quantiles(t, n=4)
            print(f"{shape} (bound {b_ms} ms, {b_by}; bytes {bytes_ms} ms) "
                  f"{name}: median {statistics.median(t)} ms, quartiles {q1} "
                  f"{q3} ms; rounds {t}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
