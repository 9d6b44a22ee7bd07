#!/usr/bin/env python3
"""Time the port's RMSNorm (K4, ``repro_rmsnorm`` in ``rmsnorm.cu``) against
other versions of its source and ``F.rms_norm``, in one process on one GPU,
in alternating rounds.

    python3 tools/k4_ab.py [--variant NAME=PATH ...] [--unchecked NAME=PATH ...]
                           [--rounds 6] [--reps 15] [--sweep]

Run from a checkout of the repository, on a card. Each ``--variant`` is a
CUDA source with the C function ``repro_rmsnorm``, built with the port's
nvcc flags (``kernels/_build.py``) beside the committed source. A source
without ``repro_rmsnorm_plan`` is called with the first kernel's interface
(up to commit aa1bb69: an f32 scale, no scale dtype; ``git show aa1bb69:
src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu``) and held to that kernel's
order of the sum (32 running sums over the columns j, j + 32, ..., then a
halving tree: :func:`first_plain`); it is timed given an f32 scale (the
kernel alone) and, as its wrapper called it, with the bf16 scale widened by
a copy first. Every other version is held to ``rmsnorm_plain``. Before it
is timed, each version must agree bit for bit with its plain version at the
reference's test shapes, at the serving shapes with a bf16 and an f32
scale, on both sides of the layout threshold and on views off a 16-byte
boundary; an ``--unchecked`` one is a diagnostic (a copy with part of its
work taken out) and is timed without the check.

Five shapes are timed, in bf16 with a bf16 scale as the served models hold
it: the serving prefill's 8,000 x 2,048 and 8,000 x 4,096 (zamba2), decode's
4 x 2,048 and 4 x 4,096, and segment_unest's 180,224 x 128. Each round times
every version and ``F.rms_norm`` once at each shape (the median of
``--reps`` runs, CUDA events, L2 flushed, ``chip_smoke.Timer``), in turn
forward and backward. Prints the card's name and power limit, each
version's ptxas lines, its device time per CUDA kernel (torch.profiler),
the medians and quartiles over the rounds beside the bound
(``chip_smoke._bound``: bytes at 3.35 TB/s), and the same Timer's reading
of an empty kernel (``torch.cuda._sleep(0)``), the floor of a launch, and
the host time a call at 4 x 2,048 of the wrapper, its parts and
``F.rms_norm`` (the enqueue, ``perf_counter``). With
``--sweep``, the committed source is also timed in its two layouts, forced,
at 4 to 8,000 rows of d 2,048 and 4,096: one row a block (one 16-byte group
a thread) and 32 threads a row in blocks of 256, the numbers behind
``repro_rmsnorm_plan``'s threshold.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPES = {"8,000 x 2,048 (prefill)": (8000, 2048),
          "8,000 x 4,096 (zamba2 prefill)": (8000, 4096),
          "4 x 2,048 (decode)": (4, 2048),
          "4 x 4,096 (zamba2 decode)": (4, 4096),
          "180,224 x 128 (segment_unest)": (180_224, 128)}
SWEEP_ROWS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8000)


def first_plain(x, scale, eps=1e-5):
    """The plain version of the first kernel: lane j's running sum of
    x_j^2, x_{j+32}^2, ..., then a halving tree over the 32 lane sums; the
    same roundings as ``rmsnorm_plain``."""
    import torch
    D = x.shape[-1]
    sq = x.float() * x.float()
    sq = torch.nn.functional.pad(sq, (0, -D % 32)) \
        .reshape(x.shape[:-1] + (-1, 32))
    t = torch.zeros(sq.shape[:-2] + (32,), dtype=torch.float32,
                    device=x.device)
    for c in range(sq.shape[-2]):
        t = t + sq[..., c, :]
    while t.shape[-1] > 1:
        t = t[..., :t.shape[-1] // 2] + t[..., t.shape[-1] // 2:]
    var = t / torch.full_like(t, D)
    root = torch.sqrt((var + eps).double()).float()
    r = (torch.ones_like(root) / root).to(x.dtype)
    return (x * r) * scale.to(x.dtype)


class FirstCall:
    """Caller of the first kernel's interface: an f32 scale, no scale
    dtype."""

    def __init__(self, lib, widen: bool):
        self.lib, self.widen = lib, widen
        f = lib.repro_rmsnorm
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                              ctypes.c_float, ctypes.c_int,
                                              ctypes.c_void_p]
        f.restype = ctypes.c_int
        self.plain = first_plain

    def __call__(self, x, scale, stream=None):
        import torch
        sc = scale.to(torch.float32).contiguous() if self.widen else scale
        out = torch.empty_like(x)
        D = x.shape[-1]
        rc = self.lib.repro_rmsnorm(x.data_ptr(), sc.data_ptr(),
                                    out.data_ptr(), x.numel() // D, D, 1e-5,
                                    {torch.float32: 0,
                                     torch.bfloat16: 1}[x.dtype], stream)
        if rc:
            raise RuntimeError(f"repro_rmsnorm failed: CUDA error {rc}")
        return out


class Call:
    """Caller of the committed interface (``rmsnorm.run_kernel``)."""

    def __init__(self, lib):
        self.k4 = importlib.import_module(
            "repro_torch.kernels.rmsnorm.rmsnorm")
        self.lib = lib
        self.plain = self.k4.rmsnorm_plain

    def __call__(self, x, scale, stream=None, layout=None):
        return self.k4.run_kernel(self.lib, x, scale, layout=layout,
                                  stream=stream)


def check_version(name, call, stream, first: bool):
    """Bit-exact against the version's plain version; raises SystemExit on
    the first difference."""
    import torch
    import chip_smoke
    g = torch.Generator(device="cuda").manual_seed(3)
    n = 0

    def same(x, s, what):
        nonlocal n
        got = call(x, s, stream=stream)
        err = chip_smoke.max_err([got], [call.plain(x, s)])
        chip_smoke.check(err == 0.0, f"{name} {what}: max abs err {err}")
        n += 1

    shapes = [(8, 64, 128), (3, 100), (512, 256), (1, 7)] + \
        list(SHAPES.values())
    if not first:
        k4 = call.k4
        for d in (128, 512, 2048, 4096):      # both sides of the threshold
            at = k4.threshold(call.lib, d, torch.bfloat16)
            shapes += [(max(at - 1, 1), d), (at, d)]
    for shape in shapes:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, device="cuda", generator=g).to(dt)
            s = torch.rand(shape[-1], device="cuda", generator=g) + 0.5
            for sc in ((s,) if first else (s, s.to(torch.bfloat16))):
                same(x, sc, f"{tuple(shape)} {dt} scale {sc.dtype}")
            if not first:                     # a view 1 value in
                buf = torch.randn(x.numel() + 1, device="cuda",
                                  generator=g).to(dt)
                same(buf[1:].view(shape), s.to(torch.bfloat16),
                     f"{tuple(shape)} {dt} one value past a 16-byte "
                     f"boundary")
    print(f"{name}: bit-exact with its plain version in {n} checks",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--unchecked", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("k4_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    sources = {"committed": _build.SOURCES["rmsnorm"]}
    for spec in args.variant + args.unchecked:
        name, _, path = spec.partition("=")
        sources[name] = Path(path).resolve()
    unchecked = {spec.partition("=")[0] for spec in args.unchecked}
    for name, path in sources.items():
        _build.SOURCES[f"k4_{name}"] = path
    libs = _build.build_all([f"k4_{n}" for n in sources])
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name in sources:
        for line in _build.build_log(f"k4_{name}").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.strip()}")
        lib = ctypes.CDLL(str(libs[f"k4_{name}"]))
        if hasattr(lib, "repro_rmsnorm_plan"):
            calls[name] = Call(lib)
        else:
            calls[name] = FirstCall(lib, widen=False)
            calls[f"{name} with the widening copy"] = FirstCall(lib, True)
    for name, call in calls.items():
        if name.partition(" with")[0] not in unchecked \
                and not name.endswith("copy"):
            check_version(name, call, stream, isinstance(call, FirstCall))

    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for shape, (rows, d) in SHAPES.items():
        x = torch.randn(rows, d, device="cuda", generator=g).to(torch.bfloat16)
        s = (torch.rand(d, device="cuda", generator=g) + 0.5).to(
            torch.bfloat16)
        inputs[shape] = (x, s, s.float())
    runs = {}
    for name, call in calls.items():
        first = isinstance(call, FirstCall) and not call.widen
        runs[name] = (lambda x, s, s32, c=call, f=first:
                      c(x, s32 if f else s, stream=stream))
    runs["F.rms_norm"] = lambda x, s, s32: F.rms_norm(x, (x.shape[-1],), s,
                                                      1e-5)
    for shape, (x, s, s32) in inputs.items():
        for name, fn in runs.items():
            us = chip_smoke.profile_kernels(lambda f=fn: f(x, s, s32))
            print(f"{name} at {shape}: device us per launch by kernel {us}",
                  flush=True)
    timer = chip_smoke.Timer()
    print(f"empty kernel (torch.cuda._sleep(0)), the same Timer: "
          f"{timer(lambda: torch.cuda._sleep(0), reps=50)} ms", flush=True)
    names = list(runs)
    for shape, (x, s, s32) in inputs.items():
        rows, d = SHAPES[shape]
        b_ms, b_by = chip_smoke._bound(2 * x.numel() * 2 + d * 2,
                                       4 * x.numel())
        reps = args.reps if rows * d > 1 << 20 else 3 * args.reps
        times = {n_: [] for n_ in names}
        for i in range(args.rounds):
            for name in names if i % 2 == 0 else names[::-1]:
                times[name].append(timer(
                    lambda f=runs[name]: f(x, s, s32), reps=reps))
        for name, t in times.items():
            q1, _, q3 = statistics.quantiles(t, n=4)
            print(f"{shape} (bound {b_ms} ms, {b_by}) {name}: median "
                  f"{statistics.median(t)} ms, quartiles {q1} {q3} ms; "
                  f"rounds {t}", flush=True)
    host_times(calls["committed"])
    if args.sweep:
        sweep(calls["committed"], timer, args.rounds, stream)
    return 0


def host_times(call, n: int = 2000):
    """Host time a call (the enqueue: ``perf_counter`` over ``n`` calls,
    then one synchronise) at decode's 4 x 2,048 bf16 with a bf16 scale: the
    port's wrapper, its parts, and ``F.rms_norm``."""
    import time
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn
    k4 = call.k4
    x = torch.randn(4, 2048, device="cuda").to(torch.bfloat16)
    s = (torch.rand(2048, device="cuda") + 0.5).to(torch.bfloat16)
    lib = _build.load("rmsnorm")
    stream = torch.cuda.current_stream().cuda_stream
    parts = {
        "the wrapper (rmsnorm)": lambda: rn.rmsnorm(x, s),
        "F.rms_norm": lambda: F.rms_norm(x, (2048,), s, 1e-5),
        "its checks (_check)": lambda: k4._check(x, s),
        "contiguous x2": lambda: (x.contiguous(), s.contiguous()),
        "torch.empty_like": lambda: torch.empty_like(x),
        "the current stream's handle":
            lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "_build.load": lambda: _build.load("rmsnorm"),
        "run_kernel (out, ctypes call, launch)":
            lambda: k4.run_kernel(lib, x, s, stream=stream),
    }
    for name, fn in parts.items():
        for _ in range(2):                  # warm up, then the reading
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            us = (time.perf_counter() - t0) / n * 1e6
            torch.cuda.synchronize()
        print(f"host time a call at 4 x 2,048, {name}: {us} us", flush=True)


def sweep(call, timer, rounds: int, stream):
    """The committed source in its two layouts, forced, at each of
    SWEEP_ROWS rows of d 2,048 and 4,096 (bf16, bf16 scale)."""
    import torch
    k4 = call.k4
    g = torch.Generator(device="cuda").manual_seed(1)
    for d in (2048, 4096):
        _, N = k4._padded_groups(d, 2)
        layouts = {"a row a block": (min(N, 512), 1),
                   "32 threads a row": (32, 8)}
        for rows in SWEEP_ROWS:
            x = torch.randn(rows, d, device="cuda", generator=g).to(
                torch.bfloat16)
            s = (torch.rand(d, device="cuda", generator=g) + 0.5).to(
                torch.bfloat16)
            times = {n: [] for n in layouts}
            for i in range(rounds):
                for n in (list(layouts) if i % 2 == 0
                          else list(layouts)[::-1]):
                    times[n].append(timer(
                        lambda lay=layouts[n]: call(x, s, stream=stream,
                                                    layout=lay), reps=15))
            print(f"sweep d {d} rows {rows} (plan "
                  f"{k4.plan(call.lib, rows, d, torch.bfloat16)}): "
                  + ", ".join(f"{n} {layouts[n]} median "
                              f"{statistics.median(t)} ms"
                              for n, t in times.items()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
