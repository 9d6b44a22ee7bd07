#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU (H100, sm_90a) and
hold its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py [--seed 0]

Run from a checkout of the repository: it imports ``src/repro_torch`` (never
JAX, never the JAX package ``repro``) and builds the kernels from
``src/repro_torch/kernels/*/csrc`` with ``nvcc``. Phases, each fatal:

 1. build   - one nvcc per CUDA source, all started together.
 2. data    - raw scanner dumps made from ``--seed`` with numpy: per session
              a T1w at 256x256x176 and a DWI at 96x96x60x65 (float32; a 1 mm
              MPRAGE and a 65-direction series), plus one corrupted dump,
              one filtered protocol and one non-finite volume.
 3. ingest  - ``ingest_directory(device_qa=True, device="cuda")`` twice:
              one-shot QA (REPRO_STREAM_INGEST=0, kernel K1) and streamed QA
              (REPRO_STREAM_INGEST=1, kernel K2). Launch counts are zeroed
              just before and read just after each run. Every recorded
              checksum must equal ``ref.qa_checksum_ref`` of its volume, and
              both runs must commit the same records and bytes.
 4. run     - ``generate_jobs`` + ``LocalRunner`` for bias_correct,
              affine_register and dwi_prequal on cuda: every unit ok,
              outputs finite, a re-query finds no work. Then at 64^3 the
              cuda outputs are held against the port's own cpu outputs with
              the parity tests' tolerances.
 5. kernels - K1, K2, K3 against their plain versions on the card: on the
              ingested volumes, on every dtype, and the streaming
              accumulator at 64 KiB, 4 MiB and 1,000,003-byte chunks.
              Bit-exact (min/max equal by value).
 6. timing  - each kernel's median time (CUDA events, L2 flushed, the GPU
              kept busy so host enqueue time is not counted) at the main
              path's shapes, beside its plain version's and its bound.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_OPS_PER_S = 67e12          # H100 SXM scalar float32, published
T1W = (256, 256, 176)
DWI = (96, 96, 60, 65)
SESSIONS = 4
BLK_V = 1024                   # qa_block_size for float32 volumes
CHECKSUM_CU = "src/repro_torch/kernels/checksum/csrc/checksum.cu"
TPU_CHECKSUM = "src/repro/kernels/checksum/checksum.py"
KERNELS = {  # wrapper name -> TPU kernel it replaces
    "qa_checksum": f"{TPU_CHECKSUM}:110",
    "qa_checksum_chunk": f"{TPU_CHECKSUM}:223",
    "device_checksum": f"{TPU_CHECKSUM}:47",
}


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def make_t1w(rng, shape=T1W):
    """A bright off-centre blob on a noisy floor under a smooth bias ramp."""
    import numpy as np
    g = [np.linspace(-1, 1, s, dtype=np.float32) for s in shape]
    gx, gy, gz = g[0][:, None, None], g[1][None, :, None], g[2][None, None, :]
    c = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
    r2 = (gx - c[0]) ** 2 + (gy - c[1]) ** 2 + (gz - c[2]) ** 2
    v = 100 * np.exp(-3 * r2) + 10
    v = v + 2 * rng.standard_normal(shape, dtype=np.float32)
    return (v * (1 + 0.2 * gx)).astype(np.float32)


def make_dwi(rng, shape=DWI):
    """Three spatial maps times three direction profiles on a noise floor:
    the low-rank structure a DWI series has, which the rank-3 denoiser
    keeps (pure noise has no gap after the third singular value, so two
    SVD libraries may keep different subspaces of it)."""
    import numpy as np
    n, V = int(np.prod(shape[:-1])), shape[-1]
    maps = rng.standard_normal((n, 3), dtype=np.float32)
    profiles = rng.standard_normal((3, V), dtype=np.float32)
    sig = 80 + (maps * np.float32([20, 12, 7])) @ profiles
    sig += 3 * rng.standard_normal((n, V), dtype=np.float32)
    return sig.reshape(shape)


def write_dumps(raw: Path, seed: int, sessions: int):
    """Raw dumps for ``sessions`` sessions plus the three that must not
    commit; returns the volumes by dump name."""
    import numpy as np
    from repro_torch.core import write_raw_dump
    rng = np.random.default_rng(seed)
    vols = {}
    for s in range(sessions):
        sub = f"{s:03d}"
        for proto, make in (("T1w", make_t1w), ("dwi", make_dwi)):
            name = f"sub{sub}_{proto}.npz"
            vols[name] = make(rng)
            write_raw_dump(raw / name, vols[name], subject=sub,
                           session="01", protocol=proto)
    bad = make_t1w(rng)
    bad[tuple(s // 2 for s in bad.shape)] = np.nan
    vols["zz_nonfinite_T1w.npz"] = bad
    write_raw_dump(raw / "zz_nonfinite_T1w.npz", bad, subject="900",
                   session="01", protocol="T1w")
    write_raw_dump(raw / "zz_bold.npz", make_dwi(rng, (32, 32, 24, 8)),
                   subject="901", session="01", protocol="bold")
    (raw / "zz_corrupted.npz").write_bytes(b"PK\x03\x04" + rng.bytes(4096))
    return vols


# ---------------------------------------------------------------------------
# measuring and comparing
# ---------------------------------------------------------------------------

class Timer:
    """Median device time of a call: L2 flushed before each run, the GPU
    kept busy by a spin kernel while the host enqueues, so the two events
    bracket device work only."""

    def __init__(self):
        import torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps=15):
        import torch
        fn()                                        # warm up
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def qa_bound(nv: int, itemsize: int):
    """Least time for the fused pass over nv values: each input byte read
    once and 24 output bytes written, against the scalar operations (per
    value a finite test, min, max and a tree add; per word an add, a
    multiply, a modulo and an add). Returns (ms, what bounds it)."""
    nw = (nv * itemsize + 3) // 4
    return _bound(nv * itemsize + 24, 4 * nv + 4 * nw)


def _bound(nbytes: int, ops: int):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def max_err(got, want) -> float:
    """Max |a - b| over matching outputs; equal values (inf, -0.0 vs +0.0,
    NaN vs NaN) count 0."""
    import numpy as np
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"outputs differ in kind: {a.shape}/{a.dtype} {b.shape}/{b.dtype}")
        a, b = a.astype(np.float64), b.astype(np.float64)
        same = (a == b) | (np.isnan(a) & np.isnan(b))
        d = np.where(same, 0.0, np.abs(a - b))
        worst = max(worst, float(np.nan_to_num(d, nan=np.inf).max(
            initial=0.0)))
    return worst


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build   # fails outside a checkout
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed")
    card = smi.stdout.strip().splitlines()[0]
    import numpy as np
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} numpy "
        f"{np.__version__} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s")
    for line in _build.build_log("checksum").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        kernels = run(args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port pulled in JAX or the JAX package")
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(args, work: Path):
    import numpy as np
    import torch
    from repro_torch.core import (LocalRunner, builtin_pipelines,
                                  generate_jobs, ingest_directory,
                                  query_available_work)
    from repro_torch.core import stream as stream_mod
    from repro_torch.kernels.checksum import (
        ACCUMULATOR_DTYPES, LAUNCHES, QAChecksumAccumulator, QAStats,
        device_checksum, device_checksum_plain, qa_checksum_batched,
        initial_carry, qa_checksum_batched_plain, qa_checksum_chunk,
        qa_checksum_chunk_plain, ref, reset_launches)

    # -- 2. data -------------------------------------------------------------
    t0 = time.perf_counter()
    raw = work / "raw"
    vols = write_dumps(raw, args.seed, SESSIONS)
    log(f"data: {len(vols)} volumes, "
        f"{sum(v.nbytes for v in vols.values()) / 1e6:.1f} MB float32, "
        f"{time.perf_counter() - t0:.3f} s")

    # -- 3. ingest: one-shot (K1), then streamed (K2) ------------------------
    ingests = {}
    os.environ.pop(stream_mod.CHUNK_MB_ENV, None)    # the 4 MiB default
    for mode in ("0", "1"):
        os.environ[stream_mod.STREAM_ENV] = mode
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        manifest, recs = ingest_directory(raw, work / f"bids{mode}", "smoke",
                                          device_qa=True, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        report = json.loads((work / f"bids{mode}" / "smoke" /
                             "ingestion_report.json").read_text())
        ingests[mode] = (manifest, recs, launches, wall, report)
        log(f"ingest stream={mode}: wall {wall:.3f} s, counts "
            f"{report['counts']}, launches {launches}, "
            f"stream {report.get('stream')}")
    m0, rec0, l0, _, rep0 = ingests["0"]
    m1, rec1, l1, _, rep1 = ingests["1"]
    qa_recs = [r for r in rec0 if r.status in ("ok", "failed_qa")]
    check(l0["qa_checksum"] == len(qa_recs) and l0["qa_checksum_chunk"] == 0,
          f"one-shot ingest launches {l0} for {len(qa_recs)} volumes")
    check(l1["qa_checksum_chunk"] >= len(qa_recs) and l1["qa_checksum"] == 0,
          f"streamed ingest launches {l1}")
    want = {"ok": 2 * SESSIONS, "corrupted": 1, "filtered": 1,
            "failed_qa": 1}
    check(rep0["counts"] == want == rep1["counts"],
          f"ingest counts {rep0['counts']} / {rep1['counts']}")
    t0 = time.perf_counter()
    for r in qa_recs:
        st = QAStats.from_carry(*ref.qa_checksum_ref(vols[r.source]))
        check(r.checksum == f"{st.checksum:016x}",
              f"{r.source}: checksum {r.checksum} != {st.checksum:016x}")
    log(f"oracle: {len(qa_recs)} checksums equal ref.qa_checksum_ref "
        f"({time.perf_counter() - t0:.3f} s)")

    def strip(recs, mode):
        return [(r.source, r.status, r.reason, r.checksum, r.sha256,
                 r.dest.replace(str(work / f"bids{mode}"), ""))
                for r in recs]
    check(strip(rec0, "0") == strip(rec1, "1"),
          "the two ingests committed different records")
    check([(i.path, i.sha256) for i in m0.images] ==
          [(i.path, i.sha256) for i in m1.images],
          "the two ingests committed different bytes")
    reasons = {r.source: r.reason for r in rec1}
    check(reasons["zz_nonfinite_T1w.npz"] == "non-finite voxels",
          f"non-finite volume: {reasons['zz_nonfinite_T1w.npz']}")

    # -- 4. the pipelines on cuda ---------------------------------------------
    pipes = builtin_pipelines("cuda")
    for name, pipe in pipes.items():
        plan = generate_jobs(m1, pipe, work / "jobs")
        check(len(plan.units) == SESSIONS,
              f"{name}: {len(plan.units)} units for {SESSIONS} sessions")
        t0 = time.perf_counter()
        results = LocalRunner(pipe, m1.root).run(plan.units)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bad = [(r.unit.job_id, r.status, r.error) for r in results
               if r.status != "ok"]
        check(not bad, f"{name}: {bad}")
        for u in plan.units:
            for f in Path(u.out_dir).glob("*.npy"):
                check(np.all(np.isfinite(np.load(f))), f"{f} is not finite")
        again, _ = query_available_work(m1, pipe)
        check(not again, f"{name}: the re-query found {len(again)} units")
        log(f"run {name}: {len(results)} units ok, wall {wall:.3f} s, per "
            f"unit {[round(r.seconds, 3) for r in results]} s")

    rng = np.random.default_rng(args.seed + 1)
    small = {"T1w": make_t1w(rng, (64, 64, 64)),
             "dwi": make_dwi(rng, (64, 64, 64, 65))}
    on_cpu = builtin_pipelines("cpu")
    gpu = {n: p.run(small) for n, p in pipes.items()}
    cpu = {n: p.run(small) for n, p in on_cpu.items()}

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
    diffs = {
        "bias_correct_rel": max(rel(gpu["bias_correct"][k],
                                    cpu["bias_correct"][k])
                                for k in cpu["bias_correct"]),
        "affine_theta_abs": float(np.max(np.abs(
            gpu["affine_register"]["affine"]
            - cpu["affine_register"]["affine"]))),
        "affine_warped_abs": float(np.max(np.abs(
            gpu["affine_register"]["T1w_reg"]
            - cpu["affine_register"]["T1w_reg"]))),
        "dwi_prequal_rel": rel(gpu["dwi_prequal"]["dwi_denoised"],
                               cpu["dwi_prequal"]["dwi_denoised"]),
    }
    log(f"cuda vs cpu at 64^3: {diffs}")
    check(diffs["bias_correct_rel"] <= 1e-4
          and diffs["affine_theta_abs"] <= 1e-4
          and diffs["affine_warped_abs"] <= 5e-3
          and diffs["dwi_prequal_rel"] <= 1e-4, f"cuda vs cpu: {diffs}")

    # -- 5. kernels against their plain versions ---------------------------------
    errs = dict.fromkeys(KERNELS, 0.0)

    def hold(name, got, want):
        errs[name] = max(errs[name], max_err(got, want))

    for v in vols.values():                 # the ingested volumes
        x = torch.from_numpy(v).cuda().reshape(1, -1)
        hold("qa_checksum", qa_checksum_batched(x),
             qa_checksum_batched_plain(x))
        hold("device_checksum", [device_checksum(x)],
             [device_checksum_plain(x)])
    bits = torch.from_numpy(np.random.default_rng(args.seed + 2).integers(
        0, 256, 3 * 4_000_012, np.uint8)).cuda()
    for dt in [getattr(torch, n) for n in ACCUMULATOR_DTYPES] + \
            [torch.bfloat16]:               # every dtype, every bit pattern
        x = bits.view(dt).reshape(3, -1)
        hold("qa_checksum", qa_checksum_batched(x),
             qa_checksum_batched_plain(x))
        hold("device_checksum", [device_checksum(x)],
             [device_checksum_plain(x)])
    t1_np = vols["sub000_T1w.npz"]
    t1 = torch.from_numpy(t1_np).cuda()
    payload = t1.view(torch.uint8).reshape(-1)
    n = t1.numel()
    one = QAStats.from_carry(*(t.cpu().numpy()[0] for t in
                               qa_checksum_batched_plain(t1.reshape(1, -1))))
    data = t1_np.tobytes()
    for chunk in (64 << 10, stream_mod.DEFAULT_CHUNK_BYTES, 1_000_003):
        acc = QAChecksumAccumulator(n, np.float32, device="cuda")
        for o in range(0, len(data), chunk):
            acc.update(data[o:o + chunk])
        st = acc.finalize()
        check(st == one, f"accumulator at {chunk}-byte chunks: {st} != {one}")
        # one launch, the way the accumulator makes it, from a carry 3 MiB in
        head = 768 * BLK_V
        carry = qa_checksum_chunk(payload[:head * 4], (0, 0, n, n),
                                  initial_carry("cuda"), dtype=torch.float32,
                                  blk_v=BLK_V, nblocks=768)
        nb = chunk // (BLK_V * 4) or 1
        part = payload[head * 4:(head + nb * BLK_V) * 4]
        kw = dict(dtype=torch.float32, blk_v=BLK_V, nblocks=nb)
        hold("qa_checksum_chunk",
             qa_checksum_chunk(part, (head, head, n, n), carry, **kw),
             qa_checksum_chunk_plain(part, (head, head, n, n), carry, **kw))
    log(f"kernels vs plain, max abs err: {errs}")
    check(all(e == 0.0 for e in errs.values()), f"kernels disagree: {errs}")

    # -- 6. timing at the main path's shapes ----------------------------------
    timer = Timer()
    t1r = t1.reshape(1, -1)
    dwi = torch.from_numpy(vols["sub000_dwi.npz"]).cuda().reshape(1, -1)
    nb4 = stream_mod.DEFAULT_CHUNK_BYTES // (BLK_V * 4)
    chunk4 = payload[:nb4 * BLK_V * 4]
    off4, carry0 = (0, 0, n, n), initial_carry("cuda")
    kw4 = dict(dtype=torch.float32, blk_v=BLK_V, nblocks=nb4)
    calls = {
        "qa_checksum": (lambda: qa_checksum_batched(t1r),
                        lambda: qa_checksum_batched_plain(t1r),
                        qa_bound(n, 4)),
        "qa_checksum_chunk": (
            lambda: qa_checksum_chunk(chunk4, off4, carry0, **kw4),
            lambda: qa_checksum_chunk_plain(chunk4, off4, carry0, **kw4),
            qa_bound(nb4 * BLK_V, 4)),
        "device_checksum": (lambda: device_checksum(t1),
                            lambda: device_checksum_plain(t1),
                            _bound(n * 4 + 8, 4 * n)),
    }
    timing = {}
    for name, (kern, plain, (b_ms, b_by)) in calls.items():
        timing[name] = (timer(kern), timer(plain, reps=5), b_ms, b_by)
        log(f"time {name}: kernel {timing[name][0]} ms, plain "
            f"{timing[name][1]} ms, bound {b_ms} ms ({b_by})")
    dwi_ms = timer(lambda: qa_checksum_batched(dwi))
    log(f"time qa_checksum at DWI {DWI}: kernel {dwi_ms} ms, bound "
        f"{qa_bound(dwi.numel(), 4)[0]} ms")
    for name in ("qa_checksum", "qa_checksum_chunk"):
        for kernel, us in profile_kernels(calls[name][0]).items():
            log(f"profile {name}: {kernel} {us} us per launch")

    # ingest split: kernel time = launches x median time at that shape
    n_dwi = sum(1 for r in qa_recs if r.source.endswith("_dwi.npz"))
    k_s = {"0": ((len(qa_recs) - n_dwi) * timing["qa_checksum"][0]
                 + n_dwi * dwi_ms) / 1e3,
           "1": l1["qa_checksum_chunk"] * timing["qa_checksum_chunk"][0]
           / 1e3}
    for mode, (_, _, _, wall, rep) in ingests.items():
        log(f"ingest split stream={mode}: wall {wall} s, kernels {k_s[mode]}"
            f" s ({100 * k_s[mode] / wall} %), host work and copies "
            f"{wall - k_s[mode]} s")

    launches = {"qa_checksum": l0["qa_checksum"],
                "qa_checksum_chunk": l1["qa_checksum_chunk"],
                # K3 is not on the main path: the JAX package calls it
                # only from tests
                "device_checksum": l0["device_checksum"]
                + l1["device_checksum"]}
    return [{"name": name, "route": "cuda", "source": CHECKSUM_CU,
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": errs[name], "ms": timing[name][0],
             "plain_ms": timing[name][1], "bound_ms": timing[name][2],
             "bound_by": timing[name][3], "library_ms": None}
            for name, replaces in KERNELS.items()]


def profile_kernels(fn, reps=5):
    """Device time per launch of each CUDA kernel ``fn`` launches, from
    torch.profiler (CUPTI); an empty dict if the trace holds no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0)
        if us and e.count:
            name = e.key.replace("(anonymous namespace)::", "")
            out[name.split("(")[0]] = us / e.count
    return out


if __name__ == "__main__":
    sys.exit(main())
