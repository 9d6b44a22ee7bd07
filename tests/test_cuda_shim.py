"""The CUDA shim's fiber scheduler (``tools/cuda_shim``), on small CUDA
sources built through ``build.py``.

Each CUDA thread of a block is a fiber on the calling OS thread, resumed
round robin in ascending ``threadIdx`` order in one launch of a launch site
and descending in the next. These tests hold it to CUDA's answers: a block
barrier orders shared-memory writes before reads; the shuffles and votes
give each lane what the card gives it; ``threadIdx`` and ``blockIdx`` stay
each fiber's own across many switches on a 3-D grid; a read of shared
memory that another warp writes with no barrier between them is wrong in
one of the two orders; and a block none of whose threads can run aborts at
once, naming the barrier, its phase and the waiting threads (in a
subprocess, so the abort does not end this one).
"""
import ctypes
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]

SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>

// rounds of: write my value, barrier, add a neighbour's, barrier
__global__ void barrier_kernel(const int* in, int* out, int rounds) {
  extern __shared__ int sm[];
  const int t = threadIdx.x, n = blockDim.x;
  int v = in[blockIdx.x * n + t];
  for (int r = 0; r < rounds; ++r) {
    sm[t] = v;
    __syncthreads();
    v += sm[(t + 1 + r) % n];
    __syncthreads();
  }
  out[blockIdx.x * n + t] = v;
}

__global__ void shuffle_kernel(const int* in, int* out, int op, int arg) {
  const int t = threadIdx.x;
  int v = in[t], r = 0;
  if (op == 0) r = __shfl_xor_sync(0xffffffffu, v, arg);
  if (op == 1) r = __shfl_down_sync(0xffffffffu, v, unsigned(arg));
  if (op == 2) r = __shfl_up_sync(0xffffffffu, v, unsigned(arg));
  if (op == 3) r = __any_sync(0xffffffffu, v > arg);
  if (op == 4) {                        // the warp's sum in every lane
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    r = v;
  }
  out[t] = r;
}

// every thread's indices after many switches, and whether they ever changed
__global__ void index_kernel(int* out, int rounds) {
  const unsigned t = threadIdx.x, bx = blockIdx.x, by = blockIdx.y,
                 bz = blockIdx.z;
  int changed = 0;
  for (int r = 0; r < rounds; ++r) {
    if (r % 3 == 0) __syncthreads();
    else if (r % 3 == 1) __syncwarp();
    else (void)__shfl_xor_sync(0xffffffffu, int(t), 1);
    changed += threadIdx.x != t || threadIdx.y != 0 || threadIdx.z != 0 ||
               blockIdx.x != bx || blockIdx.y != by || blockIdx.z != bz;
  }
  const unsigned b = (bz * gridDim.y + by) * gridDim.x + bx;
  int* o = out + 5 * (b * blockDim.x + t);
  o[0] = int(t);
  o[1] = int(bx);
  o[2] = int(by);
  o[3] = int(bz);
  o[4] = changed;
}

// warp 1 writes, warp 0 reads, with or without a barrier between them
__global__ void race_kernel(int* out, int sync) {
  extern __shared__ int sm[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (warp == 1) sm[lane] = lane + 1;
  if (sync) __syncthreads();
  if (warp == 0) out[lane] = sm[lane];
}

__global__ void hang_block_kernel() {   // half the block at the barrier
  if (threadIdx.x < 64) __syncthreads();
}
__global__ void hang_warp_kernel() {    // half of each warp at its barrier
  if (threadIdx.x % 32 < 16) __syncwarp();
}
__global__ void hang_mbar_kernel() {    // a phase no thread arrives on
  if (threadIdx.x == 0) mbar_init(0, 1);
  __syncthreads();
  mbar_wait(0, 0);
}

extern "C" {
int run_barrier(const int* in, int* out, int blocks, int threads, int rounds) {
  barrier_kernel<<<blocks, threads, threads * 4>>>(in, out, rounds);
  return 0;
}
int run_shuffle(const int* in, int* out, int threads, int op, int arg) {
  shuffle_kernel<<<1, threads, 0>>>(in, out, op, arg);
  return 0;
}
int run_index(int* out, int gx, int gy, int gz, int threads, int rounds) {
  index_kernel<<<dim3(gx, gy, gz), threads, 0>>>(out, rounds);
  return 0;
}
int run_race(int* out, int sync) {
  race_kernel<<<1, 64, 128>>>(out, sync);
  return 0;
}
void hang_block() { hang_block_kernel<<<1, 128, 0>>>(); }
void hang_warp() { hang_warp_kernel<<<1, 64, 0>>>(); }
void hang_mbar() { hang_mbar_kernel<<<1, 128, 64>>>(); }
}
"""


@pytest.fixture(scope="module")
def lib_path(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source through the shim")
    sys.path.insert(0, str(ROOT / "tools" / "cuda_shim"))
    try:
        from build import build
    finally:
        sys.path.pop(0)
    d = tmp_path_factory.mktemp("cuda_shim")
    (d / "fibers.cu").write_text(SRC)
    return build(d / "fibers.cu", d / "libfibers.so")


@pytest.fixture(scope="module")
def lib(lib_path):
    return ctypes.CDLL(str(lib_path))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_a_block_barrier_orders_writes_before_reads(lib):
    blocks, n, rounds = 3, 96, 7
    x = np.random.default_rng(0).integers(-1000, 1000, (blocks, n)).astype(
        np.int32)
    want = x.copy()
    for r in range(rounds):
        want = want + np.roll(want, -(1 + r) % n, axis=1)
    for _ in range(2):                   # both resume orders
        out = np.full_like(x, -1)
        lib.run_barrier(_ptr(x), _ptr(out), blocks, n, rounds)
        np.testing.assert_array_equal(out, want)


def _shuffle_want(x, op, arg):
    w = x.reshape(-1, 32)
    lane = np.arange(32)
    if op == "xor":
        return w[:, lane ^ arg]
    if op == "down":
        return np.where(lane + arg < 32, w[:, np.minimum(lane + arg, 31)], w)
    if op == "up":
        return np.where(lane >= arg, w[:, np.maximum(lane - arg, 0)], w)
    if op == "any":
        return np.repeat((w > arg).any(1, keepdims=True), 32, 1).astype(
            np.int32)
    return np.repeat(w.sum(1, keepdims=True, dtype=np.int32), 32, 1)


@pytest.mark.parametrize("op,arg", [
    ("xor", 1), ("xor", 16), ("down", 1), ("down", 5), ("up", 3),
    ("up", 31), ("any", 990), ("sum", 0)])
def test_shuffles_and_votes_give_the_cuda_answers(lib, op, arg):
    code = ["xor", "down", "up", "any", "sum"].index(op)
    n = 96
    x = np.random.default_rng(code).integers(-1000, 990, n).astype(np.int32)
    x[40] = 995                          # one lane of warp 1 only above 990
    want = _shuffle_want(x, op, arg).reshape(-1)
    for _ in range(2):
        out = np.full_like(x, -7)
        lib.run_shuffle(_ptr(x), _ptr(out), n, code, arg)
        np.testing.assert_array_equal(out, want)


def test_thread_and_block_indices_survive_many_switches(lib):
    gx, gy, gz, n = 3, 2, 2, 96
    for _ in range(2):
        out = np.full((gz, gy, gx, n, 5), -1, np.int32)
        lib.run_index(_ptr(out), gx, gy, gz, n, 40)
        z, y, x, t = np.meshgrid(np.arange(gz), np.arange(gy), np.arange(gx),
                                 np.arange(n), indexing="ij")
        np.testing.assert_array_equal(out[..., 0], t)
        np.testing.assert_array_equal(out[..., 1], x)
        np.testing.assert_array_equal(out[..., 2], y)
        np.testing.assert_array_equal(out[..., 3], z)
        assert not out[..., 4].any()


def test_a_missing_barrier_shows_in_one_resume_order(lib):
    want = np.arange(1, 33, dtype=np.int32)
    right = []
    for sync in (1, 1, 0, 0):
        out = np.zeros(32, np.int32)
        lib.run_race(_ptr(out), sync)
        right.append(bool(np.array_equal(out, want)))
    # with the barrier right in both orders; without it, warp 0 reads
    # the 0xff fill when it runs first and warp 1's words when it runs last
    assert right[:2] == [True, True]
    assert sorted(right[2:]) == [False, True]


@pytest.mark.parametrize("entry,message", [
    ("hang_block", ["__syncthreads, phase 0, awaited by threads 0-63",
                    "returned: threads 64-127"]),
    ("hang_warp", ["the barrier of warp 0 (", "awaited by threads 0-15",
                   "the barrier of warp 1 (", "awaited by threads 32-47",
                   "returned: threads 16-31, 48-63"]),
    ("hang_mbar", ["the mbarrier at 0, phase 0, parity 0 awaited by "
                   "threads 0-127"]),
])
def test_a_hang_aborts_at_once_naming_the_barrier(lib_path, entry, message,
                                                  tmp_path):
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-c",
         "import ctypes, resource, sys; "     # no core file from the abort
         "resource.setrlimit(resource.RLIMIT_CORE, (0, 0)); "
         f"ctypes.CDLL(sys.argv[1]).{entry}()", str(lib_path)],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    took = time.monotonic() - t0
    assert r.returncode != 0, r
    assert "shim: hang: no thread of block (0, 0, 0) can run" in r.stderr
    for m in message:
        assert m in r.stderr, r.stderr
    assert took < 10, took
