"""The CUDA source of the Mamba-2 SSD chunk scan (K6), built for the CPU
through ``tools/cuda_shim`` and held against its plain version.

The shim runs ``mamba2_ssd.cu`` with one fiber per CUDA thread, its four
kernels in order, and stands in for its inline PTX: the split-TF32
``mma.sync`` fragments in PTX's layout, ``cvt.rna.tf32`` and the
``cp.async`` stages (a copy's destination reads NaN until its wait). So
the kernels' own logic runs here: the C B^T tiles shared by the heads, the
block-wide cumsum, the state pass over the chunks, the decay factored
around each query tile, the two-stage copies, the masks of ragged chunks
and tiles, and strided views. What the shim cannot show (that the card
compiles the source, and its speed) the card tests show:
``tests/test_torch_cuda.py`` with the ``cuda`` marker, on a GPU.

The C function is called directly with CPU pointers through
``mamba2_ssd.run_kernel`` (the wrapper itself runs the plain version for
CPU tensors). Tolerance as on the card, ``SCAN_TOL``: y and the final state
within 1e-4 of max(1, max|ref|), the bound the reference holds its own
kernel to (``tests/test_kernels.py``). The broken-output controls show
that bound rejects a scan that drops the inter-chunk term or the carried
state at these shapes.
"""
import ctypes
import functools
import shutil
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import mamba2_ssd as k6
from repro_torch.kernels.mamba2_ssd.mamba2_ssd import run_kernel

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src/repro_torch/kernels/mamba2_ssd/csrc/mamba2_ssd.cu"
SCAN_TOL = 1e-4


@pytest.fixture(scope="module")
def kernel(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source through the shim")
    sys.path.insert(0, str(ROOT / "tools" / "cuda_shim"))
    try:
        from build import build
    finally:
        sys.path.pop(0)
    lib = ctypes.CDLL(str(build(CU, tmp_path_factory.mktemp("shim")
                                / "libmamba2_ssd.so")))
    return functools.partial(run_kernel, lib)


def _rel(got, want):
    if want.numel() == 0:
        return 0.0
    return float((got.float() - want.float()).abs().max()
                 / max(1.0, float(want.float().abs().max())))


def _inputs(B, H, S, dh, N, seed, model_layout, decay=0.1):
    """The reference's test distributions; in the model's layout x and lw
    are transposed views of (B, S, H, ...) tensors and B, C slices of one
    wider projection, read in place."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, dh, generator=g)
    lw = -torch.randn(B, S, H, generator=g).abs() * decay
    bc = torch.randn(B, S, 2 * N + 5, generator=g) * 0.3
    s0 = torch.randn(B, H, dh, N, generator=g)
    x, lw = x.transpose(1, 2), lw.transpose(1, 2)
    if not model_layout:
        x, lw = x.contiguous(), lw.contiguous()
    return (x, lw, bc[..., 5:5 + N], bc[..., 5 + N:]), s0


# ragged S everywhere; chunks of 32 to 256 and one that is no multiple of
# 64; dh and N of 16, 32 and 64; 10 chunks in the first case; N 128, two
# 64-wide tiles of the state (granite-4.0-h-small's widths), small: a
# block of 256 threads is 256 host threads here
SHAPES = [(2, 1, 300, 16, 16, 32), (2, 1, 200, 32, 64, 64),
          (1, 2, 300, 64, 32, 128), (1, 1, 600, 64, 64, 256),
          (2, 1, 77, 16, 8, 100), (1, 1, 70, 64, 128, 64)]


@pytest.mark.parametrize("B,H,S,dh,N,chunk", SHAPES)
@pytest.mark.parametrize("with_state,model_layout", [(False, False),
                                                     (True, True)])
def test_kernel_matches_plain(kernel, B, H, S, dh, N, chunk, with_state,
                              model_layout):
    args, s0 = _inputs(B, H, S, dh, N, S + chunk, model_layout)
    s0 = s0 if with_state else None
    y, st = kernel(*args, chunk=chunk, state=s0)
    yp, sp = k6.ssd_chunked_plain(*args, chunk=chunk, state=s0)
    assert y.shape == yp.shape and st.shape == sp.shape
    assert _rel(y, yp) < SCAN_TOL and _rel(st, sp) < SCAN_TOL
    assert y.stride() == args[0].stride()      # laid out like x


@pytest.mark.parametrize("S,chunk", [(0, 32), (1, 32), (5, 1), (130, 130)])
def test_short_and_odd_chunks(kernel, S, chunk):
    args, s0 = _inputs(1, 1, S, 16, 8, chunk, False)
    y, st = kernel(*args, chunk=chunk, state=s0)
    yp, sp = k6.ssd_chunked_plain(*args, chunk=chunk, state=s0)
    assert _rel(y, yp) < SCAN_TOL and _rel(st, sp) < SCAN_TOL


def test_kernel_matches_the_sequential_oracle(kernel):
    (x, lw, Bm, Cm), _ = _inputs(1, 2, 300, 32, 16, 5, True)
    y, _ = kernel(x, lw, Bm, Cm, chunk=32)
    assert _rel(y, k6.ssd_ref(x, lw, Bm, Cm)) < SCAN_TOL


def _by_chunk(args, lo, hi):
    x, lw, Bm, Cm = args
    return x[:, :, lo:hi], lw[:, :, lo:hi], Bm[:, lo:hi], Cm[:, lo:hi]


@pytest.mark.parametrize("broken", ["inter-chunk term dropped",
                                    "carried state dropped"])
def test_broken_outputs_fail_the_check(kernel, broken):
    """On slow decays, whose state survives a chunk, the bound that holds
    the kernel rejects outputs of a scan that restarts each chunk from a
    zero state (y), or returns the last chunk's state alone."""
    B, H, S, dh, N, T = SHAPES[0]
    args, s0 = _inputs(B, H, S, dh, N, 3, True, decay=0.001)
    y, st = kernel(*args, chunk=T, state=s0)
    yp, sp = k6.ssd_chunked_plain(*args, chunk=T, state=s0)
    assert _rel(y, yp) < SCAN_TOL and _rel(st, sp) < SCAN_TOL
    parts = [k6.ssd_chunked_plain(*_by_chunk(args, lo, lo + T), chunk=T)
             for lo in range(0, S, T)]
    if broken == "inter-chunk term dropped":
        bad, want = torch.cat([p[0] for p in parts], 2), yp
    else:
        bad, want = parts[-1][1], sp
    assert _rel(bad, want) > 10 * SCAN_TOL
