"""The CUDA source of the RWKV-6 chunked WKV (K7), built for the CPU
through ``tools/cuda_shim`` and held against its plain version.

The shim runs ``rwkv6.cu`` with one fiber per CUDA thread and its three
kernels in order (and, once the source has them, stands in for its inline
PTX). So the kernels' own logic runs here: the block-wide cumsum, the
state pass over the chunks, the decays factored around 16-step
sub-chunks, the pairwise scores inside a sub-chunk, the masks of ragged
chunks and tiles, bf16 and f32 inputs, and strided views. What the shim
cannot show (that the card compiles the source, and its speed) the card
tests show: ``tests/test_torch_cuda.py`` with the ``cuda`` marker, on a
GPU.

The C function is called directly with CPU pointers through
``rwkv6.run_kernel`` (the wrapper itself runs the plain version for CPU
tensors). Tolerance as on the card, ``SCAN_TOL``: out and the final state
within 1e-4 of max(1, max|ref|), the bound the reference holds its own
kernel to (``tests/test_kernels.py``). The broken-output controls build
copies of the source with one part broken (the state pass, the
inter-chunk term, a sub-chunk factor's reference step) and show that the
bound rejects each.
"""
import ctypes
import functools
import shutil
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import rwkv6 as k7
from repro_torch.kernels.rwkv6.rwkv6 import run_kernel

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu"
SCAN_TOL = 1e-4

# broken copies of the source: what is broken -> (the text replaced, its
# replacement); each text must occur in the source
BROKEN = {
    # every chunk enters with the given state: nothing carried
    "state pass dropped": ("s = dk[i] * s + ds[i];", "s = s;"),
    # each chunk's entering state read as zero: out without (r o exp(cumex)) S
    "inter-chunk term dropped": (
        "copy_tile(R, kLdC, a.st + bhc * a.dh * a.dh, a.dh, a.dh, a.dh);",
        "copy_tile(R, kLdC, a.st + bhc * a.dh * a.dh, a.dh, 0, a.dh);"),
    # q's reference step one row late (the sub-chunk's first row, not the
    # row before it), while D and the state's factor keep the right one
    "sub-chunk reference step off by one": (
        "- bnd(g0 + t / kSub, d));",
        "- cum[kSub * (g0 + t / kSub) * kLdR + d]);"),
}


def _build(src: Path, out: Path):
    sys.path.insert(0, str(ROOT / "tools" / "cuda_shim"))
    try:
        from build import build
    finally:
        sys.path.pop(0)
    return functools.partial(run_kernel, ctypes.CDLL(str(build(src, out))))


@pytest.fixture(scope="module")
def shim_dir(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source through the shim")
    return tmp_path_factory.mktemp("shim")


@pytest.fixture(scope="module")
def kernel(shim_dir):
    return _build(CU, shim_dir / "librwkv6.so")


def _rel(got, want):
    if want.numel() == 0:
        return 0.0
    return float((got.float() - want.float()).abs().max()
                 / max(1.0, float(want.float().abs().max())))


# decay laws (log-decay = -exp(scale z + shift), clipped at -20 as the
# model clips): the card tests' two, and the model's init (w0 = -6),
# whose state survives a chunk
DECAYS = {"reference": (0.5, -2.0), "strong": (2.0, -1.0),
          "slow": (0.5, -6.0)}


def _inputs(B, H, S, dh, seed, dtype, decay):
    """r, k, v, logw as transposed (strided) views of (B, S, H, dh)
    tensors, as the model hands them over; u and a random state."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(B, S, H, dh, generator=g).to(dtype)
               for _ in range(3))
    scale, shift = DECAYS[decay]
    z = torch.randn(B, S, H, dh, generator=g)
    lw = (-torch.exp(z * scale + shift)).clamp(-20.0, -1e-6)
    u = torch.randn(H, dh, generator=g) * 0.3
    s0 = torch.randn(B, H, dh, dh, generator=g)
    return [t.transpose(1, 2) for t in (r, k, v, lw)] + [u], s0


F32, BF16 = torch.float32, torch.bfloat16
# ragged S everywhere; chunks 32 (5 of them), 100 (no multiple of 16 or 64)
# and 128 (the model's); dh 16, 32 and 64; both dtypes, every decay law and
# no state, a zero one and a given one, each at least twice
CASES = [(2, 1, 150, 16, 32, F32, "slow", "none"),
         (2, 1, 150, 16, 32, BF16, "strong", "given"),
         (1, 2, 177, 32, 100, BF16, "slow", "zero"),
         (1, 2, 177, 32, 100, F32, "strong", "given"),
         (1, 1, 250, 64, 128, BF16, "reference", "given"),
         (1, 1, 250, 64, 128, F32, "slow", "none"),
         (1, 1, 130, 64, 128, BF16, "strong", "zero"),
         (1, 1, 130, 32, 128, F32, "reference", "given")]


@pytest.mark.parametrize("B,H,S,dh,chunk,dtype,decay,state", CASES)
def test_kernel_matches_plain(kernel, B, H, S, dh, chunk, dtype, decay,
                              state):
    args, s0 = _inputs(B, H, S, dh, S + chunk, dtype, decay)
    s0 = {"none": None, "zero": torch.zeros_like(s0), "given": s0}[state]
    o, st = kernel(*args, chunk=chunk, state=s0)
    op, sp = k7.wkv6_chunked_plain(*args, chunk=chunk, state=s0)
    assert o.dtype == torch.float32 and o.shape == op.shape
    assert st.shape == sp.shape
    assert _rel(o, op) < SCAN_TOL and _rel(st, sp) < SCAN_TOL
    assert bool(torch.isfinite(o).all() and torch.isfinite(st).all())
    assert o.stride() == args[0].stride()      # laid out like r


@pytest.mark.parametrize("S,chunk", [(0, 32), (1, 32), (5, 1), (130, 130)])
def test_short_and_odd_chunks(kernel, S, chunk):
    args, s0 = _inputs(1, 1, S, 16, chunk, torch.float32, "reference")
    o, st = kernel(*args, chunk=chunk, state=s0)
    op, sp = k7.wkv6_chunked_plain(*args, chunk=chunk, state=s0)
    assert _rel(o, op) < SCAN_TOL and _rel(st, sp) < SCAN_TOL


@pytest.mark.parametrize("decay", ["reference", "strong"])
def test_kernel_matches_the_sequential_oracle(kernel, decay):
    args, _ = _inputs(1, 1, 300, 64, 5, torch.float32, decay)
    o, _ = kernel(*args, chunk=128)
    assert _rel(o, k7.wkv6_ref(*args)) < SCAN_TOL


def test_a_chunk_past_shared_memory_fails_to_launch(kernel):
    args, _ = _inputs(1, 1, 8, 16, 0, torch.float32, "reference")
    with pytest.raises(RuntimeError, match="failed to launch"):
        kernel(*args, chunk=4096)


@pytest.mark.parametrize("broken", sorted(BROKEN))
def test_broken_kernels_fail_the_check(shim_dir, broken):
    """A copy of the source with one part broken gives outputs that the
    bound holding the kernel rejects, on slow decays from a random state
    (whose state survives a chunk) and on the reference decays."""
    old, new = BROKEN[broken]
    src = CU.read_text()
    assert old in src, f"the source no longer has {old!r}"
    path = shim_dir / f"broken_{sorted(BROKEN).index(broken)}.cu"
    path.write_text(src.replace(old, new))
    bad = _build(path, path.with_suffix(".so"))
    errors = []
    for decay in ("slow", "reference"):
        args, s0 = _inputs(1, 1, 150, 32, 3, torch.bfloat16, decay)
        o, st = bad(*args, chunk=32, state=s0)
        op, sp = k7.wkv6_chunked_plain(*args, chunk=32, state=s0)
        errors.append(max(_rel(o, op), _rel(st, sp)))
    assert max(errors) > 10 * SCAN_TOL, errors
