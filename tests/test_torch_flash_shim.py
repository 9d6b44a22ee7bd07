"""The CUDA source of flash attention (K5), built for the CPU through
``tools/cuda_shim`` and held against its plain version.

The shim runs ``flash_attention.cu`` with one fiber per CUDA thread and
stands in for its inline PTX: TMA box loads with the swizzle, mbarriers,
setmaxnreg and wgmma read through its shared-memory descriptors. So the
kernel's own logic runs here: the mbarrier ring's phases, the fragment
layouts, the masks and skipped tiles, GQA, offsets and strided views. What
the shim cannot show (the PTX's syntax, and whether the card reads the
descriptors as the shim does) the card tests show: ``tests/
test_torch_cuda.py`` with the ``cuda`` marker, on a GPU.

The C function is called directly with CPU pointers (the wrapper itself
runs the plain version for CPU tensors). Tolerance as on the card: each
64-row query tile within 3e-2 (bf16) or 2e-5 (f32) absolute and 2^-6 or
2^-12 of the tile's largest |output|.
"""
import ctypes
import functools
import shutil
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention.flash_attention import (
    _ARGTYPES, run_kernel)

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
TOL = {torch.float32: (2e-5, 2 ** -12), torch.bfloat16: (3e-2, 2 ** -6)}


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
                                / "libflash_attention.so")))
    f = lib.repro_flash_attention
    f.argtypes, f.restype = _ARGTYPES, ctypes.c_int
    return functools.partial(run_kernel, f)


def _close(got, want):
    tol, rel = TOL[want.dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    for r in range(0, want.shape[2], 64):
        w = want[:, :, r:r + 64].float()
        e = (got[:, :, r:r + 64].float() - w).abs().max().item()
        assert e <= min(tol, rel * w.abs().max().item()), (r, e)


def _qkv(B, H, KV, Sq, Sk, D, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, H, Sq, D, generator=g).to(dtype),
            *(torch.randn(B, KV, Sk, D, generator=g).to(dtype)
              for _ in range(2)))


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_every_head_dim_with_a_ragged_key_tile(kernel, D, causal):
    q, k, v = _qkv(1, 4, 2, 200, 200, D, D)
    _close(kernel(q, k, v, causal=causal),
           fa.flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.parametrize("Sq,causal", [(1, True), (1, False), (50, True)])
def test_fewer_queries_than_a_block(kernel, Sq, causal):
    q, k, v = _qkv(2, 2, 1, Sq, 300, 64, Sq)
    kw = dict(causal=causal, q_offset=300 - Sq)
    _close(kernel(q, k, v, **kw), fa.flash_attention_plain(q, k, v, **kw))


@pytest.mark.parametrize("start", [37, 130])
def test_offset_inside_a_tile(kernel, start):
    q, k, v = _qkv(1, 2, 2, 300, 300, 32, start)
    _close(kernel(q[:, :, start:start + 70], k, v, q_offset=start),
           fa.flash_attention_plain(q, k, v)[:, :, start:start + 70])


@pytest.mark.parametrize("causal", [True, False])
def test_window_skips_whole_tiles(kernel, causal):
    q, k, v = _qkv(1, 2, 1, 600, 600, 64, 6)
    kw = dict(causal=causal, window=64)
    _close(kernel(q, k, v, **kw), fa.flash_attention_plain(q, k, v, **kw))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 64, 330),       # rows 363.. have no key in their window
    (True, 64, 400),       # no row has a key
    (False, 64, 400),
    (True, None, -20),     # rows before the first key
])
def test_rows_with_no_key_average_every_key(kernel, dtype, causal, window,
                                            q_offset):
    q, k, v = _qkv(1, 2, 1, 50, 300, 64, 7, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _close(kernel(q, k, v, **kw), fa.flash_attention_plain(q, k, v, **kw))


@pytest.mark.parametrize("H,KV,D", [(8, 2, 128), (48, 1, 128)])
def test_grouped_query_heads(kernel, H, KV, D):
    q, k, v = _qkv(1, H, KV, 20, 130, D, H)
    kw = dict(q_offset=110)
    _close(kernel(q, k, v, **kw), fa.flash_attention_plain(q, k, v, **kw))


def test_scale_one_over_dh(kernel):
    """The softmax scale passed through: 1 / Dh at Dh 128 (granite-4.0-h-
    small's attention_multiplier), GQA 4 / 2, causal, against the plain
    version at the same scale."""
    q, k, v = _qkv(1, 4, 2, 70, 70, 128, 9)
    _close(kernel(q, k, v, scale=1 / 128),
           fa.flash_attention_plain(q, k, v, scale=1 / 128))


def test_fused_qkv_split_and_a_misaligned_view(kernel):
    H, KV, D, S = 4, 2, 64, 200
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, S, (H + 2 * KV) * D, generator=g).to(torch.bfloat16)
    q, k, v = (qkv[..., a * D:b * D].view(2, S, b - a, D).transpose(1, 2)
               for a, b in ((0, H), (H, H + KV), (H + KV, H + 2 * KV)))
    _close(kernel(q, k, v), fa.flash_attention_plain(q, k, v))
    x = torch.randn(1, 6, 130, 33, generator=g).to(torch.bfloat16)
    q, k, v = x[:, :4, :, 1:], x[:, 4:5, :, 1:], x[:, 5:, :, 1:]
    _close(kernel(q, k, v), fa.flash_attention_plain(q, k, v))


def test_float32_kernel(kernel):
    q, k, v = _qkv(1, 2, 1, 130, 130, 32, 3, torch.float32)
    _close(kernel(q, k, v), fa.flash_attention_plain(q, k, v))
