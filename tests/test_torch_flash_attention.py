"""The port's flash attention (K5) held against the JAX package on the CPU:
its Pallas kernel (interpret mode) and ``attention_ref``, over the sweep of
``tests/test_kernels.py`` (GQA, a padded Sq = 200, causal on and off,
window 64), plus the model layout and a query offset.

Here the wrapper runs the kernel's plain version (the tensors lie on the
CPU); the CUDA kernel is held against that plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Tolerances, as the reference sets them on its own kernel: 2e-5 absolute in
float32 (sums in another order), 3e-2 in bfloat16 (outputs rounded once to
bf16 from an f32 accumulator on both sides; one bf16 step near 1 is 2^-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (attention_ref, flash_attention,
                                           flash_attention_op)
from repro_torch.kernels.flash_attention import LAUNCHES
from repro_torch.kernels.flash_attention import \
    flash_attention as port_flash
from repro_torch.kernels.flash_attention import \
    flash_attention_op as port_flash_op
from repro_torch.kernels.flash_attention import flash_attention_plain

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(B, H, KV, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, D)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, D)).astype(np.float32))


def _both(arrs, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                                - np.asarray(b, np.float32))))


@pytest.mark.parametrize("B,H,KV,S,D", [
    (2, 4, 2, 256, 64), (1, 8, 8, 128, 32), (2, 4, 1, 200, 64),
    (1, 2, 2, 384, 128),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_and_ref(B, H, KV, S, D, dtype,
                                                causal):
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(B, H, KV, S, S, D), dtype)
    tol = DTYPES[dtype][2]
    got = port_flash(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    got = got.float().numpy()
    assert _err(got, flash_attention(qj, kj, vj, causal=causal,
                                     interpret=True)) < tol
    assert _err(got, attention_ref(qj, kj, vj, causal=causal)) < tol


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_sliding_window(dtype):
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(2, 4, 2, 256, 256, 64, 1),
                                       dtype)
    tol = DTYPES[dtype][2]
    got = port_flash(qt, kt, vt, causal=True, window=64).float().numpy()
    assert _err(got, flash_attention(qj, kj, vj, causal=True, window=64,
                                     interpret=True)) < tol
    assert _err(got, attention_ref(qj, kj, vj, causal=True,
                                   window=64)) < tol


@pytest.mark.parametrize("causal", [True, False])
def test_op_takes_the_model_layout(causal):
    """(B, S, H, Dh) in and out, as ``flash_attention_op`` of the JAX
    package."""
    q, k, v = (a.transpose(0, 2, 1, 3) for a in _qkv(1, 4, 2, 200, 200, 32,
                                                     2))
    (qj, kj, vj), (qt, kt, vt) = _both((q, k, v), "bfloat16")
    got = port_flash_op(qt, kt, vt, causal=causal)
    assert got.shape == qt.shape
    want = flash_attention_op(qj, kj, vj, causal=causal, interpret=True)
    assert _err(got.float(), want) < 3e-2


@pytest.mark.parametrize("start,stop", [(0, 64), (130, 200), (448, 512)])
def test_query_offset_equals_a_slice_of_the_whole(start, stop):
    """A block of query rows at their absolute positions gives the rows of
    the whole computation: how the card's checks sample a few query tiles
    of a 180k-token sequence."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 512, 512, 32, 3))
    whole = flash_attention_plain(q, k, v, causal=True, chunk=128)
    part = flash_attention_plain(q[:, :, start:stop], k, v, causal=True,
                                 q_offset=start)
    assert _err(part, whole[:, :, start:stop]) < 2e-5


def test_chunking_does_not_change_the_result():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 300, 300, 16, 4))
    a = flash_attention_plain(q, k, v, chunk=2048)
    b = flash_attention_plain(q, k, v, chunk=64)
    assert _err(a, b) < 2e-5


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_default_scale_is_the_one_over_sqrt_dh_call(dtype):
    """``scale`` left out and ``scale=1/sqrt(Dh)`` given are the same
    call, bit for bit (the kernel receives the same float either way)."""
    _, tdt, _ = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(tdt)
               for a in _qkv(1, 4, 2, 70, 70, 32, 6))
    assert torch.equal(flash_attention_plain(q, k, v),
                       flash_attention_plain(q, k, v,
                                             scale=1 / np.sqrt(32)))
    assert torch.equal(port_flash(q, k, v),
                       port_flash(q, k, v, scale=float(1 / np.sqrt(32))))


@pytest.mark.parametrize("causal", [True, False])
def test_scale_one_over_dh(causal):
    """granite-4.0-h-small's softmax scale, 1 / Dh (attention_multiplier
    1/128 at Dh 128): the plain version against softmax(q k^T / Dh) v in
    float64, within the float32 tolerance; the default scale differs."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 2, 96, 96, 128, 7))
    got = flash_attention_plain(q, k, v, causal=causal, scale=1 / 128)
    qd, kd, vd = (t.double() for t in (q, k.repeat_interleave(4, 1),
                                       v.repeat_interleave(4, 1)))
    s = qd @ kd.transpose(-1, -2) / 128
    if causal:
        s = s.masked_fill(torch.ones(96, 96, dtype=torch.bool).triu(1),
                          -np.inf)
    want = torch.softmax(s, -1) @ vd
    assert float((got.double() - want).abs().max()) < 2e-5
    assert float((flash_attention_plain(q, k, v, causal=causal).double()
                  - want).abs().max()) > 1e-2


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 4, 2, 70, 70, 32, 5))
    before = LAUNCHES["flash_attention"]
    assert torch.equal(port_flash(q, k, v), flash_attention_plain(q, k, v))
    assert LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("bad", ["dtype", "mixed", "gqa", "rank", "window",
                                 "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16), \
        torch.zeros(1, 2, 8, 16)
    kw = {}
    if bad == "dtype":
        q, k, v = (t.to(torch.float16) for t in (q, k, v))
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "gqa":
        k, v = torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16)
    elif bad == "rank":
        q = q[0]
    elif bad == "window":
        kw["window"] = 0
    else:
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises(ValueError):
        port_flash(q, k, v, **kw)


@pytest.mark.parametrize("view,in_place", [
    ("model_layout", True),       # (B, S, H, Dh) transposed to (B, H, S, Dh)
    ("fused_qkv_split", True),    # q sliced from one (B, S, (H+2KV) Dh)
    ("dense", True),
    ("size_one_dim_odd_stride", True),  # a dim of size 1 is never stepped
    ("odd_row_stride", False),    # rows 33 elements apart
    ("misaligned_start", False),  # starts 2 bytes past a 16-byte boundary
    ("last_dim_strided", False),
])
def test_kernel_operand_reads_in_place_only_what_tma_allows(view, in_place):
    """The bf16 kernel loads through TMA tensor maps: a view is read where
    it lies if it starts 16-byte aligned, its last dim is dense and every
    other stride of a dim longer than 1 is a multiple of 8 elements; else
    the wrapper hands the kernel a dense copy (same values). float32 views
    need only the dense last dim."""
    from repro_torch.kernels.flash_attention import kernel_operand
    base = torch.zeros(2 * 3 * 64 * 72, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    if view == "model_layout":
        t = base[:2 * 64 * 3 * 32].view(2, 64, 3, 32).transpose(1, 2)
    elif view == "fused_qkv_split":
        t = base[:2 * 64 * 5 * 32].view(2, 64, 5 * 32)[..., 32:96] \
            .view(2, 64, 2, 32).transpose(1, 2)
    elif view == "dense":
        t = base[:2 * 3 * 64 * 32].view(2, 3, 64, 32)
    elif view == "size_one_dim_odd_stride":
        t = base[:3 * 64 * 32].as_strided((1, 3, 64, 32), (7, 2048, 32, 1))
    elif view == "odd_row_stride":
        t = base[:3 * 64 * 33].view(1, 3, 64, 33)[..., :32]
    elif view == "misaligned_start":
        t = base[1:1 + 3 * 64 * 32].view(1, 3, 64, 32)
    else:
        t = base[:3 * 64 * 64].view(1, 3, 64, 64)[..., ::2]
    got = kernel_operand(t)
    assert (got.data_ptr() == t.data_ptr()) == in_place
    assert torch.equal(got, t)
    if not in_place:
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
    f32 = torch.zeros(1, 3, 64, 33)[..., :32]     # the SIMT kernel's rule
    assert kernel_operand(f32) is f32
