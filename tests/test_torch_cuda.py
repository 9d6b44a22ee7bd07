"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here skips without a GPU; on
an H100 run them with ``python -m pytest -m cuda tests/test_torch_cuda.py``
(``chip_smoke.py`` holds the same kernels at the main path's full sizes).
Tolerances: none for the checksum family (K1-K3) — the kernels keep the
plain versions' reduction order, so every output is bit-exact (min/max
equal by value), and so is RMSNorm (K4), whose plain version repeats the
kernel's order of the sum of squares. Flash attention (K5) sums in another
order than its plain version, and in bfloat16 hands the probabilities to
the tensor cores rounded to bf16. It is held on every 64-row query tile to
2e-5 absolute in float32 and 3e-2 in bfloat16, the tolerances the
reference sets on its own kernel (``tests/test_kernels.py``), and to 2^-12
(float32) or 2^-6 (bfloat16, two bf16 steps) of the tile's largest
|output|: late in a causal sequence the outputs average many keys and are
small, and the absolute tolerance alone would pass a wrong carry across
key tiles there. The chunk scans, the Mamba-2 SSD (K6) and the RWKV-6 WKV
(K7), sum in other orders than their plain versions and the sequential
oracles: y, outputs and final states within 1e-4 relative to max(1,
max|ref|), the bound the reference holds its own kernels to. Training
(``chip_smoke.py`` phase 5c at full size) runs no kernel: K4-K7 refuse an
input that requires grad under grad mode, and ``forward_train`` on the card
holds its f32 loss within 1e-4 relative and each gradient leaf within 1e-3
of its largest |value| of the port's own CPU run, a check that a detached
layer fails; checkpoints of card tensors restore bit-equal. The moe, audio
and vlm families run K4 and K5 at new shapes (d 768 and 8,192; Dh 128 with
8 query heads a kv head; 64 queries over 1,500 non-causal keys), held as
above; their MoE layer (no kernel: matmuls, a scatter and a gather) and
their f32 prefill are held to the CPU's within 1e-4 of the largest
|value|, with the experts each token chose equal. Training on a
DeviceMesh of one NCCL rank gives the one-device losses within 1e-5
relative (two NCCL ranks cannot share one card: multi-rank runs are the
CPU tests' gloo ranks), the elastic restore onto the card is bit-equal,
and the compressed sum's error is the CPU formula's bit for bit.
"""
import importlib
import math
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.checksum import (ACCUMULATOR_DTYPES, LAUNCHES,
                                          QAChecksumAccumulator, QAStats,
                                          device_checksum,
                                          device_checksum_plain, qa_checksum,
                                          qa_checksum_batched,
                                          qa_checksum_chunk, qa_stats, ref,
                                          reset_launches)

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_glue as glue
from repro_torch.kernels import mamba2_ssd as k6
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import rwkv6 as k7

# the module behind rn, for its C-call helpers (plan, run_kernel)
k4 = importlib.import_module("repro_torch.kernels.rmsnorm.rmsnorm")

pytestmark = pytest.mark.cuda

TORCH_DTYPES = {"float16": torch.float16, "float32": torch.float32,
                "int8": torch.int8, "uint8": torch.uint8,
                "int16": torch.int16, "uint16": torch.uint16,
                "int32": torch.int32, "uint32": torch.uint32,
                "bfloat16": torch.bfloat16}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    reset_launches()
    for mod in (rn, fa, k6, k7, glue):
        mod.reset_launches()
    return torch.device("cuda")


def _bytes(n, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 256, n, np.uint8))


def _values(shape, dtype, seed=0, raw=True):
    """Random bytes viewed as ``dtype`` (every bit pattern: subnormals, NaN
    and inf included), or, with ``raw=False``, floats drawn from a normal
    distribution, whose sums cannot overflow."""
    tdt = TORCH_DTYPES[dtype]
    if not raw and tdt.is_floating_point:
        x = np.random.default_rng(seed).normal(0, 50, shape)
        return torch.from_numpy(x.astype(np.float32)).to(tdt)
    n = int(np.prod(shape)) * tdt.itemsize
    return _bytes(n, seed).view(tdt).reshape(shape)


def _equal(got, want):
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), \
            (a, b)


@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
@pytest.mark.parametrize("shape", [(1,), (5,), (33, 7), (64, 64, 48),
                                   (3, 1001)])
def test_qa_checksum_kernel_equals_plain(cuda, dtype, shape):
    x = _values(shape, dtype, seed=len(shape))
    _equal(qa_checksum(x.to(cuda)), qa_checksum(x))
    _equal(qa_checksum_batched(x.reshape(shape[0], -1).to(cuda)),
           qa_checksum_batched(x.reshape(shape[0], -1)))
    _equal([device_checksum(x.to(cuda))], [device_checksum(x)])
    assert LAUNCHES["qa_checksum"] == 2 and LAUNCHES["device_checksum"] == 1


def test_kernels_equal_the_oracle_on_subnormals(cuda):
    x = np.asarray([1e-45, -3e-39, 1e-40, 2.0, -0.0] * 999, np.float32)
    got = qa_checksum(torch.from_numpy(x).to(cuda))
    for a, b in zip(got, ref.qa_checksum_ref(x)):
        assert np.array_equal(a.cpu().numpy(), b)


@pytest.mark.parametrize("dtype", ACCUMULATOR_DTYPES)
@pytest.mark.parametrize("chunk", [1000, 64 << 10, 1_000_003])
def test_chunk_kernel_accumulator_equals_one_shot(cuda, dtype, chunk):
    x = _values((70, 70, 41), dtype, seed=3, raw=False)
    data = x.numpy().tobytes()
    acc = QAChecksumAccumulator(x.numel(), x.numpy().dtype, device=cuda)
    for o in range(0, len(data), chunk):
        acc.update(data[o:o + chunk])
    st = acc.finalize()
    assert st == qa_stats(x) == QAStats.from_carry(
        *ref.qa_checksum_ref(x.numpy()))
    assert LAUNCHES["qa_checksum_chunk"] >= 1


def test_chunk_kernel_equals_plain_at_an_offset(cuda):
    x = _values((5000,), "float32", seed=4, raw=False)
    blk_v = 1024
    data = x[blk_v:].contiguous().view(torch.uint8)
    carry = (torch.tensor([7, -9], dtype=torch.int32),
             torch.tensor([-1.0, 2.0, 0.5]), torch.tensor([11], dtype=torch.int32))
    args = dict(dtype=torch.float32, blk_v=blk_v, nblocks=4)
    off = (blk_v, blk_v, 5000, 5000)
    got = qa_checksum_chunk(data.to(cuda), off,
                            tuple(c.to(cuda) for c in carry), **args)
    _equal(got, qa_checksum_chunk(data, off, carry, **args))


@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
@pytest.mark.parametrize("blk", [8, 256, 1024, 4096])
@pytest.mark.parametrize("G,nv", [(200, 3001), (2, 250_007), (1, 1_000_000)])
def test_qa_checksum_rows_and_steps(cuda, dtype, blk, G, nv):
    """Many rows, rows that are not 16-byte aligned (odd nv), steps from 8
    values (the scalar path) to 4096 (32 groups a lane in f32), a ragged
    last step."""
    x = _values((G, nv), dtype, seed=blk + G, raw=False)
    _equal(qa_checksum_batched(x.to(cuda), blk=blk),
           qa_checksum_batched(x, blk=blk))
    assert LAUNCHES["qa_checksum"] == 1


@pytest.mark.parametrize("dtype", ACCUMULATOR_DTYPES)
@pytest.mark.parametrize("blk_v,head,nb", [(1024, 63, 4), (64, 1022, 5),
                                           (4096, 31, 3)])
def test_chunk_kernel_from_a_carry(cuda, dtype, blk_v, head, nb):
    """One chunk at a word offset that crosses a multiple of 65,521, from a
    carry holding a subnormal sum and inf min/max, ending ragged."""
    tdt = TORCH_DTYPES[dtype]
    n = (head + nb) * blk_v - 3
    x = _values((n,), dtype, seed=head, raw=False)
    data = x.view(torch.uint8)[head * blk_v * tdt.itemsize:]
    carry = (torch.tensor([7, -9], dtype=torch.int32),
             torch.tensor([-np.inf, np.inf, 1e-40]),
             torch.tensor([11], dtype=torch.int32))
    off = (head * blk_v * tdt.itemsize // 4, head * blk_v,
           (n * tdt.itemsize + 3) // 4, n)
    kw = dict(dtype=tdt, blk_v=blk_v, nblocks=nb)
    got = qa_checksum_chunk(data.to(cuda), off,
                            tuple(c.to(cuda) for c in carry), **kw)
    _equal(got, qa_checksum_chunk(data, off, carry, **kw))
    assert LAUNCHES["qa_checksum_chunk"] == 1


def test_qa_checksum_on_two_streams_at_once(cuda):
    """Calls in flight on two streams take tickets of their own."""
    xs = [_values((3, 400_001), "float32", seed=s, raw=False)
          for s in range(2)]
    want = [qa_checksum_batched(x) for x in xs]
    dev = [x.to(cuda) for x in xs]
    torch.cuda.synchronize()                 # the copies, before the streams
    streams = [torch.cuda.Stream() for _ in xs]
    got = [[], []]
    for _ in range(8):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[k].append(qa_checksum_batched(dev[k]))
    torch.cuda.synchronize()
    for k in range(2):
        for g in got[k]:
            _equal(g, want[k])


def test_kernel_failure_raises(cuda):
    with pytest.raises(RuntimeError, match="failed to launch"):
        # a 32768-value block is past the kernel's shared-memory tree
        qa_checksum(torch.zeros(1 << 15, device=cuda), blk=1 << 15)


# K3 at the bytes of a T1w (256x256x176 f32) and a DWI (96x96x60x65 f32)
T1W_BYTES, DWI_BYTES = 256 * 256 * 176 * 4, 96 * 96 * 60 * 65 * 4
K3_SIZES = (0, 1, 3, 15, 16, 17, 33, 4099, 262_083, 262_084, 262_088,
            1_000_003, T1W_BYTES, T1W_BYTES + 7)


@pytest.mark.parametrize("offset", range(16))
def test_device_checksum_at_every_start(cuda, offset):
    """K3 on ranges that start 0-15 bytes into a buffer (each of the
    body's four alignments of words to 16-byte groups, and the starts that
    are not word-aligned), at ragged sizes, around 65,521 words and at a
    T1w's bytes."""
    buf = _bytes(T1W_BYTES + 64, offset).to(cuda)
    for n in K3_SIZES:
        x = buf[offset:offset + n]
        _equal([device_checksum(x)], [device_checksum_plain(x)])
    assert LAUNCHES["device_checksum"] == len(K3_SIZES)


@pytest.mark.parametrize("offset", [0, 1, 6, 12])
def test_device_checksum_at_a_dwi(cuda, offset):
    buf = _bytes(DWI_BYTES + 16, offset).to(cuda)
    for n in (DWI_BYTES, DWI_BYTES - 5):
        x = buf[offset:offset + n]
        _equal([device_checksum(x)], [device_checksum_plain(x)])


def test_device_checksum_on_two_streams_at_once(cuda):
    """K3 calls in flight on two streams take tickets of their own; one
    stream's range starts a byte into its buffer."""
    xs = [_bytes(20_000_003, s)[s:] for s in range(2)]
    want = [device_checksum(x) for x in xs]
    dev = [_bytes(20_000_003, s).to(cuda)[s:] for s in range(2)]
    torch.cuda.synchronize()                 # the copies, before the streams
    streams = [torch.cuda.Stream() for _ in xs]
    got = [[], []]
    for _ in range(8):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[k].append(device_checksum(dev[k]))
    torch.cuda.synchronize()
    for k in range(2):
        for g in got[k]:
            _equal([g], [want[k]])


def test_device_checksum_is_one_kernel_a_call(cuda):
    """torch.profiler sees one CUDA kernel a call, K3's own: no fill or
    copy of the output before it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = _bytes(10_000_001, 1).to(cuda)[3:]
    device_checksum(x)
    torch.cuda.synchronize()
    for _ in range(3):    # a trace late in a long process may hold no device
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # event
            for _ in range(4):
                device_checksum(x)
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
        if names:
            break
    assert len(names) == 4 and all("transfer_kernel" in n for n in names), \
        names


def test_device_checksum_leaves_its_tickets_zero(cuda):
    from repro_torch.kernels import _build
    from repro_torch.kernels.checksum import checksum as ck
    lib = _build.load("checksum")
    buf = _bytes(T1W_BYTES + 16, 2).to(cuda)
    sync = torch.zeros(64, dtype=torch.int32, device=cuda)
    for n, o in ((0, 0), (5, 3), (1_000_003, 1), (T1W_BYTES, 4)):
        x = buf[o:o + n]
        got = ck.run_device_checksum(lib, x, sync=sync)
        assert not sync.any(), sync
        _equal([got], [device_checksum_plain(x)])
    device_checksum(buf)                     # this stream's own buffer
    torch.cuda.synchronize()
    own = ck._SYNC[(str(buf.device), torch.cuda.current_stream().cuda_stream)]
    assert not own.any(), own


@pytest.mark.parametrize("rows,d", [(8000, 2048), (8000, 4096), (4, 2048),
                                    (4, 4096)])
def test_rmsnorm_kernel_at_the_serving_shapes(cuda, rows, d):
    """K4 at the (rows, d) of the served models' prefill and decode, in
    bf16 with a bf16 scale as the models hold it."""
    g = torch.Generator().manual_seed(d + rows)
    x = torch.randn(rows, d, generator=g).to(torch.bfloat16).to(cuda)
    s = (torch.rand(d, generator=g) + 0.5).to(torch.bfloat16).to(cuda)
    assert torch.equal(rn.rmsnorm(x, s), rn.rmsnorm_plain(x, s))


@pytest.mark.parametrize("d", [128, 512, 2048, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_kernel_at_its_layout_threshold(cuda, d, dtype):
    """K4 on both sides of the rows where ``repro_rmsnorm_plan`` turns from
    a row spread over a block to 32 (or 16) threads a row, with a bf16 and
    an f32 scale: bit-exact with the plain version."""
    from repro_torch.kernels import _build
    lib = _build.load("rmsnorm")
    at = k4.threshold(lib, d, dtype)
    layouts = {k4.plan(lib, r, d, dtype) for r in (max(at - 1, 1), at)}
    assert at == 1 or len(layouts) == 2, (at, layouts)
    g = torch.Generator().manual_seed(d)
    for rows in (max(at - 1, 1), at):
        x = torch.randn(rows, d, generator=g).to(dtype).to(cuda)
        s = torch.rand(d, generator=g) + 0.5
        for sc in (s.to(torch.bfloat16), s):
            assert torch.equal(rn.rmsnorm(x, sc.to(cuda)),
                               rn.rmsnorm_plain(x, sc.to(cuda))), (rows, sc)


@pytest.mark.parametrize("rows,d", [(4, 2048), (8000, 2048), (7, 100)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_kernel_on_a_misaligned_view(cuda, rows, d, dtype):
    """A view one value into its storage (2 bytes past a 16-byte boundary
    in bf16, 4 in f32), and a scale one value in: the scalar path, in the
    same order."""
    g = torch.Generator().manual_seed(rows)
    buf = torch.randn(rows * d + 1, generator=g).to(dtype).to(cuda)
    x = buf[1:].view(rows, d)
    sbuf = (torch.rand(d + 1, generator=g) + 0.5).to(torch.bfloat16).to(cuda)
    assert x.data_ptr() % 16 and sbuf[1:].data_ptr() % 16
    for s in (sbuf[:d], sbuf[1:]):
        assert torch.equal(rn.rmsnorm(x, s), rn.rmsnorm_plain(x, s))


def test_rmsnorm_every_layout_on_the_card(cuda):
    """Each layout the source takes, forced, at a few rows: 16 to 512
    threads a row, one row a block or several."""
    from repro_torch.kernels import _build
    lib = _build.load("rmsnorm")
    g = torch.Generator().manual_seed(5)
    for d in (7, 100, 128, 512, 2048, 4096):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(37, d, generator=g).to(dtype).to(cuda)
            s = (torch.rand(d, generator=g) + 0.5).to(cuda)
            _, N = k4._padded_groups(d, dtype.itemsize)
            for team in (16, 32, 64, 128, 256, 512):
                if team * 16 < N:
                    continue
                for rpb in {max(1, 32 // team), max(1, 256 // team)}:
                    got = k4.run_kernel(lib, x, s, layout=(team, rpb))
                    torch.cuda.synchronize()
                    assert torch.equal(got, rn.rmsnorm_plain(x, s)), \
                        (d, dtype, team, rpb)


@pytest.mark.parametrize("rows", [4, 8000])
def test_rmsnorm_is_one_kernel_a_call(cuda, rows):
    """torch.profiler sees K4's kernel alone, at most once a call, with a
    bf16 scale: the scale is not widened by a copy first. Late in a long
    process a session may hold no device event, or (at decode's ~2 us
    kernels, on an H100: 3 of 4 in each of three sessions) not all of
    them: an empty session is repeated, up to three, and each session is
    held to at most one event a call, every one K4's; the wrapper counts
    one launch a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(rows, 2048, device=cuda).to(torch.bfloat16)
    s = (torch.rand(2048, device=cuda) + 0.5).to(torch.bfloat16)
    rn.rmsnorm(x, s)
    torch.cuda.synchronize()
    for _ in range(3):
        before = rn.LAUNCHES["rmsnorm"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                rn.rmsnorm(x, s)
            torch.cuda.synchronize()
        assert rn.LAUNCHES["rmsnorm"] - before == 4
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
        assert len(names) <= 4 and all("rmsnorm_kernel" in n
                                       for n in names), names
        if names:
            break
    assert names


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


# K5: (absolute, relative to the tile's largest |output|)
TOL = {torch.float32: (2e-5, 2 ** -12), torch.bfloat16: (3e-2, 2 ** -6)}


def _close(got, want):
    """got, want: (B, H, S, Dh); each 64-row query tile within TOL."""
    tol, rel = TOL[want.dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    for r in range(0, want.shape[2], 64):
        w = want[:, :, r:r + 64]
        top = w.float().abs().max().item()
        assert _err(got[:, :, r:r + 64], w) <= min(tol, rel * top), \
            (r, _err(got[:, :, r:r + 64], w), top)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64, 128), (3, 100), (512, 256),
                                   (1, 7), (1000, 512)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, shape):
    g = torch.Generator().manual_seed(len(shape))
    x = torch.randn(shape, generator=g).to(dtype)
    s = torch.randn(shape[-1:], generator=g).abs() + 0.5
    got = rn.rmsnorm(x.to(cuda), s.to(cuda))
    assert got.dtype == dtype and got.shape == x.shape and got.is_cuda
    assert torch.equal(got, rn.rmsnorm_plain(x.to(cuda), s.to(cuda)))
    assert torch.equal(got.cpu(), rn.rmsnorm_plain(x, s))
    assert rn.LAUNCHES["rmsnorm"] == 1


@pytest.mark.parametrize("B,H,KV,S,D", [
    (2, 4, 2, 256, 64), (1, 8, 8, 128, 32), (2, 4, 1, 200, 64),
    (1, 2, 2, 384, 128), (1, 4, 2, 1000, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, B, H, KV, S, D, dtype, causal):
    g = torch.Generator().manual_seed(S)
    q = torch.randn(B, H, S, D, generator=g).to(dtype).to(cuda)
    k, v = (torch.randn(B, KV, S, D, generator=g).to(dtype).to(cuda)
            for _ in range(2))
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, want)
    assert fa.LAUNCHES["flash_attention"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_window_layout_and_offset(cuda, dtype):
    g = torch.Generator().manual_seed(7)
    q = torch.randn(1, 300, 4, 32, generator=g).to(dtype).to(cuda)
    k, v = (torch.randn(1, 300, 2, 32, generator=g).to(dtype).to(cuda)
            for _ in range(2))
    got = fa.flash_attention_op(q, k, v, causal=True, window=64)
    want = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), window=64)
    _close(got.transpose(1, 2), want)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    part = fa.flash_attention(qt[:, :, 130:200], kt, vt, q_offset=130)
    _close(part, fa.flash_attention_plain(qt, kt, vt)[:, :, 130:200])
    assert fa.LAUNCHES["flash_attention"] == 2


def test_flash_kernel_takes_odd_strided_bf16_views(cuda):
    """The bf16 kernel loads through TMA, which wants strides in multiples
    of 16 bytes; a view whose strides are odd is copied to a dense layout
    first."""
    g = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn(1, 4 if i == 0 else 2, 65, 33, generator=g)
               .to(torch.bfloat16).to(cuda)[..., :32] for i in range(3))
    assert q.stride(2) == 33
    got = fa.flash_attention(q, k, v)
    _close(got, fa.flash_attention_plain(q, k, v))



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_default_scale_is_bit_identical(cuda, dtype):
    """``scale`` left out is the 1 / sqrt(Dh) call, bit for bit."""
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(1, 4 if i == 0 else 2, 200, 64, generator=g)
               .to(dtype).to(cuda) for i in range(3))
    assert torch.equal(fa.flash_attention(q, k, v),
                       fa.flash_attention(q, k, v, scale=1 / math.sqrt(64)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_at_scale_one_over_dh(cuda, dtype, causal):
    """granite-4.0-h-small's attention: 32 query and 8 kv heads of 128,
    scale 1/128 (attention_multiplier), against the plain version at that
    scale."""
    g = torch.Generator().manual_seed(10)
    q = torch.randn(2, 32, 300, 128, generator=g).to(dtype).to(cuda)
    k, v = (torch.randn(2, 8, 300, 128, generator=g).to(dtype).to(cuda)
            for _ in range(2))
    got = fa.flash_attention(q, k, v, causal=causal, scale=1 / 128)
    _close(got, fa.flash_attention_plain(q, k, v, causal=causal,
                                         scale=1 / 128))
    assert fa.LAUNCHES["flash_attention"] == 1


def _bf16_qkv(B, H, KV, Sq, Sk, D, seed, cuda):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, H, Sq, D, generator=g).to(torch.bfloat16).to(cuda),
            *(torch.randn(B, KV, Sk, D, generator=g).to(torch.bfloat16)
              .to(cuda) for _ in range(2)))


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_every_head_dim_ragged_keys(cuda, D, causal):
    """333 keys: two whole 128-key tiles and a ragged one of 77."""
    q, k, v = _bf16_qkv(2, 4, 2, 333, 333, D, D, cuda)
    _close(fa.flash_attention(q, k, v, causal=causal),
           fa.flash_attention_plain(q, k, v, causal=causal))
    assert fa.LAUNCHES["flash_attention"] == 1


@pytest.mark.parametrize("Sq,causal", [(1, True), (1, False), (50, True),
                                       (50, False)])
def test_flash_bf16_fewer_queries_than_a_block(cuda, Sq, causal):
    """Sq below the kernel's 128-row block (Sq = 1: one decode-like row),
    placed at the end of 300 keys."""
    q, k, v = _bf16_qkv(2, 4, 2, Sq, 300, 64, Sq, cuda)
    kw = dict(causal=causal, q_offset=300 - Sq)
    _close(fa.flash_attention(q, k, v, **kw),
           fa.flash_attention_plain(q, k, v, **kw))


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("start", [37, 130, 200])
def test_flash_bf16_offset_inside_a_tile(cuda, D, start):
    """Query rows at absolute positions that start inside a key tile give
    the rows of the whole causal computation."""
    q, k, v = _bf16_qkv(1, 4, 2, 400, 400, D, start, cuda)
    part = fa.flash_attention(q[:, :, start:start + 150], k, v,
                              q_offset=start)
    _close(part, fa.flash_attention_plain(q, k, v)[:, :, start:start + 150])


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_window_skips_whole_tiles(cuda, D, causal):
    """window 64 over 1,000 keys: each 128-row block visits at most three
    of the eight key tiles."""
    q, k, v = _bf16_qkv(1, 4, 2, 1000, 1000, D, 64 + D, cuda)
    kw = dict(causal=causal, window=64)
    _close(fa.flash_attention(q, k, v, **kw),
           fa.flash_attention_plain(q, k, v, **kw))


@pytest.mark.parametrize("H,KV,D", [(16, 4, 64), (48, 1, 128)])
def test_flash_bf16_grouped_query_heads(cuda, H, KV, D):
    """G 4 and G 48 (granite's 48 query heads over one kv head, Dh 128)."""
    q, k, v = _bf16_qkv(2, H, KV, 300, 300, D, H, cuda)
    _close(fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("D", [64, 128])
def test_flash_bf16_reads_a_fused_qkv_split_in_place(cuda, D):
    """q, k and v sliced from one (B, S, (H + 2 KV) Dh) projection and
    viewed as (B, H, S, Dh): the kernel reads them where they lie."""
    H, KV, S = 8, 2, 260
    g = torch.Generator().manual_seed(D)
    qkv = torch.randn(2, S, (H + 2 * KV) * D, generator=g).to(
        torch.bfloat16).to(cuda)
    q = qkv[..., :H * D].view(2, S, H, D)
    k = qkv[..., H * D:(H + KV) * D].view(2, S, KV, D)
    v = qkv[..., (H + KV) * D:].view(2, S, KV, D)
    for t in (q, k, v):
        assert fa.kernel_operand(t.transpose(1, 2)).data_ptr() == \
            t.data_ptr()
    got = fa.flash_attention_op(q, k, v, causal=True)
    _close(got.transpose(1, 2), fa.flash_attention_plain(
        *(t.transpose(1, 2) for t in (q, k, v)), causal=True))


def test_flash_bf16_copies_a_misaligned_view(cuda):
    """A view that starts 2 bytes past a 16-byte boundary breaks TMA's
    rule: the wrapper copies it and the answer stays the same."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(1, 6, 200, 65, generator=g).to(torch.bfloat16).to(cuda)
    q, k, v = x[:, :4, :, 1:], x[:, 4:5, :, 1:], x[:, 5:, :, 1:]
    assert q.data_ptr() % 16 == 2
    assert fa.kernel_operand(q).data_ptr() != q.data_ptr()
    _close(fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 64, 330), (True, 64, 400), (False, 64, 400), (True, None, -20)])
def test_flash_rows_with_no_key_average_every_key(cuda, dtype, D, causal,
                                                  window, q_offset):
    """Rows past the keys' end under a window of 64 (from row 363 at offset
    330, all at 400), or before the first key (offset -20), see no key:
    like the plain version the kernel averages v over all 300 keys, and the
    padding of the ragged last key tile counts for nothing."""
    g = torch.Generator().manual_seed(D)
    q, k, v = (torch.randn(1, n, s, D, generator=g).to(dtype).to(cuda)
               for n, s in ((4, 50), (2, 300), (2, 300)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _close(fa.flash_attention(q, k, v, **kw),
           fa.flash_attention_plain(q, k, v, **kw))


def test_new_wrappers_raise_and_never_fall_back(cuda):
    x = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        rn.rmsnorm(x.half(), torch.ones(8, device=cuda))
    with pytest.raises(ValueError):
        rn.rmsnorm(x, torch.ones(8))                  # scale on the CPU
    q = torch.zeros(1, 2, 8, 80, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 4, 8, 32, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :3], q[:, :3])     # 4 heads over 3
    with pytest.raises(ValueError):
        fa.flash_attention(q, q.cpu(), q.cpu())
    assert rn.LAUNCHES["rmsnorm"] == fa.LAUNCHES["flash_attention"] == 0


def _rel(got, want):
    return (got.float() - want.float()).abs().max().item() / max(
        1.0, want.float().abs().max().item())


def _ssd_inputs(B, H, S, dh, N, seed, model_layout):
    """K6's inputs, as the reference's tests draw them; in the model's
    layout they are transposed views of (B, S, H, ...) tensors, and B, C
    slices of a wider projection, read in place."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, dh, generator=g)
    lw = -torch.randn(B, S, H, generator=g).abs() * 0.1
    BC = torch.randn(B, S, 2 * N + 5, generator=g) * 0.3
    s0 = torch.randn(B, H, dh, N, generator=g)
    x, lw = x.transpose(1, 2), lw.transpose(1, 2)
    if not model_layout:
        x, lw = x.contiguous(), lw.contiguous()
    return x, lw, BC[..., 5:5 + N], BC[..., 5 + N:], s0


@pytest.mark.parametrize("B,H,S,dh,N,chunk", [
    (2, 3, 96, 32, 16, 32), (1, 2, 128, 64, 64, 128), (2, 2, 200, 32, 64, 64),
    (1, 4, 520, 64, 64, 256), (2, 2, 77, 16, 8, 100),
    # tests/test_torch_ssd_shim.py's shapes, and 32 chunks of 256
    (2, 1, 300, 16, 16, 32), (1, 2, 300, 64, 32, 128), (1, 1, 600, 64, 64, 256),
    (1, 1, 130, 16, 8, 130), (1, 1, 1, 16, 8, 32), (2, 4, 8192, 64, 64, 256),
    # N past 64: two 64-wide tiles of the state (granite-4.0-h-small's 128
    # at dh 64, and ragged widths)
    (1, 2, 300, 64, 128, 128), (2, 1, 150, 32, 100, 64),
    (1, 4, 4096, 64, 128, 256)])
@pytest.mark.parametrize("model_layout", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_kernel_matches_plain(cuda, B, H, S, dh, N, chunk, model_layout,
                                  with_state):
    x, lw, Bm, Cm, s0 = _ssd_inputs(B, H, S, dh, N, S, model_layout)
    s0 = s0 if with_state else None
    dev = [t.to(cuda) if t is not None else None for t in (x, lw, Bm, Cm, s0)]
    y, st = k6.ssd_chunked(*dev[:4], chunk=chunk, state=dev[4])
    assert k6.LAUNCHES["ssd_chunked"] == 1
    yp, sp = k6.ssd_chunked_plain(*dev[:4], chunk=chunk, state=dev[4])
    assert y.shape == yp.shape and st.shape == sp.shape and y.is_cuda
    assert _rel(y, yp) < 1e-4 and _rel(st, sp) < 1e-4
    yc, sc = k6.ssd_chunked(x, lw, Bm, Cm, chunk=chunk, state=s0)  # the CPU
    assert _rel(y.cpu(), yc) < 1e-4 and _rel(st.cpu(), sc) < 1e-4
    if model_layout:           # the output is laid out like x
        assert y.stride() == dev[0].stride()


@pytest.mark.parametrize("S", [700, 8192])
def test_ssd_kernel_matches_the_sequential_oracle(cuda, S):
    x, lw, Bm, Cm, _ = _ssd_inputs(1, 4, S, 64, 64, 9, True)
    x, lw, Bm, Cm = (t.to(cuda) for t in (x, lw, Bm, Cm))
    y, _ = k6.ssd_chunked(x, lw, Bm, Cm, chunk=256)
    assert _rel(y, k6.ssd_ref(x, lw, Bm, Cm)) < 1e-4


def test_ssd_kernel_at_n128_matches_the_sequential_oracle(cuda):
    """granite-4.0-h-small's widths (dh 64, N 128) in one call, against
    the exact recurrence over all 700 steps."""
    x, lw, Bm, Cm, _ = _ssd_inputs(1, 4, 700, 64, 128, 13, True)
    x, lw, Bm, Cm = (t.to(cuda) for t in (x, lw, Bm, Cm))
    y, _ = k6.ssd_chunked(x, lw, Bm, Cm, chunk=256)
    assert k6.LAUNCHES["ssd_chunked"] == 1
    assert _rel(y, k6.ssd_ref(x, lw, Bm, Cm)) < 1e-4


def _wkv_inputs(B, H, S, dh, seed, dtype, strong):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(B, S, H, dh, generator=g).to(dtype)
               for _ in range(3))
    z = torch.randn(B, S, H, dh, generator=g)
    logw = -torch.exp(z * 2 - 1) if strong else -torch.exp(z * 0.5 - 2)
    logw = logw.clamp(-20.0, -1e-6)
    u = torch.randn(H, dh, generator=g) * 0.3
    s0 = torch.randn(B, H, dh, dh, generator=g)
    return [t.transpose(1, 2) for t in (r, k, v, logw)] + [u, s0]


@pytest.mark.parametrize("B,H,S,dh,chunk", [
    (2, 3, 96, 32, 32), (1, 2, 128, 64, 128), (2, 2, 200, 16, 64),
    (1, 4, 300, 64, 128), (1, 2, 77, 64, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strong,with_state", [(False, False), (True, True)])
def test_wkv6_kernel_matches_plain(cuda, B, H, S, dh, chunk, dtype, strong,
                                   with_state):
    r, k, v, lw, u, s0 = _wkv_inputs(B, H, S, dh, S, dtype, strong)
    s0 = s0 if with_state else None
    dev = [t.to(cuda) if t is not None else None
           for t in (r, k, v, lw, u, s0)]
    o, st = k7.wkv6_chunked(*dev[:5], chunk=chunk, state=dev[5])
    assert k7.LAUNCHES["wkv6_chunked"] == 1
    op, sp = k7.wkv6_chunked_plain(*dev[:5], chunk=chunk, state=dev[5])
    assert o.dtype == torch.float32 and o.shape == op.shape
    assert _rel(o, op) < 1e-4 and _rel(st, sp) < 1e-4
    assert bool(torch.isfinite(o).all() and torch.isfinite(st).all())
    oc, sc = k7.wkv6_chunked(r, k, v, lw, u, chunk=chunk, state=s0)
    assert _rel(o.cpu(), oc) < 1e-4 and _rel(st.cpu(), sc) < 1e-4


def test_wkv6_kernel_matches_the_sequential_oracle(cuda):
    r, k, v, lw, u, _ = _wkv_inputs(1, 4, 700, 64, 11, torch.float32, True)
    dev = [t.to(cuda) for t in (r, k, v, lw, u)]
    o, _ = k7.wkv6_chunked(*dev, chunk=128)
    assert _rel(o, k7.wkv6_ref(*dev)) < 1e-4


def test_chunk_scan_wrappers_raise_and_never_fall_back(cuda):
    x = torch.zeros(1, 2, 8, 80, device=cuda)
    lw = torch.zeros(1, 2, 8, device=cuda)
    bc = torch.zeros(1, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="at most 64"):
        k6.ssd_chunked(x, lw, bc, bc, chunk=4)
    with pytest.raises(ValueError):
        k6.ssd_chunked(x[..., :16], lw, bc.cpu(), bc, chunk=4)
    r = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="dtypes"):
        k7.wkv6_chunked(r.half(), r.half(), r.half(), r, r[0, :, 0],
                        chunk=4)
    with pytest.raises(RuntimeError, match="failed to launch"):
        # a 4096-step chunk's cumsum is past the card's shared memory
        k7.wkv6_chunked(r, r, r, r, r[0, :, 0], chunk=4096)
    assert k6.LAUNCHES["ssd_chunked"] == k7.LAUNCHES["wkv6_chunked"] == 0


@pytest.mark.parametrize("arch,k6_n,k7_n", [("zamba2-1.2b", 4, 0),
                                            ("rwkv6-1.6b", 0, 2)])
def test_served_models_launch_the_chunk_scans(cuda, arch, k6_n, k7_n):
    """Reduced zamba2 and rwkv6 prefill on the card: K6 once per Mamba-2
    layer, K7 once per rwkv layer, decode neither; the logits match the
    port's own CPU run (f32)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import graft
    from repro_torch.models import (forward_decode, forward_prefill,
                                    init_cache, init_params)
    cfg = get_config(arch).reduced()
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 150)))
    want, _ = forward_prefill(cfg, p, {"tokens": toks}, torch.float32)
    pc = _tree_to(p, cuda)
    got, cache = forward_prefill(cfg, pc, {"tokens": toks.to(cuda)},
                                 torch.float32)
    assert (k6.LAUNCHES["ssd_chunked"], k7.LAUNCHES["wkv6_chunked"]) == \
        (k6_n, k7_n)
    assert _rel(got.cpu(), want) < 1e-4
    cache = graft(init_cache(cfg, 2, 151, torch.float32, cuda), cache)
    step, _ = forward_decode(cfg, pc, cache, toks[:, :1].to(cuda), 150,
                             torch.float32)
    assert bool(torch.isfinite(step).all())
    assert (k6.LAUNCHES["ssd_chunked"], k7.LAUNCHES["wkv6_chunked"]) == \
        (k6_n, k7_n)


def _granite_reduced():
    """granite-4.0-h-small at reduced() size (one period of 10 layers, 8
    experts, the shared expert) with its plain reference's weights
    (``tests/plain/granite4_hybrid.py``), drawn on the CPU in f32."""
    import importlib.util
    from repro_torch.configs import get_config
    path = Path(__file__).resolve().parent / "plain" / "granite4_hybrid.py"
    spec = importlib.util.spec_from_file_location("plain_granite4", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from test_torch_granite4h import draw, hf_config
    finally:
        sys.path.pop(0)
    cfg = get_config("granite-4.0-h-small").reduced()
    p = draw(ref.param_specs(hf_config(cfg)), torch.Generator().manual_seed(1))
    return cfg, p, ref, hf_config(cfg)


def test_granite_prefill_and_decode_on_the_card(cuda):
    """Reduced granite-4.0-h-small in f32 on the card (K6 at each of the 9
    Mamba-2 layers, K5 at scale 1/Dh on the attention layer, the grouped
    expert GEMMs) against the port's own CPU run within 1e-4, then 4
    decode steps through its cache against the CPU's."""
    from repro_torch.models import forward_decode, init_cache
    from repro_torch.launch.serve import graft
    from repro_torch.serve import make_prefill_step
    cfg, p, _, _ = _granite_reduced()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 150)))
    step = make_prefill_step(cfg, torch.float32)
    want, wcache = step(p, {"tokens": toks})
    pc = _tree_to(p, cuda)
    got, cache = step(pc, {"tokens": toks.to(cuda)})
    assert (k6.LAUNCHES["ssd_chunked"], fa.LAUNCHES["flash_attention"]) \
        == (9, 1)
    assert _rel(got.cpu(), want) < 1e-4
    cache = graft(init_cache(cfg, 2, 154, torch.float32, cuda), cache)
    wcache = graft(init_cache(cfg, 2, 154, torch.float32, "cpu"), wcache)
    for i in range(4):
        tok = toks[:, i:i + 1]
        lg, cache = forward_decode(cfg, pc, cache, tok.to(cuda), 150 + i,
                                   torch.float32)
        wl, wcache = forward_decode(cfg, p, wcache, tok, 150 + i,
                                    torch.float32)
        assert _rel(lg.cpu(), wl) < 1e-4
    assert k6.LAUNCHES["ssd_chunked"] == 9


def test_granite_bf16_prefill_runs_the_kernels(cuda):
    """The served path of the benchmark's cell at reduced size: bf16 on
    the card, one conv_in, K6 and gate_norm a Mamba-2 layer, K5 once;
    its logits against the plain f32 reference's on the same bf16
    weights within GRANITE_BF16_TOL of their largest magnitude (bf16
    through 10 layers, and the router's near-ties, which bf16 flips
    against f32, 3 experts of 8 at this size: 0.209 on an H100, 0.091 in
    the CPU's bf16; the cell's token_gap holds the full size)."""
    from repro_torch.kernels import mamba2_glue as glue
    from repro_torch.serve import make_prefill_step
    cfg, p, ref, c = _granite_reduced()
    pc = {k: v for k, v in _tree_to(p, cuda).items()}
    pc = _tree_to_dtype(pc, torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 150))).to(cuda)
    with torch.inference_mode():
        got, _ = make_prefill_step(cfg, torch.bfloat16)(pc, {"tokens": toks})
        want = ref.logits(c, pc, toks, [149])[:, 0]
    assert (glue.LAUNCHES["mamba2_conv_in"], glue.LAUNCHES[
        "mamba2_gate_norm"], k6.LAUNCHES["ssd_chunked"],
        fa.LAUNCHES["flash_attention"]) == (9, 9, 9, 1)
    err = float((got.float() - want).abs().max() / want.abs().max())
    print(f"granite bf16 prefill vs f32 reference: {err}")
    assert err < GRANITE_BF16_TOL


GRANITE_BF16_TOL = 0.4


def _tree_to_dtype(tree, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to_dtype(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# the Mamba-2 glue kernels (kernels/mamba2_glue) around K6
# ---------------------------------------------------------------------------

# zamba2-1.2b's Mamba-2 widths: d_inner, d_state, heads, conv taps
GLUE_WIDTHS = (4096, 64, 64, 4)


def _glue_inputs(cuda, B, S, seed, state=True, pdtype=torch.bfloat16,
                 widths=GLUE_WIDTHS):
    """in_proj's output (B, S, 2 di + 2 N + H) bf16 on the card, the
    layer's parameters in ``pdtype`` and a conv state (or None)."""
    di, N, H, K = widths
    C = di + 2 * N
    g = torch.Generator(device=cuda).manual_seed(seed)

    def r(*shape, scale=1.0):
        return scale * torch.randn(shape, device=cuda, generator=g)
    proj = r(B, S, 2 * di + 2 * N + H)
    proj[..., 2 * di + 2 * N:] *= 6               # dt across softplus's 20
    p = {"conv_w": r(K, C, scale=0.5), "conv_b": r(C, scale=0.3),
         "dt_bias": r(H, scale=0.5),
         "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=cuda)),
         "D": 1 + r(H, scale=0.5), "norm": 1 + r(di, scale=0.2)}
    p = {k: v.to(pdtype) for k, v in p.items()}
    st = r(B, K - 1, C).to(torch.bfloat16) if state else None
    return proj.to(torch.bfloat16), p, st


def _glue_split(proj, widths=GLUE_WIDTHS):
    di, N, H, _ = widths
    return torch.split(proj, [di, di + 2 * N, H], -1)


@pytest.mark.parametrize("B,S,state", [(16, 256, False), (1, 4096, False),
                                       (2, 1020, True), (4, 256, True)])
@pytest.mark.parametrize("pdtype", [torch.bfloat16, torch.float32])
def test_glue_conv_in_matches_plain(cuda, B, S, state, pdtype):
    """conv_in at zamba2's widths, reading in_proj's columns in place: xs,
    lw, B, C, xh and the new conv state bit-equal to the torch ops (its
    plain version on the card), from a zero and a given conv state, at a
    length off the 64-token tile; one launch a call."""
    proj, p, st = _glue_inputs(cuda, B, S, seed=S + B, state=state,
                               pdtype=pdtype)
    z, conv, dt = _glue_split(proj)
    args = (conv, dt, st, p["conv_w"], p["conv_b"], p["dt_bias"],
            p["A_log"])
    got = glue.mamba2_conv_in(*args, d_state=GLUE_WIDTHS[1])
    want = glue.mamba2_conv_in_plain(*args, d_state=GLUE_WIDTHS[1])
    assert glue.LAUNCHES["mamba2_conv_in"] == 1
    for name, a, b in zip(("xs", "lw", "Bm", "Cm", "xh", "state"), got,
                          want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, _err(a, b))


@pytest.mark.parametrize("B,S", [(16, 256), (1, 4096), (2, 1020), (4, 256)])
@pytest.mark.parametrize("pdtype", [torch.bfloat16, torch.float32])
def test_glue_gate_norm_matches_plain(cuda, B, S, pdtype):
    """gate_norm at zamba2's widths, z read in place: the torch ops' gate
    then K4's plain version (its order of the sum of squares), bit-equal;
    one launch a call."""
    proj, p, _ = _glue_inputs(cuda, B, S, seed=S - B, state=False,
                              pdtype=pdtype)
    z = _glue_split(proj)[0]
    g = torch.Generator(device=cuda).manual_seed(B)
    di, _, H, _ = GLUE_WIDTHS
    y = 3 * torch.randn(B, S, H, di // H, device=cuda, generator=g)
    xh = torch.randn(B, S, di, device=cuda, generator=g).to(torch.bfloat16)
    args = (y, xh, z, p["D"], p["norm"])
    got = glue.mamba2_gate_norm(*args)
    assert glue.LAUNCHES["mamba2_gate_norm"] == 1
    want = glue.mamba2_gate_norm_plain(*args)
    assert torch.equal(got, want), _err(got, want)


@pytest.mark.parametrize("widths", [(256, 16, 8, 4), (64, 8, 8, 2),
                                    (2048, 64, 32, 3)])
def test_glue_kernels_at_other_widths(cuda, widths):
    """The reduced zamba2's widths, heads of 8 channels with a 2-tap conv,
    d_inner 2,048 with a 3-tap conv: both kernels bit-equal to their plain
    versions."""
    proj, p, st = _glue_inputs(cuda, 3, 150, seed=widths[0], widths=widths)
    z, conv, dt = _glue_split(proj, widths)
    args = (conv, dt, st, p["conv_w"], p["conv_b"], p["dt_bias"],
            p["A_log"])
    got = glue.mamba2_conv_in(*args, d_state=widths[1])
    want = glue.mamba2_conv_in_plain(*args, d_state=widths[1])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    di, _, H, _ = widths
    y = torch.randn(3, 150, H, di // H, device=cuda)
    gate = (y, got[4], z, p["D"], p["norm"])
    assert torch.equal(glue.mamba2_gate_norm(*gate),
                       glue.mamba2_gate_norm_plain(*gate))


def test_glue_kernels_are_one_kernel_a_call(cuda):
    """torch.profiler sees each wrapper's own kernel alone, once a call (no
    copy of proj's columns, no fill); an empty session is repeated, as for
    K4."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    proj, p, st = _glue_inputs(cuda, 4, 512, seed=3)
    z, conv, dt = _glue_split(proj)
    args = (conv, dt, st, p["conv_w"], p["conv_b"], p["dt_bias"],
            p["A_log"])
    xs, lw, Bm, Cm, xh, _ = glue.mamba2_conv_in(*args, d_state=64)
    y = xs.clone()
    for name, fn, kernel in (
            ("mamba2_conv_in",
             lambda: glue.mamba2_conv_in(*args, d_state=64),
             "conv_in_kernel"),
            ("mamba2_gate_norm",
             lambda: glue.mamba2_gate_norm(y, xh, z, p["D"], p["norm"]),
             "gate_norm_kernel")):
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            before = glue.LAUNCHES[name]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    fn()
                torch.cuda.synchronize()
            assert glue.LAUNCHES[name] - before == 4
            names = [e.name() for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA]
            assert len(names) <= 4 and all(kernel in n for n in names), \
                names
            if names:
                break
        assert names, kernel


@pytest.mark.parametrize("name", ["mamba2_conv_in", "mamba2_gate_norm"])
def test_glue_kernels_refuse_inputs_that_require_grad(cuda, name):
    """Under grad mode an input that requires grad is refused
    (``kernels/_nograd.py``) before any launch; under no_grad the same call
    runs and gives the same outputs."""
    proj, p, st = _glue_inputs(cuda, 2, 64, seed=5)
    z, conv, dt = _glue_split(proj)
    w = p["conv_w"].clone().requires_grad_(True)
    D = p["D"].float().requires_grad_(True)
    y = torch.randn(2, 64, 64, 64, device=cuda)
    xh = torch.randn(2, 64, 4096, device=cuda).to(torch.bfloat16)
    call = {
        "mamba2_conv_in": lambda w: glue.mamba2_conv_in(
            conv, dt, st, w, p["conv_b"], p["dt_bias"], p["A_log"],
            d_state=64),
        "mamba2_gate_norm": lambda D: glue.mamba2_gate_norm(
            y, xh, z, D, p["norm"])}[name]
    arg = w if name == "mamba2_conv_in" else D
    want = call(arg.detach())
    with pytest.raises(RuntimeError, match=f"{name}: an input requires "
                                           f"grad"):
        call(arg)
    with torch.no_grad():
        got = call(arg)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    assert glue.LAUNCHES[name] == 2         # the refused call launched none


def _zamba2_reduced_bf16(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("zamba2-1.2b").reduced()
    p = init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16,
                    device="cpu")
    return cfg, _tree_to(p, cuda)


def test_glue_zamba2_prefill_matches_the_unfused_path(cuda, monkeypatch):
    """The reduced zamba2 served in bf16 on the card: prefill through the
    two glue kernels (once each a Mamba-2 layer) gives the torch ops'
    logits and cache bit for bit; a decode step after it (one token) and
    the torch ops' own prefill launch neither."""
    from repro_torch.launch.serve import graft
    from repro_torch.models import (forward_decode, forward_prefill,
                                    init_cache)
    from repro_torch.models import mamba2 as TM
    cfg, pc = _zamba2_reduced_bf16(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 300))).to(cuda)
    with torch.inference_mode():
        got, cache = forward_prefill(cfg, pc, {"tokens": toks},
                                     torch.bfloat16)
        assert dict(glue.LAUNCHES) == {"mamba2_conv_in": cfg.n_layers,
                                       "mamba2_gate_norm": cfg.n_layers}
        full = graft(init_cache(cfg, 2, 301, torch.bfloat16, cuda), cache)
        step, _ = forward_decode(cfg, pc, full, toks[:, :1], 300,
                                 torch.bfloat16)
        assert bool(torch.isfinite(step).all())
        assert dict(glue.LAUNCHES) == {"mamba2_conv_in": cfg.n_layers,
                                       "mamba2_gate_norm": cfg.n_layers}
        glue.reset_launches()
        monkeypatch.setattr(TM, "_glue_kernels", lambda *a: False)
        want, wcache = forward_prefill(cfg, pc, {"tokens": toks},
                                       torch.bfloat16)
    assert dict(glue.LAUNCHES) == {"mamba2_conv_in": 0,
                                   "mamba2_gate_norm": 0}
    assert torch.equal(got, want)
    for k in ("ssm", "conv"):
        assert torch.equal(cache["state"][k], wcache["state"][k]), k


def test_glue_training_and_split_heads_keep_the_torch_ops(cuda):
    """Training (``train=True``, bf16 on the card) and a layer whose heads
    split over a group of two ranks launch neither glue kernel: training
    runs the torch ops under autograd, the group needs the gated norm's
    moment summed over its ranks."""
    import types
    from repro_torch.models import forward_train
    from repro_torch.models import mamba2 as TM
    cfg, pc = _zamba2_reduced_bf16(cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 129))).to(cuda)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    loss, _ = forward_train(cfg, pc, batch, torch.bfloat16)
    assert bool(torch.isfinite(loss))
    h = torch.zeros(2, 64, cfg.d_model, device=cuda, dtype=torch.bfloat16)
    assert TM._glue_kernels(h, cfg, False, None)
    assert not TM._glue_kernels(h, cfg, True, None)
    assert not TM._glue_kernels(h, cfg, False, types.SimpleNamespace(size=2))
    assert not TM._glue_kernels(h[:, :1], cfg, False, None)
    assert dict(glue.LAUNCHES) == {"mamba2_conv_in": 0,
                                   "mamba2_gate_norm": 0}


def test_glue_serving_mamba_block_is_at_most_12_kernels(cuda):
    """One serving Mamba-2 layer at zamba2's widths (2 x 1,024 tokens, bf16,
    a given state as prefill passes it) under torch.profiler: at most 12
    device kernels (the pre-norm K4, in_proj, conv_in, K6's four,
    gate_norm, out_proj, the residual add; the torch ops took ~37), one
    launch of each glue kernel a call. Late in a long process a session
    may miss some device events (K4's test above): a session that misses a
    glue kernel is repeated, up to three."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import mamba2 as TM
    cfg = get_config("zamba2-1.2b")
    p = TM.init_mamba_layer(torch.Generator().manual_seed(0), cfg, 1,
                            dtype=torch.bfloat16, device="cpu")
    p = {k: v[0].to(cuda) for k, v in p.items()}
    st = TM.init_mamba_state(cfg, 1, 2, torch.bfloat16, cuda)
    st = {k: v[0] for k, v in st.items()}
    x = torch.randn(2, 1024, cfg.d_model, device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        TM.mamba_block(x, p, cfg, st)
        torch.cuda.synchronize()
        for _ in range(3):
            before = dict(glue.LAUNCHES)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                TM.mamba_block(x, p, cfg, st)
                torch.cuda.synchronize()
            assert {k: glue.LAUNCHES[k] - n for k, n in before.items()} == \
                {"mamba2_conv_in": 1, "mamba2_gate_norm": 1}
            names = [e.name() for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA]
            assert len(names) <= 12, names
            seen = [sum(k in n for n in names)
                    for k in ("conv_in_kernel", "gate_norm_kernel")]
            if seen == [1, 1]:
                break
    assert seen == [1, 1], names


# ---------------------------------------------------------------------------
# training on the card (chip_smoke.py phase 5c at full size)
# ---------------------------------------------------------------------------

def _grad_inputs(name, cuda):
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, device=cuda, generator=g)
    return {
        "rmsnorm": (rn.rmsnorm, (r(4, 64), r(64)), {}),
        "flash_attention": (fa.flash_attention, (r(1, 4, 64, 64),
                                                 r(1, 2, 64, 64),
                                                 r(1, 2, 64, 64)), {}),
        "ssd_chunked": (k6.ssd_chunked, (r(1, 2, 64, 64), -r(1, 2, 64).abs(),
                                         r(1, 64, 64), r(1, 64, 64)),
                        {"chunk": 32}),
        "wkv6_chunked": (k7.wkv6_chunked, (r(1, 2, 64, 64), r(1, 2, 64, 64),
                                           r(1, 2, 64, 64),
                                           -r(1, 2, 64, 64).abs() - 0.01,
                                           r(2, 64)), {"chunk": 32}),
    }[name]


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention",
                                  "ssd_chunked", "wkv6_chunked"])
def test_kernels_refuse_inputs_that_require_grad_on_the_card(cuda, name):
    fn, args, kw = _grad_inputs(name, cuda)
    want = fn(*args, **kw)
    a = (args[0].clone().requires_grad_(True),) + args[1:]
    with pytest.raises(RuntimeError, match=f"{name}: an input requires grad"):
        fn(*a, **kw)
    with torch.no_grad():
        got = fn(*a, **kw)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    mod = {"rmsnorm": rn, "flash_attention": fa, "ssd_chunked": k6,
           "wkv6_chunked": k7}[name]
    assert mod.LAUNCHES[name] == 2            # the refused call launched none


def _train_loss_and_grads(cfg, params, batch):
    from repro_torch import tree as tree_util
    from repro_torch.models import forward_train
    leaves = [t.detach().requires_grad_(True)
              for t in tree_util.leaves(params)]
    loss, _ = forward_train(cfg, tree_util.unflatten_like(params, leaves),
                            batch, torch.float32)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b",
                                  "zamba2-1.2b"])
def test_forward_train_on_the_card_matches_the_cpu(cuda, arch):
    """Reduced configs, f32, 2 x 300 tokens (ragged chunks): the loss
    within 1e-4 relative, each gradient leaf within 1e-3 of its largest
    |value|, no kernel launched."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch).reduced()
    p = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 301))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    want_loss, want = _train_loss_and_grads(cfg, p, batch)
    loss, got = _train_loss_and_grads(cfg, _tree_to(p, cuda), batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * float(want_loss)
    for g, w in zip(got, want):
        assert g.is_cuda
        err = float((g.cpu() - w).abs().max()) / float(w.abs().max())
        assert err <= 1e-3
    assert rn.LAUNCHES["rmsnorm"] == fa.LAUNCHES["flash_attention"] == \
        k6.LAUNCHES["ssd_chunked"] == k7.LAUNCHES["wkv6_chunked"] == 0


def test_train_steps_and_checkpoint_on_the_card(cuda, tmp_path):
    """Three bf16 steps of reduced llama on the card: finite losses, every
    leaf moved by step 1, no kernel launched; an async checkpoint of the
    card state restores bit-equal onto the card, and its next step gives
    the uninterrupted loss."""
    from repro_torch import tree as tree_util
    from repro_torch.ckpt import CheckpointManager, restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_batches
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    cfg = get_config("llama3.2-1b").reduced()
    params, st = init_train_state(cfg, torch.Generator().manual_seed(0),
                                  device=cuda)
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1))
    batches = make_lm_batches(cfg, 4, 128, 4, seed=1)
    p1, s1, m = step(params, st, batches[0])
    assert not any(torch.equal(a, b) for a, b in zip(
        tree_util.leaves(params), tree_util.leaves(p1)))
    p2, s2, m2 = step(p1, s1, batches[1])
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(2, {"params": p2, "opt": s2})
    mgr.wait()
    back, n, _ = restore_checkpoint(tmp_path, {"params": p2, "opt": s2},
                                    device=cuda)
    assert n == 2
    for a, b in zip(tree_util.leaves(back), tree_util.leaves(
            {"params": p2, "opt": s2})):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
    _, _, m3 = step(p2, s2, batches[2])
    _, _, m3r = step(back["params"], back["opt"], batches[2])
    for x in (m, m2, m3):
        assert np.isfinite(float(x["loss"])) and float(x["grad_norm"]) > 0
    assert abs(float(m3r["loss"]) - float(m3["loss"])) <= \
        1e-3 * float(m3["loss"])
    assert rn.LAUNCHES["rmsnorm"] == fa.LAUNCHES["flash_attention"] == 0


# ---------------------------------------------------------------------------
# the moe, audio and vlm families' shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d", [(6000, 768), (256, 768), (4, 768),
                                    (9024, 8192), (4, 8192)])
def test_rmsnorm_kernel_at_the_family_shapes(cuda, rows, d):
    """K4 at whisper's d 768 (encoder, decoder prefill and decode rows) and
    internvl2's d 8,192, bf16 with a bf16 and an f32 scale: bit-exact."""
    g = torch.Generator().manual_seed(d + rows)
    x = torch.randn(rows, d, generator=g).to(torch.bfloat16).to(cuda)
    s = (torch.rand(d, generator=g) + 0.5).to(cuda)
    for sc in (s.to(torch.bfloat16), s):
        assert torch.equal(rn.rmsnorm(x, sc), rn.rmsnorm_plain(x, sc))
    assert rn.LAUNCHES["rmsnorm"] == 2


@pytest.mark.parametrize("H,KV", [(16, 16), (64, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dh128_at_the_family_head_layouts(cuda, H, KV, dtype):
    """Dh 128, causal, in the model's (B, S, H, Dh) layout: moonshot's 16
    heads over 16 kv heads and internvl2's 64 over 8 (G 8), at a short
    S 300 (two whole 128-key tiles and a ragged 44)."""
    g = torch.Generator().manual_seed(H)
    q = torch.randn(2, 300, H, 128, generator=g).to(dtype).to(cuda)
    k, v = (torch.randn(2, 300, KV, 128, generator=g).to(dtype).to(cuda)
            for _ in range(2))
    got = fa.flash_attention_op(q, k, v, causal=True)
    _close(got.transpose(1, 2), fa.flash_attention_plain(
        *(t.transpose(1, 2) for t in (q, k, v))))
    assert fa.LAUNCHES["flash_attention"] == 1


@pytest.mark.parametrize("Sq", [64, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cross_attention_fewer_queries_than_keys(cuda, Sq, dtype):
    """Whisper's cross-attention: Sq 64 decoder queries (and one) against
    the encoder's 1,500 keys (11 whole 128-key tiles and a ragged 92),
    non-causal, H 12, Dh 64."""
    g = torch.Generator().manual_seed(Sq)
    q = torch.randn(2, 12, Sq, 64, generator=g).to(dtype).to(cuda)
    k, v = (torch.randn(2, 12, 1500, 64, generator=g).to(dtype).to(cuda)
            for _ in range(2))
    _close(fa.flash_attention(q, k, v, causal=False),
           fa.flash_attention_plain(q, k, v, causal=False))


@pytest.mark.parametrize("arch,S,reduced", [
    ("moonshot-v1-16b-a3b", 300, False), ("moonshot-v1-16b-a3b", 1, False),
    ("llama4-scout-17b-a16e", 300, True)])
def test_moe_mlp_on_the_card_matches_the_cpu(cuda, arch, S, reduced):
    """One MoE layer, f32: moonshot at its published width (d 2,048, 64
    experts, top-6 of 1,408), llama4-scout reduced (top-1): the experts
    chosen equal to the CPU's, the output within 1e-4 of its largest
    |value| (S 1: the dense mixture)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=1)
    p = {k: v[0] for k, v in moe.init_moe(
        torch.Generator().manual_seed(0), cfg, 1, device="cpu").items()}
    x = torch.randn(2, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    sel, _, _ = moe._route(x, p["router"], cfg.moe)
    sel_c, _, _ = moe._route(x.to(cuda), p["router"].to(cuda), cfg.moe)
    assert torch.equal(sel_c.cpu(), sel)
    want, aux = moe.moe_mlp(x, p, cfg)
    got, aux_c = moe.moe_mlp(x.to(cuda), _tree_to(p, cuda), cfg)
    assert float((got.cpu() - want).abs().max()) <= \
        1e-4 * float(want.abs().max())
    assert abs(float(aux_c) - float(aux)) <= 1e-6 * abs(float(aux))


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "whisper-small",
                                  "internvl2-76b"])
def test_family_prefill_on_the_card_matches_the_cpu(cuda, arch):
    """Reduced configs, f32, 2 x 100 tokens (whisper: 64 random frames;
    internvl2: 16 random patches): the logits and every cache tensor within
    1e-4 of their largest |value|, through K4 and K5 on the card."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.models import forward_prefill, init_params
    cfg = get_config(arch).reduced()
    p = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 100)))}
    if cfg.encoder is not None:
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder.enc_seq, cfg.d_model)).astype(np.float32))
    if cfg.vlm is not None:
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.vlm.n_patches, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        want = forward_prefill(cfg, p, batch, torch.float32)
        got = forward_prefill(cfg, _tree_to(p, cuda),
                              {k: v.to(cuda) for k, v in batch.items()},
                              torch.float32)
    for g, w in zip(tree_util.leaves(got), tree_util.leaves(want)):
        assert g.is_cuda and g.shape == w.shape
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max())
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers * (
        2 if cfg.encoder else 1) + (cfg.encoder.n_layers if cfg.encoder
                                     else 0)
    assert rn.LAUNCHES["rmsnorm"] > 0



def test_cache_device_qa_fetch_reaches_k2(cuda, tmp_path):
    """``InputCache.fetch_array(device_qa=True)`` folds a storage miss
    through K2 on the cache's device; a hit re-hashes without the card."""
    from repro_torch.dist import InputCache
    vol = np.random.default_rng(5).standard_normal((48, 48, 40)).astype(
        np.float32)
    np.save(tmp_path / "v.npy", vol)
    cache = InputCache(tmp_path / "cache", device="cuda")
    arr, digest, origin, nbytes, info = cache.fetch_array(
        tmp_path / "v.npy", device_qa=True)
    assert origin == "storage" and info["device_qa"]
    assert LAUNCHES["qa_checksum_chunk"] >= 1
    np.testing.assert_array_equal(arr, vol)
    launched = LAUNCHES["qa_checksum_chunk"]
    again = cache.fetch_array(tmp_path / "v.npy", device_qa=True)
    assert again[1:3] == (digest, "cache") and again[4] is None
    assert LAUNCHES["qa_checksum_chunk"] == launched


def test_cluster_runs_segment_unest_through_k4_and_k5(cuda, tmp_path):
    """Four in-process nodes drain a campaign-planned ``segment_unest``
    run on the card, per-node caches and a journal on, one node dying: one
    ok provenance a unit, and K4 / K5 launched 5 / 2 times a pipeline
    execution, counted around the pipeline's function."""
    from repro_torch.core import (Provenance, builtin_pipelines,
                                  generate_jobs, synthesize_dataset)
    from repro_torch.core.campaign import CampaignPlan
    from repro_torch.dist import ClusterRunner, InputCache, WorkQueue
    from repro_torch.dist.cache import summaries_from_cache_dirs
    from repro_torch.dist.journal import Journal
    ds = synthesize_dataset(tmp_path / "ds", "cu", n_subjects=3,
                            sessions_per_subject=2, shape=(32, 32, 32))
    pipe = builtin_pipelines("cuda")["segment_unest"]
    runs = {"n": 0}
    real_fn = pipe.fn

    def counted(inputs):
        out = real_fn(inputs)
        runs["n"] += 1
        return out

    pipe.fn = counted
    # node-0 holds two sessions' T1w, node-1 one: the plan pins them there,
    # and node-1 (second to start) leases its unit before it dies
    units = generate_jobs(ds, pipe, tmp_path / "jobs0").units
    for node, take in (("node-0", units[:2]), ("node-1", units[2:3])):
        warm = InputCache(tmp_path / "caches" / node)
        for u in take:
            for rel in u.inputs.values():
                warm.fetch_array(Path(ds.root) / rel)
    jobs = generate_jobs(ds, pipe, tmp_path / "jobs",
                         summaries=summaries_from_cache_dirs(
                             tmp_path / "caches"))
    rn.reset_launches(), fa.reset_launches()
    runner = ClusterRunner(pipe, ds.root, nodes=4,
                           plan=CampaignPlan.load(jobs.campaign_file),
                           cache_dir=tmp_path / "caches",
                           cache_per_node=True,
                           journal_dir=tmp_path / "wal",
                           die_after={"node-1": 1})
    results = runner.run(jobs.units)
    ok = [r for r in results if r.status == "ok"]
    assert sorted(r.unit.job_id for r in ok) == \
        sorted(u.job_id for u in jobs.units)
    for u in jobs.units:
        prov = Provenance.load(Path(u.out_dir))
        assert prov.status == "ok"
        assert prov.inputs == {u.inputs["T1w"]: u.input_digests["T1w"]}
    assert (rn.LAUNCHES["rmsnorm"], fa.LAUNCHES["flash_attention"]) == \
        (5 * runs["n"], 2 * runs["n"])
    assert runs["n"] >= len(jobs.units)
    warm_ids = {j for s in CampaignPlan.load(jobs.campaign_file).shards
                if s.node_id for j in s.unit_ids}
    assert sum(r.bytes_from_cache > 0 for r in ok
               if r.unit.job_id in warm_ids) >= 1
    assert "node-1" in runner.stats.dead_nodes
    q = WorkQueue.recover(Journal(tmp_path / "wal"))
    assert q.finished()
    q._journal.close()


def test_rpc_cluster_with_a_worker_process_on_the_card(cuda, tmp_path):
    """A coordinator serving over the socket with one in-process node, and
    a worker process that joins with no ``--device`` (so on cuda): both
    commit ``segment_unest`` units, every unit ends in one ok provenance,
    and the coordinator's own runs launch K4 / K5 5 / 2 times each."""
    from repro_torch.core import (Provenance, builtin_pipelines,
                                  query_available_work, synthesize_dataset)
    from repro_torch.dist import ClusterRunner
    root = Path(__file__).resolve().parents[1]
    ds = synthesize_dataset(tmp_path / "ds", "cu", n_subjects=3,
                            sessions_per_subject=2, shape=(32, 32, 32))
    pipe = builtin_pipelines("cuda")["segment_unest"]
    units, _ = query_available_work(ds, pipe)
    runs = {"n": 0}
    real_fn = pipe.fn

    def counted(inputs):
        out = real_fn(inputs)
        runs["n"] += 1
        return out

    pipe.fn = counted

    def hold(unit, attempt):
        # the local node waits (bounded) for the worker process to join
        deadline = time.time() + 120
        while time.time() < deadline:
            srv = runner.server
            if srv is not None and "ext-0" in srv.queue.alive_nodes():
                return
            time.sleep(0.05)

    runner = ClusterRunner(pipe, ds.root, nodes=1, transport="rpc",
                           fault_hook=hold)
    got = {}
    t = threading.Thread(target=lambda: got.update(r=runner.run(units)))
    t.start()
    while runner.server is None and t.is_alive():
        time.sleep(0.01)
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    worker = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.dist.rpc", "work",
         "--addr", runner.server.addr_str, "--pipeline", "segment_unest",
         "--data-root", str(ds.root), "--node-id", "ext-0",
         "--cache-dir", str(tmp_path / "ext-cache")],
        env=env, cwd=root, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    t.join(timeout=600)
    wout, _ = worker.communicate(timeout=120)
    assert not t.is_alive() and worker.returncode in (0, 3), wout
    assert sorted(r.unit.job_id for r in got["r"] if r.status == "ok") == \
        sorted(u.job_id for u in units)
    provs = [Provenance.load(Path(u.out_dir)) for u in units]
    assert all(p.status == "ok" for p in provs)
    assert "ext-0" in runner.stats.remote_nodes, wout
    assert any(p.node_id == "ext-0" for p in provs), wout
    assert (rn.LAUNCHES["rmsnorm"], fa.LAUNCHES["flash_attention"]) == \
        (5 * runs["n"], 2 * runs["n"])


def test_peer_fabric_cluster_on_the_card(cuda, tmp_path):
    """``segment_unest`` on cuda through a ``peer_fabric`` cluster: a warm
    pass on one node, then three nodes of which two fetch from its blob
    server; outputs byte-equal to the warm pass's, at least one peer hit,
    K4 / K5 5 / 2 times a pipeline run."""
    from repro_torch.core import (builtin_pipelines, query_available_work,
                                  synthesize_dataset)
    from repro_torch.dist import ClusterRunner
    ds = synthesize_dataset(tmp_path / "ds", "cu", n_subjects=3,
                            sessions_per_subject=2, shape=(32, 32, 32))
    pipe = builtin_pipelines("cuda")["segment_unest"]
    units, _ = query_available_work(ds, pipe)
    kw = dict(cache_dir=tmp_path / "caches", cache_per_node=True,
              peer_fabric=True, lease_ttl_s=10.0)
    ClusterRunner(pipe, ds.root, nodes=1, **kw).run(units)
    want = {u.job_id: {f.name: f.read_bytes()
                       for f in Path(u.out_dir).glob("*.npy")}
            for u in units}
    shutil.rmtree(Path(ds.root) / "derivatives")
    runs = {"n": 0}
    real_fn = pipe.fn

    def counted(inputs):
        out = real_fn(inputs)
        runs["n"] += 1
        return out

    pipe.fn = counted
    rn.reset_launches(), fa.reset_launches()
    runner = ClusterRunner(pipe, ds.root, nodes=3, **kw)
    results = runner.run(units)
    ok = [r for r in results if r.status == "ok"]
    assert len(ok) == len(units)
    assert runner.stats.cache["peer_hits"] >= 1
    assert runner.stats.cache["bytes_from_peer"] == \
        sum(r.bytes_from_peer for r in results)
    assert (rn.LAUNCHES["rmsnorm"], fa.LAUNCHES["flash_attention"]) == \
        (5 * runs["n"], 2 * runs["n"])
    got = {u.job_id: {f.name: f.read_bytes()
                      for f in Path(u.out_dir).glob("*.npy")}
           for u in units}
    assert got == want


# ---------------------------------------------------------------------------
# training on a DeviceMesh: one NCCL rank on the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def nccl_mesh(cuda, tmp_path):
    """A (1, 1) ('data', 'model') mesh over one NCCL rank on cuda:0."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield make_local_mesh()
    finally:
        dist.destroy_process_group()


def test_mesh_train_on_one_nccl_rank_matches_one_device(nccl_mesh):
    """Three f32 steps of reduced llama on the one-rank mesh give the
    one-device losses within 1e-5 relative; masters and moments are
    DTensors on the card, placed as ``shardings_for`` says; no kernel
    launched."""
    from torch.distributed.tensor import DTensor
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_batches
    from repro_torch.dist.sharding import param_specs, shardings_for
    from repro_torch.train import (OptConfig, init_train_state,
                                   make_train_step, shard_train_state)
    cfg = get_config("llama3.2-1b").reduced()
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    batches = make_lm_batches(cfg, 4, 128, 3, seed=1)

    def fresh():
        return init_train_state(cfg, torch.Generator().manual_seed(0),
                                device="cuda")
    p, s = fresh()
    one = make_train_step(cfg, opt, torch.float32)
    want = []
    for b in batches:
        p, s, m = one(p, s, b)
        want.append(float(m["loss"]))
    p, s = shard_train_state(*fresh(), nccl_mesh)
    step = make_train_step(cfg, opt, torch.float32, mesh=nccl_mesh)
    got = []
    for b in batches:
        p, s, m = step(p, s, b)
        got.append(float(m["loss"]))
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got, want))
    shard = shardings_for(nccl_mesh, param_specs(p, nccl_mesh))
    for tree in (p, s["m"], s["v"]):
        for (path, x) in tree_util.flatten_with_paths(tree):
            sh = shard
            for k in path:
                sh = sh[k]
            assert isinstance(x, DTensor) and x.device.type == "cuda"
            assert tuple(x.placements) == sh.placements
    assert rn.LAUNCHES["rmsnorm"] == fa.LAUNCHES["flash_attention"] == 0


def test_elastic_restore_onto_the_card(nccl_mesh, tmp_path):
    """A one-device checkpoint restored with ``shardings=`` onto the
    one-rank cuda mesh: DTensors on the card, bit-equal, bf16 included."""
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.dist.sharding import P, shardings_for
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(8, 6, generator=g),
            "b": torch.randn(6, generator=g).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}
    save_checkpoint(tmp_path / "ck", 1, tree)
    shard = shardings_for(nccl_mesh, {"w": P("data", "model"), "b": P(None),
                                      "step": P()})
    got, step, _ = restore_checkpoint(tmp_path / "ck", tree, shardings=shard)
    assert step == 1
    for k, want in tree.items():
        assert isinstance(got[k], DTensor) and got[k].device.type == "cuda"
        assert got[k].dtype == want.dtype
        assert torch.equal(got[k].full_tensor().cpu(), want)


def test_sharded_save_on_the_card(nccl_mesh, tmp_path):
    """A tree of DTensors on the one-rank cuda mesh saved synchronously
    and async: the files are the plain save's, bytes apart from
    provenance; a save whose write fails raises (the outcome agreed over
    NCCL)."""
    import json
    from repro_torch.ckpt import CheckpointManager, save_checkpoint
    from repro_torch.dist.sharding import NamedSharding, P, distribute
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(8, 6, generator=g),
            "b": torch.randn(6, generator=g).to(torch.bfloat16)}
    placed = {"w": distribute(tree["w"], NamedSharding(
        nccl_mesh, P("data", "model"))),
        "b": distribute(tree["b"], NamedSharding(nccl_mesh, P(None)))}
    save_checkpoint(tmp_path / "plain", 1, tree)
    save_checkpoint(tmp_path / "sync", 1, placed)
    mgr = CheckpointManager(tmp_path / "async")
    mgr.save_async(1, placed)
    mgr.wait()
    want = tmp_path / "plain" / "step_00000001"
    for got in (tmp_path / "sync", tmp_path / "async"):
        got = got / "step_00000001"
        names = sorted(q.name for q in want.iterdir())
        assert sorted(q.name for q in got.iterdir()) == names
        for name in names:
            a, b = (got / name).read_bytes(), (want / name).read_bytes()
            if name == "provenance.json":
                a, b = json.loads(a), json.loads(b)
                for k in ("started_at", "finished_at", "host"):
                    a.pop(k), b.pop(k)
            assert a == b, name
    (tmp_path / "a_file").write_text("")
    with pytest.raises(OSError):
        save_checkpoint(tmp_path / "a_file" / "ck", 1, placed)
    mgr = CheckpointManager(tmp_path / "a_file" / "ck")
    mgr.save_async(1, placed)
    with pytest.raises(OSError):
        mgr.wait()


def test_compressed_psum_on_the_card(nccl_mesh):
    """The int8 compressed sum over the mesh's 'data' axis on the card:
    its new error is the CPU formula's, bit for bit, and sum + error
    reconstructs the input within the scale's step."""
    from repro_torch.dist.collectives import (compressed_psum,
                                              dequantize_int8, quantize_int8)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(100_003, generator=g) * 3
    e = torch.randn(100_003, generator=g) * 0.01
    y, err = compressed_psum(x.cuda(), e.cuda(), (nccl_mesh, "data"))
    xe = x + e
    s = xe.abs().max()
    want = xe - dequantize_int8(quantize_int8(xe, s), s)
    assert torch.equal(err.cpu(), want)
    assert float((y.cpu() + err.cpu() - xe).abs().max()) <= float(s) / 127
