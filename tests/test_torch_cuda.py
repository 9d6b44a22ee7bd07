"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here skips without a GPU; on
an H100 run them with ``python -m pytest -m cuda tests/test_torch_cuda.py``
(``chip_smoke.py`` holds the same kernels at the main path's full sizes).
Tolerance: none — the kernels keep the plain versions' reduction order, so
every output is bit-exact (min/max equal by value).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.checksum import (ACCUMULATOR_DTYPES, LAUNCHES,
                                          QAChecksumAccumulator, QAStats,
                                          device_checksum, qa_checksum,
                                          qa_checksum_batched,
                                          qa_checksum_chunk, qa_stats, ref,
                                          reset_launches)

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


def test_kernel_failure_raises(cuda):
    with pytest.raises(RuntimeError, match="failed to launch"):
        # a 32768-value block is past the kernel's shared-memory tree
        qa_checksum(torch.zeros(1 << 15, device=cuda), blk=1 << 15)
