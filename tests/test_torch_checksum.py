"""The port's QA+checksum family (K1 one-shot, K2 chunk fold, K3 transfer
checksum) held against the JAX package and the numpy oracle, on the CPU.

Here every wrapper runs its kernel's plain version (the tensors lie on the
CPU); the CUDA kernels themselves are held against these plain versions on
the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Tolerance: none. s1/s2, finite counts and the f32 sum must be bit-exact,
min/max equal by value (-0.0 == +0.0).

Subnormal policy (ROADMAP R1): interpret-mode Pallas on XLA-CPU flushes f32
subnormals, the oracle and the port keep them. So inputs held against the
JAX functions have no f32 subnormals; ``test_subnormals_match_oracle``
holds the port against ``ref.py`` alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.checksum import QAChecksumAccumulator as JaxAccumulator
from repro.kernels.checksum import device_checksum as jax_device_checksum
from repro.kernels.checksum import qa_checksum as jax_qa_checksum
from repro.kernels.checksum import qa_checksum_batched as jax_qa_batched
from repro.kernels.checksum import qa_stats as jax_qa_stats
from repro_torch.convert import accumulator_from_jax, from_jax
from repro_torch.kernels.checksum import (ACCUMULATOR_DTYPES, LAUNCHES,
                                          QAChecksumAccumulator, QAStats,
                                          device_checksum, qa_checksum,
                                          qa_checksum_batched, qa_stats, ref)

ML_BF16 = jnp.bfloat16     # numpy dtype of JAX's bfloat16 (ml_dtypes)


def _make(shape, dtype: str, seed=0, nonfinite=False):
    """Values without f32 subnormals, made from a seed with numpy."""
    rng = np.random.default_rng(seed)
    if dtype in ("float16", "float32", "bfloat16"):
        x = rng.normal(0, 50, shape).astype(np.float32)
        x[np.abs(x) < 1e-3] = 1.0
        if nonfinite and x.size > 4:
            f = x.reshape(-1)
            f[1], f[2], f[-1] = np.nan, np.inf, -np.inf
        return x.astype(ML_BF16 if dtype == "bfloat16" else dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype,
                        endpoint=True)


def _t(x: np.ndarray) -> torch.Tensor:
    return from_jax(x, "cpu")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a, b)
    assert np.array_equal(a, b, equal_nan=True), (a, b)


def _same_outputs(got, *refs):
    for r in refs:
        for a, b in zip(got, r):
            _same(a.numpy() if isinstance(a, torch.Tensor) else a, b)


@pytest.mark.parametrize("dtype", [*ACCUMULATOR_DTYPES, "bfloat16"])
@pytest.mark.parametrize("shape", [(1,), (5,), (33, 7), (16, 16, 16)])
def test_qa_checksum_matches_jax_and_oracle(dtype, shape):
    x = _make(shape, dtype, nonfinite=True)
    got = qa_checksum(_t(x))
    _same_outputs(got, ref.qa_checksum_ref(x),
                  [np.asarray(a) for a in
                   jax_qa_checksum(jnp.asarray(x), interpret=True)])
    # the fused checksum words == the plain transfer checksum
    _same(got[0].numpy(), device_checksum(_t(x)).numpy())


@pytest.mark.parametrize("shape,dtype", [
    ((5, 12, 12, 12), "float32"), ((5, 12, 12, 12), "bfloat16"),
    ((2, 27), "int16"), ((2, 3), "int8"), ((3, 5, 5), "bfloat16"),
    ((4, 9), "uint8"),
])
def test_qa_checksum_batched_rows(shape, dtype):
    """Batched rows (sub-word rows pad per row, never letting a word
    straddle two volumes) == the oracle == JAX == each row alone."""
    x = _make(shape, dtype, seed=1)
    if dtype == "float32":
        x[3, 0, 0, 0] = np.nan
    got = qa_checksum_batched(_t(x))
    _same_outputs(got, ref.qa_checksum_batched_ref(x),
                  [np.asarray(a) for a in
                   jax_qa_batched(jnp.asarray(x), interpret=True)])
    for i in range(shape[0]):
        s, q, c = qa_checksum(_t(x[i]))
        _same(s.numpy(), got[0][i].numpy())
        _same(q.numpy(), got[1][i].numpy())
        _same(c.numpy(), got[2][i].numpy())


def test_nonfinite_counts_and_corruption():
    x = _make((256,), "float32", seed=2)
    xn = x.copy()
    xn[3], xn[200] = np.nan, np.inf
    st = qa_stats(_t(xn))
    assert st.finite_count == 254 and st.vmin <= st.vmax
    assert np.isfinite(st.vsum)
    assert st == QAStats(**vars(jax_qa_stats(jnp.asarray(xn),
                                             interpret=True)))
    xc = x.copy()
    xc[17] += 1e-3
    assert qa_stats(_t(xc)).checksum != qa_stats(_t(x)).checksum
    none = qa_stats(_t(np.full(8, np.nan, np.float32)))
    assert (none.finite_count, none.vmin, none.vmax, none.vsum) == \
        (0, np.inf, -np.inf, 0.0)


@pytest.mark.parametrize("shape,dtype", [
    ((1000,), "float32"), ((33, 7), "bfloat16"), ((5,), "int32"),
    ((4096,), "float32"), ((1,), "float32"), ((7,), "int8"),
    ((0,), "float32"),
])
def test_device_checksum_matches_jax_and_oracle(shape, dtype):
    x = _make(shape, dtype, seed=3)
    got = device_checksum(_t(x)).numpy()
    _same(got, ref.device_checksum_ref(np.asarray(x)))
    if x.size:
        _same(got, np.asarray(jax_device_checksum(jnp.asarray(x),
                                                  interpret=True)))


@pytest.mark.parametrize("offset", range(1, 16))
def test_device_checksum_at_byte_offsets(offset):
    """A range that starts 1-15 bytes into a buffer (the CUDA kernel's
    unaligned starts), at sizes around a 16-byte group and around 65,521
    words (the first position wrap): the port == JAX == the oracle."""
    buf = np.random.default_rng(offset).integers(0, 256, 262_160, np.uint8)
    for n in (4099, 262_083, 262_087):
        b = buf[offset:offset + n]
        got = device_checksum(torch.from_numpy(buf)[offset:offset + n])
        _same(got.numpy(), ref.device_checksum_ref(b))
        _same(got.numpy(), np.asarray(jax_device_checksum(jnp.asarray(b),
                                                          interpret=True)))


def _feed(acc, data: bytes, chunk: int):
    for o in range(0, len(data), chunk):
        acc.update(data[o:o + chunk])
    return acc.finalize()


@pytest.mark.parametrize("dtype", ACCUMULATOR_DTYPES)
def test_accumulator_every_dtype_equals_one_shot(dtype):
    x = _make((9, 9, 7), dtype, seed=4, nonfinite=True)
    one = qa_stats(_t(x))
    assert one == QAStats.from_carry(*ref.qa_checksum_ref(x))
    for backend in ("auto", "host"):
        acc = QAChecksumAccumulator(x.size, x.dtype, backend=backend,
                                    device="cpu")
        assert _feed(acc, x.tobytes(), 100) == one


@pytest.mark.parametrize("chunk", [1, 7, 1000, 4096, 64 << 10, 1 << 20])
def test_accumulator_chunk_sizes(chunk):
    """Any chunking folds to the one-shot stats, on the port's device fold,
    its host fold and the JAX accumulator alike."""
    shape = (1025,) if chunk == 1 else (24, 24, 20)   # byte-wise: keep short
    x = _make(shape, "float32", seed=5, nonfinite=True)
    data = x.tobytes()
    one = qa_stats(_t(x))
    got = _feed(QAChecksumAccumulator(x.size, x.dtype, device="cpu"),
                data, chunk)
    host = _feed(QAChecksumAccumulator(x.size, x.dtype, backend="host"),
                 data, chunk)
    jax_st = _feed(JaxAccumulator(x.size, x.dtype, backend="host"),
                   data, chunk)
    assert got == host == one == QAStats(**vars(jax_st))


def test_accumulator_truncation_and_overrun_raise():
    x = _make((100,), "float32")
    acc = QAChecksumAccumulator(x.size, x.dtype, device="cpu")
    acc.update(x.tobytes()[:-4])
    with pytest.raises(ValueError, match="truncated"):
        acc.finalize()
    acc = QAChecksumAccumulator(x.size, x.dtype, device="cpu")
    with pytest.raises(ValueError, match="overrun"):
        acc.update(x.tobytes() + b"\0")
    with pytest.raises(ValueError, match="unsupported"):
        QAChecksumAccumulator(4, np.float64, device="cpu")


@pytest.mark.parametrize("jax_backend,cut", [("host", 5000),
                                              ("device", 4096 * 3 + 10)])
def test_carry_handoff_from_jax_midstream(jax_backend, cut):
    """A stream the JAX accumulator began (carry, blocks done, tail)
    finishes in the port with the QAStats the JAX one would have given."""
    x = _make((20, 20, 20), "float32", seed=6, nonfinite=True)
    data = x.tobytes()
    full = _feed(JaxAccumulator(x.size, x.dtype, backend=jax_backend,
                                interpret=True), data, 3000)
    jacc = JaxAccumulator(x.size, x.dtype, backend=jax_backend,
                          interpret=True)
    for o in range(0, cut, 3000):
        jacc.update(data[o:min(o + 3000, cut)])
    assert jacc._blocks_done > 0 and len(jacc._buf) > 0
    for backend in ("auto", "host"):
        port = accumulator_from_jax(jacc, "cpu", backend=backend)
        st = _feed(port, data[cut:], 777)
        assert st == QAStats(**vars(full)) == qa_stats(_t(x))


@pytest.mark.parametrize("values", [
    [1e-45], [1e-40, -3e-39, 2.0], [0.0, -0.0, 1e-38, -1e-44],
])
def test_subnormals_match_oracle(values):
    """R1: the port keeps f32 subnormals, like ref.py (the JAX package's
    interpret-mode Pallas flushes them, so it is not held here)."""
    x = np.asarray(values * 300, np.float32)
    _same_outputs(qa_checksum(_t(x)), ref.qa_checksum_ref(x))
    st = _feed(QAChecksumAccumulator(x.size, x.dtype, device="cpu"),
               x.tobytes(), 1000)
    assert st == QAStats.from_carry(*ref.qa_checksum_ref(x))


def test_from_jax_walks_trees_and_keeps_bfloat16_bits():
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": [np.float32([1.5]), (np.asarray(jnp.ones(3, jnp.bfloat16)),
                                      "tag")],
            "n": 7}
    out = from_jax(tree, "cpu")
    assert out["a"].dtype == torch.int32 and out["a"].shape == (2, 3)
    assert out["b"][0].item() == 1.5
    assert out["b"][1][0].dtype == torch.bfloat16
    assert out["b"][1][0].float().tolist() == [1.0, 1.0, 1.0]
    assert out["b"][1][1] == "tag" and out["n"] == 7


def test_plain_versions_never_count_as_launches():
    before = dict(LAUNCHES)
    qa_checksum(_t(_make((64,), "float32")))
    device_checksum(_t(_make((64,), "float32")))
    assert LAUNCHES == before
