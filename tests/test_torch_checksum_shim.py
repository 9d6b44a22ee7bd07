"""The CUDA source of the fused QA + checksum kernels (K1, K2) and the
transfer checksum (K3), built for the CPU through ``tools/cuda_shim`` and
held bit for bit against ``ref.py`` and the plain versions.

The shim runs ``checksum.cu`` with one thread per CUDA thread and its
blocks one after another, on a card of 2 SMs (so a row spreads over up
to 8 blocks). So the kernels' own logic runs here: the warp's halving
tree in registers (in the lane, across lanes, inside a 16-byte group),
the scalar path of unaligned rows and small steps, the word positions
mod 65521, the masks of ragged steps, the per-row tickets and the last
block's fold of the step sums in step order; and K3's spans of 16-byte
groups at every start offset (the bytewise head and tail words, and a
start 1-3 bytes past a word boundary bytewise throughout), its
positions advanced by compare-and-subtract across 65,521 words, and the
last block's sum of the block partials. What the shim cannot show
(that the card compiles the source, its memory model, and its speed) the
card tests show: ``tests/test_torch_cuda.py`` with the ``cuda`` marker,
on a GPU.

The C functions are called with CPU pointers through ``checksum.run_qa``,
``run_chunk`` and ``run_device_checksum`` (the wrappers themselves run the
plain versions for CPU tensors). Tolerance: none. Sums, counts and the f32
sum bit-exact, min/max equal by value, and the ticket buffer left zero.
The broken copies of the source (one tree level's pairs, the fold's
order, the ticket; K3's wrap compare, its last block's sum, its tail's
zero padding) must each fail these checks.
"""
import ctypes
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.checksum import checksum as ck
from repro_torch.kernels.checksum import ref

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src/repro_torch/kernels/checksum/csrc/checksum.cu"
DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16, "int8": torch.int8,
          "uint8": torch.uint8, "int16": torch.int16,
          "uint16": torch.uint16, "int32": torch.int32,
          "uint32": torch.uint32}

# broken copies of the source: what is broken -> (the text replaced, its
# replacement); each text must occur in the source
BROKEN = {
    # the lane's groups taken in memory order: its in-lane level pairs
    # neighbouring groups, not those half a step apart
    "in-lane pairs": ("bitrev(T0 + u, L)", "(T0 + u)"),
    # the step sums added last to first
    "fold reversed": (
        "  const float4* s4 = reinterpret_cast<const float4*>(s);",
        "  for (int j = n - 1; j >= 0; --j) acc += s[j];\n  return acc;\n"
        "  const float4* s4 = reinterpret_cast<const float4*>(s);"),
    # the last block but one folds the row
    "ticket off by one": ("== static_cast<unsigned>(B - 1)",
                          "== static_cast<unsigned>(B - 2)"),
    # K3: a word at position 65,521 of a wrapping span is not taken to 0
    "K3 wrap compare off by one": ("pw = pw >= kMPos ? pw - kMPos : pw;",
                                   "pw = pw > kMPos ? pw - kMPos : pw;"),
    # K3: the last block adds every partial but the last block's
    "K3 last block skips a partial": (
        "const int nb = static_cast<int>(gridDim.x);",
        "const int nb = static_cast<int>(gridDim.x) - 1;"),
    # K3: the bytes after the last one are read into the last word
    "K3 tail not zero-padded": ("load_word(a.data, 4 * i, a.nbytes)",
                                "load_word(a.data, 4 * i, a.nbytes + 3)"),
}


def _build(src: Path, out: Path) -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "tools" / "cuda_shim"))
    try:
        from build import build
    finally:
        sys.path.pop(0)
    return ctypes.CDLL(str(build(src, out)))


@pytest.fixture(scope="module")
def shim_dir(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source through the shim")
    return tmp_path_factory.mktemp("shim")


@pytest.fixture(scope="module")
def lib(shim_dir):
    return _build(CU, shim_dir / "libchecksum.so")


def _same(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a, b)
        assert np.array_equal(a, b, equal_nan=True), (a, b)


def _np(carry):
    return [c.numpy() for c in carry]


def _qa(lib, x, blk=1024):
    """K1 through the shim, with a fresh ticket buffer that must come back
    zero."""
    sync = torch.zeros(1 << 16, dtype=torch.int32)
    out = ck.run_qa(lib, x, blk=blk, sync=sync)
    assert not sync.any(), sync
    return out


def _chunk(lib, data, off, carry, **kw):
    sync = torch.zeros(1 << 16, dtype=torch.int32)
    out = ck.run_chunk(lib, data, off, carry, sync=sync, **kw)
    assert not sync.any(), sync
    return out


def _values(shape, dtype, seed, raw):
    """Random bytes viewed as ``dtype`` (every bit pattern: NaN, inf and
    subnormals), or normal floats (sums that stay finite, so every rounding
    of the tree shows)."""
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype]
    if not raw and tdt.is_floating_point:
        return torch.from_numpy(
            rng.normal(0, 50, shape).astype(np.float32)).to(tdt)
    n = int(np.prod(shape)) * tdt.itemsize
    return torch.from_numpy(rng.integers(0, 256, n, np.uint8)).view(
        tdt).reshape(shape)


# per dtype: blk 8 and 128 (scalar path below 32 groups a step), 512 to
# 4096 (the vector path, 1 to 32 groups a lane where the dtype reaches
# them); one aligned row with a ragged last step, and 3 rows whose odd
# length leaves rows 1 and 2 unaligned (the scalar path)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("blk", [8, 128, 512, 1024, 4096])
@pytest.mark.parametrize("G,nv", [(1, 9000), (3, 2001)])
def test_k1_matches_plain(lib, dtype, blk, G, nv):
    raw = blk in (8, 1024)
    x = _values((G, nv), dtype, seed=blk + nv, raw=raw)
    _same(_np(_qa(lib, x, blk)),
          _np(ck.qa_checksum_batched_plain(x, blk=blk)))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_k1_fold_over_pieces(lib, dtype):
    """5,001 steps of 8 values: the fold stages three pieces of step sums
    (2,048, 2,048 and 905), the next one loaded while one is added."""
    x = _values((1, 40_003), dtype, seed=11, raw=False)
    _same(_np(_qa(lib, x, blk=8)),
          _np(ck.qa_checksum_batched_plain(x, blk=8)))


# the dtypes numpy holds (the oracle is numpy)
@pytest.mark.parametrize("dtype", [d for d in DTYPES if d != "bfloat16"])
def test_k1_matches_the_oracle(lib, dtype):
    x = _values((2, 3001), dtype, seed=7, raw=dtype != "float32")
    _same(_np(_qa(lib, x)), ref.qa_checksum_batched_ref(x.numpy()))


def test_special_values(lib):
    """NaN, +-inf, subnormals and -0.0 among normal values, in a ragged
    last step, in f32 and f16."""
    specials = [np.nan, np.inf, -np.inf, 1e-45, -3e-39, 1e-40, -0.0, 0.0,
                2.0, -7.5]
    x = np.asarray(specials * 700, np.float32)[:6993]
    for arr in (x, x.astype(np.float16)):
        got = _np(_qa(lib, torch.from_numpy(arr).reshape(1, -1)))
        _same(got, ref.qa_checksum_batched_ref(arr.reshape(1, -1)))
    # -0.0 everywhere: K1's fold starts from +0.0, so its sum is +0.0; from
    # a carry of -0.0, K2's stays -0.0. Equal by value is not enough here:
    # the sign bits must agree too
    neg = torch.full((2048,), -0.0)
    got = _qa(lib, neg.reshape(1, -1))[1][0, 2]
    assert not np.signbit(got.item())
    carry = (torch.zeros(2, dtype=torch.int32),
             torch.tensor([np.inf, -np.inf, -0.0]),
             torch.zeros(1, dtype=torch.int32))
    kw = dict(dtype=torch.float32, blk_v=1024, nblocks=2)
    off = (0, 0, 2048, 2048)
    got = _chunk(lib, neg.view(torch.uint8), off, carry, **kw)[1][2]
    want = ck.qa_checksum_chunk_plain(neg.view(torch.uint8), off, carry,
                                      **kw)[1][2]
    assert np.signbit(got.item()) and np.signbit(want.item())


@pytest.mark.parametrize("dtype,blk_v,head,nb", [
    ("float32", 1024, 63, 4),      # words 64,512-68,607 cross 65,521
    ("float32", 128, 511, 3),      # 65,408-65,791, vector path R = 1
    ("float16", 1024, 127, 3),     # 512 words a step: 65,024-66,559
    ("uint8", 4096, 63, 2),        # 1,024 words a step: 64,512-66,559
    ("float32", 64, 1022, 5),      # scalar path: 65,408-65,727
])
@pytest.mark.parametrize("carry_kind", ["subnormal sum", "inf min/max"])
def test_k2_chunk_from_a_carry(lib, dtype, blk_v, head, nb, carry_kind):
    tdt = DTYPES[dtype]
    n = (head + nb) * blk_v - 3          # the chunk ends ragged
    x = _values((n,), dtype, seed=head, raw=False)
    data = x.view(torch.uint8)[head * blk_v * tdt.itemsize:]
    qa = [np.inf, -np.inf, 1e-40] if carry_kind == "subnormal sum" \
        else [-np.inf, np.inf, -2.5e-39]
    carry = (torch.tensor([7, -9], dtype=torch.int32),
             torch.tensor(qa, dtype=torch.float32),
             torch.tensor([11], dtype=torch.int32))
    nw = (n * tdt.itemsize + 3) // 4
    off = (head * blk_v * tdt.itemsize // 4, head * blk_v, nw, n)
    kw = dict(dtype=tdt, blk_v=blk_v, nblocks=nb)
    _same(_np(_chunk(lib, data, off, carry, **kw)),
          _np(ck.qa_checksum_chunk_plain(data, off, carry, **kw)))


@pytest.mark.parametrize("dtype", ["float32", "float16", "int8"])
def test_k2_chunks_fold_to_the_one_shot(lib, dtype):
    """The accumulator's launches (whole blocks, then the ragged tail),
    chained through their carries, equal one-shot K1 and the oracle."""
    tdt = DTYPES[dtype]
    x = _values((20011,), dtype, seed=3, raw=False)
    acc = ck.QAChecksumAccumulator(x.numel(), x.numpy().dtype,
                                   device="cpu")
    data = x.view(torch.uint8)
    step = acc.align_bytes
    carry = ck.initial_carry("cpu")
    kw = dict(dtype=tdt, blk_v=acc.blk_v)
    for lo in range(0, data.numel(), 3 * step):
        part = data[lo:lo + 3 * step]
        nb = -(-part.numel() // step)
        off = (lo // 4, lo // tdt.itemsize, acc.nw, acc.n_vals)
        carry = _chunk(lib, part, off, carry, nblocks=nb, **kw)
    one = _np(_qa(lib, x.reshape(1, -1)))
    _same([c[None] for c in _np(carry)], one)
    _same(one, ref.qa_checksum_batched_ref(x.numpy().reshape(1, -1)))


def _k3(lib, x):
    """K3 through the shim, with a fresh ticket buffer that must come back
    zero; held against the plain version and the oracle."""
    sync = torch.zeros(64, dtype=torch.int32)
    got = ck.run_device_checksum(lib, x, sync=sync).numpy()
    assert not sync.any(), sync
    _same([got], [ck.device_checksum_plain(x).numpy()])
    # the oracle on the bytes (numpy has no bfloat16)
    _same([got], [ref.device_checksum_ref(
        x.contiguous().view(torch.uint8).numpy())])


@pytest.mark.parametrize("nbytes", [1, 3, 4, 4097, 1 << 18, 262_147])
def test_k3_matches_plain_and_oracle(lib, nbytes):
    _k3(lib, _values((nbytes,), "uint8", seed=nbytes, raw=True))


# sizes: none, sub-word, around a 16-byte group, the shim's grid stride
# (8 blocks x 8 warps x 128 groups = 128 KiB) and 65,521 words (262,084
# bytes: the first position wrap), and a tail after many wraps
K3_SIZES = [0, 1, 3, 15, 16, 17, 33, 4099, 131_069, 131_072, 131_075,
            262_080, 262_083, 262_084, 262_085, 262_088, 300_001]


@pytest.mark.parametrize("offset", range(16))
def test_k3_at_every_start(lib, offset):
    """Starts 0-15 bytes into a 16-byte aligned buffer, so each of the
    body's four alignments of words to groups shows and the starts that
    are not word-aligned, ragged sizes; the bytes around the range are
    random, so a read past it shows."""
    buf = _values((300_032,), "uint8", seed=offset, raw=True)
    for n in K3_SIZES:
        _k3(lib, buf[offset:offset + n])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k3_every_dtype_view(lib, dtype):
    """A tensor of each dtype, whole and from its second and fourth value
    on (starts of 1-4 itemsizes: unaligned for 1- and 2-byte dtypes)."""
    x = _values((70_001,), dtype, seed=5, raw=True)
    for v in (x, x[1:], x[3:-2]):
        _k3(lib, v)


def test_a_block_past_the_tree_fails_to_launch(lib):
    with pytest.raises(RuntimeError, match="failed to launch"):
        _qa(lib, torch.zeros(1, 1 << 15), blk=1 << 15)


def _fails(bad) -> bool:
    """Whether a kernel fails any of the checks above on four inputs: one
    aligned f32 row (vector path, 8 groups a lane, several blocks), 3
    unaligned f16 rows, a chunk from a carry, and K3 over 300,001 bytes at
    three starts."""
    try:
        x = _values((1, 40_000), "float32", seed=1, raw=False)
        _same(_np(_qa(bad, x)), _np(ck.qa_checksum_batched_plain(x)))
        x = _values((3, 9_001), "float16", seed=2, raw=False)
        _same(_np(_qa(bad, x)), _np(ck.qa_checksum_batched_plain(x)))
        x = _values((9 * 1024,), "float32", seed=3, raw=False)
        data = x.view(torch.uint8)[1024 * 4:]
        carry = (torch.tensor([1, 2], dtype=torch.int32),
                 torch.tensor([0.5, 0.5, 3.0]),
                 torch.tensor([1], dtype=torch.int32))
        kw = dict(dtype=torch.float32, blk_v=1024, nblocks=8)
        off = (1024, 1024, 9 * 1024, 9 * 1024)
        _same(_np(_chunk(bad, data, off, carry, **kw)),
              _np(ck.qa_checksum_chunk_plain(data, off, carry, **kw)))
        buf = _values((300_032,), "uint8", seed=4, raw=True)
        for offset in (0, 1, 6):         # K3: many blocks, wraps, a tail
            _k3(bad, buf[offset:offset + 300_001])
    except AssertionError:
        return True
    return False


def test_the_committed_source_passes_the_broken_copies_check(lib):
    assert not _fails(lib)


@pytest.mark.parametrize("broken", sorted(BROKEN))
def test_broken_kernels_fail_the_check(shim_dir, broken):
    old, new = BROKEN[broken]
    src = CU.read_text()
    assert old in src, f"the source no longer has {old!r}"
    path = shim_dir / f"broken_{sorted(BROKEN).index(broken)}.cu"
    path.write_text(src.replace(old, new))
    assert _fails(_build(path, path.with_suffix(".so")))
