"""The CUDA source of RMSNorm (K4), built for the CPU through
``tools/cuda_shim`` and held bit for bit against its plain version.

The shim runs ``rmsnorm.cu`` with one thread per CUDA thread and its blocks
one after another, on a card of 2 SMs. So the kernel's own logic runs here:
the 16-byte groups held in registers, the tree's levels in a thread's
registers, through shared memory and across a warp's lanes, the scale
staged once a block and rounded to x's dtype, the scalar path of rows off a
16-byte boundary and of ragged widths, and the layouts ``repro_rmsnorm_plan``
picks (16 threads a row, a warp a row, a row spread over a block), in every
layout the source takes and on both sides of the plan's threshold, which
the shim's 2 SMs put at a few rows. What the shim cannot show (that the card
compiles the source, and its speed) the card tests show:
``tests/test_torch_cuda.py`` with the ``cuda`` marker, on a GPU.

The C functions are called with CPU pointers through ``rmsnorm.run_kernel``
(the wrapper itself runs the plain version for CPU tensors). Tolerance:
none. The broken copies of the source (the tree's levels in another order,
the scale not rounded to x's dtype, the ragged last group not masked) must
each fail the same checks.
"""
import ctypes
import importlib
import shutil
import sys
from pathlib import Path

import pytest
import torch

rn = importlib.import_module("repro_torch.kernels.rmsnorm.rmsnorm")

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"
WIDTHS = [7, 100, 128, 512, 2048, 4096]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
SCALES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TEAMS = [16, 32, 64, 128, 256, 512]

# broken copies of the source: what is broken -> (the text replaced, its
# replacement); each text must occur in the source
BROKEN = {
    # the lanes' levels from the nearest lane out, not from the farthest in
    "tree levels reordered": (
        "for (int off = (team < 32 ? team : 32) / 2; off > 0; off >>= 1)",
        "for (int off = 1; off < (team < 32 ? team : 32); off <<= 1)"),
    # the output multiplied by the scale as given, not rounded to x's dtype
    "scale not rounded": (
        "put<T>(o, i, __fmul_rn(xr_r, get<T>(sw, i)));",
        "put<T>(o, i, __fmul_rn(xr_r, c + i < d ? Elem<S>::value("
        "reinterpret_cast<const typename Elem<S>::Bits*>(scale)[c + i])"
        " : 0.0f));"),
    # the values past the row's end read into its last group
    "ragged group not masked": (
        "    if (c + i < d)\n      w[(i * sizeof(T)) / 4] |=",
        "    if (true)\n      w[(i * sizeof(T)) / 4] |="),
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
    return _build(CU, shim_dir / "librmsnorm.so")


def _inputs(rows, d, dtype, sdtype, seed, x_offset=0, s_offset=0):
    """x (rows, d) and scale (d,), each a view ``x_offset`` / ``s_offset``
    values into a buffer whose values past the view are large, so a read
    past the row shows."""
    g = torch.Generator().manual_seed(seed)
    xb = 8 * torch.randn(x_offset + rows * d + 64, generator=g)
    xb[:x_offset + rows * d] = torch.randn(x_offset + rows * d, generator=g)
    sb = torch.rand(s_offset + d + 8, generator=g) + 0.5
    x = xb.to(dtype)[x_offset:x_offset + rows * d].view(rows, d)
    return x, sb.to(sdtype)[s_offset:s_offset + d]


def _teams(d, dtype):
    """The layouts the source takes at width d: (threads a row, rows a
    block), one whole warp or more a block."""
    _, N = rn._padded_groups(d, dtype.itemsize)
    return [(t, max(1, 32 // t)) for t in TEAMS if t * 16 >= N] + \
           [(t, 256 // t) for t in TEAMS if t * 16 >= N and t < 256]


def _same(lib, x, s, **kw):
    got = rn.run_kernel(lib, x, s, **kw)
    want = rn.rmsnorm_plain(x, s)
    return torch.equal(got, want), got, want


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sdtype", ["bfloat16", "float32"])
def test_every_layout_is_bit_exact(lib, d, dtype, sdtype):
    """Each layout the source takes (16 to 512 threads a row, one row a
    block or several) gives the plain version's bits, on 5 rows (with
    several rows a block, the last block's dead rows write nothing)."""
    x, s = _inputs(5, d, DTYPES[dtype], SCALES[sdtype], seed=d)
    for layout in _teams(d, DTYPES[dtype]):
        ok, got, want = _same(lib, x, s, layout=layout)
        assert ok, (layout, (got.float() - want.float()).abs().max())


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_both_sides_of_its_threshold(lib, d, dtype):
    """``repro_rmsnorm`` at the most rows that take the few-rows layout and
    at one more (the shim's 2 SMs put the threshold at a few rows), with a
    bf16 and an f32 scale: the plain version's bits on both sides."""
    dt = DTYPES[dtype]
    at = rn.threshold(lib, d, dt)
    assert at > 1 and rn.plan(lib, at - 1, d, dt) != rn.plan(lib, at, d, dt)
    for rows in (at - 1, at):
        for sdtype in SCALES.values():
            x, s = _inputs(rows, d, dt, sdtype, seed=rows)
            ok, got, want = _same(lib, x, s)
            assert ok, (rows, sdtype, rn.plan(lib, rows, d, dt))


@pytest.mark.parametrize("d", [128, 2048, 4096])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows", [3, 40])
def test_rows_off_a_16_byte_boundary(lib, d, dtype, rows):
    """A view that starts one value into its storage (2 bytes past a
    16-byte boundary in bf16, 4 in f32) takes the scalar path, in the
    same order; so does a scale that starts 2 or 4 bytes in."""
    dt = DTYPES[dtype]
    for x_off, s_off in ((1, 0), (0, 1), (1, 1)):
        x, s = _inputs(rows, d, dt, torch.bfloat16, seed=rows + d,
                       x_offset=x_off, s_offset=s_off)
        assert x.data_ptr() % 16 == (x_off * dt.itemsize) % 16
        ok, got, want = _same(lib, x, s)
        assert ok, (x_off, s_off, rn.plan(lib, rows, d, dt))


def test_plan_follows_the_rows(lib):
    """With 2 SMs: rows that the many-rows layout puts in one block (at
    most half the SMs) spread one row over a block of one group a thread;
    from two blocks on, 32 threads a row in blocks of 256 (16 at d 128
    bf16, two rows a warp); past 512 groups a row, 16 groups a thread."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert rn.plan(lib, 4, 2048, bf16) == (256, 1)
    assert rn.plan(lib, 4, 4096, bf16) == (512, 1)
    assert rn.plan(lib, 4, 4096, f32) == (512, 1)
    assert rn.plan(lib, 16, 2048, bf16) == (32, 8)
    assert rn.plan(lib, 9, 2048, bf16) == (32, 8)
    assert rn.plan(lib, 8, 2048, bf16) == (256, 1)
    assert rn.plan(lib, 8000, 4096, bf16) == (32, 8)
    assert rn.plan(lib, 8000, 4096, f32) == (64, 4)
    assert rn.plan(lib, 180_224, 128, bf16) == (16, 16)


def test_refuses_what_it_cannot_hold(lib):
    """A row of more than 8,192 groups, or a layout whose threads hold more
    than 16 groups each, is refused (a RuntimeError naming the error)."""
    x, s = _inputs(2, 8 * 8192 + 8, torch.bfloat16, torch.float32, seed=1)
    with pytest.raises(RuntimeError):
        rn.run_kernel(lib, x, s)
    x, s = _inputs(2, 4096, torch.bfloat16, torch.float32, seed=1)
    with pytest.raises(RuntimeError):
        rn.run_kernel(lib, x, s, layout=(16, 2))


def _all_same(lib):
    """The checks the broken copies are held to: a ragged width and whole
    ones, bf16 and f32 x with an f32 scale, the default layout."""
    for d in (100, 2048):
        for dt in DTYPES.values():
            for rows in (3, 40):
                x, s = _inputs(rows, d, dt, torch.float32, seed=d + rows)
                if not _same(lib, x, s)[0]:
                    return False
    return True


@pytest.mark.parametrize("broken", list(BROKEN))
def test_broken_copies_fail(shim_dir, lib, broken):
    assert _all_same(lib)
    old, new = BROKEN[broken]
    src = CU.read_text()
    assert src.count(old) == 1, broken
    bad = shim_dir / f"broken_{broken.replace(' ', '_')}.cu"
    bad.write_text(src.replace(old, new))
    blib = _build(bad, bad.with_suffix(".so"))
    assert not _all_same(blib), broken
