"""The CUDA source of the Mamba-2 glue kernels, built for the CPU through
``tools/cuda_shim`` and held bit for bit against the arithmetic it is
meant to do.

The shim runs ``mamba2_glue.cu`` with one fiber per CUDA thread and its
blocks one after another. So the kernels' own logic runs here: conv_in's
4-channel groups, its window sliding down a tile of 64 tokens with
a 3-row halo from the tile before or from the conv state, the x / B / C
split, dt and lw once a head, the new conv state from the last tile; and
gate_norm's gate, K4's order of the sum of squares in each layout it
takes (16 threads a row, a warp a row, two warps a row through shared
memory) and its dead rows. What the shim cannot show (that the card
compiles the source, and its speed) the card tests show:
``tests/test_torch_cuda.py`` with the ``cuda`` marker, on a GPU.

The reference here is the torch ops' arithmetic (``mamba2_glue``'s plain
versions), with SiLU, softplus and exp taken from the C library that the
shim's build calls, so the two agree bit for bit on this host as the
kernels and the plain versions do on the card (torch's CPU exp is another
implementation: it would move a last bit now and then). Tolerance: none.
The broken copies of the source (the window not carried across tiles, a
partial sum of the conv not rounded to bf16, the D skip on the wrong head,
SiLU of z not rounded to bf16, a level of the norm's tree skipped) must
each fail the same checks.
"""
import ctypes
import ctypes.util
import importlib
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

gl = importlib.import_module("repro_torch.kernels.mamba2_glue.mamba2_glue")

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src/repro_torch/kernels/mamba2_glue/csrc/mamba2_glue.cu"
# (d_inner, d_state, heads): the reduced zamba2, zamba2-1.2b, and one with
# heads of 8 channels
WIDTHS = {"reduced": (256, 16, 8), "zamba2": (4096, 64, 64),
          "narrow": (64, 8, 8)}
GRANITE = (8192, 128, 128)      # granite-4.0-h-small: d_inner, N, heads

# broken copies of the source: what is broken -> (the text replaced, its
# replacement); each text must occur in the source once
BROKEN = {
    "window not carried across tiles": (
        "      win[j] = *reinterpret_cast<const uint2*>(xrow + t * st);",
        "      win[j] = make_uint2(0u, 0u);"),
    "conv partial sum not rounded": (
        "          y = rnd(__fadd_rn(y, rnd(__fmul_rn(bf(quarter_of(win[k], i)),",
        "          y = (__fadd_rn(y, rnd(__fmul_rn(bf(quarter_of(win[k], i)),"),
    "D skip on the wrong head": (
        "  const float D = Dv.at(c / dh);",
        "  const float D = Dv.at((c / dh) ^ 1);"),
    "silu of z not rounded": (
        "    const float sz = rnd(silu(bf(half_of(zv, i))));",
        "    const float sz = silu(bf(half_of(zv, i)));"),
    "norm tree level skipped": (
        "    for (int hh = team / 2; hh >= 32; hh >>= 1) {",
        "    for (int hh = team / 2; hh > 32; hh >>= 1) {"),
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
    return _build(CU, shim_dir / "libmamba2_glue.so")


# -- the reference: the plain versions with the C library's exp and log1p --

_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
for _fn in ("expf", "log1pf"):
    getattr(_LIBM, _fn).restype = ctypes.c_float
    getattr(_LIBM, _fn).argtypes = [ctypes.c_float]


def _libm(fn: str, a: np.ndarray) -> np.ndarray:
    f = getattr(_LIBM, fn)
    return np.array([f(float(v)) for v in a.ravel()],
                    np.float32).reshape(a.shape)


def _rnd(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _silu_table() -> np.ndarray:
    """bf16(x / (1 + expf(-x))) for every bf16 bit pattern x."""
    x = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    with np.errstate(all="ignore"):
        return _rnd(x / (np.float32(1) + _libm("expf", -x)))


SILU = _silu_table()


def _silu(t: torch.Tensor) -> torch.Tensor:
    """torch's SiLU of a bf16 tensor, with the C library's expf."""
    bits = t.contiguous().view(torch.int16).numpy().astype(np.uint16)
    return torch.from_numpy(SILU[bits]).to(torch.bfloat16)


def _softplus(v: torch.Tensor) -> torch.Tensor:
    a = v.numpy()
    with np.errstate(all="ignore"):
        return torch.from_numpy(np.where(
            a > np.float32(20), a, _libm("log1pf", _libm("expf", a))))


class _LibmOps:
    """``torch.nn.functional``'s SiLU and softplus, as the shim's build
    computes them."""
    @staticmethod
    def silu(t):
        return _silu(t)

    @staticmethod
    def softplus(t):
        return _softplus(t)


@pytest.fixture()
def want(monkeypatch):
    """The plain versions, with SiLU, softplus and the exp of A from the C
    library (A through a patched ``torch.exp`` inside the plain version's
    module only)."""
    monkeypatch.setattr(gl, "F", _LibmOps)

    class _Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def exp(t):
            return torch.from_numpy(_libm("expf", t.numpy()))
    monkeypatch.setattr(gl, "torch", _Torch())
    return gl


# -- inputs -------------------------------------------------------------

def _proj(B, S, di, N, H, seed, pdtype=torch.bfloat16, state=True, K=4):
    """in_proj's output (B, S, 2 di + 2 N + H) bf16 and the layer's conv and
    gate parameters in ``pdtype``; dt's columns spread over softplus's
    threshold."""
    g = torch.Generator().manual_seed(seed)
    C = di + 2 * N
    proj = torch.randn(B, S, 2 * di + 2 * N + H, generator=g)
    proj[..., 2 * di + 2 * N:] = 12 * torch.rand(B, S, H, generator=g) - 6
    proj[..., 2 * di + 2 * N::3] += 18         # some above 20
    p = {"conv_w": 0.5 * torch.randn(K, C, generator=g),
         "conv_b": 0.3 * torch.randn(C, generator=g),
         "dt_bias": 0.5 * torch.randn(H, generator=g),
         "A_log": torch.log(torch.linspace(1.0, 16.0, H)),
         "D": 1 + 0.5 * torch.randn(H, generator=g),
         "norm": 1 + 0.2 * torch.randn(di, generator=g)}
    p = {k: v.to(pdtype) for k, v in p.items()}
    st = torch.randn(B, K - 1, C, generator=g).to(torch.bfloat16) \
        if state else None
    return proj.to(torch.bfloat16), p, st


def _split(proj, di, N):
    return torch.split(proj, [di, di + 2 * N, proj.shape[-1] - 2 * di
                              - 2 * N], dim=-1)


def _conv_args(proj, p, st, di, N):
    z, conv, dt = _split(proj, di, N)
    return (conv, dt, st, p["conv_w"], p["conv_b"], p["dt_bias"],
            p["A_log"])


def _conv_same(lib, ref, proj, p, st, di, N):
    args = _conv_args(proj, p, st, di, N)
    got = gl.run_conv_in(lib, *args, d_state=N)
    exp = ref.mamba2_conv_in_plain(*args, d_state=N)
    names = ("xs", "lw", "Bm", "Cm", "xh", "state")
    return [n for n, a, b in zip(names, got, exp)
            if not (a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a, b))]


def _gate_inputs(B, S, di, N, H, seed, pdtype=torch.bfloat16):
    proj, p, _ = _proj(B, S, di, N, H, seed, pdtype, state=False)
    g = torch.Generator().manual_seed(seed + 1)
    y = 3 * torch.randn(B, S, H, di // H, generator=g)
    xh = torch.randn(B, S, di, generator=g).to(torch.bfloat16)
    z = _split(proj, di, N)[0]
    return y, xh, z, p["D"], p["norm"]


def _gate_same(lib, ref, *args):
    got = gl.run_gate_norm(lib, *args)
    return torch.equal(got, ref.mamba2_gate_norm_plain(*args))


# -- conv_in ------------------------------------------------------------

@pytest.mark.parametrize("S", [2, 3, 64, 65, 150])
@pytest.mark.parametrize("state", [False, True])
def test_conv_in_every_tile_edge(lib, want, S, state):
    """Reduced widths, 2 batch rows: one tile or three (64, 64, 22), a
    sequence shorter than the window, from a zero or a given conv state:
    every output the plain version's bits."""
    di, N, H = WIDTHS["reduced"]
    proj, p, st = _proj(2, S, di, N, H, seed=S, state=state)
    assert _conv_same(lib, want, proj, p, st, di, N) == []


@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [2, 3, 4])
def test_conv_in_taps_and_parameter_dtypes(lib, want, pdtype, K):
    """Convs of 2, 3 and 4 taps, f32 parameters (rounded to bf16 for the
    conv as ``w.to(x.dtype)`` does, kept f32 for dt) and bf16 ones."""
    di, N, H = WIDTHS["narrow"]
    proj, p, st = _proj(3, 70, di, N, H, seed=K, pdtype=pdtype, K=K)
    assert _conv_same(lib, want, proj, p, st, di, N) == []


def test_conv_in_at_zamba2_widths(lib, want):
    """d_inner 4,096, 64 heads, N 64 (4,224 channels, 9 blocks of 128
    threads across, the last with 8), 70 tokens over two tiles, a given
    conv state: every output the plain version's bits."""
    di, N, H = WIDTHS["zamba2"]
    proj, p, st = _proj(1, 70, di, N, H, seed=7)
    assert _conv_same(lib, want, proj, p, st, di, N) == []


def test_conv_in_at_granite_widths(lib, want):
    """granite-4.0-h-small's mixer: d_inner 8,192, 128 heads, N 128 (8,448
    channels, 17 blocks of 128 threads across, the last with 64), 20
    tokens, a given conv state: every output the plain version's bits."""
    di, N, H = GRANITE
    proj, p, st = _proj(1, 20, di, N, H, seed=11)
    assert _conv_same(lib, want, proj, p, st, di, N) == []


def test_conv_in_refuses_what_it_cannot_read(lib):
    """A conv view 2 bytes off an 8-byte boundary, widths off the
    4-channel groups and a conv of 5 taps are refused (a RuntimeError
    naming the error), not read wrong."""
    di, N, H = WIDTHS["reduced"]
    proj, p, st = _proj(1, 8, di, N, H, seed=1)
    z, conv, dt = _split(proj, di, N)
    args = (dt, st, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"])
    with pytest.raises(RuntimeError, match="failed to launch"):
        gl.run_conv_in(lib, proj[..., di - 1:2 * di + 2 * N - 1], *args,
                       d_state=N)
    with pytest.raises(RuntimeError, match="failed to launch"):
        gl.run_conv_in(lib, conv[..., 4:], dt, st[..., 4:],
                       p["conv_w"][:, 4:], p["conv_b"][4:], p["dt_bias"],
                       p["A_log"], d_state=N - 2)     # N 14: off 4 channels
    w5 = torch.cat([p["conv_w"], p["conv_w"][:1]])
    with pytest.raises(RuntimeError, match="failed to launch"):
        gl.run_conv_in(lib, conv, dt, None, w5, p["conv_b"], p["dt_bias"],
                       p["A_log"], d_state=N)


# -- gate_norm ----------------------------------------------------------

@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("rows", [(1, 3), (2, 70)])
@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
def test_gate_norm_every_layout(lib, want, width, rows, pdtype):
    """d_inner 64 (16 threads a row, two rows a warp), 256 (a warp a row)
    and 4,096 (64 threads a row, the tree's middle level through shared
    memory); 3 and 140 rows (dead rows in the last block); f32 and bf16 D
    and scale: the plain version's bits, which are K4's of the gate."""
    di, N, H = WIDTHS[width]
    args = _gate_inputs(*rows, di, N, H, seed=di + rows[1], pdtype=pdtype)
    assert _gate_same(lib, want, *args)


def test_gate_norm_at_2048_channels(lib, want):
    """d_inner 2,048: a warp a row with 8 groups a thread in registers."""
    args = _gate_inputs(2, 9, 2048, 64, 32, seed=3)
    assert _gate_same(lib, want, *args)


def test_gate_norm_at_granite_widths(lib, want):
    """d_inner 8,192 in 128 heads: 128 threads a row, 8 groups a thread,
    two rows a block; 3 rows (the second block's second row dead)."""
    di, N, H = GRANITE
    args = _gate_inputs(1, 3, di, N, H, seed=5)
    assert _gate_same(lib, want, *args)


def test_gate_norm_refuses_a_misaligned_z(lib):
    di, N, H = WIDTHS["reduced"]
    y, xh, z, D, s = _gate_inputs(1, 4, di, N, H, seed=1)
    proj = torch.zeros(1, 4, z.shape[-1] + 1, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="failed to launch"):
        gl.run_gate_norm(lib, y, xh, proj[..., 1:], D, s)


# -- broken copies ------------------------------------------------------

def _all_same(lib, ref):
    """The checks the broken copies are held to: conv_in over three tiles
    from a given state, gate_norm at d_inner 256 and 4,096."""
    di, N, H = WIDTHS["reduced"]
    proj, p, st = _proj(2, 150, di, N, H, seed=11)
    if _conv_same(lib, ref, proj, p, st, di, N):
        return False
    for width in ("reduced", "zamba2"):
        di, N, H = WIDTHS[width]
        if not _gate_same(lib, ref, *_gate_inputs(2, 9, di, N, H, seed=5)):
            return False
    return True


@pytest.mark.parametrize("broken", list(BROKEN))
def test_broken_copies_fail(shim_dir, lib, want, broken):
    assert _all_same(lib, want)
    old, new = BROKEN[broken]
    src = CU.read_text()
    assert src.count(old) == 1, broken
    bad = shim_dir / f"broken_{broken.replace(' ', '_')}.cu"
    bad.write_text(src.replace(old, new))
    blib = _build(bad, bad.with_suffix(".so"))
    assert not _all_same(blib, want), broken
