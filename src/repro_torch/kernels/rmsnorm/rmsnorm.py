"""RMSNorm (K4) on the H100.

``y = (x * r) * scale`` with ``r = 1 / sqrt(mean(x^2) + eps)``: the moment
in f32, ``r`` rounded to ``x``'s dtype, and both products rounded to that
dtype, as the reference computes it (``repro/models/layers.py:46``, and its
Pallas kernel ``repro/kernels/rmsnorm/rmsnorm.py:12``). The kernel is CUDA
C++ in ``csrc/rmsnorm.cu`` (built by ``nvcc`` at first use,
``kernels/_build.py``). :func:`rmsnorm` launches it for a CUDA tensor, once
a call, with the scale in its own dtype, and runs :func:`rmsnorm_plain`
only for a CPU tensor. The kernel has no backward: under grad mode the
wrapper refuses, on either device, an input that requires grad
(``kernels/_nograd.py``).

``LAUNCHES["rmsnorm"]`` counts kernel launches (never plain-version runs),
so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .._nograd import refuse_grad

# x's and the scale's dtypes -> codes of csrc/rmsnorm.cu's DType enum
_DTYPE_CODES: Dict[torch.dtype, int] = {torch.float32: 0, torch.bfloat16: 1}
# a row of at most this many 16-byte groups (csrc/rmsnorm.cu kMaxGroups)
MAX_GROUPS = 8192

LAUNCHES: Dict[str, int] = {"rmsnorm": 0}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "repro_rmsnorm": [_P, _P, _P, _I64, _I, ctypes.c_float, _I, _I, _P],
    "repro_rmsnorm_layout": [_P, _P, _P, _I64, _I, ctypes.c_float, _I, _I,
                             _I, _I, _P],
    "repro_rmsnorm_plan": [_I64, _I, _I, ctypes.POINTER(_I),
                           ctypes.POINTER(_I)],
}


def reset_launches():
    LAUNCHES["rmsnorm"] = 0


def _padded_groups(d: int, itemsize: int) -> Tuple[int, int]:
    """(values a 16-byte group, the row's groups rounded up to a power of
    two, at least 1)."""
    g = 16 // itemsize
    n = -(-d // g)
    return g, 1 << max(n - 1, 0).bit_length()


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`rmsnorm`, on ``x``'s device, in the kernel's
    order of the sum of squares, so the two agree bit for bit: each
    16-byte group of the row (8 bf16 or 4 f32 values, the last zero-padded)
    summed left to right, then a halving tree over the groups padded with
    zero groups to a power of two (group g with g + N/2, then g + N/4, ...);
    and the same two roundings."""
    D = x.shape[-1]
    g, N = _padded_groups(D, x.element_size())
    sq = x.float() * x.float()
    sq = F.pad(sq, (0, N * g - D)).reshape(x.shape[:-1] + (N, g))
    t = sq[..., 0]
    for i in range(1, g):
        t = t + sq[..., i]
    while t.shape[-1] > 1:
        t = t[..., :t.shape[-1] // 2] + t[..., t.shape[-1] // 2:]
    # a true division (torch turns ``t / D`` into a multiply by 1/D), and a
    # correctly rounded sqrt (the f64 root of an f32 rounds right; torch's
    # f32 sqrt on the CPU is off by a bit at times)
    var = t / torch.full_like(t, D)
    root = torch.sqrt((var + eps).double()).float()
    r = (torch.ones_like(root) / root).to(x.dtype)
    return (x * r) * scale.to(x.dtype)


def _fn(lib: ctypes.CDLL, name: str):
    f = getattr(lib, name)
    if f.argtypes is None:
        f.argtypes = _SIGNATURES[name]
        f.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return f


def _call(lib: ctypes.CDLL, name: str, *args):
    rc = _fn(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc} "
                           f"({lib.repro_error_string(rc).decode()})")


def plan(lib: ctypes.CDLL, rows: int, d: int,
         dtype: torch.dtype) -> Tuple[int, int]:
    """(threads a row, rows a block) that ``repro_rmsnorm`` of ``lib``
    takes for ``rows`` rows of ``d`` values of ``dtype`` on the current
    device."""
    team, rpb = _I(), _I()
    _call(lib, "repro_rmsnorm_plan", rows, d, _DTYPE_CODES[dtype],
          ctypes.byref(team), ctypes.byref(rpb))
    return team.value, rpb.value


def threshold(lib: ctypes.CDLL, d: int, dtype: torch.dtype) -> int:
    """The fewest rows that :func:`plan` lays out as many rows (32 or 16
    threads a row) on the current device; fewer spread a row over a
    block."""
    many = plan(lib, 1 << 30, d, dtype)
    lo, hi = 1, 1 << 30
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if plan(lib, mid, d, dtype) == many \
            else (mid + 1, hi)
    return lo


def run_kernel(lib: ctypes.CDLL, x: torch.Tensor, scale: torch.Tensor,
               eps: float = 1e-5, *, layout: Optional[Tuple[int, int]] = None,
               stream=None) -> torch.Tensor:
    """One call of ``repro_rmsnorm`` of the built library ``lib`` (a
    ``ctypes.CDLL`` of ``csrc/rmsnorm.cu``) on ``x`` (..., D) and ``scale``
    (D,), both contiguous on one device; or, with ``layout`` = (threads a
    row, rows a block), of ``repro_rmsnorm_layout`` in that layout. Returns
    the output, from ``torch.empty_like(x)``. ``stream`` is a
    ``cudaStream_t`` handle, None for the default stream. A nonzero return
    raises. Counts no launch."""
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    out = torch.empty_like(x)
    args = (x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, eps,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype])
    if layout is None:
        _call(lib, "repro_rmsnorm", *args, stream)
    else:
        _call(lib, "repro_rmsnorm_layout", *args, *layout, stream)
    return out


def _check(x: torch.Tensor, scale: torch.Tensor):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {x.dtype} for rmsnorm "
                         f"(supported: {sorted(map(str, _DTYPE_CODES))})")
    if x.dim() < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"scale {tuple(scale.shape)} does not match the "
                         f"last dim of x {tuple(x.shape)}")
    if scale.device != x.device:
        raise ValueError(f"scale on {scale.device}, x on {x.device}")
    if scale.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported scale dtype {scale.dtype} (supported:"
                         f" {sorted(map(str, _DTYPE_CODES))})")
    if _padded_groups(x.shape[-1], x.element_size())[1] > MAX_GROUPS:
        raise ValueError(f"a row of {x.shape[-1]} {x.dtype} values is wider "
                         f"than the kernel's {MAX_GROUPS} 16-byte groups")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D) float32 or bfloat16; scale: (D,) float32 or bfloat16.
    Returns x's shape and dtype on x's device."""
    refuse_grad("rmsnorm", x, scale)
    _check(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    xf, sc = x.contiguous(), scale.contiguous()
    if xf.numel() == 0:
        return torch.empty_like(xf)
    out = run_kernel(_build.load("rmsnorm"), xf, sc, eps,
                     stream=torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES["rmsnorm"] += 1
    return out
