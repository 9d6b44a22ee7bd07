"""RMSNorm (K4) on the H100.

``y = (x * r) * scale`` with ``r = 1 / sqrt(mean(x^2) + eps)``: the moment
in f32, ``r`` rounded to ``x``'s dtype, and both products rounded to that
dtype, as the reference computes it (``repro/models/layers.py:46``, and its
Pallas kernel ``repro/kernels/rmsnorm/rmsnorm.py:12``). The kernel is CUDA
C++ in ``csrc/rmsnorm.cu`` (built by ``nvcc`` at first use,
``kernels/_build.py``). :func:`rmsnorm` launches it for a CUDA tensor and
runs :func:`rmsnorm_plain` only for a CPU tensor.

``LAUNCHES["rmsnorm"]`` counts kernel launches (never plain-version runs),
so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import _build

# value dtype -> code of csrc/rmsnorm.cu's DType enum
_DTYPE_CODES: Dict[torch.dtype, int] = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"rmsnorm": 0}

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, _P]


def reset_launches():
    LAUNCHES["rmsnorm"] = 0


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`rmsnorm`, on ``x``'s device: the kernel's
    order of the sum of squares (32 running sums over the columns j, j+32,
    ..., then a halving tree), so the two agree bit for bit, and the same
    two roundings."""
    D = x.shape[-1]
    sq = x.float() * x.float()
    sq = torch.nn.functional.pad(sq, (0, -D % 32)) \
        .reshape(x.shape[:-1] + (-1, 32))
    t = torch.zeros(sq.shape[:-2] + (32,), dtype=torch.float32,
                    device=x.device)
    for c in range(sq.shape[-2]):
        t = t + sq[..., c, :]
    while t.shape[-1] > 1:
        t = t[..., :t.shape[-1] // 2] + t[..., t.shape[-1] // 2:]
    # a true division (torch turns ``t / D`` into a multiply by 1/D), and a
    # correctly rounded sqrt (the f64 root of an f32 rounds right; torch's
    # f32 sqrt on the CPU is off by a bit at times)
    var = t / torch.full_like(t, D)
    root = torch.sqrt((var + eps).double()).float()
    r = (torch.ones_like(root) / root).to(x.dtype)
    return (x * r) * scale.to(x.dtype)


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
    if not scale.dtype.is_floating_point or scale.element_size() > 4:
        raise ValueError(f"unsupported scale dtype {scale.dtype}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D) float32 or bfloat16; scale: (D,). Returns x's shape and
    dtype on x's device."""
    _check(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    xf = x.contiguous()
    out = torch.empty_like(xf)
    D = x.shape[-1]
    rows = xf.numel() // D if D else 0
    # f32 holds every bf16/f16 scale exactly; the kernel rounds it to x's
    # dtype, as scale.astype(x.dtype) does
    sc = scale.to(torch.float32).contiguous()
    if rows:
        _build.launch("rmsnorm", "repro_rmsnorm", _ARGTYPES, xf.data_ptr(),
                      sc.data_ptr(), out.data_ptr(), rows, D, eps,
                      _DTYPE_CODES[x.dtype],
                      torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES["rmsnorm"] += 1
    return out
